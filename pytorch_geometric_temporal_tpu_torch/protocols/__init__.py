"""End-to-end protocols: the bundled datasets' accuracy runs, the METR-LA
DCRNN protocol (on the seeded synthetic stand-in), the full training
harness and the heterogeneous-graph run."""

from . import harness, hetero, metrla_protocol

from .bundled_accuracy import (
    RUNS,
    ProtocolRun,
    extra_bundled_accuracy,
    pedalme_accuracy,
    twitter_tennis_accuracy,
)

__all__ = ["RUNS", "ProtocolRun", "extra_bundled_accuracy", "harness",
           "hetero", "metrla_protocol", "pedalme_accuracy",
           "twitter_tennis_accuracy"]
