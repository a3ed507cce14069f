"""End-to-end protocols: the bundled datasets' accuracy runs and the METR-LA
DCRNN protocol (on the seeded synthetic stand-in)."""

from . import metrla_protocol

from .bundled_accuracy import (
    RUNS,
    ProtocolRun,
    extra_bundled_accuracy,
    pedalme_accuracy,
    twitter_tennis_accuracy,
)

__all__ = ["RUNS", "ProtocolRun", "extra_bundled_accuracy",
           "metrla_protocol", "pedalme_accuracy", "twitter_tennis_accuracy"]
