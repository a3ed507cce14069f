"""End-to-end protocols on the datasets bundled with the package."""

from .bundled_accuracy import (
    RUNS,
    ProtocolRun,
    extra_bundled_accuracy,
    pedalme_accuracy,
    twitter_tennis_accuracy,
)

__all__ = ["RUNS", "ProtocolRun", "extra_bundled_accuracy",
           "pedalme_accuracy", "twitter_tennis_accuracy"]
