"""Training: losses, dtype policies, scaler, trainers."""

from .losses import mae, mape, masked_mae_loss, masked_mse_loss, mse, rmse
from .precision import Policy, bf16_policy, f32_policy
from .scaler import ZScoreScaler
from .trainer import BatchTrainer, SnapshotTrainer

__all__ = [
    "BatchTrainer",
    "Policy",
    "SnapshotTrainer",
    "ZScoreScaler",
    "bf16_policy",
    "f32_policy",
    "mae",
    "mape",
    "masked_mae_loss",
    "masked_mse_loss",
    "mse",
    "rmse",
]
