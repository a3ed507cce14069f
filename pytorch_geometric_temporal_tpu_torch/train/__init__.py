"""Training: losses, dtype policies and mixed precision, the scaler, the
trainers, the training state, checkpoints and divergence guards."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .guards import DivergenceGuard, loss_is_finite
from .losses import mae, mape, masked_mae_loss, masked_mse_loss, mse, rmse
from .precision import (
    DynamicLossScale,
    Policy,
    all_finite,
    bf16_policy,
    f16_policy,
    f32_policy,
    make_mixed_precision_step,
)
from .scaler import ZScoreScaler
from .state import CheckpointManager, TrainState, apply_gradients
from .trainer import BatchTrainer, SnapshotTrainer

__all__ = [
    "latest_step", "restore_checkpoint", "save_checkpoint",
    "mae", "mape", "masked_mae_loss", "masked_mse_loss", "mse", "rmse",
    "ZScoreScaler", "BatchTrainer", "SnapshotTrainer",
    "DivergenceGuard", "loss_is_finite",
    "CheckpointManager", "TrainState", "apply_gradients",
    "DynamicLossScale", "Policy", "all_finite", "bf16_policy",
    "f16_policy", "f32_policy", "make_mixed_precision_step",
]
