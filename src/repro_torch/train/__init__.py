"""Training (the reference's ``train`` package): checkpoints, resilience,
the single-device GAN step and the ``train_gan`` loop."""
from .checkpoint import (
    CheckpointCorruptError,
    available_steps,
    latest_step,
    load_loop_state,
    restore_checkpoint,
    restore_latest_valid,
    save_checkpoint,
    verify_checkpoint,
)
from .resilience import (
    DivergenceDetector,
    FaultPolicy,
    InjectedTrainFault,
    PreemptionGuard,
    TrainDivergenceError,
    TrainFaultError,
    TrainFaultPlan,
    nonfinite_flag,
)
from .trainer import METRIC_SPEC_KEYS, StepSettings, TrainHooks, gan_losses, make_gan_step, train_gan

__all__ = [
    "CheckpointCorruptError",
    "DivergenceDetector",
    "FaultPolicy",
    "InjectedTrainFault",
    "METRIC_SPEC_KEYS",
    "PreemptionGuard",
    "StepSettings",
    "TrainDivergenceError",
    "TrainFaultError",
    "TrainFaultPlan",
    "TrainHooks",
    "available_steps",
    "gan_losses",
    "latest_step",
    "load_loop_state",
    "make_gan_step",
    "nonfinite_flag",
    "restore_checkpoint",
    "restore_latest_valid",
    "save_checkpoint",
    "train_gan",
    "verify_checkpoint",
]
