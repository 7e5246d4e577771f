"""Training substrate (the port of ``repro.train``): optimizer, trainer,
checkpointing, int8 error-feedback gradient compression."""
from . import checkpoint, compression, optimizer, trainer
from .optimizer import OptConfig, adamw_update, init_opt_state
from .trainer import FailureInjector, Trainer, TrainerConfig

__all__ = ["FailureInjector", "OptConfig", "Trainer", "TrainerConfig",
           "adamw_update", "checkpoint", "compression", "init_opt_state",
           "optimizer", "trainer"]
