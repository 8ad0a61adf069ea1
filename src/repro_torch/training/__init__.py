"""Training: optimizers, the synthetic data pipeline and the train step
(counterpart of ``repro.training``), and the optimizer state's shape-only
stand-ins and logical axes for the sharded path."""

from repro_torch.training.data import DataConfig, SyntheticLM, make_batch_fn
from repro_torch.training.optimizer import (
    Adafactor,
    AdafactorState,
    AdamW,
    AdamWState,
    clip_by_global_norm,
    cosine_schedule,
    get_optimizer,
    global_norm,
)
from repro_torch.training.train_loop import (
    TrainConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
    opt_state_axes,
)

__all__ = [
    "DataConfig",
    "SyntheticLM",
    "make_batch_fn",
    "AdamW",
    "AdamWState",
    "Adafactor",
    "AdafactorState",
    "clip_by_global_norm",
    "cosine_schedule",
    "get_optimizer",
    "global_norm",
    "TrainConfig",
    "abstract_train_state",
    "init_train_state",
    "make_train_step",
    "opt_state_axes",
]
