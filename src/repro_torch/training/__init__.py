"""Training: optimizers, the synthetic data pipeline and the train step
(counterpart of ``repro.training``; ``abstract_train_state`` and
``opt_state_axes`` belong to the sharded path and are not here yet)."""

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
from repro_torch.training.train_loop import TrainConfig, init_train_state, make_train_step

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
    "init_train_state",
    "make_train_step",
]
