from .step import (
    TrainSettings,
    cross_entropy,
    init_train_state,
    make_decode_step,
    make_loss_fn,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "TrainSettings",
    "cross_entropy",
    "init_train_state",
    "make_decode_step",
    "make_loss_fn",
    "make_prefill_step",
    "make_train_step",
]
