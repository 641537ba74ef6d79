"""Training (the port of ``repro.train``): the loss and the train step
with activation checkpointing and gradient accumulation."""

from repro_torch.train.steps import loss_fn, make_train_step

__all__ = ["loss_fn", "make_train_step"]
