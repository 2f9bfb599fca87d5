"""LM training (mirrors ``repro.train``): the loss and the step factories,
one device (``make_train_step``) and explicit data parallelism over a mesh
with an int8-compressed gradient sum (``make_shardmap_train_step``), and
tensor parallelism with ZeRO-1 over placed state (``make_sharded_train_step``)."""
from repro_torch.train.loop import (
    TrainState,
    loss_fn,
    make_shardmap_train_step,
    make_sharded_train_step,
    make_train_step,
    train_state_init,
)
from repro_torch.train.losses import IGNORE, cross_entropy

__all__ = ["IGNORE", "TrainState", "cross_entropy", "loss_fn", "make_shardmap_train_step",
           "make_sharded_train_step", "make_train_step", "train_state_init"]
