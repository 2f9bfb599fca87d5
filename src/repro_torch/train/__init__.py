"""LM training (mirrors ``repro.train``): the loss and the step factory.
``make_shardmap_train_step`` (explicit data parallelism with an
int8-compressed gradient psum) is not ported; it waits with the mesh
tools."""
from repro_torch.train.loop import TrainState, loss_fn, make_train_step, train_state_init
from repro_torch.train.losses import IGNORE, cross_entropy

__all__ = ["IGNORE", "TrainState", "cross_entropy", "loss_fn", "make_train_step",
           "train_state_init"]
