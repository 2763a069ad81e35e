"""The training step's backward on the device, the layers' recompute
included: the ``device_s`` of the program's ``train.backward`` spans
(``torch.autograd.grad``, timed by CUDA events around it) over the traced
window's steps, ms."""

from perfbench.lib import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "train.backward")
