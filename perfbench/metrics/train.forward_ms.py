"""The training step's forward on the device: the ``device_s`` of the
program's ``train.forward`` spans (``model.loss``, timed by CUDA events
around it) over the traced window's steps, ms."""

from perfbench.lib import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "train.forward")
