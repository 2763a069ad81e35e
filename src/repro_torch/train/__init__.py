"""Training, ported from ``repro.train``: AdamW (``optimizer``), the step
factory with microbatch accumulation (``loop``), gradient compression
(``compression``) and checkpoints in the reference's on-disk format
(``checkpoint``)."""

from .loop import make_train_step
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "make_train_step"]
