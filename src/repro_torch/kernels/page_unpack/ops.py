"""Public wrapper of the page-unpack kernel: ``page_unpack`` decodes the
pages of one staging buffer (``staging.pack_pages``) into an output buffer
on the same device. A CUDA tensor launches the kernel (and adds one to
``page_unpack.launches``); a CPU tensor takes the plain version,
``page_unpack_ref``. Nothing falls back from the kernel.
"""

from __future__ import annotations

import threading

import torch

from .kernel import page_unpack_fwd
from .ref import page_unpack_ref
from .staging import Layout

_launch_lock = threading.Lock()


def page_unpack(staging: torch.Tensor, layout: Layout,
                out: torch.Tensor) -> None:
    """Write the values of ``layout``'s pages into ``out`` (uint8 bytes,
    each page at its ``out_offset``), in place; ``staging`` holds them as
    ``staging.write_pages`` writes them, on ``out``'s device."""
    if staging.device != out.device:
        raise ValueError(f"staging on {staging.device}, out on {out.device}")
    ends = layout.desc["out_offset"] + layout.desc["rows"] \
        * layout.desc["out_size"]
    if staging.numel() < layout.nbytes or out.numel() < ends.max(initial=0):
        raise ValueError(f"staging of {staging.numel()} bytes or out of "
                         f"{out.numel()} too small for the layout")
    if staging.device.type == "cpu":
        return page_unpack_ref(staging, layout.n_pages, out)
    if staging.device.type != "cuda":
        raise ValueError(f"no page-unpack path for device {staging.device}")
    if layout.n_pages:
        page_unpack_fwd(staging, layout.n_pages, layout.n_blocks, out)
        with _launch_lock:
            page_unpack.launches += 1


page_unpack.launches = 0
