"""Per-device cost count of a step, ported from ``repro.launch.hlo_cost``.

The reference walks the optimized HLO text of a compiled program and
multiplies loop bodies by their trip counts. PyTorch runs eagerly, so the
port counts the aten ops that actually run, under a dispatch mode
(``Counter``): a Python loop over layers or microbatches counts each trip
as it runs, which is what the reference's trip-count logic is for. It
derives the reference's quantities:

  * flops             dots: 2·M·N·K with batch dims (``torch.utils.
                      flop_counter``'s formulas), and the flash-attention
                      operator by its own formula, whichever route computes it
  * bytes             a structural HBM proxy by the reference's rules: views
                      are free; dots, copies and sorts count their operands
                      and result; slices and gathers twice the result;
                      in-place updates twice the update; any other op its
                      result only
  * collective bytes  per-device bytes moved by each c10d collective, by the
                      reference's ring factors for the group's size

Under a mesh the ops of a DTensor run on each rank's local shards: the
mode lets DTensor dispatch the op (it returns ``NotImplemented`` for it)
and counts the local ops and collectives that DTensor then issues, so
the count is per device (a FLOP counter around the DTensor op itself sees
the global product). The global op DTensor runs on fake tensors to infer
an output's shape is not counted. ``Counter`` also follows the bytes held
by the tensors the counted ops create, until each is freed, and keeps
their peak.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# importing the wrappers registers the flash operator and its FLOP formula
from ..kernels.flash_attention import ops as _flash_ops  # noqa: F401

aten = torch.ops.aten
# ops that move no data (aliasing, metadata, allocation without a fill)
_FREE = {aten.detach, aten.alias, aten._unsafe_view, aten.lift_fresh,
         aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset, aten.is_same_size}
# structural ops that count their operands and result
_COPIES = {aten._to_copy, aten.clone, aten._copy_from, aten.sort, aten.topk,
           aten.cat, aten.stack}
# slices and gathers: twice the result
_GATHERS = {aten.index, aten.gather, aten.index_select, aten.embedding,
            aten.take}
# in-place updates whose update is an operand: (op, the update's argument)
_UPDATES = {aten.index_put_: 2, aten.index_put: 2, aten.scatter_: 3,
            aten.scatter: 3, aten.scatter_add_: 3, aten.scatter_add: 3,
            aten.index_add_: 3, aten.index_add: 3, aten.index_copy_: 3,
            aten.index_copy: 3, aten.copy_: 1, aten.slice_scatter: 1,
            aten.select_scatter: 1}


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _kind(name: str):
    """The reference's collective kind of a c10d op's name, or None."""
    for key, kind in (("all_gather", "all-gather"), ("allgather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                      ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                      ("send", "collective-permute"),
                      ("recv", "collective-permute")):
        if key in name:
            return kind
    return None


def _group_size(args) -> int:
    """The size of the process group a c10d op names (by its name, as the
    functional ops do, or as a ``ProcessGroup`` object)."""
    from torch.distributed import ProcessGroup
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:       # another boxed object (a ReduceOp)
                continue
        if isinstance(a, ProcessGroup):
            return a.size()
    raise ValueError(f"no process group among the collective's arguments "
                     f"{[type(a).__name__ for a in args]}")


def collective_bytes(kind: str, size: int, n: int) -> float:
    """Bytes one device moves in a ring collective over ``n`` devices:
    ``size`` is the reduced (all-reduce), gathered (all-gather) or
    scattered-shard (reduce-scatter) result, as the reference's factors
    read it."""
    if kind == "all-reduce":
        return size * 2 * (n - 1) / max(n, 1)
    if kind in ("all-gather", "all-to-all"):
        return size * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return float(size * (n - 1))
    return float(size)  # collective-permute


def _in_shape_inference() -> bool:
    """True inside DTensor's sharding propagation, which runs the global op
    on fake tensors to infer an output's shape (not work of any device)."""
    f = sys._getframe(2)
    for _ in range(8):         # the op's caller is a few frames up
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=lambda: defaultdict(float))
    coll_counts: dict = field(default_factory=lambda: defaultdict(float))

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] += v * mult
        for k, v in other.coll_counts.items():
            self.coll_counts[k] += v * mult


class Counter(TorchDispatchMode):
    """A dispatch mode that adds each op that runs on plain (local) tensors
    to ``cost``, counts the ops that cost something (``n_ops``: the
    collectives and the aten ops that are not views or allocations), and
    follows the bytes of the
    tensors they create (their storages' bytes) until each is freed:
    ``live_bytes`` now, ``peak_live_bytes`` at most."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it on local shards
        out = func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in leaves) \
                and _in_shape_inference():
            return out
        self._count(func, args, kwargs, out)
        return out

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and id(t) not in self._live:
                n = t.untyped_storage().nbytes()
                self._live[id(t)] = n
                self.live_bytes += n
                weakref.finalize(t, self._free, id(t))
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key)

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        packet = func._overloadpacket
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d", "_c10d_functional_autograd"):
            kind = _kind(func.__name__)
            if kind is None:           # wait_tensor and the like
                return
            size = _bytes(out if ns != "c10d" else args[0])
            moved = collective_bytes(kind, size, _group_size(args))
            c.coll_bytes += moved
            c.coll_by_kind[kind] += moved
            c.coll_counts[kind] += 1
            c.bytes += size
            self.n_ops += 1
            self._track(out)
            return
        if ns not in ("aten", "repro_torch") or packet in _FREE \
                or func.is_view:
            return
        self.n_ops += 1
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            c.bytes += _bytes(out) + _bytes((args, kwargs))
        elif packet in _UPDATES:
            c.bytes += 2 * _bytes(args[_UPDATES[packet]])
        elif func._schema.is_mutable:
            c.bytes += 2 * _bytes(args[0])     # the region written in place
        elif packet in _COPIES:
            c.bytes += _bytes(out) + _bytes((args, kwargs))
        elif packet in _GATHERS:
            c.bytes += 2 * _bytes(out)
        else:
            c.bytes += _bytes(out)
        if not func._schema.is_mutable:
            self._track(out)

    def result(self) -> dict:
        return {
            "flops": self.cost.flops,
            "bytes": self.cost.bytes,
            "collective_bytes": self.cost.coll_bytes,
            "collective_by_kind": dict(self.cost.coll_by_kind),
            "collective_counts": dict(self.cost.coll_counts),
            "n_ops": self.n_ops,
            "peak_live_bytes": self.peak_live_bytes,
        }


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a ``Counter`` and return the
    reference's keys (``flops``, ``bytes``, ``collective_bytes``,
    ``collective_by_kind``, ``collective_counts``) per device, with
    ``n_ops`` and ``peak_live_bytes`` (the most bytes held at once by
    storages the step created), and the function's output as ``out``."""
    with Counter() as counter:
        out = fn(*args, **kwargs)
    return {**counter.result(), "out": out}
