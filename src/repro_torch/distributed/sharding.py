"""Distribution context, ported from ``repro.distributed.sharding``: a
``DeviceMesh`` with the reference's axis names, the logical-axis rules
restricted to the axes it has, and shape-aware helpers.

Parallelism map (production mesh (pod=2,) data=16, model=16):
  DP    — batch over ('pod', 'data')
  FSDP  — parameter/optimizer 'embed' dim over 'data' (ZeRO-3; DTensor
          all-gathers a weight where an op needs it whole)
  TP    — 'heads' / 'ff' / 'vocab' over 'model' (Megatron)
  EP    — 'experts' over 'model' when divisible (else expert-TP over d_ff)
  SP    — long-context KV cache 'kv_seq' over 'data' when batch is
          unshardable

Where the reference leaves placement to GSPMD, the port holds DTensors
whose placements come from the same rules (``placement.placements``);
where the reference uses ``shard_map`` (the MoE block), the port uses
``local_map`` and the explicit collectives of ``collectives``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

from torch.distributed.tensor.experimental import implicit_replication

from ..models.base import ShardingRules, mesh_axes
from .placement import placements


def make_rules(mesh, *, seq_sharded: bool = False, fsdp: bool = True,
               train_seq_sharded: bool = False) -> ShardingRules:
    """Rules restricted to the axes ``mesh`` has (no sharding for None).

    ``train_seq_sharded`` enables Megatron-style sequence parallelism: the
    residual stream is sharded over 'model' between blocks."""
    if mesh is None:
        return ShardingRules(embed=None, heads=None, kv_heads=None, ff=None,
                             vocab=None, experts=None, lru=None, batch=None,
                             seq=None, kv_seq=None)
    names = set(mesh_axes(mesh))

    def ax(a):
        return a if a in names else None

    batch = tuple(a for a in ("pod", "data") if a in names) or None
    return ShardingRules(
        embed=ax("data") if fsdp else None,
        heads=ax("model"), kv_heads=ax("model"), ff=ax("model"),
        vocab=ax("model"), experts=ax("model"), lru=ax("model"),
        batch=batch,
        seq=ax("model") if train_seq_sharded else None,
        kv_seq=ax("data") if seq_sharded else None,
    )


@dataclasses.dataclass
class Dist:
    mesh: Any            # a DeviceMesh with named axes, or None
    rules: ShardingRules

    def batch_axes_for(self, b: int):
        """Largest prefix of the batch axes that divides b."""
        if self.mesh is None or self.rules.batch is None:
            return None
        axes = self.rules.batch if isinstance(self.rules.batch, tuple) \
            else (self.rules.batch,)
        sizes = mesh_axes(self.mesh)
        chosen: list[str] = []
        prod = 1
        for a in axes:
            if b % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
        if not chosen:
            return None
        return tuple(chosen) if len(chosen) > 1 else chosen[0]

    def sharding(self, spec: tuple) -> Optional[tuple]:
        """(mesh, placements) for ``spec``; None without a mesh."""
        if self.mesh is None:
            return None
        return self.mesh, placements(spec, self.mesh)


_depth = 0


@contextlib.contextmanager
def sharded_ops():
    """DTensor ops take the plain tensors they meet (positions, masks, RoPE
    tables, labels, scalars) as replicated. ``implicit_replication`` sets a
    process-wide flag and clears it on exit, so only the outermost of
    nested contexts enters it (the step's around the model's loss)."""
    global _depth
    with contextlib.ExitStack() as stack:
        if _depth == 0:
            stack.enter_context(implicit_replication())
        _depth += 1
        try:
            yield
        finally:
            _depth -= 1


def make_dist(mesh, **rule_kw) -> Dist:
    return Dist(mesh=mesh, rules=make_rules(mesh, **rule_kw))
