"""Mixture-of-Experts block, ported from ``repro.models.moe``: token-choice
top-k routing with capacity, expert products as batched matmuls, and the
reference's chunked weight layout.

Routed expert weights are stored as ``E * tp`` chunks: chunk ``e * tp + j``
holds expert e's j-th slice of d_ff, with ``tp = M / gcd(E, M)`` for the
reference's production model axis ``M = 16`` (``moe_chunking``). The layout
is kept so that parameters, checkpoints and ``convert.load_jax_params``
carry the reference's keys and shapes. The reference's local path copies
the chunks back into dense ``[E, d, ff]`` weights every call (``unchunk``);
here the products run on views of the chunks and the ``tp`` partial
down-projections are summed, as the reference's ``shard_map`` path does
(exact up to the order of the sum).

The expert products are plain batched matmuls, as in the reference, which
computes them outside any kernel too: each expert is padded to its capacity
``C``. A configuration whose capacity factor is at least E / k can drop no
pair at any call (``C >= T``: top-k picks k distinct experts, so an expert
gets at most one pair a token); off a mesh its block takes the grouped
path instead (``dropless``, ``_grouped``): the pairs are sorted by expert
on the device, each pair's row is gathered once, and ``torch._grouped_mm``
runs each expert's SwiGLU on its own rows alone, with the groups' ends as
a device tensor, in slices of at most ``GROUPED_SLICE_BYTES`` of gate
activations. The result is the capacity path's with no pair dropped, up to
the order of the sums. On CUDA, ``_grouped_mm`` keeps the ends on the
device in bf16 alone (in f32 torch loops over the groups on the host, a
synchronisation), so the path is served in bf16.

On a mesh (DTensor inputs) ``moe_block`` takes the reference's sharded path
where the model axis divides the chunks: under ``local_map`` with
``moe_specs``' placements each rank routes its own batch rows, computes
its contiguous slice of chunks, and ``psum`` over 'model' combines the
partial outputs (``pmean`` of the aux loss over 'model' and the batch
axes; a data axis that cannot split the batch computes the same block on
every rank, and its gradients are not summed over it). Elsewhere
every rank computes the whole block on the whole batch, as the
reference's local path routes every token at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ..distributed.collectives import pmean, psum
from ..distributed.placement import placements
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .base import P, mesh_axes

PRODUCTION_M = 16  # model-axis size of the reference's production mesh
# the grouped path's slice of sorted pairs: its gate (and up) activations
# stay under this many bytes (mixtral-8x22b in bf16: 32768 pairs a slice)
GROUPED_SLICE_BYTES = 1 << 29


def moe_chunking(E: int, M: int = PRODUCTION_M) -> tuple[int, int]:
    """(tp, n_chunks): tp d_ff slices per expert, E * tp chunks in all."""
    tp = M // math.gcd(E, M)
    return tp, E * tp


def moe_decl(cfg) -> dict:
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_ff or cfg.d_ff
    tp, n_chunks = moe_chunking(E)
    if ff % tp:
        raise ValueError(f"expert d_ff {ff} is not a multiple of tp={tp}")
    ff_tp = ff // tp
    decl = {
        "router": P((d, E), ("embed", None)),
        "wg": P((n_chunks, d, ff_tp), ("experts", "embed", None)),
        "wu": P((n_chunks, d, ff_tp), ("experts", "embed", None)),
        "wd": P((n_chunks, ff_tp, d), ("experts", None, "embed")),
    }
    if cfg.n_shared:
        sff = (cfg.moe_ff or cfg.d_ff) * cfg.n_shared
        decl["shared"] = {
            "w_gate": P((d, sff), ("embed", "ff")),
            "w_up": P((d, sff), ("embed", "ff")),
            "w_down": P((sff, d), ("ff", "embed")),
        }
    return decl


def unchunk(w, E: int, ff_axis: int):
    """[n_chunks, a, b] chunk layout -> dense [E, d, ff] (``ff_axis=2``) or
    [E, ff, d] (``ff_axis=1``); a copy where tp > 1. The model does not
    call it (see the module's docstring); it states the layout."""
    n_chunks, a, b = w.shape
    tp = n_chunks // E
    if tp == 1:
        return w
    w4 = w.reshape(E, tp, a, b)
    if ff_axis == 2:
        return w4.permute(0, 2, 1, 3).reshape(E, a, tp * b)
    return w4.reshape(E, tp * a, b)


def _route(xt, router, top_k: int):
    """xt: [T, d] -> (weights [T, k] in xt's dtype, expert ids [T, k], the
    load-balancing aux loss, a 0-d f32 tensor). Gates are an f32 softmax;
    the top k are renormalised to sum to 1."""
    logits = xt.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(gates, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    E = router.shape[-1]
    me = gates.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=xt.device)) \
        / idx.numel()
    aux = E * torch.sum(me * ce)
    return w.to(xt.dtype), idx, aux


def _dispatch(xt, idx, E: int, C: int):
    """Scatter tokens into an expert-major buffer [E, C, d] with capacity C.
    A (token, choice) pair's place in its expert counts over the flat
    [T * k] order (token-major); pairs past C are dropped. Returns (buffer,
    slot [T * k] (E * C where dropped), keep [T * k])."""
    T, k = idx.shape
    flat_e = idx.reshape(-1)
    # expert-major [E, T * k]: the running count is a scan along the inner
    # dim (a scan along the outer dim of [T * k, E] runs E lanes serially)
    onehot = F.one_hot(flat_e, E).t()
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_in_e = pos.gather(0, flat_e[None, :])[0]
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(flat_e, E * C))
    # kept slots are distinct; every dropped pair lands in the spare slot
    # E * C, which is cut off (no host sync, unlike indexing by `keep`)
    tokens = torch.arange(T, device=xt.device).repeat_interleave(k)
    token_of_slot = torch.zeros(E * C + 1, dtype=torch.long,
                                device=xt.device).scatter_(0, slot, tokens)
    filled = torch.zeros(E * C + 1, dtype=torch.bool,
                         device=xt.device).scatter_(
        0, slot, torch.ones_like(keep))
    buf = torch.where(filled[:E * C, None], xt[token_of_slot[:E * C]],
                      torch.zeros((), dtype=xt.dtype, device=xt.device))
    return buf.reshape(E, C, xt.shape[1]), slot, keep


def _experts(buf, p, E: int, dtype, r: int = 0, m: int = 1):
    """The routed experts' SwiGLU over the chunk layout, on the ``r``-th of
    ``m`` contiguous slices of the chunks (a model axis of size m; ``p``
    holds that slice, all of them on the local path): buf [E, C, d] ->
    [E, C, d], zero outside the slice's experts. Each of an expert's chunks
    computes its slice of d_ff and its partial down-projection, and the
    partials are summed."""
    _, C, d = buf.shape
    cpr = p["wg"].shape[0]                    # chunks in the slice
    tp = cpr * m // E                         # chunks an expert in all
    n_exp = max(1, cpr // tp)                 # experts they cover
    e0 = (r * cpr) // tp
    per = cpr // n_exp                        # chunks an expert here
    xb = buf[e0:e0 + n_exp]
    if per > 1:
        xb = xb.repeat_interleave(per, dim=0)
    h = torch.bmm(xb, p["wg"].to(dtype))
    u = torch.bmm(xb, p["wu"].to(dtype))
    out = torch.bmm(F.silu(h) * u, p["wd"].to(dtype))     # [cpr, C, d]
    if per > 1:
        out = out.view(n_exp, per, C, d).sum(dim=1)
    return out if n_exp == E else F.pad(out, (0, 0, 0, 0, e0,
                                              E - e0 - n_exp))


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens."""
    return max(1, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def dropless(cfg) -> bool:
    """Whether the configuration can drop no pair at any call: its capacity
    factor is at least E / k, so that ``capacity(cfg, T) >= T`` at every
    T. Off a mesh its block takes the grouped path."""
    return cfg.top_k * cfg.capacity_factor >= cfg.n_experts


def syncs(cfg) -> bool:
    """Whether a call of the block off a mesh reads a device value on the
    host: the grouped path (``dropless``) in another type than bf16, where
    ``_grouped_mm`` loops over the groups on the host. A CUDA graph cannot
    hold such a call."""
    return dropless(cfg) and cfg.compute_dtype != "bfloat16"


def _group(idx, E: int):
    """The (token, choice) pairs [T * k] sorted by expert, token-major
    within one: (order, ends), the pairs' flat indices in that order and
    each expert's group's end (int32, on the device)."""
    sorted_key, order = torch.sort(idx.reshape(-1), stable=True)
    ends = torch.searchsorted(
        sorted_key, torch.arange(E, device=idx.device, dtype=idx.dtype),
        right=True, out_int32=True)
    return order, ends


def _grouped(xt, w, order, ends, p, k: int):
    """The grouped experts: each sorted pair's row through its expert's
    SwiGLU over the chunk layout (an expert's ``tp`` chunks read the same
    rows; their partial down-projections are summed), weighted by its gate
    and added into its token's row -> [T, d] f32."""
    T, d = xt.shape
    N = order.numel()
    dtype = xt.dtype
    E = ends.numel()
    tp = p["wg"].shape[0] // E
    ff_tp = p["wg"].shape[2]
    wg, wu = (p[n].view(E, tp, d, ff_tp) for n in ("wg", "wu"))
    wd = p["wd"].view(E, tp, ff_tp, d)
    tok = order // k
    gate = w.reshape(-1)[order]
    y = torch.zeros(T, d, dtype=torch.float32, device=xt.device)
    rows = max(1, GROUPED_SLICE_BYTES // (ff_tp * xt.element_size()))
    for s in range(0, N, rows):
        n = min(rows, N - s)
        offs = (ends - s).clamp_(0, n)
        xs = xt[tok[s:s + n]]
        out = None
        for j in range(tp):
            h = torch._grouped_mm(xs, wg[:, j].to(dtype), offs=offs)
            u = torch._grouped_mm(xs, wu[:, j].to(dtype), offs=offs)
            part = torch._grouped_mm(F.silu(h) * u, wd[:, j].to(dtype),
                                     offs=offs)
            out = part if out is None else out + part
        y.index_add_(0, tok[s:s + n], (out * gate[s:s + n, None]).float())
    return y


def moe_apply(p, x, cfg, *, model_axis=None, all_axes=(), mesh=None):
    """The MoE block over x [B, S, d] -> (y [B, S, d], aux loss). With a
    ``model_axis`` it runs on one rank's local shards of ``mesh`` (under
    ``local_map``): ``p`` holds the rank's chunks (and its slice of the
    shared experts' d_ff), and the outputs are summed over ``model_axis``
    and the aux loss averaged over ``all_axes``. Its four stages run in
    spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
    ``moe.combine`` (the shared experts and the sums over ranks in the
    last). Off a mesh, a configuration that can drop no pair
    (``dropless``) takes the grouped path, every other call the capacity
    path."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)

    with _trace.span("moe.route", cat="model"):
        w, idx, aux = _route(xt, p["router"], k)
    if model_axis is None and dropless(cfg):
        # the grouped path: its experts' stage a device span, its calls
        # and pairs counted
        _metrics.counter("bullion.moe.grouped_calls").inc()
        _metrics.counter("bullion.moe.grouped_pairs").inc(T * k)
        with _trace.span("moe.dispatch", cat="model", path="grouped"):
            order, ends = _group(idx, E)
        with _trace.device_span("moe.experts", cat="model", path="grouped",
                                tokens=T, pairs=T * k, experts=E):
            y = _grouped(xt, w, order, ends, p, k)
        with _trace.span("moe.combine", cat="model"):
            y, aux = _combine(p, xt, y.to(x.dtype), aux, None, all_axes,
                              mesh)
        return y.reshape(B, S, d), aux
    with _trace.span("moe.dispatch", cat="model"):
        buf, slot, keep = _dispatch(xt, idx, E, C)
    with _trace.span("moe.experts", cat="model"):
        if model_axis is None:
            out = _experts(buf, p, E, x.dtype)
        else:
            dim = list(mesh.mesh_dim_names).index(model_axis)
            out = _experts(buf, p, E, x.dtype,
                           mesh.get_local_rank(model_axis), mesh.size(dim))
        out = out.reshape(E * C, d)

    with _trace.span("moe.combine", cat="model"):
        # each (token, choice) pair's output, weighted, summed over k
        gathered = torch.where(keep[:, None],
                               out[torch.clamp(slot, max=E * C - 1)],
                               torch.zeros((), dtype=x.dtype,
                                           device=x.device))
        y = (gathered.reshape(T, k, d) * w[..., None]).sum(dim=1)
        y, aux = _combine(p, xt, y, aux, model_axis, all_axes, mesh)
    return y.reshape(B, S, d), aux


def _combine(p, xt, y, aux, model_axis, all_axes, mesh):
    """The shared experts added to the routed output y [T, d], the sum over
    ``model_axis`` and the aux loss's mean over ``all_axes``."""
    if "shared" in p:
        sp = p["shared"]
        g = xt @ sp["w_gate"].to(xt.dtype)
        u = xt @ sp["w_up"].to(xt.dtype)
        y = y + (F.silu(g) * u) @ sp["w_down"].to(xt.dtype)
    if model_axis is not None:
        y = psum(y, mesh, (model_axis,))
    if all_axes:
        aux = pmean(aux, mesh, all_axes)
    return y, aux


def moe_specs(p, cfg, mesh, batch_axes):
    """The sharded path's specs: (the parameters' tree, x's)."""
    xspec = (batch_axes, None, None)
    wspec = ("model", None, None)
    pspec = {"router": (None, None), "wg": wspec, "wu": wspec, "wd": wspec}
    if "shared" in p:
        pspec["shared"] = {"w_gate": (None, "model"),
                           "w_up": (None, "model"),
                           "w_down": ("model", None)}
    return pspec, xspec


def sharded_route(p, dist) -> bool:
    """The reference's rule: the sharded path where the mesh has a 'model'
    axis and it divides the chunks."""
    if dist is None or dist.mesh is None:
        return False
    axes = mesh_axes(dist.mesh)
    return "model" in axes and p["wg"].shape[0] % axes["model"] == 0


_LEAVES = ("router", "wg", "wu", "wd")
_SHARED = ("w_gate", "w_up", "w_down")


def moe_block(p, x, cfg, dist=None):
    """Entry point: the sharded path on a mesh where ``sharded_route``
    allows it; the whole block on every rank on another mesh; the local
    path for plain tensors."""
    if not isinstance(x, DTensor):
        return moe_apply(p, x, cfg)
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    shared = "shared" in p
    tensors = [p[n] for n in _LEAVES]
    if shared:
        tensors += [p["shared"][n] for n in _SHARED]

    def local(*args):
        lp = dict(zip(_LEAVES, args[:4]))
        if shared:
            lp["shared"] = dict(zip(_SHARED, args[4:7]))
        if not sharded:
            return moe_apply(lp, args[-1], cfg)
        return moe_apply(lp, args[-1], cfg, model_axis="model",
                         all_axes=varying, mesh=mesh)

    rep = (Replicate(),) * mesh.ndim
    sharded = sharded_route(p, dist)
    if not sharded:
        # every rank the whole block: the same values, the same gradients
        specs = [rep] * (len(tensors) + 1)
        fn = local_map(local, out_placements=(rep, rep), in_placements=tuple(specs),
                       in_grad_placements=tuple(specs), device_mesh=mesh,
                       redistribute_inputs=True)
        return fn(*tensors, x)
    batch_axes = dist.batch_axes_for(x.shape[0])
    pspec, xspec = moe_specs(p, cfg, mesh, batch_axes)
    specs = [placements(pspec[n], mesh) for n in _LEAVES]
    if shared:
        specs += [placements(pspec["shared"][n], mesh) for n in _SHARED]
    specs.append(placements(xspec, mesh))
    # the axes whose ranks compute different partial outputs: 'model' (its
    # chunk slices) and the axes x's batch is sharded over. A replicated
    # input's gradient is a partial sum over those; on any other axis every
    # rank computes the same block on the same rows, and its gradient is
    # replicated. The aux loss is averaged over the same axes.
    batch = batch_axes if isinstance(batch_axes, tuple) else \
        (batch_axes,) if batch_axes else ()
    varying = ("model",) + batch
    grads = [tuple(Partial() if isinstance(q, Replicate) and a in varying
                   else q for a, q in zip(names, sp)) for sp in specs]
    fn = local_map(local, out_placements=(specs[-1], rep),
                   in_placements=tuple(specs), in_grad_placements=tuple(grads),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*tensors, x)
