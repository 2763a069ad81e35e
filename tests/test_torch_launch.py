"""The port's launch analysis (``repro_torch.launch.{hlo_cost,roofline,
dryrun,report}``) against the JAX package's.

The reference counts the HLO text of a compiled program; the port counts
the ops that run (``hlo_cost.Counter``). So the cost tests mirror
``tests/test_hlo_cost.py`` on the same shapes and hold the port's counts to
the reference's ``analyze``: a matmul exactly, a loop by its trips, a
gradient against its forward, bytes by the loop. Each smoke config's
prefill counts the reference's FLOPs exactly (minicpm3-4b with the PV work
of V padded from v_head_dim to the qk dim, which the port's MLA adds), and
its training step (loss and every gradient) within 2%: the difference is
the plain attention backward's recompute of the scores
(``attention_bwd_ref``'s QK^T), counted exactly.

The reference's own dry run fails under jax 0.9 (``ROADMAP.md`` §3), so the
specs and the dry run are held to it as the distributed path is: the cache
specs leaf by leaf on stand-in meshes, and the dry run of the reference's
test (``test_dryrun_single_cell_small``) on a fake 512-rank group, in a
subprocess (a fake group cannot share a process with another default
group).
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.devices()      # the backend is up before the reference's dry run is read
_xla_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jdryrun  # noqa: E402  (sets XLA_FLAGS)
if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

import repro.configs as jconfigs  # noqa: E402
import repro.launch.report as jreport  # noqa: E402
import repro.launch.roofline as jroofline  # noqa: E402
from repro.distributed import make_dist as jmake_dist  # noqa: E402
from repro.launch.hlo_cost import analyze as janalyze  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.distributed import make_dist  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import dryrun, hlo_cost, mesh as tmesh  # noqa: E402
from repro_torch.launch import report, roofline  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _flops(fn, *args) -> float:
    return hlo_cost.analyze(fn, *args)["flops"]


# ---------------------------------------------------------------------------
# the count (mirrors of tests/test_hlo_cost.py)
# ---------------------------------------------------------------------------


def test_matmul_flops_exact():
    x, w = torch.zeros(256, 512), torch.zeros(512, 128)
    want = janalyze(_text(lambda x, w: x @ w, _sds(256, 512), _sds(512, 128)),
                    1)["flops"]
    assert _flops(lambda: x @ w) == want == 2 * 256 * 512 * 128


def _ref_loop_ratio(trips: tuple) -> float:
    """The reference's count of nested scans of a matmul (``trips`` from
    the outermost) over its count of one matmul."""
    def nest(c, w, depth):
        if depth == len(trips):
            return c @ w
        return jax.lax.scan(lambda c, _: (nest(c, w, depth + 1), None), c,
                            None, length=trips[depth])[0]

    s = (_sds(128, 128), _sds(128, 128))
    single = janalyze(_text(lambda x, w: x @ w, *s), 1)["flops"]
    return janalyze(_text(lambda x, w: nest(x, w, 0), *s), 1)["flops"] / single


@pytest.mark.parametrize("trips", [(12,), (3, 5)], ids=["loop_12", "nest_3x5"])
def test_loop_counts_every_trip(trips):
    """A Python loop of 12 matmuls counts 12 of them, a 3 x 5 nest 15, as
    the reference's trip counts of a scan and a nested scan do."""
    x, w = torch.zeros(128, 128), torch.zeros(128, 128)

    def loops(c):
        for _ in range(int(np.prod(trips))):
            c = c @ w
        return c

    single = _flops(lambda: x @ w)
    ratio = _flops(loops, x) / single
    assert ratio == int(np.prod(trips))
    assert abs(_ref_loop_ratio(trips) - ratio) < 0.01


def test_grad_counts_more_than_forward():
    x = torch.zeros(128, 128)
    w = torch.zeros(128, 128, requires_grad=True)
    fwd = _flops(lambda: torch.tanh(x @ w).sum())
    bwd = _flops(lambda: torch.autograd.grad(torch.tanh(x @ w).sum(), w))
    assert bwd >= 2 * fwd


def test_bytes_scale_with_loop():
    x = torch.zeros(128, 128)

    def loop(c):
        for _ in range(10):
            c = torch.tanh(c)
        return c

    one = hlo_cost.analyze(torch.tanh, x)["bytes"]
    ten = hlo_cost.analyze(loop, x)["bytes"]
    assert one == 128 * 128 * 4 and ten == 10 * one


def test_bytes_follow_the_reference_rules():
    """Views are free, a dot counts its operands and result, a gather
    twice its result, an in-place update twice the update, anything else
    its result."""
    a, b = torch.zeros(64, 32), torch.zeros(32, 16)
    idx = torch.zeros(8, dtype=torch.long)
    assert hlo_cost.analyze(lambda: (a.t(), a.view(-1), a[2:5]))["bytes"] \
        == 0
    assert hlo_cost.analyze(lambda: a @ b)["bytes"] == 4 * (64 * 32 + 32 * 16
                                                          + 64 * 16)
    assert hlo_cost.analyze(lambda: a[idx])["bytes"] == 2 * 8 * 32 * 4
    c = torch.zeros(64, 32)
    assert hlo_cost.analyze(lambda: c[:4].copy_(a[:4]))["bytes"] \
        == 2 * 4 * 32 * 4
    assert hlo_cost.analyze(lambda: a + 1)["bytes"] == 64 * 32 * 4


def test_flash_operator_counts_by_its_formula():
    """The flash forward counts 2·B·H·S·S·(Dqk + Dv) on the plain version,
    as on the kernel, masked pairs included; its fake route launches
    nothing and refuses a tensor with storage."""
    from repro_torch.kernels.flash_attention import attention
    q = torch.randn(2, 24, 4, 16)
    k, v = torch.randn(2, 24, 2, 16), torch.randn(2, 24, 2, 16)
    want = 2 * 2 * 4 * 24 * 24 * (16 + 16)
    assert _flops(lambda: attention(q, k, v, causal=True, window=5)) == want
    with pytest.raises(ValueError, match="fake or meta"):
        flash_ops._shape_only(q, k, v, True, 0, 24, "auto")
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fq = torch.empty(2, 24, 4, 16)
        fk, fv = torch.empty(2, 24, 2, 16), torch.empty(2, 24, 2, 16)
        out = attention(fq, fk, fv)
        assert out.shape == fq.shape
        assert _flops(lambda: attention(fq, fk, fv)) == want
    assert flash_ops.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# the smoke configs' prefill and training step against the reference
# ---------------------------------------------------------------------------

B, T, CACHE = 2, 32, 64


def _pair(arch):
    jcfg = jconfigs.get_smoke(arch).scaled(compute_dtype="float32")
    tcfg = tconfigs.get_smoke(arch).scaled(compute_dtype="float32")
    jm = jzoo.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, tzoo.build(tcfg, device="cpu")


def _batch(cfg, T_):
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T_)).astype(np.int32)}
    if cfg.encoder is not None:
        b["frames"] = rng.normal(size=(B, cfg.encoder.seq, cfg.d_model)
                                 ).astype(np.float32)
    return b


def _padded_pv(cfg) -> int:
    """The PV work of MLA's V padded from v_head_dim to the qk dim: 2·B·H·
    T·T·(dn + dr - dv) a layer (``models/mla.py``)."""
    if cfg.mla is None:
        return 0
    m = cfg.mla
    layers = sum(rep * sum(b.startswith("mla") for b in blocks)
                 for blocks, rep in cfg.segments)
    pad = m.qk_nope_head_dim + m.qk_rope_head_dim - m.v_head_dim
    return layers * 2 * B * cfg.n_heads * T * T * pad


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_moe_16b",
                                  "rwkv6_7b", "recurrentgemma_9b",
                                  "minicpm3_4b"])
def test_prefill_flops_match_reference(arch):
    """The port's prefill (the flash operator by its formula) counts the
    reference's compiled prefill's FLOPs exactly; minicpm3-4b's exceed them
    by the padded PV work alone."""
    jm, params, tm = _pair(arch)
    batch = _batch(tm.cfg, T)
    jcache = jax.eval_shape(lambda: jm.init_cache(B, CACHE, jnp.float32))
    want = janalyze(_text(jm.prefill, params,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jcache), 1)["flops"]
    tcache = tm.init_cache(B, CACHE, torch.float32)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    with torch.no_grad():
        got = _flops(tm.prefill, tb, tcache)
    assert got == want + _padded_pv(tm.cfg)


def _attention_recompute(cfg, T_) -> int:
    """QK^T of the plain attention backward (``attention_bwd_ref``
    recomputes the scores; the reference's autodiff keeps them): 2·B·H·S·S·D
    for each layer whose training attention is the flash operator (the
    encoder's over its frames, each decoder self-attention over T)."""
    if cfg.encoder is not None:
        S = cfg.encoder.seq
        return 2 * B * cfg.n_heads * cfg.head_dim * (
            cfg.encoder.n_layers * S * S + cfg.n_layers * T_ * T_)
    layers = sum(rep * sum(b.split(":")[0] in ("full", "window", "local",
                                               "global") for b in blocks)
                 for blocks, rep in cfg.segments)
    return layers * 2 * B * cfg.n_heads * T_ * T_ * cfg.head_dim


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_moe_16b",
                                  "whisper_base"])
def test_train_flops_within_two_percent_of_reference(arch):
    """The loss and every gradient count within 2% of the reference's
    ``value_and_grad``; the whole difference is the plain backward's
    recompute of QK^T (``attention_bwd_ref``)."""
    jm, params, tm = _pair(arch)
    batch = _batch(tm.cfg, T + 1)
    want = janalyze(_text(jax.value_and_grad(jm.loss), params,
                          {k: jnp.asarray(v) for k, v in batch.items()}),
                    1)["flops"]
    tm.requires_grad_(True)
    leaves = list(tm.parameters())
    got = _flops(lambda: torch.autograd.grad(tm.loss(batch), leaves))
    assert abs(got - want) < 0.02 * want
    assert got - want == _attention_recompute(tm.cfg, T)


# ---------------------------------------------------------------------------
# roofline and report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_roofline_matches_reference(arch, monkeypatch):
    """``model_flops``, ``active_params`` and ``roofline_terms`` equal the
    reference's on every shape, its formula given the card's constants
    (NVLink where it reads one ICI link)."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroofline, "HBM_BW", tmesh.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", tmesh.NVLINK_BW)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    n = tzoo.build(tcfg, device="meta").n_params
    assert n == jzoo.build(jcfg).n_params
    act = roofline.active_params(tcfg, n)
    assert act == jroofline.active_params(jcfg, n)
    for name, shape in SHAPES.items():
        mf = roofline.model_flops(tcfg, shape, n, act)
        assert mf == jroofline.model_flops(jcfg, JSHAPES[name], n, act)
        for terms in ((mf / 256, mf / 1e3, mf / 1e4),
                      (1.0, 5e12, 2.0), (0.0, 0.0, 0.0)):
            assert roofline.roofline_terms(*terms) == \
                jroofline.roofline_terms(*terms)


def test_parse_collectives_sums_the_counted_kinds():
    counted = {"collective_by_kind": {"all-gather": 10.0, "all-reduce": 5.5},
               "collective_counts": {"all-gather": 2.0, "all-reduce": 1.0}}
    assert roofline.parse_collectives(counted) == {
        "bytes_by_kind": {"all-gather": 10.0, "all-reduce": 5.5},
        "counts": {"all-gather": 2, "all-reduce": 1}, "total_bytes": 15.5}


def _record(arch, shape, mesh, i):
    if i % 7 == 3:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "skipped", "reason": "x"}
    if i % 7 == 5:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "error", "error": "ValueError: " + "y" * 80}
    t = roofline.roofline_terms(1e12 * (i + 1), 3e9 * (7 - i % 7), 1e8 * i)
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "roofline": t, "useful_flops_ratio": None if i % 5 == 0
            else 0.1 * i}


@pytest.mark.parametrize("tag", ["", "baseline"])
def test_report_table_matches_reference(tmp_path, monkeypatch, tag):
    """The same records render the same table text in both packages (a
    missing cell, a skip, an error and ok cells, both meshes)."""
    i = 0
    for arch in jreport.ARCH_ORDER[:7]:
        for shape in jreport.SHAPE_ORDER:
            for mesh in ("16x16", "2x16x16"):
                i += 1
                if i % 11 == 0:
                    continue              # a missing cell
                suffix = f"__{tag}" if tag else ""
                name = f"{arch.replace('.', '_')}__{shape}__{mesh}{suffix}"
                (tmp_path / f"{name}.json").write_text(
                    json.dumps(_record(arch, shape, mesh, i)))
    monkeypatch.setattr(jreport, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(report, "ARTIFACT_DIR", str(tmp_path))
    for mesh in ("16x16", "2x16x16"):
        got = report.table(mesh, tag)
        assert got == jreport.table(mesh, tag)
        assert "missing" in got and "SKIP" in got and "ERROR" in got
    # the port's side-by-side rendering: a row a cell, each mesh's terms
    # as its table shows them, the cells skipped on both meshes named after
    both = report.side_by_side(tag).splitlines()
    rows = {m: report.table(m, tag).splitlines()[2:]
            for m in ("16x16", "2x16x16")}
    by_cell = {tuple(line.split(" | ")[:2]): line for line in both[2:]
               if line.startswith("| ")}
    for a, b in zip(rows["16x16"], rows["2x16x16"]):
        cell = tuple(a.split(" | ")[:2])
        if "SKIP" in a and "SKIP" in b:
            assert cell not in by_cell
            assert f"{cell[0][2:]} {cell[1]}" in both[-1]
            continue
        got = by_cell[cell].split(" | ")
        for mesh_row, text in ((a, got[2]), (b, got[3].rstrip(" |"))):
            terms = mesh_row.split(" | ")[2:6]
            if terms[0] != "-":
                assert text == (f"{terms[0]} / {terms[1]} / {terms[2]} "
                                f"{terms[3]}")


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def _standin(shape: dict):
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape),
                           size=int(np.prod(list(shape.values()))))


def _ref_specs(tree) -> dict:
    from jax.sharding import PartitionSpec
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


def _port_specs(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _port_specs(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _port_specs(x, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cache_specs_match_reference(arch):
    """``cache_specs`` of every shape's cache on both production meshes and
    a small one (stand-ins: all the reference's mesh code reads), leaf by
    leaf: batch over the batch axes, the sequence over 'data' where the
    batch cannot shard (long_500k's B = 1: SP, rolling windows included),
    heads else head dim over 'model', enc-dec k/v stacks, ``pos``."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jm = jzoo.build(jcfg)
    for mesh in ({"data": 16, "model": 16},
                 {"pod": 2, "data": 16, "model": 16},
                 {"data": 2, "model": 4}):
        m = _standin(mesh)
        for name, shape in SHAPES.items():
            if shape.kind == "train":
                continue
            B, S = shape.global_batch, shape.seq_len
            sp = dict(seq_sharded=shape.kind == "decode" and B < mesh["data"])
            jcache = jax.eval_shape(lambda: jm.init_cache(B, S))
            want = _ref_specs(jdryrun.cache_specs(jcache, jcfg,
                                                  jmake_dist(m, **sp)))
            tcache = dryrun.abstract_cache(tcfg, None, B, S)
            got = dict(_port_specs(dryrun.cache_specs(tcache, tcfg,
                                                      make_dist(m, **sp))))
            assert got == want, (mesh, name)
            shapes = dict(_port_specs(tcache))
            assert all(tuple(shapes[k].shape) == v.shape for k, v in
                       _ref_shapes(jcache).items()), (mesh, name)


def _ref_shapes(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
            if leaf.shape != ()}


# ---------------------------------------------------------------------------
# the fake production meshes (one subprocess)
# ---------------------------------------------------------------------------

FAKE = textwrap.dedent("""
    import json, sys, tempfile
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          DTensor, distribute_tensor)
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun, hlo_cost
    out = {}
    mesh = dryrun.fake_world(False)
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 4096, 2048), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(2048, 8192), mesh,
                              [Shard(0), Shard(1)])
        out["local"] = hlo_cost.analyze(lambda: x @ w)["flops"]
        with FlopCounterMode(display=False) as f:
            x @ w
        out["global"] = f.get_total_flops()
        a = distribute_tensor(torch.empty(256, 64), mesh,
                              [Shard(0), Replicate()])
        r = DTensor.from_local(torch.empty(16, 64), mesh,
                               [Replicate(), Partial()])
        for name, fn in (("all-gather", lambda: a.redistribute(
                              mesh, [Replicate(), Replicate()])),
                         ("all-reduce", lambda: r.redistribute(
                              mesh, [Replicate(), Replicate()])),
                         ("reduce-scatter", lambda: r.redistribute(
                              mesh, [Replicate(), Shard(0)]))):
            c = hlo_cost.analyze(fn)
            out[name] = [c["collective_by_kind"], c["collective_counts"]]
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", True,
                          out_dir=tempfile.mkdtemp())
    out["cell"] = {k: rec.get(k) for k in ("status", "error", "n_devices",
                                            "roofline", "memory")}
    # one sharded prefill on a (1, 1) mesh: counted on fake tensors, then
    # run for real over a gloo group of one
    import torch.distributed as tdist
    from repro_torch import configs
    from repro_torch.distributed import make_dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import zoo
    cfg = configs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32")
    keys = ("flops", "bytes", "collective_bytes", "n_ops")
    fake = dryrun.serve_count(cfg, (1, 1), 2, 12, 24, torch.float32)
    out["fake_prefill"] = {k: fake[k] for k in keys}
    tdist.destroy_process_group()
    tdist.init_process_group("gloo", init_method="file://" + tempfile.mkdtemp()
                             + "/rendezvous", rank=0, world_size=1)
    model = zoo.build(cfg, device="cpu", dist=make_dist(make_test_mesh(1, 1)))
    cache = model.init_cache(2, 24, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab, (2, 12))
    with torch.no_grad():
        real = hlo_cost.analyze(model.prefill, {"tokens": tokens}, cache)
    out["real_prefill"] = {k: real[k] for k in keys}
    tdist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_runs():
    r = subprocess.run([sys.executable, "-c", FAKE], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=os.path.join(
                           ROOT, "src")))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_per_device_flops_come_from_the_local_ops(fake_runs):
    """On the fake 16x16 mesh, x [256, 4096, 2048] (batch over data) times
    w [2048, 8192] (over data and model) counts one rank's product, 2 x
    65536 x 2048 x 512, where a FLOP counter around the DTensor op counts
    the whole product."""
    assert fake_runs["local"] == 2 * 65536 * 2048 * 512
    assert fake_runs["global"] == 2 * 256 * 4096 * 2048 * 8192


def test_collective_bytes_by_ring_factors(fake_runs):
    """An all-gather of [256, 64] f32 over data (16), an all-reduce of a
    [16, 64] partial over model (16), and its reduce-scatter to rows over
    model: the reference's ring factors by group size."""
    size, n = 256 * 64 * 4, 16
    assert fake_runs["all-gather"] == [{"all-gather": size * (n - 1) / n},
                                       {"all-gather": 1}]
    shard = 16 * 64 * 4
    assert fake_runs["all-reduce"] == [
        {"all-reduce": shard * 2 * (n - 1) / n}, {"all-reduce": 1}]
    assert fake_runs["reduce-scatter"] == [
        {"reduce-scatter": shard / n * (n - 1)}, {"reduce-scatter": 1}]


def test_dryrun_single_cell_small(fake_runs):
    """The reference's ``test_dryrun_single_cell_small`` on the port: llama
    3.2-1b's decode_32k on the fake 2x16x16 mesh of 512 ranks."""
    rec = fake_runs["cell"]
    assert rec["status"] == "ok", rec["error"]
    assert rec["n_devices"] == 512
    assert rec["roofline"]["bound_s"] > 0
    assert all(v > 0 for v in rec["memory"].values())


def test_fake_count_equals_the_real_sharded_prefill(fake_runs):
    """A sharded prefill (the llama smoke config on a (1, 1) mesh, the flash
    operator on its plain route) counts the same FLOPs, bytes, collective
    bytes and ops as the same shapes on fake tensors (its shape-only
    route): what ``chip_smoke.py`` checks on the card with the kernel."""
    assert fake_runs["real_prefill"] == fake_runs["fake_prefill"]
    assert fake_runs["real_prefill"]["flops"] > 0
