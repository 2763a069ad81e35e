"""The port's ``bullion`` CLI (``python -m repro_torch.cli``) on the CPU,
held against the reference's: the cases of tests/test_cli.py run through
both packages, each shard written by its own package's writer, with equal
exit codes, equal printed output and equal ``fsck --json`` reports, clean
and corrupted; a bfloat16 column; the ``--socket`` modes against a port
server; and the module run as a program."""

import json
import os
import re
import subprocess
import sys

import numpy as np

from service_parity import assert_same, pkg

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _write(P, path, *, n=600, collect_stats=True, quant=False, lists=False,
           rows_per_group=128, page_rows=64):
    P.clear_footer_cache()
    schema = [P.ColumnSpec("id", "int64"), P.ColumnSpec("tag", "string")]
    if quant:
        schema.append(P.ColumnSpec("q", "float32", quant=P.QuantSpec(
            P.QuantMode.INT8_AFFINE, scale=0.5, zero=10.0)))
    else:
        schema.append(P.ColumnSpec("q", "float32"))
    if lists:
        schema.append(P.ColumnSpec("seq", "list<int64>"))
    w = P.BullionWriter(str(path), schema, rows_per_group=rows_per_group,
                        collect_stats=collect_stats, page_rows=page_rows)
    ids = np.arange(n, dtype=np.int64)
    table = {"id": ids, "tag": [b"t%d" % v for v in ids],
             "q": (ids % 50).astype(np.float32)}
    if lists:
        table["seq"] = [np.arange(v % 5, dtype=np.int64) for v in ids]
    w.write_table(table)
    w.close()
    return str(path)


def _run(P, capsys, argv):
    """(exit code, stdout, stderr) of ``bullion argv``."""
    capsys.readouterr()
    code = P.cli.main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


def _flip(P, path, page=0, at=5):
    fv, _ = P.read_footer(path)
    off = int(fv.arr(P.Sec.PAGE_OFFSET, np.uint64)[page])
    with open(path, "r+b") as f:
        f.seek(off + at)
        b = f.read(1)
        f.seek(off + at)
        f.write(bytes([b[0] ^ 0xFF]))
    P.clear_footer_cache()


# ---------------------------------------------------------------------------
# inspect
# ---------------------------------------------------------------------------


def _inspect(P, d, capsys, *argv, **kw):
    return _run(P, capsys, ["inspect", *argv,
                            _write(P, d / "a.bln", **kw)])


def test_inspect_reports_layout(tmp_path, capsys):
    code, out, _ = assert_same(tmp_path, _inspect, capsys=capsys, lists=True)
    assert code == 0 and "bullion v3" in out and "rows=600" in out
    assert all(n in out for n in ("id", "tag", "q", "seq", "META",
                                  "PAGE_CHECKSUM", "group 0:"))


def test_inspect_pages_table(tmp_path, capsys):
    code, out, _ = assert_same(tmp_path, lambda P, d, capsys: _inspect(
        P, d, capsys, "--pages", lists=True), capsys=capsys)
    assert code == 0 and "zone map" in out and "sketch" in out
    assert "page" in out and "scalar" in out


def test_inspect_quantized_column(tmp_path, capsys):
    code, out, _ = assert_same(tmp_path, _inspect, capsys=capsys, quant=True)
    assert code == 0 and "int8_affine" in out


def _inspect_missing(P, d, capsys):
    return _run(P, capsys, ["inspect", str(d / "nope.bln")])


def test_inspect_missing_path_is_usage_error(tmp_path, capsys):
    code, _, err = assert_same(tmp_path, _inspect_missing, capsys=capsys)
    assert code == 2 and "does not exist" in err


# ---------------------------------------------------------------------------
# fsck
# ---------------------------------------------------------------------------


def _fsck_versions(P, d, capsys):
    paths = [_write(P, d / "v0.bln", collect_stats=False),
             _write(P, d / "v3.bln", lists=True),
             _write(P, d / "quant.bln", quant=True)]
    deleted = _write(P, d / "del.bln")
    P.delete_rows(deleted, np.arange(0, 600, 7))
    l1 = _write(P, d / "dv.bln")
    P.delete_rows(l1, np.arange(0, 600, 11), level=P.Compliance.LEVEL1)
    paths += [deleted, l1]
    return [_run(P, capsys, ["fsck", "-v"] + paths),
            _run(P, capsys, ["fsck", "--json"] + paths)]


def test_fsck_clean_across_format_versions(tmp_path, capsys):
    (code, out, _), (jcode, report, _) = assert_same(
        tmp_path, _fsck_versions, capsys=capsys)
    assert code == jcode == 0 and "5 shard(s) clean" in out
    assert "CORRUPT" not in out and json.loads(report)["errors"] == 0


def _fsck_flipped(P, d, capsys):
    p = _write(P, d / "a.bln", lists=True)
    _flip(P, p)
    return [_run(P, capsys, ["fsck", p]), _run(P, capsys, ["fsck", "--json",
                                                           p])]


def test_fsck_detects_flipped_page_byte(tmp_path, capsys):
    (code, out, _), (jcode, report, _) = assert_same(
        tmp_path, _fsck_flipped, capsys=capsys)
    assert code == jcode == 1
    assert "checksum mismatch" in out and "CORRUPT" in out
    rep = json.loads(report)
    assert rep["shards"][0]["categories"]["checksums"]["failed"] == 1


def _fsck_truncated(P, d, capsys):
    p = _write(P, d / "t.bln")
    fv, foot_off = P.read_footer(p)
    P.invalidate_cached_footer(p)
    raw = open(p, "rb").read()
    off, size = fv._dir[int(P.Sec.PAGE_SIZE)]
    sizes = np.frombuffer(fv.raw(P.Sec.PAGE_SIZE), np.uint64).copy()
    sizes[-1] += 10_000_000
    patched = bytearray(raw)
    patched[foot_off + off:foot_off + off + size] = sizes.tobytes()
    open(p, "wb").write(bytes(patched))
    return [_run(P, capsys, ["fsck", p]), _run(P, capsys, ["fsck", p])]


def test_fsck_detects_truncated_data_region(tmp_path, capsys):
    (code, out, _), (again, _, _) = assert_same(tmp_path, _fsck_truncated,
                                                capsys=capsys)
    assert code == again == 2 and "UNUSABLE" in out


def _fsck_missing(P, d, capsys):
    return [_run(P, capsys, ["fsck", str(d / "missing")]),
            _run(P, capsys, ["fsck", "--json", str(d / "missing")])]


def test_fsck_missing_path_is_usage_error(tmp_path, capsys):
    (code, _, _), (jcode, report, _) = assert_same(tmp_path, _fsck_missing,
                                                   capsys=capsys)
    assert code == jcode == 2 and json.loads(report)["exit"] == 2


def _bf16(P, d, capsys, flip):
    """A bfloat16 column (the port's writer takes its uint16 bit patterns,
    the reference's the ml_dtypes values), NaN and infinities among
    them."""
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    x[[3, 700, 2000]] = [np.nan, np.inf, -np.inf]
    u = x.view(np.uint32)
    bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    if P.name == "ref":
        import ml_dtypes
        col = bits.view(ml_dtypes.bfloat16)
    else:
        col = bits
    p = str(d / "b.bln")
    w = P.BullionWriter(p, [P.ColumnSpec("id", "int64"),
                            P.ColumnSpec("x", "bfloat16")],
                        rows_per_group=1024, page_rows=256)
    w.write_table({"id": np.arange(4096, dtype=np.int64), "x": col})
    w.close()
    if flip:
        fv, _ = P.read_footer(p)
        _flip(P, p, page=fv.chunk_pages(0, 1)[0], at=40)
    return [_run(P, capsys, ["fsck", "--json", p]),
            _run(P, capsys, ["inspect", "--pages", p])]


def test_fsck_and_inspect_bfloat16_column(tmp_path, capsys):
    """The port decodes a bfloat16 page as its bits and widens them for the
    checks: reports and exit codes equal to the reference's, clean and
    with a flipped byte in an x page."""
    for case in ("clean", "flipped"):
        (tmp_path / case).mkdir()
    (code, report, _), (icode, out, _) = assert_same(
        tmp_path / "clean", _bf16, capsys=capsys, flip=False)
    rep = json.loads(report)
    assert code == 0 and icode == 0 and "bfloat16" in out
    assert rep["shards"][0]["categories"]["sketches"]["checks"] > 0
    (code, report, _), _ = assert_same(tmp_path / "flipped", _bf16,
                                       capsys=capsys, flip=True)
    assert code == 1 and json.loads(report)["errors"] >= 1


# ---------------------------------------------------------------------------
# log + metrics printers
# ---------------------------------------------------------------------------


RECORDS = [
    {"ts": 1e9, "origin": "serve", "dataset": "ads", "tenant": "a",
     "fingerprint": "abcdef0123456789", "cache_hit": True, "rows": 42,
     "wall_seconds": 0.0123, "outcome": "ok", "slow": False},
    {"ts": 1e9, "origin": "serve.wire", "dataset": "", "tenant": "-",
     "rows": 0, "wall_seconds": 0.0, "outcome": "error",
     "error": "ValueError: bad frame", "slow": False},
]


def _log_jsonl(P, d, capsys):
    sink = d / "q.jsonl"
    sink.write_text("".join(json.dumps(r) + "\n" for r in RECORDS))
    return [_run(P, capsys, ["log", str(sink)]),
            _run(P, capsys, ["log", "-n", "1", str(sink)]),
            _run(P, capsys, ["log", str(d / "none.jsonl")])]


def test_log_pretty_prints_jsonl(tmp_path, capsys):
    (code, out, _), (code1, out1, _), (missing, _, err) = assert_same(
        tmp_path, _log_jsonl, capsys=capsys)
    assert code == code1 == 0 and missing == 2
    assert "ads" in out and "abcdef012345" in out and "hit" in out
    assert "ValueError: bad frame" in out
    assert "2 record(s), 1 error(s)" in out and "1 record(s)" in out1


def _over_socket(P, d, capsys, client):
    """``log``/``metrics --socket`` of package ``client`` against ``P``'s
    server."""
    shard = _write(P, d / "a.bln", lists=True)
    with P.DatasetServer({"t": shard}) as srv:
        sock = srv.serve()
        srv.query("t", where=P.C("id") == 3)
        code, out, _ = _run(pkg(client), capsys, ["log", "--socket", sock])
        # the record less its clock readings: the timestamp and the ms
        log = (code, re.sub(r"^\S+ | +\d+\.\d+ ms", "", out, flags=re.M))
        mcode, metrics, _ = _run(pkg(client), capsys,
                                 ["metrics", "--socket", sock])
    return [log, mcode, "bullion_serve_queries" in metrics,
            pkg(client).expose.parse_prometheus_text(metrics) is not None]


def test_log_and_metrics_over_socket(tmp_path, capsys):
    (code, out), mcode, has_queries, parsed = assert_same(
        tmp_path, lambda P, d, capsys: _over_socket(P, d, capsys, P.name),
        capsys=capsys)
    assert code == mcode == 0 and has_queries and parsed
    assert "serve" in out and "1 record(s)" in out


def test_port_cli_against_reference_server(tmp_path, capsys):
    """The port's ``log``/``metrics --socket`` read a reference server as
    the reference's own CLI does."""
    d = tmp_path / "x"
    d.mkdir()
    want = _over_socket(pkg("ref"), d, capsys, "ref")
    d = tmp_path / "y"
    d.mkdir()
    got = _over_socket(pkg("ref"), d, capsys, "port")
    assert got == want and got[2]


def _metrics_local(P, d, capsys):
    code, out, _ = _run(P, capsys, ["metrics"])
    P.expose.parse_prometheus_text(out)
    return code


def test_metrics_local_renders(tmp_path, capsys):
    assert assert_same(tmp_path, _metrics_local, capsys=capsys) == 0


def test_cli_runs_as_a_module(tmp_path):
    """``python -m repro_torch.cli fsck --json`` in a fresh interpreter:
    exit 0 on a clean shard, 1 after a flipped page byte."""
    P = pkg("port")
    p = _write(P, tmp_path / "a.bln")
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.cli", "fsck", "--json", p]
    res = subprocess.run(cmd, env=env, capture_output=True, timeout=120)
    assert res.returncode == 0 and json.loads(res.stdout)["exit"] == 0
    _flip(P, p)
    res = subprocess.run(cmd, env=env, capture_output=True, timeout=120)
    assert res.returncode == 1 and json.loads(res.stdout)["errors"] == 1
