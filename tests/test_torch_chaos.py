"""The port's fault injection (``repro_torch.testing``: ``chaos`` over the
port's own backend module, ``FakeObjectStore``) and the self-healing read
path under it, on the CPU, held against the reference's: the cases of
tests/test_chaos.py and the ``FakeObjectStore`` cases of
tests/test_backend.py run through both packages with equal outcomes
(tables, ``IOStats``, quarantines, fired faults, retries, errors and
``fsck`` verdicts)."""

import dataclasses
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from service_parity import PACKAGES, assert_same, error, pkg, stable_stats

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _reset_all():
    for name in PACKAGES:
        P = pkg(name)
        P.integrity.set_verify_policy(None)
        P.integrity.set_corruption_policy(None)
        P.QUARANTINE.clear()
        P.clear_footer_cache()
        P.querylog.enable_local(False)


@pytest.fixture(autouse=True)
def _reset():
    """Integrity state is process-wide in each package; every test starts
    and ends clean."""
    _reset_all()
    yield
    _reset_all()


def _write(P, path, *, n=600, rows_per_group=128, page_rows=64,
           collect_stats=True, collect_sketches=None):
    schema = [P.ColumnSpec("id", "int64"), P.ColumnSpec("tag", "string"),
              P.ColumnSpec("q", "float32")]
    ids = np.arange(n, dtype=np.int64)
    w = P.BullionWriter(str(path), schema, rows_per_group=rows_per_group,
                        page_rows=page_rows, collect_stats=collect_stats,
                        collect_sketches=collect_sketches)
    w.write_table({"id": ids, "tag": [b"t%d" % v for v in ids],
                   "q": (ids % 50).astype(np.float32)})
    w.close()
    return str(path)


def _flip_page(P, path, page):
    fv, _ = P.read_footer(path)
    off, size = fv.page_extent(page)
    with open(path, "r+b") as f:
        f.seek(off + size // 2)
        b = f.read(1)
        f.seek(off + size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    P.clear_footer_cache()


def _read(P, spec, **kw):
    """(table, IOStats as a dict) of a full scan, or the error."""
    try:
        with P.dataset(spec) as ds:
            table = ds.to_table(**kw)
            return table, stable_stats(dataclasses.asdict(ds.stats))
    except Exception as e:
        return f"{type(e).__name__}: {e}", None


def _quarantined(P):
    return P.QUARANTINE.summary()["quarantined_pages"]


# ---------------------------------------------------------------------------
# decode-time verification
# ---------------------------------------------------------------------------


def _full_raise(P, d):
    p = _write(P, d / "a.bln")
    _flip_page(P, p, 0)
    P.integrity.set_verify_policy("full")
    with pytest.raises(P.ShardCorruptError) as ei:
        with P.dataset(p) as ds:
            ds.to_table()
    e = ei.value
    return [str(e), e.path == p, e.group, e.page, _quarantined(P)]


def test_full_raise_names_shard_group_page(tmp_path):
    msg, same_path, group, page, q = assert_same(tmp_path, _full_raise)
    assert same_path and group == 0 and page == 0 and q == 1
    assert "group 0" in msg and "page 0" in msg


def _verify_off(P, d):
    p = _write(P, d / "a.bln")
    P.integrity.set_verify_policy("off")
    return _read(P, p)


def test_verify_off_skips_hashing(tmp_path):
    _, st = assert_same(tmp_path, _verify_off)
    assert st["pages_verified"] == 0


def _sample(P, d):
    p = _write(P, d / "a.bln")
    P.integrity.set_verify_policy("sample")
    out = [_read(P, p)[1]["pages_verified"], _read(P, p)[1]["pages_verified"]]
    P.integrity.set_verify_policy("full")
    with P.dataset(p) as ds:
        ds.to_table()
        ds.to_table()
        out.append(ds.stats.pages_verified)
    return out


def test_sample_verifies_once_per_footer_cache_entry(tmp_path):
    first, again, full = assert_same(tmp_path, _sample)
    assert first > 0 and again == 0 and full == 2 * first


# ---------------------------------------------------------------------------
# degradation: skip and mask
# ---------------------------------------------------------------------------


def _skip(P, d):
    p = _write(P, d / "a.bln")
    _flip_page(P, p, 0)
    P.integrity.set_verify_policy("full")
    P.integrity.set_corruption_policy("skip")
    P.querylog.enable_local(True)
    table, st = _read(P, p)
    rec = P.querylog.LOG.records()[-1]
    _write(P, d / "a.bln")               # out-of-band repair
    again, st2 = _read(P, p)
    return [table, st, rec.degraded, rec.io["degraded_rows"],
            len(again["id"]), st2["degraded_rows"]]


def test_skip_drops_page_rows_with_exact_accounting(tmp_path):
    table, st, degraded, rows, n_again, again = assert_same(tmp_path, _skip)
    assert st["degraded_rows"] == rows == 64 and degraded
    assert st["pages_quarantined"] == 1
    assert np.array_equal(table["id"], np.arange(64, 600))
    assert n_again == 600 and again == 0


def _mask(P, d):
    p = _write(P, d / "a.bln")
    fv, _ = P.read_footer(p)
    s, _ = fv.chunk_pages(0, fv.column_index("q"))
    _flip_page(P, p, s)
    P.integrity.set_verify_policy("full")
    P.integrity.set_corruption_policy("mask")
    return _read(P, p)


def test_mask_zero_fills_and_keeps_shape(tmp_path):
    table, st = assert_same(tmp_path, _mask)
    assert len(table["id"]) == 600 and st["degraded_rows"] == 64
    assert (np.asarray(table["q"][:64]) == 0.0).all()


# ---------------------------------------------------------------------------
# the chaos harness: transient faults recover by the one re-read
# ---------------------------------------------------------------------------


def _counter(P, name):
    return P.metrics.counter(name).value


def _chaos_read(P, d, kind, **fault):
    p = _write(P, d / "a.bln")
    P.integrity.set_verify_policy("full")
    before = _counter(P, "bullion.integrity.reread_recovered")
    with P.chaos() as ctl:
        f = ctl.inject(kind, **fault)
        table, st = _read(P, p, io_depth=4 if kind == "eio" else 2)
    return [f.fired, table, st, _quarantined(P),
            _counter(P, "bullion.integrity.reread_recovered") - before]


def test_transient_bitflip_recovers_without_quarantine(tmp_path):
    fired, table, st, q, recovered = assert_same(
        tmp_path, _chaos_read, kind="bitflip", ordinal=0, byte=5)
    assert fired == 1 and np.array_equal(table["id"], np.arange(600))
    assert st["checksum_failures"] >= 1 and st["pages_quarantined"] == 0
    assert q == 0 and recovered >= 1


def test_persistent_bitflip_quarantines(tmp_path):
    fired, err, _, q, _ = assert_same(tmp_path, _chaos_read, kind="bitflip",
                                      ordinal=0, times=-1, byte=5)
    assert err.startswith("ShardCorruptError") and q >= 1 and fired >= 2


def test_eio_fallback_under_prefetch(tmp_path):
    fired, table, _, _, _ = assert_same(tmp_path, _chaos_read, kind="eio",
                                        ordinal=0)
    assert fired == 1 and np.array_equal(table["id"], np.arange(600))


def test_truncated_pread_recovers(tmp_path):
    fired, table, st, _, _ = assert_same(tmp_path, _chaos_read,
                                         kind="truncate", ordinal=0, keep=0.5)
    assert fired == 1 and np.array_equal(table["id"], np.arange(600))
    assert st["pages_quarantined"] == 0


def _stale_footer(P, d):
    p = _write(P, d / "a.bln")
    P.integrity.set_verify_policy("full")
    with P.chaos() as ctl:
        ctl.inject("stale_footer", section="footer", ordinal=0, times=-1)
        first, _ = _read(P, p)
        _write(P, d / "a.bln", n=600, rows_per_group=64, page_rows=32)
        P.clear_footer_cache()
        second, _ = _read(P, p)
    return [len(first["id"]), second]


def test_stale_footer_race_is_detected(tmp_path):
    n, err = assert_same(tmp_path, _stale_footer)
    assert n == 600 and err.startswith("ShardCorruptError")


def _harness(P, d):
    """The controller itself: unknown kinds and sections refused, ordinals
    and ``times`` windows counted per (path, section), ``clear``, and the
    previous backend back after the context."""
    out = [error(lambda: P.Fault("melt")),
           error(lambda: P.Fault("eio", section="index"))]
    ctl = P.ChaosController()
    f = ctl.inject("bitflip", path_sub="b", ordinal=1, times=2)
    out.append([len(ctl.take(path, "pread"))
                for path in ("a", "b", "b", "b", "b")])
    out.append([len(ctl.take("b", "footer")), f.fired])
    ctl.clear()
    out.append([ctl.faults, len(ctl.take("b", "pread"))])
    before = P.backend._backends.get("file")
    with P.chaos() as ctl2:
        inside = type(P.backend._backends["file"]).__name__
    out += [inside, P.backend._backends.get("file") is before]
    return out


def test_chaos_controller_counts_and_restores(tmp_path):
    out = assert_same(tmp_path, _harness)
    assert out[0].startswith("ValueError") and out[1].startswith("ValueError")
    assert out[2] == [0, 0, 1, 1, 0] and out[3] == [0, 2]
    assert out[5] == "ChaosBackend" and out[6]


# ---------------------------------------------------------------------------
# remote: the fake object store
# ---------------------------------------------------------------------------


def _remote(P, d, inner, **kw):
    os.makedirs(d / "bucket", exist_ok=True)
    local = _write(P, d / "bucket" / "part-00000.bln")
    uri = "bullion://bucket/part-00000.bln"
    with P.FakeObjectStore(str(d)) as store:
        P.backend.configure_object_store(store.endpoint)
        try:
            return inner(P, store, local, uri, **kw)
        finally:
            P.backend.configure_object_store(None)
            P.clear_footer_cache()


def _corrupt_once(P, store, local, uri):
    _read(P, uri)                        # warm the footer cache
    store.inject(corrupt=True)
    return _read(P, uri)


def test_remote_corrupt_body_recovers_with_one_refetch(tmp_path):
    table, st = assert_same(tmp_path, _remote, inner=_corrupt_once)
    assert np.array_equal(table["id"], np.arange(600))
    assert st["checksum_failures"] >= 1 and st["pages_quarantined"] == 0


def _corrupt_always(P, store, local, uri):
    _read(P, uri)
    store.inject(corrupt=True, count=8)
    out = [_read(P, uri)[0], _quarantined(P)]
    store.clear_faults()
    return out


def test_remote_persistent_corruption_quarantines(tmp_path):
    err, q = assert_same(tmp_path, _remote, inner=_corrupt_always)
    assert err.startswith("ShardCorruptError") and q >= 1


def _remote_parity(P, store, local, uri):
    """tests/test_backend.py's byte parity, predicate, head, missing key
    and malformed URI cases through the port's store and backend."""
    want, _ = _read(P, local)
    out = []
    for depth in (1, 4):
        P.clear_footer_cache()
        table, st = _read(P, uri, io_depth=depth)
        out.append([all(want[c].tobytes() == table[c].tobytes()
                        for c in ("id", "q")), st["preads"],
                    st["backend_fetches"] > 0])
    with P.dataset(uri) as ds:
        out.append(ds.where(P.C("id") >= 300).select(["id", "q"])
                   .to_table(io_depth=3))
        out.append(ds.select(["id"]).head(70).to_table(io_depth=3))
    out.append(re.sub(r"127\.0\.0\.1:\d+", "<store>",
                      _read(P, "bullion://bucket/nope.bln")[0]))
    out.append(error(lambda: P.discover("bullion://only-a-bucket")))
    fv1, _, hit1 = P.cached_footer(uri)
    ranges = store.range_requests
    fv2, _, hit2 = P.cached_footer(uri)
    out.append([hit1, hit2, fv1 is fv2, store.range_requests == ranges])
    return out


def test_remote_reads_match_local_and_errors(tmp_path):
    out = assert_same(tmp_path, _remote, inner=_remote_parity)
    assert out[0] == [True, 0, True] and out[1] == [True, 0, True]
    assert np.array_equal(out[3]["id"], np.arange(70))
    assert out[4].startswith("FileNotFoundError") and "not found" in out[4]
    assert out[5].startswith("ValueError")
    assert out[6] == [True, True, True, True]


def _faults(P, store, local, uri, monkeypatch, kind):
    """5xx retried, a truncated body retried, retries exhausted: the
    query's table, its retries, and the failure's log record."""
    monkeypatch.setenv("BULLION_BACKEND_BACKOFF", "0.001")
    _read(P, uri)
    if kind == "5xx":
        store.inject(count=2, status=503)
        table, st = _read(P, uri, io_depth=1)
        return [table, st["backend_retries"] >= 2]
    if kind == "truncate":
        store.inject(count=2, truncate=0.5)
        table, st = _read(P, uri, io_depth=4)
        store.clear_faults()
        return [table, st["backend_retries"] >= 2]
    monkeypatch.setenv("BULLION_BACKEND_RETRIES", "1")
    store.inject(count=500, status=503)
    P.querylog.enable_local(True)
    err, _ = _read(P, uri, io_depth=1)
    recs = [r for r in P.querylog.LOG.records() if r.outcome == "error"]
    store.clear_faults()
    return [err.split(":")[0], "503" in (recs[-1].error or "")]


@pytest.mark.parametrize("kind", ["5xx", "truncate", "exhausted"])
def test_remote_faults_retry_as_the_reference(tmp_path, monkeypatch, kind):
    out = assert_same(tmp_path, _remote, inner=_faults,
                      monkeypatch=monkeypatch, kind=kind)
    if kind == "exhausted":
        assert out == ["OSError", True]
    else:
        assert np.array_equal(out[0]["id"], np.arange(600)) and out[1]


def _chaos_remote(P, store, local, uri):
    """chaos() over ``bullion://``: a bitflip in a batched range fetch
    recovers by the re-read, as over local files."""
    _read(P, uri)
    P.integrity.set_verify_policy("full")
    with P.chaos(("bullion",)) as ctl:
        f = ctl.inject("bitflip", path_sub="part-00000", ordinal=0, byte=3)
        table, st = _read(P, uri, io_depth=4)
    return [f.fired, table, st["checksum_failures"] >= 1,
            st["pages_quarantined"]]


def test_chaos_hooks_object_store_uris(tmp_path):
    fired, table, failed, q = assert_same(tmp_path, _remote,
                                          inner=_chaos_remote)
    assert fired == 1 and np.array_equal(table["id"], np.arange(600))
    assert failed and q == 0


# ---------------------------------------------------------------------------
# torn writes
# ---------------------------------------------------------------------------

_VERSIONS = {"v0": dict(collect_stats=False),
             "v2": dict(collect_sketches=False), "v3": dict()}
_TEARS = {
    "truncated_footer": lambda raw: raw[:-24],
    "zeroed_magic": lambda raw: raw[:-8] + b"\0" * 8,
    "footer_len_past_eof": lambda raw: raw[:-16]
    + (len(raw) + 1024).to_bytes(8, "little") + raw[-8:],
    "mid_data_truncation": lambda raw: raw[:len(raw) // 3],
}


def _torn(P, d, version, tear):
    p = _write(P, d / "a.bln", **_VERSIONS[version])
    raw = open(p, "rb").read()
    open(p, "wb").write(_TEARS[tear](raw))
    P.clear_footer_cache()
    return [error(lambda: P.read_footer(p)), P.cli.main(["fsck", p])]


@pytest.mark.parametrize("version", sorted(_VERSIONS))
@pytest.mark.parametrize("tear", sorted(_TEARS))
def test_torn_file_rejected_on_open(tmp_path, capsys, version, tear):
    err, code = assert_same(tmp_path, _torn, version=version, tear=tear)
    assert err.startswith("ShardCorruptError") and code == 2


def _bad_extents(P, d):
    p = _write(P, d / "a.bln")
    fv, foot_off = P.read_footer(p)
    P.clear_footer_cache()
    raw = open(p, "rb").read()
    off, size = fv._dir[int(P.Sec.PAGE_SIZE)]
    sizes = np.frombuffer(fv.raw(P.Sec.PAGE_SIZE), np.uint64).copy()
    sizes[-1] += 10_000_000
    patched = bytearray(raw)
    patched[foot_off + off:foot_off + off + size] = sizes.tobytes()
    open(p, "wb").write(bytes(patched))
    return error(lambda: P.read_footer(p))


def test_bad_page_extents_rejected_on_open(tmp_path):
    assert assert_same(tmp_path, _bad_extents).startswith("ShardCorruptError")


# ---------------------------------------------------------------------------
# crash-safe writes
# ---------------------------------------------------------------------------


def _no_tmp(P, d):
    p = _write(P, d / "a.bln")
    return [os.path.exists(p), os.path.exists(p + ".tmp")]


def test_writer_leaves_no_tmp_on_success(tmp_path):
    assert assert_same(tmp_path, _no_tmp) == [True, False]


def _kill9(P, d, capsys):
    out = d / "out"
    os.makedirs(out)
    mod = "repro" if P.name == "ref" else "repro_torch"
    child = (
        "import os, signal, sys\n"
        "import numpy as np\n"
        f"from {mod}.core.writer import BullionWriter, ColumnSpec\n"
        "out = sys.argv[1]\n"
        "schema = [ColumnSpec('id', 'int64')]\n"
        "w = BullionWriter(os.path.join(out, 'part-00000.bln'), schema,\n"
        "                  rows_per_group=100)\n"
        "w.write_table({'id': np.arange(500, dtype=np.int64)})\n"
        "w.close()\n"
        "w2 = BullionWriter(os.path.join(out, 'part-00001.bln'), schema,\n"
        "                   rows_per_group=100)\n"
        "w2.write_table({'id': np.arange(500, dtype=np.int64)})\n"
        "os.kill(os.getpid(), signal.SIGKILL)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", child, str(out)], env=env,
                         capture_output=True, timeout=120)
    with P.dataset(str(out)) as ds:
        rows = ds.count_rows()
    return [res.returncode, P.discover(str(out)), rows,
            "part-00001.bln" in os.listdir(out),
            P.cli.main(["fsck", str(out)])]


def test_kill9_mid_write_leaves_no_torn_shard(tmp_path, capsys):
    code, shards, rows, torn, fsck = assert_same(tmp_path, _kill9,
                                                 capsys=capsys)
    assert code == -signal.SIGKILL and len(shards) == 1
    assert rows == 500 and not torn and fsck == 0


# ---------------------------------------------------------------------------
# fsck --json and the server's degradation report
# ---------------------------------------------------------------------------


def _fsck_json(P, d, capsys, damage):
    p = _write(P, d / "a.bln")
    if damage == "flip":
        _flip_page(P, p, 0)
    elif damage == "torn":
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[:-8] + b"\0" * 8)
        P.clear_footer_cache()
    capsys.readouterr()
    code = P.cli.main(["fsck", "--json", p])
    return [code, capsys.readouterr().out]


@pytest.mark.parametrize("damage", ["flip", "torn", "none"])
def test_fsck_json_reports(tmp_path, capsys, damage):
    import json
    code, out = assert_same(tmp_path, _fsck_json, capsys=capsys,
                            damage=damage)
    rep = json.loads(out)
    assert code == rep["exit"] == {"flip": 1, "torn": 2, "none": 0}[damage]
    if damage == "flip":
        cats = rep["shards"][0]["categories"]
        assert cats["checksums"]["failed"] == 1
        assert cats["extents"]["failed"] == 0
    elif damage == "torn":
        assert rep["unusable"] == 1 and "magic" in rep["shards"][0][
            "unusable"]


def _degraded_server(P, d):
    p = _write(P, d / "a.bln")
    _flip_page(P, p, 0)
    P.integrity.set_verify_policy("full")
    P.integrity.set_corruption_policy("skip")
    with P.DatasetServer({"t": p}) as srv:
        with P.ServeClient(srv.serve()) as c:
            res = c.query("t", columns=["id"])
            st = c.stats()
    return [res.degraded, res.degraded_rows, res.rows, res.table,
            stable_stats(st["integrity"]), st["query_log"]["degraded"]]


def test_server_reports_degradation(tmp_path):
    degraded, rows, n, table, integrity, logged = assert_same(
        tmp_path, _degraded_server)
    assert degraded and rows == 64 and n == 600 - 64
    assert integrity["verify_policy"] == "full"
    assert integrity["on_corrupt"] == "skip"
    assert integrity["quarantined_pages"] == 1 and logged >= 1


def test_chaos_patches_the_port_backend():
    """The port's harness installs itself in ``repro_torch.core.backend``
    and leaves the reference's backends alone (and the reverse)."""
    ref, port = pkg("ref"), pkg("port")
    ref_before = dict(ref.backend._backends)
    with port.chaos() as ctl:
        assert type(port.backend._backends["file"]).__name__ == "ChaosBackend"
        assert ref.backend._backends == ref_before
        assert ctl.faults == []
    assert "file" not in port.backend._backends or \
        type(port.backend._backends["file"]).__name__ != "ChaosBackend"
