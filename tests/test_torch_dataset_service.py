"""The port's dataset service (``repro_torch.serve``: ``DatasetServer``,
its wire and ``ServeClient``) on the CPU, held against the reference's:
the cases of tests/test_serve.py run through both packages with equal
outcomes (replies, fingerprints, ``stats()``, errors), a reference client
against a port server and the reverse, the wire's bytes, and the server's
device (every prepared plan runs its filter and dequantize there)."""

import threading
import time

import numpy as np
import pytest
import torch

from service_parity import assert_same, error, pkg, same, stable_stats

N_ROWS = 4096
N_SHARDS = 2


def _shards(P, d):
    """Two shards, unclustered ids + payload + a string column, written by
    ``P``'s writer (tests/test_serve.py's fixture)."""
    P.clear_footer_cache()
    d = d / "shards"
    d.mkdir()
    rng = np.random.default_rng(42)
    ids = rng.permutation(2 * N_ROWS)[:N_ROWS].astype(np.int64)
    schema = [P.ColumnSpec("id", "int64"), P.ColumnSpec("val", "float32"),
              P.ColumnSpec("tag", "string")]
    per = N_ROWS // N_SHARDS
    for s in range(N_SHARDS):
        w = P.BullionWriter(str(d / f"part-{s:04d}.bln"), schema,
                            rows_per_group=512, page_rows=128)
        sl = slice(s * per, (s + 1) * per)
        w.write_table({"id": ids[sl], "val": (ids[sl] * 2).astype(np.float32),
                       "tag": [b"tag-%d" % v for v in ids[sl]]})
        w.close()
    return str(d), ids


def _reply(r) -> dict:
    """A query result's observable fields (no clock reading)."""
    return {"table": r.table, "rows": r.rows, "cache_hit": r.cache_hit,
            "fingerprint": r.fingerprint,
            "degraded": r.degraded, "degraded_rows": r.degraded_rows}


# ---------------------------------------------------------------------------
# plan fingerprints
# ---------------------------------------------------------------------------


def _fingerprints(P, d):
    C, LP = P.C, P.LogicalPlan
    a, b = C("x") > 3, C("y") == 7
    return [LP(columns=("x", "y"), predicate=a & b).fingerprint(),
            LP(columns=("x", "y"), predicate=b & a).fingerprint(),
            LP(predicate=(a | b) & (b | a)).fingerprint(),
            LP(predicate=(b | a) & (a | b)).fingerprint(),
            LP(columns=("x",), predicate=C("x") == 1).fingerprint(),
            LP(columns=("x",), predicate=C("x") == 2).fingerprint(),
            LP(columns=("y",), predicate=C("x") == 1).fingerprint(),
            LP(columns=("x",), predicate=C("x") == 1, limit=10).fingerprint(),
            LP(predicate=None).fingerprint(),
            LP(predicate=~(C("x") == 1)).fingerprint()]


def test_fingerprint_conjunct_order_invariant(tmp_path):
    fp = assert_same(tmp_path, _fingerprints)
    assert fp[0] == fp[1] and fp[2] == fp[3]


def test_fingerprint_distinguishes_plans(tmp_path):
    fp = assert_same(tmp_path, _fingerprints)
    assert len(set(fp[4:])) == 6


# ---------------------------------------------------------------------------
# prepared-plan cache
# ---------------------------------------------------------------------------


def _repeat_query(P, d):
    path, ids = _shards(P, d)
    victim = int(ids[100])
    with P.DatasetServer({"t": path}) as srv:
        r1 = srv.query("t", where=P.C("id") == victim, columns=["id", "val"])
        r2 = srv.query("t", where=P.C("id") == victim, columns=["id", "val"])
        return [_reply(r1), _reply(r2), stable_stats(srv.stats())]


def test_repeat_query_hits_prepared_cache(tmp_path):
    r1, r2, st = assert_same(tmp_path, _repeat_query)
    assert not r1["cache_hit"] and r2["cache_hit"]
    assert r1["fingerprint"] == r2["fingerprint"]
    assert r1["table"]["id"].tolist() == r2["table"]["id"].tolist()
    assert st["plan_cache"]["hits"] == 1 and st["plan_cache"]["misses"] == 1
    assert st["queries"] == 2 and st["errors"] == 0


def _conjunct_order(P, d):
    path, ids = _shards(P, d)
    a, b = P.C("id") == int(ids[7]), P.C("val") > -1.0
    with P.DatasetServer({"t": path}) as srv:
        return [_reply(srv.query("t", where=a & b)),
                _reply(srv.query("t", where=b & a))]


def test_conjunct_order_shares_cache_entry(tmp_path):
    r1, r2 = assert_same(tmp_path, _conjunct_order)
    assert r2["cache_hit"] and r1["fingerprint"] == r2["fingerprint"]
    assert r1["table"]["id"].tolist() == r2["table"]["id"].tolist()


def _lru(P, d):
    path, ids = _shards(P, d)
    with P.DatasetServer({"t": path}, plan_cache_size=2) as srv:
        for v in ids[:3]:
            srv.query("t", where=P.C("id") == int(v))
        st = srv.stats()["plan_cache"]
        r = srv.query("t", where=P.C("id") == int(ids[0]))
        return [st, _reply(r)]


def test_cache_lru_eviction(tmp_path):
    st, r = assert_same(tmp_path, _lru)
    assert st["size"] == 2 and st["misses"] == 3
    assert not r["cache_hit"]


def _explain(P, d):
    path, ids = _shards(P, d)
    with P.DatasetServer({"t": path}) as srv:
        q = dict(columns=["id"], where=P.C("id") == int(ids[0]))
        return [srv.explain("t", **q), srv.explain("t", **q)]


def test_explain_reports_prepared_state(tmp_path):
    first, again = assert_same(tmp_path, _explain)
    assert first.startswith("Prepared[t ") and " miss]" in \
        first.splitlines()[0]
    assert " hit]" in again.splitlines()[0]
    assert "by value sketch" in first


def _unknown(P, d):
    path, _ = _shards(P, d)
    with P.DatasetServer({"t": path}) as srv:
        return [error(lambda: srv.query("nope")),
                error(lambda: srv.attach("t", path)),
                stable_stats(srv.stats())]


def test_unknown_dataset_raises(tmp_path):
    unknown, again, st = assert_same(tmp_path, _unknown)
    assert unknown.startswith("KeyError") and "unknown dataset" in unknown
    assert again.startswith("ValueError") and "already attached" in again
    assert st["errors"] == 1 and st["query_log"]["errors"] == 1


# ---------------------------------------------------------------------------
# concurrent serving
# ---------------------------------------------------------------------------


def _mixed(P, d):
    """Six threads, each six queries: projections and point probes over
    two tenants; every reply against the plain dataset API's."""
    path, ids = _shards(P, d)
    victims = [int(v) for v in ids[::97][:8]]
    with P.dataset(path) as ds:
        want_probe = {v: ds.where(P.C("id") == v).to_table()
                      for v in victims}
        want_proj = ds.select(["id", "val"]).to_table()
    with P.DatasetServer({"t": path}, max_workers=4) as srv:
        results, errors = [], []

        def worker(i):
            try:
                for j in range(6):
                    if (i + j) % 3 == 0:
                        r = srv.query("t", columns=["id", "val"],
                                      tenant=f"tenant-{i % 2}")
                        results.append(("proj", None, r))
                    else:
                        v = victims[(i * 7 + j) % len(victims)]
                        r = srv.query("t", where=P.C("id") == v,
                                      columns=["id", "val", "tag"],
                                      tenant=f"tenant-{i % 2}")
                        results.append(("probe", v, r))
            except Exception as e:     # pragma: no cover - failure path
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors and not any(t.is_alive() for t in threads)
        for kind, v, r in results:
            if kind == "proj":
                assert same(r.table, want_proj)
            else:
                assert same(r.table, {k: want_probe[v][k]
                                      for k in ("id", "val", "tag")})
                assert r.table["tag"] == [b"tag-%d" % v]
        st = srv.stats()
        footer0 = st["datasets"]["t"]["io"]["footer_bytes"]
        for v in victims:
            srv.query("t", where=P.C("id") == v, columns=["id", "val", "tag"])
        srv.query("t", columns=["id", "val"])
        return {"n": len(results), "errors": st["errors"],
                "hits": st["plan_cache"]["hits"] > 0,
                "misses": st["plan_cache"]["misses"],
                "footer_bytes_again": srv.stats()["datasets"]["t"]["io"][
                    "footer_bytes"] - footer0}


def test_concurrent_mixed_workload_deterministic(tmp_path):
    out = assert_same(tmp_path, _mixed)
    assert out == {"n": 36, "errors": 0, "hits": True, "misses": 9,
                   "footer_bytes_again": 0}


def _submit(P, d):
    path, ids = _shards(P, d)
    with P.DatasetServer({"t": path}) as srv:
        futs = [srv.submit("t", where=P.C("id") == int(v)) for v in ids[:4]]
        return sorted(int(f.result(10).table["id"][0]) for f in futs), \
            sorted(int(v) for v in ids[:4])


def test_submit_is_async(tmp_path):
    got, want = assert_same(tmp_path, _submit)
    assert got == want


# ---------------------------------------------------------------------------
# tenant io_depth budgets
# ---------------------------------------------------------------------------


def _budget(P, d):
    b = P.TenantBudget(4)
    out = [b.acquire(100)]
    b.release(4)
    out.append(b.acquire(1))
    got = []

    def blocked():
        got.append(b.acquire(4))
        b.release(4)

    t = threading.Thread(target=blocked)
    t.start()
    t.join(0.05)
    out.append(t.is_alive() and not got)
    b.release(1)
    t.join(5)
    return out + [got, b.waits, error(lambda: P.TenantBudget(0))]


def test_tenant_budget_clamps_and_blocks(tmp_path):
    out = assert_same(tmp_path, _budget)
    assert out[:5] == [4, 1, True, [4], 1]
    assert out[5].startswith("ValueError")


def _budget_load(P, d):
    path, ids = _shards(P, d)
    depth = 4
    with P.DatasetServer({"t": path}, max_workers=8, tenant_io_depth=depth,
                         default_io_depth=2) as srv:
        budget = srv.tenant_budget("noisy")
        held = budget.acquire(3)
        futs = [srv.submit("t", where=P.C("id") == int(v), tenant="noisy",
                           io_depth=2) for v in ids[:12]]
        deadline = time.time() + 10
        while budget.waits == 0 and time.time() < deadline:
            time.sleep(0.005)
        budget.release(held)
        rows = [f.result(30).table["id"].tolist() for f in futs]
        st = srv.stats()["tenants"]["noisy"]
        srv.query("t", where=P.C("id") == int(ids[0]), tenant="quiet")
        return {"rows": rows, "io_depth": st["io_depth"],
                "peak_within": st["peak_in_flight"] <= depth,
                "waited": st["waits"] > 0,
                "quiet_waits": srv.stats()["tenants"]["quiet"]["waits"]}


def test_tenant_budget_bounds_concurrency_under_load(tmp_path):
    out = assert_same(tmp_path, _budget_load)
    assert out["io_depth"] == 4 and out["peak_within"] and out["waited"]
    assert out["quiet_waits"] == 0


# ---------------------------------------------------------------------------
# socket front-end
# ---------------------------------------------------------------------------


def _socket(P, d):
    path, ids = _shards(P, d)
    victim = int(ids[321])
    with P.DatasetServer({"t": path}) as srv:
        sock = srv.serve()
        with P.ServeClient(sock) as cli:
            out = [cli.ping(), cli.datasets(),
                   _reply(cli.query("t", where=P.C("id") == victim)),
                   _reply(srv.query("t", where=P.C("id") == victim)),
                   cli.explain("t", where=P.C("id") == victim),
                   stable_stats(cli.stats()),
                   error(lambda: cli.query("nope")), cli.ping()]
    return out


def test_socket_roundtrip_matches_inprocess(tmp_path):
    ping, names, wire, local, explain, st, err, again = \
        assert_same(tmp_path, _socket)
    assert ping and names == ["t"] and again
    assert wire["rows"] == 1 and wire["table"]["tag"][0].startswith(b"tag-")
    assert same(wire["table"], local["table"])
    assert wire["fingerprint"] == local["fingerprint"]
    assert "Prepared[t" in explain and st["queries"] >= 2
    assert err.startswith("ServeError") and "unknown dataset" in err


def _clients(P, d):
    path, ids = _shards(P, d)
    victims = [int(v) for v in ids[:6]]
    with P.DatasetServer({"t": path}) as srv:
        sock = srv.serve()
        out, errors = {}, []

        def client(v):
            try:
                with P.ServeClient(sock) as cli:
                    out[v] = cli.query(
                        "t", where=P.C("id") == v).table["id"].tolist()
            except Exception as e:     # pragma: no cover - failure path
                errors.append(e)

        threads = [threading.Thread(target=client, args=(v,))
                   for v in victims]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        return {"errors": [repr(e) for e in errors],
                "ok": out == {v: [v] for v in victims}}


def test_socket_concurrent_clients(tmp_path):
    assert assert_same(tmp_path, _clients) == {"errors": [], "ok": True}


def _close(P, d):
    path, _ = _shards(P, d)
    srv = P.DatasetServer({"t": path})
    srv.serve()
    srv.close()
    srv.close()
    return error(lambda: srv.submit("t"))


def test_server_close_idempotent(tmp_path):
    err = assert_same(tmp_path, _close)
    assert err.startswith("RuntimeError") and "closed" in err


def test_serve_exports():
    """The port's serve package exports the reference's names; its
    ``ServeEngine`` is the LM engine."""
    import repro.serve as ref
    import repro_torch.serve as port
    from repro_torch.serve.lm import ServeEngine
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert port.ServeEngine is ServeEngine


# ---------------------------------------------------------------------------
# across the packages: the wire's bytes, each client against the other's
# server
# ---------------------------------------------------------------------------


def _queries(C, ids):
    return [dict(where=C("id") == int(ids[5]), columns=["id", "val", "tag"]),
            dict(columns=["val"], head=700),
            dict(where=(C("val") >= 100.0) & (C("val") < 900.0)),
            dict(where=C("id").isin([int(ids[1]), int(ids[2]), -3]))]


@pytest.mark.parametrize("client,server", [("ref", "port"),
                                           ("port", "ref")])
def test_client_and_server_across_packages(tmp_path, client, server):
    """A client of one package against a server of the other: every reply
    equals the same client's against its own package's server, and the
    server's ``stats()`` too."""
    results = {}
    for srv_name in (server, client):
        S, Cl = pkg(srv_name), pkg(client)
        d = tmp_path / f"{srv_name}_server"
        d.mkdir()
        path, ids = _shards(S, d)
        with S.DatasetServer({"t": path}) as srv:
            with Cl.ServeClient(srv.serve()) as cli:
                replies = [_reply(cli.query("t", **q))
                           for q in _queries(Cl.C, ids)]
                replies.append(error(lambda: cli.query("t", columns=["no"])))
                replies.append(stable_stats(cli.stats()))
                replies.append(cli.explain("t", **_queries(Cl.C, ids)[0]))
        results[srv_name] = [r.replace(str(d), "<tmp>")
                             if isinstance(r, str) else r for r in replies]
    assert same(results[server], results[client])
    assert results[server][0]["rows"] == 1


@pytest.mark.parametrize("which", ["predicate", "table"])
def test_wire_encodings_are_the_reference_s(tmp_path, which):
    """The port's wire encodes a predicate and a result table to the
    reference's JSON, and decodes the reference's encoding back."""
    import json
    ref, port = pkg("ref"), pkg("port")
    if which == "predicate":
        def make(C):
            return (((C("a") > 1) & ~(C("b") == 2.5)) |
                    C("c").isin([1, 2, np.int64(3)]) | (C("d") != 0))
        enc_r = ref.wire.encode_predicate(make(ref.C))
        enc_p = port.wire.encode_predicate(make(port.C))
        assert json.dumps(enc_r) == json.dumps(enc_p)
        assert repr(port.wire.decode_predicate(enc_r)) == \
            repr(make(port.C))
        assert port.wire.encode_predicate(None) is None
    else:
        table = {"a": np.arange(5, dtype=np.int64),
                 "b": np.array([0.5, np.nan, -0.0], np.float32),
                 "l": [np.arange(3, dtype=np.int32), np.zeros(0, np.int32)],
                 "s": [b"x", b"", b"\xff"], "e": []}
        enc_r, enc_p = ref.wire.encode_table(table), \
            port.wire.encode_table(table)
        assert json.dumps(enc_r) == json.dumps(enc_p)
        assert same(port.wire.decode_table(enc_r),
                    ref.wire.decode_table(enc_p))
        assert error(lambda: port.wire.encode_table({"x": 3})) == \
            error(lambda: ref.wire.encode_table({"x": 3}))


def _frames(P, d):
    """Framing errors: a torn frame, an oversized prefix and a body that
    is not an object each drop the session and leave a log record; the
    server lives on."""
    import socket
    import struct
    path, _ = _shards(P, d)
    with P.DatasetServer({"t": path}) as srv:
        sock = srv.serve()
        for payload in (struct.pack("<I", 100) + b"{}",
                        struct.pack("<I", (1 << 30) + 1),
                        struct.pack("<I", 2) + b"[]"):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(sock)
            s.sendall(payload)
            s.shutdown(socket.SHUT_WR)
            s.settimeout(10)
            assert s.recv(16) == b""           # the server hung up
            s.close()
        with P.ServeClient(sock) as cli:
            alive = cli.ping()
            unknown = error(lambda: cli._rpc({"op": "frob"}))
            log = [(r["origin"], r["outcome"], r["error"])
                   for r in cli.server_log(10)]
    return [alive, unknown, log]


def test_wire_errors_drop_the_session(tmp_path):
    alive, unknown, log = assert_same(tmp_path, _frames)
    assert alive and "unknown op 'frob'" in unknown
    assert len(log) == 4 and all(o == "serve.wire" for o, _, _ in log)


# ---------------------------------------------------------------------------
# the server's device
# ---------------------------------------------------------------------------


def test_server_plans_run_on_its_device(tmp_path, monkeypatch):
    """Every prepared plan carries the server's device, and each query's
    range filter goes to the filter wrapper with tensors there."""
    from repro_torch.kernels import filter as kfilter
    P = pkg("port")
    path, ids = _shards(P, tmp_path)
    seen = []
    wrapper = kfilter.range_mask

    def spy(cols, lo, hi, device=None):
        seen.append((cols.device.type, str(device)))
        return wrapper(cols, lo, hi, device=device)

    monkeypatch.setattr(kfilter, "range_mask", spy)
    with P.DatasetServer({"t": path}) as srv:
        ds, _, _ = srv.prepare("t", where=P.C("val") > 3.0)
        assert ds._plan.device == torch.device("cpu")
        assert srv.device == torch.device("cpu")
        r = srv.query("t", where=(P.C("val") > 3.0) & (P.C("val") < 5000.0))
    assert r.rows > 0
    assert seen and all(s == ("cpu", "cpu") for s in seen)



def test_close_ends_the_accept_thread_cleanly(tmp_path):
    """close() while the accept thread waits in accept(): the thread ends
    without an exception, however the two interleave (the reference's
    loop can read the listener after close() set it to None)."""
    errors = []
    saved = threading.excepthook
    threading.excepthook = lambda args: errors.append(args.exc_type)
    try:
        for i in range(20):
            srv = pkg("port").DatasetServer({})
            srv.serve(str(tmp_path / f"s{i}.sock"))
            srv.close()
            assert not srv._accept_thread.is_alive()
    finally:
        threading.excepthook = saved
    assert errors == []
