"""The dataset service, the ``bullion`` CLI and fault injection of both
packages behind one namespace, so a scenario runs through each and the
outcomes can be compared: ``pkg("ref")`` is the reference, ``pkg("port")``
the port with its entry points on the CPU (``device="cpu"``).

``run_both(scenario, tmp_path)`` calls ``scenario(P, directory)`` for each
package in a directory of its own and returns both outcomes, with the
directory written as ``<tmp>`` in every string, so paths in messages and
reports compare equal."""

from __future__ import annotations

import functools
import types

import numpy as np


@functools.lru_cache(maxsize=None)
def pkg(name: str) -> types.SimpleNamespace:
    if name == "ref":
        from repro import cli
        from repro import core, dataset as ds_mod, scan, serve, testing
        from repro.core import backend, footer, integrity
        from repro.dataset import plan, source
        from repro.obs import expose, metrics, querylog
        from repro.serve import wire
        dataset, server = ds_mod.dataset, serve.DatasetServer
    else:
        from repro_torch import cli
        from repro_torch import core, dataset as ds_mod, scan, serve, \
            testing
        from repro_torch.core import backend, footer, integrity
        from repro_torch.dataset import plan, source
        from repro_torch.obs import expose, metrics, querylog
        from repro_torch.serve import wire
        dataset = functools.partial(ds_mod.dataset, device="cpu")
        server = functools.partial(serve.DatasetServer, device="cpu")
    return types.SimpleNamespace(
        name=name, cli=cli, backend=backend, integrity=integrity,
        metrics=metrics, querylog=querylog, expose=expose,
        wire=wire, dataset=dataset, DatasetServer=server,
        ServeClient=serve.ServeClient, TenantBudget=serve.TenantBudget,
        LogicalPlan=plan.LogicalPlan,
        BullionWriter=core.BullionWriter, ColumnSpec=core.ColumnSpec,
        Compliance=core.Compliance, delete_rows=core.delete_rows,
        QuantMode=core.QuantMode, QuantSpec=core.QuantSpec,
        Sec=footer.Sec, read_footer=footer.read_footer,
        ShardCorruptError=footer.ShardCorruptError,
        QUARANTINE=integrity.QUARANTINE,
        clear_footer_cache=source.clear_footer_cache,
        invalidate_cached_footer=source.invalidate_cached_footer,
        cached_footer=source.cached_footer, discover=source.discover,
        C=scan.C, chaos=testing.chaos, FakeObjectStore=testing.FakeObjectStore,
        ChaosController=testing.ChaosController, Fault=testing.Fault)


PACKAGES = ("ref", "port")


def _scrub(x, tmp: str):
    """``x`` with ``tmp`` written as ``<tmp>`` in every string."""
    if isinstance(x, str):
        return x.replace(tmp, "<tmp>")
    if isinstance(x, dict):
        return {_scrub(k, tmp): _scrub(v, tmp) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_scrub(v, tmp) for v in x)
    return x


def run_both(scenario, tmp_path, **kw) -> tuple:
    """(reference outcome, port outcome) of ``scenario(P, dir, **kw)``."""
    out = []
    for name in PACKAGES:
        d = tmp_path / name
        d.mkdir()
        out.append(_scrub(scenario(pkg(name), d, **kw), str(d)))
    return tuple(out)


def difference(a, b, path: str = "") -> str | None:
    """Where two outcomes differ (None where they are equal): arrays by
    dtype and bytes (NaN payloads included), dicts by keys, sequences
    element for element, the rest by ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == b.dtype and a.shape == b.shape and \
                a.tobytes() == b.tobytes():
            return None
        return f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return f"{path}: keys {sorted(map(str, a))} vs " \
                f"{sorted(map(str, b))}"
        return next((d for k in a
                     if (d := difference(a[k], b[k], f"{path}/{k}"))), None)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: length {len(a)} vs {len(b)}"
        return next((d for i, (x, y) in enumerate(zip(a, b))
                     if (d := difference(x, y, f"{path}/{i}"))), None)
    return None if a == b else f"{path}: {a!r} vs {b!r}"


def same(a, b) -> bool:
    return difference(a, b) is None


def assert_same(tmp_path, scenario, **kw):
    """Run ``scenario`` in both packages; assert equal outcomes; return
    the port's."""
    ref, port = run_both(scenario, tmp_path, **kw)
    diff = difference(ref, port)
    assert diff is None, f"reference vs port at {diff}"
    return port


def error(fn) -> str | None:
    """``fn()``'s exception as ``"Type: message"``, or None."""
    try:
        fn()
    except Exception as e:     # the outcome compared between packages
        return f"{type(e).__name__}: {e}"
    return None


def stable_stats(stats: dict) -> dict:
    """``DatasetServer.stats()`` without its clock readings (keys holding
    ``seconds``)."""
    if isinstance(stats, dict):
        return {k: stable_stats(v) for k, v in stats.items()
                if "seconds" not in k}
    return stats
