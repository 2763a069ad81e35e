"""A Criteo-shaped click-log table, made from a seed.

Rewritten from ``src/repro_torch/data/synthetic.py`` ``write_ads_table``
(the same idea: a wide ads table with BF16-quantized dense features, sorted
users and a rare label), frozen here at the shape of the Criteo 1TB Click
Logs as MLPerf Training's DLRM reads them: one label, 13 integer features
(stored as ``log(1 + count)``, BF16-quantized) and 26 hashed categorical
features, plus ``user_id`` and ``ts`` for per-user deletion and time
windows. Every size comes from the configuration file.

``columns`` returns plain NumPy arrays; the caller writes them with the
program's writer and hands the same arrays to the reference.
"""

from __future__ import annotations

import numpy as np

DENSE = [f"I{i}" for i in range(1, 14)]
SPARSE = [f"C{i}" for i in range(1, 27)]


def _power_law(gen, n: int, alpha: float):
    """Counts k >= 0 with P(k >= m) = (m + 1) ** -alpha (a discrete Pareto
    tail), one uniform draw each, as float64 on the generator's device."""
    import torch
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=gen.device)
    return torch.floor((1.0 - u) ** (-1.0 / alpha)) - 1.0


def columns(cfg: dict, seed: int, device="cpu") -> dict:
    """Every column of the table, in schema order, from ``seed``: drawn on
    ``device`` in a few large calls, returned as NumPy arrays."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = int(cfg["rows"])
    users = cfg["users"]
    n_users = int(users["n"])
    # each user's share of the rows has a power-law tail (a few own many);
    # the table is sorted by user, as a per-user log is
    share = torch.cumsum(_power_law(gen, n_users, users["alpha"]) + 1.0, 0)
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    owner = torch.searchsorted(share, u * share[-1], right=True) \
        .clamp_(max=n_users - 1)
    perm = torch.randperm(n_users, generator=gen, device=device)
    user_id = torch.sort(perm[owner]).values
    day = float(cfg["seconds_per_day"])
    ts = cfg["ts_base"] + torch.floor(
        torch.arange(n, dtype=torch.float64, device=device)
        * (cfg["days"] * day / n)).long()
    label = torch.rand(n, generator=gen, device=device) \
        < cfg["label"]["positive_rate"]
    out = {"user_id": user_id, "ts": ts, "label": label.to(torch.int8)}
    for name in DENSE:
        out[name] = torch.log1p(_power_law(gen, n, cfg["dense"]["alpha"])) \
            .float()
    sparse = cfg["sparse"]
    for name, card in zip(SPARSE, sparse["cardinalities"]):
        rank = _power_law(gen, n, sparse["alpha"]).clamp_(max=2**31).long()
        # hashed ids: the popular ranks scattered over the id range
        out[name] = ((rank * 2654435761) % card).int()
    return {k: v.cpu().numpy() for k, v in out.items()}


def victims(cfg: dict, table: dict, seed: int) -> np.ndarray:
    """The users whose rows a compliance delete erases: a seeded share of
    the users that own rows, sorted."""
    rng = np.random.default_rng([seed, 2])
    present = np.unique(table["user_id"])
    k = max(1, int(round(len(present) * cfg["delete"]["user_share"])))
    return np.sort(rng.choice(present, k, replace=False))


def write(cfg: dict, table: dict, path: str) -> dict:
    """The table written by the program's writer: ``user_id``, ``ts``,
    ``label``, the dense features BF16-quantized, the categorical ones."""
    from repro_torch.core import BullionWriter, ColumnSpec, QuantMode, \
        QuantSpec
    schema = [ColumnSpec("user_id", "int64"), ColumnSpec("ts", "int64"),
              ColumnSpec("label", "int8")]
    schema += [ColumnSpec(c, "float32", quant=QuantSpec(QuantMode.BF16))
               for c in DENSE]
    schema += [ColumnSpec(c, "int32") for c in SPARSE]
    w = BullionWriter(path, schema, rows_per_group=int(cfg["rows_per_group"]),
                      props={"kind": "criteo-ads"})
    w.write_table(table)
    return w.close()
