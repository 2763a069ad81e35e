"""Set-up shared by the cells that read a table: the columns from the seed,
the program's writer, the compliance delete, and the traffic file's
predicates in both forms (the program's and the reference's)."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from perfbench.gen import criteo
from perfbench.reference.table import TableReference


@dataclasses.dataclass
class Table:
    cfg: dict
    columns: dict              # the generator's columns (the reference's input)
    victims: np.ndarray        # deleted users
    tmp: str
    path: str

    def reference(self, precision: str = "bf16",
                  delete: bool = True) -> TableReference:
        return TableReference(self.columns, criteo.DENSE, self.victims,
                              precision=precision, delete=delete)

    def remove(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def make(cfg: dict, seed: int, device, stages) -> Table:
    """Generate, write and delete, marking each stage."""
    from repro_torch.core.deletion import Compliance, delete_where
    from repro_torch.scan import C
    cols = criteo.columns(cfg, seed, device)
    victims = criteo.victims(cfg, cols, seed)
    stages.mark("data_generate")
    tmp = tempfile.mkdtemp(prefix="pb-")
    path = os.path.join(tmp, "t.bln")
    try:
        criteo.write(cfg, cols, path)
        stages.mark("data_write")
        stats = delete_where(path, C("user_id").isin(victims.tolist()),
                             Compliance[cfg["delete"]["level"]],
                             device=device)
        stages.mark("data_delete")
        print(json.dumps({"delete": {
            k: getattr(stats, k, None) for k in (
                "rows_deleted", "pages_touched", "pages_masked_in_place",
                "pages_relocated", "pages_dv_only", "bytes_rewritten")}}),
              file=sys.stderr)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return Table(cfg=cfg, columns=cols, victims=victims, tmp=tmp, path=path)


def predicate(where):
    """A traffic file's conjunction ``[[column, op, literal], ...]`` as the
    program's predicate (None for an empty one)."""
    from repro_torch.scan import Cmp
    pred = None
    for col, op, lit in where:
        term = Cmp(col, op, lit)
        pred = term if pred is None else pred & term
    return pred


def group_rows(table: Table) -> list:
    """Per row group: (live rows, {column: (min, max)} over all its rows,
    as its zone maps record them at write time)."""
    n, g = int(table.cfg["rows"]), int(table.cfg["rows_per_group"])
    live = ~np.isin(table.columns["user_id"], table.victims)
    out = []
    for a in range(0, n, g):
        sl = slice(a, min(a + g, n))
        out.append((int(live[sl].sum()), sl))
    return out


def evaluated(table: Table, where) -> list:
    """The row groups a conjunction's zone-map test cannot prune, with
    their live rows: the benchmark's own count of the work a scan does."""
    ops = {"==": lambda lo, hi, v: lo <= v <= hi,
           "!=": lambda lo, hi, v: not (lo == hi == v),
           "<": lambda lo, hi, v: lo < v, "<=": lambda lo, hi, v: lo <= v,
           ">": lambda lo, hi, v: hi > v, ">=": lambda lo, hi, v: hi >= v}
    ref = table.reference()
    out = []
    for live, sl in group_rows(table):
        ok = True
        for col, op, lit in where:
            v = ref.cols[col][sl]
            if not ops[op](v.min(), v.max(), lit):
                ok = False
        if ok:
            out.append(live)
    return out
