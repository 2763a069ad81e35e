"""Predicate AST with a vectorized NumPy evaluator and zone-map tests.

Leaves are ``col <op> literal`` comparisons and ``col IN {...}``; interior
nodes are AND/OR/NOT. Build them directly or through the ``C`` column
builder::

    from repro_torch.scan import C
    pred = (C("quality") >= 0.5) & ~C("label").isin([0])

Each node answers three questions:

* ``mask(table)``        — exact per-row boolean mask (NumPy, vectorized).
* ``maybe_any(stats)``   — could *any* row of a page/chunk match, judged only
                           from its zone-map record. False => safe to prune.
* ``always(stats)``      — do *all* rows provably match. Used to push NOT
                           through zone maps (NOT p prunes where p is always
                           true); conservatively False when unsure.

Zone-map tests are sound under the outer-bound convention of
``scan.stats``: recorded min <= true min, recorded max >= true max, and any
NaNs are counted in ``null_count`` (NaN rows fail every comparison except
``!=``, matching NumPy semantics).

Conjunctions of range comparisons additionally compile to flat per-column
``[lo, hi]`` intervals (``conjunctive_ranges``), the form the range-filter
kernel (``repro_torch.kernels.filter``) consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .stats import HAS_MINMAX, LIST_ELEMENTS, f8_exact, f8_lower, f8_upper

_OPS = ("==", "!=", "<", "<=", ">", ">=")


def _usable(rec) -> bool:
    """A record prunes rows only if it has min/max over *row* values.

    LIST_ELEMENTS records describe flattened list elements — row-level
    pruning on them would silently drop matches (and predicates on list
    columns must keep raising their TypeError consistently), so they are
    treated as absent."""
    if rec is None:
        return False
    flags = int(rec["flags"])
    return bool(flags & HAS_MINMAX) and not (flags & LIST_ELEMENTS)


class Predicate:
    """Base node. Combine with ``&``, ``|``, ``~``."""

    def columns(self) -> set:
        raise NotImplementedError

    def mask(self, table: dict) -> np.ndarray:
        raise NotImplementedError

    def maybe_any(self, stats: dict) -> bool:
        raise NotImplementedError

    def always(self, stats: dict) -> bool:
        raise NotImplementedError

    def sketch_refutes(self, sketches: dict) -> bool:
        """Do the per-value sketches *prove* no row can match?

        ``sketches`` maps column name -> an object with ``may_contain(v)``
        (``scan.sketch.BloomSketch``). Only equality-shaped leaves can be
        refuted; every other node conservatively answers False ("cannot
        refute"), which keeps the test sound under arbitrary nesting —
        ``Not`` in particular never refutes, because "value absent" says
        nothing about the complement."""
        return False

    def __and__(self, other: "Predicate") -> "Predicate":
        return And(self, other)

    def __or__(self, other: "Predicate") -> "Predicate":
        return Or(self, other)

    def __invert__(self) -> "Predicate":
        return Not(self)


def _column(table: dict, name: str) -> np.ndarray:
    try:
        data = table[name]
    except KeyError:
        raise KeyError(f"predicate column {name!r} not in table") from None
    if isinstance(data, list):
        raise TypeError(
            f"predicate column {name!r} is a list/string column; predicates "
            "support scalar columns only")
    return np.asarray(data)


@dataclass(frozen=True)
class Cmp(Predicate):
    col: str
    op: str
    value: float | int

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"bad op {self.op!r}; one of {_OPS}")

    def __repr__(self):
        return f"({self.col} {self.op} {self.value!r})"

    def columns(self) -> set:
        return {self.col}

    def mask(self, table: dict) -> np.ndarray:
        x = _column(table, self.col)
        v = self.value
        if self.op == "==":
            return x == v
        if self.op == "!=":
            return x != v
        if self.op == "<":
            return x < v
        if self.op == "<=":
            return x <= v
        if self.op == ">":
            return x > v
        return x >= v

    def maybe_any(self, stats: dict) -> bool:
        rec = stats.get(self.col)
        if not _usable(rec):
            return True
        lo, hi = float(rec["min"]), float(rec["max"])
        nulls = int(rec["null_count"])
        v_lo, v_hi = f8_lower(self.value), f8_upper(self.value)
        if self.op == "==":
            return not (v_hi < lo or v_lo > hi)
        if self.op == "!=":
            # empty only when every row equals value exactly
            return not (lo == hi == np.float64(self.value)
                        and f8_exact(self.value) and nulls == 0)
        if self.op == "<":
            return not (lo >= v_hi)
        if self.op == "<=":
            return not (lo > v_hi)
        if self.op == ">":
            return not (hi <= v_lo)
        return not (hi < v_lo)          # >=

    def always(self, stats: dict) -> bool:
        rec = stats.get(self.col)
        if not _usable(rec):
            return False
        lo, hi = float(rec["min"]), float(rec["max"])
        nulls = int(rec["null_count"])
        v_lo, v_hi = f8_lower(self.value), f8_upper(self.value)
        if self.op == "!=":
            # NaN != v is True, so nulls don't break universality
            return v_hi < lo or v_lo > hi
        if nulls:
            return False                # NaN rows fail every other comparison
        if self.op == "==":
            return (lo == hi == np.float64(self.value)
                    and f8_exact(self.value))
        if self.op == "<":
            return hi < v_lo
        if self.op == "<=":
            return hi <= v_lo
        if self.op == ">":
            return lo > v_hi
        return lo >= v_hi               # >=

    def sketch_refutes(self, sketches: dict) -> bool:
        if self.op != "==":
            return False
        sk = sketches.get(self.col)
        return sk is not None and not sk.may_contain(self.value)


@dataclass(frozen=True)
class In(Predicate):
    col: str
    values: tuple = field(default_factory=tuple)

    def __init__(self, col: str, values):
        object.__setattr__(self, "col", col)
        object.__setattr__(self, "values", tuple(np.asarray(values).ravel().tolist()))

    def __repr__(self):
        return f"({self.col} IN {list(self.values)})"

    def columns(self) -> set:
        return {self.col}

    def mask(self, table: dict) -> np.ndarray:
        x = _column(table, self.col)
        return np.isin(x, np.asarray(self.values))

    def maybe_any(self, stats: dict) -> bool:
        rec = stats.get(self.col)
        if not _usable(rec):
            return True
        lo, hi = float(rec["min"]), float(rec["max"])
        return any(not (f8_upper(v) < lo or f8_lower(v) > hi)
                   for v in self.values)

    def always(self, stats: dict) -> bool:
        return False

    def sketch_refutes(self, sketches: dict) -> bool:
        sk = sketches.get(self.col)
        if sk is None:
            return False
        # vacuously refuted when empty: ``IN {}`` matches no row
        return all(not sk.may_contain(v) for v in self.values)


class _NAry(Predicate):
    def __init__(self, *children: Predicate):
        flat: list[Predicate] = []
        for c in children:
            if type(c) is type(self):
                flat.extend(c.children)     # associative flattening
            else:
                flat.append(c)
        if not flat:
            raise ValueError(f"{type(self).__name__} needs >= 1 child")
        self.children = tuple(flat)

    def columns(self) -> set:
        out: set = set()
        for c in self.children:
            out |= c.columns()
        return out

    def __repr__(self):
        word = f" {type(self).__name__.upper()} "
        return "(" + word.join(map(repr, self.children)) + ")"


class And(_NAry):
    def mask(self, table: dict) -> np.ndarray:
        out = self.children[0].mask(table)
        for c in self.children[1:]:
            out = out & c.mask(table)
        return out

    def maybe_any(self, stats: dict) -> bool:
        return all(c.maybe_any(stats) for c in self.children)

    def always(self, stats: dict) -> bool:
        return all(c.always(stats) for c in self.children)

    def sketch_refutes(self, sketches: dict) -> bool:
        return any(c.sketch_refutes(sketches) for c in self.children)


class Or(_NAry):
    def mask(self, table: dict) -> np.ndarray:
        out = self.children[0].mask(table)
        for c in self.children[1:]:
            out = out | c.mask(table)
        return out

    def maybe_any(self, stats: dict) -> bool:
        return any(c.maybe_any(stats) for c in self.children)

    def always(self, stats: dict) -> bool:
        return any(c.always(stats) for c in self.children)

    def sketch_refutes(self, sketches: dict) -> bool:
        return all(c.sketch_refutes(sketches) for c in self.children)


class Not(Predicate):
    def __init__(self, child: Predicate):
        self.child = child

    def __repr__(self):
        return f"(NOT {self.child!r})"

    def columns(self) -> set:
        return self.child.columns()

    def mask(self, table: dict) -> np.ndarray:
        return ~self.child.mask(table)

    def maybe_any(self, stats: dict) -> bool:
        return not self.child.always(stats)

    def always(self, stats: dict) -> bool:
        return not self.child.maybe_any(stats)


class C:
    """Column handle: ``C("score") >= 0.5`` builds a ``Cmp``."""

    def __init__(self, name: str):
        self.name = name

    def __eq__(self, v):  # type: ignore[override]
        return Cmp(self.name, "==", v)

    def __ne__(self, v):  # type: ignore[override]
        return Cmp(self.name, "!=", v)

    def __lt__(self, v):
        return Cmp(self.name, "<", v)

    def __le__(self, v):
        return Cmp(self.name, "<=", v)

    def __gt__(self, v):
        return Cmp(self.name, ">", v)

    def __ge__(self, v):
        return Cmp(self.name, ">=", v)

    def isin(self, values) -> In:
        return In(self.name, values)

    def between(self, lo, hi) -> Predicate:
        return And(Cmp(self.name, ">=", lo), Cmp(self.name, "<=", hi))

    __hash__ = None  # type: ignore[assignment]


# ---------------------------------------------------------------------------
# kernel compilation: conjunction of ranges -> per-column [lo, hi]
# ---------------------------------------------------------------------------


def conjunctive_ranges(pred: Predicate) -> Optional[dict[str, tuple[float, float]]]:
    """If ``pred`` is a pure conjunction of range/equality comparisons,
    return closed float intervals per column (intersected); else None.

    This is the planable form the range-filter kernel accepts:
    ``lo[c] <= x[c] <= hi[c]`` AND-reduced over columns. Strict comparisons
    are closed by one float64 ULP, exact for every representable literal.
    """
    leaves: list[Cmp] = []

    def collect(p: Predicate) -> bool:
        if isinstance(p, And):
            return all(collect(c) for c in p.children)
        if isinstance(p, Cmp) and p.op != "!=":
            leaves.append(p)
            return True
        return False

    if not collect(pred):
        return None
    out: dict[str, tuple[float, float]] = {}
    for leaf in leaves:
        lo, hi = out.get(leaf.col, (-np.inf, np.inf))
        v = float(leaf.value)
        if leaf.op == "==":
            lo, hi = max(lo, v), min(hi, v)
        elif leaf.op == "<":
            hi = min(hi, float(np.nextafter(np.float64(v), -np.inf)))
        elif leaf.op == "<=":
            hi = min(hi, v)
        elif leaf.op == ">":
            lo = max(lo, float(np.nextafter(np.float64(v), np.inf)))
        else:                            # >=
            lo = max(lo, v)
        out[leaf.col] = (lo, hi)
    return out


def canonical_repr(pred: Optional[Predicate]) -> str:
    """Order-insensitive textual form for plan fingerprinting.

    ``And``/``Or`` are commutative and associative (the constructors already
    flatten nesting), so their children are rendered sorted: chaining
    ``.where(a).where(b)`` and ``.where(b).where(a)`` produce the same
    canonical string. Leaves reuse their deterministic ``repr``."""
    if pred is None:
        return "-"
    if isinstance(pred, (And, Or)):
        word = f" {type(pred).__name__.upper()} "
        return "(" + word.join(sorted(canonical_repr(c)
                                      for c in pred.children)) + ")"
    if isinstance(pred, Not):
        return f"(NOT {canonical_repr(pred.child)})"
    return repr(pred)


def evaluate(pred: Predicate, table: dict) -> np.ndarray:
    """Vectorized evaluation over decoded columns -> bool mask."""
    return np.asarray(pred.mask(table), bool)
