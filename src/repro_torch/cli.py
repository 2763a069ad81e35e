"""``bullion`` command-line tool: storage introspection + telemetry.

Run as ``python -m repro_torch.cli <command>``:

* ``inspect PATH...`` — dump a shard's anatomy: footer sections, columns
  (kind/dtype/quantization), per-group layout, and with ``--pages`` every
  page's offset/size/rows/encoding, zone map, deletion vector, and sketch
  presence. Accepts files, shard directories, globs, and
  ``bullion://bucket/key`` object-store URIs (any dataset spec
  ``dataset()`` accepts).
* ``fsck PATH...`` — verify integrity: page checksums against the footer,
  the Merkle group/root bounds, deletion-vector soundness (extent bounds,
  compacted-page row accounting), zone-map consistency (decoded values
  inside recorded min/max), and sketch consistency (no false negatives).
  Exit code 0 = clean, 1 = content corruption found, 2 = unusable input
  (a torn or truncated shard the reader refuses to open, or a path that
  resolves to nothing). Checks gate on section presence, so v0
  (stat-less) through v3 (sketched) files all verify. ``--json`` emits a
  machine-readable report: per-shard, per-category check/failure counts
  with first-failure locations, plus the would-be exit code.
* ``log [PATH.jsonl]`` — pretty-print query-log records from a
  ``BULLION_QUERY_LOG`` JSONL sink, or ``--socket`` to pull the bounded
  ring from a live server.
* ``metrics`` — the metrics registry in Prometheus text format;
  ``--socket`` scrapes a live server, default renders this process's
  (mostly empty) registry.

Every check the fsck performs mirrors an invariant ``BullionWriter`` /
``deletion._rebuild_footer`` maintains — the test suite flips page bytes
and asserts the non-zero exit.

Ported from ``repro.cli``: host code only (NumPy decode and dequantize),
it runs no kernel and takes no device. A ``bfloat16`` page decodes as its
bits here and is widened to float32 (exact) before the checks, which then
read the values the reference's ``ml_dtypes`` array holds.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

from .core.backend import open_shard
from .core.encodings import blob_encoding_name
from .core.encodings.base import BF16_CODE, bf16_to_f32
from .core.footer import ColKind, PageType, Sec, ShardCorruptError, \
    read_footer
from .core.merkle import combine, page_hash
from .core.quantization import QUANT_DTYPE, QuantMode, QuantSpec, dequantize
from .core import pages as pages_mod
from .dataset.source import discover
from .obs.expose import prometheus_text
from .scan.sketch import canonical_u64
from .scan.stats import HAS_MINMAX, LIST_ELEMENTS

_U64_NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
_COMPACTED = 0x80
_PTYPE_MASK = 0x7F


def _paths(specs: list[str]) -> list[str]:
    out: list[str] = []
    for spec in specs:
        out.extend(discover(spec))
    return out


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


# ---------------------------------------------------------------------------
# inspect
# ---------------------------------------------------------------------------

def _quant_specs(fv) -> list[QuantSpec]:
    if not fv.has(Sec.QUANT_META):
        return [QuantSpec()] * fv.n_cols
    recs = fv.arr(Sec.QUANT_META, QUANT_DTYPE)
    return [QuantSpec.from_record(recs[c]) for c in range(fv.n_cols)]


def inspect_shard(path: str, *, pages: bool = False, out=None) -> None:
    out = sys.stdout if out is None else out
    fv, foot_off = read_footer(path)
    from .core.encodings.base import code_name
    print(f"{path}: bullion v{fv.format_version}  rows={fv.num_rows}  "
          f"cols={fv.n_cols}  groups={fv.n_groups}  pages={fv.n_pages}  "
          f"compliance=L{fv.compliance}  "
          f"file_checksum={fv.file_checksum:#018x}", file=out)
    secs = " ".join(
        f"{Sec(sid).name}({size}B)" if sid in Sec._value2member_map_
        else f"?{sid}({size}B)"
        for sid, (off, size) in sorted(fv._dir.items()))
    print(f"  sections: {secs}", file=out)
    props = fv.props()
    if props:
        print("  props: " + " ".join(f"{k}={v}"
                                     for k, v in sorted(props.items())),
              file=out)
    kinds = fv.arr(Sec.COL_KIND, np.uint8)
    dtypes = fv.arr(Sec.COL_DTYPE, np.uint8)
    logical = fv.arr(Sec.COL_LOGICAL, np.uint8)
    quants = _quant_specs(fv)
    csk = fv.arr(Sec.CHUNK_SKETCH, np.uint64) \
        if fv.has(Sec.CHUNK_SKETCH) else None
    names = fv.column_names()
    print(f"  {'col':<4}{'name':<16}{'kind':<10}{'dtype':<10}"
          f"{'logical':<10}{'quant':<14}sketched", file=out)
    for c, name in enumerate(names):
        q = quants[c]
        qs = QuantMode(q.mode).name.lower()
        if q.mode in (QuantMode.INT8_AFFINE, QuantMode.UINT8_AFFINE,
                      QuantMode.INT16_AFFINE):
            qs += f"(x{q.scale:g}+{q.zero:g})"
        sk = "-"
        if csk is not None:
            n_sk = int(np.sum(csk[c::fv.n_cols] != _U64_NONE))
            sk = f"{n_sk}/{fv.n_groups} chunk(s)"
        print(f"  {c:<4}{name:<16}{ColKind(int(kinds[c])).name.lower():<10}"
              f"{code_name(int(dtypes[c])):<10}"
              f"{code_name(int(logical[c])):<10}{qs:<14}{sk}",
              file=out)
    rows_per_group = fv.arr(Sec.ROWS_PER_GROUP, np.uint32)
    sizes = fv.arr(Sec.PAGE_SIZE, np.uint64)
    gps = fv.group_page_start()
    for g in range(fv.n_groups):
        s, e = int(gps[g]), int(gps[g + 1])
        print(f"  group {g}: rows={int(rows_per_group[g])} "
              f"pages=[{s},{e}) bytes={_fmt_bytes(int(sizes[s:e].sum()))}",
              file=out)
    if not pages:
        return
    offs = fv.arr(Sec.PAGE_OFFSET, np.uint64)
    prows = fv.arr(Sec.PAGE_ROWS, np.uint32)
    flags = fv.arr(Sec.PAGE_FLAGS, np.uint8)
    pstats = fv.page_stats()
    psk = fv.arr(Sec.PAGE_SKETCH, np.uint64) \
        if fv.has(Sec.PAGE_SKETCH) else None
    col_of = _page_columns(fv)
    print(f"  {'page':<6}{'col':<16}{'type':<14}{'rows':<7}{'offset':<10}"
          f"{'size':<9}{'enc':<17}{'zone map':<26}{'dv':<6}sketch",
          file=out)
    with open_shard(path) as h:
        for p in range(fv.n_pages):
            flag = int(flags[p])
            ptype = PageType(flag & _PTYPE_MASK).name.lower()
            if flag & _COMPACTED:
                ptype += "+compact"
            head = h.pread(int(offs[p]), min(int(sizes[p]), 64))
            try:
                enc = blob_encoding_name(head)
            except Exception:
                enc = "-"
            zm = "-"
            if pstats is not None and pstats[p]["flags"] & HAS_MINMAX:
                tag = "elems " if pstats[p]["flags"] & LIST_ELEMENTS else ""
                zm = (f"{tag}[{float(pstats[p]['min']):g}, "
                      f"{float(pstats[p]['max']):g}]")
            dv = fv.deletion_vector(p)
            dvs = str(int(dv.sum())) if dv is not None else "-"
            sk = "-"
            if psk is not None:
                sk = "yes" if psk[p] != _U64_NONE else "no"
            print(f"  {p:<6}{col_of[p][1]:<16}{ptype:<14}"
                  f"{int(prows[p]):<7}{int(offs[p]):<10}"
                  f"{int(sizes[p]):<9}{enc:<17}{zm:<26}{dvs:<6}{sk}",
                  file=out)


def _page_columns(fv) -> dict[int, tuple[int, str]]:
    """page ordinal -> (column index, column name) via the chunk index."""
    names = fv.column_names()
    out: dict[int, tuple[int, str]] = {}
    for g in range(fv.n_groups):
        for c in range(fv.n_cols):
            s, e = fv.chunk_pages(g, c)
            for p in range(s, e):
                out[p] = (c, names[c])
    return out


def cmd_inspect(args) -> int:
    try:
        paths = _paths(args.path)
    except (FileNotFoundError, ValueError) as e:
        print(f"bullion inspect: {e}", file=sys.stderr)
        return 2
    for i, path in enumerate(paths):
        if i:
            print()
        try:
            inspect_shard(path, pages=args.pages)
        except (OSError, ValueError) as e:
            print(f"{path}: unreadable: {e}", file=sys.stderr)
            return 2
    return 0


# ---------------------------------------------------------------------------
# fsck
# ---------------------------------------------------------------------------

class _Fsck:
    """One shard's verification pass; collects findings instead of raising
    so a single corrupt page doesn't hide the rest."""

    def __init__(self, path: str, *, max_errors: int = 50):
        self.path = path
        self.errors: list[str] = []
        self.checks = 0
        self.failures = 0
        self.unusable: Optional[str] = None
        self.cats: dict[str, dict] = {}
        self.max_errors = max_errors

    def _cat(self, cat: str) -> dict:
        return self.cats.setdefault(
            cat, {"checks": 0, "failed": 0, "first_failure": None})

    def fail(self, msg: str, cat: str = "structure") -> None:
        self.failures += 1
        d = self._cat(cat)
        d["failed"] += 1
        if d["first_failure"] is None:
            d["first_failure"] = msg
        if len(self.errors) < self.max_errors:
            self.errors.append(f"{self.path}: {msg}")

    def check(self, ok: bool, msg: str, cat: str = "structure") -> bool:
        self.checks += 1
        self._cat(cat)["checks"] += 1
        if not ok:
            self.fail(msg, cat=cat)
        return ok

    def report(self) -> dict:
        """Machine-readable summary for ``fsck --json``."""
        return {"path": self.path, "checks": self.checks,
                "failures": self.failures, "unusable": self.unusable,
                "categories": self.cats, "errors": list(self.errors)}

    def run(self) -> None:
        try:
            fv, foot_off = read_footer(self.path)
        except ShardCorruptError as e:
            # the reader refuses to open this file at all (torn write,
            # truncated footer, bad magic): unusable, not merely corrupt
            self.unusable = str(e)
            self.fail(f"unusable: {e}", cat="open")
            return
        except (OSError, ValueError) as e:
            self.fail(f"unreadable footer: {e}", cat="open")
            return
        offs = fv.arr(Sec.PAGE_OFFSET, np.uint64)
        sizes = fv.arr(Sec.PAGE_SIZE, np.uint64)
        prows = fv.arr(Sec.PAGE_ROWS, np.uint32)
        flags = fv.arr(Sec.PAGE_FLAGS, np.uint8)
        n_pages = fv.n_pages
        self.check(len(offs) == n_pages and len(sizes) == n_pages
                   and len(prows) == n_pages and len(flags) == n_pages,
                   f"page index sections disagree with META n_pages="
                   f"{n_pages}")

        # -- extents + checksums + Merkle bounds ---------------------------
        cksums = fv.arr(Sec.PAGE_CHECKSUM, np.uint64) \
            if fv.has(Sec.PAGE_CHECKSUM) else None
        raw_pages: dict[int, bytes] = {}
        with open_shard(self.path) as h:
            for p in range(n_pages):
                off, size = int(offs[p]), int(sizes[p])
                if not self.check(
                        0 <= off and off + size <= foot_off,
                        f"page {p}: extent [{off}, {off + size}) outside "
                        f"data region [0, {foot_off})", cat="extents"):
                    continue
                try:
                    blob = h.pread(off, size)
                except OSError as e:
                    self.fail(f"page {p}: unreadable: {e}", cat="extents")
                    continue
                raw_pages[p] = blob
                if cksums is not None:
                    self.check(
                        page_hash(blob) == int(cksums[p]),
                        f"page {p}: checksum mismatch (stored "
                        f"{int(cksums[p]):#018x}, computed "
                        f"{page_hash(blob):#018x})", cat="checksums")
        if cksums is not None and fv.has(Sec.GROUP_CHECKSUM):
            gsum = fv.arr(Sec.GROUP_CHECKSUM, np.uint64)
            gps = fv.group_page_start()
            groups_ok = True
            for g in range(fv.n_groups):
                want = combine(cksums[int(gps[g]):int(gps[g + 1])])
                if not self.check(
                        want == int(gsum[g]),
                        f"group {g}: Merkle checksum mismatch",
                        cat="merkle"):
                    groups_ok = False
            if groups_ok:
                self.check(combine(gsum) == fv.file_checksum,
                           "file Merkle root mismatch", cat="merkle")

        # -- deletion vectors ----------------------------------------------
        dv_data = len(fv.raw(Sec.DV_DATA)) if fv.has(Sec.DV_DATA) else 0
        dvs: dict[int, Optional[np.ndarray]] = {}
        if fv.has(Sec.DV_OFFSET):
            dvo = fv.arr(Sec.DV_OFFSET, np.uint64)
            dvl = fv.arr(Sec.DV_SIZE, np.uint32)
            for p in range(n_pages):
                if dvo[p] == _U64_NONE:
                    dvs[p] = None
                    continue
                need = (int(prows[p]) + 7) // 8
                if not self.check(
                        int(dvo[p]) + int(dvl[p]) <= dv_data
                        and int(dvl[p]) >= need,
                        f"page {p}: deletion vector extent "
                        f"[{int(dvo[p])}, +{int(dvl[p])}) unsound for "
                        f"{int(prows[p])} rows (DV_DATA {dv_data}B)",
                        cat="deletion_vectors"):
                    dvs[p] = None
                    continue
                dvs[p] = fv.deletion_vector(p)
        else:
            dvs = {p: None for p in range(n_pages)}
        for p in range(n_pages):
            if int(flags[p]) & _COMPACTED:
                self.check(dvs.get(p) is not None,
                           f"page {p}: COMPACTED flag without a deletion "
                           f"vector", cat="deletion_vectors")

        # -- decode + zone maps + sketches ---------------------------------
        kinds = fv.arr(Sec.COL_KIND, np.uint8)
        quants = _quant_specs(fv)
        pstats = fv.page_stats()
        cstats = fv.chunk_stats()
        col_of = _page_columns(fv)
        chunk_vals: dict[tuple[int, int], list[np.ndarray]] = {}
        for g in range(fv.n_groups):
            for c in range(fv.n_cols):
                s, e = fv.chunk_pages(g, c)
                for p in range(s, e):
                    if p not in raw_pages:
                        continue
                    vals = self._check_page(fv, g, c, p, raw_pages[p],
                                            int(flags[p]), int(prows[p]),
                                            dvs.get(p), kinds, quants,
                                            pstats)
                    if vals is not None:
                        chunk_vals.setdefault((g, c), []).append(vals)
        self._check_chunks(fv, chunk_vals, cstats, pstats, quants, kinds)

    def _decode(self, flag: int, blob: bytes):
        return pages_mod.decode_page(flag & _PTYPE_MASK, blob)

    def _check_page(self, fv, g: int, c: int, p: int, blob: bytes,
                    flag: int, rows: int, dv, kinds, quants, pstats
                    ) -> Optional[np.ndarray]:
        """Decode one page, verify its row accounting + zone map + sketch;
        returns the page's (dequantized, flattened) value array for the
        chunk-level checks, or None if the page didn't decode."""
        try:
            decoded = self._decode(flag, blob)
        except Exception as e:
            self.fail(f"page {p}: decode failed: {type(e).__name__}: {e}",
                      cat="decode")
            return None
        # row accounting: a compacted page physically stores only the
        # survivors; anything else stores the raw row count
        expect = rows
        if flag & _COMPACTED and dv is not None:
            expect = rows - int(dv.sum())
        self.check(len(decoded) == expect,
                   f"page {p}: decoded {len(decoded)} rows, footer says "
                   f"{expect} ({'compacted' if flag & _COMPACTED else 'raw'}"
                   f" of {rows})", cat="decode")
        kind = int(kinds[c])
        if kind == int(ColKind.STRING):
            return None                      # no numeric domain to verify
        bf16 = False
        if kind in (int(ColKind.SCALAR), int(ColKind.MEDIA_REF)):
            vals = np.asarray(decoded)
            if int(fv.arr(Sec.COL_DTYPE, np.uint8)[c]) == BF16_CODE:
                # the reference's bfloat16 array is of kind "V": it keeps
                # its non-finite values, and so do the widened bits
                vals, bf16 = bf16_to_f32(vals), True
            elif kind == int(ColKind.SCALAR) \
                    and quants[c].mode != QuantMode.NONE:
                vals = np.asarray(dequantize(vals, quants[c]))
        else:                                # list: element domain
            vals = np.concatenate([np.asarray(r) for r in decoded]) \
                if len(decoded) else np.zeros(0)
        finite = vals[np.isfinite(vals.astype(np.float64, copy=False))] \
            if vals.dtype.kind == "f" and not bf16 else vals
        if pstats is not None and pstats[p]["flags"] & HAS_MINMAX \
                and len(finite):
            lo, hi = float(pstats[p]["min"]), float(pstats[p]["max"])
            amin, amax = float(finite.min()), float(finite.max())
            self.check(amin >= lo and amax <= hi,
                       f"page {p}: zone map [{lo:g}, {hi:g}] excludes "
                       f"decoded range [{amin:g}, {amax:g}]",
                       cat="zone_maps")
        sk = fv.page_sketch(p)
        if sk is not None and len(finite):
            self._check_sketch(sk, finite, f"page {p}")
        return finite

    def _check_sketch(self, sk, vals: np.ndarray, what: str,
                      cap: int = 256) -> None:
        """A bloom sketch must never produce a false negative for a value
        the data actually holds."""
        uniq = np.unique(np.asarray(vals, np.float64))
        if len(uniq) > cap:
            idx = np.linspace(0, len(uniq) - 1, cap).astype(np.int64)
            uniq = uniq[idx]
        for v in uniq:
            self.checks += 1
            self._cat("sketches")["checks"] += 1
            if not sk.may_contain(float(v)):
                self.fail(f"{what}: sketch false negative for value "
                          f"{float(v):g} (key "
                          f"{int(canonical_u64(float(v)))})",
                          cat="sketches")
                return

    def _check_chunks(self, fv, chunk_vals, cstats, pstats, quants,
                      kinds) -> None:
        for (g, c), parts in chunk_vals.items():
            vals = np.concatenate(parts) if parts else np.zeros(0)
            if not len(vals):
                continue
            idx = g * fv.n_cols + c
            if cstats is not None and cstats[idx]["flags"] & HAS_MINMAX:
                lo, hi = float(cstats[idx]["min"]), float(cstats[idx]["max"])
                amin, amax = float(vals.min()), float(vals.max())
                self.check(
                    amin >= lo and amax <= hi,
                    f"chunk (g={g}, c={c}): zone map [{lo:g}, {hi:g}] "
                    f"excludes decoded range [{amin:g}, {amax:g}]",
                    cat="zone_maps")
            sk = fv.chunk_sketch(g, c)
            if sk is not None:
                self._check_sketch(sk, vals, f"chunk (g={g}, c={c})")


def cmd_fsck(args) -> int:
    as_json = getattr(args, "json", False)
    try:
        paths = _paths(args.path)
    except (FileNotFoundError, ValueError) as e:
        if as_json:
            print(json.dumps({"shards": [], "errors": 0, "unusable": 1,
                              "exit": 2, "error": str(e)}))
        else:
            print(f"bullion fsck: {e}", file=sys.stderr)
        return 2
    total_errors = 0
    unusable = 0
    reports: list[dict] = []
    for path in paths:
        f = _Fsck(path, max_errors=args.max_errors)
        f.run()
        reports.append(f.report())
        total_errors += f.failures
        unusable += 1 if f.unusable else 0
        if as_json:
            continue
        for err in f.errors:
            print(f"CORRUPT  {err}")
        if args.verbose or f.failures:
            state = "UNUSABLE" if f.unusable else \
                ("CORRUPT" if f.failures else "clean")
            print(f"{path}: {state} ({f.checks} check(s), "
                  f"{f.failures} error(s))")
    code = 2 if unusable else (1 if total_errors else 0)
    if as_json:
        print(json.dumps({"shards": reports, "errors": total_errors,
                          "unusable": unusable, "exit": code}, indent=2))
        return code
    if total_errors:
        print(f"bullion fsck: {total_errors} error(s) across "
              f"{len(paths)} shard(s)")
    elif args.verbose:
        print(f"bullion fsck: {len(paths)} shard(s) clean")
    return code


# ---------------------------------------------------------------------------
# log + metrics
# ---------------------------------------------------------------------------

def _format_record(r: dict) -> str:
    fp = (r.get("fingerprint") or "")[:12] or "-"
    hit = r.get("cache_hit")
    hit = "-" if hit is None else ("hit" if hit else "miss")
    wall = r.get("wall_seconds") or 0.0
    line = (f"{r.get('ts', 0):.3f} {r.get('origin', '?'):<10} "
            f"{(r.get('dataset') or '-'):<20} "
            f"{r.get('tenant', '-'):<10} {fp:<13}{hit:<5}"
            f"{r.get('rows', 0):>8} rows {wall * 1e3:>9.3f} ms  "
            f"{r.get('outcome', '?')}")
    if r.get("slow"):
        line += "  SLOW"
    if r.get("error"):
        line += f"  {r['error']}"
    return line


def cmd_log(args) -> int:
    records: list[dict] = []
    if args.socket:
        from .serve.client import ServeClient
        with ServeClient(args.socket) as cli:
            records = cli.server_log(args.n)
    elif args.path:
        try:
            with open(args.path) as f:
                for line in f:
                    if line.strip():
                        records.append(json.loads(line))
        except (OSError, ValueError) as e:
            print(f"bullion log: {args.path}: {e}", file=sys.stderr)
            return 2
        records = records[-args.n:]
    else:
        from .obs import querylog
        records = [r.to_dict() for r in querylog.LOG.tail(args.n)]
    if not records:
        print("no query-log records")
        return 0
    for r in records:
        print(_format_record(r))
    errors = sum(1 for r in records if r.get("outcome") != "ok")
    slow = sum(1 for r in records if r.get("slow"))
    print(f"-- {len(records)} record(s), {errors} error(s), "
          f"{slow} slow")
    return 0


def cmd_metrics(args) -> int:
    if args.socket:
        from .serve.client import ServeClient
        with ServeClient(args.socket) as cli:
            sys.stdout.write(cli.metrics_text())
    else:
        sys.stdout.write(prometheus_text())
    return 0


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bullion", description="Bullion storage + telemetry tool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="dump shard layout and metadata")
    p.add_argument("path", nargs="+",
                   help="shard file / dataset dir / glob")
    p.add_argument("--pages", action="store_true",
                   help="include the per-page table")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("fsck", help="verify shard integrity")
    p.add_argument("path", nargs="+",
                   help="shard file / dataset dir / glob")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--max-errors", type=int, default=50,
                   help="stop collecting per-shard findings after N")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report: per-shard, per-category "
                        "check/failure counts + first failures")
    p.set_defaults(fn=cmd_fsck)

    p = sub.add_parser("log", help="pretty-print query-log records")
    p.add_argument("path", nargs="?",
                   help="BULLION_QUERY_LOG JSONL file")
    p.add_argument("--socket", help="pull from a live server socket")
    p.add_argument("-n", type=int, default=50, help="max records")
    p.set_defaults(fn=cmd_log)

    p = sub.add_parser("metrics",
                       help="metrics registry, Prometheus text format")
    p.add_argument("--socket", help="scrape a live server socket")
    p.set_defaults(fn=cmd_metrics)
    return ap


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
