"""The device route of page decode: ``fixed_bit_width`` and ``dictionary``
scalar pages unpacked by the page-unpack kernel's plain version
(``kernels.page_unpack``) and by ``decode_group`` on ``device="cpu"``,
against the NumPy route (``pages.decode_page`` then ``apply_dv``, and
``use_kernel=False``).

Tolerance: none. Every value is compared bit for bit. The kernel itself
runs only on the card (``tests/test_torch_gpu.py``).
"""

import itertools
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import BullionReader, BullionWriter, ColumnSpec, \
    QuantMode, QuantSpec
from repro_torch.core import pages as pages_mod
from repro_torch.core.deletion import Compliance, delete_rows
from repro_torch.core.encodings.base import (BY_NAME, EncodeContext,
                                             blob_encoding_name, dtype_code,
                                             frame, mask_blob)
from repro_torch.core.encodings.numeric import pack_bits
from repro_torch.core.footer import PageType, Sec
from repro_torch.dataset import dataset, executor, page_route
from repro_torch.dataset.page_route import route_page
from repro_torch.kernels.page_unpack import (Page, pack_pages, page_unpack,
                                             page_unpack_ref)
from repro_torch.kernels.page_unpack.staging import (BLOCK_BYTES, DESC_DTYPE,
                                                     blocks, descriptors,
                                                     layout_pages)
from repro_torch.obs import metrics, trace
from repro_torch.scan import C

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc" / "page_unpack.cu"
SCALAR = int(PageType.SCALAR)

# the first 8 of the benchmark table's categorical cardinalities (MLPerf
# DLRM's Criteo counts), and its 13 BF16 features
CARDS = [39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543]
DENSE = [f"I{i}" for i in range(1, 14)]
SPARSE = [f"C{i}" for i in range(1, 9)]


def criteo_like(n: int, seed: int) -> dict:
    """A table of the benchmark's Criteo shape at ``n`` rows: sorted
    power-law users, an int8 label (3% ones), 13 ``log(1 + count)``
    features (BF16-quantized where written) and 8 int32 categories."""
    rng = np.random.default_rng(seed)
    users = np.sort(np.floor(rng.pareto(1.2, n) * 50).astype(np.int64))
    out = {"user_id": users, "ts": 1_600_000_000 + np.arange(n) * 7,
           "label": (rng.random(n) < 0.03).astype(np.int8)}
    for name in DENSE:
        out[name] = np.log1p(np.floor(rng.pareto(0.5, n))).astype(np.float32)
    for name, card in zip(SPARSE, CARDS):
        # hashed ids: the popular ranks scattered over the id range
        rank = np.floor(rng.pareto(0.25, n)).clip(max=2**31)
        out[name] = (rank.astype(np.int64) * 2654435761 % card) \
            .astype(np.int32)
    return out


def write_criteo_like(path: str, n: int, seed: int, *,
                      rows_per_group: int, delete_share: float = 0.0,
                      level=Compliance.LEVEL2, mixed: bool = False) -> dict:
    """The table written by the port's writer, then a seeded share of its
    users deleted at ``level``. ``mixed``: the categorical columns' pages
    cycle through ``fixed_bit_width``, ``chunked`` and ``bitshuffle`` (an
    encoding advisor, on a writer that does not restrict the cascade to
    maskable encodings)."""
    table = criteo_like(n, seed)
    kinds = itertools.cycle([("fixed_bit_width",), ("chunked",),
                             ("bitshuffle",)])

    def advisor(rec, rows, dtype):
        return next(kinds) if np.dtype(dtype) == np.int32 else None

    schema = [ColumnSpec("user_id", "int64"), ColumnSpec("ts", "int64"),
              ColumnSpec("label", "int8")]
    schema += [ColumnSpec(c, "float32", quant=QuantSpec(QuantMode.BF16))
               for c in DENSE]
    schema += [ColumnSpec(c, "int32") for c in SPARSE]
    w = BullionWriter(path, schema, rows_per_group=rows_per_group,
                      **(dict(compliance=1, encoding_advisor=advisor)
                         if mixed else {}))
    w.write_table(table)
    w.close()
    if delete_share:
        rng = np.random.default_rng(seed + 1)
        present = np.unique(table["user_id"])
        victims = rng.choice(present, max(1, int(len(present)
                                                 * delete_share)),
                             replace=False)
        delete_rows(path, np.flatnonzero(np.isin(table["user_id"], victims)),
                    level)
    return table


# ---------------------------------------------------------------------------
# the kernel's plain version against the NumPy decode, page by page
# ---------------------------------------------------------------------------


def _fbw_blob(values: np.ndarray, width: int, dtype) -> bytes:
    """A ``fixed_bit_width`` page of ``values`` (uint64, < 2**width) that
    decodes to ``dtype`` (NumPy's cast of the codes), framed as the
    writer frames it."""
    header = struct.pack("<BQB", dtype_code(np.dtype(dtype)), len(values),
                         width)
    return frame(BY_NAME["fixed_bit_width"].eid, header,
                 pack_bits(values, width))


def _numpy_route(blob, page_rows, dv):
    return pages_mod.apply_dv(pages_mod.decode_page(SCALAR, blob), dv,
                              page_rows)


def _device_route(pages: list, dtype) -> list[np.ndarray]:
    """``pages`` unpacked by the plain version into one buffer, each page
    at an offset one value past a 16-byte boundary (heads and tails)."""
    dtype, at = np.dtype(dtype), 0
    for s in pages:
        at = -(-at // 16) * 16 + dtype.itemsize
        s.out_offset = at
        at += s.rows * dtype.itemsize
    staging, layout = pack_pages(list(pages))
    out = torch.zeros(at + 16, dtype=torch.uint8)
    page_unpack(staging, layout, out)
    host = out.numpy()
    return [host[s.out_offset:s.out_offset
                 + s.rows * dtype.itemsize].view(dtype) for s in pages]


def _same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.uint16])
@pytest.mark.parametrize("width", [0, 1, 7, 8, 26, 33, 64])
@pytest.mark.parametrize("deleted", [False, True])
def test_fixed_bit_width_pages_equal_numpy(dtype, width, deleted):
    """Every width over every output type (wider codes than the type take
    NumPy's cast: their low bytes), with and without a deletion vector,
    at lengths that leave heads and tails of every size."""
    rng = np.random.default_rng(width * 10 + np.dtype(dtype).itemsize)
    pages, wants = [], []
    for n in (1, 15, 17, 1000, 4099):
        values = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
        values = values >> np.uint64(64 - width) if width \
            else np.zeros(n, np.uint64)
        blob = _fbw_blob(values, width, dtype)
        dv = rng.random(n) < 0.2 if deleted else None
        page = route_page(blob, n, np.dtype(dtype), dv)
        assert page is not None
        assert (page.deleted is not None and len(page.deleted) > 0) == \
            bool(deleted and dv.any())
        pages.append(page)
        wants.append(_numpy_route(blob, n, dv))
    for got, want in zip(_device_route(pages, dtype), wants):
        _same(got, want)


@pytest.mark.parametrize("dtype", [np.uint16, np.int8, np.int32, np.int64,
                                   np.float32])
@pytest.mark.parametrize("deleted", [False, True])
def test_dictionary_pages_with_the_mask_entry_equal_numpy(dtype, deleted):
    """Dictionary pages whose deleted rows were masked in place (their
    code rewritten to the reserved entry ``nuniq``): a masked row reads
    0, and with the deletion vector applied it is dropped."""
    rng = np.random.default_rng(7)
    n = 3000
    values = rng.integers(0, 120, n).astype(dtype)
    blob = BY_NAME["dictionary"].encode(values, EncodeContext())
    assert blob is not None and blob_encoding_name(blob) == "dictionary"
    positions = np.sort(rng.choice(n, 200, replace=False))
    masked = mask_blob(blob, positions, n)
    dv = np.zeros(n, bool)
    dv[positions] = True
    page = route_page(masked, n, np.dtype(dtype), dv if deleted else None)
    assert page is not None and len(page.dictionary) == \
        len(np.unique(values))
    want = _numpy_route(masked, n, dv if deleted else None)
    (got,) = _device_route([page], dtype)
    _same(got, want)
    if not deleted:
        assert not got[positions].any()


def test_other_pages_keep_the_host_route():
    """Another top-level encoding, another dtype than the column's, a
    compact-deleted page padded back to the raw rows, or a short stream:
    no page."""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1000, 500).astype(np.int32)
    trivial = BY_NAME["trivial"].encode(vals, EncodeContext())
    fbw = _fbw_blob(vals.astype(np.uint64), 10, np.int32)
    assert route_page(trivial, 500, np.dtype(np.int32)) is None
    assert route_page(fbw, 500, np.dtype(np.int64)) is None
    assert route_page(fbw, 600, np.dtype(np.int32), align=True) is None
    assert route_page(fbw[:-3], 500, np.dtype(np.int32)) is None
    # compacted: 500 values stored for 600 rows, 100 of them deleted
    dv = np.zeros(600, bool)
    dv[rng.choice(600, 100, replace=False)] = True
    page = route_page(fbw, 600, np.dtype(np.int32), dv)
    assert page is not None and page.deleted is None \
        and page.rows == 500
    assert route_page(fbw, 600, np.dtype(np.int32), ~dv) is None


def test_staging_matches_the_kernel_source():
    """``staging.py`` mirrors ``PageDesc`` field for field and the block
    size the kernel assumes; a page's blocks cover its whole vectors."""
    code = re.sub(r"//[^\n]*", "", CSRC.read_text())
    struct_src = code[code.index("struct PageDesc {"):
                      code.index("};", code.index("struct PageDesc {"))]
    assert re.findall(r"(\w+);", struct_src) == list(DESC_DTYPE.names)
    assert DESC_DTYPE.itemsize == 72
    consts = dict(re.findall(r"constexpr \w+(?: \w+)? (k\w+) = ([^;]+);",
                             code))
    assert consts["kBlockBytes"] == "16LL * kThreads * kVecs"
    assert BLOCK_BYTES == 16 * int(consts["kThreads"]) * int(consts["kVecs"])
    for name in ("page_unpack_kernel", "page_unpack_launch"):
        assert name in code
    for word in ("dequant", "range_mask", "flash"):
        assert word not in "".join(re.findall(r"\b\w*page_unpack\w*\b",
                                              code))
    assert blocks(0, 4, 0) == 1
    assert blocks(65536, 4, 0) == 16
    assert blocks(65536, 4, 4) == 16     # 3 head values, 65,532 after
    assert blocks(65536, 2, 0) == 8


def test_layout_places_each_region():
    rng = np.random.default_rng(5)
    pages = [Page(bytes(rng.integers(0, 256, 37, dtype=np.uint8)), 3, 90, 4,
                  out_offset=8),
             Page(bytes(8), 1, 18, 2, np.arange(2, dtype=np.int16),
                  np.array([3, 7]), 1000)]
    staging, layout = pack_pages(pages)
    desc = descriptors(staging, 2)
    assert layout.nbytes == staging.numel() and layout.n_pages == 2
    assert (desc["bits_offset"] % 16 == 0).all()
    assert list(desc["nuniq"]) == [-1, 2]
    assert list(desc["n_deleted"]) == [0, 2] and desc["skip_offset"][1] > 0
    at = int(desc["skip_offset"][1])
    assert list(staging.numpy()[at:at + 8].view(np.int32)) == [3, 6]
    assert list(desc["block_start"]) == [0, 1] and layout.n_blocks == 2
    host = staging.numpy()
    at = int(desc["bits_offset"][0])
    assert at == 2 * DESC_DTYPE.itemsize
    assert bytes(host[at:at + 37]) == pages[0].packed
    assert not host[at + 37:at + 40].any()           # the word's slack
    with pytest.raises(ValueError, match="width"):
        layout_pages([Page(b"", 65, 1, 8)])
    with pytest.raises(ValueError, match="too small"):
        page_unpack(staging, layout, torch.zeros(100, dtype=torch.uint8))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(
        "repro_torch.kernels.page_unpack.ops.page_unpack_ref",
        lambda *a: calls.append(a) or page_unpack_ref(*a))
    page = route_page(_fbw_blob(np.arange(9, dtype=np.uint64), 4, np.int8),
                      9, np.dtype(np.int8))
    (got,) = _device_route([page], np.int8)
    assert len(calls) == 1 and list(got) == list(range(9))


# ---------------------------------------------------------------------------
# decode_group's device route on a table of the benchmark's shape
# ---------------------------------------------------------------------------

COLUMNS = ["label"] + DENSE + SPARSE


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("page_decode")
    paths = {name: str(d / f"{name}.bln")
             for name in ("clean", "l2", "l1", "mixed")}
    write_criteo_like(paths["clean"], 3 * 4096, 11, rows_per_group=4096)
    write_criteo_like(paths["l2"], 3 * 4096, 11, rows_per_group=4096,
                      delete_share=0.03)
    write_criteo_like(paths["l1"], 3 * 4096, 11, rows_per_group=4096,
                      delete_share=0.03, level=Compliance.LEVEL1)
    write_criteo_like(paths["mixed"], 3 * 4096, 11, rows_per_group=4096,
                      delete_share=0.03, level=Compliance.LEVEL1, mixed=True)
    return paths


def _census(path: str) -> dict:
    """Top-level encodings of each column's pages."""
    with BullionReader(path) as r:
        fv = r.footer
        out = {}
        for name in COLUMNS:
            c = fv.column_index(name)
            ids = [p for g in range(fv.n_groups)
                   for p in range(*fv.chunk_pages(g, c))]
            out[name] = {blob_encoding_name(b)
                         for b in r._read_pages(ids).values()}
    return out


def test_the_tables_hold_every_kind_of_page(tables):
    """The writer's encodings (``dictionary`` for the BF16 features,
    ``fixed_bit_width`` for the categories), the pages the LEVEL2 delete
    relocated (``chunked``, ``bitshuffle``) beside them, and columns whose
    pages mix ``fixed_bit_width``, ``chunked`` and ``bitshuffle``."""
    clean, l2 = _census(tables["clean"]), _census(tables["l2"])
    mixed = _census(tables["mixed"])
    assert all(clean[c] == {"dictionary"} for c in DENSE)
    assert all(clean[c] == {"fixed_bit_width"} for c in SPARSE)
    assert all({"dictionary", "chunked"} <= l2[c] for c in DENSE)
    assert {"fixed_bit_width", "chunked", "bitshuffle"} <= \
        set().union(*(l2[c] for c in SPARSE))
    assert all(mixed[c] == {"fixed_bit_width", "chunked", "bitshuffle"}
               for c in SPARSE)


def _read(path, use_kernel, **plan):
    ds = dataset(path, device="cpu").select(COLUMNS)
    for key, value in plan.items():
        ds = getattr(ds, key)(value)
    return ds._with_kernel(use_kernel)


@pytest.mark.parametrize("table", ["clean", "l2", "l1", "mixed"])
@pytest.mark.parametrize("drop_deleted", [True, False])
@pytest.mark.parametrize("dequantized", [True, False])
@pytest.mark.parametrize("use_kernel", [None, True])
def test_decode_group_device_route_equals_numpy(tables, table, drop_deleted,
                                                dequantized, use_kernel):
    """Every column of every route, with and without the deletion vectors
    applied, dequantized or raw, bit for bit the NumPy route's."""
    plan = {"drop_deleted": drop_deleted, "dequantized": dequantized}
    got = _read(tables[table], use_kernel, **plan).to_table()
    want = _read(tables[table], False, **plan).to_table()
    assert list(got) == list(want)
    for name in want:
        _same(got[name], want[name])


@pytest.mark.parametrize("pred", ["dense", "label"])
def test_predicate_reads_equal_numpy(tables, pred):
    where = (C("I1") > 0.5) & (C("I2") > 0.5) if pred == "dense" \
        else C("label") == 1
    got = dataset(tables["l2"], device="cpu").select(COLUMNS).where(where)
    want = dataset(tables["l2"], device="cpu").select(COLUMNS).where(where) \
        ._with_kernel(False)
    assert np.array_equal(got.row_ids(), want.row_ids())
    g, w = got.to_table(parallelism=2), want.to_table()
    for name in w:
        _same(g[name], w[name])


def _counts():
    return (metrics.counter("bullion.decode.pages_device").value,
            metrics.counter("bullion.decode.pages_host").value)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_counters_count_both_routes(tables, use_kernel):
    """``pages_device`` counts the packed pages the route took and
    ``pages_host`` every other page decoded; ``use_kernel=False`` keeps
    every page on the host."""
    with BullionReader(tables["l2"]) as r:
        fv = r.footer
        ids = [p for name in COLUMNS for g in range(fv.n_groups)
               for p in range(*fv.chunk_pages(g, fv.column_index(name)))]
        packed = sum(blob_encoding_name(b) in ("fixed_bit_width",
                                               "dictionary")
                     for b in r._read_pages(ids).values())
    before = _counts()
    _read(tables["l2"], use_kernel).to_table()
    dev, host = (a - b for a, b in zip(_counts(), before))
    assert dev + host == len(ids)
    if use_kernel is False:
        assert dev == 0
    else:
        # compact-deleted packed pages are read as stored: all take it
        assert dev == packed and 0 < dev < len(ids)


@pytest.mark.parametrize("routed", [True, False])
def test_one_unpack_and_one_dequant_a_call(tables, monkeypatch, routed):
    """One page-unpack call and one dequant call for each ``decode_group``
    call with a BF16 column, on the staging the unpack filled, whether or
    not a page of it took the device route (``routed=False``: none does,
    and the host-decoded codes reach that staging as pages of their own
    width), the values bit for bit the NumPy route's."""
    def read(table, use_kernel=None):
        return dataset(tables[table], device="cpu").select(COLUMNS) \
            .where(C("I3") > 0.5).dequantized(True) \
            ._with_kernel(use_kernel).to_table()

    want = {table: read(table, False) for table in ("clean", "l2")}
    calls = {"unpack": 0, "dequant": 0, "groups": 0, "routed": 0}
    real_unpack = page_route.page_unpack
    real_group = executor.decode_group
    import repro_torch.kernels.dequant as dq
    real_packed = dq.dequant_packed

    def unpack(*a):
        calls["unpack"] += 1
        return real_unpack(*a)

    def packed(*a, **kw):
        calls["dequant"] += 1
        return real_packed(*a, **kw)

    def group(*a, **kw):
        before = _counts()[0]
        out = real_group(*a, **kw)
        calls["groups"] += 1
        calls["routed"] += _counts()[0] > before
        return out

    if not routed:
        monkeypatch.setattr(page_route, "route_page", lambda *a, **kw: None)
    monkeypatch.setattr(page_route, "page_unpack", unpack)
    monkeypatch.setattr(dq, "dequant_packed", packed)
    monkeypatch.setattr(executor, "decode_group", group)
    for table in ("clean", "l2"):
        got = read(table)
        for name in want[table]:
            _same(got[name], want[table][name])
    assert calls["groups"] == 2 * 2 * 3     # predicate and payload a group
    assert calls["dequant"] == calls["unpack"] == calls["groups"]
    if routed:
        assert calls["routed"] >= calls["groups"] - 1
    else:
        assert calls["routed"] == 0


def test_spans_name_the_route(tables):
    with trace.collect() as tracer:
        _read(tables["l2"], None).to_table()
    routes = {}
    for s in tracer.spans:
        if s.name == "decode.decode":
            routes.setdefault(s.args["column"], set()).add(s.args["route"])
    assert routes["label"] == {"host"}
    assert all("device" in routes[c] for c in DENSE + SPARSE)
    with trace.collect() as tracer:
        _read(tables["l2"], False).to_table()
    assert {s.args["route"] for s in tracer.spans
            if s.name == "decode.decode"} == {"host"}


def test_page_rows_of_the_deleted_table_are_the_footers(tables):
    """The compact-deleted pages the route reads as stored hold exactly
    the rows their deletion vectors keep."""
    with BullionReader(tables["l2"]) as r:
        fv = r.footer
        rows = fv.arr(Sec.PAGE_ROWS, np.uint32)
        for name in SPARSE:
            c = fv.column_index(name)
            for g in range(fv.n_groups):
                s, e = fv.chunk_pages(g, c)
                for p, blob in r._read_pages(list(range(s, e))).items():
                    if blob_encoding_name(blob) != "fixed_bit_width":
                        continue
                    dv = fv.deletion_vector(p)
                    page = route_page(blob, int(rows[p]), np.dtype(np.int32),
                                      dv)
                    want = int(rows[p]) if dv is None \
                        else int((~dv).sum())
                    assert page is not None and page.rows == want
