"""Rules of the port's package: it imports nothing of JAX, of the JAX
package or of ml_dtypes, zstandard only where its absence is handled, every
module imports without CUDA, every entry point runs on the card unless the
caller asks for the CPU, and kernels build without fast math."""

import ast
import importlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(("repro_torch",) + f.relative_to(PORT).with_suffix("").parts)
    .removesuffix(".__init__") for f in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")
OPTIONAL = ("zstandard",)     # may be absent on the card's machine


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _unguarded(tree):
    """Imports of OPTIONAL modules outside a ``try`` that catches
    ImportError."""
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                h.type is None or "ImportError" in ast.dump(h.type)
                for h in node.handlers):
            for stmt in node.body:
                guarded.update(id(n) for n in ast.walk(stmt))
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        if any(n.split(".")[0] in OPTIONAL for n in names) \
                and id(node) not in guarded:
            yield names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_imports_only_inside_try(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = list(_unguarded(tree))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} outside a try"


def test_optional_import_guard():
    src = ("try:\n    import zstandard as zstd\nexcept ImportError:\n"
           "    zstd = None\n\ndef f():\n    import zstandard\n")
    assert list(_unguarded(ast.parse(src))) == [["zstandard"]]


def test_import_guard_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.models import zoo\n"
           "import repro_torch\nimport ml_dtypes\n")
    found = [m for m in _imported(ast.parse(src)) if m.split(".")[0] in FORBIDDEN]
    assert found == ["jax.numpy", "repro.models", "ml_dtypes"]


@pytest.mark.parametrize("name", MODULES)
def test_every_module_imports_without_cuda(name):
    importlib.import_module(name)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")


def _smoke_cfg():
    import repro_torch.configs as configs
    return configs.get_smoke("llama3.2-1b")


def test_resolve_device_defaults_to_cuda():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()


def test_build_and_model_default_to_cuda():
    from repro_torch.models.zoo import Model, build
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        build(_smoke_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(_smoke_cfg())


def test_serve_engine_defaults_to_cuda():
    from repro_torch.models.zoo import build
    from repro_torch.serve import ServeEngine
    model = build(_smoke_cfg(), device="cpu")
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, max_seq=16)


def test_flash_attention_defaults_to_cuda():
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.tensor(np.zeros((1, 2, 8, 16), np.float32))
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention(q, q, q)


def test_dataset_defaults_to_cuda(tmp_path):
    from repro_torch.core import BullionReader
    from repro_torch.data import write_lm_corpus
    from repro_torch.dataset import Dataset, dataset
    path = str(tmp_path / "lm.bln")
    write_lm_corpus(path, n_docs=8, doc_len=16, rows_per_group=4)
    dataset(path, device="cpu").close()
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        dataset(path)
    with BullionReader(path) as r:
        with pytest.raises(RuntimeError, match="CUDA"):
            Dataset.from_reader(r)
        with pytest.raises(RuntimeError, match="CUDA"):
            r.read_column("quality")


def test_range_mask_defaults_to_cuda():
    from repro_torch.kernels.filter import range_mask
    cols = torch.tensor(np.zeros((2, 8), np.float32))
    bound = torch.zeros(2)
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        range_mask(cols, bound, bound)


def test_dequant_and_bitunpack_default_to_cuda():
    from repro_torch.kernels.bitunpack import bitunpack
    from repro_torch.kernels.dequant import dequant
    q = torch.zeros((4, 2), dtype=torch.int8)
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        dequant(q, torch.ones(2), torch.zeros(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        bitunpack(np.zeros((1, 3), np.uint32), 3)


def test_kernels_build_without_fast_math():
    """Flushing subnormals would let x = 0 pass ``x > 0`` (lo = 1e-45) in
    the filter, and would flush subnormal bf16 patterns in dequant. The
    bit transpose of bitunpack and dequant's column-list body are built
    with the same flags, and ask for no fast math themselves."""
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, SOURCES
    flags = " ".join(NVCC_FLAGS)
    assert "--use_fast_math" not in flags and "-use_fast_math" not in flags
    assert "-ftz=true" not in flags and "--ftz=true" not in flags
    assert "sm_90a" in flags
    assert {"bitunpack", "dequant"} <= set(SOURCES)
    bitunpack = _code((CSRC / "bitunpack.cu").read_text())
    dequant = _code((CSRC / "dequant.cu").read_text())
    assert "__shfl_xor_sync" in bitunpack and "bitunpack_kernel" in bitunpack
    assert "dequant_columns_kernel" in dequant
    for code in (bitunpack, dequant):
        assert "fast_math" not in code and "ftz" not in code
        assert "#pragma nv_" not in code and "__launch_bounds__" in code


def _code(src: str) -> str:
    """A CUDA source without its comments."""
    import re
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)


def test_every_source_is_built():
    """``load_all`` builds every csrc/*.cu with the flags above, and no
    source asks for fast math or flushing itself."""
    from repro_torch.kernels._build import CSRC, SOURCES
    assert sorted(SOURCES) == sorted(p.stem for p in CSRC.glob("*.cu"))
    assert {"dequant", "bitunpack"} <= set(SOURCES)
    for name in SOURCES:
        code = _code((CSRC / f"{name}.cu").read_text())
        assert "fast_math" not in code and "ftz" not in code, name


def test_f32_flash_body_is_fma_only():
    """The f32 body (``flash_fwd_simt``, its copy helper, and the sliced
    kernel past D = 256) multiplies in f32 FMA: no tensor-core instruction
    (``mma``, ``wgmma``) and no TF32, so an f32 call stays within f32
    rounding of the reference. Its copies are cp.async."""
    from repro_torch.kernels._build import CSRC
    code = _code((CSRC / "flash_attention.cu").read_text())
    simt = [_function(code, name) for name in
            ("flash_fwd_simt", "copy_tile", "flash_fwd_simt_sliced")]
    for text in simt:
        low = text.lower()
        assert "mma" not in low and "tf32" not in low, text[:80]
        assert "fmaf(" in text or "cp_async" in text, text[:80]
    assert "cp_async16(" in simt[1] and "cp_async4(" in simt[1]
    assert "cp_async_wait<" in simt[0] and "__launch_bounds__" in code


def test_dequant_affine_route_cannot_be_contracted():
    """An FMA would change the float64 sum ``q * scale + zero`` of some
    codes by one ulp, and the read path must give NumPy's bits: the
    multiply and the add are round-to-nearest intrinsics, which nvcc never
    contracts (or the build passes -fmad=false)."""
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS
    code = _code((CSRC / "dequant.cu").read_text())
    if "-fmad=false" in NVCC_FLAGS:
        return
    for fn in ("__dmul_rn", "__dadd_rn", "__fmul_rn", "__fadd_rn",
               "__double2float_rn"):
        assert fn + "(" in code, fn
    assert "fma" not in code.lower()
    affine = code[code.index("affine("):code.index("template")]
    assert "*" not in affine and "+" not in affine, affine


def _function(code: str, name: str) -> str:
    """The body of a CUDA function: from its name to the next function."""
    start = code.index(name + "(")
    return code[start:code.index("\n}\n", start)]


def test_dequant_bodies_share_the_arithmetic():
    """The [R, C] body and the column-list body compute a code's value in
    one helper (``value``, which calls ``affine``), so they cannot drift
    apart: neither multiplies or adds codes itself."""
    from repro_torch.kernels._build import CSRC
    code = _code((CSRC / "dequant.cu").read_text())
    for body in ("dequant_kernel", "column_tile"):
        text = _function(code, body)
        assert "value(" in text, body
        assert "__dmul" not in text and "__dadd" not in text, body
    assert "affine(" in _function(code, "float value")


def test_packer_matches_the_kernel_source():
    """``staging.py`` mirrors ``ColumnDesc`` field for field, and the tile
    size the kernel assumes (``kTileBytes``)."""
    import re
    from repro_torch.kernels._build import CSRC
    from repro_torch.kernels.dequant.staging import DESC_DTYPE, TILE_BYTES
    code = _code((CSRC / "dequant.cu").read_text())
    struct = code[code.index("struct ColumnDesc {"):code.index("};",
                  code.index("struct ColumnDesc {"))]
    fields = re.findall(r"(\w+)(?:\[\d+\])?[,;]", struct)
    assert fields == list(DESC_DTYPE.names)
    consts = dict(re.findall(r"constexpr \w+(?: \w+)? (k\w+) = ([^;]+);",
                             code))
    assert consts["kTileBytes"] == "16LL * kThreads * kVecs"
    assert TILE_BYTES == 16 * int(consts["kThreads"]) * int(consts["kVecs"])


def test_dequant_columns_defaults_to_cuda():
    from repro_torch.kernels.dequant import dequant_columns
    codes = [np.zeros(4, np.int8)]
    assert len(dequant_columns(codes, [(1.0, 0.0)], device="cpu")) == 1
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        dequant_columns(codes, [(1.0, 0.0)])


SLICE_MODULES = ("obs/export.py", "obs/expose.py", "core/deletion.py",
                 "dataset/sink.py", "core/multimodal.py", "data/loader.py",
                 "models/encdec.py", "configs/whisper_base.py",
                 "serve/wire.py", "serve/client.py", "serve/server.py",
                 "cli.py", "testing/__init__.py", "testing/chaos.py",
                 "testing/objstore.py", "distributed/__init__.py",
                 "distributed/sharding.py", "distributed/collectives.py",
                 "distributed/placement.py",
                 "launch/mesh.py", "train/elastic.py")


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_import_guard_covers_the_slice_modules(rel):
    """The compliance, sink, export, loader, enc-dec, dataset-service, CLI,
    fault-injection and distributed modules are the port's own copies: the
    guard above reads them, and they import no reference."""
    path = PORT / rel
    assert path in FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("rel", ["dataset/core.py", "obs/trace.py",
                                 "obs/export.py", "models/zoo.py",
                                 "models/transformer.py", "serve/lm.py",
                                 "configs/__init__.py", "models/encdec.py",
                                 "serve/server.py", "cli.py"])
def test_no_stub_is_left(rel):
    """``Dataset.profile``/``write_to``/``delete_where``, the
    ``BULLION_TRACE`` export, the encoder-decoder (``frames`` in the model
    and the engine, whisper-base's config), the dataset service and
    sharded serving (``prefill``/``decode_step`` under a mesh, in
    ``models/zoo.py``) are implemented: nothing raises NotImplementedError
    there, and nothing cites the "Launch analysis" item of ROADMAP.md."""
    src = (PORT / rel).read_text()
    tree = ast.parse(src)
    raised = [ast.dump(n.exc) for n in ast.walk(tree)
              if isinstance(n, ast.Raise) and n.exc is not None]
    assert not [r for r in raised if "NotImplementedError" in r]
    assert "Launch analysis" not in src


@pytest.mark.parametrize("rel", ["models/moe.py", "models/rwkv6.py",
                                 "train/checkpoint.py"])
def test_no_distributed_stub_is_left(rel):
    """The sharded MoE path, sharded RWKV and ``restore(shardings=)`` are
    ported: nothing there raises NotImplementedError (the "Distributed"
    item of ROADMAP.md cited such raises until it was ported)."""
    src = (PORT / rel).read_text()
    tree = ast.parse(src)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Raise)
                and n.exc is not None
                and "NotImplementedError" in ast.dump(n.exc)]
    assert "'Distributed' item" not in src


def _public(path: Path) -> dict[str, set]:
    """Top-level public functions and classes of a module, each class with
    its public methods."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out[node.name] = {m.name for m in getattr(node, "body", [])
                              if isinstance(m, ast.FunctionDef)
                              and not m.name.startswith("_")} \
                if isinstance(node, ast.ClassDef) else set()
    return out


# names of the reference the port does without, and why
NOT_PORTED = {
    # Pallas kernels: their Hopper counterparts are csrc/*.cu, bound in
    # each kernel.py (flash_attention_fwd, range_mask_fwd, ...)
    "kernels/flash_attention/kernel.py": {"flash_attention_pallas"},
    "kernels/filter/kernel.py": {"range_mask_pallas"},
    "kernels/dequant/kernel.py": {"dequant_pallas"},
    "kernels/bitunpack/kernel.py": {"bitunpack_pallas"},
    # layers are a list of modules, not a stacked declaration
    "models/transformer.py": {"stack_decl"},
    # the port's Model initialises its parameters when it is built
    "models/zoo.py": {"Model.init"},
    # the HLO-text parser: the port counts the ops that run (a dispatch
    # mode), not the text of a compiled program
    "launch/hlo_cost.py": {"parse_module", "Op", "Computation"},
}


def test_public_names_match_the_reference():
    """Every public function, class and method of a reference module with
    a counterpart in the port exists there (``NOT_PORTED`` aside): among
    them the distributed names ``ShardingRules``, ``abstract_tree``,
    ``spec_tree``, ``constrain``, ``moe_specs``, ``Model.abstract_params``
    and ``Model.param_specs``."""
    ref_root = ROOT / "src" / "repro"
    missing = []
    for ref in sorted(ref_root.rglob("*.py")):
        rel = ref.relative_to(ref_root).as_posix()
        if not (PORT / rel).exists():
            continue
        want, got = _public(ref), _public(PORT / rel)
        names = set(want) - set(got)
        names |= {f"{c}.{m}" for c in want.keys() & got.keys()
                  for m in want[c] - got[c]}
        missing += [f"{rel}:{n}" for n in sorted(names - NOT_PORTED.get(rel,
                                                                        set()))]
    assert not missing
    base, zoo = _public(PORT / "models/base.py"), _public(PORT / "models/zoo.py")
    assert {"ShardingRules", "abstract_tree", "spec_tree",
            "constrain"} <= set(base)
    assert "moe_specs" in _public(PORT / "models/moe.py")
    assert {"abstract_params", "param_specs"} <= zoo["Model"]


def test_slice_entry_points_default_to_cuda(tmp_path):
    """``delete_where``, ``verify_deleted``, ``write_to``, ``BullionLoader``
    and ``quality_filtered_read`` run on the card unless given "cpu"."""
    from repro_torch.core import (Compliance, MultimodalSample, delete_where,
                                  quality_filtered_read, verify_deleted,
                                  write_multimodal_dataset)
    from repro_torch.data import BullionLoader, write_lm_corpus
    from repro_torch.dataset import dataset
    from repro_torch.scan import C
    path = str(tmp_path / "lm.bln")
    write_lm_corpus(path, n_docs=8, doc_len=16, rows_per_group=4)
    meta, media = str(tmp_path / "m.bln"), str(tmp_path / "m.media")
    write_multimodal_dataset(meta, media, [MultimodalSample(
        b"t", 0.5, np.zeros(2, np.float32), b"f", 1)])
    pred = C("quality") >= 0.5
    # the "cpu" route of each
    assert delete_where(path, C("doc_id") == 3, Compliance.LEVEL1,
                        device="cpu").rows_deleted == 1
    assert verify_deleted(path, "doc_id", [3], device="cpu") == \
        {"visible_rows": 0, "raw_occurrences": 1}
    with dataset(path, device="cpu") as ds:
        assert ds.where(pred).write_to(str(tmp_path / "out")).rows > 0
    BullionLoader(path, batch_size=1, seq_len=4, predicate=pred,
                  device="cpu").close()
    assert quality_filtered_read(meta, ["quality"], 1.0, device="cpu")[0]
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        delete_where(path, pred)
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_deleted(path, "doc_id", [3])
    with pytest.raises(RuntimeError, match="CUDA"):
        dataset(path).write_to(str(tmp_path / "out2"))
    with pytest.raises(RuntimeError, match="CUDA"):
        BullionLoader(path, batch_size=1, seq_len=4, predicate=pred)
    with pytest.raises(RuntimeError, match="CUDA"):
        quality_filtered_read(meta, ["quality"], 1.0)
    assert not os.path.exists(tmp_path / "out2")


def test_encdec_and_dataset_server_default_to_cuda(tmp_path):
    """whisper-base's ``Model``, and ``DatasetServer``, run on the card
    unless given "cpu"; the CLI and the chaos tools take no device."""
    import inspect
    import repro_torch.configs as configs
    from repro_torch import cli
    from repro_torch.models.zoo import build
    from repro_torch.serve import DatasetServer
    from repro_torch.testing import chaos
    cfg = configs.get_smoke("whisper_base")
    build(cfg, device="cpu")
    DatasetServer({}, device="cpu").close()
    assert "device" not in inspect.signature(cli.main).parameters
    assert "device" not in inspect.signature(chaos).parameters
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DatasetServer({})


def test_chaos_patches_the_port_backend_module():
    """``testing/chaos.py`` installs itself through the port's backend
    registry and clears the port's footer cache (ast: its imports are
    relative, to ``core.backend`` and ``dataset.source``)."""
    tree = ast.parse((PORT / "testing" / "chaos.py").read_text())
    rel = {(n.level, n.module) for n in ast.walk(tree)
           if isinstance(n, ast.ImportFrom) and n.level}
    assert {(2, "core"), (2, "core.backend"), (2, "dataset.source")} <= rel


def test_training_entry_points_default_to_cuda(tmp_path):
    """``make_train_step``, ``CheckpointManager.restore``'s target and the
    launcher run on the card unless given "cpu"."""
    from repro_torch.launch.train import main
    from repro_torch.models.zoo import build
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.checkpoint import CheckpointManager
    model = build(_smoke_cfg(), device="cpu")
    opt = adamw_init(model)
    make_train_step(model, AdamWConfig(), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, (model, opt))
    mgr.restore((model, opt), device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        make_train_step(model, AdamWConfig(), device="meta")
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, AdamWConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore((model, opt))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke", "--steps", "1", "--data", str(tmp_path / "d"),
              "--ckpt", str(tmp_path / "ck2")])
    assert not os.path.exists(tmp_path / "d")
