"""Rules of the port's package: it imports nothing of JAX, of the JAX
package or of ml_dtypes, zstandard only where its absence is handled, every
module imports without CUDA, every entry point runs on the card unless the
caller asks for the CPU, and kernels build without fast math."""

import ast
import importlib
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


def test_kernels_build_without_fast_math():
    """Flushing subnormals would let x = 0 pass ``x > 0`` (lo = 1e-45)."""
    from repro_torch.kernels._build import NVCC_FLAGS
    flags = " ".join(NVCC_FLAGS)
    assert "--use_fast_math" not in flags and "-use_fast_math" not in flags
    assert "-ftz=true" not in flags and "--ftz=true" not in flags
    assert "sm_90a" in flags
