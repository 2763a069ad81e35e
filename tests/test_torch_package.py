"""Rules of the port's package: it imports nothing of JAX or of the JAX
package, every module imports without CUDA, and every entry point runs on
the card unless the caller asks for the CPU."""

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
FORBIDDEN = ("jax", "jaxlib", "repro")


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


def test_import_guard_catches_forbidden_imports():
    src = "import jax.numpy as jnp\nfrom repro.models import zoo\nimport repro_torch\n"
    found = [m for m in _imported(ast.parse(src)) if m.split(".")[0] in FORBIDDEN]
    assert found == ["jax.numpy", "repro.models"]


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
