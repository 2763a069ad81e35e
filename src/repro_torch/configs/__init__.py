"""Architecture registry: ``get(name)`` -> full ModelConfig,
``get_smoke(name)`` -> reduced same-family config for CPU tests.

Only the architectures whose blocks the port runs have a config module here;
the others raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them.
"""

from __future__ import annotations

from importlib import import_module

from ..models.config import SHAPES, ModelConfig, ShapeConfig

ARCHS = (
    "whisper_base", "rwkv6_7b", "llama3_2_1b", "gemma3_12b", "minicpm3_4b",
    "starcoder2_15b", "mixtral_8x22b", "deepseek_moe_16b",
    "recurrentgemma_9b", "chameleon_34b",
)

PORTED = ("llama3_2_1b", "gemma3_12b", "starcoder2_15b", "chameleon_34b",
          "deepseek_moe_16b", "mixtral_8x22b", "minicpm3_4b",
          "recurrentgemma_9b", "rwkv6_7b")
# the ROADMAP.md item that ports each of the others
_LATER = {
    "whisper_base": "enc-dec + whisper-base",
}

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({
    "whisper-base": "whisper_base", "rwkv6-7b": "rwkv6_7b",
    "llama3.2-1b": "llama3_2_1b", "gemma3-12b": "gemma3_12b",
    "minicpm3-4b": "minicpm3_4b", "starcoder2-15b": "starcoder2_15b",
    "mixtral-8x22b": "mixtral_8x22b", "deepseek-moe-16b": "deepseek_moe_16b",
    "recurrentgemma-9b": "recurrentgemma_9b", "chameleon-34b": "chameleon_34b",
})


def _module(name: str):
    key = _ALIAS.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ALIAS)}")
    if key not in PORTED:
        raise NotImplementedError(
            f"arch {key!r} is not ported yet: its blocks come with the "
            f"{_LATER[key]} item of ROADMAP.md")
    return import_module(f".{key}", __package__)


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ARCHS", "PORTED", "SHAPES", "ShapeConfig", "get", "get_smoke"]
