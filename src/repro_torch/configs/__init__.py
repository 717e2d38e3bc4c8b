"""Config registry of the LM stack: the 10 assigned architectures (exact
published specs), the port's copy of the JAX package's. ``get_config(name)``
/ ``list_archs()`` are the public API; every arch has ``.reduced()`` for
smoke tests."""
from __future__ import annotations

from .base import ArchConfig, SHAPES, Shape, dummy_inputs, input_specs
from .qwen15_05b import CONFIG as qwen15_05b
from .deepseek_7b import CONFIG as deepseek_7b
from .qwen15_4b import CONFIG as qwen15_4b
from .mistral_nemo_12b import CONFIG as mistral_nemo_12b
from .llama4_scout_17b import CONFIG as llama4_scout_17b
from .grok1_314b import CONFIG as grok1_314b
from .zamba2_7b import CONFIG as zamba2_7b
from .musicgen_large import CONFIG as musicgen_large
from .llama32_vision_11b import CONFIG as llama32_vision_11b
from .rwkv6_3b import CONFIG as rwkv6_3b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    qwen15_05b, deepseek_7b, qwen15_4b, mistral_nemo_12b, llama4_scout_17b,
    grok1_314b, zamba2_7b, musicgen_large, llama32_vision_11b, rwkv6_3b,
]}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return ARCHS[name[:-len("-reduced")]].reduced()
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


__all__ = ["ArchConfig", "SHAPES", "Shape", "ARCHS", "get_config",
           "list_archs", "input_specs", "dummy_inputs"]
