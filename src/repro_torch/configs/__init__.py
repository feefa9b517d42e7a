"""The assigned architecture zoo: 10 configs + shape cells.

Port of ``repro.configs`` (the configs are data, copied as they are).

Every arch is selectable via ``--arch <id>`` in the launchers; ids use the
assignment's hyphenated names.
"""
from . import (
    deepseek_67b,
    h2o_danube_3_4b,
    internvl2_26b,
    llama4_scout_17b_a16e,
    mamba2_370m,
    qwen3_moe_235b_a22b,
    seamless_m4t_medium,
    stablelm_12b,
    tinyllama_1_1b,
    zamba2_2_7b,
)
from .base import SHAPES, ModelConfig, applicable_shapes  # noqa: F401

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_moe_235b_a22b, llama4_scout_17b_a16e, deepseek_67b,
        tinyllama_1_1b, stablelm_12b, h2o_danube_3_4b, seamless_m4t_medium,
        mamba2_370m, zamba2_2_7b, internvl2_26b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
