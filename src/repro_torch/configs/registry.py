"""Architecture registry: maps ``--arch <id>`` to its config module.

Each ported ``repro_torch/configs/<id>.py`` exports ``CONFIG`` (the
published :class:`ModelConfig`, source cited) and ``reduced()`` (a
CPU-sized variant: 2 layers, d_model <= 128): every token architecture
of the reference.  ``sanet-openkbp`` (the paper's conv backbone, not a
token model: its task dicts live in ``configs/sanet_openkbp.py``)
raises :class:`repro_torch.NotPorted` here.  The reference's
``mesh_for`` (a TPU-mesh layout) and ``precision_for`` (its serving
dtype policy, ``configs/common.py``) are not ported.
"""
from __future__ import annotations

import importlib

from repro_torch import NotPorted

# every architecture of the reference, and the ones this package has
ARCH_IDS = (
    "deepseek_v2_236b", "rwkv6_7b", "jamba_1p5_large_398b", "qwen3_8b",
    "qwen3_moe_30b_a3b", "chameleon_34b", "gemma3_1b", "smollm_135m",
    "granite_3_2b", "musicgen_medium", "sanet_openkbp",
)
PORTED = ("chameleon_34b", "deepseek_v2_236b", "gemma3_1b", "granite_3_2b",
          "jamba_1p5_large_398b", "musicgen_medium", "qwen3_8b", "qwen3_moe_30b_a3b",
          "rwkv6_7b", "smollm_135m")

# user-facing aliases (the assignment spelling)
ALIASES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "qwen3-8b": "qwen3_8b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "chameleon-34b": "chameleon_34b",
    "gemma3-1b": "gemma3_1b",
    "smollm-135m": "smollm_135m",
    "granite-3-2b": "granite_3_2b",
    "musicgen-medium": "musicgen_medium",
    "sanet-openkbp": "sanet_openkbp",
}


def get_arch(name: str):
    """The config module of a token architecture, by id or alias."""
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    if mod_name not in PORTED:
        raise NotPorted("arch", name, ", ".join(PORTED))
    return importlib.import_module(f"repro_torch.configs.{mod_name}")
