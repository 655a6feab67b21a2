"""Architecture registry: maps ``--arch <id>`` to its config module.

Each ``repro_torch/configs/<id>.py`` exports, as the reference's does:
  * ``CONFIG``      — the published :class:`ModelConfig` (source cited)
  * ``reduced()``   — a CPU-sized variant (2 layers, d_model <= 128)
  * ``mesh_for(shape, multi_pod)`` — the reference's FL site layout
    (:class:`~repro_torch.configs.base.MeshConfig`; on one card only its
    site count is read)
  * ``precision_for(shape)``       — the dtype policy
    (:class:`~repro_torch.configs.base.PrecisionConfig`)

``PORTED`` lists the token architectures (every one of the reference's);
``sanet-openkbp`` (the paper's conv backbone, whose task dicts live in
``configs/sanet_openkbp.py``) loads through :func:`get_arch` beside them,
and :func:`get_token_arch` (the token task's and serving's lookup) refuses
it with :class:`repro_torch.NotPorted`, seam ``arch``.
:func:`is_skipped` says which (architecture, shape) pairs the reference
skips, and why.
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
    """The config module of an architecture, by id or alias."""
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_token_arch(name: str):
    """:func:`get_arch` for a token model: an id outside ``PORTED``
    (sanet-openkbp) raises ``NotPorted("arch")``."""
    arch = get_arch(name)
    if arch.__name__.rsplit(".", 1)[1] not in PORTED:
        raise NotPorted("arch", f"{name} (not a token model)", ", ".join(PORTED))
    return arch


# (arch, shape) pairs the reference skips, with its reasons
LONG_500K_SKIPS = {
    "deepseek_v2_236b": "MLA compresses the KV cache but attention is full; no sub-quadratic variant",
    "qwen3_8b": "pure full attention",
    "qwen3_moe_30b_a3b": "pure full attention",
    "chameleon_34b": "pure full attention (early-fusion decoder)",
    "smollm_135m": "pure full attention",
    "granite_3_2b": "pure full attention",
    "musicgen_medium": "pure full attention",
    "sanet_openkbp": "SA-Net is a 3D conv net; sequence shapes do not apply (dose volumes only)",
}

# SA-Net is the paper's conv backbone: token-sequence shapes other than its
# own volumetric task do not apply
SHAPE_SKIPS = {
    "sanet_openkbp": {
        "prefill_32k": "conv model: no autoregressive serving",
        "decode_32k": "conv model: no autoregressive serving",
        "long_500k": "conv model: no autoregressive serving",
    },
}


def is_skipped(arch_id: str, shape_name: str):
    """The reason string if (arch, shape) is skipped, else None."""
    if shape_name == "long_500k" and arch_id in LONG_500K_SKIPS:
        return LONG_500K_SKIPS[arch_id]
    return SHAPE_SKIPS.get(arch_id, {}).get(shape_name)
