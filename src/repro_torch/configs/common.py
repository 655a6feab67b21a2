"""Helpers shared by the per-arch config modules, ported from
``repro/configs/common.py``."""
from __future__ import annotations

from repro_torch.configs.base import InputShape, MeshConfig, PrecisionConfig


def simple_mesh_for(sites_per_pod: int, fsdp: int):
    def mesh_for(shape: InputShape, multi_pod: bool = False) -> MeshConfig:
        if shape.kind != "train":
            # serving runs the aggregated global model: one site
            return MeshConfig(sites_per_pod=1, fsdp=16, multi_pod=multi_pod)
        return MeshConfig(sites_per_pod=sites_per_pod, fsdp=fsdp, multi_pod=multi_pod)
    return mesh_for


def simple_precision_for(train: PrecisionConfig, serve_param_dtype: str = "bfloat16"):
    def precision_for(shape: InputShape) -> PrecisionConfig:
        if shape.kind == "train":
            return train
        return PrecisionConfig(param_dtype=serve_param_dtype, compute_dtype="bfloat16",
                               opt_state_dtype="bfloat16")
    return precision_for
