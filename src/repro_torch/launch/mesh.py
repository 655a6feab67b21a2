"""The devices the sharded simulator lays its sites over, ported from
``repro/launch/mesh.py`` (``make_site_mesh``).

The reference builds a one-axis ``("site",)`` JAX mesh over the process's
devices; the port's sharded engine
(:func:`repro_torch.core.round_engine.execute_sharded`) takes the list of
devices itself, each holding one contiguous block of site rows.  Nothing
here touches a device until it is called.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def site_devices(num_devices: Optional[int] = None, device=None) -> List[torch.device]:
    """The devices of a sharded job on ``device`` (None: ``"cuda"``): every
    visible CUDA device for a card job, ``[cpu]`` for a CPU job;
    ``num_devices`` takes a prefix of them and must lie in ``[1,
    available]``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    if num_devices is not None:
        if not 1 <= num_devices <= len(devs):
            raise ValueError(f"num_devices={num_devices} outside "
                             f"[1, {len(devs)}] available devices")
        devs = devs[:num_devices]
    if not devs:
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    return devs
