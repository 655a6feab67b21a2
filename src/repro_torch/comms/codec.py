"""The compressed-leaf wire type, ported from ``repro/comms/codec.py``.

Only :class:`QuantizedTensor` so far; the framing and serialization come
with the socket deployment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np


@dataclasses.dataclass
class QuantizedTensor:
    """A compressed tree leaf on the wire.

    ``codec`` names the compression scheme (see
    :func:`repro_torch.comms.compression.resolve_codec`), ``shape`` is the
    logical shape the tensor dequantizes back to, and ``data`` holds the
    codec's component arrays as host numpy arrays (quantized values,
    scales).  ``meta`` carries small codec-specific scalars.
    """

    codec: str
    shape: Tuple[int, ...]
    data: Dict[str, np.ndarray]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        """Payload bytes this leaf contributes to the wire."""
        return sum(np.asarray(a).nbytes for a in self.data.values())
