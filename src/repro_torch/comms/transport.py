"""The socket wire's settings, ported from ``repro/comms/transport.py``.

Only :class:`WireConfig`, so that a job spec that names the reference's
``wire`` field builds a :class:`repro_torch.api.FederatedJob`.  The
socket transports that read it are not ported; a job whose ``wire`` is
not the default raises :class:`repro_torch.NotPorted`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class WireConfig:
    """Deployable-wire settings: auth secret, TLS, streaming threshold,
    retry and backoff, fault injection (the reference's fields and
    defaults)."""

    secret: Optional[str] = None
    tls_cert: Optional[str] = None
    tls_key: Optional[str] = None
    max_message_size: Optional[int] = None
    connect_retries: int = 4
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    flaky: Optional[str] = None

