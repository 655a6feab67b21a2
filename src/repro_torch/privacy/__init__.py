"""Privacy tier, ported from ``repro/privacy``: dropout-robust secure
aggregation (:mod:`repro_torch.privacy.secure_agg`).

The reference's DP-SGD and its Rényi accountant are not ported: a job with
``dp_clip`` or ``dp_noise_multiplier`` set raises
:class:`~repro_torch.NotPorted` naming ``dp``.
"""
from repro_torch.privacy.secure_agg import (FRAC_BITS, SecureAggClient,
                                            SecureAggState, masked_values)

__all__ = ["FRAC_BITS", "SecureAggClient", "SecureAggState", "masked_values"]
