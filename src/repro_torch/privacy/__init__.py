"""Privacy tier, ported from ``repro/privacy``:

  * :mod:`repro_torch.privacy.dp` -- per-site / per-example clipping and
    Gaussian noise inside the site update, its keys a pure function of
    (seed, round, site, step) through the port of JAX's threefry stream;
  * :mod:`repro_torch.privacy.accountant` -- the Renyi accountant of the
    composed (and Poisson-subsampled) Gaussian mechanism, surfaced as
    ``JobResult.privacy``;
  * :mod:`repro_torch.privacy.secure_agg` -- dropout-robust pairwise
    masking in fixed point.
"""
from repro_torch.privacy.accountant import (analytic_gaussian_epsilon, gaussian_epsilon,
                                            rdp_subsampled_gaussian)
from repro_torch.privacy.dp import (DPConfig, dp_gradients, gaussian_noise_like, round_key,
                                    site_step_key)
from repro_torch.privacy.secure_agg import (FRAC_BITS, SecureAggClient,
                                            SecureAggState, masked_values)

__all__ = [
    "DPConfig", "dp_gradients", "gaussian_noise_like", "round_key", "site_step_key",
    "gaussian_epsilon", "analytic_gaussian_epsilon", "rdp_subsampled_gaussian",
    "FRAC_BITS", "SecureAggClient", "SecureAggState", "masked_values",
]
