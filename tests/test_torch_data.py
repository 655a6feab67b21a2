"""The port's host-side generators against the reference: bit-equal.

The dose batches, the Algorithm-2 availability chain and the Eq. 1 case
weights are pure numpy in both packages; the same seed must give the
same bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FederationConfig as JFed  # noqa: E402
from repro.core.dropout import SiteAvailability as JAvail  # noqa: E402
from repro.core.session import availability_masks as j_masks  # noqa: E402
from repro.data.synthetic import DoseTaskGenerator as JGen  # noqa: E402
from repro.data.synthetic import _sphere_mask as j_sphere  # noqa: E402
from repro_torch.configs.base import FederationConfig as TFed  # noqa: E402
from repro_torch.core.dropout import SiteAvailability as TAvail  # noqa: E402
from repro_torch.core.session import availability_masks as t_masks  # noqa: E402
from repro_torch.data.synthetic import DoseTaskGenerator as TGen  # noqa: E402
from repro_torch.data.synthetic import _sphere_mask as t_sphere  # noqa: E402


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kw", [
    dict(volume=(16, 16, 16), num_oars=2, num_sites=3),
    dict(volume=(12, 16, 8), num_oars=9, num_sites=4, heterogeneity=0.5, seed=7),
    dict(volume=(16, 16, 16), num_oars=3, num_sites=3, site_pools=(1, 2, 5)),
])
def test_dose_generator_bit_equal(kw):
    jg, tg = JGen(**kw), TGen(**kw)
    for site, step in [(0, 0), (1, 3), (kw["num_sites"] - 1, 11)]:
        _equal(tg.sample(site, step, 2), jg.sample(site, step, 2))
    _equal(tg.stacked_batches(2, 2, 1), jg.stacked_batches(2, 2, 1))
    assert tg.in_channels == jg.in_channels


def test_sphere_mask_bit_equal():
    for center, r in [((4, 5, 6), 3.5), ((0.5, 7.2, 3.1), 2.0)]:
        assert np.array_equal(t_sphere((9, 10, 11), center, r),
                              j_sphere((9, 10, 11), center, r))


@pytest.mark.parametrize("s,max_drop,seed", [(3, 1, 0), (5, 3, 4), (8, 7, 11), (4, 0, 2)])
def test_site_availability_bit_equal(s, max_drop, seed):
    ja, ta = JAvail(s, max_drop, seed), TAvail(s, max_drop, seed)
    for _ in range(60):
        assert np.array_equal(ta.step(), ja.step())
    assert np.array_equal(t_masks(s, max_drop, seed, 25), j_masks(s, max_drop, seed, 25))


def test_site_availability_rejects_bad_budget():
    with pytest.raises(ValueError):
        TAvail(3, 3)


@pytest.mark.parametrize("counts", [None, (10, 30, 60)])
def test_case_weights_equal(counts):
    kw = dict(num_sites=3, site_case_counts=counts)
    assert np.array_equal(TFed(**kw).case_weights(), JFed(**kw).case_weights())
