"""SA-Net on OpenKBP-shaped dose prediction: the paper's own configuration.

Backbone per Figure 5; input = CT + PTV + 9 OAR masks (11 channels),
output = 3-D dose on 128^3 volumes (OpenKBP, Babier et al. 2021).
"""
from repro_torch.models.sanet import SANetConfig

SANET = SANetConfig(in_channels=11, out_channels=1, base_filters=24,
                    num_levels=4, task="dose")

# The paper's experiment as ``api.TaskConfig`` keywords: SANET's widths on
# 128^3 volumes with 9 OARs, 4 sites, batch 1 per site.
OPENKBP_TASK = dict(kind="dose", volume=(128, 128, 128), num_oars=9,
                    base_filters=SANET.base_filters,
                    num_levels=SANET.num_levels, sites=4, batch=1)


def reduced() -> SANetConfig:
    return SANetConfig(in_channels=3, out_channels=1, base_filters=8,
                       num_levels=2, task="dose")
