"""SA-Net on the paper's three tasks: its own configurations.

Backbone per Figure 5.  ``SANET``: OpenKBP dose prediction, input = CT +
PTV + 9 OAR masks (11 channels), output = 3-D dose on 128^3 volumes
(Babier et al. 2021).  ``SANET_SEG``: BraTS 2021 (4 MRI modalities, 4
classes).  ``SANET_OAR``: PanSeg (one T1 MRI channel, pancreas against
background).

``CONFIG`` records the volumetric task in the registry's
:class:`ModelConfig` form, as the reference's module does (SA-Net is not
a token model: no token path reads it); ``mesh_for`` and
``precision_for`` are the reference's (16 sites, fp32).
"""
from repro_torch.configs.base import MeshConfig, ModelConfig, PrecisionConfig
from repro_torch.models.sanet import SANetConfig

CONFIG = ModelConfig(
    name="sanet-openkbp",
    arch_type="conv3d",
    num_layers=4,                # encoder levels
    d_model=24,                  # base filters
    num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=0,
    source="OpenKBP (Babier et al. 2021), SA-Net (Yuan 2021)",
)

SANET = SANetConfig(in_channels=11, out_channels=1, base_filters=24,
                    num_levels=4, task="dose")

SANET_SEG = SANetConfig(in_channels=4, out_channels=4, base_filters=24,
                        num_levels=4, task="segmentation")   # BraTS: 4 MRI mods, 4 classes

SANET_OAR = SANetConfig(in_channels=1, out_channels=2, base_filters=24,
                        num_levels=4, task="segmentation")   # PanSeg: T1 MRI, pancreas/bg

# The paper's experiments as ``api.TaskConfig`` keywords, at the configs'
# widths on 128^3 volumes, batch 1 per site.  Dose (Figs 7-9): 9 OARs, 4
# sites.
OPENKBP_TASK = dict(kind="dose", volume=(128, 128, 128), num_oars=9,
                    base_filters=SANET.base_filters,
                    num_levels=SANET.num_levels, sites=4, batch=1)

# The strategy comparison on BraTS (Figs 11/12): 4 sites.
BRATS_TASK = dict(kind="seg", volume=(128, 128, 128),
                  in_channels=SANET_SEG.in_channels,
                  num_classes=SANET_SEG.out_channels,
                  base_filters=SANET_SEG.base_filters,
                  num_levels=SANET_SEG.num_levels, sites=4, batch=1)

# Gossip under churn on PanSeg (Fig 15): its 5 institutions.
PANSEG_TASK = dict(kind="seg", volume=(128, 128, 128),
                   in_channels=SANET_OAR.in_channels,
                   num_classes=SANET_OAR.out_channels,
                   base_filters=SANET_OAR.base_filters,
                   num_levels=SANET_OAR.num_levels, sites=5, batch=1)


def reduced() -> SANetConfig:
    return SANetConfig(in_channels=3, out_channels=1, base_filters=8,
                       num_levels=2, task="dose")


def reduced_seg() -> SANetConfig:
    return SANetConfig(in_channels=2, out_channels=3, base_filters=8,
                       num_levels=2, task="segmentation")


def mesh_for(shape, multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(sites_per_pod=16, fsdp=1, multi_pod=multi_pod)


def precision_for(shape) -> PrecisionConfig:
    return PrecisionConfig()
