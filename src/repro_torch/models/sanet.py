"""SA-Net (Scale Attention Network), ported from ``repro/models/sanet.py``.

Faithful to the reference (paper Figure 5): a ResSE encoder, a mirrored
decoder with one ResSE block per level, a scale-attention block per
decoder level and deep-supervision heads.  Parameters are the same nested
dict/list tree as the reference; conv weights are stored OIDHW (PyTorch's
layout), SE matrices ``[in, out]`` as the reference multiplies them.
:mod:`repro_torch.convert` maps a reference tree onto this one.

The public layout stays channels-last ``[B, D, H, W, C]``, as in the
reference; :func:`sanet_apply` works channels-first inside.

Numerics: the parameters and activations are fp32 throughout, as in the
reference.  The port's runs on a card keep PyTorch's default for the
convolutions, TF32 in cuDNN (``torch.backends.cudnn.allow_tf32 = True``),
and full fp32 for matmuls.  That is what the reference does on such a
card: it calls ``lax.conv_general_dilated`` with no precision and sets no
``jax_default_matmul_precision``, so XLA takes ``lax.Precision.DEFAULT``,
which on a GPU "uses tensorfloat32 if available (e.g. on A100 and H100
GPUs)" (the docstring of ``jax.lax.Precision`` in jax 0.9.0).  The CPU
computes full fp32 convolutions, so every card-vs-CPU gate turns TF32 off;
``chip_smoke.py`` runs the full-width job both ways from the same seeded
start and records the losses' gap and each round's ``step_s`` (PERF.md
§5).  Callers that need full fp32 convolutions set the flag themselves.

Two layout traps of the translation, both handled here:

* 'SAME' padding with stride 2 pads (0, 1) for even sizes in JAX; torch's
  symmetric ``padding=1`` would shift every window, so the padding is
  computed per side and applied with ``F.pad``.
* ``jax.image.resize(..., "nearest")`` samples half-pixel centres, which
  is torch's ``nearest-exact`` (plain ``nearest`` picks other voxels).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class SANetConfig:
    in_channels: int = 11              # OpenKBP: CT + PTVs + OAR masks
    out_channels: int = 1              # dose (1) or segmentation classes
    base_filters: int = 24
    num_levels: int = 4
    se_ratio: int = 4
    task: str = "dose"                 # dose | segmentation
    deep_supervision: bool = True

    def filters(self, level: int) -> int:
        return self.base_filters * (2 ** level)


# ---------------------------------------------------------------------------
# Primitives (activations channels-first [B, C, D, H, W] inside the model)
# ---------------------------------------------------------------------------


def conv_init(gen: torch.Generator, k: Tuple[int, int, int], cin: int, cout: int):
    fan_in = cin * k[0] * k[1] * k[2]
    w = torch.empty((cout, cin) + tuple(k), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return {"w": w * (2.0 / fan_in) ** 0.5, "b": torch.zeros((cout,))}


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_apply(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """3-D conv with XLA's 'SAME' padding (low side gets the smaller half)."""
    w = p["w"]
    pads = [_same_pad(x.shape[2 + i], w.shape[2 + i], stride) for i in range(3)]
    if any(lo != hi for lo, hi in pads):
        # F.pad lists the last dim first: (W_lo, W_hi, H_lo, H_hi, D_lo, D_hi)
        x = F.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])
        padding = 0
    else:
        padding = tuple(lo for lo, _ in pads)
    return F.conv3d(x, w, p["b"], stride=stride, padding=padding)


def groupnorm_init(c: int):
    return {"scale": torch.ones((c,)), "bias": torch.zeros((c,))}


def _groups(c: int, groups: int = 8) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def groupnorm_apply(p, x: torch.Tensor, groups: int = 8,
                    eps: float = 1e-5) -> torch.Tensor:
    """Contiguous channel groups, biased variance."""
    return F.group_norm(x, _groups(x.shape[1], groups), p["scale"], p["bias"], eps)


def se_init(gen: torch.Generator, c: int, ratio: int):
    hidden = max(c // ratio, 4)
    w1 = torch.randn((c, hidden), generator=gen) * (c ** -0.5)
    w2 = torch.randn((hidden, c), generator=gen) * (hidden ** -0.5)
    return {"w1": w1, "w2": w2}


def se_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-and-excitation on [B, C, D, H, W]."""
    s = x.mean(dim=(2, 3, 4))                               # [B, C]
    s = torch.relu(s @ p["w1"]) @ p["w2"]
    return x * torch.sigmoid(s)[:, :, None, None, None]


def resse_init(gen: torch.Generator, cin: int, cout: int, ratio: int):
    p = {
        "norm1": groupnorm_init(cin),
        "conv1": conv_init(gen, (3, 3, 3), cin, cout),
        "norm2": groupnorm_init(cout),
        "conv2": conv_init(gen, (3, 3, 3), cout, cout),
        "se": se_init(gen, cout, ratio),
    }
    if cin != cout:
        p["proj"] = conv_init(gen, (1, 1, 1), cin, cout)
    return p


def resse_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Pre-activation residual block with SE (Figure 5(b))."""
    h = conv_apply(p["conv1"], torch.relu(groupnorm_apply(p["norm1"], x)))
    h = conv_apply(p["conv2"], torch.relu(groupnorm_apply(p["norm2"], h)))
    h = se_apply(p["se"], h)
    skip = conv_apply(p["proj"], x) if "proj" in p else x
    return skip + h


def resize_volume(x: torch.Tensor, target_shape: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour spatial resize of [B, C, D, H, W] (half-pixel
    centres, as ``jax.image.resize``)."""
    if tuple(x.shape[2:]) == tuple(target_shape):
        return x
    return F.interpolate(x, size=tuple(target_shape), mode="nearest-exact")


def project_resized(p, x: torch.Tensor, target_shape: Sequence[int]) -> torch.Tensor:
    """``conv_apply(p, resize_volume(x, target))`` for a 1x1x1 conv.

    A pointwise conv commutes with a nearest resize (each output voxel is
    the conv of one copied input voxel), so the conv runs at whichever
    resolution is smaller: the same values, with less memory and work when
    upsampling."""
    if x.shape[2:].numel() < torch.Size(target_shape).numel():
        return resize_volume(conv_apply(p, x), target_shape)
    return conv_apply(p, resize_volume(x, target_shape))


# ---------------------------------------------------------------------------
# Scale attention block (Figure 5(c))
# ---------------------------------------------------------------------------


def scale_attn_init(gen: torch.Generator, cfg: SANetConfig, level: int):
    c = cfg.filters(level)
    proj = [conv_init(gen, (1, 1, 1), cfg.filters(i), c)
            for i in range(cfg.num_levels)]
    return {"proj": proj,
            "se": se_init(gen, c * cfg.num_levels, cfg.se_ratio)}


def scale_attn_apply(p, enc_feats, cfg: SANetConfig, level: int) -> torch.Tensor:
    """Fuse all encoder scales into one map at ``level`` resolution."""
    target = enc_feats[level].shape[2:]
    c = cfg.filters(level)
    maps = [project_resized(p["proj"][i], f, target)
            for i, f in enumerate(enc_feats)]                # each [B, C, *]
    summed = sum(maps)
    # squeeze: GAP of the sum, then SE producing per-(scale, channel) logits
    s = summed.mean(dim=(2, 3, 4))                          # [B, C]
    s_all = s.repeat(1, cfg.num_levels)                     # [B, L*C]
    e = torch.relu(s_all @ p["se"]["w1"]) @ p["se"]["w2"]   # [B, L*C]
    logits = e.reshape(s.shape[0], cfg.num_levels, c)
    weights = torch.softmax(logits, dim=1)                  # over scales
    return sum(weights[:, i][:, :, None, None, None] * maps[i]
               for i in range(cfg.num_levels))


# ---------------------------------------------------------------------------
# Full network
# ---------------------------------------------------------------------------


def sanet_init(gen: torch.Generator, cfg: SANetConfig):
    """fp32 parameters drawn on the CPU from ``gen`` (move them where
    they run), so one seed gives the same weights on every device.  The draws
    follow the reference's initializers, not its random stream."""
    p = {"stem": conv_init(gen, (3, 3, 3), cfg.in_channels, cfg.filters(0))}
    p["enc"] = []
    for lvl in range(cfg.num_levels):
        c = cfg.filters(lvl)
        blocks = {"b1": resse_init(gen, c, c, cfg.se_ratio),
                  "b2": resse_init(gen, c, c, cfg.se_ratio)}
        if lvl < cfg.num_levels - 1:
            blocks["down"] = conv_init(gen, (3, 3, 3), c, cfg.filters(lvl + 1))
        p["enc"].append(blocks)
    p["scale_attn"] = [scale_attn_init(gen, cfg, lvl)
                       for lvl in range(cfg.num_levels - 1)]
    p["dec"] = []
    p["ds_heads"] = []
    for lvl in range(cfg.num_levels - 2, -1, -1):
        cin, cout = cfg.filters(lvl + 1), cfg.filters(lvl)
        p["dec"].append({
            "up": conv_init(gen, (1, 1, 1), cin, cout),
            "block": resse_init(gen, cout, cout, cfg.se_ratio),
        })
        p["ds_heads"].append(conv_init(gen, (1, 1, 1), cout, cfg.out_channels))
    return p


def sanet_apply(params, x: torch.Tensor, cfg: SANetConfig):
    """x: [B, D, H, W, in_channels] -> (output, deep-supervision list).

    ``output`` is [B, D, H, W, out_channels]; deep-supervision outputs are
    produced at every decoder level and resized to full resolution.
    """
    full = x.shape[1:4]
    h = conv_apply(params["stem"], x.permute(0, 4, 1, 2, 3))
    enc_feats = []
    for lvl in range(cfg.num_levels):
        b = params["enc"][lvl]
        h = resse_apply(b["b2"], resse_apply(b["b1"], h))
        enc_feats.append(h)
        if lvl < cfg.num_levels - 1:
            h = conv_apply(b["down"], h, stride=2)
    ds_outs = []
    d = enc_feats[-1]
    for i, lvl in enumerate(range(cfg.num_levels - 2, -1, -1)):
        target = enc_feats[lvl].shape[2:]
        up = project_resized(params["dec"][i]["up"], d, target)
        fused = up + scale_attn_apply(params["scale_attn"][lvl], enc_feats, cfg, lvl)
        d = resse_apply(params["dec"][i]["block"], fused)
        ds = project_resized(params["ds_heads"][i], d, full)
        ds_outs.append(ds.permute(0, 2, 3, 4, 1))
    return ds_outs[-1], ds_outs


# ---------------------------------------------------------------------------
# Task losses (paper §III)
# ---------------------------------------------------------------------------


def dose_loss(params, batch, cfg: SANetConfig, ds_weight: float = 0.5):
    """Voxel-wise MAE with deep supervision (dose prediction, §III.A.3).

    ``batch["mask"]`` restricts the loss to the patient volume.
    """
    pred, ds_outs = sanet_apply(params, batch["volume"], cfg)
    mask = batch.get("mask")

    def mae(p):
        err = torch.abs(p - batch["dose"])
        if mask is not None:
            return torch.sum(err * mask) / (torch.sum(mask) + 1e-6)
        return torch.mean(err)

    loss = mae(pred)
    if cfg.deep_supervision and len(ds_outs) > 1:
        aux = sum(mae(o) for o in ds_outs[:-1]) / max(len(ds_outs) - 1, 1)
        loss = loss + ds_weight * aux
    return loss, {"mae": loss}


def _soft_jaccard(probs, onehot, eps=1e-6):
    inter = torch.sum(probs * onehot, dim=(1, 2, 3))
    union = torch.sum(probs + onehot, dim=(1, 2, 3)) - inter
    return 1.0 - (inter + eps) / (union + eps)              # [B, C]


def segmentation_loss(params, batch, cfg: SANetConfig, focal_gamma: float = 2.0,
                      use_focal: bool = False, ds_weight: float = 0.5):
    """Jaccard distance + (focal or plain) CE (paper §III.B.3 / §III.C.3)."""
    pred, ds_outs = sanet_apply(params, batch["volume"], cfg)
    labels = batch["labels"].long()                         # [B, D, H, W]
    onehot = F.one_hot(labels, cfg.out_channels).to(pred.dtype)

    def term(logits):
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
        if use_focal:
            pt = torch.exp(-ce)
            ce = ce * (1.0 - pt) ** focal_gamma
        probs = torch.softmax(logits, dim=-1)
        return torch.mean(ce) + torch.mean(_soft_jaccard(probs, onehot))

    loss = term(pred)
    if cfg.deep_supervision and len(ds_outs) > 1:
        loss = loss + ds_weight * sum(term(o) for o in ds_outs[:-1]) / max(len(ds_outs) - 1, 1)
    return loss, {"seg_loss": loss}
