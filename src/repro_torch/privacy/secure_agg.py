"""Additive-mask secure aggregation in fixed-point integer arithmetic,
ported from ``repro/privacy/secure_agg.py``.

Bonawitz-style pairwise masking over the ``Peer`` wire: every scheduled
site ``i`` encodes its weighted upload in fixed point,

    y_i = round(w_i · x_i · 2^F)            (int64, F = 32 frac bits)

and adds, for every *other* scheduled participant ``j`` of the round, a
pairwise mask stream ``m_ij`` (from a shared per-pair seed and the round
index) with antisymmetric sign:

    u_i = y_i + Σ_{j>i} m_ij − Σ_{j<i} m_ij      (mod 2^64)

The server folds the ``u_i`` words at weight 1, an exact wraparound sum, so
every mask cancels pairwise and the total is ``Σ w_i x_i · 2^F`` exactly;
dividing by ``2^F · Σ w_i`` (the weights ride the public metadata) gives
the FedAvg global to fixed-point precision (about 2⁻³² relative).  When
the barrier closes with scheduled sites missing, the server regenerates,
for each missing site ``d``, the net mask the folded sites applied against
it and subtracts it (seed escrow at the aggregation point in place of
Shamir shares; see the reference's module for the trust boundary).

The wire is shared with the reference, so everything that decides a word
is the reference's, on the host: the masks are numpy Philox streams keyed
by a sha256 over the unordered pair and the absolute round index, the
fixed point is numpy's ``round`` in float64.  A site encodes its upload in
the wire's layout on the host; the server moves the masked words to its
device in one copy and folds them there as ``int64`` additions (two's
complement wraps as the reference's ``uint64`` sum does);
:meth:`SecureAggState.unmask` repairs missing sites with host streams and
decodes in float64 on the device, bit-equal to the reference's numpy
decode of the same words.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.comms.codec import MaskedTensor, payload_span
from repro_torch.tree import tree_leaves, tree_unflatten

#: Fixed-point fractional bits (the reference's).
FRAC_BITS = 32

_SCHEME = "pairwise-v1"


def _pair_rng(secret: str, tier: str, a: int, b: int,
              round_index: int) -> np.random.Generator:
    """The (a, b) pair's per-round mask stream, derived from the shared
    job secret: a 128-bit Philox key from a hash over the unordered pair
    and the absolute round index, so no stream is reused."""
    lo, hi = (a, b) if a <= b else (b, a)
    h = hashlib.sha256(
        f"{_SCHEME}|{secret}|{tier}|{lo}|{hi}|{round_index}".encode()).digest()
    return np.random.Generator(np.random.Philox(key=int.from_bytes(h[:16], "little")))


def _pair_stream(secret: str, tier: str, a: int, b: int, round_index: int,
                 n: int) -> np.ndarray:
    """``n`` uniform uint64 mask words for the pair (order-insensitive)."""
    return _pair_rng(secret, tier, a, b, round_index).integers(
        0, 2 ** 64 - 1, size=n, dtype=np.uint64, endpoint=True)


def _net_mask(secret: str, tier: str, me: int, others: Iterable[int],
              round_index: int, n: int) -> np.ndarray:
    """The total mask site ``me`` adds: +m(me,j) for j > me, −m for j < me."""
    total = np.zeros(n, np.uint64)
    for j in others:
        j = int(j)
        if j == me:
            continue
        s = _pair_stream(secret, tier, me, j, round_index, n)
        if me < j:
            total += s
        else:
            total -= s
    return total


def _fixed_point(x: np.ndarray, weight: float) -> np.ndarray:
    """``round(w · x · 2^F)`` as a flat uint64 word array (two's complement:
    negatives wrap, the modular sum is still exact)."""
    y = np.round(np.asarray(x, np.float64).reshape(-1) * (weight * float(2 ** FRAC_BITS)))
    return y.astype(np.int64).astype(np.uint64)


class SecureAggClient:
    """Client-side masker for one participant at one tier."""

    def __init__(self, secret: str, tier: str, my_id: int):
        self.secret = str(secret)
        self.tier = str(tier)
        self.my_id = int(my_id)

    def encode(self, tree: Any, weight: float, participants: Sequence[int],
               round_index: int) -> Tuple[Any, Dict[str, Any]]:
        """Masked fixed-point encoding of ``weight · tree`` (host numpy
        leaves, the wire's layout) against the round's scheduled
        ``participants`` (which include ``my_id``).  Returns (tree of
        :class:`MaskedTensor`, upload meta)."""
        leaves = tree_leaves(tree)
        words = [_fixed_point(x, weight) for x in leaves]
        mask = _net_mask(self.secret, self.tier, self.my_id, participants,
                         int(round_index), sum(w.size for w in words))
        out, off = [], 0
        for x, w in zip(leaves, words):
            w += mask[off:off + w.size]
            off += w.size
            out.append(MaskedTensor(shape=tuple(np.shape(x)),
                                    data={"v": w.view(np.int64).reshape(np.shape(x))}))
        meta = {"masked": True, "scheme": _SCHEME, "tier": self.tier,
                "weight": float(weight), "mask_round": int(round_index),
                "frac_bits": FRAC_BITS}
        return tree_unflatten(tree, out), meta


def masked_values(tree: Any, *, device) -> Any:
    """A decoded ``__masked__`` upload as a tree of int64 word tensors on
    ``device``: views of ONE buffer, moved there in one copy.  What the
    integer :class:`~repro_torch.core.agg_engine.StreamingAccumulator`
    fold consumes (the reference's uint64 words, read as int64)."""
    from repro_torch.comms.compression import _as_device
    from repro_torch.core.agg_engine import tree_layout, unravel
    leaves = tree_leaves(tree)
    arrays = []
    for mt in leaves:
        if not isinstance(mt, MaskedTensor):
            raise ValueError(f"a {type(mt).__name__} leaf in a masked upload")
        v = np.asarray(mt.data["v"])
        if v.dtype.itemsize != 8 or v.dtype.kind not in "iu" or v.shape != tuple(mt.shape):
            raise ValueError(f"malformed masked leaf: {v.dtype} {v.shape} for {mt.shape}")
        arrays.append(v)
    span, offsets = payload_span(arrays)
    buf = _as_device(span, torch.device(device))
    packed = list(np.cumsum([0] + [a.nbytes for a in arrays[:-1]]))
    if offsets == packed and span.nbytes == sum(a.nbytes for a in arrays):
        flat = buf.view(torch.int64)
    else:
        flat = torch.cat([buf[o: o + a.nbytes].clone().view(torch.int64)
                          for o, a in zip(offsets, arrays)])
    return unravel(flat, tree_layout(tree))


@dataclasses.dataclass
class SecureAggState:
    """Server-side unmasking state for one aggregation point.

    ``participant_masks`` is the [rounds, N] bool schedule of this tier's
    participants: the same schedule the clients mask against, so the
    scheduled-but-missing ids are exactly the pairs whose masks failed to
    cancel."""

    secret: str
    tier: str
    participant_masks: np.ndarray

    def __post_init__(self):
        self.participant_masks = np.asarray(self.participant_masks, bool)
        self.recovered: List[Tuple[int, int]] = []   # (round, missing id)

    def scheduled(self, round_index: int) -> Set[int]:
        return set(np.flatnonzero(self.participant_masks[int(round_index)]).tolist())

    def unmask(self, int_tree: Any, round_index: int, folded: Set[int],
               weight_total: float) -> Any:
        """The fp32 weighted mean from the integer fold (a tree of int64
        tensors): the net masks of scheduled-but-missing ids subtracted
        (host streams, one copy to the fold's device), then the fixed point
        decoded at ``weight_total`` in float64, as the reference does.
        Returns fp32 views of one buffer on the fold's device."""
        from repro_torch.core.agg_engine import ravel_words, tree_layout, unravel
        layout = tree_layout(int_tree)
        flat = ravel_words(int_tree)
        n = layout.n
        folded = {int(i) for i in folded}
        missing = sorted(self.scheduled(round_index) - folded)
        if missing:
            resid = np.zeros(n, np.uint64)
            for d in missing:
                for i in sorted(folded):
                    s = _pair_stream(self.secret, self.tier, i, d, int(round_index), n)
                    if i < d:
                        resid += s
                    else:
                        resid -= s
                self.recovered.append((int(round_index), d))
            flat = flat - torch.from_numpy(resid.view(np.int64)).to(flat.device)
        if weight_total <= 0:
            raise ValueError("secure-agg finalize with zero folded weight")
        inv = 1.0 / (float(2 ** FRAC_BITS) * float(weight_total))
        return unravel((flat.double() * inv).float(), layout)
