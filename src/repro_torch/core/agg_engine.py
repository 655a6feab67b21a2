"""Eq. 1 on one contiguous ``[S, N]`` buffer, ported from ``repro/core/agg_engine.py``.

Any parameter tree is raveled into a contiguous ``[S, N]`` fp32 buffer
(the ravel layout is cached per structure/shape/dtype key) and reduced
over the site axis by :func:`repro_torch.kernels.ops.fedagg`: the
hand-written kernel for CUDA tensors, its plain version for CPU tensors.
Unlike the reference, nothing pads ``N``: the kernel masks its ragged
tail.

The round loop keeps every site's weights as the rows of such a
buffer, so :meth:`AggregationEngine.aggregate_round` reduces it in place
with no concatenate copy and broadcasts by writing the active rows.

Robust rules replace Eq. 1 on the same buffer: ``trimmed:f`` and
``median`` through :func:`repro_torch.kernels.ops.trimmed_mean` (the
kernel on CUDA), ``krum:f`` and ``normclip:c`` in plain PyTorch, as the
reference leaves them to XLA.

The socket server's side is here too: :class:`StreamingAccumulator` (the
O(N) running Eq. 1 sum, on the server's device, and secure aggregation's
modular int64 fold), the upload sanitation checks and
:func:`robust_combine_trees` (the rank rules over a round's uploads,
stacked into ``[k, N]``).

Under a pods topology the same buffer reduces in two tiers
(:meth:`AggregationEngine.reduce_pods_flat`): the per-pod partial means
are one ``[P, S] x [S, N]`` product (plain PyTorch in fp32, as the
reference leaves it to XLA), and the cross-pod combine is ``fedagg`` on
the ``[P, N]`` partials.  A rank rule runs once a pod, on that pod's
active members (:meth:`AggregationEngine.reduce_pods_robust`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.stacking import broadcast_to_sites, where_site
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_EPS = 1e-12


def normalized_weights(case_weights: torch.Tensor, active,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """m_i/m over the active subset (fp32, ``+1e-12``); zero for inactive
    sites.  ``scale`` is an optional per-site factor multiplied in before
    the normalization."""
    w = case_weights.float() * torch.as_tensor(active, device=case_weights.device).float()
    if scale is not None:
        w = w * torch.as_tensor(scale, device=case_weights.device).float()
    return w / (torch.sum(w) + _EPS)


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """Parsed site->global combine rule (the robust-aggregation seam).

    ``fedavg`` is Eq. 1 exactly; the rest tolerate up to ``f`` adversarial
    rows.  Rank-based rules (trimmed/median/krum) are order statistics over
    the site axis: they are UNWEIGHTED over the active rows (a 100x-weighted
    adversary would defeat the trim) and need the individual site rows."""
    name: str = "fedavg"       # fedavg | trimmed | median | krum | normclip
    f: int = 0                 # adversary budget (trimmed, krum)
    c: float = 0.0             # clip norm (normclip)

    @property
    def robust(self) -> bool:
        return self.name != "fedavg"

    @property
    def rank_based(self) -> bool:
        return self.name in ("trimmed", "median", "krum")

    @property
    def spec(self) -> str:
        """Canonical string form (round-trips through parse_aggregator)."""
        if self.name in ("trimmed", "krum"):
            return f"{self.name}:{self.f}"
        if self.name == "normclip":
            return f"normclip:{self.c:g}"
        return self.name


FEDAVG_SPEC = AggregatorSpec()


def parse_aggregator(spec) -> AggregatorSpec:
    """``fedavg | trimmed:f | median | krum:f | normclip:c`` -> spec.

    ``trimmed:0`` trims nothing, so it parses to the fedavg spec and the job
    runs the case-weighted Eq. 1 path.  Accepts a parsed spec (idempotent)
    and ``None`` (fedavg)."""
    if isinstance(spec, AggregatorSpec):
        return spec
    if spec is None:
        return FEDAVG_SPEC
    text = str(spec).strip()
    name, _, arg = text.partition(":")
    name = name.strip()
    if name in ("fedavg", "median"):
        if arg:
            raise ValueError(f"{name} takes no argument, got {text!r}")
        return FEDAVG_SPEC if name == "fedavg" else AggregatorSpec("median")
    if name in ("trimmed", "krum"):
        if not arg:
            raise ValueError(f"{name} needs an adversary budget: {name}:f")
        f = int(arg)
        if f < 0:
            raise ValueError(f"{name}:f needs f >= 0, got {text!r}")
        if f == 0 and name == "trimmed":
            return FEDAVG_SPEC
        return AggregatorSpec(name, f=f)
    if name == "normclip":
        if not arg:
            raise ValueError("normclip needs a clip norm: normclip:c")
        c = float(arg)
        if not c > 0:
            raise ValueError(f"normclip:c needs c > 0, got {text!r}")
        return AggregatorSpec("normclip", c=c)
    raise ValueError(f"unknown aggregator {text!r} (expected fedavg | "
                     "trimmed:f | median | krum:f | normclip:c)")


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full fp32 whatever the global TF32 setting (the job
    turns TF32 on for convolutions): with TF32 the products keep about
    three digits, which can change Krum's pick or a pod's partial."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return a @ b
    finally:
        torch.set_float32_matmul_precision(prev)


def _gram_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x @ x.T`` in full fp32 (Krum's distances)."""
    return _matmul_fp32(x, x.T)


def krum_index(flat: torch.Tensor, active, f: int) -> torch.Tensor:
    """The row Krum (Blanchard et al. 2017) picks over the active rows of
    [S, N], as a 0-d index tensor.

    Each active row scores the sum of its ``m = max(k - f - 2, 1)`` smallest
    squared distances to OTHER active rows (``k`` active).  Invalid pairs
    (self, inactive partner) enter at a large finite sentinel so every row's
    order stays total, while inactive rows score +inf: the argmin (the first
    minimum) lands on an active row even at ``k = 1``."""
    x = flat.float()
    act = torch.as_tensor(active, device=x.device).float() > 0.5
    s = x.shape[0]
    k = act.sum(dtype=torch.int32)
    sq = torch.sum(x * x, dim=1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * _gram_fp32(x), 0.0)
    pair_ok = act[:, None] & act[None, :] & ~torch.eye(s, dtype=torch.bool, device=x.device)
    ds = torch.sort(torch.where(pair_ok, d2, torch.full_like(d2, 1e30)), dim=1).values
    m = torch.minimum(torch.clamp_min(k - f - 2, 1), torch.clamp_min(k - 1, 1))
    r = torch.arange(s, device=x.device)[None, :]
    score = torch.sum(torch.where(r < m, ds, torch.zeros_like(ds)), dim=1)
    score = torch.where(act, score, torch.full_like(score, float("inf")))
    return torch.argmin(score)


def krum_select(flat: torch.Tensor, active, f: int) -> torch.Tensor:
    """A copy of the row of [S, N] that :func:`krum_index` picks, verbatim
    (fp32): a global row that outlives the round (FedProx's anchor) must
    not alias the buffer the next round trains in."""
    return flat.float()[krum_index(flat, active, f)].clone()


def clip_factors(flat: torch.Tensor, c: float) -> torch.Tensor:
    """[S]: each row's ``normclip:c`` factor ``min(1, c / max(||row||, 1e-12))``."""
    norms = torch.linalg.vector_norm(flat.float(), dim=1)      # no [S, N] temporary
    return torch.clamp(c / torch.clamp_min(norms, _EPS), max=1.0)


def clip_rows(flat: torch.Tensor, c: float) -> torch.Tensor:
    """Row-wise L2 clip (a copy): each site's [N] row scaled by its
    :func:`clip_factors` factor.  The ``normclip:c`` rule bounds any single
    upload's pull on the mean without discarding it."""
    return flat.float() * clip_factors(flat, c)[:, None]


def per_site_nbytes(params_stacked) -> int:
    """Wire bytes of one site's uncompressed model (per-leaf dtypes)."""
    return sum(int(np.prod(x.shape[1:], dtype=np.int64)) * x.element_size()
               for x in tree_leaves(params_stacked))


@dataclasses.dataclass(frozen=True)
class RavelLayout:
    """How a site-stacked tree maps into one contiguous [S, N] buffer.

    The buffer's dtype (:attr:`buffer_dtype`) is the leaves' one dtype
    where they share one (fp32, or bf16 for a tree of the ``mixed``
    policy's parameters), else fp32: a tree of bf16 leaves beside a few
    fp32 ones (the MoE router, Mamba's ``log_a``) keeps every value in
    an fp32 buffer, the bf16 leaves' values rounded to bf16 wherever the
    reference rounds them (:meth:`round_`)."""
    treedef: Any                           # the tree's structure (any leaves)
    shapes: Tuple[Tuple[int, ...], ...]    # per-leaf shapes WITHOUT the site axis
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    n: int                                 # total flat param count

    @functools.cached_property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(sh, dtype=np.int64)) for sh in self.shapes)

    @functools.cached_property
    def buffer_dtype(self) -> torch.dtype:
        return self.dtypes[0] if len(set(self.dtypes)) == 1 else torch.float32

    @functools.cached_property
    def narrow_runs(self) -> Tuple[Tuple[int, int, torch.dtype], ...]:
        """``(start, end, dtype)`` of the runs of adjacent leaves narrower
        than the buffer (none where the leaves share one dtype)."""
        runs = []
        for ofs, size, dt in zip(self.offsets, self.sizes, self.dtypes):
            if dt == self.buffer_dtype:
                continue
            if runs and runs[-1][1] == ofs and runs[-1][2] == dt:
                runs[-1] = (runs[-1][0], ofs + size, dt)
            else:
                runs.append((ofs, ofs + size, dt))
        return tuple(runs)

    def round_(self, flat: torch.Tensor) -> torch.Tensor:
        """Round the narrower leaves' values of ``flat`` ([N] or [S, N]) to
        their own dtype, in place, as the reference's cast to each leaf's
        dtype rounds them."""
        for start, end, dt in self.narrow_runs:
            seg = flat[..., start:end]
            seg.copy_(seg.to(dt))
        return flat

    def views(self, flat_row: torch.Tensor):
        """Per-leaf views (no copy) of one [N] row, in flatten order."""
        return [t.view(sh) for t, sh in zip(torch.split(flat_row[: self.n], self.sizes),
                                             self.shapes)]

    def trainable(self, flat_row: torch.Tensor):
        """``(tree, leaves)``: one [N] row as a parameter tree whose leaves
        are detached views that require grad (differentiate a loss of the
        tree with respect to ``leaves``); a leaf narrower than the buffer
        is a copy in its own dtype."""
        leaves = [v.detach().to(dt).requires_grad_()
                  for v, dt in zip(self.views(flat_row), self.dtypes)]
        return tree_unflatten(self.treedef, leaves), leaves

    def flat_grad(self, leaves, grads) -> torch.Tensor:
        """The gradients of ``leaves`` as one [N] row in the buffer's dtype
        (zeros where a leaf got none)."""
        return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          .to(self.buffer_dtype) for p, g in zip(leaves, grads)])


def tree_layout(tree) -> RavelLayout:
    """The fp32 ravel layout of ONE unstacked tree, in flatten order; a
    :class:`~repro_torch.comms.codec.QuantizedTensor` leaf counts at its
    logical shape.  Cached by structure and shapes."""
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(x.shape) for x in leaves)
    skeleton = tree_map(lambda _: None, tree)
    key = (repr(skeleton), shapes)
    layout = _TREE_LAYOUTS.get(key)
    if layout is None:
        sizes = [int(np.prod(sh, dtype=np.int64)) for sh in shapes]
        offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
        layout = RavelLayout(skeleton, shapes, (torch.float32,) * len(shapes), offsets,
                             sum(sizes))
        _TREE_LAYOUTS[key] = layout
    return layout


_TREE_LAYOUTS: Dict[Any, RavelLayout] = {}


def ravel(tree) -> torch.Tensor:
    """ONE unstacked tree of fp32 tensors -> its flat [N] buffer.  Leaves
    that are consecutive views of one buffer (every tree the port's
    decoders and accumulators hand out) give that buffer back without a
    copy; any other tree is concatenated (cast to fp32)."""
    if isinstance(tree, torch.Tensor) and tree.dim() == 1:
        return tree
    leaves = tree_leaves(tree)
    flat = _one_buffer(leaves, torch.float32)
    if flat is not None:
        return flat
    return torch.cat([torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
                      .reshape(-1).float() for x in leaves])


def _one_buffer(leaves, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The flat buffer that ``leaves`` are consecutive ``dtype`` views of,
    or None."""
    first = leaves[0]
    if not all(isinstance(x, torch.Tensor) for x in leaves):
        return None
    offset, base = first.storage_offset(), first.untyped_storage().data_ptr()
    for x in leaves:
        if (x.dtype != dtype or not x.is_contiguous() or x.device != first.device
                or x.untyped_storage().data_ptr() != base or x.storage_offset() != offset):
            return None
        offset += x.numel()
    return first.as_strided((offset - first.storage_offset(),), (1,))


def ravel_words(tree) -> torch.Tensor:
    """ONE tree of int64 tensors (masked fixed-point words) -> its flat [N]
    buffer: the leaves' own buffer where they are consecutive views of one,
    else a concatenation (never a cast)."""
    if isinstance(tree, torch.Tensor) and tree.dim() == 1:
        return tree
    leaves = tree_leaves(tree)
    if any(x.dtype != torch.int64 for x in leaves):
        raise TypeError("masked words are int64 tensors, got "
                        f"{sorted({str(x.dtype) for x in leaves})}")
    flat = _one_buffer(leaves, torch.int64)
    return flat if flat is not None else torch.cat([x.reshape(-1) for x in leaves])


def unravel(flat: torch.Tensor, layout: RavelLayout):
    """[N] buffer -> a tree of views of it (no copy), shaped by ``layout``."""
    return tree_unflatten(layout.treedef, layout.views(flat))


class AggregationEngine:
    """Eq. 1 for every consumer: the FedAvg strategy and ``global_model``."""

    def __init__(self):
        self._layouts: Dict[Any, RavelLayout] = {}

    def reduce_flat(self, flat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """One weighted reduction over the site axis: [S, N] x [S] -> [N]."""
        return ops.fedagg(flat, weights.float().contiguous())

    def reduce_robust_flat(self, flat: torch.Tensor, active,
                           spec: AggregatorSpec) -> torch.Tensor:
        """Rank-based combine over the active rows of [S, N] -> [N]:
        trimmed and median launch the trimmed-mean kernel (its plain
        version on the CPU); krum is an [S, S] distance program with a row
        gather, plain PyTorch on every device."""
        act = torch.as_tensor(active, device=flat.device).float()
        if spec.name == "trimmed":
            return ops.trimmed_mean(flat, act, spec.f)
        if spec.name == "median":
            return ops.masked_median(flat, act)
        if spec.name == "krum":
            return krum_select(flat, act, spec.f)
        raise ValueError(f"not a rank-based rule: {spec.name}")

    # -- ravel layout (cached per structure/shapes/dtypes) ------------------

    def layout_of(self, params_stacked) -> RavelLayout:
        leaves = tree_leaves(params_stacked)
        skeleton = tree_map(lambda _: None, params_stacked)
        key = (repr(skeleton), tuple(tuple(x.shape) for x in leaves),
               tuple(x.dtype for x in leaves))
        layout = self._layouts.get(key)
        if layout is None:
            shapes = tuple(tuple(x.shape[1:]) for x in leaves)
            sizes = [int(np.prod(sh, dtype=np.int64)) for sh in shapes]
            offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
            layout = RavelLayout(skeleton, shapes, tuple(x.dtype for x in leaves),
                                 offsets, sum(sizes))
            self._layouts[key] = layout
        return layout

    def flatten(self, params_stacked) -> Tuple[torch.Tensor, RavelLayout]:
        """Ravel a site-stacked tree into one [S, N] buffer of the layout's
        ``buffer_dtype`` (fp32 for every tree but one of bf16 leaves)."""
        layout = self.layout_of(params_stacked)
        leaves = tree_leaves(params_stacked)
        s = leaves[0].shape[0]
        flat = torch.cat([x.reshape(s, -1).to(layout.buffer_dtype) for x in leaves], dim=1)
        return flat, layout

    def unflatten(self, flat_global: torch.Tensor, layout: RavelLayout):
        """[N] buffer -> unstacked tree, restoring per-leaf dtypes."""
        leaves = [v.to(dt) for v, dt in zip(layout.views(flat_global), layout.dtypes)]
        return tree_unflatten(layout.treedef, leaves)

    # -- Eq. 1 entry points -------------------------------------------------

    def global_mean(self, params_stacked, weights: torch.Tensor):
        """sum_s weights_s * params_s (weights already normalized) -> tree."""
        flat, layout = self.flatten(params_stacked)
        return self.unflatten(self.reduce_flat(flat, weights), layout)

    def aggregate(self, params_stacked, case_weights: torch.Tensor,
                  active=None, scale: Optional[torch.Tensor] = None,
                  aggregator: Optional[AggregatorSpec] = None):
        """Eq. 1 (or a robust combine) on a stacked tree.  Returns (new
        stacked params, global params): the global model broadcast to
        active sites; inactive sites keep their local weights (the
        "disconnect" scenario).  Rank rules replace the weighted mean
        (unweighted over the active rows, ``scale`` ignored); ``normclip``
        row-clips before the weighted fold."""
        s = tree_leaves(params_stacked)[0].shape[0]
        if active is None:
            active = np.ones((s,), bool)
        spec = aggregator or FEDAVG_SPEC
        flat, layout = self.flatten(params_stacked)
        if spec.rank_based:
            gflat = self.reduce_robust_flat(flat, active, spec)
        else:
            if spec.name == "normclip":
                flat = clip_rows(flat, spec.c)
            gflat = self.reduce_flat(flat, normalized_weights(case_weights, active, scale))
        global_params = self.unflatten(gflat, layout)
        mask = torch.as_tensor(np.asarray(active, bool))
        return (where_site(mask, broadcast_to_sites(global_params, s), params_stacked),
                global_params)

    def aggregate_flat(self, flat: torch.Tensor, case_weights: torch.Tensor,
                       active, scale: Optional[torch.Tensor] = None,
                       aggregator: Optional[AggregatorSpec] = None) -> torch.Tensor:
        """:meth:`aggregate` on the [S, N] buffer itself, in place: the
        active rows are overwritten with the global row, which is returned.
        ``normclip`` never clips the buffer (inactive rows keep their
        unclipped weights): it folds each row's clip factor into its
        weight, which differs from folding clipped rows by rounding only."""
        active = np.asarray(active, bool)
        spec = aggregator or FEDAVG_SPEC
        if spec.rank_based:
            gflat = self.reduce_robust_flat(flat, active, spec)
        else:
            w = normalized_weights(case_weights, active, scale)
            if spec.name == "normclip":
                w = w * clip_factors(flat, spec.c)
            gflat = self.reduce_flat(flat, w)
        for i in np.flatnonzero(active):
            flat[i].copy_(gflat)
        return gflat

    def reduce_pods_flat(self, flat: torch.Tensor, case_weights: torch.Tensor, active,
                         pod_ids, num_pods: int, intra: str = "fedavg",
                         inter: str = "fedavg",
                         scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Two-tier Eq. 1 on [S, N] -> [N]: the rows reduce by pod id into
        per-pod partial means (a one-hot [P, S] x [S, N] product in fp32,
        TF32 off, for any assignment), then the partials combine across
        pods through :meth:`reduce_flat` (``fedagg`` on [P, N]).

        ``intra``/``inter`` pick each tier's rule: ``fedavg`` weights by
        case count, ``uniform`` weights the tier's active members equally.
        ``scale`` (client sampling's ``1/pi``) multiplies each member's
        weight, so the pod totals carry the scaled mass up.  A pod without
        an active member has a zero partial at weight 0."""
        dev = flat.device
        act = torch.as_tensor(np.asarray(active, bool), device=dev).float()
        w = act if intra == "uniform" else case_weights.float() * act
        if scale is not None:
            w = w * torch.as_tensor(scale, device=dev).float()
        pods = torch.as_tensor(np.asarray(pod_ids), device=dev)
        onehot = (pods[None, :] == torch.arange(num_pods, device=dev)[:, None]).float()
        wp = onehot * w[None, :]                                # [P, S]
        pod_tot = torch.sum(wp, dim=1)                          # [P]
        pod_mean = _matmul_fp32(wp / (pod_tot[:, None] + _EPS), flat.float())
        pod_w = (pod_tot > 0).float() if inter == "uniform" else pod_tot
        return self.reduce_flat(pod_mean, pod_w / (torch.sum(pod_w) + _EPS))

    def reduce_pods_robust(self, flat: torch.Tensor, active, pod_ids, num_pods: int,
                           spec: AggregatorSpec, inter: str = "fedavg") -> torch.Tensor:
        """A rank rule at the intra-pod tier: each pod combines its own
        active members' rows (one ``trimmed_mean`` launch a pod for trimmed
        and median, Krum's pick for krum; a pod of k members trims at most
        ``(k - 1) // 2``), then the partials combine weighted by active
        member count (``inter="uniform"``: active pods equally).  A pod with
        no active member gives a zero row at weight 0."""
        act = np.asarray(active, bool)
        pods = np.asarray(pod_ids)
        members = [(pods == p) & act for p in range(num_pods)]
        pod_mean = torch.stack([self.reduce_robust_flat(flat, m, spec) for m in members])
        cnt = torch.tensor([float(m.sum()) for m in members], device=flat.device)
        pod_w = (cnt > 0).float() if inter == "uniform" else cnt
        return self.reduce_flat(pod_mean, pod_w / (torch.sum(pod_w) + _EPS))

    def _pods_global(self, flat, case_weights, active, pod_ids, num_pods, intra, inter,
                     scale, spec: AggregatorSpec) -> torch.Tensor:
        if spec.rank_based:
            return self.reduce_pods_robust(flat, active, pod_ids, num_pods, spec, inter)
        if spec.name == "normclip":
            flat = clip_rows(flat, spec.c)
        return self.reduce_pods_flat(flat, case_weights, active, pod_ids, num_pods,
                                     intra, inter, scale=scale)

    def aggregate_pods(self, params_stacked, case_weights: torch.Tensor, pod_ids,
                       num_pods: int, active=None, intra: str = "fedavg",
                       inter: str = "fedavg", scale: Optional[torch.Tensor] = None,
                       aggregator: Optional[AggregatorSpec] = None):
        """Two-tier Eq. 1 (or a rank rule at the intra tier; ``normclip``
        clips rows before the weighted tiers) on a stacked tree.  Returns
        (new stacked params, global params) with the active sites holding
        the global."""
        s = tree_leaves(params_stacked)[0].shape[0]
        if active is None:
            active = np.ones((s,), bool)
        flat, layout = self.flatten(params_stacked)
        gflat = self._pods_global(flat, case_weights, active, pod_ids, num_pods, intra,
                                  inter, scale, aggregator or FEDAVG_SPEC)
        global_params = self.unflatten(gflat, layout)
        mask = torch.as_tensor(np.asarray(active, bool))
        return (where_site(mask, broadcast_to_sites(global_params, s), params_stacked),
                global_params)

    def aggregate_hierarchical(self, params_stacked, case_weights: torch.Tensor,
                               sites_per_pod: int, active=None):
        """:meth:`aggregate_pods` with contiguous pods of ``sites_per_pod``
        sites (pod p owns sites ``[p * sites_per_pod, (p + 1) * sites_per_pod)``)."""
        s = tree_leaves(params_stacked)[0].shape[0]
        if sites_per_pod <= 0 or s % sites_per_pod:
            raise ValueError(f"sites_per_pod={sites_per_pod} does not "
                             f"divide {s} sites; pass an explicit "
                             "assignment via aggregate_pods instead")
        return self.aggregate_pods(params_stacked, case_weights,
                                   np.arange(s) // sites_per_pod, s // sites_per_pod, active)

    def aggregate_round(self, flat: torch.Tensor, round_inputs, ctx):
        """Strategy ``post_exchange`` entry on the round loop's [S, N]
        buffer, flat or two-tier as ``ctx.topology`` says; returns (the
        buffer, updated in place, and the global row)."""
        topo = ctx.topology
        if not topo.is_pods:
            gflat = self.aggregate_flat(flat, ctx.case_weights, round_inputs["active"],
                                        round_inputs.get("weight_scale"), ctx.aggregator)
            return flat, gflat
        active = np.asarray(round_inputs["active"], bool)
        gflat = self._pods_global(flat, ctx.case_weights, active,
                                  topo.pod_of(flat.shape[0]), topo.num_pods, topo.intra,
                                  topo.inter, round_inputs.get("weight_scale"),
                                  ctx.aggregator)
        for i in np.flatnonzero(active):
            flat[i].copy_(gflat)
        return flat, gflat


_DEFAULT_ENGINE: Optional[AggregationEngine] = None


def get_engine() -> AggregationEngine:
    """Process-wide default engine (shared ravel-layout cache)."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = AggregationEngine()
    return _DEFAULT_ENGINE


# ---------------------------------------------------------------------------
# The socket server's fold and upload sanitation, on the server's device
# ---------------------------------------------------------------------------


class StreamingAccumulator:
    """O(N)-memory running Eq. 1 sum for the aggregation server.

    ``fold`` adds one site's upload, scaled by its weight, into one fp32
    buffer on the upload's device as it arrives: the server holds one model
    however many sites report.  An upload whose flat buffer the caller owns
    (``owned=True``, every decoded upload) is scaled in place.  A lock
    guards the fold, so handler threads may fold concurrently.  The sums
    follow the reference's numpy fold: ``x * fp32(w)`` rounded, then added,
    and ``finalize`` multiplies by ``fp32(1 / total weight)``.

    A masked (secure-aggregation) round folds trees of int64 words instead:
    at weight 1 only, as exact ``int64`` additions whose two's-complement
    wrap gives the reference's modular ``uint64`` sum bit for bit; it
    finalizes through :meth:`finalize_int` and
    :meth:`~repro_torch.privacy.secure_agg.SecureAggState.unmask`."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._layout: Optional[RavelLayout] = None
        self._acc: Optional[torch.Tensor] = None
        self._weight_total = 0.0
        self.count = 0

    def fold(self, tree, weight: float, owned: bool = False) -> None:
        w = float(np.float32(weight))
        layout = tree_layout(tree)
        if tree_leaves(tree)[0].dtype == torch.int64:
            # any float scaling would destroy the masks' cancellation: the
            # site weights ride the upload meta and divide out at unmask
            if w != 1.0:
                raise ValueError(f"integer (masked) uploads fold at weight 1.0, got {w}")
            x = ravel_words(tree)
        else:
            x = ravel(tree)
            x = x.mul_(w) if owned and x.dtype == torch.float32 else x.float() * w
        with self._lock:
            if self._acc is None:
                self._layout, self._acc = layout, x if owned else x.clone()
            else:
                if layout.shapes != self._layout.shapes or x.dtype != self._acc.dtype:
                    raise ValueError("upload tree structure changed mid-round")
                self._acc.add_(x)
            self._weight_total += float(weight)
            self.count += 1

    @property
    def nbytes(self) -> int:
        """Resident accumulator bytes (the O(N) mid-round state)."""
        return self._acc.numel() * self._acc.element_size() if self._acc is not None else 0

    @property
    def weight_total(self) -> float:
        """The folded weight so far (a pod's partial carries it up)."""
        return self._weight_total

    @property
    def is_integer(self) -> bool:
        """True when the buffered round is a masked (fixed-point) one."""
        return self._acc is not None and self._acc.dtype == torch.int64

    def finalize(self):
        """Normalize by the folded weight total and return the global tree
        (fp32 views of one buffer); resets the accumulator."""
        with self._lock:
            if self._acc is None:
                return None
            if self.is_integer:
                raise ValueError("masked integer rounds finalize via "
                                 "finalize_int() + SecureAggState.unmask()")
            acc = self._acc.mul_(float(np.float32(1.0 / self._weight_total)))
            tree = unravel(acc, self._layout)
            self._layout, self._acc = None, None
            self._weight_total, self.count = 0.0, 0
        return tree

    def finalize_int(self):
        """The raw modular sum of a masked round, unnormalized (int64 views
        of one buffer); resets the accumulator."""
        with self._lock:
            if self._acc is None:
                return None
            tree = unravel(self._acc, self._layout)
            self._layout, self._acc = None, None
            self._weight_total, self.count = 0.0, 0
        return tree


def tree_all_finite(tree) -> bool:
    """True iff every leaf is NaN/Inf-free (one device reduction)."""
    return bool(torch.isfinite(ravel(tree)).all())


def tree_l2_norm(tree) -> float:
    """Global L2 norm of an upload, accumulated in float64 so that huge
    adversarial values do not overflow the check meant to catch them."""
    return float(torch.linalg.vector_norm(ravel(tree).double()))


def clip_tree_norm(tree, c: float):
    """Scale one upload by ``min(1, c / ||tree||)`` before it folds
    (``normclip`` stays a streaming fold)."""
    norm = tree_l2_norm(tree)
    if norm <= c:
        return tree
    flat = ravel(tree) * float(np.float32(c / max(norm, _EPS)))
    return unravel(flat, tree_layout(tree))


def robust_combine_trees(trees, spec: AggregatorSpec):
    """The rank rules over the round's uploads at the server: the rows are
    stacked into one ``[k, N]`` device buffer and combined by the port's
    rules, unweighted over all k rows (``trimmed_mean``/median launch the
    kernel on CUDA; Krum picks one upload verbatim)."""
    if not trees:
        return None
    layout = tree_layout(trees[0])
    if any(tree_layout(t).shapes != layout.shapes for t in trees[1:]):
        raise ValueError("upload tree structure changed mid-round")
    stacked = torch.stack([ravel(t) for t in trees])
    active = torch.ones(len(trees), device=stacked.device)
    if spec.name == "krum":
        return trees[int(krum_index(stacked, active, spec.f))]
    return unravel(get_engine().reduce_robust_flat(stacked, np.ones(len(trees), bool), spec),
                   layout)
