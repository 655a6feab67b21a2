"""Federation topology, ported from ``repro/core/topology.py``: one flat star,
or two tiers of pods.

Hospitals of one group aggregate at their hub (a pod), and only the hubs
cross the slow link.  :class:`Topology` names that structure once and every
layer honours it:

  * the engine (:meth:`~repro_torch.core.agg_engine.AggregationEngine.aggregate_pods`)
    reduces the ``[S, N]`` buffer into per-pod partial means, then combines
    the partials across pods (``ctx.topology`` in the strategies' hooks);
  * the socket transports build a two-tier server stack
    (:mod:`repro_torch.comms.pods`): one aggregation server a pod and a root
    that the pod leaders re-upload their partials to, with the intra-pod and
    cross-pod bytes counted apart;
  * the scheduler seam is per tier (``intra_scheduler``/``inter_scheduler``)
    on the socket transports;
  * a whole pod going offline is Algorithm-2 churn at the pod tier
    (:func:`pod_availability_masks`), composed with the site tier's chain.

``"flat"`` is the default.  With ``fedavg`` at both tiers the pods global
equals the flat Eq. 1 mean up to rounding (weighted means compose).

Host numpy only, the reference's own copy: the port imports nothing of the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

#: combine rules at either tier: ``fedavg`` = the case-weighted Eq. 1 mean,
#: ``uniform`` = the unweighted mean over the tier's members
TIER_COMBINES = ("fedavg", "uniform")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Where aggregation happens: one flat star, or two tiers of pods.

    ``assignment`` maps each site to a pod id (``None`` = contiguous,
    near-equal blocks).  ``intra``/``inter`` pick the combine rule within
    a pod and across pods.  ``intra_scheduler``/``inter_scheduler``
    override the job's scheduler per tier on the socket transports
    (``None`` = the job's); the stacked transport runs pods synchronously
    at both tiers."""

    kind: str = "flat"                      # flat | pods
    num_pods: int = 1
    assignment: Optional[Tuple[int, ...]] = None   # site index -> pod id
    intra: str = "fedavg"
    inter: str = "fedavg"
    intra_scheduler: Optional[object] = None       # str | RoundScheduler
    inter_scheduler: Optional[object] = None

    def __post_init__(self):
        if self.kind not in ("flat", "pods"):
            raise ValueError(f"unknown topology kind {self.kind!r}; "
                             "known: flat, pods")
        for tier, rule in (("intra", self.intra), ("inter", self.inter)):
            if rule not in TIER_COMBINES:
                raise ValueError(f"unknown {tier} combine {rule!r}; known: "
                                 f"{TIER_COMBINES}")
        if self.kind == "pods" and self.num_pods < 1:
            raise ValueError(f"num_pods must be >= 1, got {self.num_pods}")

    @property
    def is_pods(self) -> bool:
        return self.kind == "pods"

    @classmethod
    def pods(cls, num_pods: int, **kw) -> "Topology":
        return cls(kind="pods", num_pods=num_pods, **kw)

    def pod_of(self, num_sites: int) -> np.ndarray:
        """[S] int32 pod id a site.  Flat: every site in pod 0; an explicit
        ``assignment`` wins; else contiguous near-equal blocks
        (``S=5, P=2 -> [0, 0, 0, 1, 1]``)."""
        if not self.is_pods:
            return np.zeros(num_sites, np.int32)
        if self.assignment is not None:
            a = np.asarray(self.assignment, np.int32)
            if a.shape != (num_sites,):
                raise ValueError(f"topology assignment covers {a.shape[0]} "
                                 f"sites, federation has {num_sites}")
            if a.min() < 0 or a.max() >= self.num_pods:
                raise ValueError(f"assignment pod ids must lie in "
                                 f"[0, {self.num_pods}); got {sorted(set(a.tolist()))}")
            return a
        if self.num_pods > num_sites:
            raise ValueError(f"{self.num_pods} pods over {num_sites} sites "
                             "leaves empty pods; pass an explicit assignment")
        out = np.zeros(num_sites, np.int32)
        for p, block in enumerate(np.array_split(np.arange(num_sites), self.num_pods)):
            out[block] = p
        return out

    def members(self, num_sites: int):
        """The site indices of each pod (list index = pod id)."""
        pod = self.pod_of(num_sites)
        return [np.flatnonzero(pod == p) for p in range(self.num_pods)]

    def validate(self, num_sites: int) -> None:
        """Raise on an inconsistent topology, empty pods included."""
        for p, m in enumerate(self.members(num_sites)):
            if self.is_pods and len(m) == 0:
                raise ValueError(f"pod {p} has no sites")


FLAT = Topology()


def resolve_topology(spec: Union[str, Topology, None]) -> Topology:
    """``None``, a name or an instance -> :class:`Topology`.  Strings:
    ``"flat"`` and ``"pods:K"``."""
    if spec is None:
        return FLAT
    if isinstance(spec, Topology):
        return spec
    if spec == "flat":
        return FLAT
    if spec.startswith("pods:"):
        try:
            k = int(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad topology spec {spec!r}; want pods:<int>")
        return Topology.pods(k)
    if spec == "pods":
        raise ValueError("topology 'pods' needs a pod count: pods:<K>")
    raise KeyError(f"unknown topology {spec!r}; known: flat, pods:<K>")


def pod_availability_masks(topology: Topology, num_sites: int, pod_dropout: int,
                           seed: int, rounds: int) -> np.ndarray:
    """[rounds, S] bool masks from the Algorithm-2 chain run at the POD
    tier: a dropped pod takes all of its sites offline that round.  The
    chain draws from its own stream (``seed + 9973``), so it composes with
    the site tier's without interference."""
    from repro_torch.core.dropout import SiteAvailability
    if pod_dropout <= 0 or not topology.is_pods:
        return np.ones((rounds, num_sites), bool)
    if pod_dropout >= topology.num_pods:
        raise ValueError(f"pod_dropout {pod_dropout} must be < num_pods "
                         f"{topology.num_pods}")
    chain = SiteAvailability(topology.num_pods, pod_dropout, seed=seed + 9973)
    pod_masks = np.stack([chain.step() for _ in range(rounds)])
    return pod_masks[:, topology.pod_of(num_sites)]


def active_pod_counts(topology: Topology, masks: np.ndarray) -> np.ndarray:
    """[rounds]: pods with at least one active site, the cross-pod
    barrier's ``expected`` each round and the simulated cross-pod upload
    count."""
    pod_of = topology.pod_of(masks.shape[1])
    return np.asarray([np.unique(pod_of[m]).size for m in masks], np.int64)


def simulated_pods_comm(topology: Topology, masks: np.ndarray, nbytes: int,
                        intra_upload_bytes: Optional[int] = None,
                        intra_download_bytes: Optional[int] = None,
                        compression: str = "none",
                        down_compression: str = "none") -> dict:
    """The stacked transport's per-tier byte split for a pods run (the
    socket transports report measured bytes under the same keys):
    intra-pod = one upload and one broadcast per active site a round,
    cross-pod = one fp32 partial up and one global down per active pod a
    round.  ``intra_upload_bytes``/``intra_download_bytes`` replace the
    site totals with the codec's payload bytes (compressed runs); partials
    and uncompressed broadcasts ride dense fp32."""
    uploads = int(masks.sum())
    cross_count = int(active_pod_counts(topology, masks).sum())
    intra_up = int(intra_upload_bytes if intra_upload_bytes is not None
                   else uploads * nbytes)
    intra_down = int(intra_download_bytes if intra_download_bytes is not None
                     else uploads * nbytes)
    cross = cross_count * nbytes
    return {"upload_bytes": intra_up + cross,
            "download_bytes": intra_down + cross,
            "total_bytes": intra_up + intra_down + 2 * cross,
            "intra_pod_upload_bytes": intra_up,
            "intra_pod_download_bytes": intra_down,
            "cross_pod_upload_bytes": cross,
            "cross_pod_download_bytes": cross,
            "upload_count": uploads, "pods": topology.num_pods,
            "compression": compression,
            "down_compression": down_compression, "simulated": True}
