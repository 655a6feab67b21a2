"""One ``FederatedJob`` API, ported from ``repro/api.py``.

A declarative job object that owns task construction, strategy, the
Algorithm-2 dropout schedule and metrics, and executes rounds through a
transport:

    job = FederatedJob(task=TaskConfig(kind="dose", sites=4), rounds=12)
    result = job.run()                  # on CUDA
    result = job.replace(device="cpu").run()

Ported so far: the SA-Net dose and segmentation tasks; on the stacked
transport, sync rounds of the paper's strategy set: ``fedavg`` (Eq. 1),
``fedprox`` (Eq. 2), the ``individual`` and ``pooled`` baselines and
``gcml`` (gossip pairs and regional DCML, Eq. 3), FedAvg and FedProx
uncompressed or with int8 uploads and/or downloads
(``compression="int8"``, ``down_compression="int8"``); the socket deployment
(``transport="thread" | "tcp"``: one site a thread or a process, real TCP
round trips to an :class:`~repro_torch.comms.coordinator.AggregationServer`
on the job's device, ``strategy="fedavg" | "individual"``, sync rounds,
int8 both ways, the wire's auth/TLS/streaming/faults, leases,
``round_deadline_s``, ``max_upload_norm`` and ``run(resume=True)`` from a
``checkpoint_dir``); the Byzantine-robust combine rules
(``aggregator="trimmed:f" | "median" | "krum:f" | "normclip:c"``), the
seeded adversary (``adversary="sign_flip:f" | "scale:c:f" |
"label_flip:f"``) and client sampling (``sample="uniform:K" |
"poisson:q"``).  Every other seam of the reference raises
:class:`repro_torch.NotPorted` naming it, and never runs something else;
compositions the reference refuses raise its ``ValueError``, checked
first, as the reference checks them.  Every field of the reference's
``FederatedJob`` and ``TaskConfig`` exists here with its default, so a
reference job spec builds this job; a field of an unported seam set to
anything but its default raises ``NotPorted`` at ``run()``.

``device`` picks where the job runs: ``None`` means ``"cuda"``, which
raises when CUDA is absent.  Nothing falls back to the CPU: pass
``device="cpu"`` to run there.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import NotPorted
from repro_torch.comms.compression import (KEEP_GLOBALS_DEFAULT, Codec, UploadCompressor,
                                           WirePlan, align_for, codec_name,
                                           decode_download, resolve_codec)
from repro_torch.comms.transport import WireConfig
from repro_torch.configs.base import FederationConfig
from repro_torch.core import federation as F
from repro_torch.core.adversary import AdversaryPlan, parse_adversary
from repro_torch.core.agg_engine import (AggregatorSpec, StreamingAccumulator,
                                         parse_aggregator, ravel, unravel)
from repro_torch.core.sampling import (ClientSampler, compose_participation,
                                       resolve_sampler)
from repro_torch.core.session import (JobResult, RoundRecorder, SyncScheduler,
                                      availability_masks, resolve_scheduler,
                                      scheduler_name)
from repro_torch.optim import adamw
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# Task construction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TaskConfig:
    """What the federation trains on.  ``kind`` in {tokens, dose, seg};
    the port runs ``dose`` and ``seg``."""

    kind: str = "tokens"
    sites: int = 4
    batch: int = 4                      # per-site batch per local step
    heterogeneity: float = 0.0          # non-IID knob (0 = IID)
    seed: int = 0                       # data seed (independent of job seed)
    # -- tokens (not ported: the defaults only) ------------------------------
    arch: str = "smollm-135m"
    reduced: bool = True
    seq: int = 64
    # -- volumetric (dose / seg) -------------------------------------------
    volume: Tuple[int, int, int] = (16, 16, 16)
    num_oars: int = 2                   # dose: OAR channels
    in_channels: int = 2                # seg: input channels
    num_classes: int = 3                # seg: label classes
    base_filters: int = 8
    num_levels: int = 2
    site_pools: Optional[Tuple[int, ...]] = None   # per-site distinct cases

    def model_config(self):
        """The SA-Net config this task trains."""
        from repro_torch.models.sanet import SANetConfig
        if self.kind == "dose":
            return SANetConfig(in_channels=2 + self.num_oars, out_channels=1,
                               base_filters=self.base_filters,
                               num_levels=self.num_levels, task="dose")
        if self.kind == "seg":
            return SANetConfig(in_channels=self.in_channels,
                               out_channels=self.num_classes,
                               base_filters=self.base_filters,
                               num_levels=self.num_levels, task="segmentation")
        if self.kind == "tokens":
            raise NotPorted("task", f"kind={self.kind!r}", "kind='dose' or 'seg'")
        raise ValueError(f"unknown task kind {self.kind!r}")

    def build(self) -> "TaskBundle":
        self.model_config()             # raises for kinds the port does not run
        return _build_volume_task(self)


@dataclass
class TaskBundle:
    """Built task: loss/forward/init fns + host batch samplers over the
    generator."""

    task: TaskConfig
    loss_fn: Callable                                     # (params, batch) -> (loss, metrics)
    init_fn: Callable[[int], Any]                         # seed -> CPU params
    model_cfg: Any
    stacked: Callable[[int, int], Dict[str, np.ndarray]]  # (round, K) -> [S,K,B,…]
    sample: Callable[[int, int], Dict[str, np.ndarray]]   # (site, step) -> [B,…]
    forward_fn: Callable                                  # -> (loss, logits, labels), one forward

    def logits_fn(self, params, batch):
        """(logits, labels) for DCML's regions, from :attr:`forward_fn`."""
        return self.forward_fn(params, batch)[1:]

    @staticmethod
    def pooled_view(b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Concatenate the site axis into one site's batch
        ([S, K, B, …] -> [1, K, S·B, …]): the paper's Pooled upper
        baseline."""
        return {k: np.reshape(np.swapaxes(x, 0, 1), (1, x.shape[1], -1) + x.shape[3:])
                for k, x in b.items()}

    def round_batches(self, round_index: int, local_steps: int,
                      pooled: bool = False) -> Dict[str, np.ndarray]:
        """[S, K, B, …] host batches for one round (K = local steps); with
        ``pooled``, the :meth:`pooled_view` of them."""
        b = self.stacked(round_index, local_steps)
        return self.pooled_view(b) if pooled else b

    def site_batches(self, site: int, round_index: int,
                     local_steps: int) -> Dict[str, np.ndarray]:
        """[1, K, B, …]: one site's slice of :attr:`stacked`, generated for
        that site alone (its own seeded stream, ``round * K + k``)."""
        ks = [self.sample(site, round_index * local_steps + k)
              for k in range(local_steps)]
        return {k: np.stack([x[k] for x in ks])[None] for k in ks[0]}


def _build_volume_task(task: TaskConfig) -> TaskBundle:
    from repro_torch.data.synthetic import DoseTaskGenerator, SegTaskGenerator
    from repro_torch.models import sanet as sanet_mod
    scfg = task.model_config()
    if task.kind == "dose":
        gen = DoseTaskGenerator(volume=task.volume, num_oars=task.num_oars,
                                num_sites=task.sites,
                                heterogeneity=task.heterogeneity,
                                seed=task.seed, site_pools=task.site_pools)
        loss_of = sanet_mod.dose_loss_of

        def logits_of(pred, batch):
            # dose regression viewed as binary high/low for DCML regions
            return (torch.cat([pred, -pred], dim=-1),
                    (batch["dose"][..., 0] > 0.5).to(torch.int32))
    else:
        gen = SegTaskGenerator(volume=task.volume, in_channels=task.in_channels,
                               num_classes=task.num_classes, num_sites=task.sites,
                               heterogeneity=task.heterogeneity,
                               seed=task.seed, site_pools=task.site_pools)
        loss_of = sanet_mod.segmentation_loss_of

        def logits_of(pred, batch):
            return pred, batch["labels"]

    def apply(params, batch):
        return sanet_mod.sanet_apply(params, batch["volume"], scfg)

    def forward_fn(params, batch):
        out = apply(params, batch)
        return (loss_of(out, batch, scfg)[0],) + logits_of(out[0], batch)

    return TaskBundle(
        task=task,
        loss_fn=lambda p, b: loss_of(apply(p, b), b, scfg),
        init_fn=lambda seed: sanet_mod.sanet_init(
            torch.Generator().manual_seed(seed), scfg),
        model_cfg=scfg,
        stacked=lambda rnd, k: gen.stacked_batches(rnd, k, task.batch),
        sample=lambda site, step: gen.sample(site, step, task.batch),
        forward_fn=forward_fn)


# ---------------------------------------------------------------------------
# The job
# ---------------------------------------------------------------------------


def _resolve_device(device: Optional[str]) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("FederatedJob runs on CUDA by default, and CUDA is "
                           "not available here; pass device='cpu' to run on "
                           "the CPU")
    return dev


@dataclass
class FederatedJob:
    """A fully-specified federated run; ``run()`` executes it.

    The fields mirror the reference's; those of seams the port does not
    implement yet keep their defaults, and any other value raises
    :class:`~repro_torch.NotPorted` at ``run()``."""

    task: TaskConfig = field(default_factory=TaskConfig)
    strategy: str = "fedavg"
    rounds: int = 10
    local_steps: int = 1
    # optimizer hyper-parameters
    lr: float = 1e-3
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    prox_mu: float = 0.01               # FedProx (Eq. 2)
    gcml_lambda: float = 0.5            # GCML (Eq. 3)
    gcml_contrast_beta: float = 1.0
    dcml_lr: Optional[float] = None     # default: lr
    # Algorithm-2 dropout schedule
    max_dropout: int = 0
    dropout_scenario: str = "disconnect"
    case_counts: Optional[Tuple[int, ...]] = None   # Eq. 1 m_i (None=uniform)
    # execution seams (ported: the defaults)
    sample: str = "none"
    transport: str = "stacked"
    scheduler: Any = "sync"
    topology: str = "flat"
    pod_dropout: int = 0
    compression: Union[str, Codec] = "none"      # upload codec
    error_feedback: bool = True         # carry the quantization residual
    down_compression: Union[str, Codec] = "none"  # download codec
    dp_clip: float = 0.0
    dp_noise_multiplier: float = 0.0
    dp_delta: float = 1e-5
    dp_mode: str = "per-site"
    secure_agg: bool = False
    aggregator: str = "fedavg"
    adversary: Optional[str] = None
    round_deadline_s: Optional[float] = None   # socket transports only
    max_upload_norm: Optional[float] = None    # socket transports only
    seed: int = 0                       # init + dropout seed
    # socket transports: the sites' channel timeout, the wire, site leases
    io_timeout: float = 120.0
    wire: Any = field(default_factory=WireConfig)
    lease_ttl: Optional[float] = None
    # the reference's compiled round engine; the port runs a round loop
    round_engine: str = "auto"
    chunk_rounds: Optional[int] = None
    device_data: bool = False
    shard_sites: bool = False
    checkpoint_dir: Optional[str] = None   # socket transports; with run(resume=True)
    ckpt_every: int = 10
    verbose: bool = False
    log_every: Optional[int] = None
    # where the job runs: None = "cuda" (raises when CUDA is absent)
    device: Optional[str] = None

    def __post_init__(self):
        _resolve_device(self.device)

    @property
    def torch_device(self) -> torch.device:
        return _resolve_device(self.device)

    def replace(self, **kw) -> "FederatedJob":
        return dataclasses.replace(self, **kw)

    @property
    def train_sites(self) -> int:
        """Sites in the *training* federation (Pooled trains as 1 site
        over the concatenated data)."""
        return 1 if self.strategy == "pooled" else self.task.sites

    @property
    def sampler(self) -> ClientSampler:
        """The job's resolved client sampler."""
        return resolve_sampler(self.sample)

    @property
    def aggregator_spec(self) -> AggregatorSpec:
        """The job's parsed combine rule."""
        return parse_aggregator(self.aggregator)

    @property
    def adversary_plan(self) -> Optional[AdversaryPlan]:
        """The job's parsed adversary plan, or None when every site is
        honest."""
        return parse_adversary(self.adversary, seed=self.seed)

    @property
    def sampled(self) -> bool:
        """True when client sampling actually thins participation
        (``uniform:S`` and ``poisson:1.0`` are the dense run)."""
        return not self.sampler.is_trivial(self.task.sites)

    def check_ported(self, transport: str = "stacked") -> None:
        """Raise :class:`~repro_torch.NotPorted` for the first seam that is
        set to something the port does not implement on ``transport``."""
        plan = self.adversary_plan
        socket = transport != "stacked"
        strategies = (("fedavg", "individual") if socket
                      else ("fedavg", "fedprox", "individual", "pooled", "gcml"))
        unported = [
            ("strategy", self.strategy not in strategies, self.strategy,
             ", ".join(repr(x) for x in strategies)),
            ("topology", self.topology != "flat" or self.pod_dropout,
             f"{self.topology!r}, pod_dropout={self.pod_dropout}", "'flat'"),
            ("dp", self.dp_clip > 0 or self.dp_noise_multiplier > 0,
             f"dp_clip={self.dp_clip}, noise={self.dp_noise_multiplier}", "off"),
            ("adversary", plan is not None and plan.kind == "noise", self.adversary,
             "sign_flip, scale, label_flip"),
            ("device_data", self.device_data, "True", "False"),
            ("shard_sites", self.shard_sites, "True", "False"),
            ("checkpoint", self.checkpoint_dir is not None and not socket,
             self.checkpoint_dir, "None on the stacked transport"),
            ("checkpoint", self.ckpt_every != 10 and not socket,
             f"ckpt_every={self.ckpt_every}", "ckpt_every=10 on the stacked transport"),
            ("secure_agg", self.secure_agg and socket, "True", "False"),
        ]
        for seam, bad, got, ok in unported:
            if bad:
                raise NotPorted(seam, str(got), ok)
        for name, seam in SEAM_FIELDS.items():
            owner, attr = (self.task, name[5:]) if name.startswith("task.") else (self, name)
            value, default = getattr(owner, attr), _default(type(owner), attr)
            if value != default:
                raise NotPorted(seam, f"{name}={value!r}", f"{name}={default!r}")
        resolve_scheduler(self.scheduler)   # raises for buffered rounds
        self.codecs()                   # raises for unported codecs
        if self.dropout_scenario not in ("disconnect", "shutdown"):
            raise ValueError(f"unknown dropout_scenario {self.dropout_scenario!r}")
        self.task.model_config()        # raises for unported task kinds

    def codecs(self) -> Tuple[Codec, Codec]:
        """The (upload, download) codecs; ``none`` or ``int8``."""
        return (resolve_codec(self.compression, "compression"),
                resolve_codec(self.down_compression, "down_compression"))

    def participation(self, rounds: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(participate, scale)``: the [rounds, S] bool participation
        schedule (Algorithm-2 availability intersected with the client
        sampler's schedule) and the [rounds, S] float32 ``1/pi`` Eq. 1
        weight scale."""
        if self.sampled and self.strategy == "pooled":
            raise ValueError("client sampling is meaningless for the "
                             "pooled centralized baseline; use sample="
                             "'none'")
        avail = availability_masks(self.task.sites, self.max_dropout,
                                   self.seed, rounds)
        return compose_participation(self.sampler, avail, self.seed)

    def masks(self, rounds: int) -> np.ndarray:
        """The run's [rounds, S] participation schedule; without sampling,
        the Algorithm-2 availability schedule verbatim."""
        return self.participation(rounds)[0]

    def weight_scale(self, rounds: int) -> np.ndarray:
        """[rounds, S] float32 Eq. 1 inclusion-probability factors; the
        rounds multiply them into the weights only when :attr:`sampled`."""
        return self.participation(rounds)[1]

    def federation(self, strategy: Optional[str] = None,
                   num_sites: Optional[int] = None) -> FederationConfig:
        sites = self.train_sites if num_sites is None else num_sites
        counts = self.case_counts
        if counts is not None and len(counts) != sites:
            counts = None               # a 1-site view (a socket worker, pooled)
        return FederationConfig(
            num_sites=sites, strategy=strategy or self.strategy,
            local_steps=self.local_steps, rounds=self.rounds,
            prox_mu=self.prox_mu, gcml_lambda=self.gcml_lambda,
            gcml_contrast_beta=self.gcml_contrast_beta,
            max_dropout_sites=self.max_dropout,
            dropout_scenario=self.dropout_scenario,
            site_case_counts=counts)

    def context(self, bundle: Optional[TaskBundle] = None,
                strategy: Optional[str] = None,
                num_sites: Optional[int] = None) -> F.FLContext:
        """The round loop's view of this job; ``strategy`` overrides the
        job's (the compressed rounds and the socket sites train under
        ``individual``) and ``num_sites`` the federation's size (a socket
        site's 1-site view)."""
        bundle = bundle or self.task.build()
        fed = self.federation(strategy, num_sites)
        device = self.torch_device
        return F.FLContext(
            fed=fed,
            case_weights=torch.as_tensor(fed.case_weights(), device=device),
            loss_fn=bundle.loss_fn, forward_fn=bundle.forward_fn, dcml_lr=self.dcml_lr or self.lr,
            optimizer=adamw(self.lr, weight_decay=self.weight_decay),
            grad_clip=self.grad_clip, device=device,
            aggregator=self.aggregator_spec,
            # a local-only view (the compressed rounds) stays honest, as in
            # the reference
            adversary=self.adversary_plan if strategy is None else None)

    def recorder(self, rounds: int, num_sites: int) -> RoundRecorder:
        return RoundRecorder(rounds, verbose=self.verbose,
                             log_every=self.log_every, num_sites=num_sites,
                             checkpoint_dir=self.checkpoint_dir)

    def run(self, rounds: Optional[int] = None, init_params=None,
            on_round: Optional[Callable[[int], None]] = None,
            resume: bool = False) -> JobResult:
        """Execute the federation.  ``init_params`` (one unstacked
        parameter tree) replaces the seeded initialization; ``on_round(r)``
        is called after each round, outside its timed span (the stacked
        transport only: a socket driver does not see rounds).
        ``resume=True`` (socket transports, with a ``checkpoint_dir``)
        re-enters from the newest round that the server's store and every
        site's own store share."""
        return resolve_transport(self.transport).execute(
            self, self.rounds if rounds is None else rounds,
            init_params=init_params, on_round=on_round, resume=resume)


# Fields of the reference's job (and, as ``task.<field>``, its task) that
# only an unported seam reads, with the seam that ``NotPorted`` names: each
# must hold its dataclass default.
SEAM_FIELDS = {
    "dp_delta": "dp", "dp_mode": "dp",
    "round_engine": "round_engine", "chunk_rounds": "round_engine",
    "task.arch": "task", "task.reduced": "task", "task.seq": "task",
}


def _default(cls, name: str):
    """The dataclass default of ``cls.name``."""
    f = next(f for f in dataclasses.fields(cls) if f.name == name)
    return f.default if f.default is not dataclasses.MISSING else f.default_factory()


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class Transport:
    """Execution backend protocol: run ``rounds`` FL rounds of ``job``."""

    name = "base"

    def execute(self, job: FederatedJob, rounds: int, init_params=None,
                on_round=None, resume: bool = False) -> JobResult:
        raise NotImplementedError


def _buffered(job: FederatedJob) -> bool:
    """True when the job asks for buffered rounds (the flat topology's one
    scheduler serves both of the reference's tiers)."""
    return scheduler_name(job.scheduler) == "buffered"


def _validate_robustness(job: FederatedJob) -> None:
    """The reference's composition guards for the robustness seams.  Robust
    rules need to see the round's individual plaintext uploads side by
    side; compositions that hide, quantize or stream them away are
    ``ValueError``s, never silent downgrades."""
    spec = job.aggregator_spec          # raises on a malformed spec string
    plan = job.adversary_plan           # raises on a malformed plan string
    if (not spec.robust and plan is None and job.max_upload_norm is None
            and job.round_deadline_s is None):
        return
    if job.strategy == "pooled":
        raise ValueError("the pooled centralized baseline has no "
                         "federation to attack or robustly aggregate")
    sites = job.task.sites
    if (spec.robust or plan is not None) and codec_name(job.compression) != "none":
        raise ValueError(
            "robust aggregation and the adversary harness operate on "
            "plaintext fp32 uploads; delta-quantized uploads would fold "
            "attacker-shaped residuals into honest error feedback — use "
            "compression='none'")
    if spec.robust and job.secure_agg:
        raise ValueError(
            "robust rules rank individual uploads; secure aggregation "
            "masks every upload so only their sum is visible — the rule "
            "would rank ciphertext.  Disable secure_agg or use "
            "aggregator='fedavg'")
    if job.max_upload_norm is not None and job.secure_agg:
        raise ValueError(
            "max_upload_norm inspects per-upload L2 norms; secure "
            "aggregation uploads fixed-point ciphertext whose norm is "
            "meaningless — disable one of them")
    if (plan is not None or spec.robust) and job.shard_sites:
        raise ValueError(
            "the sharded engine folds partial sums per device shard and "
            "runs local-strategy contexts — it has neither the full "
            "[S, N] buffer a robust rule needs nor an in-round fault "
            "seam; run robustness jobs with shard_sites=False")
    if spec.rank_based:
        if job.strategy not in ("fedavg", "fedprox"):
            raise ValueError(
                "rank-based robust rules (trimmed/median/krum) combine "
                f"centrally-aggregated uploads; strategy {job.strategy!r} "
                "has no central combine — use fedavg/fedprox (or "
                "aggregator='normclip:c', which gossip honors too)")
        if _buffered(job):
            raise ValueError(
                "rank-based robust rules need the round's uploads side "
                "by side; a buffered scheduler folds each arrival into a "
                "running sum and discards it — use scheduler='sync'")
        if spec.name == "trimmed" and 2 * spec.f >= sites:
            raise ValueError(
                f"trimmed:{spec.f} discards 2f={2 * spec.f} of {sites} "
                "uploads — the trim must leave a majority (2f < S)")
        if spec.name == "krum" and spec.f > max(sites - 3, 0):
            raise ValueError(
                f"krum:{spec.f} scores each upload against its "
                f"S−f−2 nearest neighbours and needs S ≥ f+3 (S={sites})")
    if (spec.name == "normclip"
            and job.strategy not in ("fedavg", "fedprox", "gcml")):
        raise ValueError(
            "normclip bounds uploads at a central fold (fedavg/fedprox) "
            f"or incoming gossip deltas (gcml), not {job.strategy!r}")
    if job.round_deadline_s is not None and _buffered(job):
        raise ValueError(
            "round_deadline_s bounds the sync barrier; scheduler "
            f"{job.scheduler!r} has no barrier to bound")


def _validate_down(job: FederatedJob) -> None:
    """The reference's composition guards for download compression: the
    download codec needs a server that tracks one reference trajectory
    per site."""
    if codec_name(job.down_compression) == "none":
        return
    if job.strategy not in ("fedavg", "fedprox"):
        raise ValueError(
            "down_compression encodes the server's broadcast against "
            "per-site held references; only the centrally-aggregated "
            "strategies (fedavg/fedprox) have that broadcast, not "
            f"{job.strategy!r}")
    if job.secure_agg:
        raise ValueError(
            "secure_agg downloads stay dense: the masked protocol lets "
            "the server materialize only the aggregate sum, while "
            "down_compression requires it to track what each site holds "
            "— disable one of them")
    if _buffered(job):
        raise ValueError(
            "buffered-async sites pull whichever global version is "
            "newest out of the keep_globals ring, not a per-site "
            "residual stream; down_compression needs scheduler='sync'")
    if job.aggregator_spec.robust or job.adversary_plan is not None:
        raise ValueError(
            "robust aggregation rules and the adversary harness rank "
            "plaintext uploads against ONE shared broadcast; "
            "down_compression gives every site a different decoded "
            "install, so upload distances would mix honest quantization "
            "drift with attacker signal — use down_compression='none'")
    if job.shard_sites:
        raise ValueError(
            "shard_sites=True broadcasts the global through the mesh "
            "collective, not the download codec; run down_compression "
            "jobs with shard_sites=False")


def _validate_stacked(job: FederatedJob) -> None:
    """The reference's guards for what the stacked simulator cannot hold:
    a wall-clock barrier, a server, a fault seam in buffered rounds, a
    wire to protect."""
    if job.round_deadline_s is not None:
        raise ValueError(
            "round_deadline_s bounds a real wall-clock barrier; the "
            "stacked simulator has none — run on transport='thread' "
            "or 'tcp'")
    if job.max_upload_norm is not None:
        raise ValueError(
            "max_upload_norm is server-side upload sanitation; the "
            "stacked simulator has no server — run on "
            "transport='thread' or 'tcp'")
    if job.adversary_plan is not None and _buffered(job):
        raise ValueError(
            "the stacked buffered loop trains local-only contexts "
            "with no in-round fault seam; run adversarial buffered "
            "jobs on the thread/tcp transports")
    if job.aggregator_spec.robust and _buffered(job):
        raise ValueError(
            "the stacked buffered loop folds arrivals into a plain "
            "running sum; robust buffered rounds (normclip) run on "
            "the thread/tcp transports' server")
    if job.secure_agg:
        raise ValueError(
            "secure_agg masks real uploads between distrusting "
            "participants — there is no wire to protect inside the "
            "stacked simulator; run it on transport='thread' or 'tcp'")
    if _pods(job) and job.strategy not in ("fedavg", "fedprox"):
        raise ValueError(
            "a pods topology needs a centrally-aggregated strategy "
            f"(fedavg/fedprox), not {job.strategy!r}")
    if _buffered(job) and job.strategy != "fedavg":
        raise ValueError("buffered-async scheduling currently supports "
                         f"fedavg only, not {job.strategy!r}")
    if (not _buffered(job) and codec_name(job.compression) != "none"
            and job.strategy not in ("fedavg", "fedprox")):
        raise ValueError(
            "compression on the stacked transport currently supports "
            f"fedavg/fedprox only, not {job.strategy!r}; run gcml "
            "compression on the thread/tcp transports")


class StackedTransport(Transport):
    """Single-process simulator: every site's state in one [S, N] buffer.
    A job with a codec in either direction takes the compressed rounds."""

    name = "stacked"

    def execute(self, job: FederatedJob, rounds: int, init_params=None,
                on_round=None, resume: bool = False) -> JobResult:
        _validate_robustness(job)
        _validate_down(job)
        _validate_stacked(job)
        job.check_ported()
        if resume:
            raise NotPorted("checkpoint", "run(resume=True) on the stacked transport",
                            "resume on transport='thread' or 'tcp'")
        scheduler = resolve_scheduler(job.scheduler)
        codec, down_codec = job.codecs()
        from repro_torch.core import round_engine
        if codec.name != "none" or down_codec.name != "none":
            return round_engine.run_compressed(
                job, job.task.build(), scheduler, rounds, codec,
                down_codec=down_codec, init_params=init_params, on_round=on_round)
        return round_engine.run_sync(job, job.task.build(), scheduler, rounds,
                                     init_params=init_params, on_round=on_round)




# -- socket transports (real Peer / AggregationServer) -------------------------


def _pods(job: FederatedJob) -> bool:
    return str(job.topology).startswith("pods")


def _site_store(job: FederatedJob, site_id: int):
    from repro_torch.checkpoint import CheckpointStore
    return CheckpointStore(Path(job.checkpoint_dir) / f"site{site_id}")


def _run_site(job: FederatedJob, site_id: int, agg_addr, rounds: int,
              start_round: int = 0, init_params=None) -> Dict[str, Any]:
    """One site's FL script (paper Algorithm 1, site side), the same under a
    thread or an OS process.

    The site trains on the job's device under the ``individual`` strategy
    (its 1-site round loop) with its own seeded batch stream, so thread
    scheduling never changes a batch.  At its edge it converts between its
    OIDHW model and the wire's reference layout: a dense upload is one
    gather and one copy to the host; an int8 upload is the
    :class:`UploadCompressor`'s (one ``quantize_int8`` launch per chunk
    width, one copy, the error-feedback residual on the device); a download
    is one copy to the device, one ``dequantize_int8`` launch if it is int8,
    and one gather into the port's layout.  With a ``checkpoint_dir`` the
    site keeps its own store and, resumed at ``start_round > 0``, reloads
    round ``start_round - 1``; with a ``lease_ttl`` it holds a lease, and a
    late joiner adopts the join reply's global."""
    from repro_torch.comms.peer import Peer
    dev = job.torch_device
    bundle = job.task.build()
    ctx = job.context(bundle, strategy="individual", num_sites=1)
    params0 = init_params if init_params is not None else bundle.init_fn(job.seed)
    state = F.init_fl_state(ctx, tree_map(lambda t: torch.as_tensor(t).to(dev), params0))
    fl_round = F.build_fl_round(ctx)
    layout = state["layout"]
    masks = job.masks(rounds)
    one = np.ones(1, bool)
    adv = job.adversary_plan
    malicious = adv is not None and bool(adv.malicious_mask(job.task.sites)[site_id])
    codec, down_codec = job.codecs()
    comp = UploadCompressor(codec, job.error_feedback) if codec.name != "none" else None
    down = down_codec.name != "none"
    edge = WirePlan.of(layout, getattr(codec, "chunk", 1024), align_for(dev), dev, port=True)
    peer = Peer(site_id, wire=job.wire)
    losses: List[float] = []
    times: List[Tuple[float, float]] = []        # (batch_s, step_s) a round
    base_round = start_round     # server round of the global this site holds
    stale_uploads = rejected_uploads = 0
    reference: Optional[torch.Tensor] = None     # last pulled global, port layout
    down_ref = None              # last decoded download (wire layout, device)
    down_acked: Optional[int] = None
    store = _site_store(job, site_id) if job.checkpoint_dir else None
    zeros = torch.zeros(layout.n, dtype=torch.float32, device=dev)
    hb = None
    try:
        if start_round > 0 and store is not None:
            like = {"params": zeros, "mu": zeros, "nu": zeros, "step": zeros[:1],
                    "reference": zeros, "residual": zeros, "down_ref": zeros}
            loaded, lmeta = store.load("state", start_round - 1, like)
            t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in loaded.items()}
            state["params"][0].copy_(t["params"])
            state["opt"]["mu"][0].copy_(t["mu"])
            state["opt"]["nu"][0].copy_(t["nu"])
            state["opt"]["step"][0] = t["step"].to(torch.int32)[0]
            base_round = int(lmeta.get("base_round", start_round))
            if comp is not None:
                reference = t["reference"] if lmeta.get("has_reference") else None
                comp.residual = t["residual"] if lmeta.get("has_residual") else None
            if down and lmeta.get("has_down_ref"):
                down_ref = unravel(t["down_ref"], edge.wire)
                acked = lmeta.get("down_acked")
                down_acked = int(acked) if acked is not None else None
        if job.lease_ttl and agg_addr is not None:
            from repro_torch.comms.membership import HeartbeatClient
            hb = HeartbeatClient(site_id, lambda k, m: peer.request(agg_addr, k, m),
                                 job.lease_ttl).start()
            join_round = int(hb.join_meta.get("round", 0))
            if join_round > start_round and hb.bootstrap is not None:
                # a late joiner: adopt the live global, skip the done rounds
                g = edge.to_port(edge.decode(hb.bootstrap))
                state["params"][0].copy_(g)
                base_round = join_round
                if comp is not None:
                    reference = g
                losses.extend([float("nan")] * (join_round - start_round))
                times.extend([(float("nan"), float("nan"))] * (join_round - start_round))
                start_round = join_round
        for r in range(start_round, rounds):
            me_active = bool(masks[r, site_id])
            t0 = time.perf_counter()
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in bundle.site_batches(site_id, r, job.local_steps).items()}
            if malicious and adv.flips_labels:
                b = adv.perturb_batches(b, one)
            t1 = time.perf_counter()
            if me_active or job.dropout_scenario == "disconnect":
                state, metrics = fl_round(state, b, F.make_round_inputs(ctx, one))
                losses.append(float(metrics["loss"][0]))
            else:                                    # workstation off
                losses.append(float("nan"))
            times.append((t1 - t0, time.perf_counter() - t1))
            if agg_addr is not None and me_active:
                flat = state["params"][0]
                if malicious and adv.flips_params:
                    # only the wire payload is perturbed; the site's state
                    # stays honest, as on the stacked transport
                    flat = flat.clone()[None]
                    adv.perturb_rows(flat, one)
                    flat = flat[0]
                cmeta = None
                if comp is not None:
                    # a reference older than the server's window is gone
                    # there: re-send dense rather than an unfoldable delta
                    if reference is not None and r + 1 - base_round >= KEEP_GLOBALS_DEFAULT:
                        reference = None
                    payload, cmeta = comp.encode(unravel(flat, layout), reference)
                    cmeta["base_round"] = base_round if reference is not None else 0
                else:
                    payload = edge.host_tree(flat)
                ack = peer.upload(agg_addr, payload, r + 1,
                                  active_sites=int(masks[r].sum()), meta_extra=cmeta)
                if ack.get("rejected"):
                    # the server refused the fold: drop the residual, or it
                    # would re-inject the rejected content next round
                    rejected_uploads += 1
                    if comp is not None:
                        comp.residual = None
                elif ack.get("stale"):
                    stale_uploads += 1
                g, dmeta = peer.download(agg_addr, r + 1, with_meta=True, down=down,
                                         acked_round=down_acked)
                if g is not None:
                    if down:
                        down_ref = decode_download(g, dmeta, down_ref, plan=edge)
                        down_acked = int(dmeta["round"])
                        gflat = edge.to_port(ravel(down_ref))
                    else:
                        gflat = edge.to_port(edge.decode(g))
                    base_round = int(dmeta["round"])
                    if comp is not None:
                        reference = gflat
                    state["params"][0].copy_(gflat)   # AdamW's moments are kept
            if store is not None and r % job.ckpt_every == 0:
                opt = state["opt"]
                store.save("state", r, {
                    "params": state["params"][0], "mu": opt["mu"][0], "nu": opt["nu"][0],
                    "step": opt["step"][:1].float(),
                    "reference": reference if reference is not None else zeros,
                    "residual": (comp.residual if comp is not None and comp.residual is not None
                                 else zeros),
                    "down_ref": ravel(down_ref) if down_ref is not None else zeros},
                    meta={"base_round": base_round,
                          "has_reference": reference is not None,
                          "has_residual": comp is not None and comp.residual is not None,
                          "has_down_ref": down_ref is not None,
                          "down_acked": down_acked})
        return {"losses": losses, "times": times, "stale_uploads": stale_uploads,
                "rejected_uploads": rejected_uploads,
                "params": state["params"][0].detach().cpu().numpy().copy(),
                "upload_payload_bytes": comp.encoded_bytes if comp is not None else 0,
                "upload_raw_bytes": comp.raw_bytes if comp is not None else 0,
                "upload_count": comp.encodes if comp is not None else 0}
    finally:
        if hb is not None:
            hb.stop(leave=True)
        peer.close()


def _site_worker(job, site_id, agg_addr, result_q, rounds, start_round=0, init_params=None,
                 precision=None):
    """Queue-reporting wrapper around :func:`_run_site` (thread or process).
    ``precision`` (a site process's) is the parent's TF32 flags for cuDNN
    and matmuls: a spawned process starts from PyTorch's defaults."""
    if precision is not None:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = precision
    try:
        result_q.put((site_id, _run_site(job, site_id, agg_addr, rounds, start_round,
                                         init_params)))
    except Exception as e:  # noqa: BLE001 — the job raises it
        result_q.put((site_id, {"error": f"{type(e).__name__}: {e}"}))


def _socket_resume_point(job: FederatedJob, num_sites: int):
    """``(resume_round, global)``: the newest round present in the driver's
    "global" store AND every site's own store (the global in the wire's
    layout, numpy leaves); ``(None, None)`` when none is shared."""
    from repro_torch.checkpoint import CheckpointStore
    store = CheckpointStore(Path(job.checkpoint_dir))
    common = set(store.saved_rounds("global"))
    for i in range(num_sites):
        common &= set(_site_store(job, i).saved_rounds("state"))
    if not common:
        return None, None
    rr = max(common)
    g, _ = store.load("global", rr, job.task.build().init_fn(job.seed))
    return rr, g


def _socket_down_refs(job: FederatedJob, rr: int, num_sites: int):
    """The per-site downlink references the server saved at round ``rr``
    (tags ``downref{sid}``), as the restarted server's ``initial_down``;
    a site without one re-enters through a dense bootstrap."""
    from repro_torch.checkpoint import CheckpointStore
    store = CheckpointStore(Path(job.checkpoint_dir))
    like = job.task.build().init_fn(job.seed)
    out = {}
    for sid in range(num_sites):
        tag = f"downref{sid}"
        if rr in set(store.saved_rounds(tag)):
            held, meta = store.load(tag, rr, like)
            out[sid] = (held, int(meta["held_round"]))
    return out or None


class _SocketTransport(Transport):
    """Shared round-trip machinery for thread- and process-backed sites.

    The history is assembled from the sites' reports after the run: a
    round's ``wall_s`` is the run's mean (the driver does not see remote
    rounds), ``batch_s`` and ``step_s`` the sites' mean for that round (a
    site's step on a card the other sites share)."""

    name = "socket"

    def execute(self, job: FederatedJob, rounds: int, init_params=None,
                on_round=None, resume: bool = False) -> JobResult:
        # the reference's guards, word for word, before any NotPorted
        if job.shard_sites:
            raise ValueError("shard_sites=True shards the stacked "
                             "simulator's [S, N] buffer; socket transports "
                             "distribute sites as processes already — use "
                             "transport='stacked'")
        if job.strategy == "pooled":
            raise ValueError("pooled is a single-process baseline; "
                             "run it on the stacked transport")
        if job.strategy == "gcml" and job.max_dropout:
            raise ValueError("gossip under dropout needs coordinated status "
                             "updates; run it on the stacked transport")
        if _pods(job) and job.strategy not in ("fedavg", "fedprox"):
            raise ValueError(
                "a pods topology needs a centrally-aggregated strategy "
                f"(fedavg/fedprox), not {job.strategy!r}")
        if job.secure_agg:
            if _buffered(job):
                raise ValueError(
                    "secure aggregation cancels pairwise masks at a sync "
                    "barrier over the round's scheduled participants; "
                    "buffered-async folds partial subsets, so the masks "
                    "would never cancel")
            if codec_name(job.compression) != "none":
                raise ValueError(
                    "secure aggregation uploads fixed-point masked "
                    "integers; quantizing that ciphertext would corrupt "
                    "the modular sum — use compression='none'")
            if job.strategy not in ("fedavg", "fedprox"):
                raise ValueError(
                    "secure aggregation protects centrally-aggregated "
                    f"uploads (fedavg/fedprox), not {job.strategy!r}")
        _validate_robustness(job)
        _validate_down(job)
        if job.round_deadline_s is not None and _pods(job):
            raise ValueError(
                "round_deadline_s bounds the flat star's sync "
                "barrier; per-tier pod deadlines are not wired — "
                "use topology='flat'")
        job.check_ported(self.name)
        if on_round is not None:
            raise ValueError("on_round needs the stacked transport: a socket "
                             "driver does not see the sites' rounds")
        scheduler = SyncScheduler(round_deadline_s=job.round_deadline_s)
        fed = job.federation()
        num_sites = fed.num_sites
        dev = job.torch_device
        start_round, resumed_from, initial_global, initial_down = 0, None, None, None
        if resume:
            if not job.checkpoint_dir:
                raise ValueError("run(resume=True) needs checkpoint_dir set")
            resumed_from, initial_global = _socket_resume_point(job, num_sites)
            if resumed_from is not None:
                start_round = resumed_from + 1
        codec, down_codec = job.codecs()
        down = down_codec.name != "none"
        if down and resumed_from is not None:
            initial_down = _socket_down_refs(job, resumed_from, num_sites)
        if dev.type == "cuda":
            # every kernel a site or the server launches, built once here
            # (the build is also safe when processes race on it)
            from repro_torch.kernels import build
            build.build(["quantize_int8", "dequantize_int8", "fedagg", "trimmed_mean"])
        recorder = job.recorder(rounds, num_sites)
        from repro_torch.comms.coordinator import AggregationServer
        agg = None
        try:
            if job.strategy != "individual":
                agg = AggregationServer(
                    "127.0.0.1", 0, num_sites=num_sites,
                    case_weights=list(fed.case_weights()),
                    download_timeout=job.io_timeout / 2, scheduler=scheduler,
                    wire=job.wire, lease_ttl=job.lease_ttl, initial_round=start_round,
                    initial_global=initial_global, ckpt_store=recorder.store,
                    ckpt_every=job.ckpt_every, aggregator=job.aggregator,
                    max_upload_norm=job.max_upload_norm,
                    down_compression=down_codec if down else None,
                    initial_down=initial_down, device=dev)
            results = self._run_workers(job, num_sites, agg.addr if agg else None,
                                        rounds, start_round, init_params)
        finally:
            if agg is not None:
                agg.stop()
        per_site = dict(results)
        dead = {i: p["error"] for i, p in per_site.items() if "error" in p}
        if dead:
            # elastic (lease_ttl set): a dead site already left the barriers
            if job.lease_ttl is None:
                raise RuntimeError(f"site workers failed: {dead}")
            if job.verbose:
                print(f"elastic: finishing without failed sites {sorted(dead)}")
        site_payload = sum(p.get("upload_payload_bytes", 0) for p in per_site.values())
        site_raw = sum(p.get("upload_raw_bytes", 0) for p in per_site.values())
        comm = None
        if agg is not None:
            snap = agg.stats.snapshot()
            up_b = snap.get("upload", {}).get("in_bytes", 0)
            down_b = snap.get("download", {}).get("out_bytes", 0)
            comm = {"upload_bytes": up_b, "download_bytes": down_b,
                    "total_bytes": up_b + down_b,
                    "upload_count": snap.get("upload", {}).get("count", 0),
                    "download_count": snap.get("download", {}).get("count", 0),
                    "site_payload_bytes": site_payload, "upload_raw_bytes": site_raw,
                    "compression": codec.name, "down_compression": down_codec.name,
                    "simulated": False}
            if agg.down_counters is not None:
                # the payload split (download_bytes also counts framing)
                comm["download_payload_bytes"] = agg.down_counters["encoded"]
                comm["download_raw_bytes"] = agg.down_counters["raw"]
        exec_rounds = rounds - start_round
        nan = float("nan")
        losses = np.stack([per_site[i].get("losses", [nan] * exec_rounds)
                           for i in range(num_sites)])
        times = np.asarray([per_site[i].get("times", [(nan, nan)] * exec_rounds)
                            for i in range(num_sites)], np.float64).reshape(
                                num_sites, exec_rounds, 2)
        masks = job.masks(rounds)
        stale = [per_site[i].get("stale_uploads", 0) for i in range(num_sites)]
        round_wall = recorder.elapsed / max(exec_rounds, 1)
        for ri, r in enumerate(range(start_round, rounds)):
            extra = {"wall_s": round_wall,
                     "batch_s": float(np.nanmean(times[:, ri, 0])),
                     "step_s": float(np.nanmean(times[:, ri, 1]))}
            if r == rounds - 1:
                extra["stale_uploads"] = stale
            recorder.record(r, losses[:, ri], masks[r], extra=extra)
        # the served global: the case-weighted mean of the final site
        # models (under FedAvg the sites hold the last broadcast already)
        acc = StreamingAccumulator()
        cw = fed.case_weights()
        for i in range(num_sites):
            if "params" in per_site[i]:
                acc.fold(torch.from_numpy(per_site[i]["params"]).to(dev), float(cw[i]),
                         owned=True)
        if not acc.count:
            raise RuntimeError(f"no site produced a final model: {dead}")
        bundle = job.task.build()
        like = init_params if init_params is not None else bundle.init_fn(job.seed)
        from repro_torch.core.agg_engine import tree_layout
        global_params = unravel(ravel(acc.finalize()), tree_layout(like))
        if recorder.store is not None:       # the final global, in the wire's layout
            from repro_torch import convert
            recorder.store.save("global", rounds - 1, convert.to_reference(global_params))
        return recorder.result(global_params, transport=self.name, scheduler=scheduler.name,
                               comm=comm, resumed_from=resumed_from,
                               rejected_uploads=agg.rejected_uploads if agg else 0)

    def _run_workers(self, job, num_sites, agg_addr, rounds, start_round, init_params):
        raise NotImplementedError


class ThreadTransport(_SocketTransport):
    """Real TCP round trips, sites driven by threads of this process (all
    on the job's device)."""

    name = "thread"

    def _run_workers(self, job, num_sites, agg_addr, rounds, start_round, init_params):
        q: "queue.Queue" = queue.Queue()
        threads = [threading.Thread(
            target=_site_worker,
            args=(job, i, agg_addr, q, rounds, start_round, init_params), daemon=True)
            for i in range(num_sites)]
        for t in threads:
            t.start()
        results = [q.get(timeout=job.io_timeout * max(rounds, 1)) for _ in range(num_sites)]
        for t in threads:
            t.join(timeout=5)
        return results


class TcpTransport(_SocketTransport):
    """Real TCP round trips, one OS process per site (paper §III.A.3), started
    with ``spawn`` (CUDA cannot be forked)."""

    name = "tcp"

    def _run_workers(self, job, num_sites, agg_addr, rounds, start_round, init_params):
        import multiprocessing as mp
        mpctx = mp.get_context("spawn")
        q = mpctx.Queue()
        precision = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        procs = [mpctx.Process(
            target=_site_worker,
            args=(job, i, agg_addr, q, rounds, start_round, init_params, precision),
            daemon=True)
            for i in range(num_sites)]
        for p in procs:
            p.start()
        results: List[Tuple[int, Dict[str, Any]]] = []
        deadline = time.time() + job.io_timeout * max(rounds, 1)
        try:
            while len(results) < num_sites:
                try:
                    results.append(q.get(timeout=2.0))
                except queue.Empty:
                    # a worker that died before reporting fails the job now
                    reported = {i for i, _ in results}
                    dead = [i for i, p in enumerate(procs)
                            if not p.is_alive() and p.exitcode not in (0, None)
                            and i not in reported]
                    if dead and q.empty():
                        if job.lease_ttl is not None:
                            for i in dead:
                                results.append((i, {"error": f"process exited "
                                                             f"{procs[i].exitcode}"}))
                            continue
                        raise RuntimeError(
                            f"{len(dead)} site process(es) exited with "
                            f"{[procs[i].exitcode for i in dead]} before reporting")
                    if time.time() > deadline:
                        raise TimeoutError(f"collected {len(results)}/{num_sites} site "
                                           f"results before timeout")
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
        return results


_TRANSPORTS = {"stacked": StackedTransport, "thread": ThreadTransport, "tcp": TcpTransport}


def resolve_transport(spec) -> Transport:
    if spec is None:
        return StackedTransport()
    if isinstance(spec, Transport):
        return spec
    try:
        return _TRANSPORTS[spec]()
    except KeyError:
        raise KeyError(f"unknown transport {spec!r}; known: {sorted(_TRANSPORTS)}")
