"""One ``FederatedJob`` API, ported from ``repro/api.py``.

A declarative job object that owns task construction, strategy, the
Algorithm-2 dropout schedule and metrics, and executes rounds through a
transport:

    job = FederatedJob(task=TaskConfig(kind="dose", sites=4), rounds=12)
    result = job.run()                  # on CUDA
    result = job.replace(device="cpu").run()

Ported so far: the SA-Net dose task, ``strategy="fedavg"`` (paper Eq. 1)
with sync rounds on the stacked transport, uncompressed or with int8
uploads and/or downloads (``compression="int8"``,
``down_compression="int8"``); the Byzantine-robust combine rules
(``aggregator="trimmed:f" | "median" | "krum:f" | "normclip:c"``), the
seeded adversary (``adversary="sign_flip:f" | "scale:c:f" |
"label_flip:f"``) and client sampling (``sample="uniform:K" |
"poisson:q"``).  Every other seam of the reference raises
:class:`repro_torch.NotPorted` naming it, and never runs something else;
compositions the reference refuses raise its ``ValueError``.

``device`` picks where the job runs: ``None`` means ``"cuda"``, which
raises when CUDA is absent.  Nothing falls back to the CPU: pass
``device="cpu"`` to run there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import NotPorted
from repro_torch.comms.compression import Codec, resolve_codec
from repro_torch.configs.base import FederationConfig
from repro_torch.core import federation as F
from repro_torch.core.adversary import AdversaryPlan, parse_adversary
from repro_torch.core.agg_engine import AggregatorSpec, parse_aggregator
from repro_torch.core.sampling import (ClientSampler, compose_participation,
                                       resolve_sampler)
from repro_torch.core.session import (JobResult, RoundRecorder,
                                      availability_masks, resolve_scheduler)
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# Task construction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TaskConfig:
    """What the federation trains on.  ``kind`` in {tokens, dose, seg};
    the port runs ``dose``."""

    kind: str = "tokens"
    sites: int = 4
    batch: int = 4                      # per-site batch per local step
    heterogeneity: float = 0.0          # non-IID knob (0 = IID)
    seed: int = 0                       # data seed (independent of job seed)
    # -- volumetric (dose / seg) -------------------------------------------
    volume: Tuple[int, int, int] = (16, 16, 16)
    num_oars: int = 2                   # dose: OAR channels
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
        if self.kind in ("tokens", "seg"):
            raise NotPorted("task", f"kind={self.kind!r}", "kind='dose'")
        raise ValueError(f"unknown task kind {self.kind!r}")

    def build(self) -> "TaskBundle":
        self.model_config()             # raises for kinds the port does not run
        return _build_volume_task(self)


@dataclass
class TaskBundle:
    """Built task: loss/init fns + host batch samplers over the generator."""

    task: TaskConfig
    loss_fn: Callable
    init_fn: Callable[[int], Any]                         # seed -> CPU params
    model_cfg: Any
    stacked: Callable[[int, int], Dict[str, np.ndarray]]  # (round, K) -> [S,K,B,…]


def _build_volume_task(task: TaskConfig) -> TaskBundle:
    from repro_torch.data.synthetic import DoseTaskGenerator
    from repro_torch.models import sanet as sanet_mod
    scfg = task.model_config()
    gen = DoseTaskGenerator(volume=task.volume, num_oars=task.num_oars,
                            num_sites=task.sites,
                            heterogeneity=task.heterogeneity,
                            seed=task.seed, site_pools=task.site_pools)
    return TaskBundle(
        task=task,
        loss_fn=lambda p, b: sanet_mod.dose_loss(p, b, scfg),
        init_fn=lambda seed: sanet_mod.sanet_init(
            torch.Generator().manual_seed(seed), scfg),
        model_cfg=scfg,
        stacked=lambda rnd, k: gen.stacked_batches(rnd, k, task.batch))


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
    secure_agg: bool = False
    aggregator: str = "fedavg"
    adversary: Optional[str] = None
    device_data: bool = False
    shard_sites: bool = False
    checkpoint_dir: Optional[str] = None
    seed: int = 0                       # init + dropout seed
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

    def check_ported(self) -> None:
        """Raise :class:`~repro_torch.NotPorted` for the first seam that is
        set to something the port does not implement."""
        plan = self.adversary_plan
        unported = [
            ("strategy", self.strategy != "fedavg", self.strategy, "'fedavg'"),
            ("topology", self.topology != "flat" or self.pod_dropout,
             f"{self.topology!r}, pod_dropout={self.pod_dropout}", "'flat'"),
            ("dp", self.dp_clip > 0 or self.dp_noise_multiplier > 0,
             f"dp_clip={self.dp_clip}, noise={self.dp_noise_multiplier}", "off"),
            ("secure_agg", self.secure_agg, "True", "False"),
            ("adversary", plan is not None and plan.kind == "noise", self.adversary,
             "sign_flip, scale, label_flip"),
            ("device_data", self.device_data, "True", "False"),
            ("shard_sites", self.shard_sites, "True", "False"),
            ("checkpoint", self.checkpoint_dir is not None,
             self.checkpoint_dir, "None"),
        ]
        for seam, bad, got, ok in unported:
            if bad:
                raise NotPorted(seam, str(got), ok)
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

    def federation(self, strategy: Optional[str] = None) -> FederationConfig:
        return FederationConfig(
            num_sites=self.task.sites, strategy=strategy or self.strategy,
            local_steps=self.local_steps, rounds=self.rounds,
            max_dropout_sites=self.max_dropout,
            dropout_scenario=self.dropout_scenario,
            site_case_counts=self.case_counts)

    def context(self, bundle: Optional[TaskBundle] = None,
                strategy: Optional[str] = None) -> F.FLContext:
        """The round loop's view of this job; ``strategy`` overrides the
        job's (the compressed rounds train under ``individual``)."""
        bundle = bundle or self.task.build()
        fed = self.federation(strategy)
        device = self.torch_device
        return F.FLContext(
            fed=fed,
            case_weights=torch.as_tensor(fed.case_weights(), device=device),
            loss_fn=bundle.loss_fn,
            optimizer=adamw(self.lr, weight_decay=self.weight_decay),
            grad_clip=self.grad_clip, device=device,
            aggregator=self.aggregator_spec,
            # a local-only view (the compressed rounds) stays honest, as in
            # the reference
            adversary=self.adversary_plan if strategy is None else None)

    def recorder(self, rounds: int, num_sites: int) -> RoundRecorder:
        return RoundRecorder(rounds, verbose=self.verbose,
                             log_every=self.log_every, num_sites=num_sites)

    def run(self, rounds: Optional[int] = None, init_params=None,
            on_round: Optional[Callable[[int], None]] = None) -> JobResult:
        """Execute the federation.  ``init_params`` (one unstacked
        parameter tree) replaces the seeded initialization; ``on_round(r)``
        is called after each round, outside its timed span."""
        return resolve_transport(self.transport).execute(
            self, self.rounds if rounds is None else rounds,
            init_params=init_params, on_round=on_round)


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class Transport:
    """Execution backend protocol: run ``rounds`` FL rounds of ``job``."""

    name = "base"

    def execute(self, job: FederatedJob, rounds: int, init_params=None,
                on_round=None) -> JobResult:
        raise NotImplementedError


def _validate_robustness(job: FederatedJob) -> None:
    """The reference's composition guards for the robustness seams.  Robust
    rules need to see the round's individual plaintext uploads side by
    side; compositions that hide, quantize or stream them away are
    ``ValueError``s, never silent downgrades.  (The ``max_upload_norm`` and
    ``round_deadline_s`` clauses come with the socket transports.)"""
    spec = job.aggregator_spec          # raises on a malformed spec string
    plan = job.adversary_plan           # raises on a malformed plan string
    if not spec.robust and plan is None:
        return
    if job.strategy == "pooled":
        raise ValueError("the pooled centralized baseline has no "
                         "federation to attack or robustly aggregate")
    sites = job.task.sites
    if resolve_codec(job.compression, "compression").name != "none":
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
    if job.shard_sites:
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
        if job.scheduler == "buffered":
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


def _validate_down(job: FederatedJob) -> None:
    """The robust clause of the reference's download-compression guards."""
    if resolve_codec(job.down_compression, "down_compression").name == "none":
        return
    if job.aggregator_spec.robust or job.adversary_plan is not None:
        raise ValueError(
            "robust aggregation rules and the adversary harness rank "
            "plaintext uploads against ONE shared broadcast; "
            "down_compression gives every site a different decoded "
            "install, so upload distances would mix honest quantization "
            "drift with attacker signal — use down_compression='none'")


class StackedTransport(Transport):
    """Single-process simulator: every site's state in one [S, N] buffer.
    A job with a codec in either direction takes the compressed rounds."""

    name = "stacked"

    def execute(self, job: FederatedJob, rounds: int, init_params=None,
                on_round=None) -> JobResult:
        _validate_robustness(job)
        _validate_down(job)
        scheduler = resolve_scheduler(job.scheduler)
        job.check_ported()
        codec, down_codec = job.codecs()
        from repro_torch.core import round_engine
        if codec.name != "none" or down_codec.name != "none":
            return round_engine.run_compressed(
                job, job.task.build(), scheduler, rounds, codec,
                down_codec=down_codec, init_params=init_params, on_round=on_round)
        return round_engine.run_sync(job, job.task.build(), scheduler, rounds,
                                     init_params=init_params, on_round=on_round)


def resolve_transport(spec) -> Transport:
    if isinstance(spec, Transport):
        return spec
    if spec == "stacked":
        return StackedTransport()
    raise NotPorted("transport", repr(spec), "'stacked'")
