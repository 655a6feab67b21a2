"""Federated training CLI, ported from ``repro/launch/train.py``.

A thin CLI over :class:`repro_torch.api.FederatedJob`: task construction,
strategy, dropout, checkpointing and the round loop all live in the job;
this module only maps arguments onto it.  The flags and defaults are the
reference's, plus ``--device`` (default: the card, as ``FederatedJob``;
``--device cpu`` runs on the CPU).  ``--dry-run`` resolves the job and
prints the reference's dict without training.  ``--task tokens`` (the
reference's default) trains next-token prediction of ``--arch`` (the
published width, or ``--reduced``'s CPU-sized variant) on ``--seq``-token
streams; an architecture the port has not got raises ``NotPorted("arch")``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --sites 3 --rounds 2 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --task tokens \
      --arch smollm-135m --sites 4 --batch 4 --seq 2048 --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --task dose \\
      --strategy fedavg --sites 4 --rounds 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --task dose \\
      --strategy gcml --sites 5 --rounds 20 --max-dropout 2 --device-data
  PYTHONPATH=src python -m repro_torch.launch.train --task seg --sites 64 \\
      --sample uniform:4 --dropout-scenario shutdown --shard-sites
  PYTHONPATH=src python -m repro_torch.launch.train --task dose --rounds 8 \\
      --checkpoint --out runs/a --ckpt-every 2 [--resume]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.api import FederatedJob, TaskConfig
from repro_torch.comms.transport import WireConfig
from repro_torch.core.session import BufferedScheduler


def run(args) -> dict:
    task = TaskConfig(
        kind=args.task, arch=args.arch, reduced=args.reduced,
        sites=args.sites, batch=args.batch, seq=args.seq,
        volume=(args.volume,) * 3, base_filters=args.base_filters,
        num_levels=args.num_levels,
        heterogeneity=args.het, seed=args.seed)
    # tests may force-quiet a parsed namespace by setting args.verbose
    verbose = getattr(args, "verbose", None)
    if verbose is None:
        verbose = not args.quiet
    scheduler = (BufferedScheduler(buffer_k=args.buffer_k)
                 if args.scheduler == "buffered" else args.scheduler)
    wire = WireConfig(secret=args.auth_secret, tls_cert=args.tls_cert,
                      tls_key=args.tls_key,
                      max_message_size=args.max_message_size)
    job = FederatedJob(
        task=task, strategy=args.strategy, rounds=args.rounds,
        local_steps=args.local_steps, lr=args.lr, prox_mu=args.prox_mu,
        max_dropout=args.max_dropout, dropout_scenario=args.dropout_scenario,
        sample=args.sample, shard_sites=args.shard_sites,
        transport=args.transport, scheduler=scheduler,
        topology=args.topology, pod_dropout=args.pod_dropout,
        compression=args.compression,
        down_compression=args.down_compression,
        error_feedback=not args.no_error_feedback,
        dp_clip=args.dp_clip, dp_noise_multiplier=args.dp_noise_multiplier,
        dp_delta=args.dp_delta, dp_mode=args.dp_mode,
        secure_agg=args.secure_agg, seed=args.seed,
        aggregator=args.aggregator, adversary=args.adversary,
        round_deadline_s=args.round_deadline_s,
        max_upload_norm=args.max_upload_norm,
        wire=wire, lease_ttl=args.lease_ttl,
        round_engine=args.round_engine, chunk_rounds=args.chunk_rounds,
        device_data=args.device_data,
        checkpoint_dir=str(Path(args.out) / "ckpt") if args.checkpoint else None,
        ckpt_every=args.ckpt_every, verbose=verbose,
        device=getattr(args, "device", None))
    if getattr(args, "dry_run", False):
        # resolve everything that could drift (transport/scheduler/codec
        # names, the task) but skip the training itself
        from repro_torch.api import resolve_transport
        from repro_torch.comms.compression import resolve_codec
        from repro_torch.core.session import resolve_scheduler
        topo = job.topo
        resolved = {
            "dry_run": True, "strategy": job.strategy,
            "task": job.task.kind, "sites": job.task.sites,
            "rounds": job.rounds,
            "transport": resolve_transport(job.transport).name,
            "scheduler": resolve_scheduler(job.scheduler).name,
            "topology": (f"pods:{topo.num_pods}" if topo.is_pods else "flat"),
            "pod_dropout": job.pod_dropout,
            "sample": job.sampler.spec,
            "shard_sites": job.shard_sites,
            "compression": resolve_codec(job.compression).name,
            "down_compression": resolve_codec(job.down_compression).name,
            "error_feedback": job.error_feedback,
            "round_engine": job.round_engine,
            "chunk_rounds": job.chunk_rounds,
            "device_data": job.device_data,
            "dp_clip": job.dp_clip,
            "dp_noise_multiplier": job.dp_noise_multiplier,
            "dp_delta": job.dp_delta, "dp_mode": job.dp_mode,
            "secure_agg": job.secure_agg,
            "aggregator": job.aggregator_spec.spec,
            "adversary": job.adversary,
            "round_deadline_s": job.round_deadline_s,
            "max_upload_norm": job.max_upload_norm,
            "auth": job.wire.secret is not None,
            "tls": job.wire.tls,
            "max_message_size": job.wire.max_message_size,
            "lease_ttl": job.lease_ttl,
            "resume": bool(getattr(args, "resume", False)),
        }
        print(json.dumps(resolved))
        return resolved
    res = job.run(resume=args.resume)
    result = {**res.to_dict(), "strategy": args.strategy}
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"train_{args.strategy}.json").write_text(
            json.dumps(result, indent=2))
    return result


def make_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--task", default="tokens", choices=["tokens", "dose", "seg"])
    ap.add_argument("--strategy", default="fedavg",
                    choices=["fedavg", "fedprox", "gcml", "individual", "pooled"])
    ap.add_argument("--sites", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=1, dest="local_steps")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--volume", type=int, default=16, metavar="D",
                    help="volume tasks (dose/seg): cubic volume edge "
                         "(D, D, D)")
    ap.add_argument("--base-filters", type=int, default=8,
                    dest="base_filters",
                    help="volume tasks: SA-Net channel width (shrink for "
                         "cross-device site counts)")
    ap.add_argument("--num-levels", type=int, default=2, dest="num_levels",
                    help="volume tasks: SA-Net encoder depth")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--prox-mu", type=float, default=0.01, dest="prox_mu")
    ap.add_argument("--het", type=float, default=0.0, help="non-IID heterogeneity")
    ap.add_argument("--max-dropout", type=int, default=0, dest="max_dropout")
    ap.add_argument("--dropout-scenario", default="disconnect",
                    choices=["disconnect", "shutdown"], dest="dropout_scenario")
    ap.add_argument("--sample", default="none", metavar="none|uniform:K|poisson:q",
                    help="cross-device client sampling: schedule only K "
                         "sites (uniform:K) or each site with probability "
                         "q (poisson:q) per round, Eq. 1 reweighted by "
                         "inclusion probability; composes with "
                         "--max-dropout by intersection")
    ap.add_argument("--shard-sites", action="store_true", dest="shard_sites",
                    help="stacked transport: shard the [S, N] site buffer "
                         "across the device mesh and train only the "
                         "sampled rows per round (cross-device scale; "
                         "fedavg/fedprox, sync, compression none/int8)")
    ap.add_argument("--transport", default="stacked",
                    choices=["stacked", "thread", "tcp"])
    ap.add_argument("--scheduler", default="sync", choices=["sync", "buffered"])
    ap.add_argument("--buffer-k", type=int, default=2, dest="buffer_k",
                    help="buffered scheduler: aggregate after K uploads")
    ap.add_argument("--topology", default="flat", metavar="flat|pods:K",
                    help="federation topology: flat star (default) or "
                         "pods:K — two-tier aggregation through K pod "
                         "servers and a root combiner")
    ap.add_argument("--pod-dropout", type=int, default=0, dest="pod_dropout",
                    metavar="N",
                    help="Algorithm-2 churn at the pod tier: up to N whole "
                         "pods offline at once (requires --topology pods:K)")
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "fp8", "topk", "topk-sparse",
                             "topk-fixed"],
                    help="quantize uploads (error-feedback deltas); "
                         "topk-fixed = constant-shape top-k that compiles "
                         "under the scan engine")
    ap.add_argument("--down-compression", default="none",
                    dest="down_compression",
                    choices=["none", "int8", "fp8", "topk-fixed"],
                    help="quantize downloads too: the server keeps per-site "
                         "error-feedback references and broadcasts each "
                         "global as a delta against what that site last "
                         "acknowledged (dense bootstrap on join/evict); "
                         "fedavg/fedprox, sync scheduler")
    ap.add_argument("--dp-clip", type=float, default=0.0, dest="dp_clip",
                    metavar="C",
                    help="DP-SGD: clip gradients to L2 norm C inside every "
                         "site update (0 = off)")
    ap.add_argument("--dp-noise-multiplier", type=float, default=0.0,
                    dest="dp_noise_multiplier", metavar="SIGMA",
                    help="DP-SGD: Gaussian noise stddev as a multiple of "
                         "the clip norm (needs --dp-clip > 0)")
    ap.add_argument("--dp-delta", type=float, default=1e-5, dest="dp_delta",
                    help="DP-SGD: the delta the accountant reports "
                         "epsilon at")
    ap.add_argument("--dp-mode", default="per-site", dest="dp_mode",
                    choices=["per-site", "per-example"],
                    help="DP-SGD clipping unit (per-site protects a whole "
                         "site's round contribution)")
    ap.add_argument("--secure-agg", action="store_true", dest="secure_agg",
                    help="mask uploads pairwise (fixed-point int64) so the "
                         "aggregation server only sees their sum; "
                         "thread/tcp transports, sync schedulers, "
                         "compression=none")
    ap.add_argument("--aggregator", default="fedavg",
                    metavar="fedavg|trimmed:f|median|krum:f|normclip:c",
                    help="robust site→global combine rule: coordinate-wise "
                         "trimmed mean / median, krum selection, or "
                         "per-upload L2 norm clipping (fedavg = Eq. 1 "
                         "weighted mean)")
    ap.add_argument("--adversary", default=None,
                    metavar="sign_flip:f|label_flip:f|scale:c:f|noise:s:f",
                    help="deterministic Byzantine harness: f seeded "
                         "malicious sites perturb what they expose to "
                         "aggregation (same sites and perturbations on "
                         "every transport)")
    ap.add_argument("--round-deadline-s", type=float, default=None,
                    dest="round_deadline_s", metavar="SECONDS",
                    help="socket transports: after this long with at least "
                         "one upload folded, close the sync barrier with "
                         "whoever arrived (stragglers are acked stale)")
    ap.add_argument("--max-upload-norm", type=float, default=None,
                    dest="max_upload_norm", metavar="C",
                    help="socket transports: reject uploads with L2 norm "
                         "above C (non-finite uploads are always rejected)")
    ap.add_argument("--no-error-feedback", action="store_true",
                    dest="no_error_feedback",
                    help="disable the client-side quantization residual")
    ap.add_argument("--round-engine", default="auto", dest="round_engine",
                    choices=["auto", "scan", "loop"],
                    help="stacked transport: the on-device rounds "
                         "(auto/scan) vs the host loops through the wire codec")
    ap.add_argument("--chunk-rounds", type=int, default=None,
                    dest="chunk_rounds", metavar="N",
                    help="the reference's rounds per compiled scan chunk "
                         "(accepted; the port's rounds are not chunked)")
    ap.add_argument("--device-data", action="store_true", dest="device_data",
                    help="draw the synthetic batches and each round's "
                         "inputs on the device (stacked transport; tokens, "
                         "and dose/seg without site_pools)")
    ap.add_argument("--dry-run", action="store_true", dest="dry_run",
                    help="resolve and print the job, skip training")
    ap.add_argument("--auth-secret", default=None, dest="auth_secret",
                    metavar="SECRET",
                    help="socket transports: require an HMAC hello token "
                         "over this shared job secret on every connection")
    ap.add_argument("--tls-cert", default=None, dest="tls_cert",
                    metavar="PEM", help="serve TLS with this certificate "
                                        "(clients pin it)")
    ap.add_argument("--tls-key", default=None, dest="tls_key", metavar="PEM",
                    help="private key for --tls-cert")
    ap.add_argument("--max-message-size", type=int, default=None,
                    dest="max_message_size", metavar="BYTES",
                    help="stream uploads larger than this in chunks "
                         "instead of one frame")
    ap.add_argument("--lease-ttl", type=float, default=None, dest="lease_ttl",
                    metavar="SECONDS",
                    help="elastic membership: expire sites silent for this "
                         "long into the round's dropout accounting")
    ap.add_argument("--resume", action="store_true",
                    help="re-enter a killed job from the newest usable "
                         "checkpoint under --out/ckpt (needs --checkpoint)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--checkpoint", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=10, dest="ckpt_every")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-round progress output")
    ap.add_argument("--device", default=None, metavar="cuda|cpu",
                    help="where the job runs (default: the card; raises "
                         "where CUDA is missing)")
    return ap


if __name__ == "__main__":
    run(make_parser().parse_args())
