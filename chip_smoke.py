#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. the card's name and power limit, then a build of every hand-written
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together), and the registers, shared memory and blocks an SM
   of each instance of ``flash_attention``, ``rwkv6_scan``, ``mamba_scan``,
   ``quantize_int8`` and ``dequantize_int8``;
2. each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at ragged ones, with stated tolerances, then its
   time beside its bound (fp32 attention's at the TF32 tensor-core rate,
   three products a flop), the plain version's time and, where one exists,
   one library call's time (CUDA events around a CUDA graph of the call
   site, median of 25 replays after a warm-up, so no host time is in
   them; the eager call site's time is kept as ``eager_ms``).
   ``dequantize_int8`` is timed as one launch over a full-width message
   (its 160 leaves), its library yardstick ``torch.mul`` leaf by leaf, and
   held to its plain version on 32 messages of ragged leaves laid out as
   payloads after headers of every length mod 16.
   ``quantize_int8``, ``dequantize_int8``, ``dequant_install`` and the
   residual of ``fedagg_dequant`` must be bit-equal to their plain
   versions, and the quantized values and scales equal to the numpy int8
   rule;
3. the first slice's path through the port's own entry point: a
   full-width SA-Net (11 channels, 24 filters, 4 levels, 128^3 OpenKBP
   volumes) trained by 4-site FedAvg for 2 sync rounds, with random
   weights from a seed, TF32 convolutions (the port's choice, as the
   reference's XLA on this card); then the same job with fp32 convolutions,
   each round's losses, their gap and ``step_s`` printed side by side;
4. this slice's path: the same job with int8 uploads and downloads
   (``compression="int8", down_compression="int8"``), with its exact
   byte counts per round and every kernel of the path launched in every
   round;
5. the wire codec: the full-width global model encoded for the wire as a
   site uploads it (the reference's layout; one ``quantize_int8`` launch a
   chunk width), held to the plain encoder on the reference's element
   order; its frame decoded three ways, bit-equal: grouped on the card
   (ONE ``dequantize_int8`` launch), leaf by leaf on the card, and the
   plain version (the first two timed eager); and a frame encoded on the
   CPU (align=1: odd widths, rows and scales off any alignment) decoded on
   the card in one launch, bit-equal to the plain version;
5b. this slice's path: the same full-width int8 job on the socket
   deployment (``transport="thread"``: four site threads on the card, real
   TCP round trips to the aggregation server on the card), held to the
   stacked int8 job of phase 4: payload bytes equal, globals within the
   reference's thread-vs-stacked bound (rtol 2e-3, atol 2e-4) but on at
   most 1e-5 of the elements (each within ``lr * rounds``: fold-order
   round-off that AdamW's next step amplifies), losses,
   ``wall_s``/``batch_s``/``step_s`` and peak memory printed, and ONE
   ``dequantize_int8`` launch for every int8 message decoded (uploads,
   downloads and the error-feedback updates at both ends); then the same
   job again, as the witness of that round-off, held the same way;
6. small jobs run on the card and on the CPU (the plain versions):
   uncompressed, int8 up only, int8 both ways and int8 down only;
   per-round losses must agree, and each side's bytes must be its own
   layout's; then a 2-site job on the tcp transport (one process a site),
   uncompressed and int8 both ways, the same way;
7. the third slice's path: the full-width job under Byzantine-robust
   aggregation (``aggregator="trimmed:1"``, one sign-flipping site,
   ``max_dropout=1``), with ``trimmed_mean`` launched once per round,
   ``fedagg`` once (the final global) and no int8 kernel.  Phase 2 holds
   ``trimmed_mean`` bit for bit to its plain version (NaN where it has
   NaN) over 9 site counts, 4 widths, up to 4 trim depths and 4 active patterns,
   with non-finite values in active and inactive rows, and at full width;
8. small robust jobs on the card and on the CPU (4 sites, ``max_dropout=1``,
   3 rounds, TF32 off): trimmed:1 + sign_flip:1, median + label_flip:1,
   krum:1 + scale:3:1 (the same rows picked on both sides), normclip with
   a binding clip, median + uniform:3 sampling, and int8 uploads +
   poisson:0.75 sampling; per-round losses and participants must agree;
11. the dose experiment (Figs 7-9) at full width (``OPENKBP_TASK``, TF32
   convolutions, 2 rounds): the pooled baseline (one site whose batch is
   the 4 sites' batches, a batch of 4 at 128^3) and the individual
   baseline (4 sites, ``comm`` None); ``fedagg`` once each (the final
   global, held to the plain fold of the final rows in every job of
   11-13; phase 2 holds ``fedagg``, ``trimmed_mean`` and the int8 kernels
   to their plain versions at these jobs' shapes too);
12. the strategy comparison on BraTS (Figs 11/12; ``BRATS_TASK``: 4 MRI
   channels, 4 classes, 6,840,300 parameters, the sites' case counts):
   fedavg, fedprox (``prox_mu=0.01``), fedprox with int8 both ways and
   fedprox under ``trimmed:1`` at 2 local steps, each with the exact
   launches its code implies (``run_seg_strategies`` states them), the
   FedProx anchor held to the broadcast rows and the global, fedprox's
   ``step_s`` beside fedavg's and its per-site losses equal to fedavg's
   (one local step from the anchor: the Eq. 2 term is 0);
13. gossip on PanSeg (Fig 15; ``PANSEG_TASK``: 1 channel, 2 classes, 5
   sites, 6,838,014 parameters): GCML without churn and with
   ``max_dropout=1`` under shutdown, each round's pairings and DCML
   losses printed, ``fedagg`` once (the final global);
14. small jobs of every strategy above (8^3, 4 filters, TF32 off) on the
   card and on the CPU: losses within ``JOB_RTOL``, masks, pairings and
   ``comm`` equal, the globals (and FedProx's anchors) within ``lr`` a
   local step and ``SMALL_MEDIAN_TOL`` at the median;
15. the serverless and private socket deployment at full width on the
   thread transport (``run_serverless_private`` states each check):
   PanSeg GCML through the ``CoordinationServer`` and direct pushes, dense
   (its global held to phase 13's stacked GCML by phase 5b's bound) and
   with int8 pushes (``quantize_int8`` once a chunk width a push,
   ``dequantize_int8`` twice a push; one push's decode bit-equal to the
   plain one, both kernels timed at this layout); BraTS FedProx with int8
   both ways (every anchor the install it was re-pinned to, bit for bit;
   payload bytes equal to phase 12's stacked job's); OpenKBP FedAvg with
   ``secure_agg`` (``privacy`` the reference's dict, the global held to
   the plain thread job's by phase 5b's bound, and the fixed point on the
   same inputs: the card's unmask bit-equal to the CPU's and within the
   fixed point's bound of the float64 mean, a dropped site repaired); each
   job's ``wall_s``/``batch_s``/``step_s``, peak and launches printed; then
   small tcp jobs of the three seams (8^3, 2 rounds) held to their thread
   twins;
16. two-tier pods and buffered rounds (``run_pods_and_buffered`` states
   each check): on the stacked transport at full width, ``pods:2`` FedAvg
   (its round-0 global and phase 3's flat one, from the same bits of
   trained rows, each within its fp32 rounding bound of the exact mean; the
   final global within phase 5b's bound of phase 3's; ``fedagg`` on [2, N]
   once a round), ``trimmed:1`` a pod with ``pod_dropout=1`` (a whole pod
   offline; ``trimmed_mean`` once a pod a round, held to the plain engine),
   int8 both ways in two tiers (``quantize_int8``, ``dequantize_int8`` and
   ``dequant_install`` bit-equal to their plain versions on the job's
   chunks; intra-pod bytes phase 4's), and buffered rounds (dense, int8 on
   the flat layout, int8 on the host loop: versions a host replay's, each
   global the plain fold of its last version's arrivals); on the thread
   transport ``pods:2`` int8, a buffered root, and secure aggregation at
   both tiers (each partial and global the fixed point of its inputs); then
   8^3 jobs on tcp and with a whole pod offline;
17. the fp8 and top-k codecs at full width (``run_codecs`` states each
   check): stacked FedAvg with fp8 both ways (the last round's fp8 qdq
   bit-equal to the CPU's at every chunk-width group, bytes the host
   formula's, ``fedagg`` twice a round, each fold within its fp32 bound),
   ``topk-fixed`` both ways (every leaf's kept entries, and a built tie
   leaf's, bit-equal to the CPU rule; round 0 dense), ``topk-sparse``
   uploads on the host loop against the ``topk-fixed`` scan (round 0 from
   the same bits, deterministic cuDNN; the wire's kept entries the
   twin's), the thread transport with fp8 uploads and ``topk-fixed``
   downloads (every decode on the card bit-equal to the host's; held to
   its stacked twin), int8 uploads with fp8 downloads (the int8 kernels'
   launches), and the fp8 qdq and top-k selection timed as plain PyTorch
   call sites beside their bytes bound;
18. checkpoint and resume, DP-SGD and the noise attack at full width
   (``run_resume_and_dp`` states each check): one (site, step) DP noise
   draw of the full model on the card against the CPU's (subkeys and
   uniforms bit-equal, normals within 4 ulp; the plain draw timed beside
   its bytes bound); DP-SGD FedAvg (per-site, C 0.5, sigma 0.8, 4 rounds)
   killed after 3 rounds and resumed from round 2, and the same with int8
   both ways, each resumed round bit-equal to the uninterrupted run's
   (deterministic cuDNN), ``comm`` one round's, ``privacy`` the
   accountant's epsilon for 4 rounds, the resumed round's launches exact;
   ``noise:0.5:1`` under ``trimmed:1`` (each perturbed row the CPU's draw);
   the thread transport with DP, held to the stacked job's first two
   rounds by phase 5b's bound; then 8^3 resumes, refusals and DP jobs on
   the card and the CPU;
19. on-device batches, the sharded simulator and the training CLI
   (``run_p19`` states each check): 4-site FedAvg at full width with
   ``shard_sites=True`` against the same job dense (deterministic cuDNN;
   globals by phase 5b's fold-noise rule, losses rtol 1e-4, bytes equal,
   ``fedagg`` a round and a device counted); 64 sites under ``uniform:4``
   and shutdown, plain and int8 (the never-sampled rows frozen bit for
   bit, the last round's participants the round's global, ``k_cap`` the
   packed maximum, ``quantize_int8``/``dequantize_int8`` once a chunk width
   a round); ``device_data=True`` on OpenKBP with ``max_dropout=1`` and on
   BraTS (a case drawn on the card against the CPU: masks and labels bit
   for bit, CT and the volume within 4 ulp, the dose within its stated
   bound; the Algorithm-2 chain card == CPU; the draw's ``batch_s``
   beside phase 3's host ``batch_s``); then 8^3 jobs: the seven
   sharded-vs-dense cases, ``device_data`` with GCML, FedProx, pods and
   DP card vs CPU, a resume, the refusals, a thread job that ignores
   ``device_data``, and ``launch/train.py`` on the card;
9. the fourth slice's paths: serving the token models at full width
   through ``launch/serve.py`` (prefill, then greedy decode, fp32
   weights from a seed, TF32 off): gemma3-1b (26 layers, 4 x 1024
   prompts, 32 steps) and rwkv6-7b (32 layers, 4 x 512, 32 steps)
   through ``run()``, and Jamba-1.5-Large cut to 2 layers (Mamba +
   dense FFN, Mamba + MoE; 2 x 512, 16 steps) through ``generate()``.
   Each prefill must launch its kernel once a layer (``flash_attention``
   26 times, ``rwkv6_scan`` 32, ``mamba_scan`` 2), each decode none of
   the three, and every logit must be finite.  Phase 2 holds the three
   kernels to their plain versions at ragged shapes and at these paths'
   full-width shapes (the scans' final states too; ``mamba_scan`` with a
   row of A for each channel, at every threads-a-channel instance, its bound
   the larger of bytes and the operations: the fp32 instructions its SASS
   shows with one exp an entry, on the special-function unit or as a
   software exp2 on the fp32 lanes, whichever balances the two);
10. the first five reduced token configs served on the card and on the CPU
   (the plain versions) from the same seeded weights and prompts, TF32
   off: the greedy tokens must be equal and the logits within
   rtol=atol=1e-4;
20. the fourteenth slice's path, the token task's training: (a) the
   attention backward (``flash_attention_bwd``, three fp32 kernels) alone
   against its plain version at ragged shapes and smollm-135m's (q [4, 9,
   2048, 64], k/v [4, 3, 2048, 64], causal), two launches bit-equal, the
   forward's ``lse`` held to its plain version and its output bit-equal to
   the serving call's, then timed beside its bound (five products of 2 D
   flops a seen pair at the fp32 rate), the plain backward and SDPA's
   backward alone; (b) smollm-135m at its published width trained by
   4-site FedAvg for 2 rounds through ``FederatedJob.run`` (4 x 2048 tokens
   a site step, random weights from a seed, fp32 matmuls): every leaf of
   every site step has a gradient, 30 forward and 30 backward launches a
   site step, then one site step's gradient held to the plain versions'
   on the card, wq/wk/wv named; (c) small token jobs card vs CPU (stacked,
   ``device_data``, thread, int8 both ways, per-example DP) and a resume
   bit-equal on the card;
21. the sixteenth slice's path, the scans' gradients (``run_p21`` states
   each check): (a) the WKV-6 backward (``rwkv6_scan_bwd``) alone against
   its plain version at ragged shapes (L 0, 1 and not a multiple of the
   16-step checkpoint stage, D 32 and 64, w near 0 and near 1, a non-zero
   final-state gradient) and at 21c's shape ([2, 64, 1024, 64]), two
   launches bit-equal, the forward's output and state with checkpoints
   bit-equal to the serving call's, its resources printed (the cluster's
   blocks and how many clusters the card holds at once too), then timed
   beside its bound (bytes) and the plain backward; (b) the
   selective-scan backward (``mamba_scan_bwd``) the same way, at every
   d_state instance, with dt large enough that exp(dt A) underflows, and
   at Jamba's [2, 512, 16384] x 16, its walk and its partials' sum also
   timed apart; (c) rwkv6-7b at its published width,
   depth cut to 2 layers, trained by 2-site FedAvg for 2 rounds through
   ``FederatedJob.run`` (2 x 1024 tokens a site step, fp32 matmuls): every
   leaf of every site step has a gradient, each scan kernel launched once
   a layer a site step, then one site step's gradient held to the plain
   versions' on the card, w_r/w_k/w_v/u named; (d) Jamba-1.5-Large cut to
   its first layer (Mamba + dense) at full width, one site step's gradient
   held the same way, ``mamba_scan_bwd`` launched once; (e) reduced
   rwkv6-7b and Jamba jobs card vs CPU (stacked FedAvg, per-example DP),
   and C9: a full-width gemma3-1b token job (head dim 256) passes
   ``check_ported`` on the card, its bf16 gradient passes
   ``ops.check_backward_instances`` (since the twentieth slice), and its
   config at head dim 96 is refused by it
   (``NotPorted("flash_attention_bwd")``) before any kernel is built or
   launched and before any batch is drawn;
22. the eighteenth slice's path, gemma3-1b's training (``run_p22`` states
   each check): (a) the attention backward's head-dim-256 instance (a
   cluster of four blocks splitting D) alone against its plain version at
   ragged shapes (Lq < Lk, windows inside and across tiles, GQA 4:1 and
   8:2, both masks, B 1-3) and at gemma3-1b's training shape (q [2, 4,
   1024, 256], k/v [2, 1, 1024, 256]) with its 512-key window and without,
   two launches bit-equal, the forward's ``lse`` held to its plain version,
   its resources printed, then timed at both shapes beside its bound, the
   plain backward and SDPA's backward alone; (b) gemma3-1b at its
   published width trained by 2-site FedAvg for 2 rounds through
   ``FederatedJob.run`` (2 x 1024 tokens a site step, fp32 matmuls): every
   leaf of every site step has a gradient, 26 forward and 26 backward
   launches a site step, ``step_s``, ``batch_s`` and the peak printed; (c)
   one site step's gradient held to the plain versions' on the card,
   wq/wk/wv named; (d) a small gemma-shaped job (the reduced config at head
   dim 256) card vs CPU;
23. the nineteenth slice's path, the remaining token configs served
   (``run_p23`` states each check): (a) ``flash_attention`` on MLA's
   padded route at DeepSeek-V2's prefill shape (q/k [2, 128, 512, 192], v
   [..., 128], padded to the D 256 instance) held to the plain unpadded
   ``sdpa`` at scale 192^-0.5 under ``FLASH_TOL``, timed beside the true
   work's bound and the padded work's, the plain version and SDPA, then
   at each of (c)'s configs' per-layer prefill shapes (batch, heads, kv
   heads, prompt length, head dim) held to the plain version; (b)
   DeepSeek-V2 at its published width cut to 2 layers (MLA + dense FFN,
   MLA + 160 routed and 2 shared experts), 2 x 512 prompts + 16 greedy
   steps with each MoE form (``dense``, ``gather``, ``dispatch``),
   ``flash_attention`` twice a prefill and never in decode, ``gather``'s
   logits held to ``dense``'s, and on layer 1's real input the no-drop
   ``dispatch`` held to ``moe_apply``; (c) granite-3-2b (40 layers) and
   musicgen-medium (48) at full depth, qwen3-moe-30b-a3b and chameleon-34b
   cut to 8 layers, through ``serve.run``, once a layer in prefill and
   never in decode, qwen3-moe's ``gather`` held to ``dense``; (d) the
   five reduced configs card vs CPU as phase 10; (e) a reduced deepseek
   token job card vs CPU (MLA's padded D 32 gradient) and the full-width
   deepseek job through ``check_ported``;
24. the twentieth slice's path, the reference's precision policy through
   ``repro_torch.launch.steps`` (``run_p24`` states each check): (a) the
   bf16 attention kernels on ``wgmma`` (``flash_attention_bf16``,
   ``flash_attention_bwd_bf16``): their resources and the HGMMA
   instructions of each ``__global__``, the forward's lse within 1e-5 of
   its plain version and its out bit-equal to the serving call's, the
   backward alone against its plain version on the same bf16 inputs at
   ragged shapes and at
   smollm-135m's, gemma3-1b's (global and its 512-key window) and
   DeepSeek-V2's MLA at its own (192, 128), unpadded, within one bf16 ulp of
   the largest value, two launches bit-equal, timed beside its bound (bf16
   bytes, the bf16 tensor-core rate), the plain backward, the fp32 instance,
   SDPA's bf16 backward (the 3xTF32 design's recorded time printed beside),
   and the forward at gemma3-1b's, smollm's and MLA's prefill shapes within
   2e-2 of its plain version, beside SDPA in bf16 (and the recorded time);
   (b) every token architecture served in bf16 at its published width
   (``SERVE_CUTS``' depths): prefill_32k, decode_32k and long_500k where
   ``is_skipped`` allows, prefill seconds, decode tok/s and the peak, the
   logits held to the fp32 serve of the same bf16-valued weights; (c)
   every token architecture trained at its published width in its own
   policy (``mixed``; ``bf16_train`` for DeepSeek-V2 and Jamba) with
   microbatches and remat at train_4k's 4096 tokens (``TRAIN_CUTS``'
   depths, sites and microbatches), losses and parameters finite, the bf16
   backward launched once an attention layer a microbatch, ``step_s`` and
   the peak; (d) a reduced mixed round card vs CPU.  The second-to-last
   line's ``flash_attention_bf16`` and ``flash_attention_bwd_bf16`` count
   their launches on (b)'s prefills and (c)'s steps.

Phases 11-19 run after phase 8, before 9; phases 20-24 after 10.  Every
kernel's launch count is zeroed just before each of phases 3-5b, 7, each
path of 9 and each full-width job or served run of 11-13 and 15-24, and
read just after; each of 11-24 prints its seconds.  The second-to-last line is a
JSON object with one entry per kernel; the last line is ``{"ok": true,
"device": {...}}``.  Without
CUDA, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

ROUNDS = 2
FULL_N = 6_844_323                       # full-width SA-Net parameter count
BRATS_N = 6_840_300                      # SANET_SEG's parameter count (the reference's)
PANSEG_N = 6_838_014                     # SANET_OAR's
INT8_BYTES = 6_900_148                   # one model, int8, the card's layout
DENSE_BYTES = 4 * FULL_N                 # one model, fp32
FP32_TOL = dict(rtol=1e-6, atol=1e-6)    # FMA contraction and sum order differ
BF16_TOL = dict(rtol=2e-2, atol=2e-2)    # one bf16 rounding of the output
JOB_RTOL = 1e-4                          # card vs CPU losses, TF32 off
# Published peaks (NVIDIA data sheets, dense): memory bytes/s, fp32
# (non-tensor-core) FLOP/s and TF32 tensor-core FLOP/s, by the name
# torch.cuda reports.
PEAKS = {"H100 80GB HBM3": (3.35e12, 67e12, 495e12), "H100 PCIe": (2.0e12, 51e12, 378e12),
         "H100 NVL": (3.9e12, 60e12, 417.5e12), "H200": (4.8e12, 67e12, 495e12)}
# ragged shapes for the int8 kernels: sites x chunk rows x chunk width
# (width 4: the narrowest 16-byte row; 1028: wider than the register path's
# 1024), and one row count that takes more than one grid-stride pass
RAGGED = [(s, rows, c) for s in (1, 3, 4) for rows in (1, 7, 6_797)
          for c in (1, 4, 127, 640, 1024, 1028)] + [(2, 20_000, 4), (1, 40_000, 128)]
# the trimmed mean: site counts (every register width and the shared-memory
# path) and widths (one column, odd, a multiple of 128, many blocks)
TRIM_SITES = (1, 2, 3, 4, 5, 8, 17, 33, 64)
TRIM_WIDTHS = (1, 127, 128, 65_537)
INT8_KERNELS = ("quantize_int8", "dequantize_int8", "fedagg_dequant", "dequant_install")
TOKEN_KERNELS = ("flash_attention", "flash_attention_bf16", "rwkv6_scan", "mamba_scan")
# flash attention: (batch, q heads, kv heads, Lq, Lk, D, causal, window), ragged
# (no Lq a multiple of any tile), GQA groups 1, 2, 3, 4 and 8, windows
# None/17/45/512, both masks; Lq <= 16 against Lk >= 600 (the group's packed
# rows fill one block), a window edge inside a 32-key stage
FLASH_CASES = [(1, 2, 2, 1, 1, 32, True, None), (2, 4, 2, 37, 37, 32, True, 17),
               (1, 6, 2, 45, 70, 64, True, None), (3, 4, 1, 70, 99, 64, False, None),
               (1, 3, 1, 33, 600, 128, True, 512), (2, 8, 2, 129, 129, 128, False, 17),
               (1, 4, 1, 200, 530, 256, True, 17), (1, 4, 4, 531, 531, 256, True, 512),
               (2, 4, 1, 77, 77, 256, False, 512), (1, 9, 3, 50, 50, 64, True, None),
               (2, 16, 2, 77, 90, 128, True, None), (1, 8, 1, 100, 100, 256, True, 64),
               (1, 4, 1, 16, 640, 256, True, None), (2, 8, 1, 9, 700, 64, True, 300),
               (1, 8, 2, 150, 180, 64, True, 45)]
GEMMA_ATTN = (4, 4, 1, 1024, 1024, 256)           # gemma3-1b's prefill, per layer
# the scans: (batch, heads, L, D) and (batch, L, d_inner, d_state), ragged
# the scans' L: 0, 1, and none a multiple of rwkv6_scan's 16-step stage but 0;
# D 32 with many heads
RWKV_CASES = [(1, 1, 1, 32), (1, 2, 0, 64), (2, 3, 13, 32), (1, 5, 77, 64), (3, 2, 300, 64),
              (2, 40, 45, 32), (1, 64, 100, 32)]
RWKV_FULL = (4, 64, 512, 64)                       # rwkv6-7b's prefill, per layer
# mamba: every threads-a-channel instance (d_state 4, 8, 16, 32, and 5, 12, 20
# between them), d_inner a multiple of 4 (16-byte copies) and not (4-byte),
# and not a multiple of any instance's channels a block (32, 64); L not a
# multiple of the 16-step stage, and 0, 1, 16, 48 (exact stages)
MAMBA_CASES = [(1, 1, 5, 4), (2, 13, 24, 8), (1, 77, 300, 16), (3, 40, 1000, 16),
               (2, 33, 130, 32), (2, 0, 64, 16), (1, 16, 100, 4), (2, 48, 36, 8),
               (1, 70, 68, 32), (2, 100, 4100, 16), (1, 45, 77, 5), (2, 19, 200, 12),
               (1, 33, 44, 20)]
MAMBA_FULL = (2, 512, 16384, 16)                   # Jamba-1.5-Large's prefill, per layer
# the fewest fp32 instructions an exp2 costs off the special-function unit:
# round, reduce, a degree-5 polynomial, the exponent's add (the mamba_scan
# bound lets the exps run on either unit)
SOFT_EXP2_INSTRUCTIONS = 8
# flash attention fp32: the softmax over up to 1024 keys runs in tiles with
# rescaling, against one softmax in the plain version (exp and sums differ)
FLASH_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_RTOL = 1e-5    # fp32 recurrences; atol 1e-5 of the plain version's largest value:
                    # each output sums D or ds terms in another order, with FMA
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)             # card vs CPU logits, TF32 off
SMALL_ARCHS = ("gemma3-1b", "smollm-135m", "qwen3-8b", "rwkv6-7b", "jamba-1.5-large-398b",
               "deepseek-v2-236b", "qwen3-moe-30b-a3b", "granite-3-2b", "chameleon-34b",
               "musicgen-medium")


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise SystemExit(f"chip_smoke: no published peak rates for {name!r}")


def _median_ms(run, reps: int) -> float:
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def time_ms(fn, warmup: int = 3, reps: int = 25):
    """(device ms, eager ms) of one call of ``fn``: the median of ``reps``
    replays of ``fn`` captured as a CUDA graph, so no host time is in it,
    and the median of ``reps`` eager calls, whose launch costs on the host
    are in it where they exceed the device time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _median_ms(graph.replay, reps), _median_ms(fn, reps)


def measure(torch, name, kernel, plain, library, nbytes: int, flops: int,
            tf32_products: int = 0, ops_ms: float | None = None) -> dict:
    """Device times of one call site (``kernel``/``plain``/``library`` take
    no arguments) beside the bound for ``nbytes`` moved and ``flops`` done:
    at the fp32 rate outside the tensor cores, or, with ``tf32_products``,
    as that many TF32 products of each flop at the tensor cores' TF32 rate;
    ``ops_ms``, where given, is the operations bound itself, reckoned by the
    caller for work that is not all fp32 flops.
    ``eager_ms`` is the kernel's call site with the host in it."""
    mem_rate, fp32_rate, tf32_rate = peaks(torch.cuda.get_device_name(0))
    if tf32_products:
        ops_rate, unit = tf32_rate / tf32_products, f"{tf32_products} TF32 products a flop"
    else:
        ops_rate, unit = fp32_rate, "fp32 outside the tensor cores"
    bytes_ms = 1e3 * nbytes / mem_rate
    if ops_ms is None:
        ops_ms = 1e3 * flops / ops_rate
        ops_what = f"{flops / 1e9:.2f} GFLOP at {ops_rate / 1e12:.1f} TFLOP/s ({unit})"
    else:
        ops_what = "the operations reckoned above"
    bounds = {"bytes": bytes_ms, "operations": ops_ms}
    bound_by = max(bounds, key=bounds.get)
    print(f"{name}: bound by {bound_by}: "
          f"{bytes_ms:.4f} ms for {nbytes / 1e6:.1f} MB at {mem_rate / 1e12:.2f} TB/s, "
          f"{ops_ms:.4f} ms for {ops_what}")
    ms, eager_ms = time_ms(kernel)
    out = {"ms": ms, "plain_ms": time_ms(plain)[0],
           "library_ms": time_ms(library)[0] if library is not None else None,
           "bound_ms": bounds[bound_by], "bound_by": bound_by, "eager_ms": eager_ms}
    lib = "none" if out["library_ms"] is None else f"{out['library_ms']:.4f} ms"
    print(f"{name}: kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}), plain {out['plain_ms']:.4f} ms, "
          f"library {lib}")
    return out


def check_fedagg(torch, fedagg, ref, dev) -> dict:
    """fedagg vs its plain version; returns its entry of the kernels line.
    The full-width cases are the paths' shapes: 4 OpenKBP and 4 BraTS
    sites, the pooled baseline's one row, a socket FedProx site's BraTS
    anchor (one row), GCML's 5 PanSeg sites and the cross-pod combine's two
    pods (its second at weight 0: a pod offline).  Returns the [4, N] time
    and, under ``pods_2``, the [2, N] one."""
    gen = torch.Generator(device=dev).manual_seed(0)
    full = [(4, FULL_N), (1, FULL_N), (4, BRATS_N), (1, BRATS_N), (5, PANSEG_N), (2, FULL_N)]
    cases = full + [(s, n) for s in (1, 3, 16) for n in (1, 127, 65_537)]
    err32 = 0.0
    for s, n in cases:
        w = torch.rand(s, device=dev, generator=gen)
        if s > 1:
            w[1] = 0.0                  # an inactive site's zero-weight row
        w = (w / w.sum()).contiguous()
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            x = torch.randn(s, n, device=dev, generator=gen).to(dtype)
            out = fedagg.fedagg_cuda(x, w)
            torch.cuda.synchronize()
            want = ref.fedagg_ref(x, w)
            torch.testing.assert_close(out.float(), want.float(), **tol)
            err = float((out.float() - want.float()).abs().max())
            if dtype == torch.float32:
                err32 = max(err32, err)
            if (s, n) in full:
                print(f"fedagg [{s}, {n}] {dtype}: max |kernel - plain| = {err:.3e}")
    print(f"fedagg: {len(cases)} shapes x 2 dtypes agree with the plain version "
          f"(fp32 rtol=atol=1e-6, bf16 rtol=atol=2e-2)")
    x = torch.randn(4, FULL_N, device=dev, generator=gen)
    w = torch.full((4,), 0.25, device=dev)
    timing = measure(torch, f"fedagg [4, {FULL_N}] fp32", lambda: fedagg.fedagg_cuda(x, w),
                     lambda: ref.fedagg_ref(x, w), lambda: torch.matmul(w, x),
                     nbytes=(x.numel() + w.numel() + FULL_N) * 4, flops=2 * x.numel())
    x2, w2 = x[:2].contiguous(), torch.tensor([0.75, 0.25], device=dev)
    pods = measure(torch, f"fedagg [2, {FULL_N}] fp32 (the cross-pod combine)",
                   lambda: fedagg.fedagg_cuda(x2, w2), lambda: ref.fedagg_ref(x2, w2),
                   lambda: torch.matmul(w2, x2), nbytes=(x2.numel() + 2 + FULL_N) * 4,
                   flops=2 * x2.numel())
    return {"max_abs_err": err32, **timing, "pods_2": pods}


def _int8_inputs(torch, dev, s, rows, c, gen):
    """u [S, rows, c] like a site delta, with a zero chunk (the MIN_SCALE
    floor); weights [S] with a zero-weight row; base [S, rows, c]."""
    u = torch.randn(s, rows, c, device=dev, generator=gen) * 0.05
    u[0, 0] = 0.0
    w = torch.rand(s, device=dev, generator=gen)
    if s > 1:
        w[1] = 0.0
    w = (w / w.sum()).contiguous()
    return u, w, torch.randn(s, rows, c, device=dev, generator=gen)


def _numpy_int8(x):
    import numpy as np
    s = np.maximum(np.max(np.abs(x), axis=1) / np.float32(127.0),
                   np.float32(1e-12)).astype(np.float32)
    return np.clip(np.rint(x / s[:, None]), -127, 127).astype(np.int8), s


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def check_int8_kernels(torch, plan, layout, dev, seg_plan) -> dict:
    """The four int8 kernels vs their plain versions at the ragged shapes
    and the full-width chunk groups of OpenKBP's SA-Net (``plan``, also the
    timed shapes) and BraTS's (``seg_plan``); returns their kernels-line
    entries."""
    import numpy as np
    from repro_torch.kernels import fedagg as fk
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(1)
    full = [(4, rows, width) for width, rows, _ in plan.groups]
    seg = [(4, rows, width) for width, rows, _ in seg_plan.groups]
    err = {"quantize_int8": 0.0, "dequantize_int8": 0.0, "fedagg_dequant": 0.0,
           "dequant_install": 0.0}
    for s, rows, c in RAGGED + full + seg:
        u, w, base = _int8_inputs(torch, dev, s, rows, c, gen)
        x = u.view(s * rows, c)
        q, sc = qk.quantize_int8_cuda(x)
        deq = qk.dequantize_int8_cuda(q, sc)
        q3, sc2 = q.view(s, rows, c), sc.view(s, rows)
        g, r = fk.fedagg_dequant_cuda(q3, sc2, u, w)
        inst = fk.dequant_install_cuda(q3, sc2, base)
        torch.cuda.synchronize()
        q_ref, sc_ref = ref.quantize_int8_ref(x)
        deq_ref = ref.dequantize_int8_ref(q, sc)
        g_ref, r_ref = ref.fedagg_dequant_ref(q3, sc2, u, w)
        inst_ref = ref.dequant_install_ref(q3, sc2, base)
        for name, diffs in (("quantize_int8", (q.int() - q_ref.int(), sc - sc_ref)),
                            ("dequantize_int8", (deq - deq_ref,)),
                            ("fedagg_dequant", (g - g_ref, r - r_ref)),
                            ("dequant_install", (inst - inst_ref,))):
            err[name] = max([err[name]] + [float(d.abs().max()) for d in diffs])
        where = f"[{s}, {rows}, {c}]"
        _require(torch.equal(q, q_ref) and torch.equal(sc, sc_ref),
                 f"quantize_int8 {where} differs from its plain version")
        q_np, sc_np = _numpy_int8(x.cpu().numpy())
        _require(np.array_equal(q.cpu().numpy(), q_np)
                 and np.array_equal(sc.cpu().numpy(), sc_np),
                 f"quantize_int8 {where} differs from the numpy int8 rule")
        _require(float(sc[0]) == float(np.float32(1e-12)), "zero chunk: scale not the floor")
        _require(torch.equal(deq, deq_ref), f"dequantize_int8 {where} differs from its plain version")
        _require(torch.equal(r, r_ref),
                 f"fedagg_dequant residual {where} differs from its plain version")
        torch.testing.assert_close(g, g_ref, **FP32_TOL)
        _require(torch.equal(inst, inst_ref), f"dequant_install {where} differs from its plain version")
    # rows off a 16-byte boundary take the kernel's generic path
    width, rows = full[0][2], full[0][1]
    x = (torch.randn(rows * width + 1, device=dev, generator=gen) * 0.05)[1:].view(rows, width)
    q, sc = qk.quantize_int8_cuda(x)
    q_ref, sc_ref = ref.quantize_int8_ref(x)
    where = f"quantize_int8 [{rows}, {width}] off a 16-byte boundary"
    _require(x.data_ptr() % 16 != 0, f"{where}: the view is on a 16-byte boundary")
    _require(torch.equal(sc, sc_ref), f"{where}: scales differ from its plain version")
    _require(torch.equal(q, q_ref), f"{where}: q differs from its plain version")
    print(f"int8 kernels: {len(RAGGED)} ragged shapes and {len(full)} OpenKBP and "
          f"{len(seg)} BraTS full-width chunk groups agree with the plain versions (bit-equal; fedagg_dequant's g "
          f"rtol=atol=1e-6, max |err| {err['fedagg_dequant']:.3e}) and the numpy rule")

    # times at the full-width path's shapes: one call site runs every group
    mats = [_int8_inputs(torch, dev, s, rows, c, gen) for s, rows, c in full]
    xs = [u.view(-1, u.shape[-1]) for u, _, _ in mats]
    qs = [qk.quantize_int8_cuda(x) for x in xs]
    q3s = [(q.view(u.shape), sc.view(u.shape[:2])) for (q, sc), (u, _, _) in zip(qs, mats)]
    elems = sum(x.numel() for x in xs)
    rows_all = sum(x.shape[0] for x in xs)
    n_out = sum(u.shape[1] * u.shape[2] for u, _, _ in mats)
    out = {}
    out["quantize_int8"] = measure(
        torch, f"quantize_int8 x{len(xs)} groups [{elems} elements]",
        lambda: [qk.quantize_int8_cuda(x) for x in xs],
        lambda: [ref.quantize_int8_ref(x) for x in xs], None,
        nbytes=elems * 5 + rows_all * 4, flops=6 * elems)
    out["fedagg_dequant"] = measure(
        torch, f"fedagg_dequant x{len(xs)} groups [{elems} site-elements]",
        lambda: [fk.fedagg_dequant_cuda(q, sc, u, w) for (q, sc), (u, w, _) in zip(q3s, mats)],
        lambda: [ref.fedagg_dequant_ref(q, sc, u, w) for (q, sc), (u, w, _) in zip(q3s, mats)],
        None, nbytes=elems * 9 + rows_all * 4 + n_out * 4 + 16 * len(xs), flops=4 * elems)
    out["dequant_install"] = measure(
        torch, f"dequant_install x{len(xs)} groups [{elems} site-elements]",
        lambda: [fk.dequant_install_cuda(q, sc, b) for (q, sc), (_, _, b) in zip(q3s, mats)],
        lambda: [ref.dequant_install_ref(q, sc, b) for (q, sc), (_, _, b) in zip(q3s, mats)],
        lambda: [torch.addcmul(b, q, sc[..., None]) for (q, sc), (_, _, b) in zip(q3s, mats)],
        nbytes=elems * 9 + rows_all * 4, flops=2 * elems)
    err["dequantize_int8"] = max(err["dequantize_int8"], check_grouped_dequant(torch, dev))
    # one full-width message in the card's layout: every leaf, one grouped
    # launch; the library yardstick multiplies leaf by leaf (no one PyTorch
    # call decodes leaves of several widths)
    from repro_torch.comms.compression import WirePlan
    wp = WirePlan.of(layout, 1024, 128, dev, port=True)
    _, q_all, s_all = wp.encode(torch.randn(layout.n, device=dev, generator=gen) * 0.05)
    qb, sb = q_all.view(torch.uint8), s_all.view(torch.uint8)
    host_table = torch.from_numpy(wp.table.host)
    leaves = [(q_all[qo: qo + rows * width].view(rows, width), s_all[ro: ro + rows])
              for qo, ro, rows, width in wp._places]
    got = qk.dequantize_int8_grouped_cuda(wp.table, qb, sb, torch.empty(layout.n, device=dev))
    torch.cuda.synchronize()
    want = ref.dequantize_int8_grouped_ref(host_table, qb, sb, torch.empty(layout.n, device=dev))
    per_leaf = torch.cat([qk.dequantize_int8_cuda(q, sc).reshape(-1)[: int(np.prod(sh))]
                          for (q, sc), sh in zip(leaves, wp.wire.shapes)])
    _require(torch.equal(got, want) and torch.equal(got, per_leaf),
             "dequantize_int8 grouped full-width message differs from its plain version "
             "or from the per-leaf launches")
    err["dequantize_int8"] = max(err["dequantize_int8"], float((got - want).abs().max()))
    out["dequantize_int8"] = measure(
        torch, f"dequantize_int8 one message [{wp.table.leaves} leaves, "
        f"{wp.table.total_rows} rows, {layout.n} values]",
        lambda: qk.dequantize_int8_grouped_cuda(wp.table, qb, sb, got),
        lambda: ref.dequantize_int8_grouped_ref(host_table, qb, sb, want),
        lambda: [torch.mul(q, sc[:, None]) for q, sc in leaves],
        nbytes=wp.table.nbytes(), flops=layout.n)
    return {name: {"max_abs_err": err[name], **out[name]} for name in out}


def _bits_equal(torch, a, b) -> bool:
    """Bit for bit, with NaN (of any payload) exactly where ``b`` has NaN."""
    nan = b.isnan()
    return (torch.equal(a.isnan(), nan)
            and torch.equal(torch.where(nan, 0.0, a).view(torch.int32),
                            torch.where(nan, 0.0, b).view(torch.int32)))


def _trim_cases(torch, dev, s, n, gen):
    """[S, N] fp32 with NaN and +-inf in active and inactive rows, and the
    active patterns: all, one inactive, one active (k = 1), none (k = 0)."""
    x = torch.randn(s, n, device=dev, generator=gen) * 3.0
    if n >= 8:
        x[0, 0] = float("nan")
        x[s - 1, 1] = float("inf")
        x[0, 2] = -float("inf")
        x[s // 2, 3] = float("nan")        # inactive in the one-inactive pattern
        x[:, 4] = float("inf")
        if s > 1:
            x[1, 5] = -float("inf")
            x[1, 6] = float("nan")
    one = torch.ones(s, device=dev)
    one[s // 2] = 0.0
    k1 = torch.zeros(s, device=dev)
    k1[s - 1] = 1.0
    return x, (torch.ones(s, device=dev), one, k1, torch.zeros(s, device=dev))


def check_trimmed_mean(torch, dev) -> dict:
    """trimmed_mean (and the median, f = S) vs its plain version, bit for
    bit, at ragged shapes and at full width (OpenKBP's and BraTS's 4 sites);
    returns its kernels-line entry."""
    from repro_torch.kernels import ref, robust
    gen = torch.Generator(device=dev).manual_seed(2)
    err, cases = 0.0, 0
    full = [(4, FULL_N), (4, BRATS_N)]
    shapes = [(s, n) for s in TRIM_SITES for n in TRIM_WIDTHS] + full
    for s, n in shapes:
        x, patterns = _trim_cases(torch, dev, s, n, gen)
        depths = sorted({0, 1, 2, s}) if (s, n) not in full else [1, s]
        for a in patterns if (s, n) not in full else patterns[:2]:
            for f in depths:
                out = robust.trimmed_mean_cuda(x, a, f)
                torch.cuda.synchronize()
                want = ref.trimmed_mean_ref(x, a, f)
                finite = want.isfinite() & out.isfinite()
                err = max(err, float((out - want)[finite].abs().max()) if finite.any() else 0.0)
                _require(_bits_equal(torch, out, want),
                         f"trimmed_mean [{s}, {n}] f={f} active={a.tolist() if s < 9 else int(a.sum())}"
                         " differs from its plain version")
                cases += 1
    print(f"trimmed_mean: {cases} cases ({len(TRIM_SITES)} site counts x {len(TRIM_WIDTHS)} "
          f"widths x trim depths x active patterns, non-finite values, {full} "
          f"f=1 and median) bit-equal to the plain version")

    x = torch.randn(4, FULL_N, device=dev, generator=gen)
    a = torch.ones(4, device=dev)
    nbytes = (x.numel() + FULL_N + 4) * 4

    def ops_of(f):    # per column: the sort's compare-swaps, kept adds, a divide
        fe = min(f, 3 // 2)
        return FULL_N * (6 + (4 - 2 * fe) + 1)
    timing = measure(torch, f"trimmed_mean [4, {FULL_N}] f=1",
                     lambda: robust.trimmed_mean_cuda(x, a, 1),
                     lambda: ref.trimmed_mean_ref(x, a, 1), None,
                     nbytes=nbytes, flops=ops_of(1))
    try:
        torch.quantile(x, 0.5, dim=0, interpolation="midpoint")
        library, why = (lambda: torch.quantile(x, 0.5, dim=0, interpolation="midpoint")), None
    except RuntimeError as e:
        library, why = None, str(e).splitlines()[0]
        print(f"masked_median: no library time: torch.quantile refused [4, {FULL_N}]: {why}")
    median = measure(torch, f"masked_median [4, {FULL_N}] (trimmed_mean f=4)",
                     lambda: robust.trimmed_mean_cuda(x, a, 4),
                     lambda: ref.masked_median_ref(x, a), library,
                     nbytes=nbytes, flops=ops_of(4))
    if why is not None:
        median["library_refused"] = why
    return {"max_abs_err": err, **timing, "median": median}


def _history(result) -> None:
    for h in result.history:
        extra = "".join(f" {k} {h[k]}" for k in ("upload_bytes", "download_bytes") if k in h)
        print(f"round {h['round']}: active {h['active']} loss {h['loss']:.6f} per-site "
              f"{[round(v, 6) for v in h['per_site_loss']]} batch_s "
              f"{h['batch_s']:.4f} step_s {h['step_s']:.4f} wall_s {h['wall_s']:.4f}{extra}")


def _check_result(torch, result, what: str) -> None:
    n_params = sum(t.numel() for t in _leaves(result.global_params))
    _require(all(math.isfinite(v) for h in result.history for v in h["per_site_loss"]),
             f"non-finite loss on {what}")
    _require(n_params == FULL_N, f"expected {FULL_N} parameters on {what}, got {n_params}")
    _require(all(bool(torch.isfinite(t).all()) for t in _leaves(result.global_params)),
             f"non-finite global parameters on {what}")


def run_main_path(torch, FederatedJob, TaskConfig, build, task):
    """The first slice's path: full-width FedAvg, uncompressed, with TF32
    convolutions (what the reference's XLA does with fp32 convolutions on
    this card; see ``models/sanet.py``); then the same job, from the same
    seeded initial parameters and batches, with fp32 convolutions, to
    record how far the losses lie apart and what fp32 costs a round.
    Returns (the TF32 run's launches, its result: phase 16's yardstick)."""
    torch.backends.cudnn.allow_tf32 = True         # the port's choice, stated
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default, stated
    print("main path: cudnn.allow_tf32=True, matmul.allow_tf32=False")
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=ROUNDS)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    _history(result)
    print(f"main path: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"kernels launched on the main path: {launches}")
    _check_result(torch, result, "the main path")
    _require(launches.get("fedagg", 0) >= ROUNDS,
             f"fedagg launched {launches.get('fedagg', 0)} times on the main path")

    torch.backends.cudnn.allow_tf32 = False
    fp32 = job.run()
    torch.backends.cudnn.allow_tf32 = True
    _check_result(torch, fp32, "the main path with fp32 convolutions")
    for tf, fp in zip(result.history, fp32.history):
        gap = abs(tf["loss"] - fp["loss"]) / abs(fp["loss"])
        print(f"main path round {tf['round']}: loss TF32 {tf['loss']:.6f} fp32 "
              f"{fp['loss']:.6f} (relative gap {gap:.3e}); step_s TF32 {tf['step_s']:.4f} "
              f"fp32 {fp['step_s']:.4f}")
    return launches, result


def run_int8_path(torch, FederatedJob, TaskConfig, build, task):
    """This slice's path: full-width FedAvg with int8 uploads and
    downloads; returns (its launches, the result)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=ROUNDS,
                       compression="int8", down_compression="int8")
    per_round = []
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run(on_round=lambda r: per_round.append(dict(build.LAUNCHES)))
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    _history(result)
    print(f"int8 path: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, comm {result.comm}")
    print(f"kernels launched on the int8 path: {launches}; after each round: {per_round}")
    _check_result(torch, result, "the int8 path")
    sites = task["sites"]
    for r, h in enumerate(result.history):
        prev = per_round[r - 1] if r else {}
        for name in ("quantize_int8", "fedagg_dequant", "dequant_install", "fedagg"):
            _require(per_round[r].get(name, 0) > prev.get(name, 0),
                     f"{name} not launched in round {r} of the int8 path")
        _require(h["upload_bytes"] == sites * INT8_BYTES,
                 f"round {r} upload_bytes {h['upload_bytes']} != {sites * INT8_BYTES}")
        want = sites * (DENSE_BYTES if r == 0 else INT8_BYTES)   # round 0 bootstraps
        _require(h["download_bytes"] == want,
                 f"round {r} download_bytes {h['download_bytes']} != {want}")
    return launches, result


def _eager_ms(torch, fn, reps: int = 11) -> float:
    """Median host-clock ms of ``fn`` with the device synchronised around it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def check_codec(torch, build, global_params) -> None:
    """The wire codec on the card: the full-width global, as a site uploads
    it (the reference's layout, one quantize launch per chunk width), held
    to the plain encoder on the reference's element order; its frame then
    decoded three ways, which must be bit-equal: grouped on the card (ONE
    dequantize_int8 launch), leaf by leaf on the card (``decode_array``),
    and the plain version on the CPU; the first two timed eager.  Then a
    frame encoded on the CPU (align=1: odd widths, rows and scales off any
    alignment) decoded on the card, bit-equal to the plain version."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.comms.codec import decode_message, encode_message, payload_span
    from repro_torch.comms.compression import (Int8Codec, UploadCompressor, decode_array,
                                               decode_tree, tree_payload_nbytes)

    def encode(tree):
        payload, meta = UploadCompressor(Int8Codec(), error_feedback=False).encode(tree)
        return payload, encode_message("upload", {"site": 0, "round": 1, **meta}, payload)

    params = [t.float() for t in _leaves(global_params)]
    build.reset_launches()
    payload, frame = encode(global_params)
    torch.cuda.synchronize()
    enc_launches = dict(build.LAUNCHES)
    enc = _leaves(payload)
    nbytes = tree_payload_nbytes(payload)
    print(f"codec: {len(enc)} leaves, {nbytes} payload bytes, frame {len(frame)} bytes; "
          f"encode launches {enc_launches}")
    _require(nbytes == INT8_BYTES, f"codec payload {nbytes} bytes, expected {INT8_BYTES}")
    _require(enc_launches.get("dequantize_int8", 0) == 0
             and enc_launches.get("quantize_int8", 0) == 4,
             "the encode without error feedback launches quantize_int8 once a chunk width")
    for p, qt in zip(params, enc):
        wire = convert.to_reference({"x": p})["x"]
        _require(tuple(qt.shape) == wire.shape, "codec leaf is not in the reference's shape")
        q, sc = _chunks(torch, wire.reshape(-1))
        _require(np.array_equal(qt.data["q"], q.numpy()) and np.array_equal(qt.data["scale"],
                                                                           sc.numpy()),
                 "codec payload differs from the plain encoder's on the reference's order")

    _, _, tree = decode_message(frame)
    leaves = _leaves(tree)
    build.reset_launches()
    grouped = decode_tree(tree, device="cuda")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    per_leaf = [decode_array(qt, device="cuda") for qt in leaves]
    plain = decode_tree(tree, device="cpu")
    for g, l, c in zip(_leaves(grouped), per_leaf, _leaves(plain)):
        _require(torch.equal(g, l) and torch.equal(g.cpu(), c),
                 "message decode: grouped, per-leaf and plain differ")
    _require(launches.get("dequantize_int8", 0) == 1,
             f"one message decoded with {launches.get('dequantize_int8', 0)} "
             "dequantize_int8 launches, not one")
    grouped_ms = _eager_ms(torch, lambda: decode_tree(tree, device="cuda"))
    leaf_ms = _eager_ms(torch, lambda: [decode_array(qt, device="cuda") for qt in leaves])
    print(f"codec: one upload frame ({len(frame)} bytes) to a device tree, eager: grouped "
          f"{grouped_ms:.4f} ms (1 launch), per leaf {leaf_ms:.4f} ms ({len(leaves)} launches); "
          "bit-equal to each other and to the plain version")

    cpu_payload, cpu_frame = encode(tree_map_cpu(global_params))
    _, _, cpu_tree = decode_message(cpu_frame)
    cpu_leaves = _leaves(cpu_tree)
    _, offsets = payload_span([a for qt in cpu_leaves for a in (qt.data["q"],
                                                                qt.data["scale"])])
    odd_rows = sum(o % 16 != 0 or qt.data["q"].shape[1] % 16 != 0
                   for o, qt in zip(offsets[0::2], cpu_leaves))
    odd_scales = sum(o % 4 != 0 for o in offsets[1::2])
    _require(odd_rows > 0 and odd_scales > 0, "the CPU frame has no misaligned row or scale")
    build.reset_launches()
    on_card = decode_tree(cpu_tree, device="cuda")
    torch.cuda.synchronize()
    _require(build.LAUNCHES.get("dequantize_int8", 0) == 1,
             "the misaligned frame took more than one launch")
    for g, c in zip(_leaves(on_card), _leaves(decode_tree(cpu_tree, device="cpu"))):
        _require(torch.equal(g.cpu(), c), "misaligned frame: card decode differs from plain")
    print(f"codec: a CPU-encoded frame (align=1, {tree_payload_nbytes(cpu_payload)} payload "
          f"bytes; {odd_rows} leaves with rows off 16 bytes or odd widths, {odd_scales} with "
          "scales off 4 bytes) decoded on the card in one launch, bit-equal to the plain version")


def _chunks(torch, flat_np):
    """The plain encoder on one leaf's align-128 chunks, on the CPU."""
    from repro_torch.comms.compression import _as_chunks
    from repro_torch.kernels import ref
    return ref.quantize_int8_ref(_as_chunks(torch.from_numpy(flat_np.copy()), 1024, 128))


def tree_map_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def check_grouped_dequant(torch, dev) -> float:
    """The grouped dequantize_int8 against its plain version, bit for bit,
    on messages laid out as a payload (each leaf's q then its scales) after
    a header of every length mod 16: leaves of many sizes at align 1 (odd
    widths, rows and scales at any byte offset) and 128 (the card's),
    output offsets off 16 bytes, a ragged last row, and one leaf of more
    rows than a grid-stride pass.  Returns the largest |difference|."""
    import numpy as np
    from repro_torch.comms.compression import chunk_geom
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    sizes = [1, 3, 5, 127, 128, 129, 1000, 1024, 1025, 3001, 4103, 65_537]
    err, cases = 0.0, 0
    for align in (1, 128):
        for head in range(16):
            order = rng.permutation(len(sizes)) if head else np.arange(len(sizes))
            parts, entries, pos, out_off = [], [], head, 0
            for i in order:
                n = sizes[i] * (256 if head == 15 else 1)   # past one grid-stride pass
                rows, width = chunk_geom(n, 1024, align)
                q = rng.integers(-127, 128, size=rows * width, dtype=np.int8)
                sc = (rng.random(rows, dtype=np.float32) * 0.01 + 1e-4).astype(np.float32)
                entries.append((pos, pos + q.nbytes, rows, width, n, out_off))
                parts += [q.view(np.uint8), sc.view(np.uint8)]
                pos += q.nbytes + sc.nbytes
                out_off += n
            buf = np.concatenate([np.zeros(head, np.uint8)] + parts)
            table = qk.Int8Table.of(entries)
            b = torch.from_numpy(buf).to(dev)
            got = qk.dequantize_int8_grouped_cuda(table, b, b, torch.full((out_off,), float("nan"),
                                                                          device=dev))
            torch.cuda.synchronize()
            want = ref.dequantize_int8_grouped_ref(torch.from_numpy(table.host), b, b,
                                                   torch.full((out_off,), float("nan"),
                                                              device=dev))
            _require(torch.equal(got, want), f"dequantize_int8 grouped, align {align}, "
                     f"header {head}: differs from its plain version")
            err = max(err, float((got - want).abs().max()))
            cases += 1
    print(f"dequantize_int8 grouped: {cases} messages of {len(sizes)} leaves (align 1 and "
          f"128, headers 0-15 bytes, the last of {table.total_rows} rows) bit-equal to the "
          "plain version")
    return err


def run_socket_path(torch, FederatedJob, TaskConfig, build, task, stacked) -> dict:
    """This slice's path: the full-width 4-site job with int8 both ways on
    the thread transport (real TCP round trips to the AggregationServer on
    the card), held to the stacked int8 job ``stacked``: payload bytes
    equal; globals within the reference's own thread-vs-stacked bound
    (rtol 2e-3, atol 2e-4) but on at most 1e-5 of the elements, which are
    held to ``lr * ROUNDS``: the server folds in arrival order and
    normalizes once (the reference's server), the stacked kernel folds
    normalized weights, and AdamW's next step can turn that round-off into
    a flipped int8 step or ``lr * sign(noise)`` where a gradient is near
    zero.  The witness, in the same run: the socket job run again, whose
    only difference is its fold's arrival order; it is printed against
    the first run and held to the stacked job the same way
    (``probe_fold_order.py`` shows both runs of the socket job exceeding
    the bound against each other on the same conv weight element).  Every
    int8 message decoded (4 uploads at the server, 4 downloads at the
    sites, 8 error-feedback updates a round once the downlink sends
    deltas) takes ONE dequantize_int8 launch.  Returns the first run's
    launches."""
    from repro_torch.core.round_engine import bootstrap_masks
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=ROUNDS,
                       transport="thread", compression="int8", down_compression="int8")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_result(torch, result, "the socket path")
    for s, t in zip(stacked.history, result.history):
        print(f"socket path round {t['round']}: loss stacked {s['loss']:.6f} thread "
              f"{t['loss']:.6f}; per site stacked {[round(v, 6) for v in s['per_site_loss']]} "
              f"thread {[round(v, 6) for v in t['per_site_loss']]}; wall_s stacked "
              f"{s['wall_s']:.4f} thread {t['wall_s']:.4f}; batch_s {s['batch_s']:.4f} / "
              f"{t['batch_s']:.4f}; step_s {s['step_s']:.4f} / {t['step_s']:.4f}")
    comm, sc = result.comm, stacked.comm
    print(f"socket path: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory {peak:.2f} "
          f"GiB, comm {comm}")
    _require(comm["site_payload_bytes"] == sc["upload_bytes"],
             f"site_payload_bytes {comm['site_payload_bytes']} != stacked upload_bytes "
             f"{sc['upload_bytes']}")
    _require(comm["download_payload_bytes"] == sc["download_bytes"],
             f"download_payload_bytes {comm['download_payload_bytes']} != stacked "
             f"download_bytes {sc['download_bytes']}")
    worst, outside = _outside(result.global_params, stacked.global_params)
    print(f"socket path: globals max |thread - stacked| {worst:.3e}; leaves with elements "
          f"outside rtol 2e-3, atol 2e-4 (leaf, shape, count, max): {outside}")
    masks = job.masks(ROUNDS)
    boot = bootstrap_masks(masks, 16)
    # per round: each int8 upload is decoded at the server and, for its
    # residual, at the site; each int8 (delta) download at the site and,
    # for the held copy, at the server
    per_round = [2 * int(masks[r].sum()) + 2 * int((masks[r] & ~boot[r]).sum())
                 for r in range(ROUNDS)]
    got = launches.get("dequantize_int8", 0)
    print(f"kernels launched on the socket path: {launches}; dequantize_int8 {got} for "
          f"{sum(per_round)} int8 messages decoded ({per_round} a round)")
    _require(got == sum(per_round),
             f"dequantize_int8 launched {got} times for {sum(per_round)} int8 messages")
    _require(launches.get("quantize_int8", 0) == 4 * sum(
        int(masks[r].sum()) + int((masks[r] & ~boot[r]).sum()) for r in range(ROUNDS)),
        "quantize_int8 not launched once a chunk width an int8 encode")
    # the reference's bound holds but where AdamW's step turns fold-order
    # round-off into a flipped int8 step or about lr * sign(noise): there
    # |difference| <= lr * ROUNDS, on at most 1e-5 of the elements (a
    # wrong fold, a site dropped or counted twice, moves millions)
    _require_fold_noise(job, worst, outside, "the socket path")
    again = job.run()
    _check_result(torch, again, "the socket path run again")
    w_again, o_again = _outside(again.global_params, stacked.global_params)
    w_runs, o_runs = _outside(again.global_params, result.global_params)
    print(f"socket path, witness (the same job again: only the fold's arrival order "
          f"differs): max |again - stacked| {w_again:.3e}, outside {o_again}; max |again - "
          f"first run| {w_runs:.3e}, outside {o_runs}; losses {again.losses}")
    _require_fold_noise(job, w_again, o_again, "the socket path run again")
    return launches


def _outside(got, want):
    """(max |got - want|, [(leaf, shape, count, max)] of the leaves with
    elements outside rtol 2e-3, atol 2e-4 of ``want``)."""
    worst, outside = 0.0, []
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        bad = int((d > 2e-4 + 2e-3 * b.abs()).sum())
        if bad:
            outside.append((i, tuple(a.shape), bad, float(d.max())))
    return worst, outside


def _require_fold_noise(job, worst, outside, what: str, n: int = FULL_N) -> None:
    n_out = sum(bad for _, _, bad, _ in outside)
    _require(worst <= job.lr * ROUNDS and n_out <= 1e-5 * n,
             f"{what}: globals differ from the stacked job's by up to {worst:.3e} "
             f"(lr * rounds {job.lr * ROUNDS}), {n_out} elements outside rtol 2e-3, atol 2e-4")


def check_small_tcp_jobs(torch, FederatedJob, TaskConfig) -> None:
    """A 2-site job at the tiny size on the tcp transport (one process a
    site), uncompressed and int8 both ways, on the card and on the CPU, TF32
    off: per-round losses within rtol 1e-4, and each side's payload bytes
    its own layout's (align 128 on the card, 1 on the CPU)."""
    from repro_torch.core.round_engine import bootstrap_masks, encoded_nbytes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = FederatedJob(task=TaskConfig(kind="dose", sites=2, batch=1, volume=(8, 8, 8),
                                        base_filters=4), rounds=3, transport="tcp")
    for codec in ("none", "int8"):
        job = base.replace(compression=codec, down_compression=codec)
        gpu, cpu = job.run(), job.replace(device="cpu").run()
        print(f"small tcp job {codec}: losses cuda {gpu.losses} cpu {cpu.losses}")
        for g, c in zip(gpu.losses, cpu.losses):
            _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                     f"small tcp job {codec}: cuda loss {g} != cpu loss {c}")
        if codec == "none":
            continue
        shapes = [tuple(t.shape) for t in _leaves(cpu.global_params)]
        masks = job.masks(job.rounds)
        boot = bootstrap_masks(masks, 16)
        dense = 4 * sum(math.prod(sh) for sh in shapes)
        for res, align in ((gpu, 128), (cpu, 1)):
            enc = encoded_nbytes(shapes, 1024, align)
            want_up = int(masks.sum()) * enc
            want_down = int((masks & boot).sum()) * dense + int((masks & ~boot).sum()) * enc
            _require(res.comm["site_payload_bytes"] == want_up
                     and res.comm["download_payload_bytes"] == want_down,
                     f"small tcp job align {align}: payload bytes {res.comm}")
        print(f"small tcp job int8: payload bytes cuda {gpu.comm['site_payload_bytes']} up "
              f"{gpu.comm['download_payload_bytes']} down; cpu {cpu.comm['site_payload_bytes']}"
              f" / {cpu.comm['download_payload_bytes']}")


def check_small_socket_seams(torch, FederatedJob, TaskConfig, build) -> None:
    """Phase 15's seams at the tiny size (8^3, 4 filters, 2 rounds, TF32
    off) on the tcp transport (one process a site, on the card), each held
    to its thread twin: GCML with int8 pushes (2 sites), FedProx under the
    median with ``max_upload_norm`` (3 sites; the server's ``trimmed_mean``
    launches once a round in this process, the sites' kernels in theirs),
    and FedAvg with ``secure_agg`` under ``max_dropout=1`` (3 sites).  Losses
    within rtol 1e-5 (the same arithmetic; the fold's order may differ),
    ``comm`` and ``privacy`` equal."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = dict(batch=1, volume=(8, 8, 8), base_filters=4, num_levels=2)
    pan = TaskConfig(kind="seg", sites=2, in_channels=1, num_classes=2, **tiny)
    dose = TaskConfig(kind="dose", sites=3, **tiny)
    cases = [("gcml int8", pan, dict(strategy="gcml", compression="int8"), {}),
             ("fedprox median", dose, dict(strategy="fedprox", prox_mu=0.5, aggregator="median",
                                           max_upload_norm=1e3), {"trimmed_mean": ROUNDS}),
             ("secure_agg", dose, dict(secure_agg=True, max_dropout=1), {})]
    for what, task, kw, server in cases:
        job = FederatedJob(task=task, rounds=ROUNDS, transport="tcp", **kw)
        build.reset_launches()
        tcp = job.run()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        thread = job.replace(transport="thread").run()
        print(f"small tcp {what}: losses tcp {tcp.losses} thread {thread.losses}; comm "
              f"{tcp.comm}; privacy {tcp.privacy}; launches in this process {launches}")
        for a, b in zip(tcp.losses, thread.losses):
            _require(math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-7),
                     f"small tcp {what}: loss {a} != thread twin's {b}")
        _require(tcp.comm == thread.comm and tcp.privacy == thread.privacy,
                 f"small tcp {what}: comm or privacy differs from the thread twin's")
        _expect_launches(f"small tcp {what} (the server's)", launches, server)


def check_small_jobs(torch, FederatedJob, TaskConfig) -> None:
    """The same small jobs on the card and on the CPU (plain versions);
    the CPU path is held to the JAX reference by tests/test_torch_job.py
    and tests/test_torch_compression.py.  TF32 off so both sides compute
    in fp32; tolerance 1e-4 relative, since sum orders differ and AdamW's
    first step amplifies noise on near-zero gradients.  The int8 jobs'
    bytes are each layout's own: align 128 on the card, align 1 on the
    CPU (the same values, other padding)."""
    from repro_torch.core.round_engine import bootstrap_masks, encoded_nbytes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = FederatedJob(task=TaskConfig(kind="dose", sites=3, batch=2), rounds=3,
                        max_dropout=1)
    for codecs in (("none", "none"), ("int8", "none"), ("int8", "int8"), ("none", "int8")):
        job = base.replace(compression=codecs[0], down_compression=codecs[1])
        gpu, cpu = job.run(), job.replace(device="cpu").run()
        print(f"small job {codecs}: losses cuda {gpu.losses} cpu {cpu.losses}")
        for g, c in zip(gpu.losses, cpu.losses):
            _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                     f"small job {codecs}: cuda loss {g} != cpu loss {c}")
        if codecs == ("none", "none"):
            continue
        masks = job.masks(job.rounds)
        boot = bootstrap_masks(masks, 16)
        shapes = [tuple(t.shape) for t in _leaves(cpu.global_params)]
        dense = 4 * sum(math.prod(sh) for sh in shapes)
        for res, align in ((gpu, 128), (cpu, 1)):
            enc = encoded_nbytes(shapes, 1024, align)
            up = enc if codecs[0] == "int8" else dense
            for r, h in enumerate(res.history):
                _require(h["upload_bytes"] == int(masks[r].sum()) * up,
                         f"small job {codecs} align {align}: round {r} upload bytes")
                if codecs[1] == "int8":
                    want = sum(dense if b else enc for a, b in zip(masks[r], boot[r]) if a)
                    _require(h["download_bytes"] == want,
                             f"small job {codecs} align {align}: round {r} download bytes")
        print(f"small job {codecs}: bytes per round cuda "
              f"{[(h['upload_bytes'], h.get('download_bytes')) for h in gpu.history]} cpu "
              f"{[(h['upload_bytes'], h.get('download_bytes')) for h in cpu.history]}")


def run_robust_path(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """This slice's path: full-width FedAvg under trimmed:1 with one
    sign-flipping site and Algorithm-2 churn; returns its launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=ROUNDS,
                       aggregator="trimmed:1", adversary="sign_flip:1", max_dropout=1)
    per_round = []
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run(on_round=lambda r: per_round.append(dict(build.LAUNCHES)))
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    _history(result)
    print(f"robust path: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, malicious sites "
          f"{job.adversary_plan.malicious_mask(task['sites']).nonzero()[0].tolist()}")
    print(f"kernels launched on the robust path: {launches}; after each round: {per_round}")
    _check_result(torch, result, "the robust path")
    for r in range(ROUNDS):
        _require(per_round[r].get("trimmed_mean", 0) == r + 1,
                 f"trimmed_mean not launched once in round {r} of the robust path")
        _require(per_round[r].get("fedagg", 0) == 0,
                 f"fedagg launched in round {r} of the robust path")
    _require(launches.get("fedagg", 0) == 1,
             f"fedagg launched {launches.get('fedagg', 0)} times, not once (the final global)")
    _require(not any(launches.get(k, 0) for k in INT8_KERNELS),
             "an int8 kernel was launched on the robust path")
    return launches


def check_robust_small_jobs(torch, FederatedJob, TaskConfig, build) -> None:
    """Small robust jobs on the card and on the CPU (plain versions), as
    :func:`check_small_jobs`; the CPU path is held to the JAX reference by
    tests/test_torch_robust.py.  Krum's picks are recorded on both sides."""
    from repro_torch.core import agg_engine
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"robust small jobs: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; krum's x @ x.T runs in "
          "full fp32 whatever the flag")
    base = FederatedJob(task=TaskConfig(kind="dose", sites=4, batch=2), rounds=3,
                        max_dropout=1)
    picks = []
    krum_index = agg_engine.krum_index

    def recording(flat, active, f):
        idx = krum_index(flat, active, f)
        picks.append(int(idx))
        return idx
    variants = [dict(aggregator="trimmed:1", adversary="sign_flip:1"),
                dict(aggregator="median", adversary="label_flip:1"),
                dict(aggregator="krum:1", adversary="scale:3:1"),
                dict(aggregator="normclip:15"),        # the init's norm is 21.5
                dict(aggregator="median", sample="uniform:3"),
                dict(compression="int8", sample="poisson:0.75")]
    agg_engine.krum_index = recording
    try:
        for kw in variants:
            job = base.replace(**kw)
            picks.clear()
            before = build.LAUNCHES.get("trimmed_mean", 0)
            gpu = job.run()
            launched = build.LAUNCHES.get("trimmed_mean", 0) - before
            cpu = job.replace(device="cpu").run()
            print(f"small robust job {kw}: active {[h['active'] for h in gpu.history]}, "
                  f"losses cuda {gpu.losses} cpu {cpu.losses}"
                  + (f", krum picks cuda {picks[:3]} cpu {picks[3:]}" if picks else ""))
            _require([h["active"] for h in gpu.history] == [h["active"] for h in cpu.history],
                     f"small robust job {kw}: participants differ")
            for g, c in zip(gpu.losses, cpu.losses):
                _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                         f"small robust job {kw}: cuda loss {g} != cpu loss {c}")
            rank = job.aggregator_spec.name in ("trimmed", "median")
            _require(launched == (job.rounds if rank else 0),
                     f"small robust job {kw}: trimmed_mean launched {launched} times")
            if job.aggregator_spec.name == "krum":
                _require(len(picks) == 2 * job.rounds and picks[:3] == picks[3:],
                         f"small robust job {kw}: krum picked {picks[:3]} on the card, "
                         f"{picks[3:]} on the CPU")
    finally:
        agg_engine.krum_index = krum_index

# -- the paper's strategy set (phases 11-14) -------------------------------------

PROX_MU = 0.01
# FedProx against FedAvg where the Eq. 2 term is exactly 0: the same
# arithmetic but for adding that 0 (and the round-0 anchor, Eq. 1 over
# four identical rows, which may round an element by an ulp)
PROX_ZERO_RTOL = 1e-6
# card vs CPU globals of the small strategy jobs (lr 1e-3): a fault in a
# step moves most elements by about lr; fp32 sum orders moved the median
# by 0 to 1.04e-6 (6 AdamW steps of the seg FedProx job)
SMALL_MEDIAN_TOL = 1e-5


def _strategy_history(result, what: str) -> None:
    """Each round's losses, times, pairings and (GCML) DCML losses."""
    for h in result.history:
        line = (f"{what} round {h['round']}: active {h['active']} loss {h['loss']:.6f} "
                f"per-site {[round(v, 6) for v in h['per_site_loss']]} wall_s "
                f"{h['wall_s']:.4f} batch_s {h['batch_s']:.4f} step_s {h['step_s']:.4f}")
        if "partner" in h:
            line += f" partner {h['partner']} is_receiver {h['is_receiver']}"
        for k in ("dcml_loss_r", "dcml_loss_s", "dcml_val_r", "dcml_val_s"):
            if k in h:
                line += f" {k} {[round(v, 6) for v in h[k]]}"
        for k in ("upload_bytes", "download_bytes"):
            if k in h:
                line += f" {k} {h[k]}"
        print(line)


def _run_job(torch, FederatedJob, TaskConfig, build, task, n_params: int, what: str,
             rounds: int = ROUNDS, **kw):
    """One full-width job, ``rounds`` sync rounds, TF32 convolutions,
    random weights from seed 0.  Every kernel's launches are counted from 0
    just before ``job.run()`` and the peak is reset just before.  Prints
    each round's ``wall_s``, ``batch_s`` and ``step_s``, the peak,
    ``comm``, ``privacy`` and the launches; requires the parameter count
    and finite losses and global.  Returns (result, launches, job)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**task), rounds=rounds, **kw)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    _strategy_history(result, what)
    print(f"{what}: {rounds} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, comm {result.comm}, "
          f"privacy {result.privacy}; kernels launched {launches}")
    got_n = sum(t.numel() for t in _leaves(result.global_params))
    _require(got_n == n_params, f"{what}: {got_n} parameters, not {n_params}")
    _require(all(math.isfinite(v) for h in result.history for v in h["per_site_loss"]),
             f"non-finite loss on {what}")
    _require(all(bool(torch.isfinite(t).all()) for t in _leaves(result.global_params)),
             f"non-finite global parameters on {what}")
    return result, launches, job


def _expect_launches(what: str, launches: dict, expect: dict) -> None:
    for name in set(launches) | set(expect):
        _require(launches.get(name, 0) == expect.get(name, 0),
                 f"{what}: {name} launched {launches.get(name, 0)} times, "
                 f"expected {expect.get(name, 0)}")
    print(f"{what}: launches as the code implies {expect}")


def run_strategy_job(torch, FederatedJob, TaskConfig, build, task, n_params: int,
                     what: str, expect, **kw):
    """One full-width job of the strategy set on the stacked transport
    (:func:`_run_job`); every kernel's launches must equal ``expect[name]``
    (0 for a kernel not named).

    The final global is ``fedagg``'s last launch on every uncompressed
    path: it is held to the plain version on the final rows and the
    normalized case weights (``FP32_TOL``).  FedProx's anchor, the global
    of the last round, must equal every row it was broadcast to (every
    site is active in these jobs) and lie
    within ``FP32_TOL`` of that plain global; under int8 it must be the
    global itself (the anchor is re-pinned to the exact fold).  Returns the
    result."""
    from repro_torch.kernels import ref
    result, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, n_params,
                                     what, **kw)
    _expect_launches(what, launches, expect)
    rows = result.state["params"]
    flat = torch.cat([t.reshape(-1) for t in _leaves(result.global_params)])
    anchor = result.state["strategy"].get("global")
    if kw.get("compression", "none") == "none":
        cw = torch.as_tensor(job.federation().case_weights(), device=rows.device)
        want = ref.fedagg_ref(rows, cw / cw.sum())
        torch.testing.assert_close(flat, want, **FP32_TOL)
        print(f"{what}: final global [{rows.shape[0]}, {rows.shape[1]}] within fp32 "
              f"rtol=atol=1e-6 of the plain fedagg (max |err| "
              f"{float((flat - want).abs().max()):.3e})")
        if anchor is not None:
            _require(all(torch.equal(r, anchor) for r in rows),
                     f"{what}: a row differs from the FedProx anchor it was broadcast")
            torch.testing.assert_close(anchor, want, **FP32_TOL)
    elif anchor is not None:
        _require(torch.equal(anchor, flat), f"{what}: the anchor is not the final global")
        print(f"{what}: the anchor is the final global, bit for bit")
    return result


def _fresh(torch) -> None:
    """Free what the last path left and restart the peak-memory count."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _timed(phase: str, fn, *args):
    gc.collect()
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return out


def run_dose_strategies(torch, FederatedJob, TaskConfig, build, task) -> None:
    """Phase 11, the dose experiment (Figs 7-9): the pooled baseline (ONE
    site whose batch is the 4 sites' batches, a batch of 4 at 128^3) and
    the individual baseline (4 sites, no exchange, ``comm`` None).  Neither
    aggregates in a round: ``fedagg`` runs once, for the final global (the
    case-weighted mean of the site rows; one row when pooled)."""
    sites = task["sites"]
    pooled = run_strategy_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                              "dose pooled", {"fedagg": 1}, strategy="pooled")
    _require(tuple(pooled.state["params"].shape) == (1, FULL_N)
             and all(len(h["per_site_loss"]) == 1 and h["active"] == sites
                     for h in pooled.history) and pooled.comm is None,
             "dose pooled: not one site over the task's sites")
    del pooled
    indiv = run_strategy_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                             "dose individual", {"fedagg": 1}, strategy="individual")
    _require(tuple(indiv.state["params"].shape) == (sites, FULL_N) and indiv.comm is None,
             "dose individual: not one row a site, or a comm")


def run_seg_strategies(torch, FederatedJob, TaskConfig, build, task, counts) -> dict:
    """Phase 12, the strategy comparison on BraTS (Figs 11/12), 4 sites at
    the paper's case counts.  Launches, worked out from the code:

    - fedavg: ``fedagg`` once a round (``aggregate_round``) and once for
      the final global;
    - fedprox: one more, the round-0 anchor (``FedProx.init_state``, the
      mean of the identical initial rows);
    - fedprox + int8 both ways (``run_compressed`` under ``fedprox-local``):
      ``fedagg`` once for the anchor and once a round (the fold of the
      sites' upload anchors, ``reduce_flat(anchor, w)``), none at the end
      (the global is the fold's); per round and chunk-width group G,
      ``quantize_int8`` twice (the uploads' fold, the installs),
      ``fedagg_dequant`` once and ``dequant_install`` once;
    - fedprox + trimmed:1: ``trimmed_mean`` once a round, ``fedagg`` for
      the anchor and the final global only.

    With one local step and every site active, each site starts its step at
    the anchor, so the Eq. 2 term and its gradient are 0: plain FedProx's
    per-site losses must be FedAvg's (within ``PROX_ZERO_RTOL``), and its
    ``step_s`` times a term that is computed but pulls nothing.  The int8
    job's sites install quantized copies, so the term pulls there; the
    ``trimmed:1`` job takes 2 local steps, so its second step reads the
    term at full width."""
    from repro_torch.comms.compression import align_for
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.core.round_engine import ChunkPlan
    from repro_torch.core.stacking import broadcast_to_sites
    base = dict(case_counts=counts, prox_mu=PROX_MU)
    steps, losses = {}, {}
    for strategy, expect in (("fedavg", {"fedagg": ROUNDS + 1}),
                             ("fedprox", {"fedagg": ROUNDS + 2})):
        res = run_strategy_job(torch, FederatedJob, TaskConfig, build, task, BRATS_N,
                               f"brats {strategy}", expect, strategy=strategy, **base)
        steps[strategy] = [h["step_s"] for h in res.history]
        losses[strategy] = [v for h in res.history for v in h["per_site_loss"]]
        _require(res.comm["upload_count"] == ROUNDS * task["sites"],
                 f"brats {strategy}: comm {res.comm}")
        del res
    print(f"brats step_s a round: fedavg {steps['fedavg']} fedprox {steps['fedprox']} "
          f"(round 1: fedprox / fedavg = {steps['fedprox'][-1] / steps['fedavg'][-1]:.4f})")
    gap = max(abs(p - a) / abs(a) for a, p in zip(losses["fedavg"], losses["fedprox"]))
    print(f"brats fedprox vs fedavg, one local step (the Eq. 2 term is 0): per-site losses "
          f"{'bit-equal' if losses['fedprox'] == losses['fedavg'] else 'differ'}, "
          f"max relative gap {gap:.3e}")
    _require(gap <= PROX_ZERO_RTOL,
             f"brats fedprox: per-site losses {gap:.3e} from fedavg's with a zero Eq. 2 term")
    layout = get_engine().layout_of(broadcast_to_sites(
        TaskConfig(**task).build().init_fn(0), 1))
    dev = torch.device("cuda")
    groups = len(ChunkPlan.of(layout, 1024, align_for(dev), dev).groups)
    print(f"brats chunk-width groups: {groups}")
    res = run_strategy_job(
        torch, FederatedJob, TaskConfig, build, task, BRATS_N, "brats fedprox int8",
        {"fedagg": 1 + ROUNDS, "quantize_int8": 2 * groups * ROUNDS,
         "fedagg_dequant": groups * ROUNDS, "dequant_install": groups * ROUNDS},
        strategy="fedprox", compression="int8", down_compression="int8", **base)
    _require(res.comm["compression"] == "int8" and res.comm["down_compression"] == "int8",
             f"brats fedprox int8: comm {res.comm}")
    int8_comm = res.comm
    del res
    run_strategy_job(torch, FederatedJob, TaskConfig, build, task, BRATS_N,
                     "brats fedprox trimmed:1, 2 local steps",
                     {"fedagg": 2, "trimmed_mean": ROUNDS},
                     strategy="fedprox", aggregator="trimmed:1", local_steps=2, **base)
    return int8_comm


def run_gossip(torch, FederatedJob, TaskConfig, build, task):
    """Phase 13, gossip on PanSeg (Fig 15): GCML over 5 sites without churn,
    then with ``max_dropout=1`` under the shutdown scenario.  GCML has no
    server: ``fedagg`` runs once, for the final global, and nothing else.
    Each round pairs floor(active / 2) receivers, each with a finite DCML
    loss; the others run no DCML step (NaN).  Returns the job without churn
    (its global and history), phase 15's yardstick."""
    first = None
    for what, kw in (("panseg gcml", {}),
                     ("panseg gcml churn", dict(max_dropout=1, dropout_scenario="shutdown"))):
        res = run_strategy_job(torch, FederatedJob, TaskConfig, build, task, PANSEG_N, what,
                               {"fedagg": 1}, strategy="gcml", **kw)
        _require(res.comm is None, f"{what}: comm {res.comm}")
        for h in res.history:
            recv = [i for i, r in enumerate(h["is_receiver"]) if r]
            _require(len(recv) == h["active"] // 2,
                     f"{what} round {h['round']}: {len(recv)} receivers of {h['active']}")
            _require(all(math.isfinite(h[k][i]) for i in recv
                         for k in ("dcml_loss_r", "dcml_loss_s", "dcml_val_r", "dcml_val_s")),
                     f"{what} round {h['round']}: a receiver's DCML loss is not finite")
            _require(all(math.isnan(v) for i, v in enumerate(h["dcml_loss_r"]) if i not in recv),
                     f"{what} round {h['round']}: a DCML step off the pairing")
        if first is None:
            first = dataclasses.replace(res, state=None)
        del res
    return first


def _close_globals(torch, job, gpu, cpu, what: str) -> None:
    """Card against CPU: the global model and, for FedProx, the anchor.
    Each element within ``lr`` a site's AdamW step (``rounds *
    local_steps`` of them; a step is about ``lr * sign(g)``, and float noise
    flips a near-zero gradient's sign), plus one quantization step under
    int8; the median difference within ``SMALL_MEDIAN_TOL``."""
    got, want = (torch.cat([t.reshape(-1) for t in _leaves(res.global_params)]).cpu()
                 for res in (gpu, cpu))
    pairs = [("global", got, want)]
    if "global" in cpu.state["strategy"]:
        pairs.append(("anchor", gpu.state["strategy"]["global"].cpu(),
                      cpu.state["strategy"]["global"]))
    bound = job.lr * job.rounds * job.local_steps
    if job.compression != "none":
        bound += float(want.abs().max()) / 127
    for name, a, b in pairs:
        d = (a - b).abs()
        print(f"small {what}: {name} card vs CPU max |diff| {float(d.max()):.3e} "
              f"(bound {bound:.3e}), median {float(d.median()):.3e} "
              f"(bound {SMALL_MEDIAN_TOL:.0e})")
        _require(float(d.max()) <= bound and float(d.median()) <= SMALL_MEDIAN_TOL,
                 f"small {what}: the {name} differs between card and CPU")


def check_small_strategy_jobs(torch, FederatedJob, TaskConfig) -> None:
    """Phase 14: small jobs of each strategy (8^3, 4 filters, 2 levels, 3
    rounds, TF32 off) on the card and on the CPU (the plain versions); the
    CPU path is held to the JAX reference by tests/test_torch_seg.py,
    tests/test_torch_strategies.py and tests/test_torch_gcml.py.  Losses
    (and GCML's receivers' DCML losses) within ``JOB_RTOL``; masks,
    pairings and ``comm`` equal (int8: each side's bytes its own layout's,
    as :func:`check_small_jobs` holds them).  The global models (and
    FedProx's anchors) by :func:`_close_globals`.  The seg FedProx job
    takes 2 local steps, so every round's second step reads the Eq. 2 term
    on both sides."""
    from repro_torch.comms.compression import align_for
    from repro_torch.core.round_engine import bootstrap_masks, encoded_nbytes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = dict(batch=1, volume=(8, 8, 8), base_filters=4, num_levels=2)
    dose = TaskConfig(kind="dose", sites=4, **tiny)
    seg = TaskConfig(kind="seg", sites=4, in_channels=2, num_classes=3, **tiny)
    pan = TaskConfig(kind="seg", sites=5, in_channels=1, num_classes=2, **tiny)
    cases = [("pooled", dose, dict(strategy="pooled")),
             ("individual", dose, dict(strategy="individual", max_dropout=1)),
             ("fedprox dose", dose, dict(strategy="fedprox", max_dropout=1, prox_mu=0.5)),
             ("fedprox seg", seg, dict(strategy="fedprox", max_dropout=1, local_steps=2,
                                       case_counts=(52, 44, 35, 28))),
             ("fedprox int8", seg, dict(strategy="fedprox", max_dropout=1, compression="int8",
                                        down_compression="int8")),
             ("fedprox trimmed:1", seg, dict(strategy="fedprox", max_dropout=1,
                                             aggregator="trimmed:1", adversary="sign_flip:1")),
             ("gcml", pan, dict(strategy="gcml")),
             ("gcml churn", pan, dict(strategy="gcml", max_dropout=1,
                                      dropout_scenario="shutdown", seed=3)),
             ("gcml normclip", pan, dict(strategy="gcml", max_dropout=1,
                                         aggregator="normclip:0.01"))]
    for what, task, kw in cases:
        job = FederatedJob(task=task, rounds=3, **kw)
        gpu, cpu = job.run(), job.replace(device="cpu").run()
        print(f"small {what}: losses cuda {gpu.losses} cpu {cpu.losses}")
        for g, c in zip(gpu.history, cpu.history):
            for key in ("active", "partner", "is_receiver"):
                _require(g.get(key) == c.get(key), f"small {what}: {key} differs")
            for a, b in zip(g["per_site_loss"], c["per_site_loss"]):
                _require(math.isclose(a, b, rel_tol=JOB_RTOL, abs_tol=1e-6),
                         f"small {what}: cuda loss {a} != cpu loss {b}")
            for i, r in enumerate(g.get("is_receiver", [])):
                if r:
                    _require(math.isclose(g["dcml_loss_r"][i], c["dcml_loss_r"][i],
                                          rel_tol=JOB_RTOL, abs_tol=1e-6),
                             f"small {what}: DCML losses differ")
        _close_globals(torch, job, gpu, cpu, what)
        if "compression" not in kw:
            _require(gpu.comm == cpu.comm, f"small {what}: comm {gpu.comm} != {cpu.comm}")
            continue
        masks = job.masks(job.rounds)
        boot = bootstrap_masks(masks, 16)
        shapes = [tuple(t.shape) for t in _leaves(cpu.global_params)]
        dense = 4 * sum(math.prod(sh) for sh in shapes)
        for res, align in ((gpu, align_for(torch.device("cuda"))), (cpu, 1)):
            enc = encoded_nbytes(shapes, 1024, align)
            for r, h in enumerate(res.history):
                want = sum(dense if b else enc for a, b in zip(masks[r], boot[r]) if a)
                _require(h["upload_bytes"] == int(masks[r].sum()) * enc
                         and h["download_bytes"] == want,
                         f"small {what} align {align}: round {r} bytes")


# -- the serverless and private socket deployment (phase 15) ---------------------


def _held_to(torch, job, got, want, what: str, n: int) -> None:
    """The socket bound of phase 5b: rtol 2e-3, atol 2e-4 but on at most
    1e-5 of the elements, each within ``lr * rounds``."""
    worst, outside = _outside(got.global_params, want.global_params)
    print(f"{what}: max |difference| {worst:.3e}; leaves with elements outside rtol 2e-3, "
          f"atol 2e-4 (leaf, shape, count, max): {outside}")
    for a, b in zip(got.history, want.history):
        print(f"{what} round {a['round']}: per site {[round(v, 6) for v in a['per_site_loss']]}"
              f" against {[round(v, 6) for v in b['per_site_loss']]}")
    _require_fold_noise(job, worst, outside, what, n)


def _chunk_groups(torch, TaskConfig, task) -> tuple:
    """(chunk-width groups, encoded bytes) of one int8 model of ``task`` on
    the card."""
    from repro_torch.comms.compression import WirePlan, align_for
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.core.round_engine import encoded_nbytes
    from repro_torch.core.stacking import broadcast_to_sites
    dev = torch.device("cuda")
    layout = get_engine().layout_of(broadcast_to_sites(TaskConfig(**task).build().init_fn(0), 1))
    plan = WirePlan.of(layout, 1024, align_for(dev), dev, port=True)
    return len(plan.chunks.groups), encoded_nbytes(layout.shapes, 1024, align_for(dev))


def check_push_decode(torch, build, TaskConfig, task) -> dict:
    """One int8 gossip push at PanSeg's layout as a sender makes it (the
    site's wire plan: ``quantize_int8`` once a chunk width, the push
    stream's error-feedback residual: ``dequantize_int8`` once) and a
    receiver reads it off the frame (``dequantize_int8`` once): the card's
    decode bit-equal to the plain decode of the same frame on the CPU, and
    ``quantize_int8`` bit-equal to its plain version (q and scales) at each
    of the push's chunk groups.  Then both kernels timed at this layout
    (one push): ``quantize_int8`` over the push's chunk groups,
    ``dequantize_int8`` over one message."""
    from repro_torch.api import _p2p_payload
    from repro_torch.comms.codec import decode_message, encode_message
    from repro_torch.comms.compression import (Int8Codec, UploadCompressor, WirePlan,
                                               decode_flat, decode_upload)
    from repro_torch.core.agg_engine import ravel, tree_layout
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    params = tree_map(lambda t: t.to(dev), TaskConfig(**task).build().init_fn(0))
    layout = tree_layout(params)
    flat = ravel(params)
    edge = WirePlan.of(layout, 1024, 128, dev, port=True)
    groups = len(edge.chunks.groups)
    build.reset_launches()
    payload, meta = _p2p_payload(flat, edge, layout, UploadCompressor(Int8Codec()))
    sent = {k: v for k, v in build.LAUNCHES.items() if v}
    _, imeta, tree = decode_message(encode_message("model", {"site": 0, "round": 1, **meta},
                                                   payload))
    got = ravel(decode_upload(tree, imeta, plan=edge))
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    want, _ = decode_flat(tree, device="cpu")
    _require(torch.equal(got.cpu(), want),
             "a PanSeg push decoded on the card differs from the plain decode")
    _expect_launches("one PanSeg push, sent", sent,
                     {"quantize_int8": groups, "dequantize_int8": 1})
    _expect_launches("one PanSeg push, sent and received", launches,
                     {"quantize_int8": groups, "dequantize_int8": 2})
    print(f"one PanSeg push [{layout.n} values, {groups} chunk groups, "
          f"{edge.table.leaves} leaves]: the card's decode bit-equal to the plain decode")
    mats = edge.chunks.pack(flat)
    for m in mats:
        q, sc = qk.quantize_int8_cuda(m)
        torch.cuda.synchronize()
        q_ref, sc_ref = ref.quantize_int8_ref(m)
        _require(torch.equal(q, q_ref) and torch.equal(sc, sc_ref),
                 f"quantize_int8 at a PanSeg chunk group {list(m.shape)} differs from its "
                 "plain version")
    print(f"quantize_int8 at PanSeg's {groups} chunk groups "
          f"{[list(m.shape) for m in mats]}: bit-equal to the plain version (q and scales)")
    elems = sum(m.numel() for m in mats)
    rows_all = sum(m.shape[0] for m in mats)
    out = {"quantize_int8": measure(
        torch, f"quantize_int8 one PanSeg push x{groups} groups [{elems} elements]",
        lambda: [qk.quantize_int8_cuda(m) for m in mats],
        lambda: [ref.quantize_int8_ref(m) for m in mats], None,
        nbytes=elems * 5 + rows_all * 4, flops=6 * elems)}
    _, q_all, s_all = edge.encode(flat)
    qb, sb = q_all.view(torch.uint8), s_all.view(torch.uint8)
    host_table = torch.from_numpy(edge.table.host)
    leaves = [(q_all[qo: qo + rows * width].view(rows, width), s_all[ro: ro + rows])
              for qo, ro, rows, width in edge._places]
    o1, o2 = torch.empty(layout.n, device=dev), torch.empty(layout.n, device=dev)
    out["dequantize_int8"] = measure(
        torch, f"dequantize_int8 one PanSeg push [{edge.table.leaves} leaves, "
        f"{edge.table.total_rows} rows, {layout.n} values]",
        lambda: qk.dequantize_int8_grouped_cuda(edge.table, qb, sb, o1),
        lambda: ref.dequantize_int8_grouped_ref(host_table, qb, sb, o2),
        lambda: [torch.mul(q, sc[:, None]) for q, sc in leaves],
        nbytes=edge.table.nbytes(), flops=layout.n)
    return out


def check_secure_fold(torch, n: int, sites: int = 4) -> None:
    """Secure aggregation's arithmetic at full width on synthetic rows:
    ``sites`` rows drawn like a model's, masked on the host (the reference's
    Philox streams and fixed point), folded on the card as int64 words and
    unmasked there with the last site missing (its masks repaired; the
    all-folded round is held on the job's own uploads by
    :func:`run_secure_pair`).  The card's global must be bit-equal to the CPU's
    from the same words, and within the fixed point's bound of the float64
    weighted mean of the folded rows: ``k * 2^-33 / W`` absolute (k folded
    sites, half a step each, W their weight total) plus half an fp32 ulp."""
    import numpy as np
    from repro_torch.core.agg_engine import StreamingAccumulator
    from repro_torch.privacy import SecureAggClient, SecureAggState, masked_values
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    rows = [(rng.normal(size=n) * 0.05).astype(np.float32) for _ in range(sites)]
    weights = [1.0 / sites] * sites
    masks = np.ones((2, sites), bool)
    folded = list(range(sites - 1))
    t0 = time.perf_counter()
    enc = [SecureAggClient("s", "site", i).encode({"w": rows[i]}, weights[i],
                                                   list(range(sites)), 1)[0]
           for i in folded]
    t_enc = (time.perf_counter() - t0) / len(folded)
    globals_ = {}
    for where in (dev, torch.device("cpu")):
        acc = StreamingAccumulator()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in folded:
            acc.fold(masked_values(enc[i], device=where), 1.0)
        state = SecureAggState("s", "site", masks)
        g = state.unmask(acc.finalize_int(), 1, set(folded),
                         sum(weights[i] for i in folded))["w"]
        torch.cuda.synchronize()
        globals_[where] = (g.cpu(), time.perf_counter() - t0, state.recovered)
    (card, t_card, rec), (cpu, _, rec_cpu) = globals_[dev], globals_[torch.device("cpu")]
    _require(torch.equal(card, cpu) and rec == rec_cpu,
             f"secure fold of sites {folded}: the card's unmask differs from the CPU's")
    w_tot = sum(weights[i] for i in folded)
    exact = sum(np.float64(weights[i]) * rows[i].astype(np.float64) for i in folded) / w_tot
    err = np.abs(card.numpy().astype(np.float64) - exact)
    bound = len(folded) * 2.0 ** -33 / w_tot + 2.0 ** -24 * np.abs(exact)
    _require(bool((err <= bound).all()),
             f"secure fold of sites {folded}: beyond the fixed point's bound")
    print(f"secure fold of sites {folded} ({n} values, recovered {rec}): the card's global "
          f"bit-equal to the CPU's; max |err| against the float64 mean "
          f"{float(err.max()):.3e} (bound at most {float(bound.max()):.3e}); host encode "
          f"{t_enc:.3f} s a site, fold + unmask on the card {t_card:.3f} s")


def _flat_np(tree):
    import numpy as np
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in _leaves(tree)])


def run_secure_pair(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """OpenKBP FedAvg on the thread transport, plain and with
    ``secure_agg=True``, 2 rounds each, with every site's upload (the
    plaintext row before the mask, in the wire's layout, and its weight)
    and site 0's download of each round recorded.  cuDNN is held to its
    deterministic algorithms for both jobs, so their first-round uploads
    are the same bits.  Held:

    - every round's masked global bit-equal to the fixed point of that
      round's uploads, summed mask-free on the host and decoded in float64
      as the reference does (the masks cancel, the int64 fold and the
      unmask are exact at full width on the job's own uploads);
    - that float64 decode within ``k * 2^-33 / W`` of the exact weighted
      mean (k sites, half a fixed-point step each, W their weight total;
      plus float64's own rounding) and within 2^-28 of the mean's largest
      element;
    - the first round's two globals (same uploads) against that mean: the
      masked one within the fixed-point step plus half an fp32 ulp, the
      plain one within the fp32 fold's bound ``(k + 3) * 2^-24 * sum(w|x|) / W``
      (the weights' and the reciprocal's rounding, k products, k - 1 adds,
      the scaling), and so each other within the sum of the two;
    - the final globals by the socket bound of phase 5b: the second
      round's AdamW step turns the first round's last-bit differences into
      up to ``lr`` on some elements.

    Returns the masked job's launches."""
    import numpy as np
    from repro_torch.comms.peer import Peer
    from repro_torch.privacy import SecureAggClient
    from repro_torch.privacy.secure_agg import FRAC_BITS, _fixed_point
    ups, downs = {}, {}
    upload, download, encode = Peer.upload, Peer.download, SecureAggClient.encode

    def upload_spy(self, addr, weights, round_index, *a, **k):
        if not (k.get("meta_extra") or {}).get("masked"):
            ups[(self.site_id, round_index)] = (_flat_np(weights), None)
        return upload(self, addr, weights, round_index, *a, **k)

    def encode_spy(self, tree, weight, participants, round_index):
        ups[(self.my_id, round_index + 1)] = (_flat_np(tree), float(weight))
        return encode(self, tree, weight, participants, round_index)

    def download_spy(self, addr, round_index, *a, **k):
        out = download(self, addr, round_index, *a, **k)
        if self.site_id == 0:
            downs[round_index] = _flat_np(out[0] if k.get("with_meta") else out)
        return out

    runs = {}
    Peer.upload, Peer.download, SecureAggClient.encode = upload_spy, download_spy, encode_spy
    torch.backends.cudnn.deterministic = True
    try:
        for what, kw in (("openkbp fedavg thread", {}),
                         ("openkbp fedavg thread secure_agg", {"secure_agg": True})):
            ups.clear()
            downs.clear()
            res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                          what, transport="thread", **kw)
            runs[what] = (res, launches, job, dict(ups), dict(downs))
    finally:
        Peer.upload, Peer.download, SecureAggClient.encode = upload, download, encode
        torch.backends.cudnn.deterministic = False
    plain, p_launches, _, p_ups, p_downs = runs["openkbp fedavg thread"]
    res, launches, job, s_ups, s_downs = runs["openkbp fedavg thread secure_agg"]
    _expect_launches("openkbp fedavg thread (plain, secure_agg)", {**p_launches, **launches}, {})
    _require(res.privacy == {"secure_agg": True, "mechanism": "none"} and plain.privacy is None,
             f"openkbp secure_agg: privacy {res.privacy}, plain {plain.privacy}")
    uploads = int(job.masks(ROUNDS).sum())
    _require(res.comm["site_payload_bytes"] == uploads * 8 * FULL_N
             and res.comm["upload_raw_bytes"] == uploads * 4 * FULL_N,
             f"openkbp secure_agg: comm {res.comm}")
    sites = task["sites"]
    cw = job.federation().case_weights()
    for r in range(1, ROUNDS + 1):
        xs = [s_ups[(i, r)][0] for i in range(sites)]
        ws = [s_ups[(i, r)][1] for i in range(sites)]
        words = np.zeros(FULL_N, np.uint64)
        for x, w in zip(xs, ws):
            words += _fixed_point(x, w)
        w_tot = sum(ws)
        dec = words.view(np.int64).astype(np.float64) * (1.0 / (float(2 ** FRAC_BITS) * w_tot))
        _require(np.array_equal(s_downs[r], dec.astype(np.float32)),
                 f"openkbp secure_agg round {r}: the global is not the fixed point of the "
                 "round's uploads")
        exact = sum(np.float64(w) * x.astype(np.float64) for x, w in zip(xs, ws)) / w_tot
        fixed = sites * 2.0 ** -33 / w_tot
        fp_err = float(np.abs(dec - exact).max())
        top = float(np.abs(exact).max())
        # the float64 decode and mean round at 2^-53 of the largest element
        _require(fp_err <= fixed + 2.0 ** -50 * top and fp_err <= 2.0 ** -28 * top,
                 f"openkbp secure_agg round {r}: fixed-point error {fp_err:.3e} beyond "
                 f"{fixed:.3e} or 2^-28 of {top:.3e}")
        print(f"openkbp secure_agg round {r}: the global bit-equal to the fixed point of the "
              f"round's {sites} uploads; the float64 decode within {fp_err:.3e} of the exact "
              f"mean (bound {fixed:.3e}; {fp_err / top:.3e} of its largest |element| "
              f"{top:.3e}, bound 2^-28 = {2.0 ** -28:.3e})")
        if r != 1:
            continue
        same = all(np.array_equal(p_ups[(i, 1)][0], x) for i, x in enumerate(xs))
        _require(same, "openkbp: the plain and masked jobs' first-round uploads differ")
        wabs = sum(np.float64(w) * np.abs(x.astype(np.float64)) for x, w in zip(xs, cw)) / w_tot
        bound_sa = (fixed + 2.0 ** -24 * np.abs(exact)) * (1 + 2.0 ** -20)
        bound_plain = (sites + 3) * 2.0 ** -24 * wabs * (1 + 2.0 ** -20)
        g_sa, g_plain = s_downs[1].astype(np.float64), p_downs[1].astype(np.float64)
        e_sa, e_plain = np.abs(g_sa - exact), np.abs(g_plain - exact)
        gap = np.abs(g_sa - g_plain)
        _require(bool((e_sa <= bound_sa).all()) and bool((e_plain <= bound_plain).all())
                 and bool((gap <= bound_sa + bound_plain).all()),
                 "openkbp round 1: a global beyond its rounding bound")
        print(f"openkbp round 1 (the same uploads, bit for bit): masked global within "
              f"{float(e_sa.max()):.3e} of the exact mean (bound at most "
              f"{float(bound_sa.max()):.3e}), plain within {float(e_plain.max()):.3e} (bound "
              f"at most {float(bound_plain.max()):.3e}); masked against plain: max |gap| "
              f"{float(gap.max()):.3e}, {int((gap > 0).sum())} of {FULL_N} elements differ, "
              f"{float(gap.max()) / top:.3e} of the largest |element|")
    _held_to(torch, job, res, plain, "openkbp secure_agg against plain", FULL_N)
    return launches


def run_serverless_private(torch, FederatedJob, TaskConfig, build, tasks, gossip,
                           fedprox_comm, counts) -> dict:
    """Phase 15, the serverless and private socket deployment, at full
    width on the thread transport.  Returns each job's launches.

    - PanSeg GCML (5 sites): the CoordinationServer pairs the sites, which
      push their rows to each other and run the DCML step on the card.
      Dense, no kernel runs (the final fold is the driver's); its global is
      held to phase 13's stacked GCML (the same seed, so the same pairings)
      by the socket bound of phase 5b.  With int8 pushes: per push
      ``quantize_int8`` once a chunk width and ``dequantize_int8`` twice
      (the push stream's residual at the sender, the decode at the
      receiver); the pushes' bytes exact; one push's decode bit-equal to
      the plain one and both kernels timed at this layout.
    - BraTS FedProx (4 sites, the case counts) with int8 both ways: each
      site's anchor, read at each round's first local step (one step a
      round), must be the global it installed bit for bit; the payload bytes
      equal phase 12's stacked FedProx + int8 job's; ``fedagg`` once a site
      (its round-0 anchor), the int8 kernels as phase 5b counts them.
    - OpenKBP FedAvg with ``secure_agg=True`` (4 sites) and its plain twin:
      ``privacy`` must be the reference's dict, the masked words 8 bytes a
      value, every round's masked global bit-equal to the fixed point of
      the job's own uploads and the first round's held to the plain job's
      (:func:`run_secure_pair`); then the missing-site repair on synthetic
      rows (:func:`check_secure_fold`)."""
    import numpy as np
    from repro_torch.core.round_engine import bootstrap_masks
    from repro_torch.core.strategies.fedprox import FedProxLocal
    from repro_torch.core.agg_engine import ravel
    pan, brats, openkbp = tasks
    paths = {}
    res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, pan, PANSEG_N,
                                  "panseg gcml thread", transport="thread", strategy="gcml")
    _expect_launches("panseg gcml thread", launches, {})
    _require(res.comm is None and res.privacy is None,
             f"panseg gcml thread: comm {res.comm}, privacy {res.privacy}")
    _held_to(torch, job, res, gossip, "panseg gcml thread against stacked", PANSEG_N)
    paths["panseg gcml thread"] = launches
    del res
    groups, enc_bytes = _chunk_groups(torch, TaskConfig, pan)
    pushes = ROUNDS * (pan["sites"] // 2)
    res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, pan, PANSEG_N,
                                  "panseg gcml thread int8", transport="thread",
                                  strategy="gcml", compression="int8")
    _expect_launches("panseg gcml thread int8", launches,
                     {"quantize_int8": groups * pushes, "dequantize_int8": 2 * pushes})
    c = res.comm
    _require(c["upload_count"] == pushes and c["upload_bytes"] == pushes * enc_bytes
             and c["upload_raw_bytes"] == pushes * 4 * PANSEG_N and c["download_bytes"] == 0,
             f"panseg gcml thread int8: comm {c}, {pushes} pushes of {enc_bytes} bytes")
    paths["panseg gcml thread int8"] = launches
    del res
    push_times = check_push_decode(torch, build, TaskConfig, pan)

    seen = []
    extra = FedProxLocal.local_loss_extra

    def anchor_spy(self, params_site, strat_state, ctx):
        seen.append(torch.equal(ravel(params_site).detach(), strat_state["global"]))
        return extra(self, params_site, strat_state, ctx)

    FedProxLocal.local_loss_extra = anchor_spy
    try:
        res, launches, job = _run_job(
            torch, FederatedJob, TaskConfig, build, brats, BRATS_N, "brats fedprox thread int8",
            transport="thread", strategy="fedprox", prox_mu=PROX_MU, case_counts=counts, compression="int8",
            down_compression="int8")
    finally:
        FedProxLocal.local_loss_extra = extra
    masks = job.masks(ROUNDS)
    boot = bootstrap_masks(masks, 16)
    ups = int(masks.sum())
    deltas = int((masks & ~boot).sum())
    g_brats, _ = _chunk_groups(torch, TaskConfig, brats)
    _expect_launches("brats fedprox thread int8", launches,
                     {"fedagg": brats["sites"], "quantize_int8": g_brats * (ups + deltas),
                      "dequantize_int8": 2 * ups + 2 * deltas})
    print(f"brats fedprox thread int8: {sum(seen)} of {len(seen)} first local steps start at "
          "an anchor bit-equal to the installed global")
    _require(len(seen) == ups and all(seen),
             "brats fedprox thread int8: an anchor is not the installed global")
    c = res.comm
    _require(c["site_payload_bytes"] == fedprox_comm["upload_bytes"]
             and c["download_payload_bytes"] == fedprox_comm["download_bytes"],
             f"brats fedprox thread int8: payload bytes {c} against stacked {fedprox_comm}")
    paths["brats fedprox thread int8"] = launches
    del res

    paths["openkbp fedavg thread secure_agg"] = run_secure_pair(
        torch, FederatedJob, TaskConfig, build, openkbp)
    check_secure_fold(torch, FULL_N)
    print(f"phase 15 launches by path: {paths}")
    print(f"phase 15 kernels at PanSeg's layout (one push): "
          f"{json.dumps({k: {m: v[m] for m in ('ms', 'eager_ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')} for k, v in push_times.items()})}")
    return paths


# -- the token models' kernels and serving paths ---------------------------------


# -- two-tier pods and buffered rounds (phase 16) --------------------------------

TRIM_TOL = dict(rtol=1e-6, atol=1e-7)    # tests/test_torch_robust.py's
PODS_SEED = 0     # the main path's seed: with pod_dropout=1 it takes pod 0 of
                  # case b offline in rounds 1 and 2


class _Spy:
    """Wraps ``owner.name`` while the ``with`` block runs: each call goes to
    the original, and ``calls`` gets ``(pre(args, kwargs), post(args,
    kwargs, out))`` (``pre`` sees the inputs before the call may change
    them)."""

    def __init__(self, owner, name, pre=None, post=None):
        self.owner, self.name, self.pre, self.post = owner, name, pre, post
        self.calls = []

    def __enter__(self):
        self.orig = orig = getattr(self.owner, self.name)

        def wrapper(*a, **k):
            before = self.pre(a, k) if self.pre is not None else None
            out = orig(*a, **k)
            self.calls.append((before, self.post(a, k, out) if self.post is not None else None))
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _flat(torch, tree):
    return torch.cat([t.reshape(-1) for t in _leaves(tree)])


def _rounding_check(torch, what, rows, w, got, bound_terms: int) -> float:
    """``got`` [N] within ``bound_terms * 2^-24 * sum_s w_s |x_s|`` of the
    exact (float64) weighted mean of ``rows`` [S, N] at normalized weights
    ``w`` [S]; returns the largest |error| over the bound."""
    x = rows.double()
    wd = w.double()[:, None]
    exact = (wd * x).sum(0)
    bound = bound_terms * 2.0 ** -24 * (wd * x.abs()).sum(0) * (1 + 2.0 ** -20)
    err = (got.double() - exact).abs()
    _require(bool((err <= bound).all()), f"{what}: beyond its fp32 rounding bound")
    return float((err / bound.clamp_min(1e-300)).max())


def _hold_qdq(torch, what: str, u, plan, deq) -> list:
    """``quantize_int8`` and ``dequantize_int8`` on ``plan``'s chunk
    matrices of ``u`` bit-equal to their plain versions, and the job's
    ``deq`` (its ``round_engine.qdq`` of ``u``) the kernels' decode; returns
    the matrices' shapes."""
    from repro_torch.kernels import quantize, ref
    mats = []
    for mat in plan.pack(u):
        m2 = mat.reshape(-1, mat.shape[-1])
        qk, sk = quantize.quantize_int8_cuda(m2)
        qp, sp = ref.quantize_int8_ref(m2)
        dk, dp = quantize.dequantize_int8_cuda(qk, sk), ref.dequantize_int8_ref(qp, sp)
        _require(torch.equal(qk, qp) and _bits_equal(torch, sk, sp) and _bits_equal(torch, dk, dp),
                 f"{what}: quantize/dequantize differ from the plain versions at "
                 f"{tuple(m2.shape)}")
        mats.append(dk.view(mat.shape))
    _require(_bits_equal(torch, plan.unpack(mats), deq), f"{what}: the job's qdq is not the kernels'")
    return [tuple(m.shape) for m in mats]


def run_pods_stacked(torch, FederatedJob, TaskConfig, build, task, flat_main, int8_comm):
    """Phase 16 a-c: ``pods:2`` on the stacked transport at full width.

    a. FedAvg, 2 rounds, against phase 3's flat job.  cuDNN's deterministic
       algorithms, here and for a 1-round flat twin, make round 0's trained
       rows the same bits in both; each round-0 global is held to the exact
       (float64) mean of those rows by its fp32 bound, ``(S + 3) * 2^-24 *
       sum w|x|`` flat and ``(S + P + 6) * 2^-24 * sum w|x|`` in two tiers
       (the one-hot product's and the cross-pod fold's roundings).  The
       final global is held to phase 3's by the socket bound of phase 5b;
       ``comm`` is ``simulated_pods_comm``'s; ``fedagg`` runs on [2, N] once
       a round (the cross-pod combine) and once on the final rows.
    b. ``Topology(pods, 2, assignment=(0, 0, 0, 1))`` under ``trimmed:1``
       with ``pod_dropout=1``, ``max_dropout=1``, 3 rounds: a whole pod goes
       offline; ``trimmed_mean`` once a pod a round (a pod without an active
       member included: an all-zero mask), ``fedagg`` once a round on [2, N]
       and once at the end; every round's two-tier global held to the plain
       engine (``trimmed_mean_ref`` a pod, ``fedagg_ref``) on the same rows
       by ``TRIM_TOL``.
    c. int8 both ways, 2 rounds: the uploads quantized and dequantized a
       chunk width at a time (not the fused ``fedagg_dequant``), folded in
       two tiers; the intra-pod bytes equal phase 4's flat int8 job's, the
       cross-pod bytes dense a pod a round; ``quantize_int8``,
       ``dequantize_int8`` and ``dequant_install`` bit-equal to their plain
       versions on the job's own last-round chunks.
    Returns (case c's result, {case: launches})."""
    import numpy as np
    from repro_torch.core import round_engine
    from repro_torch.core.agg_engine import AggregationEngine
    from repro_torch.core.topology import Topology, simulated_pods_comm
    from repro_torch.kernels import fedagg as fedagg_mod, ops, quantize, ref
    out = {}
    shapes = []
    rows_of = _Spy(AggregationEngine, "aggregate_round",
                   pre=lambda a, k: a[1].clone(), post=lambda a, k, o: o[1].clone())
    # (a) the composition law at round 0, then the pods job to the end
    torch.backends.cudnn.deterministic = True
    try:
        with rows_of, _Spy(ops, "fedagg", pre=lambda a, k: tuple(a[0].shape)) as shp:
            _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                     "16a flat fedavg, round 0 (deterministic cuDNN)", rounds=1)
            flat_rows, flat_g = rows_of.calls[-1]
            shp.calls.clear()
            res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                          "16a pods:2 fedavg", topology="pods:2",
                                          seed=PODS_SEED)
            shapes = [c[0] for c in shp.calls]
    finally:
        torch.backends.cudnn.deterministic = False
    pods_rows, pods_g = rows_of.calls[-ROUNDS]
    _require(torch.equal(flat_rows, pods_rows), "16a: round 0's trained rows differ")
    w = torch.as_tensor(job.federation().case_weights(), device=pods_rows.device)
    w = w / w.sum()
    s, p = task["sites"], 2
    r_flat = _rounding_check(torch, "16a flat round 0", flat_rows, w, flat_g, s + 3)
    r_pods = _rounding_check(torch, "16a pods round 0", pods_rows, w, pods_g, s + p + 6)
    gap = (flat_g - pods_g).abs()
    print(f"16a round 0: flat and pods globals within {r_flat:.3f} and {r_pods:.3f} of their "
          f"fp32 bounds of the exact mean; they differ on {int((gap > 0).sum())} of {FULL_N} "
          f"elements, by at most {float(gap.max()):.3e}")
    _held_to(torch, job, res, flat_main, "16a pods:2 fedavg against phase 3", FULL_N)
    masks = job.masks(ROUNDS)
    want_comm = simulated_pods_comm(job.topo, masks, DENSE_BYTES)
    _require(res.comm == want_comm, f"16a comm {res.comm} != {want_comm}")
    _expect_launches("16a pods:2 fedavg", launches, {"fedagg": ROUNDS + 1})
    _require(shapes == [(p, FULL_N)] * ROUNDS + [(s, FULL_N)],
             f"16a fedagg shapes {shapes}")
    print(f"16a: fedagg launched {launches.get('fedagg', 0)} times, at {shapes}")
    out["a"] = launches

    # (b) a rank rule a pod, a whole pod offline
    topo = Topology(kind="pods", num_pods=2, assignment=(0, 0, 0, 1))
    robust = _Spy(AggregationEngine, "reduce_pods_robust",
                  pre=lambda a, k: (a[1].clone(), np.asarray(a[2], bool).copy()),
                  post=lambda a, k, o: o.clone())
    with robust:
        res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                      "16b pods trimmed:1, pod_dropout=1", rounds=3,
                                      topology=topo, aggregator="trimmed:1", pod_dropout=1,
                                      max_dropout=1, seed=PODS_SEED)
    masks = job.masks(3)
    pod_of = topo.pod_of(s)
    offline = [r for r in range(3) if any(not masks[r][pod_of == q].any() for q in range(2))]
    _require(bool(offline), f"16b: no round with a whole pod offline ({masks.tolist()})")
    print(f"16b: masks {masks.astype(int).tolist()}; a whole pod offline in rounds {offline}")
    _expect_launches("16b pods trimmed:1", launches, {"trimmed_mean": 2 * 3, "fedagg": 3 + 1})
    worst = 0.0
    for (rows, active), got in robust.calls:
        members = [torch.as_tensor((pod_of == q) & active, device=rows.device).float()
                   for q in range(2)]
        parts = torch.stack([ref.trimmed_mean_ref(rows, m, 1) for m in members])
        cnt = torch.stack([m.sum() for m in members])
        want = ref.fedagg_ref(parts, cnt / (cnt.sum() + 1e-12))
        torch.testing.assert_close(got, want, **TRIM_TOL)
        worst = max(worst, float((got - want).abs().max()))
    print(f"16b: {len(robust.calls)} two-tier globals within rtol 1e-6, atol 1e-7 of the plain "
          f"engine on the card's rows (max |err| {worst:.3e})")
    out["b"] = launches

    # (c) int8 both ways in two tiers
    qdq = _Spy(round_engine, "qdq", pre=lambda a, k: (a[0].clone(), a[1]),
               post=lambda a, k, o: o.clone())
    inst = _Spy(round_engine, "down_install", pre=lambda a, k: (a[0].clone(), a[1].clone(), a[2]),
                post=lambda a, k, o: o.clone())
    with qdq, inst:
        res_c, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                        "16c pods:2 int8 both ways", topology="pods:2",
                                        compression="int8", down_compression="int8",
                                        seed=PODS_SEED)
    masks = job.masks(ROUNDS)
    c = res_c.comm
    cross = simulated_pods_comm(job.topo, masks, DENSE_BYTES)["cross_pod_upload_bytes"]
    _require(c["intra_pod_upload_bytes"] == int8_comm["upload_bytes"]
             and c["intra_pod_download_bytes"] == int8_comm["download_bytes"]
             and c["cross_pod_upload_bytes"] == c["cross_pod_download_bytes"] == cross
             == 2 * ROUNDS * DENSE_BYTES,
             f"16c comm {c} against phase 4's {int8_comm}")
    (u, plan), deq = qdq.calls[-1][0], qdq.calls[-1][1]
    g_count = len(plan.groups)
    _expect_launches("16c pods:2 int8", launches,
                     {"quantize_int8": 2 * g_count * ROUNDS, "dequantize_int8": g_count * ROUNDS,
                      "dequant_install": g_count * ROUNDS, "fedagg": 2 * ROUNDS})
    shapes = _hold_qdq(torch, "16c", u, plan, deq)
    (g, held, dplan), installed = inst.calls[-1]
    parts = []
    for d, h in zip(dplan.pack(g[None] - held), dplan.pack(held)):
        n_s, rows, width = d.shape
        qk, sk = quantize.quantize_int8_cuda(d.reshape(n_s * rows, width))
        ik = fedagg_mod.dequant_install_cuda(qk.view(n_s, rows, width), sk.view(n_s, rows), h)
        ip = ref.dequant_install_ref(qk.view(n_s, rows, width), sk.view(n_s, rows), h)
        _require(_bits_equal(torch, ik, ip), "16c: dequant_install differs from the plain version")
        parts.append(ik)
    _require(_bits_equal(torch, dplan.unpack(parts), installed),
             "16c: the job's install is not the kernel's")
    print(f"16c: comm {c}; quantize_int8, dequantize_int8 and dequant_install bit-equal to "
          f"their plain versions on the job's last-round chunks ({g_count} chunk widths, "
          f"{shapes})")
    out["c"] = launches
    return res_c, out


def _buffered_replay(masks, seed, sched):
    """The buffered schedule replayed on the host from the scheduler's own
    ``discount`` and ``ready``: per round its arrivals (site, folded,
    fired) and the version after it."""
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    version, count = 0, 0
    base = np.zeros(masks.shape[1], np.int64)
    rounds, versions = [], []
    for r in range(masks.shape[0]):
        active = np.flatnonzero(masks[r])
        arrivals, uploaded = [], []
        for site in rng.permutation(active):
            site = int(site)
            if sched.discount(version - int(base[site])) is None:
                base[site] = version
                arrivals.append((site, False, False))
                continue
            count += 1
            uploaded.append(site)
            fire = sched.ready(count, len(active))
            version, count = (version + 1, 0) if fire else (version, count)
            arrivals.append((site, True, fire))
        base[uploaded] = version
        rounds.append(arrivals)
        versions.append(version)
    return rounds, versions


def run_buffered_stacked(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 16 d: buffered FedAvg at full width, 3 rounds, ``buffer_k=2``,
    ``max_dropout=1``: dense and int8 on the scan engine's schedule, and
    int8 with ``max_staleness=16`` on the reference's host loop.  Each job's
    recorded versions must equal a host replay of the schedule from the
    scheduler's own ``discount`` and ``ready``, and its global the plain
    float64 fold ``sum w d / sum w`` of the decoded arrivals of the last
    version (recorded as the job folded them) within ``FP32_TOL``.
    ``fedagg`` once (version 0); the int8 scan one ``quantize_int8`` and one
    ``dequantize_int8`` an arrival (the flat layout: one chunk width), both
    bit-equal to their plain versions on the last arrival's flat matrix,
    whose decode must be the job's; the host loop ``quantize_int8`` once a
    chunk width an upload and ``dequantize_int8`` twice (the residual, the
    decode)."""
    from repro_torch.comms.compression import chunk_geom
    from repro_torch.core import round_engine
    from repro_torch.core.agg_engine import StreamingAccumulator, ravel
    from repro_torch.core.session import BufferedScheduler
    groups = len(round_engine.ChunkPlan.of(_layout_of(TaskConfig, task), 1024, 128,
                                           torch.device("cpu")).groups)
    out = {}
    cases = [("16d buffered dense", BufferedScheduler(buffer_k=2), {},
              round_engine, "fold_arrival", lambda a, k: (a[1].clone(), float(a[2]))),
             ("16d buffered int8 (scan)", BufferedScheduler(buffer_k=2),
              {"compression": "int8"}, round_engine, "fold_arrival",
              lambda a, k: (a[1].clone(), float(a[2]))),
             ("16d buffered int8 (host loop)", BufferedScheduler(buffer_k=2, max_staleness=16),
              {"compression": "int8"}, StreamingAccumulator, "fold",
              lambda a, k: (ravel(a[1]).clone(), float(a[2])))]
    for what, sched, kw, owner, name, pre in cases:
        with _Spy(owner, name, pre=pre) as folds, \
                _Spy(round_engine, "qdq", pre=lambda a, k: (a[0].clone(), a[1]),
                     post=lambda a, k, o: o.clone()) as qdqs:
            res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                          what, rounds=3, scheduler=sched, max_dropout=1,
                                          seed=PODS_SEED, **kw)
        masks = job.masks(3)
        arrivals, versions = _buffered_replay(masks, job.seed, sched)
        got_versions = [h["version"] for h in res.history]
        _require(got_versions == versions, f"{what}: versions {got_versions} != {versions}")
        fired = [a[2] for rnd in arrivals for a in rnd if a[1]]
        _require(len(fired) == len(folds.calls), f"{what}: {len(folds.calls)} folds recorded, "
                 f"{len(fired)} in the schedule")
        last = max(i for i, f in enumerate(fired) if f)
        first = max([i + 1 for i, f in enumerate(fired[:last]) if f] + [0])
        d = torch.stack([folds.calls[i][0][0] for i in range(first, last + 1)]).double()
        wts = torch.tensor([folds.calls[i][0][1] for i in range(first, last + 1)],
                           dtype=torch.float64, device=d.device)
        want = (wts[:, None] * d).sum(0) / wts.sum()
        got = _flat(torch, res.global_params).double()
        torch.testing.assert_close(got, want, **FP32_TOL)
        folds_n = len(fired)
        expect = {"fedagg": 1}
        held = ""
        if "compression" in kw and sched.max_staleness < 16:
            expect.update(quantize_int8=folds_n, dequantize_int8=folds_n)
            rows_f, c_f = chunk_geom(FULL_N, 1024, 1)
            _require(res.comm["upload_bytes"] == folds_n * (rows_f * c_f + 4 * rows_f),
                     f"{what}: comm {res.comm}")
            _require(len(qdqs.calls) == folds_n,
                     f"{what}: {len(qdqs.calls)} qdq calls for {folds_n} folds")
            (u, plan), deq = qdqs.calls[-1]
            shapes = _hold_qdq(torch, what, u, plan, deq)
            _require(shapes == [(rows_f, c_f)], f"{what}: the flat layout is {shapes}, not "
                     f"{[(rows_f, c_f)]}")
            held = (f"; quantize_int8 and dequantize_int8 bit-equal to their plain versions "
                    f"on the last arrival's flat {shapes[0]} matrix")
        elif "compression" in kw:
            expect.update(quantize_int8=groups * folds_n, dequantize_int8=2 * folds_n)
        _expect_launches(what, launches, expect)
        print(f"{what}: versions {got_versions} (the host replay's); {folds_n} folds; the "
              f"global within fp32 rtol=atol=1e-6 of the plain fold of version "
              f"{versions[-1]}'s {last + 1 - first} arrivals (max |err| "
              f"{float((got - want).abs().max()):.3e}); comm {res.comm}{held}")
        out[what] = launches
    return out


def _layout_of(TaskConfig, task):
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.core.stacking import broadcast_to_sites
    return get_engine().layout_of(broadcast_to_sites(TaskConfig(**task).build().init_fn(0), 1))


def _tier_spies(torch):
    """Spies on a socket pods job's servers: ``events`` gets, in each
    server's order, ``("fold", server, site, weight, decoded, decode)`` for
    every plaintext fold (``decode`` = the upload's payload, meta and
    reference on the host, as the handler thread decoded it) and
    ``("final", server, flat, weight)`` for every finalized buffer."""
    import threading
    from repro_torch.comms import compression
    from repro_torch.comms.coordinator import AggregationServer
    events, tl = [], threading.local()

    def decoded(a, k, out):
        ref = a[2]
        tl.last = (a[0], dict(a[1]), None if ref is None else tree_map_cpu(ref))

    def folded(a, k):
        server, site, meta, tree = a[:4]
        events.append(("fold", server, int(site),
                       float(meta.get("weight", server.weights[site])), _flat(torch, tree),
                       getattr(tl, "last", None)))
        tl.last = None

    def finalized(a, k, out):
        if out[0] is not None:
            events.append(("final", a[0], _flat(torch, out[0]), float(out[1])))

    spies = [_Spy(compression, "decode_upload", post=decoded),
             _Spy(AggregationServer, "_fold", pre=folded),
             _Spy(AggregationServer, "_finalize_buffer", post=finalized)]
    return spies, events


def _hold_fold(torch, what: str, folds, got, weight: float) -> float:
    """A server's finalized buffer ``got`` within the fp32 bound ``(3k +
    2) * 2^-24 * sum w|x| / sum w`` of the exact (float64) fold of its
    ``k`` decoded inputs at their weights (a product, a rounded weight and
    a sum an input, the normalization), and its weight their sum."""
    wts = [f[1] for f in folds]
    _require(math.isclose(weight, sum(wts), rel_tol=1e-12),
             f"{what}: weight {weight}, the folds' {sum(wts)}")
    rows = torch.stack([f[2] for f in folds])
    w = torch.tensor(wts, dtype=torch.float64, device=rows.device)
    return _rounding_check(torch, what, rows, w / w.sum(), got, 3 * len(folds) + 2)


def _elem_scales(torch, payload):
    """Each element's quantization step in an int8 payload (0 for a dense
    leaf): the payload decoded on the host with every q set to 1."""
    import numpy as np
    from repro_torch.comms.codec import QuantizedTensor
    from repro_torch.comms.compression import decode_flat
    from repro_torch.tree import tree_map
    ones = tree_map(lambda x: QuantizedTensor(x.codec, x.shape, {
        "q": np.ones_like(x.data["q"]), "scale": x.data["scale"]})
        if isinstance(x, QuantizedTensor) else np.zeros_like(x), payload)
    return decode_flat(ones, device="cpu")[0].double()


def _hold_pod_tiers(torch, job, events, what: str) -> str:
    """Both tiers of a socket pods job (sync tiers, plaintext) held to their
    own inputs, from :func:`_tier_spies`' events:

    - every upload a server decoded (sites' at their pod server, leaders'
      at the root) bit-equal to its plain decode on the host
      (``dequantize_int8``'s plain version, ``+`` the same reference);
    - each pod's partial a round: folded from exactly its active members,
      at their case weights, within :func:`_hold_fold`'s bound;
    - each leader's upload, decoded at the root, within its quantization
      error of its pod's partial: ``|x - p| <= (s_t + s_t-1) / 2`` (its
      error-feedback residuals, this upload's and the last one's, at each
      element's step; ``1 + 2^-15`` for the fp32 quotient inside ``rint``)
      plus 2^-21 of the magnitudes;
    - the root's global a round: folded from exactly the active pods, each
      at its partial's weight, within :func:`_hold_fold`'s bound.
    A dropped, doubled or misweighted upload or partial, or a wrong decode,
    fails.  Returns a summary."""
    import numpy as np
    from repro_torch.comms.compression import WirePlan, align_for, decode_upload
    from repro_torch.comms.pods import PodAggregationServer
    from repro_torch.core.agg_engine import tree_layout
    cpu = torch.device("cpu")
    rounds, p = job.rounds, job.topo.num_pods
    masks = job.masks(rounds)
    pod_of = job.topo.pod_of(job.task.sites)
    groups, pending = {}, {}
    for ev in events:
        if ev[0] == "fold":
            pending.setdefault(ev[1], []).append(ev[2:])
        else:
            groups.setdefault(ev[1], []).append((pending.pop(ev[1], []), ev[2], ev[3]))
    _require(not any(pending.values()), f"{what}: folds after a server's last finalize")
    pods = sorted((s for s in groups if isinstance(s, PodAggregationServer)),
                  key=lambda s: s.pod_id)
    roots = [s for s in groups if not isinstance(s, PodAggregationServer)]
    _require(len(pods) == p and len(roots) == 1, f"{what}: {len(pods)} pod servers and "
             f"{len(roots)} roots finalized")
    decodes = 0
    for srv in groups:
        for folds, _, _ in groups[srv]:
            for _, _, x, (payload, meta, ref) in folds:
                plan = WirePlan.of(tree_layout(payload), 1024, align_for(cpu), cpu, port=False)
                want = _flat(torch, decode_upload(payload, meta, ref, plan=plan))
                _require(_bits_equal(torch, x.cpu(), want),
                         f"{what}: a server's decode differs from the plain decode")
                decodes += 1
    partials, worst = {}, 0.0
    for srv in pods:
        q = srv.pod_id
        members = pod_of == q
        active = [r for r in range(rounds) if (masks[r] & members).any()]
        _require(len(groups[srv]) == len(active),
                 f"{what}: pod {q} made {len(groups[srv])} partials for {len(active)} rounds")
        for r, (folds, got, w) in zip(active, groups[srv]):
            sites = sorted(f[0] for f in folds)
            _require(sites == [int(i) for i in np.flatnonzero(masks[r] & members)],
                     f"{what}: pod {q} round {r} folded sites {sites}")
            worst = max(worst, _hold_fold(torch, f"{what} pod {q} round {r}", folds, got, w))
            partials[(q, r)] = (got, w)
    root = roots[0]
    _require(len(groups[root]) == rounds, f"{what}: {len(groups[root])} root rounds")
    prev = {}
    for r, (folds, got, w) in enumerate(groups[root]):
        pods_in = sorted(f[0] for f in folds)
        _require(pods_in == [q for q in range(p) if (q, r) in partials],
                 f"{what}: root round {r} folded pods {pods_in}")
        for q, pw, x, (payload, meta, ref) in folds:
            part, part_w = partials[(q, r)]
            _require(pw == part_w, f"{what}: pod {q} round {r} at weight {pw}, its partial's "
                     f"{part_w}")
            sc = _elem_scales(torch, payload)
            sc_prev = prev.get(q, torch.zeros_like(sc))
            prev[q] = sc
            pd = part.cpu().double()
            mag = pd.abs() + sc + sc_prev
            if ref is not None:
                mag += _flat(torch, ref).double().abs()
            bound = 0.5 * (sc + sc_prev) * (1 + 2.0 ** -15) + 2.0 ** -21 * mag
            _require(bool(((x.cpu().double() - pd).abs() <= bound).all()),
                     f"{what}: pod {q}'s upload in round {r} is not its partial")
        worst = max(worst, _hold_fold(torch, f"{what} root round {r}", folds, got, w))
    return (f"{decodes} server decodes bit-equal to the plain decode; {len(partials)} pod "
            f"partials and {rounds} root globals each the fold of exactly its active inputs "
            f"at their weights (within {worst:.3f} of the fp32 bound); each leader's upload "
            f"within its int8 step of its pod's partial")


def run_pods_sockets(torch, FederatedJob, TaskConfig, build, task, stacked_int8) -> dict:
    """Phase 16 e-g on the thread transport at full width, 2 rounds.

    e. ``pods:2`` int8 both ways: each tier held to its own inputs
       (:func:`_hold_pod_tiers`: every server decode bit-equal to the plain
       decode, every partial and root global the fp32 fold of exactly its
       active inputs at their weights, each leader's upload within its int8
       step of its partial).  The leaders re-upload their partials int8 (a
       delta against the last root global they pulled, with their own error
       feedback) where the stacked twin (case c) folds them dense in fp32,
       so the global is held to case c's only within ``lr * rounds``
       everywhere, and the count outside phase 5b's bound is printed; the
       sites' payload bytes equal case c's intra-pod upload bytes; the root
       folds one partial an active pod a round.
    f. a sync pod tier under a buffered root (``buffer_k=2``), dense: the
       reference's invariants (finite losses, every scheduled upload made,
       one partial an active pod a round at the root, cross-pod bytes).
    g. ``secure_agg`` at both tiers beside the plain pods job (cuDNN's
       deterministic algorithms, so round 0's uploads are the same bits):
       each round's partial a pod server unmasked, as its leader masks it
       again, bit-equal to the host's mask-free fixed point of its sites'
       uploads, and the root's global (site 0's download) bit-equal to the
       fixed point of the leaders' partials; the final global held to the
       plain pods job's by phase 5b's bound.
    Returns {case: launches}."""
    import numpy as np
    from repro_torch.comms.peer import Peer
    from repro_torch.comms.pods import PodTransport
    from repro_torch.core.session import BufferedScheduler
    from repro_torch.core.topology import Topology, active_pod_counts
    from repro_torch.privacy import SecureAggClient
    from repro_torch.privacy.secure_agg import FRAC_BITS, _fixed_point
    out = {}
    root_uploads = _Spy(PodTransport, "comm",
                        pre=lambda a, k: a[0].root.stats.snapshot().get("upload", {}).get(
                            "count", 0))
    spies, events = _tier_spies(torch)
    with root_uploads, spies[0], spies[1], spies[2]:
        res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                      "16e thread pods:2 int8 both ways", transport="thread",
                                      topology="pods:2", compression="int8",
                                      down_compression="int8", seed=PODS_SEED)
    print(f"16e: {_hold_pod_tiers(torch, job, events, '16e')}")
    del events[:]
    masks = job.masks(ROUNDS)
    pods_rounds = int(active_pod_counts(job.topo, masks).sum())
    worst, outside = _outside(res.global_params, stacked_int8.global_params)
    print(f"16e: against case c: max |difference| {worst:.3e} (bound lr * rounds "
          f"{job.lr * ROUNDS}); outside rtol 2e-3, atol 2e-4 (leaf, shape, count, max): "
          f"{outside} ({sum(b for _, _, b, _ in outside)} of {FULL_N})")
    _require(worst <= job.lr * ROUNDS, "16e: globals beyond lr * rounds of case c's")
    _require(res.comm["site_payload_bytes"] == stacked_int8.comm["intra_pod_upload_bytes"],
             f"16e: site payload {res.comm['site_payload_bytes']} != case c's intra-pod "
             f"{stacked_int8.comm['intra_pod_upload_bytes']}")
    _require(root_uploads.calls[-1][0] == pods_rounds,
             f"16e: {root_uploads.calls[-1][0]} cross-pod uploads, {pods_rounds} expected")
    print(f"16e: comm {res.comm}; {pods_rounds} cross-pod uploads")
    out["e"] = launches

    topo = Topology.pods(2, inter_scheduler=BufferedScheduler(buffer_k=2))
    with root_uploads:
        res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                      "16f thread pods:2, a buffered root", transport="thread",
                                      topology=topo, seed=PODS_SEED)
    c = res.comm
    _require(c["upload_count"] == int(job.masks(ROUNDS).sum()) and c["cross_pod_upload_bytes"] > 0
             and root_uploads.calls[-1][0] == pods_rounds
             and all(s <= 1 for s in res.history[-1]["stale_uploads"]),
             f"16f: comm {c}, root uploads {root_uploads.calls[-1][0]}, stale "
             f"{res.history[-1]['stale_uploads']}")
    out["f"] = launches

    # (g) secure aggregation at both tiers, beside the plain pods job
    ups, downs = {}, {}

    def encode_pre(a, k):       # (client, tree, weight, participants, round_index)
        client, tree, weight, _, round_index = a
        ups[(client.tier, client.my_id, round_index + 1)] = (_flat_np(tree), float(weight))

    def download_post(a, k, got):   # (peer, addr, round_index, ...)
        if a[0].site_id == 0 and a[2]:
            downs[a[2]] = _flat_np(got[0] if k.get("with_meta") else got)

    torch.backends.cudnn.deterministic = True
    try:
        with _Spy(SecureAggClient, "encode", pre=encode_pre), \
                _Spy(Peer, "download", post=download_post):
            plain, p_launches, _ = _run_job(torch, FederatedJob, TaskConfig, build, task,
                                            FULL_N, "16g thread pods:2", transport="thread",
                                            topology="pods:2", seed=PODS_SEED)
            downs.clear()
            res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                          "16g thread pods:2 secure_agg", transport="thread",
                                          topology="pods:2", secure_agg=True, seed=PODS_SEED)
    finally:
        torch.backends.cudnn.deterministic = False

    def fixed_mean(pairs):
        words = np.zeros(FULL_N, np.uint64)
        for x, w in pairs:
            words += _fixed_point(x, w)
        w_tot = sum(w for _, w in pairs)
        return (words.view(np.int64).astype(np.float64)
                * (1.0 / (float(2 ** FRAC_BITS) * w_tot))).astype(np.float32)

    pod_of = job.topo.pod_of(task["sites"])
    for r in range(1, ROUNDS + 1):
        for q in range(2):
            sites = [int(i) for i in np.flatnonzero(pod_of == q)]
            want = fixed_mean([ups[("site", i, r)] for i in sites])
            _require(np.array_equal(ups[("pod", q, r)][0], want),
                     f"16g round {r}: pod {q}'s partial is not the fixed point of its sites")
        want = fixed_mean([ups[("pod", q, r)] for q in range(2)])
        _require(np.array_equal(downs[r], want),
                 f"16g round {r}: the root's global is not the fixed point of the partials")
    print(f"16g: in each of {ROUNDS} rounds both pods' partials and the root's global "
          f"bit-equal to the host's mask-free fixed point of their own inputs; privacy "
          f"{res.privacy}")
    _held_to(torch, job, res, plain, "16g pods secure_agg against the plain pods job", FULL_N)
    out["g"] = {**p_launches, **launches}
    return out


def check_small_pods_jobs(torch, FederatedJob, TaskConfig) -> None:
    """Phase 16 h at 8^3 (4 filters, TF32 off): a 2-site ``pods:2`` job on
    the tcp transport held to the flat stacked job (a pod a site: the
    two-tier mean is the flat one up to rounding), losses within
    ``JOB_RTOL`` and the global within ``lr * rounds``; and a 4-site thread
    ``pods:2`` job with ``pod_dropout=1`` whose schedule takes a whole pod
    offline, which must end with finite losses and every scheduled upload
    made."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = dict(kind="dose", batch=1, volume=(8, 8, 8), base_filters=4)
    job = FederatedJob(task=TaskConfig(sites=2, **tiny), rounds=3)
    flat, tcp = job.run(), job.replace(transport="tcp", topology="pods:2").run()
    d = float((_flat(torch, flat.global_params) - _flat(torch, tcp.global_params)).abs().max())
    print(f"16h tcp pods:2 (2 sites): losses {tcp.losses} against the flat stacked job's "
          f"{flat.losses}; max |global difference| {d:.3e}; comm {tcp.comm}")
    for a, b in zip(tcp.losses, flat.losses):
        _require(math.isclose(a, b, rel_tol=JOB_RTOL, abs_tol=1e-6),
                 f"16h tcp pods: loss {a} != flat {b}")
    _require(d <= job.lr * job.rounds, "16h tcp pods: global beyond lr * rounds of flat")
    job = FederatedJob(task=TaskConfig(sites=4, **tiny), rounds=3, transport="thread",
                       topology="pods:2", pod_dropout=1, seed=3)
    masks = job.masks(3)
    _require(any(not m[:2].any() or not m[2:].any() for m in masks),
             "16h: no whole pod offline")
    res = job.run()
    _require(all(math.isfinite(v) for v in res.losses)
             and res.comm["upload_count"] == int(masks.sum()),
             f"16h thread pods pod_dropout: losses {res.losses}, comm {res.comm}")
    print(f"16h thread pods:2 pod_dropout=1: masks {masks.astype(int).tolist()}, losses "
          f"{res.losses}, comm {res.comm}")


def run_pods_and_buffered(torch, FederatedJob, TaskConfig, build, task, flat_main,
                          int8_comm) -> dict:
    """Phase 16: two-tier pods and buffered rounds at full width (a-g) and
    small socket jobs (h); returns each path's launches."""
    stacked_int8, launches = run_pods_stacked(torch, FederatedJob, TaskConfig, build, task,
                                              flat_main, int8_comm)
    launches.update(run_buffered_stacked(torch, FederatedJob, TaskConfig, build, task))
    launches.update(run_pods_sockets(torch, FederatedJob, TaskConfig, build, task,
                                     stacked_int8))
    del stacked_int8
    check_small_pods_jobs(torch, FederatedJob, TaskConfig)
    return launches


# -- the fp8 and top-k codecs (phase 17) ----------------------------------------

FP8_BYTES = 6_892_415                    # one model, fp8, align=1 on every device
TOPK_BYTES = 5_476_088                   # one model, top-k at fraction 0.1
TIE_LEAF = 1 << 20                       # a built leaf of tied magnitudes


def _fold_spy(torch):
    """Records every ``AggregationEngine.reduce_flat`` call: (rows, weights)
    and its result."""
    from repro_torch.core.agg_engine import AggregationEngine
    return _Spy(AggregationEngine, "reduce_flat", pre=lambda a, k: (a[1].clone(), a[2].clone()),
                post=lambda a, k, o: o.clone())


def _hold_folds(torch, what: str, folds) -> float:
    """Every recorded ``fedagg`` fold within ``(S + 3) * 2^-24 * sum w|x|``
    of the exact (float64) fold of its rows; returns the worst share of
    the bound."""
    worst = 0.0
    for (rows, w), got in folds:
        worst = max(worst, _rounding_check(torch, what, rows, w, got, rows.shape[0] + 3))
    return worst


def _expect_bytes(what: str, res, up: list, down: list) -> None:
    """Each round's upload and download bytes, and ``comm``'s totals."""
    for r, h in enumerate(res.history):
        _require(h["upload_bytes"] == up[r] and h["download_bytes"] == down[r],
                 f"{what}: round {r} bytes {h['upload_bytes']}/{h['download_bytes']}, the host "
                 f"formula's {up[r]}/{down[r]}")
    _require(res.comm["upload_bytes"] == sum(up) and res.comm["download_bytes"] == sum(down),
             f"{what}: comm {res.comm}")
    print(f"{what}: bytes a round up {up}, down {down}: the host formula's")


def run_fp8_stacked(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 17a: stacked FedAvg with fp8 uploads and downloads at full
    width, 2 rounds (the twin of the reference's bidirectional compressed
    scan).  The last round's fp8 qdq of the uploads, every chunk-width
    group of it (align 1), is bit-equal to the port's own CPU qdq of the
    same rows copied to the host; the bytes are the host formula's (round
    0 bootstraps the downloads dense); ``fedagg`` runs twice a round (the
    anchors' fold and the dequantized uploads' fold), each fold within its
    fp32 bound of the exact fold of its rows, and the global is their sum
    bit for bit."""
    from repro_torch.core import round_engine
    cpu = torch.device("cpu")
    with _fold_spy(torch) as folds, \
            _Spy(round_engine, "qdq_fp8", pre=lambda a, k: (a[0].clone(), a[1]),
                 post=lambda a, k, o: o.clone()) as qdqs:
        res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                      "17a fp8 both ways", compression="fp8",
                                      down_compression="fp8")
    sites = task["sites"]
    _expect_launches("17a fp8 both ways", launches, {"fedagg": 2 * ROUNDS})
    _expect_bytes("17a fp8 both ways", res, [sites * FP8_BYTES] * ROUNDS,
                  [sites * DENSE_BYTES] + [sites * FP8_BYTES] * (ROUNDS - 1))
    (u, plan), deq = qdqs.calls[-2]             # the last round's uploads (then its install)
    host_plan = round_engine.ChunkPlan.of(_layout_of(TaskConfig, task), 1024, 1, cpu)
    want = round_engine.qdq_fp8(u.cpu(), host_plan)
    _require(_bits_equal(torch, deq.cpu(), want), "17a: the card's fp8 qdq differs from the CPU's")
    groups = [(w, rows) for w, rows, _ in plan.groups]
    worst = _hold_folds(torch, "17a fold", folds.calls)
    g = _flat(torch, res.global_params)
    _require(torch.equal(g, folds.calls[-2][1] + folds.calls[-1][1]),
             "17a: the global is not the anchors' fold plus the uploads' fold")
    print(f"17a: fp8 qdq of {u.shape[0]} site rows bit-equal to the CPU's at every chunk-width "
          f"group (width, rows) {groups}; {len(folds.calls)} fedagg folds within {worst:.3f} of "
          f"their fp32 bounds; the global their last round's sum")
    return launches


def run_topk_stacked(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 17b: stacked FedAvg with ``topk-fixed`` uploads and downloads
    at full width, 2 rounds.  The kept entries of every leaf of every site
    row (the last round's uploads and installs) are bit-equal to the CPU's
    rule on the same rows copied to the host, and so are those of a built
    leaf of tied magnitudes (4 rows of 2^20, values on a grid of 1/8);
    round 0's uploads and downloads are dense, round 1's the top-k
    payload; ``fedagg`` twice a round, each within its fp32 bound."""
    from repro_torch.comms.compression import TopKPlan
    cpu = torch.device("cpu")
    with _fold_spy(torch) as folds, \
            _Spy(TopKPlan, "mask", pre=lambda a, k: a[1].clone(),
                 post=lambda a, k, o: o.clone()) as masks:
        res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                      "17b topk-fixed both ways", compression="topk-fixed",
                                      down_compression="topk-fixed")
    sites = task["sites"]
    _expect_launches("17b topk-fixed both ways", launches, {"fedagg": 2 * ROUNDS})
    _expect_bytes("17b topk-fixed both ways", res,
                  [sites * DENSE_BYTES] + [sites * TOPK_BYTES] * (ROUNDS - 1),
                  [sites * DENSE_BYTES] + [sites * TOPK_BYTES] * (ROUNDS - 1))
    layout = _layout_of(TaskConfig, task)
    sizes = tuple(int(math.prod(sh)) for sh in layout.shapes)
    host = TopKPlan.of(sizes, 0.1, cpu)
    for x, got in masks.calls[-2:]:
        _require(torch.equal(got.cpu(), host.mask(x.cpu())),
                 "17b: the card's kept entries differ from the CPU rule's")
        _require(int(got.sum()) == x.shape[0] * host.kept, "17b: not k kept a leaf")
    gen = torch.Generator(device="cuda").manual_seed(17)
    tie = torch.randint(-8, 9, (4, TIE_LEAF), device="cuda", generator=gen).float() / 8
    tplan = TopKPlan.of((TIE_LEAF,), 0.1, "cuda")
    got = tplan.mask(tie)
    want = TopKPlan.of((TIE_LEAF,), 0.1, cpu).mask(tie.cpu())
    _require(torch.equal(got.cpu(), want), "17b: the tie leaf's kept entries differ")
    worst = _hold_folds(torch, "17b fold", folds.calls)
    print(f"17b: kept entries of {len(sizes)} leaves x {sites} rows (uploads and installs) and "
          f"of a {tuple(tie.shape)} tie leaf ({int((tie.abs() == 0.875).sum())} entries at one "
          f"magnitude) bit-equal to the CPU rule; {len(folds.calls)} fedagg folds within "
          f"{worst:.3f} of their fp32 bounds")
    return launches


def run_topk_sparse_host(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 17c: ``topk-sparse`` uploads through the host loop, against the
    ``topk-fixed`` scan with uploads only, both 2 rounds at full width with
    cuDNN's deterministic algorithms, so round 0 trains the same bits in
    both.  Round 0 (dense bootstrap uploads in both): the host loop's
    decoded uploads are the scan's rows bit for bit, and each global lies
    within its fp32 bound of the exact mean of those rows (the scan's
    ``fedagg``, the host loop's streaming fold).  Round 1: the host loop's
    global within its bound of the exact fold of its decoded uploads; each
    upload's top-k wire encode keeps the entries the scan's twin keeps, the
    same values bit for bit.  Launches: ``fedagg`` once in the host loop
    (the initial global), once a round in the scan."""
    from repro_torch.comms.compression import TopKFixedCodec, WirePlan
    from repro_torch.core import round_engine
    from repro_torch.core.agg_engine import StreamingAccumulator, ravel
    torch.backends.cudnn.deterministic = True
    try:
        with _fold_spy(torch) as scan_folds:
            scan, scan_l, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                         "17c topk-fixed uploads (scan)",
                                         compression="topk-fixed")
        with _Spy(StreamingAccumulator, "fold",
                  pre=lambda a, k: (ravel(a[1]).clone(), float(a[2]))) as host_folds, \
                _Spy(WirePlan, "encode_topk", pre=lambda a, k: a[1].clone(),
                     post=lambda a, k, o: o[1]().clone()) as encodes:
            host, host_l, _ = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                       "17c topk-sparse uploads (host loop)",
                                       compression="topk-sparse")
    finally:
        torch.backends.cudnn.deterministic = False
    sites = task["sites"]
    _expect_launches("17c topk-fixed uploads (scan)", scan_l, {"fedagg": ROUNDS})
    _expect_launches("17c topk-sparse uploads (host loop)", host_l, {"fedagg": 1})
    _require(host.comm["upload_bytes"] == scan.comm["upload_bytes"] ==
             sites * (DENSE_BYTES + TOPK_BYTES), f"17c: comm {host.comm} / {scan.comm}")
    w = torch.as_tensor(job.federation().case_weights(), device="cuda")
    w = w / w.sum()
    (rows0, _), g0_scan = scan_folds.calls[0]
    # a round folds each site into its pod's accumulator, then the pod into
    # the root (one pod: the flat topology)
    _require(len(host_folds.calls) == ROUNDS * (sites + 1),
             f"17c: {len(host_folds.calls)} streaming folds")
    rows0_host = torch.stack([f[0][0] for f in host_folds.calls[:sites]])
    _require(torch.equal(rows0, rows0_host), "17c: round 0's uploads differ between the paths")
    r_scan = _rounding_check(torch, "17c scan round 0", rows0, w, g0_scan, sites + 3)
    # the host loop's round-0 global is what its sites pulled: their round-1
    # uploads are deltas against it, so rebuild it from the fold's inputs
    acc = StreamingAccumulator()
    for (x, wt), _ in host_folds.calls[:sites]:
        acc.fold({"x": x.clone()}, wt, owned=True)
    g0_host = acc.finalize()["x"]
    r_host = _rounding_check(torch, "17c host round 0", rows0_host, w, g0_host, 2 * sites + 2)
    rows1 = torch.stack([f[0][0] for f in host_folds.calls[sites + 1: 2 * sites + 1]])
    r_last = _rounding_check(torch, "17c host round 1", rows1, w, _flat(torch, host.global_params),
                             2 * sites + 2)
    twin = round_engine.DeviceCodec(TopKFixedCodec(), _layout_of(TaskConfig, task),
                                    torch.device("cuda"))
    for u, deq in encodes.calls:
        _require(torch.equal(twin.deq(u[None])[0], deq),
                 "17c: the wire's top-k and the scan's twin keep different entries")
    gap = (g0_scan - g0_host).abs()
    print(f"17c: round 0's uploads the same bits on both paths; round-0 globals within "
          f"{r_scan:.3f} (scan) and {r_host:.3f} (host loop) of their fp32 bounds, apart by at "
          f"most {float(gap.max()):.3e}; round 1's host global within {r_last:.3f}; "
          f"{len(encodes.calls)} wire encodes keep the twin's entries bit for bit")
    return host_l


def run_mixed_int8_fp8(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 17e: int8 uploads with fp8 downloads at full width, 2 rounds:
    the int8 fold runs its kernels (``quantize_int8`` and ``fedagg_dequant``
    once a chunk width a round), the anchors' fold ``fedagg`` once a round,
    the fp8 installs plain PyTorch (no ``dequant_install``)."""
    groups = len(_chunk_plan_groups(TaskConfig, task))
    res, launches, _ = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                "17e int8 up, fp8 down", compression="int8",
                                down_compression="fp8")
    _expect_launches("17e int8 up, fp8 down", launches,
                     {"quantize_int8": groups * ROUNDS, "fedagg_dequant": groups * ROUNDS,
                      "fedagg": ROUNDS})
    sites = task["sites"]
    _expect_bytes("17e int8 up, fp8 down", res, [sites * INT8_BYTES] * ROUNDS,
                  [sites * DENSE_BYTES] + [sites * FP8_BYTES] * (ROUNDS - 1))
    return launches


def _chunk_plan_groups(TaskConfig, task):
    import torch
    from repro_torch.core.round_engine import ChunkPlan
    return ChunkPlan.of(_layout_of(TaskConfig, task), 1024, 128, torch.device("cpu")).groups


def run_codec_sockets(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 17d: the thread transport at full width, fp8 uploads and
    ``topk-fixed`` downloads, 2 rounds, against its stacked twin.  Every
    message decoded on the card (the uploads at the server, the downloads
    at the sites) is bit-equal to its decode on the host; the payload bytes
    are the stacked job's; the served global (the mean of the sites' final
    models, on both transports) is held to the stacked job's by phase 5b's
    rule, but for the top-k boundary: where the two folds' round-off moves
    a magnitude across a leaf's k-th, one install keeps an entry the other
    drops, so up to 1e-3 of the elements may lie outside (their count is
    printed).  No kernel runs: fp8 and top-k are plain PyTorch."""
    from repro_torch.comms import compression
    torch.backends.cudnn.allow_tf32 = True
    kw = dict(compression="fp8", down_compression="topk-fixed")
    stacked, _, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                               "17d stacked twin", **kw)
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.kernels import ref
    cw = torch.as_tensor(job.federation().case_weights(), device="cuda")
    served = get_engine().unflatten(ref.fedagg_ref(stacked.state["params"], cw / cw.sum()),
                                    stacked.state["layout"])
    with _Spy(compression, "_decode", pre=lambda a, k: (a[0], a[1], a[2]),
              post=lambda a, k, o: o[0].clone()) as decodes:
        res, launches, _ = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                    "17d thread fp8 up, topk-fixed down", transport="thread",
                                    **kw)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cpu = torch.device("cpu")
    n_dec = 0
    for (tree, layout, dev), flat in decodes.calls:
        if torch.device(dev).type != "cuda":
            continue
        host, _ = compression._decode(tree, layout, cpu)
        _require(_bits_equal(torch, flat.cpu(), host), "17d: a card decode differs from the host's")
        n_dec += 1
    sites = task["sites"]
    _require(n_dec == 2 * sites * ROUNDS, f"17d: {n_dec} card decodes, not {2 * sites * ROUNDS}")
    _require(res.comm["site_payload_bytes"] == stacked.comm["upload_bytes"]
             and res.comm["download_payload_bytes"] == stacked.comm["download_bytes"],
             f"17d: comm {res.comm} against the stacked {stacked.comm}")
    _expect_launches("17d thread fp8 up, topk-fixed down", launches, {})
    worst, outside = _outside(res.global_params, served)
    n_out = sum(bad for _, _, bad, _ in outside)
    print(f"17d: {n_dec} decodes on the card bit-equal to the host's; wall_s a round "
          f"{[round(h['wall_s'], 4) for h in res.history]}, peak memory {peak:.2f} GiB; served "
          f"globals apart by at most {worst:.3e}, {n_out} of {FULL_N} elements outside rtol "
          f"2e-3, atol 2e-4")
    _require(n_out <= 1e-3 * FULL_N, f"17d: {n_out} elements outside the socket bound")
    return launches


def time_plain_codecs(torch, TaskConfig, task) -> list:
    """The fp8 qdq and the top-k selection as one call site each at the
    stacked path's shape (4 site rows of the full-width model, the port's
    layout in and out), plain PyTorch on the card: CUDA-graph replays, as
    the kernels are timed, beside the bytes bound (each input read once,
    each output written once)."""
    from repro_torch.comms.compression import Fp8Codec, TopKFixedCodec
    from repro_torch.core.round_engine import DeviceCodec
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    layout = _layout_of(TaskConfig, task)
    dev = torch.device("cuda")
    u = torch.randn((task["sites"], layout.n), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3)) * 0.05
    rows = []
    for name, codec in (("fp8 qdq", Fp8Codec()), ("top-k selection", TopKFixedCodec())):
        twin = DeviceCodec(codec, layout, dev)
        nbytes = 2 * u.numel() * 4
        ms, eager = time_ms(lambda: twin.deq(u))
        bound = 1e3 * nbytes / mem_rate
        rows.append({"name": name, "shape": list(u.shape), "ms": ms, "eager_ms": eager,
                     "bound_ms": bound, "bound_by": "bytes"})
        print(f"{name} [{u.shape[0]}, {u.shape[1]}] plain PyTorch: {ms:.4f} ms (eager "
              f"{eager:.4f} ms), bytes bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
              f"{mem_rate / 1e12:.2f} TB/s), {bound / ms:.1%} of it")
    return rows


def run_codecs(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 17: the fp8 and top-k codecs at full width (a-e), and the two
    plain call sites' times; returns each path's launches."""
    jobs = (torch, FederatedJob, TaskConfig, build, task)
    out = {"17a": run_fp8_stacked(*jobs), "17b": run_topk_stacked(*jobs),
           "17c": run_topk_sparse_host(*jobs), "17d": run_codec_sockets(*jobs),
           "17e": run_mixed_int8_fp8(*jobs)}
    print(json.dumps({"plain_codecs": time_plain_codecs(torch, TaskConfig, task)}))
    return out


# -- checkpoint and resume, DP-SGD and the noise attack (phase 18) ---------------

DP_KW = dict(dp_clip=0.5, dp_noise_multiplier=0.8)
P18_ROUNDS = 4                          # 18a/b: the uninterrupted run's rounds
P18_KILL = 3                            # ... the killed run's (carries at rounds 0, 2)
NORMAL_ULP = 4                          # the port's normals against another device's


def _ulps(torch, a, b):
    """The ulp distance of two fp32 tensors (their ordered integer images),
    on the CPU."""
    def ordered(x):
        i = x.detach().float().cpu().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _ckpt_dir():
    """A scratch checkpoint directory inside the checkout (removed after)."""
    import tempfile
    return tempfile.TemporaryDirectory(prefix=".p18-ckpt-", dir=Path(__file__).resolve().parent)


def check_noise_tree(torch, TaskConfig, task) -> dict:
    """One (site, step) DP noise draw of the full-width model (round 3, site
    2, step 0 of 18a's stream) on the card against the same draw on the
    CPU: the leaves' subkeys and the uniforms bit-equal, the normals within
    ``NORMAL_ULP``; prints the share that is bit-equal.  Then the card's
    draw timed as one plain call site (CUDA-graph replays) beside its bytes
    bound (the fp32 noise written once; the subkeys are 8 bytes a leaf)."""
    from repro_torch.core import prng
    from repro_torch.privacy import dp
    layout = _layout_of(TaskConfig, task)
    cfg = dp.DPConfig(**{"clip": DP_KW["dp_clip"], "noise_multiplier": DP_KW["dp_noise_multiplier"]})
    key = dp.site_step_key(dp.round_key(cfg, 3), 2, 0)
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    n_leaves = len(layout.shapes)
    keys = prng.split(key, n_leaves)
    keys_dev = prng.split(key.to(dev), n_leaves)
    _require(torch.equal(keys_dev.cpu(), keys), "18a: the leaves' subkeys differ card vs CPU")
    draws = []
    for d, k in ((cpu, keys), (dev, keys_dev)):
        s = dp.LeafStream.of(layout.shapes, d)
        b = prng.bits_at(k[:, 0][s.leaf], k[:, 1][s.leaf], s.counter)
        draws.append((prng.uniform_from_bits(b, prng._NORMAL_LO, 1.0).cpu(), s.normal(k).cpu()))
        del b
    (u_cpu, n_cpu), (u_dev, n_dev) = draws
    _require(torch.equal(u_cpu.view(torch.int32), u_dev.view(torch.int32)),
             "18a: the noise's uniforms differ card vs CPU")
    ulp = _ulps(torch, n_dev, n_cpu)
    share = float((ulp == 0).double().mean())
    _require(int(ulp.max()) <= NORMAL_ULP, f"18a: normals {int(ulp.max())} ulp apart")
    print(f"18a noise tree ({n_leaves} leaves, {layout.n} normals): subkeys and uniforms "
          f"bit-equal card vs CPU; normals within {int(ulp.max())} ulp, {share:.6%} bit-equal")
    stream = dp.LeafStream.of(layout.shapes, dev)
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    nbytes = 4 * layout.n + 8 * n_leaves
    ms, eager = time_ms(lambda: stream.normal(keys_dev))
    bound = 1e3 * nbytes / mem_rate
    row = {"name": "threefry normal (one site-step's noise)", "shape": [layout.n], "ms": ms,
           "eager_ms": eager, "bound_ms": bound, "bound_by": "bytes",
           "bit_equal_share": share}
    print(f"plain threefry normal [{layout.n}] (one site-step's DP noise): {ms:.4f} ms (eager "
          f"{eager:.4f} ms), bytes bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
          f"{mem_rate / 1e12:.2f} TB/s), {bound / ms:.2%} of it")
    return row


def _resume_pair(torch, FederatedJob, TaskConfig, build, task, what, **kw):
    """18a/b: the uninterrupted ``P18_ROUNDS``-round job (``ckpt_every=1``
    into its own directory, so every round's global is on disk), then the
    same job killed after ``P18_KILL`` rounds (``ckpt_every=2``: carries at
    rounds 0 and 2) and resumed, cuDNN deterministic.  The resumed round's
    losses and the final global must be the uninterrupted run's bit for
    bit, ``resumed_from`` 2, ``comm`` one round's and ``privacy`` the
    accountant's epsilon for all ``P18_ROUNDS`` rounds.  Returns (the
    uninterrupted result, its round-1 global, the resume's launches, the
    engine tag written)."""
    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.privacy import gaussian_epsilon
    torch.backends.cudnn.deterministic = True
    try:
        with _ckpt_dir() as full_dir, _ckpt_dir() as kill_dir:
            full, full_l, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                         f"{what} uninterrupted", rounds=P18_ROUNDS,
                                         checkpoint_dir=full_dir, ckpt_every=1, **kw)
            like = convert.to_reference(full.global_params)
            g1, _ = CheckpointStore(Path(full_dir)).load("global", 1, like)
            kill, kill_l, _ = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                       f"{what} killed after {P18_KILL}", rounds=P18_KILL,
                                       checkpoint_dir=kill_dir, ckpt_every=2, **kw)
            store = CheckpointStore(Path(kill_dir))
            tag = store.meta("driver_state", 2)["engine"]
            _require(store.saved_rounds("driver_state") == [0, 2],
                     f"{what}: driver_state at {store.saved_rounds('driver_state')}")
            job = FederatedJob(task=TaskConfig(**task), rounds=P18_ROUNDS,
                               checkpoint_dir=kill_dir, ckpt_every=2, **kw)
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t0 = time.perf_counter()
            res = job.run(resume=True)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        torch.backends.cudnn.deterministic = False
    _strategy_history(res, f"{what} resumed")
    print(f"{what} resumed: {len(res.history)} round in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, comm {res.comm}, privacy "
          f"{res.privacy}; tag {tag!r}; kernels launched {launches}")
    _require(res.resumed_from == 2 and [h["round"] for h in res.history] == [3],
             f"{what}: resumed_from {res.resumed_from}, rounds {[h['round'] for h in res.history]}")
    same_loss = res.history[0]["per_site_loss"] == full.history[3]["per_site_loss"]
    same_global = torch.equal(_flat(torch, res.global_params), _flat(torch, full.global_params))
    print(f"{what}: resumed round 3 per-site losses {res.history[0]['per_site_loss']} against "
          f"{full.history[3]['per_site_loss']}: bit-equal {same_loss}; final global bit-equal "
          f"{same_global}")
    _require(same_loss and same_global, f"{what}: the resumed run differs from the uninterrupted")
    sites = task["sites"]
    _require(res.comm["upload_count"] == sites, f"{what}: comm {res.comm} is not one round's")
    eps = gaussian_epsilon(DP_KW["dp_noise_multiplier"], P18_ROUNDS, 1e-5)
    _require(res.privacy == full.privacy and res.privacy["epsilon"] == eps
             and res.privacy["steps"] == P18_ROUNDS,
             f"{what}: privacy {res.privacy}, the accountant's epsilon {eps}")
    _require(kill.comm["upload_count"] == P18_KILL * sites, f"{what}: killed comm {kill.comm}")
    print(f"{what}: launches uninterrupted {full_l}, killed {kill_l}, resumed {launches}")
    return full, g1, launches, tag


def run_dp_resume(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 18a: DP-SGD FedAvg (per-site, C 0.5, sigma 0.8) at full width,
    4 rounds, and its resume from round 2 (tag ``sync-scan``); the resumed
    round runs ``fedagg`` twice (its exchange and the final global)."""
    full, g1, launches, tag = _resume_pair(torch, FederatedJob, TaskConfig, build, task,
                                           "18a dp fedavg", **DP_KW)
    _require(tag == "sync-scan", f"18a: tag {tag!r}")
    _expect_launches("18a resumed round", launches, {"fedagg": 2})
    return {"launches": launches, "full": full, "global1": g1}


def run_int8_resume(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 18b: the same DP job with int8 uploads and downloads (tag
    ``compressed-scan-bidir``: the residuals and the installs restored);
    the resumed round launches the four kernels of the int8 path."""
    groups = len(_chunk_plan_groups(TaskConfig, task))
    full, _, launches, tag = _resume_pair(torch, FederatedJob, TaskConfig, build, task,
                                          "18b dp fedavg int8 both ways", compression="int8",
                                          down_compression="int8", **DP_KW)
    _require(tag == "compressed-scan-bidir", f"18b: tag {tag!r}")
    _expect_launches("18b resumed round", launches,
                     {"quantize_int8": 2 * groups, "fedagg_dequant": groups,
                      "dequant_install": groups, "fedagg": 1})
    return launches


def run_noise_attack(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 18c: ``adversary="noise:0.5:1"`` under ``aggregator="trimmed:1"``
    at full width, 2 rounds: each round's perturbed row is the clean row
    plus 0.5 times the CPU's draw of the same (round, site) noise (within
    ``NORMAL_ULP`` of each normal, plus the sum's rounding); ``trimmed_mean``
    once a round, ``fedagg`` once (the final global)."""
    from repro_torch.core.adversary import AdversaryPlan
    with _Spy(AdversaryPlan, "perturb_rows",
              pre=lambda a, k: (a[1].clone(), a[2].copy(), a[3], a[4]),
              post=lambda a, k, o: a[1].clone()) as spy:
        res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                      "18c noise:0.5:1 trimmed:1", adversary="noise:0.5:1",
                                      aggregator="trimmed:1")
    _expect_launches("18c noise:0.5:1 trimmed:1", launches,
                     {"trimmed_mean": ROUNDS, "fedagg": 1})
    plan = job.adversary_plan
    cpu = torch.device("cpu")
    shares = []
    for (before, mask, rnd, layout), after in spy.calls:
        _require(int(mask.sum()) == 1, f"18c: round {rnd} perturbs {int(mask.sum())} rows")
        for i in range(mask.shape[0]):
            if not mask[i]:
                _require(torch.equal(after[i], before[i]), f"18c: honest row {i} changed")
                continue
            noise = plan.noise_row(rnd, i, layout, cpu)
            x = before[i].cpu()
            want = x + noise * 0.5
            got = after[i].cpu()
            bound = NORMAL_ULP * 2.0 ** -23 * (0.5 * noise.abs() + x.abs()) + 1e-12
            _require(bool(((got - want).abs() <= bound).all()),
                     f"18c: round {rnd} site {i}'s perturbed row differs from the CPU draw")
            shares.append(float((got == want).double().mean()))
    print(f"18c: {len(spy.calls)} rounds' perturbed rows within {NORMAL_ULP} ulp of each normal "
          f"of the CPU draw; bit-equal shares {[round(s, 6) for s in shares]}")
    return launches


def run_dp_sockets(torch, FederatedJob, TaskConfig, build, task, stacked) -> dict:
    """Phase 18d: the thread transport, DP per-site, 2 rounds at full
    width, against 18a's uninterrupted first two rounds (its round-1
    global from the checkpoint store) by phase 5b's socket bound: the
    socket sites draw their stacked twins' noise by global site id.  No
    kernel runs on the socket path."""
    res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                  "18d thread dp", transport="thread", **DP_KW)
    from repro_torch import convert
    from repro_torch.tree import tree_map
    g1 = tree_map(lambda t: t.to(_flat(torch, res.global_params).device),
                  convert.from_reference(stacked["global1"]))
    want = types.SimpleNamespace(global_params=g1, history=stacked["full"].history[:ROUNDS])
    _held_to(torch, job, res, want, "18d thread dp against 18a's first two rounds", FULL_N)
    for a, b in zip(res.history, want.history):
        _require(all(math.isclose(x, y, rel_tol=1e-3) for x, y in
                     zip(a["per_site_loss"], b["per_site_loss"])),
                 f"18d: round {a['round']} per-site losses differ from 18a's")
    _require(res.privacy == job.privacy_report(ROUNDS), f"18d: privacy {res.privacy}")
    _expect_launches("18d thread dp", launches, {})
    return launches


def _hold_resume(torch, what, full, res) -> None:
    _require(res.resumed_from == 2 and res.losses == full.losses[3:]
             and torch.equal(_flat(torch, res.global_params), _flat(torch, full.global_params)),
             f"small {what}: the resumed run differs from the uninterrupted")


def check_small_resume_jobs(torch, FederatedJob, TaskConfig) -> None:
    """Phase 18's tail at 8^3 (4 filters, 2 levels, 3 sites), TF32 off,
    cuDNN deterministic: on the card, resume parity (5 rounds against 3 +
    resume, ``ckpt_every=2``: bit for bit) on the ``"loop"`` engine,
    ``topk-fixed``, fp8 both ways, the buffered scan and GCML (4 PanSeg
    sites), each resumed run's losses within ``JOB_RTOL`` of the CPU's
    resumed run; the refusals (another engine, another DP mechanism, the
    buffered host loop, no ``checkpoint_dir``); a resume after the last
    round runs none; DP per-example and DP under ``secure_agg`` on the
    thread transport, card against CPU (losses ``JOB_RTOL``)."""
    from repro_torch.core.session import BufferedScheduler
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    tiny = dict(batch=1, volume=(8, 8, 8), base_filters=4, num_levels=2)
    dose = TaskConfig(kind="dose", sites=3, **tiny)
    pan = TaskConfig(kind="seg", sites=4, in_channels=1, num_classes=2, **tiny)
    base = dict(task=dose, rounds=5, ckpt_every=2, max_dropout=1)
    cases = [("loop", dict(round_engine="loop")),
             ("topk-fixed", dict(compression="topk-fixed")),
             ("fp8 both ways", dict(compression="fp8", down_compression="fp8")),
             ("buffered scan", dict(scheduler=BufferedScheduler(buffer_k=2))),
             ("gcml", dict(strategy="gcml", task=pan)),
             ("dp loop", dict(round_engine="loop", **DP_KW))]
    try:
        for what, kw in cases:
            job = FederatedJob(**{**base, **kw})
            full = job.run()
            with _ckpt_dir() as d, _ckpt_dir() as c:
                job.replace(checkpoint_dir=d).run(rounds=3)
                res = job.replace(checkpoint_dir=d).run(resume=True)
                job.replace(checkpoint_dir=c, device="cpu").run(rounds=3)
                cpu = job.replace(checkpoint_dir=c, device="cpu").run(resume=True)
            _hold_resume(torch, what, full, res)
            _require(all(math.isclose(a, b, rel_tol=JOB_RTOL, abs_tol=1e-6) for a, b in
                         zip(res.losses, cpu.losses)),
                     f"small {what}: resumed losses card {res.losses} cpu {cpu.losses}")
            print(f"small {what} resume: bit-equal to the uninterrupted run on the card; "
                  f"losses card {res.losses} cpu {cpu.losses}")
        refusals = [
            ("another engine", dict(round_engine="loop"), dict(round_engine="scan"),
             "written by engine 'sync-loop'"),
            ("another DP mechanism", dict(DP_KW), dict(DP_KW, dp_noise_multiplier=0.3),
             "DP settings"),
            ("the buffered host loop", dict(scheduler=BufferedScheduler(buffer_k=2)),
             dict(scheduler=BufferedScheduler(buffer_k=2), round_engine="loop"),
             "not checkpointable")]
        for what, first, then, frag in refusals:
            with _ckpt_dir() as d:
                FederatedJob(**{**base, **first}, checkpoint_dir=d).run(rounds=3)
                try:
                    FederatedJob(**{**base, **then}, checkpoint_dir=d).run(resume=True)
                except ValueError as e:
                    _require(frag in str(e), f"small refusal {what}: {e}")
                    print(f"small refusal ({what}): ValueError: {e}")
                else:
                    _require(False, f"small refusal {what}: the resume ran")
        try:
            FederatedJob(**base).run(resume=True)
        except ValueError as e:
            _require("needs checkpoint_dir" in str(e), f"small resume without a directory: {e}")
        else:
            _require(False, "small resume without a directory ran")
        with _ckpt_dir() as d:
            done = FederatedJob(**{**base, "rounds": 3, "ckpt_every": 1}, checkpoint_dir=d)
            first = done.run()
            again = done.run(resume=True)
        _require(again.resumed_from == 2 and again.history == []
                 and math.isnan(again.final_loss)
                 and torch.equal(_flat(torch, again.global_params),
                                 _flat(torch, first.global_params)),
                 "small resume after completion ran rounds")
        print("small resume after completion: no round, the same global")
        for what, kw in (("dp per-example", dict(task=dataclasses.replace(dose, batch=2),
                                                 dp_mode="per-example", **DP_KW)),
                         ("dp secure_agg thread", dict(transport="thread", secure_agg=True,
                                                       max_dropout=0, **DP_KW))):
            job = FederatedJob(**{**base, "rounds": 3, **kw})
            gpu, cpu = job.run(), job.replace(device="cpu").run()
            _require(all(math.isclose(a, b, rel_tol=JOB_RTOL, abs_tol=1e-6)
                         for g, c in zip(gpu.history, cpu.history)
                         for a, b in zip(g["per_site_loss"], c["per_site_loss"])),
                     f"small {what}: losses card {gpu.losses} cpu {cpu.losses}")
            _require(gpu.privacy == cpu.privacy == job.privacy_report(),
                     f"small {what}: privacy {gpu.privacy}")
            print(f"small {what}: losses card {gpu.losses} cpu {cpu.losses}; privacy "
                  f"{gpu.privacy}")
    finally:
        torch.backends.cudnn.deterministic = False


def run_resume_and_dp(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 18 (a-d at full width, the tail at 8^3) and the plain normal
    draw's time; returns each full-width path's launches."""
    jobs = (torch, FederatedJob, TaskConfig, build, task)
    print(json.dumps({"plain_prng": check_noise_tree(torch, TaskConfig, task)}))
    a = run_dp_resume(*jobs)
    out = {"18a": a["launches"], "18b": run_int8_resume(*jobs),
           "18c": run_noise_attack(*jobs), "18d": run_dp_sockets(*jobs, a)}
    del a
    check_small_resume_jobs(torch, FederatedJob, TaskConfig)
    return out


# -- on-device batches, the sharded simulator and the CLI (phase 19) -------------

P19_ROUNDS = 3                          # 19b, 19c
P19_SITES = 64                          # 19b: the sites the rows hold
DOSE_ATOL = 4 * 2.0 ** -23              # card vs CPU dose (in [0, 1]): exp's ulps
CARD = "cuda"                           # phase 19's device (the CPU in a dry run of it)


def _deterministic(torch, on: bool) -> None:
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def _sharded_launches(rounds: int, devices: int, pods: int = 1, final: bool = True) -> int:
    """``fedagg`` on the sharded engine: a partial a pod a device and the
    inter-pod combine each round, and with a dense global one a device at
    the end."""
    return rounds * (devices * pods + 1) + (devices if final else 0)


def run_sharded_dense(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 19a: 4-site FedAvg at full width, 2 rounds, ``shard_sites=True``
    against the same job dense (deterministic cuDNN): round 0's losses
    equal, every round's within rtol 1e-4, the globals by phase 5b's
    fold-noise rule (the two folds differ in order and normalization only),
    ``upload_bytes`` equal, ``devices`` the card count, and ``fedagg`` as
    :func:`_sharded_launches` counts it."""
    _deterministic(torch, True)
    try:
        dense, _, job = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                 "19a dense fedavg")
        shard, launches, _ = _run_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                                      "19a sharded fedavg", shard_sites=True)
    finally:
        _deterministic(torch, False)
    devices = torch.cuda.device_count()
    _require(shard.comm["sharded"] is True and shard.comm["devices"] == devices
             and shard.comm["upload_bytes"] == dense.comm["upload_bytes"],
             f"19a: comm {shard.comm} against {dense.comm}")
    _require(dense.history[0]["per_site_loss"] == shard.history[0]["per_site_loss"],
             "19a: round 0's losses differ")
    for a, b in zip(shard.history, dense.history):
        _require(all(math.isclose(x, y, rel_tol=1e-4) for x, y in
                     zip(a["per_site_loss"], b["per_site_loss"])),
                 f"19a: round {a['round']} losses {a['per_site_loss']} {b['per_site_loss']}")
    worst, outside = _outside(shard.global_params, dense.global_params)
    print(f"19a: sharded vs dense globals max |diff| {worst:.3e}, outside rtol 2e-3, atol "
          f"2e-4: {outside}")
    _require_fold_noise(job, worst, outside, "19a sharded vs dense")
    _expect_launches("19a sharded fedavg", launches,
                     {"fedagg": _sharded_launches(ROUNDS, devices)})
    return launches


def _many_sites(torch, FederatedJob, TaskConfig, build, task, what: str, **kw):
    """19b's job: ``P19_SITES`` sites, ``uniform:4``, shutdown, ``P19_ROUNDS``
    rounds, sharded; returns (result, launches, job, the inter-pod
    combines' outputs, one a round: each round folds a partial a device,
    then combines)."""
    from repro_torch.core.agg_engine import get_engine
    engine = type(get_engine())
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**dict(task, sites=P19_SITES)), rounds=P19_ROUNDS,
                       sample="uniform:4", dropout_scenario="shutdown", shard_sites=True, **kw)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with _Spy(engine, "reduce_flat", post=lambda a, k, o: o.clone()) as spy:
        t0 = time.perf_counter()
        res = job.run()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    _strategy_history(res, what)
    print(f"{what}: {P19_ROUNDS} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, comm {res.comm}; kernels "
          f"launched {launches}")
    _require(sum(t.numel() for t in _leaves(res.global_params)) == FULL_N
             and all(bool(torch.isfinite(t).all()) for t in _leaves(res.global_params)),
             f"{what}: the global's size or a non-finite element")
    per_round = torch.cuda.device_count() + 1
    combines = [out for _, out in spy.calls[per_round - 1:per_round * P19_ROUNDS:per_round]]
    return res, launches, job, combines


def run_many_sites(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """Phase 19b: 64 sites (about 5.3 GB of rows, params and AdamW's
    moments; 7.0 GB with int8's residuals), ``uniform:4`` under shutdown,
    3 rounds, plain and with int8 uploads.  Every site that never
    participates keeps its initial row and zero moments bit for bit; in the
    plain run each last-round participant's row is that round's global
    (the inter-pod combine's output) bit for bit; ``participants`` 4 and
    ``k_cap`` the packed maximum each round, the NaN losses exactly the
    non-participants'; ``fedagg`` as :func:`_sharded_launches` counts it and
    under int8 ``quantize_int8`` and ``dequantize_int8`` once a chunk width
    a round on each device that trains.  Prints the peak memory and
    ``step_s``."""
    import numpy as np
    from repro_torch.core.round_engine import pack_participants
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.core.stacking import broadcast_to_sites
    devices = torch.cuda.device_count()
    out = {}
    groups = len(_chunk_plan_groups(TaskConfig, task))
    for what, kw in (("19b 64 sites uniform:4", {}),
                     ("19b 64 sites uniform:4 int8", dict(compression="int8"))):
        res, launches, job, combines = _many_sites(torch, FederatedJob, TaskConfig, build, task,
                                                   what, **kw)
        participate, wscale = job.participation(P19_ROUNDS)
        s_loc = -(-P19_SITES // devices)
        packed = pack_participants(participate, wscale, np.zeros(P19_SITES, np.int32), s_loc,
                                   devices)
        k_cap = packed[-1]
        busy = int(packed[1].any(axis=2).sum())      # (round, device) pairs that train
        for h, row in zip(res.history, participate):
            _require(h["participants"] == 4 and h["k_cap"] == k_cap
                     and [not math.isfinite(v) for v in h["per_site_loss"]] == list(~row),
                     f"{what}: round {h['round']} participants {h['participants']} k_cap "
                     f"{h['k_cap']} (packed {k_cap}) or its NaN rows")
        init, _ = get_engine().flatten(broadcast_to_sites(
            job.task.build().init_fn(job.seed), 1))
        init = init[0].to(res.state["params"].device)
        never = np.flatnonzero(~participate.any(axis=0))
        st = res.state
        for i in never:
            _require(torch.equal(st["params"][i], init) and not st["opt"]["mu"][i].any()
                     and not st["opt"]["nu"][i].any() and int(st["opt"]["step"][i]) == 0,
                     f"{what}: site {i} never participated and its row or moments moved")
        last = np.flatnonzero(participate[-1])
        if "compression" not in kw:
            _require(len(combines) == P19_ROUNDS
                     and all(torch.equal(st["params"][i], combines[-1]) for i in last),
                     f"{what}: a last-round participant's row is not the round's global")
            expect = {"fedagg": _sharded_launches(P19_ROUNDS, devices)}
        else:
            _require(all(torch.equal(st["params"][i], st["params"][last[0]]) for i in last),
                     f"{what}: the last-round participants' rows differ")
            expect = {"fedagg": _sharded_launches(P19_ROUNDS, devices, final=False),
                      "quantize_int8": busy * groups, "dequantize_int8": busy * groups}
        _expect_launches(what, launches, expect)
        print(f"{what}: {len(never)} sites never participated, frozen bit for bit; "
              f"k_cap {k_cap}; step_s {[round(h['step_s'], 4) for h in res.history]}; "
              f"participants {[h['participants'] for h in res.history]}")
        out[what] = launches
        del res, st, combines
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _round_keys(seed: int, r: int, device):
    """Round ``r``'s ``device_data`` keys on ``device``: (k_av, k_pair,
    k_data), as ``round_engine.run_sync`` draws them."""
    from repro_torch.core import prng
    data_key = prng.fold_in(prng.key(seed, device=device), 7)
    return prng.split(prng.fold_in(data_key, r), 3)


def _hold_case(torch, what, gen, k_data, n_cases: int, labels: bool):
    """Case 0 of a round drawn on the card and on the CPU from the same key:
    masks (labels) bit-equal, the float channels within ``NORMAL_ULP`` ulp
    (the seg volume of its terms' magnitude), the dose within
    ``DOSE_ATOL``; prints the bit-equal shares."""
    from repro_torch.core import prng
    cpu = torch.device("cpu")
    draws = []
    for dev in (torch.device(CARD), cpu):
        keys = prng.split(k_data.to(dev), n_cases)[:1]
        draws.append({k: v.cpu() for k, v in
                      gen.traced_cases(keys, torch.zeros(1, dtype=torch.long, device=dev)).items()})
    card, host = draws
    if labels:
        _require(torch.equal(card["labels"], host["labels"]), f"{what}: labels differ")
        signal = host["labels"][..., None].float() * torch.tensor(
            [0.5 + 0.25 * c for c in range(card["volume"].shape[-1])])
        bound = NORMAL_ULP * 2.0 ** -23 * ((host["volume"] - signal).abs() + signal.abs())
        _require(bool(((card["volume"] - host["volume"]).abs() <= bound).all()),
                 f"{what}: the volume is beyond {NORMAL_ULP} ulp of its terms")
        ulp = _ulps(torch, card["volume"], host["volume"])
        print(f"{what}: labels bit-equal card vs CPU; volume within {NORMAL_ULP} ulp of its "
              f"terms (max {int(ulp.max())} ulp of the sum), "
              f"{float((ulp == 0).double().mean()):.6%} bit-equal")
        return
    _require(torch.equal(card["volume"][..., 1:], host["volume"][..., 1:])
             and torch.equal(card["mask"], host["mask"]), f"{what}: a mask channel differs")
    ulp = _ulps(torch, card["volume"][..., 0], host["volume"][..., 0])
    _require(int(ulp.max()) <= NORMAL_ULP, f"{what}: CT {int(ulp.max())} ulp apart")
    dose = float((card["dose"] - host["dose"]).abs().max())
    _require(dose <= DOSE_ATOL, f"{what}: dose {dose:.3e} apart (bound {DOSE_ATOL:.3e})")
    print(f"{what}: masks bit-equal card vs CPU ({card['volume'].shape[-1] - 1} channels and "
          f"the body); CT within {int(ulp.max())} ulp, {float((ulp == 0).double().mean()):.6%} "
          f"bit-equal; dose max |diff| {dose:.3e} (bound {DOSE_ATOL:.3e}), "
          f"{float((card['dose'] == host['dose']).double().mean()):.6%} bit-equal")


def time_case_draw(torch, gen, k_data, n_cases: int) -> dict:
    """One 128^3 case of the on-device dose generator (``traced_cases``:
    the threefry CT noise, the body, PTV and OAR spheres, the distance
    field's dose) timed as one plain call site (CUDA-graph replays) beside
    its bytes bound: its outputs (the volume's channels, the dose and the
    mask, fp32) written once."""
    from repro_torch.core import prng
    dev = torch.device(CARD)
    keys = prng.split(k_data.to(dev), n_cases)[:1]
    sites = torch.zeros(1, dtype=torch.long, device=dev)
    out = gen.traced_cases(keys, sites)
    nbytes = 4 * sum(v[0].numel() for v in out.values())
    del out
    ms, eager = time_ms(lambda: gen.traced_cases(keys, sites))
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    bound = 1e3 * nbytes / mem_rate
    print(f"plain on-device dose case {list(gen.volume)}, {gen.in_channels} channels: "
          f"{ms:.4f} ms (eager {eager:.4f} ms), bytes bound {bound:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at {mem_rate / 1e12:.2f} TB/s), {bound / ms:.2%} of it")
    return {"name": "on-device dose case (traced_cases)", "shape": list(gen.volume),
            "ms": ms, "eager_ms": eager, "bound_ms": bound, "bound_by": "bytes"}


def run_device_data(torch, FederatedJob, TaskConfig, build, tasks, host_batch_s) -> dict:
    """Phase 19c-d: ``device_data=True`` at full width.  19c: OpenKBP, 4
    sites, FedAvg, ``max_dropout=1``, 3 rounds; one case of round 0 drawn
    on the card and on the CPU (:func:`_hold_case`); the Algorithm-2 chain
    of the job's keys on the card equal to the CPU's, its counts the
    history's and ``comm``'s; ``batch_s`` (the on-device draw) beside
    phase 3's host ``batch_s``; ``fedagg`` once a round and once at the end.
    19d: BraTS, 1 round, one case's labels and volume card vs CPU."""
    from repro_torch.core.dropout import availability_step_traced
    dose, brats = tasks
    res, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, dose, FULL_N,
                                  "19c device_data fedavg max_dropout=1", rounds=P19_ROUNDS,
                                  max_dropout=1, device_data=True)
    _expect_launches("19c device_data", launches, {"fedagg": P19_ROUNDS + 1})
    bundle = job.task.build()
    gen = bundle.traced_stacked.__self__
    k_data = _round_keys(job.seed, 0, torch.device(CARD))[2]
    _hold_case(torch, "19c round 0 case 0", gen, k_data, dose["sites"], False)
    print(json.dumps({"plain_generator": time_case_draw(torch, gen, k_data, dose["sites"])}))
    chains = []
    for dev in (torch.device(CARD), torch.device("cpu")):
        active = torch.ones(dose["sites"], dtype=torch.bool, device=dev)
        rows = []
        for r in range(P19_ROUNDS):
            active = availability_step_traced(_round_keys(job.seed, r, dev)[0], active, 1)
            rows.append(active.cpu().tolist())
        chains.append(rows)
    _require(chains[0] == chains[1], f"19c: active chains card {chains[0]} cpu {chains[1]}")
    _require([sum(r) for r in chains[0]] == [h["active"] for h in res.history]
             and res.comm["upload_count"] == sum(map(sum, chains[0])),
             f"19c: the job's active counts {[h['active'] for h in res.history]} are not "
             f"the chain's {chains[0]}")
    print(f"19c: active chain card == CPU {chains[0]}; batch_s on the card "
          f"{[round(h['batch_s'], 4) for h in res.history]} against phase 3's host "
          f"{[round(v, 4) for v in host_batch_s]}")
    seg, seg_l, seg_job = _run_job(torch, FederatedJob, TaskConfig, build, brats, BRATS_N,
                                   "19d device_data brats", rounds=1, device_data=True)
    _expect_launches("19d device_data brats", seg_l, {"fedagg": 2})
    seg_bundle = seg_job.task.build()
    _hold_case(torch, "19d round 0 case 0", seg_bundle.traced_stacked.__self__,
               _round_keys(seg_job.seed, 0, torch.device(CARD))[2], brats["sites"],
               True)
    return {"19c": launches, "19d": seg_l,
            "batch_s": [h["batch_s"] for h in res.history] + [seg.history[0]["batch_s"]]}


def _small_pair(torch, FederatedJob, what, job, keys=("active", "partner", "is_receiver")):
    """A small job on the card and on the CPU: ``keys`` equal, losses within
    ``JOB_RTOL``; returns (card, CPU) results."""
    gpu, cpu = job.run(), job.replace(device="cpu").run()
    for g, c in zip(gpu.history, cpu.history):
        for key in keys:
            _require(g.get(key) == c.get(key), f"small {what}: {key} differs card vs CPU")
        _require(all(math.isclose(a, b, rel_tol=JOB_RTOL, abs_tol=1e-6) or
                     (math.isnan(a) and math.isnan(b))
                     for a, b in zip(g["per_site_loss"], c["per_site_loss"])),
                 f"small {what}: losses card {g['per_site_loss']} cpu {c['per_site_loss']}")
    print(f"small {what}: {', '.join(keys)} equal card vs CPU; losses card {gpu.losses} "
          f"cpu {cpu.losses}")
    return gpu, cpu


def check_small_p19_jobs(torch, FederatedJob, TaskConfig) -> None:
    """Phase 19's tail at 8^3 (4 filters, 2 levels), TF32 off, cuDNN
    deterministic: the reference's seven sharded-vs-dense cases (4 sites, 4
    rounds) on the card, each sharded run against the dense one (globals
    at the reference's tolerances but the GroupNorm-fed conv biases, held to
    ``lr * rounds``; losses rtol 1e-4 where a site trained) and against its
    CPU run; ``device_data`` with GCML (5 sites, ``max_dropout=2``:
    partners and ``active`` bit-equal card vs CPU), FedProx, ``pods:2`` and
    DP per-site, card vs CPU; a ``device_data`` resume bit-equal to its
    uninterrupted run; both seams' refusals; a thread job with
    ``device_data=True`` equal to the job without it; and the training CLI
    (``launch/train.py``) on the card by default."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _deterministic(torch, True)
    tiny = dict(batch=1, volume=(8, 8, 8), base_filters=4, num_levels=2)
    dose = TaskConfig(kind="dose", sites=4, **tiny)
    try:
        cases = [("fedavg", {}, 1e-5), ("fedprox", dict(strategy="fedprox"), 1e-5),
                 ("pods", dict(topology="pods:2"), 1e-5),
                 ("int8", dict(compression="int8"), 1e-4),
                 ("int8-fedprox", dict(compression="int8", strategy="fedprox"), 1e-4),
                 ("sampled-uniform", dict(sample="uniform:2", dropout_scenario="shutdown"), 1e-5),
                 ("sampled-poisson-churn", dict(sample="poisson:0.6", max_dropout=1,
                                                dropout_scenario="shutdown"), 1e-5)]
        for what, kw, rtol in cases:
            job = FederatedJob(task=dose, rounds=4, **kw)
            dense = job.run()
            shard, _ = _small_pair(torch, FederatedJob, f"sharded {what}",
                                   job.replace(shard_sites=True),
                                   keys=("active", "participants", "k_cap"))
            _require(shard.comm["upload_bytes"] == dense.comm["upload_bytes"]
                     and shard.comm["devices"] == torch.cuda.device_count(),
                     f"small sharded {what}: comm {shard.comm}")
            for hd, hs in zip(dense.history, shard.history):
                _require(hd["active"] == hs["active"] == hs["participants"]
                         and all(math.isclose(a, b, rel_tol=1e-4) for a, b in
                                 zip(hd["per_site_loss"], hs["per_site_loss"])
                                 if not math.isnan(b)),
                         f"small sharded {what}: round {hs['round']} against dense")
            worst = 0.0
            for (path, a), (_, b) in zip(_paths(shard.global_params),
                                         _paths(dense.global_params)):
                d = float((a - b).abs().max())
                if path.endswith(("/conv1/b", "/conv2/b")):
                    _require(d <= job.lr * job.rounds, f"small sharded {what}: {path} {d:.3e}")
                else:
                    _require(bool(((a - b).abs() <= 10 * rtol + rtol * b.abs()).all()),
                             f"small sharded {what}: {path} {d:.3e} from dense")
                    worst = max(worst, d)
            print(f"small sharded {what}: against dense max |diff| {worst:.3e} "
                  f"(rtol {rtol:g}) outside the GroupNorm-fed biases")
        pan = TaskConfig(kind="dose", sites=5, **tiny)
        for what, task, kw in (("device_data gcml", pan, dict(strategy="gcml", max_dropout=2)),
                               ("device_data fedprox", dose, dict(strategy="fedprox",
                                                                  max_dropout=1)),
                               ("device_data pods:2", dose, dict(topology="pods:2",
                                                                 max_dropout=1)),
                               ("device_data dp", dose, dict(max_dropout=1, **DP_KW))):
            _small_pair(torch, FederatedJob, what,
                        FederatedJob(task=task, rounds=3, device_data=True, **kw))
        base = FederatedJob(task=dose, rounds=5, ckpt_every=2, max_dropout=2, device_data=True)
        full = base.run()
        with _ckpt_dir() as d:
            base.replace(checkpoint_dir=d).run(rounds=3)
            res = base.replace(checkpoint_dir=d).run(resume=True)
        _hold_resume(torch, "device_data", full, res)
        print("small device_data resume: bit-equal to the uninterrupted run on the card")
        refusals = [(dict(device_data=True, compression="int8"), "device_data=True (on-device"),
                    (dict(device_data=True, round_engine="loop"), "requires the scan engine"),
                    (dict(device_data=True, sample="uniform:2"), "client sampling"),
                    (dict(shard_sites=True, strategy="gcml"), "shard_sites=True supports"),
                    (dict(shard_sites=True, compression="fp8"), "'none' or 'int8'"),
                    (dict(shard_sites=True, max_dropout=1), "'shutdown' scenario"),
                    (dict(shard_sites=True, transport="thread"), "shard_sites=True shards")]
        for kw, frag in refusals:
            try:
                FederatedJob(task=dose, rounds=1, **kw).run()
            except ValueError as e:
                _require(frag in str(e), f"small refusal {kw}: {e}")
            else:
                _require(False, f"small refusal {kw}: the job ran")
        print(f"small refusals: {len(refusals)} ValueErrors, the reference's messages")
        thread = FederatedJob(task=TaskConfig(kind="dose", sites=2, **tiny), rounds=2,
                              transport="thread")
        plain, on = thread.run(), thread.replace(device_data=True).run()
        _require(plain.losses == on.losses and plain.comm == on.comm
                 and torch.equal(_flat(torch, plain.global_params),
                                 _flat(torch, on.global_params)),
                 "small thread device_data: differs from the job without it")
        print(f"small thread job: device_data=True equal to the job without it "
              f"(losses {on.losses})")
        from repro_torch.launch import train
        with _ckpt_dir() as d:
            out = train.run(train.make_parser().parse_args(
                ["--task", "dose", "--sites", "3", "--rounds", "2", "--volume", "8",
                 "--base-filters", "4", "--batch", "1", "--quiet", "--out", d]))
            written = json.loads((Path(d) / "train_fedavg.json").read_text())
        _require(written["final_loss"] == out["final_loss"] and math.isfinite(out["final_loss"])
                 and out["compile_s"] > 0.0,
                 f"small CLI: {out['final_loss']} compile_s {out['compile_s']}")
        print(f"small CLI on the card by default: final loss {out['final_loss']:.6f}, "
              f"compile_s {out['compile_s']:.3f} (0.0 only on the CPU)")
    finally:
        _deterministic(torch, False)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def run_p19(torch, FederatedJob, TaskConfig, build, tasks, host_batch_s) -> dict:
    """Phase 19 (a-d at full width, the tail at 8^3); returns each
    full-width path's launches."""
    dose, brats = tasks
    jobs = (torch, FederatedJob, TaskConfig, build)
    out = {"19a": _timed("19a (sharded vs dense)", run_sharded_dense, *jobs, dose)}
    out.update(_timed("19b (64 sites, 4 trained a round)", run_many_sites, *jobs, dose))
    out.update(_timed("19c-d (device_data)", run_device_data, *jobs, tasks, host_batch_s))
    _timed("19 tail (small sharded, device_data, CLI jobs)", check_small_p19_jobs, torch,
           FederatedJob, TaskConfig)
    return out


def _flash_inputs(torch, dev, case, dtype, gen):
    b, hq, hkv, lq, lk, d = case[:6]
    return (torch.randn(b, hq, lq, d, device=dev, generator=gen).to(dtype),
            torch.randn(b, hkv, lk, d, device=dev, generator=gen).to(dtype),
            torch.randn(b, hkv, lk, d, device=dev, generator=gen).to(dtype))


def _attn_mask(torch, dev, lq, lk, causal, window):
    """[Lq, Lk] bool, True where a key is seen (the kernel's mask)."""
    q_pos = torch.arange(lq, device=dev)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=dev)[None, :]
    ok = torch.ones((lq, lk), dtype=torch.bool, device=dev)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def check_flash_attention(torch, dev) -> dict:
    """flash_attention vs its plain version at ragged shapes (both dtypes)
    and at gemma3-1b's per-layer shape with window 512 and with none;
    returns its kernels-line entry (the global layer, fp32)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(3)
    err = 0.0
    full = [GEMMA_ATTN + (True, 512), GEMMA_ATTN + (True, None)]
    for case in FLASH_CASES + full:
        causal, window = case[6:]
        for dtype, tol in ((torch.float32, FLASH_TOL), (torch.bfloat16, BF16_TOL)):
            q, k, v = _flash_inputs(torch, dev, case, dtype, gen)
            out = flash_attention_cuda(q, k, v, causal, window)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal, window)
            torch.testing.assert_close(out.float(), want.float(), **tol)
            if dtype == torch.float32:
                err = max(err, float((out - want).abs().max()))
    print(f"flash_attention: {len(FLASH_CASES) + len(full)} shapes x 2 dtypes agree with "
          f"the plain version (fp32 rtol=atol=1e-5, max |err| {err:.3e}; bf16 2e-2)")
    out = {}
    b, hq, hkv, lq, lk, d = GEMMA_ATTN
    for window in (512, None):
        q, k, v = _flash_inputs(torch, dev, GEMMA_ATTN, torch.float32, gen)
        mask = _attn_mask(torch, dev, lq, lk, True, window)
        pairs = int(mask.sum()) * b * hq                 # the (query, key) pairs seen
        lib = F.scaled_dot_product_attention(q, k.repeat_interleave(hq // hkv, 1),
                                             v.repeat_interleave(hq // hkv, 1),
                                             attn_mask=mask)
        lib_err = float((lib - ref.flash_attention_ref(q, k, v, True, window)).abs().max())
        out[window] = measure(
            torch, f"flash_attention {list(GEMMA_ATTN)} fp32 causal window={window}",
            lambda: flash_attention_cuda(q, k, v, True, window),
            lambda: ref.flash_attention_ref(q, k, v, True, window),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True),
            nbytes=4 * 2 * (q.numel() + k.numel()), flops=4 * d * pairs, tf32_products=3)
        out[window]["library_max_abs_err"] = lib_err
        print(f"  scaled_dot_product_attention vs the plain version: max |err| {lib_err:.3e}")
    return {"max_abs_err": err, **out[None], "window_512": out[512]}


def kernel_resources(build) -> None:
    """Registers, local memory, shared memory and blocks an SM of every
    instance of the five redesigned kernels, as ``cudaFuncGetAttributes`` and
    the occupancy calculator give them (each source's ``*_resources``; the
    bf16 attention kernels' in phase 24a)."""
    import ctypes
    from repro_torch.kernels import flash_attention, rwkv6_scan
    out = (ctypes.c_int * 5)()

    def report(what, err):
        _require(err == 0, f"{what}: CUDA error {err}")
        regs, local, smem, threads, blocks = out
        print(f"{what}: {regs} registers, local {local} B, shared {smem} B, "
              f"{threads} threads, {blocks} blocks an SM")
    one = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    fn = build.entry(flash_attention.NAME, "flash_attention_resources", one)
    for d in flash_attention.HEAD_DIMS:
        report(f"flash_attention D={d} fp32", fn(d, out))
    fn = build.entry(rwkv6_scan.NAME, "rwkv6_scan_resources",
                     [ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)])
    for d in rwkv6_scan.HEAD_DIMS:
        for bf16 in (0, 1):
            report(f"rwkv6_scan D={d} {'bf16' if bf16 else 'fp32'}", fn(d, bf16, out))
    fn = build.entry("mamba_scan", "mamba_scan_resources", one)
    for ds in (4, 8, 16, 32):          # the instance of each threads-a-channel split
        report(f"mamba_scan d_state<={ds}", fn(ds, out))
    fn = build.entry("quantize_int8", "quantize_int8_resources", one)
    for c in (128, 256, 512, 1024, 1028):  # the register path's width classes, then any
        report(f"quantize_int8 width {c}", fn(c, out))
    fn = build.entry("dequantize_int8", "dequantize_int8_resources",
                     [ctypes.POINTER(ctypes.c_int)])
    report("dequantize_int8 grouped", fn(out))


def _rwkv_inputs(torch, dev, shape, dtype, gen):
    b, h, l, d = shape
    r, k, v = (torch.randn(b, h, l, d, device=dev, generator=gen) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(b, h, l, d, device=dev, generator=gen) - 5.0))
    u = torch.randn(h, d, device=dev, generator=gen) * 0.1
    return [t.to(dtype) for t in (r, k, v, w)] + [u]


def _close_scaled(torch, got, want, what: str) -> float:
    """got vs want within SCAN_RTOL, atol SCAN_RTOL of want's largest value."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=SCAN_RTOL,
                               atol=SCAN_RTOL * max(scale, 1.0), msg=lambda m: f"{what}: {m}")
    return float((got.float() - want.float()).abs().max()) if want.numel() else 0.0


def check_rwkv6_scan(torch, dev) -> dict:
    """rwkv6_scan (out and final state) vs its plain version at ragged
    shapes and rwkv6-7b's per-layer shape; returns its kernels-line entry."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    gen = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for shape in RWKV_CASES + [RWKV_FULL]:
        for dtype in (torch.float32, torch.bfloat16):
            xs = _rwkv_inputs(torch, dev, shape, dtype, gen)
            out, state = rwkv6_scan_cuda(*xs)
            torch.cuda.synchronize()
            w_out, w_state = ref.rwkv6_scan_ref(*xs)
            if dtype == torch.float32:
                err = max(err, _close_scaled(torch, out, w_out, f"rwkv6_scan out {shape}"),
                          _close_scaled(torch, state, w_state, f"rwkv6_scan state {shape}"))
            else:        # the state is fp32 either way; out is rounded to bf16 once
                _close_scaled(torch, state, w_state, f"rwkv6_scan bf16 state {shape}")
                torch.testing.assert_close(out.float(), w_out.float(), **BF16_TOL)
    print(f"rwkv6_scan: {len(RWKV_CASES) + 1} shapes x 2 dtypes, out and final state, agree "
          f"with the plain version (rtol {SCAN_RTOL}, atol {SCAN_RTOL} of the largest value; "
          f"max |err| {err:.3e})")
    b, h, l, d = RWKV_FULL
    xs = _rwkv_inputs(torch, dev, RWKV_FULL, torch.float32, gen)
    print("rwkv6_scan: no library time: no one PyTorch call computes the WKV-6 recurrence")
    timing = measure(torch, f"rwkv6_scan {list(RWKV_FULL)} fp32",
                     lambda: rwkv6_scan_cuda(*xs), lambda: ref.rwkv6_scan_ref(*xs), None,
                     nbytes=4 * (5 * b * h * l * d + h * d + b * h * d * d),
                     flops=5 * b * h * l * d * d)   # k v, the S update, r S
    return {"max_abs_err": err, **timing}


def _mamba_inputs(torch, dev, shape, gen):
    import torch.nn.functional as F
    b, l, di, ds = shape
    dt = F.softplus(torch.randn(b, l, di, device=dev, generator=gen) - 3.0)
    bm, cm = (torch.randn(b, l, ds, device=dev, generator=gen) for _ in range(2))
    x = torch.randn(b, l, di, device=dev, generator=gen)
    # a row of A for each channel: log(1..ds) plus N(0, 0.1), so a kernel
    # that reads another channel's row disagrees
    log_a = torch.log(torch.arange(1, ds + 1, device=dev, dtype=torch.float32)).expand(di, ds)
    log_a = log_a + 0.1 * torch.randn(di, ds, device=dev, generator=gen)
    return dt, bm, cm, x, log_a.contiguous()


def check_mamba_scan(torch, dev) -> dict:
    """mamba_scan (y and final state) vs its plain version at ragged shapes
    and Jamba-1.5-Large's per-layer shape, with a row of A for each
    channel; returns its kernels-line entry, with its bound the largest of
    the bytes, the fp32 instructions the SASS shows and the ex2s."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda
    gen = torch.Generator(device=dev).manual_seed(5)
    err = 0.0
    for shape in MAMBA_CASES + [MAMBA_FULL]:
        xs = _mamba_inputs(torch, dev, shape, gen)
        y, state = mamba_scan_cuda(*xs)
        torch.cuda.synchronize()
        w_y, w_state = ref.mamba_scan_ref(*xs)
        err = max(err, _close_scaled(torch, y, w_y, f"mamba_scan y {shape}"),
                  _close_scaled(torch, state, w_state, f"mamba_scan state {shape}"))
    print(f"mamba_scan: {len(MAMBA_CASES) + 1} shapes, y and final state, agree with the "
          f"plain version (rtol {SCAN_RTOL}, atol {SCAN_RTOL} of the largest value; "
          f"max |err| {err:.3e})")
    b, l, di, ds = MAMBA_FULL
    xs = _mamba_inputs(torch, dev, MAMBA_FULL, gen)
    entries = b * l * di * ds                     # state entries a step, summed over steps
    fp32_per_entry, ex2 = _mamba_sass_counts(build, ds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm"))
    clock_ms = 1e3 / (sms * mhz * 1e6)            # one clock of every SM
    sfu_ms = entries / 16 * clock_ms              # every exp a MUFU.EX2, 16 a clock an SM
    frac, per_entry = _issue_sfu_floor(fp32_per_entry)
    ops_ms = entries * per_entry * clock_ms
    print(f"mamba_scan: the SASS of the d_state<={ds} instance has {fp32_per_entry:.2f} fp32 "
          f"instructions (FFMA, FMUL, FADD) per MUFU.EX2 ({ex2} of those); {sms} SMs at "
          f"{mhz:.0f} MHz (clocks.max.sm). Every exp on the special-function unit (16 a "
          f"clock an SM) would take {sfu_ms:.4f} ms, a floor of this design, not of the "
          f"scan: with {frac:.1%} of the exps as a {SOFT_EXP2_INSTRUCTIONS}-instruction "
          f"software exp2 on the fp32 lanes, issue (128 lanes a clock an SM, a MUFU one "
          f"slot) and SFU balance at {per_entry * 128:.2f} slots an entry, {ops_ms:.4f} ms")
    print("mamba_scan: no library time: no one PyTorch call computes the selective scan")
    timing = measure(torch, f"mamba_scan {list(MAMBA_FULL)} fp32",
                     lambda: mamba_scan_cuda(*xs), lambda: ref.mamba_scan_ref(*xs), None,
                     nbytes=4 * (3 * b * l * di + 2 * b * l * ds + di * ds + b * di * ds),
                     flops=0, ops_ms=ops_ms)
    return {"max_abs_err": err, **timing, "fp32_instructions_per_entry": fp32_per_entry,
            "sfu_ms": sfu_ms}


def _issue_sfu_floor(fp32: float, soft: int = SOFT_EXP2_INSTRUCTIONS):
    """(the share of exps taken off the SFU, clocks an SM per state entry)
    for a scan that needs ``fp32`` fp32 instructions and one exp an entry,
    when each exp may be a MUFU.EX2 (one issue slot, and the SFU's 16 lanes
    a clock an SM) or a software exp2 of ``soft`` instructions on the fp32
    lanes (128 slots a clock an SM): the share f that balances issue,
    (fp32 + 1 + f * (soft - 1)) / 128, against the SFU, (1 - f) / 16."""
    f = max(0.0, (7.0 - fp32) / (soft + 7.0))
    return f, max((fp32 + 1 + f * (soft - 1)) / 128, (1 - f) / 16)


def _smi(field: str) -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={field}",
                           "--format=csv,noheader,nounits"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _sass_ops(build, name: str) -> dict:
    """The opcodes of each ``__global__`` function (by its mangled name) in
    the built library of kernel ``name``, from ``cuobjdump -sass``."""
    import re
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        head, _, body = func.partition("\n")
        out[head.strip()] = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                                       body, re.M)
    return out


def _mamba_sass_counts(build, ds: int):
    """(fp32 instructions per MUFU.EX2, MUFU.EX2 count) in the SASS of the
    mamba_scan instance that takes ``ds`` (its template arguments: threads a
    channel, states a thread), from ``cuobjdump -sass`` on the built library.
    The step loop is unrolled, with one ex2 an entry; the few ex2 of the
    prologue's A count in with them."""
    threads, per = {4: (2, 2), 8: (2, 4), 16: (2, 8), 32: (4, 8)}[ds]
    tag = f"mamba_scan_kernelILi{threads}ELi{per}E"
    funcs = [ops for f, ops in _sass_ops(build, "mamba_scan").items() if tag in f]
    _require(len(funcs) == 1, f"mamba_scan: {len(funcs)} SASS functions named {tag}")
    ops = funcs[0]
    ex2 = sum(o.startswith("MUFU.EX2") for o in ops)
    fp32 = sum(o.split(".")[0] in ("FFMA", "FMUL", "FADD") for o in ops)
    _require(ex2 > 0, "mamba_scan: no MUFU.EX2 in its SASS")
    return fp32 / ex2, ex2


def _serving_report(torch, name: str, out: dict, kernel: str, layers: int) -> dict:
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve {name}: prefill {out['prefill_s']:.4f} s, decode {out['decode_s']:.4f} s, "
          f"{out['tok_per_s']:.1f} tok/s, peak memory {peak:.2f} GiB, continuation "
          f"{out['continuation']}")
    print(f"serve {name}: launches in prefill {out['prefill_launches']}, "
          f"in decode {out['decode_launches']}")
    _require(out["logits_finite"], f"serve {name}: a logit is not finite")
    _require(out["prefill_launches"].get(kernel, 0) == layers,
             f"serve {name}: {kernel} launched {out['prefill_launches'].get(kernel, 0)} "
             f"times in prefill, not {layers}")
    _require(not any(out["decode_launches"].get(k, 0) for k in TOKEN_KERNELS),
             f"serve {name}: a token kernel was launched in decode")
    return {k: out[k] for k in ("prefill_s", "decode_s", "tok_per_s")} | {"peak_gib": peak}


def run_serving_paths(torch, build) -> dict:
    """This slice's paths: the three token families served at full width;
    returns each kernel's launches on its path."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"serving: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, fp32 weights")
    launches = {}
    for arch, batch, prompt, steps, kernel, layers in (
            ("gemma3-1b", 4, 1024, 32, "flash_attention", 26),
            ("rwkv6-7b", 4, 512, 32, "rwkv6_scan", 32)):
        args = serve.make_parser().parse_args(
            ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
             "--decode-steps", str(steps)])
        args.reduced = False            # the published config (the CLI cannot unset it)
        _fresh(torch)
        build.reset_launches()
        out = serve.run(args)
        launches[kernel] = dict(build.LAUNCHES)
        _serving_report(torch, f"{arch} {batch}x{prompt}+{steps}", out, kernel, layers)

    cfg = dataclasses.replace(get_arch("jamba-1.5-large-398b").CONFIG, num_layers=2)
    _fresh(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init(gen, cfg, "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    build.reset_launches()
    out = serve.generate(params, prompts, cfg, 16)
    launches["mamba_scan"] = dict(build.LAUNCHES)
    out["continuation"] = out["tokens"][0][:16].tolist()
    out["logits_finite"] = bool(torch.isfinite(out["logits"]).all())
    print(f"serve jamba-1.5-large-398b cut to 2 layers ({[s.mixer + '+' + s.ffn for s in cfg.layer_specs()]}, "
          f"{n_params} parameters)")
    _serving_report(torch, "jamba 2 layers 2x512+16", out, "mamba_scan", 2)
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_small_serving(torch, build, archs=SMALL_ARCHS[:5]) -> None:
    """Reduced token configs (phase 10: the first five of ``SMALL_ARCHS``,
    phase 23d: the other five) served on the card and on the CPU (the
    plain versions) from the same seeded weights and prompts; the CPU side
    is held to the JAX reference by tests/test_torch_serve.py."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in archs:
        cfg = get_arch(arch).reduced()
        gen = torch.Generator().manual_seed(7)
        params = T.init(gen, cfg, "cpu")
        shape = (2, 20) if cfg.num_codebooks == 1 else (2, 20, cfg.num_codebooks)
        prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen)
        cpu = serve.generate(params, prompts, cfg, 6)
        before = dict(build.LAUNCHES)
        gpu = serve.generate(tree_map(lambda t: t.cuda(), params), prompts.cuda(), cfg, 6)
        launched = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0) for k in TOKEN_KERNELS}
        gap = float((gpu["logits"].cpu() - cpu["logits"]).abs().max())
        print(f"small serve {arch}: tokens cuda {gpu['tokens'][0].tolist()} cpu "
              f"{cpu['tokens'][0].tolist()}, max |logit gap| {gap:.3e}, launched {launched}")
        _require(torch.equal(gpu["tokens"].cpu(), cpu["tokens"]),
                 f"small serve {arch}: greedy tokens differ between card and CPU")
        torch.testing.assert_close(gpu["logits"].cpu(), cpu["logits"], **SERVE_TOL)
        _require(sum(launched.values()) == cfg.num_layers,
                 f"small serve {arch}: {launched} token-kernel launches for "
                 f"{cfg.num_layers} layers")


# -- the token task: the attention backward, smollm-135m FedAvg (phase 20) -------

SMOLLM_ATTN = (4, 9, 3, 2048, 2048, 64)           # smollm-135m's training shape, per layer
# the backward at ragged shapes: (batch, q heads, kv heads, Lq, Lk, D, causal,
# window): no Lq or Lk a multiple of its 64-row tiles but one, Lq < Lk, GQA
# groups 1 and 3 (and 2, 4), D 32, 64 and 128, windows inside and across tiles,
# both masks, one query and one key; then D 256 (phase 22a): one query and one
# key, Lq < Lk, GQA 4:1 and 8:2, windows inside and across tiles, both masks,
# B 1-3
BWD_CASES = [(1, 2, 2, 1, 1, 32, True, None), (2, 4, 2, 37, 37, 32, True, 17),
             (1, 6, 2, 45, 70, 64, True, None), (3, 4, 1, 70, 99, 64, False, None),
             (1, 9, 3, 50, 50, 64, True, None), (2, 3, 3, 100, 130, 32, True, 45),
             (2, 6, 2, 200, 200, 64, True, 64), (1, 3, 1, 33, 600, 128, True, 512),
             (2, 8, 2, 129, 129, 128, False, 17), (1, 9, 3, 300, 300, 64, False, 70),
             (1, 3, 1, 64, 64, 32, True, None),
             (1, 4, 1, 1, 1, 256, True, None), (2, 4, 1, 37, 70, 256, True, 17),
             (3, 8, 2, 100, 130, 256, False, None), (1, 4, 1, 200, 300, 256, True, 100),
             (2, 8, 2, 129, 129, 256, False, 45), (1, 4, 1, 64, 64, 256, True, None)]
# The backward against its plain version, both fp32: each of dq, dk and dv is
# a sum of up to G * Lq = 6,144 products (dk, dv at smollm's shape; dq sums
# Lk) taken in another order (the kernel's 3xTF32 products a 64-wide stage at
# a time, added in fp32, against the einsums'), and p = exp(s - lse) carries
# the forward's lse, within FLASH_TOL of the plain lse.  Random-walk rounding of such sums is about sqrt(6144) * 2^-24 =
# 4.7e-6 of the largest partial sum, each side rounding on its own: rtol 1e-5,
# and atol 1e-5 of the output's largest value (at least 1: one query against
# one key gives dq = dk = 0 in exact arithmetic and rounding noise in each).
BWD_RTOL = 1e-5
SMOLLM_N = 134_515_008                             # smollm-135m's parameter count
SMOLLM_LAYERS = 30
SMOLLM_TASK = dict(kind="tokens", arch="smollm-135m", reduced=False, seq=2048, batch=4,
                   sites=4)
# one site step's gradient, the kernels against the plain versions on the card:
# every leaf within GRAD_RTOL of its largest value (30 layers of attention,
# each forward within FLASH_TOL and each backward within BWD_RTOL of the plain)
GRAD_RTOL = 1e-4
SMALL_TOKENS = dict(kind="tokens", arch="smollm-135m", sites=3, batch=2, seq=32)


def _close_bwd(torch, got, want, what: str) -> float:
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=BWD_RTOL, atol=BWD_RTOL * max(scale, 1.0),
                               msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max()) if want.numel() else 0.0


def _bwd_attn_resources(build, dims) -> None:
    """The fp32 backward's kernels' resources at each head dim of ``dims``:
    the cluster's blocks and the clusters the card holds at once where D is
    split."""
    import ctypes
    from repro_torch.kernels import flash_attention as fa
    out7 = (ctypes.c_int * 7)()
    fn = build.entry(fa.BWD_NAME, "flash_attention_bwd_resources",
                     [ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)])
    for d in dims:
        for which, name in ((0, "dK/dV"), (1, "dQ")):
            _require(fn(d, which, out7) == 0, f"flash_attention_bwd {name} D={d} resources")
            regs, local, smem, threads, blocks, split, clusters = out7
            cluster = (f", clusters of {split}, {clusters} at once" if split > 1 else "")
            print(f"flash_attention_bwd {name} D={d}: {regs} registers, local {local} B, "
                  f"shared {smem} B, {threads} threads, {blocks} blocks an SM{cluster}")


def _hold_bwd(torch, dev, gen, cases) -> tuple:
    """The forward's ``lse`` against ``flash_attention_lse_ref`` and its
    output bit-equal to the serving call's, then the backward against
    ``flash_attention_bwd_ref`` within ``BWD_RTOL``, two launches bit-equal,
    at each of ``cases``; returns the largest |err| of the backward and of
    ``lse``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    err, lse_err = 0.0, 0.0
    for case in cases:
        causal, window = case[6:]
        q, k, v = _flash_inputs(torch, dev, case, torch.float32, gen)
        g = torch.randn(q.shape, device=dev, generator=gen)
        out, lse = fa.flash_attention_cuda(q, k, v, causal, window, with_lse=True)
        plain_out = fa.flash_attention_cuda(q, k, v, causal, window)
        want_out, want_lse = ref.flash_attention_lse_ref(q, k, v, causal, window)
        torch.cuda.synchronize()
        _require(torch.equal(out, plain_out), f"flash_attention {case}: out with lse differs")
        torch.testing.assert_close(lse, want_lse, **FLASH_TOL)
        torch.testing.assert_close(out, want_out, **FLASH_TOL)
        lse_err = max(lse_err, float((lse - want_lse).abs().max()))
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal, window)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal, window)
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"flash_attention_bwd {case}: two launches differ")
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal, window)
        err = max(err, *(_close_bwd(torch, a, w, f"flash_attention_bwd {case} d{n}")
                         for n, a, w in zip("qkv", got, want)))
        del q, k, v, g, out, lse, got, again, want
    print(f"flash_attention: lse of {len(cases)} shapes within rtol=atol=1e-5 of the "
          f"plain version (max |err| {lse_err:.3e}); out bit-equal with and without lse")
    print(f"flash_attention_bwd: {len(cases)} shapes agree with the plain version "
          f"(rtol {BWD_RTOL}, atol {BWD_RTOL} of the largest value; max |err| {err:.3e}); "
          f"two launches bit-equal at each")
    return err, lse_err


def check_flash_attention_bwd(torch, build, dev) -> dict:
    """Phase 20a: the forward's ``lse`` against ``flash_attention_lse_ref``
    and its output bit-equal to the serving call's (no ``lse``); the
    backward against ``flash_attention_bwd_ref`` at ragged shapes and at
    smollm-135m's, two launches bit-equal; the instances it has not got
    refused; its resources; its time beside its bound, the plain backward's
    and SDPA's backward alone; the forward at smollm's shape with and
    without ``lse``, in turns, and with ``lse`` beside its own bound and
    SDPA's forward.  Returns its kernels-line entry (the forward's numbers
    at smollm's shape under ``forward``)."""
    import torch.nn.functional as F
    from repro_torch import NotPorted
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    _bwd_attn_resources(build, [d for d in fa.BWD_HEAD_DIMS if d < 256])
    gen = torch.Generator(device=dev).manual_seed(20)
    err, _ = _hold_bwd(torch, dev, gen, [c for c in BWD_CASES if c[5] < 256]
                       + [SMOLLM_ATTN + (True, None)])
    for dtype, d in ((torch.float32, 96), (torch.bfloat16, 96)):
        q = torch.zeros(1, 2, 8, d, device=dev, dtype=dtype)
        kv = torch.zeros(1, 1, 8, d, device=dev, dtype=dtype)
        try:
            fa.flash_attention_bwd_cuda(q, kv, kv, q, torch.zeros(1, 2, 8, device=dev), q)
        except NotPorted as e:
            print(f"flash_attention_bwd {dtype} D={d}: refused ({e})")
        else:
            _require(False, f"flash_attention_bwd {dtype} D={d} was not refused")

    b, hq, hkv, lq, lk, d = SMOLLM_ATTN
    q, k, v = _flash_inputs(torch, dev, SMOLLM_ATTN, torch.float32, gen)
    g = torch.randn(q.shape, device=dev, generator=gen)
    out, lse = fa.flash_attention_cuda(q, k, v, True, None, with_lse=True)
    pairs = int(_attn_mask(torch, dev, lq, lk, True, None).sum()) * b * hq
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)

    def library():
        return torch.autograd.grad(lib_out, leaves, g, retain_graph=True)
    lib_err = max(float((a - w).abs().max()) for a, w in zip(
        library(), ref.flash_attention_bwd_ref(q, k, v, out, lse, g, True, None)))
    print(f"  scaled_dot_product_attention's backward vs the plain version: max |err| "
          f"{lib_err:.3e}")
    # the bound: five products of 2 D flops a seen (query, key) pair, as the
    # forward's (row 7) at three TF32 products a flop, the card's fastest
    # fp32-accurate rate; bytes: q, k, v, out, dout, lse read, dq, dk, dv
    # written
    flops = 5 * 2 * d * pairs
    timing = measure(
        torch, f"flash_attention_bwd {list(SMOLLM_ATTN)} fp32 causal",
        lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, True, None),
        lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, g, True, None), None,
        nbytes=4 * (4 * q.numel() + 4 * k.numel() + lse.numel()), flops=flops,
        tf32_products=3)
    tf32_rate = peaks(torch.cuda.get_device_name(0))[2]
    print(f"flash_attention_bwd: this design's floor (seven products, s and dp twice, "
          f"3 TF32 products a flop at {tf32_rate / 1e12:.0f} TFLOP/s), not a bound: "
          f"{1e3 * 3 * flops * 7 / 5 / tf32_rate:.4f} ms")
    for _ in range(3):
        library()
    # SDPA's backward runs on the stream its forward ran on, outside a graph
    # capture, so it is timed eager: compare it with the kernel's eager_ms
    timing["library_ms"] = _median_ms(library, 25)
    timing["library_max_abs_err"] = lib_err
    print(f"flash_attention_bwd: library (scaled_dot_product_attention's backward alone, "
          f"fp32, eager) {timing['library_ms']:.4f} ms against the kernel's eager "
          f"{timing['eager_ms']:.4f} ms")
    fwd = {"plain": [], "lse": []}
    for which in ("plain", "lse", "lse", "plain"):
        fwd[which].append(time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, True, None, with_lse=which == "lse"))[0])
    print(f"flash_attention {list(SMOLLM_ATTN)} fp32 causal, in turns: without lse "
          f"{fwd['plain']} ms, with lse {fwd['lse']} ms")
    # row 7's forward as training calls it (with lse): two products of 2 D
    # flops a seen pair at 3 TF32 products a flop; bytes: q, k, v read, out
    # and lse written; SDPA's forward (fp32, GQA) timed in a graph beside it
    forward = measure(
        torch, f"flash_attention {list(SMOLLM_ATTN)} fp32 causal, with lse",
        lambda: fa.flash_attention_cuda(q, k, v, True, None, with_lse=True),
        lambda: ref.flash_attention_lse_ref(q, k, v, True, None),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        nbytes=4 * (2 * q.numel() + 2 * k.numel() + lse.numel()), flops=2 * 2 * d * pairs,
        tf32_products=3)
    forward["library_max_abs_err"] = float((F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True) - out).abs().max())
    print(f"  scaled_dot_product_attention's forward vs the kernel's: max |err| "
          f"{forward['library_max_abs_err']:.3e}")
    return {"max_abs_err": err, **timing,
            "forward_ms": {k: sorted(v) for k, v in fwd.items()}, "forward": forward}


def _flat_grad_spy():
    """Wrap ``RavelLayout.flat_grad`` to record each call's leaves that got
    no gradient; returns (the list of those, a function that undoes it)."""
    from repro_torch.core import agg_engine
    orig = agg_engine.RavelLayout.flat_grad
    missing = []

    def spy(self, leaves, grads):
        missing.extend(i for i, g in enumerate(grads) if g is None)
        return orig(self, leaves, grads)
    agg_engine.RavelLayout.flat_grad = spy
    return missing, lambda: setattr(agg_engine.RavelLayout, "flat_grad", orig)


def _site_grads(torch, bundle, params, batch):
    """One site step's loss and gradients (as the round loop takes them:
    ``autograd.grad`` of the task's loss, ``allow_unused``)."""
    from repro_torch.tree import tree_leaves, tree_unflatten, tree_map
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    tree = tree_unflatten(tree_map(lambda t: None, params), leaves)
    loss, _ = bundle.loss_fn(tree, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)


def run_smollm_fedavg(torch, FederatedJob, TaskConfig, build) -> dict:
    """Phase 20b: smollm-135m at its published width (30 layers, d_model
    576, 9/3 heads of 64, vocab 49152) trained by 4-site FedAvg for 2 sync
    rounds, 4 x 2048 tokens a site step, random weights from seed 0, fp32
    matmuls; every site step's gradient has every leaf (no ``None``
    reaches ``flat_grad``); ``flash_attention`` and its backward launch 30
    times a site step, ``fedagg`` as phase 3 counts it.  Then one site step's
    gradient through the kernels against the same step through the plain
    versions on the card (the Function's forward and backward swapped for
    ``flash_attention_lse_ref`` and ``flash_attention_bwd_ref``), wq/wk/wv
    named.  Returns the path's launches."""
    from repro_torch.tree import tree_map
    missing, undo = _flat_grad_spy()
    try:
        result, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, SMOLLM_TASK,
                                         SMOLLM_N, "20b smollm-135m fedavg")
    finally:
        undo()
    _require(not missing, f"20b: {len(missing)} leaves reached flat_grad with no gradient")
    steps = SMOLLM_TASK["sites"] * ROUNDS
    _expect_launches("20b smollm-135m fedavg", launches,
                     {"flash_attention": SMOLLM_LAYERS * steps,
                      "flash_attention_bwd": SMOLLM_LAYERS * steps, "fedagg": ROUNDS + 1})
    print(f"20b: every leaf of every site step had a gradient ({steps} site steps); "
          f"step_s {[round(h['step_s'], 4) for h in result.history]}, batch_s "
          f"{[round(h['batch_s'], 4) for h in result.history]}, wall_s "
          f"{[round(h['wall_s'], 4) for h in result.history]}")
    del result
    gc.collect()
    torch.cuda.empty_cache()

    bundle = TaskConfig(**SMOLLM_TASK).build()
    params = tree_map(lambda t: t.cuda(), bundle.init_fn(0))
    batch = {"tokens": torch.from_numpy(bundle.stacked(0, 1)["tokens"][0, 0]).cuda()}
    _attn_kernels_vs_plain(torch, build, bundle, params, batch, SMOLLM_LAYERS, "20b")
    return launches


def _attn_kernels_vs_plain(torch, build, bundle, params, batch, layers: int,
                           what: str) -> None:
    """One site step's gradient through the attention kernels against the
    same step with the Function's forward and backward swapped for
    ``flash_attention_lse_ref`` and ``flash_attention_bwd_ref``, on the
    card: the backward launched once a layer, every leaf within
    ``GRAD_RTOL`` of its largest value, wq/wk/wv non-zero."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    build.reset_launches()
    loss, got = _site_grads(torch, bundle, params, batch)
    kernel_launches = dict(build.LAUNCHES)
    lse_cuda, bwd_cuda = fa._lse_cuda, fa.flash_attention_bwd_cuda
    fa._lse_cuda, fa.flash_attention_bwd_cuda = ref.flash_attention_lse_ref, \
        ref.flash_attention_bwd_ref
    try:
        build.reset_launches()
        plain_loss, want = _site_grads(torch, bundle, params, batch)
        plain_launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        fa._lse_cuda, fa.flash_attention_bwd_cuda = lse_cuda, bwd_cuda
    _require(kernel_launches.get("flash_attention_bwd", 0) == layers
             and not plain_launches, f"{what}: launches {kernel_launches} / {plain_launches}")
    worst, attn = 0.0, {}
    for (path, _), a, w in zip(_paths(params), got, want):
        _require(a is not None and w is not None, f"{what}: {path} got no gradient")
        scale = float(w.abs().max())
        rel = float((a - w).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        _require(rel <= GRAD_RTOL, f"{what}: {path} gradient {rel:.3e} of its largest value "
                                   f"from the plain versions' (bound {GRAD_RTOL})")
        if path.rsplit("/", 1)[-1] in ("wq", "wk", "wv"):
            _require(scale > 0, f"{what}: {path} has an all-zero gradient")
            attn[path] = (scale, rel)
    print(f"{what} one site step: loss kernels {float(loss):.6f} plain "
          f"{float(plain_loss):.6f}; {len(got)} leaves, worst gradient {worst:.3e} of its "
          f"leaf's largest value (bound {GRAD_RTOL}); wq/wk/wv (largest |grad|, relative "
          f"gap): {attn}")


def check_small_token_jobs(torch, FederatedJob, TaskConfig, build) -> None:
    """Phase 20c: small token jobs (reduced smollm-135m, 3 sites, 3 rounds)
    on the card and on the CPU: stacked FedAvg, ``device_data=True``, the
    thread transport, int8 both ways and per-example DP (the vmap rules),
    losses within ``JOB_RTOL`` as phase 6 holds them, bytes each side's
    own; a resume bit-equal on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    base = FederatedJob(task=TaskConfig(**SMALL_TOKENS), rounds=3)
    for what, kw in (("stacked fedavg", {}), ("device_data", dict(device_data=True)),
                     ("thread", dict(transport="thread")),
                     ("int8 both ways", dict(compression="int8", down_compression="int8")),
                     ("per-example dp", dict(dp_clip=0.5, dp_noise_multiplier=0.8,
                                             dp_mode="per-example"))):
        job = base.replace(**kw)
        build.reset_launches()
        gpu = job.run()
        launched = {k: v for k, v in build.LAUNCHES.items() if v}
        cpu = job.replace(device="cpu").run()
        print(f"small token job {what}: losses cuda {gpu.losses} cpu {cpu.losses}; bytes "
              f"cuda {gpu.comm['upload_bytes']} cpu {cpu.comm['upload_bytes']}; "
              f"launched {launched}")
        for g, c in zip(gpu.losses, cpu.losses):
            _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                     f"small token job {what}: cuda loss {g} != cpu loss {c}")
        _require(launched.get("flash_attention_bwd", 0) > 0,
                 f"small token job {what}: the backward kernel never ran")
    with _ckpt_dir() as d:
        full = base.replace(rounds=4).run()
        job = base.replace(rounds=4, checkpoint_dir=d, ckpt_every=2)
        job.run(rounds=3)
        res = job.run(resume=True)
    same = (res.resumed_from == 2 and res.history[-1]["per_site_loss"]
            == full.history[-1]["per_site_loss"] and torch.equal(
                _flat(torch, res.global_params), _flat(torch, full.global_params)))
    print(f"small token resume: from {res.resumed_from}, round 3 losses "
          f"{res.history[-1]['per_site_loss']} against {full.history[-1]['per_site_loss']}, "
          f"bit-equal {same}")
    _require(same, "small token resume: not bit-equal to the uninterrupted run")


def run_p20(torch, FederatedJob, TaskConfig, build) -> dict:
    """Phase 20 (a, b at full width; c small jobs); returns the backward's
    kernels-line entry and the path's launches."""
    entry = _timed("20a (flash_attention_bwd alone)", check_flash_attention_bwd, torch, build,
                   torch.device("cuda"))
    launches = _timed("20b (smollm-135m 4-site fedavg)", run_smollm_fedavg, torch,
                      FederatedJob, TaskConfig, build)
    _timed("20c (small token jobs, card and CPU)", check_small_token_jobs, torch,
           FederatedJob, TaskConfig, build)
    return {"entry": entry, "launches": launches}


# -- the scans' gradients: rwkv6-7b and Jamba training (phase 21) ----------------

# the WKV-6 backward at ragged shapes: (batch, heads, L, D, w): L 0, 1, and none
# a multiple of the 16-step checkpoint stage but 32; D 32 and 64; w near 0
# ("zero": exp(-exp(z + 3)), about 1e-9 at z = 0), in between, and near 1
RWKV_BWD_CASES = [(1, 1, 1, 32, "mid"), (2, 3, 13, 32, "zero"), (1, 5, 77, 64, "one"),
                  (3, 2, 300, 64, "mid"), (2, 40, 45, 32, "one"), (1, 4, 32, 64, "zero"),
                  (1, 2, 0, 64, "mid"), (1, 3, 17, 64, "zero")]
W_SHIFT = {"zero": 3.0, "mid": -5.0, "one": -9.0}
# the selective-scan backward at ragged shapes: (batch, L, d_inner, d_state,
# dt's shift): every threads-a-channel instance (d_state 1, 4, 5, 8, 12, 16,
# 20, 32), d_inner past a block's channels, L 0, 1 and not a multiple of 16;
# a shift of +4 makes dt about 4, so that exp(dt A) underflows to 0 where
# dt A < -87 (A reaches -32 at d_state 32)
MAMBA_BWD_CASES = [(1, 1, 5, 1, -3.0), (2, 13, 24, 8, -3.0), (1, 77, 300, 16, -3.0),
                   (2, 33, 130, 32, 4.0), (1, 45, 77, 5, -3.0), (2, 19, 200, 12, 4.0),
                   (1, 16, 100, 4, -3.0), (2, 0, 64, 16, -3.0), (1, 70, 68, 32, -3.0),
                   (2, 48, 36, 8, 4.0), (1, 33, 44, 20, -3.0), (1, 100, 4100, 16, 4.0)]
RWKV_TASK = dict(kind="tokens", arch="rwkv6-7b", reduced=False, seq=1024, batch=2, sites=2)
RWKV_LAYERS = 2                                    # depth cut from 32
RWKV_N = 976_859_136                               # rwkv6-7b at 2 layers
RWKV_TRAIN = (2, 64, 1024, 64)                     # its scans' shape in 21c
JAMBA_LAYERS = 1                                   # layer 0: Mamba + dense FFN
JAMBA_N = 2_098_077_696
# one site step's gradient through the kernels against the plain versions on
# the card: every leaf within RWKV_GRAD_RTOL of its largest value.  rwkv6-7b's
# per-head group norm of the scan's output amplifies round-off (as
# tests/test_torch_tokens.py finds on the CPU: the port in fp64 and in fp32 lie
# 2.6e-4 apart on the reduced config), so its gate is that test's, 1e-3;
# Jamba's, without it, is GRAD_RTOL
RWKV_GRAD_RTOL = 1e-3
SMALL_SCAN_ARCHS = ("rwkv6-7b", "jamba-1.5-large-398b")


def _rwkv_bwd_inputs(torch, dev, shape, regime, gen):
    b, h, l, d = shape
    r, k, v = (torch.randn(b, h, l, d, device=dev, generator=gen) for _ in range(3))
    z = torch.randn(b, h, l, d, device=dev, generator=gen)
    w = torch.exp(-torch.exp(z + W_SHIFT[regime]))
    u = torch.randn(h, d, device=dev, generator=gen) * 0.5
    dout = torch.randn(b, h, l, d, device=dev, generator=gen)
    dstate = torch.randn(b, h, d, d, device=dev, generator=gen)
    return (r, k, v, w, u), dout, dstate


def _mamba_bwd_inputs(torch, dev, shape, shift, gen):
    import torch.nn.functional as F
    b, l, di, ds = shape
    dt, bm, cm, x, log_a = _mamba_inputs(torch, dev, (b, l, di, ds), gen)
    dt = F.softplus(torch.randn(b, l, di, device=dev, generator=gen) + shift)
    dy = torch.randn(b, l, di, device=dev, generator=gen)
    dstate = torch.randn(b, di, ds, device=dev, generator=gen)
    return (dt, bm, cm, x, log_a), dy, dstate


def _hold_scan_bwd(torch, name, fwd, bwd, bwd_ref, xs, dgrad, dstate, what) -> float:
    """The forward with checkpoints bit-equal to the serving call; the
    backward twice, bit-equal; each gradient (the shared parameter's per
    batch row) within SCAN_RTOL of the plain backward.  Returns the
    largest error."""
    out, state, ckpt = fwd(*xs, with_ckpt=True)
    s_out, s_state = fwd(*xs)
    got = bwd(*xs, ckpt, dgrad, dstate)
    again = bwd(*xs, ckpt, dgrad, dstate)
    torch.cuda.synchronize()
    _require(torch.equal(out, s_out) and torch.equal(state, s_state),
             f"{name} {what}: the forward with checkpoints differs from the serving call")
    _require(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"{name} {what}: two launches differ")
    want = bwd_ref(*xs, dgrad, dstate, rows=True)
    return max(_close_scaled(torch, a, w, f"{name} {what} grad {i}")
               for i, (a, w) in enumerate(zip(got, want)))


def _bwd_resources(build, name: str, instances, extra=()) -> None:
    """Print each instance's registers, local and shared bytes, threads and
    blocks an SM from ``<name>_resources``, then the ``extra`` fields the
    entry writes after them."""
    import ctypes
    out = (ctypes.c_int * (5 + len(extra)))()
    fn = build.entry(name, f"{name}_resources", [ctypes.c_int64, ctypes.POINTER(ctypes.c_int)])
    for inst in instances:
        _require(fn(inst, out) == 0, f"{name} {inst} resources")
        regs, local, smem, threads, blocks = out[:5]
        print(f"{name} {inst}: {regs} registers, local {local} B, shared {smem} B, "
              f"{threads} threads, {blocks} blocks an SM"
              + "".join(f", {out[5 + i]} {what}" for i, what in enumerate(extra)))


def check_rwkv6_scan_bwd(torch, build, dev) -> dict:
    """Phase 21a: the WKV-6 backward against ``rwkv6_scan_bwd_ref`` at
    ragged shapes (w near 0 and near 1, a non-zero final-state gradient)
    and at 21c's shape, two launches bit-equal, the forward's output and
    state with checkpoints bit-equal to the serving call's; its time beside
    its bound and the plain backward's.  Returns its kernels-line entry."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    _bwd_resources(build, rs.BWD_NAME, rs.BWD_HEAD_DIMS,
                   ("blocks a cluster", "clusters the card holds at once"))
    gen = torch.Generator(device=dev).manual_seed(21)
    err = 0.0
    for case in RWKV_BWD_CASES + [RWKV_TRAIN + ("mid",)]:
        xs, dout, dstate = _rwkv_bwd_inputs(torch, dev, case[:4], case[4], gen)
        err = max(err, _hold_scan_bwd(torch, "rwkv6_scan_bwd", rs.rwkv6_scan_cuda,
                                      rs.rwkv6_scan_bwd_cuda, ref.rwkv6_scan_bwd_ref, xs,
                                      dout, dstate, str(case)))
    print(f"rwkv6_scan_bwd: {len(RWKV_BWD_CASES) + 1} shapes agree with the plain backward "
          f"(rtol {SCAN_RTOL}, atol {SCAN_RTOL} of each gradient's largest value; max |err| "
          f"{err:.3e}); two launches bit-equal; the forward with checkpoints bit-equal to the "
          f"serving call")
    b, h, l, d = RWKV_TRAIN
    xs, dout, dstate = _rwkv_bwd_inputs(torch, dev, RWKV_TRAIN, "mid", gen)
    _, _, ckpt = rs.rwkv6_scan_cuda(*xs, with_ckpt=True)
    print("rwkv6_scan_bwd: no library time: no one PyTorch call computes the WKV-6 gradient")
    print(f"rwkv6_scan_bwd: this design also reads the checkpoints, "
          f"{4 * ckpt.numel() / 1e6:.1f} MB, and keeps every state on chip (no scratch)")
    # bytes: r, k, v, w, dout read, dr, dk, dv, dw written, u, dstate read and
    # du written once (the checkpoints are this design's); operations: 14 flops
    # a state entry a step (the state recomputed: k v and an FMA; the adjoint:
    # r dout and an FMA; four FMAs for dr, dk, dv, dw).  These are products
    # (S dout, G v, G^T k, rowsum(G * S)), which a chunked form runs on the
    # tensor cores, so they are priced as row 7b's are, at three TF32 products
    # a flop; this design's FMAs at the fp32 rate are printed as its floor
    flops = 14 * b * h * l * d * d
    fp32_rate = peaks(torch.cuda.get_device_name(0))[1]
    print(f"rwkv6_scan_bwd: this design's floor, {flops / 1e9:.2f} GFLOP of FMAs at the "
          f"fp32 rate outside the tensor cores: {1e3 * flops / fp32_rate:.4f} ms")
    timing = measure(
        torch, f"rwkv6_scan_bwd {list(RWKV_TRAIN)} fp32",
        lambda: rs.rwkv6_scan_bwd_cuda(*xs, ckpt, dout, dstate),
        lambda: ref.rwkv6_scan_bwd_ref(*xs, dout, dstate, rows=True), None,
        nbytes=4 * (9 * b * h * l * d + h * d + b * h * d * d + b * h * d),
        flops=flops, tf32_products=3)
    return {"max_abs_err": err, **timing}


def check_mamba_scan_bwd(torch, build, dev) -> dict:
    """Phase 21b: the selective-scan backward against
    ``mamba_scan_bwd_ref`` at ragged shapes (every d_state instance, dt
    large enough that exp(dt A) underflows, a non-zero final-state
    gradient) and at Jamba's, two launches bit-equal, the forward with
    checkpoints bit-equal to the serving call's; its time beside its bound
    and the plain backward's.  Returns its kernels-line entry."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    _bwd_resources(build, ms.BWD_NAME, (1, 4, 8, 16, 32), ("channels a block",))
    gen = torch.Generator(device=dev).manual_seed(22)
    err, under = 0.0, 0
    for case in MAMBA_BWD_CASES + [MAMBA_FULL + (-3.0,)]:
        xs, dy, dstate = _mamba_bwd_inputs(torch, dev, case[:4], case[4], gen)
        dt, log_a = xs[0], xs[4]
        if dt.numel():
            under += int((dt.amax() * -torch.exp(log_a).amax() < -87.0).item())
        err = max(err, _hold_scan_bwd(torch, "mamba_scan_bwd", ms.mamba_scan_cuda,
                                      ms.mamba_scan_bwd_cuda, ref.mamba_scan_bwd_ref, xs, dy,
                                      dstate, str(case)))
    _require(under >= 2, f"mamba_scan_bwd: exp(dt A) underflowed in {under} cases, not 2+")
    print(f"mamba_scan_bwd: {len(MAMBA_BWD_CASES) + 1} shapes agree with the plain backward "
          f"(rtol {SCAN_RTOL}, atol {SCAN_RTOL} of each gradient's largest value; max |err| "
          f"{err:.3e}; exp(dt A) underflows in {under}); two launches bit-equal; the forward "
          f"with checkpoints bit-equal to the serving call")
    b, l, di, ds = MAMBA_FULL
    xs, dy, dstate = _mamba_bwd_inputs(torch, dev, MAMBA_FULL, -3.0, gen)
    _, _, ckpt = ms.mamba_scan_cuda(*xs, with_ckpt=True)
    entries = b * l * di * ds
    mem_rate, fp32_rate, _ = peaks(torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm"))
    # operations: one exp an entry a step (a_t), each on the SFU (16 a clock
    # an SM), or 19 fp32 flops an entry at the fp32 rate (the state: dt A, the
    # drive times B, an FMA; the walk back: four FMAs (g, dC, dB, g B), g a
    # s_{t-1} (two products), two FMAs (ddt's A term, dA) and g a), whichever
    # is longer
    sfu_ms = 1e3 * entries / 16 / (sms * mhz * 1e6)
    flops_ms = 1e3 * 19 * entries / fp32_rate
    print(f"mamba_scan_bwd: one exp an entry on the SFU {sfu_ms:.4f} ms, 19 flops an entry "
          f"{flops_ms:.4f} ms; this design takes one exp an entry (the decays kept in "
          f"registers from the recompute to the walk back)")
    nbx = -(-di // ms.bwd_block_channels(ds))
    print(f"mamba_scan_bwd: this design also reads the checkpoints, "
          f"{4 * ckpt.numel() / 1e6:.1f} MB, and writes and reads {nbx} blocks' partials of "
          f"dB and dC, {2 * 4 * nbx * b * l * ds / 1e6:.1f} MB")
    print("mamba_scan_bwd: no library time: no one PyTorch call computes the scan's gradient")
    _time_bwd_parts(torch, build, ms, xs, ckpt, dy, dstate)
    timing = measure(
        torch, f"mamba_scan_bwd {list(MAMBA_FULL)} fp32",
        lambda: ms.mamba_scan_bwd_cuda(*xs, ckpt, dy, dstate),
        lambda: ref.mamba_scan_bwd_ref(*xs, dy, dstate, rows=True), None,
        nbytes=4 * (5 * b * l * di + 4 * b * l * ds + 2 * di * ds + 2 * b * di * ds),
        flops=0, ops_ms=max(sfu_ms, flops_ms))
    return {"max_abs_err": err, **timing, "sfu_ms": sfu_ms}


def _time_bwd_parts(torch, build, ms, xs, ckpt, dy, dstate) -> None:
    """Time the selective-scan backward's two kernels apart (CUDA-graph
    medians) through the library's walk-only and sum-only entry points;
    these calls are not counted as launches."""
    import ctypes
    dt, bm, cm, x, log_a = xs
    b, l, di = dt.shape
    ds = log_a.shape[1]
    nbx = -(-di // ms.bwd_block_channels(ds))
    outs = [torch.empty_like(t) for t in (dt, bm, cm, x)] + [torch.empty(b, di, ds,
                                                                          device=dt.device)]
    parts = [torch.empty(nbx, b, l, ds, device=dt.device) for _ in range(2)]
    ptrs = [t.data_ptr() for t in (*xs, ckpt, dy, dstate, *outs, *parts)]
    ms_of = {}
    for part in ("walk", "reduce"):
        fn = build.entry(ms.BWD_NAME, f"mamba_scan_bwd_{part}_f32", ms._BWD_ARGS)

        def call(fn=fn):
            _require(fn(*ptrs, b, l, di, ds, build.stream()) == 0, "mamba_scan_bwd part")
        ms_of[part] = time_ms(call)[0]
    print(f"mamba_scan_bwd {list(MAMBA_FULL)}: the walk kernel {ms_of['walk']:.4f} ms, the "
          f"partials' sum {ms_of['reduce']:.4f} ms (CUDA-graph medians, each alone)")


class _CutDepth:
    """Swap ``repro_torch.configs.<module>.CONFIG`` for the same config at
    ``layers`` layers while the block runs (``TaskConfig.model_config``
    reads it), and restore it after."""

    def __init__(self, module: str, layers: int):
        import importlib
        self.mod = importlib.import_module(f"repro_torch.configs.{module}")
        self.layers = layers

    def __enter__(self):
        self.full = self.mod.CONFIG
        self.mod.CONFIG = dataclasses.replace(self.full, num_layers=self.layers)
        print(f"{self.full.name}: depth cut from {self.full.num_layers} to {self.layers} "
              f"layers, widths as published")
        return self.mod.CONFIG

    def __exit__(self, *exc):
        self.mod.CONFIG = self.full


def _kernels_vs_plain(torch, build, bundle, params, batch, mod, what, rtol, named, bwd_name):
    """One site step's gradient through the kernels against the same step
    with ``mod``'s forward and backward swapped for their plain versions,
    on the card; every leaf within ``rtol`` of its largest value, the
    leaves whose names end in ``named`` non-zero.  Returns the kernel
    step's launches."""
    build.reset_launches()
    loss, got = _site_grads(torch, bundle, params, batch)
    kernel_launches = {k: v for k, v in build.LAUNCHES.items() if v}
    fwd, bwd = mod._fwd_cuda, getattr(mod, f"{bwd_name}_cuda")
    mod._fwd_cuda = mod._fwd_plain
    setattr(mod, f"{bwd_name}_cuda", mod._bwd_plain)
    try:
        build.reset_launches()
        plain_loss, want = _site_grads(torch, bundle, params, batch)
        plain_launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        mod._fwd_cuda = fwd
        setattr(mod, f"{bwd_name}_cuda", bwd)
    _require(bwd_name not in plain_launches and mod.NAME not in plain_launches,
             f"{what}: the plain step launched {plain_launches}")
    worst, worst_path, seen = 0.0, None, {}
    for (path, _), a, w in zip(_paths(params), got, want):
        _require(a is not None and w is not None, f"{what}: {path} got no gradient")
        scale = float(w.abs().max())
        rel = float((a - w).abs().max()) / max(scale, 1e-30)
        if rel >= worst:
            worst, worst_path = rel, path
        _require(rel <= rtol, f"{what}: {path} gradient {rel:.3e} of its largest value from "
                              f"the plain versions' (bound {rtol})")
        if path.rsplit("/", 1)[-1] in named:
            _require(scale > 0, f"{what}: {path} has an all-zero gradient")
            seen[path] = (f"{scale:.3e}", f"{rel:.3e}")
    _require(len(seen) >= len(named), f"{what}: named leaves {sorted(seen)}")
    print(f"{what} one site step: loss kernels {float(loss):.6f} plain {float(plain_loss):.6f}; "
          f"{len(got)} leaves, worst gradient {worst:.3e} of its leaf's largest value "
          f"({worst_path}; bound {rtol}); launches {kernel_launches}; {'/'.join(named)} "
          f"(largest |grad|, relative gap): {seen}")
    return kernel_launches


def run_rwkv6_fedavg(torch, FederatedJob, TaskConfig, build) -> dict:
    """Phase 21c: rwkv6-7b at its published width (d_model 4096, 64 heads of
    64, d_ff 14336, vocab 65536, LoRA ranks 64/32/64), depth cut to 2,
    trained by 2-site FedAvg for 2 sync rounds, 2 x 1024 tokens a site
    step, random weights from seed 0, fp32 matmuls: every leaf of every
    site step has a gradient; ``rwkv6_scan`` and ``rwkv6_scan_bwd`` launch
    once a layer a site step, ``fedagg`` as phase 3 counts it.  Then one
    site step's gradient at the trained global through the kernels against
    the plain versions on the card, w_r/w_k/w_v/u named.  Returns the
    path's launches."""
    from repro_torch.kernels import rwkv6_scan as rs
    with _CutDepth("rwkv6_7b", RWKV_LAYERS):
        missing, undo = _flat_grad_spy()
        try:
            result, launches, job = _run_job(torch, FederatedJob, TaskConfig, build,
                                             RWKV_TASK, RWKV_N, "21c rwkv6-7b fedavg")
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated() / 2**30
        _require(not missing, f"21c: {len(missing)} leaves reached flat_grad with no gradient")
        steps = RWKV_TASK["sites"] * ROUNDS
        _expect_launches("21c rwkv6-7b fedavg", launches,
                         {"rwkv6_scan": RWKV_LAYERS * steps,
                          "rwkv6_scan_bwd": RWKV_LAYERS * steps, "fedagg": ROUNDS + 1})
        print(f"21c: every leaf of every site step had a gradient ({steps} site steps); "
              f"step_s {[round(h['step_s'], 4) for h in result.history]}, batch_s "
              f"{[round(h['batch_s'], 4) for h in result.history]}, wall_s "
              f"{[round(h['wall_s'], 4) for h in result.history]}, peak {peak:.2f} GiB")
        params = result.global_params               # any weights will do: the trained ones
        del result, job
        gc.collect()
        torch.cuda.empty_cache()
        bundle = TaskConfig(**RWKV_TASK).build()
        batch = {"tokens": torch.from_numpy(bundle.stacked(0, 1)["tokens"][0, 0]).cuda()}
        _kernels_vs_plain(torch, build, bundle, params, batch, rs, "21c", RWKV_GRAD_RTOL,
                          ("w_r", "w_k", "w_v", "u"), "rwkv6_scan_bwd")
        del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_jamba_step(torch, TaskConfig, build) -> dict:
    """Phase 21d: Jamba-1.5-Large at its published width cut to its first
    layer (Mamba + dense FFN: d_inner 16384, d_state 16), one site step of 2
    x 512 tokens (random weights drawn on the card from seed 0): the
    gradient through the kernels against the plain versions on the card,
    within GRAD_RTOL, log_a/w_in/w_out named; ``mamba_scan_bwd`` launched
    once.  Returns the step's launches."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    task = dict(kind="tokens", arch="jamba-1.5-large-398b", reduced=False, seq=512, batch=2,
                sites=1)
    torch.cuda.reset_peak_memory_stats()
    with _CutDepth("jamba_1p5_large_398b", JAMBA_LAYERS) as cfg:
        bundle = TaskConfig(**task).build()
        params = T.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
        n = sum(t.numel() for t in _leaves(params))
        _require(n == JAMBA_N, f"21d: {n} parameters, not {JAMBA_N}")
        batch = {"tokens": torch.from_numpy(bundle.stacked(0, 1)["tokens"][0, 0]).cuda()}
        launches = _kernels_vs_plain(torch, build, bundle, params, batch, ms,
                                     f"21d jamba 1 layer ({n} parameters)", GRAD_RTOL,
                                     ("log_a", "w_in", "w_out"), "mamba_scan_bwd")
        _require(launches.get("mamba_scan") == 1 and launches.get("mamba_scan_bwd") == 1,
                 f"21d: launches {launches}")
        print(f"21d: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_small_scan_jobs(torch, FederatedJob, TaskConfig, build) -> None:
    """Phase 21e: reduced rwkv6-7b and Jamba trained on the card and on the
    CPU (stacked FedAvg and per-example DP, 3 sites, 3 rounds), losses
    within ``JOB_RTOL``, the scans' backward kernels launched on the card;
    then C9: a full-width gemma3-1b token job on the card (head dim 256)
    passes ``check_ported`` and its bf16 gradient passes
    ``ops.check_backward_instances``; its config at head dim 96 is refused
    by it with ``NotPorted("flash_attention_bwd")``, before any kernel is
    built or launched and before any batch is drawn."""
    from repro_torch import NotPorted
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, kernel in zip(SMALL_SCAN_ARCHS, ("rwkv6_scan_bwd", "mamba_scan_bwd")):
        base = FederatedJob(task=TaskConfig(**dict(SMALL_TOKENS, arch=arch)), rounds=3)
        for what, kw in (("stacked fedavg", {}),
                         ("per-example dp", dict(dp_clip=0.5, dp_noise_multiplier=0.8,
                                                 dp_mode="per-example"))):
            job = base.replace(**kw)
            build.reset_launches()
            gpu = job.run()
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            cpu = job.replace(device="cpu").run()
            print(f"small {arch} job {what}: losses cuda {gpu.losses} cpu {cpu.losses}; "
                  f"launched {launched}")
            for g, c in zip(gpu.losses, cpu.losses):
                _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                         f"small {arch} job {what}: cuda loss {g} != cpu loss {c}")
            _require(launched.get(kernel, 0) > 0, f"small {arch} job {what}: {kernel} never ran")
    drawn, prepared = [], []
    build_task, prepare = TaskConfig.build, build_mod.prepare
    TaskConfig.build = lambda self: drawn.append(self) or build_task(self)
    build_mod.prepare = lambda *a: prepared.append(a) or prepare(*a)
    build.reset_launches()
    gemma = FederatedJob(task=TaskConfig(**dict(SMALL_TOKENS, arch="gemma3-1b",
                                                 reduced=False)), rounds=1)
    try:
        gemma.check_ported()
        print("C9: full-width gemma3-1b (head dim 256, fp32) passes check_ported on the card")
        cfg = gemma.task.model_config()
        ops.check_backward_instances(cfg, torch.bfloat16)
        print("C9: and its bf16 gradient (the mixed policy's) passes check_backward_instances")
        ops.check_backward_instances(dataclasses.replace(cfg, head_dim=96), torch.bfloat16)
    except NotPorted as e:
        _require(e.seam == "flash_attention_bwd" and "head dim 96" in str(e),
                 f"C9: NotPorted({e.seam!r}): {e}")
        print(f"C9: gemma3-1b's config at head dim 96 on the card refused up front: {e}")
    else:
        _require(False, "C9: gemma3-1b's config at head dim 96 was not refused")
    finally:
        TaskConfig.build, build_mod.prepare = build_task, prepare
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    _require(not drawn and not prepared and not launched,
             f"C9: refused late: task built {len(drawn)}, kernels prepared {len(prepared)}, "
             f"launched {launched}")


def run_p21(torch, FederatedJob, TaskConfig, build) -> dict:
    """Phase 21 (a, b the kernels alone; c, d at full width; e small jobs
    and C9); returns the two backward kernels' kernels-line entries and the
    launches of 21c and 21d."""
    dev = torch.device("cuda")
    out = {"rwkv6_scan_bwd": _timed("21a (rwkv6_scan_bwd alone)", check_rwkv6_scan_bwd,
                                    torch, build, dev),
           "mamba_scan_bwd": _timed("21b (mamba_scan_bwd alone)", check_mamba_scan_bwd,
                                    torch, build, dev)}
    out["21c"] = _timed("21c (rwkv6-7b 2-site fedavg, 2 layers)", run_rwkv6_fedavg, torch,
                        FederatedJob, TaskConfig, build)
    out["21d"] = _timed("21d (jamba 1 layer, one site step)", run_jamba_step, torch,
                        TaskConfig, build)
    _timed("21e (small rwkv6-7b and jamba jobs, card and CPU; C9)", check_small_scan_jobs,
           torch, FederatedJob, TaskConfig, build)
    return out


# -- gemma3-1b training: the attention backward at head dim 256 (phase 22) -------

GEMMA_TRAIN = (2, 4, 1, 1024, 1024, 256)          # gemma3-1b's training shape, per layer
GEMMA_N = 999_826_048                              # gemma3-1b's parameter count
GEMMA_LAYERS = 26
GEMMA_TASK = dict(kind="tokens", arch="gemma3-1b", reduced=False, seq=1024, batch=2,
                  sites=2)
# the small job's model: gemma3's reduced config (2 layers, the first with a
# 16-key window, the second global; 32 tokens) at head dim 256
SMALL_GEMMA = dict(head_dim=256)


def check_flash_attention_bwd_256(torch, build, dev) -> dict:
    """Phase 22a: the backward's head-dim-256 instance (a cluster of four
    blocks splitting D) and the forward's ``lse`` at D 256, held as phase 20a
    holds the others at the D 256 cases of ``BWD_CASES`` and at gemma3-1b's
    training shape with its 512-key window and without, two launches
    bit-equal (bf16: phase 24a); its resources; at both of
    gemma's shapes its
    time beside its bound, the plain backward's and SDPA's backward alone
    (eager, with the mask as ``attn_mask``).  Returns its kernels-line
    entry (the global layer's numbers, the window's under ``window_512``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    _bwd_attn_resources(build, [256])
    gen = torch.Generator(device=dev).manual_seed(22)
    err, lse_err = _hold_bwd(torch, dev, gen, [c for c in BWD_CASES if c[5] == 256]
                             + [GEMMA_TRAIN + (True, 512), GEMMA_TRAIN + (True, None)])
    b, hq, hkv, lq, lk, d = GEMMA_TRAIN
    tf32_rate = peaks(torch.cuda.get_device_name(0))[2]
    out = {}
    for window in (None, 512):
        q, k, v = _flash_inputs(torch, dev, GEMMA_TRAIN, torch.float32, gen)
        g = torch.randn(q.shape, device=dev, generator=gen)
        o, lse = fa.flash_attention_cuda(q, k, v, True, window, with_lse=True)
        mask = _attn_mask(torch, dev, lq, lk, True, window)
        pairs = int(mask.sum()) * b * hq                 # the (query, key) pairs seen
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)

        def library():
            return torch.autograd.grad(lib_out, leaves, g, retain_graph=True)
        lib_err = max(float((a - w).abs().max()) for a, w in zip(
            library(), ref.flash_attention_bwd_ref(q, k, v, o, lse, g, True, window)))
        # row 7b's bound: five products of 2 D flops a seen pair at 3 TF32
        # products a flop; q, k, v, out, dout, lse read, dq, dk, dv written
        flops = 5 * 2 * d * pairs
        timing = measure(
            torch, f"flash_attention_bwd {list(GEMMA_TRAIN)} fp32 causal window={window}",
            lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, g, True, window),
            lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, g, True, window), None,
            nbytes=4 * (4 * q.numel() + 4 * k.numel() + lse.numel()), flops=flops,
            tf32_products=3)
        print(f"flash_attention_bwd D=256 window={window}: this design's floor (seven "
              f"products at {tf32_rate / 1e12:.0f} TFLOP/s), not a bound: "
              f"{1e3 * 3 * flops * 7 / 5 / tf32_rate:.4f} ms")
        for _ in range(3):
            library()
        timing["library_ms"] = _median_ms(library, 25)
        timing["library_max_abs_err"] = lib_err
        print(f"flash_attention_bwd D=256 window={window}: library "
              f"(scaled_dot_product_attention's backward alone, attn_mask, fp32, eager) "
              f"{timing['library_ms']:.4f} ms against the kernel's eager "
              f"{timing['eager_ms']:.4f} ms; its max |err| against the plain version "
              f"{lib_err:.3e}")
        out[window] = timing
        del q, k, v, g, o, lse, leaves, lib_out
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "lse_max_abs_err": lse_err, **out[None],
            "window_512": out[512]}


def run_gemma_fedavg(torch, FederatedJob, TaskConfig, build) -> dict:
    """Phase 22b: gemma3-1b at its published width (26 layers, d_model
    1152, 4/1 heads of 256, d_ff 6912 GeGLU, vocab 262144 tied, a 512-key
    window on 22 layers) trained by 2-site FedAvg for 2 sync rounds, 2 x
    1024 tokens a site step, random weights from seed 0, fp32 matmuls:
    every leaf of every site step has a gradient; ``flash_attention`` and
    its backward launch 26 times a site step, ``fedagg`` as phase 3 counts
    it; ``step_s``, ``batch_s`` and the peak printed.  Then (22c) one site
    step's gradient at the trained global through the kernels against the
    plain versions on the card.  Returns the path's launches."""
    missing, undo = _flat_grad_spy()
    try:
        result, launches, job = _run_job(torch, FederatedJob, TaskConfig, build, GEMMA_TASK,
                                         GEMMA_N, "22b gemma3-1b fedavg")
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _require(not missing, f"22b: {len(missing)} leaves reached flat_grad with no gradient")
    steps = GEMMA_TASK["sites"] * ROUNDS
    _expect_launches("22b gemma3-1b fedavg", launches,
                     {"flash_attention": GEMMA_LAYERS * steps,
                      "flash_attention_bwd": GEMMA_LAYERS * steps, "fedagg": ROUNDS + 1})
    print(f"22b: every leaf of every site step had a gradient ({steps} site steps); "
          f"step_s {[round(h['step_s'], 4) for h in result.history]}, batch_s "
          f"{[round(h['batch_s'], 4) for h in result.history]}, wall_s "
          f"{[round(h['wall_s'], 4) for h in result.history]}, peak {peak:.2f} GiB")
    params = result.global_params                   # any weights will do: the trained ones
    del result, job
    gc.collect()
    torch.cuda.empty_cache()
    bundle = TaskConfig(**GEMMA_TASK).build()
    batch = {"tokens": torch.from_numpy(bundle.stacked(0, 1)["tokens"][0, 0]).cuda()}
    _attn_kernels_vs_plain(torch, build, bundle, params, batch, GEMMA_LAYERS, "22c")
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class _SmallAt:
    """Swap ``repro_torch.configs.<module>.reduced`` for the reduced config
    with ``changes`` while the block runs (``TaskConfig.model_config``
    reads it), and restore it after."""

    def __init__(self, module: str, **changes):
        import importlib
        self.mod = importlib.import_module(f"repro_torch.configs.{module}")
        self.changes = changes

    def __enter__(self):
        self.reduced = self.mod.reduced
        cfg = dataclasses.replace(self.reduced(), **self.changes)
        self.mod.reduced = lambda: cfg
        return cfg

    def __exit__(self, *exc):
        self.mod.reduced = self.reduced


def check_small_gemma_jobs(torch, FederatedJob, TaskConfig, build) -> None:
    """Phase 22d: the reduced gemma3 config at head dim 256 trained on the
    card and on the CPU (stacked FedAvg, 3 sites, 3 rounds), losses within
    ``JOB_RTOL``, the backward kernel launched on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    with _SmallAt("gemma3_1b", **SMALL_GEMMA) as cfg:
        job = FederatedJob(task=TaskConfig(**dict(SMALL_TOKENS, arch="gemma3-1b")), rounds=3)
        build.reset_launches()
        gpu = job.run()
        launched = {k: v for k, v in build.LAUNCHES.items() if v}
        cpu = job.replace(device="cpu").run()
    print(f"small gemma3 job at head dim {cfg.resolved_head_dim} ({cfg.num_layers} layers, "
          f"window {cfg.sliding_window}, seq {SMALL_TOKENS['seq']}): losses cuda {gpu.losses} "
          f"cpu {cpu.losses}; launched {launched}")
    for g, c in zip(gpu.losses, cpu.losses):
        _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                 f"small gemma3 job: cuda loss {g} != cpu loss {c}")
    steps = SMALL_TOKENS["sites"] * 3
    _require(launched.get("flash_attention_bwd", 0) == cfg.num_layers * steps,
             f"small gemma3 job: flash_attention_bwd launched {launched}")


def run_p22(torch, FederatedJob, TaskConfig, build) -> dict:
    """Phase 22 (a the kernel alone; b, c at full width; d a small job);
    returns the D 256 instance's kernels-line entry and 22b's launches."""
    entry = _timed("22a (flash_attention_bwd at D 256 alone)", check_flash_attention_bwd_256,
                   torch, build, torch.device("cuda"))
    launches = _timed("22b-c (gemma3-1b 2-site fedavg; one site step against the plain "
                      "versions)", run_gemma_fedavg, torch, FederatedJob, TaskConfig, build)
    _timed("22d (a small gemma3 job at head dim 256, card and CPU)", check_small_gemma_jobs,
           torch, FederatedJob, TaskConfig, build)
    return {"entry": dict(entry, launches=launches.get("flash_attention_bwd", 0)),
            "launches": launches}


# -- the remaining token configs served at full width (phase 23) ------------------

MLA_ATTN = (2, 128, 512)                           # DeepSeek-V2's prefill: batch, heads, L
DEEPSEEK_LAYERS = 2                                # depth cut from 60: dense FFN, then MoE
DEEPSEEK_SERVE = (2, 512, 16)                      # batch, prompt, greedy steps
# (arch, config module, depth or None for the published one, batch, prompt, steps)
WIDE_SERVES = (("granite-3-2b", "granite_3_2b", None, 4, 1024, 32),
               ("musicgen-medium", "musicgen_medium", None, 4, 1024, 32),
               ("qwen3-moe-30b-a3b", "qwen3_moe_30b_a3b", 8, 2, 512, 16),
               ("chameleon-34b", "chameleon_34b", 8, 2, 1024, 16))
SMALL_DEEPSEEK = dict(kind="tokens", arch="deepseek-v2-236b", sites=2, batch=2, seq=32)


def check_flash_attention_mla(torch, dev) -> dict:
    """Phase 23a: ``flash_attention`` on MLA's padded route at DeepSeek-V2's
    prefill shape (q/k [2, 128, 512, 192], v [..., 128], causal, padded to
    the D 256 instance, at the kernel's scale 192 ** -0.5) held to the port's
    plain ``sdpa`` on the unpadded tensors at scale 192 ** -0.5 under
    ``FLASH_TOL``; the kernel's time (on the padded tensors) beside two
    bounds, the true work's (2 flops a seen pair a column of q/k 192 + v
    128, 3 TF32 products a flop; the unpadded tensors' bytes) and the
    padded work's, the plain version's time and SDPA's on the unpadded
    tensors.  Returns the kernels-line entry of ``flash_attention``'s
    ``mla`` instance (bound: the true work's)."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_cuda, padded_head_dim
    from repro_torch.models import attention as A
    mla = get_arch("deepseek-v2-236b").CONFIG.mla
    b, h, l = MLA_ATTN
    dqk, dv = mla.qk_head_dim, mla.v_head_dim
    d = padded_head_dim(max(dqk, dv))
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k = (torch.randn(b, l, h, dqk, device=dev, generator=gen) for _ in range(2))
    v = torch.randn(b, l, h, dv, device=dev, generator=gen)
    build.reset_launches()
    out = A._padded_attention(q, k, v, mla)                # the model's route
    torch.cuda.synchronize()
    _require(build.LAUNCHES.get("flash_attention", 0) == 1,
             "23a: the padded route did not launch flash_attention once")
    scale = dqk ** -0.5
    want = A.sdpa(q, k, v, A.causal_mask(l, l, device=dev), scale=scale)
    torch.testing.assert_close(out, want, **FLASH_TOL)
    err = float((out - want).abs().max())
    print(f"flash_attention mla: q/k {dqk}, v {dv} padded to D {d} at DeepSeek-V2's "
          f"[{b}, {h}, {l}] causal agrees with the unpadded plain sdpa at scale {dqk}^-0.5 "
          f"(rtol=atol=1e-5, max |err| {err:.3e})")

    def pad(t):
        return F.pad(t, (0, d - t.shape[-1])).transpose(1, 2).contiguous()
    qp, kp, vp = pad(q), pad(k), pad(v)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))   # [B, H, L, D]
    lib_err = float((F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=scale)
                     .transpose(1, 2) - want).abs().max())
    mask = A.causal_mask(l, l, device=dev)
    pairs = b * h * l * (l + 1) // 2                   # the (query, key) pairs seen
    timing = measure(
        torch, f"flash_attention mla [{b}, {h}, {l}] q/k {dqk} v {dv} (padded to {d}) fp32 "
        f"causal", lambda: flash_attention_cuda(qp, kp, vp, True, scale=scale),
        lambda: A.sdpa(q, k, v, mask, scale=scale),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=scale),
        nbytes=4 * b * h * l * (2 * dqk + 2 * dv), flops=2 * pairs * (dqk + dv),
        tf32_products=3)
    tf32_rate = peaks(torch.cuda.get_device_name(0))[2]
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    padded = max(1e3 * 4 * 4 * b * h * l * d / mem_rate, 1e3 * 3 * 2 * pairs * 2 * d / tf32_rate)
    print(f"flash_attention mla: the padded work's bound {padded:.4f} ms (2 x {d} columns a "
          f"pair, {(2 * d) / (dqk + dv):.2f}x the true work's products); SDPA's max |err| "
          f"against the plain version {lib_err:.3e}")
    del q, k, v, qp, kp, vp, qh, kh, vh, out, want, mask
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": err, **timing, "padded_bound_ms": padded,
            "library_max_abs_err": lib_err}


def check_flash_attention_served(torch, dev) -> dict:
    """Phase 23a, the shapes phase 23c serves: ``flash_attention`` at each
    ``WIDE_SERVES`` config's per-layer prefill shape (its batch, q heads,
    kv heads, prompt length and ``resolved_head_dim``, causal, at each of
    its layers' windows), fp32, held to the plain version on the same
    inputs under ``FLASH_TOL``.  Returns each config's max |err|."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(231)
    errs = {}
    for arch, _, _, b, lp, _ in WIDE_SERVES:
        cfg = get_arch(arch).CONFIG
        case = (b, cfg.num_heads, cfg.num_kv_heads, lp, lp, cfg.resolved_head_dim)
        windows = {spec.sliding_window for spec in cfg.layer_specs() if spec.mixer == "attn"}
        for window in sorted(windows, key=lambda w: w or 0):
            q, k, v = _flash_inputs(torch, dev, case, torch.float32, gen)
            out = flash_attention_cuda(q, k, v, True, window)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, True, window)
            torch.testing.assert_close(out, want, **FLASH_TOL)
            err = float((out - want).abs().max())
            errs[arch] = max(errs.get(arch, 0.0), err)
            print(f"flash_attention {list(case)} fp32 causal window={window} ({arch}'s "
                  f"prefill layer) agrees with the plain version (rtol=atol=1e-5, max |err| "
                  f"{err:.3e})")
            del q, k, v, out, want
    torch.cuda.empty_cache()
    return errs


def run_deepseek_serving(torch, build) -> dict:
    """Phase 23b: DeepSeek-V2 at its published width cut to 2 layers (MLA +
    the 12,288 dense FFN; MLA + 160 routed and 2 shared experts), random
    fp32 weights from seed 0, served 2 x 512 prompts + 16 greedy steps
    through ``serve.generate`` once with each MoE form: ``flash_attention``
    2 launches a prefill, none in decode; ``gather``'s logits held to
    ``dense``'s by ``SERVE_TOL`` with equal tokens; then, on layer 1's
    real MoE input, ``moe_apply_dispatch`` at ``capacity_factor = E /
    top_k`` (nothing dropped) held to ``moe_apply`` by ``SERVE_TOL``, and
    the pairs dropped at the default 1.25 printed.  Returns the dense
    run's launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import attention as A
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rmsnorm_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_arch("deepseek-v2-236b").CONFIG
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_LAYERS)
    _fresh(torch)
    gen = torch.Generator(device=CARD).manual_seed(0)
    params = T.init(gen, cfg, CARD)
    n_params = sum(t.numel() for t in _leaves(params))
    _require(n_params == T.count_params(cfg), "23b: the parameter count is not count_params'")
    b, lp, steps = DEEPSEEK_SERVE
    prompts = torch.randint(0, cfg.vocab_size, (b, lp), generator=gen, device=CARD)
    print(f"deepseek-v2-236b: depth cut from {full.num_layers} to {cfg.num_layers} layers, "
          f"widths as published ({[s.mixer + '+' + s.ffn for s in cfg.layer_specs()]}, "
          f"{n_params} parameters, {4 * n_params / 1e9:.2f} GB in fp32)")
    outs, launches = {}, None
    for form in ("dense", "gather", "dispatch"):
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        out = serve.generate(params, prompts, cfg, steps, moe_impl=form)
        out["continuation"] = out["tokens"][0].tolist()
        out["logits_finite"] = bool(torch.isfinite(out["logits"]).all())
        _serving_report(torch, f"deepseek-v2 2 layers {b}x{lp}+{steps} moe_impl={form}", out,
                        "flash_attention", DEEPSEEK_LAYERS)
        outs[form] = out
        launches = launches or dict(out["prefill_launches"])
    gap = float((outs["gather"]["logits"] - outs["dense"]["logits"]).abs().max())
    print(f"23b: gather against dense: max |logit gap| {gap:.3e}")
    _require(torch.equal(outs["gather"]["tokens"], outs["dense"]["tokens"]),
             "23b: gather's greedy tokens differ from dense's")
    torch.testing.assert_close(outs["gather"]["logits"], outs["dense"]["logits"], **SERVE_TOL)

    # layer 1's MoE input: the embedding through layer 0, then layer 1's MLA
    with torch.no_grad():
        x = T.embed_tokens(params, prompts, cfg)
        x, _, _ = T._layer_apply(params["prefix_layers"][0], x, cfg, cfg.layer_spec(0), None)
        p1 = params["prefix_layers"][1]
        x = x + A.mla_apply(p1["mixer"], rmsnorm_apply(p1["norm1"], x, cfg.norm_eps), cfg)[0]
        h = rmsnorm_apply(p1["norm2"], x, cfg.norm_eps)
        m = cfg.moe
        no_drop = m.num_experts / m.top_k
        probs = moe.router_probs(p1["ffn"], h.reshape(1, -1, cfg.d_model), m)
        *_, kept, cap = moe.dispatch_slots(probs, m, no_drop)
        *_, kept_default, cap_default = moe.dispatch_slots(probs, m)
        dense_y, dense_aux = moe.moe_apply(p1["ffn"], h, m)
        disp_y, disp_aux = moe.moe_apply_dispatch(p1["ffn"], h, m, capacity_factor=no_drop)
    gap = float((disp_y - dense_y).abs().max())
    print(f"23b: moe_apply_dispatch at capacity_factor {no_drop:.4f} (capacity {cap}) on "
          f"layer 1's input {list(h.shape)}: {int((~kept).sum())} pairs dropped, max |gap| to "
          f"moe_apply {gap:.3e}, aux {float(disp_aux):.6f} / {float(dense_aux):.6f}; at the "
          f"default 1.25 (capacity {cap_default}): {int((~kept_default).sum())} of "
          f"{kept_default.numel()} (token, slot) pairs dropped")
    _require(int((~kept).sum()) == 0, "23b: pairs dropped at capacity_factor E / top_k")
    torch.testing.assert_close(disp_y, dense_y, **SERVE_TOL)
    del params, outs, x, h, probs, dense_y, disp_y
    _fresh(torch)
    return launches


def run_wide_serves(torch, build) -> dict:
    """Phase 23c: granite-3-2b (40 layers) and musicgen-medium (48, 4
    codebooks) at their published depth, 4 x 1024 prompts + 32 steps;
    qwen3-moe-30b-a3b and chameleon-34b at their published widths cut to
    8 layers (``_CutDepth``), 2 x 512 + 16 and 2 x 1024 + 16; each through
    ``serve.run`` (dense), ``flash_attention`` once a layer in prefill and
    never in decode; then qwen3-moe's ``gather`` form through
    ``serve.generate`` on ``serve.run``'s weights and prompts (the same
    seed), its logits held to ``dense``'s by ``SERVE_TOL``, tokens equal.
    Returns each config's launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    for arch, module, layers, b, lp, steps in WIDE_SERVES:
        args = serve.make_parser().parse_args(
            ["--arch", arch, "--batch", str(b), "--prompt-len", str(lp),
             "--decode-steps", str(steps), "--device", CARD])
        args.reduced = False            # the published config (the CLI cannot unset it)
        cut = _CutDepth(module, layers) if layers else contextlib.nullcontext()
        with cut:
            cfg = get_arch(arch).CONFIG
            print(f"{arch}: {cfg.num_layers} layers, {T.count_params(cfg)} parameters")
            _fresh(torch)
            build.reset_launches()
            out = serve.run(args)
            launches[arch] = dict(out["prefill_launches"])
            _serving_report(torch, f"{arch} {cfg.num_layers} layers {b}x{lp}+{steps} dense", out,
                            "flash_attention", cfg.num_layers)
            if cfg.moe is not None:
                _fresh(torch)
                gen = torch.Generator(device=CARD).manual_seed(args.seed)
                params = T.init(gen, cfg, CARD)
                prompts = torch.randint(0, cfg.vocab_size, (b, lp), generator=gen,
                                        device=CARD)
                forms = {}
                for form in ("dense", "gather"):
                    build.reset_launches()
                    forms[form] = serve.generate(params, prompts, cfg, steps, moe_impl=form)
                gather = forms["gather"]
                gather["continuation"] = gather["tokens"][0][:16].tolist()
                gather["logits_finite"] = bool(torch.isfinite(gather["logits"]).all())
                _serving_report(torch, f"{arch} {cfg.num_layers} layers {b}x{lp}+{steps} gather",
                                gather, "flash_attention", cfg.num_layers)
                gap = float((forms["gather"]["logits"] - forms["dense"]["logits"]).abs().max())
                print(f"23c {arch}: gather against dense: max |logit gap| {gap:.3e}; dense's "
                      f"tokens are serve.run's: "
                      f"{forms['dense']['tokens'][0][:16].tolist() == out['continuation']}")
                _require(torch.equal(forms["gather"]["tokens"], forms["dense"]["tokens"]),
                         f"23c {arch}: gather's greedy tokens differ from dense's")
                torch.testing.assert_close(forms["gather"]["logits"], forms["dense"]["logits"],
                                           **SERVE_TOL)
                del params, forms
        _fresh(torch)
    return launches


def check_small_deepseek_job(torch, FederatedJob, TaskConfig, build) -> None:
    """Phase 23e: a reduced deepseek-v2 token job (stacked FedAvg, 2 sites,
    2 rounds) on the card and on the CPU, losses within ``JOB_RTOL``, MLA's
    prefill and gradient through the padded D 32 instances; then the
    full-width deepseek token job passes ``check_ported`` on the card from
    its config alone (the D 256 backward instance)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**SMALL_DEEPSEEK), rounds=2, device=CARD)
    build.reset_launches()
    gpu = job.run()
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    cpu = job.replace(device="cpu").run()
    print(f"small deepseek job: losses cuda {gpu.losses} cpu {cpu.losses}; launched {launched}")
    for g, c in zip(gpu.losses, cpu.losses):
        _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                 f"small deepseek job: cuda loss {g} != cpu loss {c}")
    steps = SMALL_DEEPSEEK["sites"] * 2
    for name in ("flash_attention", "flash_attention_bwd"):
        _require(launched.get(name, 0) == 2 * steps,
                 f"small deepseek job: {name} launched {launched.get(name, 0)} times, "
                 f"not {2 * steps}")
    wide = FederatedJob(task=TaskConfig(kind="tokens", arch="deepseek-v2-236b", reduced=False),
                        device="cuda")
    before = dict(build.LAUNCHES)
    wide.check_ported()
    _require(dict(build.LAUNCHES) == before, "23e: check_ported launched a kernel")
    print("23e: the full-width deepseek-v2 token job passes check_ported on the card")


def run_p23(torch, FederatedJob, TaskConfig, build) -> dict:
    """Phase 23 (a the kernel at the MLA shape; b, c the five configs at
    full width; d the reduced ones card vs CPU; e a small deepseek job);
    returns the mla entry and each path's launches."""
    entry = _timed("23a (flash_attention at DeepSeek-V2's MLA shape)",
                   check_flash_attention_mla, torch, torch.device(CARD))
    served = _timed("23a (flash_attention at the shapes of 23c's configs)",
                    check_flash_attention_served, torch, torch.device(CARD))
    deepseek = _timed("23b (deepseek-v2 2 layers: dense, gather, dispatch)",
                      run_deepseek_serving, torch, build)
    wide = _timed("23c (granite, musicgen, qwen3-moe, chameleon at full width)",
                  run_wide_serves, torch, build)
    _timed("23d (the reduced configs, card and CPU)", check_small_serving, torch, build,
           SMALL_ARCHS[5:])
    _timed("23e (a small deepseek-v2 job, card and CPU; check_ported)",
           check_small_deepseek_job, torch, FederatedJob, TaskConfig, build)
    return {"entry": dict(entry, launches=deepseek.get("flash_attention", 0),
                          served_shapes_max_abs_err=served),
            "launches": {"deepseek-v2-236b": deepseek, **wide}}


# -- the precision policy and the step builders (phase 24) -----------------------

# published dense bf16 tensor-core peaks (NVIDIA data sheets), by the name
BF16_PEAKS = {"H100 80GB HBM3": 989e12, "H100 PCIe": 756e12, "H100 NVL": 835e12,
              "H200": 989e12}
# 24a: (what, (batch, q heads, kv heads, Lq, Lk, D), window, MLA's true q/k and v
# head dims or None): row 7b's shape (smollm-135m), gemma3-1b's training shape
# global and with its window, DeepSeek-V2's MLA at q/k 192, v 128 (the bf16
# kernels' own instance, unpadded; D is the width the fp32 instance pads to)
MLA_TRAIN = (2, 128, 128, 512, 512, 256)
BF16_BWD_SHAPES = (("smollm-135m", SMOLLM_ATTN, None, None),
                   ("gemma3-1b", GEMMA_TRAIN, None, None),
                   ("gemma3-1b window 512", GEMMA_TRAIN, 512, None),
                   ("deepseek-v2 mla", MLA_TRAIN, None, (192, 128)))
# the forward's shapes in 24a: gemma3-1b's and smollm-135m's prefill, and
# DeepSeek-V2's MLA prefill ([2, 128, 512], q/k 192, v 128) unpadded
BF16_FWD_SHAPES = (("gemma3-1b prefill", GEMMA_ATTN, None),
                   ("smollm-135m", SMOLLM_ATTN, None),
                   ("deepseek-v2 mla", (MLA_ATTN[0], MLA_ATTN[1], MLA_ATTN[1], MLA_ATTN[2],
                                        MLA_ATTN[2], 256), (192, 128)))
# the times of bf16 attention in its earlier design (the fp32 kernels' 3xTF32
# products on mma.sync over tiles converted as staged; NVIDIA H100
# 80GB HBM3, 700 W; PERF.md rows 7 and 7b), printed beside this run's and kept
# out of the kernels line, which carries only what this run measured
TF32_DESIGN_BWD_MS = {"smollm-135m": 1.6191, "gemma3-1b": 0.6863, "gemma3-1b window 512": 0.5491,
                      "deepseek-v2 mla": 6.6223}
TF32_DESIGN_FWD_MS = {"gemma3-1b prefill": 0.0982, "smollm-135m": 0.2221}
# the bf16 backward against its plain version on the same bf16 inputs, out and
# lse: the same fp32 arithmetic in another order, then one bf16 rounding of
# each gradient: within one bf16 ulp of the largest value (2^-7 of it, of 1
# at least: see _top_ulps)
BF16_BWD_ULPS = 1.0
# 24b: (arch, config module, depth or None for the published one); the
# prefill is 1 x 32768 tokens, the decode 1 sequence against a 32768-slot
# cache (4 greedy steps after a prefill of DECODE_PROMPT), long_500k 1
# sequence against a 524288-slot cache at its last 4 slots (zero contents:
# its prefill alone would take minutes); the fp32 comparison 2 x 256 tokens
# + 2 steps
SERVE_CUTS = (("smollm-135m", "smollm_135m", None), ("gemma3-1b", "gemma3_1b", None),
              ("qwen3-8b", "qwen3_8b", None), ("rwkv6-7b", "rwkv6_7b", None),
              ("granite-3-2b", "granite_3_2b", None), ("musicgen-medium", "musicgen_medium", None),
              ("qwen3-moe-30b-a3b", "qwen3_moe_30b_a3b", 8), ("chameleon-34b", "chameleon_34b", 8),
              ("deepseek-v2-236b", "deepseek_v2_236b", 2),
              ("jamba-1.5-large-398b", "jamba_1p5_large_398b", 2))
SERVE_BATCH, DECODE_STEPS, CHECK_PROMPT = 1, 4, 256
# decode_32k's prefill: 30720 tokens, a multiple of the MoE dispatch's
# 2048-token groups (a ragged count is one group of all the tokens, whose
# [G, S, E, C] one-hots take 20 GB at qwen3-moe's width), then the greedy
# steps from slot 30720 of the 32768
DECODE_PROMPT = 30720
# bf16 logits against the fp32 serve of the same bf16-valued weights: max
# |difference| over the largest |fp32 logit|, per step.  rwkv6-7b's
# recurrence and per-head group norm amplify bf16 rounding with depth in the
# reference too (its own bf16 against fp32 on the reduced config at 64
# tokens: 0.011 of the largest logit at 2 layers, 0.037 at 8; the
# attention models stay near 0.01; a CPU run of the JAX package), so its
# comparison takes the first COMPARE_LAYERS of the same weights
BF16_LOGIT_RTOL = 2.0 ** -4
COMPARE_LAYERS = {"rwkv6-7b": 2}
# top-k routing over 128 or 160 experts (qwen3-moe, DeepSeek-V2): a token
# whose router scores near-tie picks another expert in bf16 than in fp32, a
# whole expert's output apart (the reference's own bf16 against fp32 on the
# reduced configs, 4 experts: 0.027 of the largest logit at 2 layers, 0.039
# at 8, against 0.01 for the dense models; a CPU run of the JAX package; on
# the card, ``gather`` at full width: 0.148 and 0.161, Jamba's 16 experts
# 0.013).  Their gate is 2^-2; the greedy tokens' check is the same
MANY_EXPERTS, MOE_LOGIT_RTOL = 64, 2.0 ** -2
# 24c: (arch, config module, depth or None, sites, microbatch): train_4k's
# 4096 tokens a sequence, 2 microbatches a site step, 1 round (smollm 2)
# step_s of the two configs whose steps that design's backward held most
# (PERF.md section 5)
TF32_DESIGN_STEP_S = {"smollm-135m": 3.45, "musicgen-medium": 13.3}
TRAIN_CUTS = (("smollm-135m", "smollm_135m", None, 2, 8),
              ("gemma3-1b", "gemma3_1b", None, 2, 2),
              ("rwkv6-7b", "rwkv6_7b", 2, 2, 4),
              ("jamba-1.5-large-398b", "jamba_1p5_large_398b", 1, 1, 2),
              ("qwen3-8b", "qwen3_8b", 2, 1, 2),
              ("deepseek-v2-236b", "deepseek_v2_236b", 1, 1, 4),
              ("qwen3-moe-30b-a3b", "qwen3_moe_30b_a3b", 1, 1, 2),
              ("granite-3-2b", "granite_3_2b", 20, 1, 4),
              ("chameleon-34b", "chameleon_34b", 1, 1, 4),
              ("musicgen-medium", "musicgen_medium", None, 2, 8))


def _bf16_rate(torch) -> float:
    name = torch.cuda.get_device_name(0)
    for key, val in BF16_PEAKS.items():
        if key in name:
            return val
    raise SystemExit(f"chip_smoke: no published bf16 peak for {name!r}")


def _top_ulps(torch, got, want) -> float:
    """max |got - want| in bf16 ulps (2^-7) of the largest |want|, or of 1
    where that is smaller (unit-scale inputs: one query against one key
    gives dq = dk = 0 in exact arithmetic and rounding noise in each)."""
    top = max(float(want.float().abs().max()), 1.0) if want.numel() else 1.0
    return float((got.float() - want.float()).abs().max()) / (2.0 ** -7 * top) \
        if want.numel() else 0.0


def _bf16_inputs(torch, dev, shape, heads, gen):
    """bf16 q, k and v of ``shape``; with MLA's true head dims ``heads``
    (q/k, v), drawn at those widths, unpadded, as the model's bf16 route
    passes them."""
    b, hq, hkv, lq, lk, d = shape
    if heads is None:
        return _flash_inputs(torch, dev, shape, torch.bfloat16, gen)
    dqk, dv = heads
    return (torch.randn(b, hq, lq, dqk, device=dev, generator=gen).bfloat16(),
            torch.randn(b, hkv, lk, dqk, device=dev, generator=gen).bfloat16(),
            torch.randn(b, hkv, lk, dv, device=dev, generator=gen).bfloat16())


def _bf16_attn_resources(build) -> None:
    """Phase 24a: the bf16 attention kernels' resources at each instance
    (registers, local and shared bytes, blocks an SM: their ``*_resources``
    entries) and the HGMMA (``wgmma``) instructions in the SASS of each of
    their ``__global__`` functions; fails where a product kernel has
    none."""
    import ctypes
    import re
    from repro_torch.kernels import flash_attention as fa
    out = (ctypes.c_int * 7)()
    fwd = build.entry(fa.BF16_NAME, "flash_attention_bf16_resources",
                      [ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)])
    bwd = build.entry(fa.BF16_BWD_NAME, "flash_attention_bwd_bf16_resources",
                      [ctypes.c_int64] * 3 + [ctypes.POINTER(ctypes.c_int)])
    for dqk, dv in fa.BF16_INSTANCES:
        for what, call in ((f"flash_attention_bf16 ({dqk}, {dv})", lambda: fwd(dqk, dv, out)),
                           (f"flash_attention_bwd_bf16 dK/dV ({dqk}, {dv})",
                            lambda: bwd(dqk, dv, 0, out)),
                           (f"flash_attention_bwd_bf16 dQ ({dqk}, {dv})",
                            lambda: bwd(dqk, dv, 1, out))):
            err = call()
            _require(err == 0, f"{what} resources: CUDA error {err}")
            print(f"{what}: {out[0]} registers, local {out[1]} B, shared {out[2]} B, "
                  f"{out[3]} threads, {out[4]} blocks an SM")
    for name in (fa.BF16_NAME, fa.BF16_BWD_NAME):
        for func, ops in sorted(_sass_ops(build, name).items()):
            n = sum(o.startswith("HGMMA") for o in ops)
            print(f"{name}: {n} HGMMA in {func}")
            if re.search(r"_(?:bf16|dkdv|dq)_kernel", func):
                _require(n > 0, f"{name}: no HGMMA in {func}")


def check_flash_attention_bwd_bf16(torch, build, dev) -> dict:
    """Phase 24a: the bf16 kernels (``flash_attention_bf16.cu``,
    ``flash_attention_bwd_bf16.cu``, on ``wgmma``): their resources and
    HGMMA counts; the forward's lse against ``flash_attention_lse_ref``
    within ``FLASH_TOL`` and its output bit-equal to the serving call's, and
    the backward against its plain version on the same bf16 inputs, output
    and lse, at the ragged ``BWD_CASES`` and at
    ``BF16_BWD_SHAPES`` (MLA at its own q/k 192 and v 128, unpadded), within
    ``BF16_BWD_ULPS`` bf16 ulps of the largest value, two launches
    bit-equal; at each shape its time beside its bound (the bf16 tensors'
    bytes, the five products of 2 D flops a seen pair at the true head dims
    at the bf16 tensor-core rate), the plain backward's, the fp32
    instance's on the same values (MLA padded to 256, the fp32 route),
    SDPA's bf16 backward alone (eager), and the 3xTF32 design's recorded time
    printed beside; then the bf16 forward at ``BF16_FWD_SHAPES`` within
    ``BF16_TOL`` of its plain version, beside its bound and SDPA's bf16
    forward (the recorded time printed beside).  Returns the
    kernels-line entries of ``flash_attention_bwd_bf16`` and
    ``flash_attention_bf16`` (smollm's shape; the others under
    ``shapes``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    _bf16_attn_resources(build)
    gen = torch.Generator(device=dev).manual_seed(24)
    worst, lse_err = 0.0, 0.0

    def hold_lse(q, k, v, causal, window, sc, what):
        """The forward's out and lse: lse within ``FLASH_TOL`` of
        ``flash_attention_lse_ref``, out bit-equal to the serving call's."""
        out, lse = fa.flash_attention_cuda(q, k, v, causal, window, with_lse=True, scale=sc)
        plain_out = fa.flash_attention_cuda(q, k, v, causal, window, scale=sc)
        want_lse = ref.flash_attention_lse_ref(q, k, v, causal, window, sc)[1]
        torch.cuda.synchronize()
        _require(torch.equal(out, plain_out), f"flash_attention bf16 {what}: out with lse differs")
        torch.testing.assert_close(lse, want_lse, **FLASH_TOL)
        return out, lse, float((lse - want_lse).abs().max())

    for case in BWD_CASES:
        causal, window = case[6:]
        q, k, v = _flash_inputs(torch, dev, case, torch.bfloat16, gen)
        g = torch.randn(q.shape, device=dev, generator=gen).bfloat16()
        out, lse, e = hold_lse(q, k, v, causal, window, None, case)
        lse_err = max(lse_err, e)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal, window)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal, window)
        torch.cuda.synchronize()
        _require(all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(got, again)),
                 f"flash_attention_bwd bf16 {case}: two launches differ")
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal, window)
        for n, a, w in zip("qkv", got, want):
            u = _top_ulps(torch, a, w)
            _require(u <= BF16_BWD_ULPS, f"flash_attention_bwd bf16 {case} d{n}: {u:.3f} ulps")
            worst = max(worst, u)
    print(f"flash_attention_bwd bf16: {len(BWD_CASES)} ragged shapes agree with the plain "
          f"version within {BF16_BWD_ULPS} bf16 ulp of the largest value (max {worst:.3f}); "
          f"two launches bit-equal at each")
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    bf16_rate = _bf16_rate(torch)
    shapes = {}
    for what, shape, window, heads in BF16_BWD_SHAPES:
        b, hq, hkv, lq, lk, d = shape
        q, k, v = _bf16_inputs(torch, dev, shape, heads, gen)
        sc = None if heads is None else heads[0] ** -0.5   # MLA's: its q/k head dim's
        out, lse, e = hold_lse(q, k, v, True, window, sc, what)
        lse_err = max(lse_err, e)
        g = torch.randn(out.shape, device=dev, generator=gen).bfloat16()
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, True, window, sc)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, True, window, sc)
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"flash_attention_bwd bf16 {what}: two launches differ")
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, True, window, sc)
        ulps = max(_top_ulps(torch, a, w) for a, w in zip(got, want))
        _require(ulps <= BF16_BWD_ULPS, f"flash_attention_bwd bf16 {what}: {ulps:.3f} ulps")
        mask = _attn_mask(torch, dev, lq, lk, True, window)
        pairs = int(mask.sum()) * b * hq
        dqk, dv = heads or (d, d)
        # the true work: s and dq, dk over q/k's columns, dp and dv over v's
        flops = 2 * pairs * (3 * dqk + 2 * dv)
        nbytes = 2 * (b * hq * lq * (2 * dqk + 2 * dv) + b * hkv * lk * 2 * (dqk + dv)) \
            + 4 * b * hq * lq
        ops_ms = 1e3 * flops / bf16_rate
        # SDPA's bf16 backward (eager: it runs on its forward's stream, outside
        # a capture)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        kw = dict(attn_mask=mask) if window else dict(is_causal=True)
        lib_out = F.scaled_dot_product_attention(*leaves, enable_gqa=True, scale=sc, **kw)

        def library():
            return torch.autograd.grad(lib_out, leaves, g, retain_graph=True)
        # the fp32 instance on the same values, through the fp32 route (MLA
        # padded to D with zero columns)
        pad = (lambda t: t) if heads is None else (lambda t: F.pad(t, (0, d - t.shape[-1])))
        q32, k32, v32, g32 = (pad(t.float()).contiguous() for t in (q, k, v, g))
        o32, l32 = fa.flash_attention_cuda(q32, k32, v32, True, window, with_lse=True, scale=sc)
        timing = measure(
            torch, f"flash_attention_bwd {what} {list(shape[:5]) + [dqk, dv]} bf16 causal "
                   f"window={window}",
            lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, True, window, sc),
            lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, g, True, window, sc), None,
            nbytes=nbytes, flops=flops, ops_ms=ops_ms)
        fp32_ms = time_ms(lambda: fa.flash_attention_bwd_cuda(q32, k32, v32, o32, l32, g32, True,
                                                              window, sc))[0]
        for _ in range(3):
            library()
        timing["library_ms"] = _median_ms(library, 25)
        timing.update(max_abs_err=max(float((a.float() - w.float()).abs().max())
                                      for a, w in zip(got, want)),
                      max_err_bf16_ulps=ulps, fp32_instance_ms=fp32_ms,
                      lse_max_abs_err=e, bound_bytes_ms=1e3 * nbytes / mem_rate)
        print(f"flash_attention_bwd {what} bf16: {ulps:.3f} bf16 ulps of the largest value; "
              f"{timing['ms']:.4f} ms (the 3xTF32 design: {TF32_DESIGN_BWD_MS[what]:.4f} ms; "
              f"the fp32 instance on "
              f"the same values {fp32_ms:.4f} ms), bound {timing['bound_ms']:.4f} ms "
              f"({timing['bound_by']}: {flops / 1e9:.2f} GFLOP at {bf16_rate / 1e12:.0f} TFLOP/s "
              f"bf16), {flops / timing['ms'] / 1e9:.1f} TFLOP/s; SDPA's bf16 backward alone "
              f"(eager) {timing['library_ms']:.4f} ms against the kernel's eager "
              f"{timing['eager_ms']:.4f} ms")
        shapes[what] = timing
        del q, k, v, g, out, lse, got, again, want, leaves, lib_out, q32, k32, v32, o32, l32, g32
        gc.collect()
        torch.cuda.empty_cache()
    print(f"flash_attention bf16: lse of {len(BWD_CASES) + len(BF16_BWD_SHAPES)} shapes within "
          f"rtol=atol=1e-5 of the plain version (max |err| {lse_err:.3e}); out bit-equal with "
          f"and without lse")
    forward = {}
    for what, shape, heads in BF16_FWD_SHAPES:
        b, hq, hkv, lq, lk, d = shape
        q, k, v = _bf16_inputs(torch, dev, shape, heads, gen)
        dqk, dv = heads or (d, d)
        sc = None if heads is None else dqk ** -0.5
        pairs = int(_attn_mask(torch, dev, lq, lk, True, None).sum()) * b * hq
        got = fa.flash_attention_cuda(q, k, v, True, None, scale=sc)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, True, None, sc)
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
        flops = 2 * pairs * (dqk + dv)
        forward[what] = measure(
            torch, f"flash_attention {what} {list(shape[:5]) + [dqk, dv]} bf16 causal",
            lambda: fa.flash_attention_cuda(q, k, v, True, None, scale=sc),
            lambda: ref.flash_attention_ref(q, k, v, True, None, sc),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True,
                                                   scale=sc),
            nbytes=2 * (b * hq * lq * (dqk + dv) + b * hkv * lk * (dqk + dv)), flops=flops,
            ops_ms=1e3 * flops / bf16_rate)
        forward[what]["max_abs_err"] = float((got.float() - want.float()).abs().max())
        print(f"flash_attention {what} bf16: {forward[what]['ms']:.4f} ms (the 3xTF32 design: "
              f"{TF32_DESIGN_FWD_MS.get(what, 'padded to 256, not timed')}), "
              f"{flops / forward[what]['ms'] / 1e9:.1f} TFLOP/s; SDPA's bf16 forward "
              f"{forward[what]['library_ms']:.4f} ms; max |err| {forward[what]['max_abs_err']:.3e} "
              f"(gate rtol=atol=2e-2)")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    rest = lambda d: {k: v for k, v in d.items() if k != "smollm-135m"}
    return {"bwd": {**shapes["smollm-135m"], "shapes": rest(shapes)},
            "fwd": {**forward["smollm-135m"], "shapes": rest(forward)}}


def _set_index(tree, n: int) -> None:
    """Every cache ``index`` of ``tree`` to ``n`` (in place)."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            if key == "index":
                val.fill_(n)
            else:
                _set_index(val, n)
    elif isinstance(tree, (list, tuple)):
        for val in tree:
            _set_index(val, n)


def _greedy(torch, step_fn, params, tokens, caches, steps: int):
    """``steps`` greedy decode steps from ``tokens``: (the last logits,
    the seconds of the steps, the caches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, caches = step_fn(params, tokens, caches)
        tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0, caches


def _to_fp32_in_place(tree) -> None:
    """Replace every leaf of a dict/list tree by its fp32 copy, one leaf at
    a time, so that the bf16 and fp32 copies never sit on the card whole."""
    for key in (range(len(tree)) if isinstance(tree, list) else list(tree)):
        val = tree[key]
        if isinstance(val, (dict, list)):
            _to_fp32_in_place(val)
        else:
            tree[key] = val.float()


def _bf16_vs_fp32(torch, cfg, params, gen):
    """Prefill 2 x ``CHECK_PROMPT`` tokens and 2 greedy steps with the bf16
    weights, then with the same values in fp32 (``params`` converted in
    place, leaf by leaf): the largest per-step max |difference| over the
    largest |fp32 logit|, and whether the greedy tokens agree wherever the
    fp32 margin exceeds twice the difference.  The MoE runs its ``gather``
    form: ``dispatch``'s capacity drops cascade from one flipped (token,
    expert) pair to the slots of the tokens after it."""
    from repro_torch.models import transformer as T
    shape = (2, CHECK_PROMPT) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=CARD)

    def run(p, toks=None):
        with torch.no_grad():
            logits, caches = T.prefill(p, prompts, cfg, cache_capacity=CHECK_PROMPT + 2,
                                       moe_impl="gather")
            out, chosen = [logits], []
            for i in range(2):
                t = (torch.argmax(logits[:, -1:], dim=-1).to(torch.int32) if toks is None
                     else toks[i])
                chosen.append(t)
                logits, caches = T.decode_step(p, t, caches, cfg, moe_impl="gather")
                out.append(logits)
        return out, chosen

    l16, toks = run(params)
    _to_fp32_in_place(params)
    l32, _ = run(params, toks)
    rel, agree = 0.0, True
    for a, b in zip(l16, l32):
        a, b = a[..., :cfg.vocab_size], b[..., :cfg.vocab_size]     # not the -1e30 padding
        dev_ = float((a - b).abs().max())
        rel = max(rel, dev_ / float(b.abs().max()))
        top2 = torch.topk(b[:, -1], 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * dev_
        agree &= bool((a[:, -1].argmax(-1) == b[:, -1].argmax(-1))[clear].all())
    return rel, agree


def run_bf16_serving(torch, build) -> dict:
    """Phase 24b: every token architecture at its published width in its
    serving policy (bf16 weights from seed 0, a bf16 cache), through
    ``steps.build_serve``, with ``SERVE_CUTS``' depths: prefill_32k (1 x
    32768 tokens: prefill seconds, finite logits, each attention layer
    launching ``flash_attention_bf16`` once), decode_32k (4 greedy steps in a
    32768-slot cache after a prefill of ``DECODE_PROMPT``: tok/s, no kernel
    launched) and long_500k where ``is_skipped`` allows it; the peak; then
    the bf16 logits held to the fp32 serve of the same bf16-valued weights
    (``BF16_LOGIT_RTOL``), greedy tokens equal where the margin is clear.
    Returns each config's numbers and the prefills' launches."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_arch, is_skipped
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out, launches = {}, {}
    for arch, module, layers in SERVE_CUTS:
        cut = _CutDepth(module, layers) if layers else contextlib.nullcontext()
        with cut:
            cfg = get_arch(arch).CONFIG
            _fresh(torch)
            pre = steps.build_serve(arch, "prefill_32k", cfg=cfg)
            seq = INPUT_SHAPES["prefill_32k"].seq_len
            params, tokens = pre.make_inputs(seed=0, batch=SERVE_BATCH)
            print(f"24b {arch}: {cfg.num_layers} layers, bf16, prefill {SERVE_BATCH} x {seq} "
                  f"(cut from {pre.abstract_inputs[1].shape[0]}), decode {SERVE_BATCH} "
                  f"(cut from {INPUT_SHAPES['decode_32k'].global_batch}), "
                  f"{pre.precision}")
            build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, caches = pre.step_fn(params, tokens)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            _require(bool(torch.isfinite(logits).all()), f"24b {arch}: non-finite prefill logits")
            mixers = [s.mixer for s in cfg.layer_specs()]
            expect = {"flash_attention_bf16": mixers.count("attn") + mixers.count("mla"),
                      "rwkv6_scan": mixers.count("rwkv6"), "mamba_scan": mixers.count("mamba")}
            _expect_launches(f"24b {arch} prefill", launched, {k: v for k, v in expect.items()
                                                               if v})
            launches[arch] = launched
            del logits, caches
            rec = {"layers": cfg.num_layers, "prefill_s": prefill_s,
                   "prefill_tok_s": SERVE_BATCH * seq / prefill_s}
            for shape_name in ("decode_32k", "long_500k"):
                if is_skipped(module, shape_name):
                    continue
                dec = steps.build_serve(arch, shape_name, cfg=cfg)
                cap = INPUT_SHAPES[shape_name].seq_len
                toks = tokens[:, :1]
                with torch.no_grad():
                    if shape_name == "decode_32k":
                        _, _, caches = dec.make_inputs(seed=1, batch=SERVE_BATCH,
                                                       prompt_len=DECODE_PROMPT)
                    else:
                        caches = T.init_caches(SERVE_BATCH, cap, cfg, dtype=torch.bfloat16,
                                               device=CARD)
                        _set_index(caches, cap - DECODE_STEPS)
                    build.reset_launches()
                    logits, secs, caches = _greedy(torch, dec.step_fn, params, toks, caches,
                                                   DECODE_STEPS)
                _require(bool(torch.isfinite(logits).all()),
                         f"24b {arch} {shape_name}: non-finite logits")
                _require(not any(build.LAUNCHES.get(k, 0) for k in TOKEN_KERNELS),
                         f"24b {arch} {shape_name}: decode launched a kernel")
                rec[shape_name] = {"tok_s": SERVE_BATCH * DECODE_STEPS / secs,
                                   "step_s": secs / DECODE_STEPS}
                del caches, logits
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            gc.collect()
            torch.cuda.empty_cache()
            ccfg, cparams = cfg, params
            if arch in COMPARE_LAYERS:        # a periodic group of one layer: its first n
                n = COMPARE_LAYERS[arch]
                ccfg = dataclasses.replace(cfg, num_layers=n)
                _require(T.plan_groups(cfg)[0] == () and T.plan_groups(cfg)[1].period == 1,
                         f"24b {arch}: not one periodic group of one layer")
                cparams = {**params, "scan_layers": [
                    {k: tree_map(lambda t: t[:n], v) for k, v in p.items()}
                    for p in params["scan_layers"]]}
            rel, agree = _bf16_vs_fp32(torch, ccfg, cparams,
                                       torch.Generator(device=CARD).manual_seed(2))
            del cparams
            gate = (MOE_LOGIT_RTOL if cfg.moe is not None and cfg.moe.num_experts >= MANY_EXPERTS
                    else BF16_LOGIT_RTOL)
            _require(rel <= gate, f"24b {arch}: bf16 logits {rel:.3e} of the fp32 serve's "
                                  f"largest, gate {gate}")
            _require(agree, f"24b {arch}: greedy tokens differ where the margin is clear")
            rec["bf16_vs_fp32_rel"] = rel
            print(f"24b {arch}: prefill {rec['prefill_s']:.3f} s "
                  f"({rec['prefill_tok_s']:.0f} tok/s), decode "
                  f"{ {k: round(v['tok_s'], 2) for k, v in rec.items() if isinstance(v, dict)} } "
                  f"tok/s, peak {rec['peak_gib']:.2f} GiB; bf16 logits within "
                  f"{rel:.3e} of the fp32 serve's largest (gate {gate:.4f}; "
                  f"{ccfg.num_layers} layers); greedy tokens agree where the margin is clear")
            out[arch] = rec
            del params, tokens
            _fresh(torch)
    return {"serve": out, "launches": launches}


def run_bf16_training(torch, build) -> dict:
    """Phase 24c: every token architecture at its published width trained
    in its own policy (``precision_for(train_4k)``: ``mixed``, or
    ``bf16_train`` for DeepSeek-V2 and Jamba) through ``steps.build_train``
    (AdamW 1e-4, remat, clip 1.0, MoE ``dispatch``), with ``TRAIN_CUTS``'
    depth, sites and microbatch: sequences of 4096 tokens, 2 microbatches a
    site step, 1 round (smollm-135m 2), random weights from seed 0; the
    losses and every parameter finite, the bf16 attention backward
    (``flash_attention_bwd_bf16``) launched once a layer a microbatch a
    site; ``step_s`` (the 3xTF32 design's beside smollm-135m's and
    musicgen-medium's)
    and the peak.  Returns each config's numbers and the launches."""
    from repro_torch.configs.base import INPUT_SHAPES, MeshConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out, launches = {}, {}
    seq = INPUT_SHAPES["train_4k"].seq_len
    for arch, module, layers, sites, micro in TRAIN_CUTS:
        cut = _CutDepth(module, layers) if layers else contextlib.nullcontext()
        with cut:
            cfg = get_arch(arch).CONFIG
            _fresh(torch)
            art = steps.build_train(arch, cfg=cfg, override_mesh=MeshConfig(sites_per_pod=sites),
                                    microbatch=micro)
            state, batches, ri = art.make_inputs(seed=0, per_site_batch=2 * micro)
            full = get_arch(arch).mesh_for(INPUT_SHAPES["train_4k"]).total_sites
            print(f"24c {arch}: {cfg.num_layers} layers, {art.precision}, {sites} sites (cut "
                  f"from {full}), {2 * micro} x {seq} tokens a site (cut from "
                  f"{INPUT_SHAPES['train_4k'].global_batch // full}), microbatch {micro} "
                  f"(table: {steps.TRAIN_MICROBATCH[cfg.name]}), params "
                  f"{state['params'].dtype} [{state['params'].shape[0]}, "
                  f"{state['params'].shape[1]}], moments {state['opt']['mu'].dtype}")
            rounds = 2 if arch == "smollm-135m" else 1
            attn = sum(s.mixer in ("attn", "mla") for s in cfg.layer_specs())
            build.reset_launches()
            step_s = []
            for _ in range(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = art.step_fn(state, batches, ri)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                _require(math.isfinite(float(metrics["loss"])),
                         f"24c {arch}: loss {float(metrics['loss'])}")
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            want = attn * 2 * sites * rounds
            _require(launched.get("flash_attention_bwd_bf16", 0) == want,
                     f"24c {arch}: flash_attention_bwd_bf16 launched {launched}, not {want}")
            _require(bool(torch.isfinite(state["params"]).all()),
                     f"24c {arch}: non-finite parameters")
            peak = torch.cuda.max_memory_allocated() / 2**30
            was = (f" (the 3xTF32 design: about {TF32_DESIGN_STEP_S[arch]} s)"
                   if arch in TF32_DESIGN_STEP_S else "")
            print(f"24c {arch}: loss {float(metrics['loss']):.4f}, step_s "
                  f"{[round(s, 3) for s in step_s]}{was}, peak {peak:.2f} GiB; launched "
                  f"{launched}")
            out[arch] = {"layers": cfg.num_layers, "sites": sites, "microbatch": micro,
                         "step_s": step_s, "peak_gib": peak, "loss": float(metrics["loss"]),
                         "tokens_per_step": sites * 2 * micro * seq}
            launches[arch] = launched
            del state, batches, art
            _fresh(torch)
    return {"train": out, "launches": launches}


def check_small_mixed_job(torch, build) -> None:
    """Phase 24d: a reduced smollm-135m round in the ``mixed`` policy (2
    sites, 2 microbatches of 2 x 32 tokens) through ``steps.build_train``
    on the card and on the CPU from the same bf16 weights and tokens: the
    losses within rtol 2^-6 (bf16 products rounded in other orders), every
    parameter within one bf16 ulp of the largest (2^-7 of it)."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = get_arch("smollm-135m").reduced()
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 4, 32),
                           generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    got = {}
    for dev in (CARD, "cpu"):
        art = steps.build_train("smollm-135m", cfg=cfg, override_mesh=MeshConfig(sites_per_pod=2),
                                microbatch=2, device=dev)
        state, _, ri = art.make_inputs(params=tree_map(lambda t: t.to(dev), params))
        build.reset_launches()
        state, metrics = art.step_fn(state, {"tokens": tokens.to(dev)}, ri)
        if dev == CARD:
            _require(build.LAUNCHES.get("flash_attention_bwd_bf16", 0) == cfg.num_layers * 4,
                     f"24d: flash_attention_bwd_bf16 launched "
                     f"{build.LAUNCHES.get('flash_attention_bwd_bf16')}")
        got[dev] = (float(metrics["loss"]), state["params"].float().cpu())
    (lc, pc), (lh, ph) = got[CARD], got["cpu"]
    perr = float((pc - ph).abs().max()) / (2.0 ** -7 * float(ph.abs().max()))
    print(f"24d: a reduced mixed round card vs CPU: loss {lc:.6f} / {lh:.6f}, parameters "
          f"within {perr:.3f} bf16 ulps of the largest")
    _require(math.isclose(lc, lh, rel_tol=2.0 ** -6), f"24d: loss {lc} != {lh}")
    _require(perr <= 1.0, f"24d: parameters {perr:.3f} ulps apart")


def run_p24(torch, build) -> dict:
    """Phase 24 (a the bf16 kernels alone; b bf16 serving; c mixed and
    bf16_train training; d a small mixed round card vs CPU); returns the
    bf16 kernels' kernels-line entries and each path's launches."""
    entry = _timed("24a (the bf16 attention kernels alone, forward and backward)",
                   check_flash_attention_bwd_bf16, torch, build, torch.device(CARD))
    serve = _timed("24b (every token architecture served in bf16 at published width)",
                   run_bf16_serving, torch, build)
    train = _timed("24c (every token architecture trained in its policy, microbatches, remat)",
                   run_bf16_training, torch, build)
    _timed("24d (a small mixed round, card and CPU)", check_small_mixed_job, torch, build)
    return {"entry": entry, "serve": serve, "train": train}


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api import FederatedJob, TaskConfig
    from repro_torch.configs.sanet_openkbp import (BRATS_TASK, OPENKBP_TASK, PANSEG_TASK,
                                                SANET, SANET_SEG)
    from repro_torch.data.partition import BRATS_SITE_CASES
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.core.round_engine import ChunkPlan
    from repro_torch.core.stacking import broadcast_to_sites
    from repro_torch.kernels import build, fedagg, ops, ref
    from repro_torch.models.sanet import sanet_init

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build(list(ops.KERNELS))
    print(f"built {sorted(ops.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    kernel_resources(build)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    layout = get_engine().layout_of(broadcast_to_sites(
        sanet_init(torch.Generator().manual_seed(0), SANET), 1))
    plan = ChunkPlan.of(layout, 1024, 128, dev)
    seg_plan = ChunkPlan.of(get_engine().layout_of(broadcast_to_sites(
        sanet_init(torch.Generator().manual_seed(0), SANET_SEG), 1)), 1024, 128, dev)
    print(f"full-width chunk groups (width, rows per site): OpenKBP "
          f"{[(w, rows) for w, rows, _ in plan.groups]}, BraTS "
          f"{[(w, rows) for w, rows, _ in seg_plan.groups]}")
    entries = {"fedagg": check_fedagg(torch, fedagg, ref, dev),
               **check_int8_kernels(torch, plan, layout, dev, seg_plan),
               "trimmed_mean": check_trimmed_mean(torch, dev),
               "flash_attention": check_flash_attention(torch, dev),
               "rwkv6_scan": check_rwkv6_scan(torch, dev),
               "mamba_scan": check_mamba_scan(torch, dev)}

    main_launches, main_result = run_main_path(torch, FederatedJob, TaskConfig, build,
                                               OPENKBP_TASK)
    int8_launches, int8_result = run_int8_path(torch, FederatedJob, TaskConfig, build,
                                               OPENKBP_TASK)
    int8_comm = int8_result.comm
    check_codec(torch, build, int8_result.global_params)
    socket_launches = run_socket_path(torch, FederatedJob, TaskConfig, build, OPENKBP_TASK,
                                      int8_result)
    check_small_jobs(torch, FederatedJob, TaskConfig)
    check_small_tcp_jobs(torch, FederatedJob, TaskConfig)
    robust_launches = run_robust_path(torch, FederatedJob, TaskConfig, build, OPENKBP_TASK)
    check_robust_small_jobs(torch, FederatedJob, TaskConfig, build)
    del int8_result
    jobs = (torch, FederatedJob, TaskConfig)
    _timed("11 (dose pooled, individual)", run_dose_strategies, *jobs, build, OPENKBP_TASK)
    fedprox_comm = _timed("12 (brats fedavg, fedprox, + int8, + trimmed:1)",
                          run_seg_strategies, *jobs, build, BRATS_TASK,
                          tuple(BRATS_SITE_CASES[:BRATS_TASK["sites"]]))
    gossip = _timed("13 (panseg gcml)", run_gossip, *jobs, build, PANSEG_TASK)
    _timed("14 (small strategy jobs, card and CPU)", check_small_strategy_jobs, *jobs)
    p15 = _timed("15 (serverless and private sockets: gcml, fedprox, secure_agg)",
                 run_serverless_private, *jobs, build,
                 (PANSEG_TASK, BRATS_TASK, OPENKBP_TASK), gossip, fedprox_comm,
                 tuple(BRATS_SITE_CASES[:BRATS_TASK["sites"]]))
    _timed("15 (small tcp jobs: gcml, fedprox, secure_agg)", check_small_socket_seams, *jobs,
           build)
    del gossip
    host_batch_s = [h["batch_s"] for h in main_result.history]
    p16 = _timed("16 (two-tier pods and buffered rounds)", run_pods_and_buffered, *jobs,
                 build, OPENKBP_TASK, main_result, int8_comm)
    del main_result
    p17 = _timed("17 (fp8 and top-k codecs)", run_codecs, *jobs, build, OPENKBP_TASK)
    p18 = _timed("18 (checkpoint and resume, DP-SGD, the noise attack)", run_resume_and_dp,
                 *jobs, build, OPENKBP_TASK)
    p19 = _timed("19 (device_data, the sharded simulator, the CLI)", run_p19, *jobs, build,
                 (OPENKBP_TASK, BRATS_TASK), host_batch_s)
    serving_launches = run_serving_paths(torch, build)
    check_small_serving(torch, build)
    p20 = _timed("20 (the token task: the attention backward, smollm-135m fedavg, small "
                 "token jobs)", run_p20, *jobs, build)
    entries["flash_attention_bwd"] = p20["entry"]
    p21 = _timed("21 (the scans' gradients: the two backward kernels, rwkv6-7b fedavg, a "
                 "jamba site step, small jobs and C9)", run_p21, *jobs, build)
    entries["rwkv6_scan_bwd"] = p21["rwkv6_scan_bwd"]
    entries["mamba_scan_bwd"] = p21["mamba_scan_bwd"]
    p22 = _timed("22 (gemma3-1b training: the attention backward at head dim 256, gemma3-1b "
                 "fedavg, a small job)", run_p22, *jobs, build)
    entries["flash_attention_bwd"]["head_dim_256"] = p22["entry"]
    p23 = _timed("23 (the remaining token configs served at full width: deepseek-v2's MLA, "
                 "the MoE forms, granite, musicgen, qwen3-moe, chameleon)", run_p23, *jobs,
                 build)
    entries["flash_attention"]["mla"] = p23["entry"]
    p24 = _timed("24 (the precision policy and the step builders: the bf16 attention kernels, "
                 "bf16 serving, mixed and bf16_train training)", run_p24, torch, build)

    # each kernel's launches on the path that carries it: fedagg on the
    # first slice's path, the int8 fold and install on the second's, the
    # decode on the socket path, the trimmed mean on the robust path, each
    # token kernel on the serving path of its family (phase 15's paths
    # printed their own above)
    print(f"launches on phase 15's paths: {p15}")
    print(f"launches on phase 16's paths: {p16}")
    print(f"launches on phase 17's paths: {p17}")
    print(f"launches on phase 18's paths: {p18}")
    print(f"launches on phase 19's paths: {p19}")
    print(f"launches on phase 20b's path: {p20['launches']}")
    print(f"launches on phase 21c's path: {p21['21c']}; on 21d's: {p21['21d']}")
    print(f"launches on phase 22b's path: {p22['launches']}")
    print(f"launches on phase 23's paths (prefill): {p23['launches']}")
    print(f"launches on phase 24b's paths (prefill): {p24['serve']['launches']}")
    print(f"launches on phase 24c's paths: {p24['train']['launches']}")
    print(smi)
    # the bf16 kernels' launches on phase 24's paths: the forward on 24b's
    # prefills, the backward on 24c's training steps
    bf16_paths = {name: {name: sum(v.get(name, 0) for v in paths.values())}
                  for name, paths in (("flash_attention_bf16", p24["serve"]["launches"]),
                                      ("flash_attention_bwd_bf16", p24["train"]["launches"]))}
    entries["flash_attention_bf16"] = p24["entry"]["fwd"]
    entries["flash_attention_bwd_bf16"] = p24["entry"]["bwd"]
    path_of = {"fedagg": main_launches, "quantize_int8": int8_launches,
               "fedagg_dequant": int8_launches, "dequant_install": int8_launches,
               "dequantize_int8": socket_launches, "trimmed_mean": robust_launches,
               **serving_launches, "flash_attention_bwd": p20["launches"],
               "rwkv6_scan_bwd": p21["21c"], "mamba_scan_bwd": p21["21d"], **bf16_paths}
    kernels = []
    for name, (route, source, replaces) in ops.KERNELS.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": path_of[name].get(name, 0),
                        **entries[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
