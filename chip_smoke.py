"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at once)
and drives both of the port's paths:

* training (slice 1): holds the ``sqdist_rows``/``sqdist`` kernels
  against their plain versions on the card, trains the paper's MNIST CNN
  at full width (m = 100 learners, B = 10) under periodic and dynamic
  averaging through ``run_protocol_training``, checks that the dynamic
  run went through ``sqdist_rows`` once per checked round, and that a
  small dynamic run on the card makes exactly the sync decisions of the
  same run on the CPU. The scalar ``sqdist`` kernel (behind
  ``divergence.sq_distance(use_kernel=True)``) is not on the training
  path, as in the reference: it is checked and timed, and its main-path
  count is 0. Both are one CUDA launch per call (slice 5), which the
  profiler checks, and each is timed for the device alone beside the
  host-bound back-to-back time.
* serving (slice 2): holds the ``rmsnorm``, ``flash_attention`` and
  ``swa_attention`` kernels against their plain versions on the card in
  f32 and bf16 (small and ragged shapes, then the serving path's own),
  checks that the llama3-8b and llama3-8b-swa smoke configs give the
  CPU's logits and greedy tokens on the card, then serves llama3-8b at
  full width and depth in bf16 (prefill at B = 4, S = 2,048; a batch-4
  ``ServeEngine`` feeding 32 prompt tokens and generating 32) and runs
  the llama3-8b-swa prefill at B = 1, S = 16,384 through the banded
  kernel, counting each kernel's launches on each path.
* attention on the tensor cores (slice 4): bf16 attention runs the
  TMA-fed ``wgmma`` program (``attention_sm90.cu``), f32 the split-TF32
  ``mma.sync`` one (``attention.cu``, slice 13); the serving checks above
  cover both, with the programs' edges (ragged tiles, Sq = 1, Sk = 129,
  a one-tile window, head dims 32 and 64, more (batch, head) pairs than
  SMs, and more than 65,535), and f32 at every width pair it takes.
* Mamba2 serving (slice 3; the ``ssd_scan`` program redesigned for the
  tensor cores in slice 5, three launches per call): holds the
  ``ssd_scan`` kernel against the
  sequential plain version on the card (small and ragged S, chunks 8 to
  64, f32 and bf16, strong decay, grouped B and C, odd P and N, bitwise
  repeats, then the serving tensor, timed beside the bytes / TF32 bound,
  with its launches per call and each launch's device time from the
  profiler), checks that the mamba2-2.7b smoke config
  gives the CPU's logits and greedy tokens on the card, then serves
  mamba2-2.7b at full width and depth in bf16 (prefill at B = 4,
  S = 2,048; a batch-4 ``ServeEngine`` feeding 32 prompt tokens and
  generating 32), counting launches, and holds the engine's logits from
  the O(1) recurrence against the prefill's from the chunked kernel.

* the paper's other experiments (slice 6): trains the deep-driving
  PilotNet at full width (348,219 weights, 68x320x3 frames drawn on the
  card, m = 100, B = 10) through ``run_drift_segments`` with drifts at
  rounds 20 and 40, under periodic and dynamic averaging, then FedAvg,
  the random balancing augmentation from a heterogeneous init and the
  serial baseline on the MNIST CNN; each run's ``sqdist_rows`` count is
  exact (30 for the deep-driving dynamic run, 6 for the random one, 0
  otherwise), and ``kernels`` holds ``sqdist_rows`` at (100, 348,219),
  odd P, against its plain version. ``paper_agree`` runs FedAvg, the
  random augmentation, a heterogeneous init and drift=True on the card
  and on the CPU from the same model and batches (identical comm, ledger,
  keys and drift rounds) and holds ``repro_torch.prng`` on the card to
  the CPU, bit for bit.
* the network environment (slice 7): ``net_train`` trains the MNIST CNN
  at full width (m = 100, B = 10) inside the simulated network through
  ``run_protocol_training(network=...)``: dynamic averaging and gossip on
  a mobile geometric overlay at 70% availability, FedAvg and periodic
  averaging on a ring at 60%, dynamic averaging under stragglers and
  outages, and dynamic averaging at full availability, which must equal
  the ``network=None`` run bit for bit; ``sqdist_rows`` runs exactly
  once per checked round of each dynamic run (6) and never otherwise.
  ``net_agree`` runs the network golden cases, a mobile gossip case and
  bounded staleness on the card and on the CPU from the same model and
  batches: comm, ledger, per-round masks, transfers and network times
  identical, parameters within 1e-5.
* checkpoints, the hierarchy and the async timeline (slice 8):
  ``kernels`` also holds the grouped ``sqdist_rows`` (every row against
  its cluster's reference row, one launch) against its plain version and
  checks that one group is the ungrouped call bit for bit; ``tier_train``
  trains the MNIST CNN at full width (m = 100, B = 10) under the
  hierarchy of 10 clusters (on an ideal network, and in the ring at 60%
  with a 2-byte backhaul) and on the event-driven timeline (dynamic
  averaging with lte exchanges 2 rounds in flight; periodic averaging at
  k = 0, which must equal the synchronous run bit for bit; aircomp),
  each with its ``sqdist_rows`` launches split by shape and matched to
  the prediction (6 grouped and 6 inter-tier launches for the
  hierarchy's dynamic run, one per gated round for the async one), then
  saves the hierarchy and the async run after round 20, restores each
  into a fresh learner and runs it on: bit for bit the uninterrupted
  run. ``tier_agree`` runs the hierarchy sweep's and the async bench's
  settings on the card and on the CPU (integers identical, parameters
  within 1e-5) and continues a card checkpoint on the CPU.
* the fault plane, robust sync and telemetry (slice 9): ``kernels`` also
  holds ``sqdist_rows`` at (100, 1,199,882) on planes with a NaN row, an
  Inf row, a -Inf row and a zeroed row (finite rows bit for bit on
  values in {-1, 0, 1}, within rtol 1e-5 on normal values; non-finite
  ones alike in kind); ``fault_train`` trains the MNIST CNN at full width
  (m = 100, B = 10) under the fault plane: dynamic (F1) and
  robust_dynamic (F2, streamed through the telemetry plane with per-link
  bytes, profiling and the divergence series) under the crash and
  sign-flip schedule of examples/faulty_fleet.py, robust_periodic (F3)
  and the median pipeline (F4) under NaN/Inf corruption, crashes,
  adversaries and bursts, and dynamic at ``FaultConfig()`` (F5), which
  must be the ``faults=None`` run bit for bit; ``sqdist_rows`` runs
  exactly 6 times a run (66 for F2: one divergence pass a round); F2's
  stream validates, holds 60 round records with the run's own fault
  counts and ends on the live counters; one trimmed mean and one median
  at (100, P) are timed against their bytes bound. ``fault_agree`` runs
  those settings, an async run and a hierarchy at the test width on the
  card and on the CPU: integers identical, finite parameters within 1e-5.
* per-learner optimizer steps, the row-sharded fleet and the analysis
  tools (slice 10): ``kernels`` also holds ``sqdist_rows`` at (50, P)
  and (25, P), one rank's rows of mnist_cnn's fleet over 2 and 4 ranks,
  and times them; ``fault_train`` adds F6, adam at lr 1e-3 under the
  crash schedule, whose per-learner step counts must be the schedule's
  (``fault_agree`` holds F6's settings on the card to the CPU, step
  counts included); ``shard_train`` runs tests/test_shard.py's fixture
  (the drift MLP, m = 8, the seven presets and a hierarchy) flat on the
  card and the CPU (integers identical), then trains mnist_cnn at full width (m = 100,
  B = 10), dynamic and periodic, flat in this process, then on
  ``layout="sharded"`` through ``shard.launch``: S1 one rank over NCCL
  (the flat run bit for bit), S2 and S4 two and four ranks sharing the
  card over gloo. Every world: every rank's counters alike, a second
  run bit for bit the first, each rank's ``sqdist_rows`` launches by
  shape (6 at (100/n, P) under dynamic), and the fixture's presets with
  the card's flat comm, ledger and link transfers and planes within the
  reference's rtol 2e-4 / atol 1e-6. At full width S2 and S4 keep the
  flat comm and ledger under periodic; the planes, and dynamic's sync
  decisions, are reported against the flat run (the ranks' smaller
  cuBLAS/cuDNN calls give other last bits, which training grows), held
  only to a gross-fault bound. Also ms a round, peak memory and
  collective bytes a round, and ``make_dynamic_train_step`` at world 2
  against one process; ``analysis`` runs the lint of the port
  and this script and the contract matrix (clean), audits one dynamic
  chunk on the card, where the dispatch mode's host syncs and
  ``torch.cuda.set_sync_debug_mode``'s warnings must both equal the
  documented budget, places one dynamic round on the roofline and sets
  each kernel's ``kernel_bound`` beside its measured time (the same
  bound the kernel phases computed); ``costs`` runs
  ``python -m repro_torch.telemetry costs`` on F2's stream.
* the training side closed (slice 11): ``shard_train`` also runs, inside
  each world's launch, F1 (dynamic under the faulty_fleet schedule), F3
  (robust_periodic under HEAVY), A1 (async dynamic, lte 2 rounds in
  flight) and A3 (aircomp) at full width for 60 rounds (F3 40), flat
  in this process first: S1 is each one's flat run bit for bit; at S2
  and S4 the ranks agree, the integers no float decides (the fault
  schedule's counts, a cadence trigger's comm, ledger and in-flight
  timeline) are the flat run's and the plane is within 1% of the flat
  plane's norm, NaN and Inf one class (README, the split fleet's
  contract), with each rank's ``sqdist_rows`` launches at (100/n, P),
  ms a round and peak memory. ``train_step`` holds Proposition 3 at
  full width (one σ_1 round of m = 100 learners, B = 10, η = 0.05,
  against one ``make_train_step`` step with batch 1,000 and lr η/m·mB:
  rtol 1e-4 / atol 1e-6 in float64; in float32 within 1e-5 of the
  norm, which a serial step at (1 + 1/m) times the learning rate must
  miss) and ``micro_batch`` 4 against 1 at batch 1,000, each timed
  after a warm-up call. The eight figure twins run in ``twins`` (below).

* the rest of the serving zoo (slice 12): ``zoo_kernels`` holds the
  kernels against their plain versions at the shapes the zoo gives them
  (swa attention at hymba's (4, 2048, 25/5, 64) with w = 1,024; flash
  attention at musicgen's (4, 2048, 32/32, 64), llama3-405b's group of
  16 and MLA's query/key width 192 over value width 128 in bf16 and f32;
  ``ssd_scan`` at hymba's (200, 2048, 64, 16), 50 heads a group;
  ``rmsnorm`` at d = 1,600, 6,144, 5,120 and 16,384) and times each
  beside its plain version, one PyTorch call and ``kernel_bound``;
  ``zoo_agree`` runs the eight zoo smoke configs (mixtral-8x22b,
  deepseek-v2-236b, hymba-1.5b, internvl2-76b with a stub vision
  prefix, musicgen-large's four codebooks, minitron-4b, qwen1.5-110b,
  llama3-405b) on the card and on the CPU from the same weights:
  prefill logits and the MoE auxiliary loss within AGREE_TOL, each layer
  through its kernels, 16 greedy tokens identical, and the MoE configs
  also at capacity factor 1.25, where every layer's kept (token, k) set
  must be the CPU's; ``zoo_serve`` serves each at full width in bf16
  (depth cut where one card cannot hold it, ``ZOO_LAYERS``): prefill at
  (4, 2048), a batch-4 engine feeding 16 tokens and generating 16, with
  ms, tokens/s, decode ms a step beside its bytes bound, peak memory,
  each kernel's launches and the MoE configs' dropped share.
* two kernels redesigned for Hopper (slice 13): f32 attention on the
  tensor cores in split TF32 and ``rmsnorm`` with 16-byte loads and a
  block with 2-4 vectors a thread a row.
  ``lm_kernels`` also holds ``rmsnorm`` at D not a multiple of 8, on a
  view one element off (misaligned rows and scale), at decode's (1-4,
  d) for every width a full-size config norms (``norm_widths``) and at
  ``MAX_D``, and times f32 attention and swa against SDPA in f32 (kv
  heads expanded) beside the split-TF32 bound and the CUDA cores' f32
  bound; ``zoo_kernels`` times f32 attention at every zoo layout and
  ``rmsnorm`` at every ``norm_widths`` width on inputs that have left
  the L2; ``zoo_serve`` times each
  config's f32 prefill (the second call) and counts its launches.
* LM training through the kernels (slice 14): two backward kernels
  (``attention_bwd.cu``, f32; ``rmsnorm_bwd.cu``, a grouped dscale),
  the f32 attention program writing each row's
  log-sum-exp for them, and the norm's grouped scale.
  ``lm_train_kernels`` holds each backward kernel against the autograd
  gradient of its plain version in f32 and float64, bitwise across two
  launches, at llama3-8b's (1, 4096, 32/8, 128), the fleet's folded
  (16, 128, 12/4, 128) and at head dim 64, ragged S, GQA groups 1 and 4, a window and a
  non-causal Sk != Sq; the norm at (4096, 4096) with 1 and 4 groups,
  the fleet's rows and rows off 16 bytes; times them beside the plain
  version, SDPA's / ``F.rms_norm``'s backward and ``kernel_bound``.
  ``lm_train`` trains llama3-8b at full width (2 of 32 layers, f32,
  S = 4,096) through ``make_train_step(lm_loss)``, its step-1 gradient
  held against the plain versions', and fleet-llm-100m at full width
  and depth, m = 4, dynamic and periodic for 60 steps each, with exact
  launches (one per layer and op for the four learners) and the
  dynamic run repeated bit for bit; ``lm_train_agree`` holds
  llama3-8b-smoke's three step factories on the card to the CPU and
  runs the launcher twin's ``--smoke`` modes on the card.
* ``attention_bwd`` redesigned for Hopper (slice 15): every product on
  the tensor cores in split TF32 (``mma.sync``, the f32 forward's
  program, ``sm90_mma_tf32x3``), dk and dv of a GQA group summed from
  per-head partials in head order; ``lm_train_kernels`` names the
  program and each of its kernels' registers and spills from the build
  phase.
* SSM and hybrid LM training on the card (slice 16): ``ssd_scan_bwd.cu``
  (f32 on the CUDA cores: the reverse state walk, the chunks in
  parallel, db/dc summed over a row's heads and da over the chunks in
  fixed order) behind ``ssd_scan.SSDScanFn``, and the banded attention's
  gradient through ``AttentionFn`` with the window (``ops.swa_attention``
  under a gradient). ``lm_train_kernels`` holds ``ssd_scan_bwd`` against
  the autograd gradient of the sequential plain version in f32 and
  float64, bitwise across two launches, at mamba2-2.7b's (80, 4096, 64,
  128) and hymba-1.5b's (50, 4096, 64, 16) training shapes (one row of b
  and c for all heads, chunk 64) and at chunks 8 / 16 / 32, R = 1, P =
  32, N = 64, with and without dh and under strong decay, and a padded S
  through ``ops``; ``torch.func.vmap`` over 4 learners is the
  per-learner calls bit for bit in one launch; the banded backward at
  hymba's (1, 4096, 25/5, 64), w 1,024, through ``ops.swa_attention``;
  each timed beside its plain version and ``kernel_bound``. ``lm_train``
  adds mamba2-2.7b and hymba-1.5b σ_1 cells beside llama3-8b's (full
  width, 2 layers, f32, S = 4,096, 6 adam steps): step-1 gradient
  against the plain versions', exact launches of every kernel.
* ``ssd_scan_bwd`` redesigned for Hopper's tensor cores: every product on the
  tensor cores in split TF32 (``mma.sync``, ``sm90_mma_tf32x3``), C B^T
  once per (row, chunk), the reverse walk split over blocks of 16-row
  tiles with its column tile sized to N (``ssd_scan.bwd_plan``).
  ``lm_train_kernels`` adds its edges to SSD_BWD_CASES (N past a column
  tile or slab, P past a row tile, R > 1 at chunk 8) and prints with the
  timed rows the plan and each CUDA launch's device time.
* MoE and MLA LM training on the card (slice 18): ``attention_bwd.cu``
  at MLA's (query/key, value) widths, (192, 128) and (48, 32), with the
  f32 forward writing its log-sum-exp at every width pair;
  ``lm_train_kernels`` adds deepseek-v2-236b's (1, 4096, 128, 192/128)
  (timed beside SDPA's f32 backward and the bound), the smoke widths
  with 4 learners folded, and ragged non-causal Sk != Sq cases at both
  pairs (C1's guard). ``lm_train`` adds the MoE σ_1 cells with the
  reference's production train program (sgd, ``lm_loss(remat=True)``:
  each layer's forward kernels launch twice a step): deepseek-v2-236b
  (MLA, 160 experts, top 6, 2 shared) and mixtral-8x22b (8 experts, top
  2, window 4,096) at full width, depth cut to one card
  (``LM_MOE_LAYERS``), their step-1 gradient held against the plain
  versions' at S = LM_MOE_CHECK_S. ``moe_fleet`` runs the launcher
  twin's ``--smoke`` dynamic and periodic fleets of both MoE archs on
  the card: the routing under the learners' vmap, attention at (48, 32)
  and on the banded route one launch a layer for both learners, the
  dynamic run both syncing and holding.
* the reference's other benchmarks (slice 19): ``twins`` runs every
  twin of ``benchmarks/torch_run.py`` — the eight figures and those of
  ``dynamic_amortized``, ``scan_driver``, ``fig_network_regimes``,
  ``fig_hierarchy``, ``sync_bench`` (one round on the full-width CNN's
  plane at m = 8, 64 and 200, the cohort balancing at exactly m/2),
  ``async_bench``, ``robust_bench`` and ``kernel_bench`` (the five
  kernels at the reference's shapes, one launch a call, timed beside
  ``kernel_bound``) — at the reference's quick settings on the card,
  but ``shard_bench``, whose sweep of spawned worlds outlasts the
  phase and runs its cut row only; each verdict beside the reference's
  quick verdict on the CPU, each row's exactness fields held, every
  plane it gives ``sqdist_rows`` among those ``kernels`` held to the
  plain version; then each twin's cut rows (``CUT``) on the CPU from
  its own source and on the card from the same draws: integers
  identical.
* bf16 LM training on the card (slice 21, ROADMAP A28): the bf16
  ``wgmma`` forward writes its log-sum-exp when a gradient asks for it,
  ``attention_bwd_bf16.cu`` is the bf16 attention backward (one bf16
  ``mma.sync`` a product, P and dS rounded to bf16 as the reference
  rounds its probabilities) and ``rmsnorm_bwd.cu`` takes bf16; a direct
  bf16 ``ssd_scan`` takes the f32 backward upcast.
  ``lm_train_kernels`` holds them against the f32 gradient of their
  plain versions on the same bf16 inputs within twice what SDPA's or
  ``F.rms_norm``'s bf16 backward reaches (BF16_VS_LIBRARY), timed
  beside those calls; ``launch`` adds the launcher's ``train`` program
  in bf16 at LAUNCH_BF16_LAYERS layers, held as the other five, and its
  step-1 gradient against the f32 gradient of the same weights
  (LAUNCH_BF16_GAP).
* the bf16 backward kernels redesigned for Hopper (slice 22):
  ``attention_bwd_bf16.cu`` on TMA-fed ``wgmma`` with a producer warp and
  two consumer warpgroups, as the bf16 forward (``sm90_common.cuh``
  holds their shared parts), three launches, dk and dv summed over the
  kv head's group in registers (no f32 partial, no group-sum launch);
  ``rmsnorm_bwd.cu``'s bf16 rows in 16-byte vectors through a
  ``cp.async`` ring, with a scalar head and tail. ``lm_kernels`` profiles
  each launch of both at their timed shapes (``BWD_BF16_DEVICE``, the
  profiler's device time; later phases leave it no device events), which
  ``lm_train_kernels`` prints with their timed rows beside the
  kernels' registers and spills; TRAIN_NORM_BF16_CASES adds (4096,
  4100), rows off 16 bytes.

Each phase prints one JSON line with its seconds. The last three lines
are the kernel table, the card's name and power limit as ``nvidia-smi``
reports them, and ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before those lines; without a CUDA device the script exits
non-zero at once. It imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from collections import Counter
from io import StringIO

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is visible "
             "(torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.config import (  # noqa: E402
    AsyncConfig, FaultConfig, HierarchyConfig, NetworkConfig, ProtocolConfig,
    ShapeConfig, TelemetryConfig, TrainConfig, get_arch, norm_widths,
)
from repro_torch.analysis.roofline import (  # noqa: E402
    attention_work, kernel_bound, peaks, ssd_work,
)
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import distributed, shard  # noqa: E402
from repro_torch.core.flatten import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner, SerialLearner  # noqa: E402
from repro_torch.core.sync import stages  # noqa: E402
from repro_torch.core.sync.robust import flat_median, flat_trimmed_mean  # noqa: E402
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec  # noqa: E402
from repro_torch.data.pipeline import LearnerStreams  # noqa: E402
from repro_torch.device import versions  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    DeepDriveStream, GraphicalModelStream, SyntheticMNIST, TokenStream,
)
from repro_torch.kernels import (  # noqa: E402
    _build, flash_attention, ops, ref, rmsnorm, sqdist, ssd_scan,
    swa_attention,
)
from repro_torch.launch.sharding import map_named  # noqa: E402
from repro_torch.kernels._timing import (  # noqa: E402
    cold_inputs, cuda_ms, graph_ms, host_us, in_turn, profile_calls,
)
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.models.attention import takes_band  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    init_lm_params, lm_apply, lm_forward,
)
from repro_torch.network import availability, faults, topology  # noqa: E402
from repro_torch.serve.engine import ServeEngine, make_prefill  # noqa: E402
from repro_torch.telemetry.observatory import load_run, summarize  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    run_drift_segments, run_protocol_training,
)
from benchmarks import torch_run  # noqa: E402

P_MNIST = 1_199_882          # mnist_cnn's weights (Table 1)
P_DEEPDRIVE = 348_219        # deepdrive_cnn's weights (Table 5, PilotNet)
M, B, ROUNDS, CHUNK, PERIOD, DELTA = 100, 10, 60, 20, 10, 0.7
TIER_G = 10                  # tier_train's clusters of 10 learners
TOL = dict(rtol=1e-5, atol=1e-6)

# the serving path (llama3-8b and its sliding-window variant, bf16)
SERVE_B, SERVE_S, PROMPT, GEN = 4, 2048, 32, 32
SWA_B, SWA_S = 1, 16_384
# kernel vs plain on the card: f32 differs only in summation order; bf16
# outputs may land one bf16 step apart (the same f32 value rounded once)
LM_TOL = {("rmsnorm", torch.float32): dict(rtol=1e-5, atol=1e-6),
          ("attention", torch.float32): dict(rtol=1e-4, atol=1e-5),
          ("rmsnorm", torch.bfloat16): dict(rtol=2 ** -7, atol=1e-5),
          ("attention", torch.bfloat16): dict(rtol=2 ** -7, atol=1e-5)}
# the smoke configs on the card against the CPU, in f32: matmuls, softmax
# and norm statistics summed in other orders through two layers
AGREE_TOL = dict(rtol=1e-4, atol=1e-5)
# full-width serving in bf16: the engine's prompt logits against the
# prefill's, and the band below the window against full attention, as
# max |diff| over max |logit| (bf16 keeps ~3 significant digits; 32 layers)
SERVE_REL_TOL = 5e-2
# the edges of the bf16 tensor-core attention program (128-row query tiles
# of two 64-row halves, 64-key tiles, TMA zero-fill past Sq and Sk, a 1-D
# grid): ragged Sq and Sk, Sq = 1, Sk = 129, a window of one key tile, head
# dims 32 and 64, B * H above the card's 132 SMs. (B, Sq, Sk, H, Hkv, d,
# causal, window), checked in f32 and bf16 like the cases before them
ATTN_EDGES = [(2, 100, 200, 4, 2, 128, True, 0),
              (1, 300, 300, 8, 2, 128, True, 0),
              (3, 1, 300, 8, 2, 128, True, 0), (2, 1, 77, 4, 4, 64, False, 0),
              (1, 129, 129, 4, 2, 128, True, 0),
              (2, 40, 129, 4, 1, 64, False, 0),
              (1, 256, 256, 4, 2, 128, True, 64),
              (2, 200, 200, 4, 2, 32, True, 0),
              (2, 200, 200, 4, 2, 64, True, 48),
              (5, 130, 130, 32, 8, 64, True, 0)]
# the edges of rmsnorm's forms (rmsnorm.plan): D not a multiple of 8 (a
# scalar tail; a head too on the rows that start off 16 bytes), a view one
# element into its buffer (every row and the scale misaligned; at D = 200
# and D = 7 one warp a row), decode's 1-4 rows at every width a full-size
# config norms (a few blocks) and MAX_D (the stream form in f32);
# ((shape), offset), checked in f32 and bf16
NORM_EDGES = ([((5, 1601), 0), ((3, 4100), 0), ((2, 3, 1601), 1),
               ((4, 4096), 1), ((3, 16384), 3), ((9, 200), 1), ((4, 7), 1),
               ((2, rmsnorm.MAX_D), 0), ((2, rmsnorm.MAX_D), 1)]
              + [((b, 1, d), 0) for d in norm_widths()
                 for b in (1, 2, 3, 4)])
# ssd_scan against the sequential plain version: the JAX package's own
# tolerances for this kernel (tests/test_kernels.py:181-182)
SSM_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-3),
           torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
# mamba2-2.7b at full width, the engine's prompt logits (the O(1)
# recurrence) against the prefill's (the chunked kernel), as max |diff|
# over max |logit|. In f32 the two paths differ only in summation order.
# In bf16 they also round products of other shapes (gemm in prefill, gemv
# in decode) differently, and random weights amplify that with depth: the
# JAX package's own bf16 prefill and decode, on the same weights at 64
# layers, differ by 7.36-8.68% over three draws
# (tests/test_torch_ssm.py::test_bf16_prompt_gap_tracks_the_reference).
# The port may differ as much as the reference does, and no more; the
# phase prints both gaps and each bf16 path's distance from the f32 logits.
SSM_F32_REL_TOL = 1e-4
SSM_SERVE_REL_TOL = 0.0868
# the SSM tree holds L * (H + d_inner - d) + d weights more than
# param_count() counts (see repro_torch.config.ModelConfig.param_count)
SSM_TREE_EXTRA = 171_520


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def child_pids() -> list:
    """The processes whose parent is this one, zombies included."""
    pids = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid():
            pids.append(int(entry))
    return pids


def stop_children() -> list:
    """Stop every process this script started that is still there: a
    multiprocessing child, and multiprocessing's resource tracker, which
    spawning shard_train's ranks starts and which would otherwise exit
    only after this script has, outliving it. Returns the child processes
    left after that (none, unless something else started one)."""
    import multiprocessing
    from multiprocessing import resource_tracker

    for child in multiprocessing.active_children():
        child.terminate()
        child.join(10)
    resource_tracker._resource_tracker._stop()   # closes its pipe, reaps it
    return child_pids()


# ---------------------------------------------------------------------------
def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = {"phase": "env", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), **versions(),
           "nvcc": _build.nvcc_path(),
           "ninja": shutil.which("ninja")}
    emit(rec)
    return rec


def ptxas_line(line: str) -> str:
    """A line of ``-Xptxas=-v``, a function's mangled name cut to the
    kernel's own name and its template arguments."""
    line = line.strip()
    mangled = re.search(r"_ZN?(\w+)", line)
    if "entry function" not in line or not mangled:
        return line
    name, at = mangled.group(1), 0     # a run of <length><identifier>
    while (size := re.match(r"\d+", name[at:])) is not None:
        at += len(size.group())
        ident, at = name[at:at + int(size.group())], at + int(size.group())
        if "kernel" in ident:
            args = re.match(r"I\w*?E(?:Li\d+E)*", name[at:])
            return "entry " + ident + (args.group() if args else "")
    return line


def kernel_resources(ptxas: list, prefix: str) -> dict:
    """Registers and spill bytes of each kernel whose name starts with
    ``prefix``, from the build phase's ``-Xptxas=-v`` lines (entry,
    then its stack frame and spills, then its registers):
    ``{kernel: {"registers": n, "spill_stores": b, "spill_loads": b}}``."""
    out, name = {}, None
    for line in ptxas:
        if line.startswith("entry "):
            name = line[6:] if line[6:].startswith(prefix) else None
            if name:
                out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = _build.build_all()
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "built": {n: r["seconds"] for n, r in built.items()},
           "ptxas": [ptxas_line(line) for r in built.values()
                     for line in r["log"].splitlines()
                     if "entry function" in line or "registers" in line
                     or "spill" in line or "Performance Loss" in line]}
    for name in _build.SOURCES:
        _build.library(name)
    emit(rec)
    return rec


# the twins' planes (benchmarks/torch_*.py) in the twins phase, their
# quick grids and cut rows, on the smoke models: m of the figures' grids
# (fig5_1 and fig5_2 10; fig6_1 4, 8 and 16; fig6_2 and figA6 6; fig5_4
# 8; figC 6; fig5_5 5) and cut rows (4 and 8; 4 and 6; 3); scan_driver's
# and dynamic_amortized's 8; fig_network_regimes', async_bench's and
# shard_bench's cut 8; fig_hierarchy's 12 learners, whole and in 3 or 4
# clusters (grouped, (m, g)), and its coordinator tier's 3 and 4 rows
TWIN_ROWS = {"mnist_cnn": (4, 6, 8, 10, 16),
             "drift_mlp": (3, 4, 6, 8, 12, (12, 3), (12, 4)),
             "deepdrive_cnn": (3, 5)}


def twin_planes() -> list:
    """The planes the twins phase gives ``sqdist_rows``, as
    ``ops.ROWS_LAUNCHES`` keys ``(m, P, g)``: TWIN_ROWS, P the smoke
    model's weights; the full mnist_cnn at sync_bench's fleets (8, 64 and
    200; 64 also kernel_bench's row); robust_bench's regression plane;
    kernel_bench's cut row."""
    from benchmarks import torch_kernel_bench, torch_robust_bench
    from benchmarks import torch_sync_bench
    planes = []
    for arch, rows in TWIN_ROWS.items():
        params = init_cnn_params(get_arch(arch, smoke=True),
                                 torch.Generator().manual_seed(0))
        P = sum(x.numel() for x in tree_leaves(params))
        planes += [(r[0], P, r[1]) if isinstance(r, tuple) else (r, P, 1)
                   for r in rows]
    planes += [(m, P_MNIST, 1) for m in torch_sync_bench.M_LIST]
    planes += [(torch_robust_bench.M, torch_robust_bench.DIM, 1),
               (*torch_kernel_bench.CUT[0][0]["sqdist_rows"], 1)]
    return planes


def phase_kernels(gen) -> dict:
    """Each kernel against its plain version on the card, at rtol 1e-5 /
    atol 1e-6, and bitwise equal across two launches."""
    checks = []
    worst = {k: {"abs": 0.0, "rel": 0.0} for k in ("sqdist_rows", "sqdist")}

    def check(name, kernel, plain, args, label):
        a, b = kernel(*args), kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = float((a - want).abs().max())
        rel = float(((a - want).abs() / want.abs().clamp_min(1e-30)).max())
        worst[name]["abs"] = max(worst[name]["abs"], err)
        worst[name]["rel"] = max(worst[name]["rel"], rel)
        repeat = bool(torch.equal(a, b))
        ok = repeat and bool(torch.allclose(a, want, **TOL))
        checks.append({"kernel": name, "inputs": label,
                       "dtype": str(args[0].dtype).split(".")[1],
                       "max_abs_err": err, "max_rel_err": rel,
                       "bitwise_repeat": repeat, "ok": ok})
        if not ok:
            emit({"phase": "kernels", "failed": checks[-1]})
            raise SystemExit(f"kernel {name} disagrees: {checks[-1]}")

    # sqdist flattens its inputs: (1, P_MNIST) is one whole mnist_cnn model;
    # P_DEEPDRIVE is odd, so every odd row of that plane starts 4 bytes off
    # an 8-byte boundary
    # (50, P) and (25, P): one rank's rows of a fleet sharded over 2 and 4
    # ranks (shard_train); then every plane of the twins phase
    twins = twin_planes()
    for m, n in [(1, 1), (17, 515), (1, P_MNIST), (7, P_MNIST),
                 (25, P_MNIST), (50, P_MNIST), (100, P_MNIST),
                 (3, P_DEEPDRIVE), (100, P_DEEPDRIVE)] + [
                     (m, n) for m, n, g in twins if g == 1]:
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn((m, n), generator=gen, device="cuda").to(dt)
            r = torch.randn((n,), generator=gen, device="cuda").to(dt)
            R = r.expand(m, n).contiguous()
            check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref,
                  (X, r), [m, n])
            check("sqdist", sqdist.sqdist, ref.sqdist_ref, (X, R), [m, n])
            del X, R

    # the grouped form (a hierarchy's intra tier): row i against its
    # cluster's reference R[i // k], g clusters of k rows, odd P included;
    # then the twins phase's grouped planes
    for g, k, n in [(2, 3, 7), (10, 10, 515), (10, 10, P_DEEPDRIVE),
                    (10, 1, P_MNIST), (4, 25, P_MNIST)] + [
                        (g, m // g, n) for m, n, g in twins if g > 1]:
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn((g * k, n), generator=gen, device="cuda").to(dt)
            R = torch.randn((g, n), generator=gen, device="cuda").to(dt)
            check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref,
                  (X, R), [g * k, n, f"g={g}"])
            del X, R

    nonfinite = check_non_finite_rows(gen)

    mem_rate, f32_rate = peaks(torch.cuda.get_device_name(0))[:2]
    X = torch.randn((M, P_MNIST), generator=gen, device="cuda")
    r = torch.randn((P_MNIST,), generator=gen, device="cuda")
    x0 = X[0]
    # g = 1 is today's call, bit for bit
    if not torch.equal(sqdist.sqdist_rows(X, r[None]),
                       sqdist.sqdist_rows(X, r)):
        raise SystemExit("grouped sqdist_rows with g = 1 is not the "
                         "ungrouped call bit for bit")
    G = TIER_G
    Rg = torch.randn((G, P_MNIST), generator=gen, device="cuda")
    check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref, (X, Rg),
          f"timed X (100, P), R ({G}, P)")
    # the timed inputs themselves, checked as the shapes above
    check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref, (X, r),
          "timed X (100, P)")
    check("sqdist", sqdist.sqdist, ref.sqdist_ref, (x0, r),
          "timed x0 = X[0] (P,)")
    Xd = torch.randn((M, P_DEEPDRIVE), generator=gen, device="cuda")
    rd = torch.randn((P_DEEPDRIVE,), generator=gen, device="cuda")
    check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref, (Xd, rd),
          "timed X (100, P_DEEPDRIVE)")
    row_starts = sorted({(i * P_DEEPDRIVE * 4) % 16 for i in range(M)})
    timed = {
        "sqdist_rows": (M, P_MNIST, lambda: sqdist.sqdist_rows(X, r),
                        lambda: ref.sqdist_rows_ref(X, r),
                        lambda: torch.linalg.vector_norm(X - r, dim=1)
                        .square()),
        "sqdist": (1, P_MNIST, lambda: sqdist.sqdist(x0, r),
                   lambda: ref.sqdist_ref(x0, r),
                   lambda: torch.linalg.vector_norm(x0 - r).square()),
        "sqdist_rows_50": (
            50, P_MNIST, lambda: sqdist.sqdist_rows(X[:50], r),
            lambda: ref.sqdist_rows_ref(X[:50], r),
            lambda: torch.linalg.vector_norm(X[:50] - r, dim=1).square()),
        "sqdist_rows_25": (
            25, P_MNIST, lambda: sqdist.sqdist_rows(X[:25], r),
            lambda: ref.sqdist_rows_ref(X[:25], r),
            lambda: torch.linalg.vector_norm(X[:25] - r, dim=1).square()),
        "sqdist_rows_deepdrive": (
            M, P_DEEPDRIVE, lambda: sqdist.sqdist_rows(Xd, rd),
            lambda: ref.sqdist_rows_ref(Xd, rd),
            lambda: torch.linalg.vector_norm(Xd - rd, dim=1).square()),
        "sqdist_rows_grouped": (
            M, P_MNIST, lambda: sqdist.sqdist_rows(X, Rg),
            lambda: ref.sqdist_rows_ref(X, Rg),
            lambda: torch.linalg.vector_norm(
                X.view(G, M // G, P_MNIST) - Rg[:, None], dim=2).square()),
    }
    table = {}
    for name, (m, P, kernel, plain, library) in timed.items():
        refs = G if name.endswith("grouped") else 1
        nbytes = (m * P + refs * P) * 4 + 4 * m
        nops = 3 * m * P
        t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
        # the device alone: one launch per call (the last block of a row,
        # chosen by a ticket, sums its partials), against vector_norm's
        dev, dev_library = profile_calls(kernel), profile_calls(library)
        kernel_name = "sqdist" if name == "sqdist" else "sqdist_rows"
        table[name] = {
            "shape": [m, P], "dtype": "float32",
            "max_abs_err": worst[kernel_name]["abs"],
            "max_rel_err": worst[kernel_name]["rel"], "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": nops,
            "device_ms": dev["device_ms"],
            "cuda_launches_per_call": dev["cuda_launches_per_call"],
            "library_device_ms": dev_library["device_ms"],
            "library_cuda_launches_per_call":
                dev_library["cuda_launches_per_call"]}
        if dev["cuda_launches_per_call"] != 1:
            raise SystemExit(f"{name} made {dev['cuda_launches_per_call']} "
                             f"CUDA launches per call, not 1: {dev}")
    table["sqdist_rows_deepdrive"]["row_start_bytes_mod_16"] = row_starts
    table["sqdist_rows_grouped"]["groups"] = G
    table["sqdist_rows"]["non_finite_rows"] = nonfinite
    emit({"phase": "kernels", "checks": len(checks),
          "all_ok": all(c["ok"] for c in checks), "timed": table,
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate}})
    return table


def check_non_finite_rows(gen) -> dict:
    """``sqdist_rows`` at (100, P_MNIST) on the planes a faulty fleet
    syncs: a NaN row, an Inf row, a -Inf row and a row zeroed by a cold
    restart, against its plain version. On values in {-1, 0, 1} every
    partial sum is an integer below 2**24, exact in f32 in any order, so
    the finite rows must be bit for bit; on normal values they must be
    within TOL. The non-finite rows must agree in kind (NaN with NaN,
    +Inf with +Inf)."""
    out = {}
    for label, make in (
            ("values in {-1, 0, 1}", lambda shape: torch.randint(
                -1, 2, shape, generator=gen, device="cuda").float()),
            ("normal values", lambda shape: torch.randn(
                shape, generator=gen, device="cuda"))):
        X, r = make((M, P_MNIST)), make((P_MNIST,))
        X[1], X[2], X[3], X[4] = math.nan, math.inf, -math.inf, 0.0
        got, want = sqdist.sqdist_rows(X, r), ref.sqdist_rows_ref(X, r)
        torch.cuda.synchronize()
        kind = (torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.isposinf(got), torch.isposinf(want))
                and bool(torch.isnan(got[1])) and bool(torch.isposinf(
                    got[2])) and bool(torch.isposinf(got[3])))
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        exact = bool(torch.equal(got[fin], want[fin]))
        ok = kind and (exact if label.startswith("values") else bool(
            torch.allclose(got[fin], want[fin], **TOL)))
        out[label] = {"shape": [M, P_MNIST], "finite_rows": int(fin.sum()),
                      "finite_max_abs_err": err, "finite_bitwise": exact,
                      "non_finite_agree_in_kind": kind, "ok": ok}
        if not ok:
            emit({"phase": "kernels", "failed": {"non_finite": out}})
            raise SystemExit(f"sqdist_rows on non-finite rows disagrees "
                             f"with its plain version: {out[label]}")
        del X, r
    return out


def phase_train() -> dict:
    """The main path: full-width mnist_cnn, m = 100, through
    run_protocol_training, periodic then dynamic."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    test = src.sample(torch.Generator(device="cuda").manual_seed(10_000), 512)
    train = TrainConfig(optimizer="sgd", learning_rate=0.1)
    protos = {"periodic": ProtocolConfig(kind="periodic", b=PERIOD),
              "dynamic": ProtocolConfig(kind="dynamic", b=PERIOD,
                                        delta=DELTA)}
    # warm-up outside the counted window: cuDNN picks its algorithms
    run_protocol_training(loss_fn, init_fn, src, m=M, rounds=2,
                          protocol=protos["dynamic"], train=train, batch=B,
                          device="cuda")
    torch.cuda.synchronize()

    runs, launches = {}, {}
    ops.reset_launches()
    for name, proto in protos.items():
        before = dict(ops.LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dl, traj = run_protocol_training(
            loss_fn, init_fn, src, m=M, rounds=ROUNDS, protocol=proto,
            train=train, batch=B, chunk_size=CHUNK, record_every=CHUNK,
            device="cuda")
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        acc = float(cnn_accuracy(cfg, dl.mean_model(), test))
        runs[name] = {
            "weights": dl.model_size, "rounds": dl.rounds,
            "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "comm_bytes": dl.comm_bytes(),
            "ledger_bytes": int(dl.per_link_bytes().sum()),
            "cumulative_loss": dl.cumulative_loss,
            "accuracy_512": acc,
            "ms_per_round": start.elapsed_time(end) / ROUNDS,
            "wall_s": wall, "launches": launches[name],
            "plane_device": str(dl.X.device),
            "trajectory_syncs": traj.syncs}
        if dl.model_size != P_MNIST:
            raise SystemExit(f"mnist_cnn has {dl.model_size} weights, "
                             f"not {P_MNIST}")
        if not (math.isfinite(dl.cumulative_loss)
                and np.isfinite(dl.cumulative_loss_per_learner).all()):
            raise SystemExit(f"{name}: non-finite loss")
        if runs[name]["ledger_bytes"] != dl.comm_bytes():
            raise SystemExit(f"{name}: ledger {runs[name]['ledger_bytes']} "
                             f"!= comm_bytes {dl.comm_bytes()}")
        if not dl.X.is_cuda:
            raise SystemExit(f"{name}: the parameter plane is on {dl.X.device}")
        del dl
    total = dict(ops.LAUNCHES)
    emit({"phase": "train", "m": M, "batch": B, "runs": runs})

    checked = ROUNDS // PERIOD
    if launches["periodic"]["sqdist_rows"] != 0:
        raise SystemExit(f"periodic launched sqdist_rows: {launches}")
    if launches["dynamic"]["sqdist_rows"] != checked:
        raise SystemExit(f"dynamic launched sqdist_rows "
                         f"{launches['dynamic']['sqdist_rows']} times, not "
                         f"once per checked round ({checked})")
    if runs["dynamic"]["syncs"] < 1:
        raise SystemExit(f"the dynamic run never synced, so the balancing "
                         f"path did not run: {runs['dynamic']}")
    if runs["dynamic"]["comm_bytes"] >= runs["periodic"]["comm_bytes"]:
        raise SystemExit("dynamic averaging communicated no less than "
                         "periodic")
    return total


def phase_agree() -> dict:
    """The same small dynamic run on the card and on the CPU, from the same
    initial model and batches: identical sync decisions and byte counts,
    losses and parameters to f32-reassociation tolerance."""
    cfg = get_arch("mnist_cnn", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(3)))
    src = SyntheticMNIST(seed=0, image_size=14, device="cpu")
    batches = src.sample(torch.Generator().manual_seed(4), 10, lead=(12, 4))
    out = {}
    for dev in ("cpu", "cuda"):
        dl = DecentralizedLearner(
            loss_fn, lambda g: params_from_numpy(init, g.device), 4,
            ProtocolConfig(kind="dynamic", b=2, delta=0.01),
            TrainConfig(optimizer="sgd", learning_rate=0.05), device=dev)
        dl.run_chunk({k: v.to(dev) for k, v in batches.items()})
        out[dev] = dl
    cpu, gpu = out["cpu"], out["cuda"]
    err = float((gpu.X.cpu() - cpu.X).abs().max())
    rec = {"phase": "agree", "comm_totals": gpu.comm_totals,
           "cpu_comm_totals": cpu.comm_totals,
           "loss": gpu.cumulative_loss, "cpu_loss": cpu.cumulative_loss,
           "param_max_abs_err": err}
    emit(rec)
    if (gpu.comm_totals != cpu.comm_totals
            or not np.array_equal(gpu.per_link_bytes(), cpu.per_link_bytes())
            or gpu.comm_totals["syncs"] < 1):
        raise SystemExit("the card's sync decisions differ from the CPU's")
    if not (math.isclose(gpu.cumulative_loss, cpu.cumulative_loss,
                         rel_tol=1e-5) and err <= 1e-5):
        raise SystemExit("the card's losses or parameters differ from the "
                         "CPU's beyond f32 reassociation")
    return rec

# ---------------------------------------------------------------------------
# serving (slice 2)
# ---------------------------------------------------------------------------
def phase_lm_kernels(gen) -> dict:
    """rmsnorm, flash_attention(_gqa) and swa_attention against their plain
    versions on the card, f32 and bf16, bitwise equal across two
    launches, attention also at the edges of its programs
    (``ATTN_EDGES``), f32 at every width pair and B * H above 65,535,
    rmsnorm at the edges of its forms (``NORM_EDGES``); then timed at the
    serving path's shapes in bf16, and flash_attention and swa_attention
    also in f32 (the split-TF32 program, beside its bound and the CUDA
    cores' f32 bound), beside the plain version and one PyTorch call that
    the port never makes. Each attention check and time names the program
    that ran."""
    checks = []
    # the largest error of each kernel, over both dtypes and by dtype
    worst = {k: 0.0 for k in ("rmsnorm", "flash_attention", "swa_attention",
                              "flash_attention f32", "swa_attention f32")}

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def check(name, kind, kernel, plain, args, kw, label):
        a, b = kernel(*args, **kw), kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((a.float() - want.float()).abs().max())
        worst[name] = max(worst[name], err)
        if kind == "attention" and args[0].dtype == torch.float32:
            worst[name + " f32"] = max(worst[name + " f32"], err)
        repeat = bool(torch.equal(a, b))
        ok = repeat and bool(torch.allclose(
            a.float(), want.float(), **LM_TOL[kind, args[0].dtype]))
        checks.append({"kernel": name, "inputs": label,
                       "dtype": str(args[0].dtype).split(".")[1],
                       "max_abs_err": err, "bitwise_repeat": repeat,
                       "ok": ok})
        if kind == "attention":
            checks[-1]["program"] = flash_attention.program(args[0].dtype)
        if not ok:
            emit({"phase": "lm_kernels", "failed": checks[-1]})
            raise SystemExit(f"kernel {name} disagrees: {checks[-1]}")

    def norm(shape, dt, label=None, offset=0):
        # offset > 0: x and scale are views that many elements into their
        # buffers, so rows and scale start off their 16-byte boundaries
        n = math.prod(shape)
        x = randn((n + offset,), dt)[offset:].view(shape)
        s = randn((shape[-1] + offset,), dt)[offset:]
        check("rmsnorm", "rmsnorm", rmsnorm.rmsnorm, ref.rmsnorm_ref,
              (x, s, 1e-5), {}, label or list(shape) + (
                  [f"offset {offset}"] if offset else []))
        return x, s

    def attn(B, Sq, Sk, H, Hkv, d, causal, window, dt, label=None, dv=None):
        q, k, v = (randn((B, Sq, H, d), dt), randn((B, Sk, Hkv, d), dt),
                   randn((B, Sk, Hkv, dv or d), dt))
        kw = dict(causal=causal, window=window)
        check("flash_attention", "attention",
              flash_attention.flash_attention_gqa,
              ref.flash_attention_gqa_ref, (q, k, v), kw,
              label or [B, Sq, Sk, H, Hkv, d, dv or d, causal, window])
        return q, k, v

    def swa(B, S, H, Hkv, d, w, dt, label=None):
        q, k, v = (randn((B, S, H, d), dt), randn((B, S, Hkv, d), dt),
                   randn((B, S, Hkv, d), dt))
        check("swa_attention", "attention", swa_attention.swa_attention,
              ref.swa_attention_ref, (q, k, v), dict(window=w),
              label or [B, S, H, Hkv, d, w])
        if not torch.equal(
                swa_attention.swa_attention(q, k, v, window=w),
                flash_attention.flash_attention_gqa(q, k, v, causal=True,
                                                    window=w)):
            raise SystemExit("swa_attention differs from flash_attention "
                             "with the same window")
        return q, k, v

    for dt in (torch.float32, torch.bfloat16):
        for shape in [(1, 8), (130, 32), (3, 5, 256), (7, 4096),
                      (2, 7, 14_000)]:
            norm(shape, dt)
        for case in [(2, 64, 64, 1, 1, 32, True, 0),
                     (2, 100, 100, 4, 2, 64, True, 0),
                     (1, 24, 130, 8, 2, 128, True, 0),
                     (2, 96, 96, 4, 1, 128, True, 24),
                     (1, 40, 70, 2, 2, 32, False, 0),       # ROADMAP C1
                     (1, 70, 70, 2, 1, 64, False, 16),
                     *ATTN_EDGES]:
            attn(*case, dt)
        for case in [(2, 64, 1, 1, 32, 16), (1, 256, 4, 2, 128, 64),
                     (1, 1024, 8, 2, 128, 256)]:
            swa(*case, dt)
        for shape, offset in NORM_EDGES:
            norm(shape, dt, offset=offset)
        # more (batch, head) pairs than a 2-D grid's 65,535: one grid axis
        attn(1, 4, 4, 70_000, 1, 32, True, 0, dt)
    # f32 at every width pair it takes, past one query tile (128 rows, 192
    # at head dim 128)
    for d, dv in sorted(flash_attention.WIDTHS[torch.float32]):
        attn(2, 200, 230, 4, 2, d, True, 0, torch.float32, dv=dv)
        attn(1, 70, 90, 2, 2, d, False, 0, torch.float32, dv=dv)

    # the serving path's own tensors, bf16: checked, then timed
    bf = torch.bfloat16
    mem_rate, f32_rate, bf16_rate, tf32_rate = peaks(
        torch.cuda.get_device_name(0))[:4]
    D, H, Hkv, hd, w = 4096, 32, 8, 128, 8192
    x, s = norm((SERVE_B, SERVE_S, D), bf, "serve (4, 2048, 4096)")
    q, k, v = attn(SERVE_B, SERVE_S, SERVE_S, H, Hkv, hd, True, 0, bf,
                   "serve prefill (4, 2048, 32/8, 128)")
    qs, ks, vs = swa(SWA_B, SWA_S, H, Hkv, hd, w, bf,
                     "swa prefill (1, 16384, 32/8, 128), w 8192")
    f32 = torch.float32
    qf, kf, vf = attn(SERVE_B, SERVE_S, SERVE_S, H, Hkv, hd, True, 0, f32,
                      "serve prefill shape in f32 (4, 2048, 32/8, 128)")
    qsf, ksf, vsf = swa(SWA_B, SWA_S, H, Hkv, hd, w, f32,
                        "swa prefill shape in f32 (1, 16384, 32/8, 128), "
                        "w 8192")
    # one PyTorch call each, as yardsticks: (B, H, S, d) layouts and, for
    # the band, kv heads expanded and a boolean mask, made before timing
    qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qsT = qs.transpose(1, 2).contiguous()
    ksT, vsT = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                .contiguous() for t in (ks, vs))
    i = torch.arange(SWA_S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)

    def swa_library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qsT, ksT, vsT,
                                                  attn_mask=band)

    n_norm = x.numel()
    norm_bytes = 2 * n_norm * 2 + D * 2
    f_bytes, f_ops = attention_work(SERVE_B, SERVE_S, SERVE_S, H, Hkv, hd,
                                    True, 0, 2)
    s_bytes, s_ops = attention_work(SWA_B, SWA_S, SWA_S, H, Hkv, hd, True,
                                    w, 2)
    timed = {
        "rmsnorm": (
            [SERVE_B, SERVE_S, D], norm_bytes, 4 * n_norm, f32_rate, 20,
            lambda: rmsnorm.rmsnorm(x, s, 1e-5),
            lambda: ref.rmsnorm_ref(x, s, 1e-5),
            lambda: F.rms_norm(x, (D,), weight=s, eps=1e-5),
            "F.rms_norm"),
        "flash_attention": (
            [SERVE_B, SERVE_S, H, Hkv, hd], f_bytes, f_ops, bf16_rate, 5,
            lambda: flash_attention.flash_attention_gqa(q, k, v),
            lambda: ref.flash_attention_gqa_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qT, kT, vT, is_causal=True, enable_gqa=True),
            "F.scaled_dot_product_attention(is_causal=True, "
            "enable_gqa=True)"),
        "swa_attention": (
            [SWA_B, SWA_S, H, Hkv, hd, w], s_bytes, s_ops, bf16_rate, 3,
            lambda: swa_attention.swa_attention(qs, ks, vs, window=w),
            lambda: ref.swa_attention_ref(qs, ks, vs, window=w),
            swa_library,
            "F.scaled_dot_product_attention(attn_mask=band), efficient "
            "backend, kv heads expanded"),
    }
    # the f32 program at the same shapes: three TF32 products a product
    # at the TF32 rate (kernel_bound), the CUDA cores' f32 bound beside.
    # SDPA in f32 with the kv heads expanded, as zoo_kernels times it (with
    # enable_gqa it takes a slower backend in f32: timed beside)
    qfT, kfT, vfT = (t.transpose(1, 2).contiguous() for t in (qf, kf, vf))
    kfE, vfE = (t.repeat_interleave(H // Hkv, dim=1) for t in (kfT, vfT))
    timed["flash_attention f32"] = (
        [SERVE_B, SERVE_S, H, Hkv, hd], 2 * f_bytes, 3 * f_ops, tf32_rate, 3,
        lambda: flash_attention.flash_attention_gqa(qf, kf, vf),
        lambda: ref.flash_attention_gqa_ref(qf, kf, vf),
        lambda: F.scaled_dot_product_attention(qfT, kfE, vfE, is_causal=True),
        "F.scaled_dot_product_attention(is_causal=True), kv heads expanded, "
        "f32")
    qsfT = qsf.transpose(1, 2).contiguous()
    ksfT, vsfT = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  .contiguous() for t in (ksf, vsf))

    def swa_library_f32():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qsfT, ksfT, vsfT,
                                                  attn_mask=band)

    timed["swa_attention f32"] = (
        [SWA_B, SWA_S, H, Hkv, hd, w], 2 * s_bytes, 3 * s_ops, tf32_rate, 3,
        lambda: swa_attention.swa_attention(qsf, ksf, vsf, window=w),
        lambda: ref.swa_attention_ref(qsf, ksf, vsf, window=w),
        swa_library_f32,
        "F.scaled_dot_product_attention(attn_mask=band), efficient "
        "backend, kv heads expanded, f32")
    table = {}
    for name, (shape, nbytes, nops, rate, iters, kernel, plain, library,
               lib_name) in timed.items():
        t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / rate * 1e3
        dt = f32 if name.endswith("f32") else bf
        table[name] = {
            "shape": shape, "dtype": str(dt).split(".")[1],
            "max_abs_err": worst[name],
            "ms": cuda_ms(kernel, iters, 1),
            "plain_ms": cuda_ms(plain, iters, 1),
            "library_ms": cuda_ms(library, iters, 1),
            "library": lib_name,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": nops}
        if name != "rmsnorm":
            table[name]["program"] = flash_attention.program(dt)
        if dt == f32:
            table[name]["bound_ms_f32_cuda_cores"] = nops / 3 / f32_rate * 1e3
    table["flash_attention f32"]["library_enable_gqa_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(
            qfT, kfT, vfT, is_causal=True, enable_gqa=True), 3, 1)
    del kfE, vfE
    for name in ("flash_attention", "swa_attention"):
        table[name]["f32"] = table.pop(name + " f32")
    _profile_bwd_bf16()
    emit({"phase": "lm_kernels", "checks": len(checks),
          "all_ok": all(c["ok"] for c in checks),
          "tolerances": {f"{k[0]} {str(k[1]).split('.')[1]}": v
                         for k, v in LM_TOL.items()},
          "timed": table,
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate,
                    "bf16_flops": bf16_rate, "tf32_flops": tf32_rate}})
    return table


# each CUDA launch's device time of the bf16 backward kernels at their
# timed shapes (TRAIN_ATTN_BF16_CASES' first TRAIN_ATTN_BF16_TIMED,
# TRAIN_NORM_BF16_CASES), by label: taken in lm_kernels, whose process
# has not yet run the later phases, after which this process's profiler
# sees no device events, and printed with lm_train_kernels' bf16 rows
BWD_BF16_DEVICE: dict = {}


def _profile_bwd_bf16() -> None:
    g = torch.Generator(device="cuda").manual_seed(32)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    for B, Sq, Sk, H, Hkv, d, causal, w, label in TRAIN_ATTN_BF16_CASES[
            :TRAIN_ATTN_BF16_TIMED]:
        d, dv = (d, d) if isinstance(d, int) else d
        q, k, v = randn(B, Sq, H, d), randn(B, Sk, Hkv, d), randn(B, Sk, Hkv,
                                                                  dv)
        do = randn(B, Sq, H, dv)
        kw = dict(causal=causal, window=w, scale=None)
        o, lse = flash_attention.attention(q, k, v, with_lse=True, **kw)
        BWD_BF16_DEVICE[label] = profile_calls(
            lambda: flash_attention.attention_bwd(q, k, v, o, lse, do, **kw),
            3)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for R, D, gr, label in TRAIN_NORM_BF16_CASES:
        x, dy = randn(R, D), randn(R, D)
        s = (1.0 + 0.1 * randn(*((gr, D) if gr > 1 else (D,))).float()
             ).bfloat16()
        BWD_BF16_DEVICE[label] = profile_calls(
            lambda: rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5), 5)
        del x, dy, s


def _by_launch(label: str) -> dict:
    """A timed bf16 row's device time by launch, from BWD_BF16_DEVICE."""
    dev = BWD_BF16_DEVICE.get(label)
    if not dev or not dev["kernels_us"]:
        return {"device_ms_by_launch": "not measured (the profiler saw no "
                                       "device events)"}
    return {"device_ms": dev["device_ms"],
            "device_ms_by_launch": {k: v / 1e3 for k, v in
                                    dev["kernels_us"].items()}}


def phase_lm_agree() -> dict:
    """The llama3-8b and llama3-8b-swa smoke configs in f32, from the same
    numpy weights, on the CPU and on the card: prefill logits within
    AGREE_TOL, and a ServeEngine's 16 greedy tokens identical. The swa
    prompts take the banded path (S = 2w) and the masked one (S < 2w)."""
    out = {}
    for name, cases in (("llama3-8b", [(24, "flash_attention")]),
                        ("llama3-8b-swa", [(32, "swa_attention"),
                                           (24, "flash_attention")])):
        cfg = get_arch(name, smoke=True)
        weights = params_to_numpy(init_lm_params(cfg, seed=5, device="cpu"))
        params = {dev: params_from_numpy(weights, device=dev)
                  for dev in ("cpu", "cuda")}
        rng = np.random.default_rng(6)
        rec = {}
        for S, path in cases:
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
            want = make_prefill(cfg)(params["cpu"], toks)
            ops.reset_launches()
            got = make_prefill(cfg)(params["cuda"], toks.cuda())
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            err = float((got.cpu() - want).abs().max())
            rec[f"prefill S={S}"] = {"max_abs_err": err,
                                     "launches": launches}
            if launches[path] != cfg.num_layers or launches["rmsnorm"] != (
                    2 * cfg.num_layers + 1):
                raise SystemExit(f"{name} S={S}: the card's prefill did not "
                                 f"take the {path} path: {launches}")
            if not torch.allclose(got.cpu(), want, **AGREE_TOL):
                raise SystemExit(f"{name} S={S}: the card's prefill logits "
                                 f"differ from the CPU's by {err}")
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)))
        tokens = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(cfg, params[dev], max_seq=32, batch=2,
                              device=dev)
            logits = eng.feed(prompt)
            tokens[dev] = eng.generate(16, first_logits=logits).cpu()
        rec["greedy_tokens_equal"] = bool(torch.equal(tokens["cpu"],
                                                      tokens["cuda"]))
        out[name] = rec
        if not rec["greedy_tokens_equal"]:
            raise SystemExit(f"{name}: greedy tokens differ on the card: "
                             f"{tokens}")
    emit({"phase": "lm_agree", "tolerance": AGREE_TOL, "configs": out})
    return out


def _timed(fn):
    """(result, ms by CUDA events, wall s) of ``fn()``, synchronized."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def _prompt_gap(engine_logits, prefill_logits):
    """max |diff| / max |logit|, and whether every greedy pick agrees or
    is a near tie (the engine's pick within twice that difference of the
    prefill's maximum)."""
    e, p = engine_logits.float(), prefill_logits.float()
    diff = (e - p).abs().max()
    pick_e, pick_p = e.argmax(-1), p.argmax(-1)
    gap = p.max(-1).values - p.gather(1, pick_e[:, None])[:, 0]
    return {"rel": float(diff / p.abs().max()), "max_abs_diff": float(diff),
            "argmax_agree": f"{int((pick_e == pick_p).sum())}/{len(p)}",
            "picks_ok": bool((gap <= 2 * diff).all()),
            "pick_gaps": gap.tolist()}


def phase_serve() -> dict:
    """The serving path at full width and depth, bf16, weights drawn on the
    card: llama3-8b prefill at (4, 2048), a batch-4 engine feeding 32
    prompt tokens and generating 32, then the llama3-8b-swa prefill at
    (1, 16384) over the same weights (the same backbone)."""
    cfg, cfg_swa = get_arch("llama3-8b"), get_arch("llama3-8b-swa")
    L, bf = cfg.num_layers, torch.bfloat16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms, _ = _timed(lambda: init_lm_params(cfg, seed=0, dtype=bf,
                                                       device="cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    if n_params != cfg.param_count() + cfg.d_model:     # + final_norm
        raise SystemExit(f"llama3-8b has {n_params} weights, not "
                         f"{cfg.param_count() + cfg.d_model}")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=g, device="cuda")
    prefill = make_prefill(cfg)
    prefill(params, tokens[:, :128])                    # warm-up
    launches = {}

    ops.reset_launches()
    logits, prefill_ms, _ = _timed(lambda: prefill(params, tokens))
    launches["prefill"] = dict(ops.LAUNCHES)
    if tuple(logits.shape) != (SERVE_B, SERVE_S, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit(f"prefill logits {tuple(logits.shape)} are not "
                         f"finite or not of the expected shape")
    at_prompt = logits[:, PROMPT - 1].float()
    head_2k = logits[0].clone()
    del logits
    torch.cuda.synchronize()

    eng = ServeEngine(cfg, params, max_seq=PROMPT + GEN + 1, batch=SERVE_B,
                      dtype=bf, device="cuda")
    ops.reset_launches()
    first, feed_ms, _ = _timed(lambda: eng.feed(tokens[:, :PROMPT]))
    launches["feed"] = dict(ops.LAUNCHES)
    ops.reset_launches()
    generated, gen_ms, gen_wall = _timed(
        lambda: eng.generate(GEN, first_logits=first))
    launches["generate"] = dict(ops.LAUNCHES)
    main_launches = {k: launches["prefill"][k] + launches["feed"][k]
                     + launches["generate"][k] for k in ops.LAUNCHES}

    # the engine's logits at the last prompt position against the
    # prefill's: bf16 through 32 layers, and the decode attention (plain
    # _sdpa) rounds scores and probabilities to bf16 where the prefill
    # kernel keeps them in f32
    gap = _prompt_gap(first, at_prompt)
    del eng, first

    if (launches["prefill"]["flash_attention"] != L
            or launches["prefill"]["rmsnorm"] != 2 * L + 1
            or launches["feed"]["rmsnorm"] != PROMPT * (2 * L + 1)
            or launches["generate"]["rmsnorm"] != GEN * (2 * L + 1)
            or launches["feed"]["flash_attention"]
            or launches["generate"]["flash_attention"]):
        raise SystemExit(f"serving launches: {launches}")
    if gap["rel"] > SERVE_REL_TOL or not gap["picks_ok"]:
        raise SystemExit(f"the engine's prompt logits differ from the "
                         f"prefill's: {gap}")
    if tuple(generated.shape) != (SERVE_B, GEN) or not bool(
            ((generated >= 0) & (generated < cfg.vocab_size)).all()):
        raise SystemExit(f"generated {tuple(generated.shape)} tokens out of "
                         f"range")

    # the sliding-window variant over the same weights, through the band
    swa_tokens = torch.randint(0, cfg.vocab_size, (SWA_B, SWA_S),
                               generator=g, device="cuda")
    swa_tokens[0, :SERVE_S] = tokens[0]
    ops.reset_launches()
    swa_logits, swa_ms, _ = _timed(
        lambda: make_prefill(cfg_swa)(params, swa_tokens))
    launches["swa_prefill"] = dict(ops.LAUNCHES)
    if (launches["swa_prefill"]["swa_attention"] != L
            or launches["swa_prefill"]["flash_attention"]
            or launches["swa_prefill"]["rmsnorm"] != 2 * L + 1):
        raise SystemExit(f"swa prefill launches: {launches['swa_prefill']}")
    if tuple(swa_logits.shape) != (SWA_B, SWA_S, cfg.vocab_size) or not bool(
            torch.isfinite(swa_logits).all()):
        raise SystemExit("swa prefill logits are not finite or not of the "
                         "expected shape")
    # below the window the band keeps every earlier key, so the first
    # 2,048 positions must repeat the full-attention prefill of the same
    # tokens (bf16, other matmul shapes)
    swa_rel = float((swa_logits[0, :SERVE_S].float() - head_2k.float())
                    .abs().max() / head_2k.float().abs().max())
    if swa_rel > SERVE_REL_TOL:
        raise SystemExit(f"swa prefill below the window differs from the "
                         f"full prefill: rel {swa_rel}")
    del swa_logits, head_2k
    peak = torch.cuda.max_memory_allocated()
    rec = {"phase": "serve", "arch": cfg.name, "layers": L, "cut": None,
           "dtype": "bfloat16",
           "params": n_params, "weights_bytes": weight_bytes,
           "init_ms": init_ms,
           "prefill": {"batch": SERVE_B, "seq": SERVE_S, "ms": prefill_ms,
                       "tokens_per_s": SERVE_B * SERVE_S / prefill_ms * 1e3},
           "engine": {"batch": SERVE_B, "prompt": PROMPT, "generated": GEN,
                      "feed_ms_per_step": feed_ms / PROMPT,
                      "decode_ms_per_step": gen_ms / GEN,
                      "decode_wall_s": gen_wall,
                      "step_bytes_bound_ms": weight_bytes / peaks(
                          torch.cuda.get_device_name(0))[0] * 1e3,
                      "prompt_logits": {**gap,
                                        "tolerance_rel": SERVE_REL_TOL}},
           "swa_prefill": {"arch": cfg_swa.name, "batch": SWA_B,
                           "seq": SWA_S, "window": cfg_swa.sliding_window,
                           "ms": swa_ms,
                           "tokens_per_s": SWA_B * SWA_S / swa_ms * 1e3,
                           "below_window_rel_err": swa_rel},
           "peak_memory_bytes": peak, "launches": launches}
    emit(rec)
    del params
    torch.cuda.empty_cache()
    return {"main": main_launches, "swa": launches["swa_prefill"]}


# ---------------------------------------------------------------------------
# Mamba2 serving (slice 3)
# ---------------------------------------------------------------------------
def phase_ssm_kernels(gen) -> tuple:
    """ssd_scan against the sequential plain version on the card, in f32
    and bf16, bitwise equal across two launches; then the serving path's
    own tensor (B = 4, H = 80, S = 2,048, P = 64, N = 128, chunk 64, f32,
    one group), checked and timed beside its bound and the plain
    version, with its CUDA launches per call and each launch's device
    time from the profiler. The program (``PROGRAM``) runs its products on
    the tensor cores in split TF32, so the bound is the larger of its
    bytes over the memory rate and its flops over the TF32 rate; the
    flops over the CUDA cores' f32 rate stand beside it. No single
    PyTorch call computes the SSD, so there is no library yardstick. Also
    rmsnorm against its plain version at the shapes mamba2-2.7b gives it
    (rows of d_model 2560 and d_inner 5120, in prefill and in decode)."""
    checks = []
    worst = 0.0
    norm_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(SERVE_B, SERVE_S, 2560), (SERVE_B, SERVE_S, 5120),
                      (SERVE_B, 2560), (SERVE_B, 5120)]:
            xn = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            sn = torch.randn(shape[-1:], generator=gen,
                             device="cuda").to(dtype)
            n1 = rmsnorm.rmsnorm(xn, sn, 1e-5)
            n2 = rmsnorm.rmsnorm(xn, sn, 1e-5)
            want = ref.rmsnorm_ref(xn, sn, 1e-5)
            torch.cuda.synchronize()
            err = float((n1.float() - want.float()).abs().max())
            norm_worst = max(norm_worst, err)
            repeat = bool(torch.equal(n1, n2))
            ok = repeat and bool(torch.allclose(
                n1.float(), want.float(), **LM_TOL["rmsnorm", dtype]))
            checks.append({"kernel": "rmsnorm", "inputs": list(shape),
                           "dtype": str(dtype).split(".")[1],
                           "max_abs_err": err, "max_abs_ref": float(
                               want.float().abs().max()),
                           "bitwise_repeat": repeat, "finite": True,
                           "ok": ok})
            if not ok:
                emit({"phase": "ssm_kernels", "failed": checks[-1]})
                raise SystemExit(f"kernel rmsnorm disagrees: {checks[-1]}")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def check(BH, S, P, N, chunk, dtype, R=1, strong=False, label=None):
        nonlocal worst
        x, dt, a = randn(BH, S, P), F.softplus(randn(BH, S)), -torch.exp(
            randn(BH))
        if strong:      # dt * |a| in the hundreds: the decays underflow,
            dt, a = dt * 30 + 5, a * 20     # exp above the diagonal overflows
        b, c = randn(BH // R, S, N), randn(BH // R, S, N)
        x, dt, b, c = (t.to(dtype) for t in (x, dt, b, c))
        y1, h1 = ops.ssd_scan(x, dt, a, b, c, chunk=chunk)
        y2, h2 = ops.ssd_scan(x, dt, a, b, c, chunk=chunk)
        yr, hr = ref.ssd_scan_ref(x, dt, a, b.repeat_interleave(R, 0),
                                  c.repeat_interleave(R, 0))
        torch.cuda.synchronize()
        err = max(float((y1.float() - yr.float()).abs().max()),
                  float((h1 - hr).abs().max()))
        worst = max(worst, err)
        repeat = bool(torch.equal(y1, y2) and torch.equal(h1, h2))
        finite = bool(torch.isfinite(y1.float()).all()
                      and torch.isfinite(h1).all())
        ok = repeat and finite and bool(
            torch.allclose(y1.float(), yr.float(), **SSM_TOL[dtype])
            and torch.allclose(h1, hr, **SSM_TOL[dtype]))
        checks.append({"kernel": "ssd_scan",
                       "inputs": label or [BH, S, P, N, chunk, R, strong],
                       "dtype": str(dtype).split(".")[1],
                       "max_abs_err": err, "max_abs_ref": float(
                           yr.float().abs().max()),
                       "bitwise_repeat": repeat, "finite": finite, "ok": ok})
        if not ok:
            emit({"phase": "ssm_kernels", "failed": checks[-1]})
            raise SystemExit(f"kernel ssd_scan disagrees: {checks[-1]}")
        return x, dt, a, b, c

    for dtype in (torch.float32, torch.bfloat16):
        for S, chunk in [(64, 16), (96, 32), (100, 32), (8, 8), (130, 64),
                         (37, 8)]:              # tests/test_kernels.py:167
            check(3, S, 8, 4, chunk, dtype)
        check(4, 200, 64, 128, 64, dtype)
        check(6, 77, 64, 32, 16, dtype)         # the smoke config's N, chunk
        check(16, 96, 64, 128, 64, dtype, R=8)  # grouped B and C
        check(5, 128, 64, 128, 64, dtype, strong=True)
        check(4, 100, 64, 128, 32, dtype, R=2, strong=True)
        check(3, 64, 37, 20, 16, dtype)         # zero-padded tiles
        check(2, 64, 5, 3, 8, dtype)

    # the serving path's own tensor, as mamba_forward hands it over
    BH, S, P, N, Q, R = SERVE_B * 80, SERVE_S, 64, 128, 64, 80
    x, dt, a, b, c = check(BH, S, P, N, Q, torch.float32, R=R,
                           label="serve (320, 2048, 64, 128), chunk 64, "
                                 "80 heads per group")
    br, cr = b.repeat_interleave(R, 0), c.repeat_interleave(R, 0)
    mem_rate, f32_rate, _, tf32_rate = peaks(torch.cuda.get_device_name(0))[:4]
    nbytes, nops = ssd_work(BH, S, P, N, BH // R, Q, 4)
    t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / tf32_rate * 1e3
    run = lambda: ssd_scan.ssd_scan(x, dt, a, b, c, chunk=Q)  # noqa: E731
    dev = profile_calls(run, 5)
    if dev["cuda_launches_per_call"] != ssd_scan.CUDA_LAUNCHES:
        raise SystemExit(f"ssd_scan made {dev['cuda_launches_per_call']} "
                         f"CUDA launches per call: {dev}")
    table = {"ssd_scan": {
        "shape": [BH, S, P, N, Q, R], "dtype": "float32",
        "program": ssd_scan.PROGRAM,
        "max_abs_err": worst,
        "ms": cuda_ms(run, 10, 2),
        "plain_ms": cuda_ms(lambda: ref.ssd_scan_ref(x, dt, a, br, cr), 2, 1),
        "library_ms": None,
        "library": "none: no single PyTorch call computes the chunked SSD",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": nops,
        "bound_ms_f32_cuda_cores": nops / f32_rate * 1e3,
        "device_ms": dev["device_ms"],
        "cuda_launches_per_call": dev["cuda_launches_per_call"],
        "launch_device_us": dev["kernels_us"]}}
    del x, dt, a, b, c, br, cr
    torch.cuda.empty_cache()
    _profile_ssd_bwd()
    emit({"phase": "ssm_kernels", "checks": len(checks),
          "rmsnorm_max_abs_err": norm_worst,
          "rmsnorm_tolerances": {str(k[1]).split(".")[1]: v
                                 for k, v in LM_TOL.items()
                                 if k[0] == "rmsnorm"},
          "all_ok": all(c["ok"] for c in checks),
          "tolerances": {str(k).split(".")[1]: v for k, v in SSM_TOL.items()},
          "worst": [{k: c[k] for k in ("kernel", "inputs", "dtype",
                                       "max_abs_err", "max_abs_ref")}
                    for c in sorted(checks, key=lambda c: -c["max_abs_err"])
                    [:3]],
          "timed": table,
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate,
                    "tf32_flops": tf32_rate}})
    return table, norm_worst


# each CUDA launch's device time of ssd_scan_bwd at SSD_BWD_CASES' timed
# shapes, by label: taken in ssm_kernels, whose process has not yet run
# the later phases, after which this process's profiler sees no device
# events, and printed with lm_train_kernels' timed rows
SSD_BWD_DEVICE: dict = {}


def _profile_ssd_bwd() -> None:
    g = torch.Generator(device="cuda").manual_seed(27)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    for BH, S, P, N, Q, R, _, strong, label in SSD_BWD_CASES[:SSD_BWD_TIMED]:
        x, dt, a, b, c = _ssd_inputs(randn, BH, S, P, N, R, strong)
        dy = randn(BH, S, P)
        _, _, states = ssd_scan.ssd_scan(x, dt, a, b, c, chunk=Q,
                                         keep_states=True)
        SSD_BWD_DEVICE[label] = profile_calls(
            lambda: ssd_scan.ssd_scan_bwd(x, dt, a, b, c, states, dy, None,
                                          chunk=Q), 3)
        del x, dt, a, b, c, dy, states
        torch.cuda.empty_cache()


def phase_ssm_agree() -> dict:
    """The mamba2-2.7b smoke config in f32, from the same numpy weights, on
    the CPU (the sequential plain SSD) and on the card (the chunked
    kernel): prefill logits within AGREE_TOL at a ragged and a whole-chunk
    S, and a ServeEngine's 16 greedy tokens identical."""
    cfg = get_arch("mamba2-2.7b", smoke=True)
    L = cfg.num_layers
    weights = params_to_numpy(init_lm_params(cfg, seed=5, device="cpu"))
    params = {dev: params_from_numpy(weights, device=dev)
              for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(7)
    rec = {}
    for S in (40, 64):                  # 40 % 16 != 0: ops.ssd_scan pads
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
        want = make_prefill(cfg)(params["cpu"], toks)
        ops.reset_launches()
        got = make_prefill(cfg)(params["cuda"], toks.cuda())
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        err = float((got.cpu() - want).abs().max())
        rec[f"prefill S={S}"] = {"max_abs_err": err, "launches": launches}
        if launches["ssd_scan"] != L or launches["rmsnorm"] != 2 * L + 1:
            raise SystemExit(f"mamba S={S}: the card's prefill did not take "
                             f"the ssd_scan path: {launches}")
        if not torch.allclose(got.cpu(), want, **AGREE_TOL):
            raise SystemExit(f"mamba S={S}: the card's prefill logits differ "
                             f"from the CPU's by {err}")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)))
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params[dev], max_seq=32, batch=2, device=dev)
        logits = eng.feed(prompt)
        tokens[dev] = eng.generate(16, first_logits=logits).cpu()
    rec["greedy_tokens_equal"] = bool(torch.equal(tokens["cpu"],
                                                  tokens["cuda"]))
    emit({"phase": "ssm_agree", "arch": cfg.name, "tolerance": AGREE_TOL,
          **rec})
    if not rec["greedy_tokens_equal"]:
        raise SystemExit(f"mamba: greedy tokens differ on the card: {tokens}")
    return rec


def phase_ssm_serve() -> dict:
    """mamba2-2.7b at full width and depth, weights drawn on the card in
    bf16: first, the same weights in f32, the engine's logits after a
    32-token prompt (the O(1) recurrence) against the prefill's at that
    position (the chunked kernel); then, in bf16, the prefill at
    (4, 2048), a batch-4 engine feeding the 32 prompt tokens and
    generating 32, and the same comparison."""
    cfg = get_arch("mamba2-2.7b")
    L, bf = cfg.num_layers, torch.bfloat16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms, _ = _timed(lambda: init_lm_params(cfg, seed=0, dtype=bf,
                                                       device="cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    if n_params != cfg.param_count() + SSM_TREE_EXTRA:
        raise SystemExit(f"mamba2-2.7b has {n_params} weights, not "
                         f"{cfg.param_count() + SSM_TREE_EXTRA}")
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=g, device="cuda")
    prefill = make_prefill(cfg)

    # f32 at full width: the recurrence against the kernel, and the f32
    # logits that the bf16 paths are then measured against
    params32 = tree_map(lambda t: t.float(), params)
    want32 = prefill(params32, tokens[:, :PROMPT])[:, -1]
    eng32 = ServeEngine(cfg, params32, max_seq=PROMPT, batch=SERVE_B,
                        device="cuda")
    f32_gap = _prompt_gap(eng32.feed(tokens[:, :PROMPT]), want32)
    del params32, eng32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()    # the peak of bf16 serving alone
    if f32_gap["rel"] > SSM_F32_REL_TOL or not f32_gap["picks_ok"]:
        raise SystemExit(f"f32 mamba2-2.7b: the engine's prompt logits differ "
                         f"from the prefill's: {f32_gap}")

    prefill(params, tokens[:, :128])                    # warm-up
    launches = {}

    ops.reset_launches()
    logits, prefill_ms, _ = _timed(lambda: prefill(params, tokens))
    launches["prefill"] = dict(ops.LAUNCHES)
    if tuple(logits.shape) != (SERVE_B, SERVE_S, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit(f"mamba prefill logits {tuple(logits.shape)} are not "
                         f"finite or not of the expected shape")
    at_prompt = logits[:, PROMPT - 1].float()
    del logits
    # the first full-size call above, like llama's in `serve`, pays the
    # allocator's first requests (the kernel's scratch, the activations);
    # a second call gives the steady cost beside it
    _, steady_ms, _ = _timed(lambda: prefill(params, tokens))

    eng = ServeEngine(cfg, params, max_seq=PROMPT + GEN + 1, batch=SERVE_B,
                      dtype=bf, device="cuda")
    ops.reset_launches()
    first, feed_ms, _ = _timed(lambda: eng.feed(tokens[:, :PROMPT]))
    launches["feed"] = dict(ops.LAUNCHES)
    ops.reset_launches()
    generated, gen_ms, gen_wall = _timed(
        lambda: eng.generate(GEN, first_logits=first))
    launches["generate"] = dict(ops.LAUNCHES)
    main_launches = {k: launches["prefill"][k] + launches["feed"][k]
                     + launches["generate"][k] for k in ops.LAUNCHES}
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(eng.cache))

    # the engine's logits after the prompt (recurrence) against the
    # prefill's at the same position (chunked kernel), and each against f32
    bf16_gap = _prompt_gap(first, at_prompt)
    vs_f32 = {"prefill": _prompt_gap(at_prompt, want32)["rel"],
              "engine": _prompt_gap(first, want32)["rel"]}
    del eng, first
    peak = torch.cuda.max_memory_allocated()
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    rec = {"phase": "ssm_serve", "arch": cfg.name, "layers": L,
           "d_model": cfg.d_model, "cut": None, "dtype": "bfloat16",
           "params": n_params, "param_count": cfg.param_count(),
           "weights_bytes": weight_bytes, "init_ms": init_ms,
           "f32_prompt_logits": {**f32_gap, "tolerance_rel": SSM_F32_REL_TOL},
           "prefill": {"batch": SERVE_B, "seq": SERVE_S, "ms": prefill_ms,
                       "steady_ms": steady_ms,
                       "tokens_per_s": SERVE_B * SERVE_S / prefill_ms * 1e3},
           "engine": {"batch": SERVE_B, "prompt": PROMPT, "generated": GEN,
                      "feed_ms_per_step": feed_ms / PROMPT,
                      "decode_ms_per_step": gen_ms / GEN,
                      "decode_wall_s": gen_wall,
                      "state_bytes": state_bytes,
                      "step_bytes_bound_ms": (weight_bytes + 2 * state_bytes)
                      / mem_rate * 1e3,
                      "prompt_logits": {**bf16_gap,
                                        "tolerance_rel": SSM_SERVE_REL_TOL},
                      "rel_to_f32_logits": vs_f32},
           "peak_memory_bytes": peak, "launches": launches}
    emit(rec)

    if (launches["prefill"]["ssd_scan"] != L
            or launches["prefill"]["rmsnorm"] != 2 * L + 1
            or launches["feed"]["ssd_scan"]
            or launches["generate"]["ssd_scan"]
            or launches["feed"]["rmsnorm"] != PROMPT * (2 * L + 1)
            or launches["generate"]["rmsnorm"] != GEN * (2 * L + 1)):
        raise SystemExit(f"mamba serving launches: {launches}")
    if bf16_gap["rel"] > SSM_SERVE_REL_TOL or not bf16_gap["picks_ok"]:
        raise SystemExit(f"the mamba engine's prompt logits differ from the "
                         f"prefill's: {bf16_gap}")
    if tuple(generated.shape) != (SERVE_B, GEN) or not bool(
            ((generated >= 0) & (generated < cfg.vocab_size)).all()):
        raise SystemExit(f"mamba generated {tuple(generated.shape)} tokens "
                         f"out of range")
    del params
    torch.cuda.empty_cache()
    return main_launches


# ---------------------------------------------------------------------------
# the serving zoo (slice 12)
# ---------------------------------------------------------------------------

ZOO = ("mixtral-8x22b", "deepseek-v2-236b", "hymba-1.5b", "internvl2-76b",
       "musicgen-large", "minitron-4b", "qwen1.5-110b", "llama3-405b")
# zoo_serve: the layers each config runs at full width (bf16 weights on
# one 80 GB card; the cut keeps each under ~21 GB), and the vision
# prefix of stub patch embeddings before the text
ZOO_LAYERS = {"hymba-1.5b": 32, "musicgen-large": 48, "minitron-4b": 32,
              "mixtral-8x22b": 4, "deepseek-v2-236b": 2, "internvl2-76b": 8,
              "qwen1.5-110b": 4, "llama3-405b": 2}
ZOO_PREFIX = 256             # internvl2-76b's NUM_PATCHES
ZOO_PROMPT, ZOO_GEN = 16, 16
ZOO_STEADY_CALLS = 3         # prefill calls averaged after the first
# zoo_serve's engine prompt logits against the prefill's, max |diff| over
# max |logit|. In f32 the two paths differ only in summation order and
# route every token to the same experts (as SSM_F32_REL_TOL). In bf16 the
# dense and MLA configs are held to SERVE_REL_TOL and hymba, with its SSM
# branch, to SSM_SERVE_REL_TOL; a MoE config's bf16 router logits come
# from a gemm in the prefill and a gemv in decode, so near-tied experts
# swap there (a different expert, not a rounding-sized change): its bf16
# gap is reported, its picks held, and its f32 gap is the gate.
ZOO_F32_REL_TOL = 1e-4


def _zoo_inputs(cfg, B, S, gen, device, prefix=0):
    """Tokens (B, S - prefix) (audio: (B, S, K)) and, for the vision
    backbone, ``prefix`` stub patch embeddings (B, prefix, D)."""
    shape = (B, S, 4) if cfg.modality == "audio" else (B, S - prefix)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device=device)
    kw = {}
    if prefix:
        kw["prefix_embeds"] = 0.02 * torch.randn(
            (B, prefix, cfg.d_model), generator=gen, device=device)
    return toks, kw


def phase_zoo_kernels(gen) -> dict:
    """The kernels at the shapes the serving zoo gives them, each against
    its plain version (bitwise repeatable), then timed beside the plain
    version, one PyTorch call and ``kernel_bound``: swa attention at
    hymba's (4, 2048, 25/5, 64), w = 1,024; flash attention at
    musicgen's (4, 2048, 32/32, 64) and llama3-405b's group of 16
    (4, 2048, 128/8, 128); MLA's (4, 2048, 128 heads, 192/128); each in
    bf16 and in f32 (the split-TF32 program, SDPA in f32 beside it);
    ssd_scan at hymba's (200, 2048, 64, 16), 50 heads a group; rmsnorm at
    (4, 2048, d) for every width d a full-size config norms
    (``norm_widths``), on inputs that have left the L2."""
    bf, f32 = torch.bfloat16, torch.float32
    card = peaks(torch.cuda.get_device_name(0))
    B, S = SERVE_B, SERVE_S

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def row(kernel, shape, dt, err, run, plain, library, lib_name,
            bound_shape, iters=5, device=False, timed=None):
        """``timed``: the (run, plain, library) to time, where they are
        not the checked ones (cold inputs)."""
        a, b = run(), run()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise SystemExit(f"{kernel} {shape}: two launches differ")
        run, plain, library = timed or (run, plain, library)
        bound = kernel_bound(kernel, bound_shape, dt, card)
        rec = {"kernel": kernel, "shape": list(shape),
               "dtype": str(dt).split(".")[1], "max_abs_err": err,
               "ms": cuda_ms(run, iters, 1),
               "plain_ms": cuda_ms(plain, max(1, iters // 2), 1),
               "library_ms": (None if library is None
                              else cuda_ms(library, iters, 1)),
               "library": lib_name, **bound}
        if device:
            # a short kernel's back-to-back time can be its wrapper's host
            # time: the device's time of it and of the library in a CUDA
            # graph, where a call also pays the writes the one before left
            # in the L2 (a profiler's kernel interval leaves them out)
            rec["graph_ms"] = graph_ms(run)
            rec["library_graph_ms"] = graph_ms(library)
        return rec

    def attn_case(kernel, shape, dt, window=0):
        Bq, Sq, H, Hkv, d, dv = shape
        q, k, v = (randn((Bq, Sq, H, d), dt), randn((Bq, Sq, Hkv, d), dt),
                   randn((Bq, Sq, Hkv, dv), dt))
        if kernel == "swa_attention":
            run = lambda: swa_attention.swa_attention(  # noqa: E731
                q, k, v, window=window)
            plain = lambda: ref.swa_attention_ref(  # noqa: E731
                q, k, v, window=window)
        else:
            run = lambda: flash_attention.flash_attention_gqa(  # noqa: E731
                q, k, v)
            plain = lambda: ref.flash_attention_gqa_ref(  # noqa: E731
                q, k, v)
        got, want = run(), plain()
        err = float((got.float() - want.float()).abs().max())
        tol = LM_TOL["attention", dt]
        if not torch.allclose(got.float(), want.float(), **tol):
            raise SystemExit(f"{kernel} {shape} {dt} disagrees: {err}")
        del got, want
        G = H // Hkv
        qT = q.transpose(1, 2)
        kT, vT = (t.transpose(1, 2).repeat_interleave(G, dim=1)
                  for t in (k, v))
        if window:
            i = torch.arange(Sq, device="cuda")
            band = (i[None, :] <= i[:, None]) & (
                i[None, :] > i[:, None] - window)
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qT, kT, vT, attn_mask=band)
            lib = "F.scaled_dot_product_attention(attn_mask=band)"
        else:
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qT, kT, vT, is_causal=True)
            lib = "F.scaled_dot_product_attention(is_causal=True)"
        if kernel == "swa_attention":
            bshape = (Bq, Sq, H, Hkv, d, window)
        else:
            bshape = (Bq, Sq, Sq, H, Hkv, d) + ((dv,) if dv != d else ())
        rec = row(kernel, shape, dt, err, run, plain, library,
                  lib + ", kv heads expanded" if G > 1 else lib, bshape,
                  iters=3 if dt == f32 else 5)
        rec["program"] = flash_attention.program(dt)
        return rec

    rows = []
    for dt in (bf, f32):
        rows += [
            attn_case("swa_attention", (B, S, 25, 5, 64, 64), dt,
                      window=1024),
            attn_case("flash_attention", (B, S, 32, 32, 64, 64), dt),
            attn_case("flash_attention", (B, S, 128, 8, 128, 128), dt),
            attn_case("flash_attention", (B, S, 128, 128, 192, 128), dt)]
        rows[-1]["label"] = "MLA (deepseek-v2-236b)"

    # ssd_scan as hymba's mamba_forward hands it over: 50 heads, 1 group
    BH, P, N, Q, R = B * 50, 64, 16, 64, 50
    x, b_, c_ = (randn((BH, S, P), f32), randn((BH // R, S, N), f32),
                 randn((BH // R, S, N), f32))
    dt = F.softplus(randn((BH, S), f32)) * 0.1
    a = -torch.exp(randn((BH,), f32))
    run = lambda: ssd_scan.ssd_scan(x, dt, a, b_, c_, chunk=Q)  # noqa: E731
    br, cr = b_.repeat_interleave(R, 0), c_.repeat_interleave(R, 0)
    plain = lambda: ref.ssd_scan_ref(x, dt, a, br, cr)  # noqa: E731
    (y, h), (yr, hr) = run(), plain()
    err = max(float((y - yr).abs().max()), float((h - hr).abs().max()))
    if not (torch.allclose(y, yr, **SSM_TOL[f32])
            and torch.allclose(h, hr, **SSM_TOL[f32])):
        raise SystemExit(f"ssd_scan at hymba's shape disagrees: {err}")
    rec = row("ssd_scan", (BH, S, P, N, Q, R), f32, err,
              lambda: run()[0], lambda: plain()[0], None,
              "none: no single PyTorch call computes the chunked SSD",
              (BH, S, P, N, Q, R), iters=10)
    rec["program"] = ssd_scan.PROGRAM
    rows.append(rec)

    # rmsnorm timed on cold inputs: x read from device memory, as between
    # a model's products, not from the L2 where a repeat would find it
    for d in norm_widths():
        xn, s = randn((B, S, d), bf), randn((d,), bf)
        got, want = rmsnorm.rmsnorm(xn, s, 1e-5), ref.rmsnorm_ref(xn, s, 1e-5)
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(),
                              **LM_TOL["rmsnorm", bf]):
            raise SystemExit(f"rmsnorm at d = {d} disagrees: {err}")
        xs = cold_inputs(lambda: randn((B, S, d), bf), 2 * xn.nbytes)
        rows.append(row(
            "rmsnorm", (B, S, d), bf, err,
            lambda: rmsnorm.rmsnorm(xn, s, 1e-5), None, None, "F.rms_norm",
            (B, S, d), iters=20, device=True, timed=(
                in_turn(lambda x: rmsnorm.rmsnorm(x, s, 1e-5), xs),
                in_turn(lambda x: ref.rmsnorm_ref(x, s, 1e-5), xs),
                in_turn(lambda x: F.rms_norm(x, (d,), weight=s, eps=1e-5),
                        xs))))
        rows[-1]["plan"] = rmsnorm.plan(d, bf)._asdict()
        rows[-1]["cold_inputs"] = len(xs)
        del xs
    emit({"phase": "zoo_kernels", "rows": rows,
          "tolerances": {"attention bf16": LM_TOL["attention", bf],
                         "attention f32": LM_TOL["attention", f32],
                         "ssd_scan f32": SSM_TOL[f32],
                         "rmsnorm bf16": LM_TOL["rmsnorm", bf]}})
    return rows


def _zoo_path(cfg, S) -> str:
    """The attention entry point a prefill of S positions takes."""
    if cfg.block_type == "ssm":
        return ""
    return "swa_attention" if takes_band(cfg, S) else "flash_attention"


def _zoo_norms(cfg) -> int:
    """rmsnorm launches of one forward over any number of positions: each
    layer's mixer norm, its FFN norm, a hybrid block's two branch norms,
    the SSM branch's gated output norm; then the final norm."""
    per = 1 + bool(cfg.d_ff or cfg.is_moe) + {
        "hybrid": 3, "ssm": 1}.get(cfg.block_type, 0)
    return cfg.num_layers * per + 1


def phase_zoo_agree() -> dict:
    """The eight smoke configs of the serving zoo in f32, from the same
    numpy weights, on the CPU and on the card: prefill logits and the MoE
    auxiliary loss within AGREE_TOL (each layer through its kernels: the
    attention entry point once a layer, hymba's ssd_scan once a layer),
    a ServeEngine's 16 greedy tokens identical; the two MoE configs also
    at capacity factor 1.25, where each layer's kept (token, k) set must
    be the CPU's exactly."""
    def forward(cfg, params, toks, kw, dev):
        ops.reset_launches()
        logits, aux, keeps = lm_forward(
            cfg, params, toks.to(dev), **{k: v.to(dev) for k, v in kw.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
        return (logits.cpu(), aux.cpu(), [k.cpu() for k in keeps],
                dict(ops.LAUNCHES))

    out = {}
    S = 32
    for name in ZOO:
        base = get_arch(name, smoke=True)
        variants = [("", base)]
        if base.is_moe:
            variants.append((" cf 1.25", dataclasses.replace(
                base, moe=dataclasses.replace(base.moe,
                                              capacity_factor=1.25))))
        weights = params_to_numpy(init_lm_params(base, seed=7, device="cpu"))
        params = {dev: params_from_numpy(weights, device=dev)
                  for dev in ("cpu", "cuda")}
        g = torch.Generator().manual_seed(8)
        toks, kw = _zoo_inputs(base, 2, S, g, "cpu",
                               prefix=8 if base.modality == "vision" else 0)
        for tag, cfg in variants:
            want, want_aux, want_keep, _ = forward(cfg, params["cpu"], toks,
                                                   kw, "cpu")
            got, aux, keep, launches = forward(cfg, params["cuda"], toks, kw,
                                               "cuda")
            err = float((got - want).abs().max())
            rec = {"prefill_max_abs_err": err, "aux": float(aux),
                   "aux_cpu": float(want_aux), "launches": launches}
            L = cfg.num_layers
            path = _zoo_path(cfg, want.shape[1])
            if (launches[path] != L or launches["rmsnorm"] != _zoo_norms(cfg)
                    or launches["ssd_scan"] != (
                        L if cfg.block_type == "hybrid" else 0)):
                raise SystemExit(f"{name}{tag}: the card's prefill did not "
                                 f"take its kernels: {launches}")
            if not torch.allclose(got, want, **AGREE_TOL) or not \
                    torch.allclose(aux, want_aux, **AGREE_TOL):
                raise SystemExit(f"{name}{tag}: the card's prefill differs "
                                 f"from the CPU's by {err} (aux {aux} vs "
                                 f"{want_aux})")
            if cfg.is_moe:
                same = len(keep) == len(want_keep) == L and all(
                    torch.equal(a, b) for a, b in zip(keep, want_keep))
                pairs = sum(k.numel() for k in keep)
                rec["kept_sets_equal"] = same
                rec["dropped_share"] = 1 - sum(
                    int(k.sum()) for k in keep) / pairs
                if not same:
                    raise SystemExit(f"{name}{tag}: the card kept other "
                                     f"(token, k) pairs than the CPU")
            out[name + tag] = rec
        prompt = toks[:, :5]
        tokens = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(base, params[dev], max_seq=32, batch=2,
                              device=dev)
            logits = eng.feed(prompt)
            tokens[dev] = eng.generate(16, first_logits=logits).cpu()
        same = bool(torch.equal(tokens["cpu"], tokens["cuda"]))
        out[name]["greedy_tokens_equal"] = same
        if not same:
            raise SystemExit(f"{name}: greedy tokens differ on the card: "
                             f"{tokens}")
    emit({"phase": "zoo_agree", "tolerance": AGREE_TOL, "configs": out})
    return out


def phase_zoo_serve() -> dict:
    """Each zoo config at full width in bf16, weights drawn on the card,
    depth cut only where one card cannot hold the model (``ZOO_LAYERS``):
    a warm-up prefill of 2,048 text tokens at (4, 2048), the timed shape;
    then the timed prefill at (4, 2048) — internvl2-76b 256 stub patch
    embeddings and 1,792 tokens — its first call and the mean of
    ``ZOO_STEADY_CALLS`` more; then a batch-4 engine feeding the first 16
    tokens and generating 16. The engine's logits at the last prompt
    position are held against the warm-up prefill's at that position (the
    same tokens; a prefix-free prefill, as the engine has no prefix path)
    as ``serve`` holds them, and each path's kernel launches are counted
    exactly. Each model is freed before the next. Per config: prefill ms
    and tokens/s, decode ms a step beside the bytes bound, peak memory,
    each kernel's launches, and for the MoE configs the share of
    (token, k) pairs dropped. Then the prompt logits again with the same
    model in f32 (``ZOO_F32_REL_TOL``), and the f32 prefill's second call
    timed with its launches counted exactly (the split-TF32 attention
    program). A config's launches sum the bf16 paths and the timed f32
    prefill."""
    bf = torch.bfloat16
    card = peaks(torch.cuda.get_device_name(0))
    B, S = SERVE_B, SERVE_S
    records, launches_by_model = {}, {}
    for name in ZOO:
        full = get_arch(name)
        L = ZOO_LAYERS[name]
        cfg = dataclasses.replace(full, num_layers=L)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, init_ms, _ = _timed(lambda: init_lm_params(
            cfg, seed=0, dtype=bf, device="cuda"))
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in tree_leaves(params))
        # a decode step reads every weight once but the embedding table,
        # of which it gathers B rows, and, with experts, only the experts
        # its B tokens pick: at most min(E, B K) of E a layer (fewer where
        # tokens share one; the floor counts B K)
        step_bytes = weight_bytes - params["embed"].numel() * 2
        if cfg.is_moe:
            E, K = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
            experts = sum(params["blocks"]["moe"][w].numel() * 2
                          for w in ("w_gate", "w_up", "w_down"))
            step_bytes -= experts * (E - min(E, B * K)) // E
        g = torch.Generator(device="cuda").manual_seed(3)
        text, _ = _zoo_inputs(cfg, B, S, g, "cuda")
        prefix = ZOO_PREFIX if cfg.modality == "vision" else 0
        toks, kw = text, {}
        if prefix:
            toks, kw = text[:, :S - prefix], {"prefix_embeds": (0.02 * (
                torch.randn((B, prefix, cfg.d_model), generator=g,
                            device="cuda"))).to(bf)}
        n_norm = _zoo_norms(cfg)

        # the warm-up at the timed shape, and the prompt logits to hold
        # the engine against
        logits, _, keeps = lm_forward(cfg, params, text)
        at_prompt = logits[:, ZOO_PROMPT - 1].float()
        del logits
        # a pair's bucket slot counts only the pairs before it in its group
        # (1,024 tokens of one row), so the prompt's 16 positions drop
        # nothing while the capacity is 16 or more, and the engine (groups
        # of one token) drops nothing: the comparison is drop-free
        if not all(bool(k.reshape(B, S, -1)[:, :ZOO_PROMPT].all())
                   for k in keeps):
            raise SystemExit(f"{name}: the prefill dropped a prompt token")
        ops.reset_launches()
        (logits, _, keeps), ms, _ = _timed(
            lambda: lm_forward(cfg, params, toks, **kw))
        pre_launches = dict(ops.LAUNCHES)
        want_shape = (B, S) + ((4, cfg.vocab_size) if cfg.modality == "audio"
                               else (cfg.vocab_size,))
        if tuple(logits.shape) != want_shape or not bool(
                torch.isfinite(logits).all()):
            raise SystemExit(f"{name}: prefill logits {tuple(logits.shape)} "
                             f"are not finite or not {want_shape}")
        del logits
        path = _zoo_path(cfg, S)
        if (pre_launches[path] != L or pre_launches["rmsnorm"] != n_norm
                or pre_launches["ssd_scan"] != (
                    L if cfg.block_type == "hybrid" else 0)):
            raise SystemExit(f"{name}: prefill launches {pre_launches}")

        def steady():
            for _ in range(ZOO_STEADY_CALLS):
                lm_apply(cfg, params, toks, **kw)
        _, steady_total, _ = _timed(steady)
        steady_ms = steady_total / ZOO_STEADY_CALLS

        eng = ServeEngine(cfg, params, max_seq=ZOO_PROMPT + ZOO_GEN + 1,
                          batch=B, dtype=bf, device="cuda")
        ops.reset_launches()
        first, feed_ms, _ = _timed(lambda: eng.feed(toks[:, :ZOO_PROMPT]))
        feed_launches = dict(ops.LAUNCHES)
        ops.reset_launches()
        generated, gen_ms, _ = _timed(
            lambda: eng.generate(ZOO_GEN, first_logits=first))
        gen_launches = dict(ops.LAUNCHES)
        rows = B * (4 if cfg.modality == "audio" else 1)
        gap = _prompt_gap(first.reshape(rows, -1),
                          at_prompt.reshape(rows, -1))
        tol = (None if cfg.is_moe else SSM_SERVE_REL_TOL
               if cfg.block_type == "hybrid" else SERVE_REL_TOL)
        if (feed_launches["rmsnorm"] != ZOO_PROMPT * n_norm
                or gen_launches["rmsnorm"] != ZOO_GEN * n_norm
                or any(feed_launches[k] or gen_launches[k] for k in (
                    "flash_attention", "swa_attention", "ssd_scan"))):
            raise SystemExit(f"{name}: decode launches: feed {feed_launches}"
                             f", generate {gen_launches}")
        if (tol is not None and gap["rel"] > tol) or not gap["picks_ok"]:
            raise SystemExit(f"{name}: the engine's prompt logits differ "
                             f"from the prefill's: {gap}")
        if not bool(((generated >= 0) & (generated < cfg.vocab_size)).all()):
            raise SystemExit(f"{name}: decode gave tokens out of range")
        rec = {"arch": name, "layers": L, "layers_published":
               full.num_layers,
               "cut": (None if L == full.num_layers else
                       f"{L} of {full.num_layers} layers: one card holds "
                       f"~{weight_bytes / 2 ** 30:.1f} GiB of bf16 weights"),
               "weights_bytes": weight_bytes, "init_ms": init_ms,
               "prefill": {"batch": B, "seq": S, "prefix": prefix or None,
                           "first_ms": ms, "steady_ms": steady_ms,
                           "steady_calls": ZOO_STEADY_CALLS,
                           "tokens_per_s": B * S / steady_ms * 1e3},
               "decode": {"batch": B, "prompt": ZOO_PROMPT,
                          "generated": ZOO_GEN,
                          "feed_ms_per_step": feed_ms / ZOO_PROMPT,
                          "ms_per_step": gen_ms / ZOO_GEN,
                          "step_bytes": step_bytes,
                          "step_bytes_bound_ms": step_bytes / card.hbm * 1e3,
                          "prompt_logits": {**gap, "tolerance_rel": tol}},
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {"prefill": pre_launches, "feed": feed_launches,
                            "generate": gen_launches}}
        if keeps:
            rec["moe_dropped_share"] = 1 - float(sum(
                k.sum() for k in keeps)) / sum(k.numel() for k in keeps)
        launches_by_model[name] = {
            k: pre_launches[k] + feed_launches[k] + gen_launches[k]
            for k in ops.LAUNCHES}
        del params, eng, first, generated, toks, kw, keeps
        torch.cuda.empty_cache()

        params = init_lm_params(cfg, seed=0, device="cuda")
        logits, _ = lm_apply(cfg, params, text)
        at_prompt = logits[:, ZOO_PROMPT - 1]
        del logits
        # the f32 prefill timed: its second call, through the split-TF32
        # attention program
        ops.reset_launches()
        _, f32_ms, _ = _timed(lambda: lm_apply(cfg, params, text))
        f32_launches = dict(ops.LAUNCHES)
        if (f32_launches[path] != L or f32_launches["rmsnorm"] != n_norm
                or f32_launches["ssd_scan"] != pre_launches["ssd_scan"]):
            raise SystemExit(f"{name}: f32 prefill launches {f32_launches}")
        rec["f32_prefill"] = {"batch": B, "seq": S, "ms": f32_ms,
                              "tokens_per_s": B * S / f32_ms * 1e3,
                              "launches": f32_launches}
        for k in ops.LAUNCHES:
            launches_by_model[name][k] += f32_launches[k]
        eng = ServeEngine(cfg, params, max_seq=ZOO_PROMPT + 1, batch=B,
                          device="cuda")
        gap = _prompt_gap(eng.feed(text[:, :ZOO_PROMPT]).reshape(rows, -1),
                          at_prompt.reshape(rows, -1))
        rec["f32_prompt_logits"] = {**gap, "tolerance_rel": ZOO_F32_REL_TOL}
        if gap["rel"] > ZOO_F32_REL_TOL or not gap["picks_ok"]:
            raise SystemExit(f"{name}: in f32 the engine's prompt logits "
                             f"differ from the prefill's: {gap}")
        records[name] = rec
        emit({"phase": "zoo_serve", **rec})
        del params, eng, text
        torch.cuda.empty_cache()
    return launches_by_model


# ---------------------------------------------------------------------------
# the paper's other experiments (slice 6)
# ---------------------------------------------------------------------------
PAPER_ROUNDS, PAPER_CHUNK, DRIFTS = 60, 20, (20, 40)


def _timed_run(fn):
    """``fn()`` between CUDA events, with the peak memory it allocated:
    ``(result, ms, peak_bytes)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), torch.cuda.max_memory_allocated()


def _check_fleet_run(name, dl, P):
    if dl.model_size != P:
        raise SystemExit(f"{name}: {dl.model_size} weights, not {P}")
    if not (math.isfinite(dl.cumulative_loss)
            and np.isfinite(dl.cumulative_loss_per_learner).all()):
        raise SystemExit(f"{name}: non-finite loss")
    if int(dl.per_link_bytes().sum()) != dl.comm_bytes():
        raise SystemExit(f"{name}: ledger {int(dl.per_link_bytes().sum())} "
                         f"!= comm_bytes {dl.comm_bytes()}")
    if not dl.X.is_cuda:
        raise SystemExit(f"{name}: the parameter plane is on {dl.X.device}")


def _fleet_record(dl, ms, peak, launches):
    return {"weights": dl.model_size, "rounds": dl.rounds,
            "ms_per_round": ms / dl.rounds, "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "model_up": dl.comm_totals["model_up"],
            "comm_bytes": dl.comm_bytes(),
            "ledger_bytes": int(dl.per_link_bytes().sum()),
            "cumulative_loss": dl.cumulative_loss,
            "peak_memory_bytes": peak, "sqdist_rows": launches,
            "plane_device": str(dl.X.device)}


def phase_paper_train() -> dict:
    """The paper's other experiments at full width on the card: the
    deep-driving PilotNet (deepdrive_cnn, 348,219 weights, 68x320x3
    frames) under known drifts through run_drift_segments, FedAvg, the
    random augmentation from a heterogeneous init, and the serial
    baseline, each on mnist_cnn at m = 100. The sqdist_rows counts are
    set to 0 just before each run and read just after."""
    train = TrainConfig(optimizer="sgd", learning_rate=0.05)
    runs, launches = {}, {}

    # deep driving under drift: m = 100, B = 10, drifts at rounds 20, 40
    dd = get_arch("deepdrive_cnn")
    dd_loss = lambda p, b: cnn_loss(dd, p, b)           # noqa: E731
    dd_init = lambda g: init_cnn_params(dd, g)           # noqa: E731
    warm = DecentralizedLearner(dd_loss, dd_init, M,
                                ProtocolConfig(kind="nosync"), train,
                                device="cuda")           # cuDNN's choices
    warm.run_chunk(LearnerStreams(DeepDriveStream(seed=1, device="cuda"), M,
                                  batch=B).next_chunk(2))
    del warm
    dynamic = ProtocolConfig(kind="dynamic", b=2, delta=0.3)
    for name, proto, want in (
            ("deepdrive periodic", ProtocolConfig(kind="periodic", b=10), 0),
            ("deepdrive drift", dynamic, PAPER_ROUNDS // 2),
            # the same run again: its decisions must repeat to the bit
            ("deepdrive drift repeat", dynamic, PAPER_ROUNDS // 2)):
        src = DeepDriveStream(seed=1, device="cuda")
        streams = LearnerStreams(src, M, batch=B, seed=0)
        dl = DecentralizedLearner(dd_loss, dd_init, M, proto, train,
                                  device="cuda")
        ops.reset_launches()
        (sync_curve, _), ms, peak = _timed_run(
            lambda: run_drift_segments(dl, streams, src, PAPER_ROUNDS,
                                       DRIFTS))
        launches[name] = ops.LAUNCHES["sqdist_rows"]
        _check_fleet_run(name, dl, P_DEEPDRIVE)
        runs[name] = _fleet_record(dl, ms, peak, launches[name])
        runs[name]["curvature_scale"] = src.curvature_scale
        runs[name]["syncs_by_segment"] = [
            int(sync_curve[e - 1] - (sync_curve[s - 1] if s else 0))
            for s, e in zip((0,) + DRIFTS, DRIFTS + (PAPER_ROUNDS,))]
        runs[name]["per_link_bytes"] = dl.per_link_bytes().tolist()
        if launches[name] != want:
            raise SystemExit(f"{name} launched sqdist_rows "
                             f"{launches[name]} times, not {want}")
        del dl, streams
        torch.cuda.empty_cache()
    if runs["deepdrive drift"]["syncs"] < 1:
        raise SystemExit("the deepdrive dynamic run never synced")
    again = runs.pop("deepdrive drift repeat")
    launches.pop("deepdrive drift repeat")
    first = runs["deepdrive drift"]
    runs["deepdrive drift"]["repeat_ms_per_round"] = again["ms_per_round"]
    same = ("syncs", "model_up", "comm_bytes", "cumulative_loss",
            "per_link_bytes")
    if any(again[k] != first[k] for k in same):
        raise SystemExit(f"the deepdrive dynamic run did not repeat: "
                         f"{ {k: (first[k], again[k]) for k in same} }")
    for rec in runs.values():
        rec.pop("per_link_bytes")

    # mnist_cnn at m = 100: FedAvg, then the random augmentation from a
    # heterogeneous init (Fig. 6.2's eps = 2; the noisy learners start at
    # ~4x the homogeneous loss, so at half the step size)
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    mtrain = TrainConfig(optimizer="sgd", learning_rate=0.1)
    for name, proto, eps, lr, want in (
            ("mnist fedavg", ProtocolConfig(kind="fedavg", b=PERIOD,
                                            fedavg_c=0.3), 0.0, 0.1, 0),
            ("random augmentation", ProtocolConfig(
                kind="dynamic", b=PERIOD, delta=DELTA,
                augmentation="random"), 2.0, 0.05, PAPER_ROUNDS // PERIOD)):
        ops.reset_launches()
        (dl, traj), ms, peak = _timed_run(lambda: run_protocol_training(
            loss_fn, init_fn, src, m=M, rounds=PAPER_ROUNDS, protocol=proto,
            train=TrainConfig(optimizer="sgd", learning_rate=lr), batch=B,
            chunk_size=PAPER_CHUNK,
            record_every=PAPER_CHUNK, init_heterogeneity=eps,
            device="cuda"))
        launches[name] = ops.LAUNCHES["sqdist_rows"]
        _check_fleet_run(name, dl, P_MNIST)
        runs[name] = _fleet_record(dl, ms, peak, launches[name])
        runs[name].update(init_heterogeneity=eps, learning_rate=lr)
        if launches[name] != want:
            raise SystemExit(f"{name} launched sqdist_rows "
                             f"{launches[name]} times, not {want}")
        del dl
    fed = runs["mnist fedavg"]
    if (fed["syncs"], fed["model_up"], fed["full_syncs"]) != (6, 180, 0):
        raise SystemExit(f"fedavg C=0.3 at m = 100 made {fed['syncs']} "
                         f"syncs moving {fed['model_up']} models up, not "
                         f"6 and 180")
    if runs["random augmentation"]["syncs"] < 1:
        raise SystemExit("the random-augmentation run never synced")

    # the serial baseline: one model sees all m * B samples of a round
    serial = SerialLearner(loss_fn, init_fn, mtrain, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(123)
    ops.reset_launches()

    def serial_run():
        for _ in range(PAPER_ROUNDS // PAPER_CHUNK):
            serial.run_chunk(src.sample(gen, M * B, lead=(PAPER_CHUNK,)))

    _, ms, peak = _timed_run(serial_run)
    launches["serial"] = ops.LAUNCHES["sqdist_rows"]
    if not math.isfinite(serial.cumulative_loss) or not serial.x.is_cuda:
        raise SystemExit(f"serial: loss {serial.cumulative_loss} on "
                         f"{serial.x.device}")
    runs["serial"] = {"weights": serial.adapter.P, "rounds": PAPER_ROUNDS,
                      "batch": M * B, "ms_per_round": ms / PAPER_ROUNDS,
                      "cumulative_loss": serial.cumulative_loss,
                      "peak_memory_bytes": peak, "sqdist_rows": 0}
    if launches["serial"]:
        raise SystemExit(f"serial launched sqdist_rows: {launches}")
    emit({"phase": "paper_train", "m": M, "batch": B, "runs": runs})
    return launches


class HostDrawn:
    """A data source drawn on the CPU from its own generator and moved to
    ``device``, so that a run on the card and one on the CPU see the same
    batches; drifts are the wrapped source's (its numpy stream)."""

    def __init__(self, source, device, seed):
        self.source, self.device = source, torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)

    def maybe_drift(self):
        return self.source.maybe_drift()

    def sample(self, generator, batch, lead=()):
        out = self.source.sample(self.gen, batch, lead)
        return {k: v.to(self.device) for k, v in out.items()}


def phase_paper_agree() -> dict:
    """Small runs on the card and on the CPU from the same initial model
    and batches: FedAvg, the random augmentation, a heterogeneous init
    and drift=True. Comm totals, the ledger and the drift rounds must be
    identical; losses and parameters agree as in ``agree``, widened for
    the heterogeneous init by ``prng.NORMAL_TOL``. Then ``prng`` on the
    card against the CPU, bit for bit."""
    cfg = get_arch("drift_mlp")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(5)))
    train = TrainConfig(optimizer="sgd", learning_rate=0.05)
    cases = {
        "fedavg": (ProtocolConfig(kind="fedavg", b=2, fedavg_c=0.5), 0.0,
                   0.0),
        "random augmentation": (ProtocolConfig(
            kind="dynamic", b=2, delta=0.5, augmentation="random"), 0.0,
            0.0),
        "init_heterogeneity": (ProtocolConfig(kind="dynamic", b=2,
                                              delta=0.5), 2.0, 0.0),
        "drift": (ProtocolConfig(kind="dynamic", b=2, delta=0.5), 0.0,
                  0.05),
    }
    report = {}
    for name, (proto, eps, p_drift) in cases.items():
        out = {}
        for dev in ("cpu", "cuda"):
            src = HostDrawn(GraphicalModelStream(
                seed=1, drift_prob=p_drift, device="cpu"), dev, seed=7)
            dl, traj = run_protocol_training(
                loss_fn, lambda g: params_from_numpy(init, g.device), src,
                m=6, rounds=40, protocol=proto, train=train, batch=10,
                seed=3, drift=p_drift > 0, init_heterogeneity=eps,
                chunk_size=15, device=dev)
            out[dev] = (dl, traj)
        (cpu, ctraj), (gpu, gtraj) = out["cpu"], out["cuda"]
        err = float((gpu.X.cpu() - cpu.X).abs().max())
        tol = 1e-5
        if eps:
            # the init noise may differ by NORMAL_TOL per unit of |z|
            base = cpu.adapter.ravel_model(params_from_numpy(init, "cpu"))
            scale = max(float(torch.std(x, correction=0)) for x in
                        tree_leaves(params_from_numpy(init, "cpu")))
            zmax = float((cpu.X - base).abs().max()) / (eps * scale)
            tol += eps * scale * prng.NORMAL_TOL * max(1.0, zmax)
        report[name] = {"comm_totals": gpu.comm_totals,
                        "cpu_comm_totals": cpu.comm_totals,
                        "drift_rounds": gtraj.drift_rounds,
                        "cpu_drift_rounds": ctraj.drift_rounds,
                        "loss": gpu.cumulative_loss,
                        "cpu_loss": cpu.cumulative_loss,
                        "param_max_abs_err": err, "param_tol": tol}
        if (gpu.comm_totals != cpu.comm_totals
                or not np.array_equal(gpu.per_link_bytes(),
                                      cpu.per_link_bytes())
                or gtraj.drift_rounds != ctraj.drift_rounds
                or not torch.equal(gpu.sync_state.key,
                                   cpu.sync_state.key)
                or gpu.comm_totals["syncs"] < 1):
            emit({"phase": "paper_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's comm or drift rounds "
                             f"differ from the CPU's")
        if not (math.isclose(gpu.cumulative_loss, cpu.cumulative_loss,
                             rel_tol=1e-5) and err <= tol):
            emit({"phase": "paper_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's losses or parameters "
                             f"differ from the CPU's")
    if not report["drift"]["drift_rounds"]:
        raise SystemExit("the drift case drew no drift")

    # prng on the card against the CPU
    k = prng.key(2024, device="cpu")
    keys = prng.split(k, 100, device="cpu")
    same = {
        "split": lambda d: prng.split(keys, 7, device=d),
        "fold_in": lambda d: prng.fold_in(keys, 11, device=d),
        "random_bits": lambda d: prng.random_bits(k, (8, P_DEEPDRIVE),
                                                  device=d),
        "uniform": lambda d: prng.uniform(keys, (1000,), -1.5, 2.0,
                                          device=d),
        "permutation": lambda d: torch.cat([
            prng.permutation(keys[i], n, device=d)
            for i, n in ((0, 100), (1, 1625), (2, 2000))]),
    }
    bits = {}
    for name, fn in same.items():
        a, b = fn("cuda"), fn("cpu")
        bits[name] = bool(a.is_cuda and torch.equal(a.cpu(), b))
    zc = prng.normal(keys, (P_DEEPDRIVE // 100,), device="cuda").cpu()
    z = prng.normal(keys, (P_DEEPDRIVE // 100,), device="cpu")
    normal_err = float(((zc - z).abs() / z.abs().clamp_min(1.0)).max())
    rec = {"phase": "paper_agree", "cases": report, "prng_bitwise": bits,
           "normal_max_err_per_unit": normal_err,
           "normal_tol": prng.NORMAL_TOL}
    emit(rec)
    if not all(bits.values()):
        raise SystemExit(f"prng on the card differs from the CPU: {bits}")
    if normal_err > prng.NORMAL_TOL:
        raise SystemExit(f"prng.normal on the card is {normal_err} from "
                         f"the CPU's, beyond {prng.NORMAL_TOL}")
    return rec


# ---------------------------------------------------------------------------
# the network environment (slice 7)
# ---------------------------------------------------------------------------
# the regimes sweep's settings (benchmarks/fig_network_regimes.py:65-68)
# and the golden cases' ring (tests/golden_pr2_capture.py)
NET_GEO = dict(topology="geometric", act_prob=0.7, geo_radius=0.6,
               redraw_every=20, link_classes=("wifi", "lte"))
NET_RING = dict(topology="ring", act_prob=0.6, link_classes=("wifi", "lte"))
NET_OUTAGES = dict(straggler_frac=0.25, outage_every=10)


def phase_net_train() -> dict:
    """mnist_cnn at full width, m = 100, inside the simulated network,
    through run_protocol_training(network=...), 60 rounds in chunks of
    20. The sqdist_rows count is set to 0 just before each run and read
    just after: one launch per checked round of a dynamic run, whatever
    the masks; none under periodic, fedavg and gossip."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    dynamic = ProtocolConfig(kind="dynamic", b=PERIOD, delta=DELTA)
    checked = ROUNDS // PERIOD
    plan = (
        ("dynamic geometric", dynamic, NetworkConfig(**NET_GEO), checked),
        ("gossip geometric", ProtocolConfig(kind="gossip", b=PERIOD),
         NetworkConfig(**NET_GEO), 0),
        ("fedavg ring", ProtocolConfig(kind="fedavg", b=PERIOD,
                                       fedavg_c=0.3),
         NetworkConfig(**NET_RING), 0),
        ("periodic ring", ProtocolConfig(kind="periodic", b=PERIOD),
         NetworkConfig(**NET_RING), 0),
        ("dynamic outages", dynamic, NetworkConfig(**NET_OUTAGES), checked),
        ("dynamic ideal", dynamic, None, checked),
        ("dynamic full availability", dynamic, NetworkConfig(), checked))
    runs, launches, planes = {}, {}, {}
    for name, proto, net, want in plan:
        ops.reset_launches()
        (dl, traj), ms, peak = _timed_run(lambda: run_protocol_training(
            loss_fn, init_fn, src, m=M, rounds=ROUNDS, protocol=proto,
            train=TrainConfig(optimizer="sgd", learning_rate=0.1), batch=B,
            chunk_size=CHUNK, record_every=CHUNK, network=net,
            device="cuda"))
        launches[name] = ops.LAUNCHES["sqdist_rows"]
        if dl.model_size != P_MNIST or not dl.X.is_cuda:
            raise SystemExit(f"{name}: {dl.model_size} weights on "
                             f"{dl.X.device}")
        if not (math.isfinite(dl.cumulative_loss)
                and np.isfinite(dl.cumulative_loss_per_learner).all()):
            raise SystemExit(f"{name}: non-finite loss")
        ledger = int(dl.per_link_bytes().sum())
        if ledger != (2 if dl.spec.uses_overlay else 1) * dl.comm_bytes():
            raise SystemExit(f"{name}: ledger {ledger} against comm_bytes "
                             f"{dl.comm_bytes()}")
        runs[name] = {
            "network": None if net is None else {
                k: v for k, v in vars(net).items()
                if v != getattr(NetworkConfig(), k)},
            "ms_per_round": ms / ROUNDS, "peak_memory_bytes": peak,
            "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "model_up": dl.comm_totals["model_up"],
            "comm_bytes": dl.comm_bytes(), "ledger_bytes": ledger,
            "network_time": dl.network_time,
            "mean_active": dl.mean_active(),
            "cumulative_loss": dl.cumulative_loss,
            "sqdist_rows": launches[name],
            "trajectory_network_time": traj.network_time}
        if launches[name] != want:
            raise SystemExit(f"{name} launched sqdist_rows "
                             f"{launches[name]} times, not {want}")
        if net is not None and not net.full_availability \
                and not dl.mean_active() < 1.0:
            raise SystemExit(f"{name}: every learner was always reachable")
        if name in ("dynamic ideal", "dynamic full availability"):
            planes[name] = (dl.X, dl.per_link_bytes(), dl.comm_totals,
                            dl.cumulative_loss)
        del dl
    ideal, full = planes["dynamic ideal"], planes["dynamic full availability"]
    bitwise = (torch.equal(ideal[0], full[0])
               and np.array_equal(ideal[1], full[1])
               and ideal[2] == full[2] and ideal[3] == full[3])
    # the network's own costs a chunk: drawing its masks on the host, and
    # gossip's mixing product W @ X on the card (cuBLAS SGEMM, TF32 off)
    geo = NetworkConfig(**NET_GEO)
    t0 = time.perf_counter()
    for _ in range(10):
        active = availability.sample_rounds(geo, M, range(CHUNK))[0]
    masks_ms = (time.perf_counter() - t0) * 1e2
    _, W = stages.cohort_neighborhood(M, active,
                                      topology.adjacency(geo, M, 0))
    W = torch.from_numpy(W).cuda()
    mix_ms = cuda_ms(lambda: W @ ideal[0])
    emit({"phase": "net_train", "m": M, "batch": B, "runs": runs,
          "full_availability_bitwise": bitwise,
          "masks_host_ms_per_chunk": masks_ms, "chunk": CHUNK,
          "gossip_mix_ms": mix_ms,
          "gossip_mix_gflop": 2 * M * M * P_MNIST / 1e9})
    if not bitwise:
        raise SystemExit("the dynamic run at full availability is not the "
                         "network=None run bit for bit")
    for name, rec in runs.items():
        if rec["syncs"] < 1:
            raise SystemExit(f"{name} never synced")
    return launches


def phase_net_agree() -> dict:
    """The network golden cases (drift_mlp smoke, m = 6, 40 rounds), a
    mobile gossip case and bounded staleness on the card and on the CPU,
    from the same model and batches: comm, ledger, per-round masks,
    per-link counts and network times identical; losses and parameters
    within paper_agree's tolerances."""
    cfg = get_arch("drift_mlp")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(5)))
    src = GraphicalModelStream(seed=1, drift_prob=0.0, device="cpu")
    batches = src.sample(torch.Generator().manual_seed(7), 10, lead=(40, 6))
    mobile = dict(topology="geometric", act_prob=0.7, geo_radius=0.6,
                  redraw_every=7, link_classes=("wifi", "lte"), seed=3)
    cases = {
        "periodic_net": (ProtocolConfig(kind="periodic", b=3), NET_RING),
        "fedavg_net": (ProtocolConfig(kind="fedavg", b=2, fedavg_c=0.5),
                       NET_RING),
        "dynamic_net": (ProtocolConfig(kind="dynamic", b=2, delta=0.5),
                        NET_RING),
        "gossip_net": (ProtocolConfig(kind="gossip", b=2),
                       dict(NET_RING, act_prob=0.8)),
        "gossip_star_fallback": (ProtocolConfig(kind="gossip", b=2), None),
        "gossip_mobile": (ProtocolConfig(kind="gossip", b=2), mobile),
        "stale": (ProtocolConfig(kind="stale"), NET_RING),
    }
    report = {}
    for name, (proto, net) in cases.items():
        out = {}
        for dev in ("cpu", "cuda"):
            dl = DecentralizedLearner(
                loss_fn, lambda g: params_from_numpy(init, g.device), 6,
                proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                network=None if net is None else NetworkConfig(**net),
                device=dev)
            metrics = [dl.run_chunk({k: v[i:i + 20].to(dev)
                                     for k, v in batches.items()})
                       for i in (0, 20)]
            out[dev] = (dl, metrics)
        (cpu, cm), (gpu, gm) = out["cpu"], out["cuda"]
        err = float((gpu.X.cpu() - cpu.X).abs().max())
        same = (gpu.comm_totals == cpu.comm_totals
                and np.array_equal(gpu.per_link_bytes(),
                                   cpu.per_link_bytes())
                and gpu.network_time == cpu.network_time
                and gpu.mean_active() == cpu.mean_active()
                and all(np.array_equal(a.num_active, b.num_active)
                        and np.array_equal(a.link_counts, b.link_counts)
                        and np.array_equal(a.net_time, b.net_time)
                        for a, b in zip(gm, cm)))
        report[name] = {"comm_totals": gpu.comm_totals,
                        "cpu_comm_totals": cpu.comm_totals,
                        "network_time": gpu.network_time,
                        "cpu_network_time": cpu.network_time,
                        "mean_active": gpu.mean_active(),
                        "loss": gpu.cumulative_loss,
                        "cpu_loss": cpu.cumulative_loss,
                        "param_max_abs_err": err, "identical": same}
        if not same or gpu.comm_totals["syncs"] < 1:
            emit({"phase": "net_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's comm, masks or network "
                             f"time differ from the CPU's")
        if not (math.isclose(gpu.cumulative_loss, cpu.cumulative_loss,
                             rel_tol=1e-5) and err <= 1e-5):
            emit({"phase": "net_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's losses or parameters "
                             f"differ from the CPU's")
    rec = {"phase": "net_agree", "cases": report}
    emit(rec)
    return rec



# the hierarchy and async cells: fig_hierarchy's 2x ratio of inter to
# intra Delta (benchmarks/fig_hierarchy.py), the net phases' ring at 60%,
# and a wifi/lte fleet whose lte exchanges of mnist_cnn's 4,799,528-byte
# payload fly 2 rounds at a 1 s budget (0 at 3 s)
ASYNC_NET = dict(link_classes=("wifi", "lte"))
TIER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "tier_ckpt")


def _tiers(intra: dict, inter: dict, link_class="wired") -> ProtocolConfig:
    return ProtocolConfig(**intra, tiers=HierarchyConfig(
        num_clusters=TIER_G, inter=ProtocolConfig(**inter),
        link_class=link_class))


def _ledger_balance(dl) -> dict:
    """The ledger against the paper's c(f), as the reference's tests hold
    it (tests/test_sync_kernel.py:367-420, tests/test_async.py): the
    per-link sums are comm_bytes(); under a periodic inter tier the
    aggregator rows are whole models at the inter payload (the quantized
    backhaul's case); under aircomp every member link
    carries one frame a sync, so the ledger is its transfers priced."""
    ledger = dl.per_link_bytes()
    out = {"ledger_bytes": int(ledger.sum()), "comm_bytes": dl.comm_bytes()}
    if dl.spec.commit == "aircomp":
        out["balanced"] = (
            out["ledger_bytes"] == int(dl.link_xfer_totals.sum())
            * dl.model_bytes and dl.comm_bytes()
            == 2 * dl.comm_totals["syncs"] * dl.model_bytes)
    else:
        out["balanced"] = out["ledger_bytes"] == dl.comm_bytes()
    if dl.tiers is not None:
        out["uplink_bytes"] = int(ledger[dl.m:].sum())
        if dl.tiers.inter.kind == "periodic":   # no control messages:
            # the uplinks carry whole models at the inter payload
            out["balanced"] &= out["uplink_bytes"] % dl.inter_model_bytes == 0
    return out


def _run_chunks(dl, streams, chunks):
    """Drive ``dl`` over ``chunks`` chunk lengths of ``streams``; returns
    the per-round (in flight, gate fired) series."""
    inflight, checked = [], []
    for n in chunks:
        metrics = dl.run_chunk(streams.next_chunk(n))
        inflight += metrics.num_inflight.tolist()
        checked += metrics.checked.tolist()
    return inflight, checked


def _state_equal(a, b) -> bool:
    """Two sync states (flat or hierarchical) equal to the bit: reference
    rows, counters, steps, keys and every carried array."""
    if hasattr(a, "intra"):
        return _state_equal(a.intra, b.intra) and _state_equal(a.inter,
                                                               b.inter)
    return (torch.equal(a.ref, b.ref) and np.array_equal(a.v, b.v)
            and a.step == b.step and torch.equal(a.key, b.key)
            and sorted(a.extra) == sorted(b.extra)
            and all(np.array_equal(a.extra[k], b.extra[k]) for k in a.extra))


def _same_run(a, b) -> bool:
    return (torch.equal(a.X, b.X)
            and torch.equal(a.opt_state.step, b.opt_state.step)
            and _state_equal(a.sync_state, b.sync_state)
            and a.comm_totals == b.comm_totals
            and np.array_equal(a.per_link_bytes(), b.per_link_bytes())
            and a.network_time == b.network_time
            and a.cumulative_loss == b.cumulative_loss)


def phase_tier_train() -> dict:
    """mnist_cnn at full width, m = 100, B = 10, sgd lr 0.1, 60 rounds in
    chunks of 20, seed 0, under the hierarchy (H1 on an ideal network,
    H2 in the ring at 60% with a quantized backhaul) and the async
    timeline (A1 with flights, A2 and A3 at k = 0, A3 over the air).
    The sqdist_rows counts are zeroed before each run and read after it,
    split by shape; H1 and A1 are also saved after chunk 1, restored into
    a fresh engine and run on, and must equal their uninterrupted runs
    bit for bit."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    train = TrainConfig(optimizer="sgd", learning_rate=0.1)
    dyn = dict(kind="dynamic", b=PERIOD, delta=DELTA)
    per = dict(kind="periodic", b=PERIOD)
    checked = ROUNDS // PERIOD
    grouped, inter_shape = (M, P_MNIST, TIER_G), (TIER_G, P_MNIST, 1)
    flat_shape = (M, P_MNIST, 1)
    plan = {   # name -> (protocol, network, AsyncConfig, predicted launches)
        "H1": (_tiers(dyn, dict(kind="dynamic", b=PERIOD, delta=2 * DELTA)),
               None, None, {grouped: checked, inter_shape: checked}),
        "H2": (_tiers(per, dict(kind="periodic", b=2 * PERIOD,
                                bytes_per_param=2)),
               NetworkConfig(**NET_RING), None, {}),
        "A1": (ProtocolConfig(**dyn), NetworkConfig(**ASYNC_NET),
               AsyncConfig(round_budget=1.0, max_delay=8), None),
        "A2 sync": (ProtocolConfig(**per), NetworkConfig(**ASYNC_NET), None,
                    {}),
        "A2": (ProtocolConfig(**per), NetworkConfig(**ASYNC_NET),
               AsyncConfig(round_budget=3.0), {}),
        "A3": (ProtocolConfig(**per), NetworkConfig(**ASYNC_NET),
               AsyncConfig(round_budget=3.0, aircomp=True, snr_db=20.0), {}),
    }

    def engine(proto, net, an):
        streams = LearnerStreams(src, M, batch=B, seed=0)
        return DecentralizedLearner(loss_fn, init_fn, M, proto, train,
                                    seed=0, network=net, async_net=an,
                                    device="cuda"), streams

    runs, done, counts = {}, {}, {}
    for name, (proto, net, an, want) in plan.items():
        held = torch.cuda.memory_allocated()     # earlier runs kept alive
        ops.reset_launches()
        if name == "A1":     # per-round timeline: the chunks by hand
            dl, streams = engine(proto, net, an)
            (series, ms, peak) = _timed_run(lambda: _run_chunks(
                dl, streams, [CHUNK] * (ROUNDS // CHUNK)))
            inflight, gated = series
            want = {flat_shape: int(sum(gated))}
        else:
            (dl, _), ms, peak = _timed_run(lambda: run_protocol_training(
                loss_fn, init_fn, src, m=M, rounds=ROUNDS, protocol=proto,
                train=train, batch=B, chunk_size=CHUNK, record_every=CHUNK,
                network=net, async_net=an, device="cuda"))
        counts[name] = {str(k): v for k, v in ops.ROWS_LAUNCHES.items()}
        if dict(ops.ROWS_LAUNCHES) != want:
            raise SystemExit(f"{name}: sqdist_rows launches "
                             f"{counts[name]}, predicted "
                             f"{ {str(k): v for k, v in want.items()} }")
        if dl.model_size != P_MNIST or not dl.X.is_cuda:
            raise SystemExit(f"{name}: {dl.model_size} weights on "
                             f"{dl.X.device}")
        if not (math.isfinite(dl.cumulative_loss)
                and np.isfinite(dl.cumulative_loss_per_learner).all()):
            raise SystemExit(f"{name}: non-finite loss")
        balance = _ledger_balance(dl)
        if not balance["balanced"]:
            raise SystemExit(f"{name}: the ledger does not balance: "
                             f"{balance}")
        runs[name] = {
            "ms_per_round": ms / ROUNDS, "peak_memory_bytes": peak - held,
            "held_before_bytes": held, "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "model_up": dl.comm_totals["model_up"], **balance,
            "network_time": dl.network_time,
            "mean_active": dl.mean_active(),
            "cumulative_loss": dl.cumulative_loss,
            "sqdist_rows": counts[name], "links": dl.num_links}
        if name == "A1":
            runs[name]["mean_inflight"] = float(np.mean(inflight))
            runs[name]["inflight_per_round"] = inflight
            runs[name]["gated_rounds"] = [i + 1 for i, g in enumerate(gated)
                                          if g]
        if name in ("H1", "A1", "A2 sync", "A2"):
            done[name] = dl
        else:
            del dl
    a2, a2s = done.pop("A2"), done.pop("A2 sync")
    a2_bitwise = (torch.equal(a2.X, a2s.X) and a2.comm_totals
                  == a2s.comm_totals and np.array_equal(
                      a2.per_link_bytes(), a2s.per_link_bytes())
                  and a2.network_time == a2s.network_time
                  and a2.cumulative_loss == a2s.cumulative_loss)
    del a2, a2s
    # every learner ticks at rounds 10, 20, ..., 60 unless in flight, and
    # the wifi half never flies
    if not set(range(PERIOD, ROUNDS + 1, PERIOD)) <= set(
            runs["A1"]["gated_rounds"]):
        raise SystemExit(f"A1's gate missed a cadence round: "
                         f"{runs['A1']['gated_rounds']}")

    # resume: chunk 1, save, a fresh engine restores and runs to round 60
    resumed = {}
    for name in ("H1", "A1"):
        proto, net, an, _ = plan[name]
        first, streams = engine(proto, net, an)
        first.run_chunk(streams.next_chunk(CHUNK))
        path = os.path.join(TIER_DIR, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        io.save_protocol_state(path, first.params, first.opt_state,
                               first.sync_state, protocol=proto,
                               counters=first.counters_state())
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(f"{path}.{part}")
                     for part in ("params.npz", "opt.npz", "sync.npz",
                                  "spec.json", "counters.json"))
        del first
        second, streams = engine(proto, net, an)
        t0 = time.perf_counter()
        loaded = io.load_protocol_state(path, device="cuda")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        second.restore_state(*loaded)
        second.restore_counters(io.load_counters(path))
        del loaded
        streams.next_chunk(CHUNK)            # replay the consumed data
        _run_chunks(second, streams, [CHUNK] * (ROUNDS // CHUNK - 1))
        same = _same_run(second, done[name])
        resumed[name] = {"write_s": write_s, "read_s": read_s,
                         "bytes": nbytes, "bitwise": same,
                         "spec_restored": io.load_protocol_spec(path)
                         == resolve_spec(proto)}
        del second, done[name]
    rec = {"phase": "tier_train", "m": M, "batch": B, "clusters": TIER_G,
           "runs": runs, "a2_equals_sync_bitwise": a2_bitwise,
           "resume": resumed}
    emit(rec)
    if not a2_bitwise:
        raise SystemExit("A2 (k = 0 everywhere) is not the synchronous "
                         "periodic run bit for bit")
    for name, r in resumed.items():
        if not (r["bitwise"] and r["spec_restored"]):
            raise SystemExit(f"{name}: the resumed run is not the "
                             f"uninterrupted one bit for bit: {r}")
    for name, r in runs.items():
        if r["syncs"] < 1:
            raise SystemExit(f"{name} never synced")
    if not runs["A1"]["mean_inflight"] > 0:
        raise SystemExit("A1: no exchange was ever in flight")
    return {k: sum(v.values()) for k, v in counts.items()}


def phase_tier_agree() -> dict:
    """The hierarchy sweep's settings (benchmarks/fig_hierarchy.py:
    drift_mlp smoke, m = 12, g in {3, 4}, intra dynamic b = 2 Delta =
    0.3, inter Delta in {0.3, 0.6}; one in the ring at 60%) and the async
    bench's presets (benchmarks/async_bench.py: m = 8 on lte/edge links,
    async periodic and dynamic, aircomp at 20 dB) on the card and on the
    CPU from the same model and batches: comm, ledger, per-round link
    counts, in-flight counts and network time identical, parameters
    within 1e-5. Then a checkpoint written on the card after chunk 1
    is continued on the CPU: the same integers as the card's own run."""
    cfg = get_arch("drift_mlp", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(5)))
    src = GraphicalModelStream(seed=1, drift_prob=0.0, device="cpu")
    edge = dict(link_classes=("lte", "edge"))
    sweep = dict(kind="dynamic", b=2, delta=0.3)

    def hier(g, inter_delta):
        return ProtocolConfig(**sweep, tiers=HierarchyConfig(
            num_clusters=g, inter=ProtocolConfig(kind="dynamic", b=2,
                                                 delta=inter_delta)))

    cases = {   # name -> (m, protocol, network, AsyncConfig)
        "hier g3 inter 0.3": (12, hier(3, 0.3), None, None),
        "hier g3 inter 0.6": (12, hier(3, 0.6), None, None),
        "hier g4 inter 0.3": (12, hier(4, 0.3), None, None),
        "hier g4 inter 0.6": (12, hier(4, 0.6), None, None),
        "hier g3 ring": (12, hier(3, 0.6), NET_RING, None),
        "async periodic": (8, ProtocolConfig(kind="periodic", b=2), edge,
                           AsyncConfig(round_budget=1.0,
                                       payload_bytes=100_000)),
        "async dynamic": (8, ProtocolConfig(kind="dynamic", b=2, delta=0.5),
                          edge, AsyncConfig(round_budget=0.25,
                                            payload_bytes=100_000)),
        "aircomp": (8, ProtocolConfig(kind="periodic", b=2), edge,
                    AsyncConfig(round_budget=60.0, aircomp=True,
                                snr_db=20.0)),
    }
    report = {}
    for name, (m, proto, net, an) in cases.items():
        batches = src.sample(torch.Generator().manual_seed(7), 10,
                             lead=(40, m))
        out = {}
        for dev in ("cpu", "cuda"):
            dl = DecentralizedLearner(
                loss_fn, lambda g: params_from_numpy(init, g.device), m,
                proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                network=None if net is None else NetworkConfig(**net),
                async_net=an, device=dev)
            metrics = [dl.run_chunk({k: v[i:i + 20].to(dev)
                                     for k, v in batches.items()})
                       for i in (0, 20)]
            out[dev] = (dl, metrics)
            if name == "hier g3 ring" and dev == "cuda":
                ckpt = os.path.join(TIER_DIR, "agree")
                resume = DecentralizedLearner(
                    loss_fn, lambda g: params_from_numpy(init, g.device), m,
                    proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                    network=NetworkConfig(**net), device="cuda")
                resume.run_chunk({k: v[:20].to("cuda")
                                  for k, v in batches.items()})
                io.save_protocol_state(ckpt, resume.params, resume.opt_state,
                                       resume.sync_state, protocol=proto,
                                       counters=resume.counters_state())
        (cpu, cm), (gpu, gm) = out["cpu"], out["cuda"]
        err = float((gpu.X.cpu() - cpu.X).abs().max())
        same = (gpu.comm_totals == cpu.comm_totals
                and np.array_equal(gpu.per_link_bytes(),
                                   cpu.per_link_bytes())
                and gpu.network_time == cpu.network_time
                and all(np.array_equal(a.link_counts, b.link_counts)
                        and np.array_equal(a.num_inflight, b.num_inflight)
                        and np.array_equal(a.net_time, b.net_time)
                        for a, b in zip(gm, cm)))
        report[name] = {"comm_totals": gpu.comm_totals,
                        "cpu_comm_totals": cpu.comm_totals,
                        "links": gpu.num_links,
                        "network_time": gpu.network_time,
                        "inflight": np.concatenate(
                            [x.num_inflight for x in gm]).tolist(),
                        "param_max_abs_err": err, "identical": same}
        if not same or gpu.comm_totals["syncs"] < 1:
            emit({"phase": "tier_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's comm, ledger, flights or "
                             f"network time differ from the CPU's")
        if err > 1e-5:
            emit({"phase": "tier_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's parameters differ from "
                             f"the CPU's by {err}")
        if name == "hier g3 ring":
            # the card's checkpoint, continued on the CPU port
            cont = DecentralizedLearner(
                loss_fn, lambda g: params_from_numpy(init, g.device), m,
                proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                network=NetworkConfig(**net), device="cpu")
            cont.restore_state(*io.load_protocol_state(ckpt, device="cpu"))
            cont.restore_counters(io.load_counters(ckpt))
            cont.run_chunk({k: v[20:40] for k, v in batches.items()})
            cross = (cont.comm_totals == gpu.comm_totals
                     and np.array_equal(cont.per_link_bytes(),
                                        gpu.per_link_bytes())
                     and cont.network_time == gpu.network_time
                     and float((cont.X - gpu.X.cpu()).abs().max()) <= 1e-5)
            report["card checkpoint on the cpu"] = {"identical": cross}
            if not cross:
                raise SystemExit("a checkpoint written on the card does "
                                 "not continue on the CPU with the card's "
                                 "integers")
    rec = {"phase": "tier_agree", "cases": report}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# the fault plane, robust sync and telemetry (slice 9)
# ---------------------------------------------------------------------------

# examples/faulty_fleet.py:47: 20% sign-flippers, 2-4 round crashes
FAULTS = dict(fault_seed=11, byzantine_frac=0.2, byzantine_mode="sign_flip",
              crash_prob=0.15, crash_every=16, outage_min=2, outage_max=4)
# tests/test_faults.py:112: crashes, NaN/Inf corruption, adversaries, bursts
HEAVY = dict(fault_seed=7, crash_prob=0.3, byzantine_frac=0.25,
             corrupt_prob=0.05, straggler_prob=0.3)
# benchmarks/robust_bench.py's median pipeline
MEDIAN = dict(name="robust_median", trigger="robust_divergence",
              cohort="all_reachable", aggregate="median", commit="quarantine")
# F6: adam under FAULTS' crashes (ROADMAP C3: per-learner step counts)
ADAM = TrainConfig(optimizer="adam", learning_rate=1e-3)
FAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "fault_telemetry")


def _finite_class_close(got: torch.Tensor, want: torch.Tensor,
                        tol: float) -> tuple:
    """(the same entries finite, max |diff| over them): NaN and Inf are
    one class, since what a local step makes of a poisoned row depends
    on how the device's kernels carry non-finite values."""
    same = bool(torch.equal(torch.isfinite(got), torch.isfinite(want)))
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    return same and err <= tol, err


def phase_fault_train() -> dict:
    """mnist_cnn at full width, m = 100, B = 10, sgd lr 0.1, 60 rounds in
    chunks of 20, seed 0, under the fault plane: F1 dynamic and F2
    robust_dynamic (streamed to build/fault_telemetry/ with per-link
    bytes, profiling and the divergence series) under FAULTS, F3
    robust_periodic and F4 the median pipeline under HEAVY (NaN/Inf rows),
    F5 dynamic at FaultConfig(), which must be the faults=None run bit
    for bit, and F6 dynamic with adam at lr 1e-3 under FAULTS, whose
    learners' optimizer step counts must be the schedule's (a crashed
    learner's frozen, a restarted one's counted from 0). The sqdist_rows
    count is zeroed before each run and read after it: one launch per
    checked round (6), plus one divergence pass a round for F2 (60).
    Then one trimmed mean and one median at (100, P) are timed against
    their bytes bound."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    train = TrainConfig(optimizer="sgd", learning_rate=0.1)
    dyn = ProtocolConfig(kind="dynamic", b=PERIOD, delta=DELTA)
    checked = ROUNDS // PERIOD
    stream = os.path.join(FAULT_DIR, "F2.jsonl")
    plan = {   # name -> (protocol, faults, predicted launches, extra)
        "F1": (dyn, FAULTS, checked, {}),
        "F2": (ProtocolConfig(kind="robust_dynamic", b=PERIOD, delta=DELTA),
               FAULTS, checked + ROUNDS, dict(
                   track_divergence=True, telemetry=TelemetryConfig(
                       path=stream, per_link=True, profile=True))),
        "F3": (ProtocolConfig(kind="robust_periodic", b=PERIOD), HEAVY,
               checked, {}),
        "F4": (ProtocolSpec(**MEDIAN).with_params(b=PERIOD, delta=DELTA),
               HEAVY, checked, {}),
        "F5": (dyn, {}, checked, {}),
        "F5 faults=None": (dyn, None, checked, {}),
        "F6": (dyn, FAULTS, checked, {"train": ADAM}),
    }
    runs, counts, done = {}, {}, {}
    for name, (proto, fkw, want, extra) in plan.items():
        fcfg = None if fkw is None else FaultConfig(**fkw)
        tr = extra.pop("train", train)

        def run():
            dl = DecentralizedLearner(loss_fn, init_fn, M, proto, tr,
                                      seed=0, faults=fcfg, device="cuda",
                                      **extra)
            streams = LearnerStreams(src, M, batch=B, seed=0)
            metrics = [dl.run_chunk(streams.next_chunk(CHUNK))
                       for _ in range(ROUNDS // CHUNK)]
            return dl, metrics

        held = torch.cuda.memory_allocated()
        ops.reset_launches()
        (dl, metrics), ms, peak = _timed_run(run)
        counts[name] = ops.LAUNCHES["sqdist_rows"]
        if counts[name] != want:
            raise SystemExit(f"{name} launched sqdist_rows {counts[name]} "
                             f"times, predicted {want}")
        if dl.model_size != P_MNIST or not dl.X.is_cuda:
            raise SystemExit(f"{name}: {dl.model_size} weights on "
                             f"{dl.X.device}")
        series = {f: np.concatenate([np.asarray(getattr(x, f))
                                     for x in metrics]).tolist()
                  for f in ("num_faulty", "num_active", "num_quarantined",
                            "num_recovered")}
        if fcfg is not None:
            want_faulty = faults.sample_rounds(fcfg, M, range(ROUNDS)) \
                .num_faulty().tolist()
            if series["num_faulty"] != want_faulty:
                raise SystemExit(f"{name}: num_faulty {series['num_faulty']}"
                                 f" is not the schedule's {want_faulty}")
        # the learners the fault plane left honest and reachable at the
        # last round hold finite rows, and the reference row is finite
        # (the plain mean under FAULTS: no corruption, so all of it)
        if fcfg is not None and fkw:
            sched = faults.sample_rounds(fcfg, M, [ROUNDS - 1])
            ok = ~(sched.down()[0] | sched.byzantine | sched.corrupt[0])
        else:
            ok = np.ones(M, bool)
        finite_rows = torch.isfinite(dl.X).all(dim=1).cpu().numpy()
        if not (finite_rows[ok].all()
                and bool(torch.isfinite(dl.sync_state.ref).all())):
            raise SystemExit(f"{name}: an honest reachable row or the "
                             f"reference is not finite")
        runs[name] = {
            "faults": fkw, "ms_per_round": ms / ROUNDS,
            "peak_memory_bytes": peak - held, "held_before_bytes": held,
            "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "model_up": dl.comm_totals["model_up"],
            "comm_bytes": dl.comm_bytes(),
            "ledger_bytes": int(dl.per_link_bytes().sum()),
            "quarantined_learner_rounds": int(sum(series["num_quarantined"])),
            "recovered_total": int(sum(series["num_recovered"])),
            "cumulative_loss": dl.cumulative_loss,
            "honest_rows_finite": int(finite_rows[ok].sum()),
            "sqdist_rows": counts[name], **series}
        if runs[name]["ledger_bytes"] != dl.comm_bytes():
            raise SystemExit(f"{name}: the ledger does not balance")
        if name == "F6":
            runs[name]["optimizer_steps"] = check_adam_steps(dl, fcfg)
        if name == "F2":
            dl.recorder.close()
            runs[name]["stream"] = check_fault_stream(dl, stream, series)
            runs[name]["divergence_last"] = float(metrics[-1].divergence[-1])
        if name.startswith("F5"):
            done[name] = dl
        else:
            del dl
    a, b = done["F5"], done["F5 faults=None"]
    f5_bitwise = (torch.equal(a.X, b.X) and a.comm_totals == b.comm_totals
                  and np.array_equal(a.per_link_bytes(), b.per_link_bytes())
                  and a.cumulative_loss == b.cumulative_loss
                  and torch.equal(a.sync_state.ref, b.sync_state.ref))
    plane = a.X
    del done, a, b
    aggregates = time_robust_aggregates(plane)
    del plane
    rec = {"phase": "fault_train", "m": M, "batch": B, "runs": runs,
           "f5_equals_faults_none_bitwise": f5_bitwise,
           "aggregates": aggregates}
    emit(rec)
    if not f5_bitwise:
        raise SystemExit("F5 (FaultConfig()) is not the faults=None run bit "
                         "for bit")
    for name in ("F2", "F3", "F4"):
        if runs[name]["quarantined_learner_rounds"] < 1:
            raise SystemExit(f"{name}: the quarantine never flagged a row")
    for name, r in runs.items():
        if r["syncs"] < 1:
            raise SystemExit(f"{name} never synced")
    return {k: v for k, v in counts.items() if k != "F5 faults=None"}


def schedule_steps(fcfg, m: int, rounds: int) -> np.ndarray:
    """Each learner's optimizer step count after ``rounds`` rounds of the
    fault schedule: the rounds it trained (was not crashed) since its
    last restart, which zeroes the count before that round's step."""
    crashed = faults.crash_rounds(fcfg, m, range(rounds))
    restarted = faults.restart_rounds(fcfg, m, range(rounds))
    last = np.where(restarted.any(axis=0),
                    rounds - 1 - np.argmax(restarted[::-1], axis=0), 0)
    return np.array([int((~crashed[last[i]:, i]).sum()) for i in range(m)],
                    np.int32)


def check_adam_steps(dl, fcfg) -> dict:
    """F6's per-learner optimizer steps against the fault masks: the
    schedule's counts, an (m,) int32 tensor on the card, unequal (some
    learner crashed or restarted)."""
    steps = dl.opt_state.step
    want = schedule_steps(fcfg, M, ROUNDS)
    got = steps.cpu().numpy()
    out = {"dtype": str(steps.dtype), "device": str(steps.device),
           "min": int(got.min()), "max": int(got.max()),
           "learners_behind": int((got < ROUNDS).sum()),
           "restarted": int(faults.restart_rounds(fcfg, M, range(ROUNDS))
                            .any(axis=0).sum())}
    if not (steps.is_cuda and steps.dtype == torch.int32
            and np.array_equal(got, want) and got.min() < ROUNDS):
        emit({"phase": "fault_train", "failed": {"F6 steps": out,
                                                 "got": got.tolist(),
                                                 "want": want.tolist()}})
        raise SystemExit("F6: the optimizer step counts are not the fault "
                         "schedule's")
    return out


def check_fault_stream(dl, path: str, series: dict) -> dict:
    """F2's telemetry stream: it validates (``load_run``), holds 60 round
    records whose ``num_faulty`` / ``num_quarantined`` / ``num_recovered``
    are the run's own series, and its last ``cum_*`` are the live
    counters bit for bit."""
    run = load_run(path)
    rounds = run.rounds
    last = rounds[-1] if rounds else {}
    card = summarize(run)
    out = {"path": os.path.relpath(path, os.path.dirname(FAULT_DIR)),
           "round_records": len(rounds), "chunk_records": len(run.chunks),
           "fault_card": {k: v for k, v in card.get("faults", {}).items()
                          if not isinstance(v, list)},
           "profile": card.get("profile")}
    checks = {
        "60 round records": len(rounds) == ROUNDS,
        "num_faulty": [r.get("num_faulty") for r in rounds]
        == series["num_faulty"],
        "num_quarantined": [r.get("num_quarantined") for r in rounds]
        == series["num_quarantined"],
        "num_recovered": [r.get("num_recovered") for r in rounds]
        == series["num_recovered"],
        "cum_loss": last.get("cum_loss") == dl.cumulative_loss,
        "cum_net_time": last.get("cum_net_time") == dl.network_time,
        "cum_syncs": last.get("cum_syncs") == dl.comm_totals["syncs"],
        "cum_bytes": last.get("cum_bytes") == dl.comm_bytes(),
        "link_bytes_cum": run.chunks[-1]["link_bytes_cum"]
        == dl.per_link_bytes().tolist(),
        "per_link": all(sum(r["link_bytes"]) == r["round_bytes"]
                        for r in rounds),
        "divergence": all(math.isfinite(r["divergence"])
                          and r["divergence"] >= 0 for r in rounds)
        and any(r["divergence"] > 0 for r in rounds)}
    out["checks"] = checks
    if not all(checks.values()):
        emit({"phase": "fault_train", "failed": {"stream": out}})
        raise SystemExit(f"F2's telemetry stream is wrong: {checks}")
    return out


def time_robust_aggregates(X: torch.Tensor) -> dict:
    """One trimmed mean and one median over a (100, P) plane on the card,
    with its peak memory, beside the bytes bound (the plane read once,
    the row written once) and the sort alone."""
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    m, P = X.shape
    mask = np.ones(m, bool)
    nbytes = (m * P + P) * 4
    bound = nbytes / mem_rate * 1e3
    out = {"shape": [m, P], "bytes": nbytes, "bound_ms": bound,
           "bound_by": "bytes"}
    for name, fn in (
            ("trimmed_mean", lambda: flat_trimmed_mean(X, mask, 0.2)),
            ("median", lambda: flat_median(X, mask)),
            ("sort", lambda: torch.sort(X, dim=0))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(fn, iters=5, warmup=1)
        out[name] = {"ms": ms, "peak_bytes": peak,
                     "of_bound": bound / ms}
    return out


def phase_fault_agree() -> dict:
    """F1-F4's and F6's settings at the test width (drift_mlp smoke,
    m = 8, 32 rounds in chunks of 16), plus async periodic and a hierarchy
    under HEAVY, on the card and on the CPU from the same model and
    batches: comm, ledger, every round's fault / active / quarantine /
    recovery counts, the health state and the optimizer step counts
    identical; parameters finite alike and the finite ones within
    1e-5."""
    cfg = get_arch("drift_mlp", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(5)))
    src = GraphicalModelStream(seed=1, drift_prob=0.0, device="cpu")
    edge = dict(link_classes=("lte", "edge"))
    sgd = TrainConfig(optimizer="sgd", learning_rate=0.05)
    cases = {   # name -> (protocol, faults, network, AsyncConfig[, train])
        "F1 dynamic": (ProtocolConfig(kind="dynamic", b=2, delta=0.5),
                       FAULTS, None, None),
        "F6 adam dynamic": (ProtocolConfig(kind="dynamic", b=2, delta=0.5),
                            FAULTS, None, None, ADAM),
        "F2 robust_dynamic": (ProtocolConfig(kind="robust_dynamic", b=2,
                                             delta=0.5), FAULTS, None, None),
        "F3 robust_periodic": (ProtocolConfig(kind="robust_periodic", b=2),
                               HEAVY, None, None),
        "F4 median": (ProtocolSpec(**MEDIAN).with_params(b=2, delta=0.5),
                      HEAVY, None, None),
        "async periodic": (ProtocolConfig(kind="periodic", b=2), HEAVY, edge,
                           AsyncConfig(round_budget=1.0,
                                       payload_bytes=100_000)),
        "hierarchy": (ProtocolConfig(
            kind="dynamic", b=2, delta=0.3, tiers=HierarchyConfig(
                num_clusters=2, inter=ProtocolConfig(kind="dynamic", b=2,
                                                     delta=0.6))),
            HEAVY, None, None),
    }
    batches = src.sample(torch.Generator().manual_seed(7), 10, lead=(32, 8))
    report = {}
    fields = ("num_faulty", "num_active", "num_quarantined", "num_recovered",
              "num_inflight", "link_counts")
    for name, (proto, fkw, net, an, *tr) in cases.items():
        out = {}
        for dev in ("cpu", "cuda"):
            dl = DecentralizedLearner(
                loss_fn, lambda g: params_from_numpy(init, g.device), 8,
                proto, tr[0] if tr else sgd,
                network=None if net is None else NetworkConfig(**net),
                async_net=an, faults=FaultConfig(**fkw), device=dev)
            metrics = [dl.run_chunk({k: v[i:i + 16].to(dev)
                                     for k, v in batches.items()})
                       for i in (0, 16)]
            out[dev] = (dl, {f: np.concatenate([np.asarray(getattr(x, f))
                                                for x in metrics])
                             for f in fields})
        (cpu, cs), (gpu, gs) = out["cpu"], out["cuda"]
        ecpu = (cpu.sync_state.extra if cpu.tiers is None
                else cpu.sync_state.intra.extra)
        egpu = (gpu.sync_state.extra if gpu.tiers is None
                else gpu.sync_state.intra.extra)
        close, err = _finite_class_close(gpu.X.cpu(), cpu.X, 1e-5)
        same = (gpu.comm_totals == cpu.comm_totals
                and np.array_equal(gpu.per_link_bytes(),
                                   cpu.per_link_bytes())
                and gpu.network_time == cpu.network_time
                and all(np.array_equal(gs[f], cs[f]) for f in fields)
                and sorted(egpu) == sorted(ecpu)
                and all(np.array_equal(egpu[k], ecpu[k]) for k in ecpu)
                and torch.equal(gpu.opt_state.step.cpu(), cpu.opt_state.step))
        report[name] = {"comm_totals": gpu.comm_totals,
                        "cpu_comm_totals": cpu.comm_totals,
                        "faulty_learner_rounds": int(gs["num_faulty"].sum()),
                        "quarantined_learner_rounds":
                            int(gs["num_quarantined"].sum()),
                        "param_max_abs_err_finite": err,
                        "optimizer_steps": gpu.opt_state.step.tolist(),
                        "identical": same, "params_close": close}
        if not same or gpu.comm_totals["syncs"] < 1:
            emit({"phase": "fault_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's integers differ from the "
                             f"CPU's")
        if not close:
            emit({"phase": "fault_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's parameters differ from "
                             f"the CPU's by {err}")
    rec = {"phase": "fault_agree", "cases": report}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
SHARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "shard")
# the reference's sharded-vs-flat tolerance (tests/test_shard.py:79): the
# cohort means add the ranks' partial sums in rank order
SHARD_TOL = dict(rtol=2e-4, atol=1e-6)
# a split fleet's plane is held to the flat plane only to catch a gross
# fault (a lost rank or a wrong row is O(1) of the plane's norm), and
# its precision is reported: the ranks' smaller cuBLAS/cuDNN calls give
# other last bits, training grows them, and a ReLU kink can turn one into
# an O(lr) step (on the CPU, the fixture's fedavg at world 2: learner 2's
# gradient moves by 0.053 in round 26 for a 6e-8 parameter difference)
SHARD_GROSS_REL = 1e-2
SHARD_WORLDS = (1, 2, 4)
SHARD_KINDS = ("dynamic", "periodic")
STEP_ROUNDS = 20             # make_dynamic_train_step's steps at world 2
# tests/test_shard.py's fixture: the smoke drift MLP, m = 8, B = 10, sgd
# lr 0.05, 30 rounds, the ring at 60% availability over wifi and lte
FIXTURE_M, FIXTURE_ROUNDS = 8, 30
FIXTURE_NET = dict(act_prob=0.6, topology="ring", link_classes=("wifi", "lte"))
FIXTURE_PRESETS = {
    "nosync": dict(kind="nosync"),
    "periodic": dict(kind="periodic", b=3),
    "continuous": dict(kind="continuous", b=1),
    "fedavg": dict(kind="fedavg", b=2, fedavg_c=0.5),
    "dynamic": dict(kind="dynamic", b=2, delta=0.5),
    "gossip": dict(kind="gossip", b=2),
    "stale": dict(kind="stale"),
    "hierarchy": dict(kind="dynamic", b=2, delta=0.5),
}


def _shard_proto(kind: str, layout: str) -> ProtocolConfig:
    if kind == "dynamic":
        return ProtocolConfig(kind="dynamic", b=PERIOD, delta=DELTA,
                              layout=layout)
    return ProtocolConfig(kind="periodic", b=PERIOD, layout=layout)


def _fingerprint(X: torch.Tensor) -> int:
    """A position-weighted sum of the plane's bits, mod 2**64 (integer
    sums do not depend on their order): equal planes give equal values,
    and one changed bit changes it."""
    bits = X.contiguous().view(torch.int32).reshape(-1)
    total, step = 0, 1 << 24
    for i in range(0, bits.numel(), step):
        b = bits[i:i + step].to(torch.int64)
        w = torch.arange(i, i + b.numel(), device=X.device) % 65521 + 1
        total = (total + int((b * w).sum())) % (1 << 64)
    return total


def _mnist_run(kind: str, layout: str):
    """mnist_cnn at full width, m = 100, B = 10, sgd lr 0.1, seed 0, 60
    rounds in chunks of 20, under ``kind`` on ``layout``, timed: (the
    learner, ms, peak bytes)."""
    cfg = get_arch("mnist_cnn")
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")

    def run():
        dl = DecentralizedLearner(
            lambda p, b: cnn_loss(cfg, p, b),
            lambda g: init_cnn_params(cfg, g), M, _shard_proto(kind, layout),
            TrainConfig(optimizer="sgd", learning_rate=0.1), seed=0,
            device="cuda")
        streams = LearnerStreams(src, M, batch=B, seed=0)
        for _ in range(ROUNDS // CHUNK):
            dl.run_chunk(streams.next_chunk(CHUNK))
        return dl

    return _timed_run(run)


def _counters(dl) -> dict:
    return {"comm": dict(dl.comm_totals),
            "ledger": [int(x) for x in dl.per_link_bytes()],
            "network_time": dl.network_time,
            "cumulative_loss": dl.cumulative_loss,
            "loss_per_learner": dl.cumulative_loss_per_learner.tolist()}


def _fixture_data():
    """The fixture's initial model and 30 rounds of batches, as numpy
    (they go to the ranks by pickle)."""
    cfg = get_arch("drift_mlp", smoke=True)
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(0)))
    src = GraphicalModelStream(seed=0, drift_prob=0.0, device="cpu")
    batches = LearnerStreams(src, FIXTURE_M, batch=B,
                             seed=0).next_chunk(FIXTURE_ROUNDS)
    return init, {k: v.numpy() for k, v in batches.items()}


def _fixture_run(name: str, layout: str, data, device: str) -> dict:
    """One preset of the fixture on ``layout``: counters, ledger, link
    transfers and the whole (gathered) plane on the host."""
    cfg = get_arch("drift_mlp", smoke=True)
    init, batches = data
    tiers = None if name != "hierarchy" else HierarchyConfig(
        num_clusters=4, inter=ProtocolConfig(kind="periodic", b=6))
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: params_from_numpy(init, device=device), FIXTURE_M,
        ProtocolConfig(**FIXTURE_PRESETS[name], layout=layout, tiers=tiers),
        TrainConfig(optimizer="sgd", learning_rate=0.05),
        network=NetworkConfig(**FIXTURE_NET), device=device)
    dl.run_chunk({k: torch.from_numpy(v).to(device)
                  for k, v in batches.items()})
    return {"comm": dict(dl.comm_totals),
            "ledger": [int(x) for x in dl.per_link_bytes()],
            "xfers": dl.link_xfer_totals.tolist(),
            "plane": dl.fleet_plane().cpu()}


def _train_step_run(fleet) -> dict:
    """``make_dynamic_train_step`` at full width (m = 100, B = 10, sgd lr
    0.1, dynamic b=10 Δ=0.7) for STEP_ROUNDS steps; ``fleet`` None is one
    process."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    train = TrainConfig(optimizer="sgd", learning_rate=0.1)
    proto = ProtocolConfig(kind="dynamic", b=PERIOD, delta=DELTA)
    state = distributed.init_dynamic_state(
        lambda g: init_cnn_params(cfg, g),
        torch.Generator(device="cuda").manual_seed(0), M, train,
        fleet=fleet, device="cuda")
    step = distributed.make_dynamic_train_step(loss_fn, proto, train, M,
                                               fleet=fleet)
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    batches = LearnerStreams(src, M, batch=B, seed=0).next_chunk(STEP_ROUNDS)
    synced, maxd, loss = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(STEP_ROUNDS):
        state, metrics = step(state, {k: v[t] for k, v in batches.items()})
        synced.append(int(metrics["synced"]))
        maxd.append(float(metrics["max_sq_dist"]))
        loss.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    return {"synced": synced, "max_sq_dist": maxd, "loss": loss,
            "syncs": state.syncs, "checks": state.checks,
            "ms_per_step": (time.perf_counter() - t0) * 1e3 / STEP_ROUNDS}


# the fault plane, robust sync, the async timeline and aircomp on the
# split fleet (ROADMAP A26), at fault_train's F1 / F3 and tier_train's
# A1 / A3 settings: name -> (protocol kwargs, network, AsyncConfig
# kwargs, FaultConfig kwargs)
SPLIT_PLANES = {
    "F1": (dict(kind="dynamic", b=PERIOD, delta=DELTA), None, None, FAULTS),
    "F3": (dict(kind="robust_periodic", b=PERIOD), None, None, HEAVY),
    "A1": (dict(kind="dynamic", b=PERIOD, delta=DELTA), ASYNC_NET,
           dict(round_budget=1.0, max_delay=8), None),
    "A3": (dict(kind="periodic", b=PERIOD), ASYNC_NET,
           dict(round_budget=3.0, aircomp=True, snr_db=20.0), None),
}
# what no float decides in each run, held to the flat run's at S2 and S4
# (README, the split fleet's contract): the fault schedule's counts, a
# cadence trigger's comm, ledger and in-flight timeline; A1's launches
# and F1's cohorts are a distance trigger's decisions
SPLIT_EXACT = {"F1": ("num_faulty", "num_active"),
               "F3": ("comm", "ledger", "num_faulty", "num_active"),
               "A1": (),
               "A3": ("comm", "ledger", "num_inflight", "network_time")}
# ROUNDS each, but F3 two chunks: its syncs gather the whole plane
# through the host and sort it on every rank (130-180 ms a round at S2
# and S4 on an H100), and the phase keeps near its time budget
SPLIT_ROUNDS = {"F1": ROUNDS, "F3": 2 * CHUNK, "A1": ROUNDS, "A3": ROUNDS}
SPLIT_KEYS = ("comm", "ledger", "network_time", "cumulative_loss",
              "num_faulty", "num_active", "num_inflight", "checked",
              "fingerprint")


def _split_plane_run(name: str, layout: str) -> tuple:
    """SPLIT_PLANES[name] on mnist_cnn at full width (m = 100, B = 10,
    sgd lr 0.1, seed 0, SPLIT_ROUNDS[name] rounds in chunks of 20) on
    ``layout``, timed, with its sqdist_rows launches by shape (the
    counts zeroed first): (the learner, its record)."""
    proto, net, an, fk = SPLIT_PLANES[name]
    rounds = SPLIT_ROUNDS[name]
    cfg = get_arch("mnist_cnn")
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")

    def run():
        dl = DecentralizedLearner(
            lambda p, b: cnn_loss(cfg, p, b),
            lambda g: init_cnn_params(cfg, g), M,
            ProtocolConfig(**proto, layout=layout),
            TrainConfig(optimizer="sgd", learning_rate=0.1), seed=0,
            network=None if net is None else NetworkConfig(**net),
            async_net=None if an is None else AsyncConfig(**an),
            faults=None if fk is None else FaultConfig(**fk), device="cuda")
        streams = LearnerStreams(src, M, batch=B, seed=0)
        return dl, [dl.run_chunk(streams.next_chunk(CHUNK))
                    for _ in range(rounds // CHUNK)]

    ops.reset_launches()
    (dl, metrics), ms, peak = _timed_run(run)
    rec = {**_counters(dl), "ms_per_round": ms / rounds, "rounds": rounds,
           "peak_memory_bytes": peak, "rows_per_rank": dl.m_local,
           "sqdist_rows": {"x".join(map(str, k)): v for k, v in
                           ops.ROWS_LAUNCHES.items()},
           **{f: np.concatenate([np.asarray(getattr(x, f)) for x in
                                 metrics]).tolist()
              for f in ("num_faulty", "num_active", "num_inflight",
                        "checked")}}
    return dl, rec


def _class_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``_plane_gap`` over ``want``'s finite entries, NaN and ±Inf one
    class: ``finite`` says whether both planes are finite at the same
    entries."""
    fin = torch.isfinite(want)
    same = bool(torch.equal(torch.isfinite(got), fin))
    gap = _plane_gap(got[fin], want[fin])
    gap.update(finite=same and gap["finite"],
               nonfinite_entries=int((~fin).sum()))
    return gap


def _js(x) -> str:
    """A value as JSON text: NaN equals NaN, as the runs' bits do."""
    return json.dumps(x, sort_keys=True)


def shard_rank(flat_dir: str, fixture) -> dict:
    """One rank of shard_train (run by ``shard.launch``): the dynamic and
    periodic runs at full width on layout="sharded", twice each, with
    this rank's sqdist_rows launches by shape, the bytes its collectives
    received a round, its ms a round and peak memory and the gathered
    plane's fingerprint; rank 0 measures each first run's plane against
    the flat run's. Then SPLIT_PLANES' runs (F1, F3, A1, A3) once each,
    recorded the same way with their per-round series. Then every preset
    of the fixture on the card. At world 2, also make_dynamic_train_step
    on the fleet."""
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {"world": world, "rank": rank, "backend": dist.get_backend()}
    for kind in SHARD_KINDS:
        runs = []
        for rep in range(2):
            ops.reset_launches()
            shard.COLLECTIVE_BYTES.clear()
            dl, ms, peak = _mnist_run(kind, "sharded")
            rec = {**_counters(dl), "ms_per_round": ms / ROUNDS,
                   "peak_memory_bytes": peak, "rows_per_rank": dl.m_local,
                   "sqdist_rows": {"x".join(map(str, k)): v for k, v in
                                   ops.ROWS_LAUNCHES.items()},
                   "collective_bytes_per_round": {
                       k: v / ROUNDS
                       for k, v in shard.COLLECTIVE_BYTES.items()}}
            plane = dl.fleet_plane()
            rec["fingerprint"] = _fingerprint(plane)
            if rank == 0 and rep == 0:
                flat = torch.load(os.path.join(flat_dir, f"{kind}.pt"),
                                  map_location="cuda")
                rec.update(bitwise=bool(torch.equal(plane, flat)),
                           **_plane_gap(plane, flat))
                del flat
            runs.append(rec)
            del dl, plane
            torch.cuda.empty_cache()
        out[kind] = runs
    planes = {}
    for name in SPLIT_PLANES:
        dl, rec = _split_plane_run(name, "sharded")
        plane = dl.fleet_plane()
        rec["fingerprint"] = _fingerprint(plane)
        if rank == 0:
            flat = torch.load(os.path.join(flat_dir, f"{name}.pt"),
                              map_location="cuda")
            rec.update(_class_gap(plane, flat))
            del flat
        planes[name] = rec
        del dl, plane
        torch.cuda.empty_cache()
    out["planes"] = planes
    ops.reset_launches()
    out["fixture"] = {name: _fixture_run(name, "sharded", fixture, "cuda")
                      for name in FIXTURE_PRESETS}
    if world == 2:
        out["train_step"] = _train_step_run(shard.fleet_sharding(M))
    return out


def _same_fixture(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in ("comm", "ledger", "xfers"))


def _plane_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a plane is from another: the largest entry, SHARD_TOL's
    verdict and the norm of the difference relative to ``want``'s."""
    return {"max_abs_err": float((got - want).abs().max()),
            "close": bool(torch.allclose(got, want, **SHARD_TOL)),
            "rel_l2_err": float(torch.linalg.vector_norm(got - want)
                                / torch.linalg.vector_norm(want)),
            "finite": bool(torch.isfinite(got).all())}


def _gross(gap: dict) -> bool:
    return gap["finite"] and gap["rel_l2_err"] <= SHARD_GROSS_REL


def phase_shard_train() -> dict:
    """The row-sharded fleet on the one card. First tests/test_shard.py's
    fixture (the smoke drift MLP, m = 8, the ring at 60%, the seven
    presets and a hierarchy of 4 clusters) flat on the card and on the
    CPU: comm, ledger and link transfers identical. Then mnist_cnn at
    full width (m = 100, B = 10, sgd lr 0.1, 60 rounds in chunks of 20),
    dynamic b=10 Δ=0.7 and periodic b=10, flat (planes saved to
    build/shard/), and make_dynamic_train_step in this process. Then S1,
    one rank over NCCL, and S2 and S4, two and four ranks sharing the
    card over gloo. Every world: each rank's counters alike, a second
    run bit for bit the first, sqdist_rows 6 times on each rank's
    (100/n, P) rows under dynamic and never under periodic, and the
    fixture's every preset with the card's flat comm, ledger and link
    transfers. S1 is the flat run bit for bit, fixture and full width.
    At full width S2 and S4 run the local step in calls of 50 and 25
    learners, so periodic keeps the flat comm and ledger (its cadence
    reads no value) and dynamic's are reported beside the flat run's.
    Each split plane is measured against its flat one (largest error,
    SHARD_TOL's verdict) and held within SHARD_GROSS_REL of its norm.
    SPLIT_PLANES' runs (F1, F3, A1, A3; SPLIT_ROUNDS) are held the same
    way, flat in this process first: S1 bit for bit, S2 and S4 to the
    split fleet's contract (SPLIT_EXACT's integers the flat run's, the
    plane within SHARD_GROSS_REL, NaN and Inf one class), each rank's
    sqdist_rows launches at (100/n, P) as predicted. make_dynamic_train_step at
    world 2 makes one process's sync decisions."""
    os.makedirs(SHARD_DIR, exist_ok=True)
    problems = []
    fixture = _fixture_data()
    fix_flat, fix_agree = {}, {}
    for name in FIXTURE_PRESETS:
        card = _fixture_run(name, "flat", fixture, "cuda")
        cpu = _fixture_run(name, "flat", fixture, "cpu")
        fix_flat[name] = card
        fix_agree[name] = {"integers_identical": _same_fixture(card, cpu),
                           **_plane_gap(card["plane"], cpu["plane"]),
                           "syncs": card["comm"]["syncs"]}
        if not (fix_agree[name]["integers_identical"]
                and _gross(fix_agree[name])):
            problems.append(f"fixture {name}: card flat vs CPU flat "
                            f"{fix_agree[name]}")
    flat = {}
    for kind in SHARD_KINDS:
        ops.reset_launches()
        dl, ms, peak = _mnist_run(kind, "flat")
        flat[kind] = {
            **_counters(dl), "ms_per_round": ms / ROUNDS,
            "peak_memory_bytes": peak, "fingerprint": _fingerprint(dl.X),
            "sqdist_rows": {"x".join(map(str, k)): v for k, v in
                            ops.ROWS_LAUNCHES.items()}}
        torch.save(dl.X, os.path.join(SHARD_DIR, f"{kind}.pt"))
        del dl
    flat_planes = {}
    for name in SPLIT_PLANES:
        dl, rec = _split_plane_run(name, "flat")
        rec["fingerprint"] = _fingerprint(dl.X)
        torch.save(dl.X, os.path.join(SHARD_DIR, f"{name}.pt"))
        flat_planes[name] = rec
        del dl
    step_one = _train_step_run(None)
    torch.cuda.empty_cache()
    worlds, held, fix_held = {}, {}, {}
    keys = ("comm", "ledger", "network_time", "cumulative_loss",
            "loss_per_learner", "fingerprint")
    for world in SHARD_WORLDS:
        t0 = time.perf_counter()
        ranks = shard.launch(shard_rank, world, SHARD_DIR, fixture,
                             device="cuda")
        name = f"S{world}"
        worlds[name] = {"seconds": time.perf_counter() - t0,
                        "ranks": ranks}
        for kind in SHARD_KINDS:
            want, lead = flat[kind], ranks[0][kind][0]
            shape = f"{M // world}x{P_MNIST}x1"
            launches = {shape: ROUNDS // PERIOD} if kind == "dynamic" else {}
            for r in ranks:
                first, second = r[kind]
                if {k: first[k] for k in keys} != {k: lead[k] for k in keys}:
                    problems.append(f"{name} {kind}: rank {r['rank']} "
                                    f"differs from rank 0")
                if any(first[k] != second[k] for k in keys):
                    problems.append(f"{name} {kind} rank {r['rank']}: the "
                                    f"second run is not the first bit for "
                                    f"bit")
                if first["sqdist_rows"] != launches:
                    problems.append(f"{name} {kind} rank {r['rank']}: "
                                    f"sqdist_rows {first['sqdist_rows']}, "
                                    f"predicted {launches}")
            same = {k: lead[k] == want[k] for k in
                    ("comm", "ledger", "fingerprint")}
            held[f"{name} {kind}"] = {
                **same, **{k: lead[k] for k in
                           ("bitwise", "close", "max_abs_err", "rel_l2_err",
                            "finite")},
                "split_comm": lead["comm"], "flat_comm": want["comm"]}
            h = held[f"{name} {kind}"]
            if world == 1 and not (all(same.values()) and h["bitwise"]):
                problems.append(f"{name} {kind}: not the flat run bit for "
                                f"bit: {h}")
            if kind == "periodic" and not (same["comm"] and same["ledger"]):
                problems.append(f"{name} periodic: comm or ledger differ "
                                f"from the flat run's: {h}")
            if not _gross(h):
                problems.append(f"{name} {kind}: the plane is not the flat "
                                f"plane's within {SHARD_GROSS_REL}: {h}")
        for pname, want in flat_planes.items():
            lead = ranks[0]["planes"][pname]
            shape = f"{M // world}x{P_MNIST}x1"
            for r in ranks:
                got = r["planes"][pname]
                if _js({k: got[k] for k in SPLIT_KEYS}) != \
                        _js({k: lead[k] for k in SPLIT_KEYS}):
                    problems.append(f"{name} {pname}: rank {r['rank']} "
                                    f"differs from rank 0")
                # a distance trigger checks (F1), a sync reads the
                # distances (F3), a gated round checks (A1); aircomp none
                n = (sum(got["checked"]) if pname == "A1"
                     else 0 if pname == "A3"
                     else SPLIT_ROUNDS[pname] // PERIOD)
                if got["sqdist_rows"] != ({shape: n} if n else {}):
                    problems.append(f"{name} {pname} rank {r['rank']}: "
                                    f"sqdist_rows {got['sqdist_rows']}, "
                                    f"predicted {n} at {shape}")
            exact = {k: _js(lead[k]) == _js(want[k])
                     for k in (SPLIT_KEYS if world == 1
                               else SPLIT_EXACT[pname])}
            held[f"{name} {pname}"] = {
                **{k: lead[k] for k in ("close", "max_abs_err",
                                        "rel_l2_err", "finite",
                                        "nonfinite_entries")},
                "exact": exact, "split_comm": lead["comm"],
                "flat_comm": want["comm"]}
            if not all(exact.values()):
                what = ("not the flat run bit for bit" if world == 1 else
                        "an integer no float decides differs from the "
                        "flat run")
                problems.append(f"{name} {pname}: {what}: {exact}")
            if not _gross(lead):
                problems.append(f"{name} {pname}: the plane is not the "
                                f"flat plane's within {SHARD_GROSS_REL}: "
                                f"{held[f'{name} {pname}']}")
        fix_held[name] = {}
        for preset, want in fix_flat.items():
            for r in ranks:
                got = r["fixture"][preset]
                gap = _plane_gap(got["plane"], want["plane"])
                ok = _same_fixture(got, want) and _gross(gap)
                if world == 1:
                    ok = ok and bool(torch.equal(got["plane"],
                                                 want["plane"]))
                if not ok:
                    problems.append(f"{name} fixture {preset} rank "
                                    f"{r['rank']}: comm {got['comm']} vs "
                                    f"flat {want['comm']}, {gap}")
                if r["rank"] == 0:
                    fix_held[name][preset] = gap
        if world == 2:
            got = ranks[0]["train_step"]
            if not (got["synced"] == step_one["synced"] and got["syncs"] > 0
                    and all(r["train_step"]["synced"] == got["synced"]
                            for r in ranks)
                    and all(math.isfinite(x) for x in got["loss"])):
                problems.append(f"make_dynamic_train_step at world 2: "
                                f"{got} against one process's {step_one}")
    summary = {}
    for name, w in worlds.items():
        lead = w["ranks"][0]
        summary[name] = {
            "backend": lead["backend"], "seconds": w["seconds"],
            "fixture": fix_held[name],
            **{kind: {
                "ms_per_round": [x["ms_per_round"] for x in lead[kind]],
                "peak_memory_bytes_per_rank": [
                    r[kind][0]["peak_memory_bytes"] for r in w["ranks"]],
                "collective_bytes_per_round":
                    lead[kind][0]["collective_bytes_per_round"],
                "sqdist_rows_per_rank": [r[kind][0]["sqdist_rows"]
                                         for r in w["ranks"]],
                **held[f"{name} {kind}"]} for kind in SHARD_KINDS},
            "planes": {pname: {
                "ms_per_round": lead["planes"][pname]["ms_per_round"],
                "peak_memory_bytes_per_rank": [
                    r["planes"][pname]["peak_memory_bytes"]
                    for r in w["ranks"]],
                "sqdist_rows_per_rank": [r["planes"][pname]["sqdist_rows"]
                                         for r in w["ranks"]],
                **held[f"{name} {pname}"]} for pname in SPLIT_PLANES}}
    rec = {"phase": "shard_train", "m": M, "batch": B,
           "fixture": {"m": FIXTURE_M, "rounds": FIXTURE_ROUNDS,
                       "card_vs_cpu": fix_agree},
           "flat": {k: {kk: v[kk] for kk in ("ms_per_round",
                                             "peak_memory_bytes",
                                             "sqdist_rows", "comm")}
                    for k, v in {**flat, **flat_planes}.items()},
           "worlds": summary,
           "train_step": {"one_process": step_one,
                          "world2": worlds["S2"]["ranks"][0]["train_step"]},
           "problems": problems}
    emit(rec)
    if problems:
        raise SystemExit(f"shard_train: {problems}")
    return {f"{name} rank {r['rank']} {run}": (
                r["dynamic"][0] if run == "dynamic"
                else r["planes"][run])["sqdist_rows"]
            for name, w in worlds.items() for r in w["ranks"]
            for run in ("dynamic", *SPLIT_PLANES)}


# ---------------------------------------------------------------------------
# slice 11: the single-model step and Proposition 3, the figure twins
# ---------------------------------------------------------------------------
PROP3_ETA = 0.05             # tests/test_protocol_theory.py:30's eta
PROP3_TOL = dict(rtol=1e-4, atol=1e-6)
# Proposition 3 in float32 on the card: the fleet round's and the serial
# step's planes within this share of the norm (relative L2). Each f32
# side is ~1e-5 from the float64 result at mnist_cnn's width, and the two
# sides ~1e-6 of the norm apart; the control, a serial step at (1 + 1/m)
# times the right learning rate (one learner's share of the step too
# many), must land outside it
PROP3_F32_REL = 1e-5
TRAIN_STEP_CALLS = 5         # a step's time: the mean of this many calls


def _row_of(params) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in tree_leaves(params)])


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _prop3(cfg, init, fleet_batch, big, dtype, timed) -> tuple:
    """One σ_1 round of the fleet and one serial step in ``dtype``
    (parameters and images), each timed after a warm-up call, and the
    control, a serial step at (1 + 1/M) times the learning rate: (the
    fleet's row 0, the serial row, the control's row, whether every row
    of the fleet is row 0, the fleet's syncs)."""
    from repro_torch.train import make_train_step
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    p0 = tree_map(lambda x: x.to(dtype), init)
    name = str(dtype).split(".")[-1]

    def cast(batch):
        return {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in batch.items()}

    def fleet():
        return DecentralizedLearner(
            loss_fn, lambda g: p0, M, ProtocolConfig(kind="continuous", b=1),
            TrainConfig(optimizer="sgd", learning_rate=PROP3_ETA * B),
            device="cuda")

    warm = fleet()
    warm.step(cast(fleet_batch))
    del warm
    dl = fleet()
    timed(f"fleet_round_{name}", lambda: dl.step(cast(fleet_batch)), 1)
    rows = []
    for scale in (1.0, 1.0 + 1.0 / M):
        init_state, step = make_train_step(
            loss_fn, TrainConfig(optimizer="sgd", learning_rate=scale * (
                PROP3_ETA / M) * (M * B)), device="cuda")
        state0 = init_state(p0)
        run = lambda: step(state0, cast(big))           # noqa: E731
        run()
        serial, _ = (timed(f"serial_step_{name}", run, TRAIN_STEP_CALLS)
                     if scale == 1.0 else run())
        rows.append(_row_of(serial.params))
    out = (dl.X[0].clone(), *rows, bool(torch.equal(dl.X[0], dl.X[-1])),
           dl.comm_totals["syncs"])
    del dl
    return out


def phase_train_step() -> dict:
    """``repro_torch.train.step`` at mnist_cnn's full width on the card
    (TF32 off). Proposition 3 with m = 100, B = 10, η = 0.05: one σ_1
    round of the fleet (continuous averaging, sgd lr ηB: the paper's
    φ^mSGD) against one ``make_train_step`` step with batch mB = 1,000
    and lr (η/m)·mB. The identity is held within rtol 1e-4 / atol 1e-6
    in float64, where both sides are exact to the card's f64 rounding.
    In float32 each side is itself ~1e-5 from the float64 result, so
    atol 1e-6 cannot hold there: the two f32 planes are held within
    PROP3_F32_REL of the norm, and a control, the serial step at
    (1 + 1/m) times the learning rate, must miss that bound; each side's
    distance from its float64 twin is reported. ``micro_batch`` 4
    against 1 on the same batch of 1,000 (f32, sgd lr 0.1), within TOL.
    Timed by CUDA events after a warm-up call, with the peak memory
    added: a fleet round once (it moves the fleet), a step (a pure
    function) as the mean of TRAIN_STEP_CALLS calls."""
    from repro_torch.train import make_train_step
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = init_cnn_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    fleet_batch = {k: v[0] for k, v in LearnerStreams(
        src, M, batch=B, seed=0).next_chunk(1).items()}
    big = {k: v.reshape((M * B,) + v.shape[2:])
           for k, v in fleet_batch.items()}
    out = {}

    def timed(name, fn, calls):
        def repeat():
            for _ in range(calls):
                res = fn()
            return res
        held = torch.cuda.memory_allocated()
        res, ms, peak = _timed_run(repeat)
        out[name] = {"ms": ms / calls, "calls": calls,
                     "peak_memory_bytes": peak - held}
        return res

    f64, s64, c64, eq64, syncs64 = _prop3(cfg, init, fleet_batch, big,
                                          torch.float64, timed)
    f32, s32, c32, eq32, syncs32 = _prop3(cfg, init, fleet_batch, big,
                                          torch.float32, timed)
    prop3 = {"weights": f32.numel(), "m": M, "B": B, "eta": PROP3_ETA,
             "syncs": [syncs64, syncs32], "rows_equal": eq64 and eq32,
             "f64_max_abs_err": float((f64 - s64).abs().max()),
             "f64_close": bool(torch.allclose(f64, s64, **PROP3_TOL)),
             "f32_max_abs_err": float((f32 - s32).abs().max()),
             "f32_rel_l2_err": _rel_l2(f32, s32),
             "f32_rel_l2_bound": PROP3_F32_REL,
             "control_f32_rel_l2_err": _rel_l2(f32, c32),
             "control_f64_rel_l2_err": _rel_l2(f64, c64),
             "fleet_f32_vs_f64": float((f32.double() - f64).abs().max()),
             "serial_f32_vs_f64": float((s32.double() - s64).abs().max())}
    micro = {}
    for n in (1, 4):
        init_state, step = make_train_step(
            loss_fn, TrainConfig(optimizer="sgd", learning_rate=0.1,
                                 micro_batch=n), device="cuda")
        s0 = init_state(init)
        step(s0, big)
        (s1, res) = timed(f"micro_batch_{n}", lambda: step(s0, big),
                          TRAIN_STEP_CALLS)
        micro[n] = (_row_of(s1.params), float(res["loss"]))
    micro_rec = {"batch": M * B,
                 "max_abs_err": float((micro[4][0] - micro[1][0]).abs()
                                      .max()),
                 "close": bool(torch.allclose(micro[4][0], micro[1][0],
                                              **TOL)),
                 "loss": [micro[1][1], micro[4][1]]}
    rec = {"phase": "train_step", "proposition3": prop3,
           "micro_batch_4_vs_1": micro_rec, "timings": out}
    emit(rec)
    if not (prop3["f64_close"] and prop3["f32_rel_l2_err"] <= PROP3_F32_REL
            and prop3["control_f32_rel_l2_err"] > PROP3_F32_REL
            and prop3["rows_equal"] and prop3["syncs"] == [1, 1]
            and prop3["weights"] == P_MNIST and micro_rec["close"]
            and all(math.isfinite(x) for x in micro_rec["loss"])):
        raise SystemExit(f"train_step: {rec}")
    return rec


# ---------------------------------------------------------------------------
# the twins of the reference's benchmarks (benchmarks/torch_*.py) on the card
# ---------------------------------------------------------------------------

# the reference's quick verdicts (each benchmark's ``run(quick=True)`` and
# ``check``, ``python -m benchmarks.run``, jax 0.9.0 on a CPU): a card
# verdict that differs is reported, not failed
REFERENCE_QUICK_VERDICTS = {
    "scan_driver": "PASS", "fig5_1_dynamic_vs_periodic": "MIXED",
    "dynamic_amortized": "PASS", "fig5_2_fedavg": "PASS",
    "fig5_4_drift": "PASS", "fig5_5_deepdrive": "PASS",
    "fig6_1_scaleout": "PASS", "fig6_2_init_heterogeneity": "PASS",
    "figA6_optimizers": "PASS", "figC_unbalanced": "PASS",
    "fig_network_regimes": "PASS", "fig_hierarchy": "PASS",
    "sync_bench": "PASS", "shard_bench": "PASS", "async_bench": "PASS",
    "robust_bench": "PASS", "kernel_bench": "PASS",
    "roofline_table": "NO-DATA"}
# the rows' exactness fields: one that is False fails the phase (None:
# the field does not apply to that row)
TWIN_EXACT = ("comm_totals_equal", "counters_equal", "stream_exact",
              "zero_delay_exact", "fault_off_bitwise", "ledger_balanced",
              "params_close", "syncs_equal")
# twins whose quick grid the phase leaves out, each with the reason; their
# cut rows run all the same
QUICK_LEFT_OUT = {
    "shard_bench": ("its sweep is a spawn of ranks a world (1, 2, 4, 8), "
                    "each ~25 s to reach the card, 136.4 s in all: past "
                    "the phase's 180 s with the others. Its cut row holds "
                    "a 2-rank world's counters to the flat run; "
                    "`python -m benchmarks.torch_run --only shard_bench` "
                    "runs the sweep")}


def _cut_integers(dl, extra) -> dict:
    """A cut row's integers: the learner's counters, bytes and ledger,
    and every integer, bool or integer array among ``extra``'s values
    (integers of a dict value too)."""
    out = {}
    if dl is not None:
        out = {"comm": dict(dl.comm_totals), "comm_bytes": dl.comm_bytes(),
               "ledger": [int(x) for x in dl.per_link_bytes()]}
    for k, v in extra.items():
        if v is None or isinstance(v, (bool, int)):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = {a: b for a, b in v.items()
                      if isinstance(b, (bool, int))}
        elif isinstance(v, (list, np.ndarray)) and \
                np.asarray(v).dtype.kind in "iub":
            out[k] = [int(x) for x in np.asarray(v).ravel()]
    return out


def _twin_cut(mod, case) -> dict:
    """``case`` of the twin's ``CUT`` on the CPU from the twin's own
    source (recorded), then on the card from the recorded draws, each
    from the same initial model (``torch_common.cut_init``): each run's
    integers (comm counters, bytes, ledger; the sync curve of the drift
    figure; the twin's own counts), whether its loss is finite, and the
    twin's check on the rows it gives."""
    from benchmarks.torch_common import RecordSource, ReplaySource, cut_init
    init = cut_init(mod)
    make_source = getattr(mod, "default_source", None)
    rec = RecordSource(make_source("cpu")) if make_source else None
    runs = {}
    for device in ("cpu", "cuda"):
        src = (rec if device == "cpu" or rec is None
               else ReplaySource(rec.batches, device))
        init_fn = None if init is None else (
            lambda g, d=device: params_from_numpy(init, device=d))
        dl, extra = mod.cut(case, device, src, init_fn)
        runs[device] = {
            "integers": _cut_integers(dl, extra),
            "finite": dl is None or math.isfinite(dl.cumulative_loss),
            "verdict": mod.check(extra["rows"]) if "rows" in extra else None}
    return runs


def _finite_row(row: dict) -> bool:
    return all(math.isfinite(v) for v in row.values()
               if isinstance(v, float))


def _twin_problems(name: str, rows: list) -> list:
    """A twin's rows against the phase's failures: a non-finite value, a
    False exactness field, sync_bench's cohort off m/2, a kernel_bench
    error of 0.1 or more, but sqdist's, which is held to TOL's rtol of its
    value: near 2.4e6 at the reference's shape one f32 step is 0.25, so
    the reference's absolute 0.1 (its check, reported, not failed) asks
    for the plain version's summation order."""
    out = []
    for r in rows:
        if not _finite_row(r):
            out.append(f"{name}: a non-finite value in {r}")
        out += [f"{name}: {f} is False in {r}" for f in TWIN_EXACT
                if r.get(f) is False]
        if name == "sync_bench" and r.get("layout") in ("tree", "flat") \
                and r["cohort"] != r["m"] // 2:
            out.append(f"sync_bench: cohort {r['cohort']} at m = {r['m']}")
        if name == "kernel_bench" and not (
                r["rel_err_vs_oracle"] <= TOL["rtol"] if "rel_err_vs_oracle"
                in r else r.get("max_err_vs_oracle", 1) < 0.1):
            out.append(f"kernel_bench: error past its bound in {r}")
        if name == "kernel_bench" and r.get("launches") != 1:
            out.append(f"kernel_bench: {r.get('launches')} launches a call "
                       f"of {r['kernel']}, not 1")
    return out


def phase_twins() -> tuple:
    """Every twin of the reference's benchmarks (``torch_run.ALL``: the
    eight figures and the ten others, ``roofline_table`` last, which finds
    no records here: the ``launch`` phase writes them) at the reference's
    quick settings
    on the card, each verdict with its seconds and rows beside the
    reference's quick verdict on the CPU (a difference is reported, not
    failed), but for the twins of ``QUICK_LEFT_OUT`` (shard_bench: a
    world is a spawn of ranks, and its sweep alone outlasts the phase's
    180 s), with the grids' ``sqdist_rows`` launches, figures and others
    apart (kernel_bench's are its timed calls, one launch a call of each
    of its five kernels, timed beside ``kernel_bound``). Then each twin's
    ``CUT`` cases on the CPU from the twin's own draws and on the card
    from the same draws and initial model: integers identical, and the
    twin's check passes where the case gives rows. Fails on an
    exception, a non-finite value, a False exactness field
    (``TWIN_EXACT``), sync_bench's cohort off m/2, a kernel_bench error
    past its bound (``_twin_problems``), a card/CPU integer mismatch, or
    a ``sqdist_rows`` launch at a plane the kernels phase did not hold to
    its plain version (``twin_planes``)."""
    problems, twins, kernel_rows = [], {}, []
    launches = {"figures": 0, "others": 0}
    grid_s = {"figures": 0.0, "others": 0.0}
    ops.reset_launches()
    for mod in torch_run.ALL:
        path = "figures" if mod in torch_run.FIGURES else "others"
        want = REFERENCE_QUICK_VERDICTS[mod.NAME]
        if mod.NAME in QUICK_LEFT_OUT:
            twins[mod.NAME] = {"verdict": "not run",
                               "reference_cpu_verdict": want,
                               "reason": QUICK_LEFT_OUT[mod.NAME]}
            continue
        before = ops.LAUNCHES["sqdist_rows"]
        verdict, rows, sec = torch_run.run_one(mod, True, "cuda")
        if mod.NAME == "kernel_bench":
            kernel_rows = rows
        else:
            launches[path] += ops.LAUNCHES["sqdist_rows"] - before
        grid_s[path] += sec
        twins[mod.NAME] = {
            "verdict": verdict, "reference_cpu_verdict": want,
            "differs": verdict != want, "seconds": sec,
            "rows": [{k: v for k, v in r.items()
                      if not isinstance(v, (list, dict))} for r in rows]}
        if str(verdict).startswith("ERROR"):
            problems.append(f"{mod.NAME}: {verdict}")
        problems += _twin_problems(mod.NAME, rows)
    t0 = time.perf_counter()
    cuts = {}
    for mod in torch_run.ALL:
        for i, case in enumerate(mod.CUT):
            runs = _twin_cut(mod, case)
            card, cpu = runs["cuda"], runs["cpu"]
            key = f"{mod.NAME} {i}"
            cuts[key] = {"case": _js(case),
                         "integers_identical":
                             _js(card["integers"]) == _js(cpu["integers"]),
                         "integers": card["integers"]}
            if not (cuts[key]["integers_identical"] and card["finite"]
                    and card["verdict"] in (None, "PASS")):
                problems.append(f"{key} cut row: card {card} vs CPU {cpu}")
    cut_s = time.perf_counter() - t0
    # every plane the grids and the cut rows gave sqdist_rows was held to
    # its plain version in the kernels phase
    shapes = {"x".join(map(str, k)): v for k, v in ops.ROWS_LAUNCHES.items()}
    unchecked = sorted(set(ops.ROWS_LAUNCHES) - set(twin_planes()))
    if unchecked:
        problems.append(f"sqdist_rows at planes the kernels phase did not "
                        f"check: {unchecked}")
    rec = {"phase": "twins", "quick_grid_seconds": grid_s,
           "cut_seconds": cut_s, "sqdist_rows": launches,
           "sqdist_rows_by_plane": shapes, "twins": twins,
           "cut_rows": cuts, "problems": problems}
    emit(rec)
    if problems:
        raise SystemExit(f"twins: {problems}")
    return launches, {r["kernel"]: r for r in kernel_rows}


# ---------------------------------------------------------------------------
# LM training (slice 14): the backward kernels, llama3-8b at full width and
# the fleet LM of examples/torch_fleet_llm.py
# ---------------------------------------------------------------------------

# a backward kernel's gradient against the autograd gradient of its plain
# version, in f32 and in float64: max |diff| over max |want|, each of dq,
# dk, dv (dx, dscale). f32 on both sides, summed in other orders (a query
# row's sums run over up to 4,096 keys): the f32 forward's rtol, 1e-4
TRAIN_GRAD_REL = 1e-4
# the forward's log-sum-exp against logsumexp of the plain scores
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
# (B, Sq, Sk, H, Hkv, d, causal, window, label), d the head width or MLA's
# (query/key, value) widths; the first TRAIN_ATTN_TIMED are timed,
# TIME_REPEATS times each by CUDA events (median and spread)
TIME_REPEATS = 7
TRAIN_ATTN_MLA = "deepseek-v2-236b MLA (1, 4096, 128, 192/128)"
TRAIN_ATTN_CASES = [
    (1, 4096, 4096, 32, 8, 128, True, 0, "llama3-8b (1, 4096, 32/8, 128)"),
    # fleet-llm-100m keeps llama3-8b's head_dim of 128
    # (examples/fleet_llm.py replaces the widths, not head_dim)
    (16, 128, 128, 12, 4, 128, True, 0,
     "fleet-llm-100m, 4 learners folded (16, 128, 12/4, 128)"),
    # hymba-1.5b's banded attention, also through ops.swa_attention under a
    # gradient (TRAIN_ATTN_BANDED)
    (1, 4096, 4096, 25, 5, 64, True, 1024,
     "hymba-1.5b banded (1, 4096, 25/5, 64), w 1,024"),
    # deepseek-v2-236b's MLA at its training shape: 128 heads of 128 + 64
    # rope by 128
    (1, 4096, 4096, 128, 128, (192, 128), True, 0, TRAIN_ATTN_MLA),
    # deepseek-v2-236b-smoke's widths, 4 learners folded, as the fleet's
    # vmap rule launches them
    (4, 128, 128, 8, 8, (48, 32), True, 0,
     "deepseek-v2-236b-smoke, 4 learners folded (4, 128, 8, 48/32)"),
    (16, 128, 128, 12, 4, 64, True, 0, "(16, 128, 12/4, 64)"),
    # C1's guard at MLA's widths: keys past a ragged Sk masked, no causal
    (2, 100, 160, 4, 4, (192, 128), False, 0, "MLA non-causal, Sk != Sq"),
    (1, 70, 130, 4, 2, (48, 32), False, 0,
     "MLA smoke widths non-causal, Sk != Sq, GQA group 2"),
    (2, 100, 100, 4, 4, 64, True, 0, "ragged S, GQA group 1"),
    (1, 130, 130, 8, 2, 128, True, 0, "ragged S, GQA group 4"),
    (1, 300, 300, 8, 2, 64, True, 64, "a window of 64"),
    (2, 70, 90, 4, 1, 32, False, 0, "non-causal, Sk != Sq"),
    # the launch phase's fleets: llama3-8b, 2 learners folded, one
    # sequence of 1,024 each
    (2, 1024, 1024, 32, 8, 128, True, 0,
     "llama3-8b fleet, 2 learners folded (2, 1024, 32/8, 128)"),
]
TRAIN_ATTN_TIMED = 5            # the first cases, each timed
TRAIN_ATTN_BANDED = "hymba-1.5b banded (1, 4096, 25/5, 64), w 1,024"
# ssd_scan_bwd: (BH, S, P, N, chunk, R, dh, strong decay, label); the
# first two are timed. Inputs as ssm_kernels draws them: x, b, c, dy ~
# N(0, 1), dt = softplus(N(0, 1)), a = -exp(N(0, 1)); strong: dt 4 + 1
# and a 4, dt |a| about 15 a step (a chunk's cum to about -120, so exp
# above the diagonal would overflow), strong enough to test the mask and
# weak enough that the decays of neighbouring steps, which da's gradient
# sums, stay above f32's smallest normal
SSD_BWD_CASES = [
    (80, 4096, 64, 128, 64, 80, False, False,
     "mamba2-2.7b (80, 4096, 64, 128), chunk 64, R 80"),
    (50, 4096, 64, 16, 64, 50, False, False,
     "hymba-1.5b (50, 4096, 64, 16), chunk 64, R 50"),
    (8, 256, 64, 128, 8, 4, True, False, "chunk 8, R 4, dh"),
    (6, 512, 32, 64, 16, 1, False, False, "chunk 16, R 1, P 32, N 64"),
    (4, 384, 64, 16, 32, 2, True, False, "chunk 32, R 2, dh"),
    (3, 200, 48, 20, 8, 3, True, True, "chunk 8, P 48, N 20, strong decay"),
    # the tiling's edges: a slab of 64 and one of 36, a partial row tile
    (6, 256, 40, 100, 16, 2, True, False, "chunk 16, R 2, P 40, N 100"),
    # N 72 past a slab, P 24 (one and a half row tiles), R > 1 at chunk 8
    (8, 128, 24, 72, 8, 4, False, False, "chunk 8, R 4, P 24, N 72"),
    # the narrowest tiles, N 8; and the walk's blocks of four warps
    (2, 64, 64, 8, 32, 1, True, False, "chunk 32, N 8, dh"),
    (64, 512, 64, 128, 64, 16, False, True,
     "chunk 64, R 16, walk blocks of two warps, strong decay"),
]
SSD_BWD_TIMED = 2
# vmap over learners: (m, BH, S, P, N, chunk, R)
SSD_BWD_VMAP = (4, 16, 512, 64, 128, 64, 16)
# a padded S through ops.ssd_scan: (BH, S, P, N, chunk, R)
SSD_BWD_PADDED = (4, 300, 64, 128, 64, 4)
# (rows, D, groups, offset, label); offset > 0: rows off 16 bytes
TRAIN_NORM_CASES = [
    (4096, 4096, 1, 0, "(4096, 4096), one scale"),
    (4096, 4096, 4, 0, "(4096, 4096), m = 4 groups"),
    (2048, 768, 4, 0, "fleet-llm-100m's (4 x 512, 768), 4 groups"),
    (33, 1601, 1, 1, "rows off 16 bytes"),
    (12, 200, 3, 3, "rows off 16 bytes, 3 groups"),
    (2048, 4096, 2, 0, "llama3-8b fleet's (2 x 1024, 4096), 2 groups"),
]
# bf16 (A28): the backward kernels against the f32 gradient of their plain
# versions on the same bf16 inputs (the yardstick), each gradient's max
# |diff| over its max at most BF16_VS_LIBRARY times what one PyTorch call
# (SDPA's bf16 backward, F.rms_norm's) reaches against the same yardstick,
# printed beside it: both round the gradients to bf16 once, and SDPA also
# rounds P and dS to bf16 where the kernel does
BF16_VS_LIBRARY = 2.0
# (B, Sq, Sk, H, Hkv, d, causal, window, label); the first
# TRAIN_ATTN_BF16_TIMED timed, TIME_REPEATS times each (median and spread)
TRAIN_ATTN_BF16_CASES = [
    (1, 4096, 4096, 32, 8, 128, True, 0, "llama3-8b (1, 4096, 32/8, 128)"),
    (1, 4096, 4096, 128, 128, (192, 128), True, 0, TRAIN_ATTN_MLA),
    (1, 4096, 4096, 25, 5, 64, True, 1024, TRAIN_ATTN_BANDED),
    (2, 1024, 1024, 32, 8, 128, True, 0,
     "llama3-8b fleet, 2 learners folded (2, 1024, 32/8, 128)"),
    # C1's guard: keys past a ragged Sk masked, no causal
    (2, 70, 90, 4, 1, 32, False, 0, "non-causal, Sk != Sq"),
    (2, 100, 160, 4, 4, (192, 128), False, 0, "MLA non-causal, Sk != Sq"),
]
TRAIN_ATTN_BF16_TIMED = 4
# (rows, D, groups, label), all timed; the last's D is no multiple of 8,
# so every other row starts 8 bytes past a 16-byte boundary: the vector
# form's scalar head and tail
TRAIN_NORM_BF16_CASES = [
    (4096, 4096, 1, "(4096, 4096), one scale"),
    (2048, 4096, 2, "llama3-8b fleet's (2 x 1024, 4096), 2 groups"),
    (4096, 4100, 1, "(4096, 4100), rows off 16 bytes"),
]
# a direct bf16 ops.ssd_scan under a gradient, the f32 route: (BH, S, P, N,
# chunk, R); its gradients are the f32 kernel's (within TRAIN_GRAD_REL)
# rounded to bf16 once: within one bf16 step of each gradient's max of the
# plain version's in f32 on the same inputs
SSD_BF16_CASE = (16, 512, 64, 128, 64, 16)
SSD_BF16_REL = 2.0 ** -8
LM_TRAIN_LAYERS, LM_TRAIN_S, LM_TRAIN_STEPS = 2, 4096, 6
# the σ_1 cells, each at full width and LM_TRAIN_LAYERS layers
LM_TRAIN_ARCHS = ("llama3-8b", "mamba2-2.7b", "hymba-1.5b")
# step 1's gradient through the kernels against the plain versions', as
# the relative L2 over the whole model (the two differ only in the
# attention's and the norms' f32 summation orders)
LM_TRAIN_GRAD_L2 = 1e-4
# the MoE σ_1 cells: the reference's production train program
# (src/repro/launch/specs.py: TrainConfig(optimizer="sgd", remat=True)) at
# full width, f32, B = 1, S = LM_TRAIN_S, sgd at LM_MOE_LR (the six losses
# fall). Depth: the step holds the weights, the gradient and the new
# weights (3 x 4 bytes a weight); deepseek-v2-236b has 5.02e9 weights at
# 1 layer (60 GB) and 8.99e9 at 2 (108 GB), mixtral-8x22b 5.41e9 at 2 (65
# GB; its step's peak 65.26 GB with remat and without,
# benchmarks/torch_remat_memory.py) and 7.91e9 at 3 (95 GB)
LM_MOE_LAYERS = {"deepseek-v2-236b": 1, "mixtral-8x22b": 2}
LM_MOE_LR = 0.1
# their step-1 check's S: the plain attention keeps a (heads, S, S) f32
# score tensor a layer for its backward (8.6 GB at deepseek's 128 heads
# and S = 4,096) beside the weights and both gradients (60 GB); the
# attention backward at the full shape is TRAIN_ATTN_MLA's case
LM_MOE_CHECK_S = 1024
# Δ among the checked distances (the largest learner's squared distance
# from the reference) of a run that syncs at every check: 131.7 at the
# first, falling to 26.3 at the sixth on the H100 at b = 10. fleet_llm.py's
# default Δ = 5 lies below them all, which makes the run periodic
# averaging; at 45 it must both sync and hold, 0 < syncs < checks
FLEET_M, FLEET_STEPS, FLEET_PERIOD, FLEET_DELTA = 4, 60, 10, 45.0
# lm_train_agree: llama3-8b-smoke, card vs CPU for 20 adam steps (lr
# 1e-3). adam moves a weight whose gradient is at f32's noise level by up
# to lr a step, so the kernels' last bits move such weights by up to lr:
# planes within 1e-3 of their norm and 2 lr x 20 entry by entry, losses
# within rtol 1e-4 (tests/test_torch_lm_train.py's bounds, jax vs port)
AGREE_STEPS, AGREE_LR = 20, 1e-3
AGREE_PLANE_REL, AGREE_PLANE_ABS = 1e-3, 2 * AGREE_LR * AGREE_STEPS
AGREE_DYNAMIC = (2, 1.5)         # (b, delta) of the agree dynamic run


def _median_spread(key: str, times: list) -> dict:
    """``key``: the median of repeated timings, ``key_spread``: their
    least and greatest."""
    return {key: float(np.median(times)),
            f"{key}_spread": [min(times), max(times)]}


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _hold_grads(checks, name, label, got, again, want32, want64) -> None:
    """A backward kernel's gradients against the plain version's in f32
    and float64, and bitwise against a second launch."""
    err32 = [_rel_max(a, w) for a, w in zip(got, want32)]
    err64 = [_rel_max(a, w) for a, w in zip(got, want64)]
    plain64 = [_rel_max(w, w64) for w, w64 in zip(want32, want64)]
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = repeat and max(err32 + err64) <= TRAIN_GRAD_REL
    checks.append({"kernel": name, "inputs": label,
                   "rel_err_vs_plain_f32": err32,
                   "rel_err_vs_plain_f64": err64,
                   "plain_f32_rel_err_vs_f64": plain64,
                   "max_abs_err": max(float((a - w).abs().max())
                                      for a, w in zip(got, want32)),
                   "bitwise_repeat": repeat, "ok": ok})
    if not ok:
        emit({"phase": "lm_train_kernels", "failed": checks[-1]})
        raise SystemExit(f"{name} disagrees: {checks[-1]}")


def phase_lm_train_kernels(gen, ptxas: list) -> dict:
    """The two backward kernels (``attention_bwd``, ``rmsnorm_bwd``)
    against the autograd gradient of their plain versions on the card, in
    f32 and float64 (TRAIN_GRAD_REL), bitwise across two launches, at the
    training paths' shapes and the kernels' edges; the f32 forward's
    log-sum-exp against ``logsumexp`` of the plain scores and both
    forwards' outputs against their plain versions (LM_TOL); the grouped
    forward norm against one call per group, bit for bit. Timed at
    llama3-8b's and the fleet's shapes beside the plain version, one
    PyTorch call (SDPA's f32 backward with the kv heads expanded,
    ``F.rms_norm``'s backward; their forward outside the timing) and
    ``kernel_bound`` (split TF32 and the CUDA cores' f32). The
    attention rows name the program (split-TF32 ``mma.sync``, as the f32
    forward's) and its kernels' registers and spills (``ptxas``, the
    build phase's lines). Then bf16 (A28): ``attention_bwd`` in bf16
    (``_bf16_attention_bwd``), ``rmsnorm_bwd`` in bf16
    (``_bf16_norm_bwd``) and a direct bf16 ``ops.ssd_scan`` gradient
    (``_bf16_ssd_route``)."""
    card = peaks(torch.cuda.get_device_name(0))
    checks, lse_errs, fwd_errs, norm_errs, timed = [], [], [], [], {}
    t0 = time.perf_counter()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for B, Sq, Sk, H, Hkv, d, causal, w, label in TRAIN_ATTN_CASES:
        d, dv = (d, d) if isinstance(d, int) else d
        q, k = randn(B, Sq, H, d), randn(B, Sk, Hkv, d)
        v, do = randn(B, Sk, Hkv, dv), randn(B, Sq, H, dv)
        kw = dict(causal=causal, window=w, scale=None)
        o, lse = flash_attention.attention(q, k, v, with_lse=True, **kw)
        lse_want = ref.attention_lse_ref(q, k, causal=causal, window=w)
        lse_errs.append(float((lse - lse_want).abs().max()))
        if not torch.allclose(lse, lse_want, **LSE_TOL):
            raise SystemExit(f"the forward's log-sum-exp at {label}: "
                             f"{lse_errs[-1]}")
        if not torch.equal(o, flash_attention.flash_attention_gqa(
                q, k, v, causal=causal, window=w)):
            raise SystemExit(f"the forward with the log-sum-exp gives "
                             f"another output at {label}")
        o_want = ref.flash_attention_gqa_ref(q, k, v, causal=causal,
                                             window=w)
        fwd_errs.append(float((o - o_want).abs().max()))
        if not torch.allclose(o, o_want,
                              **LM_TOL["attention", torch.float32]):
            raise SystemExit(f"the f32 forward at {label} disagrees with "
                             f"its plain version: {fwd_errs[-1]}")
        del o_want
        got = flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)
        want32 = ref.flash_attention_gqa_bwd_ref(q, k, v, do, **kw)
        want64 = ref.flash_attention_gqa_bwd_ref(
            q.double(), k.double(), v.double(), do.double(), **kw)
        torch.cuda.synchronize()
        _hold_grads(checks, "attention_bwd", label, got, again, want32,
                    want64)
        del again, want32, want64
        if label == TRAIN_ATTN_BANDED:
            banded_route = _swa_route(q, k, v, o, do, w, got)
        if len(timed) < TRAIN_ATTN_TIMED:
            G = H // Hkv
            qT, kE, vE = (t.transpose(1, 2) for t in (q, k, v))
            qT = qT.contiguous().requires_grad_()
            kE, vE = (t.repeat_interleave(G, dim=1).contiguous()
                      .requires_grad_() for t in (kE, vE))
            band = None
            if w:
                pos = torch.arange(Sq, device="cuda")
                band = ((pos[None, :] <= pos[:, None])
                        & (pos[None, :] > pos[:, None] - w))
            out, backend = _sdpa_f32(qT, kE, vE, band, causal)
            doT = do.transpose(1, 2).contiguous()
            shape = [B, Sq, Sk, H, Hkv, d if d == dv else [d, dv]] + (
                [w] if w else [])
            bwd = lambda: flash_attention.attention_bwd(  # noqa: E731
                q, k, v, o, lse, do, **kw)
            lib = lambda: torch.autograd.grad(  # noqa: E731
                out, (qT, kE, vE), doT, retain_graph=True)
            reps, lib_reps = ([cuda_ms(f, 5, 1) for _ in range(TIME_REPEATS)]
                              for f in (bwd, lib))
            timed[label] = {
                "shape": shape, "label": label, "dtype": "float32",
                "program": flash_attention.bwd_program(torch.float32),
                **_median_spread("ms", reps),
                # the device's time alone, and the host's time in a call:
                # the larger of the two sets the back-to-back time
                "graph_ms": graph_ms(bwd, *((2, 3) if min(reps) > 1
                                            else (10, 5))),
                "host_ms": host_us(bwd, 20, 2) / 1e3,
                "plain_ms": cuda_ms(lambda: ref.flash_attention_gqa_bwd_ref(
                    q, k, v, do, **kw), 3, 1),
                **_median_spread("library_ms", lib_reps),
                "library_backend": backend,
                "library": "autograd.grad of F.scaled_dot_product_attention"
                           + ("(band mask)" if w else "(is_causal=True)")
                           + ", kv heads expanded, f32 (its forward "
                           "untimed)" + ("" if d == dv else
                                         f", value width {dv} of {d}"),
                "forward_ms": cuda_ms(lambda: flash_attention.attention(
                    q, k, v, with_lse=True, **kw), 5, 1),
                **kernel_bound("attention_bwd", shape, torch.float32, card)}
            row = timed[label]
            row["time_set_by"] = ("host" if row["host_ms"] > row["graph_ms"]
                                  else "device")
            del qT, kE, vE, out, doT, bwd, lib, band
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()
    attn_rows = list(timed.values())
    attn_rows[TRAIN_ATTN_TIMED - 1]["through_ops_swa_attention"] = \
        banded_route

    timed = {}
    for rows, D, g, off, label in TRAIN_NORM_CASES:
        x = randn(rows * D + off)[off:].view(rows, D)
        s = 1.0 + 0.1 * (randn(g, D) if g > 1 else randn(D))
        dy = randn(rows, D)
        got = rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5)
        again = rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5)
        want32 = ref.rmsnorm_bwd_ref(x, s, dy, 1e-5)
        want64 = ref.rmsnorm_bwd_ref(x.double(), s.double(), dy.double(),
                                     1e-5)
        torch.cuda.synchronize()
        _hold_grads(checks, "rmsnorm_bwd", label, got, again, want32, want64)
        # the forward against its plain version (grouped scales too)
        y = rmsnorm.rmsnorm(x, s, 1e-5)
        y_want = ref.rmsnorm_ref(x, s, 1e-5)
        norm_errs.append(float((y - y_want).abs().max()))
        if not torch.allclose(y, y_want, **LM_TOL["rmsnorm", torch.float32]):
            raise SystemExit(f"the f32 rmsnorm at {label} disagrees with "
                             f"its plain version: {norm_errs[-1]}")
        del y_want
        if g > 1:   # the grouped forward: one call per group, bit for bit
            R = rows // g
            if not all(torch.equal(y[i * R:(i + 1) * R], rmsnorm.rmsnorm(
                    x[i * R:(i + 1) * R].contiguous(), s[i], 1e-5))
                    for i in range(g)):
                raise SystemExit(f"the grouped rmsnorm at {label} is not "
                                 f"one call per group bit for bit")
        if rows * D >= 2048 * 768 and off == 0:
            xg = x.clone().requires_grad_()
            sg = s.clone().requires_grad_()
            shape = [rows, D] + ([g] if g > 1 else [])
            rec = {"shape": shape, "dtype": "float32",
                   "ms": cuda_ms(lambda: rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5)),
                   "plain_ms": cuda_ms(lambda: ref.rmsnorm_bwd_ref(
                       x, s, dy, 1e-5), 5, 1),
                   "forward_ms": cuda_ms(lambda: rmsnorm.rmsnorm(x, s,
                                                                 1e-5)),
                   **kernel_bound("rmsnorm_bwd", shape, torch.float32, card)}
            if g == 1:
                y = F.rms_norm(xg, (D,), weight=sg, eps=1e-5)
                rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    y, (xg, sg), dy, retain_graph=True))
                rec["library"] = ("autograd.grad of F.rms_norm, f32 (its "
                                  "forward untimed)")
                del y
            else:
                rec["library_ms"] = None
                rec["library"] = "none: no PyTorch call takes grouped scales"
            timed[label] = rec
            del xg, sg
        del x, s, dy, got, again, want32, want64
    norm_rows = list(timed.values())
    ssd_rows, ssd_extra = _ssd_bwd_checks(randn, checks, card)
    worst = {n: max(c["max_abs_err"] for c in checks if c["kernel"] == n
                    and "dtype" not in c)
             for n in ("attention_bwd", "rmsnorm_bwd", "ssd_scan_bwd")}
    # bf16 (A28)
    t1 = time.perf_counter()
    attn_bf16 = _bf16_attention_bwd(randn, checks, card)
    norm_bf16 = _bf16_norm_bwd(randn, checks, card)
    ssd_bf16 = _bf16_ssd_route(randn)
    seconds = {"float32": t1 - t0, "bfloat16": time.perf_counter() - t1}
    worst_bf16 = {n: max(c["max_abs_err"] for c in checks
                         if c["kernel"] == n and "dtype" in c)
                  for n in ("attention_bwd", "rmsnorm_bwd")}
    bwd_kernels = {k: v for k, v in kernel_resources(
        ptxas, "attention_bwd_").items()
        if not k.startswith("attention_bwd_bf16_")}
    bf16_kernels = kernel_resources(ptxas, "attention_bwd_bf16_")
    ssd_kernels = kernel_resources(ptxas, "ssd_scan_bwd_")
    emit({"phase": "lm_train_kernels", "checks": checks,
          "lse_max_abs_err": max(lse_errs),
          # each case's forward against its plain version (LM_TOL, f32)
          "forward_max_abs_err": {"flash_attention": max(fwd_errs),
                                  "rmsnorm": max(norm_errs)},
          "tolerance_rel_of_max": TRAIN_GRAD_REL, "lse_tolerance": LSE_TOL,
          "timed": {"attention_bwd": attn_rows, "rmsnorm_bwd": norm_rows,
                    "ssd_scan_bwd": ssd_rows,
                    "attention_bwd_bf16": attn_bf16,
                    "rmsnorm_bwd_bf16": norm_bf16},
          "bf16_tolerance": f"<= {BF16_VS_LIBRARY} x the library's error "
                            f"against the f32 yardstick",
          "ssd_scan_bwd_vmap_and_padded": ssd_extra,
          "ssd_scan_bf16_route": ssd_bf16, "seconds": seconds,
          "attention_bwd_ptxas": bwd_kernels,
          "attention_bwd_bf16_ptxas": bf16_kernels,
          "ssd_scan_bwd_ptxas": ssd_kernels})
    return {"attention_bwd": {**attn_rows[0],
                              "max_abs_err": worst["attention_bwd"],
                              "at_fleet_shape": attn_rows[1],
                              "banded": attn_rows[2],
                              "at_mla_shape": attn_rows[3],
                              "at_mla_smoke_shape": attn_rows[4],
                              "ptxas_by_kernel": bwd_kernels},
            "rmsnorm_bwd": {**norm_rows[0],
                            "max_abs_err": worst["rmsnorm_bwd"],
                            "other_shapes": norm_rows[1:],
                            "bf16": {**norm_bf16[0],
                                     "max_abs_err": worst_bf16["rmsnorm_bwd"],
                                     "other_shapes": norm_bf16[1:]}},
            "ssd_scan_bwd": {**ssd_rows[0],
                             "max_abs_err": worst["ssd_scan_bwd"],
                             "at_hymba_shape": ssd_rows[1],
                             **ssd_extra, "ptxas_by_kernel": ssd_kernels,
                             "bf16_route": ssd_bf16},
            "attention_bwd_bf16": {**attn_bf16[0],
                                   "max_abs_err": worst_bf16["attention_bwd"],
                                   "at_mla_shape": attn_bf16[1],
                                   "banded": attn_bf16[2],
                                   "at_fleet_shape": attn_bf16[3],
                                   "ptxas_by_kernel": bf16_kernels}}


def _sdpa_f32(q, k, v, mask, causal) -> tuple:
    """SDPA's f32 output on (B, H, S, d) leaves for the library timing,
    and the backend that took it: the memory-efficient one (the default
    for f32, which the flash and cuDNN backends do not take) where it
    takes these widths, else the math one."""
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask,
                    is_causal=causal and mask is None), backend.name
        except RuntimeError:
            continue
    raise SystemExit("no SDPA backend takes the f32 case")


def _sdpa_bf16(q, k, v, mask, causal) -> tuple:
    """SDPA's bf16 output on (B, H, S, d) tensors for the library's
    error and timing, and the backend that took it: flash where it takes
    the case (equal widths, no mask), else the memory-efficient one."""
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask,
                    is_causal=causal and mask is None), backend.name
        except RuntimeError:
            continue
    raise SystemExit("no SDPA backend takes the bf16 case")


def _bf16_failed(rec: dict, what: str) -> None:
    emit({"phase": "lm_train_kernels", "failed": rec})
    raise SystemExit(f"{what}: {rec}")


def _bf16_attention_bwd(randn, checks, card) -> list:
    """The bf16 attention backward (``csrc/attention_bwd_bf16.cu``) at
    TRAIN_ATTN_BF16_CASES: the bf16 forward's log-sum-exp against
    ``logsumexp`` of the plain scores (LSE_TOL), its output bit for bit
    the serving launch's; dq, dk and dv in bf16, bitwise across two
    launches, against the f32 yardstick within BF16_VS_LIBRARY times
    SDPA's bf16 backward (kv heads expanded in its graph, so its dk and dv
    sum the group); the banded case also through ``ops.swa_attention``
    under a gradient. The first TRAIN_ATTN_BF16_TIMED timed beside SDPA's
    backward (its forward untimed), the plain version and
    ``kernel_bound``'s bf16 bound, with the forward that writes the
    log-sum-exp beside the serving launch."""
    rows = []
    for i, (B, Sq, Sk, H, Hkv, d, causal, w, label) in enumerate(
            TRAIN_ATTN_BF16_CASES):
        d, dv = (d, d) if isinstance(d, int) else d
        q, k = randn(B, Sq, H, d).bfloat16(), randn(B, Sk, Hkv, d).bfloat16()
        v = randn(B, Sk, Hkv, dv).bfloat16()
        do = randn(B, Sq, H, dv).bfloat16()
        kw = dict(causal=causal, window=w, scale=None)
        o, lse = flash_attention.attention(q, k, v, with_lse=True, **kw)
        lse_want = ref.attention_lse_ref(q, k, causal=causal, window=w)
        lse_err = float((lse - lse_want).abs().max())
        if not torch.allclose(lse, lse_want, **LSE_TOL):
            _bf16_failed({"inputs": label, "lse_max_abs_err": lse_err},
                         "the bf16 forward's log-sum-exp")
        if not torch.equal(o, flash_attention.flash_attention_gqa(
                q, k, v, causal=causal, window=w)):
            _bf16_failed({"inputs": label}, "the bf16 forward with the "
                         "log-sum-exp gives another output than serving's")
        got = flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_gqa_bwd_ref(
            q.float(), k.float(), v.float(), do.float(), **kw)
        G = H // Hkv
        qT = q.transpose(1, 2).contiguous().requires_grad_()
        kT, vT = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (k, v))
        kE, vE = (t.repeat_interleave(G, dim=1) for t in (kT, vT))
        mask = None
        if w or (causal and Sq != Sk):
            qp = torch.arange(Sq, device="cuda")[:, None] + Sk - Sq
            kp = torch.arange(Sk, device="cuda")[None, :]
            mask = kp <= qp
            if w:
                mask = mask & (kp > qp - w)
        out, backend = _sdpa_bf16(qT, kE, vE, mask, causal)
        doT = do.transpose(1, 2).contiguous()
        lib = [g.transpose(1, 2) for g in torch.autograd.grad(
            out, (qT, kT, vT), doT, retain_graph=True)]
        torch.cuda.synchronize()
        err = [_rel_max(a, x) for a, x in zip(got, want)]
        lib_err = [_rel_max(a, x) for a, x in zip(lib, want)]
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = (repeat and all(g.dtype == torch.bfloat16 for g in got)
              and all(e <= BF16_VS_LIBRARY * e_lib
                      for e, e_lib in zip(err, lib_err)))
        checks.append({"kernel": "attention_bwd", "dtype": "bfloat16",
                       "inputs": label, "rel_err_vs_f32_yardstick": err,
                       "library_rel_err_vs_f32_yardstick": lib_err,
                       "library_backend": backend,
                       "max_abs_err": max(float((a.float() - x).abs().max())
                                          for a, x in zip(got, want)),
                       "lse_max_abs_err": lse_err, "bitwise_repeat": repeat,
                       "ok": ok})
        if not ok:
            _bf16_failed(checks[-1], "the bf16 attention_bwd disagrees")
        del again, want, lib
        rec = None
        if i < TRAIN_ATTN_BF16_TIMED:
            shape = [B, Sq, Sk, H, Hkv, d if d == dv else [d, dv]] + (
                [w] if w else [])
            bwd = lambda: flash_attention.attention_bwd(  # noqa: E731
                q, k, v, o, lse, do, **kw)
            sdpa = lambda: torch.autograd.grad(  # noqa: E731
                out, (qT, kE, vE), doT, retain_graph=True)
            reps, lib_reps = ([cuda_ms(f, 5, 1) for _ in range(TIME_REPEATS)]
                              for f in (bwd, sdpa))
            rec = {"shape": shape, "label": label, "dtype": "bfloat16",
                   "program": flash_attention.bwd_program(torch.bfloat16),
                   **_median_spread("ms", reps),
                   "plain_ms": cuda_ms(
                       lambda: ref.flash_attention_gqa_bwd_ref(
                           q, k, v, do, **kw), 3, 1),
                   **_median_spread("library_ms", lib_reps),
                   "library_backend": backend,
                   "library": "autograd.grad of F.scaled_dot_product_attention"
                              + ("(band mask)" if w else "(is_causal=True)")
                              + ", kv heads expanded, bf16 (its forward "
                              "untimed)",
                   "forward_lse_ms": cuda_ms(lambda: flash_attention.attention(
                       q, k, v, with_lse=True, **kw), 5, 1),
                   "forward_serving_ms": cuda_ms(
                       lambda: flash_attention.attention(q, k, v, **kw), 5, 1),
                   **_by_launch(label),
                   **kernel_bound("attention_bwd", shape, torch.bfloat16,
                                  card)}
            if label == TRAIN_ATTN_BANDED:
                rec["through_ops_swa_attention"] = _swa_route(
                    q, k, v, o, do, w, got)
            rows.append(rec)
        del q, k, v, do, o, lse, got, qT, kT, vT, kE, vE, out, doT, mask
        torch.cuda.empty_cache()
    return rows


def _bf16_norm_bwd(randn, checks, card) -> list:
    """The bf16 ``rmsnorm_bwd`` at TRAIN_NORM_BF16_CASES: dx and dscale in
    bf16, bitwise across two launches, against the f32 yardstick within
    BF16_VS_LIBRARY times ``F.rms_norm``'s bf16 backward (one call a group
    of the grouped scale), timed beside it (one scale), the plain version
    and ``kernel_bound``'s 2-byte bound."""
    rows = []
    for R_all, D, g, label in TRAIN_NORM_BF16_CASES:
        x, dy = randn(R_all, D).bfloat16(), randn(R_all, D).bfloat16()
        s = (1.0 + 0.1 * (randn(g, D) if g > 1 else randn(D))).bfloat16()
        got = rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5)
        again = rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5)
        want = ref.rmsnorm_bwd_ref(x.float(), s.float(), dy.float(), 1e-5)
        R = R_all // g
        leaves = [(x[j * R:(j + 1) * R].clone().requires_grad_(),
                   (s[j] if g > 1 else s).clone().requires_grad_())
                  for j in range(g)]
        outs = [F.rms_norm(xg, (D,), weight=sg, eps=1e-5)
                for xg, sg in leaves]
        parts = [torch.autograd.grad(y, xs, dy[j * R:(j + 1) * R],
                                     retain_graph=True)
                 for j, (y, xs) in enumerate(zip(outs, leaves))]
        lib = (torch.cat([a for a, _ in parts]),
               torch.stack([b for _, b in parts]) if g > 1 else parts[0][1])
        torch.cuda.synchronize()
        err = [_rel_max(a, w) for a, w in zip(got, want)]
        lib_err = [_rel_max(a, w) for a, w in zip(lib, want)]
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = (repeat and all(t.dtype == torch.bfloat16 for t in got)
              and all(e <= BF16_VS_LIBRARY * e_lib
                      for e, e_lib in zip(err, lib_err)))
        checks.append({"kernel": "rmsnorm_bwd", "dtype": "bfloat16",
                       "inputs": label, "rel_err_vs_f32_yardstick": err,
                       "library_rel_err_vs_f32_yardstick": lib_err,
                       "max_abs_err": max(float((a.float() - w).abs().max())
                                          for a, w in zip(got, want)),
                       "bitwise_repeat": repeat, "ok": ok})
        if not ok:
            _bf16_failed(checks[-1], "the bf16 rmsnorm_bwd disagrees")
        shape = [R_all, D] + ([g] if g > 1 else [])
        reps = [cuda_ms(lambda: rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5))
                for _ in range(TIME_REPEATS)]
        rec = {"shape": shape, "label": label, "dtype": "bfloat16",
               **_median_spread("ms", reps),
               "plain_ms": cuda_ms(lambda: ref.rmsnorm_bwd_ref(
                   x, s, dy, 1e-5), 5, 1),
               **_by_launch(label),
               **kernel_bound("rmsnorm_bwd", shape, torch.bfloat16, card)}
        if g == 1:
            y = outs[0]
            rec.update({
                **_median_spread("library_ms", [cuda_ms(
                    lambda: torch.autograd.grad(y, leaves[0], dy,
                                                retain_graph=True))
                    for _ in range(TIME_REPEATS)]),
                "library": "autograd.grad of F.rms_norm, bf16 (its forward "
                           "untimed)"})
        else:
            rec.update({"library_ms": None,
                        "library": "none: no PyTorch call takes grouped "
                                   "scales"})
        rows.append(rec)
        del x, dy, s, got, again, want, leaves, outs, parts, lib
    return rows


def _bf16_ssd_route(randn) -> dict:
    """A direct bf16 ``ops.ssd_scan`` under a gradient (SSD_BF16_CASE):
    the bf16 forward and the f32 ``ssd_scan_bwd`` on its inputs upcast,
    one launch each, the gradients in the inputs' dtypes within
    SSD_BF16_REL of the f32 plain version's on the same inputs."""
    BH, S, P, N, chunk, R = SSD_BF16_CASE
    x, dt, a, b, c = _ssd_inputs(randn, BH, S, P, N, R)
    x, dt, b, c = (t.bfloat16() for t in (x, dt, b, c))
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    dy = randn(BH, S, P).bfloat16()
    before = dict(ops.LAUNCHES)
    y, _ = ops.ssd_scan(*leaves, chunk=chunk)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in ops.LAUNCHES.items()
                if n != before[k]}
    want = ref.ssd_scan_bwd_ref(x.float(), dt.float(), a, b.float(),
                                c.float(), dy.float())
    err = [_rel_max(g, w) for g, w in zip(grads, want)]
    rec = {"shape": [BH, S, P, N, chunk, R], "dtype": "bfloat16",
           "route": "bf16 forward kernel, f32 ssd_scan_bwd on inputs upcast",
           "launches": launches,
           "grad_dtypes": [str(g.dtype).replace("torch.", "")
                           for g in grads],
           "rel_err_vs_plain_f32": err, "tolerance_rel_of_max": SSD_BF16_REL,
           "max_abs_err": max(float((g.float() - w).abs().max())
                              for g, w in zip(grads, want))}
    if (launches != {"ssd_scan": 1, "ssd_scan_bwd": 1}
            or any(g.dtype != t.dtype for g, t in zip(grads, leaves))
            or max(err) > SSD_BF16_REL):
        _bf16_failed({"ssd_bf16_route": rec}, "the bf16 ssd_scan gradient")
    return rec


def _swa_route(q, k, v, o, do, w, direct) -> dict:
    """``ops.swa_attention`` under a gradient at the banded case: one
    forward launch counted as ``swa_attention`` and one ``attention_bwd``,
    its output and gradients bit for bit the direct calls'."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    out = ops.swa_attention(*leaves, window=w)
    out.backward(do)
    torch.cuda.synchronize()
    launches = {k_: n for k_, n in ops.LAUNCHES.items() if n}
    same = torch.equal(out.detach(), o) and all(
        torch.equal(t.grad, g) for t, g in zip(leaves, direct))
    rec = {"launches": launches, "bitwise_the_direct_calls": same}
    if not same or launches != {"swa_attention": 1, "attention_bwd": 1}:
        emit({"phase": "lm_train_kernels", "failed": {"swa_route": rec}})
        raise SystemExit(f"ops.swa_attention under a gradient: {rec}")
    return rec


def _ssd_inputs(randn, BH, S, P, N, R, strong=False):
    x, dt, a = randn(BH, S, P), F.softplus(randn(BH, S)), -torch.exp(
        randn(BH))
    if strong:
        dt, a = dt * 4 + 1, a * 4
    return x, dt, a, randn(BH // R, S, N), randn(BH // R, S, N)


def _ssd_bwd_checks(randn, checks, card) -> tuple:
    """``ssd_scan_bwd`` against the autograd gradient of the sequential
    plain version in f32 and float64 and bitwise across two launches at
    SSD_BWD_CASES, the first SSD_BWD_TIMED timed beside the plain version
    and ``kernel_bound`` (no PyTorch call computes the SSD's gradient);
    ``torch.func.vmap(grad)`` over SSD_BWD_VMAP's learners bit for bit
    the per-learner calls, in one launch of each kernel; a padded S
    through ``ops.ssd_scan`` under a gradient against the plain route."""
    rows = []
    for BH, S, P, N, Q, R, with_dh, strong, label in SSD_BWD_CASES:
        x, dt, a, b, c = _ssd_inputs(randn, BH, S, P, N, R, strong)
        dy = randn(BH, S, P)
        dh = randn(BH, P, N) if with_dh else None
        _, _, states = ssd_scan.ssd_scan(x, dt, a, b, c, chunk=Q,
                                         keep_states=True)
        bwd = lambda: ssd_scan.ssd_scan_bwd(  # noqa: E731
            x, dt, a, b, c, states, dy, dh, chunk=Q)
        got, again = bwd(), bwd()
        want32 = ref.ssd_scan_bwd_ref(x, dt, a, b, c, dy, dh)
        torch.cuda.empty_cache()
        want64 = ref.ssd_scan_bwd_ref(
            *(t.double() for t in (x, dt, a, b, c, dy)),
            None if dh is None else dh.double())
        torch.cuda.synchronize()
        _hold_grads(checks, "ssd_scan_bwd", label, got, again, want32,
                    want64)
        checks[-1]["finite"] = all(bool(torch.isfinite(g).all())
                                   for g in got)
        if not checks[-1]["finite"]:
            raise SystemExit(f"ssd_scan_bwd gives non-finite values at "
                             f"{label}")
        del again, want32, want64
        torch.cuda.empty_cache()
        if len(rows) < SSD_BWD_TIMED:
            shape = [BH, S, P, N, Q, R]
            dev = SSD_BWD_DEVICE.get(label) or profile_calls(bwd, 3)
            rows.append({
                "shape": shape, "label": label, "dtype": "float32",
                "program": ssd_scan.BWD_PROGRAM,
                "plan": ssd_scan.bwd_plan(
                    BH, P, N, Q, torch.cuda.get_device_properties(
                        0).multi_processor_count)._asdict(),
                "device_ms": dev["device_ms"],
                "device_us_by_kernel": dev["kernels_us"],
                "cuda_launches_per_call": dev["cuda_launches_per_call"],
                **_median_spread("ms", [cuda_ms(bwd, 5, 1)
                                        for _ in range(3)]),
                "plain_ms": cuda_ms(lambda: ref.ssd_scan_bwd_ref(
                    x, dt, a, b, c, dy, dh), 1, 0),
                "forward_ms": cuda_ms(lambda: ssd_scan.ssd_scan(
                    x, dt, a, b, c, chunk=Q, keep_states=True), 5, 1),
                "library_ms": None,
                "library": "none: no PyTorch call computes the SSD or "
                           "its gradient",
                **kernel_bound("ssd_scan_bwd", shape, torch.float32, card)})
        del x, dt, a, b, c, dy, dh, states, got, bwd
        torch.cuda.empty_cache()
    return rows, {"vmap": _ssd_bwd_vmap(randn),
                  "padded_through_ops": _ssd_bwd_padded(randn)}


def _ssd_bwd_vmap(randn) -> dict:
    m, BH, S, P, N, Q, R = SSD_BWD_VMAP
    ins = [torch.stack(t) for t in zip(*(
        _ssd_inputs(randn, BH, S, P, N, R) for _ in range(m)))]
    dy = randn(m, BH, S, P)

    def loss(x, dt, a, b, c, dy):
        y, _, _ = ssd_scan.SSDScanFn.apply(x, dt, a, b, c, Q)
        return (y * dy).sum()
    ops.reset_launches()
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *ins, dy)
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    same = True
    for i in range(m):
        xi = [t[i] for t in ins]
        _, _, st = ssd_scan.ssd_scan(*xi, chunk=Q, keep_states=True)
        one = ssd_scan.ssd_scan_bwd(*xi, st, dy[i], None, chunk=Q)
        same = same and all(torch.equal(g[i], w) for g, w in zip(got, one))
    rec = {"learners": m, "shape": [BH, S, P, N, Q, R],
           "launches": launches, "bitwise_the_per_learner_calls": same}
    if not same or launches != {"ssd_scan": 1, "ssd_scan_bwd": 1}:
        emit({"phase": "lm_train_kernels", "failed": {"ssd_vmap": rec}})
        raise SystemExit(f"ssd_scan_bwd under vmap: {rec}")
    return rec


def _ssd_bwd_padded(randn) -> dict:
    BH, S, P, N, Q, R = SSD_BWD_PADDED
    ins = _ssd_inputs(randn, BH, S, P, N, R)
    dy, dh = randn(BH, S, P), randn(BH, P, N)
    leaves = [t.clone().requires_grad_() for t in ins]
    ops.reset_launches()
    y, h = ops.ssd_scan(*leaves, chunk=Q)
    torch.autograd.backward((y, h), (dy, dh))
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    want = ref.ssd_scan_bwd_ref(*ins, dy, dh)
    errs = [_rel_max(t.grad, w) for t, w in zip(leaves, want)]
    rec = {"shape": [BH, S, P, N, Q, R], "launches": launches,
           "rel_err_vs_plain_f32": errs}
    if max(errs) > TRAIN_GRAD_REL or launches != {"ssd_scan": 1,
                                                  "ssd_scan_bwd": 1}:
        emit({"phase": "lm_train_kernels", "failed": {"ssd_padded": rec}})
        raise SystemExit(f"ops.ssd_scan padded under a gradient: {rec}")
    return rec


def _lm_batch(cfg, B, S, seed):
    """Uniform tokens by ``prng.randint`` on the card (the reference
    launcher's audio draw: llama3-8b's TokenStream would hold V^2 =
    1.6e10 logits), labels the next token."""
    toks = prng.randint(prng.key(seed), (B, S + 1), 0,
                        cfg.vocab_size).long()
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def _launches_ok(got: dict, cfg, L: int, calls: int, S: int = LM_TRAIN_S,
                 remat: bool = False) -> bool:
    """Exact launches of ``calls`` training steps of ``cfg`` at L layers
    and S: per step the forward kernels and their backward ones, by the
    block's family (a hybrid block norms five times, and its attention
    takes the banded route at S = 4,096, w = 1,024); with ``remat`` each
    layer's forward kernels launch twice, in the forward and again in
    the backward's recompute (the final norm, outside the layers, once)."""
    layer_norms = 5 * L if cfg.family == "hybrid" else 2 * L
    again = 2 if remat else 1
    attn = 0 if cfg.family == "ssm" else L
    banded = takes_band(cfg, S)
    ssd = L if cfg.family in ("ssm", "hybrid") else 0
    per = {"rmsnorm": again * layer_norms + 1,
           "rmsnorm_bwd": layer_norms + 1, "attention_bwd": attn,
           "flash_attention": 0 if banded else again * attn,
           "swa_attention": again * attn if banded else 0,
           "ssd_scan": again * ssd, "ssd_scan_bwd": ssd}
    return all(got[k] == v * calls for k, v in per.items())


def _grad_gap(got, want) -> dict:
    """The kernels' gradient tree (on the host) against the plain
    versions' (on the card), leaf by leaf in slices of 2^26 weights (one
    leaf of deepseek-v2's experts holds 1.26e9): the relative L2 over the
    whole model and the largest |diff|, summed in float64."""
    n = 1 << 26
    diff2 = want2 = worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.reshape(-1), w.reshape(-1)
        for c in range(0, g.numel(), n):
            d = g[c:c + n].to(w.device).double() - w[c:c + n].double()
            diff2 += float(d.square().sum())
            want2 += float(w[c:c + n].double().square().sum())
            worst = max(worst, float(d.abs().max()))
    return {"rel_l2": math.sqrt(diff2 / want2), "max_abs_err": worst}


@contextlib.contextmanager
def _expandable_segments():
    """The caching allocator with expandable segments, for the MoE σ_1
    cells: their steps hold 65 of the card's 80 GB and ask for a 20 GiB
    row of the gradient after the backward, when the plain allocator
    keeps ~20 GiB of its cache free only in pieces of segments that the
    gradient's leaves split, and runs out (mixtral-8x22b at 2 layers, after
    the llama3-8b and deepseek-v2 cells). Expandable segments map free
    pages into one range at the same speed; a cap on splitting
    (``max_split_size_mb:1024``) fits too but slowed the deepseek-v2 step
    by 17% (benchmarks/torch_lm_allocator.py, PERF.md §6, PR 28). The
    plain allocator is back afterwards."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
        torch.cuda.empty_cache()


def _lm_train_cell(arch: str, layers: int, train: TrainConfig = None,
                   check_s: int = LM_TRAIN_S) -> dict:
    """``arch`` at full width and ``layers`` layers, f32, B = 1, S =
    LM_TRAIN_S: step 1's gradient through the kernels against the plain
    versions' (at S = ``check_s``), then LM_TRAIN_STEPS steps of
    ``make_train_step(lm_loss)`` on one batch, with ``train`` (adam at lr
    1e-3 and no rematerialized layers unless given) and
    ``lm_loss(remat=train.remat)``."""
    from repro_torch.models.model import lm_loss
    from repro_torch.train import make_train_step
    train = train or TrainConfig(optimizer="adam", learning_rate=1e-3,
                                 remat=False)
    remat = train.remat
    full = get_arch(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    params = init_lm_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    batch = _lm_batch(cfg, 1, LM_TRAIN_S, 3)
    check = batch if check_s == LM_TRAIN_S else _lm_batch(cfg, 1, check_s, 3)
    loss_fn = lambda p, b: lm_loss(cfg, p, b, remat=remat)  # noqa: E731
    ops.reset_launches()
    # the kernels' gradient waits on the host while the plain one is taken,
    # so the card holds the weights, one gradient and the plain version's
    # activations (20 GB each of the first two at deepseek-v2's layer)
    got = tree_map(lambda g: g.cpu(),
                   torch.func.grad(loss_fn)(params, check))
    one_grad = dict(ops.LAUNCHES)
    torch.cuda.empty_cache()
    # the plain versions on the card: every op takes its CPU route. By
    # loss.backward(), which frees each step's saved tensors as it goes:
    # torch.func.grad differentiates with create_graph, which keeps them
    # and records the backward too, past the card's 80 GB for the plain
    # sequential SSD at mamba2's shape (~21 GB a layer saved by the
    # forward alone)
    on_cpu, ops._on_cpu = ops._on_cpu, lambda *t: True
    try:
        leaves = tree_map(lambda v: v.detach().requires_grad_(), params)
        loss_fn(leaves, check).backward()
        want = tree_map(lambda v: v.grad, leaves)
        del leaves
    finally:
        ops._on_cpu = on_cpu
    grad = {**_grad_gap(got, want), "seq": check_s,
            "tolerance_rel_l2": LM_TRAIN_GRAD_L2, "launches": one_grad}
    del got, want
    torch.cuda.empty_cache()
    init_state, step = make_train_step(loss_fn, train, device="cuda")
    state = init_state(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, ms = [], []
    for _ in range(LM_TRAIN_STEPS):
        (state, metrics), step_ms, _ = _timed(lambda: step(state, batch))
        losses.append(float(metrics["loss"]))
        ms.append(step_ms)
    launches = dict(ops.LAUNCHES)
    rec = {"arch": cfg.name, "layers": layers, "of_layers": full.num_layers,
           "weights": cfg.param_count(), "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "batch": 1, "seq": LM_TRAIN_S,
           "dtype": "float32", "optimizer": train.optimizer,
           "lr": train.learning_rate, "remat": remat,
           "step1_grad_vs_plain": grad, "losses": losses,
           "ms_per_step_after_warmup": sum(ms[1:]) / (len(ms) - 1),
           "ms_first_step": ms[0],
           "tokens_per_s": LM_TRAIN_S / (sum(ms[1:]) / (len(ms) - 1)) * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: n / LM_TRAIN_STEPS
                                 for k, n in launches.items() if n}}
    if cfg.ssm is not None:
        rec["ssm"] = {"d_state": cfg.ssm.d_state, "head_dim": cfg.ssm.head_dim,
                      "heads": cfg.ssm.expand * cfg.d_model
                      // cfg.ssm.head_dim, "chunk": cfg.ssm.chunk_size}
    if cfg.moe is not None:
        m = cfg.moe
        rec["moe"] = {"experts": m.num_experts, "top_k": m.num_experts_per_tok,
                      "shared": m.num_shared_experts,
                      "expert_d_ff": m.expert_d_ff or cfg.d_ff,
                      "capacity_factor": m.capacity_factor}
    if cfg.mla is not None:
        rec["mla"] = {"q_lora_rank": cfg.mla.q_lora_rank,
                      "kv_lora_rank": cfg.mla.kv_lora_rank,
                      "widths": [cfg.resolved_head_dim + cfg.mla.rope_head_dim,
                                 cfg.resolved_head_dim]}
    if cfg.sliding_window and cfg.attn_type == "sliding":
        rec["window"] = cfg.sliding_window
    if takes_band(cfg, LM_TRAIN_S):
        rec["banded_window"] = cfg.sliding_window
    del state
    torch.cuda.empty_cache()
    if not (_launches_ok(launches, cfg, layers, LM_TRAIN_STEPS, remat=remat)
            and _launches_ok(one_grad, cfg, layers, 1, check_s, remat)
            and grad["rel_l2"] <= LM_TRAIN_GRAD_L2
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        emit({"phase": "lm_train", "failed": rec})
        raise SystemExit(f"lm_train {arch}: {rec}")
    return rec


def _fleet_run(cfg, init, batches, kind) -> dict:
    from repro_torch.models.model import lm_loss
    train = TrainConfig(optimizer="adam", learning_rate=3e-4, remat=False)
    loss_fn = lambda p, b: lm_loss(cfg, p, b, remat=train.remat)  # noqa: E731
    proto = ProtocolConfig(kind="dynamic", b=FLEET_PERIOD, delta=FLEET_DELTA)
    mk = (distributed.make_dynamic_train_step if kind == "dynamic"
          else distributed.make_periodic_train_step)
    step = mk(loss_fn, proto, train, FLEET_M)
    state = distributed.init_dynamic_state(
        lambda g: init, torch.Generator(device="cuda").manual_seed(0),
        FLEET_M, train, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    synced, losses, maxd = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for t, batch in enumerate(batches):
        if t == 1:
            start.record()
        state, metrics = step(state, batch)
        synced.append(int(metrics["synced"]))
        losses.append(metrics["loss"])
        maxd.append(metrics.get("max_sq_dist"))
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (len(batches) - 1)
    P = state.plane.shape[1]
    tokens = FLEET_M * batches[0]["tokens"][0].numel()
    return {"kind": kind, "steps": len(batches), "syncs": state.syncs,
            "checks": state.checks, "synced": synced,
            "losses": [float(x) for x in losses[::10]] + [float(losses[-1])],
            "max_sq_dist_checked": [float(d) for d in maxd
                                    if d is not None and float(d) > 0],
            "ms_per_step_after_warmup": ms,
            "tokens_per_step": tokens, "tokens_per_s": tokens / ms * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": dict(ops.LAUNCHES),
            "sqdist_rows_at_m_P": ops.ROWS_LAUNCHES[(FLEET_M, P, 1)],
            "weights": P, "plane": state.plane}


def phase_lm_train() -> dict:
    """LM training through the kernels on the card. (a) The σ_1 cells of
    LM_TRAIN_ARCHS at full width, 2 layers (LM_TRAIN_LAYERS), f32, B = 1,
    S = 4,096: llama3-8b (d 4096, 32/8 heads of 128, d_ff 14,336, vocab
    128,256; 2 of 32 layers), mamba2-2.7b (d 2,560, 80 SSD heads of 64,
    N 128, vocab 50,280; 2 of 64) and hymba-1.5b (d 1,600, 25/5 heads of
    64 banded at w 1,024 beside 50 SSD heads at N 16, d_ff 5,504, vocab
    32,001; 2 of 32): step 1's gradient through the kernels against the
    plain versions' on the same weights and batch (LM_TRAIN_GRAD_L2),
    then 6 adam steps (lr 1e-3) of ``make_train_step(lm_loss)`` on one
    batch: the loss falls, ms a step after the first, tokens/s, peak
    memory, and exact launches (``_launches_ok``: forward rmsnorm 2L + 1,
    5L + 1 for the hybrid, attention or ssd_scan L a step, the backward
    kernels the same). The MoE cells (LM_MOE_LAYERS) the same way with
    sgd and ``lm_loss(remat=True)``: deepseek-v2-236b (d 5,120, MLA 128
    heads of 192/128 from q and kv ranks 1,536 / 512, 160 experts of
    1,536, top 6, 2 shared, vocab 102,400; 1 of 60 layers) and
    mixtral-8x22b (d 6,144, 48/8 heads of 128 in a window of 4,096, 8
    experts of 16,384, top 2, vocab 32,768; 2 of 56), their forward
    kernels twice a step (the recompute), the step-1 check at S =
    LM_MOE_CHECK_S. The plain SSD's autograd keeps two (BH, P, N)
    f32 tensors a step, about 21 GB a layer at mamba2's shape, which
    holds the cell at 2 layers. (b) fleet-llm-100m
    (examples/torch_fleet_llm.py --big) at full width and depth, m = 4 learners of 4 x 128 tokens from
    ``TokenStream(seed=100 + i)``: ``make_dynamic_train_step`` (b = 10,
    Δ = 45) and ``make_periodic_train_step``, 60 steps each, with syncs
    and checks (the dynamic run both syncs and holds), ``sqdist_rows`` exactly once per check at (4, P), every
    norm and attention one launch a layer for the four learners (the
    vmap rules), and the dynamic run repeated bit for bit."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    from torch_fleet_llm import fleet_model, stacked_batch
    cells = {}
    for arch in LM_TRAIN_ARCHS:
        cells[arch] = _lm_train_cell(arch, LM_TRAIN_LAYERS)
        emit({"phase": "lm_train", arch: cells[arch]})
    moe_train = TrainConfig(optimizer="sgd", learning_rate=LM_MOE_LR,
                            remat=True)
    with _expandable_segments():
        for arch, layers in LM_MOE_LAYERS.items():
            cells[arch] = _lm_train_cell(arch, layers, moe_train,
                                         check_s=LM_MOE_CHECK_S)
            emit({"phase": "lm_train", arch: cells[arch]})
            torch.cuda.empty_cache()

    cfg = fleet_model(big=True)
    streams = [TokenStream(seed=100 + i, vocab=cfg.vocab_size,
                           device="cuda") for i in range(FLEET_M)]
    key, batches = prng.key(1), []
    for _ in range(FLEET_STEPS):
        key, sub = prng.split(key, 2)
        batches.append(stacked_batch(streams, sub, "cuda"))
    del streams
    init = init_lm_params(cfg, seed=0, device="cuda")
    runs = {kind: _fleet_run(cfg, init, batches, kind)
            for kind in ("dynamic", "periodic")}
    again = _fleet_run(cfg, init, batches, "dynamic")
    repeat = (again["synced"] == runs["dynamic"]["synced"]
              and torch.equal(again["plane"], runs["dynamic"]["plane"]))
    L = cfg.num_layers
    for run in runs.values():
        run.pop("plane")
    fleet = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model,
             "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
             "vocab": cfg.vocab_size, "m": FLEET_M, "b": FLEET_PERIOD,
             "delta": FLEET_DELTA, "runs": runs,
             "dynamic_repeats_bitwise": repeat}
    emit({"phase": "lm_train", "fleet-llm-100m": fleet})
    dyn, per = runs["dynamic"], runs["periodic"]
    if not (repeat and dyn["checks"] == FLEET_STEPS // FLEET_PERIOD
            and 0 < dyn["syncs"] < dyn["checks"]
            and dyn["sqdist_rows_at_m_P"] == dyn["checks"]
            and dyn["launches"]["sqdist_rows"] == dyn["checks"]
            and per["launches"]["sqdist_rows"] == 0
            and per["syncs"] == FLEET_STEPS // FLEET_PERIOD
            and all(_launches_ok(r["launches"], cfg, L, FLEET_STEPS)
                    for r in runs.values())
            and all(math.isfinite(x) for r in runs.values()
                    for x in r["losses"])):
        raise SystemExit(f"lm_train fleet-llm-100m: {fleet}")
    return {**cells, "fleet-llm-100m": fleet}


def _agree_runs(cfg, init_np, fleet, single, device) -> dict:
    """llama3-8b-smoke's three step factories for AGREE_STEPS steps on
    ``device`` from the same numpy weights and batches."""
    from repro_torch.models.model import lm_loss
    from repro_torch.train import make_train_step
    loss_fn = lambda p, b: lm_loss(cfg, p, b)          # noqa: E731
    train = TrainConfig(optimizer="adam", learning_rate=AGREE_LR)
    dev = torch.device(device)
    out = {}
    init_state, step = make_train_step(loss_fn, train, device=device)
    state = init_state(params_from_numpy(init_np, device=device))
    losses = []
    for b in single:
        state, metrics = step(state, {k: v.to(dev) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    out["train"] = {"losses": losses, "plane": _row_of(state.params).cpu()}
    for kind, (b, delta) in (("dynamic", AGREE_DYNAMIC),
                             ("periodic", (3, 1.0))):
        mk = (distributed.make_dynamic_train_step if kind == "dynamic"
              else distributed.make_periodic_train_step)
        step = mk(loss_fn, ProtocolConfig(kind="dynamic", b=b, delta=delta),
                  train, FLEET_M)
        state = distributed.init_dynamic_state(
            lambda g: params_from_numpy(init_np, device=device),
            torch.Generator(device=device).manual_seed(0), FLEET_M, train,
            device=device)
        synced, losses, dists = [], [], []
        for batch in fleet:
            state, metrics = step(state, {k: v.to(dev)
                                          for k, v in batch.items()})
            synced.append(int(metrics["synced"]))
            losses.append(float(metrics["loss"]))
            if "max_sq_dist" in metrics:
                dists.append(float(metrics["max_sq_dist"]))
        out[kind] = {"synced": synced, "syncs": state.syncs,
                     "checks": state.checks, "losses": losses,
                     "max_sq_dist": dists, "plane": state.plane.cpu()}
    return out


def phase_lm_train_agree() -> dict:
    """llama3-8b-smoke trained on the card and on the CPU from the same
    weights and batches (4 learners of 2 x 32 tokens from their
    TokenStreams; the single step on the 8 x 32 they make): the three
    modes for 20 adam steps, ``synced``, syncs and checks identical, the
    planes and losses within the AGREE_PLANE_* / rtol 1e-4 bounds, and no
    checked distance within 1e-4·Δ of Δ. Then the launcher twin's
    ``--smoke`` run of each mode on the card for each arch of
    LM_TRAIN_ARCHS, 5 steps, its events the reference launcher's
    (``train_step`` with step, loss and, for the fleet modes, synced;
    then ``train_done``), each backward kernel of the arch's path
    launched (the fleet modes through the vmap rules)."""
    from repro_torch.launch import train as launcher
    from repro_torch.telemetry import get_logger
    cfg = get_arch("llama3-8b", smoke=True)
    init_np = params_to_numpy(init_lm_params(cfg, seed=0, device="cpu"))
    streams = [TokenStream(seed=100 + i, vocab=cfg.vocab_size, device="cpu")
               for i in range(FLEET_M)]
    fleet, single = [], []
    for t in range(AGREE_STEPS):
        key = prng.fold_in(prng.key(1, "cpu"), t, "cpu")
        bs = [s.sample(prng.fold_in(key, i, "cpu"), 2, 32)
              for i, s in enumerate(streams)]
        fleet.append({k: torch.stack([b[k] for b in bs]) for k in bs[0]})
        single.append({k: v.reshape((-1,) + v.shape[2:])
                       for k, v in fleet[-1].items()})
    cpu = _agree_runs(cfg, init_np, fleet, single, "cpu")
    gpu = _agree_runs(cfg, init_np, fleet, single, "cuda")
    rec, ok = {}, True
    b, delta = AGREE_DYNAMIC
    for kind in ("train", "dynamic", "periodic"):
        c, g = cpu[kind], gpu[kind]
        diff = (g["plane"] - c["plane"]).abs()
        r = {"plane_rel_l2": _rel_l2(g["plane"], c["plane"]),
             "plane_max_abs": float(diff.max()),
             "loss_max_rel": max(abs(x - y) / abs(y) for x, y in
                                 zip(g["losses"], c["losses"]))}
        ok &= (r["plane_rel_l2"] <= AGREE_PLANE_REL
               and r["plane_max_abs"] <= AGREE_PLANE_ABS
               and r["loss_max_rel"] <= 1e-4)
        if kind != "train":
            r.update(synced=g["synced"], syncs=[g["syncs"], c["syncs"]],
                     checks=[g["checks"], c["checks"]])
            ok &= g["synced"] == c["synced"] and \
                (g["syncs"], g["checks"]) == (c["syncs"], c["checks"])
        if kind == "dynamic":
            checked = [d for t, d in enumerate(c["max_sq_dist"])
                       if (t + 1) % b == 0]
            r["closest_to_delta_rel"] = min(abs(d - delta) / delta
                                            for d in checked)
            ok &= r["closest_to_delta_rel"] >= 1e-4 and \
                0 < c["syncs"] < c["checks"]
        rec[kind] = r

    launched = {}
    for arch, mode in itertools.product(LM_TRAIN_ARCHS, (
            "train", "train_dynamic", "train_periodic")):
        events = []
        log = get_logger()
        handler = log.add_handler(events.append)
        ops.reset_launches()
        try:
            with contextlib.redirect_stdout(StringIO()):
                launcher.main(["--arch", arch, "--smoke", "--mode",
                               mode, "--steps", "5"])
        finally:
            log.remove_handler(handler)
        launches = {k: n for k, n in ops.LAUNCHES.items() if n}
        keys = {"step", "loss"} | ({"synced"} if mode != "train" else set())
        steps = [e for e in events if e["kind"] == "train_step"]
        family = get_arch(arch).family
        # every forward kernel of the arch's path has its backward launched
        bwd = {"attention_bwd"} if family != "ssm" else set()
        bwd |= {"ssd_scan_bwd"} if family in ("ssm", "hybrid") else set()
        good = ([e["kind"] for e in events] == ["train_step"] * 5
                + ["train_done"]
                and all(set(e) - {"kind"} == keys for e in steps)
                and [e["step"] for e in steps] == [1, 2, 3, 4, 5]
                and all(math.isfinite(e["loss"]) for e in steps)
                and events[-1]["mode"] == mode
                and all(launches.get(k, 0) > 0 for k in bwd | {"rmsnorm_bwd"}))
        launched[f"{arch} {mode}"] = {
            "losses": [e["loss"] for e in steps],
            "synced": [e.get("synced") for e in steps],
            "launches": launches, "ok": good}
        ok &= good
    out = {"phase": "lm_train_agree", "arch": cfg.name, "steps": AGREE_STEPS,
           "m": FLEET_M, "runs": rec, "launcher_smoke": launched,
           "tolerances": {"plane_rel_l2": AGREE_PLANE_REL,
                          "plane_max_abs": AGREE_PLANE_ABS,
                          "loss_rel": 1e-4}}
    emit(out)
    if not ok:
        raise SystemExit(f"lm_train_agree: {out}")
    return out


# moe_fleet: the launcher's --smoke dynamic fleet of each MoE arch on the
# card (m = 2, adam at lr 1e-3, B = 4 x 64 tokens a learner), b = 2 over
# 20 steps, Δ among the checked distances of its run on the H100 (with no
# sync they grow: mixtral 8.69, 19.72, 30.95, ...; deepseek 3.50, 7.97,
# ...), so the run syncs about every other check
MOE_FLEET_STEPS, MOE_FLEET_B = 20, 2
MOE_FLEET_DELTA = {"mixtral-8x22b": 14.0, "deepseek-v2-236b": 5.5}


def _launcher_run(launcher, argv) -> tuple:
    """The launcher's events of ``main(argv)`` on the card, its launches,
    and the ``max_sq_dist`` of each step of a dynamic run (its step's
    metrics, which the launcher does not log)."""
    from repro_torch.telemetry import get_logger
    events, dists = [], []
    make = launcher.make_dynamic_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            state, metrics = step(state, batch)
            dists.append(float(metrics.get("max_sq_dist", 0.0)))
            return state, metrics
        return run
    log = get_logger()
    handler = log.add_handler(events.append)
    launcher.make_dynamic_train_step = recording
    ops.reset_launches()
    try:
        with contextlib.redirect_stdout(StringIO()):
            launcher.main(argv)
    finally:
        launcher.make_dynamic_train_step = make
        log.remove_handler(handler)
    return events, {k: n for k, n in ops.LAUNCHES.items() if n}, dists


def phase_moe_fleet() -> dict:
    """The MoE fleets on the card through the launcher twin's ``main``:
    ``--smoke --mode train_dynamic`` and ``train_periodic`` for
    mixtral-8x22b (8 experts, top 2, its window-16 attention on the
    banded route) and deepseek-v2-236b (MLA at (48, 32), 16 experts, top
    6, 2 shared), m = 2 learners under the learners' vmap, b =
    MOE_FLEET_B, MOE_FLEET_STEPS steps: the launcher's events, finite
    losses, the dynamic run both syncing and holding (0 < syncs < checks,
    no checked distance within 1e-4·Δ of Δ), ``sqdist_rows`` once a
    check, and every kernel of the path one launch a layer and step for
    both learners (the vmap rules)."""
    from repro_torch.launch import train as launcher
    out, ok = {}, True
    for (arch, delta), mode in itertools.product(
            MOE_FLEET_DELTA.items(), ("train_dynamic", "train_periodic")):
        cfg = get_arch(arch, smoke=True)
        events, launches, dists = _launcher_run(launcher, [
            "--arch", arch, "--smoke", "--mode", mode, "--steps",
            str(MOE_FLEET_STEPS), "--b", str(MOE_FLEET_B), "--delta",
            str(delta)])
        steps = [e for e in events if e["kind"] == "train_step"]
        synced = [e["synced"] for e in steps]
        checks = MOE_FLEET_STEPS // MOE_FLEET_B
        checked = [d for t, d in enumerate(dists)
                   if (t + 1) % MOE_FLEET_B == 0]
        got = dict.fromkeys(("rmsnorm", "rmsnorm_bwd", "flash_attention",
                             "swa_attention", "attention_bwd", "ssd_scan",
                             "ssd_scan_bwd"), 0)
        got.update(launches)
        rec = {"arch": cfg.name, "layers": cfg.num_layers, "m": 2,
               "b": MOE_FLEET_B, "steps": MOE_FLEET_STEPS,
               "losses": [e["loss"] for e in steps], "synced": synced,
               "syncs": sum(synced), "checks": checks, "launches": launches}
        good = ([e["kind"] for e in events] == ["train_step"]
                * MOE_FLEET_STEPS + ["train_done"]
                and all(math.isfinite(e["loss"]) for e in steps)
                and _launches_ok(got, cfg, cfg.num_layers, MOE_FLEET_STEPS,
                                 S=64))
        if mode == "train_dynamic":
            rec.update(delta=delta, max_sq_dist_checked=checked,
                       closest_to_delta_rel=min(abs(d - delta) / delta
                                                for d in checked))
            good &= (0 < rec["syncs"] < checks
                     and rec["closest_to_delta_rel"] >= 1e-4
                     and launches.get("sqdist_rows") == checks)
        else:
            good &= rec["syncs"] == checks and "sqdist_rows" not in launches
        rec["ok"] = good
        out[f"{arch} {mode}"] = rec
        ok &= good
    emit({"phase": "moe_fleet", "runs": out})
    if not ok:
        raise SystemExit(f"moe_fleet: {out}")
    return out


# ---------------------------------------------------------------------------
# the launcher's programs (slice 20): launch/specs.py's five modes of
# llama3-8b at full width, 2 of its 32 layers, on the (1, 1) DeviceMesh of
# one rank; each counted on meta by launch/dryrun.py and run on the card
# ---------------------------------------------------------------------------

LAUNCH_ARCH, LAUNCH_LAYERS, LAUNCH_SEED = "llama3-8b", 2, 0
# (mode, dtype, shape): the σ_1 cell's shape (lm_train), the fleets' one
# sequence of 1,024 a learner (m = 2), serving's batch 4 at 2,048
# bf16 training's program (A28), the reference's production program at
# published dtype: its own depth, 8 of 32 layers (2.80e9 weights, 5.6 GB in
# bf16; weights, gradient and new weights 16.8 GB), the first card check
# of the dry run's L^2 extrapolation away from a counted depth (1, 2, 3)
LAUNCH_BF16_LAYERS = 8
# (key, mode, dtype, shape, layers)
LAUNCH_PROGRAMS = (
    ("train", "train", "float32", ShapeConfig("sigma1_4k", 4096, 1, "train"),
     LAUNCH_LAYERS),
    ("train_dynamic", "train_dynamic", "float32",
     ShapeConfig("fleet_1k", 1024, 2, "train"), LAUNCH_LAYERS),
    ("train_periodic", "train_periodic", "float32",
     ShapeConfig("fleet_1k", 1024, 2, "train"), LAUNCH_LAYERS),
    ("prefill", "prefill", "bfloat16",
     ShapeConfig("prefill_2k", 2048, 4, "prefill"), LAUNCH_LAYERS),
    ("decode", "decode", "bfloat16",
     ShapeConfig("decode_2k", 2048, 4, "decode"), LAUNCH_LAYERS),
    ("train_bf16", "train", "bfloat16",
     ShapeConfig("sigma1_4k", 4096, 1, "train"), LAUNCH_BF16_LAYERS))
# the bf16 program's step-1 gradient through the kernels against the f32
# gradient of the same weights, upcast, through the f32 kernels: the worst
# leaf's max |diff| over its max within LAUNCH_BF16_GAP times the gap of the
# plain versions' bf16 gradient against the same f32 gradient, at S =
# LAUNCH_BF16_CHECK_S (the plain attention keeps (heads, S, S) f32 scores a
# layer for its backward)
LAUNCH_BF16_GAP = 1.5
LAUNCH_BF16_CHECK_S = 1024
LAUNCH_TRAIN = TrainConfig(optimizer="sgd", remat=True)
# a Δ that one step's drift passes: the card's checked step syncs, the
# step the dry run counts (the host's decision has no value on meta)
LAUNCH_PROTO = ProtocolConfig(kind="dynamic", b=10, delta=1e-6)
# the caching allocator hands out blocks in multiples of 512 bytes
ALLOC_GRAIN = 512
LAUNCH_DIR = os.path.join("build", "torch_dryrun")
EXAMPLE_TWINS = ("async_fleet", "concept_drift", "custom_protocol",
                 "fedavg_comparison", "hierarchical_fleet", "serve_demo",
                 "unreliable_fleet")


def _bits_equal(a: list, b: list) -> bool:
    """The same tensors byte for byte."""
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.reshape(-1).contiguous().view(torch.uint8),
            y.reshape(-1).contiguous().view(torch.uint8))
        for x, y in zip(a, b))


def _program_tensors(mode: str, out) -> list:
    """The tensors of a program's output, in a fixed order."""
    if mode == "train":
        state, metrics = out
        return list(tree_leaves(state.params)) + [metrics["loss"]]
    if mode.startswith("train_"):
        state, metrics = out
        return [state.plane, state.ref] + [
            torch.as_tensor(v) for _, v in sorted(metrics.items())]
    if mode == "prefill":
        return [out]
    logits, cache = out
    return [logits] + list(tree_leaves(cache))


def _entry_point_call(mode: str, cfg, shape):
    """The same call through the entry points the program wraps: the
    weights by ``init_lm_params`` from the seed, the tokens by
    ``prng.randint`` (labels the next token)."""
    from repro_torch.core.distributed import (
        init_dynamic_state, make_dynamic_train_step, make_periodic_train_step)
    from repro_torch.models.model import init_lm_cache, lm_loss
    from repro_torch.serve.engine import make_decode_step
    from repro_torch.train.step import make_train_step
    dtype = getattr(torch, cfg.dtype)
    B, S = shape.global_batch, shape.seq_len
    seq = 1 if mode == "decode" else S
    toks = prng.randint(prng.key(LAUNCH_SEED), (B, seq + 1), 0,
                        cfg.vocab_size)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    loss_fn = lambda p, b: lm_loss(cfg, p, b, remat=True)    # noqa: E731
    if mode == "train":
        init_state, step = make_train_step(loss_fn, LAUNCH_TRAIN)
        return step(init_state(init_lm_params(cfg, LAUNCH_SEED, dtype)),
                    batch)
    if mode.startswith("train_"):
        mk = (make_dynamic_train_step if mode == "train_dynamic"
              else make_periodic_train_step)
        state = init_dynamic_state(
            lambda g: init_lm_params(cfg, LAUNCH_SEED, dtype),
            torch.Generator(device="cuda"), 2, LAUNCH_TRAIN)._replace(
                step=LAUNCH_PROTO.b - 1)
        fleet = {k: v.reshape(2, B // 2, S) for k, v in batch.items()}
        return mk(loss_fn, LAUNCH_PROTO, LAUNCH_TRAIN, 2)(state, fleet)
    params = init_lm_params(cfg, LAUNCH_SEED, dtype)
    if mode == "prefill":
        return make_prefill(cfg)(params, batch["tokens"])
    return make_decode_step(cfg)(params, init_lm_cache(cfg, B, S, dtype),
                                 batch["tokens"].reshape(B), S - 1)


def _launch_expected(mode: str, L: int) -> dict:
    """The kernel launches of one call of ``mode`` at L layers of
    llama3-8b: a training step's forward kernels twice (remat), its
    backward ones once; the dynamic step's one ``sqdist_rows``."""
    if mode.startswith("train"):
        want = {"rmsnorm": 4 * L + 1, "flash_attention": 2 * L,
                "rmsnorm_bwd": 2 * L + 1, "attention_bwd": L}
        if mode == "train_dynamic":
            want["sqdist_rows"] = 1
        return want
    return ({"rmsnorm": 2 * L + 1, "flash_attention": L}
            if mode == "prefill" else {"rmsnorm": 2 * L + 1})


def _storages(args) -> int:
    """Distinct allocations among a program's arguments (views are their
    base's)."""
    seen = set()
    map_named(lambda _n, t: seen.add(
        (t._base if t._base is not None else t).data_ptr())
        if isinstance(t, torch.Tensor) else None, args)
    return len(seen)


def _run_program(mode: str, dtype: str, shape, mesh, problems,
                 layers: int = LAUNCH_LAYERS) -> dict:
    """One program at ``layers`` layers: its dry run on meta, then on the
    card materialized (the arguments' memory), observed by ``analyze``
    under a tally, timed by CUDA events on a second copy, and called again
    through the entry points; the outputs bit for bit, the launches and
    the counts against the dry run's."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.launch import dryrun, specs
    cfg = dataclasses.replace(get_arch(LAUNCH_ARCH), num_layers=layers,
                              dtype=dtype)
    proto = LAUNCH_PROTO if mode.startswith("train_") else None
    t0 = time.perf_counter()
    prog, counted = dryrun.count_program(cfg, shape, mesh, mode,
                                         LAUNCH_TRAIN, proto)
    dry_s = time.perf_counter() - t0
    arg_bytes = dryrun.argument_bytes(prog, mesh)
    rec = dryrun.roofline_of(cfg, shape, mesh, mode, prog, counted)
    os.makedirs(LAUNCH_DIR, exist_ok=True)
    with open(os.path.join(LAUNCH_DIR, f"{cfg.name}_{shape.name}_one_card_"
                           f"{mode}_{dtype}.json"), "w") as f:
        json.dump({"arch": cfg.name, "shape": shape.name,
                   "mesh": "one_card", "mode": mode, "num_devices": 1,
                   "compile_s": round(dry_s, 2), "ok": True,
                   "calibrated": True, "roofline": rec,
                   "per_chip_rule": "even_split", "layers": layers,
                   "dtype": dtype, "kernels": counted["kernels"]},
                  f, indent=1, default=str)

    # A: materialized, observed by analyze under a tally (also the warm-up)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    real = specs.materialize(prog, LAUNCH_SEED, "cuda")
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - base
    storages = _storages(real.args)
    ops.reset_launches()
    outs, calls = [], []
    plain_call = ops.sqdist_rows

    def keep(X, r):
        # the main path's own call, copies of its inputs kept (the step
        # writes the plane in place after it) to hold it to the plain
        # version once the observed run is over; the observers count a
        # copy as a free move, so the counts below are the program's
        out = plain_call(X, r)
        calls.append((X.clone(), r.clone(), out))
        return out

    ops.sqdist_rows = keep
    try:
        with _build.tally() as tally:
            report = rl.analyze(prog.name, lambda *a: outs.append(
                real.fn(*a)), *real.args)
    finally:
        ops.sqdist_rows = plain_call
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    rows = dict(ops.ROWS_LAUNCHES)
    card_kernels = dryrun.kernel_totals(tally.calls)
    # the launches by the kernels line's names: the bf16 attention
    # backward is its own program (csrc/attention_bwd_bf16.cu)
    by_kernel = Counter()
    for c in tally.calls:
        by_kernel["attention_bwd_bf16" if c.family == "attention_bwd"
                  and c.dtype == torch.bfloat16 else c.family] += 1
    first = _program_tensors(mode, outs[0])
    small = [t.clone() for t in first if t.numel() < 1 << 20]
    serving = not mode.startswith("train")
    kept = first if serving else small
    del real, outs, first
    torch.cuda.empty_cache()
    # each sqdist_rows call of the run against its plain version on the
    # same inputs (TOL)
    held = []
    for X, r, got in calls:
        want = ref.sqdist_rows_ref(X, r)
        held.append({"plane": list(X.shape), "got": got.tolist(),
                     "max_abs_err": float((got - want).abs().max()),
                     "ok": bool(torch.allclose(got, want, **TOL))})
        del X, r, got, want
    del calls
    torch.cuda.empty_cache()

    # B: a second copy, timed by CUDA events, its peak read
    real = specs.materialize(prog, LAUNCH_SEED, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out = real.fn(*real.args)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated()
    fleet = ({"synced": int(out[1]["synced"]),
              **({"max_sq_dist": float(out[1]["max_sq_dist"])}
                 if mode == "train_dynamic" else {})}
             if mode.startswith("train_") else {})
    timed = _program_tensors(mode, out)
    del real, out
    # C: the entry points' own call
    entry = _program_tensors(mode, _entry_point_call(mode, cfg, shape))
    same_entry = _bits_equal(timed, entry)
    same_repeat = _bits_equal(
        kept, timed if serving else [t for t in timed
                                     if t.numel() < 1 << 20])
    del timed, entry, kept
    torch.cuda.empty_cache()

    want = _launch_expected(mode, layers)
    dry_kernels = {f: {k: v for k, v in row.items()}
                   for f, row in counted["kernels"].items()}
    checks = {
        "outputs_bit_for_bit_entry_points": same_entry,
        "outputs_repeat_bit_for_bit": same_repeat,
        "launches_exact": launches == want,
        "products_flops_equal": report.flops_per_chip == counted["flops"],
        "bytes_outside_kernels_equal":
            report.bytes_per_chip == counted["bytes"],
        "kernels_equal_kernel_work_of_launches": card_kernels == dry_kernels,
        "argument_bytes_equal_memory_rise":
            arg_bytes <= rise <= arg_bytes + ALLOC_GRAIN * storages}
    if mode.startswith("train_"):
        checks["synced"] = fleet["synced"] == 1
    if mode == "train_dynamic":
        P = prog.args[0].plane.shape[1]
        checks["sqdist_rows_at_2_P"] = rows == {(2, P, 1): 1}
        checks["sqdist_rows_held_to_plain"] = (
            len(held) == 1 and held[0]["plane"] == [2, P]
            and held[0]["ok"])
    problems += [f"launch {mode}: {k}" for k, v in checks.items() if not v]
    return {"mode": mode, "dtype": dtype, "program": prog.name,
            "shape": [shape.global_batch, shape.seq_len],
            "layers": layers, "ms": ms, "peak_bytes": peak, **fleet,
            "dry_run_s": dry_s, "launches": launches,
            "launches_by_kernel": dict(by_kernel),
            "launches_expected": want, "sqdist_rows_by_plane":
                {"x".join(map(str, k)): v for k, v in rows.items()},
            "sqdist_rows_vs_plain": {"calls": held, "tolerance": TOL},
            "products_flops": {"card": report.flops_per_chip,
                               "dry_run": counted["flops"]},
            "bytes_outside_kernels": {"card": report.bytes_per_chip,
                                      "dry_run": counted["bytes"]},
            "kernels": {"card": card_kernels, "dry_run": dry_kernels},
            "argument_bytes": {"dry_run": arg_bytes, "memory_rise": rise,
                               "allocations": storages},
            "roofline": {k: rec[k] for k in (
                "compute_s", "memory_s", "collective_s", "bottleneck",
                "model_flops", "useful_fraction")},
            "checks": checks}


def _worst_leaf(got: list, want: list, names: list) -> dict:
    """The worst leaf's max |got - want| over max |want| (float64, in
    slices of 2^26 values), and which leaf."""
    n, gaps = 1 << 26, {}
    for g, w, name in zip(got, want, names):
        g, w = g.reshape(-1), w.reshape(-1)
        diff = top = 0.0
        for c in range(0, w.numel(), n):
            wc = w[c:c + n].double()
            diff = max(diff, float((g[c:c + n].double() - wc).abs().max()))
            top = max(top, float(wc.abs().max()))
        gaps[name] = diff / max(top, 1e-30)
    worst = max(gaps, key=gaps.get)
    return {"gap": gaps[worst], "leaf": worst}


def _bf16_step1(problems) -> dict:
    """The bf16 program's step-1 gradient (``lm_loss(remat=True)`` at
    LAUNCH_BF16_LAYERS, its weights, a batch of S = LAUNCH_BF16_CHECK_S)
    through the kernels against the f32 gradient of the same weights
    upcast (through the f32 kernels), held within LAUNCH_BF16_GAP times
    the gap of the plain versions' bf16 gradient (``ops._on_cpu``
    patched) against the same f32 gradient; the kernels' launches exact
    (remat: the forward kernels twice)."""
    from repro_torch.models.model import lm_loss
    cfg = dataclasses.replace(get_arch(LAUNCH_ARCH),
                              num_layers=LAUNCH_BF16_LAYERS, dtype="bfloat16")
    batch = _lm_batch(cfg, 1, LAUNCH_BF16_CHECK_S, LAUNCH_SEED)
    params = init_lm_params(cfg, LAUNCH_SEED, torch.bfloat16)
    names = tree_leaves(map_named(lambda n, _t: "/".join(n), params))

    def grad(p):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        it = iter(leaves)
        loss = lm_loss(cfg, tree_map(lambda _: next(it), p), batch,
                       remat=True)
        return list(torch.autograd.grad(loss, leaves))

    ops.reset_launches()
    got = grad(params)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    want = grad(tree_map(lambda t: t.float(), params))
    on_cpu, ops._on_cpu = ops._on_cpu, lambda *t: True
    try:
        plain = grad(params)
    finally:
        ops._on_cpu = on_cpu
    kernels, plain_gap = (_worst_leaf(g, want, names) for g in (got, plain))
    rec = {"layers": LAUNCH_BF16_LAYERS, "seq": LAUNCH_BF16_CHECK_S,
           "kernels_vs_f32": kernels, "plain_bf16_vs_f32": plain_gap,
           "bound": f"<= {LAUNCH_BF16_GAP} x the plain versions' gap",
           "launches": launches,
           "launches_expected": _launch_expected("train",
                                                 LAUNCH_BF16_LAYERS)}
    if kernels["gap"] > LAUNCH_BF16_GAP * plain_gap["gap"]:
        problems.append(f"launch train_bf16 step 1: {rec}")
    if launches != rec["launches_expected"]:
        problems.append(f"launch train_bf16 step 1 launches: {launches}")
    del got, want, plain, params
    torch.cuda.empty_cache()
    return rec


def _example_twins(problems) -> dict:
    """Each example twin's ``main(["--smoke"])`` on the card, in this
    process, with every ``sqdist_rows`` call held to its plain version on
    the same inputs (TOL); their launches by kernel."""
    import importlib.util
    plain_call = ops.sqdist_rows
    held = {"calls": 0, "off_tolerance": 0}

    def checked(X, r):
        out = plain_call(X, r)
        held["calls"] += 1
        held["off_tolerance"] += int((~torch.isclose(
            out, ref.sqdist_rows_ref(X, r), **TOL)).sum())
        return out

    ops.reset_launches()
    ops.sqdist_rows = checked
    runs = {}
    try:
        for name in EXAMPLE_TWINS:
            path = os.path.join("examples", f"torch_{name}.py")
            spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                          path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            t0 = time.perf_counter()
            mod.main(["--smoke"])
            torch.cuda.synchronize()
            runs[name] = time.perf_counter() - t0
    finally:
        ops.sqdist_rows = plain_call
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    if held["off_tolerance"] or held["calls"] != launches.get(
            "sqdist_rows", 0):
        problems.append(f"example twins: sqdist_rows {held} against the "
                        f"plain version, {launches}")
    for kernel in ("sqdist_rows", "rmsnorm", "flash_attention", "ssd_scan"):
        if not launches.get(kernel):
            problems.append(f"example twins: no {kernel} launch")
    return {"seconds": runs, "launches": launches,
            "sqdist_rows_held": held}


def phase_launch() -> tuple:
    """The launcher's programs on the card (slice 20): the five modes of
    ``launch/specs.py::build_program`` for llama3-8b at full width (d
    4,096, 32/8 heads of 128, vocab 128,256), 2 of 32 layers, on the (1,
    1) ``DeviceMesh`` of one rank (one NCCL rank, ``launch/mesh.py``):
    ``train`` (f32, B 1, S 4,096, sgd, remat), ``train_dynamic`` and
    ``train_periodic`` (f32, m = 2, one sequence of 1,024 a learner,
    from step b - 1: one checked step that syncs), ``prefill`` (bf16, (4,
    2,048)) and ``decode`` (bf16, batch 4 against a 2,048-deep cache);
    and (slice 21) ``train`` in bf16 at LAUNCH_BF16_LAYERS layers, the
    reference's production program at published dtype, whose step-1
    gradient ``_bf16_step1`` holds against the f32 gradient.
    Each is counted on meta by the dry run (``launch/dryrun.py``, its
    record written to ``build/torch_dryrun/``), then ``materialize``d and
    run three times (``_run_program``). Fails unless every output is bit
    for bit the entry points' and the repeat's, the launches are exact
    by family (remat's forward kernels twice, one ``sqdist_rows`` at (2,
    P)), the fleets synced, and the dry run equals ``analyze`` of the
    card's run: the products' FLOPs, the bytes outside the kernels, the
    kernels' work (``kernel_work`` of every launch) and the argument
    bytes (the memory's rise while materializing, each allocation
    rounded up to ``ALLOC_GRAIN``). Then ``torch_roofline_table`` over
    the records (every one compiled) and the seven example twins at
    ``--smoke`` (``_example_twins``). An OOM fails the phase."""
    import torch.distributed as dist
    from benchmarks import torch_roofline_table as table
    from repro_torch.launch.mesh import axis_sizes, device_mesh
    problems, programs = [], {}
    t0 = time.perf_counter()
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    started = not dist.is_initialized()
    if started:
        os.makedirs("build", exist_ok=True)
        init = os.path.abspath(os.path.join("build", "launch_pg"))
        if os.path.exists(init):
            os.remove(init)
        dist.init_process_group("nccl", init_method=f"file://{init}",
                                world_size=1, rank=0)
    try:
        mesh = device_mesh((1, 1), ("data", "model"))
        for key, mode, dtype, shape, layers in LAUNCH_PROGRAMS:
            programs[key] = _run_program(mode, dtype, shape, mesh, problems,
                                         layers)
            torch.cuda.empty_cache()
        step1 = _bf16_step1(problems)
    finally:
        if started:
            dist.destroy_process_group()
    rows = table.run(dryrun_dir=LAUNCH_DIR)
    verdict = table.check(rows)
    n = len(LAUNCH_PROGRAMS)
    if verdict != f"{n}/{n} compiled":
        problems.append(f"roofline table: {verdict}")
    programs_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    examples = _example_twins(problems)
    rec = {"phase": "launch", "arch": LAUNCH_ARCH, "layers": LAUNCH_LAYERS,
           "mesh": axis_sizes(mesh), "programs": programs,
           "train_bf16_step1": step1,
           "roofline_table": verdict, "programs_seconds": programs_s,
           "examples": examples,
           "examples_seconds": time.perf_counter() - t1,
           "problems": problems}
    emit(rec)
    print(table.format_markdown(table.load_records(LAUNCH_DIR)), flush=True)
    if problems:
        raise SystemExit(f"launch: {problems}")
    return programs, examples


def phase_analysis(kernel_rows: list) -> dict:
    """The analysis tools on the card's tree and the card: the lint of the
    port and this script and the contract matrix (``--check-all``'s
    static half; the audit's CPU half is the tests'), then the audit of
    one dynamic chunk of mnist_cnn at full width on the card, under
    ``torch.cuda.set_sync_debug_mode("warn")`` too: both counts of host
    syncs must be the documented budget. Then ``roofline.analyze`` of
    one dynamic round, and ``kernel_bound`` of each kernel at its timed
    shape beside its measured time."""
    from repro_torch.analysis import audit, contracts, lint, roofline
    card = peaks(torch.cuda.get_device_name(0))
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    bench = os.path.join(here, "benchmarks")
    findings = contracts.check_all() + lint.lint_paths(
        [os.path.join(here, "src", "repro_torch"), os.path.abspath(__file__)]
        + [os.path.join(bench, f) for f in sorted(os.listdir(bench))
           if f.startswith("torch_") and f.endswith(".py")])
    static_s = time.perf_counter() - t0
    if findings:
        emit({"phase": "analysis",
              "failed": [f.render() for f in findings[:20]]})
        raise SystemExit(f"{len(findings)} analysis finding(s)")

    cfg = get_arch("mnist_cnn")
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        M, ProtocolConfig(kind="dynamic", b=PERIOD, delta=DELTA),
        TrainConfig(optimizer="sgd", learning_rate=0.1), seed=0,
        device="cuda")
    streams = LearnerStreams(src, M, batch=B, seed=0)
    dl.run_chunk(streams.next_chunk(CHUNK))     # warm-up: cuDNN, scratch
    batches = streams.next_chunk(CHUNK)
    torch.cuda.synchronize()
    # the mode is set before the warnings are caught: setting it warns
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = audit.audit_learner(dl, batches)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    warned = [w for w in caught if "synchroniz" in str(w.message).lower()]
    audit_rec = {k: v for k, v in got.items() if k not in ("metrics",
                                                            "findings")}
    audit_rec["sync_debug_warnings"] = len(warned)
    audit_rec["findings"] = [f.render() for f in got["findings"]]
    if (got["findings"] or got["syncs"] != got["budget"]
            or len(warned) != got["budget"]):
        audit_rec["warned_at"] = sorted({f"{os.path.basename(w.filename)}:"
                                         f"{w.lineno}" for w in warned})
        emit({"phase": "analysis", "failed": {"audit": audit_rec}})
        raise SystemExit(f"host syncs over the budget: {audit_rec}")

    one = {k: v[:1] for k, v in streams.next_chunk(1).items()}
    rep = roofline.analyze(
        "mnist_cnn dynamic round (m=100, B=10)", dl.run_chunk, one,
        model_flops=6.0 * dl.model_size * M * B)
    bounds = []
    for row in kernel_rows:
        b = kernel_bound(row["kernel"], row["shape"],
                         getattr(torch, row["dtype"]), card)
        bounds.append({**row, **b,
                       "measured_over_bound": row["ms"] / b["bound_ms"]})
        if abs(b["bound_ms"] - row["bound_ms"]) > 1e-9:
            raise SystemExit(f"kernel_bound({row['kernel']}) "
                             f"{b['bound_ms']} != the phase's "
                             f"{row['bound_ms']}")
    rec = {"phase": "analysis", "static_seconds": static_s,
           "static_findings": 0, "audit": audit_rec,
           "roofline": rep.as_dict(),
           "roofline_table": roofline.format_table([rep]),
           "kernel_bounds": bounds}
    emit(rec)
    return rec


def phase_costs() -> dict:
    """``python -m repro_torch.telemetry costs`` on F2's stream
    (fault_train): the per-round gate / skip / sync FLOPs of its spec
    joined with the stream's fires."""
    from repro_torch.telemetry.__main__ import main as telemetry_main
    out = StringIO()
    with contextlib.redirect_stdout(out):
        code = telemetry_main(["costs", os.path.join(FAULT_DIR, "F2.jsonl")])
    if code != 0:
        raise SystemExit(f"telemetry costs exited {code}")
    costs = json.loads(out.getvalue())
    rec = {"phase": "costs", "stream": "build/fault_telemetry/F2.jsonl",
           **costs}
    emit(rec)
    if not (costs["rounds"] == ROUNDS and costs["fires"] >= 1
            and costs["per_round"]["sync_flops"] > 0):
        raise SystemExit(f"costs of F2's stream: {costs}")
    return rec


def main() -> None:
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    env = run("env", phase_env)
    build = run("build", phase_build)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    table = run("kernels", phase_kernels, gen)
    run("agree", phase_agree)
    launches = run("train", phase_train)
    torch.cuda.empty_cache()
    lm_table = run("lm_kernels", phase_lm_kernels, gen)
    run("lm_agree", phase_lm_agree)
    serve = run("serve", phase_serve)
    ssm_table, ssm_norm_err = run("ssm_kernels", phase_ssm_kernels, gen)
    run("ssm_agree", phase_ssm_agree)
    ssm = run("ssm_serve", phase_ssm_serve)
    torch.cuda.empty_cache()
    zoo_rows = run("zoo_kernels", phase_zoo_kernels, gen)
    run("zoo_agree", phase_zoo_agree)
    zoo = run("zoo_serve", phase_zoo_serve)
    torch.cuda.empty_cache()
    paper = run("paper_train", phase_paper_train)
    run("paper_agree", phase_paper_agree)
    net = run("net_train", phase_net_train)
    run("net_agree", phase_net_agree)
    tier = run("tier_train", phase_tier_train)
    run("tier_agree", phase_tier_agree)
    fault = run("fault_train", phase_fault_train)
    run("fault_agree", phase_fault_agree)
    torch.cuda.empty_cache()
    sharded = run("shard_train", phase_shard_train)
    run("train_step", phase_train_step)
    torch.cuda.empty_cache()
    bwd_table = run("lm_train_kernels", phase_lm_train_kernels, gen,
                    build["ptxas"])
    lm_train = run("lm_train", phase_lm_train)
    run("lm_train_agree", phase_lm_train_agree)
    moe_fleet = run("moe_fleet", phase_moe_fleet)
    torch.cuda.empty_cache()
    twin_launches, twin_kernels = run("twins", phase_twins)
    torch.cuda.empty_cache()
    launch, examples = run("launch", phase_launch)
    f32, bf16 = "float32", "bfloat16"
    fa = lm_table["flash_attention"]["shape"]
    timed_rows = [
        ("sqdist_rows", [M, P_MNIST], f32, table["sqdist_rows"]),
        ("sqdist_rows", [50, P_MNIST], f32, table["sqdist_rows_50"]),
        ("sqdist_rows", [25, P_MNIST], f32, table["sqdist_rows_25"]),
        ("sqdist_rows", [M, P_MNIST, TIER_G], f32,
         table["sqdist_rows_grouped"]),
        ("sqdist_rows", [M, P_DEEPDRIVE], f32,
         table["sqdist_rows_deepdrive"]),
        ("sqdist", [P_MNIST], f32, table["sqdist"]),
        ("rmsnorm", lm_table["rmsnorm"]["shape"], bf16, lm_table["rmsnorm"]),
        ("flash_attention", [fa[0], fa[1], fa[1], *fa[2:]], bf16,
         lm_table["flash_attention"]),
        ("flash_attention", [fa[0], fa[1], fa[1], *fa[2:]], f32,
         lm_table["flash_attention"]["f32"]),
        ("swa_attention", lm_table["swa_attention"]["shape"], bf16,
         lm_table["swa_attention"]),
        ("swa_attention", lm_table["swa_attention"]["shape"], f32,
         lm_table["swa_attention"]["f32"]),
        ("ssd_scan", ssm_table["ssd_scan"]["shape"], f32,
         ssm_table["ssd_scan"]),
        ("attention_bwd", bwd_table["attention_bwd"]["shape"], f32,
         bwd_table["attention_bwd"]),
        ("rmsnorm_bwd", bwd_table["rmsnorm_bwd"]["shape"], f32,
         bwd_table["rmsnorm_bwd"]),
        ("ssd_scan_bwd", bwd_table["ssd_scan_bwd"]["shape"], f32,
         bwd_table["ssd_scan_bwd"]),
        ("ssd_scan_bwd", bwd_table["ssd_scan_bwd"]["at_hymba_shape"]["shape"],
         f32, bwd_table["ssd_scan_bwd"]["at_hymba_shape"]),
        ("attention_bwd", bwd_table["attention_bwd_bf16"]["shape"], bf16,
         bwd_table["attention_bwd_bf16"]),
        ("rmsnorm_bwd", bwd_table["rmsnorm_bwd"]["bf16"]["shape"], bf16,
         bwd_table["rmsnorm_bwd"]["bf16"])]
    run("analysis", phase_analysis, [
        {"kernel": k, "shape": list(shape), "dtype": dt, "ms": t["ms"],
         "bound_ms": t["bound_ms"]} for k, shape, dt, t in timed_rows])
    run("costs", phase_costs)
    left = stop_children()
    if left:
        raise SystemExit(f"chip_smoke.py: child processes left: {left}")
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})
    csrc = "src/repro_torch/kernels/csrc/"

    def zoo_launches(kernel):
        return sum(v[kernel] for v in zoo.values())

    def zoo_paths(kernel):
        return {f"{k} serve, f32 prefill": v[kernel] for k, v in zoo.items()
                if v[kernel]}

    def zoo_shapes(kernel):
        return [{k: v for k, v in r.items() if k != "kernel"}
                for r in zoo_rows if r["kernel"] == kernel]

    kernels = [
        {"name": "sqdist_rows", "route": "cuda", "source": csrc + "sqdist.cu",
         "replaces": "src/repro/kernels/sqdist.py:81",
         "launches": (launches["sqdist_rows"] + sum(paper.values())
                      + sum(net.values()) + sum(tier.values())
                      + sum(fault.values())
                      + sum(sum(v.values()) for v in sharded.values())
                      + sum(twin_launches.values())),
         "launches_by_path": {"mnist dynamic": launches["sqdist_rows"],
                              **{k: v for k, v in paper.items()
                                 if k in ("deepdrive drift",
                                          "random augmentation")},
                              **{"network " + k: v for k, v in net.items()
                                 if v},
                              **{"tier " + k: v for k, v in tier.items()
                                 if v},
                              **{"fault " + k: v for k, v in fault.items()},
                              **{"shard " + k: sum(v.values())
                                 for k, v in sharded.items()},
                              "figure twins (quick grids)":
                                  twin_launches["figures"],
                              "other twins (quick grids)":
                                  twin_launches["others"]},
         "launches_by_shape_per_rank": sharded,
         **table["sqdist_rows"],
         "at_deepdrive_width": table["sqdist_rows_deepdrive"],
         "grouped": table["sqdist_rows_grouped"],
         "per_rank": {"(50, P)": table["sqdist_rows_50"],
                      "(25, P)": table["sqdist_rows_25"]}},
        {"name": "sqdist", "route": "cuda", "source": csrc + "sqdist.cu",
         "replaces": "src/repro/kernels/sqdist.py:41",
         "launches": launches["sqdist"], **table["sqdist"]},
        {"name": "rmsnorm", "route": "cuda", "source": csrc + "rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:25",
         "launches": serve["main"]["rmsnorm"] + ssm["rmsnorm"]
         + zoo_launches("rmsnorm"),
         "launches_by_path": {"llama3-8b serve": serve["main"]["rmsnorm"],
                              "mamba2-2.7b serve": ssm["rmsnorm"],
                              **zoo_paths("rmsnorm")},
         **lm_table["rmsnorm"], "max_abs_err": max(
             lm_table["rmsnorm"]["max_abs_err"], ssm_norm_err),
         "zoo_shapes": zoo_shapes("rmsnorm")},
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "attention_sm90.cu",
         "sources_by_dtype": {"bfloat16": csrc + "attention_sm90.cu",
                              "float32": csrc + "attention.cu"},
         "replaces": "src/repro/kernels/flash_attention.py:77",
         "launches": serve["main"]["flash_attention"]
         + zoo_launches("flash_attention"),
         "launches_by_path": {
             "llama3-8b serve": serve["main"]["flash_attention"],
             **zoo_paths("flash_attention")},
         **lm_table["flash_attention"],
         "zoo_shapes": zoo_shapes("flash_attention")},
        {"name": "swa_attention", "route": "cuda",
         "source": csrc + "attention_sm90.cu",
         "sources_by_dtype": {"bfloat16": csrc + "attention_sm90.cu",
                              "float32": csrc + "attention.cu"},
         "replaces": "src/repro/kernels/swa_attention.py:64",
         "launches": serve["swa"]["swa_attention"]
         + zoo_launches("swa_attention"),
         "launches_by_path": {
             "llama3-8b-swa prefill": serve["swa"]["swa_attention"],
             **zoo_paths("swa_attention")},
         **lm_table["swa_attention"],
         "zoo_shapes": zoo_shapes("swa_attention")},
        {"name": "ssd_scan", "route": "cuda", "source": csrc + "ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:74",
         "launches": ssm["ssd_scan"] + zoo_launches("ssd_scan"),
         "launches_by_path": {"mamba2-2.7b serve": ssm["ssd_scan"],
                              **zoo_paths("ssd_scan")},
         **ssm_table["ssd_scan"], "zoo_shapes": zoo_shapes("ssd_scan")},
    ]
    fleet = lm_train["fleet-llm-100m"]

    def train_launches(kernel):
        by_path = {**{f"{a} train ({lm_train[a]['layers']} layer"
                      + "s" * (lm_train[a]["layers"] != 1)
                      + f", {LM_TRAIN_STEPS} steps"
                      + (", remat" if lm_train[a]["remat"] else "") + ")":
                      lm_train[a]["launches"][kernel]
                      for a in LM_TRAIN_ARCHS + tuple(LM_MOE_LAYERS)},
                   **{f"fleet-llm-100m {k} (m = {FLEET_M}, "
                      f"{FLEET_STEPS} steps)": r["launches"][kernel]
                      for k, r in fleet["runs"].items()},
                   **{f"{k} launcher (m = 2, {MOE_FLEET_STEPS} steps)":
                      r["launches"].get(kernel, 0)
                      for k, r in moe_fleet.items()}}
        by_path = {k: n for k, n in by_path.items() if n}
        return sum(by_path.values()), by_path

    # the MoE fleets' Δ trigger
    moe_rows = {f"{k} launcher": r["launches"]["sqdist_rows"]
                for k, r in moe_fleet.items() if "sqdist_rows" in r["launches"]}
    kernels[0]["launches"] += sum(moe_rows.values())
    kernels[0]["launches_by_path"].update(moe_rows)
    for name in ("rmsnorm", "flash_attention", "swa_attention", "ssd_scan"):
        row = next(r for r in kernels if r["name"] == name)
        n, by_path = train_launches(name)
        row["launches"] += n
        row["launches_by_path"].update(by_path)
    no_tpu = ("none: the JAX package has no backward Pallas kernel (it "
              "differentiates jnp {}); this is the gradient of {}")
    for name, src, fwd, what in (
            ("attention_bwd", "attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:77", "attention"),
            ("rmsnorm_bwd", "rmsnorm_bwd.cu",
             "src/repro/kernels/rmsnorm.py:25", "norms"),
            ("ssd_scan_bwd", "ssd_scan_bwd.cu",
             "src/repro/kernels/ssd_scan.py:74", "SSD (_ssd_chunked)")):
        n, by_path = train_launches(name)
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": no_tpu.format(what, fwd),
                        "launches": n, "launches_by_path": by_path,
                        **bwd_table[name]})
    # the bf16 attention backward (A28), a program of its own, launched by
    # the launcher's bf16 train program below
    kernels.append({"name": "attention_bwd_bf16", "route": "cuda",
                    "source": csrc + "attention_bwd_bf16.cu",
                    "replaces": no_tpu.format(
                        "attention", "src/repro/kernels/flash_attention.py:77"
                        " in bf16"),
                    "launches": 0, "launches_by_path": {},
                    **bwd_table["attention_bwd_bf16"]})
    # the launcher's five programs (one observed call each, the launches
    # the dry run is held to) and the example twins at --smoke
    for row in kernels:
        by_path = row.setdefault("launches_by_path", {})
        for key, prog in launch.items():
            n = prog["launches_by_kernel"].get(row["name"], 0)
            if n:
                row["launches"] += n
                by_path[f"launch {key} ({LAUNCH_ARCH}, {prog['layers']} "
                        f"layers, one call)"] = n
        n = examples["launches"].get(row["name"], 0)
        if n:
            row["launches"] += n
            by_path["example twins (--smoke)"] = n
    # kernel_bench's rows: the reference's shapes, one launch a call
    for row in kernels:
        if row["name"] in twin_kernels:
            row["kernel_bench"] = twin_kernels[row["name"]]
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
