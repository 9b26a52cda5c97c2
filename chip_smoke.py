"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught):

1. device   — the card's name and power limit (nvidia-smi), its SM count and
              opt-in shared memory beside the port's H100 spec;
2. build    — every CUDA kernel of the port built from ``src/repro_torch``
              with nvcc, one process per source, all at once;
3. kernels  — each kernel against its plain PyTorch version on the card, in
              float32 and bfloat16, at the shapes the serving path gives it
              and at the smaller widths the kernels take, timed by CUDA
              events (median) and by profiler device time (the kernel's own
              events), the L2 flushed before every call, beside the rate and
              the bound for its work; paged decode also against its plain
              version in the kernels' order; the SSD scan also under strong
              decay and against the sequential-scan oracle, with its two
              passes (C B^T, then the chunk walk) timed apart; which paged,
              flash, matmul and SSD kernel variant ran, read from a profiler
              trace;
              the same for recurrentgemma-2b's shapes: flash and paged decode at
              10 query heads on one kv head of 256 (window 2048, a row past
              Sc), and the RG-LRU scan kernel at (8, 2048, 2560) and
              (1, 4096, 2560), also under strong and weak decay, at an S
              that neither its chunk nor its tile divides and with lengths - 1
              on chunk and tile edges;
              and qwen3-moe-235b-a22b's: flash at (8, 2048), 64 query heads
              on 4 kv heads of 128, causal, bfloat16, beside SDPA, and paged
              decode at g = 16 (its widest group; the variant read from the
              trace);
              and the vision and audio families': flash at D = 64 over
              Whisper's 1500 frames (bidirectional, a ragged tail), at one
              query row against them (the cross read of a decode tick), at
              its decoder's training shapes (448 queries against 1500 keys;
              causal at 448), and at InternVL2's 16/8 heads of 128; the
              training forward and its backward at Whisper's shapes; paged
              decode at g = 1, D = 64 and g = 2, D = 128; the encoder and
              cross-read shapes and both paged shapes timed beside SDPA and
              their bounds;
   Then the H100's paged-dispatch figure fitted from the paged kernel's
   device time (beside ``core/cost.py``'s ``PAGED_STEP_LATENCY_S``);
4. serve-check — Yi-6B widths cut to 2 layers, float32, through
              ``PlanServer`` (plan cache, one CUDA graph per bucket's decode
              step): identical token streams under the paged, gather, ref
              and auto decode kernels; each request's stream byte-identical
              to the same request decoded eagerly by ``make_decode_step``;
              paged launches exact per replay; a row freed while a later
              graphed tick is queued leaves that tick's table alone; one
              step-driven trace through ``ServingEngine`` (sanitizer on): an
              (8, 256) group, mid-decode joins, a cancel, an EOS and a
              stop-sequence exit, each stream byte-identical to the request
              alone through ``handle`` (or its prefix), launches exact, every
              page freed at the end; then the router over two replicas that
              share the server's weights (sanitizer on): the reference's
              failover trace (six batch-1 requests, contexts 40-56, 8 new
              tokens, arriving at 200/s from seed 3) with replica 1 drained
              after a token of index 2 or more while it holds live work;
              zero loss, requests resubmitted, every stream gapless and
              byte-identical to the request alone through ``handle``, no
              placement on the drained replica, launches exact over both;
5. serve    — full Yi-6B (32 layers, bfloat16, random weights from a seeded
              generator) serving three requests twice through ``PlanServer``
              with ``decode_kernel="auto"``: the first pass compiles the
              plans and captures the graphs (capture seconds), the second is
              the steady state; each plan's decode kernel printed (every one
              must be paged) and every kernel's launch count checked against
              the layer count and the plans; then each request once more (in
              its bucket, with 8 or more new tokens) under ``torch.profiler``
              for the device's busy time and idle share in prefill and in
              the graphed decode, and the paged split-kernel events inside
              the decode span's device-side annotation held at one per
              attention layer and tick; then
              the planner's paged and gather seconds per bucket beside both
              operators' measured device time;
   serve-engine — phase 5's model and weights with a pool of one arena,
              through ``ContinuousBatchingScheduler``: a closed burst of 12
              seeded batch-1 requests forms one (8, 2048) group, the rest
              join as members finish, one is cancelled and one stops at
              EOS; finish reasons, the EOS stream against the request
              alone, a byte-identical second replay, joins, reclaimed
              pages, the sanitizer and the launches gated; TTFT, queue and
              exec time per request, engine ms per tick, a traced tick's
              idle share, aggregate tok/s beside the same requests one by
              one through ``handle``, graphs held and peak memory printed;
   serve-router — the serve-engine phase's server as replica 0 and a second
              ``PlanServer`` holding the same weight tensors as replica 1
              behind ``EngineRouter`` (affinity placement, one (8, 2048)
              arena a pool, sanitizer on): the serve-engine trace twice, once
              undisturbed and once with replica 1 drained after its first
              member's 2nd token; 12 records a run, gapless streams, the
              trace's finish reasons, launches exact over both replicas and
              shared weight pointers gated; placements by reason, each
              replica's counters and device clock, aggregate tok/s on this
              card beside the single engine's, the fleet's tok/s by virtual
              device time (what two cards would give), device memory before
              and after the second replica, and how many bf16 streams equal
              the single engine's and the undisturbed run's printed;
6. serve-check-ssm — Mamba-2 1.3B widths cut to 2 layers, float32, through
              ``PlanServer``: identical token streams with the SSD kernel
              and with its plain version, graphed == eager, auto == paged,
              and the prefill -> decode handoff equal to a prefill one token
              longer; phase 4's engine trace (SSD launches per layer and
              prompt pass);
7. serve-ssm — full Mamba-2 1.3B (48 layers, bfloat16, seeded random
              weights) serving the same three requests twice with graphs,
              the SSD kernel's launches checked against the layer count,
              then traced (no paged events in its decode);
8. lenet-check — LeNet at the paper's width (1 x 28 x 28, 10 classes,
              float32): the test-mode forward at batch 64 and one training
              step (loss, gradients, updated parameters) with the matmul and
              conv kernels against the same with their plain versions, and
              2 conv + 2 matmul launches per forward;
9. lenet    — ``Keras2Plan`` trains LeNet for one epoch of 8,192 synthetic
              images at batch 64 and scores 10,000 (accuracy above 0.6),
              with step and scoring times and launches against layers x
              calls, then one step and one scoring pass traced;
10. serve-check-hybrid — RecurrentGemma-2B widths cut to 3 layers (rra),
              float32, window 2048, prompts past the window: identical token
              streams under paged, gather, ref and auto (every auto plan
              paged), graphed == eager, launches exact (flash and the RG-LRU
              scan per layer and prompt pass, paged per attention layer and
              tick), phase 4's engine trace, and the handoff past the window
              equal to a prefill one token longer;
11. serve-hybrid — full recurrentgemma-2b (26 layers, bfloat16, seeded random
              weights) serving phase 5's three requests and a (1, 3000) one in
              the (1, 4096) bucket twice with graphs, every plan paged,
              launches exact, then traced;
   serve-check-moe — Qwen3-MoE-235B-A22B widths cut to 2 layers,
              float32: identical token streams under paged, gather, ref and
              auto (every auto plan paged), graphed == eager, launches exact
              (flash per layer and prompt pass, paged per layer and tick),
              and phase 4's engine trace at the dropless capacity factor
              E / k (its first prompt pass coalesces seven requests, and
              capacity drops couple the rows of one prompt pass);
   serve-moe — full-width qwen3-moe-235b-a22b (seeded random weights,
              bfloat16) at the deepest of 16, 12, 8 and 4 layers whose
              plans fit 3/4 of the card by the planner's estimate, serving
              phase 5's three requests twice with graphs, every plan paged,
              launches exact: prefill ms and decode ms/step beside the
              expert products' floors, peak memory per bucket against the
              estimate (above it fails), then traced (idle share);
   serve-check-vlm, serve-check-audio — InternVL2-2B's and Whisper-medium's
              widths cut to 2 layers (a stack), float32, through
              ``PlanServer`` (InternVL2 with prefill=True, which hands no
              cache to decode; Whisper with prefill=False, the reference's
              one engine shape for an encoder-decoder): identical streams
              under paged, gather, ref and auto (every auto plan paged),
              graphed == eager, launches exact (Whisper's cross read is
              flash per decoder layer and tick), the plain path
              (``ops.BACKEND = "torch"``, eager) equal; Whisper also at the
              model level: build_cross_cache kernel == plain, 16 greedy
              tokens over the cross K/V graphed == eager == plain;
   serve-vlm — full internvl2-2b (24 layers, bfloat16, seeded weights)
              serving phase 5's three requests twice, every plan paged,
              launches exact, peaks per bucket against the estimate, traced;
   serve-audio — full whisper-medium (24 + 24 layers, bfloat16): (a) 8 rows
              of seeded frames through build_cross_cache (24 flash
              launches, encoder ms), 64 greedy tokens through the paged
              decode step at 448 slots, one CUDA graph (graph_step), equal
              to eager, launches exact, ms/tick and its device time by
              kind; (b) PlanServer with prefill=False serving (1, 64),
              (4, 192), (8, 384) twice, launches exact, peaks, traced;
   analysis — the plan, memory and cost audits (see phase_analysis);
12. train-check — Yi-6B widths cut to 2 layers, float32, batch 2, seq 512,
              three steps of sgd and of adam (grad_clip 1.0) through
              ``make_train_step`` with the flash kernel's training forward
              (``flash_attention_train``) against the same steps with
              attention forced to the plain path (``ops.BACKEND``), with 2
              microbatches, and with remat off: losses, grad norms and
              parameters within the stated tolerances, flash launches exact
              (the training forward layers x steps x microbatches x (1 +
              remat), the backward kernel ``flash_attention_bwd`` layers x
              steps x microbatches; every train phase below holds both);
13. train    — full Yi-6B (32 layers, bfloat16, seeded random weights),
              (4, 2048), 8 steps of adam through ``repro_torch.launch.train``'s
              own entry on the plan the port's planner compiles for one H100:
              losses finite and falling, flash launches exact, no CPU
              attention operator and no call of the backward's plain rule
              (every train phase on the card fails on one); step ms,
              tokens/s, MFU, peak memory
              against the plan's estimate, the checkpoint's save and restore
              time (restored == trained), then one step traced: device time
              by part (matmul, flash forward, attention backward, optimizer,
              other) and the idle share;
   train-check-ssm, train-check-hybrid — Mamba-2 1.3B's widths cut to 2
              layers and RecurrentGemma-2B's to 3 (``rra``), float32, batch
              2, seq 512, three steps of sgd and of adam (grad_clip 1.0):
              the kernel path (the scan kernels' training forwards and
              backward kernels, flash's training forward) against the plain
              path and against 2 microbatches, launches exact;
   train-ssm, train-hybrid — full mamba2-1.3b (48 layers) and
              recurrentgemma-2b (26 layers ``rra``), bfloat16, (4, 2048), 8
              steps of adam through ``launch.train``'s own entry on the
              planner's one-card plan: losses finite and falling
              (RecurrentGemma's below ln(vocab); Mamba-2's last three below
              step 2's by more than the step-to-step moves of steps 0-2),
              launches exact (each scan layer's training forward twice a
              step under remat, its backward kernel once), no plain scan or
              CPU attention function called; step ms, tokens/s, MFU, peak
              memory against the estimate, one traced step by part (SSD,
              RG-LRU and flash forwards, their backwards, matmul,
              optimizer, other) and the idle share;
   train-check-moe — Qwen3-MoE-235B-A22B widths cut to 1 layer (15 GB
              of float32 weights; the step's gradients and Adam state take
              45 GB), float32, (2, 512), three steps of sgd and of adam
              (clip 1.0) with flash's training forward against the plain
              attention path: losses, aux, grad norms and parameters within
              train-check's tolerances, launches exact;
   train-moe — full-width qwen3-moe-235b-a22b, bfloat16, (4, 2048), 8
              Adam steps through ``make_train_step`` at the deepest of 4, 2
              and 1 layers whose plan fits 3/4 of the card by the planner's
              estimate, from trainable_params: losses finite and falling,
              flash launches exact, no plain attention; step ms, tokens/s,
              MFU over the active parameters, peak against the estimate
              (above it fails), a traced step by part;
   train-check-vlm, train-vlm, train-check-audio, train-audio — the same
              pair for internvl2-2b (full depth, (4, 2048) after its 256
              patch-prefix tokens) and whisper-medium (full depth, (8, 448)
              over 1500 frames): twins at 2 layers in float32 (kernel path
              == plain path), then 8 Adam steps in bfloat16 from
              trainable_params through make_train_step: losses finite and
              falling, flash launches exact (Whisper: encoder, decoder and
              cross, each layer), no plain attention; step ms, tokens/s,
              MFU (6 N tokens, the encoder's over its frames), peak against
              the estimate, a traced step by part;
   parfor   — two ranks spawned on the one card in a gloo process group
              (``launch/ranks.py``, a file rendezvous under ``build/``;
              each rank's output printed after it): LeNet with phase 9's
              weights scores 2,048 images through ``Keras2Plan(mesh=
              make_local_mesh())`` (remote parfor): plan "remote", each
              rank's gathered probabilities within FP32_TOL of one
              process's ``predict_proba`` with equal argmax, 2 conv + 2
              matmul launches on each rank, no collective in the traced
              body and one with ``reduce="mean"``;
   train-sharded — two ranks on the card likewise: (a) Yi-6B's and
              Mamba-2 1.3B's widths at 2 layers, float32, global batch
              (2, 512), 3 adam steps under the planner's FSDP and DP plans
              for mesh (2,), against one process's ``make_train_step`` under
              train-check's tolerances, launches exact; (b) Yi-6B's full
              widths at the deepest of 4 and 2 layers whose two ranks fit
              within 3/4 of the card (the planner's per-card estimate),
              bfloat16, (4, 2048), 8 adam steps, FSDP:
              per rank step ms, tokens/s, peak memory against the planner's
              per-card estimate, collective calls and bytes a step, flash
              launches exact, losses falling. A rank that does not start,
              exits non-zero, runs off the card or finds a world under 2
              fails the phase. Two ranks on one card measure the code path,
              not scaling;
   train-model-axis and serve-model-axis — the same two ranks as a (1, 2)
              ("data", "model") mesh: training (tensor, sequence and expert
              parallelism) against one process and at full width, then
              serving under the planner's DP_TP layouts: float32 -smoke
              twins' streams == one process's, full Yi-6B through the paged
              kernel against one card (logits within SERVE_AXIS_BF16_TOL,
              flash and paged launches exact); the dry run
              (``launch/dryrun.py``'s trace of each rank's step on fake cuda
              tensors, run here beside the ranks) gives each rank's counted
              collective calls and bytes exactly and its measured peak
              within PEAK_RATIO_BOUNDS;
14. quickstart — the paper's softmax classifier through ``Keras2Plan`` on the
              card (``repro_torch.launch.quickstart``): accuracy above 0.8,
              matmul launches exact, the DML script byte-equal to the
              reference's (its sha256 pinned here, held by the CPU tests).

Phase 3 also holds ``flash_attention_train`` at the serving shapes (D = 128
and 256, both dtypes): its output bit for bit the serving op's, its lse and
its backward kernel's gradients against the plain versions; the backward
kernel ``flash_attention_bwd`` (csrc/flash_attention_bwd.cu) on its own at
every head dim, g from 1 to 16, every mask, Whisper's 1500-key and 448 x
1500 shapes and rows that see no key: float32 against the plain rule,
bfloat16 against the plain version in its order and against autograd
through the full-score form, two calls bit for bit equal, D = 96 raising,
timed at Yi-6B's training shape beside the plain rule, SDPA's backward and
its bound; and the
scan kernels' training ops at Mamba-2's (4, 2048, 64, 64, 128) and
RecurrentGemma's (4, 2048, 2560) training shapes and smaller, float32 and
bfloat16, strong decay included: each training forward's output bit for
bit the serving op's and its saved states against the plain training
forward's; each backward kernel against the plain backward and against
autograd through the plain forward, two calls bit for bit equal; both
timed (events, profiler device time) beside their bounds.

Before the last line it prints one JSON ``kernels`` line and the card's
``nvidia-smi`` name and power limit; the last line is the JSON ``ok`` line.
It exits non-zero without printing a result when no CUDA device is present
or when the port's sources are not beside it.
"""

from __future__ import annotations

import gc
from concurrent.futures import ThreadPoolExecutor
import hashlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# the port's sources beside this script (a tree a caller put on the path
# first, as tools/*_ab.py --tree does, wins)
if str(SRC) not in sys.path:
    sys.path.append(str(SRC))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import hw  # noqa: E402
from repro_torch.analysis import cost_audit, memory_audit, plan_audit  # noqa: E402
from repro_torch.analysis import matrix as analysis_matrix  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.config import InputShape, MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.lenet import make_spec  # noqa: E402
from repro_torch.core import comm, cost  # noqa: E402
from repro_torch.core.memory import estimate_memory  # noqa: E402
from repro_torch.core.parfor import count_collectives, parfor  # noqa: E402
from repro_torch.core.plan_cache import bucket_pow2 as bucket  # noqa: E402
from repro_torch.core.planner import PlanCompiler, compile_plan  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.frontend import Keras2Plan  # noqa: E402
from repro_torch.hw import sm_count  # noqa: E402
from repro_torch.interop import nn_params_from_numpy  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import conv2d_im2col as CONV  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import paged_decode_ref  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.core.strategies import ExecutionPlan, PlanConfig, Strategy  # noqa: E402
from repro_torch.launch import graph_analysis  # noqa: E402
from repro_torch.launch.mesh import TracedMesh, make_local_mesh, mesh_groups  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.launch.train_lenet import synthetic_images  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models.attention import paged_cache_write  # noqa: E402
from repro_torch.models.blocks import _lru_decay  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.nn import loss as LOSS  # noqa: E402
from repro_torch.nn.module import Sequential  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.graph_step import GraphDecodeStep, tick  # noqa: E402
from repro_torch.runtime.router import EngineRouter  # noqa: E402
from repro_torch.runtime.scheduler import (ContinuousBatchingScheduler,  # noqa: E402
                                           simulate_arrivals)
from repro_torch.runtime.serve_loop import (DECODE_SPAN, PREFILL_SPAN,  # noqa: E402
                                            PlanServer, ServeRequest, make_decode_step,
                                            make_prefill)
from repro_torch.runtime.train_loop import (OPTIMIZER_SPAN, init_opt_state,  # noqa: E402
                                            make_train_step, shard_params)
SEED = 0
# (atol, rtol, limit on the error's RMS over the reference's RMS). A
# kernel's error passes where |got - want| <= atol + rtol * |want|.
# float32: sums in another order only (RMS ratio ~6e-7 between the flash
# plain versions).
FP32_TOL = (1e-4, 1e-4, 1e-5)
# bfloat16: the kernel's output is held against its plain version computed
# in float32 on the same bfloat16 inputs, unrounded, in the kernel's own
# order where the kernel rounds inside (flash rounds P to bfloat16 per
# 64-key tile). What remains is the output's own rounding, at most half an
# ulp (2^-8 relative; ~1.6e-3 as an RMS ratio), and for flash the few P
# values that float32 summation order rounds the other way: in a row with
# few keys one such P moves the row by up to ~1e-3 (the kernel modelled in
# float64 on the CPU at the serving shape). A kernel that loses its
# ragged-tail mask scales a 1000-key row by ~1.5 %: errors up to ~5e-3 past
# the rtol term and an RMS ratio of ~1.4e-2, caught by both limits.
PAGED_BF16_TOL = (1e-5, 2.0 ** -8, 2.0 ** -8)
FLASH_BF16_TOL = (2e-3, 2.0 ** -8, 2.0 ** -8)
# flash_decode keeps P in float32 and rounds only its output, as paged
# decode does: the paged check's tolerance
DECODE_BF16_TOL = PAGED_BF16_TOL
# SSD: the kernel computes in float32 on the bfloat16 inputs and rounds only
# its output, so the plain version on float32 copies of the same inputs is
# its reference; atol covers float32 summation order where an output sits
# near zero (terms of size ~10-100 summed over 64 positions and 128 state
# entries: ~1e-5).
SSD_BF16_TOL = (1e-4, 2.0 ** -8, 2.0 ** -8)
# rglru_scan in bfloat16: the kernel computes in float32 on the bfloat16
# inputs and rounds only y, so the plain version on the same inputs with y
# left in float32 is its reference; what remains is y's own rounding (2^-8
# relative) and, near zero, float32 differences between the card's exp,
# tanh and sigmoid and PyTorch's (an ulp or two of h over ~1, ~1e-6)
RGLRU_BF16_TOL = (1e-5, 2.0 ** -8, 2.0 ** -8)
# matmul and conv2d_im2col in bfloat16: the kernel multiplies the bfloat16
# inputs exactly and sums in float32, so the plain version on float32 copies
# of the same inputs is its reference; what remains is the output's own
# rounding (2^-8 relative) and, near zero, float32 summation order over K
# (inputs scaled to unit-variance outputs: ~1e-5 at K = 4096)
GEMM_BF16_TOL = (1e-4, 2.0 ** -8, 2.0 ** -8)
# LeNet's training step, kernels against plain versions: the two runs' conv
# and affine outputs differ by float32 summation order (~1e-6 relative); a
# relu input or a max-pool pair that close to a tie then sends one element's
# gradient the other way, which moves a weight gradient entry by up to ~5e-3
# of that tensor's largest entry and the tensor's RMS by ~1e-3 of its own.
# A wrong kernel moves them by O(1). Held per tensor: (max error over the
# largest reference entry, error RMS over reference RMS).
LENET_STEP_TOL = (1e-2, 1e-3)
# LeNet's workloads (paper's demo model): the training batch, one epoch of
# synthetic 28 x 28 images, and the scoring set
LENET_BATCH, LENET_TRAIN, LENET_SCORE = 64, 8192, 10000
# the serving requests of both models: (batch, context), 32 new tokens each
SERVE_REQUESTS = ((1, 512), (4, 1000), (8, 2000))
CHECK_REQUESTS = ((2, 300), (1, 100), (3, 64))
# recurrentgemma-2b: the three serving requests and one (1, 3000) request in
# the (1, 4096) bucket, where the window of 2048 cuts in the prompt pass and
# decode rotates; its 3-layer check serves a prompt past the window too
HYBRID_SERVE_REQUESTS = SERVE_REQUESTS + ((1, 3000),)
HYBRID_CHECK_REQUESTS = ((1, 2100), (2, 300), (1, 64))
# fewest new tokens of a traced request (more where fewer would change its
# bucket): per-step device time needs a few steps, and the profiler's
# post-processing grows with every traced event
TRACE_NEW_TOKENS = 8
# idle time at the start of a LeNet trace, and traces taken at most until
# one holds the forward's kernel launches (phase_lenet)
TRACE_SLACK_S = 0.25
TRACE_ATTEMPTS = 3
# the 2-layer serve-checks' engine trace, every span in the 256 bucket:
# (batch, context, new_tokens, role); the first ENGINE_CHECK_GROUP fill an
# (8, 256) group, the rest arrive as its rows free and join into rows that
# the members with the fewest new tokens, the cancel and the early exits
# free
ENGINE_CHECK_TRACE = ((2, 150, 12, None), (1, 140, 3, None), (1, 160, 4, None),
                      (1, 130, 10, "cancel"), (1, 170, 10, "eos"), (1, 150, 10, "stop"),
                      (1, 120, 14, None), (1, 180, 6, None), (1, 140, 8, None),
                      (2, 130, 5, None))
ENGINE_CHECK_GROUP = 7
CANCEL_AFTER = 4          # tokens a cancelled request streams first
# serve-engine: ENGINE_REQUESTS batch-1 requests with seeded contexts and new
# tokens, every span in (1024, 2048] so that all share the (8, 2048)
# bucket: eight form the group, the rest join; ENGINE_CANCEL is cancelled,
# ENGINE_EOS stops at its own 6th token
ENGINE_REQUESTS, ENGINE_CONTEXTS, ENGINE_NEW_TOKENS = 12, (1040, 1792), (8, 48)
ENGINE_CANCEL, ENGINE_EOS = 2, 5
ENGINE_STEP_SPAN = "ServingEngine.step"
# the router check of phase 4: the reference's failover trace
# (tests/test_router.py), batch-1 (context, new tokens) pairs arriving at
# ROUTER_RATE per second from ROUTER_SEED; replica 1 is drained after a
# token of index ROUTER_DRAIN_AT or more while it holds live work
ROUTER_CHECK_TRACE = ((40, 8), (44, 8), (52, 8), (40, 8), (56, 8), (48, 8))
ROUTER_RATE, ROUTER_SEED, ROUTER_DRAIN_AT = 200.0, 3, 2
# the analysis phase: the full-width cells of phases 5, 7 and 11 (each
# request's (batch, context) bucketed as the servers bucket it), and the
# measured peaks of one eager tick and one prompt pass per bucket that
# those phases take on their own servers (analysis_measure)
ANALYSIS_MODELS = (("yi-6b", SERVE_REQUESTS), ("mamba2-1.3b", SERVE_REQUESTS),
                   ("recurrentgemma-2b", HYBRID_SERVE_REQUESTS))
ANALYSIS_MEASURED: list = []
SERVE_NEW_TOKENS = 32     # new tokens of each request of phases 5, 7 and 11
# flash_attention_train's backward kernel in bfloat16 against autograd
# through the plain full-score form in float32 on the same bfloat16 inputs:
# rtol and the RMS limit are the flash check's 2^-8 (the gradients' own
# rounding, ~1.8e-3 as an RMS ratio); the backward's delta = sum(dout * out)
# reads the kernel's bf16-rounded out, which moves a dq or dk element near
# zero by up to ~0.10 of the gradient's RMS (the kernel's order modelled on
# the CPU at S = 2048, D = 128 and 256), so atol is a quarter of the
# reference gradient's RMS
FLASH_BWD_BF16 = (0.25, 2.0 ** -8, 2.0 ** -8)
# the backward kernel in bfloat16 against its plain version in the kernel's
# order and rounding (attention_bwd_tiled, float32, on the same inputs,
# out and lse included): rtol and the RMS limit are 2^-8, the gradients'
# own rounding (~1.7e-3 as an RMS ratio); what float32 summation order adds
# is the few P and dS values that round to bfloat16 the other way, which
# near a zero gradient is not relative to it: the tiled version with its
# products taken in float64 (another order) left up to 5.6e-3 of the
# reference's RMS past the rtol term on the CPU at Whisper's cross shape,
# so atol is 2^-6 of the reference gradient's RMS
FLASH_BWD_TILED_BF16 = (2.0 ** -6, 2.0 ** -8, 2.0 ** -8)
# the backward kernel's cases (flash_bwd_cases): (name, b, hq, hkv, d, sq,
# sk, causal, window, q_offset); the first is Yi-6B's training shape, timed
FLASH_BWD_CASES = (
    ("Yi-6B training shape", 4, 32, 4, 128, 2048, 2048, True, 0, -1),
    ("D=128 g=8 S=1000 causal (ragged)", 1, 16, 2, 128, 1000, 1000, True, 0, -1),
    ("D=128 g=8 S=1000 window=100", 1, 16, 2, 128, 1000, 1000, True, 100, -1),
    ("D=128 g=2 Sq=512 Sk=2048 q_offset=700 window=256", 1, 4, 2, 128, 512, 2048, True, 256,
     700),
    ("D=128 g=2 Sq=300 Sk=200 causal (rows that see no key)", 1, 4, 2, 128, 300, 200, True, 0,
     -1),
    ("D=128 g=8 Sq=1024 Sk=2048 q_offset=1024 (a sequence shard of 16/2 heads)", 1, 16, 2, 128,
     1024, 2048, True, 0, 1024),
    ("D=128 g=16 S=512 causal (Qwen3-MoE)", 1, 32, 2, 128, 512, 512, True, 0, -1),
    ("D=128 g=2 S=2304 causal (InternVL2)", 1, 16, 8, 128, 2304, 2304, True, 0, -1),
    ("D=128 g=2 Sq=700 Sk=900 bidirectional (ragged)", 2, 4, 2, 128, 700, 900, False, 0, -1),
    ("D=128 g=1 S=150 causal (Sk not a multiple of 128: a key tile's second half past Sk)", 2,
     4, 4, 128, 150, 150, True, 0, -1),
    ("D=32 g=2 S=100 causal", 2, 4, 2, 32, 100, 100, True, 0, -1),
    ("D=32 g=1 S=100 bidirectional", 2, 2, 2, 32, 100, 100, False, 0, -1),
    ("D=64 g=1 S=1500 bidirectional (Whisper encoder)", 2, 16, 16, 64, 1500, 1500, False, 0, -1),
    ("D=64 g=1 Sq=448 Sk=1500 (Whisper cross)", 2, 16, 16, 64, 448, 1500, False, 0, -1),
    ("D=64 g=1 S=448 causal (Whisper decoder)", 2, 16, 16, 64, 448, 448, True, 0, -1),
    ("D=256 g=10 S=2048 window=2048 (RecurrentGemma)", 1, 10, 1, 256, 2048, 2048, True, 2048,
     -1),
    ("D=256 g=10 S=500 window=64", 1, 10, 1, 256, 500, 500, True, 64, -1),
    ("D=256 g=5 Sq=300 Sk=200 causal (5/1 heads a rank)", 1, 5, 1, 256, 300, 200, True, 0, -1),
    ("D=256 g=2 S=1000 bidirectional", 1, 4, 2, 256, 1000, 1000, False, 0, -1),
    ("D=256 g=10 Sq=200 Sk=1100 q_offset=700 window=300", 1, 10, 1, 256, 200, 1100, True, 300,
     700),
)
# the backward kernel's timed shapes (bfloat16; _flash_bwd_timing): each
# train phase's attention and the D = 32 smoke width's (label, b, hq, hkv,
# d, sq, sk, causal, window);
# the first is FLASH_BWD_CASES' first, whose entry is the kernels line's.
# The others are held against attention_bwd_tiled at FLASH_BWD_BF16: at
# these sizes a few dq elements pass FLASH_BWD_TILED_BF16's atol (2^-6 of
# the RMS) whatever computes them — at Yi's shape on another seed the
# mma.sync kernel and the TMA + wgmma one by the same 0.0158 of the RMS at
# the same element, the tiled version with float64 products by 0.0156 (an
# H100 80GB HBM3, 700 W)
FLASH_BWD_TIMED = (
    ("Yi-6B training shape", 4, 32, 4, 128, 2048, 2048, True, 0),
    ("InternVL2-2B training shape (2048 + a 256-token prefix)", 4, 16, 8, 128, 2304, 2304, True,
     0),
    ("Qwen3-MoE training shape (g = 16)", 4, 64, 4, 128, 2048, 2048, True, 0),
    ("Whisper-medium encoder (D = 64, bidirectional)", 8, 16, 16, 64, 1500, 1500, False, 0),
    ("Whisper-medium decoder self-attention (D = 64, causal)", 8, 16, 16, 64, 448, 448, True, 0),
    ("Whisper-medium cross attention (D = 64, 448 x 1500, bidirectional)", 8, 16, 16, 64, 448,
     1500, False, 0),
    ("RecurrentGemma-2B training shape (D = 256, window 2048)", 4, 10, 1, 256, 2048, 2048, True,
     2048),
    ("yi-6b-smoke widths (D = 32, 4/2 heads) at the train-check twins' (2, 512)", 2, 4, 2, 32,
     512, 512, True, 0),
)
# the float32 backward's timed shapes (_flash_bwd_timing): the float32
# train-check twins' attention at TRAIN_CHECK_SHAPE (label, b, hq, hkv, d,
# sq, sk, causal, window): Yi-6B's (train-check, the kernels line's
# float32 entry), RecurrentGemma-2B's (train-check-hybrid: window 2048, wider
# than the sequence) and Whisper-medium's encoder over its 1500 frames
# (train-check-audio, bidirectional)
FLASH_BWD_FP32_TIMED = (
    ("the train-check twin's shape (2, 512, 32/4 heads of 128, causal)", 2, 32, 4, 128, 512, 512,
     True, 0),
    ("the train-check-hybrid twin's shape (2, 512, 10/1 heads of 256, window 2048)", 2, 10, 1,
     256, 512, 512, True, 2048),
    ("the train-check-audio twin's encoder (2, 1500, 16/16 heads of 64, bidirectional)", 2, 16,
     16, 64, 1500, 1500, False, 0),
)
# train-check: Yi-6B widths cut to TRAIN_CHECK_LAYERS layers, float32,
# (batch, seq), TRAIN_CHECK_STEPS steps, grad_clip 1.0, per optimizer lr,
# on trainable_params' weights. The kernel path against the plain path (and
# microbatches, remat) under the CPU tests' tolerances against the
# reference (tests/test_torch_train.py): loss rtol 1e-5; grad_norm rtol
# 1e-3 (softmax's backward cancels in float32; at the model's own weights
# two float32 gradients differ by up to ~3e-4 of the largest); parameters
# under SGD atol 1e-5 and rtol 1e-5 (lr times that spread); under Adam each
# element within 2 x steps x lr (an element whose gradient is near Adam's
# eps moves by a rounding-dependent fraction of lr) and the error's RMS
# within 3e-3 of the parameter's
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SHAPE, TRAIN_CHECK_STEPS = 2, (2, 512), 3
TRAIN_CHECK_LR = {"sgd": 1e-3, "adam": 1e-4}
# train-check-ssm and train-check-hybrid: the full widths cut to these
# layers (float32, TRAIN_CHECK_SHAPE, TRAIN_CHECK_STEPS steps, clip 1.0), at
# the CPU tests' learning rates for each family: the SSM's are
# TRAIN_CHECK_LR's (tests/test_torch_train_ssm.py); the hybrid's Adam runs
# at 1e-5, since its tied sqrt(d)-scaled embedding carries elements that
# Adam moves by a rounding-dependent fraction of lr into every position
# holding their token (tests/test_torch_train_hybrid.py: at 1e-4 step 2's
# grad_norm moved by 2.4e-3 between two float32 runs of the same step)
RECURRENT_CHECKS = {"ssm": ("mamba2-1.3b", dict(num_layers=2)),
                    "hybrid": ("recurrentgemma-2b", dict(num_layers=3, block_pattern="rra"))}
RECURRENT_CHECK_LR = {"ssm": TRAIN_CHECK_LR, "hybrid": {"sgd": 1e-3, "adam": 1e-5}}
# train-ssm and train-hybrid: the full models, at the train phase's shape,
# steps, lr and clip, from trainable_params with the embedding scaled by
# the second entry; the third says the losses must fall below ln(vocab), the
# loss of uniform logits. At scale 1 RecurrentGemma-2B's step 0 reads 20.68,
# far above ln(256000) = 12.45: its logits start far from uniform, and 8
# steps only bring them back (to 12.95). At 0.5 step 0
# reads 12.59 and the losses fall to 12.40 (tools/train_init_sweep.py
# --embed-scales; PERF.md section 6). Mamba-2 1.3B gets below ln(50280) =
# 10.825 at no scale in 8 steps (the sweep over 1, 0.5, 0.3, 0.2, 0.1,
# 0.05: from 0.3 down its step 0 starts within 0.04 of ln(vocab) and its
# losses only wander by their step-to-step noise), so it keeps scale 1 and
# passes the learning gate instead (LEARNING_GATE)
RECURRENT_TRAIN = {"ssm": ("mamba2-1.3b", 1.0, False),
                   "hybrid": ("recurrentgemma-2b", 0.5, True)}
# the families whose train phase must show learning beyond its noise: the
# mean of the last three losses below step 2's by more than the largest
# step-to-step move of steps 0-2 (at scale 1 Mamba-2's moves are ~0.016 and
# the mean of its last three sits ~0.033 below step 2: PERF.md section 6)
LEARNING_GATE = ("ssm",)
# the backward kernels' float32 gradients (and the float32 outputs ddt, da,
# dd, dc of a bfloat16 run): FP32_TOL's rtol and RMS limit, atol 1e-4 of
# the reference gradient's RMS: ddt sums terms (a times the reverse cumsum
# of cum's gradient, up to ~16 x hundreds) that cancel to small values, so
# float32 summation order moves an element by up to 2.3e-5 of ddt's RMS of
# ~115 (2.7e-3) at Mamba-2's training shape (an H100 80GB HBM3 at 700 W),
# past FP32_TOL's absolute 1e-4
SCAN_BWD_FP32 = (1e-4, 1e-4, 1e-5)
# the backward kernels in bfloat16: each gradient is formed in float32 from
# the bfloat16 inputs and rounded once, held against the plain backward in
# float32 on the same values, unrounded: rtol and the RMS limit are the
# rounding's 2^-8; atol a quarter of the reference gradient's RMS, as the
# flash training op's gradients (an element near zero where float32
# summation order differs)
SCAN_BWD_BF16 = (0.25, 2.0 ** -8, 2.0 ** -8)
# the two training shapes of the scan kernels: Mamba-2 1.3B's and
# RecurrentGemma-2B's (batch 4, seq 2048)
SSD_TRAIN_SHAPE = (4, 2048, 64, 64, 128)
RGLRU_TRAIN_SHAPE = (4, 2048, 2560)
# train: full Yi-6B, bfloat16, trainable_params' seeded random weights,
# through repro_torch.launch.train's own entry; the plan is the planner's
# for one H100. Adam at lr 3e-4 (the port's TrainConfig default) with the
# launcher's grad_clip 1.0: on the card 1e-4 lowered the loss less in 8
# steps and 1e-3 raised it (PERF.md, PR 23)
TRAIN_STEPS, TRAIN_SHAPE, TRAIN_LR = 8, (4, 2048), 3e-4
# parfor and train-sharded: SHARDED_WORLD ranks on the one card over gloo
# (NCCL refuses two ranks on one device), each phase's ranks given at most
# SHARDED_TIMEOUT_S; parfor scores PARFOR_ROWS images; train-sharded (a)
# checks SHARDED_CHECKS' widths at 2 layers, float32, global batch
# SHARDED_CHECK_SHAPE, against one process; (b) trains full Yi-6B widths on
# SHARDED_TRAIN_SHAPE in bfloat16 at the deepest of SHARDED_DEPTHS whose
# ranks fit the card, a rank's CUDA context counted as CUDA_CONTEXT_BYTES.
# (b) stops at 4 layers: its step is set by gloo's ~0.7 GB/s across the
# host, and at 8 layers (the deepest that fits) its 8 steps took 128 s of
# a 900 s run (PERF.md, PR 28)
SHARDED_WORLD, SHARDED_TIMEOUT_S, PARFOR_ROWS = 2, 600, 2048
SHARDED_CHECKS = (("yi-6b", dict(num_layers=2)), ("mamba2-1.3b", dict(num_layers=2)))
SHARDED_CHECK_SHAPE, SHARDED_TRAIN_SHAPE = (2, 512), (4, 2048)
SHARDED_DEPTHS, CUDA_CONTEXT_BYTES = (4, 2), 2**30
# train-model-axis: the same SHARDED_WORLD ranks as a (1, 2) ("data",
# "model") mesh (tensor, sequence and expert parallelism; two ranks on one
# card measure the code path, not scaling). (a) float32 checks against one
# process at MODEL_AXIS_CHECKS' widths (arch, cut, global batch, the
# ln1/xln gains' scale) under the planner's dp_tensor_parallel plan with
# seq_shard_checkpoints off and on: Yi-6B and Mamba-2 1.3B at 2 layers and
# SHARDED_CHECK_SHAPE as train-sharded; RecurrentGemma-2B at 3 layers
# ("rra": its 10 heads split 5 a rank, its one kv head whole); Whisper-medium
# at 2 + 2 layers over its 1500 frames at its decoder context of 448, the
# attention norms' gains at 0.1 as the CPU tests run it (its init is badly
# conditioned: tests/test_torch_audio.py). (b) full Yi-6B widths under the
# planner's fsdp_tensor_parallel plan with seq_shard_checkpoints, bfloat16,
# SHARDED_TRAIN_SHAPE, TRAIN_STEPS Adam steps at TRAIN_LR, at the deepest of
# SHARDED_DEPTHS whose two ranks fit 3/4 of the card by the planner's
# per-card estimate (4 layers: each layer's sequence-parallel collectives
# move 32-64 MiB a call through gloo's host copies, ~1 s a layer and step
# on the H100: PERF.md);
# (c) Qwen3-MoE-235B-A22B at full width and MOE_MODEL_AXIS_LAYERS layer, the
# same form, its 128 experts split 64 a rank, its Adam state in bfloat16
# (the planner's compression): with float32 state the two ranks ran the
# card out of memory (PERF.md)
MODEL_AXIS_MESH = MeshConfig((1, SHARDED_WORLD), ("data", "model"))
MODEL_AXIS_CHECKS = (("yi-6b", dict(num_layers=2), SHARDED_CHECK_SHAPE, None),
                     ("mamba2-1.3b", dict(num_layers=2), SHARDED_CHECK_SHAPE, None),
                     ("recurrentgemma-2b", dict(num_layers=3, block_pattern="rra"),
                      SHARDED_CHECK_SHAPE, None),
                     ("whisper-medium", dict(num_layers=2, encoder_layers=2), (2, 448), 0.1))
MOE_MODEL_AXIS_LAYERS = 1
# serve-model-axis, in the same two ranks as a (1, 2) ("data", "model") mesh
# under the planner's DP_TP serve layout (cache on kv heads where they split
# the model axis, else along its sequence; SSM state on its heads): (a) the
# -smoke twins in float32 (RecurrentGemma cut to "rra": its one kv head
# splits its cache along the sequence), a (4, 128) prompt pass in the
# (4, 256) bucket and SERVE_AXIS_CHECK_TOKENS greedy tokens, each rank's
# stream byte-identical to one process's on the same weights; (b) full
# Yi-6B in bfloat16 (16 of 32 q heads and 2 of 4 kv heads a rank), a
# (4, 1000) prompt in the (4, 2048) bucket and SERVE_AXIS_TOKENS greedy
# tokens through the paged kernel from trainable_params, against one card:
# the prompt pass's logits and each tick's whose input tokens agree within
# SERVE_AXIS_BF16_TOL = (atol, rtol, error RMS over the logits' RMS). The
# model axis sums its bfloat16 partial products in another order, and 32
# layers carry each rounding on: a probe of the phase read a max error of
# 0.12 on logits of RMS 1.28 and max 5.9 (4 bfloat16 ulps at that
# magnitude) and an error RMS of 2.0 % of the logits'; a rank that dropped
# a partial sum would be off by the size of the logits
SERVE_AXIS_BF16_TOL = (0.25, 2.0 ** -5, 2.0 ** -5)
SERVE_AXIS_CHECKS = (("yi-6b-smoke", {}), ("mamba2-1.3b-smoke", {}),
                     ("recurrentgemma-2b-smoke", dict(num_layers=3, block_pattern="rra")),
                     ("qwen3-moe-235b-a22b-smoke", {}))
SERVE_AXIS_CHECK_SHAPE, SERVE_AXIS_CHECK_BUCKET, SERVE_AXIS_CHECK_TOKENS = (4, 128), 256, 16
SERVE_AXIS_SHAPE, SERVE_AXIS_BUCKET, SERVE_AXIS_TOKENS = (4, 1000), 2048, 32
SERVE_AXIS_PAGE = 64
# each rank's measured peak over the dry run's traced peak
# (launch/dryrun.py) of the same step: PERF.md's prediction, gated
PEAK_RATIO_BOUNDS = (0.75, 1.25)
TRAIN_ARGS = ["--arch", "yi-6b", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_SHAPE[0]),
              "--seq", str(TRAIN_SHAPE[1]), "--dtype", "bfloat16", "--optimizer", "adam",
              "--lr", str(TRAIN_LR), "--log-every", "1"]
# the MoE phases: MOE_ARCH at full width, depth cut. serve-check-moe serves
# CHECK_REQUESTS at MOE_CHECK_LAYERS layers in float32; its engine trace
# runs at a dropless capacity factor (E / k), since a prompt pass that
# coalesces several requests routes them as one group and capacity drops
# couple its rows. serve-moe serves SERVE_REQUESTS in bfloat16 at the
# deepest of MOE_SERVE_DEPTHS whose plans fit 3/4 of the card by the
# planner's estimate; train-moe trains TRAIN_SHAPE likewise at the deepest
# of MOE_TRAIN_DEPTHS (TRAIN_STEPS Adam steps at TRAIN_LR, clip 1.0, from
# trainable_params). train-check-moe holds the flash kernel's path against
# the plain path at MOE_TRAIN_CHECK_LAYERS layers in float32
# (TRAIN_CHECK_SHAPE, TRAIN_CHECK_STEPS steps): the embedding, head and
# one layer's experts are 3.73 B parameters, 15 GB in float32, and the
# step's parameters, gradients and Adam state take 45 GB of the card
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_CHECK_LAYERS, MOE_TRAIN_CHECK_LAYERS = 2, 1
MOE_SERVE_DEPTHS, MOE_TRAIN_DEPTHS = (16, 12, 8, 4), (4, 2, 1)
# the vision and audio phases: VLM_ARCH and AUDIO_ARCH at full width and
# depth in bfloat16, their twins at ENCDEC_CHECK_LAYERS layers (a stack) in
# float32. Whisper serves (a) at the model level: AUDIO_ROWS rows of seeded
# frames through build_cross_cache, then AUDIO_DECODE_TOKENS greedy tokens
# in a context of AUDIO_CONTEXT slots (Whisper's published decoder
# context), and (b) through PlanServer with prefill=False (the reference's
# one engine shape for an encoder-decoder) on AUDIO_SERVE_REQUESTS.
# InternVL2 trains on VLM_TRAIN_SHAPE text tokens after its 256-token
# prefix, Whisper on AUDIO_TRAIN_SHAPE decoder tokens over 1500 frames
VLM_ARCH, AUDIO_ARCH, ENCDEC_CHECK_LAYERS = "internvl2-2b", "whisper-medium", 2
AUDIO_ROWS, AUDIO_CONTEXT, AUDIO_DECODE_TOKENS = 8, 448, 64
AUDIO_SERVE_REQUESTS = ((1, 64), (4, 192), (8, 384))
VLM_TRAIN_SHAPE, AUDIO_TRAIN_SHAPE = (4, 2048), (8, 448)
# the quickstart's generated DML script is byte-equal to the reference's
# (examples/quickstart.py's): sha256 of the reference's text, which
# tests/test_torch_data_ckpt.py holds against the reference's generate_dml
QUICKSTART_DML_SHA256 = "d20d38e672f28fedd02f8337bd83016ea00b6ceaa298af6263f890ba868f5a7b"
_T0 = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n== {name} == (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls;
    ``flush`` (a large buffer) is rewritten before each call so the call
    finds the L2 cache cold, as it does between layers on the serving path."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def within(got, want, tol) -> tuple:
    """(ok, max abs error, max error over the reference's RMS, error RMS
    over the reference's RMS) of ``got`` against ``want`` under ``tol``."""
    atol, rtol, rms_limit = tol
    want = want.float()
    err = (got.float() - want).abs()
    ref_rms = max(float(want.pow(2).mean().sqrt()), 1e-30)
    max_err = float(err.max())
    rms_ratio = float(err.pow(2).mean().sqrt()) / ref_rms
    ok = (not bool((err > atol + rtol * want.abs()).any()) and rms_ratio <= rms_limit
          and bool(torch.isfinite(got).all()))
    return ok, max_err, max_err / ref_rms, rms_ratio


def check_close(name, got, want, tol) -> float:
    """Holds ``got`` against ``want`` under ``tol`` = (atol, rtol, RMS
    ratio limit), printing the readings; returns the max abs error."""
    ok, max_err, max_ratio, rms_ratio = within(got, want, tol)
    print(f"  {name}: max_abs_err={max_err:.3e} max_err/ref_rms={max_ratio:.3e} "
          f"err_rms/ref_rms={rms_ratio:.3e} tol(atol={tol[0]:g}, rtol={tol[1]:g}, "
          f"rms={tol[2]:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_err


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device():
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    info = hw.probe(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {info}")
    print(f"port spec: {hw.H100}")
    if info["capability"] != "9.0":
        fail(f"kernels are built for sm_90a, the card reports {info['capability']}")
    optin = info["smem_per_block_optin"]
    if optin is not None and optin < hw.H100.vmem_bytes:
        print(f"  note: opt-in shared memory {optin} B is below the spec's "
              f"{hw.H100.vmem_bytes} B")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    phase("build")
    t0 = time.perf_counter()
    out = _build.build_all()
    _build.library("paged_decode", PA._bind)
    _build.library("flash_attention", FA._bind)
    _build.library("flash_attention_bwd", FA._bind_bwd)
    _build.library("ssd_scan", SSD._bind)
    _build.library("matmul", MM._bind)
    _build.library("conv2d_im2col", CONV._bind)
    _build.library("rglru_scan", RG._bind)
    print(f"built {sorted(p.name for p in out.glob('*.so'))} into {out} "
          f"in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


def _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, seed):
    """Flat slot stacks, shuffled page tables, sentinel entries on every page
    a row has not committed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_tab = -(-sc // page)
    n_phys = b * n_tab
    q = torch.randn((b, 1, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((n_phys * page, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((n_phys * page, hkv, d), generator=gen, device="cuda").to(dtype)
    rng = np.random.default_rng(seed)
    tables = rng.permutation(n_phys).reshape(b, n_tab).astype(np.int32)
    for row, p in enumerate(pos):
        committed = -(-min(p + 1, sc) // page)
        tables[row, committed:] = n_phys
    return (q, k, v, torch.tensor(tables, device="cuda"),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def _bound_ms(nbytes: float, flops: float, dtype, tf32x3: bool = False) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak for their type. With
    ``tf32x3`` a float32 product may also run as three TF32 tensor-core
    products, and its operation bound is the smaller of the two."""
    peak = hw.H100.peak_flops if dtype == torch.bfloat16 else hw.H100_FP32_FLOPS
    t_bytes = nbytes / hw.H100.hbm_bandwidth * 1e3
    t_ops = flops / peak * 1e3
    if tf32x3 and dtype == torch.float32:
        t_ops = min(t_ops, 3 * flops / hw.H100_TF32_FLOPS * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tflops(flops: float, ms: float) -> str:
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def phase_kernels():
    phase("kernels")
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    results = {}

    results["paged_decode_attention"] = paged_kernel_cases(flush)

    def plain_flash(q, k, v, **mask):
        # float32: the plain version the port runs on the CPU; bfloat16: the
        # plain version in the kernel's order (its key tile), rounding P as
        # the kernel does
        if q.dtype == torch.float32:
            return FA.flash_attention_torch(q, k, v, **mask)
        return FA.flash_attention_tiled(q, k, v, bk=FA.key_tile(q.shape[-1]), **mask)

    # -- flash attention: B=2, Hq=32, Hkv=4, D=128 ---------------------------
    flash_cases = [  # (name, b, hq, hkv, d, sq, sk, causal, window, q_offset)
        ("S=2048 causal", 2, 32, 4, 128, 2048, 2048, True, 0, -1),
        ("S=1000 causal (ragged)", 2, 32, 4, 128, 1000, 1000, True, 0, -1),
        ("S=2048 window=256", 2, 32, 4, 128, 2048, 2048, True, 256, -1),
        ("Sq=512 Sk=2048 q_offset=-1", 2, 32, 4, 128, 512, 2048, True, 0, -1),
        ("Sq=512 Sk=2048 q_offset=700 window=256", 2, 32, 4, 128, 512, 2048, True, 256,
         700),
        ("S=1000 bidirectional", 2, 32, 4, 128, 1000, 1000, False, 0, -1),
        # a window narrower than the 128-key tile; the first 100 rows of
        # Sq=300 over Sk=200 see no key (zeros); one row past a query tile
        ("S=1000 window=100", 2, 32, 4, 128, 1000, 1000, True, 100, -1),
        ("Sq=300 Sk=200 causal", 2, 32, 4, 128, 300, 200, True, 0, -1),
        ("S=129 causal", 2, 32, 4, 128, 129, 129, True, 0, -1),
        # the smaller head dims the kernel is built for (yi-6b-smoke: D=32)
        ("D=32 S=100 causal", 2, 4, 2, 32, 100, 100, True, 0, -1),
        ("D=32 S=100 bidirectional", 2, 4, 2, 32, 100, 100, False, 0, -1),
        ("D=64 S=100 causal", 2, 4, 2, 64, 100, 100, True, 0, -1),
        # recurrentgemma's head dim and group (10 query heads on one kv head
        # of 256): a window that cuts, Sq < Sk, a ragged tail
        ("D=256 g=10 S=300 window=100", 1, 10, 1, 256, 300, 300, True, 100, -1),
        ("D=256 g=10 Sq=70 Sk=333 window=128", 2, 10, 1, 256, 70, 333, True, 128, -1),
        # its 64-key tiles: a window of one tile, bidirectional with a ragged
        # tail, rows that see no key, Sk past the window at both ends
        ("D=256 g=10 S=500 window=64", 1, 10, 1, 256, 500, 500, True, 64, -1),
        ("D=256 g=2 S=1000 bidirectional", 2, 4, 2, 256, 1000, 1000, False, 0, -1),
        ("D=256 g=10 Sq=300 Sk=200 causal", 1, 10, 1, 256, 300, 200, True, 0, -1),
        ("D=256 g=10 Sq=200 Sk=1100 q_offset=700 window=300", 1, 10, 1, 256, 200, 1100, True,
         300, 700),
    ]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, FLASH_BF16_TOL)):
        for name, b, hq, hkv, d, sq, sk, causal, window, off in flash_cases:
            q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
            got = FA.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
            want = plain_flash(q, k, v, causal=causal, window=window, q_offset=off)
            torch.cuda.synchronize()
            check_close(f"flash {str(dtype)[6:]} {name}", got, want, tol)
            # causal rows before the first key (query position < 0) see none
            blind = max(0, -(sk - sq if off < 0 else off)) if causal else 0
            if blind and bool(got[:, :, :blind].ne(0).any()):
                fail(f"flash {str(dtype)[6:]} {name}: rows with no unmasked key are not zero")
            elif blind:
                print(f"    the first {blind} rows, which see no key, are zero")
            del q, k, v, got, want
    flash_kernel_names(FA)

    # the serving path's shape: the (8, 2000) request's prompt pass, bucket 2048
    b, hq, hkv, d, s = 8, 32, 4, 128, 2048
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    got = FA.flash_attention(q, k, v, causal=True)
    want = plain_flash(q, k, v, causal=True)
    err = check_close("flash bfloat16 serving shape (B=8, S=2048, causal)", got, want,
                      FLASH_BF16_TOL)
    del got, want
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True), flush=flush)
    plain_ms = cuda_ms(lambda: FA.flash_attention_torch(q, k, v, causal=True), flush=flush)
    # yardstick only, never called by the port: the library's fused
    # attention on the same inputs, K/V expanded to all heads beforehand
    ke, ve = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                     flush=flush)
    dev_ms, _ = device_ms(lambda: FA.flash_attention(q, k, v, causal=True), "flash", flush)
    flops, nbytes = FA.work(q, k, v, True, 0, -1)
    bound, by = _bound_ms(nbytes, flops, torch.bfloat16)
    print(f"  flash timing: kernel {ms:.4f} ms by events ({_tflops(flops, ms)}), device time "
          f"{_dev(dev_ms)}, plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms ({_tflops(flops, lib_ms)}), bound "
          f"{bound:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP)")
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116",
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms)
    del q, k, v, ke, ve
    results["flash_attention_train"] = flash_train_cases(flush, plain_flash)
    results["flash_attention_train_fp32"] = flash_fp32_train_timing(flush)
    results.update(flash_bwd_cases(flush))
    results["flash_attention_d256"] = flash_hybrid_cases(flush, plain_flash)
    results["paged_decode_attention_g10_d256"] = paged_hybrid_cases(flush)
    results.update(moe_kernel_cases(flush, plain_flash))
    results.update(encdec_kernel_cases(flush, plain_flash))
    results["flash_decode"] = flash_decode_cases(flush)
    results["rglru_scan"] = rglru_kernel_cases(flush)
    results["ssd_scan"] = ssd_kernel_cases(flush)
    results.update(ssd_train_cases(flush))
    results.update(rglru_train_cases(flush))
    results["matmul"] = matmul_kernel_cases(flush)
    results["conv2d_im2col"] = conv_kernel_cases(flush)
    del flush
    torch.cuda.empty_cache()
    return results


def flash_train_cases(flush, plain_flash) -> dict:
    """flash_attention_train, the training forward, at the serving shapes
    (Yi's (8, 2048) prompt pass at D = 128 and recurrentgemma-2b's at
    D = 256, window 2048) in float32 and bfloat16: its output bit for bit
    the serving op's and within tolerance of the plain version, its lse
    against the plain training forward's (float32 on the same inputs), and
    its recompute backward's dq, dk and dv against autograd through the
    plain full-score form in float32. At Yi's shape in bfloat16 it is timed
    by events and device time beside the serving op's device time (the
    lse store's cost), the plain training forward, SDPA and its bound.
    Returns its kernels-line entry."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    entry = None
    for label, (b, hq, hkv, d, s, win) in (("D=128", (8, 32, 4, 128, 2048, 0)),
                                           ("D=256", (8, 10, 1, 256, 2048, 2048))):
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, FLASH_BF16_TOL)):
            name = f"flash_train {str(dtype)[6:]} {label} (B={b}, S={s}, window {win})"
            q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
            mask = dict(causal=True, window=win)
            out, lse = FA.flash_attention_train(q, k, v, **mask)
            serving = FA.flash_attention(q, k, v, **mask)
            torch.cuda.synchronize()
            if not torch.equal(out, serving):
                fail(f"{name}: the training op's output is not the serving op's")
            del serving
            err = check_close(f"{name} out", out, plain_flash(q, k, v, **mask), tol)
            _, plain_lse = FA.flash_attention_train_torch(q.float(), k.float(), v.float(),
                                                          **mask)
            check_close(f"{name} lse", lse, plain_lse, FP32_TOL)
            del out, lse, plain_lse
            grads = {}
            dout = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            FA.flash_attention_train(qq, kk, vv, **mask)[0].backward(dout)
            qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
            FA.flash_attention_torch(qf, kf, vf, **mask).backward(dout.float())
            for gname, got, want in (("dq", qq.grad, qf.grad), ("dk", kk.grad, kf.grad),
                                     ("dv", vv.grad, vf.grad)):
                gtol = FP32_TOL
                if dtype == torch.bfloat16:
                    rms = float(want.pow(2).mean().sqrt())
                    gtol = (FLASH_BWD_BF16[0] * rms,) + FLASH_BWD_BF16[1:]
                grads[gname] = check_close(f"{name} {gname} (backward kernel vs autograd "
                                           f"through the full-score form)", got, want, gtol)
            del qq, kk, vv, qf, kf, vf, dout
            torch.cuda.empty_cache()
            if label == "D=128" and dtype == torch.bfloat16:
                def train():
                    return FA.flash_attention_train(q, k, v, **mask)

                def serve():
                    return FA.flash_attention(q, k, v, **mask)

                ms = cuda_ms(train, flush=flush)
                serve_event_ms = cuda_ms(serve, flush=flush)
                _, names = device_ms(train, "flash", flush)
                # per launch, both ops in turns: train, serve, serve, train
                readings = {"train": [], "serve": []}
                for label_fn in ("train", "serve", "serve", "train"):
                    readings[label_fn].append(launch_ms(train if label_fn == "train" else serve,
                                                        "flash", flush))
                dev_ms, serve_ms = (
                    statistics.mean(got) if (got := [r[0] for r in readings[op]
                                                     if r[0] is not None]) else None
                    for op in ("train", "serve"))
                plain_ms = cuda_ms(lambda: FA.flash_attention_train_torch(q, k, v, **mask),
                                   reps=5, flush=flush)
                ke, ve = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                                         is_causal=True),
                                 flush=flush)
                del ke, ve
                flops, nbytes = FA.work_train(q, k, v, True, win, -1)
                bound, by = _bound_ms(nbytes, flops, dtype)
                print(f"  flash_train timing, {label}: kernel {ms:.4f} ms by events "
                      f"({_tflops(flops, ms)}; the serving op {serve_event_ms:.4f}), device "
                      f"time per launch {_dev(dev_ms)} against the serving op's "
                      f"{_dev(serve_ms)} (the lse store; readings in turns train, serve, "
                      f"serve, train: {readings['train']}, {readings['serve']} as (ms, "
                      f"launches traced of 10)) "
                      f"({', '.join(_short(n) for n in names) or 'no events'}), plain training "
                      f"forward {plain_ms:.3f} ms, scaled_dot_product_attention "
                      f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP)")
                entry = dict(name="flash_attention_train", route="cuda",
                             source="src/repro_torch/kernels/csrc/flash_attention.cu",
                             replaces="src/repro/kernels/flash_attention.py:116",
                             max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms)
            del q, k, v
    return entry


def flash_fp32_train_timing(flush) -> dict:
    """The float32 training forward (``flash_attention_train``, the float32
    path of csrc/flash_attention.cu) at the train-check twin's attention
    shape, Yi-6B's 32/4 heads of 128 at TRAIN_CHECK_SHAPE, causal: its
    output bit for bit the serving op's, out and lse against the plain
    training forward at FP32_TOL; events, profiler device time, the plain
    training forward, SDPA in float32 on expanded K/V (a yardstick, never
    called by the port) and the bound (the smaller of float32's and
    3xTF32's). Returns its kernels-line entry."""
    b, s = TRAIN_CHECK_SHAPE
    hq, hkv, d = 32, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(26)
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda") for _ in range(2))
    name = f"flash_train float32 train-check shape ({b}, {s}, {hq}/{hkv} heads of {d}, causal)"
    out, lse = FA.flash_attention_train(q, k, v, causal=True)
    if not torch.equal(out, FA.flash_attention(q, k, v, causal=True)):
        fail(f"{name}: the training op's output is not the serving op's")
    plain_out, plain_lse = FA.flash_attention_train_torch(q, k, v, causal=True)
    err = check_close(f"{name} out", out, plain_out, FP32_TOL)
    check_close(f"{name} lse", lse, plain_lse, FP32_TOL)
    del out, lse, plain_out, plain_lse

    def train():
        return FA.flash_attention_train(q, k, v, causal=True)

    ms = cuda_ms(train, flush=flush)
    dev_ms, names = device_ms(train, "flash", flush)
    plain_ms = cuda_ms(lambda: FA.flash_attention_train_torch(q, k, v, causal=True), reps=5,
                       flush=flush)
    ke, ve = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                     flush=flush)
    lib_names = traced_kernels(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                               flush=flush)
    del ke, ve
    flops, nbytes = FA.work_train(q, k, v, True, 0, -1)
    bound, by = _bound_ms(nbytes, flops, torch.float32, tf32x3=True)
    def listed(times):
        return ", ".join(f"{_short(n)} {t:.4f}" for n, t in times.items()) or "no events"

    print(f"  {name} timing: kernel {ms:.4f} ms by events ({_tflops(flops, ms)}), device time "
          f"{_dev(dev_ms)} ({listed(names)}); plain training forward {plain_ms:.3f} ms; "
          f"scaled_dot_product_attention {lib_ms:.4f} ms ({listed(lib_names)}); bound "
          f"{bound:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP)")
    return dict(name="flash_attention_train_fp32", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:116", max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def flash_hybrid_cases(flush, plain_flash) -> dict:
    """Flash at recurrentgemma-2b's shape (10 query heads on one kv head of
    256, window 2048) against its plain version in float32 and bfloat16:
    the (8, 2000) request's prompt pass in the (8, 2048) bucket, and the
    (1, 3000) request's (1, 4096) bucket, where the window cuts (key tiles
    wholly outside it are skipped). The (8, 2048) bfloat16 shape timed by
    events and device time beside its plain version, SDPA and its bound.
    Returns its kernels-line entry."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    hq, hkv, d, win = 10, 1, 256, 2048
    timed = None
    for b, s in ((8, 2048), (1, 4096)):
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, FLASH_BF16_TOL)):
            q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
            got = FA.flash_attention(q, k, v, causal=True, window=win)
            want = plain_flash(q, k, v, causal=True, window=win)
            torch.cuda.synchronize()
            err = check_close(f"flash {str(dtype)[6:]} recurrentgemma (B={b}, S={s}, Hq=10, "
                              f"Hkv=1, D=256, window {win})", got, want, tol)
            del got, want
            flops, nbytes = FA.work(q, k, v, True, win, -1)
            pairs = FA.unmasked_pairs(s, s, True, win, -1)
            bound, by = _bound_ms(nbytes, flops, dtype)
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True, window=win),
                             flush=flush)
                dev_ms, names = device_ms(
                    lambda: FA.flash_attention(q, k, v, causal=True, window=win), "flash",
                    flush)
                plain_ms = cuda_ms(lambda: FA.flash_attention_torch(q, k, v, causal=True,
                                                                    window=win),
                                   reps=5, flush=flush)
                lib = "not timed (the window needs an explicit mask there)"
                lib_ms = None
                if s <= win:
                    # yardstick only: the library's fused attention, K/V
                    # expanded to all heads; at S <= window the mask is causal
                    ke, ve = k.repeat_interleave(hq, 1), v.repeat_interleave(hq, 1)
                    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, ke, ve, is_causal=True), flush=flush)
                    lib = f"{lib_ms:.4f} ms ({_tflops(flops, lib_ms)})"
                    del ke, ve
                print(f"  flash timing, D=256 (B={b}, S={s}): kernel {ms:.4f} ms by events "
                      f"({_tflops(flops, ms)}), device time {_dev(dev_ms)} "
                      f"({', '.join(_short(n) for n in names) or 'no events'}), plain "
                      f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib}, bound "
                      f"{bound:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP, {pairs} pairs a head)")
                if timed is None:
                    timed = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by, library_ms=lib_ms)
            del q, k, v
    return dict(name="flash_attention_d256", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:116", **timed)


def paged_hybrid_cases(flush) -> dict:
    """Paged decode at recurrentgemma-2b's serving shape, g * D = 2560 (10
    query heads on one kv head of 256): the (8, 2000) request mid-decode in
    its (8, 2048) bucket, pages of 64, rows at positions 2000-2024 and one
    past Sc whose slots were written by rotating writes, in float32 and
    bfloat16, against the plain version, the kernels' order and the
    literal-rule oracle; the bfloat16 call timed. Returns its kernels-line
    entry."""
    sms = sm_count(torch.device("cuda"))
    b, hq, hkv, d, page, sc = 8, 10, 1, 256, 64, 2048
    pos = [2000 + 4 * i for i in range(7)] + [sc + 52]
    timed = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, PAGED_BF16_TOL)):
        q, k, v, tables, posv = _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, 16)
        gen = torch.Generator(device="cuda").manual_seed(17)
        for step in range(3):
            kn = torch.randn((b, 1, hkv, d), generator=gen, device="cuda").to(dtype)
            vn = torch.randn((b, 1, hkv, d), generator=gen, device="cuda").to(dtype)
            paged_cache_write(k, v, kn, vn, posv - 2 + step, tables, page, sc, window=sc)
        label = f"paged {str(dtype)[6:]} recurrentgemma (B=8, g=10, D=256, Sc=2048)"
        got = PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc)
        want = PA.paged_attention_torch(q.float(), k.float(), v.float(), tables, posv,
                                        page=page, sc=sc)
        model = PA.paged_attention_model(q, k, v, tables, posv, page=page, sc=sc, sms=sms)
        lit = paged_decode_ref(q.float(), k.float(), v.float(), tables, posv, page=page,
                               sc=sc, window=sc)
        torch.cuda.synchronize()
        err = check_close(label, got, want, tol)
        check_close(f"{label} vs the kernel's order", got, model, tol)
        check_close(f"{label} vs literal-rule oracle", got, lit, tol)
        del got, want, model, lit
        if dtype == torch.bfloat16:
            timed = paged_timing(PA, "recurrentgemma (B=8, g=10, D=256, Sc=2048)",
                                 (q, k, v, tables, posv), page, sc, err, flush)
        del q, k, v, tables, posv
    timed.pop("steps")
    return dict(name="paged_decode_attention_g10_d256", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_attention.py:130", library_ms=None, **timed)


def moe_kernel_cases(flush, plain_flash) -> dict:
    """Flash and paged decode at qwen3-moe-235b-a22b's attention shape: 64
    query heads on 4 kv heads of 128 (g = 16, paged decode's widest group).
    Flash: the (8, 2000) request's prompt pass in the (8, 2048) bucket,
    causal, bfloat16, against its plain version in the kernel's order,
    timed by events and device time beside its plain version, SDPA and its
    bound. Paged decode: that request mid-decode (pages of 64, Sc 2048),
    float32 and bfloat16, against its plain version and the kernels' order,
    the bfloat16 call timed and its variant read from the trace. Returns
    both kernels-line entries."""
    b, hq, hkv, d, s = 8, 64, 4, 128, 2048
    gen = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    got = FA.flash_attention(q, k, v, causal=True)
    want = plain_flash(q, k, v, causal=True)
    err = check_close(f"flash bfloat16 qwen3-moe (B={b}, S={s}, Hq={hq}, Hkv={hkv}, D={d}, "
                      "causal)", got, want, FLASH_BF16_TOL)
    del got, want
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True), flush=flush)
    dev_ms, names = device_ms(lambda: FA.flash_attention(q, k, v, causal=True), "flash", flush)
    plain_ms = cuda_ms(lambda: FA.flash_attention_torch(q, k, v, causal=True), reps=5,
                       flush=flush)
    # yardstick only, never called by the port: the library's fused attention
    # on the same inputs, K/V expanded to all heads beforehand
    ke, ve = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                     flush=flush)
    del ke, ve
    flops, nbytes = FA.work(q, k, v, True, 0, -1)
    bound, by = _bound_ms(nbytes, flops, torch.bfloat16)
    print(f"  flash timing, qwen3-moe (B={b}, S={s}, g=16): kernel {ms:.4f} ms by events "
          f"({_tflops(flops, ms)}), device time {_dev(dev_ms)} "
          f"({', '.join(_short(n) for n in names) or 'no events'}), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms ({_tflops(flops, lib_ms)}), bound "
          f"{bound:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP)")
    want_name = FA.kernel_name(d, torch.bfloat16)
    if names and not any(want_name in n for n in names):
        fail(f"flash qwen3-moe: the trace holds {sorted(names)}, not {want_name}")
    flash = dict(name="flash_attention_g16", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:116", max_abs_err=err, ms=ms,
                 device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 library_ms=lib_ms)
    del q, k, v

    sms = sm_count(torch.device("cuda"))
    page, sc = 64, 2048
    pos = [2000 + 4 * i for i in range(b)]
    timed = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, PAGED_BF16_TOL)):
        inputs = _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, 22)
        label = f"paged {str(dtype)[6:]} qwen3-moe (B={b}, g=16, D={d}, Sc={sc})"
        got = PA.paged_decode_attention(*inputs, page=page, sc=sc)
        qf, kf, vf = (t.float() for t in inputs[:3])
        want = PA.paged_attention_torch(qf, kf, vf, *inputs[3:], page=page, sc=sc)
        model = PA.paged_attention_model(*inputs, page=page, sc=sc, sms=sms)
        torch.cuda.synchronize()
        perr = check_close(label, got, want, tol)
        check_close(f"{label} vs the kernel's order", got, model, tol)
        del got, want, model, qf, kf, vf
        if dtype == torch.bfloat16:
            timed = paged_timing(PA, "qwen3-moe (B=8, g=16, D=128, Sc=2048)", inputs, page,
                                 sc, perr, flush)
        del inputs
    timed.pop("steps")
    paged = dict(name="paged_decode_attention_g16", route="cuda",
                 source="src/repro_torch/kernels/csrc/paged_decode.cu",
                 replaces="src/repro/kernels/paged_attention.py:130", library_ms=None, **timed)
    return {"flash_attention_g16": flash, "paged_decode_attention_g16": paged}


def encdec_kernel_cases(flush, plain_flash) -> dict:
    """Flash and paged decode at the vision and audio families' shapes.
    Flash, float32 and bfloat16, each against its plain version: Whisper's
    encoder (8 rows, 16 heads of 64, 1500 frames, bidirectional: a ragged
    tail of 92 keys past 11 128-key tiles), its cross read at one query row
    through the flash op (the decode tick takes ``flash_decode``, in
    :func:`flash_decode_cases`), its decoder's training shapes (cross: 448
    queries against 1500 keys; self: causal at 448, g = 1) and InternVL2's
    prompt pass (16 query heads on 8 kv heads of 128, S = 2048, causal);
    each Whisper shape's bfloat16 call read from a profiler trace, which
    must hold ``flash_wgmma_kernel<64>``. The training forward at Whisper's
    two training shapes: its output bit for bit the serving op's, its lse
    and its recompute backward (a ragged last chunk of 476 keys) against
    the plain versions. Paged decode at g = 1, D = 64 (Whisper's decoder,
    Sc = 448) and g = 2, D = 128 (InternVL2, Sc = 2048), at page edges and
    mid-decode. The encoder shape and both paged shapes timed in bfloat16.
    Returns their three kernels-line entries."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    shapes = {  # name: (b, hq, hkv, d, sq, sk, causal)
        "whisper encoder": (8, 16, 16, 64, 1500, 1500, False),
        "whisper cross decode": (8, 16, 16, 64, 1, 1500, False),
        "whisper cross train": (8, 16, 16, 64, 448, 1500, False),
        "whisper decoder train": (8, 16, 16, 64, 448, 448, True),
        "internvl2 prompt": (4, 16, 8, 128, 2048, 2048, True),
    }

    def inputs(name, dtype):
        b, hq, hkv, d, sq, sk, _causal = shapes[name]
        return tuple(torch.randn(sh, generator=gen, device="cuda").to(dtype)
                     for sh in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))

    def label(name):
        b, hq, hkv, d, sq, sk, causal = shapes[name]
        return (f"{name} (B={b}, Hq={hq}, Hkv={hkv}, D={d}, Sq={sq}, Sk={sk}, "
                f"{'causal' if causal else 'bidirectional'})")

    timed = {"flash_attention_d64": "whisper encoder"}
    kept = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, FLASH_BF16_TOL)):
        for name, shape in shapes.items():
            q, k, v = inputs(name, dtype)
            got = FA.flash_attention(q, k, v, causal=shape[-1])
            want = plain_flash(q, k, v, causal=shape[-1])
            torch.cuda.synchronize()
            err = check_close(f"flash {str(dtype)[6:]} {label(name)}", got, want, tol)
            del got, want
            if dtype == torch.bfloat16 and name.startswith("whisper"):
                want_name = FA.kernel_name(shape[3], dtype)
                ran = sorted(_short(n) for n in traced_kernels(
                    lambda: FA.flash_attention(q, k, v, causal=shape[-1]), calls=1)
                    if _kernel_family(n) == "flash")
                print(f"    the trace reads {', '.join(ran) or 'no events'}")
                if ran and not any(want_name in n for n in ran):
                    fail(f"flash {name}: the trace holds {ran}, not {want_name}")
            if dtype == torch.bfloat16 and name in timed.values():
                kept[name] = (q, k, v, err)
            del q, k, v
    for name in ("whisper cross train", "whisper decoder train"):
        for dtype in (torch.float32, torch.bfloat16):
            flash_train_check(f"flash_train {str(dtype)[6:]} {label(name)}",
                              *inputs(name, dtype), shapes[name][-1])
            torch.cuda.empty_cache()

    entries = {}
    for key, name in timed.items():
        q, k, v, err = kept.pop(name)

        def call():
            return FA.flash_attention(q, k, v, causal=False)

        ms = cuda_ms(call, flush=flush)
        dev_ms, names = device_ms(call, "flash", flush)
        plain_ms = cuda_ms(lambda: FA.flash_attention_torch(q, k, v, causal=False), reps=5,
                           flush=flush)
        # yardstick only, never called by the port: the library's fused
        # attention on the same inputs (g = 1: no expansion)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), flush=flush)
        lib_dev, lib_names = device_ms(lambda: F.scaled_dot_product_attention(q, k, v), "flash",
                                       flush)
        flops, nbytes = FA.work(q, k, v, False, 0, -1)
        bound, by = _bound_ms(nbytes, flops, torch.bfloat16)
        want_name = FA.kernel_name(q.shape[-1], torch.bfloat16)
        if names and not any(want_name in n for n in names):
            fail(f"flash {name}: the trace holds {sorted(names)}, not {want_name}")
        print(f"  flash timing, {label(name)}: kernel {ms:.4f} ms by events "
              f"({_tflops(flops, ms)}), device time {_dev(dev_ms)} "
              f"({', '.join(_short(n) for n in names) or 'no events'}), plain "
              f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.4f} ms by events, "
              f"device time {_dev(lib_dev)} ({', '.join(_short(n) for n in lib_names)}), bound "
              f"{bound:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        entries[key] = dict(name=key, route="cuda",
                            source="src/repro_torch/kernels/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:116",
                            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del q, k, v

    sms = sm_count(torch.device("cuda"))
    page = 64
    for key, name, (b, hq, hkv, d, sc), edges, mid in (
            ("paged_decode_attention_g1_d64", "whisper decoder", (8, 16, 16, 64, AUDIO_CONTEXT),
             [0, 63, 64, 127, 200, 300, 446, 447], [400 + 6 * i for i in range(8)]),
            ("paged_decode_attention_g2", "internvl2", (8, 16, 8, 128, 2048),
             [0, 63, 64, 1000, 1500, 2000, 2046, 2047], [2000 + 4 * i for i in range(8)])):
        shape = f"{name} (B={b}, g={hq // hkv}, D={d}, Sc={sc})"
        timing = None
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, PAGED_BF16_TOL)):
            for which, pos in (("page edges", edges), ("mid-decode", mid)):
                inp = _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, 43)
                lab = f"paged {str(dtype)[6:]} {shape} {which}"
                got = PA.paged_decode_attention(*inp, page=page, sc=sc)
                qf, kf, vf = (t.float() for t in inp[:3])
                want = PA.paged_attention_torch(qf, kf, vf, *inp[3:], page=page, sc=sc)
                model = PA.paged_attention_model(*inp, page=page, sc=sc, sms=sms)
                torch.cuda.synchronize()
                err = check_close(lab, got, want, tol)
                check_close(f"{lab} vs the kernel's order", got, model, tol)
                del got, want, model, qf, kf, vf
                if dtype == torch.bfloat16 and which == "mid-decode":
                    timing = paged_timing(PA, shape, inp, page, sc, err, flush)
                del inp
        timing.pop("steps")
        entries[key] = dict(name=key, route="cuda",
                            source="src/repro_torch/kernels/csrc/paged_decode.cu",
                            replaces="src/repro/kernels/paged_attention.py:130",
                            library_ms=None, **timing)
    return entries


def flash_decode_cases(flush) -> dict:
    """``flash_decode`` (one query row a batch row against K/V in the
    model's (B, Sk, Hkv, D) layout, read in place), float32 and bfloat16,
    against its plain version on the same inputs: Whisper's cross read
    (8, 16/16, 1 x 1500, 64), also over one layer of a stacked (L, B, Sk,
    Hkv, D) cross cache as the decode tick hands it; Sk of 1, 37, a split's
    edge and one past either side; causal with ``q_offset`` inside the
    first split; a window; and g = 1, 2, 8 and 16 query heads a kv head.
    The cross read timed in bfloat16 beside scaled_dot_product_attention on
    (B, Hq, 1, D) and transposed copies of K/V made before the timing, the
    plain version and the bound. Returns its kernels-line entry."""
    gen = torch.Generator(device="cuda").manual_seed(45)
    sms = sm_count(torch.device("cuda"))
    # Sk = edge: four splits of exactly DECODE_MIN_SPLIT keys for Whisper's
    # 128 (row, kv head) pairs on an H100's 132 SMs (FA.decode_splits)
    edge = 4 * FA.DECODE_MIN_SPLIT
    whisper = (8, 16, 16, 1500, 64)
    cases = [  # label, (b, hq, hkv, sk, d), causal, window, q_offset
        ("whisper cross decode", whisper, False, 0, -1),
        ("Sk = 1", (8, 16, 16, 1, 64), False, 0, -1),
        ("Sk = 37", (8, 16, 16, 37, 64), False, 0, -1),
        (f"Sk = {edge - 1}", (8, 16, 16, edge - 1, 64), False, 0, -1),
        (f"Sk = {edge}, a split's edge", (8, 16, 16, edge, 64), False, 0, -1),
        (f"Sk = {edge + 1}", (8, 16, 16, edge + 1, 64), False, 0, -1),
        ("causal, q_offset 50 (inside the first split)", whisper, True, 0, 50),
        ("causal, window 100 at q_offset 700", whisper, True, 100, 700),
        ("window 64 (the last 64 keys)", whisper, False, 64, -1),
        ("g = 2", (8, 32, 16, 1500, 64), False, 0, -1),
        ("g = 8", (4, 64, 8, 1500, 64), False, 0, -1),
        ("g = 16", (2, 256, 16, 1500, 64), False, 0, -1),
    ]
    kept = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, DECODE_BF16_TOL)):
        for label, (b, hq, hkv, sk, d), causal, window, q_offset in cases:
            q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            got = FA.flash_decode(q, k, v, causal=causal, window=window, q_offset=q_offset)
            want = FA.flash_decode_torch(q.float(), k.float(), v.float(), causal=causal,
                                         window=window, q_offset=q_offset)
            torch.cuda.synchronize()
            lo, hi = FA.decode_range(sk, causal, window, q_offset)
            n, split = FA.decode_splits(lo, hi, b * hkv, sms)
            err = check_close(f"flash_decode {str(dtype)[6:]} {label} (B={b}, Hq={hq}, "
                              f"Hkv={hkv}, Sk={sk}, D={d}; {n} splits of {split})", got, want,
                              tol)
            if dtype == torch.bfloat16 and label == "whisper cross decode":
                kept = (q, k, v, err)
            del got, want
        stack = torch.randn((3, *whisper[:1], whisper[3], whisper[2], whisper[4]),
                            generator=gen, device="cuda").to(dtype)
        q = torch.randn(whisper[:2] + whisper[4:], generator=gen, device="cuda").to(dtype)
        got = FA.flash_decode(q, stack[1], stack[2], causal=False)
        want = FA.flash_decode_torch(q.float(), stack[1].float(), stack[2].float(), causal=False)
        torch.cuda.synchronize()
        check_close(f"flash_decode {str(dtype)[6:]} whisper cross decode over layer 1 of a "
                    "stacked (3, 8, 1500, 16, 64) cache", got, want, tol)
        del stack, got, want
    q, k, v, err = kept

    def call():
        return FA.flash_decode(q, k, v, causal=False)

    ms = cuda_ms(call, flush=flush)
    dev_ms, names = device_ms(call, "flash", flush)
    plain_ms = cuda_ms(lambda: FA.flash_decode_torch(q, k, v, causal=False), reps=5, flush=flush)
    # yardstick only, never called by the port: the library's fused
    # attention over K/V in its own (B, H, S, D) layout, copied beforehand
    q4, kt, vt = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, kt, vt), flush=flush)
    lib_dev, lib_names = device_ms(lambda: F.scaled_dot_product_attention(q4, kt, vt), "flash",
                                   flush)
    flops, nbytes = FA.work_decode(q, k, v, False, 0, -1)
    bound, by = _bound_ms(nbytes, flops, torch.bfloat16)
    if names and not any("flash_decode_kernel" in n for n in names):
        fail(f"flash_decode: the trace holds {sorted(names)}, not flash_decode_kernel")
    n, split = FA.decode_splits(0, 1500, 8 * 16, sms)
    print(f"  flash_decode timing, whisper cross decode (B=8, Hq=16, Hkv=16, Sk=1500, D=64, "
          f"{n} splits of {split} keys): {ms:.4f} ms by "
          f"events, device time {_dev(dev_ms)} ("
          + ", ".join(f"{_short(n)} {t:.4f} ms" for n, t in names.items()) + f"), plain "
          f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.4f} ms by events, device "
          f"time {_dev(lib_dev)} ({', '.join(_short(n) for n in lib_names)}), bound {bound:.4f} "
          f"ms ({by}; {nbytes / 1e6:.1f} MB)")
    entry = dict(name="flash_decode", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:116", max_abs_err=err, ms=ms,
                 device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 library_ms=lib_ms)
    del q, k, v, q4, kt, vt
    return entry


def flash_train_check(name, q, k, v, causal: bool) -> None:
    """``flash_attention_train`` at one shape: its output bit for bit the
    serving op's, its lse against the plain training forward's (float32 on
    the same inputs), and its recompute backward's dq, dk and dv against
    autograd through the plain full-score form in float32 (bfloat16 at
    FLASH_BWD_BF16)."""
    dtype = q.dtype
    out, lse = FA.flash_attention_train(q, k, v, causal=causal)
    if not torch.equal(out, FA.flash_attention(q, k, v, causal=causal)):
        fail(f"{name}: the training op's output is not the serving op's")
    _, plain_lse = FA.flash_attention_train_torch(q.float(), k.float(), v.float(),
                                                  causal=causal)
    check_close(f"{name} lse", lse, plain_lse, FP32_TOL)
    del out, lse, plain_lse
    gen = torch.Generator(device="cuda").manual_seed(44)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    FA.flash_attention_train(qq, kk, vv, causal=causal)[0].backward(dout)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    FA.flash_attention_torch(qf, kf, vf, causal=causal).backward(dout.float())
    for gname, got, want in (("dq", qq.grad, qf.grad), ("dk", kk.grad, kf.grad),
                             ("dv", vv.grad, vf.grad)):
        gtol = FP32_TOL
        if dtype == torch.bfloat16:
            gtol = (FLASH_BWD_BF16[0] * float(want.pow(2).mean().sqrt()),) + FLASH_BWD_BF16[1:]
        check_close(f"{name} {gname} (backward kernel vs autograd through the full-score "
                    "form)", got, want, gtol)


def flash_bwd_cases(flush) -> dict:
    """The attention backward kernel (``flash_attention_bwd``) on
    FLASH_BWD_CASES (every head dim, g from 1 to 16, causal, window,
    q_offset, Sq != Sk, ragged tails, bidirectional, rows that see no key)
    from the training forward kernel's out and lse, in float32 against the
    plain rule (``attention_bwd_torch``) at FP32_TOL and in bfloat16
    against ``attention_bwd_tiled`` at FLASH_BWD_TILED_BF16 and against
    autograd through the plain full-score form in float32 at
    FLASH_BWD_BF16; rows that see no key give dq = 0 and keys no row sees
    dk = dv = 0; two calls on the same inputs give the same bits; a head
    dim the kernel is not built for (96) and mixed dtypes raise. At each
    shape of FLASH_BWD_TIMED in bfloat16 (Yi-6B's the first case's inputs,
    the others held against ``attention_bwd_tiled`` at FLASH_BWD_BF16
    first): events, profiler device time, the plain rule,
    scaled_dot_product_attention's backward on expanded K/V (a yardstick,
    never called by the port) and the bound from ``work_bwd``; the same in
    float32 at each shape of FLASH_BWD_FP32_TIMED (the float32 train-check
    twins' attention), held against the plain rule at FP32_TOL first.
    Returns the kernels-line entries: ``flash_attention_bwd`` (bfloat16 at
    Yi-6B's shape) and ``flash_attention_bwd_fp32`` (float32 at the
    train-check twin's)."""
    gen = torch.Generator(device="cuda").manual_seed(61)
    entries = {}
    for name, b, hq, hkv, d, sq, sk, causal, window, off in FLASH_BWD_CASES:
        mask = dict(causal=causal, window=window, q_offset=off)
        qpos = (sk - sq if off < 0 else off) + torch.arange(sq, device="cuda")
        seen = FA._chunk_mask(qpos, 0, sk, sk, causal, window)
        for dtype in (torch.float32, torch.bfloat16):
            label = f"flash_bwd {str(dtype)[6:]} {name} (B={b}, Hq={hq}, Hkv={hkv}, D={d}, " \
                    f"Sq={sq}, Sk={sk})"
            q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dtype)
            out, lse = FA.flash_attention_train(q, k, v, **mask)
            args = (q, k, v, out, lse, dout)
            got = FA.flash_attention_bwd(*args, **mask)
            again = FA.flash_attention_bwd(*args, **mask)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                fail(f"{label}: two calls on the same inputs differ")
            del again
            if bool(got[0][:, :, ~seen.any(1)].any()):
                fail(f"{label}: rows that see no key have a nonzero dq")
            if bool(got[1][:, :, ~seen.any(0)].any()) or bool(got[2][:, :, ~seen.any(0)].any()):
                fail(f"{label}: keys that no row sees have a nonzero dk or dv")
            errs = []
            if dtype == torch.float32:
                want = FA.attention_bwd_torch(*args, **mask)
                for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                    errs.append(check_close(f"{label} {gname} vs the plain rule", g, w,
                                            FP32_TOL))
                del want
            else:
                tiled = FA.attention_bwd_tiled(*args, **mask)
                for gname, g, w in zip(("dq", "dk", "dv"), got, tiled):
                    rms = float(w.pow(2).mean().sqrt())
                    tol = (FLASH_BWD_TILED_BF16[0] * rms,) + FLASH_BWD_TILED_BF16[1:]
                    errs.append(check_close(f"{label} {gname} vs the kernel's order", g, w,
                                            tol))
                del tiled
                leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
                FA.flash_attention_torch(*leaves, **mask).backward(dout.float())
                for gname, g, leaf in zip(("dq", "dk", "dv"), got, leaves):
                    rms = float(leaf.grad.pow(2).mean().sqrt())
                    tol = (FLASH_BWD_BF16[0] * rms,) + FLASH_BWD_BF16[1:]
                    check_close(f"{label} {gname} vs autograd through the full-score form", g,
                                leaf.grad, tol)
                del leaves
            del got
            torch.cuda.empty_cache()
            if name == FLASH_BWD_TIMED[0][0] and dtype == torch.bfloat16:
                entries["flash_attention_bwd"] = _flash_bwd_timing(args, mask, max(errs), flush)
            del q, k, v, dout, out, lse, args
    for name, b, hq, hkv, d, sq, sk, causal, window in FLASH_BWD_TIMED[1:]:
        mask = dict(causal=causal, window=window, q_offset=-1)
        q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = FA.flash_attention_train(q, k, v, **mask)
        args = (q, k, v, out, lse, dout)
        got = FA.flash_attention_bwd(*args, **mask)
        errs = []
        for gname, g, w in zip(("dq", "dk", "dv"), got, FA.attention_bwd_tiled(*args, **mask)):
            tol = (FLASH_BWD_BF16[0] * float(w.pow(2).mean().sqrt()),) + FLASH_BWD_BF16[1:]
            errs.append(check_close(f"flash_bwd bfloat16 {name} {gname} vs the kernel's order", g,
                                    w, tol))
        del got
        torch.cuda.empty_cache()
        print(f"  {name}:")
        _flash_bwd_timing(args, mask, max(errs), flush)
        del q, k, v, dout, out, lse, args
        torch.cuda.empty_cache()
    # float32 (the 3xTF32 passes) at the float32 train-check twins' attention
    # shapes, the first (Yi-6B's) the kernels line's float32 entry
    for name, b, hq, hkv, d, sq, sk, causal, window in FLASH_BWD_FP32_TIMED:
        mask = dict(causal=causal, window=window, q_offset=-1)
        q, dout = (torch.randn((b, hq, sq, d), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((b, hkv, sk, d), generator=gen, device="cuda") for _ in range(2))
        out, lse = FA.flash_attention_train(q, k, v, **mask)
        args = (q, k, v, out, lse, dout)
        errs = [check_close(f"flash_bwd float32 {name} {gname} vs the plain rule", g, w,
                            FP32_TOL)
                for gname, g, w in zip(("dq", "dk", "dv"), FA.flash_attention_bwd(*args, **mask),
                                       FA.attention_bwd_torch(*args, **mask))]
        print(f"  float32 at {name}:")
        timed = _flash_bwd_timing(args, mask, max(errs), flush, "flash_attention_bwd_fp32")
        entries.setdefault("flash_attention_bwd_fp32", timed)
        del q, k, v, dout, out, lse, args
        torch.cuda.empty_cache()
    flash_bwd_kernel_names()
    q = torch.zeros((1, 4, 64, 96), device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 64, 96), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 64), device="cuda")
    for what, args in (("D=96", (q, kv, kv, q, lse, q)),
                       ("dout in float32", (q[..., :64], kv[..., :64], kv[..., :64],
                                            q[..., :64], lse, q[..., :64].float()))):
        try:
            FA.flash_attention_bwd(*(t.contiguous() for t in args))
        except (ValueError, TypeError) as e:
            print(f"  flash_bwd {what}: raises ({e})")
        else:
            fail(f"flash_bwd {what}: the kernel took a shape it is not built for")
    return entries


def flash_bwd_kernel_names() -> None:
    """Which passes of csrc/flash_attention_bwd.cu each head dim and dtype
    ran, read from a profiler trace of a small call each (one trace per
    configuration); fails where a traced call ran another dK/dV or dQ
    kernel than the ones the source dispatches to (``FA.bwd_kernel_names``:
    bfloat16 at D = 64, 128 and 256 the TMA + wgmma passes, at D = 32
    mma.sync, float32 the 3xTF32 passes at every head dim)."""
    gen = torch.Generator(device="cuda").manual_seed(62)
    took = []
    for dtype in (torch.bfloat16, torch.float32):
        for d in FA.HEAD_DIMS:
            q, dout = (torch.randn((1, 4, 200, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(2))
            k, v = (torch.randn((1, 2, 200, d), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            out, lse = FA.flash_attention_train(q, k, v, causal=True)
            names = {m.group(0) for name in traced_kernels(
                lambda: FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=True), calls=1)
                for m in [re.search(r"flash_bwd_\w+_kernel(<\d+>)?", name)] if m}
            took.append(f"{str(dtype)[6:]} D={d} -> {', '.join(sorted(names)) or 'not measured'}")
            want = FA.bwd_kernel_names(d, dtype)
            if names and not all(w in names for w in want):
                fail(f"flash_bwd {str(dtype)[6:]} D={d} ran {sorted(names)}, not {want}")
    print("  flash_bwd kernels by head dim (profiler): " + "; ".join(took))


def _flash_bwd_timing(args, mask, err, flush, entry_name: str = "flash_attention_bwd") -> dict:
    """The backward kernel at one shape: events, profiler device time, the
    plain rule, scaled_dot_product_attention's backward on K/V expanded to
    every head, and the bound (in float32 the smaller of float32's and
    3xTF32's: the card's least time for the same products); its
    kernels-line entry under ``entry_name``."""
    q, k, v, out, lse, dout = args
    g = q.shape[1] // k.shape[1]

    def call():
        return FA.flash_attention_bwd(*args, **mask)

    ms = cuda_ms(call, flush=flush)
    dev_ms, names = device_ms(call, "flash_bwd", flush)
    want = FA.bwd_kernel_names(q.shape[-1], q.dtype)
    if names and not all(any(w in n for n in names) for w in want):
        fail(f"flash_bwd {tuple(q.shape)} {q.dtype} ran {sorted(names)}, not {want}")
    plain_ms = cuda_ms(lambda: FA.attention_bwd_torch(*args, **mask), reps=3, warmup=1,
                       flush=flush)
    # yardstick only, never called by the port: the library's fused attention
    # backward, K/V expanded beforehand, its forward's graph kept for the calls
    qe, ke, ve = (t.detach().requires_grad_() for t in (q, k.repeat_interleave(g, 1),
                                                        v.repeat_interleave(g, 1)))
    o = F.scaled_dot_product_attention(qe, ke, ve, is_causal=mask["causal"])
    lib_ms = cuda_ms(lambda: torch.autograd.grad(o, (qe, ke, ve), dout, retain_graph=True),
                     flush=flush)
    del o, qe, ke, ve
    flops, nbytes = FA.work_bwd(*args, mask["causal"], mask["window"], mask["q_offset"])
    bound, by = _bound_ms(nbytes, flops, q.dtype, tf32x3=True)
    print(f"  flash_bwd timing, {str(q.dtype)[6:]} {tuple(q.shape)} q, {tuple(k.shape)} k/v: "
          f"kernel {ms:.4f} ms by "
          f"events ({_tflops(flops, ms)}), device time {_dev(dev_ms)} ("
          f"{', '.join(f'{_short(n)} {t:.4f}' for n, t in names.items()) or 'no events'}); "
          f"plain rule {plain_ms:.3f} ms; scaled_dot_product_attention's backward "
          f"{lib_ms:.4f} ms ({_tflops(flops, lib_ms)}); bound {bound:.4f} ms ({by}; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return dict(name=entry_name, route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention.py:116", max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def _rglru_inputs(b, s, w, dtype, seed, decay="normal"):
    """xb, r_pre, i_pre, y_pre ~ N(0, 1) in ``dtype`` and c = -8 softplus
    of a_log: log(1 + 15 u) (the model's init), 10 (strong decay, with
    r > 0.95: a < 1e-33) or -30 (weak: a = 1 in float32)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xb, r_pre, i_pre, y_pre = (torch.randn((b, s, w), generator=gen, device="cuda")
                               for _ in range(4))
    if decay == "normal":
        a_log = torch.log1p(15 * torch.rand((w,), generator=gen, device="cuda"))
    else:
        a_log = torch.full((w,), 10.0 if decay == "strong" else -30.0, device="cuda")
    if decay == "strong":
        r_pre = r_pre.abs() + 3.0
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    return ([t.to(dtype) for t in (xb, r_pre, i_pre, y_pre)]
            + [_lru_decay({"a_log": a_log}), lengths])


def rglru_kernel_cases(flush) -> dict:
    """The RG-LRU scan kernel against its plain version (the sequential
    float32 loop): at recurrentgemma-2b's prompt shapes, (8, 2048, 2560) and
    the (1, 3000) request's (1, 4096) bucket, in float32 and bfloat16, under
    strong and weak decay, and in float32 at an S that is a multiple of
    neither the chunk nor the planned tile of chunks; y and the state at
    each row's ``lengths - 1``. There and at batch 1, also against the plain
    version in the kernel's chunked order; then at 1, 2 and 32 chunks a
    block with ``lengths - 1`` on chunk and tile edges, and at a width that
    is not a multiple of a block's 16 channels. Both bfloat16 prompt
    shapes timed by events and device time beside the plain loop and the
    byte bound (no single PyTorch call computes the recurrence). Returns the
    kernels-line entry of the (8, 2048) shape."""
    sms = sm_count(torch.device("cuda"))
    w = 2560
    timed = {}
    for label, dtype, decay, shape in (("float32", torch.float32, "normal", (8, 2048, w)),
                                       ("float32 strong decay", torch.float32, "strong",
                                        (2, 512, w)),
                                       ("float32 weak decay", torch.float32, "weak",
                                        (2, 512, w)),
                                       ("float32 ragged chunks", torch.float32, "normal",
                                        (3, 1001, w)),
                                       ("bfloat16", torch.bfloat16, "normal", (8, 2048, w)),
                                       ("bfloat16 batch 1", torch.bfloat16, "normal",
                                        (1, 4096, w))):
        b, s = shape[:2]
        chunk, chunks = RG.chunk_plan(b, s, w, sms)
        if label == "float32 ragged chunks" and not (s % chunk and s % (chunk * chunks)):
            fail(f"rglru_scan: S={s} is a multiple of the chunk {chunk} or of the tile of "
                 f"{chunks}; the ragged case needs another S")
        args = _rglru_inputs(*shape, dtype, 21, decay)
        y, h_last = RG.rglru_scan(*args)
        want_y, want_h = RG.rglru_scan_torch(*args, out_dtype=torch.float32)
        torch.cuda.synchronize()
        tol = FP32_TOL if dtype == torch.float32 else RGLRU_BF16_TOL
        name = f"rglru_scan {label} {shape} ({chunks} chunks of {chunk} a block)"
        err = check_close(f"{name} y", y, want_y, tol)
        check_close(f"{name} state at lengths - 1", h_last, want_h, FP32_TOL)
        if label in ("float32 ragged chunks", "bfloat16 batch 1"):
            own_y, own_h = RG.rglru_scan_chunked_torch(*args, out_dtype=torch.float32,
                                                       chunk=chunk)
            check_close(f"{name} y vs the kernel's order", y, own_y, tol)
            check_close(f"{name} state vs the kernel's order", h_last, own_h, FP32_TOL)
            del own_y, own_h
        del y, h_last, want_y, want_h
        if dtype == torch.bfloat16:
            ms = cuda_ms(lambda: RG.rglru_scan(*args), flush=flush)
            dev_ms, names = device_ms(lambda: RG.rglru_scan(*args), "rglru", flush)
            plain_ms = cuda_ms(lambda: RG.rglru_scan_torch(*args), reps=3, warmup=1,
                               flush=flush)
            # float32 operations on the elements: the CUDA cores' rate
            flops, nbytes = RG.work(*args)
            bound, by = _bound_ms(nbytes, flops, torch.float32)
            passes = ", ".join(f"{_short(n)} {t:.4f}" for n, t in names.items())
            print(f"  rglru_scan timing, bfloat16 {shape}, {chunks} chunks of {chunk} a block: "
                  f"kernel {ms:.4f} ms by events ({nbytes / ms / 1e6:.0f} GB/s), device time "
                  f"{_dev(dev_ms)} ({passes or 'no events'}), plain loop {plain_ms:.3f} ms, "
                  f"bound {bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB); library: none (no "
                  f"single PyTorch call computes the recurrence)")
            timed[shape] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by)
        del args
    print("  rglru_scan device time: " + "; ".join(
        f"{shape} {_dev(t['device_ms'])} (bound {t['bound_ms']:.4f})"
        for shape, t in timed.items()))

    # the edges: lengths - 1 at 0, on both sides of a chunk's end (7 | 8)
    # and of a tile's (255 | 256 at 32 or 2 chunks a block), past S; one
    # chunk a block (the sequential walk over tiles), two, 32, the plan
    args = _rglru_inputs(6, 300, w, torch.float32, 22)
    args[-1] = torch.tensor([0, 8, 9, 256, 257, 400], dtype=torch.int32, device="cuda")
    want_y, want_h = RG.rglru_scan_torch(*args, out_dtype=torch.float32)
    for chunks in sorted({1, 2, RG.SCAN_MAX_CHUNKS, RG.chunk_plan(6, 300, w, sms)[1]}):
        y, h_last = RG.rglru_scan(*args, chunks=chunks)
        torch.cuda.synchronize()
        name = (f"rglru_scan float32 (6, 300, {w}), {chunks} chunks a block, lengths 0, 8, "
                f"9, 256, 257, 400")
        check_close(f"{name} y", y, want_y, FP32_TOL)
        check_close(f"{name} state at lengths - 1", h_last, want_h, FP32_TOL)
        del y, h_last
    del args, want_y, want_h
    # a width that is not a multiple of a block's 16 channels
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, RGLRU_BF16_TOL)):
        args = _rglru_inputs(3, 77, 100, dtype, 23)
        y, h_last = RG.rglru_scan(*args)
        want_y, want_h = RG.rglru_scan_torch(*args, out_dtype=torch.float32)
        torch.cuda.synchronize()
        name = f"rglru_scan {str(dtype)[6:]} (3, 77, 100)"
        check_close(f"{name} y", y, want_y, tol)
        check_close(f"{name} state at lengths - 1", h_last, want_h, FP32_TOL)
        del args, y, h_last, want_y, want_h
    return dict(name="rglru_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/rglru_scan.cu",
                replaces="src/repro/models/blocks.py:570", library_ms=None,
                **timed[(8, 2048, w)])


def paged_kernel_cases(flush) -> dict:
    """The paged decode kernels against their plain version and against
    the plain version in their own order (``paged_attention_model``) on the
    card, in float32 and bfloat16: positions at page edges, mixed, past Sc,
    rotating writes, the smaller head dims the kernels take, the serving
    shape and the (1, 1024) bucket's shape; which split kernel each head
    dim and dtype ran, from a profiler trace; the two bfloat16 shapes timed
    by CUDA events and by profiler device time. Returns the kernels-line
    entry of the serving shape."""
    sms = sm_count(torch.device("cuda"))

    def check(label, q, k, v, tables, posv, page, sc) -> float:
        got = PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc)
        # float32 copies of the inputs: the kernels compute in float32 and
        # round only their output
        qf, kf, vf = q.float(), k.float(), v.float()
        want = PA.paged_attention_torch(qf, kf, vf, tables, posv, page=page, sc=sc)
        model = PA.paged_attention_model(q, k, v, tables, posv, page=page, sc=sc,
                                         sms=sms)
        torch.cuda.synchronize()
        tol = FP32_TOL if q.dtype == torch.float32 else PAGED_BF16_TOL
        label = f"paged {str(q.dtype)[6:]} {label}"
        err = check_close(label, got, want, tol)
        check_close(f"{label} vs the kernel's order", got, model, tol)
        return err

    def check_case(label, b, hq, hkv, d, page, sc, pos, dtype, seed) -> float:
        return check(label, *_paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, seed), page, sc)

    # -- B=8, Hq=32, Hkv=4, D=128, page 64, Sc=4096 ---------------------------
    b, hq, hkv, d, page, sc = 8, 32, 4, 128, 64, 4096
    pos_cases = {
        "pos=0": [0] * b,
        "pos=page-1": [page - 1] * b,
        "pos=page": [page] * b,
        "pos mixed": [0, 63, 64, 1000, 2047, 3000, 4095, 4103],
        "pos>=Sc": [sc + 7 * i for i in range(b)],
    }
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, PAGED_BF16_TOL)):
        for name, pos in pos_cases.items():
            check_case(name, b, hq, hkv, d, page, sc, pos, dtype, 1)
        # rotating writes: rows past a window of Sc wrap into their own pages
        pos = [sc + 5, sc + 900, 2 * sc - 1, sc + 64, sc + 63, sc, 3 * sc + 17, sc + 2000]
        q, k, v, tables, posv = _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, 2)
        gen = torch.Generator(device="cuda").manual_seed(3)
        for step in range(3):
            kn = torch.randn((b, 1, hkv, d), generator=gen, device="cuda").to(dtype)
            vn = torch.randn((b, 1, hkv, d), generator=gen, device="cuda").to(dtype)
            paged_cache_write(k, v, kn, vn, posv - 2 + step, tables, page, sc, window=sc)
        got = PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc)
        lit = paged_decode_ref(q.float(), k.float(), v.float(), tables, posv, page=page,
                               sc=sc, window=sc)
        torch.cuda.synchronize()
        check("rotating writes", q, k, v, tables, posv, page, sc)
        check_close(f"paged {str(dtype)[6:]} rotating writes vs literal-rule oracle",
                    got, lit, tol)
        del q, k, v, tables, posv, got, lit
        # the smaller head dims the kernels take (yi-6b-smoke has D=32, g=2);
        # bfloat16 at D=40 runs the CUDA-core split kernel, at D=16 and 96
        # the mma kernel's instantiations for a head dim below their widest
        for dd in (16, 32, 40, 64, 96):
            check_case(f"D={dd} g=2 page 16", 2, 4, 2, dd, 16, 64, [5, 70], dtype, 6)
        # the widest groups and head dims (g <= 16, D <= 256; recurrentgemma's
        # g = 10 at D = 256), pages of 4 slots
        check_case("D=256 g=8 page 4", 2, 8, 1, 256, 4, 200, [150, 199], dtype, 6)
        check_case("D=256 g=10 page 4", 2, 10, 1, 256, 4, 200, [150, 199], dtype, 6)
        check_case("D=256 g=16 page 4", 2, 16, 1, 256, 4, 200, [3, 180], dtype, 6)
        check_case("D=128 g=16 page 4", 2, 32, 2, 128, 4, 200, [3, 180], dtype, 6)
    paged_kernel_names(PA)

    # the serving path's shapes: the (8, 2000) request mid-decode in its
    # (8, 2048) bucket, and the (1, 512) request's (1, 1024) bucket
    timed = {}
    for label, b, sc, pos in (("serving shape (B=8, Sc=2048)", 8, 2048,
                               [2000 + 4 * i for i in range(8)]),
                              ("(1, 1024) bucket", 1, 1024, [527])):
        for dtype in (torch.float32, torch.bfloat16):
            inputs = _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, 4)
            err = check(label, *inputs, page, sc)
            if dtype == torch.bfloat16:
                timed[label] = paged_timing(PA, label, inputs, page, sc, err, flush)
            del inputs
    serving = timed["serving shape (B=8, Sc=2048)"]
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_attention.py:130", library_ms=None,
                timed=timed, **serving)


def paged_timing(PA, label, inputs, page, sc, err, flush) -> dict:
    """Event median and profiler device time (L2 flushed) of one paged
    decode call, its plain version's time and its byte bound; fails if the
    trace names another split kernel than ``PA.kernel_name``."""
    q, k, v, tables, posv = inputs
    b, _, hq, d = q.shape
    hkv = k.shape[1]
    ms = cuda_ms(lambda: PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc),
                 flush=flush)
    dev_ms, names = device_ms(
        lambda: PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc),
        "paged_decode", flush)
    plain_ms = cuda_ms(lambda: PA.paged_attention_torch(q, k, v, tables, posv, page=page,
                                                        sc=sc), flush=flush)
    want = PA.kernel_name(d, q.dtype)
    if names and not any(want in n for n in names):
        fail(f"paged {label}: the trace holds {sorted(names)}, not {want}")
    slots = sum(min(int(p) + 1, sc) for p in posv.tolist())
    flops, nbytes = PA.work(q, k, v, tables, posv, page, sc, slots=slots)
    bound, by = _bound_ms(nbytes, flops, q.dtype)
    split = "; ".join(f"{_short(n)} {t:.4f}" for n, t in names.items())
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms ({split})"
    print(f"  paged timing, {label}: kernel {ms:.4f} ms by events, device time {dev} "
          f"({nbytes / (dev_ms or ms) / 1e6:.0f} GB/s); plain {plain_ms:.4f} ms; bound "
          f"{bound:.5f} ms ({by}; {nbytes / 1e6:.1f} MB committed K/V + q/out); "
          f"split plan {PA.split_plan(b, hkv, sc, d, q.dtype, sm_count(q.device))}")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, steps=b * hkv * -(-sc // page))


def paged_kernel_names(PA) -> None:
    """Which split kernel of csrc/paged_decode.cu each head dim and dtype
    ran, read from a profiler trace of three small calls each (a session
    can drop its first device event), traced again, up to
    ``TRACE_ATTEMPTS`` times, while it holds no paged kernel; fails where
    the traced calls ran another than the one the source dispatches to
    (``PA.kernel_name``)."""
    took = []
    for dtype in (torch.bfloat16, torch.float32):
        for d in (32, 40, 64, 128):
            inputs = _paged_inputs(2, 16, 2, d, 16, 256, [200, 100], dtype, 8)
            names = set()
            for _ in range(TRACE_ATTEMPTS):
                names = {_short(n) for n in traced_kernels(
                    lambda: PA.paged_decode_attention(*inputs, page=16, sc=256), calls=3)
                    if _kernel_family(n) == "paged_decode"}
                if names:
                    break
            took.append(f"{str(dtype)[6:]} D={d} -> {', '.join(sorted(names)) or 'not measured'}")
            if names and not any(n.startswith(PA.kernel_name(d, dtype)) for n in names):
                fail(f"paged {str(dtype)[6:]} D={d} ran {names}, not {PA.kernel_name(d, dtype)}")
    print("  paged kernels by head dim (profiler): " + "; ".join(took))


def flash_kernel_names(FA) -> None:
    """Which kernel of csrc/flash_attention.cu each head dim and dtype ran,
    read from a profiler trace of a small call each, one trace per
    configuration (a shared trace's time spans had caught a neighbouring
    call's kernel); fails where a traced call ran another kernel than the
    one the source dispatches to (``FA.kernel_name``)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    took = []
    for dtype in (torch.bfloat16, torch.float32):
        for d in FA.HEAD_DIMS:
            q, k, v = (torch.randn((1, 4, 200, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            names = {m.group(0) for name in traced_kernels(lambda: FA.flash_attention(q, k, v),
                                                           calls=1)
                     for m in [re.search(r"flash_\w+_kernel(<\d+>)?", name)] if m}
            label = f"flash {str(dtype)[6:]} D={d}"
            took.append(f"{str(dtype)[6:]} D={d} -> {', '.join(sorted(names)) or 'not measured'}")
            if names and not any(FA.kernel_name(d, dtype) in n for n in names):
                fail(f"{label} ran {names}, not {FA.kernel_name(d, dtype)}")
    print("  flash kernels by head dim (profiler): " + "; ".join(took))


def traced_kernels(fn, calls: int = 5, flush=None) -> dict:
    """Device milliseconds per call of each kernel that ``fn`` launches,
    by name, from one profiler trace of ``calls`` calls (after a warm-up
    call); empty where the trace holds no device events. ``flush`` (a large
    buffer) is rewritten before each call, as in ``cuda_ms``: its fill
    kernel is in the trace under its own name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            dur = (e.time_range.end - e.time_range.start) / 1e3 / calls
            times[e.name] = times.get(e.name, 0.0) + dur
    return times


def device_ms(fn, family: str, flush, calls: int = 10) -> tuple:
    """(device milliseconds per call or None, {kernel: ms per call}) of the
    kernels of ``family`` (``_kernel_family``) that ``fn`` launches, from a
    profiler trace with the L2 flushed before each call: the kernels' own
    time, without the wrapper's host time that an event median can hold and
    without the flush. None where the trace holds none of them."""
    times = traced_kernels(fn, calls=calls, flush=flush)
    mine = {k: v for k, v in times.items() if _kernel_family(k) == family}
    return (sum(mine.values()) if mine else None), mine


def launch_ms(fn, family: str, flush, calls: int = 10) -> tuple:
    """(device milliseconds per launch or None, launches in the trace) of
    the kernels of ``family`` that ``fn`` launches: the mean over the
    launches the trace holds, so a session that drops events (as noted in
    phase 9) reads low in its count, not in its time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and _kernel_family(e.name) == family]
    return (sum(durs) / len(durs) / 1e3 if durs else None), len(durs)


def _dev(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _short(name: str) -> str:
    """A kernel's demangled name without the anonymous namespace and the
    argument list."""
    name = re.sub(r"\(anonymous namespace\)::|void ", "", name)
    return name.split("(")[0]


def _ssd_inputs(b, s, h, p, n, dtype, seed, strong_decay=False):
    """x, B, C ~ N(0, 1) in ``dtype``; dt softplus'd normals and a the
    model's init (-(1 + 15 u)), both float32; d ones. ``strong_decay``: a =
    -16 and dt mostly in [5.5, 7] with one position in five near 0, so the
    within-chunk cumsum falls below -5,000 while some near-diagonal L
    entries stay near 1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    bm = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    cm = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    if strong_decay:
        u = torch.rand((b, s, h), generator=gen, device="cuda")
        big = 5.5 + 1.5 * torch.rand((b, s, h), generator=gen, device="cuda")
        dt = torch.where(u < 0.8, big, 0.01 * u)
        a = torch.full((h,), -16.0, device="cuda")
    else:
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
        a = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device="cuda"))
    d = torch.ones((h,), device="cuda")
    return x, dt, a, bm, cm, d


def ssd_kernel_cases(flush) -> dict:
    """The SSD scan kernel against its plain version (and the sequential
    oracle) on the card, each case timed; returns the kernels-line entry of
    the serving shape in bfloat16 (the (8, 2000) request's prompt pass)."""
    def run_case(label, args, want, tol) -> dict:
        got = SSD.ssd_scan(*args)
        torch.cuda.synchronize()
        err = check_close(label, got, want, tol)
        del got
        ms = cuda_ms(lambda: SSD.ssd_scan(*args), flush=flush)
        plain_ms = cuda_ms(lambda: SSD.ssd_scan_torch(*args), flush=flush)
        flops, nbytes = SSD.work(*args)
        bound, by = _bound_ms(nbytes, flops, args[0].dtype)
        print(f"    timing: kernel {ms:.4f} ms ({_tflops(flops, ms)}), plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)

    def passes(label, args):
        # one wrapper call launches two kernels: the C B^T pass and the walk
        dev_ms, times = device_ms(lambda: SSD.ssd_scan(*args), "ssd", flush)
        split = "; ".join(f"{_short(k)} {v:.4f} ms" for k, v in times.items())
        print(f"    device time ({label}, profiler, L2 flushed, per call): {_dev(dev_ms)}"
              f"{f' = {split}' if split else ''}")
        if times and not (any("ssd_scan_gram_kernel" in k for k in times)
                          and any("ssd_scan_walk_kernel" in k for k in times)):
            fail(f"ssd {label}: the trace holds {sorted(times)}, not the two passes")
        return dev_ms

    cases = [  # (name, b, s, h, p, n, strong decay)
        ("serving shape (B=8, S=2048)", 8, 2048, 64, 64, 128, False),
        ("B=1 S=1024", 1, 1024, 64, 64, 128, False),
        ("S=16 (chunk 16)", 2, 16, 64, 64, 128, False),
        ("smoke width (2, 32, 16, 16, 16), chunk 32", 2, 32, 16, 16, 16, False),
        ("strong decay (a=-16, dt to 7)", 2, 256, 64, 64, 128, True),
        ("strong decay, smoke width", 2, 128, 16, 16, 16, True),
        ("strong decay, B=4 (whole-P tile in bfloat16)", 4, 256, 64, 64, 128, True),
    ]
    serving = bucket = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, SSD_BF16_TOL)):
        for name, b, s, h, p, n, strong in cases:
            args = _ssd_inputs(b, s, h, p, n, dtype, 7, strong_decay=strong)
            if strong:
                cum = torch.cumsum((args[1] * args[2]).double()[:, :64], dim=1)
                name += f", cum down to {float(cum.min()):.0f}"
            name += f", P tile {SSD._check(*args, min(64, s), sm_count(args[0].device))}"
            # float32 copies of the inputs: the kernel computes in float32
            # and rounds only its output
            want = SSD.ssd_scan_torch(*(t.float() for t in args))
            result = run_case(f"ssd {str(dtype)[6:]} {name}", args, want, tol)
            if dtype == torch.bfloat16 and (b, s) == (8, 2048):
                serving = result
                serving["device_ms"] = passes(f"serving shape, {str(dtype)[6:]}", args)
            del args, want
    # the (1, 1024) bucket's prompt pass (the (1, 512) request), bfloat16,
    # on other seeded inputs than the B=1 S=1024 case above
    args = _ssd_inputs(1, 1024, 64, 64, 128, torch.bfloat16, 11)
    want = SSD.ssd_scan_torch(*(t.float() for t in args))
    bucket = run_case("ssd bfloat16 (1, 1024) bucket, P tile "
                      f"{SSD._check(*args, 64, sm_count(args[0].device))}", args, want,
                      SSD_BF16_TOL)
    bucket["device_ms"] = passes("(1, 1024) bucket, bfloat16", args)
    del args, want
    # the sequential-scan oracle, float32, at both widths
    for b, s, h, p, n in ((2, 128, 64, 64, 128), (2, 64, 16, 16, 16)):
        args = _ssd_inputs(b, s, h, p, n, torch.float32, 8)
        want, _state = ref.ssd_ref(*args)
        run_case(f"ssd float32 ({b}, {s}, {h}, {p}, {n}) vs sequential oracle", args, want,
                 FP32_TOL)
        del args, want
    print(f"  ssd timing at the serving shape, bfloat16: kernel {serving['ms']:.4f} ms by events, "
          f"device time {_dev(serving['device_ms'])}, plain {serving['plain_ms']:.4f} ms, bound "
          f"{serving['bound_ms']:.4f} ms ({serving['bound_by']}); (1, 1024) bucket "
          f"{bucket['ms']:.4f} ms by events, device time {_dev(bucket['device_ms'])}; no "
          "single library call")
    return dict(name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:91", library_ms=None, **serving)


def _bwd_tol(want, dtype, fp32_out):
    """The tolerance of one gradient: SCAN_BWD_FP32 for float32 runs and
    float32 outputs, SCAN_BWD_BF16 else, atol scaled by the reference's
    RMS."""
    tol = SCAN_BWD_FP32 if dtype == torch.float32 or fp32_out else SCAN_BWD_BF16
    rms = float(want.double().pow(2).mean().sqrt())   # float64: strong decay's ~1e-33
    return (tol[0] * rms,) + tol[1:]


def _train_entry(name, source, replaces, fn, plain_fn, work, args, err, flush,
                 plain_reps=3) -> dict:
    """Times one training kernel (events, profiler device time per launch
    with the L2 flushed, the plain version) beside its bound; returns its
    kernels-line entry (no library call computes it)."""
    ms = cuda_ms(fn, flush=flush)
    family = "ssd" if "ssd" in name else "rglru"
    dev_ms, names = device_ms(fn, family, flush)
    _, n_traced = launch_ms(fn, family, flush)
    plain_ms = cuda_ms(plain_fn, reps=plain_reps, warmup=1, flush=flush)
    flops, nbytes = work(*args)
    bound, by = _bound_ms(nbytes, flops, args[0].dtype)
    print(f"  {name} timing, {str(args[0].dtype)[6:]} {tuple(args[0].shape)}: kernel "
          f"{ms:.4f} ms by events, device time {_dev(dev_ms)} a call ("
          f"{', '.join(f'{_short(k)} {v:.4f}' for k, v in names.items()) or 'no events'}; "
          f"{n_traced} kernel launches traced in 10 calls); plain {plain_ms:.3f} ms; bound "
          f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); library: "
          f"none (no single PyTorch call)")
    return dict(name=name, route="cuda", source=source, replaces=replaces, max_abs_err=err,
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


def ssd_train_cases(flush) -> dict:
    """The SSD training forward (``ssd_scan_train``: y bit for bit the
    serving op's, each chunk's starting state against the plain training
    forward's) and the backward kernel (``ssd_scan_bwd``) against the plain
    backward and against autograd through the plain forward, at Mamba-2
    1.3B's training shape and the smoke width, in float32 and bfloat16,
    and under strong decay against the plain backward; both timed at the
    training shape in bfloat16. Returns their kernels-line entries."""
    entries = {}
    b0, s0, h0, p0, n0 = SSD_TRAIN_SHAPE
    cases = [  # (name, (b, s, h, p, n), strong decay, autograd check)
        (f"training shape {SSD_TRAIN_SHAPE}", SSD_TRAIN_SHAPE, False, True),
        ("smoke width (2, 128, 16, 16, 16)", (2, 128, 16, 16, 16), False, True),
        ("S=96 (chunk 32)", (2, 96, 8, 64, 128), False, False),
        ("strong decay (a=-16, dt to 7)", (2, 256, 64, 64, 128), True, False),
        ("strong decay, smoke width", (2, 128, 16, 16, 16), True, False),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, dims, strong, autograd in cases:
            chunk = 32 if dims[1] == 96 else 64
            args = _ssd_inputs(*dims, dtype, 31, strong_decay=strong)
            gen = torch.Generator(device="cuda").manual_seed(32)
            dy = torch.randn(args[0].shape, generator=gen, device="cuda").to(dtype)
            name = f"ssd_train {str(dtype)[6:]} {label}"
            y, states = SSD.ssd_scan_train(*args, chunk=chunk)
            serving = SSD.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            if not torch.equal(y, serving):
                fail(f"{name}: the training forward's y is not the serving op's")
            del serving
            f32 = [t.float() for t in args]
            _, want_states = SSD.ssd_scan_train_torch(*f32, chunk=chunk)
            check_close(f"{name} chunk states", states, want_states, FP32_TOL)
            del want_states
            got = SSD.ssd_scan_bwd(*args, states, dy, chunk=chunk)
            again = SSD.ssd_scan_bwd(*args, states, dy, chunk=chunk)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                fail(f"{name}: two backward calls on the same inputs differ")
            del again
            want = SSD.ssd_scan_bwd_torch(*f32, states, dy.float(), chunk=chunk)
            errs = {gname: check_close(f"{name} {gname} vs the plain backward", g, w,
                                       _bwd_tol(w, dtype, g.dtype == torch.float32))
                    for gname, g, w in zip(("dx", "ddt", "da", "dB", "dC", "dd"), got, want)}
            if autograd:
                leaves = [t.detach().requires_grad_() for t in f32]
                SSD.ssd_scan_torch(*leaves, chunk=chunk).backward(dy.float())
                for gname, g, leaf in zip(("dx", "ddt", "da", "dB", "dC", "dd"), got, leaves):
                    tol = _bwd_tol(leaf.grad, dtype, g.dtype == torch.float32)
                    check_close(f"{name} {gname} vs autograd through the plain forward", g,
                                leaf.grad, tol)
                del leaves
            del got, want, f32
            if dtype == torch.bfloat16 and dims == SSD_TRAIN_SHAPE:
                ferr = check_close(f"{name} y vs the plain forward", y,
                                   SSD.ssd_scan_torch(*(t.float() for t in args)), SSD_BF16_TOL)
                entries["ssd_scan_train"] = _train_entry(
                    "ssd_scan_train", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                    "src/repro/kernels/ssd_scan.py:91", lambda: SSD.ssd_scan_train(*args),
                    lambda: SSD.ssd_scan_train_torch(*args), SSD.work_train, args, ferr, flush)
                entries["ssd_scan_bwd"] = _train_entry(
                    "ssd_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                    "src/repro/kernels/ssd_scan.py:91",
                    lambda: SSD.ssd_scan_bwd(*args, states, dy),
                    lambda: SSD.ssd_scan_bwd_torch(*args, states, dy), SSD.work_bwd,
                    (*args, states, dy), errs["dx"], flush)
            del args, dy, y, states
            torch.cuda.empty_cache()
    return entries


def rglru_train_cases(flush) -> dict:
    """The RG-LRU training forward (``rglru_scan_train``: y bit for bit the
    serving op's, the state entering each chunk of 8 against the plain
    training forward's) and the backward kernel (``rglru_scan_bwd``)
    against the plain backward and against autograd through the plain
    loop, at RecurrentGemma-2B's training shape in float32 and bfloat16,
    under strong and weak decay (a = 1 in float32: the clamp) and at an S
    and a width that the chunks and a block's channels do not divide; both
    timed at the training shape in bfloat16. Returns their kernels-line
    entries."""
    entries = {}
    w0 = RGLRU_TRAIN_SHAPE[2]
    cases = [  # (name, shape, decay, autograd check)
        (f"training shape {RGLRU_TRAIN_SHAPE}", RGLRU_TRAIN_SHAPE, "normal", True),
        ("strong decay", (2, 512, w0), "strong", False),
        ("weak decay (the clamp)", (2, 512, w0), "weak", False),
        ("ragged (3, 1001, 100)", (3, 1001, 100), "normal", True),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, decay, autograd in cases:
            xb, r_pre, i_pre, y_pre, c, _lengths = _rglru_inputs(*shape, dtype, 41, decay)
            args = (xb, r_pre, i_pre, y_pre, c)
            gen = torch.Generator(device="cuda").manual_seed(42)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            name = f"rglru_train {str(dtype)[6:]} {label}"
            y, h_chunks = RG.rglru_scan_train(*args)
            serving, _ = RG.rglru_scan(*args)
            torch.cuda.synchronize()
            if not torch.equal(y, serving):
                fail(f"{name}: the training forward's y is not the serving op's")
            del serving
            f32 = [t.float() for t in args]
            _, want_h = RG.rglru_scan_train_torch(*f32)
            check_close(f"{name} chunk states", h_chunks, want_h, FP32_TOL)
            del want_h
            got = RG.rglru_scan_bwd(*args, h_chunks, dy)
            again = RG.rglru_scan_bwd(*args, h_chunks, dy)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                fail(f"{name}: two backward calls on the same inputs differ")
            del again
            want = RG.rglru_scan_bwd_torch(*f32, h_chunks, dy.float())
            names = ("dxb", "dr_pre", "di_pre", "dy_pre", "dc")
            errs = {gname: check_close(f"{name} {gname} vs the plain backward", g, w,
                                       _bwd_tol(w, dtype, g.dtype == torch.float32))
                    for gname, g, w in zip(names, got, want)}
            if autograd:
                leaves = [t.detach().requires_grad_() for t in f32]
                RG.rglru_scan_torch(*leaves)[0].backward(dy.float())
                for gname, g, leaf in zip(names, got, leaves):
                    tol = _bwd_tol(leaf.grad, dtype, g.dtype == torch.float32)
                    check_close(f"{name} {gname} vs autograd through the plain loop", g,
                                leaf.grad, tol)
                del leaves
            del got, want, f32
            if dtype == torch.bfloat16 and shape == RGLRU_TRAIN_SHAPE:
                ferr = check_close(f"{name} y vs the plain forward", y,
                                   RG.rglru_scan_torch(*args, out_dtype=torch.float32)[0],
                                   RGLRU_BF16_TOL)
                entries["rglru_scan_train"] = _train_entry(
                    "rglru_scan_train", "src/repro_torch/kernels/csrc/rglru_scan.cu",
                    "src/repro/models/blocks.py:570", lambda: RG.rglru_scan_train(*args),
                    lambda: RG.rglru_scan_train_torch(*args), RG.work_train, args, ferr,
                    flush, plain_reps=2)
                entries["rglru_scan_bwd"] = _train_entry(
                    "rglru_scan_bwd", "src/repro_torch/kernels/csrc/rglru_scan.cu",
                    "src/repro/models/blocks.py:570",
                    lambda: RG.rglru_scan_bwd(*args, h_chunks, dy),
                    lambda: RG.rglru_scan_bwd_torch(*args, h_chunks, dy), RG.work_bwd,
                    (*args, h_chunks, dy), errs["dxb"], flush, plain_reps=2)
            del args, dy, y, h_chunks
            torch.cuda.empty_cache()
    return entries


def _gemm_case(label, run, plain, library, want, tol, work, dtype, flush,
               family=None) -> dict:
    """Holds ``run()`` against ``want`` under ``tol`` and times the kernel,
    its plain version and the library call (and, given the kernel's
    ``family``, its profiler device time), its bound from ``work`` (the
    kernel module's count); returns the kernels-line numbers of the case."""
    flops, nbytes = work
    got = run()
    torch.cuda.synchronize()
    err = check_close(label, got, want, tol)
    del got
    ms = cuda_ms(run, flush=flush)
    plain_ms = cuda_ms(plain, flush=flush)
    lib_ms = cuda_ms(library, flush=flush)
    dev_ms = device_ms(run, family, flush)[0] if family else None
    # a float32 product's bound: the CUDA cores' rate or three TF32 products
    bound, by = _bound_ms(nbytes, flops, dtype, tf32x3=True)
    dev = f", device time {_dev(dev_ms)}" if family else ""
    print(f"    timing: kernel {ms:.4f} ms ({_tflops(flops, ms)}){dev}, plain {plain_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms ({_tflops(flops, lib_ms)}), bound {bound:.4f} ms ({by}; "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


def matmul_kernel_cases(flush) -> dict:
    """The matmul kernel against its plain version on the card, in float32
    and bfloat16, at the kernel benchmark's shapes, LeNet's and unaligned
    ones, each timed beside ``torch.matmul`` (cuBLAS, a yardstick only);
    returns the kernels-line entry of LeNet's first affine layer on the
    scoring set."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (name, m, k, n, dtype)
        ("1024^3 (kernel benchmark)", 1024, 1024, 1024, bf16),
        ("1024^3 (kernel benchmark)", 1024, 1024, 1024, f32),
        ("4096^3", 4096, 4096, 4096, bf16),
        ("LeNet affine 1, batch 64", LENET_BATCH, 3136, 512, f32),
        ("LeNet affine 1, scoring set", LENET_SCORE, 3136, 512, f32),
        ("LeNet affine 2, batch 64", LENET_BATCH, 512, 10, f32),
        ("LeNet affine 2, scoring set", LENET_SCORE, 512, 10, f32),
        ("split-K, unaligned (33, 1000) @ (1000, 70)", 33, 1000, 70, f32),
    ] + [(f"unaligned ({m}, {k}) @ ({k}, {n})", m, k, n, dt)
         for m, k, n in ((100, 70, 50), (17, 33, 9), (8, 8, 8)) for dt in (f32, bf16)]
    gen = torch.Generator(device="cuda").manual_seed(9)
    main = None
    for name, m, k, n, dtype in cases:
        # unit-variance outputs, as He-initialised layers give
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(dtype)
        want = MM.matmul_torch(a.float(), b.float())
        tol = FP32_TOL if dtype == f32 else GEMM_BF16_TOL
        result = _gemm_case(
            f"matmul {str(dtype)[6:]} {name}", lambda: MM.matmul(a, b),
            lambda: MM.matmul_torch(a, b), lambda: torch.matmul(a, b), want, tol,
            MM.work(a, b), dtype, flush,
            family="mm_kernel" if (m, k, n) == (LENET_SCORE, 3136, 512) else None)
        if (m, k, n) == (LENET_SCORE, 3136, 512):
            main = result
        del a, b, want
    # which kernel each dtype ran (profiler), at the scoring shape and 1024^3
    for m, k, n, dtype in ((LENET_SCORE, 3136, 512, f32), (1024, 1024, 1024, bf16)):
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        names = [_short(nm) for nm in traced_kernels(lambda: MM.matmul(a, b), calls=1)]
        print(f"  matmul {str(dtype)[6:]} ({m}, {k}) @ ({k}, {n}) ran (profiler): "
              f"{', '.join(names) or 'not measured'}")
        if names and not any(MM.kernel_name(dtype) in nm for nm in names):
            fail(f"matmul {str(dtype)[6:]} ran {names}, not {MM.kernel_name(dtype)}")
        del a, b
    return dict(name="matmul", route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
                replaces="src/repro/kernels/matmul.py:58", **main)


def conv_kernel_cases(flush) -> dict:
    """The conv2d_im2col kernel against its plain version (unfold + product)
    on the card, at the kernel benchmark's shape, LeNet's two convs at the
    training batch and on the scoring set, the kernel tests' shapes (stride 2
    among them) and one bfloat16 case, each timed beside ``F.conv2d``
    (cuDNN, a yardstick only); returns the kernels-line entry of LeNet's
    second conv on the scoring set."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (name, (n, c, h, w), f, k, stride, pad, dtype)
        ("kernel benchmark", (8, 16, 32, 32), 32, 3, 1, 1, f32),
        ("LeNet conv 1, batch 64", (LENET_BATCH, 1, 28, 28), 32, 5, 1, 2, f32),
        ("LeNet conv 2, batch 64", (LENET_BATCH, 32, 14, 14), 64, 5, 1, 2, f32),
        ("LeNet conv 1, scoring set", (LENET_SCORE, 1, 28, 28), 32, 5, 1, 2, f32),
        ("LeNet conv 2, scoring set", (LENET_SCORE, 32, 14, 14), 64, 5, 1, 2, f32),
        ("test shape 1", (2, 3, 8, 8), 4, 3, 1, 1, f32),
        ("test shape 2 (stride 2)", (1, 1, 12, 12), 8, 5, 2, 2, f32),
        ("test shape 3", (3, 4, 16, 16), 16, 3, 1, 0, f32),
        ("test shape 4 (stride 2)", (2, 2, 10, 10), 6, 3, 2, 1, f32),
        ("LeNet conv 2, batch 64", (LENET_BATCH, 32, 14, 14), 64, 5, 1, 2, bf16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(10)
    main = None
    for name, (n, c, h, w), f, k, stride, pad, dtype in cases:
        x = torch.randn((n, c, h, w), generator=gen, device="cuda").to(dtype)
        wt = (torch.randn((f, c, k, k), generator=gen, device="cuda")
              / math.sqrt(c * k * k)).to(dtype)
        want = CONV.conv2d_torch(x.float(), wt.float(), stride=stride, pad=pad)
        tol = FP32_TOL if dtype == f32 else GEMM_BF16_TOL
        result = _gemm_case(
            f"conv2d_im2col {str(dtype)[6:]} {name}: x {(n, c, h, w)}, w {(f, c, k, k)}, "
            f"stride {stride}, pad {pad}",
            lambda: CONV.conv2d_im2col(x, wt, stride=stride, pad=pad),
            lambda: CONV.conv2d_torch(x, wt, stride=stride, pad=pad),
            lambda: F.conv2d(x, wt, stride=stride, padding=pad), want, tol,
            CONV.work(x, wt, stride, pad), dtype, flush,
            family="conv_kernel" if (n, c) == (LENET_SCORE, 32) else None)
        if (n, c) == (LENET_SCORE, 32):
            main = result
        del x, wt, want
    return dict(name="conv2d_im2col", route="cuda",
                source="src/repro_torch/kernels/csrc/conv2d_im2col.cu",
                replaces="src/repro/kernels/conv2d_im2col.py:64", **main)


# ---------------------------------------------------------------------------
# 4. serve-check and 5. serve
# ---------------------------------------------------------------------------


def _eager_kernel(plan) -> str:
    """The decode-attention operator a plan's step runs (the attention-free
    family's "none" reads as the default)."""
    k = plan.config.decode_kernel
    return k if k in ("paged", "ref") else "gather"


def eager_handle(srv, req) -> tuple:
    """``req`` served as ``PlanServer.handle`` serves it (prompt pass,
    handoff write, greedy decoding in the same bucket and pool), but with
    the step of ``make_decode_step`` called eagerly tick by tick, with the
    operator the server's plan chose: no graph, no plan cache. A family
    without a handoff decodes from a zero cache at position 0, from the
    prompt pass's token (``prefill=True``, which is not counted) or from
    token 1. Returns the tokens on the host and the request rows' last
    logits."""
    dev = srv.device
    span = srv.request_span(req)
    b, s = srv.buckets(req.batch, span)
    kernel = _eager_kernel(srv.decode_entry(req.batch, span).plan)
    pool = srv.pool
    handoff = srv.prefill and srv.model.supports_handoff
    arena = pool.acquire(b, s, zero=not handoff, force=True,
                         demand_bytes=pool.member_bytes(s, req.batch, span) if pool.paged
                         else None)
    rows = pool.admit_request_rows(arena, req.batch, prompt=req.context if handoff else 0,
                                   span=span, eager=True)
    rows_t = torch.tensor(rows, device=dev)
    toks = torch.ones((b, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = []
    if srv.prefill:
        lengths = torch.tensor([req.context] * req.batch + [1] * (b - req.batch),
                               dtype=torch.int32, device=dev)
        logits, pkv = srv.model.prefill(
            srv.params, torch.ones((b, s), dtype=torch.int32, device=dev), lengths=lengths)
        first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks[rows_t] = first[:len(rows)]
        if handoff:
            pool.write_rows(arena, rows, pkv, src_rows=range(len(rows)))
            pos[rows_t] = req.context
            out.append(first[:req.batch])
    base = req.context if handoff else 0
    step = make_decode_step(srv.model, page=srv.page_size, seq_len=s, decode_kernel=kernel)
    for t in range(req.new_tokens - len(out)):
        pool.ensure_decode_slots(arena, rows, base + t)
        tables = arena.tables
        logits, _ = (step(srv.params, arena.cache, toks, pos) if tables is None
                     else step(srv.params, arena.cache, toks, pos, tables))
        toks = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        pos = pos + 1
        out.append(toks[rows_t])
    last = logits[:, -1][rows_t].float()
    tokens = torch.cat(out, dim=1).cpu().numpy()
    pool.free_rows(arena, rows)
    pool.release(arena)
    return tokens, last


def check_graphed_against_eager(srv, requests, outs, label: str) -> None:
    """Each served request's token stream (graphed decode through the plan
    cache) byte-identical to the same request decoded eagerly, and its
    final logits within the phase's tolerance."""
    for req, out in zip(requests, outs):
        tokens, last = eager_handle(srv, req)
        if not np.array_equal(tokens, out["tokens"].cpu().numpy()):
            fail(f"{label} {req.batch}x{req.context}: graphed and eager token streams differ")
        if not torch.allclose(out["last_logits"].float(), last, atol=1e-3, rtol=1e-3):
            fail(f"{label} {req.batch}x{req.context}: graphed and eager final logits differ")
    print(f"  {label}: graphed == eager (make_decode_step tick by tick) on "
          f"{len(requests)} requests")


def check_free_while_queued(srv) -> None:
    """A row freed while a later graphed tick is queued: two one-row
    tenants decode from a zero cache in one (2, 128) arena; the stream is
    held busy, tick 3 is queued behind it, and the first tenant's row is
    freed (its host table entries rewritten) before tick 3 has run. Tick 3
    must still read the table as it was: every token up to tick 3, and the
    other tenant's tokens throughout, equal the same ticks run eagerly with
    no row freed."""
    entry = srv.decode_entry(2, 100)
    b, s = entry.key.batch_bucket, entry.key.seq_bucket
    eager_step = make_decode_step(srv.model, page=srv.page_size, seq_len=s,
                                  decode_kernel=_eager_kernel(entry.plan))
    runs, busy = {}, None
    for graphed in (True, False):
        arena = srv.pool.acquire(b, s, zero=True, force=True, demand_bytes=0.0)
        gone = srv.pool.admit_request_rows(arena, 1, prompt=0, span=100, eager=True)
        kept = srv.pool.admit_request_rows(arena, 1, prompt=0, span=100, eager=True)
        if graphed:
            toks, pos = entry.step_fn.buffers(arena)
        else:
            toks = torch.empty((b, 1), dtype=torch.int32, device=srv.device)
            pos = torch.empty((b,), dtype=torch.int32, device=srv.device)
        toks.fill_(1)
        pos.zero_()
        seen = []
        for t in range(6):
            if graphed:
                if t == 3:
                    torch.cuda._sleep(200_000_000)     # ~0.1 s of device time
                entry.step_fn(srv.params, arena, toks, pos)
            else:
                tick(eager_step, srv.params, arena.cache, arena.tables, toks, pos)
            seen.append(toks[:, 0].clone())
            if graphed and t == 3:
                busy = not torch.cuda.current_stream().query()
                srv.pool.free_rows(arena, gone, early=True)
        runs[graphed] = torch.stack(seen, dim=1)[:len(gone) + len(kept)].cpu()
        srv.pool.free_rows(arena, kept if graphed else gone + kept)
        srv.pool.release(arena)
    g, e = runs[True], runs[False]
    print(f"  freed a row while tick 3 was queued (stream busy at the free: {busy}): "
          f"graphed {g.tolist()}, eager {e.tolist()}")
    if not (torch.equal(g[:, :4], e[:, :4]) and torch.equal(g[kept[0]], e[kept[0]])):
        fail("a row freed while a graphed tick was queued changed what that tick read")


def phase_serve_check():
    phase("serve-check: Yi-6B widths, 2 layers, float32: graphed == eager; "
          "paged == gather == ref == auto")
    cfg = get_config("yi-6b").replace(num_layers=2)
    streams, logits = {}, {}
    params = None
    requests = [ServeRequest(batch, ctx, new_tokens=8) for batch, ctx in CHECK_REQUESTS]
    for kernel in ("paged", "gather", "ref", "auto"):
        srv = PlanServer(cfg, config=EngineConfig(dtype="float32", prefill=True,
                                                  page_size=64, decode_kernel=kernel,
                                                  seed=SEED))
        if params is None:
            params = srv.params
        srv.params = params
        PA.paged_decode_attention.launches = 0
        outs = [srv.handle(r) for r in requests]
        chosen = [o["plan"].explain_axes()["decode_kernel"] for o in outs]
        want = cfg.num_layers * sum(o["decode_steps"] for o, k in zip(outs, chosen)
                                    if k == "paged")
        streams[kernel] = [o["tokens"].cpu().numpy() for o in outs]
        logits[kernel] = [o["last_logits"].float() for o in outs]
        print(f"  {kernel}: plans chose {chosen}; {[s.tolist() for s in streams[kernel]]}; "
              f"{PA.paged_decode_attention.launches} paged launches (expected {want})")
        if PA.paged_decode_attention.launches != want:
            fail(f"decode_kernel={kernel}: paged launches "
                 f"{PA.paged_decode_attention.launches} != {want}")
        check_graphed_against_eager(srv, requests, outs, f"decode_kernel={kernel}")
        if kernel == "paged":
            check_free_while_queued(srv)
            engine_trace_check(srv, "decode_kernel=paged")
            router_check(srv, "decode_kernel=paged")
        del srv
    for kernel in ("gather", "ref", "auto"):
        for a, c in zip(streams["paged"], streams[kernel]):
            if not np.array_equal(a, c):
                fail(f"token streams differ between paged and {kernel}")
        for a, c in zip(logits["paged"], logits[kernel]):
            if not torch.allclose(a, c, atol=1e-3, rtol=1e-3):
                fail(f"final logits differ between paged and {kernel}")
    print("  token streams identical across paged, gather, ref and auto")
    del params, logits
    torch.cuda.empty_cache()


def serve_passes(srv, cfg, decode_kernel=None, requests=SERVE_REQUESTS,
                 steady: Optional[list] = None) -> dict:
    """Serves ``requests`` (32 new tokens each) twice through
    ``PlanServer.handle``. The first pass compiles each bucket's plans and
    captures its decode graph (``metrics.compile_seconds`` holds both); the
    second is the steady state: cache hits and one graph replay per tick.
    Each request's tokens and logits are checked, each pass's kernel
    launches held against the layer count, the plans' decode kernels and
    the ticks. Fails where ``decode_kernel`` is given and a plan chose
    another operator. Returns the launches of both passes; the second
    pass's results are appended to ``steady`` where it is given."""
    wrappers = _counted_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    shapes = requests
    total = dict.fromkeys(wrappers, 0)
    for label in ("first pass: plans compiled, decode graphs captured",
                  "second pass: steady state, cache hits and graph replays"):
        requests = [ServeRequest(b, c, new_tokens=32) for b, c in shapes]
        before = {k: fn.launches for k, fn in wrappers.items()}
        m0 = srv.metrics.as_dict()
        outs = [srv.handle(r) for r in requests]
        m1 = srv.metrics.as_dict()
        got = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        chosen = [o["plan"].explain_axes()["decode_kernel"] for o in outs]
        if decode_kernel is not None and set(chosen) != {decode_kernel}:
            fail(f"the plans chose decode kernels {chosen}; every bucket must choose "
                 f"{decode_kernel}")
        want = launches_expected(cfg, len(requests) if srv.prefill else 0, sum(
            o["decode_steps"] for o, k in zip(outs, chosen) if k == "paged"),
            sum(o["decode_steps"] for o in outs))
        print(f"  {label}: compile + capture {m1['compile_seconds'] - m0['compile_seconds']:.3f} s; "
              f"plan cache +{m1['hits'] - m0['hits']} hits, +{m1['compiles'] - m0['compiles']} "
              f"compiles, {m1['recompiles']} recompiles")
        report_requests(cfg, requests, outs)
        print(f"    launches {got} (expected {want})")
        if got != want:
            fail(f"kernel launches {got} != {want}")
        for k in total:
            total[k] += got[k]
    if steady is not None:
        steady.extend(outs)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB held before the passes; the rest arenas, prompt passes "
          f"and the decode graphs' private pools); {srv.summary()}")
    return total


def phase_serve(fit) -> dict:
    cfg = get_config("yi-6b")
    phase(f"serve: {cfg.name}, {cfg.num_layers} layers, bfloat16, page 64, "
          "decode_kernel=auto, one CUDA graph per bucket")
    t0 = time.perf_counter()
    srv = PlanServer(cfg, config=EngineConfig(dtype="bfloat16", prefill=True, page_size=64,
                                              decode_kernel="auto", seed=SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in srv.params.values())
    print(f"  weights: {n_params / 1e9:.2f} B parameters, random from seed {SEED}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
    # the planner's own terms put paged 7x or more below gather at these
    # buckets: a plan that chose gather takes the kernel off the main path
    launches = serve_passes(srv, cfg, decode_kernel="paged")
    trace_decode(srv, [ServeRequest(b, c, new_tokens=32) for b, c in SERVE_REQUESTS])
    planner_on_card(srv, fit)
    analysis_measure(srv, SERVE_REQUESTS)
    del srv
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("flash_attention", "paged_decode_attention")}


def report_requests(cfg, requests, outs) -> None:
    """Checks each served request's tokens and logits and prints its
    bucket, plan's decode kernel, prefill ms, decode ms/step and tokens per
    second."""
    for req, out in zip(requests, outs):
        steps = out["decode_steps"]
        tok = out["tokens"]
        if tuple(tok.shape) != (req.batch, req.new_tokens):
            fail(f"request {req.batch}x{req.context}: tokens {tuple(tok.shape)}")
        if not bool(torch.isfinite(out["last_logits"]).all()):
            fail(f"request {req.batch}x{req.context}: non-finite logits")
        if not bool(((tok >= 0) & (tok < cfg.vocab_size)).all()):
            fail(f"request {req.batch}x{req.context}: token out of the vocabulary")
        dec_ms = out["decode_s"] * 1e3 / max(1, steps)
        print(f"    req {req.batch}x{req.context} -> bucket={out['bucket']} decode kernel "
              f"{out['plan'].explain_axes()['decode_kernel']} | prefill "
              f"{out['prefill_s'] * 1e3:.1f} ms | decode {dec_ms:.2f} ms/step "
              f"({steps} steps, {req.batch * steps / out['decode_s']:.1f} tok/s) | "
              f"total {out['latency_s'] * 1e3:.1f} ms, "
              f"{req.batch * req.new_tokens / out['latency_s']:.1f} tok/s")


def fit_dispatch(paged: dict) -> dict:
    """The H100's paged-dispatch figure from phase 3: the paged kernel's
    profiler device time minus its byte bound, over the (row, kv head, page)
    steps of the shape, at the Yi serving shape and at the (1, 1024) bucket;
    printed beside ``core/cost.py``'s ``PAGED_STEP_LATENCY_S``."""
    fit = {}
    for label, t in paged["timed"].items():
        dev = t["device_ms"] if t["device_ms"] is not None else t["ms"]
        fit[label] = (dev - t["bound_ms"]) * 1e-3 / t["steps"]
        print(f"  paged dispatch fit, {label}: ({dev:.5f} - {t['bound_ms']:.5f}) ms / "
              f"{t['steps']} steps = {fit[label]:.3e} s per step "
              f"({'device time' if t['device_ms'] is not None else 'event median'})")
    print(f"  core/cost.py PAGED_STEP_LATENCY_S = {cost.PAGED_STEP_LATENCY_S:.3e} s")
    return fit


def planner_on_card(srv, fit) -> None:
    """For each serving bucket the planner's analytic decode-attention
    seconds of both operators (``selection_trace``: every attention layer of
    one tick) beside their measured device time at the bucket's shape
    (profiler, L2 flushed before each call, one call times the attention
    layers), mid-decode. Printed, not gated."""
    cfg = srv.cfg
    n_attn = cfg.layer_pattern().count("a")
    hq, hkv, d, g = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.q_per_kv
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    print("  planner on the card (per tick, all attention layers; measured = one call's "
          "device time x layers):")
    for b, c in SERVE_REQUESTS:
        bb, s = srv.buckets(b, c + 32)
        rec = srv.compiler.selection_trace(cfg, InputShape("bucket", s, bb, "decode"))
        q, k, v, tables, posv = _paged_inputs(bb, hq, hkv, d, srv.page_size, s,
                                              [c + 16] * b + [0] * (bb - b),
                                              torch.bfloat16, 12)

        def gather():
            ke, ve = ATT.paged_gather_kv(k, v, tables, srv.page_size, s, pos=posv)
            return ATT.decode_attention(q, ke.repeat_interleave(g, dim=2),
                                        ve.repeat_interleave(g, dim=2), posv)

        measured = {}
        for op, fn in (("paged", lambda: PA.paged_decode_attention(
                q, k, v, tables, posv, page=srv.page_size, sc=s)), ("gather", gather)):
            times = traced_kernels(fn, calls=5, flush=flush)
            ms = sum(t for name, t in times.items() if "FillFunctor<unsigned char>" not in name)
            measured[op] = ms * n_attn if times else None
        fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa: E731
        print(f"    bucket ({bb}, {s}): planner paged_s {rec['paged_s'] * 1e3:.4f} ms, gather_s "
              f"{rec['gather_s'] * 1e3:.4f} ms -> {rec['kernel']}; measured paged "
              f"{fmt(measured['paged'])}, gather {fmt(measured['gather'])}")
        del q, k, v, tables, posv
    print(f"  fitted dispatch figures: {', '.join(f'{k} {v:.3e} s' for k, v in fit.items())}")
    del flush


# ---------------------------------------------------------------------------
# the serving engine: the 2-layer traces of phases 4 and 6, and serve-engine
# ---------------------------------------------------------------------------


def _first_new(stream) -> int:
    """Index of the first token that did not occur earlier (past the first),
    else 0: where an EOS set to that token ends the stream."""
    return next((i for i, t in enumerate(stream) if i and t not in stream[:i]), 0)


def _first_new_pair(stream) -> int:
    """Index of the last token of the first adjacent pair that did not occur
    earlier (past the first pair), else 1: where a stop sequence set to that
    pair ends the stream."""
    pairs = list(zip(stream, stream[1:]))
    return next((i + 1 for i, p in enumerate(pairs) if i and p not in pairs[:i]), 1)


def _engine_case(solo, role) -> tuple:
    """For a request whose stream alone is ``solo`` (batch, n): the
    ``ServeRequest`` keywords of its role, the stream the engine must give
    (a prefix of ``solo`` where the role ends it early) and the finish
    reason."""
    s = solo[0].tolist()
    if role == "eos":
        i = _first_new(s)
        return {"eos_id": s[i]}, solo[:, :i + 1], "eos"
    if role == "stop":
        j = _first_new_pair(s)
        return {"stop": ((s[j - 1], s[j]),)}, solo[:, :j + 1], "stop"
    if role == "cancel":
        return {}, solo[:, :CANCEL_AFTER], "cancelled"
    return {}, solo, "length"


def _counted_wrappers() -> dict:
    """The kernel wrappers on the serving path, by name."""
    return {"flash_attention": FA.flash_attention, "flash_decode": FA.flash_decode,
            "paged_decode_attention": PA.paged_decode_attention, "ssd_scan": SSD.ssd_scan,
            "rglru_scan": RG.rglru_scan}


def launches_expected(cfg, prefills: int, paged_ticks: int, ticks: int = 0) -> dict:
    """Each serving kernel's launches for ``prefills`` prompt passes and
    ``paged_ticks`` decode ticks whose plan chose the paged kernel, of
    ``ticks`` in all: flash, the SSD scan and the RG-LRU scan once per layer
    of their kind and prompt pass, paged decode once per attention layer
    and paged tick; an encoder-decoder's cross attention is the one-row
    ``flash_decode`` once per decoder layer and tick."""
    pattern = cfg.layer_pattern()
    n_attn = pattern.count("a")
    cross = cfg.num_layers * ticks if cfg.is_encdec else 0
    return {"flash_attention": n_attn * prefills, "flash_decode": cross,
            "paged_decode_attention": n_attn * paged_ticks,
            "ssd_scan": pattern.count("s") * prefills,
            "rglru_scan": pattern.count("r") * prefills}


def engine_launches_expected(srv, ticks: int, prefills: int, bucket) -> dict:
    """:func:`launches_expected` of an engine trace: ``ticks`` group decode
    ticks in ``bucket``, counted where the bucket's plan chose paged."""
    paged = srv.decode_entry(*bucket).plan.explain_axes()["decode_kernel"] == "paged"
    return launches_expected(srv.cfg, prefills, ticks if paged else 0)


def engine_trace_check(srv, label: str) -> None:
    """One step-driven trace through ``ServingEngine`` with the sanitizer
    on: seven requests fill an (8, 256) group at ``max_group_batch`` 8; three
    more arrive, each once the group has rows free for it, and join into
    rows that members with fewer new tokens, a cancel (after
    ``CANCEL_AFTER`` tokens), an EOS exit and a stop-sequence exit free.
    Each request's stream must be byte-identical to the same request alone
    through ``PlanServer.handle`` (a prefix of it, up to the stop, for the
    cancel and the early exits); the
    launches exact (flash and SSD per layer and prompt pass, paged decode per
    attention layer and group tick); at least two joins; and at the end every
    page leased has been freed and the pool holds no bytes."""
    solo = [srv.handle(ServeRequest(b, c, new_tokens=n))["tokens"].cpu().numpy()
            for b, c, n, _ in ENGINE_CHECK_TRACE]
    reqs, want = [], []
    for (b, c, n, role), s in zip(ENGINE_CHECK_TRACE, solo):
        kw, tokens, reason = _engine_case(s, role)
        reqs.append(ServeRequest(b, c, new_tokens=n, **kw))
        want.append((tokens, reason))
    cancel_rid = next(r.rid for r, t in zip(reqs, ENGINE_CHECK_TRACE) if t[3] == "cancel")
    eng = ServingEngine(srv, config=replace(srv.config, sanitize=True, max_group_batch=8))
    wrappers = _counted_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    handoffs = srv.pool.metrics.handoff_writes
    handles = [eng.submit(r) for r in reqs[:ENGINE_CHECK_GROUP]]
    late = reqs[ENGINE_CHECK_GROUP:]
    while late or not eng.idle:
        for ev in eng.step():
            if ev.rid == cancel_rid and ev.token is not None and ev.index + 1 >= CANCEL_AFTER:
                eng.cancel(eng.handles[ev.rid])
        # a late request arrives once the group has rows free for it, so the
        # next step's join phase seats it there (before a new group forms)
        while late and (not eng.active or eng.active[0].arena.rows_free >= late[0].batch):
            handles.append(eng.submit(late.pop(0)))
    got = {k: fn.launches for k, fn in wrappers.items()}
    prefills = srv.pool.metrics.handoff_writes - handoffs
    bucket = handles[0].result["bucket"]
    expected = engine_launches_expected(srv, eng.decode_ticks, prefills, bucket)
    recs = [h.result for h in handles]
    print(f"  {label}: engine trace, {len(reqs)} requests, bucket {bucket}: "
          f"{[(r['finish_reason'], r['joined_at_step'], r['tokens'].shape[1]) for r in recs]}; "
          f"{eng.metrics.joins} joins, {eng.decode_ticks} ticks, {prefills} prompt passes; "
          f"launches {got} (expected {expected})")
    for req, rec, (tokens, reason) in zip(reqs, recs, want):
        shape = f"{req.batch}x{req.context}+{req.new_tokens}"
        if rec["finish_reason"] != reason:
            fail(f"{label} engine trace {shape}: finished {rec['finish_reason']!r}, "
                 f"expected {reason!r}")
        if not np.array_equal(rec["tokens"].cpu().numpy(), tokens):
            fail(f"{label} engine trace {shape}: stream {rec['tokens'].tolist()} is not the "
                 f"request's stream alone through handle {tokens.tolist()}")
    if got != expected:
        fail(f"{label} engine trace: launches {got} != {expected}")
    joined = [r for r in recs[ENGINE_CHECK_GROUP:] if r["joined_at_step"] > 0
              and r["bucket"] == bucket]
    if eng.metrics.joins < 2 or len(joined) < 2:
        fail(f"{label} engine trace: {eng.metrics.joins} joins ({len(joined)} mid-decode)")
    pm = srv.pool.metrics
    if pm.pages_leased != pm.pages_freed or srv.pool.live_bytes() != 0:
        fail(f"{label} engine trace: pages leased {pm.pages_leased}, freed {pm.pages_freed}, "
             f"live bytes {srv.pool.live_bytes()}")
    print(f"  {label}: engine streams == each request alone through handle (prefixes for "
          f"the cancel, EOS and stop exits); sanitizer clean; pages leased == freed "
          f"({pm.pages_leased}), live bytes 0")


def _shared_weights(a, b) -> bool:
    """Whether two servers hold the same weight tensors (one copy)."""
    return a.params.keys() == b.params.keys() and all(
        a.params[k].data_ptr() == b.params[k].data_ptr() for k in a.params)


def _twin(srv):
    """A second ``PlanServer`` of ``srv``'s model and configuration that
    takes ``srv``'s weight tensors (its own random ones are freed)."""
    twin = PlanServer(srv.cfg, config=srv.config, device=srv.device)
    twin.params = srv.params
    return twin


def router_launches_expected(router, prefills: dict, bucket) -> dict:
    """:func:`engine_launches_expected` summed over the router's replicas:
    each replica's group ticks and prompt passes (``prefills`` by replica)."""
    total = {}
    for r in router.replicas:
        want = engine_launches_expected(r.server, r.engine.decode_ticks, prefills[r.idx], bucket)
        for k, n in want.items():
            total[k] = total.get(k, 0) + n
    return total


def run_router(router, arrivals, drain_after=None, cancel=None) -> dict:
    """``router.run`` over ``arrivals`` with the launch counts set to 0 just
    before and read just after. ``drain_after``: drain replica 1 at the
    first token event of index ``drain_after`` or more of a request placed
    there; ``cancel``: the rid cancelled after ``CANCEL_AFTER`` tokens.
    Returns the records by rid, each rid's streamed tokens and indices, the
    decision count at the drain, the drained handles, the prompt passes by
    replica, the launches and the wall seconds."""
    streams, indices, drained = {}, {}, {}
    handoffs = {r.idx: r.server.pool.metrics.handoff_writes for r in router.replicas}

    def on_event(ev):
        if ev.token is None:
            return
        streams.setdefault(ev.rid, []).append(ev.token.cpu().numpy())
        indices.setdefault(ev.rid, []).append(ev.index)
        h = router.handles.get(ev.rid)
        if (drain_after is not None and not drained and ev.index >= drain_after
                and h is not None and h.replica.idx == 1):
            drained["moved"] = router.drain_replica(1)
            drained["at"] = len(router.decisions)
        if ev.rid == cancel and ev.index + 1 >= CANCEL_AFTER and h is not None:
            router.cancel(h)

    wrappers = _counted_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    router.run(arrivals, on_event=on_event)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    return {"recs": {r["rid"]: r for r in router.results}, "seconds": seconds,
            "streams": {rid: np.concatenate(t, axis=1) for rid, t in streams.items()},
            "indices": indices, "drained": drained, "launches": launches,
            "prefills": {r.idx: r.server.pool.metrics.handoff_writes - handoffs[r.idx]
                         for r in router.replicas}}


def check_router_run(run, router, rids, label: str) -> None:
    """Gates of a router run: one record per request, every stream gapless
    (indices 0, 1, ... once each) and equal to its record's tokens, and
    after a drain: requests resubmitted, none placed on replica 1."""
    if sorted(run["recs"]) != sorted(rids) or router.handles:
        fail(f"{label}: {len(run['recs'])} records for {len(rids)} requests, "
             f"{len(router.handles)} handles left")
    for rid in rids:
        rec = run["recs"][rid]["tokens"].cpu().numpy()
        got = run["streams"].get(rid, rec[:, :0])
        if run["indices"].get(rid, []) != list(range(rec.shape[1])):
            fail(f"{label}: rid {rid} streamed indices {run['indices'].get(rid)}")
        if not np.array_equal(got, rec):
            fail(f"{label}: rid {rid} streamed {got.tolist()} but its record holds "
                 f"{rec.tolist()}")
    if run["drained"]:
        moved = run["drained"]["moved"]
        late = router.decisions[run["drained"]["at"] - len(moved):]
        if not moved or router.router_metrics.resubmitted != len(moved):
            fail(f"{label}: the drain moved {len(moved)} requests")
        if any(d.replica == 1 for d in late):
            fail(f"{label}: the drained replica took a placement after the drain")


def router_check(srv, label: str) -> None:
    """The router over ``srv`` and a twin holding its weight tensors, with
    the sanitizer on: the reference's failover trace, replica 1 drained
    after a token of index ``ROUTER_DRAIN_AT`` or more while it holds live
    work. Gates: zero loss, requests resubmitted, gapless streams each
    byte-identical to the request alone through ``handle``, no placement on
    the drained replica, flash and paged launches equal to the sum over the
    replicas' prompt passes and group ticks."""
    solo = [srv.handle(ServeRequest(1, c, new_tokens=n))["tokens"].cpu().numpy()
            for c, n in ROUTER_CHECK_TRACE]
    twin = _twin(srv)
    if not _shared_weights(srv, twin):
        fail(f"{label} router: the twin replica does not share the weight tensors")
    router = EngineRouter([srv, twin], config=replace(srv.config, sanitize=True, replicas=2,
                                                      max_group_batch=8))
    reqs = [ServeRequest(1, c, new_tokens=n) for c, n in ROUTER_CHECK_TRACE]
    run = run_router(router, simulate_arrivals(reqs, ROUTER_RATE, seed=ROUTER_SEED),
                     drain_after=ROUTER_DRAIN_AT)
    check_router_run(run, router, [r.rid for r in reqs], f"{label} router")
    if not run["drained"]:
        fail(f"{label} router: replica 1 held no live work at a token of index "
             f">= {ROUTER_DRAIN_AT}")
    for req, want in zip(reqs, solo):
        if not np.array_equal(run["streams"][req.rid], want):
            fail(f"{label} router: rid {req.rid} 1x{req.context} streamed "
                 f"{run['streams'][req.rid].tolist()}, alone through handle {want.tolist()}")
    expected = router_launches_expected(router, run["prefills"], (1, 64))
    got = {k: run["launches"][k] for k in expected}
    rm = router.router_metrics
    print(f"  {label}: router over 2 replicas (shared weights), {len(reqs)} requests at "
          f"{ROUTER_RATE:.0f}/s: placements {dict(sorted(rm.placements.items()))}, drained "
          f"replica 1 resubmitting {[h.rid - reqs[0].rid for h in run['drained']['moved']]}; "
          f"ticks {[r.engine.decode_ticks for r in router.replicas]}, prompt passes "
          f"{run['prefills']}; launches {got} (expected {expected})")
    if got != expected:
        fail(f"{label} router: launches {got} != {expected}")
    print(f"  {label}: router: zero loss, streams gapless and == each request alone through "
          f"handle, no placement on the drained replica, sanitizer clean")
    del router, twin


def serve_engine_trace():
    """The serve-engine phase's requests: ``ENGINE_REQUESTS`` batch-1
    (context, new_tokens) pairs from ``SEED``, every span in (1024, 2048]."""
    rng = np.random.default_rng(SEED)
    ctx = rng.integers(ENGINE_CONTEXTS[0], ENGINE_CONTEXTS[1] + 1, ENGINE_REQUESTS)
    new = rng.integers(ENGINE_NEW_TOKENS[0], ENGINE_NEW_TOKENS[1] + 1, ENGINE_REQUESTS)
    return [(int(c), int(n)) for c, n in zip(ctx, new)]


def log_prompt_passes(engine, log: dict) -> None:
    """Observe ``engine``'s admissions: append, by rid, the (batch, seq)
    bucket of each prompt pass that admits the request (a group's start or
    a join; a request moved by failover gets one per admission)."""
    admit = engine._admit_members

    def logged(group, queued, join_step, now):
        bucket = engine.server.buckets(sum(qr.req.batch for qr in queued),
                                       max(engine.server.request_span(qr.req) for qr in queued))
        for qr in queued:
            log.setdefault(qr.rid, []).append(bucket)
        return admit(group, queued, join_step, now)

    engine._admit_members = logged


def replay_engine_trace(srv, specs, eos: int) -> dict:
    """One closed burst of ``specs`` through ``ContinuousBatchingScheduler``
    (sanitizer on, ``max_group_batch`` 8): request ``ENGINE_EOS`` stops at
    ``eos``, request ``ENGINE_CANCEL`` is cancelled through ``on_event``
    after ``CANCEL_AFTER`` tokens. Launch counts are set to 0 just before
    the run and read just after it."""
    reqs = [ServeRequest(1, c, new_tokens=n, eos_id=eos if i == ENGINE_EOS else None)
            for i, (c, n) in enumerate(specs)]
    index = {r.rid: i for i, r in enumerate(reqs)}
    sched = ContinuousBatchingScheduler(
        srv, config=replace(srv.config, sanitize=True, max_group_batch=8))
    eng = sched.engine
    ttft, prompts = {}, {}
    log_prompt_passes(eng, prompts)

    def on_event(ev):
        if ev.token is None:
            return
        if ev.index == 0:
            ttft[index[ev.rid]] = ev.t
        if index[ev.rid] == ENGINE_CANCEL and ev.index + 1 >= CANCEL_AFTER:
            eng.cancel(eng.handles[ev.rid])

    wrappers = _counted_wrappers()
    pm = srv.pool.metrics
    handoffs, reclaimed = pm.handoff_writes, pm.pages_reclaimed
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run(simulate_arrivals(reqs), on_event=on_event)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    recs = {index[r["rid"]]: r for r in sched.results}
    return {"sched": sched, "recs": recs, "ttft": ttft, "seconds": seconds,
            "prompts": {index[rid]: b for rid, b in prompts.items()},
            "launches": launches, "ticks": eng.decode_ticks,
            "prefills": pm.handoff_writes - handoffs,
            "reclaimed": pm.pages_reclaimed - reclaimed,
            "tokens": sum(r["tokens"].shape[1] for r in recs.values())}


def phase_serve_engine(srv=None) -> dict:
    """Full Yi-6B (phase 5's configuration and weights, one pool arena: one
    batch of 8 rows, as a card serving one model holds it) through
    ``ContinuousBatchingScheduler``: a closed burst of ``ENGINE_REQUESTS``
    batch-1 requests forms one (8, 2048) group and joins the rest into rows
    its members free; one request is cancelled, one stops at EOS. Gates: the
    expected finish reasons, the EOS stream a prefix of the same request
    alone through handle, a second replay byte-identical, at least 4 joins
    and pages reclaimed, the sanitizer clean, launches exact. Printed: per
    request TTFT, queue and exec time; the scheduler summary; engine ms per
    tick and one traced tick's device busy time and idle share; aggregate
    output tok/s beside the same requests one by one through
    ``PlanServer.handle``; graphs held and peak memory. ``srv`` replaces the
    phase's server (the CPU rehearsal passes a small one). Returns the
    server, both replays, the EOS token and the sequential tok/s, for the
    serve-router phase."""
    specs = serve_engine_trace()
    cfg = srv.cfg if srv is not None else get_config("yi-6b")
    config = srv.config if srv is not None else EngineConfig(
        dtype="bfloat16", prefill=True, page_size=64, decode_kernel="auto", seed=SEED,
        pool_max_arenas=1)
    phase(f"serve-engine: {cfg.name}, {cfg.num_layers} layers, {config.dtype}, page "
          f"{config.page_size}, decode_kernel={config.decode_kernel}, pool_max_arenas="
          f"{config.pool_max_arenas}, {len(specs)} requests through ContinuousBatchingScheduler")
    if srv is None:
        t0 = time.perf_counter()
        srv = PlanServer(cfg, config=config)
        srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
        print(f"  weights random from seed {SEED} (phase 5's), server built and warmed up in "
              f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    # the same requests one by one through handle: the sequential baseline
    # and each request's stream alone; one short request first compiles the
    # (1, 2048) plans and captures that bucket's graph
    srv.handle(ServeRequest(1, ENGINE_CONTEXTS[0], new_tokens=2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = [srv.handle(ServeRequest(1, c, new_tokens=n))["tokens"].cpu().numpy()
            for c, n in specs]
    seq_s = time.perf_counter() - t0
    seq_tokens = sum(n for _, n in specs)
    eos = int(solo[ENGINE_EOS][0, 5])
    runs = [replay_engine_trace(srv, specs, eos) for _ in range(2)]
    run = runs[0]
    recs = run["recs"]
    expected = engine_launches_expected(srv, run["ticks"], run["prefills"], (8, 2048))
    print(f"  trace: {len(specs)} x batch 1, (context, new tokens) {specs}; request "
          f"{ENGINE_CANCEL} cancelled after {CANCEL_AFTER} tokens, request {ENGINE_EOS} "
          f"stops at eos {eos} (its 6th token alone)")
    for i, (c, n) in enumerate(specs):
        r = recs[i]
        same = np.array_equal(r["tokens"].cpu().numpy(), solo[i][:, :r["tokens"].shape[1]])
        print(f"    req {i} 1x{c}+{n}: bucket={r['bucket']} joined@{r['joined_at_step']} "
              f"{r['finish_reason']} {r['tokens'].shape[1]} tokens | TTFT "
              f"{run['ttft'][i] * 1e3:.1f} ms, queue {r['queue_s'] * 1e3:.1f} ms, exec "
              f"{r['exec_s'] * 1e3:.1f} ms | stream {'==' if same else '!='} alone (prefix)")
    print("  " + run["sched"].summary().replace("\n", "\n  "))
    m = run["sched"].metrics
    print(f"  engine: {run['ticks']} group ticks, {run['prefills']} prompt passes in "
          f"{run['seconds'] * 1e3:.1f} ms ({run['seconds'] * 1e3 / run['ticks']:.2f} ms per tick "
          f"with the prompt passes, inter-token p50 {m.itl_latency.percentile(50) * 1e3:.2f} ms "
          f"/ mean {m.itl_latency.mean() * 1e3:.2f} ms); launches {run['launches']} (expected "
          f"{expected}); second replay {runs[1]['seconds'] * 1e3:.1f} ms")
    rates = [r["tokens"] / r["seconds"] for r in runs]
    print(f"  aggregate output: engine {run['tokens']} tokens, {rates[0]:.1f} tok/s in the "
          f"first replay (the group's graph captured in it), {rates[1]:.1f} tok/s in the "
          f"second; sequential through handle {seq_tokens} tokens in {seq_s:.3f} s = "
          f"{seq_tokens / seq_s:.1f} tok/s; ratio (second replay) "
          f"{rates[1] / (seq_tokens / seq_s):.2f}")
    reasons = ["cancelled" if i == ENGINE_CANCEL else "eos" if i == ENGINE_EOS else "length"
               for i in range(len(specs))]
    got = [recs[i]["finish_reason"] for i in range(len(specs))]
    if got != reasons:
        fail(f"serve-engine: finish reasons {got} != {reasons}")
    s = solo[ENGINE_EOS][0].tolist()
    if recs[ENGINE_EOS]["tokens"][0].tolist() != s[:s.index(eos) + 1]:
        fail(f"serve-engine: the EOS stream {recs[ENGINE_EOS]['tokens'][0].tolist()} is not "
             f"the prefix of the request alone {s[:s.index(eos) + 1]}")
    for i in range(len(specs)):
        if not torch.equal(recs[i]["tokens"], runs[1]["recs"][i]["tokens"]):
            fail(f"serve-engine: request {i}'s stream differs between two replays")
    if m.joins < 4 or run["reclaimed"] <= 0:
        fail(f"serve-engine: {m.joins} joins, {run['reclaimed']} pages reclaimed")
    for r in runs:
        if r["launches"] != engine_launches_expected(srv, r["ticks"], r["prefills"], (8, 2048)):
            fail(f"serve-engine: launches {r['launches']} != {expected}")
    print("  reasons as expected; EOS stream == its prefix alone; second replay "
          "byte-identical; sanitizer clean; launches exact")

    # the group's first 8 requests with the sanitizer off: four steps timed
    # after the step that formed the group, then four traced
    eng = ServingEngine(srv)
    for c, n in specs[:8]:
        eng.submit(ServeRequest(1, c, new_tokens=n))
    eng.step()
    steps = 4
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    print(f"  engine tick (8, 2048), 8 live rows, sanitizer off, untraced: "
          f"{(time.perf_counter() - t0) * 1e3 / steps:.2f} ms per step (each ends in a "
          f"device sync)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(ENGINE_STEP_SPAN):
            for _ in range(steps):
                eng.step()
    eng.drain()
    span_report(prof.events(), ENGINE_STEP_SPAN, steps, "traced engine ticks (8, 2048)")
    print(f"  decode graphs held {srv.decode_graphs()}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del eng, run, recs
    return {"srv": srv, "runs": runs, "eos": eos, "seq_rate": seq_tokens / seq_s}


def _mem() -> str:
    return (f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")


def first_difference(a, b) -> int:
    """Index of the first token where two (1, n) streams differ over their
    common length, else -1."""
    n = min(a.shape[1], b.shape[1])
    diff = np.nonzero(a[0, :n] != b[0, :n])[0]
    return int(diff[0]) if diff.size else -1


def phase_serve_router(engine_out: dict) -> None:
    """The serve-engine phase's server as replica 0 and a second
    ``PlanServer`` that takes its weight tensors as replica 1, behind
    ``EngineRouter`` (affinity placement, ``max_group_batch`` 8, one arena a
    pool, sanitizer on). The serve-engine trace runs twice as a closed
    burst: undisturbed, then with replica 1 drained once its first member
    has streamed its 2nd token. Gates: 12 records a run, gapless streams,
    the trace's finish reasons, launches exact over both replicas, the
    replicas' weights at the same addresses, requests resubmitted and none
    placed on the drained replica. Printed: placements by reason; per
    replica admitted, completed, joins and its device clock; aggregate
    output tok/s by wall time on this card beside the single engine's; the
    fleet's tok/s by virtual device time (the replicas' clocks: what two
    cards would give); device memory before replica 1, after its weights
    were swapped, after its warm-up and after the first run; and how many
    bfloat16 streams equal the single engine's replay and the undisturbed
    run, with the first differing index and both runs' prompt-pass buckets
    where one differs."""
    srv, eos = engine_out["srv"], engine_out["eos"]
    specs = serve_engine_trace()
    config = replace(srv.config, sanitize=True, max_group_batch=8, replicas=2,
                     placement="affinity")
    phase(f"serve-router: {srv.cfg.name}, {srv.cfg.num_layers} layers, {config.dtype}, two "
          f"replicas on one card sharing one copy of the weights, placement "
          f"{config.placement}, {len(specs)} requests twice (undisturbed, then replica 1 "
          f"drained)")
    torch.cuda.synchronize()
    memory = [("before replica 1", _mem())]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    twin = _twin(srv)
    torch.cuda.synchronize()
    memory.append((f"replica 1 built and its weights swapped for replica 0's "
                   f"({time.perf_counter() - t0:.3f} s; peak allocated during the build "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: its own random "
                   f"weights, freed at the swap)", _mem()))
    if not _shared_weights(srv, twin):
        fail("serve-router: the replicas' weight tensors are not the same")
    # the warm-up every server gets, and the (1, 2048) plans and graph, as
    # replica 0 holds them from the serve-engine phase
    twin.handle(ServeRequest(1, 16, new_tokens=2))
    twin.handle(ServeRequest(1, ENGINE_CONTEXTS[0], new_tokens=2))
    torch.cuda.synchronize()
    memory.append(("replica 1 warmed up (its (1, 2048) arena and graph)", _mem()))
    index = {}
    runs = []
    for drain in (False, True):
        router = EngineRouter([srv, twin], config=config)
        prompts = {}
        for r in router.replicas:
            log_prompt_passes(r.engine, prompts)
        reqs = [ServeRequest(1, c, new_tokens=n, eos_id=eos if i == ENGINE_EOS else None)
                for i, (c, n) in enumerate(specs)]
        index.update({r.rid: i for i, r in enumerate(reqs)})
        run = run_router(router, simulate_arrivals(reqs),
                         drain_after=1 if drain else None, cancel=reqs[ENGINE_CANCEL].rid)
        label = "drained run" if drain else "undisturbed run"
        check_router_run(run, router, [r.rid for r in reqs], f"serve-router {label}")
        if drain and not run["drained"]:
            fail("serve-router: replica 1 streamed no 2nd token")
        run.update(label=label, router=router, tokens=sum(
            rec["tokens"].shape[1] for rec in run["recs"].values()),
            prompts={index[rid]: b for rid, b in prompts.items()},
            by_index={index[rid]: rec for rid, rec in run["recs"].items()})
        runs.append(run)
        if not drain:
            torch.cuda.synchronize()
            memory.append(("after the undisturbed run (replica 1's (8, 2048) arena and graph)",
                           _mem()))
    for run in runs:
        router = run["router"]
        rm = router.router_metrics
        reasons = [run["by_index"][i]["finish_reason"] for i in range(len(specs))]
        want = ["cancelled" if i == ENGINE_CANCEL else "eos" if i == ENGINE_EOS else "length"
                for i in range(len(specs))]
        expected = router_launches_expected(router, run["prefills"], (8, 2048))
        got = {k: run["launches"][k] for k in expected}
        device_t = max(r.clock.now() for r in router.replicas)
        moved = sorted(index[h.rid] for h in run["drained"].get("moved", []))
        print(f"  {run['label']}: placements {dict(sorted(rm.placements.items()))}"
              + (f", replica 1 drained, requests {moved} resubmitted" if moved else ""))
        for r in router.replicas:
            m = r.engine.metrics
            print(f"    replica[{r.idx}]{' DRAINING' if r.draining else ''}: admitted "
                  f"{m.admitted}, completed {m.completed}, joins {m.joins}, group ticks "
                  f"{r.engine.decode_ticks}, prompt passes {run['prefills'][r.idx]}, device_t "
                  f"{r.clock.now():.4f} s")
        print(f"    {run['tokens']} tokens in {run['seconds']:.4f} s wall = "
              f"{run['tokens'] / run['seconds']:.1f} tok/s on this one card; fleet "
              f"{run['tokens'] / device_t:.1f} tok/s by the replicas' virtual device time "
              f"({device_t:.4f} s: what two cards would give, not this card's figure); "
              f"finish reasons {reasons}; launches {got} (expected {expected})")
        if reasons != want:
            fail(f"serve-router {run['label']}: finish reasons {reasons} != {want}")
        if got != expected:
            fail(f"serve-router {run['label']}: launches {got} != {expected}")
    single = engine_out["runs"]
    rates = [r["tokens"] / r["seconds"] for r in single]
    print(f"  one engine, same trace, same call (serve-engine phase): {rates[0]:.1f} tok/s "
          f"(first replay), {rates[1]:.1f} (second); one by one through handle "
          f"{engine_out['seq_rate']:.1f} tok/s")
    for mark, mem in memory:
        print(f"  memory {mark}: {mem}")
    # bfloat16: a prompt pass re-run at another batch bucket may round
    # differently, so equality is counted here (gated in float32, phase 4)
    for run in runs:
        for ref_label, ref_recs, ref_prompts in (
                ("the single engine's replay", single[1]["recs"], single[1]["prompts"]),
                ("the undisturbed run", runs[0]["by_index"], runs[0]["prompts"])):
            if run is runs[0] and ref_recs is runs[0]["by_index"]:
                continue
            same, differ = 0, []
            for i in range(len(specs)):
                a = run["by_index"][i]["tokens"].cpu().numpy()
                b = ref_recs[i]["tokens"].cpu().numpy()
                at = first_difference(a, b)
                if at < 0 and a.shape == b.shape:
                    same += 1
                else:
                    differ.append(f"request {i} from index {at} (prompt passes "
                                  f"{run['prompts'].get(i)} vs {ref_prompts.get(i)})")
            print(f"  {run['label']}: {same} of {len(specs)} streams == {ref_label}"
                  + (f"; differing: {'; '.join(differ)}" if differ else ""))
    print(f"  decode graphs held: replica 0 {srv.decode_graphs()}, replica 1 "
          f"{twin.decode_graphs()}; zero loss, gapless streams, finish reasons, launches and "
          f"shared weights as gated; sanitizer clean")
    engine_out.clear()
    del srv, twin, runs, run, router
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 6. serve-check-ssm and 7. serve-ssm
# ---------------------------------------------------------------------------


def phase_serve_check_ssm():
    phase("serve-check-ssm: Mamba-2 1.3B widths, 2 layers, float32: SSD kernel == plain, "
          "graphed == eager, auto == paged")
    cfg = get_config("mamba2-1.3b").replace(num_layers=2)
    srv = PlanServer(cfg, config=EngineConfig(dtype="float32", prefill=True, page_size=64,
                                              seed=SEED))
    requests = [ServeRequest(batch, ctx, new_tokens=8) for batch, ctx in CHECK_REQUESTS]
    streams, logits = {}, {}
    for backend in ("auto", "torch"):
        ops.BACKEND = backend
        launches0 = SSD.ssd_scan.launches
        outs = [srv.handle(r) for r in requests]
        streams[backend] = [o["tokens"].cpu().numpy() for o in outs]
        logits[backend] = [o["last_logits"].float() for o in outs]
        launched = SSD.ssd_scan.launches - launches0
        print(f"  {backend}: {[s.tolist() for s in streams[backend]]} "
              f"({launched} ssd_scan launches)")
        if launched != (cfg.num_layers * len(CHECK_REQUESTS) if backend == "auto" else 0):
            fail(f"ops.BACKEND={backend!r}: {launched} ssd_scan launches")
        if backend == "auto":
            check_graphed_against_eager(srv, requests, outs, "Mamba-2, decode_kernel=auto")
    ops.BACKEND = "auto"
    for a, c in zip(streams["auto"], streams["torch"]):
        if not np.array_equal(a, c):
            fail("token streams differ between the SSD kernel and its plain version")
    engine_trace_check(srv, "Mamba-2 2 layers, SSD kernel")
    for a, c in zip(logits["auto"], logits["torch"]):
        if not torch.allclose(a, c, atol=1e-3, rtol=1e-3):
            fail("final logits differ between the SSD kernel and its plain version")
    print("  token streams identical with the kernel and with its plain version")
    paged = PlanServer(cfg, config=EngineConfig(dtype="float32", prefill=True, page_size=64,
                                                decode_kernel="paged", seed=SEED))
    paged.params = srv.params
    for req, a in zip(requests, streams["auto"]):
        if not np.array_equal(paged.handle(req)["tokens"].cpu().numpy(), a):
            fail("token streams differ between decode_kernel=auto and paged")
    print("  token streams identical under decode_kernel=auto and paged")
    del paged

    # handle() prompts with all ones, which this tied-embedding model at
    # random weights echoes; random prompts at mixed lengths hold the kernel
    # inside the model: prefill logits and handed-off state, kernel vs plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 320), generator=gen, device="cuda",
                           dtype=torch.int32)
    lens = torch.tensor([300, 177], dtype=torch.int32, device="cuda")
    pre = {}
    for backend in ("auto", "torch"):
        ops.BACKEND = backend
        pre[backend] = srv.model.prefill(srv.params, tokens, lengths=lens)
    ops.BACKEND = "auto"
    for name, a, c in (("logits", pre["auto"][0], pre["torch"][0]),
                       ("state", pre["auto"][1]["l.state"], pre["torch"][1]["l.state"])):
        diff, rms = float((a - c).abs().max()), float(c.pow(2).mean().sqrt())
        print(f"  random prompts (300, 177): prefill {name} kernel vs plain, max abs "
              f"difference {diff:.3e} (RMS {rms:.3f})")
        if not torch.allclose(a, c, atol=1e-3, rtol=1e-3):
            fail(f"prefill {name} differ between the SSD kernel and its plain version")
    del pre

    # handoff: a prefill of T tokens then one decode step on token T equals
    # the last logits of a prefill of the T + 1 tokens (rows padded to 320)
    t = 300
    full = torch.full((2,), t, dtype=torch.int32, device="cuda")
    _, cache = srv.model.prefill(srv.params, tokens, lengths=full)
    step, _ = srv.model.decode_step(srv.params, cache, tokens[:, t:t + 1], full)
    want, _ = srv.model.prefill(srv.params, tokens, lengths=full + 1)
    err = float((step[:, -1] - want).abs().max())
    rms = float(want.pow(2).mean().sqrt())
    print(f"  handoff: decode after a {t}-token prefill vs a {t + 1}-token prefill, "
          f"max abs logit difference {err:.3e} (logit RMS {rms:.3f})")
    if not torch.allclose(step[:, -1], want, atol=1e-3, rtol=1e-3):
        fail("prefill -> decode handoff disagrees with the longer prefill")
    del srv, cache, logits
    torch.cuda.empty_cache()


def phase_serve_ssm():
    cfg = get_config("mamba2-1.3b")
    phase(f"serve-ssm: {cfg.name}, {cfg.num_layers} layers, bfloat16, page 64, SSD kernel, "
          "decode_kernel=auto, one CUDA graph per bucket")
    t0 = time.perf_counter()
    srv = PlanServer(cfg, config=EngineConfig(dtype="bfloat16", prefill=True, page_size=64,
                                              decode_kernel="auto", seed=SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in srv.params.values())
    print(f"  weights: {n_params / 1e9:.2f} B parameters, random from seed {SEED}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
    launches = serve_passes(srv, cfg)
    print(f"  pool peak {srv.pool.metrics.peak_bytes / 2**20:.1f} MiB of recurrent state")
    trace_decode(srv, [ServeRequest(b, c, new_tokens=32) for b, c in SERVE_REQUESTS])
    analysis_measure(srv, SERVE_REQUESTS)
    del srv
    torch.cuda.empty_cache()
    return {"ssd_scan": launches["ssd_scan"]}


# ---------------------------------------------------------------------------
# 10. serve-check-hybrid and 11. serve-hybrid
# ---------------------------------------------------------------------------


def phase_serve_check_hybrid():
    phase("serve-check-hybrid: RecurrentGemma-2B widths, 3 layers (rra), float32, window "
          "2048: graphed == eager; paged == gather == ref == auto; handoff == longer prefill")
    cfg = get_config("recurrentgemma-2b").replace(num_layers=3)
    requests = [ServeRequest(batch, ctx, new_tokens=8) for batch, ctx in HYBRID_CHECK_REQUESTS]
    wrappers = _counted_wrappers()
    streams, logits, params, model = {}, {}, None, None
    for kernel in ("paged", "gather", "ref", "auto"):
        srv = PlanServer(cfg, config=EngineConfig(dtype="float32", prefill=True,
                                                  page_size=64, decode_kernel=kernel,
                                                  seed=SEED))
        if params is None:
            params, model = srv.params, srv.model
        srv.params = params
        for fn in wrappers.values():
            fn.launches = 0
        outs = [srv.handle(r) for r in requests]
        got = {k: fn.launches for k, fn in wrappers.items()}
        chosen = [o["plan"].explain_axes()["decode_kernel"] for o in outs]
        want = launches_expected(cfg, len(requests), sum(
            o["decode_steps"] for o, k in zip(outs, chosen) if k == "paged"))
        streams[kernel] = [o["tokens"].cpu().numpy() for o in outs]
        logits[kernel] = [o["last_logits"].float() for o in outs]
        print(f"  {kernel}: buckets {[o['bucket'] for o in outs]}, plans chose {chosen}; "
              f"{[t.tolist() for t in streams[kernel]]}; launches {got} (expected {want})")
        if got != want:
            fail(f"hybrid decode_kernel={kernel}: launches {got} != {want}")
        if kernel == "auto" and set(chosen) != {"paged"}:
            fail(f"hybrid decode_kernel=auto: the plans chose {chosen}, not paged")
        check_graphed_against_eager(srv, requests, outs, f"hybrid decode_kernel={kernel}")
        if kernel == "paged":
            engine_trace_check(srv, "RecurrentGemma 3 layers, decode_kernel=paged")
        del srv
    for kernel in ("gather", "ref", "auto"):
        for a, c in zip(streams["paged"], streams[kernel]):
            if not np.array_equal(a, c):
                fail(f"hybrid token streams differ between paged and {kernel}")
        for a, c in zip(logits["paged"], logits[kernel]):
            if not torch.allclose(a, c, atol=1e-3, rtol=1e-3):
                fail(f"hybrid final logits differ between paged and {kernel}")
    print("  token streams identical across paged, gather, ref and auto")

    # handoff past the window: a prefill of T tokens then one decode step
    # (the rotating dense cache) on token T equals the last logits of a
    # prefill of T + 1 tokens, with random prompts at T = 2100 and 1500
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2200), generator=gen, device="cuda",
                           dtype=torch.int32)
    lens = torch.tensor([2100, 1500], dtype=torch.int32, device="cuda")
    _, cache = model.prefill(params, tokens, lengths=lens)
    nxt = tokens[torch.arange(2, device="cuda"), lens.long()][:, None]
    step, _ = model.decode_step(params, cache, nxt, lens)
    want, _ = model.prefill(params, tokens, lengths=lens + 1)
    err = float((step[:, -1] - want).abs().max())
    rms = float(want.pow(2).mean().sqrt())
    print(f"  handoff: decode after prefills of (2100, 1500) tokens vs prefills one token "
          f"longer, max abs logit difference {err:.3e} (logit RMS {rms:.3f})")
    if not torch.allclose(step[:, -1], want, atol=1e-3, rtol=1e-3):
        fail("hybrid prefill -> decode handoff disagrees with the longer prefill")
    del params, model, cache, logits
    torch.cuda.empty_cache()


def phase_serve_hybrid() -> dict:
    cfg = get_config("recurrentgemma-2b")
    phase(f"serve-hybrid: {cfg.name}, {cfg.num_layers} layers ({cfg.block_pattern}), "
          f"bfloat16, window {cfg.window_size}, page 64, decode_kernel=auto, one CUDA graph "
          "per bucket")
    t0 = time.perf_counter()
    srv = PlanServer(cfg, config=EngineConfig(dtype="bfloat16", prefill=True, page_size=64,
                                              decode_kernel="auto", seed=SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in srv.params.values())
    print(f"  weights: {n_params / 1e9:.2f} B parameters, random from seed {SEED}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
    launches = serve_passes(srv, cfg, decode_kernel="paged", requests=HYBRID_SERVE_REQUESTS)
    print(f"  pool peak {srv.pool.metrics.peak_bytes / 2**20:.1f} MiB (paged K/V of the "
          f"attention layers and the RG-LRU state)")
    trace_decode(srv, [ServeRequest(b, c, new_tokens=32) for b, c in HYBRID_SERVE_REQUESTS])
    analysis_measure(srv, HYBRID_SERVE_REQUESTS)
    del srv
    torch.cuda.empty_cache()
    return {"flash_attention_d256": launches["flash_attention"],
            "paged_decode_attention_g10_d256": launches["paged_decode_attention"],
            "rglru_scan": launches["rglru_scan"]}


# ---------------------------------------------------------------------------
# 8. lenet-check and 9. lenet
# ---------------------------------------------------------------------------


def check_step(name, got, want) -> None:
    """Holds one tensor of LeNet's training step, kernels against plain
    versions, under ``LENET_STEP_TOL``."""
    max_tol, rms_tol = LENET_STEP_TOL
    want = want.float()
    err = (got.float() - want).abs()
    max_ratio = float(err.max()) / max(float(want.abs().max()), 1e-30)
    rms_ratio = float(err.pow(2).mean().sqrt()) / max(float(want.pow(2).mean().sqrt()), 1e-30)
    ok = max_ratio <= max_tol and rms_ratio <= rms_tol and bool(torch.isfinite(got).all())
    print(f"  {name}: max_err/ref_max={max_ratio:.3e} err_rms/ref_rms={rms_ratio:.3e} "
          f"tol({max_tol:g}, {rms_tol:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: the kernels' training step disagrees with the plain versions'")


def phase_lenet_check() -> None:
    phase(f"lenet-check: LeNet 1x28x28, 10 classes, float32, batch {LENET_BATCH}, "
          "kernels == plain")
    module = Sequential(*make_spec())
    params = module.init(torch.Generator().manual_seed(SEED), device="cuda")
    xs, ys = synthetic_images(LENET_BATCH, num_classes=10, size=28, seed=SEED + 2)
    x, y = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    xent = LOSS.cross_entropy_loss
    runs = {}
    for backend in ("auto", "torch"):
        ops.BACKEND = backend
        CONV.conv2d_im2col.launches = MM.matmul.launches = 0
        probs = module.predict(params, x)
        forward = (CONV.conv2d_im2col.launches, MM.matmul.launches)
        # the same dropout masks in both runs
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        out, caches = module.forward(params, x, mode="train", generator=gen)
        _, grads = module.backward(params, caches, xent.backward(out, y))
        gen.manual_seed(SEED + 3)
        opt_state = module.init_opt_state("sgd_momentum", params)
        new_params, _, loss = module.make_train_step("sgd_momentum", 0.01)(
            params, opt_state, x, y, gen, t=1)
        total = (CONV.conv2d_im2col.launches, MM.matmul.launches)
        runs[backend] = dict(probs=probs, loss=loss, grads=grads, new=new_params,
                             loss_fwd=xent.forward(out, y))
        print(f"  ops.BACKEND={backend!r}: test-mode forward launched conv2d_im2col "
              f"{forward[0]}, matmul {forward[1]}; with a train forward and a train step "
              f"{total[0]}, {total[1]}; loss {float(loss):.6f}")
        per_forward = (2, 2) if backend == "auto" else (0, 0)
        if forward != per_forward or total != (3 * per_forward[0], 3 * per_forward[1]):
            fail(f"ops.BACKEND={backend!r}: launches {forward}, {total}; expected "
                 f"{per_forward} per forward")
    ops.BACKEND = "auto"
    kern, plain = runs["auto"], runs["torch"]
    check_close("test-mode forward (class probabilities), kernels vs plain", kern["probs"],
                plain["probs"], FP32_TOL)
    for key in ("loss_fwd", "loss"):
        a, b = float(kern[key]), float(plain[key])
        print(f"  {key}: kernels {a:.7f}, plain {b:.7f}")
        if not abs(a - b) <= 1e-5 * abs(b):
            fail(f"{key} differs between the kernels' and the plain versions' step")
    for i, li in enumerate(module.layers):
        for j, part in enumerate(("w", "b")[:len(kern["grads"][i])]):
            check_step(f"layer {i} {li.kind} d{part}", kern["grads"][i][j], plain["grads"][i][j])
            check_step(f"layer {i} {li.kind} updated {part}", kern["new"][i][j],
                       plain["new"][i][j])
    del runs, kern, plain
    torch.cuda.empty_cache()


def phase_lenet() -> tuple:
    """LeNet trained and scored: (the kernels' launches, the trained weights
    as numpy arrays, which the parfor phase scores with)."""
    phase(f"lenet: Keras2Plan trains LeNet (1x28x28, 10 classes, float32) for one epoch of "
          f"{LENET_TRAIN} images at batch {LENET_BATCH}, scores {LENET_SCORE}")
    spec, meta = make_spec()
    x, y = synthetic_images(LENET_TRAIN, num_classes=10, size=28, seed=SEED)
    xt, yt = synthetic_images(LENET_SCORE, num_classes=10, size=28, seed=SEED + 1)
    kw = dict(optimizer="sgd_momentum", lr=0.01, batch_size=LENET_BATCH, epochs=1, seed=SEED)
    warm = Keras2Plan(spec, meta, **kw).fit(x[:4 * LENET_BATCH], y[:4 * LENET_BATCH])
    warm.predict_proba(xt[:LENET_BATCH])          # warm-up: cuBLAS, allocator
    del warm
    est = Keras2Plan(spec, meta, **kw)
    torch.cuda.synchronize()

    CONV.conv2d_im2col.launches = MM.matmul.launches = 0
    t0 = time.perf_counter()
    est.fit(x, y)                                 # ends reading the loss history
    fit_s = time.perf_counter() - t0
    weights = [[t.detach().cpu().numpy() for t in layer] for layer in est.params]
    t0 = time.perf_counter()
    probs = est.predict_proba(xt)                 # ends copying to the host
    score_s = time.perf_counter() - t0
    launches = {"conv2d_im2col": CONV.conv2d_im2col.launches, "matmul": MM.matmul.launches}

    steps = LENET_TRAIN // LENET_BATCH
    calls = steps + 1                             # forwards: one per step, one scoring pass
    want = {"conv2d_im2col": 2 * calls, "matmul": 2 * calls}
    acc = float(np.mean(probs.argmax(axis=1) == yt.argmax(axis=1)))
    print(f"  trained {steps} steps in {fit_s * 1e3:.1f} ms ({fit_s * 1e3 / steps:.3f} ms/step, "
          f"{LENET_TRAIN / fit_s:.0f} images/s); loss {est.history[0]:.4f} -> "
          f"{est.history[-1]:.4f}")
    print(f"  scored {LENET_SCORE} images in {score_s * 1e3:.1f} ms "
          f"({LENET_SCORE / score_s:.0f} images/s); test accuracy {acc:.4f}")
    print(f"  launches {launches} (expected 2 conv + 2 matmul layers x {calls} forwards = "
          f"{want})")
    if launches != want:
        fail(f"kernel launches {launches} != {want}")
    if probs.shape != (LENET_SCORE, 10) or not np.isfinite(probs).all():
        fail(f"scores: shape {probs.shape}, all finite {np.isfinite(probs).all()}")
    if not np.allclose(probs.sum(axis=1), 1.0, atol=1e-4):
        fail("class probabilities do not sum to 1")
    if not np.isfinite(est.history).all() or not est.history[-1] < est.history[0]:
        fail(f"training loss {est.history[0]} -> {est.history[-1]}")
    if not acc > 0.6:
        fail(f"test accuracy {acc:.4f} is not above 0.6")

    # per-step latency: more steps from the trained weights, each synchronised
    step = est.module.make_train_step(est.optimizer, est.lr)
    params, state = est.params, est.opt_state
    xb = torch.from_numpy(x[:LENET_BATCH]).cuda()
    yb = torch.from_numpy(y[:LENET_BATCH]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = []
    for t in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _ = step(params, state, xb, yb, gen, t=steps + 1 + t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"  train step (batch {LENET_BATCH}, synchronised): median "
          f"{statistics.median(times):.3f} ms over {len(times)} steps")

    print("  trace (torch.profiler, one train step and one scoring pass again):")
    for span, label, fn in (
            ("lenet.train_step", f"train step, batch {LENET_BATCH}",
             lambda: step(params, state, xb, yb, gen, t=steps + 21)),
            ("lenet.score", f"scoring pass, {LENET_SCORE} images",
             lambda: est.predict_proba(xt))):
        # after the serving phases' traces, the profiler dropped the first
        # device events of a new session (most of a scoring pass, a train
        # step's conv launches): each session runs the pass once unspanned,
        # then once inside the span, which must hold the forward's 2 conv
        # and 2 or more matmul kernel launches
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(TRACE_SLACK_S)
                fn()
                torch.cuda.synchronize()
                with record_function(span):
                    fn()
                    torch.cuda.synchronize()
            events = prof.events()
            lo, hi = next((e.time_range.start, e.time_range.end) for e in events
                          if e.name == span and e.device_type == DeviceType.CPU)
            found = {fam: sum(1 for e in events if _kernel_family(e.name) == fam
                              and lo <= e.time_range.start < hi)
                     for fam in ("conv_kernel", "mm_kernel")}
            if found["conv_kernel"] >= 2 and found["mm_kernel"] >= 2:
                span_report(events, span, 1, label)
                break
            print(f"    {label}: trace {attempt} incomplete (kernel events in the span "
                  f"{found}; the forward launches 2 conv and 2 or more matmul kernels)")
        else:
            print(f"    {label}: not measured (no complete trace in {TRACE_ATTEMPTS} tries)")
    del est, params, state
    torch.cuda.empty_cache()
    return launches, weights


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _kernel_family(name: str) -> str:
    low = name.lower()
    if any(k in name for k in ("paged_mma_kernel", "paged_split_kernel",
                                "paged_combine_kernel")):
        return "paged_decode"
    if "ssd_scan" in name:
        return "ssd"
    if "rglru_scan" in name:
        return "rglru"
    if "flash_bwd" in name:
        return "flash_bwd"
    if "flash_" in name:
        return "flash"
    if "repro_mm_" in name:
        return "mm_kernel"
    if "repro_conv_" in name:
        return "conv_kernel"
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def trace_decode(srv, requests) -> None:
    """Device time under ``torch.profiler``: each request served once more,
    in its own bucket, with as few new tokens as that allows (at least
    ``TRACE_NEW_TOKENS``).
    ``PlanServer.handle`` names its prefill and decode phases as spans that
    end after the device has finished them; a phase's device time is the
    union of the device events that start inside its span, its idle share
    the rest of the span.

    The replayed graphs' launches are held against the device: the decode
    span's device-side annotation must hold one paged split-kernel event
    per attention layer and tick where the plan chose paged, none
    elsewhere. A trace that misses
    (a session can drop device events) is taken again, up to
    ``TRACE_ATTEMPTS`` times; the phase fails if none holds that count."""
    n_attn = srv.cfg.layer_pattern().count("a")
    print("  trace (torch.profiler, each request served once more in its bucket, "
          f"with at least {TRACE_NEW_TOKENS} new tokens):")
    for full in requests:
        bucket = srv.buckets(full.batch, srv.request_span(full))
        n = next(n for n in range(TRACE_NEW_TOKENS, full.new_tokens + 1)
                 if srv.buckets(full.batch, full.context + n) == bucket)
        req = ServeRequest(full.batch, full.context, new_tokens=n)
        shape = f"{req.batch}x{req.context}"
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = srv.handle(req)
            events = prof.events()
            steps = out["decode_steps"]
            paged = out["plan"].explain_axes()["decode_kernel"] == "paged"
            want = n_attn * steps if paged else 0
            got, in_host = paged_split_events(events, DECODE_SPAN)
            if got == want:
                break
            print(f"    req {shape}: trace {attempt} holds {got} paged split-kernel events "
                  f"in the decode span's device annotation, expected {want}")
        else:
            fail(f"req {shape}: no trace in {TRACE_ATTEMPTS} held {want} paged "
                 f"split-kernel launches ({n_attn} attention layers x {steps} ticks)")
        for span, n in ((PREFILL_SPAN, 1), (DECODE_SPAN, steps)):
            span_report(events, span, n,
                        f"req {shape} bucket={out['bucket']} {span.split('.')[1]}")
        print(f"    req {shape}: {got / steps:.0f} paged split-kernel events per tick "
              f"on the device ({n_attn} attention layers); {in_host} of the {got} start "
              "inside the decode span on the host clock")


def paged_split_events(events, span: str):
    """The paged decode split-kernel events (one per wrapper call; the
    combine kernel left out) inside the device-side annotation of the CPU
    span ``span`` (the kernels launched inside it, on the device's clock),
    and, for the record, how many of them start inside the CPU span itself;
    (None, None) where the trace holds no such span. Only the first
    count is held: over a 24-tick decode the device timestamps of the last
    kernels can land past the span's end on the host clock, though the
    span ends after the device has finished them."""
    found = _annotated(events, span)
    host = [e.time_range for e in events if e.name == span and e.device_type == DeviceType.CPU]
    if not found or not host:
        return None, None
    lo, hi = min(a for a, _ in found), max(b for _, b in found)
    starts = [e.time_range.start for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and lo <= e.time_range.start <= hi
              and ("paged_mma_kernel" in e.name or "paged_split_kernel" in e.name)]
    return len(starts), sum(1 for t in starts if host[0].start <= t < host[0].end)


def span_report(events, span: str, n: int, label: str) -> None:
    """Prints the device's time inside the CPU span ``span`` of a
    ``torch.profiler`` trace, per each of its ``n`` steps: the span, the
    union of the device events that start inside it (busy), the idle
    share, and device time by kernel kind and by kernel."""
    found = [e.time_range for e in events if e.name == span and e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation and e.name != span]
    if not found or not dev:
        print(f"    {label}: not measured ({len(found)} spans, {len(dev)} device events in "
              f"the trace)")
        return
    lo, hi = found[0].start, found[0].end
    inside = [e for e in dev if lo <= e.time_range.start < hi]
    busy = _busy_us((e.time_range.start, min(e.time_range.end, hi)) for e in inside)
    fam, names = {}, {}
    for e in inside:
        dur = e.time_range.end - e.time_range.start
        key = _kernel_family(e.name)
        fam[key] = fam.get(key, 0.0) + dur
        names[e.name] = names.get(e.name, 0.0) + dur
    by_kind = ", ".join(f"{k} {v / n / 1e3:.3f}"
                        for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
    top = "; ".join(f"{k[:48]} {v / n / 1e3:.3f}"
                    for k, v in sorted(names.items(), key=lambda kv: -kv[1])[:3])
    unit = "ms" if n == 1 else f"ms/step over {n} steps"
    print(f"    {label}: span {(hi - lo) / n / 1e3:.3f} {unit}, device busy "
          f"{busy / n / 1e3:.3f}, idle share {1 - busy / (hi - lo):.3f}, "
          f"{len(inside) / n:.0f} device events; device time by kind: {by_kind}; "
          f"top kernels: {top}")


# ---------------------------------------------------------------------------
# analysis: the plan, memory and cost audits at full width and on the smoke
# matrix, traced on fake CUDA tensors; measured peaks on the card
# ---------------------------------------------------------------------------


def analysis_measure(srv, requests) -> None:
    """One eager decode tick and one prompt pass per bucket of ``requests``
    on ``srv`` (phases 5, 7 and 11 call this after their passes, outside
    their launch counts): the measured peak, the plan's estimate and the
    cache leaves' ``data_ptr`` across the tick, kept for the analysis
    phase, which holds them against the traced floors."""
    spans = {srv.buckets(b, srv.request_span(ServeRequest(b, c, new_tokens=SERVE_NEW_TOKENS)))
             for b, c in requests}
    for batch, span in sorted(spans):
        for measure in (memory_audit.measure_decode, memory_audit.measure_prefill):
            ANALYSIS_MEASURED.append(measure(srv, batch, span))
    torch.cuda.empty_cache()


def cublas_workspace_bytes() -> int:
    """The bytes cuBLAS's workspace takes from the caching allocator: the
    growth beyond its output of the first product after the workspaces are
    cleared (the analysis phase runs last, with no graph left to replay)."""
    a = torch.ones((256, 256), device="cuda")
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = a @ a
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before - out.nbytes
    del a, out
    return grown


def phase_analysis() -> None:
    """The analysis layer on the card's path. Full width (phases 5, 7 and
    11's cells, bfloat16, page 64, the servers' pool of 4 arenas and
    ``decode_kernel="auto"``): each cell's step traced once on fake CUDA
    tensors (no weights), the plan audit's and the cost audit's findings,
    the kernel nodes, and the measured peaks phases 5, 7 and 11 took held
    against the traced floor and the plan's estimate. Then the smoke matrix:
    the three audits traced with their self-tests, the decision audits and
    the trace closure, and each smoke arch served in both dtypes with one
    tick's and one prompt pass's peak measured. Any finding or missed
    self-test fails."""
    phase("analysis: plan, memory and cost audits on fake CUDA tensors at full width and on "
          "the smoke matrix; measured peaks against the traced floor and the estimate")
    t0 = time.perf_counter()
    findings = []
    floors = {}
    kernel_nodes = {}
    for arch, requests in ANALYSIS_MODELS:
        buckets = sorted({(bucket(b, 1), bucket(c + SERVE_NEW_TOKENS, 16))
                          for b, c in requests})
        for b, s in buckets:
            for kind in ("decode", "prefill"):
                where = plan_audit.cell_where(arch, "bfloat16", kind, b, s)
                _cfg, model, plan, _ = plan_audit.compile_cell(arch, "bfloat16", kind, b, s)
                trace = plan_audit.trace_cell(model, plan, kind, b, s)
                rec, found = plan_audit.audit_cell(arch, "bfloat16", kind, b, s, trace=trace)
                cost_rec, cost_found = cost_audit.audit_cell(arch, "bfloat16", kind, b, s,
                                                             trace=trace)
                floors[where] = rec["memory"]["floor_bytes"]
                for k, n in rec["kernel_nodes"].items():
                    kernel_nodes[k] = kernel_nodes.get(k, 0) + n
                print(f"  {where}: {rec['nodes']} nodes, kernels {rec['kernel_nodes']}, "
                      f"plan {rec['decode_kernel']}; memory floor "
                      f"{rec['memory']['floor_bytes'] / 2**30:.3f} <= estimate "
                      f"{rec['memory']['estimate_bytes'] / 2**30:.3f} <= ceiling "
                      f"{rec['memory']['ceiling_bytes'] / 2**30:.3f} GiB; "
                      f"{cost_audit.cost_line(cost_rec)}; "
                      f"{len(found) + len(cost_found)} finding(s)")
                findings += found + cost_found
    print(f"  kernel nodes over the full-width cells: {kernel_nodes} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not ANALYSIS_MEASURED:
        fail("analysis: phases 5, 7 and 11 measured no peak")
    print("  measured peaks (full width, phases 5, 7 and 11's servers):")
    for rec, found in ANALYSIS_MEASURED:
        found = found + memory_audit.hold_measured(rec, floors[rec["where"]])
        print(f"    {memory_audit.measured_line(rec)}, cache data_ptr moved: "
              f"{rec['cache_moved'] or 'none'}"
              f"{'' if not found else ' — ' + '; '.join(str(f) for f in found)}")
        findings += found

    t1 = time.perf_counter()
    smoke = {}
    for name, audit in (("plan", plan_audit), ("memory", memory_audit), ("cost", cost_audit)):
        cells, found = audit.run_audit()
        probes = audit.selftest()
        smoke[name] = (len(cells), len(found), probes)
        findings += found
        missed = [k for k, ok in probes.items() if not ok]
        print(f"  smoke {name} audit: {len(cells)} cells, {len(found)} finding(s), self-test "
              f"{'ok' if not missed else 'MISSED ' + ', '.join(missed)}")
        if missed:
            fail(f"analysis: the {name} audit's self-test missed {missed}")
    _, found = cost_audit.audit_decisions()
    closure, closure_found = cost_audit.trace_closure_certificate()
    findings += found + closure_found
    print(f"  decision audits: {len(found)} finding(s); trace closure {closure['signatures']} "
          f"signatures (bound {closure['bound']}) ({time.perf_counter() - t1:.1f} s)")
    servers = [(PlanServer(get_config(arch), config=EngineConfig(dtype=dtype, prefill=True,
                                                                  seed=SEED)),
                analysis_matrix.SMOKE_BUCKETS)
               for arch in analysis_matrix.SMOKE_ARCHS for dtype in analysis_matrix.SMOKE_DTYPES]
    print("  measured peaks (smoke matrix):")
    _, found = memory_audit.measure_servers(servers, log=lambda line: print(f"  {line}"))
    findings += found
    del servers
    torch.cuda.empty_cache()
    ws = cublas_workspace_bytes()
    print(f"  cuBLAS workspace: {ws / 2**20:.2f} MiB (the audits' ceiling counts "
          f"{plan_audit.CUBLAS_WORKSPACE_BYTES / 2**20:.2f} MiB)")
    if ws > plan_audit.CUBLAS_WORKSPACE_BYTES:
        fail(f"cuBLAS's workspace {ws} B exceeds the ceiling's "
             f"{plan_audit.CUBLAS_WORKSPACE_BYTES} B")
    for f in findings:
        print(f"  FINDING {f}")
    if findings:
        fail(f"analysis: {len(findings)} finding(s)")
    print(f"  analysis: 0 findings in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# training: train-check (2 layers, float32), train (full Yi-6B), quickstart
# ---------------------------------------------------------------------------


# the attention projections' fan-in: the model's initialisation (the
# reference's SpecBuilder) scales every "normal" weight by its second-to-last
# dimension, which for the 4-D stacked projections is the head count (wq,
# wk, wv: (L, d, H, Dh)) or the head dim (wo: (L, H, Dh, d)), not the
# d_model or H * Dh inputs they contract
PROJ_FAN_IN = {"wq": lambda sh: sh[1], "wk": lambda sh: sh[1], "wv": lambda sh: sh[1],
               "wo": lambda sh: sh[1] * sh[2], "xwq": lambda sh: sh[1],
               "xwk": lambda sh: sh[1], "xwv": lambda sh: sh[1],
               "xwo": lambda sh: sh[1] * sh[2]}


def trainable_params(model, seed: int, embed_scale: float = 1.0) -> dict:
    """Seeded random weights for the training phases: the model's own
    initialisation with each attention projection rescaled to 1/sqrt of the
    inputs it contracts. At the model's own scales (wk's std 0.5 at Yi's 4 kv
    heads) a full-depth Yi-6B's attention saturates (scores of several
    hundred) and its gradients grow several-fold a layer, to a global norm
    of ~1e25 at 32 layers: no optimizer setting lowered its loss in 8 steps
    (PERF.md). An encoder-decoder's cross projections (``xw*``) likewise.
    The embedding is multiplied by ``embed_scale``. Every other entry is the
    model's own."""
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    for key, p in params.items():
        name = key.split(".")[-1]
        if name in PROJ_FAN_IN:
            sh = p.shape
            p.mul_(math.sqrt(sh[-2] / PROJ_FAN_IN[name](sh)))
    params["embed"].mul_(embed_scale)
    return params


def _train_run(model, cfg, plan, opt, shape, init, backend="auto", lr=None,
               host=False) -> tuple:
    """TRAIN_CHECK_STEPS steps of ``make_train_step`` from a copy of
    ``init`` (or from what ``init()`` returns, where it is a function) under
    ``ops.BACKEND = backend`` at ``lr`` (default TRAIN_CHECK_LR): (per-step
    metrics, final params, {wrapper: launches}); with ``host`` the final
    params are moved to the host."""
    ops.BACKEND = backend
    params = init() if callable(init) else {k: v.clone() for k, v in init.items()}
    state = init_opt_state(opt, params, plan)
    train = TrainConfig(optimizer=opt, learning_rate=lr or TRAIN_CHECK_LR[opt], grad_clip=1.0)
    step = make_train_step(model, plan, MeshConfig((1,), ("data",)), train)
    for fn in _build.COUNTED:
        fn.launches = 0
    recs = []
    for i in range(TRAIN_CHECK_STEPS):
        batch = make_batch(cfg, shape, step=i, dtype=torch.float32, device="cuda")
        params, state, met = step(params, state, batch, i)
        recs.append({k: float(v) for k, v in met.items()})
    launches = {fn.__name__: fn.launches for fn in _build.COUNTED}
    ops.BACKEND = "auto"
    del state
    if host:
        params = {k: v.cpu() for k, v in params.items()}
    return recs, params, launches


def _same_trajectory(label, opt, got, want, lr=None) -> None:
    """Holds one train-check run against another under the train-check
    tolerances (Adam's element bound at ``lr``, default TRAIN_CHECK_LR),
    printing the largest readings."""
    (grecs, gparams, _), (wrecs, wparams, _) = got, want
    worst = {"loss": 0.0, "xent": 0.0, "grad_norm": 0.0}
    for g, w in zip(grecs, wrecs, strict=True):
        for key, rtol in (("loss", 1e-5), ("xent", 1e-5), ("grad_norm", 1e-3)):
            rel = abs(g[key] - w[key]) / max(abs(w[key]), 1e-30)
            worst[key] = max(worst[key], rel)
            if not (math.isfinite(g[key]) and rel <= rtol):
                fail(f"train-check {label}: {key} {g[key]} against {w[key]} (rtol {rtol})")
    lr = lr or TRAIN_CHECK_LR[opt]
    max_err = max_rms = 0.0
    for k, want_t in wparams.items():
        # on the card, whichever run's parameters the host holds
        want_t = want_t.to("cuda").float()
        err = (gparams[k].to("cuda").float() - want_t).abs()
        rms = float(err.pow(2).mean().sqrt()) / max(float(want_t.pow(2).mean().sqrt()), 1e-30)
        if opt == "sgd":
            ok = not bool((err > 1e-5 + 1e-5 * want_t.abs()).any())
        else:
            ok = float(err.max()) <= 2 * TRAIN_CHECK_STEPS * lr and rms <= 3e-3
        max_err, max_rms = max(max_err, float(err.max())), max(max_rms, rms)
        if not ok:
            fail(f"train-check {label}: parameter {k} max error {float(err.max()):.3e}, "
                 f"error RMS / RMS {rms:.3e}")
    print(f"  {label}: losses {[round(r['loss'], 6) for r in grecs]}; largest relative error "
          f"of loss {worst['loss']:.2e}, grad_norm {worst['grad_norm']:.2e}; parameters: max "
          f"error {max_err:.2e}, error RMS / RMS {max_rms:.2e}")


def phase_train_check() -> dict:
    """Yi-6B's float32 twin (see the phase title); returns the launches of
    the float32 training forward and backward in its kernel-path runs, the
    kernels line's float32 entries' main path."""
    b, s = TRAIN_CHECK_SHAPE
    phase(f"train-check: Yi-6B widths, {TRAIN_CHECK_LAYERS} layers, float32, batch {b}, seq "
          f"{s}, {TRAIN_CHECK_STEPS} steps, sgd and adam, grad_clip 1.0: the flash kernel's "
          f"path == the plain path, microbatches 1 == 2, remat on == off")
    cfg = replace(get_config("yi-6b"), num_layers=TRAIN_CHECK_LAYERS)
    model = build_model(cfg, dtype=torch.float32)
    shape = InputShape("train-check", s, b, "train")
    plan = compile_plan(cfg, shape, MeshConfig((1,), ("data",)), TrainConfig(),
                        dtype="float32").config
    print(f"  plan: {plan.strategy.value}, opt state {plan.opt_state_dtype}, remat "
          f"{plan.remat}, microbatches {plan.microbatches}")
    init = trainable_params(model, SEED)
    counts = {"flash_attention_train_fp32": 0, "flash_attention_bwd_fp32": 0}
    for opt in ("sgd", "adam"):
        kern = _train_run(model, cfg, plan, opt, shape, init)
        counts["flash_attention_train_fp32"] += kern[2]["flash_attention_train"]
        counts["flash_attention_bwd_fp32"] += kern[2]["flash_attention_bwd"]
        runs = {"plain": (plan, "torch"), "microbatches 2": (plan.replace(microbatches=2), "auto"),
                "remat off": (plan.replace(remat=False), "auto")}
        per_step = TRAIN_CHECK_LAYERS * (1 + plan.remat)
        flash = kern[2]["flash_attention_train"]
        print(f"  {opt}: kernel path {flash} flash_attention_train launches "
              f"(expected {TRAIN_CHECK_LAYERS} layers x {TRAIN_CHECK_STEPS} steps x "
              f"{1 + plan.remat}), {kern[2]['flash_attention_bwd']} flash_attention_bwd")
        if flash != per_step * TRAIN_CHECK_STEPS:
            fail(f"train-check {opt}: {flash} launches, expected "
                 f"{per_step * TRAIN_CHECK_STEPS}")
        check_bwd_launches(f"train-check {opt}", kern[2], flash, plan.remat)
        for label, (p, backend) in runs.items():
            other = _train_run(model, cfg, p, opt, shape, init, backend)
            got = other[2]["flash_attention_train"]
            want = (0 if backend == "torch" else
                    TRAIN_CHECK_LAYERS * (1 + p.remat) * p.microbatches * TRAIN_CHECK_STEPS)
            if got != want:
                fail(f"train-check {opt} {label}: {got} launches, expected {want}")
            check_bwd_launches(f"train-check {opt} {label}", other[2], want, p.remat)
            counts["flash_attention_train_fp32"] += got
            counts["flash_attention_bwd_fp32"] += other[2]["flash_attention_bwd"]
            _same_trajectory(f"{opt}, kernel path vs {label} ({got} launches)", opt,
                             kern, other)
            del other
        del kern
    del init, model
    gc.collect()
    print(f"  float32 launches in this phase's kernel-path runs: {counts}")
    return counts
    torch.cuda.empty_cache()


def check_bwd_launches(label: str, launches: dict, fwd: int, remat: bool) -> int:
    """Holds the attention backward kernel's launches to one a flash
    training forward of a step's first pass: ``fwd`` forwards (the remat
    recompute's included) over 1 + remat. Returns the count."""
    want = fwd // (1 + remat)
    if launches["flash_attention_bwd"] != want:
        fail(f"{label}: {launches['flash_attention_bwd']} flash_attention_bwd launches, "
             f"expected {want} (one a layer's first forward)")
    return want


class _Calls:
    """Counts calls of the plain functions that a step on the card must not
    take while a train phase runs: the model's CPU attention operators, the
    attention backward's plain rule and the scan kernels' plain versions
    (``ops``' own names and the modules' names the training ops' CPU
    implementations call)."""

    NAMES = ((ATT, "_einsum"), (ATT, "_blocked"), (FA, "attention_bwd_torch"),
             (ops, "ssd_scan_torch"),
             (ops, "rglru_scan_torch"), (SSD, "ssd_scan_torch"), (SSD, "ssd_scan_train_torch"),
             (SSD, "ssd_scan_bwd_torch"), (RG, "rglru_scan_torch"),
             (RG, "rglru_scan_train_torch"), (RG, "rglru_scan_bwd_torch"))

    def __enter__(self):
        self.calls = {n: 0 for _m, n in self.NAMES}
        self.saved = [(m, n, getattr(m, n)) for m, n in self.NAMES]
        for m, n, fn in self.saved:
            def counting(*a, _n=n, _fn=fn, **kw):
                self.calls[_n] += 1
                return _fn(*a, **kw)
            setattr(m, n, counting)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def _annotated(events, name):
    """Device-side (start, end) of the profiler's annotations of the CPU
    span ``name`` (the kernels launched inside it)."""
    return [(e.time_range.start, e.time_range.end) for e in events
            if e.name == name and e.device_type == DeviceType.CUDA and e.is_user_annotation]


def step_breakdown(events, span: str) -> None:
    """Device time of one traced train step by part: the flash, SSD and
    RG-LRU forwards (their kernels outside a backward span), the attention,
    SSD and RG-LRU backwards (kernels inside their spans' device
    annotations), the optimizer (likewise), the other matrix products, the
    rest; the step's busy time and idle share."""
    found = [e.time_range for e in events if e.name == span and e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not found or not dev:
        print(f"    train step: not measured ({len(found)} spans, {len(dev)} device events)")
        return
    lo, hi = found[0].start, found[0].end
    inside = [e for e in dev if lo <= e.time_range.start < hi]
    regions = {"attention backward": _annotated(events, FA.BACKWARD_SPAN),
               "ssd backward": _annotated(events, SSD.BACKWARD_SPAN),
               "rglru backward": _annotated(events, RG.BACKWARD_SPAN),
               "optimizer": _annotated(events, OPTIMIZER_SPAN)}
    forwards = {"flash": "flash forward", "ssd": "ssd forward", "rglru": "rglru forward",
                "matmul": "matmul"}
    parts = {"matmul": 0.0, "flash forward": 0.0, "attention backward": 0.0,
             "ssd forward": 0.0, "ssd backward": 0.0, "rglru forward": 0.0,
             "rglru backward": 0.0, "optimizer": 0.0, "other": 0.0}
    kernels = {fam: sum(1 for e in inside if _kernel_family(e.name) == fam)
               for fam in ("flash", "flash_bwd", "ssd", "rglru")}
    for e in inside:
        dur = e.time_range.end - e.time_range.start
        part = next((p for p, spans in regions.items()
                     if any(a <= e.time_range.start < b for a, b in spans)), None)
        if part is None:
            part = forwards.get(_kernel_family(e.name), "other")
        parts[part] += dur
    busy = _busy_us((e.time_range.start, min(e.time_range.end, hi)) for e in inside)
    print(f"    train step (traced): span {(hi - lo) / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / (hi - lo):.3f}, {len(inside)} device "
          f"events; device time: " + ", ".join(f"{p} {v / 1e3:.3f} ms" for p, v in parts.items()
                                                 if v or p in ("matmul", "optimizer", "other"))
          + f" (kernel events in the trace {kernels}; annotations: "
          + ", ".join(f"{p} {len(v)}" for p, v in regions.items()) + ")")


def phase_train() -> dict:
    b, s = TRAIN_SHAPE
    phase(f"train: full Yi-6B (32 layers, bfloat16, seeded random weights), batch {b}, seq "
          f"{s}, {TRAIN_STEPS} steps of adam at lr {TRAIN_LR} through "
          f"repro_torch.launch.train")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory before: {_mem()}")
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    for fn in _build.COUNTED:
        fn.launches = 0
    model = build_model(get_config("yi-6b"), dtype=torch.bfloat16)
    init = trainable_params(model, SEED)
    del model
    with _Calls() as plain:
        run = train_cli.main(TRAIN_ARGS + ["--checkpoint", str(ckpt)], params=init)
    del init
    launches = {fn.__name__: fn.launches for fn in _build.COUNTED}
    peak = torch.cuda.max_memory_allocated()
    plan = run.plan.config
    layers = run.cfg.layer_pattern().count("a")
    want = layers * TRAIN_STEPS * (1 + plan.remat) * plan.microbatches
    losses = [h["loss"] for h in run.timer.history]
    secs = [h["seconds"] for h in run.timer.history]
    step_s = statistics.median(secs[2:8])
    flops = cost.model_flops_per_step(run.cfg, run.shape)
    print(f"  plan: {plan.strategy.value}, opt state {plan.opt_state_dtype}, remat "
          f"{plan.remat}, microbatches {plan.microbatches}; estimate "
          f"{run.plan.memory.total / 2**30:.2f} GiB a card")
    print(f"  losses {[round(x, 4) for x in losses]}; step seconds "
          f"{[round(x, 4) for x in secs]}")
    print(f"  step {step_s * 1e3:.1f} ms (median of steps 2-7), {b * s / step_s:.0f} tokens/s, "
          f"mfu {flops / step_s / hw.H100.peak_flops:.4f} ({flops / 1e12:.1f} model TFLOP a "
          f"step against {hw.H100.peak_flops / 1e12:.0f} TFLOP/s)")
    print(f"  peak device memory {peak / 2**30:.2f} GiB against the plan's estimate "
          f"{run.plan.memory.total / 2**30:.2f} GiB"
          f"{' — ABOVE the estimate' if peak > run.plan.memory.total else ''}")
    print(f"  launches {launches} (flash_attention_train expected {layers} layers x "
          f"{TRAIN_STEPS} steps x {1 + plan.remat} = {want}, flash_attention_bwd "
          f"{layers * TRAIN_STEPS * plan.microbatches}); the plain attention functions called "
          f"{plain.calls}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: a loss is not finite: {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail(f"train: the mean of the last three losses {statistics.mean(losses[-3:])} is "
             f"not below step 0's {losses[0]}")
    if launches["flash_attention_train"] != want:
        fail(f"train: {launches['flash_attention_train']} flash_attention_train launches, "
             f"expected {want}")
    check_bwd_launches("train", launches, want, plan.remat)
    if any(plain.calls.values()):
        fail(f"train: the step on the card took the plain attention functions {plain.calls}")

    t0 = time.perf_counter()
    restored, step = load_checkpoint(str(ckpt), run.params)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(restored[k], run.params[k]) for k in run.params)
    size = sum(f.stat().st_size for f in ckpt.iterdir())
    print(f"  checkpoint: {size / 2**30:.2f} GiB saved in {run.save_s:.1f} s, restored in "
          f"{restore_s:.1f} s (step {step}), equal to the trained parameters: {same}")
    if step != TRAIN_STEPS or not same:
        fail("train: the restored checkpoint differs from the trained parameters")
    del restored
    shutil.rmtree(ckpt, ignore_errors=True)

    # one more step, traced (it updates the parameters in place)
    batch = make_batch(run.cfg, run.shape, step=TRAIN_STEPS, dtype=run.dtype, device="cuda")
    span = "train.step"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(span):
            run.step_fn(run.params, run.opt_state, batch, TRAIN_STEPS)
            torch.cuda.synchronize()
    step_breakdown(prof.events(), span)
    del prof, batch, run
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("flash_attention_train", "flash_attention_bwd")}


def _scan_launches(pattern: str, plan, steps: int) -> dict:
    """Each training kernel's launches for ``steps`` steps of a stack of
    ``pattern``: the forwards once a layer and microbatch, twice under
    remat (the recompute); the backwards (the attention backward's too)
    once."""
    m, fwd = plan.microbatches, 1 + plan.remat
    n = {k: pattern.count(k) for k in "sra"}
    return {"ssd_scan_train": n["s"] * steps * m * fwd, "ssd_scan_bwd": n["s"] * steps * m,
            "rglru_scan_train": n["r"] * steps * m * fwd, "rglru_scan_bwd": n["r"] * steps * m,
            "flash_attention_train": n["a"] * steps * m * fwd,
            "flash_attention_bwd": n["a"] * steps * m}


def phase_train_check_recurrent(family: str) -> None:
    """train-check-ssm / train-check-hybrid: the family's full widths cut to
    a few layers, float32, TRAIN_CHECK_STEPS steps of sgd and adam (clip
    1.0): the kernel path (the scan kernels' training forwards and backward
    kernels, flash's training forward) against the plain path and against 2
    microbatches, under the train-check tolerances, launches exact."""
    arch, cut = RECURRENT_CHECKS[family]
    b, s = TRAIN_CHECK_SHAPE
    cfg = replace(get_config(arch), **cut)
    pattern = cfg.layer_pattern()
    phase(f"train-check-{family}: {arch} widths, {len(pattern)} layers ({pattern}), float32, "
          f"batch {b}, seq {s}, {TRAIN_CHECK_STEPS} steps, sgd and adam, grad_clip 1.0: the "
          f"kernel path == the plain path, microbatches 1 == 2")
    model = build_model(cfg, dtype=torch.float32)
    shape = InputShape("train-check", s, b, "train")
    plan = compile_plan(cfg, shape, MeshConfig((1,), ("data",)), TrainConfig(),
                        dtype="float32").config
    print(f"  plan: {plan.strategy.value}, opt state {plan.opt_state_dtype}, remat "
          f"{plan.remat}, microbatches {plan.microbatches}")
    init = trainable_params(model, SEED)
    for opt in ("sgd", "adam"):
        lr = RECURRENT_CHECK_LR[family][opt]
        runs = {"kernel path": (plan, "auto"), "plain": (plan, "torch"),
                "microbatches 2": (plan.replace(microbatches=2), "auto")}
        out = {}
        for label, (p, backend) in runs.items():
            out[label] = _train_run(model, cfg, p, opt, shape, init, backend, lr=lr)
            want = ({k: 0 for k in _scan_launches(pattern, p, 0)} if backend == "torch"
                    else _scan_launches(pattern, p, TRAIN_CHECK_STEPS))
            got = {k: out[label][2][k] for k in want}
            print(f"  {opt} at lr {lr:g}, {label}: launches {got}")
            if got != want:
                fail(f"train-check-{family} {opt} {label}: launches {got}, expected {want}")
        for label in ("plain", "microbatches 2"):
            _same_trajectory(f"{opt}, kernel path vs {label}", opt, out["kernel path"],
                             out[label], lr=lr)
        del out
    del init, model
    gc.collect()
    torch.cuda.empty_cache()



def phase_train_recurrent(family: str) -> dict:
    """train-ssm / train-hybrid: the full model, bfloat16, TRAIN_SHAPE,
    TRAIN_STEPS Adam steps at TRAIN_LR through ``launch.train``'s own entry
    on the planner's one-card plan, from ``trainable_params`` (Mamba-2 has
    no attention projection, so its weights are the model's own seeded
    initialisation; at RecurrentGemma-2B's own, whose 4-D attention
    projections carry the head-count scaling, the gradient norm was 1e8 to
    3e9 and the loss flat within its batches' noise: PERF.md section 6)
    with the embedding scaled as RECURRENT_TRAIN says: losses finite and
    falling (for the hybrid below ln(vocab)), the training kernels' launches exact, no
    plain scan or CPU attention function called; step ms, tokens/s, MFU,
    peak memory against the estimate, one traced step's breakdown. Returns
    the scan kernels' launches."""
    arch, embed_scale, below_uniform = RECURRENT_TRAIN[family]
    b, s = TRAIN_SHAPE
    cfg = get_config(arch)
    pattern = cfg.layer_pattern()
    phase(f"train-{family}: full {arch} ({len(pattern)} layers, bfloat16, seeded "
          f"trainable_params, embedding x {embed_scale:g}), batch {b}, seq {s}, {TRAIN_STEPS} "
          f"steps of adam at lr {TRAIN_LR} through repro_torch.launch.train")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory before: {_mem()}")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dtype=torch.bfloat16)
    init = trainable_params(model, SEED, embed_scale)
    del model
    args = ["--arch", arch] + TRAIN_ARGS[2:]
    for fn in _build.COUNTED:
        fn.launches = 0
    with _Calls() as plain:
        run = train_cli.main(args, params=init)
    launches = {fn.__name__: fn.launches for fn in _build.COUNTED}
    del init
    peak = torch.cuda.max_memory_allocated()
    plan = run.plan.config
    want = _scan_launches(pattern, plan, TRAIN_STEPS)
    got = {k: launches[k] for k in want}
    losses = [h["loss"] for h in run.timer.history]
    secs = [h["seconds"] for h in run.timer.history]
    step_s = statistics.median(secs[2:8])
    flops = cost.model_flops_per_step(run.cfg, run.shape)
    print(f"  plan: {plan.strategy.value}, opt state {plan.opt_state_dtype}, remat "
          f"{plan.remat}, microbatches {plan.microbatches}; {run.plan.memory.summary()}")
    print(f"  losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(h['grad_norm'], 4) for h in run.timer.history]}; step seconds "
          f"{[round(x, 4) for x in secs]}")
    print(f"  step {step_s * 1e3:.1f} ms (median of steps 2-7), {b * s / step_s:.0f} tokens/s, "
          f"mfu {flops / step_s / hw.H100.peak_flops:.4f} ({flops / 1e12:.1f} model TFLOP a "
          f"step against {hw.H100.peak_flops / 1e12:.0f} TFLOP/s)")
    print(f"  peak device memory {peak / 2**30:.2f} GiB against the plan's estimate "
          f"{run.plan.memory.total / 2**30:.2f} GiB"
          f"{' — ABOVE the estimate' if peak > run.plan.memory.total else ''}")
    print(f"  launches {got} (expected {want}); plain functions called {plain.calls}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train-{family}: a loss is not finite: {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail(f"train-{family}: the mean of the last three losses "
             f"{statistics.mean(losses[-3:])} is not below step 0's {losses[0]}")
    if below_uniform and not statistics.mean(losses[-3:]) < math.log(cfg.vocab_size):
        fail(f"train-{family}: the mean of the last three losses "
             f"{statistics.mean(losses[-3:])} is not below ln(vocab) "
             f"{math.log(cfg.vocab_size)}, the loss of uniform logits")
    if family in LEARNING_GATE:
        noise = max(abs(losses[1] - losses[0]), abs(losses[2] - losses[1]))
        fall = losses[2] - statistics.mean(losses[-3:])
        print(f"  learning gate: the last three's mean sits {fall:.4f} below step 2's loss; "
              f"the largest step-to-step move of steps 0-2 is {noise:.4f}")
        if not fall > noise:
            fail(f"train-{family}: the mean of the last three losses is {fall:.4f} below step "
                 f"2's, not more than the step-to-step noise {noise:.4f}: no learning shown")
    if got != want:
        fail(f"train-{family}: launches {got}, expected {want}")
    if any(plain.calls.values()):
        fail(f"train-{family}: the step on the card called plain functions {plain.calls}")
    batch = make_batch(run.cfg, run.shape, step=TRAIN_STEPS, dtype=run.dtype, device="cuda")
    span = "train.step"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(span):
            run.step_fn(run.params, run.opt_state, batch, TRAIN_STEPS)
            torch.cuda.synchronize()
    step_breakdown(prof.events(), span)
    del prof, batch, run
    gc.collect()
    torch.cuda.empty_cache()
    kinds = ("ssd_scan_train", "ssd_scan_bwd") if family == "ssm" else ("rglru_scan_train",
                                                                        "rglru_scan_bwd")
    return {k: launches[k] for k in kinds}


# ---------------------------------------------------------------------------
# the MoE family: qwen3-moe-235b-a22b at full width, depth cut
# ---------------------------------------------------------------------------

MESH1 = MeshConfig((1,), ("data",))


def _moe_cfg(layers: int, **kw):
    return replace(get_config(MOE_ARCH), num_layers=layers, **kw)


def _deepest(label: str, est: dict) -> int:
    """The deepest depth whose estimate fits 3/4 of the card, printed beside
    every depth's estimate."""
    card = torch.cuda.get_device_properties(0).total_memory
    fits = [n for n, e in est.items() if e <= 0.75 * card]
    print(f"  {label} depth: the planner's estimate by depth "
          + ", ".join(f"{n} layers {e / 2**30:.2f} GiB" for n, e in est.items())
          + f" against 3/4 of the card's {card / 2**30:.2f} GiB -> "
          + (f"{max(fits)} layers (a cut of {get_config(MOE_ARCH).num_layers} to {max(fits)})"
             if fits else "none fits"))
    if not fits:
        fail(f"{label}: no depth of {tuple(est)} fits 3/4 of the card")
    return max(fits)


def moe_serve_depth() -> int:
    """serve-moe's depth: for each of MOE_SERVE_DEPTHS the largest plan
    estimate over the prompt-pass and decode plans of SERVE_REQUESTS'
    buckets, from the planner the server builds (bfloat16, page 64, its pool
    of arenas, decode_kernel auto)."""
    config = EngineConfig(dtype="bfloat16", prefill=True, page_size=64, decode_kernel="auto")
    compiler = PlanCompiler(hw.H100, cache_pool_arenas=config.pool_arenas,
                            cache_page_size=config.page_size, decode_kernel="auto",
                            donate_cache=True)
    buckets = sorted({(bucket(b, 1), bucket(c + SERVE_NEW_TOKENS, 16))
                      for b, c in SERVE_REQUESTS})
    est = {n: max(compiler.compile(_moe_cfg(n), InputShape("serve-moe", s, b, kind), MESH1,
                                   dtype="bfloat16").memory.total
                  for b, s in buckets for kind in ("prefill", "decode"))
           for n in MOE_SERVE_DEPTHS}
    return _deepest("serve-moe", est)


def moe_floors(cfg, batch: int, seq: int) -> tuple:
    """(decode ms a tick, prompt-pass ms) floors of the expert products at
    ``cfg``'s depth in bfloat16: a decode tick's einsums read every
    expert's weights (the reference's dense capacity buffer) at the card's
    memory rate; a (batch, seq) prompt pass's three products over the
    (E, C, D) buffer at its peak rate."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    t = batch * seq
    cap = int(t * cfg.experts_per_token * cfg.moe_capacity_factor / e) + 1
    cap = max(8, -(-cap // 8) * 8)
    tick = cfg.num_layers * 3 * e * d * f * 2 / hw.H100.hbm_bandwidth * 1e3
    prompt = cfg.num_layers * 3 * 2 * e * cap * d * f / hw.H100.peak_flops * 1e3
    return tick, prompt, cap


def phase_serve_check_moe():
    phase(f"serve-check-moe: Qwen3-MoE-235B-A22B widths, {MOE_CHECK_LAYERS} layers, float32: "
          "graphed == eager; paged == gather == ref == auto; kernel path == plain path; the "
          "engine trace")
    t_phase = time.perf_counter()
    cfg = _moe_cfg(MOE_CHECK_LAYERS)
    srv = serve_twin_check(cfg, [ServeRequest(b, c, new_tokens=8) for b, c in CHECK_REQUESTS],
                           True, "moe")
    params = srv.params
    del srv
    # the engine trace: a decode tick of at most 8 rows never drops (every
    # expert's capacity is 8 slots and takes at most one pair a row), but
    # the trace's first prompt pass coalesces seven requests, so it runs at
    # the dropless capacity factor E / k
    dropless = replace(cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    srv = PlanServer(dropless, config=EngineConfig(dtype="float32", prefill=True, page_size=64,
                                                   decode_kernel="paged", seed=SEED))
    srv.params = params
    engine_trace_check(srv, f"Qwen3-MoE {MOE_CHECK_LAYERS} layers, capacity factor "
                            f"{dropless.moe_capacity_factor:g} (dropless), decode_kernel=paged")
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  serve-check-moe: {time.perf_counter() - t_phase:.1f} s")


def phase_serve_moe() -> dict:
    t_phase = time.perf_counter()
    phase(f"serve-moe: {MOE_ARCH} at full width, bfloat16, page 64, decode_kernel=auto, one "
          "CUDA graph per bucket")
    layers = moe_serve_depth()
    cfg = _moe_cfg(layers)
    t0 = time.perf_counter()
    srv = PlanServer(cfg, config=EngineConfig(dtype="bfloat16", prefill=True, page_size=64,
                                              decode_kernel="auto", seed=SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in srv.params.values())
    print(f"  weights: {n_params / 1e9:.2f} B parameters ({cfg.active_param_count() / 1e9:.2f} B "
          f"active a token) at {layers} layers, random from seed {SEED}, built in "
          f"{time.perf_counter() - t0:.1f} s; {_mem()}")
    srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
    steady = []
    launches = serve_passes(srv, cfg, decode_kernel="paged", steady=steady)
    for req, out in zip(SERVE_REQUESTS, steady):
        b, c = req
        bb, s = srv.buckets(b, c + SERVE_NEW_TOKENS)
        tick, prompt, cap = moe_floors(cfg, bb, s)
        dec_ms = out["decode_s"] * 1e3 / max(1, out["decode_steps"])
        print(f"    req {b}x{c} bucket ({bb}, {s}): prefill {out['prefill_s'] * 1e3:.1f} ms "
              f"against the expert products' floor {prompt:.1f} ms (capacity {cap}); decode "
              f"{dec_ms:.3f} ms/step against the expert weights' read {tick:.3f} ms")
    above = measured_peaks(srv, SERVE_REQUESTS)
    trace_decode(srv, [ServeRequest(b, c, new_tokens=SERVE_NEW_TOKENS) for b, c in SERVE_REQUESTS])
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  serve-moe: {time.perf_counter() - t_phase:.1f} s")
    if above:
        fail(f"serve-moe: measured peaks above the plan's estimate at {above}")
    return {"flash_attention_g16": launches["flash_attention"],
            "paged_decode_attention_g16": launches["paged_decode_attention"]}


def phase_train_check_moe() -> None:
    train_check_on_card(_moe_cfg(MOE_TRAIN_CHECK_LAYERS),
                        f"train-check-moe: Qwen3-MoE-235B-A22B widths, {MOE_TRAIN_CHECK_LAYERS} "
                        "layer")


def moe_train_depth() -> int:
    b, s = TRAIN_SHAPE
    est = {n: compile_plan(_moe_cfg(n), InputShape("train-moe", s, b, "train"), MESH1,
                           TrainConfig(), dtype="bfloat16").memory.total
           for n in MOE_TRAIN_DEPTHS}
    return _deepest("train-moe", est)


def phase_train_moe() -> None:
    b, s = TRAIN_SHAPE
    phase(train_title(f"train-moe: {MOE_ARCH} at full width", b, s))
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _moe_cfg(moe_train_depth())
    shape = InputShape("train-moe", s, b, "train")
    peak, estimate = train_on_card(
        cfg, shape, "train-moe", cost.model_flops_per_step(cfg, shape),
        f"over the active parameters, {cfg.active_param_count() / 1e9:.3f} B of "
        f"{cfg.param_count() / 1e9:.3f} B")
    if peak > estimate:
        fail(f"train-moe: peak {peak} B above the plan's estimate {estimate:.0f} B")


def train_check_on_card(cfg, title: str) -> None:
    """A float32 twin's TRAIN_CHECK_STEPS steps of sgd and of adam (clip 1.0)
    at TRAIN_CHECK_SHAPE from trainable_params: the flash kernel's path
    against the plain attention path (``ops.BACKEND = "torch"``) under
    train-check's tolerances, the MoE auxiliary loss too, flash launches
    exact."""
    b, s = TRAIN_CHECK_SHAPE
    label = title.split(":")[0]
    phase(f"{title}, float32, batch {b}, seq {s}, {TRAIN_CHECK_STEPS} steps, sgd and adam, "
          "grad_clip 1.0: the flash kernel's path == the plain path")
    t_phase = time.perf_counter()
    model = build_model(cfg, dtype=torch.float32)
    shape = InputShape(label, s, b, "train")
    plan = compile_plan(cfg, shape, MESH1, TrainConfig(), dtype="float32").config
    print(f"  plan: {plan.strategy.value}, opt state {plan.opt_state_dtype}, remat "
          f"{plan.remat}, microbatches {plan.microbatches}; {model.param_count() / 1e9:.3f} B "
          "parameters")
    # the same seeded weights for every run, made anew on the card each time
    init = lambda: trainable_params(model, SEED)  # noqa: E731
    want = _flash_per_forward(cfg) * (1 + plan.remat) * plan.microbatches * TRAIN_CHECK_STEPS
    for opt in ("sgd", "adam"):
        kern = _train_run(model, cfg, plan, opt, shape, init, host=True)
        flash = kern[2]["flash_attention_train"]
        aux = f"; aux {[round(r['aux'], 6) for r in kern[0]]}" if cfg.num_experts else ""
        print(f"  {opt}: kernel path {flash} flash_attention_train launches (expected "
              f"{want}), {kern[2]['flash_attention_bwd']} flash_attention_bwd{aux}")
        if flash != want:
            fail(f"{label} {opt}: {flash} launches, expected {want}")
        check_bwd_launches(f"{label} {opt}", kern[2], want, plan.remat)
        other = _train_run(model, cfg, plan, opt, shape, init, "torch")
        if other[2]["flash_attention_train"] or other[2]["flash_attention_bwd"]:
            fail(f"{label} {opt}: the plain path launched a flash kernel")
        for g, w in zip(kern[0], other[0]):
            rel = abs(g["aux"] - w["aux"]) / max(abs(w["aux"]), 1e-30)
            if not (math.isfinite(g["aux"]) and rel <= 1e-5):
                fail(f"{label} {opt}: aux {g['aux']} against {w['aux']} (rtol 1e-5)")
        _same_trajectory(f"{cfg.family} {opt}, kernel path vs plain", opt, kern, other)
        del kern, other
        gc.collect()
        torch.cuda.empty_cache()
    del model
    print(f"  {label}: {time.perf_counter() - t_phase:.1f} s")


def train_title(what: str, b: int, s: int) -> str:
    return (f"{what}, bfloat16, batch {b}, seq {s}, {TRAIN_STEPS} steps of adam at lr "
            f"{TRAIN_LR}, grad_clip 1.0, through make_train_step")


def train_on_card(cfg, shape, label: str, flops: float, counted: str) -> tuple:
    """TRAIN_STEPS Adam steps (lr TRAIN_LR, clip 1.0) of ``cfg`` in bfloat16
    at ``shape`` through ``make_train_step`` on the planner's one-card plan,
    from trainable_params: losses finite and the mean of the last three
    below step 0's, flash launches exact, no plain attention; step ms,
    tokens/s, MFU (``flops`` a step, ``counted`` saying over what), peak
    against the estimate and a traced step by part. Returns (peak bytes,
    the plan's estimate)."""
    b, s = shape.global_batch, shape.seq_len
    t_phase = time.perf_counter()
    eplan = compile_plan(cfg, shape, MESH1, TrainConfig(), dtype="bfloat16")
    plan = eplan.config
    print(f"  plan: {plan.strategy.value}, opt state {plan.opt_state_dtype}, remat "
          f"{plan.remat}, microbatches {plan.microbatches}; {eplan.memory.summary()}")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dtype=torch.bfloat16)
    params = trainable_params(model, SEED)
    state = init_opt_state("adam", params, plan)
    step = make_train_step(model, plan, MESH1, TrainConfig(optimizer="adam",
                                                           learning_rate=TRAIN_LR, grad_clip=1.0))
    for fn in _build.COUNTED:
        fn.launches = 0
    recs, secs = [], []
    with _Calls() as plain:
        for i in range(TRAIN_STEPS):
            batch = make_batch(cfg, shape, step=i, dtype=torch.bfloat16, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, met = step(params, state, batch, i)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            recs.append({k: float(v) for k, v in met.items()})
    launches = {fn.__name__: fn.launches for fn in _build.COUNTED}
    peak = torch.cuda.max_memory_allocated()
    want = _flash_per_forward(cfg) * TRAIN_STEPS * (1 + plan.remat) * plan.microbatches
    losses = [r["loss"] for r in recs]
    step_s = statistics.median(secs[2:])
    aux = f"; aux {[round(r['aux'], 4) for r in recs]}" if cfg.num_experts else ""
    print(f"  losses {[round(x, 4) for x in losses]}{aux}; grad norms "
          f"{[round(r['grad_norm'], 4) for r in recs]}; step seconds "
          f"{[round(x, 4) for x in secs]}")
    print(f"  step {step_s * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS - 1}), "
          f"{b * s / step_s:.0f} tokens/s, mfu {flops / step_s / hw.H100.peak_flops:.4f} "
          f"(6 N tokens {counted}: {flops / 1e12:.2f} model TFLOP a step against "
          f"{hw.H100.peak_flops / 1e12:.0f} TFLOP/s)")
    print(f"  peak device memory {peak / 2**30:.2f} GiB against the plan's estimate "
          f"{eplan.memory.total / 2**30:.2f} GiB"
          f"{' — ABOVE the estimate' if peak > eplan.memory.total else ''}")
    print(f"  launches {launches} (flash_attention_train expected {_flash_per_forward(cfg)} a "
          f"forward x {TRAIN_STEPS} steps x {1 + plan.remat} x {plan.microbatches} = {want}, "
          f"flash_attention_bwd {want // (1 + plan.remat)}); the plain attention functions "
          f"called {plain.calls}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: a loss is not finite: {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail(f"{label}: the mean of the last three losses {statistics.mean(losses[-3:])} is "
             f"not below step 0's {losses[0]}")
    if launches["flash_attention_train"] != want:
        fail(f"{label}: {launches['flash_attention_train']} flash_attention_train launches, "
             f"expected {want}")
    check_bwd_launches(label, launches, want, plan.remat)
    if any(plain.calls.values()):
        fail(f"{label}: the step on the card took the plain attention functions {plain.calls}")
    batch = make_batch(cfg, shape, step=TRAIN_STEPS, dtype=torch.bfloat16, device="cuda")
    span = "train.step"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(span):
            step(params, state, batch, TRAIN_STEPS)
            torch.cuda.synchronize()
    step_breakdown(prof.events(), span)
    del prof, batch, params, state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {label}: {time.perf_counter() - t_phase:.1f} s")
    return peak, eplan.memory.total


# ---------------------------------------------------------------------------
# the vision and audio families: InternVL2-2B and Whisper-medium, full depth
# ---------------------------------------------------------------------------


def _encdec_cfg(arch: str, layers: Optional[int] = None):
    """``arch``'s config, or its widths cut to ``layers`` layers (the
    encoder's too)."""
    cfg = get_config(arch)
    if layers is None:
        return cfg
    return replace(cfg, num_layers=layers,
                   **({"encoder_layers": layers} if cfg.is_encdec else {}))


def serve_twin_check(cfg, requests, prefill: bool, label: str):
    """A float32 twin served through ``PlanServer`` under the paged, gather,
    ref and auto decode kernels: launches exact (flash per layer and prompt
    pass, and for an encoder-decoder per decoder layer and tick; paged per
    layer and paged tick), every auto plan paged, graphed == eager, the
    streams identical across the kernels, then the same requests eagerly on
    the plain path (``ops.BACKEND = "torch"``, no kernel launched) equal
    too. Returns the paged server."""
    wrappers = _counted_wrappers()
    streams, logits, params, kept = {}, {}, None, None
    for kernel in ("paged", "gather", "ref", "auto"):
        srv = PlanServer(cfg, config=EngineConfig(dtype="float32", prefill=prefill,
                                                  page_size=64, decode_kernel=kernel, seed=SEED))
        if params is None:
            params = srv.params
        srv.params = params
        for fn in wrappers.values():
            fn.launches = 0
        outs = [srv.handle(r) for r in requests]
        got = {k: fn.launches for k, fn in wrappers.items()}
        chosen = [o["plan"].explain_axes()["decode_kernel"] for o in outs]
        want = launches_expected(cfg, len(requests) if prefill else 0, sum(
            o["decode_steps"] for o, k in zip(outs, chosen) if k == "paged"),
            sum(o["decode_steps"] for o in outs))
        streams[kernel] = [o["tokens"].cpu().numpy() for o in outs]
        logits[kernel] = [o["last_logits"].float() for o in outs]
        print(f"  {kernel}: buckets {[o['bucket'] for o in outs]}, plans chose {chosen}; "
              f"{[t.tolist() for t in streams[kernel]]}; launches {got} (expected {want})")
        if got != want:
            fail(f"{label} decode_kernel={kernel}: launches {got} != {want}")
        if kernel == "auto" and set(chosen) != {"paged"}:
            fail(f"{label} decode_kernel=auto: the plans chose {chosen}, not paged")
        check_graphed_against_eager(srv, requests, outs, f"{label} decode_kernel={kernel}")
        if kernel == "paged":
            kept = srv
        del srv
    for kernel in ("gather", "ref", "auto"):
        for a, c in zip(streams["paged"], streams[kernel]):
            if not np.array_equal(a, c):
                fail(f"{label} token streams differ between paged and {kernel}")
        for a, c in zip(logits["paged"], logits[kernel]):
            if not torch.allclose(a, c, atol=1e-3, rtol=1e-3):
                fail(f"{label} final logits differ between paged and {kernel}")
    print(f"  {label}: token streams identical across paged, gather, ref and auto")
    ops.BACKEND = "torch"
    for fn in wrappers.values():
        fn.launches = 0
    plain = [eager_handle(kept, r) for r in requests]
    ops.BACKEND = "auto"
    if any(fn.launches for fn in wrappers.values()):
        fail(f"{label}: the plain path launched a kernel")
    for (tokens, last), a, lg in zip(plain, streams["paged"], logits["paged"]):
        if not np.array_equal(tokens, a):
            fail(f"{label}: token streams differ between the kernel path and the plain path")
        if not torch.allclose(last, lg, atol=1e-3, rtol=1e-3):
            fail(f"{label}: final logits differ between the kernel path and the plain path")
    print(f"  {label}: the plain path (ops.BACKEND='torch', eager) gives the same streams")
    return kept


def encdec_greedy(srv, params, cross, steps: int, graphed: bool, trace: bool = False):
    """Greedy decoding of ``steps`` tokens over the cross K/V ``cross``
    (``build_cross_cache``'s, one row each) from token 1 at position 0, as
    the reference's model-level enc-dec decode: ``make_decode_step``'s paged
    step (paged kernel, ``srv``'s page size) at AUDIO_CONTEXT slots on an
    arena of ``srv``'s pool, ticked through ``GraphDecodeStep`` (captured on
    its first tick, replayed after) or eagerly. With ``trace`` four more
    ticks are traced for the device's time by kind. Returns (tokens on the
    host, last logits, seconds of ticks 2..steps, {kind: device ms a tick}
    or None)."""
    b = cross["x.k"].shape[1]
    pool, dev = srv.pool, srv.device
    arena = pool.acquire(b, AUDIO_CONTEXT, zero=True, force=True,
                         demand_bytes=pool.member_bytes(AUDIO_CONTEXT, b, AUDIO_CONTEXT))
    rows = pool.admit_request_rows(arena, b, prompt=0, span=AUDIO_CONTEXT, eager=True)
    rows_t = torch.tensor(rows, device=dev)
    for key in ("x.k", "x.v"):
        arena.cache[key].index_copy_(1, rows_t, cross[key].to(arena.cache[key].dtype))
    step = make_decode_step(srv.model, page=srv.page_size, seq_len=AUDIO_CONTEXT,
                            decode_kernel="paged")
    if graphed:
        runner = GraphDecodeStep(step, dev)
        toks, pos = runner.buffers(arena)

        def run():
            return runner(params, arena, toks, pos)
    else:
        toks = torch.ones((arena.batch, 1), dtype=torch.int32, device=dev)
        pos = torch.zeros((arena.batch,), dtype=torch.int32, device=dev)

        def run():
            return tick(step, params, arena.cache, arena.tables, toks, pos)
    toks.fill_(1)
    pos.zero_()
    out = []
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits = run()
        out.append(toks[rows_t].clone())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    split = None
    if trace:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                run()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                fam = _kernel_family(e.name)
                split[fam] = split.get(fam, 0.0) + (e.time_range.end - e.time_range.start) / 4e3
    last = logits[:, -1][rows_t].float()
    tokens = torch.cat(out, dim=1).cpu().numpy()
    pool.free_rows(arena, rows)
    pool.release(arena)
    if graphed:
        runner.clear()
    return tokens, last, secs, split


def phase_serve_check_vlm():
    phase(f"serve-check-vlm: InternVL2-2B widths, {ENCDEC_CHECK_LAYERS} layers, float32, "
          "prefill=True (no handoff): paged == gather == ref == auto, graphed == eager, "
          "kernel path == plain path")
    t_phase = time.perf_counter()
    cfg = _encdec_cfg(VLM_ARCH, ENCDEC_CHECK_LAYERS)
    srv = serve_twin_check(cfg, [ServeRequest(b, c, new_tokens=8) for b, c in CHECK_REQUESTS],
                           True, "internvl2")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  serve-check-vlm: {time.perf_counter() - t_phase:.1f} s")


def phase_serve_vlm() -> dict:
    t_phase = time.perf_counter()
    cfg = _encdec_cfg(VLM_ARCH)
    phase(f"serve-vlm: {cfg.name}, {cfg.num_layers} layers, bfloat16, prefill=True, page 64, "
          "decode_kernel=auto, one CUDA graph per bucket")
    t0 = time.perf_counter()
    srv = PlanServer(cfg, config=EngineConfig(dtype="bfloat16", prefill=True, page_size=64,
                                              decode_kernel="auto", seed=SEED))
    torch.cuda.synchronize()
    print(f"  weights: {sum(p.numel() for p in srv.params.values()) / 1e9:.3f} B parameters, "
          f"random from seed {SEED}, built in {time.perf_counter() - t0:.1f} s; {_mem()}")
    srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
    launches = serve_passes(srv, cfg, decode_kernel="paged")
    measured_peaks(srv, SERVE_REQUESTS)
    trace_decode(srv, [ServeRequest(b, c, new_tokens=SERVE_NEW_TOKENS) for b, c in SERVE_REQUESTS])
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  serve-vlm: {time.perf_counter() - t_phase:.1f} s")
    return {"paged_decode_attention_g2": launches["paged_decode_attention"]}


def measured_peaks(srv, requests, prefill: bool = True) -> list:
    """Peak device memory of one eager tick and, with ``prefill``, one
    prompt pass per bucket of ``requests`` on ``srv``, printed against the
    plan's estimate; returns the cells measured above it."""
    print("  peak memory by bucket (one eager tick and one prompt pass), against the plan's "
          "estimate:")
    kinds = (memory_audit.measure_decode,) + ((memory_audit.measure_prefill,) if prefill else ())
    above = []
    for b, c in requests:
        for measure in kinds:
            rec, _found = measure(srv, b, c + SERVE_NEW_TOKENS)
            over = rec["measured_bytes"] > rec["estimate_bytes"]
            print(f"    {rec['where']}: measured {rec['measured_bytes'] / 2**30:.3f} GiB, "
                  f"estimate {rec['estimate_bytes'] / 2**30:.3f} GiB"
                  f"{' — ABOVE the estimate' if over else ''}")
            if over:
                above.append(rec["where"])
    torch.cuda.empty_cache()
    return above


def phase_serve_check_audio():
    phase(f"serve-check-audio: Whisper-medium widths, {ENCDEC_CHECK_LAYERS} encoder and "
          f"{ENCDEC_CHECK_LAYERS} decoder layers, float32: the cross cache and graphed decode "
          "== eager == the plain path; PlanServer (prefill=False) paged == gather == ref == "
          "auto")
    t_phase = time.perf_counter()
    cfg = _encdec_cfg(AUDIO_ARCH, ENCDEC_CHECK_LAYERS)
    srv = serve_twin_check(cfg, [ServeRequest(b, c, new_tokens=8) for b, c in CHECK_REQUESTS],
                           False, "whisper")
    # (a) the model-level path on trainable_params' weights (at the model's
    # own init the encoder's attention scores reach the hundreds, where a
    # float32 reordering moves its output past any kernel tolerance)
    params = trainable_params(srv.model, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen, device="cuda")
    FA.flash_attention.launches = 0
    cross = srv.model.build_cross_cache(params, frames)
    enc = FA.flash_attention.launches
    ops.BACKEND = "torch"
    plain = srv.model.build_cross_cache(params, frames)
    ops.BACKEND = "auto"
    print(f"  build_cross_cache: {enc} flash launches (expected {cfg.encoder_layers})")
    if enc != cfg.encoder_layers:
        fail(f"whisper build_cross_cache: {enc} flash launches, expected {cfg.encoder_layers}")
    for key in ("x.k", "x.v"):
        check_close(f"whisper cross cache {key}, kernel vs plain path", cross[key], plain[key],
                    FP32_TOL)
    steps = 16
    runs = {"graphed": encdec_greedy(srv, params, cross, steps, graphed=True),
            "eager": encdec_greedy(srv, params, cross, steps, graphed=False)}
    ops.BACKEND = "torch"
    runs["plain"] = encdec_greedy(srv, params, plain, steps, graphed=False)
    ops.BACKEND = "auto"
    for name in ("eager", "plain"):
        if not np.array_equal(runs[name][0], runs["graphed"][0]):
            fail(f"whisper model-level decode: {name} and graphed token streams differ")
        if not torch.allclose(runs[name][1], runs["graphed"][1], atol=1e-3, rtol=1e-3):
            fail(f"whisper model-level decode: {name} and graphed final logits differ")
    print(f"  model-level decode, {steps} tokens over the cross cache: graphed == eager == "
          f"plain path: {runs['graphed'][0].tolist()}")
    del srv, params, cross, plain, runs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  serve-check-audio: {time.perf_counter() - t_phase:.1f} s")


def phase_serve_audio() -> dict:
    t_phase = time.perf_counter()
    cfg = _encdec_cfg(AUDIO_ARCH)
    phase(f"serve-audio: {cfg.name}, {cfg.encoder_layers} + {cfg.num_layers} layers, "
          "bfloat16: (a) build_cross_cache and graphed paged decode at the model level, "
          "(b) PlanServer with prefill=False, page 64, decode_kernel=auto")
    t0 = time.perf_counter()
    srv = PlanServer(cfg, config=EngineConfig(dtype="bfloat16", prefill=False, page_size=64,
                                              decode_kernel="auto", seed=SEED))
    torch.cuda.synchronize()
    print(f"  weights: {sum(p.numel() for p in srv.params.values()) / 1e9:.3f} B parameters, "
          f"random from seed {SEED}, built in {time.perf_counter() - t0:.1f} s; {_mem()}")
    # (a) on trainable_params' weights, so the tokens read the frames
    params = trainable_params(srv.model, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    frames = torch.randn((AUDIO_ROWS, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    for fn in _build.COUNTED:
        fn.launches = 0
    cross = srv.model.build_cross_cache(params, frames)
    enc_launches = FA.flash_attention.launches
    enc_ms = cuda_ms(lambda: srv.model.build_cross_cache(params, frames), reps=3, warmup=1)
    if enc_launches != cfg.encoder_layers:
        fail(f"serve-audio: the encoder launched flash {enc_launches} times, expected "
             f"{cfg.encoder_layers}")
    xbytes = sum(t.numel() * t.element_size() for t in cross.values())
    print(f"  encoder + cross K/V over ({AUDIO_ROWS}, {cfg.encoder_seq}) frames: "
          f"{enc_ms:.2f} ms (events, median of 3), {enc_launches} flash launches; cross K/V "
          f"{xbytes / 2**20:.1f} MiB ({xbytes / AUDIO_ROWS / 1e6:.1f} MB a row, outside the "
          "page pool)")
    for fn in _build.COUNTED:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    graphed = encdec_greedy(srv, params, cross, AUDIO_DECODE_TOKENS, graphed=True, trace=True)
    peak = torch.cuda.max_memory_allocated()
    launches = {fn.__name__: fn.launches for fn in _build.COUNTED if fn.launches}
    eager = encdec_greedy(srv, params, cross, AUDIO_DECODE_TOKENS, graphed=False)
    ticks = AUDIO_DECODE_TOKENS + 4
    # no flash_attention launch in a tick: the cross read is flash_decode
    want = {"flash_decode": cfg.num_layers * ticks,
            "paged_decode_attention": cfg.num_layers * ticks}
    print(f"  decode: {AUDIO_DECODE_TOKENS} greedy tokens a row, {AUDIO_ROWS} rows, "
          f"{AUDIO_CONTEXT}-slot context, pages of 64: graphed "
          f"{graphed[2] * 1e3 / (AUDIO_DECODE_TOKENS - 1):.3f} ms/tick, eager "
          f"{eager[2] * 1e3 / (AUDIO_DECODE_TOKENS - 1):.3f} ms/tick (ticks 2-"
          f"{AUDIO_DECODE_TOKENS}); graphed launches {launches} (expected {want}); peak "
          f"{peak / 2**30:.2f} GiB")
    split = graphed[3]
    print("  decode tick device time (4 graphed ticks traced): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
          + " (paged = self-attention, flash = the cross read, flash_decode); busy "
          f"{sum(split.values()):.4f} ms a tick")
    print(f"  first row's tokens: {graphed[0][0].tolist()}")
    if not np.array_equal(graphed[0], eager[0]):
        fail("serve-audio: graphed and eager token streams differ")
    if launches != want:
        fail(f"serve-audio: graphed decode launches {launches} != {want}")
    if not bool(torch.isfinite(graphed[1]).all()):
        fail("serve-audio: non-finite logits")
    print("  graphed == eager over the 64 tokens")
    del params, cross, frames, graphed, eager
    gc.collect()
    torch.cuda.empty_cache()
    # (b) PlanServer, prefill=False: decode from a zero cache
    srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
    served = serve_passes(srv, cfg, decode_kernel="paged", requests=AUDIO_SERVE_REQUESTS)
    measured_peaks(srv, AUDIO_SERVE_REQUESTS, prefill=False)
    trace_decode(srv, [ServeRequest(b, c, new_tokens=SERVE_NEW_TOKENS)
                       for b, c in AUDIO_SERVE_REQUESTS])
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  serve-audio: {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention_d64": enc_launches,
            "flash_decode": want["flash_decode"] + served["flash_decode"],
            "paged_decode_attention_g1_d64": (want["paged_decode_attention"]
                                              + served["paged_decode_attention"])}


def _flash_per_forward(cfg) -> int:
    """Flash training-forward launches of one forward: each layer's
    self-attention, and an encoder-decoder's encoder layers and cross
    attention."""
    return cfg.num_layers + (cfg.encoder_layers + cfg.num_layers if cfg.is_encdec else 0)


def phase_train_check_encdec(arch: str) -> None:
    cfg = _encdec_cfg(arch, ENCDEC_CHECK_LAYERS)
    train_check_on_card(cfg, f"train-check-{cfg.family}: {arch} widths, {ENCDEC_CHECK_LAYERS} "
                             "layers")


def phase_train_encdec(arch: str) -> None:
    """The full model at its training shape. MFU counts 6 N tokens: the
    encoder's parameters over its frames, the rest over the positions the
    decoder reads, a vision prefix included."""
    cfg = _encdec_cfg(arch)
    b, s = VLM_TRAIN_SHAPE if cfg.family == "vlm" else AUDIO_TRAIN_SHAPE
    n_enc = sum(math.prod(sh) for k, (sh, _dt) in build_model(cfg).sb.shapes().items()
                if k.startswith("e."))
    n = cfg.param_count() - n_enc
    flops = 6.0 * (n * b * (s + cfg.num_frontend_tokens) + n_enc * b * cfg.encoder_seq)
    where = (f" after its {cfg.num_frontend_tokens}-token patch prefix" if cfg.family == "vlm"
             else f" over {cfg.encoder_seq} frames")
    phase(train_title(f"train-{cfg.family}: {arch} at full depth{where}", b, s))
    train_on_card(cfg, InputShape(f"train-{cfg.family}", s, b, "train"), f"train-{cfg.family}",
                  flops,
                  f"over {cfg.param_count() / 1e9:.3f} B parameters, the encoder's over its "
                  "frames, a vision prefix counted")


# ---------------------------------------------------------------------------
# the multi-device phases: SHARDED_WORLD ranks on the one card
# ---------------------------------------------------------------------------


def on_ranks(fn, *args) -> list:
    """``fn(rank, world, *args)`` on SHARDED_WORLD ranks of the card
    (``launch/ranks.run_ranks``: one process group, gloo since the ranks
    share the card, a file rendezvous in a directory under ``build/``);
    prints each rank's output and returns each rank's result. A rank that
    exits non-zero, gives no result or outlives SHARDED_TIMEOUT_S fails the
    phase."""
    work = ROOT / "build" / f"ranks-{fn.__name__}-{time.time_ns()}"
    outs = run_ranks(fn, SHARDED_WORLD, work, "cuda", *args, timeout=SHARDED_TIMEOUT_S)
    for r in range(SHARDED_WORLD):
        for line in (work / f"rank{r}.log").read_text().splitlines():
            print(f"  [rank {r}] {line}")
    shutil.rmtree(work, ignore_errors=True)
    return outs


def _rank_setup() -> dict:
    """A rank's settings on the card (TF32 off, as in this process) and
    where it runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"backend": str(dist.get_backend()), "world": dist.get_world_size(),
            "device": torch.cuda.get_device_name(torch.cuda.current_device()),
            "cuda_index": torch.cuda.current_device()}


def _check_ranks(label: str, outs: list) -> None:
    for r, out in enumerate(outs):
        info = out["rank"]
        print(f"  rank {r}: backend {info['backend']}, world {info['world']}, "
              f"{info['device']} (cuda:{info['cuda_index']})")
        if info["world"] < 2 or info["world"] != SHARDED_WORLD or info["backend"] != "gloo":
            fail(f"{label}: rank {r} ran in a world of {info['world']} over {info['backend']}")
        if not all(dev == "cuda" for dev in out["devices"]):
            fail(f"{label}: rank {r} ran off the card: {out['devices']}")


def _parfor_rank(rank, world, spec, meta, params, x):
    """Remote parfor scoring of LeNet through ``Keras2Plan(mesh=...)``: the
    gathered probabilities, the plan, this rank's kernel launches, and the
    collectives in traces of the parfor'd scoring (no reduction, and mean)."""
    info = _rank_setup()
    mesh = make_local_mesh("cuda")
    est = Keras2Plan(spec, meta, mesh=mesh)
    est.params = nn_params_from_numpy(params, torch.float32, "cuda")
    est.predict_proba(x[:PARFOR_ROWS // 8])       # warm-up
    torch.cuda.synchronize()
    comm.reset_stats()
    CONV.conv2d_im2col.launches = MM.matmul.launches = 0
    t0 = time.perf_counter()
    probs = est.predict_proba(x)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"conv2d_im2col": CONV.conv2d_im2col.launches, "matmul": MM.matmul.launches}
    calls = dict(comm.STATS["calls"])
    rows = torch.from_numpy(x).cuda()

    def score(r):
        return est.module.predict(est.params, r)

    body = make_fx(lambda r: parfor(score, r, mesh=mesh)[0])(rows).code
    mean = make_fx(lambda r: parfor(score, r, mesh=mesh, reduce="mean")[0])(rows).code
    return {"plan": est._last_score_plan, "probs": probs, "ms": ms, "launches": launches,
            "gather_calls": calls, "body_collectives": count_collectives(body),
            "mean_collectives": count_collectives(mean),
            "rank": info, "devices": [p.device.type for layer in est.params for p in layer]}


def parfor_inputs(weights) -> tuple:
    """parfor's work: LeNet (phase 9's ``weights``) and PARFOR_ROWS seeded
    images, and one process's ``predict_proba`` of them: ``(the ranks'
    arguments, the reference)``."""
    spec, meta = make_spec()
    x, _y = synthetic_images(PARFOR_ROWS, num_classes=10, size=28, seed=SEED + 2)
    one = Keras2Plan(spec, meta)
    one.params = [tuple(torch.from_numpy(a).cuda() for a in layer) for layer in weights]
    return (spec, meta, weights, x), one.predict_proba(x)


def phase_parfor(outs, want) -> None:
    """parfor: LeNet scores PARFOR_ROWS images through
    ``Keras2Plan(mesh=make_local_mesh())`` on SHARDED_WORLD ranks of the card
    (the ranks' ``parfor`` results of the train-sharded session); held
    against one process's ``predict_proba``."""
    phase(f"parfor: remote parfor scoring of LeNet (phase 9's weights) on {PARFOR_ROWS} "
          f"images, {SHARDED_WORLD} ranks on the card over gloo (two ranks share one card: "
          f"this measures the code path, not scaling), first in train-sharded's rank session")
    outs = [out["parfor"] for out in outs]
    _check_ranks("parfor", outs)
    n = PARFOR_ROWS // SHARDED_WORLD
    for r, out in enumerate(outs):
        err = check_close(f"rank {r} gathered probabilities vs one process", torch.from_numpy(
            out["probs"]), torch.from_numpy(want), FP32_TOL)
        same = bool((out["probs"].argmax(axis=1) == want.argmax(axis=1)).all())
        print(f"  rank {r}: plan {out['plan']}, scored its {n} rows and gathered all in "
              f"{out['ms']:.2f} ms; launches {out['launches']} (expected 2 conv + 2 matmul for "
              f"its block); collectives in the traced body {out['body_collectives']}, with "
              f"reduce='mean' {out['mean_collectives']}; the scoring's collectives "
              f"{out['gather_calls']} (the gather of the rows, after the body; nothing staged: "
              f"gloo takes all ops on CUDA tensors); max_abs_err {err:.3e}, "
              f"argmax equal {same}")
        if out["plan"] != "remote":
            fail(f"parfor: rank {r} planned {out['plan']}")
        if not same:
            fail(f"parfor: rank {r}'s argmax differs from one process's")
        if out["launches"] != {"conv2d_im2col": 2, "matmul": 2}:
            fail(f"parfor: rank {r} launched {out['launches']}")
        if out["body_collectives"] != 0 or out["mean_collectives"] != 1:
            fail(f"parfor: rank {r}'s traces hold {out['body_collectives']} and "
                 f"{out['mean_collectives']} collectives, expected 0 and 1")


def _sharded_train_run(model, cfg, plan, mesh_cfg, opt, shape, init, lr, dtype,
                       steps=TRAIN_CHECK_STEPS, clip=1.0) -> tuple:
    """``steps`` steps of ``make_train_step`` over the ranks from ``init``
    (full tensors, the same on every rank, or a function that makes them:
    then the full tensors are gone before the peak is measured), each rank
    holding what the plan gives it: (per-step metrics and seconds, this
    rank's parameters, launches, collective calls and bytes per step, peak
    memory, the parameters' devices)."""
    local = shard_params(init() if callable(init) else init, model, plan, mesh_cfg)
    state = init_opt_state(opt, local, plan)
    step = make_train_step(model, plan, mesh_cfg,
                           TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in _build.COUNTED:
        fn.launches = 0
    comm.reset_stats()
    recs = []
    for i in range(steps):
        batch = make_batch(cfg, shape, step=i, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, state, met = step(local, state, batch, i)
        rec = {k: float(v) for k, v in met.items()}
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
    peak = torch.cuda.max_memory_allocated()
    launches = {fn.__name__: fn.launches for fn in _build.COUNTED}
    per_step = {k: {op: n / steps for op, n in c.items()} for k, c in comm.STATS.items()}
    devices = sorted({t.device.type for t in local.values()})
    del state
    return recs, local, launches, per_step, peak, devices


def _sharded_check(rank, world, arch, cut) -> dict:
    """train-sharded (a): ``arch``'s widths cut as ``cut``, float32, 3 Adam
    steps on SHARDED_CHECK_SHAPE under the planner's FSDP and DP plans for
    the ranks' data mesh, against one process's ``make_train_step`` under
    the train-check tolerances; launches exact. Each rank runs the one
    process's steps too, and holds its own parameters (its blocks under
    FSDP) against the same part of that run's."""
    cfg = replace(get_config(arch), **cut)
    pattern = cfg.layer_pattern()
    b, s = SHARDED_CHECK_SHAPE
    shape = InputShape("train-sharded-check", s, b, "train")
    model = build_model(cfg, dtype=torch.float32)
    init = trainable_params(model, SEED)
    lr = TRAIN_CHECK_LR["adam"]
    one_plan = compile_plan(cfg, shape, MeshConfig((1,), ("data",)), TrainConfig(),
                            dtype="float32").config
    want_recs, want_params, _ = _train_run(model, cfg, one_plan, "adam", shape, init, lr=lr)
    mesh_cfg = MeshConfig((world,), ("data",))
    out = {}
    for strategy in ("fsdp_tensor_parallel", "data_parallel"):
        plan = compile_plan(cfg, shape, mesh_cfg, TrainConfig(force_strategy=strategy),
                            dtype="float32").config
        t0 = time.perf_counter()
        recs, local, launches, per_step, _peak, devices = _sharded_train_run(
            model, cfg, plan, mesh_cfg, "adam", shape, init, lr, torch.float32)
        secs = time.perf_counter() - t0
        expect = _scan_launches(pattern, plan, TRAIN_CHECK_STEPS)
        got = {k: launches[k] for k in expect}
        if got != expect:
            fail(f"train-sharded {arch} {strategy}: rank {rank} launches {got}, expected {expect}")
        _same_trajectory(f"rank {rank}: {arch} {len(pattern)} layers, {plan.strategy.value} "
                         f"(params over data {plan.params_over_data}) over {world} ranks vs one "
                         f"process", "adam", (recs, local, launches),
                         (want_recs, shard_params(want_params, model, plan, mesh_cfg, rank), None),
                         lr=lr)
        out[strategy] = {"launches": got, "collectives": per_step, "devices": devices,
                         "losses": [r["loss"] for r in recs], "seconds": secs}
        del local
    del init, want_params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sharded_run(rank, world, layers) -> dict:
    """train-sharded (b): Yi-6B's full widths at ``layers`` layers, bfloat16,
    SHARDED_TRAIN_SHAPE, TRAIN_STEPS Adam steps at TRAIN_LR (clip 1.0) under
    the planner's FSDP plan for the ranks' data mesh."""
    cfg = replace(get_config("yi-6b"), num_layers=layers)
    b, s = SHARDED_TRAIN_SHAPE
    shape = InputShape("train-sharded", s, b, "train")
    mesh_cfg = MeshConfig((world,), ("data",))
    plan = compile_plan(cfg, shape, mesh_cfg, TrainConfig(force_strategy="fsdp_tensor_parallel"),
                        dtype="bfloat16")
    model = build_model(cfg, dtype=torch.bfloat16)
    init = trainable_params(model, SEED)
    recs, local, launches, per_step, peak, devices = _sharded_train_run(
        model, cfg, plan.config, mesh_cfg, "adam", shape, init, TRAIN_LR, torch.bfloat16,
        steps=TRAIN_STEPS)
    del init, local
    return {"recs": recs, "launches": launches, "collectives": per_step, "peak": peak,
            "devices": devices, "estimate": plan.memory.total,
            "plan": (plan.config.strategy.value, plan.config.opt_state_dtype, plan.config.remat,
                     plan.config.microbatches)}


def _sharded_rank(rank, world, layers, parfor_args) -> dict:
    """parfor's scoring, then train-sharded (a) and (b), in one rank
    session (one start-up of the ranks for both phases)."""
    scored = _parfor_rank(rank, world, *parfor_args)
    info = _rank_setup()
    checks = {arch: _sharded_check(rank, world, arch, cut) for arch, cut in SHARDED_CHECKS}
    run = _sharded_run(rank, world, layers)
    devices = run["devices"] + [d for c in checks.values() for v in c.values()
                                for d in v["devices"]]
    return {"checks": checks, "run": run, "devices": devices, "rank": info, "parfor": scored}


def sharded_depth(world: int) -> tuple:
    """The Yi-6B depth of train-sharded (b): the planner's per-card estimate
    for mesh (world,) at each of SHARDED_DEPTHS, and the deepest whose
    ``world`` ranks fit the card at 3/4 of its memory with a CUDA context
    each."""
    b, s = SHARDED_TRAIN_SHAPE
    card = torch.cuda.get_device_properties(0).total_memory
    est = {}
    for layers in SHARDED_DEPTHS:
        cfg = replace(get_config("yi-6b"), num_layers=layers)
        est[layers] = compile_plan(cfg, InputShape("train-sharded", s, b, "train"),
                                   MeshConfig((world,), ("data",)),
                                   TrainConfig(force_strategy="fsdp_tensor_parallel"),
                                   dtype="bfloat16").memory.total
    fits = [n for n in est if world * (est[n] + CUDA_CONTEXT_BYTES) <= 0.75 * card]
    if not fits:
        fail(f"train-sharded: no depth of {SHARDED_DEPTHS} fits {world} ranks on the card")
    return est, max(fits)


def phase_train_sharded(lenet_weights) -> dict:
    """parfor and train-sharded, whose ranks run in one session."""
    b, s = SHARDED_TRAIN_SHAPE
    parfor_args, parfor_want = parfor_inputs(lenet_weights)
    gc.collect()
    torch.cuda.empty_cache()
    est, layers = sharded_depth(SHARDED_WORLD)
    t0 = time.perf_counter()
    outs = on_ranks(_sharded_rank, layers, parfor_args)
    phase_parfor(outs, parfor_want)
    phase(f"train-sharded: {SHARDED_WORLD} ranks on the card over gloo (two ranks share one "
          f"card: this measures the code path, not scaling), the parfor phase's rank session "
          f"({time.perf_counter() - t0:.1f} s for both): (a) float32 checks at "
          f"{', '.join(a for a, _c in SHARDED_CHECKS)} widths, 2 layers, global batch "
          f"{SHARDED_CHECK_SHAPE}, {TRAIN_CHECK_STEPS} adam steps under FSDP and DP against one "
          f"process; (b) full Yi-6B widths, bfloat16, ({b}, {s}), {TRAIN_STEPS} adam steps, FSDP")
    print("  planner's per-card estimate for mesh (2,), FSDP: " + ", ".join(
        f"{n} layers {v / 2**30:.2f} GiB" for n, v in est.items()))
    print(f"  depth of (b): {layers} layers, the deepest of {SHARDED_DEPTHS} whose "
          f"{SHARDED_WORLD} ranks with their CUDA contexts fit within 3/4 of the card")
    _check_ranks("train-sharded", outs)
    for r, out in enumerate(outs):
        for arch, runs in out["checks"].items():
            for strategy, res in runs.items():
                calls = {k: round(v, 1) for k, v in res["collectives"]["calls"].items()}
                print(f"  rank {r} (a) {arch} {strategy}: {res['seconds']:.1f} s; losses "
                      f"{[round(x, 6) for x in res['losses']]}; launches {res['launches']}; "
                      f"collective calls a step {calls}")
    want = None
    for r, out in enumerate(outs):
        run = out["run"]
        strategy, state_dtype, remat, micro = run["plan"]
        losses = [x["loss"] for x in run["recs"]]
        secs = [x["seconds"] for x in run["recs"]]
        step_s = statistics.median(secs[2:8])
        want = layers * TRAIN_STEPS * (1 + remat) * micro
        flash = run["launches"]["flash_attention_train"]
        calls = {k: round(v, 1) for k, v in run["collectives"]["calls"].items()}
        mib = {k: round(v / 2**20, 1) for k, v in run["collectives"]["bytes"].items()}
        print(f"  rank {r} (b): plan {strategy}, opt state {state_dtype}, remat {remat}, "
              f"microbatches {micro}; losses {[round(x, 4) for x in losses]}; step seconds "
              f"{[round(x, 4) for x in secs]}")
        print(f"  rank {r} (b): step {step_s * 1e3:.1f} ms (median of steps 2-7), "
              f"{(b // SHARDED_WORLD) * s / step_s:.0f} tokens/s on this rank, {b * s / step_s:.0f} "
              f"over the ranks; peak {run['peak'] / 2**30:.2f} GiB against the planner's "
              f"per-card estimate {run['estimate'] / 2**30:.2f} GiB; collectives a step: calls "
              f"{calls}, MiB {mib}; flash_attention_train launches {flash} (expected {layers} "
              f"layers x {TRAIN_STEPS} steps x {1 + remat} x {micro} = {want}), "
              f"flash_attention_bwd {run['launches']['flash_attention_bwd']}")
        if flash != want:
            fail(f"train-sharded: rank {r} launched flash_attention_train {flash} times, "
                 f"expected {want}")
        check_bwd_launches(f"train-sharded: rank {r}", run["launches"], want, remat)
        if not all(math.isfinite(x) for x in losses):
            fail(f"train-sharded: rank {r} loss not finite: {losses}")
        if not statistics.mean(losses[-3:]) < losses[0]:
            fail(f"train-sharded: rank {r}: the mean of the last three losses "
                 f"{statistics.mean(losses[-3:])} is not below step 0's {losses[0]}")
    return {"flash_attention_train": want}


def _model_axis_check(rank, world, arch, cut, shape_bs, gain) -> dict:
    """train-model-axis (a): ``arch``'s widths cut as ``cut``, float32, 3 Adam
    steps on ``shape_bs`` under the planner's dp_tensor_parallel plan for
    MODEL_AXIS_MESH with seq_shard_checkpoints off and on, against one
    process's ``make_train_step`` under the train-check tolerances; the
    training kernels' launches on this rank exact (each on the rank's block
    of heads or channels). Each rank runs the one process's steps too, and
    holds its own blocks against the same part of that run's."""
    cfg = replace(get_config(arch), **cut)
    b, s = shape_bs
    shape = InputShape("train-model-axis-check", s, b, "train")
    model = build_model(cfg, dtype=torch.float32)
    init = trainable_params(model, SEED)
    if gain is not None:
        for k, v in init.items():
            if k.endswith((".ln1", ".xln")):
                v.mul_(gain)
    lr = TRAIN_CHECK_LR["adam"]
    one_plan = compile_plan(cfg, shape, MESH1, TrainConfig(), dtype="float32").config
    want_recs, want_params, _ = _train_run(model, cfg, one_plan, "adam", shape, init, lr=lr)
    base = compile_plan(cfg, shape, MODEL_AXIS_MESH,
                        TrainConfig(force_strategy="dp_tensor_parallel"), dtype="float32").config
    out = {}
    for sp in (False, True):
        plan = base.replace(seq_shard_checkpoints=sp)
        t0 = time.perf_counter()
        recs, local, launches, per_step, _peak, devices = _sharded_train_run(
            model, cfg, plan, MODEL_AXIS_MESH, "adam", shape, init, lr, torch.float32)
        secs = time.perf_counter() - t0
        expect = _scan_launches(cfg.layer_pattern(), plan, TRAIN_CHECK_STEPS)
        if cfg.is_encdec:
            expect["flash_attention_train"] = (_flash_per_forward(cfg) * TRAIN_CHECK_STEPS
                                               * plan.microbatches * (1 + plan.remat))
            expect["flash_attention_bwd"] = (_flash_per_forward(cfg) * TRAIN_CHECK_STEPS
                                             * plan.microbatches)
        got = {k: launches[k] for k in expect}
        label = f"{arch} {plan.strategy.value}{' +SP' if sp else ''}"
        if got != expect:
            fail(f"train-model-axis {label}: rank {rank} launches {got}, expected {expect}")
        _same_trajectory(f"rank {rank}: {arch} ({cfg.layer_pattern()}), {label} over "
                         f"{MODEL_AXIS_MESH.shape} vs one process", "adam",
                         (recs, local, launches),
                         (want_recs, shard_params(want_params, model, plan, MODEL_AXIS_MESH,
                                                  rank), None), lr=lr)
        out[label] = {"launches": got, "collectives": per_step, "devices": devices,
                      "losses": [r["loss"] for r in recs], "seconds": secs}
        del local
    del init, want_params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def model_axis_plan(cfg, shape) -> tuple:
    """(b) and (c)'s plan: the planner's fsdp_tensor_parallel plan for
    MODEL_AXIS_MESH with seq_shard_checkpoints, its optimizer state in
    float32, or compressed to bfloat16 (the planner's own knob) where the
    ranks would not fit 3/4 of the card with it; ``(plan, its per-card
    estimate, whether the ranks fit)``."""
    card = torch.cuda.get_device_properties(0).total_memory
    world = MODEL_AXIS_MESH.num_devices
    for state_dtype in ("float32", "bfloat16"):
        train = TrainConfig(force_strategy="fsdp_tensor_parallel", opt_state_dtype=state_dtype)
        plan = compile_plan(cfg, shape, MODEL_AXIS_MESH, train, dtype="bfloat16").config
        plan = plan.replace(seq_shard_checkpoints=True)
        est = estimate_memory(cfg, shape, MODEL_AXIS_MESH, plan, train, hw.H100,
                              "bfloat16").total
        fits = world * (est + CUDA_CONTEXT_BYTES) <= 0.75 * card
        if fits:
            break
    return plan, est, fits


def model_axis_collectives(cfg, b: int, s: int, layers: int, mp: int, micro: int) -> tuple:
    """The collective calls and bytes (each rank's contribution) one step of
    (b) or (c) makes on each rank: an attention stack (dense FFN or experts)
    under sequence parallelism with remat, heads, kv heads, ffn, experts and
    vocab split over the model axis, no data axis (so no metric or FSDP
    collectives), ``micro`` microbatches of ``b / micro`` rows, clipping on.
    Each microbatch's forward and backward, per layer: the forward gathers the
    sequence into attention and into the FFN (the MoE FFN routes the whole
    sequence: an AllGatherSlice) and reduce-scatters out of each; its
    recompute runs again up to its last saved activation (the experts'
    combine or the down projection), so all but its last reduce-scatter;
    its backward reduce-scatters each gather's gradient (an AllGatherSlice
    takes its block: none), all-gathers each reduce-scatter's, and
    all-reduces the gradients of the two norms' gains (on sequence shards)
    and, for experts, of the tokens and gates that enter them whole. Around
    the layers: the embedding's reduce-scatter (all-gather back), the gather
    into the logits (reduce-scatter back) and the final norm's gain; the
    vocab-parallel cross-entropy's max and its sums. Once a step: the
    clipping norm's max and sum."""
    d, act = cfg.d_model, 2                        # bfloat16 activations and gains
    moe, k = bool(cfg.num_experts), cfg.experts_per_token
    rows = b // micro
    shard, whole = rows * (s // mp) * d * act, rows * s * d * act
    ag, rs = 6 * layers + 2, (4 if moe else 5) * layers + 2
    ar = (4 if moe else 2) * layers + 3
    calls = {"all_gather": micro * ag, "reduce_scatter": micro * rs,
             "all_reduce": micro * ar + 2}
    nbytes = {"all_gather": micro * ag * shard, "reduce_scatter": micro * rs * whole,
              "all_reduce": micro * (3 * rows * s * 4 + (2 * layers + 1) * d * act
                                     + (layers * (whole + rows * s * k * act) if moe else 0))
              + 2 * 4}
    return calls, nbytes


def _model_axis_run(rank, world, arch, layers) -> dict:
    """train-model-axis (b) and (c): ``arch``'s full widths at ``layers``
    layers, bfloat16, SHARDED_TRAIN_SHAPE, TRAIN_STEPS Adam steps at TRAIN_LR
    (clip 1.0) under :func:`model_axis_plan`, from trainable_params."""
    cfg = replace(get_config(arch), num_layers=layers)
    b, s = SHARDED_TRAIN_SHAPE
    shape = InputShape("train-model-axis", s, b, "train")
    plan, estimate, fits = model_axis_plan(cfg, shape)
    if not fits:
        raise RuntimeError(f"train-model-axis: {arch} at {layers} layers does not fit "
                           f"{world} ranks on the card")
    model = build_model(cfg, dtype=torch.bfloat16)
    # the full weights only while this rank takes its blocks: its peak is
    # the step's (a full-width Qwen3-MoE layer's weights are 6.9 GiB)
    recs, local, launches, per_step, peak, devices = _sharded_train_run(
        model, cfg, plan, MODEL_AXIS_MESH, "adam", shape, lambda: trainable_params(model, SEED),
        TRAIN_LR, torch.bfloat16, steps=TRAIN_STEPS)
    shapes = {k: tuple(v.shape) for k, v in local.items() if not k.startswith("l.")}
    del local
    gc.collect()
    torch.cuda.empty_cache()
    return {"recs": recs, "launches": launches, "collectives": per_step, "peak": peak,
            "devices": devices, "estimate": estimate, "shapes": shapes,
            "plan": (plan.strategy.value, plan.opt_state_dtype, plan.remat, plan.microbatches,
                     plan.tensor_parallel, plan.expert_parallel, plan.seq_shard_checkpoints)}


def _model_axis_rank(rank, world, layers) -> dict:
    info = _rank_setup()
    checks = {arch: _model_axis_check(rank, world, arch, cut, shape_bs, gain)
              for arch, cut, shape_bs, gain in MODEL_AXIS_CHECKS}
    runs = {"yi-6b": _model_axis_run(rank, world, "yi-6b", layers),
            MOE_ARCH: _model_axis_run(rank, world, MOE_ARCH, MOE_MODEL_AXIS_LAYERS)}
    serve_checks = {arch: _serve_axis_check(rank, arch, cut) for arch, cut in SERVE_AXIS_CHECKS}
    serve = _serve_axis_run(rank)
    devices = [d for r in runs.values() for d in r["devices"]] + [
        d for c in checks.values() for v in c.values() for d in v["devices"]] + [
        d for c in serve_checks.values() for d in c["devices"]] + serve["devices"]
    return {"checks": checks, "runs": runs, "serve_checks": serve_checks, "serve": serve,
            "devices": devices, "rank": info}


def serve_axis_plan(cfg) -> PlanConfig:
    """The planner's DP_TP serve layout for MODEL_AXIS_MESH
    (``core/planner.py::_serve_candidates``): tensor parallelism (experts
    over the model axis for MoE), the cache on kv heads where they split
    the model axis (an SSM's state on its heads), else along its
    sequence."""
    mp = MODEL_AXIS_MESH.model_parallelism
    kv = cfg.num_kv_heads
    heads = cfg.family == "ssm" or (kv >= mp and kv % mp == 0)
    return PlanConfig(strategy=Strategy.DP_TP, batch_axes=("data",), cache_batch_axes=("data",),
                      tensor_parallel=True, expert_parallel=bool(cfg.num_experts),
                      cache_heads_over_model=heads, cache_seq_axes=() if heads else ("model",),
                      remat=False, microbatches=1)


def _paged(model, cache: dict, page: int) -> tuple:
    """A dense decode cache's attention K/V as paged slot stacks, row r's
    pages the r-th run of them, and the page table that reads them."""
    key = next((k for k in cache if model.is_paged_cache_key(k)), None)
    if key is None:
        return cache, None
    rows, sc = cache[key].shape[1], cache[key].shape[2]
    out = {k: (v.reshape(v.shape[0], rows * sc, *v.shape[3:]) if model.is_paged_cache_key(k)
               else v) for k, v in cache.items()}
    tables = torch.arange(rows * (sc // page), dtype=torch.int32,
                          device=cache[key].device).view(rows, -1)
    return out, tables


def _serve_stream(model, params, batch, cache_len, new_tokens, ctx_kw, paged) -> dict:
    """A prompt pass then ``new_tokens`` greedy ticks (paged through the
    kernel, or dense), one process's or this rank's under ``ctx_kw``
    (``plan``, ``mesh_cfg``, ``groups``): the stream, the prompt pass's
    logits and each tick's (float32, host), seconds, collectives and
    kernel launches of each part, and the prompt pass's peak memory."""
    out = {}
    for fn in _build.COUNTED:
        fn.launches = 0
    comm.reset_stats()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, cache = make_prefill(model, **ctx_kw)(params, batch)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_peak"] = torch.cuda.max_memory_allocated()
    out["prefill_collectives"] = {k: dict(c) for k, c in comm.STATS.items()}
    out["prefill_launches"] = {fn.__name__: fn.launches for fn in _build.COUNTED}
    page = SERVE_AXIS_PAGE if paged else 0
    tables = None
    if paged:
        cache, tables = _paged(model, cache, page)
    step = make_decode_step(model, page=page, seq_len=cache_len, decode_kernel="paged",
                            **ctx_kw)
    tok = torch.argmax(first, dim=-1).to(torch.int32)[:, None]
    pos = batch["lengths"].clone()
    stream, logits = [tok], []
    for fn in _build.COUNTED:
        fn.launches = 0
    comm.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        args = (params, cache, tok, pos) + ((tables,) if tables is not None else ())
        lg, cache = step(*args)
        logits.append(lg[:, -1].float().cpu())
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        stream.append(tok)
        pos = pos + 1
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    out["decode_collectives"] = {k: {op: n / new_tokens for op, n in c.items()}
                                 for k, c in comm.STATS.items()}
    out["decode_launches"] = {fn.__name__: fn.launches for fn in _build.COUNTED}
    out["stream"] = torch.cat(stream, dim=1).cpu().numpy()
    out["first"] = first.float().cpu()
    out["logits"] = torch.stack(logits)
    out["devices"] = sorted({t.device.type for t in cache.values()})
    del cache
    return out


def _serve_inputs(cfg, shape_bs, bucket_len, seed) -> dict:
    b, s = shape_bs
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(1, cfg.vocab_size, (b, bucket_len), generator=gen, device="cuda",
                           dtype=torch.int32)
    return {"tokens": tokens, "lengths": torch.full((b,), s, dtype=torch.int32, device="cuda")}


def _serve_axis_check(rank, arch, cut) -> dict:
    """serve-model-axis (a): ``arch`` (a -smoke twin, cut as ``cut``) in
    float32 from seeded weights, one process's prompt pass and greedy ticks
    on the whole model, then this rank's under :func:`serve_axis_plan`;
    paged through the kernel where the cache is on kv heads."""
    cfg = replace(get_config(arch), **cut)
    model = build_model(cfg, dtype=torch.float32)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    plan = serve_axis_plan(cfg)
    paged = cfg.family != "ssm" and plan.cache_heads_over_model
    batch = _serve_inputs(cfg, SERVE_AXIS_CHECK_SHAPE, SERVE_AXIS_CHECK_BUCKET, SEED + 1)
    with torch.no_grad():
        one = _serve_stream(model, params, batch, SERVE_AXIS_CHECK_BUCKET,
                            SERVE_AXIS_CHECK_TOKENS, {}, paged)
        local = shard_params(params, model, plan, MODEL_AXIS_MESH, rank)
        groups = mesh_groups(MODEL_AXIS_MESH, "cuda")
        mine = _serve_stream(model, local, batch, SERVE_AXIS_CHECK_BUCKET,
                             SERVE_AXIS_CHECK_TOKENS,
                             dict(plan=plan, mesh_cfg=MODEL_AXIS_MESH, groups=groups,
                                  device="cuda"), paged)
    del params, local
    return {"same": bool(np.array_equal(one["stream"], mine["stream"])),
            "stream": mine["stream"], "paged": paged, "plan": plan,
            "max_err": float((one["logits"] - mine["logits"]).abs().max()),
            "launches": {k: mine["prefill_launches"][k] + mine["decode_launches"][k]
                         for k in mine["decode_launches"]},
            "one_launches": {k: one["prefill_launches"][k] + one["decode_launches"][k]
                             for k in one["decode_launches"]},
            "decode_collectives": mine["decode_collectives"], "devices": mine["devices"]}


def _serve_axis_run(rank) -> dict:
    """serve-model-axis (b): full Yi-6B in bfloat16 from seeded
    :func:`trainable_params` (at the model's own scales the full depth's
    attention saturates, and bfloat16 rounding in another order sends the
    two streams apart from the first token). Rank 0 serves the whole model
    first (one card's stream); then each rank its blocks under
    :func:`serve_axis_plan`, paged through the kernel."""
    cfg = get_config("yi-6b")
    model = build_model(cfg, dtype=torch.bfloat16)
    plan = serve_axis_plan(cfg)
    batch = _serve_inputs(cfg, SERVE_AXIS_SHAPE, SERVE_AXIS_BUCKET, SEED + 2)
    out = {"plan": plan}
    with torch.no_grad():
        full = trainable_params(model, SEED)
        if rank == 0:
            out["one"] = _serve_stream(model, full, batch, SERVE_AXIS_BUCKET,
                                       SERVE_AXIS_TOKENS, {}, True)
        local = shard_params(full, model, plan, MODEL_AXIS_MESH, rank)
        del full
        groups = mesh_groups(MODEL_AXIS_MESH, "cuda")
        ctx_kw = dict(plan=plan, mesh_cfg=MODEL_AXIS_MESH, groups=groups, device="cuda")
        out["mine"] = _serve_stream(model, local, batch, SERVE_AXIS_BUCKET, SERVE_AXIS_TOKENS,
                                    ctx_kw, True)
    out["devices"] = out["mine"]["devices"]
    del local
    gc.collect()
    torch.cuda.empty_cache()
    return out


def model_axis_depth() -> tuple:
    """The Yi-6B depth of train-model-axis (b): :func:`model_axis_plan` at
    each of SHARDED_DEPTHS (its per-card estimate and optimizer-state
    dtype), and the deepest whose ranks fit the card at 3/4 of its memory
    with a CUDA context each."""
    b, s = SHARDED_TRAIN_SHAPE
    shape = InputShape("train-model-axis", s, b, "train")
    plans = {n: model_axis_plan(replace(get_config("yi-6b"), num_layers=n), shape)
             for n in SHARDED_DEPTHS}
    fits = [n for n, (_p, _e, ok) in plans.items() if ok]
    if not fits:
        fail(f"train-model-axis: no depth of {SHARDED_DEPTHS} fits "
             f"{MODEL_AXIS_MESH.num_devices} ranks on the card")
    return {n: (e, p.opt_state_dtype) for n, (p, e, _ok) in plans.items()}, max(fits)


def phase_train_model_axis() -> dict:
    b, s = SHARDED_TRAIN_SHAPE
    t_phase = time.perf_counter()
    phase(f"train-model-axis: {SHARDED_WORLD} ranks on the card as a {MODEL_AXIS_MESH.shape} "
          f"('data', 'model') mesh over gloo (two ranks share one card: this measures the code "
          f"path, not scaling): (a) float32 checks at "
          f"{', '.join(a for a, *_r in MODEL_AXIS_CHECKS)} widths, {TRAIN_CHECK_STEPS} adam "
          f"steps under dp_tensor_parallel, sequence parallelism off and on, against one "
          f"process; (b) full Yi-6B widths and (c) {MOE_ARCH} at {MOE_MODEL_AXIS_LAYERS} layer, "
          f"bfloat16, ({b}, {s}), {TRAIN_STEPS} adam steps, fsdp_tensor_parallel with sequence "
          f"parallelism")
    gc.collect()
    torch.cuda.empty_cache()
    est, layers = model_axis_depth()
    print(f"  planner's per-card estimate for mesh {MODEL_AXIS_MESH.shape}, FSDP_TP + SP: "
          + ", ".join(f"{n} layers {v / 2**30:.2f} GiB (opt state {dt})"
                      for n, (v, dt) in est.items()))
    print(f"  depth of (b): {layers} layers, the deepest of {SHARDED_DEPTHS} whose "
          f"{SHARDED_WORLD} ranks with their CUDA contexts fit within 3/4 of the card")
    # the dry run's traces need no card: they run here while the ranks do
    with ThreadPoolExecutor(1) as pool:
        dry_future = pool.submit(dry_run_model_axis, layers)
        outs = on_ranks(_model_axis_rank, layers)
        dry, dry_s = dry_future.result()
    print(f"  dry run of train-model-axis (b), (c) and serve-model-axis (b): {dry_s:.1f} s of "
          f"tracing on fake cuda tensors, beside the ranks")
    _check_ranks("train-model-axis", outs)
    for r, out in enumerate(outs):
        for arch, runs in out["checks"].items():
            for label, res in runs.items():
                calls = {k: round(v, 1) for k, v in res["collectives"]["calls"].items()}
                print(f"  rank {r} (a) {label}: {res['seconds']:.1f} s; losses "
                      f"{[round(x, 6) for x in res['losses']]}; launches {res['launches']}; "
                      f"collective calls a step {calls}")
    launches = {}
    for arch, depth, part in (("yi-6b", layers, "b"), (MOE_ARCH, MOE_MODEL_AXIS_LAYERS, "c")):
        cfg = replace(get_config(arch), num_layers=depth)
        for r, out in enumerate(outs):
            run = out["runs"][arch]
            strategy, state_dtype, remat, micro, tp, ep, sp = run["plan"]
            want_calls, want_bytes = model_axis_collectives(cfg, b, s, depth, SHARDED_WORLD,
                                                            micro)
            losses = [x["loss"] for x in run["recs"]]
            secs = [x["seconds"] for x in run["recs"]]
            step_s = statistics.median(secs[2:8])
            want = depth * TRAIN_STEPS * (1 + remat) * micro
            flash = run["launches"]["flash_attention_train"]
            calls = run["collectives"]["calls"]
            got_bytes = run["collectives"]["bytes"]
            mib = {k: round(v / 2**20, 3) for k, v in got_bytes.items()}
            aux = (f"; aux {[round(x['aux'], 4) for x in run['recs']]}" if cfg.num_experts
                   else "")
            print(f"  rank {r} ({part}) {arch} at {depth} layers: plan {strategy}, opt state "
                  f"{state_dtype}, remat {remat}, microbatches {micro}, tensor parallel {tp}, "
                  f"expert parallel {ep}, sequence parallel {sp}; embed {run['shapes']['embed']}"
                  f"; losses {[round(x, 4) for x in losses]}{aux}; step seconds "
                  f"{[round(x, 4) for x in secs]}")
            print(f"  rank {r} ({part}): step {step_s * 1e3:.1f} ms (median of steps 2-7), "
                  f"{b * s / step_s:.0f} tokens/s over the mesh; peak {run['peak'] / 2**30:.2f} "
                  f"GiB against the planner's per-card estimate {run['estimate'] / 2**30:.2f} "
                  f"GiB; collectives a step: calls {calls} (the plan implies {want_calls}), MiB "
                  f"{mib} (the plan implies "
                  f"{ {k: round(v / 2**20, 3) for k, v in want_bytes.items()} }); "
                  f"flash_attention_train launches {flash} (expected {depth} layers x "
                  f"{TRAIN_STEPS} steps x {1 + remat} x {micro} = {want}), "
                  f"flash_attention_bwd {run['launches']['flash_attention_bwd']}")
            if not (tp and sp and (ep == bool(cfg.num_experts))):
                fail(f"train-model-axis ({part}): rank {r} ran plan {run['plan']}")
            if calls != want_calls or got_bytes != want_bytes:
                fail(f"train-model-axis ({part}): rank {r}'s collectives a step {calls}, "
                     f"{got_bytes} B, the plan implies {want_calls}, {want_bytes} B")
            if flash != want:
                fail(f"train-model-axis ({part}): rank {r} launched flash_attention_train "
                     f"{flash} times, expected {want}")
            check_bwd_launches(f"train-model-axis ({part}): rank {r}", run["launches"], want,
                               remat)
            if run["peak"] > run["estimate"]:
                fail(f"train-model-axis ({part}): rank {r}'s peak {run['peak']} B is above the "
                     f"planner's per-card estimate {run['estimate']:.0f} B")
            if not all(math.isfinite(x) for x in losses):
                fail(f"train-model-axis ({part}): rank {r} loss not finite: {losses}")
            if not statistics.mean(losses[-3:]) < losses[0]:
                fail(f"train-model-axis ({part}): rank {r}: the mean of the last three losses "
                     f"{statistics.mean(losses[-3:])} is not below step 0's {losses[0]}")
        launches[arch] = want
    ratios = {}
    for arch, part in (("yi-6b", "b"), (MOE_ARCH, "c")):
        for r, rank_out in enumerate(outs):
            run = rank_out["runs"][arch]
            cost, counts = dry[(part, r)]
            ratios[(part, r)] = _hold_to_dry_run(
                f"dry run, train-model-axis ({part}) rank {r}", run["collectives"], counts,
                run["peak"], cost.memory["peak_estimate_bytes"], run["estimate"])
    print(f"  train-model-axis: {time.perf_counter() - t_phase:.1f} s")
    t_serve = time.perf_counter()
    launches = check_serve_model_axis(outs, dry, ratios)
    print(f"  serve-model-axis checks: {time.perf_counter() - t_serve:.1f} s")
    return launches


def dry_run_cost(model, plan: ExecutionPlan, rank: int, train=None):
    """The dry run's cost of ``rank``'s step of ``plan`` on
    MODEL_AXIS_MESH (``launch/dryrun.py``'s trace: fake ``cuda`` tensors of
    the rank's blocks, collectives counted over trace groups), traced at
    ``model``'s depth: ``(GraphCost, collective counts)``."""
    coord = tuple(int(c) for c in np.unravel_index(rank, MODEL_AXIS_MESH.shape))
    trace = plan_audit.trace_cell(model, plan, plan.shape.kind, plan.shape.global_batch,
                                  plan.shape.seq_len, mesh=TracedMesh(MODEL_AXIS_MESH, coord),
                                  train=train, device="cuda")
    if trace.gm is None:
        fail(f"dry run: the {plan.shape.kind} step did not trace: {trace.error}")
    return graph_analysis.analyze(trace.gm, trace.collectives), trace.collectives


def _hold_to_dry_run(label: str, got: dict, want: dict, peak, dry_peak, estimate) -> float:
    """A rank's counted collective calls and bytes equal to the dry run's;
    its measured peak within PEAK_RATIO_BOUNDS of the dry run's; printed
    beside the planner's estimate. Returns the ratio."""
    keep = ("calls", "bytes")
    got = {k: {op: n for op, n in got[k].items() if n} for k in keep}
    want = {k: {op: n for op, n in want[k].items() if n} for k in keep}
    ratio = peak / dry_peak
    est = f"{estimate / 2**30:.2f} GiB" if estimate else "none"
    print(f"  {label}: collectives counted {got}, dry run {want}; peak measured "
          f"{peak / 2**30:.3f} GiB, dry run {dry_peak / 2**30:.3f} GiB (ratio {ratio:.3f}), "
          f"planner's estimate {est}")
    if got != want:
        fail(f"{label}: the dry run's collectives {want} differ from the counted {got}")
    if not PEAK_RATIO_BOUNDS[0] <= ratio <= PEAK_RATIO_BOUNDS[1]:
        fail(f"{label}: measured peak / dry run's {ratio:.3f} outside {PEAK_RATIO_BOUNDS}")
    return ratio


def dry_run_model_axis(layers) -> tuple:
    """The dry run of each rank's step in train-model-axis (b) and (c)
    (their plans and shapes, at their depths) and of serve-model-axis
    (b)'s prompt pass and tick: ``({(part, rank): (GraphCost, counts)},
    seconds)``."""
    t0 = time.perf_counter()
    b, s = SHARDED_TRAIN_SHAPE
    shape = InputShape("train-model-axis", s, b, "train")
    train = TrainConfig(optimizer="adam", learning_rate=TRAIN_LR, grad_clip=1.0)
    out = {}
    for arch, depth, part in (("yi-6b", layers, "b"), (MOE_ARCH, MOE_MODEL_AXIS_LAYERS, "c")):
        cfg = replace(get_config(arch), num_layers=depth)
        plan = model_axis_plan(cfg, shape)[0]
        model = build_model(cfg, dtype=torch.bfloat16)
        eplan = ExecutionPlan(model=cfg, shape=shape, mesh=MODEL_AXIS_MESH, config=plan)
        for r in range(MODEL_AXIS_MESH.num_devices):
            out[(part, r)] = dry_run_cost(model, eplan, r, train)
    cfg = get_config("yi-6b")
    model = build_model(cfg, dtype=torch.bfloat16)
    for kind in ("prefill", "decode"):
        eplan = ExecutionPlan(model=cfg, shape=InputShape(f"serve-model-axis-{kind}",
                                                          SERVE_AXIS_BUCKET,
                                                          SERVE_AXIS_SHAPE[0], kind),
                              mesh=MODEL_AXIS_MESH, config=serve_axis_plan(cfg))
        for r in range(MODEL_AXIS_MESH.num_devices):
            out[(f"serve-{kind}", r)] = dry_run_cost(model, eplan, r)
    return out, time.perf_counter() - t0


def check_serve_model_axis(outs, dry: dict, ratios: dict) -> dict:
    """serve-model-axis: (a) each rank's float32 stream == one process's,
    launches exact; (b) full Yi-6B against one card, held to the dry run;
    returns (b)'s kernel launches summed over the ranks (the kernels line's
    Yi-6B shapes; (a)'s -smoke shapes are not that line's)."""
    phase(f"serve-model-axis: the same {SHARDED_WORLD} ranks as a {MODEL_AXIS_MESH.shape} "
          f"('data', 'model') mesh under the planner's DP_TP serve layout: (a) float32 "
          f"{', '.join(a for a, _c in SERVE_AXIS_CHECKS)}, {SERVE_AXIS_CHECK_SHAPE} prompts in "
          f"the {SERVE_AXIS_CHECK_BUCKET} bucket, {SERVE_AXIS_CHECK_TOKENS} greedy tokens, "
          f"against one process; (b) full Yi-6B in bfloat16, a {SERVE_AXIS_SHAPE} prompt in the "
          f"{SERVE_AXIS_BUCKET} bucket, {SERVE_AXIS_TOKENS} greedy tokens through the paged "
          f"kernel, against one card")
    launches: dict = {}
    for arch, cut in SERVE_AXIS_CHECKS:
        cfg = replace(get_config(arch), **cut)
        attn = cfg.layer_pattern().count("a")
        for r, out in enumerate(outs):
            res = out["serve_checks"][arch]
            plan = res["plan"]
            want = {"flash_attention": attn, "paged_decode_attention":
                    attn * SERVE_AXIS_CHECK_TOKENS if res["paged"] else 0,
                    "ssd_scan": cfg.layer_pattern().count("s"),
                    "rglru_scan": cfg.layer_pattern().count("r")}
            got = {k: res["launches"][k] for k in want}
            calls = {k: round(v, 2) for k, v in res["decode_collectives"]["calls"].items()}
            print(f"  rank {r} (a) {arch} ({cfg.layer_pattern()}): cache "
                  f"{'on kv heads' if plan.cache_heads_over_model else 'along its sequence'}"
                  f", decode {'paged' if res['paged'] else 'dense'}; stream == one process: "
                  f"{res['same']}; max |logit diff| {res['max_err']:.3e}; launches {got}; "
                  f"collective calls a tick {calls}")
            if not res["same"]:
                fail(f"serve-model-axis (a) {arch}: rank {r}'s stream differs from one "
                     f"process's")
            if got != want:
                fail(f"serve-model-axis (a) {arch}: rank {r} launches {got}, expected {want}")
    cfg = get_config("yi-6b")
    one = outs[0]["serve"]["one"]
    for r, out in enumerate(outs):
        mine = out["serve"]["mine"]
        same = mine["stream"] == one["stream"]
        agree = int(same.sum())
        # tick t reads token t: its logits are comparable while every row's
        # tokens so far agree
        ticks = SERVE_AXIS_TOKENS if same.all() else int(np.argmin(same.all(axis=0)))
        ok_first, first_err, _r, first_rms = within(mine["first"], one["first"],
                                                    SERVE_AXIS_BF16_TOL)
        tick_checks = [within(mine["logits"][t], one["logits"][t], SERVE_AXIS_BF16_TOL)
                       for t in range(ticks)]
        ok_ticks = all(c[0] for c in tick_checks)
        tick_err = max([c[1] for c in tick_checks] or [0.0])
        tick_rms = max([c[3] for c in tick_checks] or [0.0])
        pre = {k: {op: n for op, n in c.items() if n} for k, c in
               mine["prefill_collectives"].items() if k != "traffic"}
        dec = {k: {op: round(n, 3) for op, n in c.items() if n} for k, c in
               mine["decode_collectives"].items() if k != "traffic"}
        flash = mine["prefill_launches"]["flash_attention"]
        paged = mine["decode_launches"]["paged_decode_attention"]
        print(f"  rank {r} (b) Yi-6B, 16 of 32 q heads and 2 of 4 kv heads: prefill "
              f"{mine['prefill_s'] * 1e3:.1f} ms (one card {one['prefill_s'] * 1e3:.1f} ms); "
              f"decode {mine['decode_s'] / SERVE_AXIS_TOKENS * 1e3:.2f} ms/step (one card "
              f"{one['decode_s'] / SERVE_AXIS_TOKENS * 1e3:.2f}); {agree} of "
              f"{one['stream'].size} tokens agree with one card's stream (every row's through "
              f"tick {ticks}); prompt-pass logits max |diff| {first_err:.3e}, error RMS / "
              f"RMS {first_rms:.3e}; those ticks' max |diff| {tick_err:.3e}, error RMS / RMS "
              f"up to {tick_rms:.3e}; collectives: "
              f"prompt pass {pre}, a tick {dec}; flash launches {flash} (expected "
              f"{cfg.num_layers}), paged {paged} (expected "
              f"{cfg.num_layers * SERVE_AXIS_TOKENS})")
        if not (ok_first and ok_ticks):
            fail(f"serve-model-axis (b): rank {r}'s logits differ from one card's beyond "
                 f"{SERVE_AXIS_BF16_TOL}")
        if flash != cfg.num_layers or paged != cfg.num_layers * SERVE_AXIS_TOKENS:
            fail(f"serve-model-axis (b): rank {r} launched flash {flash}, paged {paged}")
        pcost, pcounts = dry[("serve-prefill", r)]
        _dcost, dcounts = dry[("serve-decode", r)]
        ratios[("serve-b", r)] = _hold_to_dry_run(
            f"dry run, serve-model-axis (b) prompt pass rank {r}", mine["prefill_collectives"],
            pcounts, mine["prefill_peak"], pcost.memory["peak_estimate_bytes"], None)
        tick = {k: {op: n for op, n in mine["decode_collectives"][k].items() if n}
                for k in ("calls", "bytes")}
        if tick != {k: {op: n for op, n in dcounts[k].items() if n} for k in ("calls", "bytes")}:
            fail(f"serve-model-axis (b): rank {r}'s collectives a tick {tick} differ from the "
                 f"dry run's {dcounts}")
        print(f"  dry run, serve-model-axis (b) tick rank {r}: collectives == the dry run's "
              f"dense decode step's")
        launches["flash_attention"] = launches.get("flash_attention", 0) + flash
        launches["paged_decode_attention"] = launches.get("paged_decode_attention", 0) + paged
    print(f"  measured peak / dry run's peak: "
          + ", ".join(f"{k[0]} rank {k[1]} {v:.3f}" for k, v in ratios.items()))
    return launches


def phase_quickstart() -> None:
    phase("quickstart: the paper's softmax classifier through Keras2Plan on the card "
          "(repro_torch.launch.quickstart)")
    MM.matmul.launches = 0
    model, acc = quickstart.main([])
    launches = MM.matmul.launches
    steps = len(model.history)
    digest = hashlib.sha256(model.dml_script.encode()).hexdigest()
    print(f"  accuracy {acc:.4f} on {model.device}; {steps} steps; matmul launches {launches} "
          f"(expected one per step's affine forward and one scoring pass = {steps + 1}); "
          f"DML script sha256 {digest[:16]}... "
          f"{'== the reference' if digest == QUICKSTART_DML_SHA256 else '!= the reference'}")
    if digest != QUICKSTART_DML_SHA256:
        fail("quickstart: the generated DML script differs from the reference's")
    if launches != steps + 1:
        fail(f"quickstart: {launches} matmul launches, expected {steps + 1}")
    if not acc > 0.8:
        fail(f"quickstart: accuracy {acc} is not above 0.8")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    fit = fit_dispatch(kernels["paged_decode_attention"])
    phase_serve_check()
    launches = phase_serve(fit)
    phase_serve_router(phase_serve_engine())
    phase_serve_check_ssm()
    launches.update(phase_serve_ssm())
    phase_lenet_check()
    lenet_launches, lenet_weights = phase_lenet()
    launches.update(lenet_launches)
    phase_serve_check_hybrid()
    launches.update(phase_serve_hybrid())
    phase_serve_check_moe()
    launches.update(phase_serve_moe())
    phase_serve_check_vlm()
    launches.update(phase_serve_vlm())
    phase_serve_check_audio()
    launches.update(phase_serve_audio())
    phase_analysis()
    launches.update(phase_train_check())
    launches.update(phase_train())
    for family in ("ssm", "hybrid"):
        phase_train_check_recurrent(family)
        launches.update(phase_train_recurrent(family))
    phase_train_check_moe()
    phase_train_moe()
    for arch in (VLM_ARCH, AUDIO_ARCH):
        phase_train_check_encdec(arch)
        phase_train_encdec(arch)
    phase_train_sharded(lenet_weights)
    for name, n in phase_train_model_axis().items():
        launches[name] = launches.get(name, 0) + n
    phase_quickstart()
    for name, n in launches.items():
        kernels[name]["launches"] = n
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{key: kernels[n][key] for key in order}
                        for n in ("paged_decode_attention", "flash_attention", "ssd_scan",
                                  "matmul", "conv2d_im2col", "flash_attention_d256",
                                  "paged_decode_attention_g10_d256", "rglru_scan",
                                  "flash_attention_train", "ssd_scan_train", "ssd_scan_bwd",
                                  "rglru_scan_train", "rglru_scan_bwd", "flash_attention_bwd",
                                  "flash_attention_bwd_fp32", "flash_attention_train_fp32",
                                  "flash_attention_g16",
                                  "paged_decode_attention_g16", "flash_attention_d64",
                                  "flash_decode",
                                  "paged_decode_attention_g1_d64",
                                  "paged_decode_attention_g2")]}
    for entry in line["kernels"]:
        for key in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "library_ms"):
            if entry[key] is not None and not math.isfinite(entry[key]):
                fail(f"{entry['name']}: {key} is not finite")
    print(f"\nall phases passed in {time.perf_counter() - t0:.1f} s "
          f"({time.perf_counter() - _T0:.1f} s since start)")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
