#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. builds the four CUDA sources from ``src/repro_torch`` at once (one
   nvcc each, into ``build/``) and prints each build time and ptxas line,
   the PyTorch/CUDA versions and the card's name and power limit;
2. holds both rollout kernels (B1 generic, B2 specialized; each call one
   persistent cooperative launch of all T steps, the readout inside it)
   against their plain PyTorch twins on the card, on dim-256 / block-64
   matrices (one with whole zero blocks) and a sparse block-32 one with
   shift-add digits, over {fp32, int8} x {resident, pipelined} x batch
   {3, 16}, with readout and final state (B2 takes no band budget: its
   shares must equal, byte for byte, those of each regime's lowering);
3. drives the main serving path at ``LARGE_1024`` (dim 1024, int8-CSD):
   ``init_esn`` -> ``fit_readout`` -> an ``AsyncReservoirServer`` with 16
   slots answering a burst of 24 requests in 32-step chunks (five bursts,
   each on a fresh server), the same requests one-shot through
   ``submit_many`` (chunked must equal one-shot bit for bit), and through
   the generic kernel (``specialize=False``, must equal the specialized
   one bit for bit); a served chunk must be one B2 launch with the
   readout fused into it;
4. serves fp32 requests at ``PAPER_BASELINE`` (dim 800) with both kernels,
   then holds both against their twins at that shape (a ragged last
   column block);
6. drives the fixed-matrix multiplier path at full width on LARGE_1024's
   matrix: ``BitplaneGemv`` (B3) on the requantized int8 states of a
   rollout at batch 16 and 1 (== ``matvec_int_exact`` and the twin, bit
   for bit), ``BcsrMatmul`` (B4) on fp32 and bf16 states and on integer
   states over a unit-scale matrix (exact), ``FusedReservoir.run`` (B5)
   over 64 steps at batch 16 (vs its twin and the fp32 B1 rollout), the
   cross-family check of tests/test_plan.py at dim 256, and all three at
   PAPER_BASELINE's ragged dim 800;
8. ``autotune`` (after the timing phases): the plan autotuner on three
   matrices (LARGE_1024 int8, PAPER_BASELINE fp32, a banded dim-1024 int8
   matrix with 22 of 64 blocks kept) at batch 8 x 8 steps and batch 16 x
   32 steps: the card's prior's cold pick, then a measured tuning over
   both backends (every trial printed; the default among them, the
   winner no worse than it and on the cold pick's backend), the winner's
   states == the default schedule's (int8 bit for bit), the trials'
   cache replayed from a file with no launch, and the cost model refitted
   over all trials;
9. ``sharded`` (before ``serve_layer``): sharded serving at LARGE_1024
   int8 on 4 shards (one per card where 4 are visible, all 4 on the one
   card of a one-card machine): (a) ``ShardedReservoirEngine`` against
   ``ReservoirEngine`` at batch 16 and 13 (padded to 16) on B2, on B1 and
   at PAPER_BASELINE fp32 — states, finals and predictions bit for bit,
   one launch per shard per call — and the torch backend's sharded gap
   (within SERVE_TOL, printed); (b) a ``DistributedReservoirServer`` (4
   shards x 4 slots) answering phase 3's burst in 32-step chunks:
   least-loaded placement, one B2 launch per shard holding a live slot
   per chunk with the readout fused, every answer == the single-device
   engine's at the 16-slot pool shape, µs per chunk beside the 16-slot
   single-device server and B2's device time per chunk; (c) a fault-plan
   shard death (4 -> 3) then ``grow(1)``: zero drops, carried sequences,
   exact answers, each rebuild's ms; (d) an ``AutoscalePolicy`` growing
   a 1-shard server on the backlog and shrinking it as the tail drains,
   within the pool of 4; (e) ``ridge_fit_sharded`` over the 4 shards
   against ``ridge_fit`` (fitted values within RIDGE_TOL);
7. ``serve_layer`` (after the timing phases): the rest of the serve layer at
   LARGE_1024: (a) the ``"torch"`` backend against the ``"cuda"`` one (B2)
   at batch 16, T = 64 — int8 at LARGE_1024, fp32-dense at PAPER_BASELINE
   and the culled int8 schedule on a block-sparse dim-1024 matrix: states
   within SERVE_TOL, int32 products == ``matvec_int_exact``, chunked
   (2 x 32) == one-shot bit for bit, each backend's time per 32-step
   chunk (CUDA events; device time by the profiler, the torch backend's
   at the end of the phase); (b) a bounded-queue + deadline-shedding admission policy over an
   overflowing burst (rejections and sheds counted, every served answer
   == the engine's one-shot answer at the pool shape); (c) a fault plan
   of transient failures and a straggler window (answers == the
   fault-free run's, retries recorded); (d) a registry of a B2 model and
   a B1 (``specialize=False``) model in one pool with a new version
   published mid-burst (zero drops, versions pinned, answers bit-exact
   against the pinned engines, B1 and B2 launched);
10. ``lm_serve`` (run last, after every profile): the LM substrate's
   serving path at mistral-nemo-12b's full width (40 layers, d_model 5120,
   GQA 32/8 heads, 12,247,782,400 parameters, bf16, seeded random weights
   drawn on the card): (1) the parameter count against the reference's;
   (2) eight prompts (4 x 512, 2 x 1024, 2048, 4096 tokens) grouped by
   ``PaddingBucketer`` into four exactly filled buckets, each prefilled
   through ``make_prefill_step`` (the 4096 bucket on the chunked attention
   path) and decoded for 32 greedy steps through ``make_decode_step``:
   prefill ms and prompt tokens/s, decode ms per step and tokens/s (CUDA
   events), each beside its bound from the ported roofline functions at
   the H100's peaks, peak memory and ``ServeStats.render()``; (3) decode
   == teacher forcing at 512 tokens (rtol = atol = 0.15, the same
   argmax); (4) chunked == dense attention on layer 0's q/k/v of the
   4096-token prompt; (5) ``quantize_tree`` on the card and the 512
   bucket decoded from the int8 tree: ms per step beside bf16's and the
   int8 bounds, the first step's logits against bf16's (correlation >
   0.98).  No kernel of B1-B5 may launch on this path (the kernels line's
   ``launches_lm_serve``);
11. ``lm_blocks`` (after ``lm_serve``, unprofiled for the same reason):
   the rest of the LM substrate at full width, bf16, seeded random weights
   drawn on the card, one model at a time, each parameter count held to
   the reference's: (a) olmoe-1b-7b (16 layers, 64 experts top-8,
   6,919,100,416 parameters) over lm_serve's four buckets, each time beside
   two bounds (the roofline's active parameters; every parameter read, as
   the reference's capacity buffer reads every expert), the share of
   routed assignments dropped by capacity, decode == teacher forcing on a
   copy whose capacity covers every assignment, and int8 serving of the
   512 bucket (correlation > 0.98); (b) deepseek-v2-236b with n_layers 60
   -> 4 (MLA + 160 experts top-6 + 2 shared, 16,937,047,040 parameters),
   buckets 512 x 4 and 4096 x 1, the same checks through the absorbed MLA
   decode, and the latent cache's bytes per token; (c) recurrentgemma-2b
   and xlstm-350m (512 x 4) and whisper-base (448 x 4 over 1500 stub
   frames): prefill, decode and teacher forcing, and one sLSTM layer's
   prefill beside one mLSTM layer's.  No kernel of B1-B5 may launch
   (``launches_lm_blocks``);
12. ``train`` (after ``lm_blocks``, unprofiled for the same reason): (a)
   the paper's Sec. II task as ``examples/quickstart.py`` runs it, on the
   card: ``mackey_glass(3000)`` from the ported pipeline, ``init_esn
   (LARGE_1024)``, ``run_reservoir``, ``fit_readout`` on steps 500-2000
   at the example's ridge 1e-6 and at 1e-2, test predictions served by
   ``run_readout`` (B2 with the readout fused), train and test NRMSE, the
   test NRMSE held to ``MG_NRMSE_BOUND``; (b)
   stablelm-1.6b trained at full width (24 layers, d_model 2048, vocab
   100352, 1,644,367,872 parameters in bf16, AdamW moments in float32,
   ``remat="full"``, 2 microbatches) from seeded random weights on
   ``lm_batch``'s synthetic stream at 8 x 2048 tokens for 40 steps through
   ``make_train_step`` (AdamW at lr 2e-4, no warmup: see TRAIN_OPT):
   ms per step and tokens/s (CUDA events), model
   FLOP/s from the ported ``roofline.model_flops`` against 989 TFLOP/s,
   peak memory, loss / lr / grad norm every 10 steps; the loss must fall
   (the mean of the last 5 below the first 5's minus 0.3, as
   ``examples/train_lm.py`` checks), every loss and norm finite; then a
   ``Checkpointer`` round trip of the whole state (saved, found by
   ``latest_step``, restored into fresh tensors: equal bit for bit) and
   the next step from the restored state, its loss against the live
   state's; a breakdown of a step (one microbatch's forward and backward,
   the AdamW update, one layer's attention beside
   ``scaled_dot_product_attention``).  No kernel of B1-B5 may launch in (b) (``launches_lm_train``
   counts the phase: B2's come from (a));
13. ``mesh`` (after ``train``): the LM substrate on the ``(1, 1)`` mesh of
   ``make_host_mesh()`` (NCCL, world size 1, the process group set up in
   this process through a file store under ``build/``), each run against
   ``mesh=None`` from the same seeded state: (a) stablelm-1.6b at the
   train phase's configuration, 3 steps of ``make_train_step`` (loss and
   grad norm of every step, every parameter leaf after the last: bit for
   bit); (b) olmoe-1b-7b at full width prefilled at 512 x 4 and decoded 8
   greedy steps (every token and the last logits bit for bit); the ms per
   train and decode step of both (CUDA events), the mesh's host overhead.
   Four ranks on the one card need gloo (NCCL takes one rank per GPU): in
   ``tools/probe_mesh.py`` gloo carried all-reduce, all-gather and
   reduce-scatter of CUDA tensors among them, but the ranks died (SIGSEGV)
   in a 2 x 2 DTensor mesh over them (ROADMAP C-port-9), so the
   multi-rank path is held by the CPU tests alone.  No kernel of B1-B5 may launch
   (``launches_lm_mesh``);
14. ``dryrun`` (after ``mesh``): the dry run (``launch/dryrun.py``,
   ``lower_cell``: a step run once on rank 0 of a fake process group on
   meta tensors) held against the card: (a) stablelm-1.6b's train step at
   the train phase's shape (8 x 2048, 2 microbatches) dry-run on a fake
   world of one rank, then one real step on the card under
   ``FlopCounterMode``: the dry run's per-device dot FLOPs equal the
   counted ones, and its predicted peak is within DRYRUN_PEAK_RATIO of
   ``max_memory_allocated`` (both printed, with the ratio); (b)
   mistral-nemo-12b's int8 tree (``quantize_tree`` of the seeded bf16
   parameters) prefilled at 4 x 512 and decoded 8 greedy steps on the
   ``(1, 1)`` NCCL mesh (int8 leaves placed as ``lower_cell`` places
   them) against ``mesh=None``: tokens and last logits bit for bit, ms per
   decode step of both; (c) seven full-width cells: stablelm-1.6b
   train_4k, mistral-nemo-12b decode_32k and olmoe-1b-7b prefill_32k on
   the 16 x 16 fake mesh and on the 2 x 16 x 16 (``--multi-pod``), and
   olmoe-1b-7b train_4k on the 16 x 16, each through ``python -m
   repro_torch.launch.dryrun --cell`` in a subprocess of its own (all
   seven at once), started before (a) and run on the host's
   cores beside it: each ends ``ok``, its ``param_count`` equals the meta
   LM's and its argument bytes the shard bytes the sharding rules give
   rank 0 of its own mesh, and its per-device dot FLOPs under this
   host's torch come within DRYRUN_FLOP_RTOL of DRYRUN_FLOPS (the same
   cell's count under another torch version, both versions printed);
   peak GB per device and whether it fits 80 GB, the useful ratio, the
   collective bytes by kind (beside ``tools/mesh_bytes.py``'s) and the
   seconds per cell and of the seven.  No kernel of B1-B5 may launch
   (``launches_lm_dryrun``);
15. ``examples`` (after ``dryrun``): every ``Run:`` line of the
   docstrings of ``examples/*_torch.py`` (the twins of the reference's
   example scripts, at their own full sizes) on the card, each through
   its ``main(argv)`` in this process, so that the phase counts every
   run's launches (``serve_observed_torch`` switches ``obs`` on and off,
   and the phase puts this process's ``obs`` state back; the LM twins'
   ``(1, 1)`` mesh runs over one NCCL group the phase opens), every run
   with ``build/examples`` as its working directory and its full output
   in ``build/examples/<n>_<script>.log``.  A run that raises or does
   not end with ``OK`` fails the phase; each run's seconds and the
   numbers it printed (NRMSE, SER, accuracy, steps/s, makespans, served
   counts, loss first and last) are printed, and each ``train_lm_torch``
   run's ms per step (median of its steps after the first) and tokens/s.
   The specialized rollout (B2) and its fused readout must launch, B1 and
   B3-B5 must not (``launches_examples``).  The B2 launches of
   quickstart (2,999 steps at batch 1, dim 800 int8-CSD, states and the
   fused readout), channel_equalization (6,000 steps, dim 600, fp32 and
   int8-CSD) and timeseries_classification (batch 180 x 120 steps, dim
   400 int8-CSD) are held against B2's plain twin on the same card
   tensors: int8 states exactly, fp32 states within FP32_TOL, the fused
   readout within READOUT_TOL (beside the largest sum |x_i w_i|, the size
   a float sum's rounding grows with); then quickstart's served
   predictions are timed (CUDA events) and each timed launch held
   against the same twin;
5. times each kernel per launch at the LARGE_1024 shape with CUDA events
   and the profiler, beside its plain twin, one PyTorch call computing the
   same product (and cuSPARSE for B4), and the least time the card could
   take (its bound); B1 and B2 per launch of T = 32 and 64 steps (reported
   per step), with each grid's shared memory per block, its host enqueue
   and a sweep of block counts; B3-B5 at batch 16 and 1, each with its
   grid, its device time per launch and its library call's (profiler),
   and with a cold L2 (a 128 MiB buffer written before every launch).

Exits non-zero, printing no result, without a CUDA device or outside a
checkout.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Tolerances.  int8 states are exact (integer recurrent products, the same
# rounding sequence in kernel and twin); fp32 tile sums run in another
# order (kernel: fixed partial sums over a block's warps and lanes, reduced
# in a fixed tree; twin: a library matmul), and a
# readout is a 1024-term float sum in another order in both modes.
FP32_TOL = 1e-4
READOUT_TOL = 1e-4
# torch serve backend vs the kernels: the same recurrence, but the input
# projection is one library product (another sum order when I > 1) and
# fp32-dense sums the recurrent product in a library order
SERVE_TOL = 1e-4
# sharded ridge fit vs the one-shot fit: fitted values (float32 Gram sums
# per shard and a float32 eigensolver on the card, against a float64 host
# solve).  The LARGE_1024 training Gram's largest eigenvalue is ~4.5e4, so
# its float32 entries carry ~3e-3 of rounding; a ridge of 1 bounds the
# solve's amplification of that to ~1e-4 on the fitted values (the
# smaller ridges of 1e-2 / 1e-4 amplify it 100x / 10^4x: 1e-3 / 3e-2 on
# the CPU, the same between two float32 Gram sums of one solver)
RIDGE_TOL = 1e-3
RIDGE_LAM = 1.0

# phase 3 serves its 24-request burst this many times (fresh server each)
BURSTS = 5

# lm_serve: mistral-nemo-12b at full width.  Its parameter count is the
# JAX package's LM(cfg).param_count(), kept here because this script
# cannot import JAX.
LM_ARCH = "mistral-nemo-12b"
LM_PARAMS = 12_247_782_400
LM_LEN_BUCKETS = (512, 1024, 2048, 4096)
LM_PROMPTS = (512,) * 4 + (1024,) * 2 + (2048, 4096)   # fill each bucket
LM_DECODE_STEPS = 32
# decode vs teacher forcing in bf16: the reference's own bound between its
# two bf16 paths (tests/test_arch_smoke.py)
LM_TF_TOL = 0.15
# chunked vs dense attention in bf16, per element: the dense path rounds
# each probability to bf16 before P.V (relative 2^-9, so at most 2^-9 *
# max |v| on the output), and each path rounds its float32 output to bf16
# once (half an ulp each: together up to 2^-7 * |o|)
LM_ATTN_RTOL = 2.0 ** -7
LM_ATTN_VTOL = 2.0 ** -9
# int8 vs bf16 serving: the reference's criterion (tests/test_quantize.py)
LM_INT8_CORR = 0.98

# lm_blocks: the MoE, MLA, recurrent and enc-dec configs at full width.
# Each parameter count is the JAX package's LM(cfg).param_count() (for
# deepseek with n_layers 60 -> 4), kept here because this script cannot
# import JAX.
BLOCKS_PARAMS = {"olmoe-1b-7b": 6_919_100_416,
                 "deepseek-v2-236b": 16_937_047_040,
                 "recurrentgemma-2b": 2_894_574_080,
                 "xlstm-350m": 183_835_792,
                 "whisper-base": 71_395_840}
# one card holds about 4 of deepseek-v2-236b's 60 layers (3.97 B
# parameters each) beside its embeddings: reduced n_layers 60 -> 4
DEEPSEEK_LAYERS = 4
# whisper's published text context (n_text_ctx) and its 1500 frames
WHISPER_TEXT_CTX = 448

# train (a): Mackey-Glass at LARGE_1024 (int8-CSD, the readout fitted on
# steps 500-2000 as examples/quickstart.py fits it), at two ridges.  The
# bounds are 1.5x the port's worst test NRMSE on the CPU over nine row
# orders of the fit (tests/test_torch_train.py, MG_CPU_WORST): the card's
# float32 Gram sums in yet another order.  At the example's 1e-6 that
# order decides the fit (0.15-6.68 on the CPU), so its bound only catches
# a broken path; at 1e-2 the fit is well posed (0.0099-0.0104).
MG_NRMSE_BOUND = {1e-6: 1.5 * 6.6766281, 1e-2: 1.5 * 0.0104129}
# train (b): stablelm-1.6b at full width.  TRAIN_PARAMS is the JAX
# package's LM(cfg).param_count(), kept here because this script cannot
# import JAX.  The traffic is cut from train_4k's 256 x 4096 to one
# card's time: global batch 8 x 2048 tokens.  The optimizer departs from
# examples/train_lm.py's (lr 3e-3, warmup 20, 100 total steps): on the
# H100 that one raised the loss (12.02 -> 12.59 at step 20, 12.24 over
# the last 5), and with a 20-step warmup no lr tried (3e-4 to 3e-3) fell
# by 0.3 in 40 steps: the parameters are bf16 with no float32 copy, as in
# the reference, so updates under half a bf16 ulp of a weight are lost
# (1e-4 barely moves the loss).  lr 2e-4 without warmup fell by 0.3368
# (tools/probe_lm_train.py on the H100, recorded in PERF.md).
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_PARAMS = 1_644_367_872
TRAIN_BATCH = 8
TRAIN_SEQ = 2048
TRAIN_STEPS = 40
TRAIN_OPT = dict(lr=2e-4, warmup_steps=0, total_steps=100)
TRAIN_DROP = 0.3           # examples/train_lm.py's check on the loss
# the next step from the restored checkpoint against the live state: the
# same parameters, batch and kernels, so the same loss; the tolerance only
# allows for a reduction whose order is not fixed from run to run
TRAIN_RESUME_RTOL = 1e-6

# the mesh phase: stablelm-1.6b at the train phase's configuration for
# MESH_TRAIN_STEPS steps, olmoe-1b-7b prefilled at MESH_PROMPT (batch,
# tokens) and decoded MESH_DECODE_STEPS greedy steps, each on the (1, 1)
# mesh and without one
MESH_TRAIN_STEPS = 3
MESH_ARCH = "olmoe-1b-7b"
MESH_PROMPT = (4, 512)
MESH_DECODE_STEPS = 8

# the dryrun phase: (a) the dry run of the train phase's step (TRAIN_ARCH
# at TRAIN_BATCH x TRAIN_SEQ, its microbatches) on a fake world of one rank
# against one real step on the card: the dot FLOPs equal, the predicted
# peak within DRYRUN_PEAK_RATIO of max_memory_allocated; (b) int8 serving
# of LM_ARCH on the (1, 1) NCCL mesh against mesh=None, DRYRUN_PROMPT and
# DRYRUN_DECODE_STEPS greedy steps; (c) DRYRUN_CELLS (arch, shape,
# multi-pod) at full width on the 16 x 16 or 2 x 16 x 16 production mesh,
# each through the dry-run CLI in a subprocess of its own (all at
# once), within DRYRUN_CELL_TIMEOUT seconds of its
# start.  DRYRUN_FLOPS are the cells' per-device dot FLOPs from the dry
# run on the CPU under torch DRYRUN_FLOPS_TORCH (PERF.md); the card host's
# torch must come within DRYRUN_FLOP_RTOL of each.  MESH_BYTES are
# tools/mesh_bytes.py's computed bytes per rank of the explicit
# redistributes of the 16 x 16 cells, the sum of its rows for each cell
# (for olmoe train_4k the MoE's rows only; PERF.md), printed beside the
# dry run's collective bytes.
DRYRUN_PEAK_RATIO = (0.5, 2.0)
DRYRUN_PROMPT = (4, 512)
DRYRUN_DECODE_STEPS = 8
DRYRUN_CELLS = (("stablelm-1.6b", "train_4k", False),
                ("mistral-nemo-12b", "decode_32k", False),
                ("olmoe-1b-7b", "prefill_32k", False),
                ("stablelm-1.6b", "train_4k", True),
                ("mistral-nemo-12b", "decode_32k", True),
                ("olmoe-1b-7b", "prefill_32k", True),
                ("olmoe-1b-7b", "train_4k", False))
DRYRUN_CELL_TIMEOUT = 600
DRYRUN_FLOPS_TORCH = "2.13.0+cpu"
DRYRUN_FLOPS = {("stablelm-1.6b", "train_4k", False): 58067957841920.0,
                ("mistral-nemo-12b", "decode_32k", False): 28605153280.0,
                ("olmoe-1b-7b", "prefill_32k", False): 28312450170880.0,
                ("stablelm-1.6b", "train_4k", True): 29033978920960.0,
                ("mistral-nemo-12b", "decode_32k", True): 14302576640.0,
                ("olmoe-1b-7b", "prefill_32k", True): 14156225085440.0,
                ("olmoe-1b-7b", "train_4k", False): 55052890800128.0}
DRYRUN_FLOP_RTOL = 0.01
MESH_BYTES = {("stablelm-1.6b", "train_4k"): 33_107_148_800,
              ("mistral-nemo-12b", "decode_32k"): 5_324_800,
              ("olmoe-1b-7b", "train_4k"): 5_804_916_736}

# the examples phase: a run's printed lines that hold these words are
# echoed
EXAMPLE_NUMBERS = ("NRMSE", "SER=", "accuracy", "steps/s", "makespan",
                   "served", "rejected", "loss ", "parity", "p99",
                   "set-up", "injected", "recovered", "spatial-model",
                   "requests,")

# Published H100 SXM peaks (NVIDIA data sheet) used for the bounds.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12

_ROLLOUT_CU = "src/repro_torch/kernels/reservoir_rollout/csrc/rollout.cu"
# name -> (the Pallas kernel it replaces, its CUDA source)
KERNELS = {
    "specialized_rollout": (
        "src/repro/kernels/reservoir_rollout/specialized.py:162", _ROLLOUT_CU),
    "reservoir_rollout": (
        "src/repro/kernels/reservoir_rollout/reservoir_rollout.py:117",
        _ROLLOUT_CU),
    # the y = x @ W_out epilogue, computed inside B1's and B2's launch: its
    # launches are the rollout launches that fused it
    "rollout_readout": (
        "src/repro/kernels/reservoir_rollout/specialized.py:142", _ROLLOUT_CU),
    "bitplane_gemv": (
        "src/repro/kernels/bitplane_gemv/bitplane_gemv.py:55",
        "src/repro_torch/kernels/bitplane_gemv/csrc/bitplane_gemv.cu"),
    "bcsr_matmul": (
        "src/repro/kernels/bcsr_matmul/bcsr_matmul.py:43",
        "src/repro_torch/kernels/bcsr_matmul/csrc/bcsr_matmul.cu"),
    "reservoir_step": (
        "src/repro/kernels/reservoir_step/reservoir_step.py:44",
        "src/repro_torch/kernels/reservoir_step/csrc/reservoir_step.cu"),
}


def gpu_name_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _lm_bound(rf, cfg, shape, n_params, n_act, n_read):
    """(ms, what bounds it) for one LM step from the ported roofline
    functions at the H100's peaks: the FLOPs of ``n_act`` parameters per
    token, the bytes of ``n_read`` parameters read once (``n_act`` is the
    roofline's own bound; ``n_read = n_params`` prices a MoE that reads
    every expert, as the reference's capacity buffer does)."""
    t_c = rf.model_flops(cfg, shape, n_act) / rf.PEAK_FLOPS
    t_m = rf.analytic_hbm_bytes(cfg, shape, n_params, n_read, 1) / rf.HBM_BW
    return (max(t_c, t_m) * 1e3, "FLOPs" if t_c >= t_m else "bytes")


def maxdiff(a, b) -> float:
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        return float((a.float() - b.float()).abs().max().item())
    return float((a.long() - b.long()).abs().max().item())   # ints exact


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        # max |kernel - twin| per kernel and mode; None until a check ran
        self.err = {k: {"int8": None, "fp32": None} for k in KERNELS}
        self.failures: list[str] = []
        self.kernels: dict = {}
        self.card = ""
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            reservoir_rollout)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            specialized_rollout)
        # the rollout kernels' launch counters; a phase's counts come from
        # _drive (the fused readouts under "rollout_readout")
        self._counted = {"specialized_rollout": specialized_rollout,
                         "reservoir_rollout": reservoir_rollout}
        self.serve_launches: dict = {}
        self.sharded_launches: dict = {}
        self.lm_launches: dict = {}
        self.blocks_launches: dict = {}
        self.train_launches: dict = {}
        self.mesh_launches: dict = {}
        self.dryrun_launches: dict = {}
        self.examples_launches: dict = {}

    def check(self, cond: bool, what: str) -> None:
        if not cond:
            self.failures.append(what)
            print(f"FAIL: {what}")

    def note_err(self, kernel, mode, value) -> None:
        old = self.err[kernel].get(mode)      # bf16: bcsr_matmul only
        self.err[kernel][mode] = value if old is None else max(old, value)

    # -- phase 1 -------------------------------------------------------------
    def build(self):
        """Builds every kernel source at once (one nvcc each, in threads)."""
        torch = self.torch
        from repro_torch.kernels.bcsr_matmul import bcsr_matmul
        from repro_torch.kernels.bitplane_gemv import bitplane_gemv
        from repro_torch.kernels.reservoir_rollout import _cuda
        from repro_torch.kernels.reservoir_step import reservoir_step
        libs = {"rollout.cu": _cuda.LIBRARY,
                "bitplane_gemv.cu": bitplane_gemv.LIBRARY,
                "bcsr_matmul.cu": bcsr_matmul.LIBRARY,
                "reservoir_step.cu": reservoir_step.LIBRARY}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.load(), libs.values()))
        self.card = gpu_name_power()
        print(f"build: {time.perf_counter() - t0:.2f} s for {len(libs)} "
              "sources in parallel")
        for name, lib in libs.items():
            info = lib.build_info()
            print(f"  {name}: {info['seconds']:.2f} s ({info['path']})")
            for line in info["log"].splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print("    ptxas:", line.strip())
        print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
              f"python {sys.version.split()[0]}")
        print(f"card: {self.card}")

    # -- phase 2 -------------------------------------------------------------
    def _matrix(self, kind: str):
        """dim-256 test matrices: block-dense (block 64), the same with
        whole zero blocks, and a sparse one (block 32, 97% zeros) whose
        low-population digit planes become shift-add terms."""
        from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
        rng = np.random.default_rng(0)
        es, block = (0.97, 32) if kind == "sparse" else (0.9, 64)
        w = random_sparse_matrix(256, 256, es, rng) * 0.05
        if kind == "zero-blocks":
            w[:, 64:128] = 0.0          # a whole output column block
            w[0:64, 192:256] = 0.0      # single culled blocks
            w[128:192, 0:64] = 0.0
        return FixedMatrix.compile(w, weight_bits=8, mode="csd", block=block,
                                   rng=rng)

    def _pipelined_budget(self, plan, kmode):
        from repro_torch.plan import specialize_summary
        tile = plan.block * plan.block * (4 if kmode == "fp32" else 1)
        for n in range(1, 256):
            try:
                s = specialize_summary(plan, kmode, vmem_budget=2 * n * tile,
                                       batch_tile_max=16)
            except ValueError:
                continue
            if s["regime"] == "pipelined":
                return 2 * n * tile
        raise RuntimeError("no pipelined budget found")

    def twins(self):
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            build_tables, pack_blocks, reservoir_rollout_plain, rollout_grid)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout, specialized_rollout_plain)
        from repro_torch.plan import plan_for, specialize_rollout
        cases = 0
        for kind in ("dense-blocks", "zero-blocks", "sparse"):
            plan = plan_for(self._matrix(kind))
            print(f"matrix {kind}: block {plan.block}, "
                  f"{plan.blocks_nnz}/{plan.blocks_total} blocks kept")
            rng = np.random.default_rng(7)
            w_in = rng.uniform(-0.5, 0.5, (4, 256)).astype(np.float32)
            w_out = rng.uniform(-0.1, 0.1, (256, 4)).astype(np.float32)
            for kmode in ("fp32", "int8"):
                b1 = FusedRollout(plan, w_in, leak=0.7, mode=kmode,
                                  w_out=w_out, device=self.dev)
                b2 = SpecializedRollout(plan, w_in, leak=0.7, mode=kmode,
                                        w_out=w_out, device=self.dev)
                grid, _ = rollout_grid(b2.tables, self.dev)
                for regime in ("resident", "pipelined"):
                    budget = (None if regime == "resident"
                              else self._pipelined_budget(plan, kmode))
                    prog = specialize_rollout(plan, kmode,
                                              vmem_budget=budget)
                    shares = pack_blocks(build_tables(
                        prog.schedules, prog.data, mode=kmode,
                        n_col_blocks=plan.nbc, device=self.dev),
                        grid.n_blocks)
                    self.check(
                        prog.regime == regime
                        and shares.blob.tobytes()
                        == grid.shares.blob.tobytes()
                        and np.array_equal(shares.meta, grid.shares.meta),
                        f"{kind}/{kmode}: B2's shares != {regime} lowering's")
                    for batch in (3, 16):
                        self._twin_case(
                            torch, b1, b2, reservoir_rollout_plain,
                            specialized_rollout_plain, kmode, batch,
                            f"{kind}/{kmode}/{regime}/b{batch}"
                            f" sa_digits={b2.tables.n_digits}")
                        cases += 1
        print(f"twin cases: {cases}")

    def _twin_case(self, torch, b1, b2, plain1, plain2, kmode, batch, tag):
        gen = torch.Generator(device="cpu").manual_seed(batch)
        t = 8
        u = torch.randn((t, batch, 4), generator=gen).to(self.dev)
        x0 = (0.5 * torch.randn((batch, 256), generator=gen)).to(self.dev)
        kw = dict(want_states=True, want_preds=True, want_final=True)
        got = {}
        for name, op, plain in (("reservoir_rollout", b1, plain1),
                                ("specialized_rollout", b2, plain2)):
            s, p, f = op(u, x0, **kw)
            common = dict(leak=op.leak, smax=op.smax,
                          recur_scale=op.recur_scale, readout_every=1, **kw)
            ps, pp, pf = plain(u, op.tables, op.w_in, x0, op.w_out, **common)
            torch.cuda.synchronize()
            ds, df = maxdiff(s, ps), maxdiff(f, pf)
            dp = maxdiff(p, pp)
            self.note_err(name, kmode, max(ds, df))
            self.note_err("rollout_readout", kmode, dp)
            tol = 0.0 if kmode == "int8" else FP32_TOL
            self.check(ds <= tol and df <= tol,
                       f"{name} vs twin {tag}: states {ds:.3g} final {df:.3g}")
            self.check(dp <= READOUT_TOL, f"{name} preds vs twin {tag}: "
                       f"{dp:.3g}")
            got[name] = (s, p, f)
        same = all(torch.equal(a, b) for a, b in zip(
            got["reservoir_rollout"], got["specialized_rollout"]))
        if kmode == "int8":
            self.check(same, f"B2 != B1 bit for bit {tag}")
        # chunked with the carry donated in place == one-shot
        carry = x0.clone()
        s1, _ = b2(u[:4], carry, want_states=True, want_final=True,
                   donate_state=True)
        s2, f2 = b2(u[4:], carry, want_states=True, want_final=True,
                    donate_state=True)
        self.check(torch.equal(torch.cat([s1, s2]), got["specialized_rollout"][0])
                   and torch.equal(f2, got["specialized_rollout"][2])
                   and f2.data_ptr() == carry.data_ptr(),
                   f"donated chunked != one-shot {tag}")
        print(f"  {tag}: B1/B2 vs twins ok, B1==B2 {same}")

    # -- phase 3 -------------------------------------------------------------
    def main_path(self):
        torch = self.torch
        from repro_torch.configs.esn_paper import LARGE_1024, PAPER_BASELINE
        from repro_torch.core.esn import (fit_readout, init_esn, nrmse,
                                          run_readout, run_reservoir)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            specialized_rollout)
        from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                                       ServeStats, SubmitSpec)
        self._zero(self._counted)

        t0 = time.perf_counter()
        params = init_esn(LARGE_1024, device=self.dev)
        print(f"init_esn LARGE_1024: {time.perf_counter() - t0:.2f} s, "
              f"{params.w.plan().blocks_nnz}/{params.w.plan().blocks_total} "
              f"blocks kept, w.scale {params.w.scale!r}")
        steps = np.arange(1200, dtype=np.float32)
        signal = (np.sin(0.2 * steps) * np.cos(0.031 * steps)
                  ).astype(np.float32)[:, None]
        u_train = torch.as_tensor(signal[:-1], device=self.dev)
        y_train = torch.as_tensor(signal[1:], device=self.dev)
        states = run_reservoir(params, u_train)
        params = fit_readout(params, states, y_train, lam=1e-4, washout=100)
        pred = run_readout(params, u_train)
        err = float(nrmse(pred[100:], y_train[100:]).item())
        print(f"fit_readout: one-step-ahead NRMSE {err:.4g} "
              "(teacher signal, after 100-step washout)")
        self.check(np.isfinite(err) and err < 0.5, f"NRMSE {err}")
        self.params_1024 = params
        # (e) of the sharded phase fits a readout over these, sharded
        self.train_1024 = (states[100:], y_train[100:])

        eng = ReservoirEngine(params)
        print(f"backend 'auto' resolved to {eng.backend}: "
              f"{eng.schedule.describe()}")
        self._auto_is_timed_schedule(eng, "LARGE_1024 int8")
        print("program:", eng.program.describe())
        rng = np.random.default_rng(11)
        lengths = rng.integers(64, 257, size=24)
        specs = [SubmitSpec(
            signal[s:s + n] + 0.01 * rng.standard_normal((n, 1)).astype(
                np.float32), uid=i)
            for i, (n, s) in enumerate(zip(lengths, rng.integers(0, 900, 24)))]
        # the same burst BURSTS times, each on a fresh server: the rate is
        # all requests over all wall time, beside each burst's own rate
        bursts, served = [], []
        n_req = BURSTS * len(specs)
        b2_served = fused_served = chunks = 0
        for _ in range(BURSTS):
            # stats of its own: the engine's would add up across bursts;
            # the server's warm-up launch at construction is not served
            srv = AsyncReservoirServer(eng, n_slots=16, chunk_steps=32,
                                       stats=ServeStats())
            before = (specialized_rollout.launches,
                      specialized_rollout.fused_launches)
            for i, spec in enumerate(specs):
                srv.submit(spec, arrival_time=0.001 * i)
            t0 = time.perf_counter()
            res = srv.run()
            torch.cuda.synchronize()
            bursts.append(time.perf_counter() - t0)
            chunks += srv.stats.chunks
            b2_served += specialized_rollout.launches - before[0]
            fused_served += specialized_rollout.fused_launches - before[1]
            served.append(res)
            self.check(len(res) == len(specs) and all(
                r.status == "ok" and r.preds.shape == (n, 1)
                and np.isfinite(r.preds).all()
                for r, n in zip((res[i] for i in range(len(specs))),
                                lengths)),
                "server answered every request")
        self.chunk_launches = b2_served / max(chunks, 1)
        self.check(b2_served > 0, "B2 launched by the server")
        self.check(b2_served == chunks and fused_served == chunks,
                   f"one B2 launch with its readout fused per served chunk "
                   f"({b2_served} launches, {fused_served} fused readouts, "
                   f"{chunks} chunks)")
        wall = sum(bursts)
        print(f"server: {BURSTS} bursts x {len(specs)} requests, "
              f"{BURSTS * int(lengths.sum())} steps, {chunks} chunks, "
              f"{wall:.4f} s wall = {n_req / wall:.1f} requests/s, "
              f"{BURSTS * lengths.sum() / wall:.0f} steps/s "
              f"({b2_served} B2 launches, {self.chunk_launches:g} per "
              f"chunk; {fused_served} fused readouts) on {self.card}")
        print("  per burst requests/s: "
              + ", ".join(f"{len(specs) / w:.1f}" for w in bursts))
        # the same burst with every request there at time 0: the arrivals
        # above are 1 ms apart on the server's clock, which bounds a burst
        # below by 23 ms; here the pool stays full and the chunk cost sets
        # the rate
        walls, chunks0 = [], 0
        for _ in range(BURSTS):
            srv = AsyncReservoirServer(eng, n_slots=16, chunk_steps=32,
                                       stats=ServeStats())
            for spec in specs:
                srv.submit(spec, arrival_time=0.0)
            t0 = time.perf_counter()
            srv.run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            chunks0 += srv.stats.chunks
        print(f"server, all arrivals at 0: {n_req / sum(walls):.1f} "
              f"requests/s, {chunks0} chunks, "
              f"{sum(walls) / chunks0 * 1e6:.1f} us per chunk (per burst "
              + ", ".join(f"{len(specs) / w:.1f}" for w in walls)
              + f") on {self.card}")

        one_walls = []
        for _ in range(BURSTS):
            t0 = time.perf_counter()
            one = eng.submit_many(specs)
            torch.cuda.synchronize()
            one_walls.append(time.perf_counter() - t0)
        print(f"one-shot submit_many: {BURSTS} x {len(specs)} requests, "
              f"{sum(one_walls):.4f} s wall = "
              f"{n_req / sum(one_walls):.1f} requests/s (per call: "
              + ", ".join(f"{len(specs) / w:.1f}" for w in one_walls)
              + f") on {self.card}")
        exact = all(np.array_equal(res[i].preds, one[i].preds.cpu().numpy())
                    for res in served for i in range(len(specs)))
        self.check(exact, "chunked == one-shot bit for bit (LARGE_1024)")
        generic = ReservoirEngine(params, backend="cuda",
                                  specialize=False).submit_many(specs)
        same = all(torch.equal(generic[i].preds, one[i].preds)
                   for i in range(len(specs)))
        self.check(same, "B1 == B2 bit for bit (LARGE_1024 one-shot)")
        print(f"chunked == one-shot: {exact}; B1 == B2: {same}")
        self.requests_per_s = n_req / wall
        self.specs_1024 = specs

        # -- phase 4: fp32 at PAPER_BASELINE -------------------------------
        p800 = init_esn(PAPER_BASELINE, device=self.dev)
        gen = torch.Generator(device="cpu").manual_seed(3)
        p800 = dataclasses.replace(p800, w_out=(0.05 * torch.randn(
            (800, 1), generator=gen)).to(self.dev))
        specs800 = [SubmitSpec(signal[: n], uid=i)
                    for i, n in enumerate((40, 64, 100, 77))]
        auto800 = ReservoirEngine(p800)
        self._auto_is_timed_schedule(auto800, "PAPER_BASELINE fp32")
        a = auto800.submit_many(specs800)
        b = ReservoirEngine(p800, backend="cuda",
                            specialize=False).submit_many(specs800)
        d = max(maxdiff(a[i].preds, b[i].preds) for i in a)
        self.check(d <= FP32_TOL, f"PAPER_BASELINE fp32 B2 vs B1 {d:.3g}")
        print(f"PAPER_BASELINE fp32 (dim 800 -> 7 column blocks of 128): "
              f"specialized vs generic max |diff| {d:.3g}")
        # the readout runs inside the rollout launches on this path
        self.launches = self._made(self._counted)
        print("main-path launches (rollout_readout: fused readouts):",
              self.launches)
        for k, n in self.launches.items():
            self.check(n > 0, f"{k} launched on the main path")
        self.params_800 = p800

    def _auto_is_timed_schedule(self, eng, tag):
        """The schedule ``"auto"`` serves the 16-slot pool with is the one
        phase 5 times B2 at (``SpecializedRollout``'s defaults), and the
        one the prior picks at the pool's own shape (16 x 32)."""
        from repro_torch.plan import (ScheduleCache, default_schedule,
                                      resolve_schedule)
        mode = "int8" if eng._int8 else "fp32"
        timed = default_schedule(eng.plan, mode, "cuda")
        pool = resolve_schedule(eng.plan, mode, batch=16, steps=32,
                                cache=ScheduleCache(), device=self.dev)
        knobs = (eng.backend, eng.vmem_budget, eng.crossover,
                 eng.batch_tile_max)
        self.check(eng.schedule.key() == timed.key()
                   == pool.schedule.key()
                   and knobs == timed.key()[1:],
                   f"{tag}: 'auto' serves {eng.schedule.describe()}, the "
                   f"pool's pick is {pool.schedule.describe()}, B2 is "
                   f"timed at {timed.describe()}")
        print(f"{tag}: 'auto' serves the schedule B2 is timed at "
              f"({timed.describe()}), also the pick at the pool's shape")

    def baseline_twins(self):
        """B1 and B2 against their twins at phase 4's fp32 shape: dim 800
        in 7 column blocks of 128, the last one ragged (96 columns); a
        4-row launch equal row by row to one-row launches; each kernel's
        fp32 step at batch 16 and 1 (T = 64)."""
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            reservoir_rollout_plain)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout, specialized_rollout_plain)
        params = self.params_800
        cfg = params.config
        gen = torch.Generator(device="cpu").manual_seed(13)
        u = torch.randn((32, 4, cfg.input_dim), generator=gen).to(self.dev)
        x0 = (0.5 * torch.randn((4, cfg.reservoir_dim),
                                generator=gen)).to(self.dev)
        u64 = torch.randn((64, 16, cfg.input_dim), generator=gen).to(self.dev)
        x64 = (0.5 * torch.randn((16, cfg.reservoir_dim),
                                 generator=gen)).to(self.dev)
        kw = dict(want_states=True, want_preds=True, want_final=True)
        for name, cls, plain in (
                ("specialized_rollout", SpecializedRollout,
                 specialized_rollout_plain),
                ("reservoir_rollout", FusedRollout, reservoir_rollout_plain)):
            op = cls(params.w.plan(), params.w_in, leak=cfg.leak, mode="fp32",
                     w_out=params.w_out, device=self.dev)
            s, p, f = op(u, x0, **kw)
            ps, pp, pf = plain(u, op.tables, op.w_in, x0, op.w_out,
                               leak=op.leak, smax=op.smax,
                               recur_scale=op.recur_scale, readout_every=1,
                               **kw)
            torch.cuda.synchronize()
            ds, dp = max(maxdiff(s, ps), maxdiff(f, pf)), maxdiff(p, pp)
            self.note_err(name, "fp32", ds)
            self.note_err("rollout_readout", "fp32", dp)
            self.check(ds <= FP32_TOL and dp <= READOUT_TOL,
                       f"{name} vs twin at PAPER_BASELINE: states {ds:.3g} "
                       f"preds {dp:.3g}")
            print(f"  PAPER_BASELINE fp32 {name} vs twin: states {ds:.3g}, "
                  f"preds {dp:.3g}")
            rows = [op(u[:, i:i + 1], x0[i:i + 1], **kw) for i in range(4)]
            same = all(torch.equal(got, want)
                       for i, (s1, p1, f1) in enumerate(rows)
                       for got, want in ((s1, s[:, i:i + 1]),
                                         (p1, p[:, i:i + 1]),
                                         (f1, f[i:i + 1])))
            self.check(same, f"{name} fp32: a 4-row launch equals its rows "
                       "launched one at a time")
            for b in (16, 1):
                def call(b=b):
                    return op(u64[:, :b], x64[:b], want_states=True)
                dev_us = self._device_us(call, "rollout_kernel") / 64
                ev_us = self.timed(call, 20) / 64 * 1e3
                print(f"  PAPER_BASELINE fp32 {name} batch {b}, T=64: "
                      f"{dev_us:.3f} us/step device time, {ev_us:.3f} "
                      f"us/step by events on {self.card}")

    # -- phase 8 -------------------------------------------------------------
    def autotune(self):
        """The plan autotuner on the card, on three matrices (LARGE_1024
        int8, PAPER_BASELINE fp32, the banded culled dim-1024 int8 one) at
        the tuner's shape (batch 8, 8 steps) and the served pool's (batch
        16, 32 steps): (a) the card's prior's cold pick; (b) a measured
        tuning over both backends, every trial printed, the default among
        them, the winner no worse than it and on the cold pick's backend;
        (c) the winner's engine == the default schedule's (int8 bit for
        bit, fp32 within SERVE_TOL); (d) the saved trials replayed from a
        fresh cache with no launch; (e) the cost model refitted over all
        trials (the coefficients the card's prior is set from)."""
        torch = self.torch
        from repro_torch.core.costmodel import (ROLLOUT_FEATURES,
                                                default_rollout_cost_model,
                                                fit_rollout_cost,
                                                rollout_cost_features)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            specialized_rollout)
        from repro_torch.plan import (Schedule, ScheduleCache,
                                      autotune_rollout, candidate_schedules,
                                      default_schedule, resolve_schedule,
                                      specialize_summary)
        from repro_torch.serve import ReservoirEngine
        prior = default_rollout_cost_model("cuda")
        path = ROOT / "build" / "autotune_smoke.json"
        path.parent.mkdir(exist_ok=True)
        samples = []
        for tag, params in (("LARGE_1024 int8", self.params_1024),
                            ("PAPER_BASELINE fp32", self.params_800),
                            ("banded 1024 int8 (culled)",
                             self._culled_1024())):
            plan = params.w.plan()
            mode = "int8" if params.config.mode.startswith("int8") else "fp32"
            # every cuda candidate survives the prune when the prior ranks
            # them first; the default (torch) schedule is always measured
            top_k = len(candidate_schedules(plan, mode, ("cuda",)))
            default = default_schedule(plan, mode)
            tuned_cache, winners = ScheduleCache(), {}
            for batch, steps in ((8, 8), (16, 32)):
                shape = f"{tag} b{batch} T{steps}"
                cold = resolve_schedule(plan, mode, batch=batch, steps=steps,
                                        cache=ScheduleCache(), model=prior,
                                        device=self.dev)
                print(f"  {shape}: cold pick {cold.schedule.describe()} "
                      f"predicted {cold.predicted_s * 1e6:.1f} us "
                      f"({cold.n_candidates} candidates)")
                t0 = time.perf_counter()
                tuned = autotune_rollout(
                    plan, mode, batch=batch, steps=steps, params=params,
                    top_k=top_k, reps=3, model=prior, cache=tuned_cache,
                    device=self.dev)
                print(f"  {shape}: {len(tuned.trials)} trials in "
                      f"{time.perf_counter() - t0:.2f} s on {self.card} "
                      "(schedule: predicted / measured us, best of 3):")
                for s, p, m in sorted(tuned.trials, key=lambda t: t[2]):
                    sched = Schedule.from_dict(s)
                    print(f"    {sched.describe()}: {p * 1e6:.1f} / "
                          f"{m * 1e6:.1f}")
                    summary = specialize_summary(
                        plan, mode, vmem_budget=sched.vmem_budget,
                        crossover=sched.crossover,
                        batch_tile_max=sched.batch_tile_max)
                    samples.append((sched.backend, rollout_cost_features(
                        summary, plan.block, batch, steps), m))
                keys = [Schedule.from_dict(s).key() for s, _p, _m in
                        tuned.trials]
                print(f"  {shape}: winner {tuned.schedule.describe()} "
                      f"{tuned.measured_s * 1e6:.1f} us, default "
                      f"{default.describe()} "
                      f"{tuned.default_measured_s * 1e6:.1f} us, "
                      f"{tuned.default_measured_s / tuned.measured_s:.1f}x")
                self.check(default.key() in keys,
                           f"{shape}: default schedule among the trials")
                self.check(tuned.measured_s <= tuned.default_measured_s,
                           f"{shape}: winner slower than the default")
                self.check(cold.schedule.backend == tuned.schedule.backend,
                           f"{shape}: cold pick {cold.schedule.backend} != "
                           f"measured winner {tuned.schedule.backend}")
                self._tuned_equals_default(params, tuned, default, shape,
                                           batch, steps)
                winners[(batch, steps)] = tuned
            # (d) the trials' cache saved, loaded fresh, resolved again
            tuned_cache.save(path)
            fresh = ScheduleCache()
            loaded = fresh.load(path)
            for (batch, steps), tuned in winners.items():
                specialized_rollout.launches = 0
                replay = resolve_schedule(plan, mode, batch=batch,
                                          steps=steps, cache=fresh,
                                          device=self.dev)
                torch.cuda.synchronize()
                ok = (replay.source == "cache"
                      and replay.schedule == tuned.schedule
                      and replay.measured_s == tuned.measured_s
                      and specialized_rollout.launches == 0)
                self.check(ok, f"{tag} b{batch} T{steps}: cache replay "
                           f"source {replay.source}, "
                           f"{specialized_rollout.launches} launches")
            print(f"  {tag}: {loaded} entries replayed from {path.name} "
                  f"with source 'cache' and no B2 launch: "
                  f"{fresh.stats()}")
        # (e) the refit over every trial of this phase
        fit = fit_rollout_cost(samples, platform="cuda")
        print(f"  refit over {len(samples)} trials "
              f"({sum(b == 'cuda' for b, _f, _m in samples)} cuda) on "
              f"{self.card}; features {list(ROLLOUT_FEATURES)} + intercept:")
        for bk, c in fit.coeffs.items():
            errs = {name: float(np.median([
                abs(model.predict(bk, f) - m) / m
                for b, f, m in samples if b == bk]))
                for name, model in (("refit", fit), ("prior", prior))}
            print(f"    {bk}: [{', '.join(f'{x:.4g}' for x in c)}] "
                  f"(median |refit - measured| / measured "
                  f"{errs['refit']:.3f}, the prior's {errs['prior']:.3f})")

    def _tuned_equals_default(self, params, tuned, default, shape, batch,
                              steps):
        """(c) The winner's engine against the default schedule's on the
        same inputs: int8 states bit for bit, fp32 within SERVE_TOL; a
        cuda winner makes one B2 launch per call."""
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.specialized import (
            specialized_rollout)
        from repro_torch.serve import ReservoirEngine
        gen = torch.Generator(device="cpu").manual_seed(batch + steps)
        u = torch.randn((batch, steps, params.config.input_dim),
                        generator=gen).to(self.dev)
        win = ReservoirEngine(params, schedule=tuned)
        base = ReservoirEngine(params, schedule=default)
        specialized_rollout.launches = 0
        got = win.rollout(u)
        made = specialized_rollout.launches
        want = base.rollout(u)
        torch.cuda.synchronize()
        d = maxdiff(got, want)
        tol = 0.0 if params.config.mode.startswith("int8") else SERVE_TOL
        self.check(d <= tol, f"{shape}: winner vs default states {d:.3g}")
        self.check(made == (1 if win.backend == "cuda" else 0),
                   f"{shape}: winner made {made} B2 launches")
        print(f"  {shape}: winner ({win.backend}) vs default "
              f"({base.backend}) states max |diff| {d:.3g}, "
              f"{made} B2 launch")

    # -- phase 9 -------------------------------------------------------------
    def sharded(self):
        """Sharded serving at LARGE_1024 int8 on 4 shards: one per card
        where 4 cards are visible, else the visible cards in turn (all 4
        on one card on a one-card machine).  (a) the sharded engine
        against the single-device engine; (b) the distributed server on
        phase 3's burst; (c) a shard lost and regained; (d) autoscaling
        within the pool of 4; (e) the sharded ridge fit.  The phase's
        B1/B2 launch counts cover the sharded engines and servers only:
        the single-device answers they are checked against are left out."""
        torch = self.torch
        from repro_torch.launch.mesh import make_data_mesh
        cards = torch.cuda.device_count()
        self.shard_devices = self._shard_devices(cards)
        self.mesh4 = make_data_mesh(devices=self.shard_devices)
        self.sharded_launches = dict.fromkeys(
            [*self._counted, "rollout_readout"], 0)
        print(f"  4 shards on {[str(d) for d in self.mesh4.devices]} "
              f"({cards} card(s) visible)")
        self._sharded_engines()
        self._sharded_server()
        self._shard_loss()
        self._sharded_autoscale()
        self._sharded_ridge()
        print("sharded launches (rollout_readout: fused readouts):",
              self.sharded_launches)
        for k, n in self.sharded_launches.items():
            self.check(n > 0, f"{k} launched in sharded")

    def _shard_devices(self, cards):
        return [self.torch.device("cuda", i % cards) for i in range(4)]

    def _sharded_engines(self):
        """(a) ``ShardedReservoirEngine`` against ``ReservoirEngine`` at
        batch 16 and 13 (padded to 16): states, final states and
        predictions bit for bit — LARGE_1024 on B2 and on B1
        (``specialize=False``), PAPER_BASELINE fp32 on B2 — with one
        launch per shard per call and the readout fused.  Then the torch
        backend sharded against single: its readout is a library product
        whose algorithm may change with the rows (4 per shard against
        16), so that one comparison is held to SERVE_TOL and its gap
        printed."""
        torch = self.torch
        from repro_torch.dist import ShardedReservoirEngine
        from repro_torch.serve import ReservoirEngine
        for tag, params, kw in (
                ("LARGE_1024 int8 B2", self.params_1024, {}),
                ("LARGE_1024 int8 B1", self.params_1024,
                 {"specialize": False}),
                ("PAPER_BASELINE fp32 B2", self.params_800, {})):
            single = ReservoirEngine(params, **kw)
            sharded = ShardedReservoirEngine(params, mesh=self.mesh4, **kw)
            fn = ("specialized_rollout" if kw.get("specialize", True)
                  else "reservoir_rollout")
            cfg = params.config
            for batch in (16, 13):
                gen = torch.Generator(device="cpu").manual_seed(batch)
                u = torch.randn((batch, 64, cfg.input_dim),
                                generator=gen).to(self.dev)
                x0 = (0.3 * torch.randn((batch, cfg.reservoir_dim),
                                        generator=gen)).to(self.dev)
                ((gs, gf), gp), made = self._drive(lambda: (
                    sharded.run_segment(u, x0, want_states=True),
                    sharded.predictions(u, x0=x0)), self.sharded_launches)
                ws, wf = single.run_segment(u, x0, want_states=True)
                wp = single.predictions(u, x0=x0)
                torch.cuda.synchronize()
                exact = (torch.equal(gs, ws) and torch.equal(gf, wf)
                         and torch.equal(gp, wp))
                self.check(sharded.backend == single.backend == "cuda",
                           f"{tag}: backends {sharded.backend}, "
                           f"{single.backend}")
                self.check(exact, f"sharded != single {tag} batch {batch}: "
                           f"states {maxdiff(gs, ws):.3g} preds "
                           f"{maxdiff(gp, wp):.3g}")
                self.check(made[fn] == 8 and made["rollout_readout"] == 4,
                           f"{tag} batch {batch}: launches {made} (want 4 "
                           "per call, 4 fused readouts)")
                print(f"  (a) {tag} batch {batch}: sharded == single bit "
                      f"for bit {exact} (states, finals, preds); launches "
                      f"{made}")
        single = ReservoirEngine(self.params_1024, backend="torch")
        sharded = ShardedReservoirEngine(self.params_1024, mesh=self.mesh4,
                                         backend="torch")
        gen = torch.Generator(device="cpu").manual_seed(71)
        u = torch.randn((16, 32, 1), generator=gen).to(self.dev)
        dim = self.params_1024.config.reservoir_dim
        x0 = (0.3 * torch.randn((16, dim), generator=gen)).to(self.dev)
        gs, gf = sharded.run_segment(u, x0, want_states=True)
        ws, wf = single.run_segment(u, x0, want_states=True)
        gp, wp = sharded.predictions(u, x0=x0), single.predictions(u, x0=x0)
        torch.cuda.synchronize()
        ds, dp = max(maxdiff(gs, ws), maxdiff(gf, wf)), maxdiff(gp, wp)
        self.check(ds <= SERVE_TOL and dp <= SERVE_TOL,
                   f"torch backend sharded vs single: states {ds:.3g} "
                   f"preds {dp:.3g}")
        print(f"  (a) LARGE_1024 int8 torch backend, 4 x 4 rows vs 16: "
              f"states max |diff| {ds:.3g} (exact {ds == 0.0}), preds "
              f"{dp:.3g} (exact {dp == 0.0}) on {self.card}")

    def _sharded_server(self):
        """(b) A ``DistributedReservoirServer`` (4 shards x 4 slots)
        answers phase 3's 24-request burst in 32-step chunks: least-loaded
        admission seats request k on shard k % 4; each chunk is one B2
        launch per shard holding a live slot, the readout fused; every
        answer == the single-device engine's at the 16-slot pool shape;
        the profiler counts the same launches in a second burst.  Then µs
        per chunk against the single-device 16-slot server (host clock
        with a final sync, all arrivals at 0, in turns) and B2's
        device time per chunk (profiler)."""
        torch = self.torch
        from repro_torch.dist import (DistributedReservoirServer,
                                      ShardedReservoirEngine)
        from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                                       ServeStats)
        params, specs = self.params_1024, self.specs_1024
        self._single_1024 = single = ReservoirEngine(params)
        self._sharded_1024 = sharded = ShardedReservoirEngine(
            params, mesh=self.mesh4)
        b2 = self._counted["specialized_rollout"]

        def server():
            return DistributedReservoirServer(
                sharded, slots_per_shard=4, chunk_steps=32,
                stats=ServeStats(), devices=self.shard_devices)

        srv = server()
        for spec in specs:
            srv.submit(spec, arrival_time=0.0)
        placed, per_chunk = {}, []

        def serve():
            while True:
                chunks, before = srv.stats.chunks, b2.launches
                if not srv.step():
                    return
                if srv.stats.chunks == chunks:
                    continue
                if not placed:
                    placed.update({q.uid: srv.batcher.shard_of(i) for i, q
                                   in enumerate(srv.batcher._slots)
                                   if q is not None})
                live = {srv.batcher.shard_of(s)
                        for s in srv.batcher.last_take}
                per_chunk.append((len(live), b2.launches - before))

        _, made = self._drive(serve, self.sharded_launches)
        res = srv.results
        spread = [sum(1 for s in placed.values() if s == k)
                  for k in range(4)]
        self.check(placed == {k: k % 4 for k in range(16)},
                   f"least-loaded placement {placed}")
        self.check(all(n == m for n, m in per_chunk),
                   f"B2 launches per chunk != live shards: {per_chunk}")
        live_total = sum(n for n, _ in per_chunk)
        self.check(made["specialized_rollout"] == live_total
                   == made["rollout_readout"],
                   f"server launches {made}, one with its readout fused per "
                   f"live shard and chunk ({live_total})")
        exact = len(res) == len(specs) and all(
            self._pool_exact(single, spec.inputs, res[spec.uid].preds)
            for spec in specs)
        self.check(exact, "sharded server != single engine at the pool "
                   "shape")
        print(f"  (b) server: {len(res)} answered, first 16 placed "
              f"{spread} per shard (request k on shard k % 4: "
              f"{placed == {k: k % 4 for k in range(16)}}), "
              f"{srv.stats.chunks} chunks, B2 launches per chunk "
              f"{[m for _n, m in per_chunk]} (== shards with a live slot "
              f"{all(n == m for n, m in per_chunk)}), launches {made}; "
              f"answers == single engine at the pool shape {exact}")
        # the profiler's count of one burst's B2 launches: the server's
        # warm-up (one per shard) and one per live shard per chunk
        def burst():
            srv = server()
            for spec in specs:
                srv.submit(spec, arrival_time=0.0)
            srv.run()

        burst_us = self._device_us(burst, "rollout_kernel", n=1,
                                   per_call=4 + live_total)
        print(f"  (b) profiler: {4 + live_total} rollout_kernel launches "
              f"per burst (4 warm-up + {live_total} served), "
              f"{burst_us:.1f} us of B2 device time on {self.card}")
        # µs per chunk, in turns: single, sharded, sharded, single, ...
        walls = {"single": [], "sharded": []}
        chunks = {"single": 0, "sharded": 0}
        for name in ["single", "sharded", "sharded", "single"] * 3:
            srv = (server() if name == "sharded" else AsyncReservoirServer(
                single, n_slots=16, chunk_steps=32, stats=ServeStats()))
            for spec in specs:
                srv.submit(spec, arrival_time=0.0)

            def run(srv=srv):
                t0 = time.perf_counter()
                srv.run()
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            wall, _ = self._drive(run, self.sharded_launches
                                  if name == "sharded" else None)
            walls[name].append(wall)
            chunks[name] += srv.stats.chunks
        us = {k: sum(w) / chunks[k] * 1e6 for k, w in walls.items()}
        u = torch.zeros((16, 32, 1), device=self.dev)
        x0 = torch.zeros((16, params.config.reservoir_dim), device=self.dev)
        dev_us = {
            "sharded": self._device_us(
                lambda: sharded.run_segment(u, x0, defer_sync=True),
                "rollout_kernel", n=2, per_call=4),
            "single": self._device_us(
                lambda: single.run_segment(u, x0, defer_sync=True),
                "rollout_kernel", n=2)}
        self.sharded_times = dict(us_per_chunk=us, device_us=dev_us,
                                  b2_per_chunk=[m for _n, m in per_chunk])
        print(f"  (b) us per 32-step chunk, all arrivals at 0, 6 bursts "
              f"each in turns: sharded 4 x 4 {us['sharded']:.1f} "
              f"(bursts {[round(w * 1e3, 3) for w in walls['sharded']]} ms)"
              f" vs single 16-slot {us['single']:.1f} (bursts "
              f"{[round(w * 1e3, 3) for w in walls['single']]} ms), "
              f"{us['sharded'] / us['single']:.2f}x; B2 device time per "
              f"full chunk {dev_us['sharded']:.2f} us (4 launches of 4 "
              f"rows) vs {dev_us['single']:.2f} us (1 launch of 16) on "
              f"{self.card}")

    def _timed_rebuilds(self, srv, log):
        """Wrap ``srv.shrink`` / ``srv.grow`` to log each rebuild's ms
        (host clock, device synced on both sides)."""
        torch = self.torch

        def timed(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                log[name].append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        srv.shrink = timed("shrink", srv.shrink)
        srv.grow = timed("grow", srv.grow)

    def _shard_loss(self):
        """(c) A fault plan kills shard 3 after two chunks: the server
        shrinks 4 -> 3, then ``grow(1)`` restores 4 under the burst: zero
        drops, carried sequences readmitted, every answer bit-exact."""
        from repro_torch.dist import DistributedReservoirServer
        from repro_torch.runtime.faults import FaultEvent, FaultPlan
        from repro_torch.serve import ServeStats, SubmitSpec
        plan = FaultPlan([FaultEvent("shard_loss", at=2e-3, shard=3)])
        srv = DistributedReservoirServer(
            self._sharded_1024, slots_per_shard=4, chunk_steps=32,
            chunk_time=1e-3, fault_plan=plan, stats=ServeStats(),
            devices=self.shard_devices)
        rebuild_ms = {"shrink": [], "grow": []}
        self._timed_rebuilds(srv, rebuild_ms)
        inputs = self._burst(24, 67)
        for i, x in enumerate(inputs):
            srv.submit(SubmitSpec(x, uid=i), arrival_time=0.0)
        widths = []

        def serve():
            grown = None
            while srv.step():
                if grown is None and srv.reshards:
                    widths.append(srv.n_shards)
                    grown = srv.grow(1)
                    widths.append(srv.n_shards)
            return grown

        grown, made = self._drive(serve, self.sharded_launches)
        st = srv.stats
        exact = len(srv.results) == len(inputs) and all(
            self._pool_exact(self._single_1024, x, srv.results[i].preds)
            for i, x in enumerate(inputs))
        self.check(plan.injected == {"shard_loss": 1}
                   and widths == [3, 4] and srv.n_shards == 4
                   and srv.reshards == 1 and srv.grows == 1,
                   f"shard loss: injected {plan.injected}, widths {widths}")
        self.check(st.completed == len(inputs) and st.timed_out == 0
                   and st.admitted == st.enqueued == len(inputs)
                   and srv.readmitted > 0,
                   f"shard loss dropped requests: {st.completed} completed,"
                   f" {srv.readmitted} readmitted")
        self.check(exact, "answers across shrink/grow != single engine")
        self.rebuild_ms = rebuild_ms
        print(f"  (c) shard loss: widths 4 -> {widths}, {srv.readmitted} "
              f"sequences carried, {st.completed}/{len(inputs)} served, "
              f"{st.timed_out} dropped, answers == single engine at the "
              f"pool shape {exact}; rebuild ms: shrink "
              f"{[round(t, 3) for t in rebuild_ms['shrink']]}, grow "
              f"{[round(t, 3) for t in rebuild_ms['grow']]} on {self.card};"
              f" launches {made}")

    def _sharded_autoscale(self):
        """(d) An ``AutoscalePolicy`` grows a 1-shard server on the
        burst's backlog and shrinks it as the tail drains, never past
        the pool of 4: zero drops, answers bit-exact."""
        from repro_torch.dist import (DistributedReservoirServer,
                                      ShardedReservoirEngine)
        from repro_torch.launch.mesh import make_data_mesh
        from repro_torch.runtime.elastic import AutoscalePolicy
        from repro_torch.serve import ServeStats, SubmitSpec
        srv = DistributedReservoirServer(
            ShardedReservoirEngine(self.params_1024, mesh=make_data_mesh(
                devices=self.shard_devices[:1])),
            slots_per_shard=4, chunk_steps=32, chunk_time=1e-3,
            stats=ServeStats(), devices=self.shard_devices,
            autoscale=AutoscalePolicy(min_shards=1, max_shards=8,
                                      cooldown_steps=1))
        inputs = self._burst(32, 73, lo=32, hi=257)
        for i, x in enumerate(inputs):
            srv.submit(SubmitSpec(x, uid=i), arrival_time=0.0)
        widths = []

        def serve():
            while srv.step():
                widths.append(srv.n_shards)

        _, made = self._drive(serve, self.sharded_launches)
        exact = len(srv.results) == len(inputs) and all(
            self._pool_exact(self._single_1024, x, srv.results[i].preds)
            for i, x in enumerate(inputs))
        self.check(srv.grows >= 1 and srv.reshards >= 1
                   and max(widths) == 4 and min(widths) >= 1,
                   f"autoscale: widths {widths}, {srv.grows} grows, "
                   f"{srv.reshards} shrinks")
        self.check(srv.stats.completed == len(inputs) and exact,
                   "autoscaled answers")
        print(f"  (d) autoscale: widths per step {widths}, {srv.grows} "
              f"grows, {srv.reshards} shrinks (pool of 4, the policy's "
              f"max 8), {srv.stats.completed}/{len(inputs)} served, "
              f"answers == single engine {exact}; launches {made}")

    def _sharded_ridge(self):
        """(e) ``ridge_fit_sharded`` over the training states cut into the
        4 shards (each on its shard's device) against ``ridge_fit`` on all
        rows: the fitted values within RIDGE_TOL (a float32 Gram summed
        per shard, solved by a float32 eigendecomposition on the card,
        against one Gram solved in float64 on the host)."""
        from repro_torch.core.ridge import ridge_fit, ridge_fit_sharded
        x, y = self.train_1024
        xs = [c.to(d) for c, d in zip(x.chunk(4), self.shard_devices)]
        ys = [c.to(d) for c, d in zip(y.chunk(4), self.shard_devices)]
        w_sh = ridge_fit_sharded(xs, ys, RIDGE_LAM, "data")
        w_one = ridge_fit(x, y, lam=RIDGE_LAM)
        d = maxdiff(x @ w_sh, x @ w_one)
        self.check(bool(self.torch.isfinite(w_sh).all())
                   and d <= RIDGE_TOL,
                   f"sharded ridge fit vs ridge_fit: fitted values {d:.3g}")
        print(f"  (e) ridge_fit_sharded over 4 shards ({x.shape[0]} rows) "
              f"vs ridge_fit: fitted values max |diff| {d:.3g} (tol "
              f"{RIDGE_TOL}), weights {maxdiff(w_sh, w_one):.3g}")

    # -- lm_serve ------------------------------------------------------------
    def _kernel_counters(self) -> dict:
        """Every kernel entry point, by name."""
        from repro_torch.kernels.bcsr_matmul import bcsr_matmul as b4
        from repro_torch.kernels.bitplane_gemv import bitplane_gemv as b3
        from repro_torch.kernels.reservoir_step import reservoir_step as b5
        return {**self._counted, "bitplane_gemv": b3.bitplane_gemv,
                "bcsr_matmul": b4.bcsr_matmul,
                "reservoir_step": b5.reservoir_step}

    def _events(self, n):
        return [self.torch.cuda.Event(enable_timing=True) for _ in range(n)]

    def lm_serve(self):
        """The LM substrate's serving path at mistral-nemo-12b's full width,
        bf16, seeded random weights on the card: (1) the model and its
        parameter count; (2) eight prompts grouped by the port's
        ``PaddingBucketer`` into four exactly filled buckets, each prefilled
        through ``make_prefill_step`` and decoded greedily through
        ``make_decode_step``, timed by CUDA events beside the roofline
        functions' bounds; (3) decode == teacher forcing at 512 tokens; (4)
        chunked attention == dense on layer 0 of the 4096-token prompt; (5)
        int8 frozen-weight serving of the 512 bucket against the bf16 path.
        The path launches none of B1-B5 (checked)."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models.common import tree_leaves
        from repro_torch.models.transformer import LM
        counters = self._kernel_counters()
        self._zero(counters)
        cfg = get_config(LM_ARCH)
        lm = LM(cfg, device=self.dev)
        n = lm.param_count()
        self.check(n == LM_PARAMS, f"{LM_ARCH} param_count {n:,} != the "
                   f"reference's {LM_PARAMS:,}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device=self.dev).manual_seed(0)
                         ).params
        torch.cuda.synchronize()
        nbytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
        self.check(lm.param_count(params) == LM_PARAMS,
                   "initialized tree's parameter count")
        print(f"(1) {LM_ARCH}: {n:,} parameters, {nbytes / 1e9:.3f} GB "
              f"({cfg.dtype}), drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s; {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, {cfg.n_heads} heads / "
              f"{cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")
        first = self._lm_buckets(lm, params, n)
        self._lm_teacher_forcing(lm, params, first["prompt"])
        self._lm_chunked_attention(lm, params, first["long"])
        del first["long"]
        self._lm_int8(lm, params, first)
        del params, first
        torch.cuda.empty_cache()
        made = self._made(counters)
        self.lm_launches = made
        print(f"lm_serve launches of B1-B5 and the readout: {made}")
        self.check(not any(made.values()), "the LM path launched a "
                   "reservoir kernel")

    def _lm_buckets(self, lm, params, n_params, prompts=LM_PROMPTS,
                    len_buckets=LM_LEN_BUCKETS, extra=None,
                    tag="(2)") -> dict:
        """(2) Prefill and greedy decode of each bucket, beside its bound:
        the ported roofline's, which counts a MoE's active parameters, and
        for a MoE also the bound with every parameter read.  ``extra(b)``
        gives a bucket's other inputs (whisper's frames)."""
        torch = self.torch
        from repro_torch.configs import ShapeSpec
        from repro_torch.launch import roofline as rf
        from repro_torch.launch.steps import (make_decode_step,
                                              make_prefill_step)
        from repro_torch.serve import (PaddingBucketer, RolloutRequest,
                                       ServeStats)
        cfg = lm.cfg
        rng = np.random.default_rng(19)
        reqs = [RolloutRequest(uid=i, inputs=rng.integers(
                    0, cfg.vocab_size, (n, 1)).astype(np.int32))
                for i, n in enumerate(prompts)]
        bucketer = PaddingBucketer(len_buckets=len_buckets,
                                   batch_buckets=(1, 2, 4, 8))
        mbs = bucketer.group(reqs)
        shapes = [mb.inputs.shape[:2] for mb in mbs]
        want = [(prompts.count(n), n) for n in len_buckets]
        self.check(shapes == want
                   and all(mb.real_steps == mb.padded_steps for mb in mbs),
                   f"buckets {shapes} filled exactly")
        more = extra or (lambda b: {})
        decode = make_decode_step(lm, None)
        # warm-up of every bucket's shapes (library handles and plans, the
        # allocator's first blocks): unwarmed, the 512 x 4 bucket's prefill
        # measured 130 ms in one run on the H100 and 386 ms in another
        for mb in mbs:
            warm = torch.as_tensor(mb.inputs[:, :, 0], device=self.dev)
            lg, c = make_prefill_step(lm, None, warm.shape[1] + 2)(
                params, {"tokens": warm, **more(warm.shape[0])})
            decode(params, c, lg.argmax(-1))
            del lg, c
        torch.cuda.synchronize()
        stats = ServeStats()
        first = {}
        self.lm_times = {}
        n_act = rf.active_params(cfg, n_params)
        for mb in mbs:
            bpad, tpad = mb.inputs.shape[:2]
            toks = torch.as_tensor(mb.inputs[:, :, 0], device=self.dev).long()
            batch = {"tokens": toks, **more(bpad)}
            prefill = make_prefill_step(lm, None, tpad + LM_DECODE_STEPS)
            e = self._events(3)
            e[0].record()
            logits, caches = prefill(params, batch)
            e[1].record()
            tok = logits.argmax(-1)
            out = [tok]
            for step in range(LM_DECODE_STEPS):
                if step == 0 and tpad == len_buckets[0]:
                    first.update(tok=tok, prompt=toks[:1], prompt_batch=toks,
                                 batch=batch)
                logits, caches = decode(params, caches, tok)
                if step == 0 and tpad == len_buckets[0]:
                    first["logits"] = logits.float()
                tok = logits.argmax(-1)
                out.append(tok)
            e[2].record()
            torch.cuda.synchronize()
            if tpad == 4096:
                first["long"] = toks
            seq = torch.cat(out, dim=1)
            self.check(bool(torch.isfinite(logits).all()) and seq.shape ==
                       (bpad, LM_DECODE_STEPS + 1) and int(seq.min()) >= 0
                       and int(seq.max()) < cfg.vocab_size,
                       f"bucket {tpad} x {bpad}: finite logits, tokens")
            self.check(int(caches["index"]) == tpad + LM_DECODE_STEPS,
                       f"bucket {tpad}: cache index")
            del caches, logits
            pf_ms = e[0].elapsed_time(e[1])
            dec_ms = e[1].elapsed_time(e[2]) / LM_DECODE_STEPS
            stats.record_call(batch=bpad, steps=tpad, seconds=pf_ms / 1e3,
                              real_steps=mb.real_steps)
            stats.record_call(batch=bpad, steps=LM_DECODE_STEPS,
                              seconds=dec_ms * LM_DECODE_STEPS / 1e3,
                              real_steps=LM_DECODE_STEPS * len(mb.requests))
            pshape = ShapeSpec("bucket", tpad, bpad, "prefill")
            dshape = ShapeSpec("bucket", tpad + LM_DECODE_STEPS, bpad,
                               "decode")
            bounds, every = {}, {}
            for kind, shape in (("prefill", pshape), ("decode", dshape)):
                bounds[kind] = _lm_bound(rf, cfg, shape, n_params, n_act,
                                         n_act)
                every[kind] = _lm_bound(rf, cfg, shape, n_params, n_act,
                                        n_params)
            self.lm_times[tpad] = dict(batch=bpad, prefill_ms=pf_ms,
                                       decode_ms=dec_ms, bounds=bounds,
                                       bounds_all_weights=every)
            all_w = ""
            if n_act != n_params:
                all_w = (f"; every weight read: prefill "
                         f"{every['prefill'][0]:.2f} ms, decode "
                         f"{every['decode'][0]:.3f} ms by "
                         f"{every['decode'][1]}")
            print(f"{tag} bucket {tpad} x {bpad}: prefill {pf_ms:.2f} ms, "
                  f"{bpad * tpad / pf_ms * 1e3:,.0f} prompt tokens/s (bound "
                  f"{bounds['prefill'][0]:.2f} ms by "
                  f"{bounds['prefill'][1]}); decode {dec_ms:.3f} ms/step, "
                  f"{bpad / dec_ms * 1e3:,.1f} tokens/s (bound "
                  f"{bounds['decode'][0]:.3f} ms by {bounds['decode'][1]}"
                  f"{all_w}) on {self.card}")
        print(f"{tag} peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; serve "
              f"stats: {stats.render()}")
        return first

    def _lm_teacher_forcing(self, lm, params, prompt, extra=None,
                            tag="(3)", check=True) -> float:
        """(3) prefill(S + 1) == prefill(S) + one decode_step, within the
        reference's bf16 bound, with the same argmax; returns the gap.  A
        MoE also prints in how many layers the last token's top-k experts
        differ between the two paths.  ``check=False`` measures only."""
        torch = self.torch
        s = prompt.shape[1]
        more = extra or {}
        nxt = torch.randint(0, lm.cfg.vocab_size, (1, 1), device=self.dev,
                            generator=torch.Generator(device=self.dev
                                                      ).manual_seed(5))
        full_toks = torch.cat([prompt, nxt], dim=1)
        with self._routes() as (seen, route):
            full, _ = lm.prefill(params, {"tokens": full_toks, **more},
                                 cache_len=s + 1)
            n_full = len(seen)
            _, caches = lm.prefill(params, {"tokens": prompt, **more},
                                   cache_len=s + 1)
            n_part = len(seen)
            inc, _ = lm.decode_step(params, caches, nxt)
        a, b = inc.float(), full.float()
        gap = maxdiff(a, b)
        close = bool(torch.allclose(a, b, rtol=LM_TF_TOL, atol=LM_TF_TOL))
        same = int(a.argmax()) == int(b.argmax())
        if check:
            self.check(close and same, f"{lm.cfg.name}: decode != teacher "
                       f"forcing at {s}: gap {gap:.4g}, argmax "
                       f"{int(a.argmax())} vs {int(b.argmax())}")
        flips = ""
        if lm.cfg.moe is not None:
            m, n = lm.cfg.moe, 0
            for (xf, wf), (xd, wd) in zip(seen[:n_full], seen[n_part:]):
                top_f = route(xf[-1:], wf, m, aux=False)[0].sort().values
                top_d = route(xd, wd, m, aux=False)[0].sort().values
                n += int(not torch.equal(top_f, top_d))
            flips = (f"; the last token's top-{m.top_k} experts differ in "
                     f"{n} of {n_full} layers")
        print(f"{tag} {lm.cfg.name}: decode {'==' if check else 'vs'} "
              f"teacher forcing at {s} tokens: max |gap| {gap:.4g} (rtol = "
              f"atol = {LM_TF_TOL}{'' if check else ', not checked'}), "
              f"argmax equal {same}{flips}")
        return gap

    @contextlib.contextmanager
    def _routes(self):
        """Record each ``moe._route`` call's (normed input, router) while
        inside (instrumentation of this script: the package counts
        nothing); yields (the records, the unwrapped ``_route``)."""
        from repro_torch.models import moe as moe_lib
        route, seen = moe_lib._route, []

        def spy(x, router_w, m, aux=True):
            seen.append((x, router_w))
            return route(x, router_w, m, aux)

        moe_lib._route = spy
        try:
            yield seen, route
        finally:
            moe_lib._route = route

    def _lm_chunked_attention(self, lm, params, toks):
        """(4) The chunked online softmax against the dense path on layer
        0's q/k/v of the 4096-token prompt."""
        torch = self.torch
        from repro_torch.models.attention import attention
        from repro_torch.models.common import apply_norm, tree_map
        from repro_torch.models.gqa import _project_qkv
        cfg = lm.cfg
        g0 = tree_map(lambda a: a[0], params["groups"]["b0"])
        h = apply_norm(lm._embed(params, toks), g0["norm1"], cfg.norm)
        pos = torch.arange(toks.shape[1], device=self.dev)[None, :]
        q, k, v = _project_qkv(h, g0["attn"], cfg, pos)
        e = self._events(3)
        e[0].record()
        chunked = attention(q, k, v)
        e[1].record()
        dense = attention(q, k, v, dense_threshold=toks.shape[1])
        e[2].record()
        torch.cuda.synchronize()
        diff = (chunked.float() - dense.float()).abs()
        atol = LM_ATTN_VTOL * float(v.float().abs().max())
        within = bool((diff <= atol + LM_ATTN_RTOL * dense.float().abs()
                       ).all())
        gap = float(diff.max())
        self.check(within and bool(torch.isfinite(chunked).all()),
                   f"chunked attention vs dense at 4096: {gap:.4g}")
        print(f"(4) chunked (q 512 x kv 1024) == dense attention on layer 0 "
              f"at 4096 tokens: max |diff| {gap:.4g} (tol {atol:.4g} + "
              f"2^-7 |o|); {e[0].elapsed_time(e[1]):.2f} ms chunked, "
              f"{e[1].elapsed_time(e[2]):.2f} ms dense")

    def _lm_int8(self, lm, params, first, tag="(5)"):
        """(5) quantize_tree on the card, then the 512 bucket served from
        the int8 tree; the first decode step's logits against the bf16
        path's (the same fed token), correlation > LM_INT8_CORR."""
        torch = self.torch
        from repro_torch.configs import ShapeSpec
        from repro_torch.launch import roofline as rf
        from repro_torch.launch.steps import (make_decode_step,
                                              make_prefill_step)
        from repro_torch.models.common import tree_leaves
        from repro_torch.models.quantize import quantize_tree
        t0 = time.perf_counter()
        qparams = quantize_tree(params)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        leaves = tree_leaves(qparams)
        qbytes = sum(a.numel() * a.element_size() for a in leaves)
        q_elems = sum(a.numel() for a in leaves if a.dtype == torch.int8)
        n_q = sum(1 for a in leaves if a.dtype == torch.int8)
        print(f"{tag} quantize_tree on the card: {quant_s:.2f} s, {n_q} "
              f"leaves int8, {qbytes / 1e9:.3f} GB in all")
        bf16_ms = self.lm_times[512]["decode_ms"]
        prompts = first["prompt_batch"]
        bpad = prompts.shape[0]
        prefill = make_prefill_step(lm, None, 512 + LM_DECODE_STEPS)
        decode = make_decode_step(lm, None)
        _, caches = prefill(qparams, {"tokens": prompts})
        e = self._events(2)
        tok = first["tok"]
        e[0].record()
        for step in range(LM_DECODE_STEPS):
            logits, caches = decode(qparams, caches, tok)
            if step == 0:
                got = logits.float()
            tok = logits.argmax(-1)
        e[1].record()
        torch.cuda.synchronize()
        ms = e[0].elapsed_time(e[1]) / LM_DECODE_STEPS
        a, b = got.flatten().double(), first["logits"].flatten().double()
        corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        self.check(corr > LM_INT8_CORR and bool(torch.isfinite(got).all()),
                   f"int8 vs bf16 first decode step: correlation {corr:.5f}")
        # bounds: the int8 weights read once, and the traffic of the
        # expansion as written (per int8 element: the cast reads 1 B and
        # writes 2, the scale product reads 2 and writes 2, the product
        # reads 2; the embedding table's lookup reads only its rows)
        cache = rf.kv_cache_bytes(lm.cfg, ShapeSpec(
            "bucket", 512 + LM_DECODE_STEPS, bpad, "decode"))
        table = lm.cfg.vocab_size * lm.cfg.d_model
        ideal = (qbytes + cache) / rf.HBM_BW * 1e3
        written = ((9 * q_elems - 2 * table + (qbytes - q_elems) + cache)
                   / rf.HBM_BW * 1e3)
        self.lm_times["int8"] = dict(decode_ms=ms, corr=corr, bound_ms=ideal,
                                     written_bound_ms=written,
                                     quantize_s=quant_s)
        print(f"{tag} int8 decode, bucket 512 x {bpad}: {ms:.3f} ms/step "
              f"against bf16 {bf16_ms:.3f} ({ms / bf16_ms:.2f}x); bound "
              f"{ideal:.3f} ms with the int8 weights read once, "
              f"{written:.3f} ms for the expansion as written; first step's "
              f"logits vs bf16 correlation {corr:.5f} (> {LM_INT8_CORR}) on "
              f"{self.card}")
        print(f"{tag} peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del qparams, caches, logits, got


    # -- lm_blocks -----------------------------------------------------------
    def lm_blocks(self):
        """The rest of the LM substrate at full width, bf16, seeded random
        weights drawn on the card, one model at a time: (a) olmoe-1b-7b
        (MoE); (b) deepseek-v2-236b with its depth cut (MLA + MoE); (c)
        recurrentgemma-2b, xlstm-350m and whisper-base.  Each: its
        parameter count against the reference's, prefill and greedy decode
        per bucket beside the roofline's bounds, decode == teacher forcing;
        the MoE configs also the share of assignments dropped by capacity,
        olmoe its int8 serving.  The path launches none of B1-B5."""
        torch = self.torch
        counters = self._kernel_counters()
        self._zero(counters)
        print(f"lm_blocks on {self.card}")
        self.blocks = {}
        self._lm_olmoe()
        self._lm_deepseek()
        for arch in ("recurrentgemma-2b", "xlstm-350m", "whisper-base"):
            self._lm_recurrent_or_encdec(arch)
        made = self._made(counters)
        self.blocks_launches = made
        print(f"lm_blocks launches of B1-B5 and the readout: {made}")
        self.check(not any(made.values()), "the LM blocks launched a "
                   "reservoir kernel")

    def _lm_load(self, arch, tag, **over):
        """A full-width config's LM and its bf16 parameters drawn on the
        card, the count held to the reference's."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models.common import tree_leaves
        from repro_torch.models.transformer import LM
        cfg = get_config(arch).replace(**over)
        lm = LM(cfg, device=self.dev)
        n = lm.param_count()
        self.check(n == BLOCKS_PARAMS[arch], f"{arch} param_count {n:,} != "
                   f"the reference's {BLOCKS_PARAMS[arch]:,}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device=self.dev).manual_seed(0)
                         ).params
        torch.cuda.synchronize()
        nbytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
        cut = (f"; reduced: n_layers {get_config(arch).n_layers} -> "
               f"{cfg.n_layers}" if over else "")
        print(f"{tag} {arch}: {n:,} parameters, {nbytes / 1e9:.3f} GB "
              f"({cfg.dtype}), drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s (peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB); "
              f"{cfg.n_layers} layers {cfg.block_pattern}, d_model "
              f"{cfg.d_model}{cut}")
        return lm, params, n

    def _lm_full_capacity(self, lm, s, tag):
        """The same model with capacity_factor = n_experts / top_k: every
        expert can take every token, so a prefill of ``s + 1`` tokens and
        one of ``s`` plus a decode step route alike (the reference's
        ``reduced()`` sets it so for the same reason)."""
        from repro_torch.models.transformer import LM
        m = lm.cfg.moe
        cap = lambda t: max(int(np.ceil(t * m.top_k * m.capacity_factor
                                        / m.n_experts)), 1)
        print(f"{tag} teacher forcing on a copy with capacity_factor = "
              f"{m.n_experts} / {m.top_k}: at {m.capacity_factor} a "
              f"{s + 1}-token prefill (capacity {cap(s + 1)} per expert) "
              f"and a 1-token decode step (capacity {cap(1)}) keep "
              f"different assignments")
        return LM(lm.cfg.replace(moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k)), device=self.dev)

    def _lm_olmoe(self):
        torch = self.torch
        arch = "olmoe-1b-7b"
        lm, params, n = self._lm_load(arch, "(a)")
        first = self._lm_buckets(lm, params, n, tag="(a)")
        self.blocks[arch] = self.lm_times
        self._moe_drops(lm, params, first, "(a)")
        self.lm_times["tf_gap"] = self._lm_teacher_forcing(
            self._lm_full_capacity(lm, first["prompt"].shape[1], "(a)"),
            params, first["prompt"], tag="(a)")
        self.lm_times["tf_gap_own_capacity"] = self._lm_teacher_forcing(
            lm, params, first["prompt"], tag="(a)", check=False)
        self._lm_int8(lm, params, first, tag="(a)")
        del params, first
        torch.cuda.empty_cache()

    def _lm_deepseek(self):
        torch = self.torch
        from repro_torch.models import mla as mla_lib
        arch = "deepseek-v2-236b"
        lm, params, n = self._lm_load(arch, "(b)", n_layers=DEEPSEEK_LAYERS)
        first = self._lm_buckets(lm, params, n, prompts=(512,) * 4 + (4096,),
                                 len_buckets=(512, 4096), tag="(b)")
        self.blocks[arch] = self.lm_times
        self._moe_drops(lm, params, first, "(b)")
        self.lm_times["tf_gap"] = self._lm_teacher_forcing(
            self._lm_full_capacity(lm, first["prompt"].shape[1], "(b)"),
            params, first["prompt"], tag="(b)")
        self.lm_times["tf_gap_own_capacity"] = self._lm_teacher_forcing(
            lm, params, first["prompt"], tag="(b)", check=False)
        cfg, m = lm.cfg, lm.cfg.mla
        c = mla_lib.init_cache(1, 1, cfg, lm.dtype, device=self.dev)
        latent = sum(c[k].numel() * c[k].element_size()
                     for k in ("c_kv", "k_rope"))
        mha = cfg.n_heads * (m.nope_dim + m.rope_dim + m.v_dim) * 2
        self.check(latent == (m.kv_lora + m.rope_dim) * 2,
                   "MLA latent cache bytes per token")
        print(f"(b) latent cache: {latent:,} B per token per layer "
              f"((kv_lora {m.kv_lora} + rope {m.rope_dim}) x 2 B) against "
              f"{mha:,} B for a cache of the decompressed keys and values "
              f"({cfg.n_heads} heads x (k {m.nope_dim + m.rope_dim} + v "
              f"{m.v_dim}) x 2 B): {mha / latent:.1f}x smaller")
        del params, first, c
        torch.cuda.empty_cache()

    def _lm_recurrent_or_encdec(self, arch):
        torch = self.torch
        lm, params, n = self._lm_load(arch, "(c)")
        cfg = lm.cfg
        extra, more = None, None
        prompts = (512,) * 4
        if cfg.encoder is not None:
            # stub frame embeddings (the conv frontend is stubbed in both
            # packages), 1500 per request, and Whisper's text context
            frames = torch.randn((4, cfg.encoder.seq_len, cfg.d_model),
                                 generator=torch.Generator(
                                     device=self.dev).manual_seed(7),
                                 device=self.dev, dtype=lm.dtype)
            extra = lambda b: {"frames": frames[:b]}
            more = {"frames": frames[:1]}
            prompts = (WHISPER_TEXT_CTX,) * 4
        first = self._lm_buckets(lm, params, n, prompts=prompts,
                                 len_buckets=(prompts[0],), extra=extra,
                                 tag="(c)")
        self.blocks[arch] = self.lm_times
        prompt = first["prompt"]
        if "mlstm" in cfg.block_pattern:
            # prefill(S + 1) needs S + 1 to be a multiple of the mLSTM chunk
            # (256) or below it: 255 + 1
            prompt = prompt[:, :255]
        self.lm_times["tf_gap"] = self._lm_teacher_forcing(
            lm, params, prompt, more, tag="(c)")
        if "slstm" in cfg.block_pattern:
            self._slstm_prefill(lm, params, first["prompt_batch"])
        del params, first
        torch.cuda.empty_cache()

    def _slstm_prefill(self, lm, params, toks):
        """(c) One sLSTM layer's prefill (a Python loop over the 512
        steps, as the reference's lax.scan) beside one mLSTM layer's
        (chunkwise, 2 chunks of 256), on layer 0's normed embeddings."""
        torch = self.torch
        from repro_torch.device import ieee_fp32
        from repro_torch.models import xlstm as xl
        from repro_torch.models.common import apply_norm, tree_map
        cfg = lm.cfg
        g0 = tree_map(lambda a: a[0], params["groups"])
        kinds = {k: f"b{i}" for i, k in enumerate(cfg.block_pattern)}
        with ieee_fp32(self.dev):
            h = apply_norm(lm._embed(params, toks),
                           g0[kinds["slstm"]]["norm1"], cfg.norm)
            xl.slstm_forward(h, g0[kinds["slstm"]]["mixer"], cfg)  # warm
            e = self._events(3)
            e[0].record()
            xl.slstm_forward(h, g0[kinds["slstm"]]["mixer"], cfg)
            e[1].record()
            xl.mlstm_chunk_forward(h, g0[kinds["mlstm"]]["mixer"], cfg)
            e[2].record()
        torch.cuda.synchronize()
        s_ms, m_ms = e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])
        n_s = cfg.n_layers // len(cfg.block_pattern)
        self.lm_times["slstm_layer_ms"] = s_ms
        self.lm_times["mlstm_layer_ms"] = m_ms
        s = toks.shape[1]
        print(f"(c) xlstm-350m prefill of {s} x {toks.shape[0]}: one sLSTM "
              f"layer {s_ms:.2f} ms ({s_ms / s * 1e3:.1f} us per step, {n_s} "
              f"such layers), one mLSTM layer {m_ms:.2f} ms, on {self.card}")

    def _moe_drops(self, lm, params, first, tag):
        """The share of routed assignments dropped by capacity, reckoned
        from the port's ``_route`` and the capacity formula on every MoE
        layer's normed input, captured by wrapping ``_route`` during an
        untimed prefill of the first bucket and one decode step."""
        torch = self.torch
        m = lm.cfg.moe
        s = first["prompt_batch"].shape[1]
        with self._routes() as (seen, route):
            _, caches = lm.prefill(params, first["batch"], cache_len=s + 1)
            n_pre = len(seen)
            lm.decode_step(params, caches, first["tok"])
        del caches

        def share(calls):
            drops = total = 0
            for x, w in calls:
                idx, _, _ = route(x, w, m, aux=False)
                cap = max(int(np.ceil(idx.shape[0] * m.top_k
                                      * m.capacity_factor / m.n_experts)), 1)
                counts = torch.bincount(idx.reshape(-1),
                                        minlength=m.n_experts)
                drops += int((counts - cap).clamp(min=0).sum())
                total += idx.numel()
            return drops, total, cap

        pre, dec, l0 = (share(seen[:n_pre]), share(seen[n_pre:]),
                        share(seen[n_pre:n_pre + 1]))
        self.lm_times["drops"] = dict(prefill=pre[0] / pre[1],
                                      decode=dec[0] / dec[1],
                                      decode_layer0=l0[0] / l0[1])
        b = first["prompt_batch"].shape[0]
        print(f"{tag} capacity drops (factor {m.capacity_factor}): decode "
              f"step at batch {b}, layer 0: {l0[0]} of {l0[1]} assignments "
              f"({l0[0] / l0[1]:.1%}, capacity {l0[2]} per expert), all "
              f"{len(seen) - n_pre} layers {dec[0] / dec[1]:.1%}; prefill "
              f"of {s} x {b}: {pre[0]} of {pre[1]} ({pre[0] / pre[1]:.2%}, "
              f"capacity {pre[2]})")

    # -- phase 7 -------------------------------------------------------------
    def train(self):
        """(a) The paper's Mackey-Glass task through the reservoir path on
        the card (B2 serves the test predictions); (b) stablelm-1.6b
        trained at full width for TRAIN_STEPS steps, then a checkpoint
        round trip.  Counts every kernel's launches over the phase; (b)
        must launch none."""
        counters = self._kernel_counters()
        self._zero(counters)
        print(f"train on {self.card}")
        self._train_mackey_glass()
        made_a = self._made(counters)
        print(f"(a) launches of B1-B5 and the readout: {made_a}")
        self.check(made_a["specialized_rollout"] > 0
                   and made_a["rollout_readout"] > 0,
                   "Mackey-Glass was not served by B2 with its readout")
        self._train_lm()
        made = self._made(counters)
        self.train_launches = made
        made_b = {k: made[k] - made_a[k] for k in made}
        print(f"(b) launches of B1-B5 and the readout: {made_b}")
        self.check(not any(made_b.values()), "LM training launched a "
                   "reservoir kernel")

    def _train_mackey_glass(self):
        torch = self.torch
        from repro_torch.configs.esn_paper import LARGE_1024
        from repro_torch.core.esn import (fit_readout, init_esn, nrmse,
                                          predict, run_readout,
                                          run_reservoir)
        from repro_torch.data.pipeline import mackey_glass
        t0 = time.perf_counter()
        sig = mackey_glass(3000, seed=0)
        u = torch.as_tensor(sig[:-1, None], device=self.dev)
        y = torch.as_tensor(sig[1:, None], device=self.dev)
        params = init_esn(LARGE_1024, device=self.dev)
        states = run_reservoir(params, u)
        print(f"(a) Mackey-Glass: 3000 steps, LARGE_1024 int8-CSD (w.scale "
              f"{params.w.scale!r}), states in {time.perf_counter() - t0:.2f}"
              " s")
        for lam, bound in MG_NRMSE_BOUND.items():
            fit = fit_readout(params, states[500:2000], y[500:2000], lam=lam)
            train = float(nrmse(predict(fit, states[500:2000]),
                                y[500:2000]).item())
            preds = run_readout(fit, u)        # B2, the readout fused
            test = float(nrmse(preds[2000:], y[2000:]).item())
            print(f"    ridge {lam:g}: NRMSE train {train!r} test {test!r} "
                  f"(served by run_readout; bound {bound!r})")
            self.check(np.isfinite(train) and np.isfinite(test)
                       and test <= bound, f"Mackey-Glass test NRMSE {test} "
                       f"over {bound} at ridge {lam:g}")

    def _train_lm(self):
        """stablelm-1.6b: parameters drawn on the card, TRAIN_STEPS steps
        of ``make_train_step`` timed by CUDA events, the checks on the
        losses, then ``_train_checkpoint``."""
        torch = self.torch
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.data.pipeline import LMStreamConfig, lm_batch
        from repro_torch.launch import roofline as rf
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.transformer import LM
        from repro_torch.optim import adamw
        cfg = get_config(TRAIN_ARCH)
        lm = LM(cfg, device=self.dev)
        n = lm.param_count()
        self.check(n == TRAIN_PARAMS, f"{TRAIN_ARCH} param_count {n:,} != "
                   f"the reference's {TRAIN_PARAMS:,}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device=self.dev).manual_seed(0)
                         ).params
        state = {"params": params, "opt": adamw.init_state(params)}
        torch.cuda.synchronize()
        state_gb = torch.cuda.memory_allocated() / 1e9
        print(f"(b) {TRAIN_ARCH}: {n:,} parameters (the reference's "
              f"{TRAIN_PARAMS:,}), {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}, "
              f"{cfg.microbatches} microbatches; state (params + AdamW "
              f"m, v) {state_gb:.2f} GB drawn in "
              f"{time.perf_counter() - t0:.2f} s")
        stream = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, seed=0,
                                structure=0.8)
        t0 = time.perf_counter()
        batches = [{"tokens": torch.as_tensor(
            lm_batch(stream, i)["tokens"], dtype=torch.long,
            device=self.dev)} for i in range(TRAIN_STEPS + 1)]
        print(f"    lm_batch: {TRAIN_STEPS + 1} batches of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ + 1} tokens in {time.perf_counter() - t0:.2f} s "
              f"(reduced: train_4k's 256 x 4096 cut to {TRAIN_BATCH} x "
              f"{TRAIN_SEQ})")
        step_fn = make_train_step(lm, None, adamw.AdamWConfig(**TRAIN_OPT))
        ev = self._events(2 * TRAIN_STEPS)
        metrics = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            ev[2 * i].record()
            state, m = step_fn(state, batches[i])
            ev[2 * i + 1].record()
            metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        ms = [ev[2 * i].elapsed_time(ev[2 * i + 1])
              for i in range(TRAIN_STEPS)]
        rows = {k: torch.stack([m[k] for m in metrics]).float().cpu()
                .numpy() for k in ("loss", "grad_norm", "lr")}
        for i in range(0, TRAIN_STEPS, 10):
            self._train_row(rows, ms, i)
        self._train_row(rows, ms, TRAIN_STEPS - 1)
        steady = sorted(ms[2:])
        med = steady[len(steady) // 2]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        flops = rf.model_flops(cfg, shape, rf.active_params(cfg, n))
        bound_ms = flops / rf.PEAK_FLOPS * 1e3
        print(f"    ms per step (CUDA events, steps 3-{TRAIN_STEPS}): "
              f"median {med:.2f}, min {steady[0]:.2f}, max "
              f"{steady[-1]:.2f}; first two {ms[0]:.2f} / {ms[1]:.2f}; "
              f"wall {wall:.2f} s for {TRAIN_STEPS} steps")
        print(f"    tokens/s {tokens / med * 1e3:.1f}; model FLOPs per step "
              f"{flops:.4e} (6 N D): {flops / med * 1e3 / 1e12:.2f} TFLOP/s "
              f"= {flops / med * 1e3 / rf.PEAK_FLOPS:.2%} of "
              f"{rf.PEAK_FLOPS / 1e12:.0f} TFLOP/s (bound {bound_ms:.2f} ms "
              f"per step); peak memory {peak:.2f} GB on {self.card}")
        first = float(np.mean(rows["loss"][:5]))
        last = float(np.mean(rows["loss"][-5:]))
        print(f"    loss {first!r} -> {last!r} (means of the first and "
              f"last 5 steps)")
        self.check(all(np.isfinite(v).all() for v in rows.values()),
                   "a loss, grad norm or lr is not finite")
        self.check(last < first - TRAIN_DROP, f"loss did not fall by "
                   f"{TRAIN_DROP}: {first} -> {last}")
        self._train_breakdown(lm, state, batches[0])
        self._train_checkpoint(lm, state, step_fn, batches[TRAIN_STEPS])

    # -- mesh --------------------------------------------------------------
    def mesh(self):
        """The LM substrate on the (1, 1) NCCL mesh of ``make_host_mesh()``
        against ``mesh=None``: (a) training, (b) serving a MoE.  Counts
        every kernel's launches over the phase (must be 0)."""
        torch = self.torch
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_host_mesh, one_rank_group
        counters = self._kernel_counters()
        self._zero(counters)
        with one_rank_group(self.dev):
            mesh = make_host_mesh()
            print(f"mesh on {self.card}: {mesh.shape} over "
                  f"{mesh.size} rank, backend {dist.get_backend()}, "
                  f"torch {torch.__version__}")
            self._mesh_train(mesh)
            self._mesh_decode(mesh)
        made = self._made(counters)
        self.mesh_launches = made
        print(f"launches of B1-B5 and the readout: {made}")
        self.check(not any(made.values()), "the mesh phase launched a "
                   "reservoir kernel")

    @staticmethod
    def _local(t):
        """A DTensor's shard (on a mesh of one: the whole tensor)."""
        return t.to_local() if hasattr(t, "to_local") else t

    def _mesh_train(self, mesh):
        """(a) MESH_TRAIN_STEPS steps of stablelm-1.6b (the train phase's
        configuration and batches) without a mesh, then on it, from the
        same seeded parameters."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import LMStreamConfig, lm_batch
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.common import tree_leaves_with_path
        from repro_torch.models.transformer import LM, lm_param_shardings
        from repro_torch.optim import adamw
        from repro_torch.parallel.sharding import distribute_tree
        cfg = get_config(TRAIN_ARCH)
        lm = LM(cfg, device=self.dev)
        stream = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, seed=0,
                                structure=0.8)
        batches = [{"tokens": torch.as_tensor(
            lm_batch(stream, i)["tokens"], dtype=torch.long,
            device=self.dev)} for i in range(MESH_TRAIN_STEPS)]
        runs = {}
        for name, m in (("none", None), ("mesh", mesh)):
            torch.cuda.empty_cache()
            params = lm.init(torch.Generator(device=self.dev).manual_seed(0)
                             ).params
            if m is not None:
                params = distribute_tree(params, lm_param_shardings(cfg, m))
            state = {"params": params, "opt": adamw.init_state(params)}
            step_fn = make_train_step(lm, m, adamw.AdamWConfig(**TRAIN_OPT))
            ev = self._events(2 * MESH_TRAIN_STEPS)
            metrics = []
            for i, batch in enumerate(batches):
                ev[2 * i].record()
                state, met = step_fn(state, batch)
                ev[2 * i + 1].record()
                metrics.append({k: self._local(v) for k, v in met.items()})
            torch.cuda.synchronize()
            ms = [ev[2 * i].elapsed_time(ev[2 * i + 1])
                  for i in range(MESH_TRAIN_STEPS)]
            leaves = {p: self._local(x) for p, x in
                      tree_leaves_with_path(state["params"])}
            runs[name] = (metrics, ms, leaves)
            print(f"(a) {TRAIN_ARCH} {'on the mesh' if m else 'mesh=None'}:"
                  f" ms per step {[round(t, 2) for t in ms]}, loss "
                  f"{[float(x['loss']) for x in metrics]}, grad norm "
                  f"{[float(x['grad_norm']) for x in metrics]}")
            del state, params, step_fn
        (m0, ms0, p0), (m1, ms1, p1) = runs["none"], runs["mesh"]
        same = [all(torch.equal(a[k], b[k]) for k in ("loss", "grad_norm"))
                for a, b in zip(m0, m1)]
        equal = sum(torch.equal(p0[k], p1[k]) for k in p0)
        checksum = {n: float(sum(x.double().sum() for x in r[2].values()))
                    for n, r in runs.items()}
        print(f"    loss and grad norm bit for bit per step: {same}; "
              f"{equal} of {len(p0)} parameter leaves equal bit for bit "
              f"(checksums {checksum['none']!r} / {checksum['mesh']!r})")
        self.check(all(same) and equal == len(p0) == len(p1),
                   "the (1, 1) mesh's train steps differ from mesh=None")
        if equal != len(p0):
            worst = max(float((p0[k].double() - p1[k].double()).abs().max())
                        for k in p0)
            print(f"    largest parameter difference {worst!r}")
        for tag, ms in (("mesh=None", ms0), ("the mesh", ms1)):
            print(f"    {tag}: {ms[0]:.2f} ms first step, "
                  f"{float(np.median(ms[1:])):.2f} ms median of steps 2-"
                  f"{MESH_TRAIN_STEPS}")
        del runs, p0, p1
        torch.cuda.empty_cache()

    def _mesh_decode(self, mesh):
        """(b) olmoe-1b-7b at full width: a MESH_PROMPT prefill and
        MESH_DECODE_STEPS greedy decode steps without a mesh, then on it,
        from the same parameters (placed on the mesh of one, no copy)."""
        torch = self.torch
        from repro_torch.launch.steps import (make_decode_step,
                                              make_prefill_step)
        from repro_torch.models.transformer import lm_param_shardings
        from repro_torch.parallel.sharding import distribute_tree
        lm, params, _ = self._lm_load(MESH_ARCH, "(b)")
        b, s = MESH_PROMPT
        prompt = torch.as_tensor(np.random.default_rng(7).integers(
            0, lm.cfg.vocab_size, (b, s)), device=self.dev)
        runs = {}
        for name, m in (("none", None), ("mesh", mesh)):
            p = (params if m is None else
                 distribute_tree(params, lm_param_shardings(lm.cfg, m)))
            prefill = make_prefill_step(lm, m, s + MESH_DECODE_STEPS)
            decode = make_decode_step(lm, m)
            ev = self._events(2 * (MESH_DECODE_STEPS + 1))
            ev[0].record()
            logits, caches = prefill(p, {"tokens": prompt})
            ev[1].record()
            toks = []
            for i in range(MESH_DECODE_STEPS):
                tok = self._local(logits).argmax(-1)
                toks.append(tok)
                ev[2 * i + 2].record()
                logits, caches = decode(p, caches, tok)
                ev[2 * i + 3].record()
            torch.cuda.synchronize()
            ms = [ev[2 * i].elapsed_time(ev[2 * i + 1])
                  for i in range(MESH_DECODE_STEPS + 1)]
            runs[name] = (torch.cat(toks, 1), self._local(logits), ms)
            print(f"(b) {MESH_ARCH} {'on the mesh' if m else 'mesh=None'}: "
                  f"prefill {b} x {s} {ms[0]:.2f} ms, decode ms per step "
                  f"{[round(t, 2) for t in ms[1:]]}")
            del caches, logits, p
        (t0, l0, ms0), (t1, l1, ms1) = runs["none"], runs["mesh"]
        tok_eq = bool(torch.equal(t0, t1))
        log_eq = bool(torch.equal(l0, l1))
        print(f"    {MESH_DECODE_STEPS} greedy tokens equal: {tok_eq}; last "
              f"logits bit for bit: {log_eq}"
              + ("" if log_eq else f" (largest difference "
                 f"{float((l0.float() - l1.float()).abs().max())!r})"))
        self.check(tok_eq and log_eq, "the (1, 1) mesh's decode differs "
                   "from mesh=None")
        med = {k: float(np.median(v[2][2:])) for k, v in runs.items()}
        print(f"    decode ms per step (median of steps 2-"
              f"{MESH_DECODE_STEPS}): mesh=None {med['none']:.2f}, the mesh "
              f"{med['mesh']:.2f} ({med['mesh'] / med['none']:.2f}x: "
              f"DTensor's host overhead)")
        del params, runs
        torch.cuda.empty_cache()

    # -- examples ------------------------------------------------------------
    @staticmethod
    def _example_runs() -> list:
        """(script stem, argv) of every ``Run:`` line of the docstrings of
        ``examples/*_torch.py``, in file order."""
        import ast
        import shlex
        runs = []
        for path in sorted((ROOT / "examples").glob("*_torch.py")):
            doc = ast.get_docstring(ast.parse(path.read_text())) or ""
            block = doc.split("Run:", 1)[1] if "Run:" in doc else ""
            for line in block.splitlines():
                words = shlex.split(line)
                if not words:
                    break
                at = next(i for i, w in enumerate(words)
                          if w.endswith("_torch.py"))
                stem = pathlib.Path(words[at]).stem.removesuffix("_torch")
                runs.append((stem, words[at + 1:]))
        return runs

    def examples(self):
        """Every ``Run:`` line of the example twins on the card (module
        docstring, 15.).  Counts every kernel's launches over the phase."""
        from repro_torch import obs
        from repro_torch.launch.mesh import one_rank_group
        counters = self._kernel_counters()
        self._zero(counters)
        runs = self._example_runs()
        scripts = sorted({stem for stem, _ in runs})
        twins = sorted(p.stem.removesuffix("_torch") for p in
                       (ROOT / "examples").glob("*_torch.py"))
        self.check(scripts == twins and len(twins) == 10,
                   f"examples: Run: lines name {scripts}, twins {twins}")
        out = ROOT / "build" / "examples"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        print(f"examples on {self.card}: {len(runs)} runs of "
              f"{len(scripts)} scripts, logs in build/examples")
        cwd, state = os.getcwd(), obs.active()
        t0 = time.perf_counter()
        os.chdir(out)
        results = {}
        try:
            with one_rank_group(self.dev):     # the LM twins' (1, 1) mesh
                for i, (stem, argv) in enumerate(runs):
                    results.setdefault(stem, self._example(i, stem, argv))
        finally:
            os.chdir(cwd)
            obs._ACTIVE = state        # serve_observed_torch disables obs
        made = self._made(counters)
        fused = made["rollout_readout"]
        self.examples_launches = made
        print(f"examples: {len(runs)} runs in "
              f"{time.perf_counter() - t0:.1f} s; launches of B1-B5 and "
              f"the readout (fused {fused}): {made}")
        self.check(made["specialized_rollout"] > 0 and fused > 0,
                   f"examples: B2 {made['specialized_rollout']} launches, "
                   f"{fused} fused readouts (want both > 0)")
        idle = {k: made[k] for k in ("reservoir_rollout", "bitplane_gemv",
                                     "bcsr_matmul", "reservoir_step")}
        self.check(not any(idle.values()),
                   f"examples launched a kernel off their path: {idle}")
        t0 = time.perf_counter()
        if results.get("quickstart"):
            res = results["quickstart"]
            u = res["u"][None]
            plain = self._example_hold(
                "quickstart", res["params"], u, res["states"][None],
                res["preds"][None])
            self._example_quickstart_ms(res["params"], u, plain)
        for mode, res in (results.get("channel_equalization") or {}).items():
            self._example_hold(f"channel_equalization {mode}",
                               res["params"], res["u"][None],
                               res["states"][None])
        if results.get("timeseries_classification"):
            res = results["timeseries_classification"]
            self._example_hold("timeseries_classification", res["params"],
                               res["u"], res["states"])
        print(f"examples: B2's launches held against its twin in "
              f"{time.perf_counter() - t0:.1f} s")

    def _example_hold(self, tag, params, u, states, preds=None):
        """An example's B2 launch from a zero state over ``u`` (B, T, I)
        against B2's plain twin on the same card tensors: its ``states``
        (B, T, R) and, where given, its fused readout's ``preds`` (B, T,
        O).  Returns the twin's predictions (None without ``preds``)."""
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout, specialized_rollout_plain)
        from repro_torch.serve.engine import engine_for
        eng = engine_for(params)       # the engine the example ran on
        op = getattr(eng, "_fused", None)
        self.check(isinstance(op, SpecializedRollout),
                   f"{tag}: served by {type(op).__name__} on the "
                   f"{eng.backend} backend, not by B2")
        if not isinstance(op, SpecializedRollout):
            return None
        kmode = "int8" if op.tables.int8 else "fp32"
        u = u.to(torch.float32)
        x0 = torch.zeros((u.shape[0], params.config.reservoir_dim),
                         device=self.dev)
        out = specialized_rollout_plain(
            u.transpose(0, 1).contiguous(), op.tables, op.w_in, x0,
            op.w_out if preds is not None else None, leak=op.leak,
            smax=op.smax, recur_scale=op.recur_scale, readout_every=1,
            want_states=True, want_preds=preds is not None)
        ps, pp = out if preds is not None else (out, None)
        ps = ps.transpose(0, 1)
        ds = maxdiff(states, ps)
        tol = 0.0 if kmode == "int8" else FP32_TOL
        self.note_err("specialized_rollout", kmode, ds)
        self.check(ds <= tol, f"{tag}: B2 states vs twin {ds:.3g} "
                   f"(tolerance {tol:g})")
        line = (f"  {tag}: B2 over {u.shape[1]} steps at batch "
                f"{u.shape[0]} ({kmode}) vs twin: states {ds:.3g}")
        if pp is not None:
            pp = pp.transpose(0, 1)
            scale = float((ps.abs() @ op.w_out.abs()).max())
            dp = maxdiff(preds, pp)
            self.note_err("rollout_readout", kmode, dp)
            self.check(dp <= READOUT_TOL, f"{tag}: fused readout vs twin "
                       f"{dp:.3g} (tolerance {READOUT_TOL:g})")
            line += (f", fused readout {dp:.3g} (tolerance {READOUT_TOL:g};"
                     f" largest sum |x_i w_i| {scale:.4g})")
        print(line)
        return pp

    def _example_quickstart_ms(self, params, u, want):
        """quickstart's served predictions again, out of the phase's
        counts: one B2 launch of 2,999 steps at batch 1 with the readout
        fused, by CUDA events (median of 5), each launch held against the
        twin's predictions ``want`` within READOUT_TOL."""
        torch = self.torch
        from repro_torch.core.esn import run_readout
        if want is None:
            return
        ev, ms, worst = self._events(2), [], 0.0
        for _ in range(5):
            ev[0].record()
            got = run_readout(params, u[0])
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            worst = max(worst, maxdiff(got, want[0]))
        self.check(worst <= READOUT_TOL, f"quickstart's timed launches vs "
                   f"twin {worst:.3g} (tolerance {READOUT_TOL:g})")
        print(f"  quickstart: one B2 launch of {u.shape[1]} steps at batch "
              f"1 (dim 800 int8-CSD, readout fused): "
              f"{float(np.median(ms)):.3f} ms (median of 5; "
              f"{[round(t, 3) for t in ms]}), "
              f"{float(np.median(ms)) * 1e3 / u.shape[1]:.3f} us per step; "
              f"each launch vs twin within {worst:.3g}")

    def _example(self, i, stem, argv):
        """One ``Run:`` line through the twin's ``main(argv)`` in this
        process: returns what ``main`` returned (None if the run failed)."""
        torch = self.torch
        import importlib.util
        import io
        path = ROOT / "examples" / f"{stem}_torch.py"
        out = pathlib.Path.cwd()
        t0 = time.perf_counter()
        spec = importlib.util.spec_from_file_location(
            f"_example_{stem}_torch", path)
        mod = importlib.util.module_from_spec(spec)
        buf, err, failed, res = io.StringIO(), "", None, None
        try:
            with contextlib.redirect_stdout(buf):
                spec.loader.exec_module(mod)
                res = mod.main(argv)
            torch.cuda.synchronize()
        except (Exception, SystemExit):
            err = traceback.format_exc()
            failed = "raised"
        text = buf.getvalue()
        torch.cuda.empty_cache()
        secs = time.perf_counter() - t0
        (out / f"{i:02d}_{stem}.log").write_text(text + err)
        last = (text.rstrip().splitlines() or [""])[-1]
        ok = not failed and last.startswith("OK")
        self.check(ok, f"example {stem}_torch.py {' '.join(argv)}: "
                   f"{failed or 'last line ' + repr(last)}")
        print(f"  [{i}] {stem}_torch.py {' '.join(argv)}: {secs:.1f} s, "
              f"{'OK' if ok else 'FAILED'}")
        for line in text.splitlines():
            if any(w in line for w in EXAMPLE_NUMBERS):
                print(f"      {line.strip()}")
        if not ok:
            print(err[-3000:])
            return None
        if stem == "train_lm":
            self._example_tokens(res["step_s"], argv)
        return res

    @staticmethod
    def _example_tokens(step_s, argv):
        """ms per step and tokens per second of a ``train_lm_torch`` run:
        the median of its steps' seconds after the first (host clock,
        each step ending in the read of its loss)."""
        shape = {"--batch": 8, "--seq": 128}
        for k in shape:
            if k in argv:
                shape[k] = int(argv[argv.index(k) + 1])
        secs = step_s[1:]
        if secs:
            med = float(np.median(secs))
            print(f"      {shape['--batch']} x {shape['--seq']} tokens a "
                  f"step: {med * 1e3:.2f} ms per step (median of "
                  f"{len(secs)} steps after the first; "
                  f"{min(secs) * 1e3:.2f}-{max(secs) * 1e3:.2f}), "
                  f"{shape['--batch'] * shape['--seq'] / med:.0f} tokens/s")

    # -- dryrun ------------------------------------------------------------
    def dryrun(self):
        """The dry run held against the card: (a) the train phase's step,
        (b) int8 serving on the (1, 1) mesh, (c) seven production cells
        through the CLI (started first: they run on the host's cores while
        (a) and (b) use the card).  Counts every kernel's launches over
        the phase (must be 0)."""
        counters = self._kernel_counters()
        self._zero(counters)
        print(f"dryrun on {self.card}")
        cells = self._dryrun_start_cells()
        try:
            self._dryrun_train()
            self._dryrun_int8()
        finally:
            self._dryrun_cells(cells)
        made = self._made(counters)
        self.dryrun_launches = made
        print(f"launches of B1-B5 and the readout: {made}")
        self.check(not any(made.values()), "the dryrun phase launched a "
                   "reservoir kernel")

    def _dryrun_start_cells(self):
        """(c) Start every cell of DRYRUN_CELLS, each in a process of its
        own; returns {cell: (process, log, start)}."""
        out = ROOT / "build" / "dryrun_cells"
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        for cell in DRYRUN_CELLS:
            arch, shape, multi_pod = cell
            mesh = "2x16x16" if multi_pod else "16x16"
            log = open(out / f"{arch}__{shape}__{mesh}.log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--cell", arch, shape, "--force", "--no-hlo"]
            if multi_pod:
                cmd.append("--multi-pod")
            env = dict(os.environ,
                       PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
            procs[cell] = (subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=str(ROOT)), log, time.perf_counter())
        return procs

    def _dryrun_train(self):
        """(a) lower_cell at TRAIN_ARCH's full width on a fake world of one
        rank, then one real step on the card under FlopCounterMode."""
        torch = self.torch
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.data.pipeline import LMStreamConfig, lm_batch
        from repro_torch.launch.mesh import fake_world, make_mesh
        from repro_torch.launch.steps import lower_cell, make_train_step
        from repro_torch.models.transformer import LM
        from repro_torch.optim import adamw
        cfg = get_config(TRAIN_ARCH)
        shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        t0 = time.perf_counter()
        with fake_world(1):
            lowered, meta = lower_cell(cfg, shape, make_mesh(
                (1, 1), ("data", "model")))
            compiled = lowered.compile()
        dry_s = time.perf_counter() - t0
        walk, mem = compiled.walk(), compiled.memory_analysis()
        print(f"(a) {TRAIN_ARCH} {meta['step']} at {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, {cfg.microbatches} microbatches, dry run on a "
              f"fake world of 1 rank: {dry_s:.1f} s on the host; dot FLOPs "
              f"{walk['dot_flops']!r}, memory {mem}")
        lm = LM(cfg, device=self.dev)
        torch.cuda.empty_cache()
        params = lm.init(torch.Generator(device=self.dev).manual_seed(0)
                         ).params
        state = {"params": params, "opt": adamw.init_state(params)}
        stream = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, seed=0,
                                structure=0.8)
        batch = {"tokens": torch.as_tensor(lm_batch(stream, 0)["tokens"],
                                           dtype=torch.long,
                                           device=self.dev)}
        step_fn = make_train_step(lm, None, adamw.AdamWConfig(**TRAIN_OPT))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        real_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counted = fc.get_total_flops()
        ratio = mem["peak_bytes"] / peak
        print(f"    one real step on the card: {real_s:.2f} s (under "
              f"FlopCounterMode), loss {float(metrics['loss'])!r}; "
              f"FlopCounterMode {counted!r} FLOPs, dry run dot FLOPs "
              f"{walk['dot_flops']!r} (equal: "
              f"{walk['dot_flops'] == counted})")
        print(f"    peak bytes: dry run {mem['peak_bytes']:,} "
              f"({mem['peak_bytes'] / 1e9:.2f} GB), max_memory_allocated "
              f"{peak:,} ({peak / 1e9:.2f} GB), ratio {ratio!r} on "
              f"{self.card}")
        self.check(walk["dot_flops"] == counted > 0, "the dry run's dot "
                   f"FLOPs {walk['dot_flops']} != FlopCounterMode's "
                   f"{counted}")
        lo, hi = DRYRUN_PEAK_RATIO
        self.check(lo <= ratio <= hi, f"dry-run peak / max_memory_allocated "
                   f"{ratio} outside {DRYRUN_PEAK_RATIO}")
        self.check(bool(torch.isfinite(metrics["loss"])), "the real step's "
                   "loss is not finite")
        del state, params, metrics, step_fn, batch
        torch.cuda.empty_cache()

    def _dryrun_int8(self):
        """(b) LM_ARCH's int8 tree (``quantize_tree`` of the seeded bf16
        parameters) prefilled and decoded without a mesh, then on the
        (1, 1) NCCL mesh, placed as ``lower_cell`` places int8 leaves."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_host_mesh, one_rank_group
        from repro_torch.launch.steps import (make_decode_step,
                                              make_prefill_step)
        from repro_torch.models.quantize import (is_quantized_leaf,
                                                 quantize_tree)
        from repro_torch.models.transformer import LM, lm_param_shardings
        from repro_torch.parallel.sharding import distribute_tree
        cfg = get_config(LM_ARCH)
        lm = LM(cfg, device=self.dev)
        n = lm.param_count()
        self.check(n == LM_PARAMS, f"{LM_ARCH} param_count {n:,} != the "
                   f"reference's {LM_PARAMS:,}")
        torch.cuda.empty_cache()
        params = lm.init(torch.Generator(device=self.dev).manual_seed(0)
                         ).params
        q = quantize_tree(params)
        del params
        torch.cuda.empty_cache()
        stack = [q]
        n_q = 0
        while stack:
            t = stack.pop()
            if is_quantized_leaf(t):
                n_q += 1
            elif isinstance(t, dict):
                stack.extend(t.values())
        b, s = DRYRUN_PROMPT
        prompt = torch.as_tensor(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (b, s)), device=self.dev)
        runs = {}
        with one_rank_group(self.dev):
            mesh = make_host_mesh()
            for name, m in (("none", None), ("mesh", mesh)):
                p = (q if m is None else
                     distribute_tree(q, lm_param_shardings(
                         cfg, m, fsdp=cfg.fsdp and cfg.serving_fsdp)))
                prefill = make_prefill_step(lm, m, s + DRYRUN_DECODE_STEPS)
                decode = make_decode_step(lm, m)
                ev = self._events(2 * (DRYRUN_DECODE_STEPS + 1))
                ev[0].record()
                logits, caches = prefill(p, {"tokens": prompt})
                ev[1].record()
                toks = []
                for i in range(DRYRUN_DECODE_STEPS):
                    tok = self._local(logits).argmax(-1)
                    toks.append(tok)
                    ev[2 * i + 2].record()
                    logits, caches = decode(p, caches, tok)
                    ev[2 * i + 3].record()
                torch.cuda.synchronize()
                ms = [ev[2 * i].elapsed_time(ev[2 * i + 1])
                      for i in range(DRYRUN_DECODE_STEPS + 1)]
                runs[name] = (torch.cat(toks, 1), self._local(logits), ms)
                print(f"(b) {LM_ARCH} int8 ({n_q} int8 leaves) "
                      f"{'on the (1, 1) mesh' if m else 'mesh=None'}: "
                      f"prefill {b} x {s} {ms[0]:.2f} ms, decode ms per "
                      f"step {[round(x, 2) for x in ms[1:]]}")
                del caches, logits, p
        (t0, l0, ms0), (t1, l1, ms1) = runs["none"], runs["mesh"]
        tok_eq, log_eq = bool(torch.equal(t0, t1)), bool(torch.equal(l0, l1))
        med = {k: float(np.median(v[2][2:])) for k, v in runs.items()}
        print(f"    {DRYRUN_DECODE_STEPS} greedy tokens equal: {tok_eq}; "
              f"last logits bit for bit: {log_eq}; decode ms per step "
              f"(median of steps 2-{DRYRUN_DECODE_STEPS}): mesh=None "
              f"{med['none']:.2f}, the mesh {med['mesh']:.2f} on "
              f"{self.card}")
        self.check(n_q > 0 and tok_eq and log_eq, "int8 on the (1, 1) mesh "
                   "differs from mesh=None")
        del q, runs, l0, l1
        torch.cuda.empty_cache()

    def _dryrun_cells(self, procs):
        """(c) Wait for the CLI's cells and hold each record."""
        t0 = min(start for _, _, start in procs.values())
        for cell, (proc, log, start) in procs.items():
            try:
                rc = proc.wait(timeout=max(
                    DRYRUN_CELL_TIMEOUT - (time.perf_counter() - start), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            log.close()
            self._dryrun_cell(cell, rc, log, time.perf_counter() - start)
        print(f"(c) the {len(DRYRUN_CELLS)} cells took "
              f"{time.perf_counter() - t0:.1f} s on the host, all at once, "
              f"torch {self.torch.__version__}")

    def _dryrun_cell(self, cell, rc, log, secs):
        """One cell's record held: status, param_count, argument bytes
        against the rules on its own mesh, dot FLOPs against DRYRUN_FLOPS."""
        import math
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch import roofline as rf
        from repro_torch.launch import specs
        from repro_torch.launch.dryrun import cell_path
        from repro_torch.launch.report import HBM_GB
        from repro_torch.launch.mesh import AbstractMesh
        from repro_torch.models.common import tree_leaves
        from repro_torch.models.transformer import LM
        arch, shape, multi_pod = cell
        mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model"))
                if multi_pod else AbstractMesh((16, 16), ("data", "model")))
        where = "2 x 16 x 16" if multi_pod else "16 x 16"

        def shard_bytes(tree):
            total = 0
            for sds in tree_leaves(tree):
                local = list(sds.shape)
                for d, entry in enumerate(sds.sharding.spec):
                    for a in ((entry,) if isinstance(entry, str)
                              else entry or ()):
                        local[d] //= mesh.shape[a]
                total += math.prod(local) * sds.dtype.itemsize
            return total

        p = cell_path(arch, shape, multi_pod)
        rec = json.loads(p.read_text()) if p.exists() else {}
        ok = rc == 0 and rec.get("status") == "ok"
        self.check(ok, f"dry-run cell {arch} {shape} on {where}: exit {rc}, "
                   f"status {rec.get('status')} {rec.get('error', '')}")
        if not ok:
            print(f"(c) {arch} {shape} on {where}: FAILED within "
                  f"{secs:.1f} s, log tail:\n"
                  + pathlib.Path(log.name).read_text()[-3000:])
            return
        cfg = get_config(arch)
        lm = LM(cfg, device="meta")
        n = lm.param_count()
        sh = SHAPES[shape]
        fsdp = cfg.fsdp and (cfg.serving_fsdp if sh.kind != "train"
                             else True)
        structs, _ = specs.params_specs(lm, mesh, fsdp=fsdp)
        if sh.kind == "train":
            expect = (shard_bytes(structs) + shard_bytes(
                specs.opt_state_specs(structs, mesh, cfg.opt_dtype))
                + shard_bytes(specs.batch_specs(cfg, sh, mesh)))
        elif sh.kind == "prefill":
            expect = (shard_bytes(structs)
                      + shard_bytes(specs.batch_specs(cfg, sh, mesh)))
        else:
            expect = (shard_bytes(structs)
                      + shard_bytes(specs.cache_specs(lm, sh, mesh))
                      + shard_bytes({"t": specs.token_spec(sh, mesh)}))
        mem, walk = rec["memory_per_device"], rec["hlo_walk"]
        rep = rf.cell_report(rec)
        peak_gb = mem["peak_bytes"] / 1e9
        want = DRYRUN_FLOPS[cell]
        dot = walk["dot_flops"]
        gap = abs(dot - want) / want
        print(f"(c) {arch} {shape} on {where} ({rec['step']}): lower "
              f"{rec['t_lower_s']} s, run {rec['t_compile_s']} s (ended "
              f"within {secs:.1f} s of its start); param_count "
              f"{rec['param_count']:,} (meta LM {n:,}); argument bytes "
              f"{mem['argument_bytes']:,} (rules {expect:,}); peak "
              f"{peak_gb:.2f} GB per device, fits {HBM_GB} GB: "
              f"{peak_gb <= HBM_GB}; dot FLOPs per device {dot!r} under "
              f"torch {self.torch.__version__}, {want!r} under torch "
              f"{DRYRUN_FLOPS_TORCH} (gap {gap:.3e}, limit "
              f"{DRYRUN_FLOP_RTOL}); useful ratio 6ND / (dot x "
              f"{rec['n_devices']}) {rep['useful_ratio']!r}; collective "
              f"bytes per rank {walk['collective_bytes']} (total "
              f"{walk['total_collective_bytes']!r}; tools/mesh_bytes.py's "
              f"explicit redistributes "
              f"{'n/a' if multi_pod else MESH_BYTES.get((arch, shape), 'n/a')}"
              f"); dominant {rep['dominant']}")
        self.check(rec["param_count"] == n, f"{arch} dry-run "
                   f"param_count {rec['param_count']} != {n}")
        self.check(mem["argument_bytes"] == expect, f"{arch} {shape} on "
                   f"{where}: argument bytes {mem['argument_bytes']} != the "
                   f"rules' {expect}")
        self.check(gap <= DRYRUN_FLOP_RTOL, f"{arch} {shape} on {where}: "
                   f"dot FLOPs per device {dot} under torch "
                   f"{self.torch.__version__}, {want} under torch "
                   f"{DRYRUN_FLOPS_TORCH}")

    def _train_breakdown(self, lm, state, batch):
        """Where a step's time goes (CUDA events, ms, each after a warm-up
        call): one microbatch's forward alone and with its backward, the
        AdamW update over the whole tree, and one layer's attention
        (forward + backward at the microbatch's shape) on the port's eager
        float32 path beside ``F.scaled_dot_product_attention`` in bf16, the
        library call that computes it."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.launch.steps import _split
        from repro_torch.models import attention as attn_lib
        from repro_torch.models.common import tree_leaves, tree_map
        from repro_torch.optim import adamw
        cfg = lm.cfg
        mb = _split(batch, max(cfg.microbatches, 1))[0]
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        leaves = tree_leaves(params)

        def fwd():
            with torch.no_grad():
                lm.loss(state["params"], mb)

        grads = []

        def fwd_bwd():
            grads[:] = torch.autograd.grad(lm.loss(params, mb), leaves)

        t_fwd, t_fb = self.timed(fwd, 2), self.timed(fwd_bwd, 2)
        it = iter(grads)
        tree = tree_map(lambda _: next(it), state["params"])
        opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
        t_opt = self.timed(lambda: adamw.apply_updates(
            state["params"], tree, state["opt"], opt_cfg), 2)
        del grads, tree
        b, s = mb["tokens"].shape[0], mb["tokens"].shape[1] - 1
        h, hd = cfg.n_heads, cfg.head_dim
        gen = torch.Generator(device=self.dev).manual_seed(1)
        q, k, v = (torch.randn((b, s, h, hd), generator=gen,
                               device=self.dev, dtype=torch.bfloat16
                               ).requires_grad_() for _ in range(3))

        def eager():
            o = attn_lib.attention(q, k, v, causal=True)
            torch.autograd.grad(o.float().sum(), (q, k, v))

        def sdpa():
            o = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True)
            torch.autograd.grad(o.float().sum(), (q, k, v))

        t_attn, t_sdpa = self.timed(eager, 3), self.timed(sdpa, 3)
        n_mb = max(cfg.microbatches, 1)
        print(f"    breakdown (ms, CUDA events): one microbatch of {b} x {s}"
              f" forward {t_fwd:.2f}, forward + backward (remat "
              f"{cfg.remat}) {t_fb:.2f}, x {n_mb} = {t_fb * n_mb:.2f}; "
              f"AdamW update {t_opt:.2f}; one layer's attention forward + "
              f"backward {t_attn:.2f} (x {cfg.n_layers} layers = "
              f"{t_attn * cfg.n_layers:.2f}) against "
              f"scaled_dot_product_attention's {t_sdpa:.2f} in bf16")

    @staticmethod
    def _train_row(rows, ms, i):
        print(f"    step {i:3d} loss {float(rows['loss'][i])!r} lr "
              f"{float(rows['lr'][i])!r} grad_norm "
              f"{float(rows['grad_norm'][i])!r} ({ms[i]:.2f} ms)")

    def _train_checkpoint(self, lm, state, step_fn, batch):
        """Save the live state through a ``Checkpointer`` (into the
        git-ignored ``build/``), find it with ``latest_step``, restore it
        into fresh tensors on the card (equal bit for bit, bf16 leaves
        included), then take the next step from the restored state: its
        loss equals the live state's on the same microbatches."""
        torch = self.torch
        import shutil
        from repro_torch.checkpoint import store
        from repro_torch.launch.steps import _split
        from repro_torch.models.common import tree_leaves_with_path, tree_map
        root = ROOT / "build" / "train_ckpt"
        shutil.rmtree(root, ignore_errors=True)
        free = shutil.disk_usage(ROOT).free / 1e9
        try:
            t0 = time.perf_counter()
            ck = store.Checkpointer(root, every=TRAIN_STEPS, keep=1)
            ck.maybe_save(state, TRAIN_STEPS)
            t_copy = time.perf_counter() - t0
            ck.finalize()
            t_save = time.perf_counter() - t0
            found = store.latest_step(root)
            t_found = time.perf_counter() - t0
            fresh = tree_map(torch.empty_like, state["params"])
            like = {"params": fresh, "opt": {
                "m": tree_map(torch.empty_like, state["opt"]["m"]),
                "v": tree_map(torch.empty_like, state["opt"]["v"]),
                "step": torch.empty_like(state["opt"]["step"])}}
            restored = store.restore(like, root, TRAIN_STEPS)
            del like, fresh                 # only their shapes were read
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in root.rglob("*.npy")) / 1e9
        finally:
            shutil.rmtree(root, ignore_errors=True)
        live = tree_leaves_with_path(state)
        back = tree_leaves_with_path(restored)
        same = [p == q and a.dtype == b.dtype and a.device == b.device
                and torch.equal(a.view(torch.int16) if a.dtype ==
                                torch.bfloat16 else a,
                                b.view(torch.int16) if b.dtype ==
                                torch.bfloat16 else b)
                for (p, a), (q, b) in zip(live, back)]
        n_bf16 = sum(a.dtype == torch.bfloat16 for _, a in back)
        print(f"    checkpoint: {size:.2f} GB in {len(back)} leaves "
              f"({n_bf16} bf16) on a disk with {free:.1f} GB free; host "
              f"copy {t_copy:.2f} s, written {t_save:.2f} s, latest_step "
              f"{found} after {t_found:.2f} s, restored onto the card "
              f"after {t_all:.2f} s; {sum(same)}/{len(same)} leaves equal "
              "bit for bit")
        self.check(found == TRAIN_STEPS, f"latest_step {found}")
        self.check(len(same) == len(live) and all(same),
                   "restored checkpoint differs from the live state")
        # the next step's loss from the live state: the mean over the
        # same microbatches the step splits the batch into
        with torch.no_grad():
            k = max(lm.cfg.microbatches, 1)
            want = sum(lm.loss(state["params"], mb)
                       for mb in _split(batch, k)) / k
        del state, live
        torch.cuda.empty_cache()
        restored, m = step_fn(restored, batch)
        got, want = float(m["loss"].item()), float(want.item())
        print(f"    next step from the restored state: loss {got!r}, the "
              f"live state's {want!r} (rtol {TRAIN_RESUME_RTOL}); grad "
              f"norm {float(m['grad_norm'].item())!r}, step "
              f"{int(restored['opt']['step'].item())}")
        self.check(abs(got - want) <= TRAIN_RESUME_RTOL * abs(want),
                   f"resumed loss {got} != live {want}")

    def serve_layer(self):
        """The rest of the serve layer at LARGE_1024 on the card: the torch
        backend against the kernels, an admission policy, a fault plan and
        a registry live swap (B2 and B1 models in one pool).  The phase's
        B1/B2 launch counts cover the servers of (b)-(d) only: the
        backend comparison (a) and the one-shot answers that served ones
        are checked against are left out."""
        self.serve_launches = dict.fromkeys(
            [*self._counted, "rollout_readout"], 0)
        self._torch_backend()
        self._admission()
        self._fault_plan()
        self._registry()
        self._torch_device_times()
        print("serve_layer launches (rollout_readout: fused readouts):",
              self.serve_launches)
        for k, n in self.serve_launches.items():
            self.check(n > 0, f"{k} launched in serve_layer")

    def _zero(self, counters: dict) -> None:
        """Zero ``counters``' launches and the rollout launches that fused
        a readout."""
        for fn in counters.values():
            fn.launches = 0
        for fn in self._counted.values():
            fn.fused_launches = 0

    def _made(self, counters: dict) -> dict:
        """Launches per entry point of ``counters`` since :meth:`_zero`,
        and under ``rollout_readout`` the rollout launches that fused a
        readout."""
        made = {k: fn.launches for k, fn in counters.items()}
        made["rollout_readout"] = sum(fn.fused_launches
                                      for fn in self._counted.values())
        return made

    def _drive(self, call, into=None):
        """Run ``call`` and add the B1/B2 launches it made to the phase's
        counts ``into`` (none: left out of every count); returns (its
        result, those launches)."""
        self._zero(self._counted)
        out = call()
        self.torch.cuda.synchronize()
        made = self._made(self._counted)
        if into is not None:
            for k, n in made.items():
                into[k] += n
        return out, made

    def _backend_pair(self, params, tag, seed, **kw):
        """(a) The torch backend against the cuda backend on one reservoir
        at batch 16, T = 64: states within SERVE_TOL, int8 products ==
        matvec_int_exact exactly, chunked (2 x 32) == one-shot bit for bit
        on the torch backend, and each backend's time per 32-step chunk."""
        torch = self.torch
        from repro_torch.serve import ReservoirEngine
        t = ReservoirEngine(params, backend="torch", **kw)
        c = ReservoirEngine(params, backend="cuda", **kw)
        cfg = params.config
        gen = torch.Generator(device="cpu").manual_seed(seed)
        u = torch.randn((16, 64, cfg.input_dim), generator=gen).to(self.dev)
        x0 = (0.5 * torch.randn((16, cfg.reservoir_dim),
                                generator=gen)).to(self.dev)
        ts, tf = t.run_segment(u, x0, want_states=True)
        cs, cf = c.run_segment(u, x0, want_states=True)
        d = max(maxdiff(ts, cs), maxdiff(tf, cf))
        self.check(d <= SERVE_TOL, f"{tag} torch vs cuda states {d:.3g}")
        a, carry = t.run_segment(u[:, :32], x0, want_states=True)
        b, last = t.run_segment(u[:, 32:], carry, want_states=True)
        chunked = (torch.equal(torch.cat([a, b], dim=1), ts)
                   and torch.equal(last, tf))
        self.check(chunked, f"{tag} torch backend chunked != one-shot")
        line = (f"  {tag} [{t.torch_schedule}, block density "
                f"{t.plan.block_density:.3f}]: torch vs cuda states "
                f"{d:.3g}, chunked 2x32 == one-shot {chunked}")
        if cfg.mode.startswith("int8"):
            smax = (1 << (cfg.state_bits - 1)) - 1
            xq = torch.clamp(torch.round(ts[:, ::8].reshape(
                -1, cfg.reservoir_dim) * smax), -smax - 1,
                smax).to(torch.int32)
            exact = torch.equal(t._int_product(xq),
                                params.w.matvec_int_exact(xq))
            self.check(exact, f"{tag} torch int32 products != "
                       "matvec_int_exact")
            line += f", int32 products == matvec_int_exact {exact}"
        print(line)
        u32 = u[:, :32]
        calls = {name: (lambda eng=eng: eng.run_segment(
            u32, x0, want_states=not eng.has_readout, defer_sync=True))
            for name, eng in (("cuda", c), ("torch", t))}
        times = {}
        for name, call in calls.items():
            _, made = self._drive(call)
            ms = self.timed(call, 20)
            # the kernel's device time now; the torch backend's (thousands
            # of small launches per profile) last in the phase
            dev_us = (self._device_us(call, "", n=2) if name == "cuda"
                      else None)
            times[name] = {"ms_per_chunk": ms, "device_us_per_chunk": dev_us}
            print(f"    {name} backend: {ms * 1e3:.1f} us per 32-step chunk "
                  f"(CUDA events), launches per chunk {made} on {self.card}"
                  + ("" if name == "torch" else
                     f"; {dev_us:.3f} us device time (profiler)"))
        return times, calls["torch"]

    def _culled_1024(self):
        """A block-sparse dim-1024 matrix (blocks kept only on the three
        central block diagonals, 22/64) with LARGE_1024's input and
        readout weights: the culled int8 schedule.  Made once."""
        if getattr(self, "params_culled", None) is None:
            from repro_torch.configs.esn_paper import LARGE_1024
            from repro_torch.core.esn import ESNParams
            from repro_torch.core.sparse import (FixedMatrix,
                                                 random_sparse_matrix)
            rng = np.random.default_rng(0)
            w = random_sparse_matrix(1024, 1024, 0.95, rng) * 0.05
            blk = np.arange(1024) // 128
            w[np.abs(blk[:, None] - blk[None, :]) > 1] = 0.0
            fm = FixedMatrix.compile(w, weight_bits=8, mode="csd", block=128,
                                     rng=rng)
            p = self.params_1024
            self.params_culled = ESNParams(w=fm, w_in=p.w_in, w_out=p.w_out,
                                           config=LARGE_1024)
        return self.params_culled

    def _torch_backend(self):
        self.backend_times, self._torch_calls = {}, {}
        for tag, params, seed in (
                ("LARGE_1024 int8", self.params_1024, 41),
                ("PAPER_BASELINE fp32", self.params_800, 43),
                ("banded 1024 int8 (culled)", self._culled_1024(), 47)):
            self.backend_times[tag], self._torch_calls[tag] = \
                self._backend_pair(params, tag, seed)

    def _torch_device_times(self):
        """The torch backend's device time per 32-step chunk (profiler),
        the phase's last measurement: one chunk is hundreds of launches
        (thousands for the culled schedule, which is not profiled), and
        such profiles have been followed by empty ones on an H100."""
        for tag, call in self._torch_calls.items():
            if "culled" in tag:
                continue
            dev_us = self._device_us(call, "", n=2, required=False)
            self.backend_times[tag]["torch"]["device_us_per_chunk"] = dev_us
            print(f"  {tag} torch backend: "
                  + ("not measured" if dev_us is None else f"{dev_us:.3f} us")
                  + " device time per 32-step chunk "
                  f"(profiler) on {self.card}")

    def _burst(self, n, seed, lo=64, hi=161):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal((int(t), 1)).astype(np.float32)
                for t in rng.integers(lo, hi, size=n)]

    def _pool_exact(self, eng, inputs, out, n_slots=16):
        """A served answer == the engine's one-shot answer at the pool's
        batch shape (the request broadcast over every slot)."""
        batch = self.torch.as_tensor(np.broadcast_to(
            inputs[None], (n_slots,) + inputs.shape).copy(), device=self.dev)
        return np.array_equal(out, eng.predictions(batch)[0].cpu().numpy())

    def _admission(self):
        """(b) A bounded queue and deadline shedding in front of the B2
        server, a burst that overflows both."""
        from repro_torch.serve import (AsyncReservoirServer,
                                       BoundedQueuePolicy, CompositePolicy,
                                       DeadlineShedPolicy, ReservoirEngine,
                                       ServeStats, SubmitSpec)
        eng = ReservoirEngine(self.params_1024)
        srv = AsyncReservoirServer(
            eng, n_slots=16, chunk_steps=32, chunk_time=1e-3,
            stats=ServeStats(), admission=CompositePolicy(
                BoundedQueuePolicy(max_depth=24), DeadlineShedPolicy()))
        inputs = self._burst(40, 53)
        for i, x in enumerate(inputs):
            # every fifth request asks for a 2 ms answer
            srv.submit(SubmitSpec(x, uid=i, deadline=2e-3 if i % 5 == 4
                                  else None), arrival_time=0.0)
        res, made = self._drive(srv.run, self.serve_launches)
        st = srv.stats
        ok = [i for i, r in res.items() if r.status == "ok"]
        exact = all(self._pool_exact(eng, inputs[i], res[i].preds)
                    for i in ok)
        reasons = sorted({r.timings["reason"] for r in res.values()
                          if r.rejected})
        self.check(st.rejected > 0 and st.shed > 0,
                   f"admission rejected {st.rejected}, shed {st.shed}")
        self.check(len(res) == len(inputs) and st.completed == len(ok)
                   and st.enqueued == len(ok), "admission accounting")
        self.check(exact, "admitted answers != one-shot at the pool shape")
        print(f"  admission: {len(inputs)} submitted, {len(ok)} served, "
              f"{st.rejected} rejected, {st.shed} shed ({reasons}); "
              f"served == one-shot at the pool shape {exact}; "
              f"{srv.stats.chunks} chunks, launches {made}")

    def _fault_plan(self):
        """(c) Transient engine-call failures and a straggler window on
        the server's clock: the same answers as the fault-free run, bit
        for bit, the retries recorded and the clock charged."""
        from repro_torch.runtime.faults import FaultEvent, FaultPlan
        from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                                       ServeStats, SubmitSpec)
        eng = ReservoirEngine(self.params_1024)
        inputs = self._burst(24, 59)
        runs = {}
        for name in ("clean", "faults"):
            plan = None if name == "clean" else FaultPlan([
                FaultEvent("transient", at=2e-3, count=2),
                FaultEvent("slow_shard", at=3e-3, factor=3.0,
                           duration=4e-3),
                FaultEvent("transient", at=6e-3, count=1)])
            srv = AsyncReservoirServer(eng, n_slots=16, chunk_steps=32,
                                       chunk_time=1e-3, stats=ServeStats(),
                                       fault_plan=plan)
            for i, x in enumerate(inputs):
                srv.submit(SubmitSpec(x, uid=i), arrival_time=2e-4 * i)
            res, made = self._drive(srv.run, self.serve_launches)
            runs[name] = (srv, res, plan, made)
        clean, faulty = runs["clean"], runs["faults"]
        same = len(faulty[1]) == len(inputs) and all(
            np.array_equal(faulty[1][i].preds, clean[1][i].preds)
            for i in range(len(inputs)))
        st, plan = faulty[0].stats, faulty[2]
        self.check(same, "fault-plan answers != fault-free answers")
        self.check(st.retries == 3 and plan.injected == {
            "transient": 2, "slow_shard": 1},
            f"fault plan retries {st.retries}, injected {plan.injected}")
        self.check(faulty[0].now > clean[0].now, "fault clock not charged")
        print(f"  fault plan: {plan.injected} injected, {st.retries} "
              f"retries, clock {faulty[0].now * 1e3:.3f} ms vs "
              f"{clean[0].now * 1e3:.3f} ms fault-free; answers == "
              f"fault-free bit for bit {same}; launches {faulty[3]}")

    def _registry(self):
        """(d) Two models in one pool — "a" on B2, "b" generic on B1 — and
        a new version of "a" (a new readout) published mid-burst: zero
        drops, versions pinned at admission, every answer bit-exact
        against its pinned version's engine at the pool shape."""
        from repro_torch.serve import (AsyncReservoirServer, ModelRegistry,
                                       ServeStats, SubmitSpec)
        p = self.params_1024
        reg = ModelRegistry()
        reg.register("a", p)
        reg.register("b", dataclasses.replace(p, w_out=-0.5 * p.w_out),
                     specialize=False)
        srv = AsyncReservoirServer(reg.engine("a"), n_slots=16,
                                   chunk_steps=32, chunk_time=1e-3,
                                   registry=reg, stats=ServeStats())
        inputs = self._burst(32, 61)
        handles = [srv.submit(SubmitSpec(x, model="ab"[i % 2], uid=i),
                              arrival_time=5e-4 * i)
                   for i, x in enumerate(inputs)]

        def serve():
            published = None
            while srv.step():
                if published is None and srv.stats.completed >= 4:
                    published = reg.publish("a", dataclasses.replace(
                        p, w_out=1.5 * p.w_out))
            return published

        published, made = self._drive(serve, self.serve_launches)
        res = srv.results
        pinned = [(q.model, q.pinned_version) for q in handles]
        versions_ok = all(res[i].timings["version"] == v
                          and res[i].timings["model"] == m
                          for i, (m, v) in enumerate(pinned))
        exact = all(self._pool_exact(reg.engine(m, v), inputs[i],
                                     res[i].preds)
                    for i, (m, v) in enumerate(pinned))
        a_versions = sorted({v for m, v in pinned if m == "a"})
        self.check(published is not None and published["version"] == 2,
                   "registry publish mid-burst")
        self.check(len(res) == len(inputs) and srv.stats.timed_out == 0
                   and srv.stats.completed == len(inputs),
                   "registry dropped requests")
        self.check(versions_ok and a_versions == [1, 2],
                   f"registry versions {a_versions}")
        self.check(exact, "registry answers != pinned engine at the pool "
                   "shape")
        self.check(made["specialized_rollout"] > 0
                   and made["reservoir_rollout"] > 0,
                   f"registry launches {made}")
        prewarm = (published or {}).get("prewarm_s", float("nan"))
        print(f"  registry: {len(res)} served, {srv.stats.timed_out} dropped,"
              f" model a versions {a_versions} (publish after "
              f"{prewarm * 1e3:.1f} ms of prewarm), answers == pinned engine "
              f"at the pool shape "
              f"{exact}; {srv.stats.chunks} chunks, launches {made}")

    # -- phase 5 -------------------------------------------------------------
    def times(self):
        """B1 and B2 at the LARGE_1024 serve shape (B = 16, int8): one
        launch of T = 32 (a served chunk) and of T = 64 steps, reported
        per step, by CUDA events and the profiler, with the host enqueue
        per launch and a sweep of block counts."""
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            _launch_rollout, reservoir_rollout, reservoir_rollout_plain,
            rollout_grid)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout, specialized_rollout, specialized_rollout_plain)
        from repro_torch.plan import default_schedule
        params = self.params_1024
        cfg = params.config
        plan = params.w.plan()
        b, reps = 16, 20
        gen = torch.Generator(device="cpu").manual_seed(5)
        u = torch.randn((64, b, 1), generator=gen).to(self.dev)
        x0 = (0.5 * torch.randn((b, cfg.reservoir_dim),
                                generator=gen)).to(self.dev)
        ops = {
            "specialized_rollout": (SpecializedRollout(
                plan, params.w_in, leak=cfg.leak, mode="int8",
                w_out=params.w_out, device=self.dev),
                specialized_rollout_plain, specialized_rollout),
            "reservoir_rollout": (FusedRollout(
                plan, params.w_in, leak=cfg.leak, mode="int8",
                w_out=params.w_out, device=self.dev), reservoir_rollout_plain,
                reservoir_rollout),
        }
        # B2 is timed at the schedule phase 3's "auto" engine serves
        prog = ops["specialized_rollout"][0].program
        served = default_schedule(plan, "int8", "cuda")
        self.check((prog.crossover, prog.batch_tile_max)
                   == (served.crossover, served.batch_tile_max),
                   f"B2 timed at {prog.crossover=} {prog.batch_tile_max=}, "
                   f"served at {served.describe()}")

        timed = self.timed
        dense = params.w.dense_f32(device=self.dev)
        x = x0.clone()
        lib_step = timed(lambda: x @ dense, 200)
        bk = plan.block
        kw = dict(want_states=True, want_preds=False, want_final=False)
        extras = {}          # per kernel: its grid and its time sweeps
        for name, (op, _plain, _fn) in ops.items():
            grid, _ = rollout_grid(op.tables, self.dev)
            print(f"  {name} grid: {grid.n_blocks} blocks of {grid.cw} "
                  f"columns, {grid.form} form, share {grid.share_bytes} B "
                  f"per block, {'resident' if grid.resident else 'streamed'}"
                  f", {grid.smem} B shared memory per block")
            extras[name] = dict(
                n_blocks=grid.n_blocks, form=grid.form,
                share_bytes=grid.share_bytes, resident=grid.resident,
                smem_bytes=grid.smem)
        # in turns (B2, B1, B1, B2): the minimum of each kernel's two runs,
        # per step, for one launch of T steps
        runs = {(name, t): [] for name in ops for t in (32, 64)}
        for name in ("specialized_rollout", "reservoir_rollout",
                     "reservoir_rollout", "specialized_rollout"):
            op = ops[name][0]
            for t in (32, 64):
                runs[name, t].append(
                    timed(lambda: op(u[:t], x0, **kw), reps) / t)
        print("per-step runs (ms):",
              {f"{k[0]} T={k[1]}": v for k, v in runs.items()})
        for name, (op, _p, _f) in ops.items():
            for t in (32, 64):
                dev_us = self._device_us(lambda: op(u[:t], x0, **kw),
                                         "rollout_kernel")
                extras[name][f"device_us_per_launch_T{t}"] = \
                    dev_us
                print(f"  {name} T={t}: {dev_us:.2f} us device time per "
                      f"launch = {dev_us / t:.3f} us/step on {self.card}")
        for name, (op, plain, fn) in ops.items():
            extra = extras[name]
            for t in (32, 64):
                extra[f"ms_per_step_T{t}"] = min(runs[name, t])
                extra[f"ms_per_launch_T{t}"] = min(runs[name, t]) * t
                host = self._host_ms(lambda: op(u[:t], x0, **kw), reps)
                extra[f"host_ms_per_launch_T{t}"] = host
                print(f"  {name} T={t}: {min(runs[name, t]) * 1e3:.3f} us/step"
                      f", {min(runs[name, t]) * t * 1e3:.2f} us/launch, host "
                      f"enqueue {host * 1e3:.1f} us/launch on {self.card}")
            # block-count sweep, one launch of T = 64 steps
            sweep = {}
            chosen = extra["n_blocks"]
            for nb in sorted({32, 64, 128, chosen}):
                grid, _ = rollout_grid(op.tables, self.dev, nb)
                call = lambda nb=nb: _launch_rollout(   # noqa: E731
                    fn, u, op.tables, op.w_in, x0, None, leak=op.leak,
                    smax=op.smax, recur_scale=op.recur_scale, b_tile=b,
                    n_blocks=nb, **kw)
                sweep[nb] = timed(call, reps) / 64
                print(f"  {name} {nb} blocks ({grid.cw} columns, "
                      f"{'resident' if grid.resident else 'streamed'}, "
                      f"{grid.smem} B smem/block): {sweep[nb] * 1e3:.3f} "
                      f"us/step{' (chosen)' if nb == chosen else ''}")
            extra["ms_per_step_by_blocks"] = sweep
            # the same launch at batch 1: what of a step scales with B
            u1, x1 = u[:, :1], x0[:1]
            extra["ms_per_step_batch1"] = timed(
                lambda: op(u1, x1, **kw), reps) / 64
            print(f"  {name} batch 1, T=64: "
                  f"{extra['ms_per_step_batch1'] * 1e3:.3f} us/step on "
                  f"{self.card}")
        for name, (op, plain, _fn) in ops.items():
            per_step = min(runs[name, 64])
            common = dict(leak=op.leak, smax=op.smax,
                          recur_scale=op.recur_scale, readout_every=1, **kw)
            short = u[:8]
            plain_step = timed(lambda: plain(short, op.tables, op.w_in, x0,
                                             None, **common), 2) / 8
            # the served shape's states and its fused readout (per-block
            # partial sums reduced across the grid) against the twin
            got_s, got_p = op(u[:16], x0, want_states=True, want_preds=True)
            ref_s, ref_p = plain(u[:16], op.tables, op.w_in, x0, op.w_out,
                                 **dict(common, want_preds=True))
            d, dp = maxdiff(got_s, ref_s), maxdiff(got_p, ref_p)
            self.note_err(name, "int8", d)
            self.note_err("rollout_readout", "int8", dp)
            self.check(d == 0.0 and dp <= READOUT_TOL,
                       f"{name} vs twin at LARGE_1024: states {d:.3g}, "
                       f"fused readout {dp:.3g}")
            print(f"  LARGE_1024 int8 {name} vs twin, T=16: states {d:.3g}, "
                  f"fused readout {dp:.3g}")
            tb = op.tables
            n_mm = tb.n_matmul_terms
            bytes_ = (n_mm * bk * bk + tb.n_digits * 16
                      + len(tb.terms_host) * 16 + 2 * b * cfg.reservoir_dim * 4
                      + b * cfg.input_dim * 4
                      + cfg.input_dim * cfg.reservoir_dim * 4)
            int_ops = 2 * n_mm * bk * bk * b + 2 * tb.n_digits * b
            f32_ops = b * cfg.reservoir_dim * (2 * cfg.input_dim + 6)
            self._record(name, per_step, plain_step, lib_step, bytes_,
                         int_ops / INT8_OPS_PER_S + f32_ops / FP32_FLOPS_PER_S)
            self.kernels[name].update(extras[name])

    # -- phase 6 -------------------------------------------------------------
    def _unit_scale(self, dim, block):
        """tests/test_plan.py's integer matrix: amax == qmax, so scale is
        1.0 and float and integer products meet on exact integers."""
        from repro_torch.core.sparse import FixedMatrix
        rng = np.random.default_rng(0)
        q = rng.integers(-127, 128, size=(dim, dim)).astype(np.float64)
        q[rng.random((dim, dim)) < 0.9] = 0
        q[dim // 2:, :] = 0
        q[0, 0] = 127
        return FixedMatrix.compile(q, weight_bits=8, mode="csd", block=block,
                                   rng=rng)

    def _states(self, params, batch, steps, seed):
        """Final fp32 states of an int8 B2 rollout, and their int8
        requantization (what the int8 path multiplies)."""
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout)
        cfg = params.config
        op = SpecializedRollout(params.w.plan(), params.w_in, leak=cfg.leak,
                                mode="int8", device=self.dev)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        u = torch.randn((steps, batch, cfg.input_dim), generator=gen)
        x = op(u.to(self.dev), want_states=False, want_final=True)
        xq = torch.clamp(torch.round(x * op.smax), -op.smax - 1, op.smax)
        return x, xq.to(torch.int8)

    def _check_b3(self, op, fm, xq, tag):
        from repro_torch.kernels.bitplane_gemv.bitplane_gemv import (
            bitplane_gemv_plain)
        y = op(xq)
        twin = bitplane_gemv_plain(xq, op.digits, op.plane_mask)
        d = max(maxdiff(y, fm.matvec_int_exact(xq)),
                maxdiff(y, twin[:, : op.cols]))
        self.note_err("bitplane_gemv", "int8", d)
        self.check(d == 0.0, f"bitplane_gemv {tag}: {d:.3g}")
        return y, d

    def _check_b4(self, op, x, tag, mode, exact=None):
        from repro_torch.kernels.bcsr_matmul.bcsr_matmul import (
            bcsr_matmul_plain)
        y = op(x)
        twin = bcsr_matmul_plain(x, op.tiles, op.col_ptr, op.tile_rows,
                                 op.rows_pad)[:, : op.shape[1]]
        d = maxdiff(y, twin)
        if exact is not None:
            d = max(d, maxdiff(y, exact))
        self.note_err("bcsr_matmul", mode, d)
        tol = 0.0 if mode == "int8" else FP32_TOL
        self.check(y.dtype == twin.dtype and d <= tol,
                   f"bcsr_matmul {tag}: {d:.3g}")
        return y, d

    def _check_b5(self, fr, u, tag, against=None):
        torch = self.torch
        from repro_torch.kernels.reservoir_step.reservoir_step import (
            reservoir_step_plain)
        states = fr.run(u)
        x = torch.zeros((u.shape[1], fr.dim), device=self.dev)
        twin = []
        for t in range(u.shape[0]):
            x = reservoir_step_plain(x, fr.w, u[t], fr.w_in, leak=fr.leak)
            twin.append(x)
        d = maxdiff(states, torch.stack(twin))
        self.note_err("reservoir_step", "fp32", d)
        self.check(d <= FP32_TOL, f"reservoir_step {tag} vs twin: {d:.3g}")
        if against is not None:
            da = maxdiff(states, against)
            self.check(da <= FP32_TOL, f"reservoir_step {tag} vs fp32 B1: "
                       f"{da:.3g}")
            return d, da
        return d, None

    def fixed_matrix(self):
        """Phase 6: the fixed-matrix multiplier path at full width
        (LARGE_1024's matrix, made in phase 3), through BitplaneGemv (B3),
        BcsrMatmul (B4) and FusedReservoir (B5), each checked against its
        twin and an exact or independent reference."""
        torch = self.torch
        from repro_torch.kernels.bcsr_matmul import bcsr_matmul as b4
        from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
        from repro_torch.kernels.bitplane_gemv import bitplane_gemv as b3
        from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_step import reservoir_step as b5
        from repro_torch.kernels.reservoir_step.ops import FusedReservoir
        counted = {"bitplane_gemv": b3.bitplane_gemv,
                   "bcsr_matmul": b4.bcsr_matmul,
                   "reservoir_step": b5.reservoir_step}
        for fn in counted.values():
            fn.launches = 0

        params = self.params_1024
        cfg = params.config
        fm = params.w
        plan = fm.plan()
        x, xq = self._states(params, 16, 32, seed=17)
        self.fixed_inputs = (x, xq)
        b3op = BitplaneGemv(plan, device=self.dev)
        print(f"LARGE_1024 planes: {sum(plan.plane_mask)}/{plan.width} kept, "
              f"{b3op.digits.numel()} B of digits")
        for batch in (16, 1):
            _y, d = self._check_b3(b3op, fm, xq[:batch], f"LARGE_1024 b{batch}")
            print(f"  B3 BitplaneGemv int8 states b{batch}: "
                  f"== matvec_int_exact and twin (max |diff| {d:g})")

        b4op = BcsrMatmul(plan, device=self.dev)
        print(f"LARGE_1024 BCSR: {b4op.n_tiles} tiles of {b4op.block}")
        for batch in (16, 1):
            _y, d = self._check_b4(b4op, x[:batch], f"fp32 b{batch}", "fp32")
            print(f"  B4 BcsrMatmul fp32 b{batch} vs twin: {d:.3g}")
        _y, d = self._check_b4(b4op, x.to(torch.bfloat16), "bf16 b16", "bf16")
        print(f"  B4 BcsrMatmul bf16 b16 vs twin: {d:.3g}")
        unit = self._unit_scale(cfg.reservoir_dim, cfg.block)
        uop = BcsrMatmul(unit, device=self.dev)
        for dtype in (torch.int32, torch.int8):
            xi = xq.to(dtype)
            _y, d = self._check_b4(uop, xi, f"unit-scale {dtype}", "int8",
                                   exact=unit.matvec_int_dense_ref(xi))
            print(f"  B4 BcsrMatmul {dtype} on the unit-scale matrix: "
                  f"exact ({d:g})")

        dense = fm.dense_f32(device=self.dev)
        fr = FusedReservoir(dense, params.w_in, leak=cfg.leak,
                            device=self.dev)
        gen = torch.Generator(device="cpu").manual_seed(19)
        u = torch.randn((64, 16, cfg.input_dim), generator=gen).to(self.dev)
        b1 = FusedRollout(plan, params.w_in, leak=cfg.leak, mode="fp32",
                          device=self.dev)(u)
        d, da = self._check_b5(fr, u, "LARGE_1024 64 steps b16", against=b1)
        print(f"  B5 FusedReservoir.run 64 steps b16: vs twin {d:.3g}, vs "
              f"fp32 B1 rollout {da:.3g}")

        self._cross_family()
        self._ragged_fixed()
        self.launches.update({k: fn.launches for k, fn in counted.items()})
        print("phase-6 launches:", {k: self.launches[k] for k in counted})
        for k in counted:
            self.check(self.launches[k] > 0, f"{k} launched on phase 6")

    def _cross_family(self):
        """tests/test_plan.py's check on the card: one unit-scale plan, B3
        == xq @ q, B4 (fp32 input) == the same, one int8 B1 step ==
        tanh(y * recur_scale), all exact."""
        torch = self.torch
        from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
        from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        fm = self._unit_scale(256, 64)
        plan = fm.plan()
        rng = np.random.default_rng(1)
        xq = torch.as_tensor(rng.integers(-4, 5, size=(3, 256)),
                             dtype=torch.int32, device=self.dev)
        exact = fm.matvec_int_dense_ref(xq)
        y_int, _ = self._check_b3(BitplaneGemv(plan, device=self.dev), fm, xq,
                                  "cross-family")
        y_f = BcsrMatmul(plan, device=self.dev)(xq.to(torch.float32))
        fr = FusedRollout(plan, np.zeros((1, 256), np.float32), leak=1.0,
                          mode="int8", device=self.dev)
        got = fr(torch.zeros((1, 3, 1), device=self.dev),
                 xq.to(torch.float32) / fr.smax)[0]
        want = torch.tanh(y_int.to(torch.float32) * torch.tensor(
            fr.recur_scale, dtype=torch.float32, device=self.dev))
        ok = (torch.equal(y_int, exact)
              and torch.equal(y_f, exact.to(torch.float32))
              and torch.equal(got, want))
        self.note_err("bcsr_matmul", "fp32", maxdiff(y_f, exact))
        self.check(ok, "cross-family B3 == B4 == xq @ q, B1 == tanh(y rs)")
        print(f"cross-family (unit scale, dim 256): exact {ok}")

    def _ragged_fixed(self):
        """PAPER_BASELINE (dim 800: 7 column blocks of 128, the last one
        96 wide) through all three wrappers."""
        from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
        from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
        from repro_torch.kernels.reservoir_step.ops import FusedReservoir
        params = self.params_800
        cfg = params.config
        plan = params.w.plan()
        x, xq = self._states(params, 5, 8, seed=23)
        _y, d3 = self._check_b3(BitplaneGemv(plan, device=self.dev), params.w,
                                xq, "PAPER_BASELINE")
        _y, d4 = self._check_b4(BcsrMatmul(plan, device=self.dev), x,
                                "PAPER_BASELINE fp32", "fp32")
        fr = FusedReservoir(params.w.dense_f32(device=self.dev), params.w_in,
                            leak=cfg.leak, device=self.dev)
        gen = self.torch.Generator(device="cpu").manual_seed(29)
        u = self.torch.randn((16, 5, cfg.input_dim), generator=gen)
        d5, _ = self._check_b5(fr, u.to(self.dev), "PAPER_BASELINE")
        print(f"PAPER_BASELINE (dim 800) B3 {d3:g}, B4 {d4:.3g}, B5 {d5:.3g} "
              "vs twins")

    # -- phase 5, the fixed-matrix kernels -----------------------------------
    def fixed_times(self):
        """B3, B4 and B5 per launch at the LARGE_1024 shape, batch 16 (the
        main entry) and batch 1 (the paper's latency case), beside their
        twins, one library call each and their bounds."""
        torch = self.torch
        from repro_torch.kernels.bcsr_matmul.bcsr_matmul import (
            bcsr_matmul_plain)
        from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
        from repro_torch.kernels.bitplane_gemv.bitplane_gemv import (
            bitplane_gemv_plain)
        from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
        from repro_torch.kernels.reservoir_step.ops import FusedReservoir
        from repro_torch.kernels.reservoir_step.reservoir_step import (
            reservoir_step_plain)
        timed = self.timed
        params = self.params_1024
        cfg = params.config
        plan = params.w.plan()
        r = c = cfg.reservoir_dim
        b3op = BitplaneGemv(plan, device=self.dev)
        b4op = BcsrMatmul(plan, device=self.dev)
        dense = params.w.dense_f32(device=self.dev)
        fr = FusedReservoir(dense, params.w_in, leak=cfg.leak,
                            device=self.dev)
        qf = torch.as_tensor(params.w.q, device=self.dev).to(torch.float32)
        csr_t = dense.t().contiguous().to_sparse_csr()     # cuSPARSE: M^T
        kept = sum(plan.plane_mask)
        g3, g4 = b3op.packed.grid, b4op.packed.grid
        b5_grids = {bt: self._b5_grid(fr.packed.grid(bt)) for bt in (16, 1)}
        grids = {
            "bitplane_gemv": dict(
                n_blocks=g3.n_blocks, columns_per_block=8 * g3.groups,
                share_bytes=g3.share_bytes, stages=g3.n_stages,
                smem_bytes=b3op.packed.launch[True][1]),
            "bcsr_matmul": dict(
                n_blocks=g4.n_blocks, columns_per_block=g4.cw,
                cluster=g4.parts, tiles_per_block=g4.max_tiles,
                smem_bytes=g4.smem(16)),
            "reservoir_step": b5_grids[16]}
        for name, g in grids.items():
            print(f"  {name} grid: {g}")
        print(f"  reservoir_step grid at batch 1: {b5_grids[1]}")
        x16, xq16 = self.fixed_inputs
        i_dim = cfg.input_dim
        gen = torch.Generator(device="cpu").manual_seed(31)
        u16 = torch.randn((16, i_dim), generator=gen).to(self.dev)
        f32 = FP32_FLOPS_PER_S
        for batch in (16, 1):
            x, xq, u = x16[:batch], xq16[:batch], u16[:batch]
            key = None if batch == 16 else batch
            b3_ms = timed(lambda: b3op(xq), 200)
            b3_plain = timed(lambda: bitplane_gemv_plain(
                xq, b3op.digits, b3op.plane_mask), 5)
            b3_lib = timed(lambda: xq.float() @ qf, 200)
            self._record("bitplane_gemv", b3_ms, b3_plain, b3_lib,
                         kept * r * c + batch * r + 4 * batch * c,
                         2 * kept * batch * r * c / INT8_OPS_PER_S, key)
            b4_ms = timed(lambda: b4op(x), 200)
            b4_plain = timed(lambda: bcsr_matmul_plain(
                x, b4op.tiles, b4op.col_ptr, b4op.tile_rows, b4op.rows_pad),
                5)
            b4_lib = timed(lambda: x @ dense, 200)
            xt = x.t().contiguous()
            b4_sparse = timed(lambda: torch.sparse.mm(csr_t, xt), 200)
            tile_elems = b4op.n_tiles * b4op.block ** 2
            print(f"cuSPARSE torch.sparse.mm (CSR, {csr_t.values().numel()} "
                  f"nonzeros) b{batch}: {b4_sparse * 1e3:.2f} us on "
                  f"{self.card}")
            self._record("bcsr_matmul", b4_ms, b4_plain, b4_lib,
                         4 * (tile_elems + batch * r + batch * c),
                         2 * batch * tile_elems / f32, key)
            self.kernels["bcsr_matmul"][
                "cusparse_ms" if key is None else f"cusparse_ms_batch{batch}"
            ] = b4_sparse
            out = torch.empty((batch, r), device=self.dev)
            b5_ms = timed(lambda: fr.step(x, u, out=out), 200)
            b5_plain = timed(lambda: reservoir_step_plain(
                x, fr.w, u, fr.w_in, leak=fr.leak), 50)
            b5_lib = timed(lambda: x @ dense, 200)
            self._record("reservoir_step", b5_ms, b5_plain, b5_lib,
                         4 * (r * r + i_dim * r + batch * i_dim
                              + 2 * batch * r),
                         batch * r * (2 * r + 2 * i_dim + 6) / f32, key)
            calls = {"bitplane_gemv": lambda: b3op(xq),
                     "bcsr_matmul": lambda: b4op(x),
                     "reservoir_step": lambda: fr.step(x, u, out=out)}
            libs = {"bitplane_gemv": lambda: xq.float() @ qf,
                    "bcsr_matmul": lambda: x @ dense,
                    "reservoir_step": lambda: x @ dense}
            kernels = {"bitplane_gemv": "bitplane_gemv_kernel",
                       "bcsr_matmul": "bcsr_matmul_kernel",
                       "reservoir_step": "reservoir_step_kernel"}
            for name, call in calls.items():
                rec = self.kernels[name] if key is None else \
                    self.kernels[name][f"batch{batch}"]
                rec["host_ms"] = self._host_ms(call, 50)
                rec["device_us_per_launch"] = self._device_us(
                    call, kernels[name], n=20)
                rec["library_device_us"] = self._device_us(libs[name], "",
                                                           n=20)
                line = (f"  {name} b{batch}: device "
                        f"{rec['device_us_per_launch']:.3f} us/launch "
                        f"(library call {rec['library_device_us']:.3f} us)")
                rec["device_us_per_launch_cold_l2"] = self._device_us(
                    call, kernels[name], n=20, flush=True)
                line += (f", cold L2 "
                         f"{rec['device_us_per_launch_cold_l2']:.3f} us")
                print(f"{line}, host enqueue {rec['host_ms'] * 1e3:.1f} "
                      f"us/launch on {self.card}")
            rec = self.kernels["bcsr_matmul"] if key is None else \
                self.kernels["bcsr_matmul"][f"batch{batch}"]
            rec["cusparse_device_us"] = self._device_us(
                lambda: torch.sparse.mm(csr_t, xt), "", n=20)
        for name, g in grids.items():
            self.kernels[name]["grid"] = g
        self.kernels["reservoir_step"]["batch1"]["grid"] = b5_grids[1]

    @staticmethod
    def _b5_grid(g) -> dict:
        """What B5's launch at one batch tile looks like: blocks, columns
        and W rows per block, cluster parts, share and shared-memory
        bytes per block."""
        return dict(n_blocks=g.n_blocks, columns_per_block=g.cw,
                    cluster=g.parts, rows_per_block=g.rows,
                    share_bytes=g.share_bytes, smem_bytes=g.smem)

    def _host_ms(self, fn, n):
        """ms per call of ``fn`` on the host clock with no device sync
        inside the loop: the Python wrapper's issue cost."""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) / n * 1e3
        self.torch.cuda.synchronize()
        return host

    def timed(self, fn, n):
        """ms per call of ``fn`` over ``n`` calls, by CUDA events, after
        one warm-up call."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def _profile(self, calls, quiet=False):
        """Device time per kernel launch from a torch.profiler trace (the
        CUDA-event times include any gaps between launches)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for call in calls:
                call()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.count and e.device_time_total > 0]
        if not rows:
            print("profiler: no device kernels recorded")
        for e in [] if quiet else rows:
            print(f"  profiler {e.key[:60]}: {e.count} launches, "
                  f"{e.device_time_total / e.count:.2f} us device time each")
        return rows

    def _device_us(self, call, kernel: str, n: int = 1, flush=False,
                   required=True, per_call=1):
        """Device µs per call of the launches of ``kernel`` (every kernel
        the call launches with ``kernel=""``), from a profile of ``n``
        calls; with ``flush`` a 128 MiB buffer is written before each call
        (the 50 MB L2 holds none of the operands: cold L2).  A named
        kernel must show ``per_call`` launches per call (every call at
        least one launch), else the profile is taken again, up to five
        times a second apart, and then the run fails.  Only
        ``required=False`` (the torch backend's device time, hundreds of
        small launches per call) returns None instead, printed as "not
        measured"."""
        torch = self.torch
        if flush:
            buf = torch.empty(32 << 20, dtype=torch.float32, device=self.dev)

            def cold():
                buf.fill_(1.0)
                call()
            calls = [cold] * n
        else:
            calls = [call] * n
        call()
        for attempt in range(5):
            if attempt:
                time.sleep(1.0)
            rows = [e for e in self._profile(calls, quiet=n > 1)
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and kernel in e.key]
            count = sum(e.count for e in rows)
            if count == n * per_call or (not kernel and count >= n):
                return sum(e.device_time_total for e in rows) / n
        what = (f"{n * per_call} launches of {kernel}" if kernel
                else f"a launch in each of {n} calls")
        if required:
            raise RuntimeError(f"the profiler did not record {what} in "
                               "five profiles")
        print(f"profiler: {what} not recorded in five profiles: "
              "not measured")
        return None

    def _record(self, name, ms, plain_ms, library_ms, bytes_, ops_s,
                batch=None):
        """Times of one kernel beside its bound: the main entry, or with
        ``batch`` an extra ``batch<N>`` entry of the same kernel."""
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops_s * 1e3
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        if batch is None:
            self.kernels[name] = rec
        else:
            self.kernels[name][f"batch{batch}"] = rec
        print(f"time {name}{'' if batch is None else f' batch {batch}'}: "
              f"{ms * 1e3:.2f} us/launch, twin {plain_ms * 1e3:.1f} us, "
              f"library {library_ms * 1e3:.2f} us, bound "
              f"{max(t_bytes, t_ops) * 1e3:.4f} us ({rec['bound_by']}) on "
              f"{self.card}")

    def kernels_line(self) -> str:
        rows = []
        for name, (rep, source) in KERNELS.items():
            e = self.err[name]
            rows.append(dict(
                name=name, route="cuda", source=source, replaces=rep,
                launches=self.launches[name],
                launches_sharded=self.sharded_launches.get(name, 0),
                launches_serve_layer=self.serve_launches.get(name, 0),
                launches_lm_serve=self.lm_launches.get(name, 0),
                launches_lm_blocks=self.blocks_launches.get(name, 0),
                launches_lm_train=self.train_launches.get(name, 0),
                launches_lm_mesh=self.mesh_launches.get(name, 0),
                launches_lm_dryrun=self.dryrun_launches.get(name, 0),
                launches_examples=self.examples_launches.get(name, 0),
                max_abs_err=max(v for v in e.values() if v is not None),
                **{f"max_abs_err_{m}": v for m, v in e.items()},
                **self.kernels.get(name, {})))
        return json.dumps({"kernels": rows})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import repro_torch
    except ImportError:
        repro_torch = None
    if repro_torch is None or ROOT not in pathlib.Path(
            repro_torch.__file__).resolve().parents:
        print("chip_smoke: run from a checkout (src/repro_torch not found "
              "beside this script)", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch)
    t_all = time.perf_counter()
    # serve_layer after the kernels' timing phases (a profile taken after
    # its profiles of the torch backend's many small launches came back
    # empty), and lm_serve after every profile: serve_layer's first
    # profile after lm_serve recorded no launch on the H100
    for phase in (smoke.build, smoke.twins, smoke.main_path,
                  smoke.baseline_twins, smoke.fixed_matrix, smoke.times,
                  smoke.fixed_times, smoke.autotune, smoke.sharded,
                  smoke.serve_layer, smoke.lm_serve, smoke.lm_blocks,
                  smoke.train, smoke.mesh, smoke.dryrun, smoke.examples):
        t0 = time.perf_counter()
        print(f"== {phase.__name__}")
        try:
            phase()
        except Exception:                      # report, then fail the run
            traceback.print_exc()
            smoke.failures.append(f"phase {phase.__name__} raised")
            break
        print(f"== {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    if smoke.failures:
        print(f"chip_smoke FAILED: {smoke.failures}", file=sys.stderr)
        return 1
    print(f"requests/s (LARGE_1024 server, 16 slots, {BURSTS} bursts): "
          f"{smoke.requests_per_s:.2f} on {smoke.card}")
    print(smoke.kernels_line())
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
