#!/usr/bin/env python3
"""Drives the PyTorch port's serving and training paths on one CUDA card and
checks them.

    python3 chip_smoke.py          # from the repository root, one card

Four serving paths: gemma3-1b (attention: the flash-attention kernel),
mamba2-780m (SSM: the two SSD-scan kernels), hymba-1.5b (an attention and
an SSM branch in every layer: both kernel families) and olmoe-1b-7b (MoE:
the grouped-GEMM kernel, with flash attention, then qwen2-moe-a2.7b at
full depth); the hubert-xlarge encoder's forward and training
(bidirectional attention at D 80, frame embeddings); internvl2-26b
serving (a 19.9 B VLM backbone from the serving init straight into bf16,
patch embeddings then tokens); gemma-7b, h2o-danube-1.8b and deepseek-7b
served whole (the dense configurations, each through the flash-attention
kernel at its own shape); then the gemma3-1b
training path (the flash-attention forward with its LSE and the backward
kernels), the mamba2-780m training path (the SSD scan's backward kernels),
the hymba-1.5b training path (both families' backward kernels), the
olmoe-1b-7b training path (the grouped GEMM's dx and dw kernels) and the
gang trainer (several members in one batched run).
Phases, each printing one
JSON line; any failure raises, so the script exits non-zero and prints no
result line:

1. environment: card name and power limit, torch / CUDA / nvcc versions,
   the TF32 switches;
2. build: every CUDA source under ``src/repro_torch/kernels/csrc`` (one
   nvcc each, all at once), with ptxas's registers and spills, and the
   lines that flag a kernel: spills, an ignored setmaxnreg, wgmma
   serialised by the compiler;

then for each path in turn (gemma3-1b, mamba2-780m, hymba-1.5b,
olmoe-1b-7b):

3. kernels against their plain versions at the path's shapes (gemma3-1b
   prefill plus h2o-danube, deepseek, hymba-1.5b's global and window,
   hubert-xlarge's (bidirectional D 80) and internvl2-26b's shapes;
   mamba2-780m prefill
   plus hymba-1.5b's SSD shape, G > 1, S < chunk, an initial state, a chunk
   of 96 (partial row tiles) and 256 chunks a chain (the state hand-off);
   olmoe-1b-7b prefill and decode plus qwen2-moe-a2.7b's expert shapes and
   edge cases of the group sizes, and olmoe-1b-7b's attention, its 16
   calls of a prefill), with the kernel's, the plain version's and (for
   attention and the grouped GEMM) one PyTorch call's times and the card's
   bound for the same work (for the SSD kernels also their own device
   time by the profiler, ``kernel_ms``: the wrappers' host time a call can
   exceed ssd_chunk_state's), and at decode the grouped GEMM wrapper's host
   time a call; the error is gated both absolutely and relative to each
   output row's (attention, grouped GEMM) or each (batch, head)'s (SSD)
   largest element; then the kernels' calls of one prefill, timed
   together;
4. prefill: full-width ``forward`` on a (4, 2048) batch, with the launch
   counts reset just before it and read just after, the weights made by
   the serving init straight into bf16 (olmoe-1b-7b with both MoE
   dispatches; then qwen2-moe-a2.7b at full width and depth);
5. correctness at full width: prefill against teacher-forced decode, and
   a forward against the same model with the kernels' plain version in
   their place (for olmoe-1b-7b also the count of routing decisions that
   differ between the two runs; for hymba-1.5b both kernel families'
   plain versions, and prefill against decode also past its window of
   1024, on its first 4 layers over 1280 positions; qwen2-moe-a2.7b's
   plain-GEMM check on 4 of its 24 layers; mamba2-780m's and hymba-1.5b's
   prefill against decode over 512 positions on their first 12 and 8
   layers, SSD_CONSISTENCY_LAYERS); then the card's forward
   against the CPU's on a small config (hymba's with an SSD state of 16,
   CARD_SMOKE);
6. serve: ``ServeEngine`` answers 8 requests of 16 new tokens each;
7. profile: one prefill and a window of 4 decode steps under
   ``torch.profiler``: device busy time and idle share, kernel launches,
   host synchronisations and device time by kernel class.

Then the training path of gemma3-1b:

3. ptxas's registers and spills of the backward's kernels (prep, main,
   dQ conversion) from this run's build; the flash-attention backward
   against its plain backward (and the
   forward's LSE against logsumexp of the plain scores) at gemma3-1b's
   global, window and ragged shapes, D 128 (olmoe-1b-7b, deepseek-7b),
   hymba-1.5b's, bidirectional D 80, the smoke head dims and rows whose LSE
   marks them as having seen no key, with the kernel's, the plain
   backward's and ``torch.autograd.grad`` through SDPA's times and the
   bound; then the 26 backward calls of one train step, timed together;
4. train: ``repro_torch.launch.train.main`` on gemma3-1b at full width and
   depth (fp32 parameters, bf16 compute, full remat), a (4, 2048) batch
   from ``make_stream``, 2 warm-up and 5 timed steps, with the launch counts
   reset just before and read just after: step time, tokens/s, 6·N·T
   utilisation and peak memory;
5. correctness: one step's loss and gradients with the kernels against the
   same with the plain attention in their place, then 8 steps on one
   repeated batch, in which the loss must fall, and one step's launches
   (26 forward + 26 recomputed by the remat, 26 backward);
6. profile: one train step under ``torch.profiler``.

Then the training path of mamba2-780m (the SSD scan's backward kernels):

3. ptxas's registers and spills of the SSD kernels; the two backward
   kernels (``ssd_chunk_state_bwd``, then ``ssd_chunk_scan_bwd`` on the
   plain state pass's outputs) against their plain versions at
   mamba2-780m's training shape, hymba-1.5b's SSD, the (64, 64) pair with
   G 4, the (16, 16) pair, and with an initial state and a gradient of the
   final state: each output (G, G_0, dT; dx, dlog_a, dB and dC with their
   slices added) within 5e-2 of its (batch, head)'s largest |plain|; their
   times, the whole backward's (both kernels and the glue, as ``SSDScan``
   runs it), the plain versions' and the bounds (each kernel's own, the
   function's for the whole); then the 48 calls of each, and of the whole
   backward, in one train step, timed together;
4. train: ``launch.train.main`` on mamba2-780m at full width and depth, a
   (4, 2048) batch, 2 warm-up and 3 timed steps, the launch counts reset
   just before and read just after: step time, tokens/s, 6·N·T share and
   peak memory;
5. correctness: the kernels' step against the plain SSD's (|Δloss| ≤
   0.1·std(logits), grad-norm relative error ≤ 0.05), 8 steps on one batch
   (the loss must fall) and one step's launches (96 of each forward SSD
   kernel, 48 + 48 by the full remat; 48 of each backward);
6. profile: one train step.

After hymba-1.5b's serving path, hubert-xlarge (encoder-only: no serve
phase): the 48 attention calls of one forward timed together, a forward
at full width and depth on (4, 2048) frame embeddings (48 launches), the
forward against the plain attention's and the card against the CPU on the
smoke config, a profiled forward; then its training: the 48 backward calls
of a step timed together, ``launch.train.main`` at full width and depth
(2 warm-up and 3 timed steps), the kernels' step against the plain
attention's, 8 steps on one batch, one step's launches (96 forward, 48
backward) and its profile.  Then internvl2-26b: the 48 attention calls of
a prefill timed together, the serving init (its peak against the tree's
bytes and one fp32 draw), a prefill on (4, 2048) positions of which 256
are patch embeddings, the forward against the plain attention's, the card
against the CPU, serve (tokens only) and a profile; its 40 GB are freed
before the dense configurations: gemma-7b (28 layers, MHA at D 256,
vocabulary 256,000), h2o-danube-1.8b (D 80, a window of 4096) and
deepseek-7b (MHA at D 128), each from the serving init (its peak beside
the tree's bytes): the attention calls of a prefill timed together, a
prefill on (4, 2048) tokens, prefill against decode over 160 positions
at full depth, for h2o-danube-1.8b a forward on one row of 4608
positions against the plain attention's (past its window), the card
against the CPU and serve; then olmoe-1b-7b's path.

Then the training path of hymba-1.5b: the backward kernels' calls of one
train step (32 of each, timed together), its memory reckoned, then
``launch.train.main`` at full width and depth (2 warm-up and 3 timed
steps on (4, 2048) batches), the kernels' step against the plain versions'
of both families, 8 steps on one batch and one step's launches (64 flash
attention and 64 of each SSD forward kernel with the remat, 32 of each
backward), and its profile.  Then h2o-danube-1.8b's training the same
way (its 24 backward calls timed together, launch.train at full width
and depth, train_checks), and launch.train refusing gemma-7b and
deepseek-7b on one card before it allocates.

Then the training path of olmoe-1b-7b (the grouped GEMM's backward):

3. ptxas's registers and spills of the grouped GEMM's kernels; dx =
   dy·w[e]ᵀ and dw = x_eᵀ·dy_e against their plain versions at olmoe's
   gate/up and down shapes (T 65,536 rows of a top-8 routing),
   qwen2-moe-a2.7b's (E 60, f 1408, top-4), every row in one expert, 1000
   rows in groups off the 64-row steps with empty experts, and one row:
   dx within GMM_TOL (absolute plus relative) and 2e-2 of each row's
   largest; dw, written into a NaN-filled buffer, within 2e-2 of each
   expert slab's largest |plain|, an empty expert's slab exactly zero;
   their times, the plain versions', ``torch._grouped_mm``'s and the bound;
4. train: full width (d 2048, 64 experts top-8, 16 heads of 128, the
   einsum dispatch), depth cut by memory (MOE_TRAIN_DEPTHS: 8 of 16 layers
   if the reckoning and the measured peak fit TRAIN_BUDGET_GB, else
   4), ``init_train_state`` and ``make_train_step`` with ``launch.train``'s
   optimizer and schedule on (4, 2048) batches from ``make_stream``, 2
   warm-up and 3 timed steps, the launch counts reset before and read
   after: step time, tokens/s, 6·N_active·T utilisation (top-8 of 64
   experts) and peak memory;
5. correctness: one step's loss and gradients with the kernels against the
   same with the plain grouped GEMM, the plain run choosing the experts the
   kernels' run chose with its own differentiable router probabilities
   (|Δloss| ≤ 0.1·std(logits), grad-norm relative error ≤ 0.05; the free
   run's difference reported, not gated), 8 steps on one batch (the loss
   must fall) and one step's launches (6·L forward grouped GEMMs, 3·L dx,
   3·L dw, 2·L + L flash attention);
6. profile: one train step; then a step's 3·L dx and 3·L dw calls timed
   together, and ``launch.train.main`` on the smoke MoE config on the
   card.

Then the gang (``repro_torch.train.ensemble.train_gang``): gemma3-1b at
full width, members 0 and 1 (own lr, 2 × 1024 tokens a step each, 3
steps) each alone and both in one gang: every step's loss of the gang
within 5e-3 (relative) of the member's alone, and the flash-attention
launches a step the same for two members as for one; step time and peak
memory of each run; the same for a smoke-size mamba2 gang (the SSD scan's
vmap rule), a smoke-size olmoe gang (the grouped GEMM's, forward, dx and
dw) and a smoke-size hymba gang (both families' rules in one layer); a
one-step gang of two gemma3-1b members under the profiler.

Then the mesh section (the multi-device layer, part 1): (a) gemma3-1b at
full width and depth through ``launch.train`` on the one-rank NCCL mesh
(its state DTensors by the sharding rules, the data-parallel step with
ZeRO-1), one step against ``make_train_step`` without a mesh on the same
state and batch (loss, grad_norm and every parameter the same bits), then
timed steps, peak memory and one step's profile with its NCCL time; (b)
olmoe-1b-7b with the ragged dispatch under the mesh (``moe_ragged_sharded``
→ ``moe_sorted_local``: the grouped GEMM with every group size Cl, 1280 at
4 x 2048): a prefill at full width and depth from the serving init (48
launches, ``dropped``, each layer's busiest expert), the forward against
the GEMM's plain version (the olmoe path's routing and agreement gates),
the 48 calls at that shape against one ``torch.bmm`` each and the bound,
a train step at 4 layers (24 forward GEMMs with the remat, 12 dx, 12 dw)
and its dx and dw calls timed the same way; (c) two ranks on the one card
over gloo (NCCL takes one rank a device): gemma3-1b through
``launch.train`` at data 2 on a global 4 x 2048 batch, the ZeRO-1 shards
split in two, both processes' memory reckoned first, held against one
rank on the concatenated batch; then in the same processes at
``--n-micro 2`` (each rank's share of each microbatch, a block of the
global batch, by an all-to-all), held against one rank at n_micro 2.

Then the tensor-parallel section (two gloo ranks at (data 1, model 2):
each arch's train step against one rank, then each kernel at one rank's
shapes), and decode under a ``model`` axis (``tp_decode``): gemma3-1b,
mamba2-780m, hymba-1.5b and olmoe-1b-7b at full width and depth from bf16
serving trees, each rank holding only its shards of the weights and the
cache, 8 teacher-forced tokens on 4 slots and a 2048 cache against one
rank on the same weights (§2's decode gates on the logits, each cache
shard's shape exact and within the model's own bf16 rounding of one
rank's, measured against a decode at fp32 compute), olmoe's decode
grouped GEMMs at f 512 against their plain version; then
``dryrun_vs_card``: the dry run's count on the meta device
(``repro_torch.launch.dryrun``) against the same counter on the card for
gemma3-1b's train step at 4 x 2048 (at n_micro 1 and 2) and
mamba2-780m's prefill on one card, and gemma3-1b's train and decode
steps on the two ranks: FLOPs, HBM bytes, each kernel's calls and the
collectives equal, the reckoned peak within 10% of
``max_memory_allocated`` on one card, the measured step no shorter than
the roofline's bound.

Then the script's total seconds (the ``done`` phase), the kernels line,
the card line and, last, the result line.  There is no CPU mode: without a
CUDA device the script exits with an error.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
KERNEL_TOL = 2e-2             # bf16, as the reference's kernel tests
# The same error relative to each output row's largest |element|: both
# sides round to bf16, so a row's largest element differs by at most one
# bf16 step (2**-7 of it at worst), and the kernel's bf16 probabilities add
# noise of ~2**-9 of the row's scale; 2e-2 is 2.5 steps at worst.  Unlike
# the absolute bound it holds the late rows too, whose |out| is ~0.05: a
# window edge one key off in a 512-key row moves such a row by ~4%.
ROW_REL_TOL = 2e-2
CPU_GPU_TOL = 5e-2            # bf16 logits of |x| < 2: a few bf16 steps
# Two full-width model paths that compute the same logits but round at
# different places, both in bf16: prefill (kernel: probs rounded to bf16
# inside the tile loop) against teacher-forced decode (plain attention
# over the bf16 cache), and the kernel's forward against the same forward
# with the plain attention.  Each layer leaves differences of a few bf16
# steps (2**-8 relative) in the residual stream, which 26 layers and the
# 1152-wide unembedding carry to the logits.  Bounds, relative to the
# logits' standard deviation: 0.05 for the mean |difference| (an error of
# ~10 bf16 steps of a logit of one std), 0.25 for the max over all
# positions x 262144 logits (the far tail of that error); and the argmax
# must agree wherever the top-2 margin is more than twice the largest
# difference.
CONSISTENCY_MAX_REL = 0.25
CONSISTENCY_MEAN_REL = 0.05
# Those bounds are for gemma3-1b's 26 layers.  Each layer's few bf16 steps
# of difference are carried, and mixed, by every layer after it, so the
# difference at the logits grows with the depth: as sqrt(depth) if the
# layers' differences stay independent, linearly if they add coherently.
# The bounds take the linear envelope, x depth / 26 (mamba2-780m, 48
# layers: 0.46 max, 0.092 mean).
CONSISTENCY_LAYERS = 26
CONSISTENCY_PROMPT = 160      # 3 key tiles of 64: the online softmax runs
WINDOW_CHECK_SEQ = 600        # past gemma3-1b's window of 512
#: decode steps a profile_decode window holds, after 4 warm-up steps (8
#: until the script's time ran short: the profiler's trace of a decode
#: step, ~3,000 launches, takes it seconds to read)
PROFILE_DECODE_STEPS = 4
#: a prefill's batch: the tokens of each path's prefill phase
PREFILL_BATCH, PREFILL_SEQ = 4, 2048
#: host-side runtime calls that launch a kernel or wait for the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:90"
#: the backward's design, redesigned for Hopper after a first mma.sync
#: version (dQ and dK/dV kernels, S and dP computed in both)
FA_BWD_DESIGN = ("wgmma + TMA, warp-specialised: S and dP once a tile pair, "
                 "dQ added in key-tile order by a chained hand-off")
#: flash attention against its plain version, before gemma3-1b's prefill:
#: name, B, S, Hq, Hkv, D, causal, window (every head dim the kernel is
#: compiled for; olmoe-1b-7b's shape is checked on its own path)
FA_CASES = [
    ("gemma3-1b global", 4, 2048, 4, 1, 256, True, 0),
    ("gemma3-1b swa", 4, 2048, 4, 1, 256, True, 512),
    ("gemma3-1b swa S=window", 4, 512, 4, 1, 256, True, 512),
    ("gemma3-1b ragged", 4, 1000, 4, 1, 256, True, 0),
    ("gemma3-1b ragged swa", 4, 1000, 4, 1, 256, True, 512),
    ("h2o-danube-1.8b", 4, 2048, 32, 8, 80, True, 4096),
    ("h2o-danube-1.8b past window", 1, 4608, 32, 8, 80, True, 4096),
    ("deepseek-7b", 4, 2048, 32, 32, 128, True, 0),
    ("hymba-1.5b global", 4, 2048, 25, 5, 64, True, 0),
    ("hymba-1.5b swa", 4, 2048, 25, 5, 64, True, 1024),
    ("hubert-xlarge", 4, 2048, 16, 16, 80, False, 0),
    ("internvl2-26b", 4, 2048, 48, 8, 128, True, 0),
    ("bidirectional D128", 2, 200, 4, 2, 128, False, 0),
    ("smoke D32 window", 2, 40, 2, 1, 32, True, 16),
    ("smoke D16 MHA", 2, 72, 4, 4, 16, True, 0),
]
#: the flash-attention backward against its plain backward, before the
#: gemma3-1b training path: name, B, S, Hq, Hkv, D, causal, window, and
#: whether some rows' LSE is set to -inf (rows that saw no key: no mask of
#: the kernel leaves a row of S empty, so the backward's contract for such
#: a row is checked on the forward's LSE with those rows marked)
FA_BWD_CASES = [
    ("gemma3-1b global", 4, 2048, 4, 1, 256, True, 0, False),
    ("gemma3-1b swa", 4, 2048, 4, 1, 256, True, 512, False),
    ("gemma3-1b ragged", 4, 1000, 4, 1, 256, True, 0, False),
    ("olmoe-1b-7b D128", 4, 2048, 16, 16, 128, True, 0, False),
    ("deepseek-7b D128", 4, 2048, 32, 32, 128, True, 0, False),
    ("h2o-danube-1.8b past window", 1, 4608, 32, 8, 80, True, 4096, False),
    ("hymba-1.5b global", 4, 2048, 25, 5, 64, True, 0, False),
    ("hymba-1.5b swa", 4, 2048, 25, 5, 64, True, 1024, False),
    ("hubert-xlarge", 4, 2048, 16, 16, 80, False, 0, False),
    ("bidirectional D80", 2, 200, 4, 2, 80, False, 0, False),
    ("smoke D32 window", 2, 40, 2, 1, 32, True, 16, False),
    ("smoke D16 MHA", 2, 72, 4, 4, 16, True, 0, False),
    ("rows that saw no key", 2, 300, 4, 2, 128, True, 64, True),
]
# The backward's gate, the same form as the forward's (ROW_REL_TOL): per
# row of dQ, dK or dV (over D), max |kernel - plain| <= 2e-2 of the row's
# largest |plain| element, plus an absolute floor of 1e-3 for rows whose
# elements are all small.  The kernel rounds P and dS to bf16 as operands
# (2**-9 relative each) and its outputs to bf16 (one step, 2**-8 of the
# row's largest element at worst); the plain backward keeps fp32 throughout.
BWD_ROW_REL_TOL = 2e-2
BWD_ABS_FLOOR = 1e-3
# The forward's LSE against torch.logsumexp of the plain fp32 scores: the
# kernel sums exp2 by the special-function unit (2 ulp) in fp32, so the
# LSE agrees to ~1e-6; 1e-3 absolute (natural log) is the gate.
LSE_TOL = 1e-3
#: the training path: gemma3-1b at full width and depth, launch.train on a
#: (4, 2048) batch from make_stream; 2 warm-up steps, then 5 timed
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# The kernels' training step against the same step with the plain
# attention in the kernels' place, at full width (both bf16 compute, the
# same fp32 weights and batch).  The bounds come from the forward's check
# (CONSISTENCY_*), where the same two paths give logits whose mean
# difference is bounded at 0.05 of the logits' std: the loss is a mean over
# the positions of lse - gold, which moves by at most twice the row's
# largest logit difference, so |delta loss| <= 2 x 0.05 x std(logits); the
# gradient norm sums ~1e9 squared elements, each carrying differences of
# the size of the activations' mean relative difference, bounded at 0.05.
TRAIN_LOSS_STD_TOL = 2 * CONSISTENCY_MEAN_REL
TRAIN_GNORM_REL_TOL = CONSISTENCY_MEAN_REL
#: steps on one repeated batch in which the loss must fall, and by how much
LEARN_STEPS = 8
LEARN_DROP = 0.95
#: their learning rate in ``train_checks``: an encoder's (hubert-xlarge,
#: 48 layers) is lower, as its loss climbs back within 8 steps at 1e-3 and
#: 3e-4 (``scripts/gate_calibration.py learning``)
LEARN_LR, ENCODER_LEARN_LR = 1e-3, 1e-4
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
#: the TPU kernel each SSD kernel replaces: the chunk states are the state
#: half of _intra_kernel; the scan holds its y half, the host scan and
#: _inter_kernel (see the source's header)
SSD_REPLACES = {"ssd_chunk_state": "src/repro/kernels/ssd_scan.py:28",
                "ssd_chunk_scan": "src/repro/kernels/ssd_scan.py:61"}
SSD_TOL = 5e-2                # bf16, the reference's SSD kernel tolerance
# The same error relative to each (batch, head)'s largest |element|: y and
# the final state are rounded to bf16 on both sides (at most one bf16 step,
# 2**-8 of an element, apart), and the kernels' products keep ~16 bits of
# the fp32 operands (hi + lo bf16 parts), so the plain version and the
# kernels should differ by ~2**-8 of the largest element; 5e-2 is 12 steps.
SSD_SLAB_REL_TOL = 5e-2
SSD_CONSISTENCY_PROMPT = 512  # two chunks of 256: the inter-chunk term runs
SSD_PLAIN_CHECK_SEQ = 2048    # eight chunks
#: the SSM paths' prefill-against-decode checks over SSD_CONSISTENCY_PROMPT
#: positions run on a cut of the model, its first SSD_CONSISTENCY_LAYERS
#: layers from a serving init of their own, the bounds at the sqrt depth
#: scaling of the other cuts (QWEN2_MOE_DEPTH_SCALE): at full depth its
#: 512 host-bound decode steps took 33-48 s (mamba2-780m) and 53-60 s
#: (hymba-1.5b) of the script's time.  hymba's 8 layers hold one hyb_g and
#: seven hyb_l layers
SSD_CONSISTENCY_LAYERS = {"mamba2-780m": 12, "hymba-1.5b": 8}
#: the SSD backward kernels replace no Pallas kernel: the reference
#: differentiates its plain SSD with XLA autodiff
SSD_BWD_REPLACES = ("XLA autodiff of repro.kernels.ssd_scan / "
                    "repro.models.ssm.ssd_chunked (src/repro/models/ssm.py:27)")
SSD_BWD_DESIGN = ("wgmma on TMA-fed tiles: the reverse state pass (dy and C, the "
                  "forward's chained hand-off run backwards) first; then a block a "
                  "(b, chunk, set of a group's heads) computes S and dS once a tile "
                  "pair, dx in bf16, dlog_a, and dB and dC summed over the set's "
                  "heads on chip (dC in an fp32 chunk accumulator in shared memory)")
#: the backward kernels against their plain versions: name, B, S, H, P, G,
#: N, chunk, with an initial state and dfinal; mamba2-780m's training
#: shape, hymba-1.5b's SSD, every other (P, N) of HEAD_STATE_DIMS
SSD_BWD_CASES = [
    ("mamba2-780m train", 4, 2048, 48, 64, 1, 128, 256, False),
    ("hymba-1.5b SSD", 4, 2048, 50, 64, 1, 16, 256, False),
    ("(64, 64), G 4", 2, 1024, 16, 64, 4, 64, 256, False),
    ("(16, 16)", 2, 1024, 8, 16, 1, 16, 256, False),
    ("initial state and dfinal", 2, 512, 48, 64, 1, 128, 256, True),
]
#: the mamba2-780m training path: launch.train at full width and depth on a
#: (4, 2048) batch, 2 warm-up and 3 timed steps
SSM_TRAIN_WARMUP, SSM_TRAIN_TIMED = 2, 3
#: the gang: gemma3-1b at full width, two members with their own lr, a
#: (2, 1024) batch each, 3 steps; each member's losses against the same
#: core run with that member alone (M = 1), at the reference's bf16 loss
#: tolerance (relative: the losses are ~12.5)
GANG_ARCH, GANG_LRS, GANG_BATCH, GANG_SEQ, GANG_STEPS = "gemma3-1b", (3e-4, 1e-3), 2, 1024, 3
GANG_LOSS_REL_TOL = 5e-3
GMM_SOURCE = "src/repro_torch/kernels/csrc/moe_gmm.cu"
GMM_REPLACES = "src/repro/kernels/moe_gmm.py:66"
# The reference's bf16 tolerance for the grouped matmul
# (tests/test_kernels.py: assert_allclose with atol 2e-2 and rtol 2e-2),
# elementwise: |kernel - plain| <= 2e-2 + 2e-2 |plain|.  Both sides round
# fp32 sums to bf16; at the model's scales (x ~ N(0, 1), w ~ N(0, 0.02^2),
# d 2048: |y| ~ 0.9, up to ~5) one bf16 step is 2**-5 = 0.031 above
# |y| = 4, which a purely absolute 2e-2 would refuse.  The error relative
# to each row's largest |y| (ROW_REL_TOL) is gated too.
GMM_TOL = 2e-2
#: the grouped GEMM's gradient kernels replace no Pallas kernel: the
#: reference differentiates jax.lax.ragged_dot with XLA
GMM_BWD_REPLACES = ("gradient of src/repro/kernels/moe_gmm.py:66; the reference "
                    "differentiates jax.lax.ragged_dot, src/repro/models/moe.py:161-163")
#: the gradient kernels' design, redesigned for Hopper after a first one
#: (the forward's structure) whose consumers waited for their operands half
#: of the time
GMM_BWD_DESIGN = ("wgmma + TMA, warp-specialised, 128 x 256 tiles, a 4-stage ring: "
                  "2-block clusters on two tiles that share their larger operand (dw: "
                  "dy_e's rows for two d-tiles; dx: w[e]'s slab for two row tiles of "
                  "one expert), each block loading half of it into both by TMA "
                  "multicast; each tile stored straight from registers")
# dw against its plain version: max |kernel - plain| within 2e-2 of each
# expert slab's largest |plain| (a slab sums up to T rows, so its elements
# reach ~sqrt(rows); the output is rounded to bf16 on both sides, 2**-8 of
# an element), and an empty expert's slab exactly zero.
GMM_DW_SLAB_TOL = 2e-2
MOE_PLAIN_CHECK_SEQ = 2048
#: qwen2-moe-a2.7b's prefill runs at its full 24 layers from the serving
#: init; its check against the plain grouped GEMM keeps a cut of 4 layers
QWEN2_MOE_LAYERS = 4
QWEN2_MOE_DEPTH_SCALE = math.sqrt(QWEN2_MOE_LAYERS / CONSISTENCY_LAYERS)
#: the olmoe-1b-7b training path: full width, cut in depth by memory; a
#: (4, 2048) batch from make_stream, 2 warm-up and 3 timed steps.  The
#: memory is reckoned as ``launch.train`` reckons it (the port's
#: ``train.step.train_memory_gb``): fp32 parameters, gradients, AdamW's
#: fp32 master copy and its two moments hold 20 bytes a parameter; AdamW's
#: update makes 5 fp32 temporaries of one leaf at a time, counted at the
#: largest (for olmoe a stacked expert weight (layers, E, d, f), for hymba
#: a stacked in_proj (layers, d, 2·d_inner + 2·G·N + H)); and a step's
#: activations take 8 GB: with full remat one layer's recompute at a time
#: (olmoe: its T·K rows through three grouped GEMMs, the fp32 combine, dw
#: in bf16 and its fp32 cast; hymba: both branches' fp32 gating and conv),
#: the residual stream at every layer and the logits with their gradient.
#: The depth is the deepest of MOE_TRAIN_DEPTHS whose reckoning fits
#: TRAIN_BUDGET_GB; a measured peak above the budget falls to the next.
MOE_TRAIN_DEPTHS = (8, 4)
TRAIN_BUDGET_GB = 72.0
MOE_TRAIN_WARMUP, MOE_TRAIN_TIMED = 2, 3
#: hymba-1.5b, after mamba2-780m's paths.  Its check past the window runs
#: a cut of the model, its first HYMBA_WINDOW_LAYERS layers (one hyb_g,
#: three hyb_l), over HYMBA_WINDOW_SEQ positions (five chunks of 256),
#: past the 1024-entry ring of the hyb_l layers: at full depth 1280
#: host-bound decode steps would cost too much time.  The cut's bounds take
#: the sqrt depth scaling, as qwen2-moe-a2.7b's cut does.
HYMBA_WINDOW_LAYERS = 4
HYMBA_WINDOW_SEQ = 1280
HYMBA_WINDOW_DEPTH_SCALE = math.sqrt(HYMBA_WINDOW_LAYERS / CONSISTENCY_LAYERS)
HYMBA_TRAIN_WARMUP, HYMBA_TRAIN_TIMED = 2, 3
#: hubert-xlarge's training path: launch.train at full width and depth on
#: (4, 2048) frame-embedding batches, 2 warm-up and 3 timed steps
HUBERT_TRAIN_WARMUP, HUBERT_TRAIN_TIMED = 2, 3
#: the smoke configs the card runs where the reference's is not one the
#: kernels take: hymba-1.5b's smoke SSD state of 8 is not a multiple of 16
#: (the SSD kernels' N), so on the card its smoke config has a state of 16
CARD_SMOKE = {"hymba-1.5b": {"ssm_state": 16}}
#: layer kinds that run the attention kernels, and the SSD kernels
ATTENTION_KINDS = ("attn", "swa", "enc", "moe", "hyb_g", "hyb_l")
SSM_KINDS = ("ssm", "hyb_g", "hyb_l")
#: host synchronisations a decode step may make besides one a layer (the
#: attention's 0-d scale): the engine's token upload and argmax read
DECODE_ENGINE_SYNCS = 4


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _START}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def host_us(fn) -> float:
    """Host time of one call of ``fn`` in µs, without a synchronisation:
    1,000 calls in rounds of 100, the host clock around each round only
    (the device drains between rounds, off the clock), so the host never
    waits on a full launch queue."""
    fn()
    total = 0.0
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / 1000 * 1e6


def ptxas_flags(log: str) -> list[str]:
    """The lines of an nvcc log that flag a kernel as slower than its
    source asks: spills to local memory, ptxas ignoring setmaxnreg (C7508)
    and wgmma serialised by the compiler ("Potential Performance Loss")."""
    flags = []
    for line in log.splitlines():
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if (spills and any(int(n) for n in spills.groups())
                or "C7508" in line or "setmaxnreg ignored" in line
                or "C7518" in line or "Potential Performance Loss" in line):
            flags.append(line.strip())
    return flags


def ptxas_kernels(log: str, match: str) -> dict[str, dict]:
    """Registers and spills of each kernel of an nvcc ``-Xptxas=-v`` log
    whose mangled name starts with ``match``, keyed by its name and integer
    template arguments (``flash_attention_bwd_kernel<256>``,
    ``ssd_chunk_scan_bwd_kernel<64, 128>``)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            fn, name = entry.group(1), None
            # Itanium mangling: the length of each name, then the name
            found = re.search(r"(\d+)(" + re.escape(match) + ")", fn)
            if found:
                # the fewest trailing digits that cover the match (a
                # namespace's digits may run into the length: _GLOBAL__N_1)
                digits = found.group(1)
                length = next(int(digits[-k:]) for k in range(1, len(digits) + 1)
                              if int(digits[-k:]) >= len(match))
                end = found.start(2) + length
                args = re.match(r"I((?:L[ib]\d+E)+)E", fn[end:])
                name = fn[found.start(2):end] + (
                    f"<{', '.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"
                    if args else "")
                out[name] = {}
            continue
        if name is None:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, spills.groups())
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[name]["registers"] = int(regs.group(1))
    return out


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` runs."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, match: str, iters: int = 10) -> float:
    """Mean device time in ms, per call of ``fn``, of the kernels whose
    names contain ``match``, from the profiler's kernel intervals: unlike
    CUDA events around a loop, it leaves out the time the card waits for
    the host between launches (a wrapper's host time can exceed a short
    kernel's device time)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name)
    return us / iters / 1e3


def kcosts():
    """The port's kernel cost formulas (``repro_torch.kernels.costs``): the
    bounds here and the dry run's counter read one formula a kernel."""
    from repro_torch.kernels import costs
    return costs


def mask_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask allows: the work a kernel call must do."""
    return kcosts().mask_pairs(s, causal, window)


def floor_ms(cost: tuple[int, int]) -> tuple[float, float]:
    """(ms for the operations, ms for the bytes) of a (FLOPs, bytes) cost
    at the card's datasheet rates."""
    return cost[0] / PEAK_BF16_FLOPS * 1e3, cost[1] / PEAK_BYTES * 1e3


def attention_floor_ms(b, s, hq, hkv, d, causal, window) -> tuple[float, float]:
    """(ms for its tensor-core operations, ms for its bytes) on the card
    (``costs.attention``)."""
    return floor_ms(kcosts().attention(b, s, hq, hkv, d, causal, window))


def ssd_floor_ms(b, s, h, p, g, n, chunk, part="function",
                 init_bytes=0) -> tuple[float, float]:
    """(ms for its operations, ms for its bytes) on the card, for the whole
    SSD scan or one kernel's own reads and writes (``costs.ssd``)."""
    return floor_ms(kcosts().ssd(b, s, h, p, g, n, chunk, part, init_bytes))


def ssd_bwd_floor_ms(b, s, h, p, g, n, chunk, part, dfinal=False, init=False,
                     slices=1) -> tuple[float, float]:
    """(ms for its operations, ms for its bytes) on the card for the SSD
    scan's whole backward or one backward kernel (``costs.ssd_bwd``)."""
    return floor_ms(kcosts().ssd_bwd(b, s, h, p, g, n, chunk, part, dfinal, init,
                                     slices))


def gmm_floor_ms(t: int, d: int, f: int, nonempty: int) -> tuple[float, float]:
    """(ms for its operations, ms for its bytes) on the card for one grouped
    matmul over ``nonempty`` experts that have rows (``costs.gmm``)."""
    return floor_ms(kcosts().gmm(t, d, f, nonempty))


def gmm_row_tiles(group_sizes: torch.Tensor) -> int:
    """Row tiles the grouped GEMM runs for these group sizes: each expert's
    rows in tiles of 128, the last one partial (against T / 128 if every
    tile were full)."""
    return int(((group_sizes.long() + 127) // 128).sum())


def gmm_dense_call(part: str, x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """One dense ``torch.matmul`` with the FLOPs of a grouped backward
    product, all rows one group: dx's (T, f)·(f, d) with expert 0's weight,
    or dw's (d, T)·(T, f).  cuBLAS's rate on this card at that size, a
    yardstick only: never used by the port."""
    if part == "dx":
        w0t = w[0].t()
        return lambda: torch.matmul(dy, w0t)
    xt = x.t()
    return lambda: torch.matmul(xt, dy)


def gmm_dw_floor_ms(t: int, d: int, f: int, experts: int) -> tuple[float, float]:
    """(ms for its operations, ms for its bytes) for one dw = x_eᵀ·dy_e over
    T rows (``costs.gmm_dw``)."""
    return floor_ms(kcosts().gmm_dw(t, d, f, experts))


def largest_leaf(cfg) -> int:
    """Elements of ``cfg``'s largest parameter leaf (the port's
    ``train.step.largest_leaf``)."""
    from repro_torch.train.step import largest_leaf as leaf
    return leaf(cfg)


def train_reckoning_gb(cfg, layers: int) -> dict[str, float]:
    """GB that training ``cfg`` cut to its first ``layers`` layers needs, as
    ``launch.train`` reckons it before it allocates (the port's
    ``train.step.train_memory_gb``): the state (20 bytes a parameter),
    AdamW's fp32 temporaries of its largest leaf, the activations, and
    their total."""
    from repro_torch.train.step import train_memory_gb
    return train_memory_gb(cut_depth(cfg, layers))


def train_depth(cfg, budget_gb: float = TRAIN_BUDGET_GB,
                depths: tuple[int, ...] = MOE_TRAIN_DEPTHS) -> int:
    """The deepest of ``depths`` whose reckoning fits ``budget_gb``."""
    for layers in depths:
        if train_reckoning_gb(cfg, layers)["total_gb"] <= budget_gb:
            return layers
    raise ValueError(f"{cfg.name}: not even {depths[-1]} layers fit {budget_gb} GB")


def card_smoke(arch: str, **overrides):
    """``arch``'s smoke config as the card runs it (CARD_SMOKE)."""
    from repro_torch.configs import get_smoke
    return get_smoke(arch, **{**CARD_SMOKE.get(arch, {}), **overrides})


def path_kernels(cfg, backward: bool) -> tuple[str, ...]:
    """The kernels a forward of ``cfg`` launches, and with ``backward``
    those of a train step: flash attention for an attention layer, the SSD
    kernels for an SSM layer (a hybrid layer has both), the grouped GEMM
    for an MoE layer."""
    kinds = set(cfg.layer_types)
    names = []
    if kinds & set(ATTENTION_KINDS):
        names += ["flash_attention"] + (["flash_attention_bwd"] if backward else [])
    if kinds & set(SSM_KINDS):
        names += ["ssd_chunk_state", "ssd_chunk_scan"] + (
            ["ssd_chunk_state_bwd", "ssd_chunk_scan_bwd"] if backward else [])
    if "moe" in kinds:
        names += ["grouped_matmul"] + (
            ["grouped_matmul_dx", "grouped_matmul_dw"] if backward else [])
    return tuple(names)


def launch_counts(names: tuple[str, ...]) -> dict[str, int]:
    """The launch counts of the kernels ``names`` since their last reset."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels import ssd_scan as kssd
    counts = {"flash_attention": fa.launches, "flash_attention_bwd": fa.bwd_launches,
              "ssd_chunk_state": kssd.state_launches,
              "ssd_chunk_scan": kssd.scan_launches,
              "ssd_chunk_state_bwd": kssd.state_bwd_launches,
              "ssd_chunk_scan_bwd": kssd.scan_bwd_launches,
              "grouped_matmul": moe_gmm.launches,
              "grouped_matmul_dx": moe_gmm.dx_launches,
              "grouped_matmul_dw": moe_gmm.dw_launches}
    return {name: counts[name] for name in names}


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels import ssd_scan as kssd
    fa.launches = fa.bwd_launches = 0
    kssd.state_launches = kssd.scan_launches = 0
    kssd.state_bwd_launches = kssd.scan_bwd_launches = 0
    moe_gmm.launches = moe_gmm.dx_launches = moe_gmm.dw_launches = 0


def attention_windows(cfg) -> list[int]:
    """The window each attention layer of ``cfg`` gives the kernel, in
    layer order: ``cfg.window`` for a windowed layer (swa, hymba's hyb_l),
    0 for a global one."""
    return [cfg.window if kind in ("swa", "hyb_l") else 0
            for kind in cfg.layer_types if kind in ATTENTION_KINDS]


def tree_bytes(params) -> int:
    """Bytes of a parameter tree's leaves."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def cut_depth(cfg, layers: int):
    """``cfg`` with its first ``layers`` layers (a cut of depth only)."""
    return dataclasses.replace(cfg, n_layers=layers,
                               layer_types=cfg.layer_types[:layers])


def active_params(cfg) -> int:
    """Parameters a token passes through: every parameter but the routed
    experts a token does not choose (top-k of E in each MoE layer; all of a
    dense config's)."""
    if not cfg.n_experts:
        return cfg.param_count()
    moe_layers = sum(kind == "moe" for kind in cfg.layer_types)
    experts = moe_layers * cfg.n_experts * 3 * cfg.d_model * cfg.moe_d_ff
    return cfg.param_count() - experts * (cfg.n_experts - cfg.top_k) // cfg.n_experts


def dw_errors(out: torch.Tensor, want: torch.Tensor,
              group_sizes: torch.Tensor) -> dict:
    """dw's error against its plain version; raises past GMM_DW_SLAB_TOL of
    an expert slab's largest |plain|, on a non-finite element, or where an
    empty expert's slab is not exactly zero."""
    o, w = out.float(), want.float()
    err = (o - w).abs().amax((1, 2))
    rel = (err / w.abs().amax((1, 2)).clamp_min(1e-30))[group_sizes > 0]
    errs = {"max_abs_err": err.max().item(),
            "max_slab_rel_err": rel.max().item() if rel.numel() else 0.0,
            "empty_experts": int((group_sizes == 0).sum()),
            "empty_slabs_exactly_zero": bool((o[group_sizes == 0] == 0).all()),
            "all_finite": bool(torch.isfinite(o).all())}
    if not (errs["all_finite"] and errs["empty_slabs_exactly_zero"]
            and errs["max_slab_rel_err"] <= GMM_DW_SLAB_TOL):
        raise AssertionError(f"grouped_matmul_dw disagrees with its plain version: "
                             f"{errs} (slab-relative {GMM_DW_SLAB_TOL})")
    return errs


def bound(ops_ms: float, bytes_ms: float) -> tuple[float, str]:
    """The least time for the work, and what sets it."""
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def row_rel_err(out: torch.Tensor, want: torch.Tensor) -> float:
    """max over (b, s, h) rows of max_d |out - want| / max_d |want|."""
    o, w = out.float(), want.float()
    return ((o - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-6)).max().item()


def slab_rel_err(out: torch.Tensor, want: torch.Tensor,
                 keep: tuple[int, ...]) -> float:
    """max over slabs of max |out - want| / max |want|, a slab being one
    index of the ``keep`` dims (for SSD outputs: one (batch, head))."""
    o, w = out.float(), want.float()
    rest = [d for d in range(o.dim()) if d not in keep]
    return ((o - w).abs().amax(rest) / w.abs().amax(rest).clamp_min(1e-6)).max().item()


def gmm_errors(out: torch.Tensor, want: torch.Tensor) -> dict:
    """The grouped GEMM's error against its plain version; raises past the
    elementwise GMM_TOL (absolute plus relative) or ROW_REL_TOL."""
    o, w = out.float(), want.float()
    err = (o - w).abs()
    out_of_tol = int((err > GMM_TOL + GMM_TOL * w.abs()).sum())
    errs = {"max_abs_err": err.max().item(),
            "max_row_rel_err": row_rel_err(out, want),
            "elements_out_of_tol": out_of_tol,
            "max_abs_y": w.abs().max().item()}
    if out_of_tol or errs["max_row_rel_err"] > ROW_REL_TOL:
        raise AssertionError(f"grouped_matmul disagrees with its plain version: "
                             f"{errs} (atol = rtol = {GMM_TOL}, row-relative "
                             f"{ROW_REL_TOL})")
    return errs


def routing_differences(got: list[torch.Tensor], want: list[torch.Tensor],
                        top_k: int) -> dict:
    """Tokens whose top-k expert set differs between two runs, layer by
    layer, from each layer's router logits (T, E) in both runs; beside the
    count, the largest gap between the k-th and the (k+1)-th logit of
    ``want`` among the tokens that differ, the median gap of all tokens,
    and how far a token's logits moved between the runs.  A set can change
    only where the gap is at most twice the token's largest move, so flips
    on near-ties show as differing gaps far below the median gap."""
    per_layer, flipped, gaps, shifts = [], [], [], []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        top = w.topk(top_k + 1, dim=-1)
        want_set = top.indices[:, :top_k].sort(-1).values
        got_set = g.topk(top_k, dim=-1).indices.sort(-1).values
        differ = (got_set != want_set).any(-1)
        gap = top.values[:, top_k - 1] - top.values[:, top_k]
        per_layer.append(int(differ.sum()))
        flipped.append(gap[differ])
        gaps.append(gap)
        shifts.append((g - w).abs().amax(-1))
    flipped_gap, gap, shift = torch.cat(flipped), torch.cat(gaps), torch.cat(shifts)
    return {"tokens": int(want[0].shape[0]), "layers": len(want),
            "differing_per_layer": per_layer, "differing": sum(per_layer),
            "max_gap_of_differing": (flipped_gap.max().item()
                                     if flipped_gap.numel() else None),
            "median_logit_gap": gap.median().item(),
            "median_logit_shift": shift.median().item(),
            "max_logit_shift": shift.max().item()}


@contextlib.contextmanager
def recorded_routing(moe_mod):
    """Records every router call of the port's MoE layers, in call order,
    as (probs, logits) pairs, each (T, E), into the list it yields."""
    calls: list[tuple[torch.Tensor, torch.Tensor]] = []
    router_probs = moe_mod.router_probs

    def record(x, w_router):
        probs, logits = router_probs(x, w_router)
        calls.append((probs.detach(), logits.detach()))
        return probs, logits

    moe_mod.router_probs = record
    try:
        yield calls
    finally:
        moe_mod.router_probs = router_probs


@contextlib.contextmanager
def replayed_routing(moe_mod, calls):
    """Makes the port's MoE layers route as a recorded run did: each router
    call returns the next recorded (probs, logits)."""
    recorded = iter(calls)
    router_probs = moe_mod.router_probs
    moe_mod.router_probs = lambda x, w_router: next(recorded)
    try:
        yield
    finally:
        moe_mod.router_probs = router_probs


@contextlib.contextmanager
def recorded_choices(moe_mod):
    """Records the top-k expert indices (T, K) of every routing call of the
    port's MoE layers, in call order, into the list it yields."""
    calls: list[torch.Tensor] = []
    route = moe_mod._route

    def record(x, w_router, top_k, router_renorm):
        out = route(x, w_router, top_k, router_renorm)
        calls.append(out[3].detach())
        return out

    moe_mod._route = record
    try:
        yield calls
    finally:
        moe_mod._route = route


@contextlib.contextmanager
def replayed_choices(moe_mod, calls):
    """Makes the port's MoE layers choose the experts a recorded run chose,
    call by call, while the router's probabilities stay this run's own and
    differentiable: the top-k weights are the probabilities gathered at
    the recorded indices (renormalised where the config says)."""
    recorded = iter(calls)
    route = moe_mod._route

    def replay(x, w_router, top_k, router_renorm):
        probs, logits = moe_mod.router_probs(x, w_router)
        top_idx = next(recorded)
        top_p = probs.gather(-1, top_idx)
        if router_renorm:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        return probs, logits, top_p, top_idx

    moe_mod._route = replay
    try:
        yield
    finally:
        moe_mod._route = route


def logits_of(calls) -> list[torch.Tensor]:
    return [logits for _, logits in calls]


def logits_agreement(got: torch.Tensor, want: torch.Tensor,
                     layers: int = CONSISTENCY_LAYERS, gate: bool = True,
                     depth_scale: float | None = None) -> dict:
    """How far two (positions, vocab) logit tables of a model of ``layers``
    layers are apart, relative to the spread of ``want``; with ``gate``,
    raises past the CONSISTENCY bounds, scaled to the depth (by
    ``layers / 26`` unless ``depth_scale`` is given)."""
    scale = layers / CONSISTENCY_LAYERS if depth_scale is None else depth_scale
    max_rel = CONSISTENCY_MAX_REL * scale
    mean_rel = CONSISTENCY_MEAN_REL * scale
    diff = (got - want).abs()
    spread = want.std().item()
    top2 = want.topk(2, dim=-1).values
    agree = want.argmax(-1) == got.argmax(-1)
    decisive = top2[:, 0] - top2[:, 1] > 2 * diff.max()
    out = {
        "max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
        "logit_std": spread, "max_rel_to_std": diff.max().item() / spread,
        "mean_rel_to_std": diff.mean().item() / spread,
        "argmax_agree": int(agree.sum()), "positions": int(agree.numel()),
        "decisive_positions": int(decisive.sum()),
        "bound_max_rel": max_rel, "bound_mean_rel": mean_rel,
    }
    out["within_bounds"] = (out["max_rel_to_std"] <= max_rel
                            and out["mean_rel_to_std"] <= mean_rel
                            and bool(agree[decisive].all()))
    if gate:
        require_agreement(out)
    return out


def require_agreement(out: dict) -> None:
    if not out["within_bounds"]:
        raise AssertionError(f"logits disagree: {out}")


def rounding_agreement(got: torch.Tensor, want: torch.Tensor,
                       moved: torch.Tensor) -> dict:
    """How far two (positions, vocab) logit tables are apart, against how
    far ``want`` moves when its model's input moves by about one bf16 step
    (``moved``): the model's own sensitivity to rounding.  Within bounds
    when the mean and the max |got - want| are no larger than the mean and
    the max |moved - want|.  For a model whose random init amplifies
    rounding past the CONSISTENCY bounds (internvl2-26b)."""
    diff, noise = (got - want).abs(), (moved - want).abs()
    out = {
        "max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
        "bound_max_abs": noise.max().item(), "bound_mean_abs": noise.mean().item(),
        "logit_std": want.std().item(),
        "argmax_agree": int((want.argmax(-1) == got.argmax(-1)).sum()),
        "moved_argmax_agree": int((want.argmax(-1) == moved.argmax(-1)).sum()),
        "positions": want.shape[0],
    }
    out["within_bounds"] = (out["max_abs"] <= out["bound_max_abs"]
                            and out["mean_abs"] <= out["bound_mean_abs"])
    return out


def forward_vs_plain_gmm(model, params, toks, layers: int, top_k: int,
                         depth_scale: float | None = None) -> dict:
    """The kernels' forward against the same forward with the grouped GEMM's
    plain version in the kernel's place, twice: routing freely (a near-tie
    may then route another way: ``free``) and replaying the kernel run's
    routing, so that only the rounding differs (``same_routing``); and the
    routing differences of the free run.  Gates nothing: the caller emits,
    then gates."""
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import moe
    kernel = moe_gmm.grouped_matmul
    with torch.inference_mode():
        with recorded_routing(moe) as got_routes:
            got = model.forward(params, toks)[0].float()
        moe_gmm.grouped_matmul = moe_gmm.grouped_matmul_plain
        try:
            with recorded_routing(moe) as free_routes:
                free = model.forward(params, toks)[0].float()
            with replayed_routing(moe, got_routes):
                same = model.forward(params, toks)[0].float()
        finally:
            moe_gmm.grouped_matmul = kernel
    return {
        "routing": routing_differences(logits_of(got_routes),
                                       logits_of(free_routes), top_k),
        "free": logits_agreement(got, free, layers, False, depth_scale),
        "same_routing": logits_agreement(got, same, layers, False, depth_scale),
    }


def kernel_class(name: str) -> str:
    """A coarse class of a device event in a profile, by its name."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if "flash_attention_bwd" in low:
        return "flash_attention_bwd"
    if "flash_attention" in low:
        return "flash_attention"
    if "ssd_chunk" in low and "bwd" in low:
        return "ssd_scan_bwd"
    if "ssd_chunk" in low:
        return "ssd_scan"
    if "grouped_matmul_dw" in low or "grouped_matmul_dx" in low:
        return "grouped_matmul_bwd"
    if "grouped_matmul" in low:
        return "grouped_matmul"
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "reduce" in low or "softmax" in low or "argmax" in low:
        return "reduce"
    return "elementwise"


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


#: the profiler's device-side span around each NCCL collective
#: ("nccl:all_reduce"), as long as the collective's own kernel: counted once,
#: by the kernel
NCCL_ANNOTATION = "nccl:"


def nccl_device_ms(prof) -> float:
    """Device ms of the NCCL kernels in a profile (their spans not counted
    again)."""
    return sum((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel_class(e.name) == "nccl"
               and not e.name.startswith(NCCL_ANNOTATION))


def summarize(prof, wall_s: float, steps: int) -> dict:
    """One profiled window: host wall time (ending in a synchronise), the
    device's busy time (union of its kernel and copy intervals) and idle
    share, kernel launches and host synchronisations, device time by
    kernel class and by kernel name, and the host's own time by operator;
    ``summary_s``, the seconds this reading of the trace took."""
    t0 = time.perf_counter()
    device, launches, syncs = [], 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(NCCL_ANNOTATION):   # its kernel is counted
                device.append(e)
        elif e.name in LAUNCH_CALLS:
            launches += 1
        elif e.name in SYNC_CALLS:
            syncs += 1
    busy_ms = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    by_class: dict[str, float] = collections.Counter()
    by_name: dict[str, float] = collections.Counter()
    for e in device:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_class[kernel_class(e.name)] += ms
        by_name[e.name[:80]] += ms
    host_ms: dict[str, float] = collections.Counter()
    for avg in prof.key_averages():
        host_ms[avg.key[:60]] += avg.self_cpu_time_total / 1e3
    wall_ms = wall_s * 1e3
    return {
        "steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if device else None,
        "device_events": len(device), "kernel_launches": launches,
        "host_syncs": syncs,
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda x: -x[1])),
        "top_kernels_ms": dict(by_name.most_common(12)),
        "top_host_ops_ms": dict(host_ms.most_common(12)),
        "summary_s": time.perf_counter() - t0,
    }


def profiled(fn, steps: int) -> dict:
    """``summarize`` of ``steps`` calls of ``fn`` under the profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize(prof, wall, steps)


def sdpa_inputs(q, k, v, causal, window):
    """q, K and V expanded to every query head, in SDPA's (B, H, S, D)
    layout, and the keyword arguments of the mask."""
    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2)
    if window <= 0:
        return qt, kt, vt, {"is_causal": causal}
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(q.shape[1], device=q.device)[None, :]
    return qt, kt, vt, {"attn_mask": (i - j < window) & ((i >= j) if causal else True)}


def sdpa_call(q, k, v, causal, window):
    """One PyTorch call for the same attention (K, V expanded beforehand);
    a yardstick for the kernel only, never used by the port."""
    qt, kt, vt, mask = sdpa_inputs(q, k, v, causal, window)
    return lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, **mask)


def sdpa_grad_call(q, k, v, do, causal, window):
    """One PyTorch call for the same backward: ``torch.autograd.grad``
    through ``sdpa_call``'s attention (K, V expanded beforehand, so its dK
    and dV are per query head, not summed over the group); a yardstick for
    the backward kernel only, never used by the port."""
    *leaves, mask = sdpa_inputs(q, k, v, causal, window)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, **mask)
    return lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                       retain_graph=True)


def attention_bwd_floor_ms(b, s, hq, hkv, d, causal, window) -> tuple[float, float]:
    """(ms for its tensor-core operations, ms for its bytes) of the attention
    backward (``costs.attention_bwd``)."""
    return floor_ms(kcosts().attention_bwd(b, s, hq, hkv, d, causal, window))


def grad_row_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max over rows of the error less the row's allowed
    BWD_ROW_REL_TOL · max |want row| + BWD_ABS_FLOOR): the second <= 0
    passes."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    return (err.max().item(),
            (err - BWD_ROW_REL_TOL * w.abs().amax(-1) - BWD_ABS_FLOOR).max().item())


def serve_requests(cfg, params, dev, rng):
    """Phase 6's workload: ``ServeEngine`` on 4 slots (``max_len`` 1024)
    answers 8 requests of 16 new tokens, prompts of 2-5 tokens drawn from
    ``rng``.  Returns the engine, the tokens generated and the seconds."""
    from repro_torch.serve.engine import Request, ServeEngine
    engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
    for rid in range(8):
        prompt_ids = rng.integers(0, cfg.vocab_size, rng.integers(2, 6)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt_ids, max_new=16))
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if len(done) != 8 or any(len(r.generated) != 16 for r in done):
        raise AssertionError(f"served {len(done)} requests: "
                             f"{[len(r.generated) for r in done]}")
    return engine, sum(len(r.generated) for r in done), serve_s


def gemma3_path(dev, card) -> dict:
    """Phases 3-7 for gemma3-1b; returns its kernel's entry of the kernels
    line."""
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model, synthetic_batch
    from repro_torch.serve.engine import Request, ServeEngine

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def qkv(b, s, hq, hkv, d):
        return [torch.randn((b, s, h, d), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
                for h in (hq, hkv, hkv)]

    max_err = 0.0
    for name, b, s, hq, hkv, d, causal, window in FA_CASES:
        q, k, v = qkv(b, s, hq, hkv, d)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        if not (err <= KERNEL_TOL and rel <= ROW_REL_TOL):
            raise AssertionError(f"flash_attention {name}: max |err| {err} "
                                 f"(tol {KERNEL_TOL}), row-relative {rel} "
                                 f"(tol {ROW_REL_TOL})")
        max_err = max(max_err, err)
        bound_ms, bound_by = bound(*attention_floor_ms(b, s, hq, hkv, d,
                                                       causal, window))
        emit("kernel_check", kernel="flash_attention", case=name,
             shape=[b, s, hq, hkv, d], causal=causal, window=window,
             max_abs_err=err, tol=KERNEL_TOL, max_row_rel_err=rel,
             row_rel_tol=ROW_REL_TOL,
             ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                   window=window), 20),
             plain_ms=time_ms(lambda: fa.flash_attention_plain(
                 q, k, v, causal=causal, window=window), 3, 1),
             library_ms=time_ms(sdpa_call(q, k, v, causal, window), 20),
             bound_ms=bound_ms, bound_by=bound_by, nvidia_smi=card)
        del q, k, v, out, want

    # the work of one gemma3-1b prefill: one call per layer, at its window
    cfg = get("gemma3-1b")
    b, s = 4, 2048
    prefill_attn = fa_prefill_mix(cfg, gen, dev, b, s)
    emit("kernel_prefill_mix", kernel="flash_attention", arch=cfg.name,
         layers=cfg.n_layers, shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         nvidia_smi=card, **prefill_attn)

    # -- 4. prefill: the main path, at full width -----------------------------
    model = Model(cfg, dev)
    params = model.init(seed=0, serving=True)   # bf16 serving tree
    batch = synthetic_batch(cfg, b, s, gen, dev)
    prefill_launches = checked_forward(model, params, batch,
                                       {"flash_attention": cfg.n_layers},
                                       (b, s, cfg.vocab_size))["flash_attention"]
    prefill_s, times = timed_forward(model, params, batch)
    emit("prefill", arch=cfg.name, batch=b, seq=s, launches=prefill_launches,
         seconds=prefill_s, tokens_per_s=b * s / prefill_s, runs=times,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=card)

    # -- 5. correctness ---------------------------------------------------------
    # (a) prefill (kernel) against teacher-forced decode (plain attention),
    # over a prompt of several key tiles
    prompt = synthetic_batch(cfg, 1, CONSISTENCY_PROMPT, gen, dev)["tokens"]
    fwd, dec, _ = prefill_and_decode(model, params, prompt)
    emit("prefill_decode_consistency", arch=cfg.name, prompt=CONSISTENCY_PROMPT,
         **logits_agreement(dec, fwd))
    del fwd, dec

    # (a2) the kernel's forward against the same forward with the plain
    # attention in the kernel's place, past the window
    toks = synthetic_batch(cfg, 1, WINDOW_CHECK_SEQ, gen, dev)
    kernel = fa.flash_attention
    with torch.inference_mode():
        got = model.forward(params, toks)[0].float()
        fa.flash_attention = fa.flash_attention_plain
        try:
            want = model.forward(params, toks)[0].float()
        finally:
            fa.flash_attention = kernel
    emit("forward_vs_plain_attention", arch=cfg.name, seq=WINDOW_CHECK_SEQ,
         window=cfg.window, **logits_agreement(got, want))
    del got, want

    # (b) the card's forward (kernel) against the CPU's (plain path)
    card_vs_cpu("gemma3-1b", dev, 40)

    # -- 6. serve -----------------------------------------------------------------
    fa.launches = 0
    rng = np.random.default_rng(0)
    engine, n_tok, serve_s = serve_requests(cfg, params, dev, rng)
    serve_launches = fa.launches
    emit("serve", arch=cfg.name, requests=8, slots=4, max_len=1024,
         new_tokens=n_tok, final_pos=engine.cache["pos"], seconds=serve_s,
         decode_tokens_per_s=n_tok / serve_s,
         steps_per_s=engine.cache["pos"] / serve_s,
         flash_attention_launches=serve_launches, nvidia_smi=card)

    # -- 7. profile: where the time goes ------------------------------------------
    with torch.inference_mode():
        prof = profiled(lambda: model.forward(params, batch), 1)
    emit("profile_prefill", arch=cfg.name, batch=b, seq=s, nvidia_smi=card, **prof)
    engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
    for rid in range(4):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 4).tolist(), max_new=PROFILE_DECODE_STEPS + 8))
    for _ in range(4):                                      # warm-up
        engine.step()
    prof = profiled(engine.step, PROFILE_DECODE_STEPS)
    emit("profile_decode", arch=cfg.name, slots=4, max_len=1024, nvidia_smi=card,
         per_step={k: prof[k] / PROFILE_DECODE_STEPS for k in (
             "wall_ms", "device_busy_ms", "kernel_launches", "host_syncs")},
         **prof)

    return {
        "name": "flash_attention", "path": "gemma3-1b prefill", "route": "cuda",
        "source": FA_SOURCE, "replaces": FA_REPLACES, "launches": prefill_launches,
        **prefill_attn, "max_abs_err": max(max_err, prefill_attn["max_abs_err"]),
    }


def ssd_inputs(gen, dev, b, s, h, p, g, n, init):
    """x, log_a, B, C (and an initial state) at SSD scales like the
    reference's kernel tests: |x| ~ 0.5, log_a = -0.3 softplus(N(0, 1))."""
    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale
    x = normal(b, s, h, p, scale=0.5).to(torch.bfloat16)
    log_a = -torch.nn.functional.softplus(normal(b, s, h, scale=1.0)) * 0.3
    bm = normal(b, s, g, n, scale=0.3).to(torch.bfloat16)
    cm = normal(b, s, g, n, scale=0.3).to(torch.bfloat16)
    h0 = normal(b, h, p, n, scale=0.2) if init else None
    return x, log_a, bm, cm, h0


def fa_prefill_mix(cfg, gen, dev, b: int, s: int) -> dict:
    """The flash-attention calls of one prefill of ``cfg`` on (b, s) tokens,
    one a layer at its window (bidirectional for an encoder), timed
    together by CUDA events: the kernel's, the plain version's and SDPA's
    ms and the bound of the same work; and the kernel's largest |error|
    against the plain version over the windows."""
    from repro_torch.kernels import flash_attention as fa
    windows, causal = attention_windows(cfg), cfg.causal
    q, k, v = (torch.randn((b, s, h, cfg.head_dim), generator=gen, device=dev
                           ).to(torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    err = max((fa.flash_attention(q, k, v, causal=causal, window=w).float()
               - fa.flash_attention_plain(q, k, v, causal=causal, window=w).float()
               ).abs().max().item()
              for w in set(windows))
    lib_calls = [sdpa_call(q, k, v, causal, w) for w in windows]
    floors = [attention_floor_ms(b, s, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, causal, w) for w in windows]
    mix_bound_ms, mix_bound_by = bound(sum(f[0] for f in floors),
                                       sum(f[1] for f in floors))
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: [fa.flash_attention(q, k, v, causal=causal, window=w)
                               for w in windows], 10),
        "plain_ms": time_ms(lambda: [fa.flash_attention_plain(q, k, v, causal=causal,
                                                              window=w)
                                     for w in windows], 2, 1),
        "library_ms": time_ms(lambda: [c() for c in lib_calls], 10),
        "bound_ms": mix_bound_ms, "bound_by": mix_bound_by,
    }


def fa_train_mix(cfg, gen, dev, b: int, s: int) -> dict:
    """The flash-attention backward calls of one train step of ``cfg`` on
    (b, s) tokens, one a layer at its window (bidirectional for an
    encoder), timed together: the kernel's, the plain backward's and
    ``torch.autograd.grad`` through SDPA's ms and the bound; and the
    kernel's largest |error| (dQ, dK, dV) against the plain backward over
    the windows."""
    from repro_torch.kernels import flash_attention as fa
    windows, causal = attention_windows(cfg), cfg.causal

    def normal(h):
        return torch.randn((b, s, h, cfg.head_dim), generator=gen, device=dev
                           ).to(torch.bfloat16)

    q, k, v, do = (normal(h) for h in (cfg.n_heads, cfg.n_kv_heads,
                                        cfg.n_kv_heads, cfg.n_heads))
    saved = {w: fa.flash_attention_with_lse(q, k, v, causal=causal, window=w)
             for w in set(windows)}
    err = max((a.float() - w.float()).abs().max().item()
              for win in saved
              for a, w in zip(fa.flash_attention_bwd(q, k, v, *saved[win], do,
                                                     causal=causal, window=win),
                              fa.flash_attention_bwd_plain(q, k, v, *saved[win], do,
                                                           causal=causal, window=win)))
    lib_calls = [sdpa_grad_call(q, k, v, do, causal, w) for w in windows]
    floors = [attention_bwd_floor_ms(b, s, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim, causal, w) for w in windows]
    mix_bound_ms, mix_bound_by = bound(sum(f[0] for f in floors),
                                       sum(f[1] for f in floors))
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: [fa.flash_attention_bwd(q, k, v, *saved[w], do,
                                                      causal=causal, window=w)
                               for w in windows], 5),
        "plain_ms": time_ms(lambda: [fa.flash_attention_bwd_plain(
            q, k, v, *saved[w], do, causal=causal, window=w) for w in windows], 1, 1),
        "library_ms": time_ms(lambda: [c() for c in lib_calls], 5),
        "bound_ms": mix_bound_ms, "bound_by": mix_bound_by,
    }


def ssd_prefill_mix(cfg, gen, dev, b: int, s: int) -> dict[str, dict]:
    """The SSD scans of one prefill of ``cfg`` on (b, s) tokens, one a layer
    with SSM heads, timed together by CUDA events for each kernel and for
    the whole scan (``function``): the kernels' ms and their own device ms
    (the profiler's), the plain versions' and the bound; and each kernel's
    largest |error| against its plain version (the scan on the state
    kernel's passed states)."""
    from repro_torch.kernels import ssd_scan as kssd
    h, p, g, n, chunk = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                         cfg.ssm_state, cfg.ssm_chunk)
    x, la, bm, cm, _ = ssd_inputs(gen, dev, b, s, h, p, g, n, False)
    prev, _ = kssd.chunk_state(x, la, bm, chunk=chunk)
    want_prev, _ = kssd.chunk_state_plain(x, la, bm, chunk)
    y = kssd.chunk_scan(x, la, bm, cm, prev, chunk=chunk)
    want_y = kssd.chunk_scan_plain(x, la, bm, cm, prev, chunk)
    errs = {"chunk_state": (prev - want_prev).abs().max().item(),
            "chunk_scan": (y.float() - want_y.float()).abs().max().item()}
    errs["function"] = max(errs.values())
    del want_prev, y, want_y
    layers = range(sum(kind in SSM_KINDS for kind in cfg.layer_types))
    mix = {}
    for part, kernel, plain in (
            ("chunk_state", lambda: kssd.chunk_state(x, la, bm, chunk=chunk),
             lambda: kssd.chunk_state_plain(x, la, bm, chunk)),
            ("chunk_scan", lambda: kssd.chunk_scan(x, la, bm, cm, prev, chunk=chunk),
             lambda: kssd.chunk_scan_plain(x, la, bm, cm, prev, chunk)),
            ("function", lambda: kssd.ssd_scan(x, la, bm, cm, chunk=chunk),
             lambda: kssd.ssd_scan_plain(x, la, bm, cm, chunk=chunk))):
        ops_ms, bytes_ms = ssd_floor_ms(b, s, h, p, g, n, chunk, part)
        mix_bound_ms, mix_bound_by = bound(len(layers) * ops_ms, len(layers) * bytes_ms)
        mix[part] = {
            "max_abs_err": errs[part],
            "ms": time_ms(lambda: [kernel() for _ in layers], 10),
            # the kernels' own device time: the wrappers' host time a call
            # (~60-100 us) can exceed ssd_chunk_state's, and then ``ms``
            # counts the card waiting for the host
            "kernel_ms": kernel_ms(lambda: [kernel() for _ in layers],
                                   "ssd_" + part if part != "function" else "ssd_chunk", 3),
            "plain_ms": time_ms(lambda: [plain() for _ in layers], 2, 1),
            "bound_ms": mix_bound_ms, "bound_by": mix_bound_by,
            "library_ms": None,
        }
    return mix


def ssd_train_mix(cfg, gen, dev, b: int, s: int) -> dict[str, dict]:
    """The SSD backward of one train step of ``cfg`` on (b, s) tokens, one
    a layer with SSM heads, timed together for each backward kernel and for
    the whole backward (both kernels and the glue, as ``SSDScan`` runs it,
    against the function's bound): the kernels' ms, the plain versions' and
    the bounds; and each kernel's largest |error| against its plain version
    (the scan's dB and dC slices added)."""
    from repro_torch.kernels import ssd_scan as kssd
    h, p, g, n, chunk = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                         cfg.ssm_state, cfg.ssm_chunk)
    x, la, bm, cm, _ = ssd_inputs(gen, dev, b, s, h, p, g, n, False)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
    prev, _ = kssd.chunk_state(x, la, bm, chunk=chunk)
    state = kssd.chunk_state_bwd(dy, la, cm, prev, chunk=chunk)
    gnext, _, d_total = state
    scan = kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy, gnext, d_total, chunk=chunk)
    want_state = kssd.chunk_state_bwd_plain(dy, la, cm, prev, chunk)
    want_scan = kssd.chunk_scan_bwd_plain(x, la, bm, cm, prev, dy, gnext, d_total, chunk)

    def summed(out):   # the scan backward's dB and dC slices added
        return out[0], out[1], out[2].sum(3), out[3].sum(3)

    errs = {"chunk_state_bwd": max((a.float() - w.float()).abs().max().item()
                                   for a, w in zip(state, want_state)),
            "chunk_scan_bwd": max((a.float() - w.float()).abs().max().item()
                                  for a, w in zip(summed(scan), summed(want_scan)))}
    errs["function"] = max(errs.values())
    del state, scan, want_state, want_scan
    slices = h // kssd.bwd_heads_per_block(h, g) // g
    layers = range(sum(kind in SSM_KINDS for kind in cfg.layer_types))
    mix = {}
    for part, kernel, plain in (
            ("chunk_scan_bwd",
             lambda: kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy, gnext, d_total,
                                         chunk=chunk),
             lambda: kssd.chunk_scan_bwd_plain(x, la, bm, cm, prev, dy, gnext,
                                               d_total, chunk)),
            ("chunk_state_bwd",
             lambda: kssd.chunk_state_bwd(dy, la, cm, prev, chunk=chunk),
             lambda: kssd.chunk_state_bwd_plain(dy, la, cm, prev, chunk)),
            ("function",
             lambda: kssd.ssd_scan_bwd(x, la, bm, cm, prev, dy, chunk=chunk),
             lambda: kssd.ssd_scan_bwd_plain(x, la, bm, cm, prev, dy, chunk))):
        ops_ms, bytes_ms = ssd_bwd_floor_ms(b, s, h, p, g, n, chunk, part,
                                            slices=slices)
        mix_bound_ms, mix_bound_by = bound(len(layers) * ops_ms, len(layers) * bytes_ms)
        mix[part] = {
            "max_abs_err": errs[part],
            "ms": time_ms(lambda: [kernel() for _ in layers], 3, 1),
            "plain_ms": time_ms(lambda: [plain() for _ in layers], 1, 1),
            "bound_ms": mix_bound_ms, "bound_by": mix_bound_by, "library_ms": None,
        }
    return mix


def mamba2_path(dev, card) -> list[dict]:
    """Phases 3-7 for mamba2-780m; returns its two kernels' entries of the
    kernels line."""
    from repro_torch.configs import get, get_smoke
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.models import Model, compute_copy, synthetic_batch
    from repro_torch.serve.engine import Request, ServeEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cfg = get("mamba2-780m")
    h, p, g, n, chunk = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                         cfg.ssm_state, cfg.ssm_chunk)

    # -- 3. the SSD kernels against their plain versions ---------------------
    cases = [  # name, B, S, H, P, G, N, chunk, initial state
        ("mamba2-780m prefill", 4, 2048, h, p, g, n, chunk, False),
        ("hymba-1.5b SSD", 4, 2048, 50, 64, 1, 16, 256, False),
        ("G 4, N 64", 2, 1024, 16, 64, 4, 64, 256, False),
        ("S 100 < chunk", 4, 100, h, p, g, n, chunk, False),
        ("initial state", 2, 512, h, p, g, n, chunk, True),
        # Q not a multiple of 64 over several chunks: partial row tiles
        ("S 480, chunk 96", 2, 480, h, p, g, n, 96, True),
        # the hand-off under stress: 96 chains of 256 chunks, 24,576 blocks
        ("hand-off, 256 chunks", 2, 16384, h, p, g, n, 64, False),
    ]
    max_err = {"ssd_chunk_state": 0.0, "ssd_chunk_scan": 0.0}
    for name, b, s, hh, pp, gg, nn, ch, init in cases:
        x, la, bm, cm, h0 = ssd_inputs(gen, dev, b, s, hh, pp, gg, nn, init)
        q = min(ch, s)
        prev, final = kssd.chunk_state(x, la, bm, chunk=ch, initial_state=h0)
        y = kssd.chunk_scan(x, la, bm, cm, prev, chunk=ch)
        torch.cuda.synchronize()
        want_prev, _ = kssd.chunk_state_plain(x, la, bm, q, h0)
        want_y, want_final = kssd.ssd_scan_plain(x, la, bm, cm, chunk=ch,
                                                 initial_state=h0)
        errs = {   # max |err|, and relative to each (batch, head)'s max |want|
            "prev": ((prev - want_prev).abs().max().item(),
                     slab_rel_err(prev, want_prev, keep=(0, 1))),
            "y": ((y.float() - want_y.float()).abs().max().item(),
                  slab_rel_err(y, want_y, keep=(0, 2))),
            "final": ((final.float() - want_final.float()).abs().max().item(),
                      slab_rel_err(final, want_final, keep=(0, 1))),
        }
        for what, (err, rel) in errs.items():
            if not (err <= SSD_TOL and rel <= SSD_SLAB_REL_TOL):
                raise AssertionError(f"ssd {name} {what}: max |err| {err} (tol "
                                     f"{SSD_TOL}), per (b, h) {rel} (tol "
                                     f"{SSD_SLAB_REL_TOL})")
        max_err["ssd_chunk_state"] = max(max_err["ssd_chunk_state"], errs["prev"][0],
                                         errs["final"][0])
        max_err["ssd_chunk_scan"] = max(max_err["ssd_chunk_scan"], errs["y"][0])
        init_bytes = 4 if init else 0
        bounds = {part: bound(*ssd_floor_ms(b, s, hh, pp, gg, nn, ch, part, init_bytes))
                  for part in ("chunk_state", "chunk_scan", "function")}
        emit("kernel_check", kernel="ssd_scan", case=name,
             shape=[b, s, hh, pp, gg, nn, q], initial_state=init,
             errors={k: {"max_abs_err": e, "max_bh_rel_err": r}
                     for k, (e, r) in errs.items()},
             tol=SSD_TOL, bh_rel_tol=SSD_SLAB_REL_TOL,
             chunk_state_ms=time_ms(lambda: kssd.chunk_state(
                 x, la, bm, chunk=ch, initial_state=h0), 20),
             chunk_scan_ms=time_ms(lambda: kssd.chunk_scan(
                 x, la, bm, cm, prev, chunk=ch), 20),
             ms=time_ms(lambda: kssd.ssd_scan(x, la, bm, cm, chunk=ch,
                                              initial_state=h0), 20),
             chunk_state_plain_ms=time_ms(lambda: kssd.chunk_state_plain(
                 x, la, bm, q, h0), 3, 1),
             chunk_scan_plain_ms=time_ms(lambda: kssd.chunk_scan_plain(
                 x, la, bm, cm, prev, q), 3, 1),
             plain_ms=time_ms(lambda: kssd.ssd_scan_plain(
                 x, la, bm, cm, chunk=ch, initial_state=h0), 3, 1),
             chunk_state_bound_ms=bounds["chunk_state"][0],
             chunk_state_bound_by=bounds["chunk_state"][1],
             chunk_scan_bound_ms=bounds["chunk_scan"][0],
             chunk_scan_bound_by=bounds["chunk_scan"][1],
             bound_ms=bounds["function"][0], bound_by=bounds["function"][1],
             library_ms=None, nvidia_smi=card)
        del x, la, bm, cm, h0, prev, y, final, want_prev, want_y, want_final

    # the SSD work of one mamba2-780m prefill: one scan per layer
    b, s = 4, 2048
    mix = ssd_prefill_mix(cfg, gen, dev, b, s)
    emit("kernel_prefill_mix", kernel="ssd_scan", arch=cfg.name, layers=cfg.n_layers,
         shape=[b, s, h, p, g, n, chunk], nvidia_smi=card, **mix)

    # -- 4. prefill: the main path, at full width -----------------------------
    model = Model(cfg, dev)
    params = model.init(seed=0, serving=True)   # bf16 serving tree
    batch = synthetic_batch(cfg, b, s, gen, dev)
    torch.cuda.reset_peak_memory_stats()
    launches = checked_forward(
        model, params, batch, {"ssd_chunk_state": cfg.n_layers,
                               "ssd_chunk_scan": cfg.n_layers, "flash_attention": 0},
        (b, s, cfg.vocab_size))
    prefill_s, times = timed_forward(model, params, batch)
    emit("prefill", arch=cfg.name, batch=b, seq=s, launches=launches,
         seconds=prefill_s, tokens_per_s=b * s / prefill_s, runs=times,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=card)

    # -- 5. correctness ---------------------------------------------------------
    # (a) prefill (kernels) against teacher-forced decode (ssd_step), over
    # two chunks, so the inter-chunk path runs; on the first
    # SSD_CONSISTENCY_LAYERS layers
    layers = SSD_CONSISTENCY_LAYERS[cfg.name]
    cut = cut_depth(cfg, layers)
    cut_model = Model(cut, dev)
    cut_params = cut_model.init(seed=1, serving=True)
    prompt = synthetic_batch(cfg, 1, SSD_CONSISTENCY_PROMPT, gen, dev)["tokens"]
    fwd, dec, _ = prefill_and_decode(cut_model, cut_params, prompt)
    scale = math.sqrt(layers / CONSISTENCY_LAYERS)
    emit("prefill_decode_consistency", arch=cfg.name, prompt=SSD_CONSISTENCY_PROMPT,
         chunks=SSD_CONSISTENCY_PROMPT // chunk, layers=f"{layers} of {cfg.n_layers}",
         depth_scale=scale, **logits_agreement(dec, fwd, layers, depth_scale=scale))
    # how far each of the two bf16 paths is from the fp32 logits of the same
    # weights (the kernels' plain version computing in fp32): a rounding
    # difference leaves them about equally far, a fault in the kernels
    # leaves the prefill farther
    ref_cfg = dataclasses.replace(cut, compute_dtype="float32")
    ref_params = compute_copy(ref_cfg, cut_params)
    kernel = kssd.ssd_scan
    with torch.inference_mode():
        kssd.ssd_scan = kssd.ssd_scan_plain
        try:
            ref = Model(ref_cfg, dev).forward(ref_params, {"tokens": prompt})[0].float()
        finally:
            kssd.ssd_scan = kernel
    spread = ref.std().item()
    emit("distance_from_fp32", arch=cfg.name, prompt=SSD_CONSISTENCY_PROMPT,
         layers=f"{layers} of {cfg.n_layers}",
         **{f"{name}_max_rel_to_std": (out - ref).abs().max().item() / spread
            for name, out in (("prefill", fwd), ("decode", dec))},
         **{f"{name}_mean_rel_to_std": (out - ref).abs().mean().item() / spread
            for name, out in (("prefill", fwd), ("decode", dec))})
    del fwd, dec, ref, ref_params, cut_model, cut_params

    # (a2) the kernels' forward against the same forward with the plain
    # version in their place, over 8 chunks
    toks = synthetic_batch(cfg, 1, SSD_PLAIN_CHECK_SEQ, gen, dev)
    with torch.inference_mode():
        got = model.forward(params, toks)[0].float()
        kssd.ssd_scan = kssd.ssd_scan_plain
        try:
            want_logits = model.forward(params, toks)[0].float()
        finally:
            kssd.ssd_scan = kernel
    emit("forward_vs_plain_ssd", arch=cfg.name, seq=SSD_PLAIN_CHECK_SEQ,
         chunks=SSD_PLAIN_CHECK_SEQ // chunk,
         **logits_agreement(got, want_logits, cfg.n_layers))
    del got, want_logits

    # (b) the card's forward (kernels) against the CPU's (their plain version)
    card_vs_cpu("mamba2-780m", dev, 3 * get_smoke("mamba2-780m").ssm_chunk,
                use_kernels=True)

    # -- 6. serve -----------------------------------------------------------------
    rng = np.random.default_rng(0)
    engine, n_tok, serve_s = serve_requests(cfg, params, dev, rng)
    emit("serve", arch=cfg.name, requests=8, slots=4, new_tokens=n_tok,
         final_pos=engine.cache["pos"], seconds=serve_s,
         decode_tokens_per_s=n_tok / serve_s,
         steps_per_s=engine.cache["pos"] / serve_s, nvidia_smi=card)

    # -- 7. profile: where the time goes ------------------------------------------
    with torch.inference_mode():
        prof = profiled(lambda: model.forward(params, batch), 1)
    emit("profile_prefill", arch=cfg.name, batch=b, seq=s, nvidia_smi=card, **prof)
    engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
    for rid in range(4):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 4).tolist(), max_new=PROFILE_DECODE_STEPS + 8))
    for _ in range(4):                                      # warm-up
        engine.step()
    prof = profiled(engine.step, PROFILE_DECODE_STEPS)
    emit("profile_decode", arch=cfg.name, slots=4, nvidia_smi=card,
         per_step={k: prof[k] / PROFILE_DECODE_STEPS for k in (
             "wall_ms", "device_busy_ms", "kernel_launches", "host_syncs")},
         **prof)

    return [{"name": name, "path": "mamba2-780m prefill", "route": "cuda",
             "source": SSD_SOURCE, "replaces": SSD_REPLACES[name],
             "launches": launches[name], **mix[part],
             "max_abs_err": max(max_err[name], mix[part]["max_abs_err"])}
            for name, part in (("ssd_chunk_state", "chunk_state"),
                               ("ssd_chunk_scan", "chunk_scan"))]


def prefill_and_decode(model, params, prompt: torch.Tensor):
    """The logits of a (1, S) prompt by one forward and by S teacher-forced
    decode steps into a cache of S positions: (forward (S, V), decode
    (S, V), the cache after the last step), fp32."""
    with torch.inference_mode():
        fwd = model.forward(params, {"tokens": prompt})[0].float()
        cache = model.init_cache(1, prompt.shape[1])
        dec = []
        for t in range(prompt.shape[1]):
            lg, cache = model.decode_step(params, cache, prompt[:, t:t + 1])
            dec.append(lg[0].float())
    return fwd, torch.stack(dec), cache


@contextlib.contextmanager
def plain_kernels():
    """flash attention and the SSD scan replaced by their plain versions
    (differentiable by autograd) where the model calls them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as kssd
    kernels = fa.flash_attention, kssd.ssd_scan
    fa.flash_attention, kssd.ssd_scan = fa.flash_attention_plain, kssd.ssd_scan_plain
    try:
        yield
    finally:
        fa.flash_attention, kssd.ssd_scan = kernels


def step_launches(cfg, steps: int = 1) -> dict[str, int]:
    """Kernel launches of ``steps`` train steps of ``cfg`` under full remat:
    each layer's forward kernels twice (the forward and the recompute), its
    backward kernels once; an MoE layer's three grouped GEMMs each with a
    dx and a dw."""
    attn = sum(kind in ATTENTION_KINDS for kind in cfg.layer_types) * steps
    ssm = sum(kind in SSM_KINDS for kind in cfg.layer_types) * steps
    moe = sum(kind == "moe" for kind in cfg.layer_types) * steps
    out = {}
    if attn:
        out.update(flash_attention=2 * attn, flash_attention_bwd=attn)
    if ssm:
        out.update(ssd_chunk_state=2 * ssm, ssd_chunk_scan=2 * ssm,
                   ssd_chunk_state_bwd=ssm, ssd_chunk_scan_bwd=ssm)
    if moe:
        out.update(grouped_matmul=6 * moe, grouped_matmul_dx=3 * moe,
                   grouped_matmul_dw=3 * moe)
    return out


def model_inputs(batch: dict) -> dict:
    """A batch's model inputs: every key but the labels."""
    return {k: v for k, v in batch.items() if k != "labels"}


def timed_forward(model, params, inputs, runs: int = 3) -> tuple[float, list[float]]:
    """The median host time (s) of ``runs`` synchronised forwards, and each."""
    times = []
    with torch.inference_mode():
        for _ in range(runs):
            t0 = time.perf_counter()
            model.forward(params, inputs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def checked_forward(model, params, inputs, want: dict[str, int], shape: tuple) -> dict:
    """One forward with the launch counts set to 0 just before it and read
    just after; raises unless they are ``want`` and the logits have
    ``shape`` and are finite.  Returns the counts."""
    torch.cuda.synchronize()
    reset_launches()
    with torch.inference_mode():
        logits = model.forward(params, inputs)
    torch.cuda.synchronize()
    launches = launch_counts(tuple(want))
    if launches != want:
        raise AssertionError(f"{model.cfg.name} forward launches {launches}, want {want}")
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{model.cfg.name} logits {tuple(logits.shape)} "
                             f"(want {shape}), not all finite")
    return launches


def card_vs_cpu(arch: str, dev, seq: int, **overrides) -> None:
    """The card's forward (kernels) against the CPU's (plain versions) on
    ``arch``'s smoke config as the card runs it (``card_smoke``, with
    ``overrides``: ``use_kernels=True`` makes the CPU take the kernels'
    plain versions rather than the reference's attention branches), the
    same weights and a numpy-drawn batch of ``seq`` positions (by its input
    mode); raises past CPU_GPU_TOL."""
    from repro_torch import bridge
    from repro_torch.models import Model, synthetic_batch
    small = card_smoke(arch, **overrides)
    sm_cpu = Model(small, "cpu")
    sp_cpu = sm_cpu.init(seed=1)
    sp_gpu = bridge.params_from_numpy(bridge.params_to_numpy(sp_cpu), dev)
    inputs = model_inputs(synthetic_batch(small, 2, seq, np.random.default_rng(1), "cpu"))
    with torch.inference_mode():
        want = sm_cpu.forward(sp_cpu, inputs).float()
        got = Model(small, dev).forward(
            sp_gpu, {k: v.to(dev) for k, v in inputs.items()}).float().cpu()
    err = (got - want).abs().max().item()
    emit("small_forward_vs_cpu", arch=small.name, seq=seq, inputs=sorted(inputs),
         max_abs=err, tol=CPU_GPU_TOL)
    if not err <= CPU_GPU_TOL:
        raise AssertionError(f"card vs CPU forward: {err} > {CPU_GPU_TOL}")


def clustered_frames(batch: dict, gen: torch.Generator) -> dict:
    """``batch`` with each frame embedding drawn around its label's centroid
    (centroids N(0, 0.1²), the stream's frame scale; N(0, 0.05²) about
    them), so the labels are a function of the frames, as HuBERT's cluster
    targets are of its audio.  The stream's frames and labels are drawn
    independently, which a 48-layer encoder does not learn in a few steps
    (``scripts/gate_calibration.py learning``)."""
    labels = batch["labels"].long()
    b, s, d = batch["embeds"].shape
    centroids = torch.randn((int(labels.max()) + 1, d), generator=gen,
                            device=labels.device) * 0.1
    noise = torch.randn((b, s, d), generator=gen, device=labels.device) * 0.05
    return {**batch, "embeds": (centroids[labels] + noise).to(batch["embeds"].dtype)}


def train_checks(cfg, dev, card, kernels: tuple[str, ...]) -> None:
    """Phases 5 and 6 of a training path at full width and depth: one step's
    loss and gradients with the kernels against the same with every
    kernel's plain version (``plain_kernels``), on the stream's first batch
    (|Δloss| <= TRAIN_LOSS_STD_TOL·std(logits), grad-norm relative error <=
    TRAIN_GNORM_REL_TOL); then LEARN_STEPS steps on that one batch (for an
    encoder its frames redrawn about their labels' centroids,
    ``clustered_frames``, and ENCODER_LEARN_LR), in which the loss must
    fall, the first step's launches those of ``step_launches``; then one
    step under the profiler."""
    from repro_torch.bridge import flatten
    from repro_torch.data.pipeline import make_stream
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import (
        AdamW, cosine_schedule, global_norm, value_and_grad,
    )
    from repro_torch.train.step import init_train_state, make_train_step

    b, s = TRAIN_BATCH, TRAIN_SEQ
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             make_stream(cfg, b, s, seed=0).batch_at(0).items()}
    pgen = torch.Generator(device=dev)
    pgen.manual_seed(0)
    params = tfm.init_params(cfg, pgen)

    def loss(prm, bt):
        return tfm.loss_fn(cfg, prm, bt)

    (k_loss, _), k_grads = value_and_grad(loss, params, batch)
    with plain_kernels():
        (p_loss, _), p_grads = value_and_grad(loss, params, batch)
    with torch.no_grad():
        first = {k: v[:1] for k, v in model_inputs(batch).items()}
        logit_std = tfm.forward(cfg, params, first).float().std().item()
    k_norm, p_norm = global_norm(k_grads).item(), global_norm(p_grads).item()
    plain_flat = flatten(p_grads)
    agreement = {
        "loss": k_loss.item(), "plain_loss": p_loss.item(),
        "abs_loss_diff": abs(k_loss.item() - p_loss.item()), "logit_std": logit_std,
        "bound_abs_loss_diff": TRAIN_LOSS_STD_TOL * logit_std,
        "grad_norm": k_norm, "plain_grad_norm": p_norm,
        "grad_norm_rel_err": abs(k_norm - p_norm) / p_norm,
        "bound_grad_norm_rel_err": TRAIN_GNORM_REL_TOL,
        "leaf_max_abs_diff_over_max_abs_grad": {
            key: ((a - plain_flat[key]).abs().max()
                  / plain_flat[key].abs().max().clamp_min(1e-30)).item()
            for key, a in flatten(k_grads).items()},
    }
    emit("train_step_vs_plain_kernels", arch=cfg.name, batch=b, seq=s, **agreement)
    if not (agreement["abs_loss_diff"] <= agreement["bound_abs_loss_diff"]
            and agreement["grad_norm_rel_err"] <= TRAIN_GNORM_REL_TOL):
        raise AssertionError(f"kernel and plain {cfg.name} training steps disagree: "
                             f"{agreement}")
    del params, k_grads, p_grads, plain_flat
    torch.cuda.empty_cache()

    # the loss falls on one repeated batch; one step's launches
    encoder = cfg.input_mode == "embeds"
    learn_lr = ENCODER_LEARN_LR if encoder else LEARN_LR
    opt = AdamW(schedule=cosine_schedule(learn_lr, 1, LEARN_STEPS), weight_decay=0.0)
    pgen.manual_seed(1)
    if encoder:
        batch = clustered_frames(batch, pgen)
    state = init_train_state(cfg, opt, pgen)
    step = make_train_step(cfg, opt)
    losses = []
    for i in range(LEARN_STEPS):
        reset_launches()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            one_step = launch_counts(kernels)
    emit("train_learns", arch=cfg.name, steps=LEARN_STEPS, lr=learn_lr,
         clustered_frames=encoder, losses=losses, bound_last_over_first=LEARN_DROP,
         step_launches=one_step)
    if not losses[-1] < LEARN_DROP * losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if one_step != step_launches(cfg):
        raise AssertionError(f"one train step launched {one_step}, want "
                             f"{step_launches(cfg)} (the forward kernels twice a "
                             f"layer by the full remat, the backward kernels once)")

    # where the time of one train step goes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit("profile_train_step", arch=cfg.name, batch=b, seq=s, nvidia_smi=card,
         **summarize(trace, wall, 1))
    del state, step, batch
    torch.cuda.empty_cache()


def hymba_path(dev, card) -> list[dict]:
    """Phases 3-7 for hymba-1.5b (an attention and an SSM branch in every
    layer; its kernel shapes are checked among FA_CASES and mamba2's SSD
    cases): the kernels' calls of one prefill, prefill at full width and
    depth, prefill against teacher-forced decode at full depth and, cut to
    its first four layers, past the 1024-entry window, the kernels against
    their plain versions, the card against the CPU, serve and profile.
    Returns its prefill's entries of the kernels line."""
    from repro_torch.configs import get
    from repro_torch.models import Model, synthetic_batch
    from repro_torch.serve.engine import Request, ServeEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    cfg = get("hymba-1.5b")
    kernels = path_kernels(cfg, backward=False)
    h, p, g, n, chunk = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                         cfg.ssm_state, cfg.ssm_chunk)

    # -- 3. the kernels' calls of one prefill, timed together ------------------
    b, s = PREFILL_BATCH, PREFILL_SEQ
    windows = attention_windows(cfg)
    fa_mix = fa_prefill_mix(cfg, gen, dev, b, s)
    emit("kernel_prefill_mix", kernel="flash_attention", arch=cfg.name,
         layers=len(windows), global_layers=windows.count(0),
         shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         window=cfg.window, nvidia_smi=card, **fa_mix)
    ssd_mix = ssd_prefill_mix(cfg, gen, dev, b, s)
    emit("kernel_prefill_mix", kernel="ssd_scan", arch=cfg.name, layers=cfg.n_layers,
         shape=[b, s, h, p, g, n, chunk], nvidia_smi=card, **ssd_mix)
    torch.cuda.empty_cache()

    # -- 4. prefill: the main path, at full width and depth -------------------
    model = Model(cfg, dev)
    params = model.init(seed=0, serving=True)   # bf16 serving tree
    batch = synthetic_batch(cfg, b, s, gen, dev)
    torch.cuda.reset_peak_memory_stats()
    launches = checked_forward(model, params, batch,
                               {name: cfg.n_layers for name in kernels},
                               (b, s, cfg.vocab_size))
    prefill_s, times = timed_forward(model, params, batch)
    emit("prefill", arch=cfg.name, batch=b, seq=s, launches=launches,
         seconds=prefill_s, tokens_per_s=b * s / prefill_s, runs=times,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=card)

    # -- 5. correctness ---------------------------------------------------------
    # (a) prefill (kernels) against teacher-forced decode (plain attention
    # over the cache, ssd_step) over two chunks, on the first
    # SSD_CONSISTENCY_LAYERS layers
    layers = SSD_CONSISTENCY_LAYERS[cfg.name]
    cut = cut_depth(cfg, layers)
    cut_model = Model(cut, dev)
    cut_params = cut_model.init(seed=2, serving=True)
    prompt = synthetic_batch(cfg, 1, SSD_CONSISTENCY_PROMPT, gen, dev)["tokens"]
    fwd, dec, _ = prefill_and_decode(cut_model, cut_params, prompt)
    scale = math.sqrt(layers / CONSISTENCY_LAYERS)
    emit("prefill_decode_consistency", arch=cfg.name, prompt=SSD_CONSISTENCY_PROMPT,
         chunks=SSD_CONSISTENCY_PROMPT // chunk, layers=f"{layers} of {cfg.n_layers}",
         layer_types=list(cut.layer_types), depth_scale=scale,
         **logits_agreement(dec, fwd, layers, depth_scale=scale))
    del fwd, dec, cut_model, cut_params

    # (a2) the same past the window, on the first HYMBA_WINDOW_LAYERS layers
    # (one hyb_g, then hyb_l): the hyb_l ring of 1024 entries wraps
    cut = cut_depth(cfg, HYMBA_WINDOW_LAYERS)
    cut_model = Model(cut, dev)
    cut_params = cut_model.init(seed=1, serving=True)
    prompt = synthetic_batch(cut, 1, HYMBA_WINDOW_SEQ, gen, dev)["tokens"]
    fwd, dec, cache = prefill_and_decode(cut_model, cut_params, prompt)
    ring = [seg["attn"]["k"].shape[2] for seg in cache["segments"]]
    if ring != [HYMBA_WINDOW_SEQ, cfg.window] or cache["pos"] != HYMBA_WINDOW_SEQ:
        raise AssertionError(f"cut cache: KV lengths {ring}, pos {cache['pos']}")
    emit("prefill_decode_past_window", arch=cfg.name,
         layers=f"{HYMBA_WINDOW_LAYERS} of {cfg.n_layers}",
         layer_types=list(cut.layer_types), prompt=HYMBA_WINDOW_SEQ,
         window=cfg.window, kv_lengths=ring, chunks=HYMBA_WINDOW_SEQ // chunk,
         depth_scale=HYMBA_WINDOW_DEPTH_SCALE,
         **logits_agreement(dec, fwd, HYMBA_WINDOW_LAYERS,
                            depth_scale=HYMBA_WINDOW_DEPTH_SCALE))
    del fwd, dec, cache, cut_model, cut_params

    # (a3) the kernels' forward against the same forward with the plain
    # versions of both in their place, past the window, over 8 chunks
    toks = synthetic_batch(cfg, 1, SSD_PLAIN_CHECK_SEQ, gen, dev)
    with torch.inference_mode():
        got = model.forward(params, toks)[0].float()
        with plain_kernels():
            want_logits = model.forward(params, toks)[0].float()
    emit("forward_vs_plain_kernels", arch=cfg.name, seq=SSD_PLAIN_CHECK_SEQ,
         window=cfg.window, chunks=SSD_PLAIN_CHECK_SEQ // chunk,
         **logits_agreement(got, want_logits, cfg.n_layers))
    del got, want_logits

    # (b) the card's forward (kernels) against the CPU's (their plain
    # versions), on the card's smoke config (an SSD state of 16), past its
    # window of 16
    card_vs_cpu("hymba-1.5b", dev, 3 * card_smoke("hymba-1.5b").ssm_chunk,
                use_kernels=True)

    # -- 6. serve -----------------------------------------------------------------
    rng = np.random.default_rng(0)
    engine, n_tok, serve_s = serve_requests(cfg, params, dev, rng)
    emit("serve", arch=cfg.name, requests=8, slots=4, max_len=1024, new_tokens=n_tok,
         final_pos=engine.cache["pos"], seconds=serve_s,
         decode_tokens_per_s=n_tok / serve_s,
         steps_per_s=engine.cache["pos"] / serve_s, nvidia_smi=card)

    # -- 7. profile: where the time goes ------------------------------------------
    with torch.inference_mode():
        prof = profiled(lambda: model.forward(params, batch), 1)
    emit("profile_prefill", arch=cfg.name, batch=b, seq=s, nvidia_smi=card, **prof)
    engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
    for rid in range(4):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 4).tolist(), max_new=PROFILE_DECODE_STEPS + 8))
    for _ in range(4):                                      # warm-up
        engine.step()
    prof = profiled(engine.step, PROFILE_DECODE_STEPS)
    emit("profile_decode", arch=cfg.name, slots=4, max_len=1024, nvidia_smi=card,
         per_step={k: prof[k] / PROFILE_DECODE_STEPS for k in (
             "wall_ms", "device_busy_ms", "kernel_launches", "host_syncs")},
         **prof)
    del engine, model, params, batch

    path = "hymba-1.5b prefill"
    return [{"name": "flash_attention", "path": path, "route": "cuda",
             "source": FA_SOURCE, "replaces": FA_REPLACES,
             "launches": launches["flash_attention"], **fa_mix}] + [
        {"name": name, "path": path, "route": "cuda", "source": SSD_SOURCE,
         "replaces": SSD_REPLACES[name], "launches": launches[name], **ssd_mix[part]}
        for name, part in (("ssd_chunk_state", "chunk_state"),
                           ("ssd_chunk_scan", "chunk_scan"))]


def hubert_path(dev, card) -> list[dict]:
    """Phases 3-5 and 7 for hubert-xlarge, an encoder (bidirectional
    attention at D 80, LayerNorm, a non-gated GELU MLP, frame embeddings in
    through ``frontend_proj``; its one-call kernel shapes are among FA_CASES
    and FA_BWD_CASES): the 48 attention calls of one forward timed together,
    a forward at full width and depth on (4, 2048) frame embeddings, the
    forward against the plain attention's, the card against the CPU on the
    smoke config, and a profiled forward.  No serve phase: an encoder has
    nothing to decode.  Returns the forward's entry of the kernels line."""
    from repro_torch.configs import get
    from repro_torch.models import Model, synthetic_batch

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    cfg = get("hubert-xlarge")
    b, s = PREFILL_BATCH, PREFILL_SEQ

    # -- 3. the kernel's calls of one forward, timed together -----------------
    fa_mix = fa_prefill_mix(cfg, gen, dev, b, s)
    emit("kernel_prefill_mix", kernel="flash_attention", arch=cfg.name,
         layers=cfg.n_layers, causal=cfg.causal,
         shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], nvidia_smi=card,
         **fa_mix)
    torch.cuda.empty_cache()

    # -- 4. forward: the main path, at full width and depth -------------------
    model = Model(cfg, dev)
    params = model.init(seed=0, serving=True)
    inputs = model_inputs(synthetic_batch(cfg, b, s, gen, dev))
    torch.cuda.reset_peak_memory_stats()
    launches = checked_forward(model, params, inputs, {"flash_attention": cfg.n_layers},
                               (b, s, cfg.vocab_size))
    forward_s, times = timed_forward(model, params, inputs)
    emit("forward", arch=cfg.name, batch=b, seq=s, inputs=sorted(inputs),
         launches=launches, seconds=forward_s, tokens_per_s=b * s / forward_s,
         runs=times, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         nvidia_smi=card)

    # -- 5. correctness ---------------------------------------------------------
    # (a) the kernel's forward against the plain attention's, at full depth
    one = model_inputs(synthetic_batch(cfg, 1, s, gen, dev))
    with torch.inference_mode():
        got = model.forward(params, one)[0].float()
        with plain_kernels():
            want = model.forward(params, one)[0].float()
    emit("forward_vs_plain_attention", arch=cfg.name, seq=s, causal=cfg.causal,
         **logits_agreement(got, want, cfg.n_layers))
    del got, want
    # (b) the card against the CPU on the smoke config (D 16)
    card_vs_cpu("hubert-xlarge", dev, 40)

    # -- 7. profile: where the time of one forward goes ------------------------
    with torch.inference_mode():
        prof = profiled(lambda: model.forward(params, inputs), 1)
    emit("profile_forward", arch=cfg.name, batch=b, seq=s, nvidia_smi=card, **prof)
    del model, params, inputs, one

    return [{"name": "flash_attention", "path": "hubert-xlarge forward", "route": "cuda",
             "source": FA_SOURCE, "replaces": FA_REPLACES,
             "launches": launches["flash_attention"], **fa_mix}]


def checked_serving_init(model, card):
    """The serving init of ``model`` (``Model.init(serving=True)``: the
    tree made straight in bf16), timed, its peak memory beside the tree's
    bytes; raises if the peak passes the tree and one fp32 draw (a layer, or
    a block of rows).  Returns the parameters."""
    from repro_torch.models.transformer import _DRAW_ELEMENTS
    from repro_torch.tree import tree_leaves
    cfg = model.cfg
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, serving=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tree = tree_bytes(params)
    draw = 4 * max(_DRAW_ELEMENTS, max(math.prod(t.shape[1:]) for t in tree_leaves(params)
                                       if t.dtype == torch.bfloat16))
    peak = torch.cuda.max_memory_allocated() - before
    emit("serving_init", arch=cfg.name, params=cfg.param_count(), tree_gb=tree / 1e9,
         fp32_init_gb=4 * cfg.param_count() / 1e9, peak_gb=peak / 1e9,
         bound_peak_gb=(tree + draw) / 1e9, seconds=init_s, nvidia_smi=card)
    if peak > tree + draw:
        raise AssertionError(f"the serving init peaked at {peak / 1e9} GB, past the "
                             f"tree's {tree / 1e9} GB and one draw's {draw / 1e9} GB")
    return params


def internvl2_path(dev, card) -> list[dict]:
    """Serving internvl2-26b (the VLM backbone: 48 layers, d 6144, 48/8
    heads of 128; the patches' embeddings through ``frontend_proj`` first,
    then the tokens) at full width and depth: the 48 attention calls of one
    prefill timed together, the serving init (its peak memory beside the
    tree's bytes: one card holds the 39.8 GB bf16 tree, not the 79.6 GB
    fp32 init), a prefill on (4, 2048) positions of which 256 are patches,
    the forward against the plain attention's, the card against the CPU on
    the smoke config, serve (tokens only, as the reference's engine) and a
    profile.  Returns the prefill's entry of the kernels line."""
    from repro_torch.configs import get
    from repro_torch.models import Model, synthetic_batch
    from repro_torch.serve.engine import Request, ServeEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    cfg = get("internvl2-26b")
    b, s = PREFILL_BATCH, PREFILL_SEQ

    # -- 3. the kernel's calls of one prefill, timed together ------------------
    fa_mix = fa_prefill_mix(cfg, gen, dev, b, s)
    emit("kernel_prefill_mix", kernel="flash_attention", arch=cfg.name,
         layers=cfg.n_layers, shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         nvidia_smi=card, **fa_mix)
    torch.cuda.empty_cache()

    # -- the serving init: at most the tree and one fp32 draw -----------------
    model = Model(cfg, dev)
    params = checked_serving_init(model, card)

    # -- 4. prefill: the main path, at full width and depth -------------------
    batch = synthetic_batch(cfg, b, s, gen, dev)
    inputs = model_inputs(batch)
    torch.cuda.reset_peak_memory_stats()
    launches = checked_forward(model, params, inputs, {"flash_attention": cfg.n_layers},
                               (b, s, cfg.vocab_size))
    prefill_s, times = timed_forward(model, params, inputs)
    emit("prefill", arch=cfg.name, batch=b, seq=s,
         patches=int(inputs["patch_embeds"].shape[1]), launches=launches,
         seconds=prefill_s, tokens_per_s=b * s / prefill_s, runs=times,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=card)

    # -- 5. correctness ---------------------------------------------------------
    # (a) the kernel's forward against the plain attention's, at full depth.
    # This random init (std 0.02 at d 6144) amplifies rounding: the plain
    # forward moves more when its patch embeddings move by about one bf16
    # step than the CONSISTENCY bounds allow two bf16 paths to differ, and
    # the kernel's and the plain forward are equally far from the same
    # forward computed in fp32 (``scripts/gate_calibration.py rounding``).
    # So the gate is the model's own rounding sensitivity
    # (``rounding_agreement``); ``logits_agreement``'s numbers and the
    # distances from fp32 are reported beside it.
    one = model_inputs(synthetic_batch(cfg, 1, s, gen, dev))
    moved = {**one, "patch_embeds": (one["patch_embeds"].float()
                                     * (1 + 2 ** -7)).to(torch.bfloat16)}
    with torch.inference_mode():
        got = model.forward(params, one)[0].float()
        with plain_kernels():
            want = model.forward(params, one)[0].float()
            want_moved = model.forward(params, moved)[0].float()
            exact = Model(dataclasses.replace(cfg, compute_dtype="float32"), dev).forward(
                params, one)[0].float()
    agreement = rounding_agreement(got, want, want_moved)
    spread, from_fp32 = exact.std().item(), {}
    for name, out in (("kernel", got), ("plain", want)):
        dist = (out - exact).abs()
        from_fp32[f"{name}_vs_fp32_max_rel_to_std"] = dist.max().item() / spread
        from_fp32[f"{name}_vs_fp32_mean_rel_to_std"] = dist.mean().item() / spread
    emit("forward_vs_plain_attention", arch=cfg.name, seq=s,
         patches=int(one["patch_embeds"].shape[1]), input_moved_by=2 ** -7,
         consistency_bounds=logits_agreement(got, want, cfg.n_layers, gate=False),
         **from_fp32, **agreement)
    require_agreement(agreement)
    del got, want, want_moved, exact
    # (b) the card against the CPU on the smoke config (4 patches, then tokens)
    card_vs_cpu("internvl2-26b", dev, 40)

    # -- 6. serve: tokens only -----------------------------------------------------
    rng = np.random.default_rng(0)
    engine, n_tok, serve_s = serve_requests(cfg, params, dev, rng)
    emit("serve", arch=cfg.name, requests=8, slots=4, max_len=1024, new_tokens=n_tok,
         final_pos=engine.cache["pos"], seconds=serve_s,
         decode_tokens_per_s=n_tok / serve_s,
         steps_per_s=engine.cache["pos"] / serve_s, nvidia_smi=card)
    del engine

    # -- 7. profile: where the time goes ------------------------------------------
    with torch.inference_mode():
        prof = profiled(lambda: model.forward(params, inputs), 1)
    emit("profile_prefill", arch=cfg.name, batch=b, seq=s, nvidia_smi=card, **prof)
    engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
    for rid in range(4):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 4).tolist(), max_new=PROFILE_DECODE_STEPS + 8))
    for _ in range(4):                                      # warm-up
        engine.step()
    prof = profiled(engine.step, PROFILE_DECODE_STEPS)
    emit("profile_decode", arch=cfg.name, slots=4, max_len=1024, nvidia_smi=card,
         per_step={k: prof[k] / PROFILE_DECODE_STEPS for k in (
             "wall_ms", "device_busy_ms", "kernel_launches", "host_syncs")},
         **prof)
    del engine, model, params, batch, inputs, one

    return [{"name": "flash_attention", "path": "internvl2-26b prefill", "route": "cuda",
             "source": FA_SOURCE, "replaces": FA_REPLACES,
             "launches": launches["flash_attention"], **fa_mix}]


#: the prefill-against-decode check of a dense configuration where §2's max
#: bound does not hold: the kernels' prefill no farther from the
#: fp32-compute logits than this many times the plain decode is (the
#: tp_decode rule, TP_DECODE_FP32_REF), in max and in mean
DENSE_FP32_REF = 2.0


def consistency_or_own_rounding(dec: torch.Tensor, fwd: torch.Tensor,
                                ref: torch.Tensor, layers: int) -> dict:
    """Prefill (``fwd``, the kernels) against teacher-forced decode
    (``dec``, plain attention over the bf16 cache): §2's bounds at the
    model's depth (``logits_agreement``), and each path's distance from
    ``ref``, the same weights' logits at fp32 compute, relative to its
    spread.  Within bounds where §2's hold; or where only §2's max bound
    fails (its mean bound and the decisive argmaxes hold) and the prefill
    is no farther from ``ref`` than DENSE_FP32_REF times the decode, in max
    and mean: then the two differ by the model's own bf16 rounding, which a
    random init amplifies with width (ROADMAP C10), not by the kernels'."""
    out = logits_agreement(dec, fwd, layers, gate=False)
    spread = ref.std().item()
    for name, logits in (("prefill", fwd), ("decode", dec)):
        dist = (logits - ref).abs()
        out[f"{name}_vs_fp32_max_rel_to_std"] = dist.max().item() / spread
        out[f"{name}_vs_fp32_mean_rel_to_std"] = dist.mean().item() / spread
    out["within_section_2"] = out["within_bounds"]
    if not out["within_bounds"]:
        top2 = fwd.topk(2, dim=-1).values
        decisive = top2[:, 0] - top2[:, 1] > 2 * (fwd - dec).abs().max()
        out["within_bounds"] = (
            out["mean_rel_to_std"] <= out["bound_mean_rel"]
            and bool((fwd.argmax(-1) == dec.argmax(-1))[decisive].all())
            and all(out[f"prefill_vs_fp32_{m}_rel_to_std"]
                    <= DENSE_FP32_REF * out[f"decode_vs_fp32_{m}_rel_to_std"]
                    for m in ("max", "mean")))
    out["held_to"] = "section 2" if out["within_section_2"] else "own rounding"
    return out


#: the ported dense configurations served whole on the card (ROADMAP A8):
#: gemma-7b (28 layers, d 3072, MHA 16/16 at D 256, vocab 256,000),
#: h2o-danube-1.8b (24 layers, d 2560, 32/8 heads at D 80, a window of
#: 4096) and deepseek-7b (30 layers, d 4096, MHA 32/32 at D 128)
DENSE_ARCHS = ("gemma-7b", "h2o-danube-1.8b", "deepseek-7b")
#: h2o-danube-1.8b's window bites past 4096 positions: its forward on one
#: row of this many, the kernel against the plain attention
DANUBE_WINDOW_CHECK_SEQ = 4608


def dense_path(dev, card) -> list[dict]:
    """Serving DENSE_ARCHS at full width and depth, each from the serving
    init straight into bf16 (its peak beside the tree's bytes): the
    attention calls of one prefill timed together (kernel, plain, SDPA, the
    bound), a prefill on (4, 2048) tokens (the median of 3, its launches
    one a layer, tokens/s and peak), prefill against teacher-forced decode
    over CONSISTENCY_PROMPT positions under §2's gates at the model's
    depth, for h2o-danube-1.8b the forward on one row of
    DANUBE_WINDOW_CHECK_SEQ positions against the plain attention's, the
    card against the CPU on the smoke config, and ``ServeEngine`` on 4
    slots (8 requests of 16 tokens).  Returns each prefill's entry of the
    kernels line."""
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model, compute_copy, synthetic_batch

    entries = []
    for i, arch in enumerate(DENSE_ARCHS):
        gen = torch.Generator(device=dev)
        gen.manual_seed(20 + i)
        cfg = get(arch)
        b, s = PREFILL_BATCH, PREFILL_SEQ
        shape = [b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim]

        # -- 3. the kernel's calls of one prefill, timed together ----------
        fa_mix = fa_prefill_mix(cfg, gen, dev, b, s)
        emit("kernel_prefill_mix", kernel="flash_attention", arch=cfg.name,
             layers=cfg.n_layers, shape=shape, window=cfg.window, nvidia_smi=card,
             **fa_mix)
        torch.cuda.empty_cache()

        # -- the serving init, then 4. prefill at full width and depth -----
        model = Model(cfg, dev)
        params = checked_serving_init(model, card)
        tree_gb = tree_bytes(params) / 1e9
        batch = synthetic_batch(cfg, b, s, gen, dev)
        torch.cuda.reset_peak_memory_stats()
        launches = checked_forward(model, params, batch,
                                   {"flash_attention": cfg.n_layers},
                                   (b, s, cfg.vocab_size))
        prefill_s, times = timed_forward(model, params, batch)
        emit("prefill", arch=cfg.name, batch=b, seq=s, launches=launches,
             seconds=prefill_s, tokens_per_s=b * s / prefill_s, runs=times,
             tree_gb=tree_gb, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             nvidia_smi=card)
        del batch

        # -- 5. correctness ---------------------------------------------------
        # (a) prefill (kernel) against teacher-forced decode (plain attention
        # over the cache), over a prompt of several key tiles; each beside
        # the same weights' logits at fp32 compute (plain attention)
        prompt = synthetic_batch(cfg, 1, CONSISTENCY_PROMPT, gen, dev)["tokens"]
        fwd, dec, _ = prefill_and_decode(model, params, prompt)
        ref_cfg = dataclasses.replace(cfg, compute_dtype="float32")
        with torch.inference_mode(), plain_kernels():
            ref = Model(ref_cfg, dev).forward(compute_copy(ref_cfg, params),
                                              {"tokens": prompt})[0].float()
        agreement = consistency_or_own_rounding(dec, fwd, ref, cfg.n_layers)
        emit("prefill_decode_consistency", arch=cfg.name, prompt=CONSISTENCY_PROMPT,
             **agreement)
        require_agreement(agreement)
        del fwd, dec, ref
        # (a2) past the window: the kernel's forward against the plain
        # attention's on one row
        if cfg.window:
            toks = synthetic_batch(cfg, 1, DANUBE_WINDOW_CHECK_SEQ, gen, dev)
            with torch.inference_mode():
                got = model.forward(params, toks)[0].float()
                with plain_kernels():
                    want = model.forward(params, toks)[0].float()
            emit("forward_vs_plain_attention", arch=cfg.name, seq=DANUBE_WINDOW_CHECK_SEQ,
                 window=cfg.window, **logits_agreement(got, want, cfg.n_layers))
            del got, want
        # (b) the card against the CPU on the smoke config
        card_vs_cpu(arch, dev, 40)

        # -- 6. serve -----------------------------------------------------------
        fa.launches = 0
        rng = np.random.default_rng(0)
        engine, n_tok, serve_s = serve_requests(cfg, params, dev, rng)
        emit("serve", arch=cfg.name, requests=8, slots=4, max_len=1024,
             new_tokens=n_tok, final_pos=engine.cache["pos"], seconds=serve_s,
             decode_tokens_per_s=n_tok / serve_s,
             steps_per_s=engine.cache["pos"] / serve_s,
             flash_attention_launches=fa.launches, nvidia_smi=card)
        del engine, model, params
        torch.cuda.empty_cache()
        entries.append({"name": "flash_attention", "path": f"{cfg.name} prefill",
                        "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
                        "launches": launches["flash_attention"], **fa_mix})
    return entries


def moe_group_sizes(gen, dev, tokens: int, n_experts: int, top_k: int,
                    d: int = 2048) -> torch.Tensor:
    """Group sizes (int32, on the card) of a real top-k routing: ``tokens``
    hidden states N(0, 1) through a router N(0, 0.02^2) (the port's init
    scale), top-k of the fp32 softmax, counted per expert."""
    from repro_torch.models import moe
    x = torch.randn((tokens, d), generator=gen, device=dev)
    w = torch.randn((d, n_experts), generator=gen, device=dev) * 0.02
    probs, _ = moe.router_probs(x, w)
    idx = probs.topk(top_k, dim=-1).indices.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int32, device=dev).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def gmm_case_sizes(gen, dev, t: int, n_experts: int, kind: str,
                   top_k: int) -> torch.Tensor:
    """Group sizes summing to ``t``: from a top-k routing of t / k tokens
    (``"route"``), all in one expert (``"one"``), or cut at random points,
    empty groups included (``"random"``)."""
    if kind == "route":
        return moe_group_sizes(gen, dev, t // top_k, n_experts, top_k)
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=dev)
    if kind == "one":
        sizes[n_experts // 3] = t
        return sizes
    cuts = torch.randint(0, t + 1, (n_experts - 1,), generator=gen,
                         device=dev).sort().values
    return torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), t)]
                     ).diff().to(torch.int32)


def grouped_mm_call(x, w, sizes):
    """One PyTorch call for the same grouped product (``torch._grouped_mm``
    with int32 group ends: the rows of x (T, d) against w (E, d, f) for y
    and dx, or the columns of x (d, T) against the rows of w (T, f) for
    dw), a yardstick for the kernels only, never used by the port: (the
    call, None), or (None, the reason there is none)."""
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is None:
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    try:
        grouped_mm(x, w, offs=offs)
    except RuntimeError as exc:
        return None, f"torch._grouped_mm refused these inputs: {exc}"
    return (lambda: grouped_mm(x, w, offs=offs)), None


def olmoe_path(dev, card) -> dict:
    """Phases 3-7 for olmoe-1b-7b, then qwen2-moe-a2.7b's prefill at full
    width and depth from the serving init and its plain-GEMM check at 4 of
    its 24 layers; returns the grouped GEMM's entry of the kernels line."""
    from repro_torch import bridge
    from repro_torch.configs import get, get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import Model, moe, synthetic_batch
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cfg = get("olmoe-1b-7b")
    qcfg = get("qwen2-moe-a2.7b")
    d, f, e, k, n_layers = (cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.top_k,
                            cfg.n_layers)
    b, s = 4, 2048
    rows, qrows = b * s * k, b * s * qcfg.top_k

    # -- 3. flash attention at olmoe's shape: the 16 calls of a prefill --------
    # (its own generator: the later phases draw from ``gen`` as they did
    # before this check was added)
    agen = torch.Generator(device=dev)
    agen.manual_seed(4)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, key, val = [torch.randn((b, s, h, hd), generator=agen, device=dev
                               ).to(torch.bfloat16) for h in (hq, hkv, hkv)]
    out = fa.flash_attention(q, key, val, causal=True)
    want = fa.flash_attention_plain(q, key, val, causal=True)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    rel = row_rel_err(out, want)
    if not (err <= KERNEL_TOL and rel <= ROW_REL_TOL):
        raise AssertionError(f"flash_attention at olmoe's shape: max |err| {err} "
                             f"(tol {KERNEL_TOL}), row-relative {rel} (tol {ROW_REL_TOL})")
    ops_ms, bytes_ms = attention_floor_ms(b, s, hq, hkv, hd, True, 0)
    bound_ms, bound_by = bound(n_layers * ops_ms, n_layers * bytes_ms)
    sdpa = sdpa_call(q, key, val, True, 0)
    emit("kernel_check", kernel="flash_attention", case="olmoe-1b-7b prefill",
         calls=n_layers, shape=[b, s, hq, hkv, hd], causal=True, window=0,
         max_abs_err=err, tol=KERNEL_TOL, max_row_rel_err=rel,
         row_rel_tol=ROW_REL_TOL,
         ms=time_ms(lambda: [fa.flash_attention(q, key, val, causal=True)
                             for _ in range(n_layers)], 5),
         plain_ms=time_ms(lambda: [fa.flash_attention_plain(q, key, val, causal=True)
                                   for _ in range(n_layers)], 1, 1),
         library_ms=time_ms(lambda: [sdpa() for _ in range(n_layers)], 5),
         bound_ms=bound_ms, bound_by=bound_by, nvidia_smi=card)
    del q, key, val, out, want, sdpa

    # -- 3. the grouped GEMM against its plain version ------------------------
    cases = [  # name, T, d, f, E, group sizes, top-k of the routing
        ("olmoe-1b-7b gate/up", rows, d, f, e, "route", k),
        ("olmoe-1b-7b down", rows, f, d, e, "route", k),
        ("qwen2-moe-a2.7b gate/up", qrows, qcfg.d_model, qcfg.moe_d_ff,
         qcfg.n_experts, "route", qcfg.top_k),
        ("qwen2-moe-a2.7b down", qrows, qcfg.moe_d_ff, qcfg.d_model,
         qcfg.n_experts, "route", qcfg.top_k),
        ("olmoe-1b-7b decode, 4 tokens", 4 * k, d, f, e, "route", k),
        ("all rows in one expert", 4096, d, f, e, "one", k),
        ("1000 rows, ragged tiles", 1000, d, f, e, "random", k),
        ("one row", 1, d, f, e, "random", k),
    ]
    max_err = 0.0
    for name, t, dd, ff, ee, kind, kk in cases:
        x = torch.randn((t, dd), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((ee, dd, ff), generator=gen, device=dev) * 0.02
             ).to(torch.bfloat16)
        sizes = gmm_case_sizes(gen, dev, t, ee, kind, kk)
        out = moe_gmm.grouped_matmul(x, w, sizes)
        want = moe_gmm.grouped_matmul_plain(x, w, sizes)
        torch.cuda.synchronize()
        errs = gmm_errors(out, want)
        max_err = max(max_err, errs["max_abs_err"])
        nonempty = int((sizes > 0).sum())
        bound_ms, bound_by = bound(*gmm_floor_ms(t, dd, ff, nonempty))
        lib, no_lib = grouped_mm_call(x, w, sizes)
        # the wrapper's host time a call where decode makes it: 48 a step
        host = ({"host_us": host_us(lambda: moe_gmm.grouped_matmul(x, w, sizes))}
                if t == 4 * k else {})
        emit("kernel_check", kernel="grouped_matmul", case=name,
             shape=[t, dd, ff, ee], nonempty_experts=nonempty,
             largest_group=int(sizes.max()), row_tiles=gmm_row_tiles(sizes),
             **errs, tol=GMM_TOL,
             row_rel_tol=ROW_REL_TOL,
             ms=time_ms(lambda: moe_gmm.grouped_matmul(x, w, sizes), 20),
             plain_ms=time_ms(lambda: moe_gmm.grouped_matmul_plain(x, w, sizes), 3, 1),
             library_ms=time_ms(lib, 20) if lib else None,
             library=no_lib or "torch._grouped_mm",
             bound_ms=bound_ms, bound_by=bound_by, nvidia_smi=card, **host)
        del x, w, out, want, lib

    # the grouped GEMMs of one olmoe-1b-7b prefill: gate, up, down a layer
    sizes = moe_group_sizes(gen, dev, b * s, e, k)
    nonempty = int((sizes > 0).sum())
    x = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    hid = torch.randn((rows, f), generator=gen, device=dev).to(torch.bfloat16)
    w_in = [(torch.randn((e, d, f), generator=gen, device=dev) * 0.02
             ).to(torch.bfloat16) for _ in range(2)]
    w_down = (torch.randn((e, f, d), generator=gen, device=dev) * 0.02
              ).to(torch.bfloat16)
    calls = [(x, w_in[0]), (x, w_in[1]), (hid, w_down)] * n_layers
    libs = [grouped_mm_call(a, w, sizes) for a, w in calls[:3]]
    floors = [gmm_floor_ms(rows, a.shape[1], w.shape[2], nonempty) for a, w in calls]
    mix_bound_ms, mix_bound_by = bound(sum(fl[0] for fl in floors),
                                       sum(fl[1] for fl in floors))
    no_lib = next((why for call, why in libs if call is None), None)
    gmm_mix = {
        "ms": time_ms(lambda: [moe_gmm.grouped_matmul(a, w, sizes) for a, w in calls], 5),
        "plain_ms": time_ms(lambda: [moe_gmm.grouped_matmul_plain(a, w, sizes)
                                     for a, w in calls], 1, 1),
        "library_ms": (None if no_lib else
                       time_ms(lambda: [call() for call, _ in libs * n_layers], 5)),
        "bound_ms": mix_bound_ms, "bound_by": mix_bound_by,
    }
    emit("kernel_prefill_mix", kernel="grouped_matmul", calls=len(calls),
         shape=[rows, d, f, e], nonempty_experts=nonempty,
         row_tiles=gmm_row_tiles(sizes),
         library=no_lib or "torch._grouped_mm", nvidia_smi=card, **gmm_mix)
    del x, hid, w_in, w_down, calls, libs

    # -- 4. prefill: the main path (default dispatch) and the other one -------
    model = Model(cfg, dev)
    params = model.init(seed=0, serving=True)   # bf16 serving tree
    batch = synthetic_batch(cfg, b, s, gen, dev)
    moe_block = transformer.moe_block
    main_launches = None
    for dispatch in (cfg.moe_dispatch, "ragged"):
        dmodel = Model(dataclasses.replace(cfg, moe_dispatch=dispatch), dev)
        drops = []

        def recording(*args, **kwargs):
            out, aux = moe_block(*args, **kwargs)
            drops.append(aux["dropped"])
            return out, aux

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        transformer.moe_block = recording
        moe_gmm.launches = fa.launches = 0
        try:
            with torch.inference_mode():
                logits = dmodel.forward(params, batch)
            torch.cuda.synchronize()
        finally:
            transformer.moe_block = moe_block
        launches = {"grouped_matmul": moe_gmm.launches,
                    "flash_attention": fa.launches}
        want = {"grouped_matmul": 3 * n_layers, "flash_attention": n_layers}
        if launches != want:
            raise AssertionError(f"{dispatch} prefill launches {launches}, want {want}")
        if main_launches is None:
            main_launches = launches["grouped_matmul"]
        if tuple(logits.shape) != (b, s, cfg.vocab_size):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{dispatch} prefill logits are not finite")
        del logits
        times = []
        with torch.inference_mode():
            for _ in range(3):
                t0 = time.perf_counter()
                dmodel.forward(params, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        prefill_s = float(np.median(times))
        emit("prefill", arch=cfg.name, moe_dispatch=dispatch, batch=b, seq=s,
             launches=launches, seconds=prefill_s, tokens_per_s=b * s / prefill_s,
             runs=times, dropped_share=torch.stack(drops).mean().item(),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=card)

    # -- 5. correctness, dropless (ragged): prefill and decode route alike ----
    rmodel = Model(dataclasses.replace(cfg, moe_dispatch="ragged"), dev)
    # (a) prefill (kernels) against teacher-forced decode (plain attention,
    # grouped GEMM over K rows a step), over several key tiles
    prompt = synthetic_batch(cfg, 1, CONSISTENCY_PROMPT, gen, dev)["tokens"]
    with torch.inference_mode():
        with recorded_routing(moe) as fwd_routes:
            fwd = rmodel.forward(params, {"tokens": prompt})[0].float()
        cache = rmodel.init_cache(1, CONSISTENCY_PROMPT)
        dec = []
        with recorded_routing(moe) as dec_routes:
            for t in range(prompt.shape[1]):
                lg, cache = rmodel.decode_step(params, cache, prompt[:, t:t + 1])
                dec.append(lg[0].float())
        # decode's routing, layer by layer, replayed into the prefill
        dec_routes = [tuple(torch.cat([c[j] for c in dec_routes[i::n_layers]])
                            for j in (0, 1)) for i in range(n_layers)]
        with replayed_routing(moe, dec_routes):
            fwd_same = rmodel.forward(params, {"tokens": prompt})[0].float()
    dec = torch.stack(dec)
    routing = routing_differences(logits_of(dec_routes), logits_of(fwd_routes), k)
    free = logits_agreement(dec, fwd, n_layers, gate=False)
    same = logits_agreement(dec, fwd_same, n_layers, gate=False)
    emit("prefill_decode_consistency", arch=cfg.name, moe_dispatch="ragged",
         prompt=CONSISTENCY_PROMPT, routing=routing, same_routing=same, **free)
    require_agreement(free)
    require_agreement(same)
    del fwd, fwd_same, dec, cache, fwd_routes, dec_routes

    # (a2) the kernel's forward against the same forward with the grouped
    # GEMM's plain version in the kernel's place
    toks = synthetic_batch(cfg, 1, MOE_PLAIN_CHECK_SEQ, gen, dev)
    out = forward_vs_plain_gmm(rmodel, params, toks, n_layers, k)
    emit("forward_vs_plain_gmm", arch=cfg.name, moe_dispatch="ragged",
         seq=MOE_PLAIN_CHECK_SEQ, routing=out["routing"],
         same_routing=out["same_routing"], **out["free"])
    require_agreement(out["free"])
    require_agreement(out["same_routing"])

    # (b) the card's forward (kernels) against the CPU's (plain versions), on
    # the small configs, both dispatches
    for arch in ("olmoe-1b-7b", "qwen2-moe-a2.7b"):
        for dispatch in ("einsum", "ragged"):
            small = get_smoke(arch, moe_dispatch=dispatch)
            sm_cpu = Model(small, "cpu")
            sp_cpu = sm_cpu.init(seed=1)
            sp_gpu = bridge.params_from_numpy(bridge.params_to_numpy(sp_cpu), dev)
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, small.vocab_size, (2, 40)))
            with torch.inference_mode():
                want_small = sm_cpu.forward(sp_cpu, {"tokens": toks}).float()
                before = moe_gmm.launches
                got_small = Model(small, dev).forward(
                    sp_gpu, {"tokens": toks.to(dev)}).float().cpu()
            small_err = (got_small - want_small).abs().max().item()
            emit("small_forward_vs_cpu", arch=small.name, moe_dispatch=dispatch,
                 seq=40, max_abs=small_err, tol=CPU_GPU_TOL,
                 grouped_matmul_launches=moe_gmm.launches - before)
            if moe_gmm.launches - before != 3 * small.n_layers:
                raise AssertionError(f"{small.name}: {moe_gmm.launches - before} "
                                     f"grouped_matmul launches")
            if not small_err <= CPU_GPU_TOL:
                raise AssertionError(f"card vs CPU forward: {small_err} > {CPU_GPU_TOL}")

    # -- 6. serve (default dispatch) --------------------------------------------
    moe_gmm.launches = 0
    rng = np.random.default_rng(0)
    engine, n_tok, serve_s = serve_requests(cfg, params, dev, rng)
    serve_launches = moe_gmm.launches
    if serve_launches != 3 * n_layers * engine.cache["pos"]:
        raise AssertionError(f"serve launched grouped_matmul {serve_launches} "
                             f"times in {engine.cache['pos']} steps")
    emit("serve", arch=cfg.name, moe_dispatch=cfg.moe_dispatch, requests=8,
         slots=4, max_len=1024, new_tokens=n_tok, final_pos=engine.cache["pos"],
         seconds=serve_s, decode_tokens_per_s=n_tok / serve_s,
         steps_per_s=engine.cache["pos"] / serve_s,
         grouped_matmul_launches=serve_launches, nvidia_smi=card)

    # -- 7. profile: where the time goes ------------------------------------------
    with torch.inference_mode():
        prof = profiled(lambda: model.forward(params, batch), 1)
    emit("profile_prefill", arch=cfg.name, batch=b, seq=s, nvidia_smi=card, **prof)
    engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
    for rid in range(4):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 4).tolist(), max_new=PROFILE_DECODE_STEPS + 8))
    for _ in range(4):                                      # warm-up
        engine.step()
    prof = profiled(engine.step, PROFILE_DECODE_STEPS)
    per_step = {key: prof[key] / PROFILE_DECODE_STEPS for key in (
        "wall_ms", "device_busy_ms", "kernel_launches", "host_syncs")}
    emit("profile_decode", arch=cfg.name, slots=4, max_len=1024, nvidia_smi=card,
         per_step=per_step, **prof)
    # the MoE layer reads nothing back: one synchronisation a layer (the
    # attention's existing 0-d scale) and the engine's own
    if per_step["host_syncs"] > n_layers + DECODE_ENGINE_SYNCS:
        raise AssertionError(f"{per_step['host_syncs']} host synchronisations a "
                             f"decode step, want at most {n_layers} + "
                             f"{DECODE_ENGINE_SYNCS}")
    del engine, model, params, batch
    torch.cuda.empty_cache()

    qwen2_moe_path(dev, card, gen)

    return {
        "name": "grouped_matmul", "path": "olmoe-1b-7b prefill", "route": "cuda",
        "source": GMM_SOURCE,
        "replaces": GMM_REPLACES, "launches": main_launches,
        "max_abs_err": max_err, **gmm_mix,
    }


def qwen2_moe_path(dev, card, gen) -> None:
    """qwen2-moe-a2.7b (60 experts top-4 and a gated shared expert, 24
    layers): a prefill at full width and depth from the serving init (28.6
    GB of bf16: the fp32 init, 57.3 GB, and its serving copy would not fit
    one card), then the plain-GEMM check at 4 of its 24 layers."""
    from repro_torch.configs import get
    from repro_torch.models import Model, synthetic_batch

    qcfg = get("qwen2-moe-a2.7b")
    b, s = PREFILL_BATCH, PREFILL_SEQ
    # -- 4 at full width and depth, from the serving init ----------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qmodel = Model(qcfg, dev)
    qparams = qmodel.init(seed=0, serving=True)
    torch.cuda.synchronize()
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    qinputs = model_inputs(synthetic_batch(qcfg, b, s, gen, dev))
    torch.cuda.reset_peak_memory_stats()
    launches = checked_forward(
        qmodel, qparams, qinputs,
        {"grouped_matmul": 3 * qcfg.n_layers, "flash_attention": qcfg.n_layers},
        (b, s, qcfg.vocab_size))
    prefill_s, times = timed_forward(qmodel, qparams, qinputs)
    emit("prefill", arch=qcfg.name, layers=qcfg.n_layers,
         moe_dispatch=qcfg.moe_dispatch, batch=b, seq=s, launches=launches,
         seconds=prefill_s, tokens_per_s=b * s / prefill_s, runs=times,
         tree_gb=tree_bytes(qparams) / 1e9, init_peak_mem_gb=init_peak_gb,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=card)
    del qparams, qmodel, qinputs
    torch.cuda.empty_cache()

    # -- 5 at full width, 4 of its 24 layers ------------------------------------
    qcut = cut_depth(qcfg, QWEN2_MOE_LAYERS)
    qparams = Model(qcut, dev).init(seed=0, serving=True)
    # The bounds hold the rounding, so they gate the run with the same
    # routing; a flip on a near-tie is a step set by the expert weights and
    # the router probability, not by the depth, so at 4 layers the free
    # run's logits are reported, not gated.  Depth scaling at 4 layers: the
    # two models of error growth (linear if the layers' differences add
    # coherently, sqrt if independently) meet at 26 layers, and below it
    # the sqrt one is the larger; so the cut model takes sqrt(4 / 26):
    # 0.098·std max, 0.0196·std mean (the linear 0.038·std max is about one
    # bf16 step of the largest logits, ~3-5, and is refused by rounding
    # alone: 0.052·std measured on an H100 with the same routing).
    qr = Model(dataclasses.replace(qcut, moe_dispatch="ragged"), dev)
    toks = synthetic_batch(qcut, 1, MOE_PLAIN_CHECK_SEQ, gen, dev)
    out = forward_vs_plain_gmm(qr, qparams, toks, QWEN2_MOE_LAYERS, qcut.top_k,
                               depth_scale=QWEN2_MOE_DEPTH_SCALE)
    emit("forward_vs_plain_gmm", arch=qcut.name,
         layers=f"{QWEN2_MOE_LAYERS} of {qcfg.n_layers}", moe_dispatch="ragged",
         seq=MOE_PLAIN_CHECK_SEQ, routing=out["routing"],
         same_routing=out["same_routing"], **out["free"])
    require_agreement(out["same_routing"])
    del out, qparams, qr


def gemma3_train_path(dev, card) -> dict:
    """The training slice: the flash-attention backward against its plain
    version, gemma3-1b training at full width through ``launch.train``, the
    kernels' step against the plain attention's, a falling loss, the launch
    counts of one step and its profile.  Returns the backward kernel's entry
    of the kernels line."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import (
        AdamW, cosine_schedule, global_norm, value_and_grad,
    )
    from repro_torch.train.step import init_train_state, make_train_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    # -- 3. the backward kernels against their plain version ------------------
    # (ptxas of its prep, main and dQ-convert kernels, from this run's build)
    from repro_torch.kernels import _build
    emit("build_flash_attention_bwd", nvidia_smi=card,
         ptxas=ptxas_kernels(_build.build_log.get("flash_attention.cu", ""),
                             "flash_attention_bwd"))
    max_err = 0.0
    for name, b, s, hq, hkv, d, causal, window, empty_rows in FA_BWD_CASES:
        q, k, v = normal(b, s, hq, d), normal(b, s, hkv, d), normal(b, s, hkv, d)
        do = normal(b, s, hq, d)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)
        lse_err = (lse - fa.flash_attention_lse_plain(
            q, k, causal=causal, window=window)).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash_attention LSE {name}: {lse_err} > {LSE_TOL}")
        if empty_rows:
            lse[:, :, 5:70] = float("-inf")
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                            window=window)
        torch.cuda.synchronize()
        errs = {}
        for part, a, w in zip(("dq", "dk", "dv"), got, want):
            errs[part], over = grad_row_err(a, w)
            if over > 0:
                raise AssertionError(
                    f"flash_attention_bwd {name}: {part} max |err| {errs[part]}, "
                    f"past the row gate ({BWD_ROW_REL_TOL} of the row's largest "
                    f"|plain| + {BWD_ABS_FLOOR}) by {over}")
        if empty_rows and not bool((got[0][:, 5:70] == 0).all()):
            raise AssertionError("flash_attention_bwd: a row that saw no key has dQ != 0")
        max_err = max(max_err, *errs.values())
        bound_ms, bound_by = bound(*attention_bwd_floor_ms(b, s, hq, hkv, d,
                                                           causal, window))
        emit("kernel_check", kernel="flash_attention_bwd", case=name,
             shape=[b, s, hq, hkv, d], causal=causal, window=window,
             rows_without_keys=empty_rows, lse_max_abs_err=lse_err, lse_tol=LSE_TOL,
             max_abs_err=errs, row_rel_tol=BWD_ROW_REL_TOL, abs_floor=BWD_ABS_FLOOR,
             ms=time_ms(lambda: fa.flash_attention_bwd(
                 q, k, v, out, lse, do, causal=causal, window=window), 10),
             plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
                 q, k, v, out, lse, do, causal=causal, window=window), 2, 1),
             library_ms=time_ms(sdpa_grad_call(q, k, v, do, causal, window), 10),
             bound_ms=bound_ms, bound_by=bound_by, nvidia_smi=card)
        del q, k, v, do, out, lse, got, want

    # the backward's work in one gemma3-1b train step: one call per layer
    cfg = get("gemma3-1b")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    train_attn = fa_train_mix(cfg, gen, dev, b, s)
    emit("kernel_train_mix", kernel="flash_attention_bwd", arch=cfg.name,
         layers=cfg.n_layers, shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         nvidia_smi=card, **train_attn)
    torch.cuda.empty_cache()

    # -- 4. train: the main path, at full width and depth ----------------------
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_launches = 0
    steps = TRAIN_WARMUP + TRAIN_TIMED
    out = train.main(["--arch", "gemma3-1b", "--steps", str(steps),
                      "--batch", str(b), "--seq", str(s), "--log-every", "1"])
    fwd_launches, bwd_launches = fa.launches, fa.bwd_launches
    want_fwd, want_bwd = 2 * cfg.n_layers * steps, cfg.n_layers * steps
    if (fwd_launches, bwd_launches) != (want_fwd, want_bwd):
        raise AssertionError(f"training launched flash_attention {fwd_launches} "
                             f"and its backward {bwd_launches} times, want "
                             f"{want_fwd} and {want_bwd}")
    if out["steps_run"] != steps or not math.isfinite(out["loss"]):
        raise AssertionError(f"training ran {out['steps_run']} steps, loss {out['loss']}")
    timed = out["step_seconds"][TRAIN_WARMUP:]
    step_s = float(np.median(timed))
    n_params, tokens = cfg.param_count(), b * s
    emit("train", arch=cfg.name, batch=b, seq=s, remat=cfg.remat,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         loss_chunk=cfg.loss_chunk, warmup_steps=TRAIN_WARMUP,
         step_seconds=out["step_seconds"], step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s, params=n_params,
         mfu_6nt=6 * n_params * tokens / (step_s * PEAK_BF16_FLOPS),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         flash_attention_launches=fwd_launches,
         flash_attention_bwd_launches=bwd_launches,
         final_loss=out["loss"], final_grad_norm=out["grad_norm"], nvidia_smi=card)
    torch.cuda.empty_cache()

    # -- 5. correctness at full width ------------------------------------------
    # (a) the kernels' gradient against the plain attention's, one step's
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             make_stream(cfg, b, s, seed=0).batch_at(0).items()}
    pgen = torch.Generator(device=dev)
    pgen.manual_seed(0)
    params = tfm.init_params(cfg, pgen)

    def loss(p, bt):
        return tfm.loss_fn(cfg, p, bt)

    (k_loss, _), k_grads = value_and_grad(loss, params, batch)
    kernel = fa.flash_attention
    fa.flash_attention = fa.flash_attention_plain
    try:
        (p_loss, _), p_grads = value_and_grad(loss, params, batch)
    finally:
        fa.flash_attention = kernel
    with torch.no_grad():
        logit_std = tfm.forward(cfg, params, {"tokens": batch["tokens"][:1]}).float().std().item()
    k_norm, p_norm = global_norm(k_grads).item(), global_norm(p_grads).item()
    plain_flat = flatten(p_grads)
    leaf_rel = {key: ((a - plain_flat[key]).abs().max()
                      / plain_flat[key].abs().max().clamp_min(1e-30)).item()
                for key, a in flatten(k_grads).items()}
    agreement = {
        "loss": k_loss.item(), "plain_loss": p_loss.item(),
        "abs_loss_diff": abs(k_loss.item() - p_loss.item()), "logit_std": logit_std,
        "bound_abs_loss_diff": TRAIN_LOSS_STD_TOL * logit_std,
        "grad_norm": k_norm, "plain_grad_norm": p_norm,
        "grad_norm_rel_err": abs(k_norm - p_norm) / p_norm,
        "bound_grad_norm_rel_err": TRAIN_GNORM_REL_TOL,
        "leaf_max_abs_diff_over_max_abs_grad": leaf_rel,
    }
    emit("train_step_vs_plain_attention", arch=cfg.name, batch=b, seq=s, **agreement)
    if not (agreement["abs_loss_diff"] <= agreement["bound_abs_loss_diff"]
            and agreement["grad_norm_rel_err"] <= TRAIN_GNORM_REL_TOL):
        raise AssertionError(f"kernel and plain training steps disagree: {agreement}")
    del params, k_grads, p_grads
    torch.cuda.empty_cache()

    # (b) the loss falls on one repeated batch; (c) one step's launches
    opt = AdamW(schedule=cosine_schedule(1e-3, 1, LEARN_STEPS), weight_decay=0.0)
    pgen.manual_seed(1)
    state = init_train_state(cfg, opt, pgen)
    step = make_train_step(cfg, opt)
    losses = []
    for i in range(LEARN_STEPS):
        fa.launches = fa.bwd_launches = 0
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            step_launches = {"flash_attention": fa.launches,
                             "flash_attention_bwd": fa.bwd_launches}
    emit("train_learns", arch=cfg.name, steps=LEARN_STEPS, losses=losses,
         bound_last_over_first=LEARN_DROP, step_launches=step_launches)
    if not losses[-1] < LEARN_DROP * losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if step_launches != {"flash_attention": 2 * cfg.n_layers,
                         "flash_attention_bwd": cfg.n_layers}:
        raise AssertionError(f"one train step launched {step_launches}, want "
                             f"{2 * cfg.n_layers} forward (26 + 26 recomputed "
                             f"by the full remat) and {cfg.n_layers} backward")

    # -- 6. profile: where the time of one train step goes --------------------
    # (also the device time of fill kernels: indexing each layer out of a
    # stacked weight would fill a zero stack per layer in the backward; the
    # model unbinds each stacked leaf once instead, whose backward is one
    # stack)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels_ms: dict[str, float] = collections.Counter()
    for e in trace.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels_ms[e.name[:200]] += (e.time_range.end - e.time_range.start) / 1e3
    emit("profile_train_step", arch=cfg.name, batch=b, seq=s, nvidia_smi=card,
         fill_ms=sum(ms for name, ms in kernels_ms.items() if "fill" in name.lower()),
         elementwise_top_ms=dict(collections.Counter(
             {n: ms for n, ms in kernels_ms.items()
              if kernel_class(n) == "elementwise"}).most_common(10)),
         **summarize(trace, wall, 1))
    del state, step
    torch.cuda.empty_cache()

    return {
        "name": "flash_attention_bwd", "path": "gemma3-1b train", "route": "cuda",
        "source": FA_SOURCE, "replaces": FA_REPLACES, "launches": bwd_launches,
        "design": FA_BWD_DESIGN, **train_attn,
        "max_abs_err": max(max_err, train_attn["max_abs_err"]),
    }


def ssm_train_path(dev, card) -> list[dict]:
    """The SSD backward kernels against their plain versions, then mamba2-780m
    training at full width through ``launch.train``, the kernels' step
    against the plain SSD's, a falling loss and one step's launches.
    Returns the two backward kernels' entries of the kernels line."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import (
        AdamW, cosine_schedule, global_norm, value_and_grad,
    )
    from repro_torch.train.step import init_train_state, make_train_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cfg = get("mamba2-780m")
    h, p, g, n, chunk = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                         cfg.ssm_state, cfg.ssm_chunk)
    from repro_torch.kernels import _build
    emit("build_ssd_bwd", nvidia_smi=card,
         ptxas=ptxas_kernels(_build.build_log.get("ssd_scan.cu", ""), "ssd_chunk_"))

    # -- 3. the backward kernels against their plain versions ------------------
    keep = {"gnext": (0, 1), "dinit": (0, 1), "dT": (0, 1), "dx": (0, 2),
            "dlog_a": (0, 2), "dB": (0, 2), "dC": (0, 2)}
    max_err = {"ssd_chunk_scan_bwd": 0.0, "ssd_chunk_state_bwd": 0.0}

    def summed(out):   # the scan backward's dB and dC slices added
        return out[0], out[1], out[2].sum(3), out[3].sum(3)

    for name, b, s, hh, pp, gg, nn, ch, init in SSD_BWD_CASES:
        x, la, bm, cm, h0 = ssd_inputs(gen, dev, b, s, hh, pp, gg, nn, init)
        dy = torch.randn((b, s, hh, pp), generator=gen, device=dev).to(torch.bfloat16)
        dfinal = torch.randn((b, hh, pp, nn), generator=gen, device=dev) if init else None
        q = min(ch, s)
        prev, _ = kssd.chunk_state(x, la, bm, chunk=ch, initial_state=h0)
        errs = {}
        got = kssd.chunk_state_bwd(dy, la, cm, prev, chunk=ch, dfinal=dfinal)
        state = kssd.chunk_state_bwd_plain(dy, la, cm, prev, q, dfinal)
        for part, a, w in zip(("gnext", "dinit", "dT"), got, state):
            errs["state_bwd " + part] = ((a - w).abs().max().item(),
                                         slab_rel_err(a, w, keep[part]))
        # the scan kernel on the plain state pass's outputs
        gnext, _, d_total = state
        got = kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy, gnext, d_total, chunk=ch)
        want = kssd.chunk_scan_bwd_plain(x, la, bm, cm, prev, dy, gnext, d_total, q)
        torch.cuda.synchronize()
        for part, a, w in zip(("dx", "dlog_a", "dB", "dC"), summed(got), summed(want)):
            errs["scan_bwd " + part] = ((a - w).abs().max().item(),
                                        slab_rel_err(a, w, keep[part]))
        for what, (err, rel) in errs.items():
            if not rel <= SSD_SLAB_REL_TOL:
                raise AssertionError(f"ssd backward {name} {what}: max |err| {err}, "
                                     f"per (b, h) {rel} > {SSD_SLAB_REL_TOL}")
            kernel = "ssd_chunk_" + what.split()[0]
            max_err[kernel] = max(max_err[kernel], err)
        slices = hh // kssd.bwd_heads_per_block(hh, gg) // gg
        bounds = {part: bound(*ssd_bwd_floor_ms(b, s, hh, pp, gg, nn, ch, part,
                                                dfinal=init, init=init, slices=slices))
                  for part in ("chunk_scan_bwd", "chunk_state_bwd", "function")}
        init_dtype = h0.dtype if init else None
        emit("kernel_check", kernel="ssd_scan_bwd", case=name,
             shape=[b, s, hh, pp, gg, nn, q], initial_state_and_dfinal=init,
             heads_per_block=kssd.bwd_heads_per_block(hh, gg), slices_per_group=slices,
             errors={k: {"max_abs_err": e, "max_bh_rel_err": r}
                     for k, (e, r) in errs.items()},
             bh_rel_tol=SSD_SLAB_REL_TOL,
             chunk_state_bwd_ms=time_ms(lambda: kssd.chunk_state_bwd(
                 dy, la, cm, prev, chunk=ch, dfinal=dfinal), 5),
             chunk_scan_bwd_ms=time_ms(lambda: kssd.chunk_scan_bwd(
                 x, la, bm, cm, prev, dy, gnext, d_total, chunk=ch), 5),
             backward_ms=time_ms(lambda: kssd.ssd_scan_bwd(
                 x, la, bm, cm, prev, dy, chunk=ch, dfinal=dfinal,
                 init_dtype=init_dtype), 5),
             chunk_state_bwd_plain_ms=time_ms(lambda: kssd.chunk_state_bwd_plain(
                 dy, la, cm, prev, q, dfinal), 2, 1),
             chunk_scan_bwd_plain_ms=time_ms(lambda: kssd.chunk_scan_bwd_plain(
                 x, la, bm, cm, prev, dy, gnext, d_total, q), 2, 1),
             backward_plain_ms=time_ms(lambda: kssd.ssd_scan_bwd_plain(
                 x, la, bm, cm, prev, dy, q, dfinal, h0), 2, 1),
             **{f"{part}_bound_ms": bd[0] for part, bd in bounds.items()},
             **{f"{part}_bound_by": bd[1] for part, bd in bounds.items()},
             library_ms=None, nvidia_smi=card)
        del x, la, bm, cm, h0, dy, dfinal, prev, got, want, state, gnext, d_total
    torch.cuda.empty_cache()

    # the backward's work in one mamba2-780m train step: one call of each
    # kernel per layer, and the whole backward (both kernels and the glue,
    # as SSDScan runs it) against the function's bound
    b, s = TRAIN_BATCH, TRAIN_SEQ
    mix = ssd_train_mix(cfg, gen, dev, b, s)
    emit("kernel_train_mix", kernel="ssd_scan_bwd", arch=cfg.name, layers=cfg.n_layers,
         shape=[b, s, h, p, g, n, chunk],
         slices_per_group=h // kssd.bwd_heads_per_block(h, g) // g, nvidia_smi=card,
         **mix)
    torch.cuda.empty_cache()

    kernels = path_kernels(cfg, backward=True)

    # -- 4. train: the main path, at full width and depth ----------------------
    torch.cuda.reset_peak_memory_stats()
    steps = SSM_TRAIN_WARMUP + SSM_TRAIN_TIMED
    reset_launches()
    out = train.main(["--arch", "mamba2-780m", "--steps", str(steps), "--batch", str(b),
                      "--seq", str(s), "--log-every", "1"])
    launches = launch_counts(kernels)
    if launches != step_launches(cfg, steps):
        raise AssertionError(f"mamba2 training launched {launches}, want "
                             f"{step_launches(cfg, steps)}")
    if out["steps_run"] != steps or not math.isfinite(out["loss"]):
        raise AssertionError(f"training ran {out['steps_run']} steps, loss {out['loss']}")
    step_s = float(np.median(out["step_seconds"][SSM_TRAIN_WARMUP:]))
    n_params, tokens = cfg.param_count(), b * s
    emit("train", arch=cfg.name, batch=b, seq=s, remat=cfg.remat,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         warmup_steps=SSM_TRAIN_WARMUP, step_seconds=out["step_seconds"],
         step_ms=step_s * 1e3, tokens_per_s=tokens / step_s, params=n_params,
         mfu_6nt=6 * n_params * tokens / (step_s * PEAK_BF16_FLOPS),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
         final_loss=out["loss"], final_grad_norm=out["grad_norm"], nvidia_smi=card)
    torch.cuda.empty_cache()

    # -- 5. correctness at full width ------------------------------------------
    # (a) the kernels' step against the plain SSD's, one step's loss and grads
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             make_stream(cfg, b, s, seed=0).batch_at(0).items()}
    pgen = torch.Generator(device=dev)
    pgen.manual_seed(0)
    params = tfm.init_params(cfg, pgen)

    def loss(prm, bt):
        return tfm.loss_fn(cfg, prm, bt)

    (k_loss, _), k_grads = value_and_grad(loss, params, batch)
    kernel = kssd.ssd_scan
    kssd.ssd_scan = kssd.ssd_scan_plain
    try:
        (p_loss, _), p_grads = value_and_grad(loss, params, batch)
    finally:
        kssd.ssd_scan = kernel
    with torch.no_grad():
        logit_std = tfm.forward(cfg, params, {"tokens": batch["tokens"][:1]}).float().std().item()
    k_norm, p_norm = global_norm(k_grads).item(), global_norm(p_grads).item()
    plain_flat = flatten(p_grads)
    agreement = {
        "loss": k_loss.item(), "plain_loss": p_loss.item(),
        "abs_loss_diff": abs(k_loss.item() - p_loss.item()), "logit_std": logit_std,
        "bound_abs_loss_diff": TRAIN_LOSS_STD_TOL * logit_std,
        "grad_norm": k_norm, "plain_grad_norm": p_norm,
        "grad_norm_rel_err": abs(k_norm - p_norm) / p_norm,
        "bound_grad_norm_rel_err": TRAIN_GNORM_REL_TOL,
        "leaf_max_abs_diff_over_max_abs_grad": {
            key: ((a - plain_flat[key]).abs().max()
                  / plain_flat[key].abs().max().clamp_min(1e-30)).item()
            for key, a in flatten(k_grads).items()},
    }
    emit("train_step_vs_plain_ssd", arch=cfg.name, batch=b, seq=s, **agreement)
    if not (agreement["abs_loss_diff"] <= agreement["bound_abs_loss_diff"]
            and agreement["grad_norm_rel_err"] <= TRAIN_GNORM_REL_TOL):
        raise AssertionError(f"kernel and plain SSD training steps disagree: {agreement}")
    del params, k_grads, p_grads
    torch.cuda.empty_cache()

    # (b) the loss falls on one repeated batch; (c) one step's launches
    opt = AdamW(schedule=cosine_schedule(1e-3, 1, LEARN_STEPS), weight_decay=0.0)
    pgen.manual_seed(1)
    state = init_train_state(cfg, opt, pgen)
    step = make_train_step(cfg, opt)
    losses = []
    for i in range(LEARN_STEPS):
        reset_launches()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            one_step = launch_counts(kernels)
    emit("train_learns", arch=cfg.name, steps=LEARN_STEPS, losses=losses,
         bound_last_over_first=LEARN_DROP, step_launches=one_step)
    if not losses[-1] < LEARN_DROP * losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if one_step != step_launches(cfg):
        raise AssertionError(f"one train step launched {one_step}, want "
                             f"{step_launches(cfg)} (the forward kernels twice a "
                             f"layer by the full remat, the backward kernels once)")

    # -- 6. profile: where the time of one train step goes --------------------
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit("profile_train_step", arch=cfg.name, batch=b, seq=s, nvidia_smi=card,
         **summarize(trace, wall, 1))
    del state, step, batch
    torch.cuda.empty_cache()

    return [{"name": "ssd_" + part, "path": "mamba2-780m train", "route": "cuda",
             "source": SSD_SOURCE, "replaces": SSD_BWD_REPLACES,
             "launches": launches["ssd_" + part], "design": SSD_BWD_DESIGN,
             **mix[part],
             "max_abs_err": max(max_err["ssd_" + part], mix[part]["max_abs_err"])}
            for part in ("chunk_scan_bwd", "chunk_state_bwd")]


def hymba_train_path(dev, card) -> list[dict]:
    """hymba-1.5b training: the backward kernels' calls of one train step,
    then training at full width and depth through ``launch.train`` (its
    memory reckoned first), the kernels' step against the plain versions'
    (flash attention and the SSD scan both), a falling loss, one step's
    launches and its profile.  Returns the backward kernels' entries of the
    kernels line."""
    from repro_torch.configs import get
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import train

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cfg = get("hymba-1.5b")
    kernels = path_kernels(cfg, backward=True)
    h, p, g, n, chunk = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                         cfg.ssm_state, cfg.ssm_chunk)
    b, s = TRAIN_BATCH, TRAIN_SEQ

    # -- 3. the backward kernels' calls of one train step, timed together ----
    fa_mix = fa_train_mix(cfg, gen, dev, b, s)
    emit("kernel_train_mix", kernel="flash_attention_bwd", arch=cfg.name,
         layers=cfg.n_layers, shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         window=cfg.window, nvidia_smi=card, **fa_mix)
    ssd_mix = ssd_train_mix(cfg, gen, dev, b, s)
    emit("kernel_train_mix", kernel="ssd_scan_bwd", arch=cfg.name, layers=cfg.n_layers,
         shape=[b, s, h, p, g, n, chunk],
         slices_per_group=h // kssd.bwd_heads_per_block(h, g) // g, nvidia_smi=card,
         **ssd_mix)
    torch.cuda.empty_cache()

    # -- 4. train: the main path, at full width and depth ----------------------
    reckoning = train_reckoning_gb(cfg, cfg.n_layers)
    emit("train_reckoning", arch=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
         largest_leaf=largest_leaf(cfg), budget_gb=TRAIN_BUDGET_GB, **reckoning)
    if reckoning["total_gb"] > TRAIN_BUDGET_GB:
        raise AssertionError(f"{cfg.name} at full depth needs {reckoning} > "
                             f"{TRAIN_BUDGET_GB} GB")
    torch.cuda.reset_peak_memory_stats()
    steps = HYMBA_TRAIN_WARMUP + HYMBA_TRAIN_TIMED
    reset_launches()
    out = train.main(["--arch", "hymba-1.5b", "--steps", str(steps), "--batch", str(b),
                      "--seq", str(s), "--log-every", "1"])
    launches = launch_counts(kernels)
    if launches != step_launches(cfg, steps):
        raise AssertionError(f"hymba training launched {launches}, want "
                             f"{step_launches(cfg, steps)}")
    if out["steps_run"] != steps or not math.isfinite(out["loss"]):
        raise AssertionError(f"training ran {out['steps_run']} steps, loss {out['loss']}")
    step_s = float(np.median(out["step_seconds"][HYMBA_TRAIN_WARMUP:]))
    n_params, tokens = cfg.param_count(), b * s
    emit("train", arch=cfg.name, batch=b, seq=s, remat=cfg.remat,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         loss_chunk=cfg.loss_chunk, warmup_steps=HYMBA_TRAIN_WARMUP,
         step_seconds=out["step_seconds"], step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s, params=n_params,
         mfu_6nt=6 * n_params * tokens / (step_s * PEAK_BF16_FLOPS),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
         final_loss=out["loss"], final_grad_norm=out["grad_norm"], nvidia_smi=card)
    torch.cuda.empty_cache()

    # -- 5, 6. correctness at full width and depth, and a profiled step -------
    train_checks(cfg, dev, card, kernels)

    path = "hymba-1.5b train"
    return [{"name": "flash_attention_bwd", "path": path, "route": "cuda",
             "source": FA_SOURCE, "replaces": FA_REPLACES,
             "launches": launches["flash_attention_bwd"], "design": FA_BWD_DESIGN,
             **fa_mix}] + [
        {"name": "ssd_" + part, "path": path, "route": "cuda", "source": SSD_SOURCE,
         "replaces": SSD_BWD_REPLACES, "launches": launches["ssd_" + part],
         "design": SSD_BWD_DESIGN, **ssd_mix[part]}
        for part in ("chunk_scan_bwd", "chunk_state_bwd")]


#: the dense configurations' training on one card: h2o-danube-1.8b at full
#: width and depth through launch.train (2 warm-up and 3 timed steps);
#: gemma-7b and deepseek-7b, which launch.train refuses on one card
DANUBE_TRAIN_WARMUP, DANUBE_TRAIN_TIMED = 2, 3
REFUSED_ON_ONE_CARD = ("gemma-7b", "deepseek-7b")


def dense_train_path(dev, card) -> list[dict]:
    """h2o-danube-1.8b training at full width and depth on one card: the
    backward kernel's calls of one train step timed together, its memory
    reckoned, ``launch.train.main`` on (4, 2048) batches (step ms,
    tokens/s, 6·N·T, peak; launches as step_launches), then train_checks
    (the kernels' step against the plain attention's, 8 steps on one batch
    in which the loss falls, one step's launches, a profiled step); then
    ``launch.train`` refusing REFUSED_ON_ONE_CARD before it allocates,
    naming their memory.  Returns the backward's entry of the kernels
    line."""
    from repro_torch.configs import get
    from repro_torch.launch import train
    from repro_torch.train.step import train_memory_gb

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    arch = "h2o-danube-1.8b"
    cfg = get(arch)
    kernels = path_kernels(cfg, backward=True)
    b, s = TRAIN_BATCH, TRAIN_SEQ

    # -- 3. the backward kernel's calls of one train step, timed together ----
    fa_mix = fa_train_mix(cfg, gen, dev, b, s)
    emit("kernel_train_mix", kernel="flash_attention_bwd", arch=cfg.name,
         layers=cfg.n_layers, shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         window=cfg.window, nvidia_smi=card, **fa_mix)
    torch.cuda.empty_cache()

    # -- 4. train: the main path, at full width and depth ----------------------
    reckoning = train_reckoning_gb(cfg, cfg.n_layers)
    emit("train_reckoning", arch=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
         largest_leaf=largest_leaf(cfg), budget_gb=TRAIN_BUDGET_GB, **reckoning)
    if reckoning["total_gb"] > TRAIN_BUDGET_GB:
        raise AssertionError(f"{cfg.name} at full depth needs {reckoning} > "
                             f"{TRAIN_BUDGET_GB} GB")
    torch.cuda.reset_peak_memory_stats()
    steps = DANUBE_TRAIN_WARMUP + DANUBE_TRAIN_TIMED
    reset_launches()
    out = train.main(["--arch", arch, "--steps", str(steps), "--batch", str(b),
                      "--seq", str(s), "--log-every", "1"])
    launches = launch_counts(kernels)
    if launches != step_launches(cfg, steps):
        raise AssertionError(f"{cfg.name} training launched {launches}, want "
                             f"{step_launches(cfg, steps)}")
    if out["steps_run"] != steps or not math.isfinite(out["loss"]):
        raise AssertionError(f"training ran {out['steps_run']} steps, loss {out['loss']}")
    step_s = float(np.median(out["step_seconds"][DANUBE_TRAIN_WARMUP:]))
    n_params, tokens = cfg.param_count(), b * s
    emit("train", arch=cfg.name, batch=b, seq=s, remat=cfg.remat,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         warmup_steps=DANUBE_TRAIN_WARMUP, step_seconds=out["step_seconds"],
         step_ms=step_s * 1e3, tokens_per_s=tokens / step_s, params=n_params,
         mfu_6nt=6 * n_params * tokens / (step_s * PEAK_BF16_FLOPS),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
         final_loss=out["loss"], final_grad_norm=out["grad_norm"], nvidia_smi=card)
    torch.cuda.empty_cache()

    # -- 5, 6. correctness at full width and depth, and a profiled step -------
    train_checks(cfg, dev, card, kernels)

    # -- the two that one card does not hold: refused before any allocation --
    for refused in REFUSED_ON_ONE_CARD:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        try:
            train.main(["--arch", refused, "--steps", "1"])
        except SystemExit as e:
            message = str(e)
        else:
            raise AssertionError(f"launch.train trained {refused} on one card")
        if "training needs" not in message or torch.cuda.memory_allocated() != before:
            raise AssertionError(f"launch.train's refusal of {refused}: {message!r}")
        emit("train_refused", arch=refused, message=message,
             reckoned=train_memory_gb(get(refused)), nvidia_smi=card)

    return [{"name": "flash_attention_bwd", "path": f"{cfg.name} train", "route": "cuda",
             "source": FA_SOURCE, "replaces": FA_REPLACES,
             "launches": launches["flash_attention_bwd"], "design": FA_BWD_DESIGN,
             **fa_mix}]


def hubert_train_path(dev, card) -> list[dict]:
    """hubert-xlarge training: the attention backward's 48 calls of one
    train step (bidirectional, D 80) timed together, its memory reckoned,
    then training at full width and depth through ``launch.train`` on
    (4, 2048) frame-embedding batches, the kernels' step against the plain
    attention's, a falling loss, one step's launches and its profile.
    Returns the backward's entry of the kernels line."""
    from repro_torch.configs import get
    from repro_torch.launch import train

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    cfg = get("hubert-xlarge")
    kernels = path_kernels(cfg, backward=True)
    b, s = TRAIN_BATCH, TRAIN_SEQ

    # -- 3. the backward kernel's calls of one train step, timed together ----
    fa_mix = fa_train_mix(cfg, gen, dev, b, s)
    emit("kernel_train_mix", kernel="flash_attention_bwd", arch=cfg.name,
         layers=cfg.n_layers, causal=cfg.causal,
         shape=[b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], nvidia_smi=card,
         **fa_mix)
    torch.cuda.empty_cache()

    # -- 4. train: the main path, at full width and depth ----------------------
    emit("train_reckoning", arch=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
         largest_leaf=largest_leaf(cfg), **train_reckoning_gb(cfg, cfg.n_layers))
    torch.cuda.reset_peak_memory_stats()
    steps = HUBERT_TRAIN_WARMUP + HUBERT_TRAIN_TIMED
    reset_launches()
    out = train.main(["--arch", "hubert-xlarge", "--steps", str(steps), "--batch", str(b),
                      "--seq", str(s), "--log-every", "1"])
    launches = launch_counts(kernels)
    if launches != step_launches(cfg, steps):
        raise AssertionError(f"hubert training launched {launches}, want "
                             f"{step_launches(cfg, steps)}")
    if out["steps_run"] != steps or not math.isfinite(out["loss"]):
        raise AssertionError(f"training ran {out['steps_run']} steps, loss {out['loss']}")
    step_s = float(np.median(out["step_seconds"][HUBERT_TRAIN_WARMUP:]))
    n_params, tokens = cfg.param_count(), b * s
    emit("train", arch=cfg.name, batch=b, seq=s, inputs="embeds", remat=cfg.remat,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         loss_chunk=cfg.loss_chunk, warmup_steps=HUBERT_TRAIN_WARMUP,
         step_seconds=out["step_seconds"], step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s, params=n_params,
         mfu_6nt=6 * n_params * tokens / (step_s * PEAK_BF16_FLOPS),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
         final_loss=out["loss"], final_grad_norm=out["grad_norm"], nvidia_smi=card)
    torch.cuda.empty_cache()

    # -- 5, 6. correctness at full width and depth, and a profiled step -------
    train_checks(cfg, dev, card, kernels)

    return [{"name": "flash_attention_bwd", "path": "hubert-xlarge train", "route": "cuda",
             "source": FA_SOURCE, "replaces": FA_REPLACES,
             "launches": launches["flash_attention_bwd"], "design": FA_BWD_DESIGN,
             **fa_mix}]


def moe_train_path(dev, card) -> list[dict]:
    """The MoE training slice: the grouped GEMM's dx and dw kernels against
    their plain versions, olmoe-1b-7b training at full width and a depth cut
    by memory (``init_train_state`` and ``make_train_step`` with
    ``launch.train``'s optimizer and schedule), the kernels' step against the
    plain grouped GEMM's with the routing replayed, a falling loss, one
    step's launches and its profile, then ``launch.train`` on a smoke MoE
    config on the card.  Returns dx's and dw's entries of the kernels line."""
    from repro_torch.bridge import flatten
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_gmm
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import (
        AdamW, cosine_schedule, global_norm, value_and_grad,
    )
    from repro_torch.train.step import init_train_state, make_train_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cfg, qcfg = get("olmoe-1b-7b"), get("qwen2-moe-a2.7b")
    d, f, e, k = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.top_k
    b, s = TRAIN_BATCH, TRAIN_SEQ
    rows, qrows = b * s * k, b * s * qcfg.top_k

    kernels = path_kernels(cfg, backward=True)

    # -- 3. dx and dw against their plain versions ----------------------------
    # (ptxas of the forward, dx and dw kernels, from this run's build)
    emit("build_grouped_matmul", nvidia_smi=card,
         ptxas=ptxas_kernels(_build.build_log.get("moe_gmm.cu", ""), "grouped_matmul"))
    cases = [  # name, T, d, f, E, group sizes, top-k of the routing
        ("olmoe-1b-7b gate/up", rows, d, f, e, "route", k),
        ("olmoe-1b-7b down", rows, f, d, e, "route", k),
        ("qwen2-moe-a2.7b gate/up (f 1408: 5.5 column tiles)", qrows,
         qcfg.d_model, qcfg.moe_d_ff, qcfg.n_experts, "route", qcfg.top_k),
        ("qwen2-moe-a2.7b down", qrows, qcfg.moe_d_ff, qcfg.d_model,
         qcfg.n_experts, "route", qcfg.top_k),
        ("all rows in one expert", 4096, d, f, e, "one", k),
        ("1000 rows: groups off 64-row steps, empty experts", 1000, d, f, e, "random", k),
        ("one row", 1, d, f, e, "random", k),
    ]
    max_err = {"dx": 0.0, "dw": 0.0}
    for name, t, dd, ff, ee, kind, kk in cases:
        x = torch.randn((t, dd), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((ee, dd, ff), generator=gen, device=dev) * 0.02
             ).to(torch.bfloat16)
        dy = torch.randn((t, ff), generator=gen, device=dev).to(torch.bfloat16)
        sizes = gmm_case_sizes(gen, dev, t, ee, kind, kk)
        dx = moe_gmm.grouped_matmul_dx(dy, w, sizes)
        # a NaN-filled buffer: an element the kernel skipped shows
        dw = moe_gmm.grouped_matmul_dw(x, dy, sizes, out=torch.full(
            (ee, dd, ff), float("nan"), dtype=torch.bfloat16, device=dev))
        want_dx = moe_gmm.grouped_matmul_dx_plain(dy, w, sizes)
        want_dw = moe_gmm.grouped_matmul_dw_plain(x, dy, sizes)
        torch.cuda.synchronize()
        errs = {"dx": gmm_errors(dx, want_dx), "dw": dw_errors(dw, want_dw, sizes)}
        nonempty = int((sizes > 0).sum())
        floors = {"dx": gmm_floor_ms(t, ff, dd, nonempty),
                  "dw": gmm_dw_floor_ms(t, dd, ff, ee)}
        calls = {"dx": (lambda: moe_gmm.grouped_matmul_dx(dy, w, sizes),
                        lambda: moe_gmm.grouped_matmul_dx_plain(dy, w, sizes)),
                 "dw": (lambda: moe_gmm.grouped_matmul_dw(x, dy, sizes),
                        lambda: moe_gmm.grouped_matmul_dw_plain(x, dy, sizes))}
        libs = {"dx": grouped_mm_call(dy, w.transpose(1, 2), sizes),
                "dw": grouped_mm_call(x.t(), dy, sizes)}
        for part in ("dx", "dw"):
            max_err[part] = max(max_err[part], errs[part]["max_abs_err"])
            bound_ms, bound_by = bound(*floors[part])
            lib, no_lib = libs[part]
            emit("kernel_check", kernel=f"grouped_matmul_{part}", case=name,
                 shape=[t, dd, ff, ee], nonempty_experts=nonempty,
                 largest_group=int(sizes.max()), row_tiles=gmm_row_tiles(sizes),
                 **errs[part], tol=GMM_TOL if part == "dx" else GMM_DW_SLAB_TOL,
                 ms=time_ms(calls[part][0], 20),
                 plain_ms=time_ms(calls[part][1], 3, 1),
                 library_ms=time_ms(lib, 20) if lib else None,
                 library=no_lib or "torch._grouped_mm",
                 bound_ms=bound_ms, bound_by=bound_by, nvidia_smi=card)
        del x, w, dy, dx, dw, want_dx, want_dw, calls, libs
    torch.cuda.empty_cache()

    # -- 4. train: full width, the depth the memory allows ---------------------
    reckoning = {layers: train_reckoning_gb(cfg, layers) for layers in MOE_TRAIN_DEPTHS}
    steps = MOE_TRAIN_WARMUP + MOE_TRAIN_TIMED
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))   # launch.train's defaults
    stream = make_stream(cfg, b, s, seed=0)
    batches = [{key: torch.from_numpy(v).to(dev) for key, v in
                stream.batch_at(i).items()} for i in range(steps)]
    pgen = torch.Generator(device=dev)
    first = train_depth(cfg, TRAIN_BUDGET_GB, MOE_TRAIN_DEPTHS)
    for layers in MOE_TRAIN_DEPTHS[MOE_TRAIN_DEPTHS.index(first):]:
        mcfg = cut_depth(cfg, layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pgen.manual_seed(0)
        state = init_train_state(mcfg, opt, pgen)
        step = make_train_step(mcfg, opt)
        torch.cuda.synchronize()
        reset_launches()
        times, losses = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))     # waits for the step
            times.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = launch_counts(kernels)
        del state, step, metrics
        if peak_gb <= TRAIN_BUDGET_GB or layers == MOE_TRAIN_DEPTHS[-1]:
            break
        emit("train_depth_over_budget", arch=cfg.name, layers=layers,
             peak_mem_gb=peak_gb, budget_gb=TRAIN_BUDGET_GB)
    want = step_launches(mcfg, steps)
    if launches != want:
        raise AssertionError(f"{mcfg.name} training launched {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{mcfg.name} training losses {losses}")
    if peak_gb > TRAIN_BUDGET_GB:
        raise AssertionError(f"{mcfg.name} at {layers} layers peaks at {peak_gb} GB "
                             f"> {TRAIN_BUDGET_GB}")
    step_s = float(np.median(times[MOE_TRAIN_WARMUP:]))
    n_active, tokens = active_params(mcfg), b * s
    emit("train", arch=cfg.name, layers=f"{layers} of {cfg.n_layers}",
         reckoning_by_layers=reckoning, budget_gb=TRAIN_BUDGET_GB,
         batch=b, seq=s, remat=mcfg.remat, moe_dispatch=mcfg.moe_dispatch,
         param_dtype=mcfg.param_dtype, compute_dtype=mcfg.compute_dtype,
         warmup_steps=MOE_TRAIN_WARMUP, step_seconds=times, step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s, params=mcfg.param_count(),
         active_params=n_active,
         mfu_6nt=6 * n_active * tokens / (step_s * PEAK_BF16_FLOPS),
         peak_mem_gb=peak_gb, launches=launches, losses=losses, nvidia_smi=card)
    torch.cuda.empty_cache()

    # -- 5. correctness at full width ------------------------------------------
    # (a) the kernels' gradient against the plain grouped GEMM's, one step's,
    # the plain run choosing the experts the kernels' run chose (a near-tie
    # may flip the routing: ROADMAP C7) with its own differentiable router
    # probabilities; then the plain run routing freely, reported only
    batch = batches[0]
    pgen.manual_seed(0)
    params = tfm.init_params(mcfg, pgen)

    def loss(p, bt):
        return tfm.loss_fn(mcfg, p, bt)

    with recorded_choices(moe) as choices:
        (k_loss, _), k_grads = value_and_grad(loss, params, batch)
    kernel = moe_gmm.grouped_matmul
    moe_gmm.grouped_matmul = moe_gmm.grouped_matmul_plain
    try:
        with replayed_choices(moe, choices):
            (p_loss, _), p_grads = value_and_grad(loss, params, batch)
        k_norm, p_norm = global_norm(k_grads).item(), global_norm(p_grads).item()
        plain_flat = flatten(p_grads)
        leaf_rel = {key: ((a - plain_flat[key]).abs().max()
                          / plain_flat[key].abs().max().clamp_min(1e-30)).item()
                    for key, a in flatten(k_grads).items()}
        del p_grads, plain_flat
        (f_loss, _), f_grads = value_and_grad(loss, params, batch)
        f_norm = global_norm(f_grads).item()
        del f_grads
    finally:
        moe_gmm.grouped_matmul = kernel
    with torch.no_grad():
        logit_std = tfm.forward(mcfg, params, {"tokens": batch["tokens"][:1]}
                                ).float().std().item()
    agreement = {
        "loss": k_loss.item(), "plain_loss": p_loss.item(),
        "abs_loss_diff": abs(k_loss.item() - p_loss.item()), "logit_std": logit_std,
        "bound_abs_loss_diff": TRAIN_LOSS_STD_TOL * logit_std,
        "grad_norm": k_norm, "plain_grad_norm": p_norm,
        "grad_norm_rel_err": abs(k_norm - p_norm) / p_norm,
        "bound_grad_norm_rel_err": TRAIN_GNORM_REL_TOL,
        "leaf_max_abs_diff_over_max_abs_grad": leaf_rel,
        "free_routing": {"plain_loss": f_loss.item(),
                         "abs_loss_diff": abs(k_loss.item() - f_loss.item()),
                         "plain_grad_norm": f_norm,
                         "grad_norm_rel_err": abs(k_norm - f_norm) / f_norm},
    }
    emit("train_step_vs_plain_gmm", arch=cfg.name, layers=layers, batch=b, seq=s,
         routing="replayed", routing_calls=len(choices), **agreement)
    if not (agreement["abs_loss_diff"] <= agreement["bound_abs_loss_diff"]
            and agreement["grad_norm_rel_err"] <= TRAIN_GNORM_REL_TOL):
        raise AssertionError(f"kernel and plain training steps disagree: {agreement}")
    del params, k_grads, choices
    torch.cuda.empty_cache()

    # (b) the loss falls on one repeated batch; (c) one step's launches
    opt = AdamW(schedule=cosine_schedule(1e-3, 1, LEARN_STEPS), weight_decay=0.0)
    pgen.manual_seed(1)
    state = init_train_state(mcfg, opt, pgen)
    step = make_train_step(mcfg, opt)
    losses = []
    for i in range(LEARN_STEPS):
        reset_launches()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            one_step = launch_counts(kernels)
    emit("train_learns", arch=cfg.name, layers=layers, steps=LEARN_STEPS,
         losses=losses, bound_last_over_first=LEARN_DROP, step_launches=one_step)
    if not losses[-1] < LEARN_DROP * losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if one_step != step_launches(mcfg):
        raise AssertionError(f"one train step launched {one_step}, want "
                             f"{step_launches(mcfg)}")

    # -- 6. profile: where the time of one train step goes --------------------
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit("profile_train_step", arch=cfg.name, layers=layers, batch=b, seq=s,
         nvidia_smi=card, **summarize(trace, wall, 1))
    del state, step, metrics, batches, batch
    torch.cuda.empty_cache()

    # -- the dx and dw calls of one train step: gate, up and down a layer ----
    sizes = moe_group_sizes(gen, dev, b * s, e, k)
    nonempty = int((sizes > 0).sum())
    x = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    hid = torch.randn((rows, f), generator=gen, device=dev).to(torch.bfloat16)
    w_in = (torch.randn((e, d, f), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    w_down = (torch.randn((e, f, d), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    # (x, w, dy) of each product; gate and up share x and their shapes
    calls = [(x, w_in, hid), (x, w_in, hid), (hid, w_down, x)] * layers
    entries = []
    for part, kernel_fn, plain_fn in (
            ("dx", lambda a, w, g: moe_gmm.grouped_matmul_dx(g, w, sizes),
             lambda a, w, g: moe_gmm.grouped_matmul_dx_plain(g, w, sizes)),
            ("dw", lambda a, w, g: moe_gmm.grouped_matmul_dw(a, g, sizes),
             lambda a, w, g: moe_gmm.grouped_matmul_dw_plain(a, g, sizes))):
        floors = [gmm_floor_ms(rows, w.shape[2], w.shape[1], nonempty) if part == "dx"
                  else gmm_dw_floor_ms(rows, w.shape[1], w.shape[2], e)
                  for _, w, _ in calls]
        mix_bound_ms, mix_bound_by = bound(sum(fl[0] for fl in floors),
                                           sum(fl[1] for fl in floors))
        libs = [grouped_mm_call(g, w.transpose(1, 2), sizes) if part == "dx"
                else grouped_mm_call(a.t(), g, sizes) for a, w, g in calls[:3]]
        no_lib = next((why for call, why in libs if call is None), None)
        dense = [gmm_dense_call(part, a, w, g) for a, w, g in calls[:3]]
        mix = {
            "ms": time_ms(lambda: [kernel_fn(*c) for c in calls], 5),
            "plain_ms": time_ms(lambda: [plain_fn(*c) for c in calls], 1, 1),
            "library_ms": (None if no_lib else
                           time_ms(lambda: [call() for call, _ in libs * layers], 5)),
            "bound_ms": mix_bound_ms, "bound_by": mix_bound_by,
        }
        emit("kernel_train_mix", kernel=f"grouped_matmul_{part}", calls=len(calls),
             layers=layers, shape=[rows, d, f, e], nonempty_experts=nonempty,
             library=no_lib or "torch._grouped_mm",
             dense_matmul_ms=time_ms(lambda: [c() for c in dense * layers], 5),
             nvidia_smi=card, **mix)
        entries.append({
            "name": f"grouped_matmul_{part}", "path": f"olmoe-1b-7b train ({layers} layers)",
            "route": "cuda", "source": GMM_SOURCE,
            "replaces": GMM_BWD_REPLACES, "design": GMM_BWD_DESIGN,
            "launches": launches[f"grouped_matmul_{part}"],
            "max_abs_err": max_err[part], **mix})
        del libs, dense
    del x, hid, w_in, w_down, calls
    torch.cuda.empty_cache()

    # -- launch.train on the card, smoke config --------------------------------
    reset_launches()
    out = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cuda",
                      "--steps", "3"])
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    emit("launch_train", arch="olmoe-1b-7b", smoke=True, steps=out["steps_run"],
         loss=out["loss"], launches=launches)
    if out["steps_run"] != 3 or not math.isfinite(out["loss"]) or (
            launches["grouped_matmul_dw"] == 0):
        raise AssertionError(f"launch.train on the smoke MoE config: {out}, {launches}")
    return entries


def gang_path(dev, card) -> None:
    """The gang trainer: gemma3-1b at full width, two members with their own
    lr in one batched run against each member alone (the same core with
    M = 1): the losses of every step agree and the flash-attention launches
    a step do not grow with M; then a smoke-size mamba2 gang, so that the
    SSD scan's vmap rule launches its kernels, a smoke-size olmoe gang, so
    that the grouped GEMM's rule folds the members into its experts, and a
    smoke-size hymba gang, whose layers run both the attention's and the
    SSD scan's rules inside one checkpoint."""
    from repro_torch.configs import get
    from repro_torch.train import ensemble

    for cfg, batch, seq in ((get(GANG_ARCH), GANG_BATCH, GANG_SEQ),
                            (card_smoke("mamba2-780m"), 2, 64),
                            (card_smoke("olmoe-1b-7b"), 2, 64),
                            (card_smoke("hymba-1.5b"), 2, 64)):
        kernels = path_kernels(cfg, backward=True)
        runs = {}
        for members in ((0,), (1,), (0, 1)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params, tokens = ensemble.init_members(cfg, members, GANG_STEPS, batch,
                                                   seq, dev)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            losses = ensemble.train_gang(cfg, params, tokens,
                                         [GANG_LRS[i] for i in members],
                                         warmup=max(1, GANG_STEPS // 10))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launch_counts(kernels)
            runs[members] = {
                "losses": losses.float().cpu().T.tolist(),
                "launches_per_step": {k: v / GANG_STEPS for k, v in counts.items()},
                "step_ms": seconds / GANG_STEPS * 1e3,
                "tokens_per_s": len(members) * batch * seq * GANG_STEPS / seconds,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            }
            del params, tokens, losses
        gang = runs[(0, 1)]
        rel = [abs(a - b) / abs(b) for i in (0, 1)
               for a, b in zip(gang["losses"][i], runs[(i,)]["losses"][0])]
        emit("gang", arch=cfg.name, members=2, lrs=list(GANG_LRS), batch=batch,
             seq=seq, steps=GANG_STEPS,
             runs={"+".join(map(str, m)): r for m, r in runs.items()},
             max_loss_rel_diff_vs_alone=max(rel), bound_loss_rel_diff=GANG_LOSS_REL_TOL,
             nvidia_smi=card)
        if not max(rel) <= GANG_LOSS_REL_TOL:
            raise AssertionError(f"{cfg.name}: the gang's losses differ from each "
                                 f"member's alone by {max(rel)} > {GANG_LOSS_REL_TOL}")
        one = runs[(0,)]["launches_per_step"]
        if gang["launches_per_step"] != one or not all(one.values()):
            raise AssertionError(f"{cfg.name}: launches a step {gang['launches_per_step']} "
                                 f"for 2 members, {one} for one")
        torch.cuda.empty_cache()
    # where the time of a one-step gang of two gemma3-1b members goes (the
    # optimizer state's allocation included)
    cfg = get(GANG_ARCH)
    params, tokens = ensemble.init_members(cfg, (0, 1), 1, GANG_BATCH, GANG_SEQ, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        ensemble.train_gang(cfg, params, tokens, list(GANG_LRS), warmup=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit("profile_gang_step", arch=cfg.name, members=2, batch=GANG_BATCH,
         seq=GANG_SEQ, nvidia_smi=card, **summarize(trace, wall, 1))
    del params, tokens
    torch.cuda.empty_cache()


#: the mesh step at data 1 against the step without a mesh: the same
#: arithmetic on the same state and batch (a sum over one rank is the
#: value, ZeRO-1's one shard is the whole leaf), so the same bits
MESH_STEP_TOL = 0.0
#: pairs of steps with and without the mesh, in turns, in phase (a)
MESH_TURNS = 4
#: olmoe-1b-7b's layers in the mesh section's train step (as
#: MOE_TRAIN_DEPTHS' last: 4 of 16 hold ~52 GB at 4 x 2048)
MESH_MOE_TRAIN_LAYERS = 4
#: moe_sorted_local's capacity factor (the reference's default)
SORTED_CAPACITY_FACTOR = 1.25


def sorted_local_capacity(tokens: int, top_k: int, n_experts: int) -> int:
    """moe_sorted_local's slots an expert, Cl: T·K·1.25 / E rounded up to a
    multiple of 128, at least 128."""
    cl = int(tokens * top_k * SORTED_CAPACITY_FACTOR / n_experts)
    return max(128, ((cl + 127) // 128) * 128)


def equal_gmm_floor_ms(part: str, rows: int, d: int, f: int,
                       experts: int) -> tuple[float, float]:
    """(ms for its operations, ms for its bytes) of one product of
    moe_sorted_local, every expert's group ``rows`` / E slots (the padded
    slots are rows the function computes): the forward (E, Cl, d)·(E, d, f)
    and dx as :func:`gmm_floor_ms` with every expert non-empty, dw as
    :func:`gmm_dw_floor_ms`."""
    if part == "dw":
        return gmm_dw_floor_ms(rows, d, f, experts)
    if part == "dx":
        return gmm_floor_ms(rows, f, d, experts)
    return gmm_floor_ms(rows, d, f, experts)


def mesh_dp_path(dev, card, fwd_entry: dict, bwd_entry: dict
                 ) -> tuple[list[dict], float]:
    """Phase (a): gemma3-1b at full width and depth through
    ``launch.train`` on the one-rank NCCL mesh (parameters replicated, the
    ZeRO-1 shards whole), one step against ``make_train_step`` without a
    mesh on the same state and batch (loss, grad_norm and every parameter
    within MESH_STEP_TOL), then timed steps of the same mesh step,
    MESH_TURNS pairs of it and the step without a mesh on the same tensors
    in turns, and one under the profiler (its NCCL time).  Returns the flash-attention entries
    of the path, timed at its shapes by the gemma3-1b paths
    (``fwd_entry``, ``bwd_entry``), and the timed steps' peak memory (GB)."""
    import torch.distributed as dist
    from repro_torch.bridge import flatten
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = get("gemma3-1b")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    argv = ["--arch", "gemma3-1b", "--steps", "1", "--batch", str(b), "--seq", str(s),
            "--log-every", "1"]
    # the step without a mesh: launch.train's seed, optimizer and first batch
    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, opt, gen)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_stream(cfg, b, s, seed=0).batch_at(0).items()}
    state, metrics = make_train_step(cfg, opt)(state, batch)
    want = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
    want_params = {k: v.detach().cpu() for k, v in flatten(state["params"]).items()}
    del state, metrics
    torch.cuda.empty_cache()

    mesh = make_local_mesh()        # the group: launch.train reuses it
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out, mstate = train.run(argv)
        launches = launch_counts(("flash_attention", "flash_attention_bwd"))
        got_params = flatten(mstate["params"])
        diffs = {k: (got_params[k].to_local().detach().cpu() - w).abs().max().item()
                 for k, w in want_params.items()}
        agreement = {"loss": out["loss"], "no_mesh_loss": want["loss"],
                     "grad_norm": out["grad_norm"],
                     "no_mesh_grad_norm": want["grad_norm"],
                     "max_param_abs_diff": max(diffs.values()),
                     "leaves": len(diffs), "tol": MESH_STEP_TOL}
        emit("mesh_train_vs_no_mesh", arch=cfg.name, batch=b, seq=s,
             mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
             backend=dist.get_backend(), launches=launches, **agreement)
        if not (abs(out["loss"] - want["loss"]) <= MESH_STEP_TOL
                and abs(out["grad_norm"] - want["grad_norm"]) <= MESH_STEP_TOL
                and agreement["max_param_abs_diff"] <= MESH_STEP_TOL):
            raise AssertionError(f"the mesh step differs from the step without "
                                 f"one: {agreement}")
        if launches != {"flash_attention": 2 * cfg.n_layers,
                        "flash_attention_bwd": cfg.n_layers}:
            raise AssertionError(f"the mesh step launched {launches}")
        del want_params, got_params

        # timed steps of the same step on the same mesh, then one profiled
        step = make_train_step(cfg, AdamW(schedule=cosine_schedule(3e-4, 20, 100)))
        stream = iter(make_stream(cfg, b, s, seed=1))
        times = []
        torch.cuda.reset_peak_memory_stats()
        with mesh_ctx.set_mesh(mesh):
            for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
                bt = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
                t0 = time.perf_counter()
                mstate, metrics = step(mstate, bt)
                float(metrics["loss"])
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 1e9
            # the mesh's own cost on one rank: the same step without the mesh
            # on the same tensors (the local tensors are the whole leaves),
            # in turns
            plain_state = tree_map(shd.local, mstate)
            turns = {"mesh": [], "no_mesh": []}
            for i in range(MESH_TURNS):
                for kind in (("mesh", "no_mesh") if i % 2 == 0 else ("no_mesh", "mesh")):
                    t0 = time.perf_counter()
                    if kind == "mesh":
                        mstate, metrics = step(mstate, bt)
                    else:
                        plain_state, metrics = step(plain_state, bt)
                    float(metrics["loss"])
                    turns[kind].append(time.perf_counter() - t0)
            del plain_state
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
                t0 = time.perf_counter()
                mstate, metrics = step(mstate, bt)
                float(metrics["loss"])
                wall = time.perf_counter() - t0
        nccl_ms = sum((e.time_range.end - e.time_range.start) / 1e3
                      for e in trace.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "nccl" in e.name.lower())
        step_s = float(np.median(times[TRAIN_WARMUP:]))
        tokens = b * s
        emit("mesh_train", arch=cfg.name, batch=b, seq=s, data=mesh.size(0),
             step_seconds=times, step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
             mfu_6nt=6 * cfg.param_count() * tokens / (step_s * PEAK_BF16_FLOPS),
             peak_mem_gb=peak, nccl_device_ms=nccl_ms, nvidia_smi=card,
             turns_ms={k: [t * 1e3 for t in v] for k, v in turns.items()},
             turns_median_ms={k: float(np.median(v)) * 1e3 for k, v in turns.items()},
             **summarize(trace, wall, 1))
        del mstate, step
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    path = "gemma3-1b DP train (launch.train, one-rank mesh)"
    return [{**fwd_entry, "path": path, "launches": launches["flash_attention"]},
            {**bwd_entry, "path": path, "launches": launches["flash_attention_bwd"]}], peak


def mesh_moe_path(dev, card) -> list[dict]:
    """Phase (b): olmoe-1b-7b with the ragged dispatch under the one-rank
    mesh: ``moe_ragged_sharded`` → ``moe_sorted_local`` → the grouped GEMM
    with every group size Cl.  A prefill at full width and depth from the
    serving init (4 x 2048; 48 launches; ``dropped``), the forward against
    the same with the GEMM's plain version (the routing and agreement gates
    of the olmoe path), the 48 calls at the equal-size shape against one
    ``torch.bmm`` each and the bound; then a train step at
    MESH_MOE_TRAIN_LAYERS layers (the forward GEMMs twice a layer by the
    remat, dx and dw), its dx and dw calls timed the same way.  Returns the
    grouped GEMM's three entries for this path."""
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.kernels import moe_gmm
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model, moe, synthetic_batch, transformer
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get("olmoe-1b-7b", moe_dispatch="ragged")
    b, s = PREFILL_BATCH, PREFILL_SEQ
    d, f, e, k, n_layers = (cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.top_k,
                            cfg.n_layers)
    cl = sorted_local_capacity(b * s, k, e)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    mesh = make_local_mesh()
    entries = []
    try:
        with mesh_ctx.set_mesh(mesh):
            model = Model(cfg, dev)
            params = model.init(seed=0, serving=True)
            inputs = model_inputs(synthetic_batch(cfg, b, s, gen, dev))
            reset_launches()
            with torch.inference_mode(), recorded_choices(moe) as choices:
                logits = model.forward(params, inputs)
            torch.cuda.synchronize()
            main_launches = launch_counts(("grouped_matmul",))["grouped_matmul"]
            # each layer's busiest expert against the mean load (Cl is 1.25x it)
            loads = [torch.bincount(c.reshape(-1), minlength=e).float() for c in choices]
            busiest = [(ld.max() / ld.mean()).item() for ld in loads]
            if main_launches != 3 * n_layers:
                raise AssertionError(f"the mesh prefill launched grouped_matmul "
                                     f"{main_launches} times, want {3 * n_layers}")
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("the mesh prefill's logits are not finite")
            del logits
            prefill_s, runs = timed_forward(model, params, inputs)
            with torch.inference_mode():
                _, aux = transformer.backbone(cfg, params, inputs)
            emit("mesh_prefill", arch=cfg.name, moe_dispatch=cfg.moe_dispatch,
                 path="moe_ragged_sharded -> moe_sorted_local", batch=b, seq=s,
                 slots_per_expert=cl, grouped_matmul_launches=main_launches,
                 dropped_mean_over_layers=aux["dropped"].item() / n_layers,
                 busiest_expert_over_mean_load=busiest,
                 prefill_ms=prefill_s * 1e3, runs_ms=[t * 1e3 for t in runs],
                 tokens_per_s=b * s / prefill_s, nvidia_smi=card)
            toks = synthetic_batch(cfg, 1, MOE_PLAIN_CHECK_SEQ, gen, dev)
            out = forward_vs_plain_gmm(model, params, toks, n_layers, k)
            emit("mesh_forward_vs_plain_gmm", arch=cfg.name,
                 moe_dispatch=cfg.moe_dispatch, seq=MOE_PLAIN_CHECK_SEQ,
                 slots_per_expert=sorted_local_capacity(MOE_PLAIN_CHECK_SEQ, k, e),
                 routing=out["routing"], same_routing=out["same_routing"], **out["free"])
            require_agreement(out["free"])
            require_agreement(out["same_routing"])
            del params, model, inputs, toks
            torch.cuda.empty_cache()

            # the 48 products of a prefill at moe_sorted_local's shape
            rows = e * cl
            sizes = torch.full((e,), cl, dtype=torch.int32, device=dev)
            x = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
            hid = torch.randn((rows, f), generator=gen, device=dev).to(torch.bfloat16)
            w_in = (torch.randn((e, d, f), generator=gen, device=dev) * 0.02
                    ).to(torch.bfloat16)
            w_down = (torch.randn((e, f, d), generator=gen, device=dev) * 0.02
                      ).to(torch.bfloat16)
            layer = [(x, w_in), (x, w_in), (hid, w_down)]
            errs = [gmm_errors(moe_gmm.grouped_matmul(a, w, sizes),
                               moe_gmm.grouped_matmul_plain(a, w, sizes))
                    for a, w in layer[1:]]
            calls = layer * n_layers
            floors = [equal_gmm_floor_ms("fwd", rows, a.shape[1], w.shape[2], e)
                      for a, w in calls]
            fwd = {"max_abs_err": max(er["max_abs_err"] for er in errs),
                   "ms": time_ms(lambda: [moe_gmm.grouped_matmul(a, w, sizes)
                                          for a, w in calls], 5),
                   "plain_ms": time_ms(lambda: [moe_gmm.grouped_matmul_plain(a, w, sizes)
                                                for a, w in calls], 1, 1),
                   "library_ms": time_ms(lambda: [torch.bmm(a.view(e, cl, -1), w)
                                                  for a, w in calls], 5)}
            fwd["bound_ms"], fwd["bound_by"] = bound(sum(fl[0] for fl in floors),
                                                     sum(fl[1] for fl in floors))
            emit("kernel_mesh_mix", kernel="grouped_matmul", calls=len(calls),
                 shape=[e, cl, d, f], group_sizes="every expert Cl",
                 errors=errs, library="torch.bmm", nvidia_smi=card, **fwd)
            entries.append({"name": "grouped_matmul", "route": "cuda",
                            "path": "olmoe-1b-7b ragged prefill (mesh: moe_sorted_local)",
                            "source": GMM_SOURCE, "replaces": GMM_REPLACES,
                            "launches": main_launches, **fwd})

            # a train step at MESH_MOE_TRAIN_LAYERS layers: dx and dw
            cut = cut_depth(cfg, MESH_MOE_TRAIN_LAYERS)
            opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
            state = init_train_state(cut, opt, gen, mesh)
            step = make_train_step(cut, opt)
            stream = iter(make_stream(cut, TRAIN_BATCH, TRAIN_SEQ, seed=0))
            times, losses = [], []
            torch.cuda.reset_peak_memory_stats()
            for i in range(3):
                bt = {kk: torch.from_numpy(v).to(dev) for kk, v in next(stream).items()}
                if i == 0:
                    reset_launches()
                t0 = time.perf_counter()
                state, metrics = step(state, bt)
                losses.append(float(metrics["loss"]))
                times.append(time.perf_counter() - t0)
                if i == 0:
                    step_launches = launch_counts(("grouped_matmul", "grouped_matmul_dx",
                                                   "grouped_matmul_dw"))
                    dropped = float(metrics["dropped"]) / MESH_MOE_TRAIN_LAYERS
            want = {"grouped_matmul": 6 * MESH_MOE_TRAIN_LAYERS,
                    "grouped_matmul_dx": 3 * MESH_MOE_TRAIN_LAYERS,
                    "grouped_matmul_dw": 3 * MESH_MOE_TRAIN_LAYERS}
            emit("mesh_moe_train", arch=cut.name, layers=MESH_MOE_TRAIN_LAYERS,
                 batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses, step_seconds=times,
                 step_ms=times[-1] * 1e3, launches=step_launches,
                 dropped_mean_over_layers=dropped,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=card)
            if step_launches != want or not all(map(math.isfinite, losses)):
                raise AssertionError(f"the mesh MoE train step launched "
                                     f"{step_launches} (want {want}), losses {losses}")
            del state, step
            torch.cuda.empty_cache()

            # its dx and dw calls at the equal-size shape
            dy_in = torch.randn((rows, f), generator=gen, device=dev).to(torch.bfloat16)
            dy_down = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
            bwd_calls = [(dy_in, x, w_in), (dy_in, x, w_in),
                         (dy_down, hid, w_down)] * MESH_MOE_TRAIN_LAYERS
            for part in ("dx", "dw"):
                if part == "dx":
                    kernel = lambda dy, a, w: moe_gmm.grouped_matmul_dx(dy, w, sizes)  # noqa: E731
                    plain = lambda dy, a, w: moe_gmm.grouped_matmul_dx_plain(dy, w, sizes)  # noqa: E731
                    lib = lambda dy, a, w: torch.bmm(dy.view(e, cl, -1), w.mT)  # noqa: E731
                else:
                    kernel = lambda dy, a, w: moe_gmm.grouped_matmul_dw(a, dy, sizes)  # noqa: E731
                    plain = lambda dy, a, w: moe_gmm.grouped_matmul_dw_plain(a, dy, sizes)  # noqa: E731
                    lib = lambda dy, a, w: torch.bmm(a.view(e, cl, -1).mT,  # noqa: E731
                                                     dy.view(e, cl, -1))
                part_errs = []
                for dy, a, w in bwd_calls[:3:2]:
                    got, want_t = kernel(dy, a, w), plain(dy, a, w)
                    part_errs.append(dw_errors(got, want_t, sizes) if part == "dw"
                                     else gmm_errors(got, want_t))
                floors = [equal_gmm_floor_ms(part, rows, a.shape[1], w.shape[2], e)
                          for dy, a, w in bwd_calls]
                mix = {"max_abs_err": max(er["max_abs_err"] for er in part_errs),
                       "ms": time_ms(lambda: [kernel(*c) for c in bwd_calls], 5),
                       "plain_ms": time_ms(lambda: [plain(*c) for c in bwd_calls], 1, 1),
                       "library_ms": time_ms(lambda: [lib(*c) for c in bwd_calls], 5)}
                mix["bound_ms"], mix["bound_by"] = bound(sum(fl[0] for fl in floors),
                                                         sum(fl[1] for fl in floors))
                emit("kernel_mesh_train_mix", kernel=f"grouped_matmul_{part}",
                     calls=len(bwd_calls), shape=[e, cl, d, f], errors=part_errs,
                     library="torch.bmm", nvidia_smi=card, **mix)
                entries.append({"name": f"grouped_matmul_{part}", "route": "cuda",
                                "path": f"olmoe-1b-7b ragged train, {MESH_MOE_TRAIN_LAYERS} "
                                        "layers (mesh: moe_sorted_local)",
                                "source": GMM_SOURCE, "replaces": GMM_BWD_REPLACES,
                                "launches": step_launches[f"grouped_matmul_{part}"],
                                **mix})
            del x, hid, w_in, w_down, dy_in, dy_down
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return entries


#: phase (c): two ranks share the card over gloo (NCCL takes one rank a
#: device); each rank's products run on 2 of the 4 rows, so cuBLAS may pick
#: other kernels and round the bf16 logits differently than one rank on all
#: 4: the loss within 1e-3 and the gradient norm within 1e-2 (relative) of
#: one rank on the concatenated batch
TWO_RANK_LOSS_REL_TOL = 1e-3
TWO_RANK_GNORM_REL_TOL = 1e-2
#: the parameters phase (c) brings back from its ranks
TWO_RANK_LEAVES = ("embed", "segments/[0]/attn/wq", "segments/[1]/mlp/wo",
                   "final_norm")


def two_rank_worker(rank: int, init_file: str, out_dir: str, argvs: list[list[str]]
                    ) -> None:
    """One of phase (c)'s two ranks on card 0, in a gloo group:
    ``launch.train``'s run at data 2 for each of ``argvs`` in turn; writes
    each run's loss, grad_norm, step seconds, peak memory, the shape of its
    ZeRO-1 shard of the embedding's m and the TWO_RANK_LEAVES of its
    parameters."""
    import torch.distributed as dist
    from repro_torch.bridge import flatten
    from repro_torch.launch import train
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=2)
    try:
        runs = []
        for argv in argvs:
            torch.cuda.reset_peak_memory_stats()
            out, state = train.run(argv)
            m = state["opt"]["m"]["embed"]
            params = flatten(state["params"])
            runs.append({"loss": out["loss"], "grad_norm": out["grad_norm"],
                         "step_seconds": out["step_seconds"],
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "shard": [list(m.to_local().shape), list(m.shape)],
                         "leaves": {k: params[k].to_local().cpu() for k in TWO_RANK_LEAVES}})
            del out, state, m, params
            torch.cuda.empty_cache()
        torch.save(runs, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


#: phase (c)'s runs: launch.train at n_micro 1, then 2 (each rank's share of
#: each microbatch, a block of the global batch, by an all-to-all)
TWO_RANK_N_MICRO = (1, 2)


def two_ranks_path(dev, card, one_rank_peak_gb: float) -> None:
    """Phase (c): gemma3-1b at full width and depth through ``launch.train``
    at data 2, two processes on the one card over gloo (which takes CUDA
    tensors for the step's all-reduce, all-gather and all-to-all; NCCL
    refuses two ranks on one device), a global 4 x 2048 batch (2 rows a
    rank), the ZeRO-1 shards split in two; once at n_micro 1 and once at
    n_micro 2 (one row a rank a microbatch), in the same two processes;
    each held against one rank without a mesh on the concatenation of the
    two ranks' batches at the same n_micro.  Both processes' memory is
    reckoned first from phase (a)'s measured peak."""
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.bridge import flatten
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import (
        TrainStepConfig, init_train_state, make_train_step, train_memory_gb,
    )

    cfg = get("gemma3-1b")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    one = train_memory_gb(cfg, 1)
    activations = one_rank_peak_gb - one["state_gb"] - one["update_gb"]
    have = torch.cuda.get_device_properties(dev).total_memory / 1e9
    for n_micro in TWO_RANK_N_MICRO:
        two = train_memory_gb(cfg, 2, n_micro=n_micro)
        per_rank = (two["state_gb"] + two["update_gb"] + two["accumulator_gb"]
                    + activations / 2 / n_micro)
        emit("two_ranks_reckoning", arch=cfg.name, n_micro=n_micro,
             one_rank_peak_gb=one_rank_peak_gb, activations_gb_at_4_rows=activations,
             per_rank_gb=per_rank, both_gb=2 * per_rank, card_gb=have)
        if 2 * per_rank > have:
            raise AssertionError(f"two ranks need ~{2 * per_rank:.1f} GB; the card "
                                 f"has {have:.1f} GB")
    argv = ["--arch", "gemma3-1b", "--steps", "1", "--batch", str(b), "--seq", str(s),
            "--log-every", "1"]
    argvs = [argv + ["--n-micro", str(n)] for n in TWO_RANK_N_MICRO]
    out_dir = Path(__file__).resolve().parent / "build" / "two_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.start_processes(two_rank_worker, args=(str(out_dir / "store"), str(out_dir), argvs),
                       nprocs=2, join=True, start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]

    hosts = [SyntheticStream(cfg, b, s, seed=0, n_hosts=2, host_id=h).batch_at(0)
             for h in range(2)]
    batch = {k: torch.from_numpy(np.concatenate([h[k] for h in hosts])).to(dev)
             for k in hosts[0]}
    failed = []
    for i, n_micro in enumerate(TWO_RANK_N_MICRO):
        # one rank without a mesh on the concatenated batch, as launch.train
        # would start it: seed 0, its optimizer
        opt = AdamW(schedule=cosine_schedule(3e-4, 20, 1))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = init_train_state(cfg, opt, gen)
        state, metrics = make_train_step(cfg, opt, TrainStepConfig(n_micro=n_micro))(
            state, batch)
        params = flatten(state["params"])
        lr = float(metrics["lr"])
        run = [r[i] for r in ranks]
        moved = {k: (run[0]["leaves"][k].to(dev) - params[k]).abs() for k in TWO_RANK_LEAVES}
        agreement = {
            "loss": run[0]["loss"], "one_rank_loss": float(metrics["loss"]),
            "loss_rel_err": abs(run[0]["loss"] / float(metrics["loss"]) - 1),
            "grad_norm": run[0]["grad_norm"],
            "one_rank_grad_norm": float(metrics["grad_norm"]),
            "grad_norm_rel_err": abs(run[0]["grad_norm"] / float(metrics["grad_norm"]) - 1),
            "lr": lr,
            "param_max_abs_diff_over_lr": {k: v.max().item() / lr for k, v in moved.items()},
            "param_share_off_by_half_lr": {k: (v > lr / 2).float().mean().item()
                                           for k, v in moved.items()},
            "ranks_agree": (run[0]["loss"] == run[1]["loss"]
                            and all(torch.equal(run[0]["leaves"][k], run[1]["leaves"][k])
                                    for k in TWO_RANK_LEAVES)),
            "zero1_shard_of_embed_m": run[0]["shard"],
        }
        emit("two_ranks_train", arch=cfg.name, batch=b, seq=s, ranks=2, backend="gloo",
             n_micro=n_micro, seconds_both_ranks_all_runs=seconds,
             step_seconds=[r["step_seconds"] for r in run],
             peak_gb=[r["peak_gb"] for r in run], nvidia_smi=card,
             loss_rel_tol=TWO_RANK_LOSS_REL_TOL, grad_norm_rel_tol=TWO_RANK_GNORM_REL_TOL,
             **agreement)
        local, full = run[0]["shard"]
        if not (agreement["loss_rel_err"] <= TWO_RANK_LOSS_REL_TOL
                and agreement["grad_norm_rel_err"] <= TWO_RANK_GNORM_REL_TOL
                and agreement["ranks_agree"]
                and math.prod(local) * 2 == math.prod(full)):
            failed.append((n_micro, agreement))
        del state, params, moved
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"two ranks disagree with one: {failed}")


# ---------------------------------------------------------------------------
# The tensor-parallel section: two gloo ranks on the one card, a model axis
# of 2 (the multi-device layer's part 2)
# ---------------------------------------------------------------------------

#: its gates: PR 25's two-rank gates (each rank's products run on its half
#: of the heads or hidden units, and f's backward and g add two bf16
#: partial sums where one rank's product adds in fp32 and rounds once):
#: the loss within 1e-3 and the gradient norm within 1e-2 (relative) of
#: one rank on the same state and batch
TP_LOSS_REL_TOL = TWO_RANK_LOSS_REL_TOL
TP_GNORM_REL_TOL = TWO_RANK_GNORM_REL_TOL
#: every parameter after the step against the one-rank step's slice of it:
#: AdamW's first step moves a weight by lr · (1 + weight_decay · |w|) at
#: most, so two runs from one state differ by at most ~2·lr; a wrong slice
#: or update differs by a weight's size (~0.02, a thousand lr).  And the
#: share of a leaf's elements off by more than lr / 2 (a gradient at noise
#: level whose sign flipped; PR 25's two data ranks: up to 0.6%)
TP_PARAM_LR_BOUND = 2.5
TP_PARAM_SHARE = 0.05
#: the parameters after one step see only each gradient's sign, so each
#: rank's first moment (0.1 · the clipped gradient after that step) is
#: held against its slice of one rank's: the largest |Δ| over the leaf's
#: largest |m|.  A gradient summed M times over ``model`` (a gather's
#: backward that should have been a slice) or a partial one (a leaf read in
#: the sliced work without f) reads 0.5 or more; bf16 reads up to 0.073 on
#: the card (gemma3's q_norm: its gradient sums two ranks' bf16 partials,
#: which cancel; fp32 on the CPU: 3e-6)
TP_MOMENT_REL_TOL = 0.25
#: the section's global batch (data 1: every model rank takes all of it),
#: its seed and AdamW's schedule (launch.train's)
TP_BATCH, TP_SEQ, TP_SEED = 2, 2048, 0
#: the phases: (name, arch, layers (None: full depth), sequence-parallel);
#: mamba2-780m and olmoe-1b-7b cut in depth (the one-rank reference of
#: olmoe's 4 layers holds 36 GB of fp32 state; 8 mamba2 layers keep the
#: in_proj gathers through gloo, host memory, short)
TP_PHASES = (("a", "gemma3-1b", None, False),
             ("b", "mamba2-780m", 8, False),
             ("b", "olmoe-1b-7b", 4, False),
             ("c", "gemma3-1b", None, True))


def tp_config(arch: str, layers: int | None):
    from repro_torch.configs import get
    cfg = get(arch)
    return cfg if layers is None else cut_depth(cfg, layers)


def tp_local_config(cfg, model: int = 2, rank: int = 0):
    """``cfg`` as one ``model`` rank's kernels see it: its query and KV
    heads (``attn_view``), its SSM heads (``ssm_view``; d_model scaled so
    that d_inner is its heads' width) and its block of the experts' hidden
    units (``hidden_view``)."""
    from repro_torch.distributed import sharding as shd
    out = {}
    if cfg.n_heads:
        v = shd.attn_view(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, model, rank)
        (h0, h1), (k0, k1) = v["heads"], v["kv_heads"]
        out.update(n_heads=h1 - h0, n_kv_heads=k1 - k0)
    if cfg.ssm_state:
        v = shd.ssm_view(cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_state,
                         cfg.ssm_groups, model, rank)
        h0, h1 = v["heads"]
        out.update(d_model=(h1 - h0) * cfg.ssm_head_dim // cfg.ssm_expand)
    if cfg.n_experts:
        (f0, f1), = shd.hidden_view(cfg.moe_d_ff, model, rank)
        out.update(moe_d_ff=f1 - f0)
    return dataclasses.replace(cfg, **out)


def tp_batch(cfg, dev) -> dict:
    from repro_torch.data.pipeline import SyntheticStream
    host = SyntheticStream(cfg, TP_BATCH, TP_SEQ, seed=TP_SEED).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def tp_leaf_agreement(got: dict, want: dict, lr: float, dev) -> dict:
    """For each leaf ``path``: got[path] = (this rank's tensor, its slice of
    the whole), want[path] the whole (or the same slice): the largest |Δ|
    over lr and the share of elements off by more than lr / 2, on the card
    a leaf at a time."""
    out = {}
    for path, (t, sl) in got.items():
        w = want[path]
        w = (w[sl] if w.shape != t.shape else w).to(dev)
        diff = (t.to(dev).float() - w.float()).abs()
        out[path] = (diff.max().item() / lr, (diff > lr / 2).float().mean().item())
        del w, diff
    return out


def tp_moment_agreement(got: dict, want: dict, dev) -> dict:
    """For each leaf ``path``: got[path] = (this rank's first moment, its
    slice of the whole), want[path] the whole (or the same slice): the
    largest |Δ| over want[path]'s largest |m|, on the card a leaf at a
    time."""
    out = {}
    for path, (t, sl) in got.items():
        w = want[path].to(dev)
        scale = w.float().abs().max().item()
        w = w[sl] if w.shape != t.shape else w
        out[path] = (t.to(dev).float() - w.float()).abs().max().item() / max(scale, 1e-30)
        del w
    return out


def tp_rank_worker(rank: int, init_file: str, out_dir: str, device_type: str) -> None:
    """One of the section's two ranks on card 0, a (data 1, model 2) mesh
    over gloo.  Each phase: the mesh step once on the state of TP_SEED and
    one batch (its launches counted from 0), each stored shard brought to
    the host; then for (a) and (b) rank 0 runs one rank's step without a
    mesh on the same state and batch, rank 1 sends it its shards and rank
    0 holds every leaf of both, and of their first moments, against its
    slice; (c) each rank holds its shards against its own of (a).  Writes
    the results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.bridge import flatten
    from repro_torch.distributed import sharding as shd
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
    dev = torch.device(device_type, 0)
    if device_type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=2)
    results, kept = [], None

    def shards(tree):
        return {path: (leaf.to_local().detach().cpu(),
                       shd.local_slices(shd.spec_of(leaf), leaf.shape, mesh))
                for path, leaf in flatten(tree).items()}

    try:
        mesh = init_device_mesh(device_type, (1, 2), mesh_dim_names=("data", "model"))
        for phase, arch, layers, seq in TP_PHASES:
            cfg = tp_config(arch, layers)
            opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
            gen = torch.Generator(device=dev)
            gen.manual_seed(TP_SEED)
            state = init_train_state(cfg, opt, gen, mesh)
            batch = tp_batch(cfg, dev)
            spec = shd.Spec(("data", "model", None)) if seq else None
            step = make_train_step(cfg, opt, TrainStepConfig(seq_spec=spec))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            step_s = time.perf_counter() - t0
            launches = launch_counts(path_kernels(cfg, backward=True))
            peak = torch.cuda.max_memory_allocated() / 1e9
            local, moments = shards(state["params"]), shards(state["opt"]["m"])
            split = sum(t.numel() < math.prod(leaf.shape) for (t, _), leaf in
                        zip(local.values(), flatten(state["params"]).values()))
            del state, step
            torch.cuda.empty_cache()
            out = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers, "seq": seq,
                   "metrics": metrics, "step_s": step_s, "launches": launches,
                   "peak_gb": peak, "split_leaves": split, "leaves": len(local),
                   "lr": metrics["lr"]}
            if seq:
                out["vs_a"] = tp_leaf_agreement(
                    local, {k: v for k, (v, _) in kept[0].items()}, metrics["lr"], dev)
                out["m_vs_a"] = tp_moment_agreement(
                    moments, {k: v for k, (v, _) in kept[1].items()}, dev)
            else:
                out.update(tp_against_one_rank(rank, cfg, opt, local, moments, batch, dev))
                if phase == "a":
                    kept = local, moments
            results.append(out)
            del local, moments, batch
            torch.cuda.empty_cache()
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_against_one_rank(rank, cfg, opt, local, moments, batch, dev) -> dict:
    """Rank 0: one rank's step without a mesh on TP_SEED's state and
    ``batch`` (its metrics), and every stored shard of both ranks against
    its slice of that step's parameters, and each shard's first moment
    against its slice of that step's (rank 1 sends its own over gloo; the
    replicated leaves must be bit-equal on the two ranks)."""
    import torch.distributed as dist
    from repro_torch.bridge import flatten
    from repro_torch.train.step import init_train_state, make_train_step
    dist.barrier()
    if rank == 1:
        for t, _ in [*local.values(), *moments.values()]:
            dist.send(t.contiguous(), dst=0)
        dist.barrier()
        return {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(TP_SEED)
    state = init_train_state(cfg, opt, gen)
    state, metrics = make_train_step(cfg, opt)(state, batch)
    want = {k: v.detach() for k, v in flatten(state["params"]).items()}
    want_m = {k: v.detach() for k, v in flatten(state["opt"]["m"]).items()}
    del state
    torch.cuda.empty_cache()
    lr = float(metrics["lr"])
    other, same = {}, True
    for (path, (t, sl)), leaf in zip(local.items(), want.values()):
        buf = torch.empty_like(t)
        dist.recv(buf, src=1)
        if t.numel() == leaf.numel():        # kept whole on both ranks
            same = same and torch.equal(buf, t)
        else:                                 # rank 1's block: the next one
            dim = next(i for i, (a, b) in enumerate(zip(t.shape, leaf.shape)) if a != b)
            sl = tuple(slice(t.shape[i], 2 * t.shape[i]) if i == dim else slice(None)
                       for i in range(t.dim()))
        other[path] = (buf, sl)
    other_m = {}
    for path, (t, _) in moments.items():
        buf = torch.empty_like(t)
        dist.recv(buf, src=1)
        other_m[path] = (buf, other[path][1])   # data 1: the parameter's slice
    dist.barrier()
    agreement = {"rank0": tp_leaf_agreement(local, want, lr, dev),
                 "rank1": tp_leaf_agreement(other, want, lr, dev),
                 "m_rank0": tp_moment_agreement(moments, want_m, dev),
                 "m_rank1": tp_moment_agreement(other_m, want_m, dev)}
    del want, want_m, other, other_m
    torch.cuda.empty_cache()
    return {"one_rank": {k: float(v) for k, v in metrics.items()},
            "replicated_leaves_equal": same, **agreement}


def tp_gmm_entries(cfg, gen, dev, card, launches: dict, model: int = 2,
                   tokens: int = TP_BATCH * TP_SEQ) -> list[dict]:
    """The grouped GEMM's forward, dx and dw at one model rank's shape of
    olmoe-1b-7b (every expert's f / ``model`` hidden units; the T·K rows of
    ``tokens``, the section's batch by default, a real routing's group
    sizes): a train step's calls of each (3 a layer), against the plain
    versions, ``torch._grouped_mm`` and the bound."""
    from repro_torch.kernels import moe_gmm
    local = tp_local_config(cfg, model)
    d, f, e, k = cfg.d_model, local.moe_d_ff, cfg.n_experts, cfg.top_k
    rows = tokens * k
    sizes = moe_group_sizes(gen, dev, tokens, e, k)
    nonempty = int((sizes > 0).sum())
    x = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    hid = torch.randn((rows, f), generator=gen, device=dev).to(torch.bfloat16)
    w_in = (torch.randn((e, d, f), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    w_down = (torch.randn((e, f, d), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    calls = [(x, w_in, hid), (x, w_in, hid), (hid, w_down, x)] * cfg.n_layers
    parts = {
        "grouped_matmul": (
            lambda a, w, g: moe_gmm.grouped_matmul(a, w, sizes),
            lambda a, w, g: moe_gmm.grouped_matmul_plain(a, w, sizes),
            lambda a, w, g: grouped_mm_call(a, w, sizes),
            lambda a, w, g: gmm_floor_ms(rows, w.shape[1], w.shape[2], nonempty),
            GMM_REPLACES, gmm_errors),
        "grouped_matmul_dx": (
            lambda a, w, g: moe_gmm.grouped_matmul_dx(g, w, sizes),
            lambda a, w, g: moe_gmm.grouped_matmul_dx_plain(g, w, sizes),
            lambda a, w, g: grouped_mm_call(g, w.transpose(1, 2), sizes),
            lambda a, w, g: gmm_floor_ms(rows, w.shape[2], w.shape[1], nonempty),
            GMM_BWD_REPLACES, gmm_errors),
        "grouped_matmul_dw": (
            lambda a, w, g: moe_gmm.grouped_matmul_dw(a, g, sizes),
            lambda a, w, g: moe_gmm.grouped_matmul_dw_plain(a, g, sizes),
            lambda a, w, g: grouped_mm_call(a.t(), g, sizes),
            lambda a, w, g: gmm_dw_floor_ms(rows, w.shape[1], w.shape[2], e),
            GMM_BWD_REPLACES, lambda out, want: dw_errors(out, want, sizes)),
    }
    entries = []
    for name, (kernel, plain, lib, floor, replaces, errors) in parts.items():
        errs = [errors(kernel(*c), plain(*c)) for c in calls[1:3]]
        libs = [lib(*c) for c in calls[:3]]
        no_lib = next((why for call, why in libs if call is None), None)
        floors = [floor(*c) for c in calls]
        mix = {"max_abs_err": max(er["max_abs_err"] for er in errs),
               "ms": time_ms(lambda: [kernel(*c) for c in calls], 5),
               "plain_ms": time_ms(lambda: [plain(*c) for c in calls], 1, 1),
               "library_ms": (None if no_lib else
                              time_ms(lambda: [call() for call, _ in libs * cfg.n_layers], 5))}
        mix["bound_ms"], mix["bound_by"] = bound(sum(fl[0] for fl in floors),
                                                 sum(fl[1] for fl in floors))
        emit("kernel_tp_mix", kernel=name, model=model, calls=len(calls),
             shape=[rows, d, f, e], nonempty_experts=nonempty,
             library=no_lib or "torch._grouped_mm", errors=errs, nvidia_smi=card, **mix)
        entries.append({"name": name, "route": "cuda", "source": GMM_SOURCE,
                        "replaces": replaces,
                        "path": f"{cfg.name} TP train, model {model} ({cfg.n_layers} layers)",
                        "launches": launches[name], **mix})
        del libs
    return entries


def tp_path(dev, card) -> list[dict]:
    """The tensor-parallel section: TP_PHASES in two gloo ranks sharing the
    card, a (data 1, model 2) mesh (NCCL takes one rank a device): (a)
    gemma3-1b at full width and depth, one train step on a global 2 x 2048
    batch, against one rank without a mesh on the same state and batch
    (loss, grad_norm, every stored shard against its slice); (b)
    mamba2-780m and olmoe-1b-7b (einsum) cut in depth, the same way; (c)
    gemma3-1b with the sequence over ``model``, against (a).  Then each
    kernel at one rank's shapes (2 query heads over the replicated KV head
    at D 256; 24 of mamba2's 48 SSD heads; olmoe's experts at f 512)
    against its plain version.  Returns the kernels' entries."""
    import shutil
    import torch.multiprocessing as mp
    out_dir = Path(__file__).resolve().parent / "build" / "tp_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    for _, arch, layers, _ in TP_PHASES:
        cfg = tp_config(arch, layers)
        local = tp_local_config(cfg)
        emit("tp_shapes", arch=cfg.name, layers=cfg.n_layers, model=2,
             q_heads=local.n_heads, kv_heads=local.n_kv_heads, head_dim=cfg.head_dim,
             ssm_heads=local.ssm_heads if cfg.ssm_state else 0,
             expert_hidden=local.moe_d_ff, reckoned_gb_a_rank=train_reckoning_gb_tp(cfg))
    t0 = time.perf_counter()
    mp.start_processes(tp_rank_worker,
                       args=(str(out_dir / "store"), str(out_dir), dev.type),
                       nprocs=2, join=True, start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]

    failures, launches = [], {}
    for i, (phase, arch, layers, seq) in enumerate(TP_PHASES):
        r0, r1 = ranks[0][i], ranks[1][i]
        cfg = tp_config(arch, layers)
        want_launches = step_launches(cfg)
        ref = r0["one_rank"] if not seq else ranks[0][0]["one_rank"]
        got = r0["metrics"]
        line = {"loss": got["loss"], "one_rank_loss": ref["loss"],
                "loss_rel_err": abs(got["loss"] / ref["loss"] - 1),
                "grad_norm": got["grad_norm"], "one_rank_grad_norm": ref["grad_norm"],
                "grad_norm_rel_err": abs(got["grad_norm"] / ref["grad_norm"] - 1),
                "ranks_loss_equal": r0["metrics"]["loss"] == r1["metrics"]["loss"],
                "launches": r0["launches"], "want_launches": want_launches}
        if seq:
            a = ranks[0][0]["metrics"]
            line.update(tp_loss=a["loss"], loss_rel_err_vs_tp=abs(got["loss"] / a["loss"] - 1),
                        grad_norm_rel_err_vs_tp=abs(got["grad_norm"] / a["grad_norm"] - 1))
            leaves = {f"rank{r}": rr[i]["vs_a"] for r, rr in enumerate(ranks)}
            moms = {f"rank{r}": rr[i]["m_vs_a"] for r, rr in enumerate(ranks)}
        else:
            line["replicated_leaves_equal"] = r0["replicated_leaves_equal"]
            leaves = {"rank0": r0["rank0"], "rank1": r0["rank1"]}
            moms = {"rank0": r0["m_rank0"], "rank1": r0["m_rank1"]}
        worst = {r: max(v.values(), key=lambda x: x[0]) for r, v in leaves.items()}
        worst_m = max(((e, path) for v in moms.values() for path, e in v.items()))
        line.update(
            param_max_abs_diff_over_lr=max(w[0] for w in worst.values()),
            param_worst_share_off_by_half_lr=max(s for v in leaves.values()
                                                 for _, s in v.values()),
            m_max_rel_err=worst_m[0], m_worst_leaf=worst_m[1],
            leaves=r0["leaves"], split_leaves=r0["split_leaves"])
        emit(f"tp_train_{phase}", arch=cfg.name, layers=cfg.n_layers, batch=TP_BATCH,
             seq=TP_SEQ, mesh={"data": 1, "model": 2}, backend="gloo",
             sequence_parallel=seq, step_s=[r0["step_s"], r1["step_s"]],
             peak_gb=[r0["peak_gb"], r1["peak_gb"]], lr=r0["lr"], nvidia_smi=card,
             loss_rel_tol=TP_LOSS_REL_TOL, grad_norm_rel_tol=TP_GNORM_REL_TOL,
             param_lr_bound=TP_PARAM_LR_BOUND, param_share_tol=TP_PARAM_SHARE,
             m_rel_tol=TP_MOMENT_REL_TOL, **line)
        ok = (line["loss_rel_err"] <= TP_LOSS_REL_TOL
              and line["grad_norm_rel_err"] <= TP_GNORM_REL_TOL
              and line["ranks_loss_equal"] and r0["launches"] == want_launches
              and line["param_max_abs_diff_over_lr"] <= TP_PARAM_LR_BOUND
              and line["param_worst_share_off_by_half_lr"] <= TP_PARAM_SHARE
              and line["m_max_rel_err"] <= TP_MOMENT_REL_TOL
              and line["split_leaves"] > 0)
        if seq:
            ok = ok and (line["loss_rel_err_vs_tp"] <= TP_LOSS_REL_TOL
                         and line["grad_norm_rel_err_vs_tp"] <= TP_GNORM_REL_TOL)
        else:
            ok = ok and line["replicated_leaves_equal"]
        if not ok:
            failures.append((phase, cfg.name, line))
        launches[(phase, arch)] = r0["launches"]
    emit("tp_section", seconds_both_ranks=seconds, phases=len(TP_PHASES))
    if failures:
        raise AssertionError(f"tensor parallelism disagrees with one rank: {failures}")

    # -- the kernels at one model rank's shapes --------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    gemma = tp_local_config(tp_config("gemma3-1b", None))
    mamba = tp_local_config(tp_config("mamba2-780m", 8))
    path_a = "gemma3-1b TP train, model 2"
    path_b = "mamba2-780m TP train, model 2 (8 layers)"
    fa_fwd = fa_prefill_mix(gemma, gen, dev, TP_BATCH, TP_SEQ)
    fa_bwd = fa_train_mix(gemma, gen, dev, TP_BATCH, TP_SEQ)
    ssd_fwd = ssd_prefill_mix(mamba, gen, dev, TP_BATCH, TP_SEQ)
    ssd_bwd = ssd_train_mix(mamba, gen, dev, TP_BATCH, TP_SEQ)
    la, lb = launches[("a", "gemma3-1b")], launches[("b", "mamba2-780m")]
    entries = [
        {"name": "flash_attention", "path": path_a, "route": "cuda", "source": FA_SOURCE,
         "replaces": FA_REPLACES, "launches": la["flash_attention"], **fa_fwd},
        {"name": "flash_attention_bwd", "path": path_a, "route": "cuda",
         "source": FA_SOURCE, "replaces": FA_REPLACES,
         "launches": la["flash_attention_bwd"], **fa_bwd}]
    for part in ("chunk_state", "chunk_scan"):
        entries.append({"name": "ssd_" + part, "path": path_b, "route": "cuda",
                        "source": SSD_SOURCE, "replaces": SSD_REPLACES["ssd_" + part],
                        "launches": lb["ssd_" + part], **ssd_fwd[part]})
    for part in ("chunk_state_bwd", "chunk_scan_bwd"):
        entries.append({"name": "ssd_" + part, "path": path_b, "route": "cuda",
                        "source": SSD_SOURCE, "replaces": SSD_BWD_REPLACES,
                        "launches": lb["ssd_" + part], **ssd_bwd[part]})
    for entry in entries:
        emit("kernel_tp_entry", **entry, nvidia_smi=card)
    entries += tp_gmm_entries(tp_config("olmoe-1b-7b", 4), gen, dev, card,
                              launches[("b", "olmoe-1b-7b")])
    torch.cuda.empty_cache()
    return entries


#: the kernels at one rank's shapes of scripts/tp_across_cards.py's train
#: steps at (data 1, model 4) on 4 cards, a (4, 2048) batch: olmoe-1b-7b's
#: grouped GEMMs at f 256 of 1024 (16 layers' calls) and gemma-7b's
#: attention at 4 of its 16 query and KV heads, D 256 (28 layers' calls).
#: Their launches are counted in a model-4 rank's train step at full depth
#: on this card (tp4_rank_steps: rank 0 of a ``fake`` group of 4, whose
#: collectives move nothing)
TP4_MODEL, TP4_BATCH, TP4_SEQ = 4, 4, 2048
TP4_GMM_ARCH, TP4_FA_ARCH = "olmoe-1b-7b", "gemma-7b"


def tp4_fa_errors(cfg, gen, dev, b: int, s: int) -> dict:
    """flash attention's forward (with its LSE) and backward at ``cfg``'s
    heads on one set of (b, s) inputs against the plain versions; raises
    past KERNEL_TOL and ROW_REL_TOL (the output) or the backward's row gate
    (dQ, dK, dV; BWD_ROW_REL_TOL, BWD_ABS_FLOOR)."""
    from repro_torch.kernels import flash_attention as fa

    def normal(h):
        return torch.randn((b, s, h, cfg.head_dim), generator=gen, device=dev
                           ).to(torch.bfloat16)

    q, k, v, do = (normal(h) for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads,
                                        cfg.n_heads))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=cfg.causal, window=0)
    want = fa.flash_attention_plain(q, k, v, causal=cfg.causal, window=0)
    errs = {"max_abs_err": (out.float() - want.float()).abs().max().item(),
            "max_row_rel_err": row_rel_err(out, want)}
    if not (errs["max_abs_err"] <= KERNEL_TOL and errs["max_row_rel_err"] <= ROW_REL_TOL):
        raise AssertionError(f"flash_attention at {cfg.name}'s rank shape: {errs} "
                             f"(tol {KERNEL_TOL}, row-relative {ROW_REL_TOL})")
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=cfg.causal, window=0)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=cfg.causal, window=0)
    for part, a, w in zip(("dq", "dk", "dv"), got, want):
        errs[f"{part}_max_abs_err"], over = grad_row_err(a, w)
        if over > 0:
            raise AssertionError(
                f"flash_attention_bwd at {cfg.name}'s rank shape: {part} past the row "
                f"gate ({BWD_ROW_REL_TOL} of the row's largest |plain| + "
                f"{BWD_ABS_FLOOR}) by {over}")
    return errs


def tp4_rank_step(cfg, mesh, dev, batch: int = TP4_BATCH, seq: int = TP4_SEQ) -> dict:
    """One rank's train step as scripts/tp_across_cards.py takes it at
    (data 1, model 4), ``init_train_state`` on ``mesh`` then one step of
    ``make_train_step`` on a (batch, seq) batch, in this one process on a
    ``fake`` group's mesh, whose collectives move nothing: the values are
    not the 4-card run's, the work, the memory and the kernels a rank
    launches are.  Returns the init's peak and seconds, the step's peak
    and seconds and its launches, counted from 0 (peaks None off a card)."""
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step
    on_card = dev.type == "cuda"

    def fresh():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def peak_gb():
        if on_card:
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated() / 1e9
        return None

    opt = AdamW(schedule=cosine_schedule(3e-4, 20, 100))
    gen = torch.Generator(device=dev)
    gen.manual_seed(TP_SEED)
    t0 = fresh()
    state = init_train_state(cfg, opt, gen, mesh)
    init_peak = peak_gb()
    init_s = time.perf_counter() - t0
    host = SyntheticStream(cfg, batch, seq, seed=TP_SEED).batch_at(0)
    data = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    step = make_train_step(cfg, opt)
    reset_launches()
    t0 = fresh()
    with mesh_ctx.set_mesh(mesh):
        state, _ = step(state, data)
    step_peak = peak_gb()
    out = {"init_peak_gb": init_peak, "init_s": init_s, "step_peak_gb": step_peak,
           "step_s": time.perf_counter() - t0,
           "launches": launch_counts(path_kernels(cfg, backward=True))}
    del state, data, step
    if on_card:
        torch.cuda.empty_cache()
    return out


def tp4_rank_steps(dev, card) -> dict[str, dict]:
    """tp4_rank_step of TP4_FA_ARCH and TP4_GMM_ARCH at full width and
    depth, model rank 0 of a ``fake`` group of TP4_MODEL ranks on this
    card; fails unless each step launched ``step_launches`` of its config
    (4 cards launch the same on every rank).  Returns each arch's
    launches."""
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.train.step import train_memory_gb
    mesh = fake_mesh((1, TP4_MODEL), ("data", "model"), 0, device=dev.type)
    launches = {}
    try:
        for arch in (TP4_FA_ARCH, TP4_GMM_ARCH):
            cfg = get(arch)
            got = tp4_rank_step(cfg, mesh, dev)
            want = step_launches(cfg)
            emit("tp4_rank_step", arch=arch, layers=cfg.n_layers, batch=TP4_BATCH,
                 seq=TP4_SEQ, mesh={"data": 1, "model": TP4_MODEL}, backend="fake",
                 reckoned_gb=train_memory_gb(cfg, 1, TP4_MODEL)["total_gb"],
                 want_launches=want, nvidia_smi=card, **got)
            if got["launches"] != want:
                raise AssertionError(f"{arch}'s model-{TP4_MODEL} rank launched "
                                     f"{got['launches']}, want {want}")
            launches[arch] = got["launches"]
    finally:
        dist.destroy_process_group()
    return launches


def tp4_entries(dev, card, launches: dict[str, dict]) -> list[dict]:
    """The kernels at one model-4 rank's shapes (TP4_*): flash attention's
    forward and backward at gemma-7b's, the grouped GEMM's forward, dx and
    dw at olmoe-1b-7b's, each held against its plain version and a train
    step's calls timed together beside the library call and the bound;
    ``launches`` are tp4_rank_steps' counts.  Returns their entries of the
    kernels line."""
    from repro_torch.configs import get
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    gemma, olmoe = get(TP4_FA_ARCH), get(TP4_GMM_ARCH)
    local = tp_local_config(gemma, TP4_MODEL)
    errs = tp4_fa_errors(local, gen, dev, TP4_BATCH, TP4_SEQ)
    fa_fwd = fa_prefill_mix(local, gen, dev, TP4_BATCH, TP4_SEQ)
    fa_bwd = fa_train_mix(local, gen, dev, TP4_BATCH, TP4_SEQ)
    fa_launches = launches[TP4_FA_ARCH]
    path = f"{gemma.name} TP train, model {TP4_MODEL} ({gemma.n_layers} layers)"
    entries = [
        {"name": "flash_attention", "path": path, "route": "cuda", "source": FA_SOURCE,
         "replaces": FA_REPLACES, "launches": fa_launches["flash_attention"], **fa_fwd},
        {"name": "flash_attention_bwd", "path": path, "route": "cuda", "source": FA_SOURCE,
         "replaces": FA_REPLACES, "launches": fa_launches["flash_attention_bwd"], **fa_bwd}]
    emit("tp4_shapes", arch=gemma.name, model=TP4_MODEL, batch=TP4_BATCH, seq=TP4_SEQ,
         q_heads=local.n_heads, kv_heads=local.n_kv_heads, head_dim=local.head_dim,
         calls=len(attention_windows(local)), errors=errs,
         expert_hidden=tp_local_config(olmoe, TP4_MODEL).moe_d_ff, nvidia_smi=card)
    for entry in entries:
        emit("kernel_tp_entry", **entry, nvidia_smi=card)
    entries += tp_gmm_entries(olmoe, gen, dev, card, launches[TP4_GMM_ARCH], TP4_MODEL,
                              TP4_BATCH * TP4_SEQ)
    torch.cuda.empty_cache()
    return entries


def train_reckoning_gb_tp(cfg) -> float:
    """GB a model rank's state and step need at model 2 (the port's
    ``train_memory_gb`` with the model size), its activations at the
    section's smaller batch counted as the reckoning's."""
    from repro_torch.train.step import train_memory_gb
    return train_memory_gb(cfg, 1, 2)["total_gb"]


# ---------------------------------------------------------------------------
# Decode under a model axis (tp_decode) and the dry run against the card
# (dryrun_vs_card)
# ---------------------------------------------------------------------------

#: tp_decode: at full width and depth from the serving init (bf16), 4
#: slots, a cache of 2048 positions, 8 teacher-forced tokens (16 until
#: the script's time ran short); gemma3-1b
#: (its KV head split over the head dim), mamba2-780m (the conv cut across
#: x | B | C), hymba-1.5b (head dim split, 25 of 50 SSM heads a rank) and
#: olmoe-1b-7b (KV heads split, experts at f 512)
TP_DECODE_ARCHS = ("gemma3-1b", "mamba2-780m", "hymba-1.5b", "olmoe-1b-7b")
TP_DECODE_SLOTS, TP_DECODE_LEN, TP_DECODE_TOKENS = 4, 2048, 8
#: each rank's cache shard against its slice of one rank's cache after the
#: tokens, ||Δ|| / ||slice|| (e_tp), held against the model's own bf16
#: rounding: the same measure between one rank's bf16 decode and its
#: decode at fp32 compute on the same weights (e_ref).  e_tp ≤
#: TP_DECODE_CACHE_REF × e_ref, or ≤ TP_DECODE_CACHE_FLOOR (two bf16 steps)
#: where e_ref is smaller.  The k and v entries are bf16, formed from
#: hidden states whose sums ran in another order, and the random init
#: amplifies a rounding over depth (ROADMAP C10): the largest |Δ| of a leaf
#: moves by 2× between the ranks of one run on the card, the norm of Δ
#: does not.
#: A wrong slice or a missing sum over model reads ~1.  The largest |Δ|
#: over the leaf's largest |value| is reported beside it
TP_DECODE_CACHE_REF = 2.0
TP_DECODE_CACHE_FLOOR = 2.0 ** -7
#: the logits: §2's decode gates (max ≤ 0.25·std, mean ≤ 0.05·std at 26
#: layers, scaled by depth, as the prefill-against-decode checks), and
#: their mean distance from the fp32-compute logits within
#: TP_DECODE_FP32_REF × one rank's
TP_DECODE_FP32_REF = 2.0
#: dryrun_vs_card: (label, arch, ShapeConfig fields, mesh shape, n_micro).
#: (a), (b) and (d), (a) at n_micro 2, on one card at (1, 1); (c) on
#: tp_decode's two gloo ranks at (1, 2)
DRYRUN_CELLS = (("a", "gemma3-1b", ("train_4x2048", 2048, 4, "train"), (1, 1), 1),
                ("b", "mamba2-780m", ("prefill_4x2048", 2048, 4, "prefill"), (1, 1), 1),
                ("c", "gemma3-1b", ("train_2x2048", 2048, 2, "train"), (1, 2), 1),
                ("c", "gemma3-1b", ("decode_4x2048", 2048, 4, "decode"), (1, 2), 1),
                ("d", "gemma3-1b", ("train_4x2048", 2048, 4, "train"), (1, 1), 2))
#: the reckoned peak against torch.cuda.max_memory_allocated, (a) and (b)
DRYRUN_PEAK_REL_TOL = 0.10
#: (c)'s timed calls: one, after the counted call (its train step through
#: gloo takes seconds, against a bound of a tenth of one; its peak is not
#: gated, so no warm-up before the count)
DRYRUN_TP_TIMED = 1
#: what the meta run and the card run must count alike
DRYRUN_EQUAL = ("flops", "hbm_bytes", "kernel_calls", "collectives")


def count_on_card(arch: str, shape_fields: tuple, mesh, dev, timed: int = 3,
                  n_micro: int = 1) -> dict:
    """A dry-run cell's step (``repro_torch.launch.dryrun.build_step``: the
    same trees and settings, zeros on the card; ``n_micro`` microbatches a
    train step) under the same counter as the dry run: one counted call
    (its peak from ``torch.cuda.max_memory_allocated``), after a warm-up
    call where ``timed`` > 1, then the median of ``timed`` timed calls."""
    from repro_torch.launch import costs, dryrun
    from repro_torch.models.config import ShapeConfig
    cfg = dryrun.cell_config(arch)
    fn, args = dryrun.build_step(cfg, ShapeConfig(*shape_fields), mesh, dev.type,
                                 n_micro=n_micro)
    if timed > 1:
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter = costs.Counter(dev.type)
    counter.track(*args)
    with counter:
        fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del args, fn
    torch.cuda.empty_cache()
    return {"summary": {**counter.summary(), "kernel_calls": counter.kernel_calls()},
            "max_memory_allocated": peak, "step_s": float(np.median(times))}


def dryrun_vs_card_worker(rank: int, init_file: str, out_dir: str) -> None:
    """The one-card cells of dryrun_vs_card ((a), (b), (d)) in a one-rank
    gloo group on card 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        out = {f"{label} {arch} {fields[0]}": count_on_card(arch, fields, mesh, dev,
                                                            n_micro=n_micro)
               for label, arch, fields, shape, n_micro in DRYRUN_CELLS if shape == (1, 1)}
        torch.save(out, Path(out_dir) / "card.pt")
    finally:
        dist.destroy_process_group()


def dryrun_meta(out_dir: Path) -> tuple[subprocess.Popen, Path]:
    """Every DRYRUN_CELLS cell reckoned by the dry run on the meta device, in
    a process of its own (its fake process group is process-wide), started
    now: (the process, the JSON it writes: each ``model`` rank's counts and
    the roofline)."""
    code = """
import json, sys
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
out = {}
for label, arch, fields, shape, n_micro in %r:
    cfg = dryrun.cell_config(arch)
    axes = ("data", "model")
    for j in range(shape[1]):
        counter, seconds = dryrun.count_rank(cfg, ShapeConfig(*fields), shape, axes, j,
                                             n_micro)
        rl = dryrun.roofline(counter.flops, counter.hbm_bytes, counter.by_axis,
                             dict(zip(axes, shape)))
        out[f"{label} {arch} {fields[0]} rank {j}"] = {
            **counter.summary(), "kernel_calls": counter.kernel_calls(),
            "roofline": rl, "seconds": seconds}
json.dump(out, open(sys.argv[1], "w"))
""" % (DRYRUN_CELLS,)
    path = out_dir / "meta.json"
    root = Path(__file__).resolve().parent
    return subprocess.Popen([sys.executable, "-c", code, str(path)], cwd=root,
                            env={**os.environ, "PYTHONPATH": str(root / "src")}), path


@contextlib.contextmanager
def plain_grouped_matmul():
    """The grouped GEMM replaced by its plain version where the MoE layer
    calls it (a reference run at fp32 compute)."""
    from repro_torch.kernels import moe_gmm
    kernel = moe_gmm.grouped_matmul
    moe_gmm.grouped_matmul = moe_gmm.grouped_matmul_plain
    try:
        yield
    finally:
        moe_gmm.grouped_matmul = kernel


def tp_decode_check(cfg, mesh, dev, length: int = TP_DECODE_LEN,
                    depth_scale: float | None = None, profile_tokens: int = 0) -> dict:
    """tp_decode's check of ``cfg``, called by every rank of a (data 1,
    model m) mesh over any backend (gloo on one card here, NCCL across
    cards in scripts/tp_across_cards.py).  The serving tree (the same on
    every rank, from TP_SEED); one rank's decode of TP_DECODE_TOKENS
    teacher-forced tokens on TP_DECODE_SLOTS slots and a cache of
    ``length`` on the whole tree, in bf16 on rank 0 and at fp32 compute on
    rank 1 (the grouped GEMM's plain version in the kernel's place: the
    kernel takes bf16 only), at once, each broadcast to every rank, which
    keeps its slice of the cache; then this rank's shards of the tree and
    of a new cache (``init_cache`` with the mesh) and the same tokens
    through ``make_serve_step(cfg, mesh)``, its launches counted from 0 and
    its collectives (count, bytes) read from ``repro_torch.events``.
    ``agrees``: its logits (this rank's vocabulary columns) within §2's
    decode gates of one rank's (scaled by ``depth_scale``, else by depth)
    and no further from the fp32 ones than TP_DECODE_FP32_REF times one
    rank's; its cache shards exactly their slices' shapes and within the
    model's own rounding of one rank's (TP_DECODE_CACHE_REF,
    TP_DECODE_CACHE_FLOOR).  With ``profile_tokens``, that many more
    tokens under the profiler.  Returns this rank's results; a step is one
    token on every slot."""
    import torch.distributed as dist
    from repro_torch import bridge, events
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import init_cache, init_serving_params
    from repro_torch.serve.engine import make_serve_step
    from repro_torch.tree import tree_map
    t_start = time.perf_counter()
    rank, m = dist.get_rank(), shd.axis_sizes(mesh)["model"]
    j, on_card = mesh.get_local_rank("model"), dev.type == "cuda"
    slots, n_tokens = TP_DECODE_SLOTS, TP_DECODE_TOKENS

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gen = torch.Generator(device=dev)
    gen.manual_seed(TP_SEED)
    params = init_serving_params(cfg, gen)
    rng = np.random.default_rng(TP_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n_tokens, slots))).to(dev)
    whole = init_cache(cfg, slots, length, device="meta")
    shapes, slices = {}, {}
    for (path, leaf), spec in zip(bridge.flatten(whole).items(),
                                  shd.spec_leaves(shd.cache_shardings(whole, mesh))):
        if isinstance(leaf, torch.Tensor):
            shapes[path] = tuple(leaf.shape)
            slices[path] = shd.local_slices(spec, leaf.shape, mesh)

    one, one_rank_ms = {}, []
    if rank < 2:
        run_cfg = cfg if rank == 0 else dataclasses.replace(cfg, compute_dtype="float32")
        cache = init_cache(run_cfg, slots, length, device=dev)
        serve = make_serve_step(run_cfg)
        logits = []
        with (plain_grouped_matmul() if rank else contextlib.nullcontext()), \
                torch.no_grad():
            for t in range(n_tokens):
                sync()
                t0 = time.perf_counter()
                out, cache = serve(params, cache, tokens[t, :, None])
                sync()
                one_rank_ms.append(1e3 * (time.perf_counter() - t0))
                logits.append(out.float())
        one = {**bridge.flatten(cache), "logits": torch.cat(logits)}
        del cache, logits

    def from_rank(src, path, shape):
        """Rank ``src``'s ``path`` in fp32 on every rank."""
        buf = (one[path].float().contiguous() if rank == src
               else torch.empty(shape, dtype=torch.float32, device=dev))
        dist.broadcast(buf, src=src)
        return buf

    refs = [(from_rank(src, "logits", (n_tokens * slots, cfg.vocab_size)),
             {p: from_rank(src, p, shape)[slices[p]].clone() for p, shape in shapes.items()})
            for src in (0, 1)]
    del one
    t_ref = time.perf_counter()

    local = tree_map(lambda leaf, spec: leaf[shd.local_slices(spec, leaf.shape, mesh)].clone(),
                     params, shd.params_shardings(params, mesh))
    del params
    if on_card:
        torch.cuda.empty_cache()
    cache = init_cache(cfg, slots, length, device=dev, mesh=mesh)
    flat = bridge.flatten(cache)
    shard_shapes = all(tuple(flat[p].shape) == tuple(refs[0][1][p].shape) for p in shapes)
    serve = make_serve_step(cfg, mesh)
    moved: dict[str, list[int]] = {}

    def listen(event, *details):
        if event == events.COLLECTIVE:
            kind, _, nbytes = details
            count = moved.setdefault(kind, [0, 0])
            count[0] += 1
            count[1] += nbytes

    got, step_ms = [], []
    reset_launches()
    with torch.no_grad(), events.counting(listen):
        for t in range(n_tokens):
            sync()
            t0 = time.perf_counter()
            out, cache = serve(local, cache, tokens[t, :, None])
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            got.append(out.float())
    launches = launch_counts(path_kernels(cfg, backward=False))
    t_tp = time.perf_counter()

    got = torch.cat(got)
    first = 0 if got.shape[-1] == cfg.vocab_size else j * -(-cfg.padded_vocab // m)
    want, fp32 = (refs[r][0][:, first:first + got.shape[-1]] for r in (0, 1))
    gates = {"layers": cfg.n_layers, "gate": False, "depth_scale": depth_scale}
    agreement = logits_agreement(got, want, **gates)
    one_vs_fp32 = logits_agreement(want, fp32, **gates)
    tp_vs_fp32 = logits_agreement(got, fp32, **gates)

    def rel(a, b):
        """(||a - b|| / ||b||, max |a - b| / max |b|)"""
        a, b = a.float(), b.float()
        return ((a - b).norm().item() / max(b.norm().item(), 1e-30),
                (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30))

    flat = bridge.flatten(cache)
    cache_err = ({p: (*rel(flat[p], refs[0][1][p]), *rel(refs[0][1][p], refs[1][1][p]))
                  for p in shapes} if shard_shapes else {})
    cache_ok = shard_shapes and all(
        e[0] <= max(TP_DECODE_CACHE_REF * e[2], TP_DECODE_CACHE_FLOOR)
        for e in cache_err.values())
    worst = max(cache_err.items(), key=lambda kv: kv[1][0] / max(kv[1][2], 1e-30),
                default=(None, ()))
    keys = ("norm", "max", "ref_norm", "ref_max")
    out = {"rank": rank,
           "agrees": (agreement["within_bounds"] and cache_ok
                      and tp_vs_fp32["mean_rel_to_std"]
                      <= TP_DECODE_FP32_REF * one_vs_fp32["mean_rel_to_std"]),
           "agreement": agreement, "one_rank_vs_fp32": one_vs_fp32,
           "tp_vs_fp32": tp_vs_fp32, "cache_shard_shapes_equal": shard_shapes,
           "cache_rel_err": {p: dict(zip(keys, e)) for p, e in cache_err.items()},
           "cache_within_rounding": cache_ok, "cache_worst_leaf": worst[0],
           "cache_worst": dict(zip(keys, worst[1])),
           "launches": launches, "step_ms": float(np.median(step_ms)), "step_ms_each": step_ms,
           # rank 0's is one rank's bf16 decode, rank 1's its fp32 one
           "one_rank_step_ms": float(np.median(one_rank_ms)) if one_rank_ms else None,
           "collectives_a_step": {k: {"count": c / n_tokens, "bytes": b / n_tokens}
                                  for k, (c, b) in moved.items()},
           "view": shd.cache_view(cfg, m, j),
           # wall time: the init, one rank's decodes and their broadcast,
           # then the shards and the decode under the mesh
           "seconds": {"one_rank": t_ref - t_start, "model": t_tp - t_ref}}
    del refs, want, fp32, got
    if profile_tokens:
        sync()
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])) as trace:
            t0 = time.perf_counter()
            for t in range(profile_tokens):
                _, cache = serve(local, cache, tokens[t % n_tokens, :, None])
            sync()
            wall = time.perf_counter() - t0
        out["nccl_device_ms_a_step"] = (nccl_device_ms(trace) / profile_tokens
                                        if on_card else None)
        out["profile"] = {k: v for k, v in summarize(trace, wall, profile_tokens).items()
                          if k != "top_kernels_ms"}
    return out


def tp_decode_worker(rank: int, init_file: str, out_dir: str, device_type: str) -> None:
    """One of tp_decode's two ranks on card 0, a (data 1, model 2) mesh
    over gloo: ``tp_decode_check`` of each TP_DECODE_ARCHS, then
    dryrun_vs_card's (c) cells on this mesh.  Writes the results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get
    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=2)
    results = {}
    try:
        mesh = init_device_mesh(device_type, (1, 2), mesh_dim_names=("data", "model"))
        for arch in TP_DECODE_ARCHS:
            results[arch] = tp_decode_check(get(arch), mesh, dev)
            if device_type == "cuda":
                torch.cuda.empty_cache()
        results["dryrun"] = {
            f"{label} {arch} {fields[0]} rank {rank}": count_on_card(
                arch, fields, mesh, dev, timed=DRYRUN_TP_TIMED)
            for label, arch, fields, shape, _ in DRYRUN_CELLS if shape == (1, 2)}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_decode_gmm_entry(cfg, gen, dev, card, launches: int) -> dict:
    """The grouped GEMM at one model rank's decode shape of olmoe-1b-7b
    (4 slots, top-8: 32 rows, every expert's f 512 of 1024; a real
    routing's group sizes): a decode step's 3 calls a layer against the
    plain version, ``torch._grouped_mm`` and the bound."""
    from repro_torch.kernels import moe_gmm
    d, f, e, k = cfg.d_model, cfg.moe_d_ff // 2, cfg.n_experts, cfg.top_k
    rows = TP_DECODE_SLOTS * k
    sizes = moe_group_sizes(gen, dev, TP_DECODE_SLOTS, e, k)
    nonempty = int((sizes > 0).sum())
    x = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    hid = torch.randn((rows, f), generator=gen, device=dev).to(torch.bfloat16)
    w_in = (torch.randn((e, d, f), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    w_down = (torch.randn((e, f, d), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    calls = [(x, w_in), (x, w_in), (hid, w_down)] * cfg.n_layers
    errs = [gmm_errors(moe_gmm.grouped_matmul(a, w, sizes),
                       moe_gmm.grouped_matmul_plain(a, w, sizes)) for a, w in calls[1:3]]
    libs = [grouped_mm_call(a, w, sizes) for a, w in calls[:3]]
    no_lib = next((why for call, why in libs if call is None), None)
    floors = [gmm_floor_ms(rows, w.shape[1], w.shape[2], nonempty) for _, w in calls]
    mix = {"max_abs_err": max(er["max_abs_err"] for er in errs),
           "ms": time_ms(lambda: [moe_gmm.grouped_matmul(a, w, sizes) for a, w in calls], 5),
           "plain_ms": time_ms(lambda: [moe_gmm.grouped_matmul_plain(a, w, sizes)
                                        for a, w in calls], 1, 1),
           "library_ms": (None if no_lib else
                          time_ms(lambda: [c() for c, _ in libs * cfg.n_layers], 5))}
    mix["bound_ms"], mix["bound_by"] = bound(sum(fl[0] for fl in floors),
                                             sum(fl[1] for fl in floors))
    emit("kernel_tp_decode_mix", kernel="grouped_matmul", calls=len(calls),
         shape=[rows, d, f, e], nonempty_experts=nonempty,
         library=no_lib or "torch._grouped_mm", errors=errs, nvidia_smi=card, **mix)
    return {"name": "grouped_matmul", "route": "cuda", "source": GMM_SOURCE,
            "replaces": GMM_REPLACES, "launches": launches,
            "path": f"{cfg.name} TP decode, model 2 ({TP_DECODE_TOKENS} tokens, f 512)",
            **mix}


def dryrun_compare(meta: dict, card_runs: dict, card: str) -> list[str]:
    """Each card run against the dry run's count of the same cell and rank:
    a line each; the cells that fail the gates (DRYRUN_EQUAL equal, the
    peak within DRYRUN_PEAK_REL_TOL on one card, the step no shorter than
    the roofline's bound)."""
    bad = []
    for name, card_run in sorted(card_runs.items()):
        key = name if name in meta else f"{name} rank 0"
        m, c = meta[key], card_run["summary"]
        equal = {k: m[k] == c[k] for k in DRYRUN_EQUAL}
        line = {"cell": name, "meta": {k: m[k] for k in DRYRUN_EQUAL},
                "card": {k: c[k] for k in DRYRUN_EQUAL}, "equal": equal,
                "reckoned_peak_bytes": m["peak_bytes"],
                "max_memory_allocated": card_run["max_memory_allocated"],
                "peak_rel_err": abs(m["peak_bytes"] / card_run["max_memory_allocated"] - 1),
                "step_s": card_run["step_s"],
                "roofline_s": m["roofline"]["step_s_lower_bound"],
                "dominant": m["roofline"]["dominant"],
                "step_over_bound": card_run["step_s"] / m["roofline"]["step_s_lower_bound"]}
        if not all(equal.values()):
            line["ops_differing"] = {
                op: [m["ops"].get(op), c["ops"].get(op)]
                for op in set(m["ops"]) | set(c["ops"]) if m["ops"].get(op) != c["ops"].get(op)}
        emit("dryrun_vs_card", nvidia_smi=card, **line)
        peak_gated = not name.startswith("c ")
        if (not all(equal.values()) or line["step_s"] < line["roofline_s"]
                or (peak_gated and line["peak_rel_err"] > DRYRUN_PEAK_REL_TOL)):
            bad.append(name)
    return bad


def tp_decode_path(dev, card) -> list[dict]:
    """tp_decode and dryrun_vs_card.  tp_decode: TP_DECODE_ARCHS at full
    width and depth in two gloo ranks on the card at (data 1, model 2),
    each rank's logits within §2's decode gates of one rank's on the same
    weights and tokens and no further from the fp32-compute logits than
    TP_DECODE_FP32_REF times one rank's, its cache leaves exactly its
    shards' shapes and within the model's own rounding of one rank's
    slice (TP_DECODE_CACHE_REF, TP_DECODE_CACHE_FLOOR); the step's ms
    through gloo and the collective bytes a token reported.
    dryrun_vs_card: DRYRUN_CELLS counted on the meta device by the dry run
    (in a process started first, beside the ranks) and on the card by the
    same counter: FLOPs, HBM bytes, each kernel's calls and the collectives
    equal, the reckoned peak within DRYRUN_PEAK_REL_TOL of
    max_memory_allocated for (a) and (b), and the measured step no shorter
    than the roofline's bound.  Returns the kernels' entries."""
    import shutil
    import torch.multiprocessing as mp
    out_dir = Path(__file__).resolve().parent / "build" / "tp_decode"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    meta_proc, meta_path = dryrun_meta(out_dir)   # on the host, beside the ranks
    try:
        t0 = time.perf_counter()
        mp.start_processes(tp_decode_worker,
                           args=(str(out_dir / "store"), str(out_dir), dev.type),
                           nprocs=2, join=True, start_method="spawn")
        seconds = time.perf_counter() - t0
        ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]
        failures = []
        for arch in TP_DECODE_ARCHS:
            per = [r[arch] for r in ranks]
            ok = all(p["agrees"] for p in per)
            emit("tp_decode", arch=arch, mesh={"data": 1, "model": 2}, backend="gloo",
                 slots=TP_DECODE_SLOTS, cache_len=TP_DECODE_LEN, tokens=TP_DECODE_TOKENS,
                 cache_ref=TP_DECODE_CACHE_REF, cache_floor=TP_DECODE_CACHE_FLOOR,
                 fp32_ref=TP_DECODE_FP32_REF, ok=ok, nvidia_smi=card, ranks=per)
            if not ok:
                failures.append(arch)
        emit("tp_decode_section", seconds_both_ranks=seconds)

        # -- dryrun_vs_card --------------------------------------------------
        t0 = time.perf_counter()
        mp.start_processes(dryrun_vs_card_worker, args=(str(out_dir / "store1"), str(out_dir)),
                           nprocs=1, join=True, start_method="spawn")
        card_runs = torch.load(out_dir / "card.pt", weights_only=False)
        if meta_proc.wait() != 0:
            raise RuntimeError(f"the dry run of DRYRUN_CELLS failed: exit {meta_proc.returncode}")
        meta = json.loads(meta_path.read_text())
        for r in ranks:
            card_runs.update(r["dryrun"])
        bad = dryrun_compare(meta, card_runs, card)
        one, two = "a gemma3-1b train_4x2048", "d gemma3-1b train_4x2048"
        emit("dryrun_n_micro", arch="gemma3-1b", cells={"n_micro 1": one, "n_micro 2": two},
             card_peak_gb=[card_runs[c]["max_memory_allocated"] / 1e9 for c in (one, two)],
             reckoned_peak_gb=[meta[f"{c} rank 0"]["peak_bytes"] / 1e9 for c in (one, two)],
             step_s=[card_runs[c]["step_s"] for c in (one, two)], nvidia_smi=card)
        emit("dryrun_vs_card_section", seconds=time.perf_counter() - t0, cells=len(card_runs))
        if failures or bad:
            raise AssertionError(f"decode under model disagrees with one rank: {failures}; "
                                 f"the dry run's reckoning strays from the card: {bad}")
    finally:
        if meta_proc.poll() is None:
            meta_proc.kill()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    from repro_torch.configs import get
    olmoe = get("olmoe-1b-7b")
    return [tp_decode_gmm_entry(olmoe, gen, dev, card,
                                ranks[0]["olmoe-1b-7b"]["launches"]["grouped_matmul"])]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: the port's sources are not under {src}")
    sys.path.insert(0, str(src))

    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device()
    card = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    emit("environment", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0],
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # -- 2. build: every source, one nvcc each, all at once ------------------
    build_s = _build.build()
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in _build.build_log.items()}
    emit("build", seconds=build_s, sources=[FA_SOURCE, SSD_SOURCE, GMM_SOURCE],
         ptxas=ptxas, flags={name: ptxas_flags(log)
                             for name, log in _build.build_log.items()})

    kernels = [gemma3_path(dev, card)]
    torch.cuda.empty_cache()
    kernels += mamba2_path(dev, card)
    torch.cuda.empty_cache()
    kernels += hymba_path(dev, card)
    torch.cuda.empty_cache()
    kernels += hubert_path(dev, card)
    torch.cuda.empty_cache()
    kernels += hubert_train_path(dev, card)
    torch.cuda.empty_cache()
    kernels += internvl2_path(dev, card)
    torch.cuda.empty_cache()      # internvl2's 40 GB tree is gone from here
    kernels += dense_path(dev, card)
    torch.cuda.empty_cache()
    kernels.append(olmoe_path(dev, card))
    torch.cuda.empty_cache()
    gemma3_train_entry = gemma3_train_path(dev, card)
    kernels.append(gemma3_train_entry)
    torch.cuda.empty_cache()
    kernels += ssm_train_path(dev, card)
    torch.cuda.empty_cache()
    kernels += hymba_train_path(dev, card)
    torch.cuda.empty_cache()
    kernels += dense_train_path(dev, card)
    torch.cuda.empty_cache()
    kernels += moe_train_path(dev, card)
    torch.cuda.empty_cache()
    gang_path(dev, card)
    torch.cuda.empty_cache()
    # the mesh section: launch.train's data-parallel step on a one-rank
    # mesh, then the MoE dispatch under a mesh
    entries, one_rank_peak_gb = mesh_dp_path(dev, card, kernels[0], gemma3_train_entry)
    kernels += entries
    torch.cuda.empty_cache()
    kernels += mesh_moe_path(dev, card)
    torch.cuda.empty_cache()
    two_ranks_path(dev, card, one_rank_peak_gb)
    torch.cuda.empty_cache()
    # the tensor-parallel section, then the kernels at a model-4 rank's shapes
    kernels += tp_path(dev, card)
    torch.cuda.empty_cache()
    kernels += tp4_entries(dev, card, tp4_rank_steps(dev, card))
    torch.cuda.empty_cache()
    # decode under a model axis, and the dry run against the card
    kernels += tp_decode_path(dev, card)

    emit("done", seconds=time.perf_counter() - _START, kernel_entries=len(kernels))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
