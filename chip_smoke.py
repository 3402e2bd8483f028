#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --train train_sketch_reference [--src OLD/src]
    python3 chip_smoke.py --train train_overlap --train train_adaptive
    python3 chip_smoke.py --serve
    python3 chip_smoke.py --delta
    python3 chip_smoke.py --world 4
    python3 chip_smoke.py --mamba
    python3 chip_smoke.py --cost

The second form runs only the device and build phases and the named
train phases, each with its profile (no kernels line), from this
checkout's port or
from another source tree: an unpacked older commit's ``src/``, so that
two versions can be compared in one run on one card. The third runs only
the device, build and serve phases, the fourth only the device, build
and delta phases, the sixth only the device, build and mamba_layer
phases. The fifth needs
four cards and runs only the multi-card check: one process a card,
joined over NCCL, syncs 3 steps at J = 2^24 of REGTOP-k (fused, sparse
comm), of dense SGD, of REGTOP-k with the packed pairs in 4 chunks on
the bf16 wire, and of the sketch's values-only combine in 4 chunks on
the bf16 wire (bf16 state) and under participation bits with one rank
out a step; g_agg must be bitwise the same on every rank and, with
every rank's state, equal to an in-process ``round()`` of the same four
workers (for the chunked bf16 wire, to the same workers' compress steps
and an in-process chunk-by-chunk combine of their bf16-rounded values;
for the sketch, to the same workers' encodes, mean sketch and
values-only combine computed in one process). Then the multi-rank
phases, one process a card over NCCL: ``world_train`` (the launcher's
train() over the group: the main path, REGTOP-k fused with sparse comm,
on StableLM-3B at full width and 8 layers, global batch 32 x 128, 8
rows a rank, 5 steps; B1 and B2 launched exactly 5 times on every rank,
the flat parameters bitwise equal on every rank, each rank's peak, and
the ``train/sync`` and ``train/optimizer`` device spans of one more step
profiled on rank 0), ``world_train_dense`` (the same with the dense
all-reduce, ``--sparsifier none``: the paper's baseline across cards),
``world_train_small`` (the main path at 2 layers, whose parameters must
equal bit for bit rank 0's in-process replay of the four ranks' batches
through ``GradientSync.round`` and one whole-vector Adam),
``world_serve`` (serve() of a data-parallel batch of 8 on Granite-8B in
fp32 at full depth, prompt 48, 16 greedy steps, the gathered logits
within 2e-4 of a one-card forward on rank 0, decode ms a step) and
``world_decode_cp`` (context-parallel decode, batch 1, fp32, one line a
model: Granite-8B and DeepSeek-V2-Lite at full depth, MLA expanded and
absorbed, and Jamba-v0.1-52B at one super-block, a 4096-token prompt
prefilled on one card into 4160 cache slots, each rank 1040 of every
attention layer's slots and the whole Mamba state; xLSTM-125M at full
depth, every rank the whole state; 16 steps within 2e-4 of one-card
decode of the same cache, the logits and the recurrent leaves bitwise
across the ranks, decode ms a step beside one-card decode on rank 0's
card). At a world of
4 the tensor-parallel phases follow (``--tp`` runs them alone), over
(data, model) grids of the cards: ``world_train_tp`` (the main path on
StableLM-3B at full width, 8 layers, (data 1, model 4), batch 8 x 128, 5
steps: B1 and B2 exactly 5 times on every rank over its own J_local, the
step-0 loss within 1e-5 and gradient within 1e-4 of one card's at the
same parameters gathered, the replicated leaves' gradients bitwise
across the model group), ``world_train_tp2x2`` (the same on (2, 2),
batch 16, the parameters bitwise across each data pair),
``world_train_ep`` (Granite-MoE-3B-A800M, 8 layers, (1, 4): 10 experts
a card, the all_to_all's ms, the drop share), ``world_train_mla``
(DeepSeek-V2-Lite-16B at full width, the dense prefix and 7 MoE layers,
(1, 4): MLA split by heads, 16 experts a card, step 0 against one card
at capacity factor 16 without the load-balance term), ``world_train_xlstm``
(xLSTM-125M at full width, 4 of its 12 layers, on (2, 2), batch 16: the
mLSTM's value dims and the sLSTM's channels split, step 0 against one
card), ``world_train_whisper`` (Whisper-small at full width and depth,
12 + 12 layers, 1500 frames whole on every card, (1, 4): 3 heads a card,
step 0 against one card), ``world_train_phi3v`` (Phi-3-vision-4.2B at
full width and depth, 32 layers, 8 x 1024 tokens with 576 patches, (1,
4), step 0 against one card), ``world_train_ring`` (StableLM-3B at full
width, 8 layers, ring attention on (1, 4), 2 x 8192 positions, 2048 a
card; not a one-card model: launches, peak, a finite falling loss),
``world_serve_tp`` (serve() over a model group of 4 in fp32 at full width
and depth, one line a model: Qwen1.5-32B, 35.2 GB of weights a card;
DeepSeek-V2-Lite in both MLA forms; Jamba-v0.1-52B at 32 layers, 12.9 B
parameters a card; Whisper-small with its frames; Phi-3-vision-4.2B at a
1024-token prompt with its patches; decode within 2e-4 of the
tensor-parallel full forward, decode ms beside its bytes bound),
``world_mamba_layer`` (one Mamba layer at Jamba's width split by channel
over the four cards, forward and forward plus backward ms at 1024
positions beside one card's in the same run, its output within 1e-5 of
one card's), ``world_ring_layer`` (one StableLM-3B attention layer and
one DeepSeek-V2-Lite MLA layer, fp32, the weights model rank 0's on
every card, ring forward and backward at 8192 positions against the same
layer on one card: output and input gradient within 1e-5 of the scale,
ms beside one card's) and ``world_ckpt_tp`` (the launcher's train() of
StableLM-3B at 2 layers on (1, 4) with a checkpoint directory and
published deltas: the restore equal to the live state bit for bit on
every rank, a replica from the version-0 snapshot and the deltas equal
to the parameters joined over the group) and ``world_apply_tp`` (the same
trainer's spool served through serve() by two replicas from the
version-0 snapshot, over the model group (1, 4) and data-parallel (4,
1), each with the delta applier over its group and the spool read on
rank 0 through a ``loss:0.4,seed=2`` channel and broadcast: each ends
equal to the joined parameters bit for bit, with the same counters on
every rank and its pinned tree unchanged; intake and apply ms a rank
beside one rank's apply ms). ``--tp NAME ...`` runs only the named
phases of the multi-card run (the tensor-parallel ones,
``world_decode_cp`` and ``world_allgather``: NCCL's all-gather of 64 KiB,
the collective launch floor ``roofline.analysis.COLLECTIVE_LATENCY_S``
holds, and of 256 MB, beside NVLink's data-sheet rate).

``--cost`` runs only the device, build and kernels phases, the ``train``
cell and the cost models' phases: ``train_auto_buckets`` (the ``train``
cell with ``num_buckets=0`` through train(), B1 and B2 once a resolved
bucket a step, its parameters bit for bit those of the run with the
count written out), ``roofline`` (the same cell traced by the dry run's
tracer on the meta device: its three terms and lower bound beside the
measured steps 1-4, the memory model's peak beside the measured one, the
card's memory beside the model's capacity, a 1 GiB device copy's rate
beside the data sheet's, and B1's and B2's byte contracts over the
memory rate at most 1.05 x their measured times) and
``mla_encoder_layer`` (one bidirectional MLA layer at Whisper-small's
width and heads with DeepSeek-V2-Lite's kv_lora_rank and rope_head_dim
over 1500 frames, both forms in fp32 within 1e-5 of an fp64 one-softmax
form, and their ms). In the full run train_auto_buckets and roofline
follow the train cells, and mla_encoder_layer follows mamba_layer.

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; exits non-zero without either, and when run
outside a checkout of this repository. Phases, each printing one JSON
line and raising on any failure:

1. device:   the card, its power limit, the torch / CUDA / nvcc versions;
2. build:    compiles every kernel of the main path from ``csrc/``;
3. kernels:  each kernel against its plain PyTorch version on the card
             (``torch.equal`` on every output) at the main path's shape
             and at a small ragged shape, with CUDA-event timings;
4. compress: the compressors on the card against the same calls on CPU
             copies, bitwise, 3 steps each at J = 2^24: fused REGTOP-k
             and DGC (momentum 0.9), then the capability matrix: 8
             buckets with the bf16 state (REGTOP-k, DGC), the fused
             histogram selector (REGTOP-k, DGC; its live count in [k,
             2k]), the bf16 state under participation, thresholdk and
             randk on the fused pipeline and on the reference pipeline;
5. sketch_sync: sketch-coordinated GradientSync (kind="sketchtopk") at
             J = 2^24, 3 steps, fused pipeline (kernel sweep1_sketch) and
             reference pipeline (kernel sketch_encode), on the card and on
             CPU copies: a bitwise, the sketch within its stated bound,
             then the card's mean sketch decoded on both devices: indices,
             g_agg and the error state bitwise; then sketch_elastic_sync:
             both pipelines in fp32 and bf16 state (8 chunks on the bf16
             wire) on the card, an all-in participation bit equal bit for
             bit to no bit over 3 steps (dyadic gradients), a sitting-out
             step giving g_agg 0 and the decayed error;
6. train:    the port's main path through its launcher: StableLM-3B at
             full width cut to 8 layers, a few REGTOP-k sparse-sync steps,
             with every kernel's launch count read around that run;
7. profile:  one more step of that run under torch.profiler: device time
             by kernel and by stage of the step, and the device busy share
             (the step's new sync builds the sketch path's start table
             again, inside ``sketch/encode``);
8. train_sketch, profile_sketch: the same for the sketchtopk path (fused
             pipeline), after the REGTOP-k run's state is released;
9. reference_sync: GradientSync on the reference pipeline at J = 2^22,
             3 steps, card vs CPU copies bitwise (g_agg and every state
             vector): dense REGTOP-k with the exact selector and sparse
             comm, with the histogram_kernel selector (sparse degrades to
             simulate, one warning), and the O(k) layout with simulate
             comm;
10. train_reference, profile_reference: the reference launcher's default
             config (REGTOP-k, reference pipeline, dense posterior, exact
             selector, simulate comm) through the same launcher, with the
             dense score and apply kernels launched once per step;
11. train_sketch_reference, profile_sketch_reference: the launcher's
             defaults with ``--sparsifier sketchtopk`` (reference
             pipeline, exact selector, simulate comm): the encode
             ``sketch_encode`` and the apply kernel once per step;
12. train_dgc, profile_dgc: DGC (momentum 0.9) on the fused pipeline
             with sparse comm: sweep 1 in its dgc mode (``sweep1_dgc``)
             and sweep 2 once per step;
13. train_dgc_reference, profile_dgc_reference: the launchers' defaults
             with ``--sparsifier dgc`` (reference pipeline, exact
             selector, simulate comm): the momentum update in PyTorch and
             the apply kernel once per step;
14. train_elastic_dgc, profile_elastic_dgc: elastic participation, DGC
             on the fused pipeline with sparse comm, err_decay 0.9 and
             the fault schedule ``bursty:period=3,outage=1,workers=0``
             (the one rank sits out steps 0 and 3): sweep 1's gated
             variant (``sweep1_gated``) and sweep 2 once per step, and
             n_active [0, 1, 1, 0, 1];
15. train_elastic_reference, profile_elastic_reference: the reference
             launcher's defaults under the same schedule and decay: the
             dense score and apply kernels once per step;
16. train_dense, profile_dense: the dense baseline (``--sparsifier
             none``: the dense all-reduce, no kernel), whose stage spans
             are what the other cells' compression shares are stated
             against;
17. train_genie, profile_genie: the genie (``--sparsifier globaltopk``:
             the dense all-reduce, then the top-k over J; no kernel);
18. train_bucketed, profile_bucketed: REGTOP-k fused with 8 buckets, the
             bf16 error state and the bf16 wire: B1's bf16 read
             (``sweep1_bf16``) and B2 once a bucket, 8 a step;
19. train_hist, profile_hist: REGTOP-k fused with the histogram
             selector: B1 and B2 once a step, the live count in [k, 2k]
             on every step;
20. train_granite, profile_granite, train_starcoder2, profile_starcoder2:
             the main path (REGTOP-k fused, sparse comm: B1 and B2 once a
             step) on Granite-8B (rmsnorm, GQA kv 8; J = 1,056,993,280)
             and StarCoder2-7B (layernorm, GELU, QKV bias, GQA kv 4; J =
             1,104,301,056) at full width, depth cut to 3 layers;
20a. train_granite_moe, profile_granite_moe, train_deepseek,
             profile_deepseek: the main path on the MoE family at full
             width: Granite-MoE-3B-A800M (40 experts, top-8) cut to 8
             layers (J = 956,828,160) and DeepSeek-V2-Lite (MLA, 64
             experts top-6, 2 shared, a dense first layer) cut to its
             dense prefix and one MoE layer (J = 1,085,287,424); B1 and
             B2 once a step, and each step's lb_loss, z_loss and
             drop_frac printed; then train_xlstm, profile_xlstm: the
             main path on xLSTM-125M at full width cut to 4 layers
             (2 super-blocks of mLSTM and sLSTM, no FFN; J =
             106,402,304): B1 and B2
             once a step, and the profile's CUDA launches a step (each
             mixer's scan is a loop of eager steps over the 128
             positions); then train_phi3v, profile_phi3v: the main path
             on Phi-3-vision-4.2B at full width cut to 8 layers (J =
             1,103,023,104), batch 8 x 1024 (576 stub patches over the
             first positions, whose targets carry no loss, then 448 text
             targets a row); and train_whisper, profile_whisper: the
             main path on Whisper-small at full width and depth (12
             encoder and 12 decoder layers, J = 278,115,840), batch 8 x
             128 tokens with 8 x 1500 stub frames; B1 and B2 once a
             step in each;
20b. train_proportional, train_adaptive, train_proportional_reference,
             train_overlap, each with its profile: density allocation and
             streaming over the S layer-aligned segments of the model
             (``path_segments``): REGTOP-k fused with the proportional
             split (B1, B2 S times a step), with the adaptive split under
             the fault schedule and err_decay 0.9 (B1's gated variant, B2
             S a step), the reference launcher's defaults with the
             proportional split (B5, B6 once a step), and the main path
             streamed behind the backward pass (``overlap="backward"``:
             B1, B2 S a step, fed from hooks on a side CUDA stream); after
             the last, ``overlap_equal`` syncs one gradient of it through
             the stream and through the flat call (torch.equal), and each
             profile reports its per-segment ``compress/sweeps`` spans
             against ``train/loss_grad`` (a streamed step must start one
             before the backward pass ends);
21. serve:   the serve launcher's serve() at its defaults (batch 8, prompt
             48, 16 greedy decode steps) at full width and depth: Granite-
             8B with full attention, with a sliding window of 32 (the
             ring buffer wraps) and at a 4096-token prompt (a 4.8 GB bf16
             cache), StarCoder2-7B with full attention; in fp32 the
             prefill's and the last decode step's logits within 2e-4 of
             the full forward's (relative to its largest logit at those
             positions, tests/test_models.py's bound), then in the
             config's bf16 (its error printed): prefill ms, decode ms a
             step (the median and spread of 5 more windows of 16 steps)
             beside the bytes bound of the step (the weights, in bf16
             with the cast of every fp32 weight at its use: 8 B a
             parameter; B rows of the token table; the valid cache
             slots), tokens a second, peak memory, one profiled step;
             then the MoE family at full depth: Granite-MoE-3B-A800M
             (32 layers) in fp32 and bf16, DeepSeek-V2-Lite (27 layers,
             15.7 B parameters) in fp32 with MLA expanded and absorbed
             (the absorbed form held against the expanded full forward;
             no bf16 cell: bf16 copies beside the fp32 masters would
             need about 94 GB). An MoE cell serves, and takes its full
             forward, at capacity factor 16, where no choice is dropped
             (the served run's own drop share printed); its bytes bound
             counts the experts the profiled step routes to, beside the
             bytes of the all-experts products it runs; then the
             recurrent families: xLSTM-125M at full depth in fp32 and
             bf16 (its bytes bound reads and writes every layer's fp32
             state), and Jamba-v0.1-52B at full width cut to one
             super-block of 8 layers (13,295,235,072 parameters: Mamba,
             attention at position 4, MoE on the odd positions) in fp32
             only (bf16 copies beside the 53.2 GB of fp32 masters would
             not fit), at capacity factor 16; then the vision and
             audio families at full depth, fp32 and bf16:
             Phi-3-vision-4.2B (32 layers) at a prompt of 1024 (576
             stub patches and 448 text tokens: every decode position
             lies past the patches) and Whisper-small (12 + 12 layers)
             at a prompt of 48 with 1500 stub frames, whose cross k and
             v every decode step reads (its bytes bound counts them, and
             neither the encoder's weights nor the cross layers' k and
             v projections); the full forward takes the same patches or
             frames; in every fp32 cell each two rows' logits lie
             further apart than the error limit, so that a fault of one
             row shows;
21a. mamba_layer: one Mamba layer at Jamba's width (d_model 4096,
             d_inner 8192, d_state 16, dt_rank 256) in fp32, batch 8, at
             seq 128 (one scan chunk) and 1024 (two chunks of 512), with
             the chunks recomputed in the backward pass (``remat``):
             forward ms and forward plus backward ms (CUDA events),
             their peak memory and CUDA launches, every gradient finite,
             and the forward of the first MAMBA_FP64_ROWS rows within
             MAMBA_FP64_RTOL of the same function in fp64 (max |error|
             over the largest |y|);
20c. train_sketch_elastic, train_sketch_bucketed,
             train_sketch_reference_elastic, train_sketch_hist,
             train_reference_bf16, each with its profile: sketchtopk fused
             under the fault schedule with err_decay 0.9 (B3's gated form
             once a step, n_active [0, 1, 1, 0, 1]); with 8 buckets, the
             bf16 state and wire (B3's bf16 read once a step: the encode
             is flat, the buckets chunk the values-only wire); the
             reference pipeline with a bf16 state and sparse comm under
             the schedule (B4 once a step); the reference launcher's
             sketch defaults with the histogram_kernel selector (B4, B7
             and B6 once a step); REGTOP-k at the reference launcher's
             defaults with a bf16 state (B5's bf16 read and B6 once a
             step);
22. delta:   learning while serving in one process: the train phase's
             cell publishes a delta of k = 892,032 after each of its 5
             steps (B1, B2 once a step) to a spool, with the version-0
             and final snapshots and a checkpoint at the end; the
             checkpoint restores torch.equal to the final params,
             optimizer and error state; a replica from the version-0
             snapshot serves through serve() (batch 8, prompt 48, 16
             steps), draining the spool between decode steps through a
             receive-side ``loss:0.4,seed=2`` channel: a gap, a resync,
             and a final tree torch.equal to the publisher's mirror,
             the pinned decode tree unchanged; every payload's checksum
             equal to a numpy one and the card's; publish ms (by part),
             apply ms, wire bytes, snapshot seconds, decode ms with and
             without the applies, peak memory.

Between phases 9 and 10 runs the paper phase (paper_round, paper_fig1,
paper_fig2, paper_genie, paper_fig2_table, paper_fig3, paper): one
``make_round_fn`` round of topk, regtopk and sketchtopk at fig2's shape
(N = 20, J = 100) and fig3's (N = 8, J = 77,370) on the card and on CPU
copies of the same inputs (g_agg and every state bitwise; the sketch
within its bound, then the card's mean sketch decoded on both devices),
then the paper's drivers on the card: fig1, fig2 at S = 0.6 for 1500
iterations, the genie at fig2's size, EXPERIMENTS.md's fig2 table (at
600 iterations, where it has 3000) and fig3 for 150 iterations, held to
the claims of
tests/test_paper_claims.py, with each figure's seconds and launches.

Phase 3 holds sweep 1 in its dgc mode against its plain version too
(kernels_dgc: a, score, amax, hist and mom' with ``torch.equal``, at the
main J and the ragged J), and its gated variant in both modes
(kernels_gated: gate 1 equal to the ungated kernel, gate 0 with decay
0.9 equal to the plain version, bit for bit), and its bf16 read in every
mode at one bucket's shape, J / 8 (kernels_bf16: each output equal to
the fp32 kernel's on the upcast inputs and to the plain version). Phase 4 also runs 3 fused
steps of each kind under participation (1, 0, 1) with err_decay 0.9.
Phase 3's ``kernels_segments`` sweeps each of those S segments with B1
into views of (J,) buffers and B2 at the segment's own tau and slot
count, proportional and adaptive, and once more one element past the
first segment's start (an unaligned address), each against its plain
version with ``torch.equal``.
Phase 3 also holds the two CountSketch encodes (kernels_sketch, B3 and
B4 on the same partitioned passes and one shared start table): B3's a
with ``torch.equal``, both sketches with ``torch.equal`` on dyadic inputs
(every bucket sum exact in any order) and within the per-bucket bound of
``kernel.sketch_error_bound`` on Gaussian inputs, where the card's
atomics add in another order than the plain version, at the ragged J
(widths 512, below the partition width and not a multiple of it, and
beyond the 2^24 buckets a hash reaches; 1 and 3 rows) and at the main
shape; also the start table against the plain one, whether two runs of
each encode give the same bits, the chunks and pair buffer, the time to
build the start table, and each encode's time by kernel; then B3's
gated form (gate 0 and 1) and bf16 read (kernels_sketch_modes: a with
``torch.equal`` to the plain version, the sketch as above, gate 1 equal
to the ungated kernel) at the ragged J (two widths) and the main shape.
Then the dense REGTOP-k score and apply (kernels_fused_ef, bit patterns
equal, over a grid of mu, Q and omega with exact zeros of a and zero
divisors; the score's bf16 read too) and the
linear histogram (kernels_topk_select, counts equal, on Gaussian, zero,
edge, NaN and concentrated inputs and on every bin edge and its fp32
neighbours for four amax values, the floor included; timed beside
``torch.histc`` on the Gaussian and the concentrated input).

After the train phases one line, ``compression_share``, states each
StableLM cell against ``train_dense`` from the same run: the profiled step's
compression stages as device ms and as a share of its wall time, and the
median of steps 1-4 over the dense cell's on the host clock, marked
unresolved where it is within the dense cell's own spread. The last three lines are the
per-kernel summary, the card's name and power limit as ``nvidia-smi``
prints them, and the result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: device memory rate, fp32 rate outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SPARSITY = 0.001
MU = 0.5                     # the launcher's default --mu
TRAIN_LAYERS = 8             # StableLM-3B depth cut 32 -> 8, widths unchanged
TRAIN_STEPS = 5
MAIN_J = 892_032_000         # flat J of that model (ModelConfig.param_count)
RAGGED_J = 5 * 4096 + 123
COMPRESS_J = 1 << 24
SKETCH_ROWS = 3
MAIN_WIDTH = 3_568_128       # resolve_width(k = 892,032): 4k, under 2^22
SYNC_STEPS = 3
TIMING_REPS = 10
REF_SYNC_J = 1 << 22
# B3 at widths below the partition width 2^14, not divisible by it, and
# beyond the 2^24 buckets that a hash reaches
SKETCH_EXTRA_WIDTHS = (1000, (1 << 14) + 1, 100_003, (1 << 24) + 1000)
# amax values of B7's edge-neighbour input; 0.0 is floored to f32(1e-30)
HIST_EDGE_AMAX = (1.0, 4.0, 3.7e-3, 0.0)
# (mu, Q, omega) grid of the dense REGTOP-k score kernel
EF_GRID = [(mu, q, w) for mu in (0.1, 0.5) for q in (0.0, 0.3)
           for w in (1.0, 0.125)]
# the reference launcher's default sparsifier (repro.launch.train)
REFERENCE_DEFAULT = dict(kind="regtopk", pipeline="reference",
                         state_format="dense", selector="exact",
                         comm_mode="simulate")
# the same launcher defaults with --sparsifier sketchtopk
SKETCH_REFERENCE = dict(kind="sketchtopk", pipeline="reference",
                        comm_mode="simulate", selector="exact")
# and with --sparsifier dgc
DGC_REFERENCE = dict(kind="dgc", pipeline="reference", comm_mode="simulate",
                     selector="exact")
DGC_MOMENTUM = 0.9           # SparsifierConfig.momentum's default
ERR_DECAY = 0.9              # a sitting-out worker's error-feedback decay
ELASTIC_MASK = (True, False, True)             # phase compress, elastic
# the one rank sits out the first step of every 3: steps 0 and 3 of 5
FAULT_SCHEDULE = "bursty:period=3,outage=1,workers=0"
ELASTIC_ACTIVE = [0.0, 1.0, 1.0, 0.0, 1.0]
SKETCH_TABLE = [[MAIN_J, SKETCH_ROWS, MAIN_WIDTH]]   # (J, rows, width)
FUSED = dict(comm_mode="sparse", pipeline="fused")
BUCKETS = 8                  # train_bucketed: J / 8 = 111,504,000 a bucket
BUCKET_J = MAIN_J // BUCKETS
BF16 = dict(ef_dtype="bfloat16", wire_dtype="bfloat16")
# the train phases in run order: sparsifier fields, the kernels that
# each launches once a step, or {kernel: launches a step} (every other
# kernel 0 times), and the fault schedule ("" = every step in)
ELASTIC = dict(err_decay=ERR_DECAY)
SEGS = "S"                   # once a segment of the path's cut, a step
TRAIN_PATHS = {
    "train": (dict(kind="regtopk", **FUSED), ("sweep1", "sweep2"), ""),
    "train_sketch": (dict(kind="sketchtopk", **FUSED), ("sweep1_sketch",),
                     ""),
    "train_reference": (REFERENCE_DEFAULT, ("scores", "apply"), ""),
    "train_sketch_reference": (SKETCH_REFERENCE, ("sketch_encode", "apply"),
                               ""),
    "train_dgc": (dict(kind="dgc", **FUSED), ("sweep1_dgc", "sweep2"), ""),
    "train_dgc_reference": (DGC_REFERENCE, ("apply",), ""),
    "train_elastic_dgc": (dict(kind="dgc", **FUSED, **ELASTIC),
                          ("sweep1_gated", "sweep2"), FAULT_SCHEDULE),
    "train_elastic_reference": (dict(REFERENCE_DEFAULT, **ELASTIC),
                                ("scores", "apply"), FAULT_SCHEDULE),
    # the baselines: dense SGD (the dense all-reduce) and the genie (the
    # dense all-reduce, then the top-k over J); no kernel
    "train_dense": (dict(kind="none"), (), ""),
    "train_genie": (dict(kind="globaltopk"), (), ""),
    # the fused pipeline's capability matrix: 8 buckets with the bf16
    # state and wire (B1's bf16 read and B2 once a bucket), and the
    # histogram selector (a live count in [k, 2k] each step)
    "train_bucketed": (dict(kind="regtopk", num_buckets=BUCKETS, **FUSED,
                            **BF16),
                       {"sweep1_bf16": BUCKETS, "sweep2": BUCKETS}, ""),
    "train_hist": (dict(kind="regtopk", selector="histogram", **FUSED),
                   ("sweep1", "sweep2"), ""),
    # the main path (REGTOP-k fused, sparse comm) on the other dense
    # layouts: rmsnorm and GQA kv 8; layernorm, GELU, QKV bias, GQA kv 4
    "train_granite": (dict(kind="regtopk", **FUSED), ("sweep1", "sweep2"),
                      ""),
    "train_starcoder2": (dict(kind="regtopk", **FUSED),
                         ("sweep1", "sweep2"), ""),
    # the main path on the MoE family: routed experts (top-8 of 40);
    # MLA, shared experts and a dense prefix layer
    "train_granite_moe": (dict(kind="regtopk", **FUSED),
                          ("sweep1", "sweep2"), ""),
    "train_deepseek": (dict(kind="regtopk", **FUSED), ("sweep1", "sweep2"),
                       ""),
    "train_xlstm": (dict(kind="regtopk", **FUSED), ("sweep1", "sweep2"),
                    ""),
    # the main path on the vision (a patch stub) and audio (an encoder
    # over a frame stub, cross-attention) families
    "train_phi3v": (dict(kind="regtopk", **FUSED), ("sweep1", "sweep2"),
                    ""),
    "train_whisper": (dict(kind="regtopk", **FUSED), ("sweep1", "sweep2"),
                      ""),
    # density allocation and streaming over the S layer-aligned segments
    # of the model (S worked out by path_segments): B1 and B2 once a
    # segment; the adaptive split under the fault schedule (B1's gated
    # variant); the reference launcher's defaults with the proportional
    # split (B5, B6 once a step); the main path streamed behind the
    # backward pass
    "train_proportional": (dict(kind="regtopk", allocation="proportional",
                                **FUSED), {"sweep1": SEGS, "sweep2": SEGS},
                           ""),
    "train_adaptive": (dict(kind="regtopk", allocation="adaptive", **FUSED,
                            **ELASTIC),
                       {"sweep1_gated": SEGS, "sweep2": SEGS},
                       FAULT_SCHEDULE),
    "train_proportional_reference": (
        dict(REFERENCE_DEFAULT, allocation="proportional"),
        ("scores", "apply"), ""),
    "train_overlap": (dict(kind="regtopk", overlap="backward", **FUSED),
                      {"sweep1": SEGS, "sweep2": SEGS}, ""),
    # the sketch's elastic, bucketed and bf16 paths: B3's gated form under
    # the fault schedule; 8 buckets with the bf16 state and wire (B3's bf16
    # read once a step: the encode stays flat, the buckets chunk the
    # values-only wire); the reference pipeline with a bf16 state under the
    # schedule (B4); and its histogram_kernel selector with the simulate
    # combine (B4, B7 and B6)
    "train_sketch_elastic": (dict(kind="sketchtopk", **FUSED, **ELASTIC),
                             ("sweep1_sketch_gated",), FAULT_SCHEDULE),
    "train_sketch_bucketed": (dict(kind="sketchtopk", num_buckets=BUCKETS,
                                   **FUSED, **BF16),
                              ("sweep1_sketch_bf16",), ""),
    "train_sketch_reference_elastic": (
        dict(SKETCH_REFERENCE, comm_mode="sparse", ef_dtype="bfloat16",
             **ELASTIC), ("sketch_encode",), FAULT_SCHEDULE),
    "train_sketch_hist": (dict(SKETCH_REFERENCE, selector="histogram_kernel"),
                          ("sketch_encode", "histogram", "apply"), ""),
    # REGTOP-k at the reference launcher's defaults with a bf16 state: B5's
    # bf16 read and B6
    "train_reference_bf16": (dict(REFERENCE_DEFAULT, ef_dtype="bfloat16"),
                             ("scores_bf16", "apply"), ""),
}
# the paths whose sync cuts the gradient into layer-aligned segments
SEGMENTED = ("train_proportional", "train_adaptive",
             "train_proportional_reference", "train_overlap")
# the train phases' model: (arch, depth, J); full widths, depth cut so
# that J and its fp32 compression and Adam state fit one card
TRAIN_MODEL = ("stablelm-3b", TRAIN_LAYERS, MAIN_J)
TRAIN_BATCH, TRAIN_SEQ = 8, 128
# a model's own train sequence length: Phi-3-vision's first 576 positions
# are patches without a target, so 128 would carry no loss at all
TRAIN_SEQS = {"phi-3-vision-4.2b": 1024}
TRAIN_MODELS = {"train_granite": ("granite-8b", 3, 1_056_993_280),
                "train_starcoder2": ("starcoder2-7b", 3, 1_104_301_056),
                "train_granite_moe": ("granite-moe-3b-a800m", 8,
                                      956_828_160),
                # the dense prefix layer and one MoE layer
                "train_deepseek": ("deepseek-v2-lite-16b", 2,
                                   1_085_287_424),
                # 2 of the 6 super-blocks of mLSTM and sLSTM: at full
                # depth the cell and its profile (about 150,000 eager
                # launches a step) took 140 s of the script's 1200
                "train_xlstm": ("xlstm-125m", 4, 106_402_304),
                "train_phi3v": ("phi-3-vision-4.2b", 8, 1_103_023_104),
                # full depth: 12 encoder and 12 decoder layers
                "train_whisper": ("whisper-small", 12, 278_115_840)}
# phase serve: the serve launcher's defaults, at full width and depth
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 48, 16
SERVE_WINDOW = 32            # examples/serve_batched.py's sliding variant
SERVE_LONG_PROMPT = 4096     # a context whose bf16 cache (4.8 GB) counts
SERVE_VISION_PROMPT = 1024   # 576 patches, then 448 text tokens
# (arch, attention, prompt length); each arch's cells in a row, so that
# its parameters are drawn once
# "absorb": MLA's absorbed form, held against the expanded full forward
SERVE_CELLS = (("granite-8b", "full", SERVE_PROMPT),
               ("granite-8b", "sliding", SERVE_PROMPT),
               ("granite-8b", "full", SERVE_LONG_PROMPT),
               ("starcoder2-7b", "full", SERVE_PROMPT),
               ("granite-moe-3b-a800m", "full", SERVE_PROMPT),
               ("deepseek-v2-lite-16b", "full", SERVE_PROMPT),
               ("deepseek-v2-lite-16b", "absorb", SERVE_PROMPT),
               ("xlstm-125m", "full", SERVE_PROMPT),
               ("jamba-v0.1-52b", "full", SERVE_PROMPT),
               ("phi-3-vision-4.2b", "full", SERVE_VISION_PROMPT),
               ("whisper-small", "full", SERVE_PROMPT))
# depth cuts of the served models (full depth otherwise): Jamba's 32
# layers hold 51.6 B parameters, one super-block of 8 fits the card
SERVE_DEPTH = {"jamba-v0.1-52b": 8}
# fp32 only: 62.8 GB (53.2 GB) of fp32 masters leave no room for bf16
# copies
SERVE_FP32_ONLY = {"deepseek-v2-lite-16b": "bf16 copies of the 15.7 B "
                   "parameters beside the fp32 masters would need about "
                   "94 GB of the card's 80",
                   "jamba-v0.1-52b": "bf16 copies of the 13.3 B parameters "
                   "of one super-block beside its fp32 masters would need "
                   "about 80 GB of the card's 80"}
MOE_SERVE_CAPACITY = 16.0    # tests/test_models.py's: no choice dropped
SERVE_REPS = 5               # decode windows timed after the launcher's run
SERVE_PARAMS = {"granite-8b": 8_254_689_280, "starcoder2-7b": 7_400_268_800,
                "granite-moe-3b-a800m": 3_374_295_552,
                "deepseek-v2-lite-16b": 15_706_484_224,
                "xlstm-125m": 164_669_952, "jamba-v0.1-52b": 13_295_235_072,
                "phi-3-vision-4.2b": 3_821_079_552,
                "whisper-small": 278_115_840}
SERVE_RTOL = 2e-4            # tests/test_models.py's decode-vs-full bound
# phase mamba_layer: Jamba's Mamba layer, batch 8, one chunk and two
MAMBA_ARCH = "jamba-v0.1-52b"
MAMBA_BATCH, MAMBA_SEQS = 8, (128, 1024)
MAMBA_REPS = 5               # CUDA-event timings of each call
MAMBA_FP64_ROWS = 2          # rows of the batch held against fp64 (each
                             # row is its own scan)
# max |y - y_fp64| over max |y_fp64|: 7.1e-7 on the CPU at seq 600 (one
# row); 4.1e-6 and 2.3e-6 on an H100 at seq 128 and 1024
MAMBA_FP64_RTOL = 1e-5
# phase delta: the train phase's cell publishing a delta after each step
# to a one-rank replica; the receive-side schedule loses versions 2, 4 and
# 5 of 5, so the replica applies v1, sees the gap at v3 and resyncs from
# the final snapshot
DELTA_SCHEDULE = "loss:0.4,seed=2"
DELTA_K = 892_032            # resolve_k at sparsity 0.001 over MAIN_J
DELTA_WIRE_BYTES = 7_136_280
DELTA_REPS = 5               # CUDA-event timings of each publish part
# bytes the phase writes under its temporary directory at most: the
# checkpoint (params, Adam's master, m and v, the error state: 5 J-vectors
# of fp32 and REGTOP-k's O(k) state), three snapshots (v0, v5 and the
# timed one), with a tenth for the zip members and the page cache
DELTA_DISK_BYTES = int(1.1 * 4 * MAIN_J * 8)
# phase paper: the round checks' (workers, J, sparsity), fig2's shape and
# fig3's (the CNN at width 16), and the iterations of each driver run
PAPER_SHAPES = ((20, 100, 0.6), (8, 77_370, 0.001))
PAPER_ROUND_KERNELS = {"topk": ("apply",), "regtopk": ("scores", "apply"),
                       "sketchtopk": ("sketch_encode", "apply")}
FIG1_ITERS = 100
FIG2_ITERS = 1500            # fig2's claims and the genie's
FIG2_TABLE_ITERS = 300       # EXPERIMENTS.md's table (3000 there), cut to
                             # keep the paper phase near two minutes
FIG3_ITERS = 150
KERNEL_META = {
    "sweep1": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
               "src/repro/kernels/compress/kernel.py:78"),
    "sweep1_dgc": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
                   "src/repro/kernels/compress/kernel.py:78"),
    "sweep1_gated": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
                     "src/repro/kernels/compress/kernel.py:78"),
    "sweep1_bf16": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
                    "src/repro/kernels/compress/kernel.py:78"),
    "sweep1_dgc_bf16": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
                        "src/repro/kernels/compress/kernel.py:78"),
    "sweep1_gated_bf16": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
                          "src/repro/kernels/compress/kernel.py:78"),
    "sweep2": ("src/repro_torch/kernels/compress/csrc/sweep2.cu",
               "src/repro/kernels/compress/kernel.py:223"),
    "sweep1_sketch": ("src/repro_torch/kernels/compress/csrc/sketch_parts.cu",
                      "src/repro/kernels/compress/kernel.py:335"),
    "sweep1_sketch_gated": (
        "src/repro_torch/kernels/compress/csrc/sketch_parts.cu",
        "src/repro/kernels/compress/kernel.py:335"),
    "sweep1_sketch_bf16": (
        "src/repro_torch/kernels/compress/csrc/sketch_parts.cu",
        "src/repro/kernels/compress/kernel.py:335"),
    "sweep1_sketch_gated_bf16": (
        "src/repro_torch/kernels/compress/csrc/sketch_parts.cu",
        "src/repro/kernels/compress/kernel.py:335"),
    "sketch_encode": ("src/repro_torch/kernels/compress/csrc/sketch_parts.cu",
                      "src/repro/kernels/compress/kernel.py:321"),
    "scores": ("src/repro_torch/kernels/fused_ef/csrc/fused_ef.cu",
               "src/repro/kernels/fused_ef/kernel.py:29"),
    "scores_bf16": ("src/repro_torch/kernels/fused_ef/csrc/fused_ef.cu",
                    "src/repro/kernels/fused_ef/kernel.py:29"),
    "apply": ("src/repro_torch/kernels/fused_ef/csrc/fused_ef.cu",
              "src/repro/kernels/fused_ef/kernel.py:47"),
    "histogram": ("src/repro_torch/kernels/topk_select/csrc/hist.cu",
                  "src/repro/kernels/topk_select/kernel.py:31"),
}


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; "t" is the script's elapsed seconds."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - START,
                      **fields}), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run_text(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_split_ms(fn) -> dict:
    """Device time by kernel of one call of ``fn`` (after a warm-up),
    from torch.profiler: how a wrapper's time divides among its
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> float:
    import torch
    err = 0.0
    for got, want in pairs:
        if got.is_floating_point():
            d = (got.double() - want.double()).abs()
            d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
            err = max(err, float(d.max()))
        else:
            err = max(err, float((got.long() - want.long()).abs().max()))
    return err


def all_kernels() -> tuple:
    """Every kernel wrapper of the port (each has a ``launches`` count)."""
    from repro_torch.kernels.compress import kernel as pk
    from repro_torch.kernels.fused_ef import kernel as fef
    from repro_torch.kernels.topk_select import kernel as hk
    return pk.KERNELS + fef.KERNELS + hk.KERNELS


def reset_launches() -> None:
    for fn in all_kernels():
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in all_kernels()}


def bits_equal(got, want) -> bool:
    """Equal bit patterns (NaN and the sign of zero included)."""
    import torch
    if got.dtype != want.dtype:
        return False
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    elif got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    return torch.equal(got, want)


def phase_device() -> str:
    import torch
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    from repro_torch.kernels import build
    nvcc = run_text([build.nvcc_path(), "--version"]).splitlines()[-1]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in reports.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def kernel_case(dev, j: int, seed: int, timed: bool) -> dict:
    """Both sweeps at flat length j on seeded inputs, kernel vs plain."""
    import torch
    from repro_torch.core.numerics import regularizer_factor
    from repro_torch.kernels.compress import kernel as pk
    from repro_torch.kernels.compress.ops import maxpb_for
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    c = torch.full((1,), regularizer_factor(0.0, MU), device=dev)
    k = max(1, round(SPARSITY * j))
    out1 = pk.sweep1(g, err, c)
    ref1 = pk.sweep1_plain(g, err, c)
    for name, got, want in zip(("a", "score", "amax", "hist"), out1, ref1):
        check(torch.equal(got, want), f"sweep1 {name} differs at J={j}")
    # tau and MAXPB as a REGTOP-k step after step 0 picks them
    tau = pk.threshold_from_hist(out1[3], 2 * k)
    maxpb = maxpb_for(k, j)
    out2 = pk.sweep2(out1[1], tau, maxpb)
    ref2 = pk.sweep2_plain(out1[1], tau, maxpb)
    for name, got, want in zip(("vals", "idx", "cnt"), out2, ref2):
        check(torch.equal(got, want), f"sweep2 {name} differs at J={j}")
    res = {"j": j, "k": k, "maxpb": maxpb, "tau": float(tau),
           "candidates": int(out2[2].clamp(max=maxpb).sum()),
           "overflow_tiles": int((out2[2] > maxpb).sum()),
           "sweep1_err": max_abs_err(zip(out1, ref1)),
           "sweep2_err": max_abs_err(zip(out2, ref2))}
    if timed:
        res["sweep1_ms"] = cuda_ms(lambda: pk.sweep1(g, err, c))
        res["sweep1_plain_ms"] = cuda_ms(lambda: pk.sweep1_plain(g, err, c))
        res["sweep1_bytes"] = pk.sweep1.bytes_moved(j)
        res["sweep1_ops"] = 4 * j      # add, multiply, abs, max
        res["sweep2_ms"] = cuda_ms(lambda: pk.sweep2(out1[1], tau, maxpb))
        res["sweep2_plain_ms"] = cuda_ms(
            lambda: pk.sweep2_plain(out1[1], tau, maxpb))
        res["sweep2_bytes"] = pk.sweep2.bytes_moved(j, maxpb)
        res["sweep2_ops"] = 2 * j      # abs, compare
    return res


def dgc_case(dev, j: int, seed: int, timed: bool) -> dict:
    """Sweep 1 in its dgc mode at flat length j, kernel vs plain: a,
    score, amax, hist and mom' equal. |mom| ~ |g|, so a multiply-add
    rounded twice would differ from the fused one in many elements."""
    import torch
    from repro_torch.kernels.compress import kernel as pk
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    mom = torch.randn(j, generator=gen, device=dev)
    c = torch.ones(1, device=dev)
    out = pk.sweep1_dgc(g, err, mom, c, DGC_MOMENTUM)
    ref = pk.sweep1_plain(g, err, c, mom, DGC_MOMENTUM)
    for name, got, want in zip(("a", "score", "amax", "hist", "mom"),
                               out, ref):
        check(torch.equal(got, want), f"sweep1_dgc {name} differs at J={j}")
    unfused = (mom * DGC_MOMENTUM + g).ne(out[4]).sum()
    res = {"j": j, "momentum": DGC_MOMENTUM,
           "sweep1_dgc_err": max_abs_err(zip(out, ref)),
           "mom_differs_from_two_roundings": int(unfused)}
    del ref
    if timed:
        res["sweep1_dgc_ms"] = cuda_ms(
            lambda: pk.sweep1_dgc(g, err, mom, c, DGC_MOMENTUM))
        res["sweep1_dgc_plain_ms"] = cuda_ms(
            lambda: pk.sweep1_plain(g, err, c, mom, DGC_MOMENTUM))
        # read g, err, mom; write a, score, mom'
        res["sweep1_dgc_bytes"] = pk.sweep1_dgc.bytes_moved(j)
        res["sweep1_dgc_ops"] = 6 * j  # fma (2), add, multiply, abs, max
    return res


def gated_case(dev, j: int, seed: int, timed: bool) -> dict:
    """Sweep 1's gated variant in both modes at flat length j: gate 1
    equals the ungated kernel and gate 0 (err_decay 0.9) the plain
    version, every output bit for bit. Every 97th err is -0.0, whose
    decayed value plus a zero must be +0.0."""
    import torch
    from repro_torch.core.numerics import regularizer_factor
    from repro_torch.kernels.compress import kernel as pk
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    err[::97] = -0.0
    mom = torch.randn(j, generator=gen, device=dev)
    on, off = torch.ones(1, device=dev), torch.zeros(1, device=dev)
    res = {"j": j, "decay": ERR_DECAY, "sweep1_gated_err": 0.0}
    for mode in ("plain", "dgc"):
        dgc = mode == "dgc"
        m = mom if dgc else None
        c = torch.full((1,), 1.0 if dgc else regularizer_factor(0.0, MU),
                       device=dev)
        got = pk.sweep1_gated(g, err, c, on, ERR_DECAY, m, DGC_MOMENTUM)
        want = pk.sweep1(g, err, c, m, DGC_MOMENTUM)
        for name, x, y in zip(("a", "score", "amax", "hist", "mom"), got,
                              want):
            check(bits_equal(x, y), f"sweep1_gated {mode} gate 1: {name} "
                  f"differs from the ungated kernel at J={j}")
        del got, want
        got = pk.sweep1_gated(g, err, c, off, ERR_DECAY, m, DGC_MOMENTUM)
        want = pk.sweep1_plain(g, err, c, m, DGC_MOMENTUM, off, ERR_DECAY)
        for name, x, y in zip(("a", "score", "amax", "hist", "mom"), got,
                              want):
            check(bits_equal(x, y), f"sweep1_gated {mode} gate 0: {name} "
                  f"differs from the plain version at J={j}")
        check(not bool(torch.signbit(got[0][::97]).any()),
              "sweep1_gated: -0.0 * decay + 0.0 must be +0.0")
        res["sweep1_gated_err"] = max(res["sweep1_gated_err"],
                                      max_abs_err(zip(got, want)))
        del got, want
    if timed:
        c = torch.ones(1, device=dev)
        res["sweep1_gated_ms"] = cuda_ms(lambda: pk.sweep1_gated(
            g, err, c, on, ERR_DECAY, mom, DGC_MOMENTUM))
        res["sweep1_gated_off_ms"] = cuda_ms(lambda: pk.sweep1_gated(
            g, err, c, off, ERR_DECAY, mom, DGC_MOMENTUM))
        res["sweep1_gated_plain_ms"] = cuda_ms(lambda: pk.sweep1_plain(
            g, err, c, mom, DGC_MOMENTUM, on, ERR_DECAY))
        # the dgc mode's bytes (read g, err, mom; write a, score, mom'),
        # the gate and c
        res["sweep1_gated_bytes"] = pk.sweep1_gated.bytes_moved(j, dgc=True)
        # selects of g, err and mom', decay multiply, fma (2), add,
        # multiply, abs, max
        res["sweep1_gated_ops"] = 10 * j
    return res


def bf16_case(dev, j: int, seed: int, timed: bool) -> dict:
    """B1's bf16 read in each mode (plain, dgc, gated in both modes) at
    flat length j: every output equal to the fp32 kernel's on the upcast
    inputs (g rounded to bf16, err and mom widened) and to the plain
    version, bit for bit; gate 0 decays with err_decay 0.9 and rounds
    the decayed error to bf16. Every 97th err is -0.0."""
    import torch
    from repro_torch.core.numerics import regularizer_factor
    from repro_torch.kernels.compress import kernel as pk
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = (torch.randn(j, generator=gen, device=dev) * 0.1).to(bf)
    err[::97] = -0.0
    mom = torch.randn(j, generator=gen, device=dev).to(bf)
    c = torch.full((1,), regularizer_factor(0.0, MU), device=dev)
    on, off = torch.ones(1, device=dev), torch.zeros(1, device=dev)
    g16, e32, m32 = g.to(bf).float(), err.float(), mom.float()
    names = ("a", "score", "amax", "hist", "mom")
    cases = {
        "sweep1_bf16": (lambda: pk.sweep1_bf16(g, err, c),
                        lambda: pk.sweep1(g16, e32, c),
                        lambda: pk.sweep1_plain(g, err, c)),
        "sweep1_dgc_bf16": (
            lambda: pk.sweep1_dgc_bf16(g, err, mom, c, DGC_MOMENTUM),
            lambda: pk.sweep1_dgc(g16, e32, m32, c, DGC_MOMENTUM),
            lambda: pk.sweep1_plain(g, err, c, mom, DGC_MOMENTUM)),
    }
    for gate in (on, off):
        for m, m_up in ((None, None), (mom, m32)):
            # gate 1 against the fp32 gated kernel on the upcast inputs;
            # gate 0 against the plain version (the fp32 kernel would
            # not round the decayed error to bf16)
            cases[("sweep1_gated_bf16", float(gate), m is None)] = (
                lambda gate=gate, m=m: pk.sweep1_gated_bf16(
                    g, err, c, gate, ERR_DECAY, m, DGC_MOMENTUM),
                (lambda m_up=m_up: pk.sweep1_gated(
                    g16, e32, c, on, ERR_DECAY, m_up, DGC_MOMENTUM))
                if gate is on else None,
                lambda gate=gate, m=m: pk.sweep1_plain(
                    g, err, c, m, DGC_MOMENTUM, gate, ERR_DECAY))
    res = {"j": j, "decay": ERR_DECAY}
    for name, (kern, fp32, plain) in cases.items():
        key = name if isinstance(name, str) else name[0]
        got = kern()
        for ref_name, ref in (("the fp32 kernel on the upcast inputs",
                               fp32), ("the plain version", plain)):
            if ref is None:
                continue
            want = ref()
            for out, x, y in zip(names, got, want):
                check(bits_equal(x, y), f"{name}: {out} differs from "
                      f"{ref_name} at J={j}")
            res[f"{key}_err"] = max(res.get(f"{key}_err", 0.0),
                                    max_abs_err(zip(got, want)))
            del want
        del got
    del g16, e32, m32
    if timed:
        res["sweep1_bf16_ms"] = cuda_ms(lambda: pk.sweep1_bf16(g, err, c))
        res["sweep1_bf16_plain_ms"] = cuda_ms(
            lambda: pk.sweep1_plain(g, err, c))
        res["sweep1_bf16_bytes"] = pk.sweep1_bf16.bytes_moved(j)
        res["sweep1_bf16_ops"] = 5 * j             # round, add, mul, abs, max
        res["sweep1_dgc_bf16_ms"] = cuda_ms(
            lambda: pk.sweep1_dgc_bf16(g, err, mom, c, DGC_MOMENTUM))
        res["sweep1_dgc_bf16_plain_ms"] = cuda_ms(
            lambda: pk.sweep1_plain(g, err, c, mom, DGC_MOMENTUM))
        res["sweep1_dgc_bf16_bytes"] = pk.sweep1_dgc_bf16.bytes_moved(j)
        res["sweep1_dgc_bf16_ops"] = 7 * j
        res["sweep1_gated_bf16_ms"] = cuda_ms(lambda: pk.sweep1_gated_bf16(
            g, err, c, on, ERR_DECAY, mom, DGC_MOMENTUM))
        res["sweep1_gated_bf16_off_ms"] = cuda_ms(
            lambda: pk.sweep1_gated_bf16(g, err, c, off, ERR_DECAY, mom,
                                         DGC_MOMENTUM))
        res["sweep1_gated_bf16_plain_ms"] = cuda_ms(
            lambda: pk.sweep1_plain(g, err, c, mom, DGC_MOMENTUM, on,
                                    ERR_DECAY))
        res["sweep1_gated_bf16_bytes"] = pk.sweep1_gated_bf16.bytes_moved(
            j, dgc=True)
        res["sweep1_gated_bf16_ops"] = 12 * j
    return res


def phase_kernels(dev) -> dict:
    import torch
    small = kernel_case(dev, RAGGED_J, seed=1, timed=False)
    emit("kernels_ragged", **small)
    big = kernel_case(dev, MAIN_J, seed=0, timed=True)
    emit("kernels_main_shape", **big)
    torch.cuda.empty_cache()
    dsmall = dgc_case(dev, RAGGED_J, seed=9, timed=False)
    emit("kernels_dgc_ragged", **dsmall)
    dbig = dgc_case(dev, MAIN_J, seed=10, timed=True)
    emit("kernels_dgc_main_shape", **dbig)
    torch.cuda.empty_cache()
    gsmall = gated_case(dev, RAGGED_J, seed=11, timed=False)
    emit("kernels_gated_ragged", **gsmall)
    gbig = gated_case(dev, MAIN_J, seed=12, timed=True)
    emit("kernels_gated_main_shape", **gbig)
    torch.cuda.empty_cache()
    # B1's bf16 read at the shape train_bucketed gives it: one bucket
    bsmall = bf16_case(dev, RAGGED_J, seed=13, timed=False)
    emit("kernels_bf16_ragged", **bsmall)
    bbig = bf16_case(dev, BUCKET_J, seed=14, timed=True)
    emit("kernels_bf16_main_shape", **bbig)
    torch.cuda.empty_cache()
    return {"small": small, "big": big, "dgc_small": dsmall, "dgc_big": dbig,
            "gated_small": gsmall, "gated_big": gbig, "bf16_small": bsmall,
            "bf16_big": bbig}


def phase_kernels_segments(dev) -> dict:
    """B1 and B2 on the allocated main path's segments, kernel vs plain:
    each of the S layer-aligned segments of the StableLM cut swept by B1
    into views of (J,) buffers, then B2 at the segment's own tau and slot
    count in both modes (the proportional count or the adaptive cap as
    its provisioning, plus REGTOP-k's margin), and once more on views one
    element past the first segment's start (an unaligned base address);
    torch.equal on every output. Records each segment's slots and
    overflowing tiles, and B2's time on the largest segment at the
    adaptive slot count."""
    import torch
    from repro_torch.core import allocate
    from repro_torch.core.numerics import regularizer_factor
    from repro_torch.kernels.compress import kernel as pk
    bounds = path_segments(dict(allocation="adaptive"))
    sizes = [size for _, size in bounds]
    k = round(SPARSITY * MAIN_J)
    provs = {"proportional": [max(1, n) for n in
                              allocate.proportional_counts(k, sizes)],
             "adaptive": allocate.segment_caps(k, sizes)}
    gen = torch.Generator(device=dev).manual_seed(21)
    g = torch.randn(MAIN_J, generator=gen, device=dev)
    err = torch.randn(MAIN_J, generator=gen, device=dev) * 0.1
    c = torch.full((1,), regularizer_factor(0.0, MU), device=dev)
    a, score = torch.empty_like(g), torch.empty_like(g)
    errs = {"sweep1_err": 0.0, "sweep2_err": 0.0}
    segs, cases = [], list(enumerate(bounds))
    # the last case: one element past the first segment's start
    cases.append((0, (bounds[0][0] + 1, bounds[0][1] - 1)))
    for i, (off, size) in cases:
        sl = slice(off, off + size)
        out1 = pk.sweep1(g[sl], err[sl], c, out=[a[sl], score[sl]])
        ref1 = pk.sweep1_plain(g[sl], err[sl], c)
        for name, got, want in zip(("a", "score", "amax", "hist"), out1,
                                   ref1):
            check(torch.equal(got, want),
                  f"sweep1 {name} differs on segment ({off}, {size})")
        errs["sweep1_err"] = max(errs["sweep1_err"],
                                 max_abs_err(zip(out1, ref1)))
        del ref1
        rec = {"offset": off, "size": size}
        for mode, pv in provs.items():
            prov = pv[i]
            tau = pk.threshold_from_hist(out1[3], prov + min(k, size))
            maxpb = int(min(pk.BLOCK, max(32, -(-8 * prov * pk.BLOCK
                                               // size))))
            out2 = pk.sweep2(score[sl], tau, maxpb)
            ref2 = pk.sweep2_plain(score[sl], tau, maxpb)
            for name, got, want in zip(("vals", "idx", "cnt"), out2, ref2):
                check(torch.equal(got, want),
                      f"sweep2 {name} differs on segment ({off}, {size}), "
                      f"{mode} maxpb {maxpb}")
            errs["sweep2_err"] = max(errs["sweep2_err"],
                                     max_abs_err(zip(out2, ref2)))
            rec[mode] = {"maxpb": maxpb, "tau": float(tau),
                         "overflow_tiles": int((out2[2] > maxpb).sum())}
        segs.append(rec)
    i = max(range(len(bounds)), key=lambda t: bounds[t][1])
    off, size = bounds[i]
    sl = slice(off, off + size)
    top = segs[i]["adaptive"]
    tau = torch.full((1,), top["tau"], device=dev)
    res = dict(errs, segments=segs, timed_segment=[off, size],
               sweep2_segment_ms=cuda_ms(
                   lambda: pk.sweep2(score[sl], tau, top["maxpb"])),
               sweep2_segment_plain_ms=cuda_ms(
                   lambda: pk.sweep2_plain(score[sl], tau, top["maxpb"])))
    emit("kernels_segments", **res)
    del g, err, a, score
    torch.cuda.empty_cache()
    return res


def dyadic(gen, j: int, dev):
    """k * 2^-8 with |k| <= 2^10: every partial sum of a bucket is exact
    in fp32, so any order of the atomics gives the sequential sum."""
    import torch
    k = torch.randint(-1024, 1025, (j,), generator=gen, device=dev)
    return k.float() * 2.0 ** -8


def sketch_gap(sk, sk_plain, a) -> tuple[float, float]:
    """(max |sk - sk_plain|, its largest share of the per-bucket bound);
    fails beyond the bound."""
    from repro_torch.kernels.compress import kernel as pk
    rows, width = sk_plain.shape
    bound = pk.sketch_error_bound(a, rows, width).to(sk_plain.device)
    d = (sk.to(sk_plain.device) - sk_plain).abs().double()
    check(bool((d <= bound).all()), "sketch outside its atomics bound")
    share = float((d / bound.clamp(min=1e-300)).max())
    return float(d.max()), share


def sketch_case(dev, j: int, width: int, seed: int, timed: bool,
                rows: int = SKETCH_ROWS) -> dict:
    """Both CountSketch encodes at flat length j, kernel vs plain, on
    dyadic inputs (bitwise) and on Gaussian inputs (a bitwise, the
    sketch within the atomics bound); B3's count kernel against its
    plain table, its plan, and whether two runs give the same bits."""
    import torch
    from repro_torch.kernels.compress import kernel as pk
    gen = torch.Generator(device=dev).manual_seed(seed)
    if not timed:     # the plain table walks every tile: small J only
        starts = pk.sketch_starts(dev, j, rows, width).int() & 0xFFFF
        want = pk.sketch_starts_plain(j, rows, width, device=dev) & 0xFFFF
        check(torch.equal(starts, want.int()),
              f"sweep1_sketch start table differs at J={j}, width={width}")
    tables = {}       # B3's start table of this shape, built at first use
    g, err = dyadic(gen, j, dev), dyadic(gen, j, dev)
    a, sk = pk.sweep1_sketch(g, err, rows, width, tables)
    a_p, sk_p = pk.sweep1_sketch_plain(g, err, rows, width)
    check(torch.equal(a, a_p), f"sweep1_sketch a differs at J={j} (dyadic)")
    check(torch.equal(sk, sk_p), f"sweep1_sketch sketch differs at J={j} "
          "(dyadic)")
    check(torch.equal(pk.sketch_encode(a, rows, width, tables),
                      pk.sketch_encode_plain(a, rows, width)),
          f"sketch_encode differs at J={j} (dyadic)")
    check(len(tables) == 1, "the two encodes share one start table")
    del g, err, a_p, sk, sk_p
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    a, sk = pk.sweep1_sketch(g, err, rows, width, tables)
    a_p, sk_p = pk.sweep1_sketch_plain(g, err, rows, width)
    check(torch.equal(a, a_p), f"sweep1_sketch a differs at J={j}")
    err1, share1 = sketch_gap(sk, sk_p, a_p)
    sk4 = pk.sketch_encode(a, rows, width, tables)
    err4, share4 = sketch_gap(sk4, sk_p, a_p)
    det4 = bits_equal(sk4, pk.sketch_encode(a, rows, width, tables))
    del sk4
    _, sk2 = pk.sweep1_sketch(g, err, rows, width, tables)
    plan = pk.sketch_plan(j, rows, width)
    res = {"j": j, "rows": rows, "width": width, "dyadic_bitwise": True,
           "sweep1_sketch_err": err1, "sweep1_sketch_bound_share": share1,
           "sketch_encode_err": err4, "sketch_encode_bound_share": share4,
           "sweep1_sketch_deterministic": bits_equal(sk, sk2),
           "sketch_encode_deterministic": det4,
           "sweep1_sketch_chunks": plan["nchunks"],
           "sweep1_sketch_parts": plan["parts"],
           "sweep1_sketch_pair_buffer_bytes": plan["pair_bytes"],
           "atomics": rows * j}
    del a_p, sk, sk2, sk_p
    if timed:
        res["sweep1_sketch_ms"] = cuda_ms(
            lambda: pk.sweep1_sketch(g, err, rows, width, tables))
        res["sweep1_sketch_split_ms"] = kernel_split_ms(
            lambda: pk.sweep1_sketch(g, err, rows, width, tables))
        # built once per shape, at a run's first step
        res["sweep1_sketch_table_ms"] = cuda_ms(
            lambda: pk.sketch_starts(dev, j, rows, width))
        res["sweep1_sketch_table_bytes"] = 2 * plan["parts"] * -(
            -j // pk.SKETCH_TILE)
        res["sweep1_sketch_plain_ms"] = cuda_ms(
            lambda: pk.sweep1_sketch_plain(g, err, rows, width))
        res["sweep1_sketch_bytes"] = pk.sweep1_sketch.bytes_moved(j, rows,
                                                                 width)
        res["sweep1_sketch_ops"] = j + rows * j   # add, one add per row
        # the partitioned design's own traffic: g, err, a and the pairs
        # written and read (6 B each)
        res["sweep1_sketch_design_bytes"] = 12 * j + 12 * rows * j
        res["sketch_encode_ms"] = cuda_ms(
            lambda: pk.sketch_encode(a, rows, width, tables))
        res["sketch_encode_split_ms"] = kernel_split_ms(
            lambda: pk.sketch_encode(a, rows, width, tables))
        res["sketch_encode_plain_ms"] = cuda_ms(
            lambda: pk.sketch_encode_plain(a, rows, width))
        res["sketch_encode_bytes"] = pk.sketch_encode.bytes_moved(j, rows,
                                                                 width)
        res["sketch_encode_ops"] = rows * j
        # the same design's traffic: a and the pairs written and read
        res["sketch_encode_design_bytes"] = 4 * j + 12 * rows * j
    return res


def phase_kernels_sketch(dev) -> dict:
    import torch
    small = sketch_case(dev, RAGGED_J, 512, seed=3, timed=False)
    emit("kernels_sketch_ragged", **small)
    for i, width in enumerate(SKETCH_EXTRA_WIDTHS):
        for rows in (1, SKETCH_ROWS):
            emit("kernels_sketch_ragged", **sketch_case(
                dev, RAGGED_J, width, seed=20 + i, timed=False, rows=rows))
    big = sketch_case(dev, MAIN_J, MAIN_WIDTH, seed=2, timed=True)
    emit("kernels_sketch_main_shape", **big)
    torch.cuda.empty_cache()
    return {"small": small, "big": big}


def sketch_modes_case(dev, j: int, width: int, seed: int, timed: bool,
                      rows: int = SKETCH_ROWS) -> dict:
    """B3's gated form (gate 0 and 1) and bf16 read (and both) at flat
    length j, kernel vs plain version: on dyadic inputs a and the sketch
    bitwise; on Gaussian inputs a bitwise and the sketch within the
    atomics bound (gate 0 on dyadic inputs too: the decayed error, 0.9
    times a dyadic value, is not dyadic); gate 1 equals the ungated fp32
    kernel's a on the widened state. Dyadic inputs at the small shapes
    only (the timed main shape runs the Gaussian ones). Every 97th err
    is -0.0, whose decayed value plus a zero must be +0.0."""
    import torch
    from repro_torch.kernels.compress import kernel as pk
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = {}
    on, off = torch.ones(1, device=dev), torch.zeros(1, device=dev)
    res = {"j": j, "rows": rows, "width": width, "decay": ERR_DECAY}
    names = ("sweep1_sketch_gated", "sweep1_sketch_bf16",
             "sweep1_sketch_gated_bf16")
    # dyadic inputs (bitwise sketches) at the small shapes only
    for inputs in ("gauss",) if timed else ("dyadic", "gauss"):
        if inputs == "dyadic":
            g, err = dyadic(gen, j, dev), dyadic(gen, j, dev)
        else:
            g = torch.randn(j, generator=gen, device=dev)
            err = torch.randn(j, generator=gen, device=dev) * 0.1
        err[::97] = -0.0
        e16 = err.to(torch.bfloat16)
        cases = []
        for gate in (on, off):
            cases.append(("sweep1_sketch_gated", gate, err, lambda gate=gate:
                          pk.sweep1_sketch_gated(g, err, gate, ERR_DECAY,
                                                 rows, width, tables)))
            cases.append(("sweep1_sketch_gated_bf16", gate, e16,
                          lambda gate=gate: pk.sweep1_sketch_gated_bf16(
                              g, e16, gate, ERR_DECAY, rows, width, tables)))
        cases.append(("sweep1_sketch_bf16", None, e16, lambda:
                      pk.sweep1_sketch_bf16(g, e16, rows, width, tables)))
        for name, gate, e, run in cases:
            a, sk = run()
            a_p, sk_p = pk.sweep1_sketch_plain(g, e, rows, width, gate,
                                               ERR_DECAY)
            tag = f"{name} gate {None if gate is None else float(gate)}"
            check(bits_equal(a, a_p), f"{tag}: a differs from the plain "
                  f"version at J={j} ({inputs})")
            if inputs == "dyadic" and gate is not off:
                check(bits_equal(sk, sk_p), f"{tag}: sketch differs from "
                      f"the plain version at J={j} (dyadic)")
                err_ = 0.0
            else:
                err_, share = sketch_gap(sk, sk_p, a_p)
                res[f"{name}_bound_share"] = max(
                    res.get(f"{name}_bound_share", 0.0), share)
            res[f"{name}_err"] = max(res.get(f"{name}_err", 0.0), err_)
            if gate is off:
                check(not bool(torch.signbit(a[::97]).any()),
                      f"{tag}: -0.0 * decay + 0.0 must be +0.0")
            if gate is on:
                ref = pk.sweep1_sketch(g, e.float(), rows, width, tables)[0]
                check(bits_equal(a, ref), f"{tag}: a differs from the "
                      "ungated fp32 kernel's")
            del a, sk, a_p, sk_p
        if inputs == "gauss" and timed:
            plan = pk.sketch_plan(j, rows, width)
            res["sweep1_sketch_gated_ms"] = cuda_ms(
                lambda: pk.sweep1_sketch_gated(g, err, on, ERR_DECAY, rows,
                                               width, tables))
            res["sweep1_sketch_gated_off_ms"] = cuda_ms(
                lambda: pk.sweep1_sketch_gated(g, err, off, ERR_DECAY, rows,
                                               width, tables))
            res["sweep1_sketch_gated_plain_ms"] = cuda_ms(
                lambda: pk.sweep1_sketch_plain(g, err, rows, width, on,
                                               ERR_DECAY))
            res["sweep1_sketch_bf16_ms"] = cuda_ms(
                lambda: pk.sweep1_sketch_bf16(g, e16, rows, width, tables))
            res["sweep1_sketch_bf16_plain_ms"] = cuda_ms(
                lambda: pk.sweep1_sketch_plain(g, e16, rows, width))
            res["sweep1_sketch_gated_bf16_ms"] = cuda_ms(
                lambda: pk.sweep1_sketch_gated_bf16(g, e16, on, ERR_DECAY,
                                                    rows, width, tables))
            res["sweep1_sketch_gated_bf16_plain_ms"] = cuda_ms(
                lambda: pk.sweep1_sketch_plain(g, e16, rows, width, on,
                                               ERR_DECAY))
            for name in ("sweep1_sketch_gated", "sweep1_sketch_bf16",
                         "sweep1_sketch_gated_bf16"):
                res[f"{name}_bytes"] = getattr(pk, name).bytes_moved(
                    j, rows, width)
            # the add and one add a row; the gate's two selects
            res["sweep1_sketch_bf16_ops"] = j + rows * j
            res["sweep1_sketch_gated_ops"] = 3 * j + rows * j
            res["sweep1_sketch_gated_bf16_ops"] = 3 * j + rows * j
            res["sweep1_sketch_design_bytes"] = 12 * j + 12 * rows * j
            res["chunks"] = plan["nchunks"]
        del g, err, e16
    res["names"] = names
    return res


def phase_kernels_sketch_modes(dev) -> dict:
    """B3's new modes at a ragged J (two widths) and at the main shape."""
    import torch
    small = sketch_modes_case(dev, RAGGED_J, 512, seed=31, timed=False)
    emit("kernels_sketch_modes_ragged", **small)
    emit("kernels_sketch_modes_ragged", **sketch_modes_case(
        dev, RAGGED_J, (1 << 14) + 1, seed=32, timed=False))
    big = sketch_modes_case(dev, MAIN_J, MAIN_WIDTH, seed=33, timed=True)
    emit("kernels_sketch_modes_main_shape", **big)
    torch.cuda.empty_cache()
    return {"small": small, "big": big}


def phase_sketch_sync(dev) -> None:
    """GradientSync for kind="sketchtopk" on the card and on CPU copies,
    both pipelines; the card's mean sketch feeds the decode on both."""
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    from repro_torch.kernels.compress import kernel as pk
    cpu = torch.device("cpu")
    for pipeline in ("fused", "reference"):
        cfg = SparsifierConfig(kind="sketchtopk", sparsity=SPARSITY,
                               comm_mode="sparse", pipeline=pipeline,
                               sketch_rows=SKETCH_ROWS)
        sync_d, sync_c = GradientSync(cfg), GradientSync(cfg)
        st_d = sparsify.init_state(cfg, COMPRESS_J, dev)
        st_c = sparsify.init_state(cfg, COMPRESS_J, cpu)
        gen = torch.Generator(device=cpu).manual_seed(11)
        gaps = []
        reset_launches()
        for t in range(SYNC_STEPS):
            g = torch.randn(COMPRESS_J, generator=gen)
            a_d, sk_d = sync_d.encode(st_d, g.to(dev))
            a_c, sk_c = sync_c.encode(st_c, g)
            check(torch.equal(a_d.cpu(), a_c),
                  f"sketch sync {pipeline} step {t}: a differs")
            gaps.append(sketch_gap(sk_d, sk_c, a_c))
            sk_agg = sync_d.allreduce_sketch(sk_d)
            g_d, st_d, idx_d = sync_d.decode_exchange(sk_agg, a_d, st_d)
            g_c, st_c, idx_c = sync_c.decode_exchange(sk_agg.cpu(), a_c,
                                                      st_c)
            key = sparsify.err_key(cfg)
            for name, got, want in (("indices", idx_d, idx_c),
                                    ("g_agg", g_d, g_c),
                                    (key, st_d[key], st_c[key])):
                check(torch.equal(got.cpu(), want),
                      f"sketch sync {pipeline} step {t}: {name} differs "
                      "card vs CPU")
        launches = launch_counts()
        enc = "sweep1_sketch" if pipeline == "fused" else "sketch_encode"
        for name, n in launches.items():
            check(n == (SYNC_STEPS if name == enc else 0),
                  f"sketch sync {pipeline}: {name} launched {n} times")
        emit("sketch_sync", pipeline=pipeline, j=COMPRESS_J,
             steps=SYNC_STEPS, k=sparsify.resolve_k(cfg, COMPRESS_J),
             width=sk_agg.shape[1], launches=launches,
             sketch_err=[e for e, _ in gaps],
             sketch_bound_share=[s_ for _, s_ in gaps],
             decode_bitwise=True)


def phase_sketch_elastic_sync(dev) -> dict:
    """The sketch sync's elastic paths on the card, for both pipelines in
    fp32 and bf16 state (the sparse exchange in 8 chunks on the bf16 wire
    for the bf16 state): with an all-in participation bit every step
    gives the bits of participate=None (dyadic gradients, so every
    bucket sum is exact and two encodes agree bit for bit), and a
    sitting-out step gives g_agg = 0, n_active 0 and the decayed error.
    Returns the launches of each config's steps."""
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    on = torch.ones((), dtype=torch.bool, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    out = {}
    for pipeline in ("fused", "reference"):
        for ef in ("float32", "bfloat16"):
            extra = dict(num_buckets=BUCKETS, **BF16) if ef != "float32" \
                else {}
            cfg = SparsifierConfig(kind="sketchtopk", sparsity=SPARSITY,
                                   comm_mode="sparse", pipeline=pipeline,
                                   sketch_rows=SKETCH_ROWS, **ELASTIC,
                                   **extra)
            plain, elastic = GradientSync(cfg), GradientSync(cfg)
            st_p = st_e = sparsify.init_state(cfg, COMPRESS_J, dev)
            gen = torch.Generator(device=dev).manual_seed(12)
            key = sparsify.err_key(cfg)
            reset_launches()
            for t in range(SYNC_STEPS):
                g = dyadic(gen, COMPRESS_J, dev)
                g_p, st_p = plain(st_p, g)
                g_e, st_e, stats = elastic(st_e, g, participate=on,
                                           with_stats=True)
                check(bits_equal(g_p, g_e) and bits_equal(st_p[key],
                                                          st_e[key]),
                      f"sketch {pipeline} {ef} step {t}: an all-in bit "
                      "differs from participate=None")
                check(float(stats["n_active"]) == 1.0, "n_active")
            g_o, st_o, stats = elastic(st_e, dyadic(gen, COMPRESS_J, dev),
                                       participate=off, with_stats=True)
            decayed = (ERR_DECAY * st_e[key].float()).to(st_e[key].dtype)
            check(not bool(g_o.any()) and float(stats["n_active"]) == 0.0,
                  f"sketch {pipeline} {ef}: a sitting-out step's g_agg")
            check(bits_equal(st_o[key], decayed + 0.0),
                  f"sketch {pipeline} {ef}: a sitting-out step keeps the "
                  "decayed error")
            name = f"{pipeline}_{ef}"
            out[name] = launch_counts()
            enc = ("sweep1_sketch_gated" if pipeline == "fused"
                   else "sketch_encode")
            if pipeline == "fused" and ef != "float32":
                enc += "_bf16"
            # the reference pipeline's encode serves both syncs
            want = SYNC_STEPS + 1 + (SYNC_STEPS if pipeline == "reference"
                                     else 0)
            check(out[name][enc] == want, f"sketch {pipeline} {ef}: {enc} "
                  f"launched {out[name][enc]} times, expected {want}")
            emit("sketch_elastic_sync", pipeline=pipeline, ef_dtype=ef,
                 j=COMPRESS_J, steps=SYNC_STEPS,
                 sparsifier=dataclasses.asdict(cfg), launches=out[name],
                 all_in_bitwise=True, sitting_out=True)
    return out


def ef_inputs(dev, j: int, seed: int):
    """g, err, a_prev, g_agg, s_prev on the card: Gaussian, s_prev 0/1,
    exact zeros of a = err + g (err = -g) and tiny negative a (-1e-13,
    whose safe denominator is 0: a division by zero)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    a_prev = torch.randn(j, generator=gen, device=dev)
    g_agg = torch.randn(j, generator=gen, device=dev) * 0.5
    s_prev = (torch.rand(j, generator=gen, device=dev) < 0.3).float()
    n = max(4, j // 4096)
    zero = torch.randint(0, j, (n,), generator=gen, device=dev)
    err[zero] = -g[zero]
    tiny = torch.randint(0, j, (n,), generator=gen, device=dev)
    g[tiny], err[tiny] = -1e-13, 0.0
    return g, err, a_prev, g_agg, s_prev


def fused_ef_case(dev, j: int, seed: int, timed: bool) -> dict:
    """B5 (scores) over the (mu, Q, omega) grid and B6 (apply), kernel
    vs plain on the card, bit patterns equal."""
    import torch
    from repro_torch.kernels.fused_ef import kernel as fef
    ins = ef_inputs(dev, j, seed)
    err_s = err_a = 0.0
    zeros = nonfinite = 0
    for mu, q, w in EF_GRID:
        kw = dict(omega=w, mu=mu, Q=q)
        got = fef.scores(*ins, **kw)
        want = fef.scores_plain(*ins, **kw)
        for name, x, y in zip(("a", "score"), got, want):
            check(bits_equal(x, y), f"scores {name} differs at J={j}, "
                  f"mu={mu} Q={q} omega={w}")
        err_s = max(err_s, max_abs_err(zip(got, want)))
        zeros = int((got[0] == 0).sum())
        nonfinite = int((~torch.isfinite(got[1])).sum())
        gh = fef.apply(got[0], ins[4])
        gh_p = fef.apply_plain(got[0], ins[4])
        for name, x, y in zip(("ghat", "err"), gh, gh_p):
            check(bits_equal(x, y), f"apply {name} differs at J={j}")
        err_a = max(err_a, max_abs_err(zip(gh, gh_p)))
        del got, want, gh, gh_p
    # B5's bf16 read: the four state vectors rounded to bf16 (g stays
    # fp32), kernel vs plain version, bit patterns equal (two grid points
    # at the main shape, whose plain version rounds a dozen times a step)
    bf = torch.bfloat16
    ins16 = (ins[0],) + tuple(x.to(bf) for x in ins[1:])
    err_b = 0.0
    for mu, q, w in EF_GRID[::2] if timed else EF_GRID:
        kw = dict(omega=w, mu=mu, Q=q)
        got = fef.scores_bf16(*ins16, **kw)
        want = fef.scores_bf16_plain(*ins16, **kw)
        for name, x, y in zip(("a", "score"), got, want):
            check(bits_equal(x, y), f"scores_bf16 {name} differs at J={j}, "
                  f"mu={mu} Q={q} omega={w}")
        check(bits_equal(got[1].to(bf).float(), got[1]),
              "scores_bf16: the score holds bf16 values")
        err_b = max(err_b, max_abs_err(zip(got, want)))
        del got, want
    res = {"j": j, "grid": EF_GRID, "zeros_of_a": zeros,
           "nonfinite_scores": nonfinite, "scores_err": err_s,
           "apply_err": err_a, "scores_bf16_err": err_b}
    if timed:
        kw = dict(omega=1.0, mu=MU, Q=0.0)
        a, _ = fef.scores(*ins, **kw)
        res["scores_ms"] = cuda_ms(lambda: fef.scores(*ins, **kw))
        res["scores_plain_ms"] = cuda_ms(lambda: fef.scores_plain(*ins, **kw))
        res["scores_bytes"] = fef.scores.bytes_moved(j)
        res["scores_ops"] = 40 * j         # posterior, tanh polynomials
        res["apply_ms"] = cuda_ms(lambda: fef.apply(a, ins[4]))
        res["apply_plain_ms"] = cuda_ms(lambda: fef.apply_plain(a, ins[4]))
        res["apply_bytes"] = fef.apply.bytes_moved(j)
        res["apply_ops"] = 2 * j
        res["scores_bf16_ms"] = cuda_ms(lambda: fef.scores_bf16(*ins16,
                                                                **kw))
        res["scores_bf16_plain_ms"] = cuda_ms(
            lambda: fef.scores_bf16_plain(*ins16, **kw))
        res["scores_bf16_bytes"] = fef.scores_bf16.bytes_moved(j)
        res["scores_bf16_ops"] = 60 * j    # the chain and its roundings
    del ins16
    return res


def phase_kernels_fused_ef(dev) -> dict:
    import torch
    small = fused_ef_case(dev, RAGGED_J, seed=5, timed=False)
    emit("kernels_fused_ef_ragged", **small)
    big = fused_ef_case(dev, MAIN_J, seed=4, timed=True)
    emit("kernels_fused_ef_main_shape", **big)
    torch.cuda.empty_cache()
    return {"small": small, "big": big}


def hist_inputs(dev, kind: str, j: int, seed: int):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "zeros":
        return torch.zeros(j, device=dev)
    if kind == "edges":       # |x| = b / 2048 * 4 exactly: on bin edges
        b = torch.randint(0, 2049, (j,), generator=gen, device=dev)
        x = b.float() / 2048 * 4.0
        x[7] = 4.0
        sign = torch.rand(j, generator=gen, device=dev) < 0.5
        return torch.where(sign, -x, x)
    x = torch.randn(j, generator=gen, device=dev)
    if kind == "nan":
        x[torch.randint(0, j, (5,), generator=gen, device=dev)] = float("nan")
    if kind == "concentrated":  # gradient-like: most |x| in bins 0-1
        x *= 1e-3
        x[torch.randint(0, j, (64,), generator=gen, device=dev)] = 2.0
    return x


def bin_edges(amax):
    """(2047,) fp32 t_b, b = 1..2047: the least fp32 y >= 0 whose bin
    reaches b, RN(y / amax) * 2048 >= b, for a finite fp32 amax > 0 (a
    bisection over the bit patterns, which order non-negative floats)."""
    import torch
    from repro_torch.kernels.topk_select import kernel as hk
    b = torch.arange(1, hk.BINS, dtype=torch.float32, device=amax.device)
    lo = torch.zeros(b.shape, dtype=torch.int64, device=amax.device)
    hi = torch.full_like(lo, int(amax.view(torch.int32)))
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        ok = (mid.int().view(torch.float32) / amax) * float(hk.BINS) >= b
        hi, lo = torch.where(ok, mid, hi), torch.where(ok, lo, mid + 1)
    return hi.int().view(torch.float32)


def edge_neighbour_input(dev, j: int, raw_amax: float):
    """Every interior bin edge t_b of amax' = max(raw_amax, 1e-30), its
    two fp32 neighbours, their negatives and amax' itself, repeated to
    length j: the values where a bin is easiest to get wrong."""
    import torch
    from repro_torch.kernels.topk_select import kernel as hk
    amax = torch.tensor(raw_amax, device=dev).clamp(min=hk.AMAX_FLOOR)
    t = bin_edges(amax)
    vals = torch.cat([t, torch.nextafter(t, torch.zeros_like(t)),
                      torch.nextafter(t, torch.full_like(t, float("inf"))),
                      amax.reshape(1)])
    vals = torch.cat([vals, -vals])
    return vals.repeat(-(-j // vals.numel()))[:j].contiguous()


def topk_select_case(dev, j: int, kinds, seed: int, timed: bool) -> dict:
    """B7 (histogram) kernel vs plain on the card, counts equal, for
    the amax the op computes (max |x|, NaN if any x is NaN), and on the
    edge-neighbour inputs for their own amax (0.0 stands for the floor);
    timed: B7 and torch.histc on the Gaussian and the concentrated
    inputs."""
    import torch
    from repro_torch.kernels.topk_select import kernel as hk
    res = {"j": j, "cases": list(kinds) + [
        f"edge_neighbours(amax={a})" for a in HIST_EDGE_AMAX],
        "histogram_err": 0.0}
    cases = [(kind, lambda kind=kind, i=i: hist_inputs(dev, kind, j,
                                                       seed + i), None)
             for i, kind in enumerate(kinds)]
    cases += [(f"edges_{a}", lambda a=a: edge_neighbour_input(dev, j, a), a)
              for a in HIST_EDGE_AMAX]
    for kind, make, raw in cases:
        x = make()
        amax = (x.abs().amax() if raw is None
                else torch.tensor(raw, device=dev))
        got, want = hk.histogram(x, amax), hk.histogram_plain(x, amax)
        check(torch.equal(got, want), f"histogram differs at J={j} ({kind})")
        check(int(got.sum()) == j, f"histogram mass at J={j} ({kind})")
        if kind == "nan":
            nan_amax = hk.histogram(x, torch.tensor(float("nan"), device=dev))
            check(int(nan_amax[0]) == j, "NaN amax: every entry in bin 0")
        if timed and kind in ("gauss", "concentrated"):
            pre = "histogram" if kind == "gauss" else f"histogram_{kind}"
            res[f"{pre}_ms"] = cuda_ms(lambda: hk.histogram(x, amax))
            hi = float(amax)
            res[f"{pre}_histc_ms"] = cuda_ms(lambda: torch.histc(
                x.abs(), bins=hk.BINS, min=0.0, max=hi))
            histc = torch.histc(x.abs(), bins=hk.BINS, min=0.0, max=hi)
            res[f"{pre}_histc_differing_bins"] = int(
                (histc.long() != got.long()).sum())
        if timed and kind == "gauss":
            res["histogram_plain_ms"] = cuda_ms(
                lambda: hk.histogram_plain(x, amax))
            res["histogram_bytes"] = hk.histogram.bytes_moved(j)
            res["histogram_ops"] = 5 * j  # abs, divide, multiply, convert, clip
        del x, got, want
    return res


def phase_kernels_topk_select(dev) -> dict:
    import torch
    small = topk_select_case(dev, RAGGED_J, ("gauss", "zeros", "edges",
                                             "nan", "concentrated"),
                             seed=7, timed=False)
    emit("kernels_topk_select_ragged", **small)
    big = topk_select_case(dev, MAIN_J, ("gauss", "edges", "concentrated"),
                           seed=8, timed=True)
    emit("kernels_topk_select_main_shape", **big)
    torch.cuda.empty_cache()
    return {"small": small, "big": big}


REF_SYNC_CASES = (
    ("dense_exact_sparse", dict(comm_mode="sparse"),
     {"scores": SYNC_STEPS, "apply": SYNC_STEPS}, 0),
    ("dense_histogram_kernel_degrade",
     dict(comm_mode="sparse", selector="histogram_kernel"),
     {"scores": SYNC_STEPS, "apply": SYNC_STEPS, "histogram": SYNC_STEPS}, 1),
    ("sparse_state_simulate",
     dict(comm_mode="simulate", state_format="sparse"), {}, 0),
)


def phase_reference_sync(dev) -> dict:
    """GradientSync on the reference pipeline on the card and on CPU
    copies: g_agg and every state vector bitwise, step by step; the
    launches of each case and its sparse -> simulate warnings."""
    import warnings
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    cpu = torch.device("cpu")
    out = {}
    for name, fields, expect, n_warn in REF_SYNC_CASES:
        cfg = SparsifierConfig(kind="regtopk", sparsity=SPARSITY, mu=MU,
                               pipeline="reference", **fields)
        sync_d, sync_c = GradientSync(cfg), GradientSync(cfg)
        st_d = sparsify.init_state(cfg, REF_SYNC_J, dev)
        st_c = sparsify.init_state(cfg, REF_SYNC_J, cpu)
        gen = torch.Generator(device=cpu).manual_seed(13)
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for t in range(SYNC_STEPS):
                g = torch.randn(REF_SYNC_J, generator=gen)
                g_d, st_d = sync_d(st_d, g.to(dev), donate=True)
                g_c, st_c = sync_c(st_c, g)
                check(bits_equal(g_d.cpu(), g_c),
                      f"reference sync {name} step {t}: g_agg differs")
                check(set(st_d) == set(st_c), f"{name}: state keys")
                for key in st_c:
                    check(bits_equal(st_d[key].cpu(), st_c[key]),
                          f"reference sync {name} step {t}: {key} differs "
                          "card vs CPU")
        launches = launch_counts()
        for kname, n in launches.items():
            check(n == expect.get(kname, 0),
                  f"reference sync {name}: {kname} launched {n} times")
        warned = [str(w.message) for w in caught
                  if issubclass(w.category, RuntimeWarning)]
        check(len(warned) == n_warn, f"{name}: warnings {warned}")
        emit("reference_sync", case=name, j=REF_SYNC_J, steps=SYNC_STEPS,
             comm=sync_d.comm, launches=launches, warnings=warned,
             state=sorted(st_c), bitwise=True)
        out[name] = launches
    return out


# phase compress: (kinds, the other sparsifier fields, participation
# mask, {kernel: launches a step}); "sweep" names sweep 1's wrapper of
# the kind (sweep1, its dgc mode or the gated variant)
COMPRESS_CASES = (
    (("regtopk", "dgc"), {}, None, {"sweep": 1, "sweep2": 1}),
    (("regtopk", "dgc"), {}, ELASTIC_MASK, {"sweep": 1, "sweep2": 1}),
    # the capability matrix: 8 buckets with the bf16 state (B1's bf16
    # read and B2 a bucket), the histogram selector, the bf16 state under
    # participation (the gated bf16 read), thresholdk and randk on both
    # pipelines (randk runs no kernel on the fused pipeline; the
    # reference pipeline's apply kernel once a step)
    (("regtopk", "dgc"), dict(num_buckets=BUCKETS, **BF16), None,
     {"sweep": BUCKETS, "sweep2": BUCKETS}),
    (("regtopk", "dgc"), dict(selector="histogram"), None,
     {"sweep": 1, "sweep2": 1}),
    (("regtopk",), dict(ef_dtype="bfloat16"), ELASTIC_MASK,
     {"sweep": 1, "sweep2": 1}),
    (("thresholdk",), {}, None, {"sweep": 1, "sweep2": 1}),
    (("randk",), {}, None, {}),
    (("thresholdk", "randk"), dict(pipeline="reference",
                                   comm_mode="simulate"), None,
     {"apply": 1}),
)


def sweep_name(kind: str, mask, ef_dtype: str) -> str:
    base = ("sweep1_gated" if mask else
            "sweep1_dgc" if kind == "dgc" else "sweep1")
    return base + ("_bf16" if ef_dtype == "bfloat16" else "")


def phase_compress(dev) -> dict:
    """The compressors of COMPRESS_CASES on the card and on CPU copies:
    values, indices, every state vector (err_prev, DGC's mom, REGTOP-k's
    posterior) and the fallback reasons equal, step by step, and the
    payload's live count where there is one (the histogram selector's in
    [k, 2k]); the fused REGTOP-k and DGC steps first plain, then under
    participation ELASTIC_MASK with err_decay 0.9 (sweep 1's gated
    variant), then the capability matrix. Returns each kernel's launches
    summed over the cases."""
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify, threefry
    from repro_torch.kernels.compress.dispatch import hist_capacity
    cpu = torch.device("cpu")
    total = {}
    for kinds, extra, mask, per_step in COMPRESS_CASES:
        for kind in kinds:
            fields = dict(dict(kind=kind, sparsity=SPARSITY, mu=MU,
                               err_decay=ERR_DECAY, **FUSED), **extra)
            cfg = SparsifierConfig(**fields)
            k = sparsify.resolve_k(cfg, COMPRESS_J)
            st_dev = sparsify.init_state(cfg, COMPRESS_J, dev)
            st_cpu = sparsify.init_state(cfg, COMPRESS_J, cpu)
            key = threefry.prng_key(3) if kind == "randk" else None
            gen = torch.Generator(device=cpu).manual_seed(7)
            fallbacks, counts = [], []
            reset_launches()
            for t in range(SYNC_STEPS):
                g = torch.randn(COMPRESS_J, generator=gen)
                p = None if mask is None else torch.tensor(mask[t])
                o_dev = sparsify.compress(
                    cfg, st_dev, g.to(dev), key=None if key is None
                    else key.to(dev),
                    participate=None if p is None else p.to(dev))
                o_cpu = sparsify.compress(cfg, st_cpu, g, participate=p,
                                          key=key)
                check(set(o_dev.state) == set(o_cpu.state), f"{kind}: keys")
                check((o_dev.count is None) == (o_cpu.count is None),
                      f"{kind}: count")
                pairs = [("values", o_dev.values, o_cpu.values),
                         ("indices", o_dev.indices, o_cpu.indices),
                         *((key_, o_dev.state[key_], o_cpu.state[key_])
                           for key_ in o_cpu.state)]
                if o_cpu.count is not None:
                    pairs.append(("count", o_dev.count, o_cpu.count))
                    counts.append(int(o_cpu.count))
                for name, got, want in pairs:
                    check(bits_equal(got.cpu(), want),
                          f"compress {fields} mask {mask} step {t}: {name} "
                          "differs card vs CPU")
                check(o_dev.fallback == o_cpu.fallback,
                      f"compress {kind} step {t}: fallback branch differs")
                fallbacks.append(o_dev.fallback)
                if cfg.selector == "histogram":
                    check(k <= counts[-1] <= hist_capacity(k, COMPRESS_J),
                          f"histogram count {counts[-1]} outside [k, 2k]")
                st_dev = sparsify.observe_aggregate(
                    cfg, o_dev.state, sparsify.dense_ghat(o_dev, COMPRESS_J),
                    participate=None if p is None else p.to(dev))
                st_cpu = sparsify.observe_aggregate(
                    cfg, o_cpu.state, sparsify.dense_ghat(o_cpu, COMPRESS_J),
                    participate=p)
            launches = launch_counts()
            sweep = sweep_name(kind, mask, cfg.ef_dtype)
            want = {(sweep if name == "sweep" else name): n * SYNC_STEPS
                    for name, n in per_step.items()}
            for name, n in launches.items():
                check(n == want.get(name, 0),
                      f"compress {fields} mask {mask}: {name} launched {n}")
                total[name] = total.get(name, 0) + n
            emit("compress", kind=kind, j=COMPRESS_J, steps=SYNC_STEPS,
                 sparsifier={key_: val for key_, val in fields.items()
                             if key_ not in ("sparsity", "mu")},
                 participation=mask, bitwise=True, fallbacks=fallbacks,
                 counts=counts, state=sorted(st_cpu), launches=launches)
    return total


def phase_train(dev, sparsifier: dict, expect: dict, phase: str,
                schedule: str = "", model_cut=TRAIN_MODEL,
                run_fields: dict = None, train_kwargs: dict = None):
    """The launcher's train() on ``model_cut`` = (arch, depth, J): by
    default StableLM-3B at full width, 8 layers, with
    the given sparsifier fields and fault schedule (and ``run_fields``,
    ``train_kwargs``: the checkpoint fields, the delta broadcast's
    options); the loss must be
    finite and falling and every kernel's launch count must equal
    ``expect`` (the others 0); under the schedule the steps' n_active
    must be ELASTIC_ACTIVE, and with the histogram selector every step's
    live count must lie in [k, 2k]. Returns (launches by kernel, the
    run, the trained state, the step ms, the rest of train()'s
    result)."""
    import torch
    from repro_torch.configs.base import (OptimizerConfig, RunConfig, SHAPES,
                                          SparsifierConfig, get_config)
    from repro_torch.launch.train import train
    arch, depth, main_j = model_cut
    model = dataclasses.replace(get_config(arch), n_layers=depth)
    check(model.param_count() == main_j, f"J={model.param_count()}")
    run = RunConfig(
        model=model, shape=SHAPES["train_4k"],
        sparsifier=SparsifierConfig(**dict(dict(
            sparsity=SPARSITY, mu=MU, sketch_rows=SKETCH_ROWS), **sparsifier)),
        optimizer=OptimizerConfig(kind="adam", lr=1e-3),
        seed=0, steps=TRAIN_STEPS, log_every=1, fault_schedule=schedule,
        **(run_fields or {}))
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.reset_accumulated_memory_stats(dev)

    def on_step(rec):
        emit(f"{phase}_step", **rec,
             **{f"{name}_launches": n for name, n in launch_counts().items()
                if name in expect})

    seq = TRAIN_SEQS.get(arch, TRAIN_SEQ)
    reset_launches()
    out = train(run, device=dev, batch=TRAIN_BATCH, seq=seq, fixed_batch=True,
                log=lambda msg: print(msg, file=sys.stderr),
                on_step=on_step, **(train_kwargs or {}))
    launches = launch_counts()
    losses = [rec["loss"] for rec in out["history"]]
    check(out["params"] == main_j, f"trained J={out['params']}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    for name, n in launches.items():
        want = expect.get(name, 0)
        check(n == want, f"{phase}: {name} launched {n} times in "
              f"{TRAIN_STEPS} steps, expected {want}")
    active = [rec.get("n_active") for rec in out["history"]]
    if schedule:
        check(active == ELASTIC_ACTIVE, f"{phase}: n_active {active}")
    aux = {key: [rec.get(key) for rec in out["history"]]
           for key in ("lb_loss", "z_loss", "drop_frac")}
    if model.moe is not None:
        check(all(x is not None and math.isfinite(x) for val in aux.values()
                  for x in val), f"{phase}: MoE aux metrics {aux}")
    counts = [rec.get("count") for rec in out["history"]]
    if run.sparsifier.selector == "histogram":
        k = round(SPARSITY * main_j)
        check(all(k <= c <= 2 * k for c in counts),
              f"{phase}: live counts {counts} outside [k, 2k]")
    emit(phase, model=model.name, sparsifier=dataclasses.asdict(
             run.sparsifier), fault_schedule=schedule, n_active=active,
         counts=counts,
         n_layers=depth, **(aux if model.moe is not None else {}),
         j=out["params"], batch=TRAIN_BATCH, seq=seq, steps=TRAIN_STEPS,
         losses=losses, step_ms=[rec["ms"] for rec in out["history"]],
         launches=launches, fallbacks=out["fallbacks"],
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         alloc_retries=torch.cuda.memory_stats(dev)["num_alloc_retries"])
    state = out.pop("state")
    return launches, run, state, [rec["ms"] for rec in out["history"]], out


class RouteProbe:
    """While active, records each MoE layer's routing (``moe.route``):
    the tokens routed, the share of choices dropped and the experts
    chosen, as device tensors (read after the run, so no step waits)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.route, self.calls = moe, moe.route, []

        def route(logits, cfg):
            r = self.route(logits, cfg)
            self.calls.append((logits.shape[0], r["drop_frac"], r["top_e"]))
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.route

    def drop_frac(self) -> float:
        return max((float(d) for _, d, _ in self.calls), default=0.0)

    def experts(self) -> int:
        """Distinct experts chosen, summed over the routing calls."""
        import torch
        return sum(int(torch.unique(e).numel()) for _, _, e in self.calls)


def serve_model(arch: str):
    """The served architecture at full width, at its SERVE_DEPTH."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=SERVE_DEPTH.get(arch,
                                                            cfg.n_layers))


def serve_cfg(arch: str, attn: str, dtype: str):
    """The served config of a cell: ``attn`` "sliding" (window
    SERVE_WINDOW) or "absorb" (MLA's absorbed form); an MoE model at
    capacity factor MOE_SERVE_CAPACITY."""
    cfg = dataclasses.replace(serve_model(arch), dtype=dtype)
    if attn == "sliding":
        cfg = dataclasses.replace(cfg, attn_kind="sliding",
                                  window=SERVE_WINDOW)
    if attn == "absorb":
        cfg = dataclasses.replace(cfg, mla_absorb=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_SERVE_CAPACITY))
    return cfg


def serve_case(dev, arch: str, attn: str, prompt: int, dtype: str,
               params: dict) -> dict:
    """The serve launcher's serve() on ``arch`` at full width and depth
    (``serve_cfg``: "sliding" with the window below the prompt, so the
    ring buffer wraps in prefill and in every decode step; "absorb",
    MLA's absorbed form) with the given parameters, a prompt of
    ``prompt`` tokens, in ``dtype``; then the full forward of the prompt
    and the generated tokens (and the prompts' patches or frames),
    without a cache (MLA expanded): the
    prefill's logits against its position P - 1, the last decode step's
    against position P + N - 1, as max |difference| over the largest
    |logit| of the full forward at those positions; then SERVE_REPS more
    decode windows timed (``decode_windows``) and one more decode step
    profiled (``decode_profile``). An MoE cell records its routing
    (``RouteProbe``): the served run's drop share and the experts the
    profiled step routes to."""
    import torch
    from repro_torch.configs.base import RunConfig, SparsifierConfig
    from repro_torch.core.flatten import tree_items, tree_leaves, tree_size
    from repro_torch.launch.serve import serve, serve_shape
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import CACHE_KEYS
    from repro_torch.models.layers import lm_head_fwd
    cfg = serve_cfg(arch, attn, dtype)
    run = RunConfig(model=cfg, shape=serve_shape(SERVE_BATCH, prompt,
                                                 SERVE_NEW),
                    sparsifier=SparsifierConfig(kind="none"))
    torch.cuda.reset_peak_memory_stats(dev)
    with RouteProbe() as served:
        out = serve(run, device=dev, prompt_len=prompt, new_tokens=SERVE_NEW,
                    params=params, log=lambda msg: print(msg, file=sys.stderr))
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = torch.cat([out["prompt"], out["tokens"]], 1)
    full_cfg = dataclasses.replace(cfg, mla_absorb=False)
    with torch.inference_mode(), RouteProbe() as full_route:
        x = tfm.hidden(params, dict(out["batch"], tokens=tokens), full_cfg)
        full = lm_head_fwd(params["embed"], x[:, [prompt - 1, -1]],
                           full_cfg).float()
        del x
    scale = float(full.abs().max())
    # the least max |difference| between two rows' logits at a position,
    # over the scale: above SERVE_RTOL, a fault of one row (another row's
    # cache or stub input) shows against the full forward
    gaps = (full[:, None] - full[None]).abs().amax(-1).amin(-1)
    row_gap = float(gaps[~torch.eye(SERVE_BATCH, dtype=torch.bool,
                                    device=gaps.device)].min()) / scale
    del gaps
    e_pre = float((out["prefill_logits"].float() - full[:, 0]).abs().max())
    e_dec = float((out["logits"].float() - full[:, 1]).abs().max())
    check(out["params"] == SERVE_PARAMS[arch], f"{arch}: {out['params']}")
    check(tuple(out["tokens"].shape) == (SERVE_BATCH, SERVE_NEW),
          f"{arch}: tokens {tuple(out['tokens'].shape)}")
    check(bool(torch.isfinite(out["logits"]).all()), f"{arch}: logits")
    check(int(out["cache"]["pos"]) == prompt + SERVE_NEW,
          f"{arch}: cache pos {int(out['cache']['pos'])}")
    # k, or MLA's ckv; none in xLSTM, whose cache is recurrent state
    kv = [leaf for path, leaf in tree_items(out["cache"]["blocks"])
          if path[-1] in CACHE_KEYS]
    cap = kv[0].shape[2] if kv else None
    check(cfg.attn_every == 0 or cap == (
        SERVE_WINDOW if attn == "sliding" else prompt + SERVE_NEW),
        f"{arch}: cache {cap}")
    if cfg.moe is not None:
        check(served.drop_frac() == 0.0 and full_route.drop_frac() == 0.0,
              f"{arch}: choices dropped at capacity factor "
              f"{MOE_SERVE_CAPACITY}: served {served.drop_frac()}, full "
              f"{full_route.drop_frac()}")
    windows = decode_windows(dev, run, params, out["cache"], out["tokens"])
    with RouteProbe() as step_route:
        profile = decode_profile(dev, run, params, out["cache"],
                                 out["tokens"][:, -1:], dtype)
    live = min(cap or 0, prompt + SERVE_NEW)
    # decode runs neither the encoder nor the cross layers' k and v
    # projections: it reads their output in the cache's cross leaf
    unread = tree_size(params.get("encoder", {})) + sum(
        int(leaf.numel()) for path, leaf in tree_items(params)
        if len(path) > 1 and path[-2] == "cross"
        and path[-1] in ("wk", "wv", "bk", "bv"))
    step_bytes, all_experts_bytes = decode_bytes(
        cfg, out["params"] - unread, live, out["cache"],
        step_route.experts())
    ms = statistics.median(windows)
    res = {"arch": arch, "attn": attn, "dtype": dtype,
           "window": cfg.window if attn == "sliding" else None,
           "n_layers": cfg.n_layers, "params": out["params"],
           "prompt": prompt, "cache_slots": cap,
           "cache_bytes": sum(leaf.nbytes for leaf in tree_leaves(
               out["cache"]) if leaf.dim()),
           "prefill_ms": out["prefill_s"] * 1e3,
           "launcher_decode_ms_per_step": out["decode_s"] / SERVE_NEW * 1e3,
           "decode_ms_per_step": ms, "decode_ms_windows": windows,
           "decode_ms_spread": [min(windows), max(windows)],
           "tokens_per_s": SERVE_BATCH * 1e3 / ms,
           "decode_bound_ms": bound_ms(step_bytes, 0)[0],
           "decode_bound_bytes": step_bytes,
           "max_memory_allocated": peak,
           "prefill_rel_err": e_pre / scale, "decode_rel_err": e_dec / scale,
           "row_gap": row_gap,
           "decode_profile": profile,
           "first_sequence": out["tokens"][0].tolist()}
    if cfg.moe is not None:
        res.update(capacity_factor=MOE_SERVE_CAPACITY,
                   served_drop_frac=served.drop_frac(),
                   step_experts_routed=step_route.experts(),
                   moe_layers=tfm.n_moe_layers(cfg),
                   all_experts_bytes=all_experts_bytes,
                   all_experts_bound_ms=bound_ms(all_experts_bytes, 0)[0])
    if attn == "absorb":
        res["reference"] = "the expanded form's full forward"
    return res


def decode_bytes(cfg, n_params: int, live_slots: int, cache: dict,
                 experts: int = 0) -> tuple:
    """The least bytes a decode step moves at the last step's context: each
    weight read once, 4 B a parameter in fp32 and 8 in bf16 (the cast of
    every fp32 weight at its use writes and reads a bf16 copy, as the
    reference casts), but the token table, of which the step gathers B
    fp32 rows (unless it is also the tied head), and, in an MoE model,
    of the routed experts only the ``experts`` the step's routing chose
    (summed over the layers); the ``live_slots`` valid slots of every
    attention cache leaf, every recurrent state leaf read and written
    once, and an encoder-decoder's cross k and v read whole (``n_params``
    leaves out its encoder and its cross layers' k and v projections,
    which decode does not run). Returns (those
    bytes, the same with every expert of every MoE layer: what the
    all-experts products read)."""
    from repro_torch.core.flatten import tree_items, tree_leaves
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import CACHE_KEYS
    per_param = 4 if cfg.dtype == "float32" else 8
    n = n_params - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    per_expert = all_experts = 0
    if cfg.moe is not None:
        per_expert = (3 if cfg.act == "silu" else 2) * cfg.d_model * \
            cfg.moe.d_expert
        all_experts = tfm.n_moe_layers(cfg) * cfg.moe.n_experts * per_expert
    gather = SERVE_BATCH * cfg.d_model * 4
    kv = 0
    for stacked, tree in ((1, cache["blocks"]), (0, cache.get("prefix", []))):
        for path, leaf in tree_items(tree):
            if path[-1] in CACHE_KEYS:
                slots = leaf.shape[1 + stacked]
                kv += leaf.nbytes // slots * live_slots
            else:
                kv += 2 * leaf.nbytes
    kv += sum(leaf.nbytes for leaf in tree_leaves(cache.get("cross", {})))
    base = (n - all_experts) * per_param + gather + kv
    return (base + experts * per_expert * per_param,
            base + all_experts * per_param)


def decode_windows(dev, run, params: dict, cache: dict, tokens,
                   dec=None) -> list:
    """ms a step of SERVE_REPS more decode windows of a served cache, on
    the host clock around each window, which ends in a synchronisation:
    ``pos`` set back by the window and the generated tokens fed again at
    their positions, so each step does its served step's work at the same
    context (with full attention it writes the same k and v again).
    ``dec``: the decode step (default: one rank's)."""
    import torch
    from repro_torch.serve.step import build_decode_step
    dec = dec or build_decode_step(run, dev)
    n = tokens.shape[1]
    out = []
    for _ in range(SERVE_REPS):
        with torch.inference_mode():
            cache["pos"].sub_(n)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(n):
            dec(params, cache, tokens[:, i:i + 1])
        torch.cuda.synchronize(dev)
        out.append((time.perf_counter() - t0) / n * 1e3)
    return out


def decode_profile(dev, run, params: dict, cache: dict, token,
                   dtype: str, dec=None) -> dict:
    """One more decode step of a served cache, under torch.profiler: the
    last step again (``pos`` set back by one, the same token, so its k
    and v overwrite themselves), split into device time by kind of
    kernel: the fp32 -> bf16 conversions (``bfloat16_copy_kernel``; the
    weights' casts and a few activations'), the matmuls, the rest; and
    the launches. The conversions must be 0 in fp32 and more in bf16.
    Wall time includes the profiler's own cost. ``dec``: the decode step
    (default: one rank's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.step import build_decode_step
    dec = dec or build_decode_step(run, dev)
    with torch.inference_mode():
        cache["pos"].sub_(1)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec(params, cache, token)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = cuda_kernels(prof)
    busy = sum(ms for _, ms, _ in kernels)
    cast = sum(ms for key, ms, _ in kernels if "bfloat16_copy" in key)
    mm = sum(ms for key, ms, _ in kernels if any(
        w in key.lower() for w in ("gemm", "gemv", "nvjet", "cutlass")))
    check((cast == 0) == (dtype == "float32"),
          f"decode profile, {dtype}: {cast} ms of fp32 -> bf16 conversions; "
          f"kernels {[k[:90] for k, _, _ in kernels[:8]]}")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms, "cast_ms": cast,
            "matmul_ms": mm, "other_ms": busy - cast - mm,
            "kernel_launches": sum(n for _, _, n in kernels),
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": n}
                            for k, ms, n in kernels[:8]]}


def phase_serve(dev) -> None:
    """SERVE_CELLS at the launcher's defaults (batch 8, 16 greedy steps;
    prompt 48, and 4096 for the long cell), each architecture's
    parameters drawn once from seed 0 (fp32 masters, as the reference
    keeps them): in fp32, the decode and prefill logits within SERVE_RTOL
    of the full forward, and every two rows' logits further apart than
    that (``row_gap``); then in the config's bf16, its error printed,
    not bounded (not for SERVE_FP32_ONLY: a line says why). Decode ms a
    step is the median of SERVE_REPS windows after the launcher's run
    (its spread beside it)."""
    import torch
    from repro_torch.models import init_params
    params, held = None, None
    for arch, attn, prompt in SERVE_CELLS:
        if held != arch:
            params = None
            torch.cuda.empty_cache()
            params = init_params(serve_model(arch), torch.Generator(
                device=dev).manual_seed(0), dev)
            held = arch
        res = serve_case(dev, arch, attn, prompt, "float32", params)
        check(res["prefill_rel_err"] < SERVE_RTOL
              and res["decode_rel_err"] < SERVE_RTOL,
              f"serve {arch} {attn} {prompt}: fp32 errors "
              f"{res['prefill_rel_err']}, {res['decode_rel_err']} over "
              f"{SERVE_RTOL}")
        check(res["row_gap"] > SERVE_RTOL,
              f"serve {arch} {attn} {prompt}: two rows' logits within "
              f"{res['row_gap']} of each other, under {SERVE_RTOL}: a fault "
              "of one row would not show")
        emit("serve", **res)
        torch.cuda.empty_cache()
        if arch in SERVE_FP32_ONLY:
            emit("serve", arch=arch, attn=attn, dtype="bfloat16",
                 skipped=SERVE_FP32_ONLY[arch])
            continue
        emit("serve", **serve_case(dev, arch, attn, prompt, "bfloat16",
                                   params))
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def cuda_kernels(prof) -> list:
    """(name, device ms, calls) of each CUDA kernel a torch.profiler run
    recorded, the longest first (not the ``nccl:`` ranges that annotate
    a collective's kernel with the same device time)."""
    from torch.autograd import DeviceType
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("nccl:")
                   and e.self_device_time_total > 0), key=lambda r: -r[1])


def device_launches(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its device time, its CUDA
    kernel launches and its heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = cuda_kernels(prof)
    return {"device_busy_ms": sum(ms for _, ms, _ in kernels),
            "kernel_launches": sum(n for _, _, n in kernels),
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": n}
                            for k, ms, n in kernels[:6]]}


def phase_mamba_layer(dev) -> None:
    """One Mamba layer at Jamba's width in fp32 (``models.mamba``, the
    chunks recomputed in the backward pass as ``cfg.remat`` asks), batch
    MAMBA_BATCH, at each of MAMBA_SEQS: forward ms and forward plus
    backward ms (medians of MAMBA_REPS CUDA-event timings), the peak
    memory and the CUDA launches of each, every gradient finite, and the
    fp32 forward of the first MAMBA_FP64_ROWS rows against the same
    function in fp64 (fp64 parameters and input: ``mamba.state_dtype``):
    max |error| over max |y_fp64| below MAMBA_FP64_RTOL."""
    import torch
    from repro_torch.configs.base import get_config, mamba_dims
    from repro_torch.models import mamba
    cfg = dataclasses.replace(get_config(MAMBA_ARCH), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mamba.init_mamba(gen, cfg, device=dev)
    leaves = [params[key].requires_grad_(True) for key in sorted(params)]
    for seq in MAMBA_SEQS:
        x = torch.randn((MAMBA_BATCH, seq, cfg.d_model), generator=gen,
                        device=dev)

        def forward():
            with torch.no_grad():
                return mamba.mamba_fwd(params, x, cfg)

        def train_step():
            y = mamba.mamba_fwd(params, x, cfg)
            return torch.autograd.grad((y.float() ** 2).mean(), leaves)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        grads = train_step()
        torch.cuda.synchronize(dev)
        peak_train = torch.cuda.max_memory_allocated(dev)
        check(all(bool(torch.isfinite(g).all()) for g in grads),
              f"mamba_layer seq {seq}: a gradient is not finite")
        del grads
        torch.cuda.reset_peak_memory_stats(dev)
        y = forward()
        torch.cuda.synchronize(dev)
        peak_fwd = torch.cuda.max_memory_allocated(dev)
        rows = slice(0, MAMBA_FP64_ROWS)
        with torch.no_grad():
            y64 = mamba.mamba_fwd(
                {key: val.detach().double() for key, val in params.items()},
                x[rows].double(), cfg)
        rel = float((y[rows].double() - y64).abs().max() / y64.abs().max())
        del y, y64
        check(rel < MAMBA_FP64_RTOL, f"mamba_layer seq {seq}: fp32 forward "
              f"{rel} from fp64, over {MAMBA_FP64_RTOL}")
        torch.cuda.empty_cache()
        emit("mamba_layer", arch=MAMBA_ARCH, d_model=cfg.d_model,
             d_inner=mamba_dims(cfg)[0], d_state=cfg.ssm.d_state,
             dt_rank=mamba_dims(cfg)[1], batch=MAMBA_BATCH, seq=seq,
             chunks=seq // min(mamba.SCAN_CHUNK, seq), remat=cfg.remat,
             fwd_ms=cuda_ms(forward, MAMBA_REPS),
             fwd_bwd_ms=cuda_ms(train_step, MAMBA_REPS),
             fwd_max_memory_allocated=peak_fwd,
             fwd_bwd_max_memory_allocated=peak_train,
             fwd_profile=device_launches(forward),
             fwd_bwd_profile=device_launches(train_step),
             fp64_rows=MAMBA_FP64_ROWS, fp64_rel_err=rel,
             fp64_rtol=MAMBA_FP64_RTOL)
        del x
    del params, leaves
    torch.cuda.empty_cache()


def plain_checksum(values, indices, version: int, count: int, j: int) -> int:
    """The payload checksum of ``repro.serve.delta`` in numpy uint64 on
    the host: each 32x32-bit product fits 64 bits exactly, each sum of
    fewer than 2^32 terms does too."""
    import numpy as np
    m = np.uint64(0xFFFFFFFF)
    vb = values.view(np.uint32).astype(np.uint64)
    ib = indices.view(np.uint32).astype(np.uint64)
    pos = np.arange(vb.shape[0], dtype=np.uint64)
    h = int(((vb * ((pos * np.uint64(2654435761) + np.uint64(1)) & m)) & m)
            .sum(dtype=np.uint64))
    h += int(((ib * ((pos * np.uint64(40503) + np.uint64(2654435769)) & m))
              & m).sum(dtype=np.uint64))
    mask = 0xFFFFFFFF
    return (h + (version & mask) * 97 + (count & mask) * 89
            + (j & mask) * 83) & mask


def trees_equal(a: dict, b: dict) -> bool:
    """The same paths, dtypes and values (``torch.equal``) leaf for leaf,
    each leaf of ``b`` compared on the device of ``a``'s."""
    import torch
    from repro_torch.core.flatten import tree_items
    ia, ib = tree_items(a), tree_items(b)
    return [p for p, _ in ia] == [p for p, _ in ib] and all(
        x.dtype == y.dtype and torch.equal(x.detach(),
                                           y.detach().to(x.device))
        for (_, x), (_, y) in zip(ia, ib))


def phase_delta(dev) -> dict:
    """Learning while serving, in one process on the card: the train
    phase's cell (StableLM-3B, full width, 8 layers, REGTOP-k fused) takes
    TRAIN_STEPS steps through the launcher's train(), publishing a delta
    of k = 892,032 after each to a SpoolChannel with the version-0 and
    final snapshots, and checkpointing at the end; B1 and B2 must launch
    once a step. The checkpoint restored into fresh templates must equal
    the final params, optimizer and error state (torch.equal). A replica
    started from the version-0 snapshot serves through the launcher's
    serve() (batch 8, prompt 48, 16 greedy steps), draining the spool
    between decode steps through a receive-side FaultyChannel
    (DELTA_SCHEDULE): it must see a gap, resync, and end torch.equal to
    the publisher's mirror, while the tree its stream pinned stays equal
    to a clone taken at acquire(). Every payload's checksum must equal
    ``plain_checksum`` and the port's checksum on the card. Times: the
    publishes (host clock, and each part by CUDA events), the scatter of
    each payload on the card, a snapshot's write and read, decode with
    and without the applies."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs.base import RunConfig, SparsifierConfig
    from repro_torch.core import faults
    from repro_torch.core.flatten import tree_map
    from repro_torch.launch.serve import serve, serve_shape
    from repro_torch.serve import delta as dl
    from repro_torch.serve.step import delta_applier_from_snapshot
    from repro_torch.train.step import restore_train_state
    root = tempfile.mkdtemp(prefix="chip_smoke_delta_")
    spool, ckpt = os.path.join(root, "spool"), os.path.join(root, "ckpt")
    snaps = os.path.join(spool, "snapshots")
    try:
        free = shutil.disk_usage(root).free
        check(free > DELTA_DISK_BYTES, f"delta: {free:,} bytes free under "
              f"{root}, the phase writes up to {DELTA_DISK_BYTES:,}")
        torch.cuda.empty_cache()
        launches, run, state, step_ms, out = phase_train(
            dev, dict(kind="regtopk", **FUSED), train_expect(
                ("sweep1", "sweep2")), "delta_train",
            run_fields=dict(checkpoint_dir=ckpt),
            train_kwargs=dict(publish_deltas=spool))
        pub = out["publisher"]
        check(pub.k == DELTA_K and pub.j == MAIN_J and
              pub.version == TRAIN_STEPS, f"delta: publisher k {pub.k}, "
              f"J {pub.j}, v{pub.version}")
        publish_ms = [rec["publish_ms"] for rec in out["history"]]
        del out

        # the publish's parts on the final params, against the mirror
        # (functional: nothing is advanced)
        params = state.params
        idx = pub.topk(params)
        vals = pub.gather(params, idx)
        idx32 = idx.to(torch.int32)
        parts_ms = {
            "topk": cuda_ms(lambda: pub.topk(params), DELTA_REPS),
            "gather_scatter": cuda_ms(lambda: dl.scatter_set_tree(
                pub.flattener, pub.published, pub.gather(params, idx),
                idx32), DELTA_REPS),
            "checksum": cuda_ms(lambda: dl.payload_checksum(
                vals, idx32, pub.version, pub.k, pub.j), DELTA_REPS)}
        del idx, vals, idx32

        # the checkpoint, restored into fresh (meta) templates
        t0 = time.perf_counter()
        back = restore_train_state(ckpt, TRAIN_STEPS, run, dev)
        restore_s = time.perf_counter() - t0
        for name in ("params", "opt", "ef"):
            check(trees_equal(getattr(back, name), getattr(state, name)),
                  f"delta: the restored {name} differ from the trainer's")
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f))
                         for f in os.listdir(ckpt))
        del back, state, params
        shutil.rmtree(ckpt)
        torch.cuda.empty_cache()

        # one more snapshot of the mirror, timed, then read back
        timed = os.path.join(root, "timed")
        t0 = time.perf_counter()
        dl.write_snapshot(timed, pub.published, pub.version)
        snap_write_s = time.perf_counter() - t0
        snap_bytes = os.path.getsize(os.path.join(
            timed, f"step_{pub.version:08d}.params.npz"))
        t0 = time.perf_counter()
        snap, version = dl.read_snapshot(timed, pub.published, device=dev)
        torch.cuda.synchronize(dev)
        snap_read_s = time.perf_counter() - t0
        check(version == pub.version and trees_equal(snap, pub.published),
              "delta: the timed snapshot reads back different")
        del snap
        shutil.rmtree(timed)

        # every payload's checksum: the stamp, numpy on the host, the card
        payloads = dl.SpoolChannel(spool).recv()
        check([p.version for p in payloads] == list(range(1, TRAIN_STEPS
                                                          + 1)),
              f"delta: spool versions {[p.version for p in payloads]}")
        for p in payloads:
            check(p.verify() == "ok", f"delta: v{p.version} {p.verify()}")
            plain = plain_checksum(p.values.numpy(), p.indices.numpy(),
                                   p.version, p.count, p.j)
            card = int(dl.payload_checksum(p.values.to(dev),
                                           p.indices.to(dev), p.version,
                                           p.count, p.j))
            check(plain == card == p.checksum, f"delta: v{p.version} "
                  f"checksum {p.checksum}, plain {plain}, card {card}")
        spool_bytes = os.path.getsize(os.path.join(spool, sorted(
            f for f in os.listdir(spool) if f.startswith("delta_"))[0]))

        # the replica, from the version-0 snapshot, through serve()
        model = run.model
        srun = RunConfig(model=model, shape=serve_shape(
            SERVE_BATCH, SERVE_PROMPT, SERVE_NEW),
            sparsifier=SparsifierConfig(kind="none"))
        applier, _ = delta_applier_from_snapshot(srun, snaps, dev, step=0)
        check(applier.version == 0, f"delta: replica at v{applier.version}")

        def log(msg):
            print(msg, file=sys.stderr)

        def serve_plain(params):
            return serve(srun, device=dev, prompt_len=SERVE_PROMPT,
                         new_tokens=SERVE_NEW, params=params, log=log)
        serve_plain(applier.params)                           # warm-up
        pinned = applier.acquire()[0]         # the tree serve() pins
        held = tree_map(lambda l: l.clone(), pinned)
        chan = dl.FaultyChannel(dl.SpoolChannel(spool),
                                faults.parse_channel_schedule(DELTA_SCHEDULE))
        res = serve(srun, device=dev, prompt_len=SERVE_PROMPT,
                    new_tokens=SERVE_NEW, log=log, applier=applier,
                    channel=chan, snap_dir=snaps)
        health = res["delta"]
        check(health["gaps_detected"] >= 1 and health["resyncs"] >= 1,
              f"delta: no gap and resync under {DELTA_SCHEDULE}: {health}")
        check(applier.version == pub.version
              and trees_equal(applier.params, pub.published),
              f"delta: replica at v{applier.version} differs from the "
              f"publisher's mirror at v{pub.version}")
        check(res["pinned_version"] == 0 and trees_equal(pinned, held),
              "delta: the pinned decode tree changed")
        check(tuple(res["tokens"].shape) == (SERVE_BATCH, SERVE_NEW)
              and bool(torch.isfinite(res["logits"]).all()),
              "delta: replica decode")
        plain = serve_plain(applier.params)
        del held, pinned

        # the scatter of each payload on the replica's tree (functional)
        apply_ms = [cuda_ms(lambda p=p: dl.scatter_set_tree(
            applier.flattener, applier.params, p.values, p.indices,
            p.count), DELTA_REPS) for p in payloads]
        intake_ms = []              # the applier's intake before the scatter
        for p in payloads:
            t0 = time.perf_counter()
            p.to(dev).verify()
            intake_ms.append((time.perf_counter() - t0) * 1e3)
        result = dict(
            model=model.name, n_layers=model.n_layers, j=pub.j, k=pub.k,
            steps=TRAIN_STEPS, step_ms=step_ms, launches=launches,
            schedule=DELTA_SCHEDULE, channel=chan.counters, health=health,
            publish_ms=statistics.median(publish_ms),
            publish_ms_all=publish_ms, publish_parts_ms=parts_ms,
            apply_ms=statistics.median(apply_ms), apply_ms_range=[
                min(apply_ms), max(apply_ms)], apply_ms_all=apply_ms,
            intake_ms=intake_ms,
            wire_bytes=dl.delta_wire_bytes(pub.k), spool_file_bytes=
            spool_bytes, resync_bytes=dl.resync_bytes(pub.j),
            resync_equiv_deltas=dl.resync_equiv_deltas(pub.j, pub.k),
            snapshot_bytes=snap_bytes, snapshot_write_s=snap_write_s,
            snapshot_read_s=snap_read_s, checkpoint_bytes=ckpt_bytes,
            checkpoint_restore_s=restore_s,
            replica_apply_s=res["apply_s"],
            decode_ms_with_applies=res["decode_s"] / SERVE_NEW * 1e3,
            decode_ms_without=plain["decode_s"] / SERVE_NEW * 1e3,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        check(result["wire_bytes"] == DELTA_WIRE_BYTES,
              f"delta: wire bytes {result['wire_bytes']}")
        emit("delta", **result)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


STAGES = ("train/loss_grad", "train/flatten", "train/sync",
          "train/optimizer", "compress/sweeps", "compress/trim",
          "compress/fallback", "sync/combine", "sketch/encode",
          "sketch/allreduce", "sketch/estimate", "sketch/select",
          "compress/scores", "compress/select", "compress/apply",
          "sync/simulate", "sync/dense", "sync/select")


def phase_profile(dev, run, state, phase: str, profiled: bool = True):
    """Device time of one more step of the trained state, by kernel and
    by the step's record_function stages; busy share = kernel time over
    the step's wall time. Returns (the shapes (J, rows, width) of the
    start tables that the step's sync keeps, the wall ms, the stages).
    In a process group every rank takes the step (8 rows each) and the
    ``profiled`` one alone traces it and prints the line; the others
    return None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import lm_batch
    from repro_torch.train.step import build_train_step
    step = build_train_step(run, dev)
    batch = lm_batch(run.model, TRAIN_BATCH, TRAIN_SEQS.get(
        run.model.name, TRAIN_SEQ), run.seed, 0, dev)
    torch.cuda.synchronize(dev)
    if not profiled:
        step(state, batch)
        torch.cuda.synchronize(dev)
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device events are kernels and memcpys, plus the GPU-side spans of
    # the record_function stages and the ``nccl:`` ranges around each
    # collective's kernel, which are not work of their own
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in STAGES
                      and not e.key.startswith("nccl:")
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    stages = {key: {} for key in STAGES}
    for e in events:
        if e.key in STAGES:
            if e.device_type == DeviceType.CUDA:
                stages[e.key]["device_span_ms"] = e.device_time_total / 1e3
            else:
                stages[e.key]["host_ms"] = e.cpu_time_total / 1e3
    stages = {key: val for key, val in stages.items() if val}
    tables = [list(key[1:]) for key in step.gsync.sketch_tables]
    segments = None
    if step.seg_bounds is not None or step.stream_bounds is not None:
        segments = segment_spans(prof.events(), run.sparsifier.overlap ==
                                 "backward")
    emit(phase, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms,
         kernel_launches=sum(n for _, _, n in kernels), stages=stages,
         fallback=dict(step.gsync.fallback_reasons),
         sketch_tables=tables, segments=segments,
         top_kernels=[{"name": k[:90], "ms": ms, "calls": n}
                      for k, ms, n in kernels[:15]])
    return tables, wall_ms, stages


def segment_spans(events, streamed: bool) -> dict:
    """The per-segment stage spans of a profiled step of a segmented path:
    each ``compress/sweeps`` span's start (ms from the start of
    ``train/loss_grad``) and length, on the host's clock and on the
    card's (the record_function ranges' GPU side), and how many start
    before the backward pass ends: on the host, the end of
    ``train/loss_grad``; on the card, the start of ``train/sync``, whose
    first kernel (the gradient's norm) follows the backward's last on
    the main stream (a backward kernel launched from autograd's thread
    lies outside the main thread's ``train/loss_grad`` range on the
    card). A streamed step must start one early on the host."""
    from torch.autograd import DeviceType

    def spans(name, device):
        return sorted((e.time_range.start, e.time_range.end)
                      for e in events if e.name == name and
                      (e.device_type == DeviceType.CUDA) == device)
    out = {}
    for side, device in (("host", False), ("device", True)):
        grad, sweeps = spans("train/loss_grad", device), \
            spans("compress/sweeps", device)
        sync = spans("train/sync", device)
        if not grad or not sweeps:
            out[side] = None
            continue
        start = grad[0][0]
        end = sync[0][0] if device and sync else grad[-1][1]
        out[side] = {
            "backward_end_ms": (end - start) / 1e3,
            "sweeps_spans": len(sweeps),
            "sweeps_start_ms": [round((a - start) / 1e3, 3)
                                for a, _ in sweeps],
            "sweeps_ms": [round((b - a) / 1e3, 3) for a, b in sweeps],
            "started_before_backward_end": sum(a < end for a, _ in sweeps)}
    if streamed:
        check(out["host"] and out["host"]["started_before_backward_end"],
              f"streamed step: no compress/sweeps span starts before "
              f"train/loss_grad ends ({out['host']})")
    return out


def phase_overlap_equal(dev, run, state) -> None:
    """One step's sync of the streamed path on the card two ways, from the
    trained state and one gradient of its model: the stream (``begin``,
    ``feed_segment`` of each layer-aligned segment on a side CUDA stream,
    last segment first as the backward pass produces them, ``finish``)
    and the flat call of the same config without overlap on the same
    inputs; g_agg and every state tensor torch.equal."""
    import torch
    from repro_torch.configs.base import resolve_model_cfg
    from repro_torch.core.aggregate import GradientSync
    from repro_torch.core.flatten import TreeFlattener, tree_leaves
    from repro_torch.data import lm_batch
    from repro_torch.models import loss_fn
    from repro_torch.train.step import build_train_step
    step = build_train_step(run, dev)
    bounds = step.stream_bounds
    batch = lm_batch(run.model, 8, 128, run.seed, 0, dev)
    leaves = tree_leaves(state.params)
    grads = torch.autograd.grad(loss_fn(state.params, batch,
                                        resolve_model_cfg(run)), leaves)
    g = TreeFlattener(state.params).flatten(list(grads))
    del grads
    side = torch.cuda.Stream(dev)
    stream = step.gsync.begin(state.ef)
    for off, size in reversed(bounds):
        ready = torch.cuda.Event()
        ready.record()
        side.wait_event(ready)
        with torch.cuda.stream(side):
            stream.feed_segment(g[off:off + size], offset=off)
    torch.cuda.current_stream(dev).wait_stream(side)
    agg_s, ef_s = stream.finish()
    flat = GradientSync(dataclasses.replace(run.sparsifier, overlap="none"))
    agg_f, ef_f = flat(state.ef, g)
    check(bits_equal(agg_s, agg_f), "overlap: g_agg of the stream differs "
          "from the flat call's")
    check(set(ef_s) == set(ef_f), "overlap: state keys")
    for key in ef_f:
        check(bits_equal(ef_s[key], ef_f[key]),
              f"overlap: state {key} of the stream differs from the flat "
              "call's")
    emit("overlap_equal", segments=len(bounds), torch_equal=True,
         state=sorted(ef_f), fallbacks=dict(step.gsync.fallback_reasons),
         flat_fallbacks=dict(flat.fallback_reasons))
    del agg_s, ef_s, agg_f, ef_f, g
    torch.cuda.empty_cache()


def paper_states(cfg, n: int, j: int, gen, g):
    """N workers' stacked states on the CPU with every float vector drawn
    from ``gen`` (REGTOP-k's s_prev 0/1) at step 1, so that the posterior
    is live; every 7th error is -g, an exact zero of a = err + g."""
    import torch
    from repro_torch.core import sparsify
    st = sparsify.stack_states([sparsify.init_state(cfg, j, "cpu")
                                for _ in range(n)])
    for key, val in st.items():
        if key == "step":
            st[key] = torch.ones_like(val)
        elif key == "s_prev":
            st[key] = (torch.rand(val.shape, generator=gen) < 0.3).float()
        else:
            st[key] = torch.randn(val.shape, generator=gen) * 0.1
    if "err" in st:
        st["err"][:, ::7] = -g[:, ::7]
    return st


def paper_round_case(dev, kind: str, n: int, j: int, sparsity: float,
                     seed: int) -> dict:
    """One round of the paper drivers on the card and on CPU copies of the
    same inputs: make_round_fn for topk and regtopk (g_agg and every state
    vector bitwise); for sketchtopk the encodes (a bitwise, the sketch
    within its atomics bound), then the card's mean sketch closes the
    round on both devices (indices, g_agg and every error bitwise). Each
    kernel of the round launches once a worker."""
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    cfg = SparsifierConfig(kind=kind, sparsity=sparsity, mu=MU,
                           selector="exact")
    gen = torch.Generator().manual_seed(seed)
    grads = torch.randn((n, j), generator=gen)
    st_c = paper_states(cfg, n, j, gen, grads)
    st_d = {key: val.to(dev) for key, val in st_c.items()}
    res = {"kind": kind, "n": n, "j": j,
           "k": sparsify.resolve_k(cfg, j), "bitwise": True}
    reset_launches()
    if kind == "sketchtopk":
        sync_d, sync_c = GradientSync(cfg), GradientSync(cfg)
        enc_d = [sync_d.encode(s_, g_) for s_, g_ in zip(
            sparsify.unstack_states(st_d, n), grads.to(dev))]
        enc_c = [sync_c.encode(s_, g_) for s_, g_ in zip(
            sparsify.unstack_states(st_c, n), grads)]
        gaps = []
        for (a_d, sk_d), (a_c, sk_c) in zip(enc_d, enc_c):
            check(bits_equal(a_d.cpu(), a_c), f"paper {kind} J={j}: a")
            gaps.append(sketch_gap(sk_d, sk_c, a_c))
        sk_agg = sync_d.mean_sketch([sk for _, sk in enc_d])
        g_d, new_d, idx_d = sync_d.close_sketch_round(
            sparsify.unstack_states(st_d, n), [a for a, _ in enc_d], sk_agg)
        g_c, new_c, idx_c = sync_c.close_sketch_round(
            sparsify.unstack_states(st_c, n), [a for a, _ in enc_c],
            sk_agg.cpu())
        check(torch.equal(idx_d.cpu(), idx_c), f"paper {kind} J={j}: "
              "indices differ card vs CPU")
        new_d, new_c = (sparsify.stack_states(x) for x in (new_d, new_c))
        res.update(width=sk_agg.shape[1], sketch_err=max(e for e, _ in gaps),
                   sketch_bound_share=max(x for _, x in gaps))
    else:
        g_d, new_d = sparsify.make_round_fn(cfg, n)(st_d, grads.to(dev))
        g_c, new_c = sparsify.make_round_fn(cfg, n)(st_c, grads)
    res["launches"] = launch_counts()
    check(bits_equal(g_d.cpu(), g_c), f"paper {kind} J={j}: g_agg differs "
          "card vs CPU")
    check(set(new_d) == set(new_c), f"paper {kind}: state keys")
    for key in new_c:
        check(bits_equal(new_d[key].cpu(), new_c[key]),
              f"paper {kind} J={j}: {key} differs card vs CPU")
    for name, count in res["launches"].items():
        want = n if name in PAPER_ROUND_KERNELS[kind] else 0
        check(count == want, f"paper {kind} J={j}: {name} launched "
              f"{count} times, expected {want}")
    res["state"] = sorted(new_c)
    return res


def paper_claims(fig1, fig2, genie, fig3) -> dict:
    """The assertions of tests/test_paper_claims.py on the drivers'
    results (fig1 over its first 60 iterations, as the test runs it)."""
    topk1 = fig1["topk"][:60]
    stall = sum(1 for v in topk1 if abs(v - topk1[0]) < 1e-6)
    gap1 = max(abs(a - b) for a, b in zip(fig1["regtopk"][4:40],
                                          fig1["none"][4:40]))
    check(stall >= 45, f"fig1: TOP-1 stalls {stall} iterations")
    check(gap1 < 0.05, f"fig1: REGTOP-1 strays {gap1} from dense")
    check(abs(fig1["regtopk"][8] - fig1["none"][8]) < 0.01, "fig1: t=8")
    check(fig1["regtopk"][20] < 0.1 < fig1["topk"][20], "fig1: t=20")
    dense, topk, reg = (fig2[(0.6, kind)] for kind in
                        ("none", "topk", "regtopk"))
    check(dense[-1] < 1e-3, f"fig2: dense ends at {dense[-1]}")
    check(topk[-1] > 5 * dense[-1], "fig2: TOP-k does not plateau")
    check(topk[-1] > 0.5 * topk[len(topk) // 2], "fig2: TOP-k not flat")
    check(reg[-1] < 1.5 * topk[-1], "fig2: REGTOP-k above 1.5x TOP-k")
    genie_gap = genie[(0.6, "globaltopk")][-1]
    check(genie_gap < 1e-3, f"genie ends at {genie_gap}")
    acc_t, acc_r = fig3["topk"][-1][1], fig3["regtopk"][-1][1]
    check(acc_r >= acc_t - 0.02, f"fig3: regtopk {acc_r} < topk {acc_t}")
    return {"fig1_topk_stall": stall, "fig1_regtopk_gap": gap1,
            "fig2_final": {"none": dense[-1], "topk": topk[-1],
                           "regtopk": reg[-1]},
            "genie_final": genie_gap,
            "fig3_acc": {"topk": acc_t, "regtopk": acc_r}}


def phase_paper(dev) -> dict:
    """The paper's experiments on the card through the port's drivers:
    first one round of each kind at fig2's and fig3's shapes held against
    the CPU, then fig1, fig2 at S = 0.6 (dense, TOP-k, REGTOP-k), the
    genie at fig2's size, EXPERIMENTS.md's fig2 table (REGTOP-k, the
    sketch, the genie at S = 0.4, 0.5, 0.6) and fig3; the claims of
    tests/test_paper_claims.py on the results, each figure's seconds and
    its kernel launches (counted from 0 before it)."""
    import torch
    from repro_torch import paper_experiments as pe
    for i, (n, j, sparsity) in enumerate(PAPER_SHAPES):
        for kind in PAPER_ROUND_KERNELS:
            emit("paper_round", **paper_round_case(dev, kind, n, j,
                                                   sparsity, seed=30 + i))
    # name: (the driver's call, and the (iterations, workers, S values,
    # kinds) its rounds run: each kernel of PAPER_ROUND_KERNELS[kind]
    # launches once a worker a round, no other kernel at all)
    runs = {
        "fig1": (lambda: pe.fig1_toy_logistic(iters=FIG1_ITERS, device=dev),
                 (FIG1_ITERS, 2, 1, ("none", "topk", "regtopk"))),
        "fig2": (lambda: pe.fig2_linreg(
            S_values=(0.6,), iters=FIG2_ITERS,
            kinds=("none", "topk", "regtopk"), device=dev),
            (FIG2_ITERS, 20, 1, ("none", "topk", "regtopk"))),
        "genie": (lambda: pe.fig2_linreg(
            S_values=(0.6,), iters=FIG2_ITERS, kinds=("globaltopk",),
            device=dev), (FIG2_ITERS, 20, 1, ("globaltopk",))),
        "fig2_table": (lambda: pe.fig2_linreg(
            iters=FIG2_TABLE_ITERS,
            kinds=("regtopk", "sketchtopk", "globaltopk"), device=dev),
            (FIG2_TABLE_ITERS, 20, 3, ("regtopk", "sketchtopk",
                                       "globaltopk"))),
        "fig3": (lambda: pe.fig3_nn(iters=FIG3_ITERS, eval_every=FIG3_ITERS,
                                    device=dev),
                 (FIG3_ITERS, 8, 1, ("topk", "regtopk"))),
    }
    out, seconds, launches = {}, {}, {}
    for name, (run, (iters, workers, n_s, kinds)) in runs.items():
        reset_launches()
        t0 = time.perf_counter()
        out[name] = run()
        torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        launches[name] = {key: val for key, val in launch_counts().items()
                          if val}
        want = {}
        for kind in kinds:
            for key in PAPER_ROUND_KERNELS.get(kind, ()):
                want[key] = want.get(key, 0) + iters * workers * n_s
        check(launches[name] == want, f"paper {name}: launches "
              f"{launches[name]}, expected {want}")
        emit(f"paper_{name}", seconds=seconds[name],
             launches=launches[name])
    claims = paper_claims(out["fig1"], out["fig2"], out["genie"], out["fig3"])
    table = out["fig2_table"]
    for kind in ("regtopk", "sketchtopk", "globaltopk"):
        check(all(math.isfinite(table[(s_, kind)][-1])
                  for s_ in (0.4, 0.5, 0.6)), f"fig2 table {kind}")
    print(f"fig2 table, final ||w - w*|| after {FIG2_TABLE_ITERS} "
          "iterations:\n    S   regtopk  sketchtopk  globaltopk", flush=True)
    for s_ in (0.4, 0.5, 0.6):
        print(f"  {s_:.1f}  " + "  ".join(
            f"{table[(s_, kind)][-1]:.2e}"
            for kind in ("regtopk", "sketchtopk", "globaltopk")), flush=True)
    total = {}
    for counts in launches.values():
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
    emit("paper", seconds=seconds, launches=total, claims=claims,
         fig2_table={f"{s_}/{kind}": table[(s_, kind)][-1]
                     for s_ in (0.4, 0.5, 0.6)
                     for kind in ("regtopk", "sketchtopk", "globaltopk")},
         fig2_table_iters=FIG2_TABLE_ITERS)
    return total


WORLD_J = 1 << 24
WORLD_CASES = {      # dense SGD on dyadic gradients (exact in any order)
    "regtopk_fused_sparse": dict(kind="regtopk", pipeline="fused",
                                 comm_mode="sparse"),
    "none": dict(kind="none"),
    # the chunked, overlapped all-gather: 4 chunks on the bf16 wire
    "regtopk_bucketed_bf16_wire": dict(kind="regtopk", pipeline="fused",
                                       comm_mode="sparse", num_buckets=4,
                                       wire_dtype="bfloat16"),
    # the sketch's values-only combine: in 4 chunks on the bf16 wire with
    # a bf16 state, and elastic with one rank sitting out a step (dyadic
    # gradients: every sketch bucket and every sum is exact)
    "sketch_chunked_bf16": dict(kind="sketchtopk", pipeline="fused",
                                comm_mode="sparse", num_buckets=4,
                                ef_dtype="bfloat16", wire_dtype="bfloat16"),
    "sketch_elastic": dict(kind="sketchtopk", pipeline="fused",
                           comm_mode="sparse", err_decay=ERR_DECAY),
}
# a world case's participation bits: rank (t + 1) % world sits out step t
ELASTIC_WORLD = ("sketch_elastic",)


def chunked_round(cfg, states: list, grads: list):
    """The in-process expectation of the chunked sparse combine: every
    worker's compress, then its packed values rounded to the wire dtype
    and scatter-added chunk by chunk, worker by worker inside a chunk,
    scaled by 1/n; returns (g_agg, new states)."""
    import torch
    from repro_torch.core import bigvec, sparsify
    n, j = len(grads), grads[0].numel()
    outs = [sparsify.compress(cfg, st, g, omega=1.0 / n)
            for st, g in zip(states, grads)]
    k = outs[0].values.numel()
    nb = cfg.num_buckets if k > cfg.num_buckets else 1
    chunk = -(-k // nb)
    dense = torch.zeros(j, device=grads[0].device)
    wire = getattr(torch, cfg.wire_dtype)
    for b in range(nb):
        sl = slice(b * chunk, (b + 1) * chunk)
        for out in outs:
            bigvec.scatter_add_(dense, out.indices[sl],
                                out.values[sl].to(wire).float())
    dense.mul_(1.0 / n)
    return dense, [sparsify.observe_aggregate(cfg, out.state, dense)
                   for out in outs]


def world_bits(name: str, world: int, t: int):
    """Step t's participation bits of a world case (None: no mask)."""
    if name not in ELASTIC_WORLD:
        return None
    return [r != (t + 1) % world for r in range(world)]


def sketch_world_round(cfg, states: list, grads: list, bits):
    """The in-process expectation of the sketch's per-step combine over
    the workers: each worker's encode, the mean sketch (over the active
    ones under ``bits``), the shared indices, then the values (zeros from
    a sitting-out worker) rounded to the wire dtype, summed over the
    workers in fp32 in rank order (with the combine's inert chunk pad at
    index 0), scattered into zeros and divided by n, or max(n_active,
    1); each worker's error closed at the indices. Returns (g_agg, new
    states)."""
    import torch
    from repro_torch.core import bigvec, sparsify
    from repro_torch.core.aggregate import GradientSync
    sync = GradientSync(cfg)
    n, j = len(grads), grads[0].numel()
    dev = grads[0].device
    pfs = None if bits is None else [
        torch.tensor(b, device=dev) for b in bits]
    encs = [sync.encode(st, g, None if pfs is None else pfs[i])
            for i, (st, g) in enumerate(zip(states, grads))]
    sk = sync.mean_sketch([sk for _, sk in encs], participate=pfs)
    idx = sync.decode(sk, j)
    k = idx.numel()
    nb = cfg.num_buckets if k > cfg.num_buckets else 1
    pad = -(-k // nb) * nb - k
    wire = getattr(torch, cfg.wire_dtype)
    vals = [a[idx] if pfs is None else torch.where(pfs[i], a[idx], 0.0)
            for i, (a, _) in enumerate(encs)]
    vsum = vals[0].to(wire).float()
    for v in vals[1:]:
        vsum = vsum + v.to(wire).float()
    dense = torch.zeros(j, device=dev)
    bigvec.scatter_add_(dense, torch.cat([idx, idx.new_zeros(pad)]),
                        torch.cat([vsum, vsum.new_zeros(pad)]))
    if pfs is None:
        dense.mul_(1.0 / n)
    else:
        na = sum(float(b) for b in bits)
        dense.div_(torch.full((), max(na, 1.0), device=dev))
    key = sparsify.err_key(cfg)
    new = [{key: bigvec.scatter_set_live_(
                a.to(st[key].dtype), idx, None if pfs is None else pfs[i],
                0.0), "step": st["step"] + 1}
           for i, ((a, _), st) in enumerate(zip(encs, states))]
    return dense, new


def world_grads(name: str, world: int, j: int):
    """(SYNC_STEPS, world, j) CPU gradients of a world case, the same in
    every rank's process: Gaussian, or dyadic for the dense all-reduce,
    whose sums are then exact in NCCL's order too."""
    import torch
    gen = torch.Generator().manual_seed(19)
    shape = (SYNC_STEPS, world, j)
    if name == "none" or name.startswith("sketch"):
        return dyadic(gen, SYNC_STEPS * world * j, "cpu").reshape(shape)
    return torch.randn(shape, generator=gen)


def world_rank(rank: int, world: int, port: int, backend: str = "nccl",
               j: int = WORLD_J, tp=None) -> int:
    """One rank of the multi-card check: GradientSync over the process
    group, SYNC_STEPS steps of each WORLD_CASES config; g_agg must be
    bitwise identical on every rank and, like every rank's final state,
    equal to an in-process round() of the same workers (on rank 0), or
    for a chunked or bf16 wire to :func:`chunked_round`, or for the
    sketch to :func:`sketch_world_round` (its elastic case under the
    bits of :func:`world_bits`). Then the multi-rank phases, and at a
    world of 4 the tensor-parallel ones (WORLD_TP, then TP_PHASES);
    ``tp``, a list of their names, runs those alone (an empty list: all
    of them; ``world_decode_cp`` among the names runs it too).
    ``backend="gloo"`` at a small ``j`` runs the same check on the CPU
    without cards (tests/test_torch_chip_world.py)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    cuda = backend == "nccl"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)

    def gather(x):
        x = x.reshape(-1)
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return out

    tp_only = tp is not None
    try:
        for name, fields in ({} if tp_only else WORLD_CASES).items():
            cfg = SparsifierConfig(sparsity=SPARSITY, mu=MU, **fields)
            grads = world_grads(name, world, j)
            sync = GradientSync(cfg)
            st = sparsify.init_state(cfg, j, dev)
            ip_sync = GradientSync(cfg)
            ip_states = [sparsify.init_state(cfg, j, dev)
                         for _ in range(world)]
            step_ms = []
            for t in range(SYNC_STEPS):
                g = grads[t, rank].to(dev)
                bits = world_bits(name, world, t)
                p = None if bits is None else torch.tensor(bits[rank],
                                                           device=dev)
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                g_agg, st = sync(st, g, participate=p)
                if cuda:
                    torch.cuda.synchronize(dev)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                every = gather(g_agg)
                if rank == 0:
                    for r, other in enumerate(every):
                        check(bits_equal(other, every[0]),
                              f"world {name} step {t}: g_agg of rank {r} "
                              "differs from rank 0's")
                    ip_grads = [grads[t, r].to(dev) for r in range(world)]
                    if cfg.kind == "sketchtopk":
                        want, ip_states = sketch_world_round(
                            cfg, ip_states, ip_grads, bits)
                    elif cfg.num_buckets > 1 or cfg.wire_dtype != "float32":
                        want, ip_states = chunked_round(cfg, ip_states,
                                                        ip_grads)
                    else:
                        want, ip_states = ip_sync.round(ip_states, ip_grads)
                    check(bits_equal(g_agg, want), f"world {name} step {t}:"
                          " g_agg differs from the in-process round")
            for key in sorted(st):
                every = gather(st[key])
                if rank == 0:
                    for r, other in enumerate(every):
                        check(bits_equal(other, ip_states[r][key].reshape(-1)),
                              f"world {name}: rank {r}'s {key} differs from "
                              "the in-process round's")
            if rank == 0:
                emit("world", case=name, backend=backend, world=world, j=j,
                     steps=SYNC_STEPS, sparsifier=dataclasses.asdict(cfg),
                     comm=sync.comm, step_ms=step_ms,
                     bitwise_across_ranks=True, equals_round=True,
                     state=sorted(st))
        if not tp_only:
            del st, ip_states, ip_sync, sync
            for name in WORLD_TRAIN:
                world_train(name, dev, world, rank)
                if cuda:
                    torch.cuda.empty_cache()
            world_serve(dev, world, rank)
            if cuda:
                torch.cuda.empty_cache()
            world_decode_cp(dev, world, rank)
            world_allgather(dev, world, rank)
        else:
            if "world_decode_cp" in tp:
                world_decode_cp(dev, world, rank)
            if "world_allgather" in tp:
                world_allgather(dev, world, rank)
        if world == 4:
            for name in list(WORLD_TP) + list(TP_PHASES):
                if tp and name not in tp:
                    continue
                if cuda:
                    torch.cuda.empty_cache()
                if name in WORLD_TP:
                    world_train_tp(name, dev, world, rank)
                else:
                    TP_PHASES[name](dev, world, rank)
    except BaseException:
        # print it now and leave: tearing the group down would wait on the
        # ranks blocked in a collective, and the log would lose the cause
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        drop_tp_trainer(rank)
        os._exit(1)
    drop_tp_trainer(rank)
    dist.destroy_process_group()
    return 0


# the multi-rank phases of --world (one process a card): the launcher's
# train() and serve() and the serve step's builders over the group. On
# the card: StableLM-3B at full width and the train cell's depth (and 2
# layers for the in-process replay), global batch 32 x 128 (8 rows a rank
# at a world of 4, the one-card train cell's work a rank), 5 steps;
# Granite-8B at full width and depth in fp32. Over gloo on the CPU
# (tests/test_torch_chip_world.py) the reduced configs at small shapes.
WORLD_TRAIN = {   # phase: sparsifier fields, kernels once a step, depth
    "world_train": (dict(kind="regtopk", **FUSED), ("sweep1", "sweep2"),
                    TRAIN_LAYERS),
    "world_train_dense": (dict(kind="none"), (), TRAIN_LAYERS),
    "world_train_small": (dict(kind="regtopk", **FUSED), ("sweep1",
                                                          "sweep2"), 2),
}
WORLD_BATCH, WORLD_SEQ = 32, 128
WORLD_CP_PROMPT, WORLD_CP_SLOTS = 4096, 4160   # 1040 slots a rank at 4
# world_decode_cp's lines: (arch, depth (None: full), prompt, cache slots,
# MLA forms), fp32 at full width, batch 1. DeepSeek-V2-Lite's weights take
# 63.2 GB a card at full depth; rank 0 also prefills the prompt on one
# card and holds both caches, which must stay under WORLD_CP_PEAK. Jamba
# at one super-block (SERVE_DEPTH): its attention layer's cache split, the
# Mamba state whole on every card. xLSTM has no attention cache: every
# card steps the whole state. Over gloo the reduced configs, prompt 12 in
# 16 slots (xLSTM 8 in 12), 4 steps.
WORLD_CP_CELLS = (
    ("granite-8b", None, WORLD_CP_PROMPT, WORLD_CP_SLOTS, (False,)),
    ("deepseek-v2-lite-16b", None, WORLD_CP_PROMPT, WORLD_CP_SLOTS,
     (False, True)),
    ("jamba-v0.1-52b", 8, WORLD_CP_PROMPT, WORLD_CP_SLOTS, (False,)),
    ("xlstm-125m", None, SERVE_PROMPT, SERVE_PROMPT + SERVE_NEW, (False,)))
WORLD_CP_PEAK = 76e9
WORLD_CHUNK = 1 << 26        # elements a gather of the params compares


def world_model(depth: int, cuda: bool):
    """(model, global batch, seq, sparsity) of a world train phase."""
    from repro_torch.configs.base import get_config, reduced_config
    if cuda:
        return (dataclasses.replace(get_config("stablelm-3b"),
                                    n_layers=depth),
                WORLD_BATCH, WORLD_SEQ, SPARSITY)
    return reduced_config(get_config("stablelm-3b")), 8, 16, 0.01


def world_equal(flat, world: int, rank: int) -> bool:
    """Whether every rank holds the same bits as rank 0 in the vector
    ``flat``: rank 0 gathers the others' chunk by chunk."""
    import torch
    import torch.distributed as dist
    same = True
    for off in range(0, flat.numel(), WORLD_CHUNK):
        part = flat[off:off + WORLD_CHUNK].contiguous()
        parts = ([torch.empty_like(part) for _ in range(world)]
                 if rank == 0 else None)
        dist.gather(part, parts, dst=0)
        if rank == 0:
            same = same and all(bits_equal(x, part) for x in parts)
    return same


def world_peaks(dev, cuda: bool) -> list:
    """Every rank's peak device memory since the last reset (bytes)."""
    import torch
    import torch.distributed as dist
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, peak)
    return out


def world_train(phase: str, dev, world: int, rank: int) -> None:
    """The launcher's train() over the group: TRAIN_STEPS steps of the
    global batch (each rank its rows), every kernel's launches exact on
    every rank (on the card), the loss finite and falling, the flat
    parameters bitwise equal on every rank; each rank's peak, steps 1-4
    and (on the card) one more step profiled on rank 0, the others
    stepping beside it. ``world_train_small`` then replays the ranks'
    batches on rank 0 with ``GradientSync.round`` and one whole-vector
    Adam, which must give the same parameters bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import (OptimizerConfig, RunConfig, SHAPES,
                                          SparsifierConfig)
    from repro_torch.core.flatten import TreeFlattener
    from repro_torch.launch.train import train
    cuda = dev.type == "cuda"
    fields, kernels, depth = WORLD_TRAIN[phase]
    model, batch, seq, sparsity = world_model(depth, cuda)
    run = RunConfig(
        model=model, shape=SHAPES["train_4k"],
        sparsifier=SparsifierConfig(**dict(sparsity=sparsity, mu=MU,
                                           **fields)),
        optimizer=OptimizerConfig(kind="adam", lr=1e-3), seed=0,
        steps=TRAIN_STEPS, log_every=1)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = train(run, device=dev, group=dist.group.WORLD, batch=batch,
                seq=seq, fixed_batch=True,
                log=lambda msg: print(msg, file=sys.stderr))
    launches = launch_counts()
    expect = train_expect(kernels) if cuda else {}
    for name, n in launches.items():
        check(n == expect.get(name, 0), f"{phase} rank {rank}: {name} "
              f"launched {n} times in {TRAIN_STEPS} steps, expected "
              f"{expect.get(name, 0)}")
    losses = [rec["loss"] for rec in out["history"]]
    check(all(math.isfinite(x) for x in losses), f"{phase}: {losses}")
    check(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    peaks = world_peaks(dev, cuda)
    state = out.pop("state")
    flat = TreeFlattener(state.params).flatten(state.params).detach()
    same = world_equal(flat, world, rank)
    if rank == 0:
        check(same, f"{phase}: the ranks' parameters differ")
    spans = None
    if cuda:
        spans = phase_profile(dev, run, state, phase.replace(
            "train", "profile"), profiled=rank == 0)
    del state
    replay = None
    if phase == "world_train_small":
        replay = world_replay(dev, run, batch, seq, world, rank, flat)
    if rank == 0:
        emit(phase, model=model.name, n_layers=model.n_layers,
             j=out["params"], world=world, global_batch=batch, seq=seq,
             rows_a_rank=batch // world, steps=TRAIN_STEPS,
             sparsifier=dataclasses.asdict(run.sparsifier), losses=losses,
             step_ms=[rec["ms"] for rec in out["history"]],
             launches_a_rank=launches, fallbacks=out["fallbacks"],
             max_memory_allocated_by_rank=peaks,
             params_bitwise_across_ranks=same, equals_replay=replay,
             profile_stages=None if spans is None else spans[2])


def world_replay(dev, run, batch: int, seq: int, world: int, rank: int,
                 flat) -> bool:
    """Rank 0 replays the ranks' TRAIN_STEPS steps in one process: the
    gradient of each rank's rows of the fixed global batch, one
    ``GradientSync.round`` of the ranks' workers, Adam on the whole
    vector (elementwise, so the ZeRO-1 slicing must not change a bit);
    True when that equals ``flat`` (the trained parameters) bit for bit.
    The other ranks wait."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    from repro_torch.core.flatten import TreeFlattener, tree_leaves
    from repro_torch.data import lm_batch
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import apply_updates, init_opt_state
    same = None
    if rank == 0:
        params = init_params(run.model, torch.Generator(
            device=dev).manual_seed(run.seed), dev)
        tf = TreeFlattener(params)
        master = tf.flatten(params)
        del params
        opt = init_opt_state(run.optimizer, master)
        sync = GradientSync(run.sparsifier)
        states = [sparsify.init_state(run.sparsifier, tf.total, dev)
                  for _ in range(world)]
        glob = lm_batch(run.model, batch, seq, run.seed, 0, dev)
        rows = batch // world
        for _ in range(run.steps):
            tree = tf.unflatten(master.clone())
            leaves = [t.requires_grad_(True) for t in tree_leaves(tree)]
            grads = []
            for r in range(world):
                part = {key: val[r * rows:(r + 1) * rows]
                        for key, val in glob.items()}
                loss = loss_fn(tree, part, run.model)
                grads.append(tf.flatten(list(torch.autograd.grad(loss,
                                                                 leaves))))
            g_agg, states = sync.round(states, grads)
            del grads
            master, opt = apply_updates(run.optimizer, opt, g_agg)
        same = bits_equal(master[:tf.total], flat)
        check(same, "world_train_small: the ranks' parameters differ from "
              "the in-process replay")
    dist.barrier()
    return same


def world_serve(dev, world: int, rank: int) -> None:
    """The serve launcher's serve() over the group: a data-parallel
    batch (SERVE_BATCH rows, SERVE_BATCH / world a rank) of Granite-8B
    in fp32, prompt SERVE_PROMPT, SERVE_NEW greedy steps; rank 0 holds
    the gathered logits of the prefill and of the last step within
    SERVE_RTOL of a one-card forward of the same tokens; decode ms a step
    is the median of SERVE_REPS more windows over the group."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import (RunConfig, SparsifierConfig,
                                          get_config, reduced_config)
    from repro_torch.launch.serve import serve, serve_shape
    from repro_torch.models import init_params
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import lm_head_fwd
    cuda = dev.type == "cuda"
    cfg = get_config("granite-8b")
    prompt, new = SERVE_PROMPT, SERVE_NEW
    if not cuda:
        cfg, prompt, new = reduced_config(cfg), 8, 4
    cfg = dataclasses.replace(cfg, dtype="float32")
    run = RunConfig(model=cfg, shape=serve_shape(SERVE_BATCH, prompt, new),
                    sparsifier=SparsifierConfig(kind="none"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    out = serve(run, device=dev, group=dist.group.WORLD, prompt_len=prompt,
                new_tokens=new, params=params,
                log=lambda msg: print(msg, file=sys.stderr))
    check(tuple(out["logits"].shape) == (SERVE_BATCH, cfg.vocab_size),
          f"world_serve: logits {tuple(out['logits'].shape)}")
    rows = tuple(out["cache"]["blocks"]["l0"]["k"].shape[1:3])
    check(rows == (SERVE_BATCH // world, prompt + new),
          f"world_serve: a rank's cache (rows, slots) {rows}")
    windows = decode_windows(dev, run, params, out["cache"], out["tokens"]) \
        if cuda else None
    peaks = world_peaks(dev, cuda)
    if rank == 0:
        tokens = torch.cat([out["prompt"], out["tokens"]], 1)
        with torch.inference_mode():
            x = tfm.forward_hidden(params, tfm.embed_batch(params, tokens,
                                                           cfg), cfg)
            full = lm_head_fwd(params["embed"], x[:, [prompt - 1, -1]],
                               cfg).float()
            del x
        scale = float(full.abs().max())
        e_pre = float((out["prefill_logits"] - full[:, 0]).abs().max())
        e_dec = float((out["logits"] - full[:, 1]).abs().max())
        check(e_pre / scale < SERVE_RTOL and e_dec / scale < SERVE_RTOL,
              f"world_serve: errors {e_pre / scale}, {e_dec / scale} over "
              f"{SERVE_RTOL} of the one-card forward")
        emit("world_serve", arch=cfg.name, n_layers=cfg.n_layers,
             world=world, batch=SERVE_BATCH, rows_a_rank=rows[0],
             prompt=prompt, new_tokens=new, params=out["params"],
             prefill_ms=out["prefill_s"] * 1e3,
             launcher_decode_ms_per_step=out["decode_s"] / new * 1e3,
             decode_ms_per_step=None if windows is None
             else statistics.median(windows), decode_ms_windows=windows,
             prefill_rel_err=e_pre / scale, decode_rel_err=e_dec / scale,
             max_memory_allocated_by_rank=peaks,
             first_sequence=out["tokens"][0].tolist())
    dist.barrier()


def world_decode_cp(dev, world: int, rank: int) -> None:
    """Context-parallel decode over the group, one line a WORLD_CP_CELLS
    model and MLA form: fp32, batch 1, the prompt prefilled on rank 0's
    card into a cache of the cell's slots, broadcast and cut by
    ``shard_decode_cache`` (each rank a slice of every attention layer's
    slots, MLA's ckv and krope too, and the whole of every recurrent
    state); SERVE_NEW greedy steps through the serve step's decode
    builder (the second MLA form fed the first's tokens), every rank's
    logits the same bits and, after the last step, every recurrent leaf
    too; then rank 0 decodes the same tokens on its one-card cache: each
    step's logits within SERVE_RTOL of those (relative to their largest),
    decode ms a step of both on rank 0's card, and rank 0's peak after
    the weights are drawn (under WORLD_CP_PEAK on the card)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import (RunConfig, ShapeConfig,
                                          SparsifierConfig, get_config,
                                          reduced_config)
    from repro_torch.core.flatten import tree_items, tree_map
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.step import build_decode_step, shard_decode_cache
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    for arch, depth, prompt, slots, forms in WORLD_CP_CELLS:
        cfg, new = get_config(arch), SERVE_NEW
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        if not cuda:
            cfg, new = reduced_config(cfg), 4
            prompt, slots = (8, 12) if prompt == SERVE_PROMPT else (12, 16)
        cfg = dataclasses.replace(cfg, dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                               device=dev)
        if cuda:
            # the peak from here on: the weights, the one-card prefill and
            # the caches, not the draws' temporaries
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        with torch.inference_mode():
            if rank == 0:
                sync()
                t0 = time.perf_counter()
                first, full = tfm.prefill(params, {"tokens": tokens}, cfg,
                                          max_seq=slots)
                sync()
                prefill_ms = (time.perf_counter() - t0) * 1e3
            else:
                first = torch.empty((1, cfg.vocab_size), device=dev)
                full = tfm.init_decode_cache(cfg, 1, slots, torch.float32,
                                             dev)
            for _, leaf in tree_items(full):
                dist.broadcast(leaf, src=0)
            dist.broadcast(first, src=0)
        toks = None
        for absorb in forms:
            form = dataclasses.replace(cfg, mla_absorb=absorb)
            run = RunConfig(model=form, shape=ShapeConfig("serve", slots, 1,
                                                          "decode"),
                            sparsifier=SparsifierConfig(kind="none"))
            cache = shard_decode_cache(full, run, dist.group.WORLD)
            for (path, leaf), (_, whole) in zip(tree_items(cache),
                                                tree_items(full)):
                if path[-1] in attn.CACHE_KEYS:
                    lead = int(path[0] == "blocks")
                    part = tuple(leaf.shape[lead:lead + 2])
                    check(part == (1, slots // world), f"world_decode_cp "
                          f"{arch}: a rank's cache (rows, slots) {part} at "
                          f"{path}")
                else:
                    check(leaf.shape == whole.shape, f"world_decode_cp "
                          f"{arch}: {path} of {tuple(leaf.shape)}, the "
                          f"one-card state {tuple(whole.shape)}")
            dec = build_decode_step(run, dev)
            feed = [] if toks is None else toks
            outs, logits = [], first
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            for t in range(new):
                if toks is None:
                    feed.append(logits.argmax(-1)[:, None])
                logits, cache = dec(params, cache, feed[t])
                outs.append(logits)
            sync()
            cp_ms = (time.perf_counter() - t0) / new * 1e3
            toks = feed
            every = [None] * world
            dist.all_gather_object(every, [x.cpu() for x in outs])
            state = [leaf.reshape(-1) for path, leaf in tree_items(cache)
                     if path != ("pos",) and path[-1] not in attn.CACHE_KEYS]
            state = torch.cat(state) if state else torch.zeros(0, device=dev)
            ref = state.clone()
            dist.broadcast(ref, src=0)
            same = [None] * world
            dist.all_gather_object(same, bits_equal(state, ref))
            del cache, ref
            if rank == 0:
                check(all(all(bits_equal(a, b) for a, b in zip(o, every[0]))
                          for o in every), f"world_decode_cp {arch}: the "
                      "ranks' logits differ")
                check(all(same), f"world_decode_cp {arch}: a recurrent leaf "
                      f"differs across the ranks after the last step ({same})")
                one = tree_map(torch.clone, full)
                wants = []
                sync()
                t0 = time.perf_counter()
                with torch.inference_mode():
                    for nxt in toks:
                        want, one = tfm.decode_step(params, one, nxt, form)
                        wants.append(want)
                sync()
                one_ms = (time.perf_counter() - t0) / new * 1e3
                del one
                errs = [float((got - want).abs().max())
                        / float(want.abs().max())
                        for got, want in zip(outs, wants)]
                check(max(errs) < SERVE_RTOL, f"world_decode_cp {arch}: "
                      f"errors {errs} over {SERVE_RTOL} of one-card decode")
                peak = torch.cuda.max_memory_allocated(dev) if cuda else None
                check(peak is None or peak < WORLD_CP_PEAK,
                      f"world_decode_cp {arch}: rank 0's peak {peak} B")
                emit("world_decode_cp", arch=cfg.name, n_layers=cfg.n_layers,
                     attn=cfg.attn_kind, mla_absorb=absorb, family=cfg.family,
                     world=world, batch=1, prompt=prompt, cache_slots=slots,
                     slots_a_rank=slots // world, steps=new,
                     prefill_one_card_ms=prefill_ms,
                     decode_ms_per_step=cp_ms,
                     one_card_decode_ms_per_step=one_ms,
                     max_rel_err=max(errs), rel_errs=errs,
                     recurrent_elements=int(state.numel()),
                     recurrent_bitwise_across_ranks=True,
                     rank0_peak_bytes=peak,
                     tokens=[int(t) for t in torch.cat(toks, 1)[0].tolist()])
            del state
            dist.barrier()
        del params, full, first
        if cuda:
            torch.cuda.empty_cache()


# the tensor-parallel phases of --world 4 (one process a card): the
# launcher's train() over a (data, model) grid of the cards, and serve()
# over a model group of all four. On the card the full widths (8 layers
# for the train phases; Qwen1.5-32B at full depth, fp32); over gloo on the
# CPU (tests/test_torch_chip_world.py) the reduced configs at small shapes.
class TPCell(NamedTuple):
    """A tensor-parallel train cell: the arch at full width cut to
    ``depth`` (the decoder's; an encoder keeps its own), its (data,
    model) grid, the global batch, whether step 0 is held against one
    card, the sequence on the card (0: TRAIN_SEQS' or TRAIN_SEQ) and the
    attention's distribution ("ring": ring attention)."""
    arch: str
    depth: int
    mesh: tuple
    batch: int
    step0: bool
    seq: int = 0
    attn_dist: str = "sp"


RING_SEQ = 8192              # world_train_ring: 2048 positions a card
WORLD_TP = {
    "world_train_tp": TPCell("stablelm-3b", TRAIN_LAYERS, (1, 4),
                             TRAIN_BATCH, True),
    "world_train_tp2x2": TPCell("stablelm-3b", TRAIN_LAYERS, (2, 2),
                                2 * TRAIN_BATCH, True),
    "world_train_ep": TPCell("granite-moe-3b-a800m", TRAIN_LAYERS, (1, 4),
                             TRAIN_BATCH, False),
    # MLA under tensor parallelism: the dense prefix and 7 MoE layers
    # (J = 4,594,374,656, 16 of the 64 experts a card)
    "world_train_mla": TPCell("deepseek-v2-lite-16b", 8, (1, 4),
                              TRAIN_BATCH, True),
    # the mLSTM's value split and the sLSTM's channels: 2 of the 6
    # super-blocks (at full depth the cell and its profile took about 195
    # s of the call's 1200)
    "world_train_xlstm": TPCell("xlstm-125m", 4, (2, 2), 2 * TRAIN_BATCH,
                                True),
    # the encoder-decoder at full width and depth (12 + 12 layers, 1500
    # frames, whole on every card): 3 of the 12 heads a card
    "world_train_whisper": TPCell("whisper-small", 12, (1, 4), TRAIN_BATCH,
                                  True),
    # the vision stub at full width and depth (3,821,079,552 parameters,
    # about 955 M a card), 8 x 1024 tokens with 576 patches
    "world_train_phi3v": TPCell("phi-3-vision-4.2b", 32, (1, 4),
                                TRAIN_BATCH, True),
    # ring attention: every card all 32 heads of its own weights and 2048
    # of the 8192 positions; not a one-card model, so no step-0 check
    "world_train_ring": TPCell("stablelm-3b", TRAIN_LAYERS, (1, 4), 2,
                               False, RING_SEQ, "ring"),
}
# world_serve_tp's cells (arch, depth, attention: "absorb" is MLA's
# absorbed form), each arch's parameters drawn once: Qwen1.5-32B (35.2 GB
# of fp32 weights a card), DeepSeek-V2-Lite in both MLA forms (15.7 GB),
# Jamba-v0.1-52B at its 32 layers (51.6 GB), each at full width and depth
TP_SERVE_CELLS = (("qwen1.5-32b", 64, "full"),
                  ("deepseek-v2-lite-16b", 27, "full"),
                  ("deepseek-v2-lite-16b", 27, "absorb"),
                  ("jamba-v0.1-52b", 32, "full"),
                  ("whisper-small", 12, "full"),
                  ("phi-3-vision-4.2b", 32, "full"))
TP_SERVE_PARAMS = {"qwen1.5-32b": 35_197_096_960,   # ModelConfig.param_count
                   "deepseek-v2-lite-16b": 15_706_484_224,
                   "jamba-v0.1-52b": 51_570_315_264,
                   "whisper-small": 278_115_840,
                   "phi-3-vision-4.2b": 3_821_079_552}
# a served cell's prompt where it is not SERVE_PROMPT: Phi-3-vision's
# 576 patches and 448 text tokens (on the CPU 16 patches and 8 tokens)
TP_SERVE_PROMPTS = {"phi-3-vision-4.2b": (SERVE_VISION_PROMPT, 24)}
# the step-0 check of a dense tensor-parallel cell against one card at the
# same parameters, in fp32: the loss to rtol 1e-5, the gathered gradient
# (the replicated leaves' summed over the model group) to this share of
# the one-card gradient's largest |entry| (a column- or row-parallel
# product sums its K in parts, another order than one card's)
TP_LOSS_RTOL = 1e-5
TP_GRAD_RTOL = 1e-4
TP_A2A_REPS = 10
# world_mamba_layer: one Mamba layer at Jamba's width split by channel over
# the model group, at the longer of MAMBA_SEQS; its output against one
# card's of the same parameters within this share of max |y| (the psums
# of x_proj's and out_proj's partial products add in another order)
TP_MAMBA_SEQ = 1024
TP_MAMBA_RTOL = 1e-5
# world_ring_layer: one attention layer of each arch at full width, fp32,
# batch 1, RING_SEQ positions (64 over gloo), the weights model rank 0's
# on every card; the ring's output and input gradient, gathered, against
# one card's within this share of their largest |entry| (the ring merges
# its blocks in another order than one card's chunks)
RING_LAYER_ARCHS = ("stablelm-3b", "deepseek-v2-lite-16b")
RING_LAYER_RTOL = 1e-5
# world_ckpt_tp: the launcher's train() of StableLM-3B at full width and
# 2 layers on (1, 4), a checkpoint at the end and a delta after every
# step of CKPT_DELTA_STEPS steps' worth of selections (k = steps x tp x
# the sync's k a rank: Adam moves no entry the sync never selected, so
# each delta ships every entry that moved and the replica ends on the
# joined parameters). A second save and join of the trained state on
# every card may take no more device memory beyond the live state than a
# gather's chunks of fp32 (train.step.GATHER_CHUNK a rank) and
# CKPT_SLACK_BYTES: the card holds no global copy of any tree
CKPT_LAYERS = 2
CKPT_SLACK_BYTES = 8 << 20


def tp_model(arch: str, depth: int, cuda: bool):
    """A tensor-parallel cell's model: full width at ``depth`` on the
    card, the reduced config over gloo."""
    from repro_torch.configs.base import get_config, reduced_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=depth) if cuda \
        else reduced_config(cfg)


def group_equal(x, group) -> bool:
    """Whether x holds the same bits as on the group's first rank."""
    import torch.distributed as dist
    want = x.clone()
    dist.broadcast(want, dist.get_global_rank(group, 0), group=group)
    return bits_equal(x, want)


def group_spread(x, group) -> float:
    """max |x - x on the group's first rank|."""
    import torch.distributed as dist
    want = x.clone()
    dist.broadcast(want, dist.get_global_rank(group, 0), group=group)
    return float((x - want).abs().max()) if x.numel() else 0.0


def tp_global(tree: dict, pal) -> dict:
    """A rank's parameter (or gradient) tree gathered over its model group
    into the one-card layout (``models.specs``), on every rank of it."""
    import torch
    from repro_torch.core.flatten import tree_from_items, tree_items
    from repro_torch.models.parallel import all_gather_model
    from repro_torch.models.specs import leaf_dim
    with torch.no_grad():
        return tree_from_items(
            (path, leaf.detach() if leaf_dim(path, leaf.ndim) is None
             else all_gather_model(leaf.detach().contiguous(), pal,
                                   leaf_dim(path, leaf.ndim)))
            for path, leaf in tree_items(tree))


def step0_model(cfg):
    """The config a step-0 check runs: an MoE model at capacity factor
    MOE_SERVE_CAPACITY (no choice dropped) with the load-balance term's
    weight 0. Which rank routes which token decides the drops and the
    load-balance term (a product of two means over the rank's tokens);
    the cross-entropy and the z-loss (a mean) do not depend on it."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_SERVE_CAPACITY, load_balance_loss=0.0))


def tp_step0(dev, run, pal, rows: dict, rank: int) -> dict:
    """The step-0 check of a tensor-parallel cell, in fp32 and in the
    config's dtype (an MoE model as :func:`step0_model` gives it): this
    rank's share of the parameters train() draws (``init_rank_params``),
    its loss and gradient on its data rank's rows (the replicated leaves'
    summed over the model group, and those bitwise equal across it); the
    parameters gathered into the one-card layout on every rank, then rank
    0 (data rank 0's model group) holds the model group's loss (the sum
    of the shares) against one card's ``loss_and_aux`` of the gathered
    parameters on the same rows, and each leaf of the gathered gradient,
    gathered one at a time, against one card's."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.flatten import tree_from_items, tree_items
    from repro_torch.models import transformer as tfm
    from repro_torch.models.parallel import all_gather_model, all_reduce_sum
    from repro_torch.models.specs import leaf_dim
    out = {}
    for dtype in ("float32", run.model.dtype):
        if dtype in out:
            continue
        cfg = step0_model(dataclasses.replace(run.model, dtype=dtype))
        params = tfm.init_rank_params(cfg, run.seed, dev, pal)
        items = tree_items(params)
        leaves = [leaf.requires_grad_(True) for _, leaf in items]
        loss, _ = tfm.loss_and_aux(params, rows, cfg, pal)
        grads = list(torch.autograd.grad(loss, leaves))
        rep_equal = True
        for i, ((path, leaf), grad) in enumerate(zip(items, grads)):
            if leaf_dim(path, leaf.ndim) is None:
                grads[i] = all_reduce_sum(grad, pal.model_group)
                rep_equal = rep_equal and group_equal(grads[i],
                                                      pal.model_group)
        tp_loss = float(tfm.global_loss(loss, pal))
        glob = tp_global(params, pal)
        shapes = [(path, leaf.ndim) for path, leaf in items]
        del params, leaves, loss, items
        one_loss = one_grads = None
        if rank == 0:
            one = [leaf.requires_grad_(True) for _, leaf in tree_items(glob)]
            tree = tree_from_items((path, leaf) for (path, _), leaf in
                                   zip(shapes, one))
            one_loss, _ = tfm.loss_and_aux(tree, rows, cfg)
            one_grads = list(torch.autograd.grad(one_loss, one))
            del one, tree
        del glob
        err = scale = 0.0
        for i, (path, ndim) in enumerate(shapes):
            dim = leaf_dim(path, ndim)
            with torch.no_grad():
                g = grads[i] if dim is None else all_gather_model(
                    grads[i].contiguous(), pal, dim)
            grads[i] = None
            if rank == 0:
                err = max(err, float((g - one_grads[i]).abs().max()))
                scale = max(scale, float(one_grads[i].abs().max()))
                one_grads[i] = None
            del g
        res = None
        if rank == 0:
            res = {"tp_loss": tp_loss, "one_card_loss": float(one_loss),
                   "loss_rel_err": abs(tp_loss - float(one_loss))
                   / abs(float(one_loss)),
                   "grad_max_abs_err": err, "grad_max_abs": scale,
                   "grad_rel_err": err / scale,
                   "replicated_grads_bitwise_across_model": rep_equal}
            if cfg.moe is not None:
                res["moe_check"] = {
                    "capacity_factor": cfg.moe.capacity_factor,
                    "load_balance_loss": cfg.moe.load_balance_loss}
        del grads, one_grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        out[dtype] = res
    return out


def tp_profile(dev, run, state, pal, rows: dict, rank: int):
    """One more step of the trained state over the groups, rank 0 alone
    under torch.profiler (the others step beside it): the device spans of
    the step's stages and of the MoE's all_to_all (``moe/all_to_all``: the
    forward's and the recomputed forward's), busy share and launches."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.step import build_train_step
    step = build_train_step(run, dev, pal.group, pal.model_group,
                            pal.attn_dist)
    torch.cuda.synchronize(dev)
    dist.barrier()
    if rank:
        step(state, rows)
        torch.cuda.synchronize(dev)
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, rows)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    names = STAGES + ("moe/all_to_all",)
    spans = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
             if e.key in names and e.device_type == DeviceType.CUDA}
    kernels = [k for k in cuda_kernels(prof) if k[0] not in names]
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "kernel_launches": sum(n for _, _, n in kernels),
            "stage_device_ms": spans,
            "nccl_ms": sum(ms for key, ms, _ in kernels
                           if key.startswith("ncclDevKernel")),
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": n}
                            for k, ms, n in kernels[:10]]}


def tp_all_to_all_ms(dev, run, pal, tokens: int) -> float:
    """CUDA-event ms of one MoE all_to_all over the model group at the
    main path's shape: (E_pad, capacity of this rank's ``tokens``, d)
    fp32, the median of TP_A2A_REPS."""
    import torch
    from repro_torch.models.moe import capacity, experts_padded
    from repro_torch.models.parallel import all_to_all_model
    m = run.model.moe
    e = experts_padded(run.model, pal)
    cap = capacity(tokens, e, m.top_k, m.capacity_factor)
    buf = torch.randn((e, cap, run.model.d_model), device=dev)
    times = []
    for _ in range(TP_A2A_REPS + 1):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        all_to_all_model(buf, pal, 0, 1)
        t1.record()
        torch.cuda.synchronize(dev)
        times.append(t0.elapsed_time(t1))
    return statistics.median(times[1:])


def world_train_tp(phase: str, dev, world: int, rank: int) -> None:
    """The launcher's train() over a (data, model) grid of the cards
    (``launch.mesh.axis_groups``: rank r is data r // model, model r %
    model): the main path (REGTOP-k fused, sparse comm, Adam), TRAIN_STEPS
    steps of the fixed global batch (each data rank its rows), B1 and B2
    launched exactly once a step on every rank over its own J_local (on
    the card), the loss finite and falling, the parameters bitwise equal
    across each data group; each rank's J_local and peak, and one more
    step profiled on rank 0. A cell with the step-0 flag first takes the
    step-0 check (``tp_step0``); an MoE cell reports the MoE's all_to_all
    (profiled spans and a CUDA-event timing) and the drop share (an MoE's
    capacity follows each rank's own tokens, so its trained loss is not
    one card's)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import (OptimizerConfig, RunConfig, SHAPES,
                                          SparsifierConfig)
    from repro_torch.core.flatten import TreeFlattener, tree_items
    from repro_torch.data import lm_batch
    from repro_torch.launch.mesh import axis_groups
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import head_counts
    from repro_torch.models.specs import leaf_dim
    from repro_torch.train.step import train_parallel
    cuda = dev.type == "cuda"
    cell = WORLD_TP[phase]
    data_n, model_n = cell.mesh
    batch, check0 = cell.batch, cell.step0
    model = tp_model(cell.arch, cell.depth, cuda)
    seq, sparsity = (cell.seq or TRAIN_SEQS.get(cell.arch, TRAIN_SEQ),
                     SPARSITY) if cuda else (
        32 if model.frontend == "vision_stub" else 16, 0.01)
    group, model_group = axis_groups(data_n, model_n)
    pal = train_parallel(group, model_group, cell.attn_dist)
    d = rank // model_n
    run = RunConfig(
        model=model, shape=SHAPES["train_4k"],
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=sparsity, mu=MU,
                                    **FUSED),
        optimizer=OptimizerConfig(kind="adam", lr=1e-3), seed=0,
        steps=TRAIN_STEPS, log_every=1)
    n = batch // data_n
    rows = {key: val[d * n:(d + 1) * n] for key, val in lm_batch(
        model, batch, seq, run.seed, 0, dev).items()}
    step0 = tp_step0(dev, run, pal, rows, rank) if check0 else None
    if rank == 0 and step0 is not None:
        res = step0["float32"]
        check(res["loss_rel_err"] < TP_LOSS_RTOL,
              f"{phase}: step-0 loss {res['tp_loss']} against one card's "
              f"{res['one_card_loss']} (rtol {TP_LOSS_RTOL})")
        check(res["grad_rel_err"] < TP_GRAD_RTOL,
              f"{phase}: step-0 gradient {res['grad_rel_err']} of its scale "
              f"from one card's (limit {TP_GRAD_RTOL})")
        check(all(r["replicated_grads_bitwise_across_model"]
                  for r in step0.values()),
              f"{phase}: the replicated leaves' gradients differ across the "
              "model group")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = train(run, device=dev, group=group, model_group=model_group,
                batch=batch, seq=seq, fixed_batch=True,
                log=lambda msg: print(msg, file=sys.stderr),
                attn_dist=cell.attn_dist)
    launches = launch_counts()
    expect = train_expect(("sweep1", "sweep2")) if cuda else {}
    for name, count in launches.items():
        check(count == expect.get(name, 0), f"{phase} rank {rank}: {name} "
              f"launched {count} times in {TRAIN_STEPS} steps, expected "
              f"{expect.get(name, 0)}")
    losses = [rec["loss"] for rec in out["history"]]
    check(all(math.isfinite(x) for x in losses), f"{phase}: {losses}")
    check(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    peaks = world_peaks(dev, cuda)
    state = out.pop("state")
    flat = TreeFlattener(state.params).flatten(state.params).detach()
    j_locals = [None] * world
    dist.all_gather_object(j_locals, flat.numel())
    same = [None] * world
    dist.all_gather_object(same, group_equal(flat, group))
    check(all(same), f"{phase}: the parameters differ across a data group "
          f"({same})")
    del flat
    # each rank's REGTOP-k selects its entries of the replicated leaves on
    # its own threshold (as the reference's does), so their copies may
    # drift apart across the model group: their spread is recorded
    rep = torch.cat([leaf.detach().reshape(-1)
                     for path, leaf in tree_items(state.params)
                     if leaf_dim(path, leaf.ndim) is None])
    spread = [None] * world
    dist.all_gather_object(spread, group_spread(rep, model_group))
    profile = tp_profile(dev, run, state, pal, rows, rank) if cuda else None
    del state
    a2a = None
    if cuda and model.moe is not None:
        a2a = tp_all_to_all_ms(dev, run, pal, n * seq // model_n)
    if rank == 0:
        moe = {}
        if model.moe is not None:
            moe = {"drop_frac": [rec["drop_frac"] for rec in out["history"]],
                   "lb_loss": [rec["lb_loss"] for rec in out["history"]],
                   "experts_a_card": model.moe.n_experts // model_n,
                   "vocab_padded": -(-model.vocab_size // model_n) * model_n,
                   "all_to_all_ms_one_call": a2a,
                   "all_to_all_calls_a_step": 2 * tfm.n_moe_layers(model)
                   * (3 if model.remat else 2)}
        emit(phase, model=model.name, n_layers=model.n_layers,
             n_enc_layers=model.n_enc_layers, attn_dist=cell.attn_dist,
             stub=model.frontend, data=data_n, tp=model_n,
             j_local_by_rank=j_locals,
             heads_a_card=list(head_counts(model, pal)),
             global_batch=batch, seq=seq, rows_a_data_rank=n,
             steps=TRAIN_STEPS,
             sparsifier=dataclasses.asdict(run.sparsifier), losses=losses,
             step_ms=[rec["ms"] for rec in out["history"]],
             launches_a_rank=launches, fallbacks=out["fallbacks"],
             max_memory_allocated_by_rank=peaks, step0=step0,
             params_bitwise_across_data=all(same),
             replicated_spread_by_rank=spread, profile=profile, **moe)
    dist.barrier()


def tp_serve_cfg(arch: str, depth: int, attn: str, cuda: bool):
    """A world_serve_tp cell's config in fp32: full width at ``depth`` on
    the card (the reduced config over gloo), MLA absorbed with ``attn``
    "absorb", an MoE model at capacity factor MOE_SERVE_CAPACITY (no
    choice dropped, so decode and the full forward route alike)."""
    cfg = dataclasses.replace(tp_model(arch, depth, cuda), dtype="float32",
                              mla_absorb=attn == "absorb")
    if not cuda and arch == "whisper-small":
        # over gloo a vocabulary that tp pads, as the card's Whisper's
        # 51,865 rows are padded to 51,868
        cfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size - 2)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_SERVE_CAPACITY))
    return cfg


def tp_cache_shapes(cfg, cache: dict, world: int) -> bool:
    """Whether every leaf of a rank's decode cache has the one-rank
    cache's shape cut along its ``convert.cache_split_dims`` dimension
    over ``world`` ranks (key/value heads, recurrent channels, the
    mLSTM's value dims; MLA's ckv and krope whole)."""
    import torch
    from repro_torch.convert import cache_split_dims
    from repro_torch.core.flatten import tree_items
    from repro_torch.models import transformer as tfm
    b, slots = cache["blocks"], None
    for path, leaf in tree_items(b):
        if path[-1] in ("k", "v", "ckv", "krope"):
            slots = leaf.shape[2]
    enc_seq = cache["cross"]["k"].shape[2] if "cross" in cache else 0
    one = tfm.init_decode_cache(cfg, SERVE_BATCH, slots or 1, torch.float32,
                                "meta", enc_seq=enc_seq)
    for (path, whole), (_, dim), (_, local) in zip(
            tree_items(one), cache_split_dims(one), tree_items(cache)):
        want = list(whole.shape)
        if dim is not None:
            want[dim] //= world
        if list(local.shape) != want:
            return False
    return True


def world_serve_tp(dev, world: int, rank: int) -> None:
    """The serve launcher's serve() over a model group of all the cards
    (``--model 4``) of each TP_SERVE_CELLS cell at full width and depth in
    fp32 (the reduced configs over gloo): batch SERVE_BATCH, prompt
    SERVE_PROMPT, SERVE_NEW greedy steps, each rank holding its share of
    the weights (``init_rank_params``, drawn once an arch) and of the
    cache (``tp_cache_shapes``); the parameter count over the ranks equal
    to the config's; the prefill's and the last step's logits (the padded
    vocabulary's) within SERVE_RTOL of the tensor-parallel full forward of
    the same tokens, relative to its largest logit, every two rows
    further apart than that (``row_gap``), all over the real vocabulary
    (a padded entry's logit is -1e30 in both); decode ms a step is the median
    of SERVE_REPS more windows, beside the step's bytes bound a card (its
    weights, every expert's included, B rows of its token table, its
    cache); one more step profiled (launches a step) on every rank. One
    line a cell."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig, SparsifierConfig
    from repro_torch.core.flatten import tree_items, tree_leaves, tree_size
    from repro_torch.launch.mesh import axis_groups
    from repro_torch.launch.serve import serve, serve_shape
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import lm_head_fwd
    from repro_torch.models.specs import leaf_dim
    from repro_torch.serve.step import build_decode_step, serve_parallel
    cuda = dev.type == "cuda"
    group, model_group = axis_groups(1, world)
    params, held = None, None
    for arch, depth, attn in TP_SERVE_CELLS:
        prompt, new = (SERVE_PROMPT, SERVE_NEW) if cuda else (8, 4)
        if arch in TP_SERVE_PROMPTS:
            prompt = TP_SERVE_PROMPTS[arch][0 if cuda else 1]
        cfg = tp_serve_cfg(arch, depth, attn, cuda)
        run = RunConfig(model=cfg, shape=serve_shape(SERVE_BATCH, prompt,
                                                     new),
                        sparsifier=SparsifierConfig(kind="none"))
        pal = serve_parallel(run, group, decode=False,
                             model_group=model_group)
        init_s = None
        if held != arch:
            params = None
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params = tfm.init_rank_params(cfg, run.seed, dev, pal)
            init_s = time.perf_counter() - t0
            held = arch
        n_local = tree_size(params)
        counts = [None] * world
        dist.all_gather_object(counts, n_local)
        replicated = sum(int(leaf.numel()) for path, leaf in
                         tree_items(params)
                         if leaf_dim(path, leaf.ndim) is None)
        # the vocabulary's padding to a multiple of tp (Whisper's 51,865
        # rows to 51,868) is not the config's
        v_pad = -(-cfg.vocab_size // world) * world
        total = sum(counts) - (world - 1) * replicated - (
            v_pad - cfg.vocab_size) * cfg.d_model * (
                1 if cfg.tie_embeddings else 2)
        check(total == cfg.param_count(), f"world_serve_tp {arch}: {total} "
              f"parameters over the ranks, the config has "
              f"{cfg.param_count()}")
        if cuda:
            check(total == TP_SERVE_PARAMS[arch], f"world_serve_tp {arch}: "
                  f"{total} parameters, expected {TP_SERVE_PARAMS[arch]}")
        out = serve(run, device=dev, group=group, model_group=model_group,
                    prompt_len=prompt, new_tokens=new, params=params,
                    log=lambda msg: print(msg, file=sys.stderr))
        check(tuple(out["logits"].shape) == (SERVE_BATCH, v_pad),
              f"world_serve_tp {arch}: logits {tuple(out['logits'].shape)}")
        check(tp_cache_shapes(cfg, out["cache"], world),
              f"world_serve_tp {arch}: a rank's cache is not its share of "
              "one rank's")
        tokens = torch.cat([out["prompt"], out["tokens"]], 1)
        stubs = {key: val for key, val in out["batch"].items()
                 if key != "tokens"}
        with torch.inference_mode():
            x = tfm.hidden(params, {"tokens": tokens, **stubs}, cfg,
                           pal=pal)
            full = tfm.gather_vocab(lm_head_fwd(params["embed"],
                                                x[:, [prompt - 1, -1]], cfg,
                                                pal), pal).float()
            del x
        # the real vocabulary's logits: a padded entry's is -1e30 in both
        v = cfg.vocab_size
        full = full[..., :v]
        scale = float(full.abs().max())
        gaps = (full[:, None] - full[None]).abs().amax(-1).amin(-1)
        row_gap = float(gaps[~torch.eye(SERVE_BATCH, dtype=torch.bool,
                                        device=gaps.device)].min()) / scale
        e_pre = float((out["prefill_logits"][:, :v]
                       - full[:, 0]).abs().max()) / scale
        e_dec = float((out["logits"][:, :v] - full[:, 1]).abs().max()) / scale
        del full, gaps
        check(e_pre < SERVE_RTOL and e_dec < SERVE_RTOL,
              f"world_serve_tp {arch} {attn}: errors {e_pre}, {e_dec} over "
              f"{SERVE_RTOL} of the tensor-parallel full forward")
        check(row_gap > SERVE_RTOL, f"world_serve_tp {arch}: two rows' "
              f"logits within {row_gap} of each other")
        windows = profile = None
        if cuda:
            dec = build_decode_step(run, dev, group=group,
                                    model_group=model_group)
            windows = decode_windows(dev, run, params, out["cache"],
                                     out["tokens"], dec)
            profile = decode_profile(dev, run, params, out["cache"],
                                     out["tokens"][:, -1:], "float32", dec)
        # the step's bytes a card: its weights once (fp32, every expert's),
        # B rows of its token table in place of the table, its whole cache
        # (every slot is valid at the last step)
        tok = params["embed"]["tok"]
        cache_bytes = sum(leaf.nbytes for leaf in tree_leaves(
            out["cache"]["blocks"]) + tree_leaves(out["cache"].get(
                "prefix", [])) + tree_leaves(out["cache"].get("cross", {})))
        step_bytes = (n_local - tok.numel()) * 4 + SERVE_BATCH * \
            cfg.d_model * 4 + cache_bytes
        del out["cache"]
        peaks = world_peaks(dev, cuda)
        if rank == 0:
            ms = None if windows is None else statistics.median(windows)
            emit("world_serve_tp", arch=cfg.name, attn=attn,
                 n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
                 stub=cfg.frontend, dtype=cfg.dtype, tp=world,
                 batch=SERVE_BATCH, prompt=prompt, new_tokens=new,
                 params=total, params_by_rank=counts,
                 weights_bytes_a_card=n_local * 4, init_s=init_s,
                 vocab_padded=v_pad, cache_bytes_a_card=cache_bytes,
                 prefill_ms=out["prefill_s"] * 1e3,
                 launcher_decode_ms_per_step=out["decode_s"] / new * 1e3,
                 decode_ms_per_step=ms, decode_ms_windows=windows,
                 decode_ms_spread=None if windows is None
                 else [min(windows), max(windows)],
                 decode_bound_bytes_a_card=step_bytes,
                 decode_bound_ms=bound_ms(step_bytes, 0)[0],
                 prefill_rel_err=e_pre, decode_rel_err=e_dec,
                 row_gap=row_gap, max_memory_allocated_by_rank=peaks,
                 decode_profile=profile,
                 first_sequence=out["tokens"][0].tolist())
        del out
        dist.barrier()
    del params
    if cuda:
        torch.cuda.empty_cache()


def world_mamba_layer(dev, world: int, rank: int) -> None:
    """One Mamba layer at Jamba's width split by channel over a model group
    of all the cards (``models.mamba`` under a ``Parallel``: x_proj's and
    out_proj's partial products summed over the group), in fp32, batch
    MAMBA_BATCH, TP_MAMBA_SEQ positions (the reduced config at 64
    positions over gloo): forward ms and forward plus backward ms on every
    rank (medians of MAMBA_REPS CUDA-event timings), each rank's peak,
    every gradient finite; then on rank 0 the same layer whole on one card
    (the other ranks waiting): its output against the group's within
    TP_MAMBA_RTOL of max |y|, and its forward and forward plus backward
    ms beside the group's, in the same run."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config, mamba_dims, \
        reduced_config
    from repro_torch.convert import split_params
    from repro_torch.launch.mesh import axis_groups
    from repro_torch.models import mamba
    from repro_torch.models.parallel import Parallel
    cuda = dev.type == "cuda"
    cfg = dataclasses.replace(get_config(MAMBA_ARCH) if cuda else
                              reduced_config(get_config(MAMBA_ARCH)),
                              dtype="float32")
    seq = TP_MAMBA_SEQ if cuda else 64
    group, model_group = axis_groups(1, world)
    pal = Parallel(group=group, model_group=model_group)
    gen = torch.Generator(device=dev).manual_seed(0)
    whole = mamba.init_mamba(gen, cfg, device=dev)
    x = torch.randn((MAMBA_BATCH, seq, cfg.d_model), generator=gen,
                    device=dev)
    params = {key: val.contiguous() for key, val in split_params(
        {"mamba": whole}, world, rank)["mamba"].items()}
    leaves = [params[key].requires_grad_(True) for key in sorted(params)]

    def timed(p, fn_pal):
        def forward():
            with torch.no_grad():
                return mamba.mamba_fwd(p, x, cfg, pal=fn_pal)

        def train_step():
            y = mamba.mamba_fwd(p, x, cfg, pal=fn_pal)
            # each rank seeds its share: the psum's transpose sums them
            return torch.autograd.grad((y.float() ** 2).mean() / world,
                                       [p[key] for key in sorted(p)])
        return forward, train_step
    forward, train_step = timed(params, pal)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    grads = train_step()
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    del grads
    y = forward()
    ms = ((cuda_ms(forward, MAMBA_REPS), cuda_ms(train_step, MAMBA_REPS))
          if cuda else (None, None))
    peaks = world_peaks(dev, cuda)
    del leaves
    res = None
    if rank == 0:
        one_fwd, one_step = timed({key: val.requires_grad_(True)
                                   for key, val in whole.items()}, None)
        want = one_fwd()
        rel = float((y - want).abs().max() / want.abs().max())
        del want
        one_ms = ((cuda_ms(one_fwd, MAMBA_REPS),
                   cuda_ms(one_step, MAMBA_REPS)) if cuda else (None, None))
        res = {"one_card_rel_err": rel, "one_card_fwd_ms": one_ms[0],
               "one_card_fwd_bwd_ms": one_ms[1]}
    del y, whole, params, x
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    every = [None] * world
    dist.all_gather_object(every, finite)
    if rank == 0:
        check(all(every), f"world_mamba_layer: a gradient is not finite on "
              f"some rank ({every})")
        check(res["one_card_rel_err"] < TP_MAMBA_RTOL,
              f"world_mamba_layer: {res['one_card_rel_err']} from one card's "
              f"output, over {TP_MAMBA_RTOL}")
        emit("world_mamba_layer", arch=MAMBA_ARCH, d_model=cfg.d_model,
             d_inner=mamba_dims(cfg)[0],
             d_inner_a_card=mamba.local_dims(cfg, pal)[0],
             d_state=cfg.ssm.d_state, batch=MAMBA_BATCH, seq=seq, tp=world,
             fwd_ms=ms[0], fwd_bwd_ms=ms[1],
             max_memory_allocated_by_rank=peaks, grads_finite=True,
             rtol=TP_MAMBA_RTOL, **res)
    dist.barrier()


def world_ring_layer(dev, world: int, rank: int) -> None:
    """Ring attention against one card, one layer at a time: for each of
    RING_LAYER_ARCHS one attention layer at full width in fp32 (StableLM's
    GQA; DeepSeek-V2-Lite's MLA, the compressed ckv and krope passed round
    the ring and expanded at every hop), its weights model rank 0's on
    every card (so the ring is the whole sequence's attention), batch 1,
    RING_SEQ positions, each card its block of RING_SEQ / world. The
    ring's forward and its backward (the input's and the weights'
    gradients) on every rank; the output and the input gradient gathered
    over the group against the same layer on one card (rank 0, the others
    waiting) within RING_LAYER_RTOL of their largest |entry|; ms of the
    ring's forward and forward plus backward (medians of TIMING_REPS
    CUDA-event timings) beside one card's, in the same run."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.launch.mesh import axis_groups
    from repro_torch.models import attention as attn
    from repro_torch.models.parallel import Parallel, all_gather_model
    cuda = dev.type == "cuda"
    seq = RING_SEQ if cuda else 64
    sl = seq // world
    group, model_group = axis_groups(1, world)
    pal = Parallel(group=group, model_group=model_group, seq_parallel=True,
                   attn_dist="ring")
    for arch in RING_LAYER_ARCHS:
        cfg = dataclasses.replace(get_config(arch) if cuda else
                                  reduced_config(get_config(arch)),
                                  dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(rank)
        p = attn.init_attention(gen, cfg, device=dev)
        x = torch.randn((1, seq, cfg.d_model), generator=gen, device=dev)
        ct = torch.randn((1, seq, cfg.d_model), generator=gen, device=dev)
        for t in list(p.values()) + [x, ct]:
            dist.broadcast(t, 0)                 # model rank 0's
        block = slice(rank * sl, (rank + 1) * sl)
        leaves = [p[key].requires_grad_(True) for key in sorted(p)]

        def ring(with_grad: bool, xs=x[:, block].contiguous()):
            if not with_grad:
                with torch.no_grad():
                    return attn.ring_fwd(p, xs, cfg, pal)
            xs = xs.clone().requires_grad_(True)
            y = attn.ring_fwd(p, xs, cfg, pal)
            return y, torch.autograd.grad(y, [xs] + leaves, ct[:, block])
        y, grads = ring(True)
        with torch.no_grad():
            y_all = all_gather_model(y.detach(), pal, 1)
            gx_all = all_gather_model(grads[0], pal, 1)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        del y, grads
        ms = ((cuda_ms(lambda: ring(False)), cuda_ms(lambda: ring(True)))
              if cuda else (None, None))
        peaks = world_peaks(dev, cuda)
        res = None
        if rank == 0:
            def one(with_grad: bool):
                if not with_grad:
                    with torch.no_grad():
                        return attn.attn_fwd_full(p, x, cfg)
                xs = x.clone().requires_grad_(True)
                y1 = attn.attn_fwd_full(p, xs, cfg)
                return y1, torch.autograd.grad(y1, [xs] + leaves, ct)
            y1, g1 = one(True)
            y1 = y1.detach()
            res = {"out_rel_err": float((y_all - y1).abs().max()
                                        / y1.abs().max()),
                   "grad_rel_err": float((gx_all - g1[0]).abs().max()
                                         / g1[0].abs().max())}
            del y1, g1
            res["one_card_fwd_ms"], res["one_card_fwd_bwd_ms"] = (
                (cuda_ms(lambda: one(False)), cuda_ms(lambda: one(True)))
                if cuda else (None, None))
        del y_all, gx_all, p, leaves, x, ct
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
        every = [None] * world
        dist.all_gather_object(every, finite)
        if rank == 0:
            check(all(every), f"world_ring_layer {arch}: a gradient is not "
                  f"finite on some rank ({every})")
            check(max(res["out_rel_err"], res["grad_rel_err"])
                  < RING_LAYER_RTOL, f"world_ring_layer {arch}: {res} from "
                  f"one card's, over {RING_LAYER_RTOL}")
            emit("world_ring_layer", arch=cfg.name, attn=cfg.attn_kind,
                 d_model=cfg.d_model, heads=cfg.n_heads, batch=1, seq=seq,
                 seq_a_card=sl, tp=world, fwd_ms=ms[0], fwd_bwd_ms=ms[1],
                 max_memory_allocated_by_rank=peaks, grads_finite=True,
                 rtol=RING_LAYER_RTOL, **res)
        dist.barrier()


def tp_trainer(dev, world: int, rank: int) -> dict:
    """The trainer of world_ckpt_tp and world_apply_tp, run once a process
    by the first of them: the launcher's train() of StableLM-3B at full
    width and CKPT_LAYERS layers (the reduced config over gloo) on (1,
    world), REGTOP-k fused, TRAIN_STEPS steps, a checkpoint at the end
    and a delta of the joined parameters after every step (k in
    CKPT_LAYERS' note) into a spool with its snapshots. Returns {"root",
    "spool", "ckpt", "run", "model", "k", "group", "model_group",
    "launches", "train_s", "train_peak" (rank 0's device peak over
    train()), "out" (train()'s result; its "state" popped by the first
    caller that takes it), "joined" (the trained parameters joined over
    the group in host memory on rank 0, None on the others)}; B1 and B2
    launched once a step on every rank. :func:`drop_tp_trainer` removes
    its files."""
    if _TP_TRAINER:
        return _TP_TRAINER
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import (OptimizerConfig, RunConfig, SHAPES,
                                          SparsifierConfig)
    from repro_torch.core import sparsify
    from repro_torch.core.flatten import TreeFlattener
    from repro_torch.launch.mesh import axis_groups
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.train.step import joined_params, train_parallel
    cuda = dev.type == "cuda"
    model = tp_model("stablelm-3b", CKPT_LAYERS, cuda)
    seq, sparsity = (TRAIN_SEQ, SPARSITY) if cuda else (16, 0.01)
    group, model_group = axis_groups(1, world)
    run = RunConfig(
        model=model, shape=SHAPES["train_4k"],
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=sparsity, mu=MU,
                                    **FUSED),
        optimizer=OptimizerConfig(kind="adam", lr=1e-3), seed=0,
        steps=TRAIN_STEPS, log_every=1)
    local = init_params(model, torch.Generator(), "meta",
                        train_parallel(group, model_group))
    k = TRAIN_STEPS * world * sparsify.resolve_k(
        run.sparsifier, TreeFlattener(local).total)
    root = [tempfile.mkdtemp(prefix="chip_smoke_ckpt_tp_") if rank == 0
            else None]
    dist.broadcast_object_list(root, 0)
    root = root[0]
    spool, ckpt = os.path.join(root, "spool"), os.path.join(root, "ckpt")
    run = dataclasses.replace(run, checkpoint_dir=ckpt)
    _TP_TRAINER.update(root=root, spool=spool, ckpt=ckpt, run=run,
                       model=model, k=k, group=group, model_group=model_group)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    out = train(run, device=dev, group=group, model_group=model_group,
                batch=TRAIN_BATCH, seq=seq, fixed_batch=True,
                log=lambda msg: print(msg, file=sys.stderr),
                publish_deltas=spool, delta_k=k)
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    expect = train_expect(("sweep1", "sweep2")) if cuda else {}
    for name, count in launches.items():
        check(count == expect.get(name, 0), f"tp_trainer rank {rank}: "
              f"{name} launched {count} times in {TRAIN_STEPS} steps, "
              f"expected {expect.get(name, 0)}")
    _TP_TRAINER.update(
        out=out, launches=launches, train_s=train_s,
        train_peak=torch.cuda.max_memory_allocated(dev) if cuda else None,
        joined=joined_params(out["state"].params, model_group))
    return _TP_TRAINER


_TP_TRAINER = {}


def drop_tp_trainer(rank: int) -> None:
    """Forget :func:`tp_trainer`'s run and remove its files (rank 0)."""
    import shutil
    if _TP_TRAINER and rank == 0:
        shutil.rmtree(_TP_TRAINER["root"], ignore_errors=True)
    _TP_TRAINER.clear()


def world_ckpt_tp(dev, world: int, rank: int) -> None:
    """Checkpoints and the delta broadcast over a model group, on
    :func:`tp_trainer`'s run: the checkpoint (the parameters joined over
    the group, the states as (DP, TP, ...), every rank's copy of the
    replicated leaves beside them) restored on every rank equals its live
    state bit for bit; on rank 0 a replica from the version-0 snapshot
    takes every delta of the spool and equals the parameters joined over
    the group bit for bit, and so does the final snapshot. Then every
    rank saves and joins the trained state again with the peak memory
    counter reset: the device memory that takes beyond the live state
    stays within a gather's chunks (CKPT_SLACK_BYTES' note). The
    checkpoint's and a delta's bytes, the saves' and the restore's
    seconds, rank 0's peak over train() and the second save's extra
    bytes."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig, SHAPES, SparsifierConfig
    from repro_torch.serve import delta as dl
    from repro_torch.serve.step import delta_applier_from_snapshot
    from repro_torch.train.step import (GATHER_CHUNK, joined_params,
                                        restore_train_state, save_train_state)
    cuda = dev.type == "cuda"
    tr = tp_trainer(dev, world, rank)
    state = tr["out"].pop("state", None)
    check(state is not None, "world_ckpt_tp: the trainer's state was taken")
    group, model_group = tr["group"], tr["model_group"]
    model, k, run = tr["model"], tr["k"], tr["run"]
    spool, ckpt, root = tr["spool"], tr["ckpt"], tr["root"]
    out, launches = tr["out"], tr["launches"]
    try:
        mem = {"train_peak": tr["train_peak"]}
        if cuda:
            mem["live"] = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        save_train_state(os.path.join(root, "again"), TRAIN_STEPS, state,
                         group, model_group=model_group)
        again = joined_params(state.params, model_group)
        save_s = time.perf_counter() - t0
        del again
        if cuda:
            mem["save_extra"] = torch.cuda.max_memory_allocated(dev) \
                - mem["live"]
            bound = world * GATHER_CHUNK * 4 + CKPT_SLACK_BYTES
            check(mem["save_extra"] <= bound,
                  f"world_ckpt_tp rank {rank}: a save and a join took "
                  f"{mem['save_extra']} B beyond the live state, more "
                  f"than {bound}")
        t0 = time.perf_counter()
        back = restore_train_state(ckpt, TRAIN_STEPS, run, dev, group,
                                   model_group)
        restore_s = time.perf_counter() - t0
        same = all(trees_equal(getattr(back, name), getattr(state, name))
                   for name in ("params", "opt", "ef"))
        del back
        every = [None] * world
        dist.all_gather_object(every, same)
        joined = tr["joined"]
        del state
        if rank == 0:
            pub = out["publisher"]
            check(all(every), f"world_ckpt_tp: the restored state differs "
                  f"from the live one on some rank ({every})")
            check(pub.version == TRAIN_STEPS and pub.k == k,
                  f"world_ckpt_tp: publisher v{pub.version}, k {pub.k}")
            snaps = os.path.join(spool, "snapshots")
            srun = RunConfig(model=model, shape=SHAPES["train_4k"],
                             sparsifier=SparsifierConfig(kind="none"))
            applier, _ = delta_applier_from_snapshot(srun, snaps, dev,
                                                     step=0)
            payloads = dl.SpoolChannel(spool).recv()
            for pay in payloads:
                check(applier.offer(pay.to(dev)) == "applied",
                      f"world_ckpt_tp: v{pay.version} not applied")
            check(applier.version == TRAIN_STEPS
                  and trees_equal(applier.params, joined),
                  "world_ckpt_tp: the replica from the version-0 snapshot "
                  "and the deltas differs from the joined parameters")
            final, version = dl.read_snapshot(snaps, joined, device=dev)
            check(version == TRAIN_STEPS and trees_equal(final, joined),
                  "world_ckpt_tp: the final snapshot differs from the "
                  "joined parameters")
            del final, applier
            ckpt_bytes = {name: os.path.getsize(os.path.join(ckpt, name))
                          for name in sorted(os.listdir(ckpt))}
            emit("world_ckpt_tp", model=model.name, n_layers=model.n_layers,
                 data=1, tp=world, steps=TRAIN_STEPS, launches_a_rank=launches,
                 j_joined=pub.j,
                 delta_k=k, deltas=len(payloads),
                 delta_wire_bytes=dl.delta_wire_bytes(k),
                 losses=[rec["loss"] for rec in out["history"]],
                 publish_ms=[rec["publish_ms"] for rec in out["history"]],
                 train_s=tr["train_s"], save_and_join_s=save_s,
                 restore_s=restore_s,
                 rank0_peak_bytes=mem.get("train_peak"),
                 rank0_live_bytes=mem.get("live"),
                 rank0_save_extra_bytes=mem.get("save_extra"),
                 checkpoint_bytes=ckpt_bytes,
                 restored_bitwise_by_rank=every,
                 replica_equals_joined=True, final_snapshot_equal=True)
        dist.barrier()
    finally:
        if cuda:
            torch.cuda.empty_cache()


# world_apply_tp: the trainer's spool served by two replicas from its
# version-0 snapshot through serve() (batch SERVE_BATCH, prompt
# SERVE_PROMPT, SERVE_NEW steps), each with the group applier and the
# channel read on rank 0 through APPLY_SCHEDULE: over the model group
# (1, 4) and data-parallel (4, 1)
APPLY_SCHEDULE = "loss:0.4,seed=2"
APPLY_MESHES = ((1, 4), (4, 1))


def world_apply_tp(dev, world: int, rank: int) -> None:
    """The delta applier over a group of ranks on :func:`tp_trainer`'s
    spool: for each of APPLY_MESHES a replica from the version-0 snapshot
    through serve() with ``delta_applier_from_snapshot(group=...,
    model_group=...)``, ``GroupChannel`` over rank 0's
    ``FaultyChannel(SpoolChannel, APPLY_SCHEDULE)``. After the final
    flush and resync the replica's tree joined over the model group
    equals the trained parameters joined bit for bit, every rank of the
    data-parallel replica holds the same bits, the pinned tree is
    unchanged, and the verdicts and counters are equal on every rank. Per
    rank the intake ms (verify, the verdict's all-reduce, the scatter)
    and the apply ms (the scatter) of every offered payload, beside one
    rank's apply ms of the first payload on the joined tree (rank 0's
    card), and the decode ms a step with the applies."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig, SparsifierConfig
    from repro_torch.core import faults
    from repro_torch.core.flatten import tree_items
    from repro_torch.launch.mesh import axis_groups
    from repro_torch.launch.serve import serve, serve_shape
    from repro_torch.serve import delta as dl
    from repro_torch.serve.step import delta_applier_from_snapshot
    from repro_torch.train.step import joined_params
    cuda = dev.type == "cuda"
    tr = tp_trainer(dev, world, rank)
    tr["out"].pop("state", None)
    if cuda:
        torch.cuda.empty_cache()
    snaps = os.path.join(tr["spool"], "snapshots")
    srun = RunConfig(model=tr["model"], shape=serve_shape(
        SERVE_BATCH, SERVE_PROMPT, SERVE_NEW),
        sparsifier=SparsifierConfig(kind="none"))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn, into):
        def call(*args):
            sync()
            t0 = time.perf_counter()
            res = fn(*args)
            sync()
            into.append((time.perf_counter() - t0) * 1e3)
            return res
        return call
    for data, model in APPLY_MESHES:
        group, model_group = axis_groups(data, model)
        applier, pinned = delta_applier_from_snapshot(
            srun, snaps, dev, step=0, group=group, model_group=model_group)
        frozen = [leaf.clone() for _, leaf in tree_items(pinned)]
        intake_ms, apply_ms = [], []
        applier.offer = timed(applier.offer, intake_ms)
        applier._apply_verified = timed(applier._apply_verified, apply_ms)
        inner = None
        if rank == 0:
            inner = dl.FaultyChannel(dl.SpoolChannel(tr["spool"]),
                                     faults.parse_channel_schedule(
                                         APPLY_SCHEDULE))
        res = serve(srun, device=dev, prompt_len=SERVE_PROMPT,
                    new_tokens=SERVE_NEW, group=group,
                    model_group=model_group, applier=applier,
                    channel=dl.GroupChannel(inner, group, model_group, dev),
                    snap_dir=snaps, log=lambda msg: None)
        pinned_same = all(torch.equal(a, b) for a, (_, b)
                          in zip(frozen, tree_items(pinned)))
        del frozen, pinned
        same = True
        if model == 1:
            for _, leaf in tree_items(applier.params):
                ref = leaf.clone()
                dist.broadcast(ref, src=0)
                same = same and torch.equal(ref, leaf)
            del ref
        joined = joined_params(applier.params, model_group)
        every = [None] * world
        dist.all_gather_object(every, dict(
            metrics=res["delta"], pinned_same=pinned_same, same=same,
            intake_ms=intake_ms, apply_ms=apply_ms))
        if rank == 0:
            check(all(e["metrics"] == every[0]["metrics"] for e in every),
                  f"world_apply_tp {data}x{model}: the counters differ "
                  f"across the ranks ({[e['metrics'] for e in every]})")
            check(all(e["pinned_same"] for e in every),
                  f"world_apply_tp {data}x{model}: the pinned tree moved")
            check(all(e["same"] for e in every),
                  f"world_apply_tp {data}x{model}: the ranks' trees differ")
            check(res["delta"]["param_version"] == TRAIN_STEPS
                  and trees_equal(joined, tr["joined"]),
                  f"world_apply_tp {data}x{model}: the replica "
                  f"({res['delta']}) differs from the joined parameters")
            payloads = dl.SpoolChannel(tr["spool"]).recv()
            one, _ = delta_applier_from_snapshot(srun, snaps, dev, step=0)
            one_ms = []
            timed(one._apply_verified, one_ms)(payloads[0].to(dev))
            del one
            emit("world_apply_tp", model=tr["model"].name,
                 n_layers=tr["model"].n_layers, data=data, tp=model,
                 trainer_launches_a_rank=tr["launches"],
                 trainer_data=1, trainer_tp=world, j_joined=applier.j,
                 delta_k=tr["k"], schedule=APPLY_SCHEDULE,
                 deltas_published=TRAIN_STEPS, counters=res["delta"],
                 pinned_version=res["pinned_version"],
                 intake_ms_by_rank=[e["intake_ms"] for e in every],
                 apply_ms_by_rank=[e["apply_ms"] for e in every],
                 one_rank_apply_ms=one_ms[0],
                 apply_s=res["apply_s"],
                 decode_ms_per_step=res["decode_s"] / SERVE_NEW * 1e3,
                 prefill_s=res["prefill_s"],
                 equals_joined=True, pinned_unchanged=True,
                 counters_equal_across_ranks=True,
                 trees_bitwise_across_ranks=model == 1 or None)
        del applier, joined, res
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()


# phase roofline: the dry run's tracer and the memory model on the main
# cell, the device copy's and NCCL's rates beside the data sheet's
ROOFLINE_COPY_BYTES = 1 << 30
CONTRACT_SLACK = 1.05        # a kernel's bytes bound over its time at most
AG_BIG_BYTES = 256 * 10 ** 6   # world_allgather's gathered output
AG_REPS = 50
# phase mla_encoder_layer: one bidirectional MLA layer at Whisper-small's
# width and heads with DeepSeek-V2-Lite's kv_lora_rank and rope_head_dim,
# over Whisper's 1500 frames, both forms in fp32 against fp64
MLA_ENC_BATCH, MLA_ENC_SEQ = 8, 1500
MLA_ENC_RTOL = 1e-5


def phase_train_auto_buckets(dev) -> dict:
    """The main path with ``num_buckets=0`` through train(): the count
    the step resolves (``train.step.auto_num_buckets_for_run``), B1 and
    B2 launched once a resolved bucket a step, and after TRAIN_STEPS
    steps the parameters bit for bit those of the same run with the count
    written out."""
    import torch
    from repro_torch.configs.base import (RunConfig, SHAPES,
                                          SparsifierConfig, get_config)
    from repro_torch.core.flatten import TreeFlattener
    from repro_torch.roofline.analysis import COLLECTIVE_LATENCY_S
    from repro_torch.train.step import auto_num_buckets_for_run
    arch, depth, _ = TRAIN_MODEL
    model = dataclasses.replace(get_config(arch), n_layers=depth)
    fields = dict(kind="regtopk", **FUSED)
    nb, j, dp = auto_num_buckets_for_run(RunConfig(
        model=model, shape=SHAPES["train_4k"], sparsifier=SparsifierConfig(
            sparsity=SPARSITY, mu=MU, num_buckets=0, **fields)))
    expect = train_expect({"sweep1": nb, "sweep2": nb})
    flats, launches = [], {}
    for name, buckets in (("train_auto_buckets", 0),
                          ("train_auto_buckets_written", nb)):
        launches[name], _, state, _, _ = phase_train(
            dev, dict(fields, num_buckets=buckets), expect, name,
            model_cut=TRAIN_MODEL)
        flats.append(TreeFlattener(state.params).flatten(
            state.params).detach())
        del state
        torch.cuda.empty_cache()
    check(bits_equal(*flats), "train_auto_buckets: the parameters differ "
          f"from the run with num_buckets={nb} written out")
    emit("train_auto_buckets_equal", num_buckets=nb, j_local=j, dp=dp,
         collective_latency_s=COLLECTIVE_LATENCY_S, launches=launches,
         params_bitwise_equal=True)
    return launches


def phase_roofline(dev, kernel_res: dict, step_ms: list, peak: int) -> None:
    """The cost models on the card: the data sheet's rates (``HW_H100``)
    beside a 1 GiB device copy's measured rate; the main cell (the
    ``train`` phase's model and sparsifier at batch 8 x 128, one card)
    traced by the dry run's tracer on the meta device, its three terms
    and lower bound beside the same run's measured steps 1-4; the memory
    model's peak beside the measured peak and its capacity beside the
    card's; and B1's and B2's byte contracts (``bytes_moved``) over the
    memory rate at most CONTRACT_SLACK times their measured times."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis, memory_model
    hw = analysis.HW_H100
    src = torch.ones(ROOFLINE_COPY_BYTES // 4, device=dev)
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    copy_rate = 2 * ROOFLINE_COPY_BYTES / (copy_ms * 1e-3)
    arch, depth, main_j = TRAIN_MODEL
    shape = ShapeConfig("main", TRAIN_SEQ, TRAIN_BATCH, "train")
    run = dryrun.run_config(arch, shape, n_layers=depth, sparsity=SPARSITY,
                            comm="sparse", pipeline="fused")
    t0 = time.perf_counter()
    traced = dryrun.trace_train(run)
    trace_s = time.perf_counter() - t0
    wire = sum(traced["wire"].values())
    rec = {"mesh": {"data": 1, "model": 1}, "kind": "train",
           "shape": shape.name, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len,
           "active_params": run.model.param_count(),
           "flops": traced["flops"], "bytes_accessed": traced["bytes"],
           "collective_bytes": {"total": wire},
           "hlo_flops": traced["flops"], "hlo_bytes": traced["bytes"],
           "hlo_collective_wire_bytes": wire}
    terms = analysis.roofline_terms(rec)
    measured = statistics.median(step_ms[1:])
    mb = memory_model.per_device_memory(run, tp=1, dp=1)
    total = torch.cuda.get_device_properties(dev).total_memory
    contracts = {}
    for name in ("sweep1", "sweep2"):
        bound = kernel_res[f"{name}_bytes"] / hw.hbm_bw * 1e3
        contracts[name] = {"bytes": kernel_res[f"{name}_bytes"],
                           "bound_ms": bound, "ms": kernel_res[f"{name}_ms"],
                           "share": bound / kernel_res[f"{name}_ms"]}
    emit("roofline", hw=dataclasses.asdict(hw),
         collective_latency_s=analysis.COLLECTIVE_LATENCY_S,
         copy_bytes=ROOFLINE_COPY_BYTES, copy_ms=copy_ms,
         copy_rate_bytes_per_s=copy_rate,
         copy_share_of_datasheet=copy_rate / hw.hbm_bw,
         cell={"model": run.model.name, "n_layers": depth, "j": main_j,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ},
         trace_s=trace_s, traced_flops=traced["flops"],
         traced_bytes=traced["bytes"], traced_wire=traced["wire"],
         sync_contract_bytes=traced["sync"]["bytes"],
         sync_kernels=traced["sync"]["kernels"],
         compute_s=terms["compute_s"], memory_s=terms["memory_s"],
         collective_s=terms["collective_s"], dominant=terms["dominant"],
         step_time_lb_s=terms["step_time_lb_s"],
         model_flops=terms["model_flops"],
         measured_steps_ms=step_ms[1:], measured_median_ms=measured,
         lb_share_of_measured=terms["step_time_lb_s"] * 1e3 / measured,
         memory_model_peak=mb.peak, memory_model_total=mb.total,
         measured_peak=peak, memory_model_over_measured=mb.peak / peak,
         card_total_memory=total, contracts=contracts)
    check(total == memory_model.H100_TOTAL_MEMORY,
          f"the card holds {total} bytes, the memory model's constant "
          f"{memory_model.H100_TOTAL_MEMORY}")
    for name, c in contracts.items():
        check(c["bound_ms"] <= CONTRACT_SLACK * c["ms"],
              f"roofline: {name}'s contract ({c['bytes']} B, "
              f"{c['bound_ms']:.3f} ms) exceeds {CONTRACT_SLACK} x its "
              f"measured {c['ms']:.3f} ms")


def mla_plain_fp64(p: dict, x, cfg):
    """Bidirectional MLA of x in fp64, one softmax over every key: the
    projections (the rmsnorm of ckv, the interleaved rotation of the
    queries' and the shared key's RoPE dims by the model's own fp32
    angles, as the reference computes them: at position 1500 their
    rounding alone moves the output by 2e-5 of its scale), each head's k
    and v expanded from ckv, the scores, their softmax, the value product
    and wo."""
    import torch
    from repro_torch.models.attention import rope_angles
    d = torch.float64
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    rhd, lora = cfg.rope_head_dim, cfg.kv_lora_rank
    p = {key: val.to(d) for key, val in p.items()}
    x = x.to(d)
    ang = rope_angles(torch.arange(s, device=x.device), rhd,
                      cfg.rope_theta).to(d)
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rope(t):                          # (..., S, [H,] rhd)
        c, n = (cos, sin) if t.ndim == 3 else (cos[:, None], sin[:, None])
        t1, t2 = t[..., 0::2], t[..., 1::2]
        return torch.stack([t1 * c - t2 * n, t1 * n + t2 * c],
                           -1).reshape(t.shape)
    dkv = x @ p["dkv"]
    c = dkv[..., :lora]
    ckv = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-5) * \
        p["kv_norm"]
    krope = rope(dkv[..., lora:])
    q = (x @ p["wq"]).reshape(b, s, h, hd + rhd)
    qn, qr = q[..., :hd], rope(q[..., hd:])
    kn = (ckv @ p["uk"]).reshape(b, s, h, hd)
    v = (ckv @ p["uv"]).reshape(b, s, h, -1)
    sc = (torch.einsum("bqhd,bshd->bhqs", qn, kn)
          + torch.einsum("bqhr,bsr->bhqs", qr, krope)) * hd ** -0.5
    o = torch.einsum("bhqs,bshv->bqhv", torch.softmax(sc, -1), v)
    return o.reshape(b, s, -1) @ p["wo"]


def phase_mla_encoder_layer(dev) -> None:
    """One bidirectional MLA layer (an MLA encoder's self-attention,
    ``attn_fwd_full(causal=False)``) at Whisper-small's width and heads
    with DeepSeek-V2-Lite's kv_lora_rank and rope_head_dim, over
    MLA_ENC_SEQ frames: the expanded and the absorbed form in fp32, each
    within MLA_ENC_RTOL of the largest entry of the fp64 one-softmax form
    (:func:`mla_plain_fp64`), and each one's ms."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as attn
    ds = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(get_config("whisper-small"), attn_kind="mla",
                              kv_lora_rank=ds.kv_lora_rank,
                              rope_head_dim=ds.rope_head_dim,
                              v_head_dim=0, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = attn.init_attention(gen, cfg, device=dev)
    x = torch.randn(MLA_ENC_BATCH, MLA_ENC_SEQ, cfg.d_model, generator=gen,
                    device=dev)
    with torch.no_grad():
        want = mla_plain_fp64(p, x, cfg)
        scale = float(want.abs().max())
        forms = {}
        for form, absorb in (("expanded", False), ("absorbed", True)):
            c = dataclasses.replace(cfg, mla_absorb=absorb)
            y = attn.attn_fwd_full(p, x, c, causal=False)
            err = float((y.double() - want).abs().max()) / scale
            check(math.isfinite(err) and err <= MLA_ENC_RTOL,
                  f"mla_encoder_layer {form}: {err:.3e} of the scale from "
                  "the fp64 form")
            forms[form] = {"rel_err_vs_fp64": err, "ms": cuda_ms(
                lambda: attn.attn_fwd_full(p, x, c, causal=False))}
            del y
    emit("mla_encoder_layer", d_model=cfg.d_model, n_heads=cfg.n_heads,
         head_dim=cfg.resolved_head_dim, kv_lora_rank=cfg.kv_lora_rank,
         rope_head_dim=cfg.rope_head_dim, batch=MLA_ENC_BATCH,
         seq=MLA_ENC_SEQ, rtol=MLA_ENC_RTOL, **forms)


def world_allgather(dev, world: int, rank: int) -> None:
    """NCCL's all-gather over the group: the median of AG_REPS CUDA-event
    timings of one MIN_CHUNK_BYTES (64 KiB gathered) all-gather, each
    after a barrier (the collective launch floor that
    ``roofline.analysis.COLLECTIVE_LATENCY_S`` holds), and of one
    AG_BIG_BYTES all-gather (its bus rate, out x (n - 1) / n over the
    time, beside NVLink's data-sheet rate), and of AG_REPS back to back.
    On the card only: over gloo it measures nothing."""
    import torch
    import torch.distributed as dist
    from repro_torch.roofline import analysis
    if dev.type != "cuda":
        return
    res = {}
    for name, out_bytes in (("small", analysis.MIN_CHUNK_BYTES),
                            ("big", AG_BIG_BYTES)):
        n = out_bytes // 4 // world
        x = torch.ones(n, device=dev)
        out = torch.empty(n * world, device=dev)
        for _ in range(5):
            dist.all_gather_into_tensor(out, x)
        times = []
        for _ in range(AG_REPS):
            dist.barrier()
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_gather_into_tensor(out, x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        dist.barrier()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(AG_REPS):
            dist.all_gather_into_tensor(out, x)
        end.record()
        end.synchronize()
        med = statistics.median(times)
        res[name] = {"gathered_bytes": n * world * 4, "median_ms": med,
                     "min_ms": min(times), "max_ms": max(times),
                     "back_to_back_ms": start.elapsed_time(end) / AG_REPS,
                     "bus_bytes_per_s": n * world * 4 * (world - 1) / world
                     / (med * 1e-3)}
        del x, out
    if rank == 0:
        emit("world_allgather", world=world, **res,
             latency_s=res["small"]["median_ms"] * 1e-3,
             collective_latency_s_in_code=analysis.COLLECTIVE_LATENCY_S,
             link_datasheet_bytes_per_s=analysis.HW_H100.link_bw)


# the tensor-parallel phases after the train cells of WORLD_TP, in order
TP_PHASES = {"world_serve_tp": world_serve_tp,
             "world_mamba_layer": world_mamba_layer,
             "world_ring_layer": world_ring_layer,
             "world_ckpt_tp": world_ckpt_tp,
             "world_apply_tp": world_apply_tp}


def phase_world(world: int, src: str, tp=None) -> None:
    """Start ``world`` rank processes of this script (one card each, NCCL
    over a localhost rendezvous), relay their output, and stop them all:
    when one fails, the others (blocked in a collective) are stopped at
    once (``tp``: the tensor-parallel phases alone, as
    :func:`world_rank` reads it). First print how the cards are linked (``nvidia-smi
    topo -m``, where the machine lets it run)."""
    import socket
    import tempfile
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True)
    emit("world_topology", returncode=topo.returncode,
         topo=(topo.stdout + topo.stderr).strip())
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    outs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--world", str(world),
         "--rank", str(r), "--port", str(port), "--src", src]
        + ([] if tp is None else ["--tp", *tp]),
        stdout=out, stderr=subprocess.STDOUT, text=True)
        for r, out in enumerate(outs)]
    deadline = time.perf_counter() + 1000
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.perf_counter() < deadline):
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        out.seek(0)
        print(out.read(), end="", flush=True)
        out.close()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"world rank {r} exited {p.returncode}")


def compression_shares(steps: dict, profiles: dict) -> dict:
    """Each train cell against the dense baseline of the same run. The
    compression share is the profiled step's compression stages (every
    stage but ``train/*``: the compressor, the sketch and the sync's own
    work) as device ms over the step's wall time. Beside it, on the host
    clock, the median of steps 1..4 (the first step builds and warms up)
    over the dense cell's, share = (cell - dense) / cell; ``resolved`` is
    false where that difference is within the dense cell's own spread
    over the same steps (max - min), which the host's noise can span."""
    dense = steps["train_dense"][1:]
    base, spread = statistics.median(dense), max(dense) - min(dense)
    out = {}
    for name, ms in steps.items():
        med = statistics.median(ms[1:])
        wall, stages = profiles[name]
        comp = sum(val.get("device_span_ms", 0.0)
                   for key, val in stages.items()
                   if not key.startswith("train/"))
        out[name] = {"compression_device_ms": comp,
                     "compression_device_share": comp / wall,
                     "profiled_wall_ms": wall, "step_ms": med,
                     "over_dense_ms": med - base,
                     "share": (med - base) / med,
                     "resolved": abs(med - base) > spread}
    return {"baseline": "train_dense", "dense_spread_ms": spread,
            "cells": out}


def train_expect(kernels, segments: int = 1) -> dict:
    """A train path's launches in TRAIN_STEPS steps: once a step for each
    kernel of a tuple, or {kernel: launches a step}, SEGS standing for
    the path's ``segments``."""
    per_step = kernels if isinstance(kernels, dict) else \
        dict.fromkeys(kernels, 1)
    return {name: (segments if n == SEGS else n) * TRAIN_STEPS
            for name, n in per_step.items()}


def path_segments(fields: dict, model_cut=TRAIN_MODEL) -> list:
    """The layer-aligned segments a train path's step cuts the gradient
    into: ``core.allocate.layer_segments`` over the model's leaves (drawn
    on the meta device) at the config's resolved segment count."""
    import torch
    from repro_torch.configs.base import SparsifierConfig, get_config
    from repro_torch.core import allocate
    from repro_torch.core.flatten import TreeFlattener
    from repro_torch.models import init_params
    arch, depth, main_j = model_cut
    model = dataclasses.replace(get_config(arch), n_layers=depth)
    flat = TreeFlattener(init_params(model, torch.Generator(),
                                     torch.device("meta")))
    check(flat.total == main_j, f"J={flat.total}")
    sp = SparsifierConfig(**fields)
    return allocate.layer_segments(
        flat.layer_bounds(), allocate.resolve_num_segments(sp, flat.total))


def path_expect(name: str) -> dict:
    """A train path's launches in TRAIN_STEPS steps (train_expect with
    its segment count)."""
    fields, kernels, _ = TRAIN_PATHS[name]
    segs = (len(path_segments(fields, TRAIN_MODELS.get(name, TRAIN_MODEL)))
            if name in SEGMENTED else 1)
    return train_expect(kernels, segs)


def kernel_row(name: str, res: dict, small: dict, launches: int,
               path: str, parity: str, library_ms=None, **extra) -> dict:
    bms, by = bound_ms(res[f"{name}_bytes"], res[f"{name}_ops"])
    source, replaces = KERNEL_META[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(res[f"{name}_err"], small[f"{name}_err"]),
            "ms": res[f"{name}_ms"], "plain_ms": res[f"{name}_plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "path": path, "parity": parity, **extra}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="append", choices=TRAIN_PATHS,
                    help="run only the device and build phases and this "
                    "train phase and its profile (repeatable; no kernels "
                    "line)")
    ap.add_argument("--serve", action="store_true",
                    help="run only the device and build phases and the "
                    "serve phase (no kernels line)")
    ap.add_argument("--delta", action="store_true",
                    help="run only the device and build phases and the "
                    "delta phase (no kernels line)")
    ap.add_argument("--mamba", action="store_true",
                    help="run only the device and build phases and the "
                    "mamba_layer phase (no kernels line)")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the port's source tree (default: this checkout's "
                    "src/), e.g. an unpacked older commit's, to compare "
                    "two versions in one run")
    ap.add_argument("--world", type=int, default=0,
                    help="run only the multi-card check: GradientSync over "
                    "NCCL on this many cards (one process each) against an "
                    "in-process round, then the launcher's train() and "
                    "serve() over the group; needs that many cards")
    ap.add_argument("--tp", nargs="*", metavar="NAME",
                    choices=["world_decode_cp", "world_allgather"]
                    + list(WORLD_TP) + list(TP_PHASES),
                    help="with --world 4: run only the tensor-parallel "
                    "phases, or only those named (of world_decode_cp, "
                    "world_allgather, "
                    + ", ".join(list(WORLD_TP) + list(TP_PHASES)) + ")")
    ap.add_argument("--cost", action="store_true",
                    help="run only the device, build and kernels phases, "
                    "the main train cell and the cost models' phases "
                    "(train_auto_buckets, roofline, mla_encoder_layer; "
                    "no kernels line)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.rank is not None:
        return world_rank(args.rank, args.world, args.port, tp=args.tp)
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    if args.world:
        check(torch.cuda.device_count() >= args.world,
              f"--world {args.world} needs {args.world} cards, found "
              f"{torch.cuda.device_count()}")
        phase_world(args.world, os.path.abspath(args.src), args.tp)
        return finish(smi, None)
    if args.cost:
        kres = phase_kernels(dev)
        _, _, state, step_ms, _ = phase_train(
            dev, TRAIN_PATHS["train"][0], path_expect("train"), "train")
        peak = torch.cuda.max_memory_allocated(dev)
        del state
        torch.cuda.empty_cache()
        phase_train_auto_buckets(dev)
        phase_roofline(dev, kres["big"], step_ms, peak)
        phase_mla_encoder_layer(dev)
        return finish(smi, None)
    if args.train or args.serve or args.delta or args.mamba:
        for name in args.train or ():
            fields, kernels, schedule = TRAIN_PATHS[name]
            _, run, state, *_ = phase_train(
                dev, fields, path_expect(name), name, schedule,
                TRAIN_MODELS.get(name, TRAIN_MODEL))
            if run.sparsifier.overlap == "backward":
                phase_overlap_equal(dev, run, state)
            phase_profile(dev, run, state, name.replace("train", "profile"))
            del state
            torch.cuda.empty_cache()
        if args.serve:
            phase_serve(dev)
        if args.mamba:
            phase_mamba_layer(dev)
        if args.delta:
            phase_delta(dev)
        return finish(smi, None)
    kres = phase_kernels(dev)
    segres = phase_kernels_segments(dev)
    sres = phase_kernels_sketch(dev)
    mres = phase_kernels_sketch_modes(dev)
    eres = phase_kernels_fused_ef(dev)
    hres = phase_kernels_topk_select(dev)
    comp_launches = phase_compress(dev)
    phase_sketch_sync(dev)
    elastic_launches = phase_sketch_elastic_sync(dev)
    ref_launches = phase_reference_sync(dev)
    phase_paper(dev)
    train, steps, profiles = {}, {}, {}
    for name, (fields, kernels, schedule) in TRAIN_PATHS.items():
        train[name], run, state, steps[name], _ = phase_train(
            dev, fields, path_expect(name), name, schedule,
            TRAIN_MODELS.get(name, TRAIN_MODEL))
        if name == "train":
            main_peak = torch.cuda.max_memory_allocated(dev)
        if run.sparsifier.overlap == "backward":
            phase_overlap_equal(dev, run, state)
        tables, *profiles[name] = phase_profile(
            dev, run, state, name.replace("train", "profile"))
        if fields["kind"] == "sketchtopk":
            check(tables == SKETCH_TABLE,
                  f"{name}: the sync keeps one start table of its shape")
        del state
        torch.cuda.empty_cache()
    phase_train_auto_buckets(dev)
    phase_roofline(dev, kres["big"], steps["train"], main_peak)
    phase_serve(dev)
    phase_mamba_layer(dev)
    phase_mla_encoder_layer(dev)
    delta = phase_delta(dev)
    # the other models' cells have no dense baseline of their own
    emit("compression_share", **compression_shares(
        {name: ms for name, ms in steps.items() if name not in TRAIN_MODELS},
        profiles))
    bitwise = "torch.equal on every output"
    atomics = ("a torch.equal; sketch torch.equal on dyadic inputs, within "
               "4*n_b*2^-24*sum|contrib| per bucket on Gaussian inputs")
    big, small = kres["big"], kres["small"]
    dgc_big, dgc_small = kres["dgc_big"], kres["dgc_small"]
    reference = "reference-launcher default train (reference pipeline)"
    ebig, hbig = eres["big"], hres["big"]
    histc_same = hbig["histogram_histc_differing_bins"] == 0
    def segmented(kernel):
        # the kernel's launches on each segmented path that runs it
        return {name: train[name][kernel] for name in SEGMENTED
                if train[name].get(kernel)}
    rows = [kernel_row("sweep1", big, small, train["train"]["sweep1"],
                       "regtopk train (fused)", bitwise,
                       other_models={name: train[name]["sweep1"]
                                     for name in TRAIN_MODELS},
                       delta_launches=delta["sweep1"],
                       segmented_launches=segmented("sweep1")),
            kernel_row("sweep2", big, small, train["train"]["sweep2"],
                       "regtopk train (fused)", bitwise,
                       other_models={name: train[name]["sweep2"]
                                     for name in TRAIN_MODELS},
                       delta_launches=delta["sweep2"],
                       segmented_launches=segmented("sweep2"),
                       segments={key: segres[key] for key in (
                           "segments", "timed_segment", "sweep2_segment_ms",
                           "sweep2_segment_plain_ms")}),
            kernel_row("sweep1_dgc", dgc_big, dgc_small,
                       train["train_dgc"]["sweep1_dgc"],
                       "dgc train (fused)", bitwise, mode="dgc"),
            kernel_row("sweep1_gated", kres["gated_big"],
                       kres["gated_small"],
                       train["train_elastic_dgc"]["sweep1_gated"],
                       "elastic dgc train (fused, bursty schedule)",
                       "gate 1: torch.equal to the ungated kernel; gate 0: "
                       "torch.equal to the plain version; both modes",
                       mode="dgc gated",
                       off_ms=kres["gated_big"]["sweep1_gated_off_ms"],
                       segmented_launches=segmented("sweep1_gated")),
            kernel_row("sweep1_bf16", kres["bf16_big"], kres["bf16_small"],
                       train["train_bucketed"]["sweep1_bf16"],
                       "bucketed regtopk train (fused, 8 buckets, bf16 "
                       "state and wire)", "torch.equal on every output to "
                       "the fp32 kernel on the upcast inputs and to the "
                       "plain version", mode="plain bf16 read",
                       shape=f"J/{BUCKETS} = {BUCKET_J} a launch"),
            kernel_row("sweep1_dgc_bf16", kres["bf16_big"],
                       kres["bf16_small"], comp_launches["sweep1_dgc_bf16"],
                       "phase compress: dgc fused, 8 buckets, bf16 state "
                       "(no train path)", "torch.equal on every output to "
                       "the fp32 kernel on the upcast inputs and to the "
                       "plain version", mode="dgc bf16 read",
                       shape=f"J/{BUCKETS} = {BUCKET_J} a launch"),
            kernel_row("sweep1_gated_bf16", kres["bf16_big"],
                       kres["bf16_small"],
                       comp_launches["sweep1_gated_bf16"],
                       "phase compress: regtopk fused, bf16 state, "
                       "participation (1, 0, 1) (no train path)",
                       "gate 1: torch.equal to the fp32 gated kernel on "
                       "the upcast inputs; gate 0: torch.equal to the "
                       "plain version; both modes", mode="dgc gated bf16 "
                       "read", shape=f"J/{BUCKETS} = {BUCKET_J} a launch",
                       off_ms=kres["bf16_big"]["sweep1_gated_bf16_off_ms"]),
            kernel_row("sweep1_sketch", sres["big"], sres["small"],
                       train["train_sketch"]["sweep1_sketch"],
                       "sketchtopk train (fused)", atomics, redesigned=True,
                       deterministic=sres["big"][
                           "sweep1_sketch_deterministic"]),
            kernel_row("sketch_encode", sres["big"], sres["small"],
                       train["train_sketch_reference"]["sketch_encode"],
                       "sketchtopk train (reference pipeline, launcher "
                       "defaults)", atomics, redesigned=True,
                       deterministic=sres["big"][
                           "sketch_encode_deterministic"]),
            kernel_row("sweep1_sketch_gated", mres["big"], mres["small"],
                       train["train_sketch_elastic"]["sweep1_sketch_gated"],
                       "elastic sketchtopk train (fused, bursty schedule)",
                       "a torch.equal to the plain version (gate 0 and 1) "
                       "and at gate 1 to the ungated kernel; sketch "
                       "torch.equal on dyadic inputs, within the atomics "
                       "bound on Gaussian ones",
                       off_ms=mres["big"]["sweep1_sketch_gated_off_ms"]),
            kernel_row("sweep1_sketch_bf16", mres["big"], mres["small"],
                       train["train_sketch_bucketed"]["sweep1_sketch_bf16"],
                       "bucketed sketchtopk train (fused, 8 buckets, bf16 "
                       "state and wire)", "a torch.equal to the plain "
                       "version and to the fp32 kernel on the widened "
                       "state; sketch as B3's"),
            kernel_row("sweep1_sketch_gated_bf16", mres["big"],
                       mres["small"],
                       elastic_launches["fused_bfloat16"][
                           "sweep1_sketch_gated_bf16"],
                       "phase sketch_elastic_sync: fused, bf16 state, 8 "
                       "chunks on the bf16 wire (no train path)",
                       "a torch.equal to the plain version (gate 0 and 1); "
                       "sketch as B3's"),
            kernel_row("scores", ebig, eres["small"],
                       train["train_reference"]["scores"],
                       reference, "equal bit patterns on every output",
                       segmented_launches=segmented("scores")),
            kernel_row("scores_bf16", ebig, eres["small"],
                       train["train_reference_bf16"]["scores_bf16"],
                       "reference-launcher default train with a bf16 state",
                       "equal bit patterns on every output (each operation "
                       "rounded to bf16, as the compiled reference)"),
            kernel_row("apply", ebig, eres["small"],
                       train["train_reference"]["apply"],
                       reference, "equal bit patterns on every output",
                       segmented_launches=segmented("apply")),
            kernel_row("histogram", hbig, hres["small"],
                       ref_launches["dense_histogram_kernel_degrade"][
                           "histogram"],
                       "GradientSync, reference pipeline, "
                       "selector=histogram_kernel", bitwise,
                       sketch_launches=train["train_sketch_hist"][
                           "histogram"],
                       library_ms=hbig["histogram_histc_ms"] if histc_same
                       else None,
                       library_note=None if histc_same else
                       "none (torch.histc bins differently: "
                       f"{hbig['histogram_histc_differing_bins']} bins "
                       "differ)", redesigned=True)]
    for row in rows:
        if row["name"] in ("sweep1", "sweep2"):
            # the segment cases are kernel-vs-plain comparisons too
            row["max_abs_err"] = max(row["max_abs_err"],
                                     segres[f"{row['name']}_err"])
    return finish(smi, rows)


def finish(smi: str, rows) -> int:
    """The last lines: the kernel summary (a full run only), the card's
    name and power limit, and the result line."""
    import torch
    if rows is not None:
        print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
