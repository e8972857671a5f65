#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's serving, training and troubleshoot paths on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its lines; any failure ends the run with a non-zero
exit code and no result line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels from ``csrc/*.cu`` with nvcc for sm_90a;
3. K8 (one sepconv block) against its plain PyTorch version at every block
   shape of the 256x256 binary U-Net, batch 2, fp32 and bf16; then at other
   shapes at batch 2 and 3, ReLU on and off (``BLOCK_RAGGED``: H x W 20 x
   36, C = 3 with F = 48, C = 5 with F = 33, C = 200 with F = 72, F = 300
   over a cluster of 4 whose last slice is partial, with C = 12 and with
   C = 200 (a partial last chunk split across the cluster), 1024 -> 1024
   at 16 px, and the 512 px model's blocks);
4. K7 (a fused block pair) likewise at the nine stage shapes, ``pool=True``
   on the encoder stages and ``x2`` on the decoder stages; then at ragged
   shapes at batch 2 and 3 (H x W 20 x 36, a 3-channel input with F = 48,
   ``x2`` with 80 + 80 channels and F = 80, ``pool`` at 18 x 18 with F = 200
   so the cluster's last slice is partial, odd widths: ``x2`` with 5 + 3
   channels and F 33 -> 7, a cluster of 4 with F 300 -> 270) and at the nine
   stage shapes of the 512 px model (``configs/multiclass_512.json``);
5. the main path at full width (filters 64..512, bottleneck 1024, 256x256):
   a port checkpoint of seeded weights, ``Predictor(use_pallas=True)``
   answering batches of 1, 5 (bucketed to 8) and 32 in fp32 and bf16, held
   against a ``Predictor`` with kernels off on the same card; the module
   path with ``use_pallas=True`` (K8 in every ConvBlock) likewise; the
   launch counters of that run; images/s at batch 32, kernels on and off;
   one bf16 batch-32 ``predict`` under ``torch.profiler`` (device busy, idle
   share, K7's share of the busy time, the host copies), and one of phase
   13's int8 ``Predictor`` (its warm-up calibrates it on that batch);
6. K7 and K8 at batch 32, each output held against its plain version under
   phase 4's and phase 3's bars, then timed beside it, with its bound and
   its executed over useful multiply-adds a stage or block; both summed
   over the path's shapes;
7. K1-K6, K9-K11 against their plain versions at every shape of their
   paths, batch 2, fp32 and bf16: K1-K4 (the training chain's link forward
   and backward, the encoder boundary's pool and its backward; K4 on inputs
   with exact ties), K6 (the decoder feed, forward and backward) at the four
   decoder stages, K5 (the fused head, forward and backward) at dec1 on
   inputs where the ReLU's argument is exactly 0 on some pixels, K11 (the
   softmax head) at dec1 of the 512 px model with 3 classes and at another
   width with 4, on such inputs, with class ids of NC (in no class) and two
   classes' logits tied everywhere (the confusion matrix must match
   exactly), K9/K10 (per-block training) at the 18 block
   shapes of the 256 px model; then K1, K9, K2 and K10 at other shapes, batch
   2 and 3 (``LINK_RAGGED``: H x W 20 x 36, 3 input channels with F = 48, C = 5
   with F = 33 off the mma's depth, C = 200 with F = 72 so the last C
   slice and dpw tile are partial, C = 200 with F = 300 and the dropout (K1's
   cluster of 4 over a partial last chunk), a 1024 -> 1024 link at 16 px with the
   affine, the dropout and the output mask, and the 512 px model's links),
   and K6 at other feeds, batch 2 and 3, fp32 and bf16 (``FEED_RAGGED``:
   48 -> 8 at 16 px, C = 96 and 200 with F = 24 and 40 on odd sides
   H x W 9 x 13 and 5 x 3, odd C and F (5 -> 3), and the 512 px model's
   feeds), and K4, K5 and K11 at other shapes, batch 2 and 3, fp32 and
   bf16 (``POOL_RAGGED``: H x W 20 x 36 with F = 40 and 200, the 512 px
   model's boundaries; ``HEAD_RAGGED``: 20 x 36 with F = 8, 24, 40, 200 and
   the widest width (256 bf16, 128 fp32; a width the heads do not take in
   a dtype is skipped), F = 40 on 9 x 13 pixels, whose samples' targets are
   not 16-byte aligned, and dec1 of the 512 px model; K11 with 2, 3 and 4
   classes at each). Everywhere K4's dzt must equal its plain version's bit
   for bit (ties and the ReLU mask), K5's and K11's dzt must be 0 wherever
   a*y+b is not above 0, K11's confusion matrix must be exact, and a second
   launch of K4, K5 and K11 on the same inputs must give the same bits;
   then K11's forward and backward traced alone at the multiclass path's
   shape: one launch of each kernel, no row-sum launch;
8. the training path at full width (``configs/tpu_train_256_bf16.json`` as
   it is: ``fused_head`` auto, batch 32, seeded weights, in-memory scenes):
   3 train steps with the kernels against 3 of the composed path in fp32
   and bf16 (loss per step, step-1 gradients, BatchNorm running stats after
   step 3), the K1-K6 launches of every kernels-on step, train images/s,
   peak memory, and two steps under ``torch.profiler`` attributed to the
   kernels by ``troubleshoot/step_attribution.py`` (each kernel's launches a
   step held to the wrappers' counters); one bf16 kernels-on step with
   ``fused_head`` off (the same launches but K5's); the eval step
   (``make_eval_step``, fit's validation step) at batch 32, 18 K8 launches,
   kernels on against the composed path in fp32 and bf16 (loss and metrics
   under phase 5's module-path bars) and its images/s in turns; then
   ``fit`` for one epoch whose ``best/`` checkpoint a ``Predictor`` serves;
9. K1-K6, K9, K10 at batch 32 and K11 at batch 8 of 512 px (the paths'
   batches), whose launch plans differ from batch 2's: each output held
   against its plain version under phase 7's bars (K4, K5 and K11 with
   phase 7's bit checks), then both timed, K3-K6 and K9 with their bounds and
   the share of the bound reached; beside them, K6's fp32 d_kernel and its
   plain version's distance from an fp64 product on the card at the four
   feeds (a print, no bar; ``troubleshoot/upconcat_digits.py`` takes it
   apart);
10. multiclass training at full width (``configs/multiclass_512.json`` with
   ``fused_head`` all: 3 classes, 512 px, batch 8, cce, numpy class-id
   scenes): 3 steps with the kernels against 3 of the composed path in fp32
   and bf16 under phase 8's bars, 18/18/4/4 K1-K4, 4/4 K6 and 1/1 K11
   launches a step, images/s, peak memory and a profiled step (K11's device
   ms with every launch it makes); then the config's own 'auto' (K11 off,
   the composed sums) for one step, and its images/s against 'all' in turns
   (the A/B that decides the default);
11. per-block training at full width: each of the 18 ConvBlocks of the
   256 px model at batch 32 with BatchNorm and ``use_pallas`` (one K9 and
   one K10 launch a block) against the composed block (output, every
   gradient, running statistics; the cotangent is 0 at the outputs whose
   ReLU the fp32 and fp64 forwards decide apart, at most 64 a block; the
   fp32 output and dx within 16x the fp32 composed block's distance from
   the fp64 composed block, the rest within 5e-4 of it); K10's fp32 dpw at
   enc1.1 five ways (``troubleshoot/dpw_digits.py``: fp64; fp32 fused
   multiply-adds in pass (b)'s order; its products as 3xTF32; one split;
   the kernel) from the inputs the block's K10 took, and at batch 2 from
   the tool's seeded inputs; then one train step of the 256 px U-Net
   without BatchNorm (18 K8 launches) against its composed step;
12. the troubleshoot tools: K12a (the launch probe, ``x + 1`` on (8, 128)
   fp32) exactly and K12b (the FMA-rate probe at (1024, 512), K = 2048)
   bit for bit in bf16 and within K * 2^-24 in fp32 against their plain
   versions, with their times; ``link_floors --iters 5`` (K12's launch cost
   and FMA rates, the tensor cores' product rate, K2 timed alone at the 18
   links with one launch a timed call, each link split into pass (a), pass
   (b) and the row sums under the profiler, against its bytes floor and the
   model of its route, with its executed over useful multiply-adds; K1
   likewise, one launch a timed call;
   ``build/link_floors.json``);
   ``step_attribution`` on the default step (sites plus glue equal to the
   device's busy time within 2%, 18/18/4/4 K1-K4, 4/4 K6 and 1/1 K5
   launches a step; ``build/step_attribution.json``); ``check_install`` and
   ``check_gpu_benchmark`` (one run of three trials on the CPU leg), both
   exiting 0;
13. int8 serving at full width, on phase 5's checkpoint, fp32 and bf16: K7's
   int8 I/O mode against its plain int8 version at the nine stage shapes
   at batch 2 and 32, and at ragged shapes at batch 2 and 3
   (``INT8_RAGGED``: 20 x 36, the 3-channel input, ``x2`` with 80 + 80 and
   with 5 + 3 channels, F 300 -> 270 over a partial cluster, ``pool`` at
   18 x 18), to 1 + phase 4's relative bar x max|plain| quanta, with the
   share of elements that differ; in fp32 also bit for bit against
   quantizing the float K7's output on the dequantized input;
   ``Predictor(use_pallas=True, quantize='int8')`` answering batches of 32
   (the calibration batch), 1 and 5 (9 int8 K7 launches and no float one a
   forward), each of the nine K7 int8 calls of a batch-32 forward held to
   its plain version on the same inputs under the bar above, and the
   answers printed beside the same graph with K7's plain int8 version and
   beside the float kernel graph; ``evaluate``'s batched core on seeded
   scenes with masks (batch 32, a ragged last batch), int8 against float
   MeanIoU within 0.01; K7 int8 timed at batch 32 beside its plain version
   and its bound, and images/s int8 against float in turns;
14. 1080p streaming and row-sharded serving of the 1024 px model
   (``configs/highres_1024.json``'s U-Net, seeded weights, BatchNorm
   recalibrated as in phase 5): first ``StreamingPredictor`` on 8 seeded
   1080x1920 uint8 frames, bf16 profiled in a process of this script of its
   own (``--profile-stream``; device busy, idle share, K7's share, the
   resize products' spans, host copies), bf16 and fp32 held to
   the module path's stream under phase 5's bars with 9 K7 launches a
   forward, the int8 stream (9 int8 K7 launches and nothing else a forward,
   printed beside the float stream), frames/s in turns; then K7 with edge
   flags against its plain version (float under phase 4's bars, int8 I/O
   under phase 13's quanta) on the H / 2 + 4-row slabs of the nine stages of
   the 256 and 1024 px models, all four flag pairs, batch 2, and at
   ``EDGE_RAGGED`` at batch 2 and 3; every stage input of both models cut
   into 2 and 4 row shards, padded, run with the flags and stitched, against
   the unsharded K7 (bit for bit on the same launch plan); K7
   float-in/int8-out against its plain version at the decoder stages of
   both models, batch 2 and 3 (fp32 also bit for bit quantize(float K7));
   both modes timed at the dry run's slabs with their bounds; then the dry
   run: two processes of this script (``--rank``) on the one card, gloo, a
   (data=1, spatial=2) mesh, each serving its rows of 2 images through the
   sharded float graph (bf16, fp32), the sharded int8 graph (bf16) and the
   sharded stream, their launches counted and asserted (45 edge-flag and 4
   float-in/int8-out a rank), the gathered outputs held to the unsharded
   ones on the card (fp32 2e-5, bf16 phase 5's bars, int8 at most 0.1% of
   the elements over 1e-5); a rank that fails or hangs fails the run;
15. row-sharded and data-parallel training of the 1024 px model, K1's halo
   mode: K1 with a halo against its plain version at the 18 links of a rank
   of 2 row shards (batch 2) and at ``HALO_RAGGED`` (10-row shards of 20 x
   36, C = 3, C = 200 with F = 300 over a partial cluster; batch 2 and 3),
   halo above, below and both, the affine on and off, under phase 7's K1
   bars; zero halos bit for bit K1 without one; every link's input cut into
   2 row shards, each run with its neighbour's z row, stitched bit for bit
   the whole image's y (the sums under the sums' bar); halo against no halo
   timed at the 18 shard links at batch 4 with the bound; then
   ``configs/highres_1024.json`` as it is through ``fit`` on one rank (its
   spatial degree clamped to 1 with the Note), K3/K4 at its boundaries
   against plain, one bf16 step profiled in a process of this script of its
   own (``--profile-train``), and 3 steps kernels on against composed in
   fp32 and bf16 under phase 8's bars and launches, images/s and peak
   memory; then the dry run: the unsharded steps on the card, and two
   processes (``--train-rank``) on the one card, gloo, training 2 steps
   over a (1, 2) and a (2, 1) mesh (global batch 4, dropout 0, fp32 and
   bf16; 18 K1 halo-mode launches a step on a row-sharded rank), each held
   to the unsharded step (``hold_shard``), and one row-sharded step with
   dropout 0.2 whose dropout sites' keep masks, recorded as the step
   applies them, differ between the two ranks;
16. export (``export/pt2.py``) of phase 5's checkpoint on the card: the
   plain model and the ``use_pallas`` model at batch 1 and 32, fp32 and
   bf16, through ``export_pt2``; each artifact loaded in a fresh process
   (the plain graphs where only torch is imported, no module of the
   repository; the kernel graphs through ``load_pt2``): each loaded graph
   held to its in-memory module, and the kernel graph to the same graph
   with K8's plain version, under phase 3's K8 bars relative to
   max|plain|; the kernel graph to the plain graph under K8's fp32 bar and
   in bf16 under phase 5's mask agreement (the roundings of 18 bf16 blocks
   part from the composed path's as in phase 5), 18 ``unet.sepconv_block``
   nodes and 18 K8 launches a forward of a kernel graph (the loading
   process's counter), images/s at batch 32 loaded against in memory; then
   the export CLI's ``pt2`` on phase 8's ``fit`` checkpoint, its artifact
   held to the checkpoint's module;
17. the binary 256 px quality gate's ``torch`` stage
   (``troubleshoot/quality_gate_256.py``; the gate's full run is a command
   of its own): a pack of 16 train and 8 val numpy scenes written on the
   card with the port's ``write_pack``, stamped with the gate's
   ``write_stamp``, then one seed for one epoch of 8 steps at full width in
   fp32 (BatchNorm, dropout 0, ``use_pallas``) through ``fit``: 18/18/4/4
   K1-K4, 4/4 K6 and 1/1 K5 launches a step, 18 K8 launches a validation
   forward and in the first predict forward, a val IoU in [0, 1] and finite
   losses; then the stage refuses the pack with one byte changed; the
   stage's seconds;
18. the 3-class quality gate's ``torch`` stage
   (``troubleshoot/quality_gate_512mc.py``; the gate's full runs are
   commands of their own): a pack of 8 train and 4 val numpy class-id scenes
   at 512 px written on the card with ``write_pack(...,
   mask_is_class_id=True)``, one seed for one epoch of 4 steps at full
   width in fp32 with ``cce`` through ``fit``: with ``fused_head`` 'auto'
   18/18/4/4 K1-K4, 4/4 K6 and no K5 or K11 launch a step, 18 K8 launches
   a validation forward and in the first predict forward; then the same
   epoch with 'all' (the gate's K11 leg): 1/1 K11 a step beside the same
   K1-K4 and K6; per-class IoUs in [0, 1] and finite losses; then the stage
   refuses the pack with one byte changed; the stage's seconds;
19. the row-sharded module path (the JAX package's GSPMD-XLA step, for the
   configurations the fused chains cannot train on row shards):
   ``configs/fullconv_bce_256.json`` (a) and ``configs/binary_256.json``
   (b) as they are, through ``fit``'s path selection, model, state and
   step, unsharded on the card and then over a (data=1, spatial=2) mesh of
   two processes of this script (``--module-rank``) on the one card, gloo,
   from the same seeded weights and batches, TF32 off in both: step 1 with
   dropout off held to the unsharded step under the JAX package's bars for
   its GSPMD step (loss and dice 2e-5 relative, confusion matrices within
   0.5 plus the pixels the two runs' probabilities put in different
   classes, the probabilities within phase 5's fp32 bar of 1e-3, each
   gradient element within 1e-4 + 1e-4 x
   |unsharded|, running statistics within 1e-5 + 1e-5 x |unsharded|),
   then 3 steps with the
   config's dropout (finite losses) and their images/s; (c) the 1024 px
   model of ``configs/highres_1024.json`` with ``use_pallas`` off streamed
   from phase 14's 8 frames over the mesh against the unsharded module-path
   stream in bf16 and fp32 (phase 5's bars), frames/s; and
   ``configs/tpu_train_256_bf16.json`` with the ``iou`` loss, 3 steps on the
   kernels against the composed path under phase 8's bars and launches; the
   phase's seconds; then the twenty kernels' JSON line (with each kernel's
   bound, and K12a's library time) and the result line.

A profile whose trace lost device activity (no device time, or kernels the
host launched missing) is taken again, at most four times (``traced``); the
stream's, each time in a fresh process. TF32 is off throughout (``allow_tf32 = False`` for
matmul and cuDNN), so the plain versions compute in full fp32 like the
kernels. Relative errors are ``max|kernel - plain| / max|plain|``.
"""

import contextlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(ROOT, "build", "chip_smoke.json")  # all numbers of the run
sys.path.insert(0, ROOT)
from unet_image_segmentation_tpu_torch.troubleshoot import roofline  # noqa: E402

IMAGE = 256
FILTERS = (64, 128, 256, 512)
BATCH_CHECK = 2          # batch of the kernel comparisons
BATCH_SERVE = 32         # batch of the throughput runs and kernel timings
REQUESTS = (1, 5, 32)    # 5 runs in the bucket of 8
SEED = 2301

# kernel vs plain, relative to max|plain|: fp32 differs only by summation
# order; bf16 may differ by one bf16 rounding (2^-8) of an intermediate
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Predictor probabilities (max abs) and thresholded-mask agreement, kernels
# on vs off. In bf16 the kernels-off module path rounds to bf16 after every
# op (depthwise, pointwise, BN) where the kernels round only where the JAX
# serving graph does, so the two bf16 answers differ by more than bf16 noise.
PROB_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
MODEL_KWARGS = {"num_classes": 1, "filters": list(FILTERS), "use_batch_norm": True,
                "conv_type": "separable"}
MASK_MIN_AGREE = {"float32": 0.999, "bfloat16": 0.98}
PAIR_LAUNCHES_PER_FORWARD = 9
TRACE_ATTEMPTS = 4       # a profile whose trace lost device activity is taken again
INT8_LAUNCHES_PER_FORWARD = 9
BLOCK_LAUNCHES_PER_FORWARD = 18
# K1-K4 vs plain, relative to max|plain|. Elementwise outputs (y, dx, z,
# pooled, dzt) take the K7/K8 bars. Reductions over B*H*W pixels (Σy, Σy²,
# ddw, dpw, S, T; 131K pixels per channel at batch 2 and 256 px, 2M at
# batch 32) are summed in another order than the plain version's, and a
# sum with cancellation drifts by ~sqrt(n) fp32 roundings, so fp32 gets 5e-4.
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_SUM_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
TRAIN_CONFIG = "configs/tpu_train_256_bf16.json"   # run as it is
TRAIN_STEPS = 3
TRAIN_REPS = 5           # timing repetitions of K1-K6 and their plain versions
STEP_LAUNCHES = {"chain_fwd": 18, "chain_fwd_halo": 0, "chain_bwd": 18, "tail_pool": 4,
                 "tail_pool_bwd": 4, "upconcat": 4, "upconcat_bwd": 4, "head_fwd": 1,
                 "head_bwd": 1, "head_fwd_mc": 0, "head_bwd_mc": 0}
# the same step with fused_head off: K5 does not run
STEP_LAUNCHES_HEAD_OFF = {**STEP_LAUNCHES, "head_fwd": 0, "head_bwd": 0}
# the multiclass config: K11 with fused_head all; nothing of the head with auto
MC_CONFIG = "configs/multiclass_512.json"
MC_IMAGE, MC_BATCH = 512, 8
MC_STEP_LAUNCHES = {**STEP_LAUNCHES_HEAD_OFF, "head_fwd_mc": 1, "head_bwd_mc": 1}
MC_HEAD_CASES = ((MC_IMAGE, FILTERS[0], 3), (IMAGE, 32, 4))   # (px, F, classes) in phase 7
# Kernels-on train steps vs the composed path on the same card, relative.
# fp32: both compute in fp32 with sums in other orders (2M pixels a channel
# at the 256 px stages). The step-1 gradients pass nine BatchNorm backwards
# whose mean and variance terms cancel most of the gradient: at the
# bottleneck max|g| is ~1e-5 of the head's, so fp32 roundings show there as
# relative errors of ~1e-2 (H100 run: median 1.7e-4 over the 82 tensors,
# worst 1.5e-2 at bneck_block1.bn.bias, cosine >= 0.99999). The bar holds
# each tensor to 5e-2 and a cosine of 0.9999. bf16: the composed path rounds
# to bf16 after every op (conv, BN, ReLU and their gradients), the chain
# only where the Pallas kernels round, so the two bf16 answers differ by
# more than bf16 noise (H100 run: up to 0.24 at the bottleneck); each is
# held against the fp32 composed gradients, and the kernels' error per
# tensor may not exceed 1.5x the composed bf16 path's own error plus 0.01.
TRAIN_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_GRAD_TOL = 5e-2
TRAIN_GRAD_COS = 0.9999
BF16_GRAD_FACTOR = 1.5
BF16_GRAD_SLACK = 1e-2
# BatchNorm running stats after step 3: by then the two runs' weights differ
# where AdamW turned the sign noise of near-zero gradients into opposite
# +-lr steps, and the batch moments of steps 2 and 3 move with them (H100
# run: 5.5e-3 in fp32 at enc4_block1.bn.mean), so fp32 is held to 2e-2.
# bf16 is held like the bf16 gradients, against the fp32 composed run.
TRAIN_STATS_TOL = 2e-2
# Phase 11, one ConvBlock with BatchNorm, kernels (K9/K10) vs the composed
# block on the same card: fp32 output held like an elementwise kernel output,
# its gradients and the running statistics (sums over 2M pixels, each
# through one BatchNorm backward) like the kernels' sums. bf16 is held
# against the fp32 composed block like phase 8's bf16 gradients, but beside
# the same per-block path run with K9/K10's plain versions: that path rounds
# the output cotangent to bf16 twice, as the JAX VJP does (gy alone, then
# gy + gs + 2 y gq), and after BatchNorm's cancellation the first block's
# depthwise gradient carries ~4x the composed bf16 block's error (H100 run:
# 0.18 against 0.048 at enc1.1), so the composed bf16 block is no bar for it.
BLOCK_OUT_TOL = 1e-4
BLOCK_GRAD_TOL = 5e-4
# The ReLU after BatchNorm decides some outputs within a few fp32 ulps of 0;
# there the kernels (3xTF32 products), the composed block (cuDNN) and the
# fp64 composed block may decide apart, and each such decision moves one
# pixel's gradient by O(1). Phase 11 zeroes the cotangent at the outputs the
# three forwards decide apart, at most RELU_APART_MAX a block (H100 run: 1-28
# of 8-134 M between the two fp32 forwards; a systematic error in y of 5e-5
# relative would put tens of thousands apart). On the same decisions the
# fp32 kernels are held to the fp64 composed block: the output and dx at most
# FP64_FACTOR x the fp32 composed block's own distance from it (H100 run: up
# to 4.3x and 7.3x, at 5.7e-6 and 6.2e-6), the parameter gradients and
# running statistics within BLOCK_GRAD_TOL (H100 run: up to 9.1e-6, a
# running mean; dpw at enc1.1 4.6e-6 where the composed block is 1.8e-6
# off, 1.5e-4 before K2/K10's fp32 pass (b) took fresh mma fragments).
RELU_APART_MAX = 64
FP64_FACTOR = 16.0
DPW_BLOCK = "enc1.1"   # the block whose K10 dpw phase 11 takes apart (dpw_digits)
BLOCK_LAUNCHES = {"sepconv_block": 0, "sepconv_pair": 0, "sepconv_pair_int8": 0,
                  "sepconv_pair_quant_out": 0, "sepconv_pair_edge": 0, "sepconv_stats": 1,
                  "sepconv_bwd": 1}
BN_OFF_K8_LAUNCHES = 18
# phase 12: K12b at its full shape, and the counts the troubleshoot tools run
FMA_PROBE_K = 2048
FMA_PROBE_SHAPE = (1024, 512)
LINK_FLOORS_ARGS = ["--iters", "5"]
ATTRIBUTION_ARGS = ["--warmup", "3", "--steps", "3"]
GPU_BENCHMARK_ARGS = ["--cpu-runs", "1", "--cpu-trials", "3"]
# the shapes of the kernels' calls on the paths (troubleshoot/roofline.py)
STAGES = roofline.stage_shapes(IMAGE, FILTERS)
# phase 13: K7's int8 I/O mode at the stage shapes at these batches, and
# beyond them (label, Cx, Cx2, F1, F2, H, W, mode) at these batches: ragged
# edges, the 3-channel input and 5 + 3 channels (plain loads), 80 + 80
# (vectors of V int8 channels), a partial last slice of a cluster of 4, the
# pool on an odd number of 8x8 tiles
INT8_BATCHES = (BATCH_CHECK, BATCH_SERVE)
INT8_RAGGED = [("20x36", 32, 0, 64, 64, 20, 36, "plain"),
               ("cx3 f48", 3, 0, 48, 48, 24, 24, "pool"),
               ("x2 80|80 f80", 80, 80, 80, 80, 16, 16, "x2"),
               ("x2 5|3 f33 f7", 5, 3, 33, 7, 10, 14, "x2"),
               ("cluster f300 f270", 12, 0, 300, 270, 9, 9, "plain"),
               ("pool 18x18 f200", 64, 0, 200, 200, 18, 18, "pool")]
INT8_RAGGED_BATCHES = (2, 3)
INT8_SCALES = (2.0 ** -7, 2.0 ** -6)   # of x (int8 in [-127, 127]) and x2 ([0, 127])
INT8_REQUESTS = (BATCH_SERVE, 1, 5)    # the first calibrates the graph
# int8 against float MeanIoU of evaluate's core (the JAX package's IoU bar)
INT8_MEAN_IOU_TOL = 0.01
EVAL_SCENES = 72                        # batches of 32, 32 and a ragged 8
# phase 14: the 1024 px model (configs/highres_1024.json: filters 64..512,
# bottleneck 1024) streamed from 1080p frames, and served over row shards
STREAM_IMAGE, STREAM_FRAME, STREAM_BATCH = 1024, (1080, 1920), 8
STAGES_1024 = roofline.stage_shapes(STREAM_IMAGE, FILTERS)
EDGE_FLAGS = ((0, 0), (1, 0), (0, 1), (1, 1))
SHARDS = (2, 4)                  # the stitching's row shards
DRY_RANKS, DRY_BATCH = 2, 2      # two ranks on the one card, each its half of the rows
RANK_TIMEOUT = 300               # seconds a rank of the dry run may take
PROFILE_TIMEOUT = 180            # seconds the stream profile's process may take
# K7 with edge flags beyond the stage shapes: (label, Cx, Cx2, F1, F2, H, W,
# mode) slabs, each with the flags of a first, a last and a single shard
EDGE_RAGGED = [("20x36", 32, 0, 64, 64, 20, 36, "plain"), ("odd x2", 5, 3, 33, 7, 9, 13, "x2"),
               ("pool", 3, 0, 48, 48, 20, 36, "pool")]
EDGE_RAGGED_FLAGS = ((1, 0), (0, 1), (1, 1))
STREAM_LAUNCHES_EDGE = 9         # K7 launches with edge flags, a rank a sharded forward
STREAM_LAUNCHES_QUANT_OUT = 4    # float-in/int8-out launches (the decoder) a rank a forward
STREAM_REPS = 3
# phase 15: the 1024 px model's training (configs/highres_1024.json as it
# is: batch 4, bf16, dropout 0.2) on one rank, kernels on against composed;
# K1's halo mode against its plain version at the links of a rank of 2 row
# shards and at ragged shapes (label, C, F, H, W of a shard), stitched
# shards bit for bit the whole image's; then two ranks on the one card
# (gloo) training over a (1, 2) and a (2, 1) mesh against the unsharded step
HIGHRES_CONFIG = "configs/highres_1024.json"
TRAIN_RANKS = 2
SHARD_TRAIN_BATCH = 4            # the config's batch: a (1, 2) rank takes 4 x 512 rows
SHARD_LINKS = roofline.shard_links(STREAM_IMAGE, FILTERS, TRAIN_RANKS)
LINK_AFFINE = [link[4] for link in roofline.chain_links(STREAM_IMAGE, FILTERS)]
HIGHRES_POOLS = roofline.pool_shapes(STREAM_IMAGE, FILTERS)
HALO_BATCH = 2
HALO_RAGGED = [("20x36", 32, 64, 10, 36), ("c3 f48", 3, 48, 10, 36),
               ("c200 f300", 200, 300, 10, 36)]
HALO_RAGGED_BATCHES = (2, 3)
SHARD_MESHES = ((1, 2), (2, 1))  # (data, spatial)
SHARD_STEPS = 2
# the sharded steps against the unsharded step on the same card, fp32:
# the loss relative, each step-1 gradient tensor's largest difference over
# its max|g| and its cosine, the running statistics relative after step 1
# (the forward's batch moments, summed in another order) and after step 2.
# By step 2 the weights differ where AdamW's first step, about lr x the
# sign of each gradient element, turned the rounding noise of near-zero
# gradients into +-lr apart, and step 2's moments move with them (H100
# run: 3.7e-4 at enc4_block2.bn.mean over a (1, 2) mesh, where the step-1
# gradients were at most 6.3e-4 of max|g| apart), so step 2 is held to
# 2e-3, step 1 to 1e-4.
SHARD_LOSS_TOL = 2e-5
SHARD_GRAD_TOL = 1e-3
SHARD_GRAD_COS = 0.99999
SHARD_STATS_TOL = 1e-4
SHARD_STATS_TOL_STEP2 = 2e-3
SHARD_LAUNCHES_HALO = 18         # K1 halo-mode launches a step on a row-sharded rank
TRAIN_RANK_TIMEOUT = 420
# phase 16: export of phase 5's checkpoint at these batches, each artifact
# loaded in a process of its own kind: the plain graphs where only torch is
# imported, the kernel graphs with the port (unet::sepconv_block)
EXPORT_BATCHES = (1, BATCH_SERVE)
EXPORT_KINDS = ("plain", "kernel")
EXPORT_NODE = "unet.sepconv_block.default"
EXPORT_CHILD_TIMEOUT = 300
EXPORT_REPS = 10
# phase 17: the quality gate's torch stage on packed numpy scenes
GATE_SCENES = (16, 8)            # train, val records: 8 steps at batch 2, one epoch
GATE_SECONDS = 30                # the phase's budget on the host clock
# phase 18: the 3-class quality gate's torch stage on packed class-id scenes
GATE_MC_SCENES = (8, 4)          # train, val records at 512 px: 4 steps at batch 2
GATE_MC_SECONDS = 30             # the phase's budget on the host clock
# phase 19: the row-sharded module path (the JAX package's GSPMD-XLA step):
# two configs as they are, trained over a (1, 2) mesh of two ranks on the
# one card (gloo) and unsharded, from the same seeded weights and batches;
# the 1024 px module-path stream over the mesh; an iou step on the kernels
MODULE_CONFIGS = {"a": "configs/fullconv_bce_256.json", "b": "configs/binary_256.json"}
MODULE_MESH = (1, 2)             # (data, spatial)
MODULE_RANKS = 2
MODULE_STEPS = 3                 # with the config's dropout, after the held step 1
# step 1 (dropout off) of the row-sharded step against the unsharded step,
# under the JAX package's bars for its GSPMD step (tests/test_spatial_train.py):
# loss and dice relative, the confusion matrices' counts, each raw gradient
# element (atol + rtol x |unsharded|), the running statistics likewise. The
# counts' bar of 0.5 was set on 4096 pixels; of the 2.1M pixels of leg (a)'s
# step, a pixel whose probability lies within the two runs' difference of
# a class boundary may round to either class (H100 runs: 1 and 5 pixels
# changed class, one count moved by 1), so each pixel the two runs put in
# different classes is added to the count bar, at most MODULE_NEAR_FRAC of
# the step's pixels, and the probabilities are held to MODULE_PROB_ATOL,
# ten times the larger H100 reading (5.0e-6 leg (a), 2.3e-6 leg (b))
MODULE_LOSS_RTOL = 2e-5
MODULE_CM_ATOL = 0.5
MODULE_NEAR_FRAC = 1e-5
MODULE_PROB_ATOL = 5e-5
MODULE_GRAD_TOL = (1e-4, 1e-4)   # (atol, rtol)
MODULE_STATS_TOL = (1e-5, 1e-5)
MODULE_STREAM_DTYPES = ("bfloat16", "float32")   # the config's dtype first
MODULE_RANK_TIMEOUT = 480
IOU_CONFIG = TRAIN_CONFIG        # run with loss 'iou', on the kernels


def slab_shapes(stages, n):
    """The K7 calls of one rank of ``n`` row shards: each stage's slab, its
    H / n rows and 2 halo rows each side, by its full width."""
    return [(name, cx, cx2, f1, f2, h // n + 4, mode, h)
            for name, cx, cx2, f1, f2, h, mode in stages]


SHARD_STAGES = slab_shapes(STAGES_1024, DRY_RANKS)
SHARD_DECODER = [stage for stage in SHARD_STAGES if stage[6] == "x2"]


# K7 beyond the path's shapes (phase 4): (label, Cx, Cx2, F1, F2, H, W, mode)
# at these batches; ragged edges, a partial last slice of the cluster, and
# the 512 px model's stages
PAIR_RAGGED = [("20x36", 32, 0, 64, 64, 20, 36, "plain"),
               ("cx3 f48", 3, 0, 48, 48, 24, 24, "pool"),
               ("x2 80|80 f80", 80, 80, 80, 80, 16, 16, "x2"),
               ("pool 18x18 f200", 64, 0, 200, 200, 18, 18, "pool"),
               # odd widths: the plain-load staging of x2 and the weights, odd stores
               ("odd x2 5|3 f33 f7", 5, 3, 33, 7, 10, 14, "x2"),
               ("odd cluster f300 f270", 12, 0, 300, 270, 9, 9, "plain")] + [
    (f"512px {name}", cx, cx2, f1, f2, h, h, mode)
    for name, cx, cx2, f1, f2, h, mode in roofline.stage_shapes(512, FILTERS)]
PAIR_RAGGED_BATCHES = (2, 3)
# K8 beyond the path's shapes (phase 3): (label, C, F, H, W) at these
# batches, ReLU on and off; ragged edges, 3 and 5 input channels (plain-load
# staging, C off the mma depth), F off 16 (33) and a partial 128-wide slice
# (72), a cluster of 4 whose last slice is partial (F = 300) over one
# chunk and over four whose last is partial and split across the CTAs
# (C = 200), the deepest block, and the 512 px model's blocks
BLOCK_RAGGED = [("20x36", 32, 64, 20, 36), ("c3 f48", 3, 48, 24, 24), ("c5 f33", 5, 33, 10, 14),
                ("c200 f72", 200, 72, 12, 20), ("f300", 12, 300, 9, 9),
                ("c200 f300", 200, 300, 12, 20), ("deep", 1024, 1024, 16, 16)]
BLOCK_RAGGED_BATCHES = (2, 3)
# the eval step (phase 8): K8 in each of its 18 blocks
EVAL_K8_LAUNCHES = 18
# K2/K10 beyond the path's shapes (phase 7): (label, C, F, H, W, in_aff, drop,
# mask_combine) at these batches; ragged edges, 3 and 5 input channels, F
# off the mma's k16 (33), a partial last C slice and dpw tile (C = 200), K1's
# cluster of 4 over a partial last chunk split across its CTAs (C = 200,
# F = 300), the deepest link in every mode, and the 512 px model's links
LINK_RAGGED = [("20x36", 32, 64, 20, 36, True, False, True),
               ("c3 f48", 3, 48, 24, 24, False, False, False),
               ("c5 f33", 5, 33, 10, 14, True, False, True),
               ("c200 f72", 200, 72, 12, 20, True, False, False),
               ("c200 f300", 200, 300, 12, 20, False, True, True),
               ("deep affine mask", 1024, 1024, 16, 16, True, False, True),
               ("deep dropout mask", 1024, 1024, 16, 16, False, True, True)] + [
    (f"512px {name}", c, f, h, h, in_aff, drop, mask)
    for name, c, f, h, in_aff, drop, mask in roofline.chain_links(512, FILTERS)]
LINK_RAGGED_BATCHES = (2, 3)
# K4 and K5 beyond the path's shapes (phase 7), at these batches: K4 at
# (label, F, H, W), widths off the powers of two on ragged rows (20 x 36:
# strips of a partial last window run) and the 512 px model's boundaries;
# K5 at (label, F, H, W), the narrowest widths (one and three 16-byte
# chunks in bf16), widths off the powers of two, the widest each dtype
# takes (head_supported), targets whose per-sample spans are not 16-byte
# aligned (9 x 13 pixels), and the 512 px model's dec1
POOL_RAGGED = [("20x36", 40, 20, 36), ("20x36", 200, 20, 36)] + [
    (f"512px {name}", f, h, h) for name, f, h in roofline.pool_shapes(512, FILTERS)]
HEAD_RAGGED = [("20x36", 8, 20, 36), ("20x36", 24, 20, 36), ("20x36", 40, 20, 36),
               ("20x36", 200, 20, 36), ("20x36 widest", None, 20, 36), ("9x13", 40, 9, 13),
               ("512px dec1", FILTERS[0], 512, 512)]
HEAD_WIDEST = {"float32": 128, "bfloat16": 256}   # 32 chunks of 16 bytes
POOL_HEAD_RAGGED_BATCHES = (2, 3)
LINKS = roofline.chain_links(IMAGE, FILTERS)
POOLS = roofline.pool_shapes(IMAGE, FILTERS)
FEEDS = roofline.upconcat_shapes(IMAGE, FILTERS)


def block_shapes(stages=STAGES):
    """Distinct (C, F, H) of the 18 K8 blocks of a model's stages (256 px)."""
    out = []
    for _, cx, cx2, f1, f2, h, _ in stages:
        for shape in ((cx + cx2, f1, h), (f1, f2, h)):
            if shape not in out:
                out.append(shape)
    return out


BLOCK_RAGGED += [(f"512px {c}->{f}", c, f, h, h)
                 for c, f, h in block_shapes(roofline.stage_shapes(512, FILTERS))]


# K6 beyond the path's feeds (phase 7): (label, C, F, H, W) of x at these
# batches; widths off the 128-column tiles and the 16-byte vectors (C = 48,
# 96, 200 with F = 8, 24, 40; C = 5 with F = 3 stages and stores element by
# element), odd and unequal sides, and the 512 px model's feeds
FEED_RAGGED = [("narrow", 48, 8, 16, 16), ("odd sides", 96, 24, 9, 13),
               ("odd sides", 200, 40, 9, 13), ("small", 200, 24, 5, 3), ("small", 96, 40, 5, 3),
               ("odd widths", 5, 3, 7, 9)] + [
    (f"512px {name}", c, f, h, h) for name, c, f, h in roofline.upconcat_shapes(512, FILTERS)]
FEED_RAGGED_BATCHES = (2, 3)


def upconcat_case(torch, rnd, dev, dtype, batch, c, f, h, w=None):
    """Seeded inputs of one decoder feed for K6 (kernel at the glorot scale),
    x (batch, h, w, c) with w = h unless given."""
    w = h if w is None else w
    return dict(x=rnd(batch, h, w, c).to(dev, dtype),
                kernel=rnd(2, 2, f, c, scale=(6 / (4 * (c + f))) ** 0.5).to(dev),
                bias=0.1 * rnd(f).to(dev), skip=rnd(batch, 2 * h, 2 * w, f).to(dev, dtype),
                g=rnd(batch, 2 * h, 2 * w, 2 * f).to(dev, dtype))


def head_case(torch, rnd, dev, dtype, batch, f=FILTERS[0], h=IMAGE, w=None):
    """Seeded inputs of K5, at dec1 (F = FILTERS[0] at 256 px) unless given.
    y and the affine sit on a grid of quarters (a in {1, 1.5, 2}), so a*y+b
    is exactly 0 on some pixels and the ReLU mask's edge is tested."""
    g, w = rnd.gen, h if w is None else w
    y = (torch.randint(-8, 9, (batch, h, w, f), generator=g) * 0.25).to(dev, dtype)
    aff4 = torch.stack([1 + 0.5 * torch.randint(0, 3, (f,), generator=g),
                        0.25 * torch.randint(-2, 3, (f,), generator=g),
                        0.1 * rnd(f), 1 + 0.5 * rnd(f).abs()]).float().to(dev).contiguous()
    wv = (0.1 * rnd(f)).to(dtype).float().to(dev)
    hb = (0.1 * rnd(1)).to(dtype).float().to(dev)
    t = (torch.rand(y.shape[:3], generator=g) > 0.5).to(torch.uint8).to(dev)
    gsc = rnd(batch, 2).to(dev).contiguous()
    return dict(y=y, aff4=aff4, aff2=aff4[:2].contiguous(), w=wv, hb=hb, t=t, gsc=gsc)


def head_mc_case(torch, rnd, dev, dtype, batch, h, f, nc, w=None):
    """Seeded inputs of K11, y (batch, h, w, f) with w = h unless given: y
    and the affine on quarters as in head_case, class ids 0..nc (an id of
    nc counts in no class), and head weights whose classes 0 and 1 share a
    column and a bias, so their logits tie on every pixel (the first wins)."""
    g, w = rnd.gen, h if w is None else w
    y = (torch.randint(-8, 9, (batch, h, w, f), generator=g) * 0.25).to(dev, dtype)
    aff4 = torch.stack([1 + 0.5 * torch.randint(0, 3, (f,), generator=g),
                        0.25 * torch.randint(-2, 3, (f,), generator=g),
                        0.1 * rnd(f), 1 + 0.5 * rnd(f).abs()]).float().to(dev).contiguous()
    wt = (0.1 * rnd(f, nc)).to(dtype).float()
    wt[:, 1] = wt[:, 0]
    hb = (0.1 * rnd(nc)).to(dtype).float()
    hb[1] = hb[0]
    t = torch.randint(0, nc + 1, (batch, h, w), generator=g).to(torch.uint8).to(dev)
    gsc = rnd(batch, 2 * nc + 1).to(dev).contiguous()
    return dict(y=y, aff4=aff4, aff2=aff4[:2].contiguous(), w=wt.to(dev).contiguous(),
                hb=hb.to(dev).contiguous(), t=t, gsc=gsc)


def block_case(torch, rnd, dev, dtype, batch, c, f, h):
    """Seeded inputs of one per-block training sepconv for K9 and K10."""
    return dict(x=rnd(batch, h, h, c).to(dev, dtype),
                dw=rnd(3, 3, c, scale=(6 / (9 * c + 9)) ** 0.5).to(dev, dtype),
                pw=rnd(c, f, scale=(6 / (c + f)) ** 0.5).to(dev, dtype),
                g=rnd(batch, h, h, f).to(dev, dtype))


def kernel_shapes():
    """Kernel name -> (batch, the shapes of its calls on the path), as
    ``roofline.bounds_ms`` takes them."""
    train = roofline.train_step_shapes(IMAGE, FILTERS, 1)
    mc = roofline.train_step_shapes(MC_IMAGE, FILTERS, 3)
    out = {name: (BATCH_SERVE, shapes) for name, shapes in train.items()}
    out.update(
        sepconv_pair=(BATCH_SERVE, STAGES), sepconv_pair_int8=(BATCH_SERVE, STAGES),
        sepconv_pair_edge=(DRY_BATCH, SHARD_STAGES),
        sepconv_pair_quant_out=(DRY_BATCH, SHARD_DECODER),
        chain_fwd_halo=(SHARD_TRAIN_BATCH, SHARD_LINKS),
        sepconv_block=(BATCH_SERVE, [(cx + cx2, f1, h) for _, cx, cx2, f1, _, h, _ in STAGES] +
                       [(f1, f2, h) for _, _, _, f1, f2, h, _ in STAGES]),
        sepconv_stats=(BATCH_SERVE, LINKS), sepconv_bwd=(BATCH_SERVE, LINKS),
        head_fwd_mc=(MC_BATCH, mc["head_fwd_mc"]), head_bwd_mc=(MC_BATCH, mc["head_bwd_mc"]),
        dispatch_probe=(1, [(8 * 128,)]),
        fma_probe=(1, [(FMA_PROBE_SHAPE[0] * FMA_PROBE_SHAPE[1], FMA_PROBE_K)]))
    return out


def pool_case(torch, rnd, dev, dtype, batch, f, h, w=None):
    """Seeded inputs of one boundary, y (batch, h, w, f) with w = h unless
    given. y takes 9 levels only, so after the ReLU many 2x2 windows hold
    exact ties (K4's first-max rule)."""
    w = h if w is None else w
    y = (torch.randint(-4, 5, (batch, h, w, f), generator=rnd.gen, device=rnd.gen.device)
         * 0.25).to(dev, dtype)
    aff4 = torch.stack([1 + 0.5 * rnd(f).abs(), 0.1 * rnd(f), 0.1 * rnd(f),
                        1 + 0.5 * rnd(f).abs()]).to(dev).contiguous()
    gs = rnd(batch, h, w, f).to(dev, dtype)
    gp = rnd(batch, h // 2, w // 2, f).to(dev, dtype)
    return dict(y=y, aff4=aff4, gs=gs, gp=gp)


def same_bits(torch, name, label, dname, first, again):
    """K4, K5 and K11 sum in a fixed order: a second launch on the same
    inputs gives the same bits, or the run fails."""
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{name} {label} {dname}: a second launch gave other bits")


def judge_feed(fu, tjudge, k, label, dname):
    """K6 forward and backward on one decoder feed's inputs, against plain."""
    fwd, bwd = (k["x"], k["kernel"], k["bias"], k["skip"]), (k["x"], k["kernel"], k["g"])
    tjudge("upconcat", label + " cat", dname, [(fu.upconcat(*fwd), fu.upconcat_reference(*fwd))])
    got, want = fu.upconcat_bwd(*bwd), fu.upconcat_bwd_reference(*bwd)
    tjudge("upconcat_bwd", label + " dx/d_skip", dname, [(got[0], want[0]), (got[3], want[3])])
    tjudge("upconcat_bwd", label + " d_kernel/d_bias", dname,
           [(got[1], want[1]), (got[2], want[2])], sums=True)


def k6_d_kernel_digits(fu, k):
    """K6's fp32 d_kernel and its plain version's, each max |err| over
    max|fp64| against an fp64 product on the card
    (``troubleshoot/upconcat_digits.d_kernel_fp64``): a print, no bar."""
    from unet_image_segmentation_tpu_torch.troubleshoot.upconcat_digits import d_kernel_fp64

    c, f = k["x"].shape[-1], k["kernel"].shape[2]
    ref = d_kernel_fp64(k["x"], k["g"])
    scale = ref.abs().max()
    bwd = (k["x"], k["kernel"], k["g"])
    return {name: ((got[1].permute(3, 0, 1, 2).reshape(c, 4 * f).double() - ref).abs().max()
                   / scale).item()
            for name, got in (("kernel", fu.upconcat_bwd(*bwd)),
                              ("plain", fu.upconcat_bwd_reference(*bwd)))}


def judge_head(torch, fh, tjudge, k, label, dname):
    """K5 forward and backward against plain: dzt exactly 0 wherever the
    plain version's a*y+b is not above 0 (the ReLU mask bit for bit), and a
    second launch of each giving the same bits."""
    fwd = (k["y"], k["t"], k["aff2"], k["w"], k["hb"])
    bwd = (k["y"], k["t"], k["aff4"], k["w"], k["hb"], k["gsc"])
    got = fh.head_fwd_sums(*fwd)
    tjudge("head_fwd", label + " sums", dname, [(got, fh.head_fwd_sums_reference(*fwd))],
           sums=True)
    same_bits(torch, "head_fwd", label, dname, [got], [fh.head_fwd_sums(*fwd)])
    got, want = fh.head_bwd(*bwd), fh.head_bwd_reference(*bwd)
    tjudge("head_bwd", label + " dzt", dname, [(got[0], want[0])])
    tjudge("head_bwd", label + " S/T/dw/db", dname, list(zip(got[1:], want[1:])), sums=True)
    off = (k["y"].float() * k["aff4"][0] + k["aff4"][1]) <= 0
    if bool((got[0][off] != 0).any()):
        raise AssertionError(f"head_bwd {label} {dname}: dzt not 0 where a*y+b <= 0")
    same_bits(torch, "head_bwd", label, dname, got, fh.head_bwd(*bwd))


def judge_head_mc(torch, fh, tjudge, k, label, dname):
    """K11 forward and backward against plain: the confusion matrix
    exactly, dzt exactly 0 wherever the plain version's a*y+b is not above
    0, and a second launch of each giving the same bits."""
    fwd = (k["y"], k["t"], k["aff2"], k["w"], k["hb"])
    bwd = (k["y"], k["t"], k["aff4"], k["w"], k["hb"], k["gsc"])
    got, want = fh.head_fwd_sums_mc(*fwd), fh.head_fwd_sums_mc_reference(*fwd)
    tjudge("head_fwd_mc", label + " sums", dname, [(got, want)], sums=True)
    nc = k["w"].shape[1]
    cm, cm_want = got[:, 3 * nc + 1:], want[:, 3 * nc + 1:]
    same = torch.equal(cm, cm_want)
    print(f"  head_fwd_mc {label} {dname}: confusion matrix {'exact' if same else 'DIFFERS'} "
          f"({int(cm.sum().item())} pixels, {int(cm.reshape(-1, nc, nc)[:, :, 1].sum().item())} "
          "predicted as the tied second class)")
    if not same:
        raise AssertionError(f"head_fwd_mc {label} {dname}: confusion matrix differs")
    same_bits(torch, "head_fwd_mc", label, dname, [got], [fh.head_fwd_sums_mc(*fwd)])
    got, want = fh.head_bwd_mc(*bwd), fh.head_bwd_mc_reference(*bwd)
    tjudge("head_bwd_mc", label + " dzt", dname, [(got[0], want[0])])
    tjudge("head_bwd_mc", label + " S/T/dw/db", dname, list(zip(got[1:], want[1:])), sums=True)
    off = (k["y"].float() * k["aff4"][0] + k["aff4"][1]) <= 0
    if bool((got[0][off] != 0).any()):
        raise AssertionError(f"head_bwd_mc {label} {dname}: dzt not 0 where a*y+b <= 0")
    same_bits(torch, "head_bwd_mc", label, dname, got, fh.head_bwd_mc(*bwd))


def judge_k9(fs, tjudge, k, label, dname):
    """K9 on one block's (or link's) x and weights, against plain."""
    fwd = (k["x"], k["dw"], k["pw"])
    got, want = fs.sepconv_stats(*fwd), fs.sepconv_stats_reference(*fwd)
    tjudge("sepconv_stats", label + " y", dname, [(got[0], want[0])])
    tjudge("sepconv_stats", label + " sums", dname, list(zip(got[1:], want[1:])), sums=True)


def judge_block(fs, tjudge, k, label, dname):
    """K9 and K10 on one block's inputs, against plain."""
    judge_k9(fs, tjudge, k, label, dname)
    bwd = (k["x"], k["g"], k["dw"], k["pw"])
    got, want = fs.sepconv_bwd(*bwd), fs.sepconv_bwd_reference(*bwd)
    tjudge("sepconv_bwd", label + " dx", dname, [(got[0], want[0])])
    tjudge("sepconv_bwd", label + " ddw/dpw/dbias", dname, list(zip(got[1:], want[1:])),
           sums=True)


def judge_k1(ft, tjudge, k, label, dname):
    """K1 on one chain link's inputs, against plain."""
    got = ft.chain_fwd(k["x"], k["dw"], k["pw"], k["aff2"], k["drop"])
    want = ft.chain_fwd_reference(k["x"], k["dw"], k["pw"], k["aff2"], k["drop"])
    tjudge("chain_fwd", label + " y", dname, [(got[0], want[0])])
    tjudge("chain_fwd", label + " sums", dname, [(got[1], want[1]), (got[2], want[2])],
           sums=True)


def judge_link(ft, tjudge, k, label, dname, in_aff, mc):
    """K1 and K2 on one chain link's inputs, against plain."""
    judge_k1(ft, tjudge, k, label, dname)
    args = (k["x"], k["g"], k["y"], k["aff4"], k["comb"], k["dw"], k["pw"], mc, k["drop"])
    got, want = ft.chain_bwd(*args), ft.chain_bwd_reference(*args)
    tjudge("chain_bwd", label + " dx", dname, [(got[0], want[0])])
    pairs = [(got[1], want[1]), (got[2], want[2])]
    if in_aff:
        pairs.append((got[3], want[3]))
    tjudge("chain_bwd", label + " ddw/dpw/st", dname, pairs, sums=True)


def judge_bwd(ft, fs, tjudge, k, label, dname, in_aff, mc):
    """K2 and K10 on one link's inputs, against plain (K10 takes the link's
    x, g and weights)."""
    args = (k["x"], k["g"], k["y"], k["aff4"], k["comb"], k["dw"], k["pw"], mc, k["drop"])
    got, want = ft.chain_bwd(*args), ft.chain_bwd_reference(*args)
    tjudge("chain_bwd", label + " dx", dname, [(got[0], want[0])])
    pairs = [(got[1], want[1]), (got[2], want[2])] + ([(got[3], want[3])] if in_aff else [])
    tjudge("chain_bwd", label + " ddw/dpw/st", dname, pairs, sums=True)
    bwd = (k["x"], k["g"], k["dw"], k["pw"])
    got, want = fs.sepconv_bwd(*bwd), fs.sepconv_bwd_reference(*bwd)
    tjudge("sepconv_bwd", label + " dx", dname, [(got[0], want[0])])
    tjudge("sepconv_bwd", label + " ddw/dpw/dbias", dname, list(zip(got[1:], want[1:])),
           sums=True)


def judge_pool(torch, ft, tjudge, k, label, dname):
    """K3 and K4 on one encoder boundary's inputs, against plain; K4's dzt
    bit for bit (the ReLU mask and the first-max rule on the plain
    version's roundings), and a second K4 launch giving the same bits."""
    a, b = k["aff4"][0], k["aff4"][1]
    tjudge("tail_pool", label, dname,
           list(zip(ft.tail_pool(k["y"], a, b), ft.tail_pool_reference(k["y"], a, b))))
    judge_pool_bwd(torch, ft, tjudge, k, label, dname)


def judge_pool_bwd(torch, ft, tjudge, k, label, dname):
    """K4 against plain: dzt bit for bit, S and T under the sums' bar, and a
    second launch giving the same bits."""
    args = (k["y"], k["gs"], k["gp"], k["aff4"])
    got, want = ft.tail_pool_bwd(*args), ft.tail_pool_bwd_reference(*args)
    tjudge("tail_pool_bwd", label + " dzt", dname, [(got[0], want[0])])
    tjudge("tail_pool_bwd", label + " S/T", dname, [(got[1], want[1])], sums=True)
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"tail_pool_bwd {label} {dname}: dzt differs from plain")
    same_bits(torch, "tail_pool_bwd", label, dname, got, ft.tail_pool_bwd(*args))


def link_label(name, c, f, h, in_aff, drop, mc):
    mode = ("affine " if in_aff else "") + ("dropout " if drop else "") + ("mask " if mc else "")
    return f"{name} {c}->{f}@{h} {mode or 'plain '}".rstrip()


def check_train_kernels(torch, ft, fu, fh, fs, rnd, dev, dtypes, tjudge):
    """Phase 7: K1-K6 and K9-K11 against their plain versions at every path shape."""
    from unet_image_segmentation_tpu_torch.ops.kernels import build
    from unet_image_segmentation_tpu_torch.troubleshoot.link_floors import link_inputs

    sms = build.sm_count(dev)
    print(f"K5/K6/K11 training kernels vs plain, batch {BATCH_CHECK}, TF32 off:")
    for dname, dtype in dtypes.items():
        for name, c, f, h in FEEDS:
            k = upconcat_case(torch, rnd, dev, dtype, BATCH_CHECK, c, f, h)
            judge_feed(fu, tjudge, k, f"{name} {c}@{h}->{2 * f}@{2 * h}", dname)
        k = head_case(torch, rnd, dev, dtype, BATCH_CHECK)
        zeros = ((k["y"].float() * k["aff4"][0] + k["aff4"][1]) == 0).float().mean().item()
        judge_head(torch, fh, tjudge, k, f"dec1 F={FILTERS[0]}@{IMAGE} (a*y+b exactly 0 on "
                   f"{zeros:.3f} of the values)", dname)
        for px, f, nc in MC_HEAD_CASES:
            k = head_mc_case(torch, rnd, dev, dtype, BATCH_CHECK, px, f, nc)
            zeros = ((k["y"].float() * k["aff4"][0] + k["aff4"][1]) == 0).float().mean().item()
            judge_head_mc(torch, fh, tjudge, k, f"softmax head {nc} classes F={f}@{px} (a*y+b "
                          f"exactly 0 on {zeros:.3f} of the values)", dname)
        del k

    print(f"K9/K10 per-block training kernels vs plain, batch {BATCH_CHECK}, TF32 off:")
    for dname, dtype in dtypes.items():
        for name, c, f, h, *_ in LINKS:
            k = block_case(torch, rnd, dev, dtype, BATCH_CHECK, c, f, h)
            judge_block(fs, tjudge, k, f"block {name} {c}->{f}@{h}", dname)

    print(f"K1-K4 training kernels vs plain, batch {BATCH_CHECK}, TF32 off:")
    for dname, dtype in dtypes.items():
        for name, c, f, h, in_aff, drop, mc in LINKS:
            k = link_inputs(rnd, dev, dtype, BATCH_CHECK, c, f, h, in_aff, drop)
            judge_link(ft, tjudge, k, link_label(name, c, f, h, in_aff, drop, mc), dname,
                       in_aff, mc)
        for name, f, h in POOLS:
            k = pool_case(torch, rnd, dev, dtype, BATCH_CHECK, f, h)
            zc = ft.tail_pool_reference(k["y"], k["aff4"][0], k["aff4"][1])[0].float()
            win = zc.reshape(BATCH_CHECK, h // 2, 2, h // 2, 2, f)
            ties = ((win == win.amax(dim=(2, 4), keepdim=True)).sum(dim=(2, 4)) > 1)
            judge_pool(torch, ft, tjudge, k, f"{name} F={f}@{h} (windows with a tied max "
                       f"{ties.float().mean().item():.2f})", dname)

    print(f"K1/K9 and K2/K10 vs plain at other shapes, batch "
          f"{' and '.join(map(str, LINK_RAGGED_BATCHES))}, TF32 off:")
    stream = rnd.gen.get_state()  # these cases leave the later phases' seeded inputs as they were
    for dname, dtype in dtypes.items():
        for batch in LINK_RAGGED_BATCHES:
            for name, c, f, h, w, in_aff, drop, mc in LINK_RAGGED:
                k = link_inputs(rnd, dev, dtype, batch, c, f, h, in_aff, drop, w)
                link = f"{link_label(name, c, f, f'{h}x{w}', in_aff, drop, mc)} batch {batch}"
                fwd = ft.fwd_plan(batch, h, w, c, f, dtype, sms)
                label = f"{link}, cluster {fwd.n} x {fwd.s}, {fwd.per} tiles a cluster"
                judge_k1(ft, tjudge, k, label, dname)
                judge_k9(fs, tjudge, k, f"{link} (x, dw, pw)", dname)
                plan = ft.chain_bwd_plan(batch, h, w, c, f, dtype)
                label = (f"{link}, slices {plan.grid_a[1]} x {plan.wc}, dpw {plan.tm}x{plan.tn} "
                         f"x {plan.splits} splits")
                judge_bwd(ft, fs, tjudge, k, label, dname, in_aff, mc)
    print(f"K6 vs plain at other feeds, batch {' and '.join(map(str, FEED_RAGGED_BATCHES))}, "
          "TF32 off:")
    for dname, dtype in dtypes.items():
        for batch in FEED_RAGGED_BATCHES:
            for name, c, f, h, w in FEED_RAGGED:
                k = upconcat_case(torch, rnd, dev, dtype, batch, c, f, h, w)
                plan = fu.upconcat_plan(batch, h, w, c, f, dtype, sms)
                judge_feed(fu, tjudge, k, f"{name} {c}@{h}x{w}->{2 * f} batch {batch}, "
                           f"{plan.tiles_fwd}/{plan.tiles_dx} column tiles, {plan.splits} "
                           "d_kernel splits", dname)
    batches = " and ".join(map(str, POOL_HEAD_RAGGED_BATCHES))
    print(f"K4, K5 and K11 vs plain at other shapes, batch {batches}, TF32 off:")
    for dname, dtype in dtypes.items():
        for batch in POOL_HEAD_RAGGED_BATCHES:
            for name, f, h, w in POOL_RAGGED:
                k = pool_case(torch, rnd, dev, dtype, batch, f, h, w)
                plan = ft.pool_bwd_plan(batch, h, w, f, dtype, sms)
                judge_pool_bwd(torch, ft, tjudge, k, f"{name} F={f}@{h}x{w} batch {batch}, "
                               f"{plan.strips} strips of {plan.n} windows on {plan.ctas} CTAs",
                               dname)
            for name, f, h, w in HEAD_RAGGED:
                f = HEAD_WIDEST[dname] if f is None else f
                if not fh.head_supported(f, dtype):
                    continue
                k = head_case(torch, rnd, dev, dtype, batch, f, h, w)
                plan = fh.head_plan(batch, h * w, f, dtype, sms)
                judge_head(torch, fh, tjudge, k, f"{name} F={f}@{h}x{w} batch {batch}, "
                           f"{plan.runs} runs of {plan.pixels} px in groups of {plan.lanes} "
                           f"lanes on {plan.ctas} CTAs", dname)
                for nc in range(2, fh.MAX_MC_CLASSES + 1):
                    k = head_mc_case(torch, rnd, dev, dtype, batch, h, f, nc, w)
                    plan = fh.head_plan(batch, h * w, f, dtype, sms, nc)
                    judge_head_mc(torch, fh, tjudge, k, f"softmax {nc} classes {name} F={f}@{h}x"
                                  f"{w} batch {batch}, {plan.runs} runs of {plan.pixels} px in "
                                  f"groups of {plan.lanes} lanes on {plan.ctas} CTAs", dname)
    rnd.gen.set_state(stream)


class MemoryDataset:
    """In-memory stand-in for the loaders: ``len`` and ``batches``."""

    def __init__(self, images, masks):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def batches(self, batch_size, epoch=0, steps=None, num_workers=0):
        n = len(self) // batch_size if steps is None else min(len(self) // batch_size, steps)
        for b in range(n):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            yield self.images[sl], self.masks[sl]


def cosine(a, b):
    """Cosine of two tensors in fp64, with no floor on the norms (the
    gradients of a deep BatchNorm-free U-Net are tiny); 1 if both are 0."""
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    if na == 0.0 or nb == 0.0:
        return 1.0 if na == nb else 0.0
    return (a @ b).item() / (na * nb)


def rel_max(got, want):
    """max|got - want| / max|want| of two tensors, in fp32 (fp64 where either
    is fp64)."""
    wide = 8 in (got.element_size(), want.element_size())
    got, want = (got.double(), want.double()) if wide else (got.float(), want.float())
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def train_ab(torch, dev, smi, base, x, m, launches, expect, variant=None, profile=True):
    """3 train steps of config dict ``base`` with the kernels against 3 of
    the composed path, in fp32 and bf16, under phase 8's bars; ``expect``
    the launches of every kernels-on step, added into ``launches``; images/s
    in turns, peak memory and (``profile``) a profiled kernels-on step. With
    ``variant`` (label, model overrides, launches) also :func:`variant_ab`.
    Returns the numbers by dtype."""
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.state import Config, create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    out = {}
    for dname in ("float32", "bfloat16"):
        runs = {}
        for use_pallas in (True, False):
            d = json.loads(json.dumps(base))
            d["model"].update(compute_dtype=dname, use_pallas=use_pallas)
            cfg = Config.from_dict(d)
            model = build_unet(cfg.model, device=dev,
                               generator=torch.Generator().manual_seed(SEED))
            state = create_train_state(cfg, model=model, device=dev)
            step = make_train_step(model, cfg.train.loss)
            losses, grads = [], None
            torch.cuda.reset_peak_memory_stats()
            for i in range(TRAIN_STEPS):
                if use_pallas:
                    reset_train_counts()
                loss = float(step(state, x, m)["loss"])
                torch.cuda.synchronize()
                if use_pallas:
                    counts = train_counts()
                    print(f"  {dname} kernels-on step {i + 1} launches {counts}")
                    if counts != expect:
                        raise AssertionError(f"expected {expect} per step, got {counts}")
                    for name, n in counts.items():
                        launches[name] = launches.get(name, 0) + n
                losses.append(loss)
                if i == 0:
                    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            runs[use_pallas] = dict(
                state=state, step=step, losses=losses, grads=grads,
                stats={n: b.detach().clone() for n, b in model.named_buffers()},
                peak_gb=torch.cuda.max_memory_allocated() / 2**30,
            )
        on, off = runs[True], runs[False]
        for i, (lo, lf) in enumerate(zip(on["losses"], off["losses"])):
            rel = abs(lo - lf) / abs(lf)
            ok = np.isfinite(lo) and rel <= TRAIN_LOSS_TOL[dname]
            print(f"  {dname} step {i + 1} loss: kernels {lo:.6f} composed {lf:.6f} rel "
                  f"{rel:.2e} (tol {TRAIN_LOSS_TOL[dname]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{dname} step {i + 1}: loss disagrees")
        g_rel = {n: rel_max(on["grads"][n], g) for n, g in off["grads"].items()}
        g_cos = {n: torch.nn.functional.cosine_similarity(
            on["grads"][n].double().flatten(), g.double().flatten(), dim=0).item()
            for n, g in off["grads"].items()}
        worst, worst_cos = max(g_rel, key=g_rel.get), min(g_cos, key=g_cos.get)
        print(f"  {dname} step 1 gradients, {len(g_rel)} tensors, kernels vs composed: "
              f"max rel err {g_rel[worst]:.2e} at {worst}, median "
              f"{float(np.median(list(g_rel.values()))):.2e}; min cosine "
              f"{g_cos[worst_cos]:.8f} at {worst_cos}")
        if dname == "float32":
            ref = off["grads"]
            ok = all(np.isfinite(v) for v in g_rel.values()) and \
                g_rel[worst] <= TRAIN_GRAD_TOL and g_cos[worst_cos] >= TRAIN_GRAD_COS
            print(f"    held: max rel err <= {TRAIN_GRAD_TOL:g} and cosine >= "
                  f"{TRAIN_GRAD_COS} per tensor {'ok' if ok else 'FAIL'}")
        else:
            # bf16 against the fp32 composed gradients: the kernels' error no
            # worse than the composed bf16 path's own, per tensor
            err_on = {n: rel_max(on["grads"][n], g) for n, g in ref.items()}
            err_off = {n: rel_max(off["grads"][n], g) for n, g in ref.items()}
            excess = {n: err_on[n] - BF16_GRAD_FACTOR * err_off[n] for n in ref}
            w = max(excess, key=excess.get)
            ok = all(np.isfinite(v) for v in err_on.values()) and \
                excess[w] <= BF16_GRAD_SLACK
            print(f"    held against the fp32 composed gradients: kernels bf16 max rel err "
                  f"{max(err_on.values()):.2e}, composed bf16 {max(err_off.values()):.2e}; "
                  f"per tensor kernels <= {BF16_GRAD_FACTOR:g} x composed + "
                  f"{BF16_GRAD_SLACK:g} (worst {w}: {err_on[w]:.2e} vs {err_off[w]:.2e}) "
                  f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{dname}: step-1 gradients disagree")
        s_rel = {n: rel_max(on["stats"][n], b) for n, b in off["stats"].items()}
        worst_s = max(s_rel, key=s_rel.get)
        print(f"  {dname} BatchNorm running stats after step {TRAIN_STEPS}, {len(s_rel)} "
              f"buffers, kernels vs composed: max rel err {s_rel[worst_s]:.2e} at {worst_s}")
        if dname == "float32":
            ref_stats = off["stats"]
            ok = s_rel[worst_s] <= TRAIN_STATS_TOL
            print(f"    held: max rel err <= {TRAIN_STATS_TOL:g} {'ok' if ok else 'FAIL'}")
        else:
            err_on = {n: rel_max(on["stats"][n], b) for n, b in ref_stats.items()}
            err_off = {n: rel_max(off["stats"][n], b) for n, b in ref_stats.items()}
            excess = {n: err_on[n] - BF16_GRAD_FACTOR * err_off[n] for n in ref_stats}
            w = max(excess, key=excess.get)
            ok = excess[w] <= BF16_GRAD_SLACK
            print(f"    held against the fp32 composed run: kernels bf16 max rel err "
                  f"{max(err_on.values()):.2e}, composed bf16 {max(err_off.values()):.2e}; "
                  f"per buffer kernels <= {BF16_GRAD_FACTOR:g} x composed + "
                  f"{BF16_GRAD_SLACK:g} (worst {w}: {err_on[w]:.2e} vs {err_off[w]:.2e}) "
                  f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{dname}: BatchNorm running stats disagree")
        rates = {}
        for label in ("on", "off", "on", "off"):
            run = runs[label == "on"]
            rates.setdefault(label, []).append(
                train_images_per_second(run["step"], run["state"], x, m, torch))
        print(f"  {dname} train images/s at batch {x.shape[0]}: " + ", ".join(
            f"kernels {k} {' / '.join(f'{r:.1f}' for r in v)}" for k, v in rates.items()) +
            f"; peak memory kernels on {on['peak_gb']:.2f} GiB, composed {off['peak_gb']:.2f} "
            f"GiB [{smi}]")
        if variant is not None:
            out[dname] = {"variant": variant_ab(torch, dev, smi, base, x, m, dname, on, variant,
                                                launches)}
        prof = attributed_step(torch, dev, on["step"], on["state"], x, m, base, dname,
                               expect) if profile else None
        out.setdefault(dname, {}).update(
            losses_on=on["losses"], losses_off=off["losses"], grad_rel=g_rel, stats_rel=s_rel,
            images_per_s=rates, peak_gib={"on": on["peak_gb"], "off": off["peak_gb"]},
            profile=prof)
        del runs, on, off
    return out


def variant_ab(torch, dev, smi, base, x, m, dname, on, variant, launches):
    """One kernels-on step of ``base`` with the model overrides of
    ``variant`` = (label, overrides, launches), its launches checked, then
    its train images/s against the kernels-on run ``on`` in turns."""
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.state import Config, create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    label, overrides, expect = variant
    d = json.loads(json.dumps(base))
    d["model"].update(compute_dtype=dname, use_pallas=True, **overrides)
    cfg = Config.from_dict(d)
    model = build_unet(cfg.model, device=dev, generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(cfg, model=model, device=dev)
    step = make_train_step(model, cfg.train.loss)
    reset_train_counts()
    loss = float(step(state, x, m)["loss"])
    torch.cuda.synchronize()
    counts = train_counts()
    print(f"  {dname} kernels-on step with {label}: loss {loss:.6f} (kernels-on step 1 "
          f"{on['losses'][0]:.6f}), launches {counts}")
    if counts != expect or not np.isfinite(loss):
        raise AssertionError(f"{label}: expected {expect}, got {counts}")
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    rates = {}
    for which in ("on", label, "on", label):
        run = (on["step"], on["state"]) if which == "on" else (step, state)
        rates.setdefault(which, []).append(train_images_per_second(*run, x, m, torch))
    print(f"  {dname} A/B train images/s at batch {x.shape[0]}: " + ", ".join(
        f"{k} {' / '.join(f'{r:.1f}' for r in v)}" for k, v in rates.items()) + f" [{smi}]")
    return {"loss_step1": loss, "images_per_s": rates}


def eval_ab(torch, dev, smi, base, x, m, launches):
    """Phase 8's eval step (``make_eval_step``, which ``fit`` runs on every
    validation batch) on config dict ``base`` at its batch: kernels on (K8
    in each of the 18 blocks) against the composed path with the same seeded
    weights and BatchNorm statistics (recalibrated on the batch), in fp32
    and bf16; the loss and metrics held under phase 5's
    module-path bars (the loss and dice within ``PROB_TOL``; the confusion
    matrices as pixel shares, the soft one within ``PROB_TOL``, the
    thresholded one within ``1 - MASK_MIN_AGREE``); then images/s in turns."""
    from unet_image_segmentation_tpu_torch.models.unet import build_unet, recalibrate_batch_norm
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.train.state import Config
    from unet_image_segmentation_tpu_torch.train.steps import make_eval_step

    out = {}
    for dname in ("float32", "bfloat16"):
        runs, state = {}, None
        for use_pallas in (False, True):
            d = json.loads(json.dumps(base))
            d["model"].update(compute_dtype=dname, use_pallas=use_pallas)
            cfg = Config.from_dict(d)
            model = build_unet(cfg.model, device=dev,
                               generator=torch.Generator().manual_seed(SEED))
            if use_pallas:
                model.load_state_dict(state)
            else:   # BatchNorm statistics of the batch, so the outputs are not a constant 0.5
                recalibrate_batch_norm(model, x)
                state = model.state_dict()
            step = make_eval_step(model, cfg.train.loss)
            fs.reset_launch_counts()
            metrics = step(None, x, m)
            torch.cuda.synchronize()
            k8 = fs.LAUNCHES["sepconv_block"]
            if k8 != (EVAL_K8_LAUNCHES if use_pallas else 0) or not all(
                    torch.isfinite(v.float()).all().item() for v in metrics.values()):
                raise AssertionError(f"eval step {dname} use_pallas={use_pallas}: {k8} K8 "
                                     f"launches, metrics {metrics}")
            if use_pallas:
                launches["sepconv_block"] = launches.get("sepconv_block", 0) + k8
            runs[use_pallas] = (step, {k: v.double().cpu() for k, v in metrics.items()})
        on, off = runs[True][1], runs[False][1]
        diff, ok = {}, True
        for key, want in off.items():
            got = on[key]
            if want.dim() == 0:
                diff[key], bar = abs(got - want).item(), PROB_TOL[dname]
            else:   # pixel shares of a confusion matrix
                diff[key] = (got / got.sum() - want / want.sum()).abs().max().item()
                bar = 1 - MASK_MIN_AGREE[dname] if key == "cm_thresh" else PROB_TOL[dname]
            ok = ok and diff[key] <= bar
        print(f"  {dname} eval step at batch {x.shape[0]}, {EVAL_K8_LAUNCHES} K8 launches: loss "
              f"kernels {on['loss'].item():.6f} composed {off['loss'].item():.6f}, dice kernels "
              f"{on['dice'].item():.6f} composed {off['dice'].item():.6f}; max difference "
              + ", ".join(f"{k} {v:.2e}" for k, v in diff.items()) +
              f" (bars {PROB_TOL[dname]:g}, thresholded matrix {1 - MASK_MIN_AGREE[dname]:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"eval step {dname}: kernels disagree with the composed path")
        rates = {}
        for label in ("on", "off", "on", "off"):
            rates.setdefault(label, []).append(
                eval_images_per_second(runs[label == "on"][0], x, m, torch))
        print(f"  {dname} eval images/s at batch {x.shape[0]}: " + ", ".join(
            f"kernels {k} {' / '.join(f'{r:.1f}' for r in v)}" for k, v in rates.items()) +
            f" [{smi}]")
        out[dname] = {"loss_on": on["loss"].item(), "loss_off": off["loss"].item(),
                      "max_diff": diff, "images_per_s": rates}
        del runs
    return out


def train_path(torch, dev, smi, report, launches):
    """Phase 8: the training step at full width, kernels on against the
    composed path on the same card, then ``fit`` and a ``Predictor`` request.
    Returns fit's ``model_out`` (under ``build/phase8``)."""
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.checkpoint import load_inference_variables
    from unet_image_segmentation_tpu_torch.train.loop import fit
    from unet_image_segmentation_tpu_torch.train.state import Config, create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
        base = json.load(f)
    images, masks = synthetic_scenes(3 * BATCH_SERVE, IMAGE, SEED + 1, with_masks=True)
    x = torch.from_numpy(images[:BATCH_SERVE]).to(dev)
    m = torch.from_numpy(masks[:BATCH_SERVE]).to(dev)
    print(f"training path: {TRAIN_CONFIG} as it is (fused_head "
          f"{base['model'].get('fused_head', 'auto')}): U-Net {base['model']['filters']}"
          f" at {IMAGE}, batch {base['train']['batch_size']}, dropout "
          f"{base['model']['dropout_rate']}, {base['train']['loss']} loss, AdamW lr "
          f"{base['train']['learning_rate']} wd {base['train']['weight_decay']}; seeded "
          f"weights and dropout seeds; kernels on vs the composed path, {TRAIN_STEPS} steps each")
    report["train"] = train_ab(torch, dev, smi, base, x, m, launches, STEP_LAUNCHES)
    print(f"eval step: {TRAIN_CONFIG}'s model, make_eval_step (fit's validation) at batch "
          f"{x.shape[0]}, kernels on (K8) vs the composed path, seeded weights")
    report["eval"] = eval_ab(torch, dev, smi, base, x, m, launches)

    # PR 2's path: the same config with the composed head, kernels on
    d = json.loads(json.dumps(base))
    d["model"].update(fused_head="off", use_pallas=True)
    cfg = Config.from_dict(d)
    model = build_unet(cfg.model, device=dev, generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(cfg, model=model, device=dev)
    reset_train_counts()
    loss = float(make_train_step(model, cfg.train.loss)(state, x, m)["loss"])
    torch.cuda.synchronize()
    counts = train_counts()
    print(f"  {cfg.model.compute_dtype} kernels-on step with fused_head off: loss {loss:.6f}, "
          f"launches {counts}")
    if counts != STEP_LAUNCHES_HEAD_OFF or not np.isfinite(loss):
        raise AssertionError(f"fused_head off: expected {STEP_LAUNCHES_HEAD_OFF}, got {counts}")
    del model, state

    d = json.loads(json.dumps(base))
    tmp = os.path.join(ROOT, "build", "phase8")   # its best/ is phase 16's CLI input
    shutil.rmtree(tmp, ignore_errors=True)
    d["train"].update(epochs=1, model_out=os.path.join(tmp, "model"),
                      log_dir=os.path.join(tmp, "logs"))
    cfg = Config.from_dict(d)
    n_train = 2 * BATCH_SERVE
    t0 = time.perf_counter()
    res = fit(cfg, MemoryDataset(images[:n_train], masks[:n_train]),
              MemoryDataset(images[n_train:], masks[n_train:]), device=dev)
    print(f"  fit: 1 epoch, {n_train // BATCH_SERVE} steps + 1 validation batch in "
          f"{time.perf_counter() - t0:.1f} s, best {cfg.train.monitor} {res.best_score:.4f}")
    saved, _ = load_inference_variables(cfg.train.model_out)
    trained = res.state.model.state_dict()
    if saved.keys() != trained.keys() or not all(
            torch.equal(saved[k], trained[k].cpu()) for k in saved):
        raise AssertionError("best/ does not hold the trained weights and statistics")
    pred = Predictor(cfg.train.model_out, (IMAGE, IMAGE), compute_dtype="bfloat16",
                     use_pallas=True, device=dev)
    out = pred.predict(images[:1])
    if out.shape != (1, IMAGE, IMAGE, 1) or not np.isfinite(out).all() or \
            out.min() < 0 or out.max() > 1:
        raise AssertionError(f"Predictor on the fit checkpoint: bad output {out.shape}")
    print(f"  Predictor(use_pallas=True) on {cfg.train.model_out}/best answered a request: "
          f"probabilities in [{out.min():.3f}, {out.max():.3f}], foreground "
          f"{(out > 0.5).mean():.3f}")
    report["train"]["fit_best"] = res.best_score
    return cfg.train.model_out


def multiclass_path(torch, dev, smi, report, launches):
    """Phase 10: multiclass training at full width through K11."""
    with open(os.path.join(ROOT, MC_CONFIG)) as f:
        base = json.load(f)
    config_head = base["model"].get("fused_head", "auto")
    base["model"]["fused_head"] = "all"
    images, ids = multiclass_scenes(MC_BATCH, MC_IMAGE, SEED + 3)
    x, m = torch.from_numpy(images).to(dev), torch.from_numpy(ids).to(dev)
    share = [float((ids == c).mean()) for c in range(base["model"]["num_classes"])]
    print(f"multiclass training path: {MC_CONFIG} with fused_head all (the config's own: "
          f"{config_head}): U-Net {base['model']['filters']} at {MC_IMAGE}, "
          f"{base['model']['num_classes']} classes (pixel shares "
          f"{', '.join(f'{v:.3f}' for v in share)}), batch {base['train']['batch_size']}, "
          f"dropout {base['model']['dropout_rate']}, {base['train']['loss']} loss; kernels on vs "
          f"the composed path, {TRAIN_STEPS} steps each; then {config_head} vs all")
    if x.shape[0] != base["train"]["batch_size"]:
        raise AssertionError("the scenes must fill one batch of the config")
    report["multiclass"] = train_ab(
        torch, dev, smi, base, x, m, launches, MC_STEP_LAUNCHES,
        variant=(f"fused_head {config_head}", {"fused_head": config_head},
                 STEP_LAUNCHES_HEAD_OFF))
    for dname, rec in report["multiclass"].items():
        rows = rec["profile"]["per_kernel"]
        print(f"  {dname} K11 in the profiled step, device ms a step with every launch it makes: "
              + ", ".join(f"{name} {rows[name]['ms']:.4f} ms in {rows[name]['launches']:g} "
                          "launch(es)" for name in ("head_fwd_mc", "head_bwd_mc")))


# what utils/profiling.trace and profile_summary.check_complete say of a
# trace that lost device activity
LOST_TRACE = ("recorded no device time", "the trace lacks")


def traced(fn, label, attempts=TRACE_ATTEMPTS):
    """``fn(attempt)``, again up to ``attempts`` times while its trace lost
    device activity: on an H100 (PyTorch 2.11) torch.profiler has returned
    traces with no device time, or without a run of the kernels the host
    launched, more often the more profiler sessions the process had run
    before; the same traces came back whole in a fresh process."""
    for attempt in range(attempts):
        try:
            return fn(attempt)
        except (RuntimeError, AssertionError) as e:
            if not any(m in str(e) for m in LOST_TRACE) or attempt + 1 == attempts:
                raise
            print(f"  {label}: {e}; tracing again")


def k11_alone_launches(torch, dev, rnd):
    """Phase 7: K11's forward and backward at the multiclass path's shape
    (batch 8 of 512 px, dec1, 3 classes, bf16), traced alone: each launches
    its own kernel once and nothing else, no row-sum kernel in particular.
    Only the span's launches are counted; the lead-in (and lead-out)
    launches around it grow tenfold with each :func:`traced` attempt, up
    to a hundred."""
    from unet_image_segmentation_tpu_torch.ops import fused_head as fh
    from unet_image_segmentation_tpu_torch.troubleshoot import profile_summary
    from unet_image_segmentation_tpu_torch.utils.profiling import trace

    stream = rnd.gen.get_state()  # the later phases' seeded inputs stay as they were
    k = head_mc_case(torch, rnd, dev, torch.bfloat16, MC_BATCH, MC_IMAGE, FILTERS[0], 3)
    rnd.gen.set_state(stream)
    fwd = (k["y"], k["t"], k["aff2"], k["w"], k["hb"])
    bwd = (k["y"], k["t"], k["aff4"], k["w"], k["hb"], k["gsc"])
    fh.head_fwd_sums_mc(*fwd), fh.head_bwd_mc(*bwd)   # warm
    torch.cuda.synchronize()
    span = "chip_smoke.k11"

    def summarize(attempt):
        lead = 10 ** min(attempt, 2)
        with tempfile.TemporaryDirectory(prefix="unet_k11_") as tmp:
            with trace(tmp, dev):
                # a lead-in, as step_attribution leads in with a step
                for _ in range(lead):
                    fh.head_fwd_sums_mc(*fwd), fh.head_bwd_mc(*bwd)
                torch.cuda.synchronize()
                with torch.profiler.record_function(span):
                    fh.head_fwd_sums_mc(*fwd)
                    fh.head_bwd_mc(*bwd)
                torch.cuda.synchronize()
                for _ in range(lead - 1):
                    fh.head_fwd_sums_mc(*fwd), fh.head_bwd_mc(*bwd)
            return profile_summary.summarize(tmp, within=span)

    summary = traced(summarize, "K11 traced alone")
    profile_summary.check_complete(summary, "K11 traced alone")
    seen = {}
    for name, n in summary["launches"].items():   # kernels and copies
        entry = roofline.entry_of(name) or name
        seen[entry] = seen.get(entry, 0) + n
    want = {"head_fwd_mc_kernel": 1, "head_bwd_mc_kernel": 1}
    print(f"  K11 forward and backward traced alone (bf16, batch {MC_BATCH} of {MC_IMAGE} px): "
          f"kernels launched {seen}")
    if seen != want:
        raise AssertionError(f"K11 launched {seen}, expected {want} (no row-sum launch)")
    return {"launches": seen, "kernel_ms": {roofline.entry_of(n) or n: t
                                            for n, t in summary["kernels"].items()}}


@contextlib.contextmanager
def plain_per_block(fs):
    """The per-block training path with K9/K10's plain versions in place of
    the kernels, on the card (the bf16 yardstick of phase 11)."""
    saved = fs.sepconv_stats, fs.sepconv_bwd
    fs.sepconv_stats, fs.sepconv_bwd = fs.sepconv_stats_reference, fs.sepconv_bwd_reference
    try:
        yield
    finally:
        fs.sepconv_stats, fs.sepconv_bwd = saved


@contextlib.contextmanager
def recorded_bwd(fs, into):
    """K10 as it is, the inputs of its call kept in ``into`` (phase 11's
    dpw digits start from them)."""
    saved = fs.sepconv_bwd

    def record(x, g, dw, pw):
        into.update(x=x.detach(), g=g.detach(), dw=dw.detach(), pw=pw.detach())
        return saved(x, g, dw, pw)

    fs.sepconv_bwd = record
    try:
        yield
    finally:
        fs.sepconv_bwd = saved


def dpw_digits_path(fs, smi, report, k10_inputs):
    """Phase 11's dpw digits (``troubleshoot/dpw_digits.py``): K10's fp32 dpw
    five ways at enc1.1, from the inputs the block's K10 took at batch 32,
    and at batch 2 from the tool's seeded inputs (those of the CPU's JAX
    comparison, ``tests/dpw_digits_cpu.py``). Its K10 launches compare; they
    leave the counts as they were."""
    from unet_image_segmentation_tpu_torch.troubleshoot import dpw_digits as dd

    counts = dict(fs.LAUNCHES)
    t0 = time.perf_counter()
    data = {k: v.float().cpu().numpy() for k, v in k10_inputs.items()}
    results = [dd.run(data["x"].shape[0], data=data), dd.run(2)]
    fs.LAUNCHES.update(counts)
    for res in results:
        print(f"  {dd.line(res)} [{smi}]")
    print(f"  dpw digits in {time.perf_counter() - t0:.1f} s (the orders emulated on the host)")
    report["dpw_digits"] = results


def block_train_path(torch, dev, smi, report, launches, dtypes):
    """Phase 11: per-block training (K9/K10) of the 18 ConvBlocks at batch
    32 against the composed block, and a BatchNorm-free U-Net train step
    (K8 forward, composed backward) against its composed step."""
    from unet_image_segmentation_tpu_torch.models.layers import ConvBlock
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.train.state import Config, create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    print(f"per-block training: the 18 ConvBlocks of the {IMAGE} px U-Net with BatchNorm and "
          f"use_pallas at batch {BATCH_SERVE}, kernels (K9/K10) vs the composed block; fp32 "
          f"held to {BLOCK_OUT_TOL:g} (output) and {BLOCK_GRAD_TOL:g} (gradients, running "
          f"statistics); against the fp64 composed block, output and dx <= {FP64_FACTOR:g} x "
          f"the fp32 composed block's distance, the rest <= {BLOCK_GRAD_TOL:g}; the cotangent "
          f"0 at the ReLU decisions the three forwards take apart, at most {RELU_APART_MAX}; "
          f"bf16 against "
          f"the fp32 composed block, kernels <= {BF16_GRAD_FACTOR:g} x the plain per-block path "
          f"+ {BF16_GRAD_SLACK:g} per tensor")
    report["block_train"] = {}
    k10_inputs = {}
    gen = torch.Generator().manual_seed(SEED + 5)
    for name, c, f, h, *_ in LINKS:
        x = torch.rand(BATCH_SERVE, h, h, c, generator=gen) * 2 - 1
        g = torch.rand(BATCH_SERVE, h, h, f, generator=gen) * 2 - 1
        seed = int(torch.randint(0, 2**31, (1,), generator=gen))
        decided = []   # the ReLU decisions of the fp32 kernels, fp32 and fp64 composed
        for use_pallas, dt in ((True, torch.float32), (False, torch.float32),
                               (False, torch.float64)):
            blk = ConvBlock(c, f, use_pallas=use_pallas,
                            generator=torch.Generator().manual_seed(seed)).to(dev, dt)
            with torch.no_grad():
                decided.append(blk(x.to(dev, dt), train=True) > 0)
        split = ((decided[0] != decided[1]) | (decided[1] != decided[2])).cpu()
        n_k32, n_c64 = int((decided[0] != decided[1]).sum()), int((decided[1] != decided[2]).sum())
        g = torch.where(split, torch.zeros_like(g), g)
        del decided, blk
        res = {}
        for dname, path in (("float32", "kernels"), ("float32", "composed"),
                            ("float64", "composed"), ("bfloat16", "kernels"),
                            ("bfloat16", "plain"), ("bfloat16", "composed")):
            blk = ConvBlock(c, f, use_pallas=path != "composed",
                            generator=torch.Generator().manual_seed(seed)).to(dev)
            if dname == "float64":
                blk = blk.double()
            xi = x.to(dev, dtypes.get(dname, torch.float64)).detach().requires_grad_()
            fs.reset_launch_counts()
            if path == "plain":
                around = plain_per_block(fs)
            elif (name, dname, path) == (DPW_BLOCK, "float32", "kernels"):
                around = recorded_bwd(fs, k10_inputs)
            else:
                around = contextlib.nullcontext()
            with around:
                out = blk(xi, train=True)
                (out.double() * g.to(dev)).sum().backward()
            torch.cuda.synchronize()
            counts = dict(fs.LAUNCHES)
            if counts != (BLOCK_LAUNCHES if path == "kernels" else dict.fromkeys(counts, 0)):
                raise AssertionError(f"block {name} {dname} {path}: launches {counts}")
            if path == "kernels":
                for kname, n in counts.items():
                    launches[kname] = launches.get(kname, 0) + n
            res[(dname, path)] = dict(
                out=out.detach(), dx=xi.grad,
                **{n: p.grad for n, p in blk.named_parameters()},
                **{n: b.detach() for n, b in blk.named_buffers()})
        ref, exact = res[("float32", "composed")], res.pop(("float64", "composed"))
        err = {key: {k: rel_max(v, ref[k]) for k, v in res[key].items()}
               for key in res if key != ("float32", "composed")}
        err32, on16 = err[("float32", "kernels")], err[("bfloat16", "kernels")]
        plain16, comp16 = err[("bfloat16", "plain")], err[("bfloat16", "composed")]
        excess = {k: on16[k] - BF16_GRAD_FACTOR * plain16[k] for k in ref}
        worst32 = max((k for k in err32 if k != "out"), key=err32.get)
        w16 = max(excess, key=excess.get)
        # the fp64 witness: each fp32 path's distance from the fp64 composed block
        k64 = {k: rel_max(v, exact[k]) for k, v in res[("float32", "kernels")].items()}
        c64 = {k: rel_max(v, exact[k]) for k, v in ref.items()}
        ratio = {k: k64[k] / max(c64[k], 1e-30) for k in ("out", "dx")}
        w64 = max((k for k in k64 if k not in ratio), key=k64.get)
        ok = err32["out"] <= BLOCK_OUT_TOL and err32[worst32] <= BLOCK_GRAD_TOL and \
            excess[w16] <= BF16_GRAD_SLACK and all(np.isfinite(v) for v in on16.values()) and \
            int(split.sum()) <= RELU_APART_MAX and max(ratio.values()) <= FP64_FACTOR and \
            k64[w64] <= BLOCK_GRAD_TOL
        print(f"  {name} {c}->{f}@{h}: ReLU decisions apart of {split.numel()}: {n_k32} fp32 "
              f"kernels/composed, {n_c64} fp32/fp64 composed, {int(split.sum())} in all; fp32 out "
              f"{err32['out']:.2e}, worst other {err32[worst32]:.2e} ({worst32}); vs fp64 "
              f"(kernels / composed): out {k64['out']:.2e} / {c64['out']:.2e} "
              f"({ratio['out']:.1f}x), dx {k64['dx']:.2e} / {c64['dx']:.2e} "
              f"({ratio['dx']:.1f}x), worst other {w64} {k64[w64]:.2e} / {c64[w64]:.2e}; "
              f"bf16 vs fp32 composed, max over tensors: kernels "
              f"{max(on16.values()):.2e}, plain per-block {max(plain16.values()):.2e}, "
              f"composed {max(comp16.values()):.2e}; worst excess at {w16}: kernels "
              f"{on16[w16]:.2e} vs plain {plain16[w16]:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"block {name}: kernels disagree with the plain/composed block")
        report["block_train"][name] = {"fp32": err32, "bf16_kernels": on16,
                                       "bf16_plain": plain16, "bf16_composed": comp16,
                                       "fp32_kernels_vs_fp64": k64, "fp32_composed_vs_fp64": c64,
                                       "relu_decisions_apart": int(split.sum())}
        del res, ref, exact
    dpw_digits_path(fs, smi, report, k10_inputs)
    del k10_inputs

    with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
        base = json.load(f)
    images, masks = synthetic_scenes(BATCH_SERVE, IMAGE, SEED + 6, with_masks=True)
    x, m = torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev)
    print(f"BatchNorm-free U-Net: {TRAIN_CONFIG} with use_batch_norm off (dropout "
          f"{base['model']['dropout_rate']}, the same seeds), one step kernels on (K8 forward, "
          "the composed backward) vs the composed step")
    report["bn_off"] = {}
    ref_grads = None
    for dname in dtypes:
        runs = {}
        for use_pallas in (True, False):
            d = json.loads(json.dumps(base))
            d["model"].update(compute_dtype=dname, use_pallas=use_pallas, use_batch_norm=False)
            cfg = Config.from_dict(d)
            model = build_unet(cfg.model, device=dev,
                               generator=torch.Generator().manual_seed(SEED))
            state = create_train_state(cfg, model=model, device=dev)
            step = make_train_step(model, cfg.train.loss)
            fs.reset_launch_counts()
            loss = float(step(state, x, m)["loss"])
            torch.cuda.synchronize()
            k8 = fs.LAUNCHES["sepconv_block"]
            if k8 != (BN_OFF_K8_LAUNCHES if use_pallas else 0) or not np.isfinite(loss):
                raise AssertionError(f"BatchNorm-free step: {k8} K8 launches, loss {loss}")
            runs[use_pallas] = dict(loss=loss, step=step, state=state, grads={
                n: p.grad.detach().clone() for n, p in model.named_parameters()})
        on, off = runs[True], runs[False]
        rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
        if dname == "float32":
            ref_grads = off["grads"]
        err_on = {n: rel_max(on["grads"][n], g) for n, g in ref_grads.items()}
        err_off = {n: rel_max(off["grads"][n], g) for n, g in ref_grads.items()}
        cos = min(cosine(on["grads"][n], g) for n, g in ref_grads.items())
        if dname == "float32":
            ok = max(err_on.values()) <= TRAIN_GRAD_TOL and cos >= TRAIN_GRAD_COS
            held = f"max rel err <= {TRAIN_GRAD_TOL:g} and cosine >= {TRAIN_GRAD_COS}"
        else:
            excess = {n: err_on[n] - BF16_GRAD_FACTOR * err_off[n] for n in ref_grads}
            ok = max(excess.values()) <= BF16_GRAD_SLACK
            held = (f"against the fp32 composed gradients, kernels <= {BF16_GRAD_FACTOR:g} x "
                    f"composed bf16 ({max(err_off.values()):.2e}) + {BF16_GRAD_SLACK:g}")
        ok = ok and rel <= TRAIN_LOSS_TOL[dname]
        rates = {}
        for label in ("on", "off", "on", "off"):
            run = runs[label == "on"]
            rates.setdefault(label, []).append(
                train_images_per_second(run["step"], run["state"], x, m, torch))
        print(f"  {dname}: {BN_OFF_K8_LAUNCHES} K8 launches; loss kernels {on['loss']:.6f} "
              f"composed {off['loss']:.6f} rel {rel:.2e}; gradients max rel err "
              f"{max(err_on.values()):.2e}, min cosine {cos:.8f}, held {held} "
              f"{'ok' if ok else 'FAIL'}; train images/s " + ", ".join(
                  f"kernels {k} {' / '.join(f'{r:.1f}' for r in v)}" for k, v in rates.items()) +
              f" [{smi}]")
        if not ok:
            raise AssertionError(f"BatchNorm-free step {dname}: kernels disagree with composed")
        report["bn_off"][dname] = {"loss_rel": rel, "grad_rel": err_on, "images_per_s": rates}
        del runs, on, off


def check_attribution(prof, expect, label):
    """The profiler saw each kernel of the step at the launches ``expect``
    (wrapper -> a step) that the wrappers' counters also saw."""
    want = {k: v for k, v in expect.items() if v}
    seen = {k: row["launches"] for k, row in prof["per_kernel"].items() if k in roofline.KERNELS}
    if seen != want or prof["counter_launches_per_step"] != want:
        raise AssertionError(f"{label}: the profile saw launches {seen} a step, the counters "
                             f"{prof['counter_launches_per_step']}, expected {want}")


def attributed_step(torch, dev, step, state, x, m, base, dname, expect):
    """Phases 8 and 10: one warm-up step, then two traced steps of the
    kernels-on ``step`` attributed to the kernels by ``step_attribution``,
    their launches held to ``expect``."""
    from unet_image_segmentation_tpu_torch.troubleshoot import step_attribution

    mc = base["model"]
    prof = step_attribution.profile_train_step(
        step, state, x, m, dev, steps=2, warmup=1, batch=x.shape[0], dname=dname,
        shapes=roofline.train_step_shapes(mc["image_height"], mc["filters"], mc["num_classes"]))
    check_attribution(prof, expect, f"{dname} profiled step")
    print(f"  {dname} kernels-on step under torch.profiler: {prof['wall_ms_per_step']:.1f} ms a "
          f"step, device busy {prof['device_ms_per_step']:.1f} ms (idle share "
          f"{prof['idle_share']:.3f}); device ms a step: " + ", ".join(
              f"{row['label']} {w} {row['ms']:.2f}" for w, row in prof["per_kernel"].items()) +
          f", PyTorch glue {prof['glue_ms_per_step']:.2f}")
    print("    largest PyTorch kernel families, ms a step: " + "; ".join(
        f"{name[:60]} {t:.2f}" for name, t in list(prof["glue_ms"].items())[:6]))
    return prof


def troubleshoot_path(torch, dev, smi, report, launches, worst_abs, totals):
    """Phase 12: K12 against its plain versions, then the troubleshoot tools
    as a user runs them: ``link_floors`` (K12's probes, K2 at the 18 links
    split by pass), ``step_attribution`` (the default step by kernel),
    ``check_install`` and ``check_gpu_benchmark``. Returns the library
    times of the kernels that have one (K12a: ``x + 1``)."""
    from unet_image_segmentation_tpu_torch.ops import probes
    from unet_image_segmentation_tpu_torch.troubleshoot import (
        check_gpu_benchmark, check_install, link_floors, step_attribution)

    rng = np.random.RandomState(SEED + 7)
    print(f"K12 probes vs plain: K12a on (8, 128) fp32 exactly; K12b at {FMA_PROBE_SHAPE}, K = "
          f"{FMA_PROBE_K}, bf16 bit for bit, fp32 within K * 2^-24 relative [{smi}]")
    x = torch.from_numpy(rng.rand(8, 128).astype(np.float32)).to(dev)
    got, want = probes.dispatch_probe(x), probes.dispatch_probe_reference(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K12a differs from x + 1")
    k12a = link_floors.measure_dispatch_ms(dev)
    plain_ms = link_floors.graph_ms(lambda: probes.dispatch_probe_reference(x), 2000)
    totals["float32"]["dispatch_probe"] = (k12a["device_ms"], plain_ms)
    print(f"  K12a exact; a launch costs the device {k12a['device_ms'] * 1e3:.3f} us (from a "
          f"CUDA graph), {k12a['stream_ms'] * 1e3:.3f} us back to back from Python, "
          f"{k12a['host_ms'] * 1e3:.3f} us a launch-and-synchronise on the host; plain / "
          f"library x + 1 {plain_ms * 1e3:.3f} / {k12a['library_ms'] * 1e3:.3f} us (graph); "
          f"bound {k12a['bound_ms'] * 1e6:.2f} ns")
    x0 = torch.from_numpy(rng.rand(*FMA_PROBE_SHAPE).astype(np.float32) * 1e-3)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        xd = x0.to(dev, dtype)
        got = probes.fma_probe(xd, FMA_PROBE_K)
        want = probes.fma_probe_reference(xd, FMA_PROBE_K)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        tol = 0.0 if dname == "bfloat16" else FMA_PROBE_K * 2.0 ** -24
        worst_abs["fma_probe"] = max(worst_abs["fma_probe"], err)
        rate = link_floors.measure_fma_rate(dname, dev)
        plain_ms = time_ms(lambda: probes.fma_probe_reference(xd, FMA_PROBE_K), torch, 2)
        totals[dname]["fma_probe"] = (rate["ms"], plain_ms)
        ok = torch.isfinite(got.float()).all().item() and rel <= tol
        print(f"  K12b {dname}: max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}; {rate['ms'] * 1e3:.2f} us a call ({rate['gops']:.0f} "
              f"Gop/s, {100 * rate['bound_share']:.1f}% of the {rate['bound_ms'] * 1e3:.2f} us "
              f"bound); plain {plain_ms:.2f} ms")
        if not ok:
            raise AssertionError(f"K12b {dname} disagrees with its plain version")
    report["k12"] = {"dispatch": k12a, "fma": {d: totals[d]["fma_probe"] for d in totals}}

    print(f"link_floors {' '.join(LINK_FLOORS_ARGS)}:")
    probes.reset_launch_counts()
    if link_floors.main(LINK_FLOORS_ARGS) != 0:
        raise AssertionError("link_floors failed")
    torch.cuda.synchronize()
    for name, n in probes.LAUNCHES.items():
        if n == 0:
            raise AssertionError(f"link_floors launched no {name}")
        launches[name] = n
    with open(link_floors.OUT) as f:
        floors = json.load(f)
    iters = int(LINK_FLOORS_ARGS[1])
    if len(floors["links"]) != len(LINKS) or any(
            r["launches"] != iters or r["k1_launches"] != iters or
            min(r["pass_a_ms"], r["pass_b_ms"], r["sums_ms"], r["k1_ms"]) <= 0
            for r in floors["links"]):
        raise AssertionError(f"{link_floors.OUT}: expected {len(LINKS)} links, each with "
                             f"{iters} K1 and K2 launches and K2's time split by pass")
    print(f"  {len(floors['links'])} links, one K1 and one K2 launch a timed call, K2 split into "
          f"pass (a), pass (b) and sums -> {link_floors.OUT}")
    report["link_floors"] = floors

    print(f"step_attribution {' '.join(ATTRIBUTION_ARGS)}:")
    if step_attribution.main(ATTRIBUTION_ARGS) != 0:
        raise AssertionError("step_attribution failed")
    with open(step_attribution.OUT) as f:
        attr = json.load(f)
    check_attribution(attr, STEP_LAUNCHES, "step_attribution")
    total = attr["kernel_ms_per_step"] + attr["glue_ms_per_step"]
    if abs(total - attr["device_ms_per_step"]) > 0.02 * attr["device_ms_per_step"]:
        raise AssertionError(f"sites + glue {total} ms != busy {attr['device_ms_per_step']} ms")
    print(f"  sites + glue {total:.3f} ms = device busy {attr['device_ms_per_step']:.3f} ms a "
          f"step (within 2%); launches a step as the counters: "
          f"{attr['counter_launches_per_step']}")
    report["step_attribution"] = attr

    for tool, args in ((check_install, []), (check_gpu_benchmark, GPU_BENCHMARK_ARGS)):
        print(f"{tool.__name__.rsplit('.', 1)[-1]} {' '.join(args)}:")
        if tool.main(args) != 0:
            raise AssertionError(f"{tool.__name__} failed")
    return {"dispatch_probe": k12a["library_ms"]}


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def int8_case(torch, fs, sq, rnd, weights, dev, dtype, batch, cx, cx2, f1, f2, h, w, mode):
    """Seeded inputs of one K7 int8 call: int8 x in [-127, 127] and x2 in
    [0, 127] at INT8_SCALES, random blocks in ``dtype`` folded for an output
    scale that covers the plain float pair's output on the dequantized x."""
    w1, w2 = weights(cx + cx2, f1, dtype), weights(f1, f2, dtype)
    q = torch.randint(-127, 128, (batch, h, w, cx), generator=rnd.gen, dtype=torch.int8).to(dev)
    q2 = (torch.randint(0, 128, (batch, h, w, cx2), generator=rnd.gen, dtype=torch.int8).to(dev)
          if cx2 else None)
    s_x, s_x2 = INT8_SCALES
    xf = sq.dequantize(q, s_x, dtype)
    x2f = sq.dequantize(q2, s_x2, dtype) if cx2 else None
    s_out = sq.pow2_scale(fs.sepconv_pair_reference(xf, w1, w2, x2=x2f).float().max().item())
    return {"q": q, "q2": q2, "xf": xf, "x2f": x2f, "w": (w1, w2), "s_out": s_out,
            "fw": fs.fold_int8(w1, w2, (s_x, s_x2) if cx2 else s_x, s_out, cx),
            "pool": mode == "pool"}


def hold_int8(torch, got, want, label, dname, worst_abs):
    """K7 int8's outputs (y, or (y, pooled)) against its plain int8
    version's, in quanta: at most 1 + KERNEL_TOL x max|plain| apart."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    torch.cuda.synchronize()
    for part, g, r in zip(("y", "pooled"), got, want):
        if g.shape != r.shape or g.dtype != torch.int8:
            raise AssertionError(f"K7 int8 {label} {dname}: bad output {tuple(g.shape)} {g.dtype}")
        d = (g.int() - r.int()).abs()
        err, share = d.max().item(), (d > 0).float().mean().item()
        bar = 1 + KERNEL_TOL[dname] * r.int().abs().max().item()
        worst_abs["sepconv_pair_int8"] = max(worst_abs["sepconv_pair_int8"], err)
        print(f"  K7 int8 {label} {part} {dname}: max |kernel - plain| {err} quanta (bar "
              f"{bar:.2f}), {share:.2e} of elements differ {'ok' if err <= bar else 'FAIL'}")
        if not err <= bar:
            raise AssertionError(f"K7 int8 {label} {dname}: {err} quanta > {bar}")


def judge_int8(torch, fs, sq, k, label, dname, worst_abs):
    """K7 int8 against its plain int8 version (:func:`hold_int8`); in fp32
    also bit for bit equal to quantizing the float K7's output on the
    dequantized input."""
    kw = {"pool": k["pool"], "x2": k["q2"]}
    got = fs.sepconv_pair_int8(k["q"], *k["fw"], **kw)
    hold_int8(torch, got, fs.sepconv_pair_int8_reference(k["q"], *k["fw"], **kw), label, dname,
              worst_abs)
    got = got if k["pool"] else (got,)
    if dname == "float32":
        yf = fs.sepconv_pair(k["xf"], *k["w"], pool=k["pool"], x2=k["x2f"])
        for g, f in zip(got, yf if k["pool"] else (yf,)):
            if not torch.equal(g, sq.quantize(f, k["s_out"])):
                raise AssertionError(f"K7 int8 {label} fp32: not bit for bit quantize(float K7 "
                                     "on the dequantized input)")
        print(f"  K7 int8 {label} fp32: bit for bit quantize(float K7 on the dequantized input)")


def int8_path(torch, dev, smi, report, launches, worst_abs, totals, rnd, weights, dtypes,
              scenes, on, on8):
    """Phase 13: K7's int8 I/O mode against its plain version, the int8
    ``Predictor``s ``on8`` (phase 5's checkpoint; the bf16 one calibrated
    and profiled in phase 5) beside the float ones ``on``, ``evaluate``'s
    batched core, and their times."""
    from unet_image_segmentation_tpu_torch import serving_quant as sq
    from unet_image_segmentation_tpu_torch.evaluation import evaluate_batches
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs

    print("K7 int8 I/O vs its plain int8 version (in quanta), fp32 and bf16:")
    cases = {}
    for dname, dtype in dtypes.items():
        for batch in INT8_BATCHES:
            for stage in STAGES:
                name, cx, cx2, f1, f2, h, mode = stage
                k = int8_case(torch, fs, sq, rnd, weights, dev, dtype, batch, cx, cx2, f1, f2, h,
                              h, mode)
                judge_int8(torch, fs, sq, k, f"{name} batch {batch}", dname, worst_abs)
                if batch == BATCH_SERVE:   # kept for the timings
                    cases[(dname, name)] = {key: k[key] for key in ("q", "q2", "fw", "pool")}
                del k
        stream = rnd.gen.get_state()   # the later steps' seeded inputs stay as they were
        for batch in INT8_RAGGED_BATCHES:
            for name, cx, cx2, f1, f2, h, w, mode in INT8_RAGGED:
                k = int8_case(torch, fs, sq, rnd, weights, dev, dtype, batch, cx, cx2, f1, f2, h,
                              w, mode)
                plan = fs.pair_plan(h, w, cx + cx2, f1, f2, dtype, batch, int8=True)
                judge_int8(torch, fs, sq, k, f"{name} ({cx}{'|%d' % cx2 if cx2 else ''})->{f1}->"
                           f"{f2}@{h}x{w} {mode} batch {batch}, cluster {plan.n}", dname,
                           worst_abs)
                del k
        rnd.gen.set_state(stream)

    # the int8 Predictor: the run whose launches are counted
    fs.reset_launch_counts()
    outputs = {(d, n): on8[d].predict(scenes[:n]) for d in dtypes for n in INT8_REQUESTS}
    torch.cuda.synchronize()
    counts = dict(fs.LAUNCHES)
    forwards = len(INT8_REQUESTS) * len(dtypes)
    print(f"int8 Predictor: launches {counts} over {forwards} forwards")
    if (counts["sepconv_pair_int8"] != INT8_LAUNCHES_PER_FORWARD * forwards
            or counts["sepconv_pair"] != 0):
        raise AssertionError(f"expected {INT8_LAUNCHES_PER_FORWARD} int8 K7 launches and no "
                             f"float one a forward, got {counts}")
    launches["sepconv_pair_int8"] = counts["sepconv_pair_int8"]
    report["int8"] = {"scales": {d: on8[d].quant_scales for d in dtypes}}
    for dname in dtypes:
        pred = on8[dname]
        # each K7 int8 call of a batch-32 forward against its plain version on
        # the same inputs: the path's own activations
        names = iter(stage[0] for stage in STAGES)

        def held(xq, w1, w2, pool=False, x2=None):
            got = fs.sepconv_pair_int8(xq, w1, w2, pool=pool, x2=x2)
            hold_int8(torch, got, fs.sepconv_pair_int8_reference(xq, w1, w2, pool=pool, x2=x2),
                      f"{next(names)} in the int8 Predictor's forward", dname, worst_abs)
            return got

        with patched(sq, "sepconv_pair_int8", held):
            pred.predict(scenes[:BATCH_SERVE])
        # end to end: the same graph with the plain int8 version. A sum in
        # another order rounds to another quantum now and then, and each such
        # difference spreads to the next stage's roundings, so with random
        # weights the two graphs differ like int8 and float do: printed
        with patched(sq, "sepconv_pair_int8", fs.sepconv_pair_int8_reference):
            plain = sq.build_serving_forward_quant(pred.variables, pred.quant_scales,
                                                   **pred.serving_kwargs, device=dev)
            want = {n: plain(torch.from_numpy(scenes[:n]).to(dev)).cpu().numpy()
                    for n in INT8_REQUESTS}
        for n in INT8_REQUESTS:
            got = outputs[(dname, n)]
            if got.shape != (n, IMAGE, IMAGE, 1) or not np.isfinite(got).all():
                raise AssertionError(f"int8 Predictor {dname} batch {n}: bad output {got.shape}")
            err = float(np.abs(got - want[n]).max())
            agree = float(((got > 0.5) == (want[n] > 0.5)).mean())
            fl = on[dname].predict(scenes[:n])
            f_err = float(np.abs(got - fl).max())
            f_agree = float(((got > 0.5) == (fl > 0.5)).mean())
            print(f"  int8 Predictor {dname} batch {n}: against the graph with K7's plain int8 "
                  f"version prob max_abs_diff {err:.3e}, mask agreement {agree:.6f}; against the "
                  f"float kernel graph prob max_abs_diff {f_err:.3e}, mask agreement "
                  f"{f_agree:.6f} (printed, no bar)")
            report["int8"][f"{dname} batch {n}"] = {
                "plain_max_abs_diff": err, "plain_mask_agree": agree,
                "float_max_abs_diff": f_err, "float_mask_agree": f_agree}

    images, masks = synthetic_scenes(EVAL_SCENES, IMAGE, SEED + 7, with_masks=True)

    def batches():
        for i in range(0, EVAL_SCENES, BATCH_SERVE):
            yield ([f"scene{j}" for j in range(i, min(i + BATCH_SERVE, EVAL_SCENES))],
                   images[i:i + BATCH_SERVE], masks[i:i + BATCH_SERVE, ..., 0])

    for dname in dtypes:
        r8 = evaluate_batches(on8[dname], batches(), batch_size=BATCH_SERVE)
        rf = evaluate_batches(on[dname], batches(), batch_size=BATCH_SERVE)
        delta = abs(r8.mean_iou - rf.mean_iou)
        ok = r8.n_evaluated == rf.n_evaluated == EVAL_SCENES and delta <= INT8_MEAN_IOU_TOL
        print(f"  evaluate_batches {dname}, {EVAL_SCENES} scenes at batch {BATCH_SERVE}: MeanIoU "
              f"int8 {r8.mean_iou:.6f}, float {rf.mean_iou:.6f}, |delta| {delta:.2e} (tol "
              f"{INT8_MEAN_IOU_TOL}) {'ok' if ok else 'FAIL'}")
        report["int8"][f"{dname} mean_iou"] = {"int8": r8.mean_iou, "float": rf.mean_iou}
        if not ok:
            raise AssertionError(f"evaluate {dname}: int8 MeanIoU {r8.mean_iou} against float "
                                 f"{rf.mean_iou}")

    print(f"K7 int8 at batch {BATCH_SERVE}, ms (kernel / plain, its bound) [{smi}]:")
    for dname in dtypes:
        t_k = t_p = b_sum = 0.0
        for stage in STAGES:
            k = cases.pop((dname, stage[0]))
            kw = {"pool": k["pool"], "x2": k["q2"]}
            tk = time_ms(lambda: fs.sepconv_pair_int8(k["q"], *k["fw"], **kw), torch)
            tp = time_ms(lambda: fs.sepconv_pair_int8_reference(k["q"], *k["fw"], **kw), torch)
            bound, by = roofline.bounds_ms("sepconv_pair_int8", stage, dname, BATCH_SERVE)
            t_k, t_p, b_sum = t_k + tk, t_p + tp, b_sum + bound
            print(f"  K7 int8 {stage[0]} {dtype_label(dname)}: {tk:.3f} / {tp:.3f}, bound "
                  f"{bound:.4f} ({by}, {100 * bound / tk:.1f}%)")
            report["stages"][f"{stage[0]} int8 {dname}"] = {
                "ms": tk, "plain_ms": tp, "bound_ms": bound, "bound_by": by}
            del k, kw
        totals[dname]["sepconv_pair_int8"] = (t_k, t_p)
        print(f"  {dname} K7 int8 over the path: {t_k:.3f} / {t_p:.3f}, bound {b_sum:.4f} "
              f"({100 * b_sum / t_k:.1f}%); float K7 {totals[dname]['sepconv_pair'][0]:.3f}")

    batch = scenes[:BATCH_SERVE]
    for dname in dtypes:
        rates = {}
        for label, pred in (("int8", on8[dname]), ("float", on[dname]),
                            ("int8", on8[dname]), ("float", on[dname])):
            rates.setdefault(label, []).append(images_per_second(pred, batch, torch))
        print(f"  Predictor {dname} batch {BATCH_SERVE} images/s: " + ", ".join(
            f"{k} {' / '.join(f'{r:.1f}' for r in v)}" for k, v in rates.items()) + f" [{smi}]")
        report["int8"][f"{dname} images_per_s"] = rates


def hold_pairs(torch, worst_abs, name, label, dname, pairs, tol):
    """K7 outputs against their plain versions, relative to max|plain|, the
    worst of ``pairs`` printed on one line."""
    worst = 0.0
    for got, want in pairs:
        if got.shape != want.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} {label} {dname}: bad output {tuple(got.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        worst_abs[name] = max(worst_abs[name], err)
        worst = max(worst, err / max(want.float().abs().max().item(), 1e-30))
    print(f"  {name} {label} {dname}: worst rel err {worst:.3e} (tol {tol:g}) "
          f"{'ok' if worst <= tol else 'FAIL'}")
    if not worst <= tol:
        raise AssertionError(f"{name} {label} {dname}: rel err {worst} > {tol}")


def hold_quanta(torch, worst_abs, name, label, dname, pairs):
    """int8 K7 outputs against their plain versions, in quanta: at most
    1 + KERNEL_TOL x max|plain| apart (phase 13's bar); the worst printed."""
    worst, share, bar = 0, 0.0, 0.0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != torch.int8:
            raise AssertionError(f"{name} {label} {dname}: bad output {tuple(got.shape)}")
        d = (got.int() - want.int()).abs()
        err, b = d.max().item(), 1 + KERNEL_TOL[dname] * want.int().abs().max().item()
        worst_abs[name] = max(worst_abs[name], err)
        if err > b:
            raise AssertionError(f"{name} {label} {dname}: {err} quanta > {b}")
        worst, share, bar = max(worst, err), max(share, (d > 0).float().mean().item()), max(bar, b)
    print(f"  {name} {label} {dname}: max {worst} quanta (bar {bar:.2f}), at most {share:.2e} of "
          "elements differ ok")


def pair_outputs(out):
    return out if isinstance(out, tuple) else (out,)


def edge_checks(torch, fs, sq, rnd, weights, dev, dtypes, pair_case, worst_abs):
    """Phase 14: K7 with edge flags against its plain version: float and
    int8 I/O at the stage shapes of the 256 and 1024 px models on the slab
    of one of two row shards, all four flag pairs, and at EDGE_RAGGED."""
    print(f"K7 with edge flags vs plain, batch {BATCH_CHECK}, all four flag pairs, on a slab of "
          "H / 2 + 4 rows of each stage of the 256 and 1024 px models:")
    for dname, dtype in dtypes.items():
        shapes = [(s, BATCH_CHECK, EDGE_FLAGS) for s in slab_shapes(STAGES, 2) +
                  slab_shapes(STAGES_1024, 2)]
        shapes += [((name, cx, cx2, f1, f2, h, mode, w), batch, EDGE_RAGGED_FLAGS)
                   for batch in (2, 3) for name, cx, cx2, f1, f2, h, w, mode in EDGE_RAGGED]
        stream = rnd.gen.get_state()
        for (name, cx, cx2, f1, f2, h, mode, w), batch, flag_set in shapes:
            label = (f"{name} ({cx}{'|%d' % cx2 if cx2 else ''})->{f1}->{f2}@{h}x{w} {mode} "
                     f"batch {batch}")
            args, kw = pair_case(batch, cx, cx2, f1, f2, h, w, mode, dtype)
            pairs = []
            for flags in flag_set:
                got = fs.sepconv_pair(*args, **kw, edge_flags=flags)
                want = fs.sepconv_pair_reference(*args, **kw, edge_flags=flags)
                pairs += zip(pair_outputs(got), pair_outputs(want))
            torch.cuda.synchronize()
            hold_pairs(torch, worst_abs, "sepconv_pair_edge", label, dname, pairs,
                       KERNEL_TOL[dname])
            del args, kw, pairs
            k = int8_case(torch, fs, sq, rnd, weights, dev, dtype, batch, cx, cx2, f1, f2, h, w,
                          mode)
            pairs = []
            for flags in flag_set:
                kw8 = {"pool": k["pool"], "x2": k["q2"], "edge_flags": flags}
                pairs += zip(pair_outputs(fs.sepconv_pair_int8(k["q"], *k["fw"], **kw8)),
                             pair_outputs(fs.sepconv_pair_int8_reference(k["q"], *k["fw"], **kw8)))
            torch.cuda.synchronize()
            hold_quanta(torch, worst_abs, "sepconv_pair_edge", f"int8 I/O {label}", dname, pairs)
            del k, pairs
        rnd.gen.set_state(stream)


def launch_shape(plan):
    """What of K7's plan decides a pixel's arithmetic: the cluster, the
    slices, their width and the shared-memory layout (not the tile count)."""
    return plan.n, plan.s1, plan.s2, plan.width, plan.smem


def stitch_checks(torch, fs, dtypes, pair_case, worst_abs, report):
    """Phase 14: each batch-2 stage input of the 256 and 1024 px models cut
    into n row shards, each padded with its neighbours' 2 rows (zeros at the
    image edges), K7 with its edge flags, trimmed and stitched, against the
    unsharded K7: bit for bit where the shard's launch plan (cluster, slices,
    width, shared memory) is the whole image's, else under phase 4's bars."""
    import torch.nn.functional as F

    print(f"stitched row shards (n in {SHARDS}) vs the unsharded K7, batch {BATCH_CHECK}:")
    apart = []
    for dname, dtype in dtypes.items():
        for stage in STAGES + STAGES_1024:
            name, cx, cx2, f1, f2, h, mode = stage
            (x, w1, w2), kw = pair_case(BATCH_CHECK, cx, cx2, f1, f2, h, h, mode, dtype)
            whole = pair_outputs(fs.sepconv_pair(x, w1, w2, **kw))
            plan = launch_shape(fs.pair_plan(h, h, cx + cx2, f1, f2, dtype, BATCH_CHECK))
            pad = [F.pad(t, (0, 0, 0, 0, 2, 2)) if t is not None else None for t in (x, kw["x2"])]
            for n in SHARDS:
                rows = h // n
                parts = [pair_outputs(fs.sepconv_pair(
                    pad[0][:, i * rows:(i + 1) * rows + 4].contiguous(), w1, w2, pool=kw["pool"],
                    x2=None if pad[1] is None else pad[1][:, i * rows:(i + 1) * rows + 4]
                    .contiguous(), edge_flags=(int(i == 0), int(i == n - 1)))) for i in range(n)]
                stitched = [torch.cat([p[0][:, 2:-2] for p in parts], 1)]
                if kw["pool"]:
                    stitched.append(torch.cat([p[1][:, 1:-1] for p in parts], 1))
                same_plan = launch_shape(fs.pair_plan(rows + 4, h, cx + cx2, f1, f2, dtype,
                                                      BATCH_CHECK)) == plan
                bits = all(torch.equal(a, b) for a, b in zip(stitched, whole))
                label = f"{name}@{h} in {n} shards"
                if bits:
                    print(f"  {label} {dname}: bit for bit (same plan: {same_plan})")
                else:
                    apart.append(f"{label} {dname} (same plan: {same_plan})")
                    hold_pairs(torch, worst_abs, "sepconv_pair_edge", label, dname,
                               list(zip(stitched, whole)), KERNEL_TOL[dname])
                    if same_plan:
                        raise AssertionError(f"{label} {dname}: not bit for bit on the same plan")
                del parts, stitched
            del x, w1, w2, kw, whole, pad
    print(f"  stitched shards not bit for bit: {apart or 'none'}")
    report["stitch_not_bitwise"] = apart


def quant_out_checks(torch, fs, sq, dtypes, pair_case, worst_abs):
    """Phase 14: K7's float-in/int8-out mode against its plain version, in
    quanta: at the decoder stages of the 256 and 1024 px models, two
    streams, batch 2 and 3, and on their slabs of one of two row shards
    (the sharded int8 graph's decoder calls, the 1024 px ones the dry
    run's), batch 2, all four flag pairs; in fp32 also bit for bit
    quantize(float K7) with the same flags."""
    cases = [((name, cx, cx2, f1, f2, h, mode, h), batch, (None,))
             for name, cx, cx2, f1, f2, h, mode in STAGES + STAGES_1024 if mode == "x2"
             for batch in (2, 3)]
    cases += [(stage, BATCH_CHECK, EDGE_FLAGS) for stage in slab_shapes(STAGES, 2) + SHARD_DECODER
              if stage[6] == "x2"]
    print("K7 float-in/int8-out vs plain (in quanta), decoder stages of the 256 and 1024 px "
          f"models at batch 2 and 3, and their slabs of H / 2 + 4 rows at batch {BATCH_CHECK} "
          "with all four flag pairs:")
    for dname, dtype in dtypes.items():
        for (name, cx, cx2, f1, f2, h, mode, w), batch, flag_set in cases:
            (x, w1, w2), kw = pair_case(batch, cx, cx2, f1, f2, h, w, mode, dtype)
            s_out = sq.pow2_scale(fs.sepconv_pair(x, w1, w2, **kw).float().max().item())
            q1, q2 = fs.fold_int8(w1, w2, None, s_out, cx)
            label = f"{name}@{h}x{w} batch {batch}"
            pairs = []
            for flags in flag_set:
                got = fs.sepconv_pair_quant_out(x, q1, q2, **kw, edge_flags=flags)
                pairs.append((got, fs.sepconv_pair_quant_out_reference(x, q1, q2, **kw,
                                                                      edge_flags=flags)))
                if dname == "float32" and not torch.equal(got, sq.quantize(
                        fs.sepconv_pair(x, w1, w2, **kw, edge_flags=flags), s_out)):
                    raise AssertionError(f"K7 float-in/int8-out {label} flags {flags} fp32: not "
                                         "bit for bit quantize(float K7)")
            torch.cuda.synchronize()
            flagged = "no flags" if flag_set == (None,) else \
                f"flags {', '.join(map(str, flag_set))}"
            hold_quanta(torch, worst_abs, "sepconv_pair_quant_out", f"{label} {flagged}", dname,
                        pairs)
            if dname == "float32":
                print(f"  sepconv_pair_quant_out {label} fp32: bit for bit quantize(float K7) "
                      "with the same flags")
            del x, w1, w2, kw, pairs


def time_shard_kernels(torch, fs, dtypes, pair_case, totals, report, smi):
    """Phase 14: K7 with edge flags (the first shard's) at the dry run's
    nine slab shapes and K7 float-in/int8-out at its four decoder slabs,
    each beside its plain version, its bound and the same K7 call without
    flags (float) or the float mode (float-in/int8-out)."""
    print(f"K7 at the dry run's slabs (1024 px over {DRY_RANKS} row shards, batch {DRY_BATCH}), "
          f"ms (kernel / plain, bound; the same call in the float mode without flags) [{smi}]:")
    for dname, dtype in dtypes.items():
        t_edge, t_qo = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
        for stage in SHARD_STAGES:
            name, cx, cx2, f1, f2, hs, mode, w = stage
            (x, w1, w2), kw = pair_case(DRY_BATCH, cx, cx2, f1, f2, hs, w, mode, dtype)
            tk = time_ms(lambda: fs.sepconv_pair(x, w1, w2, **kw, edge_flags=(1, 0)), torch)
            tp = time_ms(lambda: fs.sepconv_pair_reference(x, w1, w2, **kw, edge_flags=(1, 0)),
                         torch)
            t0 = time_ms(lambda: fs.sepconv_pair(x, w1, w2, **kw), torch)
            bound, by = roofline.bounds_ms("sepconv_pair_edge", stage, dname, DRY_BATCH)
            t_edge = [t_edge[0] + tk, t_edge[1] + tp, t_edge[2] + t0]
            line = f"  {name} slab {hs}x{w} {dtype_label(dname)}: edge {tk:.3f} / {tp:.3f}, " \
                   f"bound {bound:.4f} ({by}); no flags {t0:.3f}"
            rec = {"ms": tk, "plain_ms": tp, "bound_ms": bound, "bound_by": by, "no_flags_ms": t0}
            if mode == "x2":
                s_out = 2.0 ** -3
                q1, q2 = fs.fold_int8(w1, w2, None, s_out, cx)
                tq = time_ms(lambda: fs.sepconv_pair_quant_out(x, q1, q2, **kw, edge_flags=(1, 0)),
                             torch)
                tqp = time_ms(lambda: fs.sepconv_pair_quant_out_reference(
                    x, q1, q2, **kw, edge_flags=(1, 0)), torch)
                qb, qby = roofline.bounds_ms("sepconv_pair_quant_out", stage, dname, DRY_BATCH)
                t_qo = [t_qo[0] + tq, t_qo[1] + tqp, t_qo[2] + tk]
                line += f"; float-in/int8-out {tq:.3f} / {tqp:.3f}, bound {qb:.4f} ({qby})"
                rec["quant_out"] = {"ms": tq, "plain_ms": tqp, "bound_ms": qb, "bound_by": qby}
            print(line)
            report["shard_stages"][f"{name} {dname}"] = rec
            del x, w1, w2, kw
        totals[dname]["sepconv_pair_edge"] = (t_edge[0], t_edge[1])
        totals[dname]["sepconv_pair_quant_out"] = (t_qo[0], t_qo[1])
        print(f"  {dname} over the slabs: edge {t_edge[0]:.3f} / {t_edge[1]:.3f} (no flags "
              f"{t_edge[2]:.3f}); float-in/int8-out over the decoder {t_qo[0]:.3f} / "
              f"{t_qo[1]:.3f} (float mode with flags {t_qo[2]:.3f})")


def frames_per_second(stream, frames, torch, reps=STREAM_REPS):
    """Host-clock rate of ``run_device`` on frames already on the card."""
    stream.run_device(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        stream.run_device(frames)
    torch.cuda.synchronize()
    return reps * frames.shape[0] / (time.perf_counter() - t0)


def profile_stream(torch, dev, stream, frames, smi):
    """Phase 14: one ``run_device`` of the bf16 1024 px stream under
    ``torch.profiler``: the device's busy time and idle share, K7's share of
    the busy time, the device time of the resize products (the
    ``stream.preprocess`` and ``stream.postprocess`` spans) and of the
    forward, the host copies."""
    from torch.profiler import record_function

    from unet_image_segmentation_tpu_torch.troubleshoot import profile_summary
    from unet_image_segmentation_tpu_torch.utils import profiling

    stream.run_device(frames)
    with tempfile.TemporaryDirectory() as tdir:
        with profiling.trace(tdir, dev):
            with record_function("stream"):
                stream.run_device(frames)
        s = profile_summary.summarize(tdir, within="stream")
        parts = {name: profile_summary.summarize(tdir, within=f"stream.{name}")["busy_ms"]
                 for name in ("preprocess", "forward", "postprocess")}
    profile_summary.check_complete(s, "stream profile")
    k7 = sum(ms for name, ms in s["kernels"].items()
             if roofline.entry_of(name) == "sepconv_pair_cluster_kernel")
    k7_n = sum(n for name, n in s["launches"].items()
               if roofline.entry_of(name) == "sepconv_pair_cluster_kernel")
    if k7_n != PAIR_LAUNCHES_PER_FORWARD:
        raise AssertionError(f"stream profile: {k7_n} K7 launches, expected "
                             f"{PAIR_LAUNCHES_PER_FORWARD}")
    out = {"window_ms": s["window_ms"], "busy_ms": s["busy_ms"], "idle_share": s["idle_share"],
           "k7_ms": k7, "k7_share_of_busy": k7 / s["busy_ms"], "span_busy_ms": parts,
           "copies": {name: {"ms": ms, "n": s["launches"][name]}
                      for name, ms in s["copies"].items()}}
    print(f"  bf16 stream of {frames.shape[0]} frames under torch.profiler: {s['window_ms']:.2f} ms,"
          f" device busy {s['busy_ms']:.2f} ms (idle share {s['idle_share']:.3f}); K7 {k7:.2f} ms "
          f"in {k7_n} launches ({100 * k7 / s['busy_ms']:.1f}% of busy); device busy by span: "
          f"resize in {parts['preprocess']:.2f} ms, forward {parts['forward']:.2f} ms, resize "
          f"back and threshold {parts['postprocess']:.2f} ms; host copies " + ", ".join(
              f"{name} {v['ms']:.3f} ms x{v['n']}" for name, v in out["copies"].items()) +
          f" [{smi}]")
    return out


def wait_children(procs, timeout):
    """Wait until every process is done, one fails, or ``timeout`` seconds
    are up; then kill what is left, so that none outlives the call."""
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]   # every process polled each time
            if None not in codes or any(codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def join_ranks(procs, logs, timeout, label):
    """Wait for the dry run's rank processes (:func:`wait_children`), print
    the end of every rank's log, then raise, naming a rank that failed by
    itself before one that was killed."""
    wait_children(procs, timeout)
    texts = []
    for r, log in enumerate(logs):
        log.seek(0)
        texts.append(log.read())
        log.close()
        for line in texts[-1].strip().splitlines()[-30:]:
            print(f"  rank {r}: {line}")
    bad = [r for r, (p, text) in enumerate(zip(procs, texts))
           if p.returncode != 0 or f"RANK_OK {r}" not in text]
    if bad:   # name a rank that failed by itself before one that was killed
        r = next((r for r in bad if (procs[r].returncode or 0) > 0), bad[0])
        raise AssertionError(f"{label}: rank {r} exited {procs[r].returncode} (killed when "
                             f"another rank failed or after {timeout} s)")


def profile_in_child(phase_dir, flag="--profile-stream", name="stream_profile.json"):
    """Phase 14: :func:`profile_stream` in a process of this script of its
    own (``--profile-stream``), on the checkpoint and frames under
    ``phase_dir``; phase 15's profiled training step likewise
    (``--profile-train``). In this script's long process, after the earlier
    phases' profiler sessions, torch.profiler lost the first 26 of the
    stream's 40 kernels in most traces on an H100 (PyTorch 2.11), in one run
    in all four tries; a fresh process's first trace is the case that came
    back whole. The child's error, a lost trace's included, is raised here."""
    import subprocess

    path = os.path.join(phase_dir, name)
    if os.path.exists(path):
        os.remove(path)
    with open(os.path.join(phase_dir, "profile.log"), "w+") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, phase_dir],
                                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        wait_children([proc], PROFILE_TIMEOUT)
        log.seek(0)
        lines = log.read().strip().splitlines()
    for line in lines[-30:]:
        print(f"  profile process: {line}")
    if proc.returncode != 0 or not lines or lines[-1] != "PROFILE_OK":
        raise AssertionError(f"{flag}: its process exited {proc.returncode} (killed "
                             f"after {PROFILE_TIMEOUT} s if still running): "
                             f"{lines[-1] if lines else 'no output'}")
    with open(path) as f:
        return json.load(f)


def profile_main(phase_dir):
    """The stream profile's process (``chip_smoke.py --profile-stream DIR``):
    the bf16 1024 px stream of DIR's checkpoint on DIR's frames, one
    :func:`profile_stream`; writes DIR/stream_profile.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.streaming import StreamingPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    pred = Predictor(os.path.join(phase_dir, "ckpt"), (STREAM_IMAGE, STREAM_IMAGE),
                     compute_dtype="bfloat16", use_pallas=True, device=dev)
    frames = torch.from_numpy(np.load(os.path.join(phase_dir, "frames.npy"))).to(dev)
    stream = StreamingPredictor(pred, STREAM_FRAME, STREAM_BATCH, threshold=None)
    out = profile_stream(torch, dev, stream, frames, roofline.card())
    with open(os.path.join(phase_dir, "stream_profile.json"), "w") as f:
        json.dump(out, f)
    print("PROFILE_OK", flush=True)
    return 0


def stream_path(torch, dev, smi, report, rnd, dtypes, phase_dir):
    """Phase 14: the unsharded 1024 px stream from 1080p frames, bf16 and
    fp32 (the kernel graph against the module path) and int8; returns the
    model's checkpoint, the float Predictors and the frames on the card."""
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.streaming import StreamingPredictor
    from unet_image_segmentation_tpu_torch.train.checkpoint import save_inference_variables

    print(f"1024 px stream: U-Net filters {FILTERS} at {STREAM_IMAGE} px (configs/highres_1024."
          f"json), seeded weights, {STREAM_BATCH} frames of {STREAM_FRAME[0]}x{STREAM_FRAME[1]}")
    ckpt = os.path.join(phase_dir, "ckpt")
    save_inference_variables(ckpt, seeded_state(torch, dev, rnd, synthetic_scenes(
        4, STREAM_IMAGE, SEED + 14)), MODEL_KWARGS)
    size = (STREAM_IMAGE, STREAM_IMAGE)
    on = {d: Predictor(ckpt, size, compute_dtype=d, use_pallas=True, device=dev) for d in dtypes}
    off = {d: Predictor(ckpt, size, compute_dtype=d, device=dev) for d in dtypes}
    on8 = Predictor(ckpt, size, compute_dtype="bfloat16", use_pallas=True, quantize="int8",
                    device=dev)
    frames = np.round(synthetic_scenes(STREAM_BATCH, STREAM_FRAME[0], SEED + 15,
                                       width=STREAM_FRAME[1]) * 255).astype(np.uint8)
    frames_dev = torch.from_numpy(frames).to(dev)

    def stream(pred, threshold=None):
        return StreamingPredictor(pred, STREAM_FRAME, STREAM_BATCH, threshold=threshold)

    streams = {d: stream(on[d]) for d in dtypes}
    rec = report["stream"]
    np.save(os.path.join(phase_dir, "frames.npy"), frames)
    rec["profile"] = traced(lambda _: profile_in_child(phase_dir), "stream profile")
    # the counted run: one forward a dtype
    fs.reset_launch_counts()
    probs = {d: streams[d].run_device(frames_dev) for d in dtypes}
    torch.cuda.synchronize()
    counts = dict(fs.LAUNCHES)
    want = dict.fromkeys(counts, 0)
    want["sepconv_pair"] = PAIR_LAUNCHES_PER_FORWARD * len(dtypes)
    print(f"  launches over {len(dtypes)} stream forwards: {counts}")
    if counts != want:
        raise AssertionError(f"stream: expected {want}, got {counts}")
    for dname in dtypes:
        got = probs[dname]
        ref = stream(off[dname]).run_device(frames_dev)
        masks = stream(on[dname], 0.5).run_device(frames_dev)
        if tuple(got.shape) != (STREAM_BATCH, *STREAM_FRAME) or not torch.isfinite(got).all():
            raise AssertionError(f"stream {dname}: bad output {tuple(got.shape)}")
        if not torch.equal(masks, (got > 0.5).to(torch.uint8)):
            raise AssertionError(f"stream {dname}: the thresholded stream is not probs > 0.5")
        err = (got - ref).abs().max().item()
        agree = ((got > 0.5) == (ref > 0.5)).float().mean().item()
        ok = err <= PROB_TOL[dname] and agree >= MASK_MIN_AGREE[dname]
        print(f"  {dname} stream against the module path's: prob max_abs_err {err:.3e} (tol "
              f"{PROB_TOL[dname]:g}), mask agreement {agree:.6f} (min {MASK_MIN_AGREE[dname]}), "
              f"foreground {(ref > 0.5).float().mean().item():.3f} {'ok' if ok else 'FAIL'}")
        rec[f"{dname} vs module path"] = {"max_abs_err": err, "mask_agree": agree}
        if not ok:
            raise AssertionError(f"stream {dname}: the kernels disagree with the module path")
        del ref, masks
    s8 = stream(on8)
    s8.run_device(frames_dev)   # calibrates on this batch's model input
    fs.reset_launch_counts()
    p8 = s8.run_device(frames_dev)
    torch.cuda.synchronize()
    counts = dict(fs.LAUNCHES)
    if counts["sepconv_pair_int8"] != INT8_LAUNCHES_PER_FORWARD or sum(counts.values()) != \
            INT8_LAUNCHES_PER_FORWARD:
        raise AssertionError(f"int8 stream: expected {INT8_LAUNCHES_PER_FORWARD} int8 K7 "
                             f"launches and nothing else, got {counts}")
    f_err = (p8 - probs["bfloat16"]).abs().max().item()
    f_agree = ((p8 > 0.5) == (probs["bfloat16"] > 0.5)).float().mean().item()
    print(f"  bf16 int8 stream: {counts['sepconv_pair_int8']} int8 K7 launches a forward; "
          f"against the bf16 float stream prob max_abs_diff {f_err:.3e}, mask agreement "
          f"{f_agree:.6f} (printed, no bar)")
    rec["int8 vs float"] = {"max_abs_diff": f_err, "mask_agree": f_agree,
                            "scales": s8.quant_scales}
    rates = {}
    for label, st in (("bf16", streams["bfloat16"]), ("fp32", streams["float32"]),
                      ("bf16 int8", s8)) * 2:
        rates.setdefault(label, []).append(frames_per_second(st, frames_dev, torch))
    host = stream(on["bfloat16"], 0.5)
    host(frames)
    t0 = time.perf_counter()
    for _ in range(STREAM_REPS):
        host(frames)
    rates["bf16 from host frames to host masks"] = [
        STREAM_REPS * STREAM_BATCH / (time.perf_counter() - t0)]
    print(f"  stream frames/s at batch {STREAM_BATCH} (frames on the card): " + ", ".join(
        f"{k} {' / '.join(f'{r:.1f}' for r in v)}" for k, v in rates.items()) + f" [{smi}]")
    rec["frames_per_s"] = rates
    del probs, p8, s8, streams, off, on8
    return ckpt, on, frames_dev


def dry_run(torch, dev, smi, report, launches, on, frames_dev, phase_dir):
    """Phase 14: two ranks on the one card (gloo, a file rendezvous under
    build/), each a process of this script (``--rank``), serve the 1024 px
    model over a (data=1, spatial=2) mesh; their gathered outputs held to
    the unsharded ones on the same card, their K7 launches counted."""
    import subprocess

    from unet_image_segmentation_tpu_torch import serving_quant as sq
    from unet_image_segmentation_tpu_torch.parallel.mesh import create_mesh
    from unet_image_segmentation_tpu_torch.streaming import StreamingPredictor

    dry = os.path.join(phase_dir, "dry")
    os.makedirs(dry)
    x = synthetic_scenes(DRY_BATCH, STREAM_IMAGE, SEED + 16)
    np.save(os.path.join(dry, "x.npy"), x)
    np.save(os.path.join(dry, "frames.npy"), frames_dev[:DRY_BATCH].cpu().numpy())
    xd = torch.from_numpy(x).to(dev)
    kw8 = on["bfloat16"].serving_kwargs
    scales = sq.calibrate_chained(on["bfloat16"].variables, xd, **kw8)
    with open(os.path.join(dry, "scales.json"), "w") as f:
        json.dump(scales, f)
    torch.cuda.empty_cache()
    print(f"dry run: {DRY_RANKS} ranks on the one card, gloo, a (data=1, spatial={DRY_RANKS}) "
          f"mesh, {STREAM_IMAGE} px, batch {DRY_BATCH}:")
    logs = [open(os.path.join(dry, f"rank{r}.log"), "w+") for r in range(DRY_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), dry],
                              cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    join_ranks(procs, logs, RANK_TIMEOUT, "dry run")
    out = dict(np.load(os.path.join(dry, "out.npz")))
    counts = []
    for r in range(DRY_RANKS):
        with open(os.path.join(dry, f"counts{r}.json")) as f:
            counts.append(json.load(f))
    for key in ("sepconv_pair_edge", "sepconv_pair_quant_out"):
        launches[key] = sum(c[key] for c in counts)
    rec = report["dry_run"] = {"counts": counts}
    # the unsharded references on the same card
    refs = {f"float {d}": on[d].forward_fn(xd).cpu().numpy() for d in on}
    refs["quant"] = sq.build_serving_forward_sharded_quant(
        on["bfloat16"].variables, scales, create_mesh(), **kw8, device=dev)(xd).cpu().numpy()
    refs["stream probs"] = StreamingPredictor(on["bfloat16"], STREAM_FRAME, DRY_BATCH,
                                              threshold=None).run_device(
        frames_dev[:DRY_BATCH]).cpu().numpy()
    for key, ref in refs.items():
        got = out[key]
        diff = np.abs(got - ref)
        err, share = float(diff.max()), float((diff > 1e-5).mean())
        if key == "float float32":
            bar, ok = "max 2e-05", err <= 2e-5
        elif key == "quant":
            bar, ok = "at most 1e-3 of the elements over 1e-5", share <= 1e-3
        else:
            bar, ok = f"max {PROB_TOL['bfloat16']:g}", err <= PROB_TOL["bfloat16"]
        agree = float(((got > 0.5) == (ref > 0.5)).mean())
        if key != "float float32":
            ok = ok and agree >= MASK_MIN_AGREE["bfloat16"]
        print(f"  sharded {key} against the unsharded: max_abs_diff {err:.3e}, {share:.2e} of "
              f"elements over 1e-5 (bar: {bar}), mask agreement {agree:.6f} "
              f"{'ok' if ok else 'FAIL'}")
        rec[key] = {"max_abs_diff": err, "share_over_1e-5": share, "mask_agree": agree}
        if not ok:
            raise AssertionError(f"dry run: sharded {key} disagrees with the unsharded")
    ref = refs["stream probs"]
    near = np.abs(ref - 0.5) <= PROB_TOL["bfloat16"]
    masks = out["stream masks"]
    if not np.array_equal(masks[~near], (ref > 0.5)[~near]):
        raise AssertionError("dry run: sharded stream masks differ away from the threshold")
    print(f"  sharded stream masks equal the unsharded stream's wherever the probability is "
          f"more than {PROB_TOL['bfloat16']:g} from 0.5; all equal: "
          f"{bool(np.array_equal(masks, (ref > 0.5).astype(np.uint8)))}")


def rank_main(rank, dry):
    """One rank of phase 14's dry run (``chip_smoke.py --rank R DIR``): the
    1024 px model over a (data=1, spatial=2) mesh on cuda:0, the sharded
    float graph in bf16 and fp32, the sharded int8 graph in bf16, the
    sharded stream (probabilities and masks); rank 0 writes the gathered
    outputs, every rank its K7 launch counts."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from unet_image_segmentation_tpu_torch import serving, serving_quant as sq
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.parallel import distributed
    from unet_image_segmentation_tpu_torch.parallel.mesh import create_mesh
    from unet_image_segmentation_tpu_torch.streaming import StreamingPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    distributed.initialize("file://" + os.path.join(dry, "store"), DRY_RANKS, rank,
                           backend="gloo")
    mesh = create_mesh(data=1, spatial=DRY_RANKS)
    ckpt = os.path.join(os.path.dirname(dry), "ckpt")
    size = (STREAM_IMAGE, STREAM_IMAGE)
    preds = {d: Predictor(ckpt, size, compute_dtype=d, use_pallas=True, device=dev)
             for d in ("bfloat16", "float32")}
    x = torch.from_numpy(np.load(os.path.join(dry, "x.npy"))).to(dev)
    frames = torch.from_numpy(np.load(os.path.join(dry, "frames.npy"))).to(dev)
    with open(os.path.join(dry, "scales.json")) as f:
        scales = json.load(f)
    bf = preds["bfloat16"]
    fwds = {f"float {d}": serving.build_serving_forward_sharded(
        p.variables, mesh, **p.serving_kwargs, device=dev) for d, p in preds.items()}
    fwds["quant"] = sq.build_serving_forward_sharded_quant(bf.variables, scales, mesh,
                                                           **bf.serving_kwargs, device=dev)
    fs.reset_launch_counts()
    out = {key: mesh.gather(fwd(mesh.shard(x))).float().cpu().numpy()
           for key, fwd in fwds.items()}
    for key, th in (("stream probs", None), ("stream masks", 0.5)):
        out[key] = StreamingPredictor(bf, STREAM_FRAME, DRY_BATCH, threshold=th,
                                      mesh=mesh).run_device(frames).cpu().numpy()
    torch.cuda.synchronize()
    counts = dict(fs.LAUNCHES)
    forwards = 4   # two float graphs, two streams; and one int8 graph
    want = dict.fromkeys(counts, 0)
    want.update(sepconv_pair=PAIR_LAUNCHES_PER_FORWARD * forwards,
                sepconv_pair_int8=PAIR_LAUNCHES_PER_FORWARD - STREAM_LAUNCHES_QUANT_OUT,
                sepconv_pair_quant_out=STREAM_LAUNCHES_QUANT_OUT,
                sepconv_pair_edge=STREAM_LAUNCHES_EDGE * (forwards + 1))
    print(f"launches {counts}")
    if counts != want:
        raise AssertionError(f"rank {rank}: expected {want}, got {counts}")
    fwd = fwds["float bfloat16"]
    shard = mesh.shard(x)
    fwd(shard)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STREAM_REPS):
        fwd(shard)
    torch.cuda.synchronize()
    print(f"a bf16 sharded forward of {DRY_BATCH} images: "
          f"{(time.perf_counter() - t0) / STREAM_REPS * 1e3:.1f} ms on the host clock (two ranks "
          "sharing one card through the host: not a speed figure)")
    with open(os.path.join(dry, f"counts{rank}.json"), "w") as f:
        json.dump(counts, f)
    if rank == 0:
        np.savez(os.path.join(dry, "out.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 15: row-sharded and data-parallel training, K1's halo mode
# ---------------------------------------------------------------------------


def device_rnd(torch, dev, seed):
    """``rnd`` drawing on the card from a generator of its own, seeded:
    phase 15's inputs at 1024 px (hundreds of millions of elements) are
    drawn there, not on the host."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def drnd(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale

    drnd.gen = gen
    return drnd


def halo_inputs(torch, rnd, dev, dtype, batch, c, f, h, w):
    """Seeded inputs of one K1 call at (batch, h, w, c) -> f: x, the taps,
    the pointwise and an input affine (rows a, b)."""
    x = rnd(batch, h, w, c).to(dev, dtype)
    dw = rnd(3, 3, c, scale=(6 / (9 * c + 9)) ** 0.5).to(dev, dtype)
    pw = rnd(c, f, scale=(6 / (c + f)) ** 0.5).to(dev, dtype)
    aff2 = torch.stack([1 + 0.5 * rnd(c), 0.1 * rnd(c)]).to(dev).contiguous()
    return x, dw, pw, aff2


def judge_halo(ft, tjudge, x, dw, pw, aff, halo, label, dname):
    """K1's halo mode against its plain version: y under phase 7's
    elementwise bar, the sums under its sums' bar."""
    got = ft.chain_fwd(x, dw, pw, aff, None, halo)
    want = ft.chain_fwd_reference(x, dw, pw, aff, None, halo)
    tjudge("chain_fwd_halo", label + " y", dname, [(got[0], want[0])])
    tjudge("chain_fwd_halo", label + " sums", dname, [(got[1], want[1]), (got[2], want[2])],
           sums=True)


def halo_checks(torch, ft, rnd, dev, dtypes, tjudge):
    """Phase 15 (a): K1's halo mode against its plain version at the 18
    links of a rank of 2 row shards of the 1024 px model (batch 2) and at
    ``HALO_RAGGED`` (batch 2 and 3): halo above only, below only and both,
    with the input affine and without, each halo row random z values; zero
    halos bit for bit the K1 without a halo."""
    from unet_image_segmentation_tpu_torch.ops.kernels import build

    sms = build.sm_count(dev)
    print(f"K1 halo mode vs plain at the {len(SHARD_LINKS)} links of a rank of {TRAIN_RANKS} row "
          f"shards of {STREAM_IMAGE} px (batch {HALO_BATCH}) and at other shapes (batch "
          f"{' and '.join(map(str, HALO_RAGGED_BATCHES))}): halo above, below, both; affine "
          "on and off:")
    cases = [(name, c, f, h, w, HALO_BATCH) for name, c, f, h, w in SHARD_LINKS] + [
        (name, c, f, h, w, b) for b in HALO_RAGGED_BATCHES for name, c, f, h, w in HALO_RAGGED]
    for dname, dtype in dtypes.items():
        for name, c, f, h, w, batch in cases:
            x, dw, pw, aff2 = halo_inputs(torch, rnd, dev, dtype, batch, c, f, h, w)
            plan = ft.fwd_plan(batch, h, w, c, f, dtype, sms)
            shape = f"{name} {c}->{f}@{h}x{w} batch {batch}, cluster {plan.n} x {plan.s}"
            for aff in (aff2, None):
                full = rnd(batch, 2, w, c)
                full = (full.abs() if aff is not None else full).to(dev, dtype)  # z >= 0 after a ReLU
                for which, keep in (("above", (1, 0)), ("below", (0, 1)), ("both", (1, 1))):
                    halo = (full * torch.tensor(keep, device=dev, dtype=dtype).view(1, 2, 1, 1)
                            ).contiguous()
                    judge_halo(ft, tjudge, x, dw, pw, aff, halo,
                               f"{shape} halo {which}{' affine' if aff is not None else ''}",
                               dname)
            zero = torch.zeros(batch, 2, w, c, device=dev, dtype=dtype)
            for aff in (aff2, None):
                got, want = ft.chain_fwd(x, dw, pw, aff, None, zero), ft.chain_fwd(x, dw, pw, aff)
                if not all(torch.equal(p, q) for p, q in zip(got, want)):
                    raise AssertionError(f"chain_fwd_halo {shape} {dname}: zero halos differ from "
                                         "K1 without a halo")
        print(f"  {dname}: zero halos equal K1 without a halo bit for bit (y, Σy, Σy²) at all "
              f"{len(cases)} shapes, affine on and off")


def halo_stitch_checks(torch, ft, rnd, dev, dtypes, tjudge):
    """Phase 15 (a): each link's input of the 1024 px model (batch 2, the
    link's affine) and the 20 x 36 ragged images cut into 2 row shards,
    each run through K1's halo mode with the rows its neighbour would send
    it (z rows, zeros at the image's edges): the shards' y put together
    equal K1 on the whole image bit for bit, and their sums add up to its
    sums under the sums' bar."""
    print(f"K1 halo mode: {TRAIN_RANKS} row shards stitched against K1 on the whole image, "
          f"batch {HALO_BATCH}:")
    cases = [(name, c, f, 2 * h, w, aff) for (name, c, f, h, w), aff in
             zip(SHARD_LINKS, LINK_AFFINE)] + [
        (name, c, f, 2 * h, w, True) for name, c, f, h, w in HALO_RAGGED]
    for dname, dtype in dtypes.items():
        for name, c, f, h, w, affine in cases:
            x, dw, pw, aff2 = halo_inputs(torch, rnd, dev, dtype, HALO_BATCH, c, f, h, w)
            aff = aff2 if affine else None
            whole = ft.chain_fwd(x, dw, pw, aff)
            top, bot = x[:, :h // 2].contiguous(), x[:, h // 2:].contiguous()

            def z(rows):
                return rows if aff is None else (rows.float() * aff[0] + aff[1]).clamp_min(
                    0.0).to(dtype)

            none = torch.zeros_like(top[:, :1])
            y0 = ft.chain_fwd(top, dw, pw, aff, None, torch.cat([none, z(bot[:, :1])], 1))
            y1 = ft.chain_fwd(bot, dw, pw, aff, None, torch.cat([z(top[:, -1:]), none], 1))
            stitched = torch.cat([y0[0], y1[0]], 1)
            label = f"{name} {c}->{f}@{h}x{w}{' affine' if affine else ''} stitched"
            if not torch.equal(stitched, whole[0]):
                err = (stitched.float() - whole[0].float()).abs().max().item()
                raise AssertionError(f"chain_fwd_halo {label} {dname}: y differs from the whole "
                                     f"image's by up to {err:.3e}")
            tjudge("chain_fwd_halo", label + " sums", dname,
                   [(y0[1] + y1[1], whole[1]), (y0[2] + y1[2], whole[2])], sums=True)
        print(f"  {dname}: stitched y bit for bit the whole image's at all {len(cases)} shapes")


def time_halo_links(torch, ft, rnd, dev, dtypes, tjudge, totals, report, smi):
    """Phase 15 (a): K1's halo mode at the 18 links of a (1, 2) rank at
    the config's batch (4 x 512 x 1024), the link's affine, both halos: held
    to plain, then timed beside K1 without a halo at the same shapes, the
    plain version and the bound."""
    print(f"K1 halo mode at the {len(SHARD_LINKS)} shard links, batch {SHARD_TRAIN_BATCH}, ms "
          f"(halo / no halo / plain, bound) [{smi}]:")
    rec = report["halo_links"] = {}
    for dname, dtype in dtypes.items():
        tot = {"halo": 0.0, "no halo": 0.0, "plain": 0.0, "bound": 0.0}
        for (name, c, f, h, w), affine in zip(SHARD_LINKS, LINK_AFFINE):
            x, dw, pw, aff2 = halo_inputs(torch, rnd, dev, dtype, SHARD_TRAIN_BATCH, c, f, h, w)
            aff = aff2 if affine else None
            halo = rnd(SHARD_TRAIN_BATCH, 2, w, c).abs().to(dev, dtype)
            label = f"{name} {c}->{f}@{h}x{w}"
            judge_halo(ft, tjudge, x, dw, pw, aff, halo, f"{label} batch {SHARD_TRAIN_BATCH}",
                       dname)
            t = {"halo": time_ms(lambda: ft.chain_fwd(x, dw, pw, aff, None, halo), torch,
                                 TRAIN_REPS),
                 "no halo": time_ms(lambda: ft.chain_fwd(x, dw, pw, aff), torch, TRAIN_REPS),
                 "plain": time_ms(lambda: ft.chain_fwd_reference(x, dw, pw, aff, None, halo),
                                  torch, TRAIN_REPS)}
            t["bound"], by = roofline.bounds_ms("chain_fwd_halo", (name, c, f, h, w), dname,
                                                SHARD_TRAIN_BATCH)
            for key in tot:
                tot[key] += t[key]
            print(f"  {label} {dtype_label(dname)}: {t['halo']:.3f} / {t['no halo']:.3f} / "
                  f"{t['plain']:.3f}, bound {t['bound']:.4f} ({by})")
            rec[f"{label} {dname}"] = {**t, "bound_by": by}
            del x, halo
        totals[dname]["chain_fwd_halo"] = (tot["halo"], tot["plain"])
        rec[f"total {dname}"] = tot
        print(f"  {dname} totals over the {len(SHARD_LINKS)} links: halo {tot['halo']:.3f}, no "
              f"halo {tot['no halo']:.3f}, plain {tot['plain']:.3f}, bound {tot['bound']:.4f} ms")


def highres_train(torch, dev, smi, report, launches, rnd, dtypes, tjudge, phase_dir):
    """Phase 15 (b): ``configs/highres_1024.json`` as it is through ``fit``
    on one rank (its spatial degree 2 clamped to 1, with the Note); K3/K4 at
    its boundaries against plain; then its kernels-on step against the
    composed one (:func:`train_ab`, phase 8's bars and launches) and one
    profiled bf16 step in a process of its own."""
    from unet_image_segmentation_tpu_torch.ops import fused_train as ft
    from unet_image_segmentation_tpu_torch.train.loop import fit
    from unet_image_segmentation_tpu_torch.train.state import Config

    with open(os.path.join(ROOT, HIGHRES_CONFIG)) as f:
        base = json.load(f)
    batch = base["train"]["batch_size"]
    images, masks = synthetic_scenes(3 * batch, STREAM_IMAGE, SEED + 17, with_masks=True)
    print(f"1024 px training: {HIGHRES_CONFIG} as it is (U-Net {base['model']['filters']}, batch "
          f"{batch}, {base['model']['compute_dtype']}, dropout {base['model']['dropout_rate']}, "
          f"mesh spatial {base['mesh']['spatial_axis']}) through fit on one rank:")
    d = json.loads(json.dumps(base))
    with tempfile.TemporaryDirectory() as tmp:
        d["train"].update(epochs=1, model_out=os.path.join(tmp, "model"),
                          log_dir=os.path.join(tmp, "logs"))
        t0 = time.perf_counter()
        res = fit(Config.from_dict(d), MemoryDataset(images[:2 * batch], masks[:2 * batch]),
                  MemoryDataset(images[2 * batch:], masks[2 * batch:]), device=dev)
        loss = res.history["loss"][-1]
        print(f"  fit: 1 epoch, 2 steps + 1 validation batch in {time.perf_counter() - t0:.1f} s, "
              f"loss {loss:.4f}, val_mean_io_u {res.history['val_mean_io_u'][-1]:.4f}")
        if not np.isfinite(loss):
            raise AssertionError("1024 px fit: the loss is not finite")
        del res
    print(f"K3/K4 vs plain at the {STREAM_IMAGE} px boundaries, batch {batch}:")
    for dname, dtype in dtypes.items():
        for name, f, h in HIGHRES_POOLS:
            k = pool_case(torch, rnd, dev, dtype, batch, f, h)
            judge_pool(torch, ft, tjudge, k, f"{name} boundary F={f}@{h}", dname)
            del k
    np.save(os.path.join(phase_dir, "train_x.npy"), images[:batch])
    np.save(os.path.join(phase_dir, "train_m.npy"), masks[:batch])
    torch.cuda.empty_cache()
    report["highres_profile"] = profile_in_child(phase_dir, "--profile-train",
                                                 "train_profile.json")
    prof = report["highres_profile"]
    print(f"  bf16 profiled step (a process of its own): {prof['wall_ms_per_step']:.1f} ms a step, "
          f"device busy {prof['device_ms_per_step']:.1f} ms, idle share {prof['idle_share']:.3f} "
          f"[{smi}]")
    x = torch.from_numpy(images[:batch]).to(dev)
    m = torch.from_numpy(masks[:batch]).to(dev)
    print(f"  kernels on vs the composed path, {TRAIN_STEPS} steps each, fp32 and bf16:")
    report["highres_train"] = train_ab(torch, dev, smi, base, x, m, launches, STEP_LAUNCHES,
                                       profile=False)
    del x, m
    torch.cuda.empty_cache()


def profile_train_main(phase_dir):
    """Phase 15's profiled step (``chip_smoke.py --profile-train DIR``): one
    bf16 kernels-on step of the 1024 px config on DIR's batch under
    ``step_attribution``, its launches held to phase 8's; writes
    DIR/train_profile.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.state import Config, create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with open(os.path.join(ROOT, HIGHRES_CONFIG)) as f:
        base = json.load(f)
    cfg = Config.from_dict(base)
    model = build_unet(cfg.model, device=dev, generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(cfg, model=model, device=dev)
    step = make_train_step(model, cfg.train.loss)
    x = torch.from_numpy(np.load(os.path.join(phase_dir, "train_x.npy"))).to(dev)
    m = torch.from_numpy(np.load(os.path.join(phase_dir, "train_m.npy"))).to(dev)
    prof = traced(lambda _: attributed_step(torch, dev, step, state, x, m, base,
                                            cfg.model.compute_dtype, STEP_LAUNCHES),
                  "1024 px train profile")
    prof["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(phase_dir, "train_profile.json"), "w") as f:
        json.dump(prof, f)
    print("PROFILE_OK", flush=True)
    return 0


def shard_config(dname, dropout=0.0):
    """The 1024 px config as the dry run trains it: its batch, dropout
    ``dropout``, compute dtype ``dname``."""
    from unet_image_segmentation_tpu_torch.train.state import Config

    with open(os.path.join(ROOT, HIGHRES_CONFIG)) as f:
        d = json.load(f)
    d["model"].update(compute_dtype=dname, dropout_rate=dropout)
    return Config.from_dict(d)


def shard_run(torch, dev, dname, mesh, x, m, expect):
    """``SHARD_STEPS`` kernels-on steps of the dry run's model on ``mesh``
    (None: unsharded) from seeded weights: the losses, the step-1 gradients
    (summed over the mesh), the running statistics after the last step,
    each step's launches held to ``expect``, and the K1 halo-mode launches
    counted over the steps."""
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    cfg = shard_config(dname)
    model = build_unet(cfg.model, device=dev, generator=torch.Generator().manual_seed(SEED))
    if mesh is not None:
        model.set_groups(mesh.group, mesh.spatial_group)
    state = create_train_state(cfg, model=model, device=dev)
    step = make_train_step(model, cfg.train.loss, mesh)
    if mesh is not None:
        x, m = mesh.shard(x), mesh.shard(m)
    out = {"losses": [], "halo_launches": 0}
    for i in range(SHARD_STEPS):
        reset_train_counts()
        out["losses"].append(float(step(state, x, m)["loss"]))
        torch.cuda.synchronize()
        counts = train_counts()
        out["halo_launches"] += counts["chain_fwd_halo"]
        if counts != expect:
            raise AssertionError(f"{dname} step {i + 1}: expected launches {expect}, got {counts}")
        if i == 0:
            out["grads"] = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
            out["stats1"] = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
    out["stats"] = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
    return out


def train_rank_main(rank, dry):
    """One rank of phase 15's dry run (``chip_smoke.py --train-rank R
    DIR``): on cuda:0 with gloo, ``SHARD_STEPS`` steps of the 1024 px model
    on each mesh of ``SHARD_MESHES`` in fp32 and bf16 (global batch 4,
    dropout 0), its launches held (18 K1 halo-mode launches a step on a
    row-sharded rank); then one row-sharded step with dropout 0.2, the
    keep masks its dropout sites applied recorded and compared between the
    two ranks. Rank 0 writes the results."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from unet_image_segmentation_tpu_torch.models import unet as unet_mod
    from unet_image_segmentation_tpu_torch.ops import hash_dropout as hd
    from unet_image_segmentation_tpu_torch.parallel import distributed
    from unet_image_segmentation_tpu_torch.parallel.mesh import create_mesh
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    distributed.initialize("file://" + os.path.join(dry, "store"), TRAIN_RANKS, rank,
                           backend="gloo")
    x = torch.from_numpy(np.load(os.path.join(dry, "x.npy"))).to(dev)
    m = torch.from_numpy(np.load(os.path.join(dry, "m.npy"))).to(dev)
    meshes = {shape: create_mesh(*shape) for shape in SHARD_MESHES}
    out, halo_launches = {}, 0
    for shape, mesh in meshes.items():
        rows = shape[1] > 1
        expect = {**STEP_LAUNCHES, "chain_fwd_halo": SHARD_LAUNCHES_HALO if rows else 0}
        for dname in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            run = shard_run(torch, dev, dname, mesh, x, m, expect)
            halo_launches += run["halo_launches"]
            print(f"mesh {shape} {dname}: losses {run['losses']}, launches a step {expect} "
                  f"({time.perf_counter() - t0:.1f} s on the host clock, two ranks sharing one "
                  "card: not a speed figure)", flush=True)
            key = f"{shape[0]}x{shape[1]} {dname}"
            out[f"{key} losses"] = np.array(run["losses"])
            out.update({f"{key} grad {n}": g.numpy() for n, g in run["grads"].items()})
            for part in ("stats", "stats1"):
                out.update({f"{key} {part} {n}": b.numpy() for n, b in run[part].items()})
            del run
            torch.cuda.empty_cache()
    # dropout 0.2 on the row shards: the step runs, and the keep masks that
    # its dropout sites (the bottleneck's, and the decoder's hoisted before
    # their chains) applied differ between the ranks
    mesh = meshes[(1, TRAIN_RANKS)]
    cfg = shard_config("bfloat16", dropout=0.2)
    model = unet_mod.build_unet(cfg.model, device=dev,
                                generator=torch.Generator().manual_seed(SEED))
    model.set_groups(mesh.group, mesh.spatial_group)
    state = create_train_state(cfg, model=model, device=dev)
    sites = []

    def recorded(t, seed, rate):
        """The model's dropout, its keep mask kept (the first 8 rows of
        sample 0, 64 channels) once the output shows it is the one applied."""
        y = hd.hash_dropout(t, seed, rate)
        keep = hd.keep_mask(t.shape, seed, hd.keep_threshold(rate), t.device)
        if not torch.equal(y, hd.apply_keep(t, keep, hd.inv_keep(rate))):
            raise AssertionError(f"rank {rank}: a dropout site's output is not its keep mask's")
        sites.append(keep[0, :8, :, :64].to(torch.int32).cpu())
        return y

    unet_mod.hash_dropout = recorded
    try:
        loss = float(make_train_step(model, cfg.train.loss, mesh)(state, mesh.shard(x),
                                                                  mesh.shard(m))["loss"])
    finally:
        unet_mod.hash_dropout = hd.hash_dropout
    if not np.isfinite(loss):
        raise AssertionError(f"rank {rank}: the dropout step's loss is {loss}")
    if len(sites) != len(cfg.model.filters):   # the bottleneck and decoder stages 4..2
        raise AssertionError(f"rank {rank}: {len(sites)} dropout sites ran, expected "
                             f"{len(cfg.model.filters)}")
    differ = []
    for keep in sites:
        both = torch.zeros((TRAIN_RANKS,) + tuple(keep.shape), dtype=torch.int32)
        both[rank] = keep
        dist.all_reduce(both)
        differ.append(float((both[0] != both[1]).float().mean()))
    print(f"dropout 0.2 row-sharded step: loss {loss:.6f}; the keep masks the step's "
          f"{len(sites)} dropout sites applied differ between the ranks at "
          f"{[round(d, 4) for d in differ]} of the elements compared", flush=True)
    if min(differ) == 0.0:
        raise AssertionError("a dropout site applied the same keep mask on both ranks")
    out["dropout"] = np.array([loss, *differ])
    with open(os.path.join(dry, f"counts{rank}.json"), "w") as f:
        json.dump({"chain_fwd_halo": halo_launches}, f)
    if rank == 0:
        np.savez(os.path.join(dry, "out.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)
    return 0


def hold_shard(torch, label, dname, got, ref, ref_dtype=None, own=None):
    """One sharded run against the unsharded one. fp32: the losses within
    ``SHARD_LOSS_TOL`` relative, each step-1 gradient tensor within
    ``SHARD_GRAD_TOL`` of its max|g| with a cosine of at least
    ``SHARD_GRAD_COS``, the running statistics within ``SHARD_STATS_TOL``
    relative after step 1 and ``SHARD_STATS_TOL_STEP2`` after step 2. bf16
    (phase 8's rule): the losses within its bf16 loss bar of the unsharded
    bf16 run's; gradients and statistics against the fp32 unsharded run
    ``ref_dtype``, each tensor's error at most ``BF16_GRAD_FACTOR`` x the
    unsharded bf16 run's (``own``) plus ``BF16_GRAD_SLACK``. Returns (ok,
    the worst numbers)."""
    rec = {}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    loss_bar = SHARD_LOSS_TOL if dname == "float32" else TRAIN_LOSS_TOL[dname]
    ok = loss_rel <= loss_bar
    rec["loss_rel"] = loss_rel
    if dname == "float32":
        g_rel = {n: rel_max(got["grads"][n], g) for n, g in ref["grads"].items()}
        g_cos = {n: cosine(got["grads"][n], g) for n, g in ref["grads"].items()}
        wg, wc = max(g_rel, key=g_rel.get), min(g_cos, key=g_cos.get)
        ok = ok and g_rel[wg] <= SHARD_GRAD_TOL and g_cos[wc] >= SHARD_GRAD_COS
        text = []
        for part, bar in (("stats1", SHARD_STATS_TOL), ("stats", SHARD_STATS_TOL_STEP2)):
            s_rel = {n: rel_max(got[part][n], b) for n, b in ref[part].items()}
            ws = max(s_rel, key=s_rel.get)
            ok = ok and s_rel[ws] <= bar
            rec[f"{part}_rel"] = s_rel[ws]
            text.append(f"after step {1 if part == 'stats1' else SHARD_STEPS} {s_rel[ws]:.2e} at "
                        f"{ws} (bar {bar:g})")
        print(f"  {label} {dname}: losses {got['losses']} vs {ref['losses']} (max rel "
              f"{loss_rel:.2e}, bar {loss_bar:g}); gradients max |diff| / max|g| "
              f"{g_rel[wg]:.2e} at {wg} (bar {SHARD_GRAD_TOL:g}), median "
              f"{float(np.median(list(g_rel.values()))):.2e}, min cosine {g_cos[wc]:.8f} at {wc} "
              f"(bar {SHARD_GRAD_COS}); running stats max rel " + ", ".join(text) +
              f" {'ok' if ok else 'FAIL'}")
        rec.update(grad_rel=g_rel[wg], grad_cos=g_cos[wc])
    else:
        for part in ("grads", "stats"):
            err = {n: rel_max(got[part][n], g) for n, g in ref_dtype[part].items()}
            base = {n: rel_max(own[part][n], g) for n, g in ref_dtype[part].items()}
            excess = {n: err[n] - BF16_GRAD_FACTOR * base[n] for n in err}
            w = max(excess, key=excess.get)
            ok = ok and excess[w] <= BF16_GRAD_SLACK
            rec[f"{part}_excess"] = excess[w]
            print(f"  {label} {dname} {part} against the fp32 unsharded run: sharded max rel err "
                  f"{max(err.values()):.2e}, unsharded bf16 {max(base.values()):.2e}; per tensor "
                  f"sharded <= {BF16_GRAD_FACTOR:g} x unsharded + {BF16_GRAD_SLACK:g} (worst {w}: "
                  f"{err[w]:.2e} vs {base[w]:.2e})")
        print(f"  {label} {dname}: losses {got['losses']} vs {ref['losses']} (max rel "
              f"{loss_rel:.2e}, bar {loss_bar:g}) {'ok' if ok else 'FAIL'}")
    return ok, rec


def train_dry_run(torch, dev, smi, report, launches, phase_dir):
    """Phase 15 (c): the unsharded steps on the card (fp32, bf16), then two
    ranks of this script (``--train-rank``) on the one card, gloo, training
    over each mesh of ``SHARD_MESHES``; each held to the unsharded step
    (:func:`hold_shard`); a rank that fails or hangs fails the run."""
    import subprocess

    dry = os.path.join(phase_dir, "train_dry")
    os.makedirs(dry)
    batch = SHARD_TRAIN_BATCH
    images, masks = synthetic_scenes(batch, STREAM_IMAGE, SEED + 18, with_masks=True)
    np.save(os.path.join(dry, "x.npy"), images)
    np.save(os.path.join(dry, "m.npy"), masks)
    x, m = torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev)
    print(f"sharded training dry run: the {STREAM_IMAGE} px model at full width, global batch "
          f"{batch}, dropout 0, {SHARD_STEPS} steps; unsharded on the card, then {TRAIN_RANKS} "
          f"ranks on the one card (gloo) over meshes (data, spatial) {SHARD_MESHES}:")
    refs = {d: shard_run(torch, dev, d, None, x, m, STEP_LAUNCHES) for d in ("float32",
                                                                              "bfloat16")}
    for d, r in refs.items():
        print(f"  unsharded {d}: losses {r['losses']}")
    del x, m
    torch.cuda.empty_cache()
    logs = [open(os.path.join(dry, f"rank{r}.log"), "w+") for r in range(TRAIN_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--train-rank", str(r),
                               dry], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    join_ranks(procs, logs, TRAIN_RANK_TIMEOUT, "train dry run")
    out = dict(np.load(os.path.join(dry, "out.npz")))
    counts = []
    for r in range(TRAIN_RANKS):
        with open(os.path.join(dry, f"counts{r}.json")) as f:
            counts.append(json.load(f))
    launches["chain_fwd_halo"] = sum(c["chain_fwd_halo"] for c in counts)
    rec = report["train_dry_run"] = {"halo_launches": counts, "dropout": out["dropout"].tolist()}
    names = refs["float32"]["grads"].keys()
    stat_names = refs["float32"]["stats"].keys()
    failed = []
    for shape in SHARD_MESHES:
        label = f"mesh (data {shape[0]}, spatial {shape[1]})"
        rec[label] = {}
        for dname in ("float32", "bfloat16"):
            key = f"{shape[0]}x{shape[1]} {dname}"
            got = {"losses": out[f"{key} losses"].tolist(),
                   "grads": {n: torch.from_numpy(out[f"{key} grad {n}"]) for n in names}}
            for part in ("stats", "stats1"):
                got[part] = {n: torch.from_numpy(out[f"{key} {part} {n}"]) for n in stat_names}
            ok, rec[label][dname] = hold_shard(
                torch, label, dname, got, refs[dname], ref_dtype=refs["float32"],
                own=refs["bfloat16"])
            if not ok:
                failed.append(f"{label} {dname}")
    if failed:
        raise AssertionError(f"the sharded steps disagree with the unsharded: {failed}")


# phase 16's loading process: ``python -c EXPORT_CHILD KIND DIR``, run
# from DIR, with the repository on the path only for the kernel graphs. It
# starts with the phase, so its imports and the card's context overlap the
# exports, and loads the artifacts once DIR/go exists
EXPORT_CHILD = r"""
import json, os, sys, time
t_start = time.perf_counter()
import numpy as np
import torch
kind, phase_dir, node, timeout = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])
if kind == "kernel":
    from unet_image_segmentation_tpu_torch.export.pt2 import load_pt2
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
torch.zeros(1, device=dev)
out = {"import_s": time.perf_counter() - t_start}
while not os.path.exists(os.path.join(phase_dir, "go")):
    if time.perf_counter() - t_start > timeout:
        sys.exit("no artifacts to load")
    time.sleep(0.05)
images = np.load(os.path.join(phase_dir, "x.npy"))
for name in sorted(os.listdir(phase_dir)):
    art = os.path.join(phase_dir, name)
    if not name.startswith(kind + "-"):
        continue
    t0 = time.perf_counter()
    program = torch.export.load(os.path.join(art, "model.pt2"))
    module = program.module()
    res = {"load_s": time.perf_counter() - t0,
           "nodes": sum(str(n.target) == node for n in program.graph.nodes)}
    with open(os.path.join(art, "metadata.json")) as f:
        batch = json.load(f)["input"]["shape"][0]
    x = torch.from_numpy(images[:batch]).to(dev)
    with torch.no_grad():
        if kind == "kernel":
            fs.reset_launch_counts()
        y = module(x)
        torch.cuda.synchronize()
        if kind == "kernel":
            res["launches"] = fs.LAUNCHES["sepconv_block"]
            call, _ = load_pt2(art, "cuda")
            res["load_pt2_max_diff"] = float(np.abs(call(images[:batch]) - y.cpu().numpy()).max())
    np.save(os.path.join(art, "y.npy"), y.cpu().numpy())
    out[name] = res
out["port_modules"] = sorted(m for m in sys.modules if m.startswith("unet_image_segmentation"))
print(json.dumps(out))
"""


def start_export_child(kind, phase_dir):
    """Phase 16: start one loading process (:data:`EXPORT_CHILD`) of
    ``kind``'s artifacts, its output in ``phase_dir``; the plain graphs'
    process finds no module of the repository on its path."""
    import subprocess

    env = dict(os.environ)
    if kind == "kernel":
        env["PYTHONPATH"] = ROOT
    else:
        env.pop("PYTHONPATH", None)
    with open(os.path.join(phase_dir, f"{kind}.out"), "w") as o, \
            open(os.path.join(phase_dir, f"{kind}.err"), "w") as e:
        return subprocess.Popen(
            [sys.executable, "-c", EXPORT_CHILD, kind, phase_dir, EXPORT_NODE,
             str(EXPORT_CHILD_TIMEOUT)],
            cwd=phase_dir if kind == "plain" else ROOT, env=env, stdout=o, stderr=e)


def join_export_child(kind, proc, phase_dir):
    """The JSON line of a loading process; it failing or hanging fails the run."""
    import subprocess

    try:
        rc = proc.wait(timeout=EXPORT_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at its time limit"
    with open(os.path.join(phase_dir, f"{kind}.out")) as o, \
            open(os.path.join(phase_dir, f"{kind}.err")) as e:
        text, err = o.read(), e.read()
    if rc != 0:
        raise AssertionError(f"phase 16 {kind} loading process: exit {rc}\n{text[-3000:]}"
                             f"{err[-3000:]}")
    return json.loads(text.strip().splitlines()[-1])


def forward_rates(torch, modules, x):
    """Host-clock images/s of each of ``modules`` (name -> forward) in
    turns, twice round, ``EXPORT_REPS`` forwards a rate after warm-ups."""
    rates = {name: [] for name in modules}
    with torch.no_grad():
        for fn in modules.values():
            for _ in range(3):
                fn(x)
        for _ in range(2):
            for name, fn in modules.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(EXPORT_REPS):
                    fn(x)
                torch.cuda.synchronize()
                rates[name].append(EXPORT_REPS * x.shape[0] / (time.perf_counter() - t0))
    return rates


def export_path(torch, dev, smi, report, state, scenes, fit_out):
    """Phase 16: ``export_pt2`` of phase 5's checkpoint (the plain and the
    ``use_pallas`` model, batch 1 and 32, fp32 and bf16) on the card, each
    artifact loaded in a fresh process (:func:`start_export_child`): each
    loaded graph held to its in-memory module, and the kernel graph to the
    same graph with K8's plain version, under phase 3's K8 bars relative to
    max|plain|; the kernel graph to the plain graph under K8's fp32 bar and
    phase 5's bf16 mask agreement; 18 op nodes and 18 K8 launches a forward
    of a kernel graph (that process's counter); then the batch-32 artifacts
    loaded here and timed in turns with their in-memory modules (images/s);
    then the CLI's ``pt2`` on phase 8's ``fit`` checkpoint, held to its
    module."""
    from unet_image_segmentation_tpu_torch.cli.export import main as export_main
    from unet_image_segmentation_tpu_torch.export.pt2 import export_pt2, load_pt2
    from unet_image_segmentation_tpu_torch.models.unet import UNet
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.train.checkpoint import load_inference_variables

    t_start = time.perf_counter()
    phase_dir = os.path.join(ROOT, "build", "phase16")
    shutil.rmtree(phase_dir, ignore_errors=True)
    os.makedirs(phase_dir)
    procs = {kind: start_export_child(kind, phase_dir) for kind in EXPORT_KINDS}
    try:
        np.save(os.path.join(phase_dir, "x.npy"), scenes[:max(EXPORT_BATCHES)])
        out = report["export"] = {"artifacts": {}, "images_per_s": {}}
        wanted, plain_k8, models = {}, {}, {}
        print(f"export: phase 5's checkpoint through export_pt2 on {dev}, batches "
              f"{' and '.join(map(str, EXPORT_BATCHES))}, fp32 and bf16, plain and use_pallas; "
              "each artifact loaded in a fresh process")
        for dname in ("float32", "bfloat16"):
            for kind in EXPORT_KINDS:
                model = UNet(filters=FILTERS, dtype=getattr(torch, dname),
                             use_pallas=kind == "kernel")
                model.load_state_dict(state)
                models[(dname, kind)] = model.to(dev)
                for batch in EXPORT_BATCHES:
                    name = f"{kind}-{dname}-b{batch}"
                    t0 = time.perf_counter()
                    export_pt2(model, os.path.join(phase_dir, name), batch_size=batch,
                               image_size=(IMAGE, IMAGE), device=dev)
                    out["artifacts"][name] = {"export_s": time.perf_counter() - t0}
                    x = torch.from_numpy(scenes[:batch]).to(dev)
                    with torch.no_grad():
                        wanted[name] = model(x).cpu().numpy()
                        if kind == "kernel":   # the same graph with K8's plain version
                            with patched(fs, "sepconv_block", fs.sepconv_block_reference):
                                plain_k8[name] = model(x).cpu().numpy()
        t_exports = time.perf_counter() - t_start
        open(os.path.join(phase_dir, "go"), "w").close()
        loaded = {kind: join_export_child(kind, proc, phase_dir) for kind, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t_children = time.perf_counter() - t_start - t_exports
    if loaded["plain"]["port_modules"]:
        raise AssertionError(f"the plain graphs' process imported {loaded['plain']['port_modules']}")
    print(f"  loading processes: plain graphs with torch alone (no module of the repository "
          f"imported), kernel graphs through load_pt2 [{smi}]")
    for dname in ("float32", "bfloat16"):
        tol = KERNEL_TOL[dname]
        for batch in EXPORT_BATCHES:
            names = {kind: f"{kind}-{dname}-b{batch}" for kind in EXPORT_KINDS}
            ys = {kind: np.load(os.path.join(phase_dir, n, "y.npy")) for kind, n in names.items()}
            res = {kind: loaded[kind][n] for kind, n in names.items()}
            for kind, y in ys.items():
                if y.shape != (batch, IMAGE, IMAGE, 1) or not np.isfinite(y).all():
                    raise AssertionError(f"{names[kind]}: bad output {y.shape}")
            pairs = {"kernel graph vs its plain K8": (ys["kernel"], plain_k8[names["kernel"]]),
                     "plain graph vs its module": (ys["plain"], wanted[names["plain"]]),
                     "kernel graph vs its module": (ys["kernel"], wanted[names["kernel"]]),
                     "kernel graph vs plain graph": (ys["kernel"], ys["plain"])}
            errs = {}
            for label, (got, want) in pairs.items():
                err = float(np.abs(got - want).max())
                errs[label] = (err, err / max(float(np.abs(want).max()), 1e-30))
            # K8's bars hold the first three; the kernel graph against the
            # plain graph is phase 5's kernels-on against kernels-off
            # comparison of the whole forward, whose bf16 roundings part
            # through 18 blocks (phase 5's module path: 0.056 at batch 2):
            # fp32 under K8's bar, bf16 under phase 5's mask agreement
            agree = float(((ys["kernel"] > 0.5) == (ys["plain"] > 0.5)).mean())
            err, rel = errs["kernel graph vs plain graph"]
            graphs_ok = all(errs[label][1] <= tol for label in list(pairs)[:3]) and (
                rel <= tol if dname == "float32" else agree >= MASK_MIN_AGREE[dname])
            bars = (f"tol {tol:g}" if dname == "float32" else
                    f"tol {tol:g} but the last; mask agreement {agree:.6f} (min "
                    f"{MASK_MIN_AGREE[dname]})")
            k = res["kernel"]
            ok = graphs_ok and res["plain"]["nodes"] == 0 and \
                k["nodes"] == k["launches"] == BLOCK_LAUNCHES_PER_FORWARD
            print(f"  {dtype_label(dname)} batch {batch}: " + ", ".join(
                f"{label} max_abs_err {e:.3e} rel {r:.3e}" for label, (e, r) in errs.items()) +
                f" ({bars}); kernel graph {k['nodes']} op nodes, {k['launches']} K8 "
                f"launches a forward, load_pt2's call {k['load_pt2_max_diff']:.1e} from its "
                f"module; loaded in {res['plain']['load_s']:.2f} / {k['load_s']:.2f} s "
                f"{'ok' if ok else 'FAIL'}")
            for kind, n in names.items():
                out["artifacts"][n].update(res[kind], max_abs_err=errs[f"{kind} graph vs its "
                                                                       f"module"][0])
            out["artifacts"][names["kernel"]].update(
                vs_plain_k8=errs["kernel graph vs its plain K8"][0], vs_plain_graph=err,
                mask_agree=agree)
            if not ok:
                raise AssertionError(f"export {dname} batch {batch}: {errs}, {res}")
    t0 = time.perf_counter()
    x = torch.from_numpy(scenes[:BATCH_SERVE]).to(dev)
    for dname in ("float32", "bfloat16"):
        fns = {}
        for kind in EXPORT_KINDS:
            art = os.path.join(phase_dir, f"{kind}-{dname}-b{BATCH_SERVE}", "model.pt2")
            fns[f"{kind} loaded"] = torch.export.load(art).module()
            fns[f"{kind} in memory"] = models[(dname, kind)]
        rates = out["images_per_s"][dname] = forward_rates(torch, fns, x)
        print(f"  {dtype_label(dname)} forward at batch {BATCH_SERVE}, images/s in turns: " +
              ", ".join(f"{label} {' / '.join(f'{r:.1f}' for r in v)}"
                        for label, v in rates.items()) + f" [{smi}]")
        del fns
    del models
    t_rates = time.perf_counter() - t0

    cli_dir = os.path.join(phase_dir, "cli")
    rc = export_main(["pt2", fit_out, cli_dir, "--image-size", str(IMAGE), "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"export CLI pt2 on {fit_out}: exit code {rc}")
    call, meta = load_pt2(cli_dir, device="cuda")
    sd, kwargs = load_inference_variables(fit_out)
    model = UNet(**{k: v for k, v in kwargs.items() if k in (
        "num_classes", "filters", "dropout_rate", "use_batch_norm", "conv_type")}, device=dev)
    model.load_state_dict(sd)
    with torch.no_grad():
        want = model(torch.from_numpy(scenes[:1]).to(dev)).cpu().numpy()
    got = call(scenes[:1])
    err = float(np.abs(got - want).max())
    rel = err / max(float(np.abs(want).max()), 1e-30)
    ok = got.shape == (1, IMAGE, IMAGE, 1) and rel <= KERNEL_TOL["float32"] and \
        meta["format"] == "torch.export"
    print(f"  export CLI pt2 on {fit_out}/best: {meta['input']['shape']} -> "
          f"{meta['output']['shape']}, against its module max_abs_err {err:.3e} rel {rel:.3e} "
          f"(tol {KERNEL_TOL['float32']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("export CLI pt2: the artifact disagrees with its checkpoint")
    out["cli_max_abs_err"] = err
    out["seconds"] = time.perf_counter() - t_start
    export_s = [a["export_s"] for a in out["artifacts"].values()]
    print(f"phase 16 on the host clock: {out['seconds']:.1f} s: the exports and in-memory runs "
          f"{t_exports:.1f} s (export_pt2 {sum(export_s):.1f} s, "
          f"{' / '.join(f'{t:.1f}' for t in export_s)}), the loading processes after them "
          f"{t_children:.1f} s (imports and the card's context, during the exports: " +
          ", ".join(f"{kind} {loaded[kind]['import_s']:.1f} s" for kind in EXPORT_KINDS) +
          f"), the rates {t_rates:.1f} s")


def quality_gate_path(torch, dev, smi, report):
    """Phase 17: the quality gate's ``torch`` stage on a pack written on the card."""
    from unet_image_segmentation_tpu_torch.data.packed import write_pack
    from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_256 as q

    workdir = os.path.join(ROOT, "build", "phase17")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(workdir, "packs"))
    n_train, n_val = GATE_SCENES
    images, masks = synthetic_scenes(n_train + n_val, IMAGE, SEED + 17, with_masks=True)
    u8 = np.round(images * 255.0).astype(np.uint8), np.round(masks * 255.0).astype(np.uint8)
    for split, rows in (("train", slice(0, n_train)), ("val", slice(n_train, None))):
        write_pack(q.pack_path(workdir, split), u8[0][rows], u8[1][rows])
    protocol = q.Protocol(image_size=IMAGE, n_train=n_train, n_val=n_val, epochs=1, seeds=(SEED,))
    q.write_stamp(workdir, protocol, "chip_smoke numpy scenes", None)
    print(f"quality gate (troubleshoot/quality_gate_256.py), torch stage: {n_train} train / "
          f"{n_val} val numpy scenes packed on the card, one seed, one epoch of "
          f"{n_train // protocol.batch} steps at batch {protocol.batch}, full width, fp32")
    t0 = time.perf_counter()
    res = q.stage_torch(workdir, device=dev, protocol=protocol, verbose=False)
    seconds = time.perf_counter() - t0
    rec = res["seeds"][str(SEED)]
    per_step = {k: rec["launches_per_step"][k] for k in STEP_LAUNCHES}
    k8 = (rec["launches_per_val_forward"], rec["launches_first_predict"]["sepconv_block"])
    print(f"  val IoU {rec['val_iou']:.4f}, loss {rec['loss_per_epoch']}, {rec['steps']} steps, "
          f"native loader {rec['native_loader']}; launches a step {per_step}; K8 a validation "
          f"forward {k8[0]}, in the first predict forward {k8[1]}")
    if rec["steps"] != n_train // protocol.batch or per_step != STEP_LAUNCHES or \
            k8 != (BLOCK_LAUNCHES_PER_FORWARD, BLOCK_LAUNCHES_PER_FORWARD) or \
            not 0.0 <= rec["val_iou"] <= 1.0 or not np.isfinite(rec["loss_per_epoch"]).all():
        raise AssertionError(f"quality gate stage: expected {STEP_LAUNCHES} a step and "
                             f"{BLOCK_LAUNCHES_PER_FORWARD} K8 a forward, got {rec}")
    path = q.pack_path(workdir, "val")
    with open(path, "r+b") as f:   # one byte of one image changed
        f.seek(4096)
        byte = f.read(1)[0]
        f.seek(4096)
        f.write(bytes([byte ^ 1]))
    try:
        q.stage_torch(workdir, device=dev, protocol=protocol, verbose=False)
    except ValueError as e:
        print(f"  a pack with one byte changed is refused: {e}")
    else:
        raise AssertionError("quality gate stage: a changed pack was not refused")
    print(f"phase 17 on the host clock: the torch stage {seconds:.1f} s (budget {GATE_SECONDS} s) "
          f"[{smi}]")
    report["quality_gate"] = {"seconds": seconds, **rec}


def quality_gate_mc_path(torch, dev, smi, report):
    """Phase 18: the 3-class quality gate's ``torch`` stage on class-id packs
    written on the card, the kernel leg ('auto') and the K11 leg ('all')."""
    from unet_image_segmentation_tpu_torch.data.packed import write_pack
    from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_256 as q
    from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_512mc as mc

    workdir = os.path.join(ROOT, "build", "phase18")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(workdir, "packs"))
    n_train, n_val = GATE_MC_SCENES
    images, ids = multiclass_scenes(n_train + n_val, MC_IMAGE, SEED + 18)
    u8 = np.round(images * 255.0).astype(np.uint8), ids.astype(np.uint8)
    for split, rows in (("train", slice(0, n_train)), ("val", slice(n_train, None))):
        write_pack(q.pack_path(workdir, split), u8[0][rows], u8[1][rows], mask_is_class_id=True)
    protocol = q.Protocol(image_size=MC_IMAGE, n_train=n_train, n_val=n_val, epochs=1,
                          seeds=mc.ALL_LEG_SEEDS, num_classes=mc.N_CLASSES, mask_mode="class_id",
                          loss="cce")
    q.write_stamp(workdir, protocol, "chip_smoke numpy class-id scenes", None)
    print(f"3-class quality gate (troubleshoot/quality_gate_512mc.py), torch stage: {n_train} "
          f"train / {n_val} val numpy class-id scenes at {MC_IMAGE} px packed on the card, one "
          f"seed, one epoch of {n_train // protocol.batch} steps at batch {protocol.batch}, full "
          "width, fp32, cce; fused_head 'auto', then 'all'")
    t0 = time.perf_counter()
    legs = {}
    for name, fused_all, want in (("auto", False, STEP_LAUNCHES_HEAD_OFF),
                                  ("all", True, MC_STEP_LAUNCHES)):
        res = mc.stage_torch(workdir, protocol, device=dev, fused_head_all=fused_all,
                             verbose=False)
        rec = res["seeds"][str(protocol.seeds[0])]
        per_step = {k: rec["launches_per_step"][k] for k in want}
        k8 = (rec["launches_per_val_forward"], rec["launches_first_predict"]["sepconv_block"])
        print(f"  fused_head {name!r}: per-class IoU {[round(v, 4) for v in rec['per_class_iou']]}"
              f", loss {rec['loss_per_epoch']}, {rec['steps']} steps, native loader "
              f"{rec['native_loader']}; launches a step {per_step}; K8 a validation forward "
              f"{k8[0]}, in the first predict forward {k8[1]}")
        if res["fused_head"] != name or rec["steps"] != n_train // protocol.batch or \
                per_step != want or \
                k8 != (BLOCK_LAUNCHES_PER_FORWARD, BLOCK_LAUNCHES_PER_FORWARD) or \
                not all(0.0 <= v <= 1.0 for v in rec["per_class_iou"]) or \
                not np.isfinite(rec["loss_per_epoch"]).all():
            raise AssertionError(f"3-class quality gate stage, fused_head {name!r}: expected "
                                 f"{want} a step and {BLOCK_LAUNCHES_PER_FORWARD} K8 a forward, "
                                 f"got {rec}")
        legs[name] = rec
    seconds = time.perf_counter() - t0
    path = q.pack_path(workdir, "train")
    with open(path, "r+b") as f:   # one byte of one image changed
        f.seek(8192)
        byte = f.read(1)[0]
        f.seek(8192)
        f.write(bytes([byte ^ 1]))
    try:
        mc.stage_torch(workdir, protocol, device=dev, verbose=False)
    except ValueError as e:
        print(f"  a pack with one byte changed is refused: {e}")
    else:
        raise AssertionError("3-class quality gate stage: a changed pack was not refused")
    print(f"phase 18 on the host clock: the torch stage's two legs {seconds:.1f} s (budget "
          f"{GATE_MC_SECONDS} s) [{smi}]")
    report["quality_gate_mc"] = {"seconds": seconds, **legs}


# phase 19: the row-sharded module path


def module_config(leg):
    """Leg ``leg``'s config as it is (``MODULE_CONFIGS``)."""
    from unet_image_segmentation_tpu_torch.train.state import Config

    with open(os.path.join(ROOT, MODULE_CONFIGS[leg])) as f:
        return Config.from_dict(json.load(f))


def module_batches(leg):
    """The leg's seeded batches (images, masks): ``1 + MODULE_STEPS`` global
    batches of the config's batch size and image size."""
    cfg = module_config(leg)
    n, size = cfg.train.batch_size, cfg.model.image_height
    images, masks = synthetic_scenes(n * (1 + MODULE_STEPS), size, SEED + 19 + ord(leg),
                                     with_masks=True)
    shape = (1 + MODULE_STEPS, n) + images.shape[1:]
    return images.reshape(shape), masks.reshape(shape[:-1] + (1,))


def module_run(torch, dev, leg, mesh, images, masks):
    """``fit``'s model, state and step for leg ``leg`` on ``mesh`` (a
    (1, 1) mesh: unsharded), from the config's seeded weights: step 1 with
    dropout off (its metrics, the gradients the optimizer took and the
    running statistics after it kept), then ``MODULE_STEPS`` steps with the
    config's dropout (losses, and the global batch's images/s on the host
    clock). Step 1's probabilities (the head's sigmoid, gathered) are kept
    too."""
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.loop import _model_config
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    cfg = module_config(leg)
    mcfg = _model_config(cfg, mesh)
    model = build_unet(mcfg, device=dev, generator=torch.Generator().manual_seed(cfg.train.seed))
    model.set_groups(mesh.group, mesh.spatial_group)
    state = create_train_state(cfg, model=model, device=dev)
    step = make_train_step(model, cfg.train.loss, mesh)

    def put(a):
        return mesh.shard(torch.from_numpy(a)).to(dev)

    rate, model.dropout_rate = model.dropout_rate, 0.0
    logits = []
    hook = model.output_mask.register_forward_hook(
        lambda mod, args, y: logits.append(y.detach().float()))
    met = step(state, put(images[0]), put(masks[0]))
    hook.remove()
    torch.cuda.synchronize()
    out = {"metrics": {k: v.detach().double().cpu() for k, v in met.items()},
           "probs": mesh.gather(torch.sigmoid(logits[0])).cpu(),
           "grads": {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()},
           "stats": {n: b.detach().cpu().clone() for n, b in model.named_buffers()},
           "use_pallas": mcfg.use_pallas}
    model.dropout_rate = rate
    t0 = time.perf_counter()
    out["losses"] = [float(step(state, put(x), put(m))["loss"])
                     for x, m in zip(images[1:], masks[1:])]
    torch.cuda.synchronize()
    out["images_per_s"] = MODULE_STEPS * images.shape[1] / (time.perf_counter() - t0)
    return out


def module_stream(torch, dev, ckpt, frames, mesh):
    """The 1024 px module-path ``StreamingPredictor`` (``use_pallas`` off)
    on ``mesh`` (None: unsharded) in each dtype of ``MODULE_STREAM_DTYPES``:
    the probabilities of the frames and the frames/s on the host clock."""
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.streaming import StreamingPredictor

    out = {}
    for dname in MODULE_STREAM_DTYPES:
        pred = Predictor(ckpt, (STREAM_IMAGE, STREAM_IMAGE), compute_dtype=dname,
                         use_pallas=False, device=dev)
        stream = StreamingPredictor(pred, STREAM_FRAME, STREAM_BATCH, threshold=None, mesh=mesh)
        probs = stream(frames)
        t0 = time.perf_counter()
        for _ in range(STREAM_REPS):
            stream(frames)
        out[dname] = (probs, STREAM_REPS * len(frames) / (time.perf_counter() - t0))
        del pred, stream
        torch.cuda.empty_cache()
    return out


def module_rank_main(rank, work):
    """One rank of phase 19 (``chip_smoke.py --module-rank R DIR``): on
    cuda:0 with gloo, over a ``MODULE_MESH`` mesh, each leg's
    :func:`module_run` and the module-path stream; rank 0 writes the
    results."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from unet_image_segmentation_tpu_torch.parallel import distributed
    from unet_image_segmentation_tpu_torch.parallel.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    distributed.initialize("file://" + os.path.join(work, "store"), MODULE_RANKS, rank,
                           backend="gloo")
    mesh = create_mesh(*MODULE_MESH)
    out = {}
    for leg in MODULE_CONFIGS:
        images = np.load(os.path.join(work, f"{leg}_x.npy"))
        masks = np.load(os.path.join(work, f"{leg}_m.npy"))
        t0 = time.perf_counter()
        run = module_run(torch, dev, leg, mesh, images, masks)
        print(f"leg ({leg}): step 1 loss {float(run['metrics']['loss']):.7f}, then losses "
              f"{run['losses']}, use_pallas {run['use_pallas']} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        out.update({f"{leg} metric {k}": v.numpy() for k, v in run["metrics"].items()})
        out[f"{leg} probs"] = run["probs"].numpy()
        out.update({f"{leg} grad {n}": g.numpy() for n, g in run["grads"].items()})
        out.update({f"{leg} stat {n}": b.numpy() for n, b in run["stats"].items()})
        out[f"{leg} losses"] = np.array(run["losses"])
        out[f"{leg} images_per_s"] = np.array(run["images_per_s"])
        del run
        torch.cuda.empty_cache()
    frames = np.load(os.path.join(ROOT, "build", "phase14", "frames.npy"))
    for dname, (probs, fps) in module_stream(torch, dev, os.path.join(ROOT, "build", "phase14",
                                                                       "ckpt"),
                                             frames, mesh).items():
        out[f"stream {dname}"] = probs
        out[f"stream {dname} fps"] = np.array(fps)
    if rank == 0:
        np.savez(os.path.join(work, "out.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)
    return 0


def hold_module_step(torch, label, got, ref):
    """Step 1 of a row-sharded leg against the unsharded one under
    ``MODULE_*``'s bars; returns (ok, the worst numbers)."""
    rec, ok = {}, True
    for key in ("loss", "dice"):
        a, b = float(got["metrics"][key]), float(ref["metrics"][key])
        rec[f"{key}_rel"] = abs(a - b) / abs(b)
        ok = ok and rec[f"{key}_rel"] <= MODULE_LOSS_RTOL
    p, q = ref["probs"].double(), got["probs"].double()
    delta = float((q - p).abs().max())
    ok = ok and delta <= MODULE_PROB_ATOL
    # the pixels the two runs put in different classes (> 0.5; cm_raw casts
    # the probability to int): each lies within delta of the boundary
    near = {"cm_thresh": int(((q > 0.5) != (p > 0.5)).sum()),
            "cm_raw": int(((q >= 1.0) != (p >= 1.0)).sum())}
    near_cap = math.ceil(MODULE_NEAR_FRAC * p.numel())
    rec.update(prob_max_abs_err=delta, near=near, near_cap=near_cap)
    for key in ("cm_raw", "cm_thresh"):
        rec[f"{key}_diff"] = float((got["metrics"][key] - ref["metrics"][key]).abs().max())
        ok = (ok and near[key] <= near_cap
              and rec[f"{key}_diff"] <= MODULE_CM_ATOL + near[key])
    for part, (atol, rtol) in (("grads", MODULE_GRAD_TOL), ("stats", MODULE_STATS_TOL)):
        excess = {n: float(((got[part][n].double() - r.double()).abs()
                            - rtol * r.double().abs()).max()) for n, r in ref[part].items()}
        w = max(excess, key=excess.get)
        rec[f"{part}_worst"] = {"name": w, "excess": excess[w], "atol": atol}
        ok = ok and excess[w] <= atol
    print(f"  {label} step 1 (dropout off): loss {float(got['metrics']['loss']):.7f} vs "
          f"{float(ref['metrics']['loss']):.7f} (rel {rec['loss_rel']:.2e}), dice rel "
          f"{rec['dice_rel']:.2e} (bar {MODULE_LOSS_RTOL:g}); probabilities max_abs_err "
          f"{delta:.3e} (bar {MODULE_PROB_ATOL:g}); confusion matrices max |diff| raw "
          f"{rec['cm_raw_diff']:g} (bar {MODULE_CM_ATOL} + {near['cm_raw']} pixels in another "
          f"class), > 0.5 {rec['cm_thresh_diff']:g} (bar {MODULE_CM_ATOL} + {near['cm_thresh']} "
          f"pixels in another class; at most {near_cap} may be); "
          f"gradients max(|diff| - {MODULE_GRAD_TOL[1]:g}|g|) {rec['grads_worst']['excess']:.2e} "
          f"at {rec['grads_worst']['name']} (bar {MODULE_GRAD_TOL[0]:g}); running statistics "
          f"{rec['stats_worst']['excess']:.2e} at {rec['stats_worst']['name']} (bar "
          f"{MODULE_STATS_TOL[0]:g}) {'ok' if ok else 'FAIL'}")
    return ok, rec


def module_path(torch, dev, smi, report, launches, phase_dir):
    """Phase 19: the row-sharded module path. The unsharded legs (a) and
    (b) and the unsharded module-path stream on the card, the iou step on
    the kernels against the composed path (phase 8's bars), then two ranks
    of this script (``--module-rank``) on the one card, gloo, running the
    legs and the stream over a (1, 2) mesh; each held to its unsharded run.
    A rank that fails or hangs fails the run."""
    import subprocess

    from unet_image_segmentation_tpu_torch.parallel.mesh import create_mesh

    os.makedirs(phase_dir)
    rec = report["module_path"] = {"tf32": False}
    one = create_mesh()   # one process: (1, 1)
    refs = {}
    for leg, path in MODULE_CONFIGS.items():
        images, masks = module_batches(leg)
        np.save(os.path.join(phase_dir, f"{leg}_x.npy"), images)
        np.save(os.path.join(phase_dir, f"{leg}_m.npy"), masks)
        cfg = module_config(leg)
        print(f"row-sharded module path, leg ({leg}): {path} as it is ({cfg.model.conv_type} "
              f"convs, filters {cfg.model.filters}, {cfg.model.compute_dtype}, "
              f"{cfg.train.loss}, batch {cfg.train.batch_size}, dropout "
              f"{cfg.model.dropout_rate}, use_pallas {cfg.model.use_pallas}); TF32 off in both "
              "legs (matmul and cuDNN); unsharded on the card:")
        refs[leg] = module_run(torch, dev, leg, one, images, masks)
        print(f"  unsharded: step 1 loss {float(refs[leg]['metrics']['loss']):.7f}, then losses "
              f"{refs[leg]['losses']}, {refs[leg]['images_per_s']:.1f} images/s on the host "
              f"clock over {MODULE_STEPS} steps (a smoke reading, not a speed) [{smi}]")
        torch.cuda.empty_cache()

    with open(os.path.join(ROOT, IOU_CONFIG)) as f:
        base = json.load(f)
    base["train"]["loss"] = "iou"
    images, masks = synthetic_scenes(base["train"]["batch_size"], IMAGE, SEED + 191,
                                     with_masks=True)
    print(f"iou step: {IOU_CONFIG} with loss 'iou', kernels on vs the composed path, "
          f"{TRAIN_STEPS} steps each, phase 8's bars:")
    rec["iou"] = train_ab(torch, dev, smi, base, torch.from_numpy(images).to(dev),
                          torch.from_numpy(masks).to(dev), launches, STEP_LAUNCHES,
                          profile=False)
    torch.cuda.empty_cache()

    ckpt = os.path.join(ROOT, "build", "phase14", "ckpt")
    frames = np.load(os.path.join(ROOT, "build", "phase14", "frames.npy"))
    stream_ref = module_stream(torch, dev, ckpt, frames, None)
    torch.cuda.empty_cache()

    logs = [open(os.path.join(phase_dir, f"rank{r}.log"), "w+") for r in range(MODULE_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--module-rank",
                               str(r), phase_dir], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    join_ranks(procs, logs, MODULE_RANK_TIMEOUT, "module path")
    out = dict(np.load(os.path.join(phase_dir, "out.npz")))
    failed = []
    for leg, ref in refs.items():
        got = {"metrics": {k: torch.from_numpy(out[f"{leg} metric {k}"]) for k in ref["metrics"]},
               "probs": torch.from_numpy(out[f"{leg} probs"]),
               "grads": {n: torch.from_numpy(out[f"{leg} grad {n}"]) for n in ref["grads"]},
               "stats": {n: torch.from_numpy(out[f"{leg} stat {n}"]) for n in ref["stats"]}}
        label = f"leg ({leg}) {MODULE_CONFIGS[leg]} over mesh {MODULE_MESH}"
        ok, rec[leg] = hold_module_step(torch, label, got, ref)
        losses = out[f"{leg} losses"].tolist()
        finite = bool(np.isfinite(losses).all())
        ips = float(out[f"{leg} images_per_s"])
        print(f"  {label}: {MODULE_STEPS} steps with dropout {module_config(leg).model.dropout_rate}"
              f": losses {losses} (unsharded {ref['losses']}; each shard draws its own masks, "
              f"so no bar but finite: {finite}); {ips:.1f} images/s vs {ref['images_per_s']:.1f} "
              f"unsharded on the host clock over {MODULE_STEPS} steps (a smoke reading, not a "
              f"speed; two ranks sharing one card over gloo: not a multi-card speed) [{smi}]")
        rec[leg].update(losses=losses, losses_unsharded=ref["losses"], images_per_s=ips,
                        images_per_s_unsharded=ref["images_per_s"])
        if not (ok and finite):
            failed.append(label)
    for dname, (want, fps_ref) in stream_ref.items():
        got = out[f"stream {dname}"]
        fps = float(out[f"stream {dname} fps"])
        shape_ok = got.shape == want.shape and np.isfinite(got).all()
        err = float(np.abs(got - want).max()) if shape_ok else float("inf")
        agree = float(((got > 0.5) == (want > 0.5)).mean()) if shape_ok else 0.0
        ok = err <= PROB_TOL[dname] and agree >= MASK_MIN_AGREE[dname]
        print(f"  leg (c) {HIGHRES_CONFIG}'s model, use_pallas off, {dname}: the module-path "
              f"stream of {len(want)} {STREAM_FRAME[0]}x{STREAM_FRAME[1]} frames over mesh "
              f"{MODULE_MESH} vs unsharded: prob max_abs_err {err:.3e} (tol {PROB_TOL[dname]:g}), "
              f"mask agreement {agree:.6f} (min {MASK_MIN_AGREE[dname]}); {fps:.2f} frames/s vs "
              f"{fps_ref:.2f} unsharded on the host clock over {STREAM_REPS} batches (a smoke "
              f"reading, not a speed; two ranks on one card) "
              f"{'ok' if ok else 'FAIL'} [{smi}]")
        rec[f"c {dname}"] = {"max_abs_err": err, "mask_agree": agree, "frames_per_s": fps,
                             "frames_per_s_unsharded": fps_ref}
        if not ok:
            failed.append(f"leg (c) {dname}")
    if failed:
        raise AssertionError(f"the row-sharded module path disagrees with the unsharded: {failed}")


def reset_train_counts():
    from unet_image_segmentation_tpu_torch.ops import fused_head, fused_train, fused_upconcat

    for mod in (fused_train, fused_upconcat, fused_head):
        mod.reset_launch_counts()


def train_counts():
    """The K1-K6 launch counters, merged."""
    from unet_image_segmentation_tpu_torch.ops import fused_head, fused_train, fused_upconcat

    return {**fused_train.LAUNCHES, **fused_upconcat.LAUNCHES, **fused_head.LAUNCHES}


def eval_images_per_second(step, x, m, torch, reps=5):
    """Host-clock rate of eval steps (forward, loss and metrics)."""
    step(None, x, m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(None, x, m)
    torch.cuda.synchronize()
    return reps * x.shape[0] / (time.perf_counter() - t0)


def train_images_per_second(step, state, x, m, torch, reps=3):
    """Host-clock rate of full train steps (forward, backward, AdamW)."""
    step(state, x, m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, x, m)
    torch.cuda.synchronize()
    return reps * x.shape[0] / (time.perf_counter() - t0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from unet_image_segmentation_tpu_torch import serving_quant as sq
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.models.unet import UNet
    from unet_image_segmentation_tpu_torch.ops import fused_head as fh
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.ops import fused_train as ft
    from unet_image_segmentation_tpu_torch.ops import fused_upconcat as fu
    from unet_image_segmentation_tpu_torch.ops.kernels import build
    from unet_image_segmentation_tpu_torch.train.checkpoint import save_inference_variables
    from unet_image_segmentation_tpu_torch.troubleshoot.link_floors import link_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    report = {"stages": {}, "blocks": {}, "predictor": {}}

    # ---- 1. the card -----------------------------------------------------
    smi = roofline.card()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    report["card"] = smi

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: nvcc {' '.join(build.NVCC_FLAGS[:2])} -> {build.library_path().name}, "
          f"nvcc {build.build_seconds} s, load {time.perf_counter() - t0:.2f} s")

    def rnd(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    rnd.gen = gen

    def weights(c, f, dtype):
        blk = {
            "depthwise_kernel": rnd(3, 3, c, 1, scale=(6 / (9 * c + 9)) ** 0.5),
            "pointwise_kernel": rnd(1, 1, c, f, scale=(6 / (c + f)) ** 0.5),
            "scale": 1 + 0.5 * rnd(f), "offset": 0.1 * rnd(f),
            "mean": 0.1 * rnd(f), "var": 0.02 + 0.05 * rnd(f).abs(),
        }
        return fs.prepare_block(blk, dtype, device=dev)

    def rel_err(got, want):
        err = (got.float() - want.float()).abs().max().item()
        return err, err / max(want.float().abs().max().item(), 1e-30)

    worst_abs = {name: 0.0 for name in roofline.KERNELS}

    def judge(name, label, dtype_name, pairs, tols=KERNEL_TOL):
        for got, want in pairs:
            if got.shape != want.shape or not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name} {label} {dtype_name}: bad output {tuple(got.shape)}")
            err, rel = rel_err(got, want)
            worst_abs[name] = max(worst_abs[name], err)
            tol = tols[dtype_name]
            print(f"  {name} {label} {dtype_name}: max_abs_err {err:.3e} rel {rel:.3e} "
                  f"(tol {tol:g}) {'ok' if rel <= tol else 'FAIL'}")
            if not rel <= tol:
                raise AssertionError(f"{name} {label} {dtype_name}: rel err {rel} > {tol}")

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # ---- 3. K8 vs plain -----------------------------------------------------
    print("K8 sepconv_block vs plain, batch 2:")
    for dname, dtype in dtypes.items():
        for c, f, h in block_shapes():
            w = weights(c, f, dtype)
            x = rnd(BATCH_CHECK, h, h, c).to(dev, dtype)
            got = fs.sepconv_block(x, w)
            want = fs.sepconv_block_reference(x, w)
            torch.cuda.synchronize()
            judge("sepconv_block", f"{c}->{f}@{h}", dname, [(got, want)])
    print(f"K8 vs plain at other shapes, batch {' and '.join(map(str, BLOCK_RAGGED_BATCHES))}, "
          "ReLU on and off:")
    stream = gen.get_state()  # these cases leave the later phases' seeded inputs as they were
    for dname, dtype in dtypes.items():
        for batch in BLOCK_RAGGED_BATCHES:
            for name, c, f, h, w in BLOCK_RAGGED:
                wt = weights(c, f, dtype)
                x = rnd(batch, h, w, c).to(dev, dtype)
                plan = ft.fwd_plan(batch, h, w, c, f, dtype, build.sm_count(dev))
                for relu in (True, False):
                    got = fs.sepconv_block(x, wt, relu)
                    want = fs.sepconv_block_reference(x, wt, relu)
                    torch.cuda.synchronize()
                    judge("sepconv_block", f"{name} {c}->{f}@{h}x{w} ReLU "
                          f"{'on' if relu else 'off'} batch {batch}, cluster {plan.n} x {plan.s}, "
                          f"{plan.per} tiles a cluster", dname, [(got, want)])
    gen.set_state(stream)

    # ---- 4. K7 vs plain -----------------------------------------------------
    def pair_case(batch, cx, cx2, f1, f2, h, w, mode, dtype):
        """Seeded inputs of one K7 call and its keyword arguments."""
        w1, w2 = weights(cx + cx2, f1, dtype), weights(f1, f2, dtype)
        x = rnd(batch, h, w, cx).to(dev, dtype)
        x2 = rnd(batch, h, w, cx2).to(dev, dtype) if cx2 else None
        return (x, w1, w2), dict(pool=mode == "pool", x2=x2)

    def judge_pair(label, dname, args, kw):
        got = fs.sepconv_pair(*args, **kw)
        want = fs.sepconv_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        judge("sepconv_pair", label, dname, list(zip(got, want)) if kw["pool"] else [(got, want)])

    print("K7 sepconv_pair vs plain, batch 2:")
    for dname, dtype in dtypes.items():
        for name, cx, cx2, f1, f2, h, mode in STAGES:
            args, kw = pair_case(BATCH_CHECK, cx, cx2, f1, f2, h, h, mode, dtype)
            label = f"{name} ({cx}{'|%d' % cx2 if cx2 else ''})->{f1}->{f2}@{h} {mode}"
            judge_pair(label, dname, args, kw)
    print(f"K7 vs plain at other shapes, batch {' and '.join(map(str, PAIR_RAGGED_BATCHES))}:")
    stream = gen.get_state()  # these cases leave the later phases' seeded inputs as they were
    for dname, dtype in dtypes.items():
        for batch in PAIR_RAGGED_BATCHES:
            for name, cx, cx2, f1, f2, h, w, mode in PAIR_RAGGED:
                args, kw = pair_case(batch, cx, cx2, f1, f2, h, w, mode, dtype)
                plan = fs.pair_plan(h, w, cx + cx2, f1, f2, dtype, batch)
                label = (f"{name} ({cx}{'|%d' % cx2 if cx2 else ''})->{f1}->{f2}@{h}x{w} "
                         f"{mode} batch {batch}, cluster {plan.n} x {plan.s1}/{plan.s2}")
                judge_pair(label, dname, args, kw)
    gen.set_state(stream)

    # ---- 5. main path -------------------------------------------------------
    print(f"main path: U-Net filters {FILTERS} at {IMAGE}x{IMAGE}, seeded weights")
    scenes = synthetic_scenes(64, IMAGE, SEED)
    state = seeded_state(torch, dev, rnd, scenes[:8])
    kwargs = MODEL_KWARGS
    with tempfile.TemporaryDirectory() as tmp:
        save_inference_variables(tmp, state, kwargs)
        on = {d: Predictor(tmp, (IMAGE, IMAGE), compute_dtype=d, use_pallas=True, device=dev)
              for d in dtypes}
        off = {d: Predictor(tmp, (IMAGE, IMAGE), compute_dtype=d, use_pallas=False, device=dev)
               for d in dtypes}
        # phase 13's int8 Predictors, built here for the profile below
        on8 = {d: Predictor(tmp, (IMAGE, IMAGE), compute_dtype=d, use_pallas=True,
                            quantize="int8", device=dev) for d in dtypes}
    modules = {}
    for dname, dtype in dtypes.items():
        m = UNet(filters=FILTERS, dtype=dtype, use_pallas=True)
        m.load_state_dict(state)
        modules[dname] = m.to(dev)

    # the run whose launches are counted: requests through the kernels
    fs.reset_launch_counts()
    outputs = {}
    for dname in dtypes:
        for n in REQUESTS:
            outputs[(dname, n)] = on[dname].predict(scenes[:n])
        with torch.no_grad():
            outputs[(dname, "module")] = modules[dname](
                torch.from_numpy(scenes[:BATCH_CHECK]).to(dev)).cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    forwards = len(REQUESTS) * len(dtypes)
    print(f"launches: {launches} over {forwards} Predictor forwards and "
          f"{len(dtypes)} module forwards")
    want_pair = PAIR_LAUNCHES_PER_FORWARD * forwards
    want_block = BLOCK_LAUNCHES_PER_FORWARD * len(dtypes)
    if launches["sepconv_pair"] != want_pair or launches["sepconv_block"] != want_block:
        raise AssertionError(
            f"expected {want_pair} K7 and {want_block} K8 launches, got {launches}")
    print(f"  K7 launches per Predictor forward: {launches['sepconv_pair'] // forwards}")


    for dname in dtypes:
        cases = [(n, on[dname], n) for n in REQUESTS] + [("module", None, BATCH_CHECK)]
        for key, _, n in cases:
            got = outputs[(dname, key)]
            want = off[dname].predict(scenes[:n])
            if got.shape != (n, IMAGE, IMAGE, 1) or not np.isfinite(got).all():
                raise AssertionError(f"bad output {got.shape} for {dname} {key}")
            err = float(np.abs(got - want).max())
            agree = float(((got > 0.5) == (want > 0.5)).mean())
            fg = float((want > 0.5).mean())
            ok = err <= PROB_TOL[dname] and agree >= MASK_MIN_AGREE[dname]
            label = f"batch {key}" if key != "module" else f"module path batch {n}"
            print(f"  {dname} {label}: prob max_abs_err {err:.3e} (tol {PROB_TOL[dname]:g}), "
                  f"mask agreement {agree:.6f} (min {MASK_MIN_AGREE[dname]}), "
                  f"foreground {fg:.3f} {'ok' if ok else 'FAIL'}")
            report["predictor"][f"{dname} {label}"] = {"max_abs_err": err, "mask_agree": agree}
            if not ok:
                raise AssertionError(f"{dname} {label}: kernels disagree with the plain path")

    batch = scenes[:BATCH_SERVE]
    for dname in dtypes:
        rates = {}
        for label, pred in (("on", on[dname]), ("off", off[dname]),
                            ("on", on[dname]), ("off", off[dname])):
            rates.setdefault(label, []).append(images_per_second(pred, batch, torch))
        msg = ", ".join(f"kernels {k} {' / '.join(f'{r:.1f}' for r in v)}"
                        for k, v in rates.items())
        print(f"  Predictor {dname} batch {BATCH_SERVE} images/s: {msg} [{smi}]")
        report["predictor"][f"{dname} images_per_s"] = rates
    report["predictor"]["profile"] = traced(
        lambda _: profile_predict(torch, dev, on["bfloat16"], batch, smi), "Predictor profile")
    # the int8 Predictor's profile, early in the process, where traces lose
    # least (its warm-up predict calibrates it on this batch, phase 13's
    # first request)
    report["int8_profile"] = traced(
        lambda _: profile_predict(torch, dev, on8["bfloat16"], batch, smi, "bf16 int8"),
        "int8 Predictor profile")

    # ---- 6. kernel timings --------------------------------------------------
    # K7's and K8's launch plans depend on the batch (the grid), so each
    # output at the path's batch is held against its plain version before it
    # is timed
    print(f"kernel timings, batch {BATCH_SERVE}, ms (kernel / plain, its bound and executed / "
          f"useful multiply-adds) [{smi}]:")
    totals = {}
    for dname, dtype in dtypes.items():
        tot = {"sepconv_pair": [0.0, 0.0], "sepconv_block": [0.0, 0.0]}
        for stage in STAGES:
            name, cx, cx2, f1, f2, h, mode = stage
            args, kw = pair_case(BATCH_SERVE, cx, cx2, f1, f2, h, h, mode, dtype)
            judge_pair(f"{name} batch {BATCH_SERVE}", dname, args, kw)
            t_k = time_ms(lambda: fs.sepconv_pair(*args, **kw), torch)
            t_p = time_ms(lambda: fs.sepconv_pair_reference(*args, **kw), torch)
            bound, by = roofline.bounds_ms("sepconv_pair", stage, dname, BATCH_SERVE)
            executed, useful = fs.pair_work(h, h, cx + cx2, f1, f2, dtype)
            tot["sepconv_pair"][0] += t_k
            tot["sepconv_pair"][1] += t_p
            print(f"  K7 {name} {dtype_label(dname)}: {t_k:.3f} / {t_p:.3f}, bound {bound:.4f} "
                  f"({by}), executed / useful {executed / useful:.3f}")
            report["stages"][f"{name} {dname}"] = {
                "ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                "executed_over_useful": executed / useful}
            del args, kw
            for c, f in ((cx + cx2, f1), (f1, f2)):
                w = weights(c, f, dtype)
                xb = rnd(BATCH_SERVE, h, h, c).to(dev, dtype)
                got = fs.sepconv_block(xb, w)
                want = fs.sepconv_block_reference(xb, w)
                torch.cuda.synchronize()
                judge("sepconv_block", f"{c}->{f}@{h} batch {BATCH_SERVE}", dname, [(got, want)])
                del got, want
                t_k = time_ms(lambda: fs.sepconv_block(xb, w), torch)
                t_p = time_ms(lambda: fs.sepconv_block_reference(xb, w), torch)
                bound, by = roofline.bounds_ms("sepconv_block", (c, f, h), dname, BATCH_SERVE)
                work = ft.fwd_work(BATCH_SERVE, h, h, c, f, dtype)
                tot["sepconv_block"][0] += t_k
                tot["sepconv_block"][1] += t_p
                print(f"  K8 {c}->{f}@{h} {dtype_label(dname)}: {t_k:.3f} / {t_p:.3f}, bound "
                      f"{bound:.4f} ({by}), executed / useful {work.executed / work.useful:.3f}")
                report["blocks"][f"{c}->{f}@{h} {dname}"] = {
                    "ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                    "executed_over_useful": work.executed / work.useful}
        totals[dname] = tot
        print(f"  {dname} totals over the path: K7 {tot['sepconv_pair'][0]:.3f} / "
              f"{tot['sepconv_pair'][1]:.3f}, K8 {tot['sepconv_block'][0]:.3f} / "
              f"{tot['sepconv_block'][1]:.3f}")

    def tjudge(name, label, dname, pairs, sums=False):
        judge(name, label, dname, pairs, TRAIN_SUM_TOL if sums else TRAIN_TOL)

    # ---- 7. K1-K6, K9-K11 vs plain ---------------------------------------
    check_train_kernels(torch, ft, fu, fh, fs, rnd, dev, dtypes, tjudge)
    report["k11_alone"] = k11_alone_launches(torch, dev, rnd)

    # ---- 8. the training path at full width ----------------------------------
    fit_out = train_path(torch, dev, smi, report, launches)

    # ---- 9. K1-K6 at batch 32: against plain, then timed ---------------------
    # Each kernel's launch plan depends on the batch (blocks per sample,
    # split-K counts, pixel ranges), so the outputs at the path's batch are
    # held against the plain versions too, then both are timed.
    print(f"K1-K6, K9, K10 at batch {BATCH_SERVE} and K11 at batch {MC_BATCH} of {MC_IMAGE} px "
          f"vs plain, TF32 off, then ms (kernel / plain) [{smi}]:")
    report["train_kernels"] = {}

    def timed(fns):
        return {kname: (time_ms(fk, torch, TRAIN_REPS), time_ms(fp, torch, TRAIN_REPS))
                for kname, (fk, fp) in fns.items()}

    for dname, dtype in dtypes.items():
        tot = {name: [0.0, 0.0] for name in ("chain_fwd", "chain_bwd", "tail_pool",
                                              "tail_pool_bwd", "upconcat", "upconcat_bwd",
                                              "head_fwd", "head_bwd", "sepconv_stats",
                                              "sepconv_bwd", "head_fwd_mc", "head_bwd_mc")}
        cases = []
        for name, c, f, h, in_aff, drop, mc in LINKS:
            k = link_inputs(rnd, dev, dtype, BATCH_SERVE, c, f, h, in_aff, drop)
            label = link_label(name, c, f, h, in_aff, drop, mc)
            judge_link(ft, tjudge, k, label, dname, in_aff, mc)
            fwd = (k["x"], k["dw"], k["pw"], k["aff2"], k["drop"])
            bwd = (k["x"], k["g"], k["y"], k["aff4"], k["comb"], k["dw"], k["pw"], mc, k["drop"])
            cases.append((label, "K1", "K2", None, timed({
                "chain_fwd": (lambda: ft.chain_fwd(*fwd), lambda: ft.chain_fwd_reference(*fwd)),
                "chain_bwd": (lambda: ft.chain_bwd(*bwd), lambda: ft.chain_bwd_reference(*bwd)),
            })))
            del k, fwd, bwd
        for name, f, h in POOLS:
            k = pool_case(torch, rnd, dev, dtype, BATCH_SERVE, f, h)
            label = f"{name} boundary F={f}@{h}"
            judge_pool(torch, ft, tjudge, k, label, dname)
            a, b = k["aff4"][0], k["aff4"][1]
            bwd = (k["y"], k["gs"], k["gp"], k["aff4"])
            cases.append((label, "K3", "K4", (name, f, h), timed({
                "tail_pool": (lambda: ft.tail_pool(k["y"], a, b),
                              lambda: ft.tail_pool_reference(k["y"], a, b)),
                "tail_pool_bwd": (lambda: ft.tail_pool_bwd(*bwd),
                                  lambda: ft.tail_pool_bwd_reference(*bwd)),
            })))
            del k, bwd
        k6_digits = {}
        for name, c, f, h in FEEDS:
            k = upconcat_case(torch, rnd, dev, dtype, BATCH_SERVE, c, f, h)
            label = f"{name} feed {c}@{h}->{2 * f}@{2 * h}"
            judge_feed(fu, tjudge, k, label, dname)
            if dtype == torch.float32:
                k6_digits[name] = k6_d_kernel_digits(fu, k)
            fwd, bwd = (k["x"], k["kernel"], k["bias"], k["skip"]), (k["x"], k["kernel"], k["g"])
            cases.append((label, "K6", "K6 bwd", (name, c, f, h), timed({
                "upconcat": (lambda: fu.upconcat(*fwd), lambda: fu.upconcat_reference(*fwd)),
                "upconcat_bwd": (lambda: fu.upconcat_bwd(*bwd),
                                 lambda: fu.upconcat_bwd_reference(*bwd)),
            })))
            del k, fwd, bwd
        k = head_case(torch, rnd, dev, dtype, BATCH_SERVE)
        label = f"dec1 head F={FILTERS[0]}@{IMAGE}"
        judge_head(torch, fh, tjudge, k, label, dname)
        fwd = (k["y"], k["t"], k["aff2"], k["w"], k["hb"])
        bwd = (k["y"], k["t"], k["aff4"], k["w"], k["hb"], k["gsc"])
        cases.append((label, "K5", "K5 bwd", (FILTERS[0], IMAGE), timed({
            "head_fwd": (lambda: fh.head_fwd_sums(*fwd), lambda: fh.head_fwd_sums_reference(*fwd)),
            "head_bwd": (lambda: fh.head_bwd(*bwd), lambda: fh.head_bwd_reference(*bwd)),
        })))
        del k, fwd, bwd
        for name, c, f, h, *_ in LINKS:
            k = block_case(torch, rnd, dev, dtype, BATCH_SERVE, c, f, h)
            label = f"block {name} {c}->{f}@{h}"
            judge_block(fs, tjudge, k, label, dname)
            fwd, bwd = (k["x"], k["dw"], k["pw"]), (k["x"], k["g"], k["dw"], k["pw"])
            cases.append((label, "K9", "K10", (name, c, f, h), timed({
                "sepconv_stats": (lambda: fs.sepconv_stats(*fwd),
                                  lambda: fs.sepconv_stats_reference(*fwd)),
                "sepconv_bwd": (lambda: fs.sepconv_bwd(*bwd),
                                lambda: fs.sepconv_bwd_reference(*bwd)),
            })))
            del k, fwd, bwd
        k = head_mc_case(torch, rnd, dev, dtype, MC_BATCH, MC_IMAGE, FILTERS[0], 3)
        label = f"dec1 softmax head 3 classes F={FILTERS[0]}@{MC_IMAGE} batch {MC_BATCH}"
        judge_head_mc(torch, fh, tjudge, k, label, dname)
        fwd = (k["y"], k["t"], k["aff2"], k["w"], k["hb"])
        bwd = (k["y"], k["t"], k["aff4"], k["w"], k["hb"], k["gsc"])
        cases.append((label, "K11", "K11 bwd", None, timed({
            "head_fwd_mc": (lambda: fh.head_fwd_sums_mc(*fwd),
                            lambda: fh.head_fwd_sums_mc_reference(*fwd)),
            "head_bwd_mc": (lambda: fh.head_bwd_mc(*bwd), lambda: fh.head_bwd_mc_reference(*bwd)),
        })))
        del k, fwd, bwd
        bound_tot = {name: 0.0 for name in ("tail_pool", "tail_pool_bwd", "upconcat",
                                             "upconcat_bwd", "head_fwd", "head_bwd",
                                             "sepconv_stats")}
        for label, k1, k2, shape, times in cases:
            text = []
            for (kname, (t_k, t_p)), klabel in zip(times.items(), (k1, k2)):
                tot[kname][0] += t_k
                tot[kname][1] += t_p
                text.append(f"{klabel} {t_k:.3f} / {t_p:.3f}")
                if shape is not None and kname in bound_tot:   # K3-K6, K9: the bound beside
                    bound, by = roofline.bounds_ms(kname, shape, dname, BATCH_SERVE)
                    bound_tot[kname] += bound
                    text[-1] += f", bound {bound:.4f} ({by}, {100 * bound / t_k:.1f}%)"
            print(f"  {label} {dtype_label(dname)}: " + ", ".join(text))
            report["train_kernels"][f"{label} {dname}"] = times
        if k6_digits:
            report["k6_d_kernel_digits"] = k6_digits
            print(f"  K6 fp32 d_kernel at batch {BATCH_SERVE}, max err / max|fp64| (an fp64 "
                  "product on the card), kernel (plain): " + ", ".join(
                      f"{name} {e['kernel']:.2e} ({e['plain']:.2e})"
                      for name, e in k6_digits.items()) + f" [{smi}]")
        totals[dname].update(tot)
        print(f"  {dname} totals over the path: " + ", ".join(
            f"{kname} {t[0]:.3f} / {t[1]:.3f}" + (
                f" (bound {bound_tot[kname]:.4f}, {100 * bound_tot[kname] / t[0]:.1f}%)"
                if kname in bound_tot else "") for kname, t in tot.items()))

    # ---- 10. multiclass training through K11 ---------------------------------
    multiclass_path(torch, dev, smi, report, launches)

    # ---- 11. per-block training through K9/K10, BatchNorm-free U-Net ---------
    block_train_path(torch, dev, smi, report, launches, dtypes)

    # ---- 12. the troubleshoot tools: K12, K2 link by link, the step's attribution
    library_ms = troubleshoot_path(torch, dev, smi, report, launches, worst_abs, totals)

    # ---- 13. int8 serving: K7's int8 I/O mode, the int8 Predictor, evaluate
    int8_path(torch, dev, smi, report, launches, worst_abs, totals, rnd, weights, dtypes,
              scenes, on, on8)
    del on, off, on8, modules

    # ---- 14. the 1024 px stream from 1080p frames, K7's edge-flag and
    # float-in/int8-out modes, row-sharded serving on two ranks
    phase_dir = os.path.join(ROOT, "build", "phase14")
    shutil.rmtree(phase_dir, ignore_errors=True)
    os.makedirs(phase_dir)
    report["stream"], report["shard_stages"] = {}, {}
    ckpt, on1024, frames_dev = stream_path(torch, dev, smi, report, rnd, dtypes, phase_dir)
    edge_checks(torch, fs, sq, rnd, weights, dev, dtypes, pair_case, worst_abs)
    stitch_checks(torch, fs, dtypes, pair_case, worst_abs, report)
    quant_out_checks(torch, fs, sq, dtypes, pair_case, worst_abs)
    time_shard_kernels(torch, fs, dtypes, pair_case, totals, report, smi)
    dry_run(torch, dev, smi, report, launches, on1024, frames_dev, phase_dir)
    del on1024, frames_dev
    torch.cuda.empty_cache()

    # ---- 15. row-sharded and data-parallel training, K1's halo mode -------
    phase_dir = os.path.join(ROOT, "build", "phase15")
    shutil.rmtree(phase_dir, ignore_errors=True)
    os.makedirs(phase_dir)
    drnd = device_rnd(torch, dev, SEED + 15)
    t0 = time.perf_counter()
    halo_checks(torch, ft, drnd, dev, dtypes, tjudge)
    halo_stitch_checks(torch, ft, drnd, dev, dtypes, tjudge)
    time_halo_links(torch, ft, drnd, dev, dtypes, tjudge, totals, report, smi)
    t1 = time.perf_counter()
    highres_train(torch, dev, smi, report, launches, drnd, dtypes, tjudge, phase_dir)
    t2 = time.perf_counter()
    train_dry_run(torch, dev, smi, report, launches, phase_dir)
    print(f"phase 15 on the host clock: (a) K1 halo mode {t1 - t0:.1f} s, (b) 1024 px training "
          f"{t2 - t1:.1f} s, (c) sharded training {time.perf_counter() - t2:.1f} s")

    # ---- 16. export: torch.export artifacts with K8 as a registered op ----
    export_path(torch, dev, smi, report, state, scenes, fit_out)

    # ---- 17. the binary quality gate's torch stage on packed scenes -------
    quality_gate_path(torch, dev, smi, report)

    # ---- 18. the 3-class quality gate's torch stage on class-id packs -----
    quality_gate_mc_path(torch, dev, smi, report)

    # ---- 19. the row-sharded module path, the iou step on the kernels -----
    phase_dir = os.path.join(ROOT, "build", "phase19")
    shutil.rmtree(phase_dir, ignore_errors=True)
    t0 = time.perf_counter()
    module_path(torch, dev, smi, report, launches, phase_dir)
    report["module_path"]["seconds"] = time.perf_counter() - t0
    print(f"phase 19 on the host clock: {report['module_path']['seconds']:.1f} s")

    kernels, report["bounds"] = [], {}
    shapes = kernel_shapes()
    for name, (label, src, replaces) in roofline.KERNELS.items():
        batch, calls = shapes[name]
        bound = {}
        for dname in dtypes:
            if name not in totals[dname]:
                continue
            bound[dname] = roofline.sum_bounds(name, calls, dname, batch)
            report["bounds"][f"{name} {dname}"] = {
                "ms": totals[dname][name][0], "plain_ms": totals[dname][name][1],
                "bound_ms": bound[dname][0], "bound_by": bound[dname][1]}
        line_dtype = "bfloat16" if "bfloat16" in bound else "float32"   # K12a: fp32 only
        t_k, t_p = totals[line_dtype][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"unet_image_segmentation_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": f"unet_image_segmentation_tpu/{replaces}",
            "launches": launches[name],
            "max_abs_err": worst_abs[name],
            "ms": t_k,
            "plain_ms": t_p,
            "bound_ms": bound[line_dtype][0],
            "bound_by": bound[line_dtype][1],
            # K12a's function is one PyTorch call (x + 1); no single call
            # computes any other kernel's whole function (each fuses a conv or
            # GEMM with BatchNorm, ReLU, a pool, a concat or reductions; K12b
            # is a loop of 2K calls)
            "library_ms": library_ms.get(name),
        })
        print(f"  {label} {name}: " + "; ".join(
            f"{dtype_label(d)} measured {totals[d][name][0]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})"
            for d, b in bound.items()))
    report["kernels"] = kernels
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1)
    print("ms / plain_ms / bound_ms: bf16, batch 32 (K11: batch 8 of 512 px), summed over the "
          "path's shapes (9 pair and 18 block shapes; 18 chain links; 4 encoder boundaries; 4 "
          "decoder feeds; the head; 18 per-block sepconvs); K12a: fp32 (8, 128), ms a launch; "
          f"K12b: bf16 {FMA_PROBE_SHAPE} at K = {FMA_PROBE_K}; launches: K7/K8 over phase 5's "
          "forwards (K8 also phase 8's eval steps), K7 int8 over phase 13's int8 Predictor "
          f"forwards, K1-K6 over the {TRAIN_STEPS} kernels-on steps of phases 8, 10 and 19 (and the "
          "A/B step) in each dtype, K11 over phase 10's, K9/K10 over phase 11's 18 blocks in each "
          "dtype, K12 over phase 12's link_floors run; K7 edge flags (bf16, the first shard's "
          f"flags) over the nine slabs of {STREAM_IMAGE} px over {DRY_RANKS} row shards and K7 "
          "float-in/int8-out over their four decoder slabs, at batch "
          f"{DRY_BATCH}, launches summed over phase 14's {DRY_RANKS} ranks; K1 halo mode over "
          f"the {len(SHARD_LINKS)} links of a rank of {TRAIN_RANKS} row shards of {STREAM_IMAGE} "
          f"px at batch {SHARD_TRAIN_BATCH}, launches over phase 15's row-sharded steps summed "
          f"over its {TRAIN_RANKS} ranks")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def dtype_label(dname):
    return "bf16" if dname == "bfloat16" else "fp32"


def time_ms(fn, torch, reps=10):
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def images_per_second(predictor, batch, torch, reps=5):
    """Host-clock rate of ``Predictor.predict`` (host copies included)."""
    predictor.predict(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor.predict(batch)
    torch.cuda.synchronize()
    return reps * len(batch) / (time.perf_counter() - t0)


def profile_predict(torch, dev, predictor, batch, smi, label="bf16"):
    """Phase 5: one ``predict`` of ``batch`` under ``torch.profiler``
    (``utils/profiling.trace``, read by ``troubleshoot/profile_summary``):
    the device's busy time and idle share over the call, K7's share of the
    busy time, and the host copies."""
    from torch.profiler import record_function

    from unet_image_segmentation_tpu_torch.troubleshoot import profile_summary
    from unet_image_segmentation_tpu_torch.utils import profiling

    predictor.predict(batch)
    with tempfile.TemporaryDirectory() as tdir:
        with profiling.trace(tdir, dev):
            with record_function("predict"):
                predictor.predict(batch)
        s = profile_summary.summarize(tdir, within="predict")
    profile_summary.check_complete(s, "Predictor profile")
    k7 = sum(ms for name, ms in s["kernels"].items()
             if roofline.entry_of(name) == "sepconv_pair_cluster_kernel")
    k7_n = sum(n for name, n in s["launches"].items()
               if roofline.entry_of(name) == "sepconv_pair_cluster_kernel")
    if k7_n != PAIR_LAUNCHES_PER_FORWARD:
        raise AssertionError(f"Predictor profile: {k7_n} K7 launches, expected "
                             f"{PAIR_LAUNCHES_PER_FORWARD}")
    out = {"window_ms": s["window_ms"], "busy_ms": s["busy_ms"], "idle_share": s["idle_share"],
           "k7_ms": k7, "k7_share_of_busy": k7 / s["busy_ms"],
           "copies": {name: {"ms": ms, "n": s["launches"][name]}
                      for name, ms in s["copies"].items()},
           "other_kernels": {name: ms for name, ms in sorted(
               s["kernels"].items(), key=lambda kv: -kv[1])
               if roofline.entry_of(name) is None}}
    print(f"  {label} predict of {len(batch)} under torch.profiler: {s['window_ms']:.2f} ms, device "
          f"busy {s['busy_ms']:.2f} ms (idle share {s['idle_share']:.3f}); K7 {k7:.2f} ms in "
          f"{k7_n} launches ({100 * k7 / s['busy_ms']:.1f}% of busy); host copies " + ", ".join(
              f"{name} {v['ms']:.3f} ms x{v['n']}" for name, v in out["copies"].items()) +
          f"; other kernels {sum(out['other_kernels'].values()):.3f} ms [{smi}]")
    return out


def seeded_state(torch, dev, rnd, scenes, image=IMAGE):
    """The state dict of the U-Net of ``FILTERS`` with seeded weights, its
    BatchNorm recalibrated on ``scenes`` and then moved off the batch
    statistics (the running mean by up to 5% of a deviation, the variance
    by up to 20%), as a trained model's are."""
    from unet_image_segmentation_tpu_torch.models.layers import BatchNorm
    from unet_image_segmentation_tpu_torch.models.unet import UNet, recalibrate_batch_norm

    model = UNet(filters=FILTERS, generator=rnd.gen, device=dev)
    recalibrate_batch_norm(model, torch.from_numpy(scenes).to(dev))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mean.add_(0.05 * rnd(*m.mean.shape).to(dev) * m.var.sqrt())
                m.var.mul_(1 + 0.2 * rnd(*m.var.shape).to(dev))
    return model.state_dict()


def multiclass_scenes(n, size, seed):
    """Scenes for the 3-class model: synthetic_scenes' document quad as
    class 1 and a dark disc, a "seal", as class 2 drawn over it; float32
    images (n, size, size, 3) and class ids (n, size, size, 1)."""
    images, ids = synthetic_scenes(n, size, seed, with_masks=True)
    rng = np.random.RandomState(seed + 1)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(n):
        cy, cx = rng.uniform(0.3, 0.7, 2) * size
        r = rng.uniform(0.05, 0.1) * size
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        images[i][disc] = rng.uniform(0.05, 0.35, 3)
        ids[i, disc, 0] = 2.0
    return images, ids


def synthetic_scenes(n, size, seed, with_masks=False, width=None):
    """Document-like scenes in numpy: a bright quadrilateral on a textured
    background, float32 in [0, 1], (n, size, width or size, 3); with
    ``with_masks`` also the quadrilateral's 0/1 mask (n, size, width, 1)."""
    rng = np.random.RandomState(seed)
    h, w = size, width or size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    masks = np.empty((n, h, w, 1), np.float32)
    for i in range(n):
        bg = rng.uniform(0.0, 0.4, 3) + 0.1 * rng.standard_normal((h, w, 1))
        cy, cx = rng.uniform(0.3, 0.7, 2) * (h, w)
        hh, hw = rng.uniform(0.15, 0.35, 2) * (h, w)
        ang = rng.uniform(-0.6, 0.6)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        inside = (np.abs(u) < hw) & (np.abs(v) < hh)
        img = np.broadcast_to(bg, (h, w, 3)).copy()
        img[inside] = rng.uniform(0.6, 1.0, 3)
        out[i] = np.clip(img, 0.0, 1.0)
        masks[i, ..., 0] = inside
    return (out, masks) if with_masks else out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:   # one rank of phase 14's dry run
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--profile-stream"]:   # phase 14's stream profile
        sys.exit(profile_main(sys.argv[2]))
    if sys.argv[1:2] == ["--train-rank"]:   # one rank of phase 15's dry run
        sys.exit(train_rank_main(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--profile-train"]:   # phase 15's profiled step
        sys.exit(profile_train_main(sys.argv[2]))
    if sys.argv[1:2] == ["--module-rank"]:   # one rank of phase 19
        sys.exit(module_rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
