"""Smoke run of the PyTorch/CUDA port (sparkdl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (built
for an H100: the kernels are compiled for sm_90a).  It builds the port's
four CUDA kernels from ``sparkdl_tpu_torch/ops/csrc`` with nvcc (one nvcc
per kernel, all started together): the three that replace the JAX
package's Pallas kernels (B1, B3, B2) and the head fan-out's head pass
(H1, no TPU kernel's port).  It holds each kernel against its plain
PyTorch version at every shape class its path gives it (H1 bit for bit,
``[kernel] H1``), then drives the port's paths through the user entry
points, with seeded random weights and batch 32:

  * Xception at 299x299 (``DeepImageFeaturizer`` + ``DeepImagePredictor``):
    the whole-image sepconv kernel (B1), 30 launches per batch;
  * MobileNetV2 at 224x224 with ``SPARKDL_MNV2_FUSED=1`` (featurizer +
    predictor): the mbconv kernel (B2), 13 launches per batch;
  * Xception with ``SPARKDL_XC_TILED=1`` (one featurizer batch): the tiled
    sepconv kernel (B3), 4 launches per batch, beside B1's 30;
  * InceptionV3 at 299x299, the featurizer of the reference's
    transfer-learning recipe (featurizer + predictor, f32 with TF32 off):
    none of the three kernels (its convolutions are cuDNN's, as they are
    XLA's in JAX).  Its fused branch heads are held against the per-branch
    route and ``SPARKDL_S2D_STEM=1`` against the default (both within
    1e-3), cuDNN TF32 and the bf16 engine against f32 (within 5e-2); then
    ``Pipeline([DeepImageFeaturizer, LogisticRegression])`` is fitted on
    128 class-tinted images of five colours and scored on 32 held out
    (accuracy at least 0.9), and the card's LR fit is held against the
    CPU's on the same features (within 1e-2);
  * [zoo2], BASELINE config 2's zoo past Xception at 224x224 on seeded
    weights (none of the three kernels): ResNet50 and VGG16 featurize
    (2048-d, 4096-d) and predict with top-5 decode, EfficientNetB0
    featurize; the card's f32 outputs (TF32 off) held to the CPU's
    (features within 2e-5, probabilities within 1e-4, top-5 classes
    equal), cuDNN TF32 and the bf16 engine against f32 (within 5e-2; TF32
    also above 2e-5, so that the f32 limit would catch a path in TF32),
    ResNet50 with ``SPARKDL_RN_FUSED_SHORTCUT=1`` against the plain route
    (within 2e-5, one new capture); then ResNet50 with weights imported
    from seeded Keras-layout arrays through ``import_keras_weights``, card
    against CPU (within 2e-5);
  * [keras] (run last, after [pipeline]), BASELINE configs 3 and 4 with
    a user's Keras InceptionV3 at 299x299, converted without Keras from
    the committed model config
    (``sparkdl_tpu_torch/graph/data/keras_inception_v3.json``) and seeded
    Keras-layout arrays (none of the three kernels): the converted model
    against the zoo InceptionV3 imported from the same arrays
    (probabilities within 1e-4, top-5 equal), card vs CPU (1e-4), TF32 and
    bf16 against f32 (5e-2), graphed == eager and one capture per weight
    edit; ``KerasImageFileTransformer`` over 69 JPEGs and a garbage file
    (a null row; equal to the converted engine on the loaded arrays;
    pipelined == serial), ``registerKerasImageUDF`` through the UDF
    registry over ``readImages`` resized by ``createResizeImageUDF``
    (within 1e-6 of the converted model, null row kept),
    ``KerasTransformer`` and ``TFTransformer`` card vs CPU (1e-5), and a
    save/load round trip of a stage holding the converted model (bit for
    bit);
  * [tuning] (last), BASELINE config 5 with the same converted
    InceptionV3 at 299x299 (none of the three kernels):
    ``KerasImageFileEstimator`` over 48 tinted JPEGs (batch 16) tuned by
    ``CrossValidator`` (3 folds) over optimizer {adam, sgd} x epochs
    {1, 2}: 13 fits with finite losses, 4 metrics, the best model's
    output, the graph pools held after the run no more than after the
    first fold model's transform plus one model's pool; one SGD fit card
    vs CPU (step losses 1e-6, the update 2e-4, both under TF32's
    readings, which the phase checks), a small Keras CNN's whole tuning
    run card vs CPU (equal metrics and best map, losses and outputs
    1e-6), ResNet50 with ``trainBatchStats`` card vs CPU (its statistics'
    move after one step 1e-5; the parameters after one step and the
    statistics after two no further from a float64 CPU fit than 4x the
    CPU's float32 fit), a
    checkpointed fit resumed against the uninterrupted one,
    and the CV model's save and load (bit for bit);
  * [native] (after [tuning]), the host decode core
    (``sparkdl_tpu_torch/native``): whether it built with g++ against
    libjpeg and libpng and why not; where it built, native vs PIL over 64
    JPEGs and a garbage file at 224 and 299 (mean abs diff under 8, equal
    ok masks) and ms a batch of both; where not, PIL's ms a batch;
  * [tfgraph] (last), ``TFInputGraph`` without TensorFlow: the committed
    frozen InceptionV3 skeleton (2,217 nodes) filled from
    ``seeded_keras_arrays`` (``tools/gen_tf_graphs.py``) at 299x299, batch
    32, f32 with TF32 off, through ``TFInputGraph.fromGraphDef`` (pooled
    features and probabilities) after a uint8 -> float preprocess, as one
    CUDA graph: within 1e-6 of TensorFlow's stored outputs and of the port
    on the CPU, TF32's reading above both, graphed == eager bit for bit,
    forward ms graphed and eager, kernel nodes per replay, the pool, the
    parse / fill / import seconds; ``TFImageTransformer`` over 64 image
    structs equal to the engine, saved and loaded bit for bit; the six
    constructors over the TF-written MLP and CNN through ``TFTransformer``
    on the card within rtol 1e-5 / atol 1e-6 of TensorFlow's outputs;
  * [serving] (last), online serving through ``sparkdl_tpu_torch.serving``
    with B1 in every dispatch: ``Server("Xception", featurize=True,
    max_batch_size=32)`` at 299x299, f32 with TF32 off.  With one bucket
    (32) and no ragged cuts, 96 seeded images in a shuffled order from 8
    client threads equal the zoo engine's rows and
    ``DeepImageFeaturizer.transform``'s, bit for bit, at 30 B1 launches a
    dispatch; with buckets 8/16/32 and ragged cuts, two buckets captured
    by two workers in flight and seeded bursts of 1-32 requests agree with
    the one-bucket rows within 5e-2 (the largest difference printed), and
    8 images through a CPU ``Server`` (unfused f32) within 5e-2; closed
    loops of 1, 8 and 32 clients, ragged on and off, each of at least
    1,000 requests, print requests/s, latency and queue p50/p99, fill, pad
    rows and host us per dispatch;
    the failure domain (an injected transient absorbed by one retry with
    health back to ready, a queue-full rejection with ``retry_after_s``,
    an expired deadline shed before dispatch, a drain then
    ``ServerClosedError``); MobileNetV2 at 224x224 with
    ``SPARKDL_MNV2_FUSED=1`` (13 B2 a dispatch, served == engine bit for
    bit); ``register_serving_udf`` over 64 image structs through
    ``from_transformer(DeepImageFeaturizer)`` equal to the transform's
    column bit for bit.  Every server's graph pool is printed and must be
    0 after its ``close()``.  Each served run is counted on its own (the
    counts set to 0 just before it), held to its kernels' launches per
    forward times its dispatches and captures, and summed into the
    phase's launches;
  * [headfanout] (last, after [serving]), the head fan-out:
    ``HeadFanoutServer("Xception", max_batch_size=32,
    cache=InferenceCache())`` at 299x299, f32 with TF32 off, 64 tenants'
    seeded (2048, 100) heads in one stacked bank served by H1, 96 seeded
    images.  A seeded Zipf(1.1) replay of 1,000 (image, tenant) requests
    from one client through an uncached baseline (300 requests), a cold
    pass (backbone dispatches == distinct images) and a warm pass (none),
    then the warm replay from 8 clients (p50 / p99, req/s, feature hits,
    host us per head pass); every row equal to its per-tenant oracle (its
    feature row through H1 alone) bit for bit; three mixed-tenant
    ``predict_batch`` calls of 32, each one head pass and one H1 launch;
    the 96 served feature rows equal to the zoo engine's bit for bit; a
    hot swap under 8 hammering threads (no failed future, rows old or new,
    ``no_backbone_recompile``, no new capture, the cache's entries
    unchanged); the indivisible and over-budget fallbacks bit-identical
    too; 8 images through a CPU ``HeadFanoutServer`` within 5e-3; every
    pool 0 after ``close()``.  Each served run is a counted window: B1 30
    per backbone forward, H1 one per head pass;
  * [obs] (last, after [headfanout]), observability
    (``sparkdl_tpu_torch.obs``) around the served Xception and the head
    fan-out: loops of 1,000 requests from 1 and 8 clients (10 tenants in
    turn) on a server with tracing, the flight recorder, ``slos=`` and
    ``cost=CostLedger(max_tenants=8, window=6)`` all on and on one with
    all of them off, twice each (off, on, on, off): req/s, p50, p99 and
    the overhead; rows on == rows off bit for bit; every request's span
    chain request -> micro-batch -> ``engine.call`` (``device_ms`` from
    CUDA events) -> ``engine.dispatch``; the ledger's conservation and
    ``__overflow__``; ``varz()`` through ``json.dumps``; a
    ``serving.model`` sleep breaching the p99 objective (health degraded
    naming it, ``slo.breach``) and recovering; a pinned cost baseline and
    an ``engine.dispatch`` sleep opening and closing ``cost.regression``;
    a ``SPARKDL_TRACE=<dir>`` subprocess and a ``SPARKDL_BLACKBOX=<dir>``
    one sent SIGTERM while serving, their artifacts read back; a
    ``HeadFanoutServer`` with ``cost=`` (``head.swap``,
    ``cache.feature_hit``, a cost line per tenant); us a call of each
    instrumentation site disabled and enabled.  B1 and H1 counted in every
    window;
  * [fleet] (last, after [obs]), the model fleet
    (``sparkdl_tpu_torch.serving.fleet``): ``Fleet(max_batch_size=8,
    max_wait_ms=2, bucket_sizes=[8], cost=CostLedger())`` serving a zoo
    Xception at 299x299 (v1) and two versions of it (every float weight x
    (1 + 1e-3 N(0,1))), f32 with TF32 off: one client's 500 requests
    through the fleet and through the bare v1 ``Server`` (three runs a
    side, in turns); 8 clients of three tenants (gold high priority,
    silver, metered at burst 5) through a v2 canary at fraction 0.5
    captured under the load, a promote whose first attempt an injected
    ``fleet.swap`` fault fails, then a v3 canary rolled back: every row its
    version's oracle row (a bare engine at batch 8) bit for bit,
    ``no_recompile``, every bucket graph 30 B1 launches, the drained pools
    released, req/s, p50 and p99 a window, the shared ledger's sentinel;
    ``fleet.request`` spans parenting the servers' request spans; and a
    fan-out entry (16 tenants' heads, a hot swap midway) bit for bit its
    per-tenant oracle.  B1 and H1 counted in every window;
  * [stream] (after [fleet]), exactly-once streaming
    (``sparkdl_tpu_torch.streaming``) over the zoo Xception engine at
    299x299 and device batch 16 (B1 30 a dispatch), f32 with TF32 off, 12
    chunks of 16 seeded images: ``StreamScorer`` (pipelined) equal to
    ``map_batches`` bit for bit; a child scorer over a ``DirectorySource``
    SIGKILLed between an output artifact and its commit
    (``SPARKDL_FAULTS``), a second child resuming it to 12 commits, each
    once, bit for bit the parent's oracle; a ``Server`` sink at bucket 16
    equal to the engine sink; the stall watchdog (degraded, then ready)
    and a flaky source; three runs a side of the scorer against a bare
    ``map_batches``, the chunk latency, ms a fsync'd commit, the Server
    sink's rate; and the streaming fit of [tuning]'s converted
    InceptionV3 over 44 JPEGs in record batches of 10 against the
    in-memory fit (within [tuning]'s bounds), preempted and resumed by
    ``fit_with_retries``, with both fits' img/s;
  * [mesh] (after [stream]), the device mesh and the weight policy on
    the served zoo Xception at 299x299, buckets 8/16/32: ``Server(mesh=
    get_mesh(), partition_rules=default_partition_rules)`` and
    ``donate_batch=True`` serve the plain server's rows bit for bit (B1
    30 a dispatch), ``varz()["sharding"]`` reads mesh (1, 1), replicated,
    the module's counted bytes; ``HeadFanoutServer(mesh=get_mesh())``
    rows bit for bit their per-tenant oracles (H1 one launch a pass);
  * [train] (last), the rest of training on config 5's converted
    InceptionV3 at 299x299, batch 16 (none of the kernels): the captured
    step against the eager one for SGD and Adam, f32 and TF32 (held with
    cuDNN's deterministic algorithms, timed with its defaults: img/s,
    host us a step, pool bytes, capture s), ``steps_per_execution=4``
    against 1 with a ragged tail group, ``trainBatchStats`` on ResNet50
    captured against eager, two ranks on this one card over gloo (child
    processes, unequal shards, the in-memory then the stream fit; equal
    to each other and to a one-process fit on the global batches; only
    rank 0's checkpoint), and no fit's pool left behind.

B1 is also held against its plain version at ragged shapes (a pixel count
that is not a multiple of 64, F = 200, all four ReLU variants), and each of
its classes prints its launch plan (blocks, F groups S, waves, shared
memory).  So is B2 (a pixel count that is not a multiple of 64 under a
cluster split, ragged and non-square 2-D tiles, C = 968, F = 320 under a
split), and its classes print theirs (tile kind, cluster size S, F tile,
C chunk, stages, blocks, waves, shared memory).  So is B3 (N = 3 at
147x147, 13x11, F = 200, C = 72, two F tiles, a 6000-pixel row, all four
ReLU variants), and its classes print theirs (tile, F tile, stages,
blocks, items a block walks, shared memory).  Each path runs with every
launch count set to 0 just before it and read just after; the script
checks the counts and that each path's fused route agrees with the
model's unfused route.  The main Xception path also computes its unfused
features with PyTorch's default ``cudnn.allow_tf32 = True`` and holds them
against the TF32-off ones.  Any failed phase exits non-zero; without a
CUDA device it exits non-zero before printing any result.

The engine runs every forward above as one captured CUDA graph.  Two
phases check that path itself:

  * [graph], for Xception (default and ``SPARKDL_XC_TILED=1``),
    MobileNetV2 (``SPARKDL_MNV2_FUSED=1``), InceptionV3 (f32 and
    ``SPARKDL_ZOO_COMPUTE_DTYPE=bfloat16``), ResNet50 (plain and
    ``SPARKDL_RN_FUSED_SHORTCUT=1``), VGG16 and EfficientNetB0, each
    through its zoo engine, and the converted Keras InceptionV3 of
    [keras] through its own:
    the graphed forward equals the same engine's eager forward
    (``capture = False``) bit for bit; device ms per forward of both and of
    the replay alone, host us per dispatch, launches per batch (the
    wrappers' credited counts, which must equal one ``torch.profiler``
    pass over a replay; where our kernels run, the replay's kernel count
    must equal an eager forward's), the graph's pool; an in-place edit of
    a BatchNorm in a fused block (VGG16: of a conv weight) must bring a
    new capture whose output equals the eager forward's with that edit,
    and so must toggling
    ``cudnn.allow_tf32`` and a write through ``.data`` followed by
    clearing the model's fold caches; then a pytree batch with two float
    leaves of one shape through the pipelined runner;
  * [pipeline]: the Xception and MobileNetV2 featurizers over 8 batches and
    a ragged tail of 13 images, pipelined (the default), serial
    (``SPARKDL_PIPELINE=0``) and two at once from two threads on one
    engine, bit for bit; img/s of pipelined and serial, one batch's
    upload pageable vs pinned, and the runner's stage summary.

After every phase a ``[pool]`` line gives the CUDA-graph pool bytes that
live engines hold, the zoo engine cache's share of them and its bound,
and the card memory reserved: nothing clears the zoo caches between
phases.

Output: the card's name and power limit first, one line per phase, then
one JSON line of InceptionV3's numbers (img/s, forward ms, relative
errors, the recipe's accuracy), one of [zoo2]'s (img/s, forward ms,
relative errors), one JSON line of the [graph] and [pipeline] numbers,
one of [keras]'s (forward ms of the converted model beside the zoo's
per-branch route, launches per replay, host us per dispatch, graph pool,
the stages' img/s, relative errors), one of [tuning]'s (wall time, fit
and eval img/s, captures, metrics, relative errors),
one of [native]'s (the route and why, decode ms a batch), one of
[tfgraph]'s (import seconds, forward ms, kernel nodes, pool, relative
errors), one of [serving]'s (dispatches, relative errors, the closed
loops' numbers, pools, launches), one of [headfanout]'s (the replay's
passes, the hot swap, card vs CPU, pools, launches), one of [obs]'s
(the loops, the overhead, device ms, the ledger, the faults, the
subprocesses, the fan-out, us a site call, launches), one of [fleet]'s
(the overhead, the windows, the rollout, pools, the ledger, the fan-out,
launches), one of [stream]'s (the sinks, the chaos, the stall, the
rates, the fits, launches), one of [mesh]'s (the servers' sharding,
dispatches and launches, the fan-out), one of [train]'s (captured and
eager readings and rates, the groups, the statistics, the two ranks,
pools), one ``{"pools":
...}`` line (the graph pools held after every phase, by phase; later
phases add keys to it), one JSON line with every kernel's numbers (with
its launches in [serving], [headfanout], [obs], [fleet], [stream] and
[mesh]; H1's
``launches`` are its [headfanout] launches), and last the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import copy
import ctypes
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from itertools import chain

import numpy as np
import torch

SEED = 0
BATCH = 32
N_IMAGES = 64
N_PREDICT = 32
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 outputs: about 2 bf16 steps at |y| ~ 4
MAIN_PATH_REL_TOL = 5e-2                  # fused vs unfused, as the JAX package's tests
INCEPTION_ROUTE_TOL = 1e-3                # f32 routes of one function (reference f32 bar)
LR_CARD_CPU_TOL = 1e-2                    # LR (w, b) fitted on the card vs on the CPU
ZOO2_FEATURES_TOL = 2e-5                  # card f32 (TF32 off) features vs the CPU; fsc vs plain
ZOO2_PROBS_TOL = 1e-4                     # card f32 probabilities vs the CPU (softmax scales logit error)
# The transfer-learning recipe: RECIPE_PER_CLASS images of each base colour,
# the first RECIPE_TRAIN of them (seeded order) to fit on, the rest held out.
RECIPE_BASES = [(220, 40, 40), (40, 200, 40), (40, 40, 220), (220, 220, 40),
                (200, 40, 200)]
RECIPE_PER_CLASS = 32
RECIPE_TRAIN = 128
RECIPE_MIN_ACC = 0.9
PEAK_BF16_FLOPS = 989e12                  # H100 SXM dense bf16
PEAK_F32_FLOPS = 67e12                    # H100 SXM f32, outside the tensor cores
PEAK_BYTES = 3.35e12                      # H100 SXM HBM3

# The shape classes Xception's fused route gives the whole-image sepconv
# kernel (B1) at 299x299: (H=W, C, F, pre_relu, post_relu, launches per
# forward).
SEPCONV_SHAPES = [
    (37, 256, 728, True, False, 1),    # block4_sepconv1
    (37, 728, 728, True, False, 1),    # block4_sepconv2
    (19, 728, 728, True, False, 25),   # middle flow (24) + block13_sepconv1
    (19, 728, 1024, True, False, 1),   # block13_sepconv2
    (10, 1024, 1536, False, True, 1),  # block14_sepconv1
    (10, 1536, 2048, False, True, 1),  # block14_sepconv2
]
SEPCONV_PER_FORWARD = sum(s[-1] for s in SEPCONV_SHAPES)  # 30

# Shapes off the main path that B1 must take too: (N, H=W, C, F, pre_relu,
# post_relu).  A pixel count that is not a multiple of 64, an F that no
# tile width divides, and all four ReLU variants.
SEPCONV_RAGGED = [
    (3, 19, 728, 728, True, False),
    (32, 19, 728, 200, False, False),
    (2, 10, 1024, 1536, True, True),
    (4, 19, 256, 728, False, True),
]

# The entry blocks 2-3 the tiled kernel (B3) takes with SPARKDL_XC_TILED=1.
TILED_SHAPES = [
    (147, 64, 128, False, False, 1),   # block2_sepconv1 (no leading relu)
    (147, 128, 128, True, False, 1),   # block2_sepconv2
    (74, 128, 256, True, False, 1),    # block3_sepconv1
    (74, 256, 256, True, False, 1),    # block3_sepconv2
]
TILED_PER_FORWARD = sum(s[-1] for s in TILED_SHAPES)  # 4

# Shapes off the main path that B3 must take too: (N, H, W, C, F, pre_relu,
# post_relu).  N = 3 at 147x147 (the blocks' last items fill part of a
# wave), a non-square image with ragged tiles on both axes, F = 200 (no F
# tile divides it), C = 72 (its last 64-channel chunk holds 8), two F
# tiles, a row far wider than B1 takes, and all four ReLU variants.
TILED_RAGGED = [
    (3, 147, 147, 64, 128, False, False),
    (2, 13, 11, 128, 128, True, True),
    (4, 74, 74, 128, 200, True, False),
    (2, 37, 37, 72, 128, False, True),
    (2, 19, 23, 128, 328, False, True),
    (1, 8, 6000, 256, 256, True, False),
]

# MobileNetV2's 13 stride-1 tails at 224x224: (H=W, expanded C, F,
# launches per forward).
MBCONV_SHAPES = [
    (112, 32, 16, 1),    # expanded_conv
    (56, 144, 24, 1),    # block_2
    (28, 192, 32, 2),    # block_4, block_5
    (14, 384, 64, 3),    # block_7-9
    (14, 384, 96, 1),    # block_10
    (14, 576, 96, 2),    # block_11, block_12
    (7, 960, 160, 2),    # block_14, block_15
    (7, 960, 320, 1),    # block_16
]
MBCONV_PER_FORWARD = sum(s[-1] for s in MBCONV_SHAPES)  # 13

# Shapes off the main path that B2 must take too: (N, H, W, C, F, tile
# kind forced on the plan or None for its own choice).  A pixel count that
# is not a multiple of 64 under a cluster split, a 2-D tile with a ragged
# edge (28 = 3*8 + 4), a non-square image on both tile kinds, a C whose
# last chunk is partly past C (968 = 30*32 + 8), two F tiles under a split.
MBCONV_RAGGED = [
    (3, 7, 7, 960, 160, None),
    (32, 28, 28, 192, 32, "2d"),
    (2, 13, 11, 144, 24, None),
    (2, 13, 11, 144, 24, "2d"),
    (3, 7, 7, 968, 160, None),
    (3, 14, 14, 384, 320, None),
]


# The paths through the engine's captured forward: (tag, model, input
# size, environment knobs, launches per batch (B1, B3, B2), the tensor the
# recapture check edits in place: a BatchNorm's, in a fused block where
# the model has one; VGG16 has no BatchNorm, so a conv weight).
GRAPH_PATHS = [
    ("xception", "Xception", 299, {}, (SEPCONV_PER_FORWARD, 0, 0),
     "block5_sepconv1_bn.running_var"),
    ("xception tiled", "Xception", 299, {"SPARKDL_XC_TILED": "1"},
     (SEPCONV_PER_FORWARD, TILED_PER_FORWARD, 0),
     "block2_sepconv1_bn.running_var"),
    ("mobilenet fused", "MobileNetV2", 224, {"SPARKDL_MNV2_FUSED": "1"},
     (0, 0, MBCONV_PER_FORWARD), "block_2_project_BN.running_var"),
    ("inception f32", "InceptionV3", 299, {}, (0, 0, 0),
     "mixed0_b1x1.bn.running_var"),
    ("inception bf16", "InceptionV3", 299,
     {"SPARKDL_ZOO_COMPUTE_DTYPE": "bfloat16"}, (0, 0, 0),
     "mixed0_b1x1.bn.running_var"),
    ("resnet50", "ResNet50", 224, {}, (0, 0, 0),
     "conv3_block1.conv3_block1_1_bn.running_var"),
    ("resnet50 fsc", "ResNet50", 224, {"SPARKDL_RN_FUSED_SHORTCUT": "1"},
     (0, 0, 0), "conv3_block1.conv3_block1_0_bn.running_var"),
    ("vgg16", "VGG16", 224, {}, (0, 0, 0), "block5_conv3.weight"),
    ("efficientnetb0", "EfficientNetB0", 224, {}, (0, 0, 0),
     "block4a_bn.running_var"),
    # the converted Keras InceptionV3 of [keras], not a zoo engine
    ("keras inceptionv3", "keras:InceptionV3", 299, {}, (0, 0, 0),
     "layers.batch_normalization_50.running_var"),
]
GRAPH_TIMED_REPLAYS = 10                  # replays timed per path (median)
# [pipeline]: featurizer runs over PIPELINE_BATCHES full batches and a
# ragged tail of PIPELINE_TAIL images, pipelined and serial.
PIPELINE_BATCHES = 8
PIPELINE_TAIL = 13
PIPELINE_PATHS = [("Xception", 299, {}),
                  ("MobileNetV2", 224, {"SPARKDL_MNV2_FUSED": "1"})]


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps=25, warmup=3):
    """Median time of ``fn()`` in ms over ``reps`` runs, CUDA events
    around each run after ``warmup`` runs: the device's time from the first
    enqueued kernel to the last, host enqueue gaps included (what a model
    forward costs a caller)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, calls=20, reps=5):
    """Device time of one ``fn()`` in ms: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events (median), so
    the host's launch cost (tens of microseconds through ctypes) stays out
    of the kernel's time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: plans, allocator
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def host_us_per_call(fn, calls=200):
    """Host time of one ``fn()`` call in microseconds: ``calls`` calls
    enqueued back to back (no synchronisation between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """(bound ms, what sets it) on the published H100 SXM peaks (bf16
    tensor-core operations unless ``peak_flops`` says otherwise)."""
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def compare(out, ref, what):
    """Max abs error of a kernel's output against its plain version; fails
    on a non-finite output or an element outside KERNEL_TOL."""
    check(torch.isfinite(out.float()).all().item(),
          f"kernel output not finite at {what}")
    err = (out.float() - ref.float()).abs()
    max_abs = err.max().item()
    bad = (err > KERNEL_TOL["atol"]
           + KERNEL_TOL["rtol"] * ref.float().abs()).sum().item()
    check(bad == 0, f"kernel disagrees with plain version at {what}: "
                    f"{bad} elements, max abs {max_abs}")
    return max_abs


def entry(name, source, replaces, rows, worst):
    """A kernel's JSON entry: ms / plain_ms / library_ms / bound_ms are one
    forward's launches at batch 32, summed over the shape classes (per
    class in "shapes"); ``launches`` is filled from its main path's run."""
    tot = {k: sum(r["launches_per_forward"] * r[k] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
                     "bytes_ms")}
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": None, "max_abs_err": worst,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                     else "bytes"),
        "library_ms": tot["library_ms"], "shapes": rows,
    }


def phase_build(sepconv):
    t0 = time.perf_counter()
    sepconv.load_all()
    build_s = time.perf_counter() - t0
    sources = [s for _, srcs, _, _ in sepconv.KERNELS.values() for s in srcs]
    print(f"[build] {', '.join(sources)} built+loaded in {build_s:.2f}s "
          f"(one nvcc each, in parallel)", flush=True)
    for kernel in sepconv.KERNELS:
        # ptxas reports one "Used N registers" and one "... spill stores"
        # line per template instance
        log = sepconv.build_log(kernel).splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log
                if "Used " in ln and "registers" in ln]
        spills = [int(ln.split("bytes spill stores")[0].split(",")[-1])
                  for ln in log if "bytes spill stores" in ln]
        print(f"[build] {kernel} ptxas: " + (
            f"{len(regs)} instances, {min(regs)}-{max(regs)} registers, "
            f"at most {max(spills, default=0)} bytes spilled" if regs
            else "n/a (library was cached)"), flush=True)


def _sepconv_inputs(g, n, hw, c, f, w=None):
    """Seeded operands of an [n, hw, w or hw, c] -> f sepconv on the card."""
    dev = "cuda"
    x = torch.randn(n, hw, w or hw, c, device=dev, generator=g).bfloat16()
    dwk = (torch.randn(3, 3, c, device=dev, generator=g) / 3).bfloat16()
    pw = (torch.randn(c, f, device=dev, generator=g) / math.sqrt(c)
          ).bfloat16()
    scale = torch.rand(f, device=dev, generator=g) * 0.4 + 0.8
    shift = torch.randn(f, device=dev, generator=g) * 0.05
    return x, dwk, pw, scale, shift


def _sepconv_library(x, dwk, pw, scale, shift, pre, post):
    """Yardstick: cuDNN depthwise + 1x1 conv + affine, bf16 (never called
    by the port)."""
    import torch.nn.functional as F

    c, f = pw.shape
    xc = x.permute(0, 3, 1, 2)
    dw_w = dwk.permute(2, 0, 1).reshape(c, 1, 3, 3).contiguous(
        memory_format=torch.channels_last)
    pw_w = pw.t().reshape(f, c, 1, 1).contiguous(
        memory_format=torch.channels_last)
    s_b = scale.bfloat16().reshape(1, f, 1, 1)
    t_b = shift.bfloat16().reshape(1, f, 1, 1)

    def library():
        y = F.conv2d(torch.relu(xc) if pre else xc, dw_w, padding=1, groups=c)
        y = F.conv2d(y, pw_w) * s_b + t_b
        return torch.relu(y) if post else y

    return library


def phase_sepconv_kernel(sepconv, tiled):
    """B1 (``tiled`` False) at its six shape classes or B3 (True) at the
    four entry classes: kernel vs plain version, with kernel, plain,
    library and bound ms.  At B3's classes B1's time on the same inputs is
    kept beside it (``b1_ms``): what the 2-D tile buys."""
    g = torch.Generator(device="cuda").manual_seed(SEED + int(tiled))
    kern = (sepconv._fused_sepconv_tiled_cuda if tiled
            else sepconv._fused_sepconv_cuda)
    tag = "sepconv_tiled" if tiled else "sepconv"
    rows, worst = [], 0.0
    for hw, c, f, pre, post, per_fwd in (TILED_SHAPES if tiled
                                          else SEPCONV_SHAPES):
        n = BATCH
        args = _sepconv_inputs(g, n, hw, c, f)
        plan = (sepconv._sepconv_tiled_plan if tiled
                else sepconv._sepconv_plan)(n, hw, hw, c, f)
        out = kern(*args, pre, post)
        torch.cuda.synchronize()
        ref = sepconv.sepconv_reference(*args, pre, post)
        max_abs = compare(out, ref, (tag, hw, c, f))
        worst = max(worst, max_abs)
        del out, ref
        k_ms = graph_ms(lambda: kern(*args, pre, post))
        p_ms = graph_ms(lambda: sepconv.sepconv_reference(*args, pre, post),
                        calls=5)
        l_ms = graph_ms(_sepconv_library(*args, pre, post))
        flops = 2.0 * n * hw * hw * c * (9 + f)
        nbytes = 2.0 * (n * hw * hw * (c + f) + 9 * c + c * f) + 8.0 * f
        b_ms, b_by = bound(flops, nbytes)
        row = dict(shape=[n, hw, hw, c, f], pre_relu=pre, post_relu=post,
                   launches_per_forward=per_fwd, max_abs_err=max_abs,
                   ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                   bound_by=b_by, ops_ms=flops / PEAK_BF16_FLOPS * 1e3,
                   bytes_ms=nbytes / PEAK_BYTES * 1e3)
        row["plan"] = plan
        print(f"[plan] {tag} N={n} {hw}x{hw} C={c} F={f}: "
              f"{(tiled_plan_text if tiled else plan_text)(plan)}",
              flush=True)
        extra = ""
        if tiled:
            row["b1_ms"] = graph_ms(lambda: sepconv._fused_sepconv_cuda(
                *args, pre, post))
            extra = f" b1_ms={row['b1_ms']:.4f}"
        rows.append(row)
        print(f"[kernel] {tag} N={n} {hw}x{hw} C={c} F={f} pre={int(pre)} "
              f"post={int(post)}: max_abs_err={max_abs:.5f} "
              f"kernel_ms={k_ms:.4f}{extra} plain_ms={p_ms:.4f} "
              f"library_ms={l_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"-> {b_ms / k_ms:.1%} of bound", flush=True)
    hw, c, f, pre, post, _ = (TILED_SHAPES if tiled else SEPCONV_SHAPES)[-1]
    args = _sepconv_inputs(g, BATCH, hw, c, f)
    host = host_us_per_call(lambda: kern(*args, pre, post))
    print(f"[kernel] {tag} host cost per wrapper call (ctypes launch "
          f"included): {host:.1f} us", flush=True)
    if tiled:
        e = entry("fused_sepconv_tiled",
                  "sparkdl_tpu_torch/ops/csrc/sepconv_tiled.cu",
                  "sparkdl_tpu/ops/sepconv.py:215", rows, worst)
        e["b1_ms"] = sum(r["launches_per_forward"] * r["b1_ms"] for r in rows)
    else:
        e = entry("fused_sepconv", "sparkdl_tpu_torch/ops/csrc/sepconv.cu",
                  "sparkdl_tpu/ops/sepconv.py:143", rows, worst)
    e["host_us_per_launch"] = host
    return e


def plan_text(plan):
    return (f"blocks={plan['blocks']} S={plan['groups']} "
            f"tiles/group={plan['tiles_per_group']} NT={plan['n_tile']} "
            f"KC={plan['kc']} stages={plan['stages']} "
            f"waves={plan['waves']} smem={plan['smem']} B")


def tiled_plan_text(plan):
    return (f"tile={plan['tile_h']}x{plan['tile_w']} "
            f"F_tile={plan['f_tile']} x{plan['f_tiles']} "
            f"stages={plan['stages']} blocks={plan['grid']} "
            f"tiles={plan['tiles']} items/block<={plan['items']} "
            f"smem={plan['smem']} B")


def phase_sepconv_tiled_ragged(sepconv):
    """B3 at the shapes of TILED_RAGGED, each held against its plain
    version; returns the largest max abs error."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst = 0.0
    for n, h, w, c, f, pre, post in TILED_RAGGED:
        args = _sepconv_inputs(g, n, h, c, f, w)
        out = sepconv._fused_sepconv_tiled_cuda(*args, pre, post)
        torch.cuda.synchronize()
        ref = sepconv.sepconv_reference(*args, pre, post)
        max_abs = compare(out, ref, ("sepconv_tiled ragged", n, h, w, c, f,
                                     pre, post))
        worst = max(worst, max_abs)
        print(f"[kernel] sepconv_tiled ragged N={n} {h}x{w} C={c} F={f} "
              f"pre={int(pre)} post={int(post)}: max_abs_err={max_abs:.5f}; "
              f"{tiled_plan_text(sepconv._sepconv_tiled_plan(n, h, w, c, f))}",
              flush=True)
    return worst


def phase_sepconv_ragged(sepconv):
    """B1 at the shapes of SEPCONV_RAGGED, each held against its plain
    version; returns the largest max abs error."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0.0
    for n, hw, c, f, pre, post in SEPCONV_RAGGED:
        args = _sepconv_inputs(g, n, hw, c, f)
        out = sepconv._fused_sepconv_cuda(*args, pre, post)
        torch.cuda.synchronize()
        ref = sepconv.sepconv_reference(*args, pre, post)
        max_abs = compare(out, ref, ("sepconv ragged", n, hw, c, f, pre, post))
        worst = max(worst, max_abs)
        print(f"[kernel] sepconv ragged N={n} {hw}x{hw} C={c} F={f} "
              f"pre={int(pre)} post={int(post)}: max_abs_err={max_abs:.5f}; "
              f"{plan_text(sepconv._sepconv_plan(n, hw, hw, c, f))}",
              flush=True)
    return worst


def _mbconv_inputs(g, n, h, w, c, f):
    dev = "cuda"
    x = (torch.randn(n, h, w, c, device=dev, generator=g) * 2).bfloat16()
    dwk = (torch.randn(3, 3, c, device=dev, generator=g) / 3).bfloat16()
    pw = (torch.randn(c, f, device=dev, generator=g) / math.sqrt(c)
          ).bfloat16()
    mid = torch.randn(c, device=dev, generator=g) * 0.5
    shift = torch.randn(f, device=dev, generator=g) * 0.05
    return x, dwk, pw, mid, shift


def _mbconv_library(x, dwk, pw, mid, shift):
    """Yardstick: cuDNN depthwise, +mid_shift, clamp, 1x1 conv, +shift, in
    bf16 (never called by the port)."""
    import torch.nn.functional as F

    c, f = pw.shape
    xc = x.permute(0, 3, 1, 2)
    dw_w = dwk.permute(2, 0, 1).reshape(c, 1, 3, 3).contiguous(
        memory_format=torch.channels_last)
    pw_w = pw.t().reshape(f, c, 1, 1).contiguous(
        memory_format=torch.channels_last)
    m_b = mid.bfloat16().reshape(1, c, 1, 1)
    t_b = shift.bfloat16().reshape(1, f, 1, 1)

    def library():
        y = F.conv2d(xc, dw_w, padding=1, groups=c) + m_b
        return F.conv2d(torch.clamp(y, 0.0, 6.0), pw_w) + t_b

    return library


def mbconv_plan_text(plan):
    return (f"tile={plan['tile']} S={plan['cluster']} "
            f"F_tile={plan['f_tile']} KC={plan['kc']} "
            f"stages={plan['stages']} chunks={plan['chunks']} "
            f"tiles/block={plan['tiles_per_block']} blocks={plan['blocks']} "
            f"waves={plan['waves']} smem={plan['smem']} B")


def phase_mbconv_kernel(sepconv):
    """B2 at MobileNetV2's eight shape classes: kernel vs plain version,
    with kernel, plain, library and bound ms, and each class's plan."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows, worst = [], 0.0
    for hw, c, f, per_fwd in MBCONV_SHAPES:
        n = BATCH
        args = _mbconv_inputs(g, n, hw, hw, c, f)
        plan = sepconv._mbconv_plan(n, hw, hw, c, f)
        print(f"[plan] mbconv N={n} {hw}x{hw} C={c} F={f}: "
              f"{mbconv_plan_text(plan)}", flush=True)
        out = sepconv._fused_mbconv_cuda(*args)
        torch.cuda.synchronize()
        ref = sepconv.mbconv_reference(*args)
        max_abs = compare(out, ref, ("mbconv", hw, c, f))
        worst = max(worst, max_abs)
        del out, ref

        k_ms = graph_ms(lambda: sepconv._fused_mbconv_cuda(*args))
        p_ms = graph_ms(lambda: sepconv.mbconv_reference(*args), calls=5)
        l_ms = graph_ms(_mbconv_library(*args))
        flops = 2.0 * n * hw * hw * c * (9 + f)
        nbytes = (2.0 * (n * hw * hw * (c + f) + 9 * c + c * f)
                  + 4.0 * (c + f))
        b_ms, b_by = bound(flops, nbytes)
        rows.append(dict(shape=[n, hw, hw, c, f], launches_per_forward=per_fwd,
                         max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                         ops_ms=flops / PEAK_BF16_FLOPS * 1e3,
                         bytes_ms=nbytes / PEAK_BYTES * 1e3, plan=plan))
        print(f"[kernel] mbconv N={n} {hw}x{hw} C={c} F={f}: "
              f"max_abs_err={max_abs:.5f} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) -> {b_ms / k_ms:.1%} of bound",
              flush=True)
    host = host_us_per_call(lambda: sepconv._fused_mbconv_cuda(*args))
    print(f"[kernel] mbconv host cost per wrapper call (ctypes launch "
          f"included): {host:.1f} us", flush=True)
    e = entry("fused_mbconv", "sparkdl_tpu_torch/ops/csrc/mbconv.cu",
              "sparkdl_tpu/ops/sepconv.py:290", rows, worst)
    e["host_us_per_launch"] = host
    return e


def phase_mbconv_ragged(sepconv):
    """B2 at the shapes of MBCONV_RAGGED, each held against its plain
    version; returns the largest max abs error."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = 0.0
    for n, h, w, c, f, tile in MBCONV_RAGGED:
        args = _mbconv_inputs(g, n, h, w, c, f)
        plan = sepconv._mbconv_plan(n, h, w, c, f, tile)
        out = sepconv._fused_mbconv_cuda(*args, plan=plan)
        torch.cuda.synchronize()
        ref = sepconv.mbconv_reference(*args)
        max_abs = compare(out, ref, ("mbconv ragged", n, h, w, c, f, tile))
        worst = max(worst, max_abs)
        print(f"[kernel] mbconv ragged N={n} {h}x{w} C={c} F={f}: "
              f"max_abs_err={max_abs:.5f}; {mbconv_plan_text(plan)}",
              flush=True)
    return worst


def synthetic_frame(n, size, seed):
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)

    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return DataFrame(structsToArrow(
        [imageArrayToStruct(im, origin=f"synthetic_{i}")
         for i, im in enumerate(imgs)]))


def reset_counts(sepconv):
    sepconv.fused_sepconv.launches = 0
    sepconv.fused_sepconv.tiled_launches = 0
    sepconv.fused_mbconv.launches = 0


def read_counts(sepconv):
    return dict(sepconv=sepconv.fused_sepconv.launches,
                sepconv_tiled=sepconv.fused_sepconv.tiled_launches,
                mbconv=sepconv.fused_mbconv.launches)


def unfused_check(name, df, feats, size, tag, tf32=False):
    """Features of the same uint8 batches through the model's unfused route
    on the card; fails above MAIN_PATH_REL_TOL.  With ``tf32`` the unfused
    features are computed once more under PyTorch's default
    ``cudnn.allow_tf32 = True`` and held against the TF32-off ones (which
    the CPU tests tie to the JAX package), also within MAIN_PATH_REL_TOL.
    Returns (rel err, fused ms, unfused ms, TF32 rel err or None), the
    times one forward of BATCH images timed by ``cuda_ms``."""
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import named_image as ni

    batch, ok = arrowStructsToBatch(df.table.column("image"), size, size)
    check(ok.all(), "synthetic images failed to decode")
    batch = batch[:len(feats)]
    fused_eng = ni._zoo_engine(name, True, BATCH)
    plain_eng = InferenceEngine(ni.zoo_model_fn(name, True),
                                ni._cached_model(name), device="cuda",
                                device_batch_size=BATCH)
    plain_eng.module.fused_inference = False
    want = plain_eng(batch)
    rel = float(np.linalg.norm(feats - want) / np.linalg.norm(want))
    rel_tf32 = None
    if tf32:
        torch.backends.cudnn.allow_tf32 = True
        try:
            want_tf32 = plain_eng(batch)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        rel_tf32 = float(np.linalg.norm(want_tf32 - want)
                         / np.linalg.norm(want))
        print(f"[{tag}] unfused f32 route, cudnn.allow_tf32 True vs False: "
              f"||a-b||/||b|| = {rel_tf32:.3e} (the reference's f32 "
              f"tolerance 1e-3 {'met' if rel_tf32 <= 1e-3 else 'not met'}; "
              f"fails above {MAIN_PATH_REL_TOL})", flush=True)
        check(rel_tf32 <= MAIN_PATH_REL_TOL,
              f"{tag}: unfused features with TF32 on: rel err "
              f"{rel_tf32:.4g} > {MAIN_PATH_REL_TOL}")
    check(rel <= MAIN_PATH_REL_TOL,
          f"{tag}: fused vs unfused features: rel err {rel:.4g} > "
          f"{MAIN_PATH_REL_TOL}")
    # one batch already in each engine's pinned host buffer, as the
    # runner's prepare stage leaves it
    fused_piece = fused_eng._pad(batch[:BATCH])
    plain_piece = plain_eng._pad(batch[:BATCH])
    fused_ms = cuda_ms(lambda: fused_eng.run_padded(fused_piece), reps=10)
    plain_ms = cuda_ms(lambda: plain_eng.run_padded(plain_piece), reps=10)
    print(f"[{tag}] fused vs unfused route: ||a-b||/||b|| = {rel:.3e} "
          f"(tol {MAIN_PATH_REL_TOL}); device forward per batch of {BATCH}: "
          f"fused {fused_ms:.2f} ms, unfused {plain_ms:.2f} ms", flush=True)
    return rel, fused_ms, plain_ms, rel_tf32


def featurize_predict(name, size, n_images, n_predict, sepconv, tag):
    """Featurize ``n_images`` and (when ``n_predict``) predict top-5 of
    ``n_predict`` synthetic images through the user entry points; returns
    (frame, features, launch counts of that run, img/s of the featurizer
    and of the predictor or None)."""
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.transformers import named_image as ni

    df = synthetic_frame(n_images, size, SEED)
    spec_dim = get_model_spec(name).feature_size
    feat = ni.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                  modelName=name, batchSize=BATCH)
    pred = ni.DeepImagePredictor(inputCol="image", outputCol="preds",
                                 modelName=name, decodePredictions=True,
                                 topK=5, batchSize=BATCH)
    # warm-up: builds the engines (weights to the card) and cuDNN plans
    feat.transform(df.limit(BATCH))
    if n_predict:
        pred.transform(df.limit(n_predict))
    torch.cuda.synchronize()

    reset_counts(sepconv)
    t0 = time.perf_counter()
    out = feat.transform(df)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    pred_s = 0.0
    if n_predict:
        t0 = time.perf_counter()
        pout = pred.transform(df.limit(n_predict))
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
    counts = read_counts(sepconv)

    feats = out.column_to_numpy("features")
    check(feats.shape == (n_images, spec_dim), f"{tag}: feature shape "
                                               f"{feats.shape}")
    check(np.isfinite(feats).all(), f"{tag}: features not finite")
    msg = (f"[{tag}] DeepImageFeaturizer {name} {size}x{size} batch {BATCH}: "
           f"{n_images} images in {feat_s:.3f}s = {n_images / feat_s:.1f} "
           f"img/s")
    if n_predict:
        preds = pout.table.column("preds").to_pylist()
        check(len(preds) == n_predict and all(len(r) == 5 for r in preds),
              f"{tag}: predictor did not return top-5 rows")
        for r in preds:
            p = [e["probability"] for e in r]
            check(all(math.isfinite(v) for v in p)
                  and p == sorted(p, reverse=True),
                  f"{tag}: predictor probabilities not finite and sorted")
        msg += (f"; DeepImagePredictor top-5: {n_predict} images in "
                f"{pred_s:.3f}s = {n_predict / pred_s:.1f} img/s")
    print(f"{msg}; launches {counts}", flush=True)
    rates = dict(featurize=n_images / feat_s,
                 predict=n_predict / pred_s if n_predict else None)
    return df, feats, counts, rates


def phase_xception(sepconv):
    """Default Xception path: 30 B1 launches per batch, no other kernel."""
    df, feats, counts, _ = featurize_predict("Xception", 299, N_IMAGES,
                                             N_PREDICT, sepconv, "main")
    batches = N_IMAGES // BATCH + N_PREDICT // BATCH
    check(counts == dict(sepconv=SEPCONV_PER_FORWARD * batches,
                         sepconv_tiled=0, mbconv=0),
          f"Xception launches {counts}, want {SEPCONV_PER_FORWARD} sepconv "
          f"per batch x {batches}")
    rel_tf32 = unfused_check("Xception", df, feats, 299, "main", tf32=True)[3]
    return counts["sepconv"], rel_tf32


def phase_mobilenet(sepconv):
    """MobileNetV2 with SPARKDL_MNV2_FUSED=1: 13 B2 launches per batch."""
    os.environ["SPARKDL_MNV2_FUSED"] = "1"
    try:
        df, feats, counts, _ = featurize_predict(
            "MobileNetV2", 224, N_IMAGES, N_PREDICT, sepconv, "mobilenet")
        batches = N_IMAGES // BATCH + N_PREDICT // BATCH
        check(counts == dict(sepconv=0, sepconv_tiled=0,
                             mbconv=MBCONV_PER_FORWARD * batches),
              f"MobileNetV2 launches {counts}, want {MBCONV_PER_FORWARD} "
              f"mbconv per batch x {batches}")
        _, fused_ms, plain_ms, _ = unfused_check("MobileNetV2", df, feats, 224,
                                              "mobilenet")
    finally:
        del os.environ["SPARKDL_MNV2_FUSED"]
    return counts["mbconv"], dict(fused=fused_ms, unfused=plain_ms)


def phase_xception_tiled(sepconv):
    """Xception with SPARKDL_XC_TILED=1, one featurizer batch: 4 B3 and 30
    B1 launches."""
    os.environ["SPARKDL_XC_TILED"] = "1"
    try:
        df, feats, counts, _ = featurize_predict("Xception", 299, BATCH, 0,
                                                 sepconv, "tiled")
        check(counts == dict(sepconv=SEPCONV_PER_FORWARD,
                             sepconv_tiled=TILED_PER_FORWARD, mbconv=0),
              f"tiled Xception launches {counts}, want "
              f"{TILED_PER_FORWARD} tiled + {SEPCONV_PER_FORWARD} sepconv")
        unfused_check("Xception", df, feats, 299, "tiled")
    finally:
        del os.environ["SPARKDL_XC_TILED"]
    return counts["sepconv_tiled"]


def tinted_frame(n_per_class, size, seed):
    """``n_per_class`` seeded ``size`` x ``size`` uint8 images of each class
    of RECIPE_BASES in a seeded order, with a "label" column: class k is
    clip(base_k + N(0, 40)) per pixel and channel."""
    import pyarrow as pa

    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)

    rng = np.random.default_rng(seed)
    bases = np.asarray(RECIPE_BASES, np.float32)
    labels = rng.permutation(np.repeat(np.arange(len(bases)), n_per_class))
    structs = [imageArrayToStruct(np.clip(
        bases[k] + rng.normal(0, 40, (size, size, 3)), 0, 255).astype(
        np.uint8), origin=f"tinted_{i}") for i, k in enumerate(labels)]
    return DataFrame(structsToArrow(structs)).withColumn(
        "label", pa.array(labels.astype(np.int64)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_inception(sepconv):
    """InceptionV3 at 299x299 (config 1 of the reference's recipe): no
    kernel of B1-B3 on its path.  Featurize + predict in f32 with TF32 off;
    the fused-head route against the per-branch one and the s2d stem
    against the default (both <= INCEPTION_ROUTE_TOL), cuDNN TF32 and the
    bf16 engine against f32 (<= MAIN_PATH_REL_TOL); then the
    transfer-learning recipe: Pipeline([DeepImageFeaturizer,
    LogisticRegression]) fitted on RECIPE_TRAIN tinted images, held-out
    accuracy >= RECIPE_MIN_ACC, and the card's LR fit held against the
    CPU's on the same features (<= LR_CARD_CPU_TOL)."""
    from sparkdl_tpu_torch import default_device
    from sparkdl_tpu_torch.estimators import (
        LogisticRegression, MulticlassClassificationEvaluator)
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.transformers import named_image as ni
    from sparkdl_tpu_torch.transformers.base import Pipeline

    name, tag = "InceptionV3", "inception"
    zero = dict(sepconv=0, sepconv_tiled=0, mbconv=0)
    df, feats, counts, rates = featurize_predict(name, 299, N_IMAGES,
                                                 N_PREDICT, sepconv, tag)
    check(counts == zero, f"{tag}: launches {counts}, want none of B1-B3")
    rel_fh, fused_ms, plain_ms, rel_tf32 = unfused_check(
        name, df, feats, 299, tag, tf32=True)
    check(rel_fh <= INCEPTION_ROUTE_TOL,
          f"{tag}: fused heads vs per-branch rel err {rel_fh:.4g} > "
          f"{INCEPTION_ROUTE_TOL}")
    piece = arrowStructsToBatch(df.table.column("image"), 299, 299)[0][:BATCH]
    eng = ni._zoo_engine(name, True, BATCH)
    staged = eng._pad(piece)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_ms = cuda_ms(lambda: eng.run_padded(staged), reps=10)
    finally:
        torch.backends.cudnn.allow_tf32 = False

    def variant(knob, value, n):
        os.environ[knob] = value
        try:
            _, got, c, r = featurize_predict(name, 299, n, 0, sepconv,
                                             f"{tag} {knob}={value}")
            v_eng = ni._zoo_engine(name, True, BATCH)
            v_piece = v_eng._pad(piece)
            ms = cuda_ms(lambda: v_eng.run_padded(v_piece), reps=10)
        finally:
            del os.environ[knob]
        check(c == zero, f"{tag} {knob}={value}: launches {c}")
        return _rel(got, feats[:n]), r["featurize"], ms

    rel_s2d, _, s2d_ms = variant("SPARKDL_S2D_STEM", "1", BATCH)
    check(rel_s2d <= INCEPTION_ROUTE_TOL,
          f"{tag}: s2d stem vs default rel err {rel_s2d:.4g} > "
          f"{INCEPTION_ROUTE_TOL}")
    rel_bf16, bf16_ips, bf16_ms = variant("SPARKDL_ZOO_COMPUTE_DTYPE",
                                          "bfloat16", N_IMAGES)
    check(rel_bf16 <= MAIN_PATH_REL_TOL,
          f"{tag}: bf16 vs f32 rel err {rel_bf16:.4g} > {MAIN_PATH_REL_TOL}")
    print(f"[{tag}] s2d stem vs default ||a-b||/||b|| = {rel_s2d:.3e} (tol "
          f"{INCEPTION_ROUTE_TOL}); bf16 vs f32 = {rel_bf16:.3e} (tol "
          f"{MAIN_PATH_REL_TOL}), bf16 featurizer {bf16_ips:.1f} img/s; "
          f"device forward per batch of {BATCH}: f32 fused heads "
          f"{fused_ms:.2f} ms, per-branch {plain_ms:.2f} ms, TF32 on "
          f"{tf32_ms:.2f} ms, s2d stem {s2d_ms:.2f} ms, bf16 {bf16_ms:.2f} "
          f"ms", flush=True)

    tdf = tinted_frame(RECIPE_PER_CLASS, 299, SEED + 7)
    train_df = tdf.limit(RECIPE_TRAIN)
    test_df = DataFrame(tdf.table.slice(RECIPE_TRAIN))
    featurizer = ni.DeepImageFeaturizer(inputCol="image",
                                        outputCol="features", modelName=name,
                                        batchSize=BATCH)
    lr = LogisticRegression(maxIter=20, batchSize=32)
    reset_counts(sepconv)
    t0 = time.perf_counter()
    model = Pipeline(stages=[featurizer, lr]).fit(train_df)
    scored = model.transform(test_df)
    torch.cuda.synchronize()
    recipe_s = time.perf_counter() - t0
    counts = read_counts(sepconv)
    check(counts == zero, f"{tag} recipe: launches {counts}")
    acc = MulticlassClassificationEvaluator().evaluate(scored)
    check(acc >= RECIPE_MIN_ACC, f"{tag} recipe: held-out accuracy {acc:.3f} "
                                 f"< {RECIPE_MIN_ACC}")
    train_feats = featurizer.transform(train_df)
    t0 = time.perf_counter()
    card = lr.fit(train_feats)
    fit_s = time.perf_counter() - t0
    with default_device("cpu"):
        cpu = lr.fit(train_feats)
    rel_w = _rel(card.weights["w"], cpu.weights["w"])
    rel_b = _rel(card.weights["b"], cpu.weights["b"])
    check(max(rel_w, rel_b) <= LR_CARD_CPU_TOL,
          f"{tag}: LR fit card vs CPU rel err w {rel_w:.4g} b {rel_b:.4g} > "
          f"{LR_CARD_CPU_TOL}")
    print(f"[{tag}] recipe: Pipeline(DeepImageFeaturizer, "
          f"LogisticRegression) fit on {RECIPE_TRAIN} + transform of "
          f"{len(test_df)} images in {recipe_s:.3f}s, held-out accuracy "
          f"{acc:.3f} (min {RECIPE_MIN_ACC}); LR fit on the card "
          f"{fit_s:.3f}s, (w, b) vs the CPU fit rel err {rel_w:.3e}, "
          f"{rel_b:.3e} (tol {LR_CARD_CPU_TOL}); launches {counts}",
          flush=True)
    return dict(
        featurize_img_s=rates["featurize"], predict_img_s=rates["predict"],
        bf16_featurize_img_s=bf16_ips,
        forward_ms=dict(f32_fused_heads=fused_ms, f32_per_branch=plain_ms,
                        tf32=tf32_ms, s2d_stem=s2d_ms, bf16=bf16_ms),
        rel_err=dict(fused_vs_per_branch=rel_fh, s2d_vs_default=rel_s2d,
                     tf32_vs_f32=rel_tf32, bf16_vs_f32=rel_bf16,
                     lr_card_vs_cpu_w=rel_w, lr_card_vs_cpu_b=rel_b),
        recipe_accuracy=acc, recipe_s=recipe_s, lr_fit_s=fit_s,
        launches=counts)


def _keras_layers_for(name, seed):
    """Weighted Keras layers of zoo model ``name`` in Keras layout (the
    committed layer table's names and shapes), with arrays from a numpy
    seed drawn as ``init_weights`` draws the port's: kernels N(0,
    1/fan_in), conv biases N(0, 0.05^2), dense biases 0, BatchNorm scale
    (where the layer has one) and variance U(0.8, 1.2), shift and mean
    N(0, 0.05^2)."""
    from sparkdl_tpu_torch.models import keras_import

    rng = np.random.default_rng(seed)
    layers = []
    for lname, cls, shapes in keras_import.keras_layer_table()[name]:
        if cls == "BatchNormalization":  # [scale,] shift, mean, variance
            arrays = ([rng.uniform(0.8, 1.2, s) for s in shapes[:-3]]
                      + [rng.normal(0, 0.05, s) for s in shapes[-3:-1]]
                      + [rng.uniform(0.8, 1.2, shapes[-1])])
        else:
            kernel = shapes[0]
            arrays = [rng.normal(0, 1 / math.sqrt(np.prod(kernel[:-1])),
                                 kernel)]
            if len(shapes) > 1:
                arrays.append(np.zeros(shapes[1]) if cls == "Dense"
                              else rng.normal(0, 0.05, shapes[1]))
        layers.append(keras_import.KerasLayer(
            lname, cls, [a.astype(np.float32) for a in arrays]))
    return layers


def _engine_captures(eng):
    return eng.metrics.counters.get("engine.graph_captures", 0)


def phase_zoo2(sepconv):
    """[zoo2]: BASELINE config 2's zoo past Xception, at 224x224 through
    the user entry points, on seeded weights: ResNet50 and VGG16 featurize
    (2048-d, 4096-d) and predict with top-5 decode; the card's f32
    features and probabilities (TF32 off) held to the CPU's
    (<= ZOO2_FEATURES_TOL, ZOO2_PROBS_TOL) and the predictor's top-5
    classes equal to the CPU's; cuDNN TF32 and the bf16 engine against f32
    (<= MAIN_PATH_REL_TOL), TF32 also above ZOO2_FEATURES_TOL, so that the
    f32 limit would catch a card path running in TF32; ResNet50 with
    SPARKDL_RN_FUSED_SHORTCUT=1 against the plain route
    (<= ZOO2_FEATURES_TOL), its engine capturing once; EfficientNetB0
    featurize against the CPU (<= ZOO2_FEATURES_TOL); and ResNet50 with
    weights imported from Keras-layout
    arrays through the importer's layer-list entry, card against CPU.  No
    kernel of B1-B3 on any of these paths; every forward on the card is a
    replay of a captured graph."""
    from sparkdl_tpu_torch import default_device
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.models import import_keras_weights, load_model
    from sparkdl_tpu_torch.models.imagenet import decode_predictions
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import named_image as ni

    zero = dict(sepconv=0, sepconv_tiled=0, mbconv=0)
    out = {}

    def graphed(eng, tag):
        check(eng.device.type == "cuda" and eng.capture and eng.graphs(),
              f"[zoo2] {tag}: the engine did not run a captured graph on "
              f"the card")

    def on_cpu(name, featurize, piece):
        with default_device("cpu"):
            return ni._zoo_engine(name, featurize, BATCH)(piece)

    for name in ("ResNet50", "VGG16", "EfficientNetB0"):
        tag = f"zoo2 {name}"
        predict = name != "EfficientNetB0"
        df, feats, counts, rates = featurize_predict(
            name, 224, N_IMAGES, N_PREDICT if predict else 0, sepconv, tag)
        check(counts == zero, f"{tag}: launches {counts}, want none of B1-B3")
        piece = arrowStructsToBatch(df.table.column("image"), 224,
                                    224)[0][:BATCH]
        feng = ni._zoo_engine(name, True, BATCH)
        graphed(feng, tag)
        rec = dict(featurize_img_s=rates["featurize"],
                   predict_img_s=rates["predict"])
        rel_cpu = _rel(feats[:BATCH], on_cpu(name, True, piece))
        check(rel_cpu <= ZOO2_FEATURES_TOL,
              f"{tag}: card vs CPU features rel err {rel_cpu:.4g} > "
              f"{ZOO2_FEATURES_TOL}")
        rec["features_card_vs_cpu"] = rel_cpu
        msg = (f"[{tag}] features {feats.shape[1]}-d, card vs CPU "
               f"||a-b||/||b|| = {rel_cpu:.3e} (tol {ZOO2_FEATURES_TOL})")
        if predict:
            peng = ni._zoo_engine(name, False, BATCH)
            graphed(peng, tag)
            probs = peng(piece)
            cpu_probs = on_cpu(name, False, piece)
            rel_p = _rel(probs, cpu_probs)
            check(rel_p <= ZOO2_PROBS_TOL,
                  f"{tag}: card vs CPU probabilities rel err {rel_p:.4g} > "
                  f"{ZOO2_PROBS_TOL}")
            pred = ni.DeepImagePredictor(
                inputCol="image", outputCol="preds", modelName=name,
                decodePredictions=True, topK=5, batchSize=BATCH)
            reset_counts(sepconv)
            rows = pred.transform(df.limit(BATCH)).table.column(
                "preds").to_pylist()
            check(read_counts(sepconv) == zero, f"{tag}: predictor launches")
            want = decode_predictions(cpu_probs, top=5)
            same = sum([e["class"] for e in r] == [c for c, _, _ in w]
                       for r, w in zip(rows, want))
            check(same == BATCH, f"{tag}: top-5 classes equal the CPU's in "
                                 f"{same} of {BATCH} rows")
            rec["probs_card_vs_cpu"] = rel_p
            msg += (f"; probabilities card vs CPU {rel_p:.3e} (tol "
                    f"{ZOO2_PROBS_TOL}), top-5 classes equal in {same}/{BATCH} "
                    f"rows")
        staged = feng._pad(piece)
        f32_ms = cuda_ms(lambda: feng.run_padded(staged), reps=10)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = feng(piece)
            tf32_ms = cuda_ms(lambda: feng.run_padded(staged), reps=10)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        rel_tf32 = _rel(tf32, feats[:BATCH])
        with env_knobs({"SPARKDL_ZOO_COMPUTE_DTYPE": "bfloat16"}):
            _, bf16, c, r = featurize_predict(name, 224, BATCH, 0, sepconv,
                                              f"{tag} bf16")
            beng = ni._zoo_engine(name, True, BATCH)
            bstaged = beng._pad(piece)
            bf16_ms = cuda_ms(lambda: beng.run_padded(bstaged), reps=10)
        check(c == zero, f"{tag} bf16: launches {c}")
        rel_bf16 = _rel(bf16, feats[:BATCH])
        check(max(rel_tf32, rel_bf16) <= MAIN_PATH_REL_TOL,
              f"{tag}: TF32 vs f32 {rel_tf32:.4g}, bf16 vs f32 "
              f"{rel_bf16:.4g} > {MAIN_PATH_REL_TOL}")
        check(rel_tf32 > ZOO2_FEATURES_TOL,
              f"{tag}: TF32 vs f32 {rel_tf32:.4g} is within the f32 card vs "
              f"CPU limit {ZOO2_FEATURES_TOL}, which then could not tell a "
              f"path in TF32 from one in f32")
        rec.update(tf32_vs_f32=rel_tf32, bf16_vs_f32=rel_bf16,
                   bf16_featurize_img_s=r["featurize"],
                   forward_ms=dict(f32=f32_ms, tf32=tf32_ms, bf16=bf16_ms))
        msg += (f"; TF32 vs f32 {rel_tf32:.3e} (tol {MAIN_PATH_REL_TOL}, "
                f"above the f32 limit {ZOO2_FEATURES_TOL}), bf16 vs f32 "
                f"{rel_bf16:.3e} (tol {MAIN_PATH_REL_TOL}); device forward per batch of "
                f"{BATCH}: f32 {f32_ms:.2f} ms, TF32 {tf32_ms:.2f} ms, bf16 "
                f"{bf16_ms:.2f} ms")
        if name == "ResNet50":
            before = _engine_captures(feng)
            with env_knobs({"SPARKDL_RN_FUSED_SHORTCUT": "1"}):
                _, fsc, c, _ = featurize_predict(name, 224, BATCH, 0, sepconv,
                                                 f"{tag} fsc")
                seng = ni._zoo_engine(name, True, BATCH)
                sstaged = seng._pad(piece)
                fsc_ms = cuda_ms(lambda: seng.run_padded(sstaged), reps=10)
            check(c == zero, f"{tag} fsc: launches {c}")
            check(seng is not feng and _engine_captures(seng) == 1
                  and _engine_captures(feng) == before,
                  f"{tag} fsc: captures {_engine_captures(seng)} on its "
                  f"engine, {_engine_captures(feng) - before} new on the "
                  f"plain one; want 1 and 0")
            rel_fsc = _rel(fsc, feats[:BATCH])
            check(rel_fsc <= ZOO2_FEATURES_TOL,
                  f"{tag}: fused shortcut vs plain {rel_fsc:.4g} > "
                  f"{ZOO2_FEATURES_TOL}")
            rec.update(fsc_vs_plain=rel_fsc)
            rec["forward_ms"]["fsc"] = fsc_ms
            msg += (f"; SPARKDL_RN_FUSED_SHORTCUT=1 vs plain {rel_fsc:.3e} "
                    f"(tol {ZOO2_FEATURES_TOL}), one new capture, f32 fsc "
                    f"{fsc_ms:.2f} ms")
        print(f"{msg}; launches {counts}", flush=True)
        out[name] = rec

    # weights imported from Keras-layout arrays (the layer-list entry the
    # file readers feed), then the same model on the card and on the CPU
    tag = "zoo2 import"
    layers = _keras_layers_for("ResNet50", SEED + 23)
    sd = import_keras_weights("ResNet50", layers)
    model = load_model("ResNet50")
    model.load_state_dict(sd)
    kernel = layers[0].weights[0]
    check(torch.equal(model.conv1_conv.weight,
                      torch.from_numpy(kernel).permute(3, 2, 0, 1)),
          f"{tag}: conv1_conv is not the Keras kernel transposed")
    fn = ni.zoo_model_fn("ResNet50", True)
    card = InferenceEngine(fn, model, device="cuda", device_batch_size=BATCH)
    cpu = InferenceEngine(fn, model, device="cpu", device_batch_size=BATCH)
    batch = arrowStructsToBatch(synthetic_frame(BATCH, 224, SEED).table.column(
        "image"), 224, 224)[0]
    reset_counts(sepconv)
    got = card(batch)
    check(read_counts(sepconv) == zero, f"{tag}: launches")
    graphed(card, tag)
    rel_imp = _rel(got, cpu(batch))
    seeded = ni._zoo_engine("ResNet50", True, BATCH)(batch)
    check(rel_imp <= ZOO2_FEATURES_TOL and _rel(got, seeded) > 0.1,
          f"{tag}: card vs CPU {rel_imp:.4g} (tol {ZOO2_FEATURES_TOL}); vs the "
          f"seeded weights {_rel(got, seeded):.4g} (want > 0.1)")
    print(f"[{tag}] ResNet50 from {len(layers)} Keras-layout layers through "
          f"import_keras_weights: card vs CPU features ||a-b||/||b|| = "
          f"{rel_imp:.3e} (tol {ZOO2_FEATURES_TOL}); differs from the seeded "
          f"weights' ({_rel(got, seeded):.3f})", flush=True)
    out["import_card_vs_cpu"] = rel_imp
    return out


# -- [keras]: BASELINE configs 3 and 4 with a user's Keras InceptionV3 ----------
KERAS_CONFIG = os.path.join("sparkdl_tpu_torch", "graph", "data",
                            "keras_inception_v3.json")
# f32 limits, under TF32's reading (2.3e-5) and above the sound runs'
# (9.0e-8 card vs CPU, 5.4e-8 converted vs zoo): a TF32 path fails them
KERAS_ZOO_TOL = 1e-6            # converted vs zoo InceptionV3 probabilities
KERAS_CARD_CPU_TOL = 1e-6       # converted model, card vs CPU, f32
KERAS_UDF_TOL = 1e-6            # the UDF vs the converted model on its batch
KERAS_N_FILES = 69              # JPEGs beside one garbage .jpg


def load_inception_v3(uri):
    """The user's image loader of config 3 (the reference README's
    ``loadAndPreprocessKerasInceptionV3``): PIL decode, resize to 299x299,
    Keras' "tf" preprocess (x / 127.5 - 1).  Module-level, so that a stage
    holding it saves."""
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize((299, 299), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 127.5 - 1.0


def inception_preprocess(x):
    """The image UDF's preprocessor: Keras' "tf" mode on the card."""
    return x / 127.5 - 1.0


def _as_bf16(fn):
    def bf16_fn(m, x):
        return fn(m, x.to(torch.bfloat16))

    return bf16_fn


def _zoo_probs(m, x):
    return m(x, features=False)


def _mlp_config():
    """A small Sequential MLP's Keras model config (Keras 3's form): the
    model a KerasTransformer user saves."""
    def dense(name, units, act):
        return {"class_name": "Dense", "config": {
            "name": name, "units": units, "activation": act,
            "use_bias": True}}

    return {"class_name": "Sequential", "config": {"name": "mlp", "layers": [
        {"class_name": "InputLayer", "config": {"name": "features",
                                                "batch_shape": [None, 64]}},
        dense("hidden", 128, "relu"), dense("out", 10, "softmax")]}}


def _two_io_config():
    """A two-input, two-output functional config (Keras 2's node form)."""
    def layer(cls, name, cfg, *inputs):
        return {"class_name": cls, "name": name,
                "config": dict(cfg, name=name),
                "inbound_nodes": ([[[i, 0, 0, {}] for i in inputs]]
                                  if inputs else [])}

    return {"class_name": "Functional", "config": {"name": "two", "layers": [
        layer("InputLayer", "a", {"batch_input_shape": [None, 48]}),
        layer("InputLayer", "b", {"batch_input_shape": [None, 48]}),
        layer("Concatenate", "ab", {"axis": -1}, "a", "b"),
        layer("Dense", "score", {"units": 16, "activation": "tanh"}, "ab"),
        layer("Subtract", "gap", {}, "a", "b")],
        "input_layers": [["a", 0, 0], ["b", 0, 0]],
        "output_layers": [["score", 0, 0], ["gap", 0, 0]]}}


def _seeded_arrays(module, seed):
    """Keras-layout arrays for every weighted layer of a converted module
    (dense kernels N(0, 1/fan_in), biases N(0, 0.05^2))."""
    from sparkdl_tpu_torch.graph.keras_convert import layer_key

    rng = np.random.default_rng(seed)
    layers = []
    for name, node in module.weighted_nodes().items():
        w = module.layers[layer_key(name)].weight
        fan_in, units = w.shape[1], w.shape[0]
        layers.append((name, node.op, [
            rng.normal(0, 1 / math.sqrt(fan_in), (fan_in, units)).astype(
                np.float32),
            rng.normal(0, 0.05, units).astype(np.float32)]))
    return layers


def _keras_files(tmp):
    """KERAS_N_FILES PIL-written JPEGs of assorted sizes and one garbage
    .jpg; returns the sorted paths."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 29)
    for i in range(KERAS_N_FILES):
        h, w = (int(v) for v in rng.integers(240, 400, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(tmp, f"img_{i:03d}.jpg"), quality=90)
    with open(os.path.join(tmp, "img_040_garbage.jpg"), "wb") as f:
        f.write(b"this is not a jpeg")
    return sorted(os.path.join(tmp, n) for n in os.listdir(tmp))


def phase_keras(sepconv):
    """[keras]: BASELINE configs 3 and 4 with a user's Keras InceptionV3 at
    299x299, batch 32, converted without Keras from the committed model
    config and seeded Keras-layout arrays (an in-memory KerasFile: the
    user's model object).  f32 with TF32 off unless said; B1-B3 must not
    launch.

      1. the converted model against the zoo InceptionV3 (per-branch
         route) imported from the same arrays, both through
         InferenceEngine on one preprocessed batch: probabilities within
         KERAS_ZOO_TOL, top-5 equal in every row; card vs CPU within
         KERAS_CARD_CPU_TOL; TF32 and the bf16 engine within
         MAIN_PATH_REL_TOL of f32, TF32 also above both f32 limits, so
         that they tell a TF32 path; graphed == eager bit for bit; one
         capture per weight edit;
      2. KerasImageFileTransformer (config 3) over KERAS_N_FILES JPEGs and
         a garbage .jpg through a module-level loader: two full batches and
         a ragged tail, a null row for the garbage file, outputs equal to
         the converted engine's on the same loaded arrays, pipelined ==
         serial bit for bit, img/s;
      3. registerKerasImageUDF("inceptionV3_udf", kfile) (config 4)
         through udf_registry.apply over readImages of the same directory
         resized to 299 by createResizeImageUDF: within KERAS_UDF_TOL of
         the converted model on the same decoded RGB batch, null rows
         null, img/s;
      4. KerasTransformer on a Sequential MLP config and TFTransformer on
         a two-input, two-output config, each equal to the same stage on
         the CPU (within 1e-5);
      5. save/load of an ImageFileTransformer holding the converted model:
         the reloaded stage's output bit-identical;
      6. device ms per graphed forward (f32, TF32, bf16) beside the zoo's
         per-branch route, launches per replay, host us per dispatch, the
         graph pool."""
    import tempfile

    from sparkdl_tpu_torch import default_device
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.graph.keras_convert import KerasModel
    from sparkdl_tpu_torch.image.io import (arrowStructsToBatch,
                                            createResizeImageUDF, readImages)
    from sparkdl_tpu_torch.models import import_keras_weights, load_model
    from sparkdl_tpu_torch.models import keras_import
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import (ImageFileTransformer,
                                                KerasImageFileTransformer,
                                                KerasTransformer,
                                                TFTransformer)
    from sparkdl_tpu_torch.udf import registerKerasImageUDF, udf_registry

    tag = "keras"
    zero = dict(sepconv=0, sepconv_tiled=0, mbconv=0)
    with open(KERAS_CONFIG) as f:
        config = json.load(f)
    layers = _keras_layers_for("InceptionV3", SEED + 31)
    kfile = keras_import.keras_file(config, layers)
    t0 = time.perf_counter()
    mf = ModelFunction.from_keras(kfile)
    convert_s = time.perf_counter() - t0
    check(mf.module.input_shapes == {"input_layer": [None, 299, 299, 3]}
          and tuple(mf.output_names) == ("predictions",),
          f"[{tag}] converted model's inputs {mf.module.input_shapes}, "
          f"outputs {mf.output_names}")
    zoo = load_model("InceptionV3")
    zoo.load_state_dict(import_keras_weights("InceptionV3", layers))
    zoo.fused_inference = False  # the per-branch route: the same ops
    rng = np.random.default_rng(SEED + 37)
    x8 = rng.integers(0, 256, (BATCH, 299, 299, 3), dtype=np.uint8)
    xf = x8.astype(np.float32) / 127.5 - 1.0

    # 1. the converted model against the zoo, card against CPU
    reset_counts(sepconv)  # read at the phase's end: none of B1-B3 runs
    eng = InferenceEngine(mf.fn, mf.module, device="cuda",
                          device_batch_size=BATCH)
    zeng = InferenceEngine(_zoo_probs, zoo, device="cuda",
                           device_batch_size=BATCH)
    probs = eng(xf)
    zprobs = zeng(xf)
    torch.cuda.synchronize()
    check(read_counts(sepconv) == zero, f"[{tag}] launches "
                                        f"{read_counts(sepconv)}")
    check(eng.capture and len(eng.graphs()) == 1 and zeng.graphs(),
          f"[{tag}] the engines did not run captured graphs")
    check(probs.shape == (BATCH, 1000) and np.isfinite(probs).all(),
          f"[{tag}] probabilities {probs.shape}, finite "
          f"{np.isfinite(probs).all()}")
    rel_zoo = _rel(probs, zprobs)
    top5 = np.argsort(-probs, 1)[:, :5]
    ztop5 = np.argsort(-zprobs, 1)[:, :5]
    same5 = int((top5 == ztop5).all(1).sum())
    check(rel_zoo <= KERAS_ZOO_TOL and same5 == BATCH,
          f"[{tag}] converted vs zoo InceptionV3: rel err {rel_zoo:.4g} "
          f"(tol {KERAS_ZOO_TOL}), top-5 equal in {same5}/{BATCH} rows")
    with default_device("cpu"):
        cpu = InferenceEngine(mf.fn, mf.module, device="cpu",
                              device_batch_size=BATCH)(xf)
    rel_cpu = _rel(probs, cpu)
    check(rel_cpu <= KERAS_CARD_CPU_TOL,
          f"[{tag}] card vs CPU rel err {rel_cpu:.4g} > {KERAS_CARD_CPU_TOL}")

    staged = eng._pad(xf)
    eng.capture = False
    eager = eng.run_padded(staged)
    eng.capture = True
    graphed = eng.run_padded(staged)
    torch.cuda.synchronize()
    check(torch.equal(graphed, eager), f"[{tag}] graphed forward differs "
                                       f"from the eager forward")
    captures = _engine_captures(eng)
    bn = dict(eng.module.named_buffers())[
        "layers.batch_normalization_50.running_var"]
    saved = bn.clone()
    with torch.no_grad():
        bn.mul_(0.5)
    edited = eng.run_padded(staged)
    eng.capture = False
    edited_eager = eng.run_padded(staged)
    eng.capture = True
    with torch.no_grad():
        bn.copy_(saved)
    back = eng.run_padded(staged)
    torch.cuda.synchronize()
    check(_engine_captures(eng) - captures == 2
          and torch.equal(edited, edited_eager)
          and not torch.equal(edited, graphed) and torch.equal(back, graphed),
          f"[{tag}] weight edit: {_engine_captures(eng) - captures} captures "
          f"for one edit and its undo (want 2), edited graphed == eager "
          f"{torch.equal(edited, edited_eager)}, restored == first "
          f"{torch.equal(back, graphed)}")

    zstaged = zeng._pad(xf)
    g = next(iter(eng._core.graphs.values()))
    zg = next(iter(zeng._core.graphs.values()))
    eng.metrics.timings_s.pop("engine.replay_host", None)
    ms = dict(f32=cuda_ms(lambda: eng.run_padded(staged), reps=10),
              zoo_f32=cuda_ms(lambda: zeng.run_padded(zstaged), reps=10),
              replay_f32=cuda_ms(g.graph.replay, reps=10),
              zoo_replay_f32=cuda_ms(zg.graph.replay, reps=10))
    host_us = eng.metrics.percentile("engine.replay_host", 50) * 1e6
    nodes, zoo_nodes = (graph_kernel_nodes(x.graph)[0] for x in (g, zg))
    prof_total, zprof_total = (profiled_kernels(x.graph.replay)[0]
                               for x in (g, zg))
    pool = eng.graph_pool_bytes  # the engine's one pool, all its captures
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = eng(xf)
        ms["tf32"] = cuda_ms(lambda: eng.run_padded(staged), reps=10)
        zeng(xf)
        ms["zoo_tf32"] = cuda_ms(lambda: zeng.run_padded(zstaged), reps=10)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    beng = InferenceEngine(_as_bf16(mf.fn), mf.module, device="cuda",
                           device_batch_size=BATCH,
                           compute_dtype=torch.bfloat16,
                           output_host_dtype=np.float32)
    zbeng = InferenceEngine(_as_bf16(_zoo_probs), zoo, device="cuda",
                            device_batch_size=BATCH,
                            compute_dtype=torch.bfloat16,
                            output_host_dtype=np.float32)
    bf16 = beng(xf)
    zbeng(xf)
    bstaged, zbstaged = beng._pad(xf), zbeng._pad(xf)
    ms["bf16"] = cuda_ms(lambda: beng.run_padded(bstaged), reps=10)
    ms["zoo_bf16"] = cuda_ms(lambda: zbeng.run_padded(zbstaged), reps=10)
    del zeng, beng, zbeng, zg  # their graphs' pools: not used again
    gc.collect()
    torch.cuda.empty_cache()
    rel_tf32, rel_bf16 = _rel(tf32, probs), _rel(bf16, probs)
    check(max(rel_tf32, rel_bf16) <= MAIN_PATH_REL_TOL,
          f"[{tag}] TF32 vs f32 {rel_tf32:.4g}, bf16 vs f32 {rel_bf16:.4g} > "
          f"{MAIN_PATH_REL_TOL}")
    check(rel_tf32 > max(KERAS_ZOO_TOL, KERAS_CARD_CPU_TOL),
          f"[{tag}] TF32 vs f32 reads {rel_tf32:.4g}, within the f32 limits "
          f"({KERAS_ZOO_TOL}, {KERAS_CARD_CPU_TOL}): they cannot tell a TF32 "
          f"path")
    print(f"[{tag}] converted InceptionV3 (committed config, "
          f"{len(layers)} weighted layers from seeded Keras-layout arrays, "
          f"converted in {convert_s:.2f}s) vs the zoo's per-branch route on "
          f"the same arrays, 299x299 batch {BATCH}: ||a-b||/||b|| = "
          f"{rel_zoo:.3e} (tol {KERAS_ZOO_TOL}), top-5 equal {same5}/{BATCH}; "
          f"card vs CPU {rel_cpu:.3e} (tol {KERAS_CARD_CPU_TOL}); TF32 vs f32 "
          f"{rel_tf32:.3e} (above the f32 limits), bf16 vs f32 {rel_bf16:.3e} "
          f"(tol {MAIN_PATH_REL_TOL}); graphed == eager bit for bit, one capture "
          f"per weight edit; device ms per forward (upload of the f32 batch "
          f"included) converted / zoo: f32 {ms['f32']:.2f} / "
          f"{ms['zoo_f32']:.2f}, TF32 {ms['tf32']:.2f} / {ms['zoo_tf32']:.2f},"
          f" bf16 {ms['bf16']:.2f} / {ms['zoo_bf16']:.2f}; replay alone f32 "
          f"{ms['replay_f32']:.2f} / {ms['zoo_replay_f32']:.2f}; kernel "
          f"nodes per graph {nodes} / {zoo_nodes} (profiler, one replay: "
          f"{prof_total} / {zprof_total}); host us per dispatch "
          f"{host_us:.1f}; graph pool {pool / 2**20:.1f} MiB", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        paths = _keras_files(img_dir)
        bad = paths.index(os.path.join(img_dir, "img_040_garbage.jpg"))

        # 2. config 3: KerasImageFileTransformer
        uris = DataFrame({"uri": paths})
        stage = KerasImageFileTransformer(
            inputCol="uri", outputCol="preds", modelFile=kfile,
            imageLoader=load_inception_v3, batchSize=BATCH)
        stage.transform(uris.limit(BATCH))  # warm: conversion, engine, graph
        runs = {}
        for mode in ("1", "0", "1"):
            with env_knobs({"SPARKDL_PIPELINE": mode}):
                t0 = time.perf_counter()
                out = stage.transform(uris).table.column("preds").to_pylist()
                runs.setdefault(mode, []).append(
                    (len(paths) / (time.perf_counter() - t0), out))
        check(read_counts(sepconv) == zero, f"[{tag}] launches "
                                            f"{read_counts(sepconv)}")
        piped = runs["1"][0][1]
        check(all(r[1] == piped for r in runs["1"] + runs["0"]),
              f"[{tag}] config 3: pipelined and serial outputs differ")
        check([i for i, r in enumerate(piped) if r is None] == [bad],
              f"[{tag}] config 3: null rows "
              f"{[i for i, r in enumerate(piped) if r is None]}, want [{bad}]")
        loaded = np.stack([load_inception_v3(p) for i, p in enumerate(paths)
                           if i != bad])
        want = eng(loaded)
        got = np.asarray([r for r in piped if r is not None], np.float32)
        check(got.shape == (KERAS_N_FILES, 1000) and np.array_equal(got, want),
              f"[{tag}] config 3 outputs differ from the converted engine's "
              f"on the same arrays (max abs {np.abs(got - want).max():.3g})")
        ips3 = {m: max(r[0] for r in runs[m]) for m in runs}
        del stage
        print(f"[{tag}] KerasImageFileTransformer (config 3), {len(paths)} "
              f"files ({KERAS_N_FILES} JPEGs + 1 garbage) at 299x299, batch "
              f"{BATCH} (2 full batches + a tail of "
              f"{KERAS_N_FILES - 2 * BATCH}): garbage row null, outputs == "
              f"the converted engine's on the loaded arrays, pipelined == "
              f"serial bit for bit; img/s pipelined {ips3['1']:.1f}, serial "
              f"{ips3['0']:.1f}", flush=True)

        # 3. config 4: registerKerasImageUDF
        images = readImages(img_dir)
        resize = createResizeImageUDF([299, 299])
        images = images.map_rows(lambda r: {"image": resize(r["image"])})
        registerKerasImageUDF("inceptionV3_udf", kfile,
                              preprocessor=inception_preprocess)
        udf_registry.apply("inceptionV3_udf", images.limit(BATCH), "image",
                           "p")  # warm
        t0 = time.perf_counter()
        scored = udf_registry.apply("inceptionV3_udf", images, "image",
                                    "preds")
        udf_s = time.perf_counter() - t0
        check(read_counts(sepconv) == zero, f"[{tag}] launches "
                                            f"{read_counts(sepconv)}")
        rows = scored.table.column("preds").to_pylist()
        check([i for i, r in enumerate(rows) if r is None] == [bad],
              f"[{tag}] config 4: null rows "
              f"{[i for i, r in enumerate(rows) if r is None]}, want [{bad}]")
        rgb, ok = arrowStructsToBatch(images.table.column("image"), 299, 299,
                                      compact=True)
        uwant = eng(rgb.astype(np.float32) / 127.5 - 1.0)
        ugot = np.asarray([r for r in rows if r is not None], np.float32)
        rel_udf = _rel(ugot, uwant)
        check(rel_udf <= KERAS_UDF_TOL, f"[{tag}] config 4 UDF vs the "
                                        f"converted model rel err "
                                        f"{rel_udf:.4g} > {KERAS_UDF_TOL}")
        ips4 = KERAS_N_FILES / udf_s
        print(f"[{tag}] registerKerasImageUDF('inceptionV3_udf') (config 4) "
              f"over readImages + createResizeImageUDF(299): {len(rows)} "
              f"rows, garbage row null, vs the converted model on the same "
              f"decoded RGB batch ||a-b||/||b|| = {rel_udf:.3e} (tol "
              f"{KERAS_UDF_TOL}); {ips4:.1f} img/s", flush=True)

        # 4. KerasTransformer and TFTransformer, card against CPU
        mlp = keras_import.keras_file(_mlp_config(), _seeded_arrays(
            KerasModel(_mlp_config()), SEED + 41))
        two = ModelFunction.from_keras(keras_import.keras_file(
            _two_io_config(), _seeded_arrays(KerasModel(_two_io_config()),
                                             SEED + 43)))
        vecs = np.random.default_rng(SEED + 47).normal(size=(100, 64))
        cols = DataFrame({"features": [list(r) for r in vecs],
                          "a": [list(r[:48]) for r in vecs],
                          "b": [list(r[16:]) for r in vecs]})

        def tensor_stages():
            k = KerasTransformer(inputCol="features", outputCol="k",
                                 modelFile=mlp, batchSize=BATCH)
            t = TFTransformer(modelFunction=two,
                              inputMapping={"a": "a", "b": "b"},
                              outputMapping={"score": "s", "gap": "g"},
                              batchSize=BATCH)
            out = t.transform(k.transform(cols))
            return {c: out.column_to_numpy(c) for c in ("k", "s", "g")}

        card_t = tensor_stages()
        with default_device("cpu"):
            cpu_t = tensor_stages()
        rel_t = {c: _rel(card_t[c], cpu_t[c]) for c in card_t}
        check(max(rel_t.values()) <= 1e-5,
              f"[{tag}] tensor stages card vs CPU {rel_t}")
        print(f"[{tag}] KerasTransformer (Sequential MLP 64-128-10) and "
              f"TFTransformer (two inputs, two outputs) over 100 rows: card "
              f"vs CPU {', '.join(f'{c} {v:.2e}' for c, v in rel_t.items())} "
              f"(tol 1e-5)", flush=True)

        # 5. save/load of a stage holding the converted model
        holder = ImageFileTransformer(
            inputCol="uri", outputCol="preds", modelFunction=mf,
            imageLoader=load_inception_v3, batchSize=BATCH)
        sample = uris.limit(BATCH + 3)
        before = holder.transform(sample).table.column("preds").to_pylist()
        t0 = time.perf_counter()
        holder.save(os.path.join(tmp, "stage"))
        reloaded = ImageFileTransformer.load(os.path.join(tmp, "stage"))
        io_s = time.perf_counter() - t0
        after = reloaded.transform(sample).table.column("preds").to_pylist()
        check(after == before, f"[{tag}] reloaded stage's output differs")
        print(f"[{tag}] ImageFileTransformer holding the converted model: "
              f"save + load {io_s:.2f}s, output of {len(sample)} rows "
              f"bit-identical after the round trip", flush=True)
    counts = read_counts(sepconv)
    check(counts == zero, f"[{tag}] launches {counts}, want none of B1-B3")

    return dict(
        forward_ms=ms, launches_per_replay=nodes,
        zoo_launches_per_replay=zoo_nodes,
        profiler_launches_per_replay=[prof_total, zprof_total],
        host_us_per_dispatch=host_us,
        graph_pool_bytes=pool, convert_s=convert_s,
        rel_err=dict(converted_vs_zoo=rel_zoo, card_vs_cpu=rel_cpu,
                     tf32_vs_f32=rel_tf32, bf16_vs_f32=rel_bf16,
                     udf_vs_converted=rel_udf, tensor_stages=rel_t),
        top5_equal_rows=same5,
        config3_img_s=dict(pipelined=ips3["1"], serial=ips3["0"]),
        config4_img_s=ips4, save_load_s=io_s, launches=counts)


TUNING_PER_CLASS = 24          # 48 tinted JPEGs, two classes
TUNING_BATCH = 16
TUNING_BASES = [(200, 70, 60), (60, 80, 200)]
# the small CNN's classes are closer, so that its grid points score apart
TUNING_CNN_BASES = [(132, 120, 112), (112, 120, 132)]
TUNING_CNN_SIZE = 32
# card vs CPU, f32 with TF32 off: the full-width fit's limits lie under
# TF32's readings (2.8e-6, 8.3e-4) and above the f32 runs' (1.3e-8,
# 1.5e-5 on an H100; PERF.md), and the same fit with TF32 on must fail them;
# the others lie 20-50x above their f32 readings
TUNING_LOSS_TOL = 1e-6          # per-step losses of one full-width SGD fit
TUNING_UPDATE_TOL = 2e-4        # its fitted tensors: ||d_card - d_cpu|| /
#                                 ||d_cpu||, d the update of every tensor
TUNING_CNN_LOSS_TOL = 1e-6      # the small CNN's per-epoch losses
TUNING_CNN_OUT_TOL = 1e-6       # the small CNN's best model outputs
TUNING_STATS_TOL = 1e-5         # ResNet50's running statistics' move
TUNING_STATS_F64_RATIO = 4.0    # the card's distance from a float64 fit
#                                 over the CPU float32 fit's (ResNet50)


def load_small(uri):
    """The small CNN's image loader: PIL decode, resize to 32x32, x / 127.5
    - 1.  Module-level, so that a fitted model holding it saves."""
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize(
        (TUNING_CNN_SIZE, TUNING_CNN_SIZE), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 127.5 - 1.0


def load_resnet(uri):
    """ResNet50's loader for the trainBatchStats fit: 224x224, caffe's
    BGR mean subtraction (the zoo's ResNet50 preprocess)."""
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize((224, 224), Image.BILINEAR)
    bgr = np.asarray(img, dtype=np.float32)[..., ::-1]
    return bgr - np.asarray([103.939, 116.779, 123.68], np.float32)


def _tuning_files(tmp, bases=TUNING_BASES, noise=50.0, seed=SEED + 53):
    """TUNING_PER_CLASS tinted JPEGs of each class of ``bases`` (sizes
    300-400, clip(base + N(0, noise^2)) per pixel), in a seeded order;
    returns (paths, labels)."""
    from PIL import Image

    os.makedirs(tmp)
    rng = np.random.default_rng(seed)
    labels = rng.permutation(np.repeat(np.arange(2), TUNING_PER_CLASS))
    paths = []
    for i, k in enumerate(labels):
        h, w = (int(v) for v in rng.integers(300, 400, 2))
        img = np.clip(np.asarray(bases[k], np.float32)
                      + rng.normal(0, noise, (h, w, 3)), 0, 255)
        p = os.path.join(tmp, f"img_{i:03d}.jpg")
        Image.fromarray(img.astype(np.uint8)).save(p, quality=90)
        paths.append(p)
    return paths, [int(k) for k in labels]


def _cnn_config():
    """A small Keras CNN's model config (Keras 3's Sequential form): two
    Conv2D + BatchNormalization, Dropout, MaxPooling2D,
    GlobalAveragePooling2D, a softmax Dense over the two classes."""
    def layer(cls, name, **cfg):
        return {"class_name": cls, "config": dict(cfg, name=name)}

    return {"class_name": "Sequential", "config": {"name": "cnn", "layers": [
        layer("InputLayer", "image", batch_shape=[
            None, TUNING_CNN_SIZE, TUNING_CNN_SIZE, 3]),
        layer("Conv2D", "conv1", filters=16, kernel_size=[3, 3],
              padding="same", activation="relu", use_bias=True),
        layer("BatchNormalization", "bn1", axis=-1, epsilon=1e-3),
        layer("Dropout", "drop", rate=0.25),
        layer("MaxPooling2D", "pool", pool_size=[2, 2]),
        layer("Conv2D", "conv2", filters=32, kernel_size=[3, 3],
              padding="same", activation="relu", use_bias=True),
        layer("BatchNormalization", "bn2", axis=-1, epsilon=1e-3),
        layer("GlobalAveragePooling2D", "gap"),
        layer("Dense", "out", units=2, activation="softmax",
              use_bias=True)]}}


def _seeded_cnn_arrays(module, seed):
    """Keras-layout arrays for every weighted layer of the converted CNN:
    kernels N(0, 1/fan_in) (HWIO, dense [in, out]), biases N(0, 0.05^2),
    BatchNorm gamma and variance U(0.8, 1.2), beta and mean N(0, 0.1^2)."""
    from sparkdl_tpu_torch.graph.keras_convert import layer_key

    rng = np.random.default_rng(seed)
    layers = []
    for name, node in module.weighted_nodes().items():
        m = module.layers[layer_key(name)]
        if node.op == "BatchNormalization":
            c = m.running_mean.shape[0]
            arrays = [rng.uniform(0.8, 1.2, c), rng.normal(0, 0.1, c),
                      rng.normal(0, 0.1, c), rng.uniform(0.8, 1.2, c)]
        else:
            w = m.weight
            shape = (tuple(w.shape[2:]) + (w.shape[1], w.shape[0])
                     if w.dim() == 4 else (w.shape[1], w.shape[0]))
            fan_in = int(np.prod(shape[:-1]))
            arrays = [rng.normal(0, 1 / math.sqrt(fan_in), shape),
                      rng.normal(0, 0.05, shape[-1])]
        layers.append((name, node.op, [a.astype(np.float32)
                                       for a in arrays]))
    return layers


class _FitLog:
    """Records every fit of the estimators while it is entered: the
    per-epoch losses, each epoch's per-step losses, the images each fit
    stepped over, its seconds (the card synchronised on both ends) and
    its step mode.  Instrumentation of this script: it wraps
    ``fit_data_parallel`` where the image-file estimator calls it and the
    train module's ``_StepRunner.run_epoch``."""

    def __enter__(self):
        from sparkdl_tpu_torch.estimators import image_file_estimator as ife
        from sparkdl_tpu_torch.parallel import train

        self.fits = []
        self._saved = (ife.fit_data_parallel, train._StepRunner.run_epoch)
        fit, grouped = self._saved

        def logged_fit(fn, params, x, y, **kw):
            rec = dict(steps=[], batch=min(int(kw.get("batch_size", 32)),
                                           x.shape[0]))
            self.fits.append(rec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fit(fn, params, x, y, **kw)
            torch.cuda.synchronize()
            rec.update(seconds=time.perf_counter() - t0, losses=out[1],
                       images=rec["batch"] * sum(map(len, rec["steps"])))
            return out

        def logged_steps(runner, batches):
            losses = grouped(runner, batches)
            self.fits[-1]["steps"].append(list(losses))
            self.fits[-1]["mode"] = runner.mode
            return losses

        ife.fit_data_parallel = logged_fit
        train._StepRunner.run_epoch = logged_steps
        return self

    def __exit__(self, *exc):
        from sparkdl_tpu_torch.estimators import image_file_estimator as ife
        from sparkdl_tpu_torch.parallel import train

        ife.fit_data_parallel, train._StepRunner.run_epoch = self._saved


class _CaptureCount:
    """Counts engine captures while entered (wraps the engine's capture)."""

    def __enter__(self):
        from sparkdl_tpu_torch.parallel.engine import InferenceEngine

        self.n = 0
        self._saved = InferenceEngine._capture_locked
        saved = self._saved

        def counted(eng, *a, **k):
            self.n += 1
            return saved(eng, *a, **k)

        InferenceEngine._capture_locked = counted
        return self

    def __exit__(self, *exc):
        from sparkdl_tpu_torch.parallel.engine import InferenceEngine

        InferenceEngine._capture_locked = self._saved


def _model_engine(model):
    """The engine a fitted ImageFileModel's transform runs (cached on the
    model's transformer)."""
    t = model.__dict__["_transformer_cache"][1]
    (entry,) = t.__dict__["_engine_cache"].values()
    return entry[1]


def pool_line(tag):
    """Print and return the graph pool bytes held after a phase: every
    live engine's, and the zoo engine cache's share and bound."""
    from sparkdl_tpu_torch.parallel.engine import graph_pool_bytes_held
    from sparkdl_tpu_torch.transformers import named_image as ni

    gc.collect()
    held = graph_pool_bytes_held()
    cache = ni._ENGINE_CACHE
    cache.reaccount()
    out = dict(held_bytes=held, zoo_cache_bytes=cache.total_bytes,
               zoo_cache_engines=len(cache),
               zoo_cache_cap_bytes=cache.cap_bytes,
               reserved_bytes=torch.cuda.memory_reserved())
    print(f"[pool] after {tag}: graph pools held by live engines "
          f"{held / 2**20:.1f} MiB; zoo engine cache {len(cache)} engines, "
          f"{cache.total_bytes / 2**20:.1f} MiB of its "
          f"{cache.cap_bytes / 2**20:.0f} MiB bound; card memory reserved "
          f"{out['reserved_bytes'] / 2**30:.2f} GiB", flush=True)
    return out


def _update_rel(fitted, card, init):
    """||d_card - d_cpu|| / ||d_cpu|| over every tensor, d = fitted -
    init (the fit's update; the tensors themselves agree far closer)."""
    num = sum(float(((card[k].double() - fitted[k].double()) ** 2).sum())
              for k in fitted)
    den = sum(float(((fitted[k].double() - init[k].double()) ** 2).sum())
              for k in fitted)
    return math.sqrt(num / den)


def phase_tuning(sepconv):
    """[tuning]: BASELINE config 5.  A user's Keras InceptionV3 (the
    committed config with seeded Keras-layout arrays, the in-memory
    KerasFile of [keras]) at 299x299 is fine-tuned by
    KerasImageFileEstimator over 48 tinted JPEGs of two classes (one-hot
    over the 1000 outputs, categorical_crossentropy, batch 16) and tuned by
    CrossValidator(numFolds=3) over the grid optimizer {adam, sgd} x
    fitParams {1 epoch, 2 epochs} with MulticlassClassificationEvaluator.
    f32 with TF32 off unless said; B1-B3 must not launch.

      1. the CV run: 13 fits with finite losses, 4 avgMetrics, the best
         model transforms; the graph pool bytes held after it no more
         than after the first fitted model's transform plus one model's
         pool; wall time, fit img/s, eval img/s, captures;
      2. one SGD fit of the same model, 1 epoch of 2 steps, card against
         CPU from the same tensors and batches: per-step losses within
         TUNING_LOSS_TOL, the fitted tensors' update within
         TUNING_UPDATE_TOL; with TF32 on both must read above them;
      3. a small Keras CNN (_cnn_config) tuned over the same grid and
         folds on the card and on the CPU: equal avgMetrics and best index,
         per-epoch losses within TUNING_CNN_LOSS_TOL, the best model's
         outputs within TUNING_CNN_OUT_TOL;
      4. trainBatchStats=True on the zoo's ResNet50 (from_module): one
         SGD step of 8 images, its updated running statistics card vs CPU
         within TUNING_STATS_TOL (relative to their move); the
         parameters' update after one step and the statistics' after two
         on the card no further from the CPU's float64 fit than
         TUNING_STATS_F64_RATIO times the CPU's float32 fit;
      5. the CV model saved and loaded transforms bit for bit;
      6. a 2-epoch SGD fit interrupted after epoch 1 (checkpoint_dir)
         resumes to the uninterrupted fit within TUNING_UPDATE_TOL."""
    import tempfile

    from sparkdl_tpu_torch import default_device
    from sparkdl_tpu_torch.estimators import (CrossValidator,
                                              CrossValidatorModel,
                                              ImageFileEstimator,
                                              ImageFileModel,
                                              KerasImageFileEstimator,
                                              MulticlassClassificationEvaluator,
                                              ParamGridBuilder)
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.graph.keras_convert import KerasModel
    from sparkdl_tpu_torch.models import keras_import, load_model
    from sparkdl_tpu_torch.parallel.engine import graph_pool_bytes_held

    tag = "tuning"
    zero = dict(sepconv=0, sepconv_tiled=0, mbconv=0)
    out = {}
    problems = []

    def expect(cond, msg):
        """A failed check is printed at once and fails the phase at its
        end, so that one run reads every section's numbers."""
        if not cond:
            print(f"FAIL (at the phase's end): {msg}", flush=True)
            problems.append(msg)
    with open(KERAS_CONFIG) as f:
        config = json.load(f)
    kfile = keras_import.keras_file(
        config, _keras_layers_for("InceptionV3", SEED + 31))
    mf = ModelFunction.from_keras(kfile)
    init = {k: v.clone() for k, v in mf.module.state_dict().items()}
    reset_counts(sepconv)  # read at the phase's end: none of B1-B3 runs

    def estimator(model_file, loader, **kw):
        return KerasImageFileEstimator(
            inputCol="uri", outputCol="preds", labelCol="onehot",
            modelFile=model_file, imageLoader=loader,
            kerasLoss="categorical_crossentropy", batchSize=TUNING_BATCH,
            **kw)

    def grid_for(est):
        return (ParamGridBuilder().addGrid(est.optimizer, ["adam", "sgd"])
                .addGrid(est.fitParams, [{"epochs": 1}, {"epochs": 2}])
                .build())

    evaluator = MulticlassClassificationEvaluator(labelCol="label",
                                                  predictionCol="preds")
    with tempfile.TemporaryDirectory() as tmp:
        paths, labels = _tuning_files(os.path.join(tmp, "images"))

        def frame(n_out, idx=None, files=(paths, labels)):
            uris, ys = files
            idx = range(len(uris)) if idx is None else idx
            onehot = np.eye(n_out, dtype=np.float32)
            return DataFrame({"uri": [uris[i] for i in idx],
                              "label": [ys[i] for i in idx],
                              "onehot": [onehot[ys[i]].tolist()
                                         for i in idx]})

        df = frame(1000)

        # 1. config 5 at full width
        est = estimator(kfile, load_inception_v3)
        est._set(modelFunction=mf)  # the KerasFile converted once
        pools = []
        real_transform = ImageFileModel._transform
        evals = []

        def logged_transform(model, dataset):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = real_transform(model, dataset)
            torch.cuda.synchronize()
            evals.append((len(dataset), time.perf_counter() - t0))
            pools.append((graph_pool_bytes_held(),
                          _model_engine(model).graph_pool_bytes))
            return result

        ImageFileModel._transform = logged_transform
        try:
            with _FitLog() as log, _CaptureCount() as caps:
                t0 = time.perf_counter()
                cv = CrossValidator(estimator=est,
                                    estimatorParamMaps=grid_for(est),
                                    evaluator=evaluator, numFolds=3).fit(df)
                preds = cv.transform(df).column_to_numpy("preds")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            ImageFileModel._transform = real_transform
        gc.collect()
        held_after = graph_pool_bytes_held()
        counts = read_counts(sepconv)
        expect(counts == zero, f"[{tag}] launches {counts}, want none of "
                              f"B1-B3 in the CV run")
        losses = [l for fit in log.fits for l in fit["losses"]]
        expect(len(log.fits) == 13 and all(np.isfinite(losses)),
              f"[{tag}] {len(log.fits)} fits (want 13), losses finite "
              f"{bool(np.all(np.isfinite(losses)))}")
        expect(len(cv.avgMetrics) == 4 and preds.shape == (len(paths), 1000)
              and np.isfinite(preds).all(),
              f"[{tag}] avgMetrics {cv.avgMetrics}, best model's output "
              f"{preds.shape}")
        bound = pools[0][0] + pools[0][1]
        expect(held_after <= bound,
              f"[{tag}] graph pools held after the CV run "
              f"{held_after / 2**20:.1f} MiB > after the first fitted "
              f"model's transform plus one model's pool "
              f"{bound / 2**20:.1f} MiB")
        fit_s = sum(f["seconds"] for f in log.fits)
        fit_images = sum(f["images"] for f in log.fits)
        eval_s = sum(s for _, s in evals[:12])
        eval_images = sum(n for n, _ in evals[:12])
        best = int(np.argmax(cv.avgMetrics))
        modes = {}
        for f in log.fits:
            modes[f.get("mode")] = modes.get(f.get("mode"), 0) + 1
        out["cv"] = dict(
            wall_s=wall, fits=len(log.fits), fit_s=fit_s, step_modes=modes,
            fit_img_s=fit_images / fit_s, eval_img_s=eval_images / eval_s,
            captures=caps.n, avg_metrics=cv.avgMetrics, best_index=best,
            epoch_losses=[f["losses"] for f in log.fits],
            pool_after_first_transform_bytes=pools[0][0],
            model_pool_bytes=pools[0][1], pool_held_after_bytes=held_after,
            pool_held_per_transform_bytes=[p for p, _ in pools])
        print(f"[{tag}] config 5: KerasImageFileEstimator (converted Keras "
              f"InceptionV3, 299x299, batch {TUNING_BATCH}) x CrossValidator"
              f"(3 folds) over optimizer {{adam, sgd}} x epochs {{1, 2}} on "
              f"{len(paths)} tinted JPEGs: {len(log.fits)} fits, finite "
              f"losses, avgMetrics {[round(float(m), 4) for m in cv.avgMetrics]}, "
              f"best map {best}; wall {wall:.1f}s, fit {fit_s:.1f}s for "
              f"{fit_images} images ({fit_images / fit_s:.1f} img/s), eval "
              f"{eval_images / eval_s:.1f} img/s over {eval_images} images, "
              f"{caps.n} engine captures, fits' step modes {modes}; graph "
              f"pools held: after the first "
              f"transform {pools[0][0] / 2**20:.1f} MiB (one model's pool "
              f"{pools[0][1] / 2**20:.1f} MiB), after the run "
              f"{held_after / 2**20:.1f} MiB; B1-B3 launches {counts}",
              flush=True)

        # 5. save/load of the CV model
        t0 = time.perf_counter()
        cv.save(os.path.join(tmp, "cv"))
        back = CrossValidatorModel.load(os.path.join(tmp, "cv"))
        io_s = time.perf_counter() - t0
        again = back.transform(df).column_to_numpy("preds")
        expect(np.array_equal(again, preds) and back.avgMetrics ==
              cv.avgMetrics, f"[{tag}] the reloaded CV model's output "
                             f"differs (max abs "
                             f"{np.abs(again - preds).max():.3g})")
        out["save_load_s"] = io_s
        print(f"[{tag}] CrossValidatorModel save + load {io_s:.2f}s, "
              f"{len(paths)} rows bit-identical after the round trip",
              flush=True)
        del cv, back

        # 2. one full-width SGD fit, card against CPU (and TF32)
        sub = frame(1000, range(2 * TUNING_BATCH))

        def one_fit(device=None, tf32=False, **fit_params):
            e = estimator(kfile, load_inception_v3, kerasOptimizer="sgd",
                          kerasFitParams=dict({"epochs": 1}, **fit_params))
            e._set(modelFunction=mf)
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                with _FitLog() as flog:
                    if device == "cpu":
                        with default_device("cpu"):
                            m = e.fit(sub)
                    else:
                        m = e.fit(sub)
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            steps = [s for f in flog.fits for ep in f["steps"] for s in ep]
            return (np.asarray(steps),
                    m.getModelFunction().module.state_dict(),
                    flog.fits[-1]["seconds"])

        card_steps, card_sd, card_s = one_fit()
        cpu_steps, cpu_sd, cpu_s = one_fit("cpu")
        tf32_steps, tf32_sd, _ = one_fit(tf32=True)
        loss_rel = float(np.max(np.abs(card_steps - cpu_steps)
                                / np.abs(cpu_steps)))
        upd_rel = _update_rel(cpu_sd, card_sd, init)
        tf32_loss_rel = float(np.max(np.abs(tf32_steps - cpu_steps)
                                     / np.abs(cpu_steps)))
        tf32_upd_rel = _update_rel(cpu_sd, tf32_sd, init)
        print(f"[{tag}] one SGD fit of the converted InceptionV3 (1 epoch, 2 "
              f"steps of {TUNING_BATCH}) card vs CPU: step losses "
              f"{card_steps.tolist()} vs {cpu_steps.tolist()}, max rel err "
              f"{loss_rel:.3e} (tol {TUNING_LOSS_TOL}), update rel err "
              f"{upd_rel:.3e} (tol {TUNING_UPDATE_TOL}); with TF32 on "
              f"{tf32_loss_rel:.3e} / {tf32_upd_rel:.3e} (checked above a limit); "
              f"fit {card_s:.2f}s on the card, {cpu_s:.2f}s on the CPU",
              flush=True)
        expect(len(card_steps) == 2 and loss_rel <= TUNING_LOSS_TOL
              and upd_rel <= TUNING_UPDATE_TOL,
              f"[{tag}] full-width SGD fit card vs CPU: {len(card_steps)} "
              f"steps, step loss rel err {loss_rel:.4g} (tol "
              f"{TUNING_LOSS_TOL}), update rel err {upd_rel:.4g} (tol "
              f"{TUNING_UPDATE_TOL})")
        expect(tf32_loss_rel > TUNING_LOSS_TOL or tf32_upd_rel >
              TUNING_UPDATE_TOL,
              f"[{tag}] the TF32 fit reads step loss {tf32_loss_rel:.4g}, "
              f"update {tf32_upd_rel:.4g}: within the f32 limits, which "
              f"then cannot tell a TF32 path")
        out["card_vs_cpu"] = dict(
            step_losses=card_steps.tolist(), cpu_step_losses=cpu_steps.tolist(),
            step_loss_rel=loss_rel, update_rel=upd_rel,
            tf32_step_loss_rel=tf32_loss_rel, tf32_update_rel=tf32_upd_rel,
            card_fit_s=card_s, cpu_fit_s=cpu_s)

        # 6. an interrupted fit resumes to the uninterrupted one
        whole_steps, whole_sd, _ = one_fit(epochs=2)
        ck = os.path.join(tmp, "ckpt")
        first, _, _ = one_fit(epochs=1, checkpoint_dir=ck)
        rest, resumed_sd, _ = one_fit(epochs=2, checkpoint_dir=ck)
        resume_upd = _update_rel(whole_sd, resumed_sd, init)
        resume_loss = float(np.max(np.abs(np.concatenate([first, rest])
                                          - whole_steps)
                                   / np.abs(whole_steps)))
        print(f"[{tag}] 2-epoch SGD fit interrupted after epoch 1 "
              f"(checkpoint_dir) and resumed: step loss rel err "
              f"{resume_loss:.3e}, update rel err {resume_upd:.3e} against "
              f"the uninterrupted fit (tols {TUNING_LOSS_TOL}, "
              f"{TUNING_UPDATE_TOL})", flush=True)
        expect(len(rest) == 2 and resume_loss <= TUNING_LOSS_TOL
              and resume_upd <= TUNING_UPDATE_TOL,
              f"[{tag}] resumed fit: {len(rest)} steps after the resume "
              f"(want 2), step loss rel err {resume_loss:.4g}, update rel "
              f"err {resume_upd:.4g} against the uninterrupted fit")
        out["resume"] = dict(step_loss_rel=resume_loss, update_rel=resume_upd,
                             checkpoints=sorted(os.listdir(ck)))
        del card_sd, cpu_sd, tf32_sd, whole_sd, resumed_sd

        # 3. the small CNN tuned on the card and on the CPU
        cnn = KerasModel(_cnn_config())
        cfile = keras_import.keras_file(_cnn_config(),
                                        _seeded_cnn_arrays(cnn, SEED + 59))
        small = frame(2, files=_tuning_files(
            os.path.join(tmp, "cnn_images"), TUNING_CNN_BASES, 60.0,
            SEED + 61))
        runs = {}
        for where in ("card", "cpu"):
            cest = estimator(cfile, load_small)
            grid = grid_for(cest)
            with _FitLog() as clog:
                if where == "cpu":
                    with default_device("cpu"):
                        cvm = CrossValidator(
                            estimator=cest, estimatorParamMaps=grid,
                            evaluator=evaluator, numFolds=3).fit(small)
                        cout = cvm.transform(small).column_to_numpy("preds")
                else:
                    cvm = CrossValidator(
                        estimator=cest, estimatorParamMaps=grid,
                        evaluator=evaluator, numFolds=3).fit(small)
                    cout = cvm.transform(small).column_to_numpy("preds")
            runs[where] = (cvm.avgMetrics, [f["losses"] for f in clog.fits],
                           cout)
        (cm, cl, co), (pm, pl, po) = runs["card"], runs["cpu"]
        cnn_loss_rel = max(abs(a - b) / abs(b) for x, y in zip(cl, pl)
                           for a, b in zip(x, y))
        cnn_out_rel = _rel(co, po)
        print(f"[{tag}] small Keras CNN (2 x Conv2D+BatchNormalization, "
              f"Dropout, pooling, Dense; {TUNING_CNN_SIZE}x"
              f"{TUNING_CNN_SIZE}) tuned over the same grid and folds, card "
              f"vs CPU: avgMetrics {[round(float(m), 4) for m in cm]} / "
              f"{[round(float(m), 4) for m in pm]}, best map "
              f"{int(np.argmax(cm))} / {int(np.argmax(pm))}, {len(cl)} / "
              f"{len(pl)} fits, epoch loss "
              f"rel err {cnn_loss_rel:.3e} (tol {TUNING_CNN_LOSS_TOL}), best "
              f"model's outputs {cnn_out_rel:.3e} (tol {TUNING_CNN_OUT_TOL})",
              flush=True)
        expect(cm == pm and int(np.argmax(cm)) == int(np.argmax(pm))
              and len(cl) == len(pl) == 13
              and cnn_loss_rel <= TUNING_CNN_LOSS_TOL
              and cnn_out_rel <= TUNING_CNN_OUT_TOL,
              f"[{tag}] small CNN card vs CPU: avgMetrics {cm} vs {pm}, "
              f"{len(cl)} / {len(pl)} fits, epoch loss rel err "
              f"{cnn_loss_rel:.4g} (tol {TUNING_CNN_LOSS_TOL}), best model "
              f"output rel err {cnn_out_rel:.4g} (tol {TUNING_CNN_OUT_TOL})")
        out["cnn"] = dict(avg_metrics=cm, best_index=int(np.argmax(cm)),
                          epoch_loss_rel=cnn_loss_rel,
                          output_rel=cnn_out_rel)

        # 4. trainBatchStats on the zoo's ResNet50
        resnet = load_model("ResNet50", weights=None)
        before = resnet.state_dict()
        stat_keys = [k for k in before
                     if k.endswith(("running_mean", "running_var"))]
        param_keys = [n for n, _ in resnet.named_parameters()]

        def rn_fit(rows, where, f64=False):
            """A trainBatchStats SGD fit of ResNet50 over ``rows`` (1
            epoch, batch 8); its state dict.  ``f64``: the same fit on the
            CPU in float64, from the estimator's own (float32) arrays."""
            m = copy.deepcopy(resnet).to(torch.float64 if f64 else
                                         torch.float32)
            rn_est = ImageFileEstimator(
                inputCol="uri", outputCol="preds", labelCol="onehot",
                modelFunction=ModelFunction.from_module(m),
                imageLoader=load_resnet, optimizer="sgd", batchSize=8,
                trainBatchStats=True, fitParams={"epochs": 1})
            rdf = frame(1000, rows)
            if f64:
                x, y = rn_est._load_numpy(rdf)
                with default_device("cpu"):
                    fitted = rn_est._fit_on_arrays(x.astype(np.float64),
                                                   y.astype(np.float64))
            elif where == "cpu":
                with default_device("cpu"):
                    fitted = rn_est.fit(rdf)
            else:
                fitted = rn_est.fit(rdf)
            return fitted.getModelFunction().module.state_dict()

        def part(sd, keys):
            return {k: sd[k] for k in keys}

        # one step: the statistics come from the train-mode forward at
        # the initial weights, which float32 computes to ~1e-7
        one = {w: rn_fit(range(8), w) for w in ("card", "cpu")}
        one["f64"] = rn_fit(range(8), "cpu", f64=True)
        moved = max(float((one["cpu"][k] - before[k]).abs().max())
                    for k in stat_keys)
        # relative to each statistic's move, not to its value
        stats_rel = _update_rel(part(one["cpu"], stat_keys),
                                part(one["card"], stat_keys), before)
        print(f"[{tag}] trainBatchStats=True on the zoo's ResNet50 "
              f"(from_module, 224x224, one SGD step of 8): "
              f"{len(stat_keys)} running statistics updated (max move "
              f"{moved:.3g}), card vs CPU rel err of the move "
              f"{stats_rel:.3e} (tol {TUNING_STATS_TOL})", flush=True)
        expect(len(stat_keys) == 2 * 53 and moved > 0
              and stats_rel <= TUNING_STATS_TOL,
              f"[{tag}] ResNet50 trainBatchStats, one step: "
              f"{len(stat_keys)} statistics, moved {moved:.3g}, card vs "
              f"CPU rel err {stats_rel:.4g} (tol {TUNING_STATS_TOL})")
        # the gradient through 53 train-mode BatchNorms of a random
        # ResNet50 is good to ~2e-2 in float32, on the CPU as on the card
        # (tools/batchstats_witness.py), and the second step's statistics
        # inherit it; so the parameters' update after one step and the
        # statistics after two are held to a float64 fit on the CPU: the
        # card no further from it than TUNING_STATS_F64_RATIO times the
        # CPU's float32 fit.  The parameters after two steps are printed
        # only: float32 moves them by about their whole update.
        two = {w: rn_fit(range(16), w) for w in ("card", "cpu")}
        two["f64"] = rn_fit(range(16), "cpu", f64=True)
        vs_f64 = {}
        for fits, steps, what, keys, held in (
                (one, 1, "parameters", param_keys, True),
                (two, 2, "statistics", stat_keys, True),
                (two, 2, "parameters", param_keys, False)):
            ref = part(fits["f64"], keys)
            card = _update_rel(ref, part(fits["card"], keys), before)
            cpu = _update_rel(ref, part(fits["cpu"], keys), before)
            vs_f64[f"{what}_{steps}_steps"] = dict(card=card, cpu=cpu)
            lim = max(TUNING_STATS_F64_RATIO * cpu, TUNING_STATS_TOL)
            print(f"[{tag}] ResNet50 trainBatchStats, {steps} SGD step(s) "
                  f"of 8, the {what}' update vs the CPU's float64 fit: "
                  f"card {card:.3e}, CPU float32 {cpu:.3e} "
                  + (f"(the card's limit {lim:.3e})" if held else
                     "(not held)"), flush=True)
            if held:
                expect(card <= lim,
                       f"[{tag}] ResNet50 trainBatchStats, {steps} "
                       f"step(s): the card's {what} {card:.4g} from the "
                       f"float64 fit, over {TUNING_STATS_F64_RATIO} x the "
                       f"CPU's {cpu:.4g}")
        out["resnet_batch_stats_rel"] = stats_rel
        out["resnet_vs_f64"] = vs_f64
    counts = read_counts(sepconv)
    expect(counts == zero, f"[{tag}] launches {counts}, want none of B1-B3")
    check(not problems, f"[{tag}] {len(problems)} failed: "
                        + " | ".join(problems))
    out["launches"] = counts
    return out


class env_knobs:
    """Set environment knobs for a ``with`` block, restoring them after."""

    def __init__(self, knobs):
        self.knobs = knobs

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.knobs}
        os.environ.update(self.knobs)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


NATIVE_FILES = 64               # JPEGs a decode batch, beside one garbage
NATIVE_PIL_MEAN_ABS = 8.0       # native vs PIL mean abs diff (tests/test_native.py:59)


def _native_blobs(n, seed):
    """``n`` camera-sized JPEGs (500x375, smooth gradients and noise, as
    photographs compress) and one garbage file, last."""
    import io as _io

    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:375, 0:500]
    blobs = []
    for i in range(n):
        base = np.stack([(xx * (i + 1) // 7) % 256, (yy * 3) % 256,
                         ((xx + yy) * (i % 5 + 1)) % 256], -1)
        img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255)
        buf = _io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", quality=90)
        blobs.append(buf.getvalue())
    return blobs + [b"not a jpeg"]


def phase_native(sepconv):
    """[native]: the host decode core (``sparkdl_tpu_torch/native``), which
    builds with g++ against libjpeg and libpng where their headers are
    present, else leaves ``decodeResizeBatch`` / ``structsToBatch`` on
    PIL.  Prints whether it built and why not; where it built, holds it to
    PIL over NATIVE_FILES JPEGs and a garbage file at 224x224 and 299x299
    (mean abs diff under NATIVE_PIL_MEAN_ABS, equal ok masks, the garbage
    row dropped), and times both routes a batch.  None of B1-B3 runs."""
    from sparkdl_tpu_torch import native
    from sparkdl_tpu_torch.image import io as image_io

    tag = "native"
    built, why = native.status()
    blobs = _native_blobs(NATIVE_FILES, SEED + 61)
    out = dict(built=built, why_not=why, ms={})
    with native.disabled():
        pil = {s: image_io.decodeResizeBatch(blobs, s, s)
               for s in (224, 299)}
        for s in (224, 299):
            out["ms"][f"pil_{s}"] = 1e3 * min(_wall(
                lambda: image_io.decodeResizeBatch(blobs, s, s))
                for _ in range(3))
    for s in (224, 299):
        ok = pil[s][1]
        check(ok.tolist() == [True] * NATIVE_FILES + [False],
              f"[{tag}] PIL ok mask at {s}: {ok.tolist()}")
    if not built:
        print(f"[{tag}] native core not built ({why}): decodeResizeBatch and "
              f"structsToBatch take the PIL route; PIL decode+resize of "
              f"{NATIVE_FILES} 500x375 JPEGs + 1 garbage: "
              f"{out['ms']['pil_224']:.1f} ms a batch at 224x224, "
              f"{out['ms']['pil_299']:.1f} ms at 299x299", flush=True)
        return out
    diffs = {}
    for s in (224, 299):
        got, ok = image_io.decodeResizeBatch(blobs, s, s)
        check(np.array_equal(ok, pil[s][1]),
              f"[{tag}] native ok mask {ok.tolist()} != PIL's at {s}")
        check(not got[-1].any(), f"[{tag}] garbage row not zeroed at {s}")
        diffs[s] = float(np.abs(got[:-1].astype(int)
                                - pil[s][0][:-1].astype(int)).mean())
        check(diffs[s] < NATIVE_PIL_MEAN_ABS,
              f"[{tag}] native vs PIL mean abs diff {diffs[s]:.3f} at {s}")
        out["ms"][f"native_{s}"] = 1e3 * min(_wall(
            lambda: image_io.decodeResizeBatch(blobs, s, s))
            for _ in range(3))
    out["mean_abs_vs_pil"] = diffs
    print(f"[{tag}] native core built ({native.library_path().name}): "
          f"{NATIVE_FILES} 500x375 JPEGs + 1 garbage, ok masks equal to "
          f"PIL's; mean abs diff vs PIL {diffs[224]:.3f} (224) / "
          f"{diffs[299]:.3f} (299), limit {NATIVE_PIL_MEAN_ABS}; ms a batch "
          f"native / PIL: 224x224 {out['ms']['native_224']:.1f} / "
          f"{out['ms']['pil_224']:.1f}, 299x299 {out['ms']['native_299']:.1f}"
          f" / {out['ms']['pil_299']:.1f}", flush=True)
    return out


def _wall(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


TFGRAPH_ORACLE_TOL = 1e-6       # card vs TensorFlow's stored outputs, f32
TFGRAPH_CPU_TOL = 1e-6          # card vs the port on the CPU, f32
TFGRAPH_FIXTURE_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_tf_input.py


def _gen_tf_graphs():
    """``tools/gen_tf_graphs.py`` (TensorFlow only inside its writer): the
    skeleton's files, ``seeded_keras_arrays`` and TF's oracle batch."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "gen_tf_graphs.py")
    spec = importlib.util.spec_from_file_location("gen_tf_graphs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tf_inception_preprocess(x):
    """Keras' InceptionV3 preprocess of the uint8 RGB batch that
    TFImageTransformer hands its ModelFunction, in float32 as TF's oracle
    was fed."""
    return x.float() / 127.5 - 1.0


class _Pick:
    """One output of a multi-output graph (module-level: it pickles)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, y):
        return y[self.key]


class _Reshape:
    """A flat input column back to the graph's input shape."""

    def __init__(self, name, shape):
        self.name, self.shape = name, tuple(shape)

    def __call__(self, x):
        return {**x, self.name: x[self.name].reshape((-1,) + self.shape)}


def _fixture_constructors(fixtures, model):
    """The six TFInputGraph constructors over one TF-written fixture; the
    Graph and Session of ``fromGraph`` are stand-ins that serve the
    checkpoint's stored graph and its variables (there is no TensorFlow
    here)."""
    from sparkdl_tpu_torch.graph.input import TFInputGraph

    d = os.path.join(fixtures, model)
    with open(os.path.join(d, "names.json")) as f:
        names = json.load(f)
    feeds = list(names["feeds"].values())
    fetches = list(names["fetches"].values())
    graph, sess = _gen_tf_graphs().checkpoint_stand_ins(
        os.path.join(d, "ckpt"))

    sm = os.path.join(d, "saved_model")
    tigs = {
        "fromGraph": TFInputGraph.fromGraph(graph, sess, feeds, fetches),
        "fromGraphDef": TFInputGraph.fromGraphDef(
            os.path.join(d, "frozen.pb"), feeds, fetches),
        "fromCheckpoint": TFInputGraph.fromCheckpoint(
            os.path.join(d, "ckpt"), feeds, fetches),
        "fromCheckpointWithSignature":
            TFInputGraph.fromCheckpointWithSignature(
                os.path.join(d, "ckpt"), names["checkpoint_signature"]),
        "fromSavedModel": TFInputGraph.fromSavedModel(
            sm, names["tags"], feeds, fetches),
        "fromSavedModelWithSignature":
            TFInputGraph.fromSavedModelWithSignature(
                sm, names["tags"], names["saved_model_signature"]),
    }
    return names, dict(np.load(os.path.join(d, "io.npz"))), tigs


def phase_tfgraph(sepconv):
    """[tfgraph]: TFInputGraph without TensorFlow.  A frozen Keras
    InceptionV3 (the committed 2,217-node skeleton, its weight constants
    filled from ``seeded_keras_arrays``) at 299x299, batch 32, f32 with
    TF32 off; B1-B3 must not launch.

      1. parse, fill and import times; ``TFInputGraph.fromGraphDef`` with
         two fetches (pooled features, probabilities) after a uint8 ->
         float preprocess, through InferenceEngine as one CUDA graph: the
         oracle batch's two images within TFGRAPH_ORACLE_TOL of
         TensorFlow's stored outputs, the batch within TFGRAPH_CPU_TOL of
         the port on the CPU, graphed == eager bit for bit, TF32's reading
         printed and above both limits; device ms graphed and eager in f32
         and TF32, kernel nodes per replay, the graph pool;
      2. TFImageTransformer over the Arrow image column of the same 32
         images and 32 more: equal to the engine's probabilities (two
         batches: a check, not a rate); saved and loaded, bit for bit;
      3. the six constructors over the TF-written MLP and CNN through
         TFTransformer (multi-column outputMapping) on the card, each
         within TFGRAPH_FIXTURE_TOL of TensorFlow's stored outputs."""
    import tempfile

    from sparkdl_tpu_torch import default_device
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph import proto
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.graph.input import TFInputGraph
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import (TFImageTransformer,
                                                TFTransformer)

    tag = "tfgraph"
    zero = dict(sepconv=0, sepconv_tiled=0, mbconv=0)
    gen = _gen_tf_graphs()
    with open(gen.INCEPTION_JSON) as f:
        meta = json.load(f)
    pooled, probs_name = meta["pooled"], meta["probabilities"]
    t0 = time.perf_counter()
    with open(gen.INCEPTION_PB, "rb") as f:
        gd = proto.GraphDef.parse(f.read())
    t1 = time.perf_counter()
    gen.fill_skeleton(gd, gen.skeleton_arrays(meta))
    t2 = time.perf_counter()
    tig = TFInputGraph.fromGraphDef(gd, [meta["feed"]], [pooled, probs_name])
    mf = tig.model_function()
    t3 = time.perf_counter()
    times = dict(parse_s=t1 - t0, fill_s=t2 - t1, import_s=t3 - t2)
    check(len(gd.node) == 2217 and len(meta["weights"]) == 378,
          f"[{tag}] skeleton has {len(gd.node)} nodes, "
          f"{len(meta['weights'])} weight constants")
    full = ModelFunction.from_callable(tf_inception_preprocess).compose(mf)
    oracle = np.load(gen.INCEPTION_ORACLE)
    head = gen.oracle_batch()
    rng = np.random.default_rng(SEED + 67)
    x8 = np.concatenate([head, rng.integers(
        0, 256, (BATCH - len(head), 299, 299, 3), dtype=np.uint8)])

    # 1. the engine: one CUDA graph
    reset_counts(sepconv)
    eng = InferenceEngine(full.fn, full.module, device="cuda",
                          device_batch_size=BATCH)
    y = eng(x8)
    torch.cuda.synchronize()
    check(eng.capture and len(eng.graphs()) == 1,
          f"[{tag}] the engine did not run a captured graph")
    check(y[pooled].shape == (BATCH, 2048) and y[probs_name].shape
          == (BATCH, 1000) and all(np.isfinite(v).all() for v in y.values()),
          f"[{tag}] outputs {[v.shape for v in y.values()]} not finite or "
          f"misshapen")
    rel_oracle = {k: _rel(y[n][:len(head)], oracle[k])
                  for k, n in (("pooled", pooled),
                               ("probabilities", probs_name))}
    check(max(rel_oracle.values()) <= TFGRAPH_ORACLE_TOL,
          f"[{tag}] card vs TensorFlow's outputs {rel_oracle} > "
          f"{TFGRAPH_ORACLE_TOL}")
    with default_device("cpu"):
        cpu = InferenceEngine(full.fn, full.module, device="cpu",
                              device_batch_size=BATCH)(x8)
    rel_cpu = {n: _rel(y[n], cpu[n]) for n in (pooled, probs_name)}
    check(max(rel_cpu.values()) <= TFGRAPH_CPU_TOL,
          f"[{tag}] card vs CPU {rel_cpu} > {TFGRAPH_CPU_TOL}")
    staged = eng._pad(x8)
    eng.capture = False
    eager = eng.run_padded(staged)
    eng.capture = True
    graphed = eng.run_padded(staged)
    torch.cuda.synchronize()
    same = all(torch.equal(graphed[k], eager[k]) for k in graphed) \
        if isinstance(graphed, dict) else torch.equal(graphed, eager)
    check(same, f"[{tag}] graphed forward differs from the eager forward")
    g = next(iter(eng._core.graphs.values()))
    nodes = graph_kernel_nodes(g.graph)[0]
    pool = eng.graph_pool_bytes
    ms = dict(f32=cuda_ms(lambda: eng.run_padded(staged), reps=10),
              replay_f32=cuda_ms(g.graph.replay, reps=10))
    eng.capture = False
    ms["eager_f32"] = cuda_ms(lambda: eng.run_padded(staged), reps=10)
    eng.capture = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = eng(x8)
        ms["tf32"] = cuda_ms(lambda: eng.run_padded(staged), reps=10)
        eng.capture = False
        ms["eager_tf32"] = cuda_ms(lambda: eng.run_padded(staged), reps=10)
        eng.capture = True
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rel_tf32 = {k: _rel(tf32[n][:len(head)], oracle[k])
                for k, n in (("pooled", pooled),
                             ("probabilities", probs_name))}
    check(min(rel_tf32.values()) > max(TFGRAPH_ORACLE_TOL, TFGRAPH_CPU_TOL),
          f"[{tag}] TF32 vs TensorFlow's outputs reads {rel_tf32}, within "
          f"the f32 limits: they cannot tell a TF32 path")
    check(read_counts(sepconv) == zero,
          f"[{tag}] launches {read_counts(sepconv)}")
    print(f"[{tag}] frozen InceptionV3 skeleton ({len(gd.node)} nodes, "
          f"{len(meta['weights'])} weight constants from seeded_keras_arrays"
          f"): parse {times['parse_s']:.2f}s, fill {times['fill_s']:.2f}s, "
          f"import {times['import_s']:.2f}s ({len(mf.module.steps)} steps, "
          f"{len(mf.module.const_names)} buffers); 299x299 batch {BATCH} on "
          f"the card vs TensorFlow's stored outputs ||a-b||/||b|| = pooled "
          f"{rel_oracle['pooled']:.3e}, probabilities "
          f"{rel_oracle['probabilities']:.3e} (tol {TFGRAPH_ORACLE_TOL}); "
          f"vs the CPU {max(rel_cpu.values()):.3e} (tol {TFGRAPH_CPU_TOL}); "
          f"TF32 vs TensorFlow pooled {rel_tf32['pooled']:.3e}, "
          f"probabilities {rel_tf32['probabilities']:.3e} (above the "
          f"limits); graphed == eager bit for bit; device ms per forward "
          f"graphed / eager: f32 {ms['f32']:.2f} / {ms['eager_f32']:.2f}, "
          f"TF32 {ms['tf32']:.2f} / {ms['eager_tf32']:.2f}; replay alone f32 "
          f"{ms['replay_f32']:.2f}; kernel nodes per replay {nodes}; graph "
          f"pool {pool / 2**20:.1f} MiB", flush=True)

    # 2. TFImageTransformer over the Arrow image column
    more = rng.integers(0, 256, (BATCH, 299, 299, 3), dtype=np.uint8)
    imgs = np.concatenate([x8, more])
    df = DataFrame(structsToArrow([imageArrayToStruct(im[:, :, ::-1])
                                   for im in imgs]))  # structs are BGR
    stage_mf = full.compose(ModelFunction.from_callable(_Pick(probs_name)))
    stage = TFImageTransformer(inputCol="image", outputCol="p",
                               modelFunction=stage_mf, batchSize=BATCH)
    stage.transform(df.limit(BATCH))  # warm: the stage's engine and graph
    rows = stage.transform(df).column_to_numpy("p")
    want = np.concatenate([y[probs_name], eng(more)[probs_name]])
    check(rows.shape == (2 * BATCH, 1000) and np.array_equal(rows, want),
          f"[{tag}] TFImageTransformer differs from the engine (max abs "
          f"{np.abs(rows - want).max():.3g})")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stage.save(os.path.join(tmp, "stage"))
        again = TFImageTransformer.load(os.path.join(tmp, "stage"))
        io_s = time.perf_counter() - t0
        reloaded = again.transform(df).column_to_numpy("p")
    check(np.array_equal(reloaded, rows),
          f"[{tag}] reloaded stage's output differs")
    del again
    print(f"[{tag}] TFImageTransformer (uint8 -> x/127.5-1 -> the frozen "
          f"graph -> probabilities) over {len(imgs)} image structs, batch "
          f"{BATCH}: equal to the engine bit for bit;"
          f" save + load {io_s:.2f}s, reloaded output bit for bit", flush=True)

    # 3. the six constructors on the TF-written fixtures, via TFTransformer
    fixtures = os.path.join(os.path.dirname(gen.INCEPTION_PB), "tf_fixtures")
    worst = 0.0
    t0 = time.perf_counter()
    for model in ("mlp", "cnn"):
        names, io, tigs = _fixture_constructors(fixtures, model)
        for kind, t in tigs.items():
            fmf = t.model_function()
            signature = kind.endswith("Signature")
            feeds = {k: (k if signature else v)
                     for k, v in names["feeds"].items()}
            x = {k: io[f"in_{k}"] for k in names["feeds"]}
            cols = DataFrame({f"c_{k}": [r.reshape(-1).tolist() for r in v]
                              for k, v in x.items()})
            pre = ModelFunction.from_callable(
                _Reshape(feeds[next(iter(x))], next(iter(x.values())).shape[1:]),
                input_names=fmf.input_names, output_names=fmf.input_names)
            outs = {k: (k if signature else v)
                    for k, v in names["fetches"].items()}
            tft = TFTransformer(
                modelFunction=pre.compose(fmf),
                inputMapping={f"c_{k}": v for k, v in feeds.items()},
                outputMapping={v: f"o_{k}" for k, v in outs.items()},
                batchSize=BATCH)
            got = tft.transform(cols)
            for k in names["fetches"]:
                a = got.column_to_numpy(f"o_{k}")
                ref = io[f"out_{k}"]
                check(np.allclose(a, ref, **TFGRAPH_FIXTURE_TOL),
                      f"[{tag}] {model} {kind} output {k} vs TensorFlow: max "
                      f"abs {np.abs(a - ref).max():.3g}")
                worst = max(worst, float(np.abs(a - ref).max()))
    fixtures_s = time.perf_counter() - t0
    counts = read_counts(sepconv)
    check(counts == zero, f"[{tag}] launches {counts}, want none of B1-B3")
    print(f"[{tag}] six constructors (fromGraph, fromGraphDef, "
          f"fromCheckpoint[WithSignature], fromSavedModel[WithSignature]) "
          f"over the TF-written MLP and CNN through TFTransformer on the "
          f"card: every output within rtol 1e-5 / atol 1e-6 of TensorFlow's "
          f"(max abs {worst:.3g}), {fixtures_s:.2f}s for the 12; B1-B3 "
          f"launches {counts}", flush=True)
    del stage, eng
    return dict(import_s=times, forward_ms=ms, kernel_nodes_per_replay=nodes,
                graph_pool_bytes=pool, rel_err=dict(
                    card_vs_tf=rel_oracle, card_vs_cpu=rel_cpu,
                    tf32_vs_tf=rel_tf32),
                save_load_s=io_s, fixtures_max_abs=worst, launches=counts)


def profiled_kernels(fn):
    """Kernels on the card in one ``fn()``, from ``torch.profiler``'s
    trace: (total launches, launches by kernel name).  The profiler loses
    the first records of its window, more as the process ages (PERF.md
    section 6, PR 10), so ``fn()`` runs twice in one window and only the
    kernels of the second call count: those whose correlation id is a
    launch (runtime or driver call, a graph launch included) made inside
    that call's annotated range."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("chip_smoke.counted"):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "chip_smoke.counted")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    launches = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})}
    names = {}
    for e in events:
        if (e.get("cat") == "kernel"
                and e.get("args", {}).get("correlation") in launches):
            names[e["name"]] = names.get(e["name"], 0) + 1
    return sum(names.values()), names


class _KernelNodeParams(ctypes.Structure):
    """libcuda's CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernel_nodes(cuda_graph):
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (the engine
    keeps its ``cudaGraph_t``), read through libcuda's graph API: what
    every replay launches, whatever a profiler records.  (total, nodes by
    kernel name as libcuda gives it, mangled)."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    names = {}

    def walk(graph):
        n = ctypes.c_size_t(0)
        ok(cu.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n)),
           "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        ok(cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                              ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int(-1)
            ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)), "cuGraphNodeGetType")
            if kind.value == 0:     # CU_GRAPH_NODE_TYPE_KERNEL
                p = _KernelNodeParams()
                ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                    ctypes.byref(p)),
                   "cuGraphKernelNodeGetParams_v2")
                name = ctypes.c_char_p()
                if p.func:
                    ok(cu.cuFuncGetName(ctypes.byref(name),
                                        ctypes.c_void_p(p.func)),
                       "cuFuncGetName")
                else:
                    ok(cu.cuKernelGetName(ctypes.byref(name),
                                          ctypes.c_void_p(p.kern)),
                       "cuKernelGetName")
                key = name.value.decode()
                names[key] = names.get(key, 0) + 1
            elif kind.value == 4:   # CU_GRAPH_NODE_TYPE_GRAPH
                child = ctypes.c_void_p()
                ok(cu.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node),
                                                    ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
                walk(child.value)

    walk(cuda_graph.raw_cuda_graph())
    return sum(names.values()), names


def _keras_tf_uint8(m, x):
    return m(x.to(torch.float32) / 127.5 - 1.0)


def _keras_graph_engine():
    """The converted Keras InceptionV3 of [keras] (the committed config,
    the same seeded arrays) in an engine over uint8 batches, as the zoo
    engines take them."""
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import keras_import
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    with open(KERAS_CONFIG) as f:
        mf = ModelFunction.from_keras(keras_import.keras_file(
            json.load(f), _keras_layers_for("InceptionV3", SEED + 31)))
    return InferenceEngine(_keras_tf_uint8, mf.module, device="cuda",
                           device_batch_size=BATCH)


def graph_path(sepconv, tag, name, size, knobs, want, edit):
    """One path of [graph]: the engine's captured forward (the zoo
    engine's, or the converted Keras model's for a "keras:" name) against
    the same engine's eager forward (``capture = False``), bit for bit; device
    ms per forward of both and of the replay alone, host us per dispatch,
    launches per batch (credited counts, held against one profiler pass
    over a replay, whose kernel count must equal an eager forward's where
    our kernels run), the graph's pool bytes; a recapture after an
    in-place weight edit, after a TF32 toggle, and after a ``.data`` write
    with the fold caches cleared."""
    from sparkdl_tpu_torch.parallel.engine import fold_entries
    from sparkdl_tpu_torch.transformers import named_image as ni

    rng = np.random.default_rng(SEED + 11)
    batch = rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)
    with env_knobs(knobs):
        eng = (_keras_graph_engine() if name.startswith("keras:")
               else ni._zoo_engine(name, True, BATCH))
    check(eng.capture, f"[graph] {tag}: the engine does not capture")

    def eager(x):
        eng.capture = False
        try:
            return eng.run_padded(x)
        finally:
            eng.capture = True

    graphed = eng.run_padded(batch)
    plain = eager(batch)
    torch.cuda.synchronize()
    check(torch.equal(graphed, plain),
          f"[graph] {tag}: graphed forward differs from the eager forward "
          f"(max abs {(graphed.float() - plain.float()).abs().max().item()})")
    check(torch.isfinite(graphed.float()).all().item(),
          f"[graph] {tag}: features not finite")

    staged = eng._pad(batch)  # a pinned host batch, as prepare makes it
    sig = next(iter(eng._core.graphs))
    g = eng._core.graphs[sig]
    for k in ("engine.replay_host", "engine.eager_host"):
        eng.metrics.timings_s.pop(k, None)
    fwd_ms = cuda_ms(lambda: eng.run_padded(staged), reps=GRAPH_TIMED_REPLAYS)
    replay_ms = cuda_ms(g.graph.replay, reps=GRAPH_TIMED_REPLAYS)
    eager_ms = cuda_ms(lambda: eager(staged), reps=GRAPH_TIMED_REPLAYS)
    host_us = eng.metrics.percentile("engine.replay_host", 50) * 1e6
    eager_host_us = eng.metrics.percentile("engine.eager_host", 50) * 1e6

    reset_counts(sepconv)
    for _ in range(4):
        eng.run_padded(staged)
    torch.cuda.synchronize()
    counts = read_counts(sepconv)
    per_batch = tuple(counts[k] // 4 for k in ("sepconv", "sepconv_tiled",
                                               "mbconv"))
    check(per_batch == want and all(v % 4 == 0 for v in counts.values()),
          f"[graph] {tag}: launches {counts} over 4 replays, want {want} "
          f"per batch")
    nodes, node_names = graph_kernel_nodes(g.graph)
    prof_total, prof_names = profiled_kernels(g.graph.replay)
    prof_eager, eager_names = profiled_kernels(lambda: eager(staged))
    node_ours, prof_ours = (
        tuple(sum(n for k, n in names.items() if p in k)
              for p in ("sepconv_kernel", "sepconv_tiled_kernel",
                        "mbconv_kernel"))
        for names in (node_names, prof_names))
    del g
    # the graph's own kernel nodes are what a replay launches; the
    # profiler's count of a replay is printed beside them (it also runs
    # the graph's copy nodes, as memcpy32_post kernels)
    check(node_ours == want and prof_ours == want,
          f"[graph] {tag}: the graph holds {node_ours} of our kernels and "
          f"the profiler counts {prof_ours} in one replay, the credited "
          f"counts {want}")
    prof_diff = {k: (prof_names.get(k, 0), eager_names.get(k, 0))
                 for k in set(prof_names) | set(eager_names)
                 if prof_names.get(k, 0) != eager_names.get(k, 0)}
    if any(want):
        check(nodes == prof_eager,
              f"[graph] {tag}: {nodes} kernel nodes in the graph, "
              f"{prof_eager} kernels in one eager forward (profiler, "
              f"replay vs eager by name: {prof_diff})")

    def captured(want_new, what):
        got = eng.metrics.counters["engine.graph_captures"] - captures
        check(got == want_new, f"[graph] {tag}: {got} captures after "
                               f"{what}, want {want_new}")

    captures = eng.metrics.counters["engine.graph_captures"]
    buf = dict(chain(eng.module.named_parameters(),
                     eng.module.named_buffers()))[edit]
    saved = buf.clone()
    with torch.no_grad():
        buf.mul_(0.5)
    edited = eng.run_padded(batch)
    edited_plain = eager(batch)
    torch.cuda.synchronize()
    captured(1, "an in-place weight edit")
    check(torch.equal(edited, edited_plain),
          f"[graph] {tag}: after the weight edit the graphed forward "
          f"differs from the eager one")
    check(not torch.equal(edited, graphed),
          f"[graph] {tag}: the weight edit did not change the output")
    with torch.no_grad():
        buf.copy_(saved)
    back = eng.run_padded(batch)
    torch.cuda.synchronize()
    captured(2, "the weights were restored")
    check(torch.equal(back, graphed),
          f"[graph] {tag}: with the first weights restored the output "
          f"differs from the first one")
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = eng.run_padded(batch)
        tf32_plain = eager(batch)
        torch.cuda.synchronize()
        captured(3, "cudnn.allow_tf32 was set")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check(torch.equal(tf32, tf32_plain),
          f"[graph] {tag}: with TF32 on the graphed forward differs from "
          f"the eager one")
    back = eng.run_padded(batch)
    torch.cuda.synchronize()
    captured(4, "cudnn.allow_tf32 was cleared again")
    check(torch.equal(back, graphed),
          f"[graph] {tag}: with TF32 off again the output differs from the "
          f"first one")

    # a write through .data moves no version counter: clearing the fold
    # caches after it is what makes the engine capture again
    had_folds = bool(fold_entries(eng._fold_owners))
    saved = buf.clone()
    buf.data.mul_(0.5)
    for m in eng._fold_owners:
        m._folds.clear()
    edited = eng.run_padded(batch)
    edited_plain = eager(batch)
    torch.cuda.synchronize()
    captured(4 + had_folds, "a .data write and cleared fold caches")
    check(torch.equal(edited, edited_plain),
          f"[graph] {tag}: after a .data write and cleared fold caches the "
          f"graphed forward differs from the eager one")
    check(not torch.equal(edited, graphed),
          f"[graph] {tag}: the .data write did not change the output")
    buf.data.copy_(saved)
    for m in eng._fold_owners:
        m._folds.clear()
    back = eng.run_padded(batch)
    torch.cuda.synchronize()
    captured(4 + 2 * had_folds, "the .data write was undone")
    check(torch.equal(back, graphed),
          f"[graph] {tag}: with the .data write undone the output differs "
          f"from the first one")

    pool = eng.graph_pool_bytes  # the engine's one pool, all its captures
    print(f"[graph] {tag} {size}x{size} batch {BATCH}: graphed == eager bit "
          f"for bit; device ms per forward: graphed {fwd_ms:.3f} (replay "
          f"alone {replay_ms:.3f}), eager {eager_ms:.3f}; host us per "
          f"dispatch: graphed {host_us:.1f}, eager {eager_host_us:.1f}; "
          f"launches per batch (B1, B3, B2) {per_batch}; {nodes} kernel "
          f"nodes in the graph, ours {node_ours}; profiler: {prof_total} "
          f"kernels in one replay, ours {prof_ours} ({prof_eager} in one "
          f"eager forward"
          f"{'; differing: ' + str(prof_diff) if prof_diff else ''}); graph "
          f"pool {pool / 2**20:.1f} MiB; recaptured after a weight edit, "
          f"after cudnn.allow_tf32 (output changed: "
          f"{not torch.equal(tf32, graphed)}) and after a .data write with "
          f"cleared fold caches", flush=True)
    return dict(forward_ms=fwd_ms, replay_ms=replay_ms, eager_ms=eager_ms,
                host_us=host_us, eager_host_us=eager_host_us,
                launches_per_batch=per_batch, kernel_nodes=nodes,
                profiler_kernels=prof_total,
                profiler_ours=prof_ours, profiler_eager_kernels=prof_eager,
                pool_bytes=pool,
                img_s=BATCH / fwd_ms * 1e3,
                eager_img_s=BATCH / eager_ms * 1e3)


def graph_pytree():
    """A captured forward over a pytree batch with an integer leaf in and
    out and two float leaves of one shape and dtype, pipelined, on the card
    and on the CPU: the same ids, float leaves within 1e-5, and grouped
    dispatch (3 forwards per replay, ragged tail) equal to the per-batch
    graph bit for bit."""
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    rng = np.random.default_rng(SEED + 17)
    lin = torch.nn.Linear(16, 8)
    x = rng.normal(size=(150, 16)).astype(np.float32)
    x2 = rng.normal(size=(150, 16)).astype(np.float32)  # x's shape and dtype
    ids = np.arange(150, dtype=np.int64)

    def fn(m, b):
        y = torch.tanh(m(b["x"]))
        return {"y": y, "y2": m(b["x2"]), "top": torch.argmax(y, -1),
                "ids": b["ids"] + 1}

    outs = {}
    for dev, k in (("cpu", 1), ("cuda", 1), ("cuda", 3)):
        eng = InferenceEngine(fn, lin, device=dev, device_batch_size=BATCH,
                              batches_per_dispatch=k)
        outs[(dev, k)] = eng({"x": x, "x2": x2, "ids": ids}, pipeline=True)
        if dev == "cuda":
            check(len(eng.graphs()) == (1 if k == 1 else 2),
                  f"[graph] pytree engine k={k}: graphs {eng.graphs()}")
    ref, got, grouped = outs[("cpu", 1)], outs[("cuda", 1)], outs[("cuda", 3)]
    check(np.array_equal(got["ids"], ids + 1) and got["ids"].dtype == np.int64
          and np.array_equal(got["top"], ref["top"]),
          "[graph] pytree engine: integer leaves differ from the CPU's")
    check(all(np.allclose(got[k], ref[k], rtol=1e-5, atol=1e-5)
              for k in ("y", "y2")),
          "[graph] pytree engine: float leaves differ from the CPU's")
    check(all(np.array_equal(grouped[k], got[k]) for k in got),
          "[graph] pytree engine: grouped dispatch differs from per-batch")
    print(f"[graph] pytree batch (two float leaves of one shape and an int "
          f"leaf) through the pipelined runner and the captured forward: int "
          f"leaves exact, float leaves within 1e-5 of the CPU; 3 forwards "
          f"per replay == 1 per replay bit for bit", flush=True)


def phase_graph(sepconv):
    """[graph]: every path of GRAPH_PATHS (see :func:`graph_path`), then
    a pytree batch and grouped dispatch (:func:`graph_pytree`)."""
    out = {}
    for tag, name, size, knobs, want, edit in GRAPH_PATHS:
        out[tag] = graph_path(sepconv, tag, name, size, knobs, want, edit)
    graph_pytree()
    return out


def concurrent_transforms(feat, df, knobs, n_threads):
    """``feat.transform(df)``'s features from ``n_threads`` threads at
    once, all through the one cached zoo engine, pipelined."""
    outs, errors = [None] * n_threads, []

    def work(i):
        try:
            outs[i] = feat.transform(df).column_to_numpy("features")
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    with env_knobs(dict(knobs, SPARKDL_PIPELINE="1")):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    check(not errors, f"[pipeline] concurrent featurizers raised {errors}")
    return outs


def phase_pipeline(sepconv):
    """[pipeline]: DeepImageFeaturizer over PIPELINE_BATCHES batches and a
    ragged tail, pipelined (the default) and serial (SPARKDL_PIPELINE=0),
    and two at once from two threads on one engine, bit for bit; img/s of
    both, the upload of one batch pageable vs
    pinned, and the runner's stage summary."""
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.parallel.pipeline import pipeline_stage_summary
    from sparkdl_tpu_torch.transformers import named_image as ni

    out = {}
    n = PIPELINE_BATCHES * BATCH + PIPELINE_TAIL
    for name, size, knobs in PIPELINE_PATHS:
        df = synthetic_frame(n, size, SEED + 13)
        feat = ni.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                      modelName=name, batchSize=BATCH)
        with env_knobs(knobs):
            feat.transform(df.limit(BATCH))  # warm: engine and graphs
            eng = ni._zoo_engine(name, True, BATCH)
            eng.metrics.counters.clear()
            eng.metrics.histograms.clear()
            runs = {}
            for mode in ("1", "0", "1", "0"):
                with env_knobs({"SPARKDL_PIPELINE": mode}):
                    t0 = time.perf_counter()
                    got = feat.transform(df).column_to_numpy("features")
                    runs.setdefault(mode, []).append(
                        (n / (time.perf_counter() - t0), got))
        summary = pipeline_stage_summary(eng.metrics)
        piped, serial = runs["1"][0][1], runs["0"][0][1]
        with env_knobs(dict(knobs, SPARKDL_BATCHES_PER_DISPATCH="3")):
            grouped = feat.transform(df).column_to_numpy("features")
        check(np.array_equal(grouped, piped),
              f"[pipeline] {name}: 3 batches per dispatch differ from one")
        check(piped.shape == (n, {"Xception": 2048,
                                  "MobileNetV2": 1280}[name]),
              f"[pipeline] {name}: feature shape {piped.shape}")
        check(all(np.array_equal(r[1], piped) for r in runs["1"] + runs["0"]),
              f"[pipeline] {name}: pipelined and serial features differ")
        conc = concurrent_transforms(feat, df, knobs, 2)
        check(all(np.array_equal(c, piped) for c in conc),
              f"[pipeline] {name}: two featurizers at once on one engine "
              f"differ from one alone")
        col = df.table.column("image")
        t0 = time.perf_counter()
        for off in range(0, n, BATCH):
            arrowStructsToBatch(col.slice(off, BATCH), size, size,
                                compact=True)
        decode_ms = (time.perf_counter() - t0) * 1e3 / -(-n // BATCH)
        piece = arrowStructsToBatch(col, size, size)[0][:BATCH]
        dev = torch.empty(piece.shape, dtype=torch.uint8, device="cuda")
        pinned = torch.from_numpy(piece).pin_memory()
        pageable_ms = cuda_ms(lambda: dev.copy_(torch.from_numpy(piece)))
        pinned_ms = cuda_ms(lambda: dev.copy_(pinned, non_blocking=True))
        ips = {m: max(r[0] for r in runs[m]) for m in runs}
        print(f"[pipeline] {name} {size}x{size} featurizer, {n} images "
              f"({PIPELINE_BATCHES} batches of {BATCH} + {PIPELINE_TAIL}): "
              f"pipelined == serial == 3 batches per dispatch == two "
              f"featurizers at once, bit for bit; "
              f"img/s pipelined "
              f"{ips['1']:.1f}, serial {ips['0']:.1f} (best of 2 each); "
              f"host decode {decode_ms:.2f} ms per batch; "
              f"upload of one batch ({piece.nbytes / 2**20:.1f} MiB): "
              f"pageable {pageable_ms:.3f} ms, pinned {pinned_ms:.3f} ms; "
              f"stages {summary}", flush=True)
        out[name] = dict(pipelined_img_s=ips["1"], serial_img_s=ips["0"],
                         decode_ms_per_batch=decode_ms,
                         pageable_upload_ms=pageable_ms,
                         pinned_upload_ms=pinned_ms, stages=summary)
    return out


SERVING_N = 96                  # seeded images a served run takes
SERVING_CLIENTS = 8             # client threads submitting them
SERVING_UDF_N = 64              # image structs through the serving UDF
SERVING_CPU_N = 8               # of them also through a CPU Server
SERVING_CPU_REL_TOL = 5e-2      # card (fused, bf16 inside) vs CPU (unfused f32)
SERVING_LOOP_S = 1.6            # a closed loop runs at least this long
SERVING_LOOP_N = 1000           # and until this many requests: p99 is the
                                # 10th slowest, never an outlier's rank
SERVING_LOOP_MAX_S = 30.0       # but never longer
SERVING_LOOP_CLIENTS = (1, 8, 32)
SERVED_XCEPTION = dict(sepconv=SEPCONV_PER_FORWARD, sepconv_tiled=0,
                       mbconv=0)
SERVED_MOBILENET = dict(sepconv=0, sepconv_tiled=0, mbconv=MBCONV_PER_FORWARD)
SERVED_ON_CPU = dict(sepconv=0, sepconv_tiled=0, mbconv=0)


def _served(srv, images, order, n_clients):
    """``images[order]`` submitted by ``n_clients`` threads (each a slice
    of the order, all futures first, then their results); rows in image
    order."""
    rows = [None] * len(images)
    errors = []

    def client(idxs):
        try:
            futs = [(int(i), srv.submit(images[int(i)])) for i in idxs]
            for i, f in futs:
                rows[i] = f.result(timeout=120)
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(order[k::n_clients],))
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not errors and not any(t.is_alive() for t in threads),
          f"served clients failed: {errors[:1]}")
    return np.stack(rows)


def _counted(sepconv, srv, per_forward, what, run):
    """``run()`` as one measured window of ``srv``: every kernel's count
    set to 0 and the server's series cleared just before it, both read just
    after.  Each kernel's count must be ``per_forward`` times the forwards
    ``srv`` ran in the window: its dispatches (``serving.batches``) and
    each capture's eager warm-up forward (``engine.graph_captures``).
    Returns ``run()``'s result, the counts, the window's counter deltas
    and its timing and histogram series."""
    before = dict(srv.metrics.counters)
    srv.metrics.reset_series()
    reset_counts(sepconv)
    result = run()
    counts = read_counts(sepconv)
    raw = srv.metrics.snapshot_raw()
    counters = {k: v - before.get(k, 0.0) for k, v in raw["counters"].items()}
    series = {**raw["timings_s"], **raw["histograms"]}
    batches = int(counters.get("serving.batches", 0))
    captures = int(counters.get("engine.graph_captures", 0))
    want = {k: n * (batches + captures) for k, n in per_forward.items()}
    check(counts == want,
          f"[serving] {what}: launches {counts}, want {want} ({batches} "
          f"dispatches + {captures} captures' warm-up forwards)")
    return result, counts, counters, series


def _add_counts(total, counts):
    for k, n in counts.items():
        total[k] += n


def closed_loop(srv, images, n_clients, sepconv):
    """``n_clients`` threads, each submitting one image and waiting for its
    row before the next, for at least SERVING_LOOP_S and SERVING_LOOP_N
    requests (at most SERVING_LOOP_MAX_S), as one counted window; returns
    requests/s, client latency p50/p99 (ms; p99 only over SERVING_LOOP_N
    or more requests), queue time p50/p99 (ms), batch fill ratio, rows and
    pad rows, batches, launches and host µs per dispatch (the engines'
    ``engine.replay_host``) of that window."""
    lat = [[] for _ in range(n_clients)]
    errors = []

    def client(k, t0):
        i = k
        try:
            while True:
                t = time.perf_counter() - t0
                if t >= SERVING_LOOP_MAX_S or (
                        t >= SERVING_LOOP_S
                        and sum(map(len, lat)) >= SERVING_LOOP_N):
                    return
                t1 = time.perf_counter()
                srv.predict(images[i % len(images)])
                lat[k].append(time.perf_counter() - t1)
                i += n_clients
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    def run():
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k, t0))
                   for k in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVING_LOOP_MAX_S + 120)
        check(not errors and not any(t.is_alive() for t in threads),
              f"closed loop at {n_clients} clients failed: {errors[:1]}")
        return time.perf_counter() - t0

    wall, counts, counters, series = _counted(
        sepconv, srv, SERVED_XCEPTION, f"closed loop at {n_clients} clients",
        run)
    allat = np.asarray([x for per in lat for x in per])
    queue = np.asarray(series.get("serving.time_in_queue", [0.0]))
    fills = series.get("serving.batch_fill_ratio", [])
    host = series.get("engine.replay_host", [])
    enough = len(allat) >= SERVING_LOOP_N
    return dict(clients=n_clients, seconds=wall, requests=int(len(allat)),
                requests_per_s=len(allat) / wall,
                p50_ms=float(np.percentile(allat, 50) * 1e3),
                p99_ms=(float(np.percentile(allat, 99) * 1e3) if enough
                        else None),
                queue_p50_ms=float(np.percentile(queue, 50) * 1e3),
                queue_p99_ms=(float(np.percentile(queue, 99) * 1e3)
                              if len(queue) >= SERVING_LOOP_N else None),
                fill_mean=float(np.mean(fills)) if fills else None,
                rows=int(counters.get("engine.rows", 0)),
                pad_rows=int(counters.get("engine.pad_rows", 0)),
                batches=int(counters.get("serving.batches", 0)),
                launches=counts,
                host_us_per_dispatch=(float(np.mean(host)) * 1e6
                                      if host else None))


def _ms(x, unit="ms", spec=".2f"):
    return "n/a" if x is None else f"{x:{spec}} {unit}"


def phase_serving(sepconv):
    """[serving]: online serving through ``sparkdl_tpu_torch.serving``:
    ``Server("Xception", featurize=True, max_batch_size=32)`` at 299x299,
    f32 with TF32 off, B1 in every dispatch.

      1. buckets [32] without ragged cuts, after ``warmup()``: 96 seeded
         images in a shuffled order from 8 client threads; every row equals
         the zoo engine's at batch 32 and ``DeepImageFeaturizer.transform``
         over the same images, bit for bit; B1 launches 30 a dispatch; the
         graph pool, given back by ``close()``;
      2. the default buckets 8/16/32 with ragged cuts: first two buckets
         captured at once by two workers (32 and 8 requests submitted
         together, no warm-up), then ``warmup()`` and seeded bursts of
         1-32 requests: rows within MAIN_PATH_REL_TOL of the single-bucket
         rows (largest difference printed); 8 of the images through a CPU
         ``Server`` (unfused f32) within SERVING_CPU_REL_TOL;
      3. closed loops of 1, 8 and 32 clients, ragged on and off (a second
         server), each at least SERVING_LOOP_S and SERVING_LOOP_N
         requests: requests/s, latency and queue p50/p99, fill, pad rows,
         host µs per dispatch;
      4. the failure domain: ``serving.model`` and ``engine.dispatch``
         transient faults absorbed by ``max_retries=1`` (health back to
         ready), ``serving.admit`` queue-full with ``retry_after_s``, an
         expired deadline shed before dispatch, ``close(drain=True)``
         serving the queue and then rejecting;
      5. MobileNetV2 at 224x224 with ``SPARKDL_MNV2_FUSED=1``: 13 B2
         launches a dispatch, served == engine bit for bit;
      6. ``register_serving_udf`` over 64 image structs through
         ``from_transformer(DeepImageFeaturizer)``: the transform's column
         bit for bit.

    Every served run above is a counted window (:func:`_counted`): the
    kernels' counts are set to 0 just before it and read just after, and
    each must be its per-forward count times the run's dispatches and
    captures.  The phase's launches are the sums of those reads; only the
    ``warmup()`` calls lie outside the windows.
    """
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch import faults
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.parallel.engine import graph_pool_bytes_held
    from sparkdl_tpu_torch.serving import (DeadlineExceededError,
                                           QueueFullError, Server,
                                           ServerClosedError,
                                           from_transformer)
    from sparkdl_tpu_torch.transformers import named_image as ni
    from sparkdl_tpu_torch.udf import UDFRegistry, register_serving_udf

    tag = "serving"
    out = {}
    size = get_model_spec("Xception").input_size[0]
    df = synthetic_frame(SERVING_N, size, SEED + 71)
    images, ok = arrowStructsToBatch(df.table.column("image"), size, size)
    check(ok.all(), f"[{tag}] synthetic images failed to decode")
    rng = np.random.default_rng(SEED + 72)
    order = rng.permutation(SERVING_N)
    total = dict(sepconv=0, sepconv_tiled=0, mbconv=0)

    # 1. one bucket: served == engine == transform, bit for bit
    t0 = time.perf_counter()
    srv = Server("Xception", featurize=True, max_batch_size=BATCH,
                 bucket_sizes=[BATCH], ragged=False, cache=False)
    srv.warmup(images[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(srv.device.type == "cuda", f"[{tag}] server not on the card")
    single, counts, counters, _ = _counted(
        sepconv, srv, SERVED_XCEPTION, "one bucket",
        lambda: _served(srv, images, order, SERVING_CLIENTS))
    _add_counts(total, counts)
    batches = int(counters["serving.batches"])
    check(single.shape == (SERVING_N, 2048) and np.isfinite(single).all(),
          f"[{tag}] served features {single.shape}, not finite 2048-d")
    engine_rows = ni._zoo_engine("Xception", True, BATCH)(images)
    feat = ni.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                  modelName="Xception", batchSize=BATCH)
    transformed = feat.transform(df).column_to_numpy("features")
    check(np.array_equal(single, engine_rows),
          f"[{tag}] served != zoo engine rows: max abs "
          f"{np.abs(single - engine_rows).max():.3g}")
    check(np.array_equal(single, transformed),
          f"[{tag}] served != DeepImageFeaturizer.transform: max abs "
          f"{np.abs(single - transformed).max():.3g}")
    pool_single = srv.graph_pool_bytes
    held = graph_pool_bytes_held()
    srv.close()
    check(srv.graph_pool_bytes == 0
          and graph_pool_bytes_held() == held - pool_single,
          f"[{tag}] close() kept {srv.graph_pool_bytes} pool bytes")
    print(f"[{tag}] Server(Xception, featurize, buckets [{BATCH}], ragged "
          f"off) {size}x{size}: warm-up (1 capture) {warm_s:.2f}s; "
          f"{SERVING_N} images in a shuffled order from {SERVING_CLIENTS} "
          f"clients in {batches} dispatches == zoo engine at batch {BATCH} "
          f"== DeepImageFeaturizer.transform, bit for bit; launches "
          f"{counts}; graph pool {pool_single / 2**20:.1f} MiB, "
          f"{srv.graph_pool_bytes / 2**20:.1f} MiB after close()",
          flush=True)
    out["single_bucket"] = dict(warmup_s=warm_s, dispatches=batches,
                                launches=counts,
                                pool_bytes=pool_single)

    # 2. buckets 8/16/32, ragged: two captures at once, then bursts
    srv = Server("Xception", featurize=True, max_batch_size=BATCH,
                 max_retries=1, cache=False)
    check(srv.bucket_sizes == [8, 16, 32],
          f"[{tag}] default buckets {srv.bucket_sizes}")
    first, counts, counters, _ = _counted(
        sepconv, srv, SERVED_XCEPTION, "two captures in flight",
        lambda: _served(srv, images[:40], np.arange(40), 2))
    _add_counts(total, counts)
    first_counts = counts
    first_buckets = sorted(srv._engines)
    captures = _engine_captures(srv._engines[first_buckets[0]])
    check(len(first_buckets) >= 2 and captures == len(first_buckets),
          f"[{tag}] first dispatches built {first_buckets} with "
          f"{captures} captures, want two or more buckets captured")
    srv.warmup(images[0])
    check(_engine_captures(srv._engines[BATCH]) == 3,
          f"[{tag}] warmup captured {_engine_captures(srv._engines[BATCH])}")
    pool_ragged = srv.graph_pool_bytes
    sizes = []

    def bursts():
        rows = [None] * SERVING_N
        i = 0
        while i < SERVING_N:
            k = min(int(rng.integers(1, BATCH + 1)), SERVING_N - i)
            futs = [(int(j), srv.submit(images[int(j)]))
                    for j in order[i:i + k]]
            for j, f in futs:
                rows[j] = f.result(timeout=120)
            sizes.append(k)
            i += k
        return np.stack(rows)

    bursty, counts, counters, series = _counted(
        sepconv, srv, SERVED_XCEPTION, "bursts", bursts)
    _add_counts(total, counts)
    bbatches = int(counters["serving.batches"])
    rel_first = _rel(first, single[:40])
    rel_bursty = _rel(bursty, single)
    max_abs = float(np.abs(bursty - single).max())
    check(rel_first <= MAIN_PATH_REL_TOL and rel_bursty <= MAIN_PATH_REL_TOL,
          f"[{tag}] buckets 8/16/32 vs one bucket: rel err {rel_first:.3g} "
          f"/ {rel_bursty:.3g} > {MAIN_PATH_REL_TOL}")
    print(f"[{tag}] buckets 8/16/32, ragged: 40 requests at once, buckets "
          f"{first_buckets} captured by two workers in flight, rows within "
          f"{rel_first:.3e} of one bucket, launches {first_counts}; then "
          f"warmup and {len(sizes)} seeded bursts "
          f"{sizes}: {bbatches} dispatches, fill "
          f"{np.mean(series['serving.batch_fill_ratio']):.3f}, pad rows "
          f"{int(counters.get('engine.pad_rows', 0))}; vs one bucket "
          f"||a-b||/||b|| = {rel_bursty:.3e}, max abs {max_abs:.3e} (tol "
          f"{MAIN_PATH_REL_TOL}); one pool for the 3 buckets "
          f"{pool_ragged / 2**20:.1f} MiB; launches {counts}", flush=True)
    out["ragged"] = dict(burst_sizes=sizes, dispatches=bbatches,
                         rel_err_vs_single=rel_bursty,
                         max_abs_vs_single=max_abs,
                         rel_err_concurrent_capture=rel_first,
                         pool_bytes=pool_ragged)

    t0 = time.perf_counter()
    with sparkdl_tpu_torch.default_device("cpu"):
        cpu_srv = Server("Xception", featurize=True,
                         max_batch_size=SERVING_CPU_N,
                         bucket_sizes=[SERVING_CPU_N], cache=False)
    with cpu_srv:
        check(cpu_srv.device.type == "cpu", f"[{tag}] CPU server device")
        cpu_rows, _, _, _ = _counted(
            sepconv, cpu_srv, SERVED_ON_CPU, "CPU server",
            lambda: _served(cpu_srv, images[:SERVING_CPU_N],
                            np.arange(SERVING_CPU_N), 1))
    cpu_s = time.perf_counter() - t0
    rel_cpu = _rel(single[:SERVING_CPU_N], cpu_rows)
    check(rel_cpu <= SERVING_CPU_REL_TOL,
          f"[{tag}] card vs CPU server: rel err {rel_cpu:.3g} > "
          f"{SERVING_CPU_REL_TOL}")
    print(f"[{tag}] {SERVING_CPU_N} images through a CPU Server (unfused "
          f"f32, {cpu_s:.1f}s): card vs CPU ||a-b||/||b|| = {rel_cpu:.3e} "
          f"(tol {SERVING_CPU_REL_TOL})", flush=True)
    out["card_vs_cpu_rel_err"] = rel_cpu

    # 3. closed loops, ragged on (this server) and off (a second one)
    flush_srv = Server("Xception", featurize=True, max_batch_size=BATCH,
                       ragged=False, cache=False)
    flush_srv.warmup(images[0])
    loops = {}
    for mode, s in (("ragged", srv), ("flush", flush_srv)):
        loops[mode] = []
        for n_clients in SERVING_LOOP_CLIENTS:
            r = closed_loop(s, images, n_clients, sepconv)
            _add_counts(total, r["launches"])
            loops[mode].append(r)
            print(f"[{tag}] closed loop, ragged {mode == 'ragged'}, "
                  f"{n_clients} clients, {r['requests']} requests in "
                  f"{r['seconds']:.2f}s: "
                  f"{r['requests_per_s']:.1f} req/s, latency p50 "
                  f"{_ms(r['p50_ms'])} p99 {_ms(r['p99_ms'])}, queue "
                  f"p50 {_ms(r['queue_p50_ms'])} p99 "
                  f"{_ms(r['queue_p99_ms'])}, fill {r['fill_mean']:.3f}, "
                  f"{r['rows']} rows + {r['pad_rows']} pad in "
                  f"{r['batches']} dispatches, launches {r['launches']}, "
                  f"host {_ms(r['host_us_per_dispatch'], 'us', '.0f')} "
                  f"per dispatch",
                  flush=True)
    pool_flush = flush_srv.graph_pool_bytes
    flush_srv.close()
    check(flush_srv.graph_pool_bytes == 0,
          f"[{tag}] flush server kept its pool after close()")
    out["closed_loop"] = loops

    # 4. the failure domain, on the ragged server
    x = images[0]

    def faulted():
        base = srv.predict(x)  # alone: bucket 8, as every predict below
        with faults.active(faults.FaultPlan.parse(
                "serving.model:error:exc=transient,times=1")):
            row = srv.predict(x)
        check(np.array_equal(row, base)
              and srv.metrics.counters.get("serving.batch_failures", 0) == 0,
              f"[{tag}] serving.model transient not absorbed by "
              f"max_retries=1")
        with faults.active(faults.FaultPlan.parse(
                "engine.dispatch:error:exc=transient,times=1")):
            row = srv.predict(x)
        health = srv.health()
        states = [t["state"] for t in health["transitions"]]
        check(np.array_equal(row, base) and health["state"] == "ready"
              and states[-2:] == ["degraded", "ready"],
              f"[{tag}] engine.dispatch transient: health "
              f"{health['state']}, transitions {states}")
        with faults.active(faults.FaultPlan.parse(
                "serving.admit:error:exc=queue_full,times=1")):
            try:
                srv.submit(x)
                fail(f"[{tag}] serving.admit queue_full did not reject")
            except QueueFullError as e:
                retry_after = e.retry_after_s
        check(retry_after > 0,
              f"[{tag}] QueueFullError without retry_after_s")
        return states, retry_after

    (states, retry_after), counts, counters, _ = _counted(
        sepconv, srv, SERVED_XCEPTION, "faults absorbed", faulted)
    _add_counts(total, counts)
    fault_b1 = counts["sepconv"]
    check(counters["serving.batches"] == 3,
          f"[{tag}] faults absorbed in {counters['serving.batches']} "
          f"dispatches, want 3")

    def shed_one():
        shed = srv.submit(x, timeout_ms=0)
        try:
            shed.result(timeout=60)
            fail(f"[{tag}] an expired deadline was served")
        except DeadlineExceededError:
            pass

    # no dispatch and no launch: the window's counts must be 0
    _, counts, counters, _ = _counted(
        sepconv, srv, SERVED_XCEPTION, "expired deadline", shed_one)
    check(counters.get("serving.batches", 0) == 0
          and counters.get("serving.shed_deadline", 0) == 1,
          f"[{tag}] the expired request reached the card")
    held = graph_pool_bytes_held()
    pool_ragged = srv.graph_pool_bytes

    def drain():
        parked = [srv.submit(images[j]) for j in range(12)]
        srv.close(drain=True)
        return np.stack([f.result(timeout=60) for f in parked])

    drained, counts, _, _ = _counted(
        sepconv, srv, SERVED_XCEPTION, "drain", drain)
    _add_counts(total, counts)
    drain_b1 = counts["sepconv"]
    try:
        srv.submit(x)
        fail(f"[{tag}] a closed server admitted a request")
    except ServerClosedError:
        pass
    check(_rel(drained, single[:12]) <= MAIN_PATH_REL_TOL
          and srv.graph_pool_bytes == 0
          and graph_pool_bytes_held() == held - pool_ragged,
          f"[{tag}] drain: rows or pool after close() wrong")
    print(f"[{tag}] failure domain: serving.model and engine.dispatch "
          f"transients absorbed by max_retries=1 (health {states}); "
          f"serving.admit queue_full -> QueueFullError(retry_after_s="
          f"{retry_after}); an expired deadline shed before dispatch (no "
          f"dispatch, no launch); close(drain=True) served 12 parked "
          f"requests, then ServerClosedError; B1 launches {fault_b1} + "
          f"{drain_b1}; pools "
          f"{pool_ragged / 2**20:.1f} + {pool_flush / 2**20:.1f} MiB "
          f"before close(), 0 after", flush=True)
    out["failure_domain"] = dict(retry_after_s=retry_after,
                                 health_transitions=states)
    out["pool_bytes_flush_server"] = pool_flush

    # 5. MobileNetV2, fused: 13 B2 a dispatch, served == engine
    os.environ["SPARKDL_MNV2_FUSED"] = "1"
    try:
        msize = get_model_spec("MobileNetV2").input_size[0]
        mdf = synthetic_frame(BATCH * 2, msize, SEED + 73)
        mimages, ok = arrowStructsToBatch(mdf.table.column("image"), msize,
                                          msize)
        with Server("MobileNetV2", featurize=True, max_batch_size=BATCH,
                    bucket_sizes=[BATCH], ragged=False, cache=False) as m:
            m.warmup(mimages[0])
            mrows, counts, counters, _ = _counted(
                sepconv, m, SERVED_MOBILENET, "MobileNetV2",
                lambda: _served(m, mimages, rng.permutation(len(mimages)),
                                SERVING_CLIENTS))
            _add_counts(total, counts)
            mb = int(counters["serving.batches"])
            pool_mnv2 = m.graph_pool_bytes
        check(m.graph_pool_bytes == 0,
              f"[{tag}] MobileNetV2 server kept its pool after close()")
        mref = ni._zoo_engine("MobileNetV2", True, BATCH)(mimages)
        check(np.array_equal(mrows, mref),
              f"[{tag}] served MobileNetV2 != engine rows: max abs "
              f"{np.abs(mrows - mref).max():.3g}")
    finally:
        del os.environ["SPARKDL_MNV2_FUSED"]
    print(f"[{tag}] Server(MobileNetV2, SPARKDL_MNV2_FUSED=1) {msize}x{msize}"
          f": {len(mimages)} images in {mb} dispatches == zoo engine at "
          f"batch {BATCH}, bit for bit; launches {counts}; pool "
          f"{pool_mnv2 / 2**20:.1f} MiB", flush=True)

    # 6. the serving UDF through from_transformer
    udf_df = synthetic_frame(SERVING_UDF_N, size, SEED + 74)
    reg = UDFRegistry()
    with from_transformer(feat, bucket_sizes=[BATCH], ragged=False,
                          cache=False) as usrv:
        register_serving_udf("xception_served", usrv, registry=reg)
        udf_col, counts, counters, _ = _counted(
            sepconv, usrv, SERVED_XCEPTION, "serving UDF",
            lambda: reg.apply("xception_served", udf_df, "image",
                              "served").column_to_numpy("served"))
        _add_counts(total, counts)
        ub = int(counters["serving.batches"])
        ucap = int(counters.get("engine.graph_captures", 0))
        pool_udf = usrv.graph_pool_bytes
    check(usrv.graph_pool_bytes == 0,
          f"[{tag}] UDF server kept its pool after close()")
    want = feat.transform(udf_df).column_to_numpy("features")
    check(np.array_equal(udf_col, want),
          f"[{tag}] serving UDF != transform: max abs "
          f"{np.abs(udf_col - want).max():.3g}")
    print(f"[{tag}] register_serving_udf over {SERVING_UDF_N} image structs "
          f"through from_transformer(DeepImageFeaturizer): == transform, "
          f"bit for bit ({ub} dispatches and {ucap} capture, launches "
          f"{counts}; pool {pool_udf / 2**20:.1f} MiB, 0 after close())",
          flush=True)
    print(f"[{tag}] launches over every counted window of the phase: "
          f"{total}", flush=True)
    out["launches"] = total
    out["pool_bytes_mobilenet"] = pool_mnv2
    out["pool_bytes_udf_server"] = pool_udf
    return out


HEAD_D = 2048                   # Xception's feature width
HEAD_CAP = 64                   # the bank's capacity (64 tenants)
HEAD_SHAPES = [(n, c) for n in (1, 7, 32) for c in (100, 129, 1000)]
HEAD_MAIN_SHAPE = (1, 100)      # the replay's pass: one row, a 100-class head
FANOUT_TENANTS = 64
FANOUT_CLASSES = 100
FANOUT_N = 96                   # seeded images the fan-out serves
FANOUT_REPLAY = 1000            # Zipf(1.1) requests over them, one client
FANOUT_BASELINE = 300           # of them through the uncached baseline
FANOUT_ZIPF = 1.1
FANOUT_CLIENTS = 8              # the warm pass's second run
FANOUT_CPU_N = 8                # images also through a CPU HeadFanoutServer
FANOUT_CPU_REL_TOL = 5e-3       # card (B1, bf16 inside) vs CPU (unfused f32)
FANOUT_BUDGET = 32 << 20        # hbm_budget_bytes of the over-budget bank
FANOUT_SWAP_S = 0.2             # the hot swap: load before and after it


def _head_bank_inputs(g, n, c):
    """Seeded H1 operands on the card: features N(0, 1), a bank of
    HEAD_CAP heads with kernels N(0, 1/D), random tenant indices with a
    repeat (the first row's head again in the last row)."""
    dev = "cuda"
    feats = torch.randn(n, HEAD_D, device=dev, generator=g)
    kernel = torch.randn(HEAD_CAP, HEAD_D, c, device=dev,
                         generator=g) / math.sqrt(HEAD_D)
    bias = torch.randn(HEAD_CAP, c, device=dev, generator=g)
    idx = torch.randint(0, HEAD_CAP, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    if n > 1:
        idx[-1] = idx[0]
    return feats, idx, kernel, bias


def phase_head_kernel():
    """[kernel] H1: the head pass (``ops/head.py``) against its plain
    version, bit for bit, at n in {1, 7, 32}, D = 2048, C in {100, 129,
    1000}, capacity 64; device ms (graph_ms), host us per call, the plain
    version's and the library's ms (``torch.bmm`` over the gathered heads
    plus the bias, never used by the port) and the bound: the bytes of the
    features, of every distinct head's kernel and bias, of the index and
    of the output, against 2 n D C f32 operations outside the tensor
    cores."""
    from sparkdl_tpu_torch.ops import head as hops

    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    rows, main = [], None
    for n, c in HEAD_SHAPES:
        args = _head_bank_inputs(g, n, c)
        feats, idx, kernel, bias = args
        out = hops._head_pass_cuda(*args)
        torch.cuda.synchronize()
        ref = hops.head_pass_reference(*args)
        check(torch.isfinite(out).all().item() and out.shape == (n, c),
              f"[kernel] H1 output at n={n} C={c}: {tuple(out.shape)}")
        check(torch.equal(out, ref),
              f"[kernel] H1 != plain version at n={n} C={c}: max abs "
              f"{(out - ref).abs().max().item():.3g}")
        rows_long = idx.long()

        def library():
            return (torch.bmm(feats[:, None], kernel[rows_long])[:, 0]
                    + bias[rows_long])

        k_ms = graph_ms(lambda: hops._head_pass_cuda(*args))
        p_ms = graph_ms(lambda: hops.head_pass_reference(*args), calls=3)
        l_ms = graph_ms(library)
        host = host_us_per_call(lambda: hops._head_pass_cuda(*args))
        distinct = int(torch.unique(idx).numel())
        nbytes = 4.0 * (n * HEAD_D + distinct * (HEAD_D * c + c) + n
                        + n * c)
        flops = 2.0 * n * HEAD_D * c
        b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
        lib_err = (library() - ref).abs().max().item()
        row = dict(shape=[n, HEAD_D, c], capacity=HEAD_CAP,
                   distinct_heads=distinct, max_abs_err=0.0, ms=k_ms,
                   plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                   bound_by=b_by, host_us_per_call=host,
                   library_max_abs_vs_plain=lib_err)
        rows.append(row)
        if (n, c) == HEAD_MAIN_SHAPE:
            main = row
        print(f"[kernel] H1 n={n} D={HEAD_D} C={c} cap={HEAD_CAP} "
              f"({distinct} distinct heads): == plain version bit for bit; "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms="
              f"{l_ms:.4f} (bmm vs plain max abs {lib_err:.2e}) "
              f"bound_ms={b_ms:.4f} ({b_by}) -> {b_ms / k_ms:.1%} of "
              f"bound; host {host:.1f} us per call", flush=True)
    return {
        "name": "head_pass", "route": "cuda",
        "source": "sparkdl_tpu_torch/ops/csrc/head_fanout.cu",
        "replaces": "sparkdl_tpu/parallel/engine.py:307",
        "tpu_kernel": False, "launches": None, "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "host_us_per_launch": main["host_us_per_call"],
        "main_shape": main["shape"], "shapes": rows,
    }


def _fanout_counted(sepconv, hops, srv, what, run):
    """``run()`` as one measured window of the fan-out server ``srv``: the
    kernels' counts (B1, B3, B2 and H1) set to 0 and the server's series
    cleared just before it, read just after.  B1 must be 30 times the
    backbone's forwards in the window (dispatches + captures' warm-up
    forwards), B3 and B2 0, and H1 the bank's head passes
    (``headbank.dispatches``; every dispatch of the phase holds one
    tenant's rows or runs on the stacked bank).  A CPU server's window
    must launch nothing.  Returns ``run()``'s result, the counts, the
    counter deltas and the series."""
    before = dict(srv.metrics.counters)
    srv.metrics.reset_series()
    reset_counts(sepconv)
    hops.head_pass.launches = 0
    result = run()
    counts = read_counts(sepconv)
    counts["head_pass"] = hops.head_pass.launches
    raw = srv.metrics.snapshot_raw()
    counters = {k: v - before.get(k, 0.0) for k, v in raw["counters"].items()}
    series = {**raw["timings_s"], **raw["histograms"]}
    batches = int(counters.get("serving.batches", 0))
    captures = int(counters.get("engine.graph_captures", 0))
    passes = int(counters.get("headbank.dispatches", 0))
    on_card = srv.device.type == "cuda"
    want = dict(sepconv=SEPCONV_PER_FORWARD * (batches + captures) * on_card,
                sepconv_tiled=0, mbconv=0, head_pass=passes * on_card)
    check(counts == want,
          f"[headfanout] {what}: launches {counts}, want {want} ({batches} "
          f"dispatches + {captures} captures, {passes} head passes)")
    return result, counts, counters, series


def _zipf_replay(rng, n_images, n_tenants, n):
    """A seeded Zipf(FANOUT_ZIPF) sequence of ``n`` (image, tenant)
    requests: image ranks by p(r) ~ 1/r^s, tenants uniform."""
    ranks = np.arange(1, n_images + 1, dtype=np.float64)
    probs = ranks ** -FANOUT_ZIPF
    probs /= probs.sum()
    return [(int(i), f"t{int(t):03d}") for i, t in zip(
        rng.choice(n_images, size=n, p=probs),
        rng.integers(0, n_tenants, size=n))]


def _timed_dispatch(bank, times):
    """Wrap ``bank.dispatch`` to record each head pass's host wall time
    (upload, launch, fetch) into ``times``; returns the undo."""
    real = bank.dispatch

    def timed(features, tenants):
        t0 = time.perf_counter()
        try:
            return real(features, tenants)
        finally:
            times.append(time.perf_counter() - t0)

    bank.dispatch = timed
    return lambda: bank.__dict__.pop("dispatch", None)


def _pcts(lat):
    a = np.asarray(lat) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def phase_headfanout(sepconv):
    """[headfanout]: the head fan-out over a zoo Xception backbone (B1) at
    299x299, f32 with TF32 off: ``HeadFanoutServer("Xception",
    max_batch_size=32, cache=InferenceCache())``, 64 tenants' seeded
    (2048, 100) heads (kernels N(0, 1/D), biases N(0, 1)) in one stacked
    bank served by kernel H1, 96 seeded images.

      1. the replay: a seeded Zipf(1.1) sequence of 1,000 (image, tenant)
         requests from one client through an uncached baseline server
         (the first 300), a cold pass (backbone dispatches == the distinct
         images) and a warm pass (no backbone dispatch), p50 / p99 of
         each, feature hits and host us per head pass; then the warm
         sequence from 8 clients.  Every row equals its per-tenant oracle
         (its feature row through H1 at n = 1, ``dense_head_row``) bit for
         bit;
      2. three mixed-tenant ``predict_batch`` calls of 32 over the 96
         images: each ONE head pass and ONE H1 launch, each row its
         oracle's bits; the 96 served feature rows (read back from the
         feature cache) equal the zoo engine's at batch 32 bit for bit;
      3. a hot swap of one tenant's head while 8 threads hammer it: no
         failed future, every row the old or the new oracle's bits,
         ``no_backbone_recompile``, ``executable_state()``, the captures
         and the cache's entries unchanged;
      4. the fallbacks: a (2048, 1000) head makes the bank indivisible, and
         a second server on the same cache with ``hbm_budget_bytes`` 32 MB
         and the 64 heads goes over budget; both serve oracle-equal rows;
      5. 8 images through a CPU ``HeadFanoutServer`` (unfused f32) within
         FANOUT_CPU_REL_TOL of the card's rows;
      6. every server's pool, 0 after ``close()``.

    Every served run is a counted window (:func:`_fanout_counted`)."""
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.ops import head as hops
    from sparkdl_tpu_torch.parallel.engine import (dense_head_row,
                                                   graph_pool_bytes_held)
    from sparkdl_tpu_torch.serving import HeadFanoutServer, InferenceCache
    from sparkdl_tpu_torch.transformers import named_image as ni
    from sparkdl_tpu_torch.utils.digest import content_digest

    tag = "headfanout"
    out = {}
    size = get_model_spec("Xception").input_size[0]
    df = synthetic_frame(FANOUT_N, size, SEED + 81)
    images, ok = arrowStructsToBatch(df.table.column("image"), size, size)
    check(ok.all(), f"[{tag}] synthetic images failed to decode")
    rng = np.random.default_rng(SEED + 82)
    heads = {f"t{i:03d}": {
        "kernel": (rng.normal(size=(HEAD_D, FANOUT_CLASSES))
                   / math.sqrt(HEAD_D)).astype(np.float32),
        "bias": rng.normal(size=(FANOUT_CLASSES,)).astype(np.float32)}
        for i in range(FANOUT_TENANTS)}
    dev_heads = {t: {k: torch.from_numpy(v).cuda() for k, v in h.items()}
                 for t, h in heads.items()}
    seq = _zipf_replay(rng, FANOUT_N, FANOUT_TENANTS, FANOUT_REPLAY)
    distinct = len({i for i, _ in seq})
    total = dict(sepconv=0, sepconv_tiled=0, mbconv=0, head_pass=0)
    cache = InferenceCache()

    def build(**kw):
        t0 = time.perf_counter()
        srv = HeadFanoutServer("Xception", max_batch_size=BATCH, **kw)
        for t, h in heads.items():
            srv.add_head(t, h)
        add_s = time.perf_counter() - t0
        check(srv.device.type == "cuda" and srv.bank.device.type == "cuda",
              f"[{tag}] fan-out server not on the card")
        return srv, add_s

    def feature_row(srv, i):
        key = srv.feature_namespace + (content_digest(images[i]),)
        row = srv.cache.get(key)
        check(row is not None, f"[{tag}] image {i} has no feature entry")
        return row

    def oracle(feats, head):
        with torch.inference_mode():
            return dense_head_row(head, torch.from_numpy(
                np.ascontiguousarray(feats)).cuda()).cpu().numpy()

    def serve_seq(srv, reqs, n_clients=1):
        """``reqs`` from ``n_clients`` closed-loop threads; (latencies,
        rows in request order, wall s)."""
        rows = [None] * len(reqs)
        lat = [None] * len(reqs)
        errors = []

        def client(k):
            try:
                for j in range(k, len(reqs), n_clients):
                    i, t = reqs[j]
                    t1 = time.perf_counter()
                    rows[j] = srv.predict(images[i], t)
                    lat[j] = time.perf_counter() - t1
            except Exception as e:  # reported below, in the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not errors and not any(th.is_alive() for th in threads),
              f"[{tag}] served clients failed: {errors[:1]}")
        return lat, rows, wall

    # 1. the replay: baseline (uncached), cold, warm, warm from 8 clients
    base, _ = build(cache=False)
    base.warmup(images[0])
    base.warm_head(np.zeros(HEAD_D, np.float32))
    (base_lat, base_rows, base_s), counts, counters, _ = _fanout_counted(
        sepconv, hops, base, "uncached baseline",
        lambda: serve_seq(base, seq[:FANOUT_BASELINE]))
    _add_counts(total, counts)
    base_dispatches = int(counters["serving.batches"])
    check(base_dispatches == FANOUT_BASELINE,
          f"[{tag}] baseline: {base_dispatches} backbone dispatches for "
          f"{FANOUT_BASELINE} uncached requests")
    pool_base = base.graph_pool_bytes
    base.close()
    check(base.graph_pool_bytes == 0,
          f"[{tag}] baseline server kept its pool after close()")

    srv, add_s = build(cache=cache)
    t0 = time.perf_counter()
    srv.warmup(images[0])
    srv.warm_head(np.zeros(HEAD_D, np.float32))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    stats = srv.head_stats()
    check(stats["mode"] == "stacked" and stats["capacity"] == FANOUT_TENANTS,
          f"[{tag}] bank {stats}")
    (cold_lat, cold_rows, cold_s), counts, counters, _ = _fanout_counted(
        sepconv, hops, srv, "cold pass", lambda: serve_seq(srv, seq))
    _add_counts(total, counts)
    cold_dispatches = int(counters["serving.batches"])
    cold_hits = int(counters.get("headfanout.feature_hits", 0))
    check(cold_dispatches == distinct,
          f"[{tag}] cold pass: {cold_dispatches} backbone dispatches for "
          f"{distinct} distinct images")
    head_times = []
    undo = _timed_dispatch(srv.bank, head_times)
    (warm_lat, warm_rows, warm_s1), counts, counters, _ = _fanout_counted(
        sepconv, hops, srv, "warm pass", lambda: serve_seq(srv, seq))
    undo()
    _add_counts(total, counts)
    check(counters.get("serving.batches", 0) == 0
          and counters["headfanout.feature_hits"] == FANOUT_REPLAY,
          f"[{tag}] warm pass: {counters.get('serving.batches', 0)} "
          f"backbone dispatches, "
          f"{counters.get('headfanout.feature_hits', 0)} feature hits")
    (m8_lat, m8_rows, m8_s), counts, counters, _ = _fanout_counted(
        sepconv, hops, srv, "warm pass, 8 clients",
        lambda: serve_seq(srv, seq, FANOUT_CLIENTS))
    _add_counts(total, counts)
    check(counters.get("serving.batches", 0) == 0,
          f"[{tag}] warm pass from 8 clients reached the backbone")
    feats = {i: feature_row(srv, i) for i in sorted({i for i, _ in seq})}
    want = {key: oracle(feats[key[0]], dev_heads[key[1]])
            for key in set(seq)}
    for what, rows, reqs in (("baseline", base_rows, seq[:FANOUT_BASELINE]),
                             ("cold", cold_rows, seq),
                             ("warm", warm_rows, seq),
                             ("warm 8 clients", m8_rows, seq)):
        bad = sum(r.tobytes() != want[key].tobytes()
                  for r, key in zip(rows, reqs))
        check(bad == 0, f"[{tag}] {what} pass: {bad} rows differ from "
                        f"their per-tenant oracle")
    replay = dict(requests=FANOUT_REPLAY, distinct_images=distinct,
                  tenants=FANOUT_TENANTS,
                  baseline=dict(requests=FANOUT_BASELINE,
                                dispatches=base_dispatches,
                                p50_ms=_pcts(base_lat)[0],
                                p99_ms=_pcts(base_lat)[1],
                                req_per_s=FANOUT_BASELINE / base_s),
                  cold=dict(dispatches=cold_dispatches,
                            feature_hits=cold_hits,
                            p50_ms=_pcts(cold_lat)[0],
                            p99_ms=_pcts(cold_lat)[1],
                            req_per_s=FANOUT_REPLAY / cold_s),
                  warm=dict(dispatches=0, feature_hits=FANOUT_REPLAY,
                            p50_ms=_pcts(warm_lat)[0],
                            p99_ms=_pcts(warm_lat)[1],
                            req_per_s=FANOUT_REPLAY / warm_s1,
                            host_us_per_head_pass=float(
                                np.mean(head_times)) * 1e6,
                            host_us_per_head_pass_p50=float(
                                np.median(head_times)) * 1e6),
                  warm_8_clients=dict(p50_ms=_pcts(m8_lat)[0],
                                      p99_ms=_pcts(m8_lat)[1],
                                      req_per_s=FANOUT_REPLAY / m8_s))
    out["replay"] = replay
    for name in ("baseline", "cold", "warm", "warm_8_clients"):
        r = replay[name]
        extra = (f", {r['dispatches']} backbone dispatches"
                 if "dispatches" in r else "")
        if "feature_hits" in r:
            extra += f", {r['feature_hits']} feature hits"
        if "host_us_per_head_pass" in r:
            extra += (f", host {r['host_us_per_head_pass']:.0f} us per head "
                      f"pass (p50 {r['host_us_per_head_pass_p50']:.0f})")
        print(f"[{tag}] replay {name}: {r['req_per_s']:.1f} req/s, latency "
              f"p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms{extra}; "
              f"every row == its per-tenant oracle, bit for bit",
              flush=True)
    print(f"[{tag}] {FANOUT_TENANTS} heads added in {add_s:.2f}s (bank "
          f"{stats['param_bytes_per_chip'] / 1e6:.1f} MB at capacity "
          f"{stats['capacity']}), warm-up (3 captures) {warm_s:.2f}s; "
          f"{distinct} distinct images in the {FANOUT_REPLAY}-request "
          f"replay, cold dispatches {cold_dispatches}, warm 0", flush=True)
    out["bank_bytes"] = stats["param_bytes_per_chip"]

    # 2. mixed-tenant batches of 32: one head pass and one H1 launch each
    tenants = list(heads)
    batch_rows = []
    for k in range(FANOUT_N // BATCH):
        idxs = list(range(k * BATCH, (k + 1) * BATCH))
        ts = [tenants[int(j)] for j in rng.integers(0, FANOUT_TENANTS,
                                                    BATCH)]
        rows, counts, counters, _ = _fanout_counted(
            sepconv, hops, srv, f"mixed batch {k}",
            lambda: srv.predict_batch([images[i] for i in idxs], ts))
        _add_counts(total, counts)
        check(counts["head_pass"] == 1
              and counters["headfanout.head_passes"] == 1,
              f"[{tag}] mixed batch {k}: {counts['head_pass']} H1 launches")
        batch_rows.append((idxs, ts, rows))
    served = np.stack([feature_row(srv, i) for i in range(FANOUT_N)])
    engine_rows = ni._zoo_engine("Xception", True, BATCH)(images)
    check(np.array_equal(served, engine_rows),
          f"[{tag}] served feature rows != zoo engine at batch {BATCH}: max "
          f"abs {np.abs(served - engine_rows).max():.3g}")
    bad = 0
    for idxs, ts, rows in batch_rows:
        for i, t, r in zip(idxs, ts, rows):
            bad += r.tobytes() != oracle(served[i], dev_heads[t]).tobytes()
    check(bad == 0, f"[{tag}] {bad} mixed-batch rows != their oracle")
    print(f"[{tag}] {FANOUT_N // BATCH} mixed-tenant predict_batch of "
          f"{BATCH}: one head pass and one H1 launch each, every row == its "
          f"oracle bit for bit; the {FANOUT_N} served feature rows == zoo "
          f"engine at batch {BATCH}, bit for bit", flush=True)

    # 3. hot swap under load
    hot_i, hot_t = seq[0]
    new_head = {"kernel": (rng.normal(size=(HEAD_D, FANOUT_CLASSES))
                           / math.sqrt(HEAD_D)).astype(np.float32),
                "bias": rng.normal(size=(FANOUT_CLASSES,)).astype(
                    np.float32)}
    ref_old = oracle(served[hot_i], dev_heads[hot_t]).tobytes()
    ref_new = oracle(served[hot_i], {k: torch.from_numpy(v).cuda()
                                     for k, v in new_head.items()}).tobytes()
    state = srv.executable_state()
    captures = srv.metrics.counters.get("engine.graph_captures", 0)
    entries = len(cache)

    def hammer_and_swap():
        got, errors = [], []
        stop = threading.Event()

        def client():
            while not stop.is_set():
                try:
                    got.append(srv.submit(images[hot_i], hot_t).result(60))
                except Exception as e:  # reported below
                    errors.append(e)

        threads = [threading.Thread(target=client)
                   for _ in range(FANOUT_CLIENTS)]
        for th in threads:
            th.start()
        time.sleep(FANOUT_SWAP_S)
        t0 = time.perf_counter()
        report = srv.swap_head(hot_t, new_head)
        swap_s = time.perf_counter() - t0
        time.sleep(FANOUT_SWAP_S)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        return got, errors, report, swap_s

    (got, errors, report, swap_s), counts, counters, _ = _fanout_counted(
        sepconv, hops, srv, "hot swap", hammer_and_swap)
    _add_counts(total, counts)
    n_old = sum(r.tobytes() == ref_old for r in got)
    n_new = sum(r.tobytes() == ref_new for r in got)
    check(not errors, f"[{tag}] hot swap: {len(errors)} failed futures: "
                      f"{errors[:1]}")
    check(n_old + n_new == len(got) and n_new > 0 and n_old > 0,
          f"[{tag}] hot swap: {len(got)} rows, {n_old} old, {n_new} new")
    check(report["no_backbone_recompile"] is True
          and srv.executable_state() == state
          and srv.metrics.counters.get("engine.graph_captures", 0) == captures
          and len(cache) == entries,
          f"[{tag}] hot swap touched the backbone: {report}")
    check(counters.get("serving.batches", 0) == 0,
          f"[{tag}] hot swap reached the backbone")
    print(f"[{tag}] hot swap of {hot_t}'s head under {FANOUT_CLIENTS} "
          f"threads: {len(got)} rows ({n_old} old head, {n_new} new, 0 "
          f"torn), 0 failed futures; swap {swap_s * 1e3:.1f} ms; "
          f"no_backbone_recompile {report['no_backbone_recompile']}, "
          f"executable_state and {int(captures)} captures unchanged, "
          f"cache {entries} entries unchanged; launches {counts}",
          flush=True)
    out["hot_swap"] = dict(rows=len(got), old=n_old, new=n_new,
                           swap_ms=swap_s * 1e3,
                           fingerprint_pinned=report["fingerprint_pinned"])
    heads[hot_t] = new_head
    dev_heads[hot_t] = {k: torch.from_numpy(v).cuda()
                        for k, v in new_head.items()}

    # 4. the fallbacks: indivisible (a 1000-class head), over budget
    wide = {"kernel": (rng.normal(size=(HEAD_D, 1000))
                       / math.sqrt(HEAD_D)).astype(np.float32),
            "bias": rng.normal(size=(1000,)).astype(np.float32)}
    srv.add_head("wide", wide)
    check(srv.head_stats()["mode"] == "fallback",
          f"[{tag}] a (2048, 1000) head did not make the bank indivisible")
    dev_wide = {k: torch.from_numpy(v).cuda() for k, v in wide.items()}
    fb_reqs = list(seq[:48]) + [(i, "wide") for i in range(16)]
    (_, fb_rows, _), counts, counters, _ = _fanout_counted(
        sepconv, hops, srv, "indivisible fallback",
        lambda: serve_seq(srv, fb_reqs))
    _add_counts(total, counts)
    bad = sum(r.tobytes() != oracle(
        served[i], dev_wide if t == "wide" else dev_heads[t]).tobytes()
        for r, (i, t) in zip(fb_rows, fb_reqs))
    check(bad == 0 and counters.get("serving.batches", 0) == 0,
          f"[{tag}] indivisible fallback: {bad} rows != oracle")
    over, _ = build(cache=cache, hbm_budget_bytes=FANOUT_BUDGET)
    ostats = over.head_stats()
    check(ostats["mode"] == "fallback"
          and "hbm_budget_bytes" in ostats["fallback_reason"],
          f"[{tag}] over-budget bank: {ostats}")
    over_reqs = seq[:64]
    (_, ob_rows, _), counts, counters, _ = _fanout_counted(
        sepconv, hops, over, "over-budget fallback",
        lambda: serve_seq(over, over_reqs))
    _add_counts(total, counts)
    bad = sum(r.tobytes() != oracle(served[i], dev_heads[t]).tobytes()
              for r, (i, t) in zip(ob_rows, over_reqs))
    check(bad == 0 and counters.get("serving.batches", 0) == 0,
          f"[{tag}] over-budget fallback: {bad} rows != oracle")
    over.close()
    check(over.graph_pool_bytes == 0, f"[{tag}] over-budget server pool")
    print(f"[{tag}] fallbacks: a (2048, 1000) head -> mode "
          f"{srv.head_stats()['mode']} (indivisible), {len(fb_reqs)} rows; "
          f"hbm_budget_bytes {FANOUT_BUDGET >> 20} MiB with "
          f"{FANOUT_TENANTS} heads -> {ostats['mode']} "
          f"({ostats['fallback_reason']}), {len(over_reqs)} rows from the "
          f"warm cache; every row == its oracle bit for bit", flush=True)

    # 5. card vs a CPU HeadFanoutServer (unfused f32) on 8 images
    t0 = time.perf_counter()
    with sparkdl_tpu_torch.default_device("cpu"):
        cpu_srv = HeadFanoutServer("Xception", max_batch_size=FANOUT_CPU_N,
                                   bucket_sizes=[FANOUT_CPU_N], cache=False)
    cpu_ts = tenants[:FANOUT_CPU_N]
    with cpu_srv:
        check(cpu_srv.device.type == "cpu"
              and cpu_srv.bank.device.type == "cpu",
              f"[{tag}] CPU server device")
        for t in cpu_ts:
            cpu_srv.add_head(t, heads[t])
        cpu_rows, _, _, _ = _fanout_counted(
            sepconv, hops, cpu_srv, "CPU server",
            lambda: np.stack(cpu_srv.predict_batch(
                list(images[:FANOUT_CPU_N]), cpu_ts)))
    cpu_s = time.perf_counter() - t0
    card_rows = np.stack(srv.predict_batch(list(images[:FANOUT_CPU_N]),
                                           cpu_ts))
    rel_cpu = _rel(card_rows, cpu_rows)
    check(rel_cpu <= FANOUT_CPU_REL_TOL,
          f"[{tag}] card vs CPU server: rel err {rel_cpu:.3g} > "
          f"{FANOUT_CPU_REL_TOL}")
    print(f"[{tag}] {FANOUT_CPU_N} images through a CPU HeadFanoutServer "
          f"(unfused f32, {cpu_s:.1f}s): card vs CPU ||a-b||/||b|| = "
          f"{rel_cpu:.3e} (tol {FANOUT_CPU_REL_TOL})", flush=True)
    out["card_vs_cpu_rel_err"] = rel_cpu

    # 6. pools
    pool = srv.graph_pool_bytes
    held = graph_pool_bytes_held()
    srv.close()
    check(srv.graph_pool_bytes == 0
          and graph_pool_bytes_held() == held - pool,
          f"[{tag}] close() kept {srv.graph_pool_bytes} pool bytes")
    print(f"[{tag}] pools: fan-out server {pool / 2**20:.1f} MiB, baseline "
          f"{pool_base / 2**20:.1f} MiB, over-budget server 0; all 0 after "
          f"close(); the feature namespace stays in the cache "
          f"({len(cache)} entries)", flush=True)
    print(f"[{tag}] launches over every counted window of the phase: "
          f"{total}", flush=True)
    out.update(pool_bytes=pool, pool_bytes_baseline=pool_base,
               launches=total)
    return out



# [obs]: observability around the served Xception (B1) and the fan-out (H1)
OBS_N = 96                      # seeded images the loops serve
OBS_LOOP_N = 1000               # requests a loop
OBS_CLIENTS = (1, 8)            # closed-loop clients of the two loops
OBS_TENANTS = 10                # tenants in turn: two past the ledger's 8
OBS_LEDGER = dict(max_tenants=8, window=6)
OBS_POLL_S = 1.0                # a monitor's health() poll during a loop
OBS_P99_MS = 100.0              # the latency objective the fault breaches
OBS_FAULT_MS = 150              # the injected serving.model sleep
OBS_SLOW_N = 4                  # requests served under it
OBS_RECOVER_MAX = 4000          # fast requests at most until it recovers
OBS_COST_FAULT_MS = 60          # an engine.dispatch sleep (metered time)
OBS_COST_N = 8                  # requests before, under and after it
OBS_SITE_CALLS = 200_000        # calls timed per instrumentation site
OBS_FANOUT_TENANTS = 16
OBS_FANOUT_IMAGES = 24          # distinct images of the fan-out requests
OBS_FANOUT_N = 200              # fan-out requests, tenants in turn
OBS_CHILD_TIMEOUT_S = 300       # a subprocess's time limit
OBS_CHILD_IMAGES = 8            # images a subprocess serves in turn


def _obs_loop(srv, images, n_clients, sepconv, tag, what):
    """OBS_LOOP_N requests from ``n_clients`` closed-loop clients (request
    i: image i mod OBS_N, tenant i mod OBS_TENANTS), with a monitor thread
    polling ``health()`` every OBS_POLL_S, as one counted window: every
    kernel's count set to 0 and the series cleared just before it, read
    just after; B1 must be 30 a forward (dispatches + captures' warm-up
    forwards).  Returns the loop's numbers, each image's first row, and
    whether every later row of an image equalled its first."""
    lat = [[] for _ in range(n_clients)]
    rows, same, errors = {}, [True], []
    lock = threading.Lock()

    def client(k):
        try:
            for i in range(k, OBS_LOOP_N, n_clients):
                j = i % len(images)
                t1 = time.perf_counter()
                row = srv.submit(images[j], tenant=f"t{i % OBS_TENANTS:02d}"
                                 ).result(timeout=120)
                lat[k].append(time.perf_counter() - t1)
                with lock:
                    first = rows.setdefault(j, row)
                    if first is not row and not np.array_equal(first, row):
                        same[0] = False
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    stop = threading.Event()

    def monitor():
        while not stop.wait(OBS_POLL_S):
            srv.health()

    before = dict(srv.metrics.counters)
    srv.metrics.reset_series()
    reset_counts(sepconv)
    poller = threading.Thread(target=monitor, daemon=True)
    poller.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    stop.set()
    poller.join(timeout=10)
    counts = read_counts(sepconv)
    check(not errors and not any(t.is_alive() for t in threads),
          f"[{tag}] {what}: clients failed: {errors[:1]}")
    counters = {k: v - before.get(k, 0.0)
                for k, v in srv.metrics.counters.items()}
    batches = int(counters.get("serving.batches", 0))
    captures = int(counters.get("engine.graph_captures", 0))
    want = {k: n * (batches + captures) for k, n in SERVED_XCEPTION.items()}
    check(counts == want,
          f"[{tag}] {what}: launches {counts}, want {want} ({batches} "
          f"dispatches + {captures} captures' warm-up forwards)")
    allat = np.asarray([x for per in lat for x in per])
    check(len(allat) == OBS_LOOP_N and len(rows) == len(images),
          f"[{tag}] {what}: {len(allat)} requests over {len(rows)} images")
    return dict(clients=n_clients, requests=int(len(allat)), seconds=wall,
                requests_per_s=len(allat) / wall,
                p50_ms=float(np.percentile(allat, 50) * 1e3),
                p99_ms=float(np.percentile(allat, 99) * 1e3),
                batches=batches, launches=counts,
                metered_s=float(counters.get("engine.device_time_s", 0.0))
                ), rows, same[0]


def _obs_chains(spans):
    """The span chains of a loop's ring: every ``serving.request`` root
    whose trace a ``serving.microbatch`` covers (its own trace or a member)
    that has an ``engine.call`` child carrying ``device_ms`` (CUDA timing
    events) with an ``engine.dispatch`` child.  Returns (requests, covered
    requests, micro-batches, device ms of every engine.call)."""
    by_id = {s["span_id"]: s for s in spans}
    children = {}
    for s in spans:
        children.setdefault(s["parent_id"], []).append(s)
    covered, device_ms, batches = set(), [], 0
    for b in spans:
        if b["name"] != "serving.microbatch":
            continue
        batches += 1
        parent = by_id.get(b["parent_id"])
        if parent is None or parent["name"] != "serving.request":
            continue
        for c in children.get(b["span_id"], []):
            ms = (c.get("attrs") or {}).get("device_ms")
            if c["name"] != "engine.call" or not ms or ms <= 0:
                continue
            if any(d["name"] == "engine.dispatch"
                   for d in children.get(c["span_id"], [])):
                covered.update(b["attrs"]["member_traces"])
                device_ms.append(ms)
    reqs = [s["trace_id"] for s in spans if s["name"] == "serving.request"]
    return len(reqs), sum(t in covered for t in reqs), batches, device_ms


def _obs_child(code, env_extra, cwd):
    """Start ``python -c code`` from the checkout with ``env_extra``."""
    env = dict(os.environ, **env_extra)
    for k in ("SPARKDL_TRACE", "SPARKDL_BLACKBOX", "SPARKDL_COST",
              "SPARKDL_FAULTS"):
        if k not in env_extra:
            env.pop(k, None)
    return subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


_OBS_CHILD_HEAD = f"""
import itertools, os, sys
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from sparkdl_tpu_torch.serving import InferenceCache, Server
imgs = np.random.default_rng({SEED + 93}).integers(
    0, 256, ({OBS_CHILD_IMAGES}, 299, 299, 3), dtype=np.uint8)
"""
# SPARKDL_TRACE=<dir>: serve, exit; the atexit hook flushes both artifacts
_OBS_TRACE_CHILD = _OBS_CHILD_HEAD + f"""
with Server("Xception", featurize=True, max_batch_size=8,
            cache=False) as srv:
    for i in range({2 * OBS_CHILD_IMAGES}):
        srv.predict(imgs[i % {OBS_CHILD_IMAGES}])
print(os.getpid(), flush=True)
"""
# SPARKDL_BLACKBOX=<dir>: serve (cache misses, then hits) until SIGTERM
_OBS_BLACKBOX_CHILD = _OBS_CHILD_HEAD + f"""
with Server("Xception", featurize=True, max_batch_size=8,
            cache=InferenceCache()) as srv:
    srv.predict(imgs[0])
    print(os.getpid(), "serving", flush=True)
    for i in itertools.count():
        srv.predict(imgs[i % {OBS_CHILD_IMAGES}])
"""


def _obs_children(tag):
    """The two subprocesses, run at once: one with ``SPARKDL_TRACE=<dir>``
    that serves and exits (``trace_<pid>.json`` and ``spans_<pid>.jsonl``,
    read back by ``load_spans``), one with ``SPARKDL_BLACKBOX=<dir>`` sent
    SIGTERM while it serves (its dump read back by ``load_flight``).
    Both are stopped whatever happens."""
    import signal
    import tempfile

    from sparkdl_tpu_torch.obs.export import load_spans
    from sparkdl_tpu_torch.obs.flight import load_flight

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tdir, \
            tempfile.TemporaryDirectory() as bdir:
        t0 = time.perf_counter()
        tracer = _obs_child(_OBS_TRACE_CHILD, {"SPARKDL_TRACE": tdir}, root)
        boxed = _obs_child(_OBS_BLACKBOX_CHILD, {"SPARKDL_BLACKBOX": bdir},
                           root)
        try:
            line = boxed.stdout.readline()
            if not line.strip().endswith("serving"):
                boxed.wait(timeout=OBS_CHILD_TIMEOUT_S)
                fail(f"[{tag}] blackbox child did not start serving: "
                     f"{line!r} {boxed.stderr.read()[-2000:]}")
            time.sleep(1.0)
            boxed.send_signal(signal.SIGTERM)
            b_out, b_err = boxed.communicate(timeout=OBS_CHILD_TIMEOUT_S)
            t_out, t_err = tracer.communicate(timeout=OBS_CHILD_TIMEOUT_S)
        finally:
            for p in (tracer, boxed):
                if p.poll() is None:
                    p.kill()
                    p.wait()
        child_s = time.perf_counter() - t0
        check(tracer.returncode == 0,
              f"[{tag}] SPARKDL_TRACE child exited {tracer.returncode}: "
              f"{t_err[-2000:]}")
        pid = int(t_out.split()[-1])
        chrome = os.path.join(tdir, f"trace_{pid}.json")
        jsonl = os.path.join(tdir, f"spans_{pid}.jsonl")
        check(os.path.exists(chrome) and os.path.exists(jsonl),
              f"[{tag}] SPARKDL_TRACE child left {os.listdir(tdir)}")
        spans, from_chrome = load_spans(jsonl), load_spans(chrome)
        n_req = sum(s["name"] == "serving.request" for s in spans)
        timed = [s for s in spans if s["name"] == "engine.call"
                 and (s.get("attrs") or {}).get("device_ms", 0) > 0]
        check(n_req == 2 * OBS_CHILD_IMAGES and timed
              and len(from_chrome) == len(spans)
              and [s["span_id"] for s in from_chrome]
              == [s["span_id"] for s in spans],
              f"[{tag}] trace artifacts: {n_req} request spans, "
              f"{len(timed)} timed engine calls, {len(spans)} / "
              f"{len(from_chrome)} spans (JSONL / Chrome)")
        check(boxed.returncode == -signal.SIGTERM,
              f"[{tag}] SPARKDL_BLACKBOX child exited {boxed.returncode} "
              f"after SIGTERM: {b_err[-2000:]}")
        bpid = int(line.split()[0])
        dump = os.path.join(bdir, f"flight_{bpid}.jsonl")
        check(os.path.exists(dump),
              f"[{tag}] SIGTERM left no dump: {os.listdir(bdir)}")
        events = load_flight(dump)
        names = {e["event"] for e in events}
        check(events and {"cache.miss", "cache.hit"} <= names
              and [e["seq"] for e in events]
              == sorted(e["seq"] for e in events),
              f"[{tag}] SIGTERM dump: {len(events)} events, {sorted(names)}")
        out.update(children_s=child_s, trace_spans=len(spans),
                   trace_request_spans=n_req,
                   trace_device_ms=[round(s["attrs"]["device_ms"], 3)
                                    for s in timed[:4]],
                   sigterm_events=len(events), sigterm_names=sorted(names))
        print(f"[{tag}] subprocesses ({child_s:.1f}s, run at once): "
              f"SPARKDL_TRACE=<dir> left trace_{pid}.json and "
              f"spans_{pid}.jsonl ({len(spans)} spans, {n_req} requests, "
              f"read back by load_spans from both); SPARKDL_BLACKBOX=<dir> "
              f"sent SIGTERM while serving: exit {boxed.returncode}, "
              f"flight_{bpid}.jsonl holds {len(events)} events "
              f"({', '.join(sorted(names))}), read by load_flight",
              flush=True)
    return out


def _site_us(fn, calls=OBS_SITE_CALLS):
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def phase_obs(sepconv):
    """[obs]: observability (``sparkdl_tpu_torch.obs``) around the served
    Xception at 299x299 (B1, 30 launches a forward) and the head fan-out
    (H1), f32 with TF32 off.

      1. the loops: ``Server("Xception", featurize=True,
         max_batch_size=32)`` over OBS_N seeded images, OBS_LOOP_N
         requests from 1 and from 8 closed-loop clients, OBS_TENANTS
         tenants in turn, a monitor polling ``health()`` every OBS_POLL_S;
         each loop twice on a server with tracing, the flight recorder,
         ``slos=`` and ``cost=CostLedger(max_tenants=8, window=6)`` all
         on, and twice on a server with all of them off, in the order
         off, on, on, off; req/s, p50, p99 and the overhead (the mean of
         the two runs on over the mean of the two off).  Rows on == rows off, bit for bit (both loops run in
         the 8-row bucket); every request's trace reaches request ->
         micro-batch -> ``engine.call`` (``device_ms`` from CUDA events)
         -> ``engine.dispatch``; the ledger conserves the metered seconds
         (1e-6) and folds ``__overflow__``; ``varz()`` has ``cost`` and
         ``exemplars`` and passes through ``json.dumps``;
      2. faults: OBS_SLOW_N requests under ``serving.model:sleep`` breach
         the p99 objective (health degraded naming it, ``slo.breach``),
         fast traffic recovers it (``slo.recovered``); a pinned cost
         baseline, then an ``engine.dispatch`` sleep (inside the metered
         engine call) opens ``cost.regression``, and fast traffic closes
         it (``cost.recovered``);
      3. two subprocesses at once (:func:`_obs_children`);
      4. ``HeadFanoutServer("Xception", cost=...)`` with the recorder:
         ``head.swap`` per mutation, ``cache.feature_hit`` per warm
         request, a cost line per tenant, B1 and H1 counted;
      5. us per call of the instrumentation sites, disabled and enabled.
    """
    from sparkdl_tpu_torch import faults
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.obs import cost as ocost
    from sparkdl_tpu_torch.obs import flight as oflight
    from sparkdl_tpu_torch.obs import trace as otrace
    from sparkdl_tpu_torch.obs.cost import OVERFLOW_TENANT, CostLedger
    from sparkdl_tpu_torch.obs.slo import SLO
    from sparkdl_tpu_torch.ops import head as hops
    from sparkdl_tpu_torch.serving import (HeadFanoutServer, InferenceCache,
                                           Server)

    tag = "obs"
    out = {}
    size = get_model_spec("Xception").input_size[0]
    df = synthetic_frame(OBS_N, size, SEED + 91)
    images, ok = arrowStructsToBatch(df.table.column("image"), size, size)
    check(ok.all(), f"[{tag}] synthetic images failed to decode")

    def obs_off():
        otrace.configure(enabled=False)
        oflight.configure(enabled=False)

    def obs_on():
        return (otrace.configure(enabled=True),
                oflight.configure(enabled=True))

    # 1. the loops
    obs_off()
    ledger = CostLedger(**OBS_LEDGER)
    slos = [SLO("serving-availability", "availability",
                good="serving.completed", total="serving.requests",
                objective=0.999),
            SLO("serving-p99", "latency", series="serving.request_latency",
                threshold_ms=OBS_P99_MS)]
    t0 = time.perf_counter()
    off = Server("Xception", featurize=True, max_batch_size=BATCH,
                 cache=False, cost=False)
    on = Server("Xception", featurize=True, max_batch_size=BATCH,
                cache=False, cost=ledger, slos=slos)
    off.warmup(images[0])
    on.warmup(images[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(off.device.type == "cuda" and on.device.type == "cuda",
          f"[{tag}] servers not on the card")
    loops, events = {}, {}
    b1_total, metered = 0, 0.0
    for clients in OBS_CLIENTS:
        # off, on, on, off: a drift over the four runs falls on both sides
        runs, rows = {"off": [], "on": []}, []
        dev_ms = []
        for mode in ("off", "on", "on", "off"):
            what = f"{clients} client(s), observability {mode}"
            if mode == "on":
                tracer, recorder = obs_on()
            else:
                obs_off()
            res, run_rows, same = _obs_loop(on if mode == "on" else off,
                                            images, clients, sepconv, tag,
                                            what)
            check(same, f"[{tag}] {what}: an image's rows differ between "
                  f"its requests")
            rows.append(run_rows)
            b1_total += res["launches"]["sepconv"]
            if mode == "on":
                metered += res["metered_s"]
                n_req, n_cov, n_batches, ms = _obs_chains(tracer.snapshot())
                check(n_req == OBS_LOOP_N and n_cov == OBS_LOOP_N
                      and len(ms) == n_batches == res["batches"],
                      f"[{tag}] {what}: {n_cov} of {n_req} requests reach "
                      f"request -> micro-batch -> engine.call (device_ms) -> "
                      f"engine.dispatch; {len(ms)} timed of {n_batches} "
                      f"batches ({res['batches']} dispatches)")
                dev_ms += ms
                events[clients] = sorted(
                    {e["event"] for e in recorder.snapshot()})
            runs[mode].append(res)
            print(f"[{tag}] {what}: {res['requests_per_s']:.1f} req/s, p50 "
                  f"{res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
                  f"{res['batches']} dispatches, launches "
                  f"{res['launches']}", flush=True)
        obs_off()
        check(all(np.array_equal(r[j], rows[0][j])
                  for r in rows[1:] for j in range(OBS_N)),
              f"[{tag}] {clients} client(s): rows with observability on "
              f"differ from rows with it off")

        def mean(mode, key):
            return float(np.mean([r[key] for r in runs[mode]]))

        overhead = {k: mean("on", k) / mean("off", k) - 1
                    for k in ("requests_per_s", "p50_ms", "p99_ms")}
        loops[clients] = dict(runs=runs, overhead=overhead, device_ms=dict(
            p50=float(np.percentile(dev_ms, 50)),
            p99=float(np.percentile(dev_ms, 99)), n=len(dev_ms)))
        print(f"[{tag}] {clients} client(s), two runs each: overhead of "
              f"observability {overhead['requests_per_s'] * 100:+.2f}% "
              f"req/s, {overhead['p50_ms'] * 100:+.2f}% p50, "
              f"{overhead['p99_ms'] * 100:+.2f}% p99; rows on == rows off "
              f"bit for bit; every request reaches request -> micro-batch "
              f"-> engine.call -> engine.dispatch; device_ms (CUDA events) "
              f"p50 {np.percentile(dev_ms, 50):.3f} p99 "
              f"{np.percentile(dev_ms, 99):.3f} over {len(dev_ms)} "
              f"dispatches", flush=True)
    snap = ledger.snapshot()
    tot = snap["totals"]
    cons = abs(tot["attributed_device_s"] - tot["device_s"]) / tot["device_s"]
    vs_engine = abs(tot["device_s"] - metered) / metered
    check(cons <= 1e-6 and vs_engine <= 1e-6
          and tot["rows"] == 2 * len(OBS_CLIENTS) * OBS_LOOP_N
          and OVERFLOW_TENANT in snap["tenants"]
          and snap["tracked_tenants"] == OBS_LEDGER["max_tenants"],
          f"[{tag}] cost: attributed vs metered {cons:.3g}, ledger vs the "
          f"engine's metered seconds {vs_engine:.3g}, rows {tot['rows']}, "
          f"tenants {sorted(snap['tenants'])}")
    doc = on.varz()
    text = json.dumps(doc)
    check(doc["cost"] is not None and doc["exemplars"]
          and doc["health"]["slo"]["state"] == "ok",
          f"[{tag}] varz: cost {doc['cost'] is not None}, "
          f"{len(doc['exemplars'])} exemplars, slo "
          f"{doc['health']['slo']['state']}")
    print(f"[{tag}] cost: {tot['batches']} batches, {tot['rows']} rows, "
          f"{tot['pad_rows']} pad rows, {tot['device_s']:.6f} s metered "
          f"== tenants + __pad__ to {cons:.2e} and == the engine's "
          f"{metered:.6f} s to {vs_engine:.2e}; tenants "
          f"{sorted(snap['tenants'])}; sentinel open "
          f"{sorted(snap['sentinel']['open'])}; varz {len(text)} bytes "
          f"of JSON with {len(doc['exemplars'])} exemplars (slowest "
          f"{doc['exemplars'][0]['duration_ms']:.3f} ms); flight events in "
          f"the last loops: {events}", flush=True)
    out.update(warmup_s=warm_s, loops=loops, cost_totals=tot,
               conservation_rel=cons, ledger_vs_engine_rel=vs_engine,
               tenants=sorted(snap["tenants"]), loop_events=events,
               varz_bytes=len(text))
    off.close()

    # 2. faults: an SLO breach and recovery, a cost regression and recovery
    tracer, recorder = obs_on()

    def serve(n, clients=1):
        def client(k):
            for i in range(k, n, clients):
                on.predict(images[i % OBS_N])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)

    on.metrics.reset_series()
    check(on.health()["slo"]["state"] == "ok", f"[{tag}] SLO not ok at rest")
    with faults.active(faults.FaultPlan.parse(
            f"serving.model:sleep:ms={OBS_FAULT_MS}")):
        serve(OBS_SLOW_N)
    h = on.health()
    names = [e["event"] for e in recorder.snapshot()]
    err = h["last_error"] or {}
    check(h["slo"]["state"] == "breach" and h["state"] == "degraded"
          and err.get("type") == "SLOViolation"
          and "serving-p99" in err.get("error", "")
          and "slo.breach" in names,
          f"[{tag}] serving.model sleep: slo {h['slo']['state']}, health "
          f"{h['state']}, last_error {err}, events {names}")
    p99_breach = h["slo"]["objectives"][1]["p99_ms"]
    recover_n = 0
    while recover_n < OBS_RECOVER_MAX:
        serve(200, clients=8)
        recover_n += 200
        if on.health()["slo"]["state"] == "ok":
            break
    names = [e["event"] for e in recorder.snapshot()]
    check("slo.recovered" in names,
          f"[{tag}] no slo.recovered after {recover_n} fast requests")
    print(f"[{tag}] SLO: {OBS_SLOW_N} requests under serving.model:sleep "
          f"{OBS_FAULT_MS} ms: p99 {p99_breach:.1f} ms > {OBS_P99_MS} ms, "
          f"health degraded naming serving-p99, slo.breach; recovered "
          f"(slo.recovered) after {recover_n} fast requests", flush=True)
    serve(OBS_COST_N)
    program = f"{on.model_desc}/b8"
    pinned = ledger.pin_baseline(program)
    with faults.active(faults.FaultPlan.parse(
            f"engine.dispatch:sleep:ms={OBS_COST_FAULT_MS}")):
        serve(OBS_COST_N)
    opened = ledger.regressions()
    serve(4 * OBS_COST_N)
    names = [e["event"] for e in recorder.snapshot()]
    check(program in opened and "cost.regression" in names
          and "cost.recovered" in names and not ledger.regressions(),
          f"[{tag}] cost sentinel: open {opened}, now "
          f"{ledger.regressions()}, events {names}")
    print(f"[{tag}] cost sentinel: baseline pinned at "
          f"{pinned[program] * 1e6:.1f} us/row; engine.dispatch sleep "
          f"{OBS_COST_FAULT_MS} ms opened cost.regression on {program} "
          f"(factor {opened[program]['factor']}); {4 * OBS_COST_N} fast "
          f"requests closed it (cost.recovered)", flush=True)
    out.update(slo_breach_p99_ms=p99_breach, slo_recover_requests=recover_n,
               cost_regression_factor=opened[program]["factor"])
    pool = on.graph_pool_bytes
    on.close()
    check(on.graph_pool_bytes == 0, f"[{tag}] close() kept the pool")

    # 3. the subprocesses
    obs_off()
    out["children"] = _obs_children(tag)

    # 4. the head fan-out under observability
    tracer, recorder = obs_on()
    rng = np.random.default_rng(SEED + 92)
    heads = {f"t{i:02d}": {
        "kernel": (rng.normal(size=(HEAD_D, FANOUT_CLASSES))
                   / math.sqrt(HEAD_D)).astype(np.float32),
        "bias": rng.normal(size=(FANOUT_CLASSES,)).astype(np.float32)}
        for i in range(OBS_FANOUT_TENANTS)}
    fledger = CostLedger(max_tenants=2 * OBS_FANOUT_TENANTS)
    fan = HeadFanoutServer("Xception", max_batch_size=BATCH,
                           cache=InferenceCache(), cost=fledger)
    for t, h in heads.items():
        fan.add_head(t, h)
    fan.warmup(images[0])
    fan.warm_head(np.zeros(HEAD_D, np.float32))
    reqs = [(i % OBS_FANOUT_IMAGES, f"t{i % OBS_FANOUT_TENANTS:02d}")
            for i in range(OBS_FANOUT_N)]

    def fan_run():
        fan_rows = [fan.predict(images[i], t) for i, t in reqs]
        fan.swap_head("t00", heads["t01"])
        return fan_rows

    fan_rows, counts, counters, _ = _fanout_counted(
        sepconv, hops, fan, "fan-out under observability", fan_run)
    check(all(np.isfinite(r).all() and r.shape == (FANOUT_CLASSES,)
              for r in fan_rows), f"[{tag}] fan-out rows")
    events = recorder.snapshot()
    swaps = [e for e in events if e["event"] == "head.swap"]
    fhits = [e for e in events if e["event"] == "cache.feature_hit"]
    fsnap = fledger.snapshot()
    per_tenant = {t: v["rows"] + v["feature_hits"] + v["hits"]
                  + v["coalesced"] for t, v in fsnap["tenants"].items()}
    want_tenant = {t: sum(1 for _, u in reqs if u == t) for t in heads}
    check(len(swaps) == OBS_FANOUT_TENANTS + 1
          and len(fhits) == int(counters["headfanout.feature_hits"])
          == OBS_FANOUT_N - OBS_FANOUT_IMAGES
          and per_tenant == want_tenant
          and json.dumps(fan.varz()) and fan.varz()["cost"] == fsnap,
          f"[{tag}] fan-out: {len(swaps)} head.swap, {len(fhits)} "
          f"cache.feature_hit ({counters.get('headfanout.feature_hits')} "
          f"hits), tenants {per_tenant} want {want_tenant}")
    fpool = fan.graph_pool_bytes
    fan.close()
    obs_off()
    print(f"[{tag}] HeadFanoutServer(Xception, cost=) with the recorder: "
          f"{len(swaps)} head.swap ({OBS_FANOUT_TENANTS} adds + 1 swap), "
          f"{len(fhits)} cache.feature_hit of {OBS_FANOUT_N} requests, a "
          f"cost line per tenant ({len(fsnap['tenants'])}: rows "
          f"{fsnap['totals']['rows']}, feature hits "
          f"{fsnap['totals']['feature_hits']}); launches {counts}",
          flush=True)
    b1_total += counts["sepconv"]
    out["fanout"] = dict(head_swaps=len(swaps), feature_hits=len(fhits),
                         tenants=len(fsnap["tenants"]), launches=counts,
                         pool_bytes=fpool)

    # 5. the instrumentation sites, disabled and enabled
    off_tracer = otrace.configure(enabled=False)
    on_tracer = otrace.Tracer(enabled=True, capacity=1024)
    off_ledger, on_ledger = CostLedger(enabled=False), CostLedger()
    oflight.configure(enabled=False)

    def span_site(tr):
        def site():
            with tr.span("engine.dispatch", rows=8):
                pass
        return site

    def charge(led):
        return lambda: led.record_batch(
            model="Xception", bucket=8, tenant_rows={"t00": 3},
            device_s=0.007, pad_rows=5, hbm_bytes=8e7)

    sites = dict(span_disabled_us=_site_us(span_site(off_tracer)),
                 span_enabled_us=_site_us(span_site(on_tracer)),
                 record_batch_disabled_us=_site_us(charge(off_ledger)),
                 record_batch_enabled_us=_site_us(charge(on_ledger)),
                 emit_disabled_us=_site_us(
                     lambda: oflight.emit("cache.hit", hits=1)))
    rec = oflight.configure(enabled=True, capacity=1024)
    sites["emit_enabled_us"] = _site_us(
        lambda: oflight.emit("cache.hit", hits=1))
    obs_off()
    ocost.configure(None)
    check(rec is not None and len(on_tracer) == 1024,
          f"[{tag}] instrumentation sites")
    print(f"[{tag}] us per call ({OBS_SITE_CALLS} calls): span site "
          f"disabled {sites['span_disabled_us']:.3f} / enabled "
          f"{sites['span_enabled_us']:.3f}; record_batch disabled "
          f"{sites['record_batch_disabled_us']:.3f} / enabled "
          f"{sites['record_batch_enabled_us']:.3f}; flight emit disabled "
          f"{sites['emit_disabled_us']:.3f} / enabled "
          f"{sites['emit_enabled_us']:.3f}", flush=True)
    out.update(sites=sites, pool_bytes=pool,
               launches=dict(sepconv=b1_total,
                             head_pass=counts["head_pass"]))
    print(f"[{tag}] launches over every counted window of the phase: B1 "
          f"{b1_total}, H1 {counts['head_pass']}", flush=True)
    return out


FLEET_N = 48                    # seeded images the fleet serves
FLEET_BATCH = 8                 # max_batch_size, and the fleet's one bucket
FLEET_CLIENTS = 8               # closed-loop clients of the load
FLEET_WINDOW = 300              # completed requests a measured window
FLEET_V3_WINDOW = 120           # completed requests under the v3 canary
FLEET_NOISE = 1e-3              # v2, v3: each float weight x (1 + 1e-3 N(0,1))
FLEET_TENANTS = ("gold", "silver", "metered")   # request j of client k: k+j
FLEET_METERED_BURST = 5         # the metered tenant's quota: burst 5, 1e-4/s
FLEET_OVERHEAD_N = 500          # one client's loop, fleet vs the bare server
FLEET_OVERHEAD_RUNS = 3         # runs a side, in turns
FLEET_TRACED_N = 16             # requests with tracing on
FLEET_FANOUT_TENANTS = 16
FLEET_FANOUT_IMAGES = 24
FLEET_FANOUT_N = 200            # fan-out requests, one swap_head midway


def _perturbed(state, seed):
    """``state`` with each floating tensor multiplied by 1 + FLEET_NOISE *
    N(0, 1), drawn from a numpy seed in the state's order."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in state.items():
        if t.is_floating_point():
            noise = torch.from_numpy(rng.normal(size=tuple(t.shape)))
            out[k] = t * (1 + FLEET_NOISE * noise.to(t.dtype))
        else:
            out[k] = t.clone()
    return out


def _fleet_oracle(fn, state, images):
    """A version's rows from a bare engine at the fleet's bucket shape, over
    a fresh Xception holding ``state``; the engine's graph is released
    after."""
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    module = get_model_spec("Xception").build().eval()
    module.load_state_dict(state)
    eng = InferenceEngine(fn, module, device_batch_size=FLEET_BATCH)
    rows = eng(images)
    eng.release_graphs()
    return rows


def _fleet_counts(sepconv, servers, before, warmups, what):
    """The launches of a counted window over ``servers`` (every server that
    dispatched in it, by name; ``before`` their counters when it began,
    missing for a server made inside it): B1 must be 30 a forward, the
    forwards being the dispatches, each capture's eager warm-up forward and
    the ``warmups`` warm-up dispatches made in it; B3 and B2 0."""
    counts = read_counts(sepconv)
    forwards = warmups
    for name, srv in servers.items():
        b = before.get(name, {})
        c = srv.metrics.counters
        forwards += int(c.get("serving.batches", 0)
                        - b.get("serving.batches", 0))
        forwards += int(c.get("engine.graph_captures", 0)
                        - b.get("engine.graph_captures", 0))
    want = dict(sepconv=SEPCONV_PER_FORWARD * forwards, sepconv_tiled=0,
                mbconv=0)
    check(counts == want, f"[fleet] {what}: launches {counts}, want {want} "
                          f"({forwards} forwards)")
    return counts


def phase_fleet(sepconv):
    """[fleet]: the model fleet (``sparkdl_tpu_torch.serving.fleet``) over
    a zoo Xception at 299x299 (B1, 30 launches a forward), f32 with TF32
    off.  ``Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
    cost=CostLedger())`` with entry ``xc``: v1 the zoo Xception, v2 and v3
    its weights with every float tensor x (1 + 1e-3 N(0,1)), two seeds; the
    oracles are each version's rows from a bare engine at batch 8 over a
    fresh Xception, computed first.

      1. the fleet's overhead: one client's loop of 500 requests through
         ``Fleet.submit`` and through the bare v1 ``Server``, three runs a
         side in turns;
      2. the load: 8 closed-loop clients, tenants gold (``PRIORITY_HIGH``),
         silver and metered (``TenantQuota(rate_per_s=1e-4, burst=5)``) in
         turn, over 48 seeded images.  Windows of 300 completed requests
         before the rollout, during a canary of v2 at fraction 0.5 (the
         canary captured under the load), after the promote (the first
         attempt failing under ``fleet.swap:error:at=1,times=1``, v1 still
         deployed, the retry promoting), then 120 under a v3 canary and its
         rollback.  Every row its version's oracle row bit for bit, both
         v1 and v2 served, metered admitted at most 5 times,
         ``no_recompile``, no capture on either server between the
         canary's warm-up and the promote, every bucket graph (30, 0, 0)
         launches, the drained versions' pools released, the ``rollout.*``
         and ``fleet.shed`` events; req/s, p50, p99 a window, the pools,
         the shared ledger's metered seconds and whether
         ``cost.regression`` opened while two versions replayed;
      3. 16 requests with tracing on: each ``fleet.request`` span parents
         its server's request span; ``varz()`` through ``json.dumps``,
         ``health()`` ready;
      4. the fan-out entry: ``add_fanout_model("xc-heads", "Xception")``
         with 16 tenants' f32 heads (C 100), 200 requests from 8 clients
         with one ``swap_head`` midway: every row its tenant's oracle (the
         zoo engine's feature row through the head alone) bit for bit, B1
         and H1 counted.
    """
    from sparkdl_tpu_torch import faults
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.obs import flight as oflight
    from sparkdl_tpu_torch.obs import trace as otrace
    from sparkdl_tpu_torch.obs.cost import CostLedger
    from sparkdl_tpu_torch.ops import head as hops
    from sparkdl_tpu_torch.parallel.engine import (dense_head_row,
                                                   graph_pool_bytes_held)
    from sparkdl_tpu_torch.serving import (Fleet, QuotaExceededError,
                                           ServiceUnavailableError,
                                           TenantQuota)
    from sparkdl_tpu_torch.serving.fleet import PRIORITY_HIGH
    from sparkdl_tpu_torch.transformers import named_image as ni

    tag = "fleet"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(card=card)
    size = get_model_spec("Xception").input_size[0]
    df = synthetic_frame(FLEET_N, size, SEED + 101)
    images, ok = arrowStructsToBatch(df.table.column("image"), size, size)
    check(ok.all(), f"[{tag}] synthetic images failed to decode")

    # 1. setup: the oracles first, then the fleet
    t0 = time.perf_counter()
    fn = ni.zoo_model_fn("Xception", True)
    v1_state = {k: t.clone() for k, t in
                ni._cached_model("Xception").state_dict().items()}
    states = {1: v1_state, 2: _perturbed(v1_state, SEED + 102),
              3: _perturbed(v1_state, SEED + 103)}
    oracle = {v: _fleet_oracle(fn, st, images) for v, st in states.items()}
    oracle_s = time.perf_counter() - t0
    check(all(np.isfinite(oracle[v]).all()
              and oracle[v].shape == (FLEET_N, 2048) for v in oracle)
          and not np.array_equal(oracle[2], oracle[1])
          and not np.array_equal(oracle[3], oracle[1]),
          f"[{tag}] oracles: finite (N, 2048) rows, v2 and v3 apart from v1")
    recorder = oflight.configure(enabled=True, capacity=1 << 16)
    otrace.configure(enabled=False)
    ledger = CostLedger()
    t0 = time.perf_counter()
    fleet = Fleet(max_batch_size=FLEET_BATCH, max_wait_ms=2,
                  bucket_sizes=[FLEET_BATCH], cost=ledger,
                  quotas={"gold": TenantQuota(priority=PRIORITY_HIGH),
                          "metered": TenantQuota(
                              rate_per_s=1e-4, burst=FLEET_METERED_BURST)})
    fleet.add_model("xc", "Xception", featurize=True,
                    warm_example=images[0])
    v1 = fleet._state("xc").server
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(v1.device.type == "cuda", f"[{tag}] v1 server not on the card")
    launches = dict(sepconv=0, head_pass=0)

    # 2. the fleet's overhead: one client through the fleet and the bare
    # v1 server, in turns
    def loop(submit):
        lat = []
        t1 = time.perf_counter()
        for j in range(FLEET_OVERHEAD_N):
            t2 = time.perf_counter()
            submit(images[j % FLEET_N]).result(timeout=120)
            lat.append(time.perf_counter() - t2)
        wall = time.perf_counter() - t1
        return dict(requests_per_s=FLEET_OVERHEAD_N / wall,
                    p50_ms=float(np.percentile(lat, 50) * 1e3),
                    p99_ms=float(np.percentile(lat, 99) * 1e3))

    sides = {"fleet": lambda im: fleet.submit("xc", im, tenant="silver"),
             "server": lambda im: v1.submit(im, tenant="silver")}
    runs = {"fleet": [], "server": []}
    before = {"v1": dict(v1.metrics.counters)}
    reset_counts(sepconv)
    for k in range(2 * FLEET_OVERHEAD_RUNS):
        # fleet, server, server, fleet, fleet, server
        side = ("fleet", "server")[(k + k // 2) % 2]
        runs[side].append(loop(sides[side]))
    counts = _fleet_counts(sepconv, {"v1": v1}, before, 0, "overhead loops")
    launches["sepconv"] += counts["sepconv"]

    def mean(side, key):
        return float(np.mean([r[key] for r in runs[side]]))

    overhead = {k: mean("fleet", k) / mean("server", k) - 1
                for k in ("requests_per_s", "p50_ms", "p99_ms")}
    out["overhead"] = dict(runs=runs, overhead=overhead)
    for side, via in (("fleet", "Fleet.submit"),
                      ("server", "the bare v1 Server")):
        print(f"[{tag}] ({card}) 1 client, {FLEET_OVERHEAD_N} requests, "
              f"through {via}: "
              + "; ".join(f"{r['requests_per_s']:.1f} req/s, p50 "
                          f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms"
                          for r in runs[side]), flush=True)
    print(f"[{tag}] ({card}) the fleet's overhead over the bare server "
          f"(mean of {FLEET_OVERHEAD_RUNS} runs a side): "
          f"{overhead['requests_per_s'] * 100:+.2f}% req/s, "
          f"{overhead['p50_ms'] * 100:+.2f}% p50, "
          f"{overhead['p99_ms'] * 100:+.2f}% p99", flush=True)

    # 3. the load, through a canary, a faulted promote and a rollback
    lock = threading.Lock()
    stop = threading.Event()
    recs, sheds, errors = [], {}, []

    def client(k):
        j = 0
        try:
            while not stop.is_set():
                i = (k + FLEET_CLIENTS * j) % FLEET_N
                tenant = FLEET_TENANTS[(k + j) % len(FLEET_TENANTS)]
                j += 1
                t1 = time.perf_counter()
                try:
                    fut = fleet.submit("xc", images[i], tenant=tenant)
                except (QuotaExceededError, ServiceUnavailableError) as e:
                    with lock:
                        key = (tenant, type(e).__name__)
                        sheds[key] = sheds.get(key, 0) + 1
                    continue
                row = fut.result(timeout=120)
                t2 = time.perf_counter()
                with lock:
                    recs.append((t2, t2 - t1, fut.fleet_version,
                                 fut.fleet_canary, i, row, tenant))
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    windows = {}

    def window(name, n):
        """Wait for ``n`` requests completed from now; the window's
        requests are those completed between its two ends, and its batches
        and metered seconds the shared ledger's between them."""
        tot0 = ledger.snapshot()["totals"]
        with lock:
            start_n, t1 = len(recs), time.perf_counter()
        deadline = t1 + 300
        while time.perf_counter() < deadline and not errors:
            with lock:
                if len(recs) - start_n >= n:
                    break
            time.sleep(0.002)
        check(not errors, f"[{tag}] clients failed: {errors[:1]}")
        with lock:
            done = recs[start_n:]
        check(len(done) >= n, f"[{tag}] {name}: {len(done)} of {n} "
                              f"requests in 300 s")
        t2 = max(r[0] for r in done)
        tot1 = ledger.snapshot()["totals"]
        batches = tot1["batches"] - tot0["batches"]
        metered = tot1["device_s"] - tot0["device_s"]
        lat = np.asarray([r[1] for r in done])
        windows[name] = dict(
            batches=batches, metered_s=metered,
            metered_ms_per_batch=metered / max(1, batches) * 1e3,
            # above 1: metered calls overlapped (two workers of one
            # server, or two versions' servers, metered at once)
            metered_s_per_wall_s=metered / (time.perf_counter() - t1),
            requests=len(done), seconds=t2 - t1,
            requests_per_s=len(done) / (t2 - t1),
            p50_ms=float(np.percentile(lat, 50) * 1e3),
            p99_ms=float(np.percentile(lat, 99) * 1e3),
            versions=sorted({r[2] for r in done}),
            canary=sum(1 for r in done if r[3]))

    def n_events(name):
        return sum(1 for e in recorder.snapshot() if e["event"] == name)

    def captures(srv):
        return int(srv.metrics.counters.get("engine.graph_captures", 0))

    pools, regress = {}, {}
    before = {"v1": dict(v1.metrics.counters)}
    reset_counts(sepconv)
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    try:
        window("before the rollout", FLEET_WINDOW)
        pools["before"] = graph_pool_bytes_held()
        regress["before"] = n_events("cost.regression")
        fleet.add_version("xc", states[2], label="v2")
        t1 = time.perf_counter()
        ro = fleet.start_rollout("xc", canary_fraction=0.5,
                                 warm_example=images[0])
        rollout_s = time.perf_counter() - t1
        v2 = ro.canary_server
        caps_start = (captures(v1), captures(v2))
        window("during the canary", FLEET_WINDOW)
        pools["canary"] = graph_pool_bytes_held()
        regress["canary"] = n_events("cost.regression") - regress["before"]
        open_canary = sorted(ledger.regressions())
        graphs = {"v1": [g["launches"] for g in
                         v1._engine_for(FLEET_BATCH).graphs()],
                  "v2": [g["launches"] for g in
                         v2._engine_for(FLEET_BATCH).graphs()]}
        v1_pool = v1.graph_pool_bytes
        caps_end = (captures(v1), captures(v2))
        with faults.active(faults.FaultPlan.parse(
                "fleet.swap:error:exc=transient,at=1,times=1")):
            try:
                fleet.promote("xc")
                first_failed = False
            except faults.InjectedTransientError:
                first_failed = True
            check(first_failed and fleet.deployed_version("xc") == 1
                  and ro.active and not v1.closed,
                  f"[{tag}] the faulted promote: raised {first_failed}, "
                  f"deployed v{fleet.deployed_version('xc')}")
            t1 = time.perf_counter()
            report = fleet.promote("xc")
            promote_s = time.perf_counter() - t1
        check(fleet.deployed_version("xc") == 2 and v1.closed
              and v1.graph_pool_bytes == 0,
              f"[{tag}] promote: deployed v{fleet.deployed_version('xc')}, "
              f"v1 closed {v1.closed}, its pool {v1.graph_pool_bytes}")
        pools["after"] = graph_pool_bytes_held()
        window("after the promote", FLEET_WINDOW)
        regress["after"] = (n_events("cost.regression") - regress["before"]
                            - regress["canary"])
        fleet.add_version("xc", states[3], label="v3")
        ro3 = fleet.start_rollout("xc", canary_fraction=0.5,
                                  warm_example=images[0])
        v3 = ro3.canary_server
        window("during the v3 canary", FLEET_V3_WINDOW)
        graphs["v3"] = [g["launches"] for g in
                        v3._engine_for(FLEET_BATCH).graphs()]
        v3_pool = v3.graph_pool_bytes
        rollback = fleet.rollback("xc")
        check(v3.closed and v3.graph_pool_bytes == 0
              and fleet.deployed_version("xc") == 2,
              f"[{tag}] rollback: v3 closed {v3.closed}, its pool "
              f"{v3.graph_pool_bytes}")
        pools["rolled_back"] = graph_pool_bytes_held()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
    check(not errors and not any(t.is_alive() for t in threads),
          f"[{tag}] clients failed: {errors[:1]}")
    counts = _fleet_counts(sepconv, {"v1": v1, "v2": v2, "v3": v3}, before,
                           2, "the load")
    launches["sepconv"] += counts["sepconv"]
    bad = sum(not np.array_equal(row, oracle[v][i])
              for _, _, v, _, i, row, _ in recs)
    served = sorted({r[2] for r in recs})
    snap = fleet.admission.snapshot()["tenants"]
    names = {e["event"] for e in recorder.snapshot()}
    check(bad == 0, f"[{tag}] {bad} of {len(recs)} rows differ from their "
                    f"version's oracle row")
    check(served == [1, 2, 3], f"[{tag}] versions served {served}")
    check(snap["metered"]["admitted"] <= FLEET_METERED_BURST,
          f"[{tag}] metered admitted {snap['metered']['admitted']} times")
    check(report["no_recompile"] is True and caps_end == caps_start,
          f"[{tag}] no_recompile {report['no_recompile']}, captures "
          f"(v1, v2) {caps_start} at the canary's warm-up, {caps_end} at "
          f"the promote; report {report['buckets']}")
    check(all(g == [(SEPCONV_PER_FORWARD, 0, 0)] for g in graphs.values()),
          f"[{tag}] bucket graphs' launches {graphs}")
    check(pools["after"] == pools["canary"] - v1_pool
          and pools["rolled_back"] == pools["after"] and v3_pool > 0,
          f"[{tag}] pools {pools}, v1's {v1_pool}, v3's {v3_pool}")
    check({"rollout.start", "rollout.promote", "rollout.rollback",
           "fleet.shed"} <= names, f"[{tag}] events {sorted(names)}")
    for name, w in windows.items():
        print(f"[{tag}] ({card}) {FLEET_CLIENTS} clients, {name}: "
              f"{w['requests_per_s']:.1f} req/s, p50 {w['p50_ms']:.3f} ms, "
              f"p99 {w['p99_ms']:.3f} ms over {w['requests']} requests "
              f"(versions {w['versions']}, {w['canary']} on the canary); "
              f"{w['batches']} batches metered "
              f"{w['metered_ms_per_batch']:.3f} ms each, "
              f"{w['metered_s_per_wall_s']:.3f} metered s a wall s",
              flush=True)
    tot = ledger.snapshot()["totals"]
    crossings = [e["attrs"] for e in recorder.snapshot()
                 if e["event"] == "cost.regression"]
    recovered = n_events("cost.recovered")
    print(f"[{tag}] ({card}) rollout to v2: canary warm-up {rollout_s:.2f} s "
          f"under load, promote {promote_s:.3f} s after one injected "
          f"fleet.swap failure; no_recompile {report['no_recompile']}; "
          f"captures (v1, v2) {caps_start} -> {caps_end}; every bucket "
          f"graph {graphs}; {len(recs)} rows == their version's oracle "
          f"bit for bit (served {served}); metered admitted "
          f"{snap['metered']['admitted']}, shed {snap['metered']['shed']}; "
          f"v3 rolled back ({rollback['phase']})", flush=True)
    print(f"[{tag}] ({card}) graph pools held: before the rollout "
          f"{pools['before'] / 2**20:.1f} MiB, during the canary "
          f"{pools['canary'] / 2**20:.1f}, after the promote "
          f"{pools['after'] / 2**20:.1f} (v1's {v1_pool / 2**20:.1f} MiB "
          f"released), after the v3 rollback "
          f"{pools['rolled_back'] / 2**20:.1f} (v3's "
          f"{v3_pool / 2**20:.1f} released)", flush=True)
    print(f"[{tag}] ({card}) shared ledger: {tot['batches']} batches, "
          f"{tot['device_s']:.6f} s metered; cost.regression opened "
          f"{regress['before']} time(s) before the rollout, "
          f"{regress['canary']} during the canary (open at its end: "
          f"{open_canary}), {regress['after']} after the promote; "
          f"crossings {crossings}; cost.recovered {recovered} time(s)",
          flush=True)
    out.update(oracle_s=oracle_s, setup_s=setup_s, windows=windows,
               rollout_warmup_s=rollout_s, promote_s=promote_s,
               no_recompile=report["no_recompile"],
               captures=dict(start=caps_start, end=caps_end),
               graphs={k: [list(g) for g in v] for k, v in graphs.items()},
               rows=len(recs), versions=served, pools=pools,
               v1_pool_bytes=v1_pool, v3_pool_bytes=v3_pool,
               metered=snap["metered"], sheds={
                   f"{t}/{e}": n for (t, e), n in sorted(sheds.items())},
               ledger=dict(batches=tot["batches"], device_s=tot["device_s"]),
               cost_regressions=regress, open_during_canary=open_canary,
               cost_crossings=crossings, cost_recovered=recovered)

    # 4. tracing on: each fleet.request span parents its server's request
    tracer = otrace.configure(enabled=True)
    for j in range(FLEET_TRACED_N):
        fleet.predict("xc", images[j], tenant="gold")
    spans = tracer.snapshot()
    otrace.configure(enabled=False)
    fspans = {s["span_id"]: s for s in spans if s["name"] == "fleet.request"}
    reqs = [s for s in spans if s["name"] == "serving.request"]
    check(len(fspans) == len(reqs) == FLEET_TRACED_N
          and all(r["parent_id"] in fspans
                  and fspans[r["parent_id"]]["trace_id"] == r["trace_id"]
                  for r in reqs),
          f"[{tag}] spans: {len(fspans)} fleet.request, {len(reqs)} "
          f"serving.request, not each under its own")
    text = json.dumps(fleet.varz())
    health = fleet.health()
    check(health["state"] == "ready", f"[{tag}] fleet health {health}")
    print(f"[{tag}] tracing on: {FLEET_TRACED_N} fleet.request spans, each "
          f"the parent of its server's serving.request; varz {len(text)} "
          f"bytes of JSON; health {health['state']} (cost.recovered "
          f"{n_events('cost.recovered')} time(s), open now "
          f"{sorted(ledger.regressions())})", flush=True)

    # 5. the fan-out entry
    rng = np.random.default_rng(SEED + 104)
    heads = {f"t{i:02d}": {
        "kernel": (rng.normal(size=(HEAD_D, FANOUT_CLASSES))
                   / math.sqrt(HEAD_D)).astype(np.float32),
        "bias": rng.normal(size=(FANOUT_CLASSES,)).astype(np.float32)}
        for i in range(FLEET_FANOUT_TENANTS)}
    new_head = {"kernel": (rng.normal(size=(HEAD_D, FANOUT_CLASSES))
                           / math.sqrt(HEAD_D)).astype(np.float32),
                "bias": rng.normal(size=(FANOUT_CLASSES,)).astype(
                    np.float32)}
    swapped = "t03"
    fleet.add_fanout_model("xc-heads", "Xception", warm_example=images[0])
    for t, h in heads.items():
        fleet.add_head("xc-heads", t, h)
    fan = fleet._state("xc-heads").server
    fan.warm_head(np.zeros(HEAD_D, np.float32))
    feats = ni._zoo_engine("Xception", True, FLEET_BATCH)(
        images[:FLEET_FANOUT_IMAGES])

    def dev(h):
        return {k: torch.from_numpy(v).cuda() for k, v in h.items()}

    def head_oracle(i, head):
        with torch.inference_mode():
            return dense_head_row(dev(head), torch.from_numpy(
                np.ascontiguousarray(feats[i])).cuda()).cpu().numpy()

    fan_recs, fan_errors = [], []
    swap_done = threading.Event()
    swap_report = {}

    def fan_run():
        def fan_client(k):
            try:
                for r in range(k, FLEET_FANOUT_N, FLEET_CLIENTS):
                    i = r % FLEET_FANOUT_IMAGES
                    t = f"t{r % FLEET_FANOUT_TENANTS:02d}"
                    after = swap_done.is_set()
                    row = fleet.predict("xc-heads", images[i], tenant=t)
                    with lock:
                        fan_recs.append((i, t, after, row))
            except Exception as e:  # reported below, in the main thread
                fan_errors.append(e)

        fthreads = [threading.Thread(target=fan_client, args=(k,))
                    for k in range(FLEET_CLIENTS)]
        for t in fthreads:
            t.start()
        while len(fan_recs) < FLEET_FANOUT_N // 2 and not fan_errors and \
                any(t.is_alive() for t in fthreads):
            time.sleep(0.002)
        swap_report.update(fleet.swap_head("xc-heads", swapped, new_head))
        swap_done.set()
        for t in fthreads:
            t.join(timeout=300)
        check(not fan_errors and not any(t.is_alive() for t in fthreads),
              f"[{tag}] fan-out clients failed: {fan_errors[:1]}")

    _, fcounts, fcounters, _ = _fanout_counted(
        sepconv, hops, fan, "the fleet's fan-out entry", fan_run)
    launches["sepconv"] += fcounts["sepconv"]
    launches["head_pass"] += fcounts["head_pass"]
    want = {(i, t): head_oracle(i, heads[t]).tobytes()
            for i in range(FLEET_FANOUT_IMAGES) for t in heads}
    want_new = {i: head_oracle(i, new_head).tobytes()
                for i in range(FLEET_FANOUT_IMAGES)}
    bad = 0
    for i, t, after, row in fan_recs:
        got = row.tobytes()
        if t != swapped:
            bad += got != want[(i, t)]
        elif after:
            bad += got != want_new[i]
        else:
            bad += got not in (want[(i, t)], want_new[i])
    check(len(fan_recs) == FLEET_FANOUT_N and bad == 0
          and swap_report["no_backbone_recompile"] is True
          and swap_report["head_version"] == 2,
          f"[{tag}] fan-out: {bad} of {len(fan_recs)} rows differ from "
          f"their tenant's oracle; swap report {swap_report}")
    fan_pool = fan.graph_pool_bytes
    v2_pool = v2.graph_pool_bytes
    fleet.close()
    oflight.configure(enabled=False)
    check(v2.graph_pool_bytes == 0 and fan.graph_pool_bytes == 0,
          f"[{tag}] close() kept a pool")
    print(f"[{tag}] ({card}) fan-out entry xc-heads: "
          f"{FLEET_FANOUT_TENANTS} tenants' (2048, {FANOUT_CLASSES}) heads, "
          f"{FLEET_FANOUT_N} requests from {FLEET_CLIENTS} clients, "
          f"swap_head({swapped}) midway (no_backbone_recompile, head "
          f"version 2): every row == its tenant's oracle bit for bit; "
          f"{int(fcounters.get('serving.batches', 0))} backbone "
          f"dispatches, {int(fcounters.get('headbank.dispatches', 0))} "
          f"head passes; launches {fcounts}; pools {fan_pool / 2**20:.1f} "
          f"MiB (fan-out), {v2_pool / 2**20:.1f} MiB (v2), 0 after "
          f"close()", flush=True)
    print(f"[{tag}] ({card}) launches over the counted windows: B1 "
          f"{launches['sepconv']}, H1 {launches['head_pass']}", flush=True)
    out.update(fanout=dict(requests=len(fan_recs), launches=fcounts,
                           pool_bytes=fan_pool,
                           head_passes=int(fcounters.get(
                               "headbank.dispatches", 0))),
               v2_pool_bytes=v2_pool, launches=launches)
    return out


STREAM_CHUNKS = 12              # chunks a stream holds
STREAM_CHUNK = 16               # seeded 299x299 images a chunk, and the
#                                 engine's device batch: one dispatch a chunk
STREAM_RUNS = 3                 # runs a side of each rate, in turns
STREAM_CHILD_TIMEOUT_S = 300    # a child scorer's time limit
STREAM_FAULT_AT = 4             # the child's commit that SIGKILLs it
STREAM_STALL_DEADLINE_S = 0.2   # the stall watchdog's deadline
STREAM_STALL_FEED_S = 0.8       # the late chunk comes after this long
STREAM_SERVER_TOL = 1e-6        # Server sink vs engine sink (the JAX test's)
STREAM_FIT_N = 44               # tinted JPEGs of [tuning] the fits read
STREAM_FIT_RB = 10              # rows a record batch: the tail is ragged
STREAM_FIT_EPOCHS = 2


_STREAM_CHILD = f"""
import json, os, signal, sys
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from sparkdl_tpu_torch import faults, streaming
from sparkdl_tpu_torch.ops import sepconv
from sparkdl_tpu_torch.transformers import named_image as ni
base = sys.argv[1]
eng = ni._zoo_engine("Xception", True, {STREAM_CHUNK})
sc = streaming.StreamScorer(
    eng, streaming.DirectorySource(os.path.join(base, "in")),
    journal_path=os.path.join(base, "journal.jsonl"),
    out_dir=os.path.join(base, "out"), stall_deadline_s=60.0)
try:
    summary = sc.run()
except faults.InjectedFatalError:
    # a real SIGKILL where the fault marks the crash window: no finally,
    # no atexit, no flush; only what fsync made durable survives
    os.kill(os.getpid(), signal.SIGKILL)
print(json.dumps(dict(summary=summary, health=sc.health(),
                      device=str(eng.device),
                      launches=sepconv.fused_sepconv.launches,
                      modules=sorted(m for m in ("jax", "sparkdl_tpu")
                                     if m in sys.modules))))
"""


def _stream_child(base, faults_spec):
    """Run the child scorer over ``base``; returns (rc, last stdout line,
    stderr tail).  The child is killed if it outlives its limit."""
    env = dict(os.environ, SPARKDL_TRACE="0")
    env.pop("SPARKDL_BLACKBOX", None)
    env.pop("SPARKDL_FAULTS", None)
    if faults_spec:
        env["SPARKDL_FAULTS"] = faults_spec
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _STREAM_CHILD, base],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=env, capture_output=True, text=True,
                       timeout=STREAM_CHILD_TIMEOUT_S)
    lines = r.stdout.strip().splitlines()
    return (r.returncode, lines[-1] if lines else "", r.stderr[-3000:],
            time.perf_counter() - t0)


class _Preempted:
    """``fit`` of ``est`` whose first attempt dies at the second epoch's
    loss (after epoch 1's checkpoint is saved): a preemption.  It swaps the
    train module's ``Metrics`` for the attempt (instrumentation of this
    script)."""

    def __init__(self, est):
        self.est = est
        self.attempts = 0

    def fit(self, dataset, params=None):
        from sparkdl_tpu_torch.parallel import train
        from sparkdl_tpu_torch.utils.metrics import Metrics

        self.attempts += 1
        if self.attempts > 1:
            return self.est.fit(dataset, params)

        class Preempt(Metrics):
            def record_time(self, name, value):
                super().record_time(name, value)
                if name == "epoch_loss" and \
                        len(self.timings_s["epoch_loss"]) == 2:
                    raise RuntimeError("preempted after epoch 1")

        saved, train.Metrics = train.Metrics, Preempt
        try:
            return self.est.fit(dataset, params)
        finally:
            train.Metrics = saved


def _rate_stats(xs):
    return dict(runs=list(xs), mean=float(np.mean(xs)),
                min=float(np.min(xs)), max=float(np.max(xs)))


def phase_stream(sepconv):
    """[stream]: exactly-once streaming (``sparkdl_tpu_torch.streaming``)
    over a zoo Xception 299x299 featurizer engine at device batch 16 (B1,
    30 launches a dispatch), and the streaming fit; f32 with TF32 off.  12
    chunks of 16 seeded images.

      1. engine sink, pipelined: ``StreamScorer`` over a ``MemorySource``;
         ``assemble_outputs`` == ``map_batches`` over the same chunks bit
         for bit (the oracle), B1 30 a dispatch;
      2. the chaos: the chunks through ``write_directory_chunk``; a child
         ``python -c`` scorer over a ``DirectorySource`` with
         ``stream.commit:error:exc=fatal,at=4`` SIGKILLs itself at the
         fault (rc -9, resume offset 3, offset 3's artifact durable and
         uncommitted); a second child with no fault replays to 12 commits
         (redeliveries >= 1, health ready, watermark 12, lag 0), each
         commit once, 12 artifacts, the output == the oracle bit for bit;
      3. Server sink: ``Server("Xception", featurize=True,
         max_batch_size=16, bucket_sizes=[16])``: within 1e-6 of the engine
         sink, and bit for bit (its bucket is the engine's batch);
      4. the stall watchdog: a ``MemorySource`` fed late (health degraded,
         then ready; ``stream.stall`` and ``stream.stall_recovered`` in the
         flight recorder), and a transient ``stream.source`` error
         absorbed (``stream.source_errors`` >= 1, output unchanged);
      5. the streaming fit: [tuning]'s converted Keras InceptionV3 over 44
         tinted JPEGs as ``iterFileBatches`` record batches of 10 (a ragged
         tail), batch 16, SGD, 2 epochs, against the in-memory fit
         (``shuffle`` false) on the card within [tuning]'s bounds; a
         checkpointed stream fit preempted after epoch 1 and resumed by
         ``fit_with_retries``, against the uninterrupted one; no kernel;
      6. rates, three runs a side in turns: chunks/s and img/s of the
         scorer against a bare ``map_batches`` over the same payloads, the
         ``stream.chunk_latency`` p50 and p99, ms a fsync'd commit (the
         scorer's own ``_commit_chunk`` timed in those runs: artifact write,
         output record, commit), the Server sink's chunks/s, the
         stream fit's img/s against the in-memory fit's.
    """
    import shutil
    import tempfile

    import pyarrow as pa

    from sparkdl_tpu_torch import faults, streaming
    from sparkdl_tpu_torch.estimators import KerasImageFileEstimator
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch, iterFileBatches
    from sparkdl_tpu_torch.models import get_model_spec, keras_import
    from sparkdl_tpu_torch.obs import flight as oflight
    from sparkdl_tpu_torch.serving import Server
    from sparkdl_tpu_torch.transformers import named_image as ni
    from sparkdl_tpu_torch.utils.jsonl import read_jsonl
    from sparkdl_tpu_torch.utils.retry import fit_with_retries

    tag = "stream"
    t_phase = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(card=card)
    zero = dict(sepconv=0, sepconv_tiled=0, mbconv=0)
    size = get_model_spec("Xception").input_size[0]
    n = STREAM_CHUNKS * STREAM_CHUNK
    df = synthetic_frame(n, size, SEED + 111)
    images, ok = arrowStructsToBatch(df.table.column("image"), size, size)
    check(ok.all(), f"[{tag}] synthetic images failed to decode")
    chunks = [images[k * STREAM_CHUNK:(k + 1) * STREAM_CHUNK]
              for k in range(STREAM_CHUNKS)]
    eng = ni._zoo_engine("Xception", True, STREAM_CHUNK)
    check(eng.device.type == "cuda", f"[{tag}] engine not on the card")
    eng(chunks[0])  # the capture and its eager warm-up, outside the counts
    torch.cuda.synchronize()

    def counted(what, dispatches, run):
        reset_counts(sepconv)
        result = run()
        torch.cuda.synchronize()
        counts = read_counts(sepconv)
        want = dict(zero, sepconv=SEPCONV_PER_FORWARD * dispatches)
        check(counts == want, f"[{tag}] {what}: launches {counts}, want "
                              f"{want} ({dispatches} dispatches)")
        return result, counts

    oracle, _ = counted("the oracle", STREAM_CHUNKS, lambda: np.concatenate(
        list(eng.map_batches(chunks, pipeline=False))))
    check(oracle.shape == (n, 2048) and np.isfinite(oracle).all(),
          f"[{tag}] oracle {oracle.shape}, not finite 2048-d rows")
    launches = dict(sepconv=0)
    tmp = tempfile.mkdtemp(prefix="stream_smoke_")
    try:
        # 1. engine sink, pipelined
        def score(sink, where, source=None, **kw):
            base = os.path.join(tmp, where)
            sc = streaming.StreamScorer(
                sink, source or streaming.MemorySource(chunks, finished=True),
                journal_path=os.path.join(base, "journal.jsonl"),
                out_dir=os.path.join(base, "out"), **kw)
            t0 = time.perf_counter()
            summary = sc.run()
            wall = time.perf_counter() - t0
            got = streaming.assemble_outputs(
                os.path.join(base, "journal.jsonl"), os.path.join(base, "out"))
            return sc, summary, wall, got

        (sc, summary, wall, got), counts = counted(
            "engine sink", STREAM_CHUNKS, lambda: score(eng, "engine"))
        launches["sepconv"] += counts["sepconv"]
        check(np.array_equal(got, oracle),
              f"[{tag}] engine sink != map_batches: max abs "
              f"{np.abs(got - oracle).max():.3g}")
        check(summary["chunks_scored"] == STREAM_CHUNKS
              and summary["committed_total"] == STREAM_CHUNKS
              and sc.health()["state"] == "ready"
              and sc.health()["watermark"] == STREAM_CHUNKS,
              f"[{tag}] engine sink summary {summary}, health "
              f"{sc.health()}")
        sc.close()
        print(f"[{tag}] ({card}) engine sink (pipelined): {STREAM_CHUNKS} "
              f"chunks of {STREAM_CHUNK} through StreamScorer == map_batches "
              f"bit for bit, {STREAM_CHUNKS} commits, launches {counts} "
              f"({SEPCONV_PER_FORWARD} a dispatch), {wall:.3f}s",
              flush=True)
        out["engine_sink"] = dict(launches=counts, summary=summary)

        # 2. the chaos: SIGKILL between output write and commit
        base = os.path.join(tmp, "chaos")
        for k, c in enumerate(chunks):
            streaming.write_directory_chunk(os.path.join(base, "in"), k, c)
        streaming.finish_directory_stream(os.path.join(base, "in"))
        rc1, _, err1, s1 = _stream_child(
            base, f"stream.commit:error:exc=fatal,at={STREAM_FAULT_AT}")
        check(rc1 == -9, f"[{tag}] faulted child rc {rc1}, want -9: {err1}")
        j = streaming.Journal(os.path.join(base, "journal.jsonl"))
        resume, pending = j.resume_offset(), j.uncommitted()
        j.close()
        check(resume == STREAM_FAULT_AT - 1 and any(
            r["offset"] == resume and r["has_output"] for r in pending),
            f"[{tag}] after the SIGKILL: resume offset {resume}, pending "
            f"{pending}")
        rc2, line, err2, s2 = _stream_child(base, None)
        check(rc2 == 0, f"[{tag}] resumed child rc {rc2}: {err2}")
        rec = json.loads(line)
        h = rec["health"]
        check(rec["device"].startswith("cuda") and not rec["modules"]
              and rec["summary"]["resume_offset"] == resume
              and rec["summary"]["redeliveries"] >= 1
              and rec["summary"]["committed_total"] == STREAM_CHUNKS
              and h["state"] == "ready" and h["watermark"] == STREAM_CHUNKS
              and h["lag_s"] == 0.0,
              f"[{tag}] resumed child: {rec}")
        recs, _ = read_jsonl(os.path.join(base, "journal.jsonl"))
        commits = [r["chunk_id"] for r in recs if r["rec"] == "commit"]
        arts = [f for f in os.listdir(os.path.join(base, "out"))
                if f.endswith(".npy")]
        got = streaming.assemble_outputs(os.path.join(base, "journal.jsonl"),
                                         os.path.join(base, "out"))
        same = np.array_equal(got, oracle)
        print(f"[{tag}] ({card}) chaos: child 1 (SPARKDL_FAULTS stream."
              f"commit at {STREAM_FAULT_AT}) SIGKILLed itself, rc {rc1}, "
              f"{s1:.1f}s; journal resume offset {resume}, pending "
              f"{[(r['offset'], r['has_output']) for r in pending]}; child 2 "
              f"{s2:.1f}s: {rec['summary']}, health {h['state']} watermark "
              f"{h['watermark']} lag_s {h['lag_s']}, child B1 launches "
              f"{rec['launches']}; {len(commits)} commits ({len(set(commits))}"
              f" ids), {len(arts)} artifacts; output == the parent's oracle "
              f"bit for bit: {same}"
              + ("" if same else f" (max abs {np.abs(got - oracle).max():.3g},"
                                 f" rows equal "
                                 f"{int((got == oracle).all(1).sum())})"),
              flush=True)
        check(len(commits) == len(set(commits)) == STREAM_CHUNKS
              and len(arts) == STREAM_CHUNKS,
              f"[{tag}] chaos: {len(commits)} commits, {len(arts)} artifacts")
        check(same, f"[{tag}] chaos output differs from the oracle")
        out["chaos"] = dict(rc_faulted=rc1, resume_offset=resume,
                            resumed=rec["summary"], health=h,
                            child_s=[s1, s2], commits=len(commits),
                            artifacts=len(arts))

        # 3. the Server sink
        srv = Server("Xception", featurize=True, max_batch_size=STREAM_CHUNK,
                     bucket_sizes=[STREAM_CHUNK], max_wait_ms=2, cache=False)
        srv.warmup(images[0])
        torch.cuda.synchronize()
        check(srv.device.type == "cuda", f"[{tag}] server not on the card")
        before = dict(srv.metrics.counters)
        reset_counts(sepconv)
        sc, summary, wall, got = score(srv, "server")
        counts = read_counts(sepconv)
        c = srv.metrics.counters
        forwards = int(c.get("serving.batches", 0)
                       - before.get("serving.batches", 0)
                       + c.get("engine.graph_captures", 0)
                       - before.get("engine.graph_captures", 0))
        check(counts == dict(zero, sepconv=SEPCONV_PER_FORWARD * forwards),
              f"[{tag}] Server sink launches {counts}, {forwards} forwards")
        launches["sepconv"] += counts["sepconv"]
        err = float(np.abs(got - oracle).max())
        rows_equal = int((got == oracle).all(1).sum())
        sc.close()
        print(f"[{tag}] ({card}) Server sink (bucket {STREAM_CHUNK}): "
              f"{summary['chunks_scored']} chunks, {forwards} forwards, "
              f"launches {counts}; vs the engine sink max abs {err:.3g} "
              f"(tol {STREAM_SERVER_TOL}), {rows_equal}/{n} rows bit for "
              f"bit", flush=True)
        check(got.shape == oracle.shape and err <= STREAM_SERVER_TOL
              and rows_equal == n,
              f"[{tag}] Server sink: max abs {err:.3g}, {rows_equal}/{n} "
              f"rows bit for bit")
        out["server_sink"] = dict(max_abs=err, rows_equal=rows_equal,
                                  forwards=forwards, launches=counts)

        # 4. the stall watchdog, then a flaky source
        recorder = oflight.configure(enabled=True, capacity=4096)
        src = streaming.MemorySource(chunks[:1])
        mid = {}

        def feeder():
            time.sleep(STREAM_STALL_FEED_S)
            mid.update(sc_stall.health())
            src.feed(chunks[1])
            src.finish()

        sc_stall = streaming.StreamScorer(
            eng, src, journal_path=os.path.join(tmp, "stall", "j.jsonl"),
            out_dir=os.path.join(tmp, "stall", "out"),
            stall_deadline_s=STREAM_STALL_DEADLINE_S)
        feed = threading.Thread(target=feeder)
        feed.start()
        (summary, _), counts = counted(
            "stall", 2, lambda: (sc_stall.run(), None))
        feed.join()
        launches["sepconv"] += counts["sepconv"]
        h = sc_stall.health()
        events = [e["event"] for e in recorder.snapshot()]
        got = streaming.assemble_outputs(
            os.path.join(tmp, "stall", "j.jsonl"),
            os.path.join(tmp, "stall", "out"))
        sc_stall.close()
        print(f"[{tag}] ({card}) stall: source silent {STREAM_STALL_FEED_S}s"
              f" against a {STREAM_STALL_DEADLINE_S}s deadline: health "
              f"{mid.get('state')} (lag_s {mid.get('lag_s')}, "
              f"{(mid.get('last_error') or {}).get('type')}) then "
              f"{h['state']}; stalls "
              f"{sc_stall.metrics.counters.get('stream.stalls', 0):.0f}, "
              f"recoveries "
              f"{sc_stall.metrics.counters.get('stream.stall_recoveries', 0):.0f}"
              f"; flight events {sorted(set(events))}", flush=True)
        check(mid.get("state") == "degraded" and h["state"] == "ready"
              and summary["chunks_scored"] == 2
              and {"stream.stall", "stream.stall_recovered"} <= set(events)
              and np.array_equal(got, oracle[:2 * STREAM_CHUNK]),
              f"[{tag}] stall: mid {mid}, after {h}, events {events}")
        with faults.active(faults.FaultPlan.parse(
                "seed=5;stream.source:error:exc=transient,at=2")) as plan:
            (res, counts) = counted("flaky source", 3, lambda: score(
                eng, "flaky", streaming.MemorySource(chunks[:3],
                                                     finished=True)))
        sc, summary, _, got = res
        launches["sepconv"] += counts["sepconv"]
        errors = sc.metrics.counters.get("stream.source_errors", 0)
        sc.close()
        oflight.configure(enabled=False)
        print(f"[{tag}] ({card}) flaky source: stream.source fired "
              f"{plan.fired('stream.source')}x, stream.source_errors "
              f"{errors:.0f}, {summary['chunks_scored']} chunks, output "
              f"unchanged", flush=True)
        check(errors >= 1 and np.array_equal(got, oracle[:3 * STREAM_CHUNK]),
              f"[{tag}] flaky source: {errors} errors, output differs")
        out["stall"] = dict(mid_state=mid.get("state"),
                            mid_lag_s=mid.get("lag_s"), after=h["state"],
                            source_errors=errors)

        # 6a. rates: the scorer against a bare map_batches, in turns
        def bare():
            t0 = time.perf_counter()
            for _ in eng.map_batches(chunks):
                pass
            return time.perf_counter() - t0

        # 6b. ms a fsync'd commit on this machine's disk: the scorer's own
        # _commit_chunk (artifact write and fsync, output record, the
        # stream.commit inject, commit, metrics), timed in the rate runs
        rates = dict(scorer=[], bare=[], p50_ms=[], p99_ms=[])
        commit_ms = []
        commit_chunk = streaming.StreamScorer._commit_chunk

        def timed_commit(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                return commit_chunk(self, *args, **kw)
            finally:
                commit_ms.append(1e3 * (time.perf_counter() - t0))

        streaming.StreamScorer._commit_chunk = timed_commit
        try:
            for k in range(2 * STREAM_RUNS):
                side = ("scorer", "bare")[(k + k // 2) % 2]
                if side == "bare":
                    _, counts = counted("bare map_batches", STREAM_CHUNKS,
                                        lambda: rates["bare"].append(bare()))
                else:
                    (sc, _, wall, got), counts = counted(
                        "scorer rate", STREAM_CHUNKS,
                        lambda: score(eng, f"rate{k}"))
                    check(np.array_equal(got, oracle),
                          f"[{tag}] rate run {k} output differs")
                    rates["scorer"].append(wall)
                    rates["p50_ms"].append(1e3 * sc.metrics.percentile(
                        "stream.chunk_latency", 50))
                    rates["p99_ms"].append(1e3 * sc.metrics.percentile(
                        "stream.chunk_latency", 99))
                    sc.close()
                launches["sepconv"] += counts["sepconv"]

        finally:
            streaming.StreamScorer._commit_chunk = commit_chunk
        check(len(commit_ms) == STREAM_RUNS * STREAM_CHUNKS,
              f"[{tag}] {len(commit_ms)} commits timed, expected "
              f"{STREAM_RUNS * STREAM_CHUNKS}")

        # 6c. the Server sink's rate
        server_s = []
        for k in range(STREAM_RUNS):
            reset_counts(sepconv)
            sc, _, wall, got = score(srv, f"srate{k}")
            launches["sepconv"] += read_counts(sepconv)["sepconv"]
            check(np.array_equal(got, oracle),
                  f"[{tag}] Server sink rate run {k} output differs")
            server_s.append(wall)
            sc.close()
        srv.close()
        chunk_rate = [STREAM_CHUNKS / s for s in rates["scorer"]]
        bare_rate = [STREAM_CHUNKS / s for s in rates["bare"]]
        out["rates"] = dict(
            scorer_chunks_s=_rate_stats(chunk_rate),
            scorer_img_s=_rate_stats([r * STREAM_CHUNK for r in chunk_rate]),
            bare_chunks_s=_rate_stats(bare_rate),
            bare_img_s=_rate_stats([r * STREAM_CHUNK for r in bare_rate]),
            chunk_latency_p50_ms=rates["p50_ms"],
            chunk_latency_p99_ms=rates["p99_ms"],
            commit_ms=_rate_stats(commit_ms),
            server_chunks_s=_rate_stats([STREAM_CHUNKS / s
                                         for s in server_s]))
        print(f"[{tag}] ({card}) rates, {STREAM_RUNS} runs a side in turns: "
              f"scorer {[round(r, 2) for r in chunk_rate]} chunks/s "
              f"({[round(r * STREAM_CHUNK, 1) for r in chunk_rate]} img/s) "
              f"vs bare map_batches {[round(r, 2) for r in bare_rate]} "
              f"chunks/s; chunk latency p50 "
              f"{[round(v, 2) for v in rates['p50_ms']]} ms, p99 "
              f"{[round(v, 2) for v in rates['p99_ms']]} ms; a fsync'd "
              f"commit {np.median(commit_ms):.3f} ms median "
              f"({min(commit_ms):.3f}-{max(commit_ms):.3f}); Server sink "
              f"{[round(STREAM_CHUNKS / s, 2) for s in server_s]} chunks/s",
              flush=True)

        # 5. the streaming fit on [tuning]'s converted InceptionV3
        with open(KERAS_CONFIG) as f:
            config = json.load(f)
        kfile = keras_import.keras_file(
            config, _keras_layers_for("InceptionV3", SEED + 31))
        mf = ModelFunction.from_keras(kfile)
        init = {k: v.clone() for k, v in mf.module.state_dict().items()}
        fit_dir = os.path.join(tmp, "fit_images")
        paths, labels = _tuning_files(fit_dir)
        for p in paths[STREAM_FIT_N:]:
            os.remove(p)
        paths, labels = paths[:STREAM_FIT_N], labels[:STREAM_FIT_N]
        onehot = np.eye(1000, dtype=np.float32)
        label_of = dict(zip(paths, labels))

        def source():
            for rb in iterFileBatches(fit_dir, batch_size=STREAM_FIT_RB):
                uris = rb.column(0).to_pylist()
                yield pa.record_batch({
                    "uri": pa.array(uris),
                    "onehot": pa.array([onehot[label_of[u]].tolist()
                                        for u in uris])})

        frame = DataFrame({"uri": paths,
                           "onehot": [onehot[k].tolist() for k in labels]})

        def estimator(**fit_params):
            e = KerasImageFileEstimator(
                inputCol="uri", outputCol="preds", labelCol="onehot",
                modelFile=kfile, imageLoader=load_inception_v3,
                kerasOptimizer="sgd", kerasLoss="categorical_crossentropy",
                batchSize=TUNING_BATCH,
                kerasFitParams=dict({"epochs": STREAM_FIT_EPOCHS},
                                    **fit_params))
            e._set(modelFunction=mf)
            return e

        steps = STREAM_FIT_EPOCHS * -(-STREAM_FIT_N // TUNING_BATCH)

        def timed_fit(data, **fit_params):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = estimator(**fit_params).fit(data)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            return m, s

        fit_s = dict(stream=[], memory=[])
        reset_counts(sepconv)
        models = {}
        for k in range(2 * STREAM_RUNS):
            side = ("stream", "memory")[(k + k // 2) % 2]
            m, s = timed_fit(source if side == "stream" else frame,
                             **({} if side == "stream" else
                                {"shuffle": False}))
            fit_s[side].append(s)
            models.setdefault(side, m)
        ms, mm = models["stream"], models["memory"]
        loss_rel = float(np.max(np.abs(np.asarray(ms.trainLosses)
                                       - mm.trainLosses)
                                / np.abs(mm.trainLosses)))
        upd_rel = _update_rel(mm.getModelFunction().module.state_dict(),
                              ms.getModelFunction().module.state_dict(), init)
        print(f"[{tag}] ({card}) stream fit of the converted InceptionV3 "
              f"({STREAM_FIT_N} JPEGs as record batches of {STREAM_FIT_RB}, "
              f"batch {TUNING_BATCH}, SGD, {STREAM_FIT_EPOCHS} epochs, "
              f"{steps} steps) vs the in-memory fit (shuffle off): epoch "
              f"losses {ms.trainLosses} vs {mm.trainLosses}, max rel err "
              f"{loss_rel:.3e} (tol {TUNING_LOSS_TOL}), update rel err "
              f"{upd_rel:.3e} (tol {TUNING_UPDATE_TOL})", flush=True)
        check(len(ms.trainLosses) == STREAM_FIT_EPOCHS
              and np.isfinite(ms.trainLosses).all()
              and loss_rel <= TUNING_LOSS_TOL
              and upd_rel <= TUNING_UPDATE_TOL,
              f"[{tag}] stream fit vs in-memory: loss rel {loss_rel:.4g}, "
              f"update rel {upd_rel:.4g}")
        ck = os.path.join(tmp, "fit_ckpt")
        pre = _Preempted(estimator(checkpoint_dir=ck))
        resumed = fit_with_retries(pre, source, max_retries=1)
        res_loss = abs(resumed.trainLosses[-1] - ms.trainLosses[-1]) / abs(
            ms.trainLosses[-1])
        res_upd = _update_rel(ms.getModelFunction().module.state_dict(),
                              resumed.getModelFunction().module.state_dict(),
                              init)
        counts = read_counts(sepconv)
        print(f"[{tag}] ({card}) stream fit preempted after epoch 1 "
              f"(checkpoint_dir) and resumed by fit_with_retries "
              f"({pre.attempts} attempts, {len(resumed.trainLosses)} epoch "
              f"after the resume): epoch-2 loss rel err {res_loss:.3e}, "
              f"update rel err {res_upd:.3e} against the uninterrupted "
              f"stream fit; B1-B3 launches {counts}", flush=True)
        check(pre.attempts == 2 and len(resumed.trainLosses) == 1
              and res_loss <= TUNING_LOSS_TOL
              and res_upd <= TUNING_UPDATE_TOL,
              f"[{tag}] resumed stream fit: {pre.attempts} attempts, "
              f"losses {resumed.trainLosses}, loss rel {res_loss:.4g}, "
              f"update rel {res_upd:.4g}")
        check(counts == zero, f"[{tag}] the fits launched {counts}")
        images_stepped = steps * TUNING_BATCH
        out["fit"] = dict(
            stream_losses=ms.trainLosses, memory_losses=mm.trainLosses,
            loss_rel=loss_rel, update_rel=upd_rel,
            resumed_loss_rel=res_loss, resumed_update_rel=res_upd,
            stream_img_s=_rate_stats([images_stepped / s
                                      for s in fit_s["stream"]]),
            memory_img_s=_rate_stats([images_stepped / s
                                      for s in fit_s["memory"]]))
        print(f"[{tag}] ({card}) fit rates ({images_stepped} images "
              f"stepped a fit, decode included), {STREAM_RUNS} runs a side "
              f"in turns: stream "
              f"{[round(images_stepped / s, 1) for s in fit_s['stream']]} "
              f"img/s, in-memory "
              f"{[round(images_stepped / s, 1) for s in fit_s['memory']]} "
              f"img/s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), f"[{tag}] {tmp} left behind")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{tag}] ({card}) B1 launches over the counted windows "
          f"{launches['sepconv']}; phase {out['phase_s']:.1f}s", flush=True)
    return out


MESH_WAVES = (8, 16, 32)        # one wave a bucket: each fills its bucket
MESH_WAIT_MS = 400.0            # a wave is queued whole before its flush
MESH_TENANTS = 4                # [mesh]'s fan-out tenants, 8 images each


def _waves(srv, images):
    """Serve ``images`` in MESH_WAVES: each wave's requests are submitted
    together and the wave's flush fills its bucket exactly, so two servers
    batch every image alike.  Returns the rows in image order."""
    rows, off = [], 0
    for n in MESH_WAVES:
        futs = [srv.submit(images[off + i]) for i in range(n)]
        rows += [f.result(timeout=120) for f in futs]
        off += n
    return np.stack(rows)


def phase_mesh(sepconv):
    """[mesh]: the device mesh and the weight policy on the served zoo
    Xception at 299x299, f32 with TF32 off, buckets 8/16/32.

      1. ``Server(mesh=get_mesh(), partition_rules=default_partition_rules)``
         serves rows bit for bit the plain ``Server``'s (the same waves,
         one bucket each), and so does ``donate_batch=True``; B1 launches
         30 a dispatch in every window (counts set to 0 just before each
         server's waves, read just after);
      2. ``varz()["sharding"]``: mesh (1, 1), ``sharded`` False, digest
         ``"replicated"``, ``param_bytes_total`` the module's counted
         tensors (its ``state_dict`` without ``num_batches_tracked``);
      3. ``HeadFanoutServer(mesh=get_mesh())``: MESH_TENANTS tenants over
         8 images each, every row bit for bit its per-tenant oracle (the
         head over the cached feature row), H1 one launch a head pass."""
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.ops import head as hops
    from sparkdl_tpu_torch.parallel.engine import dense_head_row
    from sparkdl_tpu_torch.parallel.mesh import (default_partition_rules,
                                                 get_mesh)
    from sparkdl_tpu_torch.serving import (HeadFanoutServer, InferenceCache,
                                           Server)
    from sparkdl_tpu_torch.transformers import named_image as ni
    from sparkdl_tpu_torch.utils.digest import content_digest

    tag = "mesh"
    out = {}
    size = get_model_spec("Xception").input_size[0]
    n = sum(MESH_WAVES)
    df = synthetic_frame(n, size, SEED + 91)
    images, ok = arrowStructsToBatch(df.table.column("image"), size, size)
    check(ok.all(), f"[{tag}] synthetic images failed to decode")
    mesh = get_mesh()
    check(mesh.shape == {"data": 1, "model": 1}
          and mesh.devices.flat[0].type == "cuda",
          f"[{tag}] get_mesh() is {mesh}, want (1, 1) on the card")
    module = ni._cached_model("Xception")
    counted = sum(t.numel() * t.element_size()
                  for k, t in module.state_dict().items()
                  if not k.endswith("num_batches_tracked"))
    kw = dict(featurize=True, max_batch_size=BATCH, bucket_sizes=[8, 16, 32],
              max_wait_ms=MESH_WAIT_MS, cache=False)
    policy = dict(mesh=mesh, partition_rules=default_partition_rules)
    rows = {}
    total = dict(sepconv=0, sepconv_tiled=0, mbconv=0)
    for name, extra in (("plain", {}), ("mesh", policy),
                        ("donate", dict(policy, donate_batch=True))):
        srv = Server("Xception", **kw, **extra)
        srv.warmup(images[0])
        before = dict(srv.metrics.counters)
        reset_counts(sepconv)
        rows[name] = _waves(srv, images)
        counts = read_counts(sepconv)
        batches = int(srv.metrics.counters.get("serving.batches", 0)
                      - before.get("serving.batches", 0))
        want = {k: v * batches for k, v in SERVED_XCEPTION.items()}
        check(batches == len(MESH_WAVES) and counts == want,
              f"[{tag}] {name} server: {batches} dispatches, launches "
              f"{counts}, want {len(MESH_WAVES)} and {want}")
        _add_counts(total, counts)
        info = srv.varz()["sharding"]
        srv.close()
        check(info["mesh_shape"] == {"data": 1, "model": 1}
              and info["sharded"] is False
              and info["sharding_digest"] == "replicated"
              and info["param_bytes_total"] == counted
              and info["param_bytes_per_chip"] == counted
              and info["donate_batch"] is (name == "donate"),
              f"[{tag}] {name} server's varz sharding {info}, want mesh "
              f"(1, 1), replicated, {counted} bytes")
        out[name] = dict(sharding=info, dispatches=batches, launches=counts)
    for name in ("mesh", "donate"):
        check(np.array_equal(rows[name], rows["plain"]),
              f"[{tag}] {name} server's rows != the plain server's: max "
              f"abs {np.abs(rows[name] - rows['plain']).max():.3g}")
    print(f"[{tag}] Server(Xception, featurize, buckets 8/16/32) on "
          f"get_mesh() {mesh.shape} with default_partition_rules, and with "
          f"donate_batch=True: {n} images in waves of {list(MESH_WAVES)} "
          f"bit for bit the plain server's; B1 {SEPCONV_PER_FORWARD} a "
          f"dispatch ({total['sepconv']} in {3 * len(MESH_WAVES)} "
          f"dispatches); varz sharding: mesh (1, 1), sharded False, digest "
          f"'replicated', param_bytes_total {counted} = the module's "
          f"counted tensors", flush=True)

    # 3. the head fan-out on the mesh
    rng = np.random.default_rng(SEED + 92)
    heads = {f"m{i}": {
        "kernel": (rng.normal(size=(HEAD_D, FANOUT_CLASSES))
                   / math.sqrt(HEAD_D)).astype(np.float32),
        "bias": rng.normal(size=(FANOUT_CLASSES,)).astype(np.float32)}
        for i in range(MESH_TENANTS)}
    fsrv = HeadFanoutServer("Xception", max_batch_size=BATCH, mesh=mesh,
                            cache=InferenceCache())
    for t, h in heads.items():
        fsrv.add_head(t, h)
    check(fsrv.device.type == "cuda" and fsrv.bank.device.type == "cuda",
          f"[{tag}] fan-out server not on the card")
    reqs = [(i, t) for t in heads for i in range(8)]
    before = dict(fsrv.metrics.counters)
    hops.head_pass.launches = 0
    served = [fsrv.predict(images[i], t) for i, t in reqs]
    h1 = hops.head_pass.launches
    passes = int(fsrv.metrics.counters.get("headbank.dispatches", 0)
                 - before.get("headbank.dispatches", 0))
    bad = 0
    for (i, t), row in zip(reqs, served):
        feats = fsrv.cache.get(fsrv.feature_namespace
                               + (content_digest(images[i]),))
        with torch.inference_mode():
            want = dense_head_row(
                {k: torch.from_numpy(v).cuda() for k, v in heads[t].items()},
                torch.from_numpy(np.ascontiguousarray(feats)).cuda()
            ).cpu().numpy()
        bad += row.tobytes() != want.tobytes()
    stats = fsrv.bank.stats()
    fsrv.close()
    check(bad == 0, f"[{tag}] {bad} fan-out rows != their per-tenant oracle")
    check(passes == len(reqs) and h1 == passes,
          f"[{tag}] fan-out: {passes} head passes for {len(reqs)} requests, "
          f"H1 {h1} launches (want one a pass)")
    check(stats["mesh_shape"] == {"data": 1, "model": 1},
          f"[{tag}] head bank stats {stats}")
    print(f"[{tag}] HeadFanoutServer(Xception, mesh=get_mesh()): "
          f"{len(reqs)} requests of {MESH_TENANTS} tenants, every row == its "
          f"per-tenant oracle bit for bit; {passes} head passes, H1 {h1} "
          f"launches; bank {stats['param_bytes_total']} bytes on mesh "
          f"{stats['mesh_shape']}", flush=True)
    out["fanout"] = dict(requests=len(reqs), passes=passes, h1=h1,
                         bank=stats)
    out["launches"] = dict(total, head_pass=h1)
    return out


TRAIN_ROWS = 48                 # [tuning]'s 48 JPEGs, batch 16
TRAIN_EPOCHS = 4                # 12 steps: 11 replays pay for a capture
TRAIN_SPE_ROWS = 80             # 5 steps an epoch: a group of 4 and a tail
TRAIN_SPE_EPOCHS = 11           # 50 replayed steps for 5 captured ones
TRAIN_STATS_EPOCHS = 6          # ResNet50's 16 rows: 12 steps of 8
TRAIN_RANK_ROWS = (28, 20)      # the two ranks' unequal shards
TRAIN_STREAM_CHUNKS = ((10, 10, 8), (12, 8))
TRAIN_STREAM_STEPS = 3          # the stream fit's pinned steps an epoch
TRAIN_CHILD_TIMEOUT_S = 300
RANK_AGREE_TOL = 1e-7           # the two ranks' fitted tensors (rel)


class _EagerSteps:
    """While entered, the train module's own ``step_mode`` answers eager:
    the eager reference of a captured fit runs the fit's own code
    (instrumentation of this script, no knob of the fit)."""

    def __enter__(self):
        from sparkdl_tpu_torch.parallel import train

        self._saved = train.step_mode
        train.step_mode = lambda *a, **k: ("eager", "the eager reference")
        return self

    def __exit__(self, *exc):
        from sparkdl_tpu_torch.parallel import train

        train.step_mode = self._saved


class _EpochLog:
    """Records every epoch of the fits run while entered: its seconds (the
    card synchronised on both ends), its per-step losses and the fit's
    step mode (wraps the train module's ``_StepRunner.run_epoch``)."""

    def __enter__(self):
        from sparkdl_tpu_torch.parallel import train

        self.epochs = []
        self.losses = []
        self.modes = []
        self._saved = train._StepRunner.run_epoch
        real = self._saved

        def logged(runner, batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = real(runner, batches)
            torch.cuda.synchronize()
            self.epochs.append((time.perf_counter() - t0, len(losses)))
            self.losses.extend(losses)
            self.modes.append(runner.mode)
            return losses

        train._StepRunner.run_epoch = logged
        return self

    def __exit__(self, *exc):
        from sparkdl_tpu_torch.parallel import train

        train._StepRunner.run_epoch = self._saved


def _train_model():
    """Config 5's model as [tuning] builds it (the committed Keras
    InceptionV3 config with seeded Keras-layout arrays): (the module on
    the card, the tensors a fit trains by name, the predict fn)."""
    from sparkdl_tpu_torch.estimators.image_file_estimator import \
        variable_names
    from sparkdl_tpu_torch.graph.function import ModelFunction, apply_with
    from sparkdl_tpu_torch.models import keras_import

    with open(KERAS_CONFIG) as f:
        config = json.load(f)
    mf = ModelFunction.from_keras(keras_import.keras_file(
        config, _keras_layers_for("InceptionV3", SEED + 31)))
    module = copy.deepcopy(mf.module).cuda().eval()
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    params = {n: tensors[n].detach() for n in variable_names(module)}

    def predict(p, x):
        return apply_with(mf.fn, module, p, x)

    return module, params, predict


_TRAIN_CHILD = """
import json, sys, time
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as c
from sparkdl_tpu_torch import resolve_device
from sparkdl_tpu_torch.param.converters import NamedOptimizer
from sparkdl_tpu_torch.parallel import distributed, train
from sparkdl_tpu_torch.utils.metrics import Metrics
rank, world, port, base = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
data = np.load(f"{base}/data.npz")
lo = sum(c.TRAIN_RANK_ROWS[:rank])
x = data["x"][lo:lo + c.TRAIN_RANK_ROWS[rank]]
y = data["y"][lo:lo + c.TRAIN_RANK_ROWS[rank]]
module, params, predict = c._train_model()
out = dict(rank=rank, device=str(resolve_device()),
           backend=distributed.backend(),
           modules=sorted(m for m in ("jax", "sparkdl_tpu")
                          if m in sys.modules))
kw = dict(optimizer=NamedOptimizer("sgd"), loss="categorical_crossentropy",
          batch_size=c.TUNING_BATCH, epochs=c.TRAIN_EPOCHS)
steps = []
grouped = train._StepRunner.run_epoch
def logged(runner, batches):
    losses = grouped(runner, batches)
    steps.extend(losses)
    return losses
train._StepRunner.run_epoch = logged
for name in ("arrays", "stream"):
    steps.clear()
    m = Metrics()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if name == "arrays":
        fitted, losses = train.fit_data_parallel(
            predict, params, x, y, checkpoint_dir=f"{base}/ckpt",
            checkpoint_every_epochs=c.TRAIN_EPOCHS, metrics=m, **kw)
    else:
        def source():
            off = 0
            for s in c.TRAIN_STREAM_CHUNKS[rank]:
                yield x[off:off + s], y[off:off + s]
                off += s
        fitted, losses = train.fit_data_parallel_stream(
            predict, params, source, steps_per_epoch=c.TRAIN_STREAM_STEPS,
            metrics=m, **kw)
    torch.cuda.synchronize()
    out[name] = dict(losses=list(steps), seconds=time.perf_counter() - t0,
                     counters={k: v for k, v in m.counters.items()
                               if k.startswith("train.")},
                     gauges={k: v for k, v in m.gauges.items()
                             if k.startswith("train.")})
    np.savez(f"{base}/{name}_{rank}.npz", **fitted)
distributed.shutdown()
print(json.dumps(out))
"""


def _train_ranks(base, world=2):
    """Run the two ranks of the group fit over gloo on this card; returns
    their JSON results.  A rank that outlives TRAIN_CHILD_TIMEOUT_S is
    killed and fails the phase."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, SPARKDL_TRACE="0")
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _TRAIN_CHILD, str(r), str(world),
                 str(port), base],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        results = []
        deadline = time.monotonic() + TRAIN_CHILD_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail(f"[train] rank {r} outlived {TRAIN_CHILD_TIMEOUT_S}s "
                     f"and was killed")
            check(p.returncode == 0, f"[train] rank {r} exited "
                                     f"{p.returncode}: {stderr[-3000:]}")
            results.append(json.loads(stdout.strip().splitlines()[-1]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _private_pool_bytes():
    """Bytes of the card's segments that belong to a private memory pool
    (every CUDA graph's; the default pool's are left out)."""
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def _global_batches(parts):
    """The steps of a group fit as one process sees them: each step's
    per-rank batches concatenated in rank order."""
    xs, ys = [], []
    for steps in zip(*parts):
        xs += [s[0] for s in steps]
        ys += [s[1] for s in steps]
    return np.concatenate(xs), np.concatenate(ys)


def phase_train(sepconv):
    """[train]: the rest of training on config 5's model, the user's Keras
    InceptionV3 at 299x299 as [tuning] builds it, batch 16, f32 with TF32
    off unless said; B1-B3 must not launch.  Every captured fit here is
    long enough for the train module's own rule to capture it (at least
    train.BREAK_EVEN_REPLAYS replays a captured step).

      1. captured against eager, for one SGD fit and one Adam fit of
         TRAIN_EPOCHS epochs over [tuning]'s 48 JPEGs (3 steps an epoch;
         the eager reference is the train module's own eager step), f32
         and TF32: with cuDNN's deterministic algorithms, per-step losses
         within TUNING_LOSS_TOL, the update within TUNING_UPDATE_TOL, and
         whether they are bit for bit; with its default algorithms (whose
         wgrad is not deterministic, eager against eager included) the
         same readings, printed; each fit's img/s (its last epoch, all
         replays), host us a step after the first, the graph pool's
         bytes, the capture seconds, and the replays that pay back a
         capture (capture s a captured step over the s a replay saves);
      2. ``steps_per_execution=4`` captured against 1, over 80 rows and
         TRAIN_SPE_EPOCHS epochs (5 steps an epoch: the warm-up step and
         a group of 4, then groups of 4 and ragged tails of 1): the same
         losses within 1e-6, one graph per group length, one loss fetch a
         group;
      3. ``trainBatchStats=True`` on the zoo's ResNet50 as [tuning] step 4
         runs it, TRAIN_STATS_EPOCHS epochs of 2 steps, cuDNN
         deterministic: captured against eager, the running statistics'
         move within TUNING_STATS_TOL;
      4. two ranks on this one card: two child processes over gloo on
         cuda:0, unequal shards (28 and 20 rows), each running
         ``fit_data_parallel`` (checkpointed at its end) then the stream
         fit with a pinned ``steps_per_epoch``, TRAIN_EPOCHS epochs each,
         in mode ``split``: both ranks' fitted tensors equal (bit for bit,
         or within RANK_AGREE_TOL), each fit within TUNING_LOSS_TOL /
         TUNING_UPDATE_TOL of a one-process fit stepped on the
         concatenated global batches, only rank 0's checkpoint on disk, a
         rank that hangs killed on a timeout;
      5. no fit's graph pool outlives it: the pools held and the card's
         reserved memory after the phase."""
    import tempfile

    from sparkdl_tpu_torch.estimators import ImageFileEstimator
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import load_model
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.parallel.engine import graph_pool_bytes_held
    from sparkdl_tpu_torch.utils.metrics import Metrics

    tag = "train"
    out = {}
    problems = []

    def expect(cond, msg):
        if not cond:
            print(f"FAIL (at the phase's end): {msg}", flush=True)
            problems.append(msg)

    gc.collect()
    torch.cuda.empty_cache()
    held0 = graph_pool_bytes_held()
    reserved0 = torch.cuda.memory_reserved()
    private0 = _private_pool_bytes()
    reset_counts(sepconv)
    module, params, predict = _train_model()
    init = {k: v.detach().cpu() for k, v in params.items()}
    with tempfile.TemporaryDirectory() as tmp:
        paths, labels = _tuning_files(os.path.join(tmp, "images"))
        x = np.stack([load_inception_v3(p) for p in paths])
        y = np.eye(1000, dtype=np.float32)[labels]

        def fit(opt, xs=x, ys=y, tf32=False, eager=False, det=False,
                **kw):
            m = Metrics()
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.deterministic = det
            try:
                with _EpochLog() as log:
                    if eager:
                        with _EagerSteps():
                            fitted, _ = train.fit_data_parallel(
                                predict, params, xs, ys,
                                optimizer=NamedOptimizer(opt),
                                loss="categorical_crossentropy",
                                batch_size=TUNING_BATCH, metrics=m, **kw)
                    else:
                        fitted, _ = train.fit_data_parallel(
                            predict, params, xs, ys,
                            optimizer=NamedOptimizer(opt),
                            loss="categorical_crossentropy",
                            batch_size=TUNING_BATCH, metrics=m, **kw)
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.deterministic = False
            last_s, last_n = log.epochs[-1]
            rec = dict(
                mode=[k.rsplit(".", 1)[1] for k in m.counters
                      if k.startswith("train.step_mode.")][0],
                img_s=last_n * TUNING_BATCH / last_s,
                step_s=last_s / last_n,
                fit_s=sum(s for s, _ in log.epochs),
                host_us_per_step=m.gauges.get("train.host_us_per_step"),
                pool_bytes=m.gauges.get("train.graph_pool_bytes", 0),
                capture_s=m.gauges.get("train.capture_s", 0.0),
                captures=m.counters.get("train.captures", 0),
                fetches=m.counters.get("train.loss_fetches"))
            return fitted, rec, np.asarray(log.losses)

        # 1. captured vs eager, f32 and TF32: held with cuDNN's
        # deterministic algorithms (cudnn.deterministic, the step's math
        # fixed), then timed with its defaults, whose wgrad algorithms
        # are not deterministic (eager against eager differs as much)
        comp = {}
        for opt in ("sgd", "adam"):
            for tf32 in (False, True):
                key = f"{opt}_{'tf32' if tf32 else 'f32'}"
                for det in (True, False):
                    runs = {}
                    # the default algorithms: a second eager fit reads the
                    # eager step's own spread
                    for name in (("captured", "eager") if det else
                                 ("captured", "eager", "eager2")):
                        runs[name] = fit(opt, tf32=tf32,
                                         eager=name != "captured", det=det,
                                         epochs=TRAIN_EPOCHS)
                    (cf, crec, closs), (ef, erec, eloss) = (
                        runs["captured"], runs["eager"])
                    spread = ""
                    if not det:
                        e2f, _, e2loss = runs["eager2"]
                        spread = (
                            f"; eager vs eager loss "
                            f"{float(np.max(np.abs(e2loss - eloss) / np.abs(eloss))):.3e}"
                            f", update " + format(_update_rel(
                                {k: torch.from_numpy(v)
                                 for k, v in ef.items()},
                                {k: torch.from_numpy(v)
                                 for k, v in e2f.items()}, init), ".3e"))
                    loss_rel = float(np.max(np.abs(closs - eloss)
                                            / np.abs(eloss)))
                    upd_rel = _update_rel(
                        {k: torch.from_numpy(v) for k, v in ef.items()},
                        {k: torch.from_numpy(v) for k, v in cf.items()},
                        init)
                    bits = (np.array_equal(closs, eloss) and all(
                        np.array_equal(cf[k], ef[k]) for k in ef))
                    algos = "deterministic" if det else "default"
                    # the replays a captured step needs to pay back its
                    # capture: capture s per captured step over the s a
                    # replayed step saves (train.BREAK_EVEN_REPLAYS)
                    saved = erec["step_s"] - crec["step_s"]
                    even = (crec["capture_s"] / crec["captures"] / saved
                            if saved > 0 and crec["captures"] else math.inf)
                    comp[f"{key}_{algos}"] = dict(
                        captured=crec, eager=erec, step_loss_rel=loss_rel,
                        update_rel=upd_rel, bit_for_bit=bits,
                        eager_spread=spread.lstrip("; "),
                        saved_ms_per_step=saved * 1e3,
                        break_even_replays=even, losses=closs.tolist())
                    print(f"[{tag}] {opt} fit, {TRAIN_EPOCHS} epochs of 3 "
                          f"steps, "
                          f"{'TF32' if tf32 else 'f32'}, cuDNN {algos} "
                          f"algorithms: captured {crec['img_s']:.1f} img/s "
                          f"(host {crec['host_us_per_step']:.0f} us a "
                          f"step, {crec['captures']} capture(s) in "
                          f"{crec['capture_s']:.2f}s, pool "
                          f"{crec['pool_bytes'] / 2**20:.0f} MiB) vs eager "
                          f"{erec['img_s']:.1f} img/s (host "
                          f"{erec['host_us_per_step']:.0f} us a step); "
                          f"step loss rel err {loss_rel:.3e}, update rel "
                          f"err {upd_rel:.3e}, bit for bit {bits}{spread}; "
                          f"a replay saves {saved * 1e3:.1f} ms a step, the "
                          f"capture pays back after {even:.1f} replays "
                          f"(train.BREAK_EVEN_REPLAYS "
                          f"{train.BREAK_EVEN_REPLAYS})", flush=True)
                    expect(crec["mode"] == "captured"
                           and erec["mode"] == "eager"
                           and crec["captures"] == 1,
                           f"[{tag}] {key}: modes {crec['mode']} / "
                           f"{erec['mode']}, {crec['captures']} captures")
                    expect(len(closs) == 3 * TRAIN_EPOCHS and (not det or (
                        loss_rel <= TUNING_LOSS_TOL
                        and upd_rel <= TUNING_UPDATE_TOL)),
                           f"[{tag}] {key} captured vs eager ({algos}): "
                           f"{len(closs)} steps, loss rel err "
                           f"{loss_rel:.4g} (tol {TUNING_LOSS_TOL}), update "
                           f"{upd_rel:.4g} (tol {TUNING_UPDATE_TOL})")
                    del runs, cf, ef
        out["captured_vs_eager"] = comp

        # 2. groups of 4 against groups of 1, both captured
        x80 = np.concatenate([x, x[:TRAIN_SPE_ROWS - TRAIN_ROWS]])
        y80 = np.concatenate([y, y[:TRAIN_SPE_ROWS - TRAIN_ROWS]])
        spe = {}
        for k in (1, 4):
            spe[k] = fit("adam", x80, y80, epochs=TRAIN_SPE_EPOCHS,
                         steps_per_execution=k)
        rel = float(np.max(np.abs(spe[4][2] - spe[1][2]) / np.abs(spe[1][2])))
        r4 = spe[4][1]
        n_steps = 5 * TRAIN_SPE_EPOCHS
        want_fetches = 2 * TRAIN_SPE_EPOCHS  # warm-up, 4 | then 4, 1 each
        expect(len(spe[4][2]) == n_steps and rel <= 1e-6
               and r4["mode"] == spe[1][1]["mode"] == "captured"
               and r4["captures"] == 2 and r4["fetches"] == want_fetches,
               f"[{tag}] steps_per_execution=4: {len(spe[4][2])} steps, loss "
               f"rel err {rel:.4g} vs 1 step a replay, modes {r4['mode']} / "
               f"{spe[1][1]['mode']}, {r4['captures']} captures (want 2), "
               f"{r4['fetches']} fetches (want {want_fetches})")
        print(f"[{tag}] adam, {TRAIN_SPE_ROWS} rows, {TRAIN_SPE_EPOCHS} "
              f"epochs, steps_per_execution=4 (groups: warm-up, 4 | 4, "
              f"tail 1 | ...) vs 1, both captured: loss rel err {rel:.3e}; "
              f"{r4['captures']} graphs, {r4['fetches']} loss fetches (vs "
              f"{spe[1][1]['fetches']}); {r4['img_s']:.1f} vs "
              f"{spe[1][1]['img_s']:.1f} img/s on the last epoch (all "
              f"replays); pool {r4['pool_bytes'] / 2**20:.0f} MiB vs "
              f"{spe[1][1]['pool_bytes'] / 2**20:.0f} MiB", flush=True)
        out["steps_per_execution"] = dict(
            loss_rel=rel, k4=r4, k1=spe[1][1])
        del spe

        # 3. trainBatchStats on the zoo's ResNet50, captured vs eager
        resnet = load_model("ResNet50", weights=None)
        before = resnet.state_dict()
        stat_keys = [k for k in before
                     if k.endswith(("running_mean", "running_var"))]
        onehot = np.eye(1000, dtype=np.float32)
        rdf = DataFrame({"uri": paths[:16], "label": labels[:16],
                         "onehot": [onehot[v].tolist()
                                    for v in labels[:16]]})
        rn, rn_modes = {}, {}
        torch.backends.cudnn.deterministic = True
        try:
            for eager in (False, True):
                est = ImageFileEstimator(
                    inputCol="uri", outputCol="preds", labelCol="onehot",
                    modelFunction=ModelFunction.from_module(
                        copy.deepcopy(resnet)),
                    imageLoader=load_resnet, optimizer="sgd", batchSize=8,
                    trainBatchStats=True,
                    fitParams={"epochs": TRAIN_STATS_EPOCHS})
                with _EpochLog() as log:
                    if eager:
                        with _EagerSteps():
                            m = est.fit(rdf)
                    else:
                        m = est.fit(rdf)
                rn[eager] = m.getModelFunction().module.state_dict()
                rn_modes[eager] = sorted(set(log.modes))
        finally:
            torch.backends.cudnn.deterministic = False
        stats_rel = _update_rel({k: rn[True][k] for k in stat_keys},
                                {k: rn[False][k] for k in stat_keys}, before)
        expect(stats_rel <= TUNING_STATS_TOL
               and rn_modes == {False: ["captured"], True: ["eager"]},
               f"[{tag}] ResNet50 trainBatchStats captured vs eager: "
               f"statistics rel err {stats_rel:.4g} (tol {TUNING_STATS_TOL}),"
               f" modes {rn_modes}")
        print(f"[{tag}] trainBatchStats=True on the zoo's ResNet50 (224x224, "
              f"{2 * TRAIN_STATS_EPOCHS} SGD steps of 8, cuDNN "
              f"deterministic): captured vs eager, {len(stat_keys)} "
              f"running statistics' move rel err {stats_rel:.3e} (tol "
              f"{TUNING_STATS_TOL})", flush=True)
        out["batch_stats_rel"] = stats_rel
        del rn, resnet

        # 4. two ranks on the one card over gloo
        base = os.path.join(tmp, "ranks")
        os.makedirs(base)
        np.savez(os.path.join(base, "data.npz"), x=x, y=y)
        t0 = time.perf_counter()
        ranks = _train_ranks(base)
        ranks_s = time.perf_counter() - t0
        local = TUNING_BATCH // 2
        shards, lo = [], 0
        for n in TRAIN_RANK_ROWS:
            shards.append((x[lo:lo + n], y[lo:lo + n]))
            lo += n
        steps = -(-TRAIN_ROWS // TUNING_BATCH)
        arrays_x, arrays_y = _global_batches(
            [[b for e in range(TRAIN_EPOCHS)
              for b in train._epoch_batches(xr, yr, local, e, True, 0,
                                            num_steps=steps)]
             for xr, yr in shards])

        def chunked(r):
            xr, yr = shards[r]
            off = 0
            for s in TRAIN_STREAM_CHUNKS[r]:
                yield xr[off:off + s], yr[off:off + s]
                off += s

        stream_x, stream_y = _global_batches(
            [[b for _ in range(TRAIN_EPOCHS)
              for b in train._stream_epoch_batches(
                  chunked(r), local, num_steps=TRAIN_STREAM_STEPS)]
             for r in range(2)])
        n_steps = steps * TRAIN_EPOCHS
        ranks_out = {}
        for name, gx, gy in (("arrays", arrays_x, arrays_y),
                             ("stream", stream_x, stream_y)):
            ref, rec, ref_loss = fit("sgd", gx, gy, epochs=1, shuffle=False)
            fits = [np.load(os.path.join(base, f"{name}_{r}.npz"))
                    for r in range(2)]
            agree = max(_update_rel(
                {k: torch.from_numpy(fits[0][k]) for k in ref},
                {k: torch.from_numpy(fits[1][k]) for k in ref},
                {k: torch.zeros(()) for k in ref}), 0.0)
            same_bits = all(np.array_equal(fits[0][k], fits[1][k])
                            for k in ref)
            losses = [np.asarray(ranks[r][name]["losses"]) for r in range(2)]
            loss_rel = float(np.max(np.abs(losses[0] - ref_loss)
                                    / np.abs(ref_loss)))
            upd_rel = _update_rel(
                {k: torch.from_numpy(v) for k, v in ref.items()},
                {k: torch.from_numpy(fits[0][k]) for k in ref}, init)
            modes = [ranks[r][name]["counters"] for r in range(2)]
            rows = n_steps * TUNING_BATCH
            img_s = rows / max(ranks[r][name]["seconds"] for r in range(2))
            expect(same_bits or agree <= RANK_AGREE_TOL,
                   f"[{tag}] two ranks' {name} fits differ: rel {agree:.3g}")
            expect(all(c.get("train.step_mode.split") == 1 for c in modes)
                   and rec["mode"] == "captured",
                   f"[{tag}] two-rank {name} fit: rank counters {modes}, "
                   f"one-process mode {rec['mode']}")
            expect(len(losses[0]) == n_steps and loss_rel <= TUNING_LOSS_TOL
                   and upd_rel <= TUNING_UPDATE_TOL,
                   f"[{tag}] two-rank {name} fit vs one process on the "
                   f"global batches: {len(losses[0])} steps, loss rel err "
                   f"{loss_rel:.4g}, update {upd_rel:.4g}")
            print(f"[{tag}] two ranks on {ranks[0]['device']} over "
                  f"{ranks[0]['backend']} ({TRAIN_RANK_ROWS} rows), {name} "
                  f"fit: ranks bit for bit {same_bits} (rel {agree:.2e}); "
                  f"vs one process on the concatenated global batches: "
                  f"loss rel err {loss_rel:.3e}, update {upd_rel:.3e}; "
                  f"{img_s:.1f} img/s across the group (fit "
                  f"{max(ranks[r][name]['seconds'] for r in range(2)):.2f}s, "
                  f"warm-up and captures included) vs one process "
                  f"{rows / rec['fit_s']:.1f} img/s; rank 0's counters "
                  f"{modes[0]}", flush=True)
            ranks_out[name] = dict(
                bit_for_bit=same_bits, rank_rel=agree, loss_rel=loss_rel,
                update_rel=upd_rel, img_s=img_s,
                one_process_img_s=rows / rec["fit_s"],
                counters=modes, gauges=[ranks[r][name]["gauges"]
                                        for r in range(2)])
        ckpts = sorted(os.listdir(os.path.join(base, "ckpt")))
        expect(ckpts == [f"epoch_{TRAIN_EPOCHS:06d}"],
               f"[{tag}] two-rank checkpoints {ckpts}, want rank 0's one")
        seen = [(r["device"], r["backend"], r["modules"]) for r in ranks]
        expect(all(r["modules"] == [] and r["backend"] == "gloo"
                   and r["device"].startswith("cuda") for r in ranks),
               f"[{tag}] ranks (device, backend, modules): {seen}")
        out["two_ranks"] = dict(ranks_out, checkpoints=ckpts,
                                wall_s=ranks_s)
    del module, params
    gc.collect()
    torch.cuda.empty_cache()
    held1 = graph_pool_bytes_held()
    reserved1 = torch.cuda.memory_reserved()
    private1 = _private_pool_bytes()
    counts = read_counts(sepconv)
    expect(counts == dict(sepconv=0, sepconv_tiled=0, mbconv=0),
           f"[{tag}] launches {counts}, want none of B1-B3")
    expect(held1 <= held0 and private1 <= private0,
           f"[{tag}] graph pools held {held1} after the phase, {held0} "
           f"before; private-pool segments {private1} after, {private0} "
           f"before: a fit's pool outlived it")
    print(f"[{tag}] pools held by live engines {held0 / 2**20:.1f} -> "
          f"{held1 / 2**20:.1f} MiB; the card's private-pool (CUDA graph) "
          f"segments {private0 / 2**20:.1f} -> {private1 / 2**20:.1f} MiB; "
          f"card memory reserved {reserved0 / 2**30:.2f} -> "
          f"{reserved1 / 2**30:.2f} GiB", flush=True)
    out["pools"] = dict(held_before=held0, held_after=held1,
                        private_before=private0, private_after=private1,
                        reserved_before=reserved0, reserved_after=reserved1)
    check(not problems, f"[{tag}] {len(problems)} failed: "
                        + " | ".join(problems))
    out["launches"] = counts
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.ops import sepconv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # full f32 in the plain and unfused references (see PERF.md)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    check(sparkdl_tpu_torch.resolve_device().type == "cuda",
          "entry points do not default to the card")
    for knob in ("SPARKDL_MNV2_FUSED", "SPARKDL_XC_TILED", "SPARKDL_S2D_STEM",
                 "SPARKDL_FUSED_HEADS", "SPARKDL_ZOO_COMPUTE_DTYPE",
                 "SPARKDL_RN_FUSED_SHORTCUT", "SPARKDL_WEIGHTS_DIR"):
        os.environ.pop(knob, None)
    phase_build(sepconv)
    b1 = phase_sepconv_kernel(sepconv, tiled=False)
    b1["max_abs_err"] = max(b1["max_abs_err"], phase_sepconv_ragged(sepconv))
    b3 = phase_sepconv_kernel(sepconv, tiled=True)
    b3["max_abs_err"] = max(b3["max_abs_err"],
                            phase_sepconv_tiled_ragged(sepconv))
    b2 = phase_mbconv_kernel(sepconv)
    b2["max_abs_err"] = max(b2["max_abs_err"], phase_mbconv_ragged(sepconv))
    h1 = phase_head_kernel()
    pools = {}
    b1["launches"], b1["tf32_unfused_rel_err"] = phase_xception(sepconv)
    pools["xception"] = pool_line("[xception]")
    b2["launches"], b2["mobilenet_forward_ms"] = phase_mobilenet(sepconv)
    pools["mobilenet"] = pool_line("[mobilenet]")
    b3["launches"] = phase_xception_tiled(sepconv)
    pools["xception_tiled"] = pool_line("[xception tiled]")
    inception = phase_inception(sepconv)
    pools["inception"] = pool_line("[inception]")
    print(json.dumps({"inception": inception}), flush=True)
    zoo2 = phase_zoo2(sepconv)
    pools["zoo2"] = pool_line("[zoo2]")
    print(json.dumps({"zoo2": zoo2}), flush=True)
    graph = phase_graph(sepconv)
    pools["graph"] = pool_line("[graph]")
    graph["pipeline"] = phase_pipeline(sepconv)
    pools["pipeline"] = pool_line("[pipeline]")
    print(json.dumps({"graph": graph}), flush=True)
    # every zoo engine of the phases above is still cached (within the
    # engine cache's bound on graph pools): nothing is cleared first
    keras = phase_keras(sepconv)
    pools["keras"] = pool_line("[keras]")
    print(json.dumps({"keras": keras}), flush=True)
    tuning = phase_tuning(sepconv)
    pools["tuning"] = pool_line("[tuning]")
    print(json.dumps({"tuning": tuning}), flush=True)
    native = phase_native(sepconv)
    pools["native"] = pool_line("[native]")
    print(json.dumps({"native": native}), flush=True)
    tfgraph = phase_tfgraph(sepconv)
    pools["tfgraph"] = pool_line("[tfgraph]")
    print(json.dumps({"tfgraph": tfgraph}), flush=True)
    serving = phase_serving(sepconv)
    pools["serving"] = pool_line("[serving]")
    print(json.dumps({"serving": serving}), flush=True)
    b1["serving_launches"] = serving["launches"]["sepconv"]
    b3["serving_launches"] = serving["launches"]["sepconv_tiled"]
    b2["serving_launches"] = serving["launches"]["mbconv"]
    fanout = phase_headfanout(sepconv)
    pools["headfanout"] = pool_line("[headfanout]")
    print(json.dumps({"headfanout": fanout}), flush=True)
    h1["launches"] = fanout["launches"]["head_pass"]
    b1["headfanout_launches"] = fanout["launches"]["sepconv"]
    obs = phase_obs(sepconv)
    pools["obs"] = pool_line("[obs]")
    print(json.dumps({"obs": obs}), flush=True)
    b1["obs_launches"] = obs["launches"]["sepconv"]
    h1["obs_launches"] = obs["launches"]["head_pass"]
    fleet = phase_fleet(sepconv)
    pools["fleet"] = pool_line("[fleet]")
    print(json.dumps({"fleet": fleet}), flush=True)
    b1["fleet_launches"] = fleet["launches"]["sepconv"]
    h1["fleet_launches"] = fleet["launches"]["head_pass"]
    stream = phase_stream(sepconv)
    pools["stream"] = pool_line("[stream]")
    print(json.dumps({"stream": stream}), flush=True)
    b1["stream_launches"] = stream["launches"]["sepconv"]
    mesh = phase_mesh(sepconv)
    pools["mesh"] = pool_line("[mesh]")
    print(json.dumps({"mesh": mesh}), flush=True)
    b1["mesh_launches"] = mesh["launches"]["sepconv"]
    h1["mesh_launches"] = mesh["launches"]["head_pass"]
    trained = phase_train(sepconv)
    pools["train"] = pool_line("[train]")
    print(json.dumps({"train": trained}), flush=True)
    print(json.dumps({"pools": pools}), flush=True)
    print(json.dumps({"kernels": [b1, b3, b2, h1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
