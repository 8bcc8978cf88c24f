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
    ``fleet.request`` spans parenting the servers' request spans; a
    fan-out entry (16 tenants' heads, a hot swap midway) bit for bit its
    per-tenant oracle; and the incident of ``tests/test_torch_fleet.py``
    (a breaker trip mid-rollout: a request shed at the door, the recovery,
    the promote).  B1 and H1 counted in every window;
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
    rank 0's checkpoint), and no fit's pool left behind;
  * [train_mesh] (after [train]), training on a mesh of several slots in
    one process, slots of cuda:0 (distinct cards where several are
    visible): the Xception featurizer and LogisticRegression on a dp2
    default mesh (B1 30 a forward in each data group, counted; the head
    against the one-device fit), config 5's InceptionV3 fitted on dp2
    against one device (and trainBatchStats on the zoo's InceptionV3),
    the predictions layer split over ``model`` on dp1 x tp2 and dp2 x tp2
    with SGD and Adam against the replicated step, fitMultiple's mesh
    slices against sequential fits, and no fit's pool left behind;
  * [compile] (right after the build), the persistent compile cache
    (``sparkdl_tpu_torch.parallel.compile_cache``): three child processes
    under ``SPARKDL_COMPILE_CACHE=<fresh temporary directory>``, each
    building the four kernel libraries through ``ops/build.py``, the zoo
    Xception featurizer at 299x299 (seeded weights, full width and depth)
    and one pinned batch of 32 through it (B1 30 launches, counted): A
    populates (4 nvcc runs), B, the restart, runs no nvcc (4 hits, the
    cache's files untouched, A's output bit for bit), C follows a tampered
    ``kernels`` record of B1 (purged, drift ``kernel:sepconv``, 4 nvcc
    runs, the same output); the seconds of each step and the cold start
    saved.  CUDA graphs are captured anew in every child;
  * [audit] (right after [compile]), the program audit, lint and lock-order
    checking (``sparkdl_tpu_torch.analysis``): the subset of programs the
    tier-1 test audits (``audit_subset``: the zoo Xception at bucket 8 and
    its predictor cut, the serving, fan-out, train and kernel programs)
    built on the meta device under the card's torch and diffed against
    the committed ``PROGRAMS_TORCH.lock.json`` (no finding, no drift);
    ``Server("Xception")`` at 299x299 in the lockfile's bf16, each bucket's
    capture (8/16/32) holding the record's kernel launches (B1 30) and
    output; the three kernel programs and the H1 heads program at their
    recorded shapes, each record's FLOPs beside its bound; the lockfile's
    consumers (``lockfile_model_fingerprint``, a fleet promote of the same
    weights keeping the result cache, the default cost ledger's FLOPs a
    row, a compile-cache manifest holding the lockfile's programs and a
    tampered copy's ``compile.invalidate`` with a GC code); and a child
    under ``SPARKDL_LOCKCHECK=1`` serving the zoo Xception through a fleet
    with a canary and a stream scorer, with no ``LockOrderError`` (the
    order graph's edges printed);
  * [twin] (last), the traffic twin (``sparkdl_tpu_torch.twin``) on the
    card: the canonical seeded day (288 ticks of 300 virtual seconds, 64
    tenants, 159,883 virtual requests through the port's fleet, admission,
    cache, rollout, SLOs, cost ledger and a stream scorer) under
    ``QuotaAutoscaler(DEFAULT_TENANT_QUOTA)``, its event digest and scores
    equal to the JAX package's day (a constant computed on the CPU), and
    ``tests/test_twin.py``'s small day twice, byte-identical to each other
    and to JAX's; wall seconds, virtual requests a wall second, and per
    fleet server its device, dispatches, captures and pool.  The day's
    model is the JAX twin's dense layer: none of the kernels runs;
  * [examples] (last), the port's examples and artifact tools:
    ``examples/port_flowers_top1.py --model Xception --batch-size 32`` in
    this process over a ``<root>/<class>/*.jpg`` tree of the five recipe
    colours x 32 tinted JPEGs (the zoo Xception at 299x299, seeded, bf16
    compute; B1 30 a forward, counted; top-1 above chance; img/s), then,
    as child processes started together, the other three examples (each
    exits 0 with its marker) and the tools: ``port_trace_summary`` and
    ``port_blackbox`` over the span, trace and flight dumps [obs], [fleet]
    and [stream] left (the [fleet] incident's ``rollout.start``,
    ``breaker.open``, ``fleet.shed``, ``rollout.promote`` in order; the
    [stream] journal clean), ``port_dryrun`` with ``ranks[2]`` and
    ``port_capture_profile Xception`` (B1 30 in its trace); then
    ``port_native_thread_scaling`` alone on 16 JPEGs.

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

Output: the card's name and power limit first, one line per phase, one
JSON line of [compile]'s numbers (each child's seconds, counts, digest
and cache state) after the build, one of [audit]'s (the re-audit, the
buckets' launches, the kernel programs' FLOPs and bounds, the consumers,
the lock-order child), then
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
pools), one of [train_mesh]'s (the head, the fits' modes, rates and
pools, the split steps, the mesh slices, pools), one of [train_ranks]'
(the split head, the featurizer's launches and the head on dp4, the
statistics, each against one process, ms a step and the all-reduces), one of [twin]'s (the day's wall seconds, rate, digest, scores and
servers; the small days), one of [examples]' (the flowers recipe's
img/s, top-1 and launches, every example's and tool's exit code and wall
seconds, the folded tables and timelines), one ``{"pools":
...}`` line (the graph pools held after every phase, by phase; later
phases add keys to it), one JSON line with every kernel's numbers (with
its launches in [serving], [headfanout], [obs], [fleet], [stream] and
[mesh], B1's ``train_mesh_launches`` in [train_mesh]'s featurizer and
``train_ranks_launches`` in [train_ranks]' two ranks' featurizers,
``compile_launches`` in [compile]'s children and its
``examples_launches`` in [examples]' flowers recipe; H1's
``launches`` are its [headfanout] launches), and last the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import copy
import ctypes
import gc
import json
import math
import os
import re
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
    with torch.cuda.graph(graph, pool=None):  # its own pool, freed below
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
        flops, nbytes = sepconv.sepconv_cost(n, hw, hw, c, f)
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
        flops, nbytes = sepconv.mbconv_cost(n, hw, hw, c, f)
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

    from sparkdl_tpu_torch.utils.metrics import profiled_kernels
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
    from sparkdl_tpu_torch.utils.metrics import profiled_kernels

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
    prof_total, prof_names, _ = profiled_kernels(g.graph.replay)
    prof_eager, eager_names, _ = profiled_kernels(lambda: eager(staged))
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
        except BaseException as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
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
        except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
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


def closed_loop(srv, images, n_clients, sepconv,
                per_forward=SERVED_XCEPTION):
    """``n_clients`` threads, each submitting one image and waiting for its
    row before the next, for at least SERVING_LOOP_S and SERVING_LOOP_N
    requests (at most SERVING_LOOP_MAX_S), as one counted window (each
    dispatch launching ``per_forward``, a mesh's data groups included);
    returns
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
        except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
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
        sepconv, srv, per_forward, f"closed loop at {n_clients} clients",
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
    1000}, capacity 64, in f32 weights and in bf16 weights; device ms
    (graph_ms), host us per call, the plain version's and the library's ms
    (``torch.bmm`` over the gathered heads plus the bias, bf16 weights
    widened to f32 first; never used by the port) and the bound: the
    bytes of the features, of every distinct head's kernel and bias (2 a
    bf16 weight), of the index and of the output, against 2 n D C f32
    operations outside the tensor cores.  The f32 figures make the entry;
    the bf16 ones, on the same inputs rounded to bf16, sit under its
    "bf16" key."""
    from sparkdl_tpu_torch.ops import head as hops

    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    inputs = [_head_bank_inputs(g, n, c) for n, c in HEAD_SHAPES]
    entry_ = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        rows, main = [], None
        for (n, c), (feats, idx, kernel, bias) in zip(HEAD_SHAPES, inputs):
            args = (feats, idx, kernel.to(dtype), bias.to(dtype))
            out = hops._head_pass_cuda(*args)
            torch.cuda.synchronize()
            ref = hops.head_pass_reference(*args)
            check(torch.isfinite(out).all().item() and out.shape == (n, c)
                  and out.dtype == torch.float32,
                  f"[kernel] H1 {tag} output at n={n} C={c}: "
                  f"{tuple(out.shape)} {out.dtype}")
            check(torch.equal(out, ref),
                  f"[kernel] H1 {tag} != plain version at n={n} C={c}: max "
                  f"abs {(out - ref).abs().max().item():.3g}")
            rows_long = idx.long()

            def library(args=args):
                w, b = args[2][rows_long].float(), args[3][rows_long].float()
                return torch.bmm(args[0][:, None], w)[:, 0] + b

            k_ms = graph_ms(lambda: hops._head_pass_cuda(*args))
            p_ms = graph_ms(lambda: hops.head_pass_reference(*args), calls=3)
            l_ms = graph_ms(library)
            # the median of three runs: one run can catch a host stall
            host = float(np.median([host_us_per_call(
                lambda: hops._head_pass_cuda(*args)) for _ in range(3)]))
            distinct = int(torch.unique(idx).numel())
            flops, nbytes = hops.head_pass_cost(n, HEAD_D, c, distinct,
                                                args[2].element_size())
            b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
            lib_err = (library() - ref).abs().max().item()
            row = dict(dtype=tag, shape=[n, HEAD_D, c], capacity=HEAD_CAP,
                       distinct_heads=distinct, max_abs_err=0.0, ms=k_ms,
                       plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                       bound_by=b_by, host_us_per_call=host,
                       library_max_abs_vs_plain=lib_err)
            rows.append(row)
            if (n, c) == HEAD_MAIN_SHAPE:
                main = row
            print(f"[kernel] H1 {tag} n={n} D={HEAD_D} C={c} cap={HEAD_CAP} "
                  f"({distinct} distinct heads): == plain version bit for "
                  f"bit; kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                  f"library_ms={l_ms:.4f} (bmm vs plain max abs "
                  f"{lib_err:.2e}) bound_ms={b_ms:.4f} ({b_by}) -> "
                  f"{b_ms / k_ms:.1%} of bound; host {host:.1f} us per call",
                  flush=True)
        entry_[tag] = {
            "launches": None, "max_abs_err": 0.0,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "host_us_per_launch": main["host_us_per_call"],
            "main_shape": main["shape"], "shapes": rows,
        }
    return {"name": "head_pass", "route": "cuda",
            "source": "sparkdl_tpu_torch/ops/csrc/head_fanout.cu",
            "replaces": "sparkdl_tpu/parallel/engine.py:307",
            "tpu_kernel": False, **entry_["float32"],
            "bf16": entry_["bfloat16"]}


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
      6. a bf16 bank: the 64 heads rounded to bf16 (torch tensors on the
         card) in a server on the same cache with ``hbm_budget_bytes`` 32
         MiB: stacked, 26,227,200 bytes (2 a weight); the warm replay from
         the cache, one H1 launch a pass, every row its per-tenant oracle
         (``dense_head_row`` over the bf16 head) bit for bit; 8 images
         against a CPU server on the same bf16 heads within
         FANOUT_CPU_REL_TOL;
      7. every server's pool, 0 after ``close()``.

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

    def build(bank=heads, **kw):
        t0 = time.perf_counter()
        srv = HeadFanoutServer("Xception", max_batch_size=BATCH, **kw)
        for t, h in bank.items():
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
            except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
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
                except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
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

    # 6. a bf16 bank of the same tenants, under the 32 MiB budget
    bf16_heads = {t: {k: torch.from_numpy(v).to(torch.bfloat16).cuda()
                      for k, v in h.items()} for t, h in heads.items()}
    half, half_add_s = build(bank=bf16_heads, cache=cache,
                             hbm_budget_bytes=FANOUT_BUDGET)
    hstats = half.head_stats()
    want_bytes = FANOUT_TENANTS * (HEAD_D * FANOUT_CLASSES
                                   + FANOUT_CLASSES) * 2
    check(hstats["mode"] == "stacked"
          and hstats["param_bytes_per_chip"] == want_bytes == 26_227_200
          and hstats["param_bytes_per_chip"] <= FANOUT_BUDGET,
          f"[{tag}] bf16 bank: {hstats}, want stacked at {want_bytes} bytes "
          f"under {FANOUT_BUDGET}")
    half.warm_head(np.zeros(HEAD_D, np.float32))
    half_times = []
    undo = _timed_dispatch(half.bank, half_times)
    (h_lat, h_rows, h_s), counts, counters, _ = _fanout_counted(
        sepconv, hops, half, "bf16 bank, warm pass",
        lambda: serve_seq(half, seq))
    undo()
    _add_counts(total, counts)
    check(counters.get("serving.batches", 0) == 0
          and counters["headfanout.feature_hits"] == FANOUT_REPLAY
          and counts["head_pass"] == FANOUT_REPLAY,
          f"[{tag}] bf16 warm pass: {counters.get('serving.batches', 0)} "
          f"backbone dispatches, {counts['head_pass']} H1 launches for "
          f"{FANOUT_REPLAY} requests")
    bad = sum(r.dtype != np.float32 or r.tobytes() != oracle(
        feats[i], bf16_heads[t]).tobytes() for r, (i, t) in zip(h_rows, seq))
    check(bad == 0, f"[{tag}] bf16 warm pass: {bad} rows != their "
                    f"per-tenant oracle")
    with sparkdl_tpu_torch.default_device("cpu"):
        cpu_half = HeadFanoutServer("Xception", max_batch_size=FANOUT_CPU_N,
                                    bucket_sizes=[FANOUT_CPU_N], cache=False)
    with cpu_half:
        for t in cpu_ts:
            cpu_half.add_head(t, {k: v.cpu() for k, v in
                                  bf16_heads[t].items()})
        check(cpu_half.head_stats()["param_bytes_total"]
              == len(cpu_ts) * (HEAD_D * FANOUT_CLASSES + FANOUT_CLASSES) * 2,
              f"[{tag}] CPU bf16 bank bytes {cpu_half.head_stats()}")
        cpu_half_rows, _, _, _ = _fanout_counted(
            sepconv, hops, cpu_half, "CPU server, bf16 bank",
            lambda: np.stack(cpu_half.predict_batch(
                list(images[:FANOUT_CPU_N]), cpu_ts)))
    card_half = np.stack(half.predict_batch(list(images[:FANOUT_CPU_N]),
                                            cpu_ts))
    rel_half = _rel(card_half, cpu_half_rows)
    check(rel_half <= FANOUT_CPU_REL_TOL,
          f"[{tag}] bf16 bank, card vs CPU server: rel err {rel_half:.3g} > "
          f"{FANOUT_CPU_REL_TOL}")
    half.close()
    check(half.graph_pool_bytes == 0, f"[{tag}] bf16 server pool")
    out["bf16"] = dict(bank_bytes=hstats["param_bytes_per_chip"],
                       mode=hstats["mode"], add_s=half_add_s,
                       p50_ms=_pcts(h_lat)[0], p99_ms=_pcts(h_lat)[1],
                       req_per_s=FANOUT_REPLAY / h_s,
                       host_us_per_head_pass=float(
                           np.mean(half_times)) * 1e6,
                       host_us_per_head_pass_p50=float(
                           np.median(half_times)) * 1e6,
                       launches=dict(counts),
                       card_vs_cpu_rel_err=rel_half)
    print(f"[{tag}] bf16 bank: {FANOUT_TENANTS} heads in bf16 (torch on the "
          f"card), {hstats['param_bytes_per_chip']} bytes at capacity "
          f"{hstats['capacity']}, {hstats['mode']} under hbm_budget_bytes "
          f"{FANOUT_BUDGET >> 20} MiB (f32: {stats['param_bytes_per_chip']} "
          f"bytes); warm replay {FANOUT_REPLAY / h_s:.1f} req/s, p50 "
          f"{_pcts(h_lat)[0]:.3f} ms p99 {_pcts(h_lat)[1]:.3f} ms, host "
          f"{out['bf16']['host_us_per_head_pass']:.0f} us per head pass (p50 "
          f"{out['bf16']['host_us_per_head_pass_p50']:.0f}), "
          f"{counts['head_pass']} H1 launches for {FANOUT_REPLAY} passes; "
          f"every row == its per-tenant oracle bit for bit; card vs a CPU "
          f"server on the same bf16 heads ||a-b||/||b|| = {rel_half:.3e} "
          f"(tol {FANOUT_CPU_REL_TOL})", flush=True)

    # 7. pools
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
        except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
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
                metered_s=float(counters.get("engine.call_host_s", 0.0))
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


def _obs_children(tag, keep=None):
    """The two subprocesses, run at once: one with ``SPARKDL_TRACE=<dir>``
    that serves and exits (``trace_<pid>.json`` and ``spans_<pid>.jsonl``,
    read back by ``load_spans``), one with ``SPARKDL_BLACKBOX=<dir>`` sent
    SIGTERM while it serves (its dump read back by ``load_flight``).
    Both are stopped whatever happens.  With ``keep`` (a directory), the
    two artifact directories are copied there as ``trace`` and ``flight``
    for [examples]' tools."""
    import shutil
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
        if keep is not None:
            shutil.copytree(tdir, os.path.join(keep, "trace"))
            shutil.copytree(bdir, os.path.join(keep, "flight"))
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


def phase_obs(sepconv, keep=None):
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
    # the ledger names a program by its record in the port's program
    # lockfile (zoo/Xception/featurize/bfloat16/b8), as JAX's by its own
    b8 = [p for p in ledger.snapshot()["programs"] if p.endswith("/b8")]
    check(len(b8) == 1, f"[{tag}] ledger programs at bucket 8: {b8}")
    program = b8[0]
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
    out["children"] = _obs_children(tag, keep)

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
FLEET_INCIDENT_COOLDOWN_S = 1.0  # the incident's breaker cooldown: a
                                 # warm canary request takes ~10 ms


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


def _fleet_incident(tag, states, image):
    """The incident of ``tests/test_torch_fleet.py``'s ``_incident`` on the
    card: a breaker trip mid-rollout, then recovery and the promote.  A
    fleet of the zoo Xception at bucket 8 (v1) with a v2 canary at
    fraction 0.5, one request down each leg first; under
    ``engine.dispatch:error:exc=dead,every=1,times=2`` the first request
    (stable leg) fails both attempts and opens the breaker, the second
    (canary) is served, the third (stable leg, breaker open) is shed at
    the fleet's door; after the cooldown two requests are served and v2
    is promoted.  Emits ``rollout.start``, ``breaker.open``, ``fleet.shed``
    and ``rollout.promote`` into the process recorder, in that order."""
    from sparkdl_tpu_torch import faults
    from sparkdl_tpu_torch.serving import Fleet, ServiceUnavailableError

    plan = faults.FaultPlan.parse(
        "seed=9;engine.dispatch:error:exc=dead,every=1,times=2")
    shed = 0
    t0 = time.perf_counter()
    with Fleet(max_batch_size=FLEET_BATCH, max_wait_ms=1,
               bucket_sizes=[FLEET_BATCH], dispatch_retries=1,
               breaker_threshold=2,
               breaker_cooldown_s=FLEET_INCIDENT_COOLDOWN_S) as fleet:
        fleet.add_model("xc", "Xception", featurize=True,
                        warm_example=image)
        fleet.add_version("xc", states[2], label="v2")
        fleet.start_rollout("xc", canary_fraction=0.5, warm_example=image)
        for _ in range(2):
            fleet.predict("xc", image)
        with faults.active(plan):
            failed = fleet.submit("xc", image).exception(timeout=120)
            for _ in range(2):
                try:
                    fleet.submit("xc", image).result(timeout=120)
                except ServiceUnavailableError:
                    shed += 1
            time.sleep(FLEET_INCIDENT_COOLDOWN_S + 0.05)
            for _ in range(2):
                fleet.submit("xc", image).result(timeout=120)
            fleet.promote("xc")
        state = fleet.health()["state"]
        version = fleet.deployed_version("xc")
    wall = time.perf_counter() - t0
    check(failed is not None and shed == 1 and state == "ready"
          and version == 2,
          f"[{tag}] incident: first request failed {failed!r}, shed {shed}, "
          f"health {state}, deployed v{version}")
    print(f"[{tag}] incident (a breaker trip mid-rollout, "
          f"engine.dispatch dead x2, cooldown {FLEET_INCIDENT_COOLDOWN_S}s): "
          f"the first request failed ({type(failed).__name__}), {shed} shed "
          f"at the door, recovered, v2 promoted, health {state}; "
          f"{wall:.2f}s", flush=True)
    return dict(shed=shed, state=state, seconds=wall)


def phase_fleet(sepconv, keep=None):
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
         and H1 counted;
      5. the incident (:func:`_fleet_incident`): a breaker trip
         mid-rollout, a request shed at the door, the recovery and the
         promote.

    With ``keep`` (a directory), the traced spans of step 3 are written
    there (``spans.jsonl``, ``trace.json``) and the recorder's events of
    the whole phase (``flight.jsonl``), for [examples]' tools.
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
        except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
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
    if keep is not None:
        from sparkdl_tpu_torch.obs.export import (write_chrome_trace,
                                                  write_spans_jsonl)

        write_spans_jsonl(os.path.join(keep, "spans.jsonl"), spans)
        write_chrome_trace(os.path.join(keep, "trace.json"), spans)
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
            except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
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
    check(v2.graph_pool_bytes == 0 and fan.graph_pool_bytes == 0,
          f"[{tag}] close() kept a pool")
    out["incident"] = _fleet_incident(tag, states, images[0])
    if keep is not None:
        check(recorder.dump(os.path.join(keep, "flight.jsonl")),
              f"[{tag}] the flight dump was not written")
    oflight.configure(enabled=False)
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


def phase_stream(sepconv, keep=None):
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
        if keep is not None:  # the resumed run's journal, for [examples]
            shutil.copy(os.path.join(base, "journal.jsonl"),
                        os.path.join(keep, "journal.jsonl"))
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
        if keep is not None:  # the stall and the flaky source, for [examples]
            check(recorder.dump(os.path.join(keep, "flight.jsonl")),
                  f"[{tag}] the flight dump was not written")
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
MESH_DEVICE = "cuda:0"          # the card whose slots the layouts repeat
# (name, data, model) of the served Xception's layouts (a)-(c)
MESH_LAYOUTS = (("a", 2, 1), ("b", 1, 2), ("c", 2, 4))
MESH_CLIENTS = 8                # req/s of each layout at this many clients
MESH_LOOP_WAIT_MS = 5.0         # the loops' flush wait: Server's default, as
                                # [serving]'s loops run (the waves' 400 ms
                                # would set a loop's pace)
MESH_REL_TOL = KERNEL_TOL["rtol"]   # bf16 rows vs one device: ~2 bf16 steps
MESH_F32_REL_TOL = INCEPTION_ROUTE_TOL  # f32 budget buster vs one device
MESH_FEATURIZE_N = 64           # (f): images the default featurizer scores


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


def _rel_max(a, b):
    """The largest difference over the largest magnitude of ``b``."""
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / max(np.abs(b).max(), 1e-30))


def _mesh_slots(n, distinct):
    """``n`` slots: all MESH_DEVICE, or spread over the visible cards."""
    if not distinct:
        return [MESH_DEVICE] * n
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def _mesh_layout(sepconv, tag, name, slots, model, images, ref_rows, kw):
    """One served layout: ``Server("Xception", mesh=...)`` over ``slots``
    under the zoo's default rules, its waves (counted), its rows against
    the one-device rows, its sharding_info(), pools and req/s."""
    from sparkdl_tpu_torch.parallel.mesh import get_mesh
    from sparkdl_tpu_torch.serving import Server

    mesh = get_mesh(devices=slots, model_parallel=model)
    dp = int(mesh.shape["data"])
    per = {k: v * dp for k, v in SERVED_XCEPTION.items()}
    srv = Server("Xception", **kw, mesh=mesh)
    srv.warmup(images[0])
    info = srv.sharding_info()
    print(f"[{tag}] ({name}) mesh {mesh.shape} slots {info['slots']}; "
          f"sharding_info {json.dumps(info, sort_keys=True)}", flush=True)
    before = dict(srv.metrics.counters)
    reset_counts(sepconv)
    rows = _waves(srv, images)
    counts = read_counts(sepconv)
    batches = int(srv.metrics.counters.get("serving.batches", 0)
                  - before.get("serving.batches", 0))
    want = {k: v * batches for k, v in per.items()}
    check(batches == len(MESH_WAVES) and counts == want,
          f"[{tag}] ({name}): {batches} dispatches, launches {counts}, "
          f"want {len(MESH_WAVES)} and {want}")
    same = bool(np.array_equal(rows, ref_rows))
    rel = _rel_max(rows, ref_rows)
    moved = float(np.mean(rows != ref_rows))
    check(same or rel <= MESH_REL_TOL,
          f"[{tag}] ({name}) rows vs one device: rel {rel:.3g} > "
          f"{MESH_REL_TOL}")
    if model > 1:
        check(info["sharded_leaves"] > 0
              and info["param_bytes_per_chip"] < info["param_bytes_total"]
              and info["param_bytes_per_slot"] < info["param_bytes_total"],
              f"[{tag}] ({name}) weights not split: {info}")
    eng = next(iter(srv._engines.values()))
    pools = eng.pool_bytes_per_device()
    srv._batcher.max_wait_s = MESH_LOOP_WAIT_MS / 1e3
    loop = closed_loop(srv, images, MESH_CLIENTS, sepconv, per)
    srv.close()
    print(f"[{tag}] ({name}) B1 {counts['sepconv']} launches in "
          f"{batches} dispatches ({per['sepconv']} a dispatch: "
          f"{SEPCONV_PER_FORWARD} a forward in each of {dp} data groups, on "
          f"whole operands: the rules leave the sepconv weights whole and "
          f"the activations reaching B1 are gathered), H1 0; rows vs one "
          f"device: {'bit for bit' if same else f'max rel {rel:.3g}'} "
          f"(limit {MESH_REL_TOL}; ||a-b||/||b|| {_rel(rows, ref_rows):.3g}, "
          f"{moved:.2%} of the values moved); pools "
          f"{ {k: round(v / 2**20, 1) for k, v in pools.items()} } MiB; "
          f"{loop['requests_per_s']:.1f} req/s at {MESH_CLIENTS} clients, "
          f"p50 {loop['p50_ms']:.2f} ms, B1 {loop['launches']['sepconv']} in "
          f"{loop['batches']} dispatches", flush=True)
    return dict(mesh_shape=info["mesh_shape"], slots=info["slots"],
                sharding=info, launches=counts, dispatches=batches,
                bit_for_bit=same, rel=rel, moved=moved,
                pool_bytes_per_device=pools, closed_loop=loop)


def _mesh_fanout(sepconv, tag, name, slots, images, heads):
    """(d): ``HeadFanoutServer`` on dp2 over ``slots``; every row bit for
    bit its per-tenant oracle; H1 once a pass in each data group."""
    from sparkdl_tpu_torch.ops import head as hops
    from sparkdl_tpu_torch.parallel.engine import dense_head_row
    from sparkdl_tpu_torch.parallel.mesh import get_mesh
    from sparkdl_tpu_torch.serving import HeadFanoutServer, InferenceCache
    from sparkdl_tpu_torch.utils.digest import content_digest

    mesh = get_mesh(devices=slots)
    dp = int(mesh.shape["data"])
    fsrv = HeadFanoutServer("Xception", max_batch_size=BATCH, mesh=mesh,
                            cache=InferenceCache())
    for t, h in heads.items():
        fsrv.add_head(t, h)
    reqs = [(i, t) for t in heads for i in range(8)]
    fsrv.predict(images[0], next(iter(heads)))  # warm the backbone bucket
    before = dict(fsrv.metrics.counters)
    reset_counts(sepconv)
    hops.head_pass.launches = 0
    served = [fsrv.predict(images[i], t) for i, t in reqs]
    h1 = hops.head_pass.launches
    counts = read_counts(sepconv)
    passes = int(fsrv.metrics.counters.get("headbank.dispatches", 0)
                 - before.get("headbank.dispatches", 0))
    bad = 0
    for (i, t), row in zip(reqs, served):
        feats = fsrv.cache.get(fsrv.feature_namespace
                               + (content_digest(images[i]),))
        with torch.inference_mode():
            want = dense_head_row(
                {k: torch.from_numpy(v).to(MESH_DEVICE)
                 for k, v in heads[t].items()},
                torch.from_numpy(np.ascontiguousarray(feats)).to(
                    MESH_DEVICE)).cpu().numpy()
        bad += row.tobytes() != want.tobytes()
    stats = fsrv.bank.stats()
    info = fsrv.backbone.sharding_info()
    fsrv.close()
    check(bad == 0, f"[{tag}] ({name}) {bad} fan-out rows != their "
          f"per-tenant oracle")
    check(passes == len(reqs) and h1 == dp * passes,
          f"[{tag}] ({name}) {passes} head passes for {len(reqs)} requests, "
          f"H1 {h1} launches (want {dp} a pass)")
    check(stats["mesh_shape"] == {"data": dp, "model": 1},
          f"[{tag}] ({name}) head bank stats {stats}")
    print(f"[{tag}] ({name}) HeadFanoutServer(Xception) on mesh "
          f"{mesh.shape} slots {info['slots']}: {len(reqs)} requests of "
          f"{len(heads)} tenants, every row == its per-tenant oracle bit for "
          f"bit; {passes} head passes, H1 {h1} launches ({dp} a pass, one "
          f"in each data group), B1 {counts['sepconv']}", flush=True)
    return dict(mesh_shape=stats["mesh_shape"], slots=info["slots"],
                requests=len(reqs), passes=passes, h1=h1,
                launches=counts)


def _mesh_budget_buster(tag):
    """(e): ``wide_dense_fn`` at 128 x 131072 f32 on dp1 x tp8 over
    MESH_DEVICE's slots, against a one-device engine: each slot holds
    8 MiB of kernel and the bias, under GC005's 32 MB budget."""
    from sparkdl_tpu_torch.analysis.program.audit import (
        REPLICATED_PARAM_BUDGET_BYTES)
    from sparkdl_tpu_torch.analysis.program.inventory import (
        WIDE_DENSE_IN, WIDE_DENSE_OUT, wide_dense_fn)
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.parallel.mesh import (default_partition_rules,
                                                 get_mesh)

    rng = np.random.default_rng(SEED + 93)
    module = torch.nn.Module()
    module.dense = torch.nn.Module()
    module.dense.register_buffer("kernel", torch.from_numpy(rng.normal(
        scale=0.05, size=(WIDE_DENSE_IN, WIDE_DENSE_OUT)).astype(
            np.float32)))
    module.dense.register_buffer("bias", torch.from_numpy(rng.normal(
        size=(WIDE_DENSE_OUT,)).astype(np.float32)))
    x = rng.normal(size=(32, WIDE_DENSE_IN)).astype(np.float32)
    mesh = get_mesh(devices=_mesh_slots(8, False), model_parallel=8)
    tp = InferenceEngine(wide_dense_fn, module, mesh=mesh,
                         device_batch_size=32,
                         partition_rules=default_partition_rules)
    one = InferenceEngine(wide_dense_fn, module, device=MESH_DEVICE,
                          device_batch_size=32)
    got, want = tp(x), one(x)
    info = tp.sharding_info()
    slot_want = WIDE_DENSE_IN * WIDE_DENSE_OUT * 4 // 8 + WIDE_DENSE_OUT * 4
    same = bool(np.array_equal(got, want))
    rel = _rel_max(got, want)
    staged, ostaged = tp._pad(x), one._pad(x)
    ms = dict(tp8=cuda_ms(lambda: tp.run_padded(staged), reps=20),
              one=cuda_ms(lambda: one.run_padded(ostaged), reps=20))
    pools = tp.pool_bytes_per_device()
    tp.release_graphs()
    one.release_graphs()
    check(same or rel <= MESH_F32_REL_TOL,
          f"[{tag}] (e) budget buster rows vs one device: rel {rel:.3g}")
    check(info["param_bytes_total"] > REPLICATED_PARAM_BUDGET_BYTES
          and info["param_bytes_per_chip"] < REPLICATED_PARAM_BUDGET_BYTES
          and info["param_bytes_per_slot"] == slot_want
          and info["split_groups"] == "captured",
          f"[{tag}] (e) budget buster layout {info}")
    print(f"[{tag}] (e) wide_dense_fn {WIDE_DENSE_IN}x{WIDE_DENSE_OUT} f32 "
          f"on mesh {info['mesh_shape']} slots {info['slots']}: "
          f"{info['param_bytes_total']} B in all, "
          f"{info['param_bytes_per_slot']} B a slot (8 MiB kernel + bias; "
          f"budget {REPLICATED_PARAM_BUDGET_BYTES}), "
          f"{info['bytes_per_device']} held; rows vs one device: "
          f"{'bit for bit' if same else f'rel {rel:.3g}'} (limit "
          f"{MESH_F32_REL_TOL}); dispatch {ms['tp8']:.3f} ms split against "
          f"{ms['one']:.3f} ms on one device; pools "
          f"{ {k: round(v / 2**20, 1) for k, v in pools.items()} } MiB",
          flush=True)
    return dict(sharding=info, bit_for_bit=same, rel=rel, ms=ms,
                pool_bytes_per_device=pools)


def _mesh_featurizer(sepconv, tag):
    """(f): ``DeepImageFeaturizer("Xception")`` with no mesh and no device
    given: the mesh it chose and the card count."""
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.transformers import named_image as ni

    size = 299
    df = synthetic_frame(MESH_FEATURIZE_N, size, SEED + 94)
    with sparkdl_tpu_torch.default_device(None):
        feat = ni.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                      modelName="Xception", batchSize=BATCH)
        eng = ni._zoo_engine("Xception", True, BATCH)
        feat.transform(df)  # its graphs captured outside the window
        reset_counts(sepconv)
        out = feat.transform(df)
        counts = read_counts(sepconv)
    f = np.asarray(out.table.column("f").to_pylist(), np.float32)
    dp = int(eng.mesh.shape["data"])
    pieces = -(-MESH_FEATURIZE_N // eng.device_batch_size)
    check(f.shape == (MESH_FEATURIZE_N, 2048) and np.isfinite(f).all(),
          f"[{tag}] (f) features {f.shape}")
    check(counts["sepconv"] == SEPCONV_PER_FORWARD * dp * pieces,
          f"[{tag}] (f) B1 {counts}, want {SEPCONV_PER_FORWARD} a forward "
          f"in each of {dp} groups over {pieces} batches")
    slots = [str(d) for d in eng.mesh.devices.flat]
    print(f"[{tag}] (f) DeepImageFeaturizer(Xception) with no mesh given: "
          f"mesh {eng.mesh.shape} slots {slots}, "
          f"{torch.cuda.device_count()} card(s) visible; "
          f"{MESH_FEATURIZE_N} images, B1 {counts['sepconv']}", flush=True)
    return dict(mesh_shape=eng.mesh.shape, slots=slots,
                cards=torch.cuda.device_count(), launches=counts)


def phase_mesh(sepconv):
    """[mesh]: the device mesh and the weight policy on the served zoo
    Xception at 299x299, buckets 8/16/32.

      1. f32 with TF32 off, on this process's one-device mesh:
         ``Server(mesh=get_mesh(), partition_rules=default_partition_rules)``
         serves rows bit for bit the plain ``Server``'s (the same waves,
         one bucket each), and so does ``donate_batch=True``; B1 launches
         30 a dispatch in every window (counts set to 0 just before each
         server's waves, read just after); ``varz()["sharding"]``: mesh
         (1, 1), ``sharded`` False, digest ``"replicated"``,
         ``param_bytes_total`` the module's counted tensors; and
         ``HeadFanoutServer(mesh=get_mesh())``: MESH_TENANTS tenants over 8
         images each, every row bit for bit its per-tenant oracle, H1 one
         launch a head pass.
      2. bf16 compute (the served dtype), on meshes of several slots of
         MESH_DEVICE (and, where two or more cards are visible, of
         distinct cards), each layout's servers closed before the next:
         (a) dp2 x tp1, (b) dp1 x tp2 and (c) dp2 x tp4 under the zoo's
         default rules: B1 30 a forward in each data group, rows within
         MESH_REL_TOL of the one-device server's, the weights split under
         (b) and (c), req/s at MESH_CLIENTS clients; (d)
         ``HeadFanoutServer`` on dp2: rows bit for bit their oracles, H1
         once a pass in each group; (e) the budget buster (f32) on dp1 x
         tp8; (f) ``DeepImageFeaturizer("Xception")`` with no mesh given,
         the mesh it chose."""
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
    mesh = get_mesh()  # one card: main pins cuda:0 where more are visible
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

    # 2. meshes of several slots, bf16 compute: (a)-(f)
    t_part = time.perf_counter()
    kw = dict(featurize=True, max_batch_size=BATCH, bucket_sizes=[8, 16, 32],
              max_wait_ms=MESH_WAIT_MS, cache=False)
    layouts = {}
    with env_knobs({"SPARKDL_ZOO_COMPUTE_DTYPE": "bfloat16"}):
        ref = Server("Xception", **kw, device=MESH_DEVICE)
        ref.warmup(images[0])
        reset_counts(sepconv)
        ref_rows = _waves(ref, images)
        _add_counts(total, read_counts(sepconv))
        ref._batcher.max_wait_s = MESH_LOOP_WAIT_MS / 1e3
        ref_loop = closed_loop(ref, images, MESH_CLIENTS, sepconv)
        _add_counts(total, ref_loop["launches"])
        ref_pool = ref.graph_pool_bytes
        ref.close()
        print(f"[{tag}] one device (bf16, {MESH_DEVICE}): "
              f"{ref_loop['requests_per_s']:.1f} req/s at {MESH_CLIENTS} "
              f"clients, p50 {ref_loop['p50_ms']:.2f} ms; pool "
              f"{ref_pool / 2**20:.1f} MiB", flush=True)
        layouts["one"] = dict(closed_loop=ref_loop, pool_bytes=ref_pool)
        variants = [False] + ([True] if torch.cuda.device_count() > 1
                              else [])
        for distinct in variants:
            for name, dp, tp in MESH_LAYOUTS:
                key = name + ("_cards" if distinct else "")
                r = _mesh_layout(sepconv, tag, key,
                                 _mesh_slots(dp * tp, distinct), tp, images,
                                 ref_rows, kw)
                _add_counts(total, r["launches"])
                _add_counts(total, r["closed_loop"]["launches"])
                layouts[key] = r
        rng = np.random.default_rng(SEED + 95)
        heads2 = {f"d{i}": {
            "kernel": (rng.normal(size=(HEAD_D, FANOUT_CLASSES))
                       / math.sqrt(HEAD_D)).astype(np.float32),
            "bias": rng.normal(size=(FANOUT_CLASSES,)).astype(np.float32)}
            for i in range(MESH_TENANTS)}
        for distinct in variants:
            key = "d" + ("_cards" if distinct else "")
            r = _mesh_fanout(sepconv, tag, key, _mesh_slots(2, distinct),
                             images, heads2)
            _add_counts(total, r["launches"])
            h1 += r["h1"]
            layouts[key] = r
    layouts["e"] = _mesh_budget_buster(tag)
    layouts["f"] = _mesh_featurizer(sepconv, tag)
    _add_counts(total, layouts["f"]["launches"])
    out["layouts"] = layouts
    out["layouts_s"] = time.perf_counter() - t_part
    print(f"[{tag}] layouts (a)-(f) in {out['layouts_s']:.1f}s", flush=True)
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


def _train_model_fn():
    """Config 5's model as [tuning] builds it (the committed Keras
    InceptionV3 config with seeded Keras-layout arrays): (its function,
    the module on the card, the tensors a fit trains by name)."""
    from sparkdl_tpu_torch.estimators.image_file_estimator import \
        variable_names
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import keras_import

    with open(KERAS_CONFIG) as f:
        config = json.load(f)
    mf = ModelFunction.from_keras(keras_import.keras_file(
        config, _keras_layers_for("InceptionV3", SEED + 31)))
    module = copy.deepcopy(mf.module).cuda().eval()
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    params = {n: tensors[n].detach() for n in variable_names(module)}
    return mf.fn, module, params


def _train_model():
    """:func:`_train_model_fn`'s model: (the module on the card, the
    tensors a fit trains by name, the predict fn)."""
    from sparkdl_tpu_torch.graph.function import apply_with

    fn, module, params = _train_model_fn()

    def predict(p, x):
        return apply_with(fn, module, p, x)

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


def _train_ranks(base, world=2, child=None, tag="train", timeout=None):
    """Run the ranks of a group fit over gloo on this card (``child``: the
    rank's code, default _TRAIN_CHILD's fits); returns their JSON results.
    A rank that exits non-zero or outlives ``timeout`` (default
    TRAIN_CHILD_TIMEOUT_S; then killed) fails the phase and the run."""
    timeout = timeout or TRAIN_CHILD_TIMEOUT_S
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, SPARKDL_TRACE="0")
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", child or _TRAIN_CHILD, str(r),
                 str(world), str(port), base],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        results = []
        deadline = time.monotonic() + timeout
        for r, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail(f"[{tag}] rank {r} outlived {timeout}s and was killed")
            check(p.returncode == 0, f"[{tag}] rank {r} exited "
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


TRAIN_MESH_SLOTS = 2            # the data groups of (a), (b) and (d)
TRAIN_MESH_FEATURIZE_N = 64     # (a): images featurized on dp2
TRAIN_MESH_LR_ITER = 20         # (a): the head's epochs, one step each
TRAIN_MESH_EPOCHS = 4           # (b): 12 steps at batch 16: captured
TRAIN_MESH_STATS_ROWS = 16      # (b): the trainBatchStats fit: one step
#                                 of 16, 8 rows a slot.  Its statistics'
#                                 move is the first forward's; later steps
#                                 follow a gradient whose float32 sums in
#                                 another order move by far more than
#                                 TUNING_STATS_TOL (a float64 step agrees
#                                 to 1e-12 on the CPU)
TRAIN_MESH_SPLIT_STEPS = 6      # (c): steps of each split-head step
TRAIN_MESH_MAP_EPOCHS = (1, 2)  # (d): the maps' epochs
TRAIN_MESH_MAP_TOL = 1e-4       # (d): each map's losses vs sequential (rel)


class _DefaultSlots:
    """While entered, the default device list that ``mesh.get_mesh()``
    reads (the mesh a fit, the featurizer and fitMultiple take when given
    none) is ``slots``: a host with that many cards, here slots of the
    cards this machine has (instrumentation of this script, no knob of the
    port)."""

    def __init__(self, slots):
        self.slots = [torch.device(d) for d in slots]

    def __enter__(self):
        from sparkdl_tpu_torch.parallel import mesh as mesh_lib

        self._saved = mesh_lib._global_devices
        devs = list(self.slots)
        mesh_lib._global_devices = lambda: (devs, [0] * len(devs))
        return self

    def __exit__(self, *exc):
        from sparkdl_tpu_torch.parallel import mesh as mesh_lib

        mesh_lib._global_devices = self._saved


def _train_model_per_device():
    """Config 5's model as :func:`_train_model` builds it, with a predict
    fn that runs each data group's rows through a copy of the module on
    the group's device (the module itself on one card)."""
    from sparkdl_tpu_torch.graph.function import apply_with

    fn, module, params = _train_model_fn()
    copies = {str(next(module.parameters()).device): module}

    def predict(p, x):
        key = str(x.device)
        if key not in copies:
            copies[key] = copy.deepcopy(module).to(x.device)
        return apply_with(fn, copies[key], p, x)

    return module, params, predict


def _fit_record(m, log, batch):
    """A fit's step mode, img/s over its last epoch, and pool bytes, from
    its Metrics and an _EpochLog."""
    mode = [k.rsplit(".", 1)[1] for k in m.counters
            if k.startswith("train.step_mode.")][0]
    last_s, last_n = log.epochs[-1]
    return dict(mode=mode, img_s=last_n * batch / last_s,
                fit_s=sum(s for s, _ in log.epochs),
                pool_bytes=m.gauges.get("train.graph_pool_bytes", 0),
                captures=m.counters.get("train.captures", 0),
                groups=m.gauges.get("train.data_groups"))


def _train_mesh_head(sepconv, tag, slots, expect):
    """(a): DeepImageFeaturizer(Xception) at 299x299 on the default mesh of
    ``slots`` (dp2), B1 counted; LogisticRegression on its features, on the
    same mesh and on one device."""
    from sparkdl_tpu_torch.estimators import LogisticRegression
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.transformers import named_image as ni
    from sparkdl_tpu_torch.utils.metrics import Metrics

    df = synthetic_frame(TRAIN_MESH_FEATURIZE_N, 299, SEED + 231)
    with _DefaultSlots(slots):
        feat = ni.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                      modelName="Xception", batchSize=BATCH)
        eng = ni._zoo_engine("Xception", True, BATCH)
        feat.transform(df)  # its graphs captured outside the window
        reset_counts(sepconv)
        out = feat.transform(df)
        counts = read_counts(sepconv)
    f = np.asarray(out.table.column("f").to_pylist(), np.float32)
    dp = int(eng.mesh.shape["data"])
    pieces = -(-TRAIN_MESH_FEATURIZE_N // eng.device_batch_size)
    expect(f.shape == (TRAIN_MESH_FEATURIZE_N, 2048)
           and np.isfinite(f).all(), f"[{tag}] (a) features {f.shape}")
    expect(dp == TRAIN_MESH_SLOTS
           and counts == dict(sepconv=SEPCONV_PER_FORWARD * dp * pieces,
                              sepconv_tiled=0, mbconv=0),
           f"[{tag}] (a) mesh {eng.mesh.shape}, launches {counts}, want "
           f"{SEPCONV_PER_FORWARD} a forward in each of {dp} groups over "
           f"{pieces} batches")
    labels = np.arange(TRAIN_MESH_FEATURIZE_N) % 2
    fdf = DataFrame({"features": [list(map(float, r)) for r in f],
                     "label": labels.astype(np.int64)})
    fits, img_s = {}, {}
    for name in ("dp2", "one"):
        m = Metrics()
        real = _fit_metrics(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if name == "dp2":
                with _DefaultSlots(slots):
                    lr = LogisticRegression(maxIter=TRAIN_MESH_LR_ITER).fit(
                        fdf)
            else:
                lr = LogisticRegression(maxIter=TRAIN_MESH_LR_ITER).fit(fdf)
        finally:
            real()
        torch.cuda.synchronize()
        img_s[name] = (TRAIN_MESH_LR_ITER * len(f)
                       / (time.perf_counter() - t0))
        fits[name] = (lr, m)
    # the head's start, folded as its fit folds the fitted (w, b)
    mu, sd = f.mean(axis=0), f.std(axis=0)
    sigma = np.where(sd < 1e-7, 1.0, sd).astype(np.float32)
    w0 = np.random.default_rng(0).normal(0, 0.01, (2048, 2)).astype(
        np.float32)
    init = {"w": torch.from_numpy(w0 / sigma[:, None]),
            "b": torch.from_numpy(-(mu / sigma) @ w0)}
    got = {k: torch.from_numpy(np.asarray(v))
           for k, v in fits["dp2"][0].weights.items()}
    ref = {k: torch.from_numpy(np.asarray(v))
           for k, v in fits["one"][0].weights.items()}
    rel = _update_rel(ref, got, init)
    modes = {k: [c.rsplit(".", 1)[1] for c in m.counters
                 if c.startswith("train.step_mode.")] for k, (_, m) in
             fits.items()}
    groups = {k: m.gauges.get("train.data_groups") for k, (_, m) in
              fits.items()}
    expect(rel <= TUNING_UPDATE_TOL and groups == {"dp2": 2.0, "one": 1.0},
           f"[{tag}] (a) LogisticRegression dp2 vs one device: (w, b) "
           f"update rel err {rel:.4g} (tol {TUNING_UPDATE_TOL}), data "
           f"groups {groups}")
    print(f"[{tag}] (a) DeepImageFeaturizer(Xception) on the default mesh "
          f"{eng.mesh.shape} slots {[str(d) for d in eng.mesh.devices.flat]}:"
          f" {TRAIN_MESH_FEATURIZE_N} images, B1 {counts['sepconv']} "
          f"({SEPCONV_PER_FORWARD} a forward in each of {dp} groups over "
          f"{pieces} batches); LogisticRegression ({TRAIN_MESH_LR_ITER} "
          f"epochs) on that mesh vs one device: (w, b) update rel err "
          f"{rel:.3e} (tol {TUNING_UPDATE_TOL}); step modes {modes}, "
          f"rows/s { {k: round(v, 1) for k, v in img_s.items()} } (fit "
          f"wall, standardization included), pools "
          f"{ {k: m.gauges.get('train.graph_pool_bytes', 0) for k, (_, m) in fits.items()} } B", flush=True)
    return dict(mesh_shape=eng.mesh.shape, launches=counts,
                head_update_rel=rel, modes=modes, groups=groups,
                rows_s=img_s,
                pool_bytes={k: m.gauges.get("train.graph_pool_bytes", 0)
                            for k, (_, m) in fits.items()})


def _fit_metrics(m):
    """While the returned undo is not called, every fit_data_parallel call
    that is given no metrics records into ``m`` (the head's fit builds
    its own call)."""
    from sparkdl_tpu_torch.parallel import train

    real = train.fit_data_parallel

    def recorded(*a, **kw):
        if kw.get("metrics") is None:
            kw["metrics"] = m
        return real(*a, **kw)

    import sparkdl_tpu_torch.estimators.classification as cls
    cls.fit_data_parallel = recorded

    def undo():
        cls.fit_data_parallel = real

    return undo


def _train_mesh_config5(sepconv, tag, slots, x, y, paths, labels, expect):
    """(b): config 5's InceptionV3 fitted with fit_data_parallel at batch 16
    on dp2 vs one device (SGD, cuDNN deterministic); then trainBatchStats
    on the zoo's InceptionV3 through the estimator, dp2 vs one device."""
    from sparkdl_tpu_torch.estimators import ImageFileEstimator
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import load_model
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.parallel.mesh import get_mesh
    from sparkdl_tpu_torch.utils.metrics import Metrics

    module, params, predict = _train_model_per_device()
    init = {k: v.detach().cpu() for k, v in params.items()}
    out = {}
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, mesh in (("dp2", get_mesh(devices=slots)), ("one", None)):
            m = Metrics()
            with _EpochLog() as log:
                fitted, _ = train.fit_data_parallel(
                    predict, params, x, y, optimizer=NamedOptimizer("sgd"),
                    loss="categorical_crossentropy", batch_size=TUNING_BATCH,
                    epochs=TRAIN_MESH_EPOCHS, mesh=mesh, metrics=m)
            runs[name] = (fitted, _fit_record(m, log, TUNING_BATCH),
                          np.asarray(log.losses))
        (df2, r2, l2), (df1, r1, l1) = runs["dp2"], runs["one"]
        loss_rel = float(np.max(np.abs(l2 - l1) / np.abs(l1)))
        upd_rel = _update_rel({k: torch.from_numpy(v) for k, v in df1.items()},
                              {k: torch.from_numpy(v) for k, v in df2.items()},
                              init)
        steps = TRAIN_MESH_EPOCHS * -(-len(x) // TUNING_BATCH)
        # slots of one card: the two groups in one captured graph; across
        # cards the step is eager by up-front choice
        want = "captured" if len(set(slots)) == 1 else "eager"
        expect(len(l2) == steps and loss_rel <= TUNING_LOSS_TOL
               and upd_rel <= TUNING_UPDATE_TOL and r2["groups"] == 2.0
               and r2["mode"] == want and r1["mode"] == "captured",
               f"[{tag}] (b) config 5 dp2 vs one device: {len(l2)} steps, "
               f"loss rel err {loss_rel:.4g} (tol {TUNING_LOSS_TOL}), update "
               f"{upd_rel:.4g} (tol {TUNING_UPDATE_TOL}), groups "
               f"{r2['groups']}, modes {r2['mode']} (want {want}) / "
               f"{r1['mode']}")
        print(f"[{tag}] (b) config 5's InceptionV3 (299x299, f32, SGD, "
              f"batch 16 = 8 rows a slot, {steps} steps, cuDNN "
              f"deterministic) on dp2 slots {slots} vs one device: step "
              f"loss rel err {loss_rel:.3e}, update rel err {upd_rel:.3e}; "
              f"dp2 {r2['img_s']:.1f} img/s ({r2['mode']}, pool "
              f"{r2['pool_bytes']} B) vs one device {r1['img_s']:.1f} img/s "
              f"({r1['mode']}, pool {r1['pool_bytes']} B)", flush=True)
        out["fit"] = dict(dp2=r2, one=r1, step_loss_rel=loss_rel,
                          update_rel=upd_rel, losses=l2.tolist())
        del runs, df1, df2, module, params, predict

        # trainBatchStats: the zoo's InceptionV3 (from_module: BatchNorm
        # running statistics and a train-mode apply), 16 rows, batch 8
        zoo = load_model("InceptionV3", weights=None)
        before = zoo.state_dict()
        stat_keys = [k for k in before
                     if k.endswith(("running_mean", "running_var"))]
        n = TRAIN_MESH_STATS_ROWS
        onehot = np.eye(1000, dtype=np.float32)
        sdf = DataFrame({"uri": paths[:n], "onehot": [
            onehot[v].tolist() for v in labels[:n]]})
        stats, recs = {}, {}
        for name in ("dp2", "one"):
            est = ImageFileEstimator(
                inputCol="uri", outputCol="preds", labelCol="onehot",
                modelFunction=ModelFunction.from_module(copy.deepcopy(zoo)),
                imageLoader=load_inception_v3, optimizer="sgd", batchSize=n,
                trainBatchStats=True,
                fitParams={"epochs": 1, "shuffle": False})
            m = Metrics()
            real = train.fit_data_parallel
            import sparkdl_tpu_torch.estimators.image_file_estimator as ife

            ife.fit_data_parallel = (
                lambda *a, _m=m, **kw: real(*a, **dict(kw, metrics=_m)))
            try:
                with _EpochLog() as log:
                    if name == "dp2":
                        with _DefaultSlots(slots):
                            fm = est.fit(sdf)
                    else:
                        fm = est.fit(sdf)
            finally:
                ife.fit_data_parallel = real
            stats[name] = fm.getModelFunction().module.state_dict()
            recs[name] = _fit_record(m, log, n)
        srel = _update_rel({k: stats["one"][k] for k in stat_keys},
                           {k: stats["dp2"][k] for k in stat_keys}, before)
        moved = any(not torch.equal(stats["dp2"][k], before[k])
                    for k in stat_keys)
        expect(srel <= TUNING_STATS_TOL and moved
               and recs["dp2"]["groups"] == 2.0,
               f"[{tag}] (b) trainBatchStats dp2 vs one device: statistics "
               f"rel err {srel:.4g} (tol {TUNING_STATS_TOL}), moved {moved}, "
               f"groups {recs['dp2']['groups']}")
        print(f"[{tag}] (b) trainBatchStats=True on the zoo's InceptionV3 "
              f"(one step of {n} rows, {n // 2} a slot): dp2 vs one "
              f"device, {len(stat_keys)} running statistics' move rel err "
              f"{srel:.3e} (tol {TUNING_STATS_TOL}); dp2 "
              f"{recs['dp2']['img_s']:.1f} img/s ({recs['dp2']['mode']}, "
              f"pool {recs['dp2']['pool_bytes']} B) vs one device "
              f"{recs['one']['img_s']:.1f} img/s ({recs['one']['mode']}, "
              f"pool {recs['one']['pool_bytes']} B)", flush=True)
        out["batch_stats"] = dict(rel=srel, dp2=recs["dp2"], one=recs["one"])
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _train_mesh_split(tag, x, y, expect, keep=None):
    """(c): make_train_step on config 5's model with the backbone frozen and
    the head, the predictions layer's weight and bias, split over ``model``
    (dp1 x tp2 and dp2 x tp2), SGD and Adam, against the replicated
    one-device step on the same batches.  ``keep`` (a dict) receives each
    step's fitted head, losses and ms by (optimizer, layout), and the
    head's first values under "init", for [train_ranks].  (Adam's update of a whole
    backbone sets each element's step by the sign of its gradient, so a
    backbone gradient that is rounding noise, summed in another order by
    the split, moves the fit by ~1e-2: the head alone is held.)"""
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.parallel.mesh import P, get_mesh
    from sparkdl_tpu_torch.parallel.shard import ShardedTensor

    module, params_all, predict = _train_model_per_device()
    module.requires_grad_(False)
    split = [n for n in sorted(params_all)
             if re.search(r"predictions\.(weight|bias)$", n)]
    params0 = {n: params_all[n] for n in split}
    del params_all
    names = split
    init = {k: v.detach().cpu() for k, v in params0.items()}

    def rule(path, leaf):
        return P("model") if path in split else P()

    layouts = (("replicated", None), ("dp1xtp2", (1, 2)),
               ("dp2xtp2", (2, 2)))
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for opt_name in ("sgd", "adam"):
            res = {}
            for name, shape in layouts:
                params = {k: v.detach().clone().requires_grad_()
                          for k, v in params0.items()}
                opt = NamedOptimizer(opt_name)([params[k] for k in names])
                mesh = (None if shape is None else get_mesh(
                    devices=_mesh_slots(shape[0] * shape[1],
                                        torch.cuda.device_count() > 1),
                    model_parallel=shape[1]))
                step = train.make_train_step(
                    predict, "categorical_crossentropy", opt, params,
                    mesh=mesh, param_specs=None if shape is None else rule)
                losses = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(TRAIN_MESH_SPLIT_STEPS):
                    if i == 1:
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                    off = (i * TUNING_BATCH) % len(x)
                    losses.append(step(
                        torch.from_numpy(x[off:off + TUNING_BATCH]).cuda(),
                        torch.from_numpy(y[off:off + TUNING_BATCH]).cuda()))
                losses = torch.stack(losses).cpu().numpy()
                torch.cuda.synchronize()
                end = time.perf_counter()
                ms = (end - t0) / TRAIN_MESH_SPLIT_STEPS * 1e3
                warm_ms = (end - t1) / (TRAIN_MESH_SPLIT_STEPS - 1) * 1e3
                per_shard = None
                if shape is not None:
                    w = step.tree[split[-1]]
                    half = (w.shape[0] // 2,) + tuple(w.shape[1:])
                    per_shard = (isinstance(w, ShardedTensor) and all(
                        tuple(s.shape) == half for s in w.shards))
                    if opt_name == "adam":
                        sh = step.opt_state_shardings()
                        leaf = names.index(split[-1])
                        per_shard = per_shard and all(
                            tuple(opt.state[s]["mu"].shape) == tuple(s.shape)
                            for s in w.shards) and \
                            tuple(sh[leaf]["mu"].spec) == ("model",) \
                            and sh[leaf]["step"] is step.replicated
                res[name] = dict(fitted={k: torch.from_numpy(v) for k, v in
                                         step.host_params().items()},
                                 losses=losses, ms=ms, warm_ms=warm_ms,
                                 per_shard=per_shard)
                if keep is not None:
                    keep[(opt_name, name)] = res[name]
                del step, opt, params
            ref = res["replicated"]
            for name, shape in layouts[1:]:
                r = res[name]
                loss_rel = float(np.max(np.abs(r["losses"] - ref["losses"])
                                        / np.abs(ref["losses"])))
                upd_rel = _update_rel(ref["fitted"], r["fitted"], init)
                expect(loss_rel <= TUNING_UPDATE_TOL
                       and upd_rel <= TUNING_UPDATE_TOL and r["per_shard"],
                       f"[{tag}] (c) {opt_name} {name}: loss rel err "
                       f"{loss_rel:.4g}, update {upd_rel:.4g} (tol "
                       f"{TUNING_UPDATE_TOL}), per-shard leaves and state "
                       f"{r['per_shard']}")
                print(f"[{tag}] (c) {opt_name}, the head {split} split "
                      f"over model (backbone frozen) on "
                      f"{name} vs the replicated step, "
                      f"{TRAIN_MESH_SPLIT_STEPS} steps at batch "
                      f"{TUNING_BATCH}: loss rel err {loss_rel:.3e}, update "
                      f"rel err {upd_rel:.3e}; shards of half the rows, each "
                      f"with their own gradient"
                      f"{' and Adam moments' if opt_name == 'adam' else ''}: "
                      f"{r['per_shard']}; {r['ms']:.1f} ms a step, "
                      f"{TUNING_BATCH / r['ms'] * 1e3:.1f} img/s (eager: "
                      f"make_train_step's steps called one by one, no pool) "
                      f"vs {ref['ms']:.1f} ms replicated", flush=True)
                out[f"{opt_name}_{name}"] = dict(
                    step_loss_rel=loss_rel, update_rel=upd_rel, ms=r["ms"],
                    warm_ms=r["warm_ms"], replicated_ms=ref["ms"],
                    per_shard=r["per_shard"])
            del res
    finally:
        torch.backends.cudnn.deterministic = False
    if keep is not None:
        keep["init"] = init
    return out


def _train_mesh_maps(tag, slots, tmp, expect):
    """(d): fitMultiple(parallelism=2) over two slots (two slices of one)
    against the sequential fits on the whole dp2 mesh, [tuning]'s small
    CNN on its 48 JPEGs."""
    import threading

    from sparkdl_tpu_torch.estimators import KerasImageFileEstimator
    from sparkdl_tpu_torch.estimators import image_file_estimator as ife
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.keras_convert import KerasModel
    from sparkdl_tpu_torch.models import keras_import

    cfile = keras_import.keras_file(
        _cnn_config(), _seeded_cnn_arrays(KerasModel(_cnn_config()),
                                          SEED + 59))
    paths, labels = _tuning_files(os.path.join(tmp, "map_images"),
                                  TUNING_CNN_BASES, 60.0, SEED + 61)
    onehot = np.eye(2, dtype=np.float32)
    df = DataFrame({"uri": paths,
                    "onehot": [onehot[k].tolist() for k in labels]})
    from sparkdl_tpu_torch.utils.metrics import Metrics

    seen, real = [], ife.fit_data_parallel

    def logged(*a, **kw):
        m = Metrics()
        t0 = time.perf_counter()
        out = real(*a, **dict(kw, metrics=m))
        torch.cuda.synchronize()
        rows = len(a[2]) * kw["epochs"]
        seen.append((kw["mesh"].size, threading.current_thread().name,
                     [k.rsplit(".", 1)[1] for k in m.counters
                      if k.startswith("train.step_mode.")][0],
                     rows / (time.perf_counter() - t0),
                     m.gauges.get("train.graph_pool_bytes", 0)))
        return out

    out = {}
    ife.fit_data_parallel = logged
    try:
        with _DefaultSlots(slots):
            for par in (1, 2):
                est = KerasImageFileEstimator(
                    inputCol="uri", outputCol="preds", labelCol="onehot",
                    modelFile=cfile, imageLoader=load_small,
                    kerasOptimizer="sgd",
                    kerasLoss="categorical_crossentropy",
                    batchSize=TUNING_BATCH,
                    kerasFitParams={"epochs": 1, "shuffle": False})
                est._set(parallelism=par)
                maps = [{est.fitParams: {"epochs": e, "shuffle": False}}
                        for e in TRAIN_MESH_MAP_EPOCHS]
                seen.clear()
                t0 = time.perf_counter()
                models = est.fit(df, maps)
                torch.cuda.synchronize()
                out[par] = dict(losses=[m.trainLosses for m in models],
                                meshes=sorted(r[0] for r in seen),
                                threads=len({r[1] for r in seen}),
                                fits=[dict(mode=r[2], img_s=r[3],
                                           pool_bytes=r[4]) for r in seen],
                                wall_s=time.perf_counter() - t0)
    finally:
        ife.fit_data_parallel = real
    rel = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                           / np.abs(np.asarray(b))))
              for a, b in zip(out[2]["losses"], out[1]["losses"]))
    expect(out[2]["meshes"] == [1, 1] and out[1]["meshes"] == [2, 2]
           and out[2]["threads"] == 2 and rel <= TRAIN_MESH_MAP_TOL,
           f"[{tag}] (d) fitMultiple parallelism=2: meshes {out[2]['meshes']}"
           f" in {out[2]['threads']} threads (sequential "
           f"{out[1]['meshes']}), trainLosses rel err {rel:.4g} (tol "
           f"{TRAIN_MESH_MAP_TOL})")
    print(f"[{tag}] (d) fitMultiple(parallelism=2) over slots {slots}: "
          f"{len(TRAIN_MESH_MAP_EPOCHS)} maps on slices of "
          f"{out[2]['meshes']} slot(s) in {out[2]['threads']} threads "
          f"({out[2]['wall_s']:.2f}s) vs sequential fits on the dp2 mesh "
          f"({out[1]['wall_s']:.2f}s): trainLosses rel err {rel:.3e} (tol "
          f"{TRAIN_MESH_MAP_TOL}); each fit's (mode, img/s, pool B): "
          f"parallel {[(f['mode'], round(f['img_s'], 1), f['pool_bytes']) for f in out[2]['fits']]}, "
          f"sequential {[(f['mode'], round(f['img_s'], 1), f['pool_bytes']) for f in out[1]['fits']]}",
          flush=True)
    return dict(parallel=out[2], sequential=out[1], loss_rel=rel)


def phase_train_mesh(sepconv, keep=None):
    """[train_mesh]: training on a mesh of several slots in one process,
    on slots of cuda:0 (or distinct cards where several are visible), f32
    with TF32 off.

      (a) ``DeepImageFeaturizer("Xception")`` at 299x299 on a dp2 default
          mesh featurizes TRAIN_MESH_FEATURIZE_N images, B1 30 a forward in
          each data group (counted); ``LogisticRegression`` fits on the same
          mesh, its (w, b) within TUNING_UPDATE_TOL of the one-device fit;
      (b) config 5's InceptionV3 fitted with ``fit_data_parallel`` at batch
          16 on dp2 (8 rows a slot): losses within TUNING_LOSS_TOL and the
          update within TUNING_UPDATE_TOL of the one-device fit; then
          ``trainBatchStats=True`` (the zoo's InceptionV3, which has
          running statistics) moves them within TUNING_STATS_TOL of the
          one-device fit's; each fit's step mode, img/s and pool bytes;
      (c) ``make_train_step`` on config 5's model, its backbone frozen
          and its head (the ``predictions`` weight and bias) split over
          ``model`` on dp1 x tp2 and dp2 x tp2, SGD and Adam over
          TRAIN_MESH_SPLIT_STEPS steps: losses and fitted tensors within
          TUNING_UPDATE_TOL of the replicated step, each shard its own leaf
          with its own Adam moments;
      (d) ``fitMultiple`` with ``parallelism=2`` over two slots: each map's
          trainLosses within TRAIN_MESH_MAP_TOL of the sequential fits;
      (e) no fit's graph pool outlives it.
    B1-B3 launch 0 times in (b)-(d).  ``keep`` receives (c)'s one-process
    results (:func:`_train_mesh_split`)."""
    import tempfile

    from sparkdl_tpu_torch.parallel.engine import graph_pool_bytes_held

    tag = "train_mesh"
    out = {}
    problems = []

    def expect(cond, msg):
        if not cond:
            print(f"FAIL (at the phase's end): {msg}", flush=True)
            problems.append(msg)

    t_phase = time.perf_counter()
    slots = _mesh_slots(TRAIN_MESH_SLOTS, torch.cuda.device_count() > 1)
    t0 = time.perf_counter()
    out["head"] = _train_mesh_head(sepconv, tag, slots, expect)
    out["head_s"] = time.perf_counter() - t0
    # after (a): its dp2 featurizer's graphs stay cached with the zoo's
    # engines, and (b)-(d) are held to leave no pool of their own
    gc.collect()
    torch.cuda.empty_cache()
    held0 = graph_pool_bytes_held()
    private0 = _private_pool_bytes()
    reset_counts(sepconv)
    with tempfile.TemporaryDirectory() as tmp:
        paths, labels = _tuning_files(os.path.join(tmp, "images"))
        x = np.stack([load_inception_v3(p) for p in paths])
        y = np.eye(1000, dtype=np.float32)[labels]
        t0 = time.perf_counter()
        out["config5"] = _train_mesh_config5(sepconv, tag, slots, x, y,
                                             paths, labels, expect)
        out["config5_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["split"] = _train_mesh_split(tag, x, y, expect, keep)
        out["split_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["maps"] = _train_mesh_maps(tag, slots, tmp, expect)
        out["maps_s"] = time.perf_counter() - t0
    counts = read_counts(sepconv)
    expect(counts == dict(sepconv=0, sepconv_tiled=0, mbconv=0),
           f"[{tag}] (b)-(d) launches {counts}, want none of B1-B3")
    gc.collect()
    torch.cuda.empty_cache()
    held1 = graph_pool_bytes_held()
    private1 = _private_pool_bytes()
    expect(held1 <= held0 and private1 <= private0,
           f"[{tag}] (e) graph pools held {held1} after the fits, {held0} "
           f"before; private-pool segments {private1} after, {private0} "
           f"before: a fit's pool outlived it")
    print(f"[{tag}] (e) over (b)-(d): pools held by live engines "
          f"{held0 / 2**20:.1f} -> {held1 / 2**20:.1f} MiB, private-pool "
          f"(CUDA graph) segments {private0 / 2**20:.1f} -> "
          f"{private1 / 2**20:.1f} MiB; card memory reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
    out["pools"] = dict(held_before=held0, held_after=held1,
                        private_before=private0, private_after=private1)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{tag}] phase {out['phase_s']:.1f}s ((a) {out['head_s']:.1f}s, "
          f"(b) {out['config5_s']:.1f}s, (c) {out['split_s']:.1f}s, (d) "
          f"{out['maps_s']:.1f}s)", flush=True)
    check(not problems, f"[{tag}] {len(problems)} failed: "
                        + " | ".join(problems))
    out["launches"] = out["head"]["launches"]
    return out


TRAIN_RANKS_SLOTS = 2           # each rank's slots: two data groups (b, c),
#                                 or the model axis of (a)


_TRAIN_RANKS_CHILD = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as c
rank, world, port, base = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
print(json.dumps(c._train_ranks_child(rank, world, port, base)))
"""


def _rank_slots(rank):
    """Rank ``rank``'s TRAIN_RANKS_SLOTS slots: cards of its own where the
    machine has enough, else slots of cuda:0."""
    n = TRAIN_RANKS_SLOTS
    count = torch.cuda.device_count()
    if count >= 2 * n:
        return [f"cuda:{rank * n + i}" for i in range(n)]
    return [MESH_DEVICE] * n


class _Collectives:
    """While entered, tallies every ``torch.distributed.all_reduce`` of
    this process (the fits' flat buffers and the BatchNorms' sums, forward
    and backward) by calls, bytes and host seconds inside the call (gloo's
    all-reduce of a CUDA tensor returns once it is done: its copies to
    and from the host included); ``scalar_calls`` / ``scalar_seconds``
    count the one-element ones (a loss of another type than the
    gradients, reduced beside their buffer) (instrumentation of this
    script)."""

    def __enter__(self):
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0
        self.scalar_calls = 0
        self.scalar_seconds = 0.0
        self._saved = torch.distributed.all_reduce
        real = self._saved

        def counted(tensor, *a, **k):
            self.calls += 1
            self.bytes += tensor.numel() * tensor.element_size()
            t0 = time.perf_counter()
            try:
                return real(tensor, *a, **k)
            finally:
                dt = time.perf_counter() - t0
                self.seconds += dt
                if tensor.numel() == 1:
                    self.scalar_calls += 1
                    self.scalar_seconds += dt

        torch.distributed.all_reduce = counted
        return self

    def __exit__(self, *exc):
        torch.distributed.all_reduce = self._saved


def _ranks_split(rank, world, x, y, base):
    """(a) in a rank: config 5's head split over this rank's two slots,
    the batch over the ranks (dp2 x tp2), SGD and Adam for
    TRAIN_MESH_SPLIT_STEPS steps of TUNING_BATCH rows, this rank's half of
    each; the fitted head saved for the parent."""
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import mesh as mesh_lib
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.parallel.shard import ShardedTensor

    module, params_all, predict = _train_model_per_device()
    module.requires_grad_(False)
    split = [n for n in sorted(params_all)
             if re.search(r"predictions\.(weight|bias)$", n)]
    params0 = {n: params_all[n] for n in split}
    del params_all

    def rule(path, leaf):
        return mesh_lib.P("model") if path in split else mesh_lib.P()

    mesh = mesh_lib.get_mesh(model_parallel=TRAIN_RANKS_SLOTS)
    local = mesh_lib.local_rows(mesh)
    rows = TUNING_BATCH // world
    out = dict(mesh=mesh.shape, local=local.shape,
               slots=[str(d) for d in local.devices.flat])
    torch.backends.cudnn.deterministic = True
    try:
        for opt_name in ("sgd", "adam"):
            params = {k: v.detach().clone().requires_grad_()
                      for k, v in params0.items()}
            opt = NamedOptimizer(opt_name)([params[k] for k in split])
            step = train.make_train_step(
                predict, "categorical_crossentropy", opt, params, mesh=mesh,
                param_specs=rule)
            losses = []
            with _Collectives() as coll:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(TRAIN_MESH_SPLIT_STEPS):
                    if i == 1:
                        torch.cuda.synchronize()
                        t1, first_s = time.perf_counter(), coll.seconds
                    off = (i * TUNING_BATCH) % len(x) + rank * rows
                    losses.append(step(
                        torch.from_numpy(x[off:off + rows]).cuda(),
                        torch.from_numpy(y[off:off + rows]).cuda()))
                losses = torch.stack(losses).cpu().numpy()
                torch.cuda.synchronize()
                end = time.perf_counter()
            ms = (end - t0) / TRAIN_MESH_SPLIT_STEPS * 1e3
            warm = TRAIN_MESH_SPLIT_STEPS - 1
            warm_ms = (end - t1) / warm * 1e3
            reduce_ms = (coll.seconds - first_s) / warm * 1e3
            w = step.tree[split[-1]]
            half = (w.shape[0] // TRAIN_RANKS_SLOTS,) + tuple(w.shape[1:])
            per_shard = (isinstance(w, ShardedTensor)
                         and [str(s.device) for s in w.shards] == out["slots"]
                         and all(tuple(s.shape) == half for s in w.shards))
            if opt_name == "adam":
                per_shard = per_shard and all(
                    tuple(opt.state[s]["mu"].shape) == half for s in w.shards)
            np.savez(os.path.join(base, f"split_{opt_name}_{rank}.npz"),
                     **step.host_params())
            out[opt_name] = dict(losses=losses.tolist(), ms=ms,
                                 warm_ms=warm_ms, reduce_ms=reduce_ms,
                                 per_shard=bool(per_shard),
                                 reduce_calls=coll.calls,
                                 reduce_bytes=coll.bytes)
            del step, opt, params
    finally:
        torch.backends.cudnn.deterministic = False
    del module, predict
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ranks_head(sepconv, rank, world, base, modes):
    """(b) in a rank: DeepImageFeaturizer(Xception) at 299x299 over this
    rank's TRAIN_MESH_FEATURIZE_N / world images (B1 counted in a window
    of its own), then LogisticRegression on the group's default mesh of
    every rank's slots, and the same head through fit_data_parallel with
    SGD; features and each (w, b) saved for the parent."""
    from sparkdl_tpu_torch.estimators import LogisticRegression
    from sparkdl_tpu_torch.estimators.classification import _predict
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.transformers import named_image as ni
    from sparkdl_tpu_torch.utils.metrics import Metrics

    n = TRAIN_MESH_FEATURIZE_N // world
    df = synthetic_frame(n, 299, SEED + 241 + rank)
    feat = ni.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                  modelName="Xception", batchSize=BATCH)
    eng = ni._zoo_engine("Xception", True, BATCH)
    feat.transform(df)  # its graphs captured outside the window
    reset_counts(sepconv)
    featurized = feat.transform(df)
    counts = read_counts(sepconv)
    f = np.asarray(featurized.table.column("f").to_pylist(), np.float32)
    labels = (np.arange(n) + rank * n) % 2
    np.savez(os.path.join(base, f"feat_{rank}.npz"), f=f, labels=labels)
    m = Metrics()
    undo = _fit_metrics(m)
    first = len(modes)
    try:
        with _Collectives() as coll:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est = LogisticRegression(maxIter=TRAIN_MESH_LR_ITER,
                                     standardization=False)
            lr = est.fit(DataFrame({
                "features": [list(map(float, r)) for r in f],
                "label": labels.astype(np.int64)}))
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
    finally:
        undo()
    np.savez(os.path.join(base, f"lr_{rank}.npz"),
             **{k: np.asarray(v) for k, v in lr.weights.items()})
    # the same head, fit_data_parallel with SGD (a capturable optimizer):
    # on the card its steps are captured in mode split, both of the
    # rank's groups inside the graph, the all-reduce between two graphs
    sgd_m = Metrics()
    first_sgd = len(modes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, _ = train.fit_data_parallel(
        _predict, _head_init(f.shape[1], 2), f, labels,
        optimizer=NamedOptimizer("sgd"), loss=train.softmax_cross_entropy,
        batch_size=est.getOrDefault(est.batchSize),
        epochs=TRAIN_MESH_LR_ITER, seed=est.getOrDefault(est.seed),
        metrics=sgd_m)
    torch.cuda.synchronize()
    sgd_s = time.perf_counter() - t0
    np.savez(os.path.join(base, f"sgd_{rank}.npz"), **fitted)
    return dict(engine=str(eng.device), engine_mesh=eng.mesh.shape,
                pieces=-(-n // eng.device_batch_size), launches=counts,
                features=list(f.shape), finite=bool(np.isfinite(f).all()),
                modes=modes[first:first_sgd],
                groups=m.gauges.get("train.data_groups"),
                steps=m.counters.get("train.steps"), fit_s=fit_s,
                reduce_calls=coll.calls, reduce_bytes=coll.bytes,
                sgd=dict(modes=modes[first_sgd:], fit_s=sgd_s,
                         steps=sgd_m.counters.get("train.steps"),
                         captures=sgd_m.counters.get("train.captures", 0),
                         groups=sgd_m.gauges.get("train.data_groups")))


def _ranks_stats(rank, world, base, modes):
    """(c) in a rank: trainBatchStats on the zoo's InceptionV3 through
    ImageFileEstimator, this rank's TRAIN_MESH_STATS_ROWS / world images
    of one global step, two data groups a rank; its running statistics
    saved for the parent."""
    from sparkdl_tpu_torch.estimators import ImageFileEstimator
    from sparkdl_tpu_torch.estimators import image_file_estimator as ife
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import load_model
    from sparkdl_tpu_torch.utils.metrics import Metrics

    with open(os.path.join(base, "files.json")) as fh:
        files = json.load(fh)
    n = TRAIN_MESH_STATS_ROWS // world
    mine = slice(rank * n, (rank + 1) * n)
    onehot = np.eye(1000, dtype=np.float32)
    sdf = DataFrame({"uri": files["paths"][mine], "onehot": [
        onehot[v].tolist() for v in files["labels"][mine]]})
    est = ImageFileEstimator(
        inputCol="uri", outputCol="preds", labelCol="onehot",
        modelFunction=ModelFunction.from_module(
            load_model("InceptionV3", weights=None)),
        imageLoader=load_inception_v3, optimizer="sgd",
        batchSize=TRAIN_MESH_STATS_ROWS, trainBatchStats=True,
        fitParams={"epochs": 1, "shuffle": False})
    m = Metrics()
    real = ife.fit_data_parallel
    ife.fit_data_parallel = (
        lambda *a, **kw: real(*a, **dict(kw, metrics=m)))
    first = len(modes)
    torch.backends.cudnn.deterministic = True
    try:
        with _Collectives() as coll:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fm = est.fit(sdf)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
    finally:
        ife.fit_data_parallel = real
        torch.backends.cudnn.deterministic = False
    sd = fm.getModelFunction().module.state_dict()
    np.savez(os.path.join(base, f"stats_{rank}.npz"),
             **{k: v.numpy() for k, v in sd.items()
                if k.endswith(("running_mean", "running_var"))})
    return dict(modes=modes[first:], groups=m.gauges.get("train.data_groups"),
                steps=m.counters.get("train.steps"), fit_s=fit_s,
                reduce_calls=coll.calls, reduce_bytes=coll.bytes,
                loss_calls=coll.scalar_calls,
                loss_ms=coll.scalar_seconds * 1e3)


def _train_ranks_child(rank, world, port, base):
    """One rank of [train_ranks]: joins the gloo group holding
    TRAIN_RANKS_SLOTS slots (:func:`_rank_slots`), runs (a)-(c) and
    returns what the parent checks; each fit's (mode, reason) is what the
    train module's own ``step_mode`` chose."""
    from sparkdl_tpu_torch.ops import sepconv
    from sparkdl_tpu_torch.parallel import distributed, train

    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo",
                           local_slots=_rank_slots(rank))
    modes = []
    chosen = train.step_mode

    def logged(*a, **k):
        mode = chosen(*a, **k)
        modes.append(list(mode))
        return mode

    train.step_mode = logged
    data = np.load(os.path.join(base, "data.npz"))
    out = dict(rank=rank, backend=distributed.backend(),
               slots=[[str(d) for d in row]
                      for row in distributed.global_slots()],
               modules=sorted(m for m in ("jax", "sparkdl_tpu")
                              if m in sys.modules))
    t0 = time.perf_counter()
    out["split"] = _ranks_split(rank, world, data["x"], data["y"], base)
    out["split_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["head"] = _ranks_head(sepconv, rank, world, base, modes)
    out["head_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["stats"] = _ranks_stats(rank, world, base, modes)
    out["stats_s"] = time.perf_counter() - t0
    distributed.shutdown()
    return out


def _head_init(features, classes):
    """LogisticRegression's first (w, b) (its default seed): the start of
    (b)'s fits and of their one-process references."""
    rng = np.random.default_rng(0)
    return {"w": rng.normal(0, 0.01, (features, classes)).astype(np.float32),
            "b": np.zeros((classes,), np.float32)}


def _head_one_process(parts, slots, make_opt):
    """(b)'s reference: the head's fit as LogisticRegression runs it
    (standardization off, its batch, seed and epochs) with the optimizer
    ``make_opt`` makes, in one process on ``slots`` (dp = len(slots)),
    stepped by make_train_step over the global batches the ranks drew
    from their ``parts`` (each rank's (features, labels)): ((w, b), ms a
    step, steps an epoch)."""
    from sparkdl_tpu_torch.estimators import LogisticRegression
    from sparkdl_tpu_torch.estimators.classification import _predict
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.parallel.mesh import get_mesh

    est = LogisticRegression(maxIter=TRAIN_MESH_LR_ITER)
    seed = est.getOrDefault(est.seed)
    world, dp = len(parts), len(slots)
    batch = est.getOrDefault(est.batchSize)
    batch += -batch % dp
    local = max(dp // world, batch // world)
    rows = sum(len(f) for f, _ in parts)
    steps = max(1, -(-rows // (local * world)))
    classes = int(max(int(l.max()) for _, l in parts)) + 1
    params = {k: torch.from_numpy(v).cuda().requires_grad_() for k, v in
              _head_init(parts[0][0].shape[1], classes).items()}
    step = train.make_train_step(
        _predict, train.softmax_cross_entropy,
        make_opt([params["w"], params["b"]]), params,
        mesh=get_mesh(devices=slots))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(TRAIN_MESH_LR_ITER):
        gx, gy = _global_batches([list(train._epoch_batches(
            f, l, local, epoch, True, seed, num_steps=steps))
            for f, l in parts])
        for i in range(steps):
            sl = slice(i * local * world, (i + 1) * local * world)
            step(torch.from_numpy(gx[sl]).cuda(),
                 torch.from_numpy(gy[sl]).cuda())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (TRAIN_MESH_LR_ITER * steps) * 1e3
    return step.host_params(), ms, steps


def phase_train_ranks(sepconv, split_refs=None):
    """[train_ranks]: a process group whose ranks each hold several slots.
    Two ranks over gloo (``python -c _TRAIN_RANKS_CHILD`` children), each
    with TRAIN_RANKS_SLOTS slots of cuda:0 (or cards of its own where the
    machine has them), f32 with TF32 off:

      (a) config 5's model, its backbone frozen, its head (the
          ``predictions`` weight and bias) split over ``model`` within
          each rank on dp2 (the ranks) x tp2 (each rank's slots), SGD and
          Adam for TRAIN_MESH_SPLIT_STEPS steps at batch 16: the ranks'
          losses and heads within TUNING_UPDATE_TOL of [train_mesh] (c)'s
          one-process dp2 x tp2 and replicated steps on the same global
          batches (``split_refs``; computed here when not given);
      (b) DeepImageFeaturizer(Xception) at 299x299 in each rank over its
          half of TRAIN_MESH_FEATURIZE_N images, B1 30 a forward counted
          in each rank; LogisticRegression (standardization off: it
          standardizes with each rank's own statistics, as JAX's does) on
          dp4 = 2 ranks x 2 groups, and the same head through
          fit_data_parallel with SGD (captured in mode split), each (w, b)
          within TUNING_UPDATE_TOL of the one-process dp4 fit on the same
          global batches;
      (c) trainBatchStats on the zoo's InceptionV3 over one step of
          TRAIN_MESH_STATS_ROWS images on dp4 (the sums met in each rank,
          then across the ranks): the ranks' running statistics equal,
          within TUNING_STATS_TOL of one process's dp4 fit.
    Each rank's mesh and slots, step modes and reasons, ms a step, the
    all-reduce's bytes a step and B1's launches are printed; B1-B3 launch
    0 times in this process."""
    import tempfile

    from sparkdl_tpu_torch.estimators import (ImageFileEstimator,
                                              LogisticRegression)
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import load_model
    from sparkdl_tpu_torch.param.converters import NamedOptimizer

    tag = "train_ranks"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(card=card)
    problems = []

    def expect(cond, msg):
        if not cond:
            print(f"FAIL (at the phase's end): {msg}", flush=True)
            problems.append(msg)

    t_phase = time.perf_counter()
    reset_counts(sepconv)
    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        paths, labels = _tuning_files(os.path.join(tmp, "images"))
        x = np.stack([load_inception_v3(p) for p in paths])
        y = np.eye(1000, dtype=np.float32)[labels]
        if not split_refs:
            split_refs = {}
            _train_mesh_split(tag, x, y, expect, split_refs)
        base = os.path.join(tmp, "ranks")
        os.makedirs(base)
        np.savez(os.path.join(base, "data.npz"), x=x, y=y)
        with open(os.path.join(base, "files.json"), "w") as fh:
            json.dump({"paths": paths, "labels": [int(v) for v in labels]},
                      fh)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _train_ranks(base, world, _TRAIN_RANKS_CHILD, tag)
        out["ranks_s"] = time.perf_counter() - t0
        for r in ranks:
            print(f"[{tag}] rank {r['rank']} over {r['backend']}: global "
                  f"slots {r['slots']}; (a) mesh {r['split']['mesh']}, its "
                  f"rows {r['split']['local']} on {r['split']['slots']}; "
                  f"(b) featurizer on {r['head']['engine']} (mesh "
                  f"{r['head']['engine_mesh']}); rank wall (a) "
                  f"{r['split_s']:.1f}s (b) {r['head_s']:.1f}s (c) "
                  f"{r['stats_s']:.1f}s", flush=True)
        seen = [(r["backend"], r["modules"], len(r["slots"][r["rank"]]))
                for r in ranks]
        expect(all(s == ("gloo", [], TRAIN_RANKS_SLOTS) for s in seen),
               f"[{tag}] ranks (backend, modules, slots): {seen}")

        # (a) the split head against [train_mesh] (c)'s one process
        init = split_refs["init"]
        split_out = {}
        for opt_name in ("sgd", "adam"):
            fits = [{k: torch.from_numpy(v) for k, v in np.load(os.path.join(
                base, f"split_{opt_name}_{r}.npz")).items()}
                for r in range(world)]
            agree = _update_rel(fits[0], fits[1],
                                {k: torch.zeros(()) for k in fits[0]})
            recs = [r["split"][opt_name] for r in ranks]
            losses = np.asarray(recs[0]["losses"])
            row = dict(rank_rel=agree, ms=[r["ms"] for r in recs],
                       warm_ms=[r["warm_ms"] for r in recs],
                       reduce_ms=[r["reduce_ms"] for r in recs],
                       reduce_bytes_per_step=(recs[0]["reduce_bytes"]
                                              / TRAIN_MESH_SPLIT_STEPS),
                       reduce_calls=recs[0]["reduce_calls"])
            for ref_name in ("dp2xtp2", "replicated"):
                ref = split_refs[(opt_name, ref_name)]
                loss_rel = float(np.max(np.abs(losses - ref["losses"])
                                        / np.abs(ref["losses"])))
                upd_rel = _update_rel(ref["fitted"], fits[0], init)
                row[ref_name] = dict(loss_rel=loss_rel, update_rel=upd_rel,
                                     ms=ref["ms"], warm_ms=ref["warm_ms"])
                expect(loss_rel <= TUNING_UPDATE_TOL
                       and upd_rel <= TUNING_UPDATE_TOL,
                       f"[{tag}] (a) {opt_name} two ranks vs one process's "
                       f"{ref_name}: loss rel err {loss_rel:.4g}, update "
                       f"{upd_rel:.4g} (tol {TUNING_UPDATE_TOL})")
            # the flat buffer: the head's gradients and the loss, float32
            flat = 4 * (sum(v.numel() for v in fits[0].values()) + 1)
            expect(agree <= RANK_AGREE_TOL
                   and all(r["per_shard"] for r in recs)
                   and all(r["reduce_calls"] == TRAIN_MESH_SPLIT_STEPS
                           and r["reduce_bytes"]
                           == flat * TRAIN_MESH_SPLIT_STEPS for r in recs),
                   f"[{tag}] (a) {opt_name}: ranks' heads rel {agree:.3g} "
                   f"(tol {RANK_AGREE_TOL}), shards on the rank's slots "
                   f"{[r['per_shard'] for r in recs]}, all-reduces "
                   f"{[(r['reduce_calls'], r['reduce_bytes']) for r in recs]}"
                   f" (want {TRAIN_MESH_SPLIT_STEPS} of {flat} B)")
            one = row["dp2xtp2"]["warm_ms"]
            print(f"[{tag}] (a) {opt_name}: config 5's head split over each "
                  f"rank's {TRAIN_RANKS_SLOTS} slots on dp2 (ranks) x tp2, "
                  f"{TRAIN_MESH_SPLIT_STEPS} steps of {TUNING_BATCH} "
                  f"({TUNING_BATCH // world} a rank): vs one process's "
                  f"dp2 x tp2 loss rel err {row['dp2xtp2']['loss_rel']:.3e}"
                  f", update {row['dp2xtp2']['update_rel']:.3e}; vs its "
                  f"replicated step {row['replicated']['loss_rel']:.3e} / "
                  f"{row['replicated']['update_rel']:.3e}; ranks' heads "
                  f"rel {agree:.2e}; ms a step after the first "
                  f"{row['warm_ms'][0]:.1f} / {row['warm_ms'][1]:.1f} "
                  f"({TUNING_BATCH / max(row['warm_ms']) * 1e3:.1f} img/s; "
                  f"with the first {row['ms'][0]:.1f} / {row['ms'][1]:.1f})"
                  f" vs one process dp2 x tp2 {one:.1f} ms "
                  f"({TUNING_BATCH / one * 1e3:.1f} img/s; with the first "
                  f"{row['dp2xtp2']['ms']:.1f}), eager step calls; gloo "
                  f"all-reduce {row['reduce_bytes_per_step']:.0f} B a step, "
                  f"{row['reduce_ms'][0]:.1f} / {row['reduce_ms'][1]:.1f} "
                  f"ms of it on the host ({card})", flush=True)
            split_out[opt_name] = row
        out["split"] = split_out

        # (b) the featurizer's launches and the head on dp4
        heads = [r["head"] for r in ranks]
        for h in heads:
            want = SEPCONV_PER_FORWARD * h["pieces"]
            expect(h["launches"] == dict(sepconv=want, sepconv_tiled=0,
                                         mbconv=0)
                   and h["finite"] and h["features"] == [
                       TRAIN_MESH_FEATURIZE_N // world, 2048],
                   f"[{tag}] (b) featurizer: launches {h['launches']}, want "
                   f"B1 {want}; features {h['features']}, finite "
                   f"{h['finite']}")
        feats = [np.load(os.path.join(base, f"feat_{r}.npz"))
                 for r in range(world)]
        parts = [(f["f"], f["labels"].astype(np.int64)) for f in feats]
        slots4 = [MESH_DEVICE] * (world * TRAIN_RANKS_SLOTS)
        est = LogisticRegression()

        def adam(ps):
            return torch.optim.Adam(
                ps, lr=est.getOrDefault(est.learningRate),
                weight_decay=est.getOrDefault(est.regParam))

        init = {k: torch.from_numpy(v)
                for k, v in _head_init(2048, 2).items()}
        zero = {k: torch.zeros(()) for k in init}
        head_fits = {}
        for name, make_opt in (("lr", adam), ("sgd", NamedOptimizer("sgd"))):
            ref, ref_ms, head_steps = _head_one_process(parts, slots4,
                                                        make_opt)
            got = [{k: torch.from_numpy(v) for k, v in np.load(os.path.join(
                base, f"{name}_{r}.npz")).items()} for r in range(world)]
            ref = {k: torch.from_numpy(v) for k, v in ref.items()}
            head_fits[name] = dict(
                update_rel=_update_rel(ref, got[0], init),
                rank_rel=_update_rel(got[0], got[1], zero),
                one_process_ms=ref_ms)
        lr_rel, lr_agree = (head_fits["lr"]["update_rel"],
                            head_fits["lr"]["rank_rel"])
        ref_ms = head_fits["lr"]["one_process_ms"]
        sgd = [h["sgd"] for h in heads]
        want_sgd = "split" if MESH_DEVICE.startswith("cuda") else "eager"
        expect(all(f["update_rel"] <= TUNING_UPDATE_TOL
                   and f["rank_rel"] <= RANK_AGREE_TOL
                   for f in head_fits.values())
               and all(h["groups"] == float(TRAIN_RANKS_SLOTS)
                       and h["steps"] == TRAIN_MESH_LR_ITER * head_steps
                       and h["sgd"]["steps"] == h["steps"]
                       and h["sgd"]["modes"][0][0] == want_sgd
                       for h in heads),
               f"[{tag}] (b) the head on dp4 vs one process: {head_fits}, "
               f"groups {[h['groups'] for h in heads]}, steps "
               f"{[(h['steps'], h['sgd']['steps']) for h in heads]} (want "
               f"{TRAIN_MESH_LR_ITER * head_steps}), SGD modes "
               f"{[s['modes'] for s in sgd]} (want {want_sgd})")
        lr_ms = [h["fit_s"] / h["steps"] * 1e3 for h in heads]
        print(f"[{tag}] (b) DeepImageFeaturizer(Xception) in each rank: "
              f"{[h['features'][0] for h in heads]} images, B1 "
              f"{[h['launches']['sepconv'] for h in heads]} "
              f"({SEPCONV_PER_FORWARD} a forward); LogisticRegression "
              f"({TRAIN_MESH_LR_ITER} epochs of {head_steps} steps) on dp4 = "
              f"{world} ranks x {TRAIN_RANKS_SLOTS} groups vs one process's "
              f"dp4 slots on the same global batches: (w, b) update rel err "
              f"{lr_rel:.3e}, ranks rel {lr_agree:.2e}; modes "
              f"{[h['modes'] for h in heads]}; ms a step "
              f"{[round(v, 2) for v in lr_ms]} (fit wall) vs one process "
              f"{ref_ms:.2f}; gloo all-reduce "
              f"{heads[0]['reduce_bytes'] / max(1, heads[0]['reduce_calls']):.0f}"
              f" B a step ({card})", flush=True)
        print(f"[{tag}] (b) the same head through fit_data_parallel with "
              f"SGD on dp4: update rel err "
              f"{head_fits['sgd']['update_rel']:.3e} vs one process, ranks "
              f"rel {head_fits['sgd']['rank_rel']:.2e}; modes "
              f"{[s['modes'] for s in sgd]}, captures "
              f"{[s['captures'] for s in sgd]}; ms a step "
              f"{[round(s['fit_s'] / s['steps'] * 1e3, 2) for s in sgd]} "
              f"(fit wall, warm-up and captures included) vs one process "
              f"{head_fits['sgd']['one_process_ms']:.2f} ({card})",
              flush=True)
        out["head"] = dict(launches=[h["launches"] for h in heads],
                           fits=head_fits, sgd=sgd,
                           update_rel=lr_rel, rank_rel=lr_agree,
                           modes=[h["modes"] for h in heads], ms=lr_ms,
                           one_process_ms=ref_ms,
                           reduce_calls=heads[0]["reduce_calls"],
                           reduce_bytes=heads[0]["reduce_bytes"])

        # (c) batch statistics across the ranks' groups
        zoo = load_model("InceptionV3", weights=None)
        before = zoo.state_dict()
        stat_keys = [k for k in before
                     if k.endswith(("running_mean", "running_var"))]
        n = TRAIN_MESH_STATS_ROWS
        onehot = np.eye(1000, dtype=np.float32)
        sdf = DataFrame({"uri": paths[:n], "onehot": [
            onehot[v].tolist() for v in labels[:n]]})
        est = ImageFileEstimator(
            inputCol="uri", outputCol="preds", labelCol="onehot",
            modelFunction=ModelFunction.from_module(zoo),
            imageLoader=load_inception_v3, optimizer="sgd", batchSize=n,
            trainBatchStats=True, fitParams={"epochs": 1, "shuffle": False})
        torch.backends.cudnn.deterministic = True
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _DefaultSlots(slots4):
                one = est.fit(sdf).getModelFunction().module.state_dict()
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
        finally:
            torch.backends.cudnn.deterministic = False
        got = [{k: torch.from_numpy(v) for k, v in np.load(os.path.join(
            base, f"stats_{r}.npz")).items()} for r in range(world)]
        srel = _update_rel({k: one[k] for k in stat_keys},
                           {k: got[0][k] for k in stat_keys}, before)
        same = all(torch.equal(got[0][k], got[1][k]) for k in stat_keys)
        moved = any(not torch.equal(got[0][k], before[k]) for k in stat_keys)
        stats = [r["stats"] for r in ranks]
        bn_calls = [s["reduce_calls"] for s in stats]
        # all-reduces: the float32 flat buffer (every parameter's
        # gradient) once, the loss at its own type (float64: the one-hot
        # labels are float64) in one element of its own, and each
        # BatchNorm's float32 (sum, sum of squares, count) forward and
        # backward
        bns = [m for m in zoo.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        want_calls = 2 + 2 * len(bns)
        want_bytes = 8 + 4 * (sum(p.numel() for p in zoo.parameters())
                              + 2 * sum(2 * m.num_features + 1 for m in bns))
        expect(srel <= TUNING_STATS_TOL and same and moved
               and all(s["groups"] == float(TRAIN_RANKS_SLOTS)
                       and s["modes"] and s["modes"][0][0] == "eager"
                       and "ranks" in s["modes"][0][1]
                       and s["reduce_calls"] == want_calls
                       and s["loss_calls"] == 1
                       and s["reduce_bytes"] == want_bytes for s in stats),
               f"[{tag}] (c) trainBatchStats on dp4 over two ranks: "
               f"statistics rel err {srel:.4g} vs one process (tol "
               f"{TUNING_STATS_TOL}), ranks equal {same}, moved "
               f"{moved}, groups {[s['groups'] for s in stats]}, modes "
               f"{[s['modes'] for s in stats]}, all-reduces "
               f"{[(s['reduce_calls'], s['reduce_bytes']) for s in stats]} "
               f"(want {want_calls} of {want_bytes} B)")
        print(f"[{tag}] (c) trainBatchStats=True on the zoo's InceptionV3 "
              f"(one step of {n} rows: {n // world} a rank, "
              f"{n // world // TRAIN_RANKS_SLOTS} a group): "
              f"{len(stat_keys)} running statistics vs one process's dp4 "
              f"rel err {srel:.3e} (tol {TUNING_STATS_TOL}); ranks "
              f"bit for bit {same}; mode {stats[0]['modes']}; fit "
              f"{[round(s['fit_s'], 2) for s in stats]} s a rank vs one "
              f"process {one_s:.2f} s; gloo all-reduces {bn_calls} "
              f"({stats[0]['reduce_bytes']} B: the flat buffer, the "
              f"float64 loss beside it ({stats[0]['loss_ms']:.2f} / "
              f"{stats[1]['loss_ms']:.2f} ms on the host) and each "
              f"BatchNorm's sums, forward and backward) ({card})",
              flush=True)
        out["stats"] = dict(rel=srel, ranks_equal=same, modes=[
            s["modes"] for s in stats], fit_s=[s["fit_s"] for s in stats],
            one_process_s=one_s, reduce_calls=bn_calls,
            reduce_bytes=stats[0]["reduce_bytes"],
            loss_ms=[s["loss_ms"] for s in stats])
        del zoo, est, one
    counts = read_counts(sepconv)
    expect(counts == dict(sepconv=0, sepconv_tiled=0, mbconv=0),
           f"[{tag}] this process's launches {counts}, want none of B1-B3")
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{tag}] phase {out['phase_s']:.1f}s (the ranks "
          f"{out['ranks_s']:.1f}s) on {card}", flush=True)
    check(not problems, f"[{tag}] {len(problems)} failed: "
                        + " | ".join(problems))
    out["launches"] = dict(
        sepconv=sum(h["launches"]["sepconv"] for h in heads),
        sepconv_tiled=0, mbconv=0)
    return out


MODEL_RANKS_STATS_MODEL = "InceptionV3"  # (f): the zoo model whose every
#                                          conv is split across the ranks
MODEL_RANKS_CHILD_TIMEOUT_S = 420        # a rank's (d), (f) and (e)


_MODEL_RANKS_CHILD = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as c
rank, world, port, base = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
print(json.dumps(c._model_ranks_child(rank, world, port, base)))
"""


class _GroupTally:
    """While entered, tallies the collectives of every
    ``distributed.RankGroup`` of more than one rank by kind: ``gather``
    (a split value all-gathered over its row group), ``input`` (the row
    group's all-reduce of a split op's input gradient), ``grads`` (the
    column group's all-reduce of the step's flat buffer) and ``bn`` (the
    column group's all-reduce of a BatchNorm's sums): calls, bytes and
    host seconds inside each call, staging included (instrumentation of
    this script)."""

    KINDS = ("gather", "input", "grads", "bn")

    def __init__(self, row):
        self.row = tuple(row)  # the ranks of this rank's row group

    def __enter__(self):
        from sparkdl_tpu_torch.parallel import distributed

        self.tally = {k: [0, 0, 0.0] for k in self.KINDS}
        cls = distributed.RankGroup
        self._saved = (cls.all_gather, cls.all_reduce,
                       cls.differentiable_all_reduce)
        gather, reduce, bn = self._saved
        tally = self.tally

        def timed(kind, fn, nbytes):
            def run(group, t):
                if group.size == 1:
                    return fn(group, t)
                t0 = time.perf_counter()
                try:
                    return fn(group, t)
                finally:
                    row = tally[kind(group) if callable(kind) else kind]
                    row[0] += 1
                    row[1] += nbytes(group, t)
                    row[2] += time.perf_counter() - t0
            return run

        size = lambda g, t: t.numel() * t.element_size()  # noqa: E731
        cls.all_gather = timed("gather", gather,
                               lambda g, t: size(g, t) * g.size)
        # a row group's all-reduce is an input gradient's, a column
        # group's the step's flat buffer (or its loss)
        cls.all_reduce = timed(
            lambda g: "input" if g.ranks == self.row else "grads", reduce,
            size)
        cls.differentiable_all_reduce = timed("bn", bn, size)
        return self

    def __exit__(self, *exc):
        from sparkdl_tpu_torch.parallel import distributed

        cls = distributed.RankGroup
        (cls.all_gather, cls.all_reduce,
         cls.differentiable_all_reduce) = self._saved

    def per_step(self, steps):
        return {k: dict(calls=v[0] / steps, bytes=v[1] / steps,
                        host_ms=v[2] / steps * 1e3)
                for k, v in self.tally.items()}


def _xception_head():
    """(d)-(e)'s model: config 5's head (its ``predictions`` weight and
    bias, 1000 x 2048, as [train_mesh] (c) splits it) over the features
    of the zoo Xception at 299x299, frozen (B1 30 a forward): (the head's
    tensors by name, predict)."""
    import torch.nn.functional as F

    from sparkdl_tpu_torch.models import load_model

    module, params_all, _ = _train_model_per_device()
    names = [n for n in sorted(params_all)
             if re.search(r"predictions\.(weight|bias)$", n)]
    head = {n: params_all[n].detach().clone() for n in names}
    del module, params_all
    xc = load_model("Xception", weights=None).cuda().eval()
    xc.requires_grad_(False)
    w, b = names[1], names[0]  # "...weight" sorts after "...bias"

    def predict(p, x):
        with torch.no_grad():  # B1's bf16 features, widened for the head
            f = xc(x, features=True).float()
        return torch.softmax(F.linear(f, p[w], p[b]), dim=-1)

    return head, predict


def _xhead_steps(step, x, y, steps=None):
    """Drive ``step`` over TRAIN_MESH_SPLIT_STEPS global batches of
    TUNING_BATCH rows (every rank of a row the same rows): (losses, ms a
    step with the first, after the first)."""
    steps = steps or TRAIN_MESH_SPLIT_STEPS
    losses = []
    torch.cuda.synchronize()
    t0 = t1 = time.perf_counter()
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        off = (i * TUNING_BATCH) % len(x)
        losses.append(step(torch.from_numpy(x[off:off + TUNING_BATCH]).cuda(),
                           torch.from_numpy(y[off:off + TUNING_BATCH]).cuda()))
    losses = torch.stack(losses).cpu().numpy()
    torch.cuda.synchronize()
    end = time.perf_counter()
    return (losses, (end - t0) / steps * 1e3,
            (end - t1) / max(1, steps - 1) * 1e3)


def _xhead_one_process(x, y):
    """(d)-(e)'s references in one process, on the same global batches:
    the head split over two slots of the card (dp1 x tp2) and replicated
    on one device, SGD and Adam: {(optimizer, layout): (fitted, losses, ms,
    warm ms)} and the head's first values."""
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.parallel.mesh import P, get_mesh

    head, predict = _xception_head()
    names = sorted(head)
    out = {"init": {k: v.detach().cpu() for k, v in head.items()}}
    torch.backends.cudnn.deterministic = True
    try:
        for opt_name in ("sgd", "adam"):
            for layout, mesh in (
                    ("dp1xtp2", get_mesh(devices=[MESH_DEVICE] * 2,
                                         model_parallel=2)),
                    ("replicated", None)):
                params = {k: v.detach().clone().requires_grad_()
                          for k, v in head.items()}
                opt = NamedOptimizer(opt_name)([params[k] for k in names])
                step = train.make_train_step(
                    predict, "categorical_crossentropy", opt, params,
                    mesh=mesh, param_specs=None if mesh is None else (
                        lambda path, leaf: P("model")))
                losses, ms, warm = _xhead_steps(step, x, y)
                out[(opt_name, layout)] = dict(
                    fitted={k: torch.from_numpy(v) for k, v in
                            step.host_params().items()},
                    losses=losses, ms=ms, warm_ms=warm)
                del step, opt, params
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _mr_head(sepconv, rank, base, model_parallel, tag):
    """(d) / (e) in a rank: config 5's head split over
    ``get_mesh(model_parallel=...)`` of the group (one row over both
    ranks), the Xception featurizer in every forward, SGD and Adam; the
    fitted head saved for the parent."""
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import mesh as mesh_lib
    from sparkdl_tpu_torch.parallel import train

    data = np.load(os.path.join(base, "data.npz"))
    x, y = data["x"], data["y"]
    head, predict = _xception_head()
    names = sorted(head)
    mesh = mesh_lib.get_mesh(model_parallel=model_parallel)
    out = dict(mesh=mesh.shape, ranks=mesh.ranks.tolist())
    torch.backends.cudnn.deterministic = True
    try:
        for opt_name in ("sgd", "adam"):
            params = {k: v.detach().clone().requires_grad_()
                      for k, v in head.items()}
            opt = NamedOptimizer(opt_name)([params[k] for k in names])
            step = train.make_train_step(
                predict, "categorical_crossentropy", opt, params, mesh=mesh,
                param_specs=lambda path, leaf: mesh_lib.P("model"))
            lay = step.layout()
            with _GroupTally(lay["row"]) as coll:
                reset_counts(sepconv)
                losses, ms, warm = _xhead_steps(step, x, y)
                counts = read_counts(sepconv)
            np.savez(os.path.join(base, f"{tag}_{opt_name}_{rank}.npz"),
                     **step.host_params())
            w = step.tree[names[1]]
            out[opt_name] = dict(
                losses=losses.tolist(), ms=ms, warm_ms=warm,
                launches=counts, layout=lay,
                mode=list(train.step_mode(
                    torch.device("cuda"), opt, False, row=lay["row"],
                    column=lay["column"])),
                shards=[[str(s.device), list(s.shape)] for s in w.shards],
                moments=([list(opt.state[s]["mu"].shape) for s in w.shards]
                         if opt_name == "adam" else None),
                collectives=coll.per_step(TRAIN_MESH_SPLIT_STEPS))
            del step, opt, params
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _mr_stats_model():
    """(f)'s model: the zoo's MODEL_RANKS_STATS_MODEL, its train-mode
    apply with BatchNorm statistics (the estimator's trainBatchStats
    route): (module on the card, params, stats, train_fn)."""
    from sparkdl_tpu_torch.graph.function import (ModelFunction, apply_with,
                                                  batch_stat_names)
    from sparkdl_tpu_torch.models import load_model

    mf = ModelFunction.from_module(load_model(MODEL_RANKS_STATS_MODEL,
                                              weights=None))
    module = copy.deepcopy(mf.module).cuda()
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    stat_names = batch_stat_names(module)
    params = {n: t.detach().clone().requires_grad_()
              for n, t in module.named_parameters()}
    stats = {n: tensors[n].detach().clone() for n in stat_names}

    def train_fn(v, x):
        return apply_with(mf.train_fn, module,
                          {**v["params"], **v["batch_stats"]}, x)

    return module, params, stats, train_fn


def _mr_stats_step(mesh, rows):
    """One trainBatchStats step (SGD) of (f)'s model under the default
    partition rules on ``mesh`` over ``rows`` images: (params, stats, ms,
    the step, its split leaves)."""
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import mesh as mesh_lib
    from sparkdl_tpu_torch.parallel import train

    module, params, stats, train_fn = _mr_stats_model()
    _, by_name = mesh_lib.resolve_param_shardings(module, mesh)
    specs = {n: by_name[n] for n in params}
    ref = {"batch_stats": stats}
    step = train.make_train_step_with_stats(
        train_fn, "categorical_crossentropy",
        NamedOptimizer("sgd")(list(params.values())), params, ref,
        mesh=mesh, param_specs=specs)
    split = sum(not mesh_lib.spec_is_replicated(s) for s in specs.values())
    x, y = rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = {k: v.detach().cpu() for k, v in ref["batch_stats"].items()}
    return got, ms, step, split


def _mr_stats(rank, base):
    """(f) in a rank: one trainBatchStats step with every conv of the
    zoo model split across the two ranks (dp1 x tp2); its running
    statistics saved for the parent."""
    from sparkdl_tpu_torch.parallel import mesh as mesh_lib
    from sparkdl_tpu_torch.parallel import train

    data = np.load(os.path.join(base, "stats_rows.npz"))
    mesh = mesh_lib.get_mesh(model_parallel=2)
    torch.backends.cudnn.deterministic = True
    try:
        with _GroupTally(mesh_lib.local_rows(mesh).row_ranks[0]) as coll:
            t0 = time.perf_counter()
            stats, ms, step, split = _mr_stats_step(
                mesh, (data["x"], data["y"]))
            wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    lay = step.layout()
    np.savez(os.path.join(base, f"f_stats_{rank}.npz"),
             **{k: v.numpy() for k, v in stats.items()})
    first = sorted(lay["split"])[0]
    out = dict(model=MODEL_RANKS_STATS_MODEL, mesh=mesh.shape, ms=ms,
               wall_s=wall, split_leaves=split, row=lay["row"],
               column=lay["column"], example=[first, lay["split"][first]],
               mode=list(train.step_mode(
                   torch.device("cuda"), step.optimizer, True,
                   row=lay["row"], column=lay["column"])),
               collectives=coll.per_step(1))
    del step
    return out


def _model_ranks_child(rank, world, port, base):
    """One rank of [model_ranks]: a group of one slot a rank for (d) and
    (f) and the fits' refusal, then a group of two slots a rank (the port
    in ``base``'s ports.json) for (e)."""
    from sparkdl_tpu_torch.ops import sepconv
    from sparkdl_tpu_torch.parallel import distributed, train
    from sparkdl_tpu_torch.parallel import mesh as mesh_lib

    with open(os.path.join(base, "ports.json")) as fh:
        port2 = json.load(fh)["second"]
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
    out = dict(rank=rank, backend=distributed.backend(),
               modules=sorted(m for m in ("jax", "sparkdl_tpu")
                              if m in sys.modules))
    t0 = time.perf_counter()
    out["d"] = _mr_head(sepconv, rank, base, 2, "d")
    out["d_s"] = time.perf_counter() - t0
    try:
        rng = np.random.default_rng(SEED + 271)
        train.fit_data_parallel(
            lambda p, xb: xb @ p["w"], {"w": np.zeros((4, 2), np.float32)},
            rng.normal(size=(8, 4)).astype(np.float32),
            np.arange(8) % 2, loss=train.softmax_cross_entropy,
            mesh=mesh_lib.get_mesh(model_parallel=2))
        out["refusal"] = None
    except NotImplementedError as e:
        out["refusal"] = str(e)
    t0 = time.perf_counter()
    out["f"] = _mr_stats(rank, base)
    out["f_s"] = time.perf_counter() - t0
    distributed.shutdown()
    distributed.initialize(f"localhost:{port2}", world, rank,
                           backend="gloo", local_slots=[MESH_DEVICE] * 2)
    t0 = time.perf_counter()
    out["e"] = _mr_head(sepconv, rank, base, 4, "e")
    out["e_s"] = time.perf_counter() - t0
    distributed.shutdown()
    return out


def phase_model_ranks(sepconv):
    """[model_ranks]: a model axis that spans ranks.  Two ranks over gloo
    (``python -c _MODEL_RANKS_CHILD`` children) sharing the card, f32
    with TF32 off, cuDNN deterministic; each rank of a row passes the
    same rows:

      (d) config 5's head (its ``predictions`` weight, 1000 x 2048, and
          bias) split across two ranks of one slot (dp1 x tp2, one row
          over both), over the frozen Xception featurizer at 299x299 (B1
          30 a forward, counted in each rank), SGD and Adam for
          TRAIN_MESH_SPLIT_STEPS steps of TUNING_BATCH rows: the ranks'
          losses and heads within TUNING_UPDATE_TOL of one process's dp1
          x tp2 step on two slots of the card, the ranks bit for bit;
      (e) the same head over two ranks of two slots (dp1 x tp4, two
          shards a rank), held to the replicated one-device step;
      (f) trainBatchStats on the zoo's MODEL_RANKS_STATS_MODEL under the
          default rules (every conv split across the two ranks), one step
          of TRAIN_MESH_STATS_ROWS images: the running statistics within
          TUNING_STATS_TOL of one process's dp1 x tp2 step, the ranks bit
          for bit;
    and ``fit_data_parallel`` on (d)'s mesh raises, naming JAX's replica
    contract.  Each rank's mesh, shards and owners, row and column
    groups, step mode and reason, ms a step beside one process's, and
    each collective's calls, bytes and host ms a step are printed."""
    import socket
    import tempfile

    from sparkdl_tpu_torch.parallel.mesh import get_mesh

    tag = "model_ranks"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(card=card)
    problems = []

    def expect(cond, msg):
        if not cond:
            print(f"FAIL (at the phase's end): {msg}", flush=True)
            problems.append(msg)

    t_phase = time.perf_counter()
    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        paths, labels = _tuning_files(os.path.join(tmp, "images"))
        x = np.stack([load_inception_v3(p) for p in paths])
        y = np.eye(1000, dtype=np.float32)[labels]
        base = os.path.join(tmp, "ranks")
        os.makedirs(base)
        n = TRAIN_MESH_STATS_ROWS
        np.savez(os.path.join(base, "data.npz"), x=x, y=y)
        np.savez(os.path.join(base, "stats_rows.npz"), x=x[:n], y=y[:n])
        with socket.socket() as s:
            s.bind(("localhost", 0))
            with open(os.path.join(base, "ports.json"), "w") as fh:
                json.dump({"second": s.getsockname()[1]}, fh)
        reset_counts(sepconv)
        t0 = time.perf_counter()
        refs = _xhead_one_process(x, y)
        out["refs_s"] = time.perf_counter() - t0
        parent_b1 = read_counts(sepconv)["sepconv"]
        t0 = time.perf_counter()
        torch.backends.cudnn.deterministic = True
        try:
            before = {k: v.cpu() for k, v in _mr_stats_model()[2].items()}
            one_stats, one_ms, one_step, _ = _mr_stats_step(
                get_mesh(devices=[MESH_DEVICE] * 2, model_parallel=2),
                (x[:n], y[:n]))
            del one_step
        finally:
            torch.backends.cudnn.deterministic = False
        out["stats_ref_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _train_ranks(base, world, _MODEL_RANKS_CHILD, tag,
                             MODEL_RANKS_CHILD_TIMEOUT_S)
        out["ranks_s"] = time.perf_counter() - t0
        expect(all(r["backend"] == "gloo" and r["modules"] == []
                   for r in ranks),
               f"[{tag}] ranks (backend, modules): "
               f"{[(r['backend'], r['modules']) for r in ranks]}")

        init = refs["init"]
        zero = {k: torch.zeros(()) for k in init}
        for part, ref_layout, shards in (("d", "dp1xtp2", 1),
                                         ("e", "replicated", 2)):
            res = {}
            for opt_name in ("sgd", "adam"):
                fits = [{k: torch.from_numpy(v) for k, v in np.load(
                    os.path.join(base, f"{part}_{opt_name}_{r}.npz")).items()}
                    for r in range(world)]
                recs = [r[part][opt_name] for r in ranks]
                ref = refs[(opt_name, ref_layout)]
                losses = np.asarray(recs[0]["losses"])
                loss_rel = float(np.max(np.abs(losses - ref["losses"])
                                        / np.abs(ref["losses"])))
                upd_rel = _update_rel(ref["fitted"], fits[0], init)
                agree = _update_rel(fits[0], fits[1], zero)
                same_losses = recs[0]["losses"] == recs[1]["losses"]
                want_b1 = SEPCONV_PER_FORWARD * TRAIN_MESH_SPLIT_STEPS
                rows = [r["layout"]["row"] for r in recs]
                cols = [r["layout"]["column"] for r in recs]
                owners = [sorted(r["layout"]["split"].values(),
                                 key=lambda v: v["local"])[0]["owners"]
                          for r in recs]
                coll = [r["collectives"] for r in recs]
                expect(loss_rel <= TUNING_UPDATE_TOL
                       and upd_rel <= TUNING_UPDATE_TOL and agree == 0.0
                       and same_losses
                       and all(rc["launches"] == dict(
                           sepconv=want_b1, sepconv_tiled=0, mbconv=0)
                               for rc in recs)
                       and rows == [[0, 1], [0, 1]]
                       and cols == [[0], [1]]
                       and all(len(rc["shards"]) == shards for rc in recs)
                       and all(rc["mode"][0] == "eager" for rc in recs)
                       and all(c["grads"]["calls"] == 0
                               and c["input"]["calls"] == 0
                               and c["gather"]["calls"] > 0 for c in coll),
                       f"[{tag}] ({part}) {opt_name}: loss rel err "
                       f"{loss_rel:.4g}, update {upd_rel:.4g} vs one "
                       f"process's {ref_layout} (tol {TUNING_UPDATE_TOL}); "
                       f"ranks rel {agree:.3g}, losses equal {same_losses};"
                       f" B1 {[rc['launches'] for rc in recs]} (want "
                       f"{want_b1} a rank); rows {rows}, columns {cols}; "
                       f"shards {[rc['shards'] for rc in recs]}; modes "
                       f"{[rc['mode'][0] for rc in recs]}; collectives "
                       f"{coll}")
                for k, rc in enumerate(recs):
                    print(f"[{tag}] ({part}) {opt_name} rank {k}: mesh "
                          f"{ranks[0][part]['mesh']} ranks "
                          f"{ranks[0][part]['ranks']}, shards "
                          f"{rc['shards']} (owners {owners[k]}, this "
                          f"rank's {rc['layout']['positions']}), row "
                          f"group {rc['layout']['row']}, column group "
                          f"{rc['layout']['column']}, mode {rc['mode'][0]}"
                          f" ({rc['mode'][1]}); B1 {rc['launches']['sepconv']}"
                          f" ({SEPCONV_PER_FORWARD} a forward); "
                          f"Adam moments {rc['moments']}", flush=True)
                    for kind, v in rc["collectives"].items():
                        print(f"[{tag}] ({part}) {opt_name} rank {k} "
                              f"collectives "
                              f"{kind}: {v['calls']:.1f} calls, "
                              f"{v['bytes']:.0f} B, {v['host_ms']:.2f} ms "
                              f"on the host a step", flush=True)
                print(f"[{tag}] ({part}) {opt_name}: config 5's head split "
                      f"over {ranks[0][part]['mesh']} across the ranks vs "
                      f"one process's {ref_layout}: loss rel err "
                      f"{loss_rel:.3e}, update rel err {upd_rel:.3e}; "
                      f"ranks rel {agree:.2e}; ms a step after the first "
                      f"{recs[0]['warm_ms']:.1f} / {recs[1]['warm_ms']:.1f}"
                      f" (with the first {recs[0]['ms']:.1f} / "
                      f"{recs[1]['ms']:.1f}) vs one process "
                      f"{ref['warm_ms']:.1f} ({ref['ms']:.1f}) ({card})",
                      flush=True)
                res[opt_name] = dict(
                    loss_rel=loss_rel, update_rel=upd_rel, rank_rel=agree,
                    warm_ms=[rc["warm_ms"] for rc in recs],
                    ms=[rc["ms"] for rc in recs], one_process_ms=ref["ms"],
                    one_process_warm_ms=ref["warm_ms"],
                    launches=[rc["launches"] for rc in recs],
                    collectives=coll[0])
            out[part] = res

        # (f) statistics through convs split across the ranks
        got = [{k: torch.from_numpy(v) for k, v in np.load(os.path.join(
            base, f"f_stats_{r}.npz")).items()} for r in range(world)]
        keys = sorted(before)
        srel = _update_rel({k: one_stats[k] for k in keys},
                           {k: got[0][k] for k in keys}, before)
        same = all(torch.equal(got[0][k], got[1][k]) for k in keys)
        moved = any(not torch.equal(got[0][k], before[k]) for k in keys)
        fs = [r["f"] for r in ranks]
        expect(srel <= TUNING_STATS_TOL and same and moved
               and all(f["mode"][0] == "eager" and f["row"] == [0, 1]
                       and f["collectives"]["gather"]["calls"] > 0
                       and f["collectives"]["input"]["calls"] > 0
                       for f in fs),
               f"[{tag}] (f) trainBatchStats across the ranks: statistics "
               f"rel err {srel:.4g} vs one process's dp1 x tp2 (tol "
               f"{TUNING_STATS_TOL}), ranks equal {same}, moved {moved}, "
               f"modes {[f['mode'] for f in fs]}, collectives "
               f"{[f['collectives'] for f in fs]}")
        for k, f in enumerate(fs):
            print(f"[{tag}] (f) rank {k}: {f['model']} on "
                  f"{f['mesh']}, {f['split_leaves']} leaves split (e.g. "
                  f"{f['example'][0]}: shards {f['example'][1]['shards']}, "
                  f"owners {f['example'][1]['owners']}), row group "
                  f"{f['row']}, column group {f['column']}, mode "
                  f"{f['mode'][0]} ({f['mode'][1]})", flush=True)
            for kind, v in f["collectives"].items():
                print(f"[{tag}] (f) rank {k} collectives {kind}: "
                      f"{v['calls']:.0f} calls, {v['bytes']:.0f} B, "
                      f"{v['host_ms']:.1f} ms on the host a step",
                      flush=True)
        print(f"[{tag}] (f) trainBatchStats=True on the zoo's "
              f"{MODEL_RANKS_STATS_MODEL}, every conv split across the two "
              f"ranks, one step of {n} rows (each rank the same rows): "
              f"{len(keys)} running statistics vs one process's dp1 x tp2 "
              f"rel err {srel:.3e} (tol {TUNING_STATS_TOL}); ranks bit for "
              f"bit {same}; a step {fs[0]['ms']:.0f} / {fs[1]['ms']:.0f} ms"
              f" a rank vs one process {one_ms:.0f} ms ({card})",
              flush=True)
        out["f"] = dict(rel=srel, ranks_equal=same, model=fs[0]["model"],
                        ms=[f["ms"] for f in fs], one_process_ms=one_ms,
                        collectives=fs[0]["collectives"],
                        split_leaves=fs[0]["split_leaves"])
        refusals = [r["refusal"] for r in ranks]
        expect(all(e is not None and "replica contract" in e
                   and "ROADMAP.md §C" in e for e in refusals),
               f"[{tag}] fit_data_parallel on dp1 x tp2 across the ranks: "
               f"{refusals}")
        print(f"[{tag}] fit_data_parallel on (d)'s mesh refuses on both "
              f"ranks: {refusals[0]}", flush=True)
        out["rank_s"] = [dict(d=r["d_s"], e=r["e_s"], f=r["f_s"])
                         for r in ranks]
    counts = read_counts(sepconv)
    b1 = SEPCONV_PER_FORWARD * TRAIN_MESH_SPLIT_STEPS
    expect(counts == dict(sepconv=parent_b1, sepconv_tiled=0, mbconv=0)
           and parent_b1 == 4 * b1,
           f"[{tag}] this process's launches {counts}: want B1 {4 * b1} "
           f"(the four one-process references), none of B2-B3")
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{tag}] phase {out['phase_s']:.1f}s (references "
          f"{out['refs_s']:.1f}s + {out['stats_ref_s']:.1f}s, the ranks "
          f"{out['ranks_s']:.1f}s: {out['rank_s']}) on {card}", flush=True)
    check(not problems, f"[{tag}] {len(problems)} failed: "
                        + " | ".join(problems))
    out["launches"] = dict(
        sepconv=sum(r["d"][o]["launches"]["sepconv"]
                    + r["e"][o]["launches"]["sepconv"]
                    for r in ranks for o in ("sgd", "adam")),
        sepconv_tiled=0, mbconv=0)
    return out


COMPILE_BATCH = 32              # the pinned batch each child dispatches
COMPILE_CHILD_TIMEOUT_S = 300   # a child's time limit
COMPILE_TAMPERED = "sepconv"    # the kernels record the phase tampers

_COMPILE_CHILD = f"""
import hashlib, json, sys, time
t0 = time.perf_counter()
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from sparkdl_tpu_torch.image.io import arrowStructsToBatch
from sparkdl_tpu_torch.ops import sepconv
from sparkdl_tpu_torch.parallel import compile_cache
from sparkdl_tpu_torch.transformers import named_image as ni
torch.cuda.init()
t1 = time.perf_counter()
sepconv.load_all()   # ops/build.py: the cache resolves, nvcc or a hit
t2 = time.perf_counter()
eng = ni._zoo_engine("Xception", True, {COMPILE_BATCH})
t3 = time.perf_counter()
df = chip_smoke.synthetic_frame({COMPILE_BATCH}, 299, chip_smoke.SEED + 191)
images, ok = arrowStructsToBatch(df.table.column("image"), 299, 299)
pinned = eng._pad(images)
torch.cuda.synchronize()
t4 = time.perf_counter()
host = lambda y: torch.as_tensor(y).cpu().float().numpy()
first = host(eng.run_padded(pinned))   # the eager warm-up and the capture
torch.cuda.synchronize()
t5 = time.perf_counter()
chip_smoke.reset_counts(sepconv)
out = host(eng.run_padded(pinned))     # one replay, counted
torch.cuda.synchronize()
t6 = time.perf_counter()
print(json.dumps(dict(
    digest=hashlib.sha256(out.tobytes()).hexdigest(),
    shape=list(out.shape), finite=bool(np.isfinite(out).all()),
    first_equal=bool(np.array_equal(first, out)), decoded=bool(ok.all()),
    launches=chip_smoke.read_counts(sepconv), captures=eng.captures,
    device=str(eng.device), policy=eng.compile_policy(),
    state=compile_cache.state(), stats=compile_cache.stats(),
    seconds=dict(start=t1 - t0, build=t2 - t1, engine=t3 - t2,
                 capture=t5 - t4, dispatch=t6 - t5, total=t6 - t0),
    modules=sorted(m for m in ("jax", "sparkdl_tpu") if m in sys.modules))))
"""


def _compile_child(cache_dir):
    """One child process under ``SPARKDL_COMPILE_CACHE=cache_dir``; returns
    its report and its wall seconds.  The child is killed past its limit."""
    env = dict(os.environ, SPARKDL_COMPILE_CACHE=cache_dir)
    for knob in ("SPARKDL_FAULTS", "SPARKDL_TRACE", "SPARKDL_BLACKBOX"):
        env.pop(knob, None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _COMPILE_CHILD],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=env, capture_output=True, text=True,
                       timeout=COMPILE_CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    check(r.returncode == 0 and lines,
          f"[compile] child failed (rc {r.returncode}): {r.stderr[-3000:]}")
    return json.loads(lines[-1]), wall


def phase_compile(sepconv):
    """[compile]: the persistent compile cache
    (``sparkdl_tpu_torch.parallel.compile_cache``) across three child
    processes under ``SPARKDL_COMPILE_CACHE=<fresh temporary directory>``.
    Each builds the four kernel libraries through ``ops/build.py``
    (``sepconv.load_all``), builds the zoo Xception featurizer engine at
    299x299 (seeded weights, full width and depth), captures it on a
    pinned batch of 32 seeded images and replays it once (B1 30 launches,
    counted), and reports the output's digest, the cache's ``state()`` and
    ``stats()``, its captures and the seconds of each step.

      A populates the cache: 4 misses (nvcc runs), 0 hits, not reused;
      B, the restart: 0 misses (no nvcc ran), 4 hits, reused, A's output
        bit for bit;
      then the phase tampers the manifest's ``kernels`` record of B1, and
      C purges: invalidated, drift ``kernel:sepconv``, entries purged, 4
        misses, A's output bit for bit.

    The graph is captured anew in every child (CUDA graphs are not
    cached).  Returns the phase's numbers; B1's launches are the three
    counted replays'."""
    import shutil
    import tempfile

    from sparkdl_tpu_torch.parallel import compile_cache

    tag = "compile"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    base = tempfile.mkdtemp(prefix="sparkdl-compile-")
    cache = os.path.join(base, "cache")
    problems = []

    def expect(cond, msg):
        if not cond:
            problems.append(msg)
            print(f"[{tag}] PROBLEM: {msg}", flush=True)

    def entries():
        """name -> (bytes, mtime) of the cache's libraries and logs."""
        return {e.name: (e.stat().st_size, e.stat().st_mtime_ns)
                for e in os.scandir(cache)
                if e.name != compile_cache.MANIFEST_NAME}

    try:
        runs = {}
        for name in ("A", "B", "C"):
            if name == "B":
                before = entries()
            if name == "C":
                path = os.path.join(cache, compile_cache.MANIFEST_NAME)
                with open(path) as fh:
                    doc = json.load(fh)
                doc["kernels"][COMPILE_TAMPERED] = "0" * 16
                with open(path, "w") as fh:
                    json.dump(doc, fh)
            rep, wall = _compile_child(cache)
            rep["wall_s"] = wall
            runs[name] = rep
            if name == "B":
                # nothing was built or rewritten: the restart only loaded
                expect(entries() == before and len(before) == 8,
                       f"child B changed the cache's entries: "
                       f"{sorted(before)} -> {sorted(entries())}")
            st, sec = rep["state"] or {}, rep["seconds"]
            print(f"[{tag}] child {name}: {wall:.2f}s wall (start "
                  f"{sec['start']:.2f}, build {sec['build']:.2f}, engine "
                  f"{sec['engine']:.2f}, first dispatch with its capture "
                  f"{sec['capture']:.2f}, replay {sec['dispatch'] * 1e3:.1f}"
                  f" ms); stats {rep['stats']}; reused {st.get('reused')}, "
                  f"invalidated {st.get('invalidated')}, drift "
                  f"{st.get('drift_rules')}, purged "
                  f"{st.get('purged_entries')}; captures {rep['captures']}; "
                  f"B1 {rep['launches']['sepconv']} launches; digest "
                  f"{rep['digest'][:16]}; on {rep['device']}", flush=True)
            expect(rep["device"].startswith("cuda") and rep["decoded"]
                   and rep["finite"] and rep["first_equal"]
                   and rep["shape"] == [COMPILE_BATCH, 2048]
                   and rep["modules"] == [],
                   f"child {name}: device {rep['device']}, decoded "
                   f"{rep['decoded']}, finite {rep['finite']}, capture == "
                   f"replay {rep['first_equal']}, shape {rep['shape']}, "
                   f"modules {rep['modules']}")
            expect(rep["launches"] == dict(sepconv=SEPCONV_PER_FORWARD,
                                           sepconv_tiled=0, mbconv=0)
                   and rep["captures"] == 1,
                   f"child {name}: launches {rep['launches']}, captures "
                   f"{rep['captures']}")
            expect(st.get("dir") == cache
                   and rep["policy"] in st.get("sharding_policies", [])
                   and st.get("capability") == "sm_90"
                   and st.get("nvcc") is not None,
                   f"child {name}: state {st}, policy {rep['policy']}")
        a, b, c = runs["A"], runs["B"], runs["C"]
        expect(a["stats"] == dict(hits=0, misses=4)
               and a["state"]["reused"] is False
               and a["state"]["invalidated"] is False,
               f"child A: stats {a['stats']}, state {a['state']}")
        expect(b["stats"] == dict(hits=4, misses=0)
               and b["state"]["reused"] is True
               and b["state"]["invalidated"] is False,
               f"child B (restart): stats {b['stats']}, state {b['state']}")
        expect(c["stats"] == dict(hits=0, misses=4)
               and c["state"]["invalidated"] is True
               and c["state"]["drift_rules"] == [f"kernel:{COMPILE_TAMPERED}"]
               and c["state"]["purged_entries"] > 0,
               f"child C (tampered): stats {c['stats']}, state {c['state']}")
        expect(a["digest"] == b["digest"] == c["digest"],
               f"digests A {a['digest']} B {b['digest']} C {c['digest']}")
        saved_build = a["seconds"]["build"] - b["seconds"]["build"]
        saved_wall = a["wall_s"] - b["wall_s"]
        print(f"[{tag}] {card}: the restart (B) ran no nvcc, its output A's "
              f"bit for bit; cold start saved {saved_build:.2f}s of build "
              f"({a['seconds']['build']:.2f} -> {b['seconds']['build']:.2f}"
              f"), {saved_wall:.2f}s of child wall ({a['wall_s']:.2f} -> "
              f"{b['wall_s']:.2f}); the tampered record purged "
              f"{c['state']['purged_entries']} entries and rebuilt in "
              f"{c['seconds']['build']:.2f}s; captures a child "
              f"{[r['captures'] for r in (a, b, c)]} (graphs not cached)",
              flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    check(not problems, f"[{tag}] {len(problems)} failed: "
                        + " | ".join(problems))
    launches = sum(r["launches"]["sepconv"] for r in runs.values())
    return dict(card=card, saved_build_s=saved_build,
                saved_wall_s=saved_wall,
                children={k: dict(stats=r["stats"], seconds=r["seconds"],
                                  wall_s=r["wall_s"], captures=r["captures"],
                                  launches=r["launches"],
                                  digest=r["digest"],
                                  reused=r["state"]["reused"],
                                  invalidated=r["state"]["invalidated"],
                                  drift_rules=r["state"]["drift_rules"],
                                  purged_entries=r["state"]["purged_entries"],
                                  toolchain={k2: r["state"][k2] for k2 in (
                                      "torch_version", "cuda_version",
                                      "nvcc", "capability")})
                          for k, r in runs.items()},
                launches=dict(sepconv=launches, sepconv_tiled=0, mbconv=0))


# [audit]: the program audit, the lockfile's consumers and the lock-order
# checker on the card.
AUDIT_MODEL = "Xception"        # the subset the tier-1 test audits: one zoo
AUDIT_BUCKET = 8                # model at one bucket, plus every model-free
#                                 program (tests/test_torch_graftcheck.py)
AUDIT_FLEET_N = 8               # images the consumers' fleet serves
LOCKCHECK_S = 3.0               # seconds the lock-order child serves
LOCKCHECK_CLIENTS = 8           # its closed-loop clients
LOCKCHECK_CHUNKS = 4            # chunks its stream scorer scores
LOCKCHECK_CHILD_TIMEOUT_S = 300


def audit_subset():
    """The program subset the tier-1 test and ``[audit]`` audit: the zoo
    ``AUDIT_MODEL`` at bucket ``AUDIT_BUCKET`` and its predictor cut, and
    every program of no zoo model (the generic and wide-dense serving
    programs, the head fan-out pair, the train steps, the kernels)."""
    from sparkdl_tpu_torch.analysis.program import stack_programs

    return [s for s in stack_programs(models=[AUDIT_MODEL])
            if s.bucket in (None, AUDIT_BUCKET)]


def _lockcheck_model(device, rng):
    """(model, variables of v1 and v2, images) the lock-order workload
    serves: the zoo Xception at 299x299 (v2: every float weight x (1 +
    1e-3 N(0,1))) on the card, a small dense model on 8x8 images
    elsewhere."""
    if device == "cuda":
        from sparkdl_tpu_torch.models import get_model_spec
        from sparkdl_tpu_torch.transformers import named_image as ni

        size = get_model_spec("Xception").input_size[0]
        state = {k: t.clone() for k, t in
                 ni._cached_model("Xception").state_dict().items()}
        model, v1, v2 = "Xception", None, _perturbed(state, SEED + 211)
    else:
        size = 8
        w = torch.from_numpy(rng.normal(size=(size * size * 3, 16)).astype(
            np.float32))
        m = torch.nn.Module()
        m.register_buffer("w", w)

        def model(module, x):
            return torch.tanh(x.float().reshape(x.shape[0], -1) / 255.0
                              @ module.w)

        v1, v2 = m, {"w": w * 1.001}
    images = rng.integers(0, 256, (2 * LOCKCHECK_CLIENTS, size, size, 3),
                          dtype=np.uint8)
    return model, v1, v2, images


def lockcheck_workload(device="cuda", seconds=LOCKCHECK_S):
    """The lock-order child's work (``[audit]``; ``tests/
    test_torch_lockcheck.py`` runs it on the CPU), meant for a process
    with ``SPARKDL_LOCKCHECK=1``: a ``Fleet`` with a result cache and a
    cost ledger serving ``_lockcheck_model`` from ``LOCKCHECK_CLIENTS``
    closed-loop clients of three tenants for ``seconds``, a v2 canary at
    fraction 0.5 started after a third of the time and promoted after two
    thirds, and beside them a ``StreamScorer`` over a ``Server`` sink
    scoring ``LOCKCHECK_CHUNKS`` chunks.  Returns whether the checker was
    on, the requests served, the errors (a ``LockOrderError`` apart), the
    stream's commits and the acquisition-order graph."""
    import shutil
    import tempfile

    import sparkdl_tpu_torch
    from sparkdl_tpu_torch import streaming
    from sparkdl_tpu_torch.analysis import lockcheck
    from sparkdl_tpu_torch.obs.cost import CostLedger
    from sparkdl_tpu_torch.serving import Fleet, InferenceCache, Server

    sparkdl_tpu_torch.set_default_device(device)
    rng = np.random.default_rng(SEED + 210)
    model, v1, v2, images = _lockcheck_model(device, rng)
    featurize = dict(featurize=True) if isinstance(model, str) else {}
    lock_errors, errors, served = [], [], [0]
    mu = threading.Lock()

    def note(e):
        with mu:
            (lock_errors if isinstance(e, lockcheck.LockOrderError)
             else errors).append(f"{type(e).__name__}: {e}")

    hook = threading.excepthook
    threading.excepthook = lambda a: note(a.exc_value)
    tmp = tempfile.mkdtemp(prefix="lockcheck_")
    try:
        fleet = Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
                      cache=InferenceCache(), cost=CostLedger())
        fleet.add_model("m", model, v1, warm_example=images[0], **featurize)
        fleet.add_version("m", v2)
        deadline = time.perf_counter() + seconds

        def client(k):
            i = k
            while time.perf_counter() < deadline:
                try:
                    fleet.submit("m", images[i % len(images)],
                                 tenant=("gold", "silver", "bronze")[k % 3]
                                 ).result(120)
                    with mu:
                        served[0] += 1
                except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
                    note(e)
                i += LOCKCHECK_CLIENTS

        sink = Server(model, v1, max_batch_size=8, bucket_sizes=[8],
                      max_wait_ms=2, **featurize)
        chunks = [images[j::LOCKCHECK_CHUNKS]
                  for j in range(LOCKCHECK_CHUNKS)]
        scorer = streaming.StreamScorer(
            sink, streaming.MemorySource(chunks, finished=True),
            journal_path=os.path.join(tmp, "journal.jsonl"),
            out_dir=os.path.join(tmp, "out"))
        summary = {}

        def stream():
            try:
                summary.update(scorer.run())
            except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
                note(e)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(LOCKCHECK_CLIENTS)]
        streamer = threading.Thread(target=stream)
        for t in threads:
            t.start()
        streamer.start()
        time.sleep(seconds / 3)
        fleet.start_rollout("m", canary_fraction=0.5, warm_example=images[1])
        time.sleep(seconds / 3)
        fleet.promote("m")
        for t in threads:
            t.join(timeout=300)
        streamer.join(timeout=300)
        fleet.close()
        sink.close()
    except Exception as e:  # graftlint: allow=SDL003 reason=reported below, in the main thread
        note(e)
    finally:
        threading.excepthook = hook
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(checked=lockcheck.enabled(), requests=served[0],
                errors=errors, lock_order_errors=lock_errors,
                stream_commits=int(summary.get("chunks_scored", 0)),
                order_graph=lockcheck.order_graph())


_LOCKCHECK_CHILD = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from sparkdl_tpu_torch.ops import sepconv
sepconv.load_all()
out = chip_smoke.lockcheck_workload()
out["modules"] = sorted(m for m in ("jax", "sparkdl_tpu") if m in sys.modules)
print(json.dumps(out))
"""


def _audit_inputs(g, spec_args):
    """Card tensors of the meta arguments' shapes and dtypes: seeded
    normal floats (bf16 operands scaled down), zero int32 indices."""
    def make(t):
        if t.dtype == torch.int32:
            return torch.zeros(t.shape, dtype=t.dtype, device="cuda")
        x = torch.randn(t.shape, device="cuda", generator=g)
        return (x / 4).to(t.dtype)
    if isinstance(spec_args, dict):
        return {k: make(v) for k, v in spec_args.items()}
    return make(spec_args)


def phase_audit(sepconv):
    """[audit]: the program audit (``sparkdl_tpu_torch.analysis``) on the
    card, under the card's torch.

      1. re-audit: :func:`audit_subset` built on the meta device and
         diffed against the committed ``PROGRAMS_TORCH.lock.json``: zero
         findings, zero drift (a fingerprint that moved between the
         lockfile's torch and this one fails);
      2. launches against the lockfile: ``Server("Xception",
         featurize=True, max_batch_size=32)`` with the zoo's bf16 compute
         dtype (the lockfile's programs), seeded weights at 299x299; each
         bucket's capture (8/16/32) holds the record's ``kernels`` (B1 30,
         B3 0, B2 0) as its own launches, each replay the record's output
         shape and dtype; the three kernel programs and the H1 heads
         program at their recorded shapes, their launches and outputs the
         records', each record's FLOPs beside the bound ``chip_smoke``
         computes from the same shared function;
      3. the consumers: ``lockfile_model_fingerprint("Xception")`` pinned;
         a ``Fleet`` promote of a weight-identical version keeps the result
         cache (the hits after it); the default ``CostLedger`` charges the
         record's ``flops_per_row`` a served row; a fresh compile-cache
         directory's manifest holds the lockfile's program count, and a
         copy of the lockfile with one tampered record gives
         ``compile.invalidate`` with a GC code;
      4. lock order: a child process under ``SPARKDL_LOCKCHECK=1`` runs
         :func:`lockcheck_workload` around the zoo Xception: no
         ``LockOrderError``; the order graph's edges printed.
    """
    import tempfile

    from sparkdl_tpu_torch.analysis.program import (DEFAULT_LOCKFILE,
                                                    audit_inventory,
                                                    diff_records,
                                                    read_lockfile)
    from sparkdl_tpu_torch.analysis.program.lockfile import write_lockfile
    from sparkdl_tpu_torch.obs import flight as oflight
    from sparkdl_tpu_torch.obs.cost import CostLedger
    from sparkdl_tpu_torch.ops import head as hops
    from sparkdl_tpu_torch.parallel import compile_cache
    from sparkdl_tpu_torch.serving import Fleet, InferenceCache, Server
    from sparkdl_tpu_torch.serving.cache import lockfile_model_fingerprint

    tag = "audit"
    t_phase = time.perf_counter()
    out = {}
    committed = read_lockfile(DEFAULT_LOCKFILE)
    programs = committed["programs"]
    locked_torch = committed["meta"].get("torch_version")

    # 1. re-audit under the card's torch
    t0 = time.perf_counter()
    specs = audit_subset()
    records, findings = audit_inventory(specs)
    drift = diff_records(committed, records, subset=True)
    audit_s = time.perf_counter() - t0
    check(not findings and not drift,
          f"[{tag}] re-audit under torch {torch.__version__} (lockfile "
          f"written under {locked_torch}): "
          + "; ".join(f.render() for f in findings + drift))
    print(f"[{tag}] re-audit of {len(records)} programs under torch "
          f"{torch.__version__} (lockfile written under torch "
          f"{locked_torch}): 0 findings, 0 drift against "
          f"PROGRAMS_TORCH.lock.json ({len(programs)} programs) in "
          f"{audit_s:.2f}s", flush=True)
    out.update(programs_audited=len(records), audit_s=audit_s,
               torch_lockfile=locked_torch, torch_card=torch.__version__)

    # 2a. every Xception bucket's capture against its record
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.models import get_model_spec

    zoo = {b: programs[f"zoo/Xception/featurize/bfloat16/b{b}"]
           for b in (8, 16, 32)}
    size = get_model_spec("Xception").input_size[0]
    df = synthetic_frame(32, size, SEED + 201)
    images, ok = arrowStructsToBatch(df.table.column("image"), size, size)
    check(ok.all(), f"[{tag}] synthetic images failed to decode")
    os.environ["SPARKDL_ZOO_COMPUTE_DTYPE"] = "bfloat16"
    try:
        srv = Server("Xception", featurize=True, max_batch_size=32,
                     cache=False)
    finally:
        os.environ.pop("SPARKDL_ZOO_COMPUTE_DTYPE", None)
    try:
        check(srv.device.type == "cuda", f"[{tag}] server not on the card")
        srv.warmup(images[0])
        buckets = {}
        for b, rec in zoo.items():
            eng = srv._engine_for(b)
            eng.run_padded(eng._pad(images[:b]))   # captures the bucket
            graph = eng.bucket_graph()
            check(graph is not None, f"[{tag}] bucket {b}: no captured graph")
            want = tuple(rec["kernels"][k] for k in ("B1", "B3", "B2"))
            reset_counts(sepconv)
            y = eng.run_padded(eng._pad(images[:b]))
            torch.cuda.synchronize()
            replay = read_counts(sepconv)
            got_out = [list(graph.static_out.shape),
                       str(graph.static_out.dtype).replace("torch.", "")]
            check(tuple(graph.launches) == want
                  and (replay["sepconv"], replay["sepconv_tiled"],
                       replay["mbconv"]) == want
                  and [got_out] == rec["out_avals"]
                  and torch.isfinite(torch.as_tensor(y).float()).all().item(),
                  f"[{tag}] bucket {b}: capture launches "
                  f"{graph.launches}, replay "
                  f"{replay}, output {got_out}; the record: kernels {want}, "
                  f"out_avals {rec['out_avals']}")
            buckets[b] = dict(launches=list(graph.launches), out=got_out,
                              flops_per_row=rec["flops_per_row"])
        print(f"[{tag}] Xception bf16 buckets 8/16/32: each capture's own "
              f"launches (B1, B3, B2) = the record's kernels "
              f"{tuple(zoo[8]['kernels'][k] for k in ('B1', 'B3', 'B2'))}, "
              f"each replay the record's output "
              f"{[buckets[b]['out'] for b in (8, 16, 32)]}; "
              f"{zoo[32]['flops_per_row'] / 1e9:.3f} GFLOP a row",
              flush=True)
        out["buckets"] = buckets
    finally:
        srv.close()

    # 2b. the kernel programs and the H1 heads program at their shapes
    from sparkdl_tpu_torch.analysis.program.inventory import (
        headfanout_dispatch_specs, sepconv_kernel_specs)

    def launch_counts():
        return dict(read_counts(sepconv), head_pass=hops.head_pass.launches)

    g = torch.Generator(device="cuda").manual_seed(SEED + 202)
    kernels = {}
    for spec in sepconv_kernel_specs() + headfanout_dispatch_specs()[1:]:
        rec = programs[spec.name]
        fn, margs = spec.build()
        args = [_audit_inputs(g, a) for a in margs]
        before = launch_counts()
        y = fn(*args)
        torch.cuda.synchronize()
        after = launch_counts()
        got = {"B1": after["sepconv"] - before["sepconv"],
               "B3": after["sepconv_tiled"] - before["sepconv_tiled"],
               "B2": after["mbconv"] - before["mbconv"],
               "H1": after["head_pass"] - before["head_pass"]}
        got_out = [[list(y.shape), str(y.dtype).replace("torch.", "")]]
        check(got == rec["kernels"] and got_out == rec["out_avals"]
              and torch.isfinite(y.float()).all().item(),
              f"[{tag}] {spec.name}: launches {got}, output {got_out}; the "
              f"record: {rec['kernels']}, {rec['out_avals']}")
        kname = next(k for k, v in rec["kernels"].items() if v)
        x = args[0] if kname != "H1" else args[2]
        if kname == "H1":
            flops, nbytes = hops.head_pass_cost(
                x.shape[0], x.shape[1], args[0]["kernel"].shape[2],
                int(torch.unique(args[1]).numel()))
            b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
        else:
            cost = (sepconv.mbconv_cost if kname == "B2"
                    else sepconv.sepconv_cost)
            flops, nbytes = cost(*x.shape, args[2].shape[1])
            b_ms, b_by = bound(flops, nbytes)
        kernels[spec.name] = dict(kernel=kname, record_flops=rec["flops"],
                                  bound_flops=flops, bound_ms=b_ms,
                                  bound_by=b_by)
        print(f"[{tag}] {spec.name}: {kname} x1, output {got_out[0]} = the "
              f"record's; record {rec['flops'] / 1e9:.4f} GFLOP, bound's "
              f"{flops / 1e9:.4f} GFLOP -> {b_ms:.4f} ms ({b_by})",
              flush=True)
    out["kernels"] = kernels

    # 3. the consumers
    fp = lockfile_model_fingerprint("Xception")
    check(fp is not None, f"[{tag}] no lockfile fingerprint for Xception")
    fpr = zoo[8]["flops_per_row"]
    ledger = CostLedger()
    cache = InferenceCache()
    fleet = Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
                  cache=cache, cost=ledger)
    try:
        fleet.add_model("xc", "Xception", featurize=True,
                        warm_example=images[0])
        first = [fleet.predict("xc", images[i], tenant="t")
                 for i in range(AUDIT_FLEET_N)]
        snap = ledger.snapshot()
        charged = snap["tenants"]["t"]["flops"]
        check(list(snap["programs"]) == ["zoo/Xception/featurize/bfloat16/b8"]
              and abs(charged - AUDIT_FLEET_N * fpr) <= 1e-9 * charged,
              f"[{tag}] ledger charged {charged} FLOPs for "
              f"{AUDIT_FLEET_N} rows, the record {fpr} a row "
              f"({list(snap['programs'])})")
        from sparkdl_tpu_torch.transformers import named_image as ni

        fleet.add_version("xc", {k: t.clone() for k, t in
                                 ni._cached_model("Xception")
                                 .state_dict().items()})
        fleet.start_rollout("xc", canary_fraction=0.0,
                            warm_example=images[0])
        report = fleet.promote("xc")
        hits0 = cache.metrics.snapshot_raw()["counters"].get("cache.hits", 0)
        again = [fleet.predict("xc", images[i], tenant="t")
                 for i in range(AUDIT_FLEET_N)]
        hits = cache.metrics.snapshot_raw()["counters"].get(
            "cache.hits", 0) - hits0
        check(report["cache"]["survived"] is True and hits == AUDIT_FLEET_N
              and all(np.array_equal(a, b) for a, b in zip(first, again)),
              f"[{tag}] promote of the same weights: cache "
              f"{report['cache']}, {hits} hits after it")
    finally:
        fleet.close()
    print(f"[{tag}] consumers: Xception pinned (fingerprint {fp[:12]}...); "
          f"the default ledger charged {charged / AUDIT_FLEET_N / 1e9:.4f} "
          f"GFLOP a row (record {fpr / 1e9:.4f}); a promote of the same "
          f"weights kept the cache: {hits} hits of {AUDIT_FLEET_N} after "
          f"it", flush=True)
    out.update(fingerprint=fp, ledger_flops_per_row=charged / AUDIT_FLEET_N,
               promote_cache=report["cache"], hits_after_promote=hits)

    saved = compile_cache.state()
    rec_before = oflight._recorder
    tmp = tempfile.mkdtemp(prefix="audit_cc_")
    try:
        recorder = oflight.configure(enabled=True)
        st = compile_cache.configure(os.path.join(tmp, "cc"))
        check(st is not None and st["lockfile_programs"] == len(programs),
              f"[{tag}] fresh compile cache: {st and st['lockfile_programs']}"
              f" lockfile programs, the lockfile {len(programs)}")
        moved = json.loads(json.dumps(programs))
        name = "zoo/Xception/featurize/bfloat16/b8"
        moved[name]["flops"] *= 2
        lock2 = os.path.join(tmp, "PROGRAMS_TORCH.lock.json")
        write_lockfile([dict(r, name=n) for n, r in moved.items()], lock2,
                       meta=committed["meta"])
        st2 = compile_cache.configure(os.path.join(tmp, "cc"),
                                      lockfile_path=lock2)
        inval = [e for e in recorder.snapshot()
                 if e["event"] == "compile.invalidate"]
        check(st2 is not None and st2["invalidated"]
              and st2["drift_rules"] == ["GC004"] and inval,
              f"[{tag}] tampered lockfile: state {st2}, events {inval}")
    finally:
        compile_cache.configure(saved["dir"] if saved else None)
        oflight._recorder = rec_before
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[{tag}] compile cache: a fresh directory's manifest holds "
          f"{st['lockfile_programs']} lockfile programs; a copy with "
          f"{name}'s flops doubled: compile.invalidate, drift "
          f"{st2['drift_rules']}", flush=True)
    out.update(manifest_programs=st["lockfile_programs"],
               tampered_drift=st2["drift_rules"])

    # 4. the lock-order child
    env = dict(os.environ, SPARKDL_LOCKCHECK="1")
    for knob in ("SPARKDL_FAULTS", "SPARKDL_TRACE", "SPARKDL_BLACKBOX",
                 "SPARKDL_COMPILE_CACHE"):
        env.pop(knob, None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _LOCKCHECK_CHILD],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=env, capture_output=True, text=True,
                       timeout=LOCKCHECK_CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    check(r.returncode == 0 and lines,
          f"[{tag}] lock-order child failed (rc {r.returncode}): "
          f"{r.stderr[-3000:]}")
    lc = json.loads(lines[-1])
    edges = sorted(f"{a} -> {b}" for a, bs in lc["order_graph"].items()
                   for b in bs)
    check(lc["checked"] and not lc["lock_order_errors"] and not lc["errors"]
          and lc["requests"] > 0 and lc["stream_commits"] == LOCKCHECK_CHUNKS
          and not lc["modules"],
          f"[{tag}] lock-order child: {json.dumps(lc)[:3000]}")
    print(f"[{tag}] SPARKDL_LOCKCHECK=1 child: {lc['requests']} requests "
          f"from {LOCKCHECK_CLIENTS} clients through a fleet with a canary "
          f"and a promote, {lc['stream_commits']} stream commits, no "
          f"LockOrderError in {child_s:.1f}s; {len(edges)} order edges: "
          f"{', '.join(edges)}", flush=True)
    out.update(lockcheck_requests=lc["requests"], lockcheck_edges=edges,
               lockcheck_child_s=child_s,
               seconds=time.perf_counter() - t_phase)
    print(f"[{tag}] phase {out['seconds']:.1f}s", flush=True)
    return out


# The JAX package's days, computed on the CPU with JAX (the card has none):
#   JAX_PLATFORMS=cpu python -c "import json, jax;
#     jax.config.update('jax_platforms', 'cpu');
#     from sparkdl_tpu.serving import TenantQuota as Q;
#     from sparkdl_tpu import twin as t;
#     r = t.run_day(t.ScenarioConfig(), policy=t.QuotaAutoscaler(
#         t.DEFAULT_TENANT_QUOTA));
#     s = t.run_day(t.ScenarioConfig(**SMALL), policy=t.StaticPolicy(),
#         default_quota=Q(rate_per_s=0.15, burst=60));
#     print(json.dumps([r.event_digest, r.scores, s.event_digest,
#         s.scores]))"
# with SMALL = TWIN_SMALL below; tests/test_torch_twin.py re-derives both.
TWIN_DAY_DIGEST = ("5ad78f4e1844216f74ada6e984836ed1"
                   "19c3bee32164206e798921850db7e2ab")
TWIN_DAY_SCORES = {
    "cost_fairness": 0.159392, "slo_minutes": 70.0, "breach_ticks": 14,
    "goodput": 0.957162, "fairness": 0.999497, "cache_hit_rate": 0.985104,
    "offered": 159883, "submitted": 153802, "shed": 6849, "fault_drops": 0,
    "stream_commits": 48, "tenants_active": 64}
#: tests/test_twin.py's _small_cfg, under StaticPolicy and its tight quota
TWIN_SMALL = dict(seed=5, ticks=12, tenants=16, mean_arrivals_per_tick=60.0,
                  flash_start=4, flash_end=8, flash_tenants=4, canary_tick=2,
                  stream_every=5, digest_universe=64)
TWIN_SMALL_QUOTA = dict(rate_per_s=0.15, burst=60)
TWIN_SMALL_DIGEST = ("34afc254c4c15fc9fdfb557ffe5a34c0"
                     "40d197874a498455a304e8940018b1fd")
TWIN_SMALL_SCORES = {
    "cost_fairness": 0.322061, "slo_minutes": 40.0, "breach_ticks": 8,
    "goodput": 0.155441, "fairness": 0.843311, "cache_hit_rate": 0.86087,
    "offered": 9309, "submitted": 1495, "shed": 7862, "fault_drops": 0,
    "stream_commits": 3, "tenants_active": 16}


def phase_twin(sepconv):
    """[twin]: the traffic twin (``sparkdl_tpu_torch.twin``) on the card:
    the canonical day (``ScenarioConfig()``: 288 ticks of 300 virtual s, 64
    tenants, the flash crowd, the canary at tick 60, the stream every 6
    ticks) under ``QuotaAutoscaler(DEFAULT_TENANT_QUOTA)``, its event
    digest and scores equal to the JAX package's canonical day
    (``TWIN_DAY_DIGEST``); then the small day of ``tests/test_twin.py``
    twice, byte-identical to each other and to JAX's
    (``TWIN_SMALL_DIGEST``).  Every fleet server's engines on the card;
    the day's model is the JAX twin's dense layer, so none of the kernels
    runs (counted).  Prints the day's wall seconds, virtual requests a
    wall second, dispatches, captures and pool bytes per server, and
    ``slo_minutes``, ``goodput`` and ``fairness``."""
    from sparkdl_tpu_torch import twin
    from sparkdl_tpu_torch.serving import TenantQuota

    tag = "twin"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    problems = []

    def expect(cond, msg):
        if not cond:
            problems.append(msg)
            print(f"[{tag}] PROBLEM: {msg}", flush=True)

    out = dict(card=card)
    reset_counts(sepconv)
    t0 = time.perf_counter()
    day = twin.run_day(twin.ScenarioConfig(), policy=twin.QuotaAutoscaler(
        twin.DEFAULT_TENANT_QUOTA))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = read_counts(sepconv)
    s = day.scores
    rate = s["offered"] / wall
    print(f"[{tag}] canonical day on {day.device} ({card}): {wall:.2f}s "
          f"wall, {s['offered']} virtual requests ({rate:.0f} a wall "
          f"second), {len(day.event_lines)} ticks; slo_minutes "
          f"{s['slo_minutes']}, goodput {s['goodput']}, fairness "
          f"{s['fairness']}, cost fairness {s['cost_fairness']}, cache hit "
          f"rate {s['cache_hit_rate']}; digest {day.event_digest[:16]}",
          flush=True)
    for srv in day.servers:
        print(f"[{tag}]   server {srv['model']} v{srv['version']} on "
              f"{srv['device']}: {srv['dispatches']} dispatches, "
              f"{srv['captures']} graph captures, pool "
              f"{srv['pool_bytes'] / 2**20:.1f} MiB", flush=True)
    expect(day.event_digest == TWIN_DAY_DIGEST,
           f"canonical day digest {day.event_digest}, JAX's "
           f"{TWIN_DAY_DIGEST}")
    expect(s == TWIN_DAY_SCORES,
           f"canonical day scores {s}, JAX's {TWIN_DAY_SCORES}")
    expect(day.device.startswith("cuda") and len(day.servers) == 4
           and all(srv["device"].startswith("cuda")
                   and srv["dispatches"] > 0 and srv["captures"] > 0
                   for srv in day.servers),
           f"servers not on the card or idle: {day.device}, {day.servers}")
    expect(counts == dict(sepconv=0, sepconv_tiled=0, mbconv=0),
           f"kernel launches in the twin's day {counts}, want none")
    out["day"] = dict(wall_s=wall, requests_per_wall_s=rate,
                      event_digest=day.event_digest, scores=s,
                      device=day.device, servers=day.servers,
                      placement_digest=day.placement["digest"])
    smalls = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = twin.run_day(twin.ScenarioConfig(**TWIN_SMALL),
                         policy=twin.StaticPolicy(),
                         default_quota=TenantQuota(**TWIN_SMALL_QUOTA))
        smalls.append((r, time.perf_counter() - t0))
    (r1, w1), (r2, w2) = smalls
    print(f"[{tag}] small day twice on {r1.device}: {w1:.2f}s and "
          f"{w2:.2f}s wall; byte-identical {r1.event_lines == r2.event_lines}"
          f", digest {r1.event_digest[:16]} (JAX {TWIN_SMALL_DIGEST[:16]})",
          flush=True)
    expect(r1.event_lines == r2.event_lines and r1.scores == r2.scores
           and r1.event_digest == r2.event_digest == TWIN_SMALL_DIGEST
           and r1.scores == TWIN_SMALL_SCORES,
           f"small days: digests {r1.event_digest} {r2.event_digest}, JAX's "
           f"{TWIN_SMALL_DIGEST}; scores {r1.scores}")
    expect(all(srv["device"].startswith("cuda") for r in (r1, r2)
               for srv in r.servers), "small-day servers not on the card")
    out["small"] = dict(wall_s=[w1, w2], event_digest=r1.event_digest,
                        scores=r1.scores, servers=r1.servers)
    check(not problems, f"[{tag}] {len(problems)} failed: "
                        + " | ".join(problems))
    out["launches"] = counts
    return out


EXAMPLES_PER_CLASS = 32         # tinted JPEGs of each RECIPE_BASES class
EXAMPLES_NOISE = 50.0           # per-pixel N(0, noise^2) around the base
EXAMPLES_CHILD_TIMEOUT_S = 300  # an example's or a tool's time limit
EXAMPLES_NATIVE_IMAGES = 16     # the thread-scaling tool's small corpus
EXAMPLES_RANKS = 2              # port_dryrun's ranks[W]
EXAMPLES_FLEET_CHAIN = ["rollout.start", "breaker.open", "fleet.shed",
                        "rollout.promote"]


def _flowers_tree(root):
    """A ``<root>/<class>/*.jpg`` tree: EXAMPLES_PER_CLASS JPEGs of each
    RECIPE_BASES colour (sides 300-400, clip(base + N(0, noise^2)) per
    pixel, written as ``_tuning_files`` writes its JPEGs), one directory a
    class."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 131)
    for k, base in enumerate(RECIPE_BASES):
        cdir = os.path.join(root, f"class_{k}")
        os.makedirs(cdir)
        for i in range(EXAMPLES_PER_CLASS):
            h, w = (int(v) for v in rng.integers(300, 400, 2))
            img = np.clip(np.asarray(base, np.float32)
                          + rng.normal(0, EXAMPLES_NOISE, (h, w, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(cdir, f"img_{i:03d}.jpg"), quality=90)
    return len(RECIPE_BASES) * EXAMPLES_PER_CLASS


def _children(tag, jobs):
    """Start every ``python argv`` of ``jobs`` (name -> argv) at once from
    the checkout's root and wait for all of them; fails the run if one
    outlasts EXAMPLES_CHILD_TIMEOUT_S, after stopping every one still
    running.  Returns name -> (exit code, stdout, stderr, wall s from the
    common start to that child's exit)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, *argv], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, argv in jobs.items()}
    done = {}

    def wait(name, proc):
        so, se = proc.communicate()
        done[name] = (proc.returncode, so, se, time.perf_counter() - t0)

    waiters = [threading.Thread(target=wait, args=item)
               for item in procs.items()]
    for w in waiters:
        w.start()
    try:
        for w in waiters:
            w.join(timeout=max(0.0, EXAMPLES_CHILD_TIMEOUT_S
                               - (time.perf_counter() - t0)))
        late = sorted(set(jobs) - set(done))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        for w in waiters:
            w.join()
    check(not late, f"[{tag}] {late} ran past {EXAMPLES_CHILD_TIMEOUT_S}s")
    return done


def _in_order(chain, names):
    """Whether ``names`` occur in ``chain`` in that order (not
    necessarily next to each other)."""
    it = iter(chain)
    return all(any(c == n for c in it) for n in names)


def phase_examples(sepconv, keep):
    """[examples]: the port's examples and artifact tools on the card.

      1. ``examples/port_flowers_top1.py`` in this process (its ``main``),
         ``--model Xception --batch-size 32``: the zoo Xception at 299x299
         (seeded weights, full width and depth) in bf16 compute over a
         tree of 5 RECIPE_BASES classes x 32 tinted JPEGs, the LR head on
         the seeded split; B1 counted (30 a forward: each dispatch and the
         capture's eager warm-up), top-1 above chance (1/5), img/s of the
         featurize;
      2. the other three examples as child processes on the card, each
         exiting 0 with its marker line;
      3. the tools as child processes, started together with the three
         examples (the thread-scaling tool after them, alone, since it
         times the host): ``port_trace_summary`` over the span
         JSONL and the Chrome trace of [obs]' ``SPARKDL_TRACE`` child and
         over [fleet]'s traced spans; ``port_blackbox`` over [obs]'
         SIGTERM dump, over [fleet]'s dump with its spans (the incident's
         ``rollout.start``, ``breaker.open``, ``fleet.shed`` and
         ``rollout.promote`` in order) and over [stream]'s dump with its
         resumed journal, each exit 0 (clean); ``port_dryrun`` with
         ``ranks[2]``; ``port_capture_profile Xception`` (B1 30 in the
         counted forward's trace); ``port_native_thread_scaling`` on 16
         JPEGs.

    ``keep`` holds the artifacts of [obs] (``obs/``), [fleet] (``fleet/``)
    and [stream] (``stream/``); it is deleted at the end."""
    import importlib.util
    import shutil
    import tempfile

    tag = "examples"
    t_phase = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(card=card, seconds={})
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="examples_smoke_")
    try:
        # 1. the flowers recipe on Xception, in this process
        tree = os.path.join(tmp, "flowers")
        n_files = _flowers_tree(tree)
        spec = importlib.util.spec_from_file_location(
            "port_flowers_top1",
            os.path.join(root, "examples", "port_flowers_top1.py"))
        flowers = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(flowers)
        reset_counts(sepconv)
        t0 = time.perf_counter()
        res = flowers.main([tree, "--model", "Xception", "--batch-size",
                            str(BATCH), "--seed", str(SEED)])
        torch.cuda.synchronize()
        out["seconds"]["port_flowers_top1"] = time.perf_counter() - t0
        counts = read_counts(sepconv)
        forwards = res["dispatches"] + res["graph_captures"]
        want = dict(sepconv=SEPCONV_PER_FORWARD * forwards, sepconv_tiled=0,
                    mbconv=0)
        print(f"[{tag}] ({card}) port_flowers_top1 Xception 299x299 batch "
              f"{BATCH}, bf16 compute: {n_files} JPEGs of "
              f"{len(RECIPE_BASES)} classes featurized in "
              f"{res['featurize_s']:.3f}s = {res['featurize_img_s']:.1f} "
              f"img/s (decode included); top-1 {res['top1']} on "
              f"{res['n_test']} held out (chance {1 / len(RECIPE_BASES)}); "
              f"{res['dispatches']} dispatches + {res['graph_captures']} "
              f"capture(s): launches {counts}; {res['weights_source']}",
              flush=True)
        check(res["device"].startswith("cuda") and res["model"] == "Xception"
              and res["classes"] == len(RECIPE_BASES)
              and res["n_train"] + res["n_test"] == n_files,
              f"[{tag}] port_flowers_top1: {res}")
        check(counts == want, f"[{tag}] port_flowers_top1 launches {counts}, "
                              f"want {want} ({forwards} forwards)")
        check(res["top1"] > 1 / len(RECIPE_BASES),
              f"[{tag}] port_flowers_top1 top-1 {res['top1']} not above "
              f"chance")
        out["flowers"] = dict(res, launches=counts["sepconv"],
                              forwards=forwards)

        # 2. and 3. the other three examples and the tools, as child
        # processes started together (one at a time they took 190 s, most
        # of it each child's start-up); then the thread-scaling tool alone
        trace_dir = os.path.join(keep, "obs", "trace")
        folds = {
            "obs spans": next(os.path.join(trace_dir, f)
                              for f in sorted(os.listdir(trace_dir))
                              if f.startswith("spans_")),
            "obs chrome": next(os.path.join(trace_dir, f)
                               for f in sorted(os.listdir(trace_dir))
                               if f.startswith("trace_")),
            "fleet spans": os.path.join(keep, "fleet", "spans.jsonl")}
        boxes = {
            "obs": [os.path.join(keep, "obs", "flight")],
            "fleet": [os.path.join(keep, "fleet", "flight.jsonl"),
                      "--spans", os.path.join(keep, "fleet", "spans.jsonl")],
            "stream": [os.path.join(keep, "stream", "flight.jsonl"),
                       "--journal",
                       os.path.join(keep, "stream", "journal.jsonl")]}
        examples = {
            "port_migrate_from_sparkdl": '{"migration_smoke": "ok"}',
            "port_serving_quickstart": '"serving_quickstart": "ok"',
            "port_distributed_fit": '"distributed_fit": "ok"'}
        artifact = os.path.join(tmp, "dryrun_lines.jsonl")
        jobs = {name: [os.path.join("examples", name + ".py")]
                for name in examples}
        jobs.update({f"port_trace_summary {what}": [
            os.path.join("tools", "port_trace_summary.py"), path]
            for what, path in folds.items()})
        jobs.update({f"port_blackbox {what}": [
            os.path.join("tools", "port_blackbox.py"), *args, "--json"]
            for what, args in boxes.items()})
        jobs["port_dryrun"] = [os.path.join("tools", "port_dryrun.py"),
                               "--ranks", str(EXAMPLES_RANKS),
                               "--artifact", artifact]
        jobs["port_capture_profile"] = [
            os.path.join("tools", "port_capture_profile.py"), "Xception",
            os.path.join(tmp, "profile"), str(BATCH)]
        t0 = time.perf_counter()
        done = _children(tag, jobs)
        out["children_s"] = time.perf_counter() - t0
        done.update(_children(tag, {"port_native_thread_scaling": [
            os.path.join("tools", "port_native_thread_scaling.py"),
            "--images", str(EXAMPLES_NATIVE_IMAGES)]}))
        for name, (_, _, _, sec) in done.items():
            out["seconds"][name] = sec
        print(f"[{tag}] ({card}) {len(jobs)} child processes started "
              f"together, all done in {out['children_s']:.1f}s; then "
              f"port_native_thread_scaling alone", flush=True)

        for name, marker in examples.items():
            rc, so, se, sec = done[name]
            line = so.strip().splitlines()[-1] if so.strip() else ""
            print(f"[{tag}] ({card}) {name}: exit {rc}, {sec:.1f}s; {line}",
                  flush=True)
            check(rc == 0 and marker in so,
                  f"[{tag}] {name} exited {rc}: {se[-2000:]}")
        out["distributed_fit"] = json.loads(
            done["port_distributed_fit"][1].strip().splitlines()[-1])

        out["trace_summary"] = {}
        for what in folds:
            rc, so, se, sec = done[f"port_trace_summary {what}"]
            rows = [ln for ln in so.splitlines() if ln.startswith("| ")][1:]
            out["trace_summary"][what] = dict(rc=rc, rows=len(rows))
            print(f"[{tag}] port_trace_summary {what}: exit {rc}, "
                  f"{len(rows)} stage rows, {sec:.1f}s", flush=True)
            check(rc == 0 and rows, f"[{tag}] port_trace_summary {what} "
                                    f"exited {rc}: {se[-2000:]}")
        out["blackbox"] = {}
        for what in boxes:
            rc, so, se, sec = done[f"port_blackbox {what}"]
            doc = json.loads(so) if rc in (0, 1) else {}
            out["blackbox"][what] = dict(
                rc=rc, events=len(doc.get("events", ())),
                correlated=doc.get("correlated_events"),
                journal=doc.get("journal", {}).get("committed"))
            print(f"[{tag}] port_blackbox {what}: exit {rc}, "
                  f"{len(doc.get('events', ()))} events in the timeline "
                  f"({doc.get('correlated_events')} trace-correlated), "
                  f"health {doc.get('health')}, verdict "
                  f"{doc.get('verdict')}, {sec:.1f}s", flush=True)
            check(rc == 0 and doc.get("events"),
                  f"[{tag}] port_blackbox {what} exited {rc}: {se[-2000:]}")
            if what == "fleet":
                check(_in_order(doc["chain"], EXAMPLES_FLEET_CHAIN),
                      f"[{tag}] [fleet]'s timeline lacks "
                      f"{EXAMPLES_FLEET_CHAIN} in order: {doc['chain']}")
            if what == "stream":
                check(doc["journal"]["committed"] == STREAM_CHUNKS
                      and not doc["journal"]["uncommitted"],
                      f"[{tag}] [stream]'s journal: {doc['journal']}")

        from sparkdl_tpu_torch.utils.jsonl import read_jsonl

        rc, so, se, sec = done["port_dryrun"]
        recs, _ = read_jsonl(artifact)
        stages = [(r["stage"], r["status"]) for r in recs]
        ranks = next((r for r in recs if r["status"] == "ok"
                      and r["stage"].startswith("ranks[")), {})
        out["dryrun"] = dict(rc=rc, stages=stages, ranks=ranks)
        print(f"[{tag}] port_dryrun ranks[{EXAMPLES_RANKS}]: exit {rc}, "
              f"{sec:.1f}s; stages {stages}; ranks {ranks}", flush=True)
        check(rc == 0 and stages == [
            ("entry", "started"), ("entry", "ok"),
            (f"ranks[{EXAMPLES_RANKS}]", "started"),
            (f"ranks[{EXAMPLES_RANKS}]", "ok"), ("summary", "ok")]
            and all(d.startswith("cuda") for d in ranks["devices"]),
            f"[{tag}] port_dryrun exited {rc}: {se[-2000:]}")

        rc, so, se, sec = done["port_capture_profile"]
        prof = json.loads(so.strip().splitlines()[-1]) if rc == 0 else {}
        b1 = sum(n for k, n in prof.get("kernels_by_name", {}).items()
                 if "sepconv_kernel" in k)
        out["capture_profile"] = dict(
            rc=rc, kernels=prof.get("kernels"), b1=b1,
            in_trace_wall_s=prof.get("in_trace_wall_s"))
        print(f"[{tag}] ({card}) port_capture_profile Xception batch "
              f"{BATCH} bf16: exit {rc}, {sec:.1f}s; the counted forward "
              f"{prof.get('in_trace_wall_s')}s in the trace, "
              f"{prof.get('kernels')} kernels, B1 {b1}", flush=True)
        check(rc == 0 and b1 == SEPCONV_PER_FORWARD
              and os.path.exists(prof["trace"]),
              f"[{tag}] port_capture_profile: exit {rc}, B1 {b1}: "
              f"{se[-2000:]}")

        rc, so, se, sec = done["port_native_thread_scaling"]
        lines = [json.loads(ln) for ln in so.splitlines()
                 if ln.startswith("{")]
        out["native_thread_scaling"] = lines
        print(f"[{tag}] port_native_thread_scaling {EXAMPLES_NATIVE_IMAGES} "
              f"JPEGs: exit {rc}, {sec:.1f}s; {lines}", flush=True)
        check(rc == 0 and any(ln.get("backend") == "pil" for ln in lines)
              and any(ln.get("backend") == "native" for ln in lines),
              f"[{tag}] port_native_thread_scaling exited {rc}: "
              f"{se[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(keep, ignore_errors=True)
    out["launches"] = dict(sepconv=out["flowers"]["launches"])
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{tag}] ({card}) phase {out['phase_s']:.1f}s", flush=True)
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
    if torch.cuda.device_count() > 1:
        # every phase runs on one card, as it did, save [mesh]'s layouts,
        # which name their slots, and its (f), which unpins
        sparkdl_tpu_torch.set_default_device("cuda:0")
    for knob in ("SPARKDL_MNV2_FUSED", "SPARKDL_XC_TILED", "SPARKDL_S2D_STEM",
                 "SPARKDL_FUSED_HEADS", "SPARKDL_ZOO_COMPUTE_DTYPE",
                 "SPARKDL_RN_FUSED_SHORTCUT", "SPARKDL_WEIGHTS_DIR"):
        os.environ.pop(knob, None)
    phase_build(sepconv)
    compiled = phase_compile(sepconv)
    print(json.dumps({"compile": compiled}), flush=True)
    audit = phase_audit(sepconv)
    audit_pool = pool_line("[audit]")
    print(json.dumps({"audit": audit}), flush=True)
    b1 = phase_sepconv_kernel(sepconv, tiled=False)
    b1["max_abs_err"] = max(b1["max_abs_err"], phase_sepconv_ragged(sepconv))
    b3 = phase_sepconv_kernel(sepconv, tiled=True)
    b3["max_abs_err"] = max(b3["max_abs_err"],
                            phase_sepconv_tiled_ragged(sepconv))
    b2 = phase_mbconv_kernel(sepconv)
    b2["max_abs_err"] = max(b2["max_abs_err"], phase_mbconv_ragged(sepconv))
    h1 = phase_head_kernel()
    pools = {"audit": audit_pool}
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
    h1["bf16"]["launches"] = fanout["bf16"]["launches"]["head_pass"]
    b1["headfanout_launches"] = fanout["launches"]["sepconv"]
    import tempfile

    # [obs], [fleet] and [stream] leave their dumps here for [examples]
    keep = tempfile.mkdtemp(prefix="smoke_artifacts_")
    for sub in ("obs", "fleet", "stream"):
        os.makedirs(os.path.join(keep, sub))
    obs = phase_obs(sepconv, os.path.join(keep, "obs"))
    pools["obs"] = pool_line("[obs]")
    print(json.dumps({"obs": obs}), flush=True)
    b1["obs_launches"] = obs["launches"]["sepconv"]
    h1["obs_launches"] = obs["launches"]["head_pass"]
    fleet = phase_fleet(sepconv, os.path.join(keep, "fleet"))
    pools["fleet"] = pool_line("[fleet]")
    print(json.dumps({"fleet": fleet}), flush=True)
    b1["fleet_launches"] = fleet["launches"]["sepconv"]
    h1["fleet_launches"] = fleet["launches"]["head_pass"]
    stream = phase_stream(sepconv, os.path.join(keep, "stream"))
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
    split_refs = {}
    train_mesh = phase_train_mesh(sepconv, split_refs)
    pools["train_mesh"] = pool_line("[train_mesh]")
    print(json.dumps({"train_mesh": train_mesh}), flush=True)
    b1["train_mesh_launches"] = train_mesh["launches"]["sepconv"]
    train_ranks = phase_train_ranks(sepconv, split_refs)
    del split_refs
    pools["train_ranks"] = pool_line("[train_ranks]")
    print(json.dumps({"train_ranks": train_ranks}), flush=True)
    b1["train_ranks_launches"] = train_ranks["launches"]["sepconv"]
    model_ranks = phase_model_ranks(sepconv)
    pools["model_ranks"] = pool_line("[model_ranks]")
    print(json.dumps({"model_ranks": model_ranks}), flush=True)
    b1["model_ranks_launches"] = model_ranks["launches"]["sepconv"]
    twin_day = phase_twin(sepconv)
    pools["twin"] = pool_line("[twin]")
    print(json.dumps({"twin": twin_day}), flush=True)
    examples = phase_examples(sepconv, keep)
    pools["examples"] = pool_line("[examples]")
    print(json.dumps({"examples": examples}), flush=True)
    b1["examples_launches"] = examples["launches"]["sepconv"]
    b1["compile_launches"] = compiled["launches"]["sepconv"]
    print(json.dumps({"pools": pools}), flush=True)
    print(json.dumps({"kernels": [b1, b3, b2, h1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
