#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``znicz_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

It imports neither ``jax`` nor ``znicz_tpu``.  Phases, each fatal on
failure (the script then exits non-zero and prints no result line):

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds every kernel of the port from
   ``znicz_tpu_torch/csrc``, one process per source, all at once, and
   ptxas's registers, shared memory and spills of each instantiation
   are printed;
3. kernels — the forward kernel against its plain PyTorch version on
   the card at the shapes the serving path gives it (AlexNet's three
   max pools at batch 64: f32, and max_pool1 in bf16 and f16), at the
   MNIST conv sample's two pools (minibatch 60) and STL-10's pool1
   (50, 96, 96, 32) in f32 and f64 (STL-10's also through the unstaged
   instantiation, random and tied), on a
   global 128x128 pool whose window no shared memory holds (the
   unstaged instantiation), on small edge-overhanging geometries in
   f32, bf16, f16 and f64, on the kernel's tile edges (output rows not
   a multiple of a tile's, channels not a multiple of a slab's, the
   MNIST pool's 87 channels) in f32, bf16 and f64, and on storage that
   is not 16-byte aligned, with forced ties, values and offsets
   BIT-equal (82 cases, max and maxabs); each case prints the vector
   width it launched at, and AlexNet's and MNIST's pool1 shapes must
   take 16-byte vectors, 87 channels and unaligned storage one
   channel.  Then kernel, plain version and ``F.max_pool2d`` (the
   library yardstick, never called by the port) timed with CUDA events
   after an L2 flush and a device spin that keeps the host's enqueue
   out of the window (median of 50 samples, 200 where the bound is
   under 10 us; a sample the host stalled past the spin is taken
   again), beside the bound from bytes at 3.35 TB/s and the host's own
   time per call; an empty launch gives the method's floor,
   and the kernel is also timed at tile budgets of 16, 24, 32 and 64
   KB;
4. backward kernel — the max-pool backward kernel against its plain
   version on the same cases (offsets from the forward kernel, a
   random gradient), then on its own tile edges in f32, f16, bf16 and
   f64 (windows staged by two tiles, column tiles, the MNIST pool at
   one channel a thread, runtime strides in row and column tiles,
   cells no window covers, a gradient off a 16-byte boundary) and on
   96x96 windows at stride 1 that no shared memory holds, BIT-equal,
   zero cells included (144 cases); both staged instantiations (stride
   2, runtime stride) at both widths and the unstaged one at 16-byte
   vectors must be among the cases, and each one's count is printed;
5. serve — a full-width AlexNet package (227x227x3, 1000 classes,
   random weights from a seed) served over HTTP by ``ServingServer``
   with every bucket up to 64 warmed; batches of 1, 3, 17 and 64 rows
   in JSON and ``.npy`` must all answer 200 with softmax rows, every
   dispatch must launch the pooling kernel exactly 3 times, and rows
   0, 1, 2, 16 and 63 of every reply (the first rows and the last row
   of each size) must match the port's plain forward run on the CPU
   within 1e-4 in log-probability, i.e. 1e-4 relative on every
   probability (float32, TF32 off on the card); the same rows run with
   TF32 let in, and both sides against the CPU's forward in float64,
   are printed beside.  The same batch, dispatched 5 times at each
   reply size, must give the same bits at every max pool and at the
   softmax, and those of ``engine.predict``; the same forward with
   ``cudnn.deterministic`` is printed beside as a witness of cuDNN's
   choice of algorithm.  Then images/s over 20 back-to-back batch-64
   engine dispatches, request latency p50/p99, and a per-layer
   device-time breakdown, whose pool layers give each pool's in-model
   (warm-L2) time;
6. workflow — full-width AlexNet trained by the workflow CLI,
   ``python -m znicz_tpu_torch alexnet --fused pool_impl=offsets`` at
   batch 128 over 2,048 TRAIN and 256 VALID prototype images for 3
   epochs, run in this process (``__main__.main``) in f32 with TF32 off
   and ``cudnn.deterministic``, snapshots under ``build/`` (deleted
   after).  Each epoch must evaluate 2,048 TRAIN and 256 VALID rows
   with finite stats within their segments; the kernels must launch 3
   times forward a train step and a VALID minibatch and 3 times
   backward a step, all at 16-byte vectors, with no plain pooling on
   the card; and each TRAIN segment must read the device back once
   (counted here by swapping ``torch.Tensor``'s reading methods; the
   synchronizing operations of PyTorch's sync debug mode are printed
   beside).  The run's windows (``FusedNet.run_window_indexed``,
   recorded by a wrapper) are replayed on a fresh ``FusedNet`` from the
   run's initial state: each epoch's TRAIN stats, the VALID n_err of
   ``predict_with_idx`` over the VALID rows, and the final parameters
   and optimizer state must equal the run's bit for bit.  Then the CLI
   resumes the newest snapshot of an epoch before the last
   (``--snapshot``; the snapshotter writes after the epochs that
   improved) and must end bit-equal to the uninterrupted run.  Prints
   each epoch's TRAIN images/s and the host's wall time per window;
7. resilience — the workflow phase's command under the supervised
   launcher (``--max-restarts 2 --restart-backoff-ms 0``) with
   mid-epoch snapshots (``alexnet.snapshotter.window_interval=1``)
   and a ``fused.dispatch`` crash injected at the 4th TRAIN window
   (epoch 2's last, after its mid-epoch snapshot), from the prng
   streams the workflow phase's run started from: exactly 1 fault, 1
   restart, which restores epoch 2's ``midepoch`` snapshot; each
   epoch's TRAIN n_err, confusion and max_err_sum, the VALID n_err and
   the final parameters, optimizer state and dropout generator state
   bit-equal to the workflow phase's run; the restart's run launches
   both kernels (84 forward, 72 backward), all 16-byte, no plain
   pooling; each TRAIN segment reads the card back twice (its
   readback and a mid-epoch snapshot's accumulator drain); once the
   supervised run returned, ``torch.cuda.memory_allocated`` within 64
   MB of its value before the phase.  Prints the crash-to-resume
   seconds and each snapshot's.  Two more checks run on the objects
   of other phases: in the train phase, on its batch-128 ``FusedNet``,
   4 steps each checked by the health monitor (interval 1, ``halt``),
   clean with one readback a check and sums of squares within 1e-6 of
   a CPU f64 recompute, ``FusedNNRollback`` storing the state on the
   card and restoring it bit for bit after 2 steps, and a NaN weight
   halting its step with a crash report under ``build/`` and no
   restart; in the serve phase, its engine under ``serving.forward``
   I/O faults every 3rd invocation: 6 batch-64 replies bit-equal to a
   dispatch without faults, 2 retries, the breaker closed, 3 forward
   launches a dispatch;
8. alexnet_units — full-width AlexNet trained by the workflow CLI
   through the unit graph, ``python -m znicz_tpu_torch alexnet`` (no
   ``--fused``: a forward and a GD unit a layer, the four
   ``zero_filter`` units masking the next layer's weights, no
   learning-rate adjuster, as in the JAX sample), in this process at
   batch 128 over the
   workflow phase's prototype rows (the first 1,024 TRAIN since PR 13,
   256 VALID) for 2 epochs, f32, TF32 off, ``cudnn.deterministic``,
   snapshots in a temporary directory: exactly 3 forward launches a
   minibatch and 3 backward a TRAIN minibatch (60 / 48), all at
   16-byte vectors, no
   plain pooling; after every run of each filler, its weights' masked
   entries are 0 (``conv_str2``, ``conv_str3``, ``conv_str5`` and
   ``fc6``), and each mask zeroes half of them; a second run from the
   same seeds (its weights drawn afresh) and the CLI resumed from the
   epoch-1 snapshot (its weight draw taken from the run's, which the
   snapshot's replace) bit-equal to the run (per-class n_err, confusion,
   weights, optimizer Arrays, the dropout generators); 2 TRAIN minibatches
   of 8 in f64 at full width, the card's unit graph against the CPU's
   and the card's fused graph against the CPU's unit graph, the
   dropout units handed the same host-drawn masks, within
   ``UNITS_F64_RTOL`` (grouped weights through their masks), the
   offsets equal, the CPU's and the fused graph's builds taking the
   card build's weight draw; Cutter / GDCutter, Cutter1D, Multiplier /
   GDMultiplier, Summator / GDSummator, ResizableAll2All and GDRProp
   once on the card against the CPU in f64 within ``REGISTRY_RTOL``.
   Prints each epoch's TRAIN images/s beside the workflow phase's, the
   host ms a minibatch and by unit (the run's and its last epoch's),
   the readbacks and syncs a minibatch and the snapshot seconds;
9. units — the MNIST conv sample (``root.mnistr_conv``, published
   widths 64 / 87 / 791 / 10) trained by the unit-at-a-time graph
   through the workflow CLI (a workflow file building
   ``mnist.build(layers=root.mnistr_conv.layers)``, no ``--fused``),
   in this process, at minibatch 60 over the loader's synthetic set
   (1,500 TRAIN and 1,000 VALID rows, ``UNITS_TRAIN`` / ``UNITS_VALID``) for
   2 epochs, f32,
   TF32 off, ``cudnn.deterministic``: the forward kernel must launch
   exactly twice a minibatch and the backward twice a TRAIN minibatch,
   half at 16-byte vectors (pool1) and half at one channel (pool2),
   with no plain pooling on the card and neither ``jax`` nor
   ``znicz_tpu`` imported; a second run from the same seeds, and the
   CLI resumed from the epoch-1 snapshot, must end with each epoch's
   per-class n_err and confusion matrices, the final weights and the
   optimizer Arrays bit-equal to the run's; the first 4 TRAIN
   minibatches at full width in f64 on the card (the f64 kernels) and
   on the CPU (the plain versions) must agree within
   ``UNITS_F64_RTOL`` of each tensor's largest, the pools' offsets
   equal.  Prints each epoch's TRAIN images/s, host ms a minibatch,
   readbacks and sync-debug syncs a minibatch, the same layers and
   data through ``--fused pool_impl=offsets`` as the yardstick, and
   both kernels' cold times at the MNIST shapes beside their bounds,
   plain versions and library calls;
10. train — full-width AlexNet in ``FusedNet(pool_impl="offsets")`` at
   batch 128: one step on the kernels against one on the "gather"
   lowering from the same state (loss and n_err equal, every update
   within ``GATHER_STEP_RTOL``, while a backward that drops the last
   row of windows must read above it); one batch-2 step on the card
   against the CPU's plain path in float64, tensor by tensor (the
   update before it is added within ``CPU_STEP_RATIO`` times the CPU's
   own float32 update's distance, while a TF32 control must exceed
   that; each conv's gates and output gradient and each pool's winners
   traced beside); then the main path, 3 epochs of 4 windows of 4
   steps over 2,048 prototype images (the first rows of the workflow
   phase's draw, made once in a thread started with the script) on the
   card, one readback per epoch, finite losses and parameters, exactly
   3 forward and 3 backward kernel launches a step and no plain pooling
   on the card, every backward launch at 16-byte vectors; then a
   step's device time split forward / backward / update, with the host
   held ahead, and the host's enqueue time;
11. train kernels — both kernels at batch 128 bit-equal to their plain
   versions, then cold beside their bounds, plain versions and library
   yardsticks (``F.max_pool2d``, ``max_pool2d_with_indices_backward``),
   and the backward at its runtime-stride instantiation and at tile
   budgets of 16, 24, 32 and 64 KB.
12. ae — the MNIST convolutional autoencoder (``root.mnist_ae``, published
    widths: conv 5 5x5 without bias -> stochastic abs pooling 3x3/s2 ->
    the depooling, ``GDMaxAbsPooling`` as a forward stage on the backward
    kernel -> deconv with the conv's weights -> MSE against the input,
    ``GDDeconv`` the only gradient unit) through the CLI's unit graph,
    ``python -m znicz_tpu_torch mnist_ae``, in this process at minibatch
    100 over the synthetic MNIST rows of the units phase (1,500 /
    1,000) for 2 epochs, f32, TF32 off, ``cudnn.deterministic``: the
    backward kernel must launch exactly once a minibatch, TRAIN and
    VALID (50, one channel
    a thread), the forward kernel never, no plain pooling on the card; a
    second run and the CLI resumed from the epoch-1 snapshot must end
    with each epoch's metrics, the weights, the GD's optimizer Arrays and
    the prng streams bit-equal to the run's; 4 TRAIN minibatches in f64
    on the card against the CPU within ``AE_F64_RTOL``, the stochastic
    winners equal.  Then the fused autoencoder stage
    (``FusedNet(objective="mse")`` on the layer list of
    ``tests/unit/test_fused_mse_ae.py`` at MnistAE's widths): 4 steps on
    the kernels bit-equal to the same steps with the pool on
    ``max_pooling_gather`` and the depooling on the plain backward, f64
    on the card against the CPU, then one epoch of the TRAIN rows in
    windows of 8 with exactly one forward (maxabs) and one backward
    (depooling) launch a step.  Both kernels at (100, 24, 24, 5) bit-equal
    to their plain versions on the kernel's and on stochastic offsets,
    then cold beside their bounds, plain versions and library yardsticks
    (``F.max_pool2d``, which computes max and not maxabs, and
    ``index_add_``);
13. mse — the seven-segment regressor (``root.mnist7``) through the
    CLI's unit graph and through ``--fused``, 2 epochs each at minibatch
    60 over the same split: each epoch's n_err and MSE printed, no
    pooling launch; 4 TRAIN minibatches in f64 on the card, the fused
    graph against the unit graph within ``AE_F64_RTOL``.
14. cifar — the CIFAR-10 caffe config (``root.cifar``, published widths,
    its ``arbitrary_step`` schedule and ``internal_mean``) at minibatch
    100 over the CIFAR loader's synthetic set, 7,500 TRAIN and 1,500
    VALID rows (CIFAR-10's split is 50,000 / 10,000; cut for the
    command's time), f32,
    TF32 off, ``cudnn.deterministic``.  First
    both kernels at the path's pools, (100, 32, 32, 32) (caffe pool1)
    and (100, 32, 32, 96) (nin pool3), 3x3/s2 in ceil mode with a row
    and a column of overhang: bit-equal to their plain versions on
    random and tied inputs in f32 and f64, every launch at 16-byte
    vectors, then cold beside their bounds, plain versions and library
    yardsticks.  Then ``python -m znicz_tpu_torch cifar`` (the unit
    graph) for 2 epochs: exactly one forward launch a minibatch (180)
    and one backward a TRAIN minibatch (150), all at 16-byte vectors,
    no plain pooling; the adjuster before the GD chain, ticked once a
    TRAIN minibatch; a second run and the CLI resumed from the epoch-1
    snapshot bit-equal to it (each epoch's n_err and confusion, the
    weights, the optimizer Arrays, every GD's learning rates and the
    adjuster's count; cuDNN's deterministic algorithms are the training
    default, ``core.backends.deterministic``); the
    same through ``--fused pool_impl=offsets`` (the same launches, one
    readback a TRAIN segment, the adjuster between the loader and the
    trainer); the nin and mlp variants (``build_variant``) through the
    unit graph at 2,000 / 500 rows for one epoch (nin's pool3 launches
    both kernels); and 12 TRAIN minibatches in f64 with the rate cut 10x
    after the third: the card's unit graph against the CPU's and the
    card's fused graph (windows of 8, the boundary inside the first)
    against it, every weight and bias within ``UNITS_F64_RTOL``, equal
    n_err, the same rate at every step.  The unit graph run's snapshots
    stay for the next phase.
15. serve_models — what the port trains, served, under
    ``cudnn.deterministic``.  The AlexNet package of the serve phase in
    f32, bf16 and int8: ``accuracy.dtype_delta_report`` on the card (its
    own 64 seeded rows, uniform in [-1, 1], every bucket 1..64) within
    its pins; per
    dtype an engine behind ``ServingServer`` answers requests of 1, 3,
    17 and 64 rows, each dispatch launching exactly 3 forward kernels at
    16-byte vectors and no plain pooling (counts set to 0 just before,
    read just after), then batch-64 dispatch ms, images/s and request
    p50/p99; the bf16 forward bit-equal to the same forward with
    ``max_pooling_plain`` in the kernel's place.  The CIFAR caffe
    snapshot of the cifar phase through ``serve --latest cifar_caffe``
    (``serving.server.serve``, the CLI's own) in f32 and bf16: 1 launch a
    dispatch, f32 rows against the port's plain forward on the CPU
    within ``LOG_P_TOL`` in log p, bf16 within its pin of f32.  Hot
    reload over HTTP: a source failing at warmup answers 400 and v1
    serves on; then, while a client thread keeps requesting, ``POST
    /reload`` to the package with its weights x0.9: no request fails,
    the version goes 1 -> 2, no warmup dispatch runs, and the replies
    equal a fresh engine's bit for bit.  A registry of ``alexnet@f32``,
    ``alexnet8@int8`` and ``cifar@bf16`` under a budget below their sum:
    adding the last evicts the least recently used (alexnet) and
    ``torch.cuda.memory_allocated`` falls by its device bytes within the
    allocator's rounding, the next request restores it with bit-equal
    replies, and int8 holds at most ``INT8_BYTES_RATIO`` of f32's bytes;
    the reload's wall ms and the evict and restore ms are printed.
15. stl10 — STL-10's published network (``root.stl``: conv 32 5x5 pad 2
    -> max pool 3x3/s2 -> strict relu -> LRN -> conv 32 5x5 -> strict
    relu -> avg pool 3x3/s2 -> LRN -> softmax; ``internal_mean``) at
    minibatch 50 over the sample's synthetic set in the real binary
    format, 2,500 TRAIN and 500 VALID images (written with the JAX
    package's bytes in a thread beside the build), f32, TF32 off,
    ``cudnn.deterministic``.  Both kernels at pool1's shape, (50, 96,
    96, 32) 3x3/s2 in ceil mode, bit-equal to their plain versions in
    f32 and f64 (also among the kernel phases' cases, staged and
    unstaged), then cold beside their bounds, plain versions and library
    yardsticks.  ``python -m znicz_tpu_torch research.stl10`` (the unit
    graph) for 2 epochs: exactly one forward launch a minibatch (120)
    and one backward a TRAIN minibatch (100), all at 16-byte vectors, no
    plain pooling, no adjuster; a second run and the CLI resumed from
    the epoch-1 snapshot bit-equal to it; ``--fused pool_impl=offsets``
    (windows of 8 over the rows on the card): the same launches, one
    readback a TRAIN segment; the first 4 TRAIN minibatches in f64, the
    card against the CPU and the fused graph against the CPU's unit
    graph, within ``UNITS_F64_RTOL``, pool1's offsets equal.  Then the
    rest of the zoo through the unit graph on the card, no kernel:
    ``research.mnist_simple`` (an epoch at minibatch 88 over the units
    phase's rows), ``research.wine_relu`` and ``wine``,
    ``research.hands``, ``research.tv_channels`` and ``yale_faces``
    (their synthetic images, where PIL imports; whether PIL and
    scikit-learn import is tried in child processes and printed), each
    ending on the card with every epoch's n_err within its rows.
17. mse_zoo — ImagenetAE's published ladder (``root.imagenet_ae``: conv
    108 9x9/s3, 192 5x5, 224 5x5, 256 3x3, each with stochastic abs
    pooling 3x3/s2 in ceil mode; the last stage's depooling on the
    backward kernel, a deconv sharing its conv's weights, MSE against
    the stage's input, ``GDDeconv`` the only gradient unit) at the
    227x227 crop over 256 of the sample's synthetic images (192 TRAIN,
    64 VALID) at its minibatch 8, f32, TF32 off,
    ``cudnn.deterministic``.  First the depooling at the four stages'
    shapes, (8, 73, 73, 108), (8, 32, 32, 192), (8, 12, 12, 224) and
    (8, 4, 4, 256), on stochastic winners: bit-equal to its plain
    version in f32 and f64, every launch at 16-byte vectors, then cold
    beside its bound, plain version and ``index_add_``.  Then
    ``python -m znicz_tpu_torch research.imagenet_ae`` for the four
    stages, 2 epochs each, each grown from the last one's snapshot
    (``--config imagenet_ae.n_stages=N``, ``imagenet_ae.restore_snapshot``):
    exactly one backward launch a minibatch, TRAIN and VALID (64 a
    stage), all at 16-byte vectors, no forward launch and no plain
    pooling; the frozen stages bit-equal to the snapshot they came
    from; a second run of the last stage from the same seeds and the
    CLI resumed from its epoch-1 snapshot bit-equal to it (each epoch's
    metrics, the shared weights, ``GDDeconv``'s optimizer Arrays, the
    prng streams); stage 0's host ms by unit, its stochastic pool's host
    draw and upload split out; stages 0 and 3 in f64, the first 4 TRAIN
    minibatches and a VALID one, the card against the CPU within
    ``UNITS_F64_RTOL``, every stochastic winner equal.  Each of the four
    stochastic pooling types in ``FusedNet`` as ImagenetAE's stage 0
    (4 steps, its stream drawn on the card, the depooling on the
    backward kernel) replayed bit for bit.  Then ``research.video_ae``
    at the published 90x160 frames, ``approximator`` in the fused
    trainer's host-stacked, sliced and indexed windows (bit-equal to
    each other, one readback a TRAIN segment) and ``kanji`` over its
    synthetic glyphs (written under ``build/``), each ending on the
    card with finite metrics.

The line before the last is the ``{"kernels": [...]}`` JSON.  For the
forward kernel, ``ms``, ``plain_ms``, ``library_ms``, ``bound_ms``,
``host_enqueue_ms`` and ``in_model_ms`` are per batch-64 dispatch,
summed over the three AlexNet pools, ``train`` holds the same per
batch-128 step, ``mnist`` per MNIST minibatch of 60 (both pools),
``ae`` per autoencoder minibatch of 100 (the maxabs pool), ``cifar``
and ``stl10`` each pool on its own, and ``launches`` counts the serve
requests', the serve retries' (``resilience_serve``), the train
epochs', the workflow run's, the supervised run's (``resilience``),
the train phase's resilience steps' (``resilience_net``), AlexNet's unit
graph's (``alexnet_units``), MNIST's unit graph's (``units``), both
autoencoder paths', both CIFAR graphs' and the serve_models
phase's launches, both STL-10 graphs' and ImagenetAE's ladder and
fused stochastic stages (``launches_by_path``; the
serve_models phase's also by serving dtype,
``launches_by_dtype``), and ``bf16`` holds each AlexNet serving pool's
timings in bfloat16.  For the backward kernel the times are per
batch-128 step (``mnist`` per TRAIN minibatch of 60, ``ae`` per
depooling of a minibatch of 100 on stochastic offsets, ``cifar`` and
``stl10`` per pool, ``imagenet_ae`` per depooling of each stage) and
``launches`` counts the train epochs', the workflow run's, the
resilience phase's two paths', both unit graphs', the autoencoder
paths', the CIFAR and STL-10 graphs' and ImagenetAE's.
``launches_by_width`` splits each kernel's launches by vector width,
and ``ptxas`` gives the registers and spilled bytes of its
instantiations.  ``max_abs_err`` is the largest difference from
the plain version that the run measured over every case the kernel was
checked on.  A line before it gives each phase's wall seconds.  The
last line is ``{"ok": true, "device": {...}}``.
"""

import collections
import gc
import http.client
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: where the serve phases write their packages (git-ignored)
SMOKE_DIR = os.path.join(HERE, "build", "znicz_tpu_torch", "smoke")
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: bfloat16 FLOP/s, the data sheet's (dense, tensor cores) and the
#: only bfloat16 rate it gives
BF16_OPS_PER_S = 989e12
#: least device spin before each timed launch, in ms: the host's enqueue
#: of a launch takes tens of microseconds, and stalls of a millisecond
#: were seen on a shared host
SPIN_MS = 2.0
#: tile budgets (KB of shared memory a block) the kernels are also
#: timed at
TILE_SWEEP_KB = (16, 24, 32, 64)
#: samples per kernel timing; shapes whose bound is under 10 us take more
TIMING_ITERS, SMALL_TIMING_ITERS = 50, 200
#: samples per kernel timing at the MNIST and autoencoder shapes, which
#: launch-bound rows have read alike since PR 6 (200 until PR 11; their
#: phases' seconds went to the mse_zoo phase)
MNIST_TIMING_ITERS = TIMING_ITERS
#: the serve phase's limit on |log p_card - log p_cpu|
LOG_P_TOL = 1e-4
ALEXNET_POOLS = (("max_pool1", (64, 55, 55, 96)),
                 ("max_pool2", (64, 27, 27, 256)),
                 ("max_pool5", (64, 13, 13, 256)))
#: (sy, sx, c, ky, kx, sliding) of tests/unit/test_pooling.py GEOMS —
#: the second and third overhang the edge
GEOMS = ((6, 6, 3, 2, 2, (2, 2)), (5, 7, 2, 3, 2, (2, 3)),
         (4, 4, 1, 3, 3, (3, 3)))
#: (b, h, w, c, ky, kx, sliding) at the kernel's tile edges: 28 tiles
#: of one output row; 13 output rows in tiles of 4 over channels a
#: multiple of the 16-byte vector but not of the slab; the MNIST pool's
#: 87 channels at 2x2/s2; rows wider than a tile (column tiles of 22
#: output columns over 350, in row tiles of 2 over 3)
TILE_EDGES = ((2, 57, 57, 96, 3, 3, (2, 2)), (2, 27, 27, 36, 3, 3, (2, 2)),
              (2, 24, 24, 87, 2, 2, (2, 2)), (2, 7, 700, 32, 3, 3, (2, 2)))
#: the MNIST conv sample's two max pools (2x2/s2) at minibatch 60: 64
#: channels (16-byte vectors) and 87 (one channel a thread)
MNIST_POOLS = (("pool1", (60, 24, 24, 64)), ("pool2", (60, 8, 8, 87)))
#: (b, h, w, c, ky, kx, sliding) whose window no shared memory holds, so
#: the kernel runs unstaged: a global 128x128 pool (128 rows x 2,048 B
#: = 262,144 B, over the 232,448 B a block may take), and for the
#: backward 96x96 windows at stride 1 (the 9,216 windows covering one
#: cell take 294,912 B of err and offsets)
UNSTAGED = (2, 128, 128, 4, 128, 128, (128, 128))
BACKWARD_UNSTAGED = (1, 191, 191, 4, 96, 96, (1, 1))
#: (b, h, w, c, ky, kx, sliding) at the backward kernel's own tile
#: edges: 2x2/s2 windows straddling tiles of an odd number of rows;
#: 3x3/s2 in odd tiles (the halo row falls on either parity); column
#: tiles; the MNIST pool's 87 channels at one channel a thread; runtime
#: strides in 15 row tiles and in column tiles; a stride past the
#: window, so some cells no window covers
BACKWARD_TILE_EDGES = (
    (2, 57, 57, 96, 2, 2, (2, 2)), (2, 41, 41, 64, 3, 3, (2, 2)),
    (2, 7, 700, 32, 3, 3, (2, 2)), (3, 24, 24, 87, 2, 2, (2, 2)),
    (2, 60, 150, 32, 3, 3, (3, 3)), (2, 5, 1200, 16, 3, 3, (3, 3)),
    (2, 20, 20, 8, 2, 2, (3, 3)))
#: the kernel's two widths: 16-byte vectors of channels, one channel
WIDE, NARROW = "16-byte", "1-channel"
#: the train phase: batch 128 (the published AlexNet minibatch,
#: Krizhevsky et al. 2012), 2,048 prototype images of 10 classes, 3
#: epochs of 4 windows of 4 steps
TRAIN_BATCH, TRAIN_IMAGES, TRAIN_CLASSES = 128, 2048, 10
EPOCHS, WINDOWS, WINDOW_STEPS = 3, 4, 4
TRAIN_POOLS = (("max_pool1", (128, 55, 55, 96)),
               ("max_pool2", (128, 27, 27, 256)),
               ("max_pool5", (128, 13, 13, 256)))
#: the workflow phase: the CLI's AlexNet at batch TRAIN_BATCH over
#: 2,048 TRAIN and 256 VALID prototype images (the loader's draw,
#: [VALID | TRAIN]) for 3 epochs
WORKFLOW_TRAIN, WORKFLOW_VALID, WORKFLOW_EPOCHS = 2048, 256, 3
#: the kernels' step against the "gather" step (plain forward, scatter
#: backward) from one state: each parameter's update within this
#: relative difference of the tensor's largest update (only the order
#: of the adds into a cell that wins two windows differs); a backward
#: that drops the last row of windows must read above it.  On an H100
#: 80GB HBM3 at 700 W the kernels read 6.5e-7, that control 0.49 and
#: one window of one image dropped 9.6e-3
GATHER_STEP_RTOL = 1e-5
#: the card's batch-2 update in f32 against the CPU's plain path in
#: f64, tensor by tensor, relative to the tensor's largest update:
#: within CPU_STEP_RATIO times the CPU's own f32 update's reading (at
#: least CPU_STEP_FLOOR), and a TF32 control must exceed that at some
#: tensor.  Updates are read before they are added to the weights (the
#: velocity slot after one step from zero velocity).  f32 itself sits
#: 1e-6 (FC layers) to 4e-2 (conv1) from the exact update, on either
#: device; on an H100 80GB HBM3 at 700 W the card's f32 read 0.29 to
#: 1.4 times the CPU's f32 and TF32 15 to 6,700 times
CPU_STEP_RATIO, CPU_STEP_FLOOR = 4.0, 1e-6
#: dispatches of the same serve batch that must give the same bits
SERVE_REPEATS = 5
#: the unit phase: the MNIST conv sample through the unit-at-a-time
#: graph at minibatch 60 (root.mnistr.loader) over the loader's
#: synthetic set, 1,500 TRAIN and 1,000 VALID rows (15,000 / 10,000
#: from PR 8 to PR 9 and 7,500 / 5,000 from PR 10 to PR 11 of MNIST's
#: 60,000 / 10,000, cut to make room for the CIFAR, the alexnet_units
#: and then the mse_zoo phase),
#: for 2 epochs; the autoencoder and MSE phases take the same
#: rows; the prng streams 1 and 2 seeded with UNITS_SEED and the next
#: integer before each run
UNITS_TRAIN, UNITS_VALID, UNITS_BATCH, UNITS_EPOCHS = 1500, 1000, 60, 2
UNITS_SEED = 1234
#: the card's f64 parameters after 4 TRAIN minibatches against the
#: CPU's, relative to each tensor's largest magnitude: f64 on either
#: device differs only by the order of the sums (about 1e-15 a
#: product), far inside this bound
UNITS_F64_RTOL = 1e-10
#: the autoencoder phase: MnistAE (root.mnist_ae, published widths) at
#: minibatch 100 over the same synthetic MNIST split for 2 epochs; its
#: pool's input shape; the fused stage's window; f64 card-vs-CPU bound
AE_BATCH, AE_EPOCHS, AE_WINDOW = 100, 2, 8
AE_SHAPE = (AE_BATCH, 24, 24, 5)
AE_F64_RTOL = UNITS_F64_RTOL
#: the MSE phase: mnist7 (root.mnist7) at minibatch 60 for 2 epochs
MSE_BATCH, MSE_EPOCHS = 60, 2
#: the alexnet_units phase: the CLI's AlexNet through the unit graph
#: at batch TRAIN_BATCH over the workflow phase's rows for 2 epochs (the
#: fewest a resume from epoch 1 allows); the forwards' output shapes
#: (a zero_filter has none); each filler's name and the (n_kernels,
#: weights per kernel) shape of the weights it masks
ALEXNET_UNITS_EPOCHS = 2
#: its TRAIN rows: the first 1,024 of the workflow phase's 2,048 (cut
#: in PR 13 to make room for the resilience phase), its 256 VALID rows
ALEXNET_UNITS_TRAIN = 1024
ALEXNET_SHAPES = [(128, 55, 55, 96), (128, 27, 27, 96), (128, 27, 27, 96),
                  (128, 27, 27, 256), (128, 13, 13, 256),
                  (128, 13, 13, 256), (128, 13, 13, 384),
                  (128, 13, 13, 384), (128, 13, 13, 256), (128, 6, 6, 256),
                  (128, 4096), (128, 4096), (128, 4096), (128, 4096),
                  (128, 4096), (128, 4096), (128, 10)]
ALEXNET_FILLED = {"grouping1_forward": (256, 2400),
                  "grouping2_forward": (384, 2304),
                  "grouping3_forward": (256, 3456),
                  "grouping5_forward": (4096, 9216)}
#: its f64 checks: full width at minibatch 8 for 2 TRAIN minibatches;
#: a snapshotter interval no run of the phase reaches but the main one's
ALEXNET_F64_BATCH, ALEXNET_F64_MB = 8, 2
NO_SNAPSHOT = 1000000
#: the rest of the registry on the card against the CPU in f64: each
#: array within this of the CPU's largest magnitude; their inputs' seed
REGISTRY_RTOL, REGISTRY_SEED = 1e-12, 2024
#: the CIFAR phase: the caffe config (root.cifar: published widths,
#: schedule and internal_mean) at minibatch 100 over the CIFAR loader's
#: synthetic set, 7,500 TRAIN and 1,500 VALID rows (CIFAR-10's split is
#: 50,000 / 10,000; cut to make room for the alexnet_units, stl10 and,
#: in PR 13, resilience phases), for 2 epochs, through the unit graph
#: and the fused graph
CIFAR_TRAIN, CIFAR_VALID, CIFAR_BATCH, CIFAR_EPOCHS = 7500, 1500, 100, 2
#: the caffe graph's forward output shapes at minibatch 100
CIFAR_SHAPES = [(100, 32, 32, 32), (100, 16, 16, 32), (100, 16, 16, 32),
                (100, 16, 16, 32), (100, 16, 16, 32), (100, 16, 16, 32),
                (100, 8, 8, 32), (100, 8, 8, 32), (100, 8, 8, 64),
                (100, 8, 8, 64), (100, 4, 4, 64), (100, 10)]
#: the max pools on the CIFAR path, 3x3/s2 in ceil mode (32 -> 16: a row
#: and a column of overhang): the caffe config's pool1 and the nin
#: variant's pool3, both at 16-byte vectors
CIFAR_POOLS = (("caffe pool1", (100, 32, 32, 32)),
               ("nin pool3", (100, 32, 32, 96)))
#: the schedule-parity check: 12 TRAIN minibatches in f64, the rate
#: dropped 10x after the third (tests/functional/test_fused_workflow.py's
#: schedule), the fused graph in windows of 8: the boundary falls inside
#: the first window
CIFAR_F64_MB, CIFAR_F64_WINDOW, CIFAR_F64_BOUNDARY = 12, 8, 3
#: the nin and mlp variants through the unit graph: 2,000 TRAIN and 500
#: VALID rows, 1 epoch
CIFAR_VARIANT_TRAIN, CIFAR_VARIANT_VALID = 2000, 500
#: the stl10 phase: STL-10's published network (root.stl) at its
#: minibatch 50 over the sample's synthetic set at STL-10's labelled
#: TRAIN split, 5,000 rows, cut to 2,500 in PR 13 to make room for the
#: resilience phase, and 500 VALID rows (the test split's 8,000, cut
#: for time), for 2 epochs through both graphs
STL_TRAIN, STL_VALID, STL_BATCH, STL_EPOCHS = 2500, 500, 50, 2
#: its max pool, pool1: 3x3/s2 in ceil mode over conv1's output (96 ->
#: 48: the last row and column of windows overhang the edge)
STL_POOLS = (("stl10 pool1", (50, 96, 96, 32)),)
#: the graph's forward output shapes at minibatch 50 (the head as wide
#: as the synthetic set's 4 labels, as in the JAX package)
STL_SHAPES = [(50, 96, 96, 32)] + [(50, 48, 48, 32)] * 5 + \
    [(50, 24, 24, 32)] * 2 + [(50, 4)]
#: its f64 checks: the first 4 TRAIN minibatches and a VALID one
STL_F64_MB = 4
#: the zoo's MNIST MLP at its published minibatch, for one epoch over the
#: units phase's rows; the other samples' epochs
ZOO_MNIST_BATCH, ZOO_EPOCHS = 88, 2
#: the mse_zoo phase: ImagenetAE's published ladder (root.imagenet_ae) at
#: the 227x227 ImageNet crop, over 256 of the sample's synthetic images
#: (192 TRAIN, 64 VALID) at its minibatch 8, each of the four stages 2
#: epochs, grown from the last one's snapshot
IAE_SIZE, IAE_IMAGES, IAE_BATCH, IAE_EPOCHS, IAE_STAGES = 227, 256, 8, 2, 4
#: the depooling of each stage, the pool's input: (label, NHWC shape)
IAE_POOLS = (("imagenet_ae stage 0", (8, 73, 73, 108)),
             ("imagenet_ae stage 1", (8, 32, 32, 192)),
             ("imagenet_ae stage 2", (8, 12, 12, 224)),
             ("imagenet_ae stage 3", (8, 4, 4, 256)))
#: its f64 checks, on stages 0 and 3: 34 images, the first 4 TRAIN
#: minibatches (8, 8, 8, 2) and a VALID one of 8
IAE_F64_IMAGES, IAE_F64_STAGES = 34, (1, 4)
#: the other MSE samples on the card: video_ae at the published 90x160
#: frames, the approximator's three window forms at window 4, kanji;
#: each for 2 epochs
MSE_ZOO_EPOCHS, MSE_ZOO_WINDOW, VIDEO_FRAME = 2, 4, (90, 160)
#: the fused stochastic pools: ImagenetAE's stage 0 as a fused
#: autoencoder stage, 4 steps of minibatch 8 for each pooling type
FUSED_STOCHASTIC_STEPS = 4


def say(*args):
    print(*args, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available — this "
                         "script runs on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say("== device: %s; torch %s, CUDA %s, cuDNN %s, %d device(s); host "
        "CPU %s" % (name, torch.__version__, torch.version.cuda,
                    torch.backends.cudnn.version(),
                    torch.cuda.device_count(), _cpu_model()))
    say(smi)
    return name, smi


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def phase_build():
    from znicz_tpu_torch.ops import cuda_build, cuda_pooling
    from znicz_tpu_torch.ops import cuda_pooling_backward
    t0 = time.perf_counter()
    cuda_build.build_all()
    cuda_pooling.load()
    cuda_pooling_backward.load()
    say("== build: %.2f s (one nvcc per source, all at once, or the cached "
        "libraries): %s" % (time.perf_counter() - t0,
                            ", ".join(cuda_build.sources())))
    for source in cuda_build.sources():
        say("   ptxas, %s:" % source)
        for line in cuda_build.ptxas_report(source):
            say("     " + line)


def _ptxas(source):
    """Registers (least, most) and spilled bytes (stores + loads, summed)
    of ``source``'s kernels, from ptxas's report."""
    import re
    from znicz_tpu_torch.ops import cuda_build
    regs, spill = [], 0
    for line in cuda_build.ptxas_report(source):
        regs += [int(n) for n in re.findall(r"Used (\d+) registers", line)]
        spill += sum(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", line))
    return {"registers": [min(regs), max(regs)], "spill_bytes": spill,
            "kernels": len(regs)}


def _bits(t):
    import torch
    return t.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[t.element_size()])


def _check_pool(torch, x, ky, kx, sliding, use_abs, label):
    """Kernel vs plain version, bit for bit; returns ``(max |diff|, the
    width the kernel launched at)``."""
    from znicz_tpu_torch.ops import cuda_pooling, pooling
    wide = cuda_pooling.LAUNCHES_WIDE
    v, o = cuda_pooling.max_pooling_offsets(x, ky, kx, sliding, use_abs)
    width = WIDE if cuda_pooling.LAUNCHES_WIDE > wide else NARROW
    pv, po = pooling.max_pooling_plain(x, ky, kx, sliding, use_abs)
    torch.cuda.synchronize()
    if v.shape != pv.shape or v.dtype != pv.dtype or \
            not torch.equal(_bits(v), _bits(pv)) or not torch.equal(o, po):
        bad = (o != po).sum().item() if o.shape == po.shape else -1
        raise RuntimeError("kernel disagrees with its plain version: %s "
                           "(%d offsets differ)" % (label, bad))
    return _max_abs_diff(v, pv), width


def _tied(torch, gen, shape, dtype):
    """Small integers: exact ties everywhere, |x| ties for maxabs, a
    tied top-left corner and -inf down channel 0 of row 0."""
    x = torch.randint(-3, 4, shape, generator=gen, device="cuda").to(dtype)
    if len(shape) == 4:
        x[:, 0, :2, :] = 2
        x[0, :, :, 0] = float("-inf")
    return x


def _cases(torch, gen):
    """``(label, x, ky, kx, sliding, width it must launch at or None)``
    of the kernel phase."""
    f32, bf16, f16, f64 = (torch.float32, torch.bfloat16, torch.float16,
                           torch.float64)
    for label, shape in ALEXNET_POOLS:
        yield ("%s f32" % label, torch.randn(shape, generator=gen,
                                             device="cuda"),
               3, 3, (2, 2), WIDE)
    for dtype in (bf16, f16):
        x = torch.randn(ALEXNET_POOLS[0][1], generator=gen, device="cuda")
        yield "max_pool1 %s" % dtype, x.to(dtype), 3, 3, (2, 2), WIDE
    for label, shape in MNIST_POOLS:
        for dtype in (f32, f64):
            x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            yield ("MNIST %s %s" % (label, dtype), x, 2, 2, (2, 2),
                   WIDE if shape[3] % 4 == 0 else NARROW)
    for label, shape in STL_POOLS:
        for dtype in (f32, f64):
            x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            yield "%s %s" % (label, dtype), x, 3, 3, (2, 2), WIDE
    b, h, w, c, ky, kx, sliding = UNSTAGED
    yield ("unstaged %s f32" % (UNSTAGED,),
           _tied(torch, gen, (b, h, w, c), f32), ky, kx, sliding, WIDE)
    for sy, sx, c, ky, kx, sliding in GEOMS:
        for dtype in (f32, bf16, f16, f64):
            yield ("geom %s %s" % ((sy, sx, c, ky, kx, sliding), dtype),
                   _tied(torch, gen, (3, sy, sx, c), dtype), ky, kx,
                   sliding, None)
    for b, h, w, c, ky, kx, sliding in TILE_EDGES:
        for dtype in (f32, bf16, f64):
            want = NARROW if c % 4 else WIDE if dtype != bf16 else None
            yield ("tile edge %s %s" % ((b, h, w, c, ky, kx, sliding),
                                        dtype),
                   _tied(torch, gen, (b, h, w, c), dtype), ky, kx,
                   sliding, want)
    # contiguous, but 4 bytes past a 16-byte boundary
    shape = (2, 27, 27, 36)
    buf = _tied(torch, gen, (2 * 27 * 27 * 36 + 1,), f32)
    yield ("unaligned %s f32" % (shape,), buf[1:].view(shape), 3, 3, (2, 2),
           NARROW)


class _Unstaged(object):
    """While installed (``with``), both wrappers plan every launch as
    they plan a window that no shared memory holds: their unstaged
    instantiations, on any shape (``MAX_SMEM`` set to 0, the plans'
    caches cleared before and after); nothing in the package reads
    it."""

    def __enter__(self):
        from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
        self.mods = (cuda_pooling, cuda_pooling_backward)
        self.saved = [m.MAX_SMEM for m in self.mods]
        for m in self.mods:
            m.MAX_SMEM = 0
            m.launch_plan.cache_clear()
        return self

    def __exit__(self, *exc):
        for m, smem in zip(self.mods, self.saved):
            m.MAX_SMEM = smem
            m.launch_plan.cache_clear()


def _stl_unstaged_cases(torch, gen):
    """``(label, x)``: STL-10's pool1 input in f32 and f64, random and
    tied, for the unstaged instantiations."""
    for label, shape in STL_POOLS:
        for dtype in (torch.float32, torch.float64):
            yield ("%s %s unstaged" % (label, dtype),
                   torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype))
            yield ("%s %s tied, unstaged" % (label, dtype),
                   _tied(torch, gen, shape, dtype))


def _spin_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on the card
    (CUDA events around one long spin, after a short one)."""
    torch.cuda._sleep(1000)
    n = 2_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return n / start.elapsed_time(end)


def _median_ms(torch, fn, flush, cycles_per_ms, iters):
    """Cold-L2 device time of ``fn`` with the host out of the window:
    ``(median device ms, median host ms of fn)`` over ``iters`` samples.

    Each sample enqueues ``flush`` (reads that leave the L2 holding
    clean lines of another buffer), then a device spin longer than the
    host takes to enqueue ``fn`` (at least ``SPIN_MS``, and four times
    the slowest of three warm-up calls), then the start event, ``fn``
    and the end event, and waits for the end.  So the device reaches the
    start event with ``fn``'s work already queued and never idles inside
    the window on the host.  A sample whose enqueue, from the spin to
    the end event, reaches the spin's length (a stall of the shared
    host) is dropped and taken again; more than ``iters // 10`` such
    samples raise."""
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        warm.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    spin_ms = max(SPIN_MS, 4e3 * max(warm))
    cycles = int(spin_ms * cycles_per_ms)
    device, host, stalls = [], [], []
    gc.disable()  # no collection inside a window
    try:
        while len(device) < iters:
            flush()
            torch.cuda._sleep(cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            t1 = time.perf_counter()
            fn()
            t2 = time.perf_counter()
            end.record()
            window = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            if window >= spin_ms:
                stalls.append(window)
                if len(stalls) > iters // 10:
                    raise RuntimeError(
                        "the host's enqueue outlasted the %.4f ms device "
                        "spin in %d samples (%s ms)" % (
                            spin_ms, len(stalls),
                            ", ".join("%.4f" % w for w in stalls)))
                continue
            host.append((t2 - t1) * 1e3)
            device.append(start.elapsed_time(end))
    finally:
        gc.enable()
    if stalls:
        say("   (%d sample(s) taken again: the host's enqueue took %s ms, "
            "the spin lasts %.4f ms)" % (
                len(stalls), ", ".join("%.4f" % w for w in stalls), spin_ms))
    return statistics.median(device), statistics.median(host)


def _tile_sweep(torch, module, fn, flush, cycles_per_ms, iters):
    """Kernel ms of ``fn`` at each tile budget of ``TILE_SWEEP_KB`` of
    the wrapper ``module``'s launch plan."""
    chosen = module.TILE_BYTES
    sweep = {}
    try:
        for kb in TILE_SWEEP_KB:
            module.TILE_BYTES = kb << 10
            module.launch_plan.cache_clear()
            sweep[kb] = _median_ms(torch, fn, flush, cycles_per_ms, iters)[0]
    finally:
        module.TILE_BYTES = chosen
        module.launch_plan.cache_clear()
    return sweep


def _runtime_stride_ms(torch, fn, flush, cycles_per_ms, iters):
    """Kernel ms of ``fn`` with the backward's launch plans sent to its
    runtime-stride instantiation: the yardstick of the stride-2 one."""
    from znicz_tpu_torch.ops import cuda_pooling_backward
    plan = cuda_pooling_backward.launch_plan
    cuda_pooling_backward.launch_plan = \
        lambda *args: plan(*args)._replace(stride2=False)
    try:
        return _median_ms(torch, fn, flush, cycles_per_ms, iters)[0]
    finally:
        cuda_pooling_backward.launch_plan = plan


def phase_kernels(torch, card, cycles_per_ms):
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import cuda_pooling, pooling
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    max_err = 0.0
    n_cases = 0
    staged = set()
    for label, x, ky, kx, sliding, want in _cases(torch, gen):
        widths = set()
        for use_abs in (False, True):
            err, width = _check_pool(torch, x, ky, kx, sliding, use_abs,
                                     "%s use_abs=%s" % (label, use_abs))
            max_err = max(max_err, err)
            widths.add(width)
            n_cases += 1
        plan = cuda_pooling.launch_plan(
            tuple(x.shape), x.element_size(), cuda_pooling.vector_width(x),
            ky, kx, sliding)
        staged.add(plan.staged)
        say("   %s: bit-equal, max and maxabs, at width %s; %s"
            % (label, "/".join(sorted(widths)), plan))
        if want is not None and widths != {want}:
            raise RuntimeError("%s launched at width %s, not %s"
                               % (label, widths, want))
        if label.startswith("unstaged") == plan.staged:
            raise RuntimeError("%s launched %s" % (
                label, "staged" if plan.staged else "unstaged"))
    # STL-10's pool1 through the unstaged instantiation as well
    with _Unstaged():
        for label, x in _stl_unstaged_cases(torch, gen):
            for use_abs in (False, True):
                err, width = _check_pool(torch, x, 3, 3, (2, 2), use_abs,
                                         "%s use_abs=%s" % (label, use_abs))
                max_err = max(max_err, err)
                n_cases += 1
            plan = cuda_pooling.launch_plan(
                tuple(x.shape), x.element_size(),
                cuda_pooling.vector_width(x), 3, 3, (2, 2))
            if plan.staged or width != WIDE:
                raise RuntimeError("%s launched %s at %s" % (label, plan,
                                                             width))
            say("   %s: bit-equal, max and maxabs, at width %s; %s"
                % (label, width, plan))
    say("== kernels: max_pooling_offsets bit-equal to max_pooling_plain "
        "on %d cases (values and int32 offsets), staged and unstaged"
        % n_cases)
    flush = torch.ones(32 << 20, device=dev).sum  # reads 128 MiB
    say("   timing: CUDA events around each launch after an L2 flush by "
        "reading 128 MiB and a device spin of at least %.1f ms (%.0f "
        "cycles/ms); median of %d samples, %d where the bound is under "
        "10 us" % (SPIN_MS, cycles_per_ms, TIMING_ITERS,
                   SMALL_TIMING_ITERS))
    say("   an empty launch between the events: %.4f ms, the method's "
        "floor; %s" % (_median_ms(torch, lambda: torch.cuda._sleep(0), flush,
                                  cycles_per_ms, SMALL_TIMING_ITERS)[0],
                       card))
    rows = {}
    for label, shape in ALEXNET_POOLS:
        x = torch.randn(shape, generator=gen, device=dev)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
        b, h, w, c = shape
        ny, nx = pooling.output_spatial(h, w, 3, 3, (2, 2))
        n_out = b * ny * nx * c
        nbytes = x.numel() * 4 + n_out * (4 + 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_out * 9 / F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        iters = SMALL_TIMING_ITERS if bound < 0.01 else TIMING_ITERS
        row = {"bound_ms": bound,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

        def kernel():
            return cuda_pooling.max_pooling_offsets(x, 3, 3, (2, 2))
        for key, fn in (
                ("ms", kernel),
                ("plain_ms", lambda: pooling.max_pooling_plain(
                    x, 3, 3, (2, 2))),
                ("library_ms", lambda: F.max_pool2d(
                    x_nchw, 3, 2, ceil_mode=True, return_indices=True))):
            row[key], row[key[:-2] + "host_ms"] = _median_ms(
                torch, fn, flush, cycles_per_ms, iters)
        rows[label] = row
        plan = cuda_pooling.launch_plan(shape, 4, cuda_pooling.vector_width(x),
                                        3, 3, (2, 2))
        say("   %s %s f32: kernel %.4f ms (host enqueue %.4f ms), plain "
            "%.4f ms (host %.4f), max_pool2d %.4f ms (host %.4f), bound "
            "%.4f ms (%.1f MB moved), %.0f%% of bound; %d samples; %s; %s"
            % (label, shape, row["ms"], row["host_ms"], row["plain_ms"],
               row["plain_host_ms"], row["library_ms"],
               row["library_host_ms"], bound, nbytes / 1e6,
               100 * bound / row["ms"], iters, plan, card))
        say("   %s kernel ms by tile budget in KB: %s" % (label, json.dumps(
            _tile_sweep(torch, cuda_pooling, kernel, flush, cycles_per_ms,
                        iters))))
    return rows, _bf16_pool_rows(torch, gen, flush, card, cycles_per_ms), \
        max_err


def _bf16_pool_rows(torch, gen, flush, card, cycles_per_ms):
    """The forward kernel in bfloat16 at AlexNet's three serving pools
    (the ``--dtype bf16`` path), cold beside its bound (2 bytes a value
    read and written, 4 an offset, over 3.35 TB/s), its plain version
    and ``F.max_pool2d`` in bfloat16."""
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import cuda_pooling, pooling
    rows = {}
    for label, shape in ALEXNET_POOLS:
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        b, h, w, c = shape
        ny, nx = pooling.output_spatial(h, w, 3, 3, (2, 2))
        n_out = b * ny * nx * c
        nbytes = x.numel() * 2 + n_out * (2 + 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_out * 9 / BF16_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        iters = SMALL_TIMING_ITERS if bound < 0.01 else TIMING_ITERS
        row = {"bound_ms": bound,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        x_nchw = x.permute(0, 3, 1, 2)
        for key, fn in (
                ("ms", lambda: cuda_pooling.max_pooling_offsets(
                    x, 3, 3, (2, 2))),
                ("plain_ms", lambda: pooling.max_pooling_plain(
                    x, 3, 3, (2, 2))),
                ("library_ms", lambda: F.max_pool2d(
                    x_nchw, 3, 2, ceil_mode=True, return_indices=True))):
            row[key], row[key[:-2] + "host_ms"] = _median_ms(
                torch, fn, flush, cycles_per_ms, iters)
        row["vector_width"] = cuda_pooling.vector_width(x)
        rows[label] = row
        say("   %s %s bf16: kernel %.4f ms (host enqueue %.4f ms), plain "
            "%.4f ms, max_pool2d %.4f ms, bound %.4f ms (%.1f MB moved), "
            "%.0f%% of bound, %d channels a thread; %d samples; %s"
            % (label, shape, row["ms"], row["host_ms"], row["plain_ms"],
               row["library_ms"], bound, nbytes / 1e6,
               100 * bound / row["ms"], row["vector_width"], iters, card))
    return rows


def kernel_record(rows, max_err, in_model):
    """The pooling kernel's entry of the ``{"kernels": [...]}`` line:
    times per batch-64 dispatch, summed over the three AlexNet pools."""
    rec = {k: sum(r[k] for r in rows.values())
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    rec["host_enqueue_ms"] = sum(r["host_ms"] for r in rows.values())
    rec["in_model_ms"] = sum(in_model[k] for k in rows)
    rec["max_abs_err"] = max_err
    rec["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                      for r in rows.values())
                       else "operations")
    return rec


def _post(conn, body, ctype, path="/predict"):
    conn.request("POST", path, body=body,
                 headers={"Content-Type": ctype})
    resp = conn.getresponse()
    return resp.status, resp.read()


def _request(conn, x, as_json):
    """One /predict round trip; returns (status, outputs, argmax or
    None, seconds)."""
    import numpy
    t0 = time.perf_counter()
    if as_json:
        # integer pixels: a compact JSON body, parsed into float32
        status, raw = _post(conn, json.dumps(
            {"inputs": x.astype(int).tolist()}), "application/json")
        doc = json.loads(raw) if status == 200 else {}
        out = numpy.asarray(doc.get("outputs", []), numpy.float32)
        argmax = doc.get("argmax")
    else:
        buf = io.BytesIO()
        numpy.save(buf, x)
        status, raw = _post(conn, buf.getvalue(),
                            "application/octet-stream")
        out = numpy.load(io.BytesIO(raw)) if status == 200 else None
        argmax = None
    dt = time.perf_counter() - t0
    if status != 200:
        raise RuntimeError("/predict answered %d: %r" % (status, raw[:300]))
    return out, argmax, dt


def _prob_errors(pairs):
    """Max |a - b| and max |log a - log b| over ``(a, b)`` pairs of
    softmax rows (probabilities floored at 1e-30 before the log)."""
    import numpy

    def log(p):
        return numpy.log(numpy.maximum(p.astype(numpy.float64), 1e-30))
    return (max(float(numpy.abs(a - b).max()) for a, b in pairs),
            max(float(numpy.abs(log(a) - log(b)).max()) for a, b in pairs))


def phase_serve(torch, card, cycles_per_ms):
    import numpy
    from znicz_tpu_torch.core import telemetry
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.export import write_package
    from znicz_tpu_torch.ops import cuda_pooling
    from znicz_tpu_torch.samples import alexnet
    from znicz_tpu_torch.serving import engine as engine_mod
    from znicz_tpu_torch.serving.server import ServingServer

    t0 = time.perf_counter()
    manifest, arrays = alexnet.init_package(seed=0)
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = write_package(manifest, arrays, os.path.join(SMOKE_DIR,
                                                        "alexnet.zip"))
    n_params = sum(v.size for k, v in arrays.items() if "zero_filter" not in k)
    say("== serve: AlexNet package, %d parameters, %.1f MB zip, built in "
        "%.2f s" % (n_params, os.path.getsize(path) / 1e6,
                    time.perf_counter() - t0))
    del arrays
    # a batch of 64 227x227x3 float32 images is 39.6 MB of .npy
    root.common.serving.max_body_bytes = 256 << 20
    telemetry.enable()
    t0 = time.perf_counter()
    engine = engine_mod.InferenceEngine(path, max_batch=64, device="cuda")
    say("   engine loaded and warmed (buckets %s) in %.2f s"
        % (list(engine.buckets), time.perf_counter() - t0))
    rand = numpy.random.RandomState(1)
    images = rand.randint(-128, 128, (64,) + engine.sample_shape).astype(
        numpy.float32)
    server = ServingServer(engine, port=0).start()
    replies = []
    try:
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=300)
        # the main path: every count to 0 just before, read just after
        cuda_pooling.LAUNCHES = 0
        cuda_pooling.LAUNCHES_WIDE = cuda_pooling.LAUNCHES_NARROW = 0
        dispatches0 = engine.dispatches
        n_requests = 0
        for _ in range(2):
            for n in (1, 3, 17, 64):
                for as_json in (True, False):
                    out, argmax, _ = _request(conn, images[:n], as_json)
                    n_requests += 1
                    if out.shape != (n, 1000) or \
                            not numpy.isfinite(out).all():
                        raise RuntimeError("reply of shape %s for %d rows"
                                           % (out.shape, n))
                    if numpy.abs(out.sum(axis=1) - 1).max() > 1e-5:
                        raise RuntimeError("softmax rows do not sum to 1")
                    if argmax is not None and \
                            argmax != out.argmax(axis=1).tolist():
                        raise RuntimeError("argmax disagrees with outputs")
                    replies.append((n, out))
        launches = cuda_pooling.LAUNCHES
        by_width = {WIDE: cuda_pooling.LAUNCHES_WIDE,
                    NARROW: cuda_pooling.LAUNCHES_NARROW}
        dispatches = engine.dispatches - dispatches0
        say("   %d requests answered 200: %d dispatches, %d kernel launches "
            "(%s)" % (n_requests, dispatches, launches, by_width))
        if launches == 0 or launches != 3 * dispatches:
            raise RuntimeError("expected 3 max_pooling_offsets launches per "
                               "dispatch, got %d for %d dispatches"
                               % (launches, dispatches))
        if by_width[NARROW] or sum(by_width.values()) != launches:
            raise RuntimeError("AlexNet's pools must launch at 16-byte "
                               "vectors: %s" % by_width)
        lat = {}
        for n, count in ((1, 30), (64, 10)):
            lat[n] = sorted(_request(conn, images[:n], False)[2] * 1e3
                            for _ in range(count))
        conn.close()
    finally:
        server.stop()

    # reference: the port's plain forward on the CPU, same package, on
    # the first two rows and the last row of every reply size
    rows = (0, 1, 2, 16, 63)
    t0 = time.perf_counter()
    cpu = engine_mod.InferenceEngine(path, buckets=(len(rows),),
                                     warmup=False, device="cpu")
    ref = cpu.predict(images[list(rows)])
    # the same forward in float64 on the CPU, to tell the card's error
    # from the CPU's own
    with torch.inference_mode():
        ref64 = engine_mod.forward(
            cpu.layers, [{k: v.double() if v.is_floating_point() else v
                          for k, v in p.items()} for p in cpu.params],
            torch.from_numpy(images[list(rows)]).double()).numpy()
    del cpu
    got = [(out[[i for i in rows if i < n]], ref[[k for k, i in
                                                  enumerate(rows) if i < n]])
           for n, out in replies]
    err = _prob_errors(got)
    # row 0 from every reply size, card against card: a spread here is
    # the card's, one only against the CPU is the CPU's
    spread = _prob_errors([(out[:1], replies[0][1][:1])
                           for _, out in replies])
    by_size = ["%d: %.3g" % (n, _prob_errors([pair])[1])
               for (n, _), pair in zip(replies, got)]
    # the control: the same rows on the card with TF32 let in
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = engine_mod.forward(
                engine.layers, engine.params,
                torch.from_numpy(images[list(rows)]).to("cuda")).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_err = _prob_errors([(tf32, ref)])
    say("   rows %s of every reply against the CPU plain forward (%.2f s "
        "on the CPU): max |diff| %.3g, max |diff log p| %.3g; TF32 "
        "control: max |diff| %.3g, max |diff log p| %.3g"
        % (list(rows), time.perf_counter() - t0, err[0], err[1],
           tf32_err[0], tf32_err[1]))
    # 1e-4 relative on every probability: on an H100 80GB HBM3 at
    # 700 W, f32 read 1.4e-6 and the TF32 control 1.0e-3
    ref_err = _prob_errors([(ref, ref64)])
    card64 = _prob_errors([(out[[i for i in rows if i < n]],
                            ref64[[k for k, i in enumerate(rows) if i < n]])
                           for n, out in replies])
    say("   row 0 across the reply sizes on the card: max |diff log p| "
        "%.3g; against the CPU, reply by reply: %s; against the CPU in "
        "f64: the card %.3g, the CPU's f32 %.3g"
        % (spread[1], ", ".join(by_size), card64[1], ref_err[1]))
    _serve_repeats(torch, engine, images, rows, ref)
    if not err[1] <= LOG_P_TOL:
        raise RuntimeError("GPU rows differ from the CPU plain forward: "
                           "max |diff log p| %g > %g" % (err[1], LOG_P_TOL))

    # throughput: back-to-back batch-64 dispatches through the engine
    engine.predict(images)
    t0 = time.perf_counter()
    for _ in range(20):
        engine.predict(images)
    dt = time.perf_counter() - t0
    say("   throughput: %.1f images/s (20 batch-64 engine dispatches, "
        "host .npy in and out, %.2f ms each); %s"
        % (20 * 64 / dt, dt / 20 * 1e3, card))
    for n, ms in sorted(lat.items()):
        say("   HTTP .npy request latency, %d row(s), %d sequential "
            "requests: p50 %.2f ms, p99 %.2f ms; %s"
            % (n, len(ms), ms[len(ms) // 2],
               ms[min(len(ms) - 1, int(round(0.99 * (len(ms) - 1))))],
               card))
    retry_launches = _serve_retry(torch, engine, images, card)
    return by_width, _layer_breakdown(torch, engine, images, card,
                                      cycles_per_ms), retry_launches


def _serve_repeats(torch, engine, images, rows, ref):
    """At each reply size of the requests, the engine's forward of the
    same padded batch dispatched ``SERVE_REPEATS`` times: every max
    pool's output and the softmax rows must be bit-identical from one
    dispatch to the next and to ``engine.predict``'s.  Then the witness:
    the same forward with ``cudnn.deterministic``, its rows against the
    CPU's ``ref`` and whether its bits equal the default's."""
    import numpy
    from znicz_tpu_torch.serving.engine import apply_layer
    pools = [i for i, e in enumerate(engine.layers)
             if e["type"] == "max_pooling"]
    names = [engine.layers[i].get("name", "pool%d" % i) for i in pools]

    def run(x):
        outs = []
        y = x
        with torch.inference_mode():
            for i, (entry, p) in enumerate(zip(engine.layers,
                                               engine.params)):
                y = apply_layer(entry, p, y)
                if i in pools:
                    outs.append(y.clone())
        return outs + [y]

    witness = []
    for n in (1, 3, 17, 64):
        bucket = engine.bucket_for(n)
        x = numpy.zeros((bucket,) + images.shape[1:], numpy.float32)
        x[:n] = images[:n]
        xd = torch.from_numpy(x).to("cuda")
        first = run(xd)
        for _ in range(SERVE_REPEATS - 1):
            for name, a, b in zip(names + ["softmax"], first, run(xd)):
                if not _bits_equal(torch, a, b):
                    raise RuntimeError(
                        "the same batch of %d rows gave other bits at %s "
                        "on another dispatch (max |diff| %g)"
                        % (bucket, name, _max_abs_diff(a, b)))
        out = first[-1][:n].cpu().numpy()
        if not numpy.array_equal(out.view(numpy.uint32), engine.predict(
                images[:n]).view(numpy.uint32)):
            raise RuntimeError("engine.predict of %d rows gave other bits "
                               "than its layer-by-layer forward" % n)
        torch.backends.cudnn.deterministic = True
        try:
            det = run(xd)[-1][:n].cpu().numpy()
        finally:
            torch.backends.cudnn.deterministic = False
        idx = [i for i in rows if i < n]
        witness.append("%d: %s, %.3g" % (
            n, "same bits" if numpy.array_equal(
                det.view(numpy.uint32), out.view(numpy.uint32))
            else "other bits", _prob_errors([(det[idx], ref[[
                k for k, i in enumerate(rows) if i < n]])])[1]))
    say("   the same batch dispatched %d times at each reply size: every "
        "max pool's output and the softmax rows bit-identical, and equal "
        "to engine.predict's; with cudnn.deterministic, by reply size "
        "(bits against the default's, max |diff log p| against the "
        "CPU): %s" % (SERVE_REPEATS, "; ".join(witness)))


def _layer_breakdown(torch, engine, images, card, cycles_per_ms):
    """Device time per layer of one batch-64 forward (CUDA events,
    median of 10), plus the host->device copy of the batch.

    After the copy the device spins for four times the host's enqueue
    of a warm forward, so the host has queued every layer before the
    device starts the first: no layer's window holds a wait on the
    host.  Raises if the host's enqueue ever reaches the spin."""
    from znicz_tpu_torch.serving.engine import apply_layer
    names = [e.get("name", e["type"]) for e in engine.layers]
    samples = {k: [] for k in ["h2d"] + names}
    host = []
    spin_ms = None
    gc.disable()  # no collection inside a forward
    with torch.inference_mode():
        for _ in range(11):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(names) + 3)]
            ev[0].record()
            y = torch.from_numpy(images).to("cuda")
            ev[1].record()
            if spin_ms is not None:
                torch.cuda._sleep(int(spin_ms * cycles_per_ms))
            t0 = time.perf_counter()
            ev[2].record()
            for i, (entry, p) in enumerate(zip(engine.layers,
                                               engine.params)):
                y = apply_layer(entry, p, y)
                ev[i + 3].record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            if spin_ms is None:  # the first forward sets the spin
                spin_ms = 4 * host.pop()
                continue
            samples["h2d"].append(ev[0].elapsed_time(ev[1]))
            for i, k in enumerate(names):
                samples[k].append(ev[i + 2].elapsed_time(ev[i + 3]))
    gc.enable()
    if max(host) >= spin_ms:
        raise RuntimeError("the host took %.4f ms to enqueue a forward, the "
                           "device spin lasts %.4f ms" % (max(host), spin_ms))
    ms = {k: statistics.median(v) for k, v in samples.items()}
    say("   per-layer device ms, batch 64, host ahead by a %.2f ms spin "
        "(%s): %s" % (spin_ms, card, json.dumps(
            {k: round(v, 4) for k, v in ms.items()})))
    say("   one forward: the host enqueues it in %.4f ms (median), the "
        "device runs it in %.4f ms"
        % (statistics.median(host), sum(ms[k] for k in names)))
    say("   peak device memory: %.1f MB"
        % (torch.cuda.max_memory_allocated() / 1e6))
    return ms


def _bits_equal(torch, a, b):
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bits(a), _bits(b))


def _check_backward(torch, x, err_buf, ky, kx, sliding, use_abs, label):
    """The backward kernel against its plain version, bit for bit, on
    offsets from the forward kernel over ``x`` and a gradient taken from
    ``err_buf`` (a flat buffer longer than the gradient: from its second
    element where ``x`` lies off a 16-byte boundary, else its first).
    Returns ``(max |difference|, nonzero cells, (instantiation, width))``."""
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    _, offs = cuda_pooling.max_pooling_offsets(x, ky, kx, sliding, use_abs)
    n = offs.numel()
    err = (err_buf[1:n + 1] if x.data_ptr() % 16 else err_buf[:n]).view(
        offs.shape)
    wide = cuda_pooling_backward.LAUNCHES_WIDE
    grad = cuda_pooling_backward.max_pooling_offsets_backward(
        err, offs, tuple(x.shape), ky, kx, sliding)
    width = WIDE if cuda_pooling_backward.LAUNCHES_WIDE > wide else NARROW
    want = pooling.max_pooling_backward_plain(
        err, offs, tuple(x.shape), ky, kx, sliding)
    torch.cuda.synchronize()
    if not _bits_equal(torch, grad, want):
        raise RuntimeError(
            "backward kernel disagrees with its plain version: %s use_abs=%s "
            "(%d cells differ)" % (label, use_abs,
                                   (grad != want).sum().item()))
    plan = cuda_pooling_backward.launch_plan(
        tuple(x.shape), x.element_size(),
        cuda_pooling_backward.vector_width(err, offs, grad), ky, kx,
        tuple(sliding))
    kind = "unstaged" if not plan.staged else \
        "stride 2" if plan.stride2 else "runtime stride"
    return _max_abs_diff(grad, want), (want != 0).sum().item(), (kind, width)


def _backward_edge_cases(torch, gen):
    """``(label, x, ky, kx, sliding)`` at the backward kernel's tile
    edges, in f32, f16, bf16 and f64, the first two once more with the
    input (so the gradient) off a 16-byte boundary, and windows that
    no shared memory holds."""
    b, h, w, c, ky, kx, sliding = BACKWARD_UNSTAGED
    yield ("backward unstaged %s f32" % (BACKWARD_UNSTAGED,),
           _tied(torch, gen, (b, h, w, c), torch.float32), ky, kx, sliding)
    for b, h, w, c, ky, kx, sliding in BACKWARD_TILE_EDGES:
        for dtype in (torch.float32, torch.float16, torch.bfloat16,
                      torch.float64):
            yield ("backward tile edge %s %s" % (
                (b, h, w, c, ky, kx, sliding), dtype),
                _tied(torch, gen, (b, h, w, c), dtype), ky, kx, sliding)
    for (b, h, w, c, ky, kx, sliding), dtype in zip(
            BACKWARD_TILE_EDGES[:2], (torch.float32, torch.bfloat16)):
        n = b * h * w * c
        buf = _tied(torch, gen, (n + 1,), dtype)
        yield ("backward tile edge %s %s, unaligned" % (
            (b, h, w, c, ky, kx, sliding), dtype),
            buf[1:].view(b, h, w, c), ky, kx, sliding)


def phase_backward_kernel(torch):
    """The backward kernel against its plain version, bit for bit, on the
    forward's cases and its own tile edges: offsets from the forward
    kernel, a random gradient in the input's type (stored off a 16-byte
    boundary where the input is), values and zero cells alike.  Both
    staged instantiations must be among the cases at both widths, and
    the unstaged one at 16-byte vectors.  Returns the max
    |difference|."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_cases = 0
    max_err = 0.0
    taken = {(k, wd): 0 for k in ("stride 2", "runtime stride")
             for wd in (WIDE, NARROW)}
    taken[("unstaged", WIDE)] = 0
    cases = [c[:5] for c in _cases(torch, gen)] + list(
        _backward_edge_cases(torch, gen))
    for label, x, ky, kx, sliding in cases:
        kinds = set()
        nonzero = 0
        for use_abs in (False, True):
            buf = torch.randn(x.numel() + 1, generator=gen,
                              device="cuda").to(x.dtype)
            err, nz, kind = _check_backward(torch, x, buf, ky, kx, sliding,
                                            use_abs, label)
            max_err = max(max_err, err)
            nonzero += nz
            kinds.add(kind)
            taken[kind] = taken.get(kind, 0) + 1
            n_cases += 1
        say("   backward %s: bit-equal (%d nonzero cells), max and maxabs, "
            "%s" % (label, nonzero, "; ".join(
                "%s, %s" % k for k in sorted(kinds))))
    # STL-10's pool1 through the unstaged instantiations as well
    with _Unstaged():
        for label, x in _stl_unstaged_cases(torch, gen):
            nonzero = 0
            for use_abs in (False, True):
                buf = torch.randn(x.numel() + 1, generator=gen,
                                  device="cuda").to(x.dtype)
                err, nz, kind = _check_backward(torch, x, buf, 3, 3, (2, 2),
                                                use_abs, label)
                max_err = max(max_err, err)
                nonzero += nz
                taken[kind] = taken.get(kind, 0) + 1
                n_cases += 1
                if kind != ("unstaged", WIDE):
                    raise RuntimeError("%s launched %s, not unstaged at %s"
                                       % (label, kind, WIDE))
            say("   backward %s: bit-equal (%d nonzero cells), max and "
                "maxabs, unstaged, %s" % (label, nonzero, WIDE))
    say("== backward kernel: max_pooling_offsets_backward bit-equal to "
        "max_pooling_backward_plain on %d cases; by instantiation and "
        "width: %s" % (n_cases, ", ".join(
            "%s at %s: %d" % (k + (n,)) for k, n in taken.items())))
    missing = [k for k, n in taken.items() if not n]
    if missing:
        raise RuntimeError("no case of the backward kernel took %s"
                           % missing)
    return max_err


def _max_abs_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel_diffs(got, want):
    """max |got - want| / max |want| over each parameter tensor of two
    ``[{"w", "b"}]`` lists."""
    out = {}
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            ref = w[k].double()
            diff = (g[k].double() - ref).abs().max()
            out["%d%s" % (i, k)] = (diff / ref.abs().max()).item()
    return out


def _worst(rel, net):
    """``(the largest of a _rel_diffs dict, "layer:type.w|b" of it)``."""
    key = max(rel, key=rel.get)
    return rel[key], "%s:%s.%s" % (key[:-1], net.specs[int(key[:-1])].type,
                                  key[-1])


def _set_pool_impl(net, impl):
    for spec in net.specs:
        if spec.kind == "pool":
            spec.impl = impl


def _set_dropout(net, ratio):
    for spec in net.specs:
        if spec.kind == "dropout":
            spec.ratio = ratio


def _step_updates(net, x, labels):
    """One step from the loaded state: ``(loss, n_err, updates, weight
    moves)`` on the host in float64.  ``updates`` are the updates before
    they were added (the velocity slot, which the state starts at zero);
    ``weight moves`` are ``p_after - p_before``, which also carry the
    rounding of the weights' storage."""
    if any(bool(slots["vel"].any()) for s in net.state
           for slots in s.values()):
        raise RuntimeError("the step must start from zero velocity")
    before = [{k: v.double().cpu() for k, v in p.items()}
              for p in net.params]
    m = net.step(x, labels)
    upd = [{k: slots["vel"].double().cpu() for k, slots in s.items()}
           for s in net.state]
    moves = [{k: v.double().cpu() - before[i][k] for k, v in p.items()}
             for i, p in enumerate(net.params)]
    return m["loss"].item(), int(m["n_err"]), upd, moves


def _dropping_backward(real, region):
    """``real`` (the backward kernel's wrapper) with the gradient of the
    windows at ``region`` of every pool set to 0 — a wrong backward, the
    step check's control."""
    def backward(err, offsets, x_shape, ky, kx, sliding):
        err = err.clone()
        err[region] = 0
        return real(err, offsets, x_shape, ky, kx, sliding)
    return backward


def _gather_check(torch, net, sd0, x, lbl):
    """One step under the kernels and one under "gather" from ``sd0``,
    then the controls: the kernel step with a backward that drops the
    last row of windows (the bottom-edge cells lose one covering
    window), and one that drops one window of one image."""
    from znicz_tpu_torch.ops import cuda_pooling_backward
    real = cuda_pooling_backward.max_pooling_offsets_backward
    runs = (("kernels", "offsets", None), ("gather", "gather", None),
            ("control, last window row dropped", "offsets",
             (slice(None), -1)),
            ("control, one window of one image dropped", "offsets",
             (0, -1, -1)))
    steps = {}
    for name, impl, region in runs:
        _set_pool_impl(net, impl)
        net.load_state_dict(sd0)
        if region is not None:
            cuda_pooling_backward.max_pooling_offsets_backward = \
                _dropping_backward(real, region)
        try:
            steps[name] = _step_updates(net, x, lbl)[:3]
        finally:
            cuda_pooling_backward.max_pooling_offsets_backward = real
    _set_pool_impl(net, "offsets")
    want = steps.pop("gather")
    readings = {k: _worst(_rel_diffs(v[2], want[2]), net)
                for k, v in steps.items()}
    say("   step, batch %d, against the gather step (loss %.9g, n_err %d): "
        "loss, n_err, max rel diff of the update of the worst tensor: %s"
        % (TRAIN_BATCH, want[0], want[1], "; ".join(
            "%s: %.9g, %d, %.3g (%s)" % ((k,) + steps[k][:2] + readings[k])
            for k in steps)))
    if steps["kernels"][:2] != want[:2]:
        raise RuntimeError("the kernel step and the gather step differ in "
                           "loss or n_err")
    if not readings["kernels"][0] <= GATHER_STEP_RTOL:
        raise RuntimeError("kernel and gather steps' updates differ by "
                           "%g > %g" % (readings["kernels"][0],
                                        GATHER_STEP_RTOL))
    control = readings["control, last window row dropped"][0]
    if not control > GATHER_STEP_RTOL:
        raise RuntimeError("a backward that drops the last row of windows "
                           "reads %g, within the %g limit: the check cannot "
                           "see it" % (control, GATHER_STEP_RTOL))


def _trace(torch, net, x, labels):
    """One forward and backward of ``net`` from its state on the batch
    ``x`` (no dropout), recorded on the host: each conv's strict-relu
    gate (output > 0) and the gradient at its output, each max pool's
    winners, and how far the sums of the first conv's weight gradient
    cancel (the largest sum of |terms|, |dL/dpre| |input| over images
    and positions, of a weight over the largest |gradient|: an error u
    relative to each term moves the gradient by up to that many times
    u of its largest value)."""
    from znicz_tpu_torch.ops import conv as conv_ops
    from znicz_tpu_torch.ops import pooling as pool_ops
    from znicz_tpu_torch.parallel import fused
    spec = net.specs[0]
    if spec.kind != "conv" or spec.activation != "strict_relu":
        raise RuntimeError("expected a strict-relu conv first, got %s" % spec)
    real_conv, real_pool = conv_ops.forward, pool_ops.max_pooling_train
    rec = {"inputs": [], "gates": [], "grads": [], "winners": []}

    def conv(x_in, *args, **kwargs):
        y = real_conv(x_in, *args, **kwargs)
        i = len(rec["gates"])
        rec["inputs"].append(x_in.detach())
        rec["gates"].append(y.detach() > 0)
        rec["grads"].append(None)
        y.register_hook(lambda g: rec["grads"].__setitem__(i, g))
        return y

    def pool(*args, **kwargs):
        values, offsets = real_pool(*args, **kwargs)
        rec["winners"].append(offsets.cpu())
        return values, offsets
    dtype = net.params[0]["w"].dtype
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in fused._apply_weight_masks(net.params, net.specs)]
    conv_ops.forward, pool_ops.max_pooling_train = conv, pool
    try:
        with torch.enable_grad():
            loss, _ = fused._loss_and_stats(
                leaves, torch.as_tensor(x).to(net.device, dtype),
                torch.as_tensor(labels).to(net.device, torch.int32),
                net.specs)
            grad, = torch.autograd.grad(loss, [leaves[0]["w"]])
    finally:
        conv_ops.forward, pool_ops.max_pooling_train = real_conv, real_pool
    d_pre = rec["grads"][0] * rec["gates"][0]  # strict relu's gradient
    w = leaves[0]["w"].detach().requires_grad_()
    with torch.enable_grad():
        y_abs = real_conv(rec["inputs"][0].abs(), w, None, spec.ky, spec.kx,
                          spec.padding, spec.sliding, include_bias=False)
        terms, = torch.autograd.grad(y_abs, [w], d_pre.abs())
    return {"gates": [g.cpu() for g in rec["gates"]],
            "grads": [g.double().cpu() for g in rec["grads"]],
            "winners": rec["winners"],
            "cancellation": (terms.max() / grad.abs().max()).item()}


def _trace_diffs(got, exact):
    """Per conv: gates that differ and max |dL/d(output) difference| over
    the largest; per pool: winners that differ."""
    return {"gates": ["%d" % (g != e).sum().item()
                      for g, e in zip(got["gates"], exact["gates"])],
            "grads": ["%.3g" % ((g - e).abs().max() / e.abs().max()).item()
                      for g, e in zip(got["grads"], exact["grads"])],
            "winners": ["%d" % (g != e).sum().item()
                        for g, e in zip(got["winners"], exact["winners"])]}


def _cpu_check(torch, net, sd0, data, labels):
    """One batch-2 step, dropout 0, on the card in f32 and with TF32 let
    in, and on the CPU's plain path in f32 and f64, from ``sd0``: the
    updates against the CPU's f64 ones, tensor by tensor, with the
    forward's gates and winners and the backward's gradients at each
    conv traced beside."""
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.parallel import fused
    from znicz_tpu_torch.samples import alexnet
    x, lbl = data[:2], labels[:2]
    t0 = time.perf_counter()
    steps, traces = {}, {}
    for dtype in (numpy.float64, numpy.float32):
        name = "cpu %s" % numpy.dtype(dtype).name
        ref = fused.FusedNet(alexnet.make_layers(), (227, 227, 3),
                             rand=prng.RandomGenerator().seed(0),
                             pool_impl="offsets", device="cpu", dtype=dtype)
        ref.load_state_dict({k: sd0[k] for k in ("params", "opt",
                                                 "hypers")})
        _set_dropout(ref, 0.0)
        traces[name] = _trace(torch, ref, x, lbl)
        steps[name] = _step_updates(ref, x, lbl)
        del ref
    cpu_s = time.perf_counter() - t0
    _set_dropout(net, 0.0)
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            net.load_state_dict(sd0)
            if not tf32:
                traces["card f32"] = _trace(torch, net, x, lbl)
            steps["card tf32" if tf32 else "card f32"] = _step_updates(
                net, x, lbl)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        _set_dropout(net, 0.5)
    exact = steps.pop("cpu float64")
    upd = {k: _worst(_rel_diffs(v[2], exact[2]), net)
           for k, v in steps.items()}
    moves = {k: _worst(_rel_diffs(v[3], exact[3]), net)
             for k, v in steps.items()}
    say("   step, batch 2, dropout 0, against the CPU's plain path in f64 "
        "(loss %.9g; %.1f s on the CPU): loss, then max rel diff of the "
        "worst tensor's update before it is added, and of p_after - "
        "p_before: %s" % (exact[0], cpu_s, "; ".join(
            "%s: %.9g, %.3g (%s), %.3g (%s)" % ((k, steps[k][0]) + upd[k] +
                                                moves[k])
            for k in steps)))
    t_exact = traces.pop("cpu float64")
    n_gates = [g.numel() for g in t_exact["gates"]]
    n_wins = [w.numel() for w in t_exact["winners"]]
    say("   traced against the CPU's f64 step: the first conv's weight "
        "gradient sums terms up to %.4g times its largest value; conv by "
        "conv (of %s gates), strict-relu gates that differ, max |diff| of "
        "the gradient at the output over its largest; pool by pool (of %s "
        "winners), winners that differ: %s" % (
            t_exact["cancellation"], "/".join(map(str, n_gates)),
            "/".join(map(str, n_wins)), "; ".join(
                "%s: gates %s, gradients %s, winners %s" % (
                    (k,) + tuple("/".join(v) for v in _trace_diffs(
                        t, t_exact).values()))
                for k, t in traces.items())))
    rel = {k: _rel_diffs(v[2], exact[2]) for k, v in steps.items()}
    bound = {t: CPU_STEP_RATIO * max(r, CPU_STEP_FLOOR)
             for t, r in rel["cpu float32"].items()}
    say("   the updates tensor by tensor (card f32 / card tf32 / cpu f32; "
        "bound %g times the CPU's f32, at least %g): %s" % (
            CPU_STEP_RATIO, CPU_STEP_RATIO * CPU_STEP_FLOOR, ", ".join(
                "%s %s" % (t, "/".join("%.3g" % rel[k][t] for k in (
                    "card f32", "card tf32", "cpu float32")))
                for t in bound)))
    over = [t for t in bound if not rel["card f32"][t] <= bound[t]]
    if over:
        raise RuntimeError("the card's f32 update is farther from the "
                           "CPU's f64 one than %g times the CPU's f32 at %s"
                           % (CPU_STEP_RATIO, ", ".join(over)))
    seen = [t for t in bound if rel["card tf32"][t] > bound[t]]
    say("   the TF32 control exceeds the bound at %d of %d tensors"
        % (len(seen), len(bound)))
    if not seen:
        raise RuntimeError("the TF32 control stays within the bound at "
                           "every tensor: the check cannot see it")


class _Prototypes(object):
    """``alexnet.prototype_images`` drawn once, in a thread started
    before the build and joined after it (:meth:`join`): numpy's draws
    release the GIL, so the draw overlaps ``nvcc``, and it is over
    before any phase that times the card or computes a reference on
    the host (a CPU forward under load once read 1.75e-4 in log p from
    the same forward unloaded).  A draw of ``n`` images is the prefix
    of any larger draw with the same seed, classes and size, so while
    installed (``with``) the workflow phase's loader (2,304 images, in
    its run and in the resumed run), the alexnet_units phase's and the
    train phase (2,048) take copies of this one draw."""

    def __init__(self, alexnet, n, seed=0x1337, n_classes=TRAIN_CLASSES,
                 size=227):
        self.alexnet, self.real = alexnet, alexnet.prototype_images
        self.n, self.key = n, (seed, n_classes, size)
        self.data = self.labels = self.error = None
        self._thread = threading.Thread(target=self._draw, daemon=True)
        self._thread.start()

    def _draw(self):
        try:
            self.data, self.labels = self.real(self.n, *self.key)
        except Exception as e:   # raised again by __enter__
            self.error = e

    def __call__(self, n, seed=0x1337, n_classes=10, size=227):
        if (seed, n_classes, size) != self.key or n > self.n:
            return self.real(n, seed, n_classes, size)
        return self.data[:n].copy(), self.labels[:n].copy()

    def join(self):
        self._thread.join()
        if self.error is not None:
            raise RuntimeError("the prototype draw failed") from self.error

    def __enter__(self):
        self.join()
        self.alexnet.prototype_images = self
        return self

    def __exit__(self, *exc):
        self.alexnet.prototype_images = self.real


class _Readbacks(object):
    """Counts reads of CUDA tensors back to the host while installed:
    ``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()``, ``bool()``,
    ``int()``, ``float()``, ``index()``, ``.to()`` a CPU device and
    ``copy_`` into a CPU tensor, keyed by ``where()`` at the call
    (``counts``).  Beside them, ``syncs`` counts the synchronizing CUDA
    operations that PyTorch's sync debug mode reports, those inside
    its own ops included.  It swaps ``torch.Tensor``'s methods and
    ``warnings.showwarning`` and puts them back; nothing in the package
    reads it."""

    METHODS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
               "__float__", "__index__", "to", "copy_")

    def __init__(self, torch, where):
        self.torch, self.where = torch, where
        self.counts = collections.Counter()
        self.syncs = collections.Counter()
        self.paused = False
        self._saved = {}
        self._warnings = None

    def _showwarning(self, message, *args, **kwargs):
        if "synchroniz" in str(message):
            if not self.paused:
                self.syncs[self.where()] += 1
            return
        self._real_showwarning(message, *args, **kwargs)

    def _wrap(self, name, real):
        tensor = self.torch.Tensor

        def method(t, *args, **kwargs):
            out = real(t, *args, **kwargs)
            if self.paused:
                return out
            if name == "to":
                hit = t.is_cuda and isinstance(out, tensor) and \
                    not out.is_cuda
            elif name == "copy_":
                hit = not t.is_cuda and isinstance(args[0], tensor) and \
                    args[0].is_cuda
            else:
                hit = t.is_cuda
            if hit:
                self.counts[self.where()] += 1
            return out
        return method

    def __enter__(self):
        import warnings
        tensor = self.torch.Tensor
        for name in self.METHODS:
            self._saved[name] = tensor.__dict__.get(name)
            setattr(tensor, name, self._wrap(name, getattr(tensor, name)))
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")
        self._real_showwarning = warnings.showwarning
        warnings.showwarning = self._showwarning
        if self.torch.cuda.is_available():
            self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.torch.cuda.is_available():
            self.torch.cuda.set_sync_debug_mode("default")
        self._warnings.__exit__(*exc)
        for name, real in self._saved.items():
            if real is None:
                delattr(self.torch.Tensor, name)
            else:
                setattr(self.torch.Tensor, name, real)


def _zero_counts():
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    for mod in (cuda_pooling, cuda_pooling_backward):
        mod.LAUNCHES = mod.LAUNCHES_WIDE = mod.LAUNCHES_NARROW = 0
    pooling.PLAIN_CUDA_CALLS = 0


def _counts():
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    return {"forward": cuda_pooling.LAUNCHES,
            "forward_by_width": {WIDE: cuda_pooling.LAUNCHES_WIDE,
                                 NARROW: cuda_pooling.LAUNCHES_NARROW},
            "backward": cuda_pooling_backward.LAUNCHES,
            "backward_by_width": {
                WIDE: cuda_pooling_backward.LAUNCHES_WIDE,
                NARROW: cuda_pooling_backward.LAUNCHES_NARROW},
            "plain_on_card": pooling.PLAIN_CUDA_CALLS}


def _workflow_argv(snapdir, *extra):
    argv = ["alexnet", "--fused", "pool_impl=offsets"]
    for key, value in (("loader.minibatch_size", TRAIN_BATCH),
                       ("loader.n_train", WORKFLOW_TRAIN),
                       ("loader.n_valid", WORKFLOW_VALID),
                       ("decision.max_epochs", WORKFLOW_EPOCHS),
                       ("snapshotter.directory", snapdir)):
        argv += ["--config", "alexnet.%s=%s" % (key, value)]
    return argv + list(extra)


class _WorkflowProbe(object):
    """Wrappers around the workflow's units, installed for the phase
    and put back after it (nothing in the package reads them): the
    trainer's initialize (the run's units, and its initial state), every
    ``FusedNet.run_window_indexed`` call of the run's net (its epoch,
    row indices on the card, sizes and hypers), the loader's shuffled
    TRAIN order at each epoch's first window (a host copy), the host's
    wall time of each TRAIN window, each ``predict_with_idx`` of the
    run's net, the decision at each segment end, and each snapshot
    written."""

    def __init__(self, torch):
        import numpy
        from znicz_tpu_torch.loader.base import VALID
        from znicz_tpu_torch.parallel import fused
        from znicz_tpu_torch.units import decision, fused_trainer, nn_units
        self.torch = torch
        self.ctx = {}
        self.calls, self.windows, self.segments, self.snapshots = \
            [], [], [], []
        self.orders = {}
        self.predicts = 0
        self.readbacks = _Readbacks(torch, self._where)
        probe = self
        trainer_cls = fused_trainer.FusedForwardBackward
        owners = {"initialize": trainer_cls,
                  "_run_train_window": trainer_cls,
                  "run_window_indexed": fused.FusedNet,
                  "predict_with_idx": fused.FusedNet,
                  "on_last_minibatch": decision.DecisionGD,
                  "export": nn_units.NNSnapshotterToFile}
        #: the real functions, put back by :meth:`close`
        self.real = real = {name: getattr(owner, name)
                            for name, owner in owners.items()}

        def initialize(unit, device=None, **kwargs):
            real["initialize"](unit, device=device, **kwargs)
            probe.ctx.update(trainer=unit, net=unit.net, wf=unit.workflow,
                             loader=unit.loader_unit)
            if "state0" not in probe.ctx:
                probe.readbacks.paused = True
                probe.ctx["state0"] = unit.net.state_dict()
                probe.readbacks.paused = False

        def _run_train_window(unit):
            t0 = time.perf_counter()
            epoch = unit.loader_unit.epoch_number
            # the host's TRAIN order of the epoch, before its first window
            probe.orders.setdefault(
                epoch, unit.loader_unit.train_indices.copy())
            n = real["_run_train_window"](unit)
            probe.windows.append((epoch, n, t0, time.perf_counter() - t0))
            return n

        def run_window_indexed(net, idx_s, batch_sizes, hypers_s):
            if net is probe.ctx.get("net"):
                probe.calls.append((probe.ctx["loader"].epoch_number,
                                    idx_s.clone(), list(batch_sizes),
                                    hypers_s))
            return real["run_window_indexed"](net, idx_s, batch_sizes,
                                              hypers_s)

        def predict_with_idx(net, x):
            if net is probe.ctx.get("net"):
                probe.predicts += 1
            return real["predict_with_idx"](net, x)

        def on_last_minibatch(d):
            real["on_last_minibatch"](d)
            c = d.minibatch_class
            # VALID is served after the loader counted the epoch
            probe.segments.append({
                "epoch": d.epoch_number - (c == VALID), "class": c,
                "n_err": d.epoch_n_err[c],
                "n": d.epoch_n_evaluated_samples[c],
                "confusion": numpy.array(d.confusion_matrixes[c]),
                "max_err_sum": d.max_err_y_sums[c],
                "t": time.perf_counter()})

        def export(snap):
            t0 = time.perf_counter()
            probe.readbacks.paused = True
            try:
                path = real["export"](snap)
            finally:
                probe.readbacks.paused = False
            probe.snapshots.append((snap.workflow.loader.epoch_number, path,
                                    time.perf_counter() - t0))
            return path

        wrappers = {"initialize": initialize,
                    "_run_train_window": _run_train_window,
                    "run_window_indexed": run_window_indexed,
                    "predict_with_idx": predict_with_idx,
                    "on_last_minibatch": on_last_minibatch,
                    "export": export}
        self._owners = owners
        for name, owner in owners.items():
            setattr(owner, name, wrappers[name])

    def _where(self):
        """The segment being served: (class, epoch) while the run's
        workflow runs, else "outside"."""
        wf, loader = self.ctx.get("wf"), self.ctx.get("loader")
        if wf is None or not wf._running:
            return "outside"
        return (loader.minibatch_class, loader.epoch_number)

    def close(self):
        for name, owner in self._owners.items():
            setattr(owner, name, self.real[name])


def phase_workflow(torch, card):
    """Full-width AlexNet trained by the workflow CLI on the card
    (``python -m znicz_tpu_torch alexnet --fused pool_impl=offsets``,
    run in this process): 3 epochs at batch 128 with the kernel
    launches, the readbacks and the segment stats checked; the run's
    windows replayed on a fresh FusedNet from its initial state, bit
    for bit; the run resumed from its newest snapshot of an epoch
    before the last, bit for bit.  Returns the run's launches and each
    epoch's TRAIN images/s."""
    import shutil
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import prng

    snapdir = os.path.join(HERE, "build", "znicz_tpu_torch",
                           "workflow_snapshots")
    shutil.rmtree(snapdir, ignore_errors=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probe = _WorkflowProbe(torch)
    try:
        say("== workflow: python -m znicz_tpu_torch %s"
            % " ".join(_workflow_argv("build/...")))
        _zero_counts()
        prng.get(1), prng.get(2)   # the run's streams, made if new
        prng0 = prng.states()
        t0 = time.perf_counter()
        with probe.readbacks:
            cli.main(_workflow_argv(snapdir))
        launches = _counts()
        run_s = time.perf_counter() - t0
        run = dict(probe.ctx)
        steps = sum(len(c[2]) for c in probe.calls)
        _check_workflow_run(probe, launches, steps, run_s, card)
        # the resilience phase's reference: this run's segments and its
        # final state on the host
        reference = {"segments": list(probe.segments),
                     "state": run["net"].state_dict(), "prng": prng0}
        _replay_workflow(torch, probe, run, card)
        _resume_workflow(torch, probe, run, cli, snapdir)
    finally:
        probe.close()
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(snapdir, ignore_errors=True)
    return launches, probe.rates, reference


def _check_workflow_run(probe, launches, steps, run_s, card):
    """The run's segments, launches, readbacks and timings."""
    import numpy
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    segs = probe.segments
    got = [(s["epoch"], s["class"], s["n"]) for s in segs]
    want = [(e, c, n) for e in range(WORKFLOW_EPOCHS)
            for c, n in ((TRAIN, WORKFLOW_TRAIN), (VALID, WORKFLOW_VALID))]
    if got != want:
        raise RuntimeError("segments (epoch, class, rows) %s, not %s"
                           % (got, want))
    for s in segs:
        if not (isinstance(s["n_err"], int) and 0 <= s["n_err"] <= s["n"]
                and numpy.isfinite(s["max_err_sum"])
                and int(s["confusion"].sum()) == s["n"]):
            raise RuntimeError("segment stats out of range: %s" % s)
    _check_trained_rows(probe)
    per_epoch = -(-WORKFLOW_TRAIN // TRAIN_BATCH)
    valid_mbs = -(-WORKFLOW_VALID // TRAIN_BATCH) * WORKFLOW_EPOCHS
    say("   %d train steps in %d windows and %d VALID minibatches in "
        "%.2f s (the CLI, from its start: data, FusedNet, snapshots); "
        "epoch_n_err by epoch (train, valid): %s; snapshots after "
        "epochs %s (%s s each)" % (
            steps, len(probe.calls), probe.predicts, run_s,
            [(s["n_err"], t["n_err"]) for s, t in zip(segs[::2], segs[1::2])],
            [e for e, _, _ in probe.snapshots],
            " / ".join("%.2f" % dt for _, _, dt in probe.snapshots)))
    if steps != per_epoch * WORKFLOW_EPOCHS or probe.predicts != valid_mbs:
        raise RuntimeError("%d steps and %d VALID minibatches, not %d and "
                           "%d" % (steps, probe.predicts,
                                   per_epoch * WORKFLOW_EPOCHS, valid_mbs))
    say("   launches: %s" % launches)
    if launches["forward"] != 3 * (steps + valid_mbs) or \
            launches["backward"] != 3 * steps or \
            launches["forward_by_width"][NARROW] or \
            launches["backward_by_width"][NARROW] or \
            launches["plain_on_card"]:
        raise RuntimeError("expected 3 forward launches a train step and a "
                           "VALID minibatch, 3 backward a step, all at "
                           "16-byte vectors, no plain pooling on the card; "
                           "got %s" % launches)
    counts = probe.readbacks.counts
    train_rb = [counts[(TRAIN, e)] for e in range(WORKFLOW_EPOCHS)]
    valid_rb = sum(v for k, v in counts.items()
                   if k != "outside" and k[0] == VALID)
    syncs = probe.readbacks.syncs
    say("   host readbacks: TRAIN segment by epoch %s; VALID %d in %d "
        "minibatches (the evaluator's stats, one each); %d outside the "
        "run, snapshots not counted; synchronizing CUDA operations "
        "(sync debug mode): TRAIN segment by epoch %s, VALID %d, outside "
        "the run %d" % (
            train_rb, valid_rb, valid_mbs, counts["outside"],
            [syncs[(TRAIN, e)] for e in range(WORKFLOW_EPOCHS)],
            sum(v for k, v in syncs.items()
                if k != "outside" and k[0] == VALID), syncs["outside"]))
    if train_rb != [1] * WORKFLOW_EPOCHS:
        raise RuntimeError("expected one readback a TRAIN segment, got %s"
                           % train_rb)
    probe.rates = []
    for e in range(WORKFLOW_EPOCHS):
        wins = [w for w in probe.windows if w[0] == e]
        seg_s = segs[2 * e]["t"] - wins[0][2]
        probe.rates.append(WORKFLOW_TRAIN / seg_s)
        say("   epoch %d: TRAIN %d images in %.3f s, %.1f images/s; host "
            "wall ms per window (steps): %s; %s" % (
                e + 1, WORKFLOW_TRAIN, seg_s, WORKFLOW_TRAIN / seg_s,
                ", ".join("%.1f (%d)" % (1e3 * w[3], w[1]) for w in wins),
                card))


def _check_trained_rows(probe):
    """The row indices each epoch's windows read on the card, in order
    and without the -1 padding, are the loader's shuffled TRAIN order of
    that epoch on the host, a permutation of the TRAIN rows (after the
    VALID ones): the staged index buffers reached the card intact."""
    import numpy
    train_rows = numpy.arange(WORKFLOW_VALID, WORKFLOW_VALID + WORKFLOW_TRAIN)
    for e in range(WORKFLOW_EPOCHS):
        order = probe.orders.get(e)
        if order is None:
            raise RuntimeError("epoch %d: no TRAIN order recorded" % (e + 1))
        got = numpy.concatenate([c[1].cpu().numpy().ravel()
                                 for c in probe.calls if c[0] == e])
        got = got[got >= 0]
        if not (numpy.sort(order) == train_rows).all():
            raise RuntimeError("epoch %d: the loader's TRAIN order is not a "
                               "permutation of rows %d-%d" % (
                                   e + 1, train_rows[0], train_rows[-1]))
        if got.shape != order.shape or not (got == order).all():
            bad = numpy.flatnonzero(got[:len(order)] != order[:len(got)])
            raise RuntimeError(
                "epoch %d: the windows read %d rows on the card, the "
                "loader's order has %d; first differing position %s"
                % (e + 1, len(got), len(order),
                   bad[:1].tolist() or "past the shorter"))
    if probe.orders[0].tolist() == probe.orders[1].tolist():
        raise RuntimeError("the TRAIN order was not reshuffled between "
                           "epochs 1 and 2")
    say("   trained rows: each epoch's windows read the loader's shuffled "
        "TRAIN order on the card, row for row (%d rows an epoch)"
        % len(train_rows))


def _replay_workflow(torch, probe, run, card):
    """The run's windows on a fresh FusedNet from the run's initial
    state: every epoch's TRAIN stats (n_err, confusion, max_err_sum)
    and, after each epoch, the VALID n_err of ``predict_with_idx`` over
    the VALID rows equal the run's; the final parameters and optimizer
    state equal bit for bit.  Each epoch's windows are timed from a
    synchronized device to their readback: the same work as the run's
    TRAIN segment without the control plane."""
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.parallel import fused
    t0 = time.perf_counter()
    trainer, loader = run["trainer"], run["loader"]
    net = fused.FusedNet(trainer.layers, tuple(trainer.input.shape[1:]),
                         pool_impl="offsets", device=run["net"].device,
                         rand=prng.RandomGenerator().seed(1))
    net.load_state_dict(run["state0"])
    data = loader.original_data.mem
    labels = numpy.asarray(loader.original_labels, numpy.int32)
    net.set_dataset(data, labels)
    run_window = probe.real["run_window_indexed"]
    predict = probe.real["predict_with_idx"]
    rates = []
    for e in range(WORKFLOW_EPOCHS):
        torch.cuda.synchronize()
        t_epoch = time.perf_counter()
        for epoch, idx, sizes, hypers_s in probe.calls:
            if epoch == e:
                run_window(net, idx, sizes, hypers_s)
        acc = net.window_acc_host()
        rates.append(WORKFLOW_TRAIN / (time.perf_counter() - t_epoch))
        net.reset_window_acc()
        seg = probe.segments[2 * e]
        if int(acc["n_err"][0]) != seg["n_err"] or \
                int(acc["n_err"][1]) != seg["n"] or \
                not (acc["confusion"] == seg["confusion"]).all() or \
                float(acc["max_err_sum"]) != seg["max_err_sum"]:
            raise RuntimeError("epoch %d: the replay's TRAIN stats %s differ "
                               "from the run's %s" % (e + 1, acc, seg))
        n_err = 0
        for s in range(0, WORKFLOW_VALID, TRAIN_BATCH):
            _, idx = predict(net, data[s:min(s + TRAIN_BATCH,
                                             WORKFLOW_VALID)])
            n_err += int((idx.cpu().numpy() != labels[s:s + len(idx)]).sum())
        if n_err != probe.segments[2 * e + 1]["n_err"]:
            raise RuntimeError("epoch %d: predict_with_idx over the VALID "
                               "rows gives n_err %d, the run %d" % (
                                   e + 1, n_err,
                                   probe.segments[2 * e + 1]["n_err"]))
    _state_bits_equal(torch, net, run["net"], "the replay")
    say("   replay: %d windows on a fresh FusedNet from the run's initial "
        "state: TRAIN stats and VALID n_err equal epoch by epoch, "
        "parameters and optimizer state bit-equal (%.2f s); its TRAIN "
        "epochs, the same windows driven directly, one readback each: "
        "%s images/s; %s" % (len(probe.calls), time.perf_counter() - t0,
                            " ".join("%.1f" % r for r in rates), card))


def _state_bits_equal(torch, got, want, what):
    for name, a, b in (("params", got.params, want.params),
                       ("optimizer state", got.state, want.state)):
        for i, (pa, pb) in enumerate(zip(a, b)):
            for k in pb:
                ta, tb = pa[k], pb[k]
                if isinstance(tb, dict):
                    same = all(_bits_equal(torch, ta[s], tb[s]) for s in tb)
                else:
                    same = _bits_equal(torch, ta, tb)
                if not same:
                    raise RuntimeError("%s: %s %d:%s differ from the run's"
                                       % (what, name, i, k))


def _resume_workflow(torch, probe, run, cli, snapdir):
    """The CLI again with ``--snapshot`` of the newest snapshot written
    after an epoch before the last (the snapshotter writes after the
    epochs that improved): its final parameters and optimizer state
    bit-equal to the run's, and its last epochs' stats the run's."""
    t0 = time.perf_counter()
    earlier = [(e, path) for e, path, _ in probe.snapshots
               if e < WORKFLOW_EPOCHS]
    if not earlier:
        raise RuntimeError("no snapshot before the last epoch: %s"
                           % probe.snapshots)
    epoch, path = max(earlier)
    segs = list(probe.segments)
    probe.ctx.clear()
    probe.ctx["state0"] = None   # not captured again
    del probe.segments[:]
    cli.main(_workflow_argv(snapdir, "--snapshot", path))
    resumed = probe.ctx["net"]
    want = [(s["epoch"], s["class"], s["n_err"]) for s in segs
            if s["epoch"] >= epoch]
    got = [(s["epoch"], s["class"], s["n_err"]) for s in probe.segments]
    if got != want:
        raise RuntimeError("the resumed run's segments %s, the run's %s"
                           % (got, want))
    _state_bits_equal(torch, resumed, run["net"], "the resumed run")
    say("   resume: --snapshot %s (after epoch %d) trained epochs %s: "
        "segment stats equal, parameters and optimizer state bit-equal to "
        "the run's (%.2f s)" % (
            os.path.basename(path), epoch,
            ", ".join(str(e) for e in range(epoch + 1, WORKFLOW_EPOCHS + 1)),
            time.perf_counter() - t0))


#: where the resilience checks write crash reports (git-ignored)
CRASH_DIR = os.path.join(HERE, "build", "znicz_tpu_torch", "crash_reports")
#: the chaos run's rule: the 4th TRAIN dispatch is epoch 2's last
#: window (two a epoch), after epoch 2's mid-epoch snapshot
CHAOS_RULE = "{'fused.dispatch': {'kind': 'crash', 'at': 4}}"
#: the memory a finished supervised run may leave allocated on the card
RESILIENCE_MEMORY_SLACK = 64 << 20


class _ResilienceProbe(object):
    """Wrappers for the resilience phase's supervised run, put back by
    :meth:`close`; they hold no reference to a workflow, so the crashed
    attempt's tensors can be freed.  They record the launch counts at
    each attempt's trainer initialize, the segments as
    :class:`_WorkflowProbe` records them, each snapshot's suffix and
    seconds, the state each auto-resume restores, the injected fault's
    time and the restart's first window's, and the finished run's
    final state on the host.  Readbacks are counted by segment with the
    snapshots paused, except the trainer's ``epoch_acc`` drain."""

    def __init__(self, torch):
        import weakref
        import numpy
        from znicz_tpu_torch import launcher
        from znicz_tpu_torch.core import faults
        from znicz_tpu_torch.loader.base import VALID
        from znicz_tpu_torch.units import decision, fused_trainer, nn_units
        self.attempt_counts, self.segments, self.snapshots = [], [], []
        self.restored, self.final_state = [], None
        self.t_fault = self.t_resumed = None
        self._wf = lambda: None
        self.readbacks = _Readbacks(torch, self._where)
        probe = self
        trainer_cls = fused_trainer.FusedForwardBackward
        owners = {"initialize": trainer_cls,
                  "_run_train_window": trainer_cls,
                  "epoch_acc": trainer_cls,
                  "on_last_minibatch": decision.DecisionGD,
                  "export": nn_units.NNSnapshotterToFile,
                  "_find_resume_state": launcher.Launcher,
                  "main": launcher.Launcher,
                  "check": faults}
        self.real = real = {name: getattr(owner, name) if name != "epoch_acc"
                            else owner.__dict__[name]
                            for name, owner in owners.items()}

        def initialize(unit, device=None, **kwargs):
            real["initialize"](unit, device=device, **kwargs)
            probe._wf = weakref.ref(unit.workflow)
            probe.attempt_counts.append(_counts())

        def _run_train_window(unit):
            if probe.t_fault is not None and probe.t_resumed is None:
                probe.t_resumed = time.perf_counter()
            return real["_run_train_window"](unit)

        def epoch_acc(unit):
            paused, probe.readbacks.paused = probe.readbacks.paused, False
            try:
                return real["epoch_acc"].fget(unit)
            finally:
                probe.readbacks.paused = paused

        def on_last_minibatch(d):
            real["on_last_minibatch"](d)
            c = d.minibatch_class
            probe.segments.append({
                "epoch": d.epoch_number - (c == VALID), "class": c,
                "n_err": d.epoch_n_err[c],
                "n": d.epoch_n_evaluated_samples[c],
                "confusion": numpy.array(d.confusion_matrixes[c]),
                "max_err_sum": d.max_err_y_sums[c]})

        def export(snap):
            t0 = time.perf_counter()
            paused, probe.readbacks.paused = probe.readbacks.paused, True
            try:
                path = real["export"](snap)
            finally:
                probe.readbacks.paused = paused
            probe.snapshots.append((snap.suffix or "midepoch",
                                    time.perf_counter() - t0))
            return path

        def _find_resume_state(launcher_, wf):
            state = real["_find_resume_state"](launcher_, wf)
            probe.restored.append(None if state is None else (
                state["suffix"], state["units"]["loader"]["epoch_number"]))
            return state

        def main(launcher_, **kwargs):
            wf = real["main"](launcher_, **kwargs)
            probe.final_state = wf.fused_trainer.net.state_dict()
            return wf

        def check(site):
            try:
                return real["check"](site)
            except faults.FaultInjectedError:
                probe.t_fault = time.perf_counter()
                raise

        wrappers = {"initialize": initialize,
                    "_run_train_window": _run_train_window,
                    "epoch_acc": property(epoch_acc,
                                          real["epoch_acc"].fset),
                    "on_last_minibatch": on_last_minibatch,
                    "export": export, "_find_resume_state": _find_resume_state,
                    "main": main, "check": check}
        self._owners = owners
        for name, owner in owners.items():
            setattr(owner, name, wrappers[name])

    def _where(self):
        wf = self._wf()
        if wf is None or not wf._running:
            return "outside"
        return (wf.loader.minibatch_class, wf.loader.epoch_number)

    def close(self):
        for name, owner in self._owners.items():
            setattr(owner, name, self.real[name])


def phase_resilience(torch, card, reference):
    """Full-width AlexNet through the supervised workflow CLI on the
    card, crashed mid-epoch by an injected fault and resumed from the
    ``midepoch`` snapshot: the workflow phase's run is the reference.
    Returns the run's launches."""
    import shutil
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import faults, prng
    from znicz_tpu_torch.core.config import root

    snapdir = os.path.join(HERE, "build", "znicz_tpu_torch",
                           "resilience_snapshots")
    shutil.rmtree(snapdir, ignore_errors=True)
    root.common.health.crash_dir = CRASH_DIR
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    argv = _workflow_argv(
        snapdir, "--max-restarts", "2", "--restart-backoff-ms", "0",
        "--config", "alexnet.snapshotter.window_interval=1",
        "--config", "common.faults.enabled=True",
        "--config", "common.faults.rules=" + CHAOS_RULE)
    say("== resilience: python -m znicz_tpu_torch %s"
        % " ".join(a if "snapshots" not in a else "...=build/..."
                   for a in argv))
    probe = _ResilienceProbe(torch)
    try:
        # the streams as the workflow phase's run found them: the same
        # weight draw and TRAIN orders
        prng.restore(reference["prng"])
        _zero_counts()
        t0 = time.perf_counter()
        with probe.readbacks:
            cli.main(argv)
        launches = _counts()
        run_s = time.perf_counter() - t0
        final_state = probe.final_state
        probe.final_state = None
        _check_resilience_run(probe, launches, reference, final_state, run_s,
                              card)
    finally:
        probe.close()
        torch.backends.cudnn.deterministic = False
        faults.disable()
        faults.reset()
        object.__setattr__(root.common.faults, "rules", type(root)(
            "root.common.faults.rules"))
        shutil.rmtree(snapdir, ignore_errors=True)
    del final_state
    gc.collect()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    say("   memory: %.1f MB allocated on the card before the phase, %+.1f "
        "MB after the supervised run returned (limit %+.1f MB): the crashed "
        "attempt's net and 1.3 GB dataset were freed"
        % (mem0 / 1e6, grown / 1e6, RESILIENCE_MEMORY_SLACK / 1e6))
    if grown > RESILIENCE_MEMORY_SLACK:
        raise RuntimeError("the supervised run left %d bytes allocated on "
                           "the card" % grown)
    return launches


def _check_resilience_run(probe, launches, reference, final_state, run_s,
                          card):
    """One fault, one restart from epoch 2's ``midepoch`` snapshot, the
    workflow phase's segments and final state bit for bit, the
    restart's launches, the readbacks by segment."""
    import numpy
    from znicz_tpu_torch.core import faults
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    st = faults.status()
    injected = sum(s["injected"] for s in st["sites"].values())
    attempts = len(probe.attempt_counts)
    say("   %d fault(s) injected (%s), %d attempt(s), restored %s; %.2f s "
        "(the CLI, from its start); %s" % (
            injected, st["sites"].get("fused.dispatch"), attempts,
            probe.restored, run_s, card))
    if injected != 1 or attempts != 2 or probe.restored != [("midepoch", 1)]:
        raise RuntimeError("expected 1 injected fault, 1 restart and a resume "
                           "from epoch 2's midepoch snapshot")
    keys = ("epoch", "class", "n_err", "n", "max_err_sum")
    got = [[s[k] for k in keys] for s in probe.segments]
    want = [[s[k] for k in keys] for s in reference["segments"]]
    if got != want or not all(
            (a["confusion"] == b["confusion"]).all()
            for a, b in zip(probe.segments, reference["segments"])):
        raise RuntimeError("the resumed run's segments %s differ from the "
                           "workflow phase's %s" % (got, want))
    _trees_bits_equal(final_state, reference["state"], "the resumed run")
    say("   segments (epoch, class, n_err, rows, max_err_sum) and "
        "confusions equal to the workflow phase's run: %s; the final "
        "parameters, optimizer state and dropout generator state bit-equal"
        % [tuple(g[:4]) for g in got])
    restart = {k: launches[k] - probe.attempt_counts[1][k]
               for k in ("forward", "backward", "plain_on_card")}
    restart_wide = {k: launches[k + "_by_width"][WIDE] -
                    probe.attempt_counts[1][k + "_by_width"][WIDE]
                    for k in ("forward", "backward")}
    per_epoch = -(-WORKFLOW_TRAIN // TRAIN_BATCH)
    steps = per_epoch // 2 + per_epoch          # epoch 2's last window, 3
    valid_mbs = 2 * -(-WORKFLOW_VALID // TRAIN_BATCH)
    say("   launches: the run %s; the restart: forward %d, backward %d, "
        "16-byte %s" % (launches, restart["forward"], restart["backward"],
                        restart_wide))
    if restart["forward"] != 3 * (steps + valid_mbs) or \
            restart["backward"] != 3 * steps or \
            restart_wide != {"forward": restart["forward"],
                             "backward": restart["backward"]} or \
            launches["forward_by_width"][NARROW] or \
            launches["backward_by_width"][NARROW] or \
            launches["plain_on_card"]:
        raise RuntimeError("expected the restart to launch 3 forward a step "
                           "and a VALID minibatch and 3 backward a step, all "
                           "16-byte, no plain pooling; got %s" % launches)
    counts = probe.readbacks.counts
    train_rb = [counts[(TRAIN, e)] for e in range(WORKFLOW_EPOCHS)]
    mid = [t for suffix, t in probe.snapshots if suffix == "midepoch"]
    say("   TRAIN segment readbacks by epoch %s (1 a segment + 1 a "
        "mid-epoch drain); VALID %d; %d mid-epoch snapshots (%s s), %d "
        "after an epoch (%s s); crash to the restart's first window %.2f "
        "s; %s" % (
            train_rb, sum(v for k, v in counts.items()
                          if k != "outside" and k[0] == VALID), len(mid),
            " / ".join("%.2f" % t for t in mid),
            len(probe.snapshots) - len(mid),
            " / ".join("%.2f" % t for s, t in probe.snapshots
                       if s != "midepoch"),
            probe.t_resumed - probe.t_fault, card))
    if train_rb != [2] * WORKFLOW_EPOCHS or len(mid) != WORKFLOW_EPOCHS:
        raise RuntimeError("expected 2 readbacks a TRAIN segment and one "
                           "mid-epoch snapshot an epoch; got %s and %d"
                           % (train_rb, len(mid)))
    if not numpy.isfinite([s["max_err_sum"] for s in probe.segments]).all():
        raise RuntimeError("a segment's max_err_sum is not finite")


def _health_and_rollback(torch, net, x, lbl, card):
    """The train phase's net (batch 128): 4 steps with the health
    monitor at interval 1 and the halt policy, each check clean with one
    readback and its sums of squares within 1e-6 of a CPU f64
    recompute; ``FusedNNRollback`` storing the state on the card,
    2 steps, the state restored bit for bit; a NaN weight halting its
    step with a crash report under ``build/`` and no restart.  Returns
    the launches of these steps."""
    import types
    from znicz_tpu_torch import launcher
    from znicz_tpu_torch.core import health
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.core.workflow import Workflow
    from znicz_tpu_torch.units.fused_trainer import FusedNNRollback

    root.common.health.update({"enabled": True, "interval": 1,
                               "policy": "halt", "crash_dir": CRASH_DIR})
    health.reset()
    rb = _Readbacks(torch, lambda: "check")
    _zero_counts()
    try:
        ms = []
        for _ in range(4):
            net.step(x, lbl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with rb:
                report = health.check_training_step(
                    None, steps=1, params=net.params, updates=net.state,
                    context="fused_step")
            ms.append(1e3 * (time.perf_counter() - t0))
            if report is None or report["non_finite"]:
                raise RuntimeError("a health check was not clean: %s"
                                   % report)
        checks = health.monitor().checks
        if checks != 4 or rb.counts["check"] != 4:
            raise RuntimeError("expected 4 checks with one readback each, "
                               "got %d checks, %d readbacks"
                               % (checks, rb.counts["check"]))
        worst = 0.0
        for name, tree in (("params", net.params), ("updates", net.state)):
            sq = sum(float((t.detach().cpu().double() ** 2).sum())
                     for t in health._leaves(tree))
            worst = max(worst, abs(report["norms"][name] ** 2 - sq) / sq)
        say("== resilience, health on the train phase's net: 4 checks "
            "clean, 1 readback each, %s ms a check (%.3f after a synchronized "
            "step); sums of squares against a CPU f64 recompute: %.3g "
            "relative at most; %s" % (
                " / ".join("%.3f" % m for m in ms), statistics.median(ms),
                worst, card))
        if worst > 1e-6:
            raise RuntimeError("a sum of squares is %g off the CPU's" % worst)

        # rollback: a history on the card, restored bit for bit
        rollback = FusedNNRollback(
            Workflow(None), trainer=types.SimpleNamespace(net=net,
                                                          gd_proxies=[]),
            minus_steps=1)
        rollback.improved = True
        t0 = time.perf_counter()
        rollback.run()
        torch.cuda.synchronize()
        store_ms = 1e3 * (time.perf_counter() - t0)
        stored = net.state_dict()
        net.step(x, lbl)
        net.step(x, lbl)
        rollback.improved = False
        t0 = time.perf_counter()
        rollback.run()
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        history = health._leaves([rollback._history[0]["params"],
                                  rollback._history[0]["opt"]])
        if not all(t.device.type == net.device.type for t in history):
            raise RuntimeError("the rollback's history is not on the card")
        _trees_bits_equal(net.state_dict(), stored, "the rolled-back net")
        say("   rollback: the state stored on the card (%d tensors, %.1f MB) "
            "in %.2f ms, restored after 2 steps in %.2f ms (its NaN probe's "
            "readback included): parameters, optimizer slots and generator "
            "bit-equal; %s" % (
                len(history), sum(t.numel() * t.element_size()
                                  for t in history) / 1e6,
                store_ms, restore_ms, card))

        # a NaN weight: the step's check halts, and no restart follows
        with torch.no_grad():
            net.params[0]["w"].view(-1)[0] = float("nan")
        attempts = []

        def run(load, main):
            attempts.append(1)
            net.step(x, lbl)
            health.check_training_step(None, steps=1, params=net.params,
                                       updates=net.state)

        mod = types.ModuleType("health_halt")
        mod.__file__ = __file__
        mod.run = run
        try:
            launcher.run_supervised(mod, max_restarts=2,
                                    restart_backoff_ms=0.0,
                                    device=net.device.type)
        except health.HealthViolationError as e:
            report_dir = e.crash_report
        else:
            raise RuntimeError("the NaN step did not halt")
        if len(attempts) != 1 or not report_dir or \
                not report_dir.startswith(CRASH_DIR) or \
                not os.path.isfile(os.path.join(report_dir, "report.json")):
            raise RuntimeError("expected one attempt and a crash report "
                               "under build/: %d, %s"
                               % (len(attempts), report_dir))
        say("   NaN weight: HealthViolationError on that step (%s), a crash "
            "report under build/, run_supervised did not restart it; %s"
            % (health.monitor().last_violation["reason"], card))
    finally:
        root.common.health.enabled = False
        health.reset()
    return _counts()


def _serve_retry(torch, engine, images, card):
    """The serve phase's engine under ``serving.forward`` faults every
    3rd invocation: replies bit-equal to a dispatch without faults, each
    fault retried, the breaker closed, every dispatch launching the
    forward kernel once a max pool.  Returns the forward launches."""
    import numpy
    from znicz_tpu_torch.core import faults
    from znicz_tpu_torch.ops import cuda_pooling
    want = engine.predict(images)
    clean_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.predict(images)
        clean_ms.append(1e3 * (time.perf_counter() - t0))
    faults.reset()
    faults.install("serving.forward", kind="io", every=3)
    faults.enable()
    cuda_pooling.LAUNCHES = 0
    cuda_pooling.LAUNCHES_WIDE = cuda_pooling.LAUNCHES_NARROW = 0
    dispatches0 = engine.dispatches
    ms = []
    try:
        for _ in range(6):
            t0 = time.perf_counter()
            got = engine.predict(images)
            ms.append(1e3 * (time.perf_counter() - t0))
            if not numpy.array_equal(got.view(numpy.uint32),
                                     want.view(numpy.uint32)):
                raise RuntimeError("a reply under retries differs from the "
                                   "dispatch without faults")
        launches = cuda_pooling.LAUNCHES
        dispatches = engine.dispatches - dispatches0
        st = faults.status()
        breaker = engine._bucket_breaker(engine.bucket_for(len(images)))
    finally:
        faults.disable()
        faults.reset()
    say("== resilience, serving retry: 6 batch-%d dispatches, %d faults "
        "injected, %d retries, breaker %s; %d forward launches, 16-byte %d; "
        "ms a reply %s (the retried ones include the 5 ms backoff), without "
        "faults %s; replies bit-equal; %s" % (
            len(images), st["sites"]["serving.forward"]["injected"],
            st["retries"], breaker.state if breaker else None, launches,
            cuda_pooling.LAUNCHES_WIDE, " / ".join("%.2f" % m for m in ms),
            " / ".join("%.2f" % m for m in clean_ms), card))
    pools = sum(layer.get("type") == "max_pooling" for layer in engine.layers)
    if st["sites"]["serving.forward"]["injected"] != 2 or \
            st["retries"] != 2 or dispatches != 6 or \
            (breaker is not None and breaker.state != "closed") or \
            launches != pools * dispatches or \
            cuda_pooling.LAUNCHES_WIDE != launches:
        raise RuntimeError("expected 2 faults retried, the breaker closed "
                           "and %d forward launches (16-byte) a dispatch"
                           % pools)
    return launches


def _units_argv(snapdir, wf_file, *extra):
    return _sample_argv(wf_file, "mnistr", snapdir, UNITS_TRAIN,
                        UNITS_VALID, UNITS_BATCH, UNITS_EPOCHS, *extra)


#: the MNIST and CIFAR loaders' synthetic draws by (loader, TRAIN rows,
#: VALID rows): made once, every later loader of the same sizes takes a
#: copy of it
_DRAWS = {}


def _sample_argv(workflow, ns, snapdir, n_train, n_valid, batch, epochs,
                 *extra):
    """The CLI's arguments for a workflow trained on the MNIST loader's
    synthetic set, its config under ``root.<ns>``."""
    argv = [workflow]
    for key, value in (("loader.synthetic_train", n_train),
                       ("loader.synthetic_valid", n_valid),
                       ("loader.minibatch_size", batch),
                       ("decision.max_epochs", epochs),
                       ("snapshotter.directory", snapdir)):
        argv += ["--config", "%s.%s=%s" % (ns, key, value)]
    return argv + list(extra)


class _UnitsProbe(object):
    """Wrappers around the workflow engine, installed for the unit,
    autoencoder and MSE phases and put back after each (nothing in the
    package reads them): every workflow run (its workflow and host start
    and end times), the decision at each segment end (after its
    bookkeeping), each snapshot written (its epoch joined to the
    sample's prefix, since two epochs with equal errors would share a
    file name; the readbacks it
    makes are not counted), the MNIST and CIFAR loaders' synthetic
    draws, each made once (``_DRAWS``: a draw is a function of the
    sizes alone), and the STL-10 loader's decoded files, read once by
    directory (``_DRAWS`` too: the files do not change within a
    phase)."""

    def __init__(self, torch):
        import numpy
        from znicz_tpu_torch.core import workflow
        from znicz_tpu_torch.loader import loader_cifar, loader_mnist
        from znicz_tpu_torch.loader import loader_stl
        from znicz_tpu_torch.loader.base import VALID
        from znicz_tpu_torch.units import decision, nn_units
        self.runs, self.segments, self.snapshots = [], [], []
        self.ctx = {}
        self.readbacks = _Readbacks(torch, self._where)
        probe = self
        owners = {"run": workflow.Workflow,
                  "_on_last_minibatch": decision.DecisionBase,
                  "export": nn_units.NNSnapshotterToFile}
        self.real = real = {name: owner.__dict__[name]
                            for name, owner in owners.items()}
        loaders = (loader_mnist.MnistLoader, loader_cifar.CifarLoader)
        self.real_draws = {cls: cls.__dict__["_load_synthetic"]
                           for cls in loaders}
        self.stl = loader_stl.STL10FullBatchLoader
        # inherited (FullBatchImageLoader's): set on the class while
        # installed; what the class itself held is put back after
        self.saved_stl = self.stl.__dict__.get("load_data")
        real_stl = self.stl.load_data

        def run(wf):
            if wf.workflow is not None:   # a nested workflow
                return real["run"](wf)
            probe.ctx["wf"] = wf
            t0 = time.perf_counter()
            out = real["run"](wf)
            probe.runs.append({"wf": wf, "t0": t0,
                               "t1": time.perf_counter()})
            return out

        def on_last_minibatch(d):
            real["_on_last_minibatch"](d)
            c = d.minibatch_class
            probe.segments.append({
                "epoch": d.epoch_number - (c == VALID), "class": c,
                "n_err": d.epoch_n_err[c],
                "n": d.epoch_n_evaluated_samples[c],
                "confusion": numpy.array(d.confusion_matrixes[c]),
                "metrics": getattr(d, "epoch_metrics", (None,) * 3)[c],
                "unit_s": {u.name: u.run_time_ for u in d.workflow.units},
                "t": time.perf_counter()})

        def export(snap):
            t0 = time.perf_counter()
            epoch = snap.workflow.loader.epoch_number
            # the sample's prefix stays first: serve --latest finds it
            snap.prefix = "%s_epoch%d" % (
                re.sub(r"_epoch\d+$", "", snap.prefix), epoch)
            probe.readbacks.paused = True
            try:
                path = real["export"](snap)
            finally:
                probe.readbacks.paused = False
            probe.snapshots.append((epoch, path, t0,
                                    time.perf_counter() - t0))
            return path

        def _load_synthetic(loader):
            base = next(c for c in type(loader).__mro__
                        if c in probe.real_draws)
            key = (base.__name__, loader.synthetic_train,
                   loader.synthetic_valid)
            if key not in _DRAWS:
                probe.real_draws[base](loader)
                _DRAWS[key] = (list(loader.class_lengths),
                               loader.original_data.mem.copy(),
                               list(loader.original_labels))
                return
            lengths, data, labels = _DRAWS[key]
            loader.class_lengths[:] = lengths
            loader.original_data.reset(data.copy())
            loader._original_labels[:] = labels

        def load_stl(loader):
            key = ("stl10", os.path.abspath(loader.directory))
            if key not in _DRAWS:
                real_stl(loader)
                _DRAWS[key] = (
                    list(loader.class_lengths),
                    loader.original_data.mem.copy(),
                    list(loader.original_labels),
                    {c: list(k) for c, k in loader._keys.items()},
                    dict(loader._label_to_int),
                    set(loader._distinct_labels))
                return
            lengths, data, labels, keys, mapping, distinct = _DRAWS[key]
            loader.class_lengths[:] = lengths
            loader.original_data.reset(data.copy())
            loader._original_labels[:] = labels
            loader._keys = {c: list(k) for c, k in keys.items()}
            loader._label_to_int = dict(mapping)
            loader._distinct_labels = set(distinct)

        self._owners = owners
        for name, fn in (("run", run), ("_on_last_minibatch",
                                        on_last_minibatch),
                         ("export", export)):
            setattr(owners[name], name, fn)
        for cls in loaders:
            cls._load_synthetic = _load_synthetic
        self.stl.load_data = load_stl

    def _where(self):
        wf = self.ctx.get("wf")
        if wf is None or not wf._running:
            return "outside"
        return (wf.loader.minibatch_class, wf.loader.epoch_number)

    def reset(self):
        self.ctx.clear()
        del self.runs[:], self.segments[:], self.snapshots[:]

    def close(self):
        for name, owner in self._owners.items():
            setattr(owner, name, self.real[name])
        for cls, real in self.real_draws.items():
            cls._load_synthetic = real
        if self.saved_stl is not None:
            self.stl.load_data = self.saved_stl
        elif "load_data" in self.stl.__dict__:   # a second close
            del self.stl.load_data


def _units_state(wf):
    """Host copies of the run's final forward weights and biases, its GD
    units' optimizer Arrays and learning rates, the learning-rate
    adjuster's count where it has one, the prng streams' states (the
    loader's shuffles and the stochastic pools draw from them) and the
    dropout units' generator states, by name."""
    import numpy
    from znicz_tpu_torch.core import prng
    out = {}
    for key, st in prng.states().items():
        out["prng%s.key" % key] = numpy.array(st["np"][1])
        out["prng%s.pos" % key] = numpy.array([st["np"][2]])
    adjuster = getattr(wf, "lr_adjuster", None)
    if adjuster is not None:
        out["lr_adjuster._minibatches_count"] = numpy.array(
            [adjuster._minibatches_count])
    for gd in wf.gds:
        if gd is not None:
            out["%s.learning_rates" % gd.name] = numpy.array(
                [gd.learning_rate, gd.learning_rate_bias], numpy.float64)
    for unit in wf.forwards:
        if hasattr(unit, "generator_state"):   # a dropout unit's stream
            out["%s.generator_state" % unit.name] = unit.generator_state
    for unit in list(wf.forwards) + [g for g in wf.gds if g is not None]:
        for attr in ("weights", "bias", "gradient_weights_with_moment",
                     "gradient_bias_with_moment",
                     "accumulated_gradient_weights",
                     "accumulated_gradient_bias"):
            arr = getattr(unit, attr, None)
            if arr is not None and arr and not unit.has_linked_attr(attr):
                out["%s.%s" % (unit.name, attr)] = numpy.array(arr.mem)
    return out


def _units_equal(got, want, what):
    """Two :func:`_units_state` dicts, bit for bit."""
    import numpy
    if sorted(got) != sorted(want):
        raise RuntimeError("%s: arrays %s, the run's %s" % (
            what, sorted(got), sorted(want)))
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or g.dtype != w.dtype or \
                not numpy.array_equal(g.view(numpy.uint8),
                                      w.view(numpy.uint8)):
            raise RuntimeError("%s: %s differs from the run's" % (what, key))


def _units_segments(segs):
    return [(s["epoch"], s["class"], s["n_err"], s["n"],
             s["confusion"].tolist(), s["metrics"]) for s in segs]


def _units_run(probe, cli, prng, argv):
    """One CLI run from the phase's seeds; returns the run's record."""
    probe.reset()
    prng.get(1).seed(UNITS_SEED)
    prng.get(2).seed(UNITS_SEED + 1)
    cli.main(argv)
    if len(probe.runs) != 1:
        raise RuntimeError("expected one workflow run, got %d"
                           % len(probe.runs))
    run = dict(probe.runs[0])
    run.update(segments=list(probe.segments),
               snapshots=list(probe.snapshots), state=_units_state(run["wf"]))
    return run


def _units_rates(run, n_train):
    """Each epoch's TRAIN images/s on the host clock (from the previous
    segment's end, or the run's start, to the TRAIN segment's end, less
    the snapshot writes in it) and the host ms per minibatch over the
    whole run (less the snapshot writes)."""
    from znicz_tpu_torch.loader.base import TRAIN
    rates, start = [], run["t0"]
    for s in run["segments"]:
        if s["class"] == TRAIN:
            snap = sum(dt for _, _, t, dt in run["snapshots"]
                       if start <= t < s["t"])
            rates.append(n_train / (s["t"] - start - snap))
        start = s["t"]
    snap = sum(dt for _, _, _, dt in run["snapshots"])
    return rates, run["t1"] - run["t0"] - snap


def phase_units(torch, card, cycles_per_ms):
    """The MNIST conv sample (``root.mnistr_conv``: conv 64 5x5 -> max
    pool 2x2 -> conv 87 5x5 -> max pool 2x2 -> all2all_relu 791 ->
    softmax 10) trained by the unit-at-a-time graph through the workflow
    CLI (a workflow file building ``mnist.build(layers=
    root.mnistr_conv.layers)``, no ``--fused``), in this process, at
    minibatch 60 over the loader's synthetic set (``UNITS_TRAIN``
    TRAIN, ``UNITS_VALID`` VALID rows) for 2 epochs, f32 with TF32 off and
    ``cudnn.deterministic``: the kernel launches (two forward a
    minibatch, two backward a TRAIN minibatch, half at 16-byte vectors
    and half at one channel, no plain pooling on the card) and each
    epoch's stats are checked; a second run from the same seeds and a
    run resumed from the epoch-1 snapshot must end bit-equal to it; the
    same layers and data through ``--fused pool_impl=offsets`` are the
    yardstick; the first 4 TRAIN minibatches at full width in f64 on the
    card (the f64 kernels) against the CPU (the plain versions); the
    kernels' cold times at the MNIST shapes.  Returns the main run's
    launches and the timing rows."""
    import shutil
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import prng

    base = os.path.join(HERE, "build", "znicz_tpu_torch", "units")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    wf_file = os.path.join(base, "mnist_conv_wf.py")
    with open(wf_file, "w") as f:
        f.write("from znicz_tpu_torch.core.config import root\n"
                "from znicz_tpu_torch.samples import mnist\n\n\n"
                "def run(load, main):\n"
                "    load(mnist.build, layers=root.mnistr_conv.layers)\n"
                "    main()\n")
    train_mb = -(-UNITS_TRAIN // UNITS_BATCH)
    valid_mb = -(-UNITS_VALID // UNITS_BATCH)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probe = _UnitsProbe(torch)
    try:
        argv = _units_argv(os.path.join(base, "run"), wf_file)
        say("== units: python -m znicz_tpu_torch %s"
            % " ".join(_units_argv("build/...", "WF.py")))
        _zero_counts()
        with probe.readbacks:
            run = _units_run(probe, cli, prng, argv)
        launches = _counts()
        _check_units_run(torch, probe, run, launches, train_mb, valid_mb,
                         card)
        t0 = time.perf_counter()
        replay = _units_run(probe, cli, prng, _units_argv(
            os.path.join(base, "replay"), wf_file))
        if _units_segments(replay["segments"]) != \
                _units_segments(run["segments"]):
            raise RuntimeError("the replay's segment stats differ from the "
                               "run's")
        _units_equal(replay["state"], run["state"], "the replay")
        say("   replay: a second CLI run from the same seeds: each epoch's "
            "per-class n_err and confusion matrices, the final weights "
            "and optimizer Arrays bit-equal to the run's (%.2f s)"
            % (time.perf_counter() - t0))
        del replay
        _resume_units(probe, cli, prng, run, lambda *extra: _units_argv(
            os.path.join(base, "resumed"), wf_file, *extra))
        _fused_yardstick(torch, probe, cli, prng, run, base, wf_file, card)
    finally:
        probe.close()
        torch.backends.cudnn.deterministic = False
    del run
    gc.collect()
    _units_card_vs_cpu(torch)
    rows = _mnist_kernel_times(torch, card, cycles_per_ms)
    shutil.rmtree(base, ignore_errors=True)
    return launches, rows


def _check_units_run(torch, probe, run, launches, train_mb, valid_mb, card):
    """The MNIST conv run's segments, shapes, launches, readbacks and
    rates: 2 forward launches a minibatch and 2 backward a TRAIN
    minibatch, half at 16-byte vectors (pool1) and half at one channel
    (pool2)."""
    half_f, half_b = (train_mb + valid_mb) * UNITS_EPOCHS, \
        train_mb * UNITS_EPOCHS
    _check_graph_run(
        torch, probe, run, launches,
        {"forward": 2 * half_f,
         "forward_by_width": {WIDE: half_f, NARROW: half_f},
         "backward": 2 * half_b,
         "backward_by_width": {WIDE: half_b, NARROW: half_b},
         "plain_on_card": 0},
        "2 forward launches a minibatch and 2 backward a TRAIN minibatch, "
        "half at 16-byte vectors and half at one channel",
        (UNITS_TRAIN, UNITS_VALID, UNITS_BATCH, UNITS_EPOCHS),
        [(60, 24, 24, 64), (60, 12, 12, 64), (60, 8, 8, 87), (60, 4, 4, 87),
         (60, 791), (60, 10)], card, "unit graph")


def _check_graph_run(torch, probe, run, launches, want, said, sizes, shapes,
                     card, what):
    """A unit-graph run's segments (``sizes``: TRAIN rows, VALID rows,
    minibatch, epochs), its forwards' output ``shapes``, its launches
    (exactly ``want``, ``said`` in words), its readbacks and its rates;
    each epoch's TRAIN images/s and the run's seconds are kept in
    ``run``."""
    import numpy
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    n_train, n_valid, batch, epochs = sizes
    train_mb, valid_mb = -(-n_train // batch), -(-n_valid // batch)
    segs = run["segments"]
    got = [(s["epoch"], s["class"], s["n"]) for s in segs]
    expect = [(e, c, n) for e in range(epochs)
              for c, n in ((TRAIN, n_train), (VALID, n_valid))]
    if got != expect:
        raise RuntimeError("segments (epoch, class, rows) %s, not %s"
                           % (got, expect))
    for s in segs:
        if not (isinstance(s["n_err"], int) and 0 <= s["n_err"] <= s["n"]
                and int(s["confusion"].sum()) == s["n"]):
            raise RuntimeError("segment stats out of range: %s" % s)
    wf = run["wf"]
    got_shapes = [tuple(f.output.shape) for f in wf.forwards
                  if getattr(f, "output", None) is not None]
    if got_shapes != shapes:
        raise RuntimeError("the graph's output shapes are %s" % got_shapes)
    for key, arr in run["state"].items():
        if not numpy.isfinite(arr).all():
            raise RuntimeError("%s is not finite" % key)
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on in the unit graph")
    n_mb = (train_mb + valid_mb) * epochs
    say("   %d epochs: (TRAIN, VALID) n_err by epoch %s of %d and %d "
        "rows; snapshots after epochs %s" % (
            epochs, [(a["n_err"], b["n_err"])
                     for a, b in zip(segs[::2], segs[1::2])],
            n_train, n_valid, [e for e, _, _, _ in run["snapshots"]]))
    say("   launches: %s" % launches)
    if launches != want:
        raise RuntimeError("expected %s, no plain pooling on the card (%s); "
                           "got %s" % (said, want, launches))
    for mod in ("jax", "znicz_tpu"):
        if mod in sys.modules:
            raise RuntimeError("%s was imported" % mod)
    counts, syncs = probe.readbacks.counts, probe.readbacks.syncs
    rb = {c: sum(v for k, v in counts.items() if k != "outside" and
                 k[0] == c) for c in (TRAIN, VALID)}
    sy = {c: sum(v for k, v in syncs.items() if k != "outside" and
                 k[0] == c) for c in (TRAIN, VALID)}
    rates, run_s = _units_rates(run, n_train)
    say("   host readbacks a minibatch: TRAIN %.3f (%d in %d), VALID %.3f "
        "(%d in %d), %d outside the run, snapshots not counted; "
        "synchronizing CUDA operations (sync debug mode) a minibatch: "
        "TRAIN %.3f, VALID %.3f" % (
            rb[TRAIN] / (train_mb * epochs), rb[TRAIN], train_mb * epochs,
            rb[VALID] / (valid_mb * epochs), rb[VALID], valid_mb * epochs,
            counts["outside"], sy[TRAIN] / (train_mb * epochs),
            sy[VALID] / (valid_mb * epochs)))
    say("   %s: TRAIN images/s by epoch %s (host clock); %.4f host ms a "
        "minibatch over the run's %d minibatches (%.2f s, snapshots not "
        "counted); %s" % (
            what, " ".join("%.1f" % r for r in rates), 1e3 * run_s / n_mb,
            n_mb, run_s, card))
    run["rates"], run["run_s"] = rates, run_s
    say("   host ms by unit over the run (Unit.run_time_; the evaluator's "
        "includes waiting for the device at its readback): %s" % (
            _unit_times(wf)))
    if epochs > 1:
        last, before = segs[-1]["unit_s"], segs[-3]["unit_s"]
        spent = sorted(((last[k] - before[k], k) for k in last),
                       reverse=True)
        say("   host ms by unit in the last epoch (%d TRAIN and %d VALID "
            "minibatches), the costliest ten: %s" % (
                train_mb, valid_mb, ", ".join(
                    "%s %.1f" % (k, 1e3 * dt) for dt, k in spent[:10])))


def _unit_times(wf):
    """``name total-ms/runs`` of the workflow's units, the costliest
    first."""
    units = sorted((u for u in wf.units if u.run_count_),
                   key=lambda u: -u.run_time_)
    return ", ".join("%s %.1f/%d" % (u.name, 1e3 * u.run_time_, u.run_count_)
                     for u in units)


def _resume_units(probe, cli, prng, run, argv):
    """The CLI again, ``argv("--snapshot", path)``, from the epoch-1
    snapshot: its last epoch's stats, final weights, optimizer Arrays
    and prng streams bit-equal to the run's."""
    t0 = time.perf_counter()
    first = [p for e, p, _, _ in run["snapshots"] if e == 1]
    if not first:
        raise RuntimeError("no snapshot after epoch 1: %s"
                           % run["snapshots"])
    resumed = _units_run(probe, cli, prng, argv("--snapshot", first[0]))
    want = [s for s in _units_segments(run["segments"]) if s[0] >= 1]
    if _units_segments(resumed["segments"]) != want:
        raise RuntimeError("the resumed run's segments differ from the "
                           "run's")
    _units_equal(resumed["state"], run["state"], "the resumed run")
    say("   resume: --snapshot %s trained epoch 2: segment stats, final "
        "weights, optimizer Arrays and prng streams bit-equal to the "
        "run's (%.2f s)"
        % (os.path.basename(first[0]), time.perf_counter() - t0))


def _fused_yardstick(torch, probe, cli, prng, run, base, wf_file, card):
    """The same layers and data through ``--fused pool_impl=offsets``
    for as many epochs: what the unit graph costs against FusedNet."""
    fused = _units_run(probe, cli, prng, _units_argv(
        os.path.join(base, "fused"), wf_file, "--fused",
        "pool_impl=offsets"))
    rates, run_s = _units_rates(fused, UNITS_TRAIN)
    segs = fused["segments"]
    say("   yardstick, --fused pool_impl=offsets (windows of %d steps): "
        "TRAIN images/s by epoch %s against the unit graph's %s; the "
        "whole run %.2f s against %.2f s; (TRAIN, VALID) n_err by epoch "
        "%s; %s" % (
            fused["wf"].fused_trainer.window,
            " ".join("%.1f" % r for r in rates),
            " ".join("%.1f" % r for r in run["rates"]), run_s,
            run["run_s"],
            [(a["n_err"], b["n_err"]) for a, b in zip(segs[::2], segs[1::2])],
            card))
    say("   yardstick host ms by unit: %s" % _unit_times(fused["wf"]))


def _units_card_vs_cpu(torch):
    """The first 4 TRAIN minibatches (and the VALID one after them) of
    the full-width MNIST conv graph in f64 (:func:`_card_vs_cpu_f64`)."""
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.samples import mnist

    def build(fused, snapdir):
        return mnist.build(
            layers=root.mnistr_conv.layers,
            loader_config={"synthetic_train": 4 * UNITS_BATCH,
                           "synthetic_valid": UNITS_BATCH,
                           "minibatch_size": UNITS_BATCH},
            decision_config={"max_epochs": 1},
            snapshotter_config={"directory": snapdir}, fused=fused)
    _card_vs_cpu_f64(torch, build, 2, 4, "")


def _card_vs_cpu_f64(torch, build, pools, train_mb, what):
    """A graph's first ``train_mb`` TRAIN minibatches and a VALID one in
    f64, ``build(fused, snapdir)`` built, on the card (the f64 kernels)
    and on the CPU (the plain versions), from one initial state: every
    forward's weights and bias within ``UNITS_F64_RTOL`` of the tensor's
    largest magnitude, every pool's offsets equal (``pools`` max pools a
    minibatch); and the same minibatches through the fused graph
    (``fused={"pool_impl": "offsets"}``) in f64 on the card, its
    parameters within the same bound of the CPU's unit graph."""
    import tempfile
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    from znicz_tpu_torch.params import unit_params_to_numpy
    from znicz_tpu_torch.units.pooling import MaxPooling
    t0 = time.perf_counter()
    real_run = MaxPooling.run
    offsets = {}

    def run(unit):
        real_run(unit)
        offsets.setdefault(unit.device.type, []).append(
            unit.input_offset.dev.cpu().numpy().copy())
    saved = root.common.engine.precision_dtype
    root.common.engine.precision_dtype = numpy.float64
    MaxPooling.run = run
    before = (cuda_pooling.LAUNCHES, cuda_pooling_backward.LAUNCHES)
    params = {}
    plain = pooling.PLAIN_CUDA_CALLS
    try:
        for device, fused in (("cuda", None), ("cpu", None),
                              ("cuda", {"pool_impl": "offsets"})):
            prng.get(1).seed(UNITS_SEED)
            prng.get(2).seed(UNITS_SEED + 1)
            with tempfile.TemporaryDirectory() as snapdir:
                wf = build(fused, snapdir)
                wf.initialize(device=device)
                wf.run()
            if fused is None:
                params[device] = unit_params_to_numpy(wf.forwards)
            else:
                params["fused"] = [
                    (p["w"], p["b"]) if p else None
                    for p in wf.fused_trainer.net.host_params()]
            if device == "cuda" and fused is None:
                launched = (cuda_pooling.LAUNCHES - before[0],
                            cuda_pooling_backward.LAUNCHES - before[1])
            del wf
    finally:
        MaxPooling.run = real_run
        root.common.engine.precision_dtype = saved
    fused_launched = (cuda_pooling.LAUNCHES - before[0] - launched[0],
                      cuda_pooling_backward.LAUNCHES - before[1] -
                      launched[1])
    if pooling.PLAIN_CUDA_CALLS != plain:
        raise RuntimeError("plain pooling ran on the card in f64")
    worst = {}
    for graph in ("cuda", "fused"):
        worst[graph] = 0.0
        for i, (g, w) in enumerate(zip(params[graph], params["cpu"])):
            if w is None:
                continue
            for a, b in zip(g, w):
                if a.dtype != numpy.float64:
                    raise RuntimeError("layer %d ran in %s" % (i, a.dtype))
                rel = numpy.abs(a - b).max() / numpy.abs(b).max()
                worst[graph] = max(worst[graph], rel)
                if not rel <= UNITS_F64_RTOL:
                    raise RuntimeError(
                        "layer %d: the card's f64 parameters (%s) %.3g "
                        "relative from the CPU's, over %g" % (
                            i, graph, rel, UNITS_F64_RTOL))
    want = (pools * (train_mb + 1), pools * train_mb)
    if len(offsets["cuda"]) != want[0] or any(
            not numpy.array_equal(a, b)
            for a, b in zip(offsets["cuda"], offsets["cpu"])):
        raise RuntimeError("the pools' offsets differ between the card and "
                           "the CPU")
    if launched != want or fused_launched != want:
        raise RuntimeError("the f64 runs launched %s and %s kernels "
                           "(forward, backward), not %s"
                           % (launched, fused_launched, want))
    say("   %scard vs CPU, f64, full width, %d TRAIN minibatches and a "
        "VALID one: every forward's weights and bias within %.3g of the "
        "tensor's largest (bound %g), the %d pools' offsets equal, on %d "
        "forward and %d backward f64 kernel launches; the fused graph "
        "(pool_impl='offsets') on the card within %.3g of the CPU's unit "
        "graph, on %d and %d; no plain pooling on the card (%.2f s)" % (
            what, train_mb, worst["cuda"], UNITS_F64_RTOL, want[0],
            launched[0], launched[1], worst["fused"], fused_launched[0],
            fused_launched[1], time.perf_counter() - t0))


def _mnist_kernel_times(torch, card, cycles_per_ms):
    """Both kernels at the MNIST pools' shapes (minibatch 60, f32),
    checked bit for bit against their plain versions, then cold beside
    their bounds, plain versions and the library calls; returns the
    rows by kernel and pool."""
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.ones(32 << 20, device="cuda").sum  # reads 128 MiB
    rows = {"forward": {}, "backward": {}}
    for label, shape in MNIST_POOLS:
        x = torch.randn(shape, generator=gen, device="cuda")
        x_nchw = x.permute(0, 3, 1, 2)
        b, h, w, c = shape
        n_in, n_out = x.numel(), b * (h // 2) * (w // 2) * c
        values, offs = cuda_pooling.max_pooling_offsets(x, 2, 2, (2, 2))
        err = torch.randn(offs.shape, generator=gen, device="cuda")
        grad = cuda_pooling_backward.max_pooling_offsets_backward(
            err, offs, shape, 2, 2, (2, 2))
        p_values, p_offs = pooling.max_pooling_plain(x, 2, 2, (2, 2))
        p_grad = pooling.max_pooling_backward_plain(err, offs, shape, 2, 2,
                                                    (2, 2))
        torch.cuda.synchronize()
        if not (_bits_equal(torch, values, p_values) and
                torch.equal(offs, p_offs) and
                _bits_equal(torch, grad, p_grad)):
            raise RuntimeError("a kernel disagrees with its plain version "
                               "at MNIST %s %s" % (label, shape))
        _, idx = F.max_pool2d(x_nchw, 2, 2, ceil_mode=True,
                              return_indices=True)
        err_nchw = err.permute(0, 3, 1, 2)
        work = {
            "forward": (n_in * 4 + n_out * 8, n_out * 4, {
                "ms": lambda: cuda_pooling.max_pooling_offsets(
                    x, 2, 2, (2, 2)),
                "plain_ms": lambda: pooling.max_pooling_plain(
                    x, 2, 2, (2, 2)),
                "library_ms": lambda: F.max_pool2d(
                    x_nchw, 2, 2, ceil_mode=True, return_indices=True)}),
            "backward": (n_out * 8 + n_in * 4, n_out * 5, {
                "ms": lambda: cuda_pooling_backward
                .max_pooling_offsets_backward(err, offs, shape, 2, 2,
                                              (2, 2)),
                "plain_ms": lambda: pooling.max_pooling_backward_plain(
                    err, offs, shape, 2, 2, (2, 2)),
                "library_ms": lambda: torch.ops.aten
                .max_pool2d_with_indices_backward(
                    err_nchw, x_nchw, [2, 2], [2, 2], [0, 0], [1, 1], True,
                    idx)})}
        for kind, (nbytes, ops, fns) in work.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_OPS_PER_S * 1e3
            row = {"bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "width": WIDE if c % 4 == 0 else NARROW}
            for key, fn in fns.items():
                row[key], row[key[:-2] + "host_ms"] = _median_ms(
                    torch, fn, flush, cycles_per_ms, MNIST_TIMING_ITERS)
            rows[kind][label] = row
            say("   MNIST %s %s %s f32 (%s): kernel %.4f ms (host enqueue "
                "%.4f ms), plain %.4f ms, library %.4f ms, bound %.4f ms "
                "(%.2f MB), %.0f%% of bound; %d samples; %s" % (
                    kind, label, shape, row["width"], row["ms"],
                    row["host_ms"], row["plain_ms"], row["library_ms"],
                    row["bound_ms"], nbytes / 1e6,
                    100 * row["bound_ms"] / row["ms"], MNIST_TIMING_ITERS,
                    card))
    return rows


def _alexnet_units_argv(snapdir, *extra):
    """The CLI's arguments for AlexNet through the unit graph over the
    workflow phase's prototype images."""
    argv = ["alexnet"]
    for key, value in (("loader.minibatch_size", TRAIN_BATCH),
                       ("loader.n_train", ALEXNET_UNITS_TRAIN),
                       ("loader.n_valid", WORKFLOW_VALID),
                       ("decision.max_epochs", ALEXNET_UNITS_EPOCHS),
                       ("snapshotter.directory", snapdir)):
        argv += ["--config", "alexnet.%s=%s" % (key, value)]
    return argv + list(extra)


class _FillerProbe(object):
    """Wraps ``ZeroFiller.run`` while installed (``with``) and put back
    after (nothing in the package reads it): after each run, the number
    of the linked weights' entries that the mask zeroes but are not 0
    is added, on the card, to a count by filler (read once, at the
    end: no readback inside the run); the runs are counted by filler,
    and each filler's weights shape and masked share are recorded."""

    def __init__(self, torch):
        from znicz_tpu_torch.units.zerofilling import ZeroFiller
        self.torch, self.cls = torch, ZeroFiller
        self.real = ZeroFiller.run
        self.bad, self.runs, self.shapes, self.off = {}, {}, {}, {}

    def __enter__(self):
        probe = self

        def run(unit):
            probe.real(unit)
            name = unit.name
            w = unit.weights.dev
            if name not in probe.off:
                mask = unit.mask.dev
                probe.off[name] = (mask == 0).reshape(w.shape)
                probe.shapes[name] = (tuple(unit.effective_shape),
                                      int((unit.mask.mem == 0).sum()),
                                      unit.mask.size)
                probe.bad[name] = probe.torch.zeros(
                    (), dtype=probe.torch.int64, device=w.device)
            probe.bad[name] += ((w != 0) & probe.off[name]).sum()
            probe.runs[name] = probe.runs.get(name, 0) + 1
        self.cls.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self.real

    def check(self, n_runs):
        """Each filler ran ``n_runs`` times, the masked entries were 0
        after every run, and the mask zeroes half the entries."""
        bad = {k: int(v) for k, v in self.bad.items()}
        if sorted(self.shapes) != sorted(ALEXNET_FILLED) or any(
                self.shapes[k][0] != shape
                for k, shape in ALEXNET_FILLED.items()):
            raise RuntimeError("the fillers masked %s, not %s"
                               % (self.shapes, ALEXNET_FILLED))
        for name, (shape, zeros, size) in self.shapes.items():
            if 2 * zeros != size:
                raise RuntimeError("%s masks %d of %d entries, not half"
                                   % (name, zeros, size))
        if any(bad.values()) or set(self.runs.values()) != {n_runs}:
            raise RuntimeError("filler runs %s (want %d each); masked "
                               "entries left nonzero after a run: %s"
                               % (self.runs, n_runs, bad))
        return bad


def phase_alexnet_units(torch, card, workflow_rates):
    """Full-width AlexNet trained by the workflow CLI through the unit
    graph (``python -m znicz_tpu_torch alexnet``, no ``--fused``), in
    this process, at batch 128 over the workflow phase's prototype
    images (the first 1,024 TRAIN, 256 VALID) for 2 epochs, f32, TF32 off,
    ``cudnn.deterministic``, snapshots in a temporary directory: 3
    forward kernel launches a minibatch and 3 backward a TRAIN
    minibatch, all at 16-byte vectors, no plain pooling on the card;
    after every run of each of the four ``zero_filter`` units, the
    masked entries of the weights it holds are 0, and its mask zeroes
    half of them; a second run from the same seeds and the CLI resumed
    from the epoch-1 snapshot end bit-equal to the run.  Then
    :func:`_alexnet_f64` and :func:`_registry_on_card`.  Prints each
    epoch's TRAIN images/s beside the workflow phase's (the fused graph,
    this run), the host ms a minibatch and by unit,
    the readbacks and syncs a minibatch and the snapshot seconds.
    Returns the run's launches."""
    import tempfile
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import prng
    train_mb = -(-ALEXNET_UNITS_TRAIN // TRAIN_BATCH)
    valid_mb = -(-WORKFLOW_VALID // TRAIN_BATCH)
    n_mb = (train_mb + valid_mb) * ALEXNET_UNITS_EPOCHS
    # the replay and the resume write no snapshot: they change nothing
    # the checks read, and each costs about a second
    no_snapshots = ("--config", "alexnet.snapshotter.interval=%d"
                    % NO_SNAPSHOT)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probe = _UnitsProbe(torch)
    fillers = _FillerProbe(torch)
    # the resume takes the run's weight draw, which it overwrites with
    # the snapshot's; the replay draws afresh (what it checks)
    memo = _DrawMemo()
    tmp = tempfile.TemporaryDirectory(prefix="alexnet_units_")
    try:
        say("== alexnet_units: python -m znicz_tpu_torch %s"
            % " ".join(_alexnet_units_argv("TMP")))
        _zero_counts()
        with probe.readbacks, fillers, memo:
            run = _units_run(probe, cli, prng, _alexnet_units_argv(
                os.path.join(tmp.name, "run")))
        launches = _counts()
        if getattr(run["wf"], "lr_adjuster", None) is not None:
            raise RuntimeError("AlexNet linked a learning-rate adjuster")
        bad = fillers.check(n_mb)
        f_mb, b_mb = n_mb, train_mb * ALEXNET_UNITS_EPOCHS
        _check_graph_run(
            torch, probe, run, launches,
            {"forward": 3 * f_mb, "forward_by_width": {WIDE: 3 * f_mb,
                                                       NARROW: 0},
             "backward": 3 * b_mb, "backward_by_width": {WIDE: 3 * b_mb,
                                                         NARROW: 0},
             "plain_on_card": 0},
            "3 forward launches a minibatch and 3 backward a TRAIN "
            "minibatch, all at 16-byte vectors",
            (ALEXNET_UNITS_TRAIN, WORKFLOW_VALID, TRAIN_BATCH,
             ALEXNET_UNITS_EPOCHS), ALEXNET_SHAPES, card,
            "unit graph")
        say("   masking: %s, each %d runs (TRAIN and VALID), half of "
            "each mask zero, masked entries left nonzero after a run: %s"
            % (", ".join("%s %s" % (k, v[0])
                         for k, v in sorted(fillers.shapes.items())),
               n_mb, bad))
        say("   the fused workflow phase (its 2,048 TRAIN rows), this run: "
            "TRAIN images/s by epoch %s against the unit graph's %s; "
            "snapshots %s s (not in the rates); %s" % (
                " ".join("%.1f" % r for r in workflow_rates),
                " ".join("%.1f" % r for r in run["rates"]),
                " / ".join("%.2f" % s[3] for s in run["snapshots"]), card))
        t0 = time.perf_counter()
        replay = _units_run(probe, cli, prng, _alexnet_units_argv(
            os.path.join(tmp.name, "replay"), *no_snapshots))
        if _units_segments(replay["segments"]) != \
                _units_segments(run["segments"]):
            raise RuntimeError("the replay's segment stats differ from the "
                               "run's")
        _units_equal(replay["state"], run["state"], "the replay")
        say("   replay: a second CLI run from the same seeds, its weights "
            "drawn afresh: each epoch's per-class n_err and confusion "
            "matrices, the weights, the optimizer Arrays and the dropout "
            "generators bit-equal to the run's; no learning-rate adjuster, "
            "as in the JAX sample (%.2f s)" % (time.perf_counter() - t0))
        del replay
        with memo:
            _resume_units(probe, cli, prng, run, lambda *extra:
                          _alexnet_units_argv(
                              os.path.join(tmp.name, "resumed"),
                              *(no_snapshots + extra)))
        say("   the resume took %d of its weight draws from the run's "
            "(the snapshot's weights replace them)" % memo.hits)
    finally:
        probe.close()
        torch.backends.cudnn.deterministic = False
        tmp.cleanup()
    del run, memo
    gc.collect()
    _alexnet_f64(torch)
    _registry_on_card(torch)
    return launches


def _host_masks(wf, rand, drawn=None):
    """Each dropout unit of ``wf`` takes its masks from ``rand``, a host
    stream: the JAX package's formula (``ceil(max(u - ratio, 0)) / (1 -
    ratio)``), uploaded to the unit's device; each mask is appended to
    ``drawn`` in the order drawn."""
    import numpy
    import torch
    from znicz_tpu_torch.units.dropout import DropoutForward
    for f in wf.forwards:
        if isinstance(f, DropoutForward):
            def calc_mask(f=f):
                leave = 1.0 - f.dropout_ratio
                u = rand.uniform(-f.dropout_ratio, leave, f.input.shape)
                m = (numpy.ceil(numpy.maximum(u, 0)) /
                     leave).astype(f.input.dtype)
                if drawn is not None:
                    drawn.append((f.dropout_ratio, m))
                f.mask.set_dev(torch.from_numpy(m).to(f.device))
            f.calc_mask = calc_mask


def _alexnet_f64(torch):
    """Full-width AlexNet in f64, minibatch ``ALEXNET_F64_BATCH``, for
    ``ALEXNET_F64_MB`` TRAIN minibatches (and one VALID minibatch), from
    one initial state: the unit graph on the card (the f64 kernels) and
    on the CPU (the plain versions), both handed the same host-drawn
    dropout masks: every weight and bias within ``UNITS_F64_RTOL`` of
    the tensor's largest, every pool's offsets equal; and the fused
    graph (``pool_impl="offsets"``) on the card, its dropout handed the
    unit graph's masks: n_err equal, its weights within the same bound
    (each grouped layer's through its mask: the unit graph lets the
    masked entries move between an update and the next filler run, the
    fused graph keeps them 0) and its biases."""
    import tempfile
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    from znicz_tpu_torch.params import unit_params_to_numpy
    from znicz_tpu_torch.samples import alexnet
    from znicz_tpu_torch.units.pooling import MaxPooling
    t0 = time.perf_counter()
    real_run, real_rand = MaxPooling.run, torch.rand
    offsets, drawn, out = {}, [], {}

    def run(unit):
        real_run(unit)
        offsets.setdefault(unit.device.type, []).append(
            unit.input_offset.dev.cpu().numpy().copy())
    saved = root.common.engine.precision_dtype
    root.common.engine.precision_dtype = numpy.float64
    MaxPooling.run = run
    plain = pooling.PLAIN_CUDA_CALLS
    launched = {}
    # the three builds start from one state: the CPU's and the fused
    # graph's take the card build's weight draw
    memo = _DrawMemo().__enter__()
    try:
        for key, device, fused in (("cuda", "cuda", None),
                                   ("cpu", "cpu", None),
                                   ("fused", "cuda",
                                    {"pool_impl": "offsets"})):
            prng.get(1).seed(UNITS_SEED)
            prng.get(2).seed(UNITS_SEED + 1)
            with tempfile.TemporaryDirectory() as snapdir:
                wf = alexnet.build(
                    loader_config={
                        "n_train": ALEXNET_F64_MB * ALEXNET_F64_BATCH,
                        "n_valid": ALEXNET_F64_BATCH,
                        "minibatch_size": ALEXNET_F64_BATCH},
                    decision_config={"max_epochs": 1},
                    snapshotter_config={"directory": snapdir,
                                        "interval": NO_SNAPSHOT},
                    fused=fused)
                wf.initialize(device=device)
                if fused is None:
                    _host_masks(wf, prng.RandomGenerator().seed(
                        UNITS_SEED + 2), drawn if key == "cuda" else None)
                else:
                    gen = wf.fused_trainer.net._gen
                    keeps = iter(drawn)

                    def rand(*size, generator=None, **kwargs):
                        if generator is not gen:
                            return real_rand(*size, generator=generator,
                                             **kwargs)
                        ratio, m = next(keeps)
                        # keep = rand >= ratio: 1 where the mask keeps
                        return torch.from_numpy(m * (1.0 - ratio)).to(
                            device=kwargs["device"], dtype=kwargs["dtype"])
                    torch.rand = rand
                c0 = (cuda_pooling.LAUNCHES, cuda_pooling_backward.LAUNCHES)
                wf.run()
                torch.rand = real_rand
                launched[key] = (cuda_pooling.LAUNCHES - c0[0],
                                 cuda_pooling_backward.LAUNCHES - c0[1])
            out[key] = {"n_err": list(wf.decision.epoch_n_err)}
            if fused is None:
                out[key]["params"] = unit_params_to_numpy(wf.forwards)
            else:
                net = wf.fused_trainer.net
                out[key]["params"] = [(p["w"], p["b"]) if p else None
                                      for p in net.host_params()]
                out[key]["masks"] = [getattr(s, "weight_mask", None)
                                     for s in net.specs]
                if next(keeps, None) is not None:
                    raise RuntimeError("the fused graph drew fewer dropout "
                                       "masks than the unit graph")
            del wf
    finally:
        memo.__exit__()
        MaxPooling.run = real_run
        torch.rand = real_rand
        root.common.engine.precision_dtype = saved
    if pooling.PLAIN_CUDA_CALLS != plain:
        raise RuntimeError("plain pooling ran on the card in f64")
    worst = {"cuda": 0.0, "fused": 0.0}
    for key in worst:
        masks = out["fused"]["masks"]
        for i, (g, w) in enumerate(zip(out[key]["params"],
                                       out["cpu"]["params"])):
            if w is None:
                continue
            for j, (a, b) in enumerate(zip(g, w)):
                if a.dtype != numpy.float64:
                    raise RuntimeError("layer %d ran in %s" % (i, a.dtype))
                if j == 0 and masks[i] is not None:
                    a, b = a * masks[i], b * masks[i]
                rel = numpy.abs(a - b).max() / numpy.abs(b).max()
                worst[key] = max(worst[key], rel)
                if not rel <= UNITS_F64_RTOL:
                    raise RuntimeError(
                        "layer %d: the card's f64 parameters (%s) %.3g "
                        "relative from the CPU's, over %g"
                        % (i, key, rel, UNITS_F64_RTOL))
    n_pools = 3 * (ALEXNET_F64_MB + 1)
    if len(offsets.get("cuda", ())) != n_pools or any(
            not numpy.array_equal(a, b)
            for a, b in zip(offsets["cuda"], offsets["cpu"])):
        raise RuntimeError("the pools' offsets differ between the card and "
                           "the CPU")
    want = (n_pools, 3 * ALEXNET_F64_MB)
    if launched["cuda"] != want or launched["fused"] != want or \
            launched["cpu"] != (0, 0):
        raise RuntimeError("the f64 runs launched %s kernels (forward, "
                           "backward), not %s on the card" % (launched,
                                                              want))
    if not (out["cuda"]["n_err"] == out["cpu"]["n_err"] ==
            out["fused"]["n_err"]):
        raise RuntimeError("n_err: card %s, CPU %s, fused %s" % (
            out["cuda"]["n_err"], out["cpu"]["n_err"],
            out["fused"]["n_err"]))
    say("   card vs CPU, f64, full width, minibatch %d, %d TRAIN "
        "minibatches and a VALID one, the dropout units handed the same "
        "host-drawn masks: every weight and bias within %.3g of the "
        "tensor's largest (bound %g), the %d pools' offsets equal, n_err "
        "%s equal; the fused graph (pool_impl='offsets', its dropout "
        "handed the unit graph's %d masks) on the card within %.3g of the "
        "CPU's unit graph, grouped weights through their masks; %s "
        "kernel launches (forward, backward) each on the card, no plain "
        "pooling; %d weight draws made, %d taken from them (%.2f s)" % (
            ALEXNET_F64_BATCH, ALEXNET_F64_MB, worst["cuda"],
            UNITS_F64_RTOL, n_pools, out["cpu"]["n_err"], len(drawn),
            worst["fused"], want, memo.draws, memo.hits,
            time.perf_counter() - t0))


def _registry_on_card(torch):
    """The rest of the layer registry once on the card and once on the
    CPU in f64, from the same seeded inputs: Cutter / GDCutter,
    Cutter1D, Multiplier / GDMultiplier, Summator / GDSummator,
    ResizableAll2All (grow, then shrink) and GDRProp (three steps);
    every array within ``REGISTRY_RTOL`` of the CPU's largest."""
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
    from znicz_tpu_torch.core.memory import Array
    from znicz_tpu_torch.units import (all2all, cutter, multiplier,
                                       resizable_all2all, rprop_gd,
                                       summator)
    t0 = time.perf_counter()

    def case(device):
        r = numpy.random.RandomState(REGISTRY_SEED)
        wf = AcceleratedWorkflow(None)

        def arr(shape, lo=-1.0, hi=1.0):
            a = Array(r.uniform(lo, hi, shape))
            a.device = torch.device(device)
            return a

        def take(**arrays):
            for k, a in arrays.items():
                if a.dev.device.type != device:
                    raise RuntimeError("%s ran on %s" % (k, a.dev.device))
                out[k] = numpy.array(a.mem)
        out = {}
        cut = cutter.Cutter(wf, padding=(1, 2, 1, 1))
        cut.input = arr((2, 6, 7, 3))
        cut.initialize(device=device)
        cut.run()
        gcut = cutter.GDCutter(wf, padding=(1, 2, 1, 1))
        gcut.err_output = arr((2, 3, 5, 3))
        gcut.link_attrs(cut, "input")
        gcut.initialize(device=device)
        gcut.run()
        take(cutter=cut.output, gd_cutter=gcut.err_input)
        c1 = cutter.Cutter1D(wf, alpha=2.0, beta=0.5, input_offset=3,
                             output_offset=1, length=4)
        c1.input = arr((3, 10))
        c1.output.reset(r.uniform(-1, 1, (3, 8)))
        c1.initialize(device=device)
        c1.run()
        take(cutter1d=c1.output)
        m, gm = multiplier.Multiplier(wf), multiplier.GDMultiplier(wf)
        s, gs = summator.Summator(wf), summator.GDSummator(wf)
        m.x, m.y = arr((4, 5)), arr((4, 5))
        gm.x, gm.y, gm.err_output = m.x, m.y, arr((4, 5))
        s.x, s.y = m.x, m.y
        gs.err_output = gm.err_output
        for u in (m, gm, s, gs):
            u.initialize(device=device)
            u.run()
        take(multiplier=m.output, gd_multiplier_x=gm.err_x,
             gd_multiplier_y=gm.err_y, summator=s.output,
             gd_summator_x=gs.err_x, gd_summator_y=gs.err_y)
        rs = resizable_all2all.ResizableAll2All(
            wf, output_sample_shape=(5,), weights_stddev=0.1,
            bias_stddev=0.1, rand=prng.RandomGenerator().seed(3))
        rs.input = arr((4, 6))
        rs.initialize(device=device)
        rs.output_sample_shape = (8,)
        rs.run()
        take(resizable_grown=rs.output)
        rs.output_sample_shape = (3,)
        rs.run()
        take(resizable_shrunk=rs.output, resizable_w=rs.weights)
        fwd = all2all.All2All(wf, output_sample_shape=(3,),
                              weights_stddev=0.1, bias_stddev=0.1,
                              rand=prng.RandomGenerator().seed(4))
        fwd.input = arr((8, 4))
        fwd.initialize(device=device)
        fwd.run()
        rp = rprop_gd.GDRProp(wf)
        rp.err_output = arr((8, 3), -0.1, 0.1)
        rp.link_attrs(fwd, "output", "input", "weights", "bias")
        rp.initialize(device=device)
        for _ in range(3):
            rp.err_output = arr((8, 3), -0.1, 0.1)
            rp.run()
        take(rprop_w=rp.weights, rprop_b=rp.bias, rprop_lrs=rp.weight_lrs,
             rprop_err=rp.err_input)
        return out

    got, want = case("cuda"), case("cpu")
    worst = 0.0
    for k, w in want.items():
        if got[k].shape != w.shape or got[k].dtype != numpy.float64:
            raise RuntimeError("%s: %s %s on the card" % (
                k, got[k].shape, got[k].dtype))
        rel = numpy.abs(got[k] - w).max() / max(numpy.abs(w).max(), 1e-300)
        worst = max(worst, rel)
        if not rel <= REGISTRY_RTOL:
            raise RuntimeError("%s: the card %.3g relative from the CPU"
                               % (k, rel))
    say("   the rest of the registry on the card against the CPU, f64: %s "
        "within %.3g (bound %g) (%.2f s)" % (
            ", ".join(sorted(want)), worst, REGISTRY_RTOL,
            time.perf_counter() - t0))


def _ae_argv(snapdir, *extra):
    return _sample_argv("mnist_ae", "mnist_ae", snapdir, UNITS_TRAIN,
                        UNITS_VALID, AE_BATCH, AE_EPOCHS, *extra)


def _ae_layers():
    """The fused autoencoder stage (the layer list of
    ``tests/unit/test_fused_mse_ae.py``) at MnistAE's widths and hypers
    (``root.mnist_ae``): conv 5 kernels 5x5, no bias -> maxabs pooling
    3x3/s2 -> depooling tied to it -> deconv tied to the conv."""
    from znicz_tpu_torch.core.config import root
    cfg = root.mnist_ae
    return [
        {"name": "conv", "type": "conv",
         "->": {"n_kernels": cfg.n_kernels, "kx": cfg.kx, "ky": cfg.ky,
                "include_bias": cfg.include_bias,
                "weights_filling": "uniform"},
         "<-": {"learning_rate": cfg.learning_rate,
                "weights_decay": cfg.weights_decay,
                "gradient_moment": cfg.gradient_moment}},
        {"name": "pool", "type": "maxabs_pooling",
         "->": {"kx": cfg.pooling.kx, "ky": cfg.pooling.ky,
                "sliding": tuple(cfg.pooling.sliding)}},
        {"name": "depool", "type": "depooling", "->": {"tied_to": "pool"}},
        {"name": "deconv", "type": "deconv",
         "->": {"tied_to": "conv", "unsafe_padding": cfg.unsafe_padding}}]


def phase_ae(torch, card, cycles_per_ms):
    """The MNIST convolutional autoencoder (``root.mnist_ae``: conv 5
    5x5 -> stochastic abs pooling 3x3/s2 -> depooling on the backward
    kernel -> deconv with the conv's weights, MSE against the input,
    GDDeconv the only gradient unit) through the CLI's unit graph at
    minibatch 100 over the units phase's rows for 2 epochs, then the fused
    autoencoder stage (``FusedNet(objective="mse")``, the forward kernel
    as the maxabs pool and the backward kernel as the depooling) over
    one epoch of the same TRAIN rows, and both kernels at the
    autoencoder's shape.  Returns the launches of both paths and the
    timing rows."""
    import shutil
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader.base import TRAIN
    base = os.path.join(HERE, "build", "znicz_tpu_torch", "ae")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    train_mb = -(-UNITS_TRAIN // AE_BATCH)
    valid_mb = -(-UNITS_VALID // AE_BATCH)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probe = _UnitsProbe(torch)
    try:
        say("== ae: python -m znicz_tpu_torch %s"
            % " ".join(_ae_argv("build/...")))
        _zero_counts()
        with probe.readbacks:
            run = _units_run(probe, cli, prng,
                             _ae_argv(os.path.join(base, "run")))
        launches = _counts()
        _check_ae_run(torch, probe, run, launches, train_mb, valid_mb, card)
        t0 = time.perf_counter()
        replay = _units_run(probe, cli, prng,
                            _ae_argv(os.path.join(base, "replay")))
        if _units_segments(replay["segments"]) != \
                _units_segments(run["segments"]):
            raise RuntimeError("the autoencoder replay's epoch metrics "
                               "differ from the run's")
        _units_equal(replay["state"], run["state"], "the replay")
        say("   replay: a second CLI run from the same seeds: each epoch's "
            "[sum, max, min] metrics, the final weights, the optimizer "
            "Arrays and the prng streams the stochastic pool draws from "
            "bit-equal to the run's (%.2f s)" % (time.perf_counter() - t0))
        del replay
        _resume_units(probe, cli, prng, run, lambda *extra: _ae_argv(
            os.path.join(base, "resumed"), *extra))
        loader = run["wf"].loader
        start, end = loader.class_index_range(TRAIN)
        data = loader.original_data.mem[start:end].copy()
        probe.close()
        del run, loader
        gc.collect()
        shutil.rmtree(base, ignore_errors=True)
        _ae_card_vs_cpu(torch)
        # deterministic cuDNN here too: the control step's bit equality
        # holds only if the deconv's weight gradient sums in one order
        fused_launches = _ae_fused(torch, data, card)
        del data
    finally:
        probe.close()
        torch.backends.cudnn.deterministic = False
    rows = _ae_kernel_times(torch, card, cycles_per_ms)
    return launches, fused_launches, rows


def _check_ae_run(torch, probe, run, launches, train_mb, valid_mb, card):
    """The autoencoder run's segments, shapes, launches, readbacks and
    rates."""
    import math
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    segs = run["segments"]
    got = [(s["epoch"], s["class"]) for s in segs]
    want = [(e, c) for e in range(AE_EPOCHS) for c in (TRAIN, VALID)]
    if got != want:
        raise RuntimeError("segments (epoch, class) %s, not %s"
                           % (got, want))
    for s in segs:
        m = s["metrics"]
        if m is None or not all(math.isfinite(v) for v in m) or \
                not 0 <= m[2] <= m[1] or not 0 < m[0] <= m[1]:
            raise RuntimeError("segment metrics out of range: %s" % s)
    wf = run["wf"]
    shapes = [tuple(a.shape) for a in (wf.conv.output, wf.pool.output,
                                       wf.depool.err_input,
                                       wf.deconv.output)]
    if shapes != [(AE_BATCH, 24, 24, 5), (AE_BATCH, 12, 12, 5),
                  (AE_BATCH, 24, 24, 5), (AE_BATCH, 28, 28, 1)]:
        raise RuntimeError("the autoencoder's shapes are %s" % shapes)
    if wf.deconv.weights is not wf.conv.weights:
        raise RuntimeError("the deconv does not share the conv's weights")
    n_mb = (train_mb + valid_mb) * AE_EPOCHS
    say("   %d epochs: (TRAIN, VALID) reconstruction MSE (avg, max, min) "
        "by epoch %s; snapshots after epochs %s" % (
            AE_EPOCHS, [(a["metrics"], b["metrics"])
                        for a, b in zip(segs[::2], segs[1::2])],
            [e for e, _, _, _ in run["snapshots"]]))
    say("   launches: %s" % launches)
    if launches["backward"] != n_mb or launches["forward"] or \
            launches["backward_by_width"] != {WIDE: 0, NARROW: n_mb} or \
            launches["plain_on_card"]:
        raise RuntimeError(
            "expected the backward kernel once a minibatch, TRAIN and VALID "
            "(%d, one channel a thread), the forward kernel never (the pool "
            "is stochastic), no plain pooling on the card; got %s"
            % (n_mb, launches))
    for mod in ("jax", "znicz_tpu"):
        if mod in sys.modules:
            raise RuntimeError("%s was imported" % mod)
    counts, syncs = probe.readbacks.counts, probe.readbacks.syncs
    n = {TRAIN: train_mb * AE_EPOCHS, VALID: valid_mb * AE_EPOCHS}
    rb = {c: sum(v for k, v in counts.items() if k != "outside" and
                 k[0] == c) for c in n}
    sy = {c: sum(v for k, v in syncs.items() if k != "outside" and
                 k[0] == c) for c in n}
    rates, run_s = _units_rates(run, UNITS_TRAIN)
    say("   host readbacks a minibatch: TRAIN %.3f (%d in %d), VALID %.3f "
        "(%d in %d), %d outside the run; synchronizing CUDA operations "
        "(sync debug mode) a minibatch: TRAIN %.3f, VALID %.3f" % (
            rb[TRAIN] / n[TRAIN], rb[TRAIN], n[TRAIN], rb[VALID] / n[VALID],
            rb[VALID], n[VALID], counts["outside"], sy[TRAIN] / n[TRAIN],
            sy[VALID] / n[VALID]))
    say("   autoencoder unit graph: TRAIN images/s by epoch %s (host "
        "clock); %.4f host ms a minibatch over the run's %d minibatches "
        "(%.2f s, snapshots not counted); %s" % (
            " ".join("%.1f" % r for r in rates), 1e3 * run_s / n_mb, n_mb,
            run_s, card))
    say("   host ms by unit over the run: %s" % _unit_times(wf))


def _ae_card_vs_cpu(torch):
    """The first 4 TRAIN minibatches (and a VALID one) of the autoencoder
    in f64 on the card (the f64 backward kernel as the depooling) and on
    the CPU (its plain version), from one seed: the shared weights and
    the GD's velocity within ``AE_F64_RTOL`` of each tensor's largest,
    and every stochastic winner equal."""
    import tempfile
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.ops import cuda_pooling_backward, pooling
    from znicz_tpu_torch.samples import mnist_ae
    from znicz_tpu_torch.units.pooling import StochasticPoolingBase
    t0 = time.perf_counter()
    real_run = StochasticPoolingBase.run
    offsets = {}

    def run(unit):
        real_run(unit)
        offsets.setdefault(unit.device.type, []).append(
            unit.input_offset.dev.cpu().numpy().copy())
    saved = root.common.engine.precision_dtype
    root.common.engine.precision_dtype = numpy.float64
    StochasticPoolingBase.run = run
    plain = pooling.PLAIN_CUDA_CALLS
    before = cuda_pooling_backward.LAUNCHES
    state = {}
    try:
        for device in ("cuda", "cpu"):
            prng.get(1).seed(UNITS_SEED)
            prng.get(2).seed(UNITS_SEED + 1)
            with tempfile.TemporaryDirectory() as snapdir:
                wf = mnist_ae.build(
                    loader_config={"synthetic_train": 4 * AE_BATCH,
                                   "synthetic_valid": AE_BATCH,
                                   "minibatch_size": AE_BATCH},
                    decision_config={"max_epochs": 1},
                    snapshotter_config={"directory": snapdir})
                wf.initialize(device=device)
                wf.run()
            state[device] = [numpy.array(a.mem) for a in (
                wf.conv.weights, wf.gd_deconv.gradient_weights_with_moment)]
            if device == "cuda":
                launched = cuda_pooling_backward.LAUNCHES - before
            del wf
    finally:
        StochasticPoolingBase.run = real_run
        root.common.engine.precision_dtype = saved
    if pooling.PLAIN_CUDA_CALLS != plain:
        raise RuntimeError("plain pooling ran on the card in f64")
    worst = 0.0
    for g, w in zip(state["cuda"], state["cpu"]):
        if g.dtype != numpy.float64:
            raise RuntimeError("the autoencoder ran in %s" % g.dtype)
        worst = max(worst, numpy.abs(g - w).max() / numpy.abs(w).max())
    if not worst <= AE_F64_RTOL:
        raise RuntimeError("the card's f64 autoencoder is %.3g relative "
                           "from the CPU's, over %g" % (worst, AE_F64_RTOL))
    if len(offsets["cuda"]) != 5 or any(
            not numpy.array_equal(a, b)
            for a, b in zip(offsets["cuda"], offsets["cpu"])):
        raise RuntimeError("the stochastic winners differ between the card "
                           "and the CPU")
    if launched != 5:
        raise RuntimeError("the f64 autoencoder launched the backward "
                           "kernel %d times, not 5" % launched)
    say("   card vs CPU, f64, 4 TRAIN minibatches and a VALID one of 100: "
        "the shared weights and the velocity within %.3g of the tensor's "
        "largest (bound %g), the 5 pools' stochastic winners equal, on %d "
        "f64 depooling launches; no plain pooling on the card (%.2f s)"
        % (worst, AE_F64_RTOL, launched, time.perf_counter() - t0))


def _ae_fused(torch, data, card):
    """The fused autoencoder stage on the card: 4 steps on the kernels
    against the same steps with the pool on ``max_pooling_gather`` (its
    winners from ``max_pooling_plain``) and the depooling on
    ``max_pooling_backward_plain``, bit for bit; 4 steps in f64 on the
    card against the CPU; then one epoch of TRAIN steps in windows of
    ``AE_WINDOW``, one launch of each kernel a step."""
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.ops import pooling
    from znicz_tpu_torch.parallel import fused
    layers = _ae_layers()
    n = len(data) - len(data) % AE_BATCH
    steps = n // AE_BATCH
    idx = numpy.random.RandomState(UNITS_SEED).permutation(len(data))[
        :n].reshape(steps, AE_BATCH)

    def net_on(device, dtype=numpy.float32):
        return fused.FusedNet(layers, (28, 28, 1), objective="mse",
                              rand=prng.RandomGenerator().seed(UNITS_SEED),
                              dtype=dtype, device=device)

    def four_steps(net):
        losses = [net.step_mse(data[i], data[i], AE_BATCH)["loss"]
                  for i in idx[:4]]
        return torch.stack(losses).cpu(), net

    t0 = time.perf_counter()
    kernels = four_steps(net_on(None))
    real = pooling.max_pooling_train, pooling.depooling
    pooling.max_pooling_train = lambda x, ky, kx, sliding, use_abs: (
        pooling.max_pooling_gather(x, ky, kx, sliding, use_abs),
        pooling.max_pooling_plain(x, ky, kx, sliding, use_abs)[1])
    pooling.depooling = pooling.max_pooling_backward_plain
    try:
        control = four_steps(net_on(None))
    finally:
        pooling.max_pooling_train, pooling.depooling = real
    if not torch.equal(kernels[0], control[0]):
        raise RuntimeError("the fused autoencoder's losses on the kernels "
                           "differ from the gather / plain steps'")
    _state_bits_equal(torch, kernels[1], control[1], "the fused "
                      "autoencoder's state after 4 steps on the kernels")
    f64 = [four_steps(net_on(d, numpy.float64))[1].host_params()[0]["w"]
           for d in (None, "cpu")]
    rel = numpy.abs(f64[0] - f64[1]).max() / numpy.abs(f64[1]).max()
    if not rel <= AE_F64_RTOL:
        raise RuntimeError("the fused autoencoder's f64 weights on the card "
                           "are %.3g relative from the CPU's" % rel)
    say("   fused autoencoder (FusedNet, objective='mse'): 4 steps on the "
        "kernels bit-equal to the gather / plain steps (losses %s, every "
        "parameter and optimizer slot); f64 card vs CPU %.3g (bound %g) "
        "(%.2f s)" % (" ".join("%.9g" % v for v in kernels[0].tolist()),
                      rel, AE_F64_RTOL, time.perf_counter() - t0))
    net = net_on(None)
    if [s.kind for s in net.specs] != ["conv", "pool", "depool", "deconv"] \
            or not net.specs[1].record_offsets:
        raise RuntimeError("the fused autoencoder's specs are %s"
                           % net.specs)
    net.set_dataset(data, None, data)
    hypers = fused.stack_hypers(net.hypers, AE_WINDOW)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    for w in range(0, steps, AE_WINDOW):
        k = min(AE_WINDOW, steps - w)
        net.run_window_mse_indexed(
            idx[w:w + k], [AE_BATCH] * k,
            hypers if k == AE_WINDOW else fused.stack_hypers(net.hypers, k))
    acc = net.window_acc_host()
    dt = time.perf_counter() - t0
    launches = _counts()
    if launches["forward"] != steps or launches["backward"] != steps or \
            launches["forward_by_width"][WIDE] or \
            launches["backward_by_width"][WIDE] or launches["plain_on_card"]:
        raise RuntimeError("expected 1 forward (maxabs) and 1 backward "
                           "(depooling) launch a step, %d each at one "
                           "channel, no plain pooling; got %s"
                           % (steps, launches))
    m = acc["metrics"]
    if not (numpy.isfinite(m).all() and 0 < m[2] <= m[1]) or \
            not net.params_finite():
        raise RuntimeError("the fused autoencoder's epoch is not finite: "
                           "%s" % m)
    say("   fused autoencoder, one epoch: %d steps of %d in windows of %d, "
        "%.1f images/s (host clock, one readback); reconstruction MSE "
        "(avg, max, min) %.6f %.6f %.6f; launches %s; %s" % (
            steps, AE_BATCH, AE_WINDOW, n / dt, m[0] / n, m[1], m[2],
            launches, card))
    return launches


def _ae_kernel_times(torch, card, cycles_per_ms):
    """Both kernels at the autoencoder's shape (100, 24, 24, 5) f32,
    3x3/s2, maxabs: bit-equal to their plain versions on the kernel's own
    offsets and on stochastic offsets, then cold beside their bounds,
    plain versions and library yardsticks."""
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.ones(32 << 20, device="cuda").sum  # reads 128 MiB
    x = torch.randn(AE_SHAPE, generator=gen, device="cuda")
    b, h, w, c = AE_SHAPE
    ny, nx = pooling.output_spatial(h, w, 3, 3, (2, 2))
    n_in, n_out = x.numel(), b * ny * nx * c
    values, offs = cuda_pooling.max_pooling_offsets(x, 3, 3, (2, 2), True)
    p_values, p_offs = pooling.max_pooling_plain(x, 3, 3, (2, 2), True)
    rand = torch.randint(0, 1 << 16, (n_out,), generator=gen, device="cuda",
                         dtype=torch.int32)
    s_values, s_offs = pooling.stochastic_pooling(x, rand, 3, 3, (2, 2),
                                                  True)
    checks = [_bits_equal(torch, values, p_values),
              torch.equal(offs, p_offs)]
    for v, o in ((values, offs), (s_values, s_offs)):
        checks.append(_bits_equal(
            torch, cuda_pooling_backward.max_pooling_offsets_backward(
                v, o, AE_SHAPE, 3, 3, (2, 2)),
            pooling.max_pooling_backward_plain(v, o, AE_SHAPE, 3, 3,
                                               (2, 2))))
    torch.cuda.synchronize()
    if not all(checks):
        raise RuntimeError("a kernel disagrees with its plain version at the "
                           "autoencoder's shape: %s" % checks)
    wins = int(torch.bincount(s_offs.view(-1).long()).max())
    say("   autoencoder %s f32 3x3/s2 maxabs: the forward kernel bit-equal "
        "to its plain version (values and offsets), the depooling on the "
        "backward kernel bit-equal to its plain version on the kernel's "
        "offsets and on stochastic offsets (a cell wins up to %d windows)"
        % (AE_SHAPE, wins))
    x_nchw = x.permute(0, 3, 1, 2)
    flat = s_offs.view(-1).long()
    work = {
        "forward": (n_in * 4 + n_out * 8, n_out * 9, {
            "ms": lambda: cuda_pooling.max_pooling_offsets(
                x, 3, 3, (2, 2), True),
            "plain_ms": lambda: pooling.max_pooling_plain(
                x, 3, 3, (2, 2), True),
            "library_ms": lambda: F.max_pool2d(
                x_nchw, 3, 2, ceil_mode=True, return_indices=True)}),
        "backward": (n_out * 8 + n_in * 4, n_out, {
            "ms": lambda: cuda_pooling_backward.max_pooling_offsets_backward(
                s_values, s_offs, AE_SHAPE, 3, 3, (2, 2)),
            "plain_ms": lambda: pooling.max_pooling_backward_plain(
                s_values, s_offs, AE_SHAPE, 3, 3, (2, 2)),
            "library_ms": lambda: torch.zeros(
                n_in, device="cuda").index_add_(0, flat,
                                                s_values.view(-1))})}
    rows = {"forward": {}, "backward": {}}
    for kind, (nbytes, ops, fns) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        row = {"bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        for key, fn in fns.items():
            row[key], row[key[:-2] + "host_ms"] = _median_ms(
                torch, fn, flush, cycles_per_ms, MNIST_TIMING_ITERS)
        rows[kind]["ae"] = row
        say("   autoencoder %s %s f32 (one channel): kernel %.4f ms (host "
            "enqueue %.4f ms), plain %.4f ms, library %.4f ms (%s), bound "
            "%.5f ms (%.3f MB), %.0f%% of bound; %d samples; %s" % (
                kind, AE_SHAPE, row["ms"], row["host_ms"], row["plain_ms"],
                row["library_ms"],
                "F.max_pool2d, max not maxabs: no one PyTorch call computes "
                "maxabs" if kind == "forward" else "index_add_",
                row["bound_ms"], nbytes / 1e6,
                100 * row["bound_ms"] / row["ms"], MNIST_TIMING_ITERS, card))
    return rows


def _mse_argv(snapdir, *extra):
    return _sample_argv("mnist7", "mnist7", snapdir, UNITS_TRAIN,
                        UNITS_VALID, MSE_BATCH, MSE_EPOCHS, *extra)


def phase_mse(torch, card):
    """The seven-segment regressor (``root.mnist7``: all2all_tanh 100 ->
    100 -> 7, MSE against the digits' codes, the nearest-code n_err)
    through the CLI's unit graph and through ``--fused``, 2 epochs each
    at minibatch 60 over the units phase's rows, then the first 4 TRAIN
    minibatches in f64 through both graphs on the card.  No pooling
    kernel is on this path; none may launch."""
    import math
    import shutil
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    base = os.path.join(HERE, "build", "znicz_tpu_torch", "mse")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    probe = _UnitsProbe(torch)
    try:
        say("== mse: python -m znicz_tpu_torch %s [--fused]"
            % " ".join(_mse_argv("build/...")))
        for mode, extra in (("units", ()), ("fused", ("--fused",))):
            _zero_counts()
            run = _units_run(probe, cli, prng, _mse_argv(
                os.path.join(base, mode), *extra))
            segs = run["segments"]
            got = [(s["epoch"], s["class"], s["n"]) for s in segs]
            want = [(e, cl, nr) for e in range(MSE_EPOCHS)
                    for cl, nr in ((TRAIN, UNITS_TRAIN),
                                   (VALID, UNITS_VALID))]
            if got != want:
                raise RuntimeError("mnist7 %s: segments %s, not %s"
                                   % (mode, got, want))
            for s in segs:
                if not (0 <= s["n_err"] <= s["n"] and all(
                        math.isfinite(v) for v in s["metrics"])):
                    raise RuntimeError("mnist7 %s: segment out of range: %s"
                                       % (mode, s))
            if any(_counts()[k] for k in ("forward", "backward",
                                          "plain_on_card")):
                raise RuntimeError("mnist7 launched pooling: %s" % _counts())
            wf = run["wf"]
            if mode == "fused" and wf.fused_trainer.window != 8:
                raise RuntimeError("mnist7 --fused ran windows of %d"
                                   % wf.fused_trainer.window)
            rates, run_s = _units_rates(run, UNITS_TRAIN)
            say("   mnist7 %s: (TRAIN, VALID) n_err / avg MSE by epoch %s; "
                "TRAIN images/s by epoch %s (host clock), %.2f s; %s" % (
                    mode, [("%d/%.6f" % (a["n_err"], a["metrics"][0]),
                            "%d/%.6f" % (b["n_err"], b["metrics"][0]))
                           for a, b in zip(segs[::2], segs[1::2])],
                    " ".join("%.1f" % r for r in rates), run_s, card))
            del run, wf
    finally:
        probe.close()
    shutil.rmtree(base, ignore_errors=True)
    _mse_card_f64(torch)


def _mse_card_f64(torch):
    """The first 4 TRAIN minibatches of mnist7 in f64 on the card through
    the fused graph against the unit graph: every weight and bias within
    ``AE_F64_RTOL`` of the tensor's largest."""
    import tempfile
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.samples import mnist7
    saved = root.common.engine.precision_dtype
    root.common.engine.precision_dtype = numpy.float64
    params = {}
    try:
        for mode, fused_cfg in (("units", None), ("fused", {})):
            prng.get(1).seed(UNITS_SEED)
            prng.get(2).seed(UNITS_SEED + 1)
            with tempfile.TemporaryDirectory() as snapdir:
                wf = mnist7.build(
                    loader_config={"synthetic_train": 4 * MSE_BATCH,
                                   "synthetic_valid": MSE_BATCH,
                                   "minibatch_size": MSE_BATCH},
                    decision_config={"max_epochs": 1},
                    snapshotter_config={"directory": snapdir},
                    fused=fused_cfg)
                wf.initialize(device="cuda")
                wf.run()
            if fused_cfg is None:
                params[mode] = [(numpy.array(f.weights.mem),
                                 numpy.array(f.bias.mem))
                                for f in wf.forwards]
            else:
                params[mode] = [(p["w"], p["b"]) for p in
                                wf.fused_trainer.net.host_params()]
            del wf
    finally:
        root.common.engine.precision_dtype = saved
    worst = 0.0
    for g, w in zip(params["fused"], params["units"]):
        for a, b in zip(g, w):
            if a.dtype != numpy.float64:
                raise RuntimeError("mnist7 ran in %s" % a.dtype)
            worst = max(worst, numpy.abs(a - b).max() / numpy.abs(b).max())
    if not worst <= AE_F64_RTOL:
        raise RuntimeError("mnist7 in f64 on the card: the fused graph is "
                           "%.3g relative from the unit graph" % worst)
    say("   mnist7 f64 on the card, 4 TRAIN minibatches: the fused graph's "
        "weights and biases within %.3g of the unit graph's (bound %g)"
        % (worst, AE_F64_RTOL))


def _cifar_argv(snapdir, *extra, **sizes):
    """The CLI's arguments for a CIFAR run; ``sizes`` may set
    ``workflow``, ``n_train``, ``n_valid`` and ``epochs``."""
    return _sample_argv(sizes.get("workflow", "cifar"), "cifar", snapdir,
                        sizes.get("n_train", CIFAR_TRAIN),
                        sizes.get("n_valid", CIFAR_VALID), CIFAR_BATCH,
                        sizes.get("epochs", CIFAR_EPOCHS), *extra)


def phase_cifar(torch, card, cycles_per_ms):
    """The CIFAR-10 caffe config (``root.cifar``: conv 32 5x5 -> max pool
    3x3/s2 -> strict relu -> LRN -> conv 32 -> relu -> avg pool -> LRN ->
    conv 64 -> relu -> avg pool -> softmax 10, the ``arbitrary_step``
    schedule, ``internal_mean``) at minibatch 100 over the loader's
    synthetic set at CIFAR-10's split: both kernels at the path's shapes
    first, bit for bit and timed; then the CLI's unit graph for 2 epochs
    (launches, readbacks, rates), a second run and a resume from the
    epoch-1 snapshot bit-equal to it; the fused graph (``--fused
    pool_impl=offsets``); the nin and mlp variants; and the schedule in
    f64 with its boundary inside a fused window.  Returns the unit
    graph's and the fused graph's launches, the timing rows and the
    directory of the unit graph run's snapshots, left for the
    serve_models phase."""
    import shutil
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import prng
    rows = _cifar_kernels(torch, card, cycles_per_ms)
    base = os.path.join(HERE, "build", "znicz_tpu_torch", "cifar")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    train_mb = -(-CIFAR_TRAIN // CIFAR_BATCH)
    valid_mb = -(-CIFAR_VALID // CIFAR_BATCH)
    n_mb, n_tr = (train_mb + valid_mb) * CIFAR_EPOCHS, train_mb * CIFAR_EPOCHS
    want = {"forward": n_mb, "forward_by_width": {WIDE: n_mb, NARROW: 0},
            "backward": n_tr, "backward_by_width": {WIDE: n_tr, NARROW: 0},
            "plain_on_card": 0}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probe = _UnitsProbe(torch)
    try:
        say("== cifar: python -m znicz_tpu_torch %s"
            % " ".join(_cifar_argv("build/...")))
        _zero_counts()
        with probe.readbacks:
            run = _units_run(probe, cli, prng,
                             _cifar_argv(os.path.join(base, "run")))
        launches = _counts()
        _check_graph_run(
            torch, probe, run, launches, want,
            "1 forward launch a minibatch and 1 backward a TRAIN minibatch, "
            "all at 16-byte vectors",
            (CIFAR_TRAIN, CIFAR_VALID, CIFAR_BATCH, CIFAR_EPOCHS),
            CIFAR_SHAPES, card, "cifar unit graph")
        _check_cifar_schedule(run["wf"], n_tr)
        t0 = time.perf_counter()
        replay = _units_run(probe, cli, prng,
                            _cifar_argv(os.path.join(base, "replay")))
        if _units_segments(replay["segments"]) != \
                _units_segments(run["segments"]):
            raise RuntimeError("the CIFAR replay's segment stats differ "
                               "from the run's")
        _units_equal(replay["state"], run["state"], "the CIFAR replay")
        run["replay_rates"] = _units_rates(replay, CIFAR_TRAIN)[0]
        say("   replay: a second CLI run from the same seeds: each epoch's "
            "per-class n_err and confusion matrices, the final weights, "
            "the optimizer Arrays, every GD's learning rates and the "
            "adjuster's count bit-equal to the run's (%.2f s); TRAIN "
            "images/s by epoch %s" % (
                time.perf_counter() - t0,
                " ".join("%.1f" % r for r in run["replay_rates"])))
        del replay
        _resume_units(probe, cli, prng, run, lambda *extra: _cifar_argv(
            os.path.join(base, "resumed"), *extra))
        fused_launches = _cifar_fused(torch, probe, cli, prng, run, base,
                                      want, card)
        del run
        gc.collect()
        _cifar_variants(probe, cli, prng, base, card)
    finally:
        probe.close()
        torch.backends.cudnn.deterministic = False
    _cifar_schedule_f64(torch)
    # the unit graph run's snapshots stay for the serve_models phase,
    # which deletes them
    return launches, fused_launches, rows, os.path.join(base, "run")


def _check_cifar_schedule(wf, n_tr):
    """The caffe run's adjuster: linked before the GD chain, ticked once
    a TRAIN minibatch, every GD at the schedule's first rates (its first
    boundary, at 60,000 minibatches, lies past the run)."""
    adj = wf.lr_adjuster
    if adj not in wf.gds[-1].links_from or \
            wf.snapshotter in wf.gds[-1].links_from:
        raise RuntimeError("the adjuster does not feed the GD chain")
    if adj._minibatches_count != n_tr:
        raise RuntimeError("the adjuster ticked %d times, not %d"
                           % (adj._minibatches_count, n_tr))
    rates = {(g.name, g.learning_rate, g.learning_rate_bias)
             for g in wf.gds if g.name in ("gd_conv1", "gd_conv3",
                                           "gd_fc_softmax4")}
    if rates != {("gd_conv1", 0.001, 0.002), ("gd_conv3", 0.001, 0.001),
                 ("gd_fc_softmax4", 0.001, 0.002)}:
        raise RuntimeError("the GD units' rates are %s" % sorted(rates))
    if wf.loader.normalization_type != "internal_mean":
        raise RuntimeError("the loader normalized with %s"
                           % wf.loader.normalization_type)
    say("   the adjuster ticked %d times (once a TRAIN minibatch) before "
        "the GD chain; arbitrary_step at 1x until minibatch 60,000, past "
        "this run" % n_tr)


def _cifar_fused(torch, probe, cli, prng, run, base, want, card):
    """The caffe config through ``--fused pool_impl=offsets`` for as many
    epochs (:func:`_fused_graph`), with the adjuster linked between the
    loader and the trainer and ticked once a TRAIN step."""
    launches, wf = _fused_graph(
        torch, probe, cli, prng, run,
        _cifar_argv(os.path.join(base, "fused"), "--fused",
                    "pool_impl=offsets"),
        want, (CIFAR_TRAIN, CIFAR_EPOCHS), card)
    trainer, adj = wf.fused_trainer, wf.lr_adjuster
    if adj not in trainer.links_from or wf.loader in trainer.links_from or \
            trainer.hyper_tick != adj.run or \
            adj._minibatches_count != want["backward"] or \
            trainer.window != 8:
        raise RuntimeError("the fused graph's adjuster is not linked as "
                           "link_lr_adjuster links it (count %d, window %d)"
                           % (adj._minibatches_count, trainer.window))
    say("   fused graph: the adjuster between the loader and the trainer, "
        "ticked %d times" % adj._minibatches_count)
    return launches


def _fused_graph(torch, probe, cli, prng, run, argv, want, sizes, card):
    """A sample through ``--fused pool_impl=offsets`` (``argv``) for as
    many epochs as the unit graph ``run`` (``sizes``: TRAIN rows,
    epochs): each TRAIN segment reads the card exactly once; the
    launches, worked out from the code before the call, are exactly
    ``want``: one forward a TRAIN step and a VALID minibatch
    (``predict_with_idx``) and one backward a TRAIN step a max pool.
    Returns the launches and the workflow."""
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    n_train, epochs = sizes
    readbacks = _Readbacks(torch, probe._where)
    _zero_counts()
    with readbacks:
        fused = _units_run(probe, cli, prng, argv)
    launches = _counts()
    say("   fused graph (--fused pool_impl=offsets) launches: %s" % launches)
    if launches != want:
        raise RuntimeError("the fused graph launched %s, not %s"
                           % (launches, want))
    per_train = [readbacks.counts[(TRAIN, e)] for e in range(epochs)]
    if per_train != [1] * epochs:
        raise RuntimeError("readbacks by TRAIN segment %s, not one each"
                           % per_train)
    valid = sum(v for k, v in readbacks.counts.items()
                if k != "outside" and k[0] == VALID)
    segs = fused["segments"]
    for s in segs:
        if not (0 <= s["n_err"] <= s["n"] and
                int(s["confusion"].sum()) == s["n"]):
            raise RuntimeError("fused segment stats out of range: %s" % s)
    rates, run_s = _units_rates(fused, n_train)
    n_mb = sum(-(-s["n"] // fused["wf"].loader.max_minibatch_size)
               for s in segs)
    syncs = sum(v for k, v in readbacks.syncs.items() if k != "outside")
    say("   fused graph: one readback a TRAIN segment %s (%d over the VALID "
        "minibatches); windows of %d steps; TRAIN images/s by epoch %s "
        "against the unit graph's %s, the run %.2f s against %.2f s "
        "(%.4f host ms a minibatch; %.3f synchronizing CUDA operations "
        "a minibatch; snapshots %s s, not counted); (TRAIN, VALID) n_err "
        "by epoch %s, the unit graph's %s; %s" % (
            per_train, valid, fused["wf"].fused_trainer.window,
            " ".join("%.1f" % r for r in rates),
            " ".join("%.1f" % r for r in run["rates"]), run_s, run["run_s"],
            1e3 * run_s / n_mb, syncs / n_mb,
            " / ".join("%.2f" % s[3] for s in fused["snapshots"]),
            [(a["n_err"], b["n_err"]) for a, b in zip(segs[::2], segs[1::2])],
            [(a["n_err"], b["n_err"]) for a, b in zip(
                run["segments"][::2], run["segments"][1::2])], card))
    say("   fused graph host ms by unit: %s" % _unit_times(fused["wf"]))
    return launches, fused["wf"]


def _cifar_variants(probe, cli, prng, base, card):
    """The nin and mlp variants (``cifar.build_variant``) through the
    unit graph, from a workflow file each, at 2,000 TRAIN and 500 VALID
    rows for one epoch: nin's pool3 launches the forward kernel once a
    minibatch and the backward once a TRAIN minibatch at 16-byte vectors,
    the mlp none."""
    train_mb = -(-CIFAR_VARIANT_TRAIN // CIFAR_BATCH)
    n_mb = train_mb + -(-CIFAR_VARIANT_VALID // CIFAR_BATCH)
    for variant, fwd, bwd in (("nin", n_mb, train_mb), ("mlp", 0, 0)):
        wf_file = os.path.join(base, "cifar_%s_wf.py" % variant)
        with open(wf_file, "w") as f:
            f.write("from znicz_tpu_torch.samples import cifar\n\n\n"
                    "def run(load, main):\n"
                    "    load(cifar.build_variant, variant=%r)\n"
                    "    main()\n" % variant)
        _zero_counts()
        r = _units_run(probe, cli, prng, _cifar_argv(
            os.path.join(base, variant), workflow=wf_file,
            n_train=CIFAR_VARIANT_TRAIN, n_valid=CIFAR_VARIANT_VALID,
            epochs=1))
        launches = _counts()
        want = {"forward": fwd, "forward_by_width": {WIDE: fwd, NARROW: 0},
                "backward": bwd, "backward_by_width": {WIDE: bwd, NARROW: 0},
                "plain_on_card": 0}
        if launches != want:
            raise RuntimeError("cifar %s launched %s, not %s"
                               % (variant, launches, want))
        wf = r["wf"]
        if getattr(wf, "lr_adjuster", None) is not None:
            raise RuntimeError("cifar %s linked an adjuster" % variant)
        if variant == "nin" and \
                tuple(wf.forwards[6].output.shape) != (100, 16, 16, 96):
            raise RuntimeError("nin's pool3 output is %s"
                               % (wf.forwards[6].output.shape,))
        rates, run_s = _units_rates(r, CIFAR_VARIANT_TRAIN)
        say("   cifar %s (unit graph, %d forwards): (class, n_err) %s; "
            "TRAIN images/s %s; launches %s; %s" % (
                variant, len(wf.forwards),
                [(s["class"], s["n_err"]) for s in r["segments"]],
                " ".join("%.1f" % v for v in rates), launches, card))


def _cifar_schedule_f64(torch):
    """The caffe config over 12 TRAIN minibatches (and a VALID one) in
    f64 with the rate dropped 10x after the third: the card's unit graph
    against the CPU's, and the card's fused graph (windows of 8, the
    boundary inside the first) against the card's unit graph; every
    weight and bias within ``UNITS_F64_RTOL`` of the tensor's largest,
    the same n_err, the same rates at every step."""
    import tempfile
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.samples import cifar
    t0 = time.perf_counter()
    steps = [(1, CIFAR_F64_BOUNDARY), (0.1, 100000)]
    schedule = {"do": True, "lr_policy_name": "arbitrary_step",
                "bias_lr_policy_name": "arbitrary_step",
                "lr_parameters": {"lrs_with_lengths": steps},
                "bias_lr_parameters": {"lrs_with_lengths": steps}}
    saved = root.common.engine.precision_dtype
    root.common.engine.precision_dtype = numpy.float64
    got = {}
    try:
        for name, device, fused_cfg in (
                ("card", "cuda", None), ("cpu", "cpu", None),
                ("fused", "cuda", {"pool_impl": "offsets",
                                   "window": CIFAR_F64_WINDOW})):
            prng.get(1).seed(UNITS_SEED)
            prng.get(2).seed(UNITS_SEED + 1)
            with tempfile.TemporaryDirectory() as snapdir:
                wf = cifar.build(
                    loader_config={
                        "synthetic_train": CIFAR_F64_MB * CIFAR_BATCH,
                        "synthetic_valid": CIFAR_BATCH,
                        "minibatch_size": CIFAR_BATCH},
                    decision_config={"max_epochs": 1},
                    snapshotter_config={"directory": snapdir},
                    lr_adjuster_config=schedule, fused=fused_cfg)
                log, adj = [], wf.lr_adjuster
                gd, real = adj._gd_units[0], adj.run

                def tick(log=log, gd=gd, real=real, adj=adj):
                    count = adj._minibatches_count
                    real()
                    if adj._minibatches_count != count:
                        log.append((gd.learning_rate, gd.learning_rate_bias))
                adj.run = tick
                if fused_cfg is not None:
                    wf.fused_trainer.hyper_tick = tick
                _zero_counts()
                wf.initialize(device=device)
                wf.run()
            launched = _counts()
            if fused_cfg is None:
                params = [(numpy.array(f.weights.mem),
                           numpy.array(f.bias.mem))
                          for f in wf.forwards if f.weights]
            else:
                params = [(p["w"], p["b"]) for p in
                          wf.fused_trainer.net.host_params() if p]
            got[name] = (params, list(wf.decision.epoch_n_err), log,
                         launched)
            del wf
    finally:
        root.common.engine.precision_dtype = saved
    want_rates = [(0.001, 0.002)] * CIFAR_F64_BOUNDARY + \
        [(0.1 * 0.001, 0.1 * 0.002)] * (CIFAR_F64_MB - CIFAR_F64_BOUNDARY)
    worst = {}
    for name, ref in (("card", "cpu"), ("fused", "card")):
        params, n_err, rates, launched = got[name]
        if n_err != got[ref][1] or rates != got[ref][2] or \
                rates != want_rates:
            raise RuntimeError(
                "f64 schedule parity: %s n_err %s rates %s, %s n_err %s "
                "rates %s" % (name, n_err, rates, ref, got[ref][1],
                              got[ref][2]))
        if launched["forward"] != CIFAR_F64_MB + 1 or \
                launched["backward"] != CIFAR_F64_MB or \
                launched["plain_on_card"]:
            raise RuntimeError("f64 %s launched %s" % (name, launched))
        worst[name] = 0.0
        for g, w in zip(params, got[ref][0]):
            for a, b in zip(g, w):
                if a.dtype != numpy.float64:
                    raise RuntimeError("f64 %s ran in %s" % (name, a.dtype))
                worst[name] = max(worst[name], numpy.abs(a - b).max() /
                                  numpy.abs(b).max())
        if not worst[name] <= UNITS_F64_RTOL:
            raise RuntimeError("f64 schedule parity: %s %.3g relative from "
                               "%s" % (name, worst[name], ref))
    say("   f64, %d TRAIN minibatches, the rate 10x lower after %d of them: "
        "the card's unit graph within %.3g of the CPU's, the card's fused "
        "graph (windows of %d, the boundary inside the first) within %.3g "
        "of the card's unit graph (bound %g); n_err %s in all three; the "
        "same rate at every step %s (%.2f s)" % (
            CIFAR_F64_MB, CIFAR_F64_BOUNDARY, worst["card"],
            CIFAR_F64_WINDOW, worst["fused"], UNITS_F64_RTOL,
            got["cpu"][1], got["cpu"][2], time.perf_counter() - t0))


def _cifar_kernels(torch, card, cycles_per_ms):
    """Both kernels at the CIFAR path's shapes (``CIFAR_POOLS``)."""
    return _pool_kernels(torch, card, cycles_per_ms, CIFAR_POOLS, "CIFAR")


def _pool_kernels(torch, card, cycles_per_ms, pools, what):
    """Both kernels at a path's 3x3/s2 ceil-mode pools (``pools``:
    ``(label, NHWC shape)``) bit-equal to their plain versions, on random
    values and on ties, in f32 and f64, every launch at 16-byte vectors;
    then in f32 cold beside their bounds, plain versions and the library
    calls.  Returns the rows by kernel and pool."""
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    gen = torch.Generator(device="cuda").manual_seed(7)
    t0 = time.perf_counter()
    checked = 0
    for label, shape in pools:
        ny, nx = pooling.output_spatial(shape[1], shape[2], 3, 3, (2, 2))
        err_buf = torch.randn(shape[0] * ny * nx * shape[3] + 1,
                              generator=gen, device="cuda")
        for dtype in (torch.float32, torch.float64):
            for x in (torch.randn(shape, generator=gen, device="cuda",
                                  dtype=dtype),
                      _tied(torch, gen, shape, dtype)):
                case = "%s %s %s %s" % (what, label, shape, dtype)
                # both raise unless bit-equal to the plain version
                _, width = _check_pool(torch, x, 3, 3, (2, 2), False, case)
                _, _, (_, bwidth) = _check_backward(
                    torch, x, err_buf.to(dtype), 3, 3, (2, 2), False, case)
                if width != WIDE or bwidth != WIDE:
                    raise RuntimeError("%s launched at %s / %s, not %s"
                                       % (case, width, bwidth, WIDE))
                checked += 1
    say("   %s pools %s, 3x3/s2 ceil mode: both kernels bit-equal to "
        "their plain versions (values, offsets, the gradient) on %d inputs "
        "(random and tied, f32 and f64), every launch at 16-byte vectors "
        "(%.2f s)" % (what, ", ".join("%s %s" % p for p in pools), checked,
                      time.perf_counter() - t0))
    flush = torch.ones(32 << 20, device="cuda").sum  # reads 128 MiB
    rows = {"forward": {}, "backward": {}}
    for label, shape in pools:
        x = torch.randn(shape, generator=gen, device="cuda")
        x_nchw = x.permute(0, 3, 1, 2)
        b, h, w, c = shape
        ny, nx = pooling.output_spatial(h, w, 3, 3, (2, 2))
        n_in, n_out = x.numel(), b * ny * nx * c
        _, offs = cuda_pooling.max_pooling_offsets(x, 3, 3, (2, 2))
        err = torch.randn(offs.shape, generator=gen, device="cuda")
        _, idx = F.max_pool2d(x_nchw, 3, 2, ceil_mode=True,
                              return_indices=True)
        err_nchw = err.permute(0, 3, 1, 2)
        work = {
            "forward": (n_in * 4 + n_out * 8, n_out * 9, {
                "ms": lambda: cuda_pooling.max_pooling_offsets(
                    x, 3, 3, (2, 2)),
                "plain_ms": lambda: pooling.max_pooling_plain(
                    x, 3, 3, (2, 2)),
                "library_ms": lambda: F.max_pool2d(
                    x_nchw, 3, 2, ceil_mode=True, return_indices=True)}),
            "backward": (n_out * 8 + n_in * 4, n_out, {
                "ms": lambda: cuda_pooling_backward
                .max_pooling_offsets_backward(err, offs, shape, 3, 3,
                                              (2, 2)),
                "plain_ms": lambda: pooling.max_pooling_backward_plain(
                    err, offs, shape, 3, 3, (2, 2)),
                "library_ms": lambda: torch.ops.aten
                .max_pool2d_with_indices_backward(
                    err_nchw, x_nchw, [3, 3], [2, 2], [0, 0], [1, 1], True,
                    idx)})}
        for kind, (nbytes, ops, fns) in work.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_OPS_PER_S * 1e3
            row = {"bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            iters = SMALL_TIMING_ITERS if row["bound_ms"] < 0.01 else \
                TIMING_ITERS
            for key, fn in fns.items():
                row[key], row[key[:-2] + "host_ms"] = _median_ms(
                    torch, fn, flush, cycles_per_ms, iters)
            rows[kind][label] = row
            say("   %s %s %s %s f32 (16-byte): kernel %.4f ms (host "
                "enqueue %.4f ms), plain %.4f ms, library %.4f ms, bound "
                "%.4f ms (%.2f MB), %.0f%% of bound; %d samples; %s" % (
                    what, kind, label, shape, row["ms"], row["host_ms"],
                    row["plain_ms"], row["library_ms"], row["bound_ms"],
                    nbytes / 1e6, 100 * row["bound_ms"] / row["ms"], iters,
                    card))
    return rows


class _StlData(object):
    """The STL-10 sample's synthetic sets (``stl10.materialize_synthetic``,
    the JAX package's bytes) written in a thread started before the build
    and joined after it (:meth:`join`), as the prototype draw is: the
    phase's set (``STL_TRAIN`` / ``STL_VALID`` rows) and the f64 checks'
    (``STL_F64_MB`` minibatches and a VALID one), in a temporary
    directory removed by :meth:`cleanup`."""

    def __init__(self):
        import tempfile
        self.tmp = tempfile.TemporaryDirectory(prefix="stl10_")
        self.main = os.path.join(self.tmp.name, "main")
        self.small = os.path.join(self.tmp.name, "f64")
        self.seconds = self.error = None
        self._thread = threading.Thread(target=self._write, daemon=True)
        self._thread.start()

    def _write(self):
        try:
            from znicz_tpu_torch.samples.research import stl10
            t0 = time.perf_counter()
            stl10.materialize_synthetic(self.main, n_train=STL_TRAIN,
                                        n_valid=STL_VALID)
            stl10.materialize_synthetic(
                self.small, n_train=STL_F64_MB * STL_BATCH,
                n_valid=STL_BATCH)
            self.seconds = time.perf_counter() - t0
        except Exception as e:   # raised again by join
            self.error = e

    def join(self):
        self._thread.join()
        if self.error is not None:
            raise RuntimeError("the STL-10 sets were not written") \
                from self.error

    def cleanup(self):
        self._thread.join()
        self.tmp.cleanup()


class _Imports(object):
    """Whether ``PIL`` and ``sklearn`` import on this host, each tried in
    a child interpreter started with the script (an import of
    scikit-learn takes seconds of the host, off this process): the zoo's
    image samples read their files with PIL, and Wine's loader writes its
    file from scikit-learn's copy where the checkout lacks it.
    :meth:`result` waits for both children and returns ``{name: None if
    it imports, else the error's last line}``."""

    MODULES = {"PIL": "PIL.Image", "sklearn": "sklearn.datasets"}

    def __init__(self):
        self.procs = {
            name: subprocess.Popen(
                [sys.executable, "-c", "import " + mod],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)
            for name, mod in self.MODULES.items()}

    def result(self):
        if getattr(self, "_out", None) is not None:
            return self._out
        out = self._out = {}
        for name, proc in self.procs.items():
            _, err = proc.communicate()
            lines = err.strip().splitlines()
            out[name] = None if proc.returncode == 0 else (
                lines[-1] if lines else "exit %d" % proc.returncode)
        return out


class _DrawMemo(object):
    """While installed (``with``), each weight draw of the host streams
    (``RandomGenerator.fill`` and ``fill_normal_real``) of at least a
    million values is kept by the stream's state before it and the
    draw's arguments; a later draw from the same state with the same
    arguments is handed the kept values and leaves the stream in the
    state the draw left it in, so the values and the streams are a fresh
    draw's, without the host's seconds.  A check that rests on drawing
    again runs with the memo out; nothing in the package reads it."""

    SMALLEST = 1 << 20

    def __init__(self):
        from znicz_tpu_torch.core import prng
        self.cls = prng.RandomGenerator
        self.real = {n: getattr(self.cls, n)
                     for n in ("fill", "fill_normal_real")}
        self.kept = {}
        self.hits = self.draws = 0

    def _wrap(self, name, real):
        memo = self

        def draw(rg, arr, *args, **kwargs):
            if arr.size < memo.SMALLEST:
                return real(rg, arr, *args, **kwargs)
            st = rg.state.get_state()
            key = (name, st[1].tobytes(), st[2], st[3], st[4], arr.shape,
                   arr.dtype.str, args, tuple(sorted(kwargs.items())))
            if key in memo.kept:
                values, after = memo.kept[key]
                arr[...] = values
                rg.state.set_state(after)
                memo.hits += 1
                return None
            out = real(rg, arr, *args, **kwargs)
            memo.kept[key] = (arr.copy(), rg.state.get_state())
            memo.draws += 1
            return out
        return draw

    def __enter__(self):
        for name, real in self.real.items():
            setattr(self.cls, name, self._wrap(name, real))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.cls, name, real)


def _stl_argv(directory, snapdir, *extra):
    """The CLI's arguments for STL-10 over ``directory``'s files."""
    argv = ["research.stl10"]
    for key, value in (("loader.directory", directory),
                       ("loader.minibatch_size", STL_BATCH),
                       ("decision.max_epochs", STL_EPOCHS),
                       ("snapshotter.directory", snapdir)):
        argv += ["--config", "stl.%s=%s" % (key, value)]
    return argv + list(extra)


def phase_stl10(torch, card, cycles_per_ms, data, imports):
    """STL-10's published network (``root.stl``: conv 32 5x5 -> max pool
    3x3/s2 -> strict relu -> LRN -> conv 32 5x5 -> strict relu -> avg
    pool 3x3/s2 -> LRN -> softmax; ``internal_mean``, minibatch 50) over
    the sample's synthetic set (``data``: 2,500 TRAIN and 500 VALID
    rows in the real binary format), f32, TF32 off,
    ``cudnn.deterministic``.  Both kernels at pool1's shape first, bit
    for bit and timed; then ``python -m znicz_tpu_torch research.stl10``
    (the unit graph) for 2 epochs: exactly one forward launch a
    minibatch (120) and one backward a TRAIN minibatch (100), all at
    16-byte vectors, no plain pooling, no adjuster; a second run from
    the same seeds and the CLI resumed from the epoch-1 snapshot
    bit-equal to it; the same through ``--fused pool_impl=offsets``
    (the same launches, one readback a TRAIN segment); the first 4
    TRAIN minibatches in f64, the card against the CPU and the fused
    graph against the CPU's unit graph; then the zoo (:func:`_zoo`,
    ``imports`` an :class:`_Imports`).
    Returns the unit graph's and the fused graph's launches and the
    timing rows."""
    import tempfile
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.samples.research import stl10
    rows = _pool_kernels(torch, card, cycles_per_ms, STL_POOLS, "STL-10")
    train_mb, valid_mb = -(-STL_TRAIN // STL_BATCH), -(-STL_VALID // STL_BATCH)
    n_mb, n_tr = (train_mb + valid_mb) * STL_EPOCHS, train_mb * STL_EPOCHS
    want = {"forward": n_mb, "forward_by_width": {WIDE: n_mb, NARROW: 0},
            "backward": n_tr, "backward_by_width": {WIDE: n_tr, NARROW: 0},
            "plain_on_card": 0}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probe = _UnitsProbe(torch)
    tmp = tempfile.TemporaryDirectory(prefix="stl10_snapshots_")
    base = tmp.name
    try:
        say("== stl10: python -m znicz_tpu_torch %s"
            % " ".join(_stl_argv("DATA", "TMP")))
        _zero_counts()
        with probe.readbacks:
            run = _units_run(probe, cli, prng, _stl_argv(
                data.main, os.path.join(base, "run")))
        launches = _counts()
        _check_graph_run(
            torch, probe, run, launches, want,
            "1 forward launch a minibatch and 1 backward a TRAIN minibatch, "
            "all at 16-byte vectors",
            (STL_TRAIN, STL_VALID, STL_BATCH, STL_EPOCHS), STL_SHAPES, card,
            "stl10 unit graph")
        say("   snapshots %s s (not in the rates)" % " / ".join(
            "%.2f" % s[3] for s in run["snapshots"]))
        wf = run["wf"]
        if getattr(wf, "lr_adjuster", None) is not None or \
                wf.loader.normalization_type != "internal_mean" or \
                wf.loader.labels_mapping != {"airplane": 0, "bird": 1,
                                             "car": 2, "cat": 3}:
            raise RuntimeError("the STL-10 graph is not the sample's: %s, "
                               "%s" % (wf.loader.normalization_type,
                                       wf.loader.labels_mapping))
        t0 = time.perf_counter()
        replay = _units_run(probe, cli, prng, _stl_argv(
            data.main, os.path.join(base, "replay")))
        if _units_segments(replay["segments"]) != \
                _units_segments(run["segments"]):
            raise RuntimeError("the STL-10 replay's segment stats differ "
                               "from the run's")
        _units_equal(replay["state"], run["state"], "the STL-10 replay")
        say("   replay: a second CLI run from the same seeds: each epoch's "
            "per-class n_err and confusion matrices, every weight and "
            "bias and the optimizer Arrays bit-equal to the run's (%.2f s)"
            % (time.perf_counter() - t0))
        del replay
        _resume_units(probe, cli, prng, run, lambda *extra: _stl_argv(
            data.main, os.path.join(base, "resumed"), *extra))
        fused_launches, _ = _fused_graph(
            torch, probe, cli, prng, run,
            _stl_argv(data.main, os.path.join(base, "fused"), "--fused",
                      "pool_impl=offsets"),
            want, (STL_TRAIN, STL_EPOCHS), card)
        del run, wf
        gc.collect()
        _zoo(torch, probe, cli, prng, base, imports.result(), card)
    finally:
        probe.close()
        torch.backends.cudnn.deterministic = False
        tmp.cleanup()

    def build(fused, snapdir):
        return stl10.build(
            loader_config={"directory": data.small,
                           "minibatch_size": STL_BATCH},
            decision_config={"max_epochs": 1},
            snapshotter_config={"directory": snapdir}, fused=fused)
    _card_vs_cpu_f64(torch, build, 1, STL_F64_MB, "STL-10 ")
    return launches, fused_launches, rows


def _zoo(torch, probe, cli, prng, base, found, card):
    """The rest of the classification zoo through the CLI's unit graph
    on the card, no kernel among them: ``research.mnist_simple`` for an
    epoch at its minibatch 88 over the units phase's MNIST rows,
    ``research.wine_relu`` and ``wine`` over the checkout's Wine file
    (or one written from scikit-learn's copy), ``research.hands``,
    ``research.tv_channels`` and ``yale_faces`` over their synthetic
    images.  Each run must end on ``cuda`` with each epoch's per-class
    n_err within its rows and neither ``jax`` nor ``znicz_tpu``
    imported.  A sample whose data needs a package the card lacks (PIL
    for the images; scikit-learn for Wine when its file is absent) is
    printed as not run, with the reason: that is not a check.  ``found``
    is :meth:`_Imports.result`."""
    from znicz_tpu_torch.core.config import root
    t0 = time.perf_counter()
    say("== zoo: on this host PIL %s, scikit-learn %s" % (
        "imports" if found["PIL"] is None else
        "does not import (%s)" % found["PIL"],
        "imports" if found["sklearn"] is None else
        "does not import (%s)" % found["sklearn"]))
    wine_file = os.path.join(root.common.dirs.datasets, "wine", "wine.txt")
    images = {"research.hands": "hands", "research.tv_channels": "channels",
              "yale_faces": "yalefaces"}
    runs = [("research.mnist_simple", _sample_argv(
        "research.mnist_simple", "mnist_simple", os.path.join(base, "ms"),
        UNITS_TRAIN, UNITS_VALID, ZOO_MNIST_BATCH, 1), None)]
    for name, ns in (("research.wine_relu", "wine_relu"), ("wine", "wine")):
        why = None if os.path.exists(wine_file) or found["sklearn"] is None \
            else "no %s and scikit-learn %s" % (wine_file, found["sklearn"])
        argv = [name, "--config", "%s.decision.max_epochs=%d"
                % (ns, ZOO_EPOCHS)]
        if ns != "wine":   # wine's snapshotter takes the common directory
            argv += ["--config", "%s.snapshotter.directory=%s"
                     % (ns, os.path.join(base, ns))]
        runs.append((name, argv, why))
    for name, ns in images.items():
        why = None if found["PIL"] is None else "PIL %s" % found["PIL"]
        runs.append((name, [
            name, "--config", "%s.loader.train_paths=[%r]"
            % (ns, os.path.join(base, ns + "_images")),
            "--config", "%s.decision.max_epochs=%d" % (ns, ZOO_EPOCHS),
            "--config", "%s.snapshotter.directory=%s"
            % (ns, os.path.join(base, ns))], why))
    snapshots = root.common.dirs.snapshots
    root.common.dirs.snapshots = os.path.join(base, "common")
    try:
        for name, argv, why in runs:
            if why is not None:
                say("   %s: not run (%s)" % (name, why))
                continue
            t1 = time.perf_counter()
            _zero_counts()
            r = _units_run(probe, cli, prng, argv)
            wf, segs = r["wf"], r["segments"]
            device = wf.forwards[0].weights.dev.device
            bad = [s for s in segs if not (
                isinstance(s["n_err"], int) and 0 <= s["n_err"] <= s["n"])]
            if device.type != "cuda" or bad or not segs or \
                    _counts()["plain_on_card"]:
                raise RuntimeError("%s: device %s, segments %s"
                                   % (name, device, segs))
            for mod in ("jax", "znicz_tpu"):
                if mod in sys.modules:
                    raise RuntimeError("%s was imported" % mod)
            say("   %s: (epoch, class, n_err of rows) %s on %s, %d forwards, "
                "the head %d wide (%.2f s); %s" % (
                    name, [(s["epoch"], s["class"], "%d/%d" % (s["n_err"],
                                                               s["n"]))
                           for s in segs], device, len(wf.forwards),
                    wf.forwards[-1].output.shape[-1],
                    time.perf_counter() - t1, card))
    finally:
        root.common.dirs.snapshots = snapshots
    say("   zoo: %.2f s" % (time.perf_counter() - t0))


def phase_train(torch, card, cycles_per_ms):
    """Full-width AlexNet trained through the port's FusedNet on the
    card: the step checks, 3 epochs of windows, the step breakdown."""
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.parallel import fused
    from znicz_tpu_torch.samples import alexnet

    t0 = time.perf_counter()
    data, labels = alexnet.synthetic_images(TRAIN_IMAGES,
                                            n_classes=TRAIN_CLASSES)
    say("== train: %d prototype images of %d classes, %.2f GB, made in "
        "%.2f s" % (len(data), TRAIN_CLASSES, data.nbytes / 1e9,
                    time.perf_counter() - t0))
    t0 = time.perf_counter()
    # the CPU check's f32 net takes this draw again (its state is then
    # this net's): one draw, kept
    memo = _DrawMemo().__enter__()
    net = fused.FusedNet(alexnet.make_layers(), (227, 227, 3),
                         rand=prng.RandomGenerator().seed(0),
                         pool_impl="offsets", dropout_seed=0)
    n_params = sum(t.numel() for p in net.params for t in p.values())
    say("   FusedNet: full-width AlexNet, %d parameters, f32, "
        "pool_impl='offsets', built in %.2f s" % (
            n_params, time.perf_counter() - t0))
    sd0 = net.state_dict()
    x = data[:TRAIN_BATCH]
    lbl = labels[:TRAIN_BATCH]

    # 1. the kernels' step against the gather step; 2. the card against
    # the CPU; cuDNN's deterministic algorithms for both
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _gather_check(torch, net, sd0, x, lbl)
    try:
        _cpu_check(torch, net, sd0, data, labels)
    finally:
        memo.__exit__()
    torch.backends.cudnn.deterministic = False

    # 3. the main path: 3 epochs of sliced windows, counts from 0
    net.load_state_dict(sd0)
    del sd0
    t0 = time.perf_counter()
    net.set_dataset(data, labels)
    torch.cuda.synchronize()
    say("   set_dataset: %.2f s" % (time.perf_counter() - t0))
    x_dev = torch.from_numpy(x).to("cuda")
    lbl_dev = torch.from_numpy(lbl).to("cuda")
    del data, x, lbl
    hypers_s = fused.stack_hypers(net.hypers, WINDOW_STEPS)
    per_epoch = WINDOWS * WINDOW_STEPS * TRAIN_BATCH
    rates = []
    _zero_counts()
    for epoch in range(EPOCHS):
        perm = numpy.random.RandomState(100 + epoch).permutation(
            TRAIN_IMAGES)[:per_epoch]
        net.set_epoch_perm(perm, 0)
        net.reset_window_acc()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for w in range(WINDOWS):
            starts = [(w * WINDOW_STEPS + k) * TRAIN_BATCH
                      for k in range(WINDOW_STEPS)]
            stats = net.run_window_sliced(
                starts, TRAIN_BATCH, [TRAIN_BATCH] * WINDOW_STEPS, hypers_s)
            losses.append(stats["loss"])
        # the epoch's one readback
        host = net.host_fetch({"acc": net.window_acc,
                               "loss": torch.stack(losses)})
        dt = time.perf_counter() - t0
        rates.append(per_epoch / dt)
        window_loss = host["loss"].mean(axis=1)
        say("   epoch %d: window mean losses %s, n_err %s, max_err_sum "
            "%.6g; %.2f s, %.1f images/s; %s" % (
                epoch + 1, " ".join("%.6f" % v for v in window_loss),
                host["acc"]["n_err"].tolist(),
                float(host["acc"]["max_err_sum"]), dt, rates[-1], card))
        if not numpy.isfinite(host["loss"]).all():
            raise RuntimeError("a loss is not finite: %s" % host["loss"])
        if int(host["acc"]["n_err"][1]) != per_epoch:
            raise RuntimeError("epoch %d evaluated %d rows, not %d" % (
                epoch + 1, host["acc"]["n_err"][1], per_epoch))
    launches = _counts()
    n_steps = EPOCHS * WINDOWS * WINDOW_STEPS
    if not net.params_finite():
        raise RuntimeError("a parameter is not finite after training")
    say("   %d steps: %s; parameters finite" % (n_steps, launches))
    if launches["forward"] != 3 * n_steps or \
            launches["backward"] != 3 * n_steps or \
            launches["forward_by_width"][NARROW] or \
            launches["backward_by_width"][WIDE] != 3 * n_steps or \
            launches["plain_on_card"]:
        raise RuntimeError("expected 3 forward and 3 backward kernel "
                           "launches a step at 16-byte vectors and no plain "
                           "pooling on the card, got %s for %d steps"
                           % (launches, n_steps))
    say("   images/s over the timed epochs: %s, %.1f over epochs 2-%d; %s"
        % (" ".join("%.1f" % r for r in rates),
           per_epoch * (EPOCHS - 1) / sum(per_epoch / r for r in rates[1:]),
           EPOCHS, card))
    breakdown = _step_breakdown(torch, net, x_dev, lbl_dev, cycles_per_ms,
                                card)
    t0 = time.perf_counter()
    net_launches = _health_and_rollback(torch, net, x_dev, lbl_dev, card)
    say("   the resilience checks on this net: %.2f s" % (
        time.perf_counter() - t0))
    return launches, breakdown, net_launches


def _step_breakdown(torch, net, x, lbl, cycles_per_ms, card):
    """Device ms of one batch-128 train step split into forward (with
    the loss), backward and update, and the host's enqueue time of the
    step: CUDA events at the step's marks, median of 10, after a device
    spin of four times the slowest warm-up enqueue so the host is ahead
    of the device all through the step.  Raises if the host's enqueue
    ever reaches the spin."""
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        net.step(x, lbl)
        warm.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    spin_ms = 4e3 * max(warm)
    parts = ("forward", "backward", "update")
    samples = {k: [] for k in parts + ("host",)}
    gc.disable()
    try:
        for _ in range(10):
            torch.cuda._sleep(int(spin_ms * cycles_per_ms))
            events = {}

            def mark(name):
                events[name] = torch.cuda.Event(enable_timing=True)
                events[name].record()
            t0 = time.perf_counter()
            mark("start")
            net.step(x, lbl, mark=mark)
            samples["host"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            for a, b in zip(("start",) + parts, parts):
                samples[b].append(events[a].elapsed_time(events[b]))
    finally:
        gc.enable()
    if max(samples["host"]) >= spin_ms:
        raise RuntimeError("the host took %.4f ms to enqueue a step, the "
                           "device spin lasts %.4f ms"
                           % (max(samples["host"]), spin_ms))
    ms = {k: statistics.median(v) for k, v in samples.items()}
    total = sum(ms[k] for k in parts)
    say("   one train step, batch %d, device ms (median of 10, host ahead "
        "by a %.1f ms spin): forward %.4f, backward %.4f, update %.4f, "
        "total %.4f (%.1f images/s of device time); the host enqueues it "
        "in %.4f ms; peak device memory %.1f GB; %s"
        % (TRAIN_BATCH, spin_ms, ms["forward"], ms["backward"], ms["update"],
           total, TRAIN_BATCH / total * 1e3, ms["host"],
           torch.cuda.max_memory_allocated() / 1e9, card))
    ms["total"] = total
    return ms


def phase_train_kernels(torch, card, cycles_per_ms):
    """Both kernels at the three training shapes (batch 128): checked
    bit for bit against their plain versions (values and offsets; the
    gradient), then timed cold beside their bounds, their plain versions
    and the library yardsticks (``F.max_pool2d``;
    ``max_pool2d_with_indices_backward`` on its indices), which the port
    never calls, and the backward at its runtime-stride instantiation
    and at each tile budget of ``TILE_SWEEP_KB``.  Returns the rows and
    each kernel's max |difference|."""
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.ops import pooling
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.ones(32 << 20, device="cuda").sum  # reads 128 MiB
    rows = {"forward": {}, "backward": {}}
    max_err = {"forward": 0.0, "backward": 0.0}
    for label, shape in TRAIN_POOLS:
        x = torch.randn(shape, generator=gen, device="cuda")
        x_nchw = x.permute(0, 3, 1, 2)
        b, h, w, c = shape
        ny, nx = pooling.output_spatial(h, w, 3, 3, (2, 2))
        n_in, n_out = x.numel(), b * ny * nx * c
        values, offs = cuda_pooling.max_pooling_offsets(x, 3, 3, (2, 2))
        err = torch.randn(offs.shape, generator=gen, device="cuda")
        grad = cuda_pooling_backward.max_pooling_offsets_backward(
            err, offs, shape, 3, 3, (2, 2))
        p_values, p_offs = pooling.max_pooling_plain(x, 3, 3, (2, 2))
        p_grad = pooling.max_pooling_backward_plain(err, offs, shape, 3, 3,
                                                    (2, 2))
        torch.cuda.synchronize()
        if not (_bits_equal(torch, values, p_values) and
                torch.equal(offs, p_offs)):
            raise RuntimeError("forward kernel disagrees with its plain "
                               "version at %s %s" % (label, shape))
        if not _bits_equal(torch, grad, p_grad):
            raise RuntimeError("backward kernel disagrees with its plain "
                               "version at %s %s (%d cells differ)" % (
                                   label, shape,
                                   (grad != p_grad).sum().item()))
        max_err["forward"] = max(max_err["forward"],
                                 _max_abs_diff(values, p_values))
        max_err["backward"] = max(max_err["backward"],
                                  _max_abs_diff(grad, p_grad))
        say("   %s %s f32: both kernels bit-equal to their plain versions "
            "(values and offsets; the gradient, %d nonzero cells)"
            % (label, shape, (p_grad != 0).sum().item()))
        del values, grad, p_values, p_offs, p_grad
        err_nchw = err.permute(0, 3, 1, 2)
        _, idx = F.max_pool2d(x_nchw, 3, 2, ceil_mode=True,
                              return_indices=True)
        work = {
            # input read, values and offsets written; 9 compares an output
            "forward": (n_in * 4 + n_out * 8, n_out * 9, {
                "ms": lambda: cuda_pooling.max_pooling_offsets(
                    x, 3, 3, (2, 2)),
                "plain_ms": lambda: pooling.max_pooling_plain(
                    x, 3, 3, (2, 2)),
                "library_ms": lambda: F.max_pool2d(
                    x_nchw, 3, 2, ceil_mode=True, return_indices=True)}),
            # err and offsets read, the input gradient written; each
            # window's offsets compared by its 9 cells, its err added once
            "backward": (n_out * 8 + n_in * 4, n_out * 10, {
                "ms": lambda: cuda_pooling_backward
                .max_pooling_offsets_backward(err, offs, shape, 3, 3,
                                              (2, 2)),
                "plain_ms": lambda: pooling.max_pooling_backward_plain(
                    err, offs, shape, 3, 3, (2, 2)),
                "library_ms": lambda: torch.ops.aten
                .max_pool2d_with_indices_backward(
                    err_nchw, x_nchw, [3, 3], [2, 2], [0, 0], [1, 1], True,
                    idx)})}
        for kind, (nbytes, ops, fns) in work.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            iters = SMALL_TIMING_ITERS if bound < 0.01 else TIMING_ITERS
            row = {"bound_ms": bound,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            for key, fn in fns.items():
                row[key], row[key[:-2] + "host_ms"] = _median_ms(
                    torch, fn, flush, cycles_per_ms, iters)
            rows[kind][label] = row
            say("   %s %s %s f32: kernel %.4f ms (host enqueue %.4f ms), "
                "plain %.4f ms, library %.4f ms, bound %.4f ms (%.1f MB), "
                "%.0f%% of bound; %d samples; %s"
                % (kind, label, shape, row["ms"], row["host_ms"],
                   row["plain_ms"], row["library_ms"], bound, nbytes / 1e6,
                   100 * bound / row["ms"], iters, card))
        row = rows["backward"][label]
        iters = SMALL_TIMING_ITERS if row["bound_ms"] < 0.01 else \
            TIMING_ITERS
        say("   backward %s plan: %s" % (
            label, cuda_pooling_backward.launch_plan(shape, 4, 4, 3, 3,
                                                     (2, 2))))
        row["runtime_stride_ms"] = _runtime_stride_ms(
            torch, work["backward"][2]["ms"], flush, cycles_per_ms, iters)
        say("   backward %s at the runtime-stride instantiation: %.4f ms "
            "(stride 2: %.4f ms before it, at 24 KB in the sweep after "
            "it); %s" % (label, row["runtime_stride_ms"], row["ms"], card))
        say("   backward %s kernel ms by tile budget in KB: %s" % (
            label, json.dumps(_tile_sweep(
                torch, cuda_pooling_backward, work["backward"][2]["ms"],
                flush, cycles_per_ms, iters))))
    return rows, max_err


#: the serve_models phase: AlexNet's serving dtypes and CIFAR's
SERVE_DTYPES = ("f32", "bf16", "int8")
CIFAR_SERVE_DTYPES = ("f32", "bf16")
#: the caching allocator's rounding of one tensor's block: a block
#: under 1 MB rounds up to 512 bytes; a larger one is split off a cached
#: block only when more than 1 MB would remain, so it may hold up to
#: 1 MB more than it asked for (CUDACachingAllocator's kMinBlockSize,
#: kSmallSize)
ALLOC_ROUND, ALLOC_LARGE_SLACK = 512, 1 << 20
#: the int8 model's device bytes against the f32 twin's, at most
INT8_BYTES_RATIO = 0.27
#: rows of the CIFAR replies held against the CPU's plain forward
CIFAR_SERVE_ROWS = 8


def _npy(x):
    import numpy
    buf = io.BytesIO()
    numpy.save(buf, x)
    return buf.getvalue()


def _serve_counted(torch, server, engine, images, label, card):
    """Requests of 1, 3, 17 and 64 rows (``.npy``) through ``server``
    with every count set to 0 just before and read just after: each must
    answer 200 with finite rows, and each dispatch launch exactly one
    forward kernel a max pool of the model (3 for AlexNet, 1 for CIFAR
    caffe), all at 16-byte vectors, with no plain pooling on the card.  Returns the launches, the replies by
    size and the request latencies (ms)."""
    import numpy
    per_dispatch = sum(e["type"] == "max_pooling" for e in engine.layers)
    conn = http.client.HTTPConnection(server.host, server.port, timeout=300)
    replies = {}
    try:
        _zero_counts()
        d0 = engine.dispatches
        for n in (1, 3, 17, 64):
            status, raw = _post(conn, _npy(images[:n]),
                                "application/octet-stream")
            if status != 200:
                raise RuntimeError("%s: /predict answered %d: %r"
                                   % (label, status, raw[:300]))
            out = numpy.load(io.BytesIO(raw))
            if out.shape[0] != n or not numpy.isfinite(out).all():
                raise RuntimeError("%s: a reply of shape %s for %d rows"
                                   % (label, out.shape, n))
            replies[n] = out
        counts = _counts()
        dispatches = engine.dispatches - d0
        lat = {}
        for n, count in ((1, 20), (64, 5)):
            ms = []
            for _ in range(count):
                t0 = time.perf_counter()
                status, _ = _post(conn, _npy(images[:n]),
                                  "application/octet-stream")
                ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise RuntimeError("%s: /predict answered %d"
                                       % (label, status))
            lat[n] = sorted(ms)
    finally:
        conn.close()
    launches = counts["forward"]
    if launches == 0 or launches != per_dispatch * dispatches or \
            counts["forward_by_width"][NARROW] or counts["plain_on_card"]:
        raise RuntimeError(
            "%s: %d dispatches launched %s forward kernels (%s, %d plain "
            "pools on the card); expected %d a dispatch, all at 16-byte "
            "vectors" % (label, dispatches, launches,
                         counts["forward_by_width"],
                         counts["plain_on_card"], per_dispatch))
    say("   %s: 4 requests answered 200 in %d dispatches, %d forward "
        "launches (%d a dispatch, all 16-byte), no plain pooling"
        % (label, dispatches, launches, per_dispatch))
    return launches, replies, lat


def _percentile(ms, q):
    return ms[min(len(ms) - 1, int(round(q * (len(ms) - 1))))]


def _throughput(engine, images):
    """Batch-64 dispatch ms (host wall, ``.npy`` in and out, ends on the
    device's reply) and images/s over 10 back-to-back dispatches."""
    engine.predict(images)
    t0 = time.perf_counter()
    for _ in range(10):
        engine.predict(images)
    dt = (time.perf_counter() - t0) / 10
    return {"dispatch_ms": dt * 1e3, "images_per_s": len(images) / dt}


def _alexnet_dtypes(torch, source, images, card):
    """AlexNet's package served in f32, bf16 and int8: the accuracy
    report within its pins for every bucket, 3 forward launches a
    dispatch, and the bf16 forward bit-equal to the same forward with
    the plain pooling in the kernel's place.  Returns the launches by
    dtype, the f32 engine and its server (for the reload), the timings
    and the device bytes by dtype."""
    from znicz_tpu_torch.ops import pooling
    from znicz_tpu_torch.serving import accuracy, engine as engine_mod
    from znicz_tpu_torch.serving.server import ServingServer
    t0 = time.perf_counter()
    report = accuracy.dtype_delta_report(
        source, dtypes=("bf16", "int8"), n_rows=64, seed=0, max_batch=64,
        device="cuda")
    ok, failures = accuracy.check(report)
    say("   accuracy report (%.2f s, buckets %s, %d rows): %s" % (
        time.perf_counter() - t0, report["buckets"], report["rows"],
        "; ".join("%s max_delta %.4g (pin %.4g), flip_rate %.4g (pin %.4g)"
                  % (dt, b["max_delta"], b["tolerance"]["max_delta"],
                     b["flip_rate"], b["tolerance"]["flip_rate"])
                  for dt, b in sorted(report["dtypes"].items()))))
    if not ok:
        raise RuntimeError("AlexNet outside its accuracy pins: %s"
                           % failures)
    launches, timing, dev_bytes, keep = {}, {}, {}, None
    for dt in SERVE_DTYPES:
        engine = engine_mod.InferenceEngine(source, max_batch=64,
                                            device="cuda", dtype=dt)
        dev_bytes[dt] = engine.device_bytes
        server = ServingServer(engine, port=0).start()
        try:
            n, _, lat = _serve_counted(torch, server, engine, images,
                                       "alexnet %s" % dt, card)
        except BaseException:
            server.stop()
            raise
        launches[dt] = n
        timing[dt] = dict(_throughput(engine, images),
                          p50_1=_percentile(lat[1], 0.5),
                          p99_1=_percentile(lat[1], 0.99),
                          p50_64=_percentile(lat[64], 0.5),
                          p99_64=_percentile(lat[64], 0.99))
        say("   alexnet %s: batch-64 dispatch %.3f ms, %.1f images/s; "
            "request p50/p99 %.2f/%.2f ms (1 row, 20 requests), "
            "%.2f/%.2f ms (64 rows, 5); %.1f MB of parameters on the "
            "card; %s" % (dt, timing[dt]["dispatch_ms"],
                          timing[dt]["images_per_s"], timing[dt]["p50_1"],
                          timing[dt]["p99_1"], timing[dt]["p50_64"],
                          timing[dt]["p99_64"], dev_bytes[dt] / 1e6, card))
        if dt == "bf16":
            _bf16_plain_control(torch, engine, images, pooling)
        if dt == "f32":
            keep = (engine, server)
        else:
            server.stop()
            del engine, server
    return launches, keep, timing, dev_bytes


def _bf16_plain_control(torch, engine, images, pooling):
    """The bf16 engine's forward of a batch of 64, with the kernel and
    with the plain pooling in its place, under cudnn.deterministic: the
    replies must be bit-equal."""
    import numpy
    from znicz_tpu_torch.serving import engine as engine_mod
    x = torch.from_numpy(images).to(engine.device)
    real = pooling.max_pooling

    def plain(t, ky, kx, sliding, use_abs=False):
        return pooling.max_pooling_plain(t, ky, kx, sliding, use_abs)
    with torch.inference_mode():
        kernel = engine_mod.forward(engine.layers, engine.params, x,
                                    "bf16").cpu().numpy()
        pooling.max_pooling = plain
        try:
            ref = engine_mod.forward(engine.layers, engine.params, x,
                                     "bf16").cpu().numpy()
        finally:
            pooling.max_pooling = real
    if not numpy.array_equal(kernel.view(numpy.uint32),
                             ref.view(numpy.uint32)):
        raise RuntimeError("the bf16 forward on the kernel differs from "
                           "the plain pooling's (max |diff| %g)"
                           % float(numpy.abs(kernel - ref).max()))
    say("   bf16: the served forward of 64 rows bit-equal to the same "
        "forward with max_pooling_plain in the kernel's place")


def _cifar_rows():
    """64 rows of the data the CIFAR model was trained on: the VALID rows
    of the CIFAR loader's synthetic set (its class prototypes plus
    noise) at a 1,000-row TRAIN draw, after ``internal_mean``."""
    import numpy
    from znicz_tpu_torch.core.workflow import Workflow
    from znicz_tpu_torch.loader.loader_cifar import CifarLoader
    loader = CifarLoader(Workflow(None), synthetic_train=1000,
                         synthetic_valid=64, minibatch_size=64,
                         normalization_type="internal_mean")
    loader.load_data()
    loader.initialize(device="cpu")
    return numpy.array(loader.original_data.mem[:64], numpy.float32)


def _cifar_latest(torch, snapdir, card):
    """The CIFAR caffe snapshot through ``serve --latest cifar_caffe``
    in f32 and bf16: 1 forward launch a dispatch; f32 rows against the
    port's plain forward on the CPU within LOG_P_TOL in log p, bf16
    within its accuracy pin of the f32 replies.  Returns the launches
    by dtype, the snapshot's path and its device bytes by dtype."""
    import numpy
    from znicz_tpu_torch.launcher import newest_snapshot
    from znicz_tpu_torch.serving import accuracy, engine as engine_mod
    from znicz_tpu_torch.serving.server import serve
    snapshot = newest_snapshot(snapdir, "cifar_caffe")
    if snapshot is None:
        raise RuntimeError("no cifar_caffe snapshot under %s" % snapdir)
    images = _cifar_rows()
    launches, replies, dev_bytes = {}, {}, {}
    for dt in CIFAR_SERVE_DTYPES:
        server, label = serve(["cifar_caffe", "--latest", "--directory",
                               snapdir, "--dtype", dt, "--port", "0",
                               "--max-batch", "64"])
        try:
            if label != snapshot:
                raise RuntimeError("--latest served %s, not %s"
                                   % (label, snapshot))
            launches[dt], replies[dt], lat = _serve_counted(
                torch, server, server.engine, images, "cifar %s" % dt, card)
            tp = _throughput(server.engine, images)
            dev_bytes[dt] = server.engine.device_bytes
        finally:
            server.drain()
        say("   cifar %s: batch-64 dispatch %.3f ms, %.1f images/s; request "
            "p50/p99 %.2f/%.2f ms (1 row); %s" % (
                dt, tp["dispatch_ms"], tp["images_per_s"],
                _percentile(lat[1], 0.5), _percentile(lat[1], 0.99), card))
    cpu = engine_mod.InferenceEngine(snapshot, buckets=(CIFAR_SERVE_ROWS,),
                                     warmup=False, device="cpu")
    ref = cpu.predict(images[:CIFAR_SERVE_ROWS])
    err = _prob_errors([(replies["f32"][64][:CIFAR_SERVE_ROWS], ref)])
    delta = max(float(numpy.abs(replies["bf16"][n] - replies["f32"][n])
                      .max()) for n in replies["f32"])
    flips = numpy.mean(replies["bf16"][64].argmax(1) !=
                       replies["f32"][64].argmax(1))
    pin = accuracy.TOLERANCES["bf16"]
    say("   cifar (%s): f32 rows against the CPU's plain forward max |diff "
        "log p| %.3g (limit %g); bf16 against f32 max |diff| %.4g (pin "
        "%g), flip rate %.4g (pin %g); replies spread %.3g"
        % (os.path.basename(snapshot), err[1], LOG_P_TOL, delta,
           pin["max_delta"], flips, pin["flip_rate"],
           float(numpy.ptp(ref))))
    if not err[1] <= LOG_P_TOL:
        raise RuntimeError("CIFAR f32 replies differ from the CPU's: max "
                           "|diff log p| %g" % err[1])
    if delta > pin["max_delta"] or flips > pin["flip_rate"]:
        raise RuntimeError("CIFAR bf16 outside its pin of f32")
    return launches, snapshot, dev_bytes


def _hot_reload(torch, engine, server, other, bad, images, card):
    """POST /reload of ``bad`` (fails at warmup: answers an error,
    version 1 serves on), then of ``other`` (AlexNet with other weights
    and the same topology) while a client thread keeps requesting: no
    request fails, the version goes 1 -> 2, no warmup dispatch runs, and
    the replies after the swap equal a fresh engine's on ``other``'s
    arrays bit for bit.  Returns the reload's wall ms."""
    import threading
    import numpy
    from znicz_tpu_torch.serving import engine as engine_mod
    row = images[:1]
    statuses, versions = [], []
    stop = threading.Event()

    def client():
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=300)
        body = json.dumps({"inputs": row.astype(int).tolist()})
        try:
            while not stop.is_set():
                status, raw = _post(conn, body, "application/json")
                statuses.append(status)
                if status == 200:
                    versions.append(json.loads(raw)["model_version"])
        finally:
            conn.close()
    conn = http.client.HTTPConnection(server.host, server.port, timeout=300)
    try:
        status, raw = _post(conn, json.dumps({"path": bad}),
                            "application/json", "/reload")
        if status != 400 or engine.version != 1 or not engine.ready:
            raise RuntimeError("a reload failing at warmup answered %d, "
                               "version %d" % (status, engine.version))
        out = numpy.load(io.BytesIO(_post(conn, _npy(row),
                                          "application/octet-stream")[1]))
        if not numpy.array_equal(out, engine.predict(row)):
            raise RuntimeError("after the failed reload v1 serves other "
                               "replies")
        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        try:
            time.sleep(0.2)
            warm0 = engine.warmup_dispatches
            t0 = time.perf_counter()
            status, raw = _post(conn, json.dumps({"path": other[0]}),
                                "application/json", "/reload")
            reload_ms = (time.perf_counter() - t0) * 1e3
            if status != 200 or json.loads(raw)["model_version"] != 2:
                raise RuntimeError("/reload answered %d: %r"
                                   % (status, raw[:300]))
            time.sleep(0.2)
        finally:
            stop.set()
            thread.join(timeout=120)
    finally:
        conn.close()
    if thread.is_alive() or not statuses or set(statuses) != {200}:
        raise RuntimeError("requests during the reload answered %s"
                           % sorted(set(statuses)))
    if versions[0] != 1 or versions[-1] != 2 or sorted(versions) != versions:
        raise RuntimeError("the versions served went %s .. %s"
                           % (versions[:3], versions[-3:]))
    if engine.warmup_dispatches != warm0:
        raise RuntimeError("the reload ran %d warmup dispatches"
                           % (engine.warmup_dispatches - warm0))
    fresh = engine_mod.InferenceEngine(other[1], max_batch=64,
                                       device="cuda", warmup=False)
    conn = http.client.HTTPConnection(server.host, server.port, timeout=300)
    try:
        for n in (1, 64):
            status, raw = _post(conn, _npy(images[:n]),
                                "application/octet-stream")
            got = numpy.load(io.BytesIO(raw))
            if not numpy.array_equal(got.view(numpy.uint32), fresh.predict(
                    images[:n]).view(numpy.uint32)):
                raise RuntimeError("after the reload, %d rows differ from a "
                                   "fresh engine's on the new package" % n)
    finally:
        conn.close()
    say("   hot reload: a source failing at warmup answered 400 and v1 "
        "served on; /reload to other weights in %.1f ms, %d requests "
        "during it all 200 (versions %d..%d), no warmup dispatch, replies "
        "after it bit-equal to a fresh engine's; %s"
        % (reload_ms, len(statuses), versions[0], versions[-1], card))
    return reload_ms


def _registry_lru(torch, source, snapshot, sizes, images, card):
    """``alexnet@f32``, ``alexnet8@int8`` and ``cifar@bf16`` under a
    budget below their sum: the least recently used (alexnet) is
    evicted and the card's allocated memory drops by its device bytes
    within the allocator's rounding; the next request restores it with
    its replies bit-equal; int8 takes at most INT8_BYTES_RATIO of f32's
    bytes.  ``sizes`` are each model's device bytes, from the phases
    that served them.  Returns the evict and restore ms."""
    import numpy
    from znicz_tpu_torch.serving.registry import ModelRegistry
    budget = sum(sizes.values()) - 1
    reg = ModelRegistry(memory_budget_bytes=budget, max_batch=64,
                        device="cuda")
    reg.add("alexnet", source)
    before = reg.engine("alexnet").predict(images)
    reg.add("alexnet8", source, dtype="int8")
    reg.engine("alexnet8").predict(images[:1])
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    reg.add("cifar", snapshot, dtype="bf16")
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    alexnet = reg.peek("alexnet")
    # the host copies have the device tensors' sizes
    rounding = sum(ALLOC_LARGE_SLACK if v.nbytes >= ALLOC_LARGE_SLACK
                   else ALLOC_ROUND
                   for name in ("alexnet", "cifar")
                   for p in reg.peek(name)._model.host_params
                   for v in p.values())
    drop = m0 - m1 + sizes["cifar"]
    if alexnet.resident or not reg.peek("alexnet8").resident:
        raise RuntimeError("the budget evicted %s" % {
            n: not reg.peek(n).resident for n in reg.names()})
    if abs(drop - sizes["alexnet"]) > rounding:
        raise RuntimeError("the eviction freed %d bytes, alexnet holds %d"
                           % (drop, sizes["alexnet"]))
    ratio = sizes["alexnet8"] / sizes["alexnet"]
    if ratio > INT8_BYTES_RATIO:
        raise RuntimeError("int8 holds %.3f of f32's bytes" % ratio)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = reg.engine("alexnet")  # restores, evicting alexnet8
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    after = engine.predict(images)
    if not numpy.array_equal(after.view(numpy.uint32),
                             before.view(numpy.uint32)):
        raise RuntimeError("the restored alexnet's replies differ")
    if reg.peek("alexnet8").resident:
        raise RuntimeError("restoring alexnet evicted nothing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.evict()
    torch.cuda.synchronize()
    evict_ms = (time.perf_counter() - t0) * 1e3
    say("   registry, budget %d bytes (their sum less 1): alexnet@f32 %d, "
        "alexnet8@int8 %d (%.4f of f32), cifar@bf16 %d bytes; adding cifar "
        "evicted alexnet, the LRU, and memory_allocated fell by %d (its "
        "bytes within %d); the next request restored it in %.1f ms "
        "(upload and warmup of %d buckets; alexnet8 evicted) with "
        "bit-equal replies; an evict takes %.2f ms; %s" % (
            budget, sizes["alexnet"], sizes["alexnet8"], ratio,
            sizes["cifar"], drop, rounding, restore_ms,
            len(engine.buckets), evict_ms, card))
    return {"evict_ms": evict_ms, "restore_ms": restore_ms}


def phase_serve_models(torch, card, cifar_snapdir):
    """What the port trains, served (see the module docstring, phase
    13).  Returns the forward launches by dtype and the numbers."""
    import shutil
    import numpy
    from znicz_tpu_torch.export import import_package, write_package
    out_dir = SMOKE_DIR
    path = os.path.join(out_dir, "alexnet.zip")
    t0 = time.perf_counter()
    source = import_package(path)
    manifest, arrays = source
    other = dict(arrays)
    for entry in manifest["layers"]:
        for attr, fname in entry.get("arrays", {}).items():
            if attr == "weights":
                other[fname] = arrays[fname] * numpy.float32(0.9)
    other_path = write_package(manifest, other,
                               os.path.join(out_dir, "alexnet_other.zip"))
    bad_path = write_package(
        {"format": 1, "input_sample_shape": manifest["input_sample_shape"],
         "layers": [{"type": "softmax", "name": "fc",
                     "arrays": {"weights": "w.npy"}}]},
        {"w.npy": numpy.ones((10, 7), numpy.float32)},
        os.path.join(out_dir, "bad.zip"))
    say("== serve_models: AlexNet package read, a twin with its weights "
        "x0.9 and a package failing at warmup written in %.2f s"
        % (time.perf_counter() - t0))
    images = numpy.random.RandomState(1).randint(
        -128, 128, (64,) + tuple(manifest["input_sample_shape"])).astype(
            numpy.float32)
    torch.backends.cudnn.deterministic = True
    try:
        launches, (engine, server), timing, dev_bytes = _alexnet_dtypes(
            torch, source, images, card)
        try:
            reload_ms = _hot_reload(torch, engine, server,
                                    (other_path, (manifest, other)),
                                    bad_path, images, card)
        finally:
            server.stop()
        del engine, server, other
        cifar_launches, snapshot, cifar_bytes = _cifar_latest(
            torch, cifar_snapdir, card)
        reg = _registry_lru(torch, source, snapshot, {
            "alexnet": dev_bytes["f32"], "alexnet8": dev_bytes["int8"],
            "cifar": cifar_bytes["bf16"]}, images, card)
    finally:
        torch.backends.cudnn.deterministic = False
        for p in (os.path.join(out_dir, "alexnet_other.zip"),
                  os.path.join(out_dir, "bad.zip")):
            if os.path.exists(p):
                os.remove(p)
        shutil.rmtree(os.path.dirname(cifar_snapdir), ignore_errors=True)
    by_dtype = {dt: launches.get(dt, 0) + cifar_launches.get(dt, 0)
                for dt in SERVE_DTYPES}
    return by_dtype, {"alexnet": timing, "reload_ms": reload_ms,
                      "registry": reg, "device_bytes": dev_bytes,
                      "cifar_device_bytes": cifar_bytes}


def _iae_argv(snapdir, stage, restore, *extra):
    """The CLI's arguments for ImagenetAE's first ``stage`` stages at
    the phase's size, restoring the earlier stages from ``restore``."""
    argv = ["research.imagenet_ae"]
    for key, value in (("loader.size", IAE_SIZE),
                       ("loader.n_images", IAE_IMAGES),
                       ("loader.minibatch_size", IAE_BATCH),
                       ("decision.max_epochs", IAE_EPOCHS),
                       ("snapshotter.directory", snapdir),
                       ("n_stages", stage), ("restore_snapshot", restore)):
        argv += ["--config", "imagenet_ae.%s=%s" % (key, value)]
    return argv + list(extra)


class _IaeData(object):
    """While installed (``with``), ImagenetAE's synthetic images are
    drawn once for each (size, count): a draw is a function of the two
    alone, and 256 images of 227x227 take about a second of the host."""

    def __init__(self):
        from znicz_tpu_torch.samples.research import imagenet_ae
        self.cls = imagenet_ae.SyntheticImageLoader
        self.real = self.cls.__dict__["load_data"]
        self.memo = {}

    def __enter__(self):
        memo, real = self.memo, self.real

        def load_data(loader):
            key = (loader.size, loader.n_images)
            if key not in memo:
                real(loader)
                memo[key] = (list(loader.class_lengths),
                             loader.original_data.mem.copy())
                return
            lengths, data = memo[key]
            loader.class_lengths[:] = lengths
            loader.original_data.reset(data.copy())
        self.cls.load_data = load_data
        return self

    def __exit__(self, *exc):
        self.cls.load_data = self.real


class _DrawTimes(object):
    """While installed (``with``), the host seconds of each stochastic
    pool's stream (``StochasticPoolingBase._rand``: the host draw from
    ``prng.get()`` and its upload), and of the draw alone (the stream's
    ``randint``), by unit name."""

    def __init__(self):
        from znicz_tpu_torch.core import prng
        from znicz_tpu_torch.units.pooling import StochasticPoolingBase
        self.cls, self.gen = StochasticPoolingBase, prng.get()
        self.real = self.cls.__dict__["_rand"]
        self.rand_s = collections.Counter()
        self.draw_s = collections.Counter()

    def __enter__(self):
        real, gen, times = self.real, self.gen, self
        real_randint = gen.randint

        def randint(*args, **kwargs):
            t0 = time.perf_counter()
            out = real_randint(*args, **kwargs)
            times.draw_s[times.current] += time.perf_counter() - t0
            return out

        def _rand(unit):
            times.current = unit.name
            t0 = time.perf_counter()
            out = real(unit)
            times.rand_s[unit.name] += time.perf_counter() - t0
            return out
        gen.randint = randint
        self.cls._rand = _rand
        return self

    def __exit__(self, *exc):
        self.cls._rand = self.real
        del self.gen.randint


def phase_mse_zoo(torch, card, cycles_per_ms, imports):
    """ImagenetAE's published ladder at 227x227 through the CLI's unit
    graph, the other MSE samples on the card, the fused trainer's three
    window forms and its stochastic pools.  Returns ImagenetAE's
    launches, the fused stochastic stages' and the depooling's timing
    rows."""
    import shutil
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root
    rows = _iae_kernels(torch, card, cycles_per_ms)
    base = os.path.join(HERE, "build", "znicz_tpu_torch", "mse_zoo")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probe = _UnitsProbe(torch)
    try:
        with _IaeData() as data:
            launches = _iae_ladder(torch, probe, cli, prng, base, card)
            _iae_card_vs_cpu(torch)
            fused_launches = _fused_stochastic(torch, data, card)
        _mse_samples(torch, probe, cli, prng, base, imports.result(), card)
    finally:
        probe.close()
        torch.backends.cudnn.deterministic = False
        for key in ("n_stages", "restore_snapshot"):
            root.imagenet_ae.__dict__.pop(key, None)
        shutil.rmtree(base, ignore_errors=True)
    return launches, fused_launches, rows


def _iae_kernels(torch, card, cycles_per_ms):
    """The backward kernel as ImagenetAE's depooling at the four stages'
    shapes: on stochastic abs winners (``pooling.stochastic_pooling`` on
    a stream drawn on the card) bit-equal to its plain version in f32
    and f64, every launch at 16-byte vectors; then in f32 cold beside
    its bound, its plain version and ``index_add_`` (median of 50)."""
    from znicz_tpu_torch.ops import cuda_pooling_backward, pooling
    gen = torch.Generator(device="cuda").manual_seed(11)
    t0 = time.perf_counter()
    cases = {}
    for label, shape in IAE_POOLS:
        b, h, w, c = shape
        ny, nx = pooling.output_spatial(h, w, 3, 3, (2, 2))
        rand = torch.randint(0, 1 << 16, (b * ny * nx * c,), generator=gen,
                             device="cuda", dtype=torch.int32)
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            values, offs = pooling.stochastic_pooling(x, rand, 3, 3, (2, 2),
                                                      True)
            wide = cuda_pooling_backward.LAUNCHES_WIDE
            got = cuda_pooling_backward.max_pooling_offsets_backward(
                values, offs, shape, 3, 3, (2, 2))
            launched_wide = cuda_pooling_backward.LAUNCHES_WIDE - wide
            want = pooling.max_pooling_backward_plain(values, offs, shape,
                                                      3, 3, (2, 2))
            torch.cuda.synchronize()
            if not _bits_equal(torch, got, want) or launched_wide != 1:
                raise RuntimeError(
                    "the depooling at %s %s %s: bit-equal %s, %d 16-byte "
                    "launches" % (label, shape, dtype,
                                  _bits_equal(torch, got, want),
                                  launched_wide))
            if dtype == torch.float32:
                cases[label] = (values, offs)
    say("== mse_zoo: the depooling (the backward kernel on stochastic abs "
        "winners) at ImagenetAE's stages %s, 3x3/s2 ceil mode: bit-equal to "
        "its plain version in f32 and f64, every launch at 16-byte vectors "
        "(%.2f s)" % (", ".join(str(s) for _, s in IAE_POOLS),
                      time.perf_counter() - t0))
    flush = torch.ones(32 << 20, device="cuda").sum  # reads 128 MiB
    out = {}
    for label, shape in IAE_POOLS:
        values, offs = cases[label]
        n_in, n_out = math.prod(shape), values.numel()
        flat = offs.view(-1).long()
        nbytes = n_out * 8 + n_in * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_out / F32_OPS_PER_S * 1e3
        row = {"bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        for key, fn in (
                ("ms", lambda: cuda_pooling_backward
                 .max_pooling_offsets_backward(values, offs, shape, 3, 3,
                                               (2, 2))),
                ("plain_ms", lambda: pooling.max_pooling_backward_plain(
                    values, offs, shape, 3, 3, (2, 2))),
                ("library_ms", lambda: torch.zeros(
                    n_in, device="cuda").index_add_(0, flat,
                                                    values.view(-1)))):
            row[key], row[key[:-2] + "host_ms"] = _median_ms(
                torch, fn, flush, cycles_per_ms, TIMING_ITERS)
        out[label] = row
        say("   depooling %s %s f32 (16-byte): kernel %.4f ms (host enqueue "
            "%.4f ms), plain %.4f ms, library %.4f ms (index_add_), bound "
            "%.5f ms (%.2f MB), %.0f%% of bound; %d samples; %s" % (
                label, shape, row["ms"], row["host_ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"], nbytes / 1e6,
                100 * row["bound_ms"] / row["ms"], TIMING_ITERS, card))
    return {"forward": {}, "backward": out}


def _iae_ladder(torch, probe, cli, prng, base, card):
    """ImagenetAE's four stages through the CLI, each grown from the
    last one's snapshot: exactly one backward launch a minibatch, TRAIN
    and VALID, at 16-byte vectors at all four widths, no forward launch,
    no plain pooling; the frozen stages bit-equal to the snapshot they
    came from; the last stage replayed and resumed bit for bit."""
    import numpy
    from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    n_valid = IAE_IMAGES // 4
    n_train = IAE_IMAGES - n_valid
    per_stage = (-(-n_train // IAE_BATCH) + -(-n_valid // IAE_BATCH)) * \
        IAE_EPOCHS
    say("== mse_zoo: python -m znicz_tpu_torch %s" % " ".join(
        _iae_argv("build/...", "K", "PREVIOUS")))
    restore, runs, by_stage = None, [], []
    draws = _DrawTimes()
    _zero_counts()
    for stage in range(1, IAE_STAGES + 1):
        before = _counts()
        argv = _iae_argv(os.path.join(base, "stage%d" % stage), stage,
                         restore)
        if stage == 1:
            with draws:
                run = _units_run(probe, cli, prng, argv)
        else:
            run = _units_run(probe, cli, prng, argv)
        after = _counts()
        delta = {"backward": after["backward"] - before["backward"],
                 "wide": after["backward_by_width"][WIDE] -
                 before["backward_by_width"][WIDE]}
        by_stage.append(delta)
        wf, segs = run["wf"], run["segments"]
        got = [(s["epoch"], s["class"]) for s in segs]
        want = [(e, c) for e in range(IAE_EPOCHS) for c in (TRAIN, VALID)]
        shape = tuple(wf.depool.err_input.shape)
        if got != want or shape != IAE_POOLS[stage - 1][1] or \
                wf.deconv.weights is not wf.conv.weights or \
                delta != {"backward": per_stage, "wide": per_stage} or \
                tuple(wf.deconv.output.shape) != tuple(wf.conv.input.shape):
            raise RuntimeError(
                "stage %d: segments %s, depooling %s, launches %s; want %s, "
                "%s, %d at 16-byte" % (stage, got, shape, delta, want,
                                       IAE_POOLS[stage - 1][1], per_stage))
        if wf.loader.class_lengths != [0, n_valid, n_train]:
            raise RuntimeError("stage %d: class lengths %s" % (
                stage, wf.loader.class_lengths))
        for s in segs:
            m = s["metrics"]
            if m is None or not all(numpy.isfinite(v) for v in m) or \
                    not 0 <= m[2] <= m[0] <= m[1]:
                raise RuntimeError("stage %d segment metrics: %s"
                                   % (stage, s))
        if restore is not None:
            saved = SnapshotterToFile.import_(restore)["units"]
            for conv in wf.convs[:-1]:
                if not numpy.array_equal(
                        numpy.asarray(conv.weights.mem).view(numpy.uint8),
                        numpy.asarray(saved[conv.name]["weights"]).view(
                            numpy.uint8)):
                    raise RuntimeError("stage %d: the frozen %s moved"
                                       % (stage, conv.name))
        rates, run_s = _units_rates(run, n_train)
        say("   stage %d (%s): (TRAIN, VALID) MSE (avg, max, min) by epoch "
            "%s; depooling %s, %d backward launches at 16-byte vectors; "
            "TRAIN images/s by epoch %s (host clock), %.4f host ms a "
            "minibatch (%.2f s); %s" % (
                stage - 1, " -> ".join("%s %dx%dx%d" % (
                    c.name, c.output.shape[1], c.output.shape[2],
                    c.output.shape[3]) for c in wf.convs),
                [(a["metrics"], b["metrics"]) for a, b in
                 zip(segs[::2], segs[1::2])], shape, delta["backward"],
                " ".join("%.1f" % r for r in rates),
                1e3 * run_s / (per_stage), run_s, card))
        if stage == 1:
            say("   stage 0 host ms by unit over the run: %s" %
                _unit_times(wf))
            say("   stage 0 stochastic pool: pool0 %.1f host ms over %d "
                "runs, of which its stream %.1f (the host draw %.1f, the "
                "int32 copy and its upload %.1f), the pooling op %.1f" % (
                    1e3 * wf.pools[0].run_time_, wf.pools[0].run_count_,
                    1e3 * draws.rand_s["pool0"], 1e3 * draws.draw_s["pool0"],
                    1e3 * (draws.rand_s["pool0"] - draws.draw_s["pool0"]),
                    1e3 * (wf.pools[0].run_time_ - draws.rand_s["pool0"])))
        restore = run["snapshots"][-1][1]
        if stage < IAE_STAGES:
            del run, wf
            gc.collect()
    launches = _counts()
    for mod in ("jax", "znicz_tpu"):
        if mod in sys.modules:
            raise RuntimeError("%s was imported" % mod)
    n_mb = per_stage * IAE_STAGES
    if launches["backward"] != n_mb or launches["forward"] or \
            launches["backward_by_width"] != {WIDE: n_mb, NARROW: 0} or \
            launches["plain_on_card"]:
        raise RuntimeError("the ladder launched %s, not %d backward at "
                           "16-byte vectors and nothing else"
                           % (launches, n_mb))
    say("   the ladder: %s; the frozen stages bit-equal to the snapshot "
        "each stage grew from" % launches)
    t0 = time.perf_counter()
    previous = _iae_argv(os.path.join(base, "replay"), IAE_STAGES,
                         run["wf"].restore_snapshot)
    replay = _units_run(probe, cli, prng, previous)
    if _units_segments(replay["segments"]) != \
            _units_segments(run["segments"]):
        raise RuntimeError("the last stage's replay differs from the run")
    _units_equal(replay["state"], run["state"], "the last stage's replay")
    say("   replay of stage 3 from the same seeds: each epoch's [sum, max, "
        "min] metrics, the shared weights, GDDeconv's optimizer Arrays and "
        "the prng streams bit-equal to the run's (%.2f s)"
        % (time.perf_counter() - t0))
    del replay
    _resume_units(probe, cli, prng, run, lambda *extra: _iae_argv(
        os.path.join(base, "resumed"), IAE_STAGES, run["wf"].restore_snapshot,
        *extra))
    return launches


def _iae_card_vs_cpu(torch):
    """ImagenetAE's stages 0 and 3 (the first four frozen at their drawn
    weights) in f64, the first 4 TRAIN minibatches and a VALID one, on
    the card (the f64 depooling kernel) and on the CPU (its plain
    version) from one seed: every conv's weights and the velocity
    within ``UNITS_F64_RTOL`` of each tensor's largest, every stochastic
    winner equal."""
    import tempfile
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.ops import cuda_pooling_backward, pooling
    from znicz_tpu_torch.samples.research import imagenet_ae
    from znicz_tpu_torch.units.pooling import StochasticPoolingBase
    real_run = StochasticPoolingBase.run
    offsets = {}

    def run(unit):
        real_run(unit)
        offsets.setdefault(unit.device.type, []).append(
            unit.input_offset.dev.cpu().numpy().copy())
    saved = root.common.engine.precision_dtype
    root.common.engine.precision_dtype = numpy.float64
    StochasticPoolingBase.run = run
    plain = pooling.PLAIN_CUDA_CALLS
    try:
        for stages in IAE_F64_STAGES:
            t0 = time.perf_counter()
            offsets.clear()
            state, seconds = {}, {}
            for device in ("cuda", "cpu"):
                t1 = time.perf_counter()
                prng.get(1).seed(UNITS_SEED)
                prng.get(2).seed(UNITS_SEED + 1)
                before = cuda_pooling_backward.LAUNCHES
                with tempfile.TemporaryDirectory() as snapdir:
                    wf = imagenet_ae.build(
                        n_stages=stages,
                        loader_config={"size": IAE_SIZE,
                                       "n_images": IAE_F64_IMAGES,
                                       "minibatch_size": IAE_BATCH},
                        decision_config={"max_epochs": 1},
                        snapshotter_config={"directory": snapdir})
                    wf.initialize(device=device)
                    wf.run()
                state[device] = [numpy.array(c.weights.mem)
                                 for c in wf.convs] + [numpy.array(
                                     wf.gd_deconv
                                     .gradient_weights_with_moment.mem)]
                if device == "cuda":
                    launched = cuda_pooling_backward.LAUNCHES - before
                seconds[device] = time.perf_counter() - t1
                del wf
            worst = 0.0
            for g, w in zip(state["cuda"], state["cpu"]):
                if g.dtype != numpy.float64:
                    raise RuntimeError("ImagenetAE ran in %s" % g.dtype)
                worst = max(worst, numpy.abs(g - w).max() /
                            numpy.abs(w).max())
            n_mb = 5   # 4 TRAIN minibatches and a VALID one
            if not worst <= UNITS_F64_RTOL or launched != n_mb or \
                    len(offsets["cuda"]) != n_mb * stages or any(
                        not numpy.array_equal(a, b) for a, b in zip(
                            offsets["cuda"], offsets["cpu"])):
                raise RuntimeError(
                    "ImagenetAE stage %d in f64: %.3g relative from the CPU "
                    "(bound %g), %d depooling launches, winners equal: %s"
                    % (stages - 1, worst, UNITS_F64_RTOL, launched, all(
                        numpy.array_equal(a, b) for a, b in zip(
                            offsets["cuda"], offsets["cpu"]))))
            say("   card vs CPU, f64, stage %d (4 TRAIN minibatches and a "
                "VALID one of 8 at %dx%d): every conv's weights and the "
                "velocity within %.3g of the tensor's largest (bound %g), "
                "the %d pools' stochastic winners equal, on %d f64 "
                "depooling launches (card %.2f s, CPU %.2f s, %.2f s)" % (
                    stages - 1, IAE_SIZE, IAE_SIZE, worst, UNITS_F64_RTOL,
                    len(offsets["cuda"]), launched, seconds["cuda"],
                    seconds["cpu"], time.perf_counter() - t0))
    finally:
        StochasticPoolingBase.run = real_run
        root.common.engine.precision_dtype = saved
    if pooling.PLAIN_CUDA_CALLS != plain:
        raise RuntimeError("plain pooling ran on the card in f64")


def _stochastic_layers(tpe):
    """ImagenetAE's stage 0 as a fused autoencoder stage with pooling
    ``tpe``: conv 108 9x9/s3 without bias -> the pool (3x3/s2; a
    pool-depool's windows are 3x3 apart) -> a depooling tied to it
    (where the pool does not depool itself) -> a deconv tied to the
    conv, the sample's hypers."""
    from znicz_tpu_torch.core.config import root
    cfg = root.imagenet_ae
    geo = cfg.stages[0]
    layers = [
        {"name": "conv", "type": "conv",
         "->": {"n_kernels": geo["n_kernels"], "kx": geo["kx"],
                "ky": geo["ky"], "sliding": tuple(geo["sliding"]),
                "include_bias": cfg.include_bias,
                "weights_filling": "uniform"},
         "<-": {"learning_rate": cfg.learning_rate,
                "weights_decay": cfg.weights_decay,
                "gradient_moment": cfg.gradient_moment}},
        {"name": "pool", "type": tpe,
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}}]
    if not tpe.endswith("_depool"):
        layers.append({"name": "depool", "type": "depooling",
                       "->": {"tied_to": "pool"}})
    layers.append({"name": "deconv", "type": "deconv",
                   "->": {"tied_to": "conv",
                          "unsafe_padding": cfg.unsafe_padding}})
    return layers


def _fused_stochastic(torch, data, card):
    """Each of the four stochastic pooling types in ``FusedNet`` as
    ImagenetAE's stage 0 at 227x227, minibatch 8, f32: 4 steps whose
    streams are drawn on the card (one draw a step), the depooling of
    the two that have one on the backward kernel (one launch a step),
    no plain pooling; a second net from the same seeds replays the steps
    bit for bit (losses, parameters, optimizer slots)."""
    import numpy
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.parallel import fused
    images = next(d for (size, _), (_, d) in data.memo.items()
                  if size == IAE_SIZE)
    x = torch.as_tensor(images[:IAE_BATCH]).cuda()
    real_draw = fused.draw_u16
    draws = []

    def draw(generator, n):
        out = real_draw(generator, n)
        draws.append(out.device.type)
        return out
    fused.draw_u16 = draw
    launches = {}
    try:
        for tpe in ("stochastic_pooling", "stochastic_abs_pooling",
                    "stochastic_pool_depool", "stochastic_abs_pool_depool"):
            t0 = time.perf_counter()
            got = []
            for _ in range(2):
                net = fused.FusedNet(
                    _stochastic_layers(tpe), x.shape[1:],
                    rand=prng.RandomGenerator().seed(UNITS_SEED),
                    objective="mse", dropout_seed=UNITS_SEED)
                del draws[:]
                _zero_counts()
                losses = [net.step_mse(x, x)["loss"]
                          for _ in range(FUSED_STOCHASTIC_STEPS)]
                counts = _counts()
                sd = net.state_dict()
                got.append((torch.stack(losses).cpu().numpy(), sd, counts,
                            list(draws)))
                del net
            (l0, s0, c0, d0), (l1, s1, c1, d1) = got
            depools = 0 if tpe.endswith("_depool") else \
                FUSED_STOCHASTIC_STEPS
            want = {"forward": 0, "forward_by_width": {WIDE: 0, NARROW: 0},
                    "backward": depools,
                    "backward_by_width": {WIDE: depools, NARROW: 0},
                    "plain_on_card": 0}
            if d0 != ["cuda"] * FUSED_STOCHASTIC_STEPS or c0 != want or \
                    not numpy.isfinite(l0).all():
                raise RuntimeError("fused %s: draws on %s, launches %s "
                                   "(want %s), losses %s"
                                   % (tpe, d0, c0, want, l0))
            if not numpy.array_equal(l0.view(numpy.uint8),
                                     l1.view(numpy.uint8)):
                raise RuntimeError("fused %s: the replay's losses differ"
                                   % tpe)
            _trees_bits_equal(s1, s0, "fused %s replay" % tpe)
            launches[tpe] = c0
            say("   fused %s (stage 0 at %dx%d, minibatch %d): %d steps, "
                "losses %s, one stream a step drawn on the card, %d "
                "depooling launches at 16-byte vectors; the replay bit-equal "
                "(losses, parameters, optimizer slots, generator) (%.2f s); "
                "%s" % (tpe, IAE_SIZE, IAE_SIZE, IAE_BATCH,
                        FUSED_STOCHASTIC_STEPS,
                        " ".join("%.6f" % v for v in l0), depools,
                        time.perf_counter() - t0, card))
    finally:
        fused.draw_u16 = real_draw
    total = dict(_counts(), forward=0, backward=0, plain_on_card=0)
    for key in ("forward", "backward", "plain_on_card"):
        total[key] = sum(c[key] for c in launches.values())
    for key in ("forward_by_width", "backward_by_width"):
        total[key] = {w: sum(c[key][w] for c in launches.values())
                      for w in (WIDE, NARROW)}
    return total


def _trees_bits_equal(got, want, what):
    """Two trees of host values (``FusedNet.state_dict``), bit for bit."""
    import numpy
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise RuntimeError("%s: keys %s, not %s"
                               % (what, sorted(got), sorted(want)))
        for k in want:
            _trees_bits_equal(got[k], want[k], "%s %s" % (what, k))
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise RuntimeError("%s: %d items, not %d"
                               % (what, len(got), len(want)))
        for i, (g, w) in enumerate(zip(got, want)):
            _trees_bits_equal(g, w, "%s %d" % (what, i))
    else:
        g, w = numpy.atleast_1d(got), numpy.atleast_1d(want)
        if g.shape != w.shape or g.dtype != w.dtype or \
                not numpy.array_equal(g.view(numpy.uint8),
                                      w.view(numpy.uint8)):
            raise RuntimeError("%s differs" % what)


def _mse_samples(torch, probe, cli, prng, base, found, card):
    """The other MSE samples through the CLI on the card for 2 epochs:
    ``research.video_ae`` at the published 90x160 frames,
    ``approximator`` in the fused trainer's three window forms (window 4:
    host-stacked, ``device_data=False``; sliced, ``device_perm=True``;
    gathered by index, the default) bit-equal to each other with one
    readback a TRAIN segment, and ``kanji`` over its synthetic glyphs
    (written under ``build/``; PIL).  Each ends on ``cuda`` with finite
    metrics, neither ``jax`` nor ``znicz_tpu`` imported."""
    import numpy
    from znicz_tpu_torch.loader.base import TRAIN
    from znicz_tpu_torch.samples import kanji

    def check(name, r):
        wf = r["wf"]
        trainer = getattr(wf, "fused_trainer", None)
        device = trainer.net.device if trainer is not None else \
            wf.forwards[0].weights.dev.device
        bad = [s for s in r["segments"] if s["metrics"] is None or
               not numpy.isfinite(s["metrics"]).all()]
        if device.type != "cuda" or bad or \
                len(r["segments"]) != 2 * MSE_ZOO_EPOCHS:
            raise RuntimeError("%s: device %s, segments %s"
                               % (name, device, r["segments"]))
        for mod in ("jax", "znicz_tpu"):
            if mod in sys.modules:
                raise RuntimeError("%s was imported" % mod)
        return device

    t0 = time.perf_counter()
    r = _units_run(probe, cli, prng, [
        "research.video_ae", "--config",
        "video_ae.loader.frame_shape=%r" % (VIDEO_FRAME,),
        "--config", "video_ae.decision.max_epochs=%d" % MSE_ZOO_EPOCHS,
        "--config", "video_ae.snapshotter.directory=%s"
        % os.path.join(base, "video_ae")])
    device = check("video_ae", r)
    if tuple(r["wf"].forwards[-1].output.shape[1:]) != \
            (VIDEO_FRAME[0] * VIDEO_FRAME[1],):
        raise RuntimeError("video_ae reconstructs %s" %
                           (r["wf"].forwards[-1].output.shape,))
    say("   research.video_ae at %dx%d frames: (TRAIN, VALID) MSE (avg, max, "
        "min) by epoch %s on %s (%.2f s); %s" % (
            VIDEO_FRAME + ([(a["metrics"], b["metrics"]) for a, b in zip(
                r["segments"][::2], r["segments"][1::2])], device,
                time.perf_counter() - t0, card)))
    forms = (("host-stacked", "window=%d,device_data=False"),
             ("sliced", "window=%d,device_perm=True"),
             ("indexed", "window=%d"))
    runs = {}
    for form, spec in forms:
        t0 = time.perf_counter()
        readbacks = _Readbacks(torch, probe._where)
        with readbacks:
            r = _units_run(probe, cli, prng, [
                "approximator", "--fused", spec % MSE_ZOO_WINDOW,
                "--config", "approximator.decision.max_epochs=%d"
                % MSE_ZOO_EPOCHS,
                "--config", "approximator.snapshotter.directory=%s"
                % os.path.join(base, "approximator_" + form)])
        check("approximator " + form, r)
        trainer = r["wf"].fused_trainer
        got_form = "indexed" if trainer._use_device_data and not \
            trainer._use_sliced else "sliced" if trainer._use_sliced else \
            "host-stacked"
        per_train = [readbacks.counts[(TRAIN, e)]
                     for e in range(MSE_ZOO_EPOCHS)]
        if got_form != form or trainer.window != MSE_ZOO_WINDOW or \
                per_train != [1] * MSE_ZOO_EPOCHS:
            raise RuntimeError("approximator --fused %s: the %s form, "
                               "window %d, readbacks by TRAIN segment %s"
                               % (spec, got_form, trainer.window, per_train))
        runs[form] = (_units_segments(r["segments"]),
                      trainer.net.state_dict())
        say("   approximator --fused %s: the %s window, (TRAIN, VALID) MSE "
            "by epoch %s, one readback a TRAIN segment %s (%.2f s); %s" % (
                spec % MSE_ZOO_WINDOW, form,
                [(a["metrics"], b["metrics"]) for a, b in zip(
                    r["segments"][::2], r["segments"][1::2])], per_train,
                time.perf_counter() - t0, card))
    segs, sd = runs["indexed"]
    for form in ("host-stacked", "sliced"):
        if runs[form][0] != segs:
            raise RuntimeError("the approximator's %s window's segments "
                               "differ from the indexed window's" % form)
        _trees_bits_equal(runs[form][1], sd,
                          "the approximator's %s window" % form)
    say("   approximator: the host-stacked, sliced and indexed windows "
        "bit-equal (each epoch's metrics, parameters, optimizer slots, "
        "generator)")
    if found["PIL"] is not None:
        say("   kanji: not run (PIL %s)" % found["PIL"])
        return
    t0 = time.perf_counter()
    data = kanji.materialize_synthetic(os.path.join(base, "kanji_data"))
    r = _units_run(probe, cli, prng, [
        "kanji", "--config", "kanji.loader.train_paths=[%r]"
        % os.path.join(data, "train"),
        "--config", "kanji.loader.target_paths=[%r]"
        % os.path.join(data, "target"),
        "--config", "kanji.decision.max_epochs=%d" % MSE_ZOO_EPOCHS,
        "--config", "kanji.snapshotter.directory=%s"
        % os.path.join(base, "kanji")])
    device = check("kanji", r)
    say("   kanji: (epoch, class, n_err of rows, avg MSE) %s on %s (%.2f s, "
        "the glyphs written under build/); %s" % (
            [(s["epoch"], s["class"], "%s/%d" % (s["n_err"], s["n"]),
              "%.6f" % s["metrics"][0]) for s in r["segments"]], device,
            time.perf_counter() - t0, card))


def _sums(rows):
    """Per-step sums of the timings over the three pools."""
    rec = {k: sum(r[k] for r in rows.values())
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    rec["host_enqueue_ms"] = sum(r["host_ms"] for r in rows.values())
    rec["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                      for r in rows.values())
                       else "operations")
    return rec


def _by_pool(rows):
    """The timings of each pool on its own, ``host_ms`` named as in
    :func:`_sums`."""
    return {label: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                    "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                    "host_enqueue_ms": r["host_ms"],
                    "bound_by": r["bound_by"]}
            for label, r in rows.items()}


def main():
    import torch
    start = time.perf_counter()
    name, smi = phase_device(torch)
    sys.path.insert(0, HERE)
    try:
        import znicz_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit("chip_smoke: the znicz_tpu_torch package is not "
                         "beside this script (%s)" % e)
    return _phases(torch, name, "[%s]" % smi, start)


def _phases(torch, name, card, start):
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    from znicz_tpu_torch.samples import alexnet
    marks = [("start", start), ("device and import", time.perf_counter())]
    prototypes = _Prototypes(alexnet, WORKFLOW_TRAIN + WORKFLOW_VALID)
    stl_data = _StlData()
    imports = _Imports()
    phase_build()
    marks.append(("build", time.perf_counter()))
    prototypes.join()
    stl_data.join()
    say("== stl10 data: %d TRAIN and %d VALID images (and the f64 checks' "
        "%d and %d) written in %.2f s, in a thread beside the build"
        % (STL_TRAIN, STL_VALID, STL_F64_MB * STL_BATCH, STL_BATCH,
           stl_data.seconds))
    marks.append(("the prototype and STL-10 draws' rest",
                  time.perf_counter()))
    cycles_per_ms = _spin_cycles_per_ms(torch)
    rows, bf16_rows, max_err = phase_kernels(torch, card, cycles_per_ms)
    marks.append(("kernels", time.perf_counter()))
    backward_err = phase_backward_kernel(torch)
    marks.append(("backward kernel", time.perf_counter()))
    by_width, layer_ms, serve_retry_launches = phase_serve(
        torch, card, cycles_per_ms)
    marks.append(("serve", time.perf_counter()))
    for label in rows:
        say("   %s in the model: %.4f ms (warm L2), cold alone %.4f ms; %s"
            % (label, layer_ms[label], rows[label]["ms"], card))
    with prototypes:
        workflow_launches, workflow_rates, reference = phase_workflow(
            torch, card)
        marks.append(("workflow", time.perf_counter()))
        resilience_launches = phase_resilience(torch, card, reference)
        del reference
        marks.append(("resilience", time.perf_counter()))
        alexnet_units_launches = phase_alexnet_units(torch, card,
                                                     workflow_rates)
        marks.append(("alexnet_units", time.perf_counter()))
        units_launches, mnist_rows = phase_units(torch, card, cycles_per_ms)
        marks.append(("units", time.perf_counter()))
        train_launches, _, resilience_net_launches = phase_train(
            torch, card, cycles_per_ms)
        marks.append(("train", time.perf_counter()))
    del prototypes
    train_rows, train_err = phase_train_kernels(torch, card, cycles_per_ms)
    marks.append(("train kernels", time.perf_counter()))
    ae_launches, ae_fused_launches, ae_rows = phase_ae(torch, card,
                                                       cycles_per_ms)
    marks.append(("ae", time.perf_counter()))
    phase_mse(torch, card)
    marks.append(("mse", time.perf_counter()))
    cifar_launches, cifar_fused_launches, cifar_rows, cifar_snaps = \
        phase_cifar(torch, card, cycles_per_ms)
    marks.append(("cifar", time.perf_counter()))
    stl_launches, stl_fused_launches, stl_rows = phase_stl10(
        torch, card, cycles_per_ms, stl_data, imports)
    stl_data.cleanup()
    marks.append(("stl10", time.perf_counter()))
    _DRAWS.clear()
    iae_launches, iae_fused_launches, iae_rows = phase_mse_zoo(
        torch, card, cycles_per_ms, imports)
    marks.append(("mse_zoo", time.perf_counter()))
    by_dtype, _ = phase_serve_models(torch, card, cifar_snaps)
    marks.append(("serve_models", time.perf_counter()))
    for mod in ("jax", "znicz_tpu"):
        if mod in sys.modules:
            raise RuntimeError("%s was imported" % mod)
    paths = {"train": train_launches, "workflow": workflow_launches,
             "alexnet_units": alexnet_units_launches,
             "units": units_launches, "ae": ae_launches,
             "ae_fused": ae_fused_launches, "cifar": cifar_launches,
             "cifar_fused": cifar_fused_launches, "stl10": stl_launches,
             "stl10_fused": stl_fused_launches, "imagenet_ae": iae_launches,
             "imagenet_ae_fused": iae_fused_launches,
             "resilience": resilience_launches,
             "resilience_net": resilience_net_launches}
    forward = {"name": "max_pooling_offsets", "route": "cuda",
               "source": "znicz_tpu_torch/csrc/" + cuda_pooling.SOURCE,
               "replaces": cuda_pooling.REPLACES,
               "launches": sum(by_width.values()) + sum(
                   p["forward"] for p in paths.values()) + sum(
                       by_dtype.values()) + serve_retry_launches,
               "launches_by_path": dict(
                   serve=sum(by_width.values()),
                   serve_models=sum(by_dtype.values()),
                   resilience_serve=serve_retry_launches,
                   **{k: p["forward"] for k, p in paths.items()}),
               "launches_by_dtype": by_dtype,
               "launches_by_width": {
                   k: by_width[k] + sum(p["forward_by_width"][k]
                                        for p in paths.values()) + (
                       sum(by_dtype.values()) + serve_retry_launches
                       if k == WIDE else 0)
                   for k in by_width},
               "ptxas": _ptxas(cuda_pooling.SOURCE)}
    forward.update(kernel_record(rows, max(max_err, train_err["forward"]),
                                 layer_ms))
    forward["train"] = _sums(train_rows["forward"])
    forward["mnist"] = _sums(mnist_rows["forward"])
    forward["ae"] = _sums(ae_rows["forward"])
    forward["cifar"] = _by_pool(cifar_rows["forward"])
    forward["stl10"] = _by_pool(stl_rows["forward"])
    forward["bf16"] = _by_pool(bf16_rows)
    backward = {"name": "max_pooling_offsets_backward", "route": "cuda",
                "source": "znicz_tpu_torch/csrc/" +
                cuda_pooling_backward.SOURCE,
                "replaces": cuda_pooling_backward.REPLACES,
                "launches": sum(p["backward"] for p in paths.values()),
                "launches_by_path": {k: p["backward"]
                                     for k, p in paths.items()},
                "launches_by_width": {
                    k: sum(p["backward_by_width"][k] for p in paths.values())
                    for k in (WIDE, NARROW)},
                "ptxas": _ptxas(cuda_pooling_backward.SOURCE),
                "max_abs_err": max(backward_err, train_err["backward"])}
    backward.update(_sums(train_rows["backward"]))
    backward["mnist"] = _sums(mnist_rows["backward"])
    backward["ae"] = _sums(ae_rows["backward"])
    backward["cifar"] = _by_pool(cifar_rows["backward"])
    backward["stl10"] = _by_pool(stl_rows["backward"])
    backward["imagenet_ae"] = _by_pool(iae_rows["backward"])
    backward["runtime_stride_ms"] = sum(
        r["runtime_stride_ms"] for r in train_rows["backward"].values())
    say("== wall seconds by phase: %s"
        % ", ".join("%s %.1f" % (phase, t - marks[i][1])
                    for i, (phase, t) in enumerate(marks[1:])))
    say(json.dumps({"kernels": [forward, backward]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
