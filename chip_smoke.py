"""Smoke run of the PyTorch port (``nndetection_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its findings:

1. device: the card's name and power limit (``nvidia-smi``); fails without
   CUDA, never falls back to the CPU;
2. build: compiles the CUDA kernels from ``nndetection_tpu_torch/csrc`` into
   the git-ignored ``nndetection_tpu_torch/_build`` and loads them, and
   beside them the host library (``csrc/nndet_host.cpp``: the model-level
   NMS, the host WBC and the COCO matching) with the host C++ compiler;
3. kernels: every kernel of the serving, train and consolidation paths
   against its plain PyTorch version on the card, at the shapes of those
   paths (instance-norm statistics (#1) at every LUNA stage shape at batch 2
   and 8, f32, bf16 and f16, exact and plane-subsampled, one launch per call,
   two calls bit for bit equal, timed as wall, device and host time, one
   JSON line of every shape's times; apply, gradient sums and input gradient
   at the LUNA plan's stage shapes, bf16 and f32, exact and
   plane-subsampled, and at the train batch's stage 0; NMS (#7) at 16 x 1000,
   2 x 10000 and 2 x 20000 boxes (the last with its scratch in a global
   workspace), also with 8-level tied scores and an all -inf image, and at
   16 x 1000 on the NaN case (``special_boxes``: NaN, +-inf and signed-zero
   coordinates, flat boxes), wall, device and host time; the fused
   conv + statistics (#5) at every fused LUNA
   shape at batch 2 and stage 0b at the train batch, each on the route its
   plan picks and timed on the others it allows, then at the tiny model's
   fused layers and at edge shapes, every route at least once, two runs bit
   for bit equal, one JSON line of every LUNA shape's route and times; the IoU matrix (#6) at
   1000, 4096, 16384 and 4097 boxes on clumped boxes and on one dense
   clump, n x (n // 2 + 3) and the NaN case (1000 x 1001 both ways), NaN at
   the plain version's positions and its bits elsewhere, timed beside its
   other grids, one JSON line of every size's times; the suppression words
   (#8) and the keep-scan at
   1000, 4096 and 16384, identical to their plain versions, wall, device
   and host time; the WBC cluster kernel at 1000 boxes x 2 classes, at the
   consolidate phase's two real inputs (the 8-flip case, one class) and at
   4161, 20000 and 57600 boxes of one class (the scratch in a global
   workspace), bit for bit equal to its plain version, two calls equal, one
   launch per call, wall, device and host time, the peak memory of one call
   at 20000, one JSON line of every input's times, then on the NaN case
   (``special_boxes``, a NaN weight in one box of ten)), with
   median times from CUDA events, the time of one PyTorch call computing
   the same function where there is one, and the bound (HBM bytes, or
   float32 or tensor-core flops, at the H100's published peaks);
4. reference: a tiny float32 model on the card against the same model on
   the CPU, TF32 off (forward, post-processing, whole-case prediction, and
   one ``Trainer.train_step`` with the same sampler draws on both: losses,
   every gradient, every parameter after the update); then the forward and
   one step under ``NNDET_CONV_FUSED=1`` at bf16-sized tolerances;
5. forward: the full-width LUNA-plan RetinaUNet (patch 96x128x128, 6
   stages, 32..320 channels, 27 anchors/position) in bf16 from a seeded
   initialization; every output finite;
6. serve: ``Predictor.predict_case`` on a 140x320x320 case without TTA and a
   96x256x256 case with 8-flip TTA, each twice (first call, then warm); the
   kernels' launch counts are reset just before and must all have risen
   (the default ensembler's WBC runs on the card: the cluster kernel);
7. train: ``Trainer.train_epoch`` on the LUNA plan at batch 8 (bf16, remat
   as the config sets it), 2 warm-up steps then 5 timed ones, on a seeded
   batch made as ``bench.py`` makes it; the launch counts are reset just
   before and all four instance-norm kernels must have run; every loss
   finite, positives matched, parameters changed;
8. consolidate: the 96x256x256 8-flip case with ``BoxEnsemblerSelective``
   and with ``BoxEnsemblerWBC``, its whole-case WBC on the card (the cluster
   kernel; no path launches #6), then the same ensembler state consolidated again on the
   card, with the device formulation on the CPU (the same detections, same
   bits) and on the host (the host library, float64), each timed; the
   model-level NMS of the selective ensembler's streams in the host library
   beside the NumPy loop on the same candidates (the same keep lists);
9. NMS mask: ``batched_nms_mask`` (#8 and the keep-scan) on the card over
   each stream's model-level candidates of that case, equal to the CPU
   plain version, and how many boxes it keeps otherwise than the host
   float64 ``batched_nms_np``, with the IoU margin of each difference;
10. sweep: ensembler states of three seeded LUNA-plan cases (patch
   96x128x128, 8 flips) with GT made from the seed; ``BoxSweeper`` on the
   card, then with the device formulation on the CPU (identical best
   parameters, scores within 1e-6) and on the host path, each timed, the
   matching in the host library;
11. deploy: checkpoints on disk to evaluation. The tiny float32 model: two
   folds saved by ``Trainer.save_checkpoint``, loaded by ``load_all_models``,
   two seeded cases (one padded, one restored) through ``predict_dir`` with
   TTA, segmentation, restore and ensembler states on the card and on the
   CPU: boxes paired within the stated tolerance, seg maps equal but for
   near-ties (counted), and ``evaluate_box_dir``, ``evaluate_case_dir`` and
   ``evaluate_seg_dir`` equal within 1e-6 on both directories as sets of
   detections (scores rounded to 1e-4, one order). Then the LUNA plan at full width,
   two seeded folds from disk, one 96x256x256 case with 8 flips,
   segmentation and ``BoxEnsemblerSelective``, first and warm: seconds, the
   consolidation of its saved state, peak memory; #1, #2, #7 and the cluster
   kernel must launch and the model-level NMS run in the host library;
12. train_aug: the fed training path on the LUNA plan at batch 8 (two
   classes): 4 seeded cases 224x288x288 on disk in the loader's format,
   ``make_splits`` and ``build_loaders`` (fold 0, ``base_more``, generator
   patch 211x250x250), ``Trainer(augment_cfg=...)`` fed twice: by the host
   loader (``device_pool=False``, pinned host batches) and by the device
   patch pool (the default on the card); each run 2 fed warm-up steps, then
   ``fit`` over 6 fed steps and a validation epoch of 2 batches with
   ``BoxEvaluator``, both through ``PrefetchIterator``, then 6 fed steps
   under ``torch.profiler`` for the card's idle share; the launch counts are
   reset just before each run and all four instance-norm kernels must have
   run; every loss finite, parameters changed, ``model_last.ckpt`` written.
   Beside them: s/step and patches/s next to phase 7's, peak memory; the
   host loader's ms per ``generate_batch``, host -> card ms, the card ms of
   ``augment_batch``; the pool's fill time, ``pool_bytes()``, host ms of
   one ``generate_batch`` and the card ms of its cut beside the bytes
   bound; and one batch's draws made on the card and applied on the card
   and on the CPU (images within 1e-4; seg equal but at voxels whose source
   coordinate lies within 1e-4 of a half, counted);
13. run_train: a task directory as the JAX ``run_prep`` leaves it
   (``dataset.yaml`` with two labels, the port's ``Plan`` of the LUNA plan,
   8 seeded 224x288x288 cases as ``.npz``, ``.npy`` and ``_boxes.pkl``),
   trained by ``run_train`` (fold 0, ``RetinaUNetV001``, ``base_more``, one
   epoch, 2 validation batches, no SWA) twice: (a) at the default pool
   budget, every train case resident, 6 fed steps; (b) with
   ``NNDET_POOL_BYTES`` at 3 cases, 16 fed steps, the others rotating in,
   the whole call under ``torch.profiler``; the launch counts are reset just
   before each; ``plan.pkl``, ``model_last.ckpt``, ``metrics.jsonl``,
   ``params.json`` and ``run_meta.json`` written, losses finite, parameters
   changed, #1-#4 and #7 launched, and (b)'s ``pool_*`` metrics in
   ``metrics.jsonl`` with ``pool_coverage`` 1.0; s/step, patches/s, idle
   share, pool report, peak memory, and PyYAML's version;
14. prep: a raw CT task (6 seeded 128x256x256 float32 cases in HU, 1-3
   objects each, two labels, spacings (1.25, 0.70, 0.70) and (1.25, 0.80,
   0.80) mm, ``.nii.gz``) through ``run_prep(num_workers=4)`` on the card:
   seconds per stage (crop, analyze, plan, process, unpack), each probe
   call of the planner (batch, remat, allocated and reserved peak, verdict,
   ms per step), the plan; every file ``run_train`` reads, finite arrays,
   ``mem_compiled_bytes > 0`` and the plan within the probe's budget
   checked, and #1-#4 launched by the probe; the same properties planned on
   the CPU at the card's budget, equal but in the fields the probe decides;
   then ``run_train`` on the port's own plan (fold 0, ``RetinaUNetV001``,
   ``base_more``, 6 fed steps, 2 validation batches, no SWA; the pool sized
   from the measured peak; #1-#4 and #7 launched): s/step, patches/s, peak
   memory beside the probe's, the pool's budget and ``pool_bytes()``; last
   the probe at the LUNA plan, batch 8, with 8 and with 32 GT slots, beside
   the train and train_aug phases' peaks (the fed step's peak split);
15. cli: the README's sequence through the port's command-line entry points
   (each ``main()`` in this process, ``sys.argv`` set, ``det_data`` and
   ``det_models`` in a temporary directory) on a raw task as in phase 14
   plus 2 test cases (one with objects, one without): ``cli.prep`` (4
   workers), ``cli.train --fold 0 --sweep`` (6 fed steps, 2 validation
   batches, no SWA), ``cli.consolidate``, ``cli.predict`` (TTA) and
   ``cli.evaluate --seg --case``, each with its launch counts reset just
   before; seconds, peak memory and launches per command, the plan and
   s/step, the swept parameters, boxes per test case and the box, case and
   seg scores; the files of the JAX package's sequence, finite scores, #1-#4
   launched by the probe and the training, #1, #2, #7 and the cluster
   kernel by the sweep's and the test split's predictions, the sweep on the
   card against the device formulation on the CPU (identical best
   parameters), and ``run_predict_val`` on the card against
   ``materialize_val_predictions`` on the host (paired, rtol and atol
   1e-5) checked;
16. luna: the LUNA-proxy cross-validation through ``run_proxy_cv``
   (``projects/Task016_Luna/proxy_cv.py``): 10 generated LUNA16-layout
   cases at inplane 256 (``.mhd`` + ``.zraw``, ``annotations.csv``), the
   Task016 converter, ``run_prep`` (4 workers, the probe on the card), fold
   0 of the 5-fold split trained one epoch of 6 fed steps with 2 validation
   batches and no SWA, ``run_sweep``, ``run_consolidate(num_folds=1)``,
   ``materialize_val_predictions``, then the pooled predictions exported as
   the LUNA CPM csv, scored over fold 0's validation series and evaluated by
   ``run_evaluate``; seconds, peak memory and kernel launches per stage.
   Checked: every validation series scored, each CSV row one pooled
   detection at or above the threshold whose world coordinate maps back
   through ``world_to_voxel`` to its box centre within 1e-4 voxel, the
   validation cases' ground-truth boxes exported as predictions scoring a
   CPM of 1.0, #1-#4 launched in prep and training, #7 in the validation
   and the sweep, the cluster kernel in the sweep and consolidation;
17. 2d: a raw 2D task written by ``data/example.py`` with the 2D planning
   test's geometry (24 + 4 seeded 512x480 cases at 0.7 x 0.7 mm, one object
   each, two classes) through ``run_prep`` (4 workers, the probe on the
   card), ``run_train`` (fold 0, one epoch of 6 fed steps, 2 validation
   batches, no SWA), ``run_sweep``, ``run_consolidate(num_folds=1)``,
   ``run_predict_test`` (4 flips) and ``run_evaluate``: the plan (patch,
   batch, stages, channels, remat), seconds per stage, s/step, peak memory
   and the launches of #1-#4, #7 and the cluster kernel, each stage's
   kernels checked; then #7 and the cluster kernel on 2D boxes (lifted to
   unit depth by their wrappers) bit for bit against their plain versions
   on the card, at the largest call of each in those predictions and at a
   seeded 1000-box input with tied scores; #1-#4 at the 2D plan's stage
   shapes; the tiny float32 2D model card vs CPU (as phase 4, 4 flips);
   one deep-supervision train phase on the LUNA plan (batch 8, bf16:
   losses finite, the instance-norm kernels launched) and a tiny float32
   deep-supervision step card vs CPU;
18. serve fused and train fused: phases 6 (the 140x320x320 case) and 7 under
   ``NNDET_CONV_FUSED=1``, restored after; #5 must launch 7 times per model
   forward (both convs of stage 0, the second of stages 1-5), so 14 times
   per train step with remat, beside the other kernels;
19. multi: the port's multi-process training, each rank a subprocess
   (``python3 chip_smoke.py --multi-worker=SPEC``): (a) ``run_train`` on the
   run_train phase's task as a one-rank job under ``NNDET_COORDINATOR``,
   ``NNDET_NUM_PROCESSES=1``, ``NNDET_PROCESS_ID=0`` (6 fed steps, 2
   validation batches): NCCL, the model in ``DistributedDataParallel``,
   the files, finite losses, #1-#4 and #7 launched, s/step beside the
   one-process ``run_train``'s; (b) two ranks sharing ``cuda:0`` under gloo,
   one data-parallel step of the tiny float32 model per head on a global
   batch of 4, TF32 off, each rank's card step against the same 2-rank step
   on the CPU (same group, the sampler's draws replayed) at the reference
   phase's tolerances, the ranks' parameters equal bit for bit, #1-#4
   launched on each; (c) the spatial step (a model axis of 2) is recorded
   as not run before anything runs: its halo exchange sends slabs point to
   point, which gloo does not do with CUDA tensors, and NCCL puts no two
   ranks on one card; what of it needs only all-reduces runs: the global
   instance norm at LUNA stage 0, its depth split over two gloo ranks on
   ``cuda:0``, forward and backward in bfloat16 and float32, each rank
   against the same 2-rank run on the CPU and its output against the plain
   norm of the whole map, #1-#4 launched on each.

Every JSON line but the last carries the host's load when it was printed
(``host_load``: the 1-minute load average and the other busy processes).
Then one JSON line with each kernel's route, source, launches in the phase
that drives it (serve for NMS, train fused for #5, train for the instance
norm, consolidate for the cluster kernel, NMS mask for #8 and the
keep-scan; #6, which no path launches, in the kernels phase; each
kernel's launches in run_train (a) as ``run_train_launches``, and in the
prep phase's ``run_prep`` and ``run_train`` as ``prep_launches``, in the
cli phase's commands as ``cli_launches``, in the luna phase's stages
as ``luna_launches``, in the 2d phase's stages as ``2d_launches``, and in
the multi phase as ``multi_launches``: (a), and (b) and the spatial norm
per rank), max error,
times and bound, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and no result line is printed.

``--parent=DIR`` (with ``kernels`` or ``iou``) times #8 and the keep-scan
at 1000, 4096 and 16384 boxes, #6 at ``IOU_SIZES`` on clumped and dense
boxes, and #7 and the cluster kernel at their table shapes, of the tree at
``DIR`` (a ``git archive`` of another commit) beside this tree's, in turns,
the other tree's in a subprocess that builds its kernels into its own
``_build/``.
``--profile=DIR`` adds a ``torch.profiler`` trace of one train step, default
and fused (kernel time by name; the tables into ``DIR/train_profile.txt`` and
``DIR/train_fused_profile.txt``). ``--phases=a,b,...``
runs only the phases named (of ``build``, ``kernels``, ``conv``, ``norm``,
``nms``, ``wbc`` and ``iou`` (#5's, #1's, #7's, the cluster kernel's and
#6's checks alone), ``reference``, ``forward``, ``serve``, ``consolidate``,
``nms_mask``, ``sweep``, ``deploy``, ``train``, ``train_aug``,
``run_train``, ``multi``, ``prep``, ``cli``, ``luna``, ``2d``, ``serve_fused``,
``train_fused``); the
device phase always runs, the ``kernels`` JSON line only when every phase
it reads ran. With no argument every phase but ``conv``, ``norm``, ``nms``,
``wbc`` and ``iou`` runs (``kernels`` holds them).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

LUNA_STAGES = [
    (2, 96, 128, 128, 32),
    (2, 48, 64, 64, 64),
    (2, 24, 32, 32, 128),
    (2, 6, 8, 8, 320),
    (2, 3, 4, 4, 320),
]
NMS_SHAPES = [(16, 1000, 100), (2, 10000, 100), (2, 20000, 100)]
# batches at which #1 is checked and timed at every LUNA stage
IN_BATCHES = (2, 8)
# the train batch's stage 0: where the backward kernels' time is reported
TRAIN_STAGE0 = (8, 96, 128, 128, 32)
# the fused convolutions of the LUNA plan under NNDET_CONV_FUSED=1, as
# (x shape [B, D, H, W, Ci], Co): both convs of stage 0, the second conv of
# stages 1-5; at batch 2, then stage 0b at the train batch, where #5's time
# is reported
CONV_SHAPES = [
    ((2, 96, 128, 128, 1), 32),
    ((2, 96, 128, 128, 32), 32),
    ((2, 48, 64, 64, 64), 64),
    ((2, 24, 32, 32, 128), 128),
    ((2, 12, 16, 16, 256), 256),
    ((2, 6, 8, 8, 320), 320),
    ((2, 3, 4, 4, 320), 320),
]
CONV_TRAIN = ((8, 96, 128, 128, 32), 32)
# consolidation: #6 at the WBC's ensemble_topk (1000) and beyond, #8 and the
# keep-scan at the model-level NMS's model_topk (1000) and beyond, the cluster
# kernel at 1000 boxes of 2 classes, then at one class of (N, boxes per
# object): the first N whose scratch leaves shared memory and 20000 boxes
# (where one call's peak memory is reported) in clumps as at the table shape,
# where most boxes are clusters of their own, and the previous kernel's cap
# as an ensemble of 40 streams (5 folds x 8 flips) sees objects, so that the
# plain cluster loop that checks it runs in seconds
IOU_SIZES = (1000, 4096, 16384, 4097)
# #6's sizes whose boxes come first in the kernels phase's stream of draws,
# ahead of #8's and the cluster kernel's table input, as in every run since
# those were ported; #6's other sizes draw their own
IOU_STREAM_SIZES = (1000, 4096)
SUPPRESSION_SIZES = (1000, 4096, 16384)
WBC_SHAPE = (1000, 2)
WBC_SIZES = ((4161, None), (20000, None), (57600, 40))
WBC_PEAK_N = 20000
# the H100 SXM's published peaks (NVIDIA's data sheet, dense): HBM3 bytes/s,
# bf16 tensor-core and float32 non-tensor flops/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# stated tolerances of kernel against plain version on the card
TOL = {
    # statistics: same float32 inputs, other summation order
    "in_stats": dict(rtol=1e-4, atol=1e-5),
    # apply, float32: identical stats in; rsqrt and a fused multiply-add
    # move the result by an ulp or two
    "in_apply_f32": dict(rtol=1e-5, atol=1e-5),
    # apply, bfloat16: that ulp can cross a bfloat16 rounding boundary,
    # one bfloat16 ulp (2^-8 relative)
    "in_apply_bf16": dict(rtol=1e-2, atol=1e-2),
    # gradient sums: float32 sums of up to 1.5M O(1) terms per (b, c) in
    # another order (per-split partials, then their combine)
    "in_grad_stats": dict(rtol=1e-4, atol=1e-3),
    # input gradient: identical sums in; the kernel divides s1 and s2 by |P|
    # before the multiply-add, the plain version after: an ulp or two in
    # float32, one bfloat16 ulp in bfloat16
    "in_grad_input_f32": dict(rtol=1e-5, atol=1e-5),
    "in_grad_input_bf16": dict(rtol=1e-2, atol=1e-2),
    # fused conv y: the kernel sums exact bf16 products in float32, the plain
    # version in float64; both round once to bf16: one bf16 ulp (2^-7
    # relative at the bottom of a binade), plus the float32 sum's error for
    # values near zero
    "conv_y": dict(rtol=2.0 ** -7, atol=1e-4),
    # fused conv statistics against two-pass float32 statistics of the
    # kernel's own y: same values, other summation order (tile partials,
    # then Chan's combine)
    "conv_stats": dict(rtol=1e-4, atol=1e-5),
    # the IoU matrix: the Pallas formula's order in IEEE float32 on both
    # sides (-fmad=false), NaN carried through both: the same bits, NaN at
    # the same positions
    "iou_ulps": 0,
    # the consolidated case on the card against its device formulation on
    # the CPU: float32 on both, summed in the same order (the plain cluster
    # loop follows the kernel's); the bits agree, this is the stated bound
    # (the kernel alone is held to its plain version bit for bit)
    "wbc": dict(rtol=1e-5, atol=1e-6),
    # the tiny float32 model's whole case, card (cuDNN, TF32 off, the WBC on
    # the card in float32) against the CPU (the host WBC in float64), as the
    # reference phase holds it
    "case_f32": dict(rtol=0.0, atol=1e-3),
}
KERNELS = {
    "in_stats": dict(route="cuda", source="nndetection_tpu_torch/csrc/instance_norm_stats.cu",
                     replaces="nndetection_tpu/ops/pallas_norm.py:72"),
    "in_apply": dict(route="triton", source="nndetection_tpu_torch/ops/instance_norm.py",
                     replaces="nndetection_tpu/ops/pallas_norm.py:105"),
    "in_grad_stats": dict(route="triton", source="nndetection_tpu_torch/ops/instance_norm.py",
                          replaces="nndetection_tpu/ops/pallas_norm.py:115"),
    "in_grad_input": dict(route="triton", source="nndetection_tpu_torch/ops/instance_norm.py",
                          replaces="nndetection_tpu/ops/pallas_norm.py:135"),
    "nms_topk": dict(route="cuda", source="nndetection_tpu_torch/csrc/nms_topk.cu",
                     replaces="nndetection_tpu/ops/pallas_ops.py:132"),
    "conv3d_in_stats": dict(route="cuda", source="nndetection_tpu_torch/csrc/conv3d_in_stats.cu",
                            replaces="nndetection_tpu/ops/pallas_conv.py:68"),
    "iou_matrix": dict(route="cuda", source="nndetection_tpu_torch/csrc/iou_matrix.cu",
                       replaces="nndetection_tpu/ops/pallas_ops.py:41"),
    "suppression_matrix": dict(route="cuda", source="nndetection_tpu_torch/csrc/suppression_matrix.cu",
                               replaces="nndetection_tpu/ops/pallas_ops.py:237"),
    # not TPU kernels: the loops JAX compiles into one device program
    "nms_keep_scan": dict(route="cuda", source="nndetection_tpu_torch/csrc/suppression_matrix.cu",
                          replaces="nndetection_tpu/core/boxes/nms.py:142"),
    "wbc_cluster": dict(route="cuda", source="nndetection_tpu_torch/csrc/wbc_cluster.cu",
                        replaces="nndetection_tpu/core/boxes/wbc.py:61"),
}


# card vs CPU of the tiny float32 step: float32 on both sides, cuDNN and
# the CPU sum the backward in other orders
REF_STEP_TOL = dict(loss=(1e-4, 1e-5), grad=1e-3, param=(1e-5, 1e-5))
# the same under NNDET_CONV_FUSED=1: the fused layers are bf16 on both sides
# (the conv's y, its VJP's output), and where the kernel's float32 sum and
# the plain version's float64 one round y to neighbouring bf16 values, the
# relus and norms that follow amplify the flip: an activation near zero
# passes or blocks its gradient on one side only. Tensors whose gradient is
# a nearly cancelling sum (norm biases, weights ahead of a norm) then differ
# by tens of percent of their own size, so the step is held as whole
# vectors, |g_card - g_cpu| / |g_cpu| over all parameters (0.103 measured on
# the H100 for this model), and each fused layer's Function alone is held
# tightly below (FUSED_FN_TOL)
REF_STEP_TOL_FUSED = dict(loss=(1e-3, 1e-4), global_rel=0.25)
FUSED_FWD_TOL = 1e-2  # times max|out| of each output
# the fused conv + norm Function of one layer, card vs CPU, relative L2 of
# the output and every gradient: y flips between the kernel and the plain
# version, cuDNN's bf16 conv VJP against the CPU's float32 one rounded to
# bf16 (measured up to 3.2e-4 on the H100)
FUSED_FN_TOL = 2e-3
# (x shape, Co) of the tiny model's fused layers at its 32^3 patch
TINY_FUSED_LAYERS = [((2, 32, 32, 32, 1), 8), ((2, 32, 32, 32, 8), 8), ((2, 16, 16, 16, 16), 16),
                     ((2, 8, 8, 8, 32), 32), ((2, 4, 4, 4, 64), 64)]
# (x shape, Co) at the edges of #5's plan: checked against the plain version
# on the route the plan picks
CONV_EDGE_SHAPES = [
    ((1, 16, 32, 8, 64), 64),    # W = 8: no brick; split-K
    ((1, 3, 16, 16, 32), 32),    # D = 3: no brick divides it; split-K
    ((2, 8, 16, 32, 32), 320),   # Co = 320: a brick with 5 channel tiles
    ((1, 8, 16, 16, 1), 32),     # Ci = 1: the scalar gather
    ((1, 8, 16, 16, 8), 16),     # Ci = 8
    ((1, 8, 16, 32, 16), 32),    # Ci = 16
    ((8, 2, 64, 64, 32), 32),    # Ci = 32, D = 2: a 2 x 8 x 16 brick
    ((2, 16, 32, 64, 64), 16),   # two 32-channel chunks of Ci, Co < the tile's 32
    ((1, 4, 8, 16, 320), 64),    # Ci = 320 on a small grid: 30 splits
]


def log(*args) -> None:
    print(*args, flush=True)


def luna_cfg(patch=(96, 128, 128), dtype="bfloat16"):
    """The LUNA16 plan of ``bench.py``: 6 stages, isotropic pooling, heads on
    decoder levels 2-5, 27 anchors per position scaled per level."""
    from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig

    anchors = tuple(tuple(v * 2 ** l for v in (4.0, 6.0, 10.0)) for l in range(4))
    return RetinaUNetConfig(
        conv_kernels=((3, 3, 3),) * 6, strides=((2, 2, 2),) * 5,
        decoder_levels=(2, 3, 4, 5), patch_size=tuple(patch),
        anchor_width=anchors, anchor_height=anchors, anchor_depth=anchors,
        start_channels=32, max_channels=320, fpn_channels=128, head_channels=128,
        dtype=dtype,
    )


def tiny_cfg():
    from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig

    return RetinaUNetConfig(
        conv_kernels=((3, 3, 3),) * 4, strides=((2, 2, 2),) * 3, decoder_levels=(1, 2, 3),
        patch_size=(32, 32, 32), anchor_width=((4, 8),) * 3, anchor_height=((4, 8),) * 3,
        anchor_depth=((4, 8),) * 3, start_channels=8, fpn_channels=16, head_channels=16,
        topk_candidates=500, detections_per_img=20, dtype="float32",
    )


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 3, hold_cycles: int = 1_000_000) -> float:
    """Median device time of the work ``fn`` enqueues: CUDA events around
    the call while a sleep kernel ahead of them holds the card, so that the
    events time the launched work and not the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host time of one warm call of ``fn`` (``perf_counter``, no
    synchronisation inside; the card is idle when each call starts)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def three_times(fn, reps: int = 20) -> dict:
    """Wall (events around the call), device and host times of ``fn``, ms."""
    return {"ms": median_ms(fn, reps), "device_ms": device_ms(fn, reps),
            "host_ms": host_ms(fn, reps)}


def times_text(t: dict) -> str:
    return f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}, host {t['host_ms']:.4f})"


def kernels_launched(fn, calls: int = 4, tries: int = 3) -> list:
    """The names of the device kernels ``calls`` calls of ``fn`` launched
    (``torch.profiler``; tried again when the trace came back empty)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return names


def bound(n_bytes: float, flops: float, peak_flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over their peak rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / peak_flops
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def json_line(obj: dict) -> None:
    """``obj`` as one JSON line, with the host's load at this moment
    (``utils/bench_env.py::host_load``): wall times move with what else
    runs on the host."""
    from nndetection_tpu_torch.utils.bench_env import host_load

    print(json.dumps({**obj, "host_load": host_load()}), flush=True)


def check_close(name, got, want, rtol, atol) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond rtol={rtol} atol={atol}, "
                             f"max abs err {err.max().item():.3e}")
    return err.max().item()


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    """The kernel library (``nvcc``, one process per source) and the host
    library (the host C++ compiler) built at once, from the checkout's
    sources, never from a leftover."""
    from concurrent.futures import ThreadPoolExecutor

    from nndetection_tpu_torch.ops import _build, native

    lib, host = _build.library_path(), _build.host_library_path()
    for path in (lib, host):
        if path.exists():
            path.unlink()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(lambda: (native.available(), time.perf_counter() - t0))
        _build.load()
        t_nvcc = time.perf_counter() - t0
        loaded, t_host = host_build.result()
    if not loaded:
        raise RuntimeError("no host C++ compiler: the host library did not build")
    root = _build.CSRC.parents[1]
    log(f"[build] nvcc {t_nvcc:.2f} s -> {lib.relative_to(root)}; host library "
        f"({_build.host_compiler()}) {t_host:.2f} s -> {host.relative_to(root)}")
    for line in _build.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def in_apply_library(x4, mean, var, gamma, beta, eps=1e-5, out=None):
    """#2's function as PyTorch calls: the per-(b, c) scale and shift
    formed by small ops, then one ``torch.addcmul(shift, x, scale)`` in
    float32 written in x's type."""
    scale = torch.rsqrt(var + eps) * gamma
    shift = beta - mean * scale
    out = torch.empty_like(x4) if out is None else out
    return torch.addcmul(shift[:, None, None], x4, scale[:, None, None], out=out)


def _grad_kernels(x4, dy4, gamma, start, step, reps):
    """in_grad_stats and in_grad_input against their plain versions on one
    map: (max errors, times)."""
    from nndetection_tpu_torch.ops.instance_norm import (
        in_grad_input, in_grad_input_plain, in_grad_stats, in_grad_stats_plain, in_stats_plain)

    name = f"{list(x4.shape)} {str(x4.dtype)[6:]} planes {start}::{step}"
    mean, var = in_stats_plain(x4, start, step)
    inv = torch.rsqrt(var + 1e-5)
    s1, s2 = in_grad_stats(x4, dy4, mean, inv)
    p1, p2 = in_grad_stats_plain(x4, dy4, mean, inv)
    e_stats = max(check_close(f"in_grad_stats s1 {name}", s1, p1, **TOL["in_grad_stats"]),
                  check_close(f"in_grad_stats s2 {name}", s2, p2, **TOL["in_grad_stats"]))
    dx = in_grad_input(x4, dy4, mean, inv, gamma, p1, p2, start, step)
    pdx = in_grad_input_plain(x4, dy4, mean, inv, gamma, p1, p2, start, step)
    tol = TOL["in_grad_input_f32" if x4.dtype == torch.float32 else "in_grad_input_bf16"]
    e_input = check_close(f"in_grad_input {name}", dx, pdx, **tol)
    times = {
        "in_grad_stats": median_ms(lambda: in_grad_stats(x4, dy4, mean, inv), reps),
        "in_grad_stats_plain": median_ms(lambda: in_grad_stats_plain(x4, dy4, mean, inv), reps),
        "in_grad_input": median_ms(
            lambda: in_grad_input(x4, dy4, mean, inv, gamma, p1, p2, start, step), reps),
        "in_grad_input_plain": median_ms(
            lambda: in_grad_input_plain(x4, dy4, mean, inv, gamma, p1, p2, start, step), reps),
    }
    log(f"[kernels] instance norm backward {name}: "
        f"grad sums err {e_stats:.2e} {times['in_grad_stats']:.4f} ms (plain {times['in_grad_stats_plain']:.4f}) | "
        f"input grad err {e_input:.2e} {times['in_grad_input']:.4f} ms (plain {times['in_grad_input_plain']:.4f})")
    return {"in_grad_stats": e_stats, "in_grad_input": e_input}, times


def phase_kernels(device, stages=LUNA_STAGES, nms_shapes=NMS_SHAPES, train_stage0=TRAIN_STAGE0,
                  conv_shapes=CONV_SHAPES, conv_train=CONV_TRAIN, iou_sizes=IOU_SIZES,
                  suppression_sizes=SUPPRESSION_SIZES, wbc_shape=WBC_SHAPE, wbc_sizes=WBC_SIZES,
                  in_batches=IN_BATCHES, reps=20):
    """Each kernel against its plain version; returns per-kernel max error
    and the times at the main path's representative shape (stage 0, bf16,
    the default plane_sub:8 schedule for IN, at batch 2 for the forward and
    at the train batch for the backward; 16 x 1000 boxes for NMS)."""
    from nndetection_tpu_torch.ops.instance_norm import (
        in_apply, in_apply_plain, in_stats_plain, plane_schedule)

    summary = {k: {"max_abs_err": 0.0} for k in KERNELS}

    def note_err(errs):
        for k, e in errs.items():
            summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], e)

    t0 = time.perf_counter()
    summary["in_stats"].update(norm_kernel_checks(device, stages, in_batches, reps))
    g = torch.Generator().manual_seed(0)
    for si, shape in enumerate(stages):
        b, d, h, w, c = shape
        base = torch.randn(shape, generator=g) * 2 + 1
        base_dy = torch.randn(shape, generator=g)
        gamma = (torch.rand(c, generator=g) + 0.5).to(device)
        beta = torch.randn(c, generator=g).to(device)
        for dtype in (torch.bfloat16, torch.float32):
            x4 = base.to(device, dtype).view(b, d, h * w, c)
            dy4 = base_dy.to(device, dtype).view(b, d, h * w, c)
            for stride in (None, 8):
                start, step = plane_schedule(d, stride)
                pmean, pvar = in_stats_plain(x4, start, step)
                y = in_apply(x4, pmean, pvar, gamma, beta)
                py = in_apply_plain(x4, pmean, pvar, gamma, beta)
                tol = TOL["in_apply_f32" if dtype == torch.float32 else "in_apply_bf16"]
                e_apply = check_close(f"in_apply {shape} {dtype}", y, py, **tol)
                note_err({"in_apply": e_apply})
                times = {
                    "in_apply": median_ms(lambda: in_apply(x4, pmean, pvar, gamma, beta), reps),
                    "in_apply_plain": median_ms(lambda: in_apply_plain(x4, pmean, pvar, gamma, beta), reps),
                }
                log(f"[kernels] instance norm apply {shape} {str(dtype)[6:]} planes {start}::{step}: "
                    f"err {e_apply:.2e} {times['in_apply']:.4f} ms (plain {times['in_apply_plain']:.4f})")
                if si == 0 and dtype == torch.bfloat16 and stride == 8:
                    out = torch.empty_like(x4)
                    e_lib = check_close(f"in_apply library {shape}",
                                        in_apply_library(x4, pmean, pvar, gamma, beta, out=out),
                                        py, **tol)
                    library_ms = median_ms(
                        lambda: in_apply_library(x4, pmean, pvar, gamma, beta, out=out), reps)
                    log(f"[kernels] instance norm apply {shape} bf16: torch.addcmul with the "
                        f"per-(b, c) scale and shift formed {library_ms:.4f} ms (err {e_lib:.2e}) "
                        f"against the kernel's {times['in_apply']:.4f} ms")
                    # x read and y written once, ~3 flops each
                    summary["in_apply"].update(
                        ms=times["in_apply"], plain_ms=times["in_apply_plain"],
                        library_ms=library_ms,
                        shape=f"{list(shape)} bf16 planes {start}::{step}",
                        **bound(nbytes(x4, x4, pmean, pvar, gamma, beta), 3 * x4.numel(), PEAK_F32))
                errs, _ = _grad_kernels(x4, dy4, gamma, start, step, reps)
                note_err(errs)
    # the backward's representative time: stage 0 of the train batch
    gd = torch.Generator(device=device).manual_seed(1)
    b, d, h, w, c = train_stage0
    x4 = (torch.randn((b, d, h * w, c), generator=gd, device=device) * 2 + 1).to(torch.bfloat16)
    dy4 = torch.randn((b, d, h * w, c), generator=gd, device=device).to(torch.bfloat16)
    gamma = torch.rand(c, generator=gd, device=device) + 0.5
    start, step = plane_schedule(d, 8)
    errs, times = _grad_kernels(x4, dy4, gamma, start, step, reps)
    note_err(errs)
    for k in ("in_grad_stats", "in_grad_input"):
        summary[k].update(ms=times[k], plain_ms=times[k + "_plain"], library_ms=None,
                          shape=f"{list(train_stage0)} bf16 planes {start}::{step}")
    # gradient sums: x and dy read, ~4 flops each; input gradient: x and dy
    # read, dx written, ~8 flops each
    summary["in_grad_stats"].update(**bound(nbytes(x4, dy4), 4 * x4.numel(), PEAK_F32))
    summary["in_grad_input"].update(**bound(nbytes(x4, dy4, x4), 8 * x4.numel(), PEAK_F32))
    del x4, dy4
    log(f"[kernels] instance norm checks took {time.perf_counter() - t0:.1f} s (Triton compiles included)")
    summary["nms_topk"].update(nms_kernel_checks(device, nms_shapes, reps))
    log(f"[kernels] took {time.perf_counter() - t0:.1f} s so far")
    summary["conv3d_in_stats"].update(conv_kernel_checks(device, conv_shapes, conv_train))
    summary.update(consolidation_kernel_checks(device, iou_sizes, suppression_sizes, reps))
    summary["wbc_cluster"].update(wbc_kernel_checks(device, wbc_shape, wbc_sizes, reps=reps))
    return summary


def norm_kernel_checks(device, stages=LUNA_STAGES, batches=IN_BATCHES, reps=20) -> dict:
    """#1 (``in_stats``) against its plain version at every LUNA stage, at
    each batch of ``batches``, under both schedules (exact, plane_sub:8), in
    float32, bfloat16 and float16: mean and var within ``TOL["in_stats"]``,
    one kernel launch per call (``torch.profiler``), two calls bit for bit
    equal. In bfloat16 it times the call (wall, device, host), the plain
    version and ``torch.var_mean`` and states the bound; one JSON line holds
    every timed shape. The summary is stage 0, batch 2, bf16, planes 4::8."""
    from nndetection_tpu_torch.ops.conv_in_stats import sm_count
    from nndetection_tpu_torch.ops.instance_norm import (
        in_stats, in_stats_plain, plan_in_stats, plane_schedule)

    gd = torch.Generator(device=device).manual_seed(4)
    n_sms = sm_count(device)
    err, out, rows = 0.0, {}, []
    for batch in batches:
        for si, stage in enumerate(stages):
            b, d, h, w, c = (batch,) + tuple(stage[1:])
            base = torch.randn((b, d, h * w, c), generator=gd, device=device) * 2 + 1
            for dtype in (torch.bfloat16, torch.float32, torch.float16):
                x4 = base.to(dtype)
                # exact and plane_sub:8 (the same planes below 16 of them)
                for start, step in dict.fromkeys(plane_schedule(d, s) for s in (None, 8)):
                    name = f"in_stats {[b, d, h, w, c]} {str(dtype)[6:]} planes {start}::{step}"
                    mean, var = in_stats(x4, start, step)
                    pmean, pvar = in_stats_plain(x4, start, step)
                    err = max(err, check_close(f"{name} mean", mean, pmean, **TOL["in_stats"]),
                              check_close(f"{name} var", var, pvar, **TOL["in_stats"]))
                    mean2, var2 = in_stats(x4, start, step)
                    if not (torch.equal(mean, mean2) and torch.equal(var, var2)):
                        raise AssertionError(f"{name}: two calls differ")
                    # the profiler's trace now and then lacks a kernel: three tries
                    for _ in range(3):
                        launched = kernels_launched(lambda: in_stats(x4, start, step))
                        if len(launched) == 4 and all("in_stats_kernel" in k for k in launched):
                            break
                    else:
                        raise AssertionError(f"{name}: four calls launched {launched}")
                    if dtype != torch.bfloat16:
                        continue
                    plan = plan_in_stats(b, d, h * w, c, start, step, n_sms)
                    t = three_times(lambda: in_stats(x4, start, step), reps)
                    sel = x4[:, start::step]
                    plain_ms = median_ms(lambda: in_stats_plain(x4, start, step), reps)
                    library_ms = median_ms(
                        lambda: torch.var_mean(sel, dim=(1, 2), correction=0), reps)
                    # the selected planes read once, ~3 flops each
                    bnd = bound(nbytes(sel, mean, var), 3 * sel.numel(), PEAK_F32)
                    log(f"[kernels] {name}: {plan.splits} splits x {plan.n_cb} channel blocks, "
                        f"one launch, bits equal; wall {t['ms']:.4f} ms, device "
                        f"{t['device_ms']:.4f}, host {t['host_ms']:.4f}; plain {plain_ms:.4f}, "
                        f"var_mean {library_ms:.4f}, bound {bnd['bound_ms']:.4f} ({bnd['bound_by']})")
                    rows.append(dict(shape=[b, d, h, w, c], planes=f"{start}::{step}",
                                     splits=plan.splits, blocks=plan.blocks, **t,
                                     plain_ms=plain_ms, library_ms=library_ms,
                                     bound_ms=bnd["bound_ms"]))
                    if batch == batches[0] and si == 0 and step == 8:
                        out = dict(t, plain_ms=plain_ms, library_ms=library_ms,
                                   shape=f"{[b, d, h, w, c]} bf16 planes {start}::{step}", **bnd)
            del base, x4
    json_line({"in_stats_shapes": rows})
    out["max_abs_err"] = err
    return out


def nms_boxes(rng, n_img, n):
    """Seeded boxes ``[n_img, n, 6]`` and scores ``[n_img, n]`` (10 % -inf)."""
    ctr = rng.uniform(10, 300, (n_img, n, 3))
    sz = rng.uniform(2, 25, (n_img, n, 3))
    boxes = torch.from_numpy(np.stack([
        ctr[..., 0] - sz[..., 0], ctr[..., 1] - sz[..., 1], ctr[..., 0] + sz[..., 0],
        ctr[..., 1] + sz[..., 1], ctr[..., 2] - sz[..., 2], ctr[..., 2] + sz[..., 2],
    ], -1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(n_img, n).astype(np.float32))
    scores[torch.from_numpy(rng.rand(n_img, n) < 0.1)] = float("-inf")
    return boxes, scores


def nms_kernel_checks(device, shapes=NMS_SHAPES, reps=20, thr=0.6) -> dict:
    """#7 (``nms_topk``) against its plain version at each NMS shape (the
    scratch in shared memory, or in a global workspace above 16384 boxes):
    indices and valid flags identical, also with scores quantised to 8
    levels and one image all -inf, two runs equal; wall, device and host
    times of the kernel and of the plain version. The summary is the first
    shape."""
    from nndetection_tpu_torch.ops.nms import nms_topk, nms_topk_plain, plan_nms_topk

    rng = np.random.RandomState(0)
    out = {}
    for ni, (n_img, n, max_out) in enumerate(shapes):
        boxes, scores = nms_boxes(rng, n_img, n)
        boxes, scores = boxes.to(device), scores.to(device)
        ties = (scores * 8).floor() / 8
        ties[0] = float("-inf")
        steps = min(max_out, n)
        plan = plan_nms_topk(n, max_out)
        for sc, what in ((scores, "scores"), (ties, "8-level scores, one image -inf")):
            wi, wv = nms_topk_plain(boxes, sc, thr, steps)
            ri, rv = nms_topk(boxes, sc, thr, max_out)
            ri2, rv2 = nms_topk(boxes, sc, thr, max_out)
            if not (torch.equal(ri[:, :steps], wi.long()) and torch.equal(rv[:, :steps], wv)
                    and torch.equal(ri, ri2) and torch.equal(rv, rv2)):
                raise AssertionError(f"nms_topk {n_img}x{n}, {what}: indices or valid flags "
                                     "differ from the plain version")
            if sc is scores:
                kept = int(wv.sum())
        if ni == 0:  # the named NaN case: special_boxes in every image
            nrng = np.random.RandomState(7)
            sp = torch.from_numpy(np.stack([special_boxes(nrng, n) for _ in range(n_img)]))
            sp = sp.to(device)
            for t_sp in (thr, -0.1):
                wi, wv = nms_topk_plain(sp, scores, t_sp, steps)
                ri, rv = nms_topk(sp, scores, t_sp, max_out)
                if not (torch.equal(ri[:, :steps], wi.long()) and torch.equal(rv[:, :steps], wv)):
                    raise AssertionError(f"nms_topk {n_img}x{n}, NaN case, threshold {t_sp}: "
                                         "indices or valid flags differ from the plain version")
            log(f"[kernels] nms_topk images {n_img} boxes {n}, NaN case (NaN, +-inf, signed "
                f"zeros; thresholds {thr} and -0.1): indices identical")
        plain_ms = median_ms(lambda: nms_topk_plain(boxes, scores, thr, steps), max(3, reps // 4), 1)
        t = three_times(lambda: nms_topk(boxes, scores, thr, max_out), reps)
        log(f"[kernels] nms_topk images {n_img} boxes {n} max_out {max_out}: indices identical "
            f"(also 8-level ties, all -inf), {kept} kept; wall {t['ms']:.4f} ms, device "
            f"{t['device_ms']:.4f}, host {t['host_ms']:.4f}; plain {plain_ms:.4f}, "
            f"smem {plan.smem_bytes} B, workspace {8 * plan.ws_words * n_img} B")
        if ni == 0:
            # the work this run's data needs: one IoU (~25 flops) and one
            # comparison per box for each step that found a box alive;
            # boxes and scores read once, int64 indices and bool flags
            # written once. The steps form a chain of max_out dependent
            # scans, a latency this bound does not count.
            out = dict(t, plain_ms=plain_ms, library_ms=None,
                       shape=f"{n_img} images x {n} boxes, max_out {max_out}",
                       **bound(nbytes(boxes, scores) + n_img * max_out * 9, kept * n * 26,
                               PEAK_F32))
    out["max_abs_err"] = 0.0
    return out


def conv_check(x, w, plan=None) -> tuple:
    """#5 on ``plan`` (default: the card's) against its plain version: y
    within one bf16 ulp of the plain (float64-summed) conv, the statistics
    against two-pass statistics of the kernel's own y, and a second run bit
    for bit equal to the first; returns (y, mean, var, max error)."""
    from nndetection_tpu_torch.ops.conv_in_stats import conv3d_in_stats, conv3d_in_stats_plain

    y, mean, var = conv3d_in_stats(x, w, plan)
    py, _, _ = conv3d_in_stats_plain(x, w)
    name = f"conv3d_in_stats {list(x.shape)} -> {w.shape[-1]}" + (f" {plan.route}" if plan else "")
    e_y = check_close(f"{name} y", y, py, **TOL["conv_y"])
    del py
    yf = y.float()
    kmean = yf.mean(dim=(1, 2, 3))
    kvar = (yf - kmean[:, None, None, None]).square().mean(dim=(1, 2, 3))
    e_s = max(check_close(f"{name} mean", mean, kmean, **TOL["conv_stats"]),
              check_close(f"{name} var", var, kvar, **TOL["conv_stats"]))
    del yf
    y2, mean2, var2 = conv3d_in_stats(x, w, plan)
    if not (torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(var, var2)):
        raise AssertionError(f"{name}: two runs differ")
    return y, mean, var, max(e_y, e_s)


def conv_kernel_checks(device, shapes=CONV_SHAPES, train=CONV_TRAIN, tiny=TINY_FUSED_LAYERS,
                       edge=CONV_EDGE_SHAPES, reps=10) -> dict:
    """#5 against its plain version (:func:`conv_check`) at every fused LUNA
    shape, the train batch's stage 0b, the tiny model's fused layers and the
    edge shapes, on the route ``plan_conv`` picks for the card. At the LUNA
    shapes it also times the kernel, the plain version, the library
    composition it replaces (cuDNN ``F.conv3d`` in bf16 on channels_last_3d,
    then ``torch.var_mean``), states the bound, and times the other routes
    the shape allows (im2col always; split-K aiming at one block per SM;
    the brick's other pipeline);
    one JSON line holds every shape's route and times. The summary is the
    train batch's stage 0b."""
    from nndetection_tpu_torch.ops.conv_in_stats import (
        BRICK_PIPELINES, SPLIT_BLOCKS_PER_SM, conv3d_in_stats, conv3d_in_stats_plain, plan_conv,
        sm_count)

    n_sms = sm_count(device)
    gd = torch.Generator(device=device).manual_seed(2)
    err = 0.0
    out, rows, routes = {}, [], set()
    luna = list(shapes) + [train]
    for i, (xs, co) in enumerate(luna + list(tiny) + list(edge)):
        ci = xs[-1]
        x = torch.randn(xs, generator=gd, device=device).to(torch.bfloat16)
        w = torch.randn((3, 3, 3, ci, co), generator=gd, device=device) * (2.0 / (27 * ci)) ** 0.5
        plan = plan_conv(xs, co, n_sms)
        routes.add(plan.route)
        y, mean, var, e = conv_check(x, w)
        err = max(err, e)
        name = (f"conv3d_in_stats {list(xs)} -> {co} {plan.route}"
                + (f" {plan.td}x{plan.th}x16, {plan.taps} taps x {plan.stages}"
                   if plan.route == "brick" else "")
                + (f" {plan.splits} splits" if plan.route == "split_k" else ""))
        if i >= len(luna):
            log(f"[kernels] {name}: err {e:.2e}")
            continue
        xn, wn = x.permute(0, 4, 1, 2, 3), w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()

        def library():
            yl = torch.nn.functional.conv3d(xn, wn, padding=1)
            return torch.var_mean(yl, dim=(2, 3, 4), correction=0)

        alts = {}
        if plan.route != "im2col":
            alts["im2col"] = plan_conv(xs, co, n_sms, route="im2col")
        if plan.route == "split_k":  # aiming at one block per SM
            alts["split_k 1/SM"] = plan_conv(xs, co, n_sms // SPLIT_BLOCKS_PER_SM,
                                             route="split_k")
        if plan.route == "brick":
            for taps, stages in BRICK_PIPELINES:
                if (taps, stages) != (plan.taps, plan.stages):
                    alts[f"brick {taps} taps x {stages}"] = plan_conv(
                        xs, co, n_sms, brick_pipeline=(taps, stages))
        for label, alt in alts.items():
            err = max(err, conv_check(x, w, alt)[3])
        ms = median_ms(lambda: conv3d_in_stats(x, w), reps)
        alt_ms = {label: median_ms(lambda: conv3d_in_stats(x, w, alt), reps)
                  for label, alt in alts.items()}
        plain_ms = median_ms(lambda: conv3d_in_stats_plain(x, w), 3, 1)
        library_ms = median_ms(library, reps)
        flops = 2 * 27 * ci * co * x.numel() // ci
        b = bound(nbytes(x, w.to(torch.bfloat16), y, mean, var), flops, PEAK_BF16)
        log(f"[kernels] {name}: err {e:.2e}; {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            + "".join(f"{k} {v:.4f} ms, " for k, v in alt_ms.items())
            + f"plain {plain_ms:.4f} ms, cuDNN conv + var_mean {library_ms:.4f} ms, "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        rows.append(dict(shape=list(xs), co=co, route=plan.route, splits=plan.splits,
                         brick=[plan.td, plan.th, 16] if plan.route == "brick" else None,
                         pipeline=[plan.taps, plan.stages] if plan.route == "brick" else None,
                         ms=ms, other_routes_ms=alt_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b["bound_ms"], bound_by=b["bound_by"]))
        if i == len(shapes):
            out = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, tflops=flops / ms / 1e9,
                       shape=f"{list(xs)} bf16 -> {co}", **b)
        del x, y
    if routes != {"brick", "split_k", "im2col"}:
        raise AssertionError(f"conv3d_in_stats: routes exercised {sorted(routes)}, want all three")
    json_line({"conv3d_in_stats_shapes": rows})
    out["max_abs_err"] = err
    return out


def clumped_boxes(rng, n, extent=300.0):
    """``n`` seeded boxes ``[n, 6]`` float32 in clumps of ~6 around random
    centres, as detections of one object from several tiles and flips."""
    ctr = rng.uniform(20, extent - 20, (max(n // 6, 1), 3))[rng.randint(0, max(n // 6, 1), n)]
    ctr = ctr + rng.uniform(-2, 2, (n, 3))
    half = rng.uniform(2, 12, (n, 3))
    lo, hi = ctr - half, ctr + half
    return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1).astype(np.float32)


def dense_boxes(rng, n, extent=300.0):
    """``n`` seeded boxes ``[n, 6]`` float32 in one clump: centres within 2
    of the middle, half sizes 8-12, so that every pair meets and every IoU
    of #6 takes its division."""
    ctr = extent / 2 + rng.uniform(-2, 2, (n, 3))
    half = rng.uniform(8, 12, (n, 3))
    lo, hi = ctr - half, ctr + half
    return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1).astype(np.float32)


def special_boxes(rng, n):
    """``n`` seeded boxes ``[n, 6]`` float32 in clumps around the origin,
    with the coordinates a diverged model or a padded input gives: a NaN
    coordinate in one box of ten, +inf or -inf in one of ten, flat boxes,
    and boxes that end or start at 0 along x, each zero signed at random (a
    box ending at -0 beside one starting at +0 gives min - max = -0)."""
    k = max(n // 6, 1)
    ctr = rng.uniform(-6, 6, (k, 3))[rng.randint(0, k, n)] + rng.uniform(-1, 1, (n, 3))
    half = rng.uniform(1, 6, (n, 3))
    lo, hi = ctr - half, ctr + half
    b = np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1).astype(np.float32)
    touch = rng.randint(0, 5, n)  # 0: ends at 0 along x, 1: starts there
    b[touch == 0, 2] = 0.0
    b[touch == 0, 0] = -half[touch == 0, 0]
    b[touch == 1, 0] = 0.0
    b[touch == 1, 2] = half[touch == 1, 0]
    b[(b == 0) & (rng.rand(n, 6) < 0.5)] = -0.0
    flat = rng.rand(n) < 0.05
    b[flat, 3] = b[flat, 1]
    for value, share in ((np.nan, 0.1), (np.inf, 0.05), (-np.inf, 0.05)):
        hit = np.nonzero(rng.rand(n) < share)[0]
        b[hit, rng.randint(0, 6, len(hit))] = value
    return b


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether two float32 tensors hold NaN at the same positions and the
    same bits everywhere else (NaN payloads may differ)."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def iou_ulps(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple:
    """#6's output against the plain version's: NaN must be at the same
    positions; returns the float32 ulps and the absolute error elsewhere,
    and raises above ``TOL["iou_ulps"]``."""
    nan = torch.isnan(want)
    if got.shape != want.shape or not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"iou_matrix {name}: shape or NaN positions differ from the plain "
                             "version")
    g, w = got[~nan], want[~nan]
    if not g.numel():
        return 0, 0.0
    ulps = int((g.view(torch.int32).long() - w.view(torch.int32).long()).abs().max())
    if ulps > TOL["iou_ulps"]:
        raise AssertionError(f"iou_matrix {name}: {ulps} float32 ulps from the plain version")
    return ulps, float((g - w).abs().max())


def iou_kernel_checks(device, sizes=IOU_SIZES, streamed=None, reps=20) -> dict:
    """#6 against its plain version on the card (:func:`iou_ulps`): at each
    size n x n of clumped boxes (most pairs apart: the division skipped;
    ``streamed`` holds the draws of ``IOU_STREAM_SIZES``) and of one dense
    clump (every pair meets), and n x (n // 2 + 3) clumped (M % 4 = 3 at
    these sizes: single-float stores); then the named NaN case
    (``special_boxes``: NaN, +-inf, signed zeros, flat boxes) both ways, with
    16-byte stores and without. At each size and input it times the call
    (wall, device, host), the plain version and the device time of the
    other grids (``rows_per_warp`` 1-16) and states the bound, beside the
    device time of an empty kernel; one JSON line holds them. The summary
    is the first size, clumped."""
    from nndetection_tpu_torch.ops.conv_in_stats import sm_count
    from nndetection_tpu_torch.ops.iou_matrix import iou_matrix, iou_matrix_plain, plan_iou

    n_sms = sm_count(device)
    streamed = streamed or {}
    out, rows, err = {}, [], 0.0
    # the least device time of one launch, measured as #6's is: an empty kernel
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), reps)
    log(f"[kernels] one launch's floor (an empty kernel, torch.cuda._sleep(0)): device "
        f"{floor_ms:.4f} ms")
    for n in sizes:
        clumped = streamed[n] if n in streamed else clumped_boxes(np.random.RandomState(n), n)
        inputs = {"clumped": clumped, "dense": dense_boxes(np.random.RandomState(n + 1), n)}
        for kind, boxes in inputs.items():
            b = torch.from_numpy(boxes).to(device)
            got, want = iou_matrix(b, b), iou_matrix_plain(b, b)
            ulps, e = iou_ulps(f"{n}x{n} {kind}", got, want)
            err = max(err, e)
            meet = int((want > 0).sum())
            del want
            plan = plan_iou(n, n, n_sms)
            t = three_times(lambda: iou_matrix(b, b), reps)
            plain_ms = median_ms(lambda: iou_matrix_plain(b, b), reps)
            other_ms = {f"R{r}": device_ms(lambda: iou_matrix(b, b, plan_iou(n, n, n_sms, r)), reps)
                        for r in (1, 2, 4, 8, 16) if r != plan.rows_per_warp}
            # boxes read once, the matrix written once; ~26 float32
            # operations per pair
            bnd = bound(nbytes(b, b, got), 26 * n * n, PEAK_F32)
            log(f"[kernels] iou_matrix {n}x{n} {kind} ({meet} pairs meet): {ulps} ulps, "
                f"{times_text(t)} (plain {plain_ms:.4f}), bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}); grid R{plan.rows_per_warp}, {plan.blocks} blocks; other "
                f"grids (device) "
                + ", ".join(f"{k} {v:.4f}" for k, v in other_ms.items()))
            rows.append(dict(n=n, input=kind, pairs_meet=meet, ulps=ulps, **t, plain_ms=plain_ms,
                             rows_per_warp=plan.rows_per_warp, vector=plan.vector,
                             blocks=plan.blocks, other_grids_ms=other_ms,
                             bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"]))
            if not out:
                out = dict(t, plain_ms=plain_ms, library_ms=None, shape=f"{n} x {n} boxes", **bnd)
            del got
        b2 = torch.from_numpy(clumped_boxes(np.random.RandomState(n + 2), n // 2 + 3)).to(device)
        ulps, e = iou_ulps(f"{n}x{n // 2 + 3}", iou_matrix(b, b2), iou_matrix_plain(b, b2))
        err = max(err, e)
        log(f"[kernels] iou_matrix {n}x{n // 2 + 3} dense x clumped: {ulps} ulps")
    rng = np.random.RandomState(5)
    sp, sp2 = (torch.from_numpy(special_boxes(rng, k)).to(device) for k in (1000, 1001))
    for x, y in ((sp, sp2), (sp2, sp), (sp, sp)):
        got, want = iou_matrix(x, y), iou_matrix_plain(x, y)
        ulps, e = iou_ulps(f"NaN case {len(x)}x{len(y)}", got, want)
        log(f"[kernels] iou_matrix NaN case {len(x)}x{len(y)}: NaN at the plain version's "
            f"{int(torch.isnan(want).sum())} positions, {ulps} ulps elsewhere")
    json_line({"iou_matrix_shapes": rows, "empty_kernel_device_ms": floor_ms})
    out["max_abs_err"] = err
    return out


def consolidation_kernel_checks(device, iou_sizes=IOU_SIZES, suppression_sizes=SUPPRESSION_SIZES,
                                reps=20) -> dict:
    """#6 (:func:`iou_kernel_checks`), #8 and the keep-scan against their
    plain versions on the card; the summary of each is its first shape."""
    from nndetection_tpu_torch.ops.suppression import (
        nms_keep_scan, nms_keep_scan_plain, num_words, suppression_matrix,
        suppression_matrix_plain)

    rng = np.random.RandomState(3)
    streamed = {n: clumped_boxes(rng, n) for n in IOU_STREAM_SIZES}
    out = {"iou_matrix": iou_kernel_checks(device, iou_sizes, streamed, reps)}

    def note(name, err, **row):
        if name not in out:
            out[name] = dict(row, max_abs_err=err)
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)

    thr = 0.1  # the model-level NMS's default model_iou
    for n in suppression_sizes:
        b = torch.from_numpy(clumped_boxes(rng, n)).to(device)
        valid = torch.from_numpy(rng.rand(n) > 0.1).to(device)
        words, pwords = suppression_matrix(b, thr), suppression_matrix_plain(b, thr)
        if not torch.equal(words, pwords):
            raise AssertionError(f"suppression_matrix {n}: words differ from the plain version")
        keep, pkeep = nms_keep_scan(words, valid), nms_keep_scan_plain(pwords, valid)
        if not torch.equal(keep, pkeep):
            raise AssertionError(f"nms_keep_scan {n}: keep flags differ from the plain version")
        times = {
            "suppression_matrix": three_times(lambda: suppression_matrix(b, thr), reps),
            "suppression_matrix_plain": median_ms(lambda: suppression_matrix_plain(b, thr), reps),
            "nms_keep_scan": three_times(lambda: nms_keep_scan(words, valid), reps),
            "nms_keep_scan_plain": median_ms(lambda: nms_keep_scan_plain(words, valid), 3, 1),
        }
        # #8: boxes read once, the words written once, ~26 operations per
        # pair above the diagonal; the keep-scan: each kept row's words from
        # its own on (the rest of its row is zero), the flags read and
        # written, one OR per word read
        kept = torch.nonzero(keep).flatten().cpu()
        words_read = int((num_words(n) - kept // 64).sum())
        b_sup = bound(nbytes(b, words), 26 * n * (n - 1) // 2, PEAK_F32)
        b_scan = bound(8 * words_read + 2 * n, words_read, PEAK_F32)
        log(f"[kernels] suppression_matrix {n} boxes thr {thr}: words identical, "
            f"{times_text(times['suppression_matrix'])} "
            f"(plain {times['suppression_matrix_plain']:.4f}), "
            f"bound {b_sup['bound_ms']:.4f} ms ({b_sup['bound_by']}) | nms_keep_scan: "
            f"{len(kept)} kept, identical, {times_text(times['nms_keep_scan'])} "
            f"(plain {times['nms_keep_scan_plain']:.4f}), "
            f"bound {b_scan['bound_ms']:.5f} ms ({b_scan['bound_by']})")
        for k, bnd in (("suppression_matrix", b_sup), ("nms_keep_scan", b_scan)):
            note(k, 0.0, **times[k], plain_ms=times[k + "_plain"], library_ms=None,
                 shape=f"{n} boxes, {len(kept)} kept" if k == "nms_keep_scan" else f"{n} boxes",
                 **bnd)
    return out


def suppression_times(device, sizes=SUPPRESSION_SIZES, reps=20, iou_sizes=IOU_SIZES) -> list:
    """Wall, device and host ms of #8 and the keep-scan at each size of
    ``sizes``, on seeded clumped boxes (90 % valid, threshold 0.1); of #6
    (``iou_matrix(b, b)``) at each size of ``iou_sizes`` on clumped boxes and
    on one dense clump; of #7 and the cluster kernel at their table shapes
    (16 images x 1000 boxes, max_out 100, threshold 0.6; 1000 boxes x 2
    classes). Through the ``nndetection_tpu_torch`` on ``sys.path``: this
    tree's, or in a ``--suppression-times`` subprocess a parent tree's."""
    from nndetection_tpu_torch.ops.iou_matrix import iou_matrix
    from nndetection_tpu_torch.ops.nms import nms_topk
    from nndetection_tpu_torch.ops.suppression import nms_keep_scan, suppression_matrix
    from nndetection_tpu_torch.ops.wbc_cluster import wbc_cluster

    rows = []
    for n in sizes:
        rng = np.random.RandomState(17 + n)
        b = torch.from_numpy(clumped_boxes(rng, n)).to(device)
        valid = torch.from_numpy(rng.rand(n) > 0.1).to(device)
        words = suppression_matrix(b, 0.1)
        kept = int(nms_keep_scan(words, valid).sum())
        for name, fn in (("suppression_matrix", lambda: suppression_matrix(b, 0.1)),
                         ("nms_keep_scan", lambda: nms_keep_scan(words, valid))):
            rows.append(dict(kernel=name, n=n, kept=kept, **three_times(fn, reps)))
        del words
    for n in iou_sizes:
        for kind, make in (("clumped", clumped_boxes), ("dense", dense_boxes)):
            b = torch.from_numpy(make(np.random.RandomState(17 + n), n)).to(device)
            rows.append(dict(kernel="iou_matrix", n=n, input=kind,
                             **three_times(lambda: iou_matrix(b, b), reps)))
    boxes, scores = nms_boxes(np.random.RandomState(0), *NMS_SHAPES[0][:2])
    boxes, scores = boxes.to(device), scores.to(device)
    rows.append(dict(kernel="nms_topk", n=NMS_SHAPES[0][1], images=NMS_SHAPES[0][0], **three_times(
        lambda: nms_topk(boxes, scores, 0.6, NMS_SHAPES[0][2]), reps)))
    wbc_in = [t.to(device) for t in table_wbc_input()]
    rows.append(dict(kernel="wbc_cluster", n=WBC_SHAPE[0], classes=WBC_SHAPE[1], **three_times(
        lambda: wbc_cluster(*wbc_in, WBC_SHAPE[1], 0.5, 0.0, 1.0), reps)))
    return rows


def suppression_times_worker(spec: dict) -> None:
    """``python3 chip_smoke.py --suppression-times=SPEC``: the times of
    :func:`suppression_times` for the tree at ``spec["root"]``, whose
    kernels its own ``ops/_build.py`` builds into its own ``_build/``; one
    JSON line."""
    from pathlib import Path

    root = Path(spec["root"]).resolve()
    sys.path.insert(0, str(root))
    import nndetection_tpu_torch

    if root not in Path(nndetection_tpu_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {nndetection_tpu_torch.__file__}, not the tree at {root}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(json.dumps({"suppression_times": suppression_times(
        device, spec["sizes"], spec["reps"], spec["iou_sizes"])}), flush=True)


def suppression_parent_comparison(device, parent: str, sizes=SUPPRESSION_SIZES, reps=20,
                                  iou_sizes=IOU_SIZES) -> None:
    """The times of :func:`suppression_times` (#6, #7, #8, the keep-scan
    and the cluster kernel) of the tree at ``parent`` (``--parent=DIR``, for
    example ``git archive`` of the parent commit) against this tree's, on
    the same card in one call, in turns: parent, this, this, parent. The
    parent runs in a subprocess of its own; each run prints its lines."""
    def parent_run():
        spec = dict(root=parent, sizes=list(sizes), reps=reps, iou_sizes=list(iou_sizes))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--suppression-times=" + json.dumps(spec)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"parent suppression times failed ({proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])["suppression_times"]

    runs = []
    for who in ("parent", "this tree", "this tree", "parent"):
        t0 = time.perf_counter()
        rows = (parent_run() if who == "parent"
                else suppression_times(device, sizes, reps, iou_sizes))
        runs.append(dict(tree=who, rows=rows))
        log(f"[kernels] {who} ({len(runs)} of 4, {time.perf_counter() - t0:.1f} s): "
            + "; ".join(f"{r['kernel']} {r['n']}{' ' + r['input'] if 'input' in r else ''}: "
                        f"{times_text(r)}" for r in rows))
    json_line({"suppression_compare": dict(parent=os.path.abspath(parent), runs=runs)})


def ensemble_boxes(rng, n, per_object):
    """``n`` seeded boxes ``[n, 6]`` float32 as ``per_object`` streams see
    ``n // per_object`` objects (half sizes 3-12, spread as densely as the
    table shape's clumps): each box an object's, its centre and half sizes
    jittered by up to 10 %."""
    m = max(n // per_object, 1)
    extent = 300.0 * max(m / 166, 1) ** (1 / 3)
    ctr, half = rng.uniform(20, extent - 20, (m, 3)), rng.uniform(3, 12, (m, 3))
    pick = rng.randint(0, m, n)
    c = ctr[pick] + rng.uniform(-0.1, 0.1, (n, 3)) * half[pick]
    h = half[pick] * rng.uniform(0.9, 1.1, (n, 3))
    lo, hi = c - h, c + h
    boxes = np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1)
    return boxes.astype(np.float32)


def wbc_inputs(rng, n, classes, per_object=None):
    """Seeded inputs of the cluster kernel, CPU tensors: ``n`` boxes in
    clumps over an extent that grows as n^(1/3) from 300 at 1000 boxes (as
    dense as the table shape), or as ``per_object`` streams see objects;
    scores, weights, expected counts, labels of ``classes`` classes, all
    valid."""
    boxes = (clumped_boxes(rng, n, 300.0 * max(n / 1000, 1) ** (1 / 3)) if per_object is None
             else ensemble_boxes(rng, n, per_object))
    scores = rng.rand(n).astype(np.float32)
    weights = (0.5 + rng.rand(n)).astype(np.float32)
    n_exp = rng.randint(1, 9, n).astype(np.float32)
    labels = rng.randint(0, classes, n).astype(np.int32)
    return ([torch.from_numpy(a) for a in (boxes, scores, weights, n_exp, labels)]
            + [torch.ones(n, dtype=torch.bool)])


def table_wbc_input(shape=WBC_SHAPE):
    """The table shape's inputs: the draws that follow those of
    ``consolidation_kernel_checks`` from ``RandomState(3)``, the boxes every
    run has timed the cluster kernel on since it was ported."""
    rng = np.random.RandomState(3)
    for n in IOU_STREAM_SIZES:
        clumped_boxes(rng, n)
    for n in SUPPRESSION_SIZES[:2]:  # the sizes checked when the table shape was set
        clumped_boxes(rng, n)
        rng.rand(n)
    return wbc_inputs(rng, *shape)


def consolidation_wbc_inputs(device, shape=(96, 256, 256), patch=(96, 128, 128),
                             names=("BoxEnsemblerSelective", "BoxEnsemblerWBC")) -> dict:
    """The cluster kernel's arguments in the consolidate phase's 8-flip case
    (one class), per ensembler: recorded from ``batched_wbc`` during a
    ``predict_case`` on the card, the same case and weights as that phase."""
    import nndetection_tpu_torch.core.boxes.wbc as core_wbc
    from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet

    cfg = luna_cfg(patch)
    params = RetinaUNet(cfg, torch.Generator().manual_seed(0)).state_dict()
    case = np.random.RandomState(5).standard_normal((1, *shape)).astype(np.float32)
    kernel, out = core_wbc.wbc_cluster, {}
    try:
        for name in names:
            calls = []
            core_wbc.wbc_cluster = lambda *a: calls.append(a) or kernel(*a)
            Predictor([ModelBundle(cfg=cfg, params=params, name="luna")], tta=True,
                      ensembler=name, device=device).predict_case(case)
            out[name] = calls[-1]
    finally:
        core_wbc.wbc_cluster = kernel
    return out


def wbc_kernel_checks(device, shape=WBC_SHAPE, sizes=WBC_SIZES, reps=20) -> dict:
    """The cluster kernel (``wbc_cluster``) against its plain version on the
    CPU copies of the same inputs, at the table shape, at the consolidate
    phase's real inputs and at one class of each of ``sizes``
    (boxes, boxes per object): all three outputs bit for bit, two calls equal, one launch per
    call; wall, device and host times; at the table shape also the plain
    version on the card, and ``batched_wbc`` as one launch and none of #6;
    at ``WBC_PEAK_N`` the peak memory of one call. One JSON line holds every
    input's times. The summary is the table shape."""
    from nndetection_tpu_torch.core.boxes.wbc import batched_wbc
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.ops.wbc_cluster import plan_wbc, wbc_cluster, wbc_cluster_plain

    cases = [(f"{shape[0]} boxes x {shape[1]} classes", table_wbc_input(shape),
              (shape[1], 0.5, 0.0, 1.0))]
    for name, args in consolidation_wbc_inputs(device).items():
        cases.append((f"{name} 8-flip case, {args[0].shape[0]} boxes x {args[6]} class",
                      list(args[:6]), tuple(args[6:])))
    rng = np.random.RandomState(11)
    for n, per_object in sizes:
        cases.append((f"{n} boxes x 1 class" + (f", {per_object} per object" if per_object else ""),
                      wbc_inputs(rng, n, 1, per_object), (1, 0.5, 0.0, 1.0)))
    out, rows = {}, []
    for i, (label, inputs, rest) in enumerate(cases):
        dev_in = [t.to(device) for t in inputs]
        cpu_in = [t.cpu() for t in inputs]
        n = dev_in[1].shape[0]
        n0 = LAUNCHES["wbc_cluster"]
        got, again = wbc_cluster(*dev_in, *rest), wbc_cluster(*dev_in, *rest)
        torch.cuda.synchronize()
        if LAUNCHES["wbc_cluster"] != n0 + 2:
            raise AssertionError(f"wbc_cluster {label}: {LAUNCHES['wbc_cluster'] - n0} launches "
                                 "in two calls")
        t0 = time.perf_counter()
        want = wbc_cluster_plain(*cpu_in, *rest)
        plain_cpu_s = time.perf_counter() - t0
        if not wbc_same(got, again, want):
            raise AssertionError(f"wbc_cluster {label}: outputs differ from the plain version "
                                 "or between two calls")
        classes, iou_thr, _, mw = rest
        seeds = int(wbc_cluster(*dev_in, classes, iou_thr, float("-inf"), mw)[2].sum())
        t = three_times(lambda: wbc_cluster(*dev_in, *rest), reps if n <= 5000 else 5)
        plan = plan_wbc(n)
        remaining = int((cpu_in[5] & torch.isfinite(cpu_in[1]) & (cpu_in[4] < classes)).sum())
        # the function's work, whatever computes it: the inputs read once,
        # the outputs written once, one IoU (~25 operations) and the ten sums
        # (~12) per remaining box
        bnd = bound(nbytes(*dev_in, *got), 37 * remaining, PEAK_F32)
        row = dict(input=label, n=n, classes=classes, clusters=seeds, emitted=int(got[2].sum()),
                   **t, bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                   smem_bytes=plan.smem_bytes, workspace_bytes=8 * plan.ws_words * classes,
                   plain_cpu_s=plain_cpu_s)
        extra = ""
        if n == WBC_PEAK_N:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            wbc_cluster(*dev_in, *rest)
            torch.cuda.synchronize()
            row["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
            extra = (f"; one call's peak memory {row['peak_bytes'] / 2 ** 20:.2f} MiB (an N x N "
                     f"float32 IoU matrix: {4 * n * n / 2 ** 30:.2f} GiB)")
        if i == 0:
            row["plain_ms"] = median_ms(lambda: wbc_cluster_plain(*dev_in, *rest), 3, 1)
            before = dict(LAUNCHES)
            boxes, scores, weights, n_exp, labels, valid = dev_in
            batched_wbc(boxes, scores, labels, weights, n_exp, valid, iou_thr, rest[2],
                        missing_weight=mw, num_classes=classes)
            torch.cuda.synchronize()
            delta = {k: LAUNCHES[k] - before.get(k, 0) for k in ("wbc_cluster", "iou_matrix")}
            if delta != {"wbc_cluster": 1, "iou_matrix": 0}:
                raise AssertionError(f"batched_wbc: launches {delta}, want one wbc_cluster, "
                                     "no iou_matrix")
            extra += f"; plain on the card {row['plain_ms']:.4f} ms; batched_wbc one launch, no #6"
            out = dict(t, plain_ms=row["plain_ms"], library_ms=None,
                       shape=f"{label}, {seeds} clusters", **bnd)
        log(f"[wbc] {label}: {seeds} clusters, {row['emitted']} emitted, bits equal to the plain "
            f"version and between two calls; wall {t['ms']:.4f} ms, device {t['device_ms']:.4f}, "
            f"host {t['host_ms']:.4f}; bound {bnd['bound_ms']:.5f} ({bnd['bound_by']}); smem "
            f"{plan.smem_bytes} B, workspace {row['workspace_bytes']} B; plain on the CPU "
            f"{plain_cpu_s:.2f} s" + extra)
        rows.append(row)
    # the named NaN case: special_boxes (NaN, +-inf, signed zeros, flat
    # boxes) and a NaN weight in one box of ten, 2 classes
    rng = np.random.RandomState(13)
    nan_in = wbc_inputs(rng, shape[0], 2)
    nan_in[0] = torch.from_numpy(special_boxes(rng, shape[0]))
    nan_in[2][torch.from_numpy(rng.rand(shape[0]) < 0.1)] = float("nan")
    for score_thr in (0.0, float("-inf")):
        rest = (2, 0.5, score_thr, 1.0)
        dev_in = [t.to(device) for t in nan_in]
        n0 = LAUNCHES["wbc_cluster"]
        got, again = wbc_cluster(*dev_in, *rest), wbc_cluster(*dev_in, *rest)
        torch.cuda.synchronize()
        if LAUNCHES["wbc_cluster"] != n0 + 2 or not wbc_same(got, again,
                                                             wbc_cluster_plain(*nan_in, *rest)):
            raise AssertionError(f"wbc_cluster NaN case, score threshold {score_thr}: outputs "
                                 "differ from the plain version or between two calls")
        log(f"[wbc] NaN case, {shape[0]} boxes x 2 classes, score threshold {score_thr}: "
            f"{int(got[2].sum())} emitted, bits equal to the plain version")
    json_line({"wbc_shapes": rows})
    out["max_abs_err"] = 0.0
    return out


def wbc_same(got, again, want) -> bool:
    """The cluster kernel's two calls and the plain version's outputs on the
    CPU: the same bits (NaN at the same positions) and the same flags."""
    return all((same_bits(g, a) and same_bits(g.cpu(), w)) if g.is_floating_point()
               else (torch.equal(g, a) and torch.equal(g.cpu(), w))
               for g, a, w in zip(got, again, want))


def spread(model, scale=100.0):
    """Scale the classifier's output conv, so that scores spread and top
    scores saturate: at initialization all scores sit within ~1e-2 of the
    prior, where float32 differences between two devices reorder near-equal
    scores and the greedy NMS turns that into different kept boxes."""
    with torch.no_grad():
        model.classifier.out.weight.mul_(scale)
    return model


def phase_reference(device, cfg=None, case_shape=(48, 48, 48), label="tiny float32") -> None:
    """The tiny float32 model (``cfg``, default :func:`tiny_cfg`) on the card
    against the CPU (plain kernels, CPU convolutions), TF32 off: forward,
    post-processing, ``predict_case`` of a ``case_shape`` case without and
    with TTA, one train step."""
    from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet, batched_postprocess

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or tiny_cfg()
    cpu_model = spread(RetinaUNet(cfg, torch.Generator().manual_seed(0)).eval())
    dev_model = RetinaUNet(cfg).to(device).eval()
    dev_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (2, *cfg.patch_size, 1)).astype(np.float32))
    with torch.inference_mode():
        want = cpu_model(x)
        got = dev_model(x.to(device))
        errs = {k: check_close(f"reference {k}", got[k].cpu(), want[k], 1e-3, 1e-3) for k in want}
        anchors = torch.from_numpy(cfg.anchors()[0])
        rng = np.random.RandomState(2)
        heads = {"box_logits": torch.from_numpy((rng.standard_normal(want["box_logits"].shape) * 3).astype(np.float32)),
                 "box_deltas": torch.from_numpy((rng.standard_normal(want["box_deltas"].shape) * 0.3).astype(np.float32))}
        pw = batched_postprocess(cfg, heads, anchors, cfg.patch_size)
        pg = batched_postprocess(cfg, {k: v.to(device) for k, v in heads.items()}, anchors.to(device), cfg.patch_size)
        for k in ("valid", "labels"):
            if not torch.equal(pg[k].cpu(), pw[k]):
                raise AssertionError(f"reference postprocess {k} differs")
        errs["post_boxes"] = check_close("reference boxes", pg["boxes"].cpu(), pw["boxes"], 0, 1e-4)
    case = np.random.RandomState(3).standard_normal((1, *case_shape)).astype(np.float32)
    bundle = [ModelBundle(cfg=cfg, params=cpu_model.state_dict())]
    for tta in (False, True):
        rc = Predictor(bundle, tta=tta, device="cpu").predict_case(case)
        rg = Predictor(bundle, tta=tta, device=device).predict_case(case)
        if len(rc["pred_scores"]) != len(rg["pred_scores"]) or not len(rc["pred_scores"]):
            raise AssertionError(f"reference predict_case tta={tta}: {len(rg['pred_scores'])} "
                                 f"detections on the card, {len(rc['pred_scores'])} on the CPU")
        # as sets: equal scores may list their detections in another order
        errs[f"case_tta{int(tta)}"] = paired_max_err(f"{label} case tta={tta}", rg, rc, 0, 1e-3)
    log(f"[reference] {label} model, card vs CPU (TF32 off), max abs err: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    reference_train_step(device, cfg, cpu_model.state_dict(), label=label)


@contextlib.contextmanager
def conv_fused():
    """``NNDET_CONV_FUSED=1`` inside, the caller's setting restored after, so
    that the other phases keep measuring the default configuration."""
    old = os.environ.get("NNDET_CONV_FUSED")
    os.environ["NNDET_CONV_FUSED"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["NNDET_CONV_FUSED"]
        else:
            os.environ["NNDET_CONV_FUSED"] = old


def phase_reference_fused(device) -> None:
    """The tiny float32 model under ``NNDET_CONV_FUSED=1`` on the card
    against the CPU: a forward, and one train step of the ``no_sampler``
    head (the hard-negative heads rank negatives by scores that differ at
    bf16 level here, and would pick other negatives)."""
    import dataclasses

    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from nndetection_tpu_torch.ops import LAUNCHES

    cfg = dataclasses.replace(tiny_cfg(), head_type="no_sampler")
    cpu_model = RetinaUNet(cfg, torch.Generator().manual_seed(0)).eval()
    dev_model = RetinaUNet(cfg).to(device).eval()
    dev_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).standard_normal((2, 32, 32, 32, 1)).astype(np.float32))
    with conv_fused(), torch.inference_mode():
        n0 = LAUNCHES["conv3d_in_stats"]
        want = cpu_model(x)
        got = dev_model(x.to(device))
        torch.cuda.synchronize()
        n_launch = LAUNCHES["conv3d_in_stats"] - n0
        errs = {k: check_close(f"reference fused {k}", got[k].cpu(), want[k], 0,
                               FUSED_FWD_TOL * float(want[k].abs().max())) for k in want}
    # the tiny model's fused layers: both convs of stage 0, the second of stages 1-3
    if n_launch != 5:
        raise AssertionError(f"reference fused forward: {n_launch} conv3d_in_stats launches, want 5")
    log("[reference] tiny float32 model under NNDET_CONV_FUSED=1, card vs CPU, max abs err: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f"; {n_launch} conv3d_in_stats launches")
    fused_function_check(device)
    with conv_fused():
        reference_train_step(device, cfg, cpu_model.state_dict(), REF_STEP_TOL_FUSED,
                             "tiny float32 NNDET_CONV_FUSED=1")


def fused_function_check(device, layers=TINY_FUSED_LAYERS) -> None:
    """``conv_instance_norm`` (the fused kernel, the apply, and the backward
    through the instance-norm kernels and cuDNN's bf16 conv VJP) on the card
    against the CPU, float32 model, at the tiny model's fused layers: the
    output and the gradients of x, w, gamma and beta."""
    from nndetection_tpu_torch.ops.conv_in_stats import conv_instance_norm

    g = torch.Generator().manual_seed(5)
    worst = 0.0
    for xs, co in layers:
        ci = xs[-1]
        x = torch.randn(xs, generator=g)
        w = torch.randn((co, ci, 3, 3, 3), generator=g) * (2.0 / (27 * ci)) ** 0.5
        gamma, beta = torch.rand(co, generator=g) + 0.5, torch.randn(co, generator=g) * 0.1
        r = torch.randn((*xs[:-1], co), generator=g)
        runs = []
        for dev in ("cpu", device):
            leaves = [t.to(dev).clone().requires_grad_() for t in (x, w, gamma, beta)]
            out = conv_instance_norm(*leaves, 1e-5, torch.float32)
            (torch.relu(out) * r.to(dev)).sum().backward()
            runs.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
        for name, got, want in zip(("out", "dx", "dw", "dgamma", "dbeta"), runs[1], runs[0]):
            rel = _rel_l2([got], [want])
            if not rel <= FUSED_FN_TOL:
                raise AssertionError(f"fused Function {list(xs)} -> {co} {name}: card vs CPU "
                                     f"{rel:.3e} relative, beyond {FUSED_FN_TOL}")
            worst = max(worst, rel)
    log(f"[reference] fused conv + norm Function at the tiny model's {len(layers)} fused layers, "
        f"card vs CPU: output and gradients within {worst:.2e} relative")


def instance_batch(rng, batch, patch, max_inst=8):
    """A seeded raw batch as ``bench.py:62-76`` makes it: one cube (a square
    in 2D) of instance id 1 per image around a random centre, class 0, noise
    images."""
    seg = np.zeros((batch, *patch), np.int32)
    for b in range(batch):
        c = [rng.randint(12, g - 12) for g in patch]
        r = rng.randint(3, 8)
        seg[(b, *(slice(ci - r, ci + r) for ci in c))] = 1
    table = np.full((batch, max_inst), -1, np.int32)
    table[:, 0] = 0
    images = rng.standard_normal((batch, *patch, 1)).astype(np.float32)
    return images, seg, table


def train_targets(device, batch, patch, seed=0):
    """Training targets of :func:`instance_batch` through the port's
    ``prepare_targets``, on ``device``."""
    from nndetection_tpu_torch.data.gt_prep import prepare_targets

    images, seg, table = instance_batch(np.random.RandomState(seed), batch, patch)
    return prepare_targets(*(torch.from_numpy(a).to(device) for a in (images, seg, table)))


def _rel_l2(got, want) -> float:
    """``|got - want| / |want|`` of the concatenated tensors."""
    num = sum(float((g - w).double().square().sum()) for g, w in zip(got, want))
    den = sum(float(w.double().square().sum()) for w in want)
    return math.sqrt(num / den)


def keep_grads(state, grads: dict) -> None:
    """Copy the clipped gradients into ``grads`` as the optimizer receives
    them (the multi-tensor SGD on the card may update them in place)."""
    step = state.optimizer.step

    def wrapped(*args, **kwargs):
        grads.update({n: p.grad.detach().cpu().clone()
                      for n, p in state.model.named_parameters()})
        return step(*args, **kwargs)

    state.optimizer.step = wrapped


def reference_train_step(device, cfg, params, tol=REF_STEP_TOL, label="tiny float32") -> None:
    """One ``Trainer.train_epoch`` step of the tiny float32 model on the
    card against the CPU, with the sampler's draws made once on the CPU and
    replayed on the card: losses, the gradient of every parameter, and every
    parameter after the update."""
    from nndetection_tpu_torch.core.boxes import sampler
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(batch_size=2, warm_iterations=0, max_epochs=1,
                         num_train_batches_per_epoch=10, swa_epochs=0)
    batch = {k: v.numpy() for k, v in train_targets("cpu", 2, cfg.patch_size, seed=4).items()}
    draws = []
    draw = sampler.draw_uniform

    def record(generator, shape, dev):
        u = draw(generator, shape, dev)
        draws.append(u.clone())
        return u

    runs = []
    try:
        for dev, fn in (("cpu", record), (device, lambda g, shape, d: draws.pop(0).to(d))):
            sampler.draw_uniform = fn
            trainer = Trainer(cfg, tcfg, dev)
            state = trainer.init_state(params=params)
            grads = {}
            keep_grads(state, grads)
            state, metrics = trainer.train_epoch(state, [batch], 0)
            runs.append((metrics, grads, dict(state.model.named_parameters())))
    finally:
        sampler.draw_uniform = draw
    (m_cpu, g_cpu, p_cpu), (m_dev, g_dev, p_dev) = runs
    errs = {}
    for k in ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg"):
        want = torch.tensor(m_cpu[f"train_{k}"])
        errs[k] = check_close(f"reference train {k}", torch.tensor(m_dev[f"train_{k}"]), want,
                              *tol["loss"])
    if m_cpu["train_num_pos"] <= 0:
        raise AssertionError("reference train step: no positive anchor")
    if "global_rel" in tol:
        names = list(p_dev)
        g_rel = _rel_l2([g_dev[n] for n in names], [g_cpu[n] for n in names])
        upd = lambda pp: [pp[n].detach().cpu() - params[n].cpu() for n in names]  # noqa: E731
        u_rel = _rel_l2(upd(p_dev), upd(p_cpu))
        worst = sorted(names, key=lambda n: float((g_dev[n] - g_cpu[n]).norm()))[-3:]
        log(f"[reference] {label}: |g_card - g_cpu| / |g_cpu| {g_rel:.3e}, the same of the "
            f"updates {u_rel:.3e}; largest differences in " + ", ".join(worst))
        if not (g_rel <= tol["global_rel"] and u_rel <= tol["global_rel"]):
            raise AssertionError(f"reference {label}: gradient or update beyond "
                                 f"{tol['global_rel']} relative")
        g_err, p_err = g_rel, u_rel
    else:
        g_err = p_err = 0.0
        for name, p in p_dev.items():
            want = g_cpu[name]
            g_err = max(g_err, check_close(f"reference grad {name}", g_dev[name], want, 0,
                                           tol["grad"] * float(want.abs().max())))
            p_err = max(p_err, check_close(f"reference param {name}", p.detach().cpu(),
                                           p_cpu[name].detach(), *tol["param"]))
    log(f"[reference] {label} train step, card vs CPU (same sampler draws, TF32 off), "
        "max abs err: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f", gradients {g_err:.2e}, parameters after the update {p_err:.2e}; "
        f"num_pos {m_cpu['train_num_pos']:.0f}, num_neg {m_cpu['train_num_neg']:.0f}")


def phase_forward(device, patch=(96, 128, 128), batch=2) -> None:
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet

    cfg = luna_cfg(patch)
    model = RetinaUNet(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.randn((batch, *patch, 1), generator=torch.Generator().manual_seed(1)).to(device)
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
        ms = median_ms(lambda: model(x), reps=5, warmup=1)
    n_anchors = len(cfg.anchors()[0])
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"forward: {k} has non-finite values")
    if tuple(out["box_logits"].shape) != (batch, n_anchors, 1):
        raise AssertionError(f"forward: box_logits {tuple(out['box_logits'].shape)}")
    log(f"[forward] LUNA plan patch {patch} batch {batch} bf16, {n_params / 1e6:.2f}M params, "
        f"{n_anchors} anchors: all finite; "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in out.items())
        + f"; {ms:.2f} ms per forward (median of 5)")


SERVE_KERNELS = ("in_stats", "in_apply", "nms_topk", "wbc_cluster")
CONSOLIDATE_KERNELS = ("wbc_cluster",)
NMS_MASK_KERNELS = ("suppression_matrix", "nms_keep_scan")
TRAIN_KERNELS = ("in_stats", "in_apply", "in_grad_stats", "in_grad_input")
# conv3d_in_stats launches per forward of the LUNA plan under
# NNDET_CONV_FUSED=1: both convs of stage 0 and the second conv of stages
# 1-5 (3x3x3, stride 1, instance norm; the first conv of stages 1-5 is
# strided, so unfused)
FUSED_PER_FORWARD = 7


def phase_serve(device, cases=(((140, 320, 320), False), ((96, 256, 256), True)),
                patch=(96, 128, 128), label="serve", required=SERVE_KERNELS):
    """Returns the launches of the phase and the model forwards it ran."""
    from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from nndetection_tpu_torch.ops import LAUNCHES

    cfg = luna_cfg(patch)
    params = RetinaUNet(cfg, torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.RandomState(0)
    forwards = 0
    LAUNCHES.clear()
    for shape, tta in cases:
        predictor = Predictor([ModelBundle(cfg=cfg, params=params, name="luna")], tta=tta,
                              device=device)
        case = rng.standard_normal((1, *shape)).astype(np.float32)
        # first call (cuDNN picks its algorithms for the new batch shape),
        # then a warm one
        seconds = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = predictor.predict_case(case)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        n_tiles = len(res["ensembler"].model_results[next(iter(res["ensembler"].model_results))]["scores"])
        forwards += 2 * math.ceil(n_tiles / predictor.tiles_per_call)
        boxes = res["pred_boxes"]
        if not (np.isfinite(boxes).all() and np.isfinite(res["pred_scores"]).all()):
            raise AssertionError(f"{label}: non-finite detections")
        if len(boxes) and ((boxes[:, [0, 1, 4]] < -1e-3).any() or
                           (boxes[:, [2, 3, 5]] > np.asarray(shape)[[0, 1, 2]] + 1e-3).any()):
            raise AssertionError(f"{label}: boxes outside the case")
        log(f"[{label}] case {shape} tta={tta}: first {seconds[0]:.4f} s, warm {seconds[1]:.4f} s "
            f"({60 / seconds[1]:.1f} volumes/min), {n_tiles} tiles x "
            f"{len(predictor.tta_flips)} flips, {predictor.tiles_per_call} tiles per call, "
            f"{len(boxes)} detections")
    launches = dict(LAUNCHES)
    missing = [k for k in required if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")
    log(f"[{label}] kernel launches during {label}: {launches}, {forwards} model forwards")
    return launches, forwards


def _consolidate(ens, device, device_wbc, fresh=True):
    """``ens.get_case_result()`` with its WBC on ``device`` as ``device_wbc``
    selects, timed on the host clock; ``fresh`` empties the memo caches
    first, so that the model-level NMS runs too."""
    import nndetection_tpu_torch.inference.ensembler as ensembler

    old = ens.device, ensembler.DEVICE_WBC
    ens.device, ensembler.DEVICE_WBC = device, device_wbc
    try:
        if fresh:
            ens._concat_cache.clear()
            ens._model_post_cache.clear()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ens.get_case_result()
        return res, time.perf_counter() - t0
    finally:
        ens.device, ensembler.DEVICE_WBC = old


def _check_detections(label, res, shape):
    boxes, scores = res["pred_boxes"], res["pred_scores"]
    if not len(scores):
        raise AssertionError(f"{label}: no detections")
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
        raise AssertionError(f"{label}: non-finite detections")
    if (boxes[:, [0, 1, 4]] < -1e-3).any() or (boxes[:, [2, 3, 5]] > np.asarray(shape) + 1e-3).any():
        raise AssertionError(f"{label}: boxes outside the case")


def paired_max_err(label, got, want, rtol, atol) -> float:
    """Max abs error of two case results as sets of detections: each of
    ``got`` paired with the nearest of ``want`` (scores, boxes, labels), one
    to one, every pair within ``atol + rtol * |want|``. Equal scores may
    list their detections in another order."""
    def rows(r):
        return np.concatenate([r["pred_boxes"], r["pred_scores"][:, None],
                               r["pred_labels"][:, None].astype(np.float64)], 1)

    a, b = rows(got), rows(want)
    diff = np.abs(a[:, None] - b[None])
    ratio = (diff / (atol + rtol * np.abs(b)[None])).max(-1)
    nearest = ratio.argmin(1)
    if len(a) != len(b) or sorted(nearest.tolist()) != list(range(len(b))):
        raise AssertionError(f"{label}: {len(a)} and {len(b)} detections do not pair one to one")
    worst = ratio[np.arange(len(a)), nearest].max() if len(a) else 0.0
    if worst > 1:
        raise AssertionError(f"{label}: a detection beyond rtol={rtol} atol={atol} ({worst:.2f}x)")
    return float(diff[np.arange(len(a)), nearest].max()) if len(a) else 0.0


def model_nms_times(ens, device):
    """The model-level NMS over every stream's candidates, ranked as the
    ensembler's ``model_nms_fn`` ranks them: seconds through the host library
    (``batched_nms_np``, one call a stream), through the NumPy loop
    (``nms_np_plain`` on the same class-offset boxes), which must keep the
    same boxes, and through ``batched_model_nms_device`` on ``device`` (one
    launch of #7 for every stream, synchronised), which must keep the host
    library's first ``model_detections_per_image``."""
    from nndetection_tpu_torch.core.boxes.ops_np import batched_nms_np, nms_np_plain
    from nndetection_tpu_torch.inference.ensembler import MODEL_NMS_KEYS, batched_model_nms_device

    p = ens.parameters
    thr, max_out = p["model_iou"], p["model_detections_per_image"]
    rank = MODEL_NMS_KEYS[p["model_nms_fn"]]
    n_boxes, t_native, t_plain = 0, 0.0, 0.0
    streams, keeps = [], []
    for name in ens.model_results:
        boxes, probs, labels, weights = ens.model_candidates(name)
        ranked = rank(probs, weights)
        streams.append((boxes, ranked, labels))
        if not len(boxes):
            keeps.append(np.zeros((0,), np.int64))
            continue
        t0 = time.perf_counter()
        keep = batched_nms_np(boxes, ranked, labels, thr)
        t1 = time.perf_counter()
        shifted = boxes.astype(np.float64)
        offsets = labels.astype(np.float64) * (boxes.max() + 1)
        shifted[:, [0, 1, 4]] += offsets[:, None]
        shifted[:, [2, 3, 5]] += offsets[:, None]
        want = nms_np_plain(shifted, ranked, thr)
        t2 = time.perf_counter()
        if not np.array_equal(keep, want):
            raise AssertionError(f"model-level NMS of stream {name}: the host library keeps "
                                 f"{len(keep)} boxes, the NumPy loop {len(want)}")
        keeps.append(keep[:max_out])
        n_boxes += len(boxes)
        t_native += t1 - t0
        t_plain += t2 - t1
    card_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = batched_model_nms_device(streams, thr, max_out, device)
        card_s.append(time.perf_counter() - t0)
        for name, g, w in zip(ens.model_results, got, keeps):
            if not np.array_equal(g, w):
                raise AssertionError(f"model-level NMS of stream {name}: the card keeps "
                                     f"{len(g)} boxes, the host library's first {max_out} "
                                     f"{len(w)}, or others")
    return n_boxes, t_native, t_plain, float(np.median(card_s))


def phase_consolidate(device, shape=(96, 256, 256), patch=(96, 128, 128), tta=True,
                      names=("BoxEnsemblerSelective", "BoxEnsemblerWBC")):
    """The 8-flip case through ``predict_case`` with each ensembler (first
    call, then a warm one, timed), its WBC on the card; then the same
    ensembler state consolidated on the card, with the device formulation on
    the CPU and on the host (the host library, float64). On the card the
    model-level NMS of every stream is one launch of #7, elsewhere the host
    library's; it is timed again on both, beside the NumPy loop, on the
    same candidates. Returns the launches of the warm calls and the
    ensemblers."""
    from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from nndetection_tpu_torch.ops import LAUNCHES, native

    if not native.available():
        raise AssertionError("consolidate: the host library did not load")
    cfg = luna_cfg(patch)
    params = RetinaUNet(cfg, torch.Generator().manual_seed(0)).state_dict()
    case = np.random.RandomState(5).standard_normal((1, *shape)).astype(np.float32)
    cpu = torch.device("cpu")
    launches, ensemblers = {}, {}
    for name in names:
        predictor = Predictor([ModelBundle(cfg=cfg, params=params, name="luna")], tta=tta,
                              ensembler=name, device=device)
        predictor.predict_case(case)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        native.NATIVE_CALLS.clear()
        t0 = time.perf_counter()
        res = predictor.predict_case(case)
        torch.cuda.synchronize()
        case_s = time.perf_counter() - t0
        native_calls = dict(native.NATIVE_CALLS)
        for k, v in LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        ens = ensemblers[name] = res["ensembler"]
        _check_detections(f"consolidate {name}", res, shape)
        card, t_card = _consolidate(ens, device, "auto")
        _, t_card_ens = _consolidate(ens, device, "auto", fresh=False)
        dev_cpu, t_cpu = _consolidate(ens, cpu, True)
        host, t_host = _consolidate(ens, cpu, False)
        n = len(card["pred_scores"])
        if n != len(res["pred_scores"]) or n != len(dev_cpu["pred_scores"]):
            raise AssertionError(f"consolidate {name}: {n} detections consolidated again on the "
                                 f"card, {len(res['pred_scores'])} in the case, "
                                 f"{len(dev_cpu['pred_scores'])} on the CPU")
        err = paired_max_err(f"consolidate {name}", card, dev_cpu, **TOL["wbc"])
        log(f"[consolidate] {name}, case {shape} tta={tta}: warm case {case_s:.4f} s, "
            f"{n} detections, host library calls {native_calls}; consolidation on the card "
            f"{t_card:.4f} s ({t_card_ens:.4f} s again with the model-level NMS memoized), "
            f"device formulation on the CPU {t_cpu:.4f} s (card vs CPU max abs err {err:.2e}), "
            f"host (host library, float64) {t_host:.4f} s ({len(host['pred_scores'])} "
            "detections)")
        if name == "BoxEnsemblerSelective":
            n_boxes, t_native, t_plain, t_dev = model_nms_times(ens, device)
            log(f"[consolidate] {name}: model-level NMS over {len(ens.model_results)} streams, "
                f"{n_boxes} candidates: host library {t_native:.4f} s, NumPy loop "
                f"(nms_np_plain) {t_plain:.4f} s, the same keep lists; batched on the card "
                f"{t_dev:.4f} s (median of 5), the host library's first "
                f"{ens.parameters['model_detections_per_image']}")
    missing = [k for k in CONSOLIDATE_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"consolidate: kernels never launched on the main path: {missing}")
    log(f"[consolidate] kernel launches during the warm cases: {launches}")
    return launches, ensemblers


def phase_nms_mask(device, ens, reps=10):
    """``batched_nms_mask`` (#8 and the keep-scan) over each stream's
    model-level candidates (top-k, clip, remove-small, score threshold),
    ranked by score x weight as the model-level weighted NMS ranks them: on
    the card, equal to the CPU plain version; differences from the host
    float64 ``batched_nms_np`` counted with their IoU margins."""
    from nndetection_tpu_torch.core.boxes.nms import batched_nms_mask
    from nndetection_tpu_torch.core.boxes.ops_np import batched_nms_np, box_iou_np
    from nndetection_tpu_torch.ops import LAUNCHES

    thr = ens.parameters["model_iou"]
    streams = []
    for name in ens.model_results:
        boxes, probs, labels, weights = ens.model_candidates(name)
        if len(boxes):
            streams.append((boxes.astype(np.float32), (probs * weights).astype(np.float32),
                            labels.astype(np.int64)))
    if not streams:
        raise AssertionError("nms mask: no candidates")
    LAUNCHES.clear()
    n_boxes = n_kept = 0
    margins = []
    for boxes, ranked, labels in streams:
        args = [torch.from_numpy(a) for a in (boxes, ranked, labels)] + [
            torch.ones(len(boxes), dtype=torch.bool)]
        keep = batched_nms_mask(*(a.to(device) for a in args), thr).cpu().numpy()
        want = batched_nms_mask(*args, thr).numpy()
        if not np.array_equal(keep, want):
            raise AssertionError(f"nms mask: {int((keep != want).sum())} keep flags differ "
                                 "between the card and the CPU plain version")
        host = np.zeros(len(boxes), bool)
        host[batched_nms_np(boxes, ranked, labels, thr)] = True
        n_boxes += len(boxes)
        n_kept += int(keep.sum())
        order = np.argsort(-ranked, kind="stable")
        rank = np.empty(len(order), int)
        rank[order] = np.arange(len(order))
        iou = box_iou_np(boxes, boxes)
        for j in np.nonzero(keep != host)[0]:
            before = (rank < rank[j]) & (labels == labels[j])
            margins.append(float(np.abs(iou[j, before] - thr).min()) if before.any() else float("nan"))
    launches = dict(LAUNCHES)
    missing = [k for k in NMS_MASK_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"nms mask: kernels never launched on the main path: {missing}")
    boxes, ranked, labels = streams[0]
    args = [torch.from_numpy(a).to(device) for a in (boxes, ranked, labels)] + [
        torch.ones(len(boxes), dtype=torch.bool, device=device)]
    ms = median_ms(lambda: batched_nms_mask(*args, thr), reps)
    log(f"[nms mask] {len(streams)} streams, {n_boxes} candidates, thr {thr}: keep masks on the "
        f"card equal the CPU plain version's, {n_kept} kept; {len(margins)} differ from the host "
        f"float64 batched_nms_np" + (f" (IoU margins {', '.join(f'{m:.2e}' for m in margins)})"
                                     if margins else "")
        + f"; {ms:.4f} ms per stream of {len(boxes)} on the card (sort, #8, keep-scan); "
        f"launches {launches}")
    return launches


def phase_sweep(device, n_cases=3, shape=(96, 128, 128), patch=(96, 128, 128), tta=True):
    """``BoxSweeper`` over the ensembler states of seeded LUNA-plan cases,
    with GT boxes made from the seed (jittered top detections of the case
    and a random box): on the card, then with the device formulation on the
    CPU (identical best parameters, scores within 1e-6) and on the host."""
    import tempfile
    from pathlib import Path

    import nndetection_tpu_torch.inference.ensembler as ensembler
    from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
    from nndetection_tpu_torch.inference.sweeper import BoxSweeper
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.ops.native import NATIVE_CALLS

    cfg = luna_cfg(patch)
    params = RetinaUNet(cfg, torch.Generator().manual_seed(0)).state_dict()
    predictor = Predictor([ModelBundle(cfg=cfg, params=params, name="luna")], tta=tta,
                          device=device)
    rng = np.random.RandomState(7)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        states = Path(tmp)
        for i in range(n_cases):
            res = predictor.predict_case(rng.standard_normal((1, *shape)).astype(np.float32))
            res["ensembler"].save_state(states, f"case_{i}")
            # three of the 30 best detections, jittered: hits the sweep can rank up
            pb = res["pred_boxes"][:30]
            pick = rng.choice(len(pb), min(3, len(pb)), replace=False)
            gt = np.concatenate([pb[pick] + rng.uniform(-3, 3, (len(pick), 6)),
                                 clumped_boxes(rng, 1, min(shape))])
            gt[:, [2, 3, 5]] = np.maximum(gt[:, [2, 3, 5]], gt[:, [0, 1, 4]] + 1)
            np.savez(states / f"case_{i}_boxes_gt.npz", boxes=gt.astype(np.float32),
                     classes=np.zeros(len(gt), np.int64))
        for label, dev, device_wbc in (("card", device, "auto"), ("CPU device formulation",
                                       torch.device("cpu"), True), ("host", torch.device("cpu"), False)):
            ensembler.DEVICE_WBC = device_wbc
            try:
                sweeper = BoxSweeper(["nodule"], states, states, save_dir=states / label.split()[0],
                                     device=dev)
                trials = []
                evaluate = sweeper._evaluate_params
                sweeper._evaluate_params = lambda p: trials.append(p) or evaluate(p)
                LAUNCHES.clear()
                NATIVE_CALLS.clear()
                t0 = time.perf_counter()
                plan = sweeper.run_postprocessing_sweep()
                seconds = time.perf_counter() - t0
            finally:
                ensembler.DEVICE_WBC = "auto"
            runs[label] = dict(plan=plan, seconds=seconds, trials=len(trials),
                               launches=dict(LAUNCHES), native=dict(NATIVE_CALLS))
            if not (states / label.split()[0] / "sweep_results.json").exists():
                raise AssertionError(f"sweep {label}: no sweep_results.json")
    card, cpu, host = runs["card"], runs["CPU device formulation"], runs["host"]
    missing = [k for k in CONSOLIDATE_KERNELS if card["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"sweep: kernels never launched on the card: {missing}")
    if card["plan"]["parameters"] != cpu["plan"]["parameters"]:
        raise AssertionError(f"sweep: best parameters differ, card {card['plan']['parameters']}, "
                             f"CPU {cpu['plan']['parameters']}")
    if not abs(card["plan"]["score"] - cpu["plan"]["score"]) <= 1e-6:
        raise AssertionError(f"sweep: score {card['plan']['score']} on the card, "
                             f"{cpu['plan']['score']} on the CPU")
    changed = {k: v for k, v in card["plan"]["parameters"].items()
               if v != ensembler.BoxEnsemblerSelective.get_default_parameters()[k]}
    for label, r in runs.items():
        log(f"[sweep] {label}: {r['seconds']:.3f} s per sweep, {r['trials']} trials x {n_cases} "
            f"cases, {r['seconds'] / r['trials']:.4f} s per trial, best score "
            f"{r['plan']['score']:.6f}, host library calls {r['native']}"
            + (f", launches {r['launches']}" if r["launches"] else ""))
    log(f"[sweep] best parameters identical on the card and the CPU; changed from the defaults: "
        f"{changed}; host path {'agrees' if host['plan'] == card['plan'] else 'differs'} "
        f"(score {host['plan']['score']:.6f})")
    return card["launches"]


# seg maps, card vs CPU: a voxel whose two highest averaged class
# probabilities lie closer than this may take either class, and at most this
# share of a case's voxels may differ
SEG_NEAR_TIE = 1e-4
SEG_MAX_FLIP_SHARE = 1e-3
# directory scores of the same files, card vs CPU
DEPLOY_EVAL_TOL = 1e-6


@contextlib.contextmanager
def recording_seg_ensemblers():
    """The ``SegmentationEnsembler`` of every ``predict_case`` inside, in
    order."""
    import nndetection_tpu_torch.inference.predictor as predictor_mod

    made, base = [], predictor_mod.SegmentationEnsembler

    class Recording(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    predictor_mod.SegmentationEnsembler = Recording
    try:
        yield made
    finally:
        predictor_mod.SegmentationEnsembler = base


def save_folds(model_dir, cfg, seeds, scale=None):
    """One port checkpoint per seed through ``Trainer.save_checkpoint``, as
    ``fold{k}/model_last.ckpt`` (the classifier spread by ``scale``)."""
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(cfg, TrainerConfig(batch_size=2), "cpu")
    for k, seed in enumerate(seeds):
        state = trainer.init_state(rng_seed=seed)
        if scale is not None:
            spread(state.model, scale)
        trainer.save_checkpoint(state, model_dir / f"fold{k}" / "model_last.ckpt")


def write_deploy_cases(image_dir, rng) -> dict:
    """Two preprocessed cases of the tiny model (image channel, then the
    seg channel that prediction drops): one smaller than the 32^3 patch
    (padded), one with the properties that ``restore`` reads. Returns each
    case's restored shape."""
    import pickle

    image_dir.mkdir(parents=True)
    np.savez(image_dir / "case_a.npz", data=rng.standard_normal((2, 20, 40, 28)).astype(np.float32))
    np.savez(image_dir / "case_b.npz", data=rng.standard_normal((2, 40, 36, 44)).astype(np.float32))
    props = {"transpose_forward": [2, 0, 1], "original_spacing": np.asarray([0.7, 0.8, 2.5]),
             "spacing_after_resampling": np.asarray([1.0, 1.2, 0.9]),
             "crop_bbox": [[3, 31], [5, 45], [0, 40]], "shape_after_crop": (28, 40, 40),
             "shape_before_crop": (34, 50, 46)}
    with open(image_dir / "case_b.pkl", "wb") as f:
        pickle.dump(props, f)
    return {"case_a": (20, 40, 28), "case_b": props["shape_before_crop"]}


def read_prediction(out_dir, cid):
    import pickle

    with open(out_dir / f"{cid}_boxes.pkl", "rb") as f:
        boxes = pickle.load(f)
    with np.load(out_dir / f"{cid}_seg.npz") as f:
        return boxes, f["seg"]


def seg_flips(card, cpu) -> tuple:
    """Voxels where two ``SegmentationEnsembler`` of one case take other
    classes, and how many of those are not near-ties of the CPU's averaged
    probabilities."""
    norm = cpu.accum / torch.clamp(cpu.weight[None], min=1e-8)
    top2 = torch.topk(norm, 2, dim=0).values
    near = (top2[0] - top2[1]).numpy() < SEG_NEAR_TIE
    differ = card.get_case_result() != cpu.get_case_result()
    return int(differ.sum()), int((differ & ~near).sum())


def canonical_copy(src, dst):
    """``src``'s predictions as sets: each ``{case}_boxes.pkl`` with its
    scores rounded to 1e-4 and its rows in one order (score, then box), the
    seg maps as they are. AP ranks detections by score, and with 16 streams
    of saturated scores the cluster scores fall on multiples of 1/16: a
    float32 ulp between the card's forward and the CPU's splits such a tie
    group or reorders it, and moves AP by tenths. Equal sets of detections
    must score equally."""
    import pickle
    import shutil

    from nndetection_tpu_torch.utils.io import save_pickle

    dst.mkdir()
    for p in src.glob("*_boxes.pkl"):
        with open(p, "rb") as f:
            r = pickle.load(f)
        scores = np.round(np.asarray(r["pred_scores"], np.float64), 4)
        boxes = np.asarray(r["pred_boxes"], np.float64)
        order = np.lexsort((*np.round(boxes, 2).T[::-1], -scores))
        save_pickle({"pred_boxes": boxes[order], "pred_scores": scores[order],
                     "pred_labels": np.asarray(r["pred_labels"])[order]}, dst / p.name)
    for p in src.glob("*_seg.npz"):
        shutil.copy(p, dst / p.name)
    return dst


def same_scores(label, got, want, tol=DEPLOY_EVAL_TOL) -> float:
    if set(got) != set(want):
        raise AssertionError(f"{label}: other metric keys on the card and the CPU")
    worst = 0.0
    for k in got:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if not (np.array_equal(np.isnan(a), np.isnan(b)) and
                np.all(np.abs(a - b)[~np.isnan(b)] <= tol)):
            raise AssertionError(f"{label} {k}: {a} on the card, {b} on the CPU")
        worst = max([worst, *np.abs(a - b)[~np.isnan(b)].ravel().tolist()])
    return worst


def phase_deploy_tiny(device) -> None:
    """Checkpoints on disk to evaluation with the tiny float32 model, on the
    card and on the CPU (TF32 off): two folds saved by the trainer, loaded by
    ``load_all_models``, ``predict_dir`` with TTA, segmentation, restore and
    the ensembler states, then the three directory evaluations."""
    import tempfile
    from pathlib import Path

    from nndetection_tpu_torch.evaluator.registry import (
        evaluate_box_dir, evaluate_case_dir, evaluate_seg_dir)
    from nndetection_tpu_torch.inference.loading import load_all_models
    from nndetection_tpu_torch.pipeline import predict_dir

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(11)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shapes = write_deploy_cases(tmp / "images", rng)
        save_folds(tmp / "models", tiny_cfg(), seeds=(0, 1), scale=100.0)
        bundles = load_all_models(tmp / "models")
        if [b.name for b in bundles] != ["fold0", "fold1"]:
            raise AssertionError(f"deploy: loaded {[b.name for b in bundles]}")
        ens, seconds = {}, {}
        for label, dev in (("card", device), ("cpu", torch.device("cpu"))):
            with recording_seg_ensemblers() as made:
                t0 = time.perf_counter()
                predict_dir(bundles, tmp / "images", tmp / label, tta=True, predict_seg=True,
                            restore=True, save_state=True, device=dev)
                seconds[label] = time.perf_counter() - t0
            ens[label] = made
        names = {label: sorted(p.name for p in (tmp / label).iterdir()) for label in ens}
        if names["card"] != names["cpu"] or len(names["card"]) != 3 * len(shapes):
            raise AssertionError(f"deploy: files {names}")
        box_err, flips = 0.0, []
        gt = tmp / "gt"
        gt.mkdir()
        for cid, shape in shapes.items():
            (got, got_seg), (want, want_seg) = (read_prediction(tmp / label, cid)
                                                for label in ("card", "cpu"))
            for r in (got, want):
                if not len(r["pred_scores"]) or not np.isfinite(r["pred_boxes"]).all():
                    raise AssertionError(f"deploy {cid}: no detections, or non-finite ones")
            box_err = max(box_err, paired_max_err(f"deploy {cid}", got, want, **TOL["case_f32"]))
            if got_seg.shape != tuple(shape) or want_seg.shape != tuple(shape):
                raise AssertionError(f"deploy {cid}: seg {got_seg.shape} / {want_seg.shape}, "
                                     f"want {shape}")
            share = float((got_seg != want_seg).mean())
            if share > SEG_MAX_FLIP_SHARE:
                raise AssertionError(f"deploy {cid}: {share:.2e} of the seg voxels differ")
            flips.append(int((got_seg != want_seg).sum()))
            # ground truth: jittered top detections in the first case, none
            # in the second; the CPU's map with 10 % of the voxels flipped
            pick = want["pred_boxes"][:3] if cid == "case_a" else np.zeros((0, 6))
            np.savez(gt / f"{cid}_boxes_gt.npz",
                     boxes=(pick + rng.uniform(-2, 2, pick.shape)).astype(np.float32),
                     classes=np.zeros(len(pick), np.int64))
            noise = rng.rand(*want_seg.shape) < 0.1
            np.savez_compressed(gt / f"{cid}_seg_gt.npz",
                                seg=np.where(noise, 1 - want_seg, want_seg).astype(np.int16))
        ens_flips = [seg_flips(c, p) for c, p in zip(ens["card"], ens["cpu"])]
        if len(ens_flips) != len(shapes) or any(bad for _, bad in ens_flips):
            raise AssertionError(f"deploy: seg voxels that differ away from a near-tie {ens_flips}")
        scores = {}
        for label in ("card", "cpu"):
            out = canonical_copy(tmp / label, tmp / f"{label}_canonical")
            scores[label] = {
                "box": evaluate_box_dir(out, gt, ["c"], save_dir=out / "eval")[0],
                "case": evaluate_case_dir(out, gt, ["c"], save_dir=out / "eval"),
                "seg": evaluate_seg_dir(out, gt, save_dir=out / "eval")}
        eval_err = max(same_scores(f"deploy {k}", scores["card"][k], scores["cpu"][k])
                       for k in scores["card"])
    s = scores["card"]
    log(f"[deploy] tiny float32, 2 folds from disk x 8 flips, cases {list(shapes.values())} "
        f"(restored shapes): predict_dir {seconds['card']:.3f} s on the card, "
        f"{seconds['cpu']:.3f} s on the CPU; boxes card vs CPU max abs err {box_err:.2e}; seg "
        f"voxels that differ {flips} (in the ensemblers {[n for n, _ in ens_flips]}, all "
        f"near-ties < {SEG_NEAR_TIE}); scores equal within {eval_err:.1e}: "
        f"mAP {s['box']['mAP_IoU_0.10_0.50_0.05_MaxDet_100']:.4f}, case AUROC "
        f"{s['case']['case_auroc']:.4f}, seg dice {s['seg']['seg_dice_fg_mean']:.4f}")


def phase_deploy_luna(device, shape=(96, 256, 256), folds=2) -> dict:
    """The LUNA plan at full width from disk: ``folds`` seeded random models
    saved by the trainer and loaded by ``load_all_models``, one case through
    ``predict_dir`` with 8 flips, segmentation and ``BoxEnsemblerSelective``,
    twice (first, warm). Returns the launches of both calls."""
    import tempfile
    from pathlib import Path

    from nndetection_tpu_torch.inference.ensembler import BoxEnsemblerSelective
    from nndetection_tpu_torch.inference.loading import load_all_models
    from nndetection_tpu_torch.inference.predictor import Predictor
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.ops.native import NATIVE_CALLS
    from nndetection_tpu_torch.pipeline import predict_dir

    cfg = luna_cfg()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_folds(tmp / "models", cfg, seeds=range(folds))
        t0 = time.perf_counter()
        bundles = load_all_models(tmp / "models")
        t_load = time.perf_counter() - t0
        (tmp / "images").mkdir()
        case = np.random.RandomState(12).standard_normal((2, *shape)).astype(np.float32)
        np.savez(tmp / "images" / "luna_0.npz", data=case)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        NATIVE_CALLS.clear()
        seconds, case_seconds = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            predict_dir(bundles, tmp / "images", tmp / "out", tta=True, predict_seg=True,
                        save_state=True, ensembler="BoxEnsemblerSelective", device=device)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            boxes, seg = read_prediction(tmp / "out", "luna_0")
            case_seconds.append(boxes["prediction_time_s"])
        launches, native_calls = dict(LAUNCHES), dict(NATIVE_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        missing = [k for k in SERVE_KERNELS if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"deploy: kernels never launched on the main path: {missing}")
        if native_calls.get("nms_3d", 0) == 0:
            raise AssertionError(f"deploy: the model-level NMS never ran in the host library "
                                 f"({native_calls})")
        _check_detections("deploy luna", boxes, shape)
        if seg.shape != shape or seg.dtype != np.int16 or not set(np.unique(seg)) <= {0, 1}:
            raise AssertionError(f"deploy luna: seg {seg.shape} {seg.dtype} {np.unique(seg)}")
        ens = BoxEnsemblerSelective.from_checkpoint(tmp / "out" / "luna_0_boxes_state.pkl",
                                                    device=device)
        again, t_cons = _consolidate(ens, device, "auto")
        if len(again["pred_scores"]) != len(boxes["pred_scores"]):
            raise AssertionError("deploy luna: the saved state consolidates to other detections")
        # where a warm case goes: the predictor's set-up (models to the card),
        # predict_case without and with the segmentation; the rest of
        # predict_dir is file IO on the host
        split = {}
        for seg_on in (False, True):
            t0 = time.perf_counter()
            predictor = Predictor(bundles, tta=True, predict_seg=seg_on, device=device)
            torch.cuda.synchronize()
            split["set-up"] = time.perf_counter() - t0
            predictor.predict_case(case[:-1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.predict_case(case[:-1])
            torch.cuda.synchronize()
            split["seg" if seg_on else "boxes only"] = time.perf_counter() - t0
    log(f"[deploy] LUNA plan {folds} folds from disk (load {t_load:.2f} s), case {shape}, 8 flips, "
        f"seg, BoxEnsemblerSelective: predict_dir first {seconds[0]:.4f} s, warm {seconds[1]:.4f} s "
        f"(predict_case {case_seconds[0]:.4f} / {case_seconds[1]:.4f} s); consolidation of the "
        f"saved state on the card {t_cons:.4f} s; {len(boxes['pred_scores'])} detections, seg "
        f"foreground {float((seg > 0).mean()):.4f}; peak device memory {peak:.2f} GiB; warm "
        f"predict_case without the segmentation {split['boxes only']:.4f} s, with it "
        f"{split['seg']:.4f} s, Predictor set-up {split['set-up']:.4f} s")
    log(f"[deploy] kernel launches during the two calls: {launches}; host library calls "
        f"{native_calls}")
    return launches


def phase_deploy(device) -> dict:
    phase_deploy_tiny(device)
    return phase_deploy_luna(device)


def phase_serve_fused(device, cases=(((140, 320, 320), False),), patch=(96, 128, 128)):
    """``phase_serve`` under ``NNDET_CONV_FUSED=1``: #5 on every fused layer
    of every forward, beside the unfused kernels on the other layers."""
    with conv_fused():
        launches, forwards = phase_serve(device, cases, patch, "serve fused",
                                         SERVE_KERNELS + ("conv3d_in_stats",))
    want = FUSED_PER_FORWARD * forwards
    if launches["conv3d_in_stats"] != want:
        raise AssertionError(f"serve fused: {launches['conv3d_in_stats']} conv3d_in_stats "
                             f"launches, want {FUSED_PER_FORWARD} x {forwards} forwards")
    return launches


def phase_train(device, patch=(96, 128, 128), batch=8, warmup=2, steps=5,
                profile_dir=None, label="train", required=TRAIN_KERNELS, cfg=None) -> dict:
    """``Trainer.train_epoch`` on the LUNA plan (or ``cfg``): ``warmup``
    steps, then ``steps`` timed ones; the launch counts cover both."""
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = cfg or luna_cfg(patch)
    trainer = Trainer(cfg, TrainerConfig(batch_size=batch, warm_iterations=10), device)
    state = trainer.init_state(rng_seed=0)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    targets = train_targets(device, batch, cfg.patch_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, m_warm = trainer.train_epoch(state, [targets] * warmup, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, m = trainer.train_epoch(state, [targets] * steps, 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    missing = [k for k in required if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")
    for metrics in (m_warm, m):
        bad = [k for k, v in metrics.items() if k.startswith("train_") and not np.isfinite(v)]
        if bad or metrics["train_nonfinite_steps"]:
            raise AssertionError(f"{label}: non-finite losses {bad}")
    if not m["train_num_pos"] > 0:
        raise AssertionError(f"{label}: no positive anchor matched")
    changed = sum(not torch.equal(p, before[n]) for n, p in state.model.named_parameters())
    if changed == 0:
        raise AssertionError(f"{label}: no parameter changed")
    log(f"[{label}] LUNA plan patch {cfg.patch_size} batch {batch} {cfg.dtype} remat={cfg.remat}"
        f"{', deep supervision' if cfg.segmenter_deep_supervision else ''}: "
        f"first {warmup} steps {t1 - t0:.2f} s; {steps} steps {seconds:.3f} s = "
        f"{seconds / steps:.4f} s/step, {steps * batch / seconds:.2f} patches/s; "
        f"peak device memory {peak:.2f} GiB; losses "
        + ", ".join(f"{k} {m['train_' + k]:.4f}" for k in ("cls", "reg", "seg_ce", "seg_dice", "total"))
        + f"; num_pos {m['train_num_pos']:.1f} num_neg {m['train_num_neg']:.1f} per step; "
        f"{changed}/{len(before)} parameter tensors changed")
    log(f"[{label}] kernel launches during {label}: {launches}")
    if profile_dir is not None:
        profile_train_step(trainer, state, targets, profile_dir, label)
    return dict(launches=launches, steps=warmup + steps, remat=cfg.remat,
                s_per_step=seconds / steps, patches_per_s=steps * batch / seconds, peak_gib=peak)


def phase_train_fused(device, unfused, **kwargs) -> dict:
    """``phase_train`` under ``NNDET_CONV_FUSED=1``: #5 on every fused layer,
    twice per step with remat (the encoder runs again in the backward)."""
    with conv_fused():
        r = phase_train(device, label="train fused",
                        required=TRAIN_KERNELS + ("conv3d_in_stats",), **kwargs)
    want = FUSED_PER_FORWARD * (2 if r["remat"] else 1) * r["steps"]
    if r["launches"]["conv3d_in_stats"] != want:
        raise AssertionError(f"train fused: {r['launches']['conv3d_in_stats']} conv3d_in_stats "
                             f"launches in {r['steps']} steps, want {want}")
    if unfused is not None:
        log(f"[train fused] against the default configuration in this run: "
            f"{r['s_per_step']:.4f} vs {unfused['s_per_step']:.4f} s/step, "
            f"{r['patches_per_s']:.2f} vs {unfused['patches_per_s']:.2f} patches/s, "
            f"peak {r['peak_gib']:.2f} vs {unfused['peak_gib']:.2f} GiB")
    return r


# the fed training phase: preprocessed cases of the LUNA plan's scale on
# disk, loaded, prefetched, augmented on the card
TRAIN_AUG_CASE_SHAPE = (224, 288, 288)
AUG_CARD_CPU_ATOL = 1e-4  # images, float32 compute on both
SEG_ROUNDING_MARGIN = 1e-4  # a source coordinate this near a half is a near-tie


def write_train_cases(image_dir, n_cases=4, shape=TRAIN_AUG_CASE_SHAPE, seed=0):
    """``n_cases`` seeded preprocessed cases in the loader's format:
    ``{case}.npy`` float32 ``[2, *shape]`` (a noise image with brighter
    ellipsoids, then the instance ids) and ``{case}_boxes.pkl``; 2-4
    ellipsoid instances a case, of classes 0 and 1 in turn. Returns the
    case ids."""
    from nndetection_tpu_torch.utils.io import save_pickle

    rng = np.random.default_rng(seed)
    image_dir.mkdir(parents=True, exist_ok=True)
    ids = []
    for c in range(n_cases):
        arr = np.empty((2, *shape), np.float32)
        arr[0] = rng.standard_normal(shape, dtype=np.float32)
        arr[1] = 0.0
        boxes, classes = [], []
        n_inst = int(rng.integers(2, 5))
        for iid in range(1, n_inst + 1):
            radius = rng.uniform(4.0, 14.0, 3)
            centre = rng.uniform(radius + 2, np.asarray(shape) - radius - 2)
            lo = np.floor(centre - radius).astype(int)
            hi = np.ceil(centre + radius).astype(int) + 1
            grid = np.meshgrid(*[np.arange(a, b) for a, b in zip(lo, hi)], indexing="ij")
            inside = sum(((g - m) / r) ** 2 for g, m, r in zip(grid, centre, radius)) <= 1.0
            box = tuple(slice(a, b) for a, b in zip(lo, hi))
            arr[1][box][inside] = iid
            arr[0][box][inside] += 2.0
            where = np.nonzero(inside)
            b_lo = [int(w.min()) + a for w, a in zip(where, lo)]
            b_hi = [int(w.max()) + a + 1 for w, a in zip(where, lo)]
            boxes.append([b_lo[0], b_lo[1], b_hi[0], b_hi[1], b_lo[2], b_hi[2]])
            classes.append((iid - 1) % 2)
        cid = f"case_{c:03d}"
        np.save(image_dir / f"{cid}.npy", arr)
        save_pickle({"boxes": np.asarray(boxes, np.float32),
                     "classes": np.asarray(classes, np.int64),
                     "instance_ids": np.arange(1, n_inst + 1, dtype=np.int64)},
                    image_dir / f"{cid}_boxes.pkl")
        ids.append(cid)
    return ids


def busy_share(fn) -> tuple:
    """``fn()`` under ``torch.profiler``: its wall seconds and the seconds
    the card was busy (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, busy_us / 1e6


def flip_like(mask, params, cfg):
    """``mask [B, *patch]`` mirrored per sample as ``apply_augment`` mirrors
    the segmentation."""
    b, dim = mask.shape[0], mask.dim() - 1
    for ax in cfg.mirror_axes:
        if ax < dim:
            flip = params.flips[:, ax].view((b,) + (1,) * dim)
            mask = torch.where(flip, mask.flip(ax + 1), mask)
    return mask


def augment_card_vs_cpu(device, raw, cfg, seed=123) -> dict:
    """One batch's draws made on the card, copied to the CPU, and
    ``apply_augment`` on both devices from the same generator-patch batch:
    images within ``AUG_CARD_CPU_ATOL``, seg equal but at voxels whose
    source coordinate lies within ``SEG_ROUNDING_MARGIN`` of a half."""
    from nndetection_tpu_torch.data.augment import (
        apply_augment,
        augment_coords,
        sample_augment_params,
    )

    images, seg = raw["images"], raw["seg_instances"]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = sample_augment_params(cfg, images.shape[0], images.shape[-1], gen, device)
    x_card, s_card = apply_augment(images.to(device), seg.to(device), params, cfg)
    cpu = params.to("cpu")
    t0 = time.perf_counter()
    x_cpu, s_cpu = apply_augment(images, seg, cpu, cfg)
    cpu_s = time.perf_counter() - t0
    err = check_close("train_aug card vs CPU images", x_card.cpu(), x_cpu, 0.0, AUG_CARD_CPU_ATOL)
    coords = augment_coords(cpu, tuple(seg.shape[1:]), cfg)
    frac = coords.abs() - coords.abs().floor()
    near = flip_like(((frac - 0.5).abs() < SEG_ROUNDING_MARGIN).any(1), cpu, cfg)
    halves = flip_like((frac == 0.5).any(1), cpu, cfg)
    differ = s_card.cpu() != s_cpu
    bad = int((differ & ~near).sum())
    if bad:
        raise AssertionError(f"train_aug card vs CPU: {bad} seg voxels differ away from a "
                             f"rounding boundary")
    fired = {k: int(getattr(cpu, k).sum()) for k in ("do_rotation", "do_scale", "do_lowres",
                                                      "do_noise", "do_blur", "do_gamma")}
    return dict(max_abs_err=err, seg_differ=int(differ.sum()), near=int(near.sum()),
                halves=int(halves.sum()), voxels=s_cpu.numel(), fired=fired, cpu_s=cpu_s)


def fed_run(label, trainer, train_loader, val_loader, warmup, steps, val_batches, classes):
    """A fresh state from seed 0: ``warmup`` fed steps, then ``fit`` over one
    epoch of ``steps`` fed steps and ``val_batches`` validation batches with
    ``BoxEvaluator``, both sides through ``PrefetchIterator``; then
    ``steps`` more fed steps under ``torch.profiler`` for the idle share.
    The launch counts and the peak memory cover the warm-up and the fit."""
    from nndetection_tpu_torch.data.loader import PrefetchIterator
    from nndetection_tpu_torch.evaluator.det import BoxEvaluator
    from nndetection_tpu_torch.ops import LAUNCHES

    state = trainer.init_state(rng_seed=0)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, m_warm = trainer.train_epoch(
        state, PrefetchIterator(train_loader.epoch(warmup), depth=2), 0)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    logs = []
    state = trainer.fit(
        train_iter_fn=lambda e: PrefetchIterator(train_loader.epoch(steps), depth=2),
        val_iter_fn=lambda e: PrefetchIterator(val_loader.epoch(val_batches), depth=2),
        evaluator_fn=lambda: BoxEvaluator.create(classes),
        log_fn=lambda e, m: logs.append(m), state=state)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (trainer.output_dir / "model_last.ckpt").exists():
        raise AssertionError(f"{label}: fit wrote no model_last.ckpt")
    wall, busy = busy_share(lambda: trainer.train_epoch(
        state, PrefetchIterator(train_loader.epoch(steps), depth=2), 1))

    missing = [k for k in TRAIN_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")
    (m,) = logs
    for metrics in (m_warm, m):
        bad = [k for k, v in metrics.items()
               if k.startswith(("train_", "val_")) and not np.isfinite(v)]
        if bad or metrics["train_nonfinite_steps"]:
            raise AssertionError(f"{label}: non-finite losses {bad}")
    changed = sum(not torch.equal(p, before[n]) for n, p in state.model.named_parameters())
    if changed == 0:
        raise AssertionError(f"{label}: no parameter changed")
    s_per_step = m["epoch_time_s"] / m["steps"]
    return dict(launches=launches, s_per_step=s_per_step,
                patches_per_s=train_loader.batch_size / s_per_step, peak_train=peak_train,
                peak_gib=peak, t_warm=t_warm, m=m, wall=wall, busy=busy,
                idle=1 - busy / wall, changed=changed, tensors=len(before))


def fed_line(r) -> str:
    m = r["m"]
    return (f"first fed steps {r['t_warm']:.2f} s; {m['steps']} fed steps "
            f"{m['epoch_time_s']:.3f} s = {r['s_per_step']:.4f} s/step, "
            f"{r['patches_per_s']:.2f} patches/s; idle share {100 * r['idle']:.1f} % over "
            f"{m['steps']} profiled fed steps (wall {r['wall']:.3f} s, card busy "
            f"{r['busy']:.3f} s); peak device memory {r['peak_train']:.2f} GiB over the "
            f"warm-up, {r['peak_gib']:.2f} GiB with the fit; losses "
            + ", ".join(f"{k} {m['train_' + k]:.4f}" for k in ("cls", "reg", "seg_ce", "seg_dice"))
            + f"; num_pos {m['train_num_pos']:.1f}; val cls {m['val_cls']:.4f}; "
            f"{r['changed']}/{r['tensors']} parameter tensors changed")


def pool_costs(device, pool) -> dict:
    """The pool's own costs, after its fed runs: host ms of one
    ``generate_batch`` (the draws and the cut's launches, no sync), the
    card ms of the cut (CUDA events) beside its bytes bound (the batch read
    once and written once)."""
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = pool.generate_batch()
        host.append(1e3 * (time.perf_counter() - t0))
    rng = np.random.RandomState(5)
    idx = rng.randint(len(pool._pool_slots), size=pool.batch_size).tolist()
    hi = np.asarray(pool.max_shape) - np.asarray(pool.patch_size)
    origins = np.stack([rng.randint(0, h + 1, pool.batch_size) for h in hi], 1)
    cut_ms = median_ms(lambda: pool.gather(idx, origins), reps=10, warmup=2)
    batch_bytes = nbytes(raw["images"], raw["seg_instances"])
    return dict(host_ms=statistics.median(host), host_all=host, cut_ms=cut_ms,
                batch_mib=batch_bytes / 2 ** 20,
                cut_bound_ms=bound(2 * batch_bytes, 0, 1.0)["bound_ms"])


def phase_train_aug(device, prepared=None, shape=TRAIN_AUG_CASE_SHAPE, n_cases=4, batch=8,
                    warmup=2, steps=6, val_batches=2) -> dict:
    """The body of the JAX ``run_train`` after the plan, on the LUNA plan at
    batch 8: seeded cases on disk, ``make_splits`` and ``build_loaders``
    (fold 0, ``base_more``), then ``Trainer(augment_cfg=...)`` fed twice in
    this call (:func:`fed_run`): by the host loader (``device_pool=False``)
    and by the device patch pool (the default on the card). ``prepared``:
    the prepared-batch train phase of this run. Returns the pool run's
    launch counts."""
    import dataclasses
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace

    from nndetection_tpu_torch.data.aug_presets import get_augmentation
    from nndetection_tpu_torch.data.augment import augment_batch
    from nndetection_tpu_torch.data.loader import DevicePatchPool, PatchLoader
    from nndetection_tpu_torch.pipeline import build_loaders, make_splits
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(luna_cfg(), classifier_classes=2, seg_classes=2)
    plan = SimpleNamespace(patch_size=cfg.patch_size, max_instances_per_patch=32, in_channels=1)
    aug = get_augmentation("base_more", cfg.patch_size)
    tcfg = TrainerConfig(batch_size=batch, warm_iterations=10, max_epochs=1,
                         num_train_batches_per_epoch=steps,
                         num_val_batches_per_epoch=val_batches, swa_epochs=0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        ids = write_train_cases(tmp / "imagesTr", n_cases, shape)
        t_write = time.perf_counter() - t0
        splits = make_splits(ids, tmp / "splits_final.pkl")
        train_loader, val_loader = build_loaders(plan, tmp / "imagesTr", splits, 0, batch,
                                                 aug_cfg=aug, device_pool=False, device=device)
        if type(train_loader) is not PatchLoader:
            raise AssertionError(f"train_aug: device_pool=False gave {type(train_loader)}")
        # the host's and the copy's costs, on a twin of the train loader (the
        # fit's sequence stays untouched)
        twin = PatchLoader(train_loader.records, train_loader.patch_size, batch,
                           max_instances=plan.max_instances_per_patch, seed=99,
                           inner_patch_size=cfg.patch_size, pin_memory=train_loader.pin_memory)
        host = {}
        for pin in (False, twin.pin_memory):
            twin.pin_memory, host[pin] = pin, []
            for _ in range(3):
                t0 = time.perf_counter()
                raw = twin.generate_batch()
                host[pin].append(1e3 * (time.perf_counter() - t0))
        batch_mib = sum(v.numel() * v.element_size() for v in raw.values()) / 2 ** 20
        h2d_ms = median_ms(lambda: {k: v.to(device, non_blocking=True) for k, v in raw.items()},
                           reps=5, warmup=1)
        images, seg = raw["images"].to(device), raw["seg_instances"].to(device)
        gen = torch.Generator(device=device).manual_seed(7)
        aug_ms = median_ms(lambda: augment_batch(gen, images, seg, aug), reps=5, warmup=2)
        del images, seg
        check = augment_card_vs_cpu(device, raw, aug)

        trainer = Trainer(cfg, tcfg, device, output_dir=tmp / "fold0_host", augment_cfg=aug)
        hosted = fed_run("train_aug host loader", trainer, train_loader, val_loader, warmup,
                         steps, val_batches, ["c0", "c1"])
        del train_loader

        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pool, val_loader = build_loaders(plan, tmp / "imagesTr", splits, 0, batch, aug_cfg=aug,
                                         device=device)
        torch.cuda.synchronize()
        t_fill = time.perf_counter() - t0
        if type(pool) is not DevicePatchPool or pool.device != torch.device(device):
            raise AssertionError(f"train_aug: build_loaders on the card gave {type(pool)}")
        pool_mem = torch.cuda.memory_allocated() - base_mem
        trainer = Trainer(cfg, tcfg, device, output_dir=tmp / "fold0_pool", augment_cfg=aug)
        pooled = fed_run("train_aug device pool", trainer, pool, val_loader, warmup, steps,
                         val_batches, ["c0", "c1"])
        costs = pool_costs(device, pool)
        report = pool.sampling_report()

    beside = ("" if prepared is None else
              f"; prepared batches in this run: {prepared['s_per_step']:.4f} s/step, "
              f"{prepared['patches_per_s']:.2f} patches/s")
    log(f"[train_aug] LUNA plan patch {cfg.patch_size} batch {batch} {cfg.dtype} remat={cfg.remat}, "
        f"2 classes, base_more, generator patch {pool.patch_size}; {n_cases} cases "
        f"{shape} written in {t_write:.2f} s ({len(pool.records)} train, "
        f"{len(val_loader.records)} val)")
    log(f"[train_aug] host loader (device_pool=False): {fed_line(hosted)}")
    log(f"[train_aug] device pool: {fed_line(pooled)}")
    log(f"[train_aug] fed s/step in this run: device pool {pooled['s_per_step']:.4f} "
        f"({pooled['patches_per_s']:.2f} patches/s, idle {100 * pooled['idle']:.1f} %), host "
        f"loader {hosted['s_per_step']:.4f} ({hosted['patches_per_s']:.2f} patches/s, idle "
        f"{100 * hosted['idle']:.1f} %){beside}")
    log(f"[train_aug] pool: {len(pool._pool_slots)} cases of max_shape {pool.max_shape}, "
        f"pool_bytes {pool.pool_bytes()} ({pool.pool_bytes() / 2 ** 20:.1f} MiB; "
        f"{pool_mem / 2 ** 20:.1f} MiB allocated), filled in {t_fill:.3f} s with the val "
        f"loader; generate_batch on the host {costs['host_ms']:.3f} ms (median of 5: "
        + ", ".join(f"{t:.3f}" for t in costs["host_all"])
        + f"); the cut on the card {costs['cut_ms']:.4f} ms for {costs['batch_mib']:.1f} MiB "
        f"(bound {costs['cut_bound_ms']:.4f} ms, bytes read and written once); report {report}")
    log(f"[train_aug] host loader costs: generate_batch, median of 3 ({batch_mib:.1f} MiB a "
        "batch): "
        + "; ".join(f"pinned {pin}: {statistics.median(v):.1f} ms ("
                    + ", ".join(f"{t:.1f}" for t in v) + ")" for pin, v in host.items())
        + f"; host -> card {h2d_ms:.3f} ms per batch (pinned {twin.pin_memory}); "
        f"augment_batch {aug_ms:.3f} ms per batch on the card")
    log(f"[train_aug] card vs CPU augmentation (the card's draws): images max abs err "
        f"{check['max_abs_err']:.2e} (atol {AUG_CARD_CPU_ATOL}); seg voxels that differ "
        f"{check['seg_differ']} of {check['voxels']} (allowed within {SEG_ROUNDING_MARGIN} of "
        f"a half: {check['near']} voxels sample there, {check['halves']} of them at exact "
        f"halves); transforms fired {check['fired']}; "
        f"apply_augment on the CPU {check['cpu_s']:.2f} s")
    log(f"[train_aug] kernel launches: host loader {hosted['launches']}; device pool "
        f"{pooled['launches']}")
    return dict(launches=pooled["launches"], s_per_step=pooled["s_per_step"],
                patches_per_s=pooled["patches_per_s"], peak_gib=pooled["peak_gib"],
                host=hosted, pool=pooled, pool_costs=costs)


# the run_train phase: a task directory as the JAX package's run_prep leaves
# it, trained through the port's entry point
RUN_TRAIN_CASES = 8
RUN_TRAIN_KERNELS = TRAIN_KERNELS + ("nms_topk",)


def luna_plan(batch=8):
    """The port's ``Plan`` of the LUNA plan of :func:`luna_cfg` (two
    classes, 32 GT slots a patch, remat)."""
    from nndetection_tpu_torch.planning.planner import Plan

    cfg = luna_cfg()
    anchors = {k: [list(a) for a in getattr(cfg, f"anchor_{k}")]
               for k in ("width", "height", "depth")}
    return Plan(
        plan_id="D3V001_3d", dim=3, target_spacing=[1.0, 1.0, 1.0], transpose_forward=[0, 1, 2],
        normalization_schemes=["CT"], intensity_properties={}, use_nonzero_mask=False,
        patch_size=list(cfg.patch_size), batch_size=batch,
        conv_kernels=[list(k) for k in cfg.conv_kernels],
        pool_strides=[list(s) for s in cfg.strides], decoder_levels=tuple(cfg.decoder_levels),
        anchors=anchors, in_channels=1, num_classes=2, seg_classes=2,
        start_channels=cfg.start_channels, max_channels=cfg.max_channels,
        fpn_channels=cfg.fpn_channels, head_channels=cfg.head_channels,
        max_instances_per_patch=32, remat=True)


def write_task(task_dir, n_cases=RUN_TRAIN_CASES, shape=TRAIN_AUG_CASE_SHAPE) -> None:
    """A task directory as ``run_prep`` leaves it: ``dataset.yaml`` (two
    labels), ``preprocessed/D3V001_3d.pkl`` and the seeded cases under
    ``preprocessed/D3V001_3d/imagesTr`` as ``.npz`` (``data``), ``.npy``
    and ``_boxes.pkl``."""
    from nndetection_tpu_torch.utils.io import save_pickle, save_yaml

    save_yaml({"task": task_dir.name, "name": "LunaPlan", "dim": 3, "target_class": None,
               "test_labels": True, "labels": {"0": "c0", "1": "c1"},
               "modalities": {"0": "CT"}}, task_dir / "dataset.yaml")
    plan = luna_plan()
    save_pickle(plan, task_dir / "preprocessed" / f"{plan.plan_id}.pkl")
    image_dir = task_dir / "preprocessed" / plan.plan_id / "imagesTr"
    for cid in write_train_cases(image_dir, n_cases, shape, seed=1):
        np.savez(image_dir / f"{cid}.npz", data=np.load(image_dir / f"{cid}.npy", mmap_mode="r"))


def run_train_once(device, task_dir, model_dir, steps, val_batches, profiled=False) -> dict:
    """``run_train`` for fold 0, one epoch of ``steps`` fed steps and
    ``val_batches`` validation batches, no SWA, with the launch counts reset
    just before; then its files, losses, parameters and launches checked."""
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from nndetection_tpu_torch.modules import RetinaUNetV001
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.pipeline import run_train
    from nndetection_tpu_torch.planning.planner import load_plan
    from nndetection_tpu_torch.train.trainer import TrainerConfig

    overrides = dict(max_epochs=1, num_train_batches_per_epoch=steps,
                     num_val_batches_per_epoch=val_batches, swa_epochs=0, warm_iterations=10)
    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    call = lambda: run_train(task_dir, model_dir, fold=0, trainer_overrides=overrides,
                             module="RetinaUNetV001", augmentation="base_more",
                             log_fn=lambda e, m: logs.append(m), device=device)
    t0 = time.perf_counter()
    if profiled:
        wall, busy = busy_share(call)
    else:
        call()
        torch.cuda.synchronize()
        wall, busy = time.perf_counter() - t0, None
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    out = model_dir / "fold0"
    missing = [f for f in ("plan.pkl", "model_last.ckpt", "metrics.jsonl", "run_meta.json",
                           "params.json") if not (out / f).exists()]
    if missing:
        raise AssertionError(f"run_train: files missing in {out}: {missing}")
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != 1 or len(logs) != 1:
        raise AssertionError(f"run_train: {len(rows)} metrics rows for one epoch")
    m = rows[0]
    bad = [k for k, v in m.items() if k.startswith(("train_", "val_")) and not np.isfinite(v)]
    if bad or m["train_nonfinite_steps"] or m["steps"] != steps:
        raise AssertionError(f"run_train: non-finite losses {bad} or {m['steps']} steps")
    not_run = [k for k in RUN_TRAIN_KERNELS if launches.get(k, 0) == 0]
    if not_run:
        raise AssertionError(f"run_train: kernels never launched on the main path: {not_run}")
    plan = load_plan(out / "plan.pkl")
    initial = RetinaUNet(RetinaUNetV001.model_config(plan),
                         generator=torch.Generator().manual_seed(TrainerConfig().seed))
    params = torch.load(out / "model_last.ckpt", map_location="cpu", weights_only=True)["params"]
    changed = sum(not torch.equal(params[n], p) for n, p in initial.state_dict().items())
    if changed == 0:
        raise AssertionError("run_train: no parameter changed")
    s_per_step = m["epoch_time_s"] / m["steps"]
    return dict(m=m, launches=launches, peak_gib=peak, wall=wall, busy=busy,
                s_per_step=s_per_step, patches_per_s=plan.batch_size / s_per_step,
                changed=changed, tensors=len(params),
                pool={k: v for k, v in m.items() if k.startswith("pool_")})


def phase_run_train(device, n_cases=RUN_TRAIN_CASES, shape=TRAIN_AUG_CASE_SHAPE, steps=6,
                    rotate_steps=16, val_batches=2) -> dict:
    """``run_train`` on a task directory of ``n_cases`` seeded LUNA-scale
    cases, fold 0, ``RetinaUNetV001`` with ``base_more``: (a) at the default
    pool budget, every train case resident; (b) with ``NNDET_POOL_BYTES`` at
    three cases, the others rotating in during the epoch (``rotate_steps``
    steps, so that each is staged), under ``torch.profiler`` for the idle
    share of the whole call. (b) must reach ``pool_coverage`` 1.0."""
    import tempfile
    from pathlib import Path

    from nndetection_tpu_torch.data.aug_presets import get_augmentation
    from nndetection_tpu_torch.data.augment import generator_patch_size_for
    import yaml
    with tempfile.TemporaryDirectory() as tmp:
        task_dir = Path(tmp) / "Task100_LunaPlan"
        t0 = time.perf_counter()
        write_task(task_dir, n_cases, shape)
        t_write = time.perf_counter() - t0
        full = run_train_once(device, task_dir, Path(tmp) / "models_a", steps, val_batches)
        # a pool slot: the case padded to the generator patch, bf16 + int16
        gen_patch = generator_patch_size_for(get_augmentation("base_more",
                                                              luna_plan().patch_size))
        case_bytes = math.prod(max(s, g) for s, g in zip(shape, gen_patch)) * (2 * 1 + 2)
        saved = os.environ.get("NNDET_POOL_BYTES")
        os.environ["NNDET_POOL_BYTES"] = str(3 * case_bytes)
        try:
            rot = run_train_once(device, task_dir, Path(tmp) / "models_b", rotate_steps,
                                 val_batches, profiled=True)
        finally:
            if saved is None:
                os.environ.pop("NNDET_POOL_BYTES", None)
            else:
                os.environ["NNDET_POOL_BYTES"] = saved
    if full["pool"].get("pool_coverage") != 1.0:
        raise AssertionError(f"run_train (a): pool report {full['pool']}")
    if rot["pool"].get("pool_cases") != 3.0 or rot["pool"].get("pool_coverage") != 1.0:
        raise AssertionError(f"run_train (b): pool report {rot['pool']}, want 3 resident "
                             "cases and coverage 1.0")
    for label, r in (("(a) every case resident", full), ("(b) 3 resident, rotating", rot)):
        m = r["m"]
        idle = ("" if r["busy"] is None else
                f"; whole call under the profiler {r['wall']:.3f} s, card busy {r['busy']:.3f} s, "
                f"idle share {100 * (1 - r['busy'] / r['wall']):.1f} % (set-up, fill, "
                "validation and checkpoints included)")
        log(f"[run_train] {label}: {m['steps']} fed steps {m['epoch_time_s']:.3f} s = "
            f"{r['s_per_step']:.4f} s/step, {r['patches_per_s']:.2f} patches/s{idle}; peak "
            f"device memory {r['peak_gib']:.2f} GiB; losses "
            + ", ".join(f"{k} {m['train_' + k]:.4f}" for k in ("cls", "reg", "seg_ce", "seg_dice"))
            + f"; val cls {m['val_cls']:.4f}; {r['changed']}/{r['tensors']} parameter tensors "
            f"changed; pool {r['pool']}")
        log(f"[run_train] {label}: kernel launches {r['launches']}")
    log(f"[run_train] task of {n_cases} cases {shape} written in {t_write:.2f} s; "
        f"dataset.yaml written and read by PyYAML {yaml.__version__}")
    return dict(launches=full["launches"], rotating=rot["launches"], full=full, rot=rot)


# the multi phase: the port's multi-process training on the one card. (a)
# run_train as a one-rank NCCL job, (b) a data-parallel step of two gloo ranks
# sharing cuda:0, (c) the spatial step where the backend carries its
# collectives on CUDA tensors
MULTI_STEP_BATCH = 4
# the spatial instance norm: LUNA stage 0 [B, D, H, W, C], D split over the
# two ranks
MULTI_NORM_SHAPE = LUNA_STAGES[0]
# its card run against its CPU run, both with the same all-reduces: the
# statistics come from other summation orders (#1's partials and Chan's
# merge against the plain sums), within in_stats' rtol of 1e-4, and reach
# y and dx through xhat (|xhat| < 6 here), so 5e-4 absolute in float32; in
# bfloat16 that moves a result by at most one bfloat16 ulp (2^-7 relative).
# The parameter gradients sum all of a rank's voxels: held at a share of
# their largest entry, as the step's gradients are (REF_STEP_TOL)
MULTI_NORM_TOL = {torch.float32: dict(y=(1e-4, 5e-4), dx=(1e-4, 5e-4), param=1e-4),
                  torch.bfloat16: dict(y=(1e-2, 1e-2), dx=(1e-2, 1e-2), param=1e-4)}
MULTI_GROUP_TIMEOUT_MIN = 5.0
MULTI_WORKER_TIMEOUT_S = 600


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(specs, env=None, timeout=MULTI_WORKER_TIMEOUT_S) -> list:
    """``python3 chip_smoke.py --multi-worker=SPEC`` for each spec, all at
    once, each with ``env[i]`` added to the environment; waits for all,
    raises with a rank's errors if it failed, and returns each one's result
    (the JSON it wrote to ``spec["out"]``)."""
    procs = []
    for i, spec in enumerate(specs):
        penv = dict(os.environ, **(env[i] if env else {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multi-worker=" + json.dumps(spec)],
            env=penv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0] + f"\n(killed after {timeout} s)")
    for p in procs:
        p.kill()
        p.wait()
    for i, (p, out) in enumerate(zip(procs, logs)):
        for line in out.splitlines():
            if line.startswith("["):
                log(f"[multi] rank {i}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"multi: rank {i} exited {p.returncode}:\n{out[-6000:]}")
    return [json.loads(open(spec["out"]).read()) for spec in specs]


def multi_worker(spec: dict) -> None:
    """One rank of the multi phase (a subprocess of the phase), writing its
    result to ``spec["out"]`` as JSON."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the multi phase's ranks run on the card only")
    out = {"run_train": _worker_run_train, "step": _worker_step,
           "spatial_norm": _worker_spatial_norm}[spec["kind"]](spec)
    with open(spec["out"], "w") as f:
        json.dump(out, f)


def _worker_run_train(spec: dict) -> dict:
    """``run_train`` under the ``NNDET_*`` contract the parent set (or none:
    one process): the process group's backend and world, the model's
    wrapper, each train step's seconds (synchronised), and
    :func:`run_train_once`'s checks (files, losses, parameters, #1-#4 and
    #7 launched)."""
    from pathlib import Path

    import torch.distributed as dist

    from nndetection_tpu_torch.train import trainer as trainer_mod

    wrappers = []
    init_state = trainer_mod.Trainer.init_state

    def recording(self, *args, **kwargs):
        state = init_state(self, *args, **kwargs)
        wrappers.append(None if state.ddp is None else type(state.ddp).__name__)
        return state

    step_s = []
    train_step = trainer_mod.Trainer.train_step

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = train_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    trainer_mod.Trainer.init_state = recording
    trainer_mod.Trainer.train_step = timed
    r = run_train_once(torch.device("cuda"), Path(spec["task"]), Path(spec["models"]),
                       spec["steps"], spec["val_batches"])
    grouped = dist.is_initialized()
    res = dict(backend=dist.get_backend() if grouped else None,
               world=dist.get_world_size() if grouped else None, wrappers=wrappers,
               step_s=step_s,
               launches=r["launches"], s_per_step=r["s_per_step"], peak_gib=r["peak_gib"],
               losses={k: r["m"][f"train_{k}"] for k in ("cls", "reg", "seg_ce", "seg_dice")})
    if grouped:
        dist.destroy_process_group()
    return res


def _worker_step(spec: dict) -> dict:
    """One train step of the tiny float32 model per head on this rank's
    rows (the whole batch on a model axis) of a seeded global batch, on the
    CPU and then on the card within one gloo group, with the sampler draws
    made on the CPU and replayed on the card, TF32 off: losses, the clipped
    gradients and the parameters after the update held at the reference
    phase's tolerances; #1-#4 launched by the card's step."""
    import dataclasses

    import torch.distributed as dist

    from nndetection_tpu_torch.core.boxes import sampler
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.parallel import distributed
    from nndetection_tpu_torch.parallel.mesh import make_mesh
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world, n_model = spec["rank"], spec["world"], spec["n_model"]
    card = torch.device(spec.get("device", "cuda"))  # "cpu" only to rehearse off the card
    distributed.initialize(f"localhost:{spec['port']}", world, rank, device=card,
                           backend="gloo", timeout_min=MULTI_GROUP_TIMEOUT_MIN)
    card = distributed.rank_device(card)
    cfg = tiny_cfg()
    params = spread(RetinaUNet(cfg, torch.Generator().manual_seed(0))).state_dict()
    tcfg = TrainerConfig(batch_size=MULTI_STEP_BATCH, warm_iterations=0, max_epochs=1,
                         num_train_batches_per_epoch=10, swa_epochs=0)
    rows = distributed.local_batch_slice(MULTI_STEP_BATCH, n_model)
    batch = {k: v[rows] for k, v in train_targets("cpu", MULTI_STEP_BATCH, cfg.patch_size,
                                                  seed=4).items()}
    draw = sampler.draw_uniform
    res = {"rows": [rows.start, rows.stop], "backend": dist.get_backend(), "heads": {}}
    card_params = {}
    for head in ("no_sampler", "hnm"):
        hcfg = dataclasses.replace(cfg, head_type=head)
        draws, runs = [], []

        def record(generator, shape, dev):
            u = draw(generator, shape, dev)
            draws.append(u.clone())
            return u

        try:
            for dev, fn in ((torch.device("cpu"), record),
                            (card, lambda g, shape, d: draws.pop(0).to(d))):
                sampler.draw_uniform = fn
                trainer = Trainer(hcfg, tcfg, dev,
                                  mesh=make_mesh(world // n_model, n_model, dev.type))
                state = trainer.init_state(params=params)
                grads = {}
                keep_grads(state, grads)
                LAUNCHES.clear()
                losses = trainer.train_step(state, trainer._to_device(batch),
                                            torch.Generator(device=dev))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                launches = dict(LAUNCHES)
                runs.append(({k: v.cpu() for k, v in losses.items()}, grads,
                             {n: p.detach().cpu() for n, p in state.model.named_parameters()},
                             launches, state.ddp is not None))
        finally:
            sampler.draw_uniform = draw
        (l_cpu, g_cpu, p_cpu, _, _), (l_dev, g_dev, p_dev, launches, wrapped) = runs
        errs = {k: check_close(f"multi {head} {k}", l_dev[k], l_cpu[k], *REF_STEP_TOL["loss"])
                for k in ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg")}
        g_err = max(check_close(f"multi {head} grad {n}", g_dev[n], g_cpu[n], 0,
                                REF_STEP_TOL["grad"] * float(g_cpu[n].abs().max()))
                    for n in g_cpu)
        p_err = max(check_close(f"multi {head} param {n}", p_dev[n], p_cpu[n],
                                *REF_STEP_TOL["param"]) for n in p_cpu)
        res["heads"][head] = dict(losses={k: float(v) for k, v in l_dev.items()},
                                  loss_err=errs, grad_err=g_err, param_err=p_err,
                                  launches=launches, ddp=wrapped)
        card_params[head] = p_dev
    torch.save(card_params, spec["out"] + ".params.pt")
    dist.destroy_process_group()
    return res


def _worker_spatial_norm(spec: dict) -> dict:
    """The global instance norm of a map sharded along D over the group
    (``spatial_instance_norm``: #1 at the exact schedule, Chan's merge of
    count, mean and M2 over the group, #2 with the global statistics;
    backward #3, its sums all-reduced and divided by the group's size, #4)
    at ``MULTI_NORM_SHAPE``, forward and backward in bfloat16 and float32:
    on the CPU and then on the card within one gloo group, the card's
    output, input gradient and parameter gradients held to the CPU's, its
    output to the plain norm of the whole map on the card; #1-#4 launched
    by each card run."""
    import torch.distributed as dist

    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.ops.instance_norm import instance_norm_plain, spatial_instance_norm
    from nndetection_tpu_torch.parallel import distributed

    rank, world = spec["rank"], spec["world"]
    distributed.initialize(f"localhost:{spec['port']}", world, rank, device="cuda",
                           backend="gloo", timeout_min=MULTI_GROUP_TIMEOUT_MIN)
    card = distributed.rank_device("cuda")
    c, depth = MULTI_NORM_SHAPE[-1], MULTI_NORM_SHAPE[1]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(MULTI_NORM_SHAPE, generator=g) * 2 + 1
    dy = torch.randn(MULTI_NORM_SHAPE, generator=g)
    gamma = torch.rand(c, generator=g) + 0.5
    beta = torch.randn(c, generator=g)
    zs = slice(rank * depth // world, (rank + 1) * depth // world)
    res = {"backend": dist.get_backend(), "z": [zs.start, zs.stop], "dtypes": {}, "launches": {}}
    for dtype in (torch.bfloat16, torch.float32):
        runs = []
        for dev in (torch.device("cpu"), card):
            xs = x[:, zs].to(dev, dtype, copy=True).contiguous().requires_grad_()
            gs, bs = (t.to(dev, copy=True).requires_grad_() for t in (gamma, beta))
            LAUNCHES.clear()
            y = spatial_instance_norm(xs, gs, bs)
            y.backward(dy[:, zs].to(dev, dtype).contiguous())
            if dev.type == "cuda":
                torch.cuda.synchronize()
            runs.append(({"y": y.detach(), "dx": xs.grad, "dgamma": gs.grad, "dbeta": bs.grad},
                         dict(LAUNCHES)))
        (cpu, _), (dev_out, launches) = runs
        tol, name = MULTI_NORM_TOL[dtype], str(dtype)[6:]
        errs = {k: check_close(f"multi spatial norm {name} {k}", dev_out[k].cpu(), cpu[k], *tol[k])
                for k in ("y", "dx")}
        for k in ("dgamma", "dbeta"):
            errs[k] = check_close(f"multi spatial norm {name} {k}", dev_out[k].cpu(), cpu[k], 0,
                                  tol["param"] * float(cpu[k].abs().max()))
        whole = instance_norm_plain(x.to(card, dtype), gamma.to(card), beta.to(card))[:, zs]
        errs["y_whole"] = check_close(f"multi spatial norm {name} y against the whole map",
                                      dev_out["y"], whole, *tol["y"])
        res["dtypes"][name] = errs
        res["launches"][name] = launches
    dist.destroy_process_group()
    return res


def phase_multi(device, single=None, n_cases=RUN_TRAIN_CASES, shape=TRAIN_AUG_CASE_SHAPE,
                steps=6, val_batches=2) -> dict:
    """The port's multi-process training on the one card, each rank a
    process of its own (``python3 chip_smoke.py --multi-worker=...``):

    (a) ``run_train`` as a one-rank job (``NNDET_COORDINATOR``,
    ``NNDET_NUM_PROCESSES=1``, ``NNDET_PROCESS_ID=0``) on the run_train
    phase's task, 6 fed steps and 2 validation batches: NCCL, the model in
    DDP, the files, finite losses, #1-#4 and #7 launched; s/step beside the
    one-process ``run_train``'s in a fresh process as well (both pay a new
    process's first steps) and in this one (``single``, the run_train
    phase's (a), or run here); (b) two gloo ranks on ``cuda:0``, one data-parallel step of
    the tiny float32 model per head, each rank against the same step on
    the CPU in the same group, the ranks' parameters equal bit for bit, #1-#4
    launched on each; (c) the spatial step with a model axis of 2 is
    recorded as not run, before anything runs (gloo sends no CUDA tensor
    point to point, NCCL puts no two ranks on one card); its global
    instance norm, which needs only all-reduces, runs on two gloo ranks on
    ``cuda:0`` (:func:`_worker_spatial_norm`)."""
    import tempfile
    from pathlib import Path

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        task_dir = tmp / "Task100_LunaPlan"
        write_task(task_dir, n_cases, shape)
        if single is None:
            single = run_train_once(device, task_dir, tmp / "models_single", steps, val_batches)
        port = free_port()
        (fresh,) = spawn_ranks(
            [dict(kind="run_train", task=str(task_dir), models=str(tmp / "models_fresh"),
                  steps=steps, val_batches=val_batches, out=str(tmp / "fresh.json"))])
        (a,) = spawn_ranks(
            [dict(kind="run_train", task=str(task_dir), models=str(tmp / "models_nccl"),
                  steps=steps, val_batches=val_batches, out=str(tmp / "a.json"))],
            env=[{"NNDET_COORDINATOR": f"localhost:{port}", "NNDET_NUM_PROCESSES": "1",
                  "NNDET_PROCESS_ID": "0"}])
        if fresh["backend"] is not None or fresh["wrappers"] != [None]:
            raise AssertionError(f"multi (a): the one-process run formed a group: {fresh}")
        if a["backend"] != "nccl" or a["world"] != 1 or a["wrappers"] != ["DistributedDataParallel"]:
            raise AssertionError(f"multi (a): backend {a['backend']}, world {a['world']}, "
                                 f"wrappers {a['wrappers']}")
        log(f"[multi] (a) run_train as a one-rank NCCL job: {a['s_per_step']:.4f} s/step against "
            f"{fresh['s_per_step']:.4f} s/step without a job in a fresh process and "
            f"{single['s_per_step']:.4f} s/step in this one ({steps} fed steps, "
            f"{val_batches} validation batches, the first steps included); backend "
            f"{a['backend']}, model in "
            f"{a['wrappers'][0]}; peak {a['peak_gib']:.2f} GiB; losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in a["losses"].items())
            + f"; kernel launches {a['launches']}")
        for label, r in (("one-rank NCCL job", a), ("one process, fresh", fresh)):
            log(f"[multi] (a) {label}: train steps {', '.join(f'{t:.4f}' for t in r['step_s'])} "
                f"s; first {r['step_s'][0]:.4f} s, median of the rest "
                f"{statistics.median(r['step_s'][1:]):.4f} s")
        out["a"] = dict(a, single_s_per_step=single["s_per_step"],
                        fresh_s_per_step=fresh["s_per_step"])

        def step_ranks(n_model, label):
            port = free_port()
            specs = [dict(kind="step", rank=r, world=2, n_model=n_model, port=port,
                          out=str(tmp / f"{label}{r}.json")) for r in range(2)]
            results = spawn_ranks(specs)
            params = [torch.load(sp["out"] + ".params.pt", weights_only=True) for sp in specs]
            for head in ("no_sampler", "hnm"):
                for n, p in params[0][head].items():
                    if not torch.equal(p, params[1][head][n]):
                        raise AssertionError(f"multi ({label}) {head}: the ranks' {n} differ")
            for r, res in enumerate(results):
                for head, h in res["heads"].items():
                    not_run = [k for k in TRAIN_KERNELS if h["launches"].get(k, 0) == 0]
                    if not_run or not h["ddp"] or res["backend"] != "gloo":
                        raise AssertionError(f"multi ({label}) rank {r} {head}: kernels not "
                                             f"launched {not_run}, ddp {h['ddp']}, backend "
                                             f"{res['backend']}")
                    log(f"[multi] ({label}) rank {r} of 2 on cuda:0 (gloo), rows "
                        f"{res['rows']}, {head}: card vs CPU max abs err losses "
                        + ", ".join(f"{k} {v:.2e}" for k, v in h["loss_err"].items())
                        + f", gradients {h['grad_err']:.2e}, parameters {h['param_err']:.2e}; "
                        f"total {h['losses']['total']:.6f}; launches {h['launches']}")
            log(f"[multi] ({label}) the two ranks' parameters after the step equal bit for bit")
            return results

        out["b"] = step_ranks(1, "b")
        log("[multi] (c) the spatial step did not run on the card: its halo exchange sends "
            "slabs point to point, which gloo does not do with CUDA tensors, and NCCL does "
            "not put two ranks on one card; a model axis of 2 needs two cards: unverified")
        port = free_port()
        out["c_norm"] = spawn_ranks(
            [dict(kind="spatial_norm", rank=r, world=2, port=port,
                  out=str(tmp / f"norm{r}.json")) for r in range(2)])
        for r, res in enumerate(out["c_norm"]):
            for name, errs in res["dtypes"].items():
                launched = res["launches"][name]
                not_run = [k for k in TRAIN_KERNELS if launched.get(k, 0) == 0]
                if not_run or res["backend"] != "gloo":
                    raise AssertionError(f"multi (c) spatial norm rank {r} {name}: kernels not "
                                         f"launched {not_run}, backend {res['backend']}")
                log(f"[multi] (c) spatial instance norm {MULTI_NORM_SHAPE} rank {r} of 2 on "
                    f"cuda:0 (gloo), depth {res['z']}, {name}: card vs CPU max abs err "
                    + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                    + f"; launches {launched}")
    # per rank, both heads' steps; both dtypes of the spatial norm
    launches = {"a": a["launches"],
                "b": [{k: sum(h["launches"].get(k, 0) for h in r["heads"].values())
                       for k in KERNELS} for r in out["b"]],
                "c_norm": [{k: sum(d.get(k, 0) for d in r["launches"].values())
                            for k in KERNELS} for r in out["c_norm"]]}
    json_line({"multi": {"a_s_per_step": a["s_per_step"], "a_step_s": a["step_s"],
                         "fresh_step_s": fresh["step_s"],
                         "fresh_s_per_step": fresh["s_per_step"],
                         "single_s_per_step": single["s_per_step"],
                         "b_ranks_bit_equal": True, "c_ran": False,
                         "c_norm_err": [r["dtypes"] for r in out["c_norm"]],
                         "launches": launches}})
    return dict(out, launches=launches)


# the prep phase: a raw CT task through the port's run_prep, then trained on
# the port's own plan
PREP_CASES = 6
PREP_CASE_SHAPE = (128, 256, 256)
# (z, y, x) mm: the median, (1.25, 0.75, 0.75), resamples every case
PREP_SPACINGS = ((1.25, 0.70, 0.70),) * 3 + ((1.25, 0.80, 0.80),) * 3
PREP_OBJECT_SIZE = (10, 28)  # voxels, 7-22 mm at 0.75 mm
PLAN_FILES = ("dataset.yaml", "preprocessed/D3V001_3d.pkl", "preprocessed/splits_final.pkl",
              "preprocessed/properties/dataset_properties.pkl")
CASE_FILES = ("imagesTr/{}.npz", "imagesTr/{}.npy", "imagesTr/{}.pkl", "imagesTr/{}_boxes.pkl",
              "labelsTr/{}_boxes_gt.npz")
# the fields the probe decides (the patch and what follows from it only
# when a probe at the base batch was over budget)
PROBE_FIELDS = ("batch_size", "remat", "mem_compiled_bytes")
PATCH_FIELDS = ("patch_size", "pool_strides", "conv_kernels", "decoder_levels", "anchors",
                "anchor_score", "requires_lowres")


def write_raw_task(task_dir, n_cases=PREP_CASES, shape=PREP_CASE_SHAPE, spacings=PREP_SPACINGS,
                   seed=0) -> None:
    """A raw task as a user brings it (``raw_splitted`` with ``.nii.gz``
    images, instance label maps and their json, ``dataset.yaml`` with one
    CT modality and two labels): ``n_cases`` float32 cases in HU (``data x
    1400 - 1000`` of ``example.generate_case``), 1-3 seeded objects each,
    case ``i`` at ``spacings[i]``."""
    from nndetection_tpu_torch.utils.io import save_yaml

    save_yaml({"task": task_dir.name, "name": "LunaLike", "dim": 3, "target_class": None,
               "test_labels": True, "labels": {"0": "c0", "1": "c1"},
               "modalities": {"0": "CT"}}, task_dir / "dataset.yaml")
    for i in range(n_cases):
        write_raw_case(task_dir, "Tr", f"case_{i}", np.random.RandomState(seed + i), shape,
                       spacings[i])


def write_raw_case(task_dir, split, cid, rng, shape, spacing, objects=True) -> None:
    """One case of :func:`write_raw_task` under ``raw_splitted/{images,
    labels}{split}``: 1-3 seeded objects, or none (a negative case) without
    ``objects``."""
    from nndetection_tpu_torch.data import nifti
    from nndetection_tpu_torch.data.example import generate_case
    from nndetection_tpu_torch.utils.io import save_json

    images = task_dir / "raw_splitted" / f"images{split}"
    labels = task_dir / "raw_splitted" / f"labels{split}"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)
    data, seg, instances = None, np.zeros(shape, np.uint8), {}
    for iid in range(1, rng.randint(1, 4) + 1 if objects else 1):
        d, mask, cls = generate_case(rng, shape, PREP_OBJECT_SIZE, object_width=3)
        data = d if data is None else np.where(mask > 0, d, data)
        seg[mask > 0] = iid
        instances[str(iid)] = int(cls)
    if data is None:  # the background of generate_case alone
        data = rng.rand(*shape).astype(np.float32)
    hu = (data * 1400.0 - 1000.0).astype(np.float32)
    nifti.save(images / f"{cid}_0000.nii.gz", hu, spacing=spacing)
    nifti.save(labels / f"{cid}.nii.gz", seg, spacing=spacing)
    save_json({"instances": instances}, labels / f"{cid}.json")


@contextlib.contextmanager
def patched(owner, wrappers: dict):
    """``owner``'s attributes replaced by ``wrappers[name](original)`` for
    the block, restored after."""
    saved = {n: getattr(owner, n) for n in wrappers}
    for n, wrap in wrappers.items():
        setattr(owner, n, wrap(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(owner, n, fn)


def timer(seconds: dict, name: str):
    """A wrapper that adds each call's seconds to ``seconds[name]``."""
    def wrap(fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return timed
    return wrap


def capturing(results: list):
    """A wrapper that appends each call's result to ``results``."""
    def wrap(fn):
        def call(*args, **kwargs):
            results.append(fn(*args, **kwargs))
            return results[-1]
        return call
    return wrap


def probe_line(r, budget) -> str:
    est = r["est"]
    b = est.breakdown
    verdict = "out of memory" if est.out_of_memory else (
        "fits" if est.fits(budget) else "over budget")
    return (f"batch {r['batch']} remat={r['remat']} patch {list(r['patch'])} GT slots "
            f"{r['slots']}: allocated peak {est.total_bytes / 2 ** 30:.4f} GiB above a baseline "
            f"of {b['baseline'] / 2 ** 30:.4f} GiB, reserved peak {b['reserved_peak'] / 2 ** 30:.4f}"
            f" GiB; {verdict} against {budget / 2 ** 30:.4f} GiB; {b['step_ms']:.2f} ms/step "
            f"(probe call {r['s']:.2f} s)")


def recording_probe(calls: list):
    """A wrapper of ``probe_train_step_estimate`` that records each call."""
    def wrap(fn):
        def probe(cfg, batch_size, max_instances=32, **kwargs):
            t0 = time.perf_counter()
            est = fn(cfg, batch_size, max_instances, **kwargs)
            calls.append(dict(batch=batch_size, remat=cfg.remat, patch=tuple(cfg.patch_size),
                              slots=max_instances, est=est, s=time.perf_counter() - t0))
            return est
        return probe
    return wrap


def check_prepared_task(task_dir, plan) -> int:
    """Every file ``run_train`` reads exists and every processed array is
    finite; returns the processed cases."""
    from nndetection_tpu_torch.utils.io import load_pickle

    prep = task_dir / "preprocessed" / plan.plan_id
    ids = [f"case_{i}" for i in range(len(list((task_dir / "raw_splitted" / "imagesTr")
                                                .glob("*.nii.gz"))))]
    missing = [f for f in PLAN_FILES if not (task_dir / f).exists()]
    missing += [f.format(c) for c in ids for f in CASE_FILES if not (prep / f.format(c)).exists()]
    if missing:
        raise AssertionError(f"prep: files missing: {missing}")
    for cid in ids:
        arr = np.load(prep / "imagesTr" / f"{cid}.npy", mmap_mode="r")
        if arr.shape[0] != plan.in_channels + 1 or not np.isfinite(arr).all():
            raise AssertionError(f"prep: {cid}.npy {arr.shape} not finite or wrong channels")
        if len(load_pickle(prep / "imagesTr" / f"{cid}_boxes.pkl")["boxes"]) == 0:
            raise AssertionError(f"prep: {cid} lost its objects")
    return len(ids)


def phase_prep(device, n_cases=PREP_CASES, shape=PREP_CASE_SHAPE, num_workers=4, steps=6,
               val_batches=2, prepared=None, fed=None) -> dict:
    """A raw CT task of ``n_cases`` seeded cases through the port's
    ``run_prep(num_workers=4, device="cuda")`` (seconds per stage, each
    probe call, the plan; files, finiteness, ``mem_compiled_bytes > 0`` and
    the plan within the probe's budget checked), the same properties
    planned on the CPU at the same budget (every field the probe does not
    decide equal), then ``run_train`` (fold 0, ``RetinaUNetV001``,
    ``base_more``, one epoch of ``steps``, ``val_batches`` validation
    batches, no SWA) on the port's own plan, its pool sized from the
    measured peak. Last, the fed step's peak split: the probe at the LUNA
    plan, batch 8, with 8 and with 32 GT slots, beside the prepared and the
    fed steps' peaks of this run (``prepared``, ``fed``: the train and
    train_aug phases' results)."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from nndetection_tpu_torch import pipeline
    from nndetection_tpu_torch.data.dataset import DatasetInfo
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.planning import planner as planner_mod
    from nndetection_tpu_torch.planning.estimator import probe_train_step_estimate
    from nndetection_tpu_torch.utils.io import load_pickle

    total = pipeline.device_memory_bytes(device)
    budget = int(total * planner_mod.BUDGET_SHARE)
    probe_budget = int(budget * 0.92 / 0.85)  # the planner's formula
    with tempfile.TemporaryDirectory() as tmp:
        task_dir = Path(tmp) / "Task101_LunaLike"
        t0 = time.perf_counter()
        write_raw_task(task_dir, n_cases, shape)
        t_write = time.perf_counter() - t0

        seconds, probes = {}, []
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with patched(pipeline, {n: timer(seconds, n) for n in (
                "run_cropping", "analyze_dataset", "_process_all", "unpack_dataset")}), \
                patched(planner_mod.Planner, {"plan_experiment": timer(seconds, "plan")}), \
                patched(planner_mod, {"probe_train_step_estimate": recording_probe(probes)}):
            plan = pipeline.run_prep(task_dir, num_workers=num_workers, device=device)
        t_prep = time.perf_counter() - t0
        prep_launches = dict(LAUNCHES)
        n_done = check_prepared_task(task_dir, plan)
        stages = dict(crop=seconds["run_cropping"], analyze=seconds["analyze_dataset"],
                      plan=seconds["plan"],
                      process=seconds["_process_all"] - seconds["unpack_dataset"],
                      unpack=seconds["unpack_dataset"])
        log(f"[prep] raw task of {n_cases} cases {shape} float32 CT, spacings "
            f"{sorted(set(PREP_SPACINGS[:n_cases]))} mm, written in {t_write:.2f} s; run_prep "
            f"(num_workers={num_workers}) {t_prep:.2f} s: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()) + f"; {n_done} cases")
        for r in probes:
            log(f"[prep] probe: {probe_line(r, probe_budget)}")
        log(f"[prep] plan: patch {plan.patch_size}, batch {plan.batch_size}, remat={plan.remat}, "
            f"target spacing {plan.target_spacing}, pool strides {plan.pool_strides}, decoder "
            f"levels {list(plan.decoder_levels)}, anchors {plan.anchors} (score "
            f"{plan.anchor_score:.4f}), mem_estimate_bytes {plan.mem_estimate_bytes} "
            f"({plan.mem_estimate_bytes / 2 ** 30:.4f} GiB), mem_compiled_bytes "
            f"{plan.mem_compiled_bytes} ({plan.mem_compiled_bytes / 2 ** 30:.4f} GiB), "
            f"requires_lowres={plan.requires_lowres}; budget {budget / 2 ** 30:.4f} GiB (0.85 x "
            f"{total / 2 ** 30:.4f} GiB), probe budget {probe_budget / 2 ** 30:.4f} GiB")
        log(f"[prep] kernel launches in run_prep (the probe's steps): {prep_launches}")
        not_run = [k for k in TRAIN_KERNELS if prep_launches.get(k, 0) == 0]
        if not_run:
            raise AssertionError(f"prep: the probe never launched {not_run}")
        if not plan.mem_compiled_bytes > 0:
            raise AssertionError("prep: the plan has no measured peak")
        final = [r for r in probes if (r["batch"], r["remat"], r["patch"]) == (
            plan.batch_size, plan.remat, tuple(plan.patch_size))]
        if not final or not final[-1]["est"].fits(probe_budget) or \
                final[-1]["est"].total_bytes != plan.mem_compiled_bytes:
            raise AssertionError("prep: the plan's batch and patch did not pass the probe")

        # the same properties planned on the CPU at the card's budget
        props = load_pickle(task_dir / "preprocessed" / "properties" / "dataset_properties.pkl")
        info = DatasetInfo.from_file(task_dir / "dataset.yaml")
        cpu_plan = planner_mod.Planner(hbm_budget=budget, device="cpu").plan_experiment(
            props, info)
        base_over = any(r["batch"] == 4 and not r["est"].fits(probe_budget) for r in probes)
        decided = PROBE_FIELDS + (PATCH_FIELDS if base_over else ())
        card, cpu = dataclasses.asdict(plan), dataclasses.asdict(cpu_plan)
        differ = {k: (card[k], cpu[k]) for k in card if card[k] != cpu[k]}
        log(f"[prep] card plan vs CPU plan at {budget} bytes: fields that differ "
            f"{differ or 'none'}; the probe decides {list(decided)}")
        wrong = sorted(set(differ) - set(decided))
        if wrong:
            raise AssertionError(f"prep: the card's and the CPU's plans differ in {wrong}")

        # train a fold on the port's own plan
        loaders = []
        pool_budget = pipeline.pool_budget(plan, plan.batch_size, total)
        with patched(pipeline, {"build_loaders": capturing(loaders)}):
            r = run_train_once(device, task_dir, Path(tmp) / "models", steps, val_batches)
        pool = loaders.pop()[0]
        m = r["m"]
        log(f"[prep] run_train on the port's plan: {m['steps']} fed steps {m['epoch_time_s']:.3f} "
            f"s = {r['s_per_step']:.4f} s/step, {r['patches_per_s']:.2f} patches/s at batch "
            f"{plan.batch_size}; peak device memory {r['peak_gib']:.4f} GiB against the probe's "
            f"{plan.mem_compiled_bytes / 2 ** 30:.4f} GiB; pool budget {pool_budget} bytes "
            f"({pool_budget / 2 ** 30:.4f} GiB), {type(pool).__name__}.pool_bytes() "
            f"{pool.pool_bytes()} ({pool.pool_bytes() / 2 ** 30:.4f} GiB); losses "
            + ", ".join(f"{k} {m['train_' + k]:.4f}" for k in ("cls", "reg", "seg_ce", "seg_dice"))
            + f"; {r['changed']}/{r['tensors']} parameter tensors changed; pool {r['pool']}")
        log(f"[prep] kernel launches in run_train: {r['launches']}")
        del pool

    # the fed step's peak split by GT slots, at the LUNA plan, batch 8
    split = {}
    for slots in (8, 32):
        calls = []
        recording_probe(calls)(probe_train_step_estimate)(luna_cfg(), 8, slots, device=device)
        split[slots] = calls[0]
        log(f"[prep] split, LUNA plan: {probe_line(calls[0], probe_budget)}")
    slot_share = (split[32]["est"].total_bytes - split[8]["est"].total_bytes) / 2 ** 30
    seen = {"prepared step (train phase, 8 GT slots)": prepared, "fed step, pool (train_aug "
            "phase, 32 GT slots)": fed}
    log(f"[prep] split: 24 more GT slots take {slot_share:.4f} GiB; peaks of this run: "
        + "; ".join(f"{k} {v['peak_gib']:.4f} GiB" if v else f"{k} not run"
                    for k, v in seen.items())
        + (f"; the fed step above the probe at 32 slots: "
           f"{fed['peak_gib'] - split[32]['est'].total_bytes / 2 ** 30:.4f} GiB (augmentation, "
           "pool, prefetched batches and the baseline)" if fed else ""))
    return dict(launches={"run_prep": prep_launches, "run_train": r["launches"]}, plan=plan,
                stages=stages, probes=probes, split=split, run_train=r)


# the cli phase: the README's sequence through the port's entry points, from
# a raw CT task to scores
CLI_TASK = "Task102_LunaLike"
CLI_TEST_CASES = 2  # the first with objects, the second without
CLI_TEST_SPACING = (1.25, 0.75, 0.75)
# the kernels each stage must launch: the probe and the training, and every
# prediction (the sweep's, the test split's)
PREDICT_KERNELS = ("in_stats", "in_apply", "nms_topk", "wbc_cluster")
CLI_KERNELS = {"prep": TRAIN_KERNELS, "train": RUN_TRAIN_KERNELS, "sweep": PREDICT_KERNELS,
               "consolidate": CONSOLIDATE_KERNELS, "predict": PREDICT_KERNELS}
# run_predict_val (the card, float32 WBC) against materialize_val_predictions
# (the host, float64 WBC) on the same raw detections: PERF.md section 2
CLI_VAL_TOL = dict(rtol=1e-5, atol=1e-5)


@contextlib.contextmanager
def environ(values: dict):
    """``os.environ`` with ``values`` set for the block, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def launch_delta(launches: dict, name: str):
    """A wrapper that records the kernel launches of each call in
    ``launches[name]``."""
    from nndetection_tpu_torch.ops import LAUNCHES

    def wrap(fn):
        def counted(*args, **kwargs):
            before = dict(LAUNCHES)
            try:
                return fn(*args, **kwargs)
            finally:
                launches[name] = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                                  if v - before.get(k, 0)}
        return counted
    return wrap


def phase_cli(device, n_cases=PREP_CASES, shape=PREP_CASE_SHAPE, n_test=CLI_TEST_CASES,
              num_workers=4, steps=6, val_batches=2, extra_overrides=()) -> dict:
    """The README's sequence through the port's command-line entry points,
    each ``main()`` called in this process with ``sys.argv`` set, on a raw
    task of ``n_cases`` seeded CT cases (:func:`write_raw_task`) and
    ``n_test`` test cases: ``cli.prep`` (``num_workers`` workers), ``cli.train
    --fold 0 --sweep`` (one epoch of ``steps`` steps, ``val_batches``
    validation batches, no SWA), ``cli.consolidate --num_folds 1``,
    ``cli.predict --num_folds 1`` (TTA) and ``cli.evaluate --seg --case``.
    Seconds, peak memory and kernel launches per command. Checked: the
    files, finite scores, each stage's kernels (``CLI_KERNELS``), the
    card's sweep against the CPU's device formulation on the same states
    (identical best parameters), and ``run_predict_val`` on the card against
    ``materialize_val_predictions`` on the host (``CLI_VAL_TOL``)."""
    import logging
    import tempfile
    from pathlib import Path

    import nndetection_tpu_torch.inference.ensembler as ensembler
    from nndetection_tpu_torch import pipeline
    from nndetection_tpu_torch.cli import consolidate, evaluate, predict, prep, train
    from nndetection_tpu_torch.inference.sweeper import BoxSweeper
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.planning.planner import load_plan
    from nndetection_tpu_torch.utils.io import load_json, load_pickle

    overrides = ["trainer_cfg.max_num_epochs=1", f"trainer_cfg.num_train_batches_per_epoch={steps}",
                 f"trainer_cfg.num_val_batches_per_epoch={val_batches}",
                 "trainer_cfg.swa_epochs=0", "trainer_cfg.warm_iterations=10",
                 *extra_overrides]
    with tempfile.TemporaryDirectory() as tmp:
        data, models = Path(tmp) / "data", Path(tmp) / "models"
        task_dir = data / CLI_TASK
        t0 = time.perf_counter()
        write_raw_task(task_dir, n_cases, shape)
        for i in range(n_test):
            write_raw_case(task_dir, "Ts", f"case_{n_cases + i}",
                           np.random.RandomState(100 + i), shape, CLI_TEST_SPACING,
                           objects=i == 0)
        t_write = time.perf_counter() - t0
        seconds, launches, peaks = {}, {}, {}

        def command(name, module, *argv):
            saved = sys.argv
            sys.argv = [f"{module.__name__}", CLI_TASK, *map(str, argv)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            try:
                module.main()
                torch.cuda.synchronize()
            finally:
                sys.argv = saved
            seconds[name] = time.perf_counter() - t0
            launches[name] = dict(LAUNCHES)
            peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30

        with environ({"det_data": str(data), "det_models": str(models)}), \
                patched(train, {"run_sweep": launch_delta(launches, "sweep")}), \
                patched(train, {"run_sweep": timer(seconds, "sweep")}):
            try:
                command("prep", prep, "--num_workers", num_workers)
                command("train", train, "--fold", 0, "--sweep", "-o", *overrides)
                command("consolidate", consolidate, "--num_folds", 1)
                command("predict", predict, "--num_folds", 1)
                command("evaluate", evaluate, "--seg", "--case")
            finally:
                for h in logging.root.handlers[:]:  # the commands' log files
                    h.close()
                    logging.root.removeHandler(h)
        launches["train"] = {k: v - launches["sweep"].get(k, 0)
                             for k, v in launches["train"].items()
                             if v - launches["sweep"].get(k, 0)}

        # the files of the JAX package's sequence
        model_dir = models / CLI_TASK / "RetinaUNetV001_D3V001_3d"
        fold, cons, preds = model_dir / "fold0", model_dir / "consolidated", \
            model_dir / "test_predictions"
        plan = load_plan(task_dir / "preprocessed" / "D3V001_3d.pkl")
        check_prepared_task(task_dir, plan)
        test_ids = [f"case_{n_cases + i}" for i in range(n_test)]
        ts = task_dir / "preprocessed" / plan.plan_id
        wanted = ([fold / f for f in ("model_last.ckpt", "plan_inference.pkl", "metrics.json")]
                  + [cons / f for f in ("model_fold0.ckpt", "plan_inference.pkl", "plan.pkl")]
                  + [ts / f"imagesTs/{c}.npy" for c in test_ids]
                  + [ts / f"labelsTs/{c}_boxes_gt_orig.npz" for c in test_ids]
                  + [preds / f"{c}_boxes.pkl" for c in test_ids]
                  + [preds / f"results_{k}.json" for k in ("boxes", "case", "seg")])
        missing = [str(p.relative_to(tmp)) for p in wanted if not p.exists()]
        states = sorted(p.name for p in (fold / "sweep").glob("*_boxes_state.pkl"))
        pooled = sorted(p.name for p in (cons / "sweep_states").glob("*_boxes_state.pkl"))
        if missing or not states or pooled != states:
            raise AssertionError(f"cli: files missing {missing}, sweep states {states}, "
                                 f"consolidated states {pooled}")
        boxes = {}
        for cid in test_ids:
            r = load_pickle(preds / f"{cid}_boxes.pkl")
            if r["restored"] is not True or not np.isfinite(r["pred_boxes"]).all() \
                    or not len(r["pred_scores"]):
                raise AssertionError(f"cli: {cid} not restored, without or with non-finite boxes")
            boxes[cid] = len(r["pred_scores"])
        scores = {k: load_json(preds / f"results_{k}.json") for k in ("boxes", "case", "seg")}
        bad = [f"{k}:{n}" for k, s in scores.items() for n, v in s.items()
               if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"cli: scores not finite: {bad}")
        for stage, kernels in CLI_KERNELS.items():
            not_run = [k for k in kernels if launches[stage].get(k, 0) == 0]
            if not_run:
                raise AssertionError(f"cli {stage}: kernels never launched: {not_run}")
        epoch = load_json(fold / "metrics.json")[0]
        pooled_params = load_pickle(cons / "plan_inference.pkl")["parameters"]

        # the card's sweep against the device formulation on the CPU
        info_classes = ["c0", "c1"]
        swept = load_pickle(fold / "plan_inference.pkl")
        ensembler.DEVICE_WBC = True
        try:
            t0 = time.perf_counter()
            cpu_sweep = BoxSweeper(info_classes, fold / "sweep", ts / "labelsTr",
                                   device="cpu").run_postprocessing_sweep()
            t_cpu_sweep = time.perf_counter() - t0
        finally:
            ensembler.DEVICE_WBC = "auto"
        host_sweep = BoxSweeper(info_classes, fold / "sweep", ts / "labelsTr",
                                device="cpu").run_postprocessing_sweep()
        if cpu_sweep["parameters"] != swept["parameters"] or \
                not abs(cpu_sweep["score"] - swept["score"]) <= 1e-6:
            raise AssertionError(f"cli: sweep on the card {swept}, on the CPU {cpu_sweep}")

        # the validation predictions, predicted again on the card against
        # those materialized from the sweep's states on the host
        t0 = time.perf_counter()
        val = pipeline.run_predict_val(task_dir, model_dir, fold=0, device=device)
        torch.cuda.synchronize()
        t_val = time.perf_counter() - t0
        val = val.rename(val.parent / "val_predicted")
        t0 = time.perf_counter()
        mat = pipeline.materialize_val_predictions(task_dir, model_dir, fold=0, device=device)
        t_mat = time.perf_counter() - t0
        names = sorted(p.name for p in val.glob("*_boxes.pkl"))
        if not names or names != sorted(p.name for p in mat.glob("*_boxes.pkl")):
            raise AssertionError(f"cli: validation predictions {names}")
        val_err, val_n = 0.0, []
        for name in names:
            got, want = load_pickle(val / name), load_pickle(mat / name)
            if not (got["restored"] and want["restored"]) or not len(want["pred_scores"]):
                raise AssertionError(f"cli: validation {name} not restored or empty")
            val_err = max(val_err, paired_max_err(f"cli val {name}", got, want, **CLI_VAL_TOL))
            val_n.append(len(want["pred_scores"]))

    log(f"[cli] task of {n_cases} + {n_test} test cases {shape} written in {t_write:.2f} s; "
        "seconds per command: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()
                                            if k != "sweep")
        + f" (of train, the sweep {seconds['sweep']:.2f})")
    log(f"[cli] plan: patch {plan.patch_size}, batch {plan.batch_size}, remat={plan.remat}, "
        f"mem_compiled_bytes {plan.mem_compiled_bytes / 2 ** 30:.4f} GiB; train "
        f"{epoch['steps']} fed steps {epoch['epoch_time_s']:.3f} s = "
        f"{epoch['epoch_time_s'] / epoch['steps']:.4f} s/step, val cls {epoch['val_cls']:.4f}")
    log(f"[cli] sweep (fold 0, {len(states)} cases): {swept['parameters']} score "
        f"{swept['score']:.6f}; identical on the CPU's device formulation ({t_cpu_sweep:.2f} s); "
        f"host float64 {'agrees' if host_sweep == swept else 'differs: ' + str(host_sweep)}; "
        f"consolidated {pooled_params}")
    log(f"[cli] boxes per test case {boxes}; box mAP "
        f"{scores['boxes']['mAP_IoU_0.10_0.50_0.05_MaxDet_100']:.4f}, AP@0.1 "
        f"{scores['boxes']['AP_IoU_0.10_MaxDet_100']:.4f}, FROC@0.1 "
        f"{scores['boxes']['FROC_score_IoU_0.10']:.4f}; case AUROC "
        f"{scores['case']['case_auroc']:.4f}, AP {scores['case']['case_ap']:.4f}; seg dice "
        f"{scores['seg']['seg_dice_fg_mean']:.4f} (run_predict_test writes no seg maps, as the "
        "JAX package's)")
    log(f"[cli] run_predict_val on the card {t_val:.2f} s against materialize_val_predictions "
        f"on the host {t_mat:.2f} s: {val_n} detections, paired within {CLI_VAL_TOL}, max abs "
        f"err {val_err:.2e}")
    log("[cli] peak device memory GiB " + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items()))
    for stage in ("prep", "train", "sweep", "consolidate", "predict", "evaluate"):
        log(f"[cli] kernel launches in {stage}: {launches[stage]}")
    return dict(launches=launches, seconds=seconds, plan=plan)


# the luna phase: the LUNA-proxy cross-validation from raw .mhd files to a CPM
LUNA_CASES = 10
LUNA_INPLANE = 256
# the kernels each stage must launch: the probe and the training, the sweep's
# predictions, the consolidation's sweep
LUNA_KERNELS = {"prep": TRAIN_KERNELS, "train": RUN_TRAIN_KERNELS, "sweep": PREDICT_KERNELS,
                "consolidate": CONSOLIDATE_KERNELS}
# a CSV row's world coordinate mapped back to its box centre, in voxels
LUNA_ROUND_TRIP_TOL = 1e-4


def stage_meter(seconds: dict, peaks: dict, launches: dict, name: str):
    """A wrapper that records each call's seconds (synchronised), peak
    device memory (GiB) and kernel launches under ``name``."""
    from nndetection_tpu_torch.ops import LAUNCHES

    def wrap(fn):
        def measured(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
                peaks[name] = max(peaks.get(name, 0.0),
                                  torch.cuda.max_memory_allocated() / 2 ** 30)
                delta = launches.setdefault(name, {})
                for k, v in LAUNCHES.items():
                    if v - before.get(k, 0):
                        delta[k] = delta.get(k, 0) + v - before.get(k, 0)
        return measured
    return wrap


def check_cpm_export(model_dir, labels_dir) -> tuple:
    """Every row of ``cpm_predictions.csv`` is one pooled detection at or
    above the export's threshold (0), in the pool's order, with the same
    probability, and its world coordinate maps back through
    ``mhd.world_to_voxel`` to the box centre within ``LUNA_ROUND_TRIP_TOL``
    voxel. Returns (rows, largest round-trip error in voxels)."""
    import csv

    from nndetection_tpu_torch.data import mhd
    from nndetection_tpu_torch.utils.io import load_pickle

    with open(model_dir / "cpm_predictions.csv") as f:
        rows = [(r["seriesuid"], np.asarray([float(r["coordX"]), float(r["coordY"]),
                                             float(r["coordZ"])]), float(r["probability"]))
                for r in csv.DictReader(f)]
    want = []
    for p in sorted((model_dir / "cv_predictions").glob("*_boxes.pkl")):
        cid = p.name[: -len("_boxes.pkl")]
        if not (labels_dir / f"{cid}_geometry.pkl").exists():
            continue
        pred = load_pickle(p)
        for b, s in zip(np.asarray(pred["pred_boxes"], np.float64), pred["pred_scores"]):
            if s >= 0.0:
                want.append((cid, np.asarray([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2,
                                              (b[4] + b[5]) / 2]), float(s)))
    if [(c, s) for c, _, s in rows] != [(c, s) for c, _, s in want]:
        raise AssertionError(f"luna: {len(rows)} CSV rows against {len(want)} pooled "
                             "detections at or above the threshold, or not the same ones")
    err = 0.0
    for (cid, world, _), (_, centre, _) in zip(rows, want):
        geom = load_pickle(labels_dir / f"{cid}_geometry.pkl")
        back = mhd.world_to_voxel(world, geom["origin"], geom["spacing"])
        err = max(err, float(np.abs(back - centre).max()))
    if not err <= LUNA_ROUND_TRIP_TOL:
        raise AssertionError(f"luna: world coordinates map back {err} voxel from the box centres")
    return len(rows), err


def gt_as_predictions_cpm(task_dir, raw_dir, out_dir, series) -> dict:
    """The CPM of the ``series``' ground-truth boxes in the original
    geometry (``labelsTr/*_boxes_gt_orig.npz``) exported as predictions of
    probability 1."""
    from nndetection_tpu_torch.projects.Task016_Luna import prepare as task016
    from nndetection_tpu_torch.utils.io import save_pickle

    gt_dir = task_dir / "preprocessed" / "D3V001_3d" / "labelsTr"
    out_dir.mkdir(parents=True, exist_ok=True)
    for cid in series:
        boxes = np.load(gt_dir / f"{cid}_boxes_gt_orig.npz")["boxes"].astype(np.float64)
        save_pickle({"pred_boxes": boxes, "pred_scores": np.ones(len(boxes), np.float32),
                     "pred_labels": np.zeros(len(boxes), np.int64), "restored": True},
                    out_dir / f"{cid}_boxes.pkl")
    task016.export_cpm(out_dir, task_dir / "raw_splitted" / "labelsTr", out_dir / "gt.csv")
    return task016.score_cpm(out_dir / "gt.csv", raw_dir / "annotations.csv", series=series)


def phase_luna(device, n_cases=LUNA_CASES, inplane=LUNA_INPLANE, steps=6, val_batches=2,
               num_workers=4, planner=None) -> dict:
    """The LUNA-proxy cross-validation through ``run_proxy_cv`` on the card:
    ``n_cases`` generated LUNA16-layout cases of ``inplane``² voxels per
    slice, converted by Task016, ``run_prep`` (``num_workers`` workers, the
    planner's probe on the card), fold 0 of the 5-fold split trained one
    epoch of ``steps`` fed steps with ``val_batches`` validation batches and
    no SWA, swept, consolidated, its validation predictions materialized,
    pooled, exported and scored (CPM and ``run_evaluate``). Seconds, peak
    memory and kernel launches per stage. Checked: every validation series
    scored, the CSV (:func:`check_cpm_export`), the ground-truth boxes'
    CPM of 1.0, each stage's kernels (``LUNA_KERNELS``)."""
    import tempfile
    from pathlib import Path

    from nndetection_tpu_torch import pipeline
    from nndetection_tpu_torch.data import luna_proxy
    from nndetection_tpu_torch.ops import LAUNCHES
    from nndetection_tpu_torch.projects.Task016_Luna import prepare as task016
    from nndetection_tpu_torch.projects.Task016_Luna import proxy_cv

    seconds, peaks, launches, scored = {}, {}, {}, []
    meter = lambda name: stage_meter(seconds, peaks, launches, name)  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        with patched(luna_proxy, {"generate_luna_proxy": meter("generate")}), \
                patched(task016, {"convert": meter("convert")}), \
                patched(pipeline, {"run_prep": meter("prep"), "run_train": meter("train"),
                                   "run_sweep": meter("sweep"),
                                   "run_consolidate": meter("consolidate"),
                                   "materialize_val_predictions": meter("materialize")}), \
                patched(proxy_cv, {"pool_and_score": lambda fn: meter("score")(
                    capturing(scored)(fn))}):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            result = proxy_cv.run_proxy_cv(
                root, num_cases=n_cases, inplane=inplane, epochs=1, steps=steps, swa_epochs=0,
                val_steps=val_batches, warmup=10, folds=[0], device=device, planner=planner,
                num_workers=num_workers)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            luna_launches = dict(LAUNCHES)

        task_dir = root / proxy_cv.TASK_NAME
        model_dir = root / "models" / proxy_cv.TASK_NAME / proxy_cv.MODULE
        series = scored[0]["series"]
        val_ids = pipeline.make_splits([], task_dir / "preprocessed" / "splits_final.pkl")[0]["val"]
        cpm = result["cpm"]
        if scored[0]["missing"] or sorted(val_ids) != series or cpm.get(
                "num_scans", len(series)) != len(series):
            raise AssertionError(f"luna: scored {series} ({cpm.get('num_scans')} scans) of the "
                                 f"validation series {val_ids}; missing {scored[0]['missing']}")
        n_rows, trip_err = check_cpm_export(model_dir, task_dir / "raw_splitted" / "labelsTr")
        gt = gt_as_predictions_cpm(task_dir, root / "raw", root / "gt_predictions", series)
        if gt["cpm"] != 1.0 or not gt.get("num_annotations"):
            raise AssertionError(f"luna: the ground-truth boxes score {gt}")
        for stage, kernels in LUNA_KERNELS.items():
            not_run = [k for k in kernels if launches[stage].get(k, 0) == 0]
            if not_run:
                raise AssertionError(f"luna {stage}: kernels never launched: {not_run}")
        bad = [k for k, v in result["box_eval"].items() if not np.isfinite(v)]
        if bad or not np.isfinite(cpm["cpm"]):
            raise AssertionError(f"luna: scores not finite: {bad} {cpm}")
        epoch = result["fold_final_epochs"][0]

    cfg = result["config"]
    log(f"[luna] {n_cases} cases at inplane {inplane} through run_proxy_cv in {total:.2f} s; "
        "seconds per stage: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    log(f"[luna] plan: patch {cfg['patch_size']}, batch {cfg['batch_size']}, spacing "
        f"{[round(s, 4) for s in cfg['target_spacing']]}; fold 0: {epoch['steps']:.0f} fed steps "
        f"{epoch['epoch_time_s']:.3f} s = {epoch['epoch_time_s'] / epoch['steps']:.4f} s/step, "
        f"val mAP {epoch.get('mAP_IoU_0.10_0.50_0.05_MaxDet_100', float('nan')):.4f}")
    log(f"[luna] scored {len(series)} validation series {series}: CPM {cpm['cpm']:.4f}, FROC "
        f"{cpm['froc']}, {cpm.get('num_annotations', 0)} nodules, {cpm.get('num_fps', 0)} FPs; "
        f"box mAP {result['box_eval'].get('mAP_IoU_0.10_0.50_0.05_MaxDet_100', float('nan'))}")
    log(f"[luna] CSV: {n_rows} rows, every pooled detection at or above 0, world -> voxel "
        f"round trip within {trip_err:.2e} voxel; ground-truth boxes as predictions: CPM "
        f"{gt['cpm']} over {gt['num_annotations']} nodules")
    log("[luna] peak device memory GiB " + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items()))
    for stage in seconds:
        log(f"[luna] kernel launches in {stage}: {launches.get(stage, {})}")
    log(f"[luna] kernel launches in the whole run: {luna_launches}")
    return dict(launches=launches, seconds=seconds, result=result)


# the 2d phase: a raw 2D task of data/example.py with the geometry of the
# planning test's 2D case (tests/test_torch_planning.py: 0.7 x 0.7 mm,
# 512 x 480), from raw images to scores on the card
TWOD_TASK = "Task103_Example2D"
TWOD_IMAGE = (512, 480)
TWOD_SPACING = (0.7, 0.7)
TWOD_TRAIN, TWOD_TEST = 24, 4
TWOD_OBJECT_SIZE = (16, 64)  # pixels: 11-45 mm at 0.7 mm
TWOD_OBJECT_WIDTH = 4  # the wall of a hollow square, pixels
# the kernels each stage must launch: the probe, the training, the sweep's
# and the test split's predictions, the consolidation's sweep
TWOD_KERNELS = {"prep": TRAIN_KERNELS, "train": RUN_TRAIN_KERNELS, "sweep": PREDICT_KERNELS,
                "consolidate": CONSOLIDATE_KERNELS, "predict": PREDICT_KERNELS}
TWOD_REPORTED = TRAIN_KERNELS + ("nms_topk", "wbc_cluster")


def tiny_cfg_2d(**overrides):
    """The tiny float32 model in 2D: 4 stages, patch 64 x 64."""
    from nndetection_tpu_torch.models.retina_unet import RetinaUNetConfig

    return RetinaUNetConfig(**{**dict(
        dim=2, conv_kernels=((3, 3),) * 4, strides=((2, 2),) * 3, decoder_levels=(1, 2, 3),
        patch_size=(64, 64), anchor_width=((4, 8),) * 3, anchor_height=((4, 8),) * 3,
        anchor_depth=None, start_channels=8, fpn_channels=16, head_channels=16,
        topk_candidates=500, detections_per_img=20, dtype="float32"), **overrides})


def largest_call(calls: list, size):
    """A wrapper that keeps in ``calls[0]`` the arguments of the call with
    the largest ``size(args)``, cloned."""
    def wrap(fn):
        def call(*args):
            if not calls or size(args) > size(calls[0]):
                calls[:] = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)]
            return fn(*args)
        return call
    return wrap


def lifted_kernel_checks(device, nms_call, wbc_call, reps=10) -> dict:
    """#7 and the cluster kernel on 2D boxes (lifted to unit depth by their
    wrappers) against their plain versions on the card on the lifted boxes,
    bit for bit: the largest call of each in the 2d phase's predictions,
    and a seeded input of 1000 boxes with scores tied to 8 levels. Returns
    the kernels' device times at the real calls."""
    from nndetection_tpu_torch.ops import LAUNCHES, lift_2d
    from nndetection_tpu_torch.ops.nms import nms_topk, nms_topk_plain
    from nndetection_tpu_torch.ops.wbc_cluster import wbc_cluster, wbc_cluster_plain

    rng = np.random.RandomState(21)
    boxes, scores = nms_boxes(rng, 4, 1000)
    nms_cases = [("real", nms_call),
                 ("seeded 4 x 1000, 8-level scores",
                  (boxes[..., :4].contiguous().to(device),
                   ((scores * 8).floor() / 8).to(device), 0.5, 100))]
    seeded = wbc_inputs(rng, 1000, 2)
    seeded[0] = seeded[0][:, :4].contiguous()
    seeded[1] = (seeded[1] * 8).floor() / 8
    wbc_cases = [("real", wbc_call),
                 ("seeded 1000 x 2 classes, 8-level scores",
                  tuple(t.to(device) for t in seeded) + (2, 0.5, 0.0, 1.0))]
    out = {}
    for label, (b, sc, thr, max_out) in nms_cases:
        if b.shape[-1] != 4:
            raise AssertionError(f"2d nms_topk {label}: boxes {tuple(b.shape)}, not 2D")
        n0 = LAUNCHES["nms_topk"]
        idx, valid = nms_topk(b, sc, thr, max_out)
        torch.cuda.synchronize()
        steps = min(max_out, b.shape[1])
        p_idx, p_valid = nms_topk_plain(lift_2d(b), sc, thr, steps)
        if LAUNCHES["nms_topk"] != n0 + 1 or not (
                torch.equal(idx[:, :steps], p_idx.long()) and torch.equal(valid[:, :steps], p_valid)
                and not valid[:, steps:].any()):
            raise AssertionError(f"2d nms_topk {label}: not one launch, or indices or flags "
                                 "differ from the plain version on the lifted boxes")
        ms = median_ms(lambda: nms_topk(b, sc, thr, max_out), reps)
        log(f"[2d] nms_topk {label}: {b.shape[0]} images x {b.shape[1]} 2D boxes, max_out "
            f"{max_out}, threshold {thr}: {int(valid.sum())} kept, bits equal to the plain "
            f"version on the card; {ms:.4f} ms")
        out[f"nms_topk {label}"] = ms
    for label, args in wbc_cases:
        b, rest = args[0], args[6:]
        if b.shape[-1] != 4:
            raise AssertionError(f"2d wbc_cluster {label}: boxes {tuple(b.shape)}, not 2D")
        n0 = LAUNCHES["wbc_cluster"]
        got = wbc_cluster(*args)
        torch.cuda.synchronize()
        want = wbc_cluster_plain(lift_2d(b), *args[1:])
        want = (want[0][..., :4], want[1], want[2])
        if LAUNCHES["wbc_cluster"] != n0 + 1 or not all(
                torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"2d wbc_cluster {label}: not one launch, or outputs differ "
                                 "from the plain version on the lifted boxes")
        ms = median_ms(lambda: wbc_cluster(*args), reps)
        log(f"[2d] wbc_cluster {label}: {b.shape[0]} 2D boxes x {rest[0]} classes, iou "
            f"{rest[1]}: {int(got[2].sum())} clusters emitted, bits equal to the plain version "
            f"on the card; {ms:.4f} ms")
        out[f"wbc_cluster {label}"] = ms
    return out


def norm_checks_2d(device, cfg, batch, reps=5) -> float:
    """#1-#4 against their plain versions at the 2D plan's encoder stage
    shapes, ``[batch, H, W, C]`` bf16, every row (the 2D default schedule):
    in_stats within ``TOL["in_stats"]``, the apply and the two gradient
    kernels within their bf16 tolerances. Returns the largest error."""
    from nndetection_tpu_torch.models.encoder import encoder_channels, encoder_strides
    from nndetection_tpu_torch.ops.instance_norm import (
        in_apply, in_apply_plain, in_stats, in_stats_plain, plane_schedule)

    channels = encoder_channels(cfg.num_levels, cfg.start_channels, cfg.max_channels)
    strides = encoder_strides(cfg.num_levels, cfg.strides, cfg.dim)
    gd = torch.Generator(device=device).manual_seed(6)
    worst, shapes = 0.0, []
    for c, st in zip(channels, strides):
        h, w = (-(-p // s) for p, s in zip(cfg.patch_size, st))
        shape = (batch, h, w, c)
        x4 = (torch.randn(shape, generator=gd, device=device) * 2 + 1).to(torch.bfloat16)
        dy4 = torch.randn(shape, generator=gd, device=device).to(torch.bfloat16)
        gamma = torch.rand(c, generator=gd, device=device) + 0.5
        beta = torch.randn(c, generator=gd, device=device)
        start, step = plane_schedule(h, None)
        mean, var = in_stats(x4, start, step)
        pmean, pvar = in_stats_plain(x4, start, step)
        worst = max(worst, check_close(f"2d in_stats {list(shape)} mean", mean, pmean,
                                       **TOL["in_stats"]),
                    check_close(f"2d in_stats {list(shape)} var", var, pvar, **TOL["in_stats"]),
                    check_close(f"2d in_apply {list(shape)}", in_apply(x4, pmean, pvar, gamma, beta),
                                in_apply_plain(x4, pmean, pvar, gamma, beta),
                                **TOL["in_apply_bf16"]))
        errs, _ = _grad_kernels(x4, dy4, gamma, start, step, reps)
        worst = max([worst, *errs.values()])
        shapes.append(list(shape))
    log(f"[2d] #1-#4 at the 2D plan's stage shapes {shapes} bf16, every row: within their "
        f"tolerances, largest error {worst:.2e}")
    return worst


def phase_2d(device, image=TWOD_IMAGE, n_train=TWOD_TRAIN, n_test=TWOD_TEST, steps=6,
             val_batches=2, num_workers=4, planner=None, ds_batch=8) -> dict:
    """A raw 2D task to scores on the card, then the 2D kernels' checks, the
    tiny 2D model card vs CPU, and the deep-supervision segmenter.

    ``data/example.py`` writes ``n_train`` + ``n_test`` seeded ``image``
    cases at ``TWOD_SPACING`` mm, one object each (a square or a hollow
    square: two classes); ``run_prep`` (``num_workers`` workers, the
    planner's probe on the card) -> ``run_train`` (fold 0, one epoch of
    ``steps`` fed steps, ``val_batches`` validation batches, no SWA) ->
    ``run_sweep`` -> ``run_consolidate(num_folds=1)`` ->
    ``run_predict_test`` (4 flips) -> ``run_evaluate``: the plan, seconds per
    stage, s/step, peak memory, and the launches of #1-#4, #7 and the
    cluster kernel, each stage's kernels (``TWOD_KERNELS``) checked. Then
    :func:`lifted_kernel_checks` on the largest NMS and cluster calls of the
    predictions, :func:`norm_checks_2d` at the plan's stage shapes,
    :func:`phase_reference` on :func:`tiny_cfg_2d`, one deep-supervision
    train phase on the LUNA plan at ``ds_batch`` (bf16) and a tiny float32
    deep-supervision step card vs CPU."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from nndetection_tpu_torch import pipeline
    from nndetection_tpu_torch.core.boxes import nms as core_nms
    from nndetection_tpu_torch.core.boxes import wbc as core_wbc
    from nndetection_tpu_torch.data.example import generate_example_dataset
    from nndetection_tpu_torch.inference.tta import get_tta_flips
    from nndetection_tpu_torch.models.encoder import encoder_channels
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from nndetection_tpu_torch.modules import RetinaUNetV001
    from nndetection_tpu_torch.planning import planner as planner_mod
    from nndetection_tpu_torch.utils.io import load_pickle

    seconds, peaks, launches, probes = {}, {}, {}, []
    meter = lambda name: stage_meter(seconds, peaks, launches, name)  # noqa: E731
    nms_calls, wbc_calls = [], []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        task = generate_example_dataset(
            root / TWOD_TASK, num_train=n_train, num_test=n_test, image_size=image,
            object_size=TWOD_OBJECT_SIZE, object_width=TWOD_OBJECT_WIDTH, spacing=TWOD_SPACING)
        seconds["write"] = time.perf_counter() - t0
        model_dir = root / "models" / TWOD_TASK / "RetinaUNetV001"
        t0 = time.perf_counter()
        with patched(planner_mod, {"probe_train_step_estimate": recording_probe(probes)}):
            plan = meter("prep")(pipeline.run_prep)(task, num_workers=num_workers,
                                                    planner=planner, device=device)
        if plan.dim != 2 or len(plan.patch_size) != 2:
            raise AssertionError(f"2d: a {plan.dim}D plan, patch {plan.patch_size}")
        r = run_train_once(device, task, model_dir, steps, val_batches)
        seconds["train"], peaks["train"], launches["train"] = r["wall"], r["peak_gib"], r["launches"]
        by_images = lambda a: a[1].numel()  # noqa: E731
        with patched(core_nms, {"nms_topk": largest_call(nms_calls, by_images)}), \
                patched(core_wbc, {"wbc_cluster": largest_call(wbc_calls, by_images)}):
            meter("sweep")(pipeline.run_sweep)(task, model_dir, 0, device=device)
            meter("consolidate")(pipeline.run_consolidate)(task, model_dir, num_folds=1,
                                                           device=device)
            pred_dir = meter("predict")(pipeline.run_predict_test)(task, model_dir, device=device)
        preds = sorted(pred_dir.glob("*_boxes.pkl"))
        boxes_per_case = [load_pickle(p)["pred_boxes"].shape for p in preds]
        metrics, _ = meter("evaluate")(pipeline.run_evaluate)(task, pred_dir, split="Ts",
                                                              device=device)
        total = time.perf_counter() - t0
    cfg = RetinaUNetV001.model_config(plan)
    key = "mAP_IoU_0.10_0.50_0.05_MaxDet_100"
    if len(preds) != n_test or any(len(s) != 2 or s[1] != 4 for s in boxes_per_case):
        raise AssertionError(f"2d: predictions {boxes_per_case} for {n_test} test cases")
    if not np.isfinite(metrics[key]):
        raise AssertionError(f"2d: {key} {metrics[key]}")
    for stage, kernels in TWOD_KERNELS.items():
        not_run = [k for k in kernels if launches[stage].get(k, 0) == 0]
        if not_run:
            raise AssertionError(f"2d {stage}: kernels never launched: {not_run}")
    flips = len(get_tta_flips(2))
    if flips != 4 or nms_calls[0][1].shape[0] % flips:
        raise AssertionError(f"2d: {flips} flips, NMS over {nms_calls[0][1].shape[0]} images")
    totals = {k: sum(v.get(k, 0) for v in launches.values()) for k in TWOD_REPORTED}

    log(f"[2d] raw task: {n_train} + {n_test} seeded cases {list(image)} at {TWOD_SPACING} mm "
        f"(data/example.py: one object each, two classes), written in {seconds['write']:.2f} "
        f"s; run_prep to run_evaluate {total:.2f} s")
    log(f"[2d] plan: patch {plan.patch_size}, batch {plan.batch_size}, {cfg.num_levels} stages, "
        f"channels {encoder_channels(cfg.num_levels, cfg.start_channels, cfg.max_channels)}, "
        f"pool strides {plan.pool_strides}, decoder levels {list(plan.decoder_levels)}, "
        f"remat={plan.remat}, target spacing {plan.target_spacing}, anchors {plan.anchors}, "
        f"mem_compiled_bytes {plan.mem_compiled_bytes} ({plan.mem_compiled_bytes / 2 ** 30:.4f} GiB)")
    for p in probes:
        log(f"[2d] probe: batch {p['batch']} remat={p['remat']} patch {list(p['patch'])}: "
            f"{p['est'].total_bytes / 2 ** 30:.4f} GiB, {p['est'].breakdown['step_ms']:.2f} "
            f"ms/step (probe call {p['s']:.2f} s)")
    log("[2d] seconds per stage: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + f"; train {r['m']['steps']} fed steps {r['m']['epoch_time_s']:.3f} s = "
        f"{r['s_per_step']:.4f} s/step, {r['patches_per_s']:.2f} patches/s")
    log("[2d] peak device memory GiB: " + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items()))
    log(f"[2d] {len(preds)} test cases predicted with {flips} flips, 2D boxes per case "
        f"{[s[0] for s in boxes_per_case]}; {key} {metrics[key]:.4f}")
    for stage, delta in launches.items():
        log(f"[2d] kernel launches in {stage}: {delta}")
    log(f"[2d] launches of #1-#4, #7 and the cluster kernel in the whole run: {totals}")
    if not all(totals.values()):
        raise AssertionError(f"2d: kernels never launched: {totals}")

    times = lifted_kernel_checks(device, nms_calls[0], wbc_calls[0])
    norm_err = norm_checks_2d(device, cfg, plan.batch_size)
    phase_reference(device, tiny_cfg_2d(), case_shape=(96, 80), label="tiny float32 2D")

    ds = phase_train(device, batch=ds_batch, warmup=1, steps=2, label="train deep supervision",
                     cfg=dataclasses.replace(luna_cfg(), segmenter_deep_supervision=True))
    ds_tiny = dataclasses.replace(tiny_cfg(), segmenter_deep_supervision=True)
    params = spread(RetinaUNet(ds_tiny, torch.Generator().manual_seed(0))).state_dict()
    reference_train_step(device, ds_tiny, params, label="tiny float32 deep supervision")
    return dict(launches={**launches, "total": totals}, plan=plan, seconds=seconds, peaks=peaks,
                s_per_step=r["s_per_step"], times=times, norm_err=norm_err, ds=ds)


def profile_train_step(trainer, state, targets, out_dir, label="train") -> None:
    """Device time by kernel over one train step (``torch.profiler``), the
    table into ``out_dir/<label>_profile.txt``."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(state, [targets], 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels only: an operator's row repeats the time of the kernels it launched
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{label.replace(' ', '_')}_profile.txt").write_text(table)
    log(f"[profile] one {label} step: wall {wall:.4f} s under the profiler, device time "
        f"{device_us / 1e6:.4f} s ({100 * device_us / 1e6 / wall:.1f} % busy)")
    for line in table.splitlines()[:20]:
        log(f"[profile] {line}")


PHASES = ("build", "kernels", "conv", "norm", "nms", "wbc", "iou", "reference", "forward", "serve",
          "consolidate", "nms_mask", "sweep", "deploy", "train", "train_aug", "run_train",
          "multi", "prep", "cli", "luna", "2d", "serve_fused", "train_fused")
# the checks of one kernel alone, which ``kernels`` includes
KERNEL_PHASES = ("conv", "norm", "nms", "wbc", "iou")


def parse_phases(argv) -> tuple:
    """``--phases=a,b,...`` (default: all but ``conv``, ``norm``, ``nms``,
    ``wbc`` and ``iou``, which ``kernels`` includes: #5's, #1's, #7's, the
    cluster kernel's and #6's checks alone).
    ``nms_mask`` runs on ``consolidate``'s ensemblers, so it brings that
    phase along."""
    arg = next((a.split("=", 1)[1] for a in argv if a.startswith("--phases=")), None)
    if arg is None:
        return tuple(p for p in PHASES if p not in KERNEL_PHASES)
    chosen = set(arg.split(","))
    unknown = chosen - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; known: {','.join(PHASES)}")
    if "nms_mask" in chosen:
        chosen.add("consolidate")
    return tuple(p for p in PHASES if p in chosen)


def main() -> None:
    times_spec = next((a.split("=", 1)[1] for a in sys.argv[1:]
                       if a.startswith("--suppression-times=")), None)
    if times_spec is not None:  # another tree's #6, #8 and keep-scan times
        return suppression_times_worker(json.loads(times_spec))
    from nndetection_tpu_torch.ops import LAUNCHES

    worker = next((a.split("=", 1)[1] for a in sys.argv[1:]
                   if a.startswith("--multi-worker=")), None)
    if worker is not None:  # one rank of the multi phase
        return multi_worker(json.loads(worker))
    parent = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--parent=")), None)
    profile_dir = next((a.split("=", 1)[1] for a in sys.argv[1:]
                        if a.startswith("--profile=")), None)
    phases = parse_phases(sys.argv[1:])
    smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    launches, summary, train, fed, single = {}, None, None, None, None
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        LAUNCHES.clear()
        summary = phase_kernels(device)
        launches["kernels"] = dict(LAUNCHES)
    else:
        if "conv" in phases:
            conv_kernel_checks(device)
        if "norm" in phases:
            norm_kernel_checks(device)
        if "nms" in phases:
            nms_kernel_checks(device)
        if "wbc" in phases:
            wbc_kernel_checks(device)
        if "iou" in phases:
            iou_kernel_checks(device)
    if parent is not None and ("kernels" in phases or "iou" in phases):
        suppression_parent_comparison(device, parent)
    if "reference" in phases:
        phase_reference(device)
        phase_reference_fused(device)
    if "forward" in phases:
        phase_forward(device)
    if "serve" in phases:
        launches["serve"] = phase_serve(device)[0]
    if "consolidate" in phases:
        launches["consolidate"], ensemblers = phase_consolidate(device)
    if "nms_mask" in phases:
        launches["nms mask"] = phase_nms_mask(device, ensemblers["BoxEnsemblerSelective"])
    if "sweep" in phases:
        launches["sweep"] = phase_sweep(device)
    if "deploy" in phases:
        launches["deploy"] = phase_deploy(device)
    if "train" in phases:
        train = phase_train(device, profile_dir=profile_dir)
        launches["train"] = train["launches"]
    if "train_aug" in phases:
        fed = phase_train_aug(device, train)
        launches["train aug"] = fed["launches"]
    if "run_train" in phases:
        rt = phase_run_train(device)
        launches["run_train"], single = rt["launches"], rt["full"]
    if "multi" in phases:
        launches["multi"] = phase_multi(device, single)["launches"]
    if "prep" in phases:
        launches["prep"] = phase_prep(device, prepared=train, fed=fed)["launches"]
    if "cli" in phases:
        launches["cli"] = phase_cli(device)["launches"]
    if "luna" in phases:
        launches["luna"] = phase_luna(device)["launches"]
    if "2d" in phases:
        launches["2d"] = phase_2d(device)["launches"]
    if "serve_fused" in phases:
        launches["serve fused"] = phase_serve_fused(device)
    if "train_fused" in phases:
        launches["train fused"] = phase_train_fused(device, train,
                                                    profile_dir=profile_dir)["launches"]
    # each kernel's launches in the phase that drives it: NMS in serving,
    # the instance norm in training, #5 in the fused training, the cluster
    # kernel in the consolidation, #8 and the keep-scan in the NMS mask; #6,
    # which no path launches, in the kernels phase
    drives = {"nms_topk": "serve", "conv3d_in_stats": "train fused",
              "iou_matrix": "kernels", "wbc_cluster": "consolidate",
              "suppression_matrix": "nms mask", "nms_keep_scan": "nms mask"}
    if summary is not None and all(drives.get(n, "train") in launches for n in KERNELS):
        kernels = []
        for name in KERNELS:
            phase = drives.get(name, "train")
            row = summary[name]
            kernels.append({"name": name, **KERNELS[name], "launches": launches[phase][name],
                            "phase": phase, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                            "shape": row["shape"],
                            **{k: row[k] for k in ("device_ms", "host_ms") if k in row},
                            **({"run_train_launches": launches["run_train"].get(name, 0)}
                               if "run_train" in launches else {}),
                            **({"prep_launches": {k: v.get(name, 0)
                                                  for k, v in launches["prep"].items()}}
                               if "prep" in launches else {}),
                            **({"cli_launches": {k: v.get(name, 0)
                                                 for k, v in launches["cli"].items()}}
                               if "cli" in launches else {}),
                            **({"luna_launches": {k: v.get(name, 0)
                                                  for k, v in launches["luna"].items()}}
                               if "luna" in launches else {}),
                            **({"2d_launches": {k: v.get(name, 0)
                                                for k, v in launches["2d"].items()}}
                               if "2d" in launches else {}),
                            **({"multi_launches": {
                                "a": launches["multi"]["a"].get(name, 0),
                                "b": [r.get(name, 0) for r in launches["multi"]["b"]],
                                "c_norm": [r.get(name, 0)
                                           for r in launches["multi"]["c_norm"]]}}
                               if "multi" in launches else {})})
        json_line({"kernels": kernels})
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
