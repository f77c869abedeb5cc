"""Smoke run of the PyTorch port (``nndetection_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its findings:

1. device: the card's name and power limit (``nvidia-smi``); fails without
   CUDA, never falls back to the CPU;
2. build: compiles the CUDA kernels from ``nndetection_tpu_torch/csrc`` into
   the git-ignored ``nndetection_tpu_torch/_build`` and loads them;
3. kernels: every kernel of the serving path against its plain PyTorch
   version on the card, at the shapes of that path (instance-norm statistics
   and apply at the LUNA plan's stage shapes, bf16 and f32, exact and
   plane-subsampled; NMS at 16 x 1000 and 2 x 10000 boxes), with median
   times from CUDA events;
4. reference: a tiny float32 model on the card against the same model on
   the CPU (forward, post-processing, whole-case prediction);
5. forward: the full-width LUNA-plan RetinaUNet (patch 96x128x128, 6
   stages, 32..320 channels, 27 anchors/position) in bf16 from a seeded
   initialization; every output finite;
6. serve: ``Predictor.predict_case`` on a 140x320x320 case without TTA and a
   96x256x256 case with 8-flip TTA, each twice (first call, then warm); the
   kernels' launch counts are reset just before and must all have risen.

Then one JSON line with each kernel's route, source, launches in phase 6,
max error and times, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and no result line is printed.
"""
from __future__ import annotations

import json
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
NMS_SHAPES = [(16, 1000, 100), (2, 10000, 100)]
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
}
KERNELS = {
    "in_stats": dict(route="triton", source="nndetection_tpu_torch/ops/instance_norm.py",
                     replaces="nndetection_tpu/ops/pallas_norm.py:72"),
    "in_apply": dict(route="triton", source="nndetection_tpu_torch/ops/instance_norm.py",
                     replaces="nndetection_tpu/ops/pallas_norm.py:105"),
    "nms_topk": dict(route="cuda", source="nndetection_tpu_torch/csrc/nms_topk.cu",
                     replaces="nndetection_tpu/ops/pallas_ops.py:132"),
}


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
    from nndetection_tpu_torch.ops import _build

    lib = _build.library_path()
    if lib.exists():  # build from the checkout's sources, never a leftover
        lib.unlink()
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] nvcc {time.perf_counter() - t0:.2f} s -> {lib.relative_to(_build.CSRC.parents[1])}")
    for line in _build.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(device, stages=LUNA_STAGES, nms_shapes=NMS_SHAPES, reps=20):
    """Each kernel against its plain version; returns per-kernel max error
    and the times at the main path's representative shape (stage 0, bf16,
    the default plane_sub:8 schedule for IN; 16 x 1000 boxes for NMS)."""
    from nndetection_tpu_torch.ops.instance_norm import (
        in_apply, in_apply_plain, in_stats, in_stats_plain, plane_schedule)
    from nndetection_tpu_torch.ops.nms import nms_topk, nms_topk_plain

    summary = {k: {"max_abs_err": 0.0} for k in KERNELS}
    g = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    for si, shape in enumerate(stages):
        b, d, h, w, c = shape
        base = torch.randn(shape, generator=g) * 2 + 1
        gamma = (torch.rand(c, generator=g) + 0.5).to(device)
        beta = torch.randn(c, generator=g).to(device)
        for dtype in (torch.bfloat16, torch.float32):
            x4 = base.to(device, dtype).view(b, d, h * w, c)
            for stride in (None, 8):
                start, step = plane_schedule(d, stride)
                mean, var = in_stats(x4, start, step)
                pmean, pvar = in_stats_plain(x4, start, step)
                e_stats = max(check_close(f"in_stats {shape} {dtype} {stride}", mean, pmean, **TOL["in_stats"]),
                              check_close(f"in_stats var {shape} {dtype} {stride}", var, pvar, **TOL["in_stats"]))
                y = in_apply(x4, pmean, pvar, gamma, beta)
                py = in_apply_plain(x4, pmean, pvar, gamma, beta)
                tol = TOL["in_apply_f32" if dtype == torch.float32 else "in_apply_bf16"]
                e_apply = check_close(f"in_apply {shape} {dtype}", y, py, **tol)
                summary["in_stats"]["max_abs_err"] = max(summary["in_stats"]["max_abs_err"], e_stats)
                summary["in_apply"]["max_abs_err"] = max(summary["in_apply"]["max_abs_err"], e_apply)
                times = {
                    "in_stats": median_ms(lambda: in_stats(x4, start, step), reps),
                    "in_stats_plain": median_ms(lambda: in_stats_plain(x4, start, step), reps),
                    "in_apply": median_ms(lambda: in_apply(x4, pmean, pvar, gamma, beta), reps),
                    "in_apply_plain": median_ms(lambda: in_apply_plain(x4, pmean, pvar, gamma, beta), reps),
                }
                log(f"[kernels] instance norm {shape} {str(dtype)[6:]} planes {start}::{step}: "
                    f"stats err {e_stats:.2e} {times['in_stats']:.4f} ms (plain {times['in_stats_plain']:.4f}) | "
                    f"apply err {e_apply:.2e} {times['in_apply']:.4f} ms (plain {times['in_apply_plain']:.4f})")
                if si == 0 and dtype == torch.bfloat16 and stride == 8:
                    for k in ("in_stats", "in_apply"):
                        summary[k].update(ms=times[k], plain_ms=times[k + "_plain"],
                                          shape=f"{list(shape)} bf16 planes {start}::{step}")
    log(f"[kernels] instance norm checks took {time.perf_counter() - t0:.1f} s (Triton compiles included)")

    rng = np.random.RandomState(0)
    for ni, (n_img, n, max_out) in enumerate(nms_shapes):
        ctr = rng.uniform(10, 300, (n_img, n, 3))
        sz = rng.uniform(2, 25, (n_img, n, 3))
        boxes = torch.from_numpy(np.stack([
            ctr[..., 0] - sz[..., 0], ctr[..., 1] - sz[..., 1], ctr[..., 0] + sz[..., 0],
            ctr[..., 1] + sz[..., 1], ctr[..., 2] - sz[..., 2], ctr[..., 2] + sz[..., 2],
        ], -1).astype(np.float32)).to(device)
        scores = torch.from_numpy(rng.rand(n_img, n).astype(np.float32))
        scores[torch.from_numpy(rng.rand(n_img, n) < 0.1)] = float("-inf")
        scores = scores.to(device)
        idx, valid = nms_topk(boxes, scores, 0.6, max_out)
        pidx, pvalid = nms_topk_plain(boxes, scores, 0.6, max_out)
        if not (torch.equal(idx, pidx.long()) and torch.equal(valid, pvalid)):
            raise AssertionError(f"nms_topk {n_img}x{n}: indices or valid flags differ")
        ms = median_ms(lambda: nms_topk(boxes, scores, 0.6, max_out), reps)
        plain_ms = median_ms(lambda: nms_topk_plain(boxes, scores, 0.6, max_out), max(3, reps // 4), 1)
        log(f"[kernels] nms_topk images {n_img} boxes {n} max_out {max_out}: indices identical, "
            f"{int(valid.sum())} kept, {ms:.4f} ms (plain {plain_ms:.4f})")
        if ni == 0:
            summary["nms_topk"].update(ms=ms, plain_ms=plain_ms,
                                       shape=f"{n_img} images x {n} boxes, max_out {max_out}")
    return summary


def spread(model, scale=100.0):
    """Scale the classifier's output conv, so that scores spread and top
    scores saturate: at initialization all scores sit within ~1e-2 of the
    prior, where float32 differences between two devices reorder near-equal
    scores and the greedy NMS turns that into different kept boxes."""
    with torch.no_grad():
        model.classifier.out.weight.mul_(scale)
    return model


def phase_reference(device) -> None:
    """The tiny float32 model on the card against the CPU (plain kernels,
    CPU convolutions), TF32 off."""
    from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet, batched_postprocess

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_cfg()
    cpu_model = spread(RetinaUNet(cfg, torch.Generator().manual_seed(0)).eval())
    dev_model = RetinaUNet(cfg).to(device).eval()
    dev_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).standard_normal((2, 32, 32, 32, 1)).astype(np.float32))
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
    case = np.random.RandomState(3).standard_normal((1, 48, 48, 48)).astype(np.float32)
    bundle = [ModelBundle(cfg=cfg, params=cpu_model.state_dict())]
    for tta in (False, True):
        rc = Predictor(bundle, tta=tta, device="cpu").predict_case(case)
        rg = Predictor(bundle, tta=tta, device=device).predict_case(case)
        if len(rc["pred_scores"]) != len(rg["pred_scores"]) or not len(rc["pred_scores"]):
            raise AssertionError(f"reference predict_case tta={tta}: {len(rg['pred_scores'])} "
                                 f"detections on the card, {len(rc['pred_scores'])} on the CPU")
        oc, og = np.argsort(-rc["pred_scores"], kind="stable"), np.argsort(-rg["pred_scores"], kind="stable")
        errs[f"case_tta{int(tta)}"] = max(
            check_close("case boxes", torch.from_numpy(rg["pred_boxes"][og]), torch.from_numpy(rc["pred_boxes"][oc]), 0, 1e-3),
            check_close("case scores", torch.from_numpy(rg["pred_scores"][og]), torch.from_numpy(rc["pred_scores"][oc]), 0, 1e-3))
    log("[reference] tiny float32 model, card vs CPU (TF32 off), max abs err: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


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


def phase_serve(device, cases=(((140, 320, 320), False), ((96, 256, 256), True)),
                patch=(96, 128, 128)):
    from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from nndetection_tpu_torch.ops import LAUNCHES

    cfg = luna_cfg(patch)
    params = RetinaUNet(cfg, torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.RandomState(0)
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
        boxes = res["pred_boxes"]
        if not (np.isfinite(boxes).all() and np.isfinite(res["pred_scores"]).all()):
            raise AssertionError("serve: non-finite detections")
        if len(boxes) and ((boxes[:, [0, 1, 4]] < -1e-3).any() or
                           (boxes[:, [2, 3, 5]] > np.asarray(shape)[[0, 1, 2]] + 1e-3).any()):
            raise AssertionError("serve: boxes outside the case")
        log(f"[serve] case {shape} tta={tta}: first {seconds[0]:.4f} s, warm {seconds[1]:.4f} s "
            f"({60 / seconds[1]:.1f} volumes/min), {n_tiles} tiles x "
            f"{len(predictor.tta_flips)} flips, {predictor.tiles_per_call} tiles per call, "
            f"{len(boxes)} detections")
    launches = dict(LAUNCHES)
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched on the main path: {missing}")
    log(f"[serve] kernel launches during serve: {launches}")
    return launches


def main() -> None:
    smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    summary = phase_kernels(device)
    phase_reference(device)
    phase_forward(device)
    launches = phase_serve(device)
    kernels = [
        {"name": name, **KERNELS[name], "launches": launches[name],
         "max_abs_err": summary[name]["max_abs_err"], "ms": summary[name]["ms"],
         "plain_ms": summary[name]["plain_ms"], "shape": summary[name]["shape"]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
