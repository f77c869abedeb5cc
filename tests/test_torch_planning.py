"""The port's planner against the JAX package's: ``architecture.py``,
``anchors_opt.py`` (the same parameters and score from the same seed) and
``analytic_estimate``, over 3D isotropic, 3D anisotropic and 2D cases;
``plan_experiment`` field by field at the same budget without the probe;
the four branches of the probe's decision under the same injected
``MemoryEstimate``s on both sides (the probes themselves differ by design:
the port measures on the card, the JAX package reads XLA's analysis; the
port's steps with the plan's GT slots, the JAX package's with 32); the
forced patch with ``n_model`` 2 and 4; ``plan_lowres``; and the defaults
that tie the planner and the probe to the card. The probe itself is tested
on the card by ``tests/test_torch_probe_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from nndetection_tpu.data.dataset import DatasetInfo as JInfo
from nndetection_tpu.planning import anchors_opt as janchors
from nndetection_tpu.planning import architecture as jarch
from nndetection_tpu.planning import estimator as jest
from nndetection_tpu.planning import planner as jplanner
from nndetection_tpu_torch.data.dataset import DatasetInfo as TInfo
from nndetection_tpu_torch.planning import anchors_opt as tanchors
from nndetection_tpu_torch.planning import architecture as tarch
from nndetection_tpu_torch.planning import estimator as test_
from nndetection_tpu_torch.planning import planner as tplanner

torch.set_num_threads(1)

BUDGET = jest.DEFAULT_BUDGET
CASES = {  # spacing (transposed order), median shape
    "iso3d": ((1.0, 1.0, 1.0), (160, 160, 160)),
    "aniso3d": ((3.0, 0.8, 0.8), (64, 256, 256)),
    "2d": ((0.7, 0.7), (512, 480)),
}


def props(case, n_cases=6, seed=0):
    """Synthetic dataset properties of ``case`` (as ``analyze_dataset``
    gives them)."""
    rng = np.random.RandomState(seed)
    spacing, shape = (np.asarray(v, np.float64) for v in CASES[case])
    dim = len(spacing)
    boxes = []
    for _ in range(40):
        s = rng.uniform(5, 20, dim)
        boxes.append([0, 0, s[0], s[1]] + ([0, s[2]] if dim == 3 else []))
    return {
        "all_spacings": np.tile(spacing, (n_cases, 1)) * rng.uniform(0.9, 1.1, (n_cases, dim)),
        "all_shapes": np.tile(shape, (n_cases, 1)),
        "intensity_properties": {0: {"mean": 0.0, "sd": 1.0, "percentile_00_5": -2.0,
                                     "percentile_99_5": 2.0, "min": -5.0, "max": 5.0}},
        "boxes_mm": np.asarray(boxes),
        "instance_classes": rng.randint(0, 2, 40),
        "per_case": {f"c{i}": {"num_instances": int(rng.randint(1, 5))} for i in range(n_cases)},
    }


def infos(case, modality="CT"):
    kw = dict(task="T", dim=len(CASES[case][0]), modalities={0: modality},
              labels={0: "a", 1: "b"})
    return TInfo(**kw), JInfo(**kw)


def planners(**kw):
    """The port's planner on the CPU and the JAX package's, at the same
    budget."""
    kw.setdefault("hbm_budget", BUDGET)
    kw.setdefault("anchor_budget", 100)
    return tplanner.Planner(device="cpu", **kw), jplanner.Planner(**kw)


def same_plan(got, want):
    assert type(got) is tplanner.Plan
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ----------------------------------------------------- architecture, anchors
@pytest.mark.parametrize("case", sorted(CASES))
def test_architecture_matches_jax(case):
    spacing, shape = CASES[case]
    patch = tarch.initial_patch_size(spacing, shape)
    assert patch == jarch.initial_patch_size(spacing, shape)
    for p in (patch, [max(8, v // 3) for v in patch]):
        got = tarch.get_pool_and_conv_props(spacing, p)
        assert got == jarch.get_pool_and_conv_props(spacing, p)
        assert tarch.shrink_largest_axis(got[3], got[2]) == jarch.shrink_largest_axis(
            got[3], got[2])
        n = len(got[1])
        assert tarch.plan_decoder_levels(n) == jarch.plan_decoder_levels(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_anchor_search_matches_jax(case):
    dim = len(CASES[case][0])
    rng = np.random.RandomState(1)
    sizes = np.concatenate([rng.uniform(4, 9, (30, dim)), rng.uniform(15, 30, (30, dim)),
                            [[200.0] * dim]])
    strides = [[1.0] * dim, [2.0] * dim, [4.0, 4.0] + [2.0] * (dim - 2)]
    filtered = tanchors.filter_boxes_by_volume(sizes)
    np.testing.assert_array_equal(filtered, janchors.filter_boxes_by_volume(sizes))
    got = tanchors.optimize_anchors(filtered, strides, budget=300, seed=3)
    want = janchors.optimize_anchors(filtered, strides, budget=300, seed=3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[1] > 0.5
    empty = tanchors.optimize_anchors(np.zeros((0, dim)), strides)
    np.testing.assert_array_equal(empty[0], janchors.optimize_anchors(np.zeros((0, dim)),
                                                                      strides)[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_analytic_estimate_matches_jax(case):
    spacing, shape = CASES[case]
    pool, kernels, _, patch = jarch.get_pool_and_conv_props(
        spacing, jarch.initial_patch_size(spacing, shape))
    kw = dict(patch_size=patch, batch_size=4, in_channels=2, conv_kernels=kernels,
              strides=pool, decoder_levels=jarch.plan_decoder_levels(len(kernels)),
              num_classes=3)
    got, want = test_.analytic_estimate(**kw), jest.analytic_estimate(**kw)
    assert (got.total_bytes, got.breakdown) == (want.total_bytes, want.breakdown)
    assert got.fits(BUDGET) == want.fits(BUDGET)


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("case, modality", [("iso3d", "CT"), ("aniso3d", "MR"), ("2d", "CT2")])
def test_plan_experiment_matches_jax(case, modality):
    tp, jp = planners(compile_validate=False)
    tinfo, jinfo = infos(case, modality)
    got, want = tp.plan_experiment(props(case), tinfo), jp.plan_experiment(props(case), jinfo)
    same_plan(got, want)
    assert got.mem_compiled_bytes == 0


def test_plan_experiment_small_budget_shrinks_like_jax():
    big = planners(compile_validate=False)[0].plan_experiment(props("iso3d"), infos("iso3d")[0])
    tp, jp = planners(compile_validate=False, hbm_budget=big.mem_estimate_bytes // 3)
    got = tp.plan_experiment(props("iso3d"), infos("iso3d")[0])
    same_plan(got, jp.plan_experiment(props("iso3d"), infos("iso3d")[1]))
    assert np.prod(got.patch_size) < np.prod(big.patch_size)


@pytest.mark.parametrize("n_model", [2, 4])
def test_forced_patch_matches_jax(n_model):
    """A pinned patch too large for one device at the budget gains
    ``n_model``; the budget is set so that the per-device slab of
    ``n_model`` fits and that of ``n_model // 2`` does not."""
    spacing = np.ones(3)
    patch = [96, 128, 128]
    pool, kernels, _, _ = jarch.get_pool_and_conv_props(spacing, patch)
    dls = jarch.plan_decoder_levels(len(kernels))
    slab = lambda n: jest.analytic_estimate(  # noqa: E731
        patch_size=[patch[0] // n, *patch[1:]], batch_size=4, in_channels=1,
        conv_kernels=kernels, strides=pool, decoder_levels=dls, num_classes=2).total_bytes
    budget = (slab(n_model) + slab(n_model // 2)) // 2
    tp, jp = planners(force_patch_size=patch, hbm_budget=budget, compile_validate=False)
    got = tp.plan_experiment(props("iso3d"), infos("iso3d")[0])
    same_plan(got, jp.plan_experiment(props("iso3d"), infos("iso3d")[1]))
    assert got.n_model == n_model
    tp, _ = planners(force_patch_size=patch, hbm_budget=slab(8) // 2, max_model_axis=4)
    with pytest.raises(ValueError, match="does not fit"):
        tp.plan_experiment(props("iso3d"), infos("iso3d")[0])


def test_plan_lowres_matches_jax():
    tp, jp = planners(compile_validate=False)
    tinfo, jinfo = infos("iso3d")
    p = props("iso3d")
    got = tp.plan_lowres(tp.plan_experiment(p, tinfo), p, tinfo)
    want = jp.plan_lowres(jp.plan_experiment(p, jinfo), p, jinfo)
    same_plan(got, want)
    assert got.plan_id == "D3V001_3dlr1" and not got.requires_lowres


# ------------------------------------------------- the probe's four branches
ARCH = {
    "patch_size": [32, 32, 32],
    "pool_strides": [[2, 2, 2], [2, 2, 2]],
    "conv_kernels": [[3, 3, 3]] * 3,
    "decoder_levels": (1, 2),
    "batch_size": 8,
    "mem_estimate_bytes": 10**9,
    "mem_compiled_bytes": 0,
}
GIB = 1024**3
VERDICTS = {  # (batch, remat) -> the injected estimate, or None
    "no_remat_fits": lambda b, remat: jest.MemoryEstimate(2 * GIB, {}),
    "batch_halved": lambda b, remat: jest.MemoryEstimate(b * 2 * GIB, {}),
    "patch_shrunk": lambda b, remat: jest.MemoryEstimate(10**12, {}),
    "unavailable": lambda b, remat: None,
}


@pytest.mark.parametrize("branch", sorted(VERDICTS))
def test_probe_branches_match_jax(monkeypatch, branch):
    calls = {"port": [], "jax": []}

    def fake(side):
        def probe(cfg, batch_size, max_instances=32, **kw):
            calls[side].append((batch_size, cfg.remat, tuple(cfg.patch_size), max_instances))
            est = VERDICTS[branch](batch_size, cfg.remat)
            if est is None or side == "jax":
                return est
            return test_.MemoryEstimate(est.total_bytes, est.breakdown)
        return probe

    monkeypatch.setattr(tplanner, "probe_train_step_estimate", fake("port"))
    monkeypatch.setattr(jplanner, "probe_train_step_estimate", fake("jax"))
    tp, jp = planners(compile_validate=True, batch_size=4)
    got = tp._compile_validate_arch(dict(ARCH), 1, 2, target_spacing=np.ones(3))
    want = jp._compile_validate_arch(dict(ARCH), 1, 2, target_spacing=np.ones(3))
    assert got == want
    assert calls["port"] == calls["jax"]
    if branch == "no_remat_fits":
        assert got["remat"] is False and calls["port"] == [(8, False, (32, 32, 32), 32)]
    if branch == "batch_halved":
        assert got["batch_size"] == 4 and got["mem_compiled_bytes"] == 8 * GIB
    if branch == "patch_shrunk":
        assert got["batch_size"] == 4 and np.prod(got["patch_size"]) < 32**3
    if branch == "unavailable":
        assert got == ARCH


def test_whole_plan_under_injected_verdict_matches_jax(monkeypatch):
    """``plan_experiment`` with the probe on both sides, batch halved once."""
    def probe(cfg, batch_size, max_instances=32, **kw):
        return jest.MemoryEstimate(batch_size * GIB, {})

    monkeypatch.setattr(jplanner, "probe_train_step_estimate", probe)
    monkeypatch.setattr(tplanner, "probe_train_step_estimate", probe)
    tp, jp = planners(compile_validate=True, hbm_budget=10 * GIB)
    got = tp.plan_experiment(props("iso3d"), infos("iso3d")[0])
    same_plan(got, jp.plan_experiment(props("iso3d"), infos("iso3d")[1]))
    assert got.mem_compiled_bytes == got.batch_size * GIB > 0


def test_probe_steps_with_the_plans_gt_slots(monkeypatch):
    """The port's probe steps with the plan's ``max_instances_per_patch``
    GT slots, where the JAX planner's takes 32 whatever the plan trains
    with (repaired in the port only); under the same injected verdicts the
    plans are equal."""
    slots = {"port": [], "jax": []}

    def fake(side):
        def probe(cfg, batch_size, max_instances=32, **kw):
            slots[side].append(max_instances)
            return jest.MemoryEstimate(batch_size * GIB, {})
        return probe

    monkeypatch.setattr(tplanner, "probe_train_step_estimate", fake("port"))
    monkeypatch.setattr(jplanner, "probe_train_step_estimate", fake("jax"))
    tp, jp = planners(compile_validate=True, hbm_budget=10 * GIB)
    got = tp.plan_experiment(props("iso3d"), infos("iso3d")[0])
    same_plan(got, jp.plan_experiment(props("iso3d"), infos("iso3d")[1]))
    assert got.max_instances_per_patch == 8
    assert slots["port"] == [8] * len(slots["jax"]) and slots["jax"] == [32] * len(slots["jax"])
    assert slots["port"]


def test_out_of_memory_fits_no_budget(monkeypatch):
    """An out-of-memory verdict halves the batch however small its
    ``total_bytes`` (what the step had reached when it failed)."""
    seen = []

    def probe(cfg, batch_size, max_instances=32, device=None):
        seen.append(batch_size)
        return test_.MemoryEstimate(GIB, {}, out_of_memory=batch_size > 4)

    monkeypatch.setattr(tplanner, "probe_train_step_estimate", probe)
    tp, _ = planners(compile_validate=True, batch_size=4)
    arch = tp._compile_validate_arch(dict(ARCH), 1, 2, target_spacing=np.ones(3))
    assert seen == [8, 8, 4] and arch["batch_size"] == 4 and "remat" not in arch
    assert not test_.MemoryEstimate(0, {}, out_of_memory=True).fits(10**15)


# --------------------------------------------------------------- the defaults
def test_planner_and_probe_default_to_the_card(monkeypatch):
    with pytest.raises(ValueError, match="hbm_budget"):
        tplanner.Planner(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplanner.Planner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_.probe_train_step_estimate(tplanner.Planner(hbm_budget=BUDGET, device="cpu")
                                        ._proxy_model_config(ARCH, 1, 2), 2)
    tp = tplanner.Planner(hbm_budget=BUDGET, device="cpu")
    assert tp.compile_validate == "auto"
    cfg = tp._proxy_model_config(ARCH, 1, 2)
    assert test_.probe_train_step_estimate(cfg, 2, device="cpu") is None
    assert tp._compile_validate_arch(dict(ARCH), 1, 2, np.ones(3)) == ARCH  # auto: no probe
    assert tplanner.Planner(hbm_budget=BUDGET, device="cpu", compile_validate=True)\
        ._compile_validate_arch(dict(ARCH), 1, 2, np.ones(3)) == ARCH  # nothing to probe


def test_probe_batch_shapes():
    cfg = tplanner.Planner(hbm_budget=BUDGET, device="cpu")._proxy_model_config(ARCH, 1, 2)
    batch = test_.probe_batch(cfg, 3, 32, torch.device("cpu"))
    assert batch["images"].shape == (3, 32, 32, 32, 1) and batch["images"].dtype == torch.float32
    assert batch["gt_boxes"].shape == (3, 32, 6) and batch["gt_mask"].shape == (3, 32)
    assert batch["gt_mask"].sum(1).tolist() == [1, 1, 1] and batch["seg"].shape == (3, 32, 32, 32)
