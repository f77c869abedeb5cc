"""The port on a tiny ProstateX-like plan against the benchmark's plain
reference (``benchmark/reference/``), on the CPU: anisotropic stages
(kernels (1,3,3) then (3,3,3), strides (1,2,2) then (2,2,2)), 4 input
sequences, 2 classes, dummy-2D augmentation, float32, seeded random
weights. The forward, one train step, the augmentation and targets, the
4-sequence pool's cut against the cases on disk, the ``train_pool_mr``
cell through the benchmark's harness, and the anchor spans and counter of
a train step.
"""
import copy
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference import augment as ref_augment  # noqa: E402
from benchmark.reference import detect  # noqa: E402
from benchmark.reference import gt_prep as ref_gt  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.reference.model import Net, param_specs  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from benchmark.traffic import generate_mr  # noqa: E402

torch.set_num_threads(1)

PATCH = [8, 32, 32]
CHANNELS = 4
MIX = {"kind": "train_mr_cases", "n_cases": 4, "shape": [12, 72, 76], "instances": [1, 3],
       "radius": [[1.0, 2.5], [3.0, 7.0], [3.0, 7.0]], "classes": 2,
       "contrast": [-1.5, -2.0, 1.5, 2.5], "storage": "float16",
       "resident_cases": 4, "swaps_per_epoch": 0, "steps_per_epoch": 2}


def tiny_mr_config() -> dict:
    """``tiny3d`` made anisotropic, 4-sequence, 2-class and dummy-2D."""
    config = copy.deepcopy(tiny.config("tiny3d"))
    config["name"] = "tinymr"
    config["model"].update(
        in_channels=CHANNELS, classifier_classes=2, seg_classes=2,
        conv_kernels=[[1, 3, 3], [3, 3, 3], [3, 3, 3]], strides=[[1, 2, 2], [2, 2, 2]],
        decoder_levels=[1, 2], patch_size=PATCH,
        anchor_width=[[1.5, 3.0], [3.0, 6.0]], anchor_height=[[4.0, 8.0], [8.0, 16.0]],
        anchor_depth=[[4.0, 8.0], [8.0, 16.0]])
    config["dummy_2d"] = True
    config["max_instances_per_patch"] = 8
    return config


def mr_cell() -> dict:
    return {"name": "tinymr.train", "config": "tinymr", "traffic": "tiny", "chips": 1,
            "entry": "train_pool_mr", "mix": dict(MIX), "check": {"steps": 2},
            "limits": dict(tiny.TRAIN_LIMITS)}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("NNDET_IN_STATS", "plane_sub:8")


def setup(seed: int = 7):
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet, RetinaUNetConfig

    config = tiny_mr_config()
    cfg = harness.reference_cfg(config)
    weights = harness.make_weights(param_specs(cfg), seed, torch.device("cpu"))
    model_cfg = RetinaUNetConfig.from_dict(config["model"])
    net = RetinaUNet(model_cfg)
    net.load_state_dict(weights)
    return config, cfg, model_cfg, weights, net.eval()


def raw_batch(seed: int, shape, batch: int = 2):
    """4-sequence images with ellipsoid-free blocks of two instances of
    classes 0 and 1, as a raw (not yet prepared) training batch."""
    g = torch.Generator().manual_seed(seed)
    images = torch.randn((batch, *shape, CHANNELS), generator=g)
    seg = torch.zeros((batch, *shape), dtype=torch.int32)
    seg[0, 2:5, 10:22, 12:26] = 1
    seg[1, 3:7, 30:44, 8:20] = 1
    seg[1, 1:4, 40:52, 40:50] = 2
    table = torch.full((batch, 8), -1, dtype=torch.int32)
    table[0, 0] = 1
    table[1, :2] = torch.tensor([0, 1])
    return images, seg, table


def test_the_plan_is_anisotropic_and_dummy_2d():
    from nndetection_tpu_torch.data.aug_presets import get_augmentation
    from nndetection_tpu_torch.data.augment import generator_patch_size_for

    config = tiny_mr_config()
    _, per_level = detect.anchors(harness.reference_cfg(config))
    # levels 1 and 2: strides (1,2,2) and (2,4,4) of the 8x32x32 patch, 8 anchors a position
    assert per_level == [8 * 16 * 16 * 8, 4 * 8 * 8 * 8]
    aug = get_augmentation(config["augmentation"], PATCH, dummy_2d=config["dummy_2d"])
    gen_patch = generator_patch_size_for(aug)
    assert gen_patch[0] == PATCH[0] and min(gen_patch[1:]) > PATCH[1]


def test_forward():
    _, cfg, _, weights, net = setup()
    images = torch.randn((2, *PATCH, CHANNELS), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = net(images), Net(cfg, weights)(images)
    assert got["box_logits"].shape[-1] == 2
    for key in ("box_logits", "box_deltas", "seg_logits"):
        torch.testing.assert_close(got[key].float(), want[key], rtol=1e-4, atol=1e-4)


def test_train_step():
    from nndetection_tpu_torch.data.gt_prep import prepare_targets
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

    config, cfg, model_cfg, weights, _ = setup()
    tcfg = dict(config["trainer"], warm_iterations=4)
    trainer = Trainer(model_cfg, TrainerConfig(**tcfg), device="cpu")
    state = trainer.init_state(params=weights)
    images, seg, table = raw_batch(4, PATCH)
    batch = prepare_targets(images, seg, table)
    assert set(batch["gt_classes"][batch["gt_mask"]].tolist()) == {0, 1}
    gen = torch.Generator().manual_seed(5)
    state_before = gen.get_state()
    losses = trainer.train_step(state, batch, gen)
    grid, per_level = detect.anchors(cfg)
    decayed = {n for n, _, init, _ in param_specs(cfg) if init != "const"}
    ref = ref_train.run_steps(cfg, tcfg, weights, decayed, [batch], [state_before],
                              torch.from_numpy(grid), per_level)
    assert float(losses["num_pos"]) > 0
    for key in ("cls", "reg", "seg_ce", "seg_dice"):
        want = ref["losses"][0][key]
        assert abs(float(losses[key]) - want) <= 1e-5 * abs(want) + 1e-7, key
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state[p]["momentum_buffer"]
        torch.testing.assert_close(buf, ref["first_grad"][name], rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(p.detach(), ref["params"][name], rtol=1e-5, atol=1e-7)


def test_dummy_2d_augmentation_and_targets():
    """The port's augmentation and targets of a 4-sequence batch against the
    reference's, from the same generator state: targets exact, images to
    float32 rounding (the benchmark's tiny CPU cells' limit)."""
    from nndetection_tpu_torch.data.aug_presets import get_augmentation
    from nndetection_tpu_torch.data.augment import augment_batch, generator_patch_size_for
    from nndetection_tpu_torch.data.gt_prep import prepare_targets

    aug = get_augmentation("base_more", PATCH, dummy_2d=True)
    gen_patch = generator_patch_size_for(aug)
    images, seg, table = raw_batch(6, gen_patch)
    ref_cfg = ref_augment.AugmentConfig(**{f: getattr(aug, f)
                                           for f in ref_augment.AugmentConfig.__dataclass_fields__})
    assert ref_cfg.dummy_2d
    for seed in (11, 12, 13):
        gen = torch.Generator().manual_seed(seed)
        state = gen.get_state()
        data, s = augment_batch(gen, images, seg, aug)
        got = prepare_targets(data, s, table)
        gen.set_state(state)
        rd, rs = ref_augment.augment_batch(gen, images, seg, ref_cfg)
        want = ref_gt.prepare_targets(rd, rs, table)
        assert got["images"].shape == (2, *PATCH, CHANNELS)
        scale = float(want["images"].abs().max())
        assert float((got["images"] - want["images"]).abs().max()) <= tiny.TRAIN_LIMITS[
            "aug_img_err"] * scale
        for key in ("seg", "gt_mask", "gt_boxes", "gt_classes"):
            assert torch.equal(got[key], want[key]), (seed, key)


def test_pool_cut_of_every_sequence(tmp_path):
    from nndetection_tpu_torch.data.loader import DevicePatchPool, build_case_records

    generate_mr.write_mr_cases(MIX, 3, tmp_path)
    records = build_case_records(tmp_path)
    arrays = {p.stem: np.load(p) for p in tmp_path.glob("*.npy")}
    assert all(a.shape == (CHANNELS + 1, *MIX["shape"]) for a in arrays.values())
    gen_patch = (8, 40, 40)
    pool = DevicePatchPool(records, patch_size=gen_patch, batch_size=2, max_pool_cases=4,
                           max_swap_bytes_per_epoch=1, device="cpu", max_instances=8, seed=5)
    assert pool.channels == CHANNELS
    origins = np.asarray([[0, 0, 0], [4, 32, 36]])
    for slots in ([0, 1], [2, 3]):
        data, seg = pool.gather(slots, origins)[:2]
        assert data.shape == (2, *gen_patch, CHANNELS) and data.dtype == torch.bfloat16
        for b, (k, org) in enumerate(zip(slots, origins)):
            arr = arrays[pool._pool_slots[k].case_id]
            win = tuple(slice(int(o), int(o) + p) for o, p in zip(org, gen_patch))
            want = torch.from_numpy(np.moveaxis(arr[(slice(0, CHANNELS),) + win]
                                                .astype(np.float32), 0, -1))
            assert torch.equal(data[b], want.to(torch.bfloat16))
            assert torch.equal(seg[b].long(), torch.from_numpy(arr[(CHANNELS,) + win]).long())


def test_generator_is_seeded_and_anisotropic(tmp_path):
    a = generate_mr.write_mr_cases(MIX, 9, tmp_path / "a")
    generate_mr.write_mr_cases(MIX, 9, tmp_path / "b")
    for cid in a:
        assert np.array_equal(np.load(tmp_path / "a" / f"{cid}.npy"),
                              np.load(tmp_path / "b" / f"{cid}.npy"))
        boxes = pickle.load(open(tmp_path / "a" / f"{cid}_boxes.pkl", "rb"))
        b = boxes["boxes"]
        # z extent within 2 * 2.5 + 1 voxels, in plane at least 2 * 3 - 1
        assert (b[:, 2] - b[:, 0]).max() <= 6 and (b[:, 3] - b[:, 1]).min() >= 5
        assert set(boxes["classes"].tolist()) <= {0, 1}


def run_mr_cell(seed: int = 2147483659):
    cell, config = mr_cell(), tiny_mr_config()
    run = harness.Run(bench=tiny.bench_for(cell), workload=cell, config=config, seed=seed,
                      seconds=0.5, trace=False, device=torch.device("cpu"),
                      spans=harness.Spans(False))
    os.environ["NNDET_IN_STATS"] = config["instance_norm_stats"]
    entry = harness.load_piece("entries", cell["entry"]).Entry(run)
    e2e = entry.window(0.5)
    entry.release()
    return entry, e2e


def test_train_pool_mr_cell_is_correct_and_fp8_is_not():
    entry, e2e = run_mr_cell()
    assert e2e["failed"] == 0 and e2e["train_patches_per_s"] > 0
    assert entry.aug_cfg.dummy_2d
    fp8 = {c["name"]: c["value"] for c in entry.check(control="fp8")}
    got = entry.check()
    for c in got:
        assert c["value"] <= c["limit"], c
    assert {c["name"] for c in got} == set(tiny.TRAIN_LIMITS)
    assert any(fp8[k] > tiny.TRAIN_LIMITS[k] for k in fp8), fp8


def test_anchor_spans_and_counter():
    """``train.anchors`` counts batch x anchors a patch for every step, and
    ``train.match`` and ``train.sample`` open once a step, under
    ``train.forward``."""
    from torch.profiler import ProfilerActivity, profile

    from nndetection_tpu_torch.data.gt_prep import prepare_targets
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig
    from nndetection_tpu_torch.utils import trace

    config, cfg, model_cfg, weights, _ = setup()
    trainer = Trainer(model_cfg, TrainerConfig(**config["trainer"]), device="cpu")
    state = trainer.init_state(params=weights)
    images, seg, table = raw_batch(4, PATCH)
    batches = [prepare_targets(images, seg, table) for _ in range(2)]
    trace.take()
    trainer.train_step(state, batches[0], torch.Generator().manual_seed(1))
    assert trace.take() == ([], {}, 0)  # no profiler, nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_epoch(state, batches, 0)
    spans, counts, _ = trace.take()
    anchors = detect.anchors(cfg)[0].shape[0]
    assert counts["train.anchors"] == 2 * 2 * anchors
    by_id = {sp.id: sp for sp in spans}
    for name in ("train.match", "train.sample"):
        found = [sp for sp in spans if sp.name == name]
        assert len(found) == 2, name
        assert all(by_id[sp.parent].name == "train.forward" for sp in found)
    match, sample = ([sp for sp in spans if sp.name == n] for n in ("train.match", "train.sample"))
    assert all(m.end_ns <= s.start_ns for m, s in zip(match, sample))
