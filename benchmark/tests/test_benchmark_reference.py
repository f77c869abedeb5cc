"""The frozen plain reference agrees with the program's CPU path at a tiny
size: the forward, the tile post-processing, the whole-case consolidation
and one train step. This test imports both; the reference itself imports
nothing of the program.

    python -m pytest benchmark/tests -q
"""
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import detect, ensemble
from benchmark.reference import train as ref_train
from benchmark.reference.model import Net, param_specs
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("NNDET_IN_STATS", "plane_sub:8")


def setup(name: str, seed: int = 7):
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet, RetinaUNetConfig

    config = tiny.config(name)
    os.environ["NNDET_IN_STATS"] = config["instance_norm_stats"]  # as the harness sets it
    cfg = harness.reference_cfg(config)
    weights = harness.make_weights(param_specs(cfg), seed, torch.device("cpu"))
    model_cfg = RetinaUNetConfig.from_dict(config["model"])
    net = RetinaUNet(model_cfg)
    net.load_state_dict(weights)
    return config, cfg, model_cfg, weights, net.eval()


@pytest.mark.parametrize("name", ["tiny3d", "tiny2d"])
def test_forward(name):
    _, cfg, _, weights, net = setup(name)
    images = torch.randn((2, *cfg["patch_size"], 1), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = net(images), Net(cfg, weights)(images)
    for key in ("box_logits", "box_deltas", "seg_logits"):
        torch.testing.assert_close(got[key].float(), want[key], rtol=1e-4, atol=1e-4)


def test_postprocess():
    from nndetection_tpu_torch.models.retina_unet import batched_postprocess

    _, cfg, model_cfg, weights, net = setup("tiny3d")
    images = torch.randn((3, *cfg["patch_size"], 1), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        preds = net(images)
    grid = torch.from_numpy(detect.anchors(cfg)[0])
    got = batched_postprocess(model_cfg, preds, grid, cfg["patch_size"], with_seg=False,
                              topk_candidates=300, max_out=20)
    want = detect.postprocess(cfg, preds["box_logits"], preds["box_deltas"], grid, 300, 20)
    assert torch.equal(got["valid"], want["valid"])
    v = want["valid"]
    torch.testing.assert_close(got["boxes"][v], want["boxes"][v])
    torch.testing.assert_close(got["scores"][v], want["scores"][v])
    assert torch.equal(got["labels"][v].long(), want["labels"][v].long())


@pytest.mark.parametrize("device_wbc", [False, True], ids=["host_wbc", "device_wbc"])
def test_consolidation(device_wbc, monkeypatch):
    from nndetection_tpu_torch.inference import ensembler

    monkeypatch.setattr(ensembler, "DEVICE_WBC", device_wbc)
    rng = np.random.default_rng(3)
    case, patch = (60, 70, 64), (32, 32, 32)
    prog = ensembler.BoxEnsemblerSelective(case, device="cpu")
    ref = ensemble.Selective(case)
    for stream in range(3):
        prog.add_model(f"s{stream}")
        for t in range(4):
            lo = rng.uniform(0, 24, (50, 3))
            size = rng.uniform(2, 10, (50, 3))
            boxes = np.stack([lo[:, 0], lo[:, 1], lo[:, 0] + size[:, 0], lo[:, 1] + size[:, 1],
                              lo[:, 2], lo[:, 2] + size[:, 2]], 1).astype(np.float32)
            scores = rng.uniform(0, 1, 50).astype(np.float32)
            labels = rng.integers(0, 2, 50)
            origin = rng.integers(0, 28, 3)
            prog.process_tile(boxes, scores, labels, origin, patch)
            ref.add_tile(stream, boxes, scores, labels, origin, patch)
    got, want = prog.get_case_result(), ref.result()
    assert len(got["pred_scores"]) == len(want["pred_scores"]) > 0
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=1e-5)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])


def test_train_step():
    from nndetection_tpu_torch.data.gt_prep import prepare_targets
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

    config, cfg, model_cfg, weights, _ = setup("tiny3d")
    tcfg = dict(config["trainer"], warm_iterations=4)
    trainer = Trainer(model_cfg, TrainerConfig(**tcfg), device="cpu")
    state = trainer.init_state(params=weights)
    g = torch.Generator().manual_seed(4)
    images = torch.randn((2, *cfg["patch_size"], 1), generator=g)
    seg = torch.zeros((2, *cfg["patch_size"]), dtype=torch.int32)
    seg[0, 4:12, 6:14, 5:13] = 1
    seg[1, 10:20, 3:9, 12:22] = 1
    seg[1, 20:26, 20:28, 2:8] = 2
    table = torch.tensor([[0] + [-1] * 31, [0, 0] + [-1] * 30], dtype=torch.int32)
    batch = prepare_targets(images, seg, table)
    gen = torch.Generator().manual_seed(5)
    state_before = gen.get_state()
    losses = trainer.train_step(state, batch, gen)
    grid, per_level = detect.anchors(cfg)
    decayed = {n for n, _, init, _ in param_specs(cfg) if init != "const"}
    ref = ref_train.run_steps(cfg, tcfg, weights, decayed, [batch], [state_before],
                              torch.from_numpy(grid), per_level)
    for key in ("cls", "reg", "seg_ce", "seg_dice"):
        assert abs(float(losses[key]) - ref["losses"][0][key]) <= 1e-5 * abs(ref["losses"][0][key]) + 1e-7
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state[p]["momentum_buffer"]
        torch.testing.assert_close(buf, ref["first_grad"][name], rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(p.detach(), ref["params"][name], rtol=1e-5, atol=1e-7)
