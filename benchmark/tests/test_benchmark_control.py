"""The check on the CPU at a tiny size: sound runs come out correct; the
control (the reference in float8 in the program's place) and each fault the
cells can have, planted under the timed path, come out not correct.

    python -m pytest benchmark/tests -q
"""
import numpy as np
import pytest

from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("NNDET_IN_STATS", "")


def failing(result: dict):
    return [k for k, v in result["compared"].items() if v["value"] > v["limit"]]


@pytest.mark.parametrize("cell", [tiny.predict_cell(), tiny.predict_cell(models=2, tta=True),
                                  tiny.train_cell(3), tiny.train_cell(2)],
                         ids=["predict", "predict_2x8", "train3d", "train2d"])
def test_sound_run_is_correct(cell):
    result = tiny.run_cell(cell)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", [tiny.predict_cell(), tiny.train_cell(3)],
                         ids=["predict", "train3d"])
def test_control_fails(cell):
    entry = tiny.entry_after_window(cell)
    compared = entry.check(control="fp8")
    assert any(c["value"] > c["limit"] for c in compared), compared


def test_half_batch_reference_fails_train():
    entry = tiny.entry_after_window(tiny.train_cell(3))
    compared = entry.check(control="half_batch")
    assert any(c["value"] > c["limit"] for c in compared), compared


def test_altered_answer_fails_predict(monkeypatch):
    from nndetection_tpu_torch.inference import ensembler

    result_of = ensembler.BoxEnsemblerSelective.get_case_result

    def altered(self):
        out = result_of(self)
        out["pred_boxes"] = out["pred_boxes"] + 1.0
        return out

    monkeypatch.setattr(ensembler.BoxEnsemblerSelective, "get_case_result", altered)
    result = tiny.run_cell(tiny.predict_cell())
    assert not result["correct"] and "case_mismatch" in failing(result)


def test_altered_tile_detections_fail_predict(monkeypatch):
    from nndetection_tpu_torch.inference.predictor import Predictor

    infer = Predictor._infer

    def altered(self, net, tiles):
        out, seg = infer(self, net, tiles)
        out["scores"] = out["scores"] * np.float32(0.5)
        return out, seg

    monkeypatch.setattr(Predictor, "_infer", altered)
    result = tiny.run_cell(tiny.predict_cell())
    assert not result["correct"] and "post_mismatch" in failing(result)


def test_half_of_the_tiles_left_out_fails_predict(monkeypatch):
    from nndetection_tpu_torch.inference import predictor

    grid = predictor.compute_grid

    def half(*args, **kwargs):
        origins = grid(*args, **kwargs)
        return origins[: max(1, len(origins) // 2)]

    monkeypatch.setattr(predictor, "compute_grid", half)
    result = tiny.run_cell(tiny.predict_cell())
    assert not result["correct"] and "case_mismatch" in failing(result)


def test_state_left_unchanged_fails_train(monkeypatch):
    from nndetection_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_apply_update", lambda self, state: False)
    result = tiny.run_cell(tiny.train_cell(3))
    assert not result["correct"] and {"grad_gap_med", "update_gap_med"} <= set(failing(result))


def test_updates_skipped_after_the_first_epoch_fail_train(monkeypatch):
    """A fault that spares the set-up epoch: from the window on, every
    update is dropped. The epoch captured after the window starts from that
    state and catches it."""
    from nndetection_tpu_torch.train.trainer import Trainer

    update = Trainer._apply_update
    steps = tiny.train_cell(3)["check"]["steps"]

    def skipped(self, state):
        return update(self, state) if state.opt_count < steps else False

    monkeypatch.setattr(Trainer, "_apply_update", skipped)
    result = tiny.run_cell(tiny.train_cell(3))
    assert not result["correct"] and "update_gap_med" in failing(result)


def test_half_of_the_batch_left_out_fails_train(monkeypatch):
    from nndetection_tpu_torch.train.trainer import Trainer

    losses = Trainer._losses

    def half(self, model, batch, generator):
        n = batch["images"].shape[0] // 2
        return losses(self, model, {k: v[:n] for k, v in batch.items()}, generator)

    monkeypatch.setattr(Trainer, "_losses", half)
    result = tiny.run_cell(tiny.train_cell(3))
    assert not result["correct"] and "loss_gap" in failing(result)


def test_altered_targets_fail_train(monkeypatch):
    from nndetection_tpu_torch.train import trainer

    prepare = trainer.prepare_targets

    def altered(*args, **kwargs):
        out = prepare(*args, **kwargs)
        out["gt_boxes"] = out["gt_boxes"] + 1.0
        return out

    monkeypatch.setattr(trainer, "prepare_targets", altered)
    result = tiny.run_cell(tiny.train_cell(3))
    assert not result["correct"] and "target_mismatch" in failing(result)
