"""The benchmark's files on the CPU: names and units, which metric moves
which, that every piece is found by its name alone, the seeded generators,
the FLOP count, and the check for JAX modules.

    python -m pytest benchmark/tests -q
"""
import json
import math
import re
import shutil

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference.model import forward_flops
from benchmark.traffic import generate

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def cells_of(metric):
    return metric.get("workloads", list(CELLS))


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for w in BENCH["workloads"]:
        for path in (harness.BENCH / "workloads" / f"{w['name']}.json",
                     harness.BENCH / "traffic" / f"{w['traffic']}.json"):
            assert path.exists(), path


def test_every_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = E2E[m["moves"]]
        assert set(cells_of(m)) <= set(cells_of(moved)), m["name"]
        assert hasattr(harness.load_reader(m["name"]), "read"), m["name"]
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if cell in cells_of(m)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(cell in cells_of(m) for m in BENCH["per_layer"])


def test_pieces_are_found_by_name_alone(tmp_path, monkeypatch):
    """A new configuration, cell, entry and per-layer metric are new files
    and new entries of ``BENCHMARK.json``: the harness finds each by its
    name, with no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    shutil.copy(root / "benchmark/configs/luna3d.json", root / "benchmark/configs/new3d.json")
    bench["configs"].append(dict(bench["configs"][0], name="new3d",
                                 file="benchmark/configs/new3d.json"))
    shutil.copy(root / "benchmark/entries/predict.py", root / "benchmark/entries/new_entry.py")
    (root / "benchmark/workloads/new3d.cell.json").write_text(json.dumps(
        dict(harness.load_json(root / "benchmark/workloads/luna3d.predict.json"),
             entry="new_entry")))
    bench["workloads"].append({"name": "new3d.cell", "config": "new3d",
                               "traffic": "cases_luna5", "chips": 1, "why": "a new cell"})
    (root / "benchmark/metrics/new_metric.predict.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["per_layer"].append({"name": "new_metric.predict", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "ensembler",
                               "moves": "volumes_per_min", "workloads": ["new3d.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "benchmark")
    cell, config = harness.find_cell(harness.load_json(root / "BENCHMARK.json"), "new3d.cell")
    assert cell["entry"] == "new_entry" and config["name"] == "luna3d"
    assert hasattr(harness.load_piece("entries", cell["entry"]), "Entry")
    assert harness.load_piece("metrics", "new_metric.predict").read(None) == 42.0


def test_a_reader_serves_other_cells_by_an_alias_file():
    alias = harness.load_json(harness.BENCH / "metrics" / "mfu.train2d.json")
    assert harness.load_reader("mfu.train2d").__file__ == harness.load_piece(
        "metrics", alias["reader"]).__file__


def test_span_device_time_takes_the_kernels_launched_in_the_span_on_its_thread():
    from benchmark.readers import span_device_seconds

    spans = harness.Spans(True)
    spans.items = [("cut", 100, 200, 1), ("step", 100, 400, 2), ("cut", 300, 350, 1)]
    run = harness.Run(bench={}, workload={}, config={}, seed=0, seconds=1.0, trace=True,
                      device=torch.device("cpu"), spans=spans)
    # launches: (correlation, start, thread); kernels: (name, start, end, correlation)
    run.launches = [(1, 150, 1), (2, 150, 2), (3, 250, 1), (4, 320, 1), (5, 360, 1)]
    run.events = [("k", 1000, 3000, 1), ("k", 3000, 9000, 2), ("k", 9000, 9500, 3),
                  ("k", 9500, 9700, 4), ("k", 9700, 9800, 5)]
    assert span_device_seconds(run, ("cut",)) == (2000 + 200) / 1e9
    assert span_device_seconds(run, ("nothing",)) is None
    # the trace's name of a thread as a card's profiler gave it
    assert harness.thread_key(139711989409472) == 998237888
    assert harness.thread_key(139726075327232) == -2095713536


def test_generators_are_deterministic_by_seed(tmp_path):
    mix = {"kind": "cases", "shapes": [[20, 24, 28], [16, 40, 30]], "objects": [1, 3],
           "radius": [2.0, 4.0], "contrast": 2.0}
    cpu = torch.device("cpu")
    a, b = generate.case_volumes(mix, 5, cpu), generate.case_volumes(mix, 5, cpu)
    c = generate.case_volumes(mix, 6, cpu)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert generate.order(mix, 5, 3) == generate.order(mix, 5, 3)
    assert sorted(generate.order(mix, 9, 1)) == [0, 1]
    train = {"kind": "train_cases", "n_cases": 3, "shape": [20, 24, 22], "instances": [1, 3],
             "radius": [2.0, 4.0], "classes": 2, "contrast": 2.0}
    for d in ("a", "b", "c"):
        generate.write_train_cases(train, 7 if d != "c" else 8, tmp_path / d)
    files = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "b").iterdir()) and len(files) == 6
    assert all((tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes()
               for f in files)
    assert (tmp_path / "a/case_000.npy").read_bytes() != (tmp_path / "c/case_000.npy").read_bytes()
    assert harness.sub_seed(2 ** 31 + 5, 1) == harness.sub_seed(2 ** 31 + 5, 1)
    assert harness.sub_seed(2 ** 31 + 5, 1) != harness.sub_seed(2 ** 31 + 5, 2)


def test_flop_count_of_a_tiny_config_matches_a_hand_count():
    cfg = {"dim": 3, "in_channels": 1, "start_channels": 4, "max_channels": 8,
           "fpn_channels": 8, "head_channels": 8, "conv_kernels": [[3, 3, 3], [3, 3, 3]],
           "strides": [[2, 2, 2]], "decoder_levels": [1], "patch_size": [8, 8, 8],
           "anchor_width": [[2, 4]], "anchor_height": [[2]], "anchor_depth": [[2]],
           "head_num_convs": 1, "learn_scale": True, "prior_prob": 0.01,
           "cls_loss_type": "bce", "classifier_classes": 1, "segmenter_fg_bg": True,
           "seg_classes": 1, "in_plane_stride": None}

    def conv(cin, cout, k, out_vox):
        return 2 * cin * cout * k * out_vox

    v0, v1 = 8 ** 3, 4 ** 3
    encoder = conv(1, 4, 27, v0) + conv(4, 4, 27, v0) + conv(4, 8, 27, v1) + conv(8, 8, 27, v1)
    # 1x1 laterals to 8 channels (level 0: fpn 8 halved, but at least 8), the
    # transposed up conv (2x2x2, one product per input voxel)
    decoder = conv(4, 8, 1, v0) + conv(8, 8, 1, v1) + conv(8, 8, 8, v1)
    a = 2  # anchors a position
    heads = 2 * (conv(8, 8, 27, v1) * 2) + conv(8, a * 1, 27, v1) + conv(8, a * 6, 27, v1)
    seg = conv(8, 2, 1, v0)
    assert forward_flops(cfg, 1) == encoder + decoder + heads + seg
    assert forward_flops(cfg, 3) == 3 * forward_flops(cfg, 1)


def test_import_check_compares_whole_top_level_names():
    names = ["jax.numpy", "nndetection_tpu.models.conv", "nndetection_tpu_torch.ops", "numpy",
             "jaxtyping", "flaxen", "optax"]
    assert harness.forbidden_modules(names) == ["jax", "nndetection_tpu", "optax"]
    assert harness.forbidden_modules(["nndetection_tpu_torch", "torch"]) == []


def test_no_benchmark_file_reads_the_jax_package_or_its_benchmark():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|nndetection_tpu)\b(?!_)")
    for path in harness.BENCH.rglob("*.py"):
        text = path.read_text()
        assert not any(pattern.match(line) for line in text.splitlines()), path
        assert not re.search(r"bench\.py|BENCH_r|MULTICHIP_", text) or path.parent.name == "tests", path
    for path in (harness.BENCH / "reference").glob("*.py"):
        assert "nndetection_tpu_torch" not in "".join(
            line for line in path.read_text().splitlines(True)
            if line.lstrip().startswith(("import", "from"))), path


def test_weights_cover_the_program_model():
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet, RetinaUNetConfig

    for name in ("luna3d", "retina2d"):
        config = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
        cfg = harness.reference_cfg(config)
        from benchmark.reference.model import param_specs

        specs = {n: tuple(s) for n, s, _, _ in param_specs(cfg)}
        with torch.device("meta"):
            model = RetinaUNet(RetinaUNetConfig.from_dict(config["model"]))
        assert specs == {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert sum(math.prod(s) for s in specs.values()) == sum(
            p.numel() for p in model.parameters())


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_run_exits_without_a_card(seed, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.run(["--workload", "luna3d.predict", "--seed", str(seed), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
