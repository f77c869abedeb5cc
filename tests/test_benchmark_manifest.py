"""``BENCHMARK.json`` names each cell once: cell names are unique, and so
is every pair of configuration and traffic mix, which is what identifies a
cell. Every configuration's file carries its name and source. Every
cell's configuration, traffic mix, entry and workload file
exists, and every per-layer metric lists only cells that report the
end-to-end metric it moves."""
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "benchmark"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def cells_of(metric):
    return metric.get("workloads", list(CELLS))


def test_cell_names_are_unique():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)), names


def test_config_and_traffic_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


def test_metric_and_config_names_are_unique():
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    configs = [c["name"] for c in BENCH["configs"]]
    assert len(metrics) == len(set(metrics)) and len(configs) == len(set(configs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_names_its_entry_and_source(config):
    c = next(c for c in BENCH["configs"] if c["name"] == config)
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["name"] == config and body["source"] == c["source"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_file_of_a_cell_exists(cell):
    w = CELLS[cell]
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert (ROOT / configs[w["config"]]["file"]).is_file()
    assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    spec = json.loads((BENCH_DIR / "workloads" / f"{cell}.json").read_text())
    assert (BENCH_DIR / "entries" / f"{spec['entry']}.py").is_file()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_metric_cells_exist_and_report_what_it_moves(metric):
    m = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    listed = cells_of(m)
    assert set(listed) <= set(CELLS), metric
    assert set(listed) <= set(cells_of(E2E[m["moves"]])), metric
    assert ((BENCH_DIR / "metrics" / f"{metric}.py").is_file()
            or (BENCH_DIR / "metrics" / f"{metric}.json").is_file())
