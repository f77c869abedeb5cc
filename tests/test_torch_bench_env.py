"""The port's host-load stamp against the JAX package's
``utils/bench_env.py``: the block's keys and types, a busy process found by
both, and ``NNDET_BENCH_REQUIRE_EXCLUSIVE`` on a contended and a quiet
host."""
import subprocess
import sys

import pytest

from nndetection_tpu.utils import bench_env as jbench
from nndetection_tpu_torch.utils import bench_env as tbench

BUSY = [{"pid": 4242, "comm": "spinner", "cpu_frac": 1.0}]


def test_host_load_block_matches_jax():
    got, want = tbench.host_load(sample_s=0.1), jbench.host_load(sample_s=0.1)
    assert set(got) == set(want) == {"loadavg_1m", "busy_other_procs", "exclusive",
                                     "sampled_at"}
    for k in got:
        assert type(got[k]) is type(want[k]), k
    assert got["exclusive"] == (got["busy_other_procs"] == [])


def test_busy_process_is_found_by_both():
    spinner = subprocess.Popen([sys.executable, "-c", "while True: pass"])
    try:
        found = [{p["pid"] for p in mod._busy_others(0.5, 0.2)} for mod in (tbench, jbench)]
    finally:
        spinner.kill()
        spinner.wait()
    assert spinner.pid in found[0] and spinner.pid in found[1]


@pytest.mark.parametrize("required", [None, "1"])
@pytest.mark.parametrize("busy", [[], BUSY])
def test_require_exclusive_matches_jax(monkeypatch, capsys, required, busy):
    if required is None:
        monkeypatch.delenv("NNDET_BENCH_REQUIRE_EXCLUSIVE", raising=False)
    else:
        monkeypatch.setenv("NNDET_BENCH_REQUIRE_EXCLUSIVE", required)
    outcomes = []
    for mod in (tbench, jbench):
        monkeypatch.setattr(mod, "_busy_others", lambda sample_s=0.6, busy_frac=0.2: list(busy))
        try:
            snap = mod.require_exclusive_or_tag("ctx")
            outcomes.append(("ok", snap["exclusive"], snap["busy_other_procs"]))
        except RuntimeError as e:
            outcomes.append(("raised", str(e)))
        outcomes.append(capsys.readouterr().err)
    assert outcomes[:2] == outcomes[2:]
    assert outcomes[0][0] == ("raised" if busy and required else "ok")
