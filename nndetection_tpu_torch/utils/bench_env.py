"""The host's load at measurement time, stamped on performance records
(counterpart of :mod:`nndetection_tpu.utils.bench_env`).

Wall times move with what else runs on the host: every JSON line of
``chip_smoke.py`` carries a :func:`host_load` block, and a measurement can
refuse to run on a contended host (``NNDET_BENCH_REQUIRE_EXCLUSIVE=1``).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List


def _busy_others(sample_s: float = 0.6, busy_frac: float = 0.2) -> List[Dict]:
    """Processes other than this one and its parent that used more than
    ``busy_frac`` of a CPU over ``sample_s`` seconds, with their names."""
    me, parent = os.getpid(), os.getppid()

    def cpu_ticks() -> Dict[int, int]:
        out = {}
        for pid in os.listdir("/proc"):
            if not pid.isdigit() or int(pid) in (me, parent):
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    parts = f.read().rsplit(")", 1)[1].split()
                # utime + stime, fields 14 and 15 of /proc/<pid>/stat
                out[int(pid)] = int(parts[11]) + int(parts[12])
            except (OSError, IndexError, ValueError):
                continue
        return out

    t0 = cpu_ticks()
    time.sleep(sample_s)
    t1 = cpu_ticks()
    hz = os.sysconf("SC_CLK_TCK")
    busy = []
    for pid, ticks in t1.items():
        frac = (ticks - t0.get(pid, ticks)) / hz / sample_s
        if frac > busy_frac:
            try:
                with open(f"/proc/{pid}/comm") as f:
                    comm = f.read().strip()
            except OSError:
                comm = "?"
            busy.append({"pid": pid, "comm": comm, "cpu_frac": round(frac, 2)})
    return busy


def host_load(sample_s: float = 0.6) -> Dict:
    """The host's 1-minute load average, the other processes busy over a
    short sample, whether there were none, and when."""
    with open("/proc/loadavg") as f:
        load1 = float(f.read().split()[0])
    busy = _busy_others(sample_s)
    return {
        "loadavg_1m": load1,
        "busy_other_procs": busy,
        "exclusive": len(busy) == 0,
        "sampled_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def require_exclusive_or_tag(context: str = "bench") -> Dict:
    """:func:`host_load`, with a warning on stderr when the host is
    contended; with ``NNDET_BENCH_REQUIRE_EXCLUSIVE=1`` a contended host
    raises instead."""
    snap = host_load()
    if not snap["exclusive"]:
        msg = f"[{context}] host is CONTENDED at measurement time: {snap['busy_other_procs']}"
        if os.environ.get("NNDET_BENCH_REQUIRE_EXCLUSIVE") == "1":
            raise RuntimeError(msg + " (NNDET_BENCH_REQUIRE_EXCLUSIVE=1)")
        print("# WARNING " + msg, file=sys.stderr)
    return snap
