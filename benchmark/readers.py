"""Arithmetic the per-layer readers share (``benchmark/metrics/*.py``): the
chip's peaks, the model's operations and the instance norm's bytes at the
cell's shapes, and the trace's device time by kernel name."""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

from benchmark import harness
from benchmark.reference.model import forward_flops, norm_map_shapes
from benchmark.roofline import norm_bytes


def peaks() -> dict:
    return harness.load_json(harness.BENCH / "roofline" / "peaks.json")


def idle_pct(run) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or memset
    ran on the card."""
    if not run.events or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)


def mfu_pct(run, forwards: float) -> Optional[float]:
    """Model operations of ``forwards`` one-patch forwards (a train step's
    backward counted as two forwards, recomputation not counted) over the
    window's wall time at the bf16 peak."""
    if forwards <= 0 or run.window_s <= 0:
        return None
    flops = forward_flops(run.ref_cfg, 1) * forwards
    return 100.0 * flops / (run.window_s * peaks()["bf16_flops_per_s"])


def layer_seconds(run, layer: str) -> float:
    """Device seconds of the trace's kernels that ``layers/<layer>.json``
    assigns to the layer."""
    spec = harness.load_json(harness.BENCH / "layers" / f"{layer}.json")
    pat = re.compile("|".join(spec["patterns"]))
    return sum(e - s for name, s, e, _ in run.events if pat.search(name)) / 1e9


def span_device_seconds(run, names) -> Optional[float]:
    """Device seconds of the trace's kernels, copies and memsets that were
    launched inside a host span named in ``names``, on the span's own
    thread (a launch and its kernel share the trace's correlation id);
    None where no launch lies in such a span."""
    by_thread: Dict[int, List[Tuple[int, int]]] = {}
    for name, s, e, tid in run.spans.items:
        if name in names:
            by_thread.setdefault(tid, []).append((s, e))
    starts = {tid: [s for s, _ in sorted(v)] for tid, v in by_thread.items()}
    ends = {tid: [e for _, e in sorted(v)] for tid, v in by_thread.items()}
    wanted = set()
    for corr, t, tid in run.launches:
        i = bisect.bisect_right(starts.get(tid, ()), t) - 1
        if i >= 0 and t <= ends[tid][i]:
            wanted.add(corr)
    if not wanted:
        return None
    return sum(e - s for _, s, e, corr in run.events if corr in wanted) / 1e9


def norm_bytes_per_patch(cfg: dict) -> List[int]:
    """``(forward, backward)`` bytes of every instance norm of one patch."""
    shapes = norm_map_shapes(cfg, 1)
    stride = cfg.get("in_plane_stride")
    return [sum(norm_bytes.forward_bytes(s, stride) for s in shapes),
            sum(norm_bytes.backward_bytes(s) for s in shapes)]


def roofline_pct(run, n_bytes: float, layer: str) -> Optional[float]:
    seconds = layer_seconds(run, layer)
    if seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * n_bytes / peaks()["hbm_bytes_per_s"] / seconds


def mean(values) -> Optional[float]:
    values = list(values or [])
    return sum(values) / len(values) if values else None
