"""The benchmark's harness: finds the cell, its configuration, its entry and
its per-layer readers by the names in ``BENCHMARK.json``, runs set-up, the
measured window and the check, and prints one JSON result line.

A run: the entry's set-up (weights and inputs from ``--seed``, the
program's objects, one pass over every shape the cell uses), the window of
``--seconds`` (under ``torch.profiler`` with ``--trace 1``), the peak
memory, the entry's release (any last work of the program that the check
needs, then the program's state freed), the check against the plain reference
(:mod:`benchmark.reference`), the per-layer readers (``--trace 1``), then
the check that no JAX module was loaded.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nndetection_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's ``--seed``."""
    seq = np.random.SeedSequence([seed % 2 ** 64, *tags])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def forbidden_modules(names) -> List[str]:
    """The top-level module names among ``names`` that are JAX's or the JAX
    package's, compared whole."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_piece(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def load_reader(name: str):
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    or the reader that ``metrics/<name>.json`` names (``{"reader":
    "<other>"}``), where one reader serves the same quantity in other
    cells."""
    alias = BENCH / "metrics" / f"{name}.json"
    if alias.exists():
        name = load_json(alias)["reader"]
    return load_piece("metrics", name)


def reference_cfg(config: dict) -> dict:
    """The model fields of a configuration file with the plane stride of the
    instance-norm statistics, as :mod:`benchmark.reference.model` reads
    them."""
    stats = config["instance_norm_stats"]
    stride = int(stats.split(":")[1]) if stats.startswith("plane_sub:") else None
    return dict(config["model"], in_plane_stride=stride)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The norm of ``got - want`` over the norm of ``want``'s deviation from
    its mean."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want - want.mean()))


def worst(values) -> float:
    """The largest of ``values``, NaN if any is NaN (``max`` skips a NaN
    that is not first)."""
    values = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def make_weights(specs, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every parameter of ``specs`` (:func:`benchmark.reference.model.param_specs`)
    from one normal draw on ``device``: kernels as normals clamped at two
    standard deviations and scaled to the variance of their init, constants
    filled."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    drawn = [s for s in specs if s[2] != "const"]
    total = sum(math.prod(s[1]) for s in drawn)
    z = torch.randn(total, generator=gen, device=device, dtype=dtype).clamp_(-2.0, 2.0)
    out, offset = {}, 0
    for name, shape, init, value in specs:
        if init == "const":
            out[name] = torch.full(shape, value, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        std = value if init == "normal" else math.sqrt((2.0 if init == "he" else 1.0) / value)
        out[name] = z[offset:offset + n].view(shape).mul(std)
        offset += n
    return out


# ------------------------------------------------------------------ spans
class Spans:
    """Host spans (``time.time_ns``, the profiler's clock, and the thread as
    :func:`thread_key` names it) and counters the entries record around the
    calls into each layer, in traced runs."""

    def __init__(self, on: bool):
        self.on = on
        self.items: List[Tuple[str, int, int, int]] = []  # name, start, end, thread
        self.values: Dict[str, List[float]] = {}

    def add(self, name: str, value: float) -> None:
        self.values.setdefault(name, []).append(value)

    def wrap(self, owner, attr: str, name: str, after: Optional[Callable] = None) -> None:
        """Records a span around every call of ``owner.attr``; ``after(t0,
        result)`` may add values."""
        if not self.on:
            return
        import threading

        fn = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            res = fn(*args, **kwargs)
            if after is not None:
                after(t0, res)
            self.items.append((name, t0, time.time_ns(), thread_key(threading.get_ident())))
            return res

        setattr(owner, attr, wrapped)


# ------------------------------------------------------------------ trace
def thread_key(ident: int) -> int:
    """A thread's ``threading.get_ident()`` as the profiler's trace names
    the thread of a CUDA runtime call (``device_resource_id``): its low 32
    bits, signed."""
    return ctypes.c_int32(ident & 0xFFFFFFFF).value


def device_events(prof) -> Tuple[List[Tuple[str, int, int, int]], List[Tuple[int, int, int]]]:
    """``(name, start_ns, end_ns, correlation)`` of every kernel, copy and
    memset the profiler saw on the card, and ``(correlation, start_ns,
    thread)`` of every CUDA runtime call on the host, its thread as
    :func:`thread_key` names it."""
    out, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                out.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.correlation_id() and e.name().startswith("cu"):  # runtime and driver calls
            launches.append((e.correlation_id(), e.start_ns(), e.device_resource_id()))
    out.sort(key=lambda t: t[1])
    return out, launches


def busy_intervals(events) -> List[Tuple[int, int]]:
    """The union of the events' intervals, as disjoint sorted intervals."""
    merged: List[List[int]] = []
    for _, s, e, _ in events:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def breakdown(events, busy, spans: Spans, window: Tuple[int, int]) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps inside the window, each named by the innermost host span that
    covers its middle."""
    by_name: Dict[str, int] = {}
    for name, s, e, _ in events:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        cover = [sp for sp in spans.items if sp[1] <= mid <= sp[2]]
        label = min(cover, key=lambda sp: sp[2] - sp[1])[0] if cover else "outside spans"
        named.append([f"host in {label}", (e - s) / 1e9])
    return {"device_ops": [[n[:200], t / 1e9] for n, t in ops], "idle_gaps": named}


# ------------------------------------------------------------------ run
@dataclass
class Run:
    """What an entry and the readers see of one run."""

    bench: dict
    workload: dict  # the cell's entry of BENCHMARK.json with its file
    config: dict  # the configuration file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    spans: Spans
    counts: Dict[str, Any] = field(default_factory=dict)
    window_s: float = 0.0
    events: List[Tuple[str, int, int, int]] = field(default_factory=list)
    launches: List[Tuple[int, int, int]] = field(default_factory=list)
    busy_s: float = 0.0

    @property
    def ref_cfg(self) -> dict:
        return reference_cfg(self.config)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def find_cell(bench: dict, name: str) -> Tuple[dict, dict]:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = dict(cells[name], **load_json(BENCH / "workloads" / f"{name}.json"))
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    return cell, config


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run(argv=None, device: Optional[str] = None, bench: Optional[dict] = None,
        cell: Optional[dict] = None, config: Optional[dict] = None,
        t_start: Optional[float] = None) -> int:
    """One run; returns the exit code. ``device`` (tests only) skips the look
    for a card and runs where it says; ``bench``, ``cell`` and ``config``
    replace the files."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark runs on the card only")
            return 3
        device = "cuda"
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    if cell is None:
        cell, config = find_cell(bench, args.workload)
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < cell["chips"]:
        log(f"{cell['name']} needs {cell['chips']} cards, {torch.cuda.device_count()} present")
        return 3
    if dev.type == "cuda":
        log(f"[bench] {cell['name']} seed {args.seed} on {power_limit()}")
        torch.cuda.reset_peak_memory_stats()
    os.environ["NNDET_IN_STATS"] = config["instance_norm_stats"]
    run_ = Run(bench=bench, workload=cell, config=config, seed=args.seed,
               seconds=args.seconds, trace=bool(args.trace), device=dev,
               spans=Spans(bool(args.trace)))
    entry = load_piece("entries", cell["entry"]).Entry(run_)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"[bench] set-up {setup_s:.3f} s")

    if run_.trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.time_ns()
            e2e = entry.window(args.seconds)
            sync(dev)
            w1 = time.time_ns()
        events, run_.launches = device_events(prof)
        run_.events = [ev for ev in events if w0 <= ev[1] and ev[2] <= w1]
        log(f"[bench] trace: {len(run_.events)} device events in the window, "
            f"{len(run_.launches)} launches on threads {sorted({t for _, _, t in run_.launches})}, "
            f"spans on threads {sorted({sp[3] for sp in run_.spans.items})}")
        busy = busy_intervals(run_.events)
        run_.busy_s = sum(e - s for s, e in busy) / 1e9
        run_.window_s = (w1 - w0) / 1e9
        trace_breakdown = breakdown(run_.events, busy, run_.spans, (w0, w1))
    else:
        w0 = time.perf_counter()
        e2e = entry.window(args.seconds)
        sync(dev)
        run_.window_s = time.perf_counter() - w0
        trace_breakdown = None
    log(f"[bench] window {run_.window_s:.3f} s: {e2e}")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    attempted, failed = e2e.pop("attempted"), e2e.pop("failed")
    entry.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    compared = entry.check()
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compared)
    log(f"[bench] check {time.perf_counter() - t_check:.3f} s")

    metrics: Dict[str, dict] = {}
    if run_.trace:
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = load_reader(m["name"]).read(run_)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in e2e and cell["name"] in m.get("workloads", [cell["name"]]):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    found = forbidden_modules(list(sys.modules))
    if found:
        log(f"[bench] modules of JAX or the JAX package were loaded: {found}")
        return 4
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if run_.trace:
        result["device"]["busy_s"] = run_.busy_s
        result["device"]["window_s"] = run_.window_s
        if trace_breakdown is not None:
            result["breakdown"] = trace_breakdown
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in compared}
    for c in compared:
        log(f"[check] {c['name']} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
