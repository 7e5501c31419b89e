"""One run of one benchmark cell.

    python3 -m gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``, whose ``driver`` key names the loop in
``drivers/<driver>.py``. Per-layer metrics are ``metrics/<name>.py``.
All are found by name, so a cell, a configuration, a mix or a metric is
added with new files and entries alone.

A run: generates the cluster from the seed, loads it into the program
(set-up, counted in ``setup_s`` from the process's start), warms the
cell's shapes, measures for ``--seconds`` seconds, then judges what the
window produced against the plain reference and prints one JSON line.
With ``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the per-layer metrics instead of the end-to-end ones.

It exits non-zero, printing no result, without a CUDA device, or when
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kube_throttler_tpu")
_GC_DEFAULT_THRESHOLD = gc.get_threshold()


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (``/proc/self/stat``), so interpreter start-up counts too."""
    start_ticks = int(Path("/proc/self/stat").read_text().rpartition(")")[2].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: Path) -> ModuleType:
    """A module from its file, under a private name: metric names hold
    dots, which an import path cannot."""
    spec = importlib.util.spec_from_file_location(f"gpubench_dyn_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    driver: ModuleType
    chips: int
    per_layer: list  # [(metric entry, reader module)]


def resolve_cell(name: str, root: Path = PKG.parent) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    mix, driver and metric readers, each found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def in_cell(m):
        return name in m.get("workloads", [name])

    e2e_names = {m["name"] for m in bench["end_to_end"] if in_cell(m)}
    metrics = [m for m in bench["per_layer"] if in_cell(m) and m["moves"] in e2e_names]
    return make_cell(name, w["config"], w["traffic"], int(w["chips"]), metrics, root)


def make_cell(name: str, config: str, traffic: str, chips: int = 1, metrics=(),
              root: Path = PKG.parent) -> Cell:
    """A cell from its configuration and mix names and its per-layer
    metric entries, with each file found under ``root/gpubench``."""
    from .cluster import load_config

    pkg = root / "gpubench"
    mix = json.loads((pkg / "traffic" / f"{traffic}.json").read_text())
    return Cell(name=name, config=load_config(config, pkg), traffic=mix,
                driver=load_module(pkg / "drivers" / f"{mix['driver']}.py"), chips=chips,
                per_layer=[(m, load_module(pkg / "metrics" / f"{m['name']}.py")) for m in metrics])


@dataclass
class RunRecord:
    """What a window left for the metric readers: the work done, the
    program's tracer spans, and the device trace."""

    units: int = 0
    calls: int = 0
    elapsed_s: float = 0.0
    spans: Dict[str, tuple] = field(default_factory=dict)  # phase -> (sum_s, count)
    trace: Optional[dict] = None  # busy_s, window_s, device_ops, idle_gaps
    least_s_per_unit: Optional[float] = None  # the roofline's least time of one unit


def span_sums(plugin, phases) -> Dict[str, tuple]:
    out = {}
    for phase in phases:
        snap = plugin.tracer.snapshot(phase)
        out[phase] = (snap["sum"], snap["count"]) if snap else (0.0, 0)
    return out


def forbidden_modules() -> list:
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def serving_gc_posture() -> int:
    """The program's own last step before it takes traffic, as its daemon
    takes it (``freeze_startup_heap``): one full collection, then, when
    the heap is large, the heap frozen and full collections deferred.
    Returns the objects frozen (0: the heap stayed under the program's
    floor and keeps the default collector)."""
    from kube_throttler_tpu_torch.utils.gchygiene import freeze_startup_heap

    return freeze_startup_heap()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             control: Optional[str] = None) -> dict:
    """Set-up, window and check of ``cell``; returns the result line's
    object. ``device`` is ``cuda`` from the command line; tests drive the
    rest of a run on ``cpu`` at small sizes. With ``control`` (a guarantee
    the reference breaks, see ``reference.semantics``) the window's
    outputs are also judged against that control, under
    ``control_checks``: the benchmark's own runs never do this."""
    import torch

    from . import adapter, cluster as cluster_mod

    t_setup = time.perf_counter()
    marks = [("start", process_age_s())]
    cl = cluster_mod.generate(cell.config, seed)
    marks.append(("generate", process_age_s()))
    store, plugin = adapter.build_plugin(cl, device, marks, process_age_s)
    if plugin.device_manager is not None:
        plugin.device_manager.prewarm()
    marks.append(("prewarm", process_age_s()))
    drv = cell.driver.Driver(cl, store, plugin, cell.traffic, seed, seconds)
    drv.warm()
    marks.append(("warm", process_age_s()))
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
    frozen = serving_gc_posture()
    phases = sorted({s for _, reader in cell.per_layer for s in getattr(reader, "SPANS", ())})
    setup_s = process_age_s() if device == "cuda" else time.perf_counter() - t_setup

    print("gpubench: set-up s " + " ".join(
        f"{name}={t - prev:.3f}" for (name, t), (_, prev) in zip(marks[1:], marks[:-1])
    ) + f" before_main={marks[0][1]:.3f} gc_frozen={frozen}", file=sys.stderr)
    rec = RunRecord()
    steps = []
    prof = None
    if trace:
        from .trace import annotate_spans, start_profiler

        annotate_spans(plugin)
        prof = start_profiler(is_cuda)
    before = span_sums(plugin, phases)
    step_note = "gpubench." + cell.traffic["driver"]
    t0 = time.perf_counter()
    note = _annotate(trace, "gpubench.window")
    note.__enter__()
    while True:
        t1 = time.perf_counter()
        with _annotate(trace, step_note):
            rec.units += drv.step()
        t2 = time.perf_counter()
        steps.append(t2 - t1)
        if t2 - t0 >= seconds:
            break
    if is_cuda:
        torch.cuda.synchronize()
    window_s = rec.elapsed_s = time.perf_counter() - t0
    rec.calls = drv.calls
    after = span_sums(plugin, phases)
    note.__exit__(None, None, None)
    if prof is not None:
        prof.stop()
    print(f"gpubench: steps {_summary(steps)} window_s={window_s:.3f}", file=sys.stderr)
    rec.spans = {p: (after[p][0] - before[p][0], after[p][1] - before[p][1]) for p in phases}
    if trace:
        from .trace import read_profile

        rec.trace = read_profile(prof, rec.elapsed_s)
    memory_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    kind = torch.cuda.get_device_name(0) if is_cuda else "cpu"
    calls = drv.calls

    # the program's state goes before the reference runs
    drv.release()
    del store, plugin
    gc.unfreeze()
    gc.set_threshold(*_GC_DEFAULT_THRESHOLD)
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = drv.check()
    check_s = time.perf_counter() - t_check
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    if trace:
        rec.least_s_per_unit = drv.least_s(kind)
        metrics = {}
        for entry, reader in cell.per_layer:
            value = reader.read(rec)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in drv.end_to_end(rec.units, rec.elapsed_s).items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if is_cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": calls, "failed": drv.failed, "metrics": metrics,
           "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    if control is not None:
        out["control_checks"] = drv.check(control=control)
    out["checks"] = checks
    print(f"gpubench: reference check took {check_s:.3f} s", file=sys.stderr)
    return out


class _annotate:
    """``torch.profiler.record_function`` when tracing, else nothing."""

    def __init__(self, on: bool, name: str):
        self.ctx = None
        if on:
            import torch

            self.ctx = torch.profiler.record_function(name)

    def __enter__(self):
        if self.ctx is not None:
            self.ctx.__enter__()

    def __exit__(self, *exc):
        if self.ctx is not None:
            self.ctx.__exit__(*exc)


def _summary(xs) -> str:
    import statistics

    if len(xs) < 2:
        return f"n={len(xs)}"
    q = statistics.quantiles(xs, n=20)
    return (f"n={len(xs)} mean_s={statistics.fmean(xs):.6f} cv={statistics.stdev(xs) / statistics.fmean(xs):.4f} "
            f"p5_s={q[0]:.6f} p50_s={statistics.median(xs):.6f} p95_s={q[-1]:.6f} max_s={max(xs):.6f}")


def _check_lines(checks: dict) -> list:
    return [f"check {name}: {v['value']} limit {v['limit']}" for name, v in checks.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = resolve_cell(args.workload)
    # every build and kernel cache of the run stays inside the checkout
    build = PKG.parent / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for line in _check_lines(out["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0
