"""The harness: finds a workload's configuration, traffic mix, limits and
per-layer readers by name, runs the mix's driver, and prints the result.

A driver (`drivers/<kind>.py`) exposes `run(ctx) -> Outcome`: it builds the
program's objects and inputs from `ctx.seed` (set-up), runs the measured
window through `ctx.window()`, reads the device's memory peak, frees the
program's state, and computes the numbers that decide `correct` with
`ctx.reference_prec()`'s reference.  Everything a driver needs of a cell
comes from the three data files; adding a cell or a metric adds files.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names that may not be loaded in the result's process
FORBIDDEN = ("jax", "jaxlib", "flax", "pwn_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(man: dict, workload: str, root: Path = ROOT) -> dict:
    """The data files of a workload, found by name: its configuration's
    file, `traffic/<mix>.json` and `checks/<workload>.json`."""
    w = workload_entry(man, workload)
    config = next(c["file"] for c in man["configs"] if c["name"] == w["config"])
    return {"config": root / config,
            "traffic": PKG / "traffic" / f"{w['traffic']}.json",
            "checks": PKG / "checks" / f"{workload}.json"}


def metrics_for(man: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of `workload` reports: with trace the per-layer
    ones (each that lists the cell, or lists none and moves an end-to-end
    metric the cell reports), else the end-to-end ones."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def metric_reader(name: str):
    """`metrics/<name>.py`'s `read(run) -> float | None`."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(ctx: "Context"):
    """The module `drivers/<kind>.py` that the cell's traffic mix names."""
    return importlib.import_module(f"perfbench.drivers.{ctx.traffic['driver']}")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names, compared whole, among `names`
    (default: the modules loaded in this process)."""
    tops = {m.split(".")[0] for m in
            (list(sys.modules) if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end quantities by metric name,
    requests attempted and failed, the numbers compared (name -> value),
    and for the per-layer readers its counts and spans."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, float]
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def process_cpu_s() -> float:
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop, the least of three: the
    speed of the host's core for the single-threaded Python the host-bound
    cells spend their steps in (read after the window, so that runs on
    different machines or cores can be told apart)."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(300_000):
            acc += i * i % 7
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


class Window:
    """The measured window: `running()` until `seconds` have passed since
    entry; `close()` synchronizes the card and fixes `elapsed_s`.  In a
    traced run the profiler covers exactly the window."""

    def __init__(self, ctx: "Context"):
        self.ctx = ctx
        self.seconds = ctx.window_seconds
        self.trace = None
        self.elapsed_s = None

    def __enter__(self) -> "Window":
        ctx = self.ctx
        ctx.setup_s = time.monotonic() - ctx.t_start
        self._prof = None
        self._cpu0 = process_cpu_s()
        if ctx.trace:
            from perfbench.trace import Profiler

            self._prof = Profiler()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds
        return self

    def running(self) -> bool:
        return time.perf_counter() < self.deadline

    def close(self) -> float:
        if self.elapsed_s is None:
            self.ctx.sync()
            self.elapsed_s = time.perf_counter() - self.t0
            cpu_share = (process_cpu_s() - self._cpu0) / self.elapsed_s
            if self._prof is not None:
                self.trace = self._prof.stop()
            self.ctx.host = {"process_cpu_share": cpu_share,
                             "python_loop_ms": host_probe_ms()}
        return self.elapsed_s

    def __exit__(self, *exc) -> None:
        self.close()


class Context:
    """One run of one workload: its entries and files, the seed, the
    device, whether the window is traced, and what the check compares:
    `candidate` "program" (the run), "fp8" (the control: the reference in
    the next precision below in the program's place), or a fault planted
    in the program (`fault`)."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device=None, root: Path = ROOT,
                 candidate: str = "program", fault: Optional[str] = None,
                 overrides: Optional[dict] = None,
                 t_start: Optional[float] = None):
        import torch

        self.torch = torch
        self.man = manifest(root)
        self.workload = workload
        files = cell_files(self.man, workload, root)
        self.config = load_json(files["config"])
        self.traffic = load_json(files["traffic"])
        self.checks = (load_json(files["checks"])
                       if files["checks"].exists() else {"limits": {}})
        for k, v in (overrides or {}).items():
            self.traffic[k] = v
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.window_seconds = (min(self.seconds, self.traffic["trace_seconds"])
                               if trace else self.seconds)
        self.device = torch.device(device) if device is not None else \
            torch.device("cuda", 0)
        self.candidate = candidate
        self.fault = fault
        self.t_start = time.monotonic() if t_start is None else t_start
        self.setup_s = None
        self.host = {}
        self.memory_peak = None
        self.on_card = self.device.type == "cuda"

    # -- the program's configuration, checked against the file ------------
    def program_config(self):
        """The program's preset with the file's overrides, after checking
        that every size the file states is the one the program runs."""
        from pwn_tpu_torch.config import get_config

        c = self.config
        cfg = get_config(c["preset"], **c.get("overrides", {}))
        model = cfg.student if c["model"] == "student" else cfg.teacher
        stated = {**{k: v for k, v in c["sizes"].items()},
                  **{f"dsp.{k}": v for k, v in c["dsp"].items()},
                  **{f"train.{k}": v for k, v in c.get("train", {}).items()}}
        for key, want in stated.items():
            if key.startswith(("dsp.", "train.")):
                sec, field = key.split(".")
                got = getattr(getattr(cfg, sec), field)
            elif key == "n_mels":
                got = cfg.dsp.n_mels
            elif key in ("upsample_strides", "upsample_kernel_mult"):
                got = getattr(cfg.teacher, key)
            else:
                got = getattr(model, key)
            if isinstance(got, tuple):
                got = list(got)
            if got != want:
                raise ValueError(f"{self.config['name']}: the file states "
                                 f"{key} = {want!r}, the program runs {got!r}")
        return cfg

    def sizes(self) -> dict:
        return self.config["sizes"]

    def sub_seeds(self, n: int) -> list:
        from perfbench.traffic_gen import seed_ints

        return seed_ints(self.seed, n)

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize(self.device)

    def window(self) -> Window:
        return Window(self)

    def read_memory(self) -> None:
        """The device's memory peak so far, read before the reference
        runs."""
        if self.on_card:
            self.sync()
            self.memory_peak = self.torch.cuda.max_memory_allocated(
                self.device)
        else:
            self.memory_peak = 0

    def free(self) -> None:
        import gc

        gc.collect()
        if self.on_card:
            self.torch.cuda.empty_cache()

    def reference_prec(self) -> str:
        return "fp8" if self.candidate == "fp8" else "fp32"


def verdict(ctx: Context, out: Outcome) -> tuple:
    """(correct, {name: {"value", "limit"}}) against `checks/<cell>.json`;
    a number with no limit there is reported with limit null and fails."""
    limits = ctx.checks.get("limits", {})
    rows = {}
    ok = True
    for name, value in out.checks.items():
        lim = limits.get(name)
        rows[name] = {"value": value, "limit": lim}
        if lim is None or not (value <= lim):
            ok = False
    if not out.checks:
        ok = False
    return ok, rows


def result_line(ctx: Context, out: Outcome, trace_obj=None) -> dict:
    """The run's result: the cell's metrics, the device, the breakdown of a
    traced run, and the numbers compared last."""
    torch = ctx.torch
    metrics = {}
    for m in metrics_for(ctx.man, ctx.workload, ctx.trace):
        if ctx.trace:
            value = metric_reader(m["name"])(RunView(ctx, out, trace_obj))
            if value is None:
                continue
        elif m["name"] == "setup_s":
            value = ctx.setup_s
        else:
            value = out.e2e[m["name"]]
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.on_card else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.on_card else "cpu"),
              "count": 1, "memory_peak_bytes": int(ctx.memory_peak)}
    line = {"correct": None, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if ctx.trace and trace_obj is not None:
        device["busy_s"] = trace_obj.busy_s
        device["window_s"] = trace_obj.window_s
        line["breakdown"] = {"device_ops": trace_obj.top_device_ops(),
                             "idle_gaps": trace_obj.idle_gaps()}
    ok, rows = verdict(ctx, out)
    line["correct"] = ok
    line["checks"] = rows
    return line


class RunView:
    """What a per-layer reader sees of a traced run: the configuration's
    sizes, the `Trace`, and the driver's counts and spans."""

    def __init__(self, ctx: Context, out: Outcome, trace_obj):
        self.sizes = ctx.sizes()
        self.trace = trace_obj
        self.counts = out.counts
        self.spans = out.spans
