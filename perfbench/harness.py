"""One cell of the benchmark, run once: set-up, the measured window, an
optional traced segment, the check against the plain reference and the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in BENCHMARK.json:
  perfbench/configs/<config>.json     sizes, generator, dtype, batch,
                                      residual limit, reduced / assumed
  perfbench/reference/<generator>.py  the frozen structure generator
  perfbench/traffic/<traffic>.json    the mix's parameters, "step" among
                                      them
  perfbench/steps/<step>.py           what one step of that mix does:
                                      check(traffic), and Mix(cell,
                                      traffic, seed) with step(i, span),
                                      work(), release(), judge(i, output)
  perfbench/metrics/<metric>.py       read(run) -> value or None

The harness is one closed-loop client: it times each step of the mix
until the window closes, keeps a sample of the steps' outputs, and has
the mix judge them by the plain reference once the window has closed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import program
from . import trace as tr
from . import work as wk

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "baspacho_tpu")
TRACE_SECONDS = 0.5          # traced steps: about this long,
TRACE_STEPS = (3, 20)        # at least 3 and at most 20 of them
TRACE_TRIES = 3
WARM_STEPS = 2
CHECKED_STEPS = 16           # outputs kept for the check, besides the last


class NoCard(RuntimeError):
    pass


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_spec(bench: dict, workload: str) -> tuple:
    """(workload entry, configuration file's contents, traffic)."""
    wl = named(bench["workloads"], workload, "workload")
    cfg_entry = named(bench["configs"], wl["config"], "config")
    cfg = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     wl["traffic"] + ".json"))
    step_module(traffic["step"]).check(traffic)
    return wl, cfg, traffic


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _module(folder: str, name: str):
    """perfbench/<folder>/<name>.py, loaded by its path."""
    key = f"perfbench.{folder}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(HERE, folder, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def reader(name: str) -> Callable:
    return _module("metrics", name).read


def step_module(name: str):
    return _module("steps", name)


@contextmanager
def no_span(name: str):
    yield


class Timed:
    """Spans that add up the host seconds spent in each name."""

    def __init__(self):
        self.s: Dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark's process
    must not hold (compared whole: baspacho_tpu_torch is not
    baspacho_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, "
                     f"{torch.cuda.device_count()} found")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi: rc {out.returncode}"


@dataclass
class Run:
    """What the per-layer readers read."""
    stages: Dict[str, float]
    steps: int = 0
    wall_s: float = 0.0
    step_s: List[float] = field(default_factory=list)
    span_s: Dict[str, float] = field(default_factory=dict)
    launches: int = 0
    work: Dict[str, wk.Work] = field(default_factory=dict)
    peak: Optional[tuple] = None
    trace: Optional[tr.Trace] = None


class Cell:
    """A configuration on one device: its pattern and the port's solver
    and programs (set-up once), then a seed's inputs as the traffic's
    step module lays them out (load), its window and its check."""

    def __init__(self, cfg: dict, traffic: dict, device, stages: dict):
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.stages = stages
        gen = importlib.import_module(
            f"perfbench.reference.{cfg['generator']}")
        with self.stage("structure"):
            self.pattern = gen.pattern(cfg["params"])
        with self.stage("analysis"):
            self.solver = program.analyse(self.pattern, self.device)
        with self.stage("programs"):
            program.build_programs(self.solver)
        self.mix = None

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.stages[name] = self.stages.get(name, 0.0) + \
            time.perf_counter() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def load(self, seed: int, dtype: Optional[str] = None) -> None:
        """The mix's inputs of `seed` (in the configuration's dtype unless
        named), warmed up with a few steps."""
        self.mix = None
        self.seed = seed
        self.dtype = dtype or self.cfg["dtype"]
        self.mix = step_module(self.traffic["step"]).Mix(self, self.traffic,
                                                         seed)
        with self.stage("warm"):
            for i in range(WARM_STEPS):
                out = self.mix.step(i, no_span)
            self.store = out.new_empty((CHECKED_STEPS,) + tuple(out.shape))

    def work(self) -> Dict[str, wk.Work]:
        return self.mix.work()

    def keep(self, i: int, out: torch.Tensor, rng) -> None:
        """Reservoir sampling of the steps' outputs (copies), and the
        last one."""
        k = CHECKED_STEPS
        slot = i if i < k else int(rng.integers(0, i + 1))
        if slot < k:
            self.store[slot].copy_(out)
            self.kept[slot] = i
        self.last = (i, out)

    def window(self, seconds: float, run: Run) -> None:
        """Steps until `seconds` have passed (at least one), each timed
        from its start to its return."""
        rng = np.random.default_rng([int(self.seed) % (1 << 63), 2])
        self.kept: Dict[int, int] = {}
        spans = Timed()
        before = program.launches()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while i == 0 or time.perf_counter() < deadline:
            a = time.perf_counter()
            out = self.mix.step(i, spans)
            run.step_s.append(time.perf_counter() - a)
            self.keep(i, out, rng)
            i += 1
        run.steps, run.wall_s = i, time.perf_counter() - t0
        run.launches = program.launches() - before
        run.span_s = spans.s

    def traced(self, step_s: float) -> Optional[tr.Trace]:
        """A profiler trace of a few steps (after a lead-in and one step
        left out, as chip_smoke.py's trace does, since the profiler can
        lose its first records), taken again while the port's kernels in
        the factor and solve spans differ in number from the launches
        the counters saw; None if no try is complete."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        lo, hi = TRACE_STEPS
        steps = max(lo, min(hi, round(TRACE_SECONDS / max(step_s, 1e-9))))
        names = program.kernel_names()

        def span(name):
            return record_function(tr.SPAN_PREFIX + name)

        for tries in range(1, TRACE_TRIES + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(0.05 * 4 ** (tries - 1))
                self.mix.step(0, no_span)
                before = program.launches()
                with record_function(tr.STEPS_RANGE):
                    for i in range(steps):
                        with span("step"):
                            self.mix.step(i, span)
                launched = program.launches() - before
            got = tr.read(prof.events(), DeviceType.CUDA, steps, names)
            seen = sum(got.port_by_span.get(k, 0)
                       for k in ("factor", "solve"))
            if seen == launched:
                return got
            print(f"trace {tries}: {seen} records of the port's kernels in "
                  f"factor and solve for {launched} launches; taken again",
                  file=sys.stderr, flush=True)
        return None

    def checked(self) -> list:
        """(step, output) of the kept steps and the last, once each."""
        out = {i: self.store[slot] for slot, i in self.kept.items()}
        out[self.last[0]] = self.last[1]
        return sorted(out.items())

    def check(self, limit: float) -> dict:
        """The mix's judgement of the kept outputs by the plain
        reference, once the program's buffers are freed."""
        outs = self.checked()
        self.last = None
        self.mix.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        worst, failed = 0.0, 0
        for i, out in outs:
            m = self.mix.judge(i, out)
            worst = max(worst, m)
            failed += not m <= limit
        self.mix = self.store = None
        return {"residual_max": worst, "checked": len(outs),
                "failed": failed}


def end_to_end(run: Run, setup_s: float) -> Dict[str, float]:
    return {"step_ms": run.wall_s / run.steps * 1e3,
            "step_p95_ms": float(np.percentile(run.step_s, 95)) * 1e3,
            "setup_s": setup_s}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             start: float, device=None, dtype: Optional[str] = None,
             hook: Optional[Callable] = None, out=sys.stdout,
             cfg: Optional[dict] = None) -> dict:
    """One run of `workload`; returns the result line's object. `device`
    None means the card, which must be there. `dtype`, `hook` (called
    with the Cell once it is loaded, to break the timed path) and `cfg`
    (in place of the workload's configuration) are for the control and
    the tests."""
    bench = benchmark()
    wl, cfg_file, traffic = cell_spec(bench, workload)
    cfg = cfg or cfg_file
    if device is None:
        require_cards(wl["chips"])
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"

    def say(*a):
        print(*a, file=out, flush=True)

    if cuda:
        say(f"card: {torch.cuda.get_device_name(device)}; "
            f"nvidia-smi name, power limit: {power_limit()}")
    say(f"config {wl['config']}: reduced {cfg['reduced']}; "
        f"assumed {json.dumps(cfg['assumed'])}")
    stages = {"imports": time.perf_counter() - start}
    cell = Cell(cfg, traffic, device, stages)
    cell.load(seed, dtype)
    if hook is not None:
        hook(cell)
    setup_s = time.perf_counter() - start
    sk = cell.solver.skel
    say(f"solver: order {sk.order}, lumps {sk.num_lumps}, data_size "
        f"{sk.data_size}, batch {cfg['batch']}, {cell.dtype}")
    say("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; total {setup_s:.3f}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(stages=stages)
    cell.window(seconds, run)
    lat = np.asarray(run.step_s) * 1e3
    say(f"window: {run.steps} steps in {run.wall_s:.6f} s; step ms "
        f"median {np.median(lat):.6f}, p95 {np.percentile(lat, 95):.6f}, "
        f"max {lat.max():.6f}; launches/step {run.launches / run.steps}")
    run.work = cell.work()
    if cuda and trace:
        run.peak = wk.peaks(torch.cuda.get_device_name(device), cell.dtype)
        run.trace = t = cell.traced(run.wall_s / run.steps)
        if t is None:
            print(f"trace: no complete trace in {TRACE_TRIES} tries; the "
                  "metrics read from it are left out", file=sys.stderr,
                  flush=True)
        else:
            say(f"trace: {t.steps} steps in {t.window_s:.6f} s, busy "
                f"{t.busy_s:.6f} s; device s by span "
                f"{json.dumps(t.device_s_by_span)}; records by span "
                f"{json.dumps(t.kernels_by_span)}; the port's kernels by "
                f"span {json.dumps(t.port_by_span)}; unattributed "
                f"{t.unattributed}")
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda
           else device.type,
           "count": wl["chips"],
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
           if cuda else 0}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    limit = cfg["residual_limit"]
    t0 = time.perf_counter()
    chk = cell.check(limit)
    say(f"check: {chk['checked']} steps' solutions against the reference "
        f"in {time.perf_counter() - t0:.3f} s")
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, workload):
                v = reader(m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(run, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, workload)}
    result = {"correct": chk["failed"] == 0 and chk["checked"] > 0,
              "attempted": run.steps, "failed": chk["failed"],
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {"residual_max": {"value": chk["residual_max"],
                                         "limit": limit}}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules the benchmark must not load: {found}")
    return result
