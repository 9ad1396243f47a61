"""One run of one cell: set-up, warm-up, a closed loop with one client for
the window, the comparison with the plain reference, the metrics.

What a cell is comes from files found by name under ``<root>/gpubench``:
``BENCHMARK.json`` names the cell's configuration and traffic mix;
``configs/<config>.json`` the deployment (its generator, its entry into the
system, sizes, precision, the reference's and the control's precision, the
limits of the comparison); ``traffic/<traffic>.json`` the request's
parameters; ``gen/<generator>.py`` makes the inputs from the seed;
``entries/<entry>.py`` builds the system under test and issues one request;
``metrics/<metric>.py`` reads one metric from the run (:class:`Run`).

An entry defines ``build``, ``request``, ``iterations``, ``work_bytes``,
``reference``, ``as_served`` and ``numbers``, and may define ``draws`` (the
requests' parameters drawn from the seed; one request without parameters
by default), ``complete`` (what a kept request still has to fetch once it
is served; nothing by default) and ``describe`` (a log line of the inputs
and the system).

``--trace 0`` reports the cell's end-to-end metrics. ``--trace 1`` splits
the window in two halves: the first with the program's span tracer live
(spans, steps and latencies), the second under ``torch.profiler`` (the
device trace); it reports the per-layer metrics.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import random
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from gpubench import devtrace, roofline
from gpubench.compare import judge

__all__ = ["Bench", "Run", "run_cell", "forbidden_modules", "result_line",
           "DTYPES"]

#: top-level module names a run may not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def load_file(path: Path, kind: str):
    """Import the module at ``path`` under a private name."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    name = f"_gpubench_{kind}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


class Bench:
    """What ``BENCHMARK.json`` and the files under ``<root>/gpubench`` say
    about one cell."""

    def __init__(self, root: Path, workload: str):
        root = Path(root)
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.cell = cells[workload]
        here = root / "gpubench"
        self.cfg = json.loads(
            (here / "configs" / f"{self.cell['config']}.json").read_text())
        self.traffic = json.loads(
            (here / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.entry = load_file(here / "entries" / f"{self.cfg['entry']}.py",
                               "entry")
        self.gen = load_file(here / "gen" / f"{self.cfg['generator']}.py",
                             "gen")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if applies(m, workload)]
        self.per_layer = [m for m in spec["per_layer"]
                          if applies(m, workload)]
        self.readers = {m["name"]: load_file(here / "metrics" /
                                             f"{m['name']}.py", "metric")
                        for m in self.end_to_end + self.per_layer}


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the run's clocks, spans, steps, bytes
    and (traced runs) device trace."""

    setup_s: float = 0.0
    window_s: float = 0.0           # the (first) window's wall time
    latencies: list = dataclasses.field(default_factory=list)
    iterations: list = dataclasses.field(default_factory=list)
    phases: list = dataclasses.field(default_factory=list)   # (name, t0, t1)
    program_spans: list = dataclasses.field(default_factory=list)
    trace: devtrace.DeviceTrace | None = None
    work: dict = dataclasses.field(default_factory=dict)     # bytes
    peaks: dict | None = None


class Phases:
    """The harness's spans around the calls into the system: host clock
    always, a ``record_function`` range while the profiler runs."""

    def __init__(self):
        self.records: list = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(devtrace.PHASE_PREFIX + name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))


class Reservoir:
    """A uniform sample, drawn from the seed, of the window's requests."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(int(seed) ^ 0x5A17)
        self.kept: list = []
        self.seen = 0

    def offer(self) -> int | None:
        """The slot the next request goes to, or None to drop it."""
        i = self.seen
        self.seen += 1
        if i < self.size:
            self.kept.append(None)
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.size else None


def closed_loop(bench: Bench, system, draws: list, seconds: float,
                phases: Phases, keep: Reservoir, run: Run, *,
                count_steps: bool, start: int = 0) -> dict:
    """One client, requests back to back until ``seconds`` have passed."""
    entry, cfg, traffic = bench.entry, bench.cfg, bench.traffic
    lat, failed, i = [], 0, start
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        draw = draws[i % len(draws)]
        t0 = time.perf_counter()
        try:
            with phases("request"):
                served = entry.request(system, cfg, traffic, draw, phases)
        except Exception:               # a failed request is counted
            traceback.print_exc()
            failed += 1
            i += 1
            if failed >= 10:
                break
            continue
        lat.append(time.perf_counter() - t0)
        slot = keep.offer()
        if slot is not None:
            if hasattr(entry, "complete"):
                served = entry.complete(system, served)
            keep.kept[slot] = (served, draw)
        if count_steps:
            run.iterations.append(entry.iterations(system, served))
        i += 1
    return dict(latencies=lat, failed=failed, attempted=i - start,
                window_s=time.perf_counter() - t_start)


def program_tracer():
    """Install a live span tracer of the program; returns (tracer, undo)."""
    from repro_torch.obs import trace as obs_trace
    tracer = obs_trace.Tracer(keep=1 << 20)
    prev = obs_trace.set_tracer(tracer)
    return tracer, lambda: obs_trace.set_tracer(prev)


def precision(spec: dict) -> dict:
    out = dict(storage=DTYPES[spec["storage"]],
               accumulate=DTYPES[spec["accumulate"]])
    out.update({k: v for k, v in spec.items()
                if k not in ("storage", "accumulate")})
    return out


def compare(bench: Bench, kept: list, ref: list) -> dict:
    """The worst of each number over the kept requests."""
    worst: dict = {}
    for served, draw in kept:
        for name, v in bench.entry.numbers(served, ref, bench.traffic,
                                           draw).items():
            worst[name] = max(worst.get(name, v), v)
    return worst


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def draws_of(entry, traffic: dict, inputs: dict, seed: int) -> list:
    if hasattr(entry, "draws"):
        return entry.draws(traffic, inputs, seed)
    return [None]


def run_cell(bench: Bench, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float | None = None, *,
             control: bool = False) -> dict:
    """One run; returns the result line's object (``check`` last).
    ``control``: the control in the program's place (:func:`control_run`)
    in place of the set-up and the window."""
    t0 = time.perf_counter() if t0 is None else t0
    cfg, traffic, entry = bench.cfg, bench.traffic, bench.entry
    run = Run()

    t = time.perf_counter()
    inputs = bench.gen.generate(cfg["inputs"], seed, device)
    log(f"inputs: {time.perf_counter() - t:.3f} s after {t - t0:.3f} s")
    draws = draws_of(entry, traffic, inputs, seed)
    if control:
        return control_run(bench, inputs, draws, device)
    t = time.perf_counter()
    system = entry.build(cfg, traffic, inputs, device)
    log(f"system: {time.perf_counter() - t:.3f} s")
    if hasattr(entry, "describe"):
        log(entry.describe(inputs, system))
    phases = Phases()
    for _ in range(int(traffic["warmup_requests"])):
        t = time.perf_counter()
        served = entry.request(system, cfg, traffic, draws[0], phases)
        log(f"warm-up: {entry.iterations(system, served)} steps "
            f"({time.perf_counter() - t:.3f} s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases.records.clear()
    run.setup_s = time.perf_counter() - t0
    log(f"setup_s {run.setup_s:.3f}")

    keep = Reservoir(int(traffic["compare_requests"]), seed)
    if not trace:
        out = closed_loop(bench, system, draws, seconds, phases, keep, run,
                          count_steps=False)
        attempted, failed = out["attempted"], out["failed"]
        run.latencies, run.window_s = out["latencies"], out["window_s"]
    else:
        tracer, undo = program_tracer()
        try:
            a = closed_loop(bench, system, draws, seconds / 2, phases, keep,
                            run, count_steps=True)
        finally:
            undo()
        run.program_spans = list(tracer.spans)
        run.phases = list(phases.records)
        run.latencies, run.window_s = a["latencies"], a["window_s"]
        b, run.trace = profiled(bench, system, draws, seconds / 2, phases,
                                keep, run, start=a["attempted"],
                                device=device)
        attempted = a["attempted"] + b["attempted"]
        failed = a["failed"] + b["failed"]
    info = device_info(device, int(bench.cell["chips"]))
    info["power_limit_w"] = (roofline.power_limit_w()
                             if device.type == "cuda" else None)
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    log(f"window: {attempted} requests, {failed} failed, "
        f"{run.window_s:.3f} s")
    if run.latencies:
        q = np.percentile(np.asarray(run.latencies) * 1e3,
                          [0, 50, 90, 95, 99, 100])
        log("latency ms min/p50/p90/p95/p99/max " +
            "/".join(f"{x:.3f}" for x in q))

    # the program's state goes before the reference runs on the card
    kept = [k for k in keep.kept if k is not None]
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = entry.reference(cfg, inputs, device, precision(cfg["reference"]))
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    ok, check = judge(compare(bench, kept, ref), cfg["limits"])
    correct = ok and failed == 0 and bool(kept)

    run.work = entry.work_bytes(cfg, inputs)
    run.peaks = (roofline.peaks_for(info["kind"])
                 if device.type == "cuda" else None)
    metrics = {}
    for m in (bench.per_layer if trace else bench.end_to_end):
        value = bench.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=info)
    if run.trace is not None:
        result["breakdown"] = dict(device_ops=run.trace.top_ops(),
                                   idle_gaps=run.trace.idle_gaps())
    result["check"] = check
    return result


def control_run(bench: Bench, inputs: dict, draws: list,
                device: torch.device) -> dict:
    """The control, judged as a run is: the plain reference at the
    configuration's ``control`` precision put in the program's place,
    served as the timed path reads it for as many draws as a run keeps.
    Its ``correct`` has to come out false. The benchmark's own runs do not
    run it; its readings bound the limits from above."""
    cfg, traffic, entry = bench.cfg, bench.traffic, bench.entry
    t = time.perf_counter()
    ref = entry.reference(cfg, inputs, device, precision(cfg["reference"]))
    log(f"reference: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    ctrl = entry.reference(cfg, inputs, device, precision(cfg["control"]))
    log(f"control: {time.perf_counter() - t:.3f} s")
    picked = [draws[i % len(draws)]
              for i in range(int(traffic["compare_requests"]))]
    kept = [(entry.as_served(ctrl, traffic, d), d) for d in picked]
    ok, check = judge(compare(bench, kept, ref), cfg["limits"])
    return dict(correct=ok, attempted=len(kept), failed=0, metrics={},
                device=device_info(device, int(bench.cell["chips"])),
                check=check)


def profiled(bench: Bench, system, draws: list, seconds: float,
             phases: Phases, keep: Reservoir, run: Run, *, start: int,
             device: torch.device):
    """The second half of a traced window, under ``torch.profiler``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    phases.profiling = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            w0 = time.time_ns()
            out = closed_loop(bench, system, draws, seconds, phases, keep,
                              run, count_steps=True, start=start)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            w1 = time.time_ns()
    finally:
        phases.profiling = False
    return out, devtrace.read_trace(prof, (w0, w1))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden (whole names)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="1: the control in the program's place, no window "
                        "(its correct has to come out false)")
    return p.parse_args(argv)


def main(root: Path, args, device_type: str, t0: float) -> int:
    """Run the cell and print its result line; the exit code."""
    bench = Bench(root, args.workload)
    if device_type == "cuda":
        chips = int(bench.cell["chips"])
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            log(f"no result: the cell needs {chips} CUDA card(s); "
                f"available={torch.cuda.is_available()}")
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    result = run_cell(bench, args.seed, args.seconds, bool(args.trace),
                      device, t0=t0, control=bool(args.control))
    found = forbidden_modules()
    if found:
        log(f"no result: the run loaded forbidden modules {found}")
        return 3
    line = result_line(result)
    print(line, flush=True)
    return 0


def result_line(result: dict) -> str:
    """Print the compared numbers as the last lines of stderr; return the
    stdout line."""
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return json.dumps(result)
