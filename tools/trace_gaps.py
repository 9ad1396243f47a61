"""Name each idle gap of a benchmark cell's device trace by the host work
that opened it, and time what the program's spans cost when they are on.

Usage (on a machine with a CUDA card, from the root of a checkout)::

    python3 tools/trace_gaps.py --workload g500s22.cold --seed N \
        [--seconds 8] [--rounds 4] [--out FILE]

It sets the cell up as the benchmark does (``gpubench``: the cell's
generator, its entry and its warm-up requests), then:

* **build**: the entry's ``build`` on the host clock, with a live span
  tracer, and the program's ``engine.prepare`` and ``format.build`` spans
  inside it (the rest of ``build`` is the host graph's construction);
* **span cost**: ``--rounds`` rounds of three requests with the per-step
  spans off and three with them on, each under a live tracer, so each
  request's ``engine.run`` span is the benchmark's ``engine_run_ms``
  reading (the order alternates, ABBA), with the median of each span the
  rounds record; and the host's time for one empty span with nothing
  recording, under a live tracer, and under the profiler (:func:`span_cost`);
* **gaps**: six windows of ``--seconds`` under ``torch.profiler``, two of
  each arm (:data:`ARMS`, in turn and back): the spans as they are, their
  profiler ranges opened through ``record_function``, and no per-step
  span. Each window gives the device's busy and idle share, and every
  idle gap between two device operations named ``<phase>/<span> > <op>``:
  the harness's phase and the innermost program span open on the host
  when the gap began, and the operation that ended it (``<phase> > <op>``
  where no program span was open). The device's and the host's clocks in
  a profile drift apart by up to hundreds of microseconds, so a gap's
  start is first taken to the host's clock (:func:`attribute`). A window
  with the per-step spans also gives the share of the idle seconds inside
  the ``solve`` phase that a program span names, and ``step_idle_us``:
  the idle seconds of the gaps that open inside ``engine.issue`` or
  ``engine.gap_read`` (or a span inside them) over the count of
  ``engine.issue`` ranges.

It prints one JSON object (the card's name and power limit first); ``--out``
also writes it to a file. ``--root`` runs the cell of another tree (such as
a copy of ``gpubench`` with smaller configurations) and ``--device cpu``
rehearses the flow without a card (no device operations, so no gaps).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: the spans of one body of the solver loop
LOOP_SPANS = ("engine.issue", "engine.gap_read")
#: the profiled windows' arms (:class:`_Arm`), run in this order and back
ARMS = ("fast", "record_function", "off")


def reduce_profile(prof, prefix: str) -> tuple[list, list, list]:
    """(device ops, harness phases, program spans) of a stopped profile.
    An op is (name, start_ns, end_ns, lead_ns): the ops ``gpubench.devtrace``
    keeps, ``lead_ns`` its start less the start of the ATen operator on the
    host that launched it (None where none did). A phase or a span is
    (name, start_ns, end_ns): the phases the host ranges whose name starts
    with ``prefix``, the spans every other host range whose name is the
    program's form of one (``layer.what``, as ``engine.issue``; an ATen
    operator's holds ``::``)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    aten = {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() != cuda and "::" in e.name()}
    ops, phases, spans = [], [], []
    for e in events:
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and b > a:
                launched = aten.get(e.linked_correlation_id())
                ops.append((name, a, b,
                            None if launched is None else a - launched))
        elif name.startswith(prefix):
            phases.append((name, a, b))
        elif "." in name and "::" not in name:
            spans.append((name, a, b))
    return ops, phases, spans


def clock_offsets(gaps: list, *, bin_ns: int = 50_000_000,
                  min_gap_ns: int = 20_000) -> dict:
    """The device clock less the host's, a bin of device time at a time:
    the median ``lead_ns`` of the ops that end an idle gap of at least
    ``min_gap_ns`` (the device was idle, so each started as soon as it was
    launched). Keyed by bin; ``None`` holds the median over every bin."""
    leads: dict = {}
    for reach, gap, _, lead in gaps:
        if lead is not None and gap >= min_gap_ns:
            leads.setdefault(reach // bin_ns, []).append(lead)
    every = [x for v in leads.values() for x in v]
    out = {k: statistics.median(v) for k, v in leads.items()}
    out[None] = statistics.median(every) if every else 0
    return out


def attribute(ops: list, phases: list, spans: list, window_s: float, *,
              bin_ns: int = 50_000_000) -> dict:
    """Every idle gap between device operations, named by the phase and
    the innermost program span open on the host when it began (see the
    module docstring); with the busy and idle seconds and
    ``step_idle_us``. A gap's start is taken to the host's clock by the
    device clock's offset in its bin (:func:`clock_offsets`), so it may
    come out early by up to a launch's latency."""
    from gpubench.devtrace import DeviceTrace, phase_at, short_name
    ops = sorted(ops, key=lambda o: o[1])
    phases = sorted(phases, key=lambda p: p[1])
    spans = sorted(spans, key=lambda s: s[1])
    found, reach = [], None          # (reach, gap_ns, next op, its lead)
    for name, a, b, lead in ops:
        if reach is not None and a > reach:
            found.append((reach, a - reach, name, lead))
        reach = b if reach is None else max(reach, b)
    offsets = clock_offsets(found, bin_ns=bin_ns)
    starts = sorted((reach - offsets.get(reach // bin_ns, offsets[None]),
                     gap, name) for reach, gap, name, _ in found)
    gaps: dict[str, int] = {}
    solve_ns = solve_named_ns = loop_ns = idle_ns = 0
    open_spans: list = []
    nxt = 0
    for t, gap, name in starts:
        while nxt < len(spans) and spans[nxt][1] <= t:
            open_spans.append(spans[nxt])
            nxt += 1
        open_spans = [s for s in open_spans if s[2] >= t]
        phase = phase_at(phases, t)
        inner = max(open_spans, key=lambda s: s[1])[0] \
            if open_spans else None
        key = (f"{phase}/{inner}" if inner else phase) + \
            f" > {short_name(name)}"
        gaps[key] = gaps.get(key, 0) + gap
        idle_ns += gap
        if phase == "solve":
            solve_ns += gap
            solve_named_ns += gap if inner else 0
        if any(s[0] in LOOP_SPANS for s in open_spans):
            loop_ns += gap
    steps = sum(1 for s in spans if s[0] == LOOP_SPANS[0])
    busy_s = DeviceTrace(window_s=window_s,
                         ops=[o[:3] for o in ops], phases=[]).busy_s
    binned = [v for k, v in offsets.items() if k is not None]
    return dict(
        window_s=window_s, busy_s=busy_s,
        device_idle_pct=(100.0 * (1.0 - busy_s / window_s)
                         if ops and window_s > 0 else None),
        linked_ops=sum(o[3] is not None for o in ops),
        clock_offset_us=dict(median=offsets[None] * 1e-3,
                             low=min(binned, default=0) * 1e-3,
                             high=max(binned, default=0) * 1e-3),
        gap_idle_s=idle_ns * 1e-9, solve_idle_s=solve_ns * 1e-9,
        solve_idle_named_share=(solve_named_ns / solve_ns
                                if solve_ns else None),
        loop_idle_s=loop_ns * 1e-9, steps=steps,
        step_idle_us=loop_ns * 1e-3 / steps if steps else None,
        spans={n: sum(1 for s in spans if s[0] == n)
               for n in sorted({s[0] for s in spans})},
        gaps=[[k, ns * 1e-9] for k, ns in
              sorted(gaps.items(), key=lambda kv: -kv[1])])


class _Arm:
    """The program's spans as one arm of a comparison has them, for the
    life of a ``with``: ``fast`` as they are; ``record_function``, their
    profiler ranges opened through ``torch.profiler.record_function``;
    ``off``, no per-step span (``hot_span`` gives ``NO_SPAN``)."""

    def __init__(self, arm: str):
        self.arm = arm

    def __enter__(self):
        from torch.autograd import profiler
        from repro_torch.obs import trace
        self.saved = trace.hot_span, trace._RANGE
        if self.arm == "off":
            trace.hot_span = lambda name: trace.NO_SPAN
        elif self.arm == "record_function":
            trace._RANGE = profiler.record_function
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import trace
        trace.hot_span, trace._RANGE = self.saved
        return False


def span_cost(device, n: int = 100_000) -> dict:
    """The host's microseconds for one empty ``hot_span`` with nothing
    recording, under a live tracer, and under the profiler with each
    arm's range."""
    from repro_torch.obs import trace

    def per_span():
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.hot_span("probe.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    out = dict(off=per_span())
    tracer = trace.Tracer(keep=16)
    prev = trace.set_tracer(tracer)
    try:
        out["tracer"] = per_span()
    finally:
        trace.set_tracer(prev)
    for arm in ARMS[:2]:
        with _Arm(arm), torch.profiler.profile(
                activities=_activities(device)):
            out[f"profiler_{arm}"] = per_span()
    return out


def _activities(device) -> list:
    kinds = torch.profiler.ProfilerActivity
    return [kinds.CPU] + ([kinds.CUDA] if device.type == "cuda" else [])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(root: Path, workload: str, seed: int, seconds: float,
            rounds: int, device) -> dict:
    from gpubench import devtrace, harness, roofline
    from repro_torch.obs import trace
    bench = harness.Bench(root, workload)
    cfg, traffic, entry = bench.cfg, bench.traffic, bench.entry
    out: dict = dict(
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        power_limit_w=(roofline.power_limit_w() if device.type == "cuda"
                       else None),
        workload=workload, seed=seed, torch=torch.__version__)
    inputs = bench.gen.generate(cfg["inputs"], seed, device)
    draws = harness.draws_of(entry, traffic, inputs, seed)
    tracer = trace.Tracer(keep=1 << 20)
    prev = trace.set_tracer(tracer)
    try:
        t0 = time.perf_counter()
        system = entry.build(cfg, traffic, inputs, device)
        build_s = time.perf_counter() - t0
    finally:
        trace.set_tracer(prev)
    out["build"] = dict(entry_build_s=build_s, spans=[
        [r["name"], r["dur"]] for r in tracer.spans])
    phases = harness.Phases()
    for _ in range(int(traffic["warmup_requests"])):
        entry.request(system, cfg, traffic, draws[0], phases)
    _sync(device)

    def request(i):
        return entry.request(system, cfg, traffic, draws[i % len(draws)],
                             phases)

    cost: dict = {"off": [], "fast": []}
    span_s: dict = {}
    i = 0
    for r in range(rounds):
        for arm in (("off", "fast") if r % 2 == 0 else ("fast", "off")):
            tracer = trace.Tracer(keep=1 << 20)
            prev = trace.set_tracer(tracer)
            try:
                with _Arm(arm):
                    for _ in range(3):
                        request(i)
                        i += 1
            finally:
                trace.set_tracer(prev)
            for rec in tracer.spans:
                span_s.setdefault(rec["name"], []).append(rec["dur"])
            cost[arm] += [rec["dur"] * 1e3 for rec in tracer.spans
                          if rec["name"] == "engine.run"]
    out["engine_run_ms"] = {k: dict(median=statistics.median(v), runs=v)
                            for k, v in cost.items() if v}
    out["span_median_us"] = {k: statistics.median(v) * 1e6
                             for k, v in span_s.items()}
    out["span_cost_us"] = span_cost(device)

    windows = []
    for arm in ARMS + ARMS[::-1]:
        phases.profiling = True
        try:
            with _Arm(arm), torch.profiler.profile(
                    activities=_activities(device)) as prof:
                w0 = time.time_ns()
                t_start, n = time.perf_counter(), 0
                while time.perf_counter() - t_start < seconds or n == 0:
                    request(i)
                    i += 1
                    n += 1
                _sync(device)
                w1 = time.time_ns()
        finally:
            phases.profiling = False
        ops, ph, spans = reduce_profile(prof, devtrace.PHASE_PREFIX)
        got = attribute(ops, ph, spans, (w1 - w0) * 1e-9)
        got.update(arm=arm, requests=n)
        windows.append(got)
    out["windows"] = windows
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="g500s22.cold")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--root", type=Path, default=ROOT)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", type=Path)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[0:0] = [str(ROOT), str(ROOT / "src")]
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    out = measure(args.root, args.workload, args.seed, args.seconds,
                  args.rounds, device)
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
