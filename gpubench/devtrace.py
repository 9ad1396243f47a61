"""The device trace of a traced window, from ``torch.profiler``.

:func:`read_trace` reduces a finished profile to what the metric readers
take: each device operation's name, start and end (kernels, copies and
sets; the profiler's GPU-side annotation ranges left out), the harness's
phase annotations on the host, the window's length, the seconds in which
any device operation ran (the union of their intervals), and the idle gaps
between them, each named by the host phase it began in and the device
operation that ended it.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeviceTrace", "read_trace", "PHASE_PREFIX"]

#: prefix of the harness's ``record_function`` phase names
PHASE_PREFIX = "gpubench."


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    ops: list            # (name, start_ns, end_ns) of device operations
    phases: list         # (name, start_ns, end_ns) of harness phases

    @property
    def busy_s(self) -> float:
        busy, reach = 0, None
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if reach is None or a > reach:
                busy += b - a
                reach = b
            elif b > reach:
                busy += b - reach
                reach = b
        return busy * 1e-9

    def kernel_seconds(self, fragment: str) -> tuple[float, int]:
        """(device seconds, launches) of the ops whose name holds
        ``fragment``."""
        hits = [(b - a) for name, a, b in self.ops if fragment in name]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, k: int = 10) -> list:
        total: dict[str, int] = {}
        for name, a, b in self.ops:
            key = short_name(name)
            total[key] = total.get(key, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle time between device operations, summed by (host phase
        at the gap's start, next device operation), largest first."""
        ops = sorted(self.ops, key=lambda o: o[1])
        phases = sorted(self.phases, key=lambda p: p[1])
        total: dict[str, int] = {}
        reach = None
        for name, a, b in ops:
            if reach is not None and a > reach:
                key = f"{phase_at(phases, reach)} > {short_name(name)}"
                total[key] = total.get(key, 0) + (a - reach)
            reach = b if reach is None else max(reach, b)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[key, ns * 1e-9] for key, ns in top]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base = base.split("(")[0].split("<")[0].strip()
    return base.split("::")[-1] if base else name[:64]


def phase_at(phases: list, t: int) -> str:
    """The innermost harness phase open at ``t`` (host clock), or "host"."""
    best = None
    for name, a, b in phases:
        if a > t:
            break
        if b >= t and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0].removeprefix(PHASE_PREFIX) if best else "host"


def read_trace(prof, window_ns: tuple[int, int]) -> DeviceTrace:
    """Reduce a stopped ``torch.profiler.profile`` whose window ran from
    ``window_ns[0]`` to ``window_ns[1]`` (``time.time_ns``, the profiler's
    clock)."""
    ops, phases = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and b > a:
                ops.append((name, a, b))
        elif name.startswith(PHASE_PREFIX):
            phases.append((name, a, b))
    return DeviceTrace(window_s=(window_ns[1] - window_ns[0]) * 1e-9,
                       ops=ops, phases=phases)
