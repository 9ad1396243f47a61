"""Declarative SLOs, error budgets, and multi-window burn-rate alerts.

The telemetry plane (:mod:`repro_torch.obs.metrics`) measures; this module
*judges*. An :class:`SLO` names a signal (a callable reading the live
registry or convergence tracker), a target, and a compliance objective;
the :class:`SLOEngine` samples every SLO on each :meth:`SLOEngine.tick`,
keeps a compliance window per SLO, accounts the error budget, and fires
multi-window burn-rate alerts as countable :mod:`repro_torch.obs.log` events.

Burn-rate math (classic SRE form, windows scaled to drill time):

* error budget = ``1 - objective`` (e.g. objective 0.99 → 1% budget);
* burn rate over a window = (fraction of non-compliant samples in the
  window) / budget — burn 1.0 spends the budget exactly at the rate the
  compliance period allows, burn ``B`` exhausts it ``B``× faster;
* an alert rule pairs a *fast* and a *slow* window with one threshold
  and fires only when **both** exceed it — the fast window gives low
  detection latency, the slow window suppresses one-tick blips.

Production rules use 5m/1h at burn 14.4 and 30m/6h at burn 6; the drill
catalog (:func:`default_slos`) keeps those ratios but compresses the
absolute spans via ``time_scale`` so a seconds-long chaos drill can
exercise the full alert path.

Signals read process-wide state lazily (``metrics.get_registry()`` at
call time), so an engine built before ``obs.configure`` still sees the
live registry. A signal returning ``None`` means "no data yet" and
counts as compliant — absence of traffic is not an outage.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Optional, Sequence

from . import log as obs_log
from . import metrics as obs_metrics
from . import trace as obs_trace

__all__ = ["SLO", "BurnRule", "SLOEngine", "default_slos",
           "histogram_quantile", "gauge_value", "counter_ratio",
           "DRILL_TIME_SCALE"]

#: canonical SRE burn-rate rules: (fast_window_s, slow_window_s, burn)
CANONICAL_RULES = ((300.0, 3600.0, 14.4), (1800.0, 21600.0, 6.0))

#: compression factor mapping the canonical hour-scale windows onto a
#: seconds-scale chaos drill (5m/1h → 1.5s/18s; 30m/6h → 9s/108s)
DRILL_TIME_SCALE = 1.0 / 200.0


# --------------------------------------------------------------------- #
# signal helpers — callables the SLO catalog is built from
# --------------------------------------------------------------------- #
def histogram_quantile(name: str, q: float) -> Callable[[], Optional[float]]:
    """Pooled (all-label) q-quantile of a live histogram, None if empty."""
    def read():
        fam = obs_metrics.get_registry().get(name)
        if fam is None or fam.kind != "histogram":
            return None
        pooled = fam.merged()
        return None if pooled.count == 0 else pooled.quantile(q)
    read.__name__ = f"{name}:p{int(q * 100)}"
    return read


def gauge_value(name: str, **labels) -> Callable[[], Optional[float]]:
    """Current gauge value, None while the gauge has never been set."""
    def read():
        return obs_metrics.get_registry().value(name, **labels)
    read.__name__ = name
    return read


def counter_ratio(numerator: str, denominator: str
                  ) -> Callable[[], Optional[float]]:
    """num/den over all-label sums of two counters; None until den > 0."""
    def total(name):
        fam = obs_metrics.get_registry().get(name)
        if fam is None:
            return 0.0
        return sum(child.value for _, child in fam.children())

    def read():
        den = total(denominator)
        if den <= 0:
            return None
        return total(numerator) / den
    read.__name__ = f"{numerator}/{denominator}"
    return read


# --------------------------------------------------------------------- #
# declarations
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class BurnRule:
    """Fire when burn rate exceeds ``burn`` over BOTH windows."""
    fast_s: float
    slow_s: float
    burn: float

    def scaled(self, time_scale: float) -> "BurnRule":
        return BurnRule(self.fast_s * time_scale,
                        self.slow_s * time_scale, self.burn)


@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective: ``signal() <op> target`` should hold for at least
    ``objective`` of samples."""
    name: str
    signal: Callable[[], Optional[float]]
    target: float
    description: str = ""
    op: str = "<="                      # "<=" or ">="
    objective: float = 0.99
    rules: tuple = CANONICAL_RULES

    def compliant(self, value: Optional[float]) -> bool:
        if value is None:
            return True
        return value <= self.target if self.op == "<=" else \
            value >= self.target


class _SLOState:
    __slots__ = ("samples", "bad_total", "total", "last_value",
                 "active_rules", "alerts")

    def __init__(self, history: int):
        self.samples = deque(maxlen=history)   # (t, bad: 0/1)
        self.bad_total = 0
        self.total = 0
        self.last_value: Optional[float] = None
        self.active_rules: set = set()         # rising-edge dedupe
        self.alerts = 0


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
class SLOEngine:
    """Samples a catalog of SLOs against the live telemetry plane.

    ``tick()`` is cheap (a handful of registry reads) and thread-safe;
    call it from a serving loop or a background ticker. Burn-rate alerts
    are emitted once per rising edge as ``obs.log`` events named
    ``slo_burn_alert`` (countable through ``obs_events_total``) plus the
    ``psi_slo_burn_alerts_total{slo,window}`` counter.
    """

    def __init__(self, slos: Sequence[SLO], *,
                 time_scale: float = 1.0,
                 clock: Callable[[], float] = obs_trace.now,
                 history: int = 4096):
        self.slos = list(slos)
        self.clock = clock
        self.time_scale = float(time_scale)
        self._lock = threading.Lock()
        self._state = {s.name: _SLOState(history) for s in self.slos}
        self._rules = {
            s.name: tuple(BurnRule(*r).scaled(self.time_scale)
                          for r in s.rules)
            for s in self.slos}
        self._installed_prev = None

    # -- sampling ------------------------------------------------------- #
    def tick(self, now: Optional[float] = None) -> None:
        t = self.clock() if now is None else float(now)
        for slo in self.slos:
            try:
                value = slo.signal()
            except Exception as exc:   # a broken signal is not an outage
                obs_log.event("slo_signal_error", f"{slo.name}: {exc}",
                              level="error", slo=slo.name)
                continue
            bad = 0 if slo.compliant(value) else 1
            st = self._state[slo.name]
            with self._lock:
                st.samples.append((t, bad))
                st.total += 1
                st.bad_total += bad
                st.last_value = value
                self._evaluate_rules(slo, st, t)
            if bad:
                obs_metrics.counter(
                    "psi_slo_violations_total",
                    "samples out of SLO target", ("slo",)
                ).labels(slo=slo.name).inc()
            if value is not None:
                obs_metrics.gauge(
                    "psi_slo_signal", "last sampled SLO signal value",
                    ("slo",)).labels(slo=slo.name).set(value)
            obs_metrics.gauge(
                "psi_slo_budget_remaining",
                "fraction of the error budget left", ("slo",)
            ).labels(slo=slo.name).set(self._budget_remaining(slo, st))

    def _bad_frac(self, st: _SLOState, t: float, window_s: float):
        n = bad = 0
        for ts, b in reversed(st.samples):
            if t - ts > window_s:
                break
            n += 1
            bad += b
        return None if n == 0 else bad / n

    def _burn(self, slo: SLO, st: _SLOState, t: float, window_s: float):
        frac = self._bad_frac(st, t, window_s)
        if frac is None:
            return None
        budget = max(1.0 - slo.objective, 1e-9)
        return frac / budget

    def _budget_remaining(self, slo: SLO, st: _SLOState) -> float:
        if st.total == 0:
            return 1.0
        budget = max(1.0 - slo.objective, 1e-9)
        spent = (st.bad_total / st.total) / budget
        return max(0.0, 1.0 - spent)

    def _evaluate_rules(self, slo: SLO, st: _SLOState, t: float) -> None:
        for rule in self._rules[slo.name]:
            fast = self._burn(slo, st, t, rule.fast_s)
            slow = self._burn(slo, st, t, rule.slow_s)
            firing = (fast is not None and slow is not None
                      and fast > rule.burn and slow > rule.burn)
            key = (rule.fast_s, rule.slow_s)
            if firing and key not in st.active_rules:
                st.active_rules.add(key)
                st.alerts += 1
                window = f"{rule.fast_s:g}s/{rule.slow_s:g}s"
                obs_log.event(
                    "slo_burn_alert",
                    f"SLO {slo.name}: burn {fast:.1f}x over {window} "
                    f"(threshold {rule.burn:g}x, value {st.last_value})",
                    level="warning", slo=slo.name, window=window,
                    burn_fast=round(fast, 3), burn_slow=round(slow, 3),
                    value=st.last_value)
                obs_metrics.counter(
                    "psi_slo_burn_alerts_total",
                    "multi-window burn-rate alerts fired",
                    ("slo", "window")).labels(
                        slo=slo.name, window=window).inc()
            elif not firing and key in st.active_rules:
                if fast is not None and fast <= rule.burn:
                    st.active_rules.discard(key)   # re-arm after recovery

    # -- reporting ------------------------------------------------------ #
    def report(self) -> dict:
        """Verdict document (also served at ``/slo`` once installed)."""
        out = {"slos": [], "ok": True,
               "alerts_total": 0, "time_scale": self.time_scale}
        with self._lock:
            for slo in self.slos:
                st = self._state[slo.name]
                remaining = self._budget_remaining(slo, st)
                meeting = slo.compliant(st.last_value)
                verdict = dict(
                    name=slo.name, description=slo.description,
                    target=slo.target, op=slo.op,
                    objective=slo.objective,
                    value=st.last_value, meeting_target=meeting,
                    samples=st.total, bad_samples=st.bad_total,
                    budget_remaining=round(remaining, 6),
                    alerts=st.alerts, alert_active=bool(st.active_rules))
                out["slos"].append(verdict)
                out["alerts_total"] += st.alerts
                if not meeting or remaining <= 0.0:
                    out["ok"] = False
        return out

    def summary(self) -> list[str]:
        """Human epilogue lines for ``serve --slo``."""
        rep = self.report()
        lines = []
        for v in rep["slos"]:
            value = ("n/a" if v["value"] is None
                     else f"{v['value']:.4g}")
            state = "OK" if v["meeting_target"] else "VIOLATED"
            if v["alert_active"]:
                state += " (burn alert active)"
            lines.append(
                f"{v['name']}: {value} {v['op']} {v['target']:g} "
                f"[{state}] budget={v['budget_remaining']:.0%} "
                f"alerts={v['alerts']}")
        lines.append(
            f"overall: {'OK' if rep['ok'] else 'OUT OF SLO'} "
            f"({rep['alerts_total']} burn-rate alert(s) fired)")
        return lines

    # -- /slo endpoint wiring ------------------------------------------- #
    def install(self) -> None:
        """Publish this engine's verdicts at the HTTP ``/slo`` endpoint."""
        self._installed_prev = obs_metrics.set_slo_provider(self.report)

    def uninstall(self) -> None:
        obs_metrics.set_slo_provider(self._installed_prev)
        self._installed_prev = None


# --------------------------------------------------------------------- #
# the default catalog
# --------------------------------------------------------------------- #
def default_slos(*, query_p99_s: float = 0.05,
                 staleness_s: float = 30.0,
                 error_bound: float = 1e-5,
                 degraded_ratio: float = 0.05) -> list[SLO]:
    """The four serving objectives the paper's trade-offs map onto:
    latency (as fast as PageRank), freshness (streaming watermark lag),
    certified error (Eq. 19 bound), and answer quality (degraded ratio).
    """
    return [
        SLO("query_p99_latency",
            histogram_quantile("psi_query_seconds", 0.99),
            query_p99_s,
            description="p99 of every ranked read (scores/top_k/rank_of)"),
        SLO("freshness_staleness",
            gauge_value("psi_stream_watermark_lag_seconds"),
            staleness_s,
            description="event-time lag: newest ingested event vs "
                        "last resolve"),
        SLO("certified_psi_error",
            gauge_value("psi_certified_error_bound"),
            error_bound,
            description="Eq. 19 certified sup-norm error bound of the "
                        "last served answer"),
        SLO("degraded_answer_ratio",
            counter_ratio("psi_resilience_degraded_served_total",
                          "psi_resilience_resolves_total"),
            degraded_ratio,
            description="last-known-good answers / supervised resolves"),
    ]
