"""Noise-aware perf-regression gate over ``BENCH_power_psi.json``.

The benchmark trajectory is append-only history; this module turns it
into a *judgement*: is the newest run slower than the history says it
should be, beyond what machine noise explains?

Method:

* **Candidate** — the newest run (or ``--label``). **Baselines** — every
  other run whose environment fingerprint is *compatible* (fingerprint
  keys present in both runs must agree on ``device_platform``, ``x64``
  and ``device_count``; runs stamped before fingerprints existed have an
  empty environment and match anything) and whose ``quick`` flag matches
  (quick runs use smaller problem sizes).
* **Comparability** — entries pair up on the full workload identity
  ``(graph, backend, regime, n, m, dtype, tol)``; a scenario whose size
  changed between PRs silently gets fewer baselines, never a bogus one.
* **Robust threshold** — per (scenario, metric): ``median`` and ``MAD``
  over the baseline values, ``sigma = 1.4826 * MAD`` (the consistent
  normal estimate). A lower-is-better metric regresses when

      candidate > median + max(k * sigma, rel_floor * median, abs_floor)

  and symmetrically for higher-is-better. The relative floor is what
  makes the gate *noise-aware* with few baselines (MAD of one sample is
  0): timing metrics get a wide floor, deterministic counters (matvecs,
  work_frac) a tight one. Timing floors double for quick candidates
  (``--quick`` or a run stamped ``quick``) — small problems are
  dominated by constant overheads.
* **Self-proof** — ``--self-check`` re-runs the gate on an in-memory
  copy of the document with every candidate ``wall_s`` doubled and
  fails the process unless the gate catches the injected slowdown.

CLI (exit 0 = pass, 1 = regression, 2 = self-check failed to catch):

    python -m repro_torch.obs.regress [--json BENCH_power_psi.json]
        [--label PR9] [--out verdict.json] [--quick] [--self-check]
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
from typing import Optional

__all__ = ["gate", "load_doc", "inject_slowdown", "main",
           "GATED_METRICS"]

#: metric -> (direction, relative floor, MAD multiplier)
GATED_METRICS = {
    "wall_s": ("lower", 0.40, 4.0),        # timing: noisy across machines
    "matvecs": ("lower", 0.05, 4.0),       # deterministic work counter
    "events_per_s": ("higher", 0.35, 4.0),  # ingest throughput (timing)
    "tenants_per_s": ("higher", 0.35, 4.0),
    "work_frac": ("lower", 0.10, 4.0),     # push locality (deterministic)
}

#: fingerprint keys that must agree when present in both runs
ENV_MATCH_KEYS = ("device_platform", "x64", "device_count")

ABS_FLOORS = {"wall_s": 0.005, "events_per_s": 0.0, "tenants_per_s": 0.0,
              "matvecs": 2.0, "work_frac": 0.01}


def load_doc(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _env_compatible(a: dict, b: dict) -> bool:
    a, b = a or {}, b or {}
    return all(a[k] == b[k] for k in ENV_MATCH_KEYS if k in a and k in b)


def _entry_key(entry: dict) -> tuple:
    return (entry.get("graph"), entry.get("backend"),
            str(entry.get("regime")), entry.get("n"), entry.get("m"),
            entry.get("dtype"), entry.get("tol"))


def _scenario(entry: dict) -> str:
    s = f"{entry.get('graph')}/{entry.get('backend')}"
    regime = entry.get("regime")
    if regime not in (None, "null"):
        s += f"[{regime}]"
    return s


def _pick_candidate(doc: dict, label: Optional[str]) -> dict:
    runs = doc.get("runs", [])
    if not runs:
        raise SystemExit("no runs in benchmark document")
    if label is None:
        return runs[-1]
    for run in runs:
        if run.get("label") == label:
            return run
    raise SystemExit(f"no run labelled {label!r} "
                     f"(have: {[r.get('label') for r in runs]})")


def gate(doc: dict, *, label: Optional[str] = None,
         quick: bool = False, min_baselines: int = 1) -> dict:
    """Evaluate the candidate run against fingerprint-matched history.

    Returns a verdict document: per-(scenario, metric) rows with
    ``status`` in ``ok`` / ``regression`` / ``improved`` / ``skipped``
    plus an overall ``ok`` flag and the named regressions.
    """
    candidate = _pick_candidate(doc, label)
    # quick runs use small problems whose timings are dominated by
    # constant overheads — widen the timing floors for them regardless
    # of how the gate itself was invoked
    quick = quick or bool(candidate.get("quick"))
    cand_env = candidate.get("environment") or {}
    baselines = [
        r for r in doc.get("runs", [])
        if r is not candidate
        and bool(r.get("quick")) == bool(candidate.get("quick"))
        and _env_compatible(cand_env, r.get("environment") or {})]

    # baseline values per (workload identity, metric)
    history: dict = {}
    for run in baselines:
        for entry in run.get("entries", []):
            for metric in GATED_METRICS:
                if metric in entry and entry[metric] is not None:
                    history.setdefault(
                        (_entry_key(entry), metric), []).append(
                            float(entry[metric]))

    rows, regressions = [], []
    for entry in candidate.get("entries", []):
        key = _entry_key(entry)
        scenario = _scenario(entry)
        for metric, (direction, rel_floor, mad_k) in GATED_METRICS.items():
            if metric not in entry or entry[metric] is None:
                continue
            value = float(entry[metric])
            base = history.get((key, metric), [])
            row = dict(scenario=scenario, metric=metric, value=value,
                       baselines=len(base), direction=direction)
            if len(base) < min_baselines:
                row["status"] = "skipped"
                rows.append(row)
                continue
            med = statistics.median(base)
            mad = statistics.median(abs(b - med) for b in base)
            sigma = 1.4826 * mad
            floor = rel_floor * (2.0 if quick and metric in
                                 ("wall_s", "events_per_s",
                                  "tenants_per_s") else 1.0)
            slack = max(mad_k * sigma, floor * abs(med),
                        ABS_FLOORS.get(metric, 0.0))
            if direction == "lower":
                limit = med + slack
                regressed, improved = value > limit, value < med - slack
            else:
                limit = med - slack
                regressed, improved = value < limit, value > med + slack
            row.update(median=med, sigma=sigma, limit=limit,
                       ratio=(value / med if med else None),
                       status=("regression" if regressed
                               else "improved" if improved else "ok"))
            rows.append(row)
            if regressed:
                regressions.append(
                    f"{scenario} {metric}: {value:.6g} vs limit "
                    f"{limit:.6g} (median {med:.6g}, "
                    f"x{value / med:.2f})" if med else
                    f"{scenario} {metric}: {value:.6g} vs {limit:.6g}")
    return dict(
        candidate=candidate.get("label"),
        baselines=[r.get("label") for r in baselines],
        quick=quick, rows=rows, regressions=regressions,
        ok=not regressions,
        counts={s: sum(1 for r in rows if r["status"] == s)
                for s in ("ok", "regression", "improved", "skipped")})


def inject_slowdown(doc: dict, *, label: Optional[str] = None,
                    metric: str = "wall_s", factor: float = 2.0) -> dict:
    """A deep copy of ``doc`` with the candidate's ``metric`` scaled by
    ``factor`` — the synthetic regression the gate must catch."""
    out = copy.deepcopy(doc)
    candidate = _pick_candidate(out, label)
    for entry in candidate.get("entries", []):
        if metric in entry and entry[metric] is not None:
            entry[metric] = float(entry[metric]) * factor
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="noise-aware perf-regression gate over the "
                    "benchmark trajectory")
    ap.add_argument("--json", default="BENCH_power_psi.json",
                    help="benchmark trajectory document")
    ap.add_argument("--label", default=None,
                    help="candidate run label (default: newest run)")
    ap.add_argument("--out", default=None,
                    help="write the verdict JSON here")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke: widen the timing floors 2x")
    ap.add_argument("--min-baselines", type=int, default=1)
    ap.add_argument("--self-check", action="store_true",
                    help="also prove the gate catches a synthetic 2x "
                         "wall_s slowdown (exit 2 if it does not)")
    args = ap.parse_args(argv)

    doc = load_doc(args.json)
    verdict = gate(doc, label=args.label, quick=args.quick,
                   min_baselines=args.min_baselines)
    c = verdict["counts"]
    print(f"[regress] candidate={verdict['candidate']} "
          f"baselines={verdict['baselines']}")
    print(f"[regress] {c['ok']} ok, {c['improved']} improved, "
          f"{c['skipped']} skipped, {c['regression']} regression(s)")
    for line in verdict["regressions"]:
        print(f"[regress] REGRESSION: {line}")

    if args.self_check:
        injected = gate(inject_slowdown(doc, label=args.label),
                        label=args.label, quick=args.quick,
                        min_baselines=args.min_baselines)
        caught = [r for r in injected["rows"]
                  if r["metric"] == "wall_s"
                  and r["status"] == "regression"]
        verdict["self_check"] = dict(
            injected="wall_s x2.0", caught=len(caught),
            example=(injected["regressions"][0]
                     if injected["regressions"] else None))
        if caught:
            print(f"[regress] self-check: injected 2x wall_s slowdown "
                  f"caught in {len(caught)} scenario(s), e.g. "
                  f"{injected['regressions'][0]}")
        else:
            print("[regress] SELF-CHECK FAILED: injected slowdown "
                  "was not caught", file=sys.stderr)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1)
        print(f"[regress] verdict -> {args.out}")

    if args.self_check and not verdict["self_check"]["caught"]:
        return 2
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
