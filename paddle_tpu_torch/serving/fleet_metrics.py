"""Fleet telemetry plane (port of ``paddle_tpu/serving/fleet_metrics.py``):
the supervisor-side metrics tier. Pure Python over the numbers the
replicas already export; the port keeps its own copy.

- **Collector** (`FleetMetrics`): a healthy probe of the supervisor's
  monitor loop also scrapes the replica's structured metrics export
  (``{"op": "export"}``: exact counters, bucket-exact histogram counts,
  SLO window counts). Exports merge bucket-exactly (serving/metrics.py
  ``merge_exports``): fleet ``_count`` / ``_sum`` / ``_bucket`` equal
  the sum of the replicas' exports and fleet quantiles are interpolated
  from the merged buckets. A replica that dies mid-scrape keeps its
  last export, marked stale, and stale exports are dropped from the
  rollup.

- **Live SLO monitor**: per-class rolling-window attainment merged
  across replicas by summing window counts, queue-depth / prefill-debt
  pressure signals and a hysteretic ``scale_up`` / ``steady`` /
  ``scale_down`` verdict (`PressureMonitor`).

- **Outlier detection**: per-replica step ms / TPOT / error rate over
  the latest scrape window (deltas between consecutive exports)
  against the fleet median by MAD-based robust z-scores.

- **Crash flight recorder** (`FlightRecorder`): on engine
  resurrection, a terminal EngineFailed or a stalled-request eviction
  the server writes a black-box bundle (timeline ring, finished traces,
  metrics export, in-flight dump, engine recipe) with an atomic
  tmp + rename and a byte-budgeted retention ring.
  ``tools/flight_inspect.py`` lints and prints bundles.

Greedy outputs are the same with the plane on or off; the scrape costs
one RPC per replica per probe cycle.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .metrics import (attainment_from_export, export_snapshot,
                      merge_exports)

__all__ = ["FleetMetrics", "ReplicaTelemetry", "PressureMonitor",
           "FlightRecorder", "merge_slo_exports", "robust_zscores",
           "prometheus_export_lines", "prometheus_multi_export_lines"]


# ---------------------------------------------------------------------------
# merge helpers
# ---------------------------------------------------------------------------


def merge_slo_exports(exports: List[Dict]) -> Dict:
    """Fold N ``SLOAttainment.export()`` dicts into one: per-class
    window counts sum (counts are counts — the fleet attainment over
    the union window is exact). Targets are taken from the first
    export that has them; replicas are expected to share targets (the
    supervisor forwards one CLI), and a disagreeing replica's counts
    still merge — attainment is evaluated replica-side against ITS
    targets, which is the honest reading of a mid-rollout fleet."""
    merged: Dict[str, Any] = {"ttft_ms": None, "tpot_ms": None,
                              "window_s": None, "classes": {}}
    for e in exports:
        if not e:
            continue
        for k in ("ttft_ms", "tpot_ms", "window_s"):
            if merged[k] is None and e.get(k) is not None:
                merged[k] = e[k]
        for cls, c in (e.get("classes") or {}).items():
            m = merged["classes"].setdefault(
                cls, {"total": 0, "ttft_met": 0, "tpot_met": 0,
                      "met": 0})
            for f in m:
                m[f] += int(c.get(f, 0))
    return merged


def _merge_fresh_exports(fresh: List["ReplicaTelemetry"]) -> Dict:
    """One merged fleet view over the FRESH replicas: summed
    counters, summed numeric gauges, bucket-exact histogram merges
    (a ladder mismatch becomes an ``{"error": ...}`` entry), and the
    summed SLO window. The single merge path both ``fleet_snapshot``
    and the Prometheus exposition read — they can't drift apart."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict] = {}
    for rt in fresh:
        for k, v in (rt.export.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        for k, v in (rt.export.get("gauges") or {}).items():
            if isinstance(v, (int, float)):
                gauges[k] = gauges.get(k, 0.0) + float(v)
    for name in sorted({h for rt in fresh
                        for h in (rt.export.get("histograms")
                                  or {})}):
        try:
            hists[name] = merge_exports(
                [(rt.export.get("histograms") or {}).get(name)
                 for rt in fresh])
        except ValueError as e:
            hists[name] = {"error": str(e)}
    slo = merge_slo_exports([(rt.export.get("slo") or {})
                             for rt in fresh])
    return {"counters": counters, "gauges": gauges,
            "histograms": hists, "slo": slo}


def robust_zscores(values: Dict[int, float]) -> Dict[int, float]:
    """MAD-based robust z-score per replica: (x - median) / (1.4826 *
    MAD). With MAD == 0 (identical replicas — the common healthy
    case) every score is 0 unless a value differs from the median at
    all, in which case it falls back to a median-relative ratio so a
    single wildly-slow replica among identical peers is still caught.
    Fewer than 3 values -> all zeros (no meaningful median)."""
    if len(values) < 3:
        return {k: 0.0 for k in values}
    xs = sorted(values.values())
    n = len(xs)
    med = (xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2]))
    devs = sorted(abs(v - med) for v in values.values())
    mad = (devs[n // 2] if n % 2
           else 0.5 * (devs[n // 2 - 1] + devs[n // 2]))
    out = {}
    for k, v in values.items():
        if mad > 1e-12:
            out[k] = (v - med) / (1.4826 * mad)
        elif abs(v - med) <= 1e-12:
            out[k] = 0.0
        else:
            # degenerate spread: every other replica identical. Scale
            # by the median so "2x the fleet" reads as a big score.
            scale = max(abs(med), 1e-9)
            out[k] = (v - med) / scale * 10.0
    return out


# ---------------------------------------------------------------------------
# pressure verdict (the 3(a) autoscaler input contract, telemetry-only)
# ---------------------------------------------------------------------------


class PressureMonitor:
    """Hysteretic scale hint from fleet load + SLO attainment.

    Raw verdict per evaluation:

    - ``scale_up``   — SLO attainment (when targets are configured)
      below ``attain_low``, OR mean queued requests per live replica
      above ``queue_high``, OR prefill debt per replica above
      ``debt_high`` tokens, OR fleet page-pool utilization above
      ``mem_high`` (the r18 memory input: a fleet meeting every
      latency SLO still needs replicas BEFORE its KV pool exhausts —
      the missing half of the 3(a) actuator contract);
    - ``scale_down`` — attainment at/above ``attain_high`` (or no
      targets), near-empty queues (< ``queue_low``), slot occupancy
      below ``occupancy_low``, AND memory comfortably below
      ``mem_high``;
    - ``steady``     — anything else.

    The PUBLISHED verdict only flips after ``hysteresis`` consecutive
    identical raw verdicts — a single bursty scrape must not flap the
    hint an autoscaler acts on. This is the signal plane of ROADMAP
    3(a); the actuator (actually changing replica count) is a later
    PR."""

    def __init__(self, attain_low: float = 0.9,
                 attain_high: float = 0.98,
                 queue_high: float = 4.0, queue_low: float = 0.5,
                 debt_high: float = 4096.0,
                 occupancy_low: float = 0.25, hysteresis: int = 3,
                 mem_high: float = 0.92):
        self.attain_low = float(attain_low)
        self.attain_high = float(attain_high)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.debt_high = float(debt_high)
        self.occupancy_low = float(occupancy_low)
        self.hysteresis = max(1, int(hysteresis))
        self.mem_high = float(mem_high)
        self.verdict = "steady"
        self._raw = "steady"
        self._streak = 0

    def _raw_verdict(self, attainment: Optional[float],
                     queued_per_replica: float,
                     debt_per_replica: float,
                     occupancy: Optional[float],
                     mem_utilization: Optional[float] = None) -> str:
        missed = attainment is not None and attainment < self.attain_low
        mem_pressed = (mem_utilization is not None
                       and mem_utilization > self.mem_high)
        if (missed or mem_pressed
                or queued_per_replica > self.queue_high
                or debt_per_replica > self.debt_high):
            return "scale_up"
        attained = attainment is None or attainment >= self.attain_high
        idle = (queued_per_replica < self.queue_low
                and (occupancy is None
                     or occupancy < self.occupancy_low)
                and (mem_utilization is None
                     or mem_utilization <= self.mem_high))
        if attained and idle:
            return "scale_down"
        return "steady"

    def evaluate(self, attainment: Optional[float],
                 queued_per_replica: float,
                 debt_per_replica: float,
                 occupancy: Optional[float],
                 mem_utilization: Optional[float] = None
                 ) -> Dict[str, Any]:
        raw = self._raw_verdict(attainment, queued_per_replica,
                                debt_per_replica, occupancy,
                                mem_utilization)
        if raw == self._raw:
            self._streak += 1
        else:
            self._raw, self._streak = raw, 1
        if raw == self.verdict:
            # streak toward the current verdict just re-confirms it
            self._streak = min(self._streak, self.hysteresis)
        elif self._streak >= self.hysteresis:
            self.verdict = raw
        return {"verdict": self.verdict, "raw": raw,
                "streak": self._streak,
                "hysteresis": self.hysteresis,
                "inputs": {"attainment": attainment,
                           "queued_per_replica":
                               round(queued_per_replica, 3),
                           "debt_per_replica":
                               round(debt_per_replica, 1),
                           "occupancy": (None if occupancy is None
                                         else round(occupancy, 3)),
                           "mem_utilization": (
                               None if mem_utilization is None
                               else round(mem_utilization, 4))}}


# ---------------------------------------------------------------------------
# the collector / merger
# ---------------------------------------------------------------------------


class ReplicaTelemetry:
    """Latest (and previous) scraped export of one replica, plus the
    derived recent-window rates the outlier detector reads."""

    __slots__ = ("idx", "export", "prev", "t", "prev_t", "stale")

    def __init__(self, idx: int):
        self.idx = idx
        self.export: Optional[Dict] = None
        self.prev: Optional[Dict] = None
        self.t: float = 0.0
        self.prev_t: float = 0.0
        self.stale = True

    def ingest(self, export: Dict, now: float) -> None:
        self.prev, self.prev_t = self.export, self.t
        self.export, self.t = export, now
        self.stale = False

    def _hist_delta(self, name: str) -> Optional[float]:
        """Mean of ``name`` over the most recent scrape interval
        (sum/total deltas between consecutive exports); falls back to
        the lifetime mean ONLY on the first scrape. A quiescent
        interval (no new observations) returns None — an idle replica
        must not keep presenting its stale lifetime numbers to the
        outlier detector (a replica slow an hour ago but idle now is
        not a current outlier)."""
        if self.export is None:
            return None
        cur = (self.export.get("histograms") or {}).get(name)
        if not cur:
            return None
        prev = ((self.prev.get("histograms") or {}).get(name)
                if self.prev else None)
        if prev is None:
            return cur["sum"] / cur["total"] if cur["total"] else None
        if cur["total"] > prev["total"]:
            return ((cur["sum"] - prev["sum"])
                    / (cur["total"] - prev["total"]))
        return None

    def _counter_rate(self, name: str, per: str = "s"
                      ) -> Optional[float]:
        """Delta of counter ``name`` per second (or per engine step
        with ``per="step"``) over the most recent scrape interval."""
        if self.export is None or self.prev is None:
            return None
        c1 = (self.export.get("counters") or {}).get(name)
        c0 = (self.prev.get("counters") or {}).get(name)
        if c1 is None or c0 is None:
            return None
        if per == "step":
            s1 = (self.export.get("gauges") or {}).get("engine_steps")
            s0 = (self.prev.get("gauges") or {}).get("engine_steps")
            if not s1 or s0 is None or s1 <= s0:
                return None
            return (c1 - c0) / (s1 - s0)
        dt = self.t - self.prev_t
        return (c1 - c0) / dt if dt > 0 else None

    def signals(self) -> Dict[str, Optional[float]]:
        """The outlier detector's per-replica inputs."""
        return {"step_ms": self._hist_delta("step_ms"),
                "tpot_ms": self._hist_delta("tpot_ms"),
                "error_rate":
                    self._counter_rate("engine_errors_total",
                                       per="step")}


class FleetMetrics:
    """Aggregates replica exports into the fleet surface.

    ``ingest(idx, export)`` is called by the supervisor's monitor
    loop after each healthy probe+scrape; ``mark_stale(idx)`` when a
    replica dies or a scrape fails (its last export is KEPT for
    postmortems but excluded from fleet rollups). All read surfaces
    (``fleet_snapshot``, ``prometheus_text``) may run on router
    connection threads, hence the lock."""

    def __init__(self, outlier_z: float = 3.5,
                 stale_after_s: float = 10.0,
                 pressure: Optional[PressureMonitor] = None,
                 pressure_interval_s: float = 1.0):
        self.outlier_z = float(outlier_z)
        self.stale_after_s = float(stale_after_s)
        self.pressure = pressure or PressureMonitor()
        # minimum wall time between pressure-hysteresis advances: a
        # scrape cycle ingests N replicas back-to-back (N generation
        # bumps), and router picks may read between them — without
        # this gate one bursty cycle could step the streak N times
        # and flip the verdict in a single cycle. One advance per
        # interval means hysteresis=K needs >= K*interval seconds of
        # SUSTAINED signal, which is the contract.
        self.pressure_interval_s = float(pressure_interval_s)
        self._replicas: Dict[int, ReplicaTelemetry] = {}
        self._lock = threading.Lock()
        self.scrapes_total = 0
        self.scrape_failures_total = 0
        self.outlier_flags_total = 0
        self._flagged: Dict[int, Dict] = {}
        # evaluation is GENERATION-GATED: _gen bumps on every ingest/
        # stale transition, and outlier flags + the pressure verdict
        # only advance when the generation changed since the last
        # evaluation. Read-side polls (fleet_stats, exposition
        # scrapes, router picks) therefore can't flap the hysteretic
        # verdict by polling fast, and the flags stay current even
        # with no reader of its own: the first reader after
        # a scrape cycle pays the (small) evaluation.
        self._gen = 0
        self._eval_gen = -1
        self._eval_t = 0.0
        self._pressure_t: Optional[float] = None
        self._eval_fresh_ids: tuple = ()
        self._last_eval: Optional[Dict] = None
        # verdict→action latch (r21): the autoscaler consumes each
        # pressure evaluation at most once — this remembers the
        # _pressure_t it last handed out
        self._consumed_pressure_t: Optional[float] = None

    # -- ingestion (monitor loop) ------------------------------------------

    def ingest(self, idx: int, export: Dict) -> None:
        now = time.monotonic()
        with self._lock:
            rt = self._replicas.setdefault(idx, ReplicaTelemetry(idx))
            rt.ingest(export, now)
            self.scrapes_total += 1
            self._gen += 1

    def mark_stale(self, idx: int) -> None:
        """A replica died / failed its scrape: keep its last export
        for postmortems but drop it from fleet rollups until it
        reports again (no poisoned fleet totals)."""
        with self._lock:
            rt = self._replicas.setdefault(idx, ReplicaTelemetry(idx))
            if not rt.stale:
                rt.stale = True
                self.scrape_failures_total += 1
                self._gen += 1

    def _fresh(self, now: float) -> List[ReplicaTelemetry]:
        return [rt for rt in self._replicas.values()
                if not rt.stale and rt.export is not None
                and now - rt.t <= self.stale_after_s]

    # -- evaluation (generation-gated; lock held) --------------------------

    def _evaluate_locked(self, now: float) -> Dict:
        """Recompute the merged fleet view, outlier flags, and the
        pressure verdict. Must be called with the lock held; the
        returned dict is replaced wholesale, never mutated, so
        callers may read it after releasing the lock.

        Two-level gating: the MERGE/flag recompute is cached for up
        to 1 s when no new telemetry arrived (poll storms stay
        cheap), but never longer — freshness depends on wall time, so
        replicas aging past ``stale_after_s`` must fall out of the
        rollup even when nothing bumps the generation (e.g. a wedged
        monitor thread). The PRESSURE verdict advances only on NEW
        INFORMATION — a generation bump or a change in the fresh
        set — and at most once per ``pressure_interval_s``, so
        neither read-side polls nor the N per-replica ingests of one
        scrape cycle can flap the hysteresis."""
        gen_changed = self._eval_gen != self._gen
        if (not gen_changed and self._last_eval is not None
                and now - self._eval_t < 1.0):
            return self._last_eval
        fresh = self._fresh(now)
        fresh_ids = tuple(sorted(rt.idx for rt in fresh))
        merged = _merge_fresh_exports(fresh)
        flagged = self._detect_outliers(fresh)
        for idx in flagged:
            if idx not in self._flagged:
                self.outlier_flags_total += 1
        self._flagged = flagged
        att = attainment_from_export(merged["slo"])
        new_info = (gen_changed or self._last_eval is None
                    or fresh_ids != self._eval_fresh_ids)
        if not fresh:
            # a telemetry BLACKOUT is not an idle fleet: with zero
            # fresh replicas there is no evidence for any scaling
            # move — hold the last published verdict, mark the raw
            # input as no_data, and leave the hysteresis state
            # untouched
            pressure = {"verdict": self.pressure.verdict,
                        "raw": "no_data", "streak": 0,
                        "hysteresis": self.pressure.hysteresis,
                        "inputs": None}
        elif new_info and (
                self._pressure_t is None
                or now - self._pressure_t >= self.pressure_interval_s):
            gauges = merged["gauges"]
            n_fresh = len(fresh)
            slots = gauges.get("num_slots", 0.0)
            inflight = gauges.get("inflight_slots", 0.0)
            # memory input (r18): fleet page-pool utilization from the
            # scraped occupancy gauges (a ratio of sums across fresh
            # replicas; per-replica detail lives in fleet_capacity).
            # UNRECLAIMABLE pages when the replica exports them (raw
            # used minus refcount-0 cache pages — a warm inclusive
            # cache fills the pool by design and must not read as
            # exhaustion); pages_used is the pre-refinement fallback.
            pool = gauges.get("num_pages", 0.0)
            used = gauges.get("pages_unreclaimable")
            if used is None:
                used = gauges.get("pages_used")
            mem_util = ((used / pool)
                        if pool and used is not None else None)
            slo = merged["slo"]
            pressure = self.pressure.evaluate(
                att.get("all")
                if (slo.get("ttft_ms") is not None
                    or slo.get("tpot_ms") is not None) else None,
                gauges.get("queued_requests", 0.0) / n_fresh,
                gauges.get("prefill_debt_tokens", 0.0) / n_fresh,
                (inflight / slots) if slots else None,
                mem_utilization=mem_util)
            self._pressure_t = now
        elif self._last_eval is not None:
            pressure = self._last_eval["pressure"]
        else:
            pressure = {"verdict": self.pressure.verdict,
                        "raw": "no_data", "streak": 0,
                        "hysteresis": self.pressure.hysteresis,
                        "inputs": None}
        self._last_eval = {"fresh": fresh, "merged": merged,
                           "flagged": flagged, "attainment": att,
                           "pressure": pressure}
        self._eval_gen = self._gen
        self._eval_t = now
        self._eval_fresh_ids = fresh_ids
        return self._last_eval

    # -- outlier detection -------------------------------------------------

    def _detect_outliers(self, fresh: List[ReplicaTelemetry]
                         ) -> Dict[int, Dict]:
        """Robust z-score per signal over the fresh replicas; a
        replica flags when any signal's score exceeds ``outlier_z``
        in the SLOW/ERRORful direction (fast replicas are not
        outliers worth avoiding)."""
        flagged: Dict[int, Dict] = {}
        for sig in ("step_ms", "tpot_ms", "error_rate"):
            vals = {rt.idx: v for rt in fresh
                    for v in [rt.signals()[sig]] if v is not None}
            for idx, z in robust_zscores(vals).items():
                if z > self.outlier_z:
                    flagged.setdefault(idx, {})[sig] = {
                        "z": round(z, 2), "value": round(vals[idx], 4)}
        return flagged

    def outliers(self) -> Dict[int, Dict]:
        """Currently-flagged replicas — evaluated lazily against the
        latest scrape generation, so the router's deprioritization
        path stays current even when nothing polls fleet_stats."""
        with self._lock:
            return dict(self._evaluate_locked(
                time.monotonic())["flagged"])

    def consume_pressure(self) -> Optional[Dict]:
        """Verdict→action latch (r21): the pressure dict when a NEW
        pressure evaluation ran since the last consume, else None.
        The autoscaler drives actions through this, so each fresh
        evaluation can trigger at most ONE action — replayed reads
        (poll storms, a fast actuator tick) and telemetry blackouts
        (verdict held, nothing evaluated) return None and cause
        nothing. ``fleet_snapshot``/``outliers`` reads never consume:
        observation stays side-effect-free."""
        with self._lock:
            ev = self._evaluate_locked(time.monotonic())
            if self._pressure_t is None or \
                    self._pressure_t == self._consumed_pressure_t:
                return None
            self._consumed_pressure_t = self._pressure_t
            return dict(ev["pressure"])

    # -- fleet surfaces ----------------------------------------------------

    def fleet_snapshot(self) -> Dict:
        """The telemetry half of the ``fleet_stats`` payload: merged
        counters/histograms/SLO, pressure verdict, outlier flags, and
        per-replica telemetry state (staleness, signals, counters).
        The supervision half — probe-failure taxonomy, restarts,
        backoff gates — is joined in by ``Supervisor.fleet_stats``,
        which owns that state."""
        now = time.monotonic()
        with self._lock:
            ev = self._evaluate_locked(now)
            all_rt = dict(self._replicas)
            scrapes = self.scrapes_total
            scrape_failures = self.scrape_failures_total
            flags_total = self.outlier_flags_total
        fresh = ev["fresh"]
        flagged = ev["flagged"]
        counters = ev["merged"]["counters"]
        gauges = ev["merged"]["gauges"]
        hists = ev["merged"]["histograms"]
        slo = ev["merged"]["slo"]
        att = ev["attainment"]
        pressure = ev["pressure"]

        per_replica = {}
        for idx, rt in sorted(all_rt.items()):
            sig = rt.signals()
            # string keys: this dict crosses a JSON socket (the
            # router's fleet_stats op) where int keys would silently
            # become strings anyway — one spelling everywhere
            per_replica[str(idx)] = {
                "stale": rt.stale or now - rt.t > self.stale_after_s,
                "age_s": (round(now - rt.t, 3) if rt.export is not None
                          else None),
                "signals": {k: (None if v is None else round(v, 4))
                            for k, v in sig.items()},
                "outlier": flagged.get(idx),
                "counters": dict(rt.export.get("counters") or {})
                if rt.export else {},
            }
        return {"replicas_fresh": len(fresh),
                "replicas_known": len(all_rt),
                "counters": counters,
                "gauges": {k: round(v, 4) for k, v in gauges.items()},
                "histograms": {k: (export_snapshot(v)
                                   if "error" not in v else v)
                               for k, v in hists.items()},
                "histogram_exports": hists,
                "slo": {"targets": {"ttft_ms": slo.get("ttft_ms"),
                                    "tpot_ms": slo.get("tpot_ms")},
                        "window_s": slo.get("window_s"),
                        "classes": slo.get("classes"),
                        "attainment": att},
                "pressure": pressure,
                "outliers": {str(k): v for k, v in flagged.items()},
                "collector": {"scrapes_total": scrapes,
                              "scrape_failures_total": scrape_failures,
                              "outlier_flags_total": flags_total},
                "per_replica": per_replica}

    def prometheus_text(self, prefix: str = "serving") -> str:
        """Fleet text exposition: per-replica series keep their
        replica-local family names with a ``replica`` label; fleet
        rollups live under DISTINCT ``fleet_``-prefixed families (an
        unlabeled rollup inside a labeled family would collide — the
        registry-audit lesson, fleet edition)."""
        now = time.monotonic()
        with self._lock:
            ev = self._evaluate_locked(now)
        fresh = ev["fresh"]
        lines: List[str] = []
        # per-replica series, replica-labeled, FAMILY-GROUPED (one
        # TYPE line per family, samples contiguous across replicas —
        # the text-format contract strict scrapers enforce)
        lines.extend(prometheus_multi_export_lines(
            [({"replica": str(rt.idx)}, rt.export)
             for rt in sorted(fresh, key=lambda r: r.idx)],
            prefix=prefix))
        # fleet rollups, unlabeled, own families — the SAME merged
        # view fleet_snapshot serves (one merge path, no drift);
        # mismatched-ladder histograms carry an "error" entry and are
        # skipped here (they still surface in fleet_stats JSON)
        if fresh:
            merged = ev["merged"]
            lines.extend(prometheus_export_lines(
                {"counters": merged["counters"],
                 "gauges": merged["gauges"],
                 "histograms": {k: v for k, v in
                                merged["histograms"].items()
                                if "error" not in v}},
                prefix="fleet", labels=None))
            att = ev["attainment"]
            slo = merged["slo"]
            if slo.get("ttft_ms") is not None \
                    or slo.get("tpot_ms") is not None:
                lines.append("# TYPE fleet_slo_attainment gauge")
                for cls in sorted(att):
                    if att[cls] is not None:
                        lines.append(
                            f'fleet_slo_attainment{{class="{cls}"}} '
                            f"{att[cls]:g}")
        lines.append("# TYPE fleet_replicas_fresh gauge")
        lines.append(f"fleet_replicas_fresh {len(fresh)}")
        return "\n".join(lines) + "\n"


def _label_str(labels: Optional[Dict[str, str]]) -> str:
    """Validated ``k="v"[,...]`` label body (empty string = no
    labels). Label values must be bare — no quotes, backslashes or
    newlines; malformed ones raise rather than emit an unparseable
    page."""
    if not labels:
        return ""
    for k, v in labels.items():
        if any(c in str(v) for c in '"\\\n'):
            raise ValueError(f"malformed label value {v!r}")
    return ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))


def prometheus_multi_export_lines(
        pairs: List, prefix: str = "serving") -> List[str]:
    """Exposition lines for N labeled exports, FAMILY-GROUPED: each
    family declares its ``# TYPE`` exactly once and all its samples
    (one per labeled export) are contiguous — the text-format
    contract strict scrapers enforce ("all lines for a given metric
    must be provided as one single group"). ``pairs`` is a list of
    ``(labels_or_None, export_dict)``."""
    pairs = [( _label_str(labels), e) for labels, e in pairs if e]
    out: List[str] = []
    hist_names = sorted({h for _lab, e in pairs
                         for h in (e.get("histograms") or {})})
    for hname in hist_names:
        name = f"{prefix}_{hname}".replace(".", "_")
        lines: List[str] = []
        for lab, e in pairs:
            h = (e.get("histograms") or {}).get(hname)
            if not h or "counts" not in h:
                continue
            acc = 0
            sep = "," if lab else ""
            for le, c in zip(h["buckets"], h["counts"]):
                acc += c
                lines.append(
                    f'{name}_bucket{{{lab}{sep}le="{le:g}"}} {acc}')
            acc += h["counts"][-1]
            lines.append(f'{name}_bucket{{{lab}{sep}le="+Inf"}} {acc}')
            brace = f"{{{lab}}}" if lab else ""
            lines.append(f'{name}_sum{brace} {h["sum"]:g}')
            lines.append(f'{name}_count{brace} {h["total"]}')
        if lines:
            out.append(f"# TYPE {name} histogram")
            out.extend(lines)
    gauge_names = sorted({g for _lab, e in pairs
                          for g, v in (e.get("gauges") or {}).items()
                          if isinstance(v, (int, float))})
    for gname in gauge_names:
        name = f"{prefix}_{gname}".replace(".", "_")
        lines = []
        for lab, e in pairs:
            v = (e.get("gauges") or {}).get(gname)
            if not isinstance(v, (int, float)):
                continue
            brace = f"{{{lab}}}" if lab else ""
            lines.append(f"{name}{brace} {v:g}")
        if lines:
            out.append(f"# TYPE {name} gauge")
            out.extend(lines)
    counter_names = sorted({c for _lab, e in pairs
                            for c in (e.get("counters") or {})})
    for cname in counter_names:
        name = f"{prefix}_{cname}".replace(".", "_")
        lines = []
        for lab, e in pairs:
            v = (e.get("counters") or {}).get(cname)
            if v is None:
                continue
            brace = f"{{{lab}}}" if lab else ""
            lines.append(f"{name}{brace} {v}")
        if lines:
            out.append(f"# TYPE {name} counter")
            out.extend(lines)
    return out


def prometheus_export_lines(export: Dict, prefix: str = "serving",
                            labels: Optional[Dict[str, str]] = None
                            ) -> List[str]:
    """Exposition lines for one ``ServingMetrics.export()``-shaped
    dict (see ``prometheus_multi_export_lines`` for the N-replica,
    family-grouped form)."""
    return prometheus_multi_export_lines([(labels, export)],
                                         prefix=prefix)


# ---------------------------------------------------------------------------
# crash flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Black-box bundle writer with a byte-budgeted retention ring.

    ``record(reason, collect)`` assembles a bundle from the
    ``collect()`` callback (the server passes a closure over its
    engine/tracer/metrics), writes it ATOMICALLY (tmp + rename — a
    crash mid-write never leaves a torn bundle for the inspector),
    then prunes OLDEST-FIRST until the directory is back under
    ``budget_bytes`` (the newest bundle always survives, even if it
    alone exceeds the budget: the most recent crash is the one the
    postmortem needs). Bundle writes must never take the serving path
    down — failures are counted, not raised. ``min_interval_s``
    rate-limits per-reason recording so a stall storm can't turn the
    engine thread into a JSON serializer."""

    def __init__(self, flight_dir: str,
                 budget_bytes: int = 64 << 20,
                 min_interval_s: float = 1.0):
        self.flight_dir = flight_dir
        self.budget_bytes = int(budget_bytes)
        self.min_interval_s = float(min_interval_s)
        os.makedirs(flight_dir, exist_ok=True)
        self.recorded_total = 0
        self.record_failures_total = 0
        self.pruned_total = 0
        self._seq = 0
        self._last_t: Dict[str, float] = {}
        self._lock = threading.Lock()

    def record(self, reason: str,
               collect: Callable[[], Dict]) -> Optional[str]:
        """Write one bundle; returns its path (None when rate-limited
        or failed)."""
        now = time.monotonic()
        with self._lock:
            last = self._last_t.get(reason)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last_t[reason] = now
            self._seq += 1
            seq = self._seq
        try:
            bundle = collect()
            bundle.setdefault("v", 1)
            bundle["reason"] = reason
            bundle["t_unix"] = time.time()
            bundle["pid"] = os.getpid()
            name = (f"flight-{int(bundle['t_unix'] * 1e3):013d}"
                    f"-{seq:04d}-{reason}.json")
            path = os.path.join(self.flight_dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=_json_default)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self.recorded_total += 1
            self._prune(keep=name)
            return path
        except Exception:
            self.record_failures_total += 1
            return None

    def bundles(self) -> List[str]:
        """Committed bundle paths, oldest first (name-sorted: names
        embed ms timestamps + a sequence number)."""
        try:
            names = sorted(n for n in os.listdir(self.flight_dir)
                           if n.startswith("flight-")
                           and n.endswith(".json"))
        except OSError:
            return []
        return [os.path.join(self.flight_dir, n) for n in names]

    def total_bytes(self) -> int:
        return sum(os.path.getsize(p) for p in self.bundles()
                   if os.path.exists(p))

    def _prune(self, keep: str) -> None:
        paths = self.bundles()
        sizes = {p: os.path.getsize(p) for p in paths
                 if os.path.exists(p)}
        total = sum(sizes.values())
        for p in paths:
            if total <= self.budget_bytes:
                break
            if os.path.basename(p) == keep:
                continue  # the newest bundle always survives
            try:
                os.unlink(p)
                total -= sizes.get(p, 0)
                self.pruned_total += 1
            except OSError:
                pass


def _json_default(obj):
    """Bundles carry whatever the engine snapshot holds — numpy
    scalars/arrays and the odd object; degrade to something readable
    rather than failing the write."""
    for attr in ("item", "tolist"):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                break
    return repr(obj)
