"""Lints of the serving layer's black-box records (port of
``tools/flight_inspect.py``, with ``lint_trace_obj`` of
``tools/trace_lint.py``).

``lint_bundle`` validates one parsed flight bundle: a replica's
(resurrection, terminal EngineFailed, stall, failed swap: engine
snapshot, step timeline, finished span trees, in-flight dump, metrics
export, page-ledger tail, capacity card) or the supervisor's autoscale
bundle (the action, the fleet, the journal's tail). ``lint_fleet_journal``
validates the autoscaler's crc-checked fleet journal; ``lint_dir`` lints
every committed ``flight-*.json`` under a directory and, given a byte
budget, the retention ring. Each returns error strings, empty when
clean, the same strings as the repo's ``tools/flight_inspect.py`` on the
same input: the chaos harness (``chaos_serving``) calls them.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

# clock-granularity slack for containment checks, in microseconds
EPS_US = 2.0


def _lint_chrome(events: List[Dict]) -> List[str]:
    errors = []
    for i, e in enumerate(events):
        if e.get("ph") == "M":
            continue  # metadata record
        if "name" not in e:
            errors.append(f"event {i}: missing name")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i} ({e.get('name')}): bad ts {ts!r}")
        if e.get("ph") == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"event {i} ({e.get('name')}): bad dur {dur!r}")
    return errors


def _lint_spans(trace: Dict) -> List[str]:
    tid = trace.get("trace_id", "?")
    errors: List[str] = []
    spans = trace.get("spans")
    if not isinstance(spans, list):
        return [f"trace {tid}: no spans list"]
    if trace.get("leaked_open"):
        errors.append(f"trace {tid}: {trace['leaked_open']} span(s) "
                      f"were force-closed at finish (leaked open)")
    by_id: Dict[str, Dict] = {}
    trace_pid = trace.get("pid")
    for s in spans:
        sid = s.get("sid")
        if not sid:
            errors.append(f"trace {tid}: span without sid "
                          f"({s.get('name')})")
            continue
        if sid in by_id:
            errors.append(f"trace {tid}: duplicate span id {sid}")
        by_id[sid] = s
    for s in spans:
        name, sid = s.get("name", "?"), s.get("sid")
        t0, t1 = s.get("t0_us"), s.get("t1_us")
        if t1 is None:
            errors.append(f"trace {tid}: span {name} ({sid}) is OPEN")
            continue
        if not isinstance(t0, (int, float)) or t0 < 0:
            errors.append(f"trace {tid}: span {name} bad t0 {t0!r}")
            continue
        if t1 + EPS_US < t0:
            errors.append(f"trace {tid}: span {name} ends before it "
                          f"starts ({t0} -> {t1})")
        parent = s.get("parent")
        if parent is not None:
            p = by_id.get(parent)
            if p is None:
                errors.append(f"trace {tid}: span {name} ({sid}) has "
                              f"ORPHAN parent {parent}")
            else:
                # same-participant containment (shared clock only)
                s_pid = (s.get("args") or {}).get("pid", trace_pid)
                p_pid = (p.get("args") or {}).get("pid", trace_pid)
                if s_pid == p_pid and p.get("t1_us") is not None:
                    if t0 + EPS_US < p["t0_us"] or \
                            t1 - EPS_US > p["t1_us"]:
                        errors.append(
                            f"trace {tid}: span {name} ({sid}) "
                            f"[{t0}, {t1}] escapes parent "
                            f"{p.get('name')} [{p['t0_us']}, "
                            f"{p['t1_us']}]")
    # cycle check (parent chains must terminate)
    for s in spans:
        seen, cur = set(), s.get("sid")
        while cur is not None:
            if cur in seen:
                errors.append(f"trace {tid}: parent cycle at {cur}")
                break
            seen.add(cur)
            nxt = by_id.get(cur)
            cur = nxt.get("parent") if nxt else None
    return errors


def lint_trace_obj(obj: Any) -> List[str]:
    """Lint a parsed trace object; returns a list of error strings
    (empty = valid)."""
    if isinstance(obj, dict) and "traceEvents" in obj:
        return _lint_chrome(obj["traceEvents"])
    if isinstance(obj, dict) and "traces" in obj:
        traces = obj["traces"]
    elif isinstance(obj, dict) and "spans" in obj:
        traces = [obj]
    elif isinstance(obj, list):
        traces = obj
    else:
        return ["unrecognized trace format (expected {'traces': [...]},"
                " a trace dict with 'spans', or {'traceEvents': [...]})"]
    errors: List[str] = []
    if not traces:
        errors.append("no traces in dump")
    for t in traces:
        if not isinstance(t, dict):
            errors.append(f"non-dict trace entry: {type(t).__name__}")
            continue
        errors.extend(_lint_spans(t))
    return errors


REQUIRED_KEYS = ("v", "reason", "t_unix", "pid", "engine", "metrics",
                 "step_timeline", "traces", "inflight")
# v2 bundles additionally carry the
# page-ledger ring tail and a capacity snapshot; both are REQUIRED at
# that version and linted below (v1 bundles predate them)
REQUIRED_KEYS_V2 = ("page_ledger", "capacity")
KNOWN_REASONS = ("resurrect", "engine_failed", "stall", "autoscale")
# autoscale bundles are written by the SUPERVISOR's recorder —
# there is no engine/timeline/inflight to snapshot; instead they
# carry the scale action, the fleet membership at commit time, and
# the journal's recent action tail
REQUIRED_KEYS_AUTOSCALE = ("v", "reason", "t_unix", "pid", "action",
                           "fleet", "journal_tail")
# the device-pool owner classes that must sum to the pool size.
# "dedup" (cross-request shared pages) is OPTIONAL in the lint: older
# bundles never carry it, newer ones always do — the sum includes it
# whenever present
OCCUPANCY_CLASSES = ("inflight", "prefix_device", "reserved", "free")
OPTIONAL_OCCUPANCY_CLASSES = ("dedup",)


def lint_bundle(bundle: Any, name: str = "bundle") -> List[str]:
    """Validate one parsed flight bundle; returns error strings
    (empty = clean)."""
    errors: List[str] = []
    if not isinstance(bundle, dict):
        return [f"{name}: not a JSON object"]
    if bundle.get("reason") == "autoscale":
        return _lint_autoscale_bundle(bundle, name)
    required = REQUIRED_KEYS
    if isinstance(bundle.get("v"), int) and bundle["v"] >= 2:
        required = REQUIRED_KEYS + REQUIRED_KEYS_V2
    for k in required:
        if k not in bundle:
            errors.append(f"{name}: missing key {k!r}")
    if errors:
        return errors
    if bundle.get("reason") not in KNOWN_REASONS:
        errors.append(f"{name}: unknown reason "
                      f"{bundle.get('reason')!r}")
    if not isinstance(bundle.get("t_unix"), (int, float)) \
            or bundle["t_unix"] <= 0:
        errors.append(f"{name}: bad t_unix {bundle.get('t_unix')!r}")
    if not isinstance(bundle.get("pid"), int):
        errors.append(f"{name}: bad pid {bundle.get('pid')!r}")

    # embedded traces: only FINISHED trees travel, so the full
    # trace_lint contract applies (an empty list is fine — tracing
    # may be unsampled/off; the flight recorder still has the ring)
    traces = bundle.get("traces")
    if not isinstance(traces, list):
        errors.append(f"{name}: traces must be a list")
    elif traces:
        errors.extend(f"{name}: {e}"
                      for e in lint_trace_obj({"traces": traces}))

    tl = bundle.get("step_timeline")
    if not isinstance(tl, list):
        errors.append(f"{name}: step_timeline must be a list")
    else:
        last = -1
        for i, entry in enumerate(tl):
            if not isinstance(entry, dict) or "step" not in entry:
                errors.append(f"{name}: timeline[{i}] not a per-step "
                              f"dict")
                continue
            s = entry["step"]
            if not isinstance(s, int) or s < last:
                errors.append(f"{name}: timeline step numbers not "
                              f"monotonic at [{i}] ({last} -> {s!r})")
                break
            last = s

    infl = bundle.get("inflight")
    if not isinstance(infl, list):
        errors.append(f"{name}: inflight must be a list")
    else:
        for i, r in enumerate(infl):
            if not isinstance(r, dict) or not all(
                    k in r for k in ("req_id", "state", "prompt_len",
                                     "generated")):
                errors.append(f"{name}: inflight[{i}] missing "
                              f"req_id/state/prompt_len/generated")

    # the page-ledger tail (event seq strictly increasing) and the
    # capacity snapshot (occupancy owner classes sum to the pool size)
    led = bundle.get("page_ledger")
    if led is not None:
        if not isinstance(led, list):
            errors.append(f"{name}: page_ledger must be a list")
        else:
            last_seq = 0
            for i, ev in enumerate(led):
                if not isinstance(ev, dict) or "seq" not in ev \
                        or "ev" not in ev:
                    errors.append(f"{name}: page_ledger[{i}] not an "
                                  f"event dict")
                    break
                s = ev["seq"]
                if not isinstance(s, int) or s <= last_seq:
                    errors.append(f"{name}: page_ledger seq not "
                                  f"monotonic at [{i}] "
                                  f"({last_seq} -> {s!r})")
                    break
                last_seq = s
    cap = bundle.get("capacity")
    if cap is not None:
        if not isinstance(cap, dict) \
                or not isinstance(cap.get("num_pages"), int) \
                or not isinstance(cap.get("occupancy"), dict):
            errors.append(f"{name}: capacity must carry num_pages + "
                          f"occupancy")
        else:
            occ = cap["occupancy"]
            missing = [c for c in OCCUPANCY_CLASSES if c not in occ]
            if missing:
                errors.append(f"{name}: capacity occupancy missing "
                              f"classes {missing}")
            else:
                total = sum(int(occ[c]) for c in OCCUPANCY_CLASSES)
                total += sum(int(occ.get(c, 0))
                             for c in OPTIONAL_OCCUPANCY_CLASSES)
                if total != cap["num_pages"]:
                    errors.append(
                        f"{name}: occupancy classes sum {total} != "
                        f"pool size {cap['num_pages']}")

    met = bundle.get("metrics")
    if not isinstance(met, dict):
        errors.append(f"{name}: metrics must be an export dict")
    else:
        for hname, h in (met.get("histograms") or {}).items():
            if not isinstance(h, dict) or "counts" not in h:
                errors.append(f"{name}: histogram {hname} malformed")
                continue
            if sum(h["counts"]) != h.get("total"):
                errors.append(
                    f"{name}: histogram {hname} counts sum "
                    f"{sum(h['counts'])} != total {h.get('total')}")
    return errors


def _lint_autoscale_bundle(bundle: Dict, name: str) -> List[str]:
    """Supervisor-side autoscale bundles: action + fleet +
    journal tail instead of an engine snapshot."""
    errors: List[str] = []
    for k in REQUIRED_KEYS_AUTOSCALE:
        if k not in bundle:
            errors.append(f"{name}: missing key {k!r}")
    if errors:
        return errors
    if not isinstance(bundle.get("t_unix"), (int, float)) \
            or bundle["t_unix"] <= 0:
        errors.append(f"{name}: bad t_unix {bundle.get('t_unix')!r}")
    if not isinstance(bundle.get("pid"), int):
        errors.append(f"{name}: bad pid {bundle.get('pid')!r}")
    act = bundle.get("action")
    if not isinstance(act, dict) or not all(
            k in act for k in ("action", "reason", "ok")):
        errors.append(f"{name}: action must carry action/reason/ok")
    fleet = bundle.get("fleet")
    if not isinstance(fleet, list):
        errors.append(f"{name}: fleet must be a list")
    else:
        for i, e in enumerate(fleet):
            if not isinstance(e, dict) \
                    or not isinstance(e.get("idx"), int):
                errors.append(f"{name}: fleet[{i}] missing int idx")
    tail = bundle.get("journal_tail")
    if not isinstance(tail, list):
        errors.append(f"{name}: journal_tail must be a list")
    else:
        for i, e in enumerate(tail):
            if not isinstance(e, dict) \
                    or not isinstance(e.get("seq"), int) \
                    or e.get("phase") not in JOURNAL_PHASES:
                errors.append(f"{name}: journal_tail[{i}] not a "
                              f"seq/phase entry")
    return errors


# "swapped" marks a roll action's confirmed weight swap — legal
# ONLY between a ``roll`` begin and its terminal phase; recovery keys
# its forward/backward convergence decision on it
JOURNAL_PHASES = ("begin", "launched", "swapped", "commit",
                  "rollback")
_JOURNAL_ROLES = ("mixed", "prefill", "decode")


def lint_fleet_journal(obj: Any, name: str = "journal",
                       allow_open_tail: int = 0) -> List[str]:
    """Validate a parsed fleet-state journal (the autoscaler's atomic
    crc-checked file); returns error strings (empty = clean).

    Checks the journal contract: crc over the canonical body
    (key-sorted, separator-free JSON, recomputed here without importing
    the serving layer), a seq counter covering every logged action, ``begin``
    seqs strictly monotonic, every ``begin`` matched by a terminal
    ``commit``/``rollback``, and typed fleet entries (int idx, known
    role). ``allow_open_tail`` tolerates that many UNRESOLVED actions
    at the end of the log — a supervisor crashed mid-action
    legitimately leaves its in-flight action open (lint the debris
    with 1), but after a recovery pass every action must be resolved
    (the chaos harness lints with the default 0)."""
    errors: List[str] = []
    if not isinstance(obj, dict) or "body" not in obj \
            or "crc" not in obj:
        return [f"{name}: not a fleet journal (crc+body object)"]
    body = obj["body"]
    crc = zlib.crc32(json.dumps(
        body, sort_keys=True, separators=(",", ":")).encode())
    if obj.get("crc") != crc:
        errors.append(f"{name}: crc mismatch "
                      f"({obj.get('crc')} != {crc})")
    if not isinstance(body, dict):
        return errors + [f"{name}: body must be an object"]
    if not isinstance(body.get("seq"), int) or body["seq"] < 0:
        errors.append(f"{name}: bad seq counter {body.get('seq')!r}")
    actions = body.get("actions")
    begins: List[int] = []
    resolved: set = set()
    begin_kind: Dict[int, Any] = {}
    if not isinstance(actions, list):
        errors.append(f"{name}: actions must be a list")
        actions = []
    for i, e in enumerate(actions):
        if not isinstance(e, dict) \
                or not isinstance(e.get("seq"), int) \
                or e.get("phase") not in JOURNAL_PHASES:
            errors.append(f"{name}: actions[{i}] not a seq/phase "
                          f"entry")
            continue
        if e["phase"] == "begin":
            if begins and e["seq"] <= begins[-1]:
                errors.append(f"{name}: begin seq not monotonic at "
                              f"actions[{i}] ({begins[-1]} -> "
                              f"{e['seq']})")
            begins.append(e["seq"])
            begin_kind[e["seq"]] = e.get("action")
        elif e["phase"] == "swapped":
            # a confirmed weight swap belongs to a roll action
            # and nothing else (a swapped spawn/drain/rerole would
            # mean the supervisor wrote a nonsense recovery record).
            # A seq whose begin was pruned from the bounded tail is
            # tolerated — only a VISIBLE mismatch is an error.
            kind = begin_kind.get(e["seq"])
            if kind is not None and kind != "roll":
                errors.append(f"{name}: actions[{i}] phase "
                              f"'swapped' on a {kind!r} action "
                              f"(only roll actions swap)")
        elif e["phase"] in ("commit", "rollback"):
            resolved.add(e["seq"])
        if isinstance(body.get("seq"), int) \
                and e["seq"] > body["seq"]:
            errors.append(f"{name}: actions[{i}] seq {e['seq']} "
                          f"beyond counter {body['seq']}")
    open_seqs = [s for s in begins if s not in resolved]
    if len(open_seqs) > max(0, int(allow_open_tail)):
        errors.append(
            f"{name}: {len(open_seqs)} begin(s) without commit/"
            f"rollback (seqs {open_seqs}; {allow_open_tail} "
            f"tolerated)")
    fleet = body.get("fleet")
    if not isinstance(fleet, list):
        errors.append(f"{name}: fleet must be a list")
    else:
        seen_idx = set()
        for i, e in enumerate(fleet):
            if not isinstance(e, dict) \
                    or not isinstance(e.get("idx"), int):
                errors.append(f"{name}: fleet[{i}] missing int idx")
                continue
            if e["idx"] in seen_idx:
                errors.append(f"{name}: fleet idx {e['idx']} "
                              f"duplicated")
            seen_idx.add(e["idx"])
            if e.get("role") not in _JOURNAL_ROLES:
                errors.append(f"{name}: fleet[{i}] bad role "
                              f"{e.get('role')!r}")
            if e.get("pid") is not None \
                    and not isinstance(e.get("pid"), int):
                errors.append(f"{name}: fleet[{i}] bad pid "
                              f"{e.get('pid')!r}")
    return errors


def lint_dir(path: str, budget_bytes: Optional[int] = None
             ) -> Tuple[List[str], List[str]]:
    """Lint every committed bundle under ``path``; returns (bundle
    paths, errors). With ``budget_bytes``, also checks the retention
    ring held its byte budget (the chaos-harness invariant). Only
    COMMITTED bundles (``flight-*.json``) are considered: a leftover
    ``*.tmp`` is legitimate crash debris under the atomic-rename
    contract (a SIGKILL mid-write abandons the tmp; the rename is
    what commits), so tmp files are ignored, never linted, and never
    counted against the budget."""
    errors: List[str] = []
    try:
        names = sorted(os.listdir(path))
    except OSError as e:
        return [], [f"{path}: {e}"]
    bundles = [os.path.join(path, n) for n in names
               if n.startswith("flight-") and n.endswith(".json")]
    total = 0
    for p in bundles:
        try:
            total += os.path.getsize(p)
            with open(p, encoding="utf-8") as f:
                obj = json.load(f)
        except Exception as e:
            errors.append(f"{p}: unreadable ({type(e).__name__}: {e})")
            continue
        errors.extend(lint_bundle(obj, name=os.path.basename(p)))
    if budget_bytes is not None and len(bundles) > 1 \
            and total > budget_bytes:
        # a single oversized newest bundle is allowed (the most
        # recent crash always survives); more than one while over
        # budget means pruning failed
        errors.append(f"{path}: retention ring over budget "
                      f"({total} > {budget_bytes} bytes across "
                      f"{len(bundles)} bundles)")
    return bundles, errors
