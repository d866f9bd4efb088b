"""Closed-loop autoscaling for the serving fleet (port of
``paddle_tpu/serving/autoscaler.py``).

The `PressureMonitor` (``fleet_metrics.py``) publishes a hysteretic
``scale_up`` / ``steady`` / ``scale_down`` verdict; the `Autoscaler`
here consumes it. It is a supervisor-side control loop that

- spawns a replica on ``scale_up`` and drains, then kills, one on
  ``scale_down``, inside a min/max-replica envelope with a cooldown for
  each direction and one action in flight at a time;
- on a disaggregated fleet also steers the fleet's shape: a mixed or
  over-represented replica is re-roled (drained and restarted with a
  new ``--role``) toward one prefill replica for every
  ``decode_per_prefill`` decode-capable ones.

Every action is journaled to an atomic crc-checked fleet-state file
(`FleetJournal`: tmp + rename + fsync) before the process action it
describes, so a supervisor that dies mid-action leaves a record a
restarted supervisor acts on: `plan_recovery` + `Autoscaler.recover`
adopt running replicas found in the journal or by their
``PT_SUPERVISOR_JOURNAL`` env marker, reap or adopt an orphaned
half-spawn, resume or roll back a half-finished drain, re-role or
weight roll, and never spawn a second copy of a live replica. A spawn
that never goes ready is killed and still charged against the
cooldown; a drain whose handoff fails falls back to a plain drain (the
survivors prefill the chains again on first use); the router's replica
set changes only after the journal commit.

The journal's bytes are the reference's: a journal either package
writes loads in the other. The module uses no ``torch``, and the
supervisor process that runs it never touches the card. Recovery
recognises a replica by its command line, ``python -m
paddle_tpu_torch.serving.server``, so it never adopts or signals a
process of the JAX package.

Chaos hook: ``PT_AUTOSCALE_HOLD_S`` sleeps inside every action's
journaled-but-uncommitted window, so ``paddle_tpu_torch.tools.
chaos_serving`` can SIGKILL the supervisor mid-spawn, mid-scale-down
or mid-roll deterministically. Nothing happens when it is unset.

Run it::

    python -m paddle_tpu_torch.serving.supervisor --replicas 2 \
        --autoscale --min-replicas 1 --max-replicas 4 --cooldown-s 30 \
        --journal /abs/path/fleet-journal.json
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["AutoscaleConfig", "FleetJournal", "Autoscaler",
           "desired_prefill", "load_journal", "open_actions",
           "plan_recovery", "scan_marked_replicas"]

_ROLES = ("mixed", "prefill", "decode")
# env markers _spawn stamps on every journal-managed replica: recovery
# can attribute an orphaned server process to its fleet even when the
# journal's pid snapshot is stale (the monitor loop respawns crashed
# replicas without a journal write)
JOURNAL_ENV = "PT_SUPERVISOR_JOURNAL"
REPLICA_IDX_ENV = "PT_REPLICA_IDX"
# the command line of a replica process (``python -m <this>``): the
# reference's "paddle_tpu.serving.server" is no substring of it, so
# neither package's recovery adopts the other's replicas
SERVER_MODULE = "paddle_tpu_torch.serving.server"


def _canonical(body: Dict) -> bytes:
    """The byte form the journal crc covers: key-sorted, no
    whitespace — any reader (``tools/flight_inspect.py`` recomputes
    this without importing either package) derives the same digest."""
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()


def load_journal(path: str) -> Tuple[Optional[Dict], Optional[str]]:
    """Read + verify a fleet journal; returns ``(body, error)`` —
    exactly one is None. A missing file is not an error distinct from
    a torn one to the CALLER (both mean "no trusted state"), but the
    error string says which for the operator."""
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
    except FileNotFoundError:
        return None, f"{path}: no journal"
    except Exception as e:
        return None, f"{path}: unreadable ({type(e).__name__}: {e})"
    if not isinstance(obj, dict) or "body" not in obj:
        return None, f"{path}: not a journal object"
    body = obj["body"]
    crc = zlib.crc32(_canonical(body))
    if obj.get("crc") != crc:
        return None, (f"{path}: crc mismatch "
                      f"({obj.get('crc')} != {crc})")
    return body, None


class FleetJournal:
    """Atomic crc-checked fleet-state file.

    One JSON object ``{"v": 1, "crc": <crc32 of canonical body>,
    "body": {...}}`` rewritten WHOLE on every mutation (tmp + rename
    + fsync — the ResilientCheckpointManager discipline: a crash
    mid-write leaves the previous committed state, never a torn
    file). The body holds the action seq counter, the owning
    supervisor pid, the last COMMITTED fleet (idx/pid/port/role per
    replica), and an append-only action log: each action contributes
    a ``begin`` entry (written BEFORE the process action), optional
    ``launched`` (spawn pid known), and a terminal ``commit`` or
    ``rollback``. The log keeps a bounded tail but never drops an
    entry belonging to an unresolved seq."""

    MAX_ACTION_ENTRIES = 256

    def __init__(self, path: str,
                 supervisor_pid: Optional[int] = None):
        self.path = path
        self._lock = threading.Lock()
        self.writes_total = 0
        self.write_failures_total = 0
        self._body: Dict = {"seq": 0,
                            "supervisor_pid": (supervisor_pid
                                               or os.getpid()),
                            "fleet": [], "actions": []}

    # -- persistence -------------------------------------------------------

    def _write_locked(self) -> None:
        body = self._body
        obj = {"v": 1, "crc": zlib.crc32(_canonical(body)),
               "body": body}
        tmp = self.path + ".tmp"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(obj, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.writes_total += 1
        except OSError:
            # a journal that cannot persist must not take the fleet
            # down; the failure is counted and surfaces in status()
            self.write_failures_total += 1

    def adopt_body(self, body: Dict) -> None:
        """Continue a recovered journal: keep its seq counter (action
        seqs stay monotonic ACROSS supervisor generations), its
        action log and its committed weight config; the fleet
        snapshot and owner pid are ours now."""
        with self._lock:
            self._body["seq"] = int(body.get("seq") or 0)
            self._body["actions"] = list(body.get("actions") or ())
            self._body["supervisor_pid"] = os.getpid()
            if isinstance(body.get("config"), dict):
                self._body["config"] = dict(body["config"])
            self._write_locked()

    # -- mutation ----------------------------------------------------------

    def _append_locked(self, entry: Dict) -> None:
        acts = self._body["actions"]
        acts.append(entry)
        if len(acts) > self.MAX_ACTION_ENTRIES:
            resolved = {e["seq"] for e in acts
                        if e.get("phase") in ("commit", "rollback")}
            keep = acts[-self.MAX_ACTION_ENTRIES:]
            head = [e for e in acts[:-self.MAX_ACTION_ENTRIES]
                    if e["seq"] not in resolved]
            self._body["actions"] = head + keep

    def begin(self, action: str, **fields) -> int:
        """Allocate the next action seq and journal the INTENT —
        called before the process action so a crash can only lose
        work the journal already names."""
        with self._lock:
            self._body["seq"] += 1
            seq = self._body["seq"]
            entry = {"seq": seq, "action": action, "phase": "begin",
                     "t_unix": time.time()}
            entry.update(fields)
            self._append_locked(entry)
            self._write_locked()
            return seq

    def update(self, seq: int, phase: str = "launched",
               **fields) -> None:
        with self._lock:
            entry = {"seq": seq, "phase": phase,
                     "t_unix": time.time()}
            entry.update(fields)
            self._append_locked(entry)
            self._write_locked()

    def commit(self, seq: int, **fields) -> None:
        self.update(seq, phase="commit", **fields)

    def rollback(self, seq: int, reason: str = "", **fields) -> None:
        self.update(seq, phase="rollback", reason=reason, **fields)

    def record_fleet(self, fleet: List[Dict]) -> None:
        """Persist the COMMITTED fleet (who exists, where). Also the
        monitor-respawn refresh path: pids change without a scale
        action, and recovery trusts this snapshot first."""
        with self._lock:
            self._body["fleet"] = list(fleet)
            self._write_locked()

    def record_config(self, checkpoint: Optional[str],
                      generation: int) -> None:
        """Persist the fleet's COMMITTED weight config: the
        checkpoint directory and weight generation every respawn
        boots from. Written when a roll fully commits — recovery
        restores it so a restarted supervisor spawns dead replicas
        on the rolled weights, and an incomplete roll converges BACK
        to exactly this config."""
        with self._lock:
            self._body["config"] = {
                "checkpoint": checkpoint,
                "generation": int(generation)}
            self._write_locked()

    def config(self) -> Dict:
        with self._lock:
            return dict(self._body.get("config") or {})

    # -- reads -------------------------------------------------------------

    def tail(self, n: int = 16) -> List[Dict]:
        with self._lock:
            return [dict(e) for e in self._body["actions"][-n:]]

    def fleet(self) -> List[Dict]:
        with self._lock:
            return [dict(e) for e in self._body["fleet"]]

    @property
    def seq(self) -> int:
        with self._lock:
            return self._body["seq"]


def open_actions(body: Dict) -> List[Dict]:
    """Actions with a ``begin`` and no terminal ``commit``/
    ``rollback`` — merged per seq (later phases overlay fields, e.g.
    the spawn pid from ``launched``), oldest first."""
    merged: Dict[int, Dict] = {}
    resolved = set()
    for e in (body.get("actions") or ()):
        seq = e.get("seq")
        if not isinstance(seq, int):
            continue
        if e.get("phase") == "begin":
            merged[seq] = dict(e)
        elif e.get("phase") in ("commit", "rollback"):
            resolved.add(seq)
        elif seq in merged:
            upd = {k: v for k, v in e.items() if k != "phase"}
            merged[seq].update(upd)
    return [merged[s] for s in sorted(merged) if s not in resolved]


# ---------------------------------------------------------------------------
# orphan discovery + adoption plumbing
# ---------------------------------------------------------------------------


def _proc_environ(pid: int) -> Dict[str, str]:
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            raw = f.read()
    except OSError:
        return {}
    out = {}
    for part in raw.split(b"\0"):
        if b"=" in part:
            k, _, v = part.partition(b"=")
            out[k.decode("utf-8", "replace")] = \
                v.decode("utf-8", "replace")
    return out


def _proc_cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(
                "utf-8", "replace")
    except OSError:
        return ""


def _pid_is_replica(pid: int, port: Optional[int] = None) -> bool:
    """Is ``pid`` a live serving-server process (optionally on
    ``port``)? The cmdline check is the pid-reuse guard: a recycled
    pid running something else must never be adopted or signalled."""
    cmd = _proc_cmdline(pid)
    if SERVER_MODULE not in cmd:
        return False
    if port is not None and f"--port {port}" not in cmd:
        return False
    return True


def scan_marked_replicas(journal_path: str) -> Dict[int, Dict]:
    """Find every live server process stamped with OUR journal's env
    marker: ``{idx: {"pid": p, "port": q}}``. Catches replicas the
    journal's fleet snapshot missed (a monitor respawn between
    snapshot refreshes) — the never-strand backstop."""
    out: Dict[int, Dict] = {}
    try:
        pids = [int(p) for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return out
    me = os.getpid()
    for pid in pids:
        if pid == me:
            continue
        cmd = _proc_cmdline(pid)
        if SERVER_MODULE not in cmd:
            continue
        env = _proc_environ(pid)
        if env.get(JOURNAL_ENV) != journal_path:
            continue
        try:
            idx = int(env.get(REPLICA_IDX_ENV, ""))
        except ValueError:
            continue
        port = None
        toks = cmd.split()
        if "--port" in toks:
            try:
                port = int(toks[toks.index("--port") + 1])
            except (ValueError, IndexError):
                port = None
        out[idx] = {"pid": pid, "port": port}
    return out


class _AdoptedProc:
    """Popen-shaped handle over a replica ADOPTED from the journal:
    the process is not our child, so ``waitpid`` is unavailable —
    liveness is polled through /proc with the cmdline pid-reuse
    guard, signals go through ``os.kill``. Implements exactly the
    Popen surface the Supervisor uses (poll/wait/terminate/kill/
    send_signal/pid), so adopted and spawned replicas ride the same
    monitor/teardown code."""

    def __init__(self, pid: int, port: Optional[int] = None):
        self.pid = int(pid)
        self._port = port
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None and \
                not _pid_is_replica(self.pid, self._port):
            self.returncode = 0  # exit status unknowable: not ours
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while self.poll() is None:
            if deadline is not None and \
                    time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(
                    f"adopted pid {self.pid}", timeout)
            time.sleep(0.05)
        return self.returncode

    def send_signal(self, sig: int) -> None:
        if self.poll() is not None:
            return
        try:
            os.kill(self.pid, sig)
        except OSError:
            pass

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)


# ---------------------------------------------------------------------------
# recovery planning (pure — unit-testable without processes)
# ---------------------------------------------------------------------------


def plan_recovery(body: Optional[Dict], scan: Dict[int, Dict],
                  min_replicas: int, max_replicas: int,
                  alive: Optional[Callable[[int, Optional[int]],
                                           bool]] = None) -> Dict:
    """Decide what a restarted supervisor does with the journal +
    the live-process scan. Pure function of its inputs (``alive``
    injectable for tests; defaults to the /proc check):

    - every journal-fleet replica still running is ADOPTED; a dead
      one is RESPAWNED (fresh process, same idx/role);
    - a scanned live replica the fleet snapshot missed is adopted
      too (monitor respawn raced the snapshot) — never stranded;
    - an open ``spawn`` is adopted + committed when its process runs
      and the envelope has room, else reaped + rolled back; a spawn
      that never launched is rolled back (nothing to reap);
    - an open ``drain`` whose victim is dead is committed (the kill
      half finished); a live victim is RESUMED (re-drained — chains
      already shipped to survivors stay valid) when the envelope
      allows the removal, else ROLLED BACK and the victim re-admitted
      as a full member;
    - an open ``rerole`` resumes against a live victim and completes
      as a respawn-with-new-role against a dead one;
    - an open ``roll`` (a weight upgrade) resumes FORWARD when the
      swap was confirmed (``swapped`` recorded) or any sibling roll
      action to the same target generation already committed (the
      canary proved the checkpoint) — the fleet converges onto the
      new generation; otherwise it converges BACK to the journal's
      committed weight config and the action rolls back
      (``roll_incomplete``). Either way the action stays OPEN until
      the executor finishes converging, so a second crash mid-resume
      resumes again instead of stranding a mixed-generation fleet.

    Adoption is keyed by replica idx, so the same process can never
    be adopted twice and a planned respawn never duplicates a live
    one — the never-double-spawn contract."""
    if alive is None:
        alive = _pid_is_replica
    plan = {"adopt": [], "respawn": [], "reap": [],
            "resolve": [], "resume": [], "errors": []}
    fleet = {e["idx"]: dict(e)
             for e in ((body or {}).get("fleet") or ())
             if isinstance(e, dict) and isinstance(e.get("idx"), int)}
    # scan overlays the snapshot: a respawn between snapshot
    # refreshes means the journal pid is stale but the scan is live
    for idx, info in scan.items():
        ent = fleet.setdefault(idx, {"idx": idx, "role": "mixed"})
        ent["pid"], ent["port"] = info["pid"], info.get("port")
    claimed: set = set()
    members: Dict[int, Dict] = {}

    def is_alive(ent: Dict) -> bool:
        pid = ent.get("pid")
        return isinstance(pid, int) and alive(pid, ent.get("port"))

    opens = open_actions(body) if body else []
    open_idxs = {a.get("replica") for a in opens}
    # roll recovery: a target generation is PROVEN when any
    # roll action to it committed (the canary survived its window) —
    # an open sibling then resumes forward instead of rolling back
    roll_begins: Dict[int, Dict] = {}
    committed_seqs: set = set()
    for e in ((body or {}).get("actions") or ()):
        if not isinstance(e, dict):
            continue
        if e.get("phase") == "begin" and e.get("action") == "roll":
            roll_begins[e.get("seq")] = e
        elif e.get("phase") == "commit":
            committed_seqs.add(e.get("seq"))
    proven_gens = {e.get("generation_to")
                   for s, e in roll_begins.items()
                   if s in committed_seqs and not e.get("rollback")}
    for idx, ent in sorted(fleet.items()):
        if idx in open_idxs:
            continue  # the action resolution below owns this replica
        if is_alive(ent):
            plan["adopt"].append(ent)
            members[idx] = ent
        else:
            plan["respawn"].append({"idx": idx,
                                    "role": ent.get("role", "mixed")})
            members[idx] = ent
        claimed.add(idx)

    for act in opens:
        seq, kind = act["seq"], act.get("action")
        idx = act.get("replica")
        ent = fleet.get(idx, {"idx": idx,
                              "role": act.get("role", "mixed")})
        if act.get("pid") is not None:
            ent.setdefault("pid", act["pid"])
            ent.setdefault("port", act.get("port"))
        live_now = is_alive(ent)
        if kind == "spawn":
            if live_now and len(members) < max_replicas:
                ent.setdefault("role", act.get("role", "mixed"))
                plan["adopt"].append(ent)
                members[idx] = ent
                plan["resolve"].append(
                    (seq, "commit", "adopted_on_recovery"))
            elif live_now:
                plan["reap"].append(ent)
                plan["resolve"].append(
                    (seq, "rollback", "reaped_over_envelope"))
            else:
                plan["resolve"].append(
                    (seq, "rollback", "orphan_dead"))
        elif kind == "drain":
            survivors = len([m for m in members if m != idx])
            if not live_now:
                plan["resolve"].append(
                    (seq, "commit", "victim_already_dead"))
            elif survivors >= min_replicas and survivors >= 1:
                plan["adopt"].append(dict(ent, draining=True))
                plan["resume"].append({"seq": seq, "action": "drain",
                                       "replica": idx})
            else:
                # re-admit: killing it now would violate the envelope
                plan["adopt"].append(ent)
                members[idx] = ent
                plan["resolve"].append(
                    (seq, "rollback", "readmitted_below_min"))
        elif kind == "rerole":
            to_role = act.get("role_to", "mixed")
            if live_now:
                plan["adopt"].append(
                    dict(ent, role=act.get("role_from",
                                           ent.get("role", "mixed")),
                         draining=True))
                plan["resume"].append(
                    {"seq": seq, "action": "rerole", "replica": idx,
                     "role": to_role})
            else:
                plan["respawn"].append({"idx": idx, "role": to_role})
                members[idx] = dict(ent, role=to_role)
                plan["resolve"].append(
                    (seq, "commit", "respawned_with_new_role"))
        elif kind == "roll":
            # the victim is a normal fleet member either way (a swap
            # never removes a process); which GENERATION the fleet
            # converges to is the resume entry's job
            if live_now:
                plan["adopt"].append(ent)
            else:
                plan["respawn"].append(
                    {"idx": idx, "role": ent.get("role", "mixed")})
            members[idx] = ent
            gen_to = act.get("generation_to")
            if act.get("swapped") or gen_to in proven_gens:
                plan["resume"].append(
                    {"seq": seq, "action": "roll", "replica": idx,
                     "checkpoint": act.get("checkpoint"),
                     "generation": gen_to})
            else:
                cfg = (body or {}).get("config") or {}
                plan["resume"].append(
                    {"seq": seq, "action": "roll_back",
                     "replica": idx,
                     "checkpoint": cfg.get("checkpoint"),
                     "generation": int(
                         cfg.get("generation")
                         or act.get("generation_from") or 0)})
        else:
            plan["resolve"].append(
                (seq, "rollback", f"unknown_action_{kind}"))
    return plan


# ---------------------------------------------------------------------------
# the actuator
# ---------------------------------------------------------------------------


@dataclass
class AutoscaleConfig:
    """Envelope + pacing for the actuator. ``cooldown_up_s`` gates
    spawns, ``cooldown_down_s`` gates drains AND re-roles (both cost
    a drain); ``shape`` enables the prefill:decode ratio controller
    on disaggregated fleets."""

    min_replicas: int = 1
    max_replicas: int = 4
    cooldown_up_s: float = 30.0
    cooldown_down_s: float = 60.0
    interval_s: float = 1.0
    spawn_ready_timeout_s: float = 300.0
    drain_timeout_s: float = 30.0
    shape: bool = True
    # the shape rule's numeric form: target one prefill replica per
    # ``decode_per_prefill`` decode-capable replicas, bumped up when
    # handoff prefill failures climb, down when TPOT attainment drops
    decode_per_prefill: float = 3.0
    tpot_attain_low: float = 0.9


def desired_prefill(n_total: int, decode_per_prefill: float = 3.0,
                    bias: int = 0) -> int:
    """The prefill:decode ratio rule, executable: prefill replicas for an
    ``n_total``-replica disaggregated fleet ("start 1 prefill per
    2-4 decode"), clamped so at least one replica of EACH class
    survives any shape move. ``bias`` is the signal correction:
    +1 when handoff prefill failures climb, -1 when TPOT attainment
    drops (grow the decode side)."""
    if n_total < 2:
        return 0
    want = round(n_total / (1.0 + decode_per_prefill)) + bias
    return max(1, min(n_total - 1, want))


class Autoscaler:
    """The closed-loop actuator. Owns the `FleetJournal`, consumes
    the `FleetMetrics` verdict→action latch, and performs journaled
    spawn/drain/rerole actions against the supervisor. All actions —
    loop-driven, forced (router ``autoscale`` op), or resumed from
    recovery — serialize on one lock: single action in flight,
    ever."""

    def __init__(self, supervisor, config: Optional[AutoscaleConfig]
                 = None, journal_path: Optional[str] = None,
                 flight=None):
        self.sup = supervisor
        self.cfg = config or AutoscaleConfig()
        if self.cfg.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.cfg.max_replicas < self.cfg.min_replicas:
            raise ValueError("max_replicas < min_replicas")
        path = journal_path or os.path.join(self.sup.log_dir,
                                            "fleet-journal.json")
        self.journal = FleetJournal(path)
        # flight recorder: every action commit/
        # rollback writes an ``autoscale`` bundle — the postmortem
        # shows what the actuator did before a crash
        self.flight = flight
        self.actions_total: Dict[Tuple[str, str], int] = {}
        self.last_action: Optional[Dict] = None
        self.recovery: Optional[Dict] = None
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None
        self._handoff_fail_seen = 0
        self._action_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending_resumes: List[Dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the supervisor stamps PT_SUPERVISOR_JOURNAL (+ replica idx)
        # into every replica env so recovery/straggler scans can
        # attribute orphans to this fleet
        self.sup.journal_path = path
        self.sup.autoscaler = self

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        daemon=True,
                                        name="pt-autoscaler")
        self._thread.start()

    def stop(self, grace_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=grace_s)

    # -- recovery ----------------------------------------------------------

    def recover(self) -> Dict:
        """Adopt the previous supervisor generation's fleet. Must run
        BEFORE ``Supervisor.start()``: it REPLACES ``sup.replicas``
        with adopted (live, not re-spawned) + to-respawn records, so
        start() only spawns what recovery says is dead. Resumed
        half-finished actions queue for the loop's first tick (after
        the fleet is ready)."""
        from .supervisor import Replica

        body, err = load_journal(self.journal.path)
        scan = scan_marked_replicas(self.journal.path)
        report: Dict = {"journal": self.journal.path,
                        "loaded": body is not None,
                        "error": err, "adopted": [], "respawned": [],
                        "reaped": [], "resolved": [], "resumed": []}
        if body is None and not scan:
            self.recovery = report
            self.journal.record_fleet([])
            return report
        plan = plan_recovery(body, scan, self.cfg.min_replicas,
                             self.cfg.max_replicas)
        if body is not None:
            self.journal.adopt_body(body)
            # restore the committed weight config BEFORE any
            # respawn — a dead replica must come back on the weights
            # the previous supervisor generation had rolled to
            cfg = body.get("config") or {}
            if cfg:
                self.sup.checkpoint = cfg.get("checkpoint")
                self.sup.weight_generation = int(
                    cfg.get("generation") or 0)
        replicas: List[Replica] = []
        for ent in plan["adopt"]:
            rep = Replica(int(ent["idx"]), self.sup.host)
            rep.port = ent.get("port")
            rep.role = (ent.get("role") if ent.get("role") in _ROLES
                        else "mixed")
            rep.proc = _AdoptedProc(int(ent["pid"]), ent.get("port"))
            rep.spawn_t = time.monotonic()
            rep.log_path = os.path.join(self.sup.log_dir,
                                        f"replica{rep.idx}.log")
            rep.draining = bool(ent.get("draining"))
            replicas.append(rep)
            report["adopted"].append(
                {"idx": rep.idx, "pid": ent["pid"],
                 "port": rep.port, "role": rep.role,
                 "draining": rep.draining})
        for ent in plan["respawn"]:
            rep = Replica(int(ent["idx"]), self.sup.host)
            rep.role = (ent.get("role") if ent.get("role") in _ROLES
                        else "mixed")
            replicas.append(rep)  # proc None: start() spawns it
            report["respawned"].append({"idx": rep.idx,
                                        "role": rep.role})
        for ent in plan["reap"]:
            proc = _AdoptedProc(int(ent["pid"]), ent.get("port"))
            proc.kill()
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
            report["reaped"].append({"idx": ent.get("idx"),
                                     "pid": ent["pid"]})
        for seq, verdict, why in plan["resolve"]:
            if verdict == "commit":
                self.journal.commit(seq, resumed=why)
            else:
                self.journal.rollback(seq, reason=why)
            report["resolved"].append({"seq": seq, "phase": verdict,
                                       "reason": why})
        if replicas:
            self.sup.replicas = replicas
            self.sup._next_idx = max(r.idx for r in replicas) + 1
        self._pending_resumes = list(plan["resume"])
        report["resumed"] = list(plan["resume"])
        self.journal.record_fleet(self._fleet_entries())
        self.recovery = report
        return report

    # -- control loop ------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception:
                # the actuator must never take the supervisor down;
                # a failed tick is retried next interval
                pass
            self._stop.wait(timeout=self.cfg.interval_s)

    def _tick(self) -> None:
        while self._pending_resumes and not self._stop.is_set():
            self._execute_resume(self._pending_resumes.pop(0))
        self._refresh_fleet_record()
        fleet = getattr(self.sup, "fleet", None)
        pressure = (fleet.consume_pressure()
                    if fleet is not None and
                    hasattr(fleet, "consume_pressure") else None)
        acted = False
        if pressure is not None:
            v = pressure.get("verdict")
            if v == "scale_up":
                acted = bool(self.scale_up(reason="pressure")
                             .get("ok"))
            elif v == "scale_down":
                acted = bool(self.scale_down(reason="pressure")
                             .get("ok"))
        if not acted and self.cfg.shape:
            plan = self.plan_shape()
            if plan is not None:
                self.rerole(plan["replica"], plan["role"],
                            reason=plan["reason"])

    def _execute_resume(self, resume: Dict) -> None:
        seq, idx = resume["seq"], resume["replica"]
        try:
            rep = self.sup._by_idx(idx)
        except KeyError:
            self.journal.rollback(seq, reason="resume_victim_lost")
            return
        if resume["action"] == "drain":
            self._finish_drain(rep, seq, reason="resume")
        elif resume["action"] == "rerole":
            self._finish_rerole(rep, resume.get("role", "mixed"),
                                seq, reason="resume")
        elif resume["action"] == "roll":
            self._finish_roll(resume, forward=True)
        elif resume["action"] == "roll_back":
            self._finish_roll(resume, forward=False)

    def _finish_roll(self, resume: Dict, forward: bool) -> None:
        """Converge an interrupted weight roll. Forward: the swap
        was confirmed (or a sibling committed), so finish rolling the
        WHOLE fleet onto the target generation — roll_fleet skips
        already-converged replicas, making the resume idempotent.
        Backward: the swap was never confirmed, so converge every
        replica (including one whose swap landed just before the
        kill) back to the journal's committed config. The journal
        entry resolves only AFTER convergence — a crash mid-resume
        leaves it open for the next recovery."""
        seq = resume["seq"]
        ckpt = resume.get("checkpoint")
        gen = int(resume.get("generation") or 0)
        if forward:
            out = self.sup.roll_fleet(ckpt, generation=gen,
                                      canary_window_s=0.0,
                                      reason="resume")
            if out.get("ok"):
                self.journal.commit(seq, resumed="roll_resumed")
                self.journal.record_config(ckpt, gen)
                return
            # forward convergence failed (checkpoint gone / every
            # swap refused): fall back to the committed config so
            # the fleet is at least UNIFORM
            cfg = self.journal.config()
            self.sup._rollback_generation(
                cfg.get("checkpoint"),
                int(cfg.get("generation") or 0), self.journal,
                reason="roll_resume_failed")
            self.sup.checkpoint = cfg.get("checkpoint")
            self.sup.weight_generation = int(
                cfg.get("generation") or 0)
            self.journal.rollback(seq, reason="roll_resume_failed")
            return
        self.sup._rollback_generation(ckpt, gen, self.journal,
                                      reason="roll_incomplete")
        self.sup.checkpoint = ckpt
        self.sup.weight_generation = gen
        self.journal.rollback(seq, reason="roll_incomplete")

    def _refresh_fleet_record(self) -> None:
        """Keep the journal's fleet snapshot current with monitor
        respawns (pid/port churn without a scale action)."""
        cur = self._fleet_entries()
        if cur != self.journal.fleet():
            self.journal.record_fleet(cur)

    def _fleet_entries(self) -> List[Dict]:
        out = []
        for r in self.sup.replicas:
            out.append({"idx": r.idx,
                        "pid": (r.proc.pid if r.proc is not None
                                else None),
                        "port": r.port, "role": r.role})
        return out

    # -- shared action plumbing --------------------------------------------

    def _chaos_hold(self) -> None:
        """Deterministic SIGKILL window for the chaos harness: sleep
        inside the journaled-but-uncommitted span of every action.
        Zero-cost when PT_AUTOSCALE_HOLD_S is unset."""
        try:
            hold = float(os.environ.get("PT_AUTOSCALE_HOLD_S") or 0)
        except ValueError:
            hold = 0.0
        if hold > 0:
            time.sleep(hold)

    def _record(self, action: str, reason: str, ok: bool,
                **fields) -> Dict:
        with self._state_lock:
            key = (action, reason)
            self.actions_total[key] = self.actions_total.get(key,
                                                             0) + 1
            out = {"action": action, "reason": reason, "ok": ok,
                   "t_unix": time.time()}
            out.update(fields)
            self.last_action = out
        # bundle only actions that actually STARTED (journaled):
        # refusals are counters, not postmortems — an at_max refusal
        # re-fires every tick under sustained pressure and would
        # churn the flight ring's budget for nothing
        if self.flight is not None and action in ("spawn", "drain",
                                                  "rerole", "roll") \
                and not reason.startswith("refused_"):
            self.flight.record("autoscale", lambda: {
                "action": dict(out),
                "fleet": self._fleet_entries(),
                "journal_tail": self.journal.tail(16),
                "autoscaler": self.status()})
        return dict(out)

    def _refuse(self, action: str, why: str) -> Dict:
        return self._record(action, f"refused_{why}", ok=False)

    def _cooldown_left(self, direction: str, now: float) -> float:
        if direction == "up":
            last, cd = self._last_up_t, self.cfg.cooldown_up_s
        else:
            last, cd = self._last_down_t, self.cfg.cooldown_down_s
        if last is None:
            return 0.0
        return max(0.0, last + cd - now)

    def _wait_replica_ready(self, rep, timeout_s: float) -> bool:
        from .supervisor import _rpc
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._stop.is_set():
            if not rep.alive():
                return False
            try:
                h = _rpc(self.sup.host, rep.port, {"op": "health"},
                         timeout_s=self.sup.probe_timeout_s)
                if "status" in h:
                    return True
            except Exception:
                pass
            time.sleep(0.25)
        return False

    # -- actions -----------------------------------------------------------

    def scale_up(self, reason: str = "pressure",
                 role: str = "mixed", force: bool = False) -> Dict:
        """Journal begin → spawn → wait ready → commit → attach. A
        spawn that never goes ready is killed, rolled back, and still
        charged against the up-cooldown (a crash-looping image must
        not be retried at full rate)."""
        if role not in _ROLES:
            return self._refuse("spawn", f"bad_role_{role}")
        with self._action_lock:
            now = time.monotonic()
            if len(self.sup.replicas) >= self.cfg.max_replicas:
                return self._refuse("spawn", "at_max")
            if not force and self._cooldown_left("up", now) > 0:
                return self._refuse("spawn", "cooldown")
            rep = self.sup.add_replica(role=role, spawn=False)
            seq = self.journal.begin("spawn", replica=rep.idx,
                                     role=role, reason=reason)
            self.sup._spawn(rep)
            self.journal.update(seq, phase="launched",
                                pid=rep.proc.pid, port=rep.port)
            self._chaos_hold()
            ok = self._wait_replica_ready(
                rep, self.cfg.spawn_ready_timeout_s)
            self._last_up_t = now  # charged even on failure
            if not ok:
                try:
                    rep.proc.kill()
                    rep.proc.wait(timeout=10.0)
                except Exception:
                    pass
                rep.close_log()
                self.journal.rollback(seq, reason="never_ready")
                return self._record("spawn", "never_ready", ok=False,
                                    replica=rep.idx)
            # the autoscaler probes its pending
            # spawn itself — without this reset a replica that
            # flapped before re-roling/adoption would carry max
            # backoff into its next legitimate respawn
            rep.reset_backoff()
            rep.ready = True
            self.journal.commit(seq)
            self.sup.attach_replica(rep)
            self.journal.record_fleet(self._fleet_entries())
            return self._record("spawn", reason, ok=True,
                                replica=rep.idx, port=rep.port,
                                seq=seq)

    def _pick_victim(self):
        """Least-loaded ready replica whose removal the scale-down
        guard allows (ties: highest idx — the newest one goes
        first)."""
        cands = []
        for r in self.sup.replicas:
            if getattr(r, "draining", False):
                continue
            if self.sup.scale_down_guard(
                    r.idx, min_replicas=self.cfg.min_replicas):
                continue
            cands.append(r)
        if not cands:
            return None
        return min(cands, key=lambda r: (getattr(r, "load", 0),
                                         -r.idx))

    def scale_down(self, reason: str = "pressure",
                   force: bool = False) -> Dict:
        """Guard → journal begin → drain (handoff, degrading to
        plain drain on failure) → kill → commit → detach. The
        replica set the router reads shrinks only after the commit
        (the draining flag already keeps new traffic off the
        victim)."""
        with self._action_lock:
            now = time.monotonic()
            if not force and self._cooldown_left("down", now) > 0:
                return self._refuse("drain", "cooldown")
            victim = self._pick_victim()
            if victim is None:
                return self._refuse("drain", "no_eligible_victim")
            seq = self.journal.begin(
                "drain", replica=victim.idx,
                pid=(victim.proc.pid if victim.proc else None),
                port=victim.port, role=victim.role, reason=reason)
            victim.draining = True
            self._chaos_hold()
            out = self._finish_drain(victim, seq, reason=reason)
            self._last_down_t = now
            return out

    def _finish_drain(self, victim, seq: int, reason: str) -> Dict:
        """The drain+kill+commit half — shared by fresh scale-downs
        and recovery resumes (drain is idempotent on the server:
        stop admitting, finish in-flight, return pages)."""
        victim.draining = True
        drain = self.sup.drain_replica(
            victim.idx, handoff=True,
            timeout_s=self.cfg.drain_timeout_s)
        if victim.proc is not None:
            try:
                victim.proc.terminate()
                victim.proc.wait(timeout=10.0)
            except Exception:
                try:
                    victim.proc.kill()
                    victim.proc.wait(timeout=10.0)
                except Exception:
                    pass
        victim.close_log()
        self.journal.commit(seq, drained=bool(drain.get("drained")),
                            handoff_failures=len(
                                (drain.get("handoff") or {})
                                .get("failures", ())))
        self.sup.remove_replica(victim)
        self.journal.record_fleet(self._fleet_entries())
        return self._record("drain", reason, ok=True,
                            replica=victim.idx, seq=seq,
                            drained=bool(drain.get("drained")))

    def rerole(self, idx: int, to_role: str,
               reason: str = "shape", force: bool = False) -> Dict:
        """Fleet-shape move: drain + restart ONE replica with a new
        ``--role`` instead of cold-spawning (its process slot, log
        and idx survive; its KV chains are handed to survivors
        first). Failure to come back ready degrades typed: the
        journal rolls back, the replica reverts to its old role and
        the monitor's respawn/backoff path owns recovery."""
        if to_role not in _ROLES:
            return self._refuse("rerole", f"bad_role_{to_role}")
        with self._action_lock:
            now = time.monotonic()
            if not force and self._cooldown_left("down", now) > 0:
                return self._refuse("rerole", "cooldown")
            try:
                rep = self.sup._by_idx(idx)
            except KeyError:
                return self._refuse("rerole", "no_such_replica")
            if rep.role == to_role:
                return self._refuse("rerole", "already_that_role")
            if self.sup.scale_down_guard(
                    idx, min_replicas=self.cfg.min_replicas):
                return self._refuse("rerole", "guard")
            seq = self.journal.begin(
                "rerole", replica=rep.idx,
                pid=(rep.proc.pid if rep.proc else None),
                port=rep.port, role_from=rep.role, role_to=to_role,
                reason=reason)
            rep.draining = True
            self._chaos_hold()
            out = self._finish_rerole(rep, to_role, seq,
                                      reason=reason)
            self._last_down_t = now
            return out

    def _finish_rerole(self, rep, to_role: str, seq: int,
                       reason: str) -> Dict:
        rep.draining = True
        old_role = rep.role
        self.sup.drain_replica(rep.idx, handoff=True,
                               timeout_s=self.cfg.drain_timeout_s)
        if rep.proc is not None:
            try:
                rep.proc.terminate()
                rep.proc.wait(timeout=10.0)
            except Exception:
                try:
                    rep.proc.kill()
                    rep.proc.wait(timeout=10.0)
                except Exception:
                    pass
        rep.role = to_role
        self.sup._spawn(rep)
        self.journal.update(seq, phase="launched", pid=rep.proc.pid,
                            port=rep.port)
        ok = self._wait_replica_ready(rep,
                                      self.cfg.spawn_ready_timeout_s)
        if not ok:
            try:
                rep.proc.kill()
            except Exception:
                pass
            rep.role = old_role
            rep.draining = False
            self.sup._mark_dead(rep)  # monitor respawns, old role
            self.journal.rollback(seq, reason="rerole_never_ready")
            return self._record("rerole", "rerole_never_ready",
                                ok=False, replica=rep.idx)
        rep.reset_backoff()
        rep.ready = True
        rep.draining = False
        self.journal.commit(seq)
        self.journal.record_fleet(self._fleet_entries())
        return self._record("rerole", reason, ok=True,
                            replica=rep.idx, role=to_role, seq=seq)

    # -- fleet shape (the prefill:decode ratio rule, executable) -----------

    def plan_shape(self) -> Optional[Dict]:
        """On a disaggregated fleet, compare the prefill-replica
        count against ``desired_prefill`` with the signal bias:
        handoff prefill failures climbing (scraped off the router)
        push the prefill side up; fleet TPOT attainment below
        ``tpot_attain_low`` pushes the decode side up. Returns a
        rerole proposal or None. Mixed replicas are the preferred
        conversion stock; with none left, the over-represented class
        donates."""
        reps = [r for r in self.sup.replicas
                if not getattr(r, "draining", False)]
        if len(reps) < 2 or all(r.role == "mixed" for r in reps):
            return None
        bias = 0
        router = getattr(self.sup, "router", None)
        if router is not None:
            fails = getattr(router,
                            "handoff_prefill_failures_total", 0)
            if fails > self._handoff_fail_seen:
                self._handoff_fail_seen = fails
                bias += 1
        tpot = self._tpot_attainment()
        if tpot is not None and tpot < self.cfg.tpot_attain_low:
            bias -= 1
        want = desired_prefill(len(reps),
                               self.cfg.decode_per_prefill, bias)
        n_prefill = sum(1 for r in reps if r.role == "prefill")
        if n_prefill < want:
            donor = next((r for r in reps if r.role == "mixed"),
                         None) or next(
                (r for r in reps if r.role == "decode"), None)
            if donor is not None and not self.sup.scale_down_guard(
                    donor.idx, min_replicas=self.cfg.min_replicas):
                return {"replica": donor.idx, "role": "prefill",
                        "reason": "shape_prefill_up"}
        elif n_prefill > want:
            donor = next((r for r in reps if r.role == "prefill"),
                         None)
            if donor is not None and not self.sup.scale_down_guard(
                    donor.idx, min_replicas=self.cfg.min_replicas):
                return {"replica": donor.idx, "role": "decode",
                        "reason": "shape_decode_up"}
        return None

    def _tpot_attainment(self) -> Optional[float]:
        fleet = getattr(self.sup, "fleet", None)
        if fleet is None:
            return None
        try:
            snap = fleet.fleet_snapshot()
            classes = (snap.get("slo") or {}).get("classes") or {}
            met = total = 0
            for c in classes.values():
                met += int(c.get("tpot_met") or 0)
                total += int(c.get("total") or 0)
            return (met / total) if total else None
        except Exception:
            return None

    # -- surfaces ----------------------------------------------------------

    def status(self) -> Dict:
        now = time.monotonic()
        with self._state_lock:
            by_role: Dict[str, int] = {}
            for r in self.sup.replicas:
                by_role[r.role] = by_role.get(r.role, 0) + 1
            return {
                "enabled": True,
                "min_replicas": self.cfg.min_replicas,
                "max_replicas": self.cfg.max_replicas,
                "replicas": len(self.sup.replicas),
                "replicas_by_role": by_role,
                "cooldown_up_s": self.cfg.cooldown_up_s,
                "cooldown_down_s": self.cfg.cooldown_down_s,
                "cooldown_up_remaining_s": round(
                    self._cooldown_left("up", now), 3),
                "cooldown_down_remaining_s": round(
                    self._cooldown_left("down", now), 3),
                "action_in_flight": self._action_lock.locked(),
                "last_action": (dict(self.last_action)
                                if self.last_action else None),
                "actions_total": {f"{a}|{r}": n for (a, r), n
                                  in sorted(
                                      self.actions_total.items())},
                "pending_resumes": len(self._pending_resumes),
                "journal": {"path": self.journal.path,
                            "seq": self.journal.seq,
                            "writes_total":
                                self.journal.writes_total,
                            "write_failures_total":
                                self.journal.write_failures_total},
                "recovery": self.recovery,
            }

    def prometheus_lines(self) -> List[str]:
        """The autoscaler's metric families, appended to the router's
        ``fleet_metrics`` exposition."""
        with self._state_lock:
            totals = dict(self.actions_total)
        lines = ["# TYPE serving_autoscale_actions_total counter"]
        for (action, reason), n in sorted(totals.items()):
            lines.append(
                f'serving_autoscale_actions_total{{'
                f'action="{action}",reason="{reason}"}} {n}')
        lines.append("# TYPE serving_fleet_replicas gauge")
        by_role: Dict[str, int] = {}
        for r in self.sup.replicas:
            by_role[r.role] = by_role.get(r.role, 0) + 1
        for role in _ROLES:
            lines.append(f'serving_fleet_replicas{{role="{role}"}} '
                         f"{by_role.get(role, 0)}")
        return lines
