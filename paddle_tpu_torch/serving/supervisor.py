"""Replica supervision and failover routing (port of
``paddle_tpu/serving/supervisor.py``).

One `ServingServer` process is one fault domain: engine resurrection
(server.py) survives anything below the socket, but a SIGKILL, an OOM
or a wedged interpreter takes the whole replica with it. This module is
the layer above: a `Supervisor` that spawns N server processes
(``python -m paddle_tpu_torch.serving.server``, on the card unless the
``server_args`` name ``--device cpu``), health-probes them over the
wire, restarts crashed replicas with exponential backoff, and a
`FailoverRouter` that fronts them on one port: a request whose replica
dies mid-flight is resubmitted to a live replica when it is idempotent
(carries a ``key``), so the client sees a pause instead of a torn
connection.

Idempotency: greedy decoding is deterministic, so resubmitting a keyed
request derives the tokens the dead replica would have produced. The
router counts the token messages it already relayed and suppresses that
many from the resubmitted stream. Unkeyed requests get a typed
retryable ``ReplicaFailed`` instead.

Routing: keyed requests are steered for cache affinity (the prompt's
first-block chain key against each replica's advertised ``prefix_keys``,
else a rendezvous hash over the live set); with prefill-class and
decode-capable replicas live, a keyed request routes prefill-first: a
``prefill_only`` job on the rendezvous-stable prefill replica, then the
decode forward with a ``fetch_from`` hint naming it, and the decode
replica pulls the chain over ``fetch_pages`` instead of prefilling. Any
peer advertising a chain can serve it the same way (the fleet cache).
Every handoff failure degrades to a local prefill with the same tokens.

Fleet telemetry (serving/fleet_metrics.py): each healthy probe cycle
also scrapes the replica's structured metrics export and its capacity
card; the router's ``fleet_stats``, ``fleet_metrics`` and
``fleet_capacity`` ops publish the merged view with the probe-failure
taxonomy. ``roll_fleet`` hot-swaps the fleet replica by replica onto a
new checkpoint behind the router, with a canary window and automatic
rollback.

Autoscaling (serving/autoscaler.py): ``--autoscale`` attaches an
`Autoscaler` that spawns, drains and re-roles replicas inside a
min/max envelope and journals every action, and every swap of a roll,
to a crc-checked fleet journal before it acts. ``_spawn`` stamps each
replica's env with the journal's path and the replica's index, so a
supervisor restarted on the same ``--journal`` adopts the replicas its
predecessor left running instead of spawning second copies. The
router's ``autoscale`` op forces an action or reads the status. The
supervisor process never touches the card: only its replicas hold a
CUDA context there.

Not ported: ``--mesh`` (a tensor-parallel mesh per replica).

Fault sites (distributed/fault_inject.py): ``net.recv`` fires in the
router's backend reader: an armed schedule makes the router treat the
backend as dead and exercise the failover path.

Run it::

    python -m paddle_tpu_torch.serving.supervisor --model gpt_1p3b \
        --replicas 2 --roles prefill,decode --port 8770
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Replica", "Supervisor", "FailoverRouter",
           "classify_probe_failure", "handoff_chains",
           "rendezvous_owner"]


def _free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rpc(host: str, port: int, payload: Dict, timeout_s: float) -> Dict:
    """One request/one reply over a fresh connection (health probes,
    admin ops). Raises OSError family on a dead backend."""
    with socket.create_connection((host, port),
                                  timeout=timeout_s) as s:
        f = s.makefile("rw", encoding="utf-8")
        f.write(json.dumps(payload) + "\n")
        f.flush()
        line = f.readline()
        if not line:
            raise ConnectionError("backend closed without replying")
        return json.loads(line)


def classify_probe_failure(exc: Optional[BaseException]) -> str:
    """Probe-failure taxonomy (r17): map a probe exception (None = the
    reply arrived but was malformed) onto a stable kind. The monitor
    loop keeps per-replica counts per kind — a replica that TIMES OUT
    (wedged/overloaded) and one REFUSING connections (dead port) and
    one answering GARBAGE (torn/buggy) are different incidents."""
    if exc is None:
        return "malformed"
    if isinstance(exc, socket.timeout):
        return "timeout"
    if isinstance(exc, ConnectionRefusedError):
        return "refused"
    if isinstance(exc, ConnectionResetError):
        return "reset"
    if isinstance(exc, json.JSONDecodeError):
        return "torn_json"
    if isinstance(exc, ConnectionError):
        return "closed"
    if isinstance(exc, OSError):
        return "os_error"
    return "error"


class Replica:
    """One supervised server process."""

    def __init__(self, idx: int, host: str):
        self.idx = idx
        self.host = host
        self.port: Optional[int] = None
        self.proc: Optional[subprocess.Popen] = None
        self.ready = False
        self.restarts = 0           # respawns after a death
        self.consec_deaths = 0      # resets on a healthy probe
        self.probe_failures = 0
        # probe-failure taxonomy (r17): a bare "ok = False" collapsed
        # timeout/refused/malformed into one signal — these keep the
        # per-kind lifetime counts + the most recent classified error,
        # exported through fleet_stats (a replica that times out under
        # load and one that answers garbage need different operators)
        self.probe_failures_by_kind: Dict[str, int] = {}
        self.last_probe_error: Optional[str] = None
        self.next_spawn_t: Optional[float] = None  # backoff gate
        self.spawn_t: Optional[float] = None       # warmup clock
        self.log_path: Optional[str] = None
        self._log_file = None
        # cache-affinity advertisement (r15): refreshed from every
        # healthy probe — the chain-head prefix keys this replica's
        # cache can serve, its page size (the router needs it to hash
        # a prompt's first block), and its current load (the
        # least-loaded fallback's input)
        self.prefix_keys: frozenset = frozenset()
        self.page_size: Optional[int] = None
        self.load: int = 0
        # disaggregated serving (r20): the replica's class (refreshed
        # from health; the supervisor seeds it from its roles list so
        # routing is correct from the first probe) and whether its
        # prefix-key advertisement was recency-capped — a truncated
        # list means "not advertised" is NOT "not resident"
        self.role: str = "mixed"
        self.prefix_truncated: bool = False
        # memory observatory (r18): the replica's latest capacity-op
        # reply (occupancy by owner class + exhaustion forecast),
        # refreshed each healthy probe cycle — fleet_capacity merges
        # the fresh ones
        self.capacity: Optional[Dict] = None
        self.capacity_t: float = 0.0
        # autoscaling (r21): a draining victim is mid-scale-down or
        # mid-rerole — the monitor must not respawn its deliberate
        # kill and the router must not route to it
        self.draining = False
        # weight hot-swap (r24): the replica's serving weight
        # generation, refreshed from every healthy probe — roll_fleet
        # reads it to skip already-converged replicas, fleet_stats
        # rolls it up so a mixed-generation fleet is visible
        self.weight_generation: int = 0

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def reset_backoff(self) -> None:
        """A healthy probe clears the crash-loop state. One definition
        for every probe path (monitor loop, autoscaler ready-checks):
        before r21 only the monitor reset, so a replica that flapped
        during a scale storm carried max backoff into its next
        legitimate respawn."""
        self.consec_deaths = 0
        self.probe_failures = 0
        self.next_spawn_t = None

    def close_log(self) -> None:
        if self._log_file is not None:
            try:
                self._log_file.close()
            except OSError:
                pass
            self._log_file = None


class Supervisor:
    """Spawn, probe, and resurrect N serving replicas.

    ``server_args`` are appended to every replica's command line
    (e.g. ``["--page-size", "8", "--stall-timeout-s", "30"]``);
    ``replica_env`` overlays the inherited environment — chaos runs
    arm PT_FAULT_INJECT there, CPU test runs pin OMP_NUM_THREADS=1.
    A dead replica respawns after ``backoff_base_s * 2**consec_deaths``
    (capped at ``backoff_max_s``) on a FRESH port; a ready replica that
    fails ``max_probe_failures`` consecutive health probes is killed
    and treated as dead (half-alive processes hold no traffic)."""

    def __init__(self, model: str = "gpt_125m", replicas: int = 2,
                 host: str = "127.0.0.1",
                 server_args: Sequence[str] = (),
                 replica_env: Optional[Dict[str, str]] = None,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 5.0,
                 max_probe_failures: int = 3,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 10.0,
                 ready_timeout_s: float = 300.0,
                 log_dir: Optional[str] = None,
                 collect_metrics: bool = True,
                 fleet=None,
                 roles: Optional[Sequence[str]] = None,
                 checkpoint: Optional[str] = None,
                 weight_generation: int = 0):
        self.model = model
        self.host = host
        self.server_args = list(server_args)
        # weight hot-swap (r24): the fleet's COMMITTED weight source —
        # every (re)spawn, monitor respawn and re-role boots from this
        # checkpoint at this generation, so a replica that crashes
        # after a roll comes back on the ROLLED weights, not the boot
        # image. roll_fleet advances both once the canary commits.
        self.checkpoint = checkpoint
        self.weight_generation = int(weight_generation)
        self.replica_env = dict(replica_env or {})
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.max_probe_failures = int(max_probe_failures)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.ready_timeout_s = float(ready_timeout_s)
        # fleet telemetry plane (r17): a healthy probe cycle also
        # scrapes the replica's STRUCTURED metrics export into the
        # collector (ServingMetrics.export() over the wire — never
        # parsed exposition text); collect_metrics=False is the
        # scrape-overhead escape hatch the fleet_goodput bench A/Bs
        self.collect_metrics = bool(collect_metrics)
        if fleet is not None:
            self.fleet = fleet
        elif collect_metrics:
            from .fleet_metrics import FleetMetrics
            self.fleet = FleetMetrics(
                stale_after_s=max(10.0, 4 * float(probe_interval_s)))
        else:
            self.fleet = None
        if log_dir is None:
            self.log_dir = tempfile.mkdtemp(
                prefix="pt-serving-supervisor-")
        else:
            self.log_dir = log_dir
            os.makedirs(log_dir, exist_ok=True)
        self.replicas: List[Replica] = [Replica(i, host)
                                        for i in range(int(replicas))]
        # disaggregated roles (r20): one role per replica ("mixed" /
        # "prefill" / "decode"), threaded to each server as --role and
        # seeded on the Replica records so the router's role-aware
        # dispatch is correct from the first probe. A shorter list
        # pads with "mixed".
        self.roles: List[str] = []
        roles = list(roles or ())
        for i, rep in enumerate(self.replicas):
            role = roles[i] if i < len(roles) else "mixed"
            if role not in ("mixed", "prefill", "decode"):
                raise ValueError(
                    f"replica role must be mixed/prefill/decode; got "
                    f"{role!r} for replica {i}")
            rep.role = role
            self.roles.append(role)
        # `Autoscaler` attaches itself here and sets journal_path so
        # _spawn stamps the env markers recovery scans for; the router
        # back-references itself for the shape planner's handoff
        # failure signal
        self.autoscaler = None
        self.journal_path: Optional[str] = None
        self.router = None
        self._next_idx = int(replicas)
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True) -> None:
        # spawn only the unspawned: after the autoscaler's recovery the
        # list holds adopted replicas (proc set) beside records to
        # respawn (proc None)
        for rep in self.replicas:
            if rep.proc is None:
                self._spawn(rep)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="pt-supervisor-monitor")
        self._monitor.start()
        if wait_ready:
            self.wait_ready()

    def wait_ready(self, min_ready: Optional[int] = None) -> None:
        """Block until ``min_ready`` replicas (default: all) answer a
        health probe; raises with the laggards' log paths on timeout
        (the logs hold the subprocess traceback)."""
        if min_ready is None:
            want = len([r for r in self.replicas if not r.draining])
        else:
            want = min_ready
        deadline = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < deadline:
            if sum(r.ready for r in self.replicas
                   if not r.draining) >= want:
                return
            if self._stop.is_set():
                raise RuntimeError("supervisor stopped while waiting")
            time.sleep(0.1)
        lag = [(r.idx, r.log_path) for r in self.replicas
               if not r.ready]
        raise RuntimeError(
            f"replicas not ready after {self.ready_timeout_s}s: {lag}")

    def stop(self, drain: bool = True, grace_s: float = 10.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=grace_s)
        reps = list(self.replicas)  # autoscaler churn: fixed snapshot
        for rep in reps:
            if rep.alive() and drain:
                try:
                    _rpc(self.host, rep.port, {"op": "drain"},
                         timeout_s=2.0)
                except Exception:
                    pass
        for rep in reps:
            if rep.alive():
                rep.proc.terminate()
        deadline = time.monotonic() + grace_s
        for rep in reps:
            if rep.proc is None:
                continue
            left = max(0.1, deadline - time.monotonic())
            try:
                rep.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rep.proc.wait(timeout=5.0)
            rep.close_log()

    def __enter__(self) -> "Supervisor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- chaos hooks -------------------------------------------------------

    def kill_replica(self, idx: int,
                     sig: int = signal.SIGKILL) -> None:
        """Chaos entry: deliver ``sig`` to one replica process (the
        monitor notices the death and respawns it with backoff)."""
        rep = self._by_idx(idx)
        if rep.alive():
            rep.proc.send_signal(sig)

    def _by_idx(self, idx: int) -> Replica:
        """Replica by its idx FIELD — under autoscaling the list is no
        longer position-indexed (scale-down leaves holes)."""
        for r in self.replicas:
            if r.idx == idx:
                return r
        raise KeyError(f"no replica with idx {idx}")

    # -- autoscaling membership (r21) --------------------------------------

    def add_replica(self, role: str = "mixed",
                    spawn: bool = True) -> Replica:
        """Allocate the next replica record. ``spawn=False`` leaves it
        DETACHED (not in ``self.replicas``): the autoscaler journals
        the intent, spawns, waits ready, and only then attaches — the
        router never routes to a pending spawn."""
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"bad role {role!r}")
        with self._lock:
            rep = Replica(self._next_idx, self.host)
            self._next_idx += 1
        rep.role = role
        if spawn:
            self._spawn(rep)
            self.attach_replica(rep)
        return rep

    def attach_replica(self, rep: Replica) -> None:
        """Publish a replica to the router/monitor (idempotent). The
        list is REBOUND, never mutated in place — readers iterate a
        consistent snapshot without taking the lock."""
        with self._lock:
            if all(r.idx != rep.idx for r in self.replicas):
                self.replicas = self.replicas + [rep]

    def remove_replica(self, rep: Replica) -> None:
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r.idx != rep.idx]
        rep.close_log()
        if self.fleet is not None:
            self.fleet.mark_stale(rep.idx)

    def scale_down_guard(self, idx: int,
                         min_replicas: int = 1) -> Optional[str]:
        """Why removing replica ``idx`` must be REFUSED, or None when
        the removal is safe (satellite fix, r21): an empty survivor
        set, a survivor set below the min-replica envelope, or — on a
        disaggregated fleet — losing the last replica advertising a
        role would strand traffic, so the refusal is typed here
        instead of crashing or stranding downstream."""
        try:
            rep = self._by_idx(idx)
        except KeyError:
            return "no_such_replica"
        survivors = [r for r in self.replicas
                     if r.idx != idx and not r.draining]
        if not survivors:
            return "last_replica"
        if len(survivors) < min_replicas:
            return f"below_min_replicas({min_replicas})"
        if rep.role in ("prefill", "decode") and \
                not any(r.role == rep.role for r in survivors):
            return f"last_{rep.role}_replica"
        return None

    def drain_replica(self, idx: int, handoff: bool = True,
                      timeout_s: float = 30.0,
                      min_replicas: int = 1) -> Dict:
        """Scale-down drain with prefix-affinity-aware handoff (r20,
        the missing ROADMAP 3(a) drain): refresh the victim's
        advertisement, hand its hot chains to the surviving
        decode-capable replicas through the fetch_pages path (each
        survivor pulls its rendezvous share DIRECTLY from the victim),
        then drain the victim — stop admitting, finish in-flight,
        return every page. The victim process is left alive for the
        caller to reap (or the monitor to respawn); handoff failures
        degrade to re-prefill-on-first-use, never block the drain.

        Refuses TYPED (r21 satellite fix) when the guard says removal
        would empty the fleet, drop below ``min_replicas``, or lose
        the last replica of a role — ``{"refused": <reason>}`` instead
        of a crash or a stranded fleet. A victim already mid-drain
        (``rep.draining``) skips the guard: the autoscaler's recovery
        path re-drains an adopted victim whose removal was already
        committed to."""
        rep = self._by_idx(idx)
        if not rep.draining:
            guard = self.scale_down_guard(idx,
                                          min_replicas=min_replicas)
            if guard is not None:
                return {"victim": idx, "refused": guard,
                        "handoff": None, "drained": False}
        report: Dict = {"victim": idx, "handoff": None,
                        "drained": False}
        if handoff and rep.alive():
            heads: List[str] = list(rep.prefix_keys)
            try:
                h = _rpc(self.host, rep.port, {"op": "health"},
                         timeout_s=timeout_s)
                heads = list(h.get("prefix_keys") or heads)
            except Exception:
                pass  # stale advertisement is still worth handing off
            survivors = [r for r in self.live()
                         if r.idx != idx and r.role != "prefill"]
            if heads and survivors:
                report["handoff"] = handoff_chains(
                    self.host, rep.port, heads, survivors,
                    timeout_s=timeout_s)
        try:
            _rpc(self.host, rep.port, {"op": "drain"},
                 timeout_s=timeout_s)
            report["drained"] = True
        except Exception as e:
            report["drain_error"] = f"{type(e).__name__}: {e}"
        return report

    # -- rolling weight upgrade (r24) --------------------------------------

    def _probe_generation(self, rep: Replica) -> Optional[int]:
        """The replica's CURRENT weight generation, probed live (the
        scraped ``rep.weight_generation`` can lag a probe cycle).
        None on a dead/unreachable replica."""
        try:
            h = _rpc(self.host, rep.port, {"op": "health"},
                     timeout_s=self.probe_timeout_s)
            g = h.get("weight_generation")
            if isinstance(g, int) and not isinstance(g, bool):
                return g
        except Exception:
            pass
        return None

    def _fleet_attainment(self) -> Optional[float]:
        """Merged fleet SLO attainment (r17 monitor) as one fraction —
        the canary window's regression baseline. None when the fleet
        plane is off or no SLO targets are armed."""
        if self.fleet is None:
            return None
        try:
            snap = self.fleet.fleet_snapshot()
            classes = (snap.get("slo") or {}).get("classes") or {}
            met = total = 0
            for c in classes.values():
                met += (int(c.get("ttft_met") or 0)
                        + int(c.get("tpot_met") or 0))
                total += 2 * int(c.get("total") or 0)
            return (met / total) if total else None
        except Exception:
            return None

    def _watch_canary(self, canary: Replica, window_s: float,
                      baseline: Optional[float], slo_regress: float,
                      canary_check=None) -> Optional[str]:
        """Observe the first swapped replica for ``window_s`` before
        the roll proceeds. Returns a typed regression reason (the
        auto-rollback trigger) or None:

        - the canary dying or failing 3 consecutive probes (an
          EngineFailed-class failure);
        - the r17 outlier detector flagging it (erroring / slow vs
          the fleet median — the error-rate signal);
        - fleet SLO attainment dropping more than ``slo_regress``
          below the pre-roll baseline;
        - a truthy string from an injected ``canary_check()`` (the
          operator/test hook), checked every probe interval."""
        if window_s <= 0:
            return None
        deadline = time.monotonic() + window_s
        bad_probes = 0
        while time.monotonic() < deadline:
            if not canary.alive():
                return "canary_died"
            try:
                h = _rpc(self.host, canary.port, {"op": "health"},
                         timeout_s=self.probe_timeout_s)
                bad_probes = 0 if "status" in h else bad_probes + 1
            except Exception:
                bad_probes += 1
            if bad_probes >= 3:
                return "canary_unhealthy"
            if self.fleet is not None:
                try:
                    if canary.idx in set(self.fleet.outliers()):
                        return "canary_outlier"
                except Exception:
                    pass
            att = self._fleet_attainment()
            if baseline is not None and att is not None \
                    and baseline - att > slo_regress:
                return "slo_regression"
            if canary_check is not None:
                why = canary_check()
                if why:
                    return str(why)
            time.sleep(min(self.probe_interval_s,
                           max(0.05, deadline - time.monotonic())))
        return None

    def _swap_replica(self, rep: Replica, checkpoint: str,
                      generation: int, timeout_s: float,
                      rollback: bool = False) -> Optional[str]:
        """One replica's hot swap over the wire; returns a typed error
        string or None on a verified success (the replica answers its
        health probe AT the target generation)."""
        payload = {"op": "swap", "checkpoint": checkpoint,
                   "generation": generation, "timeout_s": timeout_s}
        if rollback:
            payload["rollback"] = True
        try:
            reply = _rpc(self.host, rep.port, payload,
                         timeout_s=timeout_s + 30.0)
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        if reply.get("error"):
            return f"{reply['error']}: {reply.get('reason')}"
        deadline = time.monotonic() + max(10.0,
                                          2 * self.probe_timeout_s)
        while time.monotonic() < deadline:
            if self._probe_generation(rep) == generation:
                rep.weight_generation = generation
                # satellite fix (r24): a verified swap is proof of
                # life — clear any crash-loop backoff the replica
                # accumulated before the roll
                rep.reset_backoff()
                return None
            time.sleep(0.1)
        return "swap_unverified: health never showed the target " \
               "generation"

    def _respawn_with_config(self, rep: Replica,
                             timeout_s: float = 60.0) -> bool:
        """Forward-convergence fallback: kill + respawn ``rep`` from
        the COMMITTED fleet config (self.checkpoint at
        self.weight_generation) and wait for a healthy probe. False
        hands the replica to the monitor's backoff/respawn path —
        which also spawns from the committed config, so the fleet
        still converges."""
        if rep.proc is not None:
            try:
                rep.proc.kill()
                rep.proc.wait(timeout=10.0)
            except Exception:
                pass
        rep.restarts += 1
        self._spawn(rep)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not rep.alive():
                break
            try:
                h = _rpc(self.host, rep.port, {"op": "health"},
                         timeout_s=self.probe_timeout_s)
                if "status" in h:
                    rep.ready = True
                    rep.reset_backoff()
                    rep.weight_generation = self.weight_generation
                    return True
            except Exception:
                pass
            time.sleep(0.25)
        self._mark_dead(rep)
        return False

    def _handoff_before_swap(self, rep: Replica,
                             timeout_s: float) -> Optional[Dict]:
        """Hand the victim's hot chains to survivors before its swap
        invalidates them (the generation bump clears its cache). Same
        degradation contract as the r20 drain handoff: failures mean
        re-prefill-on-first-use, never a blocked roll."""
        heads: List[str] = list(rep.prefix_keys)
        try:
            h = _rpc(self.host, rep.port, {"op": "health"},
                     timeout_s=timeout_s)
            heads = list(h.get("prefix_keys") or heads)
        except Exception:
            pass
        survivors = [r for r in self.live()
                     if r.idx != rep.idx and r.role != "prefill"]
        if not heads or not survivors:
            return None
        return handoff_chains(self.host, rep.port, heads, survivors,
                              timeout_s=timeout_s)

    def _rollback_generation(self, checkpoint: Optional[str],
                             generation: int, journal,
                             reason: str,
                             swap_timeout_s: float = 120.0) -> List:
        """Converge every live replica back to ``generation`` (the
        canary's automatic rollback, and recovery's convergence of an
        unconfirmed roll). Each swap back is a journaled roll action
        marked ``rollback`` when ``journal`` is given. A replica that
        refuses the swap (or a fleet with no old checkpoint to reload)
        is respawned from the committed config instead: the fleet never
        stays mixed."""
        out = []
        for rep in sorted(self.live(), key=lambda r: r.idx):
            cur = self._probe_generation(rep)
            if cur == generation:
                continue
            seq = None
            if journal is not None:
                seq = journal.begin(
                    "roll", replica=rep.idx, checkpoint=checkpoint,
                    generation_from=(cur if cur is not None
                                     else rep.weight_generation),
                    generation_to=generation, rollback=True,
                    pid=(rep.proc.pid if rep.proc else None),
                    port=rep.port, role=rep.role, reason=reason)
            err = ("no rollback checkpoint"
                   if not checkpoint else
                   self._swap_replica(rep, checkpoint, generation,
                                      swap_timeout_s, rollback=True))
            if err is None:
                if journal is not None:
                    journal.update(seq, phase="swapped", swapped=True)
                    journal.commit(seq)
                out.append({"replica": rep.idx, "how": "swap"})
            else:
                ok = self._respawn_with_config(rep)
                if journal is not None:
                    if ok:
                        journal.commit(seq, respawned=True)
                    else:
                        journal.rollback(
                            seq, reason="rollback_respawn_pending")
                out.append({"replica": rep.idx,
                            "how": "respawn" if ok else "pending",
                            "swap_error": err})
        return out

    def roll_fleet(self, checkpoint: str,
                   generation: Optional[int] = None,
                   canary_window_s: float = 0.0,
                   slo_regress: float = 0.1,
                   canary_check=None,
                   handoff: bool = True,
                   swap_timeout_s: float = 120.0,
                   reason: str = "roll") -> Dict:
        """Rolling weight upgrade (r24 tentpole): converge the fleet,
        replica by replica behind the router, onto ``checkpoint`` at
        the next (or given) weight generation — hot-swapping live
        engines, never dropping a request (the server-side swap holds
        admission while active slots drain; queued work waits).

        Per replica: journal a ``roll`` action (begin, swapped, commit:
        the crash-recovery record) when an autoscaler is attached, hand
        its hot chains to survivors, send the swap op, verify the
        health probe reports the target generation. The first swapped
        replica is the canary: it is watched for ``canary_window_s``
        against the pre-roll SLO baseline, the outlier detector and
        ``canary_check`` before the rest follow; a regression swaps
        everything back to the previous generation (journaled, counted,
        flight-recorded) and the roll reports the typed reason. A roll
        that commits records its checkpoint and generation as the
        journal's committed config.

        Failure containment: a canary whose swap fails TYPED (corrupt
        checkpoint, validation refusal) aborts the roll with zero
        replicas changed — old weights keep serving fleet-wide. A
        mid-roll swap failure AFTER the canary proved the checkpoint
        converges forward by respawning the replica from the new
        committed config instead. The committed config
        (self.checkpoint / self.weight_generation) advances when the
        canary commits, so monitor respawns during the roll come up
        on the NEW weights."""
        targets = sorted(self.live(), key=lambda r: r.idx)
        if not targets:
            return {"ok": False, "refused": "no_live_replica"}
        old_ckpt, old_gen = self.checkpoint, self.weight_generation
        gen_to = (int(generation) if generation is not None
                  else old_gen + 1)
        asc = self.autoscaler
        journal = getattr(asc, "journal", None)
        baseline = self._fleet_attainment()
        report: Dict = {"ok": False, "checkpoint": checkpoint,
                        "generation_from": old_gen,
                        "generation": gen_to, "canary": None,
                        "swapped": [], "skipped": [],
                        "respawned": [], "rolled_back": [],
                        "regression": None}
        canary_done = False
        for rep in targets:
            cur = self._probe_generation(rep)
            if cur == gen_to:
                # resume idempotency: a replica already converged (a
                # crash-recovered half-roll) is skipped, not re-rolled
                report["skipped"].append(rep.idx)
                canary_done = True
                continue
            seq = None
            if journal is not None:
                seq = journal.begin(
                    "roll", replica=rep.idx, checkpoint=checkpoint,
                    generation_from=(cur if cur is not None
                                     else rep.weight_generation),
                    generation_to=gen_to,
                    pid=(rep.proc.pid if rep.proc else None),
                    port=rep.port, role=rep.role, reason=reason)
            if handoff:
                report.setdefault("handoff", {})[str(rep.idx)] = \
                    self._handoff_before_swap(rep, swap_timeout_s)
            if asc is not None:
                asc._chaos_hold()
            err = self._swap_replica(rep, checkpoint, gen_to,
                                     swap_timeout_s)
            if err is not None:
                if not canary_done:
                    # canary refusal: NOTHING changed — the corrupt/
                    # mismatched checkpoint never reaches a second
                    # replica and old weights keep serving everywhere
                    if journal is not None:
                        journal.rollback(seq,
                                         reason="canary_swap_failed")
                    report["failed"] = {"replica": rep.idx,
                                        "error": err}
                    report["refused"] = "canary_swap_failed"
                    if asc is not None:
                        asc._record("roll", "canary_swap_failed",
                                    ok=False, replica=rep.idx,
                                    generation=gen_to, seq=seq)
                    return report
                # the canary proved the checkpoint: converge forward
                ok = self._respawn_with_config(rep)
                if journal is not None:
                    if ok:
                        journal.update(seq, phase="swapped",
                                       swapped=True, respawned=True)
                        journal.commit(seq)
                    else:
                        journal.rollback(
                            seq, reason="roll_respawn_pending")
                report["respawned"].append(
                    {"replica": rep.idx, "swap_error": err,
                     "ready": ok})
                continue
            if journal is not None:
                journal.update(seq, phase="swapped", swapped=True)
                journal.commit(seq)
            report["swapped"].append(rep.idx)
            if not canary_done:
                canary_done = True
                report["canary"] = rep.idx
                # commit the new config NOW: respawns during the rest
                # of the roll must come up on the proven new weights
                self.checkpoint = checkpoint
                self.weight_generation = gen_to
                why = self._watch_canary(rep, canary_window_s,
                                         baseline, slo_regress,
                                         canary_check)
                if why is not None:
                    self.checkpoint = old_ckpt
                    self.weight_generation = old_gen
                    report["regression"] = why
                    report["rolled_back"] = \
                        self._rollback_generation(
                            old_ckpt, old_gen, journal,
                            reason=f"canary_{why}",
                            swap_timeout_s=swap_timeout_s)
                    if asc is not None:
                        asc._record("roll", f"canary_rollback_{why}",
                                    ok=False, canary=rep.idx,
                                    generation=gen_to)
                    return report
        self.checkpoint = checkpoint
        self.weight_generation = gen_to
        if journal is not None:
            journal.record_config(checkpoint, gen_to)
        if asc is not None:
            asc._record("roll", reason, ok=True, generation=gen_to,
                        swapped=len(report["swapped"]),
                        skipped=len(report["skipped"]),
                        respawned=len(report["respawned"]))
        report["ok"] = True
        return report

    @property
    def restarts_total(self) -> int:
        return sum(r.restarts for r in self.replicas)

    def live(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.ready and r.alive() and not r.draining]

    # -- internals ---------------------------------------------------------

    def _spawn(self, rep: Replica) -> None:
        rep.port = _free_port(self.host)
        rep.ready = False
        rep.probe_failures = 0
        rep.next_spawn_t = None
        rep.spawn_t = time.monotonic()
        rep.close_log()
        rep.log_path = os.path.join(self.log_dir,
                                    f"replica{rep.idx}.log")
        rep._log_file = open(rep.log_path, "ab")
        # "{replica}" in an arg expands to this replica's index — how
        # per-replica paths (e.g. --spill-dir subdirs) stay disjoint
        # while every replica shares one server_args list
        extra = [a.replace("{replica}", str(rep.idx))
                 if "{replica}" in a else a for a in self.server_args]
        if rep.role != "mixed":
            extra = ["--role", rep.role] + extra
        # weight hot-swap (r24): spawn at the fleet's COMMITTED weight
        # config — a monitor respawn or a --roles re-role restart after
        # a roll boots the rolled checkpoint at the rolled generation
        # instead of regressing to the boot image at generation 0
        if self.weight_generation:
            extra = ["--weight-generation",
                     str(self.weight_generation)] + extra
        if self.checkpoint:
            extra = ["--checkpoint", self.checkpoint] + extra
        cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.server",
               "--model", self.model, "--host", self.host,
               "--port", str(rep.port)] + extra
        env = dict(os.environ)
        env.update(self.replica_env)
        if self.journal_path:
            # the autoscaler's fleet markers: a restarted supervisor's
            # recovery attributes an orphaned server to its fleet by
            # these even when the journal's pid snapshot is stale
            # (monitor respawns change pids without a journal write)
            from .autoscaler import JOURNAL_ENV, REPLICA_IDX_ENV
            env[JOURNAL_ENV] = self.journal_path
            env[REPLICA_IDX_ENV] = str(rep.idx)
        rep.proc = subprocess.Popen(cmd, stdout=rep._log_file,
                                    stderr=subprocess.STDOUT, env=env)

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            # list(): the autoscaler rebinds self.replicas on attach/
            # remove — iterate one consistent snapshot per sweep
            for rep in list(self.replicas):
                if self._stop.is_set():
                    return
                if rep.draining:
                    # deliberate scale-down/rerole victim: its death
                    # is intended — respawning it (or charging
                    # _mark_dead backoff) would fight the actuator
                    continue
                if rep.proc is None or rep.next_spawn_t is not None:
                    # awaiting backoffed respawn
                    if rep.next_spawn_t is not None and \
                            time.monotonic() >= rep.next_spawn_t:
                        rep.restarts += 1
                        self._spawn(rep)
                    continue
                if not rep.alive():
                    self._mark_dead(rep)
                    continue
                probe_exc: Optional[BaseException] = None
                try:
                    h = _rpc(self.host, rep.port, {"op": "health"},
                             timeout_s=self.probe_timeout_s)
                    ok = "status" in h
                except Exception as e:
                    ok = False
                    probe_exc = e
                if ok:
                    rep.ready = True
                    rep.reset_backoff()
                    self._scrape_metrics(rep)
                    self._scrape_capacity(rep)
                    # cache-affinity advertisement (r15): best-effort —
                    # an old server build without these fields just
                    # leaves the replica unadvertised (RR/least-loaded
                    # routing still applies)
                    try:
                        rep.prefix_keys = frozenset(
                            h.get("prefix_keys") or ())
                        rep.prefix_truncated = bool(
                            h.get("prefix_keys_truncated"))
                        role = h.get("role")
                        if role in ("mixed", "prefill", "decode"):
                            rep.role = role
                        ps = h.get("page_size")
                        rep.page_size = int(ps) if ps else None
                        rep.load = (int(h.get("active") or 0)
                                    + int(h.get("queued") or 0))
                        g = h.get("weight_generation")
                        if isinstance(g, int) and \
                                not isinstance(g, bool):
                            rep.weight_generation = g
                    except (TypeError, ValueError):
                        pass
                else:
                    rep.probe_failures += 1
                    # taxonomy (r17): timeout / refused / malformed /
                    # torn are different incidents; count them apart
                    kind = classify_probe_failure(probe_exc)
                    rep.probe_failures_by_kind[kind] = \
                        rep.probe_failures_by_kind.get(kind, 0) + 1
                    rep.last_probe_error = (
                        kind if probe_exc is None else
                        f"{kind}: {type(probe_exc).__name__}: "
                        f"{probe_exc}")
                    stuck_warmup = (
                        not rep.ready and rep.spawn_t is not None
                        and time.monotonic() - rep.spawn_t
                        > self.ready_timeout_s)
                    if (rep.ready and
                            rep.probe_failures
                            >= self.max_probe_failures) or stuck_warmup:
                        # half-alive (was ready, socket went
                        # unresponsive) OR wedged during startup (alive
                        # but never answered a probe within
                        # ready_timeout_s — e.g. a hung compile). Both
                        # are permanent capacity loss unless the
                        # supervisor reclaims them: kill and let the
                        # respawn path own recovery
                        try:
                            rep.proc.kill()
                        except OSError:
                            pass
                        self._mark_dead(rep)
            self._stop.wait(timeout=self.probe_interval_s)

    def _scrape_metrics(self, rep: Replica) -> None:
        """Collector half of the probe cycle (r17): pull the replica's
        structured metrics export into the fleet plane. A scrape that
        fails mid-cycle (replica died between probe and scrape, torn
        reply) marks the replica STALE — its last export is kept for
        postmortems but dropped from fleet rollups, so a dying replica
        can never poison fleet totals."""
        if self.fleet is None or not self.collect_metrics:
            return
        try:
            reply = _rpc(self.host, rep.port, {"op": "export"},
                         timeout_s=self.probe_timeout_s)
            export = reply.get("export")
            if not isinstance(export, dict):
                raise ValueError("export op returned no export dict")
            self.fleet.ingest(rep.idx, export)
        except Exception:
            self.fleet.mark_stale(rep.idx)

    def _scrape_capacity(self, rep: Replica) -> None:
        """Memory observatory (r18): pull the replica's ``capacity``
        op (occupancy by owner class + exhaustion forecast) each
        healthy probe cycle. Advisory — a failed scrape just leaves
        the last snapshot to age out of ``fleet_capacity`` rollups."""
        if not self.collect_metrics:
            return
        try:
            reply = _rpc(self.host, rep.port, {"op": "capacity"},
                         timeout_s=self.probe_timeout_s)
            if not isinstance(reply.get("num_pages"), int):
                raise ValueError("capacity op returned no pool size")
            rep.capacity = reply
            rep.capacity_t = time.monotonic()
        except Exception:
            pass

    def fleet_capacity(self) -> Dict:
        """The ``fleet_capacity`` payload (r18): per-replica occupancy
        merged into one fleet view — summed owner-class page counts,
        the fleet used-fraction, and the most urgent (minimum)
        time-to-exhaustion forecast across replicas. Stale snapshots
        (older than 4 probe intervals, min 10 s — the collector's
        freshness rule) are reported but excluded from the rollup."""
        now = time.monotonic()
        stale_after = max(10.0, 4 * self.probe_interval_s)
        totals: Dict[str, int] = {}
        num_pages = 0
        fresh = 0
        ttes: List[float] = []
        per: Dict[str, Dict] = {}
        for r in self.replicas:
            cap = r.capacity
            is_fresh = (cap is not None and r.ready
                        and now - r.capacity_t <= stale_after)
            per[str(r.idx)] = {
                "fresh": is_fresh,
                "age_s": (round(now - r.capacity_t, 3)
                          if cap is not None else None),
                "capacity": cap}
            if not is_fresh:
                continue
            fresh += 1
            num_pages += int(cap.get("num_pages") or 0)
            for k, v in (cap.get("occupancy") or {}).items():
                totals[k] = totals.get(k, 0) + int(v)
            tte = (cap.get("forecast") or {}).get("tte_s")
            if isinstance(tte, (int, float)):
                ttes.append(float(tte))
        return {"replicas_fresh": fresh,
                "replicas_known": len(self.replicas),
                "num_pages": num_pages,
                "occupancy": totals,
                "used_fraction": (
                    round(1.0 - totals.get("free", 0) / num_pages, 4)
                    if num_pages else None),
                # the fleet exhausts when its FIRST replica does: a
                # router can't split one request across pools
                "tte_s": (round(min(ttes), 3) if ttes else None),
                "per_replica": per}

    def fleet_stats(self) -> Dict:
        """The ``fleet_stats`` payload (r17): the collector's merged
        telemetry (bucket-exact fleet histograms, merged SLO window,
        pressure verdict, outlier flags) JOINED with the supervision
        state only this process knows — per-replica probe-failure
        taxonomy, restart counts, and live backoff gates (previously
        computed and exported nowhere)."""
        now = time.monotonic()
        supervision = {}
        for r in self.replicas:
            supervision[str(r.idx)] = {
                "port": r.port, "ready": r.ready, "alive": r.alive(),
                "load": r.load,
                "role": getattr(r, "role", "mixed"),
                "draining": r.draining,
                "weight_generation": getattr(r, "weight_generation",
                                             0),
                "restarts": r.restarts,
                "consec_deaths": r.consec_deaths,
                "probe_failures": r.probe_failures,
                "probe_failures_by_kind":
                    dict(r.probe_failures_by_kind),
                "last_probe_error": r.last_probe_error,
                "backoff_remaining_s": (
                    None if r.next_spawn_t is None
                    else round(max(0.0, r.next_spawn_t - now), 3)),
            }
        out = (self.fleet.fleet_snapshot()
               if self.fleet is not None else
               {"replicas_fresh": 0, "replicas_known": 0,
                "collector": None})
        out["supervision"] = supervision
        out["restarts_total"] = self.restarts_total
        out["collect_metrics"] = self.collect_metrics
        # weight hot-swap (r24): the committed fleet generation plus
        # the set actually OBSERVED on live replicas — more than one
        # entry means a roll is in flight (or went wrong); the chaos
        # harness asserts this converges to exactly one
        out["weight_generation"] = self.weight_generation
        out["weight_generations"] = sorted(
            {getattr(r, "weight_generation", 0)
             for r in self.live()} or {self.weight_generation})
        # the autoscaler's envelope, cooldowns, last action and journal
        # health: fleet_stats is the one op an operator watches
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.status()
        return out

    def _mark_dead(self, rep: Replica) -> None:
        rep.ready = False
        rep.consec_deaths += 1
        backoff = min(self.backoff_max_s,
                      self.backoff_base_s
                      * 2 ** (rep.consec_deaths - 1))
        rep.next_spawn_t = time.monotonic() + backoff
        rep.close_log()
        if self.fleet is not None:
            # drop the dead replica from fleet rollups immediately —
            # not after stale_after_s ages it out
            self.fleet.mark_stale(rep.idx)


def rendezvous_owner(key_hex: str, candidates):
    """Highest-random-weight owner of a chain key among ``candidates``
    (objects with ``.idx``) — the SAME formula the router's affinity
    rendezvous uses, so chains handed off at drain time land exactly
    where future keyed requests will be steered."""
    return max(candidates, key=lambda r: hashlib.blake2b(
        f"{key_hex}:{r.idx}".encode(), digest_size=8).digest())


def handoff_chains(host: str, victim_port: int,
                   heads: Sequence[str], survivors,
                   timeout_s: float = 30.0) -> Dict:
    """Prefix-affinity-aware drain handoff (r20, ROADMAP 3(a)): ask
    each survivor to ``prefetch`` its rendezvous share of the victim's
    advertised chain heads straight from the victim (the blobs never
    transit this process). ``survivors`` are objects with ``.idx`` and
    ``.port``. Per-head failures are recorded, never raised — a failed
    handoff just means the chain is re-prefilled on first use, the
    same typed fallback as every other fetch path."""
    report: Dict = {"heads": len(heads), "imported_pages": 0,
                    "bytes": 0, "failures": [], "per_survivor": {}}
    if not heads or not survivors:
        return report
    assign: Dict[int, List[str]] = {}
    by_idx = {r.idx: r for r in survivors}
    for head in heads:
        assign.setdefault(rendezvous_owner(head, survivors).idx,
                          []).append(head)
    for idx, share in assign.items():
        rep = by_idx[idx]
        try:
            reply = _rpc(host, rep.port,
                         {"op": "prefetch", "host": host,
                          "port": victim_port, "heads": share},
                         timeout_s=timeout_s)
        except Exception as e:
            report["failures"].append(
                f"survivor {idx}: {type(e).__name__}: {e}")
            continue
        if reply.get("error"):
            report["failures"].append(
                f"survivor {idx}: {reply['error']}: "
                f"{reply.get('reason')}")
            continue
        report["imported_pages"] += int(reply.get("imported") or 0)
        report["bytes"] += int(reply.get("bytes") or 0)
        report["per_survivor"][str(idx)] = {
            "heads": len(share),
            "imported": int(reply.get("imported") or 0),
            "corrupt": int(reply.get("corrupt") or 0),
            "skipped": int(reply.get("skipped") or 0)}
    return report


class _BackendLost(ConnectionError):
    """Router-internal: the backend replica died mid-request."""


class _ClientLost(ConnectionError):
    """Router-internal: the ROUTER'S OWN client socket died mid-relay.
    Must never be confused with `_BackendLost`: failing over would burn
    healthy replicas generating into a dead socket and corrupt the
    replica-failure metrics."""


class FailoverRouter:
    """One client-facing port over N supervised replicas.

    Per-request routing: round-robin over ready replicas — except
    KEYED requests, which are steered for CACHE AFFINITY (r15): the
    prompt's first-block prefix key (the same chained blake2b the
    prefix cache uses) is matched against each replica's advertised
    cached keys; an advertising holder wins, otherwise a rendezvous
    hash over the live replicas picks a stable owner so repeated
    prefixes concentrate on one replica and BUILD affinity, and when
    no key can be computed (short prompt, no advertisement yet) the
    least-loaded live replica takes it. Affinity is a ROUTING HINT
    only: excluded/dead replicas are always filtered first, so it can
    never block failover — a steered request whose replica dies fails
    over exactly like any other.

    A backend that dies mid-request (connection error, or an armed
    ``net.recv`` schedule) costs an unkeyed request a typed retryable
    ``ReplicaFailed``; a KEYED request is resubmitted to another live
    replica, with already-relayed streamed tokens suppressed from the
    resubmission (greedy determinism makes the resubmitted stream a
    superset-in-order of what was already sent). ``health`` is
    answered by the router itself with per-replica state; other admin
    ops go to the first live replica."""

    def __init__(self, supervisor: Supervisor, host: str = "127.0.0.1",
                 port: int = 0, max_failover: int = 3,
                 backend_timeout_s: float = 300.0,
                 no_replica_wait_s: float = 60.0,
                 affinity: bool = True,
                 trace_sample: float = 0.0, tracer=None,
                 deprioritize_outliers: bool = False,
                 disaggregate: bool = True,
                 fleet_cache: bool = True,
                 forecast_placement: bool = False):
        self.sup = supervisor
        # back-reference: the autoscaler's shape planner reads
        # handoff_prefill_failures_total off the router; a frozen stub
        # supervisor just does not get one
        try:
            supervisor.router = self
        except AttributeError:
            pass
        self.host = host
        self._requested_port = port
        self.max_failover = int(max_failover)
        self.backend_timeout_s = float(backend_timeout_s)
        self.no_replica_wait_s = float(no_replica_wait_s)
        self.affinity = bool(affinity)
        # disaggregated prefill/decode (r20), default ON but inert on
        # an all-mixed fleet (byte-for-byte the pre-r20 routing): with
        # prefill-class AND decode-capable replicas live, a keyed
        # request with a computable first-block key routes
        # PREFILL-FIRST — the prompt runs as a prefill_only job on a
        # prefill replica (rendezvous-stable so residency builds),
        # then the request is dispatched to a decode-capable replica
        # with a fetch_from hint naming the prefill peer; the decode
        # side pulls the chain over fetch_pages and splices it instead
        # of re-prefilling. Every handoff failure degrades to local
        # prefill, never a hang.
        self.disaggregate = bool(disaggregate)
        # fleet telemetry (r17), default OFF: steer UNKEYED traffic
        # away from replicas the outlier detector currently flags
        # (slow step-ms/TPOT or erroring vs the fleet median). A
        # routing PREFERENCE only — flagged replicas still serve when
        # they are all that's live, keyed/affinity routing is
        # untouched, and failover exclusion always filters first.
        self.deprioritize_outliers = bool(deprioritize_outliers)
        # fleet cache (r23), default ON and inert without advertised
        # keys: when the picked replica does NOT advertise a keyed
        # request's chain but some OTHER live replica does, attach a
        # fetch_from hint naming that peer — any replica's tiers are
        # the fleet's cache, not just the designated prefill owner's.
        # A dead/evicted peer degrades exactly like the r20 handoff:
        # typed PageFetchFailed, counted, local prefill, same tokens.
        self.fleet_cache = bool(fleet_cache)
        # byte-planning placement (r23), default OFF: prefer replicas
        # whose capacity forecast (r18 exhaustion EWMA, scraped by the
        # supervisor's capacity probe) is NOT about to exhaust. A
        # PREFERENCE like deprioritize_outliers — never filters to
        # empty, failover exclusion still applies first.
        self.forecast_placement = bool(forecast_placement)
        # end-to-end tracing (r16): the router is the FIRST hop, so
        # its sampler decides for the whole request — a sampled
        # request's forward carries a trace context that forces the
        # replica to trace under the router's forward span (one trace
        # id, one merged tree; keyed failover appends failover spans
        # to the same tree)
        if tracer is not None:
            self.tracer = tracer
        else:
            from .tracing import SpanTracer, stderr_span_sink
            rate, sink = float(trace_sample), None
            if os.environ.get("PT_SERVING_DEBUG"):
                rate, sink = 1.0, stderr_span_sink
            self.tracer = SpanTracer(sample_rate=rate, on_span=sink)
        self.port: Optional[int] = None
        self.failovers_total = 0
        self.replica_failures_total = 0
        # cache-affinity accounting (r15): per PICK (routing decision),
        # not per request — a failover retry that re-picks counts
        # again. routed = picks that had a computable first-block key;
        # hits = picks steered to a replica ADVERTISING the key (vs
        # rendezvous-hash placement). Guarded by _lock: picks run on
        # concurrent connection threads.
        self.affinity_routed_total = 0
        self.affinity_hits_total = 0
        # disaggregation accounting (r20): handoffs_total counts
        # requests dispatched with a fetch_from hint (prefill hop run
        # or chain already parked on a prefill replica);
        # handoff_prefill_failures_total counts prefill hops that
        # failed and fell back to plain dispatch (local prefill)
        self.handoffs_total = 0
        self.handoff_prefill_failures_total = 0
        # fleet-cache accounting (r23): picks where the hint named a
        # non-owner peer advertising the chain (the any-replica lane)
        self.fleet_cache_hints_total = 0
        # byte-planning placement accounting (r23)
        self.forecast_steers_total = 0
        # optional routing-event hook: trace({"t": ..., "ev": ...,
        # ...}) — the chaos harness uses it for postmortems
        self.trace = None
        self._rr = 0
        self._stopping = False
        self._sock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()

    def start(self) -> int:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self._requested_port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="pt-router-accept")
        t.start()
        self._threads.append(t)
        return self.port

    def stop(self) -> None:
        self._stopping = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(timeout=5.0)

    def __enter__(self) -> "FailoverRouter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                self._sock.settimeout(0.2)
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="pt-router-conn")
            with self._lock:
                self._threads = [x for x in self._threads
                                 if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("r", encoding="utf-8")
        wfile = conn.makefile("w", encoding="utf-8")

        def send(obj: Dict) -> None:
            wfile.write(json.dumps(obj) + "\n")
            wfile.flush()

        try:
            for line in rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError as e:
                    send({"error": "BadRequest", "reason": str(e)})
                    continue
                try:
                    self._handle(msg, send)
                except Exception as e:  # typed reply, never a hang
                    send({"error": type(e).__name__, "reason": str(e)})
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: Dict, send) -> None:
        op = msg.get("op", "generate")
        if op == "health":
            send({"status": "ok" if self.sup.live() else "degraded",
                  "live": len(self.sup.live()),
                  "failovers_total": self.failovers_total,
                  "affinity_routed_total": self.affinity_routed_total,
                  "affinity_hits_total": self.affinity_hits_total,
                  "disaggregate": self.disaggregate,
                  "handoffs_total": self.handoffs_total,
                  "handoff_prefill_failures_total":
                      self.handoff_prefill_failures_total,
                  "fleet_cache_hints_total":
                      self.fleet_cache_hints_total,
                  "forecast_steers_total": self.forecast_steers_total,
                  "replicas": [{"idx": r.idx, "port": r.port,
                                "ready": r.ready, "alive": r.alive(),
                                "restarts": r.restarts,
                                "role": getattr(r, "role", "mixed"),
                                "load": getattr(r, "load", 0),
                                "advertised_prefixes":
                                    len(getattr(r, "prefix_keys", ())),
                                "prefix_keys_truncated":
                                    getattr(r, "prefix_truncated",
                                            False)}
                               for r in self.sup.replicas]})
            return
        if op == "trace":
            # the ROUTER's share of the span trees (pick/forward/
            # failover spans); replica shares come from each replica's
            # own trace op and merge by trace id — router spans carry
            # the forward span ids the replica roots reference as
            # remote_parent
            send({"traces": self.tracer.finished(),
                  "events": self.tracer.events(),
                  "sample_rate": self.tracer.sample_rate})
            return
        if op == "fleet_stats":
            # fleet telemetry plane (r17): the collector's merged view
            # + supervision taxonomy, answered BY THE ROUTER (the one
            # port an operator watches). Duck-typed: a stub supervisor
            # without the plane gets a typed reply, not a crash.
            fs = getattr(self.sup, "fleet_stats", None)
            if fs is None:
                send({"error": "FleetMetricsUnavailable",
                      "reason": "supervisor has no fleet telemetry "
                                "plane"})
                return
            stats = fs()
            stats["router"] = {
                "failovers_total": self.failovers_total,
                "replica_failures_total": self.replica_failures_total,
                "affinity_routed_total": self.affinity_routed_total,
                "affinity_hits_total": self.affinity_hits_total,
                "deprioritize_outliers": self.deprioritize_outliers,
                "disaggregate": self.disaggregate,
                "handoffs_total": self.handoffs_total,
                "handoff_prefill_failures_total":
                    self.handoff_prefill_failures_total,
                "fleet_cache_hints_total": self.fleet_cache_hints_total,
                "forecast_steers_total": self.forecast_steers_total,
            }
            send({"fleet": stats})
            return
        if op == "fleet_capacity":
            # memory observatory (r18): merged per-replica occupancy +
            # the fleet's nearest time-to-exhaustion — the capacity
            # half of the autoscaler input contract (3a). Duck-typed
            # like fleet_stats.
            fc = getattr(self.sup, "fleet_capacity", None)
            if fc is None:
                send({"error": "FleetCapacityUnavailable",
                      "reason": "supervisor has no capacity "
                                "collector"})
                return
            send({"capacity": fc()})
            return
        if op == "fleet_metrics":
            # fleet Prometheus exposition: per-replica series carry a
            # replica label, fleet rollups live in fleet_* families
            fm = getattr(self.sup, "fleet", None)
            if fm is None:
                send({"error": "FleetMetricsUnavailable",
                      "reason": "supervisor has no fleet telemetry "
                                "plane"})
                return
            text = fm.prometheus_text()
            asc = getattr(self.sup, "autoscaler", None)
            if asc is not None:
                # serving_autoscale_actions_total and
                # serving_fleet_replicas
                text = (text.rstrip("\n") + "\n"
                        + "\n".join(asc.prometheus_lines()) + "\n")
            send({"text": text})
            return
        if op == "autoscale":
            # the actuator's one-port drive: status, or a forced
            # scale_up / scale_down / rerole (cooldowns bypassed, the
            # envelope and the guards still apply)
            asc = getattr(self.sup, "autoscaler", None)
            if asc is None:
                send({"error": "AutoscalerUnavailable",
                      "reason": "supervisor started without "
                                "--autoscale"})
                return
            action = msg.get("action")
            if action in (None, "status"):
                send({"autoscaler": asc.status()})
            elif action == "scale_up":
                send({"result": asc.scale_up(
                    reason=msg.get("reason") or "forced",
                    role=msg.get("role") or "mixed", force=True)})
            elif action == "scale_down":
                send({"result": asc.scale_down(
                    reason=msg.get("reason") or "forced",
                    force=True)})
            elif action == "rerole":
                send({"result": asc.rerole(
                    int(msg.get("replica", -1)),
                    msg.get("role") or "mixed",
                    reason=msg.get("reason") or "forced",
                    force=True)})
            else:
                send({"error": "BadRequest",
                      "reason": f"unknown autoscale action "
                                f"{action!r}"})
            return
        if op == "roll":
            # rolling weight upgrade (r24): the one-port drive for
            # Supervisor.roll_fleet — blocks this connection thread
            # for the roll's duration (other connections keep
            # routing). Duck-typed like the other fleet ops.
            rf = getattr(self.sup, "roll_fleet", None)
            if rf is None:
                send({"error": "RollUnavailable",
                      "reason": "supervisor has no roll_fleet"})
                return
            ckpt = msg.get("checkpoint")
            if not isinstance(ckpt, str) or not ckpt:
                send({"error": "BadRequest",
                      "reason": "roll needs a 'checkpoint' directory"})
                return
            kwargs: Dict = {}
            if msg.get("generation") is not None:
                kwargs["generation"] = int(msg["generation"])
            if msg.get("canary_window_s") is not None:
                kwargs["canary_window_s"] = \
                    float(msg["canary_window_s"])
            if msg.get("slo_regress") is not None:
                kwargs["slo_regress"] = float(msg["slo_regress"])
            send({"roll": rf(ckpt, **kwargs)})
            return
        if op != "generate":
            # admin op: first live replica answers (replica-targeted
            # audits talk to replica ports directly)
            rep = self._pick(set())
            if rep is None:
                send({"error": "NoReplicaAvailable", "retryable": True})
                return
            try:
                send(_rpc(self.sup.host, rep.port, msg,
                          timeout_s=self.backend_timeout_s))
            except Exception as e:
                send({"error": "ReplicaFailed", "retryable": True,
                      "reason": f"{type(e).__name__}: {e}"})
            return
        self._route_generate(msg, send)

    def _affinity_key(self, msg: Dict) -> Optional[str]:
        """The prompt's first-block prefix key (hex) — the unit the
        prefix cache shares by and replicas advertise. None when it
        cannot be computed: unkeyed request, no live replica has
        reported its page size yet, or the prompt has no full
        shareable first block (length <= page_size: the cache never
        shares a block covering the last prompt token)."""
        if not self.affinity or msg.get("key") is None:
            return None
        prompt = msg.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            return None
        # getattr: the supervisor is duck-typed (tests front plain
        # stub replicas) — a replica without advertisement fields
        # simply never attracts affinity routing
        ps = next((getattr(r, "page_size", None)
                   for r in self.sup.live()
                   if getattr(r, "page_size", None)), None)
        if not ps or len(prompt) <= ps:
            return None
        from .prefix_cache import _block_hash
        try:
            # generation-aware (r24): replicas salt their chain roots
            # with their weight generation, so the router must hash
            # with the fleet's COMMITTED generation or no advertised
            # key would ever match after a roll. Mid-roll, replicas
            # still on the old generation simply stop matching and
            # degrade to rendezvous placement — the documented
            # cold-cache cost of a rolling upgrade.
            gen = getattr(self.sup, "weight_generation", 0) or 0
            return _block_hash(None, np.asarray(prompt[:ps],
                                                np.int32),
                               generation=gen).hex()
        except (TypeError, ValueError, OverflowError):
            return None  # malformed prompt: backend answers BadRequest

    # forecast pressure floor (r23): a replica whose fresh capacity
    # forecast projects pool exhaustion within this many seconds is
    # deprioritized by forecast_placement picks
    FORECAST_TTE_FLOOR_S = 5.0

    def _forecast_pressed(self, rep: Replica) -> bool:
        """True when ``rep``'s capacity snapshot is FRESH (the r18
        collector freshness rule) and its exhaustion forecast projects
        the pool empty within FORECAST_TTE_FLOOR_S."""
        cap = getattr(rep, "capacity", None)
        if not isinstance(cap, dict):
            return False
        stale_after = max(10.0, 4 * getattr(self.sup,
                                            "probe_interval_s", 2.5))
        if time.monotonic() - getattr(rep, "capacity_t", 0.0) \
                > stale_after:
            return False
        tte = (cap.get("forecast") or {}).get("tte_s")
        return (isinstance(tte, (int, float))
                and float(tte) < self.FORECAST_TTE_FLOOR_S)

    def _fleet_cache_hint(self, rep: Replica,
                          affinity_key: Optional[str],
                          trace=None) -> Optional[Dict]:
        """Fleet cache (r23): the pick did NOT land on a holder (none
        live in the pickable set, or the holder died and is excluded)
        — but ANY live peer advertising the chain can serve it over
        fetch_pages, prefill-class or not: every replica's spill tiers
        are one fleet-wide KV byte cache. Returns a fetch_from hint
        naming the least-loaded advertising peer, or None (lane off,
        unkeyed, the pick already holds the chain, or no peer
        advertises it). If the peer dies before the pull, the decode
        side's typed PageFetchFailed falls back to local prefill —
        never a hang, never wrong tokens."""
        if not self.fleet_cache or affinity_key is None:
            return None
        if affinity_key in getattr(rep, "prefix_keys", ()):
            return None  # already resident where decode will run
        peers = [r for r in self.sup.live()
                 if r.idx != rep.idx
                 and affinity_key in getattr(r, "prefix_keys", ())]
        if not peers:
            return None
        peer = min(peers, key=lambda r: (getattr(r, "load", 0), r.idx))
        with self._lock:
            self.fleet_cache_hints_total += 1
        if trace is not None:
            trace("fleet_cache_hint", rep=rep.idx, peer=peer.idx)
        return {"host": self.sup.host, "port": peer.port}

    def _pick(self, exclude: set, affinity_key: Optional[str] = None,
              keyed: bool = False,
              exclude_prefill: bool = False) -> Optional[Replica]:
        """Pick a live replica outside ``exclude``. With an
        ``affinity_key``: an ADVERTISING holder wins (ties:
        least-loaded), else a rendezvous hash over the live set picks
        a stable owner so repeated prefixes build cache residency on
        one replica. A KEYED request whose affinity key could not be
        computed (short prompt, no advertised page size) falls back to
        least-loaded (round-robin among load ties); unkeyed requests
        keep the pre-r15 round-robin. Liveness/exclusion filter FIRST
        — affinity is a preference among survivors and can never block
        failover. ``exclude_prefill`` (r20 role-aware dispatch) keeps
        decode streams off prefill-class replicas — they would answer
        WrongRole."""
        live = [r for r in self.sup.live() if r.idx not in exclude]
        if exclude_prefill:
            live = [r for r in live
                    if getattr(r, "role", "mixed") != "prefill"]
        if not live:
            return None
        if self.forecast_placement and len(live) > 1:
            # byte-planning placement (r23, default off): drop replicas
            # whose FRESH capacity forecast says the pool exhausts
            # within the pressure floor — a request landed there would
            # thrash evictions the moment it started decoding. A
            # preference, never a filter-to-empty; stale/absent
            # forecasts count as healthy (advisory plane, r18 rules).
            healthy = [r for r in live if not self._forecast_pressed(r)]
            if healthy and len(healthy) < len(live):
                with self._lock:
                    self.forecast_steers_total += 1
                live = healthy
        if affinity_key is not None:
            holders = [r for r in live
                       if affinity_key in getattr(r, "prefix_keys", ())]
            with self._lock:
                self.affinity_routed_total += 1
                if holders:
                    self.affinity_hits_total += 1
            if holders:
                return min(holders,
                           key=lambda r: (getattr(r, "load", 0), r.idx))
            # rendezvous (highest-random-weight) hashing: stable under
            # replica churn — removing one replica only remaps ITS
            # keys, so the rest of the fleet's cache residency survives
            return max(live, key=lambda r: hashlib.blake2b(
                f"{affinity_key}:{r.idx}".encode(),
                digest_size=8).digest())
        if keyed:
            lo = min(getattr(r, "load", 0) for r in live)
            live = [r for r in live if getattr(r, "load", 0) == lo]
        elif self.deprioritize_outliers:
            # r17 (default off): unkeyed traffic prefers replicas the
            # fleet outlier detector hasn't flagged — a preference,
            # never a filter-to-empty (a fully-flagged fleet still
            # serves), applied AFTER liveness/exclusion so it cannot
            # block failover
            fm = getattr(self.sup, "fleet", None)
            if fm is not None:
                try:
                    flagged = set(fm.outliers())
                except Exception:
                    flagged = set()
                healthy = [r for r in live if r.idx not in flagged]
                if healthy:
                    live = healthy
        with self._lock:
            self._rr += 1
            return live[self._rr % len(live)]

    def _route_generate(self, msg: Dict, send) -> None:
        keyed = msg.get("key") is not None
        # cache-affinity steering (r15): computed ONCE per request and
        # reused across failover attempts — the tried-set exclusion in
        # _pick keeps a dead affinity target from ever being retried
        affinity_key = self._affinity_key(msg)
        # token messages already sent to the client — MUTABLE so a
        # _BackendLost raised mid-stream still preserves the relay
        # progress the next attempt must suppress
        progress = {"relayed": 0}
        attempts = 0
        tried: set = set()
        arrival = time.monotonic()
        wait_deadline = arrival + self.no_replica_wait_s
        # deadline_ms is a budget FROM ARRIVAL covering the whole
        # request: each forward (first try included — time can pass
        # waiting for a live replica) carries only the REMAINING
        # budget, or a failed-over request would restart its clock on
        # every replica and overshoot the contract by up to
        # max_failover * deadline_ms
        budget_ms = msg.get("deadline_ms")
        if isinstance(budget_ms, bool) or \
                not isinstance(budget_ms, (int, float)):
            budget_ms = None  # malformed: backend answers BadRequest
        # end-to-end tracing (r16): the router's span tree for this
        # request — pick/forward/failover. A client-supplied trace
        # context is adopted; otherwise the router's sampler decides.
        prompt = msg.get("prompt")
        rtr = self.tracer.start(
            "route", ctx=msg.get("trace") if isinstance(
                msg.get("trace"), dict) else None,
            key=msg.get("key"),
            prompt_len=len(prompt) if isinstance(prompt, list) else 0)

        def trace(ev: str, **kw) -> None:
            if self.trace is not None:
                kw.update(ev=ev, key=msg.get("key"),
                          t=round(time.monotonic(), 3))
                try:
                    self.trace(kw)
                except Exception:
                    pass

        # disaggregated dispatch (r20): keyed requests with a
        # computable first-block key route PREFILL-FIRST when the
        # fleet has prefill-class replicas; the returned hint makes
        # the decode-capable target fetch the chain instead of
        # re-prefilling. None = plain dispatch (all-mixed fleet,
        # chain already decode-resident, or the hop failed — counted).
        handoff_hint = None
        if self.disaggregate and keyed and affinity_key is not None:
            handoff_hint = self._plan_handoff(msg, affinity_key, rtr,
                                              trace, budget_ms, arrival)
        while True:
            # affinity=False restores the pre-r15 keyed routing wholly
            # (round-robin, no least-loaded filter) — the bisect
            # escape hatch MIGRATION.md documents
            rep = self._pick(tried, affinity_key=affinity_key,
                             keyed=keyed and self.affinity,
                             exclude_prefill=self.disaggregate)
            trace("pick", rep=None if rep is None else rep.idx,
                  attempts=attempts)
            if rep is None:
                # every replica tried/dead: wait for the supervisor to
                # resurrect one (fresh respawns are fair game again)
                if time.monotonic() >= wait_deadline:
                    self.replica_failures_total += 1
                    if rtr is not None:
                        self.tracer.finish(rtr, state="no_replica")
                    send({"error": "NoReplicaAvailable",
                          "retryable": True,
                          "reason": "no live replica within "
                                    f"{self.no_replica_wait_s}s"})
                    return
                tried.clear()
                time.sleep(0.2)
                continue
            hint = handoff_hint
            if hint is None:
                hint = self._fleet_cache_hint(rep, affinity_key, trace)
            fwd = msg
            if hint is not None:
                # the hint survives failover: if the advertising peer
                # died meanwhile, the decode side's fetch fails typed
                # and falls back to local prefill — never a hang
                fwd = dict(msg)
                fwd["fetch_from"] = hint
            if budget_ms is not None and budget_ms > 0:
                remaining = budget_ms \
                    - (time.monotonic() - arrival) * 1e3
                if remaining <= 0:
                    if rtr is not None:
                        self.tracer.finish(rtr, state="deadline")
                    send({"error": "DeadlineExceeded",
                          "reason": "deadline_ms elapsed before "
                                    "completion",
                          "tokens_out": progress["relayed"]})
                    return
                fwd = dict(fwd)  # preserve any fetch_from hint
                fwd["deadline_ms"] = remaining
            fs = None
            if rtr is not None:
                # each forward attempt is one span; the replica roots
                # its share of the tree under this span via the wire
                # context (engine submit trace_ctx -> remote_parent)
                fs = rtr.begin("forward", parent=rtr.anchor,
                               replica=rep.idx, attempt=attempts)
                if fwd is msg:
                    fwd = dict(msg)
                fwd["trace"] = rtr.ctx(parent=fs)
            try:
                self._forward(rep, fwd, send, progress)
                trace("done", rep=rep.idx,
                      relayed=progress["relayed"])
                if rtr is not None:
                    rtr.end(fs, relayed=progress["relayed"])
                    self.tracer.finish(rtr, state="done")
                return
            except _ClientLost as e:
                # OUR client hung up mid-relay; the replica is fine.
                # Abort quietly — no failover, no replica-failure
                # metrics, nothing left to deliver the reply to.
                trace("client_lost", rep=rep.idx, err=str(e))
                if rtr is not None:
                    rtr.end(fs, error="client_lost")
                    self.tracer.finish(rtr, state="client_lost")
                return
            except _BackendLost as e:
                trace("backend_lost", rep=rep.idx, err=str(e))
                if rtr is not None:
                    rtr.end(fs, error=str(e),
                            relayed=progress["relayed"])
                attempts += 1
                tried.add(rep.idx)
                if not keyed:
                    self.replica_failures_total += 1
                    if rtr is not None:
                        self.tracer.finish(rtr, state="replica_failed")
                    send({"error": "ReplicaFailed", "retryable": True,
                          "reason": f"replica {rep.idx} lost "
                                    f"mid-request ({e}); resubmit "
                                    f"with a 'key' for transparent "
                                    f"failover"})
                    return
                if attempts > self.max_failover:
                    self.replica_failures_total += 1
                    if rtr is not None:
                        self.tracer.finish(rtr, state="replica_failed")
                    send({"error": "ReplicaFailed", "retryable": True,
                          "reason": f"{attempts} replicas lost "
                                    f"mid-request"})
                    return
                self.failovers_total += 1
                if rtr is not None:
                    # the stitch marker: the same tree continues on
                    # the next replica
                    rtr.event("failover", parent=rtr.anchor,
                              from_replica=rep.idx, attempt=attempts)

    def _plan_handoff(self, msg: Dict, affinity_key: str, rtr,
                      trace, budget_ms=None,
                      arrival: float = 0.0) -> Optional[Dict]:
        """Decide and (when needed) EXECUTE the prefill half of a
        disaggregated dispatch (r20). Returns a ``fetch_from`` hint
        for the decode forward, or None for plain dispatch:

        - no prefill-class or no decode-capable replica live → None
          (an all-mixed fleet is byte-for-byte pre-r20);
        - a decode-capable replica already advertises the chain →
          None (the affinity pick will land there; nothing to ship);
        - a prefill replica advertises it → hint at that replica,
          skipping the prefill hop entirely;
        - otherwise run the prompt as a ``prefill_only`` job on the
          rendezvous-stable prefill replica (so residency builds on
          one peer) and hint at it. A failed/typed-error hop is
          counted and degrades to plain dispatch — local prefill on
          the decode side, bit-identical output, never a hang.

        Truncation-awareness: a prefill replica advertising a
        TRUNCATED key list may hold the chain unadvertised; the
        rendezvous owner is exactly where earlier traffic parked it,
        and its own prefix cache dedupes the prefill_only job into a
        cache hit — so the hop is cheap precisely when the
        advertisement lied by omission."""
        live = self.sup.live()
        prefills = [r for r in live
                    if getattr(r, "role", "mixed") == "prefill"]
        decodes = [r for r in live
                   if getattr(r, "role", "mixed") != "prefill"]
        if not prefills or not decodes:
            return None
        if any(affinity_key in getattr(r, "prefix_keys", ())
               for r in decodes):
            return None  # already resident where decode will run
        holder = next((r for r in prefills
                       if affinity_key in getattr(r, "prefix_keys",
                                                  ())), None)
        if holder is not None:
            with self._lock:
                self.handoffs_total += 1
            trace("handoff_hint", rep=holder.idx, prefilled=False)
            return {"host": self.sup.host, "port": holder.port}
        target = rendezvous_owner(affinity_key, prefills)
        pf = {"op": "generate", "prompt": msg.get("prompt"),
              "max_new_tokens": 1, "prefill_only": True}
        for k in ("eos", "priority", "key"):
            if msg.get(k) is not None:
                pf[k] = msg[k]
        # the hop spends from the SAME deadline budget as the dispatch
        # it precedes: forward the remaining ms (the prefill replica's
        # own deadline gate sheds a hopeless job instead of queueing
        # it) and bound the RPC wait by it — a request that cannot
        # afford the hop goes straight to plain dispatch, so
        # disaggregation never makes a deadline-feasible request fail
        timeout_s = self.backend_timeout_s
        if budget_ms is not None and budget_ms > 0:
            remaining = budget_ms - (time.monotonic() - arrival) * 1e3
            if remaining <= 0:
                return None  # dispatch loop answers DeadlineExceeded
            pf["deadline_ms"] = remaining
            timeout_s = min(timeout_s, remaining / 1e3 + 1.0)
        sp = (rtr.begin("prefill_handoff", parent=rtr.anchor,
                        replica=target.idx)
              if rtr is not None else None)
        try:
            reply = _rpc(self.sup.host, target.port, pf,
                         timeout_s=timeout_s)
        except Exception as e:
            reply = {"error": f"{type(e).__name__}", "reason": str(e)}
        if not reply.get("prefilled"):
            with self._lock:
                self.handoff_prefill_failures_total += 1
            trace("handoff_prefill_failed", rep=target.idx,
                  err=reply.get("error"))
            if rtr is not None:
                rtr.end(sp, error=str(reply.get("error"))[:120])
            return None  # plain dispatch: local prefill, bit-identical
        with self._lock:
            self.handoffs_total += 1
        trace("handoff_prefill", rep=target.idx,
              pages=len(reply.get("keys") or ()))
        if rtr is not None:
            rtr.end(sp, pages=len(reply.get("keys") or ()))
        return {"host": self.sup.host, "port": target.port}

    def _forward(self, rep: Replica, msg: Dict, send,
                 progress: Dict[str, int]) -> None:
        """Proxy one request to ``rep``; stream token messages through,
        suppressing the first ``progress["relayed"]`` (already
        delivered by a prior attempt — bit-identical by greedy
        determinism), advancing the count IN PLACE so progress
        survives a mid-stream `_BackendLost`. Raises `_BackendLost` if
        the backend dies before the final reply, `_ClientLost` if the
        router's own client can no longer be written to."""
        from ..distributed.fault_inject import (InjectedFault,
                                                fault_point)

        def to_client(reply: Dict) -> None:
            # client-side send failures get their own exception class
            # so the backend-loss handler below can't mistake a dead
            # CLIENT for a dead REPLICA and fail over for nothing
            try:
                send(reply)
            except Exception as e:
                raise _ClientLost(f"{type(e).__name__}: {e}")

        seen = 0
        try:
            with socket.create_connection(
                    (self.sup.host, rep.port),
                    timeout=self.backend_timeout_s) as s:
                f = s.makefile("rw", encoding="utf-8")
                f.write(json.dumps(msg) + "\n")
                f.flush()
                while True:
                    fault_point("net.recv")
                    line = f.readline()
                    if not line:
                        raise _BackendLost(
                            f"replica {rep.idx} closed mid-request")
                    try:
                        reply = json.loads(line)
                    except json.JSONDecodeError:
                        raise _BackendLost(
                            f"replica {rep.idx} sent torn JSON")
                    if "token" in reply:
                        seen += 1
                        if seen > progress["relayed"]:
                            to_client(reply)
                            progress["relayed"] = seen
                        continue
                    # final reply (result or typed error)
                    to_client(reply)
                    return
        except InjectedFault as e:
            raise _BackendLost(f"injected net.recv ({e})")
        except (OSError, ValueError) as e:
            if isinstance(e, (_BackendLost, _ClientLost)):
                raise
            raise _BackendLost(f"{type(e).__name__}: {e}")


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch serving supervisor: N replica "
                    "server processes + health-probed restarts + "
                    "failover router on one port")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--model", default="gpt_125m")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8770,
                        help="router (client-facing) port")
    parser.add_argument("--probe-interval-s", type=float, default=0.5)
    parser.add_argument("--backoff-base-s", type=float, default=0.5)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument(
        "--roles", default=None, metavar="R0,R1,...",
        help="comma list assigning each replica a role (mixed/prefill/"
             "decode; shorter lists pad with mixed): --replicas 2 "
             "--roles prefill,decode runs one prefill-class replica "
             "shipping finished KV chains to a decode-class replica "
             "through the router's prefill-first dispatch. Omit for an "
             "all-mixed fleet")
    parser.add_argument(
        "--no-disaggregate", action="store_true",
        help="turn the router's prefill-first dispatch off even when "
             "prefill-class replicas exist")
    parser.add_argument(
        "--checkpoint", default=None, metavar="DIR",
        help="boot every replica from the newest valid checkpoint in "
             "DIR; `{\"op\": \"roll\", \"checkpoint\": ...}` on the "
             "router later hot-swaps the fleet onto a new checkpoint "
             "replica by replica with a canary and automatic rollback")
    parser.add_argument(
        "--prefill-chunk", type=int, default=None, metavar="TOKENS",
        help="chunked prefill per replica (each server's "
             "--prefill-chunk)")
    parser.add_argument(
        "--no-fused-step", action="store_true",
        help="unfused decode ops on every replica (each server's "
             "--no-fused-step)")
    parser.add_argument(
        "--multi-step", type=int, default=1, metavar="N",
        help="decode iterations a launch on every replica (each "
             "server's --multi-step)")
    parser.add_argument(
        "--spill-mb", type=int, default=None, metavar="MB",
        help="host-RAM spill tier per replica (each server's "
             "--spill-mb); a decode replica needs one large enough for "
             "a handed-off chain")
    parser.add_argument(
        "--spill-dir", default=None, metavar="DIR",
        help="disk spill tier per replica: replica i gets "
             "DIR/replica<i> as its --spill-dir")
    parser.add_argument(
        "--spill-disk-mb", type=int, default=1024, metavar="MB",
        help="byte budget of each replica's disk tier (default 1024)")
    parser.add_argument(
        "--trace-sample", type=float, default=0.0, metavar="R",
        help="the router samples this fraction of requests into span "
             "trees (and each server samples at the same rate)")
    parser.add_argument(
        "--slo-ttft-ms", type=float, default=None, metavar="MS",
        help="TTFT target of every replica's live SLO monitor, merged "
             "by the router's fleet_stats op")
    parser.add_argument(
        "--slo-tpot-ms", type=float, default=None, metavar="MS",
        help="TPOT target of the live SLO monitor")
    parser.add_argument(
        "--flight-dir", default=None, metavar="DIR",
        help="crash flight recorder: replica i writes black-box bundles "
             "to DIR/replica<i> (tools/flight_inspect.py reads them)")
    parser.add_argument(
        "--flight-budget-mb", type=int, default=64, metavar="MB",
        help="byte budget of each replica's bundle retention ring")
    parser.add_argument(
        "--no-collect-metrics", action="store_true",
        help="turn the fleet metrics collector off; fleet_stats then "
             "reports supervision state only")
    parser.add_argument(
        "--deprioritize-outliers", action="store_true",
        help="steer unkeyed traffic away from replicas the outlier "
             "detector flags")
    parser.add_argument(
        "--no-fleet-cache", action="store_true",
        help="no fetch_from hint to a peer advertising a keyed "
             "request's chain: the picked replica prefills locally")
    parser.add_argument(
        "--forecast-placement", action="store_true",
        help="steer new requests away from replicas whose exhaustion "
             "forecast is under the pressure floor")
    parser.add_argument(
        "--autoscale", action="store_true",
        help="autoscaling: a supervisor control loop consumes the "
             "pressure verdict, spawns a replica on scale_up and drains "
             "then kills one on scale_down inside the --min/"
             "--max-replicas envelope, and on disaggregated fleets "
             "re-roles replicas toward the prefill:decode ratio. Every "
             "action is journaled to a crc-checked fleet-state file "
             "before it acts; a restarted supervisor adopts the "
             "journal's fleet and resumes or rolls back what was half "
             "done")
    parser.add_argument("--min-replicas", type=int, default=1,
                        help="autoscale floor (default 1)")
    parser.add_argument("--max-replicas", type=int, default=4,
                        help="autoscale ceiling (default 4)")
    parser.add_argument(
        "--cooldown-s", type=float, default=30.0,
        help="seconds between scale actions of one direction (scale-up "
             "and scale-down/rerole keep a clock each; default 30)")
    parser.add_argument(
        "--autoscale-interval-s", type=float, default=1.0,
        help="the actuator's tick interval (default 1.0)")
    parser.add_argument(
        "--journal", default=None, metavar="PATH",
        help="fleet-state journal path (default: "
             "<log-dir>/fleet-journal.json). Recovery adopts the fleet "
             "recorded here: restart a supervisor on the SAME absolute "
             "path (and --log-dir) to inherit its predecessor's "
             "replicas instead of orphaning them")
    parser.add_argument(
        "server_args", nargs="*",
        help="extra args passed to every replica's "
             "`python -m paddle_tpu_torch.serving.server` after `--` "
             "(e.g. -- --page-size 64 --device cpu)")
    args = parser.parse_args(argv)

    def _sigterm(signum, frame):
        # kill, docker stop and systemd speak SIGTERM: route it through
        # the cleanup below, or the replica tree is orphaned
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)

    server_args = list(args.server_args)
    if args.prefill_chunk is not None:
        server_args += ["--prefill-chunk", str(args.prefill_chunk)]
    if args.no_fused_step:
        server_args += ["--no-fused-step"]
    if args.multi_step != 1:
        server_args += ["--multi-step", str(args.multi_step)]
    if args.spill_mb is not None:
        server_args += ["--spill-mb", str(args.spill_mb)]
    if args.spill_dir is not None:
        server_args += ["--spill-dir",
                        os.path.join(args.spill_dir, "replica{replica}"),
                        "--spill-disk-mb", str(args.spill_disk_mb)]
    if args.trace_sample:
        server_args += ["--trace-sample", str(args.trace_sample)]
    if args.slo_ttft_ms is not None:
        server_args += ["--slo-ttft-ms", str(args.slo_ttft_ms)]
    if args.slo_tpot_ms is not None:
        server_args += ["--slo-tpot-ms", str(args.slo_tpot_ms)]
    if args.flight_dir is not None:
        server_args += ["--flight-dir",
                        os.path.join(args.flight_dir,
                                     "replica{replica}"),
                        "--flight-budget-mb",
                        str(args.flight_budget_mb)]
    roles = None
    if args.roles:
        roles = [r.strip() for r in args.roles.split(",") if r.strip()]
        bad = [r for r in roles
               if r not in ("mixed", "prefill", "decode")]
        if bad:
            raise SystemExit(f"--roles: unknown role(s) {bad}; choose "
                             f"from mixed/prefill/decode")
    sup = Supervisor(model=args.model, replicas=args.replicas,
                     host=args.host, server_args=server_args,
                     probe_interval_s=args.probe_interval_s,
                     backoff_base_s=args.backoff_base_s,
                     log_dir=args.log_dir,
                     collect_metrics=not args.no_collect_metrics,
                     roles=roles, checkpoint=args.checkpoint)
    print(f"[paddle_tpu_torch.supervisor] spawning {args.replicas} "
          f"replicas of {args.model} (logs: {sup.log_dir}) ...",
          flush=True)
    asc = None
    if args.autoscale:
        from .autoscaler import AutoscaleConfig, Autoscaler
        flight = None
        if args.flight_dir is not None:
            from .fleet_metrics import FlightRecorder
            # min_interval_s=0: scale actions are rare and each one
            # matters for the postmortem
            flight = FlightRecorder(
                os.path.join(args.flight_dir, "supervisor"),
                budget_bytes=args.flight_budget_mb << 20,
                min_interval_s=0.0)
        asc = Autoscaler(
            sup,
            AutoscaleConfig(min_replicas=args.min_replicas,
                            max_replicas=args.max_replicas,
                            cooldown_up_s=args.cooldown_s,
                            cooldown_down_s=args.cooldown_s,
                            interval_s=args.autoscale_interval_s),
            journal_path=args.journal, flight=flight)
        # recovery BEFORE start(): adopt the previous generation's live
        # replicas (journal + env-marker scan) so start() spawns only
        # what recovery says is dead
        rec = asc.recover()
        print(f"[paddle_tpu_torch.supervisor] autoscale journal "
              f"{asc.journal.path}: adopted "
              f"{[a['idx'] for a in rec['adopted']]}, respawning "
              f"{[a['idx'] for a in rec['respawned']]}, reaped "
              f"{len(rec['reaped'])}, resolved "
              f"{len(rec['resolved'])}, resuming "
              f"{len(rec['resumed'])} action(s)", flush=True)
    router = None
    try:
        sup.start(wait_ready=True)
        router = FailoverRouter(
            sup, host=args.host, port=args.port,
            trace_sample=args.trace_sample,
            deprioritize_outliers=args.deprioritize_outliers,
            disaggregate=not args.no_disaggregate,
            fleet_cache=not args.no_fleet_cache,
            forecast_placement=args.forecast_placement)
        port = router.start()
        if asc is not None:
            asc.start()
        print(f"[paddle_tpu_torch.supervisor] router on "
              f"{args.host}:{port}; replicas "
              f"{[(r.idx, r.port) for r in sup.replicas]}", flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("[paddle_tpu_torch.supervisor] stopping ...", flush=True)
    finally:
        # every exit path must tear down whatever was spawned
        if asc is not None:
            asc.stop()
        if router is not None:
            router.stop()
        sup.stop()


if __name__ == "__main__":
    main()
