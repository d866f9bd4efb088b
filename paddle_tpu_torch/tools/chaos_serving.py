"""Seeded chaos harness for the port's crash-safe serving stack (port of
``tools/chaos_serving.py``).

Drives a real workload through the full serving topology (failover
router, supervised replica processes of ``python -m
paddle_tpu_torch.serving.server``, the SLO scheduler, the paged decode
engine) while a deterministic fault schedule (``distributed/
fault_inject.py``, seeded) fires at every layer below the client, or a
process is SIGKILLed at a chosen moment. Each run returns a
`ChaosReport`; its ``ok`` holds when every invariant held:

1. termination: every request ends in a full result or a typed error
   reply, never a hang;
2. zero leaks: after drain, every replica's ``leak_check`` op comes
   back clean;
3. bit-identical recovery: every successful greedy completion equals
   the fault-free reference computed in this process before any fault
   is armed;
4. flight bundles lint clean and each retention ring held its budget;
5. every replica's page ledger reconciles after drain;
6. (``run_disagg_chaos``) the prefill replica killed mid-handoff costs
   no request more than a local prefill;
7. (``run_autoscale_chaos``) the supervisor SIGKILLed mid-spawn and
   mid-scale-down and restarted on its journal strands no replica,
   loses no chain, and leaves a journal that lints clean;
8. (``run_fleet_cache_chaos``) the advertising peer killed mid-fetch:
   typed fallback to a local prefill, and the lane really armed;
9. (``run_roll_chaos``) a rolling weight upgrade interrupted every way
   the journal must survive converges to exactly one generation.

Replicas run on ``device`` (default ``"cuda"``, passed to each replica
as ``--device``); ``--device cpu`` runs the plain versions of the
kernels, which is how the CPU tests drive it. The CUDA kernels need a
head dim of 64 or 128, so on the card use ``--model gpt_125m`` or
larger (``gpt_tiny``'s head dim is 32). Usage::

    python -m paddle_tpu_torch.tools.chaos_serving --device cpu \\
        --replicas 2 --requests 12 --seed 0
    python -m paddle_tpu_torch.tools.chaos_serving --model gpt_125m \\
        --autoscale-chaos

Exit code 0 when every invariant held; the JSON report goes to stdout.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import flight_inspect

# the directory that holds the package: replicas and supervisors started
# from here import it whatever their working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# default replica fault schedule: an engine.step burst long enough to
# breach --max-engine-errors 3 (forcing one resurrection per replica
# process), scattered transient allocation failures, and a couple of
# torn server-side receives. Deterministic per PT_FAULT_SEED.
DEFAULT_REPLICA_FAULTS = ("engine.step:at=4|5|6,max=3;"
                          "alloc.page:p=0.05,max=3;"
                          "net.recv:p=0.02,max=2")


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one seeded chaos run."""

    requests: int = 0
    completed: int = 0            # full results
    typed_errors: int = 0         # DeadlineExceeded / ReplicaFailed / ...
    hangs: int = 0                # no reply within timeout (INVARIANT 1)
    mismatches: int = 0           # greedy output != reference (INV. 3)
    leak_failures: int = 0        # replica leak_check not ok (INV. 2)
    # INVARIANT 4: every survivor bundle lints clean and each replica's
    # retention ring held its budget
    flight_bundles: int = 0
    flight_lint_failures: int = 0
    flight_errors: List[str] = dataclasses.field(default_factory=list)
    # INVARIANT 5: after drain every replica's page ledger reconciles
    # with its allocator
    ledger_failures: int = 0
    ledger_errors: List[str] = dataclasses.field(default_factory=list)
    # INVARIANT 7: no serving process left carrying our journal marker
    # after the final graceful stop, and the journal lints clean
    stranded_processes: int = 0
    journal_lint_failures: int = 0
    # INVARIANT 8: the run exercised the lane under test (a fault that
    # never races the behaviour proves nothing, and fails the run)
    arming_failures: int = 0
    # INVARIANT 9: the fleet converged to exactly one weight generation,
    # a corrupt checkpoint was refused with zero replicas changed, and
    # converged outputs equal that generation's reference
    generation_failures: int = 0
    recoveries: int = 0           # supervisor SIGKILL->restart cycles
    error_kinds: Dict[str, int] = dataclasses.field(default_factory=dict)
    details: List[Dict] = dataclasses.field(default_factory=list)
    engine_restarts: int = 0      # scraped from surviving replicas
    replayed_requests: int = 0
    supervisor_restarts: int = 0  # replica process respawns
    router_failovers: int = 0
    replicas_checked: int = 0
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return (self.hangs == 0 and self.mismatches == 0
                and self.leak_failures == 0
                and self.flight_lint_failures == 0
                and self.ledger_failures == 0
                and self.stranded_processes == 0
                and self.journal_lint_failures == 0
                and self.arming_failures == 0
                and self.generation_failures == 0
                and self.completed + self.typed_errors == self.requests)

    def to_dict(self) -> Dict:
        out = dataclasses.asdict(self)
        out["ok"] = self.ok
        return out


def _pythonpath() -> str:
    """This process's PYTHONPATH with the package's root in front."""
    return os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH", "")) if p)


def _free_device_memory() -> None:
    """Drop the reference model's memory before a fleet boots beside it
    on the card."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _greedy(model, prompts, max_new, page_size: int,
            max_seq_len: int) -> List[List[int]]:
    """The greedy tokens of the port's engine (``num_slots=2``) on
    ``model``."""
    from ..inference import create_decode_engine

    eng = create_decode_engine(model, device=model.device, num_slots=2,
                               page_size=page_size,
                               max_seq_len=max_seq_len)
    try:
        rids = [eng.submit(p, mnt) for p, mnt in zip(prompts, max_new)]
        results = eng.run()
    finally:
        eng.close()
    return [[int(t) for t in results[r][len(p):]]
            for r, p in zip(rids, prompts)]


def _reference_outputs(model_name: str, prompts, max_new,
                       page_size: int, max_seq_len: int,
                       device: str = "cuda") -> List[List[int]]:
    """Fault-free greedy outputs on the seed-0 weights a replica builds,
    computed in this process before any fault is armed: the
    bit-identity oracle for every replayed or failed-over request
    (batching never changes a greedy output)."""
    from ..serving.server import build_model

    model = build_model(model_name, device)
    out = _greedy(model, prompts, max_new, page_size, max_seq_len)
    del model
    _free_device_memory()
    return out


def _scrape_counters(host: str, port: int) -> Dict[str, float]:
    from ..serving.supervisor import _rpc
    try:
        snap = _rpc(host, port, {"op": "stats"}, timeout_s=10.0)
        return dict(snap["stats"]["counters"])
    except Exception:
        return {}


def _prompts(rng, n: int, lo: int, hi: int):
    import numpy as np
    return [np.asarray(rng.integers(1, 100, size=int(rng.integers(lo, hi))),
                       np.int32)
            for _ in range(n)]


def _server_args(device: str, page_size: int, max_seq_len: int,
                 num_slots: int) -> List[str]:
    return ["--device", device, "--page-size", str(page_size),
            "--max-seq-len", str(max_seq_len),
            "--num-slots", str(num_slots), "--stall-timeout-s", "120"]


def _tally(report: ChaosReport, outcomes: Sequence[Optional[Dict]],
           accept: Callable[[int, object], bool]) -> None:
    """Invariants 1 and 3 over the clients' final outcomes: a full
    result (whose tokens ``accept``), a typed error, or a hang."""
    for i, out in enumerate(outcomes):
        if isinstance(out, dict):
            report.details.append(
                {"i": i, "elapsed_s": out.get("_elapsed_s"),
                 "kind": out.get("error")
                 or out.get("_transport_error", "ok")})
        if out is None or not isinstance(out, dict):
            report.hangs += 1
            continue
        if "_transport_error" in out:
            # the router owns typed delivery; a torn ROUTER client
            # connection counts as a hang-class failure
            report.hangs += 1
            kind = out["_transport_error"].split(":")[0]
            report.error_kinds[kind] = report.error_kinds.get(kind, 0) + 1
            continue
        if out.get("error"):
            report.typed_errors += 1
            kind = out["error"]
            report.error_kinds[kind] = report.error_kinds.get(kind, 0) + 1
            continue
        report.completed += 1
        if not accept(i, out.get("generated")):
            report.mismatches += 1


def _audit(report: ChaosReport, host: str, members, deadline: float,
           retry_drain: bool = False) -> None:
    """Invariants 2 and 5 on each ``(label, port)`` member: drain, then
    ``leak_check`` until clean (a busy replica is waited for until
    ``deadline``), then its page ledger's reconcile. ``port`` is a
    callable read at every attempt: the supervisor may respawn a replica
    on a fresh port meanwhile. With ``retry_drain`` a drain RPC torn by
    an injected fault is retried until ``deadline`` (every member gets
    one attempt)."""
    from ..serving.supervisor import _rpc
    for label, port in members:
        drained = False
        while True:
            try:
                _rpc(host, port(), {"op": "drain"}, timeout_s=10.0)
                drained = True
                break
            except Exception:
                if not retry_drain or time.monotonic() >= deadline:
                    break
                time.sleep(0.5)
        if not drained:
            report.leak_failures += 1
            continue
        ok = False
        chk: Dict = {}
        while time.monotonic() < deadline:
            try:
                chk = _rpc(host, port(), {"op": "leak_check"},
                           timeout_s=10.0)
            except Exception:
                time.sleep(0.5)
                continue
            if chk.get("ok"):
                ok = True
                break
            if not chk.get("busy"):
                break  # the audit FAILED (not just in-flight work)
            time.sleep(0.5)
        if ok:
            report.replicas_checked += 1
        else:
            report.leak_failures += 1
        led = chk.get("ledger")
        if isinstance(led, dict) and not led.get("ok", True):
            report.ledger_failures += 1
            report.ledger_errors.extend(
                f"replica {label}: {m}"
                for m in (led.get("mismatches") or
                          ["reconcile failed"])[:4])


def _members(sup):
    """The supervisor's replicas as ``_audit`` members."""
    return [(r.idx, lambda r=r: r.port) for r in sup.replicas]


def _lint_flight(report: ChaosReport, path: str,
                 budget_bytes: Optional[int] = None) -> None:
    if not os.path.isdir(path):
        return
    bundles, errors = flight_inspect.lint_dir(path,
                                              budget_bytes=budget_bytes)
    report.flight_bundles += len(bundles)
    if errors:
        report.flight_lint_failures += 1
        report.flight_errors.extend(errors[:8])


def _wait_respawned(sup, deadline: float) -> None:
    """The killed replica RESPAWNED and ready, not just still flagged
    ready because the monitor has not probed the corpse yet."""
    while time.monotonic() < deadline:
        if sup.restarts_total >= 1 and \
                all(r.ready and r.alive() for r in sup.replicas):
            break
        time.sleep(0.3)
    sup.wait_ready()


def _run_clients(indices, client) -> List[threading.Thread]:
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in indices]
    for t in threads:
        t.start()
    return threads


def _call(host: str, port: int, payload: Dict, timeout_s: float) -> Dict:
    """One request, its transport failure folded into the reply."""
    from ..serving.server import client_request
    t0 = time.monotonic()
    try:
        out = client_request(host, port, payload, timeout_s=timeout_s)
    except Exception as e:
        out = {"_transport_error": f"{type(e).__name__}: {e}"}
    out["_elapsed_s"] = round(time.monotonic() - t0, 2)
    return out


def run_chaos(replicas: int = 2, requests: int = 12, seed: int = 0,
              model: str = "gpt_tiny", page_size: int = 8,
              max_seq_len: int = 96, num_slots: int = 2,
              max_new_tokens: int = 6,
              replica_faults: Optional[str] = DEFAULT_REPLICA_FAULTS,
              router_fault_p: float = 0.08,
              router_fault_max: int = 3,
              kill_replica: bool = True,
              deadline_doomed: int = 2,
              unkeyed: int = 2,
              request_timeout_s: float = 300.0,
              drain_timeout_s: float = 120.0,
              device: str = "cuda",
              log_dir: Optional[str] = None,
              flight_budget_mb: int = 4,
              extra_server_args: Optional[List[str]] = None
              ) -> ChaosReport:
    """One seeded chaos run over a supervised fleet: ``engine.step``
    bursts force an engine resurrection with in-flight replay in each
    replica, ``alloc.page`` fails allocations, ``net.recv`` tears
    connections inside the replicas and inside the router's backend
    reader, and replica 0 is SIGKILLed mid-run (the supervisor respawns
    it while the router resubmits its keyed requests).

    ``deadline_doomed`` requests carry a 1 ms deadline (a typed
    DeadlineExceeded), ``unkeyed`` requests omit the idempotency key (a
    mid-request replica loss costs them a typed ReplicaFailed instead of
    a failover): typed outcomes both, so invariant 1 covers them.
    ``extra_server_args`` appends server flags to every replica (e.g.
    ``["--multi-step", "4", "--speculate", "4", "--prefill-chunk",
    "8"]``: the same fault sites then fire inside the multi-step
    launch); none of them changes a greedy output."""
    import numpy as np

    from ..distributed import fault_inject as fi
    from ..serving.supervisor import FailoverRouter, Supervisor

    t_start = time.monotonic()
    rng = np.random.default_rng(seed)
    prompts = _prompts(rng, requests, 4, 20)
    max_new = [max_new_tokens] * requests
    # the oracle MUST precede any arming: it runs in this process
    expected = _reference_outputs(model, prompts, max_new, page_size,
                                  max_seq_len, device)

    log_dir = log_dir or tempfile.mkdtemp(prefix="pt-chaos-")
    replica_env = {"PT_FAULT_SEED": str(seed), "PYTHONPATH": _pythonpath()}
    if replica_faults:
        replica_env["PT_FAULT_INJECT"] = replica_faults
    # every replica writes flight bundles on resurrection; the fault
    # schedule forces one in each replica process, so a good run leaves
    # lint-clean bundles behind
    flight_root = os.path.join(log_dir, "flight")
    server_args = (["--device", device, "--page-size", str(page_size),
                    "--max-seq-len", str(max_seq_len),
                    "--num-slots", str(num_slots),
                    "--max-engine-errors", "3",
                    "--stall-timeout-s", "120",
                    "--flight-dir",
                    os.path.join(flight_root, "replica{replica}"),
                    "--flight-budget-mb", str(flight_budget_mb)]
                   + list(extra_server_args or ()))
    sup = Supervisor(model=model, replicas=replicas,
                     server_args=server_args, replica_env=replica_env,
                     probe_interval_s=0.3, backoff_base_s=0.5,
                     log_dir=log_dir)
    report = ChaosReport(requests=requests)
    outcomes: List[Optional[Dict]] = [None] * requests
    route_trace: List[Dict] = []
    try:
        sup.start(wait_ready=True)
        router = FailoverRouter(sup, max_failover=replicas + 2)
        router.trace = route_trace.append
        rport = router.start()
        if router_fault_p > 0:
            # router-side net.recv: armed in THIS process, after the
            # oracle ran (fault_point is process-global)
            fi.get_injector().arm("net.recv", probability=router_fault_p,
                                  max_faults=router_fault_max,
                                  seed=seed + 1)
        first_result = threading.Event()

        def client(i: int) -> None:
            payload = {"op": "generate",
                       "prompt": [int(t) for t in prompts[i]],
                       "max_new_tokens": max_new[i],
                       "stream": bool(i % 2)}
            if i >= unkeyed:
                payload["key"] = f"chaos-{seed}-{i}"
            # a deadline enforced WELL before the client transport
            # timeout: whatever goes wrong below the socket, the reply
            # is a typed DeadlineExceeded, never a client-side timeout
            payload["deadline_ms"] = (1 if i < deadline_doomed
                                      else int(request_timeout_s * 500))
            outcomes[i] = _call("127.0.0.1", rport, payload,
                                request_timeout_s)
            first_result.set()

        threads = _run_clients(range(requests), client)
        if kill_replica:
            # SIGKILL one replica mid-run, once traffic is flowing
            first_result.wait(timeout=request_timeout_s)
            time.sleep(0.5)
            sup.kill_replica(0)
        for t in threads:
            t.join(timeout=request_timeout_s)
        _tally(report, outcomes, lambda i, got: got == expected[i])

        fi.get_injector().disarm("net.recv")
        deadline = time.monotonic() + drain_timeout_s
        sup.wait_ready()  # the killed replica must be back first
        # the replica-side net.recv faults stay armed for a replica's
        # whole life, so the drain RPC itself can be torn: retried
        # until the deadline (drain is idempotent)
        _audit(report, sup.host, _members(sup),
               deadline, retry_drain=True)
        for rep in sup.replicas:
            counters = _scrape_counters(sup.host, rep.port)
            report.engine_restarts += \
                int(counters.get("engine_restarts_total", 0))
            report.replayed_requests += \
                int(counters.get("replayed_requests_total", 0))
        budget = flight_budget_mb << 20
        for rep in sup.replicas:
            _lint_flight(report,
                         os.path.join(flight_root, f"replica{rep.idx}"),
                         budget_bytes=budget)
        if report.flight_bundles == 0 and replica_faults:
            # the fault schedule guarantees resurrections; zero bundles
            # means the recorder silently failed
            report.flight_lint_failures += 1
            report.flight_errors.append(
                f"no flight bundles under {flight_root} despite the "
                f"engine.step fault schedule")
        report.supervisor_restarts = sup.restarts_total
        report.router_failovers = router.failovers_total
        router.stop()
    finally:
        try:
            fi.get_injector().disarm("net.recv")
        except Exception:
            pass
        sup.stop()
    report.wall_s = round(time.monotonic() - t_start, 3)
    if not report.ok:
        # postmortem breadcrumbs: the router's routing history and the
        # replica logs (subprocess tracebacks live there)
        report.details.append({"route_trace": route_trace,
                               "log_dir": log_dir})
    return report


def run_disagg_chaos(requests: int = 8, seed: int = 0,
                     model: str = "gpt_tiny", page_size: int = 8,
                     max_seq_len: int = 96, num_slots: int = 2,
                     max_new_tokens: int = 6,
                     prompt_len_range=(18, 34),
                     request_timeout_s: float = 300.0,
                     drain_timeout_s: float = 120.0,
                     device: str = "cuda",
                     log_dir: Optional[str] = None) -> ChaosReport:
    """INVARIANT 6: SIGKILL the prefill-class replica MID-HANDOFF. A
    1-prefill + 1-decode fleet serves keyed long-prompt requests through
    the router's prefill-first dispatch while the prefill replica is
    killed about a second in, so some requests are mid prefill hop,
    some mid ``fetch_pages`` pull, some already spliced. Every request
    terminates in a full result (the handoff, or the local-prefill
    fallback with the same greedy tokens) or a typed error; zero leaked
    pages and a clean ledger reconcile on the survivor and on the
    respawned prefill replica."""
    import numpy as np

    from ..serving.supervisor import FailoverRouter, Supervisor

    t_start = time.monotonic()
    rng = np.random.default_rng(seed)
    # long keyed prompts: every one has shareable full pages, so every
    # request is handoff-eligible (the path under test)
    prompts = _prompts(rng, requests, *prompt_len_range)
    max_new = [max_new_tokens] * requests
    expected = _reference_outputs(model, prompts, max_new, page_size,
                                  max_seq_len, device)

    log_dir = log_dir or tempfile.mkdtemp(prefix="pt-chaos-disagg-")
    sup = Supervisor(model=model, replicas=2, roles=["prefill", "decode"],
                     server_args=_server_args(device, page_size,
                                              max_seq_len, num_slots),
                     replica_env={"PYTHONPATH": _pythonpath()},
                     probe_interval_s=0.3, backoff_base_s=0.5,
                     log_dir=log_dir)
    report = ChaosReport(requests=requests)
    outcomes: List[Optional[Dict]] = [None] * requests
    route_trace: List[Dict] = []
    try:
        sup.start(wait_ready=True)
        router = FailoverRouter(sup, max_failover=4)
        router.trace = route_trace.append
        rport = router.start()
        first_result = threading.Event()

        def client(i: int) -> None:
            outcomes[i] = _call(
                "127.0.0.1", rport,
                {"op": "generate", "prompt": [int(t) for t in prompts[i]],
                 "max_new_tokens": max_new[i], "stream": bool(i % 2),
                 "key": f"disagg-{seed}-{i}",
                 "deadline_ms": int(request_timeout_s * 500)},
                request_timeout_s)
            first_result.set()

        threads = _run_clients(range(requests), client)
        # the first wave is inside its prefill hop / fetch_pages pull
        # about one second in (not waiting for a completion: by then
        # the whole wave can be past the handoff)
        first_result.wait(timeout=1.0)
        sup.kill_replica(0)
        for t in threads:
            t.join(timeout=request_timeout_s)
        _tally(report, outcomes, lambda i, got: got == expected[i])

        deadline = time.monotonic() + drain_timeout_s
        _wait_respawned(sup, deadline)
        _audit(report, sup.host, _members(sup),
               deadline)
        report.supervisor_restarts = sup.restarts_total
        report.router_failovers = router.failovers_total
        report.details.append(
            {"handoffs_total": router.handoffs_total,
             "handoff_prefill_failures_total":
                 router.handoff_prefill_failures_total})
        router.stop()
    finally:
        sup.stop()
    report.wall_s = round(time.monotonic() - t_start, 3)
    if not report.ok:
        report.details.append({"route_trace": route_trace,
                               "log_dir": log_dir})
    return report


def run_fleet_cache_chaos(requests: int = 8, seed: int = 0,
                          model: str = "gpt_tiny", page_size: int = 8,
                          max_seq_len: int = 96, num_slots: int = 2,
                          max_new_tokens: int = 6,
                          request_timeout_s: float = 300.0,
                          drain_timeout_s: float = 120.0,
                          device: str = "cuda",
                          log_dir: Optional[str] = None) -> ChaosReport:
    """INVARIANT 8: SIGKILL the ADVERTISING PEER mid fleet-cache fetch
    under keyed traffic. An all-mixed 2-replica fleet (host spill tiers,
    chunked prefill so concurrent same-prefix admissions fold pages);
    replica 0 is warmed with a shared-prefix chain and advertises it;
    the harness's router steers every pick off replica 0, so every keyed
    request dispatches to replica 1 with a ``fetch_from`` hint naming
    replica 0. Once hints are seen, replica 0 is SIGKILLed: the first
    wave's pulls die mid-pull, the second wave dispatches against a
    stale advertisement. Every request ends in a full result (a typed
    PageFetchFailed falls back to a local prefill with the same tokens)
    or a typed error; zero leaks and a dedup-aware ledger reconcile on
    every member; no hint before the kill fails the run
    (``arming_failures``)."""
    import numpy as np

    from ..serving.prefix_cache import _block_hash
    from ..serving.supervisor import FailoverRouter, Supervisor

    t_start = time.monotonic()
    rng = np.random.default_rng(seed)
    # every prompt shares a 2-full-page prefix (the chain the fleet
    # cache ships) with a distinct random tail
    base = rng.integers(1, 100, size=2 * page_size)
    prompts = [np.asarray(np.concatenate(
                   [base, rng.integers(1, 100,
                                       size=int(rng.integers(2, 17)))]),
               np.int32)
               for _ in range(requests)]
    max_new = [max_new_tokens] * requests
    expected = _reference_outputs(model, prompts, max_new, page_size,
                                  max_seq_len, device)

    log_dir = log_dir or tempfile.mkdtemp(prefix="pt-chaos-fleet-")
    # both sides of the lane need tiers (the peer exports blobs from
    # them, the fetcher lands blobs into them)
    server_args = (_server_args(device, page_size, max_seq_len, num_slots)
                   + ["--spill-mb", "64", "--prefill-chunk",
                      str(page_size)])
    sup = Supervisor(model=model, replicas=2, server_args=server_args,
                     replica_env={"PYTHONPATH": _pythonpath()},
                     probe_interval_s=0.3, backoff_base_s=0.5,
                     log_dir=log_dir)
    report = ChaosReport(requests=requests)
    outcomes: List[Optional[Dict]] = [None] * requests
    route_trace: List[Dict] = []

    class _SteeredRouter(FailoverRouter):
        """Keep picks off the warmed holder (replica 0) so keyed
        requests MUST take the fleet-cache lane to reuse its chain."""

        def _pick(self, exclude, affinity_key=None, keyed=False,
                  exclude_prefill=False):
            return super()._pick(set(exclude) | {0}, affinity_key,
                                 keyed, exclude_prefill)

    try:
        sup.start(wait_ready=True)
        # warm the shared chain onto replica 0 directly, then wait for
        # its advertisement to reach the supervisor's probe loop
        warm = _call(sup.host, sup.replicas[0].port,
                     {"op": "generate",
                      "prompt": [int(t) for t in prompts[0]],
                      "max_new_tokens": 2, "key": f"fleet-warm-{seed}"},
                     request_timeout_s)
        key_hex = _block_hash(None, np.asarray(base[:page_size],
                                               np.int32)).hex()
        adv_deadline = time.monotonic() + 30.0
        while time.monotonic() < adv_deadline and \
                key_hex not in sup.replicas[0].prefix_keys:
            time.sleep(0.2)
        if warm.get("error") or "_transport_error" in warm or \
                key_hex not in sup.replicas[0].prefix_keys:
            report.arming_failures += 1
            report.details.append(
                {"arming": "warm/advertisement failed",
                 "warm_error": warm.get("error")
                 or warm.get("_transport_error"),
                 "advertised": sorted(sup.replicas[0].prefix_keys)[:4]})
            return report

        router = _SteeredRouter(sup, max_failover=4)
        router.trace = route_trace.append
        rport = router.start()

        def client(i: int) -> None:
            outcomes[i] = _call(
                sup.host, rport,
                {"op": "generate", "prompt": [int(t) for t in prompts[i]],
                 "max_new_tokens": max_new[i], "stream": bool(i % 2),
                 "key": f"fleet-{seed}-{i}",
                 "deadline_ms": int(request_timeout_s * 500)},
                request_timeout_s)

        n1 = max(1, requests // 2)
        threads = _run_clients(range(n1), client)
        # arm check THEN kill: once the router attached a fleet-cache
        # hint, the first wave is inside its pull from replica 0
        arm_deadline = time.monotonic() + 10.0
        while time.monotonic() < arm_deadline and \
                router.fleet_cache_hints_total == 0:
            time.sleep(0.05)
        hints_pre_kill = router.fleet_cache_hints_total
        if hints_pre_kill == 0:
            report.arming_failures += 1
        time.sleep(0.2)
        sup.kill_replica(0)
        # second wave: dispatched against a stale advertisement
        threads += _run_clients(range(n1, requests), client)
        for t in threads:
            t.join(timeout=request_timeout_s)
        _tally(report, outcomes, lambda i, got: got == expected[i])

        deadline = time.monotonic() + drain_timeout_s
        _wait_respawned(sup, deadline)
        _audit(report, sup.host, _members(sup),
               deadline)
        report.supervisor_restarts = sup.restarts_total
        report.router_failovers = router.failovers_total
        # how the fetches ended (pulled or typed fallback), and the
        # dedup fold counts
        surv = _scrape_counters(sup.host, sup.replicas[1].port)
        report.details.append(
            {"fleet_cache_hints_total": router.fleet_cache_hints_total,
             "hints_pre_kill": hints_pre_kill,
             "handoffs_total": router.handoffs_total,
             "survivor_counters":
                 {k: v for k, v in surv.items()
                  if "handoff" in k or "dedup" in k}})
        router.stop()
    finally:
        sup.stop()
    report.wall_s = round(time.monotonic() - t_start, 3)
    if not report.ok:
        report.details.append({"route_trace": route_trace,
                               "log_dir": log_dir})
    return report


class _CliFleet:
    """A supervisor run as ``python -m paddle_tpu_torch.serving.
    supervisor`` (the process the autoscale and roll chaos runs SIGKILL
    and restart on the same journal), reached through its router's
    port. ``restarts`` records each restart's seconds until the router
    served again."""

    def __init__(self, cmd: List[str], hold_s: float, log_dir: str,
                 rport: int, journal: str):
        self.cmd, self.rport, self.journal = cmd, rport, journal
        self.env = dict(os.environ, PYTHONPATH=_pythonpath(),
                        PT_AUTOSCALE_HOLD_S=str(hold_s))
        self.log = open(os.path.join(log_dir, "supervisor-cli.log"), "ab")
        self.log_dir = log_dir
        self.proc: Optional[subprocess.Popen] = None
        self.restarts: List[float] = []

    def launch(self) -> None:
        self.proc = subprocess.Popen(self.cmd, stdout=self.log,
                                     stderr=subprocess.STDOUT,
                                     env=self.env)

    def kill_and_restart(self, min_live: int) -> None:
        """SIGKILL the supervisor, start it again, and wait until its
        router serves ``min_live`` live replicas."""
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)
        t0 = time.monotonic()
        self.launch()
        self.wait_router(min_live)
        self.restarts.append(round(time.monotonic() - t0, 3))

    def op(self, payload: Dict, timeout_s: float = 10.0) -> Dict:
        return _call("127.0.0.1", self.rport, payload, timeout_s)

    def force(self, payload: Dict, timeout_s: float) -> threading.Thread:
        """``payload`` sent from a thread: the supervisor may die
        before it answers."""
        t = threading.Thread(target=self.op, args=(payload,),
                             kwargs={"timeout_s": timeout_s}, daemon=True)
        t.start()
        return t

    def wait_router(self, min_live: int = 1,
                    timeout_s: float = 300.0) -> Dict:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            h = self.op({"op": "health"}, timeout_s=5.0)
            if h.get("live", 0) >= min_live:
                return h
            time.sleep(0.3)
        raise RuntimeError(f"router not serving {min_live} live "
                           f"replica(s) within {timeout_s}s "
                           f"(logs: {self.log_dir})")

    def generate(self, payload: Dict, timeout_s: float) -> Dict:
        """The front door dies while the supervisor is down: transport
        errors and retryable typed errors are retried (same key, which
        greedy determinism makes free) until ``timeout_s``; only the
        final outcome is judged."""
        deadline = time.monotonic() + timeout_s
        t0 = time.monotonic()
        while True:
            out = self.op(payload, timeout_s=timeout_s)
            if ("_transport_error" in out or (
                    out.get("error") and out.get("retryable"))) \
                    and time.monotonic() < deadline:
                time.sleep(0.5)
                continue
            break
        out["_elapsed_s"] = round(time.monotonic() - t0, 2)
        return out

    def journal_obj(self) -> Optional[Dict]:
        try:
            with open(self.journal, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def journal_clean(self) -> bool:
        """The journal lints with every action resolved."""
        jobj = self.journal_obj()
        return jobj is not None and not flight_inspect.lint_fleet_journal(
            jobj, allow_open_tail=0)

    def stop(self) -> None:
        """Graceful stop (SIGTERM), a SIGKILL if it does not end."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                try:
                    self.proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
        self.log.close()


def _supervisor_cmd(model: str, replicas: int, rport: int, log_dir: str,
                    journal: str, min_replicas: int, cooldown_s: float,
                    server_args: List[str],
                    checkpoint: Optional[str] = None) -> List[str]:
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.supervisor",
           "--replicas", str(replicas), "--model", model,
           "--port", str(rport)]
    if checkpoint is not None:
        cmd += ["--checkpoint", checkpoint]
    return cmd + ["--probe-interval-s", "0.3", "--backoff-base-s", "0.5",
                  "--log-dir", log_dir,
                  "--flight-dir", os.path.join(log_dir, "flight"),
                  "--autoscale", "--min-replicas", str(min_replicas),
                  "--max-replicas", "3", "--cooldown-s", str(cooldown_s),
                  "--autoscale-interval-s", "0.3", "--journal", journal,
                  "--"] + server_args


def _reissue(report: ChaosReport, fleet: _CliFleet, prompts, max_new,
             keys: List[str], want: List[List[int]],
             timeout_s: float) -> None:
    """No lost chains: every key re-issued after recovery decodes its
    reference tokens (chains handed to survivors, or prefilled again on
    first use)."""
    for i, p in enumerate(prompts):
        out = fleet.generate({"op": "generate",
                              "prompt": [int(t) for t in p],
                              "max_new_tokens": max_new[i],
                              "key": keys[i]}, timeout_s)
        if out.get("generated") != want[i]:
            report.mismatches += 1
            report.details.append(
                {"reissue": i,
                 "kind": out.get("error")
                 or out.get("_transport_error", "mismatch")})


def _final_checks(report: ChaosReport, fleet: _CliFleet,
                  drain_timeout_s: float) -> None:
    """Zero leaks and a clean ledger on every live member, the
    supervisor's autoscale bundles and the journal lint clean (every
    action resolved), each action's wall seconds from the journal."""
    h = fleet.op({"op": "health"}, timeout_s=10.0)
    _audit(report, "127.0.0.1",
           [(r.get("idx"), lambda p=r.get("port"): p)
            for r in (h.get("replicas") or ())
            if r.get("port") is not None and r.get("alive")],
           time.monotonic() + drain_timeout_s)
    _lint_flight(report, os.path.join(fleet.log_dir, "flight",
                                      "supervisor"))
    jobj = fleet.journal_obj()
    errs = (["journal unreadable"] if jobj is None else
            flight_inspect.lint_fleet_journal(jobj, name="fleet-journal",
                                              allow_open_tail=0))
    if errs:
        report.journal_lint_failures += 1
        report.details.append({"journal_lint": errs[:8]})
    report.details.append({"journal_actions": _action_walls(jobj),
                           "restart_to_serving_s": list(fleet.restarts)})


def _check_armed(report: ChaosReport, fleet: _CliFleet, kind: str,
                 label: str) -> None:
    """The kill landed inside a journaled-but-uncommitted ``kind``
    action: the restarted supervisor's recovery resolved or resumed one.
    A kill that missed the window proves nothing and fails the run
    (``arming_failures``)."""
    asc = fleet.op({"op": "autoscale"}).get("autoscaler") or {}
    rec = asc.get("recovery") or {}
    body = (fleet.journal_obj() or {}).get("body") or {}
    kinds = {e.get("seq"): e.get("action")
             for e in body.get("actions") or ()
             if e.get("phase") == "begin"}
    seqs = [r.get("seq") for r in (rec.get("resolved") or [])
            + (rec.get("resumed") or [])]
    if not any(kinds.get(q) == kind for q in seqs):
        report.arming_failures += 1
        report.details.append({"arming": f"{label}: recovery found no "
                                         f"open {kind} action",
                               "recovery": rec})


def _action_walls(jobj: Optional[Dict]) -> List[Dict]:
    """Each journaled action's kind, replica, outcome and wall seconds
    from its ``begin`` to its terminal phase."""
    begins: Dict[int, Dict] = {}
    out = []
    for e in ((jobj or {}).get("body") or {}).get("actions") or ():
        if e.get("phase") == "begin":
            begins[e["seq"]] = e
        elif e.get("phase") in ("commit", "rollback") and \
                e.get("seq") in begins:
            b = begins[e["seq"]]
            out.append({"seq": e["seq"], "action": b.get("action"),
                        "replica": b.get("replica"),
                        "phase": e["phase"],
                        "reason": e.get("reason") or e.get("resumed"),
                        "wall_s": round(e["t_unix"] - b["t_unix"], 3)})
    return out


def _reap_stranded(report: ChaosReport, journal: str) -> None:
    """After the final graceful stop no serving process may still carry
    the journal's marker; any found is counted and killed."""
    from ..serving.autoscaler import scan_marked_replicas
    time.sleep(1.0)  # let SIGTERMed replicas finish exiting
    stranded = scan_marked_replicas(journal)
    report.stranded_processes = len(stranded)
    if stranded:
        report.details.append({"stranded": stranded})
        for info in stranded.values():  # never leave them behind
            try:
                os.kill(info["pid"], signal.SIGKILL)
            except OSError:
                pass


def run_autoscale_chaos(requests: int = 8, seed: int = 0,
                        model: str = "gpt_tiny", page_size: int = 8,
                        max_seq_len: int = 96, num_slots: int = 2,
                        max_new_tokens: int = 6,
                        prompt_len_range=(18, 34),
                        hold_s: float = 3.0,
                        request_timeout_s: float = 300.0,
                        drain_timeout_s: float = 120.0,
                        device: str = "cuda",
                        log_dir: Optional[str] = None) -> ChaosReport:
    """INVARIANT 7: SIGKILL the SUPERVISOR itself mid-scale-action, once
    mid-SPAWN (journal ``begin`` + process launched, not committed) and
    once mid-SCALE-DOWN (victim marked draining, drain not yet run),
    under keyed traffic; restart it on the same journal, and hold the
    crash-safety contract end to end:

    - no stranded replica: after the final graceful stop, no serving
      process carries the journal's env marker;
    - no lost chains: every keyed request (retried while its front door
      was down) and a re-issue of every key after recovery return the
      reference tokens;
    - zero leaked pages and a clean ledger on every member at the end;
    - typed termination for every request;
    - the journal lints strictly clean after recovery (crc, monotonic
      seqs, every ``begin`` resolved) and the supervisor's autoscale
      flight bundles lint clean.

    The kill window comes from ``PT_AUTOSCALE_HOLD_S``: every scale
    action sleeps ``hold_s`` between its journal record and its commit
    path, so a kill half a hold after forcing lands inside the
    journaled-but-uncommitted span; a restarted supervisor whose
    recovery found no open action of the kind killed counts an
    ``arming_failures`` (the kill missed its window). ``prompt_len_range`` (tokens) should
    cover at least two full pages, so the scale-down's handoff carries
    chains."""
    import numpy as np

    from ..serving.supervisor import _free_port

    t_start = time.monotonic()
    rng = np.random.default_rng(seed)
    prompts = _prompts(rng, requests, *prompt_len_range)
    max_new = [max_new_tokens] * requests
    keys = [f"autoscale-{seed}-{i}" for i in range(requests)]

    log_dir = os.path.abspath(
        log_dir or tempfile.mkdtemp(prefix="pt-chaos-autoscale-"))
    os.makedirs(log_dir, exist_ok=True)
    # the supervisor's --journal and the stranded scan name this one
    # absolute path (the env marker is compared as a string)
    journal = os.path.join(log_dir, "fleet-journal.json")
    rport = _free_port()
    fleet = _CliFleet(
        _supervisor_cmd(model, 1, rport, log_dir, journal, 1, 0.5,
                        _server_args(device, page_size, max_seq_len,
                                     num_slots)),
        hold_s, log_dir, rport, journal)
    report = ChaosReport(requests=requests)
    outcomes: List[Optional[Dict]] = [None] * requests

    def client(i: int) -> None:
        outcomes[i] = fleet.generate(
            {"op": "generate", "prompt": [int(t) for t in prompts[i]],
             "max_new_tokens": max_new[i], "stream": bool(i % 2),
             "key": keys[i], "deadline_ms": int(request_timeout_s * 500)},
            request_timeout_s)

    fleet.launch()
    try:
        # the oracle runs while the fleet boots (no fault is armed
        # before the first kill)
        expected = _reference_outputs(model, prompts, max_new, page_size,
                                      max_seq_len, device)
        fleet.wait_router(min_live=1)

        # ---- phase A: SIGKILL mid-SPAWN under keyed traffic ----------
        wave1 = _run_clients(range(requests // 2), client)
        fleet.force({"op": "autoscale", "action": "scale_up"}, 60.0)
        # half a hold after forcing: the journal holds begin+launched
        # for the spawn, the commit has not happened
        time.sleep(hold_s * 0.5)
        fleet.kill_and_restart(min_live=1)
        report.recoveries += 1
        _check_armed(report, fleet, "spawn", "phase_a")
        for t in wave1:
            t.join(timeout=request_timeout_s)

        # >= 2 members before the scale-down phase (the phase-A spawn
        # may have been adopted and committed OR rolled back; a refusal
        # like at_max is fine as long as 2 end up live)
        t0 = time.monotonic()
        up = fleet.op({"op": "autoscale", "action": "scale_up"},
                      timeout_s=240.0)
        fleet.wait_router(min_live=2)
        report.details.append({"scale_up": (up.get("result") or {})
                               .get("reason", up.get("error")),
                               "scale_up_s": round(time.monotonic() - t0,
                                                   3)})

        # ---- phase B: SIGKILL mid-SCALE-DOWN under keyed traffic -----
        wave2 = _run_clients(range(requests // 2, requests), client)
        fleet.force({"op": "autoscale", "action": "scale_down"}, 60.0)
        time.sleep(hold_s * 0.5)
        fleet.kill_and_restart(min_live=1)
        report.recoveries += 1
        _check_armed(report, fleet, "drain", "phase_b")
        # the resumed drain resolves when nothing is pending or in
        # flight and the journal has no open action left
        deadline = time.monotonic() + drain_timeout_s
        resolved = False
        while time.monotonic() < deadline and not resolved:
            asc = fleet.op({"op": "autoscale"}).get("autoscaler") or {}
            resolved = (asc.get("pending_resumes") == 0
                        and not asc.get("action_in_flight")
                        and fleet.journal_clean())
            if not resolved:
                time.sleep(0.5)
        if not resolved:
            report.journal_lint_failures += 1
            report.details.append(
                {"journal": "open actions never resolved after "
                            "recovery"})
        for t in wave2:
            t.join(timeout=request_timeout_s)

        _tally(report, outcomes, lambda i, got: got == expected[i])
        _reissue(report, fleet, prompts, max_new, keys, expected,
                 request_timeout_s)
        _final_checks(report, fleet, drain_timeout_s)
    finally:
        fleet.stop()
    _reap_stranded(report, journal)
    report.wall_s = round(time.monotonic() - t_start, 3)
    if not report.ok:
        report.details.append({"log_dir": log_dir})
    return report


def run_roll_chaos(requests: int = 8, seed: int = 0,
                   model: str = "gpt_tiny", page_size: int = 8,
                   max_seq_len: int = 96, num_slots: int = 2,
                   max_new_tokens: int = 6,
                   prompt_len_range=(18, 34),
                   hold_s: float = 4.0,
                   request_timeout_s: float = 300.0,
                   drain_timeout_s: float = 120.0,
                   converge_timeout_s: float = 300.0,
                   device: str = "cuda",
                   log_dir: Optional[str] = None) -> ChaosReport:
    """INVARIANT 9: interrupt a live rolling weight upgrade every way the
    journal must survive, under keyed traffic:

    - phase A, SIGKILL the SUPERVISOR mid-roll: force ``roll_fleet``
      toward a new checkpoint, kill the supervisor inside the
      journaled-but-uncommitted span (``PT_AUTOSCALE_HOLD_S`` holds
      every roll action between its journal begin and its swap), restart
      it on the same journal: the fleet converges to exactly one weight
      generation, forward if the canary proved the checkpoint, back to
      the journal's committed config otherwise;
    - phase B, a corrupt checkpoint: a roll whose checkpoint fails its
      crc manifest is refused typed (``canary_swap_failed``) with zero
      replicas changed;
    - phase C, SIGKILL a REPLICA mid-roll: the roll still converges the
      whole fleet (the dead replica respawns on the new committed
      config) and reports ok;
    - throughout: typed termination; completed mid-roll outputs equal
      SOME generation's reference, never a hybrid; after convergence
      every key re-issued equals the converged generation's reference;
      zero leaks and clean ledgers; journal and bundles lint clean; no
      stranded process.

    The fleet boots from generation 0's checkpoint while this process
    makes generation 1, its torn copy (hard links but for the torn
    shard) and both generations' reference tokens; the checkpoints lie
    under ``log_dir`` and are deleted when the run ends."""
    import shutil

    import numpy as np

    from ..distributed.resilience import ResilientCheckpointManager
    from ..models.gpt import (checkpoint_state, load_jax_state,
                              perturbed_state)
    from ..serving.server import build_model
    from ..serving.supervisor import _free_port

    t_start = time.monotonic()
    rng = np.random.default_rng(seed)
    # long keyed prompts: the pre-swap handoff carries state, and the
    # generation-salted chain keys meet real cached prefixes
    prompts = _prompts(rng, requests, *prompt_len_range)
    max_new = [max_new_tokens] * requests
    keys = [f"roll-{seed}-{i}" for i in range(requests)]

    log_dir = os.path.abspath(
        log_dir or tempfile.mkdtemp(prefix="pt-chaos-roll-"))
    os.makedirs(log_dir, exist_ok=True)
    journal = os.path.join(log_dir, "fleet-journal.json")
    ckpt_a = os.path.join(log_dir, "ckpt-a")
    ckpt_b = os.path.join(log_dir, "ckpt-b")
    ckpt_bad = os.path.join(log_dir, "ckpt-bad")

    # ---- generation 0 on disk: the fleet boots from it --------------
    # generation 0 is the deterministic boot build, so replicas spawned
    # without a checkpoint and replicas restored from ckpt_a serve the
    # same tokens
    base = build_model(model, device)
    state_a = checkpoint_state(base)
    t0 = time.monotonic()
    ResilientCheckpointManager(ckpt_a).save(1, state_a)
    walls: Dict[str, float] = {"save_s": round(time.monotonic() - t0, 3)}

    rport = _free_port()
    # cooldown parked high AND min == the boot size: a pressure-driven
    # scale-down must not eat a member mid-run (a 1-replica fleet is
    # one generation trivially), so every journal entry of this run is
    # recovery or a roll
    fleet = _CliFleet(
        _supervisor_cmd(model, 2, rport, log_dir, journal, 2, 3600.0,
                        _server_args(device, page_size, max_seq_len,
                                     num_slots), checkpoint=ckpt_a),
        hold_s, log_dir, rport, journal)
    report = ChaosReport(requests=requests)
    outcomes: List[Optional[Dict]] = [None] * requests
    refs: Dict[int, List[List[int]]] = {}

    def second_generation() -> None:
        """Generation 1 (``perturbed_state`` of generation 0) on disk, a
        torn copy of it, and both generations' reference tokens: made
        while the fleet boots."""
        state_b = perturbed_state(state_a, scale=1e-3, seed=seed + 1)
        t0 = time.monotonic()
        ResilientCheckpointManager(ckpt_b).save(1, state_b)
        walls["save_s"] += round(time.monotonic() - t0, 3)
        # the torn copy shares every shard with ckpt_b but one, which
        # is torn AFTER its crc was manifested: the swap's
        # validate-before-apply must refuse this checkpoint typed
        shutil.copytree(ckpt_b, ckpt_bad, copy_function=os.link)
        step_dir = os.path.join(ckpt_bad, "step_00000001")
        shard = os.path.join(step_dir, sorted(
            f for f in os.listdir(step_dir) if f.endswith(".npy"))[0])
        os.unlink(shard)
        shutil.copyfile(os.path.join(ckpt_b, "step_00000001",
                                     os.path.basename(shard)), shard)
        with open(shard, "r+b") as f:
            f.seek(max(0, os.path.getsize(shard) // 2))
            f.write(b"\xff" * 16)
        refs[0] = _greedy(base, prompts, max_new, page_size, max_seq_len)
        load_jax_state(base, state_b)
        refs[1] = _greedy(base, prompts, max_new, page_size, max_seq_len)

    def client(i: int) -> None:
        outcomes[i] = fleet.generate(
            {"op": "generate", "prompt": [int(t) for t in prompts[i]],
             "max_new_tokens": max_new[i], "stream": bool(i % 2),
             "key": keys[i], "deadline_ms": int(request_timeout_s * 500)},
            request_timeout_s)

    def wait_converged(label: str, timeout_s: float) -> Optional[int]:
        """Until every live replica reports ONE generation (>= 2 live:
        convergence means the whole fleet), no resume is pending, and
        the journal lints with zero open actions: the generation, or
        None."""
        deadline = time.monotonic() + timeout_s
        last: Dict = {}
        while time.monotonic() < deadline:
            fl = fleet.op({"op": "fleet_stats"}).get("fleet") or {}
            gens = fl.get("weight_generations")
            live = fleet.op({"op": "health"}, timeout_s=5.0).get("live", 0)
            asc = fleet.op({"op": "autoscale"}).get("autoscaler") or {}
            last = {"gens": gens, "live": live,
                    "pending": asc.get("pending_resumes"),
                    "in_flight": asc.get("action_in_flight")}
            if (isinstance(gens, list) and len(gens) == 1 and live >= 2
                    and asc.get("pending_resumes") == 0
                    and not asc.get("action_in_flight")
                    and fleet.journal_clean()):
                return int(gens[0])
            time.sleep(0.5)
        report.generation_failures += 1
        report.details.append({"converge": label, "state": last})
        return None

    def accept(i: int, got) -> bool:
        # a request completed mid-roll may carry EITHER generation's
        # weights; never a cross-spliced hybrid
        if any(got == r[i] for r in refs.values()):
            return True
        report.details.append({"hybrid_output": i})
        return False

    t0 = time.monotonic()
    fleet.launch()
    try:
        second_generation()
        del base, state_a
        _free_device_memory()
        fleet.wait_router(min_live=2)
        walls["boot_s"] = round(time.monotonic() - t0, 3)

        # ---- phase A: SIGKILL the supervisor mid-roll ---------------
        t0 = time.monotonic()
        wave1 = _run_clients(range(requests // 2), client)
        fleet.force({"op": "roll", "checkpoint": ckpt_b,
                     "generation": 1}, 600.0)
        # half a hold after forcing: the canary's roll action is
        # journaled (begin, maybe handoff) but the swap has not run
        time.sleep(hold_s * 0.5)
        fleet.kill_and_restart(min_live=2)
        report.recoveries += 1
        _check_armed(report, fleet, "roll", "phase_a")
        for t in wave1:
            t.join(timeout=request_timeout_s)
        g1 = wait_converged("phase_a", converge_timeout_s)
        walls["phase_a_s"] = round(time.monotonic() - t0, 3)
        if g1 is not None and g1 not in refs:
            report.generation_failures += 1
            report.details.append({"phase_a_generation": g1})
            g1 = None

        # ---- phase B: corrupt checkpoint refused typed --------------
        if g1 is not None:
            t0 = time.monotonic()
            rr = (fleet.op({"op": "roll", "checkpoint": ckpt_bad,
                            "generation": 9}, timeout_s=600.0)
                  .get("roll") or {})
            walls["phase_b_s"] = round(time.monotonic() - t0, 3)
            gens = (fleet.op({"op": "fleet_stats"}).get("fleet") or {}) \
                .get("weight_generations")
            if (rr.get("ok") is not False
                    or rr.get("refused") != "canary_swap_failed"
                    or gens != [g1]):
                report.generation_failures += 1
                report.details.append(
                    {"corrupt_roll": {"report": rr, "gens": gens}})

        # ---- phase C: SIGKILL a replica mid-roll --------------------
        g2 = None
        if g1 is not None:
            from ..serving.autoscaler import scan_marked_replicas
            t0 = time.monotonic()
            ckpt_c = ckpt_b if g1 == 0 else ckpt_a
            refs[2] = refs[1] if g1 == 0 else refs[0]
            wave2 = _run_clients(range(requests // 2, requests), client)
            roller = fleet.force({"op": "roll", "checkpoint": ckpt_c,
                                  "generation": 2}, 600.0)
            # 1.5 holds in: the canary has (usually) committed and a
            # follower sits in its journaled pre-swap window; kill the
            # HIGHEST-idx marked replica (the canary is the lowest live
            # idx), forcing the respawn-forward path
            time.sleep(hold_s * 1.5)
            marked = scan_marked_replicas(journal)
            if marked:
                try:
                    os.kill(marked[max(marked)]["pid"], signal.SIGKILL)
                except OSError:
                    pass
            roller.join(timeout=600.0)
            for t in wave2:
                t.join(timeout=request_timeout_s)
            g2 = wait_converged("phase_c", converge_timeout_s)
            walls["phase_c_s"] = round(time.monotonic() - t0, 3)
            if g2 is not None and g2 != 2:
                report.generation_failures += 1
                report.details.append({"phase_c_generation": g2})
                g2 = None

        _tally(report, outcomes, accept)
        # after convergence every key equals the CONVERGED generation
        # (old-generation cached prefixes miss by construction)
        if g2 is not None:
            _reissue(report, fleet, prompts, max_new, keys, refs[2],
                     request_timeout_s)
        _final_checks(report, fleet, drain_timeout_s)
    finally:
        fleet.stop()
        for d in (ckpt_a, ckpt_b, ckpt_bad):
            shutil.rmtree(d, ignore_errors=True)
    _reap_stranded(report, journal)
    report.details.append({"walls": walls})
    report.wall_s = round(time.monotonic() - t_start, 3)
    if not report.ok:
        report.details.append({"log_dir": log_dir})
    return report


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="seeded chaos run against the port's crash-safe "
                    "serving stack; exit 0 iff every invariant held")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--model", default="gpt_tiny")
    parser.add_argument("--no-kill", action="store_true",
                        help="skip the replica SIGKILL")
    parser.add_argument("--faults", default=DEFAULT_REPLICA_FAULTS,
                        help="PT_FAULT_INJECT schedule for replicas "
                             "('' = none)")
    parser.add_argument("--device", default="cuda",
                        help="the replicas' (and the reference engine's) "
                             "torch device (default cuda; 'cpu' runs the "
                             "plain versions of the kernels)")
    parser.add_argument("--log-dir", default=None)
    parser.add_argument(
        "--multi-step", type=int, default=1, metavar="N",
        help="every replica's engine runs N decode iterations a launch; "
             "1 = per-token decode")
    parser.add_argument(
        "--speculate", type=int, default=0, metavar="K",
        help="every replica speculates with the n-gram draft at k=K "
             "(0 = off)")
    parser.add_argument(
        "--prefill-chunk", type=int, default=0, metavar="TOKENS",
        help="every replica prefills in chunks of TOKENS (0 = whole)")
    parser.add_argument(
        "--disagg", action="store_true",
        help="run INVARIANT 6 instead: 1 prefill + 1 decode replica, "
             "keyed long-prompt handoff traffic, SIGKILL the prefill "
             "replica mid-handoff")
    parser.add_argument(
        "--fleet-cache-chaos", action="store_true",
        help="run INVARIANT 8 instead: keyed shared-prefix traffic on "
             "fleet-cache fetch_from hints, SIGKILL the advertising peer "
             "mid-fetch")
    parser.add_argument(
        "--roll-chaos", action="store_true",
        help="run INVARIANT 9 instead: SIGKILL the supervisor mid rolling "
             "weight upgrade and a replica mid-roll, plus a corrupt "
             "checkpoint roll; the fleet converges to one generation")
    parser.add_argument(
        "--autoscale-chaos", action="store_true",
        help="run INVARIANT 7 instead: SIGKILL the supervisor mid-spawn "
             "and mid-scale-down, restart it on the fleet journal; no "
             "stranded replica, no lost chain, the journal lints clean")
    args = parser.parse_args(argv)

    common = dict(requests=args.requests, seed=args.seed, model=args.model,
                  device=args.device, log_dir=args.log_dir)
    if args.fleet_cache_chaos:
        report = run_fleet_cache_chaos(**common)
    elif args.roll_chaos:
        report = run_roll_chaos(**common)
    elif args.autoscale_chaos:
        report = run_autoscale_chaos(**common)
    elif args.disagg:
        report = run_disagg_chaos(**common)
    else:
        extra = []
        if args.multi_step > 1:
            extra += ["--multi-step", str(args.multi_step)]
        if args.speculate > 0:
            extra += ["--speculate", str(args.speculate)]
        if args.prefill_chunk > 0:
            extra += ["--prefill-chunk", str(args.prefill_chunk)]
        report = run_chaos(replicas=args.replicas,
                           replica_faults=args.faults or None,
                           kill_replica=not args.no_kill,
                           extra_server_args=extra or None, **common)
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
