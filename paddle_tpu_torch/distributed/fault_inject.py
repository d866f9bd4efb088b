"""Deterministic fault injection for the serving path (port of
``paddle_tpu/distributed/fault_inject.py``).

Named sites raise (or, for the spill write, corrupt) on an armed
schedule, so every recovery path of the serving stack is testable on the
CPU. The port fires eleven of the JAX package's sites:

==================== =================================================
site                 where it fires
==================== =================================================
engine.step          inference/continuous_batching engine step, FIRST
                     thing — before admission and any launch, so host
                     and device state are untouched; persistent firing
                     drives the server's engine-resurrection path
serving.prefill      engine admission prefill (retried per the
                     serving.prefill policy; exhausted retries unwind
                     and requeue, then FAIL the request typed)
serving.verify       the engine's speculative draft-and-verify step
                     (retried per the serving.verify policy; fires
                     before the verify forward writes a pool)
alloc.page           PageAllocator alloc/reserve (before any free-list
                     mutation); admission unwinds and requeues
cache.spill          serving/prefix_cache.py spill-tier blob write
                     (eviction) and read (restore); "torn" corrupts the
                     written blob so the restore-side crc32 must catch
                     it — either way the page degrades to a cache miss
serving.request      serving/server.py per-request front-end handling
net.recv             serving/server.py connection reader
checkpoint.write     resilience.ResilientCheckpointManager.save; "torn"
                     truncates a shard after its crc32 was recorded
checkpoint.read      ResilientCheckpointManager.restore
checkpoint.load      the server's swap op and --checkpoint boot (load +
                     validate on the calling thread, retried)
swap.apply           engine swap_weights, after validation and before
                     the first tensor write
dataloader.fetch     io.DataLoader's batch assembly in a worker
                     (retried per the stock policy)
==================== =================================================

Default-OFF: with no site armed, ``fault_point`` is one module-bool
read. Arm programmatically::

    inj = get_injector()
    inj.arm("engine.step", at_calls=[3, 4])
    inj.arm("cache.spill", probability=0.2, max_faults=3, seed=7)

or from the environment (read once, at the first ``get_injector()``),
with the JAX package's variables so a deployment's chaos settings carry
over::

    PT_FAULT_INJECT="engine.step:at=3|4;cache.spill:p=0.2,max=3,mode=torn"
    PT_FAULT_SEED=7

Schedules are deterministic: probabilistic firing draws from a per-site
numpy Generator seeded at arm time, and ``at_calls`` fires on exact
1-based call indices.

The injector is process-global: a caller that arms a site must
``reset()`` afterwards, or every later engine in the process is hit.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional

import numpy as np

# The sites the port fires. Each has a retry disposition in
# distributed/resilience.py, the same as in the JAX package: a
# _BUILTIN_SITE_POLICIES entry or a NO_RETRY_SITES reason.
FAULT_SITES: Dict[str, str] = {
    "serving.request": "serving front-end per-request handling",
    "serving.prefill": "decode-engine admission prefill",
    "serving.verify": "speculative draft-and-verify step",
    "engine.step": "decode-engine step (pre-admission, pre-launch)",
    "alloc.page": "page-allocator alloc/reserve (pre-mutation)",
    "net.recv": "connection receive (server)",
    "cache.spill": "prefix-cache spill-tier blob write/read "
                   "(serving/prefix_cache.py; write side implements "
                   "'torn' — a corrupted blob the restore-side crc32 "
                   "must catch; either side degrades to a cache miss "
                   "and the chained-prefill fallback recomputes)",
    "checkpoint.write": "durable checkpoint save (the manager)",
    "checkpoint.read": "checkpoint restore (the manager)",
    "checkpoint.load": "hot-swap checkpoint load+validate (serving "
                       "swap op, conn thread; transient IO faults "
                       "retry via the builtin policy, a persistent/"
                       "corrupt load fails as a typed SwapFailed "
                       "with the old weights still serving)",
    "dataloader.fetch": "dataloader worker batch assembly",
    "swap.apply": "engine weight-swap apply (fires after validation, "
                  "before the first tensor write — an abort here "
                  "proves the all-or-nothing swap contract)",
}

# False whenever no injector exists or no site is armed, so an unarmed
# fault_point() costs one global read
_ACTIVE = False
_GLOBAL: Optional["FaultInjector"] = None
_LOCK = threading.Lock()

# "abort" raises InjectedFault at the site; "torn" asks the site to
# complete a corrupted write and report success (sites declare it
# through ``modes``; elsewhere it degrades to abort)
MODE_ABORT = "abort"
MODE_TORN = "torn"


class InjectedFault(ConnectionError):
    """Raised by an armed fault site. A ConnectionError, so the default
    RetryPolicy retries it as a transient."""

    def __init__(self, site: str, index: int, mode: str = MODE_ABORT):
        super().__init__(
            f"injected fault at site {site!r} (call #{index}, {mode})")
        self.site = site
        self.index = index
        self.mode = mode


@dataclass
class FaultSpec:
    """Arming schedule for one site."""

    probability: float = 0.0
    at_calls: FrozenSet[int] = frozenset()  # 1-based call indices
    max_faults: Optional[int] = None
    mode: str = MODE_ABORT
    exc: Optional[type] = None  # exception class; default InjectedFault
    seed: int = 0
    calls: int = 0
    fired: int = 0
    _rng: np.random.Generator = field(default=None, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def should_fire(self) -> bool:
        self.calls += 1
        if self.max_faults is not None and self.fired >= self.max_faults:
            return False
        if self.calls in self.at_calls:
            return True
        if self.probability > 0.0 and \
                self._rng.random() < self.probability:
            return True
        return False


class FaultInjector:
    """Registry of armed sites; ``fire`` is the hot entry point."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._specs: Dict[str, FaultSpec] = {}
        self._lock = threading.Lock()
        self.log: List[InjectedFault] = []

    def arm(self, site: str, probability: float = 0.0, at_calls=(),
            max_faults: Optional[int] = None, mode: str = MODE_ABORT,
            exc: Optional[type] = None, seed: Optional[int] = None
            ) -> "FaultInjector":
        global _ACTIVE
        with self._lock:
            self._specs[site] = FaultSpec(
                probability=probability,
                at_calls=frozenset(int(c) for c in at_calls),
                max_faults=max_faults, mode=mode, exc=exc,
                seed=self.seed if seed is None else seed)
        _ACTIVE = True
        return self

    def disarm(self, site: Optional[str] = None) -> None:
        global _ACTIVE
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)
            if not self._specs:
                _ACTIVE = False

    def armed(self, site: str) -> bool:
        return site in self._specs

    def counts(self, site: str) -> Dict[str, int]:
        spec = self._specs.get(site)
        return {"calls": spec.calls, "fired": spec.fired} if spec else \
            {"calls": 0, "fired": 0}

    def fire(self, site: str,
             modes: tuple = (MODE_ABORT,)) -> Optional[str]:
        """Consult the site's schedule. Raises on an "abort" fault;
        returns the mode for a non-abort mode the site declares in
        ``modes``; a mode the site does not implement degrades to
        abort. Returns None when nothing fires."""
        with self._lock:
            spec = self._specs.get(site)
            if spec is None or not spec.should_fire():
                return None
            spec.fired += 1
            # log a fresh instance, never the raised one: a raised
            # exception's traceback would pin every frame of the
            # faulting stack for the injector's lifetime
            logged = InjectedFault(site, spec.calls, spec.mode)
            self.log.append(logged)
            if spec.mode == MODE_ABORT or spec.mode not in modes:
                if spec.exc is not None:
                    raise spec.exc(str(logged))
                raise InjectedFault(site, spec.calls, spec.mode)
            return spec.mode

    def configure_from_env(self, env=None) -> "FaultInjector":
        """Parse ``PT_FAULT_INJECT``: ``site:k=v,k=v;site2:...`` with
        keys p (probability), at (``|``-separated call indices), max,
        mode, seed."""
        env = os.environ if env is None else env
        raw = env.get("PT_FAULT_INJECT", "").strip()
        if not raw:
            return self
        for entry in raw.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            site, _, spec = entry.partition(":")
            kw: Dict = {}
            for kv in filter(None, spec.split(",")):
                k, _, v = kv.partition("=")
                k, v = k.strip(), v.strip()
                if k == "p":
                    kw["probability"] = float(v)
                elif k == "at":
                    kw["at_calls"] = [int(x) for x in v.split("|") if x]
                elif k == "max":
                    kw["max_faults"] = int(v)
                elif k == "mode":
                    kw["mode"] = v
                elif k == "seed":
                    kw["seed"] = int(v)
            self.arm(site.strip(), **kw)
        return self


def get_injector() -> FaultInjector:
    """The process-wide injector (created on first use; env-armed)."""
    global _GLOBAL
    with _LOCK:
        if _GLOBAL is None:
            _GLOBAL = FaultInjector(
                seed=int(os.environ.get("PT_FAULT_SEED", "0")))
            _GLOBAL.configure_from_env()
    return _GLOBAL


def reset() -> None:
    """Drop the global injector: no site stays armed."""
    global _GLOBAL, _ACTIVE
    with _LOCK:
        _GLOBAL = None
        _ACTIVE = False


def fault_point(site: str, modes: tuple = (MODE_ABORT,)
                ) -> Optional[str]:
    """Injection site hook: a no-op (one bool read) unless a site is
    armed anywhere in the process. ``modes`` declares which non-abort
    modes this site implements; anything else raises InjectedFault."""
    if not _ACTIVE:
        return None
    return get_injector().fire(site, modes)


# a process launched with PT_FAULT_INJECT set is armed without an
# explicit get_injector() call (the sites only read _ACTIVE)
if os.environ.get("PT_FAULT_INJECT", "").strip():
    get_injector()
