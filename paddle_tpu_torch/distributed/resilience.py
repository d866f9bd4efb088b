"""Retry policies and durable checkpoints for the serving path (port of
``paddle_tpu/distributed/resilience.py`` ``:60-479``: the retry half and
``ResilientCheckpointManager``).

``RetryPolicy`` is exponential backoff with seeded jitter and an
optional deadline; ``get_retry_policy(site)`` resolves a fault site's
policy (programmatic override > ``PT_RETRY_SITES`` > built-in site
default > ``DEFAULT_RETRY``). Each site of ``fault_inject.FAULT_SITES``
has a disposition here, as in the JAX package: a built-in policy
(``serving.prefill``, ``serving.verify``) or a ``NO_RETRY_SITES`` reason naming who owns
recovery.

``PT_RETRY_SITES``: ``site:attempts=5,base=0.01,max_delay=1,mult=2,
jitter=0,timeout=3;site2:...``.

``ResilientCheckpointManager`` writes step-indexed checkpoints in the
JAX package's on-disk layout, so a directory written by either package
restores in the other::

    dir/step_00000020/
        manifest.json        # {"format": 1, "step", "shards":
                             #  {f: {crc32, size}}, "structure"}
        arr_0000.npy ...     # one np.save shard per leaf

A step is written under a ``.tmp-*`` sibling and renamed into place once
every shard and the manifest are on disk; restore checks each shard's
size and crc32 and ``restore_latest_valid`` skips a torn or partial
step. The ``HeartbeatMonitor`` and ``ResilientTrainer`` of the JAX
module belong to multi-device training and are not ported
(ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .fault_inject import MODE_TORN, fault_point

log = logging.getLogger("paddle_tpu_torch.resilience")

_TRANSIENT = (ConnectionError, OSError, TimeoutError)
# OSError subclasses that are deterministic, not transient: retrying
# them burns backoff and hides the real exception behind RetryExhausted
_NEVER_RETRY = (FileNotFoundError, PermissionError, NotADirectoryError,
                IsADirectoryError, FileExistsError)


class RetryExhausted(RuntimeError):
    """All attempts of a retried op failed; ``__cause__`` is the last
    underlying error."""

    def __init__(self, site: str, attempts: int, reason: str = ""):
        msg = f"retry exhausted after {attempts} attempt(s)"
        if site:
            msg += f" at site {site!r}"
        if reason:
            msg += f" ({reason})"
        super().__init__(msg)
        self.site = site
        self.attempts = attempts


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with seeded jitter and an optional deadline.
    ``retry_on`` lists the transient exception classes; everything else
    propagates at once. InjectedFault is a ConnectionError, so armed
    fault sites exercise this path."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25
    timeout_s: Optional[float] = None
    retry_on: tuple = _TRANSIENT
    seed: int = 0

    def preview_delays(self) -> List[float]:
        """The deterministic delays this policy would sleep (one per
        retry: max_attempts - 1 entries)."""
        rng = np.random.default_rng(self.seed)
        return [self._delay(attempt, rng)
                for attempt in range(max(0, self.max_attempts - 1))]

    def _delay(self, attempt: int, rng) -> float:
        d = min(self.base_delay_s * self.multiplier ** attempt,
                self.max_delay_s)
        return d * (1.0 + self.jitter * float(rng.random()))

    def call(self, fn: Callable, *args, site: str = "",
             on_retry: Optional[Callable] = None, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying transient failures.
        ``max_attempts`` below 1 is clamped to 1: the op runs at least
        once."""
        attempts = max(1, self.max_attempts)
        rng = np.random.default_rng(self.seed)
        deadline = (time.monotonic() + self.timeout_s
                    if self.timeout_s is not None else None)
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                if isinstance(e, _NEVER_RETRY):
                    raise  # deterministic: keep the original type
                if attempt + 1 >= attempts:
                    raise RetryExhausted(site, attempt + 1) from e
                delay = self._delay(attempt, rng)
                if deadline is not None and \
                        time.monotonic() + delay > deadline:
                    raise RetryExhausted(site, attempt + 1,
                                         "deadline exceeded") from e
                log.warning("retry %d/%d at %s after %s: sleeping %.3fs",
                            attempt + 1, self.max_attempts - 1,
                            site or "<op>", type(e).__name__, delay)
                if on_retry is not None:
                    on_retry(attempt + 1, e, delay)
                time.sleep(delay)

    @classmethod
    def from_spec(cls, spec: str, **defaults) -> "RetryPolicy":
        """Parse ``attempts=5,base=0.01,max_delay=1,mult=2,jitter=0,
        timeout=3`` (the PT_RETRY_SITES value format); a malformed entry
        is logged and skipped."""
        kw: Dict[str, Any] = dict(defaults)
        keymap = {"attempts": ("max_attempts", int),
                  "base": ("base_delay_s", float),
                  "max_delay": ("max_delay_s", float),
                  "mult": ("multiplier", float),
                  "jitter": ("jitter", float),
                  "timeout": ("timeout_s", float),
                  "seed": ("seed", int)}
        for kv in filter(None, spec.split(",")):
            k, _, v = kv.partition("=")
            entry = keymap.get(k.strip())
            if entry is None or not v:
                log.warning("PT_RETRY_SITES: ignoring malformed entry "
                            "%r (known keys: %s)", kv,
                            ", ".join(sorted(keymap)))
                continue
            name, conv = entry
            kw[name] = conv(v)
        return cls(**kw)


DEFAULT_RETRY = RetryPolicy()
NO_RETRY = RetryPolicy(max_attempts=1)

# built-in per-site policies. serving.prefill: a queued client waits on
# its TTFT, so retry promptly and give up fast enough that the engine's
# max_prefill_attempts can fail the request typed. serving.verify: every
# active slot's client waits on the speculative step, so the same
# regime; a persistent failure escalates through the server's
# engine-error cap
_BUILTIN_SITE_POLICIES: Dict[str, RetryPolicy] = {
    "serving.prefill": RetryPolicy(max_attempts=3, base_delay_s=0.02,
                                   max_delay_s=0.25),
    "serving.verify": RetryPolicy(max_attempts=3, base_delay_s=0.02,
                                  max_delay_s=0.25),
    # the checkpoint IO sites ride the stock policy; a persistent or
    # corrupt hot-swap load exhausts it and surfaces as a typed
    # SwapFailed with the old weights still serving
    "checkpoint.write": DEFAULT_RETRY,
    "checkpoint.read": DEFAULT_RETRY,
    "checkpoint.load": DEFAULT_RETRY,
    # io.DataLoader's batch assembly: a flaky filesystem read retries
    "dataloader.fetch": DEFAULT_RETRY,
}

# sites deliberately not retried in place: a higher layer owns recovery
NO_RETRY_SITES: Dict[str, str] = {
    "serving.request": "client-facing: the server answers a retryable "
                       "typed reply and the CLIENT owns the retry",
    "engine.step": "the serving loop counts consecutive failures; "
                   "recovery is engine resurrection + in-flight "
                   "replay (serving/server.py), not a per-step retry",
    "alloc.page": "admission unwinds and requeues the request; the "
                  "next engine step retries admission naturally",
    "net.recv": "connection-level: the client reconnects",
    "cache.spill": "a failed or corrupt spill blob degrades to a "
                   "prefix-cache miss and the chained-prefill "
                   "fallback recomputes the pages "
                   "(serving/prefix_cache.py)",
    "swap.apply": "the swap caller owns recovery: an abort here "
                  "surfaces as a typed SwapFailed with the old "
                  "generation still serving; a blind in-place retry "
                  "could double-apply against a live engine",
}

_site_policies: Dict[str, RetryPolicy] = {}
_env_policies: Optional[Dict[str, RetryPolicy]] = None
_policy_lock = threading.Lock()


def set_site_policy(site: str, policy: Optional[RetryPolicy]) -> None:
    """Override the retry policy for one site (None removes)."""
    with _policy_lock:
        if policy is None:
            _site_policies.pop(site, None)
        else:
            _site_policies[site] = policy


def clear_site_policies() -> None:
    with _policy_lock:
        _site_policies.clear()


def _load_env_policies() -> Dict[str, RetryPolicy]:
    global _env_policies
    if _env_policies is None:
        out: Dict[str, RetryPolicy] = {}
        raw = os.environ.get("PT_RETRY_SITES", "").strip()
        for entry in filter(None, (e.strip() for e in raw.split(";"))):
            site, _, spec = entry.partition(":")
            out[site.strip()] = RetryPolicy.from_spec(spec)
        _env_policies = out
    return _env_policies


def get_retry_policy(site: str) -> RetryPolicy:
    """Resolution order: programmatic override > PT_RETRY_SITES env >
    built-in site default > DEFAULT_RETRY."""
    with _policy_lock:
        p = _site_policies.get(site)
    if p is not None:
        return p
    env = _load_env_policies().get(site)
    if env is not None:
        return env
    return _BUILTIN_SITE_POLICIES.get(site, DEFAULT_RETRY)


def call_with_retry(site: str, fn: Callable, *args, **kwargs):
    return get_retry_policy(site).call(fn, *args, site=site, **kwargs)


# ---------------------------------------------------------------------------
# Durable checkpoints
# ---------------------------------------------------------------------------

class CheckpointCorruptError(RuntimeError):
    pass


def _flatten_tree(obj, path: str, leaves: Dict[str, np.ndarray]):
    """Encode a dict/list/tuple/array tree as a JSON structure whose
    leaves name ``.npy`` shards (``resilience.py:293-310``)."""
    if isinstance(obj, dict):
        return {"kind": "dict",
                "items": {str(k): _flatten_tree(v, f"{path}.{k}", leaves)
                          for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        kind = "list" if isinstance(obj, list) else "tuple"
        return {"kind": kind,
                "items": [_flatten_tree(v, f"{path}[{i}]", leaves)
                          for i, v in enumerate(obj)]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"kind": "scalar", "value": obj}
    name = f"arr_{len(leaves):04d}.npy"
    leaves[name] = np.asarray(obj)
    return {"kind": "leaf", "shard": name}


def _unflatten_tree(node, arrays: Dict[str, np.ndarray]):
    kind = node["kind"]
    if kind == "dict":
        return {k: _unflatten_tree(v, arrays)
                for k, v in node["items"].items()}
    if kind == "list":
        return [_unflatten_tree(v, arrays) for v in node["items"]]
    if kind == "tuple":
        return tuple(_unflatten_tree(v, arrays) for v in node["items"])
    if kind == "scalar":
        return node["value"]
    return arrays[node["shard"]]


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


class ResilientCheckpointManager:
    """Step-indexed checkpoints with atomic writes, per-shard checksums
    and keep-N rotation; restore skips anything that fails validation
    (``resilience.py:334-479``).

    A write lands in a ``.tmp-*`` sibling renamed into place once every
    shard and the manifest are on disk, so a crash mid-write never
    leaves a step directory that looks complete. A torn write that was
    renamed (the ``checkpoint.write`` site's "torn" mode, or bitrot) is
    caught at read time by the crc32 manifest and skipped by
    ``restore_latest_valid``."""

    MANIFEST = "manifest.json"

    def __init__(self, directory: str, keep_n: int = 3,
                 retry: Optional[RetryPolicy] = None):
        self.directory = os.path.abspath(directory)
        self.keep_n = max(1, int(keep_n))
        self.retry = retry
        self.last_skipped: List[int] = []
        self._seq = 0
        # steps this manager wrote cleanly: rotation skips re-reading
        # them; restore always validates from disk
        self._written_ok: set = set()
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith("step_"):
                try:
                    out.append(int(fn[5:]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> str:
        """Write ``state`` (nested dict/list/tuple of arrays and
        scalars) as checkpoint ``step``, retried per the
        ``checkpoint.write`` site policy; returns the step directory."""
        policy = self.retry or get_retry_policy("checkpoint.write")
        path = policy.call(self._write_once, step, state,
                           site="checkpoint.write")
        self._gc()
        return path

    def _write_once(self, step: int, state: Any) -> str:
        self._seq += 1
        tmp = os.path.join(
            self.directory,
            f".tmp-step_{step:08d}-{os.getpid()}-{self._seq}")
        final = self._step_dir(step)
        os.makedirs(tmp)
        try:
            leaves: Dict[str, np.ndarray] = {}
            structure = _flatten_tree(state, "", leaves)
            shards = {}
            for name, arr in leaves.items():
                p = os.path.join(tmp, name)
                with open(p, "wb") as f:
                    np.save(f, arr, allow_pickle=False)
                shards[name] = {"crc32": _crc32_file(p),
                                "size": os.path.getsize(p)}
            manifest = {"format": 1, "step": int(step),
                        "shards": shards, "structure": structure}
            with open(os.path.join(tmp, self.MANIFEST), "w") as f:
                json.dump(manifest, f)
            mode = fault_point("checkpoint.write", modes=(MODE_TORN,))
            if mode == MODE_TORN and shards:
                # a write acknowledged but landed corrupt: truncate one
                # shard after its checksum was recorded, then publish
                victim = os.path.join(tmp, sorted(shards)[0])
                with open(victim, "r+b") as f:
                    f.truncate(max(0, os.path.getsize(victim) // 2))
                self._written_ok.discard(step)
            if os.path.exists(final):
                shutil.rmtree(final)  # a retry overwriting a torn step
            os.rename(tmp, final)
            if mode != MODE_TORN:
                self._written_ok.add(step)
            return final
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _gc(self) -> None:
        steps = self.all_steps()
        doomed = steps[:-self.keep_n]
        if doomed:
            # rotation never strands the run on corrupt steps only: the
            # newest valid step survives even outside the window
            newest_valid = next(
                (s for s in reversed(steps)
                 if s in self._written_ok or self.validate(s)), None)
            for step in doomed:
                if step == newest_valid:
                    continue
                self._written_ok.discard(step)
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
        for fn in os.listdir(self.directory):
            # a stale tmp of a crashed writer; this process's own carry
            # its pid and sequence number
            if fn.startswith(".tmp-") and f"-{os.getpid()}-" not in fn:
                shutil.rmtree(os.path.join(self.directory, fn),
                              ignore_errors=True)

    def validate(self, step: int) -> bool:
        """True iff the step's manifest parses and every shard matches
        its recorded size and crc32."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, self.MANIFEST)) as f:
                manifest = json.load(f)
            for name, meta in manifest["shards"].items():
                p = os.path.join(d, name)
                if os.path.getsize(p) != meta["size"] or \
                        _crc32_file(p) != meta["crc32"]:
                    return False
            return True
        except (OSError, ValueError, KeyError):
            return False

    def restore(self, step: int) -> Any:
        """Load checkpoint ``step``; raises CheckpointCorruptError when
        validation fails."""
        fault_point("checkpoint.read")
        if not self.validate(step):
            raise CheckpointCorruptError(
                f"checkpoint step {step} at {self._step_dir(step)} is "
                "missing, partial, or fails its checksum manifest")
        d = self._step_dir(step)
        with open(os.path.join(d, self.MANIFEST)) as f:
            manifest = json.load(f)
        arrays = {name: np.load(os.path.join(d, name), allow_pickle=False)
                  for name in manifest["shards"]}
        return _unflatten_tree(manifest["structure"], arrays)

    def restore_latest_valid(self) -> Optional[Tuple[int, Any]]:
        """Walk the steps newest first, skipping corrupt or partial
        ones; returns (step, state) or None. The skipped steps are
        recorded in ``last_skipped``."""
        self.last_skipped = []
        policy = self.retry or get_retry_policy("checkpoint.read")
        for step in reversed(self.all_steps()):
            try:
                state = policy.call(self.restore, step,
                                    site="checkpoint.read")
                return step, state
            except (CheckpointCorruptError, RetryExhausted) as e:
                self.last_skipped.append(step)
                log.warning("skipping checkpoint step %d: %s", step, e)
        return None
