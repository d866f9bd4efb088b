"""Retry policies for the serving path (port of the retry half of
``paddle_tpu/distributed/resilience.py``, ``:60-287``).

``RetryPolicy`` is exponential backoff with seeded jitter and an
optional deadline; ``get_retry_policy(site)`` resolves a fault site's
policy (programmatic override > ``PT_RETRY_SITES`` > built-in site
default > ``DEFAULT_RETRY``). Each site of ``fault_inject.FAULT_SITES``
has a disposition here, as in the JAX package: a built-in policy
(``serving.prefill``, ``serving.verify``) or a ``NO_RETRY_SITES`` reason naming who owns
recovery.

``PT_RETRY_SITES``: ``site:attempts=5,base=0.01,max_delay=1,mult=2,
jitter=0,timeout=3;site2:...``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

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
