"""The port's chaos harness (``paddle_tpu_torch/tools/chaos_serving.py``)
at gpt_tiny on the CPU, and a live autoscaled fleet (JAX
``tests/test_autoscaler.py`` ``TestAutoscalerLive``, and the invariant 9
run of ``tests/test_hot_swap.py``, on the port).

Every replica is ``python -m paddle_tpu_torch.serving.server --device
cpu`` with ``OMP_NUM_THREADS=1`` set in this process's environment, which
the harness hands to the supervisors it starts and they to their
replicas. These runs SIGKILL supervisors on purpose, orphaning their
replicas; the repo's stray-process guard does not match the port's
module names, so each test reaps what it started: its teardown SIGKILLs
every serving process of the port that carries its journal marker or
names its log directory, and then asserts that none was found.
"""

import _torch_threads  # noqa: F401

import json
import os
import signal
import time

import numpy as np
import pytest

from paddle_tpu_torch.serving.autoscaler import (AutoscaleConfig,
                                                 Autoscaler, JOURNAL_ENV,
                                                 _proc_cmdline,
                                                 _proc_environ)
from paddle_tpu_torch.serving.server import client_request
from paddle_tpu_torch.serving.supervisor import FailoverRouter, Supervisor
from paddle_tpu_torch.tools import chaos_serving as chaos
from paddle_tpu_torch.tools import flight_inspect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_processes_under(root):
    """Pids of the port's serving processes (servers, supervisors) that
    carry a journal marker under ``root``, name it on their command line
    or hold a file open under it (a replica's log)."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        pid = int(name)
        cmd = _proc_cmdline(pid)
        if "paddle_tpu_torch.serving." not in cmd:
            continue
        hit = root in cmd or \
            _proc_environ(pid).get(JOURNAL_ENV, "").startswith(root)
        if not hit:
            try:
                fds = os.listdir(f"/proc/{pid}/fd")
            except OSError:
                fds = []
            for fd in fds:
                try:
                    if os.readlink(f"/proc/{pid}/fd/{fd}").startswith(root):
                        hit = True
                        break
                except OSError:
                    continue
        if hit:
            found.append(pid)
    return found


@pytest.fixture
def chaos_dir(tmp_path, monkeypatch):
    """The run's log directory; one intra-op thread in every process the
    run starts; a 240 s limit; the reaper."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    root = str(tmp_path / "run")

    def expire(signum, frame):
        raise TimeoutError("chaos test over its 240 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(240)
    try:
        yield root
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)
        left = _port_processes_under(root)
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        assert left == [], f"processes left behind: {left}"


def _assert_ok(report):
    assert report.ok, json.dumps(report.to_dict(), indent=1)[:6000]


def test_run_chaos_kill_replica(chaos_dir):
    report = chaos.run_chaos(replicas=2, requests=10, seed=0,
                             kill_replica=True, device="cpu",
                             log_dir=chaos_dir)
    _assert_ok(report)
    assert report.supervisor_restarts >= 1
    assert report.engine_restarts >= 1 and report.flight_bundles >= 1
    assert report.replicas_checked == 2


def test_run_autoscale_chaos(chaos_dir):
    """Invariant 7: the supervisor SIGKILLed mid-spawn and mid-scale-down
    and restarted on its journal."""
    report = chaos.run_autoscale_chaos(requests=6, seed=0, device="cpu",
                                       log_dir=chaos_dir)
    _assert_ok(report)
    assert report.recoveries == 2
    assert report.stranded_processes == 0
    assert report.journal_lint_failures == 0
    assert report.completed + report.typed_errors == 6
    walls = next(d for d in report.details if "journal_actions" in d)
    assert len(walls["restart_to_serving_s"]) == 2
    acts = [(a["action"], a["phase"]) for a in walls["journal_actions"]]
    assert ("drain", "commit") in acts and ("spawn", "commit") in acts


def test_run_roll_chaos(chaos_dir):
    """Invariant 9: the supervisor SIGKILLed mid-roll, a corrupt
    checkpoint, a replica SIGKILLed mid-roll."""
    report = chaos.run_roll_chaos(requests=6, seed=0, device="cpu",
                                  log_dir=chaos_dir)
    _assert_ok(report)
    assert report.recoveries == 1 and report.generation_failures == 0
    assert not any(d.startswith("ckpt-") for d in os.listdir(chaos_dir))


def test_run_disagg_chaos(chaos_dir):
    report = chaos.run_disagg_chaos(requests=6, seed=0, device="cpu",
                                    log_dir=chaos_dir)
    _assert_ok(report)
    assert report.supervisor_restarts >= 1


def test_run_fleet_cache_chaos(chaos_dir):
    report = chaos.run_fleet_cache_chaos(requests=6, seed=0, device="cpu",
                                         log_dir=chaos_dir)
    _assert_ok(report)
    assert report.arming_failures == 0


def test_autoscaled_fleet_keyed_tokens_across_scale_events(chaos_dir):
    """A live autoscaled fleet keeps keyed greedy outputs bitwise the
    in-process engine's before a scale-up, after it, and after the
    scale-down that follows (chains stay where the rendezvous put them
    or are handed to a survivor); the journal holds a spawn and a drain
    and lints clean."""
    rng = np.random.default_rng(0)
    prompts = [np.asarray(rng.integers(1, 100, size=20), np.int32)
               for _ in range(4)]
    expected = chaos._reference_outputs("gpt_tiny", prompts, [5] * 4, 8,
                                        96, device="cpu")
    sup = Supervisor(
        model="gpt_tiny", replicas=1,
        server_args=["--device", "cpu", "--page-size", "8",
                     "--max-seq-len", "96", "--num-slots", "2"],
        replica_env={"PYTHONPATH": REPO}, probe_interval_s=0.3,
        backoff_base_s=0.5, log_dir=os.path.join(chaos_dir, "logs"))
    asc = Autoscaler(sup, AutoscaleConfig(min_replicas=1, max_replicas=2,
                                          cooldown_up_s=0.0,
                                          cooldown_down_s=0.0),
                     journal_path=os.path.join(chaos_dir, "j.json"))
    router = None
    try:
        sup.start(wait_ready=True)
        router = FailoverRouter(sup, port=0)
        port = router.start()

        def run_all():
            outs = []
            for i, p in enumerate(prompts):
                r = client_request("127.0.0.1", port,
                                   {"op": "generate",
                                    "prompt": [int(t) for t in p],
                                    "max_new_tokens": 5,
                                    "key": f"asl-{i}"}, timeout_s=180.0)
                assert not r.get("error"), r
                outs.append(r["generated"])
            return outs

        assert run_all() == expected
        t0 = time.monotonic()
        up = asc.scale_up(reason="test", force=True)
        assert up["ok"] is True, up
        assert time.monotonic() - t0 < 60 and len(sup.replicas) == 2
        assert run_all() == expected
        down = asc.scale_down(reason="test", force=True)
        assert down["ok"] is True, down
        assert len(sup.replicas) == 1
        assert run_all() == expected
        obj = json.loads(open(asc.journal.path).read())
        assert flight_inspect.lint_fleet_journal(obj,
                                                 allow_open_tail=0) == []
        kinds = [a["action"] for a in asc.journal.tail(99)
                 if a.get("phase") == "begin"]
        assert kinds == ["spawn", "drain"]
        chk = client_request("127.0.0.1", sup.replicas[0].port,
                             {"op": "leak_check"}, timeout_s=30)
        assert chk.get("ok"), chk
    finally:
        if router is not None:
            router.stop()
        sup.stop()
