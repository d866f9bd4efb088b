"""The port's replica supervisor (``paddle_tpu_torch/serving/
supervisor.py``): ``tests/test_crash_safe_serving.py`` ``TestSupervisor``,
``tests/test_hot_swap.py`` ``TestSupervisorWeightConfig`` and
``tests/test_fleet_metrics.py`` ``TestFleetE2E`` on the port.

The replicas are ``python -m paddle_tpu_torch.serving.server`` processes
on gpt_tiny with ``--device cpu`` and ``OMP_NUM_THREADS=1``. Each test
that spawns processes has its own time limit (``_time_limit``) and stops
its supervisor in a ``finally``, killing any replica left.
"""

import _torch_threads  # noqa: F401

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.resilience import (
    ResilientCheckpointManager)
from paddle_tpu_torch.inference import create_decode_engine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import supervisor as sup_mod
from paddle_tpu_torch.serving.server import client_request
from paddle_tpu_torch.serving.supervisor import FailoverRouter, Supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER_ARGS = ["--device", "cpu", "--page-size", "8", "--max-seq-len",
               "96", "--num-slots", "2", "--slo-ttft-ms", "60000",
               "--slo-tpot-ms", "60000"]
REPLICA_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
               "PYTHONPATH": REPO}
PROMPT = list(range(3, 22))


@pytest.fixture
def _time_limit():
    """A test that spawns replicas fails after 150 s instead of hanging
    the worker; its ``finally`` then stops the fleet."""
    def expire(signum, frame):
        raise TimeoutError("fleet test over its 150 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(150)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def _stop(sup, router=None):
    try:
        if router is not None:
            router.stop()
    finally:
        sup.stop(grace_s=5.0)


def _wait(cond, what, timeout_s=30.0):
    end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _local_tokens(state, prompt, mnt):
    """Greedy tokens of an in-process engine on gpt_tiny with ``state``
    (None: the seed-0 weights a replica builds)."""
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    if state is not None:
        tgpt.load_jax_state(m, state)
    m.eval()
    eng = create_decode_engine(m, device="cpu", num_slots=2, page_size=8,
                               max_seq_len=96)
    try:
        rid = eng.submit(np.asarray(prompt, np.int32), mnt)
        return [int(t) for t in eng.run()[rid]][len(prompt):]
    finally:
        eng.close()


# -- no process ------------------------------------------------------------

def test_spawn_command_carries_role_config_and_replica_index(
        tmp_path, monkeypatch):
    sup = Supervisor(model="gpt_tiny", replicas=2, collect_metrics=False,
                     log_dir=str(tmp_path), roles=["prefill"],
                     server_args=["--spill-dir", "/s/replica{replica}"],
                     replica_env={"OMP_NUM_THREADS": "1"},
                     checkpoint="/ck/rolled", weight_generation=4)
    captured = []

    class _FakeProc:
        pid = 4242

        def poll(self):
            return None

    monkeypatch.setattr(sup_mod.subprocess, "Popen",
                        lambda cmd, **kw: captured.append((cmd, kw))
                        or _FakeProc())
    for rep in sup.replicas:
        sup._spawn(rep)
        rep.close_log()
    (cmd0, kw0), (cmd1, _kw1) = captured
    assert cmd0[:3] == [sys.executable, "-m",
                        "paddle_tpu_torch.serving.server"]
    assert cmd0[cmd0.index("--checkpoint") + 1] == "/ck/rolled"
    assert cmd0[cmd0.index("--weight-generation") + 1] == "4"
    assert cmd0[cmd0.index("--role") + 1] == "prefill"
    assert "--role" not in cmd1  # a shorter roles list pads with mixed
    assert cmd0[cmd0.index("--spill-dir") + 1] == "/s/replica0"
    assert cmd1[cmd1.index("--spill-dir") + 1] == "/s/replica1"
    assert kw0["env"]["OMP_NUM_THREADS"] == "1"
    assert [r.role for r in sup.replicas] == ["prefill", "mixed"]
    with pytest.raises(ValueError, match="role"):
        Supervisor(model="gpt_tiny", replicas=1, roles=["verifier"])


def test_roll_refused_and_membership_guards(tmp_path):
    sup = Supervisor(model="gpt_tiny", replicas=2, collect_metrics=False,
                     log_dir=str(tmp_path), roles=["prefill", "decode"])
    assert sup.roll_fleet("/ck/new") == {"ok": False,
                                         "refused": "no_live_replica"}
    assert sup.scale_down_guard(7) == "no_such_replica"
    assert sup.scale_down_guard(0) == "last_prefill_replica"
    assert sup.drain_replica(1)["refused"] == "last_decode_replica"
    extra = sup.add_replica("decode", spawn=False)
    assert extra.idx == 2 and all(r.idx != 2 for r in sup.replicas)
    sup.attach_replica(extra)
    sup.attach_replica(extra)
    assert [r.idx for r in sup.replicas] == [0, 1, 2]
    assert sup.scale_down_guard(1) is None
    assert sup.scale_down_guard(1, min_replicas=3) == \
        "below_min_replicas(3)"
    sup.remove_replica(extra)
    assert [r.idx for r in sup.replicas] == [0, 1]
    with pytest.raises(ValueError):
        sup.add_replica("verifier", spawn=False)


def test_main_unported_flags(tmp_path, monkeypatch):
    """``--mesh`` is the one supervisor flag left unported; the
    autoscaler's flags parse and build it (the fleet's start is stopped
    at once here)."""
    seen = []

    def no_start(self, wait_ready=True):
        seen.append(self.autoscaler)
        raise KeyboardInterrupt

    monkeypatch.setattr(sup_mod.Supervisor, "start", no_start)
    monkeypatch.setattr(sup_mod.signal, "signal", lambda *a: None)
    for i, argv in enumerate((["--autoscale"],
                              ["--autoscale", "--min-replicas", "2"],
                              ["--autoscale", "--journal",
                               str(tmp_path / "j.json")])):
        sup_mod.main(argv + ["--replicas", "2", "--log-dir",
                             str(tmp_path / f"logs{i}")])
    assert [a.cfg.min_replicas for a in seen] == [1, 2, 1]
    assert seen[2].journal.path == str(tmp_path / "j.json")
    with pytest.raises(SystemExit) as e:
        sup_mod.main(["--mesh", "model=2"])
    assert e.value.code == 2  # argparse's unknown-flag exit
    with pytest.raises(SystemExit, match="unknown role"):
        sup_mod.main(["--roles", "prefill,verifier"])


def test_never_ready_replica_is_reclaimed(tmp_path, _time_limit):
    sup = Supervisor(model="gpt_tiny", replicas=1, probe_interval_s=0.05,
                     probe_timeout_s=0.2, ready_timeout_s=0.3,
                     backoff_base_s=3600, log_dir=str(tmp_path))
    rep = sup.replicas[0]
    rep.port = 1  # nothing listens: every probe fails
    rep.proc = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(600)"])
    rep.spawn_t = time.monotonic() - 10.0
    t = threading.Thread(target=sup._monitor_loop, daemon=True)
    t.start()
    try:
        _wait(lambda: rep.next_spawn_t is not None, "the reclaim", 10.0)
        rep.proc.wait(timeout=5)
        assert rep.probe_failures_by_kind.get("refused", 0) >= 1
        assert rep.last_probe_error.startswith("refused")
    finally:
        sup._stop.set()
        t.join(timeout=2.0)
        if rep.proc.poll() is None:
            rep.proc.kill()


# -- live replicas ---------------------------------------------------------

def test_scrape_staleness_failover_and_respawn(tmp_path, _time_limit):
    """Two mixed replicas: the probe cycle scrapes each export into the
    fleet plane; a keyed stream whose replica is killed mid-stream ends
    on the survivor with every token once and equal to the in-process
    engine; the killed replica goes stale, respawns on the committed
    config and serves again."""
    sup = Supervisor(model="gpt_tiny", replicas=2, server_args=SERVER_ARGS,
                     replica_env=REPLICA_ENV, probe_interval_s=0.2,
                     backoff_base_s=0.2, ready_timeout_s=60,
                     log_dir=str(tmp_path))
    router = None
    try:
        sup.start(wait_ready=True)
        router = FailoverRouter(sup)
        port = router.start()
        for i in range(2):
            r = client_request("127.0.0.1", port,
                               {"op": "generate", "prompt": [1, 2, 3 + i],
                                "max_new_tokens": 3}, timeout_s=60)
            assert r.get("done"), r

        def fleet():
            return client_request("127.0.0.1", port,
                                  {"op": "fleet_stats"})["fleet"]

        _wait(lambda: fleet()["counters"].get("requests_total", 0) >= 2,
              "the scrape")
        fs = fleet()
        assert fs["replicas_fresh"] == 2
        assert fs["slo"]["attainment"]["all"] == 1.0
        text = client_request("127.0.0.1", port,
                              {"op": "fleet_metrics"})["text"]
        assert "fleet_replicas_fresh 2" in text
        cap = client_request("127.0.0.1", port,
                             {"op": "fleet_capacity"})["capacity"]
        assert cap["replicas_fresh"] == 2 and cap["num_pages"] > 0

        killed = {}

        def on_token(tok, toks=[]):
            toks.append(tok)
            if len(toks) == 4:
                for rep in sup.replicas:
                    if client_request("127.0.0.1", rep.port,
                                      {"op": "health"})["active"]:
                        killed["idx"] = rep.idx
                        sup.kill_replica(rep.idx)
                        return

        streamed = []
        out = client_request("127.0.0.1", port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": 60, "stream": True,
                              "key": "fo"}, timeout_s=60,
                             on_token=lambda t: (streamed.append(t),
                                                 on_token(t)))
        assert "idx" in killed and out.get("done"), (killed, out)
        assert streamed == out["generated"] == \
            _local_tokens(None, PROMPT, 60)
        assert router.failovers_total >= 1
        dead = next(r for r in sup.replicas if r.idx == killed["idx"])
        _wait(lambda: fleet()["per_replica"][str(dead.idx)]["stale"],
              "the stale mark")
        _wait(lambda: dead.restarts == 1 and dead.ready and dead.alive(),
              "the respawn", 60.0)
        assert sup.restarts_total == 1
        r = client_request("127.0.0.1", dead.port,
                           {"op": "generate", "prompt": PROMPT,
                            "max_new_tokens": 4}, timeout_s=60)
        assert r["generated"] == _local_tokens(None, PROMPT, 4)
        sv = fleet()["supervision"][str(dead.idx)]
        assert sv["restarts"] == 1 and sv["alive"]
    finally:
        _stop(sup, router)


def test_disaggregated_fleet_handoff_and_roll(tmp_path, _time_limit):
    """A prefill and a decode replica behind the router: a keyed request
    routes prefill-first and the decode replica splices the fetched
    chain (the in-process engine's tokens); then ``roll_fleet`` onto a
    seed-1 checkpoint (canary window 0.5 s) under a streaming client:
    both replicas at generation 1, no failed request, a respawn boots
    the committed checkpoint, and a fresh prompt gives the tokens of
    the seed-1 weights."""
    sup = Supervisor(model="gpt_tiny", replicas=2,
                     roles=["prefill", "decode"],
                     server_args=SERVER_ARGS + ["--spill-mb", "16"],
                     replica_env=REPLICA_ENV, probe_interval_s=0.2,
                     backoff_base_s=0.2, ready_timeout_s=60,
                     log_dir=str(tmp_path / "logs"))
    router = None
    try:
        sup.start(wait_ready=True)
        router = FailoverRouter(sup)
        port = router.start()
        _wait(lambda: all(r.page_size for r in sup.replicas),
              "the advertisement")
        out = client_request("127.0.0.1", port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": 6, "key": "k"},
                             timeout_s=60)
        assert out["generated"] == _local_tokens(None, PROMPT, 6)
        assert out["stats"]["handoff_pages"] == 2
        assert router.handoffs_total == 1
        for rep in sup.replicas:
            chk = client_request("127.0.0.1", rep.port,
                                 {"op": "leak_check"})
            assert chk.get("ok"), chk

        m1 = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu",
                                 generator=torch.Generator()
                                 .manual_seed(1))
        state = tgpt.checkpoint_state(m1)
        ckdir = str(tmp_path / "ckpt")
        ResilientCheckpointManager(ckdir).save(1, state)
        stop, during = threading.Event(), []

        def client():
            j = 0
            while not stop.is_set():
                r = client_request("127.0.0.1", port,
                                   {"op": "generate",
                                    "prompt": [5 + j % 7] * 12,
                                    "max_new_tokens": 4,
                                    "key": f"r{j}"}, timeout_s=60)
                during.append(r.get("done") is True)
                j += 1

        th = threading.Thread(target=client)
        th.start()
        try:
            roll = sup.roll_fleet(ckdir, canary_window_s=0.5)
        finally:
            stop.set()
            th.join(timeout=60)
        assert roll["ok"] and roll["canary"] == 0, roll
        assert sorted(roll["swapped"]) == [0, 1]
        assert during and all(during), during
        gens = [client_request("127.0.0.1", r.port,
                               {"op": "health"})["weight_generation"]
                for r in sup.replicas]
        assert gens == [1, 1]
        assert (sup.checkpoint, sup.weight_generation) == (ckdir, 1)
        fresh = list(range(40, 59))
        want = _local_tokens(state, fresh, 6)
        got = client_request("127.0.0.1", port,
                             {"op": "generate", "prompt": fresh,
                              "max_new_tokens": 6, "key": "b"},
                             timeout_s=60)
        assert got["generated"] == want
        # a respawn comes up on the committed checkpoint and generation
        sup.kill_replica(1)
        dec = sup.replicas[1]
        _wait(lambda: dec.restarts == 1 and dec.ready and dec.alive(),
              "the respawn", 60.0)
        h = client_request("127.0.0.1", dec.port, {"op": "health"})
        assert h["weight_generation"] == 1
        again = client_request("127.0.0.1", dec.port,
                               {"op": "generate", "prompt": fresh,
                                "max_new_tokens": 6}, timeout_s=60)
        assert again["generated"] == want
    finally:
        _stop(sup, router)
