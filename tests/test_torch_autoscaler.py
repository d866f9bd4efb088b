"""The port's autoscaler (``paddle_tpu_torch/serving/autoscaler.py``),
the supervisor's journal wiring and the port's lint copy
(``paddle_tpu_torch/tools/flight_inspect.py``), against the JAX package.

``tests/test_autoscaler.py``'s unit classes and the journal cases of
``tests/test_hot_swap.py`` run on the port. Beside them, parity with the
reference: every ``plan_recovery`` scenario gives equal plans in both
packages, ``desired_prefill`` agrees over a grid, a journal written by
either package loads in the other to an equal body with an equal crc,
the port's lints return the reference tool's error lists on clean and
tampered journals and bundles, ``perturbed_state`` is bitwise JAX's, and
``roll_fleet`` journals the same actions in both supervisors. No test
here starts a process of the serving layer; the env-marker scans start
``sleep`` lookalikes and kill them.
"""

import _torch_threads  # noqa: F401

import copy
import importlib.util
import json
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import autoscaler as jas
from paddle_tpu.serving import supervisor as jsup

from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import autoscaler as tas
from paddle_tpu_torch.serving import supervisor as tsup
from paddle_tpu_torch.serving.autoscaler import (AutoscaleConfig,
                                                 Autoscaler, FleetJournal,
                                                 desired_prefill,
                                                 load_journal, open_actions,
                                                 plan_recovery,
                                                 scan_marked_replicas)
from paddle_tpu_torch.serving.server import client_request
from paddle_tpu_torch.serving.supervisor import (FailoverRouter, Replica,
                                                 Supervisor)
from paddle_tpu_torch.tools import flight_inspect as tfin

REPO = Path(__file__).resolve().parent.parent


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


jfin = _load_tool("flight_inspect")


def _sup(n=2, roles=None, tmp=None, **kw):
    """A Supervisor record set without processes: construction never
    spawns (start() does), so guard and plan logic is unit-testable."""
    kw.setdefault("collect_metrics", False)
    return Supervisor(model="gpt_tiny", replicas=n, roles=roles,
                      log_dir=str(tmp) if tmp else None, **kw)


# ---------------------------------------------------------------------------
# FleetJournal: atomic, crc-checked, bounded, lint-clean
# ---------------------------------------------------------------------------

class TestFleetJournal:
    def test_begin_before_action_then_commit_roundtrip(self, tmp_path):
        path = str(tmp_path / "j.json")
        j = FleetJournal(path)
        seq = j.begin("spawn", replica=3, role="mixed")
        body, err = load_journal(path)
        assert err is None
        opens = open_actions(body)
        assert [a["seq"] for a in opens] == [seq]
        assert opens[0]["action"] == "spawn"
        j.update(seq, phase="launched", pid=4242, port=9999)
        body, _ = load_journal(path)
        assert open_actions(body)[0]["pid"] == 4242
        j.commit(seq)
        body, _ = load_journal(path)
        assert open_actions(body) == []
        assert j.seq == seq

    def test_rollback_resolves_and_crc_rejects_tamper(self, tmp_path):
        path = str(tmp_path / "j.json")
        j = FleetJournal(path)
        seq = j.begin("drain", replica=0)
        j.rollback(seq, reason="readmitted_below_min")
        body, err = load_journal(path)
        assert err is None and open_actions(body) == []
        obj = json.loads(open(path).read())
        obj["body"]["seq"] = 999
        open(path, "w").write(json.dumps(obj))
        body, err = load_journal(path)
        assert body is None and "crc mismatch" in err

    def test_torn_write_leaves_previous_state(self, tmp_path):
        path = str(tmp_path / "j.json")
        j = FleetJournal(path)
        j.begin("spawn", replica=0)
        before = open(path).read()
        open(path + ".tmp", "w").write(before[: len(before) // 2])
        body, err = load_journal(path)
        assert err is None and body is not None
        assert open(path).read() == before

    def test_bounded_tail_never_drops_unresolved(self, tmp_path):
        j = FleetJournal(str(tmp_path / "j.json"))
        stuck = j.begin("drain", replica=0)  # never resolved
        for _ in range(FleetJournal.MAX_ACTION_ENTRIES):
            s = j.begin("spawn", replica=1)
            j.commit(s)
        body, _ = load_journal(j.path)
        assert [a["seq"] for a in open_actions(body)] == [stuck]

    def test_adopt_body_keeps_seq_monotonic_across_generations(
            self, tmp_path):
        path = str(tmp_path / "j.json")
        j1 = FleetJournal(path)
        s1 = j1.begin("spawn", replica=0)
        j1.commit(s1)
        body, _ = load_journal(path)
        j2 = FleetJournal(path)  # the restarted supervisor
        j2.adopt_body(body)
        s2 = j2.begin("spawn", replica=1)
        assert s2 > s1
        body, _ = load_journal(path)
        assert body["supervisor_pid"] == os.getpid()

    @pytest.mark.parametrize("fin", [tfin, jfin], ids=["port", "jax"])
    def test_flight_inspect_lints_journal_bytes(self, tmp_path, fin):
        path = str(tmp_path / "j.json")
        j = FleetJournal(path)
        seq = j.begin("spawn", replica=1, role="mixed")
        j.update(seq, phase="launched", pid=1234, port=8901)
        j.commit(seq)
        j.record_fleet([{"idx": 0, "pid": 111, "port": 8800,
                         "role": "mixed"},
                        {"idx": 1, "pid": 1234, "port": 8901,
                         "role": "mixed"}])
        obj = json.loads(open(path).read())
        assert fin.lint_fleet_journal(obj, allow_open_tail=0) == []
        j.begin("drain", replica=0)
        obj = json.loads(open(path).read())
        assert fin.lint_fleet_journal(obj, allow_open_tail=0)
        assert fin.lint_fleet_journal(obj, allow_open_tail=1) == []

    def test_write_failure_counted_not_raised(self, tmp_path):
        blocker = tmp_path / "blocker"
        blocker.write_text("")
        j = FleetJournal(str(blocker / "j.json"))
        j.begin("spawn", replica=0)  # must not raise
        assert j.write_failures_total >= 1
        assert j.writes_total == 0


# ---------------------------------------------------------------------------
# plan_recovery: the pure restart contract, and its parity with JAX
# ---------------------------------------------------------------------------

def _body(fleet=(), actions=(), config=None, seq=None):
    seqs = [a["seq"] for a in actions] or [0]
    body = {"seq": seq if seq is not None else max(seqs),
            "supervisor_pid": 12345,
            "fleet": list(fleet), "actions": list(actions)}
    if config is not None:
        body["config"] = dict(config)
    return body


def _roll_begin(seq, replica=1, gen_to=3, **extra):
    e = {"seq": seq, "action": "roll", "phase": "begin",
         "replica": replica, "checkpoint": "/ck/new",
         "generation_from": 0, "generation_to": gen_to,
         "pid": 300, "port": 8900, "role": "mixed"}
    e.update(extra)
    return e


_F0 = {"idx": 0, "pid": 100, "port": 8800, "role": "mixed"}
_F1 = {"idx": 1, "pid": 101, "port": 8801, "role": "mixed"}
_FLEET = [_F0, {"idx": 1, "pid": 300, "port": 8900, "role": "mixed"}]
_CFG = {"checkpoint": "/ck/old", "generation": 1}
_SPAWN = [{"seq": 5, "action": "spawn", "phase": "begin", "replica": 1,
           "role": "mixed"},
          {"seq": 5, "phase": "launched", "pid": 300, "port": 8900}]
_DRAIN1 = [{"seq": 7, "action": "drain", "phase": "begin", "replica": 1,
            "pid": 101, "port": 8801}]
_REROLE = [{"seq": 9, "action": "rerole", "phase": "begin", "replica": 1,
            "pid": 101, "port": 8801, "role_from": "mixed",
            "role_to": "prefill"}]

ALL = "all"          # every pid alive
ONLY_100 = "100"     # only pid 100 alive
ONLY_200 = "200"

# (name, body, scan, min, max, which pids are alive)
SCENARIOS = [
    ("adopts_live_respawns_dead",
     _body(fleet=[_F0, {"idx": 1, "pid": 101, "port": 8801,
                        "role": "decode"}]), {}, 1, 4, ONLY_100),
    ("scan_overlays_stale_snapshot_pid", _body(fleet=[_F0]),
     {0: {"pid": 200, "port": 8810}}, 1, 4, ONLY_200),
    ("open_spawn_live_under_envelope", _body(fleet=[_F0], actions=_SPAWN),
     {}, 1, 4, ALL),
    ("open_spawn_live_over_envelope", _body(fleet=[_F0], actions=_SPAWN),
     {}, 1, 1, ALL),
    ("open_spawn_dead", _body(fleet=[_F0], actions=_SPAWN[:1]), {}, 1, 4,
     ONLY_100),
    ("open_drain_victim_dead", _body(fleet=[_F0, _F1], actions=_DRAIN1),
     {}, 1, 4, ONLY_100),
    ("open_drain_victim_live", _body(fleet=[_F0, _F1], actions=_DRAIN1),
     {}, 1, 4, ALL),
    ("open_drain_readmitted_below_min",
     _body(fleet=[_F0], actions=[{"seq": 7, "action": "drain",
                                  "phase": "begin", "replica": 0,
                                  "pid": 100, "port": 8800}]),
     {}, 1, 4, ALL),
    ("open_rerole_live", _body(fleet=[_F0, _F1], actions=_REROLE), {}, 1,
     4, ALL),
    ("open_rerole_dead", _body(fleet=[_F0, _F1], actions=_REROLE), {}, 1,
     4, ONLY_100),
    ("never_double_spawn",
     _body(fleet=[_F0, {"idx": 1, "pid": 300, "port": 8900,
                        "role": "mixed"}], actions=_SPAWN),
     {1: {"pid": 300, "port": 8900}}, 1, 4, ALL),
    ("unknown_action",
     _body(fleet=[_F0], actions=[{"seq": 3, "action": "teleport",
                                  "phase": "begin", "replica": 2}]),
     {}, 1, 4, ALL),
    ("roll_unproven_backward",
     _body(fleet=_FLEET, actions=[_roll_begin(7)], config=_CFG), {}, 1, 4,
     ALL),
    ("roll_swapped_forward",
     _body(fleet=_FLEET, actions=[_roll_begin(7),
                                  {"seq": 7, "phase": "swapped",
                                   "swapped": True}], config=_CFG),
     {}, 1, 4, ALL),
    ("roll_committed_sibling_forward",
     _body(fleet=_FLEET, actions=[_roll_begin(6, replica=0),
                                  {"seq": 6, "phase": "commit"},
                                  _roll_begin(7, replica=1)],
           config=_CFG), {}, 1, 4, ALL),
    ("roll_committed_rollback_sibling_backward",
     _body(fleet=_FLEET, actions=[_roll_begin(6, replica=0, rollback=True),
                                  {"seq": 6, "phase": "commit"},
                                  _roll_begin(7, replica=1)],
           config=_CFG), {}, 1, 4, ALL),
    ("roll_dead_victim_respawned",
     _body(fleet=_FLEET, actions=[_roll_begin(7)], config=_CFG), {}, 1, 4,
     ONLY_100),
    ("roll_without_config_back_to_generation_from",
     _body(fleet=_FLEET, actions=[_roll_begin(7)]), {}, 1, 4, ALL),
    ("no_journal_scan_only", None, {0: {"pid": 200, "port": 8810},
                                    3: {"pid": 100, "port": None}}, 1, 4,
     ALL),
]


def _alive(which):
    if which == ALL:
        return lambda pid, port: True
    return lambda pid, port: pid == int(which)


def _plan(name):
    _, body, scan, lo, hi, which = next(s for s in SCENARIOS
                                        if s[0] == name)
    return plan_recovery(copy.deepcopy(body), copy.deepcopy(scan), lo, hi,
                         alive=_alive(which))


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s[0] for s in
                                                     SCENARIOS])
def test_plan_recovery_equals_jax(scenario):
    _, body, scan, lo, hi, which = scenario
    got = tas.plan_recovery(copy.deepcopy(body), copy.deepcopy(scan), lo,
                            hi, alive=_alive(which))
    want = jas.plan_recovery(copy.deepcopy(body), copy.deepcopy(scan), lo,
                             hi, alive=_alive(which))
    assert got == want


class TestPlanRecovery:
    def test_adopts_live_respawns_dead(self):
        plan = _plan("adopts_live_respawns_dead")
        assert [e["idx"] for e in plan["adopt"]] == [0]
        assert plan["respawn"] == [{"idx": 1, "role": "decode"}]
        assert plan["reap"] == [] and plan["resume"] == []

    def test_scan_overlays_stale_snapshot_pid(self):
        plan = _plan("scan_overlays_stale_snapshot_pid")
        assert [(e["idx"], e["pid"]) for e in plan["adopt"]] == [(0, 200)]
        assert plan["respawn"] == []

    def test_open_spawn_live_under_envelope_adopted_and_committed(self):
        plan = _plan("open_spawn_live_under_envelope")
        assert sorted(e["idx"] for e in plan["adopt"]) == [0, 1]
        assert plan["resolve"] == [(5, "commit", "adopted_on_recovery")]

    def test_open_spawn_live_over_envelope_reaped(self):
        plan = _plan("open_spawn_live_over_envelope")
        assert [e["pid"] for e in plan["reap"]] == [300]
        assert plan["resolve"] == \
            [(5, "rollback", "reaped_over_envelope")]

    def test_open_spawn_dead_rolled_back_nothing_to_reap(self):
        plan = _plan("open_spawn_dead")
        assert plan["reap"] == []
        assert plan["resolve"] == [(5, "rollback", "orphan_dead")]

    def test_open_drain_victim_dead_committed(self):
        plan = _plan("open_drain_victim_dead")
        assert plan["resolve"] == [(7, "commit", "victim_already_dead")]
        assert [e["idx"] for e in plan["adopt"]] == [0]

    def test_open_drain_victim_live_resumed_with_draining_flag(self):
        plan = _plan("open_drain_victim_live")
        assert plan["resume"] == [{"seq": 7, "action": "drain",
                                   "replica": 1}]
        dr = [e for e in plan["adopt"] if e["idx"] == 1]
        assert dr and dr[0].get("draining") is True

    def test_open_drain_readmitted_when_below_min(self):
        plan = _plan("open_drain_readmitted_below_min")
        assert plan["resume"] == []
        assert plan["resolve"] == [(7, "rollback", "readmitted_below_min")]
        ent = [e for e in plan["adopt"] if e["idx"] == 0][0]
        assert not ent.get("draining")

    def test_open_rerole_live_resumes_dead_respawns_with_new_role(self):
        live = _plan("open_rerole_live")
        assert live["resume"] == [{"seq": 9, "action": "rerole",
                                   "replica": 1, "role": "prefill"}]
        dead = _plan("open_rerole_dead")
        assert {"idx": 1, "role": "prefill"} in dead["respawn"]
        assert dead["resolve"] == \
            [(9, "commit", "respawned_with_new_role")]

    def test_never_double_spawn_idx_claimed_once(self):
        plan = _plan("never_double_spawn")
        assert sorted(e["idx"] for e in plan["adopt"]) == [0, 1]
        assert plan["respawn"] == []

    def test_unknown_action_rolled_back_typed(self):
        plan = _plan("unknown_action")
        assert plan["resolve"] == [(3, "rollback",
                                    "unknown_action_teleport")]


class TestPlanRecoveryRoll:
    def test_unproven_roll_resumes_backward_to_committed_config(self):
        plan = _plan("roll_unproven_backward")
        (res,) = plan["resume"]
        assert res["action"] == "roll_back" and res["seq"] == 7
        assert res["checkpoint"] == "/ck/old"
        assert res["generation"] == 1
        assert all(seq != 7 for seq, _, _ in plan["resolve"])
        assert any(e["idx"] == 1 for e in plan["adopt"])

    def test_swapped_record_resumes_forward(self):
        plan = _plan("roll_swapped_forward")
        (res,) = plan["resume"]
        assert res["action"] == "roll" and res["generation"] == 3
        assert res["checkpoint"] == "/ck/new"
        assert all(seq != 7 for seq, _, _ in plan["resolve"])

    def test_committed_sibling_roll_proves_generation_forward(self):
        (res,) = _plan("roll_committed_sibling_forward")["resume"]
        assert res["action"] == "roll" and res["generation"] == 3

    def test_committed_rollback_sibling_proves_nothing(self):
        (res,) = _plan("roll_committed_rollback_sibling_backward")["resume"]
        assert res["action"] == "roll_back"

    def test_dead_roll_victim_respawned_not_stranded(self):
        plan = _plan("roll_dead_victim_respawned")
        assert {"idx": 1, "role": "mixed"} in plan["respawn"]
        assert plan["resume"][0]["action"] == "roll_back"


# ---------------------------------------------------------------------------
# Scale-down guard, backoff reset
# ---------------------------------------------------------------------------

class TestScaleDownGuard:
    def test_last_replica_refused(self, tmp_path):
        sup = _sup(1, tmp=tmp_path)
        assert sup.scale_down_guard(0) == "last_replica"
        out = sup.drain_replica(0)
        assert out["refused"] == "last_replica"
        assert out["drained"] is False

    def test_below_min_envelope_refused(self, tmp_path):
        sup = _sup(2, tmp=tmp_path)
        assert sup.scale_down_guard(0, min_replicas=2) == \
            "below_min_replicas(2)"
        assert sup.scale_down_guard(0, min_replicas=1) is None

    def test_last_role_advertising_replica_refused(self, tmp_path):
        sup = _sup(3, roles=["prefill", "decode", "decode"], tmp=tmp_path)
        assert sup.scale_down_guard(0) == "last_prefill_replica"
        assert sup.scale_down_guard(1) is None
        sup.replicas[2].draining = True
        assert sup.scale_down_guard(1) == "last_decode_replica"

    def test_unknown_idx_typed(self, tmp_path):
        sup = _sup(1, tmp=tmp_path)
        assert sup.scale_down_guard(99) == "no_such_replica"

    def test_mid_drain_victim_skips_guard(self, tmp_path):
        sup = _sup(1, tmp=tmp_path)
        sup.replicas[0].draining = True
        out = sup.drain_replica(0)
        assert "refused" not in out


class TestBackoffReset:
    def test_reset_backoff_clears_the_exponential_state(self):
        rep = Replica(0, "127.0.0.1")
        rep.consec_deaths = 5
        rep.probe_failures = 2
        rep.next_spawn_t = time.monotonic() + 60.0
        rep.reset_backoff()
        assert rep.consec_deaths == 0
        assert rep.probe_failures == 0
        assert rep.next_spawn_t is None


# ---------------------------------------------------------------------------
# Shape rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [-1, 0, 1])
def test_desired_prefill_equals_jax(bias):
    for n in range(17):
        for ratio in (1.0, 2.0, 3.0, 4.0):
            assert desired_prefill(n, ratio, bias) == \
                jas.desired_prefill(n, ratio, bias), (n, ratio)


class TestShapeRule:
    def test_desired_prefill_ratio_and_clamps(self):
        assert desired_prefill(0) == 0
        assert desired_prefill(1) == 0
        assert desired_prefill(2) == 1
        assert desired_prefill(4) == 1
        assert desired_prefill(8) == 2
        assert desired_prefill(4, decode_per_prefill=1.0) == 2
        assert desired_prefill(2, bias=-5) == 1
        assert desired_prefill(2, bias=+5) == 1
        assert desired_prefill(4, bias=+1) == 2
        assert desired_prefill(4, bias=-1) == 1

    def _asc(self, sup, tmp):
        return Autoscaler(sup, AutoscaleConfig(min_replicas=1,
                                               max_replicas=8),
                          journal_path=str(tmp / "j.json"))

    def test_mixed_only_fleet_never_shaped(self, tmp_path):
        assert self._asc(_sup(3, tmp=tmp_path), tmp_path).plan_shape() \
            is None

    def test_underrepresented_prefill_converts_a_mixed(self, tmp_path):
        sup = _sup(4, roles=["decode", "decode", "decode", "mixed"],
                   tmp=tmp_path)
        assert self._asc(sup, tmp_path).plan_shape() == {
            "replica": 3, "role": "prefill", "reason": "shape_prefill_up"}

    def test_overrepresented_prefill_converts_to_decode(self, tmp_path):
        sup = _sup(4, roles=["prefill", "prefill", "decode", "decode"],
                   tmp=tmp_path)
        assert self._asc(sup, tmp_path).plan_shape() == {
            "replica": 0, "role": "decode", "reason": "shape_decode_up"}

    def test_balanced_fleet_not_shaped(self, tmp_path):
        sup = _sup(2, roles=["prefill", "decode"], tmp=tmp_path)
        assert self._asc(sup, tmp_path).plan_shape() is None

    def test_handoff_failure_climb_biases_prefill_up(self, tmp_path):
        sup = _sup(4, roles=["prefill", "decode", "decode", "decode"],
                   tmp=tmp_path)

        class _R:
            handoff_prefill_failures_total = 3
        sup.router = _R()
        asc = self._asc(sup, tmp_path)
        plan = asc.plan_shape()
        assert plan is not None and plan["role"] == "prefill"
        assert asc.plan_shape() is None  # edge-triggered

    def test_tpot_attainment_drop_biases_decode_up(self, tmp_path):
        sup = _sup(4, roles=["prefill", "decode", "decode", "decode"],
                   tmp=tmp_path)

        class _F:
            def fleet_snapshot(self):
                return {"slo": {"classes": {"a": {"tpot_met": 1,
                                                  "total": 4}}}}
        sup.fleet = _F()
        asc = self._asc(sup, tmp_path)
        assert asc._tpot_attainment() == 0.25
        # want stays 1 prefill (clamped), so nothing moves
        assert asc.plan_shape() is None


# ---------------------------------------------------------------------------
# Actuator refusals + observability (no processes)
# ---------------------------------------------------------------------------

class TestActuatorRefusals:
    def _asc(self, sup, tmp, **cfg):
        kw = dict(min_replicas=1, max_replicas=2)
        kw.update(cfg)
        return Autoscaler(sup, AutoscaleConfig(**kw),
                          journal_path=str(tmp / "j.json"))

    def test_envelope_validated(self, tmp_path):
        sup = _sup(1, tmp=tmp_path)
        with pytest.raises(ValueError):
            Autoscaler(sup, AutoscaleConfig(min_replicas=0),
                       journal_path=str(tmp_path / "j.json"))
        with pytest.raises(ValueError):
            Autoscaler(sup, AutoscaleConfig(min_replicas=3,
                                            max_replicas=2),
                       journal_path=str(tmp_path / "j2.json"))

    def test_scale_up_refused_at_max_even_forced(self, tmp_path):
        asc = self._asc(_sup(2, tmp=tmp_path), tmp_path)
        out = asc.scale_up(force=True)
        assert out["ok"] is False and out["reason"] == "refused_at_max"
        assert asc.actions_total[("spawn", "refused_at_max")] == 1

    def test_scale_up_refused_in_cooldown(self, tmp_path):
        asc = self._asc(_sup(1, tmp=tmp_path), tmp_path, max_replicas=4,
                        cooldown_up_s=3600.0)
        asc._last_up_t = time.monotonic()
        assert asc.scale_up()["reason"] == "refused_cooldown"
        assert asc.status()["cooldown_up_remaining_s"] > 0

    def test_scale_down_refused_no_eligible_victim(self, tmp_path):
        asc = self._asc(_sup(1, tmp=tmp_path), tmp_path)
        assert asc.scale_down(force=True)["reason"] == \
            "refused_no_eligible_victim"

    def test_rerole_typed_refusals(self, tmp_path):
        sup = _sup(2, roles=["prefill", "decode"], tmp=tmp_path)
        asc = self._asc(sup, tmp_path)
        assert asc.rerole(0, "gpu", force=True)["reason"] == \
            "refused_bad_role_gpu"
        assert asc.rerole(9, "decode", force=True)["reason"] == \
            "refused_no_such_replica"
        assert asc.rerole(0, "prefill", force=True)["reason"] == \
            "refused_already_that_role"
        assert asc.rerole(0, "decode", force=True)["reason"] == \
            "refused_guard"

    def test_refusals_never_touch_the_journal(self, tmp_path):
        asc = self._asc(_sup(2, tmp=tmp_path), tmp_path)
        seq0 = asc.journal.seq
        asc.scale_up(force=True)
        asc.rerole(0, "bogus", force=True)
        assert asc.journal.seq == seq0

    def test_prometheus_families_and_status(self, tmp_path):
        sup = _sup(2, roles=["prefill", "decode"], tmp=tmp_path)
        asc = self._asc(sup, tmp_path)
        asc.scale_up(force=True)
        text = "\n".join(asc.prometheus_lines())
        assert "# TYPE serving_autoscale_actions_total counter" in text
        assert 'serving_autoscale_actions_total{action="spawn",' \
               'reason="refused_at_max"} 1' in text
        assert 'serving_fleet_replicas{role="prefill"} 1' in text
        assert 'serving_fleet_replicas{role="decode"} 1' in text
        assert 'serving_fleet_replicas{role="mixed"} 0' in text
        st = asc.status()
        assert st["replicas_by_role"] == {"prefill": 1, "decode": 1}
        assert st["last_action"]["reason"] == "refused_at_max"
        assert st["actions_total"] == {"spawn|refused_at_max": 1}
        assert st["action_in_flight"] is False
        assert st["journal"]["path"] == str(tmp_path / "j.json")

    def test_status_and_exposition_equal_jax(self, tmp_path):
        outs = []
        for sup_mod, as_mod, sub in ((tsup, tas, "t"), (jsup, jas, "j")):
            sup = sup_mod.Supervisor(model="gpt_tiny", replicas=2,
                                     roles=["prefill", "decode"],
                                     collect_metrics=False,
                                     log_dir=str(tmp_path / sub))
            asc = as_mod.Autoscaler(sup, as_mod.AutoscaleConfig(
                min_replicas=1, max_replicas=2),
                journal_path=str(tmp_path / "j.json"))
            asc.scale_up(force=True)
            asc.scale_down(force=False, reason="pressure")
            asc.rerole(5, "decode", force=True)
            st = asc.status()
            for k in ("last_action", "recovery"):
                st.pop(k)
            outs.append((st, asc.prometheus_lines()))
        assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Flight-recorder autoscale bundles and the lint copy's parity
# ---------------------------------------------------------------------------

def _autoscale_bundle(**over):
    b = {"v": 1, "reason": "autoscale", "t_unix": 1.7e9, "pid": 4321,
         "action": {"action": "spawn", "reason": "pressure", "ok": True,
                    "t_unix": 1.7e9},
         "fleet": [{"idx": 0, "pid": 1, "port": 8800, "role": "mixed"}],
         "journal_tail": [{"seq": 1, "phase": "begin", "action": "spawn"},
                          {"seq": 1, "phase": "commit"}]}
    b.update(over)
    return b


def _replica_bundle(**over):
    b = {"v": 2, "reason": "resurrect", "t_unix": 1.7e9, "pid": 77,
         "engine": {"steps": 3}, "inflight": [
             {"req_id": 1, "state": "decoding", "prompt_len": 4,
              "generated": 2}],
         "metrics": {"counters": {}, "histograms": {
             "ttft_s": {"counts": [1, 2, 0], "total": 3}}},
         "step_timeline": [{"step": 1}, {"step": 2}],
         "traces": [{"trace_id": "t1", "pid": 77, "spans": [
             {"sid": "a", "name": "request", "parent": None,
              "t0_us": 0.0, "t1_us": 100.0},
             {"sid": "b", "name": "prefill", "parent": "a",
              "t0_us": 10.0, "t1_us": 50.0}]}],
         "page_ledger": [{"seq": 1, "ev": "alloc"}, {"seq": 2, "ev": "free"}],
         "capacity": {"num_pages": 10, "occupancy": {
             "inflight": 2, "prefix_device": 3, "reserved": 1, "free": 4}}}
    b.update(over)
    return b


def _tampered_bundles():
    bad_trace = _replica_bundle()
    bad_trace["traces"][0]["spans"][1]["t1_us"] = 500.0  # escapes parent
    open_span = _replica_bundle()
    open_span["traces"][0]["spans"][1]["t1_us"] = None
    orphan = _replica_bundle()
    orphan["traces"][0]["spans"][1]["parent"] = "zz"
    no_fleet = _autoscale_bundle()
    del no_fleet["fleet"]
    return {
        "autoscale_clean": _autoscale_bundle(),
        "replica_clean": _replica_bundle(),
        "autoscale_bad_action": _autoscale_bundle(action="not-a-dict"),
        "autoscale_bad_tail": _autoscale_bundle(
            journal_tail=[{"seq": 1, "phase": "exploded"}]),
        "autoscale_no_fleet": no_fleet,
        "autoscale_bad_pid": _autoscale_bundle(pid="x", t_unix=-1),
        "replica_unknown_reason": _replica_bundle(reason="swap_failed"),
        "replica_timeline_back": _replica_bundle(
            step_timeline=[{"step": 3}, {"step": 1}]),
        "replica_ledger_back": _replica_bundle(
            page_ledger=[{"seq": 2, "ev": "a"}, {"seq": 2, "ev": "b"}]),
        "replica_occupancy_sum": _replica_bundle(capacity={
            "num_pages": 11, "occupancy": {"inflight": 2,
                                           "prefix_device": 3,
                                           "reserved": 1, "free": 4}}),
        "replica_histogram": _replica_bundle(metrics={"histograms": {
            "h": {"counts": [1, 1], "total": 3}}}),
        "replica_missing_v2": {k: v for k, v in _replica_bundle().items()
                               if k != "capacity"},
        "replica_bad_trace": bad_trace,
        "replica_open_span": open_span,
        "replica_orphan": orphan,
        "not_a_dict": ["x"],
    }


class TestAutoscaleBundleLint:
    def test_wellformed_bundle_lints_clean(self):
        assert tfin.lint_bundle(_autoscale_bundle()) == []

    def test_malformed_bundles_rejected(self):
        assert tfin.lint_bundle(_autoscale_bundle(action="not-a-dict"))
        assert tfin.lint_bundle(_autoscale_bundle(
            journal_tail=[{"seq": 1, "phase": "exploded"}]))
        bad = _autoscale_bundle()
        del bad["fleet"]
        assert tfin.lint_bundle(bad)

    def test_recorder_written_bundle_lints_end_to_end(self, tmp_path):
        from paddle_tpu_torch.serving.fleet_metrics import FlightRecorder
        sup = _sup(2, tmp=tmp_path)
        flight = FlightRecorder(str(tmp_path / "flight"),
                                min_interval_s=0.0)
        asc = Autoscaler(sup, AutoscaleConfig(min_replicas=1,
                                              max_replicas=2),
                         journal_path=str(tmp_path / "j.json"),
                         flight=flight)
        assert asc.scale_up(force=True)["ok"] is False  # no bundle
        asc._record("drain", "unit", ok=True, replica=1)  # bundled
        for fin in (tfin, jfin):
            bundles, errors = fin.lint_dir(str(tmp_path / "flight"))
            assert errors == [] and len(bundles) == 1


@pytest.mark.parametrize("name", sorted(_tampered_bundles()))
def test_bundle_lint_equals_the_reference_tool(name):
    b = _tampered_bundles()[name]
    got = tfin.lint_bundle(copy.deepcopy(b), name=name)
    assert got == jfin.lint_bundle(copy.deepcopy(b), name=name)
    assert (got == []) == name.endswith("_clean")


def _journal_obj(tmp_path):
    j = FleetJournal(str(tmp_path / "j.json"))
    s = j.begin("spawn", replica=1, role="mixed")
    j.update(s, phase="launched", pid=1234, port=8901)
    j.commit(s)
    r = j.begin("roll", replica=0, checkpoint="/ck", generation_from=0,
                generation_to=1)
    j.update(r, phase="swapped", swapped=True)
    j.commit(r)
    j.record_fleet([{"idx": 0, "pid": 11, "port": 8800, "role": "mixed"},
                    {"idx": 1, "pid": 1234, "port": 8901,
                     "role": "decode"}])
    j.record_config("/ck", 1)
    return json.loads(open(j.path).read())


def _tampered_journals(obj):
    def with_body(edit):
        o = copy.deepcopy(obj)
        edit(o["body"])
        o["crc"] = zlib.crc32(tas._canonical(o["body"]))
        return o

    crc = copy.deepcopy(obj)
    crc["body"]["seq"] += 1
    return {
        "clean": obj,
        "crc_mismatch": crc,
        "open_begin": with_body(lambda b: b["actions"].append(
            {"seq": b["seq"] + 1, "phase": "begin", "action": "drain"})
            or b.update(seq=b["seq"] + 1)),
        "seq_beyond_counter": with_body(lambda b: b.update(seq=1)),
        "begin_not_monotonic": with_body(lambda b: b["actions"].extend(
            [{"seq": 1, "phase": "begin", "action": "spawn"},
             {"seq": 1, "phase": "commit"}])),
        "swapped_on_spawn": with_body(lambda b: b["actions"].insert(
            1, {"seq": 1, "phase": "swapped", "swapped": True})),
        "bad_phase": with_body(lambda b: b["actions"].append(
            {"seq": 1, "phase": "exploded"})),
        "fleet_dup_and_role": with_body(lambda b: b["fleet"].extend(
            [{"idx": 0, "role": "gpu", "pid": "x"}, {"role": "mixed"}])),
        "bad_counter": with_body(lambda b: b.update(seq=-1)),
        "actions_not_list": with_body(lambda b: b.update(actions={})),
        "not_a_journal": {"body": {}},
    }


@pytest.mark.parametrize("tail", [0, 1])
def test_journal_lint_equals_the_reference_tool(tmp_path, tail):
    cases = _tampered_journals(_journal_obj(tmp_path))
    for name, obj in cases.items():
        got = tfin.lint_fleet_journal(copy.deepcopy(obj), name=name,
                                      allow_open_tail=tail)
        assert got == jfin.lint_fleet_journal(copy.deepcopy(obj),
                                              name=name,
                                              allow_open_tail=tail), name
        if name == "clean" or (name == "open_begin" and tail):
            assert got == [], name
        else:
            assert got, name


def test_trace_lint_copy_equals_the_reference_tool():
    jtl = _load_tool("trace_lint")
    b = _replica_bundle()
    chrome = {"traceEvents": [{"ph": "M"}, {"name": "x", "ts": 1, "ph": "X",
                                            "dur": -1}, {"ts": -2}]}
    cyc = {"trace_id": "c", "spans": [
        {"sid": "a", "parent": "b", "t0_us": 0, "t1_us": 1},
        {"sid": "b", "parent": "a", "t0_us": 0, "t1_us": 1},
        {"sid": "b", "parent": None, "t0_us": 5, "t1_us": 1},
        {"name": "nosid"}], "leaked_open": 2}
    for obj in ({"traces": b["traces"]}, chrome, cyc, [cyc, 3], [], 7,
                {"traces": []}):
        assert tfin.lint_trace_obj(copy.deepcopy(obj)) == \
            jtl.lint_trace_obj(copy.deepcopy(obj))


# ---------------------------------------------------------------------------
# Journal bytes across packages, committed config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_loads_across_packages(tmp_path, writer):
    w, r = (tas, jas) if writer == "port" else (jas, tas)
    path = str(tmp_path / "j.json")
    j = w.FleetJournal(path, supervisor_pid=4242)
    s = j.begin("spawn", replica=2, role="prefill", reason="pressure")
    j.update(s, phase="launched", pid=99, port=8100)
    j.rollback(s, reason="never_ready")
    j.record_fleet([{"idx": 0, "pid": 5, "port": 8000, "role": "mixed"}])
    j.record_config("/ck/x", 3)
    body_w, err_w = w.load_journal(path)
    body_r, err_r = r.load_journal(path)
    assert err_w is None and err_r is None and body_r == body_w
    assert tas._canonical(body_r) == jas._canonical(body_r)
    obj = json.loads(open(path).read())
    assert obj["crc"] == zlib.crc32(tas._canonical(body_r)) == \
        zlib.crc32(jas._canonical(body_r))
    # the reader's journal continues the writer's: seqs stay monotonic
    j2 = r.FleetJournal(path)
    j2.adopt_body(body_r)
    assert j2.begin("drain", replica=0) == s + 1
    assert j2.config() == {"checkpoint": "/ck/x", "generation": 3}
    assert w.load_journal(path)[1] is None


class TestJournalConfigAndLint:
    def test_record_config_roundtrip_and_adoption(self, tmp_path):
        path = str(tmp_path / "j.json")
        j = FleetJournal(path)
        assert j.config() == {}
        j.record_config("/ck/rolled", 4)
        body, err = load_journal(path)
        assert err is None
        assert body["config"] == {"checkpoint": "/ck/rolled",
                                  "generation": 4}
        j2 = FleetJournal(path)
        j2.adopt_body(body)
        assert j2.config()["generation"] == 4
        s = j2.begin("spawn", replica=0)
        j2.commit(s)
        body, _ = load_journal(path)
        assert body["config"]["checkpoint"] == "/ck/rolled"

    def test_swapped_phase_legal_on_roll_actions_only(self, tmp_path):
        path = str(tmp_path / "j.json")
        j = FleetJournal(path)
        seq = j.begin("roll", replica=0, checkpoint="/ck/new",
                      generation_from=0, generation_to=1)
        j.update(seq, phase="swapped", swapped=True)
        j.commit(seq)
        obj = json.loads(open(path).read())
        assert tfin.lint_fleet_journal(obj, allow_open_tail=0) == []
        s2 = j.begin("spawn", replica=1, role="mixed")
        j.update(s2, phase="swapped", swapped=True)
        j.commit(s2)
        obj = json.loads(open(path).read())
        errs = tfin.lint_fleet_journal(obj, allow_open_tail=0)
        assert errs and any("roll" in e for e in errs)


# ---------------------------------------------------------------------------
# perturbed_state: bitwise the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1e-3), (7, 0.5)])
def test_perturbed_state_bitwise_jax(seed, scale):
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    state = tgpt.checkpoint_state(m)
    state["an_int_leaf"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    state["a_f64_leaf"] = np.linspace(0, 1, 5)
    got = tgpt.perturbed_state(state, scale=scale, seed=seed)
    want = jgpt.perturbed_state(state, scale=scale, seed=seed)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["an_int_leaf"] is state["an_int_leaf"]
    assert not np.array_equal(got["a_f64_leaf"], state["a_f64_leaf"])


# ---------------------------------------------------------------------------
# Supervisor: journal markers, weight config, roll journaling, router ops
# ---------------------------------------------------------------------------

class _FakeProc:
    pid = 4242
    returncode = None

    def poll(self):
        return None


def _capture_spawns(monkeypatch, mod=tsup):
    captured = []
    monkeypatch.setattr(mod.subprocess, "Popen",
                        lambda cmd, **kw: captured.append((cmd, kw))
                        or _FakeProc())
    return captured


class TestSupervisorWeightConfig:
    def test_spawn_carries_committed_checkpoint_and_generation(
            self, tmp_path, monkeypatch):
        sup = Supervisor(model="gpt_tiny", replicas=1,
                         collect_metrics=False, log_dir=str(tmp_path),
                         checkpoint="/ck/rolled", weight_generation=4)
        captured = _capture_spawns(monkeypatch)
        rep = sup.replicas[0]
        sup._spawn(rep)
        rep.close_log()
        cmd = captured[0][0]
        assert cmd[cmd.index("--checkpoint") + 1] == "/ck/rolled"
        assert cmd[cmd.index("--weight-generation") + 1] == "4"

    def test_roll_fleet_refuses_without_live_replicas(self, tmp_path):
        sup = Supervisor(model="gpt_tiny", replicas=1,
                         collect_metrics=False, log_dir=str(tmp_path))
        assert sup.roll_fleet("/ck/new") == {"ok": False,
                                             "refused": "no_live_replica"}


class TestJournalEnvMarkers:
    def test_spawn_stamps_markers_only_under_an_autoscaler(
            self, tmp_path, monkeypatch):
        sup = _sup(2, tmp=tmp_path)
        captured = _capture_spawns(monkeypatch)
        sup._spawn(sup.replicas[0])
        asc = Autoscaler(sup, AutoscaleConfig(),
                         journal_path=str(tmp_path / "j.json"))
        assert sup.autoscaler is asc
        assert sup.journal_path == str(tmp_path / "j.json")
        sup._spawn(sup.replicas[1])
        for rep in sup.replicas:
            rep.close_log()
        (_, kw0), (_, kw1) = captured
        assert tas.JOURNAL_ENV not in kw0["env"]
        assert kw1["env"][tas.JOURNAL_ENV] == str(tmp_path / "j.json")
        assert kw1["env"][tas.REPLICA_IDX_ENV] == "1"
        assert tas.JOURNAL_ENV == jas.JOURNAL_ENV == "PT_SUPERVISOR_JOURNAL"
        assert tas.REPLICA_IDX_ENV == jas.REPLICA_IDX_ENV == \
            "PT_REPLICA_IDX"

    def _lookalike(self, journal, module, idx, port):
        env = dict(os.environ)
        env["PT_SUPERVISOR_JOURNAL"] = journal
        env["PT_REPLICA_IDX"] = str(idx)
        return subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(60)", module,
             "--port", str(port)], env=env)

    def test_scan_finds_marked_port_replicas_only(self, tmp_path):
        """A process whose command line names the port's server module
        and whose env carries our journal's marker is found by the
        port's scan; one naming the JAX server module is not (and the
        JAX scan sees only it), and neither is found under another
        journal's path."""
        journal = str(tmp_path / "j.json")
        port_like = self._lookalike(journal, tas.SERVER_MODULE, 3, 8899)
        jax_like = self._lookalike(journal, "paddle_tpu.serving.server",
                                   4, 8898)
        try:
            deadline = time.monotonic() + 10
            found = jfound = {}
            while time.monotonic() < deadline:
                found = scan_marked_replicas(journal)
                jfound = jas.scan_marked_replicas(journal)
                if found and jfound:
                    break
                time.sleep(0.1)
            assert found == {3: {"pid": port_like.pid, "port": 8899}}
            assert jfound == {4: {"pid": jax_like.pid, "port": 8898}}
            assert scan_marked_replicas(str(tmp_path / "other.json")) == {}
            assert tas._pid_is_replica(port_like.pid, 8899)
            assert not tas._pid_is_replica(port_like.pid, 8898)
            assert not tas._pid_is_replica(jax_like.pid)
            proc = tas._AdoptedProc(port_like.pid, 8899)
            assert proc.poll() is None
            proc.kill()
            port_like.wait(timeout=10)
            assert proc.wait(timeout=5) == 0
        finally:
            for p in (port_like, jax_like):
                p.kill()
                p.wait()


class _FakeRollFleet:
    """Monkeypatches a process-free supervisor so ``roll_fleet`` runs
    its journaled loop: two live replicas whose swaps succeed except
    where ``fail`` names them."""

    def __init__(self, sup, fail=(), canary_regress=None):
        self.gens = {r.idx: 0 for r in sup.replicas}
        for r in sup.replicas:
            r.ready = True
            r.proc = _FakeProc()
        sup.live = lambda: list(sup.replicas)
        sup._probe_generation = lambda rep: self.gens[rep.idx]
        sup._handoff_before_swap = lambda rep, t: None
        sup._fleet_attainment = lambda: None
        sup._respawn_with_config = lambda rep: True

        def swap(rep, ckpt, gen, timeout_s, rollback=False):
            if rep.idx in fail and not rollback:
                return "SwapFailed: torn shard"
            self.gens[rep.idx] = gen
            return None
        sup._swap_replica = swap
        sup._watch_canary = lambda *a, **k: canary_regress


def _roll_journal(sup_mod, as_mod, tmp_path, sub, **fake):
    sup = sup_mod.Supervisor(model="gpt_tiny", replicas=2,
                             collect_metrics=False,
                             log_dir=str(tmp_path / sub))
    _FakeRollFleet(sup, **fake)
    asc = as_mod.Autoscaler(sup, as_mod.AutoscaleConfig(),
                            journal_path=str(tmp_path / sub / "j.json"))
    out = sup.roll_fleet("/ck/b", canary_window_s=0.0)
    body, err = as_mod.load_journal(asc.journal.path)
    assert err is None
    acts = [{k: v for k, v in e.items() if k not in ("t_unix", "pid")}
            for e in body["actions"]]
    return out, acts, body.get("config"), asc.status()["actions_total"]


@pytest.mark.parametrize("case", ["ok", "canary_swap_failed",
                                  "follower_respawned",
                                  "canary_regressed"])
def test_roll_fleet_journals_like_jax(tmp_path, case):
    fake = {"ok": {}, "canary_swap_failed": {"fail": (0,)},
            "follower_respawned": {"fail": (1,)},
            "canary_regressed": {"canary_regress": "slo_regressed"}}[case]
    t = _roll_journal(tsup, tas, tmp_path, "t", **fake)
    j = _roll_journal(jsup, jas, tmp_path, "j", **fake)
    assert t == j
    out, acts, config, totals = t
    phases = [(e["seq"], e["phase"]) for e in acts]
    if case == "ok":
        assert out["ok"] and config == {"checkpoint": "/ck/b",
                                        "generation": 1}
        assert phases == [(1, "begin"), (1, "swapped"), (1, "commit"),
                          (2, "begin"), (2, "swapped"), (2, "commit")]
        assert totals == {"roll|roll": 1}
    elif case == "canary_swap_failed":
        assert out["refused"] == "canary_swap_failed" and config is None
        assert phases == [(1, "begin"), (1, "rollback")]
    elif case == "follower_respawned":
        assert out["ok"] and out["respawned"][0]["replica"] == 1
        assert acts[-2]["respawned"] is True
    else:
        assert out["regression"] == "slo_regressed"
        assert [e.get("rollback") for e in acts if e["phase"] == "begin"] \
            == [None, True]
        assert totals == {"roll|canary_rollback_slo_regressed": 1}


def test_resume_roll_back_converges_and_rolls_back(tmp_path):
    """Recovery's ``roll_back`` resume swaps every replica to the
    committed config through journaled rollback actions and resolves the
    open roll with ``roll_incomplete``."""
    sup = _sup(2, tmp=tmp_path)
    fake = _FakeRollFleet(sup)
    fake.gens[0] = 3  # the canary's swap landed just before the kill
    asc = Autoscaler(sup, AutoscaleConfig(),
                     journal_path=str(tmp_path / "j.json"))
    seq = asc.journal.begin("roll", replica=0, checkpoint="/ck/new",
                            generation_from=1, generation_to=3)
    asc._execute_resume({"seq": seq, "action": "roll_back", "replica": 0,
                         "checkpoint": "/ck/old", "generation": 1})
    assert fake.gens == {0: 1, 1: 1}
    assert (sup.checkpoint, sup.weight_generation) == ("/ck/old", 1)
    body, _ = load_journal(asc.journal.path)
    assert open_actions(body) == []
    assert tfin.lint_fleet_journal({"v": 1, "crc": zlib.crc32(
        tas._canonical(body)), "body": body}) == []
    rb = [e for e in body["actions"] if e["seq"] == seq][-1]
    assert rb["phase"] == "rollback" and rb["reason"] == "roll_incomplete"


def test_router_autoscale_and_metrics_ops(tmp_path):
    """Without an autoscaler the ``autoscale`` op answers
    AutoscalerUnavailable; with one it reports the status, forces
    actions (typed refusals here: no process exists) and refuses an
    unknown action; ``fleet_stats`` carries the status and
    ``fleet_metrics`` the autoscaler's families."""
    sup = _sup(1, tmp=tmp_path, collect_metrics=True)
    router = FailoverRouter(sup)
    port = router.start()
    try:
        def op(msg):
            return client_request("127.0.0.1", port, msg, timeout_s=10)

        assert op({"op": "autoscale"})["error"] == "AutoscalerUnavailable"
        assert "autoscaler" not in op({"op": "fleet_stats"})["fleet"]
        assert sup.router is router
        asc = Autoscaler(sup, AutoscaleConfig(min_replicas=1,
                                              max_replicas=1),
                         journal_path=str(tmp_path / "j.json"))
        st = op({"op": "autoscale", "action": "status"})["autoscaler"]
        assert st["enabled"] and st["max_replicas"] == 1
        assert op({"op": "autoscale", "action": "scale_up"})["result"][
            "reason"] == "refused_at_max"
        assert op({"op": "autoscale", "action": "scale_down"})["result"][
            "reason"] == "refused_no_eligible_victim"
        assert op({"op": "autoscale", "action": "rerole", "replica": 0,
                   "role": "mixed"})["result"]["reason"] == \
            "refused_already_that_role"
        assert op({"op": "autoscale", "action": "boom"})["error"] == \
            "BadRequest"
        fs = op({"op": "fleet_stats"})["fleet"]
        assert fs["autoscaler"]["actions_total"] == {
            "spawn|refused_at_max": 1,
            "drain|refused_no_eligible_victim": 1,
            "rerole|refused_already_that_role": 1}
        text = op({"op": "fleet_metrics"})["text"]
        assert 'serving_autoscale_actions_total{action="spawn",' \
               'reason="refused_at_max"} 1' in text
        assert 'serving_fleet_replicas{role="mixed"} 1' in text
        assert asc.journal.seq == 0
    finally:
        router.stop()


def test_main_takes_the_autoscale_flags(tmp_path, monkeypatch):
    """``--autoscale`` and its flags build an Autoscaler with the JAX
    defaults and run its recovery before the fleet starts (here the
    start is stopped at once); ``--mesh`` stays unported."""
    made = {}

    def no_start(self, wait_ready=True):
        made["asc"] = self.autoscaler
        raise KeyboardInterrupt

    monkeypatch.setattr(tsup.Supervisor, "start", no_start)
    # main routes SIGTERM to its cleanup: not in this test process
    monkeypatch.setattr(tsup.signal, "signal", lambda *a: None)
    journal = str(tmp_path / "j.json")
    tsup.main(["--model", "gpt_tiny", "--replicas", "1", "--log-dir",
               str(tmp_path / "logs"), "--autoscale", "--max-replicas",
               "3", "--cooldown-s", "2.5", "--journal", journal,
               "--flight-dir", str(tmp_path / "flight")])
    asc = made["asc"]
    assert asc.journal.path == journal
    assert (asc.cfg.min_replicas, asc.cfg.max_replicas) == (1, 3)
    assert asc.cfg.cooldown_up_s == asc.cfg.cooldown_down_s == 2.5
    assert asc.cfg.interval_s == 1.0
    assert asc.recovery["loaded"] is False
    assert asc.flight is not None
    assert load_journal(journal)[1] is None
    made.clear()
    tsup.main(["--model", "gpt_tiny", "--replicas", "1", "--log-dir",
               str(tmp_path / "logs2")])
    assert made["asc"] is None
    with pytest.raises(SystemExit) as e:
        tsup.main(["--mesh", "model=2"])
    assert e.value.code == 2


def test_recover_adopts_respawns_and_resolves(tmp_path, monkeypatch):
    """``Autoscaler.recover`` on a journal its predecessor left: the live
    replica is adopted (not spawned again), the dead one queued for
    respawn, the open spawn of a dead process rolled back, the committed
    weight config restored; ``start`` then spawns only the dead one."""
    path = str(tmp_path / "j.json")
    prev = FleetJournal(path, supervisor_pid=1)
    # pids beyond the default pid_max: no real process is ever named
    live, dead = 2 ** 22 + 11, 2 ** 22 + 13
    prev.record_fleet([{"idx": 0, "pid": live, "port": 8800,
                        "role": "mixed"},
                       {"idx": 1, "pid": dead, "port": 8801,
                        "role": "decode"}])
    prev.record_config("/ck/rolled", 2)
    s = prev.begin("spawn", replica=2, role="mixed")
    monkeypatch.setattr(tas, "_pid_is_replica",
                        lambda pid, port=None: pid == live)
    sup = _sup(1, tmp=tmp_path)
    asc = Autoscaler(sup, AutoscaleConfig(), journal_path=path)
    rep = asc.recover()
    assert [a["idx"] for a in rep["adopted"]] == [0]
    assert rep["respawned"] == [{"idx": 1, "role": "decode"}]
    assert rep["resolved"] == [{"seq": s, "phase": "rollback",
                                "reason": "orphan_dead"}]
    assert (sup.checkpoint, sup.weight_generation) == ("/ck/rolled", 2)
    assert [r.idx for r in sup.replicas] == [0, 1]
    assert isinstance(sup.replicas[0].proc, tas._AdoptedProc)
    assert sup.replicas[1].proc is None and sup._next_idx == 2
    captured = _capture_spawns(monkeypatch)
    monkeypatch.setattr(tsup.Supervisor, "wait_ready",
                        lambda self, min_ready=None: None)
    sup._stop.set()  # the monitor thread exits at once: it probes nothing
    sup.start()
    sup._monitor.join(timeout=5)
    for r in sup.replicas:
        r.close_log()
    assert len(captured) == 1
    cmd, kw = captured[0]
    assert kw["env"][tas.REPLICA_IDX_ENV] == "1"
    assert cmd[cmd.index("--checkpoint") + 1] == "/ck/rolled"
    body, _ = load_journal(path)
    assert body["seq"] == s and open_actions(body) == []
    assert body["supervisor_pid"] == os.getpid()


def test_chaos_kill_waits_for_the_journaled_window(tmp_path, monkeypatch):
    """The chaos harness kills a supervisor once the journal holds the
    forced action open (a spawn only once its pid is journaled), not
    after a fixed sleep; and its final journal lint first waits out an
    action the autoscaler began of its own."""
    from paddle_tpu_torch.tools import chaos_serving as tcs
    path = str(tmp_path / "fleet-journal.json")
    fleet = tcs._CliFleet(["true"], 0.0, str(tmp_path), 1, path)
    try:
        journal = FleetJournal(path)
        t0 = time.monotonic()
        fleet.wait_open("spawn", timeout_s=0.3)   # no journal yet
        assert time.monotonic() - t0 >= 0.3
        seq = journal.begin("spawn", replica=1, role="mixed")
        t0 = time.monotonic()
        fleet.wait_open("spawn", need=("pid",), timeout_s=0.3)
        assert time.monotonic() - t0 >= 0.3       # begun, not launched
        journal.update(seq, phase="launched", pid=4242, port=1)
        t0 = time.monotonic()
        fleet.wait_open("spawn", need=("pid",), timeout_s=30.0)
        fleet.wait_open("spawn", timeout_s=30.0)
        assert time.monotonic() - t0 < 5.0
        t0 = time.monotonic()
        fleet.wait_open("drain", timeout_s=0.3)   # another kind
        assert time.monotonic() - t0 >= 0.3

        monkeypatch.setattr(fleet, "op", lambda payload, timeout_s=10.0: {
            "autoscaler": {"pending_resumes": 0, "action_in_flight": None}})
        assert not fleet.wait_quiescent(0.6)      # seq still open
        journal.commit(seq)
        t0 = time.monotonic()
        fleet.wait_open("spawn", timeout_s=0.3)   # resolved: not open
        assert time.monotonic() - t0 >= 0.3
        assert fleet.wait_quiescent(30.0)
        monkeypatch.setattr(fleet, "op", lambda payload, timeout_s=10.0: {
            "autoscaler": {"pending_resumes": 0,
                           "action_in_flight": "drain"}})
        assert not fleet.wait_quiescent(0.6)      # in flight, journal clean
    finally:
        fleet.log.close()


def test_spawn_kills_the_process_it_replaces(tmp_path, monkeypatch):
    """A replica's respawn stops the process it replaces if that still
    runs: the monitor's respawn and a roll's ``_respawn_with_config``
    racing on one replica left the first spawn's server running with
    no handle to it (a stranded process in ``run_roll_chaos``)."""
    import threading

    class Proc:
        def __init__(self):
            self.pid, self.returncode = 4242, None

        def poll(self):
            return self.returncode

        def kill(self):
            self.returncode = -9

        def wait(self, timeout=None):
            return self.returncode

    spawned = []

    def popen(cmd, **kw):
        time.sleep(0.01)     # widen the window between read and replace
        spawned.append(Proc())
        return spawned[-1]

    monkeypatch.setattr(tsup.subprocess, "Popen", popen)
    sup = _sup(1, tmp=tmp_path)
    rep = sup.replicas[0]
    try:
        sup._spawn(rep)
        first = rep.proc
        sup._spawn(rep)
        assert first.returncode == -9 and rep.proc.returncode is None
        rep.proc.returncode = 1           # died on its own: left alone
        sup._spawn(rep)
        assert spawned[1].returncode == 1
        threads = [threading.Thread(target=sup._spawn, args=(rep,))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        running = [p for p in spawned if p.returncode is None]
        assert running == [rep.proc] and len(spawned) == 11
    finally:
        rep.close_log()


# -- the autoscale chaos harness's diagnostics ---------------------------------

def _cli_fleet(tmp_path, replies):
    """A ``_CliFleet`` whose router answers from ``replies`` (op ->
    reply); no process is started."""
    from paddle_tpu_torch.tools import chaos_serving as cs
    fleet = cs._CliFleet(["true"], 0.0, str(tmp_path), 1,
                         str(tmp_path / "fleet-journal.json"))
    fleet.op = lambda payload, timeout_s=10.0: dict(
        replies[payload["op"]])
    return fleet


def test_wait_router_error_carries_scale_up_and_health(tmp_path):
    """A refused scale-up followed by a fleet that never serves two live
    replicas: the error names the refusal, the last health reply (one
    live replica, the other not ready) and the autoscaler's status, so
    the fault can be told apart after the machine is gone."""
    health = {"status": "ok", "live": 1, "replicas": [
        {"idx": 0, "ready": True, "alive": True},
        {"idx": 1, "ready": False, "alive": True}]}
    fleet = _cli_fleet(tmp_path, {
        "health": health,
        "autoscale": {"autoscaler": {"replicas": 3,
                                     "recovery": {"adopted": [1]}}}})
    up = {"result": {"reason": "refused_at_max", "ok": False}}
    with pytest.raises(RuntimeError) as err:
        fleet.wait_router(min_live=2, timeout_s=0.4,
                          context={"scale_up": up})
    msg = str(err.value)
    assert "refused_at_max" in msg
    assert '"ready": false' in msg and '"live": 1' in msg
    assert '"adopted": [1]' in msg
    assert fleet.wait_router(min_live=1, timeout_s=0.4) == health
    fleet.stop()


def test_scale_up_reason_names_refusals_errors_and_transport():
    from paddle_tpu_torch.tools.chaos_serving import _scale_up_reason
    assert _scale_up_reason({"result": {"reason": "forced", "ok": True}}) \
        == "forced"
    assert _scale_up_reason({"result": {"reason": "never_ready"}}) == \
        "never_ready"
    assert _scale_up_reason({"error": "autoscaler not enabled"}) == \
        "autoscaler not enabled"
    assert _scale_up_reason(
        {"_transport_error": "ConnectionRefusedError: [Errno 111]"}
    ).startswith("ConnectionRefusedError")


def test_keep_logs_copies_logs_flight_and_journal(tmp_path):
    from paddle_tpu_torch.tools.chaos_serving import keep_logs
    src = tmp_path / "run"
    (src / "flight").mkdir(parents=True)
    (src / "replica0.log").write_text("boot\n")
    (src / "supervisor-cli.log").write_text("sup\n")
    (src / "fleet-journal.json").write_text("{}")
    (src / "flight" / "bundle-1.tar").write_text("x")
    (src / "weights.bin").write_text("big")
    dest = tmp_path / "kept"
    assert keep_logs(str(src), str(dest)) == str(dest)
    kept = sorted(str(p.relative_to(dest)) for p in dest.rglob("*")
                  if p.is_file())
    assert kept == ["fleet-journal.json", os.path.join("flight",
                                                       "bundle-1.tar"),
                    "replica0.log", "supervisor-cli.log"]
    assert keep_logs(str(src), None) == str(src)


def test_autoscale_chaos_failure_keeps_its_error_and_the_logs(
        tmp_path, monkeypatch):
    """A run that raises stops the fleet, copies the logs once, and
    re-raises the original exception with the kept directory as a
    note."""
    from paddle_tpu_torch.tools import chaos_serving as cs
    stops = []

    class Fleet:
        def __init__(self, *args):
            pass

        def launch(self):
            pass

        def stop(self):
            stops.append(1)

    def oracle(*args):
        raise AssertionError("oracle disagrees")

    monkeypatch.setattr(cs, "_CliFleet", Fleet)
    monkeypatch.setattr(cs, "_reference_outputs", oracle)
    monkeypatch.setattr(cs.time, "sleep", lambda s: None)
    log_dir, dest = tmp_path / "run", tmp_path / "kept"
    log_dir.mkdir()
    (log_dir / "replica0.log").write_text("boot\n")
    with pytest.raises(AssertionError, match="oracle disagrees") as err:
        cs.run_autoscale_chaos(requests=2, device="cpu",
                               log_dir=str(log_dir), failure_dir=str(dest))
    assert err.value.__notes__ == [f"logs and journal kept in {dest}"]
    assert (dest / "replica0.log").read_text() == "boot\n"
    assert stops == [1]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pressure_drain_waits_its_cooldown_after_a_spawn(
        pkg, tmp_path, monkeypatch):
    """A forced spawn joins an idle fleet; the next pressure verdict says
    scale down. The port's autoscaler refuses that drain for
    ``cooldown_down_s`` after the spawn joined; the JAX package's drains
    at once, undoing the scale-up (the autoscale chaos run on the card
    that served one live replica for 300 s: a pressure drain began 10 ms
    after the forced spawn committed). A forced drain is not held."""
    sup_mod, as_mod = (tsup, tas) if pkg == "port" else (jsup, jas)
    monkeypatch.delenv("PT_AUTOSCALE_HOLD_S", raising=False)
    sup = sup_mod.Supervisor(model="gpt_tiny", replicas=1,
                             collect_metrics=False, log_dir=str(tmp_path))
    _capture_spawns(monkeypatch, sup_mod)
    asc = as_mod.Autoscaler(sup, as_mod.AutoscaleConfig(
        min_replicas=1, max_replicas=3, cooldown_up_s=60.0,
        cooldown_down_s=60.0), journal_path=str(tmp_path / "j.json"))
    for rep in sup.replicas:
        rep.proc, rep.ready = _FakeProc(), True
    asc._wait_replica_ready = lambda rep, timeout_s: True
    asc._finish_drain = lambda victim, seq, reason: {"reason": "drained"}
    assert asc.scale_up(force=True)["ok"]
    for rep in sup.replicas:
        rep.close_log()
    assert len(sup.replicas) == 2
    got = asc.scale_down(reason="pressure")["reason"]
    if pkg == "port":
        assert got == "refused_cooldown"
        assert asc.status()["cooldown_down_remaining_s"] > 59.0
        assert asc.scale_down(force=True)["reason"] == "drained"
    else:
        assert got == "drained"


def test_chaos_depth_cut_reaches_replicas_and_oracle():
    """``num_layers`` cuts the served model's depth, its widths kept, and
    the chaos harnesses pass it to every replica's command line."""
    from paddle_tpu_torch.serving.server import build_model
    from paddle_tpu_torch.tools.chaos_serving import _server_args
    full = build_model("gpt_tiny", "cpu")
    cut = build_model("gpt_tiny", "cpu", num_layers=1)
    assert cut.config.num_layers == 1 < full.config.num_layers
    assert cut.config.hidden_size == full.config.hidden_size
    args = _server_args("cpu", 8, 96, 2, num_layers=1)
    assert args[args.index("--num-layers") + 1] == "1"
    assert "--num-layers" not in _server_args("cpu", 8, 96, 2)
