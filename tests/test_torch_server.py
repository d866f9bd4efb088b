"""The PyTorch port's serving front-end on the CPU (``device="cpu"``)
with gpt_tiny: streaming and plain generate, health, stats, metrics,
drain and the page audit, over a real localhost socket.
"""

import _torch_threads  # noqa: F401

import threading

import numpy as np
import pytest

from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import server as srv
from paddle_tpu_torch.serving.server import ServingServer, client_request


@pytest.fixture(scope="module")
def model():
    return GPTForCausalLM(gpt_tiny(), device="cpu")


@pytest.fixture
def server(model):
    s = ServingServer(model, device="cpu", num_slots=2, page_size=8,
                      max_seq_len=64, num_pages=12)
    port = s.start()
    yield s, port
    s.stop()


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, n).tolist()


def test_streaming_and_plain_generate(server):
    s, port = server
    streamed = []
    rep = client_request("127.0.0.1", port,
                         {"op": "generate", "prompt": _prompt(9),
                          "max_new_tokens": 6, "stream": True},
                         timeout_s=60, on_token=streamed.append)
    assert rep["done"] and len(rep["generated"]) == 6
    assert streamed == rep["generated"]
    assert rep["tokens"][:9] == _prompt(9)
    again = client_request("127.0.0.1", port,
                           {"op": "generate", "prompt": _prompt(9),
                            "max_new_tokens": 6}, timeout_s=60)
    assert again["generated"] == rep["generated"]  # greedy


def test_concurrent_requests_share_the_engine(server):
    s, port = server
    replies = [None] * 4

    def one(i):
        replies[i] = client_request(
            "127.0.0.1", port,
            {"op": "generate", "prompt": _prompt(5 + 3 * i, i),
             "max_new_tokens": 5, "stream": i % 2 == 0}, timeout_s=60)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(r and r["done"] and len(r["generated"]) == 5
               for r in replies)


def test_health_stats_metrics_drain_leak_check(server):
    s, port = server
    client_request("127.0.0.1", port, {"op": "generate",
                                       "prompt": _prompt(4),
                                       "max_new_tokens": 3}, timeout_s=60)
    health = client_request("127.0.0.1", port, {"op": "health"})
    assert health["status"] == "ok" and health["device"] == "cpu"
    assert health["num_pages"] == 12
    stats = client_request("127.0.0.1", port, {"op": "stats"})
    assert stats["stats"]["counters"]["requests_total"] >= 1
    assert stats["programs_launched"]["decode"] >= 2
    text = client_request("127.0.0.1", port, {"op": "metrics"})["text"]
    assert "serving_ttft_ms" in text
    assert client_request("127.0.0.1", port, {"op": "drain"})["ok"]
    late = client_request("127.0.0.1", port,
                          {"op": "generate", "prompt": [1, 2]})
    assert late["error"] == "ServerDraining"
    leak = client_request("127.0.0.1", port, {"op": "leak_check"})
    assert leak["ok"] and leak["free_pages"] == 12
    assert leak["ledger"]["ok"]


@pytest.mark.parametrize("payload,error", [
    ({"op": "generate", "prompt": []}, "BadRequest"),
    ({"op": "generate", "prompt": [1], "max_new_tokens": 0}, "BadRequest"),
    ({"op": "generate", "prompt": [1], "priority": "urgent"}, "BadRequest"),
    ({"op": "generate", "prompt": [1], "deadline_ms": -1}, "BadRequest"),
    ({"op": "generate", "prompt": [1] * 70}, "BadRequest"),
    ({"op": "swap"}, "BadRequest"),       # no checkpoint named
    ({"op": "fetch_pages"}, "BadRequest"),  # not ported: an unknown op
])
def test_typed_errors(server, payload, error):
    s, port = server
    rep = client_request("127.0.0.1", port, payload, timeout_s=60)
    assert rep["error"] == error


def test_deadline_exceeded_is_typed(server):
    s, port = server
    rep = client_request("127.0.0.1", port,
                         {"op": "generate", "prompt": _prompt(5),
                          "max_new_tokens": 40, "deadline_ms": 0.001},
                         timeout_s=60)
    assert rep["error"] == "DeadlineExceeded"


def test_default_prefix_cache_answers_a_repeated_prompt(model):
    """The server's cache is on by default: a repeated prompt reuses its
    full pages and gets the tokens a cache-less server gives."""
    prompt = _prompt(29, seed=3)  # 3 full pages of 8 are shareable
    replies = {}
    for cache in (True, False):
        s = ServingServer(model, device="cpu", prefix_cache=cache,
                          num_slots=2, page_size=8, max_seq_len=64,
                          num_pages=12)
        port = s.start()
        try:
            replies[cache] = [client_request(
                "127.0.0.1", port, {"op": "generate", "prompt": prompt,
                                    "max_new_tokens": 6}, timeout_s=60)
                for _ in range(2)]
            stats = client_request("127.0.0.1", port, {"op": "stats"})
            leak = client_request("127.0.0.1", port,
                                  {"op": "leak_check"})
        finally:
            s.stop()
        assert leak["ok"], leak
        if cache:
            assert stats["prefix_cache"]["hit_pages"] == 3
            assert leak["cached_pages"] == 3
        else:
            assert stats["prefix_cache"] is None
    on, off = replies[True], replies[False]
    assert on[0]["stats"]["cached_pages"] == 0
    assert on[1]["stats"]["cached_pages"] == 3
    assert on[1]["stats"]["cache_enabled"] is True
    assert off[1]["stats"]["cached_pages"] == 0
    assert [r["generated"] for r in on] == [r["generated"] for r in off]


def test_cli_builds_the_server_from_its_flags(monkeypatch):
    made = {}

    class Stop(Exception):
        pass

    class Fake:
        def __init__(self, model, **kw):
            made.update(kw)

        def start(self):
            raise Stop

    monkeypatch.setattr(srv, "ServingServer", Fake)
    monkeypatch.setattr(srv, "build_model", lambda name, dev: None)
    with pytest.raises(Stop):
        srv.main(["--device", "cpu", "--no-prefix-cache", "--spill-mb",
                  "2", "--spill-dir", "/x", "--spill-disk-mb", "3",
                  "--blob-format", "int4",
                  "--max-engine-restarts", "5", "--no-dedup",
                  "--prefill-chunk", "128", "--speculate", "3",
                  "--draft-window", "32"])
    assert made["prefix_cache"] is False and made["dedup"] is False
    assert made["prefill_chunk_tokens"] == 128
    spec = made["speculative"]
    assert (spec.k, spec.draft, spec.draft_window) == (3, "ngram", 32)
    assert made["spill_bytes"] == 2 << 20
    assert made["spill_dir"] == "/x" and made["spill_disk_bytes"] == 3 << 20
    assert made["blob_format"] == "int4"
    assert made["max_engine_restarts"] == 5
    made.clear()
    with pytest.raises(Stop):
        srv.main(["--device", "cpu"])
    assert made["prefix_cache"] is True and made["spill_bytes"] is None
    assert made["max_engine_restarts"] == 2 and made["blob_format"] == "raw"
    assert made["dedup"] is True
    assert "prefill_chunk_tokens" not in made and "speculative" not in made


def test_cli_rejects_unported_flags_like_an_unknown_flag():
    with pytest.raises(SystemExit) as e:
        srv.main(["--device", "cpu", "--mesh", "2"])
    assert e.value.code == 2


@pytest.mark.parametrize("flag", [["--role", "prefill"],
                                  ["--flight-dir", "/tmp/x"],
                                  ["--flight-budget-mb", "8"],
                                  ["--handoff-timeout-s", "5"]])
def test_cli_rejects_fleet_flags_like_an_unknown_flag(flag, monkeypatch):
    """Each fleet flag reaches the server under the JAX server's name
    and default; with ``--mesh``, still unported, the command line is
    answered as one with an unknown flag."""
    made = {}

    class Stop(Exception):
        pass

    class Fake:
        def __init__(self, model, **kw):
            made.update(kw)

        def start(self):
            raise Stop

    monkeypatch.setattr(srv, "ServingServer", Fake)
    monkeypatch.setattr(srv, "build_model", lambda name, dev: None)
    with pytest.raises(Stop):
        srv.main(["--device", "cpu"])
    assert (made["role"], made["flight_dir"], made["flight_budget_bytes"],
            made["handoff_timeout_s"]) == ("mixed", None, 64 << 20, 30.0)
    want = {"--role": ("role", "prefill"),
            "--flight-dir": ("flight_dir", "/tmp/x"),
            "--flight-budget-mb": ("flight_budget_bytes", 8 << 20),
            "--handoff-timeout-s": ("handoff_timeout_s", 5.0)}[flag[0]]
    with pytest.raises(Stop):
        srv.main(["--device", "cpu"] + flag)
    assert made[want[0]] == want[1]
    with pytest.raises(SystemExit) as e:
        srv.main(["--device", "cpu", "--mesh", "2"] + flag)
    assert e.value.code == 2
