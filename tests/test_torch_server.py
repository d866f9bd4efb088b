"""The PyTorch port's serving front-end on the CPU (``device="cpu"``)
with gpt_tiny: streaming and plain generate, health, stats, metrics,
drain and the page audit, over a real localhost socket.
"""

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
    ({"op": "swap"}, "BadRequest"),       # not ported: an unknown op
    ({"op": "capacity"}, "BadRequest"),
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


def test_prefix_cache_is_not_ported(model):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ServingServer(model, device="cpu", prefix_cache=True)


def test_cli_rejects_unported_flags_like_an_unknown_flag():
    with pytest.raises(SystemExit) as e:
        srv.main(["--device", "cpu", "--speculate", "4"])
    assert e.value.code == 2
