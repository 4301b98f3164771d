"""The traffic generator: the same bytes for a seed, the same work for
every seed in another order, inside the window and the mix's clips. The
serving mix is the test's own: no cell serves yet."""

import copy
import json
from collections import Counter

import torch

from portbench import traffic

MIX = {
    "kind": "serve",
    "engine": {"num_slots": 32, "max_len": 1536, "page_size": 16,
               "prefill_chunk": 512, "kv_pages": 3073},
    "arrivals": {"process": "poisson", "rate_per_s": 3.2},
    "schedule_seed": 20261018,
    "system_prompts": {"count": 4, "tokens": 256},
    "user_tokens": {"median": 256, "sigma": 0.8, "lo": 32, "hi": 1023},
    "output_tokens": {"median": 96, "sigma": 0.7, "lo": 16, "hi": 256},
}


def chat():
    return copy.deepcopy(MIX)


def sizes(reqs):
    return Counter((r["system"], len(r["prompt"]), r["max_new_tokens"])
                   for r in reqs)


def test_same_seed_same_bytes():
    a = traffic.chat_requests(chat(), 40, 2 ** 31 + 5, 32768)
    b = traffic.chat_requests(chat(), 40, 2 ** 31 + 5, 32768)
    assert json.dumps(a) == json.dumps(b)


def test_every_seed_offers_the_same_work_in_another_order():
    a = traffic.chat_requests(chat(), 40, 11, 32768)["requests"]
    b = traffic.chat_requests(chat(), 40, 2 ** 31 + 12, 32768)["requests"]
    assert sizes(a) == sizes(b)
    assert [r["due"] for r in a] != [r["due"] for r in b]
    assert abs(a[-1]["due"] - b[-1]["due"]) < 1e-9  # the same gaps summed
    assert [r["prompt"] for r in a] != [r["prompt"] for r in b]


def test_requests_inside_the_window_and_the_clips():
    mix = chat()
    got = traffic.chat_requests(mix, 40, 3, 32768)
    sysn = mix["system_prompts"]["tokens"]
    user, out = mix["user_tokens"], mix["output_tokens"]
    assert len(got["systems"]) == mix["system_prompts"]["count"]
    for r in got["requests"]:
        assert 0 < r["due"] < 40
        assert r["prompt"][:sysn] == got["systems"][r["system"]]
        assert user["lo"] <= len(r["prompt"]) - sysn <= user["hi"]
        assert out["lo"] <= r["max_new_tokens"] <= out["hi"]
        # the whole request fits a slot with the engine's margin row
        assert (len(r["prompt"]) + r["max_new_tokens"] + 1
                <= mix["engine"]["max_len"])
        assert all(0 <= t < 32768 for t in r["prompt"])


def test_train_batches_from_the_seed():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return traffic.train_batches(g, 2, 4, 16, 100, "cpu")

    assert torch.equal(draw(7), draw(7))
    assert draw(7).shape == (2, 4, 17)
    assert not torch.equal(draw(7), draw(8))
