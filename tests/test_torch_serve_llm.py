"""The PyTorch port's continuous-batching engine (ray_tpu_torch.serve.llm
and serve.paged_kv) against the JAX package's `generate`, on the same
weights, mirroring tests/test_serve_llm.py and tests/test_paged_kv.py.

Greedy tokens must be equal (f32 on the CPU). Paged and slotted steps
must agree bit for bit within the port. Every engine a test builds is
shut down by the `engines` fixture.
"""

import gc
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from ray_tpu.models.generate import generate as jax_generate
from ray_tpu.serve.llm import LLMReplica as JaxLLMReplica
from ray_tpu_torch.exceptions import (
    PromptTooLongError,
    RequestCancelledError,
    ServeOverloadedError,
)
from ray_tpu_torch.models import configs, params_from_jax
from ray_tpu_torch.models.generate import generate
from ray_tpu_torch.serve import context, llm, paged_kv
from ray_tpu_torch.serve.llm import ContinuousBatchingEngine, LLMReplica

torch.set_num_threads(1)

# Mixed lengths; the last prompt spans three chunks of 8.
PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9], [4], [9, 9, 2, 1],
           list(range(10, 29))]
MAX_NEW = 6


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jax_configs.tiny, configs.tiny
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jp, jcfg, tp, tcfg


@pytest.fixture(scope="module")
def jax_refs(tiny):
    jp, jcfg, _, _ = tiny
    return [np.asarray(jax_generate(jp, jnp.asarray([p], dtype=jnp.int32),
                                    jcfg, max_new_tokens=MAX_NEW))[0].tolist()
            for p in PROMPTS]


@pytest.fixture
def engines():
    made = []
    yield made
    for e in made:
        e.shutdown()


def _engine(engines, tiny, **kw):
    _, _, tp, tcfg = tiny
    eng = ContinuousBatchingEngine(tp, tcfg, **kw)
    engines.append(eng)
    return eng


def _wait_for(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


@pytest.mark.parametrize("kv_mode", ["paged", "slotted"])
def test_engine_greedy_equals_jax_generate(engines, tiny, jax_refs, kv_mode):
    """Concurrent mixed-length prompts (more than slots, so some queue),
    a three-chunk prompt, and max_len 60 that the chunk of 8 does not
    divide."""
    eng = _engine(engines, tiny, num_slots=3, max_len=60, prefill_chunk=8,
                  kv_mode=kv_mode, page_size=4)
    handles = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    outs = [h.result(timeout=120) for h in handles]
    assert outs == jax_refs
    st = eng.stats()
    assert st["kv"]["mode"] == kv_mode
    assert st["prefill_chunks"] == sum(-(-len(p) // 8) for p in PROMPTS)


def test_paged_and_slotted_steps_are_bit_exact(tiny):
    """The same prefill and decode steps through the slotted cache and
    through a scrambled block table give identical logits, tokens and
    K/V rows."""
    _, _, tp, tcfg = tiny
    slots, max_len, ps, mp = 2, 16, 4, 4
    sl = llm.init_slotted_cache(tcfg, slots, max_len, device="cpu")
    pg = paged_kv.init_paged_cache(tcfg, slots, 1 + slots * mp, ps, mp,
                                   device="cpu")
    bt = torch.tensor([[8, 3, 5, 1], [2, 7, 4, 6]])
    prompts = {1: [11, 12, 13, 14, 15, 16, 17], 0: [40, 41, 42]}
    for slot, prompt in prompts.items():
        toks = torch.zeros((1, 8), dtype=torch.int64)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        ls = llm._prefill_chunk(tp, toks, len(prompt), slot, 0, sl["k"],
                                sl["v"], sl["lengths"], tcfg)
        lp = paged_kv.prefill_chunk_paged(tp, toks, len(prompt), slot, 0,
                                          pg["k"], pg["v"], pg["lengths"],
                                          bt, tcfg, max_len)
        assert torch.equal(ls, lp)
    assert torch.equal(sl["lengths"], pg["lengths"])
    tokens = torch.tensor([3, 9])
    active = torch.tensor([True, True])
    len_s, len_p = sl["lengths"], pg["lengths"]
    for _ in range(4):
        ts, len_s = llm._decode_slots(tp, tokens, sl["k"], sl["v"], len_s,
                                      active, None, None, None, None, tcfg)
        tpg, len_p = paged_kv.decode_paged(tp, tokens, pg["k"], pg["v"],
                                           len_p, active, bt, None, None,
                                           None, None, tcfg, max_len)
        assert torch.equal(ts, tpg) and torch.equal(len_s, len_p)
        tokens = ts
    for slot in range(slots):
        n = int(len_s[slot])
        k_p = pg["k"][:, bt[slot]].reshape(tcfg.n_layers, mp * ps,
                                           tcfg.n_kv_heads, tcfg.head_dim)
        assert torch.equal(k_p[:, :n], sl["k"][:, slot, :n])


def test_prefix_cache_skips_prefill_and_keeps_tokens(engines, tiny):
    _, _, tp, tcfg = tiny
    eng = _engine(engines, tiny, num_slots=2, max_len=64, prefill_chunk=8,
                  kv_mode="paged", page_size=4)
    prompt = list(range(30, 43))  # 13 tokens: 3 full pages + 1
    ref = generate(tp, [prompt], tcfg, max_new_tokens=5)[0].tolist()
    assert eng.submit(prompt, max_new_tokens=5).result(60) == ref
    chunks0 = eng.stats()["prefill_chunks"]
    assert eng.submit(prompt, max_new_tokens=5).result(60) == ref
    st = eng.stats()
    assert st["kv"]["prefix_hits"] == 1
    assert st["kv"]["prefill_tokens_skipped"] == 12
    assert st["prefill_chunks"] - chunks0 == 1
    # A prompt of whole pages hits fully: its last token is recomputed into
    # a copy-on-write fork of the last shared page.
    whole = prompt[:12]
    ref_w = generate(tp, [whole], tcfg, max_new_tokens=5)[0].tolist()
    assert eng.submit(whole, max_new_tokens=5).result(60) == ref_w
    assert eng.stats()["kv"]["prefill_tokens_skipped"] == 12 + 11
    # A shared two-page prefix with another tail.
    other = prompt[:8] + [7, 7, 7]
    ref_o = generate(tp, [other], tcfg, max_new_tokens=5)[0].tolist()
    assert eng.submit(other, max_new_tokens=5).result(60) == ref_o
    assert eng.stats()["kv"]["prefix_hits"] == 3


def test_no_page_leaks_over_200_admit_evict_cycles(engines, tiny):
    eng = _engine(engines, tiny, num_slots=4, max_len=32, prefill_chunk=8,
                  kv_mode="paged", page_size=4)
    rng = np.random.default_rng(7)
    for _ in range(10):
        hs = []
        for _ in range(20):
            n = int(rng.integers(1, 21))
            prompt = rng.integers(0, 6, size=n).tolist()  # shared prefixes
            hs.append((eng.submit(prompt, max_new_tokens=int(
                rng.integers(1, 5))), n))
        for h, _ in hs:
            assert 1 <= len(h.result(timeout=120)) <= 4

    def settled():
        kv = eng.stats()["kv"]
        return (kv["pages_in_use"] == kv["prefix_cache_pages"]
                and eng.stats()["active"] == 0)

    _wait_for(settled)
    with eng._lock:
        eng._prefix_cache.flush()
    kv = eng.stats()["kv"]
    assert kv["pages_in_use"] == 0 and kv["pages_free"] == kv["pages_total"]
    assert eng.stats()["free_slots"] == 4


def test_prompt_too_long(engines, tiny):
    eng = _engine(engines, tiny, num_slots=2, max_len=32, kv_mode="slotted")
    with pytest.raises(PromptTooLongError) as err:
        eng.submit(list(range(31)))
    assert err.value.max_prompt_len == 30
    small = _engine(engines, tiny, num_slots=1, max_len=32, page_size=4,
                    kv_pages=3, kv_mode="paged")
    with pytest.raises(PromptTooLongError) as err:
        small.submit(list(range(7)))
    assert err.value.max_prompt_len == 6
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit([1], top_k=llm.MAX_TOP_K + 1)


def test_top_k_one_sampling_equals_greedy(engines, tiny):
    eng = _engine(engines, tiny, num_slots=3, max_len=64, kv_mode="paged")
    prompt = [3, 7, 11, 2]
    greedy = eng.submit(prompt, max_new_tokens=8)
    top1 = eng.submit(prompt, max_new_tokens=8, temperature=0.9, top_k=1)
    other = eng.submit([5, 1], max_new_tokens=8, temperature=0.8,
                       top_k=20, top_p=0.95)
    g = greedy.result(60)
    assert top1.result(60) == g
    s = other.result(60)
    assert len(s) == 8 and all(0 <= t < configs.tiny.vocab_size for t in s)


def test_pick_tokens_filters_like_generate():
    """Per-slot top-k/top-p in `_pick_tokens` keep exactly the tokens the
    single-request filters keep: sampling never leaves that set."""
    from ray_tpu_torch.models.generate import _filter_top_k, _filter_top_p

    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 0.7, 1.3])
    top_ks = torch.tensor([0, 5, 0])
    top_ps = torch.tensor([1.0, 1.0, 0.6])
    allowed = [
        {int(torch.argmax(logits[0]))},
        set(torch.nonzero(torch.isfinite(
            _filter_top_k(logits[1:2] / 0.7, 5)[0])).flatten().tolist()),
        set(torch.nonzero(torch.isfinite(
            _filter_top_p(logits[2:3] / 1.3, 0.6)[0])).flatten().tolist()),
    ]
    gen = torch.Generator().manual_seed(0)
    seen = [set(), set(), set()]
    for _ in range(300):
        out = llm._pick_tokens(logits, temps, top_ks, top_ps, gen)
        for i, t in enumerate(out.tolist()):
            seen[i].add(t)
    assert seen[0] == allowed[0]
    assert seen[1] <= allowed[1] and len(seen[1]) > 1
    assert seen[2] <= allowed[2]


def test_cancel_frees_the_slot(engines, tiny):
    eng = _engine(engines, tiny, num_slots=2, max_len=128, kv_mode="paged")
    h = eng.submit([1, 2, 3], max_new_tokens=100)
    it = iter(h)
    next(it)
    h.cancel()
    with pytest.raises(RequestCancelledError):
        h.result(5)
    _wait_for(lambda: eng.stats()["free_slots"] == 2)
    assert eng.stats()["kv"]["pages_in_use"] == eng.stats()["kv"][
        "prefix_cache_pages"]


def test_expired_deadline_is_refused(engines, tiny):
    eng = _engine(engines, tiny, num_slots=1, max_len=32, kv_mode="slotted")
    meta = context.RequestMeta(deadline_ts=time.time() - 1.0, tenant="t")
    with context.bind(meta):
        with pytest.raises(RequestCancelledError) as err:
            eng.submit([1, 2])
    assert err.value.reason == "deadline"
    assert eng.stats()["deadline_expired"] == 1


def test_full_admission_queue_sheds(engines, tiny, monkeypatch):
    from ray_tpu_torch._private.config import get_config

    eng = _engine(engines, tiny, num_slots=1, max_len=32, kv_mode="slotted")
    monkeypatch.setattr(get_config(), "serve_max_queued_per_engine", 0)
    with pytest.raises(ServeOverloadedError):
        eng.submit([1, 2])
    assert eng.stats()["shed_total"] == 1


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_a_dropped_replica_stops_its_engine(tiny, package):
    """A replica built in this process and dropped without shutdown():
    its finalizer stops the engine, whose thread would otherwise run on,
    holding the weights and the KV cache (the JAX package's __del__; the
    port's too)."""
    jp, jcfg, tp, tcfg = tiny
    replica, loaded = ((JaxLLMReplica, (jp, jcfg)) if package == "ray_tpu"
                       else (LLMReplica, (tp, tcfg)))

    def engine_threads():
        return {t for t in threading.enumerate()
                if t.name == "llm-engine" and t.is_alive()}

    before = engine_threads()
    rep = replica(lambda: loaded, num_slots=2, max_len=32,
                  default_max_new_tokens=4)
    thread = rep.engine._thread
    assert thread.is_alive() and thread in engine_threads()
    del rep
    gc.collect()
    deadline = time.monotonic() + 5.0
    while thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not thread.is_alive(), "the dropped replica's engine runs on"
    assert engine_threads() <= before


def test_llm_replica_call_and_stream(tiny):
    _, _, tp, tcfg = tiny
    rep = LLMReplica(lambda: (tp, tcfg), num_slots=2, max_len=32,
                     default_max_new_tokens=4)
    try:
        ref = generate(tp, [[2, 4, 6]], tcfg, max_new_tokens=4)[0].tolist()
        assert rep([2, 4, 6]) == ref
        assert list(rep.stream([2, 4, 6])) == ref
        rep.shutdown()  # joins the loop: every step dispatched is drained
        st = rep.stats()
        assert st["latency"]["ttft"]["count"] == 2
        assert st["forward_passes"] == st["prefill_chunks"] + st["steps"]
    finally:
        rep.shutdown()


def test_paused_stream_consumer_does_not_stall_the_engine(engines, tiny):
    """A consumer that holds a stream between tokens must not block the
    engine from pushing tokens (to this or any other request)."""
    _, _, tp, tcfg = tiny
    eng = _engine(engines, tiny, num_slots=2, max_len=64, kv_mode="paged")
    ha = eng.submit([1, 2, 3], max_new_tokens=8)
    it = iter(ha)
    first = next(it)  # the generator is now suspended mid-stream
    hb = eng.submit([4, 5], max_new_tokens=5)
    ref_b = generate(tp, [[4, 5]], tcfg, max_new_tokens=5)[0].tolist()
    assert hb.result(timeout=60) == ref_b
    ref_a = generate(tp, [[1, 2, 3]], tcfg, max_new_tokens=8)[0].tolist()
    assert [first] + list(it) == ref_a
