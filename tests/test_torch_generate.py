"""Parity of the PyTorch port's generation (ray_tpu_torch.models.generate)
with the JAX package's, on the same weights (converted from a JAX tree)
and the same prompts.

Logits agree within 1e-4 in f32: both sum the same products, in other
orders (XLA's and PyTorch's CPU matmuls and softmax). Greedy tokens are
equal. Samplers draw different bits from different generators, so the
sampler is held to its distribution, and the filters to JAX exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from ray_tpu_torch.models import configs, params_from_jax

# The packages' models/__init__ export the `generate` function under the
# module's name, so the modules are looked up by path.
jax_gen = importlib.import_module("ray_tpu.models.generate")
tgen = importlib.import_module("ray_tpu_torch.models.generate")

torch.set_num_threads(1)

NAMES = ["tiny", "tiny_gqa", "tiny_gemma", "tiny_qwen"]


def _models(name, seed=0):
    jcfg, tcfg = jax_configs.NAMED_CONFIGS[name], configs.NAMED_CONFIGS[name]
    jp = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jp, jcfg, tp, tcfg


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_logits_match_jax(name):
    jp, jcfg, tp, tcfg = _models(name)
    rng = np.random.default_rng(1)
    b, lp, steps, max_len = 2, 6, 3, 16
    prompt = rng.integers(0, tcfg.vocab_size, size=(b, lp)).astype(np.int32)
    nxt = rng.integers(0, tcfg.vocab_size, size=(steps, b)).astype(np.int32)
    jcache = jax_gen.init_kv_cache(jcfg, b, max_len)
    tcache = tgen.init_kv_cache(tcfg, b, max_len, device="cpu")
    jl, jcache = jax_gen.prefill(jp, jnp.asarray(prompt), jcache, jcfg)
    tl, tcache = tgen.prefill(tp, torch.from_numpy(prompt).long(), tcache,
                              tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for s in range(steps):
        jl, jcache = jax_gen.decode_step(jp, jnp.asarray(nxt[s]), jcache, jcfg)
        tl, tcache = tgen.decode_step(tp, torch.from_numpy(nxt[s]).long(),
                                      tcache, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    assert tcache["length"] == int(jcache["length"]) == lp + steps
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_generate_equals_jax(name):
    jp, jcfg, tp, tcfg = _models(name)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, tcfg.vocab_size, size=(2, 5)).astype(np.int32)
    want = np.asarray(jax_gen.generate(jp, jnp.asarray(prompt), jcfg,
                                       max_new_tokens=8))
    got = tgen.generate(tp, prompt, tcfg, max_new_tokens=8)
    assert got.dtype == torch.int64 and got.shape == (2, 8)
    assert got.tolist() == want.tolist()


def test_generate_pads_with_eos_after_stopping():
    jp, jcfg, tp, tcfg = _models("tiny")
    prompt = np.array([[3, 1, 4, 1, 5]], dtype=np.int32)
    free = tgen.generate(tp, prompt, tcfg, max_new_tokens=8)[0].tolist()
    eos = free[2]
    got = tgen.generate(tp, prompt, tcfg, max_new_tokens=8, eos_id=eos)
    want = np.asarray(jax_gen.generate(jp, jnp.asarray(prompt), jcfg,
                                       max_new_tokens=8, eos_id=eos))
    assert got.tolist() == want.tolist()
    first = free.index(eos)
    assert got[0, :first + 1].tolist() == free[:first + 1]
    assert got[0, first:].tolist() == [eos] * (8 - first)


def test_generate_zero_tokens():
    _, _, tp, tcfg = _models("tiny")
    out = tgen.generate(tp, [[1, 2]], tcfg, max_new_tokens=0)
    assert out.shape == (1, 0)


def test_top_k_one_sampling_equals_greedy():
    _, _, tp, tcfg = _models("tiny_gqa")
    prompt = [[7, 7, 2, 9]]
    greedy = tgen.generate(tp, prompt, tcfg, max_new_tokens=6)
    sampled = tgen.generate(tp, prompt, tcfg, max_new_tokens=6,
                            temperature=0.7, top_k=1, seed=5)
    assert sampled.tolist() == greedy.tolist()


@pytest.mark.parametrize("k", [1, 5, 40])
def test_filter_top_k_equals_jax(k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((3, 97)).astype(np.float32) * 2
    got = tgen._filter_top_k(torch.from_numpy(logits), k)
    want = jax_gen._filter_top_k(jnp.asarray(logits), k)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.95, 1.0])
def test_filter_top_p_equals_jax(p):
    rng = np.random.default_rng(int(p * 100))
    logits = rng.standard_normal((3, 97)).astype(np.float32) * 2
    got = tgen._filter_top_p(torch.from_numpy(logits), p)
    want = jax_gen._filter_top_p(jnp.asarray(logits), p)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_sampler_follows_its_distribution():
    """Draw counts over a 6-way distribution (one entry masked to -inf)
    stay within 5 standard deviations of n * p for every category."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, float("-inf")]])
    n = 20000
    gen = torch.Generator().manual_seed(0)
    draws = tgen._sample(logits.expand(n, -1), gen)
    counts = torch.bincount(draws, minlength=6).double()
    p = torch.softmax(logits[0].double(), dim=-1)
    sd = torch.sqrt(n * p * (1 - p))
    assert counts[5] == 0
    assert bool(((counts - n * p).abs() <= 5 * sd + 1e-9).all()), counts
