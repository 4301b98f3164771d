"""Parity of the PyTorch port's model definitions (ray_tpu_torch.models)
with the JAX package's: configurations, parameter conversion, and the
embedding and output projection."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from ray_tpu_torch.models import configs, params_from_jax
from ray_tpu_torch.models import transformer as tf

torch.set_num_threads(1)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _jax_params(cfg, seed=0):
    params = jax_tf.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("name", sorted(jax_configs.NAMED_CONFIGS))
def test_every_named_config_maps(name):
    jcfg = jax_configs.NAMED_CONFIGS[name]
    tcfg = configs.NAMED_CONFIGS[name]
    assert configs.get_config(name) is tcfg
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tf_ = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    # The port's own fields (latent attention, YaRN, DeepSeek-style MoE)
    # keep their defaults, today's behaviour, in every config JAX names.
    assert set(jf) <= set(tf_)
    for f in dataclasses.fields(tcfg):
        if f.name not in jf:
            assert tf_[f.name] == f.default, (name, f.name)
    for k, v in jf.items():
        if k == "dtype":
            assert tf_[k] == _DTYPES[v], name
        else:
            assert tf_[k] == v, (name, k)
    assert tcfg.head_dim == jcfg.head_dim


@pytest.mark.parametrize("name,dtype", [
    ("tiny", None), ("tiny_gqa", None), ("tiny_gemma", None),
    ("tiny_qwen", None), ("tiny_moe", None), ("tiny", "bfloat16"),
])
def test_weights_round_trip_exactly(name, dtype):
    jcfg = jax_configs.NAMED_CONFIGS[name]
    tcfg = configs.NAMED_CONFIGS[name]
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype))
        tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    tree = _jax_params(jcfg)
    params = params_from_jax(tree, tcfg, device="cpu")
    assert set(params) == set(tree)
    assert set(params["layers"]) == set(tree["layers"])
    for k, v in tree.items():
        if k == "layers":
            continue
        got = _to_numpy(params[k])
        assert got.dtype == v.dtype and np.array_equal(
            got.view(np.uint8), v.view(np.uint8)), k
    for k, v in tree["layers"].items():
        got = _to_numpy(params["layers"][k])
        assert got.dtype == v.dtype and got.shape == v.shape
        assert np.array_equal(got.view(np.uint8), v.view(np.uint8)), k


def test_params_from_jax_rejects_a_wrong_config():
    tree = _jax_params(jax_configs.tiny)
    with pytest.raises(ValueError):
        params_from_jax(tree, configs.tiny_gqa, device="cpu")
    with pytest.raises(TypeError):
        params_from_jax(tree, dataclasses.replace(
            configs.tiny, dtype=torch.bfloat16), device="cpu")


@pytest.mark.parametrize("name", ["tiny", "tiny_qwen"])
def test_init_params_shapes_match_jax(name):
    """The port's own random init has the JAX tree's keys, shapes and
    dtypes (the draws differ: jax.random is not torch.Generator)."""
    tree = _jax_params(jax_configs.NAMED_CONFIGS[name])
    params = tf.init_params(configs.NAMED_CONFIGS[name], seed=1,
                            device="cpu")
    flat = {k: v for k, v in params.items() if k != "layers"}
    flat.update({f"layers/{k}": v for k, v in params["layers"].items()})
    ref = {k: v for k, v in tree.items() if k != "layers"}
    ref.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: v.shape for k, v in ref.items()}
    again = tf.init_params(configs.NAMED_CONFIGS[name], seed=1, device="cpu")
    assert torch.equal(again["layers"]["wq"], params["layers"]["wq"])


def test_embed_and_project_logits_match_jax_on_tiny_gemma():
    """tiny_gemma: tied embeddings, sqrt(d) embedding scale, logit
    softcap. f32 within 1e-5 (matmul sums in another order)."""
    jcfg, tcfg = jax_configs.tiny_gemma, configs.tiny_gemma
    tree = _jax_params(jcfg, seed=4)
    params = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 7)).astype(np.int32)
    x = tf._embed_tokens(params, torch.from_numpy(tokens).long(), tcfg)
    jx = jax_tf._embed_tokens(tree, jnp.asarray(tokens), jcfg)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-6)
    h = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    got = tf.project_logits(torch.from_numpy(h), params, tcfg)
    want = jax_tf.project_logits(jnp.asarray(h), tree, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(got.abs().max()) <= tcfg.final_logit_softcap


def test_embed_scale_rounds_like_jax_in_bf16():
    jcfg = dataclasses.replace(jax_configs.tiny_gemma, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(configs.tiny_gemma, dtype=torch.bfloat16)
    tree = _jax_params(jcfg, seed=2)
    params = params_from_jax(tree, tcfg, device="cpu")
    tokens = np.arange(16, dtype=np.int32).reshape(2, 8)
    x = tf._embed_tokens(params, torch.from_numpy(tokens).long(), tcfg)
    jx = np.asarray(jax_tf._embed_tokens(tree, jnp.asarray(tokens), jcfg))
    assert np.array_equal(_to_numpy(x).view(np.uint16), jx.view(np.uint16))


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_act_matches_jax(activation):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    cfg_t = dataclasses.replace(configs.tiny, activation=activation)
    cfg_j = dataclasses.replace(jax_configs.tiny, activation=activation)
    got = tf._act(cfg_t)(torch.from_numpy(x))
    want = jax_tf._act(cfg_j)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
