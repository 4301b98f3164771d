"""Parity of the PyTorch port's training path (ray_tpu_torch.models
`forward`, `loss_fn`, and one AdamW update) with the JAX package's, on the
CPU, from the same JAX parameters (carried across by `params_from_jax`)
and the same numpy tokens.

Tolerances (f32; the two frameworks sum products in other orders):
logits within rtol=atol=2e-5 (the reference's forward tolerance), the
loss within rtol 1e-5, every gradient leaf within rtol 1e-4 / atol 1e-6.
Measured on these configs: logits 7.6e-6 at most (tiny_gemma, whose
softcapped logits reach 30), gradients 1.2e-7. The three remat policies
recompute the same CPU arithmetic, so their gradients equal remat=False's
exactly. Three AdamW steps against optax.adamw(1e-4): each leaf's move
(its parameters after the steps minus before) within a relative L2 error
of 1e-3 of optax's, and every element within 6e-4. Adam divides each
gradient by its own running magnitude, so a gradient near zero, where the
two frameworks' 1e-8-sized gradient differences can flip its sign, turns
into a different update of up to 2 * lr per step: 6e-4 is that bound over
three steps. Measured: relative L2 at most 4.2e-4 (layers/wv), one
element of wv 7.3e-6 apart, all others within 1.2e-6.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from ray_tpu_torch.models import configs, forward, loss_fn, params_from_jax
from ray_tpu_torch.models import transformer as tf

torch.set_num_threads(1)

REMATS = [None, "full", "dots", "dots_nobatch"]


def _flat(p):
    out = {k: v for k, v in p.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in p["layers"].items()})
    return out


def _tokens(cfg, seed=0, shape=(2, 17)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_reference(name: str):
    """(numpy tree, tokens, logits, loss, flat grads) of the JAX package's
    default CPU path (jnp attention and rmsnorm with its custom VJP)."""
    jcfg = jax_configs.NAMED_CONFIGS[name]
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = _tokens(jcfg)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, _ = jax_tf.forward(jtree, jnp.asarray(tokens), jcfg)
    loss, grads = jax.value_and_grad(jax_tf.loss_fn)(
        jtree, jnp.asarray(tokens), jcfg)
    grads = _flat(jax.tree_util.tree_map(np.asarray, grads))
    return tree, tokens, np.asarray(logits), float(loss), grads


def _port_loss_and_grads(name, remat, tree, tokens):
    cfg = configs.NAMED_CONFIGS[name]
    cfg = dataclasses.replace(cfg, remat=remat is not None,
                              remat_policy=remat or "full")
    params = params_from_jax(tree, cfg, device="cpu")
    for t in _flat(params).values():
        t.requires_grad_(True)
    tok = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits, aux = forward(params, tok, cfg)
    loss = loss_fn(params, tok, cfg)
    loss.backward()
    return logits, aux, loss, {k: t.grad for k, t in _flat(params).items()}


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("name", ["tiny", "tiny_gqa", "tiny_gemma",
                                  "tiny_qwen"])
def test_forward_loss_and_grads_match_jax(name, remat):
    tree, tokens, want_logits, want_loss, want_grads = _jax_reference(name)
    logits, aux, loss, grads = _port_loss_and_grads(name, remat, tree, tokens)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=2e-5,
                               atol=2e-5)
    assert float(aux) == 0.0
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        assert g is not None and g.shape == want_grads[k].shape, k
        np.testing.assert_allclose(g.numpy(), want_grads[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if remat is not None:
        _, _, base_loss, base = _port_loss_and_grads(name, None, tree, tokens)
        assert loss.item() == base_loss.item()
        for k, g in grads.items():
            assert torch.equal(g, base[k]), k


def test_training_after_serving_in_one_process():
    """Serving first builds the cached RoPE tables under inference mode; a
    training step in the same process must still save them for backward."""
    from ray_tpu_torch.ops.rope import rope_tables

    tree, tokens, _, want_loss, want_grads = _jax_reference("tiny")
    cfg = configs.NAMED_CONFIGS["tiny"]
    rope_tables.cache_clear()
    with torch.inference_mode():
        rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                    torch.device("cpu"))
    _, _, loss, grads = _port_loss_and_grads("tiny", "dots_nobatch", tree,
                                             tokens)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_ce_chunk_loss_matches_jax():
    """loss_fn's chunked branch (lm_head and CE a chunk at a time, with the
    softcap) against the JAX package's, on tiny_gemma."""
    jcfg = dataclasses.replace(jax_configs.tiny_gemma, ce_chunk=8)
    tcfg = dataclasses.replace(configs.tiny_gemma, ce_chunk=8)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jax.random.PRNGKey(3), jcfg))
    tokens = _tokens(jcfg, seed=3)
    want, jg = jax.value_and_grad(jax_tf.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens), jcfg)
    jg = _flat(jax.tree_util.tree_map(np.asarray, jg))
    params = params_from_jax(tree, tcfg, device="cpu")
    for t in _flat(params).values():
        t.requires_grad_(True)
    loss = loss_fn(params, torch.from_numpy(tokens).long(), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for k, t in _flat(params).items():
        np.testing.assert_allclose(t.grad.numpy(), jg[k], rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_adamw_steps_match_optax():
    """Three steps of bench.py's update (optax.adamw(1e-4): b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4) against torch.optim.AdamW with the
    same hyperparameters, passed explicitly (torch's default decay is
    1e-2), each step on a fresh batch."""
    jcfg, tcfg = jax_configs.tiny, configs.tiny
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jax.random.PRNGKey(1), jcfg))
    batches = [_tokens(jcfg, seed=10 + i) for i in range(3)]

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = optax.adamw(1e-4)
    state = opt.init(jparams)
    for tok in batches:
        _, g = jax.value_and_grad(jax_tf.loss_fn)(jparams, jnp.asarray(tok),
                                                  jcfg)
        updates, state = opt.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    want = _flat(jax.tree_util.tree_map(np.asarray, jparams))

    params = params_from_jax(tree, tcfg, device="cpu")
    leaves = list(_flat(params).values())
    for t in leaves:
        t.requires_grad_(True)
    topt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
    for tok in batches:
        topt.zero_grad(set_to_none=True)
        loss_fn(params, torch.from_numpy(tok).long(), tcfg).backward()
        topt.step()
    init = _flat(tree)
    for k, t in _flat(params).items():
        move, want_move = t.detach().numpy() - init[k], want[k] - init[k]
        assert np.abs(want_move).max() > 0, k
        rel = np.linalg.norm(move - want_move) / np.linalg.norm(want_move)
        assert rel <= 1e-3, (k, rel)
        np.testing.assert_allclose(move, want_move, rtol=0, atol=6e-4,
                                   err_msg=k)


def test_remat_policies_and_refusals():
    """A bogus remat policy raises; MoE layers train; and the pipeline's
    refusals (MoE under pp, layers or batch that do not split) are the
    reference's, message for message. Those raise before any
    communication, so the port's side takes a stand-in with a mesh's
    axis names and sizes."""
    cfg = dataclasses.replace(configs.tiny, remat=True, remat_policy="bogus")
    params = tf.init_params(configs.tiny, seed=0, device="cpu")
    tok = torch.from_numpy(_tokens(cfg)).long()
    with pytest.raises(ValueError, match="unknown remat_policy 'bogus'"):
        loss_fn(params, tok, cfg)
    moe = tf.init_params(configs.tiny_moe, seed=0, device="cpu")
    assert bool(torch.isfinite(loss_fn(moe, tok, configs.tiny_moe)))

    from ray_tpu.parallel import MeshConfig, build_mesh

    three = dataclasses.replace(configs.tiny, n_layers=3)
    cases = [  # (config name or config, mesh sizes, global batch, M)
        ("tiny_moe", {"pp": 2}, 2, None),
        (three, {"pp": 2}, 2, None),
        ("tiny", {"pp": 2}, 3, 2),
        ("tiny", {"dp": 2, "pp": 2}, 4, 4),
    ]
    for name, sizes, batch, m in cases:
        tcfg = configs.NAMED_CONFIGS[name] if isinstance(name, str) else name
        jcfg = (jax_configs.NAMED_CONFIGS[name] if isinstance(name, str)
                else dataclasses.replace(jax_configs.tiny, n_layers=3))
        jmesh = build_mesh(MeshConfig(**sizes),
                           jax.devices()[:int(np.prod(list(sizes.values())))])
        tree = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
        with pytest.raises(ValueError) as want:
            jax_tf.forward_pipelined(tree, jnp.zeros((batch, 8), jnp.int32),
                                     jcfg, jmesh, num_microbatches=m)
        stand_in = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                         shape=tuple(sizes.values()))
        local = batch // sizes.get("dp", 1)
        with pytest.raises(ValueError) as got:
            tf.forward_pipelined(tf.init_params(tcfg, seed=0, device="cpu"),
                                 torch.zeros((local, 8), dtype=torch.long),
                                 tcfg, stand_in, num_microbatches=m)
        assert str(got.value) == str(want.value)


def test_forward_positions_and_hidden():
    """positions= reaches RoPE as in the reference; return_hidden gives the
    final-normed hidden states that project_logits maps to the logits."""
    jcfg, tcfg = jax_configs.tiny_qwen, configs.tiny_qwen
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jax.random.PRNGKey(2), jcfg))
    tokens = _tokens(jcfg, seed=2, shape=(2, 9))
    pos = (np.arange(9)[None, :] + np.array([[3], [11]])).astype(np.int32)
    want, _ = jax_tf.forward(tree, jnp.asarray(tokens), jcfg,
                             positions=jnp.asarray(pos))
    params = params_from_jax(tree, tcfg, device="cpu")
    tok = torch.from_numpy(tokens).long()
    got, _ = forward(params, tok, tcfg, positions=torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    hidden, _ = forward(params, tok, tcfg, return_hidden=True)
    logits, _ = forward(params, tok, tcfg)
    assert hidden.shape == (2, 9, tcfg.d_model)
    torch.testing.assert_close(tf.project_logits(hidden, params, tcfg), logits)


def test_bf16_step_runs_and_keeps_dtypes():
    """The bf16 training step bench.py runs (remat dots_nobatch, AdamW with
    bf16 state), at a tiny width on the CPU: finite loss, bf16 gradients
    and parameters that move."""
    cfg = dataclasses.replace(configs.tiny, dtype=torch.bfloat16, remat=True,
                              remat_policy="dots_nobatch")
    params = tf.init_params(cfg, seed=0, device="cpu")
    leaves = list(_flat(params).values())
    for t in leaves:
        t.requires_grad_(True)
    before = params["layers"]["wq"].detach().clone()
    opt = torch.optim.AdamW(leaves, lr=1e-4, weight_decay=1e-4)
    loss = loss_fn(params, torch.from_numpy(_tokens(cfg)).long(), cfg)
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)
    opt.step()
    assert not torch.equal(before, params["layers"]["wq"])
