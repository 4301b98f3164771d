"""The RL stack's second half (ROADMAP A7b) of the port held against the
JAX package: SAC, TD3/DDPG, CQL, recurrent PPO, R2D2, Ape-X's replay
shards and the multi-agent module dict, plus the envs chip_smoke.py
carries.

Tolerances:
  * SAC and CQL run in float64 on both sides (JAX under
    `jax.enable_x64`, the port's modules `.double()`), from the same
    state with the same batches and the JAX draws fed in: metrics and
    every leaf of the new state (params, targets, log_alpha, each Adam's
    count, mu and nu) within rtol 1e-8 with a floor of 1e-8 x the
    reference's largest magnitude. float64 because the JAX package's
    tanh correction log(1 - tanh(pre)^2 + 1e-6) cancels in float32: its
    tanh and torch's differ by up to 2 ulps in 59% of inputs, and near
    |pre| = 8 one ulp moves the log-probability by up to 0.39. The port
    takes the correction from pre without the cancellation, the same
    value in exact arithmetic (ROADMAP §C;
    test_sac_logp_keeps_the_precision_the_jax_formula_loses pins it).
    Adam's first moment after one step from zero is 0.1 x the gradient,
    so the first step's moments compare every gradient.
  * TD3 in float64 too, at the same tolerance: in float32 Adam's step
    turns the last-bit differences of a gradient element at 1e-5 of the
    typical size (mu 1.36e-7 against 1.8e-2) into 3.2e-3 x lr.
  * R2D2 and recurrent PPO in float32: losses and gradients within rtol
    1e-5 with a floor of 1e-5 x the largest magnitude; weights after
    updates within rtol 1e-5 with a floor of 1e-3 x lr, as
    tests/test_torch_rl_learner.py.
  * Replay draws, exports and env dynamics: exact.

The algorithm cases (DDPG, recurrent PPO and R2D2 evaluation, Ape-X's
ladder, and the `slow` learning cases of tests/test_rl.py and
tests/test_rl_extras.py) run the port with device="cpu"; their env
classes come from chip_smoke.py, which imports no JAX, so the port's
workers load none.
"""

import copy
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import ray_tpu.rl as jax_rl
import ray_tpu_torch as rt
import ray_tpu_torch.rl as torch_rl
from ray_tpu.rl.algorithms import apex as japex
from ray_tpu.rl.algorithms import cql as jcql
from ray_tpu.rl.algorithms import r2d2 as jr2d2
from ray_tpu.rl.algorithms import recurrent_ppo as jrppo
from ray_tpu.rl.algorithms import sac as jsac
from ray_tpu.rl.algorithms import td3 as jtd3
from ray_tpu.rl.core import rl_module as jrl
from ray_tpu.rl import multi_agent as jma
from ray_tpu_torch.rl import multi_agent as tma
from ray_tpu_torch.rl.algorithms import apex as tapex
from ray_tpu_torch.rl.algorithms import cql as tcql
from ray_tpu_torch.rl.algorithms import r2d2 as tr2d2
from ray_tpu_torch.rl.algorithms import recurrent_ppo as trppo
from ray_tpu_torch.rl.algorithms import sac as tsac
from ray_tpu_torch.rl.algorithms import td3 as ttd3
from ray_tpu_torch.rl.core import convert
from ray_tpu_torch.rl.core import learner as tlearner
from ray_tpu_torch.rl.core import rl_module as trl

torch.set_num_threads(1)

CPU = "cpu"
RTOL = 1e-5
RTOL_F64 = 1e-8


def close(got, want, rtol=RTOL, what="", atol=None):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if atol is None:
        atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def flat_state(state):
    """A learner state of either package as flat numpy leaves, each
    optimizer state as its Adam's {"count", "mu", "nu"}."""
    out = {}
    for k, v in state.items():
        if k.endswith("opt") or k == "opt_state":
            v = convert.find_adam(v)
        for path, leaf in convert.flatten(v).items():
            out[f"{k}.{path}" if path else k] = np.asarray(leaf)
    return out


def close_states(got, want, rtol, atol=None, what=""):
    g, w = flat_state(got), flat_state(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))
    for k in w:
        if k.endswith(".count") or k == "step":
            assert int(g[k]) == int(w[k]), (what, k)
        else:
            close(g[k], w[k], rtol=rtol, what=f"{what} {k}", atol=atol)


def t64(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def t32(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def transitions(seed, B=16, obs_dim=3, action_dim=2, scale=3.0,
                dtype=np.float64):
    r = np.random.default_rng(seed)
    return {
        "obs": (scale * r.normal(size=(B, obs_dim))).astype(dtype),
        "actions": r.uniform(-1, 1, (B, action_dim)).astype(dtype),
        "rewards": r.normal(size=B).astype(dtype),
        "next_obs": (scale * r.normal(size=(B, obs_dim))).astype(dtype),
        "dones": (r.uniform(size=B) < 0.25).astype(dtype),
    }


# -- exports ---------------------------------------------------------------------

def test_exports_equal_the_jax_packages_and_none_raises():
    assert set(torch_rl.__all__) == set(jax_rl.__all__)
    assert len(torch_rl.__all__) == len(set(torch_rl.__all__))
    for name in torch_rl.__all__:
        assert getattr(torch_rl, name) is not None
    assert not hasattr(torch_rl, "A7B_NAMES")


# -- SAC -----------------------------------------------------------------------

SAC_SPEC = dict(obs_dim=3, action_dim=2, action_low=-2.0, action_high=2.0,
                hidden=(32, 32))
LR = 1e-3


def jax_sac_state(jm, params, dtype):
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype), params)
    zero = jnp.asarray(0.0, dtype)
    qp = {"q1": params["q1"], "q2": params["q2"]}
    return {"params": params, "target": jax.tree.map(lambda x: x, qp),
            "log_alpha": zero,
            "pi_opt": optax.adam(LR).init(params["pi"]),
            "q_opt": optax.adam(LR).init(qp),
            "alpha_opt": optax.adam(LR).init(zero)}


def sac_draws(key, B, d):
    k_next, k_pi = jax.random.split(key)
    return {"next": jax.random.normal(k_next, (B, d)),
            "pi": jax.random.normal(k_pi, (B, d))}


def cql_draws(key, B, d, K):
    k_next, k_pi, k_rand, k_cur, k_nxt = jax.random.split(key, 5)

    def per(k):
        return jnp.stack([jax.random.normal(kk, (B, d))
                          for kk in jax.random.split(k, K)])

    return {"next": jax.random.normal(k_next, (B, d)),
            "pi": jax.random.normal(k_pi, (B, d)),
            "rand": jax.random.uniform(k_rand, (K, B, d), minval=-1.0,
                                       maxval=1.0),
            "cur": per(k_cur), "nxt": per(k_nxt)}


def run_sac_family(make_jupdate, tupdate, draws, warm_up, B=16):
    """JAX and port updates from one JAX state in float64: `warm_up` JAX
    updates first (Adam's moments no longer zero), then three updates on
    each from that state; every metric, then the whole state."""
    with jax.enable_x64(True):
        jm = jrl.ContinuousPolicyModule(jrl.ContinuousModuleSpec(**SAC_SPEC))
        jstate = jax_sac_state(jm, jm.init(jax.random.PRNGKey(0)),
                               jnp.float64)
        jupdate = make_jupdate(jm)
        for i in range(warm_up):
            b = transitions(100 + i, B)
            jstate, _ = jupdate(jstate, {k: jnp.asarray(v)
                                         for k, v in b.items()},
                                jax.random.PRNGKey(200 + i))
        tm = trl.ContinuousPolicyModule(
            trl.ContinuousModuleSpec(**SAC_SPEC)).double()
        tstate = tsac.init_sac_state(tm, LR)
        tsac.load_sac_state(tstate, jax.device_get(jstate))
        close_states(tsac.sac_state_to_jax(tstate), jax.device_get(jstate),
                     0.0, atol=0.0, what="loaded")
        for i in range(3):
            b = transitions(i, B)
            key = jax.random.PRNGKey(10 + i)
            jstate, jmet = jupdate(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()}, key)
            noise = {k: t64(v) for k, v in draws(key, B).items()}
            tmet = tupdate(tstate, {k: t64(v) for k, v in b.items()}, noise)
            assert set(tmet) == set(jmet)
            for k in jmet:
                close(tmet[k], jmet[k], RTOL_F64, what=f"step {i} {k}")
            close_states(tsac.sac_state_to_jax(tstate),
                         jax.device_get(jstate), RTOL_F64,
                         what=f"step {i}")


@pytest.mark.parametrize("warm_up", [0, 2])
def test_sac_updates_match_jax_with_its_draws(warm_up):
    def make_jupdate(jm):
        txs = [optax.adam(LR) for _ in range(3)]
        return jsac.make_sac_update(jm, *txs, 0.99, 0.005, -2.0)

    run_sac_family(make_jupdate, tsac.make_sac_update(0.99, 0.005, -2.0),
                   lambda key, B: sac_draws(key, B, 2), warm_up)


@pytest.mark.parametrize("warm_up", [0, 2])
def test_cql_updates_match_jax_with_its_draws(warm_up):
    K = 3

    def make_jupdate(jm):
        txs = [optax.adam(LR) for _ in range(3)]
        return jcql.make_cql_update(jm, *txs, 0.99, 0.005, -2.0, 2.0, K)

    run_sac_family(make_jupdate, tcql.make_cql_update(0.99, 0.005, -2.0, 2.0, K),
                   lambda key, B: cql_draws(key, B, 2, K), warm_up)


def test_sac_logp_keeps_the_precision_the_jax_formula_loses():
    """The tanh correction at |pre| up to 12 (std 3): the port's float32
    log-probability within 1e-4 of the formula in float64 (numpy, an
    oracle outside both packages), where the JAX package's float32 one,
    from the same draw, is off by more than 1e-2 (ROADMAP §C)."""
    jm = jrl.ContinuousPolicyModule(jrl.ContinuousModuleSpec(**SAC_SPEC))
    params = jm.init(jax.random.PRNGKey(0))
    log3 = np.float32(math.log(3.0))
    params["pi"][-1]["b"] = jnp.asarray([0.0, 0.0, log3, log3])
    tm = trl.ContinuousPolicyModule(trl.ContinuousModuleSpec(**SAC_SPEC))
    tm.set_weights(jax.tree.map(np.asarray, params))
    obs = np.zeros((4000, 3), np.float32)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (4000, 2)))
    _, jlogp = jm.sample_with_logp(params, obs, key)
    _, tlogp = tm.sample_with_logp(t32(obs), eps=t32(eps))
    pre = 3.0 * eps.astype(np.float64)
    want = (-0.5 * eps.astype(np.float64) ** 2 - np.log(3.0)
            - 0.5 * np.log(2.0 * np.pi)).sum(-1) - np.log(
                1.0 - np.tanh(pre) ** 2 + 1e-6).sum(-1)
    assert np.abs(tlogp.detach().numpy() - want).max() < 1e-4
    assert np.abs(np.asarray(jlogp, np.float64) - want).max() > 1e-2


# -- TD3 -----------------------------------------------------------------------

TD3_SPEC = dict(obs_dim=3, action_dim=2, action_low=-2.0, action_high=2.0,
                hidden=(32, 24))


def test_td3_delay_and_updates_match_jax_with_its_draws():
    """Four steps at policy_delay 2 from one JAX state, in float64 as
    SAC's: each step's metrics and new state as the JAX update's; on
    steps 1 and 3 the actor, its Adam and every target stay bit for bit
    and pi_loss reads 0.0, and the step count rides the state."""
    with jax.enable_x64(True):
        jm = jtd3.DeterministicPolicyModule(
            jrl.ContinuousModuleSpec(**TD3_SPEC))
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                              jm.init(jax.random.PRNGKey(1)))
        qp = {"q1": params["q1"], "q2": params["q2"]}
        jstate = {"params": params,
                  "target": jax.tree.map(lambda x: x,
                                         {"pi": params["pi"], **qp}),
                  "pi_opt": optax.adam(LR).init(params["pi"]),
                  "q_opt": optax.adam(LR).init(qp),
                  "step": jnp.asarray(0, jnp.int32)}
        jupdate = jtd3.make_td3_update(jm, optax.adam(LR), optax.adam(LR),
                                       0.99, 0.005, 0.2, 0.5, 2)
        tm = ttd3.DeterministicPolicyModule(
            trl.ContinuousModuleSpec(**TD3_SPEC)).double()
        tstate = ttd3.init_td3_state(tm, LR)
        ttd3.load_td3_state(tstate, jax.device_get(jstate))
        tupdate = ttd3.make_td3_update(0.99, 0.005, 0.2, 0.5, 2)
        for i in range(4):
            b = transitions(30 + i)
            key = jax.random.PRNGKey(40 + i)
            before = ttd3.td3_state_to_jax(tstate)
            jstate, jmet = jupdate(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()}, key)
            noise = t64(jax.random.normal(key, (16, 2)))
            tmet = tupdate(tstate, {k: t64(v) for k, v in b.items()}, noise)
            assert tstate["step"] == i + 1
            for k in jmet:
                close(tmet[k], jmet[k], RTOL_F64, what=f"step {i} {k}")
            after = ttd3.td3_state_to_jax(tstate)
            if i % 2:
                assert float(tmet["pi_loss"]) == 0.0
                for part in ("target", "pi_opt"):
                    for k, v in flat_state({part: before[part]}).items():
                        np.testing.assert_array_equal(
                            flat_state({part: after[part]})[k], v, err_msg=k)
                for k, v in convert.flatten(before["params"]["pi"]).items():
                    np.testing.assert_array_equal(
                        convert.flatten(after["params"]["pi"])[k], v)
            else:
                assert float(tmet["pi_loss"]) != 0.0
            close_states(after, jax.device_get(jstate), RTOL_F64,
                         what=f"step {i}")


def test_ddpg_preset_equals_the_jax_one():
    from dataclasses import fields

    for cls in ("TD3Config", "DDPGConfig"):
        ours, theirs = getattr(ttd3, cls)(), getattr(jtd3, cls)()
        for f in fields(theirs):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


# -- recurrent PPO and R2D2 ----------------------------------------------------

REC_SPEC = dict(obs_dim=3, num_actions=3, state_dim=8, hidden=(16,))


def rec_pair(name, seed=0):
    jm = getattr(jrl, name)(jrl.RecurrentModuleSpec(**REC_SPEC))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = getattr(trl, name)(trl.RecurrentModuleSpec(**REC_SPEC))
    tm.set_weights(jax.tree.map(np.asarray, params))
    return jm, params, tm


def seq_batch(seed, B=3, T=7):
    r = np.random.default_rng(seed)
    dones = (r.uniform(size=(B, T)) < 0.2).astype(np.float32)
    return {"obs": r.normal(size=(B, T, 3)).astype(np.float32),
            "state0": r.normal(size=(B, 8)).astype(np.float32),
            "dones": dones,
            "actions": r.integers(0, 3, (B, T)).astype(np.int32),
            "logp": np.full((B, T), -1.1, np.float32),
            "advantages": r.normal(size=(B, T)).astype(np.float32),
            "returns": r.normal(size=(B, T)).astype(np.float32),
            "rewards": r.normal(size=(B, T)).astype(np.float32)}


def check_grads(jloss_of_params, params, tloss, tm):
    (jl, jmet), jg = jax.value_and_grad(jloss_of_params, has_aux=True)(params)
    tl, tmet = tloss
    close(tl, jl, what="loss")
    assert set(tmet) == set(jmet)
    for k in jmet:
        close(tmet[k], jmet[k], what=k)
    leaves = convert.flatten(tm.tree())
    grads = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    for (k, p), g in zip(leaves.items(), grads):
        w = convert.leaf_from_jax(want[k])
        close(torch.zeros_like(p) if g is None else g, w, what=f"grad {k}")


def test_recurrent_ppo_loss_and_gradients_match_jax():
    jm, params, tm = rec_pair("RecurrentPolicyModule")
    b = seq_batch(5)
    check_grads(lambda p: jrppo.recurrent_ppo_loss(p, jm, b), params,
                trppo.recurrent_ppo_loss(tm, {k: torch.from_numpy(v)
                                              for k, v in b.items()}), tm)


@pytest.mark.parametrize("burn_in", [0, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_r2d2_loss_with_burn_in_matches_jax(burn_in, ties):
    """The burn-in mask, the last step's mask and the double-Q target;
    with `ties` the online head's columns are equal, so every argmax is
    a tie and the target's columns (which differ) tell which action was
    taken: the first, in both."""
    jm, params, tm = rec_pair("RecurrentQNetworkModule", 1)
    _, tparams, tt = rec_pair("RecurrentQNetworkModule", 2)
    if ties:
        head = params["q"][-1]
        head["w"] = jnp.repeat(head["w"][:, :1], 3, axis=1)
        head["b"] = jnp.zeros(3)
        tm.set_weights(jax.tree.map(np.asarray, params))
    b = {k: v for k, v in seq_batch(6).items()
         if k in ("obs", "state0", "dones", "actions", "rewards")}
    jloss = jr2d2.r2d2_update_fn(jm, 0.97, burn_in)
    tloss = tr2d2.r2d2_update_fn(0.97, burn_in)
    check_grads(lambda p: jloss(p, tparams, b), params,
                tloss(tm, tt, {k: torch.from_numpy(v) for k, v in b.items()}),
                tm)


@pytest.mark.parametrize("max_norm", [10.0, 0.05])
def test_r2d2_updates_from_one_jax_state_match_jax(max_norm):
    """Three updates of the GRU-Q module (its target fixed) through
    Adam behind optax's clip: at 10 (R2D2's) the norm stays under it, at
    0.05 every update is clipped. The JAX state after one update loads
    into the port (module, target, the chained optimizer's moments)."""
    jm, params, tm = rec_pair("RecurrentQNetworkModule", 3)
    _, tparams, tt = rec_pair("RecurrentQNetworkModule", 4)
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(LR))
    jloss = jr2d2.r2d2_update_fn(jm, 0.99, 2)

    @jax.jit
    def jstep(p, opt, batch):
        (_, m), g = jax.value_and_grad(jloss, has_aux=True)(p, tparams, batch)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, m, optax.global_norm(g)

    opt = tx.init(params)
    params, opt, _, _ = jstep(params, opt, seq_batch(20))
    tm.set_weights(jax.tree.map(np.asarray, params))
    tparams_np = jax.tree.map(np.asarray, tparams)
    tt.set_weights(tparams_np)
    leaves = convert.flatten(tm.tree())
    topt = tlearner.adam(leaves.values(), LR)
    convert.load_adam(topt, leaves, jax.device_get(opt))
    tloss = tr2d2.r2d2_update_fn(0.99, 2)
    for i in range(3):
        b = seq_batch(21 + i)
        params, opt, jmet, norm = jstep(params, opt, b)
        assert (float(norm) >= max_norm) == (max_norm < 1.0)
        loss, tmet = tloss(tm, tt, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        tlearner.step(topt, leaves.values(), loss, max_norm)
        for k in jmet:
            close(tmet[k], jmet[k], what=f"step {i} {k}")
        close_states({"params": tm.get_weights(),
                      "opt_state": convert.adam_to_jax(topt, leaves)},
                     jax.device_get({"params": params, "opt_state": opt}),
                     RTOL, atol=1e-3 * LR, what=f"step {i}")
    assert convert.flatten(tt.get_weights()).keys() == \
        convert.flatten(tparams_np).keys()


def test_sequence_replay_draws_the_jax_windows():
    r = np.random.default_rng(7)
    windows = [{"obs": r.normal(size=(4, 3)).astype(np.float32),
                "state0": r.normal(size=8).astype(np.float32),
                "actions": r.integers(0, 2, 4).astype(np.int32)}
               for _ in range(13)]
    ours, theirs = (tr2d2.SequenceReplayBuffer(10, seed=3),
                    jr2d2.SequenceReplayBuffer(10, seed=3))
    for w in windows:
        ours.add(w)
        theirs.add(w)
    assert len(ours) == len(theirs) == 10
    for n in (1, 5, 16):
        a, b = ours.sample(n), theirs.sample(n)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_replay_shards_draw_the_jax_samples():
    """The shard actors' classes, called in this process: the same adds,
    priority updates and seeds give the same prioritized samples."""
    r = np.random.default_rng(8)
    batch = {"obs": r.normal(size=(40, 3)).astype(np.float32),
             "next_obs": r.normal(size=(40, 3)).astype(np.float32),
             "actions": r.integers(0, 2, 40).astype(np.int32),
             "rewards": r.normal(size=40).astype(np.float32),
             "dones": np.zeros(40, np.float32),
             "discounts": np.full(40, 0.99, np.float32)}
    ours = tapex.ReplayShardActor._cls(32, 3, 1005, 0.6)
    theirs = japex.ReplayShardActor._cls(32, 3, 1005, 0.6)
    assert ours.sample(4, 0.4) is None and theirs.sample(4, 0.4) is None
    assert ours.add_batch(batch) == theirs.add_batch(batch) == 32
    ours.update_priorities(np.arange(8), np.arange(8) * 0.5)
    theirs.update_priorities(np.arange(8), np.arange(8) * 0.5)
    for beta in (0.4, 1.0):
        a, b = ours.sample(16, beta), theirs.sample(16, beta)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.size() == theirs.size() == 32


def test_apex_epsilon_ladder_and_defaults_equal_the_jax_ones():
    from dataclasses import fields

    cfg = tapex.APEXConfig()
    cfg.num_env_runners = 4
    n = cfg.num_env_runners
    eps = [cfg.apex_eps_base ** (1 + 7 * i / (n - 1)) for i in range(n)]
    assert eps[0] == pytest.approx(0.4)
    assert all(a > b for a, b in zip(eps, eps[1:]))
    assert eps[-1] == pytest.approx(0.4 ** 8)
    theirs = japex.APEXConfig()
    for f in fields(theirs):
        if not callable(getattr(theirs, f.name)):
            assert getattr(tapex.APEXConfig(), f.name) == \
                getattr(theirs, f.name), f.name


def test_multi_rl_module_trees_cross_both_ways():
    """A JAX MultiRLModule's dict of trees loads into the port's (and
    back, equal), and each policy then computes the JAX forward."""
    specs = {"p0": jrl.RLModuleSpec(3, 3, (16,)),
             "p1": jrl.RLModuleSpec(3, 3, (8, 8))}
    jm = jma.MultiRLModule(specs)
    weights = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = tma.MultiRLModule({k: trl.RLModuleSpec(3, 3, s.hidden)
                            for k, s in specs.items()})
    tm.set_weights(weights)
    back = tm.get_weights()
    for pid in specs:
        for k, v in convert.flatten(weights[pid]).items():
            np.testing.assert_array_equal(convert.flatten(back[pid])[k], v)
        obs = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
        want = jm[pid].forward(weights[pid], obs)
        got = tm[pid](t32(obs))
        for k in want:
            close(got[k], want[k], what=f"{pid} {k}")
    assert set(tm.init(5)) == {"p0", "p1"}


# -- the envs chip_smoke.py carries -------------------------------------------

def test_chip_smoke_pendulum_equals_gymnasiums_pendulum_v1():
    import gymnasium as gym

    ours, theirs = chip_smoke.PendulumEnv(), gym.make("Pendulum-v1")
    o1, _ = ours.reset(seed=11)
    o2, _ = theirs.reset(seed=11)
    np.testing.assert_array_equal(o1, o2)
    start = np.array([2.9, -0.7])
    ours.state = start.copy()
    theirs.unwrapped.state = start.copy()
    actions = np.random.default_rng(0).uniform(-2.5, 2.5, (200, 1))
    for t, a in enumerate(actions.astype(np.float32)):
        a1, a2 = ours.step(a), theirs.step(a)
        np.testing.assert_array_equal(a1[0], a2[0], err_msg=str(t))
        assert a1[1] == a2[1] and a1[2:4] == a2[2:4], t
    assert a1[3] and a2[3]  # truncated at step 200 by both


def test_chip_smoke_carries_the_jax_tests_envs():
    import sys

    sys.path.insert(0, "tests")
    from test_rl import CueRecallEnv
    from test_rl_extras import MatchContextEnv

    a, b = chip_smoke.CueRecallEnv(seed=3), CueRecallEnv(seed=3)
    for _ in range(20):
        oa, ob = a.reset()[0], b.reset()[0]
        np.testing.assert_array_equal(oa, ob)
        for act in (0, 1, 1, 0):
            ra, rb = a.step(act), b.step(act)
            np.testing.assert_array_equal(ra[0], rb[0])
            assert ra[1:4] == rb[1:4]
    a, b = chip_smoke.MatchContextEnv(seed=4), MatchContextEnv(seed=4)
    for _ in range(3):
        oa, ob = a.reset()[0], b.reset()[0]
        for k in ob:
            np.testing.assert_array_equal(oa[k], ob[k])
        for t in range(8):
            act = {"a0": t % 3, "a1": (t + 1) % 3}
            ra, rb = a.step(act), b.step(act)
            for k in rb[0]:
                np.testing.assert_array_equal(ra[0][k], rb[0][k])
            assert ra[1:4] == rb[1:4]


# -- the JAX tests' algorithm cases on the port ------------------------------

@pytest.fixture(scope="module")
def rt_start():
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _pendulum():
    import gymnasium as gym

    return gym.make("Pendulum-v1")


def test_ddpg_preset_trains(rt_start):
    from ray_tpu_torch.rl import DDPGConfig, TD3

    cfg = (
        DDPGConfig()
        .environment(_pendulum, obs_dim=3, action_dim=1, action_low=-2.0,
                     action_high=2.0)
        .env_runners(num_env_runners=1, rollout_length=64)
        .training(batch_size=32, updates_per_iteration=4, warmup_steps=32,
                  device=CPU)
    )
    assert cfg.policy_delay == 1
    assert cfg.target_noise == 0.0
    algo = cfg.build()
    assert isinstance(algo, TD3)
    try:
        algo.train()  # warmup fill
        r2 = algo.train()  # real updates
        assert r2["training_iteration"] == 2
        assert "learner/q_loss" in r2
        assert np.isfinite(r2["learner/q_loss"])
        assert algo.state["step"] == 8  # 4 updates an iteration
    finally:
        algo.stop()


def test_sac_checkpoint_restores_the_whole_state(rt_start, tmp_path):
    """Algorithm.save/restore through the SAC state in the JAX layout:
    a fresh SAC restored from another's checkpoint continues with the
    same update (the same weights after one more iteration on the same
    buffer and draws)."""
    from ray_tpu_torch.rl import SACConfig

    def build():
        return (SACConfig()
                .environment(_pendulum, obs_dim=3, action_dim=1,
                             action_low=-2.0, action_high=2.0)
                .env_runners(num_env_runners=1, rollout_length=64)
                .training(batch_size=16, updates_per_iteration=3,
                          warmup_steps=64, device=CPU)
                .build())

    a = build()
    b = build()
    try:
        a.train()
        a.train()
        a.save(str(tmp_path))
        b.restore(str(tmp_path))
        close_states(b._get_learner_state(), a._get_learner_state(), 0.0,
                     atol=0.0)
        assert b._steps_sampled == a._steps_sampled == 128
        b.buffer = copy.deepcopy(a.buffer)
        b._gen.set_state(a._gen.get_state())
        m_a = tlearner.readback(a._run_updates(2))
        m_b = tlearner.readback(b._run_updates(2))
        assert m_a == m_b
    finally:
        a.stop()
        b.stop()


def test_recurrent_ppo_evaluation_and_runner_state(rt_start):
    from ray_tpu_torch.rl import RecurrentPPOConfig

    algo = (
        RecurrentPPOConfig(state_dim=8)
        .environment(chip_smoke.CueRecallEnv, obs_dim=3, num_actions=2)
        .env_runners(num_env_runners=1, rollout_length=32)
        .training(lr=3e-3, num_epochs=1, device=CPU)
        .evaluation(evaluation_interval=1, evaluation_duration=3)
    ).build()
    try:
        result = algo.train()
        assert "evaluation" in result
        assert result["evaluation"]["episodes_this_eval"] == 3
        states = rt.get(
            [r.get_runner_state.remote() for r in algo.env_runners],
            timeout=120,
        )
        assert states[0]["policy_state"] is not None
        assert rt.get(
            algo.env_runners[0].set_runner_state.remote(states[0]),
            timeout=120,
        )
    finally:
        algo.stop()


def test_r2d2_evaluation_greedy_and_explore(rt_start):
    from ray_tpu_torch.rl import R2D2Config

    algo = (
        R2D2Config(state_dim=8)
        .environment(chip_smoke.CueRecallEnv, obs_dim=3, num_actions=2)
        .env_runners(num_env_runners=1, window_length=8)
        .training(learning_starts=4, updates_per_iteration=1,
                  train_batch_size=4, device=CPU)
        .evaluation(evaluation_interval=1, evaluation_duration=2)
    ).build()
    try:
        r = algo.train()
        assert r["evaluation"]["episodes_this_eval"] == 2
        algo.config.evaluation_explore = True
        ev = algo.evaluate()
        assert ev["episodes_this_eval"] == 2
    finally:
        algo.stop()


def test_r2d2_state_round_trips_in_the_jax_layout(rt_start):
    """R2D2's learner state (GRU-Q module, its target, Adam behind the
    clip) leaves in the JAX layout and loads back unchanged."""
    from ray_tpu_torch.rl import R2D2Config

    algo = (R2D2Config(state_dim=8)
            .environment(chip_smoke.CueRecallEnv, obs_dim=3, num_actions=2)
            .env_runners(num_env_runners=1, window_length=8)
            .training(learning_starts=2, updates_per_iteration=2,
                      train_batch_size=2, device=CPU)).build()
    try:
        algo.train()
        algo.train()
        state = algo._get_learner_state()
        assert int(state["opt_state"]["count"]) == 2  # from the 2nd window
        algo.sync_target()
        algo._set_learner_state(state)
        close_states(algo._get_learner_state(), state, 0.0, atol=0.0)
    finally:
        algo.stop()


# -- the JAX tests' `slow` learning cases, on the port ------------------------

def _best(algo, iters, bar):
    """The best mean return over up to `iters` iterations, stopping once
    it reaches `bar`."""
    best = -1e9
    for _ in range(iters):
        best = max(best, algo.train()["episode_return_mean"])
        if best >= bar:
            break
    return best


@pytest.mark.slow
@pytest.mark.parametrize("name", ["SACConfig", "TD3Config"])
def test_continuous_control_pendulum_improves(rt_start, name):
    kw = dict(lr=1e-3, batch_size=128, updates_per_iteration=400,
              warmup_steps=400, tau=0.01, device=CPU)
    if name == "TD3Config":
        kw["explore_sigma"] = 0.15
    algo = (getattr(torch_rl, name)()
            .environment(_pendulum, obs_dim=3, action_dim=1,
                         action_low=-2.0, action_high=2.0)
            .env_runners(num_env_runners=1, rollout_length=400)
            .training(**kw).build())
    try:
        first = algo.train()
        best = -1e9
        for _ in range(24):
            best = max(best, algo.train()["episode_return_mean"])
            if best > -400.0:
                break
        assert best > -800.0 and best > first["episode_return_mean"] + 200, \
            (first["episode_return_mean"], best)
    finally:
        algo.stop()


def _bandit_transitions(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    a = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    r = (1.0 - (a[:, 0] - 0.5 * s[:, 0]) ** 2).astype(np.float32)
    return {"obs": s, "actions": a, "rewards": r, "next_obs": s,
            "dones": np.ones(n, dtype=np.float32)}


@pytest.mark.slow
def test_cql_learns_offline_bandit():
    from ray_tpu_torch.rl import CQLConfig

    algo = (CQLConfig().module(obs_dim=1, action_dim=1)
            .training(lr=3e-3, cql_alpha=1.0, minibatch_size=256,
                      device=CPU).build())
    batch = _bandit_transitions()
    obs = np.linspace(-1, 1, 21, dtype=np.float32)[:, None]
    before = np.abs(algo.compute_actions(obs)[:, 0] - 0.5 * obs[:, 0]).mean()
    metrics = algo.train_on_batch(batch, num_epochs=40)
    after = np.abs(algo.compute_actions(obs)[:, 0] - 0.5 * obs[:, 0]).mean()
    assert np.isfinite(metrics["q_loss"])
    assert "cql_loss" in metrics
    assert after < before and after < 0.25, (before, after)


@pytest.mark.slow
def test_cql_penalizes_out_of_distribution_actions():
    from ray_tpu_torch.rl import CQLConfig

    rng = np.random.default_rng(1)
    n = 2048
    s = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    a = rng.uniform(-1, 0.0, (n, 1)).astype(np.float32)
    r = (1.0 + a[:, 0]).astype(np.float32)
    batch = {"obs": s, "actions": a, "rewards": r, "next_obs": s,
             "dones": np.ones(n, dtype=np.float32)}
    algo = (CQLConfig().module(obs_dim=1, action_dim=1)
            .training(lr=3e-3, cql_alpha=5.0, minibatch_size=256,
                      device=CPU).build())
    algo.train_on_batch(batch, num_epochs=30)
    with torch.no_grad():
        obs = torch.zeros((64, 1))
        q_in, _ = algo.module.q_values(obs, torch.full((64, 1), -0.1))
        q_ood, _ = algo.module.q_values(obs, torch.full((64, 1), 0.9))
    assert float(q_ood.mean()) < float(q_in.mean()) + 0.5


@pytest.mark.slow
def test_recurrent_ppo_learns_memory_task(rt_start):
    from ray_tpu_torch.rl import RecurrentPPOConfig

    rec = (
        RecurrentPPOConfig(state_dim=16)
        .environment(chip_smoke.CueRecallEnv, obs_dim=3, num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=128)
        .training(lr=5e-3, num_epochs=6, device=CPU)
    ).build()
    try:
        best = _best(rec, 14, 0.9)
        assert best >= 0.9, f"recurrent PPO failed the memory task: {best}"
    finally:
        rec.stop()


@pytest.mark.slow
def test_r2d2_learns_memory_task(rt_start):
    from ray_tpu_torch.rl import R2D2Config

    algo = (
        R2D2Config(state_dim=16)
        .environment(chip_smoke.CueRecallEnv, obs_dim=3, num_actions=2)
        .env_runners(num_env_runners=2, window_length=16)
        .training(lr=2e-3, train_batch_size=16, updates_per_iteration=24,
                  learning_starts=16, burn_in=2, target_update_freq=2,
                  device=CPU)
        .exploration(epsilon_start=1.0, epsilon_end=0.05,
                     epsilon_decay_iters=8)
    ).build()
    try:
        best = _best(algo, 25, 0.9)
        assert best >= 0.9, f"R2D2 failed the memory task: best={best}"
    finally:
        algo.stop()


@pytest.mark.slow
def test_apex_dqn_learns_with_sharded_replay(rt_start):
    import gymnasium as gym

    from ray_tpu_torch.rl import APEXConfig

    algo = (
        APEXConfig()
        .environment(lambda: gym.make("CartPole-v1"), obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=3, rollout_length=200)
        .training(lr=1e-3, train_batch_size=64, updates_per_iteration=48,
                  learning_starts=400, n_step=3, device=CPU)
        .build()
    )
    assert len(algo.shards) == 2
    try:
        best, result = -1.0, None
        for _ in range(40):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best >= 75.0:
                break
        assert result["buffer_size"] > 400
        sizes = rt.get([s.size.remote() for s in algo.shards], timeout=60)
        assert all(s > 0 for s in sizes)
        assert best >= 75.0, f"APEX failed to learn: best={best}"
    finally:
        algo.stop()


def _ma_config(policies, mapping_fn, seed=0):
    from ray_tpu_torch.rl import MultiAgentPPOConfig

    return (
        MultiAgentPPOConfig()
        .environment(lambda: chip_smoke.MatchContextEnv(seed=seed))
        .multi_agent(policies=policies, policy_mapping_fn=mapping_fn)
        .env_runners(num_env_runners=2, rollout_length=64)
        .training(lr=1e-2, num_epochs=4, minibatch_size=64, device=CPU)
    )


@pytest.mark.slow
@pytest.mark.parametrize("shared", [False, True])
def test_multi_agent_ppo_improves(rt_start, shared):
    spec = trl.RLModuleSpec(obs_dim=3, num_actions=3)
    if shared:
        algo = _ma_config({"shared": spec}, lambda aid: "shared").build()
    else:
        algo = _ma_config({"p0": spec, "p1": spec},
                          lambda aid: "p0" if aid == "a0" else "p1").build()
    try:
        first = algo.train()
        last = first
        for _ in range(6):
            last = algo.train()
            if last["episode_return_mean"] >= 13.0:
                break
        assert last["episode_return_mean"] > first["episode_return_mean"]
        assert last["episodes_total"] > 0
        if not shared:
            assert any(k.startswith("learner/p0/") for k in last)
            assert any(k.startswith("learner/p1/") for k in last)
    finally:
        algo.stop()


def test_multi_agent_ppo_one_iteration_on_both_policies(rt_start):
    """One multi-agent PPO iteration (tier 1: the JAX package's cases
    are `slow`): every trajectory a runner ships is GAE-ready and both
    policies' learners report finite losses."""
    spec = trl.RLModuleSpec(obs_dim=3, num_actions=3)
    algo = _ma_config({"p0": spec, "p1": spec},
                      lambda aid: "p0" if aid == "a0" else "p1").build()
    try:
        out = rt.get(algo.env_runners[0].sample.remote(), timeout=120)
        assert set(out) == {"p0", "p1"}
        for trajs in out.values():
            assert sum(len(t["obs"]) for t in trajs) == 64
            assert all(t["obs"].shape[1:] == (3,) for t in trajs)
        r = algo.train()
        for pid in ("p0", "p1"):
            assert np.isfinite(r[f"learner/{pid}/total_loss"])
    finally:
        algo.stop()
