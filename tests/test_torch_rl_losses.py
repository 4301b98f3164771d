"""The port's RL losses, returns and data plumbing held against the JAX
package's: ppo/a2c/impala/appo/dqn/noisy/c51 losses (values and every
gradient), compute_gae, vtrace, n_step_transitions,
categorical_projection, both replay buffers and the connectors.

Inputs are seeded numpy arrays, the module weights one JAX init moved
into the port (`rl.core.convert`). Tolerance: f32 rtol 1e-5 with an
absolute floor of 1e-5 times the reference's largest magnitude; the
numpy-only pieces (GAE, n-step, projection, replay, connectors) must be
equal, as the port keeps the JAX package's numpy code.
"""

import numpy as np
import pytest
import torch

import jax

from ray_tpu.rl import connectors as jconn
from ray_tpu.rl import env_runner as jenv
from ray_tpu.rl import replay as jreplay
from ray_tpu.rl.algorithms import appo as jappo
from ray_tpu.rl.algorithms import dqn as jdqn
from ray_tpu.rl.algorithms import impala as jimpala
from ray_tpu.rl.algorithms import ppo as jppo
from ray_tpu.rl.core import rl_module as jrl
from ray_tpu_torch.rl import connectors as tconn
from ray_tpu_torch.rl import env_runner as tenv
from ray_tpu_torch.rl import replay as treplay
from ray_tpu_torch.rl.algorithms import appo as tappo
from ray_tpu_torch.rl.algorithms import dqn as tdqn
from ray_tpu_torch.rl.algorithms import impala as timpala
from ray_tpu_torch.rl.algorithms import ppo as tppo
from ray_tpu_torch.rl.core import convert
from ray_tpu_torch.rl.core import rl_module as trl

torch.set_num_threads(1)

RTOL = 1e-5


def close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.shape(got) == want.shape, (what, np.shape(got), want.shape)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def rng(seed):
    return np.random.default_rng(seed)


def pair(name, spec_kw, *args, spec="RLModuleSpec"):
    jm = getattr(jrl, name)(getattr(jrl, spec)(**spec_kw), *args)
    params = jm.init(jax.random.PRNGKey(0))
    tm = getattr(trl, name)(getattr(trl, spec)(**spec_kw), *args)
    tm.set_weights(jax.tree.map(np.asarray, params))
    return jm, params, tm


def check_loss(jloss, tloss, jm, params, tm, batch):
    """Loss, every metric and every gradient of the two packages."""
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jloss(p, jm, batch), has_aux=True)(params)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    tl, tmet = tloss(tm, tb)
    close(tl, jl, what="loss")
    assert set(tmet) == set(jmet)
    for k in jmet:
        close(tmet[k], jmet[k], what=k)
    leaves = convert.flatten(tm.tree())
    grads = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)
    want = convert.flatten(convert.tree_from_jax(
        jax.tree.map(np.asarray, jg)))
    for (k, _), g in zip(leaves.items(), grads):
        close(torch.zeros_like(want[k]) if g is None else g, want[k],
              what=f"grad {k}")


def ppo_batch(n, seed=1, obs_dim=4, actions=2):
    r = rng(seed)
    return {
        "obs": r.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": r.integers(0, actions, n).astype(np.int32),
        "logp": (r.normal(size=n) * 0.3 - 0.7).astype(np.float32),
        "advantages": (r.normal(size=n) * 2 + 0.5).astype(np.float32),
        "returns": r.normal(size=n).astype(np.float32),
    }


# -- PPO and A2C -------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 64])
def test_ppo_loss_values_and_gradients_match_jax(n):
    """n=8: numpy's population std and torch's default (unbiased) one
    differ by sqrt(8/7), far beyond the tolerance, so this case pins
    correction=0 in the advantage normalisation."""
    jm, params, tm = pair("DiscretePolicyModule", dict(obs_dim=4,
                                                       num_actions=2))
    check_loss(jppo.ppo_loss, tppo.ppo_loss, jm, params, tm, ppo_batch(n))


def test_ppo_loss_on_the_conv_module_matches_jax():
    kw = dict(obs_shape=(12, 12, 1), num_actions=3, feature_dim=16,
              hidden=(8,))
    jm, params, tm = pair("ConvPolicyModule", kw, spec="ConvModuleSpec")
    b = ppo_batch(6, obs_dim=1, actions=3)
    b["obs"] = rng(2).normal(size=(6, 12, 12, 1)).astype(np.float32)
    check_loss(jppo.ppo_loss, tppo.ppo_loss, jm, params, tm, b)


def test_a2c_loss_values_and_gradients_match_jax():
    jm, params, tm = pair("DiscretePolicyModule", dict(obs_dim=4,
                                                       num_actions=2))
    check_loss(jppo.a2c_loss, tppo.a2c_loss, jm, params, tm, ppo_batch(32))


# -- V-trace, IMPALA, APPO ---------------------------------------------------

def bt_batch(B=3, T=5, seed=3, obs_dim=4):
    r = rng(seed)
    dones = np.zeros((B, T), np.float32)
    dones[0, 2] = dones[2, 4] = 1.0
    return {
        "obs": r.normal(size=(B, T, obs_dim)).astype(np.float32),
        "actions": r.integers(0, 2, (B, T)).astype(np.int32),
        "logp": (r.normal(size=(B, T)) * 0.5 - 0.7).astype(np.float32),
        "values": r.normal(size=(B, T)).astype(np.float32),
        "rewards": r.normal(size=(B, T)).astype(np.float32),
        "dones": dones,
        "last_obs": r.normal(size=(B, obs_dim)).astype(np.float32),
        "last_values": r.normal(size=B).astype(np.float32),
    }


def test_vtrace_matches_jax_on_one_rollout_and_batched():
    """Behaviour and target log-probs apart by up to ~1.5 nats, so both
    the rho and the c clips bind on some steps."""
    b = bt_batch(B=4, T=9, seed=4)
    target = b["logp"] + rng(5).normal(size=b["logp"].shape).astype(
        np.float32) * 0.8
    boot = b["last_values"]
    for gamma, clip_rho, clip_c in ((0.99, 1.0, 1.0), (0.9, 2.0, 0.5)):
        for i in range(4):
            want = jimpala.vtrace(b["logp"][i], target[i], b["rewards"][i],
                                  b["values"][i], boot[i], b["dones"][i],
                                  gamma, clip_rho, clip_c)
            got = timpala.vtrace(*(torch.from_numpy(x) for x in (
                b["logp"][i], target[i], b["rewards"][i], b["values"][i])),
                torch.tensor(boot[i]), torch.from_numpy(b["dones"][i]),
                gamma, clip_rho, clip_c)
            for g, w in zip(got, want):
                close(g, w)
        batched = timpala.vtrace(*(torch.from_numpy(x) for x in (
            b["logp"], target, b["rewards"], b["values"], boot, b["dones"])),
            gamma, clip_rho, clip_c)
        want = jax.vmap(lambda *a: jimpala.vtrace(*a, gamma, clip_rho,
                                                  clip_c))(
            b["logp"], target, b["rewards"], b["values"], boot, b["dones"])
        for g, w in zip(batched, want):
            close(g, w)


def test_vtrace_terminal_cuts_bootstrap():
    z = torch.zeros(2)
    vs, _ = timpala.vtrace(z, z, torch.tensor([1.0, 2.0]), z,
                           torch.tensor(100.0), torch.tensor([0.0, 1.0]),
                           gamma=1.0)
    np.testing.assert_allclose(vs.numpy(), [3.0, 2.0], rtol=1e-6)


def test_impala_loss_values_and_gradients_match_jax():
    jm, params, tm = pair("DiscretePolicyModule", dict(obs_dim=4,
                                                       num_actions=2))
    b = {k: v for k, v in bt_batch().items()
         if k not in ("values", "last_values")}
    check_loss(lambda p, m, x: jimpala.impala_loss(p, m, x, gamma=0.95),
               lambda m, x: timpala.impala_loss(m, x, gamma=0.95),
               jm, params, tm, b)


@pytest.mark.parametrize("bootstrap", ["last_values", "last_obs"])
def test_appo_loss_values_and_gradients_match_jax(bootstrap):
    jm, params, tm = pair("DiscretePolicyModule", dict(obs_dim=4,
                                                       num_actions=2))
    b = bt_batch(seed=6)
    if bootstrap == "last_obs":
        del b["last_values"]
    check_loss(jappo.appo_loss, tappo.appo_loss, jm, params, tm, b)


# -- the DQN family ----------------------------------------------------------

def q_batch(n=16, seed=7, weights=False):
    r = rng(seed)
    b = {
        "obs": r.normal(size=(n, 5)).astype(np.float32),
        "actions": r.integers(0, 3, n).astype(np.int32),
        "targets": (r.normal(size=n) * 2).astype(np.float32),
    }
    if weights:
        b["weights"] = r.uniform(0.1, 1.0, n).astype(np.float32)
    return b


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("name", ["QNetworkModule", "DuelingQNetworkModule"])
def test_dqn_loss_values_and_gradients_match_jax(name, weights):
    jm, params, tm = pair(name, dict(obs_dim=5, num_actions=3,
                                     hidden=(16, 8)))
    check_loss(jdqn.dqn_loss, tdqn.dqn_loss, jm, params, tm,
               q_batch(weights=weights))


def test_noisy_dqn_loss_with_given_noise_matches_jax():
    jm, params, tm = pair("NoisyQNetworkModule", dict(obs_dim=5,
                                                      num_actions=3,
                                                      hidden=(16, 8)))
    b = q_batch(weights=True)
    b["eps_in"], b["eps_out"] = jrl.factorized_noise_np(rng(8), 8, 3)
    check_loss(jdqn.noisy_dqn_loss, tdqn.noisy_dqn_loss, jm, params, tm, b)


@pytest.mark.parametrize("weights", [False, True])
def test_c51_loss_values_and_gradients_match_jax(weights):
    jm, params, tm = pair("C51QNetworkModule",
                          dict(obs_dim=5, num_actions=3, hidden=(16,)),
                          11, -2.0, 2.0)
    b = q_batch(weights=weights)
    del b["targets"]
    p = rng(9).uniform(size=(16, 11)).astype(np.float32)
    b["target_probs"] = p / p.sum(-1, keepdims=True)
    check_loss(jdqn.c51_loss, tdqn.c51_loss, jm, params, tm, b)


def test_categorical_projection_equals_jax_and_keeps_its_edge_rounding():
    r = rng(10)
    support = np.linspace(-1.0, 1.0, 5)
    probs = r.uniform(size=(6, 5)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    args = (probs, support, r.normal(size=6).astype(np.float32),
            r.uniform(0.5, 1.0, 6).astype(np.float32),
            (r.uniform(size=6) < 0.3).astype(np.float32))
    np.testing.assert_array_equal(tdqn.categorical_projection(*args),
                                  jdqn.categorical_projection(*args))
    # An inexact dz must not index past the last atom when targets clip
    # to v_max (hi = ceil(b) = N without the clamp).
    support = np.linspace(42.57, 71.49, 95)
    probs = np.full((4, 95), 1.0 / 95, dtype=np.float32)
    args = (probs, support, np.full(4, 1e6, dtype=np.float32),
            np.ones(4, dtype=np.float32), np.zeros(4, dtype=np.float32))
    out = tdqn.categorical_projection(*args)
    np.testing.assert_array_equal(out, jdqn.categorical_projection(*args))
    assert np.allclose(out.sum(-1), 1.0, atol=1e-4)
    assert out[:, -1] == pytest.approx(np.ones(4), abs=1e-4)


# -- returns and transitions --------------------------------------------------

def test_compute_gae_equals_jax():
    r = rng(11)
    batch = {
        "rewards": r.normal(size=40).astype(np.float32),
        "values": r.normal(size=40).astype(np.float32),
        "dones": (r.uniform(size=40) < 0.1).astype(np.float32),
        "last_value": 0.37,
    }
    for gamma, lam in ((0.99, 0.95), (1.0, 1.0), (0.5, 0.0)):
        want = jenv.compute_gae(batch, gamma, lam)
        got = tenv.compute_gae(batch, gamma, lam)
        for k in ("advantages", "returns"):
            np.testing.assert_array_equal(got[k], want[k])


def test_n_step_transitions_equal_jax():
    r = rng(12)
    T = 30
    batch = {
        "obs": r.normal(size=(T, 3)).astype(np.float32),
        "next_obs": r.normal(size=(T, 3)).astype(np.float32),
        "actions": r.integers(0, 2, T).astype(np.int32),
        "rewards": r.normal(size=T).astype(np.float32),
        "dones": (r.uniform(size=T) < 0.1).astype(np.float32),
    }
    ends = (batch["dones"] > 0) | (r.uniform(size=T) < 0.05)
    for n, gamma in ((1, 0.99), (3, 0.9), (5, 0.5)):
        want = jreplay.n_step_transitions(batch, ends, n, gamma)
        got = treplay.n_step_transitions(batch, ends, n, gamma)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _transitions(n, seed, obs_shape=(2,)):
    r = rng(seed)
    return {
        "obs": r.normal(size=(n, *obs_shape)).astype(np.float32),
        "next_obs": r.normal(size=(n, *obs_shape)).astype(np.float32),
        "actions": r.integers(0, 4, n).astype(np.int32),
        "rewards": r.normal(size=n).astype(np.float32),
        "dones": (r.uniform(size=n) < 0.2).astype(np.float32),
        "discounts": r.uniform(0.5, 1.0, n).astype(np.float32),
    }


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffers_sample_as_jax_under_one_seed(prioritized):
    def run(mod):
        cls = (mod.PrioritizedReplayBuffer if prioritized
               else mod.ReplayBuffer)
        buf = cls(capacity=50, obs_dim=(3, 2), seed=4, store_discounts=True)
        out = []
        for i in range(4):  # the third add wraps the ring
            buf.add_batch(_transitions(20, 20 + i, (3, 2)))
            if prioritized:
                mb = buf.sample(16, beta=0.5)
                buf.update_priorities(mb["indices"],
                                      rng(40 + i).uniform(size=16) * 3)
            else:
                mb = buf.sample(16)
            out.append(mb)
        return len(buf), out

    (nj, want), (nt, got) = run(jreplay), run(treplay)
    assert nj == nt == 50
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_connectors_equal_jax():
    def run(mod):
        pipe = mod.ConnectorPipeline([mod.FlattenObs(),
                                      mod.NormalizeObs(clip=5.0),
                                      mod.ClipReward(bound=1.0)])
        r = rng(13)
        outs = [pipe(r.normal(loc=7.0, scale=2.0, size=(2, 3)))
                for _ in range(50)]
        rewards = [pipe.transform_reward(x) for x in (10.0, -3.0, 0.5)]
        return outs, rewards, pipe.get_state()

    (jo, jr, js), (to, tr, ts) = run(jconn), run(tconn)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a, b)
    assert tr == jr == [1.0, -1.0, 0.5]
    assert ts[1]["count"] == js[1]["count"] == 50
    np.testing.assert_array_equal(ts[1]["mean"], js[1]["mean"])
    pipe = tconn.ConnectorPipeline([tconn.FlattenObs(),
                                    tconn.NormalizeObs(clip=5.0),
                                    tconn.ClipReward()])
    pipe.set_state(ts)
    x = rng(14).normal(size=(2, 3))
    ref = jconn.ConnectorPipeline([jconn.FlattenObs(),
                                   jconn.NormalizeObs(clip=5.0),
                                   jconn.ClipReward()])
    ref.set_state(js)
    np.testing.assert_array_equal(pipe(x), ref(x))
