"""The port's offline RL (ray_tpu_torch/rl/offline.py) held against the
JAX package's (ray_tpu/rl/offline.py).

Both runtimes run in this process (tests/torch_data_util.py), as the
data tests do: `episodes_to_dataset` and `dataset_to_batch` go through
each package's data library and must give equal rows and arrays,
exactly. `bc_loss` and `marwil_loss`: the loss, every metric and every
gradient within rtol 1e-5 with a floor of 1e-5 x the reference's
largest magnitude (float32). Three Learner updates from the same
weights: every metric within rtol 1e-5 (1e-6 absolute) and every weight
within rtol 1e-5 with a floor of 1e-3 x lr, as
tests/test_torch_rl_learner.py. The cases of tests/test_rl_extras.py
(the dataset round trip, BC on expert data, MARWIL from a streamed
dataset) run under both packages with the same assertions; the port's
learners compute on the CPU (device="cpu").
"""

import numpy as np
import pytest
import torch

import jax

from ray_tpu.rl import offline as joffline
from ray_tpu.rl.core import learner as jlearner
from ray_tpu.rl.core import rl_module as jrl
from ray_tpu_torch.rl import offline as toffline
from ray_tpu_torch.rl.core import convert
from ray_tpu_torch.rl.core import learner as tlearner
from ray_tpu_torch.rl.core import rl_module as trl
from tests.torch_data_util import both_runtimes, plain

torch.set_num_threads(1)

RTOL = 1e-5
LR = 1e-3
OFFLINE = (joffline, toffline)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    with both_runtimes(num_cpus=2):
        yield


def close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.shape(got) == want.shape, (what, np.shape(got), want.shape)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def rollouts(seed, n=3, T=9):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dones = np.zeros(T, np.float32)
        dones[r.integers(0, T)] = 1.0
        out.append({
            "obs": r.normal(size=(T, 4)).astype(np.float32),
            "actions": r.integers(0, 2, T).astype(np.int32),
            "logp": r.normal(size=T).astype(np.float32),
            "rewards": r.normal(size=T).astype(np.float32),
            "dones": dones,
            "last_value": float(r.normal()),
            "last_obs": r.normal(size=4).astype(np.float32),
        })
    return out


@pytest.mark.parametrize("gamma", [None, 0.9])
def test_episodes_to_dataset_and_dataset_to_batch_give_equal_rows(gamma):
    data = rollouts(1)
    ref, out = (plain(mod.episodes_to_dataset(data, gamma=gamma).take_all())
                for mod in OFFLINE)
    assert out == ref and len(out) == 27
    keys = ("obs", "actions", "rewards", "dones", "logp") + (
        ("returns",) if gamma else ())
    ref, out = (plain(mod.dataset_to_batch(
        mod.episodes_to_dataset(data, gamma=gamma), keys=keys))
        for mod in OFFLINE)
    assert out == ref


@pytest.mark.parametrize("mod", OFFLINE, ids=["jax", "port"])
def test_episodes_to_dataset_roundtrip(mod):
    rollouts = [
        {
            "obs": np.arange(6, dtype=np.float32).reshape(3, 2),
            "actions": np.array([0, 1, 0], dtype=np.int32),
            "rewards": np.array([1.0, 2.0, 3.0], dtype=np.float32),
            "last_value": 0.0,  # non-per-step field: must be dropped
        },
        {
            "obs": np.ones((2, 2), dtype=np.float32),
            "actions": np.array([1, 1], dtype=np.int32),
            "rewards": np.array([4.0, 5.0], dtype=np.float32),
            "last_value": 0.0,
        },
    ]
    ds = mod.episodes_to_dataset(rollouts)
    assert ds.count() == 5
    batch = mod.dataset_to_batch(ds, keys=("obs", "actions", "rewards"))
    assert batch["obs"].shape == (5, 2)
    assert batch["actions"].tolist() == [0, 1, 0, 1, 1]
    assert sorted(batch["rewards"].tolist()) == [1.0, 2.0, 3.0, 4.0, 5.0]


SPEC = dict(obs_dim=4, num_actions=3, hidden=(32, 32))


def pair(seed=0):
    jm = jrl.DiscretePolicyModule(jrl.RLModuleSpec(**SPEC))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = trl.DiscretePolicyModule(trl.RLModuleSpec(**SPEC))
    tm.set_weights(jax.tree.map(np.asarray, params))
    return jm, params, tm


def offline_batch(seed, n=48, ret_scale=1.0):
    r = np.random.default_rng(seed)
    return {"obs": r.normal(size=(n, 4)).astype(np.float32),
            "actions": r.integers(0, 3, n).astype(np.int32),
            "returns": (ret_scale * r.normal(size=n)).astype(np.float32)}


LOSSES = [("bc", joffline.bc_loss, toffline.bc_loss)] + [
    (f"marwil beta {b}", joffline.marwil_loss(b), toffline.marwil_loss(b))
    for b in (0.0, 2.0)]


@pytest.mark.parametrize("name,jloss,tloss", LOSSES,
                         ids=[x[0] for x in LOSSES])
def test_offline_losses_and_gradients_match_jax(name, jloss, tloss):
    jm, params, tm = pair()
    b = offline_batch(3)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jloss(p, jm, b), has_aux=True)(params)
    tl, tmet = tloss(tm, {k: torch.from_numpy(v) for k, v in b.items()})
    close(tl, jl, what="loss")
    assert set(tmet) == set(jmet)
    for k in jmet:
        close(tmet[k], jmet[k], what=k)
    leaves = convert.flatten(tm.tree())
    grads = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    for (k, p), g in zip(leaves.items(), grads):  # bc_loss reads no vf
        close(torch.zeros_like(p) if g is None else g, want[k],
              what=f"grad {k}")


@pytest.mark.parametrize("name,jloss,tloss", LOSSES,
                         ids=[x[0] for x in LOSSES])
def test_three_learner_updates_match_the_jax_learner(name, jloss, tloss):
    jl = jlearner.Learner(jrl.DiscretePolicyModule(jrl.RLModuleSpec(**SPEC)),
                          jloss, seed=0, lr=LR)
    tl = tlearner.Learner(trl.DiscretePolicyModule(trl.RLModuleSpec(**SPEC)),
                          tloss, seed=0, lr=LR, device="cpu")
    tl.set_weights(jl.get_weights())
    for step in range(3):
        b = offline_batch(10 + step, ret_scale=20.0)
        jm, tm = jl.update_from_batch(b), tl.update_from_batch(b)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, atol=1e-6,
                                       err_msg=f"step {step} {k}")
        got = convert.flatten(tl.get_weights())
        for k, w in convert.flatten(jax.tree.map(np.asarray,
                                                 jl.get_weights())).items():
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=1e-3 * LR,
                                       err_msg=f"step {step} {k}")


def _configs(mod, name):
    import ray_tpu.rl as jax_rl
    import ray_tpu_torch.rl as torch_rl

    cfg = getattr(jax_rl if mod is joffline else torch_rl, name)()
    if mod is toffline:
        cfg.training(device="cpu")
    return cfg


@pytest.mark.parametrize("mod", OFFLINE, ids=["jax", "port"])
def test_bc_learns_expert_policy(mod):
    rng = np.random.default_rng(0)
    obs = np.zeros((512, 3), dtype=np.float32)
    hot = rng.integers(0, 3, size=512)
    obs[np.arange(512), hot] = 1.0
    ds = mod.episodes_to_dataset([{"obs": obs,
                                   "actions": hot.astype(np.int32)}])
    bc = _configs(mod, "BCConfig").module(obs_dim=3, num_actions=3).training(
        lr=5e-3).build()
    metrics = bc.train_on_dataset(ds, num_epochs=20)
    assert metrics["accuracy"] > 0.95, metrics
    test_obs = np.eye(3, dtype=np.float32)
    np.testing.assert_array_equal(bc.compute_actions(test_obs), [0, 1, 2])


@pytest.mark.parametrize("mod", OFFLINE, ids=["jax", "port"])
def test_marwil_dataset_backed_training(mod):
    """The behavior policy is 50/50, but action 1 earns higher returns:
    MARWIL, trained from the streamed dataset (rows arrive as object
    arrays), must prefer action 1 where plain BC stays near 50/50."""
    rng = np.random.default_rng(3)
    rollouts = []
    for _ in range(8):
        T = 50
        obs = rng.normal(size=(T, 4)).astype(np.float32)
        actions = rng.integers(0, 2, size=T).astype(np.int32)
        rewards = (2.0 * actions - 1.0 + 0.1 * rng.normal(size=T)).astype(
            np.float32)
        dones = np.zeros(T, dtype=np.float32)
        dones[-1] = 1.0
        rollouts.append({"obs": obs, "actions": actions, "rewards": rewards,
                         "dones": dones})
    ds = mod.episodes_to_dataset(rollouts, gamma=0.9)
    assert ds.count() == 8 * 50
    assert "returns" in ds.take(1)[0]
    marwil = (_configs(mod, "MARWILConfig").module(obs_dim=4, num_actions=2)
              .training(lr=5e-3, minibatch_size=64, beta=2.0, gamma=0.9)
              .build())
    metrics = marwil.train_on_dataset(ds, num_epochs=4)
    assert np.isfinite(metrics["total_loss"])
    bc = (_configs(mod, "BCConfig").module(obs_dim=4, num_actions=2)
          .training(lr=5e-3, minibatch_size=64).build())
    bc.train_on_dataset(ds, num_epochs=4)
    probe = rng.normal(size=(256, 4)).astype(np.float32)
    marwil_pref = float((marwil.compute_actions(probe) == 1).mean())
    bc_pref = float((bc.compute_actions(probe) == 1).mean())
    assert marwil_pref > 0.8, marwil_pref
    assert marwil_pref > bc_pref + 0.2, (marwil_pref, bc_pref)
