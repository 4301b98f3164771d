"""The port's Learner and LearnerGroup held against the JAX package's
(ray_tpu/rl/core/learner.py, learner_group.py).

  * three Learner updates from the same weights on the same batches
    against the JAX Learner (optax clip_by_global_norm(0.5) + adam):
    every metric, grad_norm (the norm before the clip) included, within
    rtol 1e-5, and every weight after each update within rtol 1e-5 with
    an absolute floor of 1e-3 x lr, a thousandth of one Adam step. Adam
    divides each gradient element by its own RMS, so an element whose
    gradient sits at rounding level (1e-9 to 1e-7 here, next to Adam's
    eps of 1e-8) takes a step that the packages' last-bit differences in
    the loss's sums move by up to a few 1e-4 of lr. One case whose norm
    stays under the clip and one far over it (grad_clip 100 and 0.5);
  * a two-learner LearnerGroup over the DCN group against one learner on
    the same batch from the same weights (the PPO loss normalises
    advantages per shard, so both halves carry the same advantages and
    the shard gradients average to the whole batch's): weights within
    the same tolerance, and both learners' weights bit-equal;
  * get_state/set_state round trips: a learner restored from another's
    state continues bit for bit.
Learners run on the CPU (device="cpu"); the card's run is chip_smoke.py's
rl phase and tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax

from ray_tpu.rl.algorithms import ppo as jppo
from ray_tpu.rl.core import learner as jlearner
from ray_tpu.rl.core import learner_group as jgroup
from ray_tpu.rl.core import rl_module as jrl
from ray_tpu_torch.rl.algorithms import ppo as tppo
from ray_tpu_torch.rl.core import convert
from ray_tpu_torch.rl.core import learner as tlearner
from ray_tpu_torch.rl.core import learner_group as tgroup
from ray_tpu_torch.rl.core import rl_module as trl

torch.set_num_threads(1)

RTOL = 1e-5
SPEC = dict(obs_dim=4, num_actions=2, hidden=(32, 32))


LR = 1e-3


def close_trees(got, want, rtol=RTOL, atol=1e-3 * LR):
    a, b = convert.flatten(got), convert.flatten(want)
    assert set(a) == set(b)
    for k in a:
        w = np.asarray(b[k])
        np.testing.assert_allclose(a[k], w, rtol=rtol, atol=atol, err_msg=k)


def batch(seed, n=64, ret_scale=1.0):
    r = np.random.default_rng(seed)
    return {
        "obs": r.normal(size=(n, 4)).astype(np.float32),
        "actions": r.integers(0, 2, n).astype(np.int32),
        "logp": np.full(n, -0.69, dtype=np.float32),
        "advantages": r.normal(size=n).astype(np.float32),
        "returns": (r.normal(size=n) * ret_scale).astype(np.float32),
    }


@pytest.mark.parametrize("grad_clip,clipped", [(100.0, False), (0.5, True)])
def test_three_updates_match_the_jax_learner(grad_clip, clipped):
    jl = jlearner.Learner(jrl.DiscretePolicyModule(jrl.RLModuleSpec(**SPEC)),
                          jppo.ppo_loss, seed=0, lr=LR,
                          grad_clip=grad_clip)
    tl = tlearner.Learner(trl.DiscretePolicyModule(trl.RLModuleSpec(**SPEC)),
                          tppo.ppo_loss, seed=0, lr=LR, device="cpu",
                          grad_clip=grad_clip)
    tl.set_weights(jl.get_weights())
    for step in range(3):
        b = batch(10 + step, ret_scale=50.0)
        jm = jl.update_from_batch(b)
        tm = tl.update_from_batch(b)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, atol=1e-6,
                                       err_msg=f"step {step} {k}")
        assert (jm["grad_norm"] > grad_clip) == clipped
        close_trees(tl.get_weights(), jax.tree.map(np.asarray,
                                                   jl.get_weights()))


def test_clip_is_optaxs_and_grad_norm_is_taken_before_it():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    norm = tlearner.global_norm(g)
    assert float(norm) == 13.0
    tlearner.clip_by_global_norm_(g, 0.5, norm)
    np.testing.assert_allclose(g[0].numpy(), [3 / 13 * 0.5, 4 / 13 * 0.5],
                               rtol=1e-7)
    small = [torch.tensor([0.3, 0.4])]
    tlearner.clip_by_global_norm_(small, 0.5, tlearner.global_norm(small))
    np.testing.assert_array_equal(small[0].numpy(), np.float32([0.3, 0.4]))


def test_state_round_trip_continues_bit_for_bit():
    a = tlearner.Learner(trl.DiscretePolicyModule(trl.RLModuleSpec(**SPEC)),
                         tppo.ppo_loss, seed=3, device="cpu")
    a.update_from_batch(batch(1))
    state = a.get_state()
    b = tlearner.Learner(trl.DiscretePolicyModule(trl.RLModuleSpec(**SPEC)),
                         tppo.ppo_loss, seed=9, device="cpu")
    b.set_state(state)
    ma, mb = a.update_from_batch(batch(2)), b.update_from_batch(batch(2))
    assert ma == mb
    wa, wb = convert.flatten(a.get_weights()), convert.flatten(b.get_weights())
    for k in wa:
        np.testing.assert_array_equal(wa[k], wb[k])


def test_minibatch_epochs_cover_the_batch_as_jax():
    seen = {"jax": [], "port": []}
    b = {"x": np.arange(10)}
    for name, fn in (("jax", jlearner.minibatch_epochs),
                     ("port", tlearner.minibatch_epochs)):
        fn(lambda mb, name=name: seen[name].append(mb["x"].tolist()) or {},
           b, 2, 4, np.random.default_rng(0))
    assert seen["jax"] == seen["port"] and len(seen["port"]) == 4


def test_split_batch_replicates_shared_keys_as_jax():
    b = {"obs": np.zeros((64, 4), np.float32),
         "eps_in": np.arange(64, dtype=np.float32),
         "eps_out": np.arange(2, dtype=np.float32)}
    assert tgroup.SHARED_BATCH_KEYS == jgroup.SHARED_BATCH_KEYS
    for s, w in zip(tgroup._split_batch(b, 2), jgroup._split_batch(b, 2)):
        for k in w:
            np.testing.assert_array_equal(s[k], w[k])


@pytest.fixture(scope="module")
def rt_torch():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _factory():
    return trl.DiscretePolicyModule(trl.RLModuleSpec(**SPEC))


def test_two_learners_over_dcn_equal_one_learner(rt_torch):
    b = batch(5, n=64)
    # The same advantages in both halves: per-shard normalisation then
    # equals the whole batch's.
    b["advantages"][32:] = b["advantages"][:32][::-1]
    one = tgroup.LearnerGroup(_factory, tppo.ppo_loss, num_learners=1,
                              device="cpu", seed=0, lr=LR)
    two = tgroup.LearnerGroup(_factory, tppo.ppo_loss, num_learners=2,
                              device="cpu", seed=0, lr=LR)
    try:
        w0 = one.get_weights()
        two.set_weights(w0)
        m1 = one.update_from_batch(b)
        m2 = two.update_from_batch(b)
        np.testing.assert_allclose(m2["total_loss"], m1["total_loss"],
                                   rtol=1e-5)
        w1 = one.get_weights()
        ranks = rt_torch.get([a.get_weights.remote() for a in two.actors],
                             timeout=120)
        for k, v in convert.flatten(ranks[0]).items():
            np.testing.assert_array_equal(v, convert.flatten(ranks[1])[k])
        close_trees(ranks[0], w1)
        # Optimizer state too: a second update stays together.
        state = two.get_state()
        one.set_state(state)
        one.update_from_batch(b)
        two.update_from_batch(b)
        close_trees(two.get_weights(), one.get_weights())
        devices = two.foreach_learner(lambda lr: str(lr.device))
        assert devices == ["cpu", "cpu"]
    finally:
        one.shutdown()
        two.shutdown()
