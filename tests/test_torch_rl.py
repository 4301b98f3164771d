"""The port's RL stack (ray_tpu_torch.rl) on the cases of
tests/test_rl.py and tests/test_rl_extras.py that its slice holds:
module shapes and math, the learner, GAE and V-trace, replay, the
runners (vectorized, with connectors, recurrent), PPO, A2C, IMPALA,
APPO and the DQN family (double, dueling, n-step, PER, C51, noisy) on
CartPole and the pixel env, evaluation, checkpoint and restore, Tune,
and the trainable's resources. Each case carries `slow` exactly where
its JAX counterpart does, and asserts what that one asserts; learners
run on the CPU (device="cpu"). The names of the second half (ROADMAP
A7b) import as the others do; their cases are in test_torch_rl_extras.py
and test_torch_rl_offline.py.

This file imports no JAX: env classes defined here reach the port's
workers by reference, and the workers must not load JAX. The parity of
each function with the JAX package's is in test_torch_rl_models.py,
test_torch_rl_losses.py and test_torch_rl_learner.py.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rl import (
    DiscretePolicyModule,
    Learner,
    PPOConfig,
    RLModuleSpec,
    compute_gae,
    ppo_loss,
)

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def rt_start():
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


# -- tests/test_rl.py --------------------------------------------------------

def test_module_forward_shapes():
    module = DiscretePolicyModule(RLModuleSpec(obs_dim=4, num_actions=2))
    out = module(torch.zeros((7, 4)))
    assert out["action_logits"].shape == (7, 2)
    assert out["value"].shape == (7,)


def test_learner_update_reduces_loss():
    learner = Learner(DiscretePolicyModule(RLModuleSpec(4, 2)), ppo_loss,
                      seed=0, device=CPU)
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.normal(size=(64, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=64).astype(np.int32),
        "logp": np.full(64, -0.69, dtype=np.float32),
        "advantages": rng.normal(size=64).astype(np.float32),
        "returns": rng.normal(size=64).astype(np.float32),
    }
    m1 = learner.update_from_batch(batch)
    for _ in range(10):
        m2 = learner.update_from_batch(batch)
    assert m2["vf_loss"] < m1["vf_loss"]
    assert np.isfinite(m2["total_loss"])


def test_learner_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Learner(DiscretePolicyModule(RLModuleSpec(4, 2)), ppo_loss)


def test_gae_simple_case():
    batch = {
        "rewards": np.array([1.0, 1.0, 1.0], dtype=np.float32),
        "values": np.array([0.0, 0.0, 0.0], dtype=np.float32),
        "dones": np.array([0.0, 0.0, 1.0], dtype=np.float32),
        "last_value": 5.0,
    }
    out = compute_gae(batch, gamma=1.0, lam=1.0)
    np.testing.assert_allclose(out["returns"], [3.0, 2.0, 1.0])


def test_gae_bootstrap_on_truncation():
    batch = {
        "rewards": np.array([0.0, 0.0], dtype=np.float32),
        "values": np.array([0.0, 0.0], dtype=np.float32),
        "dones": np.array([0.0, 0.0], dtype=np.float32),
        "last_value": 10.0,
    }
    out = compute_gae(batch, gamma=0.5, lam=1.0)
    np.testing.assert_allclose(out["returns"], [2.5, 5.0])


def test_vtrace_reduces_to_td_lambda_on_policy():
    from ray_tpu_torch.rl import vtrace

    T = 5
    rng = np.random.default_rng(0)
    logp = torch.from_numpy(rng.normal(size=T).astype(np.float32))
    rewards = torch.from_numpy(rng.normal(size=T).astype(np.float32))
    values = torch.from_numpy(rng.normal(size=T).astype(np.float32))
    gamma = 0.9
    vs, _ = vtrace(logp, logp, rewards, values, torch.tensor(0.7),
                   torch.zeros(T), gamma=gamma)
    expected = np.zeros(T)
    acc = 0.7
    for t in reversed(range(T)):
        acc = float(rewards[t]) + gamma * acc
        expected[t] = acc
    np.testing.assert_allclose(vs.numpy(), expected, rtol=1e-5)


def test_vtrace_terminal_cuts_bootstrap():
    from ray_tpu_torch.rl import vtrace

    z = torch.zeros(2)
    vs, _ = vtrace(z, z, torch.tensor([1.0, 2.0]), z, torch.tensor(100.0),
                   torch.tensor([0.0, 1.0]), gamma=1.0)
    np.testing.assert_allclose(vs.numpy(), [3.0, 2.0], rtol=1e-6)


def test_replay_buffer_ring_and_sampling():
    from ray_tpu_torch.rl import ReplayBuffer

    buf = ReplayBuffer(capacity=10, obs_dim=2, seed=0)
    for start in (0, 6):  # second add wraps the ring
        buf.add_batch({
            "obs": np.full((6, 2), start, dtype=np.float32),
            "next_obs": np.full((6, 2), start + 1, dtype=np.float32),
            "actions": np.arange(start, start + 6, dtype=np.int32),
            "rewards": np.ones(6, dtype=np.float32),
            "dones": np.zeros(6, dtype=np.float32),
        })
    assert len(buf) == 10
    mb = buf.sample(32)
    assert mb["obs"].shape == (32, 2)
    assert set(mb["actions"]) <= set(range(12))


def test_vector_env_runner_shapes_and_stats(rt_start):
    from ray_tpu_torch.rl import VectorEnvRunner

    spec = RLModuleSpec(4, 2, (32,))
    runner = VectorEnvRunner.options(num_cpus=0.5).remote(
        _cartpole, lambda: DiscretePolicyModule(spec), num_envs=4,
        rollout_length=64, seed=3,
    )
    learner = Learner(DiscretePolicyModule(spec), None, seed=0, device=CPU)
    rt.get(runner.set_weights.remote(learner.get_weights()), timeout=120)
    batch = rt.get(runner.sample.remote(), timeout=300)
    assert batch["obs"].shape == (64, 4, 4)
    assert batch["actions"].shape == (64, 4)
    assert batch["logp"].shape == (64, 4)
    assert batch["rewards"].shape == (64, 4)
    assert batch["dones"].shape == (64, 4)
    assert batch["last_values"].shape == (4,)
    assert batch["last_obs"].shape == (4, 4)
    assert batch["dones"].sum() > 0
    stats = rt.get(runner.episode_stats.remote(), timeout=60)
    assert stats["episodes"] > 0
    rt.kill(runner)


def _improves(algo, iters, bar, stop_at=None, first=None):
    try:
        first = algo.train() if first is None else first
        best = 0.0
        for _ in range(iters):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if stop_at is not None and best >= stop_at:
                break
        assert best > first["episode_return_mean"] or best > bar, (
            f"no improvement: first={first['episode_return_mean']}, "
            f"best={best}")
        return result
    finally:
        algo.stop()


@pytest.mark.slow
def test_ppo_cartpole_improves(rt_start):
    config = (
        PPOConfig()
        .environment(_cartpole, obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=256)
        .training(lr=3e-3, num_epochs=4, minibatch_size=128, device=CPU)
    )
    result = _improves(config.build(), 6, 60.0)
    assert result["episodes_total"] > 0


@pytest.mark.slow
def test_impala_cartpole_improves(rt_start):
    from ray_tpu_torch.rl import IMPALAConfig

    algo = (
        IMPALAConfig()
        .environment(_cartpole, obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=128)
        .training(lr=3e-3, updates_per_iteration=8, rollouts_per_update=2,
                  device=CPU)
        .build()
    )
    _improves(algo, 8, 60.0, stop_at=75.0)


def _dqn_learns(algo, iters=30, bar=75.0, check=None):
    try:
        best, first = -1.0, None
        for _ in range(iters):
            result = algo.train()
            if check is not None:
                check(result)
            if first is None and result["episodes_total"] > 0:
                first = result["episode_return_mean"]
            best = max(best, result["episode_return_mean"])
            if best >= bar:
                break
        assert best >= bar, f"DQN failed to learn: first={first} best={best}"
        return result
    finally:
        algo.stop()


@pytest.mark.slow
def test_dqn_cartpole_improves(rt_start):
    from ray_tpu_torch.rl import DQNConfig

    algo = (
        DQNConfig()
        .environment(_cartpole, obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=200)
        .training(lr=1e-3, train_batch_size=64, updates_per_iteration=64,
                  learning_starts=400, target_update_freq=2, device=CPU)
        .exploration(epsilon_start=1.0, epsilon_end=0.05,
                     epsilon_decay_iters=6)
        .build()
    )
    result = _dqn_learns(algo)
    assert result["buffer_size"] > 400


@pytest.mark.slow
def test_appo_cartpole_improves(rt_start):
    from ray_tpu_torch.rl import APPOConfig

    algo = (
        APPOConfig()
        .environment(_cartpole, obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=2, num_envs_per_runner=4,
                     rollout_length=64)
        .training(lr=3e-3, updates_per_iteration=8, rollouts_per_update=1,
                  device=CPU)
        .build()
    )
    _improves(algo, 8, 60.0, stop_at=75.0)


class _PickleCartPole:
    """Classic cart-pole dynamics on plain numpy with the gymnasium API,
    which always pickles (runner checkpoints carry the live env)."""

    _GRAV, _MASS_CART, _MASS_POLE = 9.8, 1.0, 0.1
    _HALF_LEN, _FORCE, _DT = 0.5, 10.0, 0.02
    _X_LIM, _THETA_LIM = 2.4, 12 * np.pi / 180.0

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, dtype=np.float64)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self._FORCE if int(action) == 1 else -self._FORCE
        total_m = self._MASS_CART + self._MASS_POLE
        pole_ml = self._MASS_POLE * self._HALF_LEN
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        tmp = (force + pole_ml * theta_dot**2 * sin_t) / total_m
        theta_acc = (self._GRAV * sin_t - cos_t * tmp) / (
            self._HALF_LEN
            * (4.0 / 3.0 - self._MASS_POLE * cos_t**2 / total_m)
        )
        x_acc = tmp - pole_ml * theta_acc * cos_t / total_m
        self._state = np.array([
            x + self._DT * x_dot,
            x_dot + self._DT * x_acc,
            theta + self._DT * theta_dot,
            theta_dot + self._DT * theta_acc,
        ])
        self._t += 1
        terminated = bool(abs(self._state[0]) > self._X_LIM
                          or abs(self._state[2]) > self._THETA_LIM)
        truncated = self._t >= 200
        return self._state.astype(np.float32), 1.0, terminated, truncated, {}


@pytest.mark.slow
def test_ppo_evaluation_and_checkpoint_restore(rt_start, tmp_path):
    def build():
        return (
            PPOConfig()
            .environment(lambda: _PickleCartPole(), obs_dim=4, num_actions=2)
            .env_runners(num_env_runners=1, rollout_length=128)
            .training(lr=3e-3, num_epochs=2, minibatch_size=64, device=CPU)
            .evaluation(evaluation_interval=2, evaluation_num_env_runners=1,
                        evaluation_duration=3)
            .build()
        )

    algo_a = build()
    try:
        r1 = algo_a.train()
        assert "evaluation" not in r1
        r2 = algo_a.train()
        assert "evaluation" in r2, "interval=2 must evaluate on iter 2"
        ev = r2["evaluation"]
        assert ev["episodes_this_eval"] == 3
        assert np.isfinite(ev["episode_return_mean"])
        assert ev["episode_return_max"] >= ev["episode_return_mean"] >= (
            ev["episode_return_min"])
        ckpt = algo_a.save(str(tmp_path / "ckpt"))
        r3a = algo_a.train()
    finally:
        algo_a.stop()

    algo_b = build()
    try:
        algo_b.restore(ckpt)
        assert algo_b._iteration == 2
        r3b = algo_b.train()
        assert r3b["training_iteration"] == r3a["training_iteration"] == 3
        for k in r3a:
            if k.startswith("learner/"):
                np.testing.assert_allclose(r3b[k], r3a[k], rtol=1e-4,
                                           err_msg=f"{k} diverged")
        assert r3b["episode_return_mean"] == pytest.approx(
            r3a["episode_return_mean"], rel=1e-6)
    finally:
        algo_b.stop()


class PixelSideEnv:
    """A bright dot on the left or right half of a 12x12 frame; the
    action must name the side for +1. Episodes are 16 steps; a random
    policy averages ~8."""

    H = W = 12

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._side = 0

    def _obs(self):
        img = np.zeros((self.H, self.W, 1), dtype=np.float32)
        row = int(self._rng.integers(2, self.H - 2))
        col_half = int(self._rng.integers(1, self.W // 2 - 1))
        col = col_half if self._side == 0 else self.W // 2 + col_half
        img[row - 1:row + 2, col - 1:col + 2, 0] = 1.0
        return img

    def reset(self, *, seed=None, options=None):
        self._t = 0
        self._side = int(self._rng.integers(2))
        return self._obs(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._side else 0.0
        self._t += 1
        self._side = int(self._rng.integers(2))
        return self._obs(), reward, self._t >= 16, False, {}


def test_conv_module_forward_shapes():
    from ray_tpu_torch.rl.core.rl_module import (ConvModuleSpec,
                                                 ConvPolicyModule)

    mod = ConvPolicyModule(ConvModuleSpec((12, 12, 1), num_actions=2))
    obs = torch.zeros((5, 12, 12, 1))
    out = mod(obs)
    assert out["action_logits"].shape == (5, 2)
    assert out["value"].shape == (5,)
    a, logp, v = mod.sample_action(obs, torch.Generator().manual_seed(1))
    assert a.shape == (5,) and logp.shape == (5,) and v.shape == (5,)


@pytest.mark.slow
def test_ppo_pixel_env_improves(rt_start):
    config = (
        PPOConfig()
        .environment(lambda: PixelSideEnv(), obs_shape=(12, 12, 1),
                     num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=128)
        .training(lr=3e-3, num_epochs=4, minibatch_size=64, device=CPU)
    )
    algo = config.build()
    try:
        best = 0.0
        for _ in range(14):
            best = max(best, algo.train()["episode_return_mean"])
            if best >= 12.0:
                break
        assert best >= 12.0, f"conv policy failed to learn: best={best}"
    finally:
        algo.stop()


@pytest.mark.slow
def test_dqn_pixel_env_learns(rt_start):
    from ray_tpu_torch.rl import DQNConfig

    algo = (
        DQNConfig()
        .environment(lambda: PixelSideEnv(), obs_shape=(12, 12, 1),
                     num_actions=2)
        .env_runners(num_env_runners=1, rollout_length=128)
        .training(lr=3e-3, train_batch_size=64, updates_per_iteration=16,
                  learning_starts=128, buffer_capacity=4096, device=CPU)
        .exploration(epsilon_start=1.0, epsilon_end=0.05,
                     epsilon_decay_iters=4)
        .build()
    )
    _dqn_learns(algo, iters=8, bar=12.0)


class CueRecallEnv:
    """Memory task: step 0 shows a cue (+1 or -1 in obs[0]); at the final
    step the action matching the cue earns +1."""

    LEN = 4

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._cue = 1

    def _obs(self):
        o = np.zeros(3, dtype=np.float32)
        if self._t == 0:
            o[0] = float(self._cue)
        o[1] = (self.LEN - self._t) / self.LEN
        o[2] = 1.0 if self._t == self.LEN - 1 else 0.0
        return o

    def reset(self, *, seed=None, options=None):
        self._t = 0
        self._cue = 1 if self._rng.integers(2) else -1
        return self._obs(), {}

    def step(self, action):
        reward, done = 0.0, False
        if self._t == self.LEN - 1:
            reward = 1.0 if int(action) == (1 if self._cue > 0 else 0) else 0.0
            done = True
        self._t += 1
        return self._obs(), reward, done, False, {}


def test_recurrent_module_seq_matches_steps():
    from ray_tpu_torch.rl.core.rl_module import (RecurrentModuleSpec,
                                                 RecurrentPolicyModule)

    mod = RecurrentPolicyModule(RecurrentModuleSpec(obs_dim=3,
                                                    num_actions=2,
                                                    state_dim=8))
    T = 6
    obs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(T, 3)).astype(np.float32))
    dones = torch.tensor([0, 0, 1, 0, 0, 0], dtype=torch.float32)
    h = mod.initial_state(1)
    step_values = []
    for t in range(T):
        out, h = mod.forward_step(obs[t][None], h)
        step_values.append(float(out["value"][0].detach()))
        if dones[t]:
            h = mod.initial_state(1)
    seq = mod.forward_seq(obs[None], mod.initial_state(1), dones[None])
    np.testing.assert_allclose(seq["value"].detach().numpy()[0],
                               step_values, rtol=1e-5)


def test_recurrent_runner_state_and_greedy_evaluation(rt_start):
    """The recurrent runner's checkpoint state carries its GRU state and
    generator; an evaluation runner threads the state greedily (the
    runner half of test_recurrent_ppo_evaluation_and_runner_state; its
    algorithm's half is in test_torch_rl_extras.py)."""
    from ray_tpu_torch.rl.algorithms.algorithm import EvalEnvRunner
    from ray_tpu_torch.rl.core.rl_module import (RecurrentModuleSpec,
                                                 RecurrentPolicyModule)
    from ray_tpu_torch.rl.env_runner import RecurrentEnvRunner

    spec = RecurrentModuleSpec(obs_dim=3, num_actions=2, state_dim=8)
    factory = lambda: RecurrentPolicyModule(spec)  # noqa: E731
    weights = factory().init(4).get_weights()
    runner = RecurrentEnvRunner.remote(lambda: CueRecallEnv(), factory,
                                       seed=1, rollout_length=10)
    ev = EvalEnvRunner.remote(lambda: CueRecallEnv(), factory, seed=2)
    try:
        rt.get([runner.set_weights.remote(weights),
                ev.set_weights.remote(weights)], timeout=120)
        first = rt.get(runner.sample.remote(), timeout=120)
        assert first["state0"].shape == (8,)
        state = rt.get(runner.get_runner_state.remote(), timeout=120)
        assert state["policy_state"] is not None
        a = rt.get(runner.sample.remote(), timeout=120)
        assert rt.get(runner.set_runner_state.remote(state), timeout=120)
        b = rt.get(runner.sample.remote(), timeout=120)
        for k in ("obs", "actions", "logp", "rewards", "state0"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for explore in (False, True):
            out = rt.get(ev.run_episodes.remote(3, explore=explore),
                         timeout=120)
            assert out["lengths"] == [4, 4, 4]
    finally:
        rt.kill(runner)
        rt.kill(ev)


@pytest.mark.slow
def test_ppo_tuned_via_tuner(rt_start, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig

    config = (
        PPOConfig()
        .environment(lambda: CueRecallEnv(), obs_dim=3, num_actions=2)
        .env_runners(num_env_runners=1, rollout_length=64)
        .training(num_epochs=2, minibatch_size=32, device=CPU)
    )
    tuner = tune.Tuner(
        config.as_trainable(stop_iters=2),
        param_space={"lr": tune.grid_search([1e-3, 3e-3])},
        tune_config=tune.TuneConfig(metric="episode_return_mean",
                                    mode="max"),
        run_config=RunConfig(name="rl_tune", storage_path=str(tmp_path)),
    )
    results = tuner.fit()
    best = results.get_best_result()
    assert "episode_return_mean" in best.metrics
    lrs = {row["config/lr"] for row in results.get_dataframe()}
    assert lrs == {1e-3, 3e-3}
    bad = tune.Tuner(
        config.as_trainable(stop_iters=1),
        param_space={"not_a_field": tune.grid_search([1])},
        run_config=RunConfig(name="rl_bad", storage_path=str(tmp_path)),
    )
    errs = [r.error for r in bad.fit() if r.error is not None]
    assert errs and "not_a_field" in str(errs[0])


def test_rl_trainable_checkpoints_and_resources(rt_start, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig

    config = (
        PPOConfig()
        .environment(lambda: CueRecallEnv(), obs_dim=3, num_actions=2)
        .env_runners(num_env_runners=1, rollout_length=32)
        .training(num_epochs=1, minibatch_size=32, device=CPU)
    )
    pinned = tune.with_resources(config, {"CPU": 0.5})
    fn = pinned.as_trainable(stop_iters=1)
    assert fn._tune_resources == {"CPU": 0.5}
    bad = tune.Tuner(
        config.as_trainable(stop_iters=1),
        param_space={"training": tune.grid_search([0.1])},
        run_config=RunConfig(name="rl_bad2", storage_path=str(tmp_path)),
    )
    errs = [r.error for r in bad.fit() if r.error is not None]
    assert errs and "training" in str(errs[0])


# -- tests/test_rl_extras.py (this slice's cases) -----------------------------

def test_flatten_and_normalize_connectors():
    from ray_tpu_torch.rl import ConnectorPipeline, FlattenObs, NormalizeObs

    pipe = ConnectorPipeline([FlattenObs(), NormalizeObs(clip=5.0)])
    rng = np.random.default_rng(0)
    outs = [pipe(rng.normal(loc=7.0, scale=2.0, size=(2, 3)))
            for _ in range(200)]
    assert outs[-1].shape == (6,)
    stacked = np.stack(outs[100:])
    assert abs(stacked.mean()) < 0.5
    assert stacked.std() < 2.0
    pipe2 = ConnectorPipeline([FlattenObs(), NormalizeObs(clip=5.0)])
    pipe2.set_state(pipe.get_state())
    x = rng.normal(loc=7.0, scale=2.0, size=(2, 3))
    np.testing.assert_allclose(pipe(x), pipe2(x), rtol=1e-5)


def test_clip_reward_connector():
    from ray_tpu_torch.rl import ClipReward, ConnectorPipeline

    pipe = ConnectorPipeline([ClipReward(bound=1.0)])
    assert pipe.transform_reward(10.0) == 1.0
    assert pipe.transform_reward(-3.0) == -1.0
    assert pipe.transform_reward(0.5) == 0.5
    obs = np.array([2.0, -2.0], dtype=np.float32)
    np.testing.assert_array_equal(pipe(obs), obs)


def test_env_runner_applies_connectors(rt_start):
    from ray_tpu_torch.rl import ConnectorPipeline, EnvRunner, NormalizeObs

    spec = RLModuleSpec(obs_dim=4, num_actions=2)
    runner = EnvRunner.remote(
        _cartpole, lambda: DiscretePolicyModule(spec), rollout_length=64,
        connectors=ConnectorPipeline([NormalizeObs(clip=3.0)]),
    )
    try:
        weights = DiscretePolicyModule(spec).get_weights()
        rt.get(runner.set_weights.remote(weights), timeout=120)
        batch = rt.get(runner.sample.remote(), timeout=300)
        assert np.abs(batch["obs"]).max() <= 3.0
        state = rt.get(runner.get_connector_state.remote(), timeout=120)
        assert state[0]["count"] >= 64
    finally:
        rt.kill(runner)


def test_continuous_module_tanh_gaussian_math():
    from ray_tpu_torch.rl import ContinuousModuleSpec, ContinuousPolicyModule

    m = ContinuousPolicyModule(ContinuousModuleSpec(
        3, 2, action_low=-2.0, action_high=2.0, hidden=(16,)))
    obs = torch.zeros((5, 3))
    a, logp = m.sample_with_logp(obs, torch.Generator().manual_seed(1))
    assert a.shape == (5, 2) and logp.shape == (5,)
    assert bool((a.abs() <= 1.0).all())
    scaled, _, v = m.sample_action(obs, torch.Generator().manual_seed(1))
    assert bool((scaled.abs() <= 2.0).all()) and v.shape == (5,)
    q1, q2 = m.q_values(obs, a)
    assert q1.shape == (5,) and q2.shape == (5,)
    assert bool((m.deterministic_action(obs).abs() <= 1.0).all())
    # At a vanishing std the tanh-Gaussian log-prob is the Gaussian's
    # density at its own mean plus the change of variables.
    mu, log_std = m._dist(obs)
    gauss = (-log_std - 0.5 * np.log(2 * np.pi)).sum(-1)
    assert bool((logp <= gauss.detach() + 10.0).all())


def test_n_step_transitions_math():
    from ray_tpu_torch.rl import n_step_transitions

    obs = np.arange(5, dtype=np.float32)[:, None]
    nxt = obs + 1
    batch = {
        "obs": obs, "next_obs": nxt,
        "actions": np.zeros(5, dtype=np.int32),
        "rewards": np.array([1, 2, 4, 8, 16], dtype=np.float32),
        "dones": np.array([0, 0, 1, 0, 0], dtype=np.float32),
    }
    ep_ends = np.array([False, False, True, False, False])
    out = n_step_transitions(batch, ep_ends, n=3, gamma=0.5)
    assert out["rewards"][0] == pytest.approx(3.0)
    assert out["dones"][0] == 1.0
    assert out["next_obs"][0] == pytest.approx(nxt[2])
    assert out["discounts"][0] == pytest.approx(0.125)
    assert out["rewards"][1] == pytest.approx(4.0)
    assert out["discounts"][1] == pytest.approx(0.25)
    assert out["rewards"][3] == pytest.approx(16.0)
    assert out["dones"][3] == 0.0
    assert out["discounts"][3] == pytest.approx(0.25)
    assert out["rewards"][4] == pytest.approx(16.0)
    assert out["discounts"][4] == pytest.approx(0.5)


def test_prioritized_replay_bias_and_weights():
    from ray_tpu_torch.rl import PrioritizedReplayBuffer

    buf = PrioritizedReplayBuffer(capacity=64, obs_dim=1, seed=0, alpha=1.0)
    buf.add_batch({
        "obs": np.arange(64, dtype=np.float32)[:, None],
        "next_obs": np.zeros((64, 1), dtype=np.float32),
        "actions": np.zeros(64, dtype=np.int32),
        "rewards": np.zeros(64, dtype=np.float32),
        "dones": np.zeros(64, dtype=np.float32),
    })
    buf.update_priorities(np.arange(64), np.ones(64))
    buf.update_priorities(np.array([7]), np.array([100.0]))
    mb = buf.sample(512, beta=1.0)
    counts = np.bincount(mb["indices"], minlength=64)
    assert counts[7] > 0.4 * 512
    assert mb["weights"].max() == pytest.approx(1.0)
    hot = mb["weights"][mb["indices"] == 7]
    cold = mb["weights"][mb["indices"] != 7]
    assert len(hot) and len(cold)
    assert hot.max() < cold.min()


def test_dueling_module_identifiable_and_samples():
    from ray_tpu_torch.rl import DuelingQNetworkModule

    mod = DuelingQNetworkModule(RLModuleSpec(obs_dim=3, num_actions=4))
    obs = torch.randn((5, 3), generator=torch.Generator().manual_seed(1))
    q = mod(obs)["q_values"]
    assert q.shape == (5, 4)
    with torch.no_grad():
        mod.tree()["a"][-1]["b"].add_(3.7)
    q2 = mod(obs)["q_values"]
    assert torch.allclose(q, q2, atol=1e-5)
    a = mod.sample_action(obs, torch.Generator().manual_seed(2), epsilon=0.0)
    assert a.shape == (5,)


@pytest.mark.slow
def test_rainbow_dqn_cartpole_improves(rt_start):
    from ray_tpu_torch.rl import DQNConfig

    algo = (
        DQNConfig()
        .environment(_cartpole, obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=200)
        .training(lr=1e-3, train_batch_size=64, updates_per_iteration=64,
                  learning_starts=400, target_update_freq=2, double_q=True,
                  dueling=True, n_step=3, prioritized_replay=True,
                  device=CPU)
        .exploration(epsilon_start=1.0, epsilon_end=0.05,
                     epsilon_decay_iters=6)
        .build()
    )
    _dqn_learns(algo)


def test_categorical_projection_math():
    from ray_tpu_torch.rl import categorical_projection

    support = np.linspace(-1.0, 1.0, 5)
    probs = np.full((1, 5), 0.2, dtype=np.float32)
    out = categorical_projection(
        probs, support, np.array([0.25], dtype=np.float32),
        np.array([0.9], dtype=np.float32), np.array([1.0], dtype=np.float32))
    assert out.shape == (1, 5)
    assert out.sum() == pytest.approx(1.0, abs=1e-5)
    assert out[0, 2] == pytest.approx(0.5, abs=1e-5)
    assert out[0, 3] == pytest.approx(0.5, abs=1e-5)
    eye = np.zeros((1, 5), dtype=np.float32)
    eye[0, 1] = 1.0
    out2 = categorical_projection(eye, support, np.zeros(1, np.float32),
                                  np.ones(1, np.float32),
                                  np.zeros(1, np.float32))
    assert np.allclose(out2, eye, atol=1e-6)
    out3 = categorical_projection(eye, support, np.array([50.0], np.float32),
                                  np.ones(1, np.float32),
                                  np.array([1.0], np.float32))
    assert out3[0, -1] == pytest.approx(1.0, abs=1e-5)


def test_c51_module_expected_values():
    from ray_tpu_torch.rl import C51QNetworkModule

    mod = C51QNetworkModule(RLModuleSpec(obs_dim=3, num_actions=2),
                            num_atoms=11, v_min=-2.0, v_max=2.0)
    obs = torch.randn((4, 3), generator=torch.Generator().manual_seed(1))
    out = mod(obs)
    assert out["q_logits"].shape == (4, 2, 11)
    assert out["q_probs"].shape == (4, 2, 11)
    assert torch.allclose(out["q_probs"].sum(-1), torch.ones(4, 2),
                          atol=1e-5)
    expect = (out["q_probs"] * mod.support).sum(-1)
    assert torch.allclose(out["q_values"], expect, atol=1e-5)
    a = mod.sample_action(obs, torch.Generator().manual_seed(2), epsilon=0.0)
    assert a.shape == (4,)


@pytest.mark.slow
def test_a2c_cartpole_improves(rt_start):
    from ray_tpu_torch.rl import A2CConfig

    algo = (
        A2CConfig()
        .environment(_cartpole, obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=256)
        .training(lr=3e-3, device=CPU)
        .build()
    )
    assert algo.config.num_epochs == 1
    _improves(algo, 30, 50.0, stop_at=60.0)


@pytest.mark.slow
def test_c51_dqn_cartpole_improves(rt_start):
    from ray_tpu_torch.rl import DQNConfig

    algo = (
        DQNConfig()
        .environment(_cartpole, obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=200)
        .training(lr=1e-3, train_batch_size=64, updates_per_iteration=64,
                  learning_starts=400, distributional=True, num_atoms=51,
                  v_min=0.0, v_max=100.0, n_step=3, device=CPU)
        .exploration(epsilon_start=1.0, epsilon_end=0.05,
                     epsilon_decay_iters=6)
        .build()
    )
    _dqn_learns(algo)


def test_distributional_plus_dueling_rejected():
    from ray_tpu_torch.rl import DQNConfig

    cfg = (DQNConfig().environment(lambda: None, obs_dim=2, num_actions=2)
           .training(distributional=True, dueling=True, device=CPU))
    with pytest.raises(ValueError, match="distributional"):
        cfg.build()


def test_categorical_projection_edge_rounding():
    from ray_tpu_torch.rl import categorical_projection

    support = np.linspace(42.57, 71.49, 95)
    probs = np.full((4, 95), 1.0 / 95, dtype=np.float32)
    out = categorical_projection(probs, support,
                                 np.full(4, 1e6, dtype=np.float32),
                                 np.ones(4, dtype=np.float32),
                                 np.zeros(4, dtype=np.float32))
    assert np.allclose(out.sum(-1), 1.0, atol=1e-4)
    assert out[:, -1] == pytest.approx(np.ones(4), abs=1e-4)


def test_distributional_single_atom_rejected():
    from ray_tpu_torch.rl import DQNConfig

    cfg = (DQNConfig().environment(lambda: None, obs_dim=2, num_actions=2)
           .training(distributional=True, num_atoms=1, device=CPU))
    with pytest.raises(ValueError, match="num_atoms"):
        cfg.build()


def test_noisy_module_math():
    from ray_tpu_torch.rl import NoisyQNetworkModule, noisy_dqn_loss
    from ray_tpu_torch.rl.core.rl_module import factorized_noise

    mod = NoisyQNetworkModule(RLModuleSpec(obs_dim=3, num_actions=4))
    obs = torch.randn((6, 3), generator=torch.Generator().manual_seed(1))
    q1, q2 = mod(obs)["q_values"], mod(obs)["q_values"]
    assert torch.equal(q1, q2) and q1.shape == (6, 4)
    n1 = factorized_noise(torch.Generator().manual_seed(2), 64, 4)
    n2 = factorized_noise(torch.Generator().manual_seed(3), 64, 4)
    qa = mod(obs, noise=n1)["q_values"]
    qb = mod(obs, noise=n2)["q_values"]
    assert not torch.allclose(qa, q1)
    assert not torch.allclose(qa, qb)
    batch = {"obs": obs, "actions": torch.zeros(6, dtype=torch.int32),
             "targets": torch.ones(6), "eps_in": n1[0], "eps_out": n1[1]}
    loss, _ = noisy_dqn_loss(mod, batch)
    gw, gb = torch.autograd.grad(loss, [mod.sigma_w, mod.sigma_b])
    assert float(gw.abs().sum()) > 0 and float(gb.abs().sum()) > 0
    acts = {int(mod.sample_action(obs[:1],
                                  torch.Generator().manual_seed(k))[0])
            for k in range(40)}
    assert len(acts) > 1


@pytest.mark.slow
def test_noisy_dqn_cartpole_improves(rt_start):
    from ray_tpu_torch.rl import DQNConfig

    algo = (
        DQNConfig()
        .environment(_cartpole, obs_dim=4, num_actions=2)
        .env_runners(num_env_runners=2, rollout_length=200)
        .training(lr=1e-3, train_batch_size=64, updates_per_iteration=64,
                  learning_starts=400, noisy=True, n_step=3, device=CPU)
        .build()
    )

    def check(result):
        assert result["epsilon"] == 0.0  # exploration is the noise

    _dqn_learns(algo, iters=45, check=check)


def test_noisy_multi_learner_split_replicates_noise():
    from ray_tpu_torch.rl.core.learner_group import _split_batch

    batch = {
        "obs": np.zeros((64, 4), dtype=np.float32),
        "actions": np.zeros(64, dtype=np.int32),
        "targets": np.zeros(64, dtype=np.float32),
        "eps_in": np.arange(64, dtype=np.float32),
        "eps_out": np.arange(2, dtype=np.float32),
    }
    shards = _split_batch(batch, 2)
    assert len(shards) == 2
    for s in shards:
        assert s["obs"].shape == (32, 4)
        assert np.array_equal(s["eps_in"], batch["eps_in"])
        assert np.array_equal(s["eps_out"], batch["eps_out"])


# -- the second half's names ----------------------------------------------------

@pytest.mark.parametrize("name", sorted([
    "SAC", "SACConfig", "TD3", "TD3Config", "DDPGConfig", "CQL", "CQLConfig",
    "R2D2", "R2D2Config", "RecurrentPPO", "RecurrentPPOConfig",
    "recurrent_ppo_loss", "APEX", "APEXConfig", "ReplayShardActor",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
    "MultiAgentPPOConfig", "MultiRLModule", "BC", "BCConfig", "MARWIL",
    "MARWILConfig", "bc_loss", "episodes_to_dataset", "dataset_to_batch",
]))
def test_a7b_names_raise_naming_their_item(name):
    """The second half's names, which raised NotImplementedError naming
    A7b until it was ported, now import as exported names, and the
    package has no module __getattr__ left to raise."""
    import importlib

    rl = importlib.import_module("ray_tpu_torch.rl")
    assert name in rl.__all__
    assert name in vars(rl)
    ns = {}
    exec(f"from ray_tpu_torch.rl import {name}", ns)
    assert ns[name] is getattr(rl, name)
    assert not hasattr(rl, "__getattr__") and not hasattr(rl, "A7B_NAMES")
