"""DQN's and Ape-X's checkpoints hold the target network: `restore()` in a
fresh algorithm brings back the target and the online snapshots and, in
the port, the algorithm's two nets that compute with them, in both
packages (ray_tpu/rl/algorithms/dqn.py's `_restore_extra_state`). Without it the
next hard sync copies a fresh build's weights into the target network.

Both runtimes run in this process (tests/torch_data_util.py). Tolerance
0: the checkpoint's trees are numpy, and the port's nets load them by
copy onto the algorithm's device (the CPU here; tests/test_torch_gpu.py
restores across the CPU and the card).
"""

import numpy as np
import pytest

import ray_tpu.rl as jax_rl
import ray_tpu_torch.rl as torch_rl
from tests.torch_data_util import both_runtimes

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(scope="module")
def runtimes():
    with both_runtimes(num_cpus=4):
        yield


def _leaves(tree, path=()):
    """(path, numpy array) for every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, np.asarray(tree))]


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.shape == y.shape and np.array_equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def _config(package, config_cls):
    cfg = (config_cls()
           .environment(lambda: __import__("gymnasium").make("CartPole-v1"),
                        obs_dim=4, num_actions=2)
           .env_runners(num_env_runners=1, rollout_length=64))
    device = {} if package == "ray_tpu" else {"device": "cpu"}
    return cfg.training(lr=1e-3, train_batch_size=32, updates_per_iteration=8,
                        learning_starts=64, target_update_freq=2, **device)


def _check_restored(package, algo, saved):
    assert _equal(algo.target_params, saved["target"])
    assert _equal(algo._online_params, saved["online"])
    if package == "ray_tpu_torch":
        assert _equal(algo._target_net.get_weights(), saved["target"])
        assert _equal(algo._online_net.get_weights(), saved["online"])
        for net in (algo._target_net, algo._online_net):
            assert all(p.device == algo.device for p in net.parameters())


@pytest.mark.parametrize("package", PACKAGES)
def test_dqn_restore_brings_back_the_target_network(runtimes, package,
                                                     tmp_path):
    """Three iterations with a hard sync every two: the target holds the
    online weights of iteration 1, the online snapshot those of iteration
    2, and neither a fresh build's. A fresh DQN restored from the
    checkpoint holds both."""
    rl = jax_rl if package == "ray_tpu" else torch_rl
    a = _config(package, rl.DQNConfig).build()
    try:
        for _ in range(3):
            a.train()
        saved = {"target": a.target_params, "online": a._online_params}
        a.save(str(tmp_path))
    finally:
        a.stop()
    b = _config(package, rl.DQNConfig).build()
    try:
        assert not _equal(saved["target"], saved["online"])
        assert not _equal(saved["target"], b.target_params)
        assert not _equal(saved["online"], b._online_params)
        b.restore(str(tmp_path))
        _check_restored(package, b, saved)
    finally:
        b.stop()


@pytest.mark.parametrize("package", PACKAGES)
def test_apex_restore_brings_back_the_target_network(runtimes, package,
                                                      tmp_path):
    """Ape-X takes DQN's checkpoint state. Its replay fills
    asynchronously, so the snapshots are set, not trained: the target and
    the online weights shifted apart, saved, restored into a fresh one."""
    rl = jax_rl if package == "ray_tpu" else torch_rl
    cfg = _config(package, rl.APEXConfig)
    cfg.num_replay_shards = 1
    a = cfg.build()
    try:
        def shifted(tree, by):
            if isinstance(tree, dict):
                return {k: shifted(v, by) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(shifted(v, by) for v in tree)
            return np.asarray(tree) + np.asarray(by, np.asarray(tree).dtype)

        a.target_params = shifted(a.target_params, 0.5)
        a._online_params = shifted(a._online_params, -0.25)
        saved = {"target": a.target_params, "online": a._online_params}
        a.save(str(tmp_path))
    finally:
        a.stop()
    b = cfg.build()
    try:
        assert not _equal(saved["target"], b.target_params)
        b.restore(str(tmp_path))
        _check_restored(package, b, saved)
    finally:
        b.stop()
