"""The slice as a whole: data-parallel training through each package's
trainer from the same weights and batches.

The JAX side: `JaxTrainer(num_workers=2, jax_config=JaxConfig(
dp_sync="dcn"))` trains `configs.tiny` in f32 for 4 steps, gradients
averaged by `train.allreduce_gradients` over the DCN group, optax AdamW.
The port's: `TorchTrainer(num_workers=2)` on gloo, the port's
`allreduce_gradients`, `torch.optim.AdamW` with the same hyperparameters.
Both start from one JAX `init_params` tree (carried into the port by
`params_from_jax`), and rank r's batch at step s is the same numpy draw
in both. Each driver runs in a subprocess and prints rank 0's losses and
the path of the checkpoint it wrote after the last step (orbax in the JAX
package, the port's flat tensor file). Tolerance 2e-3, the f32 gradient
tolerance of the card's training step in tests/test_torch_gpu.py (the two
frameworks sum in other orders). The learning rate makes the update
twenty times that tolerance, and the updates themselves are compared
leaf by leaf at a relative tolerance: a port that skips the all-reduce,
or takes rank 0's gradient alone, fails both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from ray_tpu_torch.models import configs, loss_fn, params_from_jax
from ray_tpu_torch.models import params_to_numpy
from tests.test_torch_serve_api import PRELUDE, run_driver

TOL = 2e-3
STEPS = 4
# Large enough that four AdamW steps move every weight by about 0.04,
# twenty times TOL: a checkpoint compared at TOL sees the update.
LR = 1e-2
# The two updates (final - initial weights) agree leaf by leaf to this
# share of their norm; on this host they agree to 4e-5.
UPDATE_RTOL = 1e-3

DRIVER = PRELUDE + r'''
import tempfile

train = importlib.import_module(pkg + ".train")
weights = sys.argv[2]


def nest(flat):
    tree = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers/"):
            tree["layers"][k[len("layers/"):]] = v
        else:
            tree[k] = v
    return tree


def batch(rank, step):
    rng = np.random.default_rng(1000 + 10 * rank + step)
    return rng.integers(0, 256, size=(2, 17)).astype(np.int32)


def jax_loop(config):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu import train
    from ray_tpu.models import configs
    from ray_tpu.models import transformer as tf

    cfg = configs.tiny
    params = jax.tree_util.tree_map(
        jnp.asarray, nest(dict(np.load(config["weights"]))))
    opt = optax.adamw(config["lr"], weight_decay=1e-4)
    state = opt.init(params)
    rank = train.get_world_rank()
    for step in range(config["steps"]):
        loss, g = jax.value_and_grad(tf.loss_fn)(
            params, jnp.asarray(batch(rank, step)), cfg)
        g = train.allreduce_gradients(g)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        ck = None
        if step == config["steps"] - 1 and rank == 0:
            ck = train.Checkpoint.from_pytree(
                params, os.path.join(train.get_trial_dir(), "final"))
        train.report({"step": step, "loss": float(loss),
                      "world": train.get_world_size()}, checkpoint=ck)


def torch_loop(config):
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import configs, loss_fn, params_from_jax

    torch.set_num_threads(1)
    cfg = configs.tiny
    params = params_from_jax(nest(dict(np.load(config["weights"]))), cfg,
                             device="cpu")
    names = [k for k in sorted(params) if k != "layers"]
    leaves = [params[k] for k in names]
    leaves += [params["layers"][k] for k in sorted(params["layers"])]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=config["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    rank = train.get_world_rank()
    for step in range(config["steps"]):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, torch.from_numpy(batch(rank, step)).long(),
                       cfg)
        loss.backward()
        grads = train.allreduce_gradients([t.grad for t in leaves])
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()
        ck = None
        if step == config["steps"] - 1 and rank == 0:
            ck = train.Checkpoint.from_pytree(
                {k: ({kk: vv.detach() for kk, vv in v.items()}
                     if k == "layers" else v.detach())
                 for k, v in params.items()},
                os.path.join(train.get_trial_dir(), "final"))
        train.report({"step": step, "loss": float(loss),
                      "world": train.get_world_size()}, checkpoint=ck)


rt.init(num_cpus=4)
try:
    kw = dict(train_loop_config={"weights": weights, "steps": 4,
                                 "lr": float(sys.argv[3])},
              scaling_config=train.ScalingConfig(num_workers=2),
              run_config=train.RunConfig(
                  name="parity",
                  storage_path=tempfile.mkdtemp(prefix="parity_" + pkg)))
    if pkg == "ray_tpu":
        trainer = train.JaxTrainer(
            jax_loop, jax_config=train.JaxConfig(dp_sync="dcn"), **kw)
    else:
        trainer = train.TorchTrainer(torch_loop, **kw)
    r = trainer.fit()
finally:
    rt.shutdown()
print("RESULT " + json.dumps({
    "error": None if r.error is None else str(r.error),
    "losses": [m["loss"] for m in r.metrics_history],
    "worlds": [m["world"] for m in r.metrics_history],
    "checkpoint": r.checkpoint.path if r.checkpoint else None}))
'''


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_parity")
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jax.random.PRNGKey(0),
                                       jax_configs.tiny))
    weights = tmp / "weights.npz"
    np.savez(weights, **_flat(tree))
    jax_run, port_run = (run_driver(tmp, DRIVER, pkg, str(weights), str(LR),
                                    timeout=600)
                         for pkg in ("ray_tpu", "ray_tpu_torch"))
    return tree, jax_run, port_run


def _tokens():
    return np.random.default_rng(7).integers(0, 256, (2, 17)).astype(np.int32)


def test_reported_losses_agree_at_every_step(runs):
    _, jax_run, port_run = runs
    assert jax_run["error"] is None and port_run["error"] is None
    assert jax_run["worlds"] == port_run["worlds"] == [2] * STEPS
    assert len(jax_run["losses"]) == len(port_run["losses"]) == STEPS
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               rtol=0, atol=TOL)
    # The batches differ step to step: the losses are four numbers.
    assert len(set(np.round(port_run["losses"], 4))) == STEPS


def test_jax_checkpoint_loads_into_the_port(runs):
    from ray_tpu.train import Checkpoint as JaxCheckpoint

    from ray_tpu_torch.train import Checkpoint

    tree, jax_run, port_run = runs
    jax_final = jax.tree_util.tree_map(
        np.asarray, JaxCheckpoint(jax_run["checkpoint"]).to_pytree())
    loaded = params_from_jax(jax_final, configs.tiny, device="cpu")
    port_final = Checkpoint(port_run["checkpoint"]).to_pytree(device="cpu")
    init = _flat(tree)
    for k, t in _flat(port_final).items():
        want = _flat(loaded)[k]
        assert t.dtype == want.dtype and t.shape == want.shape, k
        np.testing.assert_allclose(t.numpy(), want.numpy(), rtol=0,
                                   atol=TOL, err_msg=k)
        # Trained, by far more than the tolerance.
        assert np.abs(want.numpy() - init[k]).max() > 10 * TOL, k
    tok = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        np.testing.assert_allclose(loss_fn(loaded, tok, configs.tiny).item(),
                                   loss_fn(port_final, tok,
                                           configs.tiny).item(),
                                   rtol=0, atol=TOL)


def test_port_checkpoint_loads_into_jax(runs):
    from ray_tpu.train import Checkpoint as JaxCheckpoint

    from ray_tpu_torch.train import Checkpoint

    _, jax_run, port_run = runs
    port_final = Checkpoint(port_run["checkpoint"]).to_pytree(device="cpu")
    as_jax = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(port_final))
    jax_final = jax.tree_util.tree_map(
        jnp.asarray, JaxCheckpoint(jax_run["checkpoint"]).to_pytree())
    assert (jax.tree_util.tree_structure(as_jax)
            == jax.tree_util.tree_structure(jax_final))
    for a, b in zip(jax.tree_util.tree_leaves(as_jax),
                    jax.tree_util.tree_leaves(jax_final)):
        assert a.dtype == b.dtype and a.shape == b.shape
    tok = jnp.asarray(_tokens())
    np.testing.assert_allclose(
        float(jax_tf.loss_fn(as_jax, tok, jax_configs.tiny)),
        float(jax_tf.loss_fn(jax_final, tok, jax_configs.tiny)),
        rtol=0, atol=TOL)



def test_updates_agree_leaf_by_leaf(runs):
    """final - initial weights, per leaf, in both packages: the same
    update to UPDATE_RTOL of its norm."""
    from ray_tpu.train import Checkpoint as JaxCheckpoint

    from ray_tpu_torch.train import Checkpoint

    tree, jax_run, port_run = runs
    init = _flat(tree)
    jax_final = _flat(jax.tree_util.tree_map(
        np.asarray, JaxCheckpoint(jax_run["checkpoint"]).to_pytree()))
    port_final = _flat(params_to_numpy(
        Checkpoint(port_run["checkpoint"]).to_pytree(device="cpu")))
    assert sorted(port_final) == sorted(jax_final) == sorted(init)
    for k in sorted(init):
        want = jax_final[k].astype(np.float64) - init[k]
        got = port_final[k].astype(np.float64) - init[k]
        assert np.linalg.norm(got - want) <= UPDATE_RTOL * np.linalg.norm(
            want), k
