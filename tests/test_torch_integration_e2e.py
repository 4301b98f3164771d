"""Full-stack integration on the port: Data pipeline -> TorchTrainer ->
checkpoint -> Serve with batching over real HTTP, the counterpart of
tests/test_integration_e2e.py's one flow (its JAX gradient descent is
torch autograd here, on the CPU; the proxy takes a free port). `slow`,
as the JAX file is.
"""

import json
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rtd
from ray_tpu_torch import serve
from ray_tpu_torch.train import (Checkpoint, RunConfig, ScalingConfig,
                                 TorchTrainer)

pytestmark = pytest.mark.slow  # chaos/e2e tier — fast runs skip


def _train_loop(config):
    """Fit y = 2x + 1 by gradient descent over a Data shard."""
    import torch

    from ray_tpu_torch import train

    shard = config["shards"][train.get_world_rank()]
    xs = torch.tensor([r["x"] for r in shard.take_all()],
                      dtype=torch.float32)
    ys = 2.0 * xs + 1.0

    params = {"w": torch.zeros((), requires_grad=True),
              "b": torch.zeros((), requires_grad=True)}

    def loss_fn(p):
        pred = p["w"] * xs + p["b"]
        return ((pred - ys) ** 2).mean()

    for step in range(config["steps"]):
        gw, gb = torch.autograd.grad(loss_fn(params),
                                     [params["w"], params["b"]])
        with torch.no_grad():
            params = {"w": (params["w"] - 0.4 * gw).requires_grad_(True),
                      "b": (params["b"] - 0.4 * gb).requires_grad_(True)}
        loss = float(loss_fn(params))
        if train.get_world_rank() == 0 and step == config["steps"] - 1:
            ckpt = Checkpoint.from_dict(
                {"w": float(params["w"]), "b": float(params["b"])}
            )
            train.report({"loss": loss}, checkpoint=ckpt)
        else:
            train.report({"loss": loss})


def test_data_train_serve_end_to_end(tmp_path):
    rt.init(num_cpus=4)
    try:
        # 1. Data: build + transform a dataset, split into worker shards.
        ds = rtd.from_items(
            [{"x": float(i)} for i in range(64)], parallelism=4
        ).map(lambda r: {"x": r["x"] / 64.0})
        shards = ds.split(2)

        # 2. Train: 2-worker data-parallel fit, checkpoint the model.
        trainer = TorchTrainer(
            _train_loop,
            train_loop_config={"steps": 300, "shards": shards},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="e2e", storage_path=str(tmp_path)),
        )
        result = trainer.fit()
        assert result.error is None
        model = result.checkpoint.to_dict()
        assert abs(model["w"] - 2.0) < 0.3 and abs(model["b"] - 1.0) < 0.3

        # 3. Serve the checkpoint with dynamic batching over real HTTP.
        @serve.deployment(max_ongoing_requests=8)
        class LinearModel:
            def __init__(self, ckpt_dict):
                self.w = ckpt_dict["w"]
                self.b = ckpt_dict["b"]

            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
            def predict(self, xs):
                return [self.w * x + self.b for x in xs]

            def __call__(self, x):
                return self.predict(x)

        serve.run(LinearModel.bind(model), name="linear")
        addr = serve.start_http_proxy(port=0)

        from concurrent.futures import ThreadPoolExecutor

        def call(x):
            req = urllib.request.Request(
                f"{addr}/linear",
                data=json.dumps({"x": x}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())["result"]

        with ThreadPoolExecutor(max_workers=8) as pool:
            preds = list(pool.map(call, [0.0, 0.25, 0.5, 1.0] * 2))
        for x, pred in zip([0.0, 0.25, 0.5, 1.0] * 2, preds):
            assert abs(pred - (model["w"] * x + model["b"])) < 1e-5
    finally:
        serve.shutdown()
        rt.shutdown()
