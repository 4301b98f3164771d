"""Tensor-parallel replicas: the follower ranks an LLMReplica starts.

A replica that the raylet granted more than one card serves with one
process per card: the replica itself is tp rank 0 (the scheduler, the
handles and the streams) and it starts one follower process per further
card, each confined to its card. All of them join one process group
(NCCL where CUDA is, gloo otherwise) through a `file://` rendezvous, and
then each runs the replica's model loader, which builds the mesh and
returns that rank's shards — a mesh never crosses a process boundary, as
in the JAX package, whose loader returns (params, cfg, mesh) too. A
follower builds the engine on its shards and follows rank 0's plans
until rank 0's engine stops; it exits with it, and on its own when the
replica's process is gone.

    python -m ray_tpu_torch.serve.tp <spec file>

is a follower's entry point; `start_followers` writes the spec.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional


class Followers:
    """The follower processes of one replica, and the group they joined."""

    def __init__(self, procs: List[subprocess.Popen], tmp: str):
        self.procs = procs
        self.tmp = tmp

    def stop(self, timeout: float = 30.0) -> None:
        """Wait for the followers to leave (their engines end with rank
        0's), kill any that does not, and leave the process group."""
        import shutil

        import torch.distributed as dist

        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _backend() -> str:
    import torch

    return "nccl" if torch.cuda.is_available() else "gloo"


def _join(rank: int, world: int, init_method: str, backend: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(0)  # each rank's first visible card
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=600))


def start_followers(model_loader, engine_kwargs: dict) -> Optional[Followers]:
    """Start one follower per card this replica holds beyond its first,
    and join this process to their group as rank 0. None (and nothing
    started) where the replica holds one card or none."""
    from ray_tpu_torch._private.accelerators.gpu import granted_gpu_ids
    from ray_tpu_torch._vendor import cloudpickle

    ids = granted_gpu_ids()
    if len(ids) < 2:
        return None
    world = len(ids)
    tmp = tempfile.mkdtemp(prefix="rt_tp_")
    init_method = f"file://{os.path.join(tmp, 'rdzv')}"
    backend = _backend()
    blob = cloudpickle.dumps({"loader": model_loader,
                              "engine": engine_kwargs})
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env_path = os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    procs = []
    for rank in range(1, world):
        spec = os.path.join(tmp, f"rank{rank}.spec")
        with open(spec, "wb") as f:
            pickle.dump({"rank": rank, "world": world,
                         "init_method": init_method, "backend": backend,
                         "parent": os.getpid(), "sys_path": list(sys.path),
                         "blob": blob}, f)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=ids[rank],
                   PYTHONPATH=env_path)
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.serve.tp", spec],
                env=env, stdout=subprocess.DEVNULL, stderr=err))
    followers = Followers(procs, tmp)
    try:
        _join(0, world, init_method, backend)
    except BaseException:
        for p in procs:
            p.kill()
        followers.stop(timeout=5)
        raise
    return followers


def _exit_with_parent(parent: int) -> None:
    """End this follower when the replica's process is gone (it was
    killed and can send no STOP)."""
    while True:
        if os.getppid() != parent:
            os._exit(3)
        time.sleep(0.5)


def _main(spec_path: str) -> None:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    for p in reversed(spec["sys_path"]):
        if p not in sys.path:
            sys.path.insert(0, p)
    threading.Thread(target=_exit_with_parent, args=(spec["parent"],),
                     daemon=True).start()
    from ray_tpu_torch._vendor import cloudpickle

    job = cloudpickle.loads(spec["blob"])
    _join(spec["rank"], spec["world"], spec["init_method"], spec["backend"])
    import torch.distributed as dist

    from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

    loaded = job["loader"]()
    if len(loaded) != 3:
        raise ValueError("a tensor-parallel replica's model_loader must "
                         "return (params, cfg, mesh) in every rank")
    params, cfg, mesh = loaded
    engine = ContinuousBatchingEngine(params, cfg, mesh=mesh, **job["engine"])
    engine.wait()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1])
