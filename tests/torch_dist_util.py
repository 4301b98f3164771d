"""Run a function on N gloo ranks of the CPU and collect what each returns.

    ranks = Ranks("tests/torch_dist_cases.py:parallel_cases", 4, tmp)
    ...                       # the JAX side, meanwhile
    results = ranks.get()

starts one interpreter per rank (this file as a script), joins them in a
gloo process group through a `file://` rendezvous under `tmp` (no port,
so pytest-xdist's workers cannot collide), calls `function(rank, world)`
in each; `get()` waits and returns each rank's result (a dict of numpy
arrays), rank order. A rank that fails fails `get()` with its standard
error.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Ranks:
    def __init__(self, target: str, world: int, tmp, timeout: float = 300):
        self.tmp = pathlib.Path(tmp)
        self.tmp.mkdir(parents=True, exist_ok=True)
        self.timeout = timeout
        self._results = None
        rdzv = self.tmp / "rdzv"
        rdzv.unlink(missing_ok=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        self.procs = []
        for rank in range(world):
            with open(self.tmp / f"rank{rank}.err", "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, target, str(rank), str(world),
                     str(rdzv), str(self.tmp / f"rank{rank}.pkl")],
                    cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                    stderr=err))

    def get(self) -> list:
        if self._results is None:
            self._results = self._wait()
        return self._results

    def _wait(self) -> list:
        try:
            for p in self.procs:
                p.wait(timeout=self.timeout)
        finally:
            self.stop()
        failed = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(
                f"ranks {failed} failed; rank {failed[0]}'s standard error:\n"
                + (self.tmp / f"rank{failed[0]}.err").read_text()[-6000:])
        results = []
        for rank in range(len(self.procs)):
            with open(self.tmp / f"rank{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _main(target: str, rank: int, world: int, rdzv: str, out: str) -> None:
    import importlib.util

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    path, fn = target.rsplit(":", 1)
    spec = importlib.util.spec_from_file_location("_rank_cases", ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)
    try:
        result = getattr(mod, fn)(rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
          sys.argv[5])
