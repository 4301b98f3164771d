"""Shared by the port's data tests (tests/test_torch_data*.py): both
runtimes in one process, and a pipeline run under each package whose two
results must be equal.

The JAX runtime (`ray_tpu`) and the port's (`ray_tpu_torch`) keep their
state, stores and workers apart, so one test process can hold both.
Pipelines are functions of `(rt, rd)`, the package and its `data`
module; they return plain values (numpy arrays become dtype and list) so
that the comparison is exact.
"""

import contextlib

import numpy as np

import ray_tpu
import ray_tpu.data as jax_data
import ray_tpu_torch
import ray_tpu_torch.data as torch_data

PACKAGES = ((ray_tpu, jax_data), (ray_tpu_torch, torch_data))


@contextlib.contextmanager
def both_runtimes(**kwargs):
    """ray_tpu.init and ray_tpu_torch.init with the same arguments."""
    ray_tpu.init(**kwargs)
    try:
        ray_tpu_torch.init(**kwargs)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
    finally:
        ray_tpu.shutdown()


def plain(x):
    """Numpy arrays and scalars as (dtype, values); containers recurse."""
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def same(pipeline):
    """Run `pipeline(rt, rd)` under the JAX package, then the port; assert
    the two results are equal and return the port's."""
    ref, out = (plain(pipeline(rt, rd)) for rt, rd in PACKAGES)
    assert out == ref, (out, ref)
    return out
