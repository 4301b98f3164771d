"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with the JAX
package's, on the same numpy inputs.

rmsnorm: the port's plain version against JAX `_rmsnorm_ref` and against
the Pallas kernel in interpret mode. f32 agrees within 1e-5 (both sum the
row in f32, in different orders); bf16 within 1 bf16 ulp (the same f32
result can round to either neighbour when the sums differ in their last
bits). The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_gpu.py, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.rmsnorm import _rmsnorm_ref, rmsnorm as jax_rmsnorm
from ray_tpu.ops.rope import apply_rope as jax_apply_rope
from ray_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from ray_tpu_torch.ops import apply_rope, rmsnorm, rope_frequencies
from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain, rmsnorm_cuda

torch.set_num_threads(1)

EPS = 1e-6


def _bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units in the last
    place (adjacent representable values are 1 apart)."""
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _to_torch(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(arr).to(dtype)


def _jax_to_torch(out) -> torch.Tensor:
    """A JAX array (f32 or bf16) as a torch tensor, bits preserved."""
    arr = np.array(out)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rows", [1, 7, 300])
def test_rmsnorm_plain_matches_jax(rows, d, dtype):
    rng = np.random.default_rng(rows * 1000 + d)
    x = rng.standard_normal((rows, d)).astype(np.float32) * 3.0
    w = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    xt, wt = _to_torch(x, tdt), _to_torch(w, tdt)
    got = _rmsnorm_plain(xt, wt, EPS)
    assert got.dtype == tdt and got.shape == (rows, d)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    ref = _jax_to_torch(_rmsnorm_ref(xj, wj, EPS))
    # rows=300 crosses the kernel's 256-row block with a ragged tail.
    pallas = _jax_to_torch(jax_rmsnorm(xj, wj, EPS, use_pallas=True,
                                       interpret=True))
    for want in (ref, pallas):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)
        else:
            assert _bf16_ulp_diff(got, want) <= 1


def test_rmsnorm_dispatch_cpu_uses_plain_and_counts_nothing():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    before = rmsnorm_cuda.launches
    out = rmsnorm(x, w, EPS)
    assert torch.equal(out, _rmsnorm_plain(x, w, EPS))
    assert rmsnorm_cuda.launches == before


def test_rmsnorm_refuses_other_devices():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError):
        rmsnorm(x, torch.empty(64, device="meta"))
    with pytest.raises(ValueError):
        rmsnorm_cuda(torch.ones(2, 64), torch.ones(64))


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_matches_jax(with_positions):
    b, l, h, d, max_seq = 2, 9, 3, 32, 40
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, l, h, d)).astype(np.float32)
    pos = rng.integers(0, max_seq, size=(b, l)).astype(np.int32)
    cos, sin = rope_frequencies(d, max_seq, 10000.0, device="cpu")
    jcos, jsin = jax_rope_frequencies(d, max_seq, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    tpos = torch.from_numpy(pos).long() if with_positions else None
    jpos = jnp.asarray(pos) if with_positions else None
    got = apply_rope(torch.from_numpy(x), cos, sin, tpos)
    want = jax_apply_rope(jnp.asarray(x), jcos, jsin, jpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_apply_rope_clamps_positions_like_jax():
    """A JAX gather clamps an index past the table; the port clamps it
    explicitly (a CUDA gather would assert)."""
    d, max_seq = 16, 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2, 1, d)).astype(np.float32)
    pos = np.array([[7, 12]], dtype=np.int32)
    cos, sin = rope_frequencies(d, max_seq, device="cpu")
    jcos, jsin = jax_rope_frequencies(d, max_seq)
    got = apply_rope(torch.from_numpy(x), cos, sin,
                     torch.from_numpy(pos).long())
    want = jax_apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
