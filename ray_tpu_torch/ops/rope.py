"""Rotary position embeddings (RoPE). Counterpart of ray_tpu/ops/rope.py.

Plain PyTorch: the JAX package has no kernel here either.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ray_tpu_torch._device import resolve_device


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     dtype: torch.dtype = torch.float32, device=None):
    """Precompute cos/sin tables: [max_seq, head_dim//2]."""
    device = resolve_device(device)
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate pairs of features. x: [batch, seq, heads, head_dim].

    positions: optional [batch, seq] global positions; defaults to
    arange(seq). Positions past the table are clamped to its last row, as
    a JAX gather clamps them (a CUDA gather would assert instead).
    """
    b, l, h, d = x.shape
    if positions is None:
        cos_p = cos[:l][None, :, None, :]
        sin_p = sin[:l][None, :, None, :]
    else:
        pos = positions.clamp(max=cos.shape[0] - 1)
        cos_p = cos[pos][:, :, None, :]
        sin_p = sin[pos][:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    # bf16 x times f32 tables promotes to f32, then casts back (as jnp).
    rot1 = x1 * cos_p - x2 * sin_p
    rot2 = x2 * cos_p + x1 * sin_p
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=16)
def rope_tables(head_dim: int, max_seq: int, theta: float,
                device: torch.device):
    """rope_frequencies in f32, computed once per (head_dim, max_seq, theta,
    device). JAX folded the tables into each compiled step; eager code
    would otherwise rebuild them on every engine step."""
    return rope_frequencies(head_dim, max_seq, theta, device=device)
