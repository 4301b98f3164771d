"""Rotary position embeddings (RoPE). Counterpart of ray_tpu/ops/rope.py.

Plain PyTorch: the JAX package has no kernel here either.
"""

from __future__ import annotations

import functools
import math
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
    would otherwise rebuild them on every engine step. Built outside
    inference mode, so tables first made by serving can still be saved for
    a training step's backward."""
    with torch.inference_mode(False):
        return rope_frequencies(head_dim, max_seq, theta, device=device)


# -- YaRN (arXiv:2309.00071), as transformers' "yarn" rope type computes it --

def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention temperature: 0.1 * mscale * ln(scale) + 1, or 1 at
    a scale of 1 or less."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(rot_dim: int, theta: float, factor: float,
                  original_max: int, beta_fast: float = 32.0,
                  beta_slow: float = 1.0, device=None) -> torch.Tensor:
    """[rot_dim // 2] f64 inverse frequencies: extrapolated (theta's) for
    the dimensions that turn more than beta_fast times over the original
    context, interpolated (divided by factor) for those that turn fewer
    than beta_slow times, and a linear ramp between."""
    device = resolve_device(device)

    def correction_dim(rotations):
        return (rot_dim * math.log(original_max / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), rot_dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float64,
                                       device=device) / rot_dim)
    ramp = ((torch.arange(rot_dim // 2, dtype=torch.float64, device=device)
             - low) / (high - low)).clamp(0, 1)
    extrapolation = 1 - ramp
    return (1.0 / (factor * pos_freqs)) * (1 - extrapolation) + \
        (1.0 / pos_freqs) * extrapolation


@functools.lru_cache(maxsize=16)
def yarn_tables(rot_dim: int, length: int, theta: float, factor: float,
                original_max: int, beta_fast: float, beta_slow: float,
                mscale: float, mscale_all_dim: float, device: torch.device):
    """(cos, sin) [length, rot_dim // 2] f32 of YaRN's frequencies, times
    its attention factor (mscale's temperature over mscale_all_dim's:
    1 where the two are equal). The angles are taken in f64, so a
    position's table is exact to f32 however far it lies. Built once per
    argument set, outside inference mode, as rope_tables."""
    with torch.inference_mode(False):
        inv = yarn_inv_freq(rot_dim, theta, factor, original_max, beta_fast,
                            beta_slow, device)
        freqs = torch.outer(torch.arange(length, dtype=torch.float64,
                                         device=device), inv)
        att = (yarn_mscale(factor, mscale) / yarn_mscale(factor,
                                                          mscale_all_dim)
               if mscale and mscale_all_dim else yarn_mscale(factor))
        return ((torch.cos(freqs) * att).float(),
                (torch.sin(freqs) * att).float())


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """Features (x0, x1, x2, x3, ...) as (x0, x2, ..., x1, x3, ...): the
    interleaved pairs of a checkpoint whose rope rotates (2i, 2i + 1),
    put where apply_rope's rotate-half pairs (i, i + d/2) are."""
    return x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
