"""The yardstick's arithmetic against hand-worked values, and the
configurations' sizes against their published parameter counts."""

import json
import math
from pathlib import Path

import pytest

from portbench import yardstick as y

HERE = Path(__file__).resolve().parents[1]


def dims(name):
    with open(HERE / "configs" / f"{name}.json") as f:
        return y.model_dims(json.load(f))


def test_mistral_7b_parameter_count():
    assert y.param_count(dims("mistral-7b")) == 7_248_023_552


def test_mixtral_4_layers_held_and_active():
    d = dims("mixtral-8x7b")
    assert d["layers"] == 4
    assert y.param_count(d) == 6_067_228_672
    assert y.active_params(d) == 1_839_370_240


def test_causal_pairs():
    assert y.causal_pairs(1024, 1024) == 1024 * 1025 // 2 == 524_800
    assert y.causal_pairs(3, 2) == 1 + 2 + 2


def test_flash_cost_at_the_train_shape():
    cost = y.flash_cost(4, 1024, 32, 8, 128)
    q = 4 * 1024 * 32 * 128 * 2            # bf16 queries [b, L, h, d]
    kv = 4 * 1024 * 8 * 128 * 2            # bf16 keys [b, L, kvh, d]
    s = 4 * 32 * 1024 * 4                  # one f32 [b, h, L] statistic
    pairs = 524_800
    assert cost["flash_fwd"] == (2 * 2 * 4 * 32 * 128 * pairs,
                                 2 * q + 2 * kv + s)
    assert cost["flash_bwd_dq"] == (2 * 3 * 4 * 32 * 128 * pairs,
                                     3 * q + 2 * kv + 2 * s)
    assert cost["flash_bwd_dkv"] == (2 * 4 * 4 * 32 * 128 * pairs,
                                      2 * q + 4 * kv + 2 * s)
    assert cost["flash_fwd"][0] == 34_393_292_800
    # The forward is bound by its products (34.8 us), not its bytes (25.2).
    assert y.roofline_s(*cost["flash_fwd"]) == pytest.approx(34.776e-6,
                                                             rel=1e-4)


def test_rmsnorm_bytes():
    assert y.rmsnorm_fwd_bytes(4096, 4096) == (2 * 4096 * 4096 + 4096) * 2
    assert y.rmsnorm_bwd_bytes(4096, 4096) == (3 * 4096 * 4096 + 2 * 4096) * 2


def test_roofline_picks_the_larger_bound():
    assert y.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert y.roofline_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_train_step_flops_for_mixtral():
    d = dims("mixtral-8x7b")
    n = 1_839_370_240 - 32000 * 4096       # active, without the embedding
    attn = 3 * 4 * (4 * 4 * 32 * 128 * 524_800)
    assert y.train_step_flops(d, 4, 1024) == 6 * n * 4096 + attn


def test_percentile_is_nearest_rank_and_counts_misses():
    xs = list(range(1, 101))
    assert y.percentile(xs, 90) == 90
    assert y.percentile(xs, 95) == 95
    assert y.percentile([1.0, math.inf], 90) == math.inf


def test_kernel_groups():
    assert y.kernel_group("void flash_bwd_dkv_mma_kernel<128>") == "flash_dkv"
    assert y.kernel_group("flash_bwd_dq_mma_kernel") == "flash_dq"
    assert y.kernel_group("rmsnorm_fwd_kernel<bf16, 2>") == "rmsnorm_fwd"
    assert y.kernel_group("sm90_xmma_gemm_bf16") == "matmul"
    assert y.kernel_group("multi_tensor_apply_kernel") == "optimizer"
    assert y.kernel_group("elementwise_kernel") == "other"


def test_busy_intervals_merge_and_clip():
    k = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 5.0)]
    assert y.busy_intervals(k, 0.5, 4.0) == [(0.5, 2.0), (3.0, 4.0)]
