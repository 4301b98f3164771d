"""Named model configurations. Counterpart of ray_tpu/models/configs.py:
every entry, with the same fields (dtype as a torch dtype).

Llama-2 family dimensions follow the published architecture (Touvron et
al., arXiv:2307.09288); tiny/test configs keep the same structure at toy
scale for CPU tests.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.models.transformer import TransformerConfig

# -- test-scale ------------------------------------------------------------

tiny = TransformerConfig(
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    max_seq=128,
    dtype=torch.float32,
    remat=False,
)

tiny_gqa = TransformerConfig(
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    max_seq=128,
    dtype=torch.float32,
    remat=False,
)

tiny_moe = TransformerConfig(
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    max_seq=128,
    dtype=torch.float32,
    num_experts=4,
    experts_per_token=2,
    remat=False,
)

# -- benchmark-scale ---------------------------------------------------------

llama2_1b = TransformerConfig(
    vocab_size=32000,
    d_model=2048,
    n_layers=16,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5504,
    max_seq=2048,
)

# -- production-scale ------------------------------------------------------

llama2_7b = TransformerConfig(
    vocab_size=32000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    max_seq=4096,
)

llama2_13b = TransformerConfig(
    vocab_size=32000,
    d_model=5120,
    n_layers=40,
    n_heads=40,
    n_kv_heads=40,
    d_ff=13824,
    max_seq=4096,
)

llama2_70b = TransformerConfig(
    vocab_size=32000,
    d_model=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,  # GQA
    d_ff=28672,
    max_seq=4096,
)

llama3_8b = TransformerConfig(
    vocab_size=128256,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    max_seq=8192,
    rope_theta=500000.0,
)

tiny_gemma = TransformerConfig(
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=1,
    d_ff=256,
    max_seq=128,
    dtype=torch.float32,
    remat=False,
    activation="gelu",
    final_logit_softcap=30.0,
    tie_embeddings=True,
    scale_embeddings=True,
)

# Gemma-2B architecture (arXiv:2403.08295: GeGLU MLP, MQA, tied
# embeddings, sqrt(d) embedding scaling, final logit softcap).
gemma_2b = TransformerConfig(
    vocab_size=256128,
    d_model=2048,
    n_layers=18,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    max_seq=8192,
    activation="gelu",
    final_logit_softcap=30.0,
    tie_embeddings=True,
    scale_embeddings=True,
)

mixtral_8x7b = TransformerConfig(
    vocab_size=32000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    max_seq=4096,
    num_experts=8,
    experts_per_token=2,
)

tiny_qwen = TransformerConfig(
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    max_seq=128,
    dtype=torch.float32,
    remat=False,
    qk_norm=True,
    custom_head_dim=32,  # wider than d_model/n_heads, the Qwen3 shape
)

# Qwen3-4B architecture (arXiv:2505.09388): GQA with fixed 128-wide
# heads, per-head-dim QK-norm instead of QKV bias, SwiGLU, 1M rope theta.
qwen3_4b = TransformerConfig(
    vocab_size=151936,
    d_model=2560,
    n_layers=36,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    max_seq=32768,
    rope_theta=1000000.0,
    qk_norm=True,
    custom_head_dim=128,
    tie_embeddings=True,
)

# Mistral-Small-4-119B-2603's text decoder (its config.json: DeepSeek-V3's
# layer, arXiv:2412.19437): multi-head latent attention with YaRN rope,
# 128 experts of width 2048, top-4 by sigmoid scores with a correction
# bias, renormalised gates, and one shared expert in every layer.
mistral_small_4 = TransformerConfig(
    vocab_size=131072,
    d_model=4096,
    n_layers=36,
    n_heads=32,
    n_kv_heads=32,
    d_ff=12288,
    max_seq=1048576,
    rope_theta=10000.0,
    norm_eps=1e-6,
    num_experts=128,
    experts_per_token=4,
    q_lora_rank=1024,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_type="yarn",
    rope_factor=128.0,
    rope_original_max=8192,
    beta_fast=32.0,
    beta_slow=1.0,
    mscale=1.0,
    mscale_all_dim=1.0,
    rope_interleave=True,
    llama4_scaling_beta=0.1,
    n_shared_experts=1,
    moe_d_ff=2048,
    router="sigmoid_bias",
    norm_topk_prob=True,
    routed_scaling_factor=1.0,
)

# mistral_small_4's layer at toy widths: the YaRN ramp and the llama-4
# query scale both act within 32 positions.
tiny_mla = TransformerConfig(
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    max_seq=128,
    dtype=torch.float32,
    remat=False,
    num_experts=8,
    experts_per_token=2,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=8,
    qk_rope_dim=8,
    v_head_dim=16,
    rope_type="yarn",
    rope_factor=4.0,
    rope_original_max=16,
    mscale=1.0,
    mscale_all_dim=1.0,
    rope_interleave=True,
    llama4_scaling_beta=0.1,
    n_shared_experts=1,
    moe_d_ff=32,
    router="sigmoid_bias",
    norm_topk_prob=True,
)

NAMED_CONFIGS = {
    "tiny": tiny,
    "tiny_gqa": tiny_gqa,
    "tiny_moe": tiny_moe,
    "llama2-1b": llama2_1b,
    "llama2-7b": llama2_7b,
    "llama2-13b": llama2_13b,
    "llama2-70b": llama2_70b,
    "llama3-8b": llama3_8b,
    "tiny_gemma": tiny_gemma,
    "gemma-2b": gemma_2b,
    "mixtral-8x7b": mixtral_8x7b,
    "tiny_qwen": tiny_qwen,
    "qwen3-4b": qwen3_4b,
    "mistral-small-4": mistral_small_4,
    "tiny_mla": tiny_mla,
}


def get_config(name: str) -> TransformerConfig:
    if name not in NAMED_CONFIGS:
        raise KeyError(f"unknown model config {name!r}; have {list(NAMED_CONFIGS)}")
    return NAMED_CONFIGS[name]
