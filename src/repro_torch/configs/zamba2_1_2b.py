"""zamba2-1.2b [hybrid]: 38 Mamba2 blocks (ssm_state=64) + a shared
(weight-tied) attention+MLP block applied every 6 blocks, d_model=2048,
32H (kv=32), d_ff=8192, vocab=32000. [arXiv:2411.15242]

O(1) SSM state + short shared-attn caches => long_500k runs natively.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid", cite="arXiv:2411.15242",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2),
    hybrid_attn_every=6, ssm_chunk=32, rope_theta=1e4,
    microbatch=2, optimizer="adamw")

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512,
    ssm=SSMConfig(kind="mamba2", state_dim=16, head_dim=32, expand=2),
    hybrid_attn_every=2, ssm_chunk=16, microbatch=1, attn_chunk=64,
    remat=False)

register(FULL, REDUCED)
