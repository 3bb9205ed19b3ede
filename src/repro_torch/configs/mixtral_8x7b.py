"""mixtral-8x7b [moe]: 32L, d_model=4096, 32H (GQA kv=8), 8 experts top-2
(d_expert=14336), native sliding-window attention (W=4096), vocab=32000.
[arXiv:2401.04088]

With E=8 < tp=16 the EP all_to_all path is degenerate, so Mixtral uses
expert tensor parallelism: per-data-shard local dispatch with each
expert's FFN hidden dim sharded over ``model`` like a dense FFN, one bf16
activation psum per layer (§Perf mixtral iteration 1), plus Megatron-style
sequence parallelism on the residual stream (iteration 2).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe", cite="arXiv:2401.04088",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, sliding_window=4096, rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336,
                  capacity_factor=1.25, impl="dense"),
    fsdp=True, seq_shard=True, microbatch=4, optimizer="adamw")

REDUCED = FULL.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512, sliding_window=64,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128,
                  capacity_factor=1.5, impl="dense"),
    fsdp=False, microbatch=1, attn_chunk=32, remat=False)

register(FULL, REDUCED)
