"""mistral-nemo-12b [dense]: 40L, d_model=5120, 32H (GQA kv=8),
head_dim=128, d_ff=14336, vocab=131072, 128k context (rope theta 1e6).
[hf:mistralai/Mistral-Nemo-Base-2407]

long_500k runs the sliding-window variant (cfg.with_sliding_window(4096))
— see DESIGN.md §5.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    cite="hf:mistralai/Mistral-Nemo-Base-2407",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1e6,
    fsdp=True, microbatch=4, optimizer="adamw")

REDUCED = FULL.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, fsdp=False, microbatch=1, attn_chunk=64,
    remat=False)

register(FULL, REDUCED)
