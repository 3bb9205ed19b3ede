"""nemotron-4-15b [dense]: 32L, d_model=6144, 48H (GQA kv=8), d_ff=24576,
vocab=256000, squared-ReLU MLP, LayerNorm. [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="nemotron-4-15b", family="dense", cite="arXiv:2402.16819",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256000, activation="relu2", norm="layernorm",
    rope_theta=1e4, fsdp=True, microbatch=4, optimizer="adamw")

REDUCED = FULL.replace(
    n_layers=2, d_model=384, n_heads=6, n_kv_heads=2, d_ff=768,
    vocab_size=512, fsdp=False, microbatch=1, attn_chunk=64, remat=False)

register(FULL, REDUCED)
