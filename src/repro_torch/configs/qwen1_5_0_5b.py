"""qwen1.5-0.5b [dense]: 24L, d_model=1024, 16H (kv=16), d_ff=2816,
vocab=151936, QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen1.5-0.5b", family="dense", cite="hf:Qwen/Qwen1.5-0.5B",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab_size=151936, qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    microbatch=1, optimizer="adamw")

REDUCED = FULL.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512, attn_chunk=64, remat=False)

register(FULL, REDUCED)
