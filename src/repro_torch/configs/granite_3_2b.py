"""granite-3-2b [dense]: 40L, d_model=2048, 32H (GQA kv=8), d_ff=8192,
vocab=49155, tied embeddings. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="granite-3-2b", family="dense",
    cite="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=49155, tie_embeddings=True, rope_theta=1e4,
    microbatch=2, optimizer="adamw")

REDUCED = FULL.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512, microbatch=1, attn_chunk=64, remat=False)

register(FULL, REDUCED)
