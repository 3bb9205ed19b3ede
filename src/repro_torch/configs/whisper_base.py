"""whisper-base [audio]: enc-dec, conv/mel frontend stubbed to frame
embeddings. 6L decoder (+6L encoder), d_model=512, 8H (kv=8), d_ff=2048,
vocab=51865. [arXiv:2212.04356]

Adaptation notes: rotary positions replace Whisper's learned/sinusoidal
absolute embeddings (DESIGN.md §8); GeLU MLPs and pre-LayerNorm match the
original. long_500k is SKIPPED for this arch (enc-dec, 448-token decoder
context by design — no faithful sub-quadratic decoder variant).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, register

FULL = ModelConfig(
    name="whisper-base", family="encdec", cite="arXiv:2212.04356",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51865, activation="gelu", norm="layernorm",
    tie_embeddings=True, rope_theta=1e4,
    encoder=EncoderConfig(kind="audio", n_layers=6, n_ctx=1500),
    attn_chunk=512, microbatch=1, optimizer="adamw")

REDUCED = FULL.replace(
    name="whisper-base", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    encoder=EncoderConfig(kind="audio", n_layers=2, n_ctx=8),
    attn_chunk=64, remat=False)

register(FULL, REDUCED)
