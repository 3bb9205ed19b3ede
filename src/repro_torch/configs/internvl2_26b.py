"""internvl2-26b [vlm]: InternViT (stub) + InternLM2-20B backbone: 48L,
d_model=6144, 48H (GQA kv=8), d_ff=16384, vocab=92553. [arXiv:2404.16821]

The ViT/projector frontend is the allowed stub: input_specs provides 256
projected patch embeddings per image, prepended to the text tokens.
long_500k runs the sliding-window variant.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, register

FULL = ModelConfig(
    name="internvl2-26b", family="vlm", cite="arXiv:2404.16821",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553, rope_theta=1e6,
    encoder=EncoderConfig(kind="vit", n_prefix=256),
    fsdp=True, microbatch=4, optimizer="adamw")

REDUCED = FULL.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512, encoder=EncoderConfig(kind="vit", n_prefix=16),
    fsdp=False, microbatch=1, attn_chunk=64, remat=False)

register(FULL, REDUCED)
