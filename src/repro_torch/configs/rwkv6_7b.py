"""rwkv6-7b [ssm, attention-free]: RWKV-6 "Finch", 32L, d_model=4096
(64 heads x 64), d_ff=14336 channel-mix, vocab=65536, data-dependent
per-channel decay. [arXiv:2404.05892]

O(1) decode state => long_500k runs natively. §Arch-applicability: k-FED
never looks inside the model, so the paper's technique applies unchanged
(it clusters this arch's client embedding/update vectors like any other).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

FULL = ModelConfig(
    name="rwkv6-7b", family="ssm", cite="arXiv:2404.05892",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab_size=65536, attn="none",
    ssm=SSMConfig(kind="rwkv6", head_dim=64, decay_lora=64),
    ssm_chunk=32, fsdp=True, microbatch=2, optimizer="adamw")

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, ssm=SSMConfig(kind="rwkv6", head_dim=32, decay_lora=16),
    ssm_chunk=16, fsdp=False, microbatch=1, remat=False)

register(FULL, REDUCED)
