"""deepseek-v3-671b [moe]: 61L, d_model=7168, 128H, MLA (latent kv),
MoE 1 shared + 256 routed top-8 experts (d_expert=2048), first 3 layers
dense (d_ff=18432), vocab=129280, MTP head. [arXiv:2412.19437]

Distribution: MLA absorbed-form decode caches 576 B/token; experts are
EP-sharded over (data x model) jointly — every expert chip-resident, its
gradient never crossing a device boundary — with hierarchical per-axis
all_to_all dispatch (§Perf deepseek iterations 3-4; ep="tp" is the
recorded baseline). Adafactor (factored 2nd moment) + FSDP over
(pod, data) for the non-expert parameters is what fits 671B on
16 GB/chip (DESIGN.md §6). long_500k runs with the MLA compressed cache.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe", cite="arXiv:2412.19437",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280, attn="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  capacity_factor=1.25, impl="alltoall", ep="2d"),
    n_dense_layers=3, mtp=True, rope_theta=1e4,
    fsdp=True, microbatch=8, optimizer="adafactor")

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512,
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16,
                  qk_rope_dim=8, v_dim=16),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, n_shared=1,
                  capacity_factor=1.5, impl="dense"),
    n_dense_layers=1, mtp=True, fsdp=False, microbatch=1, attn_chunk=64,
    remat=False)

register(FULL, REDUCED)
