"""Model configuration dataclasses and the architecture registry
(counterpart of ``repro/configs/base.py``, without its input shapes).

Every architecture has one module in this package defining its exact
full-size config (cited) plus a REDUCED variant (<= 2 layers,
d_model <= 512, <= 4 experts). The routed serving heads
(``models/heads.py``) read the REDUCED variant's activation, FFN ratio
and head counts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    impl: str = "alltoall"        # "alltoall" | "dense" (small-E einsum)
    ep: str = "tp"                # expert-parallel axes: "tp" (model axis
                                  # only — baseline) | "2d" (data x model:
                                  # experts chip-resident, expert grads
                                  # never cross devices; §Perf iter 3)
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"          # "mamba2" | "rwkv6"
    state_dim: int = 64           # N (mamba) / head_dim (rwkv state is dh x dh)
    head_dim: int = 64
    expand: int = 2               # mamba inner expansion
    conv_width: int = 4
    decay_lora: int = 64          # rwkv6 data-dependent decay LoRA rank


@dataclass(frozen=True)
class EncoderConfig:
    """Stub-frontend encoder (audio frames / ViT patches arrive as
    precomputed embeddings — the one allowed stub)."""
    kind: str = "audio"           # "audio" (whisper self-attn stack) | "vit"
    n_layers: int = 0             # 0 => embeddings consumed directly
    n_ctx: int = 1500             # encoder memory length at decode
    n_prefix: int = 256           # vlm: patch tokens prepended


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    cite: str = ""
    head_dim: Optional[int] = None
    attn: str = "gqa"             # gqa | mla | none
    activation: str = "swiglu"    # swiglu | gelu | relu2
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1e6
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0       # leading non-MoE layers (deepseek: 3)
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0    # zamba2: shared attn block every N blocks
    encoder: Optional[EncoderConfig] = None
    mtp: bool = False             # deepseek multi-token-prediction head
    # runtime / distribution knobs
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024
    ssm_chunk: int = 64
    fsdp: bool = False
    seq_shard: bool = False       # Megatron-style sequence parallelism:
                                  # residual stream sharded (dp, model, -)
                                  # between blocks (§Perf mixtral iter 2)
    microbatch: int = 1           # grad-accumulation factor
    optimizer: str = "adamw"      # adamw | adafactor | sgd

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_sliding_window(self, window: int = 4096) -> "ModelConfig":
        return self.replace(sliding_window=window)


_REGISTRY: dict = {}


def register(cfg: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = (cfg, reduced)
    return cfg


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    full, red = _REGISTRY[name]
    return red if reduced else full


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    import importlib
    for mod in ("whisper_base", "mistral_nemo_12b", "granite_3_2b",
                "deepseek_v3_671b", "mixtral_8x7b", "qwen1_5_0_5b",
                "nemotron_4_15b", "internvl2_26b", "rwkv6_7b",
                "zamba2_1_2b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
