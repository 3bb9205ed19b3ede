"""Roofline terms of one step on the card (counterpart of
``repro/launch/roofline.py``).

Terms per (arch, shape, mesh), in seconds a step, for one rank:

  compute    = effective flops        / peak_flops
  memory     = bytes moved            / hbm_bw
  collective = collective bytes       / link_bw

The flops are :func:`launch.flops.effective_flops` of a dtype-aware count
(``launch/flops.py``); the bytes and the collective bytes come from the
dry run's counters on the meta device (``launch/dryrun.py``,
``launch/mesh.py``). There is no HLO to read: the reference's
``parse_collectives`` has its counterpart in the meta mesh's record of
every collective (``launch/mesh.MetaGroup``).

Hardware constants come from named profiles (``HW_PROFILES``): pass
``hw=`` to :func:`roofline_terms`, a profile name to :func:`hw_profile`,
or set ``REPRO_HW_PROFILE``. The one profile is the card the port runs
on.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Union

# One H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet, SXM column,
# dense rates without sparsity, at the 700 W limit):
#   peak_flops      989 TFLOP/s bf16 on the tensor cores;
#   peak_flops_f32  67 TFLOP/s f32 outside the tensor cores (the port
#                   runs its f32 products with TF32 off);
#   hbm_bw          3.35 TB/s of HBM3;
#   link_bw         NVLink 4: 900 GB/s a card in both directions, 450e9
#                   bytes a second in one.
HW_PROFILES: Dict[str, Dict[str, float]] = {
    "h100": {"peak_flops": 989e12, "peak_flops_f32": 67e12,
             "hbm_bw": 3.35e12, "link_bw": 450e9},
}
DEFAULT_HW_PROFILE = "h100"


def hw_profile(name: Optional[str] = None) -> Dict[str, float]:
    """Resolve a named hardware profile. ``None`` falls back to the
    ``REPRO_HW_PROFILE`` environment variable, then to ``h100``."""
    name = name or os.environ.get("REPRO_HW_PROFILE") or DEFAULT_HW_PROFILE
    if name not in HW_PROFILES:
        raise KeyError(
            f"unknown hardware profile {name!r}: accepted profiles are "
            f"{sorted(HW_PROFILES)}")
    return HW_PROFILES[name]


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float,
                   hw: Union[None, str, Dict[str, float]] = None
                   ) -> Dict[str, float]:
    """Roofline time terms. ``flops``: bf16-equivalent flops
    (:func:`launch.flops.effective_flops`); ``hw``: a profile name, a
    profile dict, or None (:func:`hw_profile`'s resolution)."""
    if not isinstance(hw, dict):
        hw = hw_profile(hw)
    compute = flops / hw["peak_flops"]
    memory = bytes_accessed / hw["hbm_bw"]
    collective = collective_bytes / hw["link_bw"]
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    terms["total_s"] = max(compute, memory, collective)
    return terms


def model_flops(cfg, shape, n_params: int, active_params: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training;
    2 N D for inference steps. D = tokens processed globally."""
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    n = active_params if cfg.moe else n_params
    return mult * n * tokens


def param_count(shapes) -> int:
    """Parameters of ``Model.param_shapes()``' {path: shape}."""
    return sum(math.prod(s) for s in shapes.values())


def active_param_count(cfg, shapes) -> int:
    """Active params = total minus the (1 - top_k/E) share of the
    routed expert weights: every ``w1`` / ``w2`` / ``w3`` leaf under a
    ``moe`` path (``models/moe.EXPERT_LEAVES``), the shared experts'
    included, as the reference counts them. ``shapes``:
    ``Model.param_shapes()``."""
    from repro_torch.models.moe import EXPERT_LEAVES
    total = param_count(shapes)
    if not cfg.moe:
        return total
    expert = sum(math.prod(s) for path, s in shapes.items()
                 if "moe" in path and path[-1] in EXPERT_LEAVES)
    frac = cfg.moe.top_k / cfg.moe.n_experts
    return total - int(expert * (1.0 - frac))
