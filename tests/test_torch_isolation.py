"""The port stands alone and never runs on the CPU unasked.

No module of src/repro_torch (and not chip_smoke.py) imports jax or the
JAX package; without a card a Session that was not given device="cpu"
refuses to start; every kernel wrapper refuses a CPU tensor; and a CPU
call of the dispatch launches no kernel.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fed.api import FederationPlan, Session  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.kmeans_update import kmeans_update  # noqa: E402
from repro_torch.kernels.moe_combine import moe_combine  # noqa: E402
from repro_torch.kernels.moe_combine_bwd import moe_combine_bwd  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_dispatch  # noqa: E402
from repro_torch.kernels.moe_dispatch_bwd import (  # noqa: E402
    moe_dispatch_bwd)
from repro_torch.kernels.pdist_argmin import pdist_argmin  # noqa: E402
from repro_torch.kernels.solve_attach import solve_attach  # noqa: E402
from repro_torch.kernels.swa_decode import (swa_combine,  # noqa: E402
                                          swa_decode_attention,
                                          swa_decode_partial)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        for name in _imports(path):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_session_without_card_refuses_to_start(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(FederationPlan(k=4, k_prime=2, d=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(FederationPlan(k=4, k_prime=2, d=3, device="cpu"),
                device="cuda")
    assert Session(FederationPlan(k=4, k_prime=2, d=3, device="cpu")
                   ).device.type == "cpu"
    assert Session(FederationPlan(k=4, k_prime=2, d=3),
                   device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 5, 3))
    c = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pdist_argmin(x, c)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmeans_update(x, torch.zeros((2, 5), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        solve_attach(x, c, torch.zeros((6, 3)),
                     torch.ones((2, 4), dtype=torch.bool),
                     torch.ones((2, 5), dtype=torch.bool), max_iters=3)
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_dispatch(x[0], idx, torch.ones((4,), dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_combine(x[0], idx, torch.ones((4,)), 1)
    kv = torch.zeros((2, 6, 1, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        swa_decode_attention(x[:, :2], kv, kv, torch.zeros((2, 6)), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swa_decode_partial(x[:, :2], kv, kv, torch.zeros((2, 6)), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swa_combine(torch.zeros((4, 2, 5)), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_combine_bwd(torch.zeros((4, 3)), x[0], idx,
                        torch.ones((5,), dtype=torch.bool), torch.ones((4,)),
                        1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_dispatch_bwd(x[0], idx, torch.ones((4,), dtype=torch.bool), 1)


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, 16, 4)).astype(np.float32))
    c = x[:, :3].contiguous()
    ops.assign_argmin(x, c)
    ops.kmeans_update(x, torch.zeros((2, 16), dtype=torch.int32), 3)
    ops.solve_attach(x, c, c[0], max_iters=5)
    idx = torch.zeros((4,), dtype=torch.int32)
    ops.moe_dispatch(x[0], idx, torch.ones((4,), dtype=torch.bool))
    ops.moe_combine(x[0], idx, torch.ones((4,)), 1)
    kv = torch.zeros((2, 6, 1, 4))
    ops.swa_decode_attention(x[:, :2], kv, kv, torch.zeros((2, 6)), 0.5)
    part = ops.swa_decode_partial(x[:, :2], kv, kv, torch.zeros((2, 6)),
                                  0.5, ranks=2)
    ops.swa_combine(torch.cat([part, part], dim=1), torch.float32)
    # The MoE layer's dispatch and combine with their gradients.
    xg = x[0, :4].clone().requires_grad_(True)
    keep = torch.ones((4,), dtype=torch.bool)
    own = torch.arange(4, dtype=torch.int32)
    buf = ops.moe_dispatch(xg, own, keep, slot=own, keep=keep, top_k=1)
    y = ops.moe_combine(buf, own, torch.ones((4,)), 1, src_entry=own,
                        valid=keep)
    y.sum().backward()
    assert xg.grad is not None
    assert ops.launch_counts() == {"pdist_argmin": 0, "kmeans_update": 0,
                                   "solve_attach": 0, "moe_dispatch": 0,
                                   "moe_combine": 0, "swa_decode": 0,
                                   "moe_combine_bwd": 0,
                                   "moe_dispatch_bwd": 0,
                                   "swa_decode_partial": 0,
                                   "swa_combine": 0}


def test_serve_path_imports_no_jax():
    """Importing the LM serve path loads neither jax nor the JAX
    package (checked in a fresh interpreter), and init_params refuses
    to start without a card unless asked for the CPU."""
    import os
    import subprocess
    import sys
    code = ("import sys; import repro_torch.models.model, "
            "repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_init_params_without_card_refuses_to_start(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import init_params
    from repro_torch.models.model import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("mixtral-8x7b", reduced=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(model)
    p = init_params(model, device="cpu")
    assert p["embed"].device.type == "cpu"
