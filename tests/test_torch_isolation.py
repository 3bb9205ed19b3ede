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
from repro_torch.kernels.pdist_argmin import pdist_argmin  # noqa: E402
from repro_torch.kernels.solve_attach import solve_attach  # noqa: E402

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


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, 16, 4)).astype(np.float32))
    c = x[:, :3].contiguous()
    ops.assign_argmin(x, c)
    ops.kmeans_update(x, torch.zeros((2, 16), dtype=torch.int32), 3)
    ops.solve_attach(x, c, c[0], max_iters=5)
    assert ops.launch_counts() == {"pdist_argmin": 0, "kmeans_update": 0,
                                   "solve_attach": 0}
