"""The JAX package's side of tests/test_torch_ep.py, run as a script in
a process of its own, which forces 8 host devices before it imports jax
(tests/test_distributed.py's MOE_CHILD does the same):

    python tests/_torch_ep_jax.py <cases.pkl> <out.pkl>

``cases.pkl`` (written by the test) holds the MoE layer cases (mesh
shape, MoEConfig fields, parameters and input as numpy) and the model
cases (config name, MoEConfig fields, mesh shape, the parameters'
leaves in ``jax.tree_util`` order, prompts). For each layer case it
records the sharded ``apply_moe``'s output, aux loss and the path it
took (traced: ``_dense_shard_map``, ``_alltoall_local`` or
``_local_moe``; the cases of one mesh are jitted as one program); for
each model case the jitted sharded prefill's logits.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs.base import MoEConfig, get_config  # noqa: E402
from repro.launch.serve import make_prefill  # noqa: E402
from repro.launch.sharding import make_ctx  # noqa: E402
from repro.models import moe as MoE  # noqa: E402
from repro.models.model import build_model  # noqa: E402


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))


PATHS = []


def _recorded(name, fn):
    def wrapped(*args, **kw):
        PATHS.append(name)
        return fn(*args, **kw)
    return wrapped


MoE._dense_shard_map = _recorded("etp", MoE._dense_shard_map)
MoE._alltoall_local = _recorded("alltoall", MoE._alltoall_local)
MoE._local_moe = _recorded("local", MoE._local_moe)


def layer_cases(cases):
    """The layer cases of one mesh shape, jitted as one program (one
    compile a mesh): each case's output, aux loss and traced path."""
    mesh = mesh_of(cases[0]["mesh"])
    ctx = make_ctx(mesh)
    cfgs = [type("C", (), {"moe": MoEConfig(**c["moe"])})() for c in cases]
    paths = []

    def run(ps, xs):
        out = []
        for cfg, p, x in zip(cfgs, ps, xs):
            del PATHS[:]
            out.append(MoE.apply_moe(p, x, cfg, ctx))
            paths.append(PATHS[0])
        return out
    ps = [{k: jnp.asarray(v) for k, v in c["params"].items()} for c in cases]
    xs = [jnp.asarray(c["x"]) for c in cases]
    with mesh:
        out = jax.jit(run)(ps, xs)
    return [{"y": np.asarray(y), "aux": float(aux), "path": path}
            for (y, aux), path in zip(out, paths)]


def model_case(case):
    cfg = get_config(case["name"], reduced=True).replace(dtype="float32")
    cfg = cfg.replace(moe=MoEConfig(**case["moe"]))
    jm = build_model(cfg)
    key = jax.random.PRNGKey(0)
    treedef = jax.tree_util.tree_structure(jax.eval_shape(jm.init, key))
    jp = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in case["leaves"]])
    mesh = mesh_of(case["mesh"])
    jm.decode_room = 1
    with mesh:
        logits, _ = jax.jit(make_prefill(jm, make_ctx(mesh)))(
            jp, {"tokens": jnp.asarray(case["tokens"])})
    return {"logits": np.asarray(logits)}


def main(src, dst):
    with open(src, "rb") as f:
        cases = pickle.load(f)
    by_mesh = {}
    for key, case in cases["layers"].items():
        by_mesh.setdefault(case["mesh"], []).append(key)
    out = {"layers": {}, "models": {}}
    for keys in by_mesh.values():
        got = layer_cases([cases["layers"][k] for k in keys])
        out["layers"].update(zip(keys, got))
    for key, case in cases["models"].items():
        out["models"][key] = model_case(case)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
