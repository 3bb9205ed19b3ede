"""Rank workers of tests/test_torch_mesh.py.

``torch.multiprocessing.spawn`` pickles a worker by its qualified name,
so the workers live in this importable module, which imports neither
jax nor the JAX package: the parent test computes the JAX side and the
JAX draws, and hands them over as numpy arrays. Every rank joins a gloo
world through a FileStore, runs the cases it is given in order and
saves what it computed to ``rank<r>.pt`` for the parent to check.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.prng import GumbelSource


class TableGumbel(GumbelSource):
    """Precomputed draws: ``table[(id, n)]`` is id's (k', n) noise (the
    JAX package's, computed by the parent test)."""

    def __init__(self, table):
        super().__init__(0)
        self.table = table

    def draw(self, ids, k_prime, n, device):
        return torch.as_tensor(np.stack(
            [self.table[(int(i), int(n))][:k_prime] for i in ids]),
            device=device)


def spawn(world: int, tmp: str, cases: dict) -> list:
    """Run ``cases`` on every rank of a gloo world of ``world`` ranks;
    returns each rank's results, in rank order."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(world, tmp, cases), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str, cases: dict) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {name: CASES[name](spec) for name, spec in cases.items()}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _mesh(shape=None, names=("data",)):
    from repro_torch.utils.mesh import make_mesh
    return make_mesh(shape or (dist.get_world_size(),), names,
                     backend="gloo")


def _np(t):
    return t.detach().cpu().numpy()


def case_primitives(spec):
    """Gather order, psum bits and the sharded argmax tie."""
    from repro_torch.core.server import ShardedReducer
    rank = dist.get_rank()
    out = {}
    meshes = [((dist.get_world_size(),), ("data",))]
    if dist.get_world_size() == 4:
        meshes.append(((2, 2), ("data", "model")))
    for shape, names in meshes:
        mesh = _mesh(shape, names)
        axes_list = [names] + ([names[::-1], names[:1], names[1:]]
                               if len(names) > 1 else [])
        for axes in axes_list:
            g = mesh.group(axes)
            x = torch.tensor([[rank, mesh.index(axes)]], dtype=torch.int64)
            out[("gather", shape, axes)] = _np(g.all_gather(x))
            b = torch.tensor([[rank % 2 == 0, True]])
            out[("gather_bool", shape, axes)] = _np(g.all_gather(b))
    mesh = _mesh()
    g = mesh.group("data")
    x = torch.as_tensor(spec["psum"][rank])
    out["psum"] = _np(g.psum(x))
    out["pmax"] = _np(g.pmax(x))
    out["pmin"] = _np(g.pmin(x))
    many = g.all_gather_many([x, x > 0, None, x.to(torch.int32)])
    out["many"] = [None if t is None else _np(t) for t in many]
    # One row a rank, a 1-byte column before a 4-byte one.
    one = g.all_gather_many([x[:1] > 0, x[:1].to(torch.int32)])
    out["many_one_row"] = [_np(t) for t in one]
    vals = torch.as_tensor(spec["argmax"][rank])
    red = ShardedReducer(g, rank * vals.shape[0], vals.shape[0])
    out["argmax"] = int(red.argmax(vals))
    return out


def case_round(spec):
    """Session.run under replicated and sharded, every variant."""
    from repro_torch.fed.api import FederationPlan, Session
    mesh = _mesh()
    src = TableGumbel(spec["draws"])
    out = {}
    for topology in ("replicated", "sharded"):
        for pname, part in (("all", None), ("absent", spec["part"])):
            for weighted in (False, True):
                plan = FederationPlan(
                    k=spec["k"], k_prime=spec["kp"], d=spec["d"],
                    topology=topology, weight_by_core_counts=weighted,
                    device="cpu")
                r = Session(plan, mesh=mesh).run(src, spec["data"],
                                                 participation=part)
                out[(topology, pname, weighted)] = (_np(r.labels),
                                                    _np(r.tau_centers))
    return out


def case_fold(spec):
    """aggregate_incremental_sharded of this rank's rows of a batch."""
    from repro_torch.core import server as S
    mesh = _mesh()
    g = mesh.group("data")
    B = spec["ids"].shape[0]
    b = B // g.size
    lo, hi = g.index * b, (g.index + 1) * b
    st = S.init_state(spec["cap"], spec["kp"], spec["d"], device="cpu")
    st = S.aggregate_incremental_sharded(
        st, torch.as_tensor(spec["ids"][lo:hi]),
        torch.as_tensor(spec["centers"][lo:hi]),
        torch.as_tensor(spec["mask"][lo:hi]), g,
        weights=torch.as_tensor(spec["w"][lo:hi]))
    return [_np(t) for t in st]


def served_pair(sess, reqs, kvs):
    """PLANE_CHILD's traffic: every request, then the first four again."""
    out = sess.serve_versioned(reqs, kvs)
    out += sess.serve_versioned(reqs[:4], kvs[:4])
    return out


def _to(tree, device):
    """A round's NamedTuples of tensors, on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_to(t, device) for t in tree))


def case_plane(spec):
    """The sharded plane over an async refresh window, on the CPU or
    (``spec["device"]``) with every rank on one card."""
    from repro_torch.fed.api import FederationPlan, Session
    mesh = _mesh()
    dev = spec.get("device", "cpu")
    plan = FederationPlan(**spec["plan"], serve_axes=("data",), device=dev)
    draws = spec.get("draws")
    sess = Session.from_round(plan, _to(spec["round"], dev), mesh=mesh,
                              gumbel=TableGumbel(draws) if draws else None)
    served = served_pair(sess, spec["reqs"], spec["kvs"])
    st = sess.stats()
    return {"served": served, "state": [_np(t) for t in sess.service.state],
            "tau": _np(sess.tau_centers), "version": sess.tau_version,
            "serve_shards": st["serve_shards"],
            "serve_axes": st["serve_axes"]}


def serve_bursts(sess, datas, kvs, bursts):
    """One flush a burst; returns (served, the decision after each)."""
    served, decisions, at = [], [], 0
    for nb in bursts:
        served += sess.serve_versioned(datas[at:at + nb], kvs[at:at + nb])
        d = sess.service.autoscaler.decision
        decisions.append((d.shards, d.batch_size, tuple(d.ladder)))
        at += nb
    return served, decisions


def case_autoscale(spec):
    """Bursty traffic under latency autoscaling on the sharded plane."""
    from repro_torch.fed.api import FederationPlan, Session
    mesh = _mesh()
    plan = FederationPlan(**spec["plan"], serve_axes=("data",),
                          device="cpu")
    sess = Session.from_round(plan, spec["round"], mesh=mesh, seed=3)
    served, decisions = serve_bursts(sess, spec["reqs"], spec["kvs"],
                                     spec["bursts"])
    return {"served": served, "decisions": decisions,
            "state": [_np(t) for t in sess.service.state]}


def case_checkpoint(spec):
    """Serve, save (rank 0 writes), restore on every rank, serve on."""
    from repro_torch.fed.api import FederationPlan, Session
    mesh = _mesh()
    plan = FederationPlan(**spec["plan"], serve_axes=("data",),
                          device="cpu")
    reqs, kvs, cut = spec["reqs"], spec["kvs"], spec["cut"]
    live = Session.from_round(plan, spec["round"], mesh=mesh, seed=5)
    live.serve_versioned(reqs[:cut], kvs[:cut])
    path = live.save(spec["path"])
    restored = Session.restore(path, plan, mesh=mesh, device="cpu")
    return {"path": path,
            "live": live.serve_versioned(reqs[cut:], kvs[cut:]),
            "restored": restored.serve_versioned(reqs[cut:], kvs[cut:]),
            "state": [_np(t) for t in live.service.state],
            "restored_state": [_np(t) for t in restored.service.state]}


def served_routed(sess, reqs, kvs, chunk):
    """serve_predict in flushes of ``chunk``: each request's (labels,
    version, prediction, cluster, routed)."""
    out = []
    for lo in range(0, len(reqs), chunk):
        out += [(p.labels, p.tau_version, p.prediction, p.cluster, p.routed)
                for p in sess.serve_predict(reqs[lo:lo + chunk],
                                            kvs[lo:lo + chunk])]
    return out


def case_routed(spec):
    """The sharded routed step: serve_predict at the full grant (and,
    with ``bursts``, under autoscaling); the plan's small head_capacity
    makes queues overflow across shards."""
    from repro_torch.fed.api import FederationPlan, Session
    mesh = _mesh()
    plan = FederationPlan(**spec["plan"], serve_axes=("data",),
                          device="cpu")
    sess = Session.from_round(plan, spec["round"], mesh=mesh, seed=3)
    out = {"served": served_routed(sess, spec["reqs"], spec["kvs"],
                                   spec["chunk"]),
           "state": [_np(t) for t in sess.service.state],
           "heads": sess.stats()["heads"],
           "plane_compiles": sess.stats()["plane_compiles"]}
    if spec.get("bursts"):
        auto = Session.from_round(plan.with_options(autoscale="latency"),
                                  spec["round"], mesh=mesh, seed=3)
        served, decisions, at = [], [], 0
        for nb in spec["bursts"]:
            served += served_routed(auto, spec["reqs"][at:at + nb],
                                    spec["kvs"][at:at + nb], nb)
            d = auto.service.autoscaler.decision
            decisions.append((d.shards, d.batch_size))
            at += nb
        out["auto"] = {"served": served, "decisions": decisions,
                       "state": [_np(t) for t in auto.service.state]}
    return out


def drift_outcome(sess):
    """What a drift session must replay: fold state, mass, counters,
    version (and the heads, with heads on)."""
    svc = sess.service
    out = {"state": [_np(t) for t in svc.state],
           "mass": svc._drift_mass.copy(),
           "counters": (svc._drift_events, svc._drift_moves,
                        svc._drift_last),
           "version": sess.tau_version}
    if svc.heads is not None:
        from repro_torch.models.heads import tree_map
        out["heads"] = tree_map(_np, svc.heads)
    return out


def case_drift(spec):
    """A split_merge session on the sharded plane, heads off
    (serve_versioned) and on (serve_predict, the routed re-map)."""
    from repro_torch.fed.api import FederationPlan, Session
    mesh = _mesh()
    out = {}
    for heads in ("off", "linear"):
        plan = FederationPlan(**spec["plan"], heads=heads,
                              serve_axes=("data",), device="cpu")
        sess = Session.from_round(plan, spec["round"], mesh=mesh, seed=3)
        if heads == "off":
            served = [sess.serve_versioned(spec["reqs"][lo:lo + 8],
                                           spec["kvs"][lo:lo + 8])
                      for lo in range(0, len(spec["reqs"]), 8)]
        else:
            served = served_routed(sess, spec["reqs"], spec["kvs"], 8)
        out[heads] = {"served": served, **drift_outcome(sess)}
    return out


def encoded_outcome(sess, reqs, routed):
    """An encoded session's results: serve_versioned (or serve_predict,
    ``routed``) in two flushes, then the fold state and stats."""
    half = len(reqs) // 2
    if routed:
        served = (served_routed(sess, reqs[:half], [None] * half, half)
                  + served_routed(sess, reqs[half:],
                                  [None] * (len(reqs) - half), len(reqs)))
    else:
        served = (sess.serve_versioned(reqs[:half])
                  + sess.serve_versioned(reqs[half:]))
    st = sess.stats()
    return {"served": served, "state": [_np(t) for t in sess.service.state],
            "encoder": st["encoder"], "heads": st["heads"],
            "plane_compiles": st["plane_compiles"]}


def case_encoded(spec):
    """The encoded serve and the encoded routed step on the sharded
    plane (each rank encodes its rows of every batch)."""
    from repro_torch.fed.api import FederationPlan, Session
    mesh = _mesh()
    out = {}
    for name, kw in spec["plans"].items():
        plan = FederationPlan(**kw, serve_axes=("data",), device="cpu")
        sess = Session.from_tau(plan, spec["tau"], mesh=mesh, seed=3)
        out[name] = encoded_outcome(sess, spec["reqs"],
                                    kw.get("heads", "off") != "off")
    return out


def case_lloyd(spec):
    from repro_torch.core.distributed import distributed_lloyd
    mesh = _mesh()
    labels, centers = distributed_lloyd(
        mesh, spec["data"], spec["k"], source=TableGumbel(spec["draws"]),
        iters=spec["iters"], device="cpu")
    return _np(labels), _np(centers)


def case_errors(spec):
    """The plan and mesh errors that need a world: messages by name."""
    from repro_torch.fed.api import FederationPlan, PlanError, Session
    from repro_torch.utils.mesh import MeshError, make_mesh
    mesh = _mesh()
    out = {}
    base = dict(k=4, k_prime=2, d=3, device="cpu")
    for name, kw in (("axis", dict(topology="sharded",
                                   mesh_axes=("model",))),
                     ("serve_axis", dict(serve_axes=("model",))),
                     ("batch", dict(serve_axes=("data",), batch_size=3))):
        try:
            Session(FederationPlan(**base, **kw), mesh=mesh)
            out[name] = None
        except PlanError as e:
            out[name] = str(e)
    try:
        make_mesh((dist.get_world_size(),), ("data",), backend="nccl")
        out["nccl"] = None
    except MeshError as e:
        out["nccl"] = str(e)
    return out


CASES = {"primitives": case_primitives, "round": case_round,
         "fold": case_fold, "plane": case_plane,
         "autoscale": case_autoscale, "checkpoint": case_checkpoint,
         "lloyd": case_lloyd, "errors": case_errors, "routed": case_routed,
         "drift": case_drift, "encoded": case_encoded}
