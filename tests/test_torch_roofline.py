"""The port's bounds tooling against the JAX package's: the roofline
module (``launch/roofline.py``), the dtype-aware flop count on the meta
device (``launch/flops.py`` against ``repro.launch.jaxpr_flops.
trace_flops``), the routed bench's baseline step
(``fed/plane._make_allk_step``), the dry run under a meta mesh
(``launch/mesh.py``, ``launch/dryrun.py``) and ``launch/perf_probe.py``
on the CPU.

The flop counts are equal, or equal less a difference computed from the
shapes and named here:

  * ``prefill_qkv_again``: with a cache to build, the reference's
    ``block_seq`` runs ``_qkv`` (GQA) or ``_mla_latent`` (MLA) a second
    time on the same input (``repro/models/transformer.py:143-156``),
    on every attention layer of the decoder and the hybrid family's
    shared block after each group; the port builds the cache from the
    attention's own k and v. The jaxpr holds both products, so the walk
    charges both.
  * ``ssd_einsums`` (f32): the reference writes two of the chunked SSD's
    broadcast products as einsums without a contraction
    (``repro/models/mamba.py:115``, ``:127``), which the walk charges as
    dot_generals; the port computes them as elementwise products.
  * ``mtp_recompute``: under ``cfg.remat`` the port recomputes
    DeepSeek-V3's MTP block in the backward, as it does the segments'
    layers (``models/model.py`` ``_mtp_loss``); the reference does not
    checkpoint that block. ``torch.utils.checkpoint`` stops its
    recompute at the last saved tensor, so the block's last product
    (the FFN's ``w2``) is not run again.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.fed import plane as jplane  # noqa: E402
from repro.fed.stream import StreamConfig as JaxStreamConfig  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.jaxpr_flops import trace_flops  # noqa: E402
from repro.models import heads as jheads  # noqa: E402
from repro.models.common import DistCtx as JaxCtx  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.optim import build_optimizer as jbuild_optimizer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (SHAPES, InputShape, get_config,  # noqa: E402
                                 input_specs, list_archs)
from repro_torch.core.lloyd import lloyd  # noqa: E402
from repro_torch.fed import plane  # noqa: E402
from repro_torch.fed.stream import StreamConfig  # noqa: E402
from repro_torch.launch import dryrun, perf_probe, roofline  # noqa: E402
from repro_torch.launch.flops import (Counter, effective_flops,  # noqa: E402
                                      flops_by_dtype)
from repro_torch.launch.mesh import MetaMesh, make_production_mesh  # noqa: E402
from repro_torch.launch.train import init_state, make_train_step  # noqa: E402
from repro_torch.models.common import ShapeOnly  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import build_optimizer  # noqa: E402
from repro_torch.utils.mesh import MeshError  # noqa: E402
from test_torch_prng import JaxServeGumbel  # noqa: E402
from test_torch_route import _step_inputs  # noqa: E402

# ------------------------------------------------------------ roofline --


def test_hw_profile_defaults_to_h100_and_names_the_profiles(monkeypatch):
    monkeypatch.delenv("REPRO_HW_PROFILE", raising=False)
    hw = roofline.hw_profile()
    assert roofline.DEFAULT_HW_PROFILE == "h100"
    assert hw is roofline.HW_PROFILES["h100"]
    assert (hw["peak_flops"], hw["peak_flops_f32"], hw["hbm_bw"],
            hw["link_bw"]) == (989e12, 67e12, 3.35e12, 450e9)
    with pytest.raises(KeyError, match=r"tpu_v5e.*\['h100'\]"):
        roofline.hw_profile("tpu_v5e")
    monkeypatch.setenv("REPRO_HW_PROFILE", "h100")
    assert roofline.hw_profile() is hw


def test_roofline_terms_by_name_dict_and_default(monkeypatch):
    monkeypatch.delenv("REPRO_HW_PROFILE", raising=False)
    args = (989e12, 6.7e12, 4.5e11)
    want = {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 1.0,
            "bottleneck": "memory", "total_s": 2.0}
    for hw in ("h100", roofline.HW_PROFILES["h100"], None):
        got = roofline.roofline_terms(*args, hw=hw)
        assert got.keys() == want.keys()
        assert got["bottleneck"] == "memory"
        for key in ("compute_s", "memory_s", "collective_s", "total_s"):
            assert got[key] == pytest.approx(want[key], rel=1e-12)
    # The card's f32 / bf16 ratio: compute_s = bf16 / 989e12 + f32 / 67e12.
    fl = {"bf16": 989e12, "f32": 67e12}
    terms = roofline.roofline_terms(effective_flops(fl), 0.0, 0.0)
    assert terms["compute_s"] == pytest.approx(2.0, rel=1e-12)
    assert terms["bottleneck"] == "compute"


@pytest.fixture(scope="module")
def param_counts():
    """{arch: ((n, active) of the port, (n, active) of the reference)}
    at full width, both shape-only (``Model.param_shapes``,
    ``jax.eval_shape`` of ``init``)."""
    out = {}
    for arch in list_archs():
        cfg = get_config(arch)
        shapes = build_model(cfg).param_shapes()
        jcfg = jget_config(arch)
        jm = jbuild_model(jcfg)
        ps = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ps))
        out[arch] = ((roofline.param_count(shapes),
                      roofline.active_param_count(cfg, shapes)),
                     (n, jroofline.active_param_count(jcfg, ps)))
    return out


@pytest.mark.parametrize("arch", sorted(
    ["deepseek-v3-671b", "granite-3-2b", "internvl2-26b", "mistral-nemo-12b",
     "mixtral-8x7b", "nemotron-4-15b", "qwen1.5-0.5b", "rwkv6-7b",
     "whisper-base", "zamba2-1.2b"]))
def test_param_counts_and_model_flops_equal_jax(param_counts, arch):
    (n, active), (jn, jactive) = param_counts[arch]
    assert (n, active) == (jn, jactive)
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert (active < n) == bool(cfg.moe)
    for name, shape in SHAPES.items():
        assert vars(shape) == vars(JSHAPES[name])
        assert roofline.model_flops(cfg, shape, n, active) == \
            jroofline.model_flops(jcfg, JSHAPES[name], jn, jactive), name


# -------------------------------------------------------- flop counts --

def prefill_qkv_again(cfg, B: int, S: int) -> float:
    """bf16 flops of the reference's second ``_qkv`` / ``_mla_latent``
    of every attention layer of a prefill over B x S positions (module
    docstring)."""
    d = cfg.d_model
    if cfg.attn == "mla":
        per = 2 * B * S * d * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim)
    else:
        per = 2 * B * S * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    segments = build_model(cfg).segments
    layers = sum(s.n_layers for s in segments if s.kind == "attn_ffn")
    if cfg.family == "hybrid":
        layers += len(segments)          # the shared block after each group
    return float(per * layers)


def ssd_einsums(cfg, B: int, S: int) -> float:
    """f32 flops of the reference's contraction-free SSD einsums over
    B x S positions (module docstring): per Mamba2 layer, one product of
    (B, S, H) by (B, S, H, P) and one of (B, S, chunk) by (B, S, H)."""
    if cfg.family != "hybrid":
        return 0.0
    s = cfg.ssm
    H = s.expand * cfg.d_model // s.head_dim
    layers = sum(x.n_layers for x in build_model(cfg).segments
                 if x.kind == "mamba")
    return float(layers * (2 * B * S * H * s.head_dim
                           + 2 * B * S * cfg.ssm_chunk * H))


def mtp_recompute(cfg, B: int, S: int) -> dict:
    """Flops of the port's remat recompute of DeepSeek-V3's MTP block on
    one microbatch of B x S tokens (module docstring): the MLA block's
    projections and the FFN's w1 and w3 in bf16, the attention's scores
    and weighted sums in f32 (S within one attention chunk)."""
    assert S <= cfg.attn_chunk
    m, d, H, T = cfg.mla, cfg.d_model, cfg.n_heads, B * S
    dk = m.qk_nope_dim + m.qk_rope_dim
    bf16 = 2 * T * (d * m.q_lora_rank + m.q_lora_rank * H * dk
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_dim)
                    + H * m.v_dim * d + 2 * d * cfg.d_ff)
    f32 = 2 * B * H * S * S * (dk + m.v_dim)
    return {"bf16": float(bf16), "f32": float(f32)}


def _jax_specs(specs):
    dt = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
          torch.float32: jnp.float32}
    return {k: jax.ShapeDtypeStruct(tuple(v.shape), dt[v.dtype])
            for k, v in specs.items()}


# One reduced config a family (both MoE attentions), prefill of B x S.
FAMILY_ARCHS = ["mistral-nemo-12b", "mixtral-8x7b", "deepseek-v3-671b",
                "rwkv6-7b", "zamba2-1.2b", "whisper-base", "internvl2-26b"]
B_, S_ = 2, 32


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_flops_by_dtype_equal_trace_flops(arch):
    """Prefill and one decode step of a reduced config on the meta
    device against ``trace_flops`` of the JAX package's: the decode
    equal, the prefill equal less ``prefill_qkv_again`` (bf16) and
    ``ssd_einsums`` (f32)."""
    cfg = get_config(arch, reduced=True)
    extra = cfg.encoder.n_prefix if cfg.family == "vlm" else 0
    if cfg.family == "encdec":
        S = S_ + cfg.encoder.n_ctx
    else:
        S = S_ + extra
    batch = input_specs(cfg, InputShape("t", S, B_, "prefill"))
    model = build_model(cfg)
    params = model.init(ShapeOnly())
    with torch.no_grad(), Counter() as c:
        _, cache = model.prefill(params, batch)
    prefill = dict(c.flops)
    tok = torch.empty((B_,), dtype=torch.int32, device="meta")
    with torch.no_grad():
        decode = flops_by_dtype(model.serve_step, params, cache, tok)
    assert c.calls["mm"] + c.calls["bmm"] > 0

    jm = jbuild_model(jget_config(arch, reduced=True))
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jb = _jax_specs(batch)
    jprefill = trace_flops(lambda p, b: jm.prefill(p, b, JaxCtx()), jp, jb)
    _, jcache = jax.eval_shape(lambda p, b: jm.prefill(p, b, JaxCtx()),
                               jp, jb)
    jdecode = trace_flops(lambda p, c, t: jm.serve_step(p, c, t, JaxCtx()),
                          jp, jcache, jax.ShapeDtypeStruct((B_,), jnp.int32))
    assert decode == jdecode
    S_dec = S_ + extra
    assert prefill["bf16"] == jprefill["bf16"] - prefill_qkv_again(
        cfg, B_, S_dec)
    assert prefill["f32"] == jprefill["f32"] - ssd_einsums(cfg, B_, S_dec)


TRAIN_CASES = [("mixtral-8x7b", {}), ("deepseek-v3-671b", {}),
               ("mixtral-8x7b", dict(remat=True, microbatch=2)),
               ("deepseek-v3-671b", dict(remat=True, microbatch=2))]


@pytest.mark.parametrize("arch,kw", TRAIN_CASES,
                         ids=["mixtral", "deepseek", "mixtral-remat-mb2",
                              "deepseek-remat-mb2"])
def test_train_flops_by_dtype_equal_trace_flops(arch, kw):
    """One train step on the meta device (forward, backward, remat's
    recompute and every microbatch as they run) against ``trace_flops``
    of the JAX package's jitted step: equal, less ``mtp_recompute`` a
    microbatch where DeepSeek-V3 runs under remat."""
    B, S = 4, 32
    cfg = get_config(arch, reduced=True).replace(**kw)
    model = build_model(cfg)
    opt = build_optimizer(cfg.optimizer, 1e-4)
    batch = input_specs(cfg, InputShape("t", S, B, "train"))
    got = flops_by_dtype(make_train_step(model, None, opt),
                         init_state(model, ShapeOnly(), opt), batch)
    jcfg = jget_config(arch, reduced=True).replace(**kw)
    jm = jbuild_model(jcfg)
    jopt = jbuild_optimizer(cfg.optimizer, 1e-4)
    jstate = jax.eval_shape(lambda: jtrain.init_state(
        jm, jax.random.PRNGKey(0), jopt))
    want = trace_flops(jtrain.make_train_step(jm, JaxCtx(), jopt), jstate,
                       _jax_specs(batch))
    extra = {"bf16": 0.0, "f32": 0.0}
    if cfg.mtp and cfg.remat:
        mb = cfg.microbatch
        extra = {k: mb * v for k, v in mtp_recompute(cfg, B // mb,
                                                     S).items()}
    assert got == {k: want[k] + extra[k] for k in want}


# ------------------------------------------------- the routed baseline --

ALLK_CASES = [("spread", 8, "qwen1.5-0.5b", "transformer", "f32"),
              ("one_cluster", 4, "linear", "ffn", "f32")]


@pytest.mark.parametrize("case,k,heads,arch,serve_dtype", ALLK_CASES)
def test_allk_step_matches_jax_and_routed(case, k, heads, arch, serve_dtype):
    """``_make_allk_step`` against the JAX package's on the same inputs,
    heads and draws (labels, center masks, votes and keep exact, every
    request kept; predictions within 1e-6 of their largest magnitude),
    and against the port's routed step on its kept requests (within rtol
    / atol 1e-6, as tests/test_route_serve.py holds the JAX pair)."""
    kw = dict(k=k, k_prime=2, d=16, capacity=64, batch_size=8,
              bucket_sizes=(32,), heads=heads, head_arch=arch,
              serve_dtype=serve_dtype)
    jcfg, cfg = JaxStreamConfig(**kw), StreamConfig(**kw)
    tau, data, pmask, kv, rids = _step_inputs(case, k)
    jp = jheads.init_heads(jax.random.PRNGKey(3), k, jcfg.head_spec())
    base = jax.random.PRNGKey(0)
    keys = jax.vmap(lambda r: jax.random.fold_in(base, r))(
        jnp.asarray(rids, jnp.uint32))
    want = [np.asarray(w) for w in jax.jit(jplane._make_allk_step(jcfg))(
        jnp.asarray(tau), jp, keys, jnp.asarray(data), jnp.asarray(pmask),
        jnp.asarray(kv))]
    args = (torch.as_tensor(tau),
            convert.heads(jax.tree.map(np.asarray, jp), device="cpu"),
            JaxServeGumbel(0).draw(rids.tolist(), 2, 32, "cpu"),
            torch.as_tensor(data), torch.as_tensor(pmask),
            torch.as_tensor(kv))
    got = [g.numpy() for g in plane._make_allk_step(cfg)(*args)]
    for i in (0, 2, 5, 6):      # labels, center mask, votes, kept
        np.testing.assert_array_equal(got[i], want[i])
    assert got[5].dtype == np.int32 and got[6].all()
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=1e-4 * np.abs(want[1]).max())
    np.testing.assert_allclose(got[4], want[4], rtol=0,
                               atol=1e-6 * np.abs(want[4]).max())
    routed = [g.numpy() for g in plane._make_routed_step(cfg)(*args)]
    kept = routed[6]
    assert kept.any() and (case != "one_cluster" or not kept.all())
    np.testing.assert_array_equal(got[5], routed[5])
    for i in range(4):
        np.testing.assert_array_equal(got[i], routed[i])
    np.testing.assert_allclose(got[4][kept], routed[4][kept], rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------ dry run --

DRY_ARCH = "qwen1.5-0.5b"     # reduced: d 256, 4 heads of 64, tp 2 divides

RECORD_KEYS = {
    "arch", "shape", "mesh", "status", "chips", "n_params",
    "n_active_params", "flops_per_device", "flops_eff_per_device",
    "flops_bf16", "flops_f32", "bytes_per_device", "collectives",
    "collective_bytes", "model_flops", "useful_flops_ratio", "compute_s",
    "memory_s", "collective_s", "bottleneck", "total_s", "bytes_peak_est",
    "t_count_s"}


@pytest.fixture(scope="module")
def dry_records():
    """{(mode, layers): record} of reduced qwen1.5-0.5b at 1 and 2
    layers under a (2, 2) ("data", "model") meta mesh, B=4, S=32."""
    out = {}
    for mode in ("prefill", "decode", "train"):
        for layers in (1, 2):
            cfg = get_config(DRY_ARCH, reduced=True).replace(n_layers=layers)
            out[mode, layers] = dryrun.lower_one(
                DRY_ARCH, InputShape(mode, 32, 4, mode), verbose=False,
                mesh=MetaMesh((2, 2), ("data", "model")), cfg=cfg)
    return out


@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
def test_lower_one_under_a_2x2_meta_mesh(dry_records, mode):
    """The record's keys; its collectives against a hand count of the
    layout; this rank's flops times the 4 ranks equal to the one-device
    count (no replicated product: the batch is cut over ``data``, every
    product's heads, hidden or vocab columns over ``model``).

    Hand count, B/dp = 2 rows of S = 32 at d = 256 on a rank, bf16:
    prefill and decode: one psum over ``model`` for the vocab-parallel
    embedding, then a layer's two row-parallel outputs (``wo``, the
    FFN's ``w2``), each (2, 32, 256) (decode (2, 256)), and one
    all-gather of the last position's logits over the vocab (2, 256).
    train, a layer more: 4 psums over ``model`` (the two row-parallel
    outputs, and in the backward the two column-parallel inputs' psum of
    the cotangent) and 12 over ``data`` (each of the layer's leaves'
    gradient parts: ln1, wq, wk, wv, bq, bk, bv, wo, ln2, w1, w3, w2)."""
    one, two = dry_records[mode, 1], dry_records[mode, 2]
    assert set(one) == RECORD_KEYS and one["status"] == "ok"
    assert one["chips"] == 4 and one["mesh"] == "single"
    for rec in (one, two):
        whole = rec["flops_bf16"] + rec["flops_f32"]
        assert rec["flops_per_device"] * 4 == whole > 0
        assert rec["collective_bytes"] == sum(
            v["bytes"] for v in rec["collectives"].values())
        assert rec["total_s"] == max(rec["compute_s"], rec["memory_s"],
                                     rec["collective_s"])
    d, rows = 256, 2 * 32 if mode != "decode" else 2
    act = rows * d * 2
    if mode in ("prefill", "decode"):
        for L, rec in ((1, one), (2, two)):
            assert rec["collectives"] == {
                "all_gather": {"count": 1, "bytes": 2 * 256 * 2},
                "psum": {"count": 1 + 2 * L, "bytes": (1 + 2 * L) * act}}
        return
    more = {k: two["collectives"][k]["count"] - one["collectives"][k]["count"]
            for k in two["collectives"]}
    assert more == {"psum": 4 + 12, "pmax": 0}
    cfg = get_config(DRY_ARCH, reduced=True)
    shapes = build_model(cfg.replace(n_layers=1)).param_shapes()
    layer = {p[2:]: s[1:] for p, s in shapes.items() if p[0] == "segments"}
    assert len(layer) == 12
    # A rank holds half of each of the layer's leaves (its heads, hidden
    # or output columns over ``model``) but the norms' whole vectors.
    part = sum(math.prod(s) // (1 if name[0] in ("ln1", "ln2") else 2)
               for name, s in layer.items())
    gained = two["collective_bytes"] - one["collective_bytes"]
    assert gained == 4 * act + 2 * part


def test_lower_one_production_mesh_and_errors():
    """The production meshes' one-rank views, a skip, and a meta run
    that fails naming the port's line; the meta groups refuse a CPU
    tensor."""
    mesh = make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16} and mesh.world == 256
    multi = make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.group(("pod", "data")).size == 32
    rec = dryrun.lower_one("whisper-base", "long_500k")
    assert rec["status"] == "skipped" and "448-token" in rec["reason"]
    with pytest.raises(MeshError, match="meta tensors"):
        mesh.group("model").psum(torch.ones(3))

    # The round's Lloyd loop reads its convergence on the host.
    x = torch.empty((2, 8, 3), device="meta")
    with pytest.raises(dryrun.DryRunError,
                       match=r"repro_torch/core/lloyd.py:\d+ \(lloyd\)"):
        dryrun.count(lloyd, (x, torch.empty((2, 2, 3), device="meta")))


def test_perf_probe_on_the_cpu(capsys):
    """The probe at reduced size on the CPU under a one-rank counted
    mesh: its table is the host's op time (a CPU run names no device
    time), and the schedule lists what the ShardGroup was asked for."""
    res = perf_probe.main(["--arch", "mixtral-8x7b", "--shape",
                           "decode_32k", "--layers", "2", "--batch", "2",
                           "--seq", "64", "--device", "cpu", "-n", "5",
                           "--mesh-shape", "1", "1"])
    out = capsys.readouterr().out
    assert res["device"] == "cpu" and len(res["top"]) == 5
    assert "host op (a CPU run: no device time)" in out
    assert "mixtral-8x7b 2 layers, batch 2, sequence 64, decode" in out
    assert any(name == "aten::bmm" or name == "aten::mm"
               for name, *_ in res["top"])
    assert res["collectives"] and all(
        v["count"] > 0 for v in res["collectives"].values())
    assert "== collective schedule ==" in out
