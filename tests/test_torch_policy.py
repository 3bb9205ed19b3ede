"""The port's fold-admission policies (repro_torch/fed/policy.py) and
autoscale controller (repro_torch/fed/autoscale.py) against the JAX
package's, on the same admission sequences and queue snapshots drawn
with hypothesis: slots, grants, state arrays and decisions exactly
(both are numpy host logic)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from repro.fed import autoscale as jas  # noqa: E402
from repro.fed import policy as jpol  # noqa: E402
from repro_torch.fed import autoscale, policy  # noqa: E402


def _sequence(seed, n_batches, max_rid):
    """Serve batches of request ids (with re-deliveries) and f32 report
    weights that are sums of core counts, as the service admits them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        b = int(rng.integers(1, 9))
        rids = rng.integers(0, max_rid, size=b)
        w = rng.integers(0, 400, size=(b, 3)).astype(np.float32).sum(1)
        out.append((rids, w))
    return out


def _both(name, capacity, seed, half_life=0):
    kw = dict(seed=seed, half_life=half_life)
    return (policy.make_policy(name, capacity, **kw),
            jpol.make_policy(name, capacity, **kw))


def _same_state(a, b):
    sa, sb = a.state_arrays(), b.state_arrays()
    assert sorted(sa) == sorted(sb)
    for key in sb:
        assert sa[key].dtype == sb[key].dtype, key
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10 ** 6), capacity=st.integers(1, 12),
       half_life=st.integers(0, 5))
@pytest.mark.parametrize("name", ["drop", "lru", "weighted_reservoir"])
def test_policies_admit_as_jax(name, seed, capacity, half_life):
    """Every batch's slot vector (padded to the serve batch) and grant
    count, and the state after it, equal the JAX policy's; the state
    reloaded into a fresh policy admits the rest alike."""
    got, want = _both(name, capacity, seed % 7, half_life)
    assert (got.name, got.needs_weight) == (want.name, want.needs_weight)
    seq = _sequence(seed, 12, 3 * capacity + 2)
    for i, (rids, w) in enumerate(seq):
        weights = w if want.needs_weight else None
        total = int(len(rids) + seed % 3)
        gs, gg = got.admit_padded(rids, weights, total=total)
        ws, wg = want.admit_padded(rids, weights, total=total)
        np.testing.assert_array_equal(gs, ws)
        assert gs.dtype == ws.dtype and gg == wg
        _same_state(got, want)
        if i == 5:   # restore mid-stream, from the JAX package's arrays
            got = policy.make_policy(name, capacity, seed=seed % 7,
                                     half_life=half_life)
            like = got.state_like()
            arrays = {k: np.asarray(v, like[k].dtype)
                      for k, v in want.state_arrays().items()}
            got.load_state(arrays)


@pytest.mark.parametrize("half_life", [0, 3])
def test_reservoir_keys_are_the_jax_packages(half_life):
    """The key of each (id, weight) bit for bit, from the rng of
    (seed, id), with and without the decay."""
    got, want = _both("weighted_reservoir", 4, 11, half_life)
    for rid in range(40):
        for w in (0.0, 1.0, 7.0, 123.0):
            assert got.key_of(rid, w) == want.key_of(rid, w)


def test_policy_ids_and_base_class():
    assert policy.POLICY_IDS == jpol.POLICY_IDS
    assert sorted(policy.POLICIES) == sorted(jpol.POLICIES)
    assert policy.FoldPolicy.needs_weight is False
    with pytest.raises(ValueError, match="fold_policy='fifo'"):
        policy.make_policy("fifo", 4)


def _snapshots(seed, n, ladder):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = int(rng.integers(0, 40))
        ns = rng.integers(1, 4 * ladder[-1] + 1, size=depth)
        out.append([int(v) for v in ns])
    return out


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10 ** 6), log_batch=st.integers(0, 4))
@pytest.mark.parametrize("name", ["off", "latency", "throughput"])
def test_controller_decides_as_jax(name, seed, log_batch):
    """The same snapshots, decisions, streaks, checkpoint arrays and
    stats (telemetry aside) as the JAX controller, and a reload of its
    arrays mid-sequence replays the rest."""
    ladder = (16, 64, 256)
    kw = dict(max_batch=2 ** log_batch, granted=1, n_axes=1,
              base_ladder=ladder)
    got = autoscale.AutoscaleController(name, **kw)
    want = jas.AutoscaleController(name, **kw)
    for i, ns in enumerate(_snapshots(seed, 10, ladder)):
        snap = autoscale.snapshot_queue(ns, ladder)
        assert snap == jas.snapshot_queue(ns, ladder)
        if ns:
            assert got.observe(snap) == want.observe(snap)
        assert got.streak == want.streak
        for key, arr in want.state_arrays().items():
            np.testing.assert_array_equal(got.state_arrays()[key], arr)
        if i == 4:
            got = autoscale.AutoscaleController(name, **kw)
            got.load_state(*want.state_arrays().values())
        assert got.stats() == want.stats()


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_decide_and_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    ladder = (32, 64)
    for _ in range(8):
        ns = [int(v) for v in rng.integers(1, 600, size=rng.integers(0, 30))]
        snap = autoscale.snapshot_queue(ns, ladder)
        prev = autoscale.AutoscaleDecision(1, int(2 ** rng.integers(0, 4)),
                                           ladder, int(rng.integers(0, 9)))
        streak = int(rng.integers(0, 2))
        for name in ("latency", "throughput"):
            assert autoscale.decide(
                name, snap, max_batch=8, granted=1, n_axes=1,
                base_ladder=ladder, prev=prev, streak=streak) == jas.decide(
                name, jas.QueueSnapshot(*snap), max_batch=8, granted=1,
                n_axes=1, base_ladder=ladder,
                prev=jas.AutoscaleDecision(*prev), streak=streak)
        x = int(rng.integers(0, 5000))
        assert autoscale.pow2_ceil(x) == jas.pow2_ceil(x)
        assert autoscale.bucket_of(x + 1, ladder) == jas.bucket_of(
            x + 1, ladder)
        g, b = int(2 ** rng.integers(0, 4)), int(rng.integers(1, 17))
        assert autoscale.shards_for(b, g, 1) == jas.shards_for(b, g, 1)
    assert autoscale.AUTOSCALE_IDS == jas.AUTOSCALE_IDS
    assert autoscale.AUTOSCALE_POLICIES == jas.AUTOSCALE_POLICIES
    with pytest.raises(autoscale.AutoscaleError, match="autoscale='fast'"):
        autoscale.AutoscaleController("fast", max_batch=8, granted=1,
                                      n_axes=1, base_ladder=ladder)
