"""The paper's Figures 2 and 3 on the port (repro_torch/launch/figures.py)
against the JAX package's benchmarks (benchmarks/bench_fig2_heterogeneity.py,
bench_fig3_communication.py) at their quick-mode sizes, on the same numpy
data and the same k-means++ draws. The benchmarks' k-means costs are
read off as they compute them.

Tolerances (set from f32 before the runs): bytes exact; each k-means
cost within 1e-5 relative (the same labels, f32 sums in another order);
a ratio within 1e-5 relative, or, for Figure 2's differences of nearly
equal costs (k-FED, or the IID round, within a hair of the oracle),
within the costs' 1e-5 carried through the differences and the
quotient.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from benchmarks import bench_fig2_heterogeneity as jfig2  # noqa: E402
from benchmarks import bench_fig3_communication as jfig3  # noqa: E402
from repro.data.gaussian import structured_devices as jax_devices  # noqa: E402
from repro_torch.launch import figures  # noqa: E402
from test_torch_prng import JaxKeyGumbel, JaxRoundGumbel  # noqa: E402

RTOL = 1e-5


def _jax_round_key(seed, Z):
    return JaxRoundGumbel(jax.random.PRNGKey(seed), Z)


def _recorded(monkeypatch, bench):
    """The costs the benchmark computes, in its order of calls."""
    seen = []
    inner = bench.kmeans_cost_of_labels

    def record(*args):
        out = inner(*args)
        seen.append(float(out))
        return out

    monkeypatch.setattr(bench, "kmeans_cost_of_labels", record)
    return seen


@pytest.mark.parametrize("dataset,kps", [("femnist", [1, 3]),
                                         ("shakespeare", [2])])
def test_fig2_quick_matches_the_jax_bench(monkeypatch, dataset, kps):
    """Each row's oracle, structured and IID costs and ratio, for the
    two proxies of the benchmark's quick mode (one seed of its two, and
    some of its k': the JAX package compiles a round for every
    partition's shape)."""
    name, xs, ys, k, _, Z = {d[0]: d for d in figures.fig2_datasets(
        False)}[dataset]
    seen = _recorded(monkeypatch, jfig2)
    want = jfig2._run_dataset(name, xs, ys, k, kps, Z, seeds=1)
    got = figures.fig2_dataset(name, xs, ys, k, kps, Z, device="cpu",
                               seeds=1,
                               oracle_source=JaxKeyGumbel(
                                   jax.random.PRNGKey(0)),
                               round_key=_jax_round_key)
    phi_star, costs = seen[0], iter(seen[1:])
    np.testing.assert_allclose(got[0]["phi_star"], phi_star, rtol=RTOL)
    for row, line in zip(got, want):
        assert line.startswith(row["name"] + ",")
        ratios = []
        for (got_kp, got_k), got_ratio in zip(row["costs"], row["ratios"]):
            phi_kp, phi_k = next(costs), next(costs)
            np.testing.assert_allclose([got_kp, got_k], [phi_kp, phi_k],
                                       rtol=RTOL)
            den = max(phi_k - phi_star, 1e-9)
            ratios.append((phi_kp - phi_star) / den)
            # The costs' relative error carried through the differences
            # and the quotient.
            err = RTOL * ((phi_kp + phi_star)
                          + abs(ratios[-1]) * (phi_k + phi_star)) / den
            assert abs(got_ratio - ratios[-1]) <= max(
                err, RTOL * abs(ratios[-1]))
        assert line.endswith(f"cost_ratio={float(np.mean(ratios)):.3f}")


def test_fig3_quick_matches_the_jax_bench(monkeypatch):
    """Every row of the benchmark's quick mode: the k-FED and Lloyd
    costs, their ratio and the bytes, on the JAX package's devices."""
    seen = _recorded(monkeypatch, jfig3)
    want = jfig3.run(False)
    k, d, kp, m0, n_per, rounds = figures.fig3_settings(False)
    costs = iter(seen)
    for s, (kp_i, line) in enumerate(zip([1, kp // 2, kp], want)):
        kp_eff = max(1, kp_i)
        fm = jax_devices(jax.random.PRNGKey(s), k=k, d=d, k_prime=kp_eff,
                         m0=m0 * (kp // kp_eff), n_per_comp_dev=n_per,
                         sep=25.0)
        row = figures.fig3_row(
            np.array(fm.data), k, kp_eff, s, device="cpu", rounds=rounds,
            round_key=_jax_round_key,
            lloyd_source=JaxKeyGumbel(jax.random.PRNGKey(17 + s)))
        phi_kfed, phi_lloyd = next(costs), next(costs)
        np.testing.assert_allclose([row["phi_kfed"], row["phi_lloyd"]],
                                   [phi_kfed, phi_lloyd], rtol=RTOL)
        np.testing.assert_allclose(row["ratio"], phi_kfed / phi_lloyd,
                                   rtol=RTOL)
        fields = dict(f.split("=") for f in line.split(",", 2)[2].split(";"))
        assert line.startswith(row["name"] + ",")
        assert int(fields["bytes_kfed"]) == row["bytes_kfed"]
        assert int(fields["bytes_lloyd"]) == row["bytes_lloyd"]
        assert fields["cost_ratio_kfed_vs_lloyd"] == f"{row['ratio']:.3f}"


def test_fig2_and_fig3_run_on_their_own_draws():
    """Without the JAX draws, the port's own (a smaller Figure 3 and one
    Figure 2 row): finite costs, k-FED at least as good as the IID
    partition's, and the bytes of the formula."""
    name, xs, ys, k, kps, Z = figures.fig2_datasets(False)[1]
    row = figures.fig2_dataset(name, xs, ys, k, kps[:1], Z, device="cpu",
                               seeds=1)[0]
    assert np.isfinite(row["ratio"]) and row["ratio"] < 1.0
    fm = figures.structured_devices(0, k=8, d=12, k_prime=2, m0=2,
                                    n_per_comp_dev=20, sep=25.0)
    r = figures.fig3_row(fm.data, 8, 2, 0, device="cpu", rounds=5)
    assert np.isfinite(r["ratio"]) and r["Z"] == 8
    assert r["bytes_kfed"] == 8 * 2 * 12 * 4 + 8 * 12 * 4
    assert r["bytes_lloyd"] == 5 * 8 * (8 * 12 + 8) * 4
