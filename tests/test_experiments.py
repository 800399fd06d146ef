"""Experiment-module unit tests (spectrum enumeration, families)."""
import numpy as np

from tensorkrylov.experiments.eigenvalue_distribution import (
    clusterzero,
    clusterone,
    kronsum_spectrum,
    kronsum_spectrum_multiset,
    perturb_eigenvalues,
    uniform_eigenvalues,
)


def test_families():
    cz = clusterzero(10)
    assert cz[0] == 0.01 and cz[-1] == 1.0
    co = clusterone(10)
    assert co[0] == 0.01 and abs(co[-1] - 1.0) < 1e-12
    U = uniform_eigenvalues(5, 3, (1.0, 2.0))
    assert U.shape == (3, 5) and not np.allclose(U[0], U[1])


def test_multiset_spectrum_matches_full():
    ev = np.array([1.0, 2.5, 4.0])
    d = 3
    full = np.sort(kronsum_spectrum(np.broadcast_to(ev, (d, 3))))
    vals, counts = kronsum_spectrum_multiset(ev, d)
    assert counts.sum() == 3**d
    recon = np.sort(np.repeat(vals, counts))
    np.testing.assert_allclose(recon, full, rtol=1e-14)


def test_perturbed_spectrum():
    P = perturb_eigenvalues(np.array([1.0, 2.0]), 3, 0.1)
    np.testing.assert_allclose(P[0], [1.1, 2.1])
    np.testing.assert_allclose(P[2], [1.3, 2.3])


def test_interpret_cross_check_branches():
    """ADVICE r3 medium: a measurement above the certified bound must be
    labelled a contradiction, never a confirmation."""
    from tensorkrylov.experiments.northstar import interpret_cross_check

    assert interpret_cross_check(None, 1e-9, 1e-9, 1e-8) is None
    assert "<= floor" in interpret_cross_check(1e-10, 1e-9, 5e-9, 1e-8)
    assert "confirmation" in interpret_cross_check(3e-9, 1e-9, 5e-9, 1e-8)
    # the r3 flagship shape: measured 9.8e-6 >> bound 5.4e-9 and tol 1e-8
    v = interpret_cross_check(9.8e-6, 3e-8, 5.4e-9, 1e-8)
    assert "CONTRADICTED" in v
    # above bound but within tol: slack exceeded, target still met
    v2 = interpret_cross_check(8e-9, 1e-9, 5e-9, 1e-8)
    assert "within tol" in v2
