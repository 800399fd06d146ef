"""Coefficient tables: packed npz vs raw reference files, selection
semantics, and actual approximation quality of the exp-sums."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from tensorkrylov.coeffs.preprocess import parse_coefficient_file, DEFAULT_SRC
from tensorkrylov.coeffs.tables import (
    load_tables,
    select_bh,
    select_stenger,
    stenger_eps,
    TMAX,
)

RAW_AVAILABLE = os.path.isdir(DEFAULT_SRC)


@pytest.fixture(scope="module")
def tables():
    return load_tables()


def test_pack_shapes(tables):
    nR = tables.R_values.shape[0]
    assert tables.err.shape == (nR, TMAX)
    assert tables.omega.shape == (nR, TMAX, TMAX)
    assert np.all(np.diff(np.asarray(tables.R_values)) > 0)


@pytest.mark.skipif(not RAW_AVAILABLE, reason="raw coefficient files not present")
def test_pack_matches_raw_files(tables):
    """Spot-check packed ω/α against a raw Braess–Hackbusch file."""
    R = np.asarray(tables.R_values)
    row = int(np.searchsorted(R, 1000.0))
    assert R[row] == 1000.0
    # find an available rank in that row
    errs = np.asarray(tables.err[row])
    t = int(np.nonzero(np.isfinite(errs))[0][0]) + 1
    om, al = parse_coefficient_file(os.path.join(DEFAULT_SRC, f"1_xk{t:02d}.1_3"), t)
    np.testing.assert_allclose(np.asarray(tables.omega[row, t - 1, :t]), om)
    np.testing.assert_allclose(np.asarray(tables.alpha[row, t - 1, :t]), al)


@pytest.mark.slow
def test_bh_approximation_quality(tables):
    """The selected exp-sum must actually achieve its tabulated error on
    [1, R] — validates packing + parsing end to end."""
    for kappa, tol in ((50.0, 1e-7), (900.0, 1e-9), (7e4, 1e-11)):
        co = select_bh(jnp.asarray(kappa), tol, tables)
        om = np.asarray(co.omega)
        al = np.asarray(co.alpha)
        x = np.linspace(1.0, kappa, 4001)
        approx = (om[None, :] * np.exp(-np.outer(x, al))).sum(axis=1)
        err = np.max(np.abs(approx - 1.0 / x))
        assert err <= max(float(co.err) * 1.5, 1e-15), (kappa, tol, err, float(co.err))
        assert err <= tol * 1.5


@pytest.mark.slow  # 1.5 s; covered in spirit by the sup-error sweep above
def test_bh_ceil_covers_kappa(tables):
    """ceil row selection: chosen R ≥ κ, so the whole spectrum is inside."""
    R = np.asarray(tables.R_values)
    for kappa in (2.5, 81.0, 4321.0, 81560.0, 9.4e5):
        co = select_bh(jnp.asarray(kappa), 1e-8, tables)
        # reconstruct which row was used from the coefficients
        om = np.asarray(co.omega)[: int(co.rank)]
        match = None
        for i in range(len(R)):
            if np.allclose(np.asarray(tables.omega[i, int(co.rank) - 1, : int(co.rank)]), om):
                match = i
                break
        assert match is not None
        assert R[match] >= kappa * 0.999, (kappa, R[match])


def test_bh_reference_row_floors(tables):
    """reference mode floors κ to first digit (R may be < κ)."""
    co = select_bh(jnp.asarray(81560.0), 1e-8, tables, row_select="reference")
    co_ceil = select_bh(jnp.asarray(81560.0), 1e-8, tables, row_select="ceil")
    # floor → R=8e4 row; ceil → R=9e4 row → different coefficients
    assert not np.allclose(np.asarray(co.omega), np.asarray(co_ceil.omega))


def test_stenger_approximates_inverse():
    """Σ ω_j exp(−α_j x) ≈ 1/x on [1, 100] with the modelled accuracy."""
    co = select_stenger(jnp.asarray(1e-6), tmax=201)
    om = np.asarray(co.omega)
    al = np.asarray(co.alpha)
    x = np.linspace(1.0, 100.0, 2000)
    approx = (om[None, :] * np.exp(-np.outer(x, al))).sum(axis=1)
    err = np.max(np.abs(approx - 1.0 / x))
    assert err < 1e-5, err  # model constant is approximate; demand the order


def test_stenger_rank_selection():
    co = select_stenger(jnp.asarray(1e-4), tmax=201)
    t = (int(co.rank) - 1) // 2
    assert float(stenger_eps(jnp.asarray(t))) <= 1e-4
    assert float(stenger_eps(jnp.asarray(t - 1))) > 1e-4
    # masked slots are exactly zero
    om = np.asarray(co.omega)
    assert np.all(om[int(co.rank):] == 0.0)
