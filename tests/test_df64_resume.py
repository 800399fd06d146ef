"""df64 crash-resume: state_cache persistence at checkpoint boundaries.

An interrupted certified flagship solve (storage='df64') resumes from its
last checkpoint instead of step 0. These tests
pin the contract: a solve resumed from a mid-run cache continues the
recording recurrence bit-exactly (the persisted state is the complete
f32-pair basis prefix + exact f64 projected arrays)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import tensorkrylov as tk


def _problem():
    op = tk.laplace(2, 64, shift=30.0)
    b = tk.random_rhs(2, 64, seed=5)
    return op, b / jnp.linalg.norm(b, axis=1, keepdims=True)


def test_df64_resume_bit_exact(tmp_path):
    op, b = _problem()
    cfg = tk.SolverConfig(kmax=16, tol=1e-30)  # never converge: full ladder
    cache = str(tmp_path / "df64_state.npz")

    # run A: advance to checkpoint 8 only; cache left at k_prev=9
    tk.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8],
                      state_cache=cache)
    z = np.load(cache)
    assert str(z["storage"]) == "df64" and int(z["k_prev"]) == 9
    assert z["Vh_act"].shape == (9 * 2, 64)

    # run B: resumes from k=9, advances only 9..16
    r_resumed = tk.solve_deflated(op, b, cfg, m=6, storage="df64",
                                  checkpoints=[8, 16], state_cache=cache)
    # run C: identical solve from scratch, no cache
    r_fresh = tk.solve_deflated(op, b, cfg, m=6, storage="df64",
                                checkpoints=[8, 16])
    assert r_resumed.checkpoints == r_fresh.checkpoints
    np.testing.assert_array_equal(
        np.asarray(r_resumed.relative_residual),
        np.asarray(r_fresh.relative_residual))
    np.testing.assert_array_equal(
        np.asarray(r_resumed.certified_bound),
        np.asarray(r_fresh.certified_bound))
    np.testing.assert_array_equal(np.asarray(r_resumed.x.weights),
                                  np.asarray(r_fresh.x.weights))
    np.testing.assert_array_equal(np.asarray(r_resumed.x.factors),
                                  np.asarray(r_fresh.x.factors))
    # the resumed run re-saves at its own checkpoints
    assert int(np.load(cache)["k_prev"]) == 17


@pytest.mark.slow  # negative-path variants of the fast bit-exact test
def test_df64_resume_rejects_stale_cache(tmp_path):
    op, b = _problem()
    cache = str(tmp_path / "df64_state.npz")
    cfg = tk.SolverConfig(kmax=16, tol=1e-30)
    tk.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8],
                      state_cache=cache)
    # different deflation rank → recorded C/m mismatch → must refuse
    with pytest.raises(ValueError, match="stale"):
        tk.solve_deflated(op, b, cfg, m=4, storage="df64", checkpoints=[8],
                          state_cache=cache)
    # different stride schedule → pass-1 relation would not replay
    with pytest.raises(ValueError, match="stale"):
        tk.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8],
                          state_cache=cache, project_every=2)


def test_state_cache_still_rejected_for_unsupported_storage(tmp_path):
    op, b = _problem()
    with pytest.raises(ValueError, match="state_cache"):
        tk.solve_deflated(op, b, tk.SolverConfig(kmax=16), m=6,
                          storage="segmented",
                          state_cache=str(tmp_path / "x.npz"))


def test_advance_budget_march_bit_exact(tmp_path):
    """r5 budgeted-leg march: advance_budget runs run N steps past the
    resumed cache, save, and return a partial RUNNING result; the marched
    cache then completes to the SAME solve as one uninterrupted run."""
    op, b = _problem()
    cfg = tk.SolverConfig(kmax=16, tol=1e-30)
    cache = str(tmp_path / "march.npz")

    r1 = tk.solve_deflated(op, b, cfg, m=6, storage="df64",
                           checkpoints=[8, 16], state_cache=cache,
                           advance_budget=4)
    assert r1.x is None and r1.niterations == 4
    assert int(np.load(cache)["k_prev"]) == 5
    r2 = tk.solve_deflated(op, b, cfg, m=6, storage="df64",
                           checkpoints=[8, 16], state_cache=cache,
                           advance_budget=7)
    assert r2.x is None and r2.niterations == 11
    # finish without a budget; must equal the uninterrupted solve
    r_fin = tk.solve_deflated(op, b, cfg, m=6, storage="df64",
                              checkpoints=[8, 16], state_cache=cache)
    r_ref = tk.solve_deflated(op, b, cfg, m=6, storage="df64",
                              checkpoints=[8, 16])
    # interim checkpoints evaluated AFTER a resume see the cumulative
    # sweep-overlap telemetry of later steps (conservative proxy), so only
    # the deciding checkpoint and the solution are bit-comparable
    assert r_fin.certified_bound[-1] == r_ref.certified_bound[-1]
    assert r_fin.relative_residual[-1] == r_ref.relative_residual[-1]
    np.testing.assert_array_equal(np.asarray(r_fin.x.factors),
                                  np.asarray(r_ref.x.factors))
