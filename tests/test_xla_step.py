"""The plain XLA Krylov steps against a dense numpy oracle.

S steps of ops/orth.py's Lanczos (always-reorthogonalized) and Arnoldi
(CGS2) recurrences must reproduce an independent numpy f64 Arnoldi
(modified Gram–Schmidt, twice) on the same dense factors: the same
orthonormal basis, the same projected matrix, and the Arnoldi relation
A V_S = V_{S+1} H. Bandwidth 1 is the Laplace factor (offsets -1..1),
bandwidth 2 the convection–diffusion factor (offsets -1..2).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tensorkrylov as tk
from tensorkrylov.models.gallery import bands_to_dense
from tensorkrylov.ops.orth import arnoldi_step, init_state, lanczos_step


def _oracle(A, b, S):
    """Numpy Arnoldi (MGS twice) for one factor: V (n, S+1), H (S+1, S)."""
    n = A.shape[0]
    V = np.zeros((n, S + 1))
    H = np.zeros((S + 1, S))
    V[:, 0] = b / np.linalg.norm(b)
    for j in range(S):
        w = A @ V[:, j]
        for _ in range(2):
            for i in range(j + 1):
                c = V[:, i] @ w
                H[i, j] += c
                w = w - c * V[:, i]
        H[j + 1, j] = np.linalg.norm(w)
        V[:, j + 1] = w / H[j + 1, j]
    return V, H


@pytest.mark.parametrize("S", [1, 3, 7])
@pytest.mark.parametrize("family", ["laplace", "conv_diff"])
def test_xla_step_matches_dense_oracle(S, family):
    d, n = 2, 24
    if family == "laplace":
        op = tk.laplace(d, n)
        step = lambda st, b, k: lanczos_step(  # noqa: E731
            op, st, b, k, reorth=True, proj_dtype=jnp.float64)
    else:
        op = tk.conv_diff(d, n)
        assert max(abs(o) for o in op.offsets) == 2
        step = lambda st, b, k: arnoldi_step(  # noqa: E731
            op, st, b, k, proj_dtype=jnp.float64)
    b = jnp.asarray(np.random.default_rng(1).standard_normal((d, n)))
    state, _ = init_state(op, b, S, jnp.float64)
    for k in range(1, S + 1):
        state, _ = step(state, b, k)
    A = bands_to_dense(op)
    V = np.asarray(state.V)          # (K, d, n)
    H = np.asarray(state.H)          # (d, K, K)
    for s in range(d):
        V_ref, H_ref = _oracle(A[s], np.asarray(b[s]), S)
        Vs = V[:, s, :].T            # (n, S+1)
        np.testing.assert_allclose(Vs, V_ref, atol=1e-12)
        np.testing.assert_allclose(H[s, : S + 1, :S], H_ref, atol=1e-10)
        resid = A[s] @ Vs[:, :S] - Vs @ H[s, : S + 1, :S]
        assert np.max(np.abs(resid)) < 1e-10 * np.max(np.abs(A[s]))
