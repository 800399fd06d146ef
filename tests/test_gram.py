"""Lemma-3.4 residual algebra vs dense Kronecker oracles.

Mirrors the reference's utils testset (/root/reference/test/utils.jl — which
is commented out of its own runtests; ours actually runs)."""
import numpy as np
import jax.numpy as jnp
import pytest

from tensorkrylov.ops.gram import (
    residual_norm_sq,
    cp_gram_matrices,
    _mask_yz,
    mv_norm_sq,
    tensor_inner_prod,
    excluded_products,
)


def _dense_setup(rng, d=5, K=8, tmax=5, k=6, t=3, sym=True):
    H = rng.standard_normal((d, K, K))
    if sym:
        H = (H + H.transpose(0, 2, 1)) / 2
    Y = rng.standard_normal((d, K, tmax))
    Y[:, k:, :] = 0
    Y[:, :, t:] = 0
    btil = rng.standard_normal((d, K))
    btil[:, k:] = 0
    w = rng.standard_normal(tmax)
    w[t:] = 0
    subdiag = rng.standard_normal(d)
    return H, Y, btil, w, subdiag, k, t


def _dense_oracle(H, Y, btil, w, k):
    d, K, tmax = Y.shape
    Hm = H.copy()
    Hm[:, k:, :] = 0
    Hm[:, :, k:] = 0
    yfull = np.zeros(K**d)
    for j in range(tmax):
        acc = np.array([w[j]])
        for s in range(d):
            acc = np.kron(acc, Y[s, :, j])
        yfull += acc
    bfull = np.array([1.0])
    for s in range(d):
        bfull = np.kron(bfull, btil[s])
    T = yfull.reshape((K,) * d)
    Hy = np.zeros_like(T)
    for s in range(d):
        Hy += np.moveaxis(np.tensordot(Hm[s], T, axes=([1], [s])), 0, s)
    Hy = Hy.reshape(-1)
    return Hy, bfull


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.slow
def test_residual_terms_vs_dense(rng, sym):
    H, Y, btil, w, subdiag, k, t = _dense_setup(rng, sym=sym)
    Hy, bfull = _dense_oracle(H, Y, btil, w, k)
    terms = residual_norm_sq(
        jnp.asarray(H), jnp.asarray(Y), jnp.asarray(btil), k, jnp.asarray(w), jnp.asarray(subdiag)
    )
    r2_dense = np.sum((Hy - bfull) ** 2)
    np.testing.assert_allclose(float(terms.r_comp_sq), r2_dense, rtol=1e-10)

    Hm, Ym, btm = _mask_yz(jnp.asarray(H), jnp.asarray(Y), jnp.asarray(btil), k)
    Z, Gy, Gz, X = cp_gram_matrices(Hm, Ym)
    np.testing.assert_allclose(float(mv_norm_sq(Gy, Gz, X, jnp.asarray(w))), Hy @ Hy, rtol=1e-10)
    np.testing.assert_allclose(
        float(tensor_inner_prod(Ym, Z, btm, jnp.asarray(w))), Hy @ bfull, rtol=1e-10
    )


@pytest.mark.slow
def test_boundary_terms_vs_dense(rng):
    """Boundary = Σ_s h_s² · ‖y at index k-1 in mode s‖² (Lemma 3.4,
    /root/reference/src/utils.jl:402-443)."""
    H, Y, btil, w, subdiag, k, t = _dense_setup(rng)
    d, K, tmax = Y.shape
    terms = residual_norm_sq(
        jnp.asarray(H), jnp.asarray(Y), jnp.asarray(btil), k, jnp.asarray(w), jnp.asarray(subdiag)
    )
    # dense: materialize y, then for each mode s sum squares over the slab
    # with index k-1 in mode s
    yfull = np.zeros((K,) * d)
    for j in range(tmax):
        acc = np.array([w[j]])
        for s in range(d):
            acc = np.kron(acc, Y[s, :, j])
        yfull += acc.reshape((K,) * d)
    boundary = 0.0
    for s in range(d):
        slab = np.take(yfull, k - 1, axis=s)
        boundary += subdiag[s] ** 2 * np.sum(slab**2)
    np.testing.assert_allclose(float(terms.boundary_sq), boundary, rtol=1e-10)


def test_excluded_products(rng):
    G = rng.standard_normal((4, 3, 3))
    E = np.asarray(excluded_products(jnp.asarray(G)))
    for s in range(4):
        oracle = np.ones((3, 3))
        for m in range(4):
            if m != s:
                oracle = oracle * G[m]
        np.testing.assert_allclose(E[s], oracle, rtol=1e-12)
