"""Contractions that assume exact f32 products.

The df64 and recorded-block pair GEMMs are exact only if no f32 product is rounded: on a GPU an f32 dot_general
without precision=HIGHEST may run in TF32, and XLA:GPU has no GEMM with f32
operands and an f64 result. Both faults show only on the card, so these
tests inspect the traced programs: every dot_general with f32 operands pins
HIGHEST, and none mixes f32 operands with an f64 result. (The programs
are traced through __wrapped__: their jits carry compiler options, which
JAX accepts on top-level jits only.)
"""
import jax
import jax.extend  # noqa: F401  (ClosedJaxpr / Jaxpr types)
import jax.numpy as jnp
import numpy as np
import pytest

from tensorkrylov.ops.precision import einsum

F32, F64 = np.dtype("float32"), np.dtype("float64")


def _subjaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in _subjaxprs(eqn.params):
            yield from _dot_generals(sub)


def _check_pinned(closed):
    dots = list(_dot_generals(closed.jaxpr))
    assert dots, "no dot_general traced"
    n_pair = 0
    for eqn in dots:
        ins = [np.dtype(v.aval.dtype) for v in eqn.invars]
        out = np.dtype(eqn.outvars[0].aval.dtype)
        assert not (F32 in ins and out == F64), f"f32 x f32 -> f64 GEMM: {eqn}"
        if F32 in ins or "HIGHEST" in str(eqn.params["precision"]):
            assert "HIGHEST" in str(eqn.params["precision"]), str(eqn)
            n_pair += 1
    return n_pair


def _df64_advance_jaxpr():
    from tensorkrylov.df64_core import _Df64State, _df64_advance

    d, n, K, Kp, m = 2, 64, 9, 16, 4
    f32, f64 = jnp.float32, jnp.float64
    z = lambda shape, dt: jnp.zeros(shape, dt)  # noqa: E731
    st = _Df64State(
        z((d, K), f64), z((d, K), f64), z((d, K), f64),
        z((d, n), f32), z((d, n), f32), z((d, n), f32), z((d, n), f32),
        z((d,), f64), z((), f64), z((), f64),
        z((Kp * d, n), f32), z((Kp * d, n), f32),
        z((d, Kp, Kp), f32), z((d, m, Kp), f32), z((d, K), f64))
    bands = z((d, 3, n), f32)
    fn = lambda bh, bl, s, bp, uh, ul: _df64_advance.__wrapped__(  # noqa: E731
        bh, bl, (-1, 0, 1), s, bp, uh, ul, jnp.asarray(1, jnp.int32), S=2)
    return jax.make_jaxpr(fn)(bands, bands, st, z((d, n), f64),
                              z((n, m), f32), z((n, m), f32))


def _df64_gram_jaxpr():
    from tensorkrylov.df64_core import _df64_gram_row_chunk

    V = jnp.zeros((32 * 2, 64), jnp.float32)
    return jax.make_jaxpr(
        lambda a, b: _df64_gram_row_chunk.__wrapped__(
            a, b, jnp.asarray(0, jnp.int32), jnp.asarray(3, jnp.int32),
            d=2))(V, V)


def _block_recorded_jaxpr():
    from tensorkrylov.block_recorded import _BlockRecState, _block_rec_advance

    d, n, Kp, R, m = 2, 64, 16, 2, 4
    f32, f64 = jnp.float32, jnp.float64
    z = lambda shape, dt: jnp.zeros(shape, dt)  # noqa: E731
    st = _BlockRecState(
        H=z((d, Kp, Kp), f64), btil=z((d, R, R), f64), dev=z((d, Kp), f64),
        dev0=z((d, R), f64), Vh=z((Kp * d, n), f32), Vl=z((Kp * d, n), f32),
        sweep_overlap=z((), f64), eta_w=z((d, Kp), f64), C=z((d, m, Kp), f64))
    bands = z((d, 3, n), f32)
    fn = lambda bh, bl, s, uh, ul: _block_rec_advance.__wrapped__(  # noqa: E731
        bh, bl, (-1, 0, 1), s, jnp.asarray(1, jnp.int32), uh, ul, S=1, R=R,
        deflated=True)
    return jax.make_jaxpr(fn)(bands, bands, st, z((n, m), f32), z((n, m), f32))


def _cross_check_gram_jaxpr():
    from tensorkrylov.utils.cp import _gram_chunk

    return jax.make_jaxpr(_gram_chunk)(jnp.zeros((2, 64, 5)))


@pytest.mark.parametrize("build", [
    _df64_advance_jaxpr, _df64_gram_jaxpr, _block_recorded_jaxpr,
    _cross_check_gram_jaxpr,
], ids=["df64_advance", "df64_gram", "block_recorded_advance",
        "cross_check_gram"])
def test_pair_products_pin_highest(build):
    assert _check_pinned(build()) > 0


def test_einsum_promotes_f32_operands_exactly():
    """f32 operands with an f64 result are promoted (exactly) before the
    GEMM, which then runs in f64 at HIGHEST."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((16, 4)).astype(np.float32)
    f = lambda x, y: einsum("ij,jk->ik", x, y,  # noqa: E731
                            preferred_element_type=jnp.float64)
    closed = jax.make_jaxpr(f)(a, b)
    (dot,) = list(_dot_generals(closed.jaxpr))
    assert [np.dtype(v.aval.dtype) for v in dot.invars] == [F64, F64]
    assert "HIGHEST" in str(dot.params["precision"])
    # exact products, f64 accumulation (summation order may differ)
    np.testing.assert_allclose(
        np.asarray(f(a, b)), a.astype(np.float64) @ b.astype(np.float64),
        rtol=1e-14, atol=1e-14)
