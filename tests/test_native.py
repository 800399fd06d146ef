"""Native (C++) host runtime vs pure-Python oracles."""
import numpy as np
import pytest

from tensorkrylov import native
from tensorkrylov.models.gallery import dense_to_bands as py_dense_to_bands


needs_native = pytest.mark.skipif(not native.available(), reason="no toolchain")


def _bands(d, n, dtype):
    bands = np.zeros((d, 3, n), dtype)
    bands[:, 0, 1:] = -1.0
    bands[:, 1, :] = 2.0
    bands[:, 2, :-1] = -1.0
    return bands


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_native_spmv_matches_numpy(dtype, rng):
    d, n = 3, 1000
    bands = _bands(d, n, dtype)
    v = rng.standard_normal((d, n)).astype(dtype)
    u = native.banded_spmv(bands, (-1, 0, 1), v)
    oracle = np.zeros_like(v)
    oracle[:, 1:] += bands[:, 0, 1:] * v[:, :-1]
    oracle += bands[:, 1] * v
    oracle[:, :-1] += bands[:, 2, :-1] * v[:, 1:]
    np.testing.assert_allclose(u, oracle, rtol=1e-6 if dtype == np.float32 else 1e-14)


@needs_native
def test_native_dense_to_bands(rng):
    mats = rng.standard_normal((2, 40, 40))
    mats[:, np.abs(np.subtract.outer(np.arange(40), np.arange(40))) > 3] = 0.0
    nb, no = native.dense_to_bands(mats)
    pb, po = py_dense_to_bands(mats)
    assert no == tuple(po)
    np.testing.assert_allclose(nb, pb)


@needs_native
def test_native_bh_parser_matches_python():
    import os
    from tensorkrylov.coeffs.preprocess import parse_coefficient_file, DEFAULT_SRC

    if not os.path.isdir(DEFAULT_SRC):
        pytest.skip("raw coefficient files not present")
    path = os.path.join(DEFAULT_SRC, "1_xk04.3_1")
    om_n, al_n = native.parse_bh_file(path, 4)
    om_p, al_p = parse_coefficient_file(path, 4)
    np.testing.assert_allclose(om_n, om_p)
    np.testing.assert_allclose(al_n, al_p)
