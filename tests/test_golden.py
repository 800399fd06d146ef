"""Golden-trace regression: the full solver must reproduce a committed
convergence trajectory bit-for-bit-ish (numerical-parity analogue of the
reference's serialized reproduction_data, SURVEY.md §4)."""
import json
import os

import numpy as np
import jax.numpy as jnp

import tensorkrylov as tk
from tensorkrylov.types import SolverConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_laplace_d4_n100.json")


def test_golden_trace():
    with open(GOLDEN) as f:
        g = json.load(f)
    op = tk.laplace(g["d"], g["n"])
    b = tk.random_rhs(g["d"], g["n"], seed=g["seed"])
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    res = tk.solve(op, b, SolverConfig(kmax=g["n"], tol=g["tol"], orth=g["orth"]))
    assert int(res.status) == g["status"]
    assert int(res.niterations) == g["niterations"]
    rr = np.asarray(res.relative_residual)[1 : g["niterations"] + 1]
    ref = np.asarray(g["relative_residual"])
    np.testing.assert_allclose(rr, ref, rtol=1e-6)
