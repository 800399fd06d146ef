"""Telemetry formatting/export."""
import json

import numpy as np
import jax.numpy as jnp

import tensorkrylov as tk
from tensorkrylov.convergence import trim, summarize, to_json
from tensorkrylov.types import SolverConfig


def _result():
    op = tk.laplace(2, 25)
    b = tk.random_rhs(2, 25, seed=3)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    return tk.solve(op, b, SolverConfig(kmax=25, tol=1e-8, check_every=3))


def test_trim_and_summarize():
    res = _result()
    t = trim(res)
    ni = int(res.niterations)
    assert len(t["relative_residual"]) == ni
    s = summarize(res)
    assert "TensorKrylov solve" in s and str(ni) in s


def test_to_json_roundtrip():
    res = _result()
    payload = json.loads(to_json(res))
    assert payload["status"] in ("CONVERGED", "MAXITER")
    assert len(payload["relative_residual"]) == payload["niterations"]
