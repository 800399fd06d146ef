"""Core pytree data structures.

Array-native analogues of the reference's tensor structures
(/root/reference/src/tensor_struct.jl): the Kronecker-sum operator is stored
as stacked DIA bands ``(d, nb, n)`` instead of a list of per-factor sparse
matrices, and the CP/Kruskal tensor stacks its factor matrices into a single
``(d, n, t)`` array. Everything is a registered pytree with static shapes so
it can live inside jit/while_loop.
"""
from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _pytree_dataclass(cls=None, *, static: Tuple[str, ...] = ()):
    """Register a dataclass as a JAX pytree with some static (aux) fields."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        fields = [f.name for f in dataclasses.fields(c)]
        data_fields = tuple(f for f in fields if f not in static)

        def flatten(obj):
            return (
                tuple(getattr(obj, f) for f in data_fields),
                tuple(getattr(obj, f) for f in static),
            )

        def unflatten(aux, children):
            kwargs = dict(zip(data_fields, children))
            kwargs.update(dict(zip(static, aux)))
            return c(**kwargs)

        jax.tree_util.register_pytree_node(c, flatten, unflatten)
        return c

    if cls is None:
        return wrap
    return wrap(cls)


@_pytree_dataclass(static=("offsets", "symmetric", "halo"))
class KroneckerSumOperator:
    """A = Σ_s I⊗…⊗A_s⊗…⊗I, stored as per-factor DIA bands.

    bands[s, b, i] = A_s[i, i + offsets[b]] for 0 <= i + offsets[b] < n,
    zero-padded outside that range (so shift-multiply-accumulate SpMV needs
    no edge masking). Replaces the reference's ``Vector`` of sparse/dense
    factors (/root/reference/src/tensor_struct.jl:168-231).

    Attributes:
      bands: (d, nb, n) array.
      offsets: static tuple of nb ints (diagonal offsets).
      symmetric: static bool — SPD factors (Lanczos path) vs general
        (Arnoldi path); the analogue of the reference's Sym/NonSymInstance
        trait (/root/reference/src/tensor_struct.jl:83-85).
      halo: static SpMV communication override. None → portable jnp rolls
        (GSPMD lowers them to collective-permutes under sharding).
        (mesh, mode_axis, factor_axis_or_None) → every spmv() on this
        operator runs the explicit shard_map + ppermute halo-exchange path
        (parallel/halo.py) over that mesh — the latency-hiding layout for
        multi-host mode sharding. Set via parallel.sharding.solve_sharded
        (comm='ring').
    """

    bands: jax.Array
    offsets: Tuple[int, ...]
    symmetric: bool = True
    halo: Any = None

    @property
    def d(self) -> int:
        return self.bands.shape[0]

    @property
    def n(self) -> int:
        return self.bands.shape[2]

    @property
    def nnz_per_factor(self) -> int:
        """Nonzeros of one factor (band lengths, exact for DIA storage)."""
        n = self.n
        return sum(n - abs(o) for o in self.offsets)

    @property
    def dtype(self):
        return self.bands.dtype

    def astype(self, dtype) -> "KroneckerSumOperator":
        return KroneckerSumOperator(
            self.bands.astype(dtype), self.offsets, self.symmetric, self.halo
        )


@_pytree_dataclass
class CPTensor:
    """Rank-t CP (Kruskal) tensor: Σ_j weights[j] · ⊗_s factors[s, :, j].

    Stacked-factor analogue of the reference's KruskalTensor
    (/root/reference/src/tensor_struct.jl:283-316).

    Attributes:
      weights: (t,) array (λ in the reference).
      factors: (d, n, t) array.
    """

    weights: jax.Array
    factors: jax.Array

    @property
    def d(self) -> int:
        return self.factors.shape[0]

    @property
    def n(self) -> int:
        return self.factors.shape[1]

    @property
    def rank(self) -> int:
        return self.factors.shape[2]


class Status(enum.IntEnum):
    """Solver status — replaces the reference's println/exception signalling
    (/root/reference/src/tensor_krylov_method.jl:89,114,122 and
    /root/reference/src/utils.jl:7-14)."""

    RUNNING = 0
    CONVERGED = 1
    BREAKDOWN = 2      # compressed-norm breakdown (negative squared norm)
    MAXITER = 3
    LUCKY_BREAKDOWN = 4  # Lanczos/Arnoldi beta == 0


# ---------------------------------------------------------------------------
# Config


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration.

    Replaces the reference's type-level dispatch (Instance trait,
    MatrixGallery class, TensorDecomposition selection — SURVEY.md §5
    "Config / flag system").
    """

    kmax: int = 128                  # max Krylov iterations (nmax in reference)
    tol: float = 1e-9
    # 'lanczos' (plain TTR) | 'lanczos_reorth' (always-on extra CGS sweep) |
    # 'lanczos_reorth_auto' (loss-probe-triggered sweep — the reference's
    # on-demand semantics, /root/reference/src/orthogonal_bases.jl:119-131) |
    # 'arnoldi' (CGS2)
    orth: str = "lanczos_reorth"
    # spectral estimation source for the exp-sum interval:
    #  'H'                — Ritz values of projected H_s (default; tightest)
    #  'A_minor'          — eigvals of k×k minors of A_s (reference semantics,
    #                       /root/reference/src/eigenvalues.jl:326-333)
    #  'analytic_laplace' — closed-form Laplace spectrum
    #                       (/root/reference/src/eigenvalues.jl:226-265)
    spectral_source: str = "H"
    tmax: int = 63                   # max exponential-sum rank (table width)
    basis_dtype: Any = jnp.float64   # dtype of V / SpMV / orth GEMMs
    proj_dtype: Any = jnp.float64    # dtype of projected algebra (keep f64)
    identical_factors: bool = False  # fast path: all A_s equal (reference
                                     # assumes this, /root/reference/src/utils.jl:509)
    # residual check cadence (1 = every iteration, like the reference)
    check_every: int = 1
    # trigger threshold for orth='lanczos_reorth_auto': probe |⟨v_k, v_0⟩|
    # above this runs a full CGS sweep. 0.0 → √eps of the compute dtype
    # (the reference's √eps, /root/reference/src/orthogonal_bases.jl:125).
    reorth_tol: float = 0.0
    # Eigendecomposition of the projected H minors:
    #  'auto'          — 'dense'
    #  'dense'         — jnp.linalg.eigh
    #  'tridiag_mixed' — f32 seed + f64 Sturm refinement + inverse iteration
    #                    (Lanczos/symmetric path only)
    eigh_impl: str = "auto"
    # Nonsymmetric projected exp-sum evaluation:
    #  'auto' — solver.NONSYM_SOLVE_AUTO ('eig' in host-projected runs)
    #  'expm' — t LU-free Taylor-SS matrix exponentials
    #  'eig'  — one complex eigendecomposition + t diagonal scalings
    #           (~t× fewer matmuls)
    nonsym_solve_impl: str = "auto"
    # per-check progress via jax.debug.print from inside the jitted loop —
    # the analogue of the reference's DebugMode
    # (/root/reference/src/tensor_krylov_method.jl:6-8)
    debug: bool = False
    # Exponential-sum accuracy target: 'kappa' selects coefficients with
    # tabulated error ≤ tol/κ (the residual of the compressed solve is
    # bounded by ε·κ·‖b̃‖, so this is what actually certifies tol);
    # 'reference' uses tol directly like
    # /root/reference/src/approximation.jl:78-83 (whose solves floor at ε·κ).
    coeff_tol_scale: str = "kappa"
    # BH table row: 'ceil' = smallest tabulated R ≥ κ (spectrum fully inside
    # [1, R]); 'reference' = floor-to-first-digit like
    # /root/reference/src/approximation.jl:109-116
    bh_row_select: str = "ceil"
    # BREAKDOWN when r_comp² < −breakdown_rel·eps·(‖Hy‖²+‖b̃‖²): genuinely
    # negative beyond accumulated roundoff. Mild negativity (cancellation at
    # the f64 floor — where the reference throws and aborts,
    # /root/reference/src/utils.jl:395) is clamped to zero and iteration
    # continues on the boundary terms.
    breakdown_rel: float = 256.0
    # width of the cancellation noise band for the compressed residual:
    # computed r_comp² below cancel_floor_rel·eps·(‖Hy‖²+‖b̃‖²) is treated as
    # roundoff and replaced by min(computed + band, analytic ε·κ bound)
    cancel_floor_rel: float = 64.0

    def __post_init__(self):
        assert self.orth in (
            "lanczos", "lanczos_reorth", "lanczos_reorth_auto", "arnoldi"
        ), self.orth
        assert self.spectral_source in ("H", "A_minor", "analytic_laplace")
        assert self.coeff_tol_scale in ("kappa", "reference")
        assert self.bh_row_select in ("ceil", "reference")
        assert self.eigh_impl in ("auto", "dense", "tridiag_mixed", "host")
        assert self.nonsym_solve_impl in ("auto", "expm", "eig")


@_pytree_dataclass(static=("config",))
class SolveResult:
    """Solution + telemetry. The telemetry arrays are the analogue of the
    reference's ConvergenceData (/root/reference/src/convergence.jl:3-23),
    padded to kmax+1 and valid for indices 1..niterations."""

    x: CPTensor                      # lifted solution (d, n, t), weights (t,)
    status: jax.Array                # int32 Status
    niterations: jax.Array           # int32
    relative_residual: jax.Array     # (kmax+1,)
    projected_residual: jax.Array    # (kmax+1,) — r_comp
    orthogonality: jax.Array         # (kmax+1,) — loss estimate
    lambda_min: jax.Array            # (kmax+1,)
    lambda_max: jax.Array            # (kmax+1,)
    expsum_rank: jax.Array           # (kmax+1,) int32
    config: Any = None

    @property
    def converged(self):
        return self.status == Status.CONVERGED
