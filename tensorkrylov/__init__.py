"""tensorkrylov — tensorized Krylov solver framework on JAX/XLA.

Solves A x = b for Kronecker-sum operators A = Σ_s I⊗…⊗A_s⊗…⊗I with
tensor-product right-hand sides, entirely in low-rank form, per
Kressner–Tobler (SIAM J. Matrix Anal. Appl. 31(4), 2010). Built from scratch
for JAX/XLA/Pallas; capability reference: thbake/TensorKrylov.jl
(see SURVEY.md / DESIGN.md at the repo root).
"""
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status
from .solver import solve, solve_multi_rhs, MultiRhsResult, solve_host_projected, solve_resumable
from .block import solve_block
from .block_recorded import BlockRecordedResult, solve_block_recorded
from .twopass import solve_two_pass
from .refine import solve_refined, RefinedResult, cp_residual
from .deflate import solve_deflated, deflation_basis, DeflationBasis, DeflatedResult
from .system import TensorizedSystem, random_rhs, solve_tensorized_system
from .models import gallery
from .models.gallery import (
    conv_diff,
    eigval_matrix,
    laplace,
    reaction_diffusion,
    operator_from_dense_factors,
    operator_from_ragged_factors,
    pad_ragged_rhs,
    rand_spd,
)
from .utils.cp import (
    cp_axpy,
    cp_dot,
    cp_full,
    cp_norm,
    cp_round,
    kron_apply_cp,
    kron_residual_dense,
)

__all__ = [
    "CPTensor",
    "KroneckerSumOperator",
    "SolveResult",
    "SolverConfig",
    "Status",
    "solve",
    "solve_multi_rhs",
    "MultiRhsResult",
    "solve_block",
    "solve_block_recorded",
    "BlockRecordedResult",
    "solve_two_pass",
    "solve_refined",
    "solve_deflated",
    "deflation_basis",
    "DeflationBasis",
    "DeflatedResult",
    "RefinedResult",
    "cp_residual",
    "cp_axpy",
    "cp_round",
    "kron_apply_cp",
    "TensorizedSystem",
    "random_rhs",
    "solve_tensorized_system",
    "gallery",
    "laplace",
    "reaction_diffusion",
    "conv_diff",
    "eigval_matrix",
    "rand_spd",
    "operator_from_dense_factors",
    "operator_from_ragged_factors",
    "pad_ragged_rhs",
    "cp_full",
    "cp_norm",
    "cp_dot",
    "kron_residual_dense",
]

__version__ = "0.1.0"
