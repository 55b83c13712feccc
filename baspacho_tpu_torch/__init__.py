"""baspacho_tpu_torch — the PyTorch/CUDA port of baspacho_tpu.

Batched supernodal sparse Cholesky on an NVIDIA Hopper GPU: the host
symbolic analysis (a numpy-only copy of baspacho_tpu's) emits static
level schedules; the numeric factor, solves and mat-vec run through
hand-written CUDA kernels (ops/kernels.py, csrc/), with plain PyTorch
twins on the CPU. On top, the Levenberg-Marquardt optimizer
(optimizer/, its gradient / Hessian assembly a kernel too) and BAL
bundle adjustment (bal.py). The package imports torch and numpy, never
jax and never baspacho_tpu.
"""

from .sparse_structure import SparseStructure
from .block_matrix import CoalescedBlockMatrixSkel
from .accessor import CoalescedAccessor, PermutedCoalescedAccessor
from .computation_model import ComputationModel
from .solver import (
    AddFillPolicy,
    BackendType,
    Settings,
    Solver,
    create_solver,
    skeleton_arrays,
    solver_from_skeleton,
)
from .utils import (
    cum_sum_vec,
    inverse_permutation,
    compose_permutations,
    left_permute,
)

__all__ = [
    "SparseStructure",
    "CoalescedBlockMatrixSkel",
    "CoalescedAccessor",
    "PermutedCoalescedAccessor",
    "ComputationModel",
    "AddFillPolicy",
    "BackendType",
    "Settings",
    "Solver",
    "create_solver",
    "skeleton_arrays",
    "solver_from_skeleton",
    "cum_sum_vec",
    "inverse_permutation",
    "compose_permutations",
    "left_permute",
]
