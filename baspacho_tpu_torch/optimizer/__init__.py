"""The port's optimizer layer: the Levenberg-Marquardt optimizer over
factor graphs with its gradient / Hessian assembly (K6), robust losses,
SE3, PCG and its four preconditioners (the mixed direct/iterative solve
of examples/pcg_sample.py). BAL bundle adjustment on top of it is
baspacho_tpu_torch.bal."""

from .soft_loss import TrivialLoss, HuberLoss, CauchyLoss
from .pcg import pcg
from .preconditioner import (
    IdentityPrecond,
    BlockJacobiPrecond,
    BlockGaussSeidelPrecond,
    LowerPrecSolvePrecond,
)
from .optimizer import (Optimizer, OptimizerSettings, VariableFamily,
                        mixed_solve)
from .lie import SE3

__all__ = [
    "TrivialLoss", "HuberLoss", "CauchyLoss", "pcg",
    "IdentityPrecond", "BlockJacobiPrecond", "BlockGaussSeidelPrecond",
    "LowerPrecSolvePrecond", "Optimizer", "OptimizerSettings",
    "VariableFamily", "mixed_solve", "SE3",
]
