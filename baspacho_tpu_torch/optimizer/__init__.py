"""The port's optimizer layer: so far PCG and its four preconditioners
(the mixed direct/iterative solve of examples/pcg_sample.py). The LM
optimizer, its grad/Hessian assembly and BAL come with a later slice."""

from .pcg import pcg
from .preconditioner import (
    IdentityPrecond,
    BlockJacobiPrecond,
    BlockGaussSeidelPrecond,
    LowerPrecSolvePrecond,
)

__all__ = [
    "pcg", "IdentityPrecond", "BlockJacobiPrecond",
    "BlockGaussSeidelPrecond", "LowerPrecSolvePrecond",
]
