"""Robust loss functions for the LM optimizer.

Port of baspacho_tpu/optimizer/soft_loss.py (the reference's SoftLoss.h:
Trivial / Huber / Cauchy) on tensors, usable under torch.func.vmap and
forward-mode autodiff. Convention: given the squared residual s = ||r||^2,
`val(s)` is the robustified cost and `weight(s) = d val / d s` the IRLS
weight applied to the residual and the Jacobian.
"""

from __future__ import annotations

import torch


class TrivialLoss:
    def val(self, s):
        return s

    def weight(self, s):
        return torch.ones_like(s)


class HuberLoss:
    def __init__(self, b: float):
        self.b = float(b)

    def val(self, s):
        sq = torch.sqrt(torch.clamp(s, min=1e-30))
        return torch.where(s <= self.b * self.b, s,
                           2.0 * self.b * sq - self.b * self.b)

    def weight(self, s):
        sq = torch.sqrt(torch.clamp(s, min=1e-30))
        return torch.where(s <= self.b * self.b, torch.ones_like(s),
                           self.b / sq)


class CauchyLoss:
    def __init__(self, b: float = 1.0):
        self.b2 = float(b) * float(b)

    def val(self, s):
        return self.b2 * torch.log1p(s / self.b2)

    def weight(self, s):
        return 1.0 / (1.0 + s / self.b2)
