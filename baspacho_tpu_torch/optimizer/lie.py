"""Minimal SE(3) Lie group ops on tensors (batched).

Port of baspacho_tpu/optimizer/lie.py (the reference's Sophus SE3 through
the VarUtil trait, Optimizer.h:80-96: DataDim 7 quaternion + translation,
TangentDim 6, tangentStep = exp(step) * value). Values are (..., 7)
tensors [qx, qy, qz, qw, tx, ty, tz]. Every branch is a torch.where over
guarded operands, so torch.func.vmap and forward-mode Jacobians see no
NaN at zero angle.
"""

from __future__ import annotations

import torch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _quat_mul(a, b):
    ax, ay, az, aw = torch.unbind(a, dim=-1)
    bx, by, bz, bw = torch.unbind(b, dim=-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def _quat_rotate(q, v):
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


class SE3:
    DATA_DIM = 7
    TANGENT_DIM = 6

    @staticmethod
    def identity(dtype=torch.float64):
        return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype)

    @staticmethod
    def exp(tangent):
        """tangent (..., 6) = [v (trans), w (rot)] -> SE3 (..., 7)."""
        v = tangent[..., :3]
        w = tangent[..., 3:]
        theta2 = torch.sum(w * w, dim=-1, keepdim=True)
        theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
        small = theta2 < 1e-12
        # quaternion from rotation vector
        half = 0.5 * theta
        sinc = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
        q = torch.cat([w * sinc,
                       torch.where(small, 1.0 - theta2 / 8.0,
                                   torch.cos(half))], dim=-1)
        # V matrix applied to v (closed form; series for small angles)
        wxv = _cross(w, v)
        wxwxv = _cross(w, wxv)
        a = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) /
                        torch.clamp(theta2, min=1e-30))
        b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                        (theta - torch.sin(theta)) /
                        torch.clamp(theta2 * theta, min=1e-30))
        t = v + a * wxv + b * wxwxv
        return torch.cat([q, t], dim=-1)

    @staticmethod
    def compose(a, b):
        qa, ta = a[..., :4], a[..., 4:]
        qb, tb = b[..., :4], b[..., 4:]
        return torch.cat([_quat_mul(qa, qb), ta + _quat_rotate(qa, tb)],
                         dim=-1)

    @staticmethod
    def transform(pose, point):
        """Apply SE3 (..., 7) to points (..., 3)."""
        return _quat_rotate(pose[..., :4], point) + pose[..., 4:]

    @staticmethod
    def tangent_step(value, step):
        """Left-multiplicative update: exp(step) * value (the reference's
        Sophus convention, Optimizer.h:93)."""
        return SE3.compose(SE3.exp(step), value)

    @staticmethod
    def normalize(value):
        q = value[..., :4]
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        return torch.cat([q, value[..., 4:]], dim=-1)
