"""Bundle Adjustment in the Large (BAL) dataset support.

Port of baspacho_tpu/bal.py (the reference's
benchmarking/BaAtLarge.{h,cpp}): load/save of the BAL text format and
the Snavely reprojection model. The data side (BalProblem, load_bal,
save_bal, snavely_project_np, make_random_bal) is a numpy copy of the
JAX package's, so both packages make the same scene from a seed; the
residual is a torch function, vmapped over observations by the optimizer
with Jacobians from forward-mode autodiff through the Rodrigues rotation
(the reference hand-derives them, BaAtLarge.h:57-152).

BAL camera parameterization (9): [r (Rodrigues axis-angle, 3), t (3),
f, k1, k2]. Projection: P = R x + t; p = -(P.x, P.y)/P.z;
proj = f * (1 + k1 |p|^2 + k2 |p|^4) * p.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BalProblem:
    cameras: np.ndarray   # (num_cams, 9)
    points: np.ndarray    # (num_pts, 3)
    obs_cam: np.ndarray   # (num_obs,)
    obs_pt: np.ndarray    # (num_obs,)
    obs_uv: np.ndarray    # (num_obs, 2)

    @property
    def num_cameras(self):
        return len(self.cameras)

    @property
    def num_points(self):
        return len(self.points)

    @property
    def num_observations(self):
        return len(self.obs_cam)


def load_bal(path: str) -> BalProblem:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        txt = f.read().split()
    it = iter(txt)
    ncam, npt, nobs = int(next(it)), int(next(it)), int(next(it))
    obs_cam = np.empty(nobs, dtype=np.int64)
    obs_pt = np.empty(nobs, dtype=np.int64)
    obs_uv = np.empty((nobs, 2))
    for i in range(nobs):
        obs_cam[i] = int(next(it))
        obs_pt[i] = int(next(it))
        obs_uv[i] = (float(next(it)), float(next(it)))
    rest = np.array([float(x) for x in it])
    cams = rest[:ncam * 9].reshape(ncam, 9)
    pts = rest[ncam * 9:ncam * 9 + npt * 3].reshape(npt, 3)
    return BalProblem(cams, pts, obs_cam, obs_pt, obs_uv)


def save_bal(path: str, p: BalProblem) -> None:
    with open(path, "w") as f:
        f.write(f"{p.num_cameras} {p.num_points} {p.num_observations}\n")
        for c, q, uv in zip(p.obs_cam, p.obs_pt, p.obs_uv):
            f.write(f"{c} {q} {uv[0]:.16e} {uv[1]:.16e}\n")
        for cam in p.cameras:
            f.write("\n".join(f"{v:.16e}" for v in cam) + "\n")
        for pt in p.points:
            f.write("\n".join(f"{v:.16e}" for v in pt) + "\n")


def rodrigues_rotate(r, x):
    """Rotate points x (..., 3) by axis-angle r (..., 3)."""
    theta2 = torch.sum(r * r, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < 1e-14
    k = r / torch.where(small, torch.ones_like(theta), theta)
    c = torch.cos(theta)
    s = torch.sin(theta)
    kxx = torch.linalg.cross(k, x, dim=-1)
    kdx = torch.sum(k * x, dim=-1, keepdim=True)
    rot = c * x + s * kxx + (1.0 - c) * kdx * k
    # first-order fallback near zero angle
    return torch.where(small, x + torch.linalg.cross(r, x, dim=-1), rot)


def snavely_project(camera, point):
    """BAL/Snavely projection. camera (9,), point (3,) -> (2,)."""
    r, t = camera[:3], camera[3:6]
    f, k1, k2 = camera[6], camera[7], camera[8]
    p = rodrigues_rotate(r, point) + t
    xp = -p[:2] / p[2]
    n2 = torch.sum(xp * xp)
    dist = 1.0 + k1 * n2 + k2 * n2 * n2
    return f * dist * xp


def reprojection_residual(point, camera, uv):
    return snavely_project(camera, point) - uv


def snavely_project_np(cameras, points):
    """Vectorized host (NumPy) Snavely projection for data generation.
    cameras (N, 9), points (N, 3) -> (N, 2)."""
    r, t = cameras[:, :3], cameras[:, 3:6]
    f, k1, k2 = cameras[:, 6:7], cameras[:, 7:8], cameras[:, 8:9]
    theta2 = np.sum(r * r, axis=-1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, 1e-30))
    small = theta2 < 1e-14
    k = r / np.where(small, 1.0, theta)
    c, s = np.cos(theta), np.sin(theta)
    kxx = np.cross(k, points)
    kdx = np.sum(k * points, axis=-1, keepdims=True)
    rot = c * points + s * kxx + (1.0 - c) * kdx * k
    p = np.where(small, points + np.cross(r, points), rot) + t
    xp = -p[:, :2] / p[:, 2:3]
    n2 = np.sum(xp * xp, axis=-1, keepdims=True)
    return f * (1.0 + k1 * n2 + k2 * n2 * n2) * xp


def make_random_bal(n_cams=6, n_pts=50, track_len=4, seed=0,
                    noise=0.0, track_mode="uniform", window=20,
                    loop_frac=0.05) -> BalProblem:
    """Synthetic BAL-style problem for tests/benchmarks (the reference
    ships real downloads; this generates a consistent random scene).

    track_mode:
      * "uniform" — each point seen by track_len cameras drawn uniformly
        (worst-case camera coupling; the reduced camera system densifies).
      * "window"  — cameras form a trajectory; each point is seen by
        track_len cameras inside a `window`-wide segment, with a
        `loop_frac` fraction of points spanning a random long-range pair
        of segments (loop closures). This matches real BAL capture
        sessions and gives the camera-locality structure large-scale
        solvers exploit; points come out sorted by first camera.
    """
    rng = np.random.RandomState(seed)
    pts = rng.rand(n_pts, 3) * 4 - 2 + np.array([0, 0, 8.0])
    cams = np.zeros((n_cams, 9))
    cams[:, :3] = rng.randn(n_cams, 3) * 0.05       # small rotations
    cams[:, 3:6] = rng.randn(n_cams, 3) * 0.5
    cams[:, 5] -= 2.0                                # pull back in z
    cams[:, 6] = 500.0 + rng.rand(n_cams) * 100     # focal
    cams[:, 7] = rng.randn(n_cams) * 1e-4
    cams[:, 8] = rng.randn(n_cams) * 1e-6
    obs_cam, obs_pt = [], []
    tl = min(track_len, n_cams)
    if track_mode == "window":
        w = min(window, n_cams)
        k = min(tl, w)
        base = np.sort(rng.randint(0, max(1, n_cams - w), size=n_pts))
        # vectorized distinct-sample-of-k-from-w per point
        offs = np.argsort(rng.rand(n_pts, w), axis=1)[:, :k]
        seen = base[:, None] + offs
        loop = rng.rand(n_pts) < loop_frac  # loop closure: retarget half
        nloop = int(loop.sum())
        if nloop:
            lo2 = rng.randint(0, max(1, n_cams - w), size=nloop)
            offs2 = np.argsort(rng.rand(nloop, w), axis=1)[:, :k - k // 2]
            seen[loop, k // 2:] = lo2[:, None] + offs2
        obs_cam = seen.ravel()
        obs_pt = np.repeat(np.arange(n_pts), k)
    else:
        for p in range(n_pts):
            seen = rng.choice(n_cams, size=tl, replace=False)
            for c in seen:
                obs_cam.append(c)
                obs_pt.append(p)
    obs_cam = np.array(obs_cam)
    obs_pt = np.array(obs_pt)
    uv = snavely_project_np(cams[obs_cam], pts[obs_pt])
    uv = uv + rng.randn(*uv.shape) * noise
    return BalProblem(cams, pts, obs_cam, obs_pt, uv)


def build_ba_optimizer(problem: BalProblem, huber: float = -1.0,
                       fix_first_cam: bool = True, device=None):
    """Factor-graph optimizer for a BAL problem with Schur-eliminated
    points (mirrors examples/OptimizeBaAtLarge.cpp + BaAtLargeBench.cpp:
    points registered first, then moved to a sparse elimination range),
    on `device` (default: the CUDA card, see Optimizer). Returns (opt,
    points family id, cameras family id)."""
    from .optimizer import Optimizer, VariableFamily
    from .optimizer.soft_loss import HuberLoss

    opt = Optimizer(device=device)
    pts = opt.add_variable_family(
        VariableFamily(problem.points.copy(), name="points"))
    cams = opt.add_variable_family(
        VariableFamily(problem.cameras.copy(), name="cameras"))
    loss = HuberLoss(huber) if huber > 0 else None
    opt.add_factor_family(
        reprojection_residual,
        [(pts, problem.obs_pt), (cams, problem.obs_cam)],
        consts=(problem.obs_uv,), loss=loss)
    if fix_first_cam:
        target = problem.cameras[:1].copy()

        def prior(cam, tgt):
            return 1e3 * (cam - tgt)

        opt.add_factor_family(prior, [(cams, np.array([0]))],
                              consts=(target,))
    opt.set_elimination_families([pts])
    return opt, pts, cams
