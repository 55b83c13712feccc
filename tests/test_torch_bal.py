"""The port's BAL support (baspacho_tpu_torch.bal) against the JAX
package, f64, on the CPU: the Rodrigues rotation, the Snavely projection
and its forward-mode Jacobians, the text format, the synthetic scenes
(bitwise the same arrays), and LM on the scenarios of tests/test_bal.py
through testing/flows.py's ba_optimizer, the flow chip_smoke.py runs on
BAL 871 on the card: cost trajectories within 1e-10 of the initial cost,
directly and through the partial factor + PCG with BlockJacobiPrecond."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baspacho_tpu as J
from baspacho_tpu import bal as JB
from baspacho_tpu.optimizer import BlockJacobiPrecond, OptimizerSettings
import baspacho_tpu_torch as T
from baspacho_tpu_torch import bal as TB
from baspacho_tpu_torch.testing.flows import ba_optimizer, ba_settings
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)


def test_rodrigues_matches_jax_and_the_matrix():
    rng = np.random.RandomState(0)
    r = rng.randn(8, 3)
    r[0] = 1e-9  # the first-order branch
    x = rng.randn(8, 3)
    got = TB.rodrigues_rotate(torch.from_numpy(r), torch.from_numpy(x))
    want = np.asarray(JB.rodrigues_rotate(jnp.asarray(r), jnp.asarray(x)))
    assert np.max(np.abs(got.numpy() - want)) < 1e-15
    for i in range(1, 8):
        theta = np.linalg.norm(r[i])
        k = r[i] / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
        assert np.max(np.abs(got[i].numpy() - R @ x[i])) < 1e-12


def test_snavely_projection_and_jacobians_match_jax():
    prob = JB.make_random_bal(n_cams=4, n_pts=6, seed=3, noise=0.3)
    cams, pts = prob.cameras[prob.obs_cam], prob.points[prob.obs_pt]
    cams[0, :3] = 0.0  # a camera at zero rotation
    jf = jax.vmap(jax.jacfwd(JB.reprojection_residual, argnums=(0, 1)))
    tf = torch.func.vmap(torch.func.jacfwd(TB.reprojection_residual,
                                           argnums=(0, 1)))
    args = (pts, cams, prob.obs_uv)
    jr = jax.vmap(JB.reprojection_residual)(*map(jnp.asarray, args))
    tr = torch.func.vmap(TB.reprojection_residual)(
        *map(torch.from_numpy, args))
    assert np.max(np.abs(tr.numpy() - np.asarray(jr))) < 1e-10
    for a, b in zip(tf(*map(torch.from_numpy, args)),
                    jf(*map(jnp.asarray, args))):
        assert np.isfinite(a.numpy()).all()
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= \
            1e-13 * np.max(np.abs(np.asarray(b)))
    np_proj = TB.snavely_project_np(cams, pts)
    t_proj = torch.func.vmap(TB.snavely_project)(torch.from_numpy(cams),
                                                 torch.from_numpy(pts))
    assert np.max(np.abs(t_proj.numpy() - np_proj)) < 1e-10


@pytest.mark.parametrize("mode", ["uniform", "window"])
def test_make_random_bal_matches_jax_bitwise(mode):
    kw = dict(n_cams=30, n_pts=200, track_len=5, seed=7, noise=0.5,
              track_mode=mode, window=8, loop_frac=0.1)
    a, b = JB.make_random_bal(**kw), TB.make_random_bal(**kw)
    for k in ("cameras", "points", "obs_cam", "obs_pt", "obs_uv"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_bal_roundtrip_and_jax_files(tmp_path):
    p = TB.make_random_bal(n_cams=3, n_pts=10, seed=1)
    path = os.path.join(tmp_path, "port.txt")
    TB.save_bal(path, p)
    q = TB.load_bal(path)
    for k in ("cameras", "points", "obs_cam", "obs_pt", "obs_uv"):
        assert np.array_equal(getattr(p, k), getattr(q, k)), k
    jpath = os.path.join(tmp_path, "jax.txt")
    JB.save_bal(jpath, JB.make_random_bal(n_cams=3, n_pts=10, seed=1))
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()


def noisy(prob, cam_noise: bool, seed: int):
    """The perturbed starts of tests/test_bal.py:42-68."""
    cams = prob.cameras.copy()
    if cam_noise:
        cams = cams + np.random.RandomState(seed).randn(*cams.shape) * \
            np.array([1e-3, 1e-3, 1e-3, 1e-2, 1e-2, 1e-2, 0, 0, 0])
        seed += 1
    pts = prob.points + np.random.RandomState(seed).randn(
        *prob.points.shape) * 0.02
    return cams, pts


@pytest.mark.parametrize("case,backend", [
    ("direct", "REF"), ("direct", "PLANNED"), ("pcg", "REF"),
    ("pcg", "PLANNED")])
def test_ba_lm_matches_jax(case, backend):
    """test_bal.py's two scenarios: from a noisy start, directly (seed 2,
    cameras and points perturbed, 20 iterations) and with the partial
    factor + PCG (seed 5, points perturbed, 15 iterations)."""
    pcg = case == "pcg"
    seed, iters = (5, 15) if pcg else (2, 20)
    prob = JB.make_random_bal(n_cams=5, n_pts=60, track_len=4, seed=seed)
    cams, pts = noisy(prob, not pcg, 6 if pcg else 3)
    jp = JB.BalProblem(cams, pts, prob.obs_cam, prob.obs_pt, prob.obs_uv)
    tp = TB.BalProblem(cams, pts, prob.obs_cam, prob.obs_pt, prob.obs_uv)
    jo = JB.build_ba_optimizer(jp)[0]
    js = OptimizerSettings(max_iters=iters,
                           backend=getattr(J.BackendType, backend),
                           **({"use_pcg": True,
                               "precond": BlockJacobiPrecond,
                               "pcg_tol": 1e-10, "pcg_max_iters": 80}
                              if pcg else {}))
    sj = jo.optimize(js)
    ts = ba_settings(getattr(T.BackendType, backend), iters, pcg=pcg)
    to = ba_optimizer(tp, ts, "cpu")
    st = to.optimize(ts)
    assert to.solver.sparse_elim_ranges[:2] == [0, 60]
    cj, ct = sj["costs"], st["costs"]
    print(case, backend, cj, ct, st["pcg_iters"])
    n = min(len(cj), len(ct))
    assert abs(len(cj) - len(ct)) <= 1
    assert np.max(np.abs(np.subtract(cj[:n], ct[:n]))) <= 1e-10 * cj[0]
    assert st["final_cost"] < (1e-8 if pcg else 1e-9)
    for fam_j, fam_t in zip(jo.families, to.families):
        np.testing.assert_allclose(fam_t.values.numpy(),
                                   np.asarray(fam_j.values), rtol=0,
                                   atol=1e-6)
