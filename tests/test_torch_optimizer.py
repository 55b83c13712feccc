"""The port's LM optimizer layer (baspacho_tpu_torch.optimizer) against
the JAX package, f64, on the CPU (the wrappers run their plain twins):

  * cost, gradient and Hessian data of compute_grad_hess, on REF and
    PLANNED, on the spring chain (with and without a Cauchy outlier), the
    SE3 bundle adjustment of tests/test_optimizer.py and a small BAL
    scene under a Huber loss; and on the SE3 BA against J^T r / J^T J
    computed densely;
  * K6's plan (ops/assembly.py), which only the CUDA kernel reads,
    evaluated record by record in numpy, and its plain twin;
  * CHUNK_OBS: chunked Jacobians give the same bits as one chunk;
  * LM cost trajectories per iteration (within 1e-10 of the initial
    cost, the same iteration count but where the stopping test sits at
    its threshold), directly and through the partial factor + PCG;
  * verify_jacobians, SE3 and the robust losses;
  * the device default: without a card and without a device,
    build_solver raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu.optimizer as JO
from baspacho_tpu import bal as JB
import baspacho_tpu_torch as T
import baspacho_tpu_torch.optimizer as TO
from baspacho_tpu_torch import bal as TB
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.assembly import LONG_SEG
from baspacho_tpu_torch.testing.flows import dense_normal_equations
from baspacho_tpu_torch.testing.problems import se3_ba, spring_chain
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

BACKENDS = ["REF", "PLANNED"]


def _bal(O, **kw):
    pkg = TB if O is TO else JB
    prob = pkg.make_random_bal(n_cams=6, n_pts=60, track_len=3, seed=4,
                               noise=0.5)
    return pkg.build_ba_optimizer(prob, huber=1.0, **kw)[0]


PROBLEMS = {
    "spring": lambda O, **kw: spring_chain(O, n=6, seed=3, **kw)[0],
    "spring_cauchy": lambda O, **kw: spring_chain(
        O, n=8, seed=1, outlier_loss=O.CauchyLoss(1.0), **kw)[0],
    "se3_ba": lambda O, **kw: se3_ba(O, **kw)[0],
    "bal_huber": _bal,
}


def both(problem, backend):
    """The problem's optimizer in both packages, solvers built."""
    jo = PROBLEMS[problem](JO)
    to = PROBLEMS[problem](TO, device="cpu")
    jo.build_solver(JO.OptimizerSettings(
        backend=getattr(J.BackendType, backend)))
    to.build_solver(TO.OptimizerSettings(
        backend=getattr(T.BackendType, backend)))
    return jo, to


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_grad_hess_matches_jax(problem, backend):
    jo, to = both(problem, backend)
    cj, gj, hj = jo.compute_grad_hess([f.values for f in jo.families])
    ct, gt, ht = to.compute_grad_hess([f.values for f in to.families])
    assert abs(float(ct) - float(cj)) <= 1e-12 * abs(float(cj))
    assert rel(gt.numpy(), gj) <= 1e-12
    assert rel(ht.numpy(), hj) <= 1e-12


def plan_reference(terms, plans, data_size, order):
    """K6's plan evaluated in numpy, the way csrc/grad_hess.cu reads it:
    every record of every segment adds sum_r W[f, r, tab_a + i] *
    W[f, r, tab_b + j] to element (i, j) of its block."""
    out = {"hess": np.zeros(data_size), "grad": np.zeros(order)}
    for (_, W), (_, p) in zip(terms, plans):
        W = W.numpy()
        ta, tb = p.tab_a.numpy(), p.tab_b.numpy()
        for name in ("hess", "grad"):
            s = getattr(p, name)
            ptr, rec, rows, cols, off, stride = (
                getattr(s, k).numpy() for k in ("ptr", "rec", "rows", "cols",
                                                "off", "stride"))
            seg = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
            f, q = rec // p.Q, rec % p.Q
            for i in range(int(rows.max(initial=0))):
                for j in range(int(cols.max(initial=0))):
                    m = (i < rows[seg]) & (j < cols[seg])
                    v = np.einsum("nr,nr->n", W[f[m], :, ta[q[m]] + i],
                                  W[f[m], :, tb[q[m]] + j])
                    np.add.at(out[name], off[seg[m]] + i * stride[seg[m]] + j,
                              v)
    return out["grad"], out["hess"]


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_k6_plan_and_twin_match_jax(problem):
    """The destination-sorted plan the CUDA kernel reads, and the plain
    twin, both against the JAX package's _accumulate_family result."""
    jo, to = both(problem, "PLANNED")
    _, gj, hj = jo.compute_grad_hess([f.values for f in jo.families])
    terms = to.jacobians([f.values for f in to.families])
    g, h = plan_reference(terms, to._plans, to.solver.data_size,
                          to.solver.order)
    assert rel(g, gj) <= 1e-12 and rel(h, hj) <= 1e-12
    gt = torch.zeros(to.solver.order, dtype=torch.float64)
    ht = torch.zeros(to.solver.data_size, dtype=torch.float64)
    for (_, W), (_, plan) in zip(terms, to._plans):
        kernels.grad_hess_twin(W, ht, gt, plan)
        for s in (plan.hess, plan.grad):
            n_seg = s.ptr.numel() - 1
            ids = torch.sort(torch.cat([s.short, s.long])).values
            assert torch.equal(ids, torch.arange(n_seg))
            assert bool((s.ptr.diff()[s.long] > LONG_SEG).all())
    assert rel(gt.numpy(), gj) <= 1e-12 and rel(ht.numpy(), hj) <= 1e-12


def test_plan_flips_the_point_camera_blocks():
    """BA: points are ordered first, so every point-camera block is
    stored as (camera rows, point columns), transposed."""
    to = PROBLEMS["bal_huber"](TO, device="cpu")
    to.build_solver(TO.OptimizerSettings(backend=T.BackendType.PLANNED))
    pairs = to._plans[0][1].pairs
    assert [(ti, tj) for _, ti, _, tj, *_ in pairs] == [(3, 3), (3, 9),
                                                        (9, 9)]
    assert bool(pairs[1][-1].all()) and not bool(pairs[0][-1].any())


def test_dense_normal_equations():
    """The assembled gradient and Hessian equal J^T r and J^T J of the
    SE3 BA computed densely."""
    to = PROBLEMS["se3_ba"](TO, device="cpu")
    to.build_solver(TO.OptimizerSettings(backend=T.BackendType.PLANNED))
    values = [f.values for f in to.families]
    _, grad, hdata = to.compute_grad_hess(values)
    g, H = dense_normal_equations(to, values)
    hd = to.solver.skel.densify(hdata.numpy(), fill_upper_half=True)
    assert rel(grad.numpy(), g) <= 1e-12
    assert rel(hd, H) <= 1e-12


def test_chunked_jacobians_are_bitwise_equal():
    """CHUNK_OBS bounds the Jacobian evaluation's memory only: K6 runs
    once over the family, so 16-factor chunks give the same bits."""
    def run(chunk):
        old = TO.Optimizer.CHUNK_OBS
        TO.Optimizer.CHUNK_OBS = chunk
        try:
            to = PROBLEMS["bal_huber"](TO, device="cpu")
            to.build_solver(TO.OptimizerSettings(
                backend=T.BackendType.PLANNED))
            return to.compute_grad_hess([f.values for f in to.families])
        finally:
            TO.Optimizer.CHUNK_OBS = old

    a, b = run(1 << 30), run(16)
    assert all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
               for x, y in zip(a, b))


def same_trajectory(cj, ct, settings):
    """Costs per iteration within 1e-10 of the initial cost; the same
    number of iterations, or one more on one side where the stopping
    test sat at its threshold (the two packages sum in other orders)."""
    n = min(len(cj), len(ct))
    assert abs(len(cj) - len(ct)) <= 1, (cj, ct)
    assert np.max(np.abs(np.subtract(cj[:n], ct[:n]))) <= 1e-10 * cj[0]
    if len(cj) != len(ct):
        longer = cj if len(cj) > len(ct) else ct
        last = (longer[-2] - longer[-1]) / longer[-2]
        assert last < 100 * settings.cost_rel_tol or \
            longer[-1] <= 1e-10 * cj[0], (cj, ct)


LM_CASES = {
    # (problem, max_iters, settings beyond max_iters and backend)
    "spring": (lambda O, **kw: spring_chain(O, **kw)[0], 20, {}),
    "se3_schur": (lambda O, **kw: se3_ba(O, **kw)[0], 15, {}),
    "se3_pcg": (lambda O, **kw: se3_ba(O, seed=2, **kw)[0], 15,
                {"use_pcg": True, "precond": "BlockJacobiPrecond",
                 "pcg_tol": 1e-10, "pcg_max_iters": 60}),
}


@pytest.mark.parametrize("case,backend", [
    ("spring", "REF"), ("se3_schur", "REF"), ("se3_schur", "PLANNED"),
    ("se3_pcg", "REF"), ("se3_pcg", "PLANNED")])
def test_lm_trajectory_matches_jax(case, backend):
    make, iters, extra = LM_CASES[case]
    stats = []
    for O, pkg, kw in ((JO, J, {}), (TO, T, {"device": "cpu"})):
        ex = dict(extra)
        if "precond" in ex:
            ex["precond"] = getattr(O, ex["precond"])
        settings = O.OptimizerSettings(
            max_iters=iters, backend=getattr(pkg.BackendType, backend), **ex)
        stats.append(make(O, **kw).optimize(settings))
    sj, st = stats
    print(case, backend, sj["costs"], st["costs"], st["pcg_iters"])
    same_trajectory(sj["costs"], st["costs"], settings)
    assert st["costs"][-1] < 1e-8 * st["costs"][0]


def test_robust_loss_holds_the_outlier():
    """tests/test_optimizer.py:84-95 in the port: the Cauchy-robustified
    outlier factor does not drag x_4 to 100."""
    opt, xs = spring_chain(TO, n=8, seed=1, outlier_loss=TO.CauchyLoss(1.0),
                           device="cpu")
    opt.optimize(TO.OptimizerSettings(max_iters=25))
    assert abs(float(opt.families[xs].values[4, 0]) - 4.0) < 0.5


def test_verify_jacobians():
    opt, _ = spring_chain(TO, device="cpu")
    assert opt.verify_jacobians()
    opt2 = TO.Optimizer(device="cpu")
    ys = opt2.add_variable_family(TO.VariableFamily(np.zeros((4, 1))))
    # |a| + a with JAX's derivative of |a| at 0 (1; torch.abs gives 0):
    # a kink exactly at the evaluation point, where finite differences
    # (1) and the forward-mode derivative (2) disagree
    opt2.add_factor_family(lambda a: torch.where(a >= 0, a, -a) + a,
                           [(ys, np.arange(4))])
    assert not opt2.verify_jacobians()
    se3, _, _ = se3_ba(TO, n_cams=3, n_pts=4, device="cpu")
    assert se3.verify_jacobians(epsilon=1e-6, max_relative_error=1e-4)


def test_se3_matches_jax():
    rng = np.random.RandomState(7)
    tang = rng.randn(6, 6) * 0.3
    tang[0, 3:] = 1e-8   # the small-angle series
    tang[1, 3:] = 0.0
    poses = np.array(JO.SE3.exp(jnp.asarray(rng.randn(6, 6) * 0.5)))
    pts = rng.randn(6, 3)
    for name, jv, tv in (
            ("exp", JO.SE3.exp(jnp.asarray(tang)),
             TO.SE3.exp(torch.from_numpy(tang))),
            ("compose", JO.SE3.compose(jnp.asarray(poses),
                                       jnp.asarray(poses[::-1])),
             TO.SE3.compose(torch.from_numpy(poses),
                            torch.from_numpy(poses[::-1].copy()))),
            ("tangent_step", JO.SE3.tangent_step(jnp.asarray(poses),
                                                 jnp.asarray(tang)),
             TO.SE3.tangent_step(torch.from_numpy(poses),
                                 torch.from_numpy(tang))),
            ("transform", JO.SE3.transform(jnp.asarray(poses),
                                           jnp.asarray(pts)),
             TO.SE3.transform(torch.from_numpy(poses),
                              torch.from_numpy(pts))),
            ("normalize", JO.SE3.normalize(jnp.asarray(poses * 1.5)),
             TO.SE3.normalize(torch.from_numpy(poses * 1.5)))):
        assert np.max(np.abs(tv.numpy() - np.asarray(jv))) < 1e-14, name
    # forward-mode derivatives at zero (the optimizer's Jacobian point)
    # are finite and equal JAX's
    import jax
    jj = jax.jacfwd(lambda d: JO.SE3.tangent_step(jnp.asarray(poses[0]), d))(
        jnp.zeros(6))
    tj = torch.func.jacfwd(lambda d: TO.SE3.tangent_step(
        torch.from_numpy(poses[0]), d))(torch.zeros(6, dtype=torch.float64))
    assert np.isfinite(tj.numpy()).all()
    assert np.max(np.abs(tj.numpy() - np.asarray(jj))) < 1e-14


@pytest.mark.parametrize("loss", ["TrivialLoss", "HuberLoss", "CauchyLoss"])
def test_soft_loss_matches_jax(loss):
    args = () if loss == "TrivialLoss" else (1.5,)
    s = np.array([0.0, 0.3, 2.25, 7.0, 1e4])
    jl, tl = getattr(JO, loss)(*args), getattr(TO, loss)(*args)
    for m in ("val", "weight"):
        want = np.asarray(getattr(jl, m)(jnp.asarray(s)))
        got = getattr(tl, m)(torch.from_numpy(s)).numpy()
        assert np.max(np.abs(got - want)) <= 1e-15 * np.max(np.abs(want))


def test_build_solver_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid")
    opt, _ = spring_chain(TO)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.build_solver(TO.OptimizerSettings())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.build_ba_optimizer(TB.make_random_bal())[0].optimize()


def test_unobserved_variable_needs_additive_damping():
    """The window-mode BAL scenes leave their last camera unobserved (BAL
    871's camera 870 too): its Hessian block is zero. The JAX package's
    damping, diag * (1 + lambda), leaves it singular: its PLANNED LM
    takes no step. The port's panel Cholesky gives NaN for that panel
    (the K1 twin as the kernel), so its direct LM leaves NaN in the
    camera's values, and its BlockJacobi preconditioner refuses the zero
    block. With damp_additive (the reference's lambda * (1 + diag)) the
    direct and the PCG paths converge with finite values, PLANNED as
    REF."""
    kw = dict(n_cams=26, n_pts=300, track_len=5, seed=1, track_mode="window",
              window=24, loop_frac=0.03, noise=1.0)
    prob = JB.make_random_bal(**kw)
    assert 25 not in set(prob.obs_cam.tolist())
    js = JO.OptimizerSettings(max_iters=3, backend=J.BackendType.PLANNED)
    assert JB.build_ba_optimizer(prob)[0].optimize(js)["iters"] == 0

    def port(backend, **kw_settings):
        opt, _, cams = TB.build_ba_optimizer(TB.make_random_bal(**kw),
                                             device="cpu")
        st = opt.optimize(TO.OptimizerSettings(
            max_iters=3, backend=getattr(T.BackendType, backend),
            **kw_settings))
        return st, opt.families[cams].values

    st, cams = port("PLANNED")
    assert bool(torch.isnan(cams[25]).all()) and \
        bool(torch.isfinite(cams[:25]).all())
    pcg = {"use_pcg": True, "precond": TO.BlockJacobiPrecond,
           "pcg_tol": 1e-10, "pcg_max_iters": 80}
    with pytest.raises(torch.linalg.LinAlgError):
        port("PLANNED", **pcg)
    for extra in ({}, pcg):
        st, cams = port("PLANNED", damp_additive=True, **extra)
        assert st["iters"] == 3 and np.all(np.diff(st["costs"]) < 0)
        assert bool(torch.isfinite(cams).all())
        ref, _ = port("REF", damp_additive=True, **extra)
        same_trajectory(ref["costs"], st["costs"], TO.OptimizerSettings())
