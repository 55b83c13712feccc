"""The port's demo twins (baspacho_tpu_torch/examples) at their own
sizes on the CPU, against the JAX package's demos (examples/) computed
the same way: the spring chain's and BA's LM cost trajectories, the
differentiable solve's gradient and Adam loss trajectory, and the mixed
solve's PCG iterations and residual per preconditioner."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baspacho_tpu import Settings, create_solver
from baspacho_tpu import bal as JB
import baspacho_tpu.optimizer as JO
from baspacho_tpu.optimizer import OptimizerSettings
from baspacho_tpu.sparse_structure import SparseStructure
from baspacho_tpu.testing import SparseMatGenerator, random_spd_data
from baspacho_tpu.utils import cum_sum_vec
from baspacho_tpu_torch.examples import diff_solve, optimize_ba, \
    optimize_simple, pcg_sample
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)


def close_costs(cj, ct):
    n = min(len(cj), len(ct))
    assert abs(len(cj) - len(ct)) <= 1, (cj, ct)
    assert np.max(np.abs(np.subtract(cj[:n], ct[:n]))) <= 1e-10 * cj[0]


def test_optimize_simple_matches_jax():
    got = optimize_simple.main(["--device", "cpu"])
    opt = JO.Optimizer()
    rng = np.random.RandomState(0)
    xs = opt.add_variable_family(JO.VariableFamily(rng.rand(20, 1) * 10))
    opt.add_factor_family(lambda a, b: (b - a) - 1.0,
                          [(xs, np.arange(19)), (xs, np.arange(1, 20))])
    opt.add_factor_family(lambda a: a, [(xs, np.array([0]))])
    want = opt.optimize(OptimizerSettings(max_iters=25))
    close_costs(want["costs"], got["costs"])
    assert got["final_cost"] < 1e-16


def test_optimize_ba_matches_jax():
    got = optimize_ba.main(["--device", "cpu"])
    prob = JB.make_random_bal(n_cams=8, n_pts=200, track_len=5, seed=0,
                              noise=0.5)
    opt = JB.build_ba_optimizer(prob, huber=100.0)[0]
    want = opt.optimize(OptimizerSettings(max_iters=20))
    close_costs(want["costs"], got["costs"])


def jax_demo(steps: int):
    """examples/diff_solve.py's computation, `steps` Adam steps: the
    gradient at the start and the loss before each step."""
    n = 16
    rows = [[i] if i == 0 else [i - 1, i] for i in range(n)]
    ss = SparseStructure(cum_sum_vec([len(r) for r in rows]),
                         np.concatenate(rows))
    solver = create_solver(Settings(), np.ones(n, dtype=np.int64), ss)
    fsolve = solver.make_differentiable_solve()
    acc = solver.accessor()
    diag_off = np.asarray([acc.diag_block_offset(i)[0] for i in range(n)])
    off_off = np.asarray([acc.block_offset(i, i - 1)[0]
                          for i in range(1, n)])
    b = jnp.ones(n)

    def hdata_of(log_k):
        k = jnp.exp(log_k)
        h = jnp.zeros(solver.data_size)
        h = h.at[diag_off[0]].add(k[0] + 1.0)
        h = h.at[diag_off[1:-1]].add(k[:-1] + k[1:])
        h = h.at[diag_off[-1]].add(k[-1])
        return h.at[off_off].add(-k)

    rng = np.random.RandomState(0)
    target = fsolve(hdata_of(jnp.asarray(rng.randn(n - 1) * 0.5)), b)

    def loss(log_k):
        return jnp.sum((fsolve(hdata_of(log_k), b) - target) ** 2)

    opt = optax.adam(0.05)
    log_k = jnp.zeros(n - 1)
    state = opt.init(log_k)
    grad0 = np.asarray(jax.grad(loss)(log_k))
    losses = []
    vg = jax.jit(jax.value_and_grad(loss))
    for _ in range(steps):
        v, g = vg(log_k)
        upd, state = opt.update(g, state)
        log_k = optax.apply_updates(log_k, upd)
        losses.append(float(v))
    return grad0, losses


def test_diff_solve_matches_jax():
    steps = 60
    grad0, want = jax_demo(steps)
    got = diff_solve.main(["--device", "cpu", "--steps", str(steps)])
    # the gradient at the start, through the port's implicit backward
    _, fsolve, hdata_of = diff_solve.setup(16, "cpu")
    rng = np.random.RandomState(0)
    b = torch.ones(16, dtype=torch.float64)
    target = fsolve(hdata_of(torch.from_numpy(rng.randn(15) * 0.5)), b)
    lk = torch.zeros(15, dtype=torch.float64, requires_grad=True)
    torch.sum((fsolve(hdata_of(lk), b) - target.detach()) ** 2).backward()
    assert np.max(np.abs(lk.grad.numpy() - grad0)) <= \
        1e-12 * np.max(np.abs(grad0))
    assert np.max(np.abs(np.subtract(got["losses"], want))) <= \
        1e-9 * want[0]
    assert got["losses"][-1] < 0.5 * got["losses"][0]


def jax_pcg_demo(precond: str):
    """examples/pcg_sample.py's computation: (PCG iterations, the
    residual max |M x - b| of the full system)."""
    gen = SparseMatGenerator.gen_flat(20, 0.3, seed=42)
    gen.add_schur_set(80, 0.1)
    ss = gen.to_structure()
    solver = create_solver(Settings(), np.full(ss.order, 3), ss,
                           sparse_elim_ranges=[0, 80])
    data = random_spd_data(solver.data_size, solver.order, 7)
    data = jnp.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    rhs = jnp.asarray(np.random.RandomState(0).rand(solver.order))
    t = solver.sparse_elim_ranges[-1]
    o = solver.span_vector_offset(t)
    part = solver.factor_up_to(data, t)
    v = solver.solve_l_up_to(part, t, rhs)
    pre = {"jacobi": JO.BlockJacobiPrecond,
           "gauss_seidel": JO.BlockGaussSeidelPrecond}[precond](solver, t)
    pre.init(part)

    def embed(x):
        return jnp.zeros_like(v).at[o:].set(x)

    x, _, iters = JO.pcg(
        lambda r: pre.apply(embed(r))[o:],
        lambda p: solver.add_mv_from(part, t, embed(p),
                                     jnp.zeros_like(v))[o:],
        v[o:], 1e-10, 100)
    sol = solver.solve_lt_up_to(part, t, v.at[o:].set(x))
    mv = solver.add_mv_from(data, 0, sol, jnp.zeros_like(sol))
    return int(iters), float(jnp.max(jnp.abs(mv - rhs)))


@pytest.mark.parametrize("precond", ["jacobi", "gauss_seidel"])
def test_pcg_sample_matches_jax(precond):
    iters, resid = jax_pcg_demo(precond)
    got = pcg_sample.main([precond, "--device", "cpu"])
    assert got["iterations"] == iters
    assert got["residual"] <= 1e-9
    assert abs(got["residual"] - resid) <= 1e-4 * resid
