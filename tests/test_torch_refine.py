"""Refined and differentiable solves, check_factor and the device
default of the port, against the JAX package and dense oracles (f64 and
f32 on the CPU, both backends).

  solve_refined            tests/test_solve.py:114: an f32 factor and
                           f64 residuals recover 1e-10
  check_factor             tests/test_factor.py:179
  make_differentiable_solve  torch.autograd.gradcheck, and gradients
                           against jax.grad on the problems of
                           tests/test_optimizer.py:215-281 (1e-8
                           relative: both are one more solve on the
                           forward factor, summed in other orders)
  device default           solvers run on the CUDA card unless a device
                           is named, and refuse to fall back to the CPU
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baspacho_tpu as J
from baspacho_tpu.testing import SparseMatGenerator as JGen
import baspacho_tpu_torch as T
from baspacho_tpu_torch.testing import SparseMatGenerator, random_spd_data
from baspacho_tpu_torch.testing.problems import SMALL
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

BACKENDS = ["REF", "PLANNED"]


def make(pkg, gen_cls, n, fill, seed, block, backend, data_seed):
    ss = gen_cls.gen_flat(n, fill, seed=seed).to_structure()
    kw = {} if pkg is J else {"device": "cpu"}
    s = pkg.create_solver(
        pkg.Settings(backend=getattr(pkg.BackendType, backend)),
        np.full(n, block), ss, **kw)
    data = random_spd_data(s.data_size, s.order, data_seed)
    return s, np.asarray(s.skel.damp(data, 0.0, s.order * 1.5))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(2))
def test_iterative_refinement_recovers_f64(backend, seed):
    ts, data64 = make(T, SparseMatGenerator, 18, 0.3, seed + 90, 3, backend,
                      seed + 1090)
    f32 = ts.factor(torch.from_numpy(data64.astype(np.float32)))
    assert f32.dtype == torch.float32
    rhs = np.random.RandomState(seed + 1090).rand(ts.order)
    x = ts.solve_refined(torch.from_numpy(data64), f32,
                         torch.from_numpy(rhs), iterations=3)
    assert x.dtype == torch.float64
    dense = ts.skel.densify(data64, fill_upper_half=True)
    want = np.linalg.solve(dense, rhs)
    err0 = np.max(np.abs(ts.solve(f32, torch.from_numpy(
        rhs.astype(np.float32))).double().numpy() - want))
    err = np.max(np.abs(x.numpy() - want))
    assert err < 1e-10, (err, err0)
    assert err < err0 / 10
    js, _ = make(J, JGen, 18, 0.3, seed + 90, 3, backend, seed + 1090)
    xj = np.asarray(js.solve_refined(data64, np.asarray(
        js.factor(data64.astype(np.float32))), rhs, iterations=3))
    assert np.max(np.abs(x.numpy() - xj)) < 1e-10


@pytest.mark.parametrize("backend", BACKENDS)
def test_check_factor_detects_indefinite(backend):
    ts, _ = make(T, SparseMatGenerator, 15, 0.3, 5, 2, backend, 5)
    data = random_spd_data(ts.data_size, ts.order, 5)
    good = ts.factor(torch.from_numpy(ts.skel.damp(data, 0.0,
                                                   ts.order * 1.5)))
    assert ts.check_factor(good)
    assert ts.check_factor(torch.stack([good, good]))
    bad = ts.factor(torch.from_numpy(ts.skel.damp(data, 0.0, -1e6)))
    assert not ts.check_factor(bad)
    one = good.clone()
    one[int(ts.skel.damp_indices()[3])] *= -1
    assert not ts.check_factor(one)
    assert not ts.check_factor(torch.stack([good, one]))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nrhs", [0, 2])
def test_differentiable_solve_gradcheck(backend, nrhs):
    ts, data = make(T, SparseMatGenerator, 6, 0.5, 3, 2, backend, 7)
    fsolve = ts.make_differentiable_solve()
    rng = np.random.RandomState(5)
    rhs = rng.rand(*((ts.order,) if nrhs == 0 else (ts.order, nrhs)))
    h = torch.from_numpy(data).requires_grad_()
    b = torch.from_numpy(rhs).requires_grad_()
    assert torch.autograd.gradcheck(fsolve, (h, b), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("problem", [(10, 0.35, 3, 7, 5, 0),
                                     (8, 0.4, 9, 1, 2, 3)])
def test_differentiable_solve_matches_jax_grad(backend, problem):
    """tests/test_optimizer.py:215-281's two problems (1-D rhs, and 3
    right-hand sides): the gradients of sum(w * solve(h, b)) wrt h and b
    equal jax.grad's."""
    n, fill, seed, dseed, rseed, nrhs = problem
    js, data = make(J, JGen, n, fill, seed, 2, backend, dseed)
    ts, _ = make(T, SparseMatGenerator, n, fill, seed, 2, backend, dseed)
    rng = np.random.RandomState(rseed)
    shape = (ts.order,) if nrhs == 0 else (ts.order, nrhs)
    rhs, w = rng.rand(*shape), rng.rand(*shape)
    jsolve = js.make_differentiable_solve()
    gh_j, gb_j = jax.grad(lambda h, b: jnp.sum(jnp.asarray(w) * jsolve(h, b)),
                          argnums=(0, 1))(jnp.asarray(data), jnp.asarray(rhs))
    h = torch.from_numpy(data).requires_grad_()
    b = torch.from_numpy(rhs).requires_grad_()
    (torch.from_numpy(w) * ts.make_differentiable_solve()(h, b)).sum() \
        .backward()
    for got, want in ((h.grad, gh_j), (b.grad, gb_j)):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) \
            < 1e-8


def test_entry_points_default_to_cuda(monkeypatch):
    """create_solver, Solver and solver_from_skeleton run on the CUDA
    card unless a device is named; with no card they raise instead of
    quietly running on the CPU."""
    ss = SparseMatGenerator.gen_flat(6, 0.5, seed=1).to_structure()
    planned = T.Settings(backend=T.BackendType.PLANNED)
    ref = T.create_solver(planned, np.full(6, 2), ss, device="cpu")
    arrays = T.skeleton_arrays(ref.skel)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.create_solver(planned, np.full(6, 2), ss)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.create_solver(T.Settings(), np.full(6, 2), ss)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.solver_from_skeleton(arrays, ref.permutation, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Solver(ref.skel, [], ref.permutation)
    with pytest.raises(RuntimeError, match="CUDA"):
        SMALL["flat"](T, device=None)
    assert T.create_solver(planned, np.full(6, 2), ss,
                           device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    # with the card's index, as the tensors on it report their device
    # (an index-less "cuda" refused every tensor on cuda:0)
    card = torch.device("cuda", 0)
    assert T.create_solver(planned, np.full(6, 2), ss).device == card
    assert T.solver_from_skeleton(arrays, ref.permutation, []) \
        .device == card
    assert T.Solver(ref.skel, [], ref.permutation).device == card
    assert T.create_solver(planned, np.full(6, 2), ss,
                           device="cuda").device == card
