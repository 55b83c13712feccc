"""The mixed direct/iterative solve of examples/pcg_sample.py (the
reference's PCG_Sample.cpp) in the port (testing/flows.py, the flow
chip_smoke.py runs on the card) against the JAX package, with each of
the four preconditioners, on both backends (f64, CPU twins):

  factor_up_to(t) -> solve_l_up_to -> preconditioner init -> pcg with
  add_mv_from(part, t) as the operator -> solve_lt_up_to

t is the end of the sparse elimination range. The iteration count must
equal the JAX package's, or differ by one when the residual sits at the
stopping threshold (the two sum the dot products in different orders);
the solutions agree to 1e-10 relative, and solve the full system to
1e-10 by the port's block mat-vec from span 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu.optimizer as JO
from baspacho_tpu.testing import SparseMatGenerator as JGen
import baspacho_tpu_torch as T
import baspacho_tpu_torch.optimizer as TO
from baspacho_tpu_torch.testing import SparseMatGenerator, random_spd_data
from baspacho_tpu_torch.testing.flows import pcg_flow

torch.set_num_threads(1)

PRECONDS = ["IdentityPrecond", "BlockJacobiPrecond",
            "BlockGaussSeidelPrecond", "LowerPrecSolvePrecond"]
TOL, MAX_ITERS = 1e-10, 100
_cache = {}


def solvers(backend):
    """The sample's problem in both packages (same skeleton)."""
    if backend not in _cache:
        out = []
        for pkg, gen in ((J, JGen), (T, SparseMatGenerator)):
            g = gen.gen_flat(20, 0.3, seed=42)
            g.add_schur_set(80, 0.1)
            ss = g.to_structure()
            kw = {} if pkg is J else {"device": "cpu"}
            out.append(pkg.create_solver(
                pkg.Settings(backend=getattr(pkg.BackendType, backend)),
                np.full(ss.order, 3), ss, sparse_elim_ranges=[0, 80], **kw))
        js, ts = out
        a, b = T.skeleton_arrays(js.skel), T.skeleton_arrays(ts.skel)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        data = random_spd_data(ts.data_size, ts.order, 7)
        data = np.asarray(ts.skel.damp(data, 0.0, ts.order * 1.5))
        rhs = np.random.RandomState(0).rand(ts.order)
        _cache[backend] = (js, ts, data, rhs)
    return _cache[backend]


def jax_flow(s, data, rhs, precond):
    t = s.sparse_elim_ranges[-1]
    o = s.span_vector_offset(t)
    data = jnp.asarray(data)
    part = s.factor_up_to(data, t)
    v = s.solve_l_up_to(part, t, jnp.asarray(rhs))
    pre = getattr(JO, precond)(s, t)
    pre.init(part)

    def apply_inv_m(x):
        return pre.apply(jnp.zeros_like(v).at[o:].set(x))[o:]

    def apply_a(x):
        full = jnp.zeros_like(v).at[o:].set(x)
        return s.add_mv_from(part, t, full, jnp.zeros_like(full))[o:]

    x, r2, it = JO.pcg(apply_inv_m, apply_a, v[o:], TOL, MAX_ITERS)
    sol = s.solve_lt_up_to(part, t, v.at[o:].set(x))
    return np.asarray(sol), int(it), float(r2)


@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("backend", ["REF", "PLANNED"])
def test_pcg_sample_matches_jax(backend, precond):
    js, ts, data, rhs = solvers(backend)
    want, it_j, r2_j = jax_flow(js, data, rhs, precond)
    got, it_t, r2_t = pcg_flow(ts, torch.from_numpy(data),
                               torch.from_numpy(rhs), precond, tol=TOL,
                               max_iters=MAX_ITERS)
    thresh = TOL * TOL * float(rhs[ts.span_vector_offset(
        ts.sparse_elim_ranges[-1]):] @ rhs[ts.span_vector_offset(
            ts.sparse_elim_ranges[-1]):])
    print(f"{backend} {precond}: iterations jax {it_j} port {it_t}; "
          f"|r|^2 jax {r2_j:.3e} port {r2_t:.3e}")
    assert abs(it_t - it_j) <= 1 and (it_t == it_j or
                                      min(r2_j, r2_t) > 1e-6 * thresh)
    assert 0 < it_t < MAX_ITERS
    got = got.numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-10
    mv = ts.add_mv_from(torch.from_numpy(data), 0, torch.from_numpy(got),
                        torch.zeros(ts.order, dtype=torch.float64)).numpy()
    assert np.linalg.norm(mv - rhs) / np.linalg.norm(rhs) < 1e-10
    dense = ts.skel.densify(data, fill_upper_half=True)
    assert np.linalg.norm(dense @ got - rhs) / np.linalg.norm(rhs) < 1e-10


def test_pcg_matches_jax_on_a_dense_system():
    """pcg alone: the same iterates as the JAX loop on an SPD matrix."""
    rng = np.random.RandomState(3)
    m = rng.rand(30, 30)
    a = m @ m.T + 30 * np.eye(30)
    b = rng.rand(30)
    d = 1.0 / np.diag(a)
    xj, r2j, itj = JO.pcg(lambda r: jnp.asarray(d) * r,
                          lambda p: jnp.asarray(a) @ p, jnp.asarray(b),
                          1e-12, 50)
    xt, r2t, itt = TO.pcg(lambda r: torch.from_numpy(d) * r,
                          lambda p: torch.from_numpy(a) @ p,
                          torch.from_numpy(b), 1e-12, 50)
    assert itt == int(itj)
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 1e-12
    assert np.linalg.norm(a @ xt.numpy() - b) < 1e-10 * np.linalg.norm(b)


def test_block_jacobi_apply_matches_jax():
    js, ts, data, rhs = solvers("REF")
    t = ts.sparse_elim_ranges[-1]
    pj, pt = JO.BlockJacobiPrecond(js, t), TO.BlockJacobiPrecond(ts, t)
    pj.init(jnp.asarray(data))
    pt.init(torch.from_numpy(data))
    v = np.random.RandomState(1).rand(ts.order, 2)
    want = np.asarray(pj.apply(jnp.asarray(v)))
    got = pt.apply(torch.from_numpy(v)).numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-12
