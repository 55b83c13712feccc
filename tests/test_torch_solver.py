"""The port's planned factor + solve as a whole against the JAX
package's PLANNED solver, on the five small problems (f64, CPU twins).

Tolerances: 1e-10 relative between the packages (XLA and torch sum in
different orders, and the stored inverse amplifies rounding); 1e-12
between batched and single runs of the port; 1e-4 between its f32 and
f64 runs."""

import jax
import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.testing.problems import SMALL, spd_data
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

_cache = {}


def case(name):
    """(JAX solver, port solver, data, JAX factor) of one problem."""
    if name not in _cache:
        js, ts = SMALL[name](J), SMALL[name](T)
        data = spd_data(js, 21)
        _cache[name] = (js, ts, data, np.asarray(js.factor(data)))
    return _cache[name]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_factor_buffer_matches_jax(name):
    """The whole buffer, stored inverse (strict upper of each diag
    block) included."""
    js, ts, data, fj = case(name)
    ft = ts.factor(torch.from_numpy(data))
    assert ft.shape == (ts.data_size,) and ft.dtype == torch.float64
    assert rel(ft.numpy(), fj) < 1e-10
    # and it is a Cholesky factor of the matrix
    dense = ts.skel.densify(data, fill_upper_half=True)
    L = np.tril(ts.skel.densify(ft.numpy()))
    assert rel(L @ L.T, dense) < 1e-12


@pytest.mark.parametrize("name", sorted(SMALL))
def test_solve_matches_jax(name):
    js, ts, data, fj = case(name)
    ft = torch.from_numpy(fj)
    rng = np.random.RandomState(7)
    for rhs in (rng.rand(js.order, 1), rng.rand(js.order, 3),
                rng.rand(js.order)):
        want = np.asarray(js.solve(fj, rhs))
        got = ts.solve(ft, torch.from_numpy(rhs))
        assert got.shape == rhs.shape
        assert rel(got.numpy(), want) < 1e-10


@pytest.mark.parametrize("name", ["meri3", "elim_range", "grid10"])
def test_batched_matches_single(name):
    js, ts, data, _ = case(name)
    datas = np.stack([data * (1.0 + 0.01 * b) for b in range(3)])
    fb = ts.factor(torch.from_numpy(datas))
    rng = np.random.RandomState(3)
    rhs = rng.rand(3, ts.order, 2)
    xb = ts.solve(fb, torch.from_numpy(rhs))
    xb1 = ts.solve(fb, torch.from_numpy(rhs[:, :, 0]))
    for b in range(3):
        fs = ts.factor(torch.from_numpy(datas[b]))
        assert rel(fb[b].numpy(), fs.numpy()) < 1e-12
        xs = ts.solve(fs, torch.from_numpy(rhs[b]))
        assert rel(xb[b].numpy(), xs.numpy()) < 1e-12
        assert rel(xb1[b].numpy(), xs[:, 0].numpy()) < 1e-12


@pytest.mark.parametrize("name", ["meri3", "grid10"])
def test_f32_matches_f64(name):
    js, ts, data, _ = case(name)
    f64 = ts.factor(torch.from_numpy(data))
    f32 = ts.factor(torch.from_numpy(data.astype(np.float32)))
    assert f32.dtype == torch.float32
    assert rel(f32.double().numpy(), f64.numpy()) < 1e-4
    rhs = np.random.RandomState(1).rand(ts.order, 2)
    x64 = ts.solve(f64, torch.from_numpy(rhs))
    x32 = ts.solve(f32, torch.from_numpy(rhs.astype(np.float32)))
    assert rel(x32.double().numpy(), x64.numpy()) < 1e-4


def test_factor_is_deterministic_and_pure():
    js, ts, data, _ = case("meri3")
    d = torch.from_numpy(data.copy())
    a = ts.factor(d)
    b = ts.factor(d)
    assert torch.equal(a, b)
    assert np.array_equal(d.numpy(), data)  # the input is not modified


def test_main_path_runs_every_kernel_wrapper():
    js, ts, data, _ = case("meri3")
    kernels.reset_counts()
    f = ts.factor(torch.from_numpy(data))
    ts.solve(f, torch.from_numpy(np.ones(ts.order)))
    c = kernels.COUNTS
    nb = sum(len(lv[0]) for lv in ts.backend._factor_schedule(
        0, ts.skel.num_lumps))
    assert c["bucket_factor"].twin_calls == nb
    assert c["bucket_solve"].twin_calls == 2 * nb
    assert c["segmented_subtract"].twin_calls > 0
    assert all(v.launches == 0 for v in c.values())  # CPU: no kernels


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_input_checks_raise_like_jax(pkg):
    """The checks of solver.py:211-231, in both packages."""
    js, ts, data, fj = case("meri2")
    s = js if pkg is J else ts
    cvt = np.asarray if pkg is J else torch.from_numpy
    n, order = s.data_size, s.order
    with pytest.raises(ValueError):
        s.factor(cvt(np.ones(n + 1)))
    with pytest.raises(ValueError):
        s.factor(cvt(np.ones((2, 2, n))))
    with pytest.raises(ValueError):
        s.solve(cvt(fj), cvt(np.ones(order + 1)))
    with pytest.raises(ValueError):
        s.solve(cvt(fj), cvt(np.ones((1, order, 2))))
    with pytest.raises(ValueError):
        s.solve(cvt(np.stack([fj, fj])), cvt(np.ones(order)))


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
@pytest.mark.parametrize("nd,nv", [(1, 16), (3, 2)])
def test_batch_mismatch_raises_like_jax(pkg, nd, nv):
    """Batched data and RHS must have one batch size (JAX: vmap's size
    check); the port raises before anything runs."""
    js, ts, data, fj = case("meri2")
    s = js if pkg is J else ts
    cvt = np.asarray if pkg is J else torch.from_numpy
    rhs = np.ones((nv, s.order, 2))
    with pytest.raises(ValueError):
        s.solve(cvt(np.stack([fj] * nd)), cvt(rhs))


def test_port_only_checks():
    js, ts, data, fj = case("meri2")
    with pytest.raises(TypeError):
        ts.factor(torch.ones(ts.data_size, dtype=torch.int64))
    with pytest.raises(TypeError):
        ts.solve(torch.from_numpy(fj), torch.ones(ts.order,
                                                  dtype=torch.float32))
    with pytest.raises(ValueError):
        ts.factor(torch.ones(ts.data_size, device="meta"))


_SHARDED_REFUSALS = {
    # id: (method, backend, batched data, JAX's message)
    "factor_sharded_batched": ("factor_sharded", "PLANNED", True,
                               "factor_sharded shards ONE factorization"),
    "factor_sharded_ref": ("factor_sharded", "REF", False,
                           "factor_sharded needs the PLANNED backend"),
    "solve_sharded_batched": ("solve_sharded", "PLANNED", True,
                              "solve_sharded shards ONE solve"),
    "solve_sharded_ref": ("solve_sharded", "REF", False,
                          "solve_sharded needs the PLANNED backend"),
}


@pytest.mark.parametrize("method", list(_SHARDED_REFUSALS))
def test_sharded_methods_refuse(method):
    """The sharded methods refuse batched data and the REF backend with
    the JAX package's messages, before they read the mesh."""
    name, backend, batched, msg = _SHARDED_REFUSALS[method]
    js, ts, data, fj = case("meri2")
    if backend == "REF":
        js, ts = SMALL["meri2"](J, backend="REF"), \
            SMALL["meri2"](T, backend="REF")
    d = np.stack([data] * 2) if batched else data
    args = (d,) if name == "factor_sharded" else (d, np.ones(ts.order))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("shard",))
    with pytest.raises(AssertionError, match=f"^{msg}$"):
        getattr(js, name)(*args, mesh)
    with pytest.raises(ValueError, match=f"^{msg}$"):
        getattr(ts, name)(*(torch.from_numpy(a) for a in args), None)


def test_public_names_and_accessor():
    js, ts, data, _ = case("meri2")
    for s in (js, ts):
        assert s.span_vector_offset(3) == js.span_vector_offset(3)
        assert s.span_matrix_offset(0) == js.span_matrix_offset(0)
    acc_j, acc_t = js.accessor(), ts.accessor()
    assert np.array_equal(acc_j.diag_block(data, 2),
                          acc_t.diag_block(data, 2))


def test_runs_on_a_jax_skeleton():
    """A numpy buffer of a JAX solver factors identically on the port's
    solver rebuilt from that solver's skeleton."""
    js, _, data, fj = case("meri3")
    ts = T.solver_from_skeleton(T.skeleton_arrays(js.skel), js.permutation,
                                js.sparse_elim_ranges, device="cpu")
    ft = ts.factor(torch.from_numpy(data).to("cpu"))
    assert rel(ft.numpy(), fj) < 1e-10
