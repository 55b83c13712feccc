"""The port's chained methods (Solver.factor_chained / solve_chained) on
the CPU against the JAX package's, f64: PLANNED on MERI-2 and on
WIDE_DENSE (a FLAT+Schur problem with a dense level and a 600-wide
lump), REF on MERI-2 and on ELIM_RANGE (FLAT + a 60-block Schur range;
the JAX REF program of WIDE_DENSE, unrolled over its 1,501 lumps, takes
minutes to compile), each with 1-D and batched data. The batched calls
are held item by item against the JAX package's 1-D chains, which share
one compiled program (a vmapped one would compile again).

Tolerances: factor_chained(d, 1) within 1e-12 relative of the JAX
package's; solve_chained(F, b, 3) within 1e-10 (three stored-inverse
solves, or on REF three L passes, amplify rounding). Against the port's
own eager calls the chains are exact: on the CPU they run the same
steps in a loop."""

import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu_torch.testing.problems import SMALL, spd_data, wide_dense
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

PROBLEMS = {"PLANNED": ("meri2", "wide_dense"),
            "REF": ("meri2", "elim_range")}
CASES = [(b, p) for b, ps in PROBLEMS.items() for p in ps]
_cache = {}


def case(backend, name):
    """(JAX solver, port solver, data (2, data_size): the matrix and a
    scaled copy, JAX factors of both)."""
    key = (backend, name)
    if key not in _cache:
        make = wide_dense if name == "wide_dense" else SMALL[name]
        js, ts = make(J, backend=backend), make(T, backend=backend)
        d = spd_data(js, 21)
        datas = np.stack([d, d * 1.01])
        _cache[key] = (js, ts, datas, np.array(js.factor(datas)))
    return _cache[key]


def jax_items(fn, *arrays):
    """fn (a JAX chained call) of each item of the batched arrays,
    stacked."""
    return np.stack([np.asarray(fn(*xs)) for xs in zip(*arrays)])


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("batched", [False, True], ids=["1d", "batched"])
@pytest.mark.parametrize("backend,name", CASES)
def test_factor_chained_matches_jax(backend, name, batched):
    js, ts, datas, _ = case(backend, name)
    d = datas if batched else datas[0]
    want = jax_items(lambda x: js.factor_chained(x, 1), datas) if batched \
        else np.asarray(js.factor_chained(d, 1))
    got = ts.factor_chained(torch.from_numpy(d), 1)
    assert got.shape == d.shape and got.dtype == torch.float64
    assert rel(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("nrhs", [0, 2], ids=["1d_rhs", "nrhs2"])
@pytest.mark.parametrize("batched", [False, True], ids=["1d", "batched"])
@pytest.mark.parametrize("backend,name", CASES)
def test_solve_chained_matches_jax(backend, name, batched, nrhs):
    js, ts, _, fj = case(backend, name)
    rng = np.random.RandomState(nrhs)
    shape = ((2,) if batched else ()) + (ts.order,) + ((nrhs,) if nrhs
                                                       else ())
    b = rng.rand(*shape)
    f = fj if batched else fj[0]
    want = jax_items(lambda g, c: js.solve_chained(g, c, 3), f, b) \
        if batched else np.asarray(js.solve_chained(f, b, 3))
    got = ts.solve_chained(torch.from_numpy(f), torch.from_numpy(b), 3)
    assert got.shape == b.shape
    assert rel(got.numpy(), want) < 1e-10


@pytest.mark.parametrize("backend", sorted(PROBLEMS))
def test_zero_length_chains_copy(backend):
    """k = 0 returns a copy of the data, or of the rhs, as JAX's
    fori_loop of no steps returns its input."""
    _, ts, datas, fj = case(backend, "meri2")
    d = torch.from_numpy(datas[0])
    b = torch.from_numpy(np.random.RandomState(1).rand(ts.order, 2))
    for got, src in ((ts.factor_chained(d, 0), d),
                     (ts.solve_chained(torch.from_numpy(fj[0]), b, 0), b)):
        assert torch.equal(got, src)
        assert got.data_ptr() != src.data_ptr()


@pytest.mark.parametrize("backend,name", CASES)
def test_chains_repeat_the_eager_calls(backend, name):
    """factor_chained(d, 3) is three factors, NaN for NaN (past the
    first they factor a factor); solve_chained(F, b, 3) is three solves
    (REF: three L passes, its step as in the JAX package)."""
    _, ts, datas, fj = case(backend, name)
    d = torch.from_numpy(datas)
    want = ts.factor(ts.factor(ts.factor(d)))
    torch.testing.assert_close(ts.factor_chained(d, 3), want, rtol=0,
                               atol=0, equal_nan=True)
    f = torch.from_numpy(fj)
    b = torch.from_numpy(np.random.RandomState(2).rand(2, ts.order, 2))
    step = ts.solve if backend == "PLANNED" else ts.solve_l
    torch.testing.assert_close(ts.solve_chained(f, b, 3),
                               step(f, step(f, step(f, b))), rtol=0, atol=0)


@pytest.mark.parametrize("what", ["data_size", "rhs_length", "rhs_dims",
                                  "negative_k"])
def test_chained_refusals(what):
    """A wrong data size or rhs shape raises ValueError in both packages
    (their _check_data / _check_rhs); a negative k only in the port
    (JAX's fori_loop runs no step)."""
    js, ts, datas, fj = case("PLANNED", "meri2")
    f, b = fj[0], np.ones(ts.order)
    calls = {"data_size": lambda s: s.factor_chained(datas[0][:-1], 1),
             "rhs_length": lambda s: s.solve_chained(f, b[:-1], 1),
             "rhs_dims": lambda s: s.solve_chained(f, b[None, None], 1),
             "negative_k": lambda s: s.factor_chained(datas[0], -1)}
    if what != "negative_k":
        with pytest.raises(ValueError):
            calls[what](js)
    with pytest.raises(ValueError):
        calls[what](ts)
