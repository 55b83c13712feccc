"""Wide panels (padded width > 512): the plain twins of K1-wide and
K3-wide against the JAX routines they port, on the same synthetic
bucket (f64, CPU). The CUDA kernels are held against these twins on the
card by chip_smoke.py.

  K1-wide wide_factor  vs PlannedBackend._factor_bucket (_blocked_factor
                       + _blocked_lower_inv + _embed_inv)
  K3-wide wide_solve   vs PlannedBackend._diag_solve(use_inv=True)

The bucket holds two panels of padded width 1024 (real widths 1000 and
700) with padded below rows 64 (real 60 and 33), so the padding of both
the columns and the below rows is exercised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baspacho_tpu as J
from baspacho_tpu.ops.planned_backend import LumpBucket as JBucket
import baspacho_tpu_torch as T
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.planned_backend import _dev_bucket, _dev_csr
from baspacho_tpu_torch.ops.schedule import LumpBucket, solve_csr
from baspacho_tpu_torch.testing.problems import SMALL, spd_data, wide_dense

torch.set_num_threads(1)

RTOL = 1e-10  # f64: XLA and torch sum in different orders, and the
#               stored inverse amplifies rounding

CP, RP = 1024, 64
COLS, ROWS = (1000, 700), (60, 33)
_cache = {}


def bucket():
    """(JAX backend, JAX bucket, port bucket, data, order): two wide
    panels side by side in one flat buffer, SPD diagonal blocks (lower
    triangle stored), random below rows, zero padding."""
    if not _cache:
        rng = np.random.RandomState(4)
        h = CP + RP
        data = np.zeros(2 * h * CP)
        for i, (n, r) in enumerate(zip(COLS, ROWS)):
            p = data[i * h * CP:(i + 1) * h * CP].reshape(h, CP)
            m = rng.rand(n, n) - 0.5
            p[:n, :n] = np.tril(m @ m.T + n * np.eye(n))
            p[CP:CP + r, :n] = rng.rand(r, n) - 0.5
        order = sum(COLS) + 100
        bidx = np.full((2, RP), order, dtype=np.int32)
        for i, r in enumerate(ROWS):
            bidx[i, :r] = np.sort(rng.choice(np.arange(sum(COLS), order), r,
                                             replace=False))
        kw = dict(rp=RP, cp=CP, off=np.array([0, h * CP], np.int32),
                  rows=np.array(ROWS, np.int32),
                  cols=np.array(COLS, np.int32),
                  vec_off=np.array([0, COLS[0]], np.int32), below_idx=bidx)
        tlb = LumpBucket(**kw)
        tlb.members = np.array([0, 1])
        _cache.update(js=SMALL["meri2"](J), jlb=JBucket(**kw), tlb=tlb,
                      data=data, order=order)
    c = _cache
    return c["js"], c["jlb"], c["tlb"], c["data"], c["order"]


def rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / \
        max(np.max(np.abs(np.asarray(b))), 1e-300)


def factored():
    js, jlb, tlb, data, _ = bucket()
    if "fj" not in _cache:
        ext = jnp.concatenate([jnp.asarray(data), jnp.zeros(2)])
        want, prod = jax.jit(
            lambda e: js.backend._factor_bucket(e, jlb))(ext)
        _cache["fj"] = (np.asarray(want[:-2]), np.asarray(prod))
    return _cache["fj"]


def test_k1_wide_twin_matches_factor_bucket():
    """The whole buffer: L, the full embedded inverse (strict upper of
    each diagonal block), x below, and zero padding."""
    _, _, tlb, data, _ = bucket()
    want, prod_j = factored()
    got = torch.from_numpy(data.copy())[None]
    b = _dev_bucket(tlb, "cpu")
    kernels.reset_counts()
    kernels.wide_factor(got, b.off, b.rows, b.cols, b.cp, b.rp, b.off_h,
                        b.cols_h)
    assert kernels.COUNTS["wide_factor"].twin_calls == 1
    assert kernels.COUNTS["wide_factor"].launches == 0
    g = got[0].numpy()
    assert rel(g, want) < RTOL
    # the products the JAX routine returns are x x^T of the stored x
    h = CP + RP
    x = g.reshape(2, h, CP)[:, CP:]
    assert rel(np.einsum("brk,bsk->brs", x, x).reshape(-1), prod_j) < RTOL
    # padding stays zero: columns >= n of every row, rows >= n of the diag
    for i, (n, r) in enumerate(zip(COLS, ROWS)):
        p = g.reshape(2, h, CP)[i]
        assert not p[:, n:].any() and not p[n:CP].any()
        assert not p[CP + r:].any()


def test_k1_wide_twin_batched_is_per_item():
    """Batch items are factored independently and identically."""
    _, _, tlb, data, _ = bucket()
    b = _dev_bucket(tlb, "cpu")
    got = torch.from_numpy(np.stack([data, 2.0 * data]))
    kernels.wide_factor_twin(got, b.off, b.rows, b.cols, b.cp, b.rp,
                             b.off_h, b.cols_h)
    one = torch.from_numpy(2.0 * data)[None]
    kernels.wide_factor_twin(one, b.off, b.rows, b.cols, b.cp, b.rp,
                             b.off_h, b.cols_h)
    assert torch.equal(got[1], one[0])
    assert rel(got[0].numpy(), factored()[0]) < RTOL


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("transpose", [False, True])
def test_k3_wide_twin_matches_diag_solve(nrhs, transpose):
    """Both passes on the factored bucket; the L pass's below scatter
    runs through the K2 twin, as on the main path."""
    js, jlb, tlb, _, order = bucket()
    fj = factored()[0]
    rng = np.random.RandomState(nrhs + 10 * transpose)
    v = rng.rand(order, nrhs)
    want = jax.jit(lambda e, v, bx: js.backend._diag_solve(
        e, v, jlb, order, transpose, bx, use_inv=True))(
        jnp.concatenate([jnp.asarray(fj), jnp.zeros(2)]),
        jnp.concatenate([jnp.asarray(v), jnp.zeros((1, nrhs))]),
        jnp.asarray(jlb.below_idx))
    got = torch.from_numpy(v.copy())[None]
    b = _dev_bucket(tlb, "cpu")
    y = torch.zeros((1, 2 * RP, nrhs), dtype=torch.float64)
    kernels.reset_counts()
    kernels.wide_solve(torch.from_numpy(fj.copy())[None], got, y, 0, b.off, b.rows,
                       b.cols, b.vec_off, b.below_idx, b.cp, b.rp,
                       transpose)
    assert kernels.COUNTS["wide_solve"].twin_calls == 1
    if not transpose:
        c = _dev_csr(solve_csr([tlb], [0], order), "cpu")
        kernels.segmented_subtract_twin(got, y, c.tgt, c.seg_ptr, c.src_idx,
                                        nrhs)
    assert rel(got[0].numpy(), np.asarray(want)[:order]) < RTOL


def test_wide_wrappers_never_fall_back_off_cpu():
    """A tensor on a device other than the CPU goes to the kernel path,
    which refuses anything that is not CUDA: no silent twin."""
    d = torch.empty((1, 16), dtype=torch.float64, device="meta")
    i = torch.empty(1, dtype=torch.int64, device="meta")
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.wide_factor(d, i, i, i, 1024, 0, (0,), (1000,))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.wide_solve(d, d.view(1, 16, 1), None, 0, i, i, i, i, i,
                           1024, 0, True)
    with pytest.raises(ValueError, match="batch"):
        kernels.wide_solve(torch.zeros((2, 8)), torch.zeros((1, 8, 1)),
                           None, 0, i, i, i, i, i, 1024, 0, True)
    assert all(c.twin_calls == 0 and c.launches == 0
               for c in kernels.COUNTS.values())


def test_wide_problem_routes_wide_buckets():
    """FLAT-like problems build (no width refusal) and their wide lump
    goes through the wide wrappers on the main path."""
    ts = wide_dense(T)
    sched = ts.backend._factor_schedule(0, ts.skel.num_lumps)
    assert [lb.cp for lb in sched[-1][0]] == [1024]
    data = spd_data(ts, 2)
    kernels.reset_counts()
    f = ts.factor(torch.from_numpy(data))
    ts.solve(f, torch.from_numpy(np.ones(ts.order)))
    c = kernels.COUNTS
    assert c["wide_factor"].twin_calls == 1
    assert c["wide_solve"].twin_calls == 2
    assert c["dense_update"].twin_calls == 1
