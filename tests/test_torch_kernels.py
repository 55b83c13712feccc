"""The three kernels' plain twins against the JAX routines they port,
fed the same inputs from the same schedule (f64, CPU). The CUDA kernels
themselves are held against these twins on the card by chip_smoke.py.

  K1 bucket_factor       vs PlannedBackend._factor_bucket
  K2 segmented_subtract  vs PlannedBackend._apply_pairs
  K3 bucket_solve        vs PlannedBackend._diag_solve(use_inv=True)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.planned_backend import _dev_bucket, _dev_csr
from baspacho_tpu_torch.ops.schedule import pair_csr, solve_csr
from baspacho_tpu_torch.testing.problems import SMALL, spd_data

torch.set_num_threads(1)

RTOL = 1e-10  # f64: XLA and torch sum in different orders, and the
#               stored inverse amplifies rounding

_cache = {}


def problem():
    """The meridian problem (gen_meridians(3, 150)): 4 levels, panel
    widths 4..256, below blocks 0..64 rows."""
    if not _cache:
        js, ts = SMALL["meri3"](J), SMALL["meri3"](T)
        data = spd_data(js, 11) * js.skel.padding_mask()
        _cache.update(js=js, ts=ts, data=data,
                      fj=np.asarray(js.factor(data)))
    return _cache["js"], _cache["ts"], _cache["data"], _cache["fj"]


def rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / \
        max(np.max(np.abs(np.asarray(b))), 1e-300)


def _levels(js, ts):
    nl = js.skel.num_lumps
    return list(zip(js.backend._factor_schedule(0, nl),
                    ts.backend._factor_schedule(0, nl)))


def test_k1_twin_matches_factor_bucket():
    """Every bucket, factored from the (masked) input: stored panels,
    the embedded inverse included, and the products x x^T."""
    js, ts, data, _ = problem()
    ext_j = jnp.concatenate([jnp.asarray(data), jnp.zeros(2)])
    n = 0
    for (jlbs, _, _, _), (tlbs, _, ptot) in _levels(js, ts):
        for jlb, tlb in zip(jlbs, tlbs):
            want, prod_j = jax.jit(
                lambda e, jlb=jlb: js.backend._factor_bucket(e, jlb))(ext_j)
            got = torch.from_numpy(data.copy())[None]
            prod = torch.zeros((1, max(ptot, 1)), dtype=torch.float64)
            b = _dev_bucket(tlb, "cpu")
            kernels.bucket_factor_twin(got, prod, b.off, b.rows, b.cols,
                                       b.cp, b.rp, b.prod_base)
            assert rel(got[0].numpy(), want[:-2]) < RTOL
            if tlb.rp:
                size = len(tlb.off) * tlb.rp * tlb.rp
                seg = prod[0, tlb.prod_base:tlb.prod_base + size].numpy()
                assert rel(seg, prod_j) < RTOL
            n += 1
    assert n >= 8


def test_k2_twin_matches_apply_pairs():
    """Each level's block pairs subtracted from a random product buffer
    into a random data buffer."""
    js, ts, data, _ = problem()
    rng = np.random.RandomState(5)
    n = 0
    for (_, jpbs, jptot, dense), (_, tpbs, ptot) in _levels(js, ts):
        if not ptot:
            continue
        assert dense is None and jptot == ptot
        flat = rng.rand(ptot)
        aux = []
        js.backend._register_aux(jpbs, aux)
        want = jax.jit(lambda e, f, a, jpbs=jpbs: js.backend._apply_pairs(
            e, f, jpbs, a))(
            jnp.concatenate([jnp.asarray(data), jnp.zeros(2)]),
            jnp.asarray(flat), [jnp.asarray(a) for a in aux])
        got = torch.from_numpy(data.copy())[None]
        c = _dev_csr(pair_csr(tpbs), "cpu")
        kernels.segmented_subtract_twin(got, torch.from_numpy(flat)[None],
                                        c.tgt, c.seg_ptr, c.src_idx, 1)
        assert rel(got[0].numpy(), want[:-2]) < RTOL
        n += 1
    assert n >= 3


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("transpose", [False, True])
def test_k3_twin_matches_diag_solve(nrhs, transpose):
    """Every bucket of the factored problem, one RHS block; the L pass's
    below scatter runs through the K2 twin, as on the main path."""
    js, ts, _, fj = problem()
    order = js.order
    rng = np.random.RandomState(nrhs + 10 * transpose)
    v = rng.rand(order, nrhs)
    ext_j = jnp.concatenate([jnp.asarray(fj), jnp.zeros(2)])
    vv_j = jnp.concatenate([jnp.asarray(v), jnp.zeros((1, nrhs))])
    data_t = torch.from_numpy(fj.copy())[None]
    n = 0
    for jlbs, tlbs in zip(js.backend._solve_schedule(0, js.skel.num_lumps),
                          ts.backend._solve_schedule(0, ts.skel.num_lumps)):
        for jlb, tlb in zip(jlbs, tlbs):
            bidx = jnp.asarray(jlb.below_idx) if jlb.rp else None
            want = jax.jit(lambda e, v, bx, jlb=jlb: js.backend._diag_solve(
                e, v, jlb, order, transpose, bx, use_inv=True))(
                ext_j, vv_j, bidx)
            got = torch.from_numpy(v.copy())[None]
            b = _dev_bucket(tlb, "cpu")
            y = torch.zeros((1, len(tlb.off) * tlb.rp, nrhs),
                            dtype=torch.float64)
            kernels.bucket_solve_twin(data_t, got, y, 0, b.off, b.rows,
                                      b.cols, b.vec_off, b.below_idx, b.cp,
                                      b.rp, transpose)
            if not transpose and tlb.rp:
                c = _dev_csr(solve_csr([tlb], [0], order), "cpu")
                kernels.segmented_subtract_twin(got, y, c.tgt, c.seg_ptr,
                                                c.src_idx, nrhs)
            assert rel(got[0].numpy(), want[:order]) < RTOL
            n += 1
    assert n >= 8


def test_k2_twin_against_loop():
    """Segment sums in a plain loop, batched, width > 1."""
    rng = np.random.RandomState(0)
    out = rng.rand(2, 7, 3)
    src = rng.rand(2, 5, 3)
    tgt = np.array([1, 4, 6])
    seg_ptr = np.array([0, 2, 2, 5])
    src_idx = np.array([0, 3, 1, 1, 4])
    want = out.copy()
    for t in range(3):
        for j in range(seg_ptr[t], seg_ptr[t + 1]):
            want[:, tgt[t]] -= src[:, src_idx[j]]
    got = torch.from_numpy(out.copy())
    kernels.segmented_subtract_twin(got, torch.from_numpy(src),
                                    *(torch.from_numpy(a) for a in
                                      (tgt, seg_ptr, src_idx)), 3)
    assert np.max(np.abs(got.numpy() - want)) < 1e-15


def test_wrappers_route_cpu_to_twins_and_count():
    js, ts, data, _ = problem()
    tlb = ts.backend._factor_schedule(0, ts.skel.num_lumps)[0][0][0]
    b = _dev_bucket(tlb, "cpu")
    kernels.reset_counts()
    d = torch.from_numpy(data.copy())[None]
    prod = torch.zeros((1, max(len(tlb.off) * tlb.rp ** 2, 1)),
                       dtype=torch.float64)
    kernels.bucket_factor(d, prod, b.off, b.rows, b.cols, b.cp, b.rp,
                          b.prod_base)
    c = kernels.COUNTS["bucket_factor"]
    assert (c.launches, c.twin_calls) == (0, 1)
    kernels.reset_counts()
    assert kernels.COUNTS["bucket_factor"].twin_calls == 0


def test_wrappers_never_fall_back_off_cpu():
    """A tensor on a device other than the CPU goes to the kernel path,
    which refuses anything that is not CUDA: no silent twin."""
    d = torch.empty((1, 16), dtype=torch.float64, device="meta")
    i = torch.empty(1, dtype=torch.int64, device="meta")
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.bucket_factor(d, None, i, i, i, 4, 0, 0)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.segmented_subtract(d, d, i, i, i, 1)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.bucket_solve(d, d.view(1, 16, 1), None, 0, i, i, i, i, i,
                             4, 0, True)
    assert all(c.twin_calls == 0 and c.launches == 0
               for c in kernels.COUNTS.values())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_mismatched_batches(device):
    """Every wrapper checks that its operands' batch sizes agree before
    it runs the twin (CPU) or would launch the kernel (any other device)."""
    f = dict(dtype=torch.float64, device=device)
    i = torch.zeros(1, dtype=torch.int64, device=device)
    kernels.reset_counts()
    with pytest.raises(ValueError, match="batch"):
        kernels.bucket_factor(torch.zeros((2, 64), **f),
                              torch.zeros((1, 64), **f), i, i, i, 4, 8, 0)
    with pytest.raises(ValueError, match="batch"):
        kernels.segmented_subtract(torch.zeros((1, 8), **f),
                                   torch.zeros((3, 8), **f), i, i, i, 1)
    with pytest.raises(ValueError, match="batch"):
        kernels.bucket_solve(torch.zeros((1, 64), **f),
                             torch.zeros((16, 8, 1), **f), None, 0, i, i, i,
                             i, i, 4, 0, True)
    with pytest.raises(ValueError, match="batch"):
        kernels.bucket_solve(torch.zeros((2, 64), **f),
                             torch.zeros((2, 8, 1), **f),
                             torch.zeros((1, 8, 1), **f), 0, i, i, i, i, i,
                             4, 8, False)
    assert all(c.twin_calls == 0 and c.launches == 0
               for c in kernels.COUNTS.values())


def test_build_names_and_flags():
    """The library is content-hashed per source set and built for the
    Hopper target with the plain-C route."""
    p = kernels.library_path()
    assert os.path.dirname(p) == kernels.BUILD_DIR
    assert p == kernels.library_path()
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    for s in kernels.SOURCES:
        assert os.path.exists(os.path.join(kernels.CSRC, s))
