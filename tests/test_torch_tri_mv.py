"""The plain twins of K3-rest (tri_solve, wide_tri_solve) and K5
(add_mv, wide_add_mv) against the JAX routines they port (f64, CPU).
The CUDA kernels are held against these twins on the card by
chip_smoke.py.

  K3-rest  vs PlannedBackend._diag_solve(use_inv=False) (_tri: the
           unrolled inverse at cp <= 8, triangular_solve up to 512,
           _big_panel_solve above)
  K5       vs the bucket step of PlannedBackend.make_add_mv (a dense
           numpy oracle per bucket), and vs make_add_mv itself on whole
           problems whose buckets cover every width class

Synthetic buckets hold two panels of one padded shape, with padded
columns and below rows, at cp 4, 64 and 1024 and rp 0 and 16, for 1 and
3 right-hand sides, over a batch of two. The K3-rest buckets are
factored by the JAX routine, so their strict upper holds Linv^T, which
substitution must not read; the port's copies also carry garbage in
every padded slot, which it must not read either. Tolerance 1e-10
relative: different summation orders, and the JAX package inverts the
cp <= 8 panels where the port substitutes."""

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
from baspacho_tpu_torch.testing.problems import SMALL, spd_data, wide_below
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-10
COLS = {4: (3, 4), 64: (60, 37), 1024: (1000, 700)}
ROWS = (16, 9)
_cache = {}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def bucket(cp, rp):
    """(JAX backend, JAX bucket, port bucket, SPD data, padding mask,
    order) of a two-panel bucket."""
    key = ("bucket", cp, rp)
    if key not in _cache:
        rng = np.random.RandomState(cp + rp)
        h = cp + rp
        cols, rows = COLS[cp], ROWS if rp else (0, 0)
        data = np.zeros(2 * h * cp)
        mask = np.zeros(2 * h * cp)
        for i, (n, r) in enumerate(zip(cols, rows)):
            p = data[i * h * cp:(i + 1) * h * cp].reshape(h, cp)
            m = rng.rand(n, n) - 0.5
            p[:n, :n] = np.tril(m @ m.T + n * np.eye(n))
            p[cp:cp + r, :n] = rng.rand(r, n) - 0.5
            q = mask[i * h * cp:(i + 1) * h * cp].reshape(h, cp)
            q[:n, :n] = 1
            q[cp:cp + r, :n] = 1
        order = sum(cols) + 50
        bidx = np.full((2, max(rp, 1)), order, dtype=np.int32)
        for i, r in enumerate(rows):
            bidx[i, :r] = np.sort(rng.choice(np.arange(sum(cols), order), r,
                                             replace=False))
        kw = dict(rp=rp, cp=cp, off=np.array([0, h * cp], np.int32),
                  rows=np.array(rows, np.int32),
                  cols=np.array(cols, np.int32),
                  vec_off=np.array([0, cols[0]], np.int32), below_idx=bidx)
        tlb = LumpBucket(**kw)
        tlb.members = np.array([0, 1])
        _cache[key] = (SMALL["meri2"](J).backend, JBucket(**kw), tlb, data,
                       mask, order)
    return _cache[key]


def factored(cp, rp, scale):
    """The bucket's data (times `scale`) factored by the JAX routine: L,
    Linv^T strictly above, x below."""
    key = ("factored", cp, rp, scale)
    if key not in _cache:
        jb, jlb, _, data, _, _ = bucket(cp, rp)
        ext = jnp.concatenate([jnp.asarray(scale * data), jnp.zeros(2)])
        f, _ = jax.jit(lambda e: jb._factor_bucket(e, jlb))(ext)
        _cache[key] = np.asarray(f[:-2])
    return _cache[key]


def junk(a, mask, seed):
    """a with garbage in every padded slot."""
    return a + (1 - mask) * np.random.RandomState(seed).rand(len(a))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("rp", [0, 16])
@pytest.mark.parametrize("cp", [4, 64, 1024])
def test_tri_twin_matches_diag_solve(cp, rp, nrhs, transpose):
    jb, jlb, tlb, _, mask, order = bucket(cp, rp)
    fs = [factored(cp, rp, s) for s in (1.0, 2.5)]
    rng = np.random.RandomState(cp + nrhs + 10 * transpose)
    vs = [rng.rand(order, nrhs) for _ in fs]
    run = jax.jit(lambda e, v, bx: jb._diag_solve(
        e, v, jlb, order, transpose, bx if rp else None, use_inv=False))
    want = [np.asarray(run(jnp.concatenate([jnp.asarray(f), jnp.zeros(2)]),
                           jnp.concatenate([jnp.asarray(v),
                                            jnp.zeros((1, nrhs))]),
                           jnp.asarray(jlb.below_idx)))[:order]
            for f, v in zip(fs, vs)]
    data = torch.from_numpy(np.stack([junk(f, mask, i)
                                      for i, f in enumerate(fs)]))
    got = torch.from_numpy(np.stack(vs))
    b = _dev_bucket(tlb, "cpu")
    y = torch.full((2, 2 * rp, nrhs), np.nan, dtype=torch.float64)
    kernels.reset_counts()
    if cp > 512:
        kernels.wide_tri_solve(data, got, y, 0, b.off, b.rows, b.cols,
                               b.vec_off, b.below_idx, b.cp, b.rp,
                               transpose, b.off_h, b.cols_h)
        assert kernels.COUNTS["wide_tri_solve"].twin_calls == 1
    else:
        kernels.tri_solve(data, got, y, 0, b.off, b.rows, b.cols, b.vec_off,
                          b.below_idx, b.cp, b.rp, transpose)
        assert kernels.COUNTS["tri_solve"].twin_calls == 1
    if not transpose and rp:
        assert torch.isfinite(y).all()  # every y row written, 0 if padded
        c = _dev_csr(solve_csr([tlb], [0], order), "cpu")
        kernels.segmented_subtract_twin(got, y, c.tgt, c.seg_ptr, c.src_idx,
                                        nrhs)
    for z in range(2):
        assert rel(got[z].numpy(), want[z]) < RTOL


WIDE_N = {1024: 1000, 3072: 2985}  # real columns of the wide model panels


def chain_items(K, transpose):
    """K3-rest wide's work items (row tile, column tile) of one panel in
    ticket order, as csrc/tri_solve.cu's tri_wide_chain_kernel orders
    them: row by row in the L pass ((k, 0..k-2), then diag k), the mirror
    in the Lt pass, by columns from the last ((K-1..k+2, k), then diag
    k); the adjacent tile (k, k-1) belongs to a diagonal item."""
    items = []
    for g in range(K):
        k = K - 1 - g if transpose else g
        items += [(u, k) for u in range(K - 1, k + 1, -1)] if transpose \
            else [(k, j) for j in range(k - 1)]
        items.append((k, k))
    return items


def chain_deps(item, K, transpose):
    """The items whose output an item reads: diagonal items (their
    solutions) and off-diagonal items (their partial slots)."""
    row, col = item
    if row != col:
        src = row if transpose else col
        return [(src, src)]
    adj = row + 1 if transpose else row - 1
    srcs = range(K - 1, row + 1, -1) if transpose else range(row - 1)
    own = [(u, row) if transpose else (row, u) for u in srcs]
    return own + ([(adj, adj)] if 0 <= adj < K else [])


def chain_model(L, x, transpose, K, nb=128):
    """The chain's arithmetic in numpy on one panel's real lower triangle
    L (n x n) and RHS rows x (n x nrhs): items in ticket order; an
    off-diagonal item (k, j) keeps its partial L[k, j] s_j (Lt: L[k, j]^T
    s_k) in a slot of its own; a diagonal item subtracts its partials in
    source order, then its adjacent tile's product, and multiplies by its
    tile's inverse. Every item reads only what an earlier ticket made
    (a missing key raises)."""
    n = L.shape[0]
    kn = -(-n // nb)
    t = lambda k: slice(k * nb, min(n, (k + 1) * nb))  # noqa: E731
    s, part = {}, {}
    for row, col in chain_items(K, transpose):
        if row >= kn:
            continue
        if row == col:
            adj = row + 1 if transpose else row - 1
            srcs = range(kn - 1, row + 1, -1) if transpose \
                else range(row - 1)
            b = x[t(row)].copy()
            for src in srcs:
                b -= part[(row, src)]
            if 0 <= adj < kn:
                b -= L[t(adj), t(row)].T @ s[adj] if transpose \
                    else L[t(row), t(adj)] @ s[adj]
            tinv = np.linalg.inv(np.tril(L[t(row), t(row)]))
            s[row] = (tinv.T if transpose else tinv) @ b
        else:
            src, tgt = (row, col) if transpose else (col, row)
            blk = L[t(row), t(col)]
            part[(tgt, src)] = (blk.T if transpose else blk) @ s[src]
    return np.concatenate([s[k] for k in range(kn)])


def wide_panel(cp, rp):
    """One wide panel (cp 1024 or 3072, WIDE_N real columns, rp padded
    below rows, 9 real) with garbage above the diagonal and in the
    padding: (data, bucket, order)."""
    key = ("wide", cp, rp)
    if key not in _cache:
        rng = np.random.RandomState(cp + rp)
        n, r = WIDE_N[cp], 9 if rp else 0
        p = rng.rand(cp + rp, cp)  # garbage everywhere ...
        p[:n, :n] = np.triu(p[:n, :n], 1) + np.diag(1 + rng.rand(n)) + \
            np.tril(rng.rand(n, n) - 0.5, -1) * (2.0 / n)  # ... but L
        p[cp:cp + r, :n] = rng.rand(r, n) - 0.5
        order = n + 40
        bidx = np.full((1, max(rp, 1)), order, dtype=np.int32)
        bidx[0, :r] = np.sort(rng.choice(np.arange(n, order), r,
                                         replace=False))
        lb = LumpBucket(rp=rp, cp=cp, off=np.array([0], np.int32),
                        rows=np.array([r], np.int32),
                        cols=np.array([n], np.int32),
                        vec_off=np.array([0], np.int32), below_idx=bidx)
        lb.members = np.array([0])
        _cache[key] = (p.reshape(-1), lb, order)
    return _cache[key]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("rp", [0, 16])
@pytest.mark.parametrize("cp", [1024, 3072])
def test_wide_chain_model_matches_twin(cp, rp, nrhs, transpose):
    """K3-rest wide's scheme (tickets in column order, partials summed in
    source order, each diagonal tile's inverse), modelled in numpy with
    the wrapper's gather and below terms around it, equals the twin
    (_tri_plain) on a panel whose strict upper and padding hold garbage:
    vv, and y in the L pass."""
    data, lb, order = wide_panel(cp, rp)
    n, r = int(lb.cols[0]), int(lb.rows[0])
    P = data.reshape(cp + rp, cp)
    L, below = np.tril(P[:n, :n]), P[cp:cp + r, :n]
    bidx = lb.below_idx[0, :r]
    vv = np.random.RandomState(nrhs).rand(order, nrhs)
    x = vv[:n].copy()
    if transpose:
        x -= below.T @ vv[bidx]
    want = vv.copy()
    want[:n] = chain_model(L, x, transpose, cp // 128)
    got = torch.from_numpy(vv.copy())[None]
    y = torch.full((1, rp, nrhs), np.nan, dtype=torch.float64)
    b = _dev_bucket(lb, "cpu")
    kernels._tri_plain(torch.from_numpy(data)[None], got, y, 0, b.off,
                       b.rows, b.cols, b.vec_off, b.below_idx, cp, rp,
                       transpose)
    assert rel(got[0].numpy(), want) < RTOL
    if rp and not transpose:
        assert rel(y[0, :r].numpy(), below @ want[:n]) < RTOL
        assert not y[0, r:].numpy().any()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("problems", [1, 3])
def test_wide_chain_items_wait_only_on_earlier_tickets(problems, transpose):
    """Every item of the chain reads only what items with smaller tickets
    make, for every tile count up to the 3072-wide corner's 24 and any
    number of interleaved panels (ticket = item * problems + panel), and
    each diagonal's partials are all made: a CTA then never waits on a
    ticket no running CTA holds."""
    for K in range(1, 25):
        items = chain_items(K, transpose)
        adjacent = {(k, k - 1) for k in range(1, K)}
        assert sorted(items) == sorted(
            (k, j) for k in range(K) for j in range(k + 1)
            if (k, j) not in adjacent)
        ticket = {}
        for li, it in enumerate(items):
            for p in range(problems):
                ticket[(p, it)] = li * problems + p
        for (p, it), tk in ticket.items():
            for d in chain_deps(it, K, transpose):
                assert ticket[(p, d)] < tk


def _mv_oracle(data, x, out, tlb, order, alpha):
    """out + alpha M x for the bucket's panels, dense numpy."""
    res = out.copy()
    h = tlb.cp + tlb.rp
    for i in range(2):
        n, r, v0 = int(tlb.cols[i]), int(tlb.rows[i]), int(tlb.vec_off[i])
        p = data[int(tlb.off[i]):int(tlb.off[i]) + h * tlb.cp].reshape(
            h, tlb.cp)
        lo = np.tril(p[:n, :n])
        sym = lo + np.tril(lo, -1).T
        res[v0:v0 + n] += alpha * (sym @ x[v0:v0 + n])
        if r:
            below = p[tlb.cp:tlb.cp + r, :n]
            bi = tlb.below_idx[i, :r]
            res[v0:v0 + n] += alpha * (below.T @ x[bi])
            res[bi] += alpha * (below @ x[v0:v0 + n])
    return res


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("rp", [0, 16])
@pytest.mark.parametrize("cp", [4, 64, 1024])
def test_add_mv_twin_matches_bucket_oracle(cp, rp, nrhs):
    """On factored data (Linv^T above the diagonal, which the mat-vec
    must not read) with garbage in the padding; the below scatter runs
    through the K2 twin, as in make_add_mv."""
    _, _, tlb, _, mask, order = bucket(cp, rp)
    fs = [factored(cp, rp, s) for s in (1.0, 2.5)]
    rng = np.random.RandomState(cp + nrhs)
    xs = [rng.rand(order, nrhs) for _ in fs]
    outs = [rng.rand(order, nrhs) for _ in fs]
    want = [_mv_oracle(f, x, o, tlb, order, -0.6)
            for f, x, o in zip(fs, xs, outs)]
    data = torch.from_numpy(np.stack([junk(f, mask, i)
                                      for i, f in enumerate(fs)]))
    got = torch.from_numpy(np.stack(outs))
    b = _dev_bucket(tlb, "cpu")
    y = torch.full((2, 2 * rp, nrhs), np.nan, dtype=torch.float64)
    op = kernels.wide_add_mv if cp > 512 else kernels.add_mv
    kernels.reset_counts()
    op(data, torch.from_numpy(np.stack(xs)), got, y, 0, b.off, b.rows,
       b.cols, b.vec_off, b.below_idx, b.cp, b.rp, -0.6)
    assert kernels.COUNTS[op.__name__].twin_calls == 1
    if rp:
        assert torch.isfinite(y).all()
        c = _dev_csr(solve_csr([tlb], [0], order), "cpu")
        kernels.segmented_subtract_twin(got, y, c.tgt, c.seg_ptr, c.src_idx,
                                        nrhs)
    for z in range(2):
        assert rel(got[z].numpy(), want[z]) < RTOL


@pytest.mark.parametrize("name", ["meri3", "elim_range", "wide_below"])
def test_add_mv_matches_jax_make_add_mv(name):
    """Whole problems on the JAX solver's skeleton: together their
    add_mv buckets have panels of every width class, with and without
    below rows."""
    js = (wide_below if name == "wide_below" else SMALL[name])(J)
    ts = T.solver_from_skeleton(T.skeleton_arrays(js.skel), js.permutation,
                                js.sparse_elim_ranges, device="cpu")
    data = spd_data(js, 4)
    rng = np.random.RandomState(6)
    x, out = rng.rand(2, ts.order, 3), rng.rand(2, ts.order, 3)
    datas = np.stack([data, 1.5 * data])
    got = ts.add_mv_from(torch.from_numpy(datas), 0, torch.from_numpy(x),
                         torch.from_numpy(out), 0.8).numpy()
    for z in range(2):
        want = np.asarray(js.add_mv_from(datas[z], 0, x[z], out[z], 0.8))
        assert rel(got[z], want) < RTOL
    classes = {("tiny" if lb.cp <= 8 else "narrow" if lb.cp <= 512
                else "wide", lb.rp > 0)
               for lb in ts.backend._bucket_lumps(
                   np.arange(ts.skel.num_lumps), True)}
    assert {"meri3": {("tiny", True), ("narrow", True), ("tiny", False),
                      ("narrow", False)},
            "elim_range": {("tiny", True), ("tiny", False)},
            "wide_below": {("wide", True), ("narrow", True)}}[name] \
        <= classes


def test_new_wrappers_never_fall_back_off_cpu():
    """A tensor on a device other than the CPU goes to the kernel path,
    which refuses anything that is not CUDA: no silent twin."""
    d = torch.empty((1, 16), dtype=torch.float64, device="meta")
    v = d.view(1, 16, 1)
    i = torch.empty(1, dtype=torch.int64, device="meta")
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.tri_solve(d, v, None, 0, i, i, i, i, i, 4, 0, True)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.wide_tri_solve(d, v, None, 0, i, i, i, i, i, 1024, 0, True,
                               (0,), (1000,))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.add_mv(d, v, v, None, 0, i, i, i, i, i, 4, 0, 1.0)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.wide_add_mv(d, v, v, None, 0, i, i, i, i, i, 1024, 0, 1.0)
    with pytest.raises(ValueError, match="batch"):
        kernels.add_mv(torch.zeros((2, 8)), torch.zeros((1, 8, 1)),
                       torch.zeros((1, 8, 1)), None, 0, i, i, i, i, i, 4, 0,
                       1.0)
    assert all(c.twin_calls == 0 and c.launches == 0
               for c in kernels.COUNTS.values())
