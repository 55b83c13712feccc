"""Host schedule of the planned factor and solve (numpy only).

The host half of `baspacho_tpu/ops/planned_backend.py`, copied close to
line for line so a diff against the original shows what changed:

  * padding policy `pad_dim` / `storage_pad` / `_pad_pow2` (shared with
    the skeleton's storage layout, so both packages build the same
    padded buffer);
  * `LumpBucket` / `PairBucket` and the per-level bucketing
    `_bucket_lumps` (without the TPU panel-footprint cap, which exists
    for the TPU's (8, 128) tiling);
  * the block-pair enumeration `_build_pairs`, which returns one flat
    run list per level: the JAX package's shape groups, padding and
    chunking serve XLA's static shapes, and nothing here reads them;
  * `_factor_schedule` / `_solve_schedule`;
  * the compact row space of `_build_dense_update` (touched spans,
    `compact_start`, per-origin compact rows) behind `DenseUpdate`.

A level's update runs through one of two mechanisms:

  pairs  each origin's product x . x^T goes to a product buffer, and the
         level's block pairs subtract it into the targets (K1 + K2);
  dense  no pairs: the dense-level kernel (K4) sums x_o[a] . x_o[b]^T
         over the origins that share the target span-block (a, b),
         straight into the target panel, from records sorted by
         destination (a wide origin's x x^T is summed by tiles of its
         below rows instead).

The port's rule (its own; the JAX package prices the two against TPU
cost constants): a level goes dense when the volume of its origins'
products, sum_o rows_o^2, exceeds the area R^2 of the compact row space
their below rows span, i.e. when the origins overlap so much that the
pair path's product buffer and per-element CSR would outgrow a dense
R x R update (a lone origin, whose volume is exactly R^2, stays on
pairs). A level with an origin wider than `NARROW_MAX` also
goes dense, since the blocked wide factor writes no product. The test
reads only per-origin row counts and the union of the origins' below
spans, both linear in the number of below chains, so a level is never
enumerated per element or per pair before it goes dense. On the
reference problems it sends every level of MERI and GRID to pairs
(overlap <= 0.74) and every sparse-elimination Schur level dense
(overlap >= 1.58). `PlannedSchedule(plan, assembly="dense"|"pairs")`
forces either mechanism on every level (levels with a wide origin stay
dense), for the tests.

The JAX package's one-hot / W / span-granular chunk planning, outlier
routing and gap closing are TPU scatter workarounds and are not ported:
K4's cost does not depend on how far an origin's rows spread.

Added for the hand-written kernels: `pair_csr` and `solve_csr` turn a
level's contributions into a target-sorted CSR (stable in origin order),
which the deterministic segmented-subtract kernel consumes.

The schedule split over the n ranks of a process group
(`factor_share` / `solve_share`, for make_factor_sharded /
make_solve_sharded): a
bucket of at least n * SHARD_MIN_B panels is split into n contiguous
shares (`share_bounds`, `bucket_share`), smaller ones run replicated.
Unlike the JAX package, shares are not padded to one size: only the
all-gather's packs are (`FactorShare.pack_len`), and no padded slot is
ever written back. A dense level with a split bucket gives each rank a
DenseUpdate over its own origins (the replicated buckets' on rank 0) and
the level's target elements (`dense_targets`), which the ranks'
updates are summed over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import trace
from .plan import NumericPlan

NARROW_MAX = 512  # widest padded panel the one-CTA bucket factor takes;
#                   wider buckets (512-multiples) take the blocked path


def pad_dim(x: int, floor: int = 1) -> int:
    """Bucket-shape padding: next power of two (with a floor) up to 512,
    then next multiple of 512. Coarse pow2 padding keeps bucket count low
    for the long tail of small shapes, while the 512-multiple regime caps
    the waste on large panels. Floors (8 for panel rows, 4 for block
    dims) collapse tiny shapes into single buckets."""
    if x <= floor:
        return floor
    if x <= 512:
        return int(2 ** int(np.ceil(np.log2(x))))
    return ((x + 511) // 512) * 512


PAD_ROWS = 8    # floor for below-diag panel rows
PAD_COLS = 4    # floor for lump widths / pair block dims


def storage_pad(below_rows, widths):
    """Padded panel shape policy shared by the skeleton storage layout and
    the planned backend's buckets: power-of-two with floors; columns with
    no below rows get no row padding."""
    below_rows = np.asarray(below_rows, dtype=np.int64)
    prp = np.where(below_rows == 0, 0, _pad_pow2(below_rows, PAD_ROWS))
    return prp, _pad_pow2(np.asarray(widths, dtype=np.int64), PAD_COLS)


def _i32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int32)


def _pad_pow2(x: np.ndarray, floor: int) -> np.ndarray:
    """Vectorized pad_dim (pow2 up to 512, then 512-multiples)."""
    x = np.maximum(np.asarray(x, dtype=np.int64), floor)
    p2 = np.int64(1) << np.ceil(np.log2(x)).astype(np.int64)
    return np.where(x <= 512, p2, (x + 511) // 512 * 512)


@dataclass
class LumpBucket:
    """Same-padded-shape supernode panels factored as one batched op.

    Each panel is [(cp x cp) padded diag | (rp x cp) padded below] at
    flat offset `off`."""
    rp: int              # padded below rows
    cp: int              # padded lump width (= panel row stride)
    off: np.ndarray      # (B,) panel flat-data offsets
    rows: np.ndarray     # (B,) actual below rows
    cols: np.ndarray     # (B,) actual lump widths
    vec_off: np.ndarray  # (B,) RHS offsets
    below_idx: np.ndarray = None  # (B, rp) RHS rows of below rows (solve)
    prod_base: int = 0   # offset of this bucket's outer products in the
    #                      level's concatenated flat product buffer
    members: list = None  # lump ids in bucket order


@dataclass
class PairBucket:
    """Run-coalesced update blocks of one level, in enumeration order
    (origin column, then column run, then row run). Each entry subtracts
    a (rs x cs) block of the level product buffer into a contiguous-rows
    region of a target panel; rows are maximal runs of consecutive spans
    (adjacent chains in the target column, hence contiguous memory in the
    padded layout). The JAX package splits these into shape groups padded
    for XLA's static shapes; the hand-written assembly reads them per
    element (`pair_csr`), so here they stay one flat list."""
    src_base: np.ndarray    # (P,) flat offset of block in product buffer
    src_stride: np.ndarray  # (P,) product row stride (rp of origin bucket)
    rs: np.ndarray          # (P,) rows
    cs: np.ndarray          # (P,) cols
    c0: np.ndarray          # (P,) column offset inside the target panel
    tgt_row_start: np.ndarray  # (P,) flat offset of the block's first row
    #                            at column 0 of the target panel
    tgt_stride: np.ndarray  # (P,) per-pair target panel stride


DENSE_LONG = 32      # K4 destinations with more records are long
DENSE_CHUNK = 256    # records of one work item of K4's f64 long grid,
DENSE_TC_TILE = 16   # and its tile edge (csrc/dense_level.cu kMmaChunk,
#                      dense_mma_kernel's 16 x 16 tiles)
DENSE_NK = 32        # widest k-slice of one K4 record
DENSE_PIECE = 32     # K4 destinations are at most DENSE_PIECE square
DENSE_TILE = 64      # tile edge of K4's wide-origin product


@dataclass
class DenseUpdate:
    """One dense level's update, for the dense-level kernel (K4).

    Compact row space: the level's touched spans (below spans of its
    origins) concatenated in span order, R rows. Origins are the level's
    lumps with below rows, in bucket order; their solved below blocks x
    (written in place by the bucket factor) are read from the data.

    The target of span-block (a, b), a >= b, is slice q in
    [slice_ptr[s], slice_ptr[s + 1]) of touched span b (index s into
    `tspans`): rows of span a start at compact row sl_cs[q] and at flat
    offset sl_off[q] (column 0 of b) with row stride sp_ld[s]. Slices of
    one span ascend in sl_cs.

    K4's plan for the narrow origins (panels of at most NARROW_MAX
    columns), destination-sorted: a destination is a span-block (a, b),
    or a DENSE_PIECE-square piece of it where a span is wider; one record
    per (destination, narrow origin whose below rows hold both spans),
    origins in order within a destination: rec[p] = (xb, dr << 32 | ld <<
    16 | n), x_o[b]'s first element (plus the slice's first column) at
    data offset xb, x_o[a]'s dr rows further (dr < 0 for a piece above
    its column piece in a diagonal block), row stride ld, n columns; an
    origin wider than DENSE_NK columns gives one record per k-slice.
    Destination d subtracts the sum of its records rec[dst_ptr[d]:
    dst_ptr[d + 1]] from dst_rows x dst_cols elements at dst_off + i *
    dst_ld + j; dst_nk is its widest record; dst_short / dst_long split
    them at DENSE_LONG records; long_records counts dst_long's records.

    In f64 the long destinations are summed on the tensor cores by work
    items, destination by destination: each DENSE_TC_TILE-square tile of
    a destination, its records cut into the fewest chunks of at most
    DENSE_CHUNK, as even as can be. tc_item[k] = (first record, end
    record, s << 2 | tile, slot): tile's bit 1 the row half, bit 0 the
    column half of destination s; slot -1 where the tile is one chunk
    (the item subtracts its sum), else the scratch slot of its partial
    sum, consecutive for a tile's chunks; tc_post[j] = (s << 2 | tile,
    first slot, chunks) for each tile of more than one chunk, summed in
    chunk order; tc_slots slots in all.

    A wide origin (panel wider than NARROW_MAX: hundreds to thousands of
    columns, few origins, whose span-blocks would re-read x from memory
    for every destination) is summed by tiles of x x^T instead: `wide`
    holds (xoff, rows, width, ld, row0, pair0, chain0, tile0, tiles) per
    wide origin, indexing the concatenated w_* arrays: w_tile (I << 32 |
    J) lists the DENSE_TILE-square tiles of its below rows with a row
    chain at or past a column chain, w_rch / w_rin each below row's chain
    (0-based in the origin) and row inside its span, w_pt each chain
    pair's target offset (a >= b at a (a + 1) / 2 + b), w_cld each
    chain's target row stride. The compact rows and origin groups serve
    the plain twin."""
    R: int
    max_span: int
    tspans: np.ndarray     # (S,) touched spans, ascending
    sp_cs: np.ndarray      # (S,) compact start
    sp_size: np.ndarray    # (S,) rows
    sp_ld: np.ndarray      # (S,) row stride of the span's lump panel
    crow: np.ndarray       # (N,) compact row of every origin below row
    slice_ptr: np.ndarray  # (S + 1,)
    sl_cs: np.ndarray      # (Q,)
    sl_size: np.ndarray    # (Q,)
    sl_off: np.ndarray     # (Q,)
    org_xoff: np.ndarray   # (O,) flat offset of each origin's below block
    org_rows: np.ndarray   # (O,) below rows
    org_cols: np.ndarray   # (O,) width
    org_rptr: np.ndarray   # (O + 1,) extents into crow
    groups: list           # (cp, rp, first, end) origin ranges per bucket
    rec: np.ndarray        # (M, 2) records, destination-sorted
    dst_off: np.ndarray    # (T,)
    dst_ld: np.ndarray     # (T,)
    dst_rows: np.ndarray   # (T,)
    dst_cols: np.ndarray   # (T,)
    dst_nk: np.ndarray     # (T,)
    dst_ptr: np.ndarray    # (T + 1,)
    dst_short: np.ndarray  # destinations with <= DENSE_LONG records
    dst_long: np.ndarray   # the others
    long_records: int
    tc_item: np.ndarray    # (K, 4)
    tc_post: np.ndarray    # (P, 3)
    tc_slots: int
    wide: list             # per wide origin, see above
    w_tile: np.ndarray
    w_rch: np.ndarray
    w_rin: np.ndarray
    w_pt: np.ndarray
    w_cld: np.ndarray


def _expand(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenation of the ranges [starts[i], starts[i] + counts[i])."""
    tot = int(counts.sum())
    ex = np.cumsum(counts) - counts
    return np.repeat(starts - ex, counts) + np.arange(tot, dtype=np.int64)


def _dense_records(sp, org_of, grow, rptr, nch, xoff, ld, width, span_size,
                   tspans, sl_span, slice_ptr, sl_off, sp_ld,
                   num_spans) -> dict:
    """K4's plan (DenseUpdate), vectorised but for a loop over the wide
    origins. sp, org_of, grow: span, origin and first row of every below
    chain of the level's origins, origins in order; sl_span the span a of
    each slice."""
    n_sl = np.diff(slice_ptr)
    s_of = np.repeat(np.arange(len(tspans)), n_sl)
    keys = s_of * num_spans + sl_span
    cstart = np.cumsum(nch) - nch

    def target(ia, jb):
        """The slice of each chain pair (ia at or past jb)."""
        key = np.searchsorted(tspans, sp[jb]) * num_spans + sp[ia]
        q = np.searchsorted(keys, key)
        assert np.array_equal(keys[q], key), "span-block without a target"
        return q

    # narrow origins: every (chain a >= chain b) pair, by origin, then b
    wide_o = ld > NARROW_MAX
    nc = len(sp)
    cnt = np.where(wide_o[org_of], 0, (cstart + nch)[org_of] - np.arange(nc))
    jb = np.repeat(np.arange(nc), cnt)
    ia = _expand(np.arange(nc), cnt)
    q = target(ia, jb)
    # destinations: the pieces of each slice, row piece-major
    rows_q, cols_q = span_size[sl_span], span_size[tspans][s_of]
    npr = (rows_q + DENSE_PIECE - 1) // DENSE_PIECE
    npc = (cols_q + DENSE_PIECE - 1) // DENSE_PIECE
    npq = npr * npc
    pbase = np.cumsum(npq) - npq
    e = np.repeat(np.arange(len(q)), npq[q])  # a pair per piece
    loc = np.arange(len(e)) - np.repeat(np.cumsum(npq[q]) - npq[q], npq[q])
    q, pr, pc = q[e], loc // npc[q[e]], loc % npc[q[e]]
    order = np.argsort(pbase[q] + loc, kind="stable")  # keeps origin order
    e, q, pr, pc = e[order], q[order], pr[order], pc[order]
    u = pbase[q] + pr * npc[q] + pc
    o = org_of[jb[e]]
    la = grow[ia[e]] - rptr[o] + pr * DENSE_PIECE  # rows in the origin
    lb = grow[jb[e]] - rptr[o] + pc * DENSE_PIECE
    # k-slices of at most DENSE_NK columns
    w = width[o]
    ns = (w + DENSE_NK - 1) // DENSE_NK
    sl = np.repeat(np.arange(len(ns)), ns)
    k0 = (np.arange(int(ns.sum())) - np.repeat(np.cumsum(ns) - ns, ns)) * \
        DENSE_NK
    nk = np.minimum(DENSE_NK, w[sl] - k0)
    ldr = ld[o][sl]
    assert not np.any(ldr >= 1 << 16), "narrow origins are at most 512 wide"
    rec = np.stack([(xoff[o] + lb * ld[o])[sl] + k0,
                    ((la - lb)[sl] << 32) | (ldr << 16) | nk], axis=1)
    used, start, count = np.unique(u[sl], return_index=True,
                                   return_counts=True)
    # each destination's slice and piece
    dq = np.repeat(np.arange(len(npq)), npq)[used]
    dl = used - pbase[dq]
    dpr, dpc = dl // npc[dq], dl % npc[dq]
    long_ = count > DENSE_LONG
    dst_rows = np.minimum(DENSE_PIECE, rows_q[dq] - dpr * DENSE_PIECE)
    dst_cols = np.minimum(DENSE_PIECE, cols_q[dq] - dpc * DENSE_PIECE)

    # wide origins: tiles of x x^T, targets per chain pair
    parts = {k: [] for k in ("tile", "rch", "rin", "pt", "cld")}
    wide, r0 = [], [0, 0, 0, 0]
    for w_ in np.flatnonzero(wide_o):
        ch = cstart[w_] + np.arange(nch[w_])
        sz = span_size[sp[ch]]
        n_r = int(sz.sum())
        rch = np.repeat(np.arange(len(ch)), sz)
        a, b = np.tril_indices(len(ch))
        nt = (n_r + DENSE_TILE - 1) // DENSE_TILE
        first = np.arange(nt) * DENSE_TILE
        last = rch[np.minimum(first + DENSE_TILE, n_r) - 1]
        ti, tj = np.nonzero(last[:, None] >= rch[first][None, :])
        new = dict(tile=(ti.astype(np.int64) << 32) | tj, rch=rch,
                   rin=np.arange(n_r) - np.repeat(np.cumsum(sz) - sz, sz),
                   pt=sl_off[target(ch[a], ch[b])],
                   cld=sp_ld[np.searchsorted(tspans, sp[ch])])
        wide.append((int(xoff[w_]), n_r, int(width[w_]), int(ld[w_]),
                     r0[0], r0[1], r0[2], r0[3], len(ti)))
        for k, v in new.items():
            parts[k].append(v.astype(np.int64))
        r0 = [r0[0] + n_r, r0[1] + len(a), r0[2] + len(ch), r0[3] + len(ti)]
    cat = {f"w_{k}": np.concatenate(v) if v else np.zeros(0, np.int64)
           for k, v in parts.items()}
    return dict(
        rec=rec,
        dst_off=sl_off[dq] + dpr * DENSE_PIECE * sp_ld[s_of[dq]] +
        dpc * DENSE_PIECE,
        dst_ld=sp_ld[s_of[dq]],
        dst_rows=dst_rows, dst_cols=dst_cols,
        dst_nk=np.maximum.reduceat(nk, start) if len(start) else start,
        dst_ptr=np.append(start, len(rec)),
        dst_short=np.flatnonzero(~long_), dst_long=np.flatnonzero(long_),
        long_records=int(count[long_].sum()),
        **_tc_items(np.flatnonzero(long_), start, count, dst_rows, dst_cols),
        wide=wide, **cat)


def _tc_items(long_, start, count, rows, cols) -> dict:
    """The f64 long grid's work items and post list (DenseUpdate) of the
    long destinations `long_`, from every destination's first record,
    record count, rows and columns."""
    t = DENSE_TC_TILE
    n, p0 = count[long_], start[long_]
    tc = (cols[long_] + t - 1) // t
    nt = (rows[long_] + t - 1) // t * tc
    nchk = (n + DENSE_CHUNK - 1) // DENSE_CHUNK
    dt = np.repeat(np.arange(len(long_)), nt)  # per tile: its destination
    tl = np.arange(len(dt)) - np.repeat(np.cumsum(nt) - nt, nt)
    key = long_[dt] << 2 | (tl // tc[dt]) << 1 | tl % tc[dt]
    nk = nchk[dt]
    it = np.repeat(np.arange(len(dt)), nk)  # per item: its tile
    ck = np.arange(len(it)) - np.repeat(np.cumsum(nk) - nk, nk)
    d = dt[it]
    multi = nk > 1
    slots = np.where(multi, nk, 0)
    slot0 = np.cumsum(slots) - slots
    item = np.stack([p0[d] + ck * n[d] // nk[it],
                     p0[d] + (ck + 1) * n[d] // nk[it], key[it],
                     np.where(multi[it], slot0[it] + ck, -1)], axis=1)
    post = np.stack([key[multi], slot0[multi], nk[multi]], axis=1)
    return dict(tc_item=item.astype(np.int64).reshape(-1, 4),
                tc_post=post.astype(np.int64).reshape(-1, 3),
                tc_slots=int(slots.sum()))


class PlannedSchedule:
    """Level schedule of one plan: lump buckets, product-buffer offsets
    and assembly block pairs, or the dense update, per level (host,
    cached per lump range). `assembly` ("dense" or "pairs") forces one
    mechanism on every level, for the tests."""

    def __init__(self, plan: NumericPlan, assembly: Optional[str] = None):
        if assembly not in (None, "dense", "pairs"):
            raise ValueError(f"assembly {assembly!r}: None, 'dense' or "
                             "'pairs'")
        self.assembly = assembly
        self.plan = plan
        self.num_levels = int(plan.lump_levels.max()) + 1 \
            if len(plan.lump_levels) else 0
        self._sched_cache: Dict[Tuple[int, int], list] = {}
        self._solve_cache: Dict[Tuple[int, int], list] = {}
        # global chain lookup: key (lump_of_chain, row_span) is globally
        # ascending in chain storage order -> one searchsorted resolves any
        # (target lump, span) to its chain index
        sk = plan.skel
        chain_lump = np.repeat(
            np.arange(sk.num_lumps, dtype=np.int64),
            sk.chain_col_ptr[1:] - sk.chain_col_ptr[:-1])
        self._chain_keys = chain_lump * sk.num_spans + sk.chain_row_span

    def _by_level(self, start: int, end: int) -> List[np.ndarray]:
        """Lump ids of [start, end) grouped by schedule level (ascending),
        preserving id order within a level (none for an empty range)."""
        if end <= start:
            return []
        lv = np.asarray(self.plan.lump_levels[start:end])
        ids = np.arange(start, end, dtype=np.int64)
        order = np.argsort(lv, kind="stable")
        lv_s, ids_s = lv[order], ids[order]
        brk = (np.nonzero(np.diff(lv_s))[0] + 1).tolist()
        bounds = [0, *brk, len(ids_s)]
        return [ids_s[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def _factor_schedule(self, start: int, end: int):
        key = (start, end)
        sched = self._sched_cache.get(key)
        if sched is None:
            with trace.span("programs.schedule"):
                sched = [self._build_level(lds, with_below_idx=True)
                         for lds in self._by_level(start, end)]
            self._sched_cache[key] = sched
        return sched

    def _build_level(self, lds, with_below_idx=False):
        """Bucket the level's lumps (`lds` is an array of lump ids); plan
        the dense update, or else assign product-buffer offsets to buckets
        with below rows and enumerate the assembly block pairs. Returns
        (lump_buckets, pairs, product-buffer size, dense), with pairs None
        and size 0 on a dense level, dense None on a pair level."""
        lds = np.asarray(lds, dtype=np.int64)
        lump_buckets = self._bucket_lumps(lds, with_below_idx)
        dense = self._dense_update(lump_buckets)
        if dense is not None:
            return lump_buckets, None, 0, dense
        prod_total = 0
        origin_pos: Dict[int, Tuple[int, int]] = {}
        for lb in lump_buckets:
            if lb.rp == 0:
                continue
            lb.prod_base = prod_total
            for bi, l in enumerate(lb.members.tolist()):
                origin_pos[l] = (prod_total + bi * lb.rp * lb.rp, lb.rp)
            prod_total += len(lb.off) * lb.rp * lb.rp
        pairs = self._build_pairs(lds, origin_pos)
        return lump_buckets, pairs, prod_total, None

    def _dense_update(self, lump_buckets,
                      force: bool = False) -> Optional[DenseUpdate]:
        """The level's DenseUpdate when the rule of the module docstring
        sends it dense (or, with `force`, whenever the buckets hold an
        origin: one rank's part of a dense level), else None (vectorized:
        the rule is linear in the origins' below chains and rows, K4's
        records in the pairs of each origin's below chains)."""
        sk = self.plan.skel
        span_size = sk.span_start[1:] - sk.span_start[:-1]
        org, xoff, ld, width, groups = [], [], [], [], []
        for lb in lump_buckets:
            keep = lb.rows > 0
            if lb.rp == 0 or not np.any(keep):
                continue
            first = sum(len(m) for m in org)
            org.append(np.asarray(lb.members)[keep])
            xoff.append(lb.off[keep].astype(np.int64) + lb.cp * lb.cp)
            ld.append(np.full(int(keep.sum()), lb.cp, np.int64))
            width.append(lb.cols[keep].astype(np.int64))
            groups.append((lb.cp, lb.rp, first, first + len(org[-1])))
        if not org:
            return None
        org, xoff = np.concatenate(org), np.concatenate(xoff)
        ld, width = np.concatenate(ld), np.concatenate(width)

        # below chains of every origin, origins in order
        nd = sk.lump_to_span[org + 1] - sk.lump_to_span[org]
        c0 = sk.chain_col_ptr[org] + nd
        nch = sk.chain_col_ptr[org + 1] - c0
        sp = sk.chain_row_span[_expand(c0, nch)]
        sz = span_size[sp]
        org_of = np.repeat(np.arange(len(org), dtype=np.int64), nch)
        rows = np.bincount(org_of, weights=sz,
                           minlength=len(org)).astype(np.int64)
        tspans = np.unique(sp)
        R = int(span_size[tspans].sum())
        wide = bool(np.any(ld > NARROW_MAX))
        if not (wide or force):
            if self.assembly == "pairs":
                return None
            overlap = float((rows.astype(np.float64) ** 2).sum()) / R / R
            if self.assembly != "dense" and overlap <= 1.0:
                return None

        compact_start = np.zeros(sk.num_spans, dtype=np.int64)
        tsize = span_size[tspans]
        compact_start[tspans] = np.cumsum(tsize) - tsize
        rptr = np.concatenate([[0], np.cumsum(rows)])
        grow = np.cumsum(sz) - sz  # first row of each chain, into crow
        crow = np.repeat(compact_start[sp] - grow, sz) + \
            np.arange(int(rptr[-1]), dtype=np.int64)

        # target slices: per touched span b of lump t, the touched chains
        # of t's column from b down (a >= b, spans ascending)
        tl = np.unique(sk.span_to_lump[tspans])
        ch = _expand(sk.chain_col_ptr[tl],
                     sk.chain_col_ptr[tl + 1] - sk.chain_col_ptr[tl])
        ct = np.repeat(tl, sk.chain_col_ptr[tl + 1] - sk.chain_col_ptr[tl])
        touched = np.zeros(sk.num_spans, dtype=bool)
        touched[tspans] = True
        keep = touched[sk.chain_row_span[ch]]
        ch, ct = ch[keep], ct[keep]
        cs = sk.chain_row_span[ch]
        bounds = np.concatenate(
            [[0], np.nonzero(ct[1:] != ct[:-1])[0] + 1, [len(ct)]])
        own = np.nonzero((cs >= sk.lump_to_span[ct]) &
                         (cs < sk.lump_to_span[ct + 1]))[0]
        assert np.array_equal(cs[own], tspans), "touched span without chain"
        grp_end = bounds[np.searchsorted(bounds, own, side="right")]
        n_sl = grp_end - own
        q = _expand(own, n_sl)
        slice_ptr = np.concatenate([[0], np.cumsum(n_sl)])
        sl_cs, sl_size = compact_start[cs[q]], span_size[cs[q]]
        sl_off = sk.chain_data[ch[q]] + \
            np.repeat(sk.span_offset_in_lump[tspans], n_sl)
        sp_ld = sk.col_stride[ct[own]].astype(np.int64)
        plan = _dense_records(
            sp, org_of, grow, rptr, nch, xoff, ld, width, span_size, tspans,
            cs[q], slice_ptr, sl_off, sp_ld, sk.num_spans)
        return DenseUpdate(
            R=R, max_span=int(tsize.max()), tspans=tspans,
            sp_cs=compact_start[tspans], sp_size=tsize, sp_ld=sp_ld,
            crow=crow, slice_ptr=slice_ptr, sl_cs=sl_cs, sl_size=sl_size,
            sl_off=sl_off, org_xoff=xoff, org_rows=rows, org_cols=width,
            org_rptr=rptr, groups=groups, **plan)

    def _bucket_lumps(self, lds, with_below_idx: bool) -> List[LumpBucket]:
        """Group the lump ids by padded panel shape (fully vectorized)."""
        plan = self.plan
        order = plan.skel.order
        lds = np.asarray(lds, dtype=np.int64)
        if not len(lds):
            return []
        prp_a = plan.lump_prp[lds]
        cp_a = plan.lump_strides[lds]
        co_a = plan.lump_col_offset[lds]
        sort_idx = np.lexsort((co_a, cp_a, prp_a))
        g_all = lds[sort_idx]
        prp_s, cp_s, co_s = prp_a[sort_idx], cp_a[sort_idx], co_a[sort_idx]
        brk = (np.nonzero((prp_s[1:] != prp_s[:-1]) |
                          (cp_s[1:] != cp_s[:-1]))[0] + 1).tolist()
        bounds = [0, *brk, len(g_all)]
        ptr = plan.below_row_ptr
        flat = plan.below_rows_flat
        out = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            g = g_all[a:b]
            rp, cp = int(prp_s[a]), int(cp_s[a])
            bidx = None
            if with_below_idx:
                bidx = np.full((len(g), max(rp, 1)), order, dtype=np.int32)
                cnt = ptr[g + 1] - ptr[g]
                tot = int(cnt.sum())
                if tot:
                    ii = np.repeat(np.arange(len(g)), cnt)
                    ex = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                    jj = np.arange(tot, dtype=np.int64) - np.repeat(ex, cnt)
                    src = np.repeat(ptr[g] - ex, cnt) + \
                        np.arange(tot, dtype=np.int64)
                    bidx[ii, jj] = flat[src]
            lb = LumpBucket(
                rp=rp, cp=cp, off=_i32(co_s[a:b]),
                rows=_i32(plan.lump_total_rows[g] - plan.lump_sizes[g]),
                cols=_i32(plan.lump_sizes[g]),
                vec_off=_i32(plan.lump_vec_offset[g]),
                below_idx=bidx)
            lb.members = g
            out.append(lb)
        return out

    def _build_pairs(self, lds, origin_pos) -> PairBucket:
        """Run-coalesced lower block pairs of all level columns.

        Below-diagonal spans of each origin column are grouped into
        maximal runs of consecutive span ids; column-side runs are split
        at target-lump boundaries, row-side runs additionally at the
        target's diag/below panel boundary (the padded layout has a gap
        there). Every (row_run >= col_run) pair is one rectangle — the
        run-diagonal rectangle includes upper span pairs, which is safe:
        they land in the never-read upper half of the target's diagonal
        block (the reference likewise subtracts whole square blocks on
        diagonal pairs, MatOpsRef.cpp:163-171). Vectorized with a global
        sorted (lump, span) chain-key lookup."""
        sk = self.plan.skel
        span_size = sk.span_start[1:] - sk.span_start[:-1]
        col_stride = sk.col_stride
        ck = self._chain_keys
        S = sk.num_spans

        parts = []  # per column: (src, sstride, rs, cs, c0, trs) arrays
        for o in np.asarray(lds, dtype=np.int64):
            o = int(o)
            if o not in origin_pos:
                continue
            base, rp = origin_pos[o]
            cs_, ce_ = int(sk.chain_col_ptr[o]), int(sk.chain_col_ptr[o + 1])
            nd = int(sk.lump_to_span[o + 1] - sk.lump_to_span[o])
            spans = sk.chain_row_span[cs_ + nd:ce_]
            nb = len(spans)
            if nb == 0:
                continue
            sizes = span_size[spans]
            row_offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            tlump = sk.span_to_lump[spans]
            # column runs: consecutive spans, same target lump
            brk_col = np.nonzero((spans[1:] != spans[:-1] + 1) |
                                 (tlump[1:] != tlump[:-1]))[0] + 1
            cbounds = np.concatenate([[0], brk_col, [nb]])
            # row runs: consecutive spans, split at each target's
            # diag/below boundary — computed per column run below
            brk_row = np.nonzero(spans[1:] != spans[:-1] + 1)[0] + 1
            rbounds_all = np.concatenate([[0], brk_row, [nb]])

            for cb in range(len(cbounds) - 1):
                j0, j1 = int(cbounds[cb]), int(cbounds[cb + 1])
                t = int(tlump[j0])
                stride = int(col_stride[t])
                t_end_span = int(sk.lump_to_span[t + 1])
                c0 = int(sk.span_offset_in_lump[spans[j0]])
                ccols = int(row_offs[j1 - 1] + sizes[j1 - 1] - row_offs[j0])
                # row runs start at this column run (i >= j ordering)
                ri = j0
                while ri < nb:
                    # find end of this row run
                    nxt = rbounds_all[np.searchsorted(rbounds_all, ri,
                                                      side="right")]
                    re = int(nxt)
                    # split at the target's diag/below boundary
                    if spans[ri] < t_end_span:
                        # run starts inside target lump's own spans
                        inside = np.searchsorted(spans[ri:re], t_end_span)
                        re_eff = ri + int(inside)
                    else:
                        re_eff = re
                    if re_eff == ri:
                        re_eff = re  # entire run below the boundary
                    seg_end = re_eff
                    # locate first span's chain in target column
                    s0 = int(spans[ri])
                    pos = int(np.searchsorted(ck, t * S + s0))
                    assert sk.chain_row_span[pos] == s0, \
                        "missing fill chain in target column"
                    rrows = int(row_offs[seg_end - 1] + sizes[seg_end - 1] -
                                row_offs[ri])
                    parts.append((
                        base + int(row_offs[ri]) * rp + int(row_offs[j0]),
                        rp, rrows, ccols, c0,
                        int(sk.chain_data[pos]),
                        stride))
                    ri = seg_end
        arr = np.array(parts, dtype=np.int64).reshape(-1, 7).T
        src, sstride, rs, cls, c0, trs, stride = arr
        return PairBucket(src_base=src, src_stride=sstride, rs=rs, cs=cls,
                          c0=c0, tgt_row_start=trs, tgt_stride=stride)

    def _solve_schedule(self, start: int, end: int) -> List[List[LumpBucket]]:
        key = (start, end)
        sched = self._solve_cache.get(key)
        if sched is None:
            # the factor schedule's lump buckets are built with the same
            # (with_below_idx=True) layout — reuse them
            fs = self._sched_cache.get(key)
            if fs is not None:
                sched = [lev[0] for lev in fs]
            else:
                with trace.span("programs.schedule"):
                    sched = [self._bucket_lumps(lds, with_below_idx=True)
                             for lds in self._by_level(start, end)]
            self._solve_cache[key] = sched
        return sched


@dataclass
class SegmentCSR:
    """Target-sorted contributions of one level's assembly:
    out[tgt[t]] -= sum(src[src_idx[seg_ptr[t]:seg_ptr[t + 1]]]).
    Within a segment, contributions keep their origin order, so the sum
    is taken in one fixed order (bitwise deterministic)."""
    tgt: np.ndarray      # (T,) int64 target positions, ascending
    seg_ptr: np.ndarray  # (T + 1,) int64 segment extents into src_idx
    src_idx: np.ndarray  # (N,) int64 source positions


def _csr(tgt: np.ndarray, src: np.ndarray, origin: np.ndarray) -> SegmentCSR:
    order = np.lexsort((origin, tgt))
    tgt, src = tgt[order], src[order]
    starts = np.concatenate([[True], tgt[1:] != tgt[:-1]]) \
        if len(tgt) else np.zeros(0, dtype=bool)
    pos = np.nonzero(starts)[0]
    seg_ptr = np.concatenate([pos, [len(tgt)]]).astype(np.int64)
    return SegmentCSR(tgt=tgt[pos].astype(np.int64), seg_ptr=seg_ptr,
                      src_idx=src.astype(np.int64))


def pair_csr(pb: PairBucket) -> SegmentCSR:
    """CSR over data elements of one factor level's block pairs: every
    (r < rs, c < cs) element of every pair rectangle contributes
    prod[src_base + r * src_stride + c] to
    data[tgt_row_start + c0 + r * tgt_stride + c]."""
    with trace.span("programs.schedule"):
        n_el = pb.rs * pb.cs
        p = np.repeat(np.arange(len(n_el)), n_el)
        k = np.arange(int(n_el.sum()), dtype=np.int64) - \
            np.repeat(np.cumsum(n_el) - n_el, n_el)
        r, c = k // pb.cs[p], k % pb.cs[p]
        # the targets of one rectangle are distinct: origin order is the
        # order of the pairs' enumeration
        return _csr(pb.tgt_row_start[p] + pb.c0[p] +
                    r * pb.tgt_stride[p] + c,
                    pb.src_base[p] + r * pb.src_stride[p] + c, p)


def solve_csr(buckets: List[LumpBucket], row_base: List[int],
              order: int) -> SegmentCSR:
    """CSR over RHS rows of one solve level's below updates: row r of
    panel b of bucket i contributes y[row_base[i] + b * rp + r] to RHS
    row below_idx[b, r]. Sentinel rows (== order) are skipped."""
    with trace.span("programs.schedule"):
        tgts, srcs, origins = [], [], []
        for lb, base in zip(buckets, row_base):
            if lb.rp == 0:
                continue
            bidx = lb.below_idx.astype(np.int64)
            B, rp = bidx.shape
            src = base + np.arange(B * rp, dtype=np.int64).reshape(B, rp)
            keep = bidx != order
            tgts.append(bidx[keep])
            srcs.append(src[keep])
            members = np.asarray(lb.members, dtype=np.int64)
            origins.append(np.broadcast_to(members[:, None], (B, rp))[keep])
        if not tgts:
            z = np.zeros(0, np.int64)
            return SegmentCSR(z, np.zeros(1, np.int64), z)
        return _csr(np.concatenate(tgts), np.concatenate(srcs),
                    np.concatenate(origins))


# ----------------------------------------------------------------------
# the schedule sharded over the ranks of a process group
# ----------------------------------------------------------------------
SHARD_MIN_B = 2  # buckets of fewer than n * SHARD_MIN_B panels run
#                  replicated on every rank


def share_bounds(B: int, n: int) -> Optional[np.ndarray]:
    """Panel bounds of the n contiguous shares of a bucket of B panels
    (sizes differ by one at most), or None when the bucket runs
    replicated."""
    if B < n * SHARD_MIN_B:
        return None
    return np.arange(n + 1, dtype=np.int64) * B // n


def bucket_share(lb: LumpBucket, lo: int, hi: int) -> LumpBucket:
    """Panels [lo, hi) of the bucket as a bucket of their own, its
    products at their place in the level's product buffer."""
    share = LumpBucket(
        rp=lb.rp, cp=lb.cp, off=lb.off[lo:hi], rows=lb.rows[lo:hi],
        cols=lb.cols[lo:hi], vec_off=lb.vec_off[lo:hi],
        below_idx=None if lb.below_idx is None else lb.below_idx[lo:hi],
        prod_base=lb.prod_base + lo * lb.rp * lb.rp)
    share.members = lb.members[lo:hi]
    return share


def _panel_elements(lbs) -> np.ndarray:
    """Data positions of the panels of the buckets, panel by panel."""
    parts = [_expand(lb.off.astype(np.int64),
                     np.full(len(lb.off), (lb.cp + lb.rp) * lb.cp, np.int64))
             for lb in lbs]
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _product_elements(lbs) -> np.ndarray:
    """Product-buffer positions of the buckets' panels' products."""
    parts = [lb.prod_base + np.arange(len(lb.off) * lb.rp * lb.rp,
                                      dtype=np.int64)
             for lb in lbs if lb.rp]
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _rhs_rows(lbs, order: int, below: bool) -> np.ndarray:
    """RHS rows the buckets' solves change: each panel's own rows and,
    with `below`, its below rows (sentinels dropped), sorted."""
    parts = [_expand(lb.vec_off.astype(np.int64), lb.cols.astype(np.int64))
             for lb in lbs]
    if below:
        parts += [lb.below_idx[lb.below_idx != order].astype(np.int64)
                  for lb in lbs if lb.rp]
    return np.unique(np.concatenate(parts)) if parts else \
        np.zeros(0, np.int64)


def dense_targets(du: DenseUpdate) -> np.ndarray:
    """Data positions of every element of a dense level's target slices
    (rows of span a by the columns of span b), sorted."""
    n_sl = np.diff(du.slice_ptr)
    s_of = np.repeat(np.arange(len(du.tspans)), n_sl)
    cols, ld = du.sp_size[s_of], du.sp_ld[s_of]
    ne = du.sl_size * cols
    q = np.repeat(np.arange(len(ne)), ne)
    k = _expand(np.zeros(len(ne), np.int64), ne)
    return np.sort(du.sl_off[q] + k // cols[q] * ld[q] + k % cols[q])


@dataclass
class FactorShare:
    """One rank's part of a factor level sharded over n ranks.

    The rank factors `buckets`: its share of every bucket split across
    the ranks (share_bounds) and every replicated bucket whole. When a
    bucket is split, one all-gather carries each rank's pack, padded to
    `pack_len`: its shares' factored panel elements (data positions
    `pack_data`) and, on a pair level, their products (product
    positions `pack_prod`); every rank then writes element
    `unpack_*_src` of the gathered (n * pack_len) buffer to position
    `unpack_*_dst`. pack_len 0: nothing is split, no all-gather.

    A dense level with a split bucket sums its update over the ranks:
    `dense` is this rank's part (the origins of its shares, and of the
    replicated buckets on rank 0 only; None without origins), `targets`
    the level's target elements, the same on every rank. Otherwise
    `dense` is the level's whole update and `targets` None."""
    buckets: List[LumpBucket]
    pack_len: int
    pack_data: np.ndarray
    pack_prod: np.ndarray
    unpack_data_src: np.ndarray
    unpack_data_dst: np.ndarray
    unpack_prod_src: np.ndarray
    unpack_prod_dst: np.ndarray
    dense: Optional[DenseUpdate]
    targets: Optional[np.ndarray]


@dataclass
class SolveShare:
    """One rank's part of a solve level sharded over n ranks: the buckets
    it solves (its shares of the split buckets; the replicated ones on
    rank 0 only when a bucket is split, else all of them on every rank)
    and the RHS rows the level's L and Lt passes change (None when
    nothing is split: the level runs replicated, with no all-reduce)."""
    buckets: List[LumpBucket]
    rows_l: Optional[np.ndarray]
    rows_lt: Optional[np.ndarray]


def _split_level(lump_buckets, n: int, r: int):
    """One level split over n ranks: (the buckets rank r factors or
    solves: its shares of the split buckets and the replicated buckets,
    in level order; the update's origins on rank r: its shares, and the
    replicated buckets on rank 0 only; every rank's shares of the split
    buckets). No share lists: nothing is split."""
    mine, origins, shares = [], [], [[] for _ in range(n)]
    for lb in lump_buckets:
        bounds = share_bounds(len(lb.off), n)
        if bounds is None:
            mine.append(lb)
            if r == 0:
                origins.append(lb)
            continue
        for q in range(n):
            shares[q].append(bucket_share(lb, int(bounds[q]),
                                          int(bounds[q + 1])))
        mine.append(shares[r][-1])
        origins.append(shares[r][-1])
    return mine, origins, shares if shares[0] else None


def factor_share(sched: PlannedSchedule, level, n: int,
                 r: int) -> FactorShare:
    """Rank r's part of a factor level of `sched` split over n ranks."""
    lump_buckets, _, _, dense = level
    mine, origins, shares = _split_level(lump_buckets, n, r)
    z = np.zeros(0, np.int64)
    if shares is None:
        return FactorShare(mine, 0, z, z, z, z, z, z, dense, None)
    pair = dense is None
    data_el = [_panel_elements(s) for s in shares]
    prod_el = [_product_elements(s) if pair else z for s in shares]
    M = max(len(a) + len(b) for a, b in zip(data_el, prod_el))
    src_d, src_p = [], []
    for q, (a, b) in enumerate(zip(data_el, prod_el)):
        src_d.append(q * M + np.arange(len(a), dtype=np.int64))
        src_p.append(q * M + len(a) + np.arange(len(b), dtype=np.int64))
    my_dense = targets = None
    if not pair:
        my_dense = sched._dense_update(origins, force=True)
        targets = dense_targets(dense)
    return FactorShare(
        mine, M, data_el[r], prod_el[r], np.concatenate(src_d),
        np.concatenate(data_el), np.concatenate(src_p),
        np.concatenate(prod_el), my_dense, targets)


def solve_share(sched: PlannedSchedule, buckets, n: int,
                r: int) -> SolveShare:
    """Rank r's part of a solve level of `sched` split over n ranks."""
    mine, origins, shares = _split_level(buckets, n, r)
    if shares is None:
        return SolveShare(mine, None, None)
    order = sched.plan.skel.order
    return SolveShare(origins, _rhs_rows(buckets, order, True),
                      _rhs_rows(buckets, order, False))
