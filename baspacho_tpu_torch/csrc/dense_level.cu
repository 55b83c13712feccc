// K4 dense_update: the update of a dense (Schur) level.
//
// Replaces PlannedBackend._run_dense_level
// (baspacho_tpu/ops/planned_backend.py:1644) with the accumulation
// helpers it drives (_scatter_w_bucket :1710, _accum_oh_bucket :1724,
// _accum_sg_bucket :1770) and the slice subtraction _apply_dense_slices
// (:1612). It computes the same buffer: every target element loses
// sum_o x_o[row] . x_o[col] over the level's origins o, where x_o is the
// origin's solved below block (left in the data by the bucket factor).
// It does not carry over the JAX package's mechanisms (a dense compact U
// built by one-hot GEMMs or W W^T), and it needs no product buffer.
//
// Narrow origins (panels of at most 512 columns): a destination-sorted
// segmented reduction, as K6 (grad_hess.cu). The host (ops/schedule.py
// DenseUpdate) makes one record for each target span-block (a, b),
// a >= b, and each narrow origin o whose below rows hold both spans,
// sorted by destination with origin order kept inside one (spans wider
// than 32 rows are cut into pieces of 32, each piece pair a destination):
//
//   rec[p] = (xb, dr << 32 | ld << 16 | n): x_o[b] starts at data offset
//            xb, x_o[a] dr rows further (dr < 0 where a piece of a
//            diagonal block lies above its column piece), both with row
//            stride ld (the origin's padded width), n columns (origins
//            wider than 32 columns are cut into k-slices, consecutive
//            records)
//
//   D[off + r * ld_t + c] -= sum_records sum_k x_o[a][r][k] x_o[b][c][k]
//
// for the destination's |a| x |b| elements at off with row stride ld_t.
// dense_warp_kernel: a warp per short destination (at most 32 records),
// lanes over its elements, G = 32 / elements lane groups summing
// interleaved records, combined by shuffles in group order.
// Long destinations (more than 32 records; BAL 871's camera blocks:
// hundreds to ~3,000 points each) take one of two grids. f64:
// dense_mma_kernel sums them on the tensor cores, a CTA of 8 warps per
// work item of the host's (ops/schedule.py: a destination's 16 x 16
// tile and a chunk of at most 256 of its records). A warp takes every
// 8th record of the chunk; a lane reads one record's header and passes
// it round by shuffles; each record's rows are loaded straight from the
// panel as mma.m8n8k4 fragments (lane (g, t) holds row g, column t),
// zero past its columns and the tile's rows, so padding never enters a
// product. Where a warp's records are at most four columns wide with
// even strides (BAL, Schur sets) a lane loads two columns of one of two
// records at once, and two steps of four columns take both records:
// per BAL record 2 vector loads a pair, 4 mma, ~34 instructions. The
// warps combine in warp order; a tile cut into chunks writes each
// chunk's sum to a scratch slot and dense_post_kernel adds them in chunk
// order. f32 (no tensor cores): dense_block_kernel, a CTA per long
// destination; chunks of records' x rows are staged in shared memory by
// cp.async, double-buffered so that one chunk's loads overlap the
// previous chunk's products; G = 256 / elements thread groups sum
// interleaved records, combined in group order. Every element is owned
// by one thread, with no atomics: reruns agree bitwise, and targets are
// disjoint across destinations.
//
// Wide origins (a blocked wide panel: few origins of hundreds to
// thousands of columns) would have every destination re-read their rows
// from memory, 45 GB on BAL 871's cp-3072 level. dense_wide_kernel forms
// such an origin's x x^T in 64 x 64 tiles of its below rows instead, one
// CTA per tile (every tile with a row chain at or past its column chain),
// from 32-column stages of both row blocks loaded by cp.async and double
// buffered; four warps each hold a 32 x 32 block in registers, summed by
// the f64 tensor cores (mma.m8n8k4, fixed order) or, in f32, by FMAs in
// the same order of columns (gram_tile, warp_tiles.cuh, which K1's
// product shares). Each element (i, j) whose row chain a is at
// or past its column chain b is subtracted straight into its target:
// pt[a (a + 1) / 2 + b] + rin[i] * cld[b] + rin[j]. One launch per wide
// origin, before the narrow records: targets are disjoint inside a launch.
//
// Bound on BAL 871's point level (f64): x read once, 0.57 GB, ~0.17 ms
// at 3.35 TB/s; ~1.9 G multiply-adds, ~0.06 ms at 67 TFLOP/s; the 7.9 M
// records add 0.13 GB. Each x block is read by ~15 records (5 camera
// spans per point): the long records read 4.5 GB of 32-byte sectors,
// mostly from L2. On an H100 the staged f64 grid took 2.90 ms for the
// long destinations there, bound by issuing its per-value staging (60 %
// of a CTA's cycles, tools/dense_block_probe.py); the tensor cores' grid
// takes 0.84 ms, and 0.71 ms with every read an L1 hit: it is bound by
// instruction issue (address arithmetic, shuffles, 4 mma a record, 3 of
// them for the 9th row and column), not by bytes (PERF.md §6). The
// earlier one-CTA-per-span design took 128 ms there, one barrier per
// origin.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

constexpr int kWarpThreads = 256;   // 8 warps, one short destination each
constexpr int kBlockThreads = 256;  // one long destination (f32)
constexpr int kStageBytes = 32 * 1024;  // each of the two stage buffers
constexpr int kMmaWarps = 8;    // one f64 work item, a record stream a
//                                 warp
constexpr int kMmaChunk = 256;  // records of one work item at most, 32 a
//                                 warp (ops/schedule.py DENSE_CHUNK)
constexpr int kMmaBatch = 2;    // records loaded together (mma_records)
static_assert(kMmaChunk == 32 * kMmaWarps, "a lane reads one header");

struct Rec {
  int64_t xa, xb;
  int ld, n;
};

__device__ __forceinline__ Rec rec_at(const int64_t* rec, int64_t p) {
  const int64_t xb = rec[2 * p], m = rec[2 * p + 1];
  const int ld = (int)((m >> 16) & 0xffff);
  return Rec{xb + (m >> 32) * ld, xb, ld, (int)(m & 0xffff)};
}

template <typename T>
__global__ void dense_warp_kernel(T* data, int64_t bstride,
                                  const int64_t* __restrict__ list,
                                  int64_t n_list,
                                  const int64_t* __restrict__ rec,
                                  const int64_t* __restrict__ dst_off,
                                  const int64_t* __restrict__ dst_ld,
                                  const int64_t* __restrict__ dst_rows,
                                  const int64_t* __restrict__ dst_cols,
                                  const int64_t* __restrict__ dst_ptr) {
  const int64_t w =
      (int64_t)blockIdx.x * (kWarpThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= n_list) return;  // uniform over the warp
  T* D = data + (int64_t)blockIdx.y * bstride;
  const int64_t s = list[w];
  const int R = (int)dst_rows[s], C = (int)dst_cols[s], E = R * C;
  const int64_t off = dst_off[s], ldt = dst_ld[s];
  const int64_t p0 = dst_ptr[s], p1 = dst_ptr[s + 1];
  const int ET = E < 32 ? E : 32, G = 32 / ET;
  const int g = lane / ET, el = lane % ET;
  for (int e0 = 0; e0 < E; e0 += ET) {
    const int e = e0 + el;
    const bool live = g < G && e < E;
    T acc = T(0);
    if (live) {
      const int r = e / C, c = e % C;
      for (int64_t p = p0 + g; p < p1; p += G) {
        const Rec x = rec_at(rec, p);
        const T* xa = D + x.xa + (int64_t)r * x.ld;
        const T* xb = D + x.xb + (int64_t)c * x.ld;
        T dot = T(0);
        for (int k = 0; k < x.n; ++k) dot += xa[k] * xb[k];
        acc += dot;
      }
    }
    T tot = acc;
    for (int gg = 1; gg < G; ++gg)
      tot += __shfl_sync(0xffffffffu, acc, gg * ET + el);
    if (g == 0 && e < E) D[off + (e / C) * ldt + e % C] -= tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    dense_block_kernel(T* data, int64_t bstride,
                       const int64_t* __restrict__ list,
                       const int64_t* __restrict__ rec,
                       const int64_t* __restrict__ dst_off,
                       const int64_t* __restrict__ dst_ld,
                       const int64_t* __restrict__ dst_rows,
                       const int64_t* __restrict__ dst_cols,
                       const int64_t* __restrict__ dst_ptr,
                       const int64_t* __restrict__ dst_nk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CH = kStageBytes / sizeof(T);
  T* const buf0 = reinterpret_cast<T*>(smem_raw);  // chunks 0, 2, ...
  T* const buf1 = buf0 + CH;                        // chunks 1, 3, ...
  T* const part = buf1 + CH;  // kBlockThreads group sums
  const int tid = threadIdx.x, nt = kBlockThreads;
  T* D = data + (int64_t)blockIdx.y * bstride;
  const int64_t s = list[blockIdx.x];
  const int R = (int)dst_rows[s], C = (int)dst_cols[s], E = R * C;
  const int nk = (int)dst_nk[s];
  const int64_t off = dst_off[s], ldt = dst_ld[s];
  const int64_t p0 = dst_ptr[s], p1 = dst_ptr[s + 1];
  // a record's staged values: x_o[a] (R rows), then x_o[b] (C rows), nk
  // columns each (zero past the record's n)
  const int per = (R + C) * nk, cap = CH / per;
  const int nchunk = (int)((p1 - p0 + cap - 1) / cap);
  const int ET = E < nt ? E : nt, G = nt / ET;

  auto stage = [&](int ci) {
    T* b = (ci & 1) ? buf1 : buf0;
    const int64_t c0 = p0 + (int64_t)ci * cap;
    const int n = (int)(p1 - c0 < cap ? p1 - c0 : cap);
    for (int i = tid; i < n * per; i += nt) {
      const int j = i / per, rem = i - j * per;
      const int row = rem / nk, k = rem - row * nk;
      const Rec x = rec_at(rec, c0 + j);
      if (k < x.n)
        cp_async_el(b + i, D + (row < R ? x.xa + (int64_t)row * x.ld
                                        : x.xb + (int64_t)(row - R) * x.ld) +
                               k);
      else
        b[i] = T(0);
    }
    cp_async_commit();
  };

  for (int e0 = 0; e0 < E; e0 += ET) {
    const int g = tid / ET, e = e0 + tid % ET;
    const bool live = g < G && e < E;
    const int r = live ? e / C : 0, c = live ? e % C : 0;
    T acc = T(0);
    stage(0);
    for (int ci = 0; ci < nchunk; ++ci) {
      if (ci + 1 < nchunk) {
        stage(ci + 1);  // its buffer was last read in chunk ci - 1
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* b = (ci & 1) ? buf1 : buf0;
      const int64_t c0 = p0 + (int64_t)ci * cap;
      const int n = (int)(p1 - c0 < cap ? p1 - c0 : cap);
      if (live) {
        for (int j = g; j < n; j += G) {
          const T* xa = b + j * per + r * nk;
          const T* xb = b + j * per + (R + c) * nk;
          T dot = T(0);
          for (int k = 0; k < nk; ++k) dot += xa[k] * xb[k];
          acc += dot;
        }
      }
      __syncthreads();  // chunk ci's buffer may be refilled
    }
    part[tid] = acc;
    __syncthreads();
    if (tid < ET && e0 + tid < E) {
      T tot = T(0);
      for (int gg = 0; gg < G; ++gg) tot += part[gg * ET + tid];
      const int ee = e0 + tid;
      D[off + (ee / C) * ldt + ee % C] -= tot;
    }
    __syncthreads();
  }
}

// acc += a b^T on the f64 tensor cores: an 8 x 8 block of a warp, a and b
// the fragments of four columns (a: row lane / 4, column lane % 4; b: the
// same of the other operand's rows), acc[h] the element (lane / 4,
// (lane % 4) * 2 + h).
__device__ __forceinline__ void mma884(double (&acc)[2], double a,
                                       double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(acc[0]), "+d"(acc[1])
      : "d"(a), "d"(b));
}

// *p where `on`, else 0 (x is not written during the launch).
__device__ __forceinline__ double ld_on(const double* p, bool on) {
  return on ? __ldg(p) : 0.0;
}

// One warp's records of a work item, kMmaBatch at a time, into acc (a
// 16 x 16 tile of blocks acc[i][j], MB x NC of them holding elements):
// lane j holds the decoded header of the warp's j-th record (ha, hb: the
// element offsets of the tile's first rows of x_o[a] and x_o[b]; hn = ld
// | n << 16, n = 0 past the item), passed round by shuffles; lane (g, t)
// = (lane / 4, lane % 4) loads row 8 i + g, column k0 + t of each 8-row
// block i straight from the data, zero past the record's columns and the
// tile's rows (ra[i], rb[i]), so padding columns are never read; then
// one mma.m8n8k4 per block, four columns a step, records in order.
template <int MB, int NC>
__device__ __forceinline__ void mma_records(double (&acc)[2][2][2],
                                            const double* D, int64_t ha,
                                            int64_t hb, int hn, int cnt,
                                            int g, int t, const bool (&ra)[2],
                                            const bool (&rb)[2]) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kB = kMmaBatch;
  for (int j = 0; j < cnt; j += kB) {
    int64_t xa[kB], xb[kB];
    int ld[kB], n[kB], nmax = 0;
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      xa[u] = __shfl_sync(kAll, ha, j + u);
      xb[u] = __shfl_sync(kAll, hb, j + u);
      const int ln = __shfl_sync(kAll, hn, j + u);
      ld[u] = ln & 0xffff;
      n[u] = ln >> 16;
      nmax = max(nmax, n[u]);
    }
    for (int k0 = 0; k0 < nmax; k0 += 4) {
      double a[kB][2], b[kB][2];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const bool on = k0 + t < n[u];
        const double* pa = D + xa[u] + (g * ld[u] + k0 + t);
        const double* pb = D + xb[u] + (g * ld[u] + k0 + t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[u][i] = i < MB ? ld_on(pa + i * 8 * ld[u], on && ra[i]) : 0.0;
          b[u][i] = i < NC ? ld_on(pb + i * 8 * ld[u], on && rb[i]) : 0.0;
        }
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (k0 >= n[u]) continue;  // uniform over the warp
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int jj = 0; jj < NC; ++jj)
            mma884(acc[i][jj], a[u][i], b[u][jj]);
      }
    }
  }
}

// mma_records for a warp whose records are all at most four columns
// wide, with even row strides and 16-byte aligned rows: two records a
// step. Lane (g, t) loads two columns at once, columns c, c + 1 (c = 2
// (t % 2)) of row 8 i + g of record j + t / 2, and the step's four
// columns are those of both records: the first component of each lane
// gives one mma.m8n8k4 per block (columns 0 and 2 of both), the second
// another (columns 1 and 3). Zero past the record's columns and the
// tile's rows, so padding columns never enter a product.
template <int MB, int NC>
__device__ __forceinline__ void mma_pairs(double (&acc)[2][2][2],
                                          const double* D, int64_t ha,
                                          int64_t hb, int hn, int cnt, int g,
                                          int t, const bool (&ra)[2],
                                          const bool (&rb)[2]) {
  constexpr unsigned kAll = 0xffffffffu;
  const int h = t >> 1, c = 2 * (t & 1);
  for (int j = 0; j < cnt; j += 2) {
    const int64_t xa = __shfl_sync(kAll, ha, j + h);
    const int64_t xb = __shfl_sync(kAll, hb, j + h);
    const int ln = __shfl_sync(kAll, hn, j + h);
    const int ld = ln & 0xffff, n = ln >> 16;
    const bool on = c < n, hi = c + 1 < n;
    const double2* pa =
        reinterpret_cast<const double2*>(D + xa + (g * ld + c));
    const double2* pb =
        reinterpret_cast<const double2*>(D + xb + (g * ld + c));
    double2 a[2], b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i] = i < MB && on && ra[i] ? __ldg(pa + i * 4 * ld)
                                   : make_double2(0.0, 0.0);
      b[i] = i < NC && on && rb[i] ? __ldg(pb + i * 4 * ld)
                                   : make_double2(0.0, 0.0);
      if (!hi) a[i].y = b[i].y = 0.0;
    }
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) mma884(acc[i][jj], a[i].x, b[jj].x);
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) mma884(acc[i][jj], a[i].y, b[jj].y);
  }
}

// The f64 long destinations on the tensor cores. A CTA per work item:
// item[4 k .. 4 k + 3] = (first record, end record, s << 2 | tile, slot)
// sums records [first, end) of destination s (at most kMmaChunk) over
// its 16 x 16 tile (row half tile >> 1, column half tile & 1). Warp w
// of the kMmaWarps takes the records first + w, first + w + kMmaWarps,
// ... in that order, two a step (mma_pairs) where all of them are at
// most four columns wide with even strides and offsets, else one
// (mma_records). The warps' sums are combined in warp order and
// subtracted from the destination (slot < 0) or written to slot `slot`
// of the scratch (256 values a slot, n_slot slots a batch item) for
// dense_post_kernel.
__global__ void __launch_bounds__(kMmaWarps * 32, 4)
    dense_mma_kernel(double* data, int64_t bstride,
                     const int64_t* __restrict__ item, double* scratch,
                     int64_t n_slot, const int64_t* __restrict__ rec,
                     const int64_t* __restrict__ dst_off,
                     const int64_t* __restrict__ dst_ld,
                     const int64_t* __restrict__ dst_rows,
                     const int64_t* __restrict__ dst_cols) {
  __shared__ double part[kMmaWarps][256];  // each warp's 16 x 16 sums
  constexpr int W = kMmaWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  double* D = data + (int64_t)blockIdx.y * bstride;
  const int64_t* it = item + 4 * (int64_t)blockIdx.x;
  const int64_t p0 = it[0], p1 = it[1], s = it[2] >> 2, slot = it[3];
  const int r0 = (int)(it[2] >> 1 & 1) * 16, c0 = (int)(it[2] & 1) * 16;
  const int R = min(16, (int)dst_rows[s] - r0);
  const int C = min(16, (int)dst_cols[s] - c0);
  const bool ra[2] = {g < R, g + 8 < R}, rb[2] = {g < C, g + 8 < C};
  double acc[2][2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  const int64_t q = p0 + warp + (int64_t)lane * W;  // this lane's header
  int64_t ha = 0, hb = 0;
  int hn = 0;  // past p1: no columns, nothing read
  if (q < p1) {
    const int64_t xb = rec[2 * q], m = rec[2 * q + 1];
    const int ld = (int)((m >> 16) & 0xffff);
    ha = xb + ((m >> 32) + r0) * ld;
    hb = xb + (int64_t)c0 * ld;
    hn = ld | (int)(m & 0xffff) << 16;
  }
  const int cnt = (int)((p1 - p0 - warp + W - 1) / W);  // <= 32
  // two records a step where every record of the warp allows it (the
  // data's base and batch stride too, so that a batch's items and single
  // runs take the same path)
  const bool pairs =
      __all_sync(0xffffffffu,
                 q >= p1 || ((hn >> 16) <= 4 && ((ha | hb | hn) & 1) == 0)) &&
      (reinterpret_cast<uintptr_t>(data) & 15) == 0 && (bstride & 1) == 0;
  switch ((R > 8) * 4 + (C > 8) * 2 + pairs) {  // uniform over the warp
    case 0:
      mma_records<1, 1>(acc, D, ha, hb, hn, cnt, g, t, ra, rb);
      break;
    case 1:
      mma_pairs<1, 1>(acc, D, ha, hb, hn, cnt, g, t, ra, rb);
      break;
    case 2:
      mma_records<1, 2>(acc, D, ha, hb, hn, cnt, g, t, ra, rb);
      break;
    case 3:
      mma_pairs<1, 2>(acc, D, ha, hb, hn, cnt, g, t, ra, rb);
      break;
    case 4:
      mma_records<2, 1>(acc, D, ha, hb, hn, cnt, g, t, ra, rb);
      break;
    case 5:
      mma_pairs<2, 1>(acc, D, ha, hb, hn, cnt, g, t, ra, rb);
      break;
    case 6:
      mma_records<2, 2>(acc, D, ha, hb, hn, cnt, g, t, ra, rb);
      break;
    default:
      mma_pairs<2, 2>(acc, D, ha, hb, hn, cnt, g, t, ra, rb);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        part[warp][(8 * i + g) * 16 + 8 * jj + 2 * t + h] = acc[i][jj][h];
  __syncthreads();
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  if (r < R && c < C) {
    double tot = part[0][threadIdx.x];
    for (int w = 1; w < W; ++w) tot += part[w][threadIdx.x];
    if (slot < 0)
      D[dst_off[s] + (int64_t)(r0 + r) * dst_ld[s] + c0 + c] -= tot;
    else
      scratch[((int64_t)blockIdx.y * n_slot + slot) * 256 + threadIdx.x] =
          tot;
  }
}

// The destinations' tiles that dense_mma_kernel summed in chunks: a CTA
// per post[3 k .. 3 k + 2] = (s << 2 | tile, first slot, slots) sums the
// chunks' slots in order and subtracts the sum from the tile.
__global__ void __launch_bounds__(256)
    dense_post_kernel(double* data, int64_t bstride,
                      const int64_t* __restrict__ post,
                      const double* __restrict__ scratch, int64_t n_slot,
                      const int64_t* __restrict__ dst_off,
                      const int64_t* __restrict__ dst_ld,
                      const int64_t* __restrict__ dst_rows,
                      const int64_t* __restrict__ dst_cols) {
  double* D = data + (int64_t)blockIdx.y * bstride;
  const int64_t* pt = post + 3 * (int64_t)blockIdx.x;
  const int64_t s = pt[0] >> 2, first = pt[1], n = pt[2];
  const int r0 = (int)(pt[0] >> 1 & 1) * 16, c0 = (int)(pt[0] & 1) * 16;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  if (r >= (int)dst_rows[s] - r0 || c >= (int)dst_cols[s] - c0) return;
  const double* sl =
      scratch + ((int64_t)blockIdx.y * n_slot + first) * 256 + threadIdx.x;
  double tot = sl[0];
  for (int64_t k = 1; k < n; ++k) tot += sl[256 * k];
  D[dst_off[s] + (int64_t)(r0 + r) * dst_ld[s] + c0 + c] -= tot;
}

// A wide origin's update: x (rows x n, row stride ld) at data offset
// xoff; tile[t] = I << 32 | J names a 64 x 64 tile of x x^T; rch / rin:
// each below row's chain (0-based in the origin) and row inside its span;
// pt: each chain pair's target (a >= b, at a (a + 1) / 2 + b); cld: each
// chain's target row stride.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    dense_wide_kernel(T* data, int64_t bstride, int64_t xoff, int64_t ld,
                      int n, int64_t rows, const int64_t* __restrict__ tile,
                      const int64_t* __restrict__ rch,
                      const int64_t* __restrict__ rin,
                      const int64_t* __restrict__ pt,
                      const int64_t* __restrict__ cld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);  // 2 x (128 rows x kTld)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  T* D = data + (int64_t)blockIdx.y * bstride;
  const int64_t tl = tile[blockIdx.x];
  const int64_t r0 = (tl >> 32) * kTile, c0 = (tl & 0xffffffff) * kTile;
  T acc[4][4][2];
  gram_tile(acc, D + xoff, ld, n, rows, r0, c0, sm);

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int64_t i = r0 + wm * 32 + mi * 8 + (lane >> 2);
    if (i >= rows) continue;
    const int64_t a = rch[i], ra = rin[i];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t j = c0 + wn * 32 + nj * 8 + (lane & 3) * 2 + h;
        if (j >= rows) continue;
        const int64_t b = rch[j];
        if (b > a) continue;
        D[pt[a * (a + 1) / 2 + b] + ra * cld[b] + rin[j]] -= acc[mi][nj][h];
      }
  }
}

template <typename T>
int launch(void* data, int64_t bstride, const int64_t* list, int64_t n_list,
           int long_mode, const int64_t* rec, const int64_t* dst_off,
           const int64_t* dst_ld, const int64_t* dst_rows,
           const int64_t* dst_cols, const int64_t* dst_ptr,
           const int64_t* dst_nk, int batch, cudaStream_t stream) {
  if (n_list <= 0) return 0;
  if (long_mode == 0) {
    const int64_t per_block = kWarpThreads / 32;
    dense_warp_kernel<T><<<dim3((unsigned)((n_list + per_block - 1) /
                                           per_block),
                                batch),
                           kWarpThreads, 0, stream>>>(
        static_cast<T*>(data), bstride, list, n_list, rec, dst_off, dst_ld,
        dst_rows, dst_cols, dst_ptr);
    return (int)cudaGetLastError();
  }
  if constexpr (sizeof(T) == 4) {  // f64 takes bs_dense_mma
    if (long_mode == 1) {
      const size_t smem = 2 * kStageBytes + kBlockThreads * sizeof(T);
      cudaError_t e = cudaFuncSetAttribute(
          dense_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
      dense_block_kernel<T><<<dim3((unsigned)n_list, batch), kBlockThreads,
                              smem, stream>>>(
          static_cast<T*>(data), bstride, list, rec, dst_off, dst_ld,
          dst_rows, dst_cols, dst_ptr, dst_nk);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_wide(void* data, int64_t bstride, int64_t xoff, int64_t ld, int n,
                int64_t rows, const int64_t* tile, int64_t n_tile,
                const int64_t* rch, const int64_t* rin, const int64_t* pt,
                const int64_t* cld, int batch, cudaStream_t stream) {
  if (n_tile <= 0) return 0;
  const size_t smem = 2 * 2 * kTile * kTld * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      dense_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dense_wide_kernel<T><<<dim3((unsigned)n_tile, batch), kTileThreads, smem,
                         stream>>>(static_cast<T*>(data), bstride, xoff, ld,
                                   n, rows, tile, rch, rin, pt, cld);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. long_mode 0: a warp per destination of
// `list`; 1 (float32 only): a CTA per destination, staged, whose staged
// record, (rows + cols) x nk values, must fit in 32 KB (the host's
// 32-row pieces and 32-column slices see to it). Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for float64 in mode 1).
extern "C" int bs_dense_update(int dtype, void* data, int64_t bstride,
                               const int64_t* list, int64_t n_list,
                               int long_mode, const int64_t* rec,
                               const int64_t* dst_off, const int64_t* dst_ld,
                               const int64_t* dst_rows,
                               const int64_t* dst_cols,
                               const int64_t* dst_ptr, const int64_t* dst_nk,
                               int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(data, bstride, list, n_list, long_mode, rec,
                         dst_off, dst_ld, dst_rows, dst_cols, dst_ptr, dst_nk,
                         batch, s);
  if (dtype == 1)
    return launch<double>(data, bstride, list, n_list, long_mode, rec,
                          dst_off, dst_ld, dst_rows, dst_cols, dst_ptr,
                          dst_nk, batch, s);
  return (int)cudaErrorInvalidValue;
}

// The f64 long destinations: dense_mma_kernel over the n_item work items,
// then, if n_post > 0, dense_post_kernel over the chunked tiles, through
// `scratch` (batch x n_slot x 256 doubles). Returns the cudaError_t of
// the launches.
extern "C" int bs_dense_mma(void* data, int64_t bstride, const int64_t* item,
                            int64_t n_item, const int64_t* post,
                            int64_t n_post, void* scratch, int64_t n_slot,
                            const int64_t* rec, const int64_t* dst_off,
                            const int64_t* dst_ld, const int64_t* dst_rows,
                            const int64_t* dst_cols, int batch,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* d = static_cast<double*>(data);
  double* sc = static_cast<double*>(scratch);
  if (n_item > 0)
    dense_mma_kernel<<<dim3((unsigned)n_item, batch), kMmaWarps * 32, 0,
                       st>>>(d, bstride, item, sc, n_slot, rec, dst_off,
                             dst_ld, dst_rows, dst_cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_post <= 0) return (int)e;
  dense_post_kernel<<<dim3((unsigned)n_post, batch), 256, 0, st>>>(
      d, bstride, post, sc, n_slot, dst_off, dst_ld, dst_rows, dst_cols);
  return (int)cudaGetLastError();
}

// One wide origin's x x^T, subtracted into its targets (dense_wide_kernel
// names the arguments). Returns the cudaError_t of the launch.
extern "C" int bs_dense_wide(int dtype, void* data, int64_t bstride,
                             int64_t xoff, int64_t ld, int n, int64_t rows,
                             const int64_t* tile, int64_t n_tile,
                             const int64_t* rch, const int64_t* rin,
                             const int64_t* pt, const int64_t* cld, int batch,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_wide<float>(data, bstride, xoff, ld, n, rows, tile, n_tile,
                              rch, rin, pt, cld, batch, s);
  if (dtype == 1)
    return launch_wide<double>(data, bstride, xoff, ld, n, rows, tile, n_tile,
                               rch, rin, pt, cld, batch, s);
  return (int)cudaErrorInvalidValue;
}
