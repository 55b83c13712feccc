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
// dense_block_kernel: a CTA per long destination (BAL 871's camera
// blocks: hundreds to ~3,000 points each); chunks of records' x rows are
// staged in shared memory by cp.async, double-buffered so that one
// chunk's loads overlap the previous chunk's products; G = 256 / elements
// thread groups sum interleaved records, combined in group order. Every
// element is owned by one thread, with no atomics and no barrier per
// record: reruns agree bitwise, and targets are disjoint across
// destinations.
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
// spans per point), so the kernel's distance from the bound depends on
// how many of those re-reads hit L2. The earlier one-CTA-per-span design
// took 128 ms there on an H100 (PERF.md), one barrier per origin.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

constexpr int kWarpThreads = 256;   // 8 warps, one short destination each
constexpr int kBlockThreads = 256;  // one long destination
constexpr int kStageBytes = 32 * 1024;  // each of the two stage buffers

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
  if (!long_mode) {
    const int64_t per_block = kWarpThreads / 32;
    dense_warp_kernel<T><<<dim3((unsigned)((n_list + per_block - 1) /
                                           per_block),
                                batch),
                           kWarpThreads, 0, stream>>>(
        static_cast<T*>(data), bstride, list, n_list, rec, dst_off, dst_ld,
        dst_rows, dst_cols, dst_ptr);
  } else {
    const size_t smem = 2 * kStageBytes + kBlockThreads * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(
        dense_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dense_block_kernel<T><<<dim3((unsigned)n_list, batch), kBlockThreads,
                            smem, stream>>>(
        static_cast<T*>(data), bstride, list, rec, dst_off, dst_ld, dst_rows,
        dst_cols, dst_ptr, dst_nk);
  }
  return (int)cudaGetLastError();
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
// `list`; 1: a CTA per destination, whose staged record, (rows + cols) x
// nk values, must fit in 32 KB in f64 (the host's 32-row pieces and
// 32-column slices see to it). Returns the cudaError_t of the launch.
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
