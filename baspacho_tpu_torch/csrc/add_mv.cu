// K5 add_mv / wide_add_mv: symmetric block mat-vec, out += alpha M x, over
// one bucket of panels.
//
// Replaces PlannedBackend.make_add_mv (baspacho_tpu/ops/planned_backend.py:
// 3078-3133) and UnrolledBackend.make_add_mv (ops/ref_backend.py:174-205):
// the inner loop of PCG and of refinement. Per panel p with n = cols[p]
// real columns and rows[p] real below rows:
//   out[own rows] += alpha (sym(lower(diag)) x_own + below^T x[bidx])
//   y[r]           = -alpha below[r] . x_own
// The panel's own rows are written by no other panel; the below rows of
// many panels land on shared rows, so they go to the scratch y, and after
// every add_mv launch of the call one segmented-subtract (K2) over a
// target-sorted CSR applies out[bidx] -= y. Only the lower triangle of the
// diag block is read (a factor stores Linv^T above it), only real columns
// and rows (the padding need not be zero); bidx == order marks a padding
// row. No atomics: every sum is taken in one fixed order that depends on
// the bucket's shape (cp, rp) only, so batch items equal their single
// runs and reruns equal each other, bitwise.
//
// A panel is one contiguous (cp + rp) x cp row-major block, and both its
// terms are sums over the same real elements A[i][m] (own rows i: m <= i,
// the lower triangle; below rows: m < n): row i's dot A[i] . x_own (own
// rows: its part of the out row; below rows: y) and the column sums
// sum_i A[i][m] g_i (g_i = x_own[i] for an own row, strictly below the
// diagonal, and x[bidx] for a below row). Bound by reading the panels at
// nrhs 1: BAL 871's PCG operator reads 17.6 MB of narrow panels and
// ~220 MB of wide ones per call. The earlier design ran one CTA per panel
// with a thread per column walking every below row in series, a
// dependent bidx -> x gather per row: 2.4 ms for BAL's cp-256 panel on an
// H100 (PERF.md). Every grid here reads its rows once, row-major,
// coalesced, on many CTAs, forms both terms from each element it loads,
// and issues its gathers ahead of the rows that use them; the layout of
// a bucket (ops/kernels.py mv_layout) depends on (cp, rp) only:
//
//   mv_warp_kernel (4 <= cp <= 32, at most 1024 elements a panel: Schur's
//     and BAL's points): one warp per panel, eight panels per CTA, no
//     block barrier. The panel's real elements are copied into shared
//     memory by cp.async and all its rows' bidx, then all their gathers,
//     loaded at once, before any is used. cp lanes per row, 32 / cp rows
//     per step; a row's dot by a butterfly within its lane group, the
//     column sums per lane, joined across the groups at the end, the
//     panel's out rows written at once.
//   mv_chunk_kernel (every other narrow shape) and wide_mv_chunk_kernel
//     (cp > 512): one CTA of eight warps per (panel, chunk of at most 256
//     rows, column strip of up to 512), each warp on every eighth step of
//     the chunk with its rows' gathers in a register, up to 16 elements a
//     lane in flight. Row dots go to y (one strip) or to a row-partial
//     scratch; the warps' column sums are joined in warp order in shared
//     memory and written to a column-partial scratch per chunk. Strips
//     above an own-rows-only chunk hold no lower element and are skipped.
//     A panel that is one chunk and one strip finishes in the CTA.
//   mv_post_kernel / wide_mv_post_kernel: a CTA per 32 own rows, warp w
//     summing entries w, w + 8, ... of their partials (strips, then
//     chunks), the warps joined in order, into out; with several strips,
//     a thread per below row sums its strips into y.
// Grids run over (work item, batch item x RHS column): each RHS column of
// each batch item is an independent pass over the same panels. The wide
// panels' grids carry names of their own, for the traces.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

constexpr int kWarps = 8;      // warps per CTA of every grid
constexpr int kPostThreads = 256;
constexpr int kWarpElems = 1024;  // elements of a panel of mv_warp_kernel
//                                   at most (ops/kernels.py MV_WARP_ELEMS)

// one launch's operands and grid layout (bs_add_mv); strides in elements
struct Mv {
  const void* data;
  int64_t data_bs;
  const void* x;
  int64_t x_bs;
  void* out;
  int64_t out_bs;
  void* y;
  int64_t y_bs;
  int64_t y_base;        // first y row of the bucket
  void* part;            // column partials, then row partials
  const int64_t* off;
  const int64_t* rows;
  const int64_t* cols;
  const int64_t* vec_off;
  const int64_t* bidx;
  int64_t order;
  int64_t B;
  int cp, rp, nrhs;
  int W;                 // strip width: min(cp, 512)
  int nstrip;            // ceil(cp / W)
  int crc;               // rows per chunk (0: one warp per panel)
  int nchunk;            // ceil((cp + rp) / crc)
  double alpha;
};

// sum over aligned groups of G lanes (G a power of two), every lane of
// the group gets it
template <typename T>
__device__ __forceinline__ T group_sum(T v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the lanes of the same position in each group of G lanes
template <typename T>
__device__ __forceinline__ T across_groups(T v, int G) {
  for (int o = G; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the end of row i's real columns: an own row reads m <= i (the lower
// triangle), a below row m < n; rows past `end` read none
__device__ __forceinline__ int row_lim(int i, int cp, int n, int end) {
  return i < cp ? (i < n ? i + 1 : 0) : (i < end ? n : 0);
}

// row i's gather g_i: x_own[i] for an own row, x[bidx] for a below row
// (0 on a sentinel or past `end`)
template <typename T>
__device__ __forceinline__ T row_gather(int i, int cp, int n, int end,
                                        int64_t v0, const int64_t* bidx,
                                        int64_t order, const T* x,
                                        int nrhs) {
  if (i < cp) return i < n ? x[(v0 + i) * nrhs] : T(0);
  if (i >= end) return T(0);
  const int64_t q = bidx[i - cp];
  return q != order ? x[q * nrhs] : T(0);
}

// shared memory of one warp of mv_warp_kernel, in elements: the panel's
// elements in whole 32-lane steps, its rows' gathers, the own rows' dots
__host__ __device__ __forceinline__ int mv_warp_elems(int cp, int rp) {
  return ((cp + rp) * cp + 31) / 32 * 32 + cp + rp + 32;
}

// one warp per panel, kWarps panels a CTA, the panels' elements, gathers
// and dots in dynamic shared memory; 4 <= cp <= 32, (cp + rp) cp <=
// kWarpElems
template <typename T>
__global__ void __launch_bounds__(32 * kWarps) mv_warp_kernel(Mv a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cp = a.cp, rp = a.rp, h = cp + rp, RG = 32 / cp;
  T* sp = reinterpret_cast<T*>(smem) + warp * mv_warp_elems(cp, rp);
  T* gsm = sp + (h * cp + 31) / 32 * 32;
  T* rd = gsm + h;
  const int64_t p = (int64_t)blockIdx.x * kWarps + warp;
  if (p >= a.B) return;
  const int nrhs = a.nrhs, z = blockIdx.y / nrhs, k = blockIdx.y % nrhs;
  const int gi = lane / cp, m = lane % cp;  // lane's row in a step, column
  const int n = (int)a.cols[p], nrows = rp > 0 ? (int)a.rows[p] : 0;
  const int end = cp + nrows;
  const int64_t v0 = a.vec_off[p];
  const T* P = static_cast<const T*>(a.data) + z * a.data_bs + a.off[p];
  const T* x = static_cast<const T*>(a.x) + z * a.x_bs + k;
  const int64_t* bidx = a.bidx + p * rp;
  T* yk = rp > 0 ? static_cast<T*>(a.y) + z * a.y_bs +
                       (a.y_base + p * rp) * nrhs + k
                 : nullptr;
  const T alpha = T(a.alpha);
  // every load of the panel issued before any is used: its real elements
  // by cp.async (element 32 s + lane is step s's, padding zero-filled,
  // not read), then its rows' bidx, then their gathers
  for (int s = 0; 32 * s < end * cp; ++s) {
    const int i = s * RG + gi;
    const bool real = m < row_lim(i, cp, n, end);
    cp_async_el(sp + 32 * s + lane, real ? P + 32 * s + lane : P,
                real ? (int)sizeof(T) : 0);
  }
  cp_async_commit();
  int64_t q[kWarpElems / 4 / 32];
#pragma unroll
  for (int w = 0; w < kWarpElems / 4 / 32; ++w) {
    const int i = 32 * w + lane;
    q[w] = i >= cp && i < end ? bidx[i - cp] : a.order;
  }
#pragma unroll
  for (int w = 0; w < kWarpElems / 4 / 32; ++w) {
    const int i = 32 * w + lane;
    if (i < end)
      gsm[i] = i < cp ? (i < n ? x[(v0 + i) * nrhs] : T(0))
                      : (q[w] != a.order ? x[q[w] * nrhs] : T(0));
  }
  const T xo = m < n ? x[(v0 + m) * nrhs] : T(0);
  cp_async_wait<0>();
  __syncwarp();
  T acc = T(0);
  for (int s = 0; s * RG < end; ++s) {
    const int i = s * RG + gi;
    const int lim = row_lim(i, cp, n, end);
    const T e = sp[32 * s + lane];
    const T g = lim > 0 ? gsm[i] : T(0);
    if (i >= cp || m < i) acc += e * g;
    const T d = group_sum(e * xo, cp);
    if (m == 0 && lim > 0) {
      if (i < cp) rd[i] = d;
      else yk[(int64_t)(i - cp) * nrhs] = -alpha * d;
    }
  }
  acc = across_groups(acc, cp);
  __syncwarp();
  if (lane < n) {
    T* o = static_cast<T*>(a.out) + z * a.out_bs + (v0 + lane) * nrhs + k;
    *o += alpha * (rd[lane] + acc);
  }
  for (int r = nrows + lane; r < rp; r += 32) yk[(int64_t)r * nrhs] = T(0);
}

// CT = columns per lane in a strip: max(1, W / 32)
template <typename T, int CT>
__device__ __forceinline__ void mv_chunk(const Mv& a, T (*red)[CT * 32],
                                         T* rd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = a.nchunk * a.nstrip;
  const int64_t p = blockIdx.x / per;
  const int c = (int)(blockIdx.x % per) / a.nstrip;
  const int s = (int)(blockIdx.x % a.nstrip);
  const int cp = a.cp, rp = a.rp, h = cp + rp, W = a.W;
  const int r0 = c * a.crc, r1 = min(r0 + a.crc, h), c0 = s * W;
  // own rows above the strip: no lower element, and the post reads
  // nothing of this item
  if (r1 <= cp && r1 <= c0) return;
  const int G = W < 32 ? W : 32, RG = 32 / G;
  const int gi = lane / G, m = lane % G;
  const int nrhs = a.nrhs, z = blockIdx.y / nrhs, k = blockIdx.y % nrhs;
  const int n = (int)a.cols[p], nrows = rp > 0 ? (int)a.rows[p] : 0;
  const int end = cp + nrows, rend = min(r1, end);
  const int64_t v0 = a.vec_off[p];
  const T* P = static_cast<const T*>(a.data) + z * a.data_bs + a.off[p];
  const T* x = static_cast<const T*>(a.x) + z * a.x_bs + k;
  const int64_t* bidx = a.bidx + p * rp;
  const bool fused = a.nchunk == 1 && a.nstrip == 1;
  const bool direct_y = a.nstrip == 1;
  const int64_t item = (int64_t)blockIdx.y * a.B + p;
  T* colp = static_cast<T*>(a.part) + (item * a.nchunk + c) * cp;
  T* rowp = static_cast<T*>(a.part) + gridDim.y * a.B * a.nchunk * cp +
            (item * a.nstrip + s) * h;
  T* yk = rp > 0 ? static_cast<T*>(a.y) + z * a.y_bs +
                       (a.y_base + p * rp) * nrhs + k
                 : nullptr;
  const T alpha = T(a.alpha);
  // the gathers of this warp's rows (at most 32: crc <= 256), lane
  // l holding the l-th, loaded ahead of the rows
  const int il = r0 + warp * RG + (lane / RG) * kWarps * RG + lane % RG;
  const T gw = il < rend ? row_gather(il, cp, n, end, v0, bidx, a.order, x,
                                      nrhs)
                         : T(0);
  T xo[CT], acc[CT];
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int col = c0 + m + 32 * t;
    xo[t] = col < n ? x[(v0 + col) * nrhs] : T(0);
    acc[t] = T(0);
  }
  // rows of up to 16 loads a lane in flight
  int kk = 0;
#pragma unroll (CT >= 16 ? 1 : 16 / CT)
  for (int ib = r0 + warp * RG; ib < rend; ib += kWarps * RG, ++kk) {
    const int i = ib + gi;  // < r1: crc is a multiple of kWarps * RG
    const int lim = row_lim(i, cp, n, end);
    const T g = __shfl_sync(0xffffffffu, gw, kk * RG + gi);
    const T* Pi = P + (int64_t)i * cp;
    T d = T(0);
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int col = c0 + m + 32 * t;
      const T e = col < lim ? Pi[col] : T(0);
      d += e * xo[t];
      if (i >= cp || col < i) acc[t] += e * g;
    }
    d = group_sum(d, G);
    if (m == 0 && lim > 0) {
      if (i >= cp && direct_y) yk[(int64_t)(i - cp) * nrhs] = -alpha * d;
      else if (fused) rd[i] = d;
      else rowp[i] = d;
    }
  }
  if (direct_y && rp > 0)  // the padding rows' y
    for (int i = max(max(r0, end), cp) + threadIdx.x; i < r1;
         i += blockDim.x)
      yk[(int64_t)(i - cp) * nrhs] = T(0);
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    acc[t] = across_groups(acc[t], G);
    if (gi == 0) red[warp][m + 32 * t] = acc[t];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int col = c0 + j;
    if (col >= n) break;
    T v = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][j];
    if (fused)
      static_cast<T*>(a.out)[z * a.out_bs + (v0 + col) * nrhs + k] +=
          alpha * (rd[col] + v);
    else
      colp[col] = v;
  }
}

template <typename T, int CT>
__global__ void __launch_bounds__(32 * kWarps) mv_chunk_kernel(Mv a) {
  __shared__ T red[kWarps][CT * 32];
  __shared__ T rd[CT * 32];
  mv_chunk<T, CT>(a, red, rd);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) wide_mv_chunk_kernel(Mv a) {
  __shared__ T red[kWarps][512];
  __shared__ T rd[512];
  mv_chunk<T, 16>(a, red, rd);
}

// own rows in blocks of 32 columns, a CTA each: warp w sums the entries
// w, w + 8, ... of the rows' partial list (strips 0..j / W, then chunks
// j / crc..c1, the same for the block's 32 columns: W and crc are
// multiples of 32 or the panel is one strip narrower than 32), the warps'
// sums joined in warp order; with several strips, further CTAs sum the
// below rows' strips into y, a thread per row
template <typename T>
__device__ __forceinline__ void mv_post(const Mv& a, T (*red)[32]) {
  const int cp = a.cp, rp = a.rp, h = cp + rp;
  const int ncb = (cp + 31) / 32;
  const int nyb = a.nstrip > 1 ? (rp + kPostThreads - 1) / kPostThreads : 0;
  const int64_t p = blockIdx.x / (ncb + nyb);
  const int q = (int)(blockIdx.x % (ncb + nyb));
  const int nrhs = a.nrhs, z = blockIdx.y / nrhs, k = blockIdx.y % nrhs;
  const int n = (int)a.cols[p], nrows = rp > 0 ? (int)a.rows[p] : 0;
  const int64_t item = (int64_t)blockIdx.y * a.B + p;
  const T* colp = static_cast<const T*>(a.part) + item * a.nchunk * cp;
  const T* rowp = static_cast<const T*>(a.part) +
                  gridDim.y * a.B * a.nchunk * cp + item * a.nstrip * h;
  const T alpha = T(a.alpha);
  if (q >= ncb) {
    const int r = (q - ncb) * kPostThreads + threadIdx.x;
    if (r >= rp) return;
    T acc = T(0);
    if (r < nrows)
      for (int s = 0; s < a.nstrip; ++s) acc += rowp[(int64_t)s * h + cp + r];
    static_cast<T*>(a.y)[z * a.y_bs + (a.y_base + p * rp + r) * nrhs + k] =
        -alpha * acc;
    return;
  }
  const int j0 = q * 32;
  if (j0 >= n) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, j = j0 + lane;
  const int sb = j0 / a.W, cb = j0 / a.crc;
  const int c1 = ((nrows > 0 ? cp + nrows : n) - 1) / a.crc;
  const int ne = sb + 1 + c1 - cb + 1;
  T acc = T(0);
  if (j < n) {
#pragma unroll 8
    for (int e = warp; e < ne; e += kWarps)
      acc += e <= sb ? rowp[(int64_t)e * h + j]
                     : colp[(int64_t)(cb + e - sb - 1) * cp + j];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && j < n) {
    T v = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][lane];
    static_cast<T*>(a.out)[z * a.out_bs + (a.vec_off[p] + j) * nrhs + k] +=
        alpha * v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPostThreads) mv_post_kernel(Mv a) {
  __shared__ T red[kWarps][32];
  mv_post<T>(a, red);
}

template <typename T>
__global__ void __launch_bounds__(kPostThreads) wide_mv_post_kernel(Mv a) {
  __shared__ T red[kWarps][32];
  mv_post<T>(a, red);
}

template <typename T>
int launch(const Mv& a, int batch, bool wide, cudaStream_t st) {
  const unsigned zk = (unsigned)(batch * a.nrhs);
  const int threads = 32 * kWarps;
  if (a.crc == 0) {
    if (a.cp < 4 || a.cp > 32 || (a.cp + a.rp) * a.cp > kWarpElems)
      return (int)cudaErrorInvalidValue;
    static bool sized = false;  // up to ~84 KB, past the default 48
    if (!sized) {
      cudaFuncSetAttribute(
          mv_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)(kWarps * (kWarpElems + kWarpElems / 4 + 32) * sizeof(T)));
      sized = true;
    }
    mv_warp_kernel<T><<<dim3((unsigned)((a.B + kWarps - 1) / kWarps), zk),
                        threads, kWarps * mv_warp_elems(a.cp, a.rp) *
                                     sizeof(T), st>>>(a);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)(a.B * a.nchunk * a.nstrip), zk);
  if (wide) {
    if (a.W != 512) return (int)cudaErrorInvalidValue;
    wide_mv_chunk_kernel<T><<<grid, threads, 0, st>>>(a);
  } else {
    switch (a.W >= 32 ? a.W / 32 : 1) {
      case 1: mv_chunk_kernel<T, 1><<<grid, threads, 0, st>>>(a); break;
      case 2: mv_chunk_kernel<T, 2><<<grid, threads, 0, st>>>(a); break;
      case 4: mv_chunk_kernel<T, 4><<<grid, threads, 0, st>>>(a); break;
      case 8: mv_chunk_kernel<T, 8><<<grid, threads, 0, st>>>(a); break;
      case 16: mv_chunk_kernel<T, 16><<<grid, threads, 0, st>>>(a); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || (a.nchunk == 1 && a.nstrip == 1)) return (int)e;
  const int64_t blocks = (a.cp + 31) / 32 +
                        (a.nstrip > 1 ? (a.rp + kPostThreads - 1) /
                                            kPostThreads : 0);
  const dim3 pg((unsigned)(a.B * blocks), zk);
  if (wide)
    wide_mv_post_kernel<T><<<pg, kPostThreads, 0, st>>>(a);
  else
    mv_post_kernel<T><<<pg, kPostThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. strip / chunk / nchunk: the grid layout
// (ops/kernels.py mv_layout; chunk 0: one warp per panel); part: the
// column and row partials, batch * nrhs * B * (nchunk * cp + nstrip *
// (cp + rp)) elements, unused by a one-launch layout; wide: the
// wide_mv_* grids (strip 512). Returns the cudaError_t of the launches.
extern "C" int bs_add_mv(int dtype, const void* data, int64_t data_bstride,
                         const void* x, int64_t x_bstride, void* out,
                         int64_t out_bstride, void* y, int64_t y_bstride,
                         int64_t y_base, void* part, const int64_t* off,
                         const int64_t* rows, const int64_t* cols,
                         const int64_t* vec_off, const int64_t* below_idx,
                         int64_t order, int64_t B, int cp, int rp, int nrhs,
                         int batch, int strip, int chunk, int nchunk,
                         int wide, double alpha, void* stream) {
  if (B == 0) return 0;
  Mv a{data, data_bstride, x, x_bstride, out, out_bstride, y, y_bstride,
       y_base, part, off, rows, cols, vec_off, below_idx, order, B, cp, rp,
       nrhs, strip, (cp + strip - 1) / strip, chunk, nchunk, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, batch, wide != 0, s);
  if (dtype == 1) return launch<double>(a, batch, wide != 0, s);
  return (int)cudaErrorInvalidValue;
}
