// K3-rest tri_solve / wide_tri_solve: diagonal solve of one bucket by
// substitution on the lower triangle, for partial-range solves.
//
// Replaces PlannedBackend._diag_solve with use_inv=False
// (baspacho_tpu/ops/planned_backend.py:2134): _tri (:2105), which uses
// _unrolled_lower_inv (:1336) for cp <= 8, triangular_solve for
// cp <= 512 and _big_panel_solve (:1192) above, as driven level by level
// by make_solve_l / make_solve_lt (:2201-2235). Partial-range solves run
// on data from factor_up_to / factor_from, whose strict upper holds
// Linv^T, and on pseudo-factored data, which holds none: so these kernels
// read only the lower triangle of each diag block, only its n = cols[i]
// real columns and only the rows[i] real below rows (the padding of the
// input buffer need not be zero). The RHS rows and the L pass's below
// products follow bucket_solve.cu:
//   L pass:  x = L^-1 vv[rows]; vv[rows] = x; y[r] = below[r] . x
//            (the segmented-subtract kernel then applies vv[bidx] -= y)
//   Lt pass: x = vv[rows] - below^T vv[bidx] (sentinel rows skipped);
//            vv[rows] = L^-T x
//
// Narrow (cp <= 512), tri_l_kernel / tri_lt_kernel: one CTA per (panel,
// batch item), the RHS columns staged in shared memory in chunks of kc,
// column-oriented substitution (step j: divide row j, then every thread
// updates its (row, column) pairs below / above it), two barriers per
// column; in the Lt pass, the threads share the below^T term's rows when
// the panel has few columns. The JAX split at cp 8 (an explicit inverse,
// for XLA) is not carried over. Bound by latency: a cp-4 panel is 3 short
// steps, and the 50,000 panels of a Schur level run as 50,000 CTAs.
//
// Wide (cp > 512): a dependent chain of 128-wide diagonal tiles, as
// _big_panel_solve runs it. tri_wide_pre gathers the panel's RHS rows into
// a (batch, B, cp, nrhs) scratch xs (Lt pass: minus the below^T term);
// tri_wide_inv inverts every diagonal tile at once (one CTA per tile, 8
// threads per column of its inverse); then one tri_wide_step launch per
// tile, in order: every CTA multiplies the tile's RHS rows by the tile's
// inverse (8 threads per output), CTA 0 keeps the result, and each CTA
// applies it to its block of the rest of xs (64 rows or columns of the
// off-diagonal block, 16 threads each), so a chain step is one launch
// with the panel's rows on many CTAs. tri_wide_post writes the solution
// back and, in the L pass, y. Bound by the chain of short dependent
// launches (27 per pass on the corner: pre, inverse, 24 steps, post), not
// by its bytes (the lower triangle, 36 MB at cp 3072 in f64, ~11 us).
// Every sum has a fixed order, so reruns agree bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void tri_l_kernel(const T* data, int64_t data_bstride, T* vv,
                             int64_t vv_bstride, T* y, int64_t y_bstride,
                             int64_t y_base, const int64_t* off,
                             const int64_t* rows, const int64_t* cols,
                             const int64_t* vec_off, int cp, int rp,
                             int nrhs, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  const int64_t i = blockIdx.x;
  const T* P = data + (int64_t)blockIdx.y * data_bstride + off[i];
  const T* below = P + (int64_t)cp * cp;
  T* v = vv + (int64_t)blockIdx.y * vv_bstride;
  const int n = (int)cols[i], nrows = rp > 0 ? (int)rows[i] : 0;
  const int64_t v0 = vec_off[i], ld = cp;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k0 = 0; k0 < nrhs; k0 += kc) {
    const int w = min(kc, nrhs - k0);
    for (int t = tid; t < n * w; t += nt)
      sb[t] = v[(v0 + t / w) * nrhs + k0 + t % w];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (tid < w) sb[j * w + tid] /= P[j * ld + j];
      __syncthreads();
      for (int t = tid; t < (n - 1 - j) * w; t += nt) {
        const int r = j + 1 + t / w, k = t % w;
        sb[r * w + k] -= P[r * ld + j] * sb[j * w + k];
      }
      __syncthreads();
    }
    for (int t = tid; t < n * w; t += nt)
      v[(v0 + t / w) * nrhs + k0 + t % w] = sb[t];
    if (rp > 0) {
      T* yo = y + (int64_t)blockIdx.y * y_bstride + y_base +
              i * rp * (int64_t)nrhs;
      for (int t = tid; t < rp * w; t += nt) {
        const int r = t / w, k = t % w;
        T acc = T(0);
        if (r < nrows) {
          const T* br = below + r * ld;
          for (int j = 0; j < n; ++j) acc += br[j] * sb[j * w + k];
        }
        yo[(int64_t)r * nrhs + k0 + k] = acc;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void tri_lt_kernel(const T* data, int64_t data_bstride, T* vv,
                              int64_t vv_bstride, const int64_t* off,
                              const int64_t* rows, const int64_t* cols,
                              const int64_t* vec_off,
                              const int64_t* below_idx, int64_t order,
                              int cp, int rp, int nrhs, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  T* red = sb + (int64_t)cp * kc;  // blockDim.x partial sums
  const int64_t i = blockIdx.x;
  const T* P = data + (int64_t)blockIdx.y * data_bstride + off[i];
  const T* below = P + (int64_t)cp * cp;
  const int64_t* bidx = below_idx + i * rp;
  T* v = vv + (int64_t)blockIdx.y * vv_bstride;
  const int n = (int)cols[i], nrows = rp > 0 ? (int)rows[i] : 0;
  const int64_t v0 = vec_off[i], ld = cp;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k0 = 0; k0 < nrhs; k0 += kc) {
    const int w = min(kc, nrhs - k0);
    // x[j] = b[j] - sum_r below[r][j] vv[bidx[r]]: with few (j, k)
    // pairs (cp 4: 3 of them), np threads share each pair's rows,
    // strided, and their partial sums are added in part order
    const int ne = n * w, np = ne >= nt ? 1 : nt / ne;
    if (np == 1) {
      for (int t = tid; t < ne; t += nt) {
        const int j = t / w, k = t % w;
        T acc = v[(v0 + j) * nrhs + k0 + k];
        for (int r = 0; r < nrows; ++r) {
          const int64_t q = bidx[r];
          if (q != order) acc -= below[r * ld + j] * v[q * nrhs + k0 + k];
        }
        sb[t] = acc;
      }
    } else {
      T acc = T(0);
      if (tid < np * ne) {
        const int e = tid % ne, j = e / w, k = e % w;
        for (int r = tid / ne; r < nrows; r += np) {
          const int64_t q = bidx[r];
          if (q != order) acc += below[r * ld + j] * v[q * nrhs + k0 + k];
        }
      }
      red[tid] = acc;
      __syncthreads();
      if (tid < ne) {
        T x = v[(v0 + tid / w) * nrhs + k0 + tid % w];
        for (int p = 0; p < np; ++p) x -= red[p * ne + tid];
        sb[tid] = x;
      }
    }
    __syncthreads();
    // back substitution on L^T: row j of L is contiguous
    for (int j = n - 1; j >= 0; --j) {
      if (tid < w) sb[j * w + tid] /= P[j * ld + j];
      __syncthreads();
      for (int t = tid; t < j * w; t += nt) {
        const int m = t / w, k = t % w;
        sb[m * w + k] -= P[j * ld + m] * sb[j * w + k];
      }
      __syncthreads();
    }
    for (int t = tid; t < n * w; t += nt)
      v[(v0 + t / w) * nrhs + k0 + t % w] = sb[t];
    __syncthreads();
  }
}

// scratch xs (batch, B, cp, nrhs): xs[j] = vv[v0 + j] for j < n (Lt pass:
// minus sum_r below[r][j] vv[bidx[r]]), 0 for n <= j < cp
template <typename T>
__global__ void tri_wide_pre_kernel(const T* data, int64_t data_bstride,
                                    const T* vv, int64_t vv_bstride, T* xs,
                                    const int64_t* off, const int64_t* rows,
                                    const int64_t* cols,
                                    const int64_t* vec_off,
                                    const int64_t* below_idx, int64_t order,
                                    int cp, int rp, int nrhs, int transpose) {
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cp) return;
  T* out = xs + ((int64_t)blockIdx.z * B + i) * ld * nrhs;
  const int n = (int)cols[i];
  if (j >= n) {
    for (int k = 0; k < nrhs; ++k) out[(int64_t)j * nrhs + k] = T(0);
    return;
  }
  const T* below = data + (int64_t)blockIdx.z * data_bstride + off[i] +
                   ld * ld;
  const T* v = vv + (int64_t)blockIdx.z * vv_bstride;
  const int64_t* bidx = below_idx + i * rp;
  const int nrows = (transpose && rp > 0) ? (int)rows[i] : 0;
  const int64_t v0 = vec_off[i];
  for (int k = 0; k < nrhs; ++k) {
    T acc = v[(v0 + j) * nrhs + k];
    for (int r = 0; r < nrows; ++r) {
      const int64_t q = bidx[r];
      if (q != order) acc -= below[r * ld + j] * v[q * nrhs + k];
    }
    out[(int64_t)j * nrhs + k] = acc;
  }
}

constexpr int kQuads = 8;  // threads per column of tri_wide_inv

// inverses of every diagonal tile of each panel, all at once: CTA
// (tile, panel, batch item), kQuads threads per column c of the tile's
// inverse, which they compute by forward substitution: for each row r,
// each thread sums every kQuads-th term of L[r, c:r] . X[c:r, c], a
// butterfly over the kQuads lanes adds the parts, and the column's first
// lane writes X[r, c] to shared memory (row stride nb + 1). Out: tinv
// (batch, B, cp / nb, nb, nb), zero outside the tile's w x w lower
// triangle, stored as Tinv^T for the L pass and as Tinv for the Lt pass,
// so that tri_wide_step's thread t reads column t (contiguous across
// threads) in either pass.
template <typename T>
__global__ void tri_wide_inv_kernel(const T* data, int64_t data_bstride,
                                    T* tinv, const int64_t* off,
                                    const int64_t* cols, int cp, int nb,
                                    int transpose) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* X = reinterpret_cast<T*>(smem_raw);
  const int k = blockIdx.x, ntile = gridDim.x;
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int z = blockIdx.z, k0 = k * nb;
  const int w = min(nb, (int)cols[i] - k0);
  if (w <= 0) return;
  const T* P = data + (int64_t)z * data_bstride + off[i] + k0 * ld + k0;
  const int c = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
  const int sx = nb + 1;
  const bool col = c < w;
  for (int r = 0; r < w; ++r) {
    const T* Lr = P + r * ld;
    T acc = T(0);
    if (col && r > c) {
#pragma unroll 4
      for (int m = c + q; m < r; m += kQuads) acc += Lr[m] * X[m * sx + c];
    }
    for (int o = 1; o < kQuads; o <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (col && q == 0)
      X[r * sx + c] = r < c ? T(0) : (r == c ? T(1) / Lr[r] : -acc / Lr[r]);
    __syncwarp();
  }
  __syncthreads();
  T* out = tinv + (((int64_t)z * B + i) * ntile + k) * nb * nb;
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int r = transpose ? e / nb : e % nb;
    const int cc = transpose ? e % nb : e / nb;
    out[e] = (r < w && cc < w) ? X[r * sx + cc] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kWarps = 8;    // warps per CTA of tri_wide_post
constexpr int kBlock = 64;   // rows (L pass) or columns (Lt pass) per CTA
                             // of tri_wide_step's update
constexpr int kParts = 16;   // threads per row or column of that update
constexpr int kSolve = 8;    // threads per output of tri_wide_step's
                             // product with the tile's inverse

// one step of the tile chain, for tile [k0, k0 + w) of each panel (w =
// min(nb, n - k0)), on kBlock * kParts = nb * kSolve threads: every CTA
// computes the tile's solution s = Tinv x (L pass) or Tinv^T x (Lt pass)
// from the running RHS xs (kSolve threads per output t, each reading
// every kSolve-th row of column t of the stored inverse), CTA 0 stores it
// in xsol, and each CTA applies it to its block of the rest: L pass rows
// [k1, n), xs[r] -= L[r, tile] s; Lt pass columns [0, k0), xs[c] -=
// L[tile, c]^T s (kParts threads per row or column). Parts are added by
// butterflies in a fixed order. No CTA writes the tile's rows of xs in
// its step, so all read the same x; each row of the rest is written by
// one CTA.
template <typename T>
__global__ void tri_wide_step_kernel(const T* data, int64_t data_bstride,
                                     const T* tinv, T* xs, T* xsol,
                                     const int64_t* off,
                                     const int64_t* cols, int cp, int k0,
                                     int nb, int nrhs, int transpose) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sin = reinterpret_cast<T*>(smem_raw);
  T* sout = sin + nb;
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int z = blockIdx.z, ntile = cp / nb;
  const int n = (int)cols[i], w = min(nb, n - k0), k1 = k0 + w;
  if (w <= 0) return;
  const int lo = transpose ? blockIdx.x * kBlock : k1 + blockIdx.x * kBlock;
  const int hi = transpose ? min(k0, lo + kBlock) : min(n, lo + kBlock);
  if (blockIdx.x > 0 && lo >= hi) return;
  const T* P = data + (int64_t)z * data_bstride + off[i];
  const T* Ti = tinv + (((int64_t)z * B + i) * ntile + k0 / nb) * nb * nb;
  T* x = xs + ((int64_t)z * B + i) * ld * nrhs;
  T* xo = xsol + ((int64_t)z * B + i) * ld * nrhs;
  const int tid = threadIdx.x;
  const int t = tid / kSolve, q = tid % kSolve;    // output, its part
  const int e = tid / kParts, part = tid % kParts;  // update row / column
  for (int k = 0; k < nrhs; ++k) {
    if (tid < w) sin[tid] = x[(int64_t)(k0 + tid) * nrhs + k];
    __syncthreads();
    T acc = T(0);
    if (t < w) {
#pragma unroll 4
      for (int m = q; m < w; m += kSolve) acc += Ti[m * nb + t] * sin[m];
    }
    for (int o = 1; o < kSolve; o <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (t < w && q == 0) sout[t] = acc;
    __syncthreads();
    if (blockIdx.x == 0 && tid < w)
      xo[(int64_t)(k0 + tid) * nrhs + k] = sout[tid];
    const int g = lo + e;
    acc = T(0);
    if (g < hi) {
      if (!transpose) {
        const T* Lr = P + g * ld + k0;
#pragma unroll 4
        for (int m = part; m < w; m += kParts) acc += Lr[m] * sout[m];
      } else {
        const T* Lc = P + k0 * ld + g;
#pragma unroll 4
        for (int m = part; m < w; m += kParts) acc += Lc[m * ld] * sout[m];
      }
    }
    for (int o = 1; o < kParts; o <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (g < hi && part == 0) x[(int64_t)g * nrhs + k] -= acc;
    __syncthreads();
  }
}

// vv[rows] = xs; L pass: y[r] = below[r] . xs (0 past the real rows).
// One warp per row q: q < cp a RHS row, q >= cp below row q - cp.
template <typename T>
__global__ void tri_wide_post_kernel(const T* data, int64_t data_bstride,
                                     T* vv, int64_t vv_bstride, T* y,
                                     int64_t y_bstride, int64_t y_base,
                                     const T* xs, const int64_t* off,
                                     const int64_t* rows, const int64_t* cols,
                                     const int64_t* vec_off, int cp, int rp,
                                     int nrhs) {
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = (int)cols[i];
  const T* x = xs + ((int64_t)blockIdx.z * B + i) * ld * nrhs;
  if (q < cp) {
    if (q >= n) return;
    T* v = vv + (int64_t)blockIdx.z * vv_bstride + (vec_off[i] + q) * nrhs;
    for (int k = lane; k < nrhs; k += 32) v[k] = x[(int64_t)q * nrhs + k];
    return;
  }
  const int r = q - cp;
  if (r >= rp) return;
  const T* br = data + (int64_t)blockIdx.z * data_bstride + off[i] +
                ld * ld + r * ld;
  T* yo = y + (int64_t)blockIdx.z * y_bstride + y_base +
          (i * rp + r) * (int64_t)nrhs;
  const bool real = r < (int)rows[i];
  for (int k = 0; k < nrhs; ++k) {
    T acc = T(0);
    if (real)
      for (int j = lane; j < n; j += 32) acc += br[j] * x[(int64_t)j * nrhs + k];
    acc = warp_sum(acc);
    if (lane == 0) yo[k] = acc;
  }
}

template <typename T>
int launch_narrow(int transpose, const void* data, int64_t data_bstride,
                  void* vv, int64_t vv_bstride, void* y, int64_t y_bstride,
                  int64_t y_base, const int64_t* off, const int64_t* rows,
                  const int64_t* cols, const int64_t* vec_off,
                  const int64_t* below_idx, int64_t order, int64_t B, int cp,
                  int rp, int nrhs, int batch, cudaStream_t stream) {
  const int nt = cp <= 8 ? 64 : (cp <= 32 ? 128 : 256);
  int kc = 32768 / (cp * (int)sizeof(T));
  kc = kc < 1 ? 1 : (kc > nrhs ? nrhs : kc);
  const dim3 grid((unsigned)B, batch);
  const T* d = static_cast<const T*>(data);
  const size_t smem = ((size_t)cp * kc + nt) * sizeof(T);
  if (!transpose) {
    tri_l_kernel<T><<<grid, nt, smem, stream>>>(
        d, data_bstride, static_cast<T*>(vv), vv_bstride,
        static_cast<T*>(y), y_bstride, y_base, off, rows, cols, vec_off, cp,
        rp, nrhs, kc);
  } else {
    tri_lt_kernel<T><<<grid, nt, smem, stream>>>(
        d, data_bstride, static_cast<T*>(vv), vv_bstride, off, rows, cols,
        vec_off, below_idx, order, cp, rp, nrhs, kc);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide_inv(const void* data, int64_t data_bstride, void* tinv,
                    const int64_t* off, const int64_t* cols, int64_t B,
                    int cp, int nb, int batch, int transpose,
                    cudaStream_t stream) {
  const size_t smem = (size_t)nb * (nb + 1) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      tri_wide_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  tri_wide_inv_kernel<T><<<dim3(cp / nb, (unsigned)B, batch), nb * kQuads,
                           smem, stream>>>(static_cast<const T*>(data),
                                     data_bstride, static_cast<T*>(tinv),
                                     off, cols, cp, nb, transpose);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64; transpose: 0 L pass, 1 Lt pass.
// Each returns the cudaError_t of its launches.
extern "C" int bs_tri_solve(int dtype, int transpose, const void* data,
                            int64_t data_bstride, void* vv,
                            int64_t vv_bstride, void* y, int64_t y_bstride,
                            int64_t y_base, const int64_t* off,
                            const int64_t* rows, const int64_t* cols,
                            const int64_t* vec_off, const int64_t* below_idx,
                            int64_t order, int64_t B, int cp, int rp,
                            int nrhs, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_narrow<float>(transpose, data, data_bstride, vv,
                                vv_bstride, y, y_bstride, y_base, off, rows,
                                cols, vec_off, below_idx, order, B, cp, rp,
                                nrhs, batch, s);
  if (dtype == 1)
    return launch_narrow<double>(transpose, data, data_bstride, vv,
                                 vv_bstride, y, y_bstride, y_base, off, rows,
                                 cols, vec_off, below_idx, order, B, cp, rp,
                                 nrhs, batch, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bs_tri_wide_pre(int dtype, int transpose, const void* data,
                               int64_t data_bstride, const void* vv,
                               int64_t vv_bstride, void* xs,
                               const int64_t* off, const int64_t* rows,
                               const int64_t* cols, const int64_t* vec_off,
                               const int64_t* below_idx, int64_t order,
                               int64_t B, int cp, int rp, int nrhs, int batch,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((cp + 127) / 128, (unsigned)B, batch);
  if (dtype == 0)
    tri_wide_pre_kernel<float><<<grid, 128, 0, s>>>(
        static_cast<const float*>(data), data_bstride,
        static_cast<const float*>(vv), vv_bstride, static_cast<float*>(xs),
        off, rows, cols, vec_off, below_idx, order, cp, rp, nrhs, transpose);
  else if (dtype == 1)
    tri_wide_pre_kernel<double><<<grid, 128, 0, s>>>(
        static_cast<const double*>(data), data_bstride,
        static_cast<const double*>(vv), vv_bstride, static_cast<double*>(xs),
        off, rows, cols, vec_off, below_idx, order, cp, rp, nrhs, transpose);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int bs_tri_wide_inv(int dtype, int transpose, const void* data,
                               int64_t data_bstride, void* tinv,
                               const int64_t* off, const int64_t* cols,
                               int64_t B, int cp, int nb, int batch,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_wide_inv<float>(data, data_bstride, tinv, off, cols, B, cp,
                                  nb, batch, transpose, s);
  if (dtype == 1)
    return launch_wide_inv<double>(data, data_bstride, tinv, off, cols, B,
                                   cp, nb, batch, transpose, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bs_tri_wide_step(int dtype, int transpose, const void* data,
                                int64_t data_bstride, const void* tinv,
                                void* xs, void* xsol, const int64_t* off,
                                const int64_t* cols, int64_t B, int cp, int k0,
                                int nb, int nrhs, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb * kSolve != kBlock * kParts) return (int)cudaErrorInvalidValue;
  const dim3 grid((cp + kBlock - 1) / kBlock, (unsigned)B, batch);
  if (dtype == 0)
    tri_wide_step_kernel<float><<<grid, nb * kSolve,
                                  2 * nb * sizeof(float), s>>>(
        static_cast<const float*>(data), data_bstride,
        static_cast<const float*>(tinv), static_cast<float*>(xs),
        static_cast<float*>(xsol), off, cols, cp, k0, nb, nrhs, transpose);
  else if (dtype == 1)
    tri_wide_step_kernel<double><<<grid, nb * kSolve,
                                   2 * nb * sizeof(double), s>>>(
        static_cast<const double*>(data), data_bstride,
        static_cast<const double*>(tinv), static_cast<double*>(xs),
        static_cast<double*>(xsol), off, cols, cp, k0, nb, nrhs, transpose);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int bs_tri_wide_post(int dtype, const void* data,
                                int64_t data_bstride, void* vv,
                                int64_t vv_bstride, void* y, int64_t y_bstride,
                                int64_t y_base, const void* xs,
                                const int64_t* off, const int64_t* rows,
                                const int64_t* cols, const int64_t* vec_off,
                                int64_t B, int cp, int rp, int nrhs, int batch,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((cp + rp + kWarps - 1) / kWarps, (unsigned)B, batch);
  if (dtype == 0)
    tri_wide_post_kernel<float><<<grid, 32 * kWarps, 0, s>>>(
        static_cast<const float*>(data), data_bstride,
        static_cast<float*>(vv), vv_bstride, static_cast<float*>(y),
        y_bstride, y_base, static_cast<const float*>(xs), off, rows, cols,
        vec_off, cp, rp, nrhs);
  else if (dtype == 1)
    tri_wide_post_kernel<double><<<grid, 32 * kWarps, 0, s>>>(
        static_cast<const double*>(data), data_bstride,
        static_cast<double*>(vv), vv_bstride, static_cast<double*>(y),
        y_bstride, y_base, static_cast<const double*>(xs), off, rows, cols,
        vec_off, cp, rp, nrhs);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
