// K5 add_mv / wide_add_mv: symmetric block mat-vec, out += alpha M x, over
// one bucket of panels.
//
// Replaces PlannedBackend.make_add_mv (baspacho_tpu/ops/planned_backend.py:
// 3078-3133) and UnrolledBackend.make_add_mv (ops/ref_backend.py:174-205):
// the inner loop of PCG and of refinement. Per panel i with n = cols[i]
// real columns and rows[i] real below rows:
//   out[own rows] += alpha (sym(lower(diag)) x_own + below^T x[bidx])
//   y[r]           = -alpha below[r] . x_own
// The panel's own rows are written by no other panel, so the first line
// is a plain read-modify-write; the below rows of many panels land on
// shared rows, so they go to the scratch y, and after every add_mv launch
// of the call one segmented-subtract (K2) over a target-sorted CSR
// applies out[bidx] -= y: no atomics, every sum in one fixed order. Only
// the lower triangle of the diag block is read (a factor stores Linv^T
// above it), only real columns and rows (the padding need not be zero).
//
// Narrow (cp <= 512), mv_kernel: one CTA per (panel, batch item), x_own
// staged in shared memory; one thread per (own row, RHS column) (the
// below^T term's rows shared among several threads when the panel has
// few columns), then one per (below row, RHS column). Bound by latency at
// cp 4 (50,000 panels of a Schur level), by the panel reads above.
//
// Wide (cp > 512, the one panel of its level): wide_mv_tile splits the
// lower triangle into 64 x 64 tiles, one CTA each, and reads every element
// once for both of its terms (row sums L x into p1[column block], column
// sums L^T x into p2[row block]); wide_mv_post sums each row's partials in
// a fixed order (one warp per row, a butterfly reduction), adds the
// below^T term and writes out, and writes y. Bound by reading the lower
// triangle (36 MB at cp 3072 in f64, ~11 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTB = 64;     // tile edge of wide_mv_tile
constexpr int kWarps = 8;   // rows per CTA of wide_mv_post

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void mv_kernel(const T* data, int64_t data_bstride, const T* xv,
                          int64_t x_bstride, T* out, int64_t out_bstride,
                          T* y, int64_t y_bstride, int64_t y_base,
                          const int64_t* off, const int64_t* rows,
                          const int64_t* cols, const int64_t* vec_off,
                          const int64_t* below_idx, int64_t order, int cp,
                          int rp, int nrhs, int kc, T alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* red = sx + (int64_t)cp * kc;  // blockDim.x partial sums
  const int64_t i = blockIdx.x;
  const T* P = data + (int64_t)blockIdx.y * data_bstride + off[i];
  const T* below = P + (int64_t)cp * cp;
  const int64_t* bidx = below_idx + i * rp;
  const T* x = xv + (int64_t)blockIdx.y * x_bstride;
  T* o = out + (int64_t)blockIdx.y * out_bstride;
  const int n = (int)cols[i], nrows = rp > 0 ? (int)rows[i] : 0;
  const int64_t v0 = vec_off[i], ld = cp;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k0 = 0; k0 < nrhs; k0 += kc) {
    const int w = min(kc, nrhs - k0);
    for (int t = tid; t < n * w; t += nt)
      sx[t] = x[(v0 + t / w) * nrhs + k0 + t % w];
    // below^T x[bidx]: with few (j, k) pairs (cp 4: 3 of them), np
    // threads share each pair's rows, strided, summed in part order
    const int ne = n * w, np = ne >= nt ? 1 : nt / ne;
    if (np > 1) {
      T acc = T(0);
      if (tid < np * ne) {
        const int e = tid % ne, j = e / w, k = e % w;
        for (int r = tid / ne; r < nrows; r += np) {
          const int64_t q = bidx[r];
          if (q != order) acc += below[r * ld + j] * x[q * nrhs + k0 + k];
        }
      }
      red[tid] = acc;
    }
    __syncthreads();
    for (int t = tid; t < ne; t += nt) {
      const int j = t / w, k = t % w;
      T acc = T(0);
      for (int m = 0; m <= j; ++m) acc += P[j * ld + m] * sx[m * w + k];
      for (int m = j + 1; m < n; ++m) acc += P[m * ld + j] * sx[m * w + k];
      if (np == 1) {
        for (int r = 0; r < nrows; ++r) {
          const int64_t q = bidx[r];
          if (q != order) acc += below[r * ld + j] * x[q * nrhs + k0 + k];
        }
      } else {
        for (int p = 0; p < np; ++p) acc += red[p * ne + t];
      }
      o[(v0 + j) * nrhs + k0 + k] += alpha * acc;
    }
    if (rp > 0) {
      T* yo = y + (int64_t)blockIdx.y * y_bstride + y_base +
              i * rp * (int64_t)nrhs;
      for (int t = tid; t < rp * w; t += nt) {
        const int r = t / w, k = t % w;
        T acc = T(0);
        if (r < nrows) {
          const T* br = below + r * ld;
          for (int j = 0; j < n; ++j) acc += br[j] * sx[j * w + k];
        }
        yo[(int64_t)r * nrhs + k0 + k] = -alpha * acc;
      }
    }
    __syncthreads();
  }
}

// partials p1, p2: (batch, B, nblk, cp, nrhs), nblk = cp / kTB
template <typename T>
__global__ void wide_mv_tile_kernel(const T* data, int64_t data_bstride,
                                    const T* xv, int64_t x_bstride, T* p1,
                                    T* p2, const int64_t* off,
                                    const int64_t* cols,
                                    const int64_t* vec_off, int cp,
                                    int nrhs) {
  __shared__ T sT[kTB][kTB + 1];
  __shared__ T sxr[kTB], sxc[kTB];
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int z = blockIdx.z;
  // lower-triangular tile index -> (rb, cb), cb <= rb
  const int t = blockIdx.x;
  int rb = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((rb + 1) * (rb + 2) / 2 <= t) ++rb;
  while (rb * (rb + 1) / 2 > t) --rb;
  const int cb = t - rb * (rb + 1) / 2;
  const int n = (int)cols[i];
  const int r0 = rb * kTB, c0 = cb * kTB;
  if (r0 >= n) return;
  const T* P = data + (int64_t)z * data_bstride + off[i];
  const T* x = xv + (int64_t)z * x_bstride;
  const int64_t v0 = vec_off[i];
  const int nblk = cp / kTB;
  const int tid = threadIdx.x;
  for (int e = tid; e < kTB * kTB; e += blockDim.x) {
    const int r = e / kTB, c = e % kTB;
    const int gr = r0 + r, gc = c0 + c;
    sT[r][c] = (gr < n && gc < n && gc <= gr) ? P[gr * ld + gc] : T(0);
  }
  const int64_t pbase = ((int64_t)z * B + i) * nblk;
  for (int k = 0; k < nrhs; ++k) {
    if (tid < kTB) {
      const int g = r0 + tid;
      sxr[tid] = g < n ? x[(v0 + g) * nrhs + k] : T(0);
    } else {
      const int g = c0 + tid - kTB;
      sxc[tid - kTB] = g < n ? x[(v0 + g) * nrhs + k] : T(0);
    }
    __syncthreads();
    if (tid < kTB) {  // row sums: L x over this tile's columns
      T acc = T(0);
      for (int c = 0; c < kTB; ++c) acc += sT[tid][c] * sxc[c];
      p1[((pbase + cb) * cp + r0 + tid) * nrhs + k] = acc;
    } else {          // column sums: L^T x, strictly below the diagonal
      const int c = tid - kTB;
      T acc = T(0);
      for (int r = (rb == cb ? c + 1 : 0); r < kTB; ++r)
        acc += sT[r][c] * sxr[r];
      p2[((pbase + rb) * cp + c0 + c) * nrhs + k] = acc;
    }
    __syncthreads();
  }
}

// one warp per row q: q < cp an own row (sum of its partials and the
// below^T term into out), q >= cp below row q - cp (y)
template <typename T>
__global__ void wide_mv_post_kernel(const T* data, int64_t data_bstride,
                                    const T* xv, int64_t x_bstride, T* out,
                                    int64_t out_bstride, T* y,
                                    int64_t y_bstride, int64_t y_base,
                                    const T* p1, const T* p2,
                                    const int64_t* off, const int64_t* rows,
                                    const int64_t* cols,
                                    const int64_t* vec_off,
                                    const int64_t* below_idx, int64_t order,
                                    int cp, int rp, int nrhs, T alpha) {
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int z = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = (int)cols[i], nrows = rp > 0 ? (int)rows[i] : 0;
  const T* P = data + (int64_t)z * data_bstride + off[i];
  const T* below = P + ld * ld;
  const T* x = xv + (int64_t)z * x_bstride;
  const int64_t v0 = vec_off[i];
  if (q < cp) {
    if (q >= n) return;
    const int nblk = cp / kTB, nbn = (n + kTB - 1) / kTB, rbq = q / kTB;
    const int64_t pbase = ((int64_t)z * B + i) * nblk;
    const int64_t* bidx = below_idx + i * rp;
    const int n1 = rbq + 1, n2 = nbn - rbq, tot = n1 + n2 + nrows;
    T* o = out + (int64_t)z * out_bstride + (v0 + q) * nrhs;
    for (int k = 0; k < nrhs; ++k) {
      T acc = T(0);
      for (int e = lane; e < tot; e += 32) {
        if (e < n1) {
          acc += p1[((pbase + e) * cp + q) * nrhs + k];
        } else if (e < n1 + n2) {
          acc += p2[((pbase + rbq + e - n1) * cp + q) * nrhs + k];
        } else {
          const int r = e - n1 - n2;
          const int64_t b = bidx[r];
          if (b != order) acc += below[r * ld + q] * x[b * nrhs + k];
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) o[k] += alpha * acc;
    }
    return;
  }
  const int r = q - cp;
  if (r >= rp) return;
  const T* br = below + r * ld;
  T* yo = y + (int64_t)z * y_bstride + y_base + (i * rp + r) * (int64_t)nrhs;
  for (int k = 0; k < nrhs; ++k) {
    T acc = T(0);
    if (r < nrows)
      for (int j = lane; j < n; j += 32) acc += br[j] * x[(v0 + j) * nrhs + k];
    acc = warp_sum(acc);
    if (lane == 0) yo[k] = -alpha * acc;
  }
}

template <typename T>
int launch_narrow(const void* data, int64_t data_bstride, const void* x,
                  int64_t x_bstride, void* out, int64_t out_bstride, void* y,
                  int64_t y_bstride, int64_t y_base, const int64_t* off,
                  const int64_t* rows, const int64_t* cols,
                  const int64_t* vec_off, const int64_t* below_idx,
                  int64_t order, int64_t B, int cp, int rp, int nrhs,
                  int batch, double alpha, cudaStream_t stream) {
  const int nt = cp <= 8 ? 64 : (cp <= 32 ? 128 : 256);
  int kc = 32768 / (cp * (int)sizeof(T));
  kc = kc < 1 ? 1 : (kc > nrhs ? nrhs : kc);
  mv_kernel<T><<<dim3((unsigned)B, batch), nt, (cp * kc + nt) * sizeof(T),
                 stream>>>(
      static_cast<const T*>(data), data_bstride, static_cast<const T*>(x),
      x_bstride, static_cast<T*>(out), out_bstride, static_cast<T*>(y),
      y_bstride, y_base, off, rows, cols, vec_off, below_idx, order, cp, rp,
      nrhs, kc, (T)alpha);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const void* data, int64_t data_bstride, const void* x,
                int64_t x_bstride, void* out, int64_t out_bstride, void* y,
                int64_t y_bstride, int64_t y_base, void* p1, void* p2,
                const int64_t* off, const int64_t* rows, const int64_t* cols,
                const int64_t* vec_off, const int64_t* below_idx,
                int64_t order, int64_t B, int cp, int rp, int nrhs, int batch,
                double alpha, cudaStream_t stream) {
  const int nblk = cp / kTB;
  const T* d = static_cast<const T*>(data);
  const T* xx = static_cast<const T*>(x);
  wide_mv_tile_kernel<T><<<dim3(nblk * (nblk + 1) / 2, (unsigned)B, batch),
                           2 * kTB, 0, stream>>>(
      d, data_bstride, xx, x_bstride, static_cast<T*>(p1),
      static_cast<T*>(p2), off, cols, vec_off, cp, nrhs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wide_mv_post_kernel<T><<<dim3((cp + rp + kWarps - 1) / kWarps,
                                (unsigned)B, batch),
                           32 * kWarps, 0, stream>>>(
      d, data_bstride, xx, x_bstride, static_cast<T*>(out), out_bstride,
      static_cast<T*>(y), y_bstride, y_base, static_cast<const T*>(p1),
      static_cast<const T*>(p2), off, rows, cols, vec_off, below_idx, order,
      cp, rp, nrhs, (T)alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. Each returns the cudaError_t of its
// launches.
extern "C" int bs_add_mv(int dtype, const void* data, int64_t data_bstride,
                         const void* x, int64_t x_bstride, void* out,
                         int64_t out_bstride, void* y, int64_t y_bstride,
                         int64_t y_base, const int64_t* off,
                         const int64_t* rows, const int64_t* cols,
                         const int64_t* vec_off, const int64_t* below_idx,
                         int64_t order, int64_t B, int cp, int rp, int nrhs,
                         int batch, double alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_narrow<float>(data, data_bstride, x, x_bstride, out,
                                out_bstride, y, y_bstride, y_base, off, rows,
                                cols, vec_off, below_idx, order, B, cp, rp,
                                nrhs, batch, alpha, s);
  if (dtype == 1)
    return launch_narrow<double>(data, data_bstride, x, x_bstride, out,
                                 out_bstride, y, y_bstride, y_base, off, rows,
                                 cols, vec_off, below_idx, order, B, cp, rp,
                                 nrhs, batch, alpha, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bs_wide_add_mv(int dtype, const void* data,
                              int64_t data_bstride, const void* x,
                              int64_t x_bstride, void* out,
                              int64_t out_bstride, void* y, int64_t y_bstride,
                              int64_t y_base, void* p1, void* p2,
                              const int64_t* off, const int64_t* rows,
                              const int64_t* cols, const int64_t* vec_off,
                              const int64_t* below_idx, int64_t order,
                              int64_t B, int cp, int rp, int nrhs, int batch,
                              double alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_wide<float>(data, data_bstride, x, x_bstride, out,
                              out_bstride, y, y_bstride, y_base, p1, p2, off,
                              rows, cols, vec_off, below_idx, order, B, cp,
                              rp, nrhs, batch, alpha, s);
  if (dtype == 1)
    return launch_wide<double>(data, data_bstride, x, x_bstride, out,
                               out_bstride, y, y_bstride, y_base, p1, p2, off,
                               rows, cols, vec_off, below_idx, order, B, cp,
                               rp, nrhs, batch, alpha, s);
  return (int)cudaErrorInvalidValue;
}
