// K3 bucket_solve: stored-inverse diagonal solve of one bucket.
//
// Replaces PlannedBackend._diag_solve with use_inv=True
// (baspacho_tpu/ops/planned_backend.py:2134) and _tri_stored (:2118),
// as driven level by level by make_solve (:2383).
//
// Each panel's diag block holds L on and below the diagonal and Linv^T
// strictly above (written by bucket_factor); Linv is rebuilt on the fly
// from the strict upper and 1 / diag. With n = cols[i], the RHS rows of
// the panel are vec_off[i] .. vec_off[i] + n - 1 of vv (order x nrhs,
// row-major, one block per batch item).
//   L mode:  x = Linv . vv[rows]; vv[rows] = x;
//            y[y_base + i * rp * nrhs ..] = below . x  (rp x nrhs; the
//            segmented-subtract kernel then applies vv[bidx] -= y)
//   Lt mode: x = vv[rows] - below^T . vv[bidx]  (skipping rows whose
//            index is the sentinel `order`), vv[rows] = Linv^T . x
// Panels of one level touch disjoint RHS rows, and their below rows
// belong to later levels, so the CTAs of one launch never race.
//
// One CTA per (panel, batch item). The RHS columns are processed in
// chunks of kc columns staged in shared memory (2 * cp * kc values).
// Bound by latency on the short per-level chains: a level is a handful
// of small launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void solve_l_kernel(const T* data, int64_t data_bstride, T* vv,
                               int64_t vv_bstride, T* y, int64_t y_bstride,
                               int64_t y_base, const int64_t* off,
                               const int64_t* rows, const int64_t* cols,
                               const int64_t* vec_off, int cp, int rp,
                               int nrhs, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  T* sx = sb + (int64_t)cp * kc;
  const int64_t i = blockIdx.x;
  const T* P = data + (int64_t)blockIdx.y * data_bstride + off[i];
  const T* below = P + (int64_t)cp * cp;
  T* v = vv + (int64_t)blockIdx.y * vv_bstride;
  const int n = (int)cols[i], nrows = (int)rows[i];
  const int64_t v0 = vec_off[i], ld = cp;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k0 = 0; k0 < nrhs; k0 += kc) {
    const int w = min(kc, nrhs - k0);
    for (int t = tid; t < n * w; t += nt) {
      const int j = t / w, k = t % w;
      sb[t] = v[(v0 + j) * nrhs + k0 + k];
    }
    __syncthreads();
    // x[j] = sum_{m <= j} Linv[j][m] b[m]; Linv[j][m] = P[m * cp + j]
    for (int t = tid; t < n * w; t += nt) {
      const int j = t / w, k = t % w;
      T acc = sb[t] / P[j * ld + j];
      for (int m = 0; m < j; ++m) acc += P[m * ld + j] * sb[m * w + k];
      sx[t] = acc;
      v[(v0 + j) * nrhs + k0 + k] = acc;
    }
    __syncthreads();
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
        yo[(int64_t)r * nrhs + k0 + k] = acc;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void solve_lt_kernel(const T* data, int64_t data_bstride, T* vv,
                                int64_t vv_bstride, const int64_t* off,
                                const int64_t* rows, const int64_t* cols,
                                const int64_t* vec_off,
                                const int64_t* below_idx, int64_t order,
                                int cp, int rp, int nrhs, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
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
    // x[j] = b[j] - sum_r below[r][j] vv[bidx[r]]
    for (int t = tid; t < n * w; t += nt) {
      const int j = t / w, k = t % w;
      T acc = v[(v0 + j) * nrhs + k0 + k];
      for (int r = 0; r < nrows; ++r) {
        const int64_t q = bidx[r];
        if (q != order) acc -= below[r * ld + j] * v[q * nrhs + k0 + k];
      }
      sb[t] = acc;
    }
    __syncthreads();
    // z[j] = sum_{m >= j} Linv[m][j] x[m]; Linv[m][j] = P[j * cp + m]
    for (int t = tid; t < n * w; t += nt) {
      const int j = t / w, k = t % w;
      T acc = sb[t] / P[j * ld + j];
      for (int m = j + 1; m < n; ++m) acc += P[j * ld + m] * sb[m * w + k];
      v[(v0 + j) * nrhs + k0 + k] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(int transpose, const void* data, int64_t data_bstride, void* vv,
           int64_t vv_bstride, void* y, int64_t y_bstride, int64_t y_base,
           const int64_t* off, const int64_t* rows, const int64_t* cols,
           const int64_t* vec_off, const int64_t* below_idx, int64_t order,
           int64_t B, int cp, int rp, int nrhs, int batch,
           cudaStream_t stream) {
  const int nt = cp <= 8 ? 64 : (cp <= 32 ? 128 : 256);
  int kc = 32768 / (2 * cp * (int)sizeof(T));
  kc = kc < 1 ? 1 : (kc > nrhs ? nrhs : kc);
  const dim3 grid((unsigned)B, batch);
  const T* d = static_cast<const T*>(data);
  if (!transpose) {
    solve_l_kernel<T><<<grid, nt, 2 * cp * kc * sizeof(T), stream>>>(
        d, data_bstride, static_cast<T*>(vv), vv_bstride,
        static_cast<T*>(y), y_bstride, y_base, off, rows, cols, vec_off, cp,
        rp, nrhs, kc);
  } else {
    solve_lt_kernel<T><<<grid, nt, cp * kc * sizeof(T), stream>>>(
        d, data_bstride, static_cast<T*>(vv), vv_bstride, off, rows, cols,
        vec_off, below_idx, order, cp, rp, nrhs, kc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64; transpose: 0 L pass, 1 Lt pass.
// Returns the cudaError_t of the launch.
extern "C" int bs_bucket_solve(int dtype, int transpose, const void* data,
                               int64_t data_bstride, void* vv,
                               int64_t vv_bstride, void* y, int64_t y_bstride,
                               int64_t y_base, const int64_t* off,
                               const int64_t* rows, const int64_t* cols,
                               const int64_t* vec_off,
                               const int64_t* below_idx, int64_t order,
                               int64_t B, int cp, int rp, int nrhs,
                               int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(transpose, data, data_bstride, vv, vv_bstride, y,
                         y_bstride, y_base, off, rows, cols, vec_off,
                         below_idx, order, B, cp, rp, nrhs, batch, s);
  if (dtype == 1)
    return launch<double>(transpose, data, data_bstride, vv, vv_bstride, y,
                          y_bstride, y_base, off, rows, cols, vec_off,
                          below_idx, order, B, cp, rp, nrhs, batch, s);
  return (int)cudaErrorInvalidValue;
}
