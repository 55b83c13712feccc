// K3-wide wide_solve: stored-inverse diagonal solve of a bucket of wide
// panels (padded width cp > 512).
//
// Replaces PlannedBackend._diag_solve with use_inv=True and _tri_stored
// (baspacho_tpu/ops/planned_backend.py:2134, :2118) for wide buckets, as
// driven level by level by make_solve (:2383). The arguments, layout and
// result are bucket_solve's (bucket_solve.cu): Linv is rebuilt on the fly
// from the stored strict upper (Linv^T) and 1 / diag, never materialised.
//
// A wide level holds one or a few panels, so one CTA per panel would run
// on a single SM. Each pass is two launches over row blocks instead, with
// a (batch, B, cp, nrhs) scratch `tmp` between them (a pass reads the RHS
// rows it overwrites):
//   L pass   lmv    tmp[j] = Linv[j, :j+1] . vv[rows]: 64 rows per CTA,
//                   four interleaved partial sums per row, added in a
//                   fixed order (coalesced reads of the stored columns);
//            lpost  vv[rows] = tmp, y[r] = below[r] . tmp: one warp per
//                   row, lanes over columns, a butterfly reduction;
//   Lt pass  ltpre  tmp[j] = vv[rows][j] - sum_r below[r][j] vv[bidx[r]]:
//                   one thread per column, rows in order;
//            ltmv   vv[rows][j] = Linv[:, j] . tmp: one warp per row of the
//                   stored upper (contiguous), a butterfly reduction.
// Every sum has a fixed order, so reruns agree bitwise. Bound by reading
// the stored block (cp^2 / 2 values per pass and RHS column) from device
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLmvRows = 64;  // rows per CTA of lmv (x 4 partial sums)
constexpr int kWarps = 8;     // warps (rows) per CTA of lpost and ltmv

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void wide_lmv_kernel(const T* data, int64_t data_bstride,
                                const T* vv, int64_t vv_bstride, T* tmp,
                                const int64_t* off, const int64_t* cols,
                                const int64_t* vec_off, int cp, int nrhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);  // one RHS column, cp values
  T* red = sb + cp;                         // 4 x kLmvRows partial sums
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const T* P = data + (int64_t)blockIdx.z * data_bstride + off[i];
  const T* v = vv + (int64_t)blockIdx.z * vv_bstride;
  T* out = tmp + ((int64_t)blockIdx.z * B + i) * ld * nrhs;
  const int n = (int)cols[i];
  const int64_t v0 = vec_off[i];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int jl = tid % kLmvRows, part = tid / kLmvRows;
  const int j = blockIdx.x * kLmvRows + jl;
  for (int k = 0; k < nrhs; ++k) {
    for (int m = tid; m < n; m += nt) sb[m] = v[(v0 + m) * nrhs + k];
    __syncthreads();
    T acc = T(0);
    if (j < n)
      for (int m = part; m < j; m += 4) acc += P[m * ld + j] * sb[m];
    red[part * kLmvRows + jl] = acc;
    __syncthreads();
    if (part == 0 && j < n)
      out[(int64_t)j * nrhs + k] =
          ((red[jl] + red[kLmvRows + jl]) + red[2 * kLmvRows + jl]) +
          red[3 * kLmvRows + jl] + sb[j] / P[j * ld + j];
    __syncthreads();
  }
}

template <typename T>
__global__ void wide_lpost_kernel(const T* data, int64_t data_bstride, T* vv,
                                  int64_t vv_bstride, T* y, int64_t y_bstride,
                                  int64_t y_base, const T* tmp,
                                  const int64_t* off, const int64_t* rows,
                                  const int64_t* cols,
                                  const int64_t* vec_off, int cp, int rp,
                                  int nrhs) {
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = (int)cols[i];
  const T* x = tmp + ((int64_t)blockIdx.z * B + i) * ld * nrhs;
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
__global__ void wide_ltpre_kernel(const T* data, int64_t data_bstride,
                                  const T* vv, int64_t vv_bstride, T* tmp,
                                  const int64_t* off, const int64_t* rows,
                                  const int64_t* cols, const int64_t* vec_off,
                                  const int64_t* below_idx, int64_t order,
                                  int cp, int rp, int nrhs) {
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (int)cols[i]) return;
  const T* below = data + (int64_t)blockIdx.z * data_bstride + off[i] +
                   ld * ld;
  const T* v = vv + (int64_t)blockIdx.z * vv_bstride;
  const int64_t* bidx = below_idx + i * rp;
  T* out = tmp + ((int64_t)blockIdx.z * B + i) * ld * nrhs;
  const int nrows = rp > 0 ? (int)rows[i] : 0;
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

template <typename T>
__global__ void wide_ltmv_kernel(const T* data, int64_t data_bstride, T* vv,
                                 int64_t vv_bstride, const T* tmp,
                                 const int64_t* off, const int64_t* cols,
                                 const int64_t* vec_off, int cp, int nrhs) {
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = (int)cols[i];
  if (j >= n) return;
  // z[j] = sum_{m >= j} Linv[m][j] t[m]; Linv[m][j] = P[j][m] for m > j
  const T* row = data + (int64_t)blockIdx.z * data_bstride + off[i] + j * ld;
  const T* t = tmp + ((int64_t)blockIdx.z * B + i) * ld * nrhs;
  T* v = vv + (int64_t)blockIdx.z * vv_bstride + (vec_off[i] + j) * nrhs;
  for (int k = 0; k < nrhs; ++k) {
    T acc = T(0);
    for (int m = j + 1 + lane; m < n; m += 32)
      acc += row[m] * t[(int64_t)m * nrhs + k];
    acc = warp_sum(acc);
    if (lane == 0) v[k] = acc + t[(int64_t)j * nrhs + k] / row[j];
  }
}

template <typename T>
int launch(int transpose, const void* data, int64_t data_bstride, void* vv,
           int64_t vv_bstride, void* y, int64_t y_bstride, int64_t y_base,
           void* tmp, const int64_t* off, const int64_t* rows,
           const int64_t* cols, const int64_t* vec_off,
           const int64_t* below_idx, int64_t order, int64_t B, int cp, int rp,
           int nrhs, int batch, cudaStream_t stream) {
  const T* d = static_cast<const T*>(data);
  T* v = static_cast<T*>(vv);
  T* t = static_cast<T*>(tmp);
  const unsigned nb = (unsigned)B;
  if (!transpose) {
    const size_t smem = (cp + 4 * kLmvRows) * sizeof(T);
    wide_lmv_kernel<T><<<dim3((cp + kLmvRows - 1) / kLmvRows, nb, batch),
                         4 * kLmvRows, smem, stream>>>(
        d, data_bstride, v, vv_bstride, t, off, cols, vec_off, cp, nrhs);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    wide_lpost_kernel<T><<<dim3((cp + rp + kWarps - 1) / kWarps, nb, batch),
                           32 * kWarps, 0, stream>>>(
        d, data_bstride, v, vv_bstride, static_cast<T*>(y), y_bstride, y_base,
        t, off, rows, cols, vec_off, cp, rp, nrhs);
  } else {
    wide_ltpre_kernel<T><<<dim3((cp + 127) / 128, nb, batch), 128, 0,
                           stream>>>(d, data_bstride, v, vv_bstride, t, off,
                                     rows, cols, vec_off, below_idx, order,
                                     cp, rp, nrhs);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    wide_ltmv_kernel<T><<<dim3((cp + kWarps - 1) / kWarps, nb, batch),
                          32 * kWarps, 0, stream>>>(
        d, data_bstride, v, vv_bstride, t, off, cols, vec_off, cp, nrhs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64; transpose: 0 L pass, 1 Lt pass.
// Returns the cudaError_t of the launches.
extern "C" int bs_wide_solve(int dtype, int transpose, const void* data,
                             int64_t data_bstride, void* vv,
                             int64_t vv_bstride, void* y, int64_t y_bstride,
                             int64_t y_base, void* tmp, const int64_t* off,
                             const int64_t* rows, const int64_t* cols,
                             const int64_t* vec_off,
                             const int64_t* below_idx, int64_t order,
                             int64_t B, int cp, int rp, int nrhs, int batch,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(transpose, data, data_bstride, vv, vv_bstride, y,
                         y_bstride, y_base, tmp, off, rows, cols, vec_off,
                         below_idx, order, B, cp, rp, nrhs, batch, s);
  if (dtype == 1)
    return launch<double>(transpose, data, data_bstride, vv, vv_bstride, y,
                          y_bstride, y_base, tmp, off, rows, cols, vec_off,
                          below_idx, order, B, cp, rp, nrhs, batch, s);
  return (int)cudaErrorInvalidValue;
}
