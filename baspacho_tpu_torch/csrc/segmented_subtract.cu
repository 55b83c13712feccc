// K2 segmented_subtract: deterministic assembly.
//
// Replaces PlannedBackend._apply_pairs
// (baspacho_tpu/ops/planned_backend.py:1466), the per-level block-pair
// scatter-add of the products x . x^T into later panels (PairBucket
// descriptors :116-135), and the below-row RHS scatter of the L solve
// pass (the vv[bidx] -= below . x half of _diag_solve, :2173-2179).
//
//   out[tgt[t] * width + k] -= sum_{j in [seg_ptr[t], seg_ptr[t+1])}
//                              src[src_idx[j] * width + k]
//
// The host builds the CSR once per level: contributions sorted by
// target, stable in origin order. One thread owns one target element and
// sums its segment in that fixed order, so the result is bitwise the
// same from run to run: no atomics. width is 1 for the factor (targets
// are data elements) and nrhs for the solve (targets are RHS rows).
// Bound by device memory traffic (gathered source reads, one
// read-modify-write per target).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void seg_sub_kernel(T* out, int64_t out_bstride, const T* src,
                               int64_t src_bstride, const int64_t* tgt,
                               const int64_t* seg_ptr,
                               const int64_t* src_idx, int64_t n_tgt,
                               int64_t width) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_tgt * width) return;
  const int64_t t = g / width, k = g % width;
  const T* s = src + (int64_t)blockIdx.y * src_bstride;
  T acc = T(0);
  for (int64_t j = seg_ptr[t]; j < seg_ptr[t + 1]; ++j)
    acc += s[src_idx[j] * width + k];
  out[(int64_t)blockIdx.y * out_bstride + tgt[t] * width + k] -= acc;
}

template <typename T>
int launch(void* out, int64_t out_bstride, const void* src,
           int64_t src_bstride, const int64_t* tgt, const int64_t* seg_ptr,
           const int64_t* src_idx, int64_t n_tgt, int64_t width, int batch,
           cudaStream_t stream) {
  const int nt = 256;
  const int64_t blocks = (n_tgt * width + nt - 1) / nt;
  seg_sub_kernel<T><<<dim3((unsigned)blocks, batch), nt, 0, stream>>>(
      static_cast<T*>(out), out_bstride, static_cast<const T*>(src),
      src_bstride, tgt, seg_ptr, src_idx, n_tgt, width);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. Returns the cudaError_t of the launch.
extern "C" int bs_segmented_subtract(int dtype, void* out,
                                     int64_t out_bstride, const void* src,
                                     int64_t src_bstride, const int64_t* tgt,
                                     const int64_t* seg_ptr,
                                     const int64_t* src_idx, int64_t n_tgt,
                                     int64_t width, int batch,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(out, out_bstride, src, src_bstride, tgt, seg_ptr,
                         src_idx, n_tgt, width, batch, s);
  if (dtype == 1)
    return launch<double>(out, out_bstride, src, src_bstride, tgt, seg_ptr,
                          src_idx, n_tgt, width, batch, s);
  return (int)cudaErrorInvalidValue;
}
