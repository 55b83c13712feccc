// K6 grad_hess: deterministic gradient / Hessian assembly of one factor
// family of the LM optimizer.
//
// Replaces Optimizer._accumulate_family
// (baspacho_tpu/optimizer/optimizer.py:334-363, driven by _grad_hess_impl
// :365-407): per factor f, g_k += J_k^T r into grad[vec_off_k + i] and
// H_kl += J_k^T J_l into the coalesced Hessian buffer at off + i*stride + j
// (off + j*stride + i where the block is stored transposed, `flip`). The
// JAX package materialises every per-factor product (2.64M x 81 values on
// BAL 871) and scatter-adds it; here the products are formed on the fly
// inside a segmented reduction, without atomics.
//
//   W   (F, rdim, TDW)  the family's weighted Jacobians of every live slot
//                       side by side, then the weighted residual as the
//                       last column: W[f, q, a + i] = sqrt(w_f) J_k[f, q, i]
//
// The host (ops/assembly.py) sorts every (pair, factor) contribution by
// its destination block once per optimizer: segment s is one block of
// rows[s] x cols[s] elements at out[off[s] + r * stride[s] + c]; its
// records rec[seg_ptr[s] .. seg_ptr[s+1]) are f * Q + q, in factor order,
// where q names the two column offsets (tab_a[q], tab_b[q]) into W, so
//
//   out[off + r * stride + c] += sum_records sum_q W[f, q, tab_a + r]
//                                                  * W[f, q, tab_b + c]
//
// The gradient is the same reduction with cols 1 and tab_b the residual
// column. Every element is owned by one thread, which adds its records in
// segment order to the value it read, and writes once: bitwise the same
// from run to run. Products accumulate in the output type, as the JAX
// einsums' preferred_element_type does.
//
// Two kernels share the work. gh_warp_kernel: one warp per short segment
// (at most LONG_SEG records: point blocks, point-camera blocks), lanes
// over the block's elements. gh_block_kernel: one CTA per long segment
// (camera blocks, ~3,000 records on BAL 871); the CTA stages `chunk`
// records' Jacobian columns in shared memory (coalesced, many loads in
// flight), and G = 256 / (rows * cols) thread groups sum interleaved
// records, combined in group order at the end. Bound by device memory:
// W read once per destination block it feeds, the CSR, one read and one
// write of each touched output element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP_THREADS = 256;   // 8 warps, one short segment each
constexpr int BLOCK_THREADS = 256;  // one long segment

template <typename T>
__global__ void gh_warp_kernel(const T* __restrict__ W, int64_t tdw,
                               int rdim, T* out,
                               const int64_t* __restrict__ seg_list,
                               int64_t n_list,
                               const int64_t* __restrict__ seg_off,
                               const int64_t* __restrict__ seg_stride,
                               const int64_t* __restrict__ seg_rows,
                               const int64_t* __restrict__ seg_cols,
                               const int64_t* __restrict__ seg_ptr,
                               const int64_t* __restrict__ rec,
                               const int64_t* __restrict__ tab_a,
                               const int64_t* __restrict__ tab_b,
                               int64_t Q) {
  const int64_t w =
      (int64_t)blockIdx.x * (WARP_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= n_list) return;
  const int64_t s = seg_list[w];
  const int R = (int)seg_rows[s], C = (int)seg_cols[s];
  const int64_t off = seg_off[s], stride = seg_stride[s];
  const int64_t p0 = seg_ptr[s], p1 = seg_ptr[s + 1];
  for (int e = lane; e < R * C; e += 32) {
    const int r = e / C, c = e % C;
    const int64_t dst = off + r * stride + c;
    T acc = out[dst];
    for (int64_t p = p0; p < p1; ++p) {
      const int64_t v = rec[p];
      const int64_t f = v / Q, q = v - f * Q;
      const T* wf = W + f * rdim * tdw;
      const int64_t a = tab_a[q] + r, b = tab_b[q] + c;
      T sum = T(0);
      for (int k = 0; k < rdim; ++k) sum += wf[k * tdw + a] * wf[k * tdw + b];
      acc += sum;
    }
    out[dst] = acc;
  }
}

template <typename T>
__global__ void gh_block_kernel(const T* __restrict__ W, int64_t tdw,
                                int rdim, T* out,
                                const int64_t* __restrict__ seg_list,
                                int chunk,
                                const int64_t* __restrict__ seg_off,
                                const int64_t* __restrict__ seg_stride,
                                const int64_t* __restrict__ seg_rows,
                                const int64_t* __restrict__ seg_cols,
                                const int64_t* __restrict__ seg_ptr,
                                const int64_t* __restrict__ rec,
                                const int64_t* __restrict__ tab_a,
                                const int64_t* __restrict__ tab_b,
                                int64_t Q) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = BLOCK_THREADS;
  const int64_t s = seg_list[blockIdx.x];
  const int R = (int)seg_rows[s], C = (int)seg_cols[s], E = R * C;
  const int64_t off = seg_off[s], stride = seg_stride[s];
  const int64_t pb = seg_ptr[s], pe = seg_ptr[s + 1];
  const int RC = R + C, per = rdim * RC;  // staged values per record
  T* stA = sm;                            // [chunk][rdim][R]
  T* stB = sm + (int64_t)chunk * rdim * R;  // [chunk][rdim][C]
  T* part = sm + (int64_t)chunk * per;    // [nt] partial sums
  const int ET = E < nt ? E : nt;  // elements per tile
  const int G = nt / ET;           // record groups per tile
  for (int e0 = 0; e0 < E; e0 += ET) {
    const int g = tid / ET, e = e0 + tid % ET;
    const bool live = g < G && e < E;
    const int r = live ? e / C : 0, c = live ? e % C : 0;
    T acc = T(0);
    for (int64_t c0 = pb; c0 < pe; c0 += chunk) {
      const int n = (int)((pe - c0) < chunk ? (pe - c0) : chunk);
      __syncthreads();  // the previous chunk has been consumed
      for (int i = tid; i < n * per; i += nt) {
        const int j = i / per, rem = i - j * per;
        const int k = rem / RC, col = rem - k * RC;
        const int64_t v = rec[c0 + j];
        const int64_t f = v / Q, q = v - f * Q;
        const T* row = W + (f * rdim + k) * tdw;
        if (col < R)
          stA[(j * rdim + k) * R + col] = row[tab_a[q] + col];
        else
          stB[(j * rdim + k) * C + (col - R)] = row[tab_b[q] + (col - R)];
      }
      __syncthreads();
      if (live) {
        for (int j = g; j < n; j += G) {
          T sum = T(0);
          for (int k = 0; k < rdim; ++k)
            sum += stA[(j * rdim + k) * R + r] * stB[(j * rdim + k) * C + c];
          acc += sum;
        }
      }
    }
    __syncthreads();
    part[tid] = acc;
    __syncthreads();
    if (tid < ET && e0 + tid < E) {
      const int ee = e0 + tid;
      const int64_t dst = off + (ee / C) * stride + (ee % C);
      T tot = out[dst];
      for (int gg = 0; gg < G; ++gg) tot += part[gg * ET + tid];
      out[dst] = tot;
    }
  }
}

template <typename T>
int launch(const void* W, int64_t tdw, int rdim, void* out,
           const int64_t* seg_list, int64_t n_list, int long_mode, int chunk,
           int max_rc, const int64_t* seg_off, const int64_t* seg_stride,
           const int64_t* seg_rows, const int64_t* seg_cols,
           const int64_t* seg_ptr, const int64_t* rec, const int64_t* tab_a,
           const int64_t* tab_b, int64_t Q, cudaStream_t stream) {
  if (n_list <= 0) return 0;
  if (!long_mode) {
    const int64_t per_block = WARP_THREADS / 32;
    const int64_t blocks = (n_list + per_block - 1) / per_block;
    gh_warp_kernel<T><<<(unsigned)blocks, WARP_THREADS, 0, stream>>>(
        static_cast<const T*>(W), tdw, rdim, static_cast<T*>(out), seg_list,
        n_list, seg_off, seg_stride, seg_rows, seg_cols, seg_ptr, rec, tab_a,
        tab_b, Q);
  } else {
    const size_t smem =
        ((size_t)chunk * rdim * max_rc + BLOCK_THREADS) * sizeof(T);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    gh_block_kernel<T><<<(unsigned)n_list, BLOCK_THREADS, smem, stream>>>(
        static_cast<const T*>(W), tdw, rdim, static_cast<T*>(out), seg_list,
        chunk, seg_off, seg_stride, seg_rows, seg_cols, seg_ptr, rec, tab_a,
        tab_b, Q);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. long_mode 0: warp per segment of seg_list;
// 1: CTA per segment, `chunk` records staged at a time, max_rc the largest
// rows + cols among the listed segments. Returns the cudaError_t of the
// launch.
extern "C" int bs_grad_hess(int dtype, const void* W, int64_t tdw, int rdim,
                            void* out, const int64_t* seg_list,
                            int64_t n_list, int long_mode, int chunk,
                            int max_rc, const int64_t* seg_off,
                            const int64_t* seg_stride,
                            const int64_t* seg_rows,
                            const int64_t* seg_cols, const int64_t* seg_ptr,
                            const int64_t* rec, const int64_t* tab_a,
                            const int64_t* tab_b, int64_t Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(W, tdw, rdim, out, seg_list, n_list, long_mode,
                         chunk, max_rc, seg_off, seg_stride, seg_rows,
                         seg_cols, seg_ptr, rec, tab_a, tab_b, Q, s);
  if (dtype == 1)
    return launch<double>(W, tdw, rdim, out, seg_list, n_list, long_mode,
                          chunk, max_rc, seg_off, seg_stride, seg_rows,
                          seg_cols, seg_ptr, rec, tab_a, tab_b, Q, s);
  return (int)cudaErrorInvalidValue;
}
