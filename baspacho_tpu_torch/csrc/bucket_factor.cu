// K1 bucket_factor: batched supernode panel factor of one bucket.
//
// Replaces PlannedBackend._factor_bucket
// (baspacho_tpu/ops/planned_backend.py:1423) with its helpers
// _pad_eye, _factor_panels, _unrolled_chol, _unrolled_lower_inv,
// _lower_inv and _embed_inv (:1269-1464), for padded widths cp <= 512.
//
// Every panel is [(cp x cp) diag | (rp x cp) below], row-major with row
// stride cp, at flat offset off[i] of the data buffer. With n = cols[i]
// the real width (columns >= n are padding, held at zero), the kernel
//   * factors L = chol(diag[:n, :n]) from the lower triangle only; the
//     padded columns carry the identity in the JAX routine, which leaves
//     them zero in the stored block, so they are skipped here;
//   * stores L on and below the diagonal and Linv^T strictly above it
//     (the layout of _embed_inv);
//   * overwrites the below block with x = below . Linv^T;
//   * writes the products x . x^T, (rp x rp) per panel, into the level's
//     product buffer at prod_base + i * rp * rp (zero on padded rows),
//     unless prod is null: a dense level's update (dense_level.cu) reads
//     x from the data instead.
//
// Three kernels, launched back to back on the current stream:
//   chol_inv  one CTA per (panel, batch item): right-looking Cholesky
//             and the row-by-row inverse, in place in device memory, the
//             current column of L / row of Linv staged in shared memory
//             (~n^3/3 flops in n dependent steps; a wide panel is bound
//             by the latency of those steps on its one SM);
//   below     one CTA per (panel, chunk of below rows, batch item): the
//             chunk is staged in shared memory so the product can
//             overwrite it in place (bound by reads of the stored Linv);
//   prod      one thread per product entry (rp^2 * n flops per panel,
//             the level's bulk of work on the wide levels).
// Simple and right first: no tensor cores, no TMA, no shared-memory
// tiling of the diagonal block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void chol_inv_kernel(T* data, int64_t data_bstride,
                                const int64_t* off, const int64_t* cols,
                                int cp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* colk = reinterpret_cast<T*>(smem_raw);  // column k of L, rows > k
  T* rowk = colk + cp;                        // row k of Linv, cols <= k
  T* P = data + (int64_t)blockIdx.y * data_bstride + off[blockIdx.x];
  const int n = (int)cols[blockIdx.x];
  const int tid = threadIdx.x, nt = blockDim.x;
  // warps walk rows, lanes walk consecutive columns of a row
  const int tx = tid & 31, ty = tid >> 5, nty = nt >> 5;
  const int64_t ld = cp;

  // the strict upper triangle receives Linv^T (zero on padded columns)
  for (int r = ty; r < cp; r += nty)
    for (int c = r + 1 + tx; c < cp; c += 32) P[r * ld + c] = T(0);
  __syncthreads();

  // Cholesky of the leading n x n lower triangle, right-looking
  for (int k = 0; k < n; ++k) {
    if (tid == 0) P[k * ld + k] = sqrt(P[k * ld + k]);
    __syncthreads();
    const T d = P[k * ld + k];
    for (int r = k + 1 + tid; r < n; r += nt) {
      const T v = P[r * ld + k] / d;
      P[r * ld + k] = v;
      colk[r] = v;
    }
    __syncthreads();
    for (int r = k + 1 + ty; r < n; r += nty) {
      const T lr = colk[r];
      T* row = P + r * ld;
      for (int c = k + 1 + tx; c <= r; c += 32) row[c] -= lr * colk[c];
    }
    __syncthreads();
  }

  // X = L^-1 row by row: X[i][c] (i > c) lives at P[c * cp + i], the
  // diagonal 1 / L[k][k] is recomputed where needed.
  for (int k = 0; k < n; ++k) {
    const T dk = T(1) / P[k * ld + k];
    for (int c = tid; c < k; c += nt) {
      const T v = P[c * ld + k] * dk;
      P[c * ld + k] = v;
      rowk[c] = v;
    }
    if (tid == 0) rowk[k] = dk;
    for (int i = k + 1 + tid; i < n; i += nt) colk[i] = P[i * ld + k];
    __syncthreads();
    // X[i][c] -= L[i][k] * X[k][c] for i > k, c <= k
    for (int c = ty; c <= k; c += nty) {
      const T xc = rowk[c];
      T* row = P + c * ld;
      for (int i = k + 1 + tx; i < n; i += 32) row[i] -= colk[i] * xc;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void below_kernel(T* data, int64_t data_bstride,
                             const int64_t* off, const int64_t* rows,
                             const int64_t* cols, int cp, int rb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  T* P = data + (int64_t)blockIdx.z * data_bstride + off[blockIdx.x];
  T* below = P + (int64_t)cp * cp;
  const int n = (int)cols[blockIdx.x];
  const int r0 = blockIdx.y * rb;
  const int nr = min(rb, (int)rows[blockIdx.x] - r0);
  if (nr <= 0) return;  // uniform over the CTA
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t ld = cp;
  for (int t = tid; t < nr * n; t += nt) {
    const int r = t / n, k = t % n;
    sb[t] = below[(r0 + r) * ld + k];
  }
  __syncthreads();
  // x[r][j] = sum_{k <= j} below[r][k] * Linv[j][k]
  for (int t = tid; t < nr * n; t += nt) {
    const int r = t / n, j = t % n;
    const T* br = sb + r * n;
    T acc = br[j] / P[j * ld + j];
    for (int k = 0; k < j; ++k) acc += br[k] * P[k * ld + j];
    below[(r0 + r) * ld + j] = acc;
  }
}

template <typename T>
__global__ void prod_kernel(const T* data, int64_t data_bstride, T* prod,
                            int64_t prod_bstride, int64_t prod_base,
                            const int64_t* off, const int64_t* rows,
                            const int64_t* cols, int cp, int rp) {
  const int64_t i = blockIdx.x;
  const T* X = data + (int64_t)blockIdx.z * data_bstride + off[i] +
               (int64_t)cp * cp;
  T* out = prod + (int64_t)blockIdx.z * prod_bstride + prod_base +
           i * rp * rp;
  const int n = (int)cols[i], nrows = (int)rows[i];
  const int64_t total = (int64_t)rp * rp;
  for (int64_t e = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
       e < total; e += (int64_t)gridDim.y * blockDim.x) {
    const int r = (int)(e / rp), s = (int)(e % rp);
    T acc = T(0);
    if (r < nrows && s < nrows) {
      const T* xr = X + (int64_t)r * cp;
      const T* xs = X + (int64_t)s * cp;
      for (int k = 0; k < n; ++k) acc += xr[k] * xs[k];
    }
    out[e] = acc;
  }
}

template <typename T>
int launch(void* data, int64_t data_bstride, void* prod,
           int64_t prod_bstride, int64_t prod_base, const int64_t* off,
           const int64_t* rows, const int64_t* cols, int64_t B, int cp,
           int rp, int batch, cudaStream_t stream) {
  T* d = static_cast<T*>(data);
  // wide panels run on one SM each: as many threads as the block takes
  const int nt = cp <= 8 ? 32 : (cp <= 32 ? 128 : (cp <= 128 ? 512 : 1024));
  chol_inv_kernel<T><<<dim3((unsigned)B, batch), nt, 2 * cp * sizeof(T),
                       stream>>>(d, data_bstride, off, cols, cp);
  if (rp > 0) {
    int rb = 32768 / (cp * (int)sizeof(T));
    rb = rb < 1 ? 1 : (rb > rp ? rp : rb);
    below_kernel<T><<<dim3((unsigned)B, (rp + rb - 1) / rb, batch), 256,
                      rb * cp * sizeof(T), stream>>>(d, data_bstride, off,
                                                     rows, cols, cp, rb);
    if (prod != nullptr) {
      int64_t tiles = ((int64_t)rp * rp + 255) / 256;
      if (tiles > 65535) tiles = 65535;
      prod_kernel<T><<<dim3((unsigned)B, (unsigned)tiles, batch), 256, 0,
                       stream>>>(d, data_bstride, static_cast<T*>(prod),
                                 prod_bstride, prod_base, off, rows, cols,
                                 cp, rp);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. Returns the cudaError_t of the launches.
extern "C" int bs_bucket_factor(int dtype, void* data, int64_t data_bstride,
                                void* prod, int64_t prod_bstride,
                                int64_t prod_base, const int64_t* off,
                                const int64_t* rows, const int64_t* cols,
                                int64_t B, int cp, int rp, int batch,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(data, data_bstride, prod, prod_bstride, prod_base,
                         off, rows, cols, B, cp, rp, batch, s);
  if (dtype == 1)
    return launch<double>(data, data_bstride, prod, prod_bstride, prod_base,
                          off, rows, cols, B, cp, rp, batch, s);
  return (int)cudaErrorInvalidValue;
}
