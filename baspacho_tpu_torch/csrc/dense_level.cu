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
// built by one-hot GEMMs or W W^T, 2 R^2 Kp flops when the origins' rows
// are spread), and it needs no product buffer.
//
// One CTA per (touched span b, tile of compact rows, batch item) owns
// the target column block of b: rows of every touched span a >= b
// (compact rows [cs_b, R), tiled by rt rows in shared memory), columns
// of b. It walks the origins whose below rows hold b (list entries, in
// origin order), kGroup at a time: the group's products x[tail rows] .
// x[b rows]^T, spread over all threads, are computed together into
// registers, then added into the shared accumulator entry by entry with
// a barrier between entries, so every element is summed in one fixed
// order (origin order, but for groups larger than one round), one
// thread at a time: no atomics, bitwise reproducible. Then it subtracts the accumulator into
// the target slices (chain (a, lump of b) of the target panel, found by
// binary search among b's slices). The CTAs' targets are disjoint.
//
// Work: the level's true product volume (sum over origins and spans b of
// tail rows x |b| x width), about 5e8 multiply-adds on the 50,000-origin
// Schur level. Bound by latency: one round trip to device memory per
// group of kGroup list entries (the next group's entries are read
// meanwhile) and one barrier per entry, hidden across the CTAs on an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemBudget = 96 * 1024;  // accumulator bytes per CTA
constexpr int kGroup = 16;    // list entries whose products overlap
constexpr int kSlots = 2;     // products per thread and round
constexpr int kThreads = 512;

__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t lo,
                                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void dense_level_kernel(
    T* data, int64_t bstride, const int64_t* list_ptr, const int64_t* ent_x,
    const int64_t* ent_row, const int64_t* ent_nrow, const int64_t* ent_ld,
    const int64_t* ent_n, const int64_t* crow, const int64_t* sp_cs,
    const int64_t* sp_size, const int64_t* sp_ld, const int64_t* slice_ptr,
    const int64_t* sl_cs, const int64_t* sl_size, const int64_t* sl_off,
    int64_t R, int rt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  // per list entry of a group (double-buffered: the next group's entries
  // are read while the current group is summed): first tail row in crow,
  // offsets of the tail's first row and of span b's first row, the
  // origin's row stride and width, the count of products
  __shared__ int64_t m_row[2][kGroup], m_xa[2][kGroup], m_xb[2][kGroup];
  __shared__ int m_ld[2][kGroup], m_n[2][kGroup], m_cnt[2][kGroup];
  const int64_t s = blockIdx.x;
  const int sb = (int)sp_size[s];
  const int64_t lo = sp_cs[s] + (int64_t)blockIdx.y * rt;
  if (lo >= R) return;  // uniform over the CTA
  const int64_t hi = lo + rt < R ? lo + rt : R;
  const bool whole = blockIdx.y == 0 && hi == R;  // every tail row is ours
  const int nacc = (int)(hi - lo) * sb;
  T* D = data + (int64_t)blockIdx.z * bstride;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int t = tid; t < nacc; t += nt) acc[t] = T(0);

  // the entry's tail rows inside [lo, hi): read into registers, stored
  // to the buffer after the current group is summed
  struct Meta { int64_t row, xa, xb; int ld, n, cnt; };
  auto fetch = [&](int64_t e) {
    const int64_t r0 = ent_row[e], ld = ent_ld[e], x = ent_x[e];
    int64_t a = r0, z = r0 + ent_nrow[e];
    if (!whole) {  // crow ascends along an origin's rows
      a = lower_bound(crow, a, z, lo);
      z = lower_bound(crow, a, z, hi);
    }
    return Meta{a, x + (a - r0) * ld, x, (int)ld, (int)ent_n[e],
                (int)(z - a) * sb};
  };
  auto store = [&](const Meta& m, int buf, int j) {
    m_row[buf][j] = m.row;
    m_xa[buf][j] = m.xa;
    m_xb[buf][j] = m.xb;
    m_ld[buf][j] = m.ld;
    m_n[buf][j] = m.n;
    m_cnt[buf][j] = m.cnt;
  };
  const int64_t e_beg = list_ptr[s], e_end = list_ptr[s + 1];
  if (tid < kGroup && e_beg + tid < e_end) store(fetch(e_beg + tid), 0, tid);
  __syncthreads();
  for (int64_t e0 = e_beg; e0 < e_end; e0 += kGroup) {
    const int buf = (int)((e0 - e_beg) / kGroup) & 1;
    const int ng = e_end - e0 < kGroup ? (int)(e_end - e0) : kGroup;
    const bool ahead = tid < kGroup && e0 + kGroup + tid < e_end;
    Meta next{};
    if (ahead) next = fetch(e0 + kGroup + tid);
    // the group's products, concatenated entry by entry, are spread
    // over all the threads (kSlots each per round), so their memory round
    // trips overlap; then they are added entry by entry, a barrier
    // between entries
    int pref[kGroup + 1];
    pref[0] = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      pref[j + 1] = pref[j] + (j < ng ? m_cnt[buf][j] : 0);
    for (int base = 0; base < pref[kGroup]; base += kSlots * nt) {
      T val[kSlots];
      int idx[kSlots], ent[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int p = base + q * nt + tid;
        ent[q] = -1;
        if (p < pref[kGroup]) {
          int j = 0;
#pragma unroll
          for (int jj = 1; jj < kGroup; ++jj) j += p >= pref[jj];
          const int t = p - pref[j], i = t / sb, c = t % sb;
          const int64_t ld = m_ld[buf][j];
          const T* xr = D + m_xa[buf][j] + i * ld;
          const T* xc = D + m_xb[buf][j] + c * ld;
          T dot = T(0);
          for (int k = 0; k < m_n[buf][j]; ++k) dot += xr[k] * xc[k];
          val[q] = dot;
          idx[q] = (int)(crow[m_row[buf][j] + i] - lo) * sb + c;
          ent[q] = j;
        }
      }
      for (int j = 0; j < ng; ++j) {
#pragma unroll
        for (int q = 0; q < kSlots; ++q)
          if (ent[q] == j) acc[idx[q]] += val[q];
        __syncthreads();
      }
    }
    if (ahead) store(next, buf ^ 1, tid);
    __syncthreads();  // the next group's entries are in place
  }

  const int64_t q0 = slice_ptr[s], q1 = slice_ptr[s + 1], ldt = sp_ld[s];
  for (int t = tid; t < nacc; t += nt) {
    const int64_t rr = lo + t / sb;
    const int c = t % sb;
    int64_t ql = q0, qh = q1;  // last slice starting at or before rr
    while (ql < qh) {
      const int64_t mid = (ql + qh) >> 1;
      if (sl_cs[mid] <= rr) ql = mid + 1; else qh = mid;
    }
    const int64_t q = ql - 1;
    if (q >= q0 && rr < sl_cs[q] + sl_size[q])
      D[sl_off[q] + (rr - sl_cs[q]) * ldt + c] -= acc[t];
  }
}

template <typename T>
int launch(void* data, int64_t bstride, const int64_t* list_ptr,
           const int64_t* ent_x, const int64_t* ent_row,
           const int64_t* ent_nrow, const int64_t* ent_ld,
           const int64_t* ent_n, const int64_t* crow, const int64_t* sp_cs,
           const int64_t* sp_size, const int64_t* sp_ld,
           const int64_t* slice_ptr, const int64_t* sl_cs,
           const int64_t* sl_size, const int64_t* sl_off, int64_t S,
           int64_t R, int max_span, int batch, cudaStream_t stream) {
  int64_t rt = kSmemBudget / ((int64_t)max_span * (int64_t)sizeof(T));
  if (rt < 1) rt = 1;
  if (rt > R) rt = R;
  const int64_t tiles = (R + rt - 1) / rt;
  const size_t smem = (size_t)rt * max_span * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      dense_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dense_level_kernel<T><<<dim3((unsigned)S, (unsigned)tiles, batch),
                          kThreads, smem, stream>>>(
      static_cast<T*>(data), bstride, list_ptr, ent_x, ent_row, ent_nrow,
      ent_ld, ent_n, crow, sp_cs, sp_size, sp_ld, slice_ptr, sl_cs, sl_size,
      sl_off, R, (int)rt);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. Returns the cudaError_t of the launch.
extern "C" int bs_dense_update(
    int dtype, void* data, int64_t bstride, const int64_t* list_ptr,
    const int64_t* ent_x, const int64_t* ent_row, const int64_t* ent_nrow,
    const int64_t* ent_ld, const int64_t* ent_n, const int64_t* crow,
    const int64_t* sp_cs, const int64_t* sp_size, const int64_t* sp_ld,
    const int64_t* slice_ptr, const int64_t* sl_cs, const int64_t* sl_size,
    const int64_t* sl_off, int64_t S, int64_t R, int max_span, int batch,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(data, bstride, list_ptr, ent_x, ent_row, ent_nrow,
                         ent_ld, ent_n, crow, sp_cs, sp_size, sp_ld,
                         slice_ptr, sl_cs, sl_size, sl_off, S, R, max_span,
                         batch, s);
  if (dtype == 1)
    return launch<double>(data, bstride, list_ptr, ent_x, ent_row, ent_nrow,
                          ent_ld, ent_n, crow, sp_cs, sp_size, sp_ld,
                          slice_ptr, sl_cs, sl_size, sl_off, S, R, max_span,
                          batch, s);
  return (int)cudaErrorInvalidValue;
}
