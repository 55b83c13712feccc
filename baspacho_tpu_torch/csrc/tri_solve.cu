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
// Wide (cp > 512): the 128-wide tiles of _big_panel_solve, three launches
// per call. tri_wide_pre gathers the panel's RHS rows into a (batch, B,
// cp, nrhs) scratch xs (Lt pass: minus the below^T term) and zeroes the
// flags; tri_wide_chain solves every panel; tri_wide_post writes the
// solution back and, in the L pass, y.
//
// Bound: the lower triangle must be read once, 36 MB at cp 3072 in f64,
// ~11 us at 3.35 TB/s; the operations are as many multiply-adds. The
// earlier design ran one launch per tile step, 27 dependent
// launches per pass on the corner, 1.023 ms for an L and an Lt pass on an
// H100 (PERF.md): each step waited for the previous launch to end,
// though the bytes of L a step reads do not depend on the solution.
//
// tri_wide_chain carries the chain on the device, in one persistent
// launch. Its work items are the tiles (k, j), j <= k, of every panel and
// batch item, in row order: L pass diag 0, diag 1, (2, 0), diag 2, (3,
// 0..1), diag 3, ...; Lt pass the mirror, by columns from the last: diag
// K-1, diag K-2, (K-1, K-3), diag K-3, ... The adjacent tile (k, k-1) is
// no item of its own: diagonal item k (Lt pass: k-1) forms its product.
// In that order every item depends only on earlier items, and a diagonal
// item is claimed well before the chain reaches it. A CTA claims the
// next item by a ticket (atomicAdd on a counter); every earlier item is
// then held by a CTA that is already running, so the chain completes
// whatever number of CTAs fits on the card.
//
// An off-diagonal item starts the cp.async copy of its L tile into
// shared memory before it waits for the solution s of its source tile,
// then writes its product L[k, j] s_j (Lt: L[k, j]^T s_k) to a scratch
// slot of its own and raises its flag. A diagonal item loads its
// adjacent tile into registers and inverts its own tile before it waits
// (8 x 8 diagonal blocks by substitution, then joined pairwise by small
// products, 8 -> 16 -> ... -> 128, 4 x 4 outputs per thread, L^T held
// in the upper half of the same shared array until it is spent); then
// it subtracts its partials from its RHS rows in source order as each
// flag rises, the adjacent product last, as soon as the
// previous diagonal publishes, multiplies by the inverse and publishes
// s_k. The first diagonal of a pass, which nothing precedes, substitutes
// instead (a warp per RHS column): its inverse would lead the chain. So
// a step of the chain is one wait, one load of a 128-row solution and
// two 128-wide products from registers and shared memory; every sum has
// a fixed order, so reruns agree bitwise. A flag rises by a barrier and
// one thread's st.release, and is read by one thread's ld.acquire and a
// barrier; published vectors are read past L1 (__ldcg).

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
// minus sum_r below[r][j] vv[bidx[r]]), 0 for n <= j < cp; and the
// nflags flags of tri_wide_chain set to 0
template <typename T>
__global__ void tri_wide_pre_kernel(const T* data, int64_t data_bstride,
                                    const T* vv, int64_t vv_bstride, T* xs,
                                    int* flags, int64_t nflags,
                                    const int64_t* off, const int64_t* rows,
                                    const int64_t* cols,
                                    const int64_t* vec_off,
                                    const int64_t* below_idx, int64_t order,
                                    int cp, int rp, int nrhs, int transpose) {
  const int64_t nthreads =
      (int64_t)gridDim.x * gridDim.y * gridDim.z * blockDim.x;
  for (int64_t f = (((int64_t)blockIdx.z * gridDim.y + blockIdx.y) *
                        gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
       f < nflags; f += nthreads)
    flags[f] = 0;
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

constexpr int kNb = 128;           // tile edge of tri_wide_chain
constexpr int kLd = kNb + 1;       // row stride of its shared tile
constexpr int kQ = 4;              // threads per output of its products
constexpr int kChainThreads = kQ * kNb;
constexpr int kRc = 8;             // RHS columns staged at a time

template <typename T>
__device__ __forceinline__ void cp_async_el(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// thread 0 waits for the flag (acquire), then the whole CTA goes on (the
// barrier orders the other threads' reads after it). A wait of more than
// ~2^35 cycles (~18 s) can only be a broken chain: the kernel traps, and
// the launch reports an error, rather than hang the card.
__device__ __forceinline__ void wait_flag(const int* f) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(f) == 0) {
      if (clock64() - t0 > (1ll << 35)) __trap();
    }
  }
  __syncthreads();
}

// the CTA's writes, ordered before thread 0's release by the barrier,
// are visible to whoever acquires the flag
__device__ __forceinline__ void raise_flag(int* f) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(f, 1);
}

// sum over m in [lo, hi) of a[m * sa] b[m * sb], in four partial sums
// (independent chains of multiply-adds) added in a fixed order
template <typename T>
__device__ __forceinline__ T dot4(const T* a, int sa, const T* b, int sb,
                                  int lo, int hi) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int m = lo;
  for (; m + 3 < hi; m += 4) {
    s0 += a[m * sa] * b[m * sb];
    s1 += a[(m + 1) * sa] * b[(m + 1) * sb];
    s2 += a[(m + 2) * sa] * b[(m + 2) * sb];
    s3 += a[(m + 3) * sa] * b[(m + 3) * sb];
  }
  for (; m < hi; ++m) s0 += a[m * sa] * b[m * sb];
  return (s0 + s1) + (s2 + s3);
}

// out[t] = sum_m M(t, m) V[m][kk] over t < w_out, m < w_in, where M(t, m)
// is A[t][m] (trans 0) or A[m][t] (trans 1), A with row stride kLd; tri 1
// keeps m <= t, tri 2 m >= t. Thread (q, t) sums the q-th quarter of the
// m range, the quarters are added in order; the result is returned to
// thread t < w_out.
template <typename T>
__device__ T chain_matvec(const T* A, int trans, int tri, const T* V, int kk,
                          int w_out, int w_in, T* red) {
  const int tid = threadIdx.x, t = tid % kNb, q = tid / kNb;
  constexpr int part = kNb / kQ;
  int lo = q * part, hi = min(lo + part, w_in);
  if (tri == 1) hi = min(hi, t + 1);
  if (tri == 2) lo = max(lo, t);
  T acc = T(0);
  if (t < w_out)
    acc = trans ? dot4(A + t, kLd, V + kk, kRc, lo, hi)
                : dot4(A + t * kLd, 1, V + kk, kRc, lo, hi);
  red[q * kNb + t] = acc;
  __syncthreads();
  T tot = T(0);
  if (tid < w_out)
    for (int p = 0; p < kQ; ++p) tot += red[p * kNb + tid];
  __syncthreads();
  return tot;
}

// s = L^-1 b (Lt: L^-T b) of a staged diagonal tile (L^T strictly above
// the diagonal of S, 1 / diagonal in D) by substitution, warp kk on RHS
// column kk of V (kc <= 16 columns), lane owning rows lane + 32 i; s to
// out[r * ld + kk]
template <typename T>
__device__ void substitute(const T* S, const T* D, const T* V, T* out,
                           int ld, int w, int kc, int transpose) {
  constexpr int kR = kNb / 32;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= kc) return;
  T b[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
    b[i] = lane + 32 * i < w ? V[(lane + 32 * i) * kRc + wid] : T(0);
  if (!transpose) {
#pragma unroll
    for (int jb = 0; jb < kR; ++jb) {
      for (int jl = 0; jl < 32; ++jl) {
        const int j = jb * 32 + jl;
        if (j >= w) break;
        const T xj = __shfl_sync(0xffffffffu, b[jb] * D[j], jl);
        if (lane == jl) b[jb] = xj;
#pragma unroll
        for (int i = jb; i < kR; ++i) {
          const int r = lane + 32 * i;
          if (r > j) b[i] -= S[j * kLd + r] * xj;  // L[r][j]
        }
      }
    }
  } else {
#pragma unroll
    for (int jb = kR - 1; jb >= 0; --jb) {
      for (int jl = 31; jl >= 0; --jl) {
        const int j = jb * 32 + jl;
        if (j >= w) continue;
        const T xj = __shfl_sync(0xffffffffu, b[jb] * D[j], jl);
        if (lane == jl) b[jb] = xj;
#pragma unroll
        for (int i = 0; i <= jb; ++i) {
          const int r = lane + 32 * i;
          if (r < j) b[i] -= S[r * kLd + j] * xj;  // L[j][r]
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i)
    if (lane + 32 * i < w) out[(int64_t)(lane + 32 * i) * ld + wid] = b[i];
}

// Items in group g of the ticket order (row g of the tiles in the L pass,
// column K - 1 - g in the Lt pass): the off-diagonal tiles that feed the
// group's diagonal, but for the adjacent one, then the diagonal
__device__ __forceinline__ int chain_group(int g) { return 1 + max(0, g - 1); }

// The chain of every panel and batch item (P = batch * B problems of K =
// cp / kNb tiles), one persistent launch. Scratch: xs (P, cp, nrhs) the
// RHS from tri_wide_pre; xsol (P, cp, nrhs) the published tile
// solutions; part (P, K, K, kNb, nrhs) the partial products, slot (tgt,
// src); flags: [0] the ticket counter, then (P, K) solution flags, then
// (P, K, K) partial flags. Ticket t is item t / P of problem t % P, in
// the order of the header; items past the panel's real columns are
// skipped (no real item depends on one).
template <typename T>
__global__ void __launch_bounds__(kChainThreads)
    tri_wide_chain_kernel(const T* data, int64_t data_bstride, const T* xs,
                          T* xsol, T* part, int* flags, const int64_t* off,
                          const int64_t* cols, int B, int64_t P, int cp,
                          int nrhs, int transpose) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // kNb x kLd tile
  T* D = S + kNb * kLd;                   // the diagonal tile's diagonal
  T* V = D + kNb;                         // kNb x kRc vector chunk
  T* V2 = V + kNb * kRc;                  // the adjacent solution's chunk
  T* red = V2 + kNb * kRc;                // kQ x kNb quarter sums
  T* Tm = red + kQ * kNb;                 // kNb^2 / 4 products of the inverse
  __shared__ int ticket;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = cp / kNb;
  const int64_t total = P * (K + (int64_t)(K - 1) * (K - 2) / 2);
  for (;;) {
    if (tid == 0) ticket = atomicAdd(flags, 1);
    __syncthreads();
    const int64_t tk = ticket;
    __syncthreads();
    if (tk >= total) return;
    const int64_t p = tk % P;
    int l = (int)(tk / P), g = 0;
    while (l >= chain_group(g)) {
      l -= chain_group(g);
      ++g;
    }
    // L pass: row g, tiles (g, 0 .. g - 2), then the diagonal; Lt pass:
    // column k = K - 1 - g, tiles (K - 1 .. k + 2, k), then the diagonal
    const bool diag = l == chain_group(g) - 1;
    const int row = diag ? (transpose ? K - 1 - g : g)
                         : (transpose ? K - 1 - l : g);
    const int col = diag ? row : (transpose ? K - 1 - g : l);
    const int64_t i = p % B, z = p / B;
    const int n = (int)cols[i], Kn = (n + kNb - 1) / kNb;
    if (row >= Kn) continue;
    const T* L = data + z * data_bstride + off[i];
    const int r0 = row * kNb, c0 = col * kNb;
    const int wr = min(kNb, n - r0), wc = min(kNb, n - c0);
    const T* xp = xs + p * cp * nrhs;
    T* sp = xsol + p * cp * nrhs;
    int* sflag = flags + 1 + p * K;
    int* pflag = flags + 1 + P * K + p * K * K;
    T* pp = part + p * K * K * kNb * nrhs;

    if (row == col) {
      // the adjacent tile's product is this item's own: L[k, k-1] s_{k-1}
      // (Lt pass: L[k+1, k]^T s_{k+1}); its tile goes to registers first,
      // kNb / kQ values per thread, thread (q, t) holding M(t, m) for m
      // in its quarter
      const int w = wr, adj = transpose ? row + 1 : row - 1;
      const bool has_adj = transpose ? adj < Kn : adj >= 0;
      const int a0 = adj * kNb, wa = has_adj ? min(kNb, n - a0) : 0;
      constexpr int kPart = kNb / kQ;
      const int t = tid % kNb, q = tid / kNb;
      T lreg[kPart];
#pragma unroll
      for (int j = 0; j < kPart; ++j) {
        const int m = q * kPart + j;
        lreg[j] = (t < w && m < wa)
                      ? (transpose ? L[(int64_t)(a0 + m) * cp + r0 + t]
                                   : L[(int64_t)(r0 + t) * cp + a0 + m])
                      : T(0);
      }
      // stage the tile: L^T strictly above the diagonal, the diagonal in D;
      // identity past the tile's w real rows
      for (int e = tid; e < kNb * kNb; e += nt) {
        const int r = e / kNb, m = e % kNb;
        if (m < r) {
          if (r < w)
            cp_async_el(&S[m * kLd + r], L + (int64_t)(r0 + r) * cp + r0 + m);
          else
            S[m * kLd + r] = T(0);
        } else if (m == r) {
          if (r < w)
            cp_async_el(&D[r], L + (int64_t)(r0 + r) * cp + r0 + r);
          else
            D[r] = T(1);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // invert into the lower half: the 8 x 8 diagonal blocks by forward
      // substitution (a warp each, lane c owning column c: X[r][c] =
      // -(sum_{c <= m < r} L[r][m] X[m][c]) / L[r][r], L[r][m] = S[m][r]),
      // then pairs of inverted blocks (A, B) joined, 8 -> 16 -> ... -> 128:
      // X_BA = -X_BB (L_BA X_AA), the inner product through Tm.
      // The first diagonal of a pass (no sources) skips the inverse: its
      // solve is on the critical path before anything else, and one warp
      // per RHS column substitutes faster than the CTA inverts.
      const bool first = transpose ? row == Kn - 1 : row == 0;
      if (first) {
        for (int r = tid; r < kNb; r += nt) D[r] = T(1) / D[r];
        __syncthreads();
      } else {
        const int wid = tid / 32, lane = tid % 32;
        if (wid < kNb / 8 && lane < 8) {
          const int base = wid * 8, c = base + lane;
          for (int r = base; r < base + 8; ++r) {
            if (r >= c) {
              T acc = T(0);
              for (int m = c; m < r; ++m)
                acc += S[m * kLd + r] * S[m * kLd + c];
              S[r * kLd + c] = r == c ? T(1) / D[r] : -acc / D[r];
            }
            __syncwarp(0xffu);
          }
          // the block's L^T is spent: its inverse's upper half is zero
          for (int r = base; r < c; ++r) S[r * kLd + c] = T(0);
        }
        __syncthreads();
        // join: T = L_BA X_AA, X_BA = -X_BB T, full-range sums (upper
        // halves are zero), 4 x 4 outputs per thread; then L_BA^T, spent,
        // is zeroed, so the joined block's upper half is zero too
        for (int bs = 8; bs < kNb; bs *= 2) {
          const int tb = bs / 4, per = tb * tb;
          for (int e = tid; e < 4 * bs; e += nt) {
            const int pr = e / per, i0 = e % per / tb * 4, j0 = e % tb * 4;
            const int a0b = pr * 2 * bs, b0b = a0b + bs;
            T acc[4][4] = {};
            for (int m = 0; m < bs; ++m) {
              const T* row = S + (a0b + m) * kLd;
              T l[4], x[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                l[u] = row[b0b + i0 + u];
                x[u] = row[a0b + j0 + u];
              }
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[u][v] += l[u] * x[v];
            }
            T* tm = Tm + pr * bs * bs;
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                tm[(i0 + u) * bs + j0 + v] = acc[u][v];
          }
          __syncthreads();
          for (int e = tid; e < 4 * bs; e += nt) {
            const int pr = e / per, i0 = e % per / tb * 4, j0 = e % tb * 4;
            const int a0b = pr * 2 * bs, b0b = a0b + bs;
            const T* tm = Tm + pr * bs * bs;
            T acc[4][4] = {};
            for (int m = 0; m < bs; ++m) {
              T xb[4], t4[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                xb[u] = S[(b0b + i0 + u) * kLd + b0b + m];
                t4[u] = tm[m * bs + j0 + u];
              }
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[u][v] += xb[u] * t4[v];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                S[(b0b + i0 + u) * kLd + a0b + j0 + v] = -acc[u][v];
                S[(a0b + i0 + u) * kLd + b0b + j0 + v] = T(0);
              }
          }
          __syncthreads();
        }
      }
      // the RHS rows less the partials, in source order, the adjacent
      // product last, then s = X b (L pass) or X^T b (Lt pass)
      const int nsrc = max(0, transpose ? Kn - 2 - row : row - 1);
      for (int k0 = 0; k0 < nrhs; k0 += kRc) {
        const int kc = min(kRc, nrhs - k0);
        for (int e = tid; e < w * kc; e += nt) {
          const int m = e / kc, kk = e % kc;
          V[m * kRc + kk] = xp[(int64_t)(r0 + m) * nrhs + k0 + kk];
        }
        for (int a = 0; a < nsrc; ++a) {
          const int src = transpose ? Kn - 1 - a : a;
          wait_flag(&pflag[row * K + src]);
          const T* pt = pp + ((int64_t)row * K + src) * kNb * nrhs;
          for (int e = tid; e < w * kc; e += nt) {
            const int m = e / kc, kk = e % kc;
            V[m * kRc + kk] -= __ldcg(pt + (int64_t)m * nrhs + k0 + kk);
          }
        }
        if (has_adj) {
          wait_flag(&sflag[adj]);
          for (int e = tid; e < kNb * kc; e += nt) {
            const int m = e / kc, kk = e % kc;
            V2[m * kRc + kk] =
                m < wa ? __ldcg(sp + (int64_t)(a0 + m) * nrhs + k0 + kk)
                       : T(0);
          }
          __syncthreads();
          for (int kk = 0; kk < kc; ++kk) {
            T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
            const T* v2 = V2 + q * kPart * kRc + kk;
#pragma unroll
            for (int j = 0; j < kPart; j += 4) {
              s0 += lreg[j] * v2[j * kRc];
              s1 += lreg[j + 1] * v2[(j + 1) * kRc];
              s2 += lreg[j + 2] * v2[(j + 2) * kRc];
              s3 += lreg[j + 3] * v2[(j + 3) * kRc];
            }
            red[q * kNb + t] = (s0 + s1) + (s2 + s3);
            __syncthreads();
            if (tid < w) {
              T tot = T(0);
              for (int p2 = 0; p2 < kQ; ++p2) tot += red[p2 * kNb + tid];
              V[tid * kRc + kk] -= tot;
            }
            __syncthreads();
          }
        }
        __syncthreads();
        if (first) {
          substitute(S, D, V, sp + (int64_t)r0 * nrhs + k0, nrhs, w, kc,
                     transpose);
          __syncthreads();  // V is refilled for the next columns
          continue;
        }
        for (int kk = 0; kk < kc; ++kk) {
          const T s = chain_matvec(S, transpose, transpose ? 2 : 1, V, kk, w,
                                   w, red);
          if (tid < w) sp[(int64_t)(r0 + tid) * nrhs + k0 + kk] = s;
        }
      }
      raise_flag(&sflag[row]);
    } else {
      // stage L[row tile, col tile], then wait for the source's solution
      for (int e = tid; e < wr * wc; e += nt) {
        const int r = e / wc, m = e % wc;
        cp_async_el(&S[r * kLd + m], L + (int64_t)(r0 + r) * cp + c0 + m);
      }
      cp_async_commit();
      // L pass: row tile gets L s_col; Lt pass: col tile gets L^T s_row
      const int src = transpose ? row : col, tgt = transpose ? col : row;
      const int w_in = transpose ? wr : wc, w_out = transpose ? wc : wr;
      wait_flag(&sflag[src]);
      cp_async_wait_all();
      __syncthreads();
      T* pt = pp + ((int64_t)tgt * K + src) * kNb * nrhs;
      for (int k0 = 0; k0 < nrhs; k0 += kRc) {
        const int kc = min(kRc, nrhs - k0);
        for (int e = tid; e < w_in * kc; e += nt) {
          const int m = e / kc, kk = e % kc;
          V[m * kRc + kk] =
              __ldcg(sp + (int64_t)(src * kNb + m) * nrhs + k0 + kk);
        }
        __syncthreads();
        for (int kk = 0; kk < kc; ++kk) {
          const T v = chain_matvec(S, transpose, 0, V, kk, w_out, w_in, red);
          if (tid < w_out) pt[(int64_t)tid * nrhs + k0 + kk] = v;
        }
      }
      raise_flag(&pflag[tgt * K + src]);
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kWarps = 8;  // warps per CTA of tri_wide_post

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
int launch_wide_chain(const void* data, int64_t data_bstride, const void* xs,
                      void* xsol, void* part, int* flags, const int64_t* off,
                      const int64_t* cols, int64_t B, int cp, int nrhs,
                      int batch, int transpose, cudaStream_t stream) {
  if (cp % kNb) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kNb * kLd + kNb + 2 * (size_t)kNb * kRc +
                       kQ * kNb + (size_t)kNb * kNb / 4) *
                      sizeof(T);
  // the shared-memory opt-in and the resident CTAs, once per type and
  // device (host calls that would otherwise lead every launch)
  static int dev_seen = -1, capacity = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != dev_seen) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(tri_wide_chain_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, tri_wide_chain_kernel<T>, kChainThreads, smem)) !=
            cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    capacity = sms * per_sm;
    dev_seen = dev;
  }
  const int64_t K = cp / kNb, P = B * batch;
  const int64_t items = P * (K + (K - 1) * (K - 2) / 2);
  // as many CTAs as fit on the card at once (more would only wait), at
  // most one per item
  const int64_t grid = items < capacity ? items : capacity;
  tri_wide_chain_kernel<T><<<(unsigned)grid, kChainThreads, smem, stream>>>(
      static_cast<const T*>(data), data_bstride, static_cast<const T*>(xs),
      static_cast<T*>(xsol), static_cast<T*>(part), flags, off, cols, (int)B,
      P, cp, nrhs, transpose);
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

static int tri_wide_pre(int dtype, int transpose, const void* data,
                        int64_t data_bstride, const void* vv,
                        int64_t vv_bstride, void* xs, int* flags,
                        int64_t nflags, const int64_t* off,
                        const int64_t* rows, const int64_t* cols,
                        const int64_t* vec_off, const int64_t* below_idx,
                        int64_t order, int64_t B, int cp, int rp, int nrhs,
                        int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((cp + 127) / 128, (unsigned)B, batch);
  if (dtype == 0)
    tri_wide_pre_kernel<float><<<grid, 128, 0, s>>>(
        static_cast<const float*>(data), data_bstride,
        static_cast<const float*>(vv), vv_bstride, static_cast<float*>(xs),
        flags, nflags, off, rows, cols, vec_off, below_idx, order, cp, rp,
        nrhs, transpose);
  else if (dtype == 1)
    tri_wide_pre_kernel<double><<<grid, 128, 0, s>>>(
        static_cast<const double*>(data), data_bstride,
        static_cast<const double*>(vv), vv_bstride, static_cast<double*>(xs),
        flags, nflags, off, rows, cols, vec_off, below_idx, order, cp, rp,
        nrhs, transpose);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// flags: 1 + P * K * (K + 1) ints zeroed by tri_wide_pre; part:
// P * K * K * 128 * nrhs values (P = B * batch, K = cp / 128)
static int tri_wide_chain(int dtype, int transpose, const void* data,
                          int64_t data_bstride, const void* xs, void* xsol,
                          void* part, int* flags, const int64_t* off,
                          const int64_t* cols, int64_t B, int cp, int nrhs,
                          int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_wide_chain<float>(data, data_bstride, xs, xsol, part, flags,
                                    off, cols, B, cp, nrhs, batch, transpose,
                                    s);
  if (dtype == 1)
    return launch_wide_chain<double>(data, data_bstride, xs, xsol, part,
                                     flags, off, cols, B, cp, nrhs, batch,
                                     transpose, s);
  return (int)cudaErrorInvalidValue;
}

static int tri_wide_post(int dtype, const void* data, int64_t data_bstride,
                         void* vv, int64_t vv_bstride, void* y,
                         int64_t y_bstride, int64_t y_base, const void* xs,
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

// K3-rest wide in one host call: tri_wide_pre, tri_wide_chain and
// tri_wide_post on one stream (the arguments of the three above; scratch
// holds xs, xsol and the partial slots in turn). Returns the first
// cudaError_t.
extern "C" int bs_tri_wide_solve(int dtype, int transpose, const void* data,
                                 int64_t data_bstride, void* vv,
                                 int64_t vv_bstride, void* y,
                                 int64_t y_bstride, int64_t y_base,
                                 void* scratch, int* flags, int64_t nflags,
                                 const int64_t* off, const int64_t* rows,
                                 const int64_t* cols, const int64_t* vec_off,
                                 const int64_t* below_idx, int64_t order,
                                 int64_t B, int cp, int rp, int nrhs,
                                 int batch, void* stream) {
  const size_t item = dtype == 1 ? sizeof(double) : sizeof(float);
  const int64_t nx = B * batch * cp * nrhs;
  char* xs = static_cast<char*>(scratch);
  char* xsol = xs + nx * item;
  char* part = xsol + nx * item;
  int e = tri_wide_pre(dtype, transpose, data, data_bstride, vv,
                          vv_bstride, xs, flags, nflags, off, rows, cols,
                          vec_off, below_idx, order, B, cp, rp, nrhs, batch,
                          stream);
  if (e) return e;
  e = tri_wide_chain(dtype, transpose, data, data_bstride, xs, xsol, part,
                        flags, off, cols, B, cp, nrhs, batch, stream);
  if (e) return e;
  return tri_wide_post(dtype, data, data_bstride, vv, vv_bstride, y,
                          y_bstride, y_base, xsol, off, rows, cols, vec_off,
                          B, cp, y ? rp : 0, nrhs, batch, stream);
}
