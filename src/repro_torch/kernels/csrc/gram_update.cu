// Fused border evaluation + both Gram products, with carry-in, for OAVI.
//
// Replaces the Pallas TPU kernels `gram_update_acc` (_gram_acc_kernel) and
// `gram_update` (_gram_kernel) of src/repro/kernels/gram_update.py.  One
// kernel pair serves both: a null carry-in pointer is the zero-initialised
// `gram_update`.
//
// What it computes, for B = A[:, parents] * X[:, vars]  (m x K):
//     QL = ql0 + A^T B   (L x K)      C = c0 + B^T B   (K x K)
// reduced in the canonical order: for every bm-row block b the partial
// P_b = Y_b^T B_b (Y = [A | B]) is summed over its rows in row order, and the
// partials are folded into the carry strictly left to right,
//     out = (((acc0 + P_0) + P_1) + ...).
// That order is a contract: a call over rows [0, m) equals, bit for bit, a
// chain of calls over any split at a multiple of bm with the carry threaded
// through.  No atomics, and no partial ever spans two row blocks.
//
// What bounds it on the H100: fp32 FMAs.  Per row it does (L+K)*K FMAs and
// reads (L+n)*4 bytes, i.e. (L+K)*K/(2*(L+n)) FMA per byte, about 60 at
// L = K = 64, n = 3 -- far above the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte).  Tensor cores are not used: OAVI's
// accept/reject test `btb + q.y <= psi` cancels, so TF32 is not an option.
//
// What the design does about it:
//   * Pass 1 (gram_partials_kernel): one thread block per (output tile,
//     row block).  A 64x64 tile of Y^T B is held as 4x4 register micro-tiles
//     in 256 threads; rows stream through shared memory in 32-row slabs.
//     The slab loads are coalesced along A's rows; the parent and variable
//     columns are gathered in the load (the block reads its own parents/vars,
//     there is no scalar prefetch) and the product B is formed there, so B
//     never reaches device memory.  Each block writes its partial P_b.
//     Computing the partials of all row blocks in parallel is what fills the
//     132 SMs when L = K = 64 gives only two output tiles.
//   * Pass 2 (gram_fold_kernel): one thread per output element folds the
//     partials in block order onto the carry.
//   The host entry point walks the row blocks in groups that fit the scratch
//   buffer the caller passes; each group is pass 1 + pass 2, so the grouping
//   is itself a chain of carried calls and changes no bit.
//   Ragged L, K and n are masked; indices are clamped into range.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile edge (rows of Y^T B and cols)
constexpr int kMicro = 4;      // per-thread micro-tile edge
constexpr int kSlab = 32;      // rows staged in shared memory at a time
constexpr int kThreads = 256;  // (kTile / kMicro)^2

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v >= hi ? hi - 1 : v);
}

// One (output tile, row block) partial of Y^T B, Y = [A | B].
__global__ void __launch_bounds__(kThreads)
gram_partials_kernel(const float* __restrict__ A, const float* __restrict__ X,
                     const int* __restrict__ parents,
                     const int* __restrict__ vars, float* __restrict__ P,
                     long long row0, int L, int n, int K, int bm,
                     int tiles_j) {
  __shared__ __align__(16) float ys[kSlab][kTile];  // left operand slab
  __shared__ __align__(16) float bs[kSlab][kTile];  // right operand slab
  __shared__ int lp[kTile], lv[kTile], rp[kTile], rv[kTile];

  const int tile = blockIdx.x;
  const int i0 = (tile / tiles_j) * kTile;
  const int j0 = (tile % tiles_j) * kTile;
  const int LK = L + K;
  const long long rbase = row0 + (long long)blockIdx.y * bm;
  const int t = threadIdx.x;

  // Column plan of this tile.  lp < 0 marks an A column (index in lv),
  // lp >= 0 a border column A[:, lp] * X[:, lv]; rp = -2 marks padding.
  if (t < kTile) {
    const int i = i0 + t;
    if (i < L) {
      lp[t] = -1;
      lv[t] = i;
    } else if (i < LK) {
      lp[t] = clampi(parents[i - L], L);
      lv[t] = clampi(vars[i - L], n);
    } else {
      lp[t] = -2;
      lv[t] = 0;
    }
    const int j = j0 + t;
    if (j < K) {
      rp[t] = clampi(parents[j], L);
      rv[t] = clampi(vars[j], n);
    } else {
      rp[t] = -2;
      rv[t] = 0;
    }
  }
  __syncthreads();

  const int ty = t / (kTile / kMicro);  // micro-tile row
  const int tx = t % (kTile / kMicro);  // micro-tile col
  float acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.0f;

  for (int s = 0; s < bm; s += kSlab) {
    // Stage kSlab rows: consecutive threads take consecutive columns of one
    // row, so the A-column loads are coalesced.
    for (int e = t; e < kSlab * kTile; e += kThreads) {
      const int r = e / kTile;
      const int c = e % kTile;
      const float* arow = A + (rbase + s + r) * (long long)L;
      const float* xrow = X + (rbase + s + r) * (long long)n;
      const int p = lp[c];
      float yv;
      if (p == -1) {
        yv = arow[lv[c]];
      } else if (p >= 0) {
        yv = __fmul_rn(arow[p], xrow[lv[c]]);
      } else {
        yv = 0.0f;
      }
      ys[r][c] = yv;
      const int q = rp[c];
      bs[r][c] = q >= 0 ? __fmul_rn(arow[q], xrow[rv[c]]) : 0.0f;
    }
    __syncthreads();
    // Rows in order: each output element sums its block's rows 0..bm-1
    // sequentially, one FMA per row.
#pragma unroll 4
    for (int r = 0; r < kSlab; ++r) {
      const float4 y4 = *reinterpret_cast<const float4*>(&ys[r][ty * kMicro]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[r][tx * kMicro]);
      const float yv[kMicro] = {y4.x, y4.y, y4.z, y4.w};
      const float bv[kMicro] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < kMicro; ++a)
#pragma unroll
        for (int b = 0; b < kMicro; ++b)
          acc[a][b] = __fmaf_rn(yv[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

  float* Pb = P + (long long)blockIdx.y * LK * K;
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty * kMicro + a;
    if (i >= LK) continue;
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int j = j0 + tx * kMicro + b;
      if (j < K) Pb[(long long)i * K + j] = acc[a][b];
    }
  }
}

// out[e] = (((acc0[e] + P_0[e]) + P_1[e]) + ...), one thread per element.
// acc0 == nullptr starts from zero.  out may alias acc0 (same element, same
// thread).
__global__ void gram_fold_kernel(const float* __restrict__ P, int nblocks,
                                 const float* ql0, const float* c0, float* ql,
                                 float* c, int L, int K) {
  const long long E = (long long)(L + K) * K;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long LKe = (long long)L * K;
  const bool in_ql = e < LKe;
  const float* src = in_ql ? ql0 : c0;
  const long long off = in_ql ? e : e - LKe;
  float s = src != nullptr ? src[off] : 0.0f;
#pragma unroll 8
  for (int b = 0; b < nblocks; ++b) s = __fadd_rn(s, P[(long long)b * E + e]);
  (in_ql ? ql : c)[off] = s;
}

}  // namespace

// Host entry point.  m must be a multiple of bm and bm of kSlab (the Python
// wrapper pads and checks).  scratch holds group_blocks partials of
// (L+K)*K floats.  Returns the first launch error, or cudaSuccess.
extern "C" int repro_gram_update(const float* A, const float* X,
                                 const int* parents, const int* vars,
                                 const float* ql0, const float* c0, float* ql,
                                 float* c, float* scratch, long long m, int L,
                                 int n, int K, int bm, int group_blocks,
                                 cudaStream_t stream) {
  const long long nb = m / bm;
  const int tiles_i = (L + K + kTile - 1) / kTile;
  const int tiles_j = (K + kTile - 1) / kTile;
  const long long E = (long long)(L + K) * K;
  const int fold_threads = 256;
  const unsigned fold_blocks = (unsigned)((E + fold_threads - 1) / fold_threads);
  const float* acc_ql = ql0;
  const float* acc_c = c0;
  long long b0 = 0;
  do {  // at least one fold, so m == 0 copies the carry through
    const int g = (int)((nb - b0) < group_blocks ? (nb - b0) : group_blocks);
    if (g > 0) {
      dim3 grid((unsigned)(tiles_i * tiles_j), (unsigned)g);
      gram_partials_kernel<<<grid, kThreads, 0, stream>>>(
          A, X, parents, vars, scratch, b0 * bm, L, n, K, bm, tiles_j);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    gram_fold_kernel<<<fold_blocks, fold_threads, 0, stream>>>(
        scratch, g, acc_ql, acc_c, ql, c, L, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    acc_ql = ql;
    acc_c = c;
    b0 += g;
  } while (b0 < nb);
  return (int)cudaSuccess;
}

// Message of a CUDA error code returned by the entry points above.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
