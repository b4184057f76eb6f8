// Theorem 4.9 block-inverse update of Inverse Hessian Boosting.
//
// Replaces the Pallas TPU kernel `ihb_update` (_ihb_kernel) of
// src/repro/kernels/ihb_update.py.  Given the padded inverse N (L x L, the
// identity beyond the active block), the new column's Gram vector q (zero
// from slot ell on) and its squared norm btb, it writes
//     u = N q,   s = max(btb - sum(q * u), 1e-30),
//     N' = N + u u^T / s,  then row and column ell := -u / s, (ell, ell) := 1/s
// out of place into `out`.  With the identity padding and q's zeros the
// entries beyond ell come out bit-exact (x + (0 * 0) / s == x).
//
// btb, ell and the optional `active` flag are read from device memory, so the
// OAVI candidate loop needs no host sync per candidate: when *active == 0 the
// kernel copies N to out unchanged (the rejected/accepted branch of the
// reference's lax.cond).
//
// What bounds it on the H100: bytes.  The work is ~5 L^2 flops over
// 2 L^2 * 4 bytes of N read and N' written, under 1 flop per byte, and at the
// OAVI sizes (L = 64 .. 2048) the launch latency dominates below L ~ 512.
//
// What the design does about it: the update needs the old N whole before any
// row of N' is written (u = N q reads every row), so it is three launches in
// stream order, each a plain streaming pass:
//   1. ihb_matvec_kernel: one warp per row, u[i] = sum_j N[i,j] q[j] with
//      lane-strided partial sums and a fixed shuffle tree (deterministic);
//   2. ihb_schur_kernel: one block reduces sum(q * u) in a fixed order and
//      writes s;
//   3. ihb_rank1_kernel: one thread per element, coalesced along rows.
// Writing out of place keeps N intact, so the caller's state stays valid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool is_active(const unsigned char* active) {
  return active == nullptr || *active != 0;
}

__global__ void __launch_bounds__(kThreads)
ihb_matvec_kernel(const float* __restrict__ N, const float* __restrict__ q,
                  const unsigned char* active, float* __restrict__ u, int L) {
  if (!is_active(active)) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (kThreads / 32) + warp;
  if (i >= L) return;
  const float* row = N + (long long)i * L;
  float s = 0.0f;
  for (int j = lane; j < L; j += 32) s = __fmaf_rn(row[j], q[j], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (lane == 0) u[i] = s;
}

__global__ void __launch_bounds__(kThreads)
ihb_schur_kernel(const float* __restrict__ q, const float* __restrict__ btb,
                 const unsigned char* active, float* __restrict__ u, int L) {
  if (!is_active(active)) return;
  __shared__ float part[kThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < L; i += kThreads)
    s = __fadd_rn(s, __fmul_rn(q[i], u[i]));
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
      part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) u[L] = fmaxf(__fsub_rn(*btb, part[0]), 1e-30f);
}

// u holds N q in [0, L) and s at [L].
__global__ void __launch_bounds__(kThreads)
ihb_rank1_kernel(const float* __restrict__ N, const float* __restrict__ u,
                 const int* __restrict__ ell_p, const unsigned char* active,
                 float* __restrict__ out, int L) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)L * L) return;
  const float nij = N[e];
  if (!is_active(active)) {
    out[e] = nij;
    return;
  }
  const int i = (int)(e / L);
  const int j = (int)(e % L);
  const int ell = *ell_p;
  const float s = u[L];
  float v;
  if (i == ell && j == ell) {
    v = __fdiv_rn(1.0f, s);
  } else if (i == ell || j == ell) {
    // -u/s, plus +0 as the reference's `n2 * keep + onehot / s` adds it
    // (turns a -0 from u == 0 into +0)
    v = __fadd_rn(__fdiv_rn(-u[i == ell ? j : i], s), 0.0f);
  } else {
    v = __fadd_rn(nij, __fdiv_rn(__fmul_rn(u[i], u[j]), s));
  }
  out[e] = v;
}

}  // namespace

// Host entry point.  u_scratch holds L + 1 floats.  active may be null
// (always update).  Returns the first launch error, or cudaSuccess.
extern "C" int repro_ihb_update(const float* N, const float* q,
                                const float* btb, const int* ell,
                                const unsigned char* active, float* out,
                                float* u_scratch, int L, cudaStream_t stream) {
  const unsigned rows_blocks = (unsigned)((L + kThreads / 32 - 1) / (kThreads / 32));
  ihb_matvec_kernel<<<rows_blocks, kThreads, 0, stream>>>(N, q, active,
                                                          u_scratch, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ihb_schur_kernel<<<1, kThreads, 0, stream>>>(q, btb, active, u_scratch, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long E = (long long)L * L;
  const unsigned blocks = (unsigned)((E + kThreads - 1) / kThreads);
  ihb_rank1_kernel<<<blocks, kThreads, 0, stream>>>(N, u_scratch, ell, active,
                                                    out, L);
  return (int)cudaGetLastError();
}
