// Online-softmax (flash) attention with GQA, causal or not, dv != d allowed.
//
// Replaces the Pallas TPU kernel `flash_attention` (_flash_kernel) of
// src/repro/kernels/flash_attention.py:81.  For every flattened query head h
// (of B * Hq) it computes
//     o[h] = softmax(q[h] k[h / group]^T / sqrt(d), causal mask) v[h / group]
// streaming K and V through shared memory with a running max m, sum l and
// accumulator acc, all fp32; p is rounded to v's type before P V, as the
// reference rounds it; the output takes q's type.  Masked scores are the
// finite -1e30 of the reference, masked probabilities are exactly 0, and l
// is clamped at 1e-30 before the division.
//
// Differences from the TPU kernel, by design: a thread block owns one
// (head, q-tile) and loops over the k-tiles itself (the TPU's sequential
// grid axis), stops at the diagonal when causal, and masks the ragged Sq and
// Sk edges itself, so the caller pads nothing.  Causal attention here is
// top-left aligned (key j is seen by query i iff j <= i), as in the TPU
// kernel; the caller allows it only for Sq == Sk, where it equals the
// plain version's bottom-right mask.
//
// What bounds it on the H100: operations.  At the serve shape (B * Hq = 128,
// S = 2048, d = dv = 128, causal, bf16) a call does ~137 GFLOP of tensor-core
// work on ~168 MB of q, k, v and o: 0.14 ms at 989 TFLOP/s against 0.05 ms
// at 3.35 TB/s.
//
// What the design does about it: the bf16 kernel (flash_attn_mma) runs both
// products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate).  Four warps each own 16 query rows of a 64-row q-tile; the
// q fragments stay in registers for the whole k loop; S = Q K^T stays in
// registers and becomes the A operand of P V without touching shared
// memory (the C layout of one m16n8 tile pair is the A layout of m16k16).
// K is staged row-major and V transposed, each row padded by 8 halfwords so
// the fragment loads hit 32 distinct banks.  Loads are plain 16-byte loads
// with no cp.async/TMA pipeline and no wgmma yet: two or three blocks on
// each SM hide one another's load latency.  fp32 inputs, and bf16 head sizes
// without an mma instantiation, take flash_attn_simple: one key per lane,
// scalar fp32 FMA from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the reference
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p as the reference feeds it to P V: rounded to v's type, back in fp32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// flash_attn_simple: any float type, d and dv up to 256.
// 4 warps, 16 query rows per block (4 per warp), 32 keys per tile (one per
// lane).  Shared: Q (16 x d), K (32 x (d + 1), padded against bank
// conflicts), V (32 x dv), all fp32.
// ---------------------------------------------------------------------------

constexpr int kSimpleRows = 16;
constexpr int kSimpleKeys = 32;
constexpr int kSimpleRowsPerWarp = 4;
constexpr int kSimpleMaxCols = 8;  // dv <= 32 * 8

template <typename T>
__global__ void __launch_bounds__(128)
flash_attn_simple(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                  int d, int dv, int group, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kSimpleRows * d;
  float* Vs = Ks + kSimpleKeys * (d + 1);
  const int n_tiles = gridDim.x;
  // causal: the longest tiles (last rows) are launched first
  const int tile = causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int hk = h / group;
  const int q0 = tile * kSimpleRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qh = q + (size_t)h * Sq * d;
  const T* kh = k + (size_t)hk * Sk * d;
  const T* vh = v + (size_t)hk * Sk * dv;

  for (int i = threadIdx.x; i < kSimpleRows * d; i += blockDim.x) {
    const int r = q0 + i / d;
    Qs[i] = r < Sq ? to_float(qh[(size_t)r * d + i % d]) : 0.0f;
  }
  float m[kSimpleRowsPerWarp], l[kSimpleRowsPerWarp];
  float acc[kSimpleRowsPerWarp][kSimpleMaxCols];
#pragma unroll
  for (int i = 0; i < kSimpleRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kSimpleMaxCols; ++c) acc[i][c] = 0.0f;
  }
  const int k_end = causal ? min(Sk, q0 + kSimpleRows) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kSimpleKeys) {
    __syncthreads();  // Q staged / previous tile consumed
    for (int i = threadIdx.x; i < kSimpleKeys * d; i += blockDim.x) {
      const int r = k0 + i / d;
      Ks[(i / d) * (d + 1) + i % d] = r < Sk ? to_float(kh[(size_t)r * d + i % d]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kSimpleKeys * dv; i += blockDim.x) {
      const int r = k0 + i / dv;
      Vs[i] = r < Sk ? to_float(vh[(size_t)r * dv + i % dv]) : 0.0f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kSimpleRowsPerWarp; ++i) {
      const int rl = warp * kSimpleRowsPerWarp + i;
      const int row = q0 + rl;
      const float* qr = Qs + rl * d;
      const float* kr = Ks + lane * (d + 1);
      float s = 0.0f;
      for (int t = 0; t < d; ++t) s = fmaf(qr[t], kr[t], s);
      s *= scale;
      const bool valid = key < Sk && (!causal || key <= row);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.0f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int c = 0; c < kSimpleMaxCols; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < kSimpleKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
        const float* vr = Vs + j * dv;
#pragma unroll
        for (int c = 0; c < kSimpleMaxCols; ++c) {
          const int col = lane + 32 * c;
          if (col < dv) acc[i][c] = fmaf(pj, vr[col], acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSimpleRowsPerWarp; ++i) {
    const int row = q0 + warp * kSimpleRowsPerWarp + i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)h * Sq + row) * dv;
#pragma unroll
    for (int c = 0; c < kSimpleMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) orow[col] = from_float<T>(acc[i][c] / li);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_attn_mma: bf16, head sizes D (q, k) and DV (v) multiples of 16.
// ---------------------------------------------------------------------------

constexpr int kRows = 64;             // query rows per block, 16 per warp
constexpr int kKeys = 64;             // keys per k-tile
constexpr int kThreads = 128;
constexpr int kVStride = kKeys + 8;   // halfwords per row of the transposed V tile
static_assert(kKeys == kRows, "stage_rows stages Q and K tiles of one height");

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, int DV>
struct MmaShape {
  static constexpr int kQStride = D + 8;  // halfwords per row of the Q / K tile
  static constexpr int kQKBytes = kRows * kQStride * 2;  // Q, then K, share it
  static constexpr int kVBytes = DV * kVStride * 2;
  static constexpr int kSmem = kQKBytes + kVBytes;
};

// Copy rows [r0, r0 + kRows) of a (rows x W) bf16 matrix into shared memory
// with row stride W + 8; rows at or beyond n_rows become zeros.
template <int W>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int r0, int n_rows) {
  constexpr int kChunks = W / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * W + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + c * 8) = val;
  }
}

// Copy keys [k0, k0 + kKeys) of V (Sk x DV) transposed: Vt[col][key].
// Consecutive threads take consecutive keys, so the 2-byte stores of a warp
// fill 16 consecutive words.
template <int DV>
__device__ __forceinline__ void stage_v_transposed(__nv_bfloat16* Vt, const __nv_bfloat16* src,
                                                   int k0, int Sk) {
  constexpr int kChunks = DV / 8;
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int r = i % kKeys, c = i / kKeys;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < Sk)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + r) * DV + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) Vt[(c * 8 + j) * kVStride + r] = e[j];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attn_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int Sq, int Sk, int group, int causal, float scale_log2) {
  using Shape = MmaShape<D, DV>;
  constexpr int QS = Shape::kQStride;
  constexpr int KT = D / 16;      // k-steps of Q K^T
  constexpr int NS = kKeys / 8;   // n-tiles of S per warp
  constexpr int NO = DV / 8;      // n-tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* QKs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(smem_raw + Shape::kQKBytes);

  const int n_tiles = gridDim.x;
  const int tile = causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int hk = h / group;
  const int q0 = tile * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread-in-group
  const __nv_bfloat16* kh = k + (size_t)hk * Sk * D;
  const __nv_bfloat16* vh = v + (size_t)hk * Sk * DV;

  // Q tile -> shared -> A fragments in registers (kept for the whole loop)
  stage_rows<D>(QKs, q + (size_t)h * Sq * D, q0, Sq);
  __syncthreads();
  uint32_t qf[KT][4];
  {
    const __nv_bfloat16* r0 = QKs + (warp * 16 + g) * QS;
    const __nv_bfloat16* r1 = r0 + 8 * QS;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qf[kk][0] = ld_u32(r0 + kk * 16 + 2 * t);
      qf[kk][1] = ld_u32(r1 + kk * 16 + 2 * t);
      qf[kk][2] = ld_u32(r0 + kk * 16 + 8 + 2 * t);
      qf[kk][3] = ld_u32(r1 + kk * 16 + 8 + 2 * t);
    }
  }

  // this thread's two rows: row0 = q0 + 16 warp + g, row1 = row0 + 8
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf;  // running max, in log2 units
  float l0 = 0.0f, l1 = 0.0f;        // this thread's share of the row sums
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // Q fragments loaded / previous tile consumed
    stage_rows<D>(QKs, kh, k0, Sk);
    stage_v_transposed<DV>(Vt, vh, k0, Sk);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kr = QKs + (j * 8 + g) * QS + kk * 16 + 2 * t;
        mma_bf16(s[j], qf[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // scale into log2 units, mask, row max over the quad
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * t + e;
        const bool ok0 = col < Sk && (!causal || col <= row0);
        const bool ok1 = col < Sk && (!causal || col <= row1);
        s[j][e] = ok0 ? s[j][e] * scale_log2 : kNegInf;
        s[j][2 + e] = ok1 ? s[j][2 + e] * scale_log2 : kNegInf;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a masked score is kNegInf: its probability is exactly 0
        s[j][e] = s[j][e] == kNegInf ? 0.0f : exp2f(s[j][e] - mn0);
        s[j][2 + e] = s[j][2 + e] == kNegInf ? 0.0f : exp2f(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P V: the C fragments of S n-tiles (2 kt, 2 kt + 1) are the A
    // fragment of the k-step kt, rounded to bf16 as the reference rounds p
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + g) * kVStride + kt * 16 + 2 * t;
        mma_bf16(acc[n], pa, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }

  // full row sums over the quad, then o = acc / max(l, 1e-30)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + (size_t)h * Sq * DV;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)row0 * DV + col) =
          pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)row1 * DV + col) =
          pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
  }
}

template <int D, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int BHq,
                       int Sq, int Sk, int group, int causal, cudaStream_t stream) {
  constexpr int smem = MmaShape<D, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_mma<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, BHq);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  flash_attn_mma<D, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, group,
      causal, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simple(const void* q, const void* k, const void* v, void* o, int BHq,
                          int Sq, int Sk, int d, int dv, int group, int causal,
                          cudaStream_t stream) {
  const int smem = (int)sizeof(float) *
                   (kSimpleRows * d + kSimpleKeys * (d + 1) + kSimpleKeys * dv);
  cudaError_t err = cudaFuncSetAttribute(flash_attn_simple<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kSimpleRows - 1) / kSimpleRows, BHq);
  flash_attn_simple<T><<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, d, dv, group, causal, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace

// Head sizes with a tensor-core instantiation (bf16 only): 1 if (d, dv) has
// one, else 0.  The wrapper reports which variant a call takes.
extern "C" int repro_flash_attention_has_mma(int d, int dv) {
  return (d == 64 && dv == 64) || (d == 128 && dv == 128) || (d == 192 && dv == 128);
}

// q (BHq, Sq, d), k (BHq / group, Sk, d), v (BHq / group, Sk, dv), o (BHq, Sq, dv),
// all contiguous, 16-byte aligned, of one type: dtype 0 = float32, 1 = bfloat16.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int BHq, int Sq, int Sk, int d, int dv, int group,
                                     int causal, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (BHq <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && repro_flash_attention_has_mma(d, dv)) {
    if (d == 64) return (int)launch_mma<64, 64>(q, k, v, o, BHq, Sq, Sk, group, causal, stream);
    if (d == 128) return (int)launch_mma<128, 128>(q, k, v, o, BHq, Sq, Sk, group, causal, stream);
    return (int)launch_mma<192, 128>(q, k, v, o, BHq, Sq, Sk, group, causal, stream);
  }
  if (d > 256 || dv > 32 * kSimpleMaxCols) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_simple<float>(q, k, v, o, BHq, Sq, Sk, d, dv, group, causal, stream);
  if (dtype == 1)
    return (int)launch_simple<__nv_bfloat16>(q, k, v, o, BHq, Sq, Sk, d, dv, group, causal,
                                             stream);
  return (int)cudaErrorInvalidValue;
}
