// Online-softmax (flash) attention with GQA, causal or not, dv != d allowed.
//
// Replaces the Pallas TPU kernel `flash_attention` (_flash_kernel) of
// src/repro/kernels/flash_attention.py:81.  For every flattened query head h
// (of B * Hq) it computes
//     o[h] = softmax(q[h] k[h / group]^T / sqrt(d), causal mask) v[h / group]
// streaming K and V through shared memory with a running max m, sum l and
// accumulator acc, all fp32; the scores are kept in fp32 log2 units; p is
// rounded to v's type only as the operand of P V, as the reference rounds
// it; the row sum l is taken from the fp32 p; the output takes q's type.
// Masked scores are the finite -1e30 of the reference, masked probabilities
// are exactly 0, and l is clamped at 1e-30 before the division.
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
// S = 2048, d = dv = 128, causal, bf16) a call does 137.5 GFLOP of
// tensor-core work on 168 MB of q, k, v and o: 0.139 ms at 989 TFLOP/s
// against 0.050 ms at 3.35 TB/s.  Only wgmma reaches the tensor cores' full
// rate, and only if the operands arrive in shared memory while the tensor
// cores work and no thread spends instructions on moving them.
//
// Two variants, chosen by repro_flash_attention_variant:
//   * flash_attn_wgmma (bf16; (d, dv) = (128, 128), the serve shape, (64, 64)
//     and (192, 128)).  One block per (head, 128-row q-tile), 384 threads:
//     two consumer warpgroups own 64 rows each; in the third, the producer,
//     one thread issues TMA loads: Q once, then K and V 128-key tiles through
//     a 3-stage ring (2 stages at d = 192) guarded by full/empty mbarriers.
//     setmaxnreg moves the producer's registers to the consumers (24 and 240
//     a thread).  The tensor maps are 3-D (heads, rows, cols): rows past
//     Sq/Sk read as zeros inside each head and a box never reaches into the
//     next head.  The maps are encoded on the host with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
//     (ByVersion), so the library links no libcuda.  TMA writes the tiles in
//     the 128-byte swizzle that wgmma's descriptors read.  S = Q K^T is wgmma
//     m64n128k16 with both operands from shared memory, K-major; the fp32 S
//     accumulator becomes, rounded to bf16, the register A operand of
//     O += P V, whose B operand V is read MN-major (transpose bit) from its
//     TMA tile: no thread transposes or copies a tile.  In each warpgroup, S
//     of k-tile i + 1 is issued before P V of tile i, so the softmax of i + 1
//     runs on the CUDA cores while P V of i runs on the tensor cores; the two
//     warpgroups take turns to issue (named barriers), so one's softmax also
//     overlaps the other's products.  The mask arithmetic runs only on the
//     last k-tile (the diagonal when causal, the ragged Sk edge otherwise);
//     every other tile runs unmasked.  Causal blocks are scheduled longest
//     first, and k-tiles wholly above the diagonal are never loaded.
//   * flash_attn_simple (fp32, and bf16 head sizes without a tensor-core
//     instantiation, up to 256): one key per lane, scalar fp32 FMA from
//     shared memory.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol is linked
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

// ---------------------------------------------------------------------------
// flash_attn_wgmma: bf16, (d, dv) = (128, 128) (the serve shape), (64, 64)
// or (192, 128).
//
// Warps 0-7 are the two consumer warpgroups; warpgroup 2 is the producer.
// Shared memory, each tile stored as 64-column halves of 128-byte rows in the
// 128-byte swizzle that TMA writes and wgmma reads:
//     Q (128 x D), then kStages x [K (128 x D), V (128 x DV)], then barriers
// (3 stages, 230,480 bytes at d = dv = 128; 2 stages at d = 192, dv = 128:
// one block per SM).  Barriers: full_q;
// full_k[s], full_v[s] (TMA bytes landed); empty[s] (the 8 consumer warps
// are done with stage s).
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;     // query rows per block, 64 per consumer warpgroup
constexpr int kWgKeys = 128;     // keys per k-tile
constexpr int kWgConsumers = 256;
constexpr int kWgThreads = kWgConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;   // setmaxnreg: the producer gives its registers
constexpr int kConsumerRegs = 240;  // to the consumers (128 x 24 + 256 x 240 <= 65536)
constexpr int kHalf = 64;        // bf16 columns in one 128-byte swizzled row
constexpr int kAtom = 1024;      // 8 rows x 128 bytes: one swizzle atom

template <int D, int DV>
struct WgShape {
  // K/V ring depth: 3 (k-tile i + 2 loads while i + 1's S runs) where it
  // fits the 227 KB a block may use, else 2
  static constexpr int kStages =
      (kWgRows * D + 3 * kWgKeys * (D + DV)) * 2 + 2048 <= 232448 ? 3 : 2;
  static constexpr int kQBytes = kWgRows * D * 2;
  static constexpr int kKBytes = kWgKeys * D * 2;
  static constexpr int kVBytes = kWgKeys * DV * 2;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBarOff = kQBytes + kStages * kStageBytes;
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + kAtom;  // + slack to align the base
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box {64 columns, 128 rows, 1 head} of a 3-D (heads, rows, cols) map.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending (they retire in
// order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` over `count` threads: wait for it, or arrive without
// waiting.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Pin accumulator registers at this point of the program: no read of them
// moves above a wgmma wait, no write below a wgmma issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_ACC1(d, i) "+f"(d[i])
#define WG_ACC8(d, i)                                                                    \
  WG_ACC1(d, i), WG_ACC1(d, i + 1), WG_ACC1(d, i + 2), WG_ACC1(d, i + 3), WG_ACC1(d, i + 4), \
      WG_ACC1(d, i + 5), WG_ACC1(d, i + 6), WG_ACC1(d, i + 7)

// d = A (64x16) B (16x128), A and B from shared memory, both K-major (the
// scale-d predicate is off: d's old value is ignored, its registers kept)
__device__ __forceinline__ void wgmma_ss_m64n128_zero(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24),
        WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(0));
}

// d += A (64x16) B (16x128), A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24),
        WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64x16, registers) B (16x128, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24),
        WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64x16, registers) B (16x64, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DV>
__device__ __forceinline__ void wgmma_rs(float (&d)[DV / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64(d, a, db);
}

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 int Sq, int Sk, int group, int causal, float scale_log2) {
  using Sh = WgShape<D, DV>;
  constexpr int kWgStages = Sh::kStages;
  static_assert(D % kHalf == 0 && DV % kHalf == 0, "head sizes in 64-column halves");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + kAtom - 1) & ~uint32_t(kAtom - 1);
  const uint32_t sQ = base;
  const uint32_t sKV = base + Sh::kQBytes;  // stage s: K at sKV + s * kStageBytes, V after it
  const uint32_t bar = base + Sh::kBarOff;
  const uint32_t full_q = bar;
  auto full_k = [&](int s) { return bar + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar + 8 * (1 + kWgStages + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * kWgStages + s); };

  // causal: the longest q-tiles (last rows) of every head are scheduled first
  const int n_tiles = gridDim.y;
  const int tile = causal ? n_tiles - 1 - blockIdx.y : blockIdx.y;
  const int h = blockIdx.x;
  const int q0 = tile * kWgRows;
  // k-tiles wholly above the diagonal are never loaded (causal needs Sq == Sk)
  const int k_end = causal ? min(Sk, q0 + kWgRows) : Sk;
  const int n_k = (k_end + kWgKeys - 1) / kWgKeys;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kWgConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kWgConsumers / 32) {
    // producer: one thread issues Q once, then K and V of every k-tile
    // through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kWgConsumers) {
      const int hk = h / group;
      mbar_expect_tx(full_q, Sh::kQBytes);
#pragma unroll
      for (int c = 0; c < D / kHalf; ++c)
        tma_load_3d(sQ + c * kWgRows * 128, &tq, full_q, c * kHalf, q0, h);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kWgStages;
        mbar_wait(empty(s), ((i / kWgStages) & 1) ^ 1);
        const uint32_t sK = sKV + s * Sh::kStageBytes, sV = sK + Sh::kKBytes;
        mbar_expect_tx(full_k(s), Sh::kKBytes);
#pragma unroll
        for (int c = 0; c < D / kHalf; ++c)
          tma_load_3d(sK + c * kWgKeys * 128, &tk, full_k(s), c * kHalf, i * kWgKeys, hk);
        mbar_expect_tx(full_v(s), Sh::kVBytes);
#pragma unroll
        for (int c = 0; c < DV / kHalf; ++c)
          tma_load_3d(sV + c * kWgKeys * 128, &tv, full_v(s), c * kHalf, i * kWgKeys, hk);
      }
    }
    return;
  }

  // consumers: tile i's P V runs on the tensor cores while the warpgroup
  // computes the softmax of tile i + 1, whose S = Q K^T was issued first
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;                    // consumer warpgroup: rows 64 wg .. 64 wg + 63
  const int g = lane >> 2, t = lane & 3;      // accumulator row group and column pair
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf;  // running max, in log2 units
  float l0 = 0.0f, l1 = 0.0f;        // this thread's share of the row sums
  float alpha0 = 1.0f, alpha1 = 1.0f;  // rescale of acc before the next P V
  float acc[DV / 2];
#pragma unroll
  for (int n = 0; n < DV / 2; ++n) acc[n] = 0.0f;
  float s[64];                    // S = Q K^T, 64 rows x 128 keys over the warpgroup
#pragma unroll
  for (int n = 0; n < 64; ++n) s[n] = 0.0f;
  uint32_t pa[kWgKeys / 16][4];   // P in bf16: the A operand of P V
  const uint32_t sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows: 8 atoms

  // S = Q K^T of k-tile i: D / 16 steps of m64n128k16, K-major operands;
  // issued and committed, not waited for (the caller fences first)
  auto issue_qk = [&](int i) {
    const int st = i % kWgStages;
    const uint32_t sK = sKV + st * Sh::kStageBytes;
    mbar_wait(full_k(st), (i / kWgStages) & 1);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kWgRows * 128 + (kk % 4) * 32;
      const uint64_t da = sw128_desc(sQw + off, 16, kAtom);
      const uint64_t db = sw128_desc(sK + (kk / 4) * kWgKeys * 128 + (kk % 4) * 32, 16, kAtom);
      if (kk == 0)
        wgmma_ss_m64n128_zero(s, da, db);
      else
        wgmma_ss_m64n128(s, da, db);
    }
    wgmma_commit();
  };

  // Online softmax of k-tile i, in place: scores into log2 units, masked
  // only on the last k-tile (the diagonal when causal, the ragged Sk edge
  // otherwise), new running max, p = exp2(s - m) in fp32, row sums, and the
  // rescale alpha that acc takes before this tile's P V
  auto softmax = [&](int i) {
    const int k0 = i * kWgKeys;
    const bool masked = i == n_k - 1 && (causal || k_end % kWgKeys != 0);
    float mx0 = kNegInf, mx1 = kNegInf;
    if (masked) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j * 8 + 2 * t + e;
          const bool ok0 = col < Sk && (!causal || col <= row0);
          const bool ok1 = col < Sk && (!causal || col <= row1);
          s[4 * j + e] = ok0 ? s[4 * j + e] * scale_log2 : kNegInf;
          s[4 * j + 2 + e] = ok1 ? s[4 * j + 2 + e] * scale_log2 : kNegInf;
          mx0 = fmaxf(mx0, s[4 * j + e]);
          mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] *= scale_log2;
          s[4 * j + 2 + e] *= scale_log2;
          mx0 = fmaxf(mx0, s[4 * j + e]);
          mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = exp2f(m0 - mn0);
    alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
    if (masked) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a masked score is kNegInf: its probability is exactly 0
          s[4 * j + e] = s[4 * j + e] == kNegInf ? 0.0f : exp2f(s[4 * j + e] - mn0);
          s[4 * j + 2 + e] = s[4 * j + 2 + e] == kNegInf ? 0.0f : exp2f(s[4 * j + 2 + e] - mn1);
          sum0 += s[4 * j + e];
          sum1 += s[4 * j + 2 + e];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = exp2f(s[4 * j + e] - mn0);
          s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn1);
          sum0 += s[4 * j + e];
          sum1 += s[4 * j + 2 + e];
        }
      }
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
  };

  // the S accumulators of key columns 16 kt .. 16 kt + 15 are the A
  // fragment of k-step kt, rounded to bf16 as the reference rounds p
  auto pack = [&]() {
#pragma unroll
    for (int kt = 0; kt < kWgKeys / 16; ++kt) {
      pa[kt][0] = pack_bf16(s[8 * kt + 0], s[8 * kt + 1]);
      pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
  };

  // O = alpha O + P V of k-tile i, V read MN-major (dv contiguous) from its
  // TMA tile: issued and committed, not waited for.  acc and P are final
  // before the iteration's first wgmma (the caller fences), so no other
  // instruction touches an accumulator while one runs.
  auto rescale = [&]() {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[4 * n + 0] *= alpha0;
      acc[4 * n + 1] *= alpha0;
      acc[4 * n + 2] *= alpha1;
      acc[4 * n + 3] *= alpha1;
    }
    fence_regs(acc);
  };
  auto issue_pv = [&](int i) {
    const int st = i % kWgStages;
    const uint32_t sV = sKV + st * Sh::kStageBytes + Sh::kKBytes;
    mbar_wait(full_v(st), (i / kWgStages) & 1);
    __syncwarp();
#pragma unroll
    for (int kt = 0; kt < kWgKeys / 16; ++kt)
      wgmma_rs<DV>(acc, pa[kt], sw128_desc(sV + kt * 16 * 128, kWgKeys * 128, kAtom));
    wgmma_commit();
  };

  // The two warpgroups take turns to issue their wgmma batches (named
  // barriers 1 + wg), so one's softmax overlaps the other's products.
  auto my_turn = [&]() { bar_sync(1 + wg, kWgConsumers); };
  auto your_turn = [&]() { bar_arrive(2 - wg, kWgConsumers); };
  if (wg == 1) bar_arrive(1, kWgConsumers);  // warpgroup 0 goes first

  mbar_wait(full_q, 0);
  __syncwarp();
  my_turn();
  wgmma_fence();
  issue_qk(0);
  your_turn();
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  pack();
  // every k-tile but the last: S of tile i + 1, then P V of tile i; the
  // softmax of i + 1 runs while P V of i is on the tensor cores
  for (int i = 0; i + 1 < n_k; ++i) {
    rescale();
    my_turn();
    wgmma_fence();
    issue_qk(i + 1);
    issue_pv(i);
    your_turn();
    wgmma_wait<1>();  // S of tile i + 1 is done (groups retire in order)
    fence_regs(s);
    softmax(i + 1);
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(i % kWgStages));
    pack();
  }
  rescale();
  my_turn();
  wgmma_fence();
  issue_pv(n_k - 1);
  your_turn();
  wgmma_wait<0>();
  fence_regs(acc);

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
  for (int n = 0; n < DV / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)row0 * DV + col) =
          pack_bf16(acc[4 * n + 0] / l0, acc[4 * n + 1] / l0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)row1 * DV + col) =
          pack_bf16(acc[4 * n + 2] / l1, acc[4 * n + 3] / l1);
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query: nothing links against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (heads, rows, cols) bf16 tensor as a 3-D TMA map of {64, 128, 1} boxes in
// the 128-byte swizzle.  Rows past `rows` read as zeros inside each head: a
// box never reaches into the next head.
cudaError_t encode_3d(CUtensorMap* map, const void* ptr, int heads, int rows, int cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {kHalf, kWgRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int BHq, int Sq,
                         int Sk, int group, int causal, cudaStream_t stream) {
  static_assert(kWgRows == kWgKeys, "q and k maps share one box");
  constexpr int smem = WgShape<D, DV>::kSmem;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_3d(&tq, q, BHq, Sq, D);
  if (err == cudaSuccess) err = encode_3d(&tk, k, BHq / group, Sk, D);
  if (err == cudaSuccess) err = encode_3d(&tv, v, BHq / group, Sk, DV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attn_wgmma<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BHq, (Sq + kWgRows - 1) / kWgRows);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  flash_attn_wgmma<D, DV><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, group, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Which kernel a call takes: 1 = flash_attn_wgmma, 0 = flash_attn_simple
// (dtype 0 = float32, 1 = bfloat16).
extern "C" int repro_flash_attention_variant(int dtype, int d, int dv) {
  return dtype == 1 && ((d == 128 && dv == 128) || (d == 64 && dv == 64) ||
                        (d == 192 && dv == 128));
}

// q (BHq, Sq, d), k (BHq / group, Sk, d), v (BHq / group, Sk, dv), o (BHq, Sq, dv),
// all contiguous, 16-byte aligned, of one type: dtype 0 = float32, 1 = bfloat16.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int BHq, int Sq, int Sk, int d, int dv, int group,
                                     int causal, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (BHq <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (repro_flash_attention_variant(dtype, d, dv)) {
    if (d == 64) return (int)launch_wgmma<64, 64>(q, k, v, o, BHq, Sq, Sk, group, causal, stream);
    if (d == 128)
      return (int)launch_wgmma<128, 128>(q, k, v, o, BHq, Sq, Sk, group, causal, stream);
    return (int)launch_wgmma<192, 128>(q, k, v, o, BHq, Sq, Sk, group, causal, stream);
  }
  if (d > 256 || dv > 32 * kSimpleMaxCols) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_simple<float>(q, k, v, o, BHq, Sq, Sk, d, dv, group, causal, stream);
  if (dtype == 1)
    return (int)launch_simple<__nv_bfloat16>(q, k, v, o, BHq, Sq, Sk, d, dv, group, causal,
                                             stream);
  return (int)cudaErrorInvalidValue;
}
