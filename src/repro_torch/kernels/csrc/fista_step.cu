// One FISTA step of the l1-penalized squared-hinge linear SVM head
// (LinearSVM, src/repro_torch/core/svm.py) in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this loop as a
// lax.while_loop that XLA fuses (src/repro/core/svm.py, _fista).  The port's
// eager step issues ~54 launches, more than the host issues in the time the
// card runs them, and reads X twice through skinny GEMMs and a chain of
// (m, k) temporaries; this kernel is one launch and one pass over X a step.
//
// The step, on the state buffer (float32: W (p x k) | b (k) | Wz (p x k) |
// bz (k) | t | delta) and the step count i (int32):
//     live   = i < max_iter and delta > tol        (else: return, no byte moves)
//     s      = X Wz + bz,  y_c = +1 if label == c else -1   (one-vs-rest, so
//              the class index gives the +-1 matrix Y bit for bit)
//     g      = (-2/m) * max(0, 1 - y s) * y,   gW = X^T g,   gb = sum_rows g
//     W'     = sign(u) max(|u| - step lam, 0),  u = Wz - step gW;  b' = bz - step gb
//     t'     = (1 + sqrt(1 + 4 t t)) / 2,  beta = (t - 1) / t'
//     Wz'    = W' + beta (W' - W),  bz' likewise
//     delta' = max|W' - W| + max|b' - b|,  i' = i + 1
// The update's float32 operations are the eager step's, in its order and
// without contraction (__f*_rn), so only the gradient's summation order
// differs from the plain version.
//
// What bounds it on the H100: bytes.  X is read once, 4 p bytes a row, and one
// byte of class index a row: m (4 p + 1) bytes, 58.8 MB at m = 1,200,000 and
// p = 12, 17.6 us at 3.35 TB/s.  The arithmetic (~4 m p k flops) is ~0.1 GFLOP.
//
// What the design does about it:
//   * Persistent grid: G = SMs x resident blocks, each warp on its own: warp w
//     of the grid takes the 32-row warp tiles w, w + 8 G, ...  A warp tile is
//     contiguous in X, so the warp copies it to shared memory with 16-byte
//     cp.async (lane l takes chunks l, l + 32, ...), S - 1 tiles ahead of the
//     one it computes, in a ring of its own: no block barrier in the loop.
//   * Each lane computes its row: the k scores (Wz and bz broadcast from
//     shared memory), the squared-hinge factors, and x_j g_c and g_c
//     accumulated in registers: acc[KB][PB], compile-time buckets of k and p
//     (below).
//   * The block reduces its accumulators in a fixed order (each warp's lanes in
//     turn through shared memory, then the warps in turn) into
//     partials[v * G + block].
//   * The last block to finish (a __threadfence() and an atomic ticket, which it
//     resets for the next launch) sums each value's partials in float64 in an
//     order fixed by G, and does the update above in one warp.  No float
//     atomics: the bits depend on G (the card's SM count) and not on which
//     block finishes last, so a step is deterministic.
//   * Steps after the first of a call are programmatic dependent launches: a
//     step issues its first tiles of X before griddepcontrol.wait, while the
//     step before it finishes its last block; it reads the state after.
//
// Instantiations: p rounded up to PB in {4, 8, 16, 32}, k to KB in {2, 4, 8},
// PB * KB <= 64 (kAccLimit): k = 2 up to p = 32, k <= 4 up to p = 16, k <= 8
// up to p = 8.  Wider heads keep the eager step (core/svm.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAccLimit = 64;

// warp tiles a warp's ring holds: S - 1 in flight ahead of the one it
// computes (fewer for the widest rows, to keep a block's ring under 227 KB)
__host__ __device__ constexpr int stages(int pb) { return pb <= 16 ? 6 : 4; }
// a stage: a warp tile's 32 rows of p floats, then its 32 class bytes
__host__ __device__ constexpr long long stage_bytes(int p) { return 128LL * p + 32; }
// the dynamic shared memory: the warps' rings, which the block's reduction
// takes over after the loop (KB (PB + 1) values x kWarps x 33 floats)
__host__ __device__ constexpr long long ring_bytes(int pb, int kb, int p) {
  const long long rings = (long long)kWarps * stages(pb) * stage_bytes(p);
  const long long red = 4LL * kb * (pb + 1) * kWarps * 33;
  return rings > red ? rings : red;
}

struct FistaArgs {
  const float* X;
  const int8_t* labels;
  float* state;
  int* iters;
  float* partials;
  unsigned int* ticket;
  const float* step;
  const float* lam;
  const float* tol;
  long long m;
  int p;
  int k;
  int max_iter;
  float coef;  // float32(-2 / m), as the eager step's scalar
};

// torch.max's rule: a NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes to shared memory, of which the first `bytes` from gmem (the rest zero)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Warp tile wt (rows 32 wt ..) into a stage: its 32 p floats are contiguous in
// X and 16-byte aligned, so lane l copies 16-byte chunks l, l + 32, ...; lanes
// 0 and 1 copy its class bytes.  Past the last row the stage holds zeros.
template <int PB>
__device__ __forceinline__ void issue_tile(const FistaArgs& a, long long wt, char* stage,
                                           int lane) {
  const int p = a.p;
  const long long row0 = wt * 32;
  const int rows = a.m - row0 < 32 ? (int)(a.m - row0) : 32;
  const int floats = rows * p;
  const float* src = a.X + row0 * p;
  float* dst = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int q = 0; q < PB / 4; ++q) {
    const int c = 4 * (q * 32 + lane);  // the chunk's first float
    if (c < 32 * p) {
      const int left = floats - c;
      cp_async16(dst + c, left > 0 ? src + c : a.X, left >= 4 ? 16 : (left > 0 ? 4 * left : 0));
    }
  }
  if (lane < 2) {
    const int left = rows - 16 * lane;
    cp_async16(stage + 128 * p + 16 * lane, left > 0 ? a.labels + row0 + 16 * lane : a.labels,
               left >= 16 ? 16 : (left > 0 ? left : 0));
  }
}

template <int PB, int KB>
__global__ void __launch_bounds__(kThreads, (PB * KB >= kAccLimit) ? 1 : 2)
fista_step_kernel(FistaArgs a) {
  constexpr int S = stages(PB);
  // each warp's ring of S stages
  extern __shared__ __align__(16) char ring[];
  __shared__ float s_wz[KB][PB];
  __shared__ float s_bz[KB];
  __shared__ float s_red[kWarps][KB * (PB + 1)];
  __shared__ float s_grad[KB * (PB + 1)];
  __shared__ int s_last;

  // the next step may start its loads of X while this one ends
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const int p = a.p, k = a.k, pk = p * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m = a.m;
  const long long wtiles = (m + 31) / 32;
  const long long nw = (long long)gridDim.x * kWarps;  // warps of the grid
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  char* my = ring + (long long)warp * S * stage_bytes(p);

  // X does not depend on the state: the first tiles are in flight before the
  // step before this one has ended
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    const long long wt = gw + st * nw;
    if (wt < wtiles) issue_tile<PB>(a, wt, my + st * stage_bytes(p), lane);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");

  float* W = a.state;
  float* b = W + pk;
  float* Wz = b + k;
  float* bz = Wz + pk;
  float* t_ptr = bz + k;
  float* delta_ptr = t_ptr + 1;
  // one round trip: the stop test's inputs and this thread's entry of Wz, bz
  const int i = *a.iters;
  const float delta = *delta_ptr, tol = *a.tol;
  const int wc = tid / PB, wj = tid % PB;
  const float wz = tid < KB * PB && wc < k && wj < p ? Wz[wj * k + wc] : 0.f;
  const float bzc = tid < k ? bz[tid] : 0.f;
  if (!(i < a.max_iter && delta > tol)) {  // a step past the stop
    cp_async_wait<0>();
    return;
  }
  if (tid < KB * PB) s_wz[wc][wj] = wz;
  if (tid < KB) s_bz[tid] = bzc;
  __syncthreads();

  float acc[KB][PB];
  float accb[KB];
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    accb[c] = 0.f;
#pragma unroll
    for (int j = 0; j < PB; ++j) acc[c][j] = 0.f;
  }

  int st = 0;
  for (long long wt = gw; wt < wtiles; wt += nw, st = st + 1 == S ? 0 : st + 1) {
    // S - 1 tiles ahead, into the stage the last tile left
    const long long ahead = wt + (S - 1) * nw;
    if (ahead < wtiles)
      issue_tile<PB>(a, ahead, my + (st == 0 ? S - 1 : st - 1) * stage_bytes(p), lane);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncwarp();  // every lane's chunks of this tile are in
    const char* stage = my + st * stage_bytes(p);
    if (wt * 32 + lane < m) {
      const float* row = reinterpret_cast<const float*>(stage) + lane * p;
      float x[PB];
      if ((p & 3) == 0) {  // 16-byte rows; for p / 4 odd no bank conflicts
#pragma unroll
        for (int q = 0; q < PB / 4; ++q) {
          const float4 v = 4 * q < p ? reinterpret_cast<const float4*>(row)[q]
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
          x[4 * q] = v.x;
          x[4 * q + 1] = v.y;
          x[4 * q + 2] = v.z;
          x[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < PB; ++j) x[j] = j < p ? row[j] : 0.f;
      }
      const int lab = reinterpret_cast<const int8_t*>(stage + 128 * p)[lane];
#pragma unroll
      for (int c = 0; c < KB; ++c) {
        if (c < k) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < PB; ++j)
            if (j < p) s = fmaf(x[j], s_wz[c][j], s);
          s = __fadd_rn(s, s_bz[c]);
          const float y = lab == c ? 1.f : -1.f;
          float act = __fsub_rn(1.f, __fmul_rn(y, s));
          act = act < 0.f ? 0.f : act;
          const float g = __fmul_rn(a.coef, __fmul_rn(act, y));
#pragma unroll
          for (int j = 0; j < PB; ++j)
            if (j < p) acc[c][j] = fmaf(x[j], g, acc[c][j]);
          accb[c] = __fadd_rn(accb[c], g);
        }
      }
    }
    __syncwarp();  // the stage is read before it is refilled
  }
  cp_async_wait<0>();

  // The block's partials, in a fixed order: each value's 32 lanes of each warp
  // in turn, then the warps in turn.  The ring is free now: it holds every
  // lane's values, a warp's 32 of one value at a stride of 33 floats (no bank
  // conflicts on either side).
  constexpr int VC = KB * (PB + 1);
  __syncthreads();  // every warp is out of its ring
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int c = 0; c < KB; ++c) {
#pragma unroll
    for (int j = 0; j < PB; ++j) red[((c * PB + j) * kWarps + warp) * 33 + lane] = acc[c][j];
    red[((KB * PB + c) * kWarps + warp) * 33 + lane] = accb[c];
  }
  __syncthreads();
  for (int task = tid; task < VC * kWarps; task += kThreads) {
    const int e = task / kWarps;
    const bool is_b = e >= KB * PB;
    if ((is_b ? e - KB * PB : e / PB) < k && (is_b || e % PB < p)) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < 32; ++l) s = __fadd_rn(s, red[task * 33 + l]);
      s_red[task % kWarps][e] = s;
    }
  }
  __syncthreads();
  const int G = gridDim.x;
  for (int e = tid; e < VC; e += kThreads) {
    const bool is_b = e >= KB * PB;
    const int c = is_b ? e - KB * PB : e / PB, j = is_b ? 0 : e % PB;
    if (c < k && j < p) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, s_red[w][e]);
      const int vi = is_b ? pk + c : j * k + c;
      a.partials[(long long)vi * G + blockIdx.x] = s;
    }
  }

  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.ticket, 1u) == (unsigned int)(G - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The last block.  Warp 0 reads what the update needs while the partials
  // come in.  Each value's partials are summed in float64 by a group of gs
  // lanes (lane l of the group sums blocks l, l + gs, ... in turn, then a
  // shuffle tree): an order fixed by V and G alone.
  const int V = pk + k;
  float w_old[2] = {0.f, 0.f}, wz_old[2] = {0.f, 0.f}, b_old = 0.f, bz_old = 0.f, t = 0.f, step = 0.f, sl = 0.f;
  if (warp == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      w_old[h] = e < pk ? W[e] : 0.f;
      wz_old[h] = e < pk ? Wz[e] : 0.f;
    }
    if (lane < k) {
      b_old = b[lane];
      bz_old = bz[lane];
    }
    t = *t_ptr;
    step = *a.step;
    sl = __fmul_rn(step, *a.lam);
  }
  int gs = 32;
  while (gs > 1 && V * gs > kThreads) gs >>= 1;
  constexpr int kBatch = 48;  // loads a lane has in flight
  for (int base = 0; base < V; base += kThreads / gs) {
    const int vi = base + tid / gs, l = tid % gs;
    double s = 0.0;
    if (vi < V) {
      const float* part = a.partials + (long long)vi * G;
      for (int g0 = l; g0 < G; g0 += kBatch * gs) {
        float v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int g = g0 + q * gs;
          v[q] = g < G ? __ldcg(part + g) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) s += (double)v[q];
      }
    }
    for (int o = gs / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (vi < V && l == 0) s_grad[vi] = (float)s;
  }
  __syncthreads();

  if (warp == 0) {
    const float t_new = __fmul_rn(
        0.5f, __fadd_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(__fmul_rn(4.f, t), t)))));
    const float beta = __fdiv_rn(__fsub_rn(t, 1.f), t_new);
    float dw = 0.f, db = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      if (e < pk) {
        const float u = __fsub_rn(wz_old[h], __fmul_rn(step, s_grad[e]));
        float shrunk = __fsub_rn(fabsf(u), sl);
        shrunk = shrunk < 0.f ? 0.f : shrunk;
        const float w_new = __fmul_rn((float)((u > 0.f) - (u < 0.f)), shrunk);
        const float diff = __fsub_rn(w_new, w_old[h]);
        W[e] = w_new;
        Wz[e] = __fadd_rn(w_new, __fmul_rn(beta, diff));
        dw = nan_max(dw, fabsf(diff));
      }
    }
    if (lane < k) {
      const float b_new = __fsub_rn(bz_old, __fmul_rn(step, s_grad[pk + lane]));
      const float diff = __fsub_rn(b_new, b_old);
      b[lane] = b_new;
      bz[lane] = __fadd_rn(b_new, __fmul_rn(beta, diff));
      db = nan_max(db, fabsf(diff));
    }
    dw = warp_max(dw);
    db = warp_max(db);
    if (lane == 0) {
      *t_ptr = t_new;
      *delta_ptr = __fadd_rn(dw, db);
      *a.iters = i + 1;
      *a.ticket = 0u;
    }
  }
}

int bucket_p(int p) { return p < 1 ? 0 : p <= 4 ? 4 : p <= 8 ? 8 : p <= 16 ? 16 : p <= 32 ? 32 : 0; }
int bucket_k(int k) { return k < 1 ? 0 : k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : 0; }

int variant(int p, int k) {
  const int pb = bucket_p(p), kb = bucket_k(k);
  return (pb && kb && pb * kb <= kAccLimit) ? pb * 100 + kb : 0;
}

#define FISTA_VARIANTS(X) X(4, 2) X(8, 2) X(16, 2) X(32, 2) X(4, 4) X(8, 4) X(16, 4) X(4, 8) X(8, 8)

// the ring may take more than the 48 KB a block has without asking
template <int PB, int KB>
cudaError_t allow_ring(int p) {
  return cudaFuncSetAttribute(fista_step_kernel<PB, KB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)ring_bytes(PB, KB, p));
}

template <int PB, int KB>
cudaError_t grid_of(long long m, int p, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_ring<PB, KB>(p);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fista_step_kernel<PB, KB>,
                                                        kThreads, (size_t)ring_bytes(PB, KB, p));
  if (err != cudaSuccess) return err;
  const long long blocks = (m + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(blocks < cap ? blocks : cap);
  return cudaSuccess;
}

// The first step of a call waits for all the stream ran before it (which may
// have written X); each later one is launched as a programmatic dependent of
// the step before it, so that its first loads of X overlap that step's end
// (its state is read after griddepcontrol.wait).
template <int PB, int KB>
cudaError_t launch(const FistaArgs& a, int grid, int steps, cudaStream_t stream) {
  cudaError_t err = allow_ring<PB, KB>(a.p);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)ring_bytes(PB, KB, a.p);
  cfg.stream = stream;
  for (int s = 0; s < steps; ++s) {
    cfg.attrs = s == 0 ? nullptr : &overlap;
    cfg.numAttrs = s == 0 ? 0 : 1;
    err = cudaLaunchKernelEx(&cfg, fista_step_kernel<PB, KB>, a);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The instantiation (PB * 100 + KB) that takes a head of p features and k
// classes, or 0 where none does (the eager step's).
extern "C" int repro_fista_variant(int p, int k) { return variant(p, k); }

// Blocks of one launch over m rows: min(row tiles, SMs x resident blocks).
// 0 where no instantiation takes (p, k) or the card cannot be queried.
extern "C" int repro_fista_grid(long long m, int p, int k) {
  int grid = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (variant(p, k)) {
#define FISTA_GRID(PB, KB) \
  case PB * 100 + KB:      \
    err = grid_of<PB, KB>(m, p, &grid); \
    break;
    FISTA_VARIANTS(FISTA_GRID)
#undef FISTA_GRID
    default:
      break;
  }
  return err == cudaSuccess ? grid : 0;
}

// `steps` launches of the step on `stream`, each checked as it is issued.
// partials holds (p k + k) x grid floats; ticket one zeroed uint32.
extern "C" int repro_fista_steps(const float* X, const signed char* labels, float* state,
                                 int* iters, float* partials, unsigned int* ticket,
                                 const float* step, const float* lam, const float* tol,
                                 long long m, int p, int k, int max_iter, float coef, int grid,
                                 int steps, cudaStream_t stream) {
  if (m < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  const FistaArgs a{X, reinterpret_cast<const int8_t*>(labels), state, iters, partials, ticket,
                    step, lam, tol, m, p, k, max_iter, coef};
  switch (variant(p, k)) {
#define FISTA_LAUNCH(PB, KB) \
  case PB * 100 + KB:        \
    return (int)launch<PB, KB>(a, grid, steps, stream);
    FISTA_VARIANTS(FISTA_LAUNCH)
#undef FISTA_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}
