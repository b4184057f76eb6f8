// Theorem 4.9 block-inverse update of Inverse Hessian Boosting, and the OAVI
// candidate loop of one degree built on it.
//
// Replaces the Pallas TPU kernel `ihb_update` (_ihb_kernel) of
// src/repro/kernels/ihb_update.py.  Given the padded inverse N (L x L, the
// identity beyond the active block), the new column's Gram vector q (zero
// from slot ell on) and its squared norm btb, the update is
//     u = N q,   s = max(btb - sum(q * u), 1e-30),
//     N' = N + u u^T / s,  then row and column ell := -u / s, (ell, ell) := 1/s.
// With the identity padding and q's zeros, every entry outside the leading
// (ell+1) x (ell+1) block comes out equal to N's (x + (0 * 0) / s == x, and
// the new row and column are +0 beyond ell), so only that block is read and
// written: entries past ell are never touched and stay bit-exact.
//
// Two entry points, both one cooperative persistent launch (at most one block
// per SM, every block co-resident):
//
//   repro_ihb_update  one update.  btb, ell and the optional `active` flag are
//       read from device memory; with *active == 0 every block returns after
//       reading the flag and no byte of N moves.  N_in and N_out may alias
//       (the fit updates in place).
//   repro_ihb_degree  the fast engine's candidate loop of one degree
//       (src/repro/core/oavi.py, _make_stats_degree_step, engine='fast',
//       inverse_engine='inverse'): for a = 0..K-1, q = QL[:, a] plus C[j, a]
//       at the slots of the candidates j < a appended earlier, btb = C[a, a],
//       u = N q, mse = btb - sum(q * u) (= btb + q . y with y = -u on the
//       active block), accept = mse <= psi, and on reject the update above at
//       slot ell, ell += 1.  N is updated in place; the decisions, mses,
//       coefficients (-u when accepted), slots and the final ell are written
//       for the host, which reads them once per degree.
//
// What bounds it on the H100: latency.  The bytes are the active block, read
// once and written once: at most 2 (ell+1)^2 * 4 bytes, 33 MB at ell = 2047,
// 10 us at 3.35 TB/s; at the OAVI sizes it is far less.  The dependence chain
// is the limit: u needs every active row of N before any row can be
// rewritten, and in the degree loop candidate a + 1 needs N after candidate
// a's update.
//
// What the design does about it:
//   * Row i of N belongs to block i % G for the whole launch (cyclic, so the
//     rows of a small active block spread over many SMs).  A block reads and
//     writes only its own rows, so the only data that crosses blocks is u.
//     One grid barrier per update: each block writes u for its rows, the
//     barrier, then each block reads all of u, reduces sum(q * u) in one fixed
//     order (the same bits in every block, so every block takes the same
//     branch; no atomics anywhere) and updates its own rows.  The next
//     candidate's matvec reads rows that only this block wrote, so it needs
//     no barrier; u is double-buffered so that a fast block writing the next
//     candidate's u never overwrites what a slow block still reads.
//   * Where a block's rows fit its shared memory (always at Lcap <= 2048 on
//     the H100) they are staged there: the degree loop reads the initial
//     active block from device memory once and writes the final one once;
//     the single update reads each active row once.  Otherwise the rows are
//     read and written in device memory (L2) in place.
//   * Dot products: one warp per row, lane-strided FMAs and a fixed shuffle
//     tree (deterministic).
//
// A class axis (the class-batched fit, src/repro/core/class_batch.py, where
// the reference vmaps ihb_update): both entry points take `lanes`
// independent problems laid out lane after lane (N, q, u and the outputs at
// fixed strides; btb, ell, active, ell0 and K one per lane) and run them in
// ONE cooperative launch: lane c owns blocks [c G, (c + 1) G), and its rows
// are dealt to those G blocks as above.  No bit depends on G (one warp per
// row, the fixed shuffle tree, one fixed order for sum(q * u)), so a lane of
// a batched launch, with fewer blocks and perhaps an unstaged band, gives the
// bits of a one-lane launch.  The lanes share the grid barrier: a gated-off
// lane of the update, and a lane whose candidates are used up in the degree
// loop, meets the barriers and does nothing else (no byte of its N moves).
// The one-lane call is lanes = 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows a block is given at least before another block joins the grid
constexpr int kMinRowsPerBlock = 8;
constexpr int kMaxDevices = 64;

struct Band {
  float* smem;    // staged rows (local index k = i / G), or null
  int ld_s;       // row stride of the staged rows
  float* global;  // N in device memory
  int L;          // row stride of N
  int b, G;       // this block, grid size

  __device__ float* row(int i) const {
    return smem ? smem + (size_t)(i / G) * ld_s : global + (size_t)i * L;
  }
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  return s;  // lane 0 holds the sum
}

// u[i] = sum_{j < ell} row_i[j] q[j] for the block's rows i < ell.
__device__ void band_matvec(const Band& band, const float* q_s, int ell,
                            float* u_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = band.b + warp * band.G; i < ell; i += kWarps * band.G) {
    const float* r = band.row(i);
    float acc = 0.0f;
    for (int j = lane; j < ell; j += 32) acc = __fmaf_rn(r[j], q_s[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) u_out[i] = acc;
  }
}

// u_s[0..ell) := u (written by every block before the grid barrier) and
// returns sum_{i < ell} q_i u_i, reduced in one fixed order: the same bits in
// every block.  u is read through L2 (__ldcg): L1 is not coherent across SMs.
__device__ float gather_u_and_reduce(const float* u, const float* q_s,
                                     float* u_s, float* red, int ell) {
  float part = 0.0f;
  for (int i = threadIdx.x; i < ell; i += kThreads) {
    const float ui = __ldcg(u + i);
    u_s[i] = ui;
    part = __fadd_rn(part, __fmul_rn(q_s[i], ui));
  }
  part = warp_sum(part);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = part;
  __syncthreads();
  float total = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total = __fadd_rn(total, red[w]);
  __syncthreads();  // red is reused by the next call
  return total;
}

// The rank-1 update of the block's rows at slot ell, from u_s[0..ell) and s:
// rows i < ell read from `src` and written to `dst` (which may be the same
// rows), row ell written whole.  The roundings are the reference's:
// N + (u_i u_j) / s, and -u / s + 0 on the new row and column (the +0 turns a
// -0 into +0, as `n2 * keep + onehot / s` does).
__device__ void band_rank1(const Band& src, const Band& dst, const float* u_s,
                           float s, int ell) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = src.b + warp * src.G; i <= ell; i += kWarps * src.G) {
    float* w = dst.row(i);
    if (i == ell) {
      for (int j = lane; j < ell; j += 32)
        w[j] = __fadd_rn(__fdiv_rn(-u_s[j], s), 0.0f);
      if (lane == 0) w[ell] = __fdiv_rn(1.0f, s);
      continue;
    }
    const float* r = src.row(i);
    const float ui = u_s[i];
    for (int j = lane; j < ell; j += 32)
      w[j] = __fadd_rn(r[j], __fdiv_rn(__fmul_rn(ui, u_s[j]), s));
    if (lane == 0) w[ell] = __fadd_rn(__fdiv_rn(-ui, s), 0.0f);
  }
}

// Copies rows i < nrows, columns j < ncols of the block's rows between N and
// the staged band.
__device__ void band_copy(const Band& band, int nrows, int ncols, bool to_smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = band.b + warp * band.G; i < nrows; i += kWarps * band.G) {
    float* s = band.smem + (size_t)(i / band.G) * band.ld_s;
    float* g = band.global + (size_t)i * band.L;
    if (to_smem)
      for (int j = lane; j < ncols; j += 32) s[j] = g[j];
    else
      for (int j = lane; j < ncols; j += 32) g[j] = s[j];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ihb_update_kernel(const float* N_in, float* N_out, const float* __restrict__ q,
                  const float* __restrict__ btb_p, const int* __restrict__ ell_p,
                  const unsigned char* __restrict__ active, float* u, int L, int G,
                  int staged, int ld_s) {
  cg::grid_group grid = cg::this_grid();
  const int cls = blockIdx.x / G, b = blockIdx.x % G;
  if (active != nullptr && active[cls] == 0) {
    // no byte moves; beside other lanes the blocks still meet the barrier
    if ((int)gridDim.x != G) grid.sync();
    return;
  }
  const size_t LL = (size_t)L * L;
  N_in += cls * LL;
  N_out += cls * LL;
  q += (size_t)cls * L;
  u += (size_t)cls * L;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ell = ell_p[cls];
  float* q_s = smem;
  float* u_s = q_s + L;
  float* red = u_s + L;
  float* rows = red + kWarps;
  for (int j = threadIdx.x; j < ell; j += kThreads) q_s[j] = q[j];
  Band in{staged ? rows : nullptr, ld_s, const_cast<float*>(N_in), L, b, G};
  if (staged) band_copy(in, ell, ell, true);
  __syncthreads();
  band_matvec(in, q_s, ell, u);
  grid.sync();
  const float S = gather_u_and_reduce(u, q_s, u_s, red, ell);
  const float s = fmaxf(__fsub_rn(btb_p[cls], S), 1e-30f);
  Band out{nullptr, 0, N_out, L, b, G};
  band_rank1(in, out, u_s, s, ell);
}

// Per-lane parameters of one degree-loop launch, passed by value.
constexpr int kMaxLanes = 64;
struct DegreeLanes {
  int ell0[kMaxLanes];
  int K[kMaxLanes];
  int staged[kMaxLanes];
  int ld_s[kMaxLanes];
};

__global__ void __launch_bounds__(kThreads, 1)
ihb_degree_kernel(const float* __restrict__ QLt, const float* __restrict__ C,
                  float* N, int Lcap, int Kcap, int Kmax, int kstride, float psi,
                  unsigned char* __restrict__ accepted, float* __restrict__ mses,
                  float* __restrict__ coeffs, long long* __restrict__ slots,
                  int* __restrict__ ell_out, float* ubuf, int G, DegreeLanes lanes) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int cls = blockIdx.x / G, b = blockIdx.x % G;
  // this lane's parameters, read at constant indices (a dynamic index into
  // the parameter struct would copy it to local memory)
  int ell0 = 0, K = 0, staged = 0, ld_s = 0;
#pragma unroll
  for (int c = 0; c < kMaxLanes; ++c) {
    if (c == cls) {
      ell0 = lanes.ell0[c];
      K = lanes.K[c];
      staged = lanes.staged[c];
      ld_s = lanes.ld_s[c];
    }
  }
  const int ell_max = ell0 + K;
  QLt += (size_t)cls * Kcap * Lcap;
  C += (size_t)cls * Kcap * Kcap;
  N += (size_t)cls * Lcap * Lcap;
  accepted += (size_t)cls * kstride;
  mses += (size_t)cls * kstride;
  coeffs += (size_t)cls * kstride * Lcap;
  slots += (size_t)cls * kstride;
  ubuf += (size_t)cls * 2 * Lcap;
  float* q_s = smem;
  float* u_s = q_s + ell_max;
  float* red = u_s + ell_max;
  int* owner = reinterpret_cast<int*>(red + kWarps);  // slot - ell0 -> candidate
  float* rows = reinterpret_cast<float*>(owner + K);
  Band band{staged ? rows : nullptr, ld_s, N, Lcap, b, G};
  if (staged) band_copy(band, ell0, ell0, true);
  int ell = ell0;
  for (int a = 0; a < Kmax; ++a) {
    // a lane whose candidates are used up meets the barrier and idles
    const bool live = a < K;
    float* u = ubuf + (a & 1) * Lcap;
    if (live) {
      const float* qa = QLt + (size_t)a * Lcap;
      for (int j = threadIdx.x; j < ell; j += kThreads) {
        float v = qa[j];
        if (j >= ell0) v = __fadd_rn(v, C[(size_t)owner[j - ell0] * Kcap + a]);
        q_s[j] = v;
      }
      __syncthreads();
      band_matvec(band, q_s, ell, u);
    }
    grid.sync();
    if (!live) continue;
    const float S = gather_u_and_reduce(u, q_s, u_s, red, ell);
    const float mse = __fsub_rn(C[(size_t)a * Kcap + a], S);
    const bool accept = mse <= psi;
    if (b == 0 && threadIdx.x == 0) {
      accepted[a] = accept;
      mses[a] = mse;
      slots[a] = accept ? Lcap : ell;
    }
    if (accept) {
      // the generator's coefficients y = -u on the active block
      for (int i = b + threadIdx.x * G; i < ell; i += kThreads * G)
        coeffs[(size_t)a * Lcap + i] = -u_s[i];
    } else {
      band_rank1(band, band, u_s, fmaxf(mse, 1e-30f), ell);
      if (threadIdx.x == 0) owner[ell - ell0] = a;
      ++ell;
    }
    __syncthreads();  // q_s, u_s and owner are rewritten by the next candidate
  }
  if (staged) band_copy(band, ell, ell, false);
  if (b == 0 && threadIdx.x == 0) ell_out[cls] = ell;
}

struct DeviceInfo {
  int sms = 0;
  int max_smem = 0;          // per block, opt-in
  int set_update = 0;        // dynamic smem limit set on each kernel
  int set_degree = 0;
};
DeviceInfo g_info[kMaxDevices];

cudaError_t device_info(DeviceInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_info[dev];
  if (d.sms == 0) {
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&d.max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = &d;
  return cudaSuccess;
}

// Blocks for each of `lanes` lanes whose largest active block has `rows`
// rows: one block per kMinRowsPerBlock rows, at most sms / lanes.
int lane_blocks(const DeviceInfo& d, int rows, int lanes) {
  int g = (rows + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (g > d.sms / lanes) g = d.sms / lanes;
  return g < 1 ? 1 : g;
}

// Layout of a lane's staged band of `rows` rows over G blocks: whether it
// fits beside `fixed_bytes` (else the rows stay in device memory), its row
// stride, and the shared memory the lane needs.
void plan_band(const DeviceInfo& d, int rows, int G, size_t fixed_bytes, int* staged,
               int* ld_s, size_t* smem) {
  const int per_block = (rows + G - 1) / G;
  const size_t band = (size_t)per_block * rows * sizeof(float);
  *ld_s = rows;
  *staged = fixed_bytes + band <= (size_t)d.max_smem;
  *smem = fixed_bytes + (*staged ? band : 0);
}

// Shared memory of a degree-loop lane besides its band: q and u (rows each),
// the reduction slots and the owner of each appended slot (K), 16-byte
// rounded so the band that follows is aligned.
size_t degree_fixed_bytes(int rows, int K) {
  const size_t bytes = (2 * (size_t)rows + kWarps) * sizeof(float) + (size_t)K * sizeof(int);
  return (bytes + 15) / 16 * 16;
}

cudaError_t set_smem(const void* fn, int* current, size_t smem) {
  if ((int)smem <= *current || smem <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *current = (int)smem;
  return err;
}

}  // namespace

// Lanes one launch of either entry point takes at most (each lane needs a
// block of its own, every block co-resident); the caller splits more.
extern "C" int repro_ihb_max_lanes() {
  DeviceInfo* d = nullptr;
  if (device_info(&d) != cudaSuccess) return 1;
  return d->sms < kMaxLanes ? d->sms : kMaxLanes;
}

// The blocks a lane of a launch of `lanes` lanes with at most `rows` active
// rows is given (so a test can show a lane's G differs from a one-lane call's).
extern "C" int repro_ihb_lane_blocks(int rows, int lanes) {
  DeviceInfo* d = nullptr;
  if (device_info(&d) != cudaSuccess) return 0;
  return lane_blocks(*d, rows, lanes);
}

// Whether a lane of the degree loop stages its band in shared memory, for
// ell0 + K = rows, K candidates, in a launch of `lanes` lanes with at most
// `rows_max` active rows.
extern "C" int repro_ihb_degree_staged(int rows, int K, int rows_max, int lanes) {
  DeviceInfo* d = nullptr;
  if (device_info(&d) != cudaSuccess) return 0;
  int staged, ld_s;
  size_t smem;
  plan_band(*d, rows, lane_blocks(*d, rows_max, lanes), degree_fixed_bytes(rows, K), &staged,
            &ld_s, &smem);
  return K > 0 && staged;
}

// `lanes` Theorem 4.9 updates (see above), lane c on N + c L L, q + c L,
// btb[c], ell[c], active[c].  u_scratch holds lanes L floats.  active may be
// null (always update).  Returns the first CUDA error, or cudaSuccess; a grid
// that cannot be co-resident is an error (cudaErrorCooperativeLaunchTooLarge).
extern "C" int repro_ihb_update(const float* N_in, float* N_out, const float* q,
                                const float* btb, const int* ell,
                                const unsigned char* active, float* u_scratch,
                                int L, int lanes, cudaStream_t stream) {
  DeviceInfo* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 1 || lanes > repro_ihb_max_lanes()) return (int)cudaErrorInvalidValue;
  int G = lane_blocks(*d, L, lanes);
  int staged, ld_s;
  size_t smem;
  plan_band(*d, L, G, (2 * (size_t)L + kWarps) * sizeof(float), &staged, &ld_s, &smem);
  err = set_smem((const void*)ihb_update_kernel, &d->set_update, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&N_in, &N_out, &q, &btb, &ell, &active, &u_scratch, &L, &G,
                  &staged, &ld_s};
  err = cudaLaunchCooperativeKernel((const void*)ihb_update_kernel, dim3(G * lanes),
                                    dim3(kThreads), args, smem, stream);
  return (int)err;
}

// The candidate loop of one degree (see above) for `lanes` lanes: lane c
// starts from ell0s[c] active columns and runs Ks[c] candidates (0: it only
// meets the barriers).  QLt (Kcap x Lcap) and C (Kcap x Kcap) are a lane's
// normalized Gram blocks, QL transposed; N (Lcap x Lcap) is updated in place;
// the outputs are (kstride) and (kstride x Lcap) a lane, and ell_out
// one int a lane; kstride >= max Ks is the outputs' candidates a lane.
// Needs ell0s[c] >= 1 and ell0s[c] + Ks[c] <= Lcap.  coeffs must hold zeros;
// u_scratch holds 2 Lcap floats a lane.  ell0s and Ks are host arrays.
extern "C" int repro_ihb_degree(const float* QLt, const float* C, float* N,
                                int Lcap, int Kcap, const int* ell0s, const int* Ks,
                                int lanes, int kstride, float psi, unsigned char* accepted,
                                float* mses, float* coeffs, long long* slots, int* ell_out,
                                float* u_scratch, cudaStream_t stream) {
  DeviceInfo* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 1 || lanes > repro_ihb_max_lanes()) return (int)cudaErrorInvalidValue;
  DegreeLanes dl;
  int Kmax = 0, rows_max = 1;
  for (int c = 0; c < lanes; ++c) {
    if (ell0s[c] < 1 || Ks[c] < 0 || ell0s[c] + Ks[c] > Lcap || Ks[c] > Kcap)
      return (int)cudaErrorInvalidValue;
    dl.ell0[c] = ell0s[c];
    dl.K[c] = Ks[c];
    Kmax = Ks[c] > Kmax ? Ks[c] : Kmax;
    rows_max = ell0s[c] + Ks[c] > rows_max ? ell0s[c] + Ks[c] : rows_max;
  }
  if (Kmax < 1 || kstride < Kmax) return (int)cudaErrorInvalidValue;
  int G = lane_blocks(*d, rows_max, lanes);
  size_t smem = 0;
  for (int c = 0; c < lanes; ++c) {
    const int rows = dl.ell0[c] + dl.K[c];
    const size_t fixed = degree_fixed_bytes(rows, dl.K[c]);
    size_t lane_smem;
    plan_band(*d, rows, G, fixed, &dl.staged[c], &dl.ld_s[c], &lane_smem);
    if (dl.K[c] == 0) {  // nothing to update: the lane stages nothing
      dl.staged[c] = 0;
      lane_smem = fixed;
    }
    smem = lane_smem > smem ? lane_smem : smem;
  }
  err = set_smem((const void*)ihb_degree_kernel, &d->set_degree, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&QLt, &C, &N, &Lcap, &Kcap, &Kmax, &kstride, &psi, &accepted,
                  &mses, &coeffs, &slots, &ell_out, &u_scratch, &G, &dl};
  err = cudaLaunchCooperativeKernel((const void*)ihb_degree_kernel, dim3(G * lanes),
                                    dim3(kThreads), args, smem, stream);
  return (int)err;
}
