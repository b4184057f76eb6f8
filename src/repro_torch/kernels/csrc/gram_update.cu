// Fused border evaluation + both Gram products, with carry-in, for OAVI.
//
// Replaces the Pallas TPU kernels `gram_update_acc` (_gram_acc_kernel) and
// `gram_update` (_gram_kernel) of src/repro/kernels/gram_update.py.  One
// kernel family serves both: a null carry-in pointer is the zero-initialised
// `gram_update`.
//
// What it computes, for B = A[:, parents] * X[:, vars]  (m x K):
//     QL = ql0 + A^T B   (L x K)      C = c0 + B^T B   (K x K)
// reduced in the canonical order: for every bm-row block b the partial
// P_b = Y_b^T B_b (Y = [A | B]) is summed over its rows in row order, from
// zero, and the partials are folded into the carry strictly left to right,
//     out = (((acc0 + P_0) + P_1) + ...).
// That order is a contract: a call over rows [0, m) equals, bit for bit, a
// chain of calls over any split at a multiple of bm with the carry threaded
// through.  No atomics, and no partial ever spans two row blocks.  Only the
// upper triangle of B^T B is computed; each strictly-lower entry C[j][i] is
// the fold of its own carry c0[j][i] with the partials of C[i][j], so the
// Gram part of C is exactly symmetric.
//
// What bounds it on the H100: fp32 FMAs (TF32 is no option: OAVI's
// accept/reject test `btb + q.y <= psi` cancels).  Per row the least work is
// L*K FMAs for A^T B and K*(K+1)/2 for the upper triangle of B^T B, on
// (L + n)*4 bytes: ~750 FMA per byte at L = K = 2048, n = 57 and ~23 at
// L = K = 64, n = 3, both above the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 10 FMA per byte).
//
// What the design does about it:
//   * Register blocking.  An output tile is 128 rows of Y^T B by W = 128
//     columns (64 where K <= 64) in 2 W threads; each thread holds an 8 x 8
//     micro-tile and per row reads its 8 + 8 operands as four float4 from
//     shared memory: 64 FMAs for four 16-byte shared loads.  The two float4
//     of a thread lie 64 (W / 2) columns apart, so a warp's loads hit
//     distinct banks.
//   * Staging overlapped with compute.  Rows stream in 16-row slabs through a
//     3-stage cp.async ring, two slabs in flight while one is multiplied; no
//     register holds a value in transit.  Where L and n are small (whole rows
//     of A and X fit the ring: L <= 256, n <= 64) the ring holds those rows,
//     contiguous in device memory, and each slab's border products
//     A[r, p] * X[r, v] (__fmul_rn) are formed in shared memory: A is read
//     once.  Otherwise the border columns are first materialised by
//     gram_border_kernel with the same __fmul_rn (m x K floats) and the ring
//     holds the tile's own columns of A and B, 16 bytes a copy where rows are
//     aligned: at full width every tile of Y would otherwise gather the same
//     products again.
//   * Upper triangle only.  Tiles of B^T B wholly below the diagonal are not
//     computed (25% of the work at L = K).
//   * Two reductions over row blocks, both in the canonical order.  Where
//     the output has enough tiles to fill the card (the wrapper decides), a
//     block owns one tile and walks all row blocks: per row block it sums
//     P_b from zero in registers and folds run = run + P_b, run starting at
//     the carry (the mirrored lower entries fold in shared memory): no
//     scratch, no second pass.  Otherwise (L = K = 64 gives one tile) the
//     partials of all row blocks are computed in parallel into scratch and
//     gram_fold_kernel folds them, one warp per 32 entries streaming the
//     partials through its own 4-stage cp.async ring; the host walks the row
//     blocks in groups that fit the scratch, each group a carried call, so
//     the grouping changes no bit.  Both reductions, and both border
//     sources, give the same bits.
//   Ragged L, K and n are masked; indices are clamped into range.
//
// A class axis (the class-batched fit, src/repro/core/class_batch.py, where
// the reference vmaps this kernel): `lanes` independent problems of one
// shape, laid out lane after lane (A, X, parents, vars, the carry, the
// outputs, the scratch and the border buffer each at a fixed stride), run in
// ONE launch of each kernel, the lane index as the last grid dimension.
// Every block of a lane computes exactly what the same block of a one-lane
// call computes: the reduction path, the scratch grouping and the border
// source are the one-lane call's (the host picks them from the lane's shape,
// not from lanes x tiles), so each lane's bits are the one-lane call's.  The
// one-lane call is lanes = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 128;   // rows of Y^T B per output tile
constexpr int kSlab = 16;        // rows staged in shared memory at a time
constexpr int kStages = 3;       // slabs in the cp.async ring
constexpr int kGatherMaxL = 256;  // staged gather: whole A rows in the ring
constexpr int kGatherMaxN = 64;   // and whole X rows
constexpr int kFoldThreads = 32;  // one warp per fold block: the fold spreads over every SM
constexpr int kFoldDepth = 32;    // partials per stage of the fold
constexpr int kFoldStages = 4;

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v >= hi ? hi - 1 : v);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kStages - 2 committed slabs are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

struct Problem {
  const float* A;
  const float* X;
  const int* parents;
  const int* vars;
  const float* Bm;  // materialised border columns (m x K), or null: staged gather
  int L, n, K;
  int vec;  // 16-byte copies: rows of A (and Bm) 16-byte aligned, L and K multiples of 4
};

// Distances between consecutive lanes, in elements: A (m L), X (m n), the
// border buffer (m K), QL and its carry (L K), C and its carry (K K), the
// scratch (group x partial stride) and parents / vars (K).
struct LaneStrides {
  long long a, x, bm, ql, c, p;
  int idx;
};

// The problem and outputs of lane `lane`: every pointer moved by its stride
// (null stays null).
__device__ __forceinline__ void to_lane(Problem& pb, const float*& ql0, const float*& c0,
                                        float*& ql, float*& c, float*& P, const LaneStrides& ls,
                                        int lane) {
  pb.A += lane * ls.a;
  pb.X += lane * ls.x;
  pb.parents += (long long)lane * ls.idx;
  pb.vars += (long long)lane * ls.idx;
  if (pb.Bm != nullptr) pb.Bm += lane * ls.bm;
  if (ql0 != nullptr) ql0 += lane * ls.ql;
  if (c0 != nullptr) c0 += lane * ls.c;
  if (ql != nullptr) ql += lane * ls.ql;
  if (c != nullptr) c += lane * ls.c;
  if (P != nullptr) P += lane * ls.p;
}

// Where a column of Y (i < L + K) or of the right operand B comes from:
// kind 1 a plain column (src[row * ld] in global memory, or column `a` of the
// staged A slab), kind 2 the product of column `a` of A and `x` of X, kind 0
// padding.
struct ColSrc {
  int kind, a, x;
  const float* src;
  int ld;
};

__device__ __forceinline__ ColSrc border_col(const Problem& pb, int k) {
  if (k >= pb.K) return {0, 0, 0, pb.A, 0};
  const int a = clampi(pb.parents[k], pb.L), x = clampi(pb.vars[k], pb.n);
  if (pb.Bm != nullptr) return {1, a, x, pb.Bm + k, pb.K};
  return {2, a, x, pb.A, 0};
}

__device__ __forceinline__ ColSrc y_col(const Problem& pb, int i) {
  if (i < pb.L) return {1, i, 0, pb.A + i, pb.L};
  return border_col(pb, i - pb.L);
}

// Floats between two partials in scratch: (L + K) * K rounded up to whole
// 32-float rows, so the fold's 16-byte copies stay aligned.
__host__ __device__ __forceinline__ long long partial_stride(int L, int K) {
  return ((long long)(L + K) * K + 31) / 32 * 32;
}

// Whether the tile at (i0, j0) holds an entry of A^T B or of the upper
// triangle of B^T B (rows of Y^T B at or past L are rows i - L of C).
__host__ __device__ __forceinline__ bool tile_needed(int i0, int j0, int width, int L, int K) {
  const int j_last = (j0 + width < K ? j0 + width : K) - 1;
  return i0 < L || i0 - L <= j_last;
}

// Shared memory of a tile kernel, in floats.  Plain: kStages slabs of the Y
// tile ([kSlab][kTileRows]) and the right tile ([kSlab][W]).  Gather:
// kStages raw slabs of A ([kSlab][L]) and X ([kSlab][n]), then one formed
// slab of the Y and right tiles.  FOLD adds the mirrored lower entries'
// sums, [64][threads].
template <int W>
struct TileShape {
  static constexpr int kThreads = 2 * W;  // 8 x 8 micro-tiles
  static constexpr int kFormed = kSlab * (kTileRows + W);
  static constexpr int kYThreads = kThreads / kTileRows;  // threads per Y column
  static constexpr int kYRows = kSlab / kYThreads;        // rows each of them stages
  static constexpr int kRightRows = kSlab / 2;            // two threads per right column
};

__host__ __device__ __forceinline__ int raw_stage_floats(int L, int n) {
  return (kSlab * (L + n) + 3) / 4 * 4;  // 16-byte aligned stages
}

template <int W>
int tile_smem_bytes(bool fold, bool gather, int L, int n) {
  using Sh = TileShape<W>;
  const int floats = (gather ? kStages * raw_stage_floats(L, n) + Sh::kFormed
                             : kStages * Sh::kFormed) +
                     (fold ? 64 * Sh::kThreads : 0);
  return floats * (int)sizeof(float);
}

// One output tile of Y^T B, 128 rows by W columns, over row blocks of bm
// rows from row0.  FOLD: the block walks all n_rb row blocks and folds each
// partial onto the carry (run, in registers; the mirrored lower entries of C
// in shared memory); otherwise it computes the partial of row block
// blockIdx.y alone and writes it to P.  Slabs of kSlab rows arrive by
// cp.async through a kStages ring.  GATHER: the ring holds whole rows of A
// and X and the border products are formed from them in shared memory;
// otherwise it holds the tile's own columns, A's and materialised B's.
template <int W, bool FOLD, bool GATHER>
__global__ void __launch_bounds__(TileShape<W>::kThreads, FOLD ? 1 : 2)
gram_tile_kernel(Problem pb, const float* ql0, const float* c0, float* ql, float* c, float* P,
                 long long row0, int n_rb, int bm, int tiles_j, LaneStrides ls) {
  using Sh = TileShape<W>;
  to_lane(pb, ql0, c0, ql, c, P, ls, (int)blockIdx.z);
  constexpr int NT = Sh::kThreads;
  extern __shared__ __align__(16) float gsm[];
  const int L = pb.L, K = pb.K, LK = pb.L + pb.K, n = pb.n;
  const int raw_floats = raw_stage_floats(L, n);
  // slab u of the ring; the formed slab (GATHER); FOLD's run_lower
  auto ybuf = [&](int u) { return gsm + u * Sh::kFormed; };
  auto bbuf = [&](int u) { return gsm + u * Sh::kFormed + kSlab * kTileRows; };
  auto abuf = [&](int u) { return gsm + u * raw_floats; };
  auto xbuf = [&](int u) { return gsm + u * raw_floats + kSlab * L; };
  float* formed = gsm + kStages * raw_floats;
  float* run_lower = gsm + (GATHER ? kStages * raw_floats + Sh::kFormed : kStages * Sh::kFormed);

  const int i0 = (blockIdx.x / tiles_j) * kTileRows;
  const int j0 = (blockIdx.x % tiles_j) * W;
  if (!tile_needed(i0, j0, W, L, K)) return;
  const int t = threadIdx.x;
  const long long rbase = FOLD ? row0 : row0 + (long long)blockIdx.y * bm;
  if constexpr (!FOLD) n_rb = 1;

  // element staging: this thread's column of the Y tile (rows sy + kYThreads
  // k) and of the right tile (rows sb + 2 k)
  const int cy = t % kTileRows, sy = t / kTileRows;
  const int cb = t % W, sb = t / W;
  const ColSrc ysrc = i0 + cy < LK ? y_col(pb, i0 + cy) : ColSrc{0, 0, 0, pb.A, 0};
  const ColSrc bsrc = border_col(pb, j0 + cb);
  // 16-byte staging (plain, pb.vec): column chunk qy of the Y tile (rows ry +
  // NT / 32 k) and qb of the right tile (rows rb + NT / (W / 4) k)
  constexpr int kYChunkRows = NT / 32, kBChunkRows = NT / (W / 4);
  const int qy = t % 32, ry = t / 32, qb = t % (W / 4), rb = t / (W / 4);
  ColSrc ychunk = {0, 0, 0, pb.A, 0}, bchunk = {0, 0, 0, pb.A, 0};
  if (!GATHER && pb.vec) {
    if (i0 + 4 * qy < LK) ychunk = y_col(pb, i0 + 4 * qy);
    bchunk = border_col(pb, j0 + 4 * qb);
  }

  // compute: this thread's 8 x 8 micro-tile, rows {4 ty + a, 64 + 4 ty + a}
  // and columns {4 tx + b, W / 2 + 4 tx + b}
  const int tx = t % (W / 8), ty = t / (W / 8);
  auto row_of = [&](int a) { return (a < 4 ? 0 : 64) + 4 * ty + (a & 3); };
  auto col_of = [&](int b) { return (b < 4 ? 0 : W / 2) + 4 * tx + (b & 3); };

  float acc[8][8];
  float run[8][8];  // FOLD: the carried sum of this thread's entries
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
  if constexpr (FOLD) {
    // run starts at the carry; a strictly-upper entry (i - L < j) of C also
    // folds its mirror C[j][i - L] from the mirror's own carry, in run_lower
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int i = i0 + row_of(a), j = j0 + col_of(b);
        float up = 0.0f, lo = 0.0f;
        if (i < LK && j < K) {
          if (i < L) {
            if (ql0 != nullptr) up = ql0[(long long)i * K + j];
          } else if (c0 != nullptr) {
            const int ci = i - L;
            if (ci <= j) up = c0[(long long)ci * K + j];
            if (ci < j) lo = c0[(long long)j * K + ci];
          }
        }
        run[a][b] = up;
        run_lower[(8 * a + b) * NT + t] = lo;
      }
    }
  }

  const int spb = bm / kSlab;  // slabs per row block
  const int n_slabs = n_rb * spb;

  // Copies of slab s into ring slot s % kStages (none past the last slab),
  // then one commit, so every slab is one cp.async group.
  auto issue = [&](int s) {
    if (s < n_slabs) {
      const long long r = rbase + (long long)s * kSlab;
      const int u = s % kStages;
      if constexpr (GATHER) {
        // kSlab whole rows of A and of X: contiguous in global memory
        const float* a_src = pb.A + r * L;
        if (pb.vec) {
          for (int e = t; e < kSlab * L / 4; e += NT) cp_async16(abuf(u) + 4 * e, a_src + 4 * e);
        } else {
          for (int e = t; e < kSlab * L; e += NT) cp_async4(abuf(u) + e, a_src + e);
        }
        const float* x_src = pb.X + r * n;
        for (int e = t; e < kSlab * n; e += NT) cp_async4(xbuf(u) + e, x_src + e);
      } else if (pb.vec) {
        if (ychunk.kind != 0) {
#pragma unroll
          for (int k = 0; k < kSlab / kYChunkRows; ++k) {
            const int rr = ry + kYChunkRows * k;
            cp_async16(ybuf(u) + rr * kTileRows + 4 * qy, ychunk.src + (r + rr) * ychunk.ld);
          }
        }
        if (bchunk.kind != 0) {
#pragma unroll
          for (int k = 0; k < kSlab / kBChunkRows; ++k) {
            const int rr = rb + kBChunkRows * k;
            cp_async16(bbuf(u) + rr * W + 4 * qb, bchunk.src + (r + rr) * bchunk.ld);
          }
        }
      } else {
        if (ysrc.kind != 0) {
#pragma unroll
          for (int k = 0; k < Sh::kYRows; ++k) {
            const int rr = sy + Sh::kYThreads * k;
            cp_async4(ybuf(u) + rr * kTileRows + cy, ysrc.src + (r + rr) * ysrc.ld);
          }
        }
        if (bsrc.kind != 0) {
#pragma unroll
          for (int k = 0; k < Sh::kRightRows; ++k) {
            const int rr = sb + 2 * k;
            cp_async4(bbuf(u) + rr * W + cb, bsrc.src + (r + rr) * bsrc.ld);
          }
        }
      }
    }
    cp_async_commit();
  };

  // GATHER: the Y and right tiles of slab s, formed from its raw A and X
  // rows with the same __fmul_rn as the materialised border columns
  auto form = [&](int s) {
    const float* as = abuf(s % kStages);
    const float* xs = xbuf(s % kStages);
    auto value = [&](const ColSrc& col, int rr) {
      if (col.kind == 1) return as[rr * L + col.a];
      if (col.kind == 2) return __fmul_rn(as[rr * L + col.a], xs[rr * n + col.x]);
      return 0.0f;
    };
#pragma unroll
    for (int k = 0; k < Sh::kYRows; ++k) {
      const int rr = sy + Sh::kYThreads * k;
      formed[rr * kTileRows + cy] = value(ysrc, rr);
    }
#pragma unroll
    for (int k = 0; k < Sh::kRightRows; ++k) {
      const int rr = sb + 2 * k;
      formed[kSlab * kTileRows + rr * W + cb] = value(bsrc, rr);
    }
  };

  // The multiply-accumulate of one slab (rows in order: each entry sums its
  // block's rows sequentially, one FMA per row) and, at the end of a row
  // block, the fold of its partial.
  auto compute = [&](int s, const float* yb, const float* bb) {
#pragma unroll
    for (int r = 0; r < kSlab; ++r) {
      const float4 y0 = *reinterpret_cast<const float4*>(yb + r * kTileRows + 4 * ty);
      const float4 y1 = *reinterpret_cast<const float4*>(yb + r * kTileRows + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bb + r * W + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bb + r * W + W / 2 + 4 * tx);
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = __fmaf_rn(yv[a], bv[b], acc[a][b]);
    }
    if constexpr (FOLD) {
      if ((s + 1) % spb == 0) {  // row block done: fold its partial
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            run[a][b] = __fadd_rn(run[a][b], acc[a][b]);
            float& lo = run_lower[(8 * a + b) * NT + t];
            lo = __fadd_rn(lo, acc[a][b]);
            acc[a][b] = 0.0f;
          }
        }
      }
    }
  };

  if constexpr (!GATHER) {  // padding columns are zeroed once in every slot
    for (int u = 0; u < kStages; ++u) {
      if (pb.vec) {
        for (int k = 0; ychunk.kind == 0 && k < kSlab / kYChunkRows; ++k)
          *reinterpret_cast<float4*>(ybuf(u) + (ry + kYChunkRows * k) * kTileRows + 4 * qy) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int k = 0; bchunk.kind == 0 && k < kSlab / kBChunkRows; ++k)
          *reinterpret_cast<float4*>(bbuf(u) + (rb + kBChunkRows * k) * W + 4 * qb) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        for (int k = 0; ysrc.kind == 0 && k < Sh::kYRows; ++k)
          ybuf(u)[(sy + Sh::kYThreads * k) * kTileRows + cy] = 0.0f;
        for (int k = 0; bsrc.kind == 0 && k < Sh::kRightRows; ++k)
          bbuf(u)[(sb + 2 * k) * W + cb] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait_ring();
    __syncthreads();  // slab s landed for every thread; slab s - 1 is consumed
    issue(s + kStages - 1);
    if constexpr (GATHER) {
      form(s);
      __syncthreads();
      compute(s, formed, formed + kSlab * kTileRows);
    } else {
      compute(s, ybuf(s % kStages), bbuf(s % kStages));
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  if constexpr (FOLD) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int i = i0 + row_of(a), j = j0 + col_of(b);
        if (i >= LK || j >= K) continue;
        if (i < L) {
          ql[(long long)i * K + j] = run[a][b];
          continue;
        }
        const int ci = i - L;
        if (ci <= j) c[(long long)ci * K + j] = run[a][b];
        if (ci < j) c[(long long)j * K + ci] = run_lower[(8 * a + b) * NT + t];
      }
    }
  } else {
    float* Pb = P + (long long)blockIdx.y * partial_stride(L, K);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int i = i0 + row_of(a), j = j0 + col_of(b);
        if (i < LK && j < K && (i < L || i - L <= j)) Pb[(long long)i * K + j] = acc[a][b];
      }
    }
  }
}

// out = (((acc0 + P_0) + P_1) + ...) for every entry of A^T B and of the
// upper triangle of B^T B; a strictly-upper entry of C also folds its mirror
// C[j][i] from its own carry.  acc0 == nullptr starts from zero.  The
// outputs may alias the carry (same entry, same thread).  One warp per block
// owns 32 consecutive entries; the partials stream through shared memory in
// kFoldStages stages of kFoldDepth partials (cp.async, 16 bytes a thread),
// so each warp keeps (kFoldStages - 1) * kFoldDepth * 128 bytes in flight.
// Partials lie `stride` floats apart (a multiple of 32).
__global__ void __launch_bounds__(kFoldThreads)
gram_fold_kernel(const float* __restrict__ P, int nblocks, long long stride, const float* ql0,
                 const float* c0, float* ql, float* c, int L, int K, LaneStrides ls) {
  __shared__ __align__(16) float buf[kFoldStages][kFoldDepth][kFoldThreads];
  {  // this block's lane of the class axis: blockIdx.y
    const long long cls = blockIdx.y;
    P += cls * ls.p;
    if (ql0 != nullptr) ql0 += cls * ls.ql;
    if (c0 != nullptr) c0 += cls * ls.c;
    ql += cls * ls.ql;
    c += cls * ls.c;
  }
  const long long E = (long long)(L + K) * K;
  const int lane = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * kFoldThreads;
  const long long e = e0 + lane;
  // copies: lane moves floats [4 (lane % 8), +4) of partial 4 k + lane / 8
  const int q = lane % 8, pu = lane / 8;
  const int n_stages = (nblocks + kFoldDepth - 1) / kFoldDepth;
  auto issue = [&](int st) {
    if (st < n_stages) {
#pragma unroll
      for (int k = 0; k < kFoldDepth / 4; ++k) {
        const int u = 4 * k + pu, b = st * kFoldDepth + u;
        if (b < nblocks) {
          const uint32_t dst = static_cast<uint32_t>(
              __cvta_generic_to_shared(&buf[st % kFoldStages][u][4 * q]));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                       "l"(P + b * stride + e0 + 4 * q)
                       : "memory");
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int i = (int)(e / K), j = (int)(e % K);
  const int ci = i - L;
  const bool live = e < E && (i < L || ci <= j);  // else the mirror's thread holds it
  const bool mirror = i >= L && ci < j;
  float s = 0.0f, sl = 0.0f;
  if (live) {
    if (i < L) {
      if (ql0 != nullptr) s = ql0[e];
    } else if (c0 != nullptr) {
      s = c0[(long long)ci * K + j];
      if (mirror) sl = c0[(long long)j * K + ci];
    }
  }
#pragma unroll
  for (int st = 0; st < kFoldStages - 1; ++st) issue(st);
  for (int st = 0; st < n_stages; ++st) {
    issue(st + kFoldStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFoldStages - 1) : "memory");
    __syncwarp();
    const int count = min(kFoldDepth, nblocks - st * kFoldDepth);
    const float(*v)[kFoldThreads] = buf[st % kFoldStages];
#pragma unroll
    for (int u = 0; u < kFoldDepth; ++u) {
      if (u < count) {
        s = __fadd_rn(s, v[u][lane]);
        sl = __fadd_rn(sl, v[u][lane]);
      }
    }
    __syncwarp();  // every lane has read the stage before it is refilled
  }
  if (!live) return;
  if (i < L) {
    ql[e] = s;
    return;
  }
  c[(long long)ci * K + j] = s;
  if (mirror) c[(long long)j * K + ci] = sl;
}

// Bm[r, k] = A[r, parents[k]] * X[r, vars[k]], one thread per entry; the
// lane is blockIdx.y.
__global__ void gram_border_kernel(const float* __restrict__ A, const float* __restrict__ X,
                                   const int* __restrict__ parents, const int* __restrict__ vars,
                                   float* __restrict__ Bm, long long m, int L, int n, int K,
                                   LaneStrides ls) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m * K) return;
  const long long cls = blockIdx.y;
  A += cls * ls.a;
  X += cls * ls.x;
  parents += cls * ls.idx;
  vars += cls * ls.idx;
  Bm += cls * ls.bm;
  const long long r = e / K;
  const int k = (int)(e % K);
  Bm[e] = __fmul_rn(A[r * L + clampi(parents[k], L)], X[r * n + clampi(vars[k], n)]);
}


template <int W, bool FOLD, bool GATHER>
cudaError_t launch_tiles_as(const Problem& pb, const float* ql0, const float* c0, float* ql,
                            float* c, float* P, long long row0, int n_rb, int bm, int lanes,
                            const LaneStrides& ls, cudaStream_t stream) {
  const int tiles_i = (pb.L + pb.K + kTileRows - 1) / kTileRows;
  const int tiles_j = (pb.K + W - 1) / W;
  const int smem = tile_smem_bytes<W>(FOLD, GATHER, pb.L, pb.n);
  cudaError_t err = cudaFuncSetAttribute(gram_tile_kernel<W, FOLD, GATHER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(tiles_i * tiles_j), FOLD ? 1u : (unsigned)n_rb, (unsigned)lanes);
  gram_tile_kernel<W, FOLD, GATHER><<<grid, TileShape<W>::kThreads, smem, stream>>>(
      pb, ql0, c0, ql, c, P, row0, n_rb, bm, tiles_j, ls);
  return cudaGetLastError();
}

// Staged gather without a materialised border buffer, plain columns with it.
template <int W, bool FOLD>
cudaError_t launch_tiles(const Problem& pb, const float* ql0, const float* c0, float* ql, float* c,
                         float* P, long long row0, int n_rb, int bm, int lanes,
                         const LaneStrides& ls, cudaStream_t stream) {
  if (pb.Bm == nullptr)
    return launch_tiles_as<W, FOLD, true>(pb, ql0, c0, ql, c, P, row0, n_rb, bm, lanes, ls,
                                          stream);
  return launch_tiles_as<W, FOLD, false>(pb, ql0, c0, ql, c, P, row0, n_rb, bm, lanes, ls,
                                         stream);
}

template <int W>
cudaError_t run_gram(const Problem& pb, const float* ql0, const float* c0, float* ql, float* c,
                     float* scratch, long long m, int bm, int group_blocks, int fold, int lanes,
                     const LaneStrides& ls, cudaStream_t stream) {
  const long long nb = m / bm;
  if (fold)
    return launch_tiles<W, true>(pb, ql0, c0, ql, c, nullptr, 0, (int)nb, bm, lanes, ls, stream);
  const long long stride = partial_stride(pb.L, pb.K);
  const unsigned fold_blocks = (unsigned)(stride / kFoldThreads);
  const float* acc_ql = ql0;
  const float* acc_c = c0;
  long long b0 = 0;
  do {  // at least one fold, so m == 0 copies the carry through
    const int g = (int)((nb - b0) < group_blocks ? (nb - b0) : group_blocks);
    if (g > 0) {
      cudaError_t err = launch_tiles<W, false>(pb, nullptr, nullptr, nullptr, nullptr, scratch,
                                               b0 * bm, g, bm, lanes, ls, stream);
      if (err != cudaSuccess) return err;
    }
    gram_fold_kernel<<<dim3(fold_blocks, (unsigned)lanes), kFoldThreads, 0, stream>>>(
        scratch, g, stride, acc_ql, acc_c, ql, c, pb.L, pb.K, ls);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    acc_ql = ql;
    acc_c = c;
    b0 += g;
  } while (b0 < nb);
  return cudaSuccess;
}

}  // namespace

// Floats of scratch one row block's partial takes.
extern "C" long long repro_gram_partial_floats(int L, int K) { return partial_stride(L, K); }

// Output tiles the kernel computes for these widths (the wrapper picks the
// in-block fold when they fill the card).
extern "C" int repro_gram_tiles(int L, int K) {
  const int width = K <= 64 ? 64 : 128;
  const int tiles_i = (L + K + kTileRows - 1) / kTileRows;
  const int tiles_j = (K + width - 1) / width;
  int count = 0;
  for (int ti = 0; ti < tiles_i; ++ti)
    for (int tj = 0; tj < tiles_j; ++tj)
      count += tile_needed(ti * kTileRows, tj * width, width, L, K);
  return count;
}

// Whether the border products can be gathered inside the kernel (whole rows
// of A and X fit the staging ring); else the caller passes a border buffer.
extern "C" int repro_gram_can_gather(int L, int n) {
  return L <= kGatherMaxL && n <= kGatherMaxN;
}

// Host entry point.  m must be a multiple of bm and bm of kSlab (the Python
// wrapper pads and checks).  border (m x K floats a lane) or null: where
// given, the border columns are materialised there first; where null, they
// are gathered in the kernel (repro_gram_can_gather).  fold = 1: one block
// per output tile walks every row block (no scratch); fold = 0: scratch holds
// group_blocks partials of repro_gram_partial_floats(L, K) floats each, for
// every lane.  lanes problems of this shape lie one after another in every
// array (a one-lane call is lanes = 1).  Returns the first launch error, or
// cudaSuccess.
extern "C" int repro_gram_update(const float* A, const float* X, const int* parents,
                                 const int* vars, const float* ql0, const float* c0, float* ql,
                                 float* c, float* scratch, float* border, long long m, int L,
                                 int n, int K, int bm, int group_blocks, int fold, int lanes,
                                 cudaStream_t stream) {
  if (bm <= 0 || bm % kSlab != 0 || m % bm != 0) return (int)cudaErrorInvalidValue;
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  if (border == nullptr && !repro_gram_can_gather(L, n)) return (int)cudaErrorInvalidValue;
  const LaneStrides ls{m * L, m * n, m * K, (long long)L * K, (long long)K * K,
                       (long long)group_blocks * partial_stride(L, K), K};
  if (border != nullptr && m > 0) {
    const long long E = m * K;
    gram_border_kernel<<<dim3((unsigned)((E + 255) / 256), (unsigned)lanes), 256, 0, stream>>>(
        A, X, parents, vars, border, m, L, n, K, ls);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies need every row of A (and of the border buffer) 16-byte
  // aligned and the tiles' column groups of 4 inside one matrix
  const int vec = L % 4 == 0 && K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(border) % 16 == 0;
  const Problem pb{A, X, parents, vars, border, L, n, K, vec};
  if (K <= 64)
    return (int)run_gram<64>(pb, ql0, c0, ql, c, scratch, m, bm, group_blocks, fold, lanes, ls,
                             stream);
  return (int)run_gram<128>(pb, ql0, c0, ql, c, scratch, m, bm, group_blocks, fold, lanes, ls,
                            stream);
}

// Message of a CUDA error code returned by the entry points above.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
