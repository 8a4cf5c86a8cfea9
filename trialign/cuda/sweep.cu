// TriAlign score sweep for NVIDIA Hopper (sm_90a), called from JAX through
// the XLA foreign function interface.
//
// Contract (identical to trialign.kernels.sweep.sweep_reference): the call
// sweeps the rectangle j in (J0, J0+H], k in (K0, K0+W] of the 7-matrix DP
// over every i in [0, la].  Inputs are the two faces on its low sides,
//   in_row (Lc+1, 7, Wc+1): D(i, t, J0, K0+k) for k in [0, W]
//   in_col (Lc+1, 7, Hc+1): D(i, t, J0+j, K0) for j in [0, H]
// and it returns the faces on its high sides (out_row at j = J0+H,
// out_col at k = K0+W, same layouts) plus the 7 values of one requested
// cell (fj, fk) at i = la.  Index 0 of every face is its corner cell.
// (la, H, W, fj, fk) arrive at run time in a device buffer and lie within
// the buffers' static extents (Lc, Hc, Wc), so one compiled call serves
// every problem up to those extents; entries past the runtime rectangle
// are neither read nor written.
//
// Inside the call the rectangle is cut into TJ x TK tiles, one thread per
// (j, k) column; a block sweeps its tile's pillar over all i with the
// cells skewed so that thread (j, k) handles cell i = s - j - k at step s.
// The one-cell j/k neighbours of a step come through a three-slot ring in
// shared memory; the halo cells and symbols of CH steps are staged into
// shared memory at once, so global-memory latency is paid once a chunk.  Pillars take tickets in row-major order and pipeline
// along i: each publishes the last step it completed,
// and a pillar waits only for the up, left and diagonal pillars to be far
// enough ahead.  Every pillar it waits on holds a smaller ticket, so a
// running block never waits on one that is not running or finished.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int NM = 7;       // DP matrices
constexpr int TJ = 16;      // tile rows: one warp per row
constexpr int TK = 32;      // tile columns: one lane per column
constexpr int CH = 16;      // steps between progress waits / publishes
constexpr int MAXSYM = 8;   // largest runtime substitution matrix

struct Params {
  int w[NM * NM];            // transition weights W[t][s]
  int sub[MAXSYM * MAXSYM];  // S(x, y) at x * nsym + y when nsym > 0
  int nsym, sub_floor, match, mismatch, rtl, score_bits;
  int Lc, Hc, Wc, n_jtc, n_ktc;  // static extents of the buffers
  const int* dims;  // runtime (la, H, W, fj, fk) within the extents
  const int* a;     // (Lc+1,): a[i] is the i-th symbol, a[0] unused
  const int* b;     // (Hc,): b[j-1] is row J0+j's symbol
  const int* c;     // (Wc,)
  const int* in_row;
  const int* in_col;
  int* out_row;
  int* out_col;
  int* final_cell;  // (7,)
  int* row_scr;     // (n_jtc-1, Lc+1, 7, Wc+1): bottom faces of tile rows
  int* col_scr;     // (n_ktc-1, Lc+1, 7, Hc+1): right faces of tile columns
  int* flags;       // n_jtc*n_ktc progress words, then the ticket counter
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int pair_score(const Params& p, const int* subt,
                                          int x, int y) {
  if (p.nsym > 0) {
    return (unsigned)x < (unsigned)p.nsym && (unsigned)y < (unsigned)p.nsym
               ? subt[x * p.nsym + y]
               : p.sub_floor;
  }
  return x == y ? p.match : p.mismatch;
}

// max_s(v[s] + W[t][s]) with Hopper's fused add-max.
__device__ __forceinline__ int grouped(const Params& p, int t, const int* v) {
  int m = v[0] + p.w[t * NM];
#pragma unroll
  for (int s = 1; s < NM; ++s) m = __viaddmax_s32(v[s], p.w[t * NM + s], m);
  return m;
}

__device__ __forceinline__ int max7(const int* v) {
  return __vimax3_s32(__vimax3_s32(v[0], v[1], v[2]),
                      __vimax3_s32(v[3], v[4], v[5]), v[6]);
}

// Dynamic shared memory of one block, in ints.
constexpr int SM_RING = 3 * NM * (TJ + 1) * (TK + 1);  // step ring
constexpr int SM_ROW = CH * NM * TK;                    // staged row halo
constexpr int SM_COL = CH * NM * TJ;                    // staged column halo
constexpr int SM_COR = CH * NM;                         // staged corner
constexpr int SM_A = CH + TJ + TK;                      // A window
constexpr int SM_INTS = SM_RING + SM_ROW + SM_COL + SM_COR + SM_A + MAXSYM * MAXSYM + 1;

__global__ void __launch_bounds__(TJ * TK, 2) sweep_kernel(const Params p) {
  extern __shared__ int smem[];
  int(*ring)[NM][TJ + 1][TK + 1] = reinterpret_cast<int(*)[NM][TJ + 1][TK + 1]>(smem);
  int* st_row = smem + SM_RING;   // [CH][NM][TK]
  int* st_col = st_row + SM_ROW;  // [CH][NM][TJ]
  int* st_cor = st_col + SM_COL;  // [CH][NM]
  int* awin = st_cor + SM_COR;    // a[i] at awin[i - (s0 - TJ - TK)]
  int* subt = awin + SM_A;
  int* pillar_sm = subt + MAXSYM * MAXSYM;

  const int tid = threadIdx.y * TK + threadIdx.x;
  if (tid == 0) *pillar_sm = atomicAdd(&p.flags[p.n_jtc * p.n_ktc], 1) + 1;
  if (tid < MAXSYM * MAXSYM) subt[tid] = p.sub[tid];
  __syncthreads();

  // The grid covers the buffers' extents; tiles past the runtime
  // rectangle have nothing to do, and no tile of the rectangle waits on
  // them (they all hold larger tickets).
  const int la = __ldg(p.dims), H = __ldg(p.dims + 1), W = __ldg(p.dims + 2);
  const int fj = __ldg(p.dims + 3), fk = __ldg(p.dims + 4);
  const int n_jt = (H + TJ - 1) / TJ, n_kt = (W + TK - 1) / TK;
  const int pillar = *pillar_sm;
  if (pillar >= n_jt * n_kt) return;
  const int jt = pillar / n_kt, kt = pillar % n_kt;
  const int j0 = jt * TJ, k0 = kt * TK;
  const int h = min(TJ, H - j0), w = min(TK, W - k0);
  const int jl = threadIdx.y + 1, kl = threadIdx.x + 1;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const bool active = jl <= h && kl <= w;
  const long rstride = (long)NM * (p.Wc + 1);  // one i of a row face
  const long cstride = (long)NM * (p.Hc + 1);
  const long rsize = (long)(p.Lc + 1) * rstride;
  const long csize = (long)(p.Lc + 1) * cstride;
  const int* row_src = jt == 0 ? p.in_row : p.row_scr + (jt - 1) * rsize;
  const int* col_src = kt == 0 ? p.in_col : p.col_scr + (kt - 1) * csize;
  int* row_dst = jt == n_jt - 1 ? p.out_row : p.row_scr + jt * rsize;
  int* col_dst = kt == n_kt - 1 ? p.out_col : p.col_scr + kt * csize;
  int* my_flag = &p.flags[pillar];

  const int bj = active ? p.b[j0 + jl - 1] : 0;
  const int ck = active ? p.c[k0 + kl - 1] : 0;
  const int sbc = pair_score(p, subt, bj, ck);
  const bool is_final = active && j0 + jl == fj && k0 + kl == fk;

  // Own previous cell, the up/left neighbours' previous cells, and the
  // 7-way max of the diagonal neighbour's previous cell.
  int P[NM], Up[NM], Lp[NM], m7Dp = 0;
#pragma unroll
  for (int t = 0; t < NM; ++t) P[t] = Up[t] = Lp[t] = 0;

  const int last = la + h + w;
  for (int s0 = 0; s0 <= last; s0 += CH) {
    // A producer's face cell i is written at its step i + (its distance
    // from the shared edge), so each neighbour has to be that many steps
    // ahead of the last step of this chunk.
    if (tid == 0) {
      const int s1 = s0 + CH - 1;
      if (jt > 0)
        while (ld_acquire(&p.flags[pillar - n_kt]) < s1 + TJ) __nanosleep(32);
      if (kt > 0)
        while (ld_acquire(&p.flags[pillar - 1]) < s1 + TK) __nanosleep(32);
      if (jt > 0 && kt > 0)
        while (ld_acquire(&p.flags[pillar - n_kt - 1]) < s1 + TJ + TK)
          __nanosleep(32);
    }
    __syncthreads();

    // Stage the chunk's halo cells and symbols with many loads in flight:
    // at step s0+u, halo (0, kl) holds D(s0+u-kl) of the row above,
    // (jl, 0) holds D(s0+u-jl) of the column to the left and (0, 0)
    // holds D(s0+u).  Warp 0 loads the row, warp 1 the column (one lane
    // per row), warp 2 the corner, warp 3 the A window.
    if (warp == 0 && lane < w) {
      for (int u = 0; u < CH; ++u) {
        const int ii = s0 + u - kl;
        const bool in = ii >= 0 && ii <= la;
#pragma unroll
        for (int t = 0; t < NM; ++t)
          st_row[(u * NM + t) * TK + lane] =
              in ? __ldcg(row_src + ii * rstride + t * (p.Wc + 1) + k0 + kl) : 0;
      }
    } else if (warp == 1 && lane < h) {
      for (int u = 0; u < CH; ++u) {
        const int ii = s0 + u - (lane + 1);
        const bool in = ii >= 0 && ii <= la;
#pragma unroll
        for (int t = 0; t < NM; ++t)
          st_col[(u * NM + t) * TJ + lane] =
              in ? __ldcg(col_src + ii * cstride + t * (p.Hc + 1) + j0 + lane + 1) : 0;
      }
    } else if (warp == 2 && lane < CH) {
      const int ii = s0 + lane;
      const bool in = ii <= la;
#pragma unroll
      for (int t = 0; t < NM; ++t)
        st_cor[lane * NM + t] = in ? __ldcg(row_src + ii * rstride + t * (p.Wc + 1) + k0) : 0;
    } else if (warp == 3) {
      for (int x = lane; x < SM_A; x += TK) {
        const int ii = s0 - TJ - TK + x;
        awin[x] = ii >= 1 && ii <= la ? p.a[ii] : 0;
      }
    }
    __syncthreads();

    const int steps = min(CH, last - s0 + 1);
    for (int u = 0; u < steps; ++u) {
      const int s = s0 + u;
      const int cur = s % 3, prv = (s + 2) % 3, pp = (s + 1) % 3;
      if (active && jl == 1) {
        const int ii = s - kl;
#pragma unroll
        for (int t = 0; t < NM; ++t) {
          const int v = st_row[(u * NM + t) * TK + lane];
          ring[cur][t][0][kl] = v;
          // The tile in the top row, right column seeds index 0 (the
          // corner) of the right face it writes.
          if (jt == 0 && kl == w && ii >= 0 && ii <= la)
            col_dst[ii * cstride + t * (p.Hc + 1)] = v;
        }
      }
      if (active && kl == 1) {
        const int ii = s - jl;
#pragma unroll
        for (int t = 0; t < NM; ++t) {
          const int v = st_col[(u * NM + t) * TJ + jl - 1];
          ring[cur][t][jl][0] = v;
          if (kt == 0 && jl == h && ii >= 0 && ii <= la)
            row_dst[ii * rstride + t * (p.Wc + 1)] = v;
        }
      }
      if (tid == 0) {
#pragma unroll
        for (int t = 0; t < NM; ++t) ring[cur][t][0][0] = st_cor[u * NM + t];
      }

      const int i = s - jl - kl;
      if (active && i >= 0 && i <= la) {
        int nv[NM];
        if (i == 0) {
#pragma unroll
          for (int t = 0; t < NM; ++t) nv[t] = 0;
        } else {
          const int ai = awin[i - (s0 - TJ - TK)];
          const int sab = pair_score(p, subt, ai, bj);
          const int sac = pair_score(p, subt, ai, ck);
          int s3;
          if (p.rtl) {
            s3 = ai == bj ? (bj == ck ? 3 * p.match : 2 * (p.match + p.mismatch))
                          : 3 * p.mismatch;
          } else {
            s3 = sab + sac + sbc;
          }
          int v[NM];
          nv[1] = grouped(p, 1, P);  // Ix: D(i-1, j, k)
#pragma unroll
          for (int t = 0; t < NM; ++t) v[t] = ring[prv][t][jl - 1][kl];
          nv[2] = grouped(p, 2, v);         // Iy: D(i, j-1, k)
          nv[4] = grouped(p, 4, Up) + sab;  // Ixy: D(i-1, j-1, k)
#pragma unroll
          for (int t = 0; t < NM; ++t) Up[t] = v[t];
#pragma unroll
          for (int t = 0; t < NM; ++t) v[t] = ring[prv][t][jl][kl - 1];
          nv[3] = grouped(p, 3, v);         // Iz: D(i, j, k-1)
          nv[6] = grouped(p, 6, Lp) + sac;  // Ixz: D(i-1, j, k-1)
#pragma unroll
          for (int t = 0; t < NM; ++t) Lp[t] = v[t];
#pragma unroll
          for (int t = 0; t < NM; ++t) v[t] = ring[pp][t][jl - 1][kl - 1];
          nv[5] = grouped(p, 5, v) + sbc;   // Iyz: D(i, j-1, k-1)
          nv[0] = m7Dp + s3;                // M: max7 D(i-1, j-1, k-1)
          m7Dp = max7(v);
          if (p.score_bits) {
            const int half = 1 << (p.score_bits - 1);
            const int mask = (1 << p.score_bits) - 1;
#pragma unroll
            for (int t = 0; t < NM; ++t) nv[t] = ((nv[t] + half) & mask) - half;
          }
        }
#pragma unroll
        for (int t = 0; t < NM; ++t) {
          P[t] = nv[t];
          ring[cur][t][jl][kl] = nv[t];
        }
        if (jl == h) {
#pragma unroll
          for (int t = 0; t < NM; ++t) row_dst[i * rstride + t * (p.Wc + 1) + k0 + kl] = nv[t];
        }
        if (kl == w) {
#pragma unroll
          for (int t = 0; t < NM; ++t) col_dst[i * cstride + t * (p.Hc + 1) + j0 + jl] = nv[t];
        }
        if (is_final && i == la) {
#pragma unroll
          for (int t = 0; t < NM; ++t) p.final_cell[t] = nv[t];
        }
      }
      __syncthreads();
    }

    // Publish the last completed step; a finished pillar publishes INT_MAX
    // so that waits past its last step end.
    if (tid == 0) {
      const int s_done = s0 + steps - 1;
      __threadfence();
      st_release(my_flag, s_done == last ? 0x7fffffff : s_done);
    }
  }
}

ffi::Error SweepImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> dims,
                     ffi::Buffer<ffi::S32> a, ffi::Buffer<ffi::S32> b,
                     ffi::Buffer<ffi::S32> c, ffi::Buffer<ffi::S32> in_row,
                     ffi::Buffer<ffi::S32> in_col,
                     ffi::Span<const int32_t> weights,
                     ffi::Span<const int32_t> sub, int32_t nsym,
                     int32_t sub_floor, int32_t match, int32_t mismatch,
                     int32_t rtl, int32_t score_bits,
                     ffi::ResultBuffer<ffi::S32> out_row,
                     ffi::ResultBuffer<ffi::S32> out_col,
                     ffi::ResultBuffer<ffi::S32> final_cell,
                     ffi::ResultBuffer<ffi::S32> scratch) {
  // Buffer extents are static; the runtime rectangle in `dims` lies
  // within them (the Python wrapper checks it).
  Params p;
  const long Lc = (long)a.element_count() - 1;
  const long Hc = (long)b.element_count(), Wc = (long)c.element_count();
  if (dims.element_count() != 5)
    return ffi::Error::InvalidArgument("dims must hold (la, H, W, fj, fk)");
  if (Lc < 1 || Hc < 1 || Wc < 1)
    return ffi::Error::InvalidArgument("sweep needs la, H, W >= 1");
  if (weights.size() != NM * NM || nsym < 0 || nsym > MAXSYM ||
      sub.size() != MAXSYM * MAXSYM)
    return ffi::Error::InvalidArgument("bad scoring attributes");
  if ((long)in_row.element_count() != (Lc + 1) * NM * (Wc + 1) ||
      (long)in_col.element_count() != (Lc + 1) * NM * (Hc + 1) ||
      (long)out_row->element_count() != (Lc + 1) * NM * (Wc + 1) ||
      (long)out_col->element_count() != (Lc + 1) * NM * (Hc + 1) ||
      (long)final_cell->element_count() != NM)
    return ffi::Error::InvalidArgument("face shapes do not match the rectangle");
  const long n_jt = (Hc + TJ - 1) / TJ, n_kt = (Wc + TK - 1) / TK;
  const long need = ((n_jt - 1) * (Wc + 1) + (n_kt - 1) * (Hc + 1)) * (Lc + 1) * NM +
                    n_jt * n_kt + 1;
  if ((long)scratch->element_count() < need)
    return ffi::Error::InvalidArgument("scratch buffer too small");

  for (int t = 0; t < NM * NM; ++t) p.w[t] = weights[t];
  for (int t = 0; t < MAXSYM * MAXSYM; ++t) p.sub[t] = sub[t];
  p.nsym = nsym;
  p.sub_floor = sub_floor;
  p.match = match;
  p.mismatch = mismatch;
  p.rtl = rtl;
  p.score_bits = score_bits;
  p.Lc = (int)Lc;
  p.Hc = (int)Hc;
  p.Wc = (int)Wc;
  p.n_jtc = (int)n_jt;
  p.n_ktc = (int)n_kt;
  p.dims = dims.typed_data();
  p.a = a.typed_data();
  p.b = b.typed_data();
  p.c = c.typed_data();
  p.in_row = in_row.typed_data();
  p.in_col = in_col.typed_data();
  p.out_row = out_row->typed_data();
  p.out_col = out_col->typed_data();
  p.final_cell = final_cell->typed_data();
  int* scr = scratch->typed_data();
  p.row_scr = scr;
  p.col_scr = scr + (n_jt - 1) * (Wc + 1) * (Lc + 1) * NM;
  p.flags = p.col_scr + (n_kt - 1) * (Hc + 1) * (Lc + 1) * NM;

  const cudaError_t attr_err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SM_INTS * (int)sizeof(int));
  if (attr_err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(attr_err));
  // Progress words start at -1 (nothing written); the ticket counter too,
  // so the first block draws pillar 0.
  cudaMemsetAsync(p.flags, 0xFF, (n_jt * n_kt + 1) * sizeof(int), stream);
  sweep_kernel<<<(unsigned)(n_jt * n_kt), dim3(TK, TJ), SM_INTS * sizeof(int), stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TrialignSweep, SweepImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // dims
                                  .Arg<ffi::Buffer<ffi::S32>>()  // a
                                  .Arg<ffi::Buffer<ffi::S32>>()  // b
                                  .Arg<ffi::Buffer<ffi::S32>>()  // c
                                  .Arg<ffi::Buffer<ffi::S32>>()  // in_row
                                  .Arg<ffi::Buffer<ffi::S32>>()  // in_col
                                  .Attr<ffi::Span<const int32_t>>("weights")
                                  .Attr<ffi::Span<const int32_t>>("sub")
                                  .Attr<int32_t>("nsym")
                                  .Attr<int32_t>("sub_floor")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("rtl")
                                  .Attr<int32_t>("score_bits")
                                  .Ret<ffi::Buffer<ffi::S32>>()  // out_row
                                  .Ret<ffi::Buffer<ffi::S32>>()  // out_col
                                  .Ret<ffi::Buffer<ffi::S32>>()  // final cell
                                  .Ret<ffi::Buffer<ffi::S32>>()  // scratch
);
