// Ragged grouped GEMM out[n, :] = x[n, :] @ W[group(n)] for Hopper: the MoE
// expert products.
//
// Replaces the reference's Pallas kernel B3 (src/repro/codegen/fused_gen.py:
// _grouped_row_fn, pl.pallas_call at :243) in both of its orientations:
//   forward  out[n, f] = sum_k x[n, k] * W[g, k, f]
//   dX       out[n, k] = sum_f x[n, f] * W[g, k, f]   (W's contract axis last)
// The Python side (codegen/fused_gen.py) passes W's strides so that the
// contracted axis is "k" and the output axis "n" of the product; the dX
// orientation is the forward one with W's two trailing strides swapped.
// Rows are partitioned into contiguous groups; the host cuts each non-empty
// group into row blocks of at most the body's M tile and builds a table of
// (group id, first row, rows) triples, one per row block, so empty groups
// launch no CTA and no block spans two groups.
//
// The TPU kernel keeps a whole (N, C) x block and an (N, bn) f32 output
// block resident in VMEM while a sequential grid axis walks the groups.
// Hopper has no sequential grid, so here one CTA owns one (row block,
// column block) of the output: it reads its rows from the table, streams K
// through shared memory and keeps the f32 accumulator in registers.  The
// tile is 16, 32 or 64 rows by 128 columns (4 warps side by side along the
// columns, 32-deep K steps) or, where groups average more than 64 rows,
// 128 x 128 (64-deep K steps, two warpgroups on wgmma); the launch's plan
// names the tile (grouped_launch_plan, fused_gen.FusedPlan: a searched
// one, else the tile fused_gen.grouped_tile_m picks from the group
// sizes).  Rows past a
// block's end are zero on load and masked on store, so ragged and size-1
// groups come out exactly.  The grid is one dimension, rasterized in bands:
// the row blocks of one band (as many as the largest group has) run side by
// side for each column block in turn, so the CTAs that share a W tile, and
// those that share an x row block, are resident together and read it from
// L2.  The serving forward (16-row tile, aligned operands) runs its own body
// on a 2-D grid of (column block, group): the 16-row tile body on the band
// grid read 2-3.5 % slower at C = 16.
//
// What bounds it on the H100.  Serving (C = 4..16 rows a group): every
// expert's matrix is read once per call, so a call moves the whole expert
// slab (kimi-k2: 384 x 7168 x 2048 bf16 = 11.27 GB, 3.37 ms at 3.35 TB/s)
// against 0.18 ms of bf16 tensor-core math at C = 16: bound by bytes.
// Training (32 experts of C = 320): 2 x 10240 x 7168 x 2048 = 0.30 TFLOP
// on 0.94 GB of slab, 0.30 ms of math at 989 TFLOP/s against 0.28 ms of
// bytes: both, so the slab must be read from device memory once (row
// blocks in the grid, not a loop that streams it again per 64 rows), and
// the math must keep the tensor cores fed: mma.sync layouts of the 128-row
// tile stalled near 230 TFLOP/s there, so aligned 128-row blocks run
// wgmma (m64n128k16, about 390 TFLOP/s).
//
// The design keeps the bytes moving: x and W tiles stream with 16-byte
// cp.async into a three-stage shared-memory ring (two K steps in flight
// while a third is multiplied), in whichever orientation W lies:
//   * forward, W [k][n] with n contiguous: the tile is kept [k][n] (rows
//     padded by 16 bytes so the eight rows of an ldmatrix phase hit distinct
//     banks) and reaches the m16n8k16 B fragments through ldmatrix.trans;
//   * dX, W [n][k] with k contiguous: the tile is kept [n][k] as it lies,
//     which is the .col B operand as it stands: plain ldmatrix.
// x is k-contiguous in both; its A fragments come through ldmatrix.  The
// tensor cores run mma.sync m16n8k16 (bf16 in, f32 accumulate).  The
// 128-row wgmma body keeps its tiles in the 128-byte-swizzled layouts
// wgmma reads (K-major for x and the dX W, N-major for the forward W) on a
// ring of the same depth.  Operands that cannot take 16-byte copies (odd
// widths, unaligned pointers, neither W stride unit) are staged element by
// element into one mma.sync body of 128 x 128 (8 warps of 64 x 32), which
// takes a block of any size.
//   * f32 operands keep exact f32 math on the FMA pipes (16 rows x 64
//     columns a pass, 256 threads of 4 outputs each), one CTA per (column
//     block, row block) of the same table.
// Accumulation is f32; the store rounds once to the output type (round to
// nearest even for bf16), as the reference's f32 accumulator is cast once.
// Output pairs of adjacent columns are stored as one 32-bit (bf16) or
// 64-bit (f32) word where the output rows allow it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// bf16 body (tensor cores)
constexpr int BN = 128;
constexpr int WN = 4;  // warps along the columns: 32 columns each
constexpr int STAGES = 3;
constexpr int GROUPED_MAX_ROWS = 128;  // the largest M tile

// One tile configuration: BM x BN, BK deep, WM x WN warps.
template <int BM_, int BK_, int WM_>
struct Cfg {
  static constexpr int BM = BM_;
  static constexpr int BK = BK_;
  static constexpr int WM = WM_;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int MT = BM / WM / 16;  // m16 tiles of a warp
  static constexpr int NT = BN / WN / 8;   // n8 tiles of a warp (4)
  static constexpr int LDX = BK + 8;       // x [m][k]
  static constexpr int LDW_KN = BN + 8;    // W [k][n] (forward)
  static constexpr int LDW_NK = BK + 8;    // W [n][k] (dX)
  static constexpr int X_ELEMS = BM * LDX;
  // a W ring slot, [n][k] (the dX orientation) or [k][n]
  __host__ __device__ static constexpr int w_elems(bool wnk) {
    return wnk ? BN * LDW_NK : BK * LDW_KN;
  }
  __host__ __device__ static constexpr int smem(bool wnk) {
    return STAGES * (X_ELEMS + w_elems(wnk)) * 2;
  }
};

// f32 body (FMA pipes)
constexpr int F_BN = 64;
constexpr int F_RM = 16;
constexpr int F_BK = 32;
constexpr int F_THREADS = 256;

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2_from_f32(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2_from_f32(__nv_bfloat16* p, float a,
                                                float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices: thread i gets row i/4, columns 2(i%4), 2(i%4)+1 of
// each (lanes 8j..8j+7 give the row addresses of matrix j)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, transposed: thread i gets rows 2(i%4), 2(i%4)+1 of column i/4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Band rasterization of blockIdx.x: the row blocks of a band (the most a
// group has) are adjacent for each column block in turn.
__device__ __forceinline__ void band_tile(int n_blocks, int band, int N,
                                          int& blk, int& n0) {
  const int ncol = (N + BN - 1) / BN;
  const int per_band = band * ncol;
  const int b = blockIdx.x / per_band;
  const int first = b * band;
  const int in_band = min(band, n_blocks - first);
  const int rem = blockIdx.x - b * per_band;
  blk = first + rem % in_band;
  n0 = (rem / in_band) * BN;
}

// One K step into one ring slot: the x rows [0, rows) of the block (zero
// past them) and the W tile [k0, k0 + BK) x [n0, n0 + BN), kept [n][k]
// (WNK, the dX orientation) or [k][n].  VEC: 16-byte cp.async; else element
// by element, walking W's unit-stride axis first.
template <class C, bool VEC, bool WNK>
__device__ __forceinline__ void load_tiles(
    __nv_bfloat16* xs, __nv_bfloat16* ws, const __nv_bfloat16* X,
    const __nv_bfloat16* Xp, const __nv_bfloat16* W, const __nv_bfloat16* Wg,
    int rows, int n0, int k0, int N, int K, long long sXm, long long sXk,
    long long sWk, long long sWn) {
  constexpr int BK = C::BK;
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int v = tid; v < C::BM * BK / 8; v += C::THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + c < K;
      cp_async16(xs + r * C::LDX + c, ok ? Xp + r * sXm + k0 + c : X, ok);
    }
    if (WNK) {
#pragma unroll
      for (int v = tid; v < BN * BK / 8; v += C::THREADS) {
        const int nn = v / (BK / 8);
        const int c = (v % (BK / 8)) * 8;
        const bool ok = n0 + nn < N && k0 + c < K;
        cp_async16(ws + nn * C::LDW_NK + c,
                   ok ? Wg + (n0 + nn) * sWn + k0 + c : W, ok);
      }
    } else {
#pragma unroll
      for (int v = tid; v < BK * BN / 8; v += C::THREADS) {
        const int kk = v / (BN / 8);
        const int c = (v % (BN / 8)) * 8;
        const bool ok = k0 + kk < K && n0 + c < N;
        cp_async16(ws + kk * C::LDW_KN + c,
                   ok ? Wg + (k0 + kk) * sWk + n0 + c : W, ok);
      }
    }
  } else {
    for (int e = tid; e < C::BM * BK; e += C::THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const int k = k0 + c;
      xs[r * C::LDX + c] = (r < rows && k < K) ? Xp[r * sXm + k * sXk]
                                               : __float2bfloat16(0.f);
    }
    for (int e = tid; e < BK * BN; e += C::THREADS) {
      const int kk = WNK ? e % BK : e / BN;
      const int c = WNK ? e / BK : e % BN;
      const int k = k0 + kk;
      const int n = n0 + c;
      const __nv_bfloat16 v = (k < K && n < N) ? Wg[k * sWk + n * sWn]
                                               : __float2bfloat16(0.f);
      ws[WNK ? c * C::LDW_NK + kk : kk * C::LDW_KN + c] = v;
    }
  }
}

// VEC: x has unit stride along k, W along n ([k][n]) or k (WNK), the
// unit-stride extents and the other strides are multiples of 8 and both
// pointers 16-byte aligned, so 8 elements move as one cp.async.
template <typename TOut, class C, bool VEC, bool WNK>
__global__ void __launch_bounds__(C::THREADS)
grouped_bf16_mma_kernel(const __nv_bfloat16* __restrict__ X,
                        const __nv_bfloat16* __restrict__ W,
                        TOut* __restrict__ O, const int* __restrict__ table,
                        int n_blocks, int band, int N, int K, long long sXm,
                        long long sXk, long long sWg, long long sWk,
                        long long sWn, long long sOm, long long sOn) {
  constexpr int MT = C::MT;
  constexpr int NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ws = Xs + STAGES * C::X_ELEMS;
  constexpr int W_ELEMS = C::w_elems(WNK);

  int blk, n0;
  band_tile(n_blocks, band, N, blk, n0);

  const int gid = table[3 * blk];
  const int start = table[3 * blk + 1];
  const int rows = table[3 * blk + 2];
  const __nv_bfloat16* Wg = W + gid * sWg;
  const __nv_bfloat16* Xp = X + start * sXm;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = (warp / WN) * MT * 16;
  const int wn = (warp % WN) * 32;
  const int nk = (K + C::BK - 1) / C::BK;

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_tiles<C, VEC, WNK>(Xs + s * C::X_ELEMS, Ws + s * W_ELEMS, X, Xp,
                              W, Wg, rows, n0, s * C::BK, N, K, sXm, sXk, sWk,
                              sWn);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's)
    __syncthreads();              // ... and everyone's; slot kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_tiles<C, VEC, WNK>(
          Xs + (nxt % STAGES) * C::X_ELEMS, Ws + (nxt % STAGES) * W_ELEMS,
          X, Xp, W, Wg, rows, n0, nxt * C::BK, N, K, sXm, sXk, sWk, sWn);
    cp_async_commit();
    const __nv_bfloat16* xs = Xs + (kt % STAGES) * C::X_ELEMS;
    const __nv_bfloat16* ws = Ws + (kt % STAGES) * W_ELEMS;
#pragma unroll
    for (int ks = 0; ks < C::BK; ks += 16) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        if (WNK)  // [n][k]: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), ...
          ldmatrix_x4(r, ws + (wn + p * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  C::LDW_NK +
                             ks + ((lane >> 3) & 1) * 8);
        else  // [k][n]: transposed
          ldmatrix_x4_trans(r, ws + (ks + (lane & 15)) * C::LDW_KN + wn +
                                   p * 16 + (lane >> 4) * 8);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t af[4];
        ldmatrix_x4(af, xs + (wm + mi * 16 + (lane & 15)) * C::LDX + ks +
                            (lane >> 4) * 8);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_16816(acc[mi][ni], af, bf[ni]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: e = 2h + j holds row g + 8h, column 2t + j
  const bool pair = sOn == 1 && (sOm & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + mi * 16 + g + 8 * h;
      if (row >= rows) continue;
      TOut* Orow = O + (start + row) * sOm;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        if (pair && n + 1 < N) {
          store2_from_f32(Orow + n, acc[mi][ni][2 * h],
                          acc[mi][ni][2 * h + 1]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n + j < N)
              store_from_f32(Orow + (n + j) * sOn, acc[mi][ni][2 * h + j]);
        }
      }
    }
}


// ---------------------------------------------------------------------------
// wgmma body: 128 x 128 tiles of two warpgroups (64 rows each), 64-deep K
// steps on a three-stage cp.async ring whose tiles are laid out as wgmma
// reads them: 128-byte rows, the 16-byte chunks of row r XORed with r % 8
// (the 128-byte swizzle), 1024-byte aligned atoms of 8 rows.  x and the dX
// orientation's W are K-major (a row of 64 k); the forward W is N-major:
// two atoms of 64 columns, each 64 k rows of 128 bytes.
// ---------------------------------------------------------------------------
constexpr int G_STAGES = 3;
constexpr int G_TILE = 128 * 64 * 2;  // bytes of one operand's tile
constexpr int G_SMEM = G_STAGES * 2 * G_TILE + 1024;

// matrix descriptor: start address, leading and stride byte offsets, and
// the 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d[64] += A(64 x 16) . B(16 x 128); TB: B N-major (transposed)
template <int TB>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async's writes, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One 64-deep K step of x (128 rows) and W (128 columns) into one slot.
template <bool WNK>
__device__ __forceinline__ void g_load(
    unsigned char* xs, unsigned char* ws, const __nv_bfloat16* X,
    const __nv_bfloat16* Xp, const __nv_bfloat16* W, const __nv_bfloat16* Wg,
    int rows, int n0, int k0, int N, int K, long long sXm, long long sWk,
    long long sWn) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // x [m][k]: 128 rows of 8 chunks
    const int v = tid + i * 256;
    const int r = v >> 3, c = v & 7;
    const bool ok = r < rows && k0 + c * 8 < K;
    cp_async16(xs + r * 128 + ((c ^ (r & 7)) << 4),
               ok ? Xp + r * sXm + k0 + c * 8 : X, ok);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = tid + i * 256;
    if (WNK) {  // [n][k]: 128 rows of 8 chunks
      const int nn = v >> 3, c = v & 7;
      const bool ok = n0 + nn < N && k0 + c * 8 < K;
      cp_async16(ws + nn * 128 + ((c ^ (nn & 7)) << 4),
                 ok ? Wg + (n0 + nn) * sWn + k0 + c * 8 : W, ok);
    } else {  // [k][n]: 64 rows of 16 chunks, two 64-column atoms
      const int kk = v >> 4, c = v & 15;
      const bool ok = k0 + kk < K && n0 + c * 8 < N;
      cp_async16(ws + (c >> 3) * 8192 + kk * 128 + (((c & 7) ^ (kk & 7)) << 4),
                 ok ? Wg + (k0 + kk) * sWk + n0 + c * 8 : W, ok);
    }
  }
}

// The wgmma body for 16-byte-aligned operands (VEC) at up to 128 rows.
template <typename TOut, bool WNK>
__global__ void __launch_bounds__(256)
grouped_wgmma_kernel(const __nv_bfloat16* __restrict__ X,
                     const __nv_bfloat16* __restrict__ W,
                     TOut* __restrict__ O, const int* __restrict__ table,
                     int n_blocks, int band, int N, int K, long long sXm,
                     long long sWg, long long sWk, long long sWn,
                     long long sOm, long long sOn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Xs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ws = Xs + G_STAGES * G_TILE;

  int blk, n0;
  band_tile(n_blocks, band, N, blk, n0);
  const int gid = table[3 * blk];
  const int start = table[3 * blk + 1];
  const int rows = table[3 * blk + 2];
  const __nv_bfloat16* Wg = W + gid * sWg;
  const __nv_bfloat16* Xp = X + start * sXm;
  const int wg = threadIdx.x >> 7;  // warpgroup: rows 64 wg .. 64 wg + 63
  const int nk = (K + 63) / 64;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < nk)
      g_load<WNK>(Xs + s * G_TILE, Ws + s * G_TILE, X, Xp, W, Wg, rows, n0,
                  s * 64, N, K, sXm, sWk, sWn);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G_STAGES - 2>();  // step kt has landed (this thread's)
    fence_proxy_async();
    __syncthreads();                // ... and everyone's
    const uint32_t xa =
        smem_addr(Xs + (kt % G_STAGES) * G_TILE) + wg * 64 * 128;
    const uint32_t wa = smem_addr(Ws + (kt % G_STAGES) * G_TILE);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // K-major: 16 k are 32 bytes along the row; N-major: two 8-row atoms
      const uint64_t da = gmma_desc(xa + ks * 32, 16, 1024);
      if (WNK)
        wgmma_128<0>(acc, da, gmma_desc(wa + ks * 32, 16, 1024));
      else
        wgmma_128<1>(acc, da, gmma_desc(wa + ks * 2048, 8192, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // step kt - 1's products are done ...
    __syncthreads();  // ... in both warpgroups: its slot is free
    const int nxt = kt + G_STAGES - 1;
    if (nxt < nk)
      g_load<WNK>(Xs + (nxt % G_STAGES) * G_TILE,
                  Ws + (nxt % G_STAGES) * G_TILE, X, Xp, W, Wg, rows, n0,
                  nxt * 64, N, K, sXm, sWk, sWn);
    cp_async_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  cp_async_wait<0>();

  // warp w of warpgroup wg: rows 64 wg + 16 w + g (+ 8); per n8 block j,
  // acc[4j + 2h + e] is (row g + 8h, column 8j + 2t + e)
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;
  const bool pair = sOn == 1 && (sOm & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= rows) continue;
    TOut* Orow = O + (start + row) * sOm;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pair && n + 1 < N) {
        store2_from_f32(Orow + n, v0, v1);
      } else {
        if (n < N) store_from_f32(Orow + n * sOn, v0);
        if (n + 1 < N) store_from_f32(Orow + (n + 1) * sOn, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Serving body (groups of at most 16 rows, aligned forward operands): one CTA
// per (column block, group) on a 2-D grid, one m16 tile of rows, 32-deep K
// steps, static shared memory, A fragments read as words.  At C = 16 it
// reads 2-3.5 % faster than Cfg<16, 32, 1> on the band grid, and this body
// moves every expert's slab once a call: it is the kimi-k2 serving path.
// ---------------------------------------------------------------------------
constexpr int S_BK = 32;
constexpr int S_THREADS = 128;
constexpr int S_LDX = S_BK + 8;  // padded x row: 80 bytes
constexpr int S_LDW = BN + 8;    // padded W row: 272 bytes

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One K step into one ring slot: the x rows [0, rows) of the pass (zero past
// them) and the W tile [k0, k0 + S_BK) x [n0, n0 + BN), 16-byte cp.async.
__device__ __forceinline__ void serve_load_tiles(
    __nv_bfloat16 (*xs)[S_LDX], __nv_bfloat16 (*ws)[S_LDW],
    const __nv_bfloat16* X, const __nv_bfloat16* Xp, const __nv_bfloat16* W,
    const __nv_bfloat16* Wg, int rows, int n0, int k0, int N, int K,
    long long sXm, long long sWk) {
  constexpr int RM = 16;
  const int tid = threadIdx.x;
  for (int v = tid; v < RM * (S_BK / 8); v += S_THREADS) {
    const int r = v >> 2;
    const int c = (v & 3) * 8;
    const bool ok = r < rows && k0 + c < K;
    cp_async16(&xs[r][c], ok ? Xp + r * sXm + k0 + c : X, ok);
  }
#pragma unroll
  for (int i = 0; i < S_BK * BN / 8 / S_THREADS; ++i) {
    const int v = tid + i * S_THREADS;
    const int kk = v >> 4;
    const int c = (v & 15) * 8;
    const bool ok = k0 + kk < K && n0 + c < N;
    cp_async16(&ws[kk][c], ok ? Wg + (k0 + kk) * sWk + n0 + c : W, ok);
  }
}

template <typename TOut>
__global__ void __launch_bounds__(S_THREADS)
grouped_serve_kernel(const __nv_bfloat16* __restrict__ X,
                     const __nv_bfloat16* __restrict__ W,
                     TOut* __restrict__ O, const int* __restrict__ table,
                     int N, int K, long long sXm, long long sWg,
                     long long sWk, long long sOm, long long sOn) {
  constexpr int MT = 1;
  constexpr int RM = 16 * MT;
  __shared__ __align__(16) __nv_bfloat16 Xs[STAGES][RM][S_LDX];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Ws[STAGES][S_BK][S_LDW];  // [k][n]

  const int gid = table[3 * blockIdx.y];
  const int start = table[3 * blockIdx.y + 1];
  const int size = table[3 * blockIdx.y + 2];
  const int n0 = blockIdx.x * BN;
  const __nv_bfloat16* Wg = W + gid * sWg;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wn = warp * 32;
  const int nk = (K + S_BK - 1) / S_BK;

  for (int r0 = 0; r0 < size; r0 += RM) {
    const int rows = min(RM, size - r0);
    const __nv_bfloat16* Xp = X + (start + r0) * sXm;

    float acc[MT][4][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        serve_load_tiles(Xs[s], Ws[s], X, Xp, W, Wg, rows, n0, s * S_BK, N, K,
                         sXm, sWk);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's)
      __syncthreads();              // ... and everyone's; slot kt-1 is free
      const int nxt = kt + STAGES - 1;
      if (nxt < nk)
        serve_load_tiles(Xs[nxt % STAGES], Ws[nxt % STAGES], X, Xp, W, Wg,
                         rows, n0, nxt * S_BK, N, K, sXm, sWk);
      cp_async_commit();
      const int slot = kt % STAGES;
#pragma unroll
      for (int ks = 0; ks < S_BK; ks += 16) {
        uint32_t bf[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, &Ws[slot][ks + (lane & 15)][wn + p * 16 + (lane >> 4) * 8]);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int r = mi * 16 + g;
          uint32_t af[4];
          af[0] = lds_u32(&Xs[slot][r][ks + 2 * t]);
          af[1] = lds_u32(&Xs[slot][r + 8][ks + 2 * t]);
          af[2] = lds_u32(&Xs[slot][r][ks + 2 * t + 8]);
          af[3] = lds_u32(&Xs[slot][r + 8][ks + 2 * t + 8]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af, bf[ni]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass's first loads reuse every slot

    // accumulator fragment: e = 2h + j holds row g + 8h, column 2t + j
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mi * 16 + g + 8 * h;
        if (row >= rows) continue;
        TOut* Orow = O + (start + r0 + row) * sOm;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = n0 + wn + ni * 8 + 2 * t + j;
            if (n < N) store_from_f32(Orow + n * sOn, acc[mi][ni][2 * h + j]);
          }
      }
  }
}

template <typename TOut>
__global__ void __launch_bounds__(F_THREADS)
grouped_f32_kernel(const float* __restrict__ X, const float* __restrict__ W,
                   TOut* __restrict__ O, const int* __restrict__ table, int N,
                   int K, long long sXm, long long sXk, long long sWg,
                   long long sWk, long long sWn, long long sOm, long long sOn) {
  __shared__ float Xs[F_BK][F_RM + 1];  // [k][m]
  __shared__ float Ws[F_BK][F_BN + 1];  // [k][n]

  const int gid = table[3 * blockIdx.y];
  const int start = table[3 * blockIdx.y + 1];
  const int size = table[3 * blockIdx.y + 2];
  const int n0 = blockIdx.x * F_BN;
  const float* Wg = W + gid * sWg;
  const int tid = threadIdx.x;
  const int tx = tid % F_BN;  // column
  const int ty = tid / F_BN;  // rows ty + 4 i
  const bool k_fast = sWk == 1;

  for (int r0 = 0; r0 < size; r0 += F_RM) {
    const int rows = min(F_RM, size - r0);
    const float* Xp = X + (start + r0) * sXm;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += F_BK) {
      for (int e = tid; e < F_RM * F_BK; e += F_THREADS) {
        const int r = e / F_BK;
        const int c = e % F_BK;
        const int k = k0 + c;
        Xs[c][r] = (r < rows && k < K) ? Xp[r * sXm + k * sXk] : 0.f;
      }
      for (int e = tid; e < F_BK * F_BN; e += F_THREADS) {
        const int kk = k_fast ? e % F_BK : e / F_BN;
        const int c = k_fast ? e / F_BK : e % F_BN;
        const int k = k0 + kk;
        const int n = n0 + c;
        Ws[kk][c] = (k < K && n < N) ? Wg[k * sWk + n * sWn] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < F_BK; ++kk) {
        const float b = Ws[kk][tx];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] = fmaf(Xs[kk][ty + 4 * i], b, acc[i]);
      }
      __syncthreads();
    }
    const int n = n0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 4 * i;
      if (row < rows && n < N)
        store_from_f32(O + (start + r0 + row) * sOm + n * sOn, acc[i]);
    }
  }
}

template <typename TOut, class C, bool VEC, bool WNK>
void run_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, TOut* o,
              const int* table, int n_blocks, int band, int N, int K,
              long long sXm, long long sXk, long long sWg, long long sWk,
              long long sWn, long long sOm, long long sOn,
              cudaStream_t stream) {
  auto kernel = grouped_bf16_mma_kernel<TOut, C, VEC, WNK>;
  constexpr int smem = C::smem(WNK);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;
  const unsigned ncol = static_cast<unsigned>((N + BN - 1) / BN);
  kernel<<<static_cast<unsigned>(n_blocks) * ncol, C::THREADS, smem,
           stream>>>(x, w, o, table, n_blocks, band, N, K, sXm, sXk, sWg, sWk,
                     sWn, sOm, sOn);
}

template <typename TOut, bool WNK>
void run_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, TOut* o,
               const int* table, int n_blocks, int band, int N, int K,
               long long sXm, long long sWg, long long sWk, long long sWn,
               long long sOm, long long sOn, cudaStream_t stream) {
  auto kernel = grouped_wgmma_kernel<TOut, WNK>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  (void)attr;
  const unsigned ncol = static_cast<unsigned>((N + BN - 1) / BN);
  kernel<<<static_cast<unsigned>(n_blocks) * ncol, 256, G_SMEM, stream>>>(
      x, w, o, table, n_blocks, band, N, K, sXm, sWg, sWk, sWn, sOm, sOn);
}

template <typename TOut>
void run_serve(const __nv_bfloat16* x, const __nv_bfloat16* w, TOut* o,
               const int* table, int n_blocks, int N, int K, long long sXm,
               long long sWg, long long sWk, long long sOm, long long sOn,
               cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, n_blocks);
  grouped_serve_kernel<TOut><<<grid, S_THREADS, 0, stream>>>(
      x, w, o, table, N, K, sXm, sWg, sWk, sOm, sOn);
}

// Whether bf16 operands take 16-byte copies (the bodies of the M tiles;
// fused_gen.grouped_body's "ring"); else the element-wise 128-row body.
bool bf16_vec(const void* X, const void* W, int N, int K, long long sXm,
              long long sXk, long long sWg, long long sWk, long long sWn) {
  // W [n][k] (the dX orientation) when k is its unit-stride axis
  const bool wnk = sWk == 1 && sWn != 1;
  const bool w_vec = wnk ? sWn % 8 == 0 && K % 8 == 0
                         : sWn == 1 && sWk % 8 == 0 && N % 8 == 0;
  return w_vec && sXk == 1 && K % 8 == 0 && sXm % 8 == 0 && sWg % 8 == 0 &&
         reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(W) % 16 == 0;
}

template <typename TOut, class C>
void launch_bf16(const void* X, const void* W, void* O, const int* table,
                 int n_blocks, int band, int N, int K, long long sXm,
                 long long sXk, long long sWg, long long sWk, long long sWn,
                 long long sOm, long long sOn, cudaStream_t stream) {
  // W [n][k] (the dX orientation) when k is its unit-stride axis
  const bool wnk = sWk == 1 && sWn != 1;
  const bool vec = bf16_vec(X, W, N, K, sXm, sXk, sWg, sWk, sWn);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(X);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(W);
  TOut* o = static_cast<TOut*>(O);
  if (!vec) {  // element by element: one 128-row mma.sync body for any block
    using E = Cfg<128, 64, 2>;
    if (wnk)
      run_bf16<TOut, E, false, true>(x, w, o, table, n_blocks, band, N, K,
                                     sXm, sXk, sWg, sWk, sWn, sOm, sOn, stream);
    else
      run_bf16<TOut, E, false, false>(x, w, o, table, n_blocks, band, N, K,
                                      sXm, sXk, sWg, sWk, sWn, sOm, sOn,
                                      stream);
    return;
  }
  if constexpr (C::BM == 128) {  // aligned 128-row blocks: wgmma
    if (wnk)
      run_wgmma<TOut, true>(x, w, o, table, n_blocks, band, N, K, sXm, sWg,
                            sWk, sWn, sOm, sOn, stream);
    else
      run_wgmma<TOut, false>(x, w, o, table, n_blocks, band, N, K, sXm, sWg,
                             sWk, sWn, sOm, sOn, stream);
  } else if (wnk) {
    run_bf16<TOut, C, true, true>(x, w, o, table, n_blocks, band, N, K, sXm,
                                  sXk, sWg, sWk, sWn, sOm, sOn, stream);
  } else if constexpr (C::BM == 16) {  // the serving body
    run_serve<TOut>(x, w, o, table, n_blocks, N, K, sXm, sWg, sWk, sOm, sOn,
                    stream);
  } else {
    run_bf16<TOut, C, true, false>(x, w, o, table, n_blocks, band, N, K, sXm,
                                   sXk, sWg, sWk, sWn, sOm, sOn, stream);
  }
}

// The body of the M tile ``tile_m`` (16, 32, 64 or 128; 0, which no
// aligned call takes, for the element-wise body); false for another tile.
template <typename TOut>
bool launch_bf16_tile(int tile_m, const void* X, const void* W, void* O,
                      const int* table, int n_blocks, int band, int N, int K,
                      long long sXm, long long sXk, long long sWg,
                      long long sWk, long long sWn, long long sOm,
                      long long sOn, cudaStream_t stream) {
  if (tile_m == 16)
    launch_bf16<TOut, Cfg<16, 32, 1>>(X, W, O, table, n_blocks, band, N, K,
                                      sXm, sXk, sWg, sWk, sWn, sOm, sOn,
                                      stream);
  else if (tile_m == 32)
    launch_bf16<TOut, Cfg<32, 32, 1>>(X, W, O, table, n_blocks, band, N, K,
                                      sXm, sXk, sWg, sWk, sWn, sOm, sOn,
                                      stream);
  else if (tile_m == 64)
    launch_bf16<TOut, Cfg<64, 32, 1>>(X, W, O, table, n_blocks, band, N, K,
                                      sXm, sXk, sWg, sWk, sWn, sOm, sOn,
                                      stream);
  else if (tile_m == 128 || tile_m == 0)
    launch_bf16<TOut, Cfg<128, 64, 2>>(X, W, O, table, n_blocks, band, N, K,
                                       sXm, sXk, sWg, sWk, sWn, sOm, sOn,
                                       stream);
  else
    return false;
  return true;
}

template <typename TOut>
void launch_f32(const void* X, const void* W, void* O, const int* table,
                int n_blocks, int N, int K, long long sXm, long long sXk,
                long long sWg, long long sWk, long long sWn, long long sOm,
                long long sOn, cudaStream_t stream) {
  const dim3 grid((N + F_BN - 1) / F_BN, n_blocks);
  grouped_f32_kernel<TOut><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const float*>(X), static_cast<const float*>(W),
      static_cast<TOut*>(O), table, N, K, sXm, sXk, sWg, sWk, sWn, sOm, sOn);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements.  table
// is a device array of n_blocks (group id, first row, rows) triples, one per
// row block: no block spans two groups, and none holds more rows than the
// plan's M tile.  The plan (fused_gen.FusedPlan: the searched one, else
// the tile fused_gen picks from the table) is the M tile ``tile_m``: 16,
// 32, 64 or 128 for bf16 operands that take 16-byte copies (bf16_vec), 0
// for the bodies that take no plan (f32 operands, element-wise copies).  A
// plan the call cannot take is refused with cudaErrorInvalidValue, never
// swapped for another.  band is the number of row blocks rasterized side
// by side (the most any group has).  W's element (g, k, n) of the product
// is W[g * sWg + k * sWk + n * sWn].  Returns cudaGetLastError() after the
// launch (0 = launched); nothing is synchronised, and nothing is allocated
// here.
int grouped_launch_plan(int tile_m, int in_dtype, int out_dtype,
                        const void* X, const void* W, void* O,
                        const int* table, int n_blocks, int band, int N,
                        int K, long long sXm, long long sXk, long long sWg,
                        long long sWk, long long sWn, long long sOm,
                        long long sOn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      n_blocks < 1 || band < 1 || N < 1)
    return invalid;
  const bool planned =
      in_dtype == 1 && bf16_vec(X, W, N, K, sXm, sXk, sWg, sWk, sWn);
  if (planned != (tile_m != 0)) return invalid;
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      launch_f32<float>(X, W, O, table, n_blocks, N, K, sXm, sXk, sWg, sWk,
                        sWn, sOm, sOn, s);
      break;
    case 1:
      launch_f32<__nv_bfloat16>(X, W, O, table, n_blocks, N, K, sXm, sXk,
                                sWg, sWk, sWn, sOm, sOn, s);
      break;
    case 2:
      if (!launch_bf16_tile<float>(tile_m, X, W, O, table, n_blocks, band, N,
                                   K, sXm, sXk, sWg, sWk, sWn, sOm, sOn, s))
        return invalid;
      break;
    default:
      if (!launch_bf16_tile<__nv_bfloat16>(tile_m, X, W, O, table, n_blocks,
                                           band, N, K, sXm, sXk, sWg, sWk,
                                           sWn, sOm, sOn, s))
        return invalid;
  }
  return static_cast<int>(cudaGetLastError());
}

// The largest row block the kernel takes (its largest M tile), checked
// against the Python side's table at load.
int grouped_max_rows(void) { return GROUPED_MAX_ROWS; }

}  // extern "C"
