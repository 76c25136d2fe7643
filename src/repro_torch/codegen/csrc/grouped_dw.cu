// Grouped weight gradient of the MoE expert products for Hopper:
//
//   out[g, k1, k2] = sum_{n in group g} x[n, k1] * dout[n, k2]
//
// Replaces the reference's Pallas kernel B4 (src/repro/codegen/fused_gen.py:
// _grouped_dw_fn, pl.pallas_call at :309), the dW mode of the ragged grouped
// GEMM (the derived spec grouped_matmul.dW).  Rows are partitioned into
// contiguous groups with static offsets; the host builds a device table of
// EVERY group (group id, first row, row count), empty ones included.
//
// The TPU kernel runs one grid step per (group, column block) and reads all
// N rows of both operands each time, zeroing the rows outside the group with
// a mask, so an empty group comes out as exact zeros.  Here every body reads
// only its group's rows; in the mma.sync body one CTA owns one
// (group, 64-row block of K1, 128-column block of K2) tile of the output and
// reads only its own group's rows: they stream through shared memory in
// steps of 32 (the reduction axis is the row axis n), and the f32
// accumulator stays in registers.  A CTA of an empty group runs no step and
// stores its zero accumulator, which is the exact-zero slab the reference
// gives; rows past the group's end are zero on load.
//
// What bounds it on the H100: at kimi-k2's expert shapes a training step of
// 1024 tokens puts C = 28 rows in each of 384 groups, and the output is the
// whole expert slab (384 x 7168 x 2048 bf16 = 11.27 GB) against 0.3 GB of
// operands and 0.3 ms of bf16 tensor-core math: the kernel is bound by the
// bytes it stores (3.4 ms).  On the MoE training path's cut (32 groups of
// C = 320) the two sides are near balance: 0.30 ms of tensor-core math and
// 0.34 ms of bytes a call (the output's 0.94 GB most of them), so a body
// that does not overlap its stores with the next tile's products cannot
// approach the bound.
// Three bodies (codegen.fused_gen.grouped_dw_body picks; the C side
// refuses a body the call cannot take):
//   * the ring (body 1), for bf16 operands TMA can read (unit stride along
//     K1 and K2, K1 and K2 multiples of 8, row strides multiples of 16
//     bytes, 16-byte aligned bases): hopper.cuh's skeleton, persistent.
//     One CTA an SM walks the (group, 128-row K1 tile, 256-column K2
//     tile) tiles with a static stride (no tile counter, so no scratch);
//     a searched plan (grouped_dw_launch_plan, fused_gen.FusedPlan) may
//     take 128-column tiles and a CTA count of its own instead;
//     one producer thread keeps TMA loads of 64-row K steps in flight
//     across tiles into three 48 KB stages; two consumer warpgroups run
//     wgmma m64n256k16 with x_g^T (M-major) and dout_g (N-major) read
//     through the transposed descriptors.  A group's last step zeroes
//     the next group's rows in x's tile before its wgmmas.  A finished
//     tile is staged per warpgroup (2 x 32 KB outside the ring) and
//     written by TMA stores that run on while the next tile's products
//     start (see grouped_dw_bf16_ring_kernel);
//   * other bf16 operands run on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//     accumulate), 4 warps of 32 x 64.  Both operand tiles are n-major as
//     they lie in memory (x as [n][k1], dout as [n][k2], rows padded by 8
//     elements so the eight rows of an ldmatrix phase hit distinct banks),
//     and both fragments come through ldmatrix.trans: the A fragment of the
//     product is x's tile transposed, the B fragment dout's, as B3's W tile.
//     Tiles stream with 16-byte cp.async into a three-stage ring when both
//     operands have unit stride along their columns and 16-byte aligned
//     rows; otherwise the same body loads element-wise.
//     Its stores are 4 bytes a thread straight from the mma fragments;
//   * f32 operands keep exact f32 math on the FMA pipes (a 64 x 64 tile,
//     256 threads of 4 x 4 outputs).
// Accumulation is f32; the store rounds once to the output type (round to
// nearest even for bf16), as the reference's f32 result is cast once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// bf16 body (tensor cores)
constexpr int BM = 64;   // K1 rows of the output tile
constexpr int BN = 128;  // K2 columns of the output tile
constexpr int BK = 32;   // group rows a step (the reduction)
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int LDX = BM + 8;  // padded x row: 144 bytes
constexpr int LDD = BN + 8;  // padded dout row: 272 bytes

// f32 body (FMA pipes)
constexpr int F_BM = 64;
constexpr int F_BN = 64;
constexpr int F_BK = 16;
constexpr int F_THREADS = 256;

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// two neighbouring outputs of one row, as one 8- or 4-byte store
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
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

// four 8x8 b16 matrices, transposed: thread i gets rows 2(i%4), 2(i%4)+1 of
// column i/4 of each
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

// One step of the bf16 body into one ring slot: group rows [r0, r0 + BK)
// (zero at and past `size`) of the x tile [m0, m0 + BM) and of the dout
// tile [n0, n0 + BN).
template <bool VEC>
__device__ __forceinline__ void load_tiles(
    __nv_bfloat16 (*xs)[LDX], __nv_bfloat16 (*ds)[LDD],
    const __nv_bfloat16* X, const __nv_bfloat16* Xg, const __nv_bfloat16* D,
    const __nv_bfloat16* Dg, int size, int r0, int m0, int n0, int K1,
    int K2, long long sXn, long long sXk, long long sDn, long long sDk) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < BK * BM / 8 / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v >> 3;
      const int c = (v & 7) * 8;
      const bool ok = r0 + r < size && m0 + c < K1;
      cp_async16(&xs[r][c], ok ? Xg + (r0 + r) * sXn + m0 + c : X, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v >> 4;
      const int c = (v & 15) * 8;
      const bool ok = r0 + r < size && n0 + c < K2;
      cp_async16(&ds[r][c], ok ? Dg + (r0 + r) * sDn + n0 + c : D, ok);
    }
  } else {
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int r = e / BM;
      const int c = e % BM;
      xs[r][c] = (r0 + r < size && m0 + c < K1)
                     ? Xg[(r0 + r) * sXn + (m0 + c) * sXk]
                     : __float2bfloat16(0.f);
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      ds[r][c] = (r0 + r < size && n0 + c < K2)
                     ? Dg[(r0 + r) * sDn + (n0 + c) * sDk]
                     : __float2bfloat16(0.f);
    }
  }
}

// VEC: x and dout have unit stride along their columns, K1 and K2 are
// multiples of 8 and every row starts 16-byte aligned.
template <typename TOut, bool VEC>
__global__ void __launch_bounds__(THREADS)
grouped_dw_bf16_mma_kernel(const __nv_bfloat16* __restrict__ X,
                           const __nv_bfloat16* __restrict__ D,
                           TOut* __restrict__ O, const int* __restrict__ table,
                           int K1, int K2, long long sXn, long long sXk,
                           long long sDn, long long sDk, long long sOg,
                           long long sOm, long long sOn) {
  __shared__ __align__(16) __nv_bfloat16 Xs[STAGES][BK][LDX];  // [n][k1]
  __shared__ __align__(16) __nv_bfloat16 Ds[STAGES][BK][LDD];  // [n][k2]

  const int gid = table[3 * blockIdx.z];
  const int start = table[3 * blockIdx.z + 1];
  const int size = table[3 * blockIdx.z + 2];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const __nv_bfloat16* Xg = X + start * sXn;
  const __nv_bfloat16* Dg = D + start * sDn;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  const int nk = (size + BK - 1) / BK;  // 0 for an empty group

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_tiles<VEC>(Xs[s], Ds[s], X, Xg, D, Dg, size, s * BK, m0, n0, K1,
                      K2, sXn, sXk, sDn, sDk);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed (this thread's)
    __syncthreads();              // ... and everyone's; slot kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_tiles<VEC>(Xs[nxt % STAGES], Ds[nxt % STAGES], X, Xg, D, Dg, size,
                      nxt * BK, m0, n0, K1, K2, sXn, sXk, sDn, sDk);
    cp_async_commit();
    const int slot = kt % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // A[m][k] = x[k][m]: matrix j of the x4 load covers rows (k)
      // ks + 8 (j / 2) .. + 8 and columns (m) 8 (j % 2) .. + 8, so the four
      // registers are a0..a3 of the m16n8k16 A fragment
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi],
                          &Xs[slot][ks + (lane >> 4) * 8 + (lane & 7)]
                             [wm + mi * 16 + ((lane >> 3) & 1) * 8]);
      uint32_t bf[8][2];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, &Ds[slot][ks + (lane & 15)][wn + p * 16 + (lane >> 4) * 8]);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16816(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: e = 2h + j holds row g + 8h, column 2t + j
  TOut* Og = O + gid * sOg;
  const bool pairs =
      sOn == 1 && sOm % 2 == 0 && sOg % 2 == 0 &&
      reinterpret_cast<uintptr_t>(O) % (2 * sizeof(TOut)) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + 8 * h;
      if (row >= K1) continue;
      TOut* Orow = Og + row * sOm;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        const float a = acc[mi][ni][2 * h];
        const float b = acc[mi][ni][2 * h + 1];
        if (pairs && n + 1 < K2) {
          store_pair(Orow + n, a, b);
        } else {
          if (n < K2) store_from_f32(Orow + n * sOn, a);
          if (n + 1 < K2) store_from_f32(Orow + (n + 1) * sOn, b);
        }
      }
    }
}

template <typename TOut>
__global__ void __launch_bounds__(F_THREADS)
grouped_dw_f32_kernel(const float* __restrict__ X, const float* __restrict__ D,
                      TOut* __restrict__ O, const int* __restrict__ table,
                      int K1, int K2, long long sXn, long long sXk,
                      long long sDn, long long sDk, long long sOg,
                      long long sOm, long long sOn) {
  __shared__ float Xs[F_BK][F_BM];  // [n][k1]
  __shared__ float Ds[F_BK][F_BN];  // [n][k2]

  const int gid = table[3 * blockIdx.z];
  const int start = table[3 * blockIdx.z + 1];
  const int size = table[3 * blockIdx.z + 2];
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;
  const float* Xg = X + start * sXn;
  const float* Dg = D + start * sDn;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx + 16 j
  const int ty = tid / 16;  // rows ty + 16 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < size; r0 += F_BK) {
    for (int e = tid; e < F_BK * F_BM; e += F_THREADS) {
      const int r = e / F_BM;
      const int c = e % F_BM;
      Xs[r][c] = (r0 + r < size && m0 + c < K1)
                     ? Xg[(r0 + r) * sXn + (m0 + c) * sXk]
                     : 0.f;
    }
    for (int e = tid; e < F_BK * F_BN; e += F_THREADS) {
      const int r = e / F_BN;
      const int c = e % F_BN;
      Ds[r][c] = (r0 + r < size && n0 + c < K2)
                     ? Dg[(r0 + r) * sDn + (n0 + c) * sDk]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ds[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  TOut* Og = O + gid * sOg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= K1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < K2) store_from_f32(Og + row * sOm + n * sOn, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The ring body (body 1): bf16 operands TMA can read, on hopper.cuh's
// skeleton, persistent
// ---------------------------------------------------------------------------
constexpr int W_BM = 128;  // K1 rows of the output tile: 64 a warpgroup
constexpr int W_BN = 256;  // K2 columns (without a plan)
constexpr int W_BN_NARROW = 128;  // the K2 width a plan may take instead
constexpr int W_BK = 64;   // group rows a step (the reduction)
constexpr int W_THREADS = 384;
constexpr int W_A_BYTES = W_BM * W_BK * 2;               // 16 KB of x
constexpr int W_STAGES = 3;
// The ring's shared memory at a tile of BN K2 columns (W_BN or
// W_BN_NARROW): three stages of x and dout, the two warpgroups' staged
// output, 1024 bytes to align them, full and empty barriers.
template <int BN>
struct DwRing {
  static constexpr int STAGE = W_A_BYTES + W_BK * BN * 2;  // + dout's rows
  static constexpr int ACC = BN / 2;  // f32 accumulators of a consumer
  static constexpr int HALF_OUT = 64 * BN * 2;  // a warpgroup's bf16 rows
  static constexpr int SMEM =
      W_STAGES * STAGE + 2 * HALF_OUT + 1024 + 2 * W_STAGES * 8;
};

// The ring's tile walk: tile ``t`` of the (group, K1 tile, K2 tile)
// tiles, the K1 tiles of one K2 tile of a group walked first, so CTAs
// resident together share dout's tile through L2.  Tiles of an empty
// group run no step.
struct DwTile {
  int gid, start, size, m_t, n_t;
};
__device__ __forceinline__ DwTile dw_tile(const int* table, int t, int tm,
                                          int tn) {
  const int per = tm * tn;
  const int e = t / per, r = t - e * per;
  return {__ldg(table + 3 * e), __ldg(table + 3 * e + 1),
          __ldg(table + 3 * e + 2), r % tm, r / tm};
}

// The ring kernel, persistent: CTA b takes tiles b, b + grid, ... of the
// walk (dw_tile) and keeps the ring running across them.  Warpgroup 0's
// thread 0 loads each 64-row K step of the tile's group: x's rows by tmX
// ((K1, rows), two boxes of 64 k1 x 64 rows, read M-major through the
// transposed descriptor) and dout's by tmD ((K2, rows), four boxes of 64
// k2 x 64 rows, N-major); TMA zero-fills past the tensor's last row.
// Warpgroups 1 and 2 take 64 of the tile's K1 rows each and run wgmma
// m64n256k16 (A = x_g^T, B = dout_g, both transposed).  A group's last
// step reads the next group's first rows: before its wgmmas each
// warpgroup writes zeros over those rows of its own x atom (whole
// 128-byte rows, so the swizzle does not matter) and fences them for the
// async proxy, so they add nothing (one operand suffices: the reduction
// runs over rows).  A finished tile is stored from shared memory: each
// warpgroup writes its 64 x 256 bf16 rows into its staging buffer in the
// 128-byte swizzled layout (conflict-free) and one thread stores them
// with four TMA stores (tmO: (K2, K1, groups), boxes of 64 x 64,
// clipped at the edges), which run on while the warpgroup starts the
// next tile; the buffer is written again once those stores have read it.
// f32 output is stored from the fragments.  An empty group's tiles store
// zeros, the reference's exact-zero slab.
template <typename TOut, int BN>
__global__ void __launch_bounds__(W_THREADS, 1)
grouped_dw_bf16_ring_kernel(const __grid_constant__ CUtensorMap tmX,
                            const __grid_constant__ CUtensorMap tmD,
                            const __grid_constant__ CUtensorMap tmO,
                            TOut* __restrict__ O,
                            const int* __restrict__ table, int n_groups,
                            int K1, int K2, long long sOg, long long sOm,
                            long long sOn) {
  using R = DwRing<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* tiles =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staged = tiles + W_STAGES * R::STAGE;  // 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + 2 * R::HALF_OUT);
  uint64_t* empty = full + W_STAGES;

  const int tm = (K1 + W_BM - 1) / W_BM;
  const int tn = (K2 + BN - 1) / BN;
  const int count = n_groups * tm * tn;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer group
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tmX);
      hopper::tma_prefetch(&tmD);
      int it = 0;
      for (int t = blockIdx.x; t < count; t += gridDim.x) {
        const DwTile d = dw_tile(table, t, tm, tn);
        const int steps = (d.size + W_BK - 1) / W_BK;
        for (int i = 0; i < steps; ++i, ++it) {
          const int s = it % W_STAGES;
          hopper::mbar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
          hopper::mbar_arrive_tx(&full[s], R::STAGE);
          unsigned char* a = tiles + s * R::STAGE;
          unsigned char* b = a + W_A_BYTES;
          const int row = d.start + i * W_BK;
          hopper::tma_load(a, &tmX, &full[s], d.m_t * W_BM, row, 0);
          hopper::tma_load(a + 8192, &tmX, &full[s], d.m_t * W_BM + 64, row,
                           0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load(b + j * 8192, &tmD, &full[s],
                             d.n_t * BN + 64 * j, row, 0);
        }
      }
    }
    return;
  }

  hopper::regs_inc<232>();
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int half = ct >> 7;          // its warpgroup's 64 rows of K1
  const int wt = ct & 127;           // thread of the warpgroup
  const int lane = ct & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r_w = 16 * ((ct >> 5) & 3) + g;  // the thread's rows r_w, + 8
  const uint32_t base = hopper::smem_u32(tiles);
  unsigned char* mine = staged + half * R::HALF_OUT;
  float acc[R::ACC];
  int it = 0;
  for (int t = blockIdx.x; t < count; t += gridDim.x) {
    const DwTile d = dw_tile(table, t, tm, tn);
    const int steps = (d.size + W_BK - 1) / W_BK;
#pragma unroll
    for (int i = 0; i < R::ACC; ++i) acc[i] = 0.f;
    for (int i = 0; i < steps; ++i, ++it) {
      const int s = it % W_STAGES;
      hopper::mbar_wait(&full[s], (it / W_STAGES) & 1);
      const uint32_t a = base + s * R::STAGE + half * 8192;
      const uint32_t b = base + s * R::STAGE + W_A_BYTES;
      const int valid = d.size - i * W_BK;
      if (valid < W_BK) {
        // rows [valid, 64) of this warpgroup's x atom are the next group's
        uint4* atom = reinterpret_cast<uint4*>(tiles + s * R::STAGE +
                                               half * 8192 + valid * 128);
        for (int c = wt; c < (W_BK - valid) * 8; c += 128)
          atom[c] = make_uint4(0u, 0u, 0u, 0u);
        hopper::fence_proxy_async();
        hopper::bar_sync(2 + half, 128);
      }
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hopper::wgmma_bf16<1, 1>(acc, hopper::desc(a + ks * 2048, 8192, 1024),
                                 hopper::desc(b + ks * 2048, 8192, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (i > 0 && wt == 0)
        hopper::mbar_arrive(&empty[(it - 1) % W_STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (steps > 0 && wt == 0) hopper::mbar_arrive(&empty[(it - 1) % W_STAGES]);

    // accumulator d[4j + 2h + e]: row r_w + 8h of the warpgroup's 64,
    // column 8j + 2q + e of the tile's 256
    const int row0 = d.m_t * W_BM + half * 64;
    const int col0 = d.n_t * BN;
    if constexpr (sizeof(TOut) == 2) {
      if (wt == 0) hopper::bulk_wait_read<0>();  // the last tile's stores
      hopper::bar_sync(2 + half, 128);
#pragma unroll
      for (int j = 0; j < R::ACC / 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_w + 8 * h;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              mine + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ (r & 7)) << 4) +
              4 * q) = v;
        }
      hopper::fence_proxy_async();
      hopper::bar_sync(2 + half, 128);
      if (wt == 0) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_store(&tmO, mine + j * 8192, col0 + 64 * j, row0,
                            d.gid);
        hopper::bulk_commit();
      }
    } else {
      const bool pair = sOn == 1 && sOm % 2 == 0 && sOg % 2 == 0;
      TOut* Og = O + d.gid * sOg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r_w + 8 * h;
        if (row >= K1) continue;
        TOut* Orow = Og + row * sOm;
#pragma unroll
        for (int j = 0; j < R::ACC / 4; ++j) {
          const int n = col0 + 8 * j + 2 * q;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (pair && n + 1 < K2) {
            store_pair(Orow + n, v0, v1);
          } else {
            if (n < K2) store_from_f32(Orow + n * sOn, v0);
            if (n + 1 < K2) store_from_f32(Orow + (n + 1) * sOn, v1);
          }
        }
      }
    }
  }
  if (sizeof(TOut) == 2 && wt == 0) hopper::bulk_wait_all();
}

// Can the ring take the call: bf16 x and dout with unit stride along K1 /
// K2, K1 and K2 multiples of 8, row strides multiples of 8 elements (16
// bytes), 16-byte aligned bases, at least one row; a bf16 output stored
// by TMA must be the same (unit stride along K2, the other strides
// multiples of 16 bytes, 16-byte aligned); a tile count within int.
// codegen.fused_gen.grouped_dw_body states the operands' part of it.
bool ring_ok(int in_dtype, int out_dtype, const void* X, const void* D,
             const void* O, int n_rows, int n_groups, int K1, int K2,
             long long sXn, long long sXk, long long sDn, long long sDk,
             long long sOg, long long sOm, long long sOn) {
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const auto row_ok = [&](long long s) {
    return n_rows == 1 || (s > 0 && s % 8 == 0);
  };
  const long long tiles = (long long)n_groups * ((K1 + W_BM - 1) / W_BM) *
                          ((K2 + W_BN - 1) / W_BN);
  return in_dtype == 1 && n_rows >= 1 && K1 % 8 == 0 && K2 % 8 == 0 &&
         (sXk == 1 || K1 == 1) && (sDk == 1 || K2 == 1) && row_ok(sXn) &&
         row_ok(sDn) && aligned(X) && aligned(D) && tiles < (1LL << 31) &&
         (out_dtype == 0 ||
          (aligned(O) && sOn == 1 && sOm % 8 == 0 && sOg % 8 == 0));
}

// ``ctas`` persistent CTAs, at most one a tile, on tiles of BN K2 columns
template <typename TOut, int BN>
int launch_ring(const void* X, const void* D, void* O, const int* table,
                int n_rows, int n_groups, int K1, int K2, long long sXn,
                long long sDn, long long sOg, long long sOm, long long sOn,
                int ctas, cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, td, to{};
  const hopper::Operand x{X, K1, n_rows, sXn, 1, 0};
  const hopper::Operand d{D, K2, n_rows, sDn, 1, 0};
  if (!hopper::make_map(&tx, x, 2, bf16, 64, W_BK) ||
      !hopper::make_map(&td, d, 2, bf16, 64, W_BK))
    return invalid;
  if (sizeof(TOut) == 2) {
    const hopper::Operand o{O, K2, K1, sOm, n_groups, sOg};
    if (!hopper::make_map(&to, o, 2, bf16, 64, 64)) return invalid;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_dw_bf16_ring_kernel<TOut, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DwRing<BN>::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (ctas < 1) return invalid;
  const long long tiles = (long long)n_groups * ((K1 + W_BM - 1) / W_BM) *
                          ((K2 + BN - 1) / BN);
  if (tiles >= (1LL << 31)) return invalid;  // (ring_ok counts W_BN's)
  const unsigned grid = (unsigned)(tiles < ctas ? tiles : ctas);
  grouped_dw_bf16_ring_kernel<TOut, BN>
      <<<grid, W_THREADS, DwRing<BN>::SMEM, stream>>>(
      tx, td, to, static_cast<TOut*>(O), table, n_groups, K1, K2, sOg, sOm,
      sOn);
  return static_cast<int>(cudaGetLastError());
}

// The ring at a tile width of ``width`` K2 columns (W_BN or W_BN_NARROW)
// and ``ctas`` CTAs, into an output of ``out_dtype``
int launch_ring_width(int width, int ctas, int out_dtype, const void* X,
                      const void* D, void* O, const int* table, int n_rows,
                      int n_groups, int K1, int K2, long long sXn,
                      long long sDn, long long sOg, long long sOm,
                      long long sOn, cudaStream_t s) {
  if (width == W_BN)
    return out_dtype == 1
               ? launch_ring<__nv_bfloat16, W_BN>(X, D, O, table, n_rows,
                                                  n_groups, K1, K2, sXn, sDn,
                                                  sOg, sOm, sOn, ctas, s)
               : launch_ring<float, W_BN>(X, D, O, table, n_rows, n_groups,
                                          K1, K2, sXn, sDn, sOg, sOm, sOn,
                                          ctas, s);
  if (width == W_BN_NARROW)
    return out_dtype == 1
               ? launch_ring<__nv_bfloat16, W_BN_NARROW>(
                     X, D, O, table, n_rows, n_groups, K1, K2, sXn, sDn, sOg,
                     sOm, sOn, ctas, s)
               : launch_ring<float, W_BN_NARROW>(X, D, O, table, n_rows,
                                                 n_groups, K1, K2, sXn, sDn,
                                                 sOg, sOm, sOn, ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TOut>
void launch_bf16(const void* X, const void* D, void* O, const int* table,
                 int n_groups, int K1, int K2, long long sXn, long long sXk,
                 long long sDn, long long sDk, long long sOg, long long sOm,
                 long long sOn, cudaStream_t stream) {
  const dim3 grid((K2 + BN - 1) / BN, (K1 + BM - 1) / BM, n_groups);
  const bool vec = sXk == 1 && sDk == 1 && K1 % 8 == 0 && K2 % 8 == 0 &&
                   sXn % 8 == 0 && sDn % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(D) % 16 == 0;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(X);
  const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(D);
  TOut* o = static_cast<TOut*>(O);
  if (vec)
    grouped_dw_bf16_mma_kernel<TOut, true><<<grid, THREADS, 0, stream>>>(
        x, d, o, table, K1, K2, sXn, sXk, sDn, sDk, sOg, sOm, sOn);
  else
    grouped_dw_bf16_mma_kernel<TOut, false><<<grid, THREADS, 0, stream>>>(
        x, d, o, table, K1, K2, sXn, sXk, sDn, sDk, sOg, sOm, sOn);
}

template <typename TOut>
void launch_f32(const void* X, const void* D, void* O, const int* table,
                int n_groups, int K1, int K2, long long sXn, long long sXk,
                long long sDn, long long sDk, long long sOg, long long sOm,
                long long sOn, cudaStream_t stream) {
  const dim3 grid((K2 + F_BN - 1) / F_BN, (K1 + F_BM - 1) / F_BM, n_groups);
  grouped_dw_f32_kernel<TOut><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const float*>(X), static_cast<const float*>(D),
      static_cast<TOut*>(O), table, K1, K2, sXn, sXk, sDn, sDk, sOg, sOm,
      sOn);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  The plan (fused_gen.FusedPlan:
// the searched one, else fused_gen.grouped_dw_plan's) picks the body: the
// ring (bf16 operands TMA can read, ring_ok) on tiles of ``tile_n`` K2
// columns (W_BN or W_BN_NARROW) and a persistent grid of ``ctas`` >= 1
// CTAs (at most one a tile); no plan (``tile_n`` and ``ctas`` 0) the body
// of the operands' dtype, mma.sync (bf16) or FMA (f32).  A plan the call
// cannot take is refused (cudaErrorInvalidValue), never swapped.  Strides
// are in elements.  table is a device array of n_groups (group id, first
// row, row count) triples, one for every group of the partition, empty
// ones included, in row order and covering rows [0, n_rows); x is
// (n_rows, K1) and dout (n_rows, K2) with element (n, k) at n * sXn + k *
// sXk (sDn, sDk), and out's element (g, k1, k2) is at g * sOg + k1 * sOm +
// k2 * sOn.  Returns cudaGetLastError() after the launch (0 = launched);
// nothing is synchronised, and nothing is allocated here.
int grouped_dw_launch_plan(int tile_n, int ctas, int in_dtype, int out_dtype,
                           const void* X, const void* D, void* O,
                           const int* table, int n_rows, int n_groups, int K1,
                           int K2, long long sXn, long long sXk,
                           long long sDn, long long sDk, long long sOg,
                           long long sOm, long long sOn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      n_groups < 1 || K1 < 1 || K2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_n != 0 || ctas != 0) {
    if (!ring_ok(in_dtype, out_dtype, X, D, O, n_rows, n_groups, K1, K2, sXn,
                 sXk, sDn, sDk, sOg, sOm, sOn))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_ring_width(tile_n, ctas, out_dtype, X, D, O, table, n_rows,
                             n_groups, K1, K2, sXn, sDn, sOg, sOm, sOn, s);
  }
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      launch_f32<float>(X, D, O, table, n_groups, K1, K2, sXn, sXk, sDn, sDk,
                        sOg, sOm, sOn, s);
      break;
    case 1:
      launch_f32<__nv_bfloat16>(X, D, O, table, n_groups, K1, K2, sXn, sXk,
                                sDn, sDk, sOg, sOm, sOn, s);
      break;
    case 2:
      launch_bf16<float>(X, D, O, table, n_groups, K1, K2, sXn, sXk, sDn,
                         sDk, sOg, sOm, sOn, s);
      break;
    default:
      launch_bf16<__nv_bfloat16>(X, D, O, table, n_groups, K1, K2, sXn, sXk,
                                 sDn, sDk, sOg, sOm, sOn, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// grouped_dw_launch_plan of a named body for callers that hold no plan:
// body 0 the mma.sync or FMA body, 1 the ring on grouped_dw_plan's plan
// (W_BN, one CTA an SM); the other arguments as grouped_dw_launch_plan's.
int grouped_dw_launch(int body, int in_dtype, int out_dtype, const void* X,
                      const void* D, void* O, const int* table, int n_rows,
                      int n_groups, int K1, int K2, long long sXn,
                      long long sXk, long long sDn, long long sDk,
                      long long sOg, long long sOm, long long sOn,
                      void* stream) {
  int tile_n = 0, ctas = 0;
  if (body == 1) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&ctas, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return static_cast<int>(cudaErrorInvalidValue);
    tile_n = W_BN;
  } else if (body != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return grouped_dw_launch_plan(tile_n, ctas, in_dtype, out_dtype, X, D, O,
                                table, n_rows, n_groups, K1, K2, sXn, sXk,
                                sDn, sDk, sOg, sOm, sOn, stream);
}

}  // extern "C"
