// The hand-written GEMM kernels of repro_torch.kernels, for Hopper: the
// counterparts of the reference's three hand-written Pallas kernels, kept as
// the baselines of the generated contraction kernel (csrc/contract.cu).
//
//   kind 0, B5  C = A @ B                  src/repro/kernels/matmul/matmul.py:
//               matmul_pallas (_matmul_kernel)
//   kind 1, B6  C = act((A @ B + beta - mean) * rsqrt(var + eps))
//               src/repro/kernels/fused_dense_act/fused_dense_act.py:
//               fused_dense_act_pallas (_fused_dense_kernel), paper eqs 3-5
//   kind 2, B7  C = (A . diag(g)) @ B, with a * g rounded to the operand
//               type before the product, as the TPU kernel scales its VMEM
//               A block in the input dtype
//               src/repro/kernels/fused_rnz/fused_rnz.py:
//               weighted_matmul_pallas (_fused_rnz_kernel), paper eq 2
//
// A (M, K), B (K, N) and C (M, N) are row-major and contiguous, g is (K,)
// in the operand type, beta / mean / var are (N,) float32.  B7 is a
// prologue on A (scaled by g after it leaves shared memory, before the
// product), B6 an epilogue on the f32 accumulator, before the one store.
//
// The TPU kernels walk a 3-D grid (M/bm, N/bn, K/bk) whose last axis is
// sequential and carry the f32 accumulator across it in VMEM.  Here a CTA
// owns an output tile of its own size (the caller's block sizes are
// checked to divide the extents, as the reference asserts, but do not set
// the CUDA tile) and loops over K itself, keeping the accumulator in
// registers.  Ragged edges are masked, so any M, N, K is legal.
//
// What bounds it on the H100: at the fused path's shape (M = 2048 tokens,
// K = 4096, N = 12288, bf16) a call does 206 GFLOP on 168 MB, 1229
// operations a byte, so the tensor-core rate bounds it (0.2085 ms at 989
// TFLOP/s).  Three bodies, picked by the caller (kernels/_baselines.py,
// baseline_body) and checked here (a body the operands cannot take is
// refused, never swapped):
//   * the ring body (body 1), B5, B6 and B7 with bf16 operands that TMA
//     can read (16-byte aligned A, B and g, K and N multiples of 8), on
//     hopper.cuh's building blocks.  A CTA of three warpgroups owns a 128
//     x 256 tile: warpgroup 0 gives its registers away (setmaxnreg) and
//     one of its threads keeps TMA loads of 64-deep K steps in flight into
//     a ring of 4 stages of 48 KB (A K-major as it lies, 128 x 64; B
//     N-major as it lies, four 64-column atoms read through the transposed
//     descriptor; 128-byte swizzle), a full and an empty mbarrier a stage;
//     warpgroups 1 and 2 take 64 rows each and run wgmma m64n256k16, one
//     group in flight across K steps.  The grid is persistent (one CTA an
//     SM, tiles dealt in bands of 8 row tiles, hopper::raster): the ring
//     runs on across tiles, so the producer loads the next tile's first
//     stages while the consumers store the last one.  At the fused path's
//     shape that is 16 x 48 = 768 tiles, 5.8 a CTA, so K is not split.
//     TMA zero-fills the boxes past M, N and K; the store is masked.  B7's
//     prologue takes A through registers: ldmatrix from the swizzled tile,
//     scaled by g in f32 (a bf16 x bf16 product is exact there), rounded to
//     bf16, fed to the register-A wgmma with B in shared memory; the
//     stage's 64 values of g come by TMA with the stage.  A warpgroup
//     waits for its own group before it writes the next fragments (ptxas
//     serializes every wgmma of a kernel whose register operands are
//     written while a group is in flight, C7513); the other warpgroup's
//     group keeps the tensor cores busy meanwhile, and at n256 each
//     fragment feeds twice the work it feeds at B1's n128 (contract.cu's
//     k-scale ring).  B6's epilogue runs on the f32 fragments before the
//     store: at the start of each tile the 256 consumer threads stage the
//     tile's columns of beta, mean and rsqrt(var + eps) in shared memory,
//     one column each, and meet at a named barrier (the producer is
//     elsewhere in the ring); the factors are double-buffered by the
//     CTA's tile parity, so a slow warpgroup still storing the last tile
//     reads its own buffer (the barrier of the tile between orders the
//     next write after it).  The store reads each column pair's factors
//     as float2s, so no factor lives in a register array beside the 128
//     accumulators;
//   * the mma.sync body (body 0), every other bf16 call (unaligned
//     operands, K or N not a multiple of 8): mma.sync m16n8k16
//     (bf16 in, f32 accumulate) on a 64 x 128 tile, 4 warps of 64 x 32;
//     K streams in steps of 32 through a three-stage cp.async ring
//     (16-byte copies, two K steps in flight while a third is computed).
//     B stays k-major as it lies (rows padded to 136 elements) and reaches
//     the B fragments through ldmatrix.trans; A rows are padded to 40
//     elements so fragment loads are conflict-free.  Without 16-byte
//     alignment or with K or N not a multiple of 8 the same body loads
//     element-wise;
//   * the FMA body (body 2): f32 operands keep exact f32 math on the FMA
//     pipes, a 128 x 64 tile, each of 256 threads owning an 8 x 4
//     micro-tile.
// Accumulation is f32; the store rounds once to the output type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

extern "C" {

struct BaselineParams {
  const void* A;
  const void* B;
  void* C;
  const void* g;       // B7: (K,) in the operand type
  const float* beta;   // B6: (N,) float32 each
  const float* mean;
  const float* var;
  long long M, N, K;
  float eps;
  int act;             // 0 id, 1 relu, 2 gelu (tanh), 3 tanh
  int kind;            // 0 matmul, 1 fused_dense_act, 2 weighted_matmul
  int in_dtype;        // 0 float32, 1 bfloat16
  int out_dtype;
  int body;            // 0 mma.sync, 1 ring, 2 fma (f32 operands)
};

}  // extern "C"

namespace {

// bf16 body (tensor cores)
constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int LDX = BK + 8;  // padded A row: 80 bytes
constexpr int LDW = BN + 8;  // padded B row: 272 bytes

// f32 body (FMA pipes)
constexpr int F_BM = 128;
constexpr int F_BN = 64;
constexpr int F_BK = 32;
constexpr int F_THREADS = 256;
constexpr int F_TM = 8;
constexpr int F_TN = 4;

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

__device__ __forceinline__ float activate(int act, float z) {
  switch (act) {
    case 1:
      return fmaxf(z, 0.f);
    case 2: {
      // jax.nn.gelu's default: the tanh approximation
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * z * (1.f + tanhf(c * (z + 0.044715f * z * z * z)));
    }
    case 3:
      return tanhf(z);
    default:
      return z;
  }
}

// B6's epilogue on one accumulator element of column n; the others store it
template <int KIND>
__device__ __forceinline__ float finish(const BaselineParams& p, int n,
                                        float acc) {
  if (KIND != 1) return acc;
  const float y = acc + p.beta[n];
  return activate(p.act, (y - p.mean[n]) * rsqrtf(p.var[n] + p.eps));
}

// 16-byte async copy; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 b16 matrices, transposed: thread i gets rows 2(i%4), 2(i%4)+1 of
// column i/4 of each, which is the m16n8k16 B fragment of a [k][n] tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 of A times two of g, each product rounded to bf16 (B7's zipper);
// the product of two bf16 is exact in f32, so this is the rounding of the
// exact product, as the reference's bf16 multiply
__device__ __forceinline__ uint32_t scale2(uint32_t a, uint32_t g) {
  const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(&g);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      __low2float(av) * __low2float(gv), __high2float(av) * __high2float(gv));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One K step into one ring slot: A [m0, m0 + BM) x [k0, k0 + BK), B
// [k0, k0 + BK) x [n0, n0 + BN), and (B7) g [k0, k0 + BK); zero past the
// edges.
template <int KIND, bool VEC>
__device__ __forceinline__ void load_tiles(__nv_bfloat16 (*as)[LDX],
                                           __nv_bfloat16 (*bs)[LDW],
                                           __nv_bfloat16* gs,
                                           const BaselineParams& p, int m0,
                                           int n0, int k0) {
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.A);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.B);
  const __nv_bfloat16* G = static_cast<const __nv_bfloat16*>(p.g);
  const int M = (int)p.M, N = (int)p.N, K = (int)p.K;
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v >> 2;
      const int c = (v & 3) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(&as[r][c], ok ? A + (long long)(m0 + r) * K + k0 + c : A,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int kk = v >> 4;
      const int c = (v & 15) * 8;
      const bool ok = k0 + kk < K && n0 + c < N;
      cp_async16(&bs[kk][c], ok ? B + (long long)(k0 + kk) * N + n0 + c : B,
                 ok);
    }
    if (KIND == 2 && tid < BK / 8) {
      const bool ok = k0 + tid * 8 < K;
      cp_async16(gs + tid * 8, ok ? G + k0 + tid * 8 : G, ok);
    }
  } else {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      as[r][c] = (m0 + r < M && k0 + c < K)
                     ? A[(long long)(m0 + r) * K + k0 + c]
                     : __float2bfloat16(0.f);
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int c = e % BN;
      bs[kk][c] = (k0 + kk < K && n0 + c < N)
                      ? B[(long long)(k0 + kk) * N + n0 + c]
                      : __float2bfloat16(0.f);
    }
    if (KIND == 2 && tid < BK)
      gs[tid] = k0 + tid < K ? G[k0 + tid] : __float2bfloat16(0.f);
  }
}

template <typename TOut, int KIND, bool VEC>
__global__ void __launch_bounds__(THREADS)
baseline_bf16_kernel(const BaselineParams p) {
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM][LDX];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BK][LDW];  // [k][n]
  __shared__ __align__(16) __nv_bfloat16 Gs[STAGES][BK];

  const int M = (int)p.M, N = (int)p.N, K = (int)p.K;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wn = warp * 32;
  const int nk = (K + BK - 1) / BK;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_tiles<KIND, VEC>(As[s], Bs[s], Gs[s], p, m0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's)
    __syncthreads();              // ... and everyone's; slot kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_tiles<KIND, VEC>(As[nxt % STAGES], Bs[nxt % STAGES],
                            Gs[nxt % STAGES], p, m0, n0, nxt * BK);
    cp_async_commit();
    const int slot = kt % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, &Bs[slot][ks + (lane & 15)][wn + q * 16 + (lane >> 4) * 8]);
        bf[2 * q][0] = r[0];
        bf[2 * q][1] = r[1];
        bf[2 * q + 1][0] = r[2];
        bf[2 * q + 1][1] = r[3];
      }
      uint32_t g_lo = 0, g_hi = 0;
      if (KIND == 2) {
        g_lo = lds_u32(&Gs[slot][ks + 2 * t]);
        g_hi = lds_u32(&Gs[slot][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = mi * 16 + g;
        uint32_t af[4];
        af[0] = lds_u32(&As[slot][r][ks + 2 * t]);
        af[1] = lds_u32(&As[slot][r + 8][ks + 2 * t]);
        af[2] = lds_u32(&As[slot][r][ks + 2 * t + 8]);
        af[3] = lds_u32(&As[slot][r + 8][ks + 2 * t + 8]);
        if (KIND == 2) {
          af[0] = scale2(af[0], g_lo);
          af[1] = scale2(af[1], g_lo);
          af[2] = scale2(af[2], g_hi);
          af[3] = scale2(af[3], g_hi);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af, bf[ni]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: e = 2h + j holds row g + 8h, column 2t + j
  TOut* C = static_cast<TOut*>(p.C);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mi * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn + ni * 8 + 2 * t + j;
          if (n < N)
            store_from_f32(C + (long long)m * N + n,
                           finish<KIND>(p, n, acc[mi][ni][2 * h + j]));
        }
    }
}

template <typename TOut, int KIND>
__global__ void __launch_bounds__(F_THREADS)
baseline_f32_kernel(const BaselineParams p) {
  __shared__ float As[F_BK][F_BM + 1];  // [k][m]
  __shared__ float Bs[F_BK][F_BN];      // [k][n]

  const float* A = static_cast<const float*>(p.A);
  const float* B = static_cast<const float*>(p.B);
  const float* G = static_cast<const float*>(p.g);
  const int M = (int)p.M, N = (int)p.N, K = (int)p.K;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;

  float acc[F_TM][F_TN];
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int i = 0; i < F_BM * F_BK / F_THREADS; ++i) {
      const int e = tid + i * F_THREADS;
      const int r = e / F_BK;
      const int c = e % F_BK;
      const int m = m0 + r;
      const int k = k0 + c;
      float v = 0.f;
      if (m < M && k < K) {
        v = A[(long long)m * K + k];
        if (KIND == 2) v = v * G[k];  // rounded to f32 before the product
      }
      As[c][r] = v;
    }
#pragma unroll
    for (int i = 0; i < F_BK * F_BN / F_THREADS; ++i) {
      const int e = tid + i * F_THREADS;
      const int r = e / F_BN;
      const int c = e % F_BN;
      const int k = k0 + r;
      const int n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? B[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[F_TM];
      float bv[F_TN];
#pragma unroll
      for (int i = 0; i < F_TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < F_TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < F_TM; ++i)
#pragma unroll
        for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  TOut* C = static_cast<TOut*>(p.C);
#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < F_TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        store_from_f32(C + (long long)m * N + n, finish<KIND>(p, n, acc[i][j]));
    }
  }
}

// ---------------------------------------------------------------------------
// The ring body (body 1): B5, B6 and B7, bf16 operands that TMA can read
// ---------------------------------------------------------------------------
constexpr int R_BM = 128;
constexpr int R_BN = 256;
constexpr int R_BK = 64;  // one 128-byte swizzled row of bf16
constexpr int R_THREADS = 384;
constexpr int R_A_BYTES = R_BM * R_BK * 2;  // 16 KB
constexpr int R_STAGE = R_A_BYTES + R_BK * R_BN * 2;  // + 32 KB of B
constexpr int R_STAGES = 4;
constexpr int R_G_BYTES = R_BK * 2;  // a stage's 64 values of g (B7)
constexpr int R_ACC = R_BN / 2;      // f32 accumulators of a consumer thread
constexpr int R_BAND = 8;            // row tiles of a rasterization band
// B6's column factors (beta, mean, rsqrt(var + eps)) of a tile, two buffers
constexpr int R_F_BYTES = 2 * 3 * R_BN * 4;
constexpr int R_CONSUMERS = 256;
// the ring, 1024 bytes to align it, the g slots, B6's factors, full and
// empty barriers
constexpr int R_SMEM = R_STAGES * R_STAGE + 1024 + R_STAGES * R_G_BYTES +
                       R_F_BYTES + 2 * R_STAGES * 8;

// One consumer warpgroup's K loop over a tile (kind 0): its 64 rows
// (``half``) of each stage's A tile against the stage's whole B tile, four
// k16 wgmmas a stage.  ``it0`` is the ring's step count at the tile's
// first stage (the ring runs on across tiles).  A stage is released once
// its group has retired: the one before after wait_group 1, the tile's
// last after wait_group 0.
__device__ __forceinline__ void ring_loop(float (&acc)[R_ACC], uint32_t tiles,
                                          uint64_t* full, uint64_t* empty,
                                          int it0, int steps, int half) {
  for (int i = 0; i < steps; ++i) {
    const int it = it0 + i;
    const int s = it % R_STAGES;
    hopper::mbar_wait(&full[s], (it / R_STAGES) & 1);
    const uint32_t a = tiles + s * R_STAGE + half * 8192;
    const uint32_t b = tiles + s * R_STAGE + R_A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::wgmma_bf16<0, 1>(acc, hopper::desc(a + ks * 32, 16, 1024),
                               hopper::desc(b + ks * 2048, 8192, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (i > 0 && threadIdx.x % 128 == 0)
      hopper::mbar_arrive(&empty[(it - 1) % R_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (threadIdx.x % 128 == 0)
    hopper::mbar_arrive(&empty[(it0 + steps - 1) % R_STAGES]);
}

// B7's K loop: A goes through registers.  Each k16 step's A fragment of
// the warp's 16 rows is read from the swizzled tile by ldmatrix (lane l:
// row l % 8 + 8 (l / 8 % 2), 16-byte chunk 2 q + l / 16, stored at chunk ^
// row % 8), scaled by g in f32 and rounded to bf16 (the thread's k are
// 2t, 2t + 1, 2t + 8 and 2t + 9 of the step, t = lane % 4), and fed to the
// register-A wgmma; B stays in shared memory.  The stage's g arrives with
// it (``gs``, by TMA, zero past K).  The warpgroup waits for its own group
// before it writes the next fragments (C7513 otherwise, see the header).
__device__ __forceinline__ void ring_loop_scaled(float (&acc)[R_ACC],
                                                 uint32_t tiles,
                                                 const unsigned char* gs,
                                                 uint64_t* full,
                                                 uint64_t* empty, int it0,
                                                 int steps, int half) {
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane & 7) +
                  8 * ((lane >> 3) & 1);
  const uint32_t mine = tiles + half * 8192 + row * 128;
  const int kt = lane & 3;  // the thread's bf16 pair of each 8 k
  for (int i = 0; i < steps; ++i) {
    const int it = it0 + i;
    const int s = it % R_STAGES;
    hopper::mbar_wait(&full[s], (it / R_STAGES) & 1);
    const __nv_bfloat162* g2 =
        reinterpret_cast<const __nv_bfloat162*>(gs + s * R_G_BYTES);
    uint32_t af[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hopper::ldmatrix_x4(af[q], mine + s * R_STAGE +
                                     (((2 * q + (lane >> 4)) ^ (row & 7))
                                      << 4));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&af[q][r]));
        const float2 g = __bfloat1622float2(g2[8 * q + kt + 4 * (r >> 1)]);
        const __nv_bfloat162 y = __floats2bfloat162_rn(f.x * g.x, f.y * g.y);
        af[q][r] = *reinterpret_cast<const uint32_t*>(&y);
      }
    }
    const uint32_t b = tiles + s * R_STAGE + R_A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      hopper::wgmma_bf16_rs<1>(acc, af[q],
                               hopper::desc(b + q * 2048, 8192, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) hopper::fence_regs(af[q]);
    if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[s]);
  }
}

// The masked store of a consumer thread's fragment: rows r0 and r0 + 8,
// columns c0 + 8j and c0 + 8j + 1 (wgmma's accumulator layout), each pair
// one word (N is a multiple of 8 and c0 even).  B6 (KIND 1) first runs its
// epilogue on each pair, in finish()'s order, from the tile's staged
// factors ``fac`` (beta, mean, rsqrt(var + eps), R_BN each; the pair's
// columns at ``cl0`` + 8j in the tile).
template <typename TOut, int KIND>
__device__ __forceinline__ void ring_store(TOut* C, const float (&acc)[R_ACC],
                                           const float* fac, int act, int r0,
                                           int c0, int cl0, int M, int N) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m >= M) continue;
    TOut* row = C + (long long)m * N;
#pragma unroll
    for (int j = 0; j < R_ACC / 4; ++j) {
      const int n = c0 + 8 * j;
      if (n >= N) continue;
      float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (KIND == 1) {
        const int c = cl0 + 8 * j;
        const float2 bt = *reinterpret_cast<const float2*>(fac + c);
        const float2 mu = *reinterpret_cast<const float2*>(fac + R_BN + c);
        const float2 rs =
            *reinterpret_cast<const float2*>(fac + 2 * R_BN + c);
        x = activate(act, ((x + bt.x) - mu.x) * rs.x);
        y = activate(act, ((y + bt.y) - mu.y) * rs.y);
      }
      store2_from_f32(row + n, x, y);
    }
  }
}

// The ring kernel, persistent: CTA b takes tiles b, b + grid, ... of the
// (M / 128) x (N / 256) tiles in bands of R_BAND row tiles.  tmA: A as
// (K, M), boxes of 64 k x 128 m; tmB: B as (N, K), boxes of 64 n x 64 k;
// tmG (B7): g as (K, 1), boxes of 64.  B6 reads beta, mean, var, eps and
// act from ``p``.
template <typename TOut, int KIND>
__global__ void __launch_bounds__(R_THREADS, 1)
baseline_bf16_ring_kernel(const __grid_constant__ CUtensorMap tmA,
                          const __grid_constant__ CUtensorMap tmB,
                          const __grid_constant__ CUtensorMap tmG,
                          const __grid_constant__ BaselineParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* tiles =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* gs = tiles + R_STAGES * R_STAGE;  // 128-byte slots
  float* fac = reinterpret_cast<float*>(gs + R_STAGES * R_G_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(fac) + R_F_BYTES);
  uint64_t* empty = full + R_STAGES;
  TOut* C = static_cast<TOut*>(p.C);
  const int M = (int)p.M, N = (int)p.N, K = (int)p.K;

  const int gx = (N + R_BN - 1) / R_BN;
  const int gy = (M + R_BM - 1) / R_BM;
  const int count = gx * gy;
  const int nk = (K + R_BK - 1) / R_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer group
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tmA);
      hopper::tma_prefetch(&tmB);
      if (KIND == 2) hopper::tma_prefetch(&tmG);
      int it = 0;
      for (int t = blockIdx.x; t < count; t += gridDim.x) {
        int m_t, n_t;
        hopper::raster(t, gx, gy, R_BAND, m_t, n_t);
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % R_STAGES;
          hopper::mbar_wait(&empty[s], ((it / R_STAGES) & 1) ^ 1);
          hopper::mbar_arrive_tx(&full[s],
                                 R_STAGE + (KIND == 2 ? R_G_BYTES : 0));
          unsigned char* a = tiles + s * R_STAGE;
          unsigned char* b = a + R_A_BYTES;
          const int k0 = i * R_BK;
          hopper::tma_load(a, &tmA, &full[s], k0, m_t * R_BM, 0);
#pragma unroll
          for (int j = 0; j < R_BN / 64; ++j)
            hopper::tma_load(b + j * 8192, &tmB, &full[s],
                             n_t * R_BN + 64 * j, k0, 0);
          if (KIND == 2)
            hopper::tma_load(gs + s * R_G_BYTES, &tmG, &full[s], k0, 0, 0);
        }
      }
    }
    return;
  }

  hopper::regs_inc<232>();
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int half = ct >> 7;          // its warpgroup's 64 rows
  const int lane = ct & 31;
  const uint32_t base = hopper::smem_u32(tiles);
  float acc[R_ACC];
  int it = 0;
  for (int t = blockIdx.x, parity = 0; t < count;
       t += gridDim.x, it += nk, parity ^= 1) {
    int m_t, n_t;
    hopper::raster(t, gx, gy, R_BAND, m_t, n_t);
    float* f = fac + parity * 3 * R_BN;
    if (KIND == 1) {
      // the tile's column factors, one column a consumer thread
      const int n = n_t * R_BN + ct;
      const bool in = n < N;
      f[ct] = in ? p.beta[n] : 0.f;
      f[R_BN + ct] = in ? p.mean[n] : 0.f;
      f[2 * R_BN + ct] = in ? rsqrtf(p.var[n] + p.eps) : 0.f;
      hopper::bar_sync(1, R_CONSUMERS);
    }
#pragma unroll
    for (int i = 0; i < R_ACC; ++i) acc[i] = 0.f;
    if (KIND == 2)
      ring_loop_scaled(acc, base, gs, full, empty, it, nk, half);
    else
      ring_loop(acc, base, full, empty, it, nk, half);
    const int r0 = m_t * R_BM + half * 64 + ((ct >> 5) & 3) * 16 +
                   (lane >> 2);
    const int cl0 = 2 * (lane & 3);
    ring_store<TOut, KIND>(C, acc, f, p.act, r0, n_t * R_BN + cl0, cl0, M,
                           N);
  }
}

// Can the ring take the call: any kind, bf16 operands, 16-byte aligned
// bases, K and N multiples of 8 (16-byte rows for TMA), a tile count
// within int.
bool ring_ok(const BaselineParams& p) {
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  return p.in_dtype == 1 && p.M >= 1 &&
         p.N >= 1 && p.K >= 1 && p.K % 8 == 0 && p.N % 8 == 0 &&
         aligned(p.A) && aligned(p.B) && (p.kind != 2 || aligned(p.g)) &&
         ((p.M + R_BM - 1) / R_BM) * ((p.N + R_BN - 1) / R_BN) < (1LL << 31);
}

// The ring's launch: the tensor maps, then one CTA an SM (or one a tile,
// where there are fewer tiles).  cudaErrorInvalidValue where the ring
// cannot take the call.
template <typename TOut, int KIND>
int launch_ring(const BaselineParams& p, cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!ring_ok(p)) return invalid;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ta, tb, tg{};
  const hopper::Operand a{p.A, p.K, p.M, p.K, 1, 0};
  const hopper::Operand b{p.B, p.N, p.K, p.N, 1, 0};
  if (!hopper::make_map(&ta, a, 2, bf16, R_BK, R_BM) ||
      !hopper::make_map(&tb, b, 2, bf16, 64, R_BK))
    return invalid;
  if (KIND == 2) {
    const hopper::Operand g{p.g, p.K, 1, 0, 1, 0};
    if (!hopper::make_map(&tg, g, 2, bf16, R_BK, 1, false)) return invalid;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      baseline_bf16_ring_kernel<TOut, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles =
      ((p.M + R_BM - 1) / R_BM) * ((p.N + R_BN - 1) / R_BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  baseline_bf16_ring_kernel<TOut, KIND><<<grid, R_THREADS, R_SMEM, stream>>>(
      ta, tb, tg, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TOut, int KIND>
void launch_bf16(const BaselineParams& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.N + BN - 1) / BN),
                  (unsigned)((p.M + BM - 1) / BM));
  const bool vec = p.K % 8 == 0 && p.N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(p.A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.B) % 16 == 0 &&
                   (KIND != 2 || reinterpret_cast<uintptr_t>(p.g) % 16 == 0);
  if (vec)
    baseline_bf16_kernel<TOut, KIND, true><<<grid, THREADS, 0, stream>>>(p);
  else
    baseline_bf16_kernel<TOut, KIND, false><<<grid, THREADS, 0, stream>>>(p);
}

template <typename TOut, int KIND>
void launch_f32(const BaselineParams& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.N + F_BN - 1) / F_BN),
                  (unsigned)((p.M + F_BM - 1) / F_BM));
  baseline_f32_kernel<TOut, KIND><<<grid, F_THREADS, 0, stream>>>(p);
}

// The ring's six kernels: kind 0, 1 or 2, f32 or bf16 output.
int launch_ring_kind(const BaselineParams& p, cudaStream_t s) {
  if (p.kind == 0)
    return p.out_dtype == 1 ? launch_ring<__nv_bfloat16, 0>(p, s)
                            : launch_ring<float, 0>(p, s);
  if (p.kind == 1)
    return p.out_dtype == 1 ? launch_ring<__nv_bfloat16, 1>(p, s)
                            : launch_ring<float, 1>(p, s);
  if (p.kind == 2)
    return p.out_dtype == 1 ? launch_ring<__nv_bfloat16, 2>(p, s)
                            : launch_ring<float, 2>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int KIND>
void launch_kind(const BaselineParams& p, cudaStream_t s) {
  switch (p.in_dtype * 2 + p.out_dtype) {
    case 0:
      launch_f32<float, KIND>(p, s);
      break;
    case 1:
      launch_f32<__nv_bfloat16, KIND>(p, s);
      break;
    case 2:
      launch_bf16<float, KIND>(p, s);
      break;
    default:
      launch_bf16<__nv_bfloat16, KIND>(p, s);
      break;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; body codes: 0 mma.sync (bf16
// operands), 1 the ring (bf16, any kind, ring_ok), 2 FMA (f32
// operands).  A body the operands cannot take is refused
// (cudaErrorInvalidValue), never swapped.  Returns cudaGetLastError()
// after the launch (0 = launched); nothing is synchronised, and nothing is
// allocated here.
int baseline_launch(const BaselineParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->in_dtype < 0 || p->in_dtype > 1 || p->out_dtype < 0 ||
      p->out_dtype > 1 || p->kind < 0 || p->kind > 2 || p->act < 0 ||
      p->act > 3 || (p->kind == 1 && !(p->beta && p->mean && p->var)) ||
      (p->kind == 2 && !p->g) || p->body < 0 || p->body > 2 ||
      (p->body == 0 && p->in_dtype != 1) ||
      (p->body == 2 && p->in_dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->body == 1) return launch_ring_kind(*p, s);
  if (p->kind == 0)
    launch_kind<0>(*p, s);
  else if (p->kind == 1)
    launch_kind<1>(*p, s);
  else
    launch_kind<2>(*p, s);
  return static_cast<int>(cudaGetLastError());
}

// The CTA tile height of the mma.sync and FMA bodies, so the wrapper
// checks their grid's y limit (the ring's grid is one-dimensional).
int baseline_tile_m(int in_dtype) { return in_dtype == 1 ? BM : F_BM; }

// sizeof(BaselineParams), checked against the ctypes mirror at load.
int baseline_params_size(void) { return (int)sizeof(BaselineParams); }

}  // extern "C"
