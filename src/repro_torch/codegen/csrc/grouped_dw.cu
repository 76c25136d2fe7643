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
// a mask, so an empty group comes out as exact zeros.  Here one CTA owns one
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
// bytes it stores.  On the MoE training path's cut (32 groups of C = 320)
// it is bound by neither by much; the math is 0.09 ms a call, the output
// 0.94 GB.  This first version is simple and right: its stores are 4 bytes
// a thread straight from the mma fragments (rows of 16 bytes per quad), not
// staged through shared memory.
// Two bodies, chosen by the operand type:
//   * bf16 operands run on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//     accumulate), 4 warps of 32 x 64.  Both operand tiles are n-major as
//     they lie in memory (x as [n][k1], dout as [n][k2], rows padded by 8
//     elements so the eight rows of an ldmatrix phase hit distinct banks),
//     and both fragments come through ldmatrix.trans: the A fragment of the
//     product is x's tile transposed, the B fragment dout's, as B3's W tile.
//     Tiles stream with 16-byte cp.async into a three-stage ring when both
//     operands have unit stride along their columns and 16-byte aligned
//     rows; otherwise the same body loads element-wise.
//   * f32 operands keep exact f32 math on the FMA pipes (a 64 x 64 tile,
//     256 threads of 4 x 4 outputs).
// Accumulation is f32; the store rounds once to the output type (round to
// nearest even for bf16), as the reference's f32 result is cast once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements.  table
// is a device array of n_groups (group id, first row, row count) triples,
// one for every group of the partition, empty ones included; x is (N, K1)
// and dout (N, K2) with element (n, k) at n * sXn + k * sXk (sDn, sDk), and
// out's element (g, k1, k2) is at g * sOg + k1 * sOm + k2 * sOn.  Returns
// cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised, and nothing is allocated here.
int grouped_dw_launch(int in_dtype, int out_dtype, const void* X,
                      const void* D, void* O, const int* table, int n_groups,
                      int K1, int K2, long long sXn, long long sXk,
                      long long sDn, long long sDk, long long sOg,
                      long long sOm, long long sOn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      n_groups < 1 || K1 < 1 || K2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
    case 3:
      launch_bf16<__nv_bfloat16>(X, D, O, table, n_groups, K1, K2, sXn, sXk,
                                 sDn, sDk, sOg, sOm, sOn, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
