// Strided batched contraction C[b,m,n] = sum_k A[b,m,k] * B[b,k,n] for Hopper.
//
// Replaces the reference's generated Pallas contraction kernel
// (src/repro/codegen/pallas_gen.py: CompiledKernel._build -> _make_kernel,
// folded by _contract) for two-operand product-reduce specs.  The Python
// side (codegen/cuda_gen.py) folds any such spec onto (batch, m, k, n):
// batch = indices shared by both operands and the output, m / n = output
// indices of A / B only, k = the shared reduce indices.  It passes element
// strides, so permuted views reach the kernel without a copy.
//
// What bounds it on the H100: at the serving shapes (M = 128..512 tokens,
// K and N = 1024..12288) a bf16 product does 2MNK operations on about
// 2(MK + KN + MN) bytes, i.e. 100..250 operations per byte, so the bound
// is the tensor-core rate for M = 512 and the weight bytes for M = 128.
// This first version is simple and right rather than fast.  Two bodies,
// chosen by the operand type; both take their own CTA grid (the TPU plan's
// grid, often a single block, is not used), stream K through shared memory
// in steps of 32, accumulate in f32 in a fixed order per output, and mask
// ragged edges on load and store, so any M, N, K is legal:
//   * bf16 operands run on the tensor cores: mma.sync m16n8k16 (bf16 in,
//     f32 accumulate), a 64 x 128 CTA tile over 4 warps of 32 x 64.  A is
//     staged row-major and B transposed (n-major) with rows padded to 40
//     elements, so every fragment load of a warp hits 32 distinct banks.
//     Global loads are 16 bytes where the strides allow (unit stride along
//     k for A and along n for B, 8-element aligned), else element-wise.
//     No cp.async/TMA pipelining yet: loads and math alternate.
//   * f32 operands keep exact f32 math on the FMA pipes: a 128 x 64 CTA
//     tile, each of 256 threads owning an 8 x 4 micro-tile (rows ty + 16 i,
//     columns tx + 16 j, so a warp's shared reads are conflict-free).
// The store rounds to the output type (round to nearest even for bf16),
// as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// f32 body (FMA pipes)
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int TM = 8;  // rows per thread: BM / 16
constexpr int TN = 4;  // columns per thread: BN / 16

// bf16 body (tensor cores)
constexpr int TC_BM = 64;
constexpr int TC_BN = 128;
constexpr int TC_BK = 32;
constexpr int TC_THREADS = 128;
constexpr int TC_LD = TC_BK + 8;  // padded row: 80 bytes = 20 banks

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TOut>
__global__ void __launch_bounds__(THREADS)
contract_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    TOut* __restrict__ C, int M, int N, int K,
                    long long sAb, long long sAm, long long sAk,
                    long long sBb, long long sBk, long long sBn,
                    long long sCb, long long sCm, long long sCn) {
  // A is stored k-major with one pad column so that the transposing store
  // of a warp (32 consecutive k of one row) hits 32 distinct banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long b = blockIdx.z;
  A += b * sAb;
  B += b * sBb;
  C += b * sCb;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int m = m0 + r;
      const int k = k0 + c;
      As[c][r] = (m < M && k < K) ? A[m * sAm + k * sAk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int k = k0 + r;
      const int n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? B[k * sBk + n * sBn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) store_from_f32(C + m * sCm + n * sCn, acc[i][j]);
    }
  }
}


__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// VEC: A has unit stride along k and B along n, K and N are multiples of
// 8 and every row starts 16-byte aligned, so 8 elements load as one uint4.
template <typename TOut, bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
contract_bf16_mma_kernel(const __nv_bfloat16* __restrict__ A,
                         const __nv_bfloat16* __restrict__ B,
                         TOut* __restrict__ C, int M, int N, int K,
                         long long sAb, long long sAm, long long sAk,
                         long long sBb, long long sBk, long long sBn,
                         long long sCb, long long sCm, long long sCn) {
  __shared__ __align__(16) __nv_bfloat16 As[TC_BM][TC_LD];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[TC_BN][TC_LD];  // [n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  const long long b = blockIdx.z;
  A += b * sAb;
  B += b * sBb;
  C += b * sCb;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TC_BK) {
    if (VEC) {
      // A: 64 rows x 4 chunks of 8 k; 4 lanes cover one 64-byte row run
#pragma unroll
      for (int i = 0; i < TC_BM * TC_BK / 8 / TC_THREADS; ++i) {
        const int v = tid + i * TC_THREADS;
        const int r = v >> 2;
        const int c = (v & 3) * 8;
        const int m = m0 + r;
        const int k = k0 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && k < K)
          val = *reinterpret_cast<const uint4*>(A + m * sAm + k);
        *reinterpret_cast<uint4*>(&As[r][c]) = val;
      }
      // B: 32 k rows x 16 chunks of 8 n; a warp takes the 32 k rows of one
      // chunk, so its transposing stores fill one 64-byte run per column
#pragma unroll
      for (int i = 0; i < TC_BK * TC_BN / 8 / TC_THREADS; ++i) {
        const int v = tid + i * TC_THREADS;
        const int kk = v & 31;
        const int c = (v >> 5) * 8;
        const int k = k0 + kk;
        const int n = n0 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k < K && n < N)
          val = *reinterpret_cast<const uint4*>(B + k * sBk + n);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) Bs[c + j][kk] = e[j];
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < TC_BM * TC_BK / TC_THREADS; ++i) {
        const int e = tid + i * TC_THREADS;
        const int r = e / TC_BK;
        const int c = e % TC_BK;
        const int m = m0 + r;
        const int k = k0 + c;
        As[r][c] = (m < M && k < K) ? A[m * sAm + k * sAk]
                                    : __float2bfloat16(0.f);
      }
#pragma unroll 4
      for (int i = 0; i < TC_BK * TC_BN / TC_THREADS; ++i) {
        const int e = tid + i * TC_THREADS;
        const int kk = e % TC_BK;
        const int c = e / TC_BK;
        const int k = k0 + kk;
        const int n = n0 + c;
        Bs[c][kk] = (k < K && n < N) ? B[k * sBk + n * sBn]
                                     : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TC_BK; ks += 16) {
      uint32_t af[2][4];
      uint32_t bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = lds_u32(&As[r][ks + 2 * t]);
        af[mi][1] = lds_u32(&As[r + 8][ks + 2 * t]);
        af[mi][2] = lds_u32(&As[r][ks + 2 * t + 8]);
        af[mi][3] = lds_u32(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = wn + ni * 8 + g;
        bf[ni][0] = lds_u32(&Bs[c][ks + 2 * t]);
        bf[ni][1] = lds_u32(&Bs[c][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16816(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // accumulator fragment: e = 2h + j holds row g + 8h, column 2t + j
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn + ni * 8 + 2 * t + j;
          if (n < N)
            store_from_f32(C + m * sCm + n * sCn, acc[mi][ni][2 * h + j]);
        }
    }
}

template <typename TOut>
void launch_f32(const void* A, const void* B, void* C, int batch, int M,
                int N, int K, long long sAb, long long sAm, long long sAk,
                long long sBb, long long sBk, long long sBn, long long sCb,
                long long sCm, long long sCn, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  contract_f32_kernel<TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<TOut*>(C), M, N, K, sAb, sAm, sAk, sBb, sBk, sBn, sCb, sCm,
      sCn);
}

template <typename TOut>
void launch_bf16(const void* A, const void* B, void* C, int batch, int M,
                 int N, int K, long long sAb, long long sAm, long long sAk,
                 long long sBb, long long sBk, long long sBn, long long sCb,
                 long long sCm, long long sCn, cudaStream_t stream) {
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, batch);
  const bool vec =
      sAk == 1 && sBn == 1 && K % 8 == 0 && N % 8 == 0 && sAm % 8 == 0 &&
      sBk % 8 == 0 && (batch == 1 || (sAb % 8 == 0 && sBb % 8 == 0)) &&
      reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(B);
  TOut* c = static_cast<TOut*>(C);
  if (vec)
    contract_bf16_mma_kernel<TOut, true><<<grid, TC_THREADS, 0, stream>>>(
        a, b, c, M, N, K, sAb, sAm, sAk, sBb, sBk, sBn, sCb, sCm, sCn);
  else
    contract_bf16_mma_kernel<TOut, false><<<grid, TC_THREADS, 0, stream>>>(
        a, b, c, M, N, K, sAb, sAm, sAk, sBb, sBk, sBn, sCb, sCm, sCn);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements.
// Returns cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised, and nothing is allocated here.
int contract_launch(int in_dtype, int out_dtype, const void* A, const void* B,
                    void* C, int batch, int M, int N, int K, long long sAb,
                    long long sAm, long long sAk, long long sBb, long long sBk,
                    long long sBn, long long sCb, long long sCm, long long sCn,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int code = in_dtype * 2 + out_dtype;
  switch (code) {
    case 0:
      launch_f32<float>(A, B, C, batch, M, N, K, sAb, sAm, sAk, sBb, sBk,
                        sBn, sCb, sCm, sCn, s);
      break;
    case 1:
      launch_f32<__nv_bfloat16>(A, B, C, batch, M, N, K, sAb, sAm, sAk, sBb,
                                sBk, sBn, sCb, sCm, sCn, s);
      break;
    case 2:
      launch_bf16<float>(A, B, C, batch, M, N, K, sAb, sAm, sAk, sBb, sBk,
                         sBn, sCb, sCm, sCn, s);
      break;
    case 3:
      launch_bf16<__nv_bfloat16>(A, B, C, batch, M, N, K, sAb, sAm, sAk, sBb,
                                 sBk, sBn, sCb, sCm, sCn, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Smallest CTA tile height of the two bodies, so the Python wrapper checks
// the grid's y limit with the kernel's own number.
int contract_tile_m(void) { return TC_BM < BM ? TC_BM : BM; }

}  // extern "C"
