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
// in the operand type, beta / mean / var are (N,) float32.  One templated
// body serves all three: B7 is its prologue hook (the A fragments are
// scaled by g in registers, after they leave shared memory), B6 its
// epilogue hook (on the f32 accumulator, before the one store).
//
// The TPU kernels walk a 3-D grid (M/bm, N/bn, K/bk) whose last axis is
// sequential and carry the f32 accumulator across it in VMEM.  Here one CTA
// owns an output tile of its own size (64 x 128 for bf16, 128 x 64 for
// f32: the caller's block sizes are checked to divide the extents, as the
// reference asserts, but do not set the CUDA tile) and loops over K itself,
// keeping the accumulator in registers.  Ragged edges are masked, so any M,
// N, K is legal.
//
// What bounds it on the H100: at the slice's shape (M = 2048 tokens, K =
// 4096, N = 12288, bf16) a call does 206 GFLOP on 168 MB, 1229 operations a
// byte, so the tensor-core rate bounds it (0.208 ms at 989 TFLOP/s).  This
// first version is right and simple:
//   * bf16 operands: mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps
//     of 64 x 32; K streams in steps of 32 through a three-stage cp.async
//     ring (16-byte copies, two K steps in flight while a third is
//     computed).  B stays k-major as it lies in memory (rows padded to 136
//     elements) and reaches the B fragments through ldmatrix.trans; A rows
//     are padded to 40 elements so fragment loads are conflict-free.
//     Without 16-byte alignment or with K or N not a multiple of 8 the same
//     body loads element-wise.
//   * f32 operands keep exact f32 math on the FMA pipes: a 128 x 64 tile,
//     each of 256 threads owning an 8 x 4 micro-tile.
// Accumulation is f32; the store rounds once to the output type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int pad;
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

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch (0 = launched); nothing is synchronised, and nothing is
// allocated here.
int baseline_launch(const BaselineParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->in_dtype < 0 || p->in_dtype > 1 || p->out_dtype < 0 ||
      p->out_dtype > 1 || p->kind < 0 || p->kind > 2 || p->act < 0 ||
      p->act > 3 || (p->kind == 1 && !(p->beta && p->mean && p->var)) ||
      (p->kind == 2 && !p->g))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->kind == 0)
    launch_kind<0>(*p, s);
  else if (p->kind == 1)
    launch_kind<1>(*p, s);
  else
    launch_kind<2>(*p, s);
  return static_cast<int>(cudaGetLastError());
}

// The CTA tile height of each body, so the wrapper checks the grid's y limit.
int baseline_tile_m(int in_dtype) { return in_dtype == 1 ? BM : F_BM; }

// sizeof(BaselineParams), checked against the ctypes mirror at load.
int baseline_params_size(void) { return (int)sizeof(BaselineParams); }

}  // extern "C"
