// Strided batched contraction C[b,m,n] = sum_k A[b,m,k] * B[b,k,n] for Hopper,
// with the generated kernel's epilogue and its three-operand modes.
//
// Replaces the reference's generated Pallas contraction kernel
// (src/repro/codegen/pallas_gen.py: CompiledKernel._build -> _make_kernel,
// folded by _contract) for product-reduce specs.  The Python side
// (codegen/cuda_gen.py) folds a spec onto (batch, m, k, n): batch = indices
// shared by both GEMM operands and the output, m / n = output indices of A /
// B only, k = the shared reduce indices.  It passes element strides, so
// permuted views reach the kernel without a copy.  Everything else about a
// launch travels in one ContractParams struct:
//   * prologue: a per-k scale of the A tile (kscale), applied in f32 as the
//     tile is staged and rounded once to the operand type for the product;
//     the weighted spec A_ij B_jk g_j -> ik of paper eq 2 (no (A.g) copy in
//     device memory);
//   * epilogue on the f32 accumulator, before the one store, in this order:
//     a multiplier vector (mul: g of the weighted spec's dA / dB, an output
//     column or row), then the reference's Epilogue stages scale, bias,
//     (y - mean) * rsqrt(var + eps) and the activation (relu, gelu with the
//     tanh approximation, tanh, silu, id).  Each vector is indexed by one
//     folded output coordinate (batch, m or n) as (coord / div) % len, so a
//     vector along any output index works;
//   * row reduce: C[n] = sum_m acc[m, n] * T[m, n] for a third operand T
//     that holds the product's (m, n) indices, the weighted spec's dg
//     (dg_j = sum_i A_ij (dout . B^T)_ij).  Each CTA multiplies its
//     accumulator tile by T, sums its rows in a fixed order (registers, warp
//     shuffles, then shared memory) and writes one partial row; the last CTA
//     of each column block to arrive (an atomic counter per column block,
//     after a __threadfence) sums the partial rows in row-block order and
//     stores.  One launch, and the same bits from run to run (no float
//     atomics).
// A plain product runs its own kernel with scalar parameters
// (contract_*_kernel), with no trace of these modes; the *_fused_kernel
// instantiation of the same body takes the struct and runs any of them,
// switched by the parameters at run time.
//
// What bounds it on the H100: at the serving and training shapes (M = 128
// .. 2048 tokens, K and N = 1024..12288) a bf16 product does 2MNK operations
// on about 2(MK + KN + MN) bytes, 100..800 operations per byte, so the bound
// is the tensor-core rate from M = 512 up and the weight bytes at M = 128.
// The epilogue and the prologue add O(MN) and O(MK) arithmetic, nothing to
// that bound.  Three bodies; each takes its own CTA grid (the TPU plan's
// grid, often a single block, is not used), accumulates in f32 in a fixed
// order per output and masks ragged edges, so any M, N, K is legal:
//   * the ring body (body 1), for plain bf16 products at M >= 64 whose
//     operands TMA can read (each with unit stride on one of its two axes,
//     the other strides multiples of 16 bytes, 16-byte aligned bases;
//     codegen.cuda_gen.contract_body picks it, and contract_launch refuses
//     it for anything else): hopper.cuh's skeleton.  A CTA of three
//     warpgroups owns a 128 x BN tile (BN = 128 or 256).  One producer
//     thread keeps TMA loads of 64-deep K steps in flight into a ring of
//     192 KB (6 stages at BN 128, 4 at 256), full and empty mbarriers per
//     stage; two consumer warpgroups run wgmma m64nBNk16 on 64 rows each,
//     one wgmma group in flight across K steps, registers moved from the
//     producer by setmaxnreg.  Every layout is read as it lies: the tensor
//     maps and the descriptors' transpose bits take A K-major or M-major
//     and B K-major or N-major, so the backward's transposed operands
//     (matmul.dA's W^T, matmul.dB's x^T) need no copy; the batch is the
//     maps' third dimension.  TMA zero-fills out-of-bounds boxes, so ragged
//     M, N and K cost nothing on the load side; the store is masked.
//     Where the output has few tiles (M = 128, or N = 1024 at M = 512), the
//     K steps are split across CTAs so the grid fills the card; each writes
//     its f32 partial tile to scratch and the last CTA of a tile to arrive
//     sums them in split order and stores (one launch, the same bits every
//     run).  Python picks BN and the split (cuda_gen.ring_tiles).  The
//     libcuda's cuTensorMapEncodeTiled is reached through the runtime's
//     entry-point query (hopper.cuh), so the library links no libcuda;
//   * every other bf16 product (decode's M < 64, unaligned or
//     element-strided operands) and the fused modes run mma.sync m16n8k16
//     (bf16 in, f32 accumulate) on a 64 x 128 CTA tile over 4 warps of 32 x
//     64, K in steps of 32.  A is staged row-major and B transposed
//     (n-major) with rows padded to 40 elements, so every fragment load of
//     a warp hits 32 distinct banks.  Global loads are 16 bytes where the
//     strides allow (unit stride along k for A and along n for B, 8-element
//     aligned), else element-wise.  Loads and math alternate;
//   * f32 operands keep exact f32 math on the FMA pipes: a 128 x 64 CTA
//     tile, each of 256 threads owning an 8 x 4 micro-tile (rows ty + 16 i,
//     columns tx + 16 j, so a warp's shared reads are conflict-free).
// The store rounds to the output type (round to nearest even for bf16),
// as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

extern "C" {

// One vector operand: element (coord / div) % len of p (f32, contiguous),
// where coord is the folded batch (axis 0), m (1), n (2) or k (3)
// coordinate.  p == nullptr means the stage is off.
struct Vec {
  const float* p;
  long long div;
  long long len;
  int axis;
  int pad;
};

struct ContractParams {
  const void* A;
  const void* B;
  void* C;
  long long batch, M, N, K;
  long long sAb, sAm, sAk, sBb, sBk, sBn, sCb, sCm, sCn;
  Vec kscale;                  // prologue: A[b, m, k] *= kscale[k]
  Vec mul, scale, bias, mean;  // epilogue vectors ...
  Vec var;                     // ... mean and var together (norm)
  const void* T;               // row reduce: third operand T[m, n] ...
  long long sTm, sTn;
  float* partial;              // ... (row blocks, N) f32 scratch; the
                               // ring's split partial tiles
  int* counter;                // ... one zeroed int per column block; the
                               // ring's: one per output tile
  float eps;
  int act;                     // 0 id, 1 relu, 2 gelu (tanh), 3 tanh, 4 silu
  int in_dtype;                // 0 float32, 1 bfloat16
  int out_dtype;
  int body;                    // 0 mma.sync / FMA bodies, 1 the ring
  int tile_n;                  // the ring's BN: 128 or 256
  int splits;                  // the ring's K split (1: none)
  int pad;
};

}  // extern "C"

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

// Out of line, with scalar arguments (no address of a kernel parameter
// leaves the kernel): the 64-bit division, inlined at every use, multiplied
// the fused kernels' code and build time.
__device__ __noinline__ long long vec_index_slow(long long c, long long div,
                                                 long long len) {
  return (c / div) % len;
}

__device__ __forceinline__ float vec_at(const Vec& v, long long b, int m,
                                        int n, int k) {
  const long long c = v.axis == 0 ? b : v.axis == 1 ? m : v.axis == 2 ? n : k;
  // the common case (the vector's index is its group's only one) needs no
  // division
  return v.p[v.div == 1 && c < v.len ? c : vec_index_slow(c, v.div, v.len)];
}

// FEAT_PLAIN: the product alone.  FEAT_FUSED: the k-scale prologue, the
// epilogue and the row-reduce mode, each where its parameters are set.
constexpr int FEAT_PLAIN = 0;
constexpr int FEAT_FUSED = 1;

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
    case 4:
      return z / (1.f + expf(-z));
    default:
      return z;
  }
}

// The epilogue on one accumulator element at output (b, m, n); an unset
// stage is skipped.
__device__ __forceinline__ float epilogue(const ContractParams& p, long long b,
                                          int m, int n, float y) {
  if (p.mul.p) y *= vec_at(p.mul, b, m, n, 0);
  if (p.scale.p) y *= vec_at(p.scale, b, m, n, 0);
  if (p.bias.p) y += vec_at(p.bias, b, m, n, 0);
  if (p.mean.p)
    y = (y - vec_at(p.mean, b, m, n, 0)) *
        rsqrtf(vec_at(p.var, b, m, n, 0) + p.eps);
  return activate(p.act, y);
}

// The row-reduce mode's last step, after every thread with a column wrote
// its partial sum for column n (n >= N: no column): the last CTA of this
// column block sums the partial rows in row-block order and stores C[n].
template <typename TOut>
__device__ __forceinline__ void finish_row_reduce(const ContractParams& p,
                                                  int N, int n) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(p.counter + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last || n >= N) return;
  __threadfence();
  float s = 0.f;
  for (int r = 0; r < (int)gridDim.y; ++r)
    s += __ldcg(p.partial + (long long)r * N + n);
  store_from_f32(static_cast<TOut*>(p.C) + n * p.sCn, s);
}

// The f32 body; ``p`` (the fused modes' parameters) is read only when FEAT
// is FEAT_FUSED, and is null otherwise.
template <typename TOut, int FEAT>
__device__ __forceinline__ void contract_f32_body(
    const float* __restrict__ A, const float* __restrict__ B,
    TOut* __restrict__ C, int M, int N, int K, long long sAb, long long sAm,
    long long sAk, long long sBb, long long sBk, long long sBn, long long sCb,
    long long sCm, long long sCn, const ContractParams* p) {
  // A is stored k-major with one pad column so that the transposing store
  // of a warp (32 consecutive k of one row) hits 32 distinct banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  __shared__ float Red[THREADS / 32][BN];

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
      float v = (m < M && k < K) ? A[m * sAm + k * sAk] : 0.f;
      if (FEAT == FEAT_FUSED && p->kscale.p && k < K)
        v *= vec_at(p->kscale, b, m, 0, k);
      As[c][r] = v;
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

  if (FEAT == FEAT_FUSED && p->T) {
    // row reduce: column sums of acc * T over this CTA's 128 rows
    const float* T = static_cast<const float*>(p->T);
    float cs[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) cs[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) cs[j] += acc[i][j] * T[m * p->sTm + n * p->sTn];
      }
    }
    // lanes l and l + 16 of a warp share columns: rows ty and ty + 1
#pragma unroll
    for (int j = 0; j < TN; ++j)
      cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
    if ((tid & 31) < 16)
#pragma unroll
      for (int j = 0; j < TN; ++j) Red[tid / 32][tx + 16 * j] = cs[j];
    __syncthreads();
    int n = N;
    if (tid < BN) {
      n = n0 + tid;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) s += Red[w][tid];
      if (n < N) p->partial[(long long)blockIdx.y * N + n] = s;
    }
    finish_row_reduce<TOut>(*p, N, n);
    return;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        store_from_f32(C + m * sCm + n * sCn,
                       FEAT == FEAT_PLAIN ? acc[i][j]
                                          : epilogue(*p, b, m, n, acc[i][j]));
    }
  }
}


template <typename TOut>
__global__ void __launch_bounds__(THREADS)
contract_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    TOut* __restrict__ C, int M, int N, int K, long long sAb,
                    long long sAm, long long sAk, long long sBb,
                    long long sBk, long long sBn, long long sCb,
                    long long sCm, long long sCn) {
  contract_f32_body<TOut, FEAT_PLAIN>(A, B, C, M, N, K, sAb, sAm, sAk, sBb,
                                      sBk, sBn, sCb, sCm, sCn, nullptr);
}

template <typename TOut>
__global__ void __launch_bounds__(THREADS)
contract_f32_fused_kernel(const ContractParams p) {
  contract_f32_body<TOut, FEAT_FUSED>(
      static_cast<const float*>(p.A), static_cast<const float*>(p.B),
      static_cast<TOut*>(p.C), (int)p.M, (int)p.N, (int)p.K, p.sAb, p.sAm,
      p.sAk, p.sBb, p.sBk, p.sBn, p.sCb, p.sCm, p.sCn, &p);
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
// ``p`` as in contract_f32_body.
template <typename TOut, bool VEC, int FEAT>
__device__ __forceinline__ void contract_bf16_body(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    TOut* __restrict__ C, int M, int N, int K, long long sAb, long long sAm,
    long long sAk, long long sBb, long long sBk, long long sBn, long long sCb,
    long long sCm, long long sCn, const ContractParams* p) {
  __shared__ __align__(16) __nv_bfloat16 As[TC_BM][TC_LD];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[TC_BN][TC_LD];  // [n][k]
  __shared__ float Red[2][TC_BN];

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
  const bool kscale = FEAT == FEAT_FUSED && p->kscale.p != nullptr;

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
        if (m < M && k < K) {
          val = *reinterpret_cast<const uint4*>(A + m * sAm + k);
          if (kscale) {
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) *
                                         vec_at(p->kscale, b, m, 0, k + j));
          }
        }
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
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (m < M && k < K) {
          v = A[m * sAm + k * sAk];
          if (kscale)
            v = __float2bfloat16_rn(__bfloat162float(v) *
                                    vec_at(p->kscale, b, m, 0, k));
        }
        As[r][c] = v;
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
  if (FEAT == FEAT_FUSED && p->T) {
    // row reduce: column sums of acc * T over this CTA's 64 rows
    const __nv_bfloat16* T = static_cast<const __nv_bfloat16*>(p->T);
    float cs[8][2];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) cs[ni][0] = cs[ni][1] = 0.f;
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
              cs[ni][j] += acc[mi][ni][2 * h + j] *
                           __bfloat162float(T[m * p->sTm + n * p->sTn]);
          }
      }
    // the 8 row groups g of a warp share columns: lanes t, t + 4, .., t + 28
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          cs[ni][j] += __shfl_xor_sync(0xffffffffu, cs[ni][j], off);
    if (g == 0)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          Red[warp >> 1][wn + ni * 8 + 2 * t + j] = cs[ni][j];
    __syncthreads();
    const int n = n0 + tid;  // 128 threads, 128 columns
    if (n < N)
      p->partial[(long long)blockIdx.y * N + n] = Red[0][tid] + Red[1][tid];
    finish_row_reduce<TOut>(*p, N, n);
    return;
  }

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
            store_from_f32(C + m * sCm + n * sCn,
                           FEAT == FEAT_PLAIN
                               ? acc[mi][ni][2 * h + j]
                               : epilogue(*p, b, m, n, acc[mi][ni][2 * h + j]));
        }
    }
}

template <typename TOut, bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
contract_bf16_mma_kernel(const __nv_bfloat16* __restrict__ A,
                         const __nv_bfloat16* __restrict__ B,
                         TOut* __restrict__ C, int M, int N, int K,
                         long long sAb, long long sAm, long long sAk,
                         long long sBb, long long sBk, long long sBn,
                         long long sCb, long long sCm, long long sCn) {
  contract_bf16_body<TOut, VEC, FEAT_PLAIN>(A, B, C, M, N, K, sAb, sAm, sAk,
                                            sBb, sBk, sBn, sCb, sCm, sCn,
                                            nullptr);
}

template <typename TOut, bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
contract_bf16_mma_fused_kernel(const ContractParams p) {
  contract_bf16_body<TOut, VEC, FEAT_FUSED>(
      static_cast<const __nv_bfloat16*>(p.A),
      static_cast<const __nv_bfloat16*>(p.B), static_cast<TOut*>(p.C),
      (int)p.M, (int)p.N, (int)p.K, p.sAb, p.sAm, p.sAk, p.sBb, p.sBk, p.sBn,
      p.sCb, p.sCm, p.sCn, &p);
}

int features(const ContractParams& p) {
  return p.T || p.kscale.p || p.mul.p || p.scale.p || p.bias.p || p.mean.p ||
                 p.act
             ? FEAT_FUSED
             : FEAT_PLAIN;
}

template <typename TOut>
void launch_f32(const ContractParams& p, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.batch);
  if (features(p) == FEAT_PLAIN)
    contract_f32_kernel<TOut><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(p.A), static_cast<const float*>(p.B),
        static_cast<TOut*>(p.C), (int)p.M, (int)p.N, (int)p.K, p.sAb, p.sAm,
        p.sAk, p.sBb, p.sBk, p.sBn, p.sCb, p.sCm, p.sCn);
  else
    contract_f32_fused_kernel<TOut><<<grid, THREADS, 0, stream>>>(p);
}

template <typename TOut, bool VEC>
void launch_bf16_vec(const ContractParams& p, dim3 grid,
                     cudaStream_t stream) {
  if (features(p) == FEAT_PLAIN)
    contract_bf16_mma_kernel<TOut, VEC><<<grid, TC_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(p.A),
        static_cast<const __nv_bfloat16*>(p.B), static_cast<TOut*>(p.C),
        (int)p.M, (int)p.N, (int)p.K, p.sAb, p.sAm, p.sAk, p.sBb, p.sBk,
        p.sBn, p.sCb, p.sCm, p.sCn);
  else
    contract_bf16_mma_fused_kernel<TOut, VEC>
        <<<grid, TC_THREADS, 0, stream>>>(p);
}

template <typename TOut>
void launch_bf16(const ContractParams& p, cudaStream_t stream) {
  const dim3 grid((p.N + TC_BN - 1) / TC_BN, (p.M + TC_BM - 1) / TC_BM,
                  p.batch);
  const bool vec =
      p.sAk == 1 && p.sBn == 1 && p.K % 8 == 0 && p.N % 8 == 0 &&
      p.sAm % 8 == 0 && p.sBk % 8 == 0 &&
      (p.batch == 1 || (p.sAb % 8 == 0 && p.sBb % 8 == 0)) &&
      reinterpret_cast<uintptr_t>(p.A) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p.B) % 16 == 0;
  if (vec)
    launch_bf16_vec<TOut, true>(p, grid, stream);
  else
    launch_bf16_vec<TOut, false>(p, grid, stream);
}

// ---------------------------------------------------------------------------
// The ring body: plain bf16 products on hopper.cuh's TMA / mbarrier / wgmma
// skeleton (see the header of this file).
// ---------------------------------------------------------------------------
constexpr int R_BM = 128;
constexpr int R_BK = 64;  // one 128-byte swizzled row of bf16
constexpr int R_THREADS = 384;
constexpr int R_CONSUMERS = 256;
constexpr int R_A_BYTES = R_BM * R_BK * 2;
constexpr int R_RING_BYTES = 192 * 1024;
constexpr int R_BAND = 8;    // row tiles of a rasterization band
constexpr int A_MMAJOR = 1;  // layout bits: A stored (k, m), m contiguous
constexpr int B_NMAJOR = 2;  // ... B stored (k, n), n contiguous

template <int BN>
struct Ring {
  static constexpr int STAGE = R_A_BYTES + BN * R_BK * 2;
  static constexpr int STAGES = R_RING_BYTES / STAGE;  // 6 at BN 128, 4 at 256
  static constexpr int ACC = BN / 2;  // f32 accumulators of a consumer thread
  // the ring, 1024 bytes to align it, full and empty barriers, a flag
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8 + 16;
};

__device__ __forceinline__ void store2_from_f32(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2_from_f32(__nv_bfloat16* p, float a,
                                                float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One consumer warpgroup's K loop: its 64 rows (``half``) of each stage's A
// tile against the stage's whole B tile, four k16 wgmmas a stage.  The
// stage before is released once its group has retired (wait_group 1).
template <int BN, bool AT, bool BT>
__device__ __forceinline__ void ring_mainloop(float (&acc)[BN / 2],
                                              uint32_t tiles, uint64_t* full,
                                              uint64_t* empty, int steps,
                                              int half) {
  using R = Ring<BN>;
  for (int i = 0; i < steps; ++i) {
    const int s = i % R::STAGES;
    hopper::mbar_wait(&full[s], (i / R::STAGES) & 1);
    const uint32_t a = tiles + s * R::STAGE + half * 8192;
    const uint32_t bt = tiles + s * R::STAGE + R_A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::wgmma_bf16<AT, BT>(
          acc,
          AT ? hopper::desc(a + ks * 2048, 8192, 1024)
             : hopper::desc(a + ks * 32, 16, 1024),
          BT ? hopper::desc(bt + ks * 2048, 8192, 1024)
             : hopper::desc(bt + ks * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (i > 0 && threadIdx.x % 128 == 0)
      hopper::mbar_arrive(&empty[(i - 1) % R::STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// The masked store of a consumer thread's fragment: rows r0 and r0 + 8,
// columns c0 + 8j and c0 + 8j + 1 (wgmma's accumulator layout), adjacent
// pairs as one word where ``pair``.
template <typename TOut, int ACC>
__device__ __forceinline__ void ring_store(TOut* C, const float (&acc)[ACC],
                                           int r0, int c0, int M, int N,
                                           long long sCm, long long sCn,
                                           bool pair) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m >= M) continue;
    TOut* row = C + m * sCm;
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
      const int n = c0 + 8 * j;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pair && n + 1 < N) {
        store2_from_f32(row + n, v0, v1);
      } else {
        if (n < N) store_from_f32(row + n * sCn, v0);
        if (n + 1 < N) store_from_f32(row + (n + 1) * sCn, v1);
      }
    }
  }
}

// Grid (tiles, 1, batch x splits): the (M / 128) x (N / BN) tiles in bands
// of R_BAND row tiles (hopper::raster); 384 threads: warpgroup 0 the
// producer, 1 and 2 the consumers.  ``layout``: A_MMAJOR | B_NMAJOR bits,
// matching the boxes of tmA (K-major: 64 k x 128 m; M-major: 64 m x 64 k)
// and tmB (K-major: 64 k x BN n; N-major: 64 n x 64 k).
template <int BN>
__global__ void __launch_bounds__(R_THREADS, 1)
contract_bf16_ring_kernel(const __grid_constant__ CUtensorMap tmA,
                          const __grid_constant__ CUtensorMap tmB, void* C,
                          int M, int N, int K, long long sCb, long long sCm,
                          long long sCn, int layout, int out_bf16, int splits,
                          float* partial, int* counter) {
  using R = Ring<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* tiles =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  int* last = reinterpret_cast<int*>(empty + R::STAGES);

  const int gx = (N + BN - 1) / BN;
  const int gy = (M + R_BM - 1) / R_BM;
  int m_t, n_t;
  hopper::raster(blockIdx.x, gx, gy, R_BAND, m_t, n_t);
  const int n0 = n_t * BN;
  const int m0 = m_t * R_BM;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int nk = (K + R_BK - 1) / R_BK;
  const int per = (nk + splits - 1) / splits;
  const int k_first = split * per;
  const int steps = min(nk, k_first + per) - k_first;  // >= 1 (the host's)

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
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
      for (int i = 0; i < steps; ++i) {
        const int s = i % R::STAGES;
        hopper::mbar_wait(&empty[s], ((i / R::STAGES) & 1) ^ 1);
        hopper::mbar_arrive_tx(&full[s], R::STAGE);
        unsigned char* a = tiles + s * R::STAGE;
        unsigned char* bt = a + R_A_BYTES;
        const int k0 = (k_first + i) * R_BK;
        if (layout & A_MMAJOR) {  // two 64-row atoms
          hopper::tma_load(a, &tmA, &full[s], m0, k0, b);
          hopper::tma_load(a + 8192, &tmA, &full[s], m0 + 64, k0, b);
        } else {
          hopper::tma_load(a, &tmA, &full[s], k0, m0, b);
        }
        if (layout & B_NMAJOR) {  // BN / 64 column atoms
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load(bt + j * 8192, &tmB, &full[s], n0 + 64 * j, k0,
                             b);
        } else {
          hopper::tma_load(bt, &tmB, &full[s], k0, n0, b);
        }
      }
    }
    return;
  }

  hopper::regs_inc<232>();
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int half = ct >> 7;          // its warpgroup's 64 rows
  float acc[R::ACC];
#pragma unroll
  for (int i = 0; i < R::ACC; ++i) acc[i] = 0.f;
  const uint32_t base = hopper::smem_u32(tiles);
  switch (layout) {
    case 0:
      ring_mainloop<BN, false, false>(acc, base, full, empty, steps, half);
      break;
    case A_MMAJOR:
      ring_mainloop<BN, true, false>(acc, base, full, empty, steps, half);
      break;
    case B_NMAJOR:
      ring_mainloop<BN, false, true>(acc, base, full, empty, steps, half);
      break;
    default:
      ring_mainloop<BN, true, true>(acc, base, full, empty, steps, half);
      break;
  }

  if (splits > 1) {
    // this split's partial tile to scratch ([tile][split][i][thread]), then
    // the last CTA of the tile to arrive sums every split in split order
    const long long tile = ((long long)b * gy + m_t) * gx + n_t;
    float* mine = partial + (tile * splits + split) * (R_BM * BN);
#pragma unroll
    for (int i = 0; i < R::ACC; ++i)
      __stcg(mine + i * R_CONSUMERS + ct, acc[i]);
    __threadfence();
    hopper::bar_sync(1, R_CONSUMERS);
    if (ct == 0) *last = atomicAdd(counter + tile, 1) == splits - 1;
    hopper::bar_sync(1, R_CONSUMERS);
    if (!*last) return;
    __threadfence();
    const float* all = partial + tile * splits * (R_BM * BN);
#pragma unroll
    for (int i = 0; i < R::ACC; ++i) acc[i] = 0.f;
    for (int sp = 0; sp < splits; ++sp)
#pragma unroll
      for (int i = 0; i < R::ACC; ++i)
        acc[i] += __ldcg(all + sp * (R_BM * BN) + i * R_CONSUMERS + ct);
  }

  const int lane = ct & 31;
  const int r0 = m0 + half * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  const bool pair = sCn == 1 && sCm % 2 == 0 && sCb % 2 == 0;
  if (out_bf16)
    ring_store(static_cast<__nv_bfloat16*>(C) + b * sCb, acc, r0, c0, M, N,
               sCm, sCn, pair);
  else
    ring_store(static_cast<float*>(C) + b * sCb, acc, r0, c0, M, N, sCm, sCn,
               pair);
}

// The ring's launch: checks its preconditions (cudaErrorInvalidValue when
// one fails; nothing switches body), encodes the two tensor maps and
// launches.  An operand is taken K-major where it has unit stride along k,
// else M-major (A) / N-major (B) where it has unit stride there; the other
// strides must be what TMA reads (hopper::tma_ok).
template <int BN>
int launch_ring(const ContractParams& p, cudaStream_t stream) {
  using R = Ring<BN>;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const long long nk = (p.K + R_BK - 1) / R_BK;
  if (p.in_dtype != 1 || features(p) != FEAT_PLAIN || p.M < 64 || p.K < 1 ||
      p.N < 1 || p.batch < 1 || p.splits < 1 || p.splits > nk ||
      (p.splits > 1 && (!p.partial || !p.counter)))
    return invalid;
  const long long per = (nk + p.splits - 1) / p.splits;
  const long long tiles = ((p.M + R_BM - 1) / R_BM) * ((p.N + BN - 1) / BN);
  const long long gz = p.batch * p.splits;
  if ((p.splits - 1) * per >= nk || tiles >= (1LL << 31) || gz > 65535)
    return invalid;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ta, tb;
  int layout = 0;
  const hopper::Operand a_k{p.A, p.K, p.M, p.sAm, p.batch, p.sAb};
  const hopper::Operand a_m{p.A, p.M, p.K, p.sAk, p.batch, p.sAb};
  if ((p.sAk == 1 || p.K == 1) && hopper::tma_ok(a_k, 2)) {
    if (!hopper::make_map(&ta, a_k, 2, bf16, R_BK, R_BM)) return invalid;
  } else if (p.sAm == 1 && hopper::tma_ok(a_m, 2)) {
    if (!hopper::make_map(&ta, a_m, 2, bf16, 64, R_BK)) return invalid;
    layout |= A_MMAJOR;
  } else {
    return invalid;
  }
  const hopper::Operand b_k{p.B, p.K, p.N, p.sBn, p.batch, p.sBb};
  const hopper::Operand b_n{p.B, p.N, p.K, p.sBk, p.batch, p.sBb};
  if ((p.sBk == 1 || p.K == 1) && hopper::tma_ok(b_k, 2)) {
    if (!hopper::make_map(&tb, b_k, 2, bf16, R_BK, BN)) return invalid;
  } else if ((p.sBn == 1 || p.N == 1) && hopper::tma_ok(b_n, 2)) {
    if (!hopper::make_map(&tb, b_n, 2, bf16, 64, R_BK)) return invalid;
    layout |= B_NMAJOR;
  } else {
    return invalid;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      contract_bf16_ring_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((unsigned)tiles, 1, (unsigned)gz);
  contract_bf16_ring_kernel<BN><<<grid, R_THREADS, R::SMEM, stream>>>(
      ta, tb, p.C, (int)p.M, (int)p.N, (int)p.K, p.sCb, p.sCm, p.sCn, layout,
      p.out_dtype == 1, (int)p.splits, p.partial, p.counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Strides are in elements.  The row-reduce mode (T set) needs batch 1, a
// (row blocks, N) f32 partial buffer and one zeroed int per column block
// (the row and column block counts of the chosen body: contract_tile_*).
// body 1 runs the ring (tile_n, splits; with splits > 1 a partial buffer
// of batch x row tiles x column tiles x splits x 128 x tile_n floats and
// one zeroed int per output tile, (batch, row tile, column tile) order),
// or refuses.  Returns cudaGetLastError()
// after the launch (0 = launched); nothing is synchronised, and nothing is
// allocated here.
int contract_launch(const ContractParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->in_dtype < 0 || p->in_dtype > 1 || p->out_dtype < 0 ||
      p->out_dtype > 1 || (p->T && p->batch != 1) ||
      (p->mean.p == nullptr) != (p->var.p == nullptr) || p->act < 0 ||
      p->act > 4 || p->body < 0 || p->body > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->body == 1) {
    if (p->tile_n == 128) return launch_ring<128>(*p, s);
    if (p->tile_n == 256) return launch_ring<256>(*p, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (p->in_dtype * 2 + p->out_dtype) {
    case 0:
      launch_f32<float>(*p, s);
      break;
    case 1:
      launch_f32<__nv_bfloat16>(*p, s);
      break;
    case 2:
      launch_bf16<float>(*p, s);
      break;
    case 3:
      launch_bf16<__nv_bfloat16>(*p, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The CTA tile of each body, so the Python wrapper sizes the grid checks and
// the row-reduce scratch with the kernel's own numbers.
int contract_tile_m(int in_dtype) { return in_dtype == 1 ? TC_BM : BM; }
int contract_tile_n(int in_dtype) { return in_dtype == 1 ? TC_BN : BN; }

// The ring's CTA rows, checked against cuda_gen.RING_BM at load: the
// wrapper sizes the split scratch and counters with it.
int contract_ring_tile_m(void) { return R_BM; }

// sizeof(ContractParams), checked against the ctypes mirror at load.
int contract_params_size(void) { return (int)sizeof(ContractParams); }

}  // extern "C"
