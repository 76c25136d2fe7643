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
// is the tensor-core rate from M = 512 up and the weight bytes at M = 128;
// at decode (M = 1..63) it does 2M operations a weight, and the weight
// bytes alone bound it.  The epilogue and the prologue add O(MN) and O(MK)
// arithmetic, nothing to that bound.  An f32 product at the fused path's
// shape (M = 2048, K = 4096, N = 12288) is bound by its operations: 1.25
// ms at 3xTF32's 165 TFLOP/s (TF32's 495 over three products), 6.2 ms at
// the FMA pipes' 67.  Five bodies; each takes its own CTA
// grid (the TPU plan's grid, often a single block, is not used),
// accumulates in f32 in a fixed order per output and masks ragged edges,
// so any M, N, K is legal:
//   * the ring body (body 1), for bf16 products at M >= 64 whose operands
//     TMA can read (each with unit stride on one of its two axes, the
//     other strides multiples of 16 bytes, 16-byte aligned bases;
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
//     fused modes run the same body as contract_bf16_ring_fused_kernel
//     (BN = 128 or 256; 128 for the k-scale and row-reduce modes).  The
//     epilogue runs after the split sum (an activation needs the whole
//     sum) on the f32 tile staged in the drained ring: each vector is
//     staged once a tile as row and column factors in shared memory, a
//     thread holds its columns' factors in registers, and a loop over the
//     rows applies every stage without a branch (an unset one is the
//     identity) and stores each row contiguously.  Applied to the
//     fragments in registers, with the activation's switch at every one of
//     a thread's 64-128 values, the same epilogue took the kernel to
//     2-3x the plain ring's time.  The k-scale prologue takes A through
//     registers: ldmatrix from the swizzled tile, scaled in f32 and
//     rounded once to bf16, the register-A wgmma (A K-major only); the
//     stage's 64 scale values come by TMA with the stage.  Rewriting the
//     A tile in shared memory (by the consumers, or by the producer's idle
//     warps) and loading the values from device memory in the loop each
//     left the tensor cores waiting.  The row reduce multiplies the
//     fragments by T, sums rows by shuffles and the two warpgroups' rows
//     in shared memory in warp order, one partial row a 128-row tile, and
//     the last CTA of the column block sums them in row-tile order (no
//     float atomics).
//     The libcuda's cuTensorMapEncodeTiled is reached through the
//     runtime's entry-point query (hopper.cuh), so the library links no
//     libcuda;
//   * the narrow body (body 2), for plain bf16 products at M < 64 (decode)
//     whose x has unit stride along k and whose W TMA reads K- or N-major:
//     the same ring with the operands' roles swapped, C^T = W^T x^T, so the
//     weights' N fills wgmma's 64-row side and x^T, M tokens zero-filled
//     to BN = 8, 16, 32 or 64 columns, is the m64nBNk16 B operand (W
//     N-major through the transposed descriptor).  A CTA owns 128 of N;
//     the K steps are split across CTAs so the grid holds up to two CTAs
//     an SM (104 KB rings, 4-6 stages in flight each), and the last CTA of
//     a tile sums the partials in split order and stores C transposed,
//     masked to the M tokens (cuda_gen.narrow_tiles);
//   * every other bf16 product (unaligned or element-strided operands,
//     x not k-contiguous at M < 64) and the fused modes at M < 64 run
//     mma.sync m16n8k16
//     (bf16 in, f32 accumulate) on a 64 x 128 CTA tile over 4 warps of 32 x
//     64, K in steps of 32.  A is staged row-major and B transposed
//     (n-major) with rows padded to 40 elements, so every fragment load of
//     a warp hits 32 distinct banks.  Global loads are 16 bytes where the
//     strides allow (unit stride along k for A and along n for B, 8-element
//     aligned), else element-wise.  Loads and math alternate;
//   * the tc32 body (body 3), for f32 products, plain or with the
//     epilogue and multiplier modes, whose x (A) has unit stride along k
//     or m and whose W (B) unit stride along n or k, as TMA reads them
//     (codegen.cuda_gen.contract_body; launch_tc32 refuses the rest):
//     3xTF32 on the tensor cores.  Each operand is split into hi + lo,
//     each rounded to TF32 (to nearest, ties away: cvt.rna's rounding),
//     and each product accumulates lo.hi + hi.lo + hi.hi in f32, about
//     2^-21 relative against TF32's 2^-11 (B2's tc32 body, held at the f32
//     tolerance).  tf32 wgmma reads shared-memory operands K-major only
//     (no transpose bits), and the fused path's W is N-major, so the
//     roles are swapped as in the narrow body: C^T = W^T x^T, W^T
//     wgmma's register A operand and x^T its K-major shared B.  A CTA of
//     three warpgroups owns 128 of N by BMX of M: thread 0 keeps TMA
//     loads of 32-deep K steps in flight into a ring of up to 192 KB;
//     warps 1-3 split each landed x tile into hi and lo rows, fence them
//     for the async proxy and release the stage on a second ("ready")
//     mbarrier; the two consumer warpgroups read W^T's fragments with
//     8-byte shared loads (either of W's layouts), split them in registers
//     and run three m64nBMXk8 wgmmas a k8 step.  An x with unit stride
//     along k lands k-major and is split in place (four 48 KB stages at
//     BMX 128); one with unit stride along m only (matmul.dB's x^T, the
//     weighted dB's) lands m-major in a tile of its own, four boxes of 32
//     m x 32 k, and the splitting warps transpose it as they split: 4 m at
//     one k read as a float4, 4 x 4 transposed in registers, hi and lo
//     written in the stage's k order, so the consumers see the same tiles
//     (three 64 KB stages); no copy of x^T is made.  A plain product at M
//     < 64 whose x is k-major takes a narrow x tile, BMX = M rounded up
//     to 8, 16, 32 or 64, so a stage holds 18-32 KB and the ring 6-10
//     stages of W in flight (decode: W's bytes bound it, and a 128-wide
//     tile would spend its wgmmas on zero columns); the fused modes
//     keep BMX 128 (fused_store's 128 rows).  A plain unsplit product
//     runs one CTA an SM, each walking its tiles in turn with its ring
//     running on, so the next tile's loads are in flight while a tile is
//     stored (decode's matmul.dB, K = 4: the 2.49 GB store bounds it).
//     Where the output has few tiles the K steps are split across CTAs
//     as the ring's (cuda_gen.tc32_tiles picks BMX and the split).  The
//     tensor cores round their own accumulation toward zero, so a sum
//     over all of K drifts with K; each stage's twelve products are
//     summed from zero and added to the accumulator in f32 instead.  The
//     epilogue and the multiplier vector run on the f32 tile staged in
//     the drained ring, as the fused ring's (fused_store); a plain
//     product stores its fragments, two neighbouring n a word;
//   * the other f32 products (the k-scale prologue, the row reduce,
//     layouts TMA cannot read) keep exact f32 math on the FMA pipes: a
//     128 x 64 CTA tile, each of 256 threads owning an 8 x 4 micro-tile
//     (rows ty + 16 i, columns tx + 16 j, so a warp's shared reads are
//     conflict-free).
// Every split and row-reduce counter is set back to 0 by the CTA that
// finishes with it, so the wrapper zeroes its counters once and a launch
// is one kernel and nothing else.
// The store rounds to the output type (round to nearest even for bf16),
// as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

extern "C" {

// One vector operand: element (coord / div) % len of p (contiguous; f32,
// or bf16 where ``bf16`` is set), where coord is the folded batch (axis
// 0), m (1), n (2) or k (3) coordinate.  p == nullptr means the stage is
// off.
struct Vec {
  const void* p;
  long long div;
  long long len;
  int axis;
  int bf16;
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
  int body;                    // 0 mma.sync / FMA bodies, 1 the ring, 2
                               // the narrow body, 3 tc32 (3xTF32)
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
  const long long i =
      v.div == 1 && c < v.len ? c : vec_index_slow(c, v.div, v.len);
  return v.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v.p)[i])
                : static_cast<const float*>(v.p)[i];
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
// column block sums the partial rows in row-block order and stores C[n],
// and sets the block's counter back to 0.
template <typename TOut>
__device__ __forceinline__ void finish_row_reduce(const ContractParams& p,
                                                  int N, int n) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(p.counter + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) p.counter[blockIdx.x] = 0;  // for the next launch
  if (n >= N) return;
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
// The ring bodies on hopper.cuh's TMA / mbarrier / wgmma skeleton (see the
// header of this file): the plain ring, its fused instantiation, and the
// narrow body of decode's products.
// ---------------------------------------------------------------------------
constexpr int R_BM = 128;
constexpr int R_BK = 64;  // one 128-byte swizzled row of bf16
constexpr int R_THREADS = 384;
constexpr int R_CONSUMERS = 256;
constexpr int R_A_BYTES = R_BM * R_BK * 2;
constexpr int R_RING_BYTES = 192 * 1024;
// the narrow body's ring: two CTAs an SM (2 x 104 KB of its 228 KB)
constexpr int N_RING_BYTES = 104 * 1024;
// the fused ring's tile width for the k-scale and row-reduce modes (the
// epilogue and multiplier modes also take 256, as the plain ring does)
constexpr int R_FUSED_BN = 128;
constexpr int R_BAND = 8;    // row tiles of a rasterization band
constexpr int A_MMAJOR = 1;  // layout bits: A stored (k, m), m contiguous
constexpr int B_NMAJOR = 2;  // ... B stored (k, n), n contiguous

template <int BN, int RING_BYTES = R_RING_BYTES>
struct Ring {
  static constexpr int STAGE = R_A_BYTES + BN * R_BK * 2;
  // 6 at BN 128, 4 at 256; narrow: 6 at BN 8, 5 at 16 and 32, 4 at 64
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int ACC = BN / 2;  // f32 accumulators of a consumer thread
  // the ring, 1024 bytes to align it, full and empty barriers, a flag
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8 + 16;
};

// The fused ring's shared memory after the ring's: the epilogue's vectors,
// staged once a tile at the tile's local row (a vector along m) or column
// (along n) coordinate, entry 0 for a vector along batch; and the row
// reduce's column sums of the 8 consumer warps.
struct FusedSmem {
  float ksv[8][R_BK];  // each stage's 64 k-scale values (TMA, f32 or bf16)
  // the epilogue's mul, scale, bias, mean and rsqrt(var + eps) as a row
  // factor (a vector along m or batch) and a column factor (along n), the
  // other one the stage's identity (1, 1, 0, 0, 1)
  float vr[5][R_BM];
  float vc[5][256];
  float red[8][R_FUSED_BN];
};
static_assert(Ring<R_FUSED_BN>::STAGES <= 8, "a k-scale slot a stage");
// the fused epilogue's f32 tile in the drained ring: 128 rows of BN + 8
// floats (the pad spreads a fragment's rows over banks); a warp takes 4
// columns a thread of 128 columns of a row a pass
template <int BN>
struct ETile {
  static_assert(BN % 128 == 0 && BN <= 256, "a staged vector per column");
  static constexpr int LD = BN + 8;
  static_assert(R_BM * LD * 4 <= Ring<BN>::STAGES * Ring<BN>::STAGE,
                "the epilogue tile fits the drained ring");
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
template <typename R, bool AT, bool BT>
__device__ __forceinline__ void ring_mainloop(float (&acc)[R::ACC],
                                              uint32_t tiles, uint64_t* full,
                                              uint64_t* empty, int steps,
                                              int half) {
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

// The k-scale prologue's K loop (the fused ring, A K-major): A goes
// through registers.  Each k16 step's A fragment of the warp's 16 rows is
// read from the swizzled tile by ldmatrix (lane l: row l % 8 + 8 (l / 8 %
// 2), 16-byte chunk 2 ks + l / 16, stored at chunk ^ row % 8), scaled in
// f32 and rounded once to bf16 (as contract_bf16_body scales as it
// stages: the thread's k are 2t, 2t + 1, 2t + 8 and 2t + 9 of the step),
// and fed to the register-A wgmma; B stays in shared memory.  The stage's
// 64 scale values arrive with it, by TMA into ``ksv`` (zero past K):
// loaded from device memory in the loop, they left the tensor cores
// waiting on their latency.  A warpgroup waits for its own group before
// it writes the next fragments (ptxas serializes every wgmma of a kernel
// whose registers feeding a wgmma are written while another is in
// flight, C7513); the other consumer warpgroup's group keeps the tensor
// cores busy meanwhile.  KBF16: the vector is bf16, else f32.
template <typename R, bool BT, bool KBF16>
__device__ __forceinline__ void ring_mainloop_ks(float (&acc)[R::ACC],
                                                 uint32_t tiles,
                                                 uint64_t* full,
                                                 uint64_t* empty, int steps,
                                                 int half, const float* ksv) {
  static_assert(R::ACC == 64, "the register-A wgmma is m64n128k16");
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane & 7) +
                  8 * ((lane >> 3) & 1);
  const uint32_t mine = tiles + half * 8192 + row * 128;
  const int kt = 2 * (lane & 3);
  for (int i = 0; i < steps; ++i) {
    const int s = i % R::STAGES;
    hopper::mbar_wait(&full[s], (i / R::STAGES) & 1);
    // the thread's (k, k + 1) pairs of the stage: 16 q + kt (+ 8)
    float2 sv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 16 * (j >> 1) + kt + 8 * (j & 1);
      if (KBF16)
        sv[j] = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(ksv + s * R_BK)[k / 2]);
      else
        sv[j] = reinterpret_cast<const float2*>(ksv + s * R_BK)[k / 2];
    }
    const uint32_t a = mine + s * R::STAGE;
    uint32_t af[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hopper::ldmatrix_x4(
          af[q], a + ((((2 * q + (lane >> 4)) ^ (row & 7))) << 4));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&af[q][r]));
        const float2 g = sv[2 * q + (r >> 1)];
        const __nv_bfloat162 y = __floats2bfloat162_rn(f.x * g.x, f.y * g.y);
        af[q][r] = *reinterpret_cast<const uint32_t*>(&y);
      }
    }
    const uint32_t bt = tiles + s * R::STAGE + R_A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      hopper::wgmma_bf16_rs<BT>(acc, af[q],
                                BT ? hopper::desc(bt + q * 2048, 8192, 1024)
                                   : hopper::desc(bt + q * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) hopper::fence_regs(af[q]);
    if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[s]);
  }
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

// Stage the epilogue's vectors of the tile at (b, m0, n0) (consumer thread
// ``ct`` writes entry ct of each): a vector along n as column factors,
// along m as row factors, along batch as the one row factor of every
// row; var as rsqrt(var + eps), the factor epilogue() computes per
// element.  An unset stage, and the side a vector does not run along,
// hold the identity, so fused_store applies every stage without a branch
// and gets epilogue()'s values exactly.
template <int BN>
__device__ __forceinline__ void stage_vectors(FusedSmem* fs,
                                              const ContractParams& p,
                                              long long b, int m0, int n0,
                                              int ct) {
  const Vec* vs[5] = {&p.mul, &p.scale, &p.bias, &p.mean, &p.var};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const Vec& v = *vs[i];
    const float id = i == 2 || i == 3 ? 0.f : 1.f;
    const int m = m0 + ct, n = n0 + ct;
    if (ct < BN) {
      float x = id;
      if (v.p && v.axis == 2 && n < p.N) {
        x = vec_at(v, b, m0, n, 0);
        if (i == 4) x = rsqrtf(x + p.eps);
      }
      fs->vc[i][ct] = x;
    }
    if (ct < R_BM) {
      float x = id;
      if (v.p && (v.axis == 0 || (v.axis == 1 && m < p.M))) {
        x = vec_at(v, b, m, n0, 0);
        if (i == 4) x = rsqrtf(x + p.eps);
      }
      fs->vr[i][ct] = x;
    }
  }
}

// The fused epilogue and store from the f32 tile staged in the drained
// ring (``tile``, 128 x ETile<BN>::LD): a loop over the rows, 8 a pass, a
// warp's 32 threads on 4 columns each of 128 columns of one row, so the
// stores of a row are contiguous (4 values a thread, two pairs, where C
// has unit column stride and even strides).  Every stage is applied, from
// the row factors of the row and the thread's column factors (held in
// registers), in epilogue()'s order; ACT is the activation.
template <int BN, int ACT, typename TOut>
__device__ __forceinline__ void fused_store(const float* tile,
                                            const ContractParams& p,
                                            const FusedSmem* fs, TOut* C,
                                            int m0, int n0, int ct) {
  constexpr int LD = ETile<BN>::LD;
  constexpr int G = BN / 128;
  const int M = (int)p.M, N = (int)p.N;
  const bool pairs = p.sCn == 1 && p.sCm % 2 == 0 && p.sCb % 2 == 0;
  float4 cf[5][G];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
      cf[i][g] = *reinterpret_cast<const float4*>(
          &fs->vc[i][(ct & 31) * 4 + 128 * g]);
#pragma unroll 2
  for (int r = ct >> 5; r < R_BM; r += R_CONSUMERS / 32) {
    const int m = m0 + r;
    if (m >= M) break;
    const float rf[5] = {fs->vr[0][r], fs->vr[1][r], fs->vr[2][r],
                         fs->vr[3][r], fs->vr[4][r]};
    TOut* row = C + m * p.sCm;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = (ct & 31) * 4 + 128 * g;
      const int n = n0 + c;
      const float4 v = *reinterpret_cast<const float4*>(tile + r * LD + c);
      float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const auto col = [&](int i) {
          return reinterpret_cast<const float*>(&cf[i][g])[e];
        };
        float z = y[e] * (rf[0] * col(0));
        z *= rf[1] * col(1);
        z += rf[2] + col(2);
        z = (z - (rf[3] + col(3))) * (rf[4] * col(4));
        y[e] = activate(ACT, z);
      }
      if (pairs && n + 3 < N) {
        store2_from_f32(row + n, y[0], y[1]);
        store2_from_f32(row + n + 2, y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) store_from_f32(row + (n + e) * p.sCn, y[e]);
      }
    }
  }
}

// fused_store with the activation as a template argument (the loop holds
// one activation's code, not five)
template <int BN, typename TOut>
__device__ __forceinline__ void fused_store_act(const float* tile,
                                                const ContractParams& p,
                                                const FusedSmem* fs, TOut* C,
                                                int m0, int n0, int ct) {
  switch (p.act) {
    case 1:
      fused_store<BN, 1>(tile, p, fs, C, m0, n0, ct);
      break;
    case 2:
      fused_store<BN, 2>(tile, p, fs, C, m0, n0, ct);
      break;
    case 3:
      fused_store<BN, 3>(tile, p, fs, C, m0, n0, ct);
      break;
    case 4:
      fused_store<BN, 4>(tile, p, fs, C, m0, n0, ct);
      break;
    default:
      fused_store<BN, 0>(tile, p, fs, C, m0, n0, ct);
      break;
  }
}

// The row-reduce mode on the ring (batch 1): C[n] = sum_m acc[m, n]
// T[m, n], a K split's column sums a row block of their own (``m_t`` the
// split's x ``gy`` row tiles + the row tile, ``gy`` the row tiles x the
// splits).  A thread sums its two rows, shuffles sum the 8 row
// groups of a warp, and the 8 consumer warps' rows are summed in shared
// memory in warp order: one partial row a 128-row tile.  The last CTA of
// the column block to arrive sums the partial rows in row-tile order,
// stores, and sets the block's counter back to 0 for the next launch.
template <typename TOut, int ACC>
__device__ __forceinline__ void ring_row_reduce(const float (&acc)[ACC],
                                                const ContractParams& p,
                                                FusedSmem* fs, int* last,
                                                int r0, int c0, int n0,
                                                int m_t, int n_t, int gy,
                                                int ct) {
  const int M = (int)p.M, N = (int)p.N;
  const __nv_bfloat16* T = static_cast<const __nv_bfloat16*>(p.T);
  float cs[ACC / 2];
#pragma unroll
  for (int i = 0; i < ACC / 2; ++i) cs[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = c0 + 8 * j + e;
        if (n < N)
          cs[2 * j + e] += acc[4 * j + 2 * h + e] *
                           __bfloat162float(T[m * p.sTm + n * p.sTn]);
      }
  }
  // lanes t, t + 4, .., t + 28 share columns
#pragma unroll
  for (int i = 0; i < ACC / 2; ++i)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], off);
  const int lane = ct & 31;
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        fs->red[ct >> 5][8 * j + 2 * lane + e] = cs[2 * j + e];
  hopper::bar_sync(1, R_CONSUMERS);
  const int n = n0 + ct;
  const bool mine = ct < 2 * ACC && n < N;  // 2 ACC: the tile's columns
  if (mine) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += fs->red[w][ct];
    __stcg(p.partial + (long long)m_t * N + n, s);
  }
  __threadfence();
  hopper::bar_sync(1, R_CONSUMERS);
  if (ct == 0) *last = atomicAdd(p.counter + n_t, 1) == gy - 1;
  hopper::bar_sync(1, R_CONSUMERS);
  if (!*last) return;
  __threadfence();
  if (ct == 0) p.counter[n_t] = 0;
  if (mine) {
    float s = 0.f;
    for (int r = 0; r < gy; ++r)
      s += __ldcg(p.partial + (long long)r * N + n);
    store_from_f32(static_cast<TOut*>(p.C) + n * p.sCn, s);
  }
}

// The body of the three ring kernels.  Grid (tiles, 1, batch x splits):
// the (M / 128) x (N / BN) tiles in bands of R_BAND row tiles
// (hopper::raster); 384 threads: warpgroup 0 the producer, 1 and 2 the
// consumers.  ``layout``: A_MMAJOR | B_NMAJOR bits, matching the boxes of
// tmA (K-major: 64 k x 128 m; M-major: 64 m x 64 k) and tmB (K-major: 64 k
// x BN n; N-major: 64 n x 64 k).  FEAT_FUSED reads ``p``'s k-scale,
// epilogue and row-reduce modes (null for FEAT_PLAIN); tmK maps the
// k-scale vector (boxes of 64).  NARROW: two CTAs
// an SM, so no register rebalancing (setmaxnreg's pool is the SM's).
template <int BN, int RING_BYTES, int FEAT, bool NARROW>
__device__ __forceinline__ void ring_body(
    const CUtensorMap* tmA, const CUtensorMap* tmB, void* C, int M, int N,
    int K, long long sCb, long long sCm, long long sCn, int layout,
    int out_bf16, int splits, float* partial, int* counter,
    const ContractParams* p, const CUtensorMap* tmK = nullptr) {
  using R = Ring<BN, RING_BYTES>;
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

  // the fused kernel's shared memory, 128-byte aligned for TMA
  FusedSmem* fs = reinterpret_cast<FusedSmem*>(
      (reinterpret_cast<uintptr_t>(last + 4) + 127) & ~uintptr_t(127));
  const int ks_bytes =
      FEAT == FEAT_FUSED && p->kscale.p ? R_BK * (p->kscale.bf16 ? 2 : 4) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer group
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    if constexpr (!NARROW) hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(tmA);
      hopper::tma_prefetch(tmB);
      for (int i = 0; i < steps; ++i) {
        const int s = i % R::STAGES;
        hopper::mbar_wait(&empty[s], ((i / R::STAGES) & 1) ^ 1);
        hopper::mbar_arrive_tx(&full[s], R::STAGE + ks_bytes);
        unsigned char* a = tiles + s * R::STAGE;
        unsigned char* bt = a + R_A_BYTES;
        const int k0 = (k_first + i) * R_BK;
        if (ks_bytes)  // the k-scale prologue's 64 values of the stage
          hopper::tma_load(fs->ksv[s], tmK, &full[s], k0, 0, 0);
        if (layout & A_MMAJOR) {  // two 64-row atoms
          hopper::tma_load(a, tmA, &full[s], m0, k0, b);
          hopper::tma_load(a + 8192, tmA, &full[s], m0 + 64, k0, b);
        } else {
          hopper::tma_load(a, tmA, &full[s], k0, m0, b);
        }
        if (layout & B_NMAJOR) {  // BN / 64 column atoms
          if constexpr (BN >= 64) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              hopper::tma_load(bt + j * 8192, tmB, &full[s], n0 + 64 * j,
                               k0, b);
          }
        } else {
          hopper::tma_load(bt, tmB, &full[s], k0, n0, b);
        }
      }
    }
    return;
  }

  if constexpr (!NARROW) hopper::regs_inc<232>();
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int half = ct >> 7;          // its warpgroup's 64 rows
  float acc[R::ACC];
#pragma unroll
  for (int i = 0; i < R::ACC; ++i) acc[i] = 0.f;
  const uint32_t base = hopper::smem_u32(tiles);
  bool done = false;
  if constexpr (FEAT == FEAT_FUSED) {
    stage_vectors<BN>(fs, *p, b, m0, n0, ct);
    if constexpr (BN == R_FUSED_BN) if (ks_bytes) {  // A K-major
      const float* ksv = &fs->ksv[0][0];
      if (layout & B_NMAJOR) {
        if (p->kscale.bf16)
          ring_mainloop_ks<R, true, true>(acc, base, full, empty, steps,
                                          half, ksv);
        else
          ring_mainloop_ks<R, true, false>(acc, base, full, empty, steps,
                                           half, ksv);
      } else {
        if (p->kscale.bf16)
          ring_mainloop_ks<R, false, true>(acc, base, full, empty, steps,
                                           half, ksv);
        else
          ring_mainloop_ks<R, false, false>(acc, base, full, empty, steps,
                                            half, ksv);
      }
      done = true;
    }
  }
  if (!done) {
    switch (layout) {
      case 0:
        ring_mainloop<R, false, false>(acc, base, full, empty, steps, half);
        break;
      case A_MMAJOR:
        ring_mainloop<R, true, false>(acc, base, full, empty, steps, half);
        break;
      case B_NMAJOR:
        if constexpr (BN >= 64)
          ring_mainloop<R, false, true>(acc, base, full, empty, steps, half);
        break;
      default:
        if constexpr (BN >= 64)
          ring_mainloop<R, true, true>(acc, base, full, empty, steps, half);
        break;
    }
  }

  // the row reduce takes a split's column sums as a row block of their
  // own (they are linear in acc), so its splits are never summed here
  bool row_reduce = false;
  if constexpr (FEAT == FEAT_FUSED) row_reduce = p->T != nullptr;
  if (splits > 1 && !row_reduce) {
    // this split's partial tile to scratch ([tile][split][i][thread]), then
    // the last CTA of the tile to arrive sums every split in split order
    // and sets the tile's counter back to 0 for the next launch
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
    if (ct == 0) counter[tile] = 0;
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
  if constexpr (FEAT == FEAT_FUSED) {
    if constexpr (BN == R_FUSED_BN) if (p->T) {
      if (out_bf16)
        ring_row_reduce<__nv_bfloat16>(acc, *p, fs, last, r0, c0, n0,
                                       split * gy + m_t, n_t, gy * splits,
                                       ct);
      else
        ring_row_reduce<float>(acc, *p, fs, last, r0, c0, n0,
                               split * gy + m_t, n_t, gy * splits, ct);
      return;
    }
    // both warpgroups are past their last wgmma (and the producer
    // warpgroup past its loads): the ring is free for the f32 tile
    hopper::bar_sync(1, R_CONSUMERS);
    float* tile = reinterpret_cast<float*>(tiles);
#pragma unroll
    for (int j = 0; j < R::ACC / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (r0 - m0 + 8 * h) * ETile<BN>::LD +
                                   (c0 - n0) + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    hopper::bar_sync(1, R_CONSUMERS);
    if (out_bf16)
      fused_store_act<BN>(tile, *p, fs,
                          static_cast<__nv_bfloat16*>(C) + b * sCb, m0, n0,
                          ct);
    else
      fused_store_act<BN>(tile, *p, fs, static_cast<float*>(C) + b * sCb,
                          m0, n0, ct);
    return;
  }
  const bool pair = sCn == 1 && sCm % 2 == 0 && sCb % 2 == 0;
  if (out_bf16)
    ring_store(static_cast<__nv_bfloat16*>(C) + b * sCb, acc, r0, c0, M, N,
               sCm, sCn, pair);
  else
    ring_store(static_cast<float*>(C) + b * sCb, acc, r0, c0, M, N, sCm, sCn,
               pair);
}

// The plain ring: scalar parameters only (handing a plain product the
// ContractParams struct measured up to 2.5x slower).
template <int BN>
__global__ void __launch_bounds__(R_THREADS, 1)
contract_bf16_ring_kernel(const __grid_constant__ CUtensorMap tmA,
                          const __grid_constant__ CUtensorMap tmB, void* C,
                          int M, int N, int K, long long sCb, long long sCm,
                          long long sCn, int layout, int out_bf16, int splits,
                          float* partial, int* counter) {
  ring_body<BN, R_RING_BYTES, FEAT_PLAIN, false>(
      &tmA, &tmB, C, M, N, K, sCb, sCm, sCn, layout, out_bf16, splits,
      partial, counter, nullptr);
}

// The fused modes on the ring: the k-scale prologue, the epilogue (after
// the split sum where K is split) and the row reduce, each where ``p``
// sets it (the k-scale and row-reduce modes at BN = R_FUSED_BN).
template <int BN>
__global__ void __launch_bounds__(R_THREADS, 1)
contract_bf16_ring_fused_kernel(const __grid_constant__ CUtensorMap tmA,
                                const __grid_constant__ CUtensorMap tmB,
                                const __grid_constant__ CUtensorMap tmK,
                                const __grid_constant__ ContractParams p,
                                int layout) {
  ring_body<BN, R_RING_BYTES, FEAT_FUSED, false>(
      &tmA, &tmB, p.C, (int)p.M, (int)p.N, (int)p.K, p.sCb, p.sCm, p.sCn,
      layout, p.out_dtype == 1, (int)p.splits, p.partial, p.counter, &p,
      &tmK);
}

// The narrow body: C^T = B^T A^T on the ring, two CTAs an SM.  Launched
// with the roles swapped (launch_narrow): its "A" is W^T (N rows of K),
// its "B" x^T (K x BN tokens), its "M" the product's N and its "N" the
// product's M, and the strides of C exchanged, so ring_store writes C
// transposed and masked to the M tokens.
template <int BN>
__global__ void __launch_bounds__(R_THREADS, 2)
contract_bf16_narrow_kernel(const __grid_constant__ CUtensorMap tmA,
                            const __grid_constant__ CUtensorMap tmB, void* C,
                            int M, int N, int K, long long sCb, long long sCm,
                            long long sCn, int layout, int out_bf16,
                            int splits, float* partial, int* counter) {
  ring_body<BN, N_RING_BYTES, FEAT_PLAIN, true>(
      &tmA, &tmB, C, M, N, K, sCb, sCm, sCn, layout, out_bf16, splits,
      partial, counter, nullptr);
}

// The two tensor maps of a ring launch and its layout bits: A taken
// K-major where it has unit stride along k, else M-major where it has unit
// stride there; B K-major, else N-major; the other strides what TMA reads
// (hopper::tma_ok).  false: the ring cannot read them.
template <int BN>
bool ring_maps(const ContractParams& p, CUtensorMap* ta, CUtensorMap* tb,
               int* layout) {
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  *layout = 0;
  const hopper::Operand a_k{p.A, p.K, p.M, p.sAm, p.batch, p.sAb};
  const hopper::Operand a_m{p.A, p.M, p.K, p.sAk, p.batch, p.sAb};
  if ((p.sAk == 1 || p.K == 1) && hopper::tma_ok(a_k, 2)) {
    if (!hopper::make_map(ta, a_k, 2, bf16, R_BK, R_BM)) return false;
  } else if (p.sAm == 1 && hopper::tma_ok(a_m, 2)) {
    if (!hopper::make_map(ta, a_m, 2, bf16, 64, R_BK)) return false;
    *layout |= A_MMAJOR;
  } else {
    return false;
  }
  const hopper::Operand b_k{p.B, p.K, p.N, p.sBn, p.batch, p.sBb};
  const hopper::Operand b_n{p.B, p.N, p.K, p.sBk, p.batch, p.sBb};
  if ((p.sBk == 1 || p.K == 1) && hopper::tma_ok(b_k, 2)) {
    if (!hopper::make_map(tb, b_k, 2, bf16, R_BK, BN)) return false;
  } else if ((p.sBn == 1 || p.N == 1) && hopper::tma_ok(b_n, 2)) {
    if (!hopper::make_map(tb, b_n, 2, bf16, 64, R_BK)) return false;
    *layout |= B_NMAJOR;
  } else {
    return false;
  }
  return true;
}

// The K split's checks shared by the ring launches: at least one K step
// for every split, scratch where K is split, a grid within its limits.
bool split_ok(const ContractParams& p, long long tiles) {
  const long long nk = (p.K + R_BK - 1) / R_BK;
  if (p.K < 1 || p.N < 1 || p.batch < 1 || p.splits < 1 || p.splits > nk ||
      (p.splits > 1 && (!p.partial || !p.counter)))
    return false;
  const long long per = (nk + p.splits - 1) / p.splits;
  return (p.splits - 1) * per < nk && tiles < (1LL << 31) &&
         p.batch * p.splits <= 65535;
}

// The ring's launch: checks its preconditions (cudaErrorInvalidValue when
// one fails; nothing switches body), encodes the two tensor maps and
// launches the plain ring, or the fused one where ``p`` sets a mode (the
// k-scale and row-reduce modes at tile width R_FUSED_BN; the row reduce
// with its scratch: a partial row a row tile and split).
template <int BN>
int launch_ring(const ContractParams& p, cudaStream_t stream) {
  using R = Ring<BN>;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const bool fused = features(p) != FEAT_PLAIN;
  const long long tiles = ((p.M + R_BM - 1) / R_BM) * ((p.N + BN - 1) / BN);
  if (p.in_dtype != 1 || p.M < 64 || !split_ok(p, tiles) ||
      ((p.T || p.kscale.p) && BN != R_FUSED_BN) ||
      (p.T && (!p.partial || !p.counter)))
    return invalid;
  CUtensorMap ta, tb;
  int layout = 0;
  if (!ring_maps<BN>(p, &ta, &tb, &layout)) return invalid;
  CUtensorMap tk{};
  if (p.kscale.p) {
    // the k-scale prologue reads K-major A tiles, and its vector by TMA:
    // element k at index k (div 1, len K), 16-byte aligned, zero past K
    const int elem = p.kscale.bf16 ? 2 : 4;
    const hopper::Operand v{p.kscale.p, p.K, 1, 0, 1, 0};
    if ((layout & A_MMAJOR) || p.kscale.div != 1 || p.kscale.len != p.K ||
        !hopper::make_map(&tk, v, elem,
                          p.kscale.bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          R_BK, 1, false))
      return invalid;
  }
  const dim3 grid((unsigned)tiles, 1, (unsigned)(p.batch * p.splits));
  if (fused) {
    constexpr int smem = R::SMEM + (int)sizeof(FusedSmem) + 128;
    static const cudaError_t attr = cudaFuncSetAttribute(
        contract_bf16_ring_fused_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    contract_bf16_ring_fused_kernel<BN>
        <<<grid, R_THREADS, smem, stream>>>(ta, tb, tk, p, layout);
    return static_cast<int>(cudaGetLastError());
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      contract_bf16_ring_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  contract_bf16_ring_kernel<BN><<<grid, R_THREADS, R::SMEM, stream>>>(
      ta, tb, p.C, (int)p.M, (int)p.N, (int)p.K, p.sCb, p.sCm, p.sCn, layout,
      p.out_dtype == 1, (int)p.splits, p.partial, p.counter);
  return static_cast<int>(cudaGetLastError());
}

// The narrow body's launch (1 <= M <= BN, a plain bf16 product): x (the
// product's A) must have unit stride along k, so x^T is the MMA's K-major
// B, boxes of 64 k x BN tokens (rows past M zero-filled); W (the product's
// B) is read K-major (unit stride along k) or N-major (the transposed
// descriptor), 128 of its N a CTA.
template <int BN>
int launch_narrow(const ContractParams& p, cudaStream_t stream) {
  using R = Ring<BN, N_RING_BYTES>;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (p.N + R_BM - 1) / R_BM;
  if (p.in_dtype != 1 || features(p) != FEAT_PLAIN || p.M < 1 ||
      p.M > BN || !split_ok(p, tiles))
    return invalid;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tw, tx;
  int layout = 0;
  const hopper::Operand w_k{p.B, p.K, p.N, p.sBn, p.batch, p.sBb};
  const hopper::Operand w_n{p.B, p.N, p.K, p.sBk, p.batch, p.sBb};
  if ((p.sBk == 1 || p.K == 1) && hopper::tma_ok(w_k, 2)) {
    if (!hopper::make_map(&tw, w_k, 2, bf16, R_BK, R_BM)) return invalid;
  } else if ((p.sBn == 1 || p.N == 1) && hopper::tma_ok(w_n, 2)) {
    if (!hopper::make_map(&tw, w_n, 2, bf16, 64, R_BK)) return invalid;
    layout |= A_MMAJOR;
  } else {
    return invalid;
  }
  const hopper::Operand x_k{p.A, p.K, p.M, p.sAm, p.batch, p.sAb};
  if (!((p.sAk == 1 || p.K == 1) && hopper::tma_ok(x_k, 2)) ||
      !hopper::make_map(&tx, x_k, 2, bf16, R_BK, BN))
    return invalid;
  static const cudaError_t attr = cudaFuncSetAttribute(
      contract_bf16_narrow_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((unsigned)tiles, 1, (unsigned)(p.batch * p.splits));
  contract_bf16_narrow_kernel<BN><<<grid, R_THREADS, R::SMEM, stream>>>(
      tw, tx, p.C, (int)p.N, (int)p.M, (int)p.K, p.sCb, p.sCn, p.sCm, layout,
      p.out_dtype == 1, (int)p.splits, p.partial, p.counter);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tc32 body (body 3): f32 products in 3xTF32 on the tensor cores, with
// the operands' roles swapped, C^T = W^T x^T (see the header of this file).
// ---------------------------------------------------------------------------
constexpr int T_BN = 128;  // the product's N a CTA: wgmma's 128 rows
constexpr int T_BM = 128;  // the widest x tile (the product's M a CTA)
constexpr int T_BK = 32;   // k a stage: one 128-byte swizzled row of f32
constexpr int T_W_BYTES = T_BN * T_BK * 4;  // W's tile
constexpr int T_RING_BYTES = 192 * 1024;    // the stages' bytes, at most
constexpr int T_SPLIT = 96;  // the splitting threads: warps 1-3
static_assert(T_BM == R_BM, "fused_store's 128 rows");

// The ring of one instantiation: x's tile BMX (the product's M) wide --
// wgmma's n, 8 to 128 -- split into hi and lo tiles; XM: x arrives
// m-major in a tile of its own (four boxes of 32 m x 32 k) that the
// splitting threads transpose, else k-major into the hi tile, split in
// place.  A stage: hi, lo, W, then (XM) the m-major tile; as many stages
// as T_RING_BYTES holds (4 at 128 wide, 3 with XM, 6 to 10 narrow).
template <bool XM, int BMX>
struct Tc32 {
  static_assert(!XM || BMX == T_BM, "an m-major x takes the 128-wide tile");
  static constexpr int X_BYTES = BMX * T_BK * 4;
  static constexpr int STAGE = (XM ? 3 : 2) * X_BYTES + T_W_BYTES;
  static constexpr int STAGES = T_RING_BYTES / STAGE;
  static constexpr int ACC = BMX / 2;  // f32 accumulators of a consumer
  // the ring, 1024 bytes to align it, full, ready and empty barriers
  static constexpr int SMEM = STAGES * STAGE + 1024 + 3 * STAGES * 8 + 16;
  static_assert(STAGE % 1024 == 0, "every tile 1024-byte aligned");
};
static_assert(R_BM * ETile<T_BN>::LD * 4 <=
                  Tc32<true, T_BM>::STAGES * Tc32<true, T_BM>::STAGE,
              "the epilogue tile fits the drained ring");

// The stage's k order.  wgmma k8 step q's slot j (j < 4: A's registers a0
// and a1, j >= 4: a2 and a3, at thread t = j % 4) holds
//   k = 2 (j % 4) + (q & 1) + 16 (q >> 1) + 8 (j >= 4)
// of the stage's 32, a permutation of them: a thread's two k of steps 0
// and 1 (and of 2 and 3) are neighbours, and the rows of W it reads hit
// distinct banks in either layout.  The splitting threads write x's hi
// and lo rows in this order, so each product pairs equal k: row m of a
// tile holds 32 k, 128-byte swizzled, output chunk o = 2q + h (k-slots 4h
// .. 4h + 3 of step q) at o ^ m % 8.
//
// One half of a row of the landed k-major x tile (32 f32 along k, 128-byte
// swizzled: chunk c of 4 k at c ^ row % 8) split into hi (in place) and lo,
// each permuted to the k order.  Half u, chunks 4u .. 4u + 3 (k 16u ..
// 16u + 15), holds exactly the k of steps 2u and 2u + 1, so a half is read
// whole and then written over by one thread, and no other thread touches
// it.
__device__ __forceinline__ void tc32_split_half(unsigned char* his,
                                                unsigned char* los, int row,
                                                int u) {
  float4* hi = reinterpret_cast<float4*>(his + row * 128);
  float4* lo = reinterpret_cast<float4*>(los + row * 128);
  const int sw = row & 7;
  float in[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 v = hi[(4 * u + c) ^ sw];
    in[c][0] = v.x;
    in[c][1] = v.y;
    in[c][2] = v.z;
    in[c][3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int o = 4 * u + c, q = c >> 1, h = c & 1;
    uint32_t hb[4], lb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hopper::split_tf32(in[(i >> 1) + 2 * h][2 * (i & 1) + (q & 1)], hb[i],
                         lb[i]);
    hi[o ^ sw] = make_float4(__uint_as_float(hb[0]), __uint_as_float(hb[1]),
                             __uint_as_float(hb[2]), __uint_as_float(hb[3]));
    lo[o ^ sw] = make_float4(__uint_as_float(lb[0]), __uint_as_float(lb[1]),
                             __uint_as_float(lb[2]), __uint_as_float(lb[3]));
  }
}

// One of the 256 tasks of transposing a landed m-major x tile (four boxes
// j of 32 m: row k of 128 bytes, chunk c of 4 m at c ^ k % 8) into the
// stage's hi and lo tiles (rows m, the k order): 4 m (4c .. 4c + 3 of box
// j) by the 4 k of output chunk o.  The four k are read as four float4 of
// 4 m each, transposed in registers, split and written as rows 4c + e's
// chunk o.  Task bits: o (0-2), c's parity p (3), a rotation r (4-5), j
// (6-7); c = 2 ((o % 2 + 2 (o / 4) + r) % 4) + p.  Eight neighbouring
// threads (a 16-byte access's phase) take o = 0..7 with one p: their
// reads (chunk c ^ k % 8, k % 8 = 2i + q % 2) and their writes (chunk o ^
// (4p + e)) each hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ void tc32_split_transpose(const unsigned char* xm,
                                                     unsigned char* his,
                                                     unsigned char* los,
                                                     int task) {
  const int o = task & 7, p = (task >> 3) & 1, r = (task >> 4) & 3;
  const int j = task >> 6;
  const int q = o >> 1, h = o & 1;
  const int c = 2 * (((o & 1) + 2 * (o >> 2) + r) & 3) + p;
  const unsigned char* box = xm + j * 4096;
  float in[4][4];  // [slot i of the chunk][m 4c + e]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 2 * i + (q & 1) + 16 * (q >> 1) + 8 * h;
    const float4 v = *reinterpret_cast<const float4*>(
        box + k * 128 + ((c ^ (k & 7)) << 4));
    in[i][0] = v.x;
    in[i][1] = v.y;
    in[i][2] = v.z;
    in[i][3] = v.w;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = 32 * j + 4 * c + e;
    uint32_t hb[4], lb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) hopper::split_tf32(in[i][e], hb[i], lb[i]);
    const int at = m * 128 + ((o ^ (m & 7)) << 4);
    *reinterpret_cast<float4*>(his + at) =
        make_float4(__uint_as_float(hb[0]), __uint_as_float(hb[1]),
                    __uint_as_float(hb[2]), __uint_as_float(hb[3]));
    *reinterpret_cast<float4*>(los + at) =
        make_float4(__uint_as_float(lb[0]), __uint_as_float(lb[1]),
                    __uint_as_float(lb[2]), __uint_as_float(lb[3]));
  }
}

// A consumer thread's register-A fragments of W^T for the stage's four k8
// steps, split: ah / al[q] the hi / lo parts of (row g: local n ``nl``, k
// slot t), (row g + 8: nl + 1, slot t), (nl, slot t + 4), (nl + 1, slot
// t + 4) in the stage's k order.  The wgmma's rows are the product's n
// permuted, row g of a warp's 16 holding n 2g and row g + 8 n 2g + 1, so a
// thread's two n are neighbours.  WK: W's tile is K-major (rows of 128 n,
// 32 k each, one box; matmul.dA's W^T), else N-major (four boxes of 32 n,
// rows of 32 k).  Each read is 8 bytes, and a half warp's reads hit 32
// distinct banks in either layout.
template <bool WK>
__device__ __forceinline__ void tc32_fragments(const unsigned char* ws,
                                               int nl, int t,
                                               uint32_t (&ah)[4][4],
                                               uint32_t (&al)[4][4]) {
  float a[4][4];
  if (WK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = nl + h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // k 2t + 8j and its neighbour: steps 2 (j >> 1) and 2 (j >> 1) + 1
        const int k = 2 * t + 8 * j;
        const float2 v = *reinterpret_cast<const float2*>(
            ws + r * 128 + ((((k >> 2) ^ (r & 7))) << 4) + (k & 3) * 4);
        a[2 * (j >> 1)][h + 2 * (j & 1)] = v.x;
        a[2 * (j >> 1) + 1][h + 2 * (j & 1)] = v.y;
      }
    }
  } else {
    const unsigned char* box = ws + (nl >> 5) * 4096;
    const int nb = nl & 31;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * t + (q & 1) + 16 * (q >> 1) + 8 * h;
        const float2 v = *reinterpret_cast<const float2*>(
            box + k * 128 + (((nb >> 2) ^ (k & 7)) << 4) + (nb & 3) * 4);
        a[q][2 * h] = v.x;
        a[q][2 * h + 1] = v.y;
      }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) hopper::split_tf32(a[q][r], ah[q][r], al[q][r]);
}

// The body of the tc32 kernels.  Grid (CTAs, 1, batch x splits) over the
// (N / 128) x (M / BMX) tiles in bands of R_BAND row tiles (rows: the
// product's N): a CTA takes tiles blockIdx.x, + gridDim.x, ... in turn,
// its ring and barriers running on from one tile to the next, so the next
// tile's loads are in flight while a tile is stored (a plain product
// unsplit: one CTA an SM; otherwise one tile a CTA).  The K steps of each
// split run across ``splits`` CTAs as the ring's (the last CTA of a tile
// sums the partial tiles in split order).
// Warpgroup 0: thread 0 keeps TMA loads of x (tmX: k-major (K, M, batch),
// boxes of 32 k x BMX m; XM: m-major (M, K, batch), four boxes of 32 m x
// 32 k) and W (tmW: N-major (N, K, batch), four boxes of 32 n x 32 k; WK:
// K-major (K, N, batch), one box of 32 k x 128 n) in flight; warps 1-3
// split each landed x tile (tc32_split_half in place, or XM
// tc32_split_transpose from the m-major tile), fence it for the async
// proxy and arrive on the stage's ready barrier.  Warpgroups 1 and 2 take
// 64 of the tile's n each: W^T's fragments by 8-byte shared loads, split
// in registers, and x^T's hi and lo tiles from shared memory, three
// m64nBMXk8 wgmmas a k8 step (lo.hi, hi.lo, then hi.hi), a stage's twelve
// summed from zero and added to the accumulator in f32.  A warpgroup
// waits for its own group before it writes the next fragments (C7513
// otherwise, as ring_mainloop_ks); the other one's keeps the tensor cores
// busy.  FEAT_FUSED (BMX 128 only) applies ``p``'s epilogue and multiplier
// through the staged tile (fused_store), else the fragments are stored as
// they are, two neighbouring n of one row a word where C allows.
template <int FEAT, bool WK, bool XM, int BMX>
__device__ __forceinline__ void tc32_body(const CUtensorMap* tmX,
                                          const CUtensorMap* tmW, void* C,
                                          int M, int N, int K, long long sCb,
                                          long long sCm, long long sCn,
                                          int out_bf16, int splits,
                                          float* partial, int* counter,
                                          const ContractParams* p) {
  using TG = Tc32<XM, BMX>;
  static_assert(FEAT == FEAT_PLAIN || BMX == T_BM, "fused_store's 128 rows");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* tiles =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + TG::STAGES * TG::STAGE);
  uint64_t* ready = full + TG::STAGES;
  uint64_t* empty = ready + TG::STAGES;
  int* last = reinterpret_cast<int*>(empty + TG::STAGES);
  FusedSmem* fs = reinterpret_cast<FusedSmem*>(
      (reinterpret_cast<uintptr_t>(last + 4) + 127) & ~uintptr_t(127));

  const int gx = (M + BMX - 1) / BMX;
  const int gy = (N + T_BN - 1) / T_BN;
  const int ntiles = gx * gy;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int nk = (K + T_BK - 1) / T_BK;
  const int per = (nk + splits - 1) / splits;
  const int k_first = split * per;
  const int steps = min(nk, k_first + per) - k_first;  // >= 1 (the host's)
  if (threadIdx.x == 0) {
    for (int s = 0; s < TG::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&ready[s], T_SPLIT);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer group
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {  // the producer
      hopper::tma_prefetch(tmX);
      hopper::tma_prefetch(tmW);
      int it = 0;  // the ring's step count, over this CTA's tiles
      for (int job = blockIdx.x; job < ntiles; job += gridDim.x) {
        int r_t, c_t;
        hopper::raster(job, gx, gy, R_BAND, r_t, c_t);
        const int n0 = r_t * T_BN;
        const int m0 = c_t * BMX;
        for (int i = 0; i < steps; ++i, ++it) {
          const int s = it % TG::STAGES;
          hopper::mbar_wait(&empty[s], ((it / TG::STAGES) & 1) ^ 1);
          hopper::mbar_arrive_tx(&full[s], TG::X_BYTES + T_W_BYTES);
          unsigned char* xs = tiles + s * TG::STAGE;
          unsigned char* ws = xs + 2 * TG::X_BYTES;
          const int k0 = (k_first + i) * T_BK;
          if (XM) {
#pragma unroll
            for (int j = 0; j < BMX / 32; ++j)
              hopper::tma_load(ws + T_W_BYTES + j * 4096, tmX, &full[s],
                               m0 + 32 * j, k0, b);
          } else {
            hopper::tma_load(xs, tmX, &full[s], k0, m0, b);
          }
          if (WK) {
            hopper::tma_load(ws, tmW, &full[s], k0, n0, b);
          } else {
#pragma unroll
            for (int j = 0; j < T_BN / 32; ++j)
              hopper::tma_load(ws + j * 4096, tmW, &full[s], n0 + 32 * j,
                               k0, b);
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // the splitters
      const int st = threadIdx.x - 32;
      const int total =
          steps * ((ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x);
      for (int it = 0; it < total; ++it) {
        const int s = it % TG::STAGES;
        unsigned char* xs = tiles + s * TG::STAGE;
        hopper::mbar_wait(&full[s], (it / TG::STAGES) & 1);
        if (XM) {
          // 256 tasks over 96 threads: 3, 3 and 2 a thread by warp
          for (int task = st; task < 256; task += T_SPLIT)
            tc32_split_transpose(xs + 2 * TG::X_BYTES + T_W_BYTES, xs,
                                 xs + TG::X_BYTES, task);
        } else {
          // 2 BMX half rows over 96 threads
          for (int task = st; task < 2 * BMX; task += T_SPLIT)
            tc32_split_half(xs, xs + TG::X_BYTES, task >> 1, task & 1);
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  hopper::regs_inc<232>();
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int half = ct >> 7;
  const int lane = ct & 31;
  const int t = lane & 3;
  // the thread's two neighbouring n of the tile (wgmma rows g and g + 8)
  const int nl = 64 * half + 16 * ((ct >> 5) & 3) + 2 * (lane >> 2);
  const uint32_t base = hopper::smem_u32(tiles);
  int it = 0;
  for (int job = blockIdx.x; job < ntiles; job += gridDim.x) {
    int r_t, c_t;
    hopper::raster(job, gx, gy, R_BAND, r_t, c_t);
    const int n0 = r_t * T_BN;
    const int m0 = c_t * BMX;
    // acc: the sum over the stages, each stage's 12 wgmmas summed in part
    // (its first from zero) and added to acc in f32 (the tensor cores' own
    // accumulation rounds toward zero, so a running sum over all of K would
    // drift with K)
    float acc[TG::ACC], part[TG::ACC];
#pragma unroll
    for (int i = 0; i < TG::ACC; ++i) acc[i] = part[i] = 0.f;
    if constexpr (FEAT == FEAT_FUSED)
      stage_vectors<T_BN>(fs, *p, b, m0, n0, ct);
    for (int i = 0; i < steps; ++i, ++it) {
      const int s = it % TG::STAGES;
      const uint32_t parity = (it / TG::STAGES) & 1;
      hopper::mbar_wait(&full[s], parity);
      hopper::mbar_wait(&ready[s], parity);
      uint32_t ah[4][4], al[4][4];
      tc32_fragments<WK>(tiles + s * TG::STAGE + 2 * TG::X_BYTES, nl, t, ah,
                         al);
      const uint32_t xh = base + s * TG::STAGE;
      const uint32_t xl = xh + TG::X_BYTES;
      hopper::fence_regs(part);
      hopper::wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hopper::wgmma_tf32_rs(part, al[q],
                              hopper::desc(xh + q * 32, 16, 1024), q > 0);
        hopper::wgmma_tf32_rs(part, ah[q],
                              hopper::desc(xl + q * 32, 16, 1024));
        hopper::wgmma_tf32_rs(part, ah[q],
                              hopper::desc(xh + q * 32, 16, 1024));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hopper::fence_regs(ah[q]);
        hopper::fence_regs(al[q]);
      }
      if (ct % 128 == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < TG::ACC; ++j) acc[j] += part[j];
    }

    if (splits > 1) {
      // as the ring's (a split launch takes one tile a CTA): this split's
      // partial tile to scratch ([tile][split][i][thread]), then the last
      // CTA of the tile to arrive sums every split in split order and sets
      // the tile's counter back to 0 for the next launch
      const long long tile = ((long long)b * gy + r_t) * gx + c_t;
      float* mine = partial + (tile * splits + split) * (BMX * T_BN);
#pragma unroll
      for (int i = 0; i < TG::ACC; ++i)
        __stcg(mine + i * R_CONSUMERS + ct, acc[i]);
      __threadfence();
      hopper::bar_sync(1, R_CONSUMERS);
      if (ct == 0) *last = atomicAdd(counter + tile, 1) == splits - 1;
      hopper::bar_sync(1, R_CONSUMERS);
      if (!*last) return;
      __threadfence();
      if (ct == 0) counter[tile] = 0;
      const float* all = partial + tile * splits * (BMX * T_BN);
#pragma unroll
      for (int i = 0; i < TG::ACC; ++i) acc[i] = 0.f;
      for (int sp = 0; sp < splits; ++sp)
#pragma unroll
        for (int i = 0; i < TG::ACC; ++i)
          acc[i] += __ldcg(all + sp * (BMX * T_BN) + i * R_CONSUMERS + ct);
    }

    // accumulator d[4j + 2h + e]: wgmma row g + 8h (n0 + nl + h), column
    // 8j + 2t + e (m0 + 8j + 2t + e)
    if constexpr (FEAT == FEAT_FUSED) {
      // both warpgroups are past their last wgmma, every stage consumed:
      // the ring is free for the f32 tile, rows m, columns n
      hopper::bar_sync(1, R_CONSUMERS);
      float* tile = reinterpret_cast<float*>(tiles);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(tile + (8 * j + 2 * t + e) *
                                                ETile<T_BN>::LD + nl) =
              make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
      hopper::bar_sync(1, R_CONSUMERS);
      if (out_bf16)
        fused_store_act<T_BN>(tile, *p, fs,
                              static_cast<__nv_bfloat16*>(C) + b * sCb, m0,
                              n0, ct);
      else
        fused_store_act<T_BN>(tile, *p, fs, static_cast<float*>(C) + b * sCb,
                              m0, n0, ct);
      return;
    }
    const bool pair = sCn == 1 && sCm % 2 == 0 && sCb % 2 == 0;
    const int n = n0 + nl;
#pragma unroll
    for (int j = 0; j < BMX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m >= M) continue;
        const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
        const long long at = b * sCb + m * sCm;
        if (out_bf16) {
          __nv_bfloat16* row = static_cast<__nv_bfloat16*>(C) + at;
          if (pair && n + 1 < N) {
            store2_from_f32(row + n, v0, v1);
          } else {
            if (n < N) store_from_f32(row + n * sCn, v0);
            if (n + 1 < N) store_from_f32(row + (n + 1) * sCn, v1);
          }
        } else {
          float* row = static_cast<float*>(C) + at;
          if (pair && n + 1 < N) {
            store2_from_f32(row + n, v0, v1);
          } else {
            if (n < N) store_from_f32(row + n * sCn, v0);
            if (n + 1 < N) store_from_f32(row + (n + 1) * sCn, v1);
          }
        }
      }
  }
}

// The plain product in 3xTF32: scalar parameters only, as the plain ring.
template <bool WK, bool XM, int BMX>
__global__ void __launch_bounds__(R_THREADS, 1)
contract_f32_tc_kernel(const __grid_constant__ CUtensorMap tmX,
                       const __grid_constant__ CUtensorMap tmW, void* C, int M,
                       int N, int K, long long sCb, long long sCm,
                       long long sCn, int out_bf16, int splits,
                       float* partial, int* counter) {
  tc32_body<FEAT_PLAIN, WK, XM, BMX>(&tmX, &tmW, C, M, N, K, sCb, sCm, sCn,
                                     out_bf16, splits, partial, counter,
                                     nullptr);
}

// The epilogue and the multiplier vector in 3xTF32 (the 128-wide tile).
template <bool WK, bool XM>
__global__ void __launch_bounds__(R_THREADS, 1)
contract_f32_tc_fused_kernel(const __grid_constant__ CUtensorMap tmX,
                             const __grid_constant__ CUtensorMap tmW,
                             const __grid_constant__ ContractParams p) {
  tc32_body<FEAT_FUSED, WK, XM, T_BM>(
      &tmX, &tmW, p.C, (int)p.M, (int)p.N, (int)p.K, p.sCb, p.sCm, p.sCn,
      p.out_dtype == 1, (int)p.splits, p.partial, p.counter, &p);
}

template <bool WK, bool XM, int BMX>
int launch_tc32_maps(const ContractParams& p, const CUtensorMap& tx,
                     const CUtensorMap& tw, cudaStream_t stream) {
  using TG = Tc32<XM, BMX>;
  const long long tiles = ((p.M + BMX - 1) / BMX) * ((p.N + T_BN - 1) / T_BN);
  // a plain unsplit product: one CTA an SM, each walking its tiles in
  // turn; otherwise one tile a CTA (the fused store stages its tile in the
  // drained ring, and a split's last CTA sums the tile)
  long long ctas = tiles;
  if (features(p) == FEAT_PLAIN && p.splits == 1) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (sms < ctas) ctas = sms;
  }
  const dim3 grid((unsigned)ctas, 1, (unsigned)(p.batch * p.splits));
  if (features(p) != FEAT_PLAIN) {
    if constexpr (BMX == T_BM) {
      constexpr int smem = TG::SMEM + (int)sizeof(FusedSmem) + 128;
      static const cudaError_t attr = cudaFuncSetAttribute(
          contract_f32_tc_fused_kernel<WK, XM>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      contract_f32_tc_fused_kernel<WK, XM>
          <<<grid, R_THREADS, smem, stream>>>(tx, tw, p);
      return static_cast<int>(cudaGetLastError());
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      contract_f32_tc_kernel<WK, XM, BMX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, TG::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  contract_f32_tc_kernel<WK, XM, BMX><<<grid, R_THREADS, TG::SMEM, stream>>>(
      tx, tw, p.C, (int)p.M, (int)p.N, (int)p.K, p.sCb, p.sCm, p.sCn,
      p.out_dtype == 1, (int)p.splits, p.partial, p.counter);
  return static_cast<int>(cudaGetLastError());
}

// W's tensor map, N-major where W has unit stride along n, else K-major
// where it has unit stride along k, and the launch of that layout.
template <bool XM, int BMX>
int launch_tc32_w(const ContractParams& p, const CUtensorMap& tx,
                  cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tw;
  const hopper::Operand w_n{p.B, p.N, p.K, p.sBk, p.batch, p.sBb};
  const hopper::Operand w_k{p.B, p.K, p.N, p.sBn, p.batch, p.sBb};
  if ((p.sBn == 1 || p.N == 1) && hopper::tma_ok(w_n, 4)) {
    if (!hopper::make_map(&tw, w_n, 4, f32, 32, T_BK)) return invalid;
    return launch_tc32_maps<false, XM, BMX>(p, tx, tw, stream);
  }
  if ((p.sBk == 1 || p.K == 1) && hopper::tma_ok(w_k, 4)) {
    if (!hopper::make_map(&tw, w_k, 4, f32, T_BK, T_BN)) return invalid;
    return launch_tc32_maps<true, XM, BMX>(p, tx, tw, stream);
  }
  return invalid;
}

// The tc32 body's launch: f32 operands, no k-scale and no row reduce, x
// (the product's A) with unit stride along k (k-major) or, where it has
// none, along m (m-major: matmul.dB's x^T), and W (B) with unit stride
// along n (N-major) or k (K-major), as TMA reads them (hopper::tma_ok:
// 16-byte aligned bases, other strides multiples of 16 bytes); x's tile
// ``tile_n`` wide: 128, or 8, 16, 32 or 64 for a plain product whose x is
// k-major (decode's M < 64); a K split that leaves every CTA a step, with
// its scratch; grid limits.  cudaErrorInvalidValue for anything else:
// nothing switches body (codegen.cuda_gen.contract_body and tc32_tiles
// state the same rule).
int launch_tc32(const ContractParams& p, cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const int w = p.tile_n;
  if (w != 8 && w != 16 && w != 32 && w != 64 && w != T_BM) return invalid;
  const long long tiles = ((p.M + w - 1) / w) * ((p.N + T_BN - 1) / T_BN);
  const long long nk = (p.K + T_BK - 1) / T_BK;
  if (p.in_dtype != 0 || p.T || p.kscale.p || p.M < 1 || p.N < 1 ||
      p.K < 1 || p.batch < 1 || tiles >= (1LL << 31) || p.splits < 1 ||
      p.splits > nk || p.batch * p.splits > 65535 ||
      (p.splits > 1 && (!p.partial || !p.counter)) ||
      (w != T_BM && features(p) != FEAT_PLAIN))
    return invalid;
  const long long per = (nk + p.splits - 1) / p.splits;
  if ((p.splits - 1) * per >= nk) return invalid;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tx;
  const hopper::Operand x_k{p.A, p.K, p.M, p.sAm, p.batch, p.sAb};
  const hopper::Operand x_m{p.A, p.M, p.K, p.sAk, p.batch, p.sAb};
  if ((p.sAk == 1 || p.K == 1) && hopper::tma_ok(x_k, 4)) {
    if (!hopper::make_map(&tx, x_k, 4, f32, T_BK, w)) return invalid;
    switch (w) {
      case 8:
        return launch_tc32_w<false, 8>(p, tx, stream);
      case 16:
        return launch_tc32_w<false, 16>(p, tx, stream);
      case 32:
        return launch_tc32_w<false, 32>(p, tx, stream);
      case 64:
        return launch_tc32_w<false, 64>(p, tx, stream);
      default:
        return launch_tc32_w<false, T_BM>(p, tx, stream);
    }
  }
  if (w == T_BM && (p.sAm == 1 || p.M == 1) && hopper::tma_ok(x_m, 4)) {
    if (!hopper::make_map(&tx, x_m, 4, f32, 32, T_BK)) return invalid;
    return launch_tc32_w<true, T_BM>(p, tx, stream);
  }
  return invalid;
}

}  // namespace

extern "C" {

// Strides are in elements.  The row-reduce mode (T set) needs batch 1, a
// (row blocks, N) f32 partial buffer and one zeroed int per column block
// (the row and column block counts of the chosen body: contract_tile_* for
// bodies 0, 128 x contract_ring_fused_tile_n() on the ring, whose row
// blocks are the row tiles x splits).  body 1 runs
// the ring (tile_n, splits; with splits > 1 a partial buffer of batch x
// row tiles x column tiles x splits x 128 x tile_n floats and one zeroed
// int per output tile, (batch, row tile, column tile) order; the fused
// modes at tile_n 128), body 2 the narrow body (tile_n 8, 16, 32 or 64 >=
// M; with splits > 1 batch x (N / 128) x splits x 128 x tile_n floats and
// one zeroed int per 128 columns of N), body 3 the tc32 body (f32
// operands, no k-scale, no row reduce; tile_n x's tile width along M: 128,
// or 8, 16, 32 or 64 for a plain product with x k-major; with splits > 1
// a partial buffer of batch x (M / tile_n) x (N / 128) x splits x 128 x
// tile_n floats and one zeroed int per output tile), or refuses.  Body 0
// runs mma.sync for bf16 and the FMA pipes for f32.  Every counter is 0
// again when the launch ends, so the caller zeroes a counter buffer once
// and reuses it.  Returns cudaGetLastError() after the launch (0 =
// launched); nothing is synchronised, and nothing is allocated here.
int contract_launch(const ContractParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->in_dtype < 0 || p->in_dtype > 1 || p->out_dtype < 0 ||
      p->out_dtype > 1 || (p->T && p->batch != 1) ||
      (p->mean.p == nullptr) != (p->var.p == nullptr) || p->act < 0 ||
      p->act > 4 || p->body < 0 || p->body > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->body == 3) return launch_tc32(*p, s);
  if (p->body == 1) {
    if (p->tile_n == 128) return launch_ring<128>(*p, s);
    if (p->tile_n == 256) return launch_ring<256>(*p, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p->body == 2) {
    switch (p->tile_n) {
      case 8:
        return launch_narrow<8>(*p, s);
      case 16:
        return launch_narrow<16>(*p, s);
      case 32:
        return launch_narrow<32>(*p, s);
      case 64:
        return launch_narrow<64>(*p, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
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

// The ring's CTA rows (the narrow body's columns of N a CTA), checked
// against cuda_gen.RING_BM at load: the wrapper sizes the split scratch
// and counters with it.
int contract_ring_tile_m(void) { return R_BM; }

// The fused ring's tile width, checked against cuda_gen.RING_FUSED_BN at
// load: the wrapper sizes the ring's row-reduce scratch with it.
int contract_ring_fused_tile_n(void) { return R_FUSED_BN; }

// sizeof(ContractParams), checked against the ctypes mirror at load.
int contract_params_size(void) { return (int)sizeof(ContractParams); }

}  // extern "C"
