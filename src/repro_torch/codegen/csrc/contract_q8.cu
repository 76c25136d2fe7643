// B1's 8-bit modes for Hopper: the int8 and fp8 (e4m3) contraction
// C[b,m,n] = sum_k A[b,m,k] * B[b,k,n] on the tensor cores (with the
// weighted family's multiplier, row reduce and int8 byte planes on the
// ring), and the upcast body that runs what the tensor cores cannot take
// (mixed or int32 operands, M < 64) on the CUDA cores.
//
// Replaces the reference's generated Pallas contraction kernel for
// quantized specs (src/repro/codegen/pallas_gen.py: CompiledKernel._build
// -> _make_kernel, pl.pallas_call at :263).  There an int8 spec upcasts
// its 1-byte operand blocks and accumulates exactly in an int32 VMEM
// scratch (:158-163, :219-226); an fp8 spec accumulates in f32.  The
// Python side (codegen/cuda_gen.py) folds the spec onto (batch, m, k, n)
// as for the bf16/f32 kernel (contract.cu) and passes element strides.
//
// q8_mma_kernel<INT> (two 8-bit operands of one type):
//   * int8: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, int32
//     accumulators, exact (the same bits as the reference's int32 sums,
//     which wrap modulo 2^32 like these);
//   * fp8 e4m3: mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32.  The
//     tensor cores keep fewer bits than f32 when they add into a running
//     accumulator, so every k32 step's mma starts from zero and its four
//     partial sums are added into f32 registers on the CUDA cores: the
//     accumulation over K is the reference's f32 accumulation.
//   A 64 x 128 CTA tile over 4 warps of 32 x 64, K in steps of 64 bytes.
//   The 8-bit B fragment holds 4 consecutive k per register, which
//   ldmatrix.trans (a b16 instruction) cannot build from an n-major tile,
//   so shared memory holds both tiles k-major: As[m][k] and Bs[n][k], rows
//   padded to 80 bytes (the 8 row groups x 4 lanes of a fragment load hit
//   32 distinct banks).  Global loads are 16 bytes where the strides allow:
//   A k-contiguous; B k-contiguous (``ops.dense(quant=)`` writes its
//   quantized W that way, quantize_channels_kmajor) or n-contiguous (16
//   bytes read along n, scattered into the k-major tile); else element by
//   element.
// upcast_kernel<INT>: the contraction on the CUDA cores over operands of
//   any type the codes name (int8, fp8, int32, f32, bf16), each upcast to
//   the accumulator type as it is staged, as the reference upcasts before
//   its dot (pallas_gen.py:160-163): int32 IMAD for int8 specs, f32 FMA for
//   fp8.  It runs the 3-operand modes of contract.cu on such operands: a
//   per-k scale of the A tile, a multiplier of the accumulator and the
//   deterministic row reduce.  A 128 x 64 tile, 8 x 4 outputs per thread,
//   as contract.cu's f32 body.  It is correct and off the main paths: the
//   8-bit weighted family takes the ring where every operand is 8-bit of
//   one format (codegen.cuda_gen.eight_bit_route); what is left here is a
//   mixed or int32 operand (a one-sided reduce's int32 sum, an int32 g),
//   M < 64 and layouts TMA cannot read even after a K-major copy.
// Both end in the same epilogue on the accumulator converted to f32, in
// the reference's order: dequant (qscale), scale, bias, (y - mean) *
// rsqrt(var + eps), activation.  With no epilogue the accumulator is
// stored as it is: an int8 spec's int32 result is exact.
//
// q8_ring_kernel<INT, PLANES> (body 1): the same product on hopper.cuh's
//   skeleton, for K-major operands at M >= 64 (codegen.modes.q8_body picks
//   it; the launch refuses anything else): A k-contiguous and B
//   k-contiguous as ``ops.dense(quant=)`` writes its W
//   (quantize_channels_kmajor), row strides multiples of 16 bytes, 16-byte
//   aligned bases.  8-bit wgmma takes only K-major operands, so the
//   n-major B (the ragged case), the transposed fold (A stored (K, M)) and
//   unaligned operands run q8_mma_kernel.  A CTA of three warpgroups owns
//   a 128 x 128 tile; one producer thread keeps TMA loads of 128 k-bytes a
//   stage (four k32 steps, 128-byte swizzled boxes) in flight on a
//   six-stage ring of 192 KB with full and empty mbarriers; two consumer
//   warpgroups run wgmma m64n128k32 on 64 rows each.  Its plan (the
//   search's, codegen.modes.Q8Plan) is the grid: one CTA a tile
//   (q8_ring_kernel), or a persistent grid of fewer CTAs each walking its
//   tiles (q8_ring_persistent_kernel, q8_plan_launch).
//   * int8: .s32.s8.s8 into int32 accumulators, one group in flight across
//     K steps; no .satfinite, so it wraps modulo 2^32 like the reference
//     and stays exact.
//   * fp8: .f32.e4m3.e4m3.  The tensor cores keep fewer bits than f32 when
//     they add into a running accumulator, so, as in q8_mma_kernel, every
//     k32 wgmma starts from zero and its partial sums are promoted into
//     the f32 accumulator on the CUDA cores: the accumulation over K stays
//     the reference's f32 one.  Two partial accumulators alternate, so one
//     wgmma is in flight while the other partial is added (interval k32:
//     the numerics of q8_mma_kernel, measured at 2.6e-7 / 4.1e-7 scaled at
//     the MLP shapes; a longer interval would trade them for FADDs).
//   Three modes of the weighted family (weighted_matmul and its .dA, .dB,
//   .dg over 8-bit operands and an 8-bit g or T):
//   * a multiplier of the accumulator (``mul``, g on an output group:
//     .dA, .dB), in the accumulator's type after the sums; exact modulo
//     2^32 for int8, since (sum a b) g == sum (a b g) there;
//   * the deterministic row reduce (``T``: .dg), contract.cu's ring
//     row reduce in the accumulator's type: column sums of acc * T per
//     CTA into a (row blocks, N) buffer, summed in row-block order by the
//     last CTA of each column block;
//   * int8 byte planes (PLANES 2: weighted_matmul's k-scale).  a * g no
//     longer fits 8 bits, but x = a g lies in [-16256, 16384], so h = (x +
//     128) >> 8 in [-63, 64] and l = x - 256 h in [-128, 127] are both s8
//     and C = 256 H.B + L.B exactly modulo 2^32 (the wrapper writes H and
//     L, codegen.modes.int8_planes).  The ring walks K twice over the same
//     B, H's walk then L's, with acc *= 256 between them after a
//     wait_group 0: no second accumulator (the consumers' registers stay
//     at 64 int32 sums), no wgmma under a branch, and B's second read
//     comes from L2.  (The fp8 k-scale runs on contract.cu's bf16 k-scale
//     ring instead: an e4m3 x e4m3 product has at most 8 significant bits,
//     so a g and the upcast B are exact in bf16.)
//
// What bounds it on the H100: at qwen3-8b's MLP shapes (M = 2048, D =
// 4096, F = 12288) an 8-bit product is 206 GOP on about 160 MB (1-byte
// operands, f32 output), bound by the 1979 TOPS int8/fp8 tensor-core rate
// (0.104 ms) over the bytes (0.048 ms).  q8_mma_kernel is simple and
// right: loads and math alternate, no pipeline, no wgmma, and its fp8
// promotion costs four FADDs per mma.sync; the ring body keeps loads in
// flight and the tensor cores on wgmma, and its fp8 promotion is one FADD
// per accumulator per k32 step.  Its tile's epilogue is not overlapped
// with the next tile's loads (one CTA a tile), so it stores a thread's two
// neighbouring outputs as one word: whole 32-byte sectors a row and half
// the store instructions, which matters most where the output is large
// against the work (weighted_matmul.dB writes 201 MB of int32).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

extern "C" {

// One vector operand: element (coord / div) % len of p, where coord is the
// folded batch (axis 0), m (1), n (2) or k (3) coordinate.  kscale and mul
// hold the accumulator type (int32 for int accumulation, else f32); the
// epilogue vectors are f32.  p == nullptr means the stage is off.
struct Vec {
  const void* p;
  long long div;
  long long len;
  int axis;
  int pad;
};

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn, 4 int32.
struct Q8Params {
  const void* A;
  const void* B;
  void* C;
  const void* T;  // row reduce: third operand T[m, n]
  long long batch, M, N, K;
  long long sAb, sAm, sAk, sBb, sBk, sBn, sCb, sCm, sCn, sTm, sTn;
  Vec kscale;                  // prologue: A[b, m, k] *= kscale[k]
  Vec mul;                     // the accumulator times a vector
  Vec qscale, scale, bias, mean, var;  // the epilogue
  void* partial;               // row reduce: (row blocks, N) accumulators
  int* counter;                // row reduce: one zeroed int per column block
  float eps;
  int act;                     // 0 id, 1 relu, 2 gelu (tanh), 3 tanh, 4 silu
  int a_dtype, b_dtype, t_dtype, out_dtype;
  int acc_int;                 // 1: int32 accumulation, 0: f32
  int body;                    // q8_launch: 0 q8_mma_kernel, 1 the ring
  int planes;                  // the ring: 1, or 2 int8 planes of A (H, L)
};

}  // extern "C"

namespace {

constexpr int QBM = 64;
constexpr int QBN = 128;
constexpr int QBK = 64;  // bytes of k per stage: two m16n8k32 steps
constexpr int QTHREADS = 128;
constexpr int QLD = QBK + 16;  // padded row: 80 bytes = 20 banks

constexpr int UBM = 128;
constexpr int UBN = 64;
constexpr int UBK = 32;
constexpr int UTHREADS = 256;
constexpr int UTM = 8;
constexpr int UTN = 4;

template <bool INT>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<true> {
  using type = int;
};

__device__ __forceinline__ float fp8_to_f32(uint8_t v) {
  __nv_fp8_e4m3 x;
  x.__x = v;
  return static_cast<float>(x);
}

__device__ __forceinline__ float load_f32(const void* p, long long i,
                                          int code) {
  switch (code) {
    case 0:
      return static_cast<const float*>(p)[i];
    case 1:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case 2:
      return static_cast<float>(static_cast<const int8_t*>(p)[i]);
    case 3:
      return fp8_to_f32(static_cast<const uint8_t*>(p)[i]);
    default:
      return static_cast<float>(static_cast<const int*>(p)[i]);
  }
}

// int accumulation takes int8 or int32 operands (the Python side checks)
__device__ __forceinline__ int load_i32(const void* p, long long i,
                                        int code) {
  return code == 2 ? static_cast<int>(static_cast<const int8_t*>(p)[i])
                   : static_cast<const int*>(p)[i];
}

template <typename TAcc>
__device__ __forceinline__ TAcc load_as(const void* p, long long i, int code);
template <>
__device__ __forceinline__ float load_as<float>(const void* p, long long i,
                                                int code) {
  return load_f32(p, i, code);
}
template <>
__device__ __forceinline__ int load_as<int>(const void* p, long long i,
                                            int code) {
  return load_i32(p, i, code);
}

__device__ __noinline__ long long vec_index_slow(long long c, long long div,
                                                 long long len) {
  return (c / div) % len;
}

__device__ __forceinline__ long long vec_index(const Vec& v, long long b,
                                               long long m, long long n,
                                               long long k) {
  const long long c = v.axis == 0 ? b : v.axis == 1 ? m : v.axis == 2 ? n : k;
  return v.div == 1 && c < v.len ? c : vec_index_slow(c, v.div, v.len);
}

template <typename T>
__device__ __forceinline__ T vec_at(const Vec& v, long long b, long long m,
                                    long long n, long long k) {
  return static_cast<const T*>(v.p)[vec_index(v, b, m, n, k)];
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
    case 4:
      return z / (1.f + expf(-z));
    default:
      return z;
  }
}

__device__ __forceinline__ bool has_epilogue(const Q8Params& p) {
  return p.qscale.p || p.scale.p || p.bias.p || p.mean.p || p.act;
}

__device__ __forceinline__ float epilogue(const Q8Params& p, long long b,
                                          long long m, long long n, float y) {
  if (p.qscale.p) y *= vec_at<float>(p.qscale, b, m, n, 0);
  if (p.scale.p) y *= vec_at<float>(p.scale, b, m, n, 0);
  if (p.bias.p) y += vec_at<float>(p.bias, b, m, n, 0);
  if (p.mean.p)
    y = (y - vec_at<float>(p.mean, b, m, n, 0)) *
        rsqrtf(vec_at<float>(p.var, b, m, n, 0) + p.eps);
  return activate(p.act, y);
}

// Store one element: with no epilogue the accumulator itself (an int32
// accumulator into an int32 output is exact), else the f32 epilogue of it,
// converted as the reference's astype does (round to nearest even for
// bf16, toward zero for int32).
template <typename TAcc>
__device__ __forceinline__ void store_out(const Q8Params& p, bool epi,
                                          long long off, long long b,
                                          long long m, long long n, TAcc acc) {
  if (!epi) {
    if (p.out_dtype == 4) {
      static_cast<int*>(p.C)[off] = static_cast<int>(acc);
      return;
    }
    const float y = static_cast<float>(acc);
    if (p.out_dtype == 1)
      static_cast<__nv_bfloat16*>(p.C)[off] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(p.C)[off] = y;
    return;
  }
  const float y = epilogue(p, b, m, n, static_cast<float>(acc));
  if (p.out_dtype == 4)
    static_cast<int*>(p.C)[off] = static_cast<int>(y);
  else if (p.out_dtype == 1)
    static_cast<__nv_bfloat16*>(p.C)[off] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(p.C)[off] = y;
}

// Store two neighbouring elements (n, n + 1) of a row at ``off`` (even;
// the output n-contiguous), as store_out does each, in one store.
template <typename TAcc>
__device__ __forceinline__ void store_pair(const Q8Params& p, bool epi,
                                           long long off, long long b,
                                           long long m, long long n, TAcc a0,
                                           TAcc a1) {
  if (!epi && p.out_dtype == 4) {
    *reinterpret_cast<int2*>(static_cast<int*>(p.C) + off) =
        make_int2(static_cast<int>(a0), static_cast<int>(a1));
    return;
  }
  float y0 = static_cast<float>(a0), y1 = static_cast<float>(a1);
  if (epi) {
    y0 = epilogue(p, b, m, n, y0);
    y1 = epilogue(p, b, m, n + 1, y1);
  }
  if (p.out_dtype == 4)
    *reinterpret_cast<int2*>(static_cast<int*>(p.C) + off) =
        make_int2(static_cast<int>(y0), static_cast<int>(y1));
  else if (p.out_dtype == 1)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.C) +
                                       off) = __floats2bfloat162_rn(y0, y1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p.C) + off) =
        make_float2(y0, y1);
}

__device__ __forceinline__ uint32_t lds_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_k32(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  // one k32 step from zero, added into the f32 accumulator on the CUDA
  // cores (see the header)
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += s[e];
}

template <bool INT>
__global__ void __launch_bounds__(QTHREADS) q8_mma_kernel(const Q8Params p) {
  using TAcc = typename AccOf<INT>::type;
  __shared__ __align__(16) uint8_t As[QBM][QLD];  // [m][k]
  __shared__ __align__(16) uint8_t Bs[QBN][QLD];  // [n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  const long long M = p.M, N = p.N, K = p.K;
  const long long m0 = (long long)blockIdx.y * QBM;
  const long long n0 = (long long)blockIdx.x * QBN;
  const long long b = blockIdx.z;
  const uint8_t* A = static_cast<const uint8_t*>(p.A) + b * p.sAb;
  const uint8_t* B = static_cast<const uint8_t*>(p.B) + b * p.sBb;
  const bool batch_ok = p.batch == 1 || (p.sAb % 16 == 0 && p.sBb % 16 == 0);
  const bool a_vec = p.sAk == 1 && K % 16 == 0 && p.sAm % 16 == 0 &&
                     batch_ok &&
                     reinterpret_cast<uintptr_t>(p.A) % 16 == 0;
  const bool b_kvec = p.sBk == 1 && K % 16 == 0 && p.sBn % 16 == 0 &&
                      batch_ok &&
                      reinterpret_cast<uintptr_t>(p.B) % 16 == 0;
  const bool b_nvec = !b_kvec && p.sBn == 1 && N % 16 == 0 &&
                      p.sBk % 16 == 0 && batch_ok &&
                      reinterpret_cast<uintptr_t>(p.B) % 16 == 0;

  TAcc acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (long long k0 = 0; k0 < K; k0 += QBK) {
    if (a_vec) {
      // 64 rows x 4 chunks of 16 k
#pragma unroll
      for (int i = 0; i < QBM * QBK / 16 / QTHREADS; ++i) {
        const int v = tid + i * QTHREADS;
        const int r = v >> 2;
        const int c = (v & 3) * 16;
        const long long m = m0 + r, k = k0 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && k < K)
          val = *reinterpret_cast<const uint4*>(A + m * p.sAm + k);
        *reinterpret_cast<uint4*>(&As[r][c]) = val;
      }
    } else {
      // k fastest unless A is m-contiguous
      const bool kfast = p.sAk == 1 || p.sAm != 1;
      for (int i = 0; i < QBM * QBK / QTHREADS; ++i) {
        const int e = tid + i * QTHREADS;
        const int r = kfast ? e / QBK : e % QBM;
        const int c = kfast ? e % QBK : e / QBM;
        const long long m = m0 + r, k = k0 + c;
        As[r][c] = (m < M && k < K) ? A[m * p.sAm + k * p.sAk] : 0;
      }
    }
    if (b_kvec) {
      // 128 n rows x 4 chunks of 16 k
#pragma unroll
      for (int i = 0; i < QBN * QBK / 16 / QTHREADS; ++i) {
        const int v = tid + i * QTHREADS;
        const int r = v >> 2;
        const int c = (v & 3) * 16;
        const long long n = n0 + r, k = k0 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n < N && k < K)
          val = *reinterpret_cast<const uint4*>(B + n * p.sBn + k);
        *reinterpret_cast<uint4*>(&Bs[r][c]) = val;
      }
    } else if (b_nvec) {
      // 64 k rows x 8 chunks of 16 n, scattered into the k-major tile
#pragma unroll
      for (int i = 0; i < QBN * QBK / 16 / QTHREADS; ++i) {
        const int v = tid + i * QTHREADS;
        const int kk = v & (QBK - 1);
        const int c = (v / QBK) * 16;
        const long long k = k0 + kk, n = n0 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k < K && n < N)
          val = *reinterpret_cast<const uint4*>(B + k * p.sBk + n);
        const uint8_t* e = reinterpret_cast<const uint8_t*>(&val);
#pragma unroll
        for (int j = 0; j < 16; ++j) Bs[c + j][kk] = e[j];
      }
    } else {
      const bool nfast = p.sBn == 1 && p.sBk != 1;
      for (int i = 0; i < QBN * QBK / QTHREADS; ++i) {
        const int e = tid + i * QTHREADS;
        const int c = nfast ? e % QBN : e / QBK;
        const int kk = nfast ? e / QBN : e % QBK;
        const long long n = n0 + c, k = k0 + kk;
        Bs[c][kk] = (k < K && n < N) ? B[k * p.sBk + n * p.sBn] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < QBK; ks += 32) {
      uint32_t af[2][4];
      uint32_t bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = lds_u32(&As[r][ks + 4 * t]);
        af[mi][1] = lds_u32(&As[r + 8][ks + 4 * t]);
        af[mi][2] = lds_u32(&As[r][ks + 16 + 4 * t]);
        af[mi][3] = lds_u32(&As[r + 8][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = wn + ni * 8 + g;
        bf[ni][0] = lds_u32(&Bs[c][ks + 4 * t]);
        bf[ni][1] = lds_u32(&Bs[c][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_k32(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // accumulator fragment: e = 2h + j holds row g + 8h, column 2t + j
  const bool epi = has_epilogue(p);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const long long n = n0 + wn + ni * 8 + 2 * t + j;
          if (n < N)
            store_out<TAcc>(p, epi, b * p.sCb + m * p.sCm + n * p.sCn, b, m,
                            n, acc[mi][ni][2 * h + j]);
        }
    }
}

// The row-reduce mode's last step (contract.cu's, in the accumulator
// type): the last CTA of this column block sums the partial rows in
// row-block order and stores C[n].
template <typename TAcc>
__device__ __forceinline__ void finish_row_reduce(const Q8Params& p,
                                                  long long N, long long n) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(p.counter + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last || n >= N) return;
  __threadfence();
  const TAcc* part = static_cast<const TAcc*>(p.partial);
  TAcc s = 0;
  for (int r = 0; r < (int)gridDim.y; ++r)
    s += __ldcg(part + (long long)r * N + n);
  store_out<TAcc>(p, false, n * p.sCn, 0, 0, n, s);
}

template <bool INT>
__global__ void __launch_bounds__(UTHREADS) upcast_kernel(const Q8Params p) {
  using TAcc = typename AccOf<INT>::type;
  // A is stored k-major with one pad column (conflict-free transposing
  // stores, as contract.cu's f32 body)
  __shared__ TAcc As[UBK][UBM + 1];
  __shared__ TAcc Bs[UBK][UBN];
  __shared__ TAcc Red[UTHREADS / 32][UBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long M = p.M, N = p.N, K = p.K;
  const long long m0 = (long long)blockIdx.y * UBM;
  const long long n0 = (long long)blockIdx.x * UBN;
  const long long b = blockIdx.z;
  const char* A = static_cast<const char*>(p.A);
  const char* B = static_cast<const char*>(p.B);
  const long long aoff = b * p.sAb, boff = b * p.sBb;
  const bool kscale = p.kscale.p != nullptr;

  TAcc acc[UTM][UTN];
#pragma unroll
  for (int i = 0; i < UTM; ++i)
#pragma unroll
    for (int j = 0; j < UTN; ++j) acc[i][j] = 0;

  for (long long k0 = 0; k0 < K; k0 += UBK) {
    for (int i = 0; i < UBM * UBK / UTHREADS; ++i) {
      const int e = tid + i * UTHREADS;
      const int r = e / UBK;
      const int c = e % UBK;
      const long long m = m0 + r, k = k0 + c;
      TAcc v = 0;
      if (m < M && k < K) {
        v = load_as<TAcc>(A, aoff + m * p.sAm + k * p.sAk, p.a_dtype);
        if (kscale) v *= vec_at<TAcc>(p.kscale, b, m, 0, k);
      }
      As[c][r] = v;
    }
    for (int i = 0; i < UBK * UBN / UTHREADS; ++i) {
      const int e = tid + i * UTHREADS;
      const int r = e / UBN;
      const int c = e % UBN;
      const long long k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N)
                     ? load_as<TAcc>(B, boff + k * p.sBk + n * p.sBn,
                                     p.b_dtype)
                     : TAcc(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < UBK; ++kk) {
      TAcc a[UTM];
      TAcc bv[UTN];
#pragma unroll
      for (int i = 0; i < UTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < UTN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < UTM; ++i)
#pragma unroll
        for (int j = 0; j < UTN; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }

  if (p.mul.p) {
#pragma unroll
    for (int i = 0; i < UTM; ++i) {
      const long long m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < UTN; ++j) {
        const long long n = n0 + tx + 16 * j;
        if (m < M && n < N) acc[i][j] *= vec_at<TAcc>(p.mul, b, m, n, 0);
      }
    }
  }

  if (p.T) {
    // row reduce: column sums of acc * T over this CTA's 128 rows
    TAcc cs[UTN];
#pragma unroll
    for (int j = 0; j < UTN; ++j) cs[j] = 0;
#pragma unroll
    for (int i = 0; i < UTM; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < UTN; ++j) {
        const long long n = n0 + tx + 16 * j;
        if (n < N)
          cs[j] += acc[i][j] *
                   load_as<TAcc>(p.T, m * p.sTm + n * p.sTn, p.t_dtype);
      }
    }
    // lanes l and l + 16 of a warp share columns: rows ty and ty + 1
#pragma unroll
    for (int j = 0; j < UTN; ++j)
      cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
    if ((tid & 31) < 16)
#pragma unroll
      for (int j = 0; j < UTN; ++j) Red[tid / 32][tx + 16 * j] = cs[j];
    __syncthreads();
    long long n = N;
    if (tid < UBN) {
      n = n0 + tid;
      TAcc s = 0;
#pragma unroll
      for (int w = 0; w < UTHREADS / 32; ++w) s += Red[w][tid];
      if (n < N)
        static_cast<TAcc*>(p.partial)[(long long)blockIdx.y * N + n] = s;
    }
    finish_row_reduce<TAcc>(p, N, n);
    return;
  }

  const bool epi = has_epilogue(p);
#pragma unroll
  for (int i = 0; i < UTM; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < UTN; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n < N)
        store_out<TAcc>(p, epi, b * p.sCb + m * p.sCm + n * p.sCn, b, m, n,
                        acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The ring body (see the header): 128 x 128 tiles, 128 k-bytes a stage.
// ---------------------------------------------------------------------------
constexpr int QR_BM = 128;
constexpr int QR_BN = 128;
static_assert(QR_BM == QR_BN, "q8_ring_tile() names one square tile");
constexpr int QR_BK = 128;  // bytes of k a stage: four k32 wgmmas
constexpr int QR_THREADS = 384;
constexpr int QR_CONSUMERS = 256;
constexpr int QR_A_BYTES = QR_BM * QR_BK;
constexpr int QR_STAGE = QR_A_BYTES + QR_BN * QR_BK;
constexpr int QR_STAGES = 6;
// the row reduce's column sums of the 8 consumer warps (4-byte sums)
constexpr int QR_RED_BYTES = 8 * QR_BN * 4;
// the ring, 1024 bytes to align it, the row reduce's sums, full and empty
// barriers, the row reduce's "last CTA" flag
constexpr int QR_SMEM =
    QR_STAGES * QR_STAGE + 1024 + QR_RED_BYTES + 2 * QR_STAGES * 8 + 16;

// The accumulator times a multiplier, wrapping modulo 2^32 for int32
// (unsigned arithmetic: (sum a b) g == sum (a b g) there, as the
// reference's int32 sums of a * b * g)
__device__ __forceinline__ int acc_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}
__device__ __forceinline__ float acc_mul(float a, float b) { return a * b; }
// The accumulator's sum, wrapping modulo 2^32 for int32 as acc_mul does
__device__ __forceinline__ int acc_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}
__device__ __forceinline__ float acc_add(float a, float b) { return a + b; }

// One consumer warpgroup's int8 K walk: ``steps`` ring steps from the
// ring's step ``i0``, one wgmma group in flight across steps, each stage
// released once its group has retired (the walk's last after
// wait_group 0).
__device__ __forceinline__ void q8_int_walk(int (&acc)[64], uint32_t base,
                                            uint64_t* full, uint64_t* empty,
                                            int i0, int steps, int half) {
  for (int j = 0; j < steps; ++j) {
    const int i = i0 + j;
    const int s = i % QR_STAGES;
    hopper::mbar_wait(&full[s], (i / QR_STAGES) & 1);
    const uint32_t a = base + s * QR_STAGE + half * 8192;
    const uint32_t bt = base + s * QR_STAGE + QR_A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::wgmma_s8(acc, hopper::desc(a + ks * 32, 16, 1024),
                       hopper::desc(bt + ks * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (j > 0 && threadIdx.x % 128 == 0)
      hopper::mbar_arrive(&empty[(i - 1) % QR_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (steps > 0 && threadIdx.x % 128 == 0)
    hopper::mbar_arrive(&empty[(i0 + steps - 1) % QR_STAGES]);
}

// The row reduce on the ring (contract.cu's ring_row_reduce, in the
// accumulator's type): each consumer thread's column sums of acc * T over
// its two rows, summed across the 8 row groups of its warp by shuffles and
// across the 8 consumer warps in shared memory in warp order; the tile's
// 128 sums go to ``partial`` row m_t; the last CTA of the column block
// (``counter``) sums the partial rows in row-block order, stores C[n] and
// sets the counter back to 0.  Deterministic: no float atomics, a fixed
// order everywhere.
template <typename TAcc>
__device__ __forceinline__ void q8_ring_row_reduce(
    const TAcc (&acc)[64], const Q8Params& p, TAcc (*red)[QR_BN], int* last,
    long long r0, long long c0, int m_t, int n_t, int gy, int ct) {
  TAcc cs[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) cs[i] = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = r0 + 8 * h;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long n = c0 + 8 * j + e;
        if (n < p.N)
          cs[2 * j + e] = acc_add(
              cs[2 * j + e],
              acc_mul(acc[4 * j + 2 * h + e],
                      load_as<TAcc>(p.T, m * p.sTm + n * p.sTn, p.t_dtype)));
      }
  }
  // lanes t, t + 4, .., t + 28 share columns
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      cs[i] = acc_add(cs[i], __shfl_xor_sync(0xffffffffu, cs[i], off));
  const int lane = ct & 31;
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[ct >> 5][8 * j + 2 * lane + e] =
          cs[2 * j + e];
  hopper::bar_sync(1, QR_CONSUMERS);
  const long long n = (long long)n_t * QR_BN + ct;
  const bool mine = ct < QR_BN && n < p.N;
  TAcc* partial = static_cast<TAcc*>(p.partial);
  if (mine) {
    TAcc s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s = acc_add(s, red[w][ct]);
    __stcg(partial + (long long)m_t * p.N + n, s);
  }
  __threadfence();
  hopper::bar_sync(1, QR_CONSUMERS);
  if (ct == 0) *last = atomicAdd(p.counter + n_t, 1) == gy - 1;
  hopper::bar_sync(1, QR_CONSUMERS);
  if (!*last) return;
  __threadfence();
  if (ct == 0) p.counter[n_t] = 0;
  if (mine) {
    TAcc s = 0;
    for (int r = 0; r < gy; ++r)
      s = acc_add(s, __ldcg(partial + (long long)r * p.N + n));
    store_out<TAcc>(p, false, n * p.sCn, 0, 0, n, s);
  }
}

// Grid (tiles, 1, batch): the (M / 128) x (N / 128) tiles in bands of 8
// row tiles (hopper::raster); 384 threads: warpgroup 0 the producer, 1 and
// 2 the consumers.  tmA: boxes of 128 k x 128 m; tmB: 128 k x 128 n.
// PLANES 2 (int8): A's two byte planes H and L (tmA's batch coordinate
// 0 and 1, batch 1) are walked over the same B in turn, K twice, with acc
// *= 256 between the walks: C = 256 H.B + L.B modulo 2^32.  After the sums,
// ``p.mul`` multiplies the accumulator; with ``p.T`` the tile goes to the
// row reduce instead of the store.
template <bool INT, int PLANES>
__global__ void __launch_bounds__(QR_THREADS, 1)
q8_ring_kernel(const __grid_constant__ CUtensorMap tmA,
               const __grid_constant__ CUtensorMap tmB,
               const __grid_constant__ Q8Params p) {
  using TAcc = typename AccOf<INT>::type;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* tiles =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  TAcc (*red)[QR_BN] =
      reinterpret_cast<TAcc (*)[QR_BN]>(tiles + QR_STAGES * QR_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + QR_STAGES * QR_STAGE +
                                               QR_RED_BYTES);
  uint64_t* empty = full + QR_STAGES;
  int* last = reinterpret_cast<int*>(empty + QR_STAGES);

  const int gx = (int)((p.N + QR_BN - 1) / QR_BN);
  const int gy = (int)((p.M + QR_BM - 1) / QR_BM);
  int m_t, n_t;
  hopper::raster(blockIdx.x, gx, gy, 8, m_t, n_t);
  const int n0 = n_t * QR_BN;
  const int m0 = m_t * QR_BM;
  const int b = blockIdx.z;
  const int nk = (int)((p.K + QR_BK - 1) / QR_BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < QR_STAGES; ++s) {
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
      for (int i = 0; i < PLANES * nk; ++i) {
        const int s = i % QR_STAGES;
        const int plane = i / nk;
        const int k0 = (i - plane * nk) * QR_BK;
        hopper::mbar_wait(&empty[s], ((i / QR_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_tx(&full[s], QR_STAGE);
        unsigned char* a = tiles + s * QR_STAGE;
        hopper::tma_load(a, &tmA, &full[s], k0, m0, b + plane);
        hopper::tma_load(a + QR_A_BYTES, &tmB, &full[s], k0, n0, b);
      }
    }
    return;
  }

  hopper::regs_inc<232>();
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int half = ct >> 7;          // its warpgroup's 64 rows
  const uint32_t base = hopper::smem_u32(tiles);
  TAcc acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;

  if constexpr (INT) {
    q8_int_walk(acc, base, full, empty, 0, nk, half);
    if constexpr (PLANES == 2) {
      // H's walk has retired (wait_group 0): C = 256 H.B, then + L.B
#pragma unroll
      for (int e = 0; e < 64; ++e)
        acc[e] = static_cast<int>(static_cast<unsigned>(acc[e]) << 8);
      q8_int_walk(acc, base, full, empty, nk, nk, half);
    }
  } else {
    // every k32 wgmma from zero into one of two partials; the other, whose
    // group has retired (wait_group 1), is added into acc meanwhile
    float part[2][64];
    for (int i = 0; i < nk; ++i) {
      const int s = i % QR_STAGES;
      hopper::mbar_wait(&full[s], (i / QR_STAGES) & 1);
      const uint32_t a = base + s * QR_STAGE + half * 8192;
      const uint32_t bt = base + s * QR_STAGE + QR_A_BYTES;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float (&cur)[64] = part[ks & 1];
        float (&prev)[64] = part[(ks + 1) & 1];
        hopper::fence_regs(cur);
        hopper::wgmma_fence();
        hopper::wgmma_e4m3(cur, hopper::desc(a + ks * 32, 16, 1024),
                           hopper::desc(bt + ks * 32, 16, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(prev);
        if (i > 0 || ks > 0) {
#pragma unroll
          for (int e = 0; e < 64; ++e) acc[e] += prev[e];
        }
        // stage i - 1's last group (its ks = 3) has retired
        if (ks == 0 && i > 0 && threadIdx.x % 128 == 0)
          hopper::mbar_arrive(&empty[(i - 1) % QR_STAGES]);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part[1]);  // the last step's (ks = 3) partial
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[1][e];
  }

  // warp w of the consumer group: rows 16 w + g (+ 8); per n8 block j,
  // acc[4j + 2h + e] is (row g + 8h, column 8j + 2t + e)
  const int lane = ct & 31;
  const long long r0 = m0 + half * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  const long long c0 = n0 + 2 * (lane & 3);
  if (p.mul.p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = r0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long n = c0 + 8 * j + e;
          if (m < p.M && n < p.N)
            acc[4 * j + 2 * h + e] = acc_mul(
                acc[4 * j + 2 * h + e], vec_at<TAcc>(p.mul, b, m, n, 0));
        }
    }
  }
  if (p.T) {
    q8_ring_row_reduce<TAcc>(acc, p, red, last, r0, c0, m_t, n_t, gy, ct);
    return;
  }
  // a thread's two neighbouring columns go out as one 8-byte store (4 for
  // bf16) where the output is n-contiguous with even row and batch strides
  // and an 8-byte aligned base: a warp then writes whole 32-byte sectors
  // of each row
  const bool epi = has_epilogue(p);
  const bool pair = p.sCn == 1 && p.sCm % 2 == 0 &&
                    (p.batch == 1 || p.sCb % 2 == 0) &&
                    reinterpret_cast<uintptr_t>(p.C) % 8 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = r0 + 8 * h;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long n = c0 + 8 * j;
      const long long off = b * p.sCb + m * p.sCm + n * p.sCn;
      if (pair && n + 1 < p.N) {
        store_pair<TAcc>(p, epi, off, b, m, n, acc[4 * j + 2 * h],
                         acc[4 * j + 2 * h + 1]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (n + e < p.N)
          store_out<TAcc>(p, epi, off + e * p.sCn, b, m, n + e,
                          acc[4 * j + 2 * h + e]);
    }
  }
}

// The ring on a persistent grid (a searched plan, codegen.modes.Q8Plan):
// gridDim.x CTAs, CTA c taking tiles c, c + gridDim.x, ... of batch x (M /
// 128) x (N / 128), each tile in q8_ring_kernel's raster order, with its
// sums, multiplier, row reduce and stores, so the grid changes no value.
// The ring's stages and phases run on across a CTA's tiles (``i0``, the
// ring's step at a tile's start), so one tile's epilogue overlaps the next
// one's loads; the fp8 walk releases its last stage for the next tile.  A
// kernel of its own: q8_ring_kernel's one-tile launch, folded into this
// loop, ran 4-10 % slower on an H100.
template <bool INT, int PLANES>
__global__ void __launch_bounds__(QR_THREADS, 1)
q8_ring_persistent_kernel(const __grid_constant__ CUtensorMap tmA,
                          const __grid_constant__ CUtensorMap tmB,
                          const __grid_constant__ Q8Params p) {
  using TAcc = typename AccOf<INT>::type;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* tiles =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  TAcc (*red)[QR_BN] =
      reinterpret_cast<TAcc (*)[QR_BN]>(tiles + QR_STAGES * QR_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + QR_STAGES * QR_STAGE +
                                               QR_RED_BYTES);
  uint64_t* empty = full + QR_STAGES;
  int* last = reinterpret_cast<int*>(empty + QR_STAGES);

  const int gx = (int)((p.N + QR_BN - 1) / QR_BN);
  const int gy = (int)((p.M + QR_BM - 1) / QR_BM);
  const int nk = (int)((p.K + QR_BK - 1) / QR_BK);
  const int per = gx * gy;
  const int items = p.batch * per;  // < 2^31: the launch checks

  if (threadIdx.x == 0) {
    for (int s = 0; s < QR_STAGES; ++s) {
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
      int i = 0;  // the ring's step, across this CTA's tiles
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        int m_t, n_t;
        hopper::raster(t % per, gx, gy, 8, m_t, n_t);
        const int b = t / per;
        for (int j = 0; j < PLANES * nk; ++j, ++i) {
          const int s = i % QR_STAGES;
          const int plane = j / nk;
          const int k0 = (j - plane * nk) * QR_BK;
          hopper::mbar_wait(&empty[s], ((i / QR_STAGES) & 1) ^ 1);
          hopper::mbar_arrive_tx(&full[s], QR_STAGE);
          unsigned char* a = tiles + s * QR_STAGE;
          hopper::tma_load(a, &tmA, &full[s], k0, m_t * QR_BM, b + plane);
          hopper::tma_load(a + QR_A_BYTES, &tmB, &full[s], k0, n_t * QR_BN,
                           b);
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
  int i0 = 0;  // the ring's step at the tile's start, as the producer's
  for (int t = blockIdx.x; t < items; t += gridDim.x, i0 += PLANES * nk) {
    int m_t, n_t;
    hopper::raster(t % per, gx, gy, 8, m_t, n_t);
    const int b = t / per;
    const int n0 = n_t * QR_BN;
    const int m0 = m_t * QR_BM;
    TAcc acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0;

    if constexpr (INT) {
      q8_int_walk(acc, base, full, empty, i0, nk, half);
      if constexpr (PLANES == 2) {
#pragma unroll
        for (int e = 0; e < 64; ++e)
          acc[e] = static_cast<int>(static_cast<unsigned>(acc[e]) << 8);
        q8_int_walk(acc, base, full, empty, i0 + nk, nk, half);
      }
    } else {
      float part[2][64];
      for (int j = 0; j < nk; ++j) {
        const int i = i0 + j;
        const int s = i % QR_STAGES;
        hopper::mbar_wait(&full[s], (i / QR_STAGES) & 1);
        const uint32_t a = base + s * QR_STAGE + half * 8192;
        const uint32_t bt = base + s * QR_STAGE + QR_A_BYTES;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float (&cur)[64] = part[ks & 1];
          float (&prev)[64] = part[(ks + 1) & 1];
          hopper::fence_regs(cur);
          hopper::wgmma_fence();
          hopper::wgmma_e4m3(cur, hopper::desc(a + ks * 32, 16, 1024),
                             hopper::desc(bt + ks * 32, 16, 1024));
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          hopper::fence_regs(prev);
          if (j > 0 || ks > 0) {
#pragma unroll
            for (int e = 0; e < 64; ++e) acc[e] += prev[e];
          }
          if (ks == 0 && j > 0 && threadIdx.x % 128 == 0)
            hopper::mbar_arrive(&empty[(i - 1) % QR_STAGES]);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part[1]);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += part[1][e];
      // the last step's stage, for the CTA's next tile
      if (threadIdx.x % 128 == 0)
        hopper::mbar_arrive(&empty[(i0 + nk - 1) % QR_STAGES]);
    }

    const long long r0 = m0 + half * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
    const long long c0 = n0 + 2 * (lane & 3);
    if (p.mul.p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = r0 + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long n = c0 + 8 * j + e;
            if (m < p.M && n < p.N)
              acc[4 * j + 2 * h + e] = acc_mul(
                  acc[4 * j + 2 * h + e], vec_at<TAcc>(p.mul, b, m, n, 0));
          }
      }
    }
    if (p.T) {
      q8_ring_row_reduce<TAcc>(acc, p, red, last, r0, c0, m_t, n_t, gy, ct);
      continue;
    }
    const bool epi = has_epilogue(p);
    const bool pair = p.sCn == 1 && p.sCm % 2 == 0 &&
                      (p.batch == 1 || p.sCb % 2 == 0) &&
                      reinterpret_cast<uintptr_t>(p.C) % 8 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = r0 + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long n = c0 + 8 * j;
        const long long off = b * p.sCb + m * p.sCm + n * p.sCn;
        if (pair && n + 1 < p.N) {
          store_pair<TAcc>(p, epi, off, b, m, n, acc[4 * j + 2 * h],
                           acc[4 * j + 2 * h + 1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < p.N)
            store_out<TAcc>(p, epi, off + e * p.sCn, b, m, n + e,
                            acc[4 * j + 2 * h + e]);
      }
    }
  }
}

template <bool INT, int PLANES>
int q8_ring_start(const CUtensorMap& ta, const CUtensorMap& tb,
                  const Q8Params& p, dim3 grid, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      q8_ring_kernel<INT, PLANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, QR_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  q8_ring_kernel<INT, PLANES><<<grid, QR_THREADS, QR_SMEM, stream>>>(ta, tb,
                                                                      p);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT, int PLANES>
int q8_ring_persistent_start(const CUtensorMap& ta, const CUtensorMap& tb,
                             const Q8Params& p, unsigned ctas,
                             cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      q8_ring_persistent_kernel<INT, PLANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, QR_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  q8_ring_persistent_kernel<INT, PLANES>
      <<<ctas, QR_THREADS, QR_SMEM, stream>>>(ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}

// The ring's launch: checks its preconditions (cudaErrorInvalidValue when
// one fails; nothing switches body), encodes the two tensor maps and
// launches.  With ``planes`` 2, A holds the two int8 planes as its batch.
// ``ctas`` 0: one CTA a tile (q8_ring_kernel); else that many persistent
// CTAs, at most one a tile (q8_ring_persistent_kernel).
int q8_ring_launch(const Q8Params& p, int ctas, cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      ((p.M + QR_BM - 1) / QR_BM) * ((p.N + QR_BN - 1) / QR_BN);
  if (p.M < 64 || p.K < 1 || p.N < 1 || p.batch < 1 || p.batch > 65535 ||
      tiles >= (1LL << 31) ||
      (p.planes == 2 && (p.a_dtype != 2 || p.batch != 1 || p.T)) ||
      ctas < 0 || (ctas > 0 && tiles * p.batch >= (1LL << 31)))
    return invalid;
  const hopper::Operand a{p.A, p.K, p.M, p.sAm, p.planes == 2 ? 2 : p.batch,
                          p.sAb};
  const hopper::Operand bo{p.B, p.K, p.N, p.sBn, p.batch, p.sBb};
  if (!(p.sAk == 1 || p.K == 1) || !(p.sBk == 1 || p.K == 1)) return invalid;
  CUtensorMap ta, tb;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!hopper::make_map(&ta, a, 1, u8, QR_BK, QR_BM) ||
      !hopper::make_map(&tb, bo, 1, u8, QR_BK, QR_BN))
    return invalid;
  if (ctas > 0) {
    const unsigned grid =
        (unsigned)(ctas < tiles * p.batch ? ctas : tiles * p.batch);
    if (p.a_dtype != 2)
      return q8_ring_persistent_start<false, 1>(ta, tb, p, grid, stream);
    if (p.planes == 2)
      return q8_ring_persistent_start<true, 2>(ta, tb, p, grid, stream);
    return q8_ring_persistent_start<true, 1>(ta, tb, p, grid, stream);
  }
  const dim3 grid((unsigned)tiles, 1, (unsigned)p.batch);
  if (p.a_dtype != 2) return q8_ring_start<false, 1>(ta, tb, p, grid, stream);
  if (p.planes == 2) return q8_ring_start<true, 2>(ta, tb, p, grid, stream);
  return q8_ring_start<true, 1>(ta, tb, p, grid, stream);
}

bool valid(const Q8Params& p) {
  const bool out_ok = p.out_dtype == 0 || p.out_dtype == 1 ||
                      p.out_dtype == 4;
  return out_ok && (p.mean.p == nullptr) == (p.var.p == nullptr) &&
         p.act >= 0 && p.act <= 4 && (!p.T || p.batch == 1);
}

}  // namespace

extern "C" {

// q8_launch (below) on a plan: ``ctas`` 0 (one CTA a tile) or the ring's
// persistent CTAs; the mma.sync body refuses ctas other than 0.
int q8_plan_launch(const Q8Params* p, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(*p) || p->a_dtype != p->b_dtype ||
      (p->a_dtype != 2 && p->a_dtype != 3) || p->kscale.p ||
      p->acc_int != (p->a_dtype == 2) || p->body < 0 || p->body > 1 ||
      p->planes < 1 || p->planes > 2 ||
      (p->body == 0 && (p->T || p->mul.p || p->planes != 1 || ctas != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->body == 1) return q8_ring_launch(*p, ctas, s);
  const dim3 grid((unsigned)((p->N + QBN - 1) / QBN),
                  (unsigned)((p->M + QBM - 1) / QBM), (unsigned)p->batch);
  if (p->a_dtype == 2)
    q8_mma_kernel<true><<<grid, QTHREADS, 0, s>>>(*p);
  else
    q8_mma_kernel<false><<<grid, QTHREADS, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// Two 8-bit operands of one type (a_dtype == b_dtype, 2 int8 or 3 fp8) on
// the tensor cores: q8_mma_kernel (body 0) or the ring (body 1, or
// refused).  Only the ring takes the multiplier, the row reduce (its
// partial buffer (row blocks of 128, N) and one int per 128-column block,
// zeroed) and two int8 planes (the k-scale the wrapper folded into A);
// no body takes a k-scale vector.  Strides are in elements (bytes).
// Returns cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised or allocated here.
int q8_launch(const Q8Params* p, void* stream) {
  return q8_plan_launch(p, 0, stream);
}

// Any operand types on the CUDA cores (int accumulation: int8 or int32
// operands only), with the k-scale, multiplier and row-reduce modes.  The
// row reduce needs batch 1, a (row blocks, N) partial buffer of the
// accumulator type and one zeroed int per column block (upcast_tile_*).
int upcast_launch(const Q8Params* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(*p) || p->body != 0 || p->planes != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((p->N + UBN - 1) / UBN),
                  (unsigned)((p->M + UBM - 1) / UBM), (unsigned)p->batch);
  if (p->acc_int)
    upcast_kernel<true><<<grid, UTHREADS, 0, s>>>(*p);
  else
    upcast_kernel<false><<<grid, UTHREADS, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

int q8_tile_m(void) { return QBM; }
int q8_tile_n(void) { return QBN; }
int upcast_tile_m(void) { return UBM; }
int upcast_tile_n(void) { return UBN; }
// the ring's square tile (rows and columns), which sizes the row reduce's
// partial buffer and counters
int q8_ring_tile(void) { return QR_BM; }

// sizeof(Q8Params), checked against the ctypes mirror at load.
int q8_params_size(void) { return (int)sizeof(Q8Params); }

}  // extern "C"
