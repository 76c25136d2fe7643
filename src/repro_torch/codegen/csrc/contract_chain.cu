// B1's chain mode for Hopper: C[r,c] = sum_q (sum_p X[r,p] Y[p,q]) Z[q,c],
// two reductions in one launch, the intermediate T = X.Y never in device
// memory.
//
// Replaces the reference's generated Pallas contraction kernel for
// chain_matmul and its derived backward specs (src/repro/codegen/
// pallas_gen.py: CompiledKernel._build -> _make_kernel, pl.pallas_call at
// :263), which sums block-local einsum("ij,jk,kl->il") terms over both
// reduction chunks (core/enumerate.py: chain_matmul_spec, the paper's
// fusion claim across two contractions).  The Python side
// (codegen/cuda_gen.py) maps a spec of three matrices X(r,p), Y(p,q),
// Z(q,c) onto this kernel: chain_matmul A@B@C, and its .dA, .dB, .dC, each
// a chain of three strided or transposed matrices.  It picks the
// association: (X.Y).Z as written, or X.(Y.Z) by running the transposed
// chain Z^T Y^T X^T into C^T, whichever recomputes less (a CTA recomputes
// its rows of T once per column block).
//
// Grid: one CTA per (r block, c block).  It loops over chunks of q; for
// each chunk it forms T[r block, q chunk] over the whole p reduction, then
// adds T.Z[q chunk, c block] into the accumulator.  Operands are read with
// their strides along whichever axis is contiguous, so transposed views
// need no copy: one launch, no copies.
//   * bf16 (chain_bf16_kernel): mma.sync m16n8k16 for both products, a 64 x
//     128 CTA tile, 4 warps of 16 rows x 128 columns, p in steps of 64.
//     Each warp forms its 16 rows of a 64-column T chunk in f32 registers,
//     and the accumulator fragment of m16n8 is the A fragment of m16n8k16,
//     so T goes into the second product from registers, rounded once to
//     bf16 (the reference keeps T in f32: hold bf16 at its bf16 TOL).  A
//     tile is staged 16 bytes at a time along its contiguous axis where
//     the strides and the alignment allow (scattered into the k-major
//     shared layout when that axis is the other one), else element by
//     element.
//   * f32, int8, fp8, int32 (chain_scalar_kernel<INT>): the CUDA cores, a
//     64 x 64 tile, 256 threads; each operand is upcast as it is staged
//     (int32 accumulation for int8 specs, f32 otherwise) and T, in the
//     accumulator type, goes through shared memory.
// The epilogue (dequant, scale, bias, norm, activation) runs on the f32
// accumulator before the store.
//
// What bounds it on the H100: one qwen3-8b head's (QK^T)V without softmax
// over a 4096-token context, (R, P, Q, C) = (4096, 128, 4096, 128), needs
// 0.27 GFLOP (Y.Z first) on about 4 MB, so its bound is the bytes (1.3 us
// at 3.35 TB/s).  A fused kernel recomputes the intermediate's slice of
// each CTA: 4.4 GFLOP in the association this one takes (8.6 as written),
// 4.4 us at 989 TFLOP/s.  This body is simple and right: loads alternate
// with the math (no cp.async pipeline), and 64 CTAs do not fill 132 SMs.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// One epilogue vector: element (coord / div) % len of p (f32), coord the
// output row (axis 1) or column (axis 2).  p == nullptr: the stage is off.
struct ChainVec {
  const float* p;
  long long div;
  long long len;
  int axis;
  int pad;
};

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn, 4 int32.
struct ChainParams {
  const void* X;
  const void* Y;
  const void* Z;
  void* C;
  long long R, P, Q, N;
  long long sXr, sXp, sYp, sYq, sZq, sZn, sCr, sCn;
  ChainVec qscale, scale, bias, mean, var;
  float eps;
  int act;  // 0 id, 1 relu, 2 gelu (tanh), 3 tanh, 4 silu
  int in_dtype;
  int out_dtype;
};

}  // extern "C"

namespace {

constexpr int CBR = 64;   // bf16: rows per CTA (4 warps x 16)
constexpr int CBN = 128;  // bf16: columns per CTA
constexpr int CBQ = 64;   // bf16: q chunk
constexpr int CBP = 64;   // bf16: p step
constexpr int CTHREADS = 128;
constexpr int CLD_P = CBP + 8;  // 72 bf16 = 36 words: conflict-free frags
constexpr int CLD_Q = CBQ + 8;  // 72 bf16 = 36 words

constexpr int SBR = 64;  // scalar: rows per CTA
constexpr int SBN = 64;  // scalar: columns per CTA
constexpr int SBQ = 32;
constexpr int SBP = 32;
constexpr int STHREADS = 256;

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

template <typename TAcc>
__device__ __forceinline__ TAcc load_as(const void* p, long long i, int code);
template <>
__device__ __forceinline__ float load_as<float>(const void* p, long long i,
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
template <>
__device__ __forceinline__ int load_as<int>(const void* p, long long i,
                                            int code) {
  return code == 2 ? static_cast<int>(static_cast<const int8_t*>(p)[i])
                   : static_cast<const int*>(p)[i];
}

__device__ __noinline__ long long vec_index_slow(long long c, long long div,
                                                 long long len) {
  return (c / div) % len;
}

__device__ __forceinline__ float vec_at(const ChainVec& v, long long r,
                                        long long n) {
  const long long c = v.axis == 1 ? r : n;
  return v.p[v.div == 1 && c < v.len ? c : vec_index_slow(c, v.div, v.len)];
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

// Store the accumulator at (r, n): as it is with no epilogue, else its f32
// epilogue; converted as the reference's astype does.
template <typename TAcc>
__device__ __forceinline__ void store_out(const ChainParams& p, long long r,
                                          long long n, TAcc acc) {
  const long long off = r * p.sCr + n * p.sCn;
  const bool epi =
      p.qscale.p || p.scale.p || p.bias.p || p.mean.p || p.act;
  if (!epi && p.out_dtype == 4) {
    static_cast<int*>(p.C)[off] = static_cast<int>(acc);
    return;
  }
  float y = static_cast<float>(acc);
  if (epi) {
    if (p.qscale.p) y *= vec_at(p.qscale, r, n);
    if (p.scale.p) y *= vec_at(p.scale, r, n);
    if (p.bias.p) y += vec_at(p.bias, r, n);
    if (p.mean.p)
      y = (y - vec_at(p.mean, r, n)) * rsqrtf(vec_at(p.var, r, n) + p.eps);
    y = activate(p.act, y);
  }
  if (p.out_dtype == 4)
    static_cast<int*>(p.C)[off] = static_cast<int>(y);
  else if (p.out_dtype == 1)
    static_cast<__nv_bfloat16*>(p.C)[off] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(p.C)[off] = y;
}

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// How a bf16 tile is read from device memory: 16 bytes (8 elements) at a
// time along its smem rows (STAGE_ROWVEC) or down its smem columns
// (STAGE_COLVEC), or element by element (STAGE_SCALAR).
constexpr int STAGE_SCALAR = 0;
constexpr int STAGE_ROWVEC = 1;
constexpr int STAGE_COLVEC = 2;

// The mode for a tile whose element (r, c) lies at G[r * sr + c * sc]:
// the unit-stride axis must have a multiple of 8 elements, the other
// stride a multiple of 8, and G 16-byte alignment.
__device__ __forceinline__ int stage_mode(const void* G, long long sr,
                                          long long sc, long long R,
                                          long long C) {
  if (reinterpret_cast<uintptr_t>(G) % 16 != 0) return STAGE_SCALAR;
  if (sc == 1 && sr % 8 == 0 && C % 8 == 0) return STAGE_ROWVEC;
  if (sr == 1 && sc % 8 == 0 && R % 8 == 0) return STAGE_COLVEC;
  return STAGE_SCALAR;
}

// Stage the ROWS x COLS tile at (r0, c0) of G into T[r][c] (zeros past R,
// C).  Consecutive threads take consecutive addresses of G in every mode.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16 (*T)[LD],
                                           const __nv_bfloat16* G,
                                           long long sr, long long sc,
                                           long long r0, long long c0,
                                           long long R, long long C,
                                           int mode) {
  const int tid = threadIdx.x;
  if (mode == STAGE_ROWVEC) {
#pragma unroll
    for (int v = tid; v < ROWS * COLS / 8; v += CTHREADS) {
      const int r = v / (COLS / 8);
      const int c = (v % (COLS / 8)) * 8;
      const long long gr = r0 + r, gc = c0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < R && gc < C)
        val = *reinterpret_cast<const uint4*>(G + gr * sr + gc);
      *reinterpret_cast<uint4*>(&T[r][c]) = val;
    }
  } else if (mode == STAGE_COLVEC) {
#pragma unroll
    for (int v = tid; v < ROWS * COLS / 8; v += CTHREADS) {
      const int r = (v % (ROWS / 8)) * 8;
      const int c = v / (ROWS / 8);
      const long long gr = r0 + r, gc = c0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < R && gc < C)
        val = *reinterpret_cast<const uint4*>(G + gr + gc * sc);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) T[r + j][c] = e[j];
    }
  } else {
    const bool cfast = sc == 1 || sr != 1;
    for (int e = tid; e < ROWS * COLS; e += CTHREADS) {
      const int r = cfast ? e / COLS : e % ROWS;
      const int c = cfast ? e % COLS : e / ROWS;
      const long long gr = r0 + r, gc = c0 + c;
      T[r][c] = (gr < R && gc < C) ? G[gr * sr + gc * sc]
                                   : __float2bfloat16(0.f);
    }
  }
}

__global__ void __launch_bounds__(CTHREADS) chain_bf16_kernel(
    const ChainParams p) {
  __shared__ __align__(16) __nv_bfloat16 Xs[CBR][CLD_P];  // [r][p]
  __shared__ __align__(16) __nv_bfloat16 Ys[CBQ][CLD_P];  // [q][p]
  __shared__ __align__(16) __nv_bfloat16 Zs[CBN][CLD_Q];  // [n][q]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const long long R = p.R, P = p.P, Q = p.Q, N = p.N;
  const long long r0 = (long long)blockIdx.y * CBR;
  const long long n0 = (long long)blockIdx.x * CBN;
  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(p.X);
  const __nv_bfloat16* Y = static_cast<const __nv_bfloat16*>(p.Y);
  const __nv_bfloat16* Z = static_cast<const __nv_bfloat16*>(p.Z);
  // tiles as (smem row, smem column): X (r, p), Y (q, p), Z (n, q)
  const int x_mode = stage_mode(X, p.sXr, p.sXp, R, P);
  const int y_mode = stage_mode(Y, p.sYq, p.sYp, Q, P);
  const int z_mode = stage_mode(Z, p.sZn, p.sZq, N, Q);

  float acc[CBN / 8][4];
#pragma unroll
  for (int ni = 0; ni < CBN / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  for (long long q0 = 0; q0 < Q; q0 += CBQ) {
    float tq[CBQ / 8][4];
#pragma unroll
    for (int ni = 0; ni < CBQ / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) tq[ni][e] = 0.f;

    for (long long p0 = 0; p0 < P; p0 += CBP) {
      stage_tile<CBR, CBP, CLD_P>(Xs, X, p.sXr, p.sXp, r0, p0, R, P, x_mode);
      stage_tile<CBQ, CBP, CLD_P>(Ys, Y, p.sYq, p.sYp, q0, p0, Q, P, y_mode);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < CBP; ks += 16) {
        uint32_t af[4];
        af[0] = lds_u32(&Xs[wr + g][ks + 2 * t]);
        af[1] = lds_u32(&Xs[wr + g + 8][ks + 2 * t]);
        af[2] = lds_u32(&Xs[wr + g][ks + 2 * t + 8]);
        af[3] = lds_u32(&Xs[wr + g + 8][ks + 2 * t + 8]);
#pragma unroll
        for (int ni = 0; ni < CBQ / 8; ++ni) {
          uint32_t bf[2];
          bf[0] = lds_u32(&Ys[ni * 8 + g][ks + 2 * t]);
          bf[1] = lds_u32(&Ys[ni * 8 + g][ks + 2 * t + 8]);
          mma_16816(tq[ni], af, bf);
        }
      }
      __syncthreads();
    }

    stage_tile<CBN, CBQ, CLD_Q>(Zs, Z, p.sZn, p.sZq, n0, q0, N, Q, z_mode);
    __syncthreads();
    // T's accumulator fragments (tile j: rows g, g + 8; columns 8j + 2t,
    // + 1) are the A fragments of the second product's k steps
#pragma unroll
    for (int kk = 0; kk < CBQ / 16; ++kk) {
      uint32_t af[4];
      af[0] = pack_bf16(tq[2 * kk][0], tq[2 * kk][1]);
      af[1] = pack_bf16(tq[2 * kk][2], tq[2 * kk][3]);
      af[2] = pack_bf16(tq[2 * kk + 1][0], tq[2 * kk + 1][1]);
      af[3] = pack_bf16(tq[2 * kk + 1][2], tq[2 * kk + 1][3]);
#pragma unroll
      for (int ni = 0; ni < CBN / 8; ++ni) {
        uint32_t bf[2];
        bf[0] = lds_u32(&Zs[ni * 8 + g][kk * 16 + 2 * t]);
        bf[1] = lds_u32(&Zs[ni * 8 + g][kk * 16 + 2 * t + 8]);
        mma_16816(acc[ni], af, bf);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = r0 + wr + g + 8 * h;
    if (r >= R) continue;
#pragma unroll
    for (int ni = 0; ni < CBN / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long n = n0 + ni * 8 + 2 * t + j;
        if (n < N) store_out<float>(p, r, n, acc[ni][2 * h + j]);
      }
  }
}

template <bool INT>
__global__ void __launch_bounds__(STHREADS) chain_scalar_kernel(
    const ChainParams p) {
  using TAcc = typename AccOf<INT>::type;
  __shared__ TAcc Xs[SBP][SBR + 1];  // [p][r]
  __shared__ TAcc Ys[SBP][SBQ + 1];  // [p][q]
  __shared__ TAcc Ts[SBQ][SBR + 1];  // [q][r]
  __shared__ TAcc Zs[SBQ][SBN];      // [q][n]

  const int tid = threadIdx.x;
  const int tx = tid % 32;  // T: column q = tx, rows ty + 8 i
  const int ty = tid / 32;
  const int ax = tid % 16;  // acc: rows ay + 16 i, columns ax + 16 j
  const int ay = tid / 16;
  const long long R = p.R, P = p.P, Q = p.Q, N = p.N;
  const long long r0 = (long long)blockIdx.y * SBR;
  const long long n0 = (long long)blockIdx.x * SBN;
  const int code = p.in_dtype;
  const bool x_pfast = p.sXp == 1 || p.sXr != 1;
  const bool y_qfast = p.sYq == 1 && p.sYp != 1;
  const bool z_nfast = p.sZn == 1 || p.sZq != 1;

  TAcc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (long long q0 = 0; q0 < Q; q0 += SBQ) {
    TAcc tq[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) tq[i] = 0;
    for (long long p0 = 0; p0 < P; p0 += SBP) {
      for (int i = 0; i < SBP * SBR / STHREADS; ++i) {
        const int e = tid + i * STHREADS;
        const int pp = x_pfast ? e % SBP : e / SBR;
        const int rr = x_pfast ? e / SBP : e % SBR;
        const long long r = r0 + rr, k = p0 + pp;
        Xs[pp][rr] = (r < R && k < P)
                         ? load_as<TAcc>(p.X, r * p.sXr + k * p.sXp, code)
                         : TAcc(0);
      }
      for (int i = 0; i < SBP * SBQ / STHREADS; ++i) {
        const int e = tid + i * STHREADS;
        const int qq = y_qfast ? e % SBQ : e / SBP;
        const int pp = y_qfast ? e / SBQ : e % SBP;
        const long long q = q0 + qq, k = p0 + pp;
        Ys[pp][qq] = (q < Q && k < P)
                         ? load_as<TAcc>(p.Y, k * p.sYp + q * p.sYq, code)
                         : TAcc(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int pp = 0; pp < SBP; ++pp) {
        const TAcc y = Ys[pp][tx];
#pragma unroll
        for (int i = 0; i < 8; ++i) tq[i] += Xs[pp][ty + 8 * i] * y;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Ts[tx][ty + 8 * i] = tq[i];
    for (int i = 0; i < SBQ * SBN / STHREADS; ++i) {
      const int e = tid + i * STHREADS;
      const int nn = z_nfast ? e % SBN : e / SBQ;
      const int qq = z_nfast ? e / SBN : e % SBQ;
      const long long n = n0 + nn, q = q0 + qq;
      Zs[qq][nn] = (q < Q && n < N)
                       ? load_as<TAcc>(p.Z, q * p.sZq + n * p.sZn, code)
                       : TAcc(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int qq = 0; qq < SBQ; ++qq) {
      TAcc a[4];
      TAcc z[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ts[qq][ay + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) z[j] = Zs[qq][ax + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * z[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ay + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + ax + 16 * j;
      if (n < N) store_out<TAcc>(p, r, n, acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// Strides are in elements.  in_dtype 1 (bf16) runs the tensor-core body;
// 0, 2, 3, 4 the CUDA-core body (int32 accumulation for 2 and 4).  Returns
// cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised or allocated here.
int chain_launch(const ChainParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int out = p->out_dtype;
  if (p->in_dtype < 0 || p->in_dtype > 4 ||
      (out != 0 && out != 1 && out != 4) ||
      (p->mean.p == nullptr) != (p->var.p == nullptr) || p->act < 0 ||
      p->act > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->in_dtype == 1) {
    const dim3 grid((unsigned)((p->N + CBN - 1) / CBN),
                    (unsigned)((p->R + CBR - 1) / CBR));
    chain_bf16_kernel<<<grid, CTHREADS, 0, s>>>(*p);
  } else {
    const dim3 grid((unsigned)((p->N + SBN - 1) / SBN),
                    (unsigned)((p->R + SBR - 1) / SBR));
    if (p->in_dtype == 2 || p->in_dtype == 4)
      chain_scalar_kernel<true><<<grid, STHREADS, 0, s>>>(*p);
    else
      chain_scalar_kernel<false><<<grid, STHREADS, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The CTA tile (rows, columns) of the body chosen for in_dtype: the Python
// side sizes its grid checks and its association cost with them.
int chain_tile_m(int in_dtype) { return in_dtype == 1 ? CBR : SBR; }
int chain_tile_n(int in_dtype) { return in_dtype == 1 ? CBN : SBN; }

// sizeof(ChainParams), checked against the ctypes mirror at load.
int chain_params_size(void) { return (int)sizeof(ChainParams); }

}  // extern "C"
