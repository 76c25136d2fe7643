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
// chain Z^T Y^T X^T into C^T, whichever forms less of T (chain_cost below).
//
// Grid: one CTA per (r block, c block), and the CTAs of a thread-block
// cluster (up to 8 along the column blocks: chain_cluster, or the
// searched plan's, codegen.modes.ChainPlan) share one r block.  For each
// chunk of q, every CTA of the cluster forms a partial T over its own
// share of the p reduction; the partials are summed through distributed
// shared memory in rank order (each rank sums its slice of T's rows over
// all ranks, then every rank gathers the others' slices), so each
// CTA holds the whole T chunk, rounded once, and multiplies it into its own
// column block.  The sum has a fixed order and no atomics: two launches on
// the same inputs give the same bits.  Relative to one CTA forming T alone,
// the recomputation of T (once per cluster, not once per column block) and
// each CTA's serial p loop both fall by the cluster size.  Operands are
// read with their strides along whichever axis is contiguous, so transposed
// views need no copy: one launch, no copies.
//   * bf16 (chain_bf16_kernel): mma.sync m16n8k16 for both products, a 64 x
//     128 CTA tile, 8 warps of 16 rows x 64 columns, q in chunks of 128, p
//     in steps of 64.  X, Y and Z tiles stream through a three-stage
//     16-byte cp.async ring, each kept in shared memory as it lies (rows
//     along its unit-stride axis, padded by 16 bytes), and reach the
//     fragments through ldmatrix or ldmatrix.trans as the layout asks.  T is
//     summed in f32 and rounded once to bf16 (the reference keeps T in f32:
//     hold bf16 at its bf16 TOL).
//   * f32, int8, fp8, int32 (chain_scalar_kernel<TIn>): the CUDA cores, a
//     64 x 64 tile, 256 threads of 4 x 4 outputs, q in chunks of 64, p in
//     steps of 32.  Tiles stream raw through a three-stage cp.async ring
//     and are upcast into a compute tile (int32 accumulation for int8 and
//     int32 operands, so partials sum exactly; f32 otherwise).
// Operands that cannot take 16-byte copies (odd widths, unaligned
// pointers, neither stride unit) are staged element by element into the
// same layouts.  The epilogue (dequant, scale, bias, norm, activation) runs
// on the f32 accumulator before the store.
//
// What bounds it on the H100: one qwen3-8b head's (QK^T)V without softmax
// over a 4096-token context, (R, P, Q, C) = (4096, 128, 4096, 128), needs
// 0.27 GFLOP (Y.Z first) on about 4 MB, so its bound is the bytes (1.3 us
// at 3.35 TB/s).  The kernel runs it as the transposed chain (128, 4096,
// 128, 4096): 2 r blocks x 32 column blocks in clusters of 8, so T is formed
// 4 times (0.54 GFLOP with the second product, 0.5 us at 989 TFLOP/s) and
// each CTA walks 512 of p.  At 64 CTAs it is bound by each CTA's latency
// (its 224 KB of tiles from L2, its 10.5 MFLOP on one SM, two cluster
// barriers and the DSMEM sums): about 40 us on the device.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
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
  int cluster;  // CTAs a cluster: 1, 2, 4 or 8; 0 takes cluster_for's
};

}  // extern "C"

namespace {

__device__ __forceinline__ float fp8_to_f32(uint8_t v) {
  __nv_fp8_e4m3 x;
  x.__x = v;
  return static_cast<float>(x);
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

namespace cg = cooperative_groups;

constexpr int STAGES = 3;
constexpr int MAX_CLUSTER = 8;

// bf16 body
constexpr int CBR = 64;   // rows per CTA (4 warps x 16)
constexpr int CBN = 128;  // columns per CTA
constexpr int CBQ = 128;  // q chunk
constexpr int CBP = 64;   // p step
constexpr int CTHREADS = 256;  // 8 warps: 4 of 16 rows x 2 column halves
constexpr int CWQ = CBQ / 2;    // T columns of a warp
constexpr int CWN = CBN / 2;    // output columns of a warp

// scalar body
constexpr int SBR = 64;  // rows per CTA
constexpr int SBN = 64;  // columns per CTA
constexpr int SBQ = 64;  // q chunk
constexpr int SBP = 32;  // p step
constexpr int STHREADS = 256;

// The cluster size for a p reduction of `steps` steps: the largest power of
// two up to MAX_CLUSTER that leaves every rank two steps or more.
__host__ __device__ inline int cluster_for(long long steps) {
  int cs = 1;
  while (cs < MAX_CLUSTER && steps >= 4LL * cs) cs *= 2;
  return cs;
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

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

// m16n8k16 A fragment of the 16 x 16 block at (m0, k0) of a tile kept
// [m][k] (km = false) or [k][m] (km = true), row length LD
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* S, int m0, int k0,
                                       int lane, bool KM) {
  if (KM)
    ldmatrix_x4_trans(a, S + (k0 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                             m0 + ((lane >> 3) & 1) * 8);
  else
    ldmatrix_x4(a, S + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// B fragments of the n8 tiles n0 and n0 + 8 at k0 (r[0..1] and r[2..3]) of
// a tile kept [n][k] (KN = false) or [k][n] (KN = true)
template <int LD>
__device__ __forceinline__ void load_b2(uint32_t (&r)[4],
                                        const __nv_bfloat16* S, int n0, int k0,
                                        int lane, bool KN) {
  if (KN)
    ldmatrix_x4_trans(r, S + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8);
  else
    ldmatrix_x4(r, S + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                       ((lane >> 3) & 1) * 8);
}

// 16-byte copies of T along a tile's rows: element (a, b) of G at
// G[a * sa + b] (b the unit-stride axis), a in [a0, a0 + A), b in [b0, b0 +
// B), into S[a][b] (row length LD elements); zeros past AE, BE.
template <typename T, int A, int B, int LD, int NT>
__device__ __forceinline__ void tile_async(T* S, const T* G, long long sa,
                                           long long a0, long long b0,
                                           long long AE, long long BE) {
  constexpr int EPC = 16 / sizeof(T);
#pragma unroll
  for (int v = threadIdx.x; v < A * B / EPC; v += NT) {
    const int a = v / (B / EPC);
    const int b = (v % (B / EPC)) * EPC;
    const bool ok = a0 + a < AE && b0 + b < BE;
    cp_async16(S + a * LD + b, ok ? G + (a0 + a) * sa + b0 + b : G, ok);
  }
}

// 16-byte copies need: unit stride along the tile's rows, the other stride
// and that axis's extent multiples of the chunk, and an aligned base.
template <typename T>
__device__ __forceinline__ bool can_vec(const void* G, long long sa,
                                        long long sb, long long BE) {
  constexpr long long EPC = 16 / sizeof(T);
  return sb == 1 && sa % EPC == 0 && BE % EPC == 0 &&
         reinterpret_cast<uintptr_t>(G) % 16 == 0;
}

// Element by element, upcast by Cvt::up: S[a * ld_a + b * ld_b] = G[a * sa
// + b * sb], walking G's unit-stride axis first.
template <class Cvt, int A, int B, int NT, typename TS, typename T>
__device__ __forceinline__ void tile_scalar(TS* S, int ld_a, int ld_b,
                                            const T* G, long long sa,
                                            long long sb, long long a0,
                                            long long b0, long long AE,
                                            long long BE) {
  const bool bfast = sb == 1 || sa != 1;
  for (int e = threadIdx.x; e < A * B; e += NT) {
    const int a = bfast ? e / B : e % A;
    const int b = bfast ? e % B : e / A;
    const long long ga = a0 + a, gb = b0 + b;
    S[a * ld_a + b * ld_b] =
        (ga < AE && gb < BE) ? Cvt::up(G[ga * sa + gb * sb]) : TS(0.f);
  }
}

struct Bf16Id {
  static __device__ __forceinline__ __nv_bfloat16 up(__nv_bfloat16 v) {
    return v;
  }
};

// The p steps [lo, hi) of this rank's share of nsteps.
__device__ __forceinline__ void p_share(long long nsteps, int rank, int cs,
                                        long long& lo, long long& hi) {
  const long long per = (nsteps + cs - 1) / cs;
  lo = min(nsteps, per * rank);
  hi = min(nsteps, lo + per);
}

// ---------------------------------------------------------------------------
// bf16 body
// ---------------------------------------------------------------------------

// smem layout (elements): X ring, Y ring, Z tile, T (bf16), then the f32
// partial of T.  A tile's rows run along its unit-stride axis.
constexpr int LDX = 72;    // X [r][p] (64 + 8) or [p][r] (64 + 8)
constexpr int LDYQ = 72;   // Y [q][p]: CBQ rows of CBP
constexpr int LDYP = 136;  // Y [p][q]: CBP rows of CBQ
constexpr int LDZ = 136;   // Z [n][q] or [q][n]: 128 rows of 128
constexpr int LDT = 136;   // T [r][q] bf16
constexpr int LDTP = 132;  // partial T [r][q] f32
constexpr int X_EL = CBR * LDX;
constexpr int Y_EL = CBQ * LDYQ > CBP * LDYP ? CBQ * LDYQ : CBP * LDYP;
constexpr int Z_EL = 128 * LDZ;
constexpr int T_EL = CBR * LDT;
constexpr int BF16_SMEM =
    (STAGES * (X_EL + Y_EL) + Z_EL + T_EL) * 2 + CBR * LDTP * 4;

// XK: X is kept [p][r] (r its unit-stride axis), else [r][p]; YK: Y
// [p][q], else [q][p]; ZK: Z [q][n], else [n][q].  Y's layout, read in the
// inner loop, is a template flag; X's and Z's are uniform branches.
template <bool YK>
__global__ void __launch_bounds__(CTHREADS) chain_bf16_kernel(
    const ChainParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ys = Xs + STAGES * X_EL;
  __nv_bfloat16* Zs = Ys + STAGES * Y_EL;
  __nv_bfloat16* Tb = Zs + Z_EL;
  float* Tp = reinterpret_cast<float*>(Tb + T_EL);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (warp & 3) * 16;   // rows of T and of the output
  const int wq = (warp >> 2) * CWQ;  // columns of T
  const int wn = (warp >> 2) * CWN;  // output columns
  const long long R = p.R, P = p.P, Q = p.Q, N = p.N;
  const long long r0 = (long long)blockIdx.y * CBR;
  const long long n0 = (long long)blockIdx.x * CBN;
  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(p.X);
  const __nv_bfloat16* Y = static_cast<const __nv_bfloat16*>(p.Y);
  const __nv_bfloat16* Z = static_cast<const __nv_bfloat16*>(p.Z);
  const bool XK = p.sXr == 1 && p.sXp != 1;
  const bool ZK = p.sZn == 1 && p.sZq != 1;
  // each tile as (smem row axis, unit-stride axis): strides and extents
  const long long xa = XK ? p.sXp : p.sXr, xb = XK ? p.sXr : p.sXp;
  const long long ya = YK ? p.sYp : p.sYq, yb = YK ? p.sYq : p.sYp;
  const long long za = ZK ? p.sZq : p.sZn, zb = ZK ? p.sZn : p.sZq;
  const bool x_vec = can_vec<__nv_bfloat16>(X, xa, xb, XK ? R : P);
  const bool y_vec = can_vec<__nv_bfloat16>(Y, ya, yb, YK ? Q : P);
  const bool z_vec = can_vec<__nv_bfloat16>(Z, za, zb, ZK ? N : Q);
  long long s_lo, s_hi;
  p_share((P + CBP - 1) / CBP, rank, cs, s_lo, s_hi);
  const int nk = static_cast<int>(s_hi - s_lo);

  // stage p step s (absolute) of the q chunk at q0 into ring slot `slot`
  auto stage_xy = [=](int slot, long long s, long long q0) {
    const long long k0 = s * CBP;
    __nv_bfloat16* xs = Xs + slot * X_EL;
    __nv_bfloat16* ys = Ys + slot * Y_EL;
    if (XK) {  // [p][r]
      if (x_vec)
        tile_async<__nv_bfloat16, CBP, CBR, LDX, CTHREADS>(xs, X, xa, k0, r0,
                                                           P, R);
      else
        tile_scalar<Bf16Id, CBP, CBR, CTHREADS>(
            xs, LDX, 1, X, xa, xb, k0, r0, P, R);
    } else {  // [r][p]
      if (x_vec)
        tile_async<__nv_bfloat16, CBR, CBP, LDX, CTHREADS>(xs, X, xa, r0, k0,
                                                           R, P);
      else
        tile_scalar<Bf16Id, CBR, CBP, CTHREADS>(
            xs, LDX, 1, X, xa, xb, r0, k0, R, P);
    }
    if (YK) {  // [p][q]
      if (y_vec)
        tile_async<__nv_bfloat16, CBP, CBQ, LDYP, CTHREADS>(ys, Y, ya, k0, q0,
                                                            P, Q);
      else
        tile_scalar<Bf16Id, CBP, CBQ, CTHREADS>(
            ys, LDYP, 1, Y, ya, yb, k0, q0, P, Q);
    } else {  // [q][p]
      if (y_vec)
        tile_async<__nv_bfloat16, CBQ, CBP, LDYQ, CTHREADS>(ys, Y, ya, q0, k0,
                                                            Q, P);
      else
        tile_scalar<Bf16Id, CBQ, CBP, CTHREADS>(
            ys, LDYQ, 1, Y, ya, yb, q0, k0, Q, P);
    }
  };

  float acc[CWN / 8][4];
#pragma unroll
  for (int ni = 0; ni < CWN / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  const int sl = CBR / cs;  // rows of T this rank sums
  for (long long q0 = 0; q0 < Q; q0 += CBQ) {
    // this chunk's Z tile: its own cp.async group, ahead of the ring's
    if (ZK) {  // [q][n]
      if (z_vec)
        tile_async<__nv_bfloat16, CBQ, CBN, LDZ, CTHREADS>(Zs, Z, za, q0, n0,
                                                           Q, N);
      else
        tile_scalar<Bf16Id, CBQ, CBN, CTHREADS>(
            Zs, LDZ, 1, Z, za, zb, q0, n0, Q, N);
    } else {  // [n][q]
      if (z_vec)
        tile_async<__nv_bfloat16, CBN, CBQ, LDZ, CTHREADS>(Zs, Z, za, n0, q0,
                                                           N, Q);
      else
        tile_scalar<Bf16Id, CBN, CBQ, CTHREADS>(
            Zs, LDZ, 1, Z, za, zb, n0, q0, N, Q);
    }
    cp_async_commit();

    float tq[CWQ / 8][4];
#pragma unroll
    for (int ni = 0; ni < CWQ / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) tq[ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) stage_xy(s, s_lo + s, q0);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) stage_xy(nxt % STAGES, s_lo + nxt, q0);
      cp_async_commit();
      const __nv_bfloat16* xs = Xs + (kt % STAGES) * X_EL;
      const __nv_bfloat16* ys = Ys + (kt % STAGES) * Y_EL;
#pragma unroll
      for (int ks = 0; ks < CBP; ks += 16) {
        uint32_t af[4];
        load_a<LDX>(af, xs, wr, ks, lane, XK);
#pragma unroll
        for (int pq = 0; pq < CWQ / 16; ++pq) {
          uint32_t r[4];
          load_b2<YK ? LDYP : LDYQ>(r, ys, wq + pq * 16, ks, lane, YK);
          const uint32_t b0[2] = {r[0], r[1]};
          const uint32_t b1[2] = {r[2], r[3]};
          mma_16816(tq[2 * pq], af, b0);
          mma_16816(tq[2 * pq + 1], af, b1);
        }
      }
    }
    cp_async_wait<0>();

    // this rank's partial of T (e = 2h + j: row g + 8h, column 2t + j)
#pragma unroll
    for (int ni = 0; ni < CWQ / 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            &Tp[(wr + g + 8 * h) * LDTP + wq + ni * 8 + 2 * t]) =
            make_float2(tq[ni][2 * h], tq[ni][2 * h + 1]);
    cluster.sync();  // every partial written (and this CTA's Z landed)
    // sum this rank's rows over the ranks in rank order, round once
    for (int v = tid; v < sl * CBQ / 4; v += CTHREADS) {
      const int row = rank * sl + v / (CBQ / 4);
      const int col = (v % (CBQ / 4)) * 4;
      // every rank's value in flight at once, then summed in rank order
      float4 part[MAX_CLUSTER];
#pragma unroll
      for (int j = 0; j < MAX_CLUSTER; ++j)
        if (j < cs)
          part[j] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(&Tp[row * LDTP + col], j));
      float4 s4 = part[0];
#pragma unroll
      for (int j = 1; j < MAX_CLUSTER; ++j)
        if (j < cs) {
          s4.x += part[j].x;
          s4.y += part[j].y;
          s4.z += part[j].z;
          s4.w += part[j].w;
        }
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(&Tb[row * LDT + col]);
      d[0] = __floats2bfloat162_rn(s4.x, s4.y);
      d[1] = __floats2bfloat162_rn(s4.z, s4.w);
    }
    cluster.sync();  // every rank's slice of T is summed
    // gather the other ranks' slices
    for (int v = tid; v < CBR * CBQ / 8; v += CTHREADS) {
      const int row = v / (CBQ / 8);
      const int col = (v % (CBQ / 8)) * 8;
      const int owner = row / sl;
      if (owner == rank) continue;
      *reinterpret_cast<uint4*>(&Tb[row * LDT + col]) =
          *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(&Tb[row * LDT + col], owner));
    }
    __syncthreads();

    if (n0 < N) {
#pragma unroll
      for (int kk = 0; kk < CBQ / 16; ++kk) {
        uint32_t af[4];
        load_a<LDT>(af, Tb, wr, kk * 16, lane, false);
#pragma unroll
        for (int pn = 0; pn < CWN / 16; ++pn) {
          uint32_t r[4];
          load_b2<LDZ>(r, Zs, wn + pn * 16, kk * 16, lane, ZK);
          const uint32_t b0[2] = {r[0], r[1]};
          const uint32_t b1[2] = {r[2], r[3]};
          mma_16816(acc[2 * pn], af, b0);
          mma_16816(acc[2 * pn + 1], af, b1);
        }
      }
    }
    __syncthreads();  // Z and T are rewritten by the next chunk
  }
  cluster.sync();  // no CTA leaves while a peer may read its T

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = r0 + wr + g + 8 * h;
    if (r >= R) continue;
#pragma unroll
    for (int ni = 0; ni < CWN / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long n = n0 + wn + ni * 8 + 2 * t + j;
        if (n < N) store_out<float>(p, r, n, acc[ni][2 * h + j]);
      }
  }
}

// ---------------------------------------------------------------------------
// scalar body
// ---------------------------------------------------------------------------

template <typename TIn>
struct Scalar;  // TAcc and the upcast of each operand type
template <>
struct Scalar<float> {
  using TAcc = float;
  static __device__ __forceinline__ float up(float v) { return v; }
};
template <>
struct Scalar<int8_t> {
  using TAcc = int;
  static __device__ __forceinline__ int up(int8_t v) {
    return static_cast<int>(v);
  }
};
template <>
struct Scalar<uint8_t> {  // float8_e4m3fn bits
  using TAcc = float;
  static __device__ __forceinline__ float up(uint8_t v) {
    return fp8_to_f32(v);
  }
};
template <>
struct Scalar<int> {
  using TAcc = int;
  static __device__ __forceinline__ int up(int v) { return v; }
};

// compute tiles (TAcc) and their row lengths
constexpr int SLX = SBR + 1;  // Xc [p][r]
constexpr int SLY = SBQ + 1;  // Yc [p][q]
constexpr int SLZ = SBN + 1;  // Zc [q][n]
constexpr int SLT = SBQ + 1;  // Tc, Tp [r][q]
// raw ring (bytes): each tile as it lies, rows along its unit-stride axis
constexpr int RAW_X = SBR * SBP * 4;
constexpr int RAW_Y = SBP * SBQ * 4;
constexpr int RAW_Z = SBQ * SBN * 4;
constexpr int SCALAR_SMEM = STAGES * (RAW_X + RAW_Y) + RAW_Z +
                            4 * (SBP * SLX + SBP * SLY + SBQ * SLZ +
                                 2 * SBR * SLT);

// Upcast the raw tile R[a][b] (A x B, b its unit-stride axis) into
// S[a * la + b * lb].
template <typename TIn, int A, int B>
__device__ __forceinline__ void upcast(typename Scalar<TIn>::TAcc* S, int la,
                                       int lb, const TIn* Rw) {
  for (int e = threadIdx.x; e < A * B; e += STHREADS)
    S[(e / B) * la + (e % B) * lb] = Scalar<TIn>::up(Rw[e]);
}

template <typename TIn>
__global__ void __launch_bounds__(STHREADS) chain_scalar_kernel(
    const ChainParams p) {
  using TAcc = typename Scalar<TIn>::TAcc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* rx = smem_raw;                  // STAGES raw X
  unsigned char* ry = rx + STAGES * RAW_X;       // STAGES raw Y
  unsigned char* rz = ry + STAGES * RAW_Y;       // raw Z
  TAcc* Xc = reinterpret_cast<TAcc*>(rz + RAW_Z);  // [p][r]
  TAcc* Yc = Xc + SBP * SLX;                       // [p][q]
  TAcc* Zc = Yc + SBP * SLY;                       // [q][n]
  TAcc* Tp = Zc + SBQ * SLZ;                       // partial T [r][q]
  TAcc* Tc = Tp + SBR * SLT;                       // T [r][q]

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int ax = tid % 16;  // 4 x 4 outputs: rows ay + 16 i, cols ax + 16 j
  const int ay = tid / 16;
  const long long R = p.R, P = p.P, Q = p.Q, N = p.N;
  const long long r0 = (long long)blockIdx.y * SBR;
  const long long n0 = (long long)blockIdx.x * SBN;
  const TIn* X = static_cast<const TIn*>(p.X);
  const TIn* Y = static_cast<const TIn*>(p.Y);
  const TIn* Z = static_cast<const TIn*>(p.Z);
  // raw layouts: rows along the unit-stride axis (XR: X [r][p] raw, p unit)
  const bool XR = p.sXp == 1 || p.sXr != 1;
  const bool YQ = p.sYq == 1 && p.sYp != 1;  // Y [p][q] raw
  const bool ZN = p.sZn == 1 || p.sZq != 1;  // Z [q][n] raw
  const bool x_vec = XR ? can_vec<TIn>(X, p.sXr, p.sXp, P)
                        : can_vec<TIn>(X, p.sXp, p.sXr, R);
  const bool y_vec = YQ ? can_vec<TIn>(Y, p.sYp, p.sYq, Q)
                        : can_vec<TIn>(Y, p.sYq, p.sYp, P);
  const bool z_vec = ZN ? can_vec<TIn>(Z, p.sZq, p.sZn, N)
                        : can_vec<TIn>(Z, p.sZn, p.sZq, Q);
  long long s_lo, s_hi;
  p_share((P + SBP - 1) / SBP, rank, cs, s_lo, s_hi);
  const int nk = static_cast<int>(s_hi - s_lo);

  // p step s of the q chunk q0: raw copies into ring slot `slot`, or,
  // for an operand without 16-byte copies, straight into its compute tile
  auto stage_xy = [=](int slot, long long s, long long q0) {
    const long long k0 = s * SBP;
    TIn* xs = reinterpret_cast<TIn*>(rx + slot * RAW_X);
    TIn* ys = reinterpret_cast<TIn*>(ry + slot * RAW_Y);
    if (x_vec) {
      if (XR)
        tile_async<TIn, SBR, SBP, SBP, STHREADS>(xs, X, p.sXr, r0, k0, R, P);
      else
        tile_async<TIn, SBP, SBR, SBR, STHREADS>(xs, X, p.sXp, k0, r0, P, R);
    }
    if (y_vec) {
      if (YQ)
        tile_async<TIn, SBP, SBQ, SBQ, STHREADS>(ys, Y, p.sYp, k0, q0, P, Q);
      else
        tile_async<TIn, SBQ, SBP, SBP, STHREADS>(ys, Y, p.sYq, q0, k0, Q, P);
    }
  };
  // after the step's copies landed: its compute tiles
  auto upcast_xy = [=](int slot, long long s, long long q0) {
    const long long k0 = s * SBP;
    const TIn* xs = reinterpret_cast<const TIn*>(rx + slot * RAW_X);
    const TIn* ys = reinterpret_cast<const TIn*>(ry + slot * RAW_Y);
    if (!x_vec)
      tile_scalar<Scalar<TIn>, SBP, SBR, STHREADS>(Xc, SLX, 1, X, p.sXp,
                                                   p.sXr, k0, r0, P, R);
    else if (XR)
      upcast<TIn, SBR, SBP>(Xc, 1, SLX, xs);
    else
      upcast<TIn, SBP, SBR>(Xc, SLX, 1, xs);
    if (!y_vec)
      tile_scalar<Scalar<TIn>, SBP, SBQ, STHREADS>(Yc, SLY, 1, Y, p.sYp,
                                                   p.sYq, k0, q0, P, Q);
    else if (YQ)
      upcast<TIn, SBP, SBQ>(Yc, SLY, 1, ys);
    else
      upcast<TIn, SBQ, SBP>(Yc, 1, SLY, ys);
  };

  TAcc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int sl = SBR / cs;
  for (long long q0 = 0; q0 < Q; q0 += SBQ) {
    TIn* zs = reinterpret_cast<TIn*>(rz);
    if (z_vec) {
      if (ZN)
        tile_async<TIn, SBQ, SBN, SBN, STHREADS>(zs, Z, p.sZq, q0, n0, Q, N);
      else
        tile_async<TIn, SBN, SBQ, SBQ, STHREADS>(zs, Z, p.sZn, n0, q0, N, Q);
    }
    cp_async_commit();

    TAcc tq[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tq[i][j] = 0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) stage_xy(s, s_lo + s, q0);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // step kt landed; the compute tiles are free
      upcast_xy(kt % STAGES, s_lo + kt, q0);
      __syncthreads();  // compute tiles ready; slot kt - 1 is free
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) stage_xy(nxt % STAGES, s_lo + nxt, q0);
      cp_async_commit();
#pragma unroll 8
      for (int pp = 0; pp < SBP; ++pp) {
        TAcc a[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xc[pp * SLX + ay + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = Yc[pp * SLY + ax + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) tq[i][j] += a[i] * y[j];
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Tp[(ay + 16 * i) * SLT + ax + 16 * j] = tq[i][j];
    cluster.sync();  // every partial written (and this CTA's Z landed)
    for (int v = tid; v < sl * SBQ; v += STHREADS) {
      const int off = (rank * sl + v / SBQ) * SLT + v % SBQ;
      TAcc s = 0;
      for (int j = 0; j < cs; ++j) s += *cluster.map_shared_rank(&Tp[off], j);
      Tc[off] = s;
    }
    // this chunk's Z compute tile (its raw copies landed before the sync)
    if (!z_vec)
      tile_scalar<Scalar<TIn>, SBQ, SBN, STHREADS>(Zc, SLZ, 1, Z, p.sZq,
                                                   p.sZn, q0, n0, Q, N);
    else if (ZN)
      upcast<TIn, SBQ, SBN>(Zc, SLZ, 1, zs);
    else
      upcast<TIn, SBN, SBQ>(Zc, 1, SLZ, zs);
    cluster.sync();  // every rank's slice of T is summed
    for (int v = tid; v < SBR * SBQ; v += STHREADS) {
      const int row = v / SBQ;
      const int owner = row / sl;
      if (owner == rank) continue;
      const int off = row * SLT + v % SBQ;
      Tc[off] = *cluster.map_shared_rank(&Tc[off], owner);
    }
    __syncthreads();
    if (n0 < N) {
#pragma unroll 8
      for (int qq = 0; qq < SBQ; ++qq) {
        TAcc a[4], z[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Tc[(ay + 16 * i) * SLT + qq];
#pragma unroll
        for (int j = 0; j < 4; ++j) z[j] = Zc[qq * SLZ + ax + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * z[j];
      }
    }
    __syncthreads();  // Z, T and the compute tiles are rewritten next chunk
  }
  cluster.sync();  // no CTA leaves while a peer may read its T

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

// Launch Kernel on a grid of (column blocks, row blocks) in clusters of cs
// along the columns (the column count rounded up to a multiple of cs).
template <auto Kernel>
cudaError_t launch_clustered(int threads, int smem, long long cols,
                             long long rows, int cs, const ChainParams& p,
                             cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((cols + cs - 1) / cs * cs),
                     static_cast<unsigned>(rows));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, Kernel, p);
}

// The launch's cluster size: the plan's (``p.cluster``), else cluster_for's
// for the body's p steps of ``step``.
int cluster_of(const ChainParams& p, int step) {
  return p.cluster ? p.cluster : cluster_for((p.P + step - 1) / step);
}

cudaError_t launch_bf16(const ChainParams& p, cudaStream_t s) {
  const int cs = cluster_of(p, CBP);
  const long long cols = (p.N + CBN - 1) / CBN, rows = (p.R + CBR - 1) / CBR;
  // Y kept [p][q] when q is its unit-stride axis
  return p.sYq == 1 && p.sYp != 1
             ? launch_clustered<&chain_bf16_kernel<true>>(
                   CTHREADS, BF16_SMEM, cols, rows, cs, p, s)
             : launch_clustered<&chain_bf16_kernel<false>>(
                   CTHREADS, BF16_SMEM, cols, rows, cs, p, s);
}

template <typename TIn>
cudaError_t launch_scalar(const ChainParams& p, cudaStream_t s) {
  return launch_clustered<&chain_scalar_kernel<TIn>>(
      STHREADS, SCALAR_SMEM, (p.N + SBN - 1) / SBN, (p.R + SBR - 1) / SBR,
      cluster_of(p, SBP), p, s);
}

}  // namespace

extern "C" {

// Strides are in elements.  in_dtype 1 (bf16) runs the tensor-core body;
// 0, 2, 3, 4 the CUDA-core body (int32 accumulation for 2 and 4).  The
// cluster size is the plan's where ``cluster`` is set (a power of two up
// to MAX_CLUSTER: a rank whose share of p is empty adds a zero partial),
// else cluster_for's.  Returns
// the launch's error (0 = launched); nothing is synchronised or allocated
// here.
int chain_launch(const ChainParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int out = p->out_dtype;
  if (p->in_dtype < 0 || p->in_dtype > 4 ||
      (out != 0 && out != 1 && out != 4) ||
      (p->mean.p == nullptr) != (p->var.p == nullptr) || p->act < 0 ||
      p->act > 4 || p->cluster < 0 || p->cluster > MAX_CLUSTER ||
      (p->cluster & (p->cluster - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (p->in_dtype) {
    case 0:
      err = launch_scalar<float>(*p, s);
      break;
    case 1:
      err = launch_bf16(*p, s);
      break;
    case 2:
      err = launch_scalar<int8_t>(*p, s);
      break;
    case 3:
      err = launch_scalar<uint8_t>(*p, s);
      break;
    default:
      err = launch_scalar<int>(*p, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The CTA tile (rows, columns) of the body chosen for in_dtype, and its
// cluster size for a p reduction of extent P: the Python side sizes its
// grid checks and its association cost with them.
int chain_tile_m(int in_dtype) { return in_dtype == 1 ? CBR : SBR; }
int chain_tile_n(int in_dtype) { return in_dtype == 1 ? CBN : SBN; }
int chain_cluster(int in_dtype, long long P) {
  const int step = in_dtype == 1 ? CBP : SBP;
  return cluster_for((P + step - 1) / step);
}

// sizeof(ChainParams), checked against the ctypes mirror at load.
int chain_params_size(void) { return (int)sizeof(ChainParams); }

}  // extern "C"
