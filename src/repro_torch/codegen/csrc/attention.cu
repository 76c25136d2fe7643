// Kernel B2 for Hopper: flash attention over folded heads,
//   O[h, s, :] = sum_t softmax_t(Q[h, s, :] . K[h, t, :] * D^-0.5 + mask)
//                 V[h, t, :],
// Q (H, S, D), K (H, T, D), V (H, T, E), O (H, S, E), scores and softmax in
// f32, an optional causal mask (column <= row) and optional per-head
// kv_lengths (column < length).
//
// Replaces the reference's generated Pallas flash-attention kernel
// (src/repro/codegen/fused_gen.py: _attention_fn, pl.pallas_call at :140).
// That kernel walks a grid (H/bh, S/bs, T/bt) whose KV axis is last and
// sequential, carrying the running max m, sum l and the f32 accumulator in
// VMEM scratch from one grid step to the next.  Here one CTA owns one
// (head, 64-row block of s) and walks the KV axis itself in 64-column
// blocks, m, l and the accumulator in registers; nothing carries between
// CTAs.  The reference's semantics hold exactly:
//   * masked scores take the finite MASK_VALUE (-0.7 * FLT_MAX), so
//     exp(MASK - m) underflows to 0 and never makes a NaN, and masked
//     probabilities are re-zeroed, so a KV block masked in full at the start
//     of a row adds exp(0) = 1 to nothing;
//   * a row with l == 0 (kv_lengths 0) stores exact zeros;
//   * a CTA stops at the last KV block its rows can see (causal: its last
//     row; kv_lengths: the head's length, read by the CTA itself).  That is
//     exact: a skipped block would add alpha = 1 and p = 0.
// Any S and T (ragged edges zero-filled and masked), d and e up to 256.
//
//   * bf16 (attn_bf16_kernel<W>, W = max(d, e) rounded up to 64, 128 or
//     256): 4 warps of 16 rows.  Q.K^T on mma.sync m16n8k16 (bf16 in, f32
//     accumulate); the online softmax runs on the accumulator fragments
//     (quad shuffles for the row max, per-thread partial sums reduced once
//     at the end); P is rounded to bf16 in registers, and its accumulator
//     fragments are the A fragments of P.V's m16n8k16 (as the chain kernel
//     hands T from one mma to the next).  V reaches its B fragments through
//     ldmatrix.trans.  K and V tiles stream through a two-stage cp.async
//     ring (16-byte copies; element-wise loads when d or e is not a
//     multiple of 8 or a pointer or stride is not 16-byte aligned).  The
//     reference multiplies P and V in f32: rounding P to bf16 is held at
//     the bf16 tolerance.
//   * f32 (attn_f32_kernel<EP>): exact f32 on the FMA pipes, both products
//     as the reference computes them (TF32 would miss its f32 tolerance):
//     256 threads, each a 4 x 4 micro-tile of the 64 x 64 scores, then four
//     threads per row for the softmax, then a 4 x EP/16 micro-tile of the
//     accumulator; tiles are loaded synchronously.
//
// What bounds it on the H100: one qwen3-8b prefill's attention (128 folded
// heads, S = T = 512, d = e = 128, causal, bf16) does 8.6 GFLOP on 67 MB of
// q, k, v and o, 128 operations a byte, below the card's 295: the bytes
// bound it (0.020 ms at 3.35 TB/s).  A 4096-token prompt (32 heads) does
// 137 GFLOP on 134 MB and the tensor cores bound it (0.139 ms at 989
// TFLOP/s).  The design keeps the (S, T) scores and probabilities out of
// device memory, which is what the bound asks; it reads K and V once per
// 64-row block (from L2 for all but the first).  This first version is
// simple: mma.sync, not wgmma; Q fragments reloaded from shared memory for
// every KV block; the bf16 tiles need 46-169 KB of dynamic shared memory,
// so one or two CTAs share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;  // rows of s per CTA
constexpr int BC = 64;  // columns of t per KV block
constexpr int BF_THREADS = 128;
constexpr int F_THREADS = 256;
constexpr int MAX_HEAD = 256;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

struct AttnArgs {
  const void* Q;
  const void* K;
  const void* V;
  void* O;
  const int* lengths;  // (H,) int32 or nullptr
  int H, S, T, D, E;
  long long sQh, sQs, sKh, sKt, sVh, sVt, sOh, sOs;
  int causal;
  int out_dtype;  // 0 float32, 1 bfloat16
  int vec;        // bf16: 16-byte cp.async loads
};

// Columns [0, tlen) of head h can be valid: T, cut to the head's length.
__device__ __forceinline__ int kv_len(const AttnArgs& a, int h) {
  int t = a.T;
  if (a.lengths) t = min(t, max(a.lengths[h], 0));
  return t;
}

// The KV columns a CTA of rows [r0, r0 + BR) has to visit.
__device__ __forceinline__ int kv_stop(const AttnArgs& a, int tlen, int r0) {
  return a.causal ? min(tlen, r0 + BR) : tlen;
}

__device__ __forceinline__ void store_out(const AttnArgs& a, long long off,
                                          float y) {
  if (a.out_dtype == 1)
    static_cast<__nv_bfloat16*>(a.O)[off] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(a.O)[off] = y;
}

// ----------------------------------------------------------------------------
// bf16 body (tensor cores)
// ----------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; pred false writes zeros and reads nothing
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 b16 matrices, transposed: the m16n8k16 B fragments of two
// neighbouring n-tiles of a [k][n] tile
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

// Rows [row0, row0 + ROWS) x columns [0, ncols) of G (row stride ld) into
// T[r][c]; rows at or past nrows become zeros.  Columns past ncols are never
// written: the kernel zeroed them once.
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16 (*T)[LD],
                                          const __nv_bfloat16* G,
                                          long long ld, int row0, int nrows,
                                          int ncols, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int per_row = ncols / 8;
    for (int v = tid; v < ROWS * per_row; v += BF_THREADS) {
      const int r = v / per_row;
      const int c = (v - r * per_row) * 8;
      const bool ok = row0 + r < nrows;
      cp_async16(&T[r][c], ok ? G + (long long)(row0 + r) * ld + c : G, ok);
    }
  } else {
    for (int e = tid; e < ROWS * ncols; e += BF_THREADS) {
      const int r = e / ncols;
      const int c = e - r * ncols;
      T[r][c] = row0 + r < nrows ? G[(long long)(row0 + r) * ld + c]
                                 : __float2bfloat16(0.f);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(BF_THREADS) attn_bf16_kernel(
    const AttnArgs a) {
  constexpr int LD = W + 8;  // padded row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16(*Qs)[LD] = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem);
  __nv_bfloat16(*Ks)[LD] = Qs + BR;      // 2 slots of BC rows: [t][d]
  __nv_bfloat16(*Vs)[LD] = Ks + 2 * BC;  // 2 slots of BC rows: [t][e]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * 16;
  const int h = blockIdx.y;
  // heaviest causal row blocks first: they launch before the light ones
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int tlen = kv_len(a, h);
  const int nblk = (kv_stop(a, tlen, r0) + BC - 1) / BC;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.Q) + h * a.sQh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.K) + h * a.sKh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.V) + h * a.sVh;
  const bool vec = a.vec != 0;

  // zero every tile once: columns past d and e stay zero for good
  {
    uint4* s4 = reinterpret_cast<uint4*>(smem);
    const int n = (BR + 4 * BC) * LD * 2 / 16;
    for (int i = tid; i < n; i += BF_THREADS) s4[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_rows<BR, LD>(Qs, Q, a.sQs, r0, a.S, a.D, vec);
  if (nblk > 0) {
    load_rows<BC, LD>(Ks, K, a.sKt, 0, a.T, a.D, vec);
    load_rows<BC, LD>(Vs, V, a.sVt, 0, a.T, a.E, vec);
  }
  cp_async_commit();

  const int dk = (a.D + 15) & ~15;  // k extent of Q.K^T
  const int ek = (a.E + 15) & ~15;  // n extent of P.V
  const float scale = rsqrtf(static_cast<float>(a.D)) * LOG2E;
  float acc[W / 8][4];
#pragma unroll
  for (int ni = 0; ni < W / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
  float m[2] = {MASK_VALUE, MASK_VALUE};  // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};                // this thread's partial sums

  for (int j = 0; j < nblk; ++j) {
    const int slot = j & 1;
    if (j + 1 < nblk) {
      load_rows<BC, LD>(Ks + (slot ^ 1) * BC, K, a.sKt, (j + 1) * BC, a.T,
                        a.D, vec);
      load_rows<BC, LD>(Vs + (slot ^ 1) * BC, V, a.sVt, (j + 1) * BC, a.T,
                        a.E, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // block j (and Q) has landed (this thread's)
    __syncthreads();     // ... and everyone's
    const __nv_bfloat16(*Kt)[LD] = Ks + slot * BC;
    const __nv_bfloat16(*Vt)[LD] = Vs + slot * BC;

    float sc[BC / 8][4];
#pragma unroll
    for (int ni = 0; ni < BC / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[ni][e] = 0.f;
    for (int ks = 0; ks < dk; ks += 16) {
      uint32_t af[4];
      af[0] = lds_u32(&Qs[wr + g][ks + 2 * t4]);
      af[1] = lds_u32(&Qs[wr + g + 8][ks + 2 * t4]);
      af[2] = lds_u32(&Qs[wr + g][ks + 2 * t4 + 8]);
      af[3] = lds_u32(&Qs[wr + g + 8][ks + 2 * t4 + 8]);
#pragma unroll
      for (int ni = 0; ni < BC / 8; ++ni) {
        uint32_t bf[2];
        bf[0] = lds_u32(&Kt[ni * 8 + g][ks + 2 * t4]);
        bf[1] = lds_u32(&Kt[ni * 8 + g][ks + 2 * t4 + 8]);
        mma_16816(sc[ni], af, bf);
      }
    }

    // scale into the log2 domain, mask, and take the rows' block maxima;
    // fragment element e holds row g + 8 (e / 2), column 2 t4 + (e % 2)
    const int c0 = j * BC;
    float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int ni = 0; ni < BC / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + wr + g + 8 * (e >> 1);
        const int col = c0 + ni * 8 + 2 * t4 + (e & 1);
        const bool ok = col < tlen && (!a.causal || col <= row);
        const float s = ok ? sc[ni][e] * scale : MASK_VALUE;
        sc[ni][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
    // p = exp(s - m), re-zeroed where masked (a valid score is never the
    // mask value)
#pragma unroll
    for (int ni = 0; ni < BC / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sc[ni][e];
        const float p = s == MASK_VALUE ? 0.f : exp2f(s - m[e >> 1]);
        sc[ni][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int ni = 0; ni < W / 8; ++ni) {
      acc[ni][0] *= alpha[0];
      acc[ni][1] *= alpha[0];
      acc[ni][2] *= alpha[1];
      acc[ni][3] *= alpha[1];
    }

    // P (accumulator fragments, rounded to bf16) . V
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t af[4];
      af[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      af[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      af[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      af[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int nb = 0; nb < W / 16; ++nb) {
        if (nb * 16 >= ek) break;
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Vt[kk * 16 + (lane & 15)][nb * 16 +
                                                        (lane >> 4) * 8]);
        const uint32_t b0[2] = {r[0], r[1]};
        const uint32_t b1[2] = {r[2], r[3]};
        mma_16816(acc[2 * nb], af, b0);
        mma_16816(acc[2 * nb + 1], af, b1);
      }
    }
    __syncthreads();  // slot j is free for block j + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;  // fully masked row: 0 / 1
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + wr + g + 8 * r;
    if (row >= a.S) continue;
    const long long base = h * a.sOh + row * a.sOs;
#pragma unroll
    for (int ni = 0; ni < W / 8; ++ni)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = ni * 8 + 2 * t4 + jj;
        if (col < a.E) store_out(a, base + col, acc[ni][2 * r + jj] / l[r]);
      }
  }
}

// ----------------------------------------------------------------------------
// f32 body (FMA pipes)
// ----------------------------------------------------------------------------

template <int EP>
__global__ void __launch_bounds__(F_THREADS) attn_f32_kernel(
    const AttnArgs a) {
  constexpr int LQ = BR + 1;  // Qs[d][r], Ks[d][t]: padded, d-major
  constexpr int LS = BC + 1;  // Ss[r][t]
  extern __shared__ float smf[];
  const int D = a.D, E = a.E;
  float* Qs = smf;
  float* Ks = Qs + D * LQ;
  float* Vs = Ks + D * LS;  // [t][e], row stride E
  float* Ss = Vs + BC * E;
  float* Ms = Ss + BR * LS;  // running max per row
  float* Ls = Ms + BR;       // running sum per row
  float* As = Ls + BR;       // this block's rescale per row

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // scores: columns tx + 16 j; out: tx + 16 j
  const int ty = tid / 16;  // rows ty + 16 i
  const int h = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int tlen = kv_len(a, h);
  const int nblk = (kv_stop(a, tlen, r0) + BC - 1) / BC;
  const float* Q = static_cast<const float*>(a.Q) + h * a.sQh;
  const float* K = static_cast<const float*>(a.K) + h * a.sKh;
  const float* V = static_cast<const float*>(a.V) + h * a.sVh;
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  for (int e = tid; e < BR * D; e += F_THREADS) {
    const int r = e / D;
    const int c = e - r * D;
    Qs[c * LQ + r] = r0 + r < a.S ? Q[(long long)(r0 + r) * a.sQs + c] : 0.f;
  }
  if (tid < BR) {
    Ms[tid] = MASK_VALUE;
    Ls[tid] = 0.f;
  }
  float acc[4][EP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < EP / 16; ++j) acc[i][j] = 0.f;

  for (int blk = 0; blk < nblk; ++blk) {
    const int c0 = blk * BC;
    __syncthreads();  // the last block's tiles are read
    for (int e = tid; e < BC * D; e += F_THREADS) {
      const int r = e / D;
      const int c = e - r * D;
      Ks[c * LS + r] =
          c0 + r < a.T ? K[(long long)(c0 + r) * a.sKt + c] : 0.f;
    }
    for (int e = tid; e < BC * E; e += F_THREADS) {
      const int r = e / E;
      const int c = e - r * E;
      Vs[r * E + c] = c0 + r < a.T ? V[(long long)(c0 + r) * a.sVt + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[d * LQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[d * LS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = r0 + ty + 16 * i;
        const int col = c0 + tx + 16 * j;
        const bool ok = col < tlen && (!a.causal || col <= row);
        Ss[(ty + 16 * i) * LS + tx + 16 * j] =
            ok ? s[i][j] * scale : MASK_VALUE;
      }
    __syncthreads();

    // the online softmax: four neighbouring threads per row, 16 columns each
    {
      const int row = tid / 4;
      const int q = tid % 4;
      float* srow = Ss + row * LS + q * 16;
      float mx = MASK_VALUE;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = Ms[row];
      const float mn = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float v = srow[c];
        const float p = v == MASK_VALUE ? 0.f : expf(v - mn);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (q == 0) {
        const float alpha = expf(m_old - mn);
        Ms[row] = mn;
        Ls[row] = Ls[row] * alpha + sum;
        As[row] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = As[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < EP / 16; ++j) acc[i][j] *= al;
    }
    for (int tt = 0; tt < BC; ++tt) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * LS + tt];
#pragma unroll
      for (int j = 0; j < EP / 16; ++j) {
        const int col = tx + 16 * j;
        if (col < E) {
          const float vv = Vs[tt * E + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i;
    const int row = r0 + rr;
    if (row >= a.S) continue;
    float lv = Ls[rr];
    if (lv == 0.f) lv = 1.f;  // fully masked row: 0 / 1
    const long long base = h * a.sOh + row * a.sOs;
#pragma unroll
    for (int j = 0; j < EP / 16; ++j) {
      const int col = tx + 16 * j;
      if (col < E) store_out(a, base + col, acc[i][j] / lv);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           const AttnArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16.  Q (H, S, D), K (H, T, D), V (H, T,
// E), O (H, S, E), each unit-stride along its last axis; strides in
// elements.  lengths: nullptr or (H,) int32 on the device.  Returns
// cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised or allocated here.
int attention_launch(int in_dtype, int out_dtype, int causal, const void* Q,
                     const void* K, const void* V, void* O,
                     const int* lengths, int H, int S, int T, int D, int E,
                     long long sQh, long long sQs, long long sKh,
                     long long sKt, long long sVh, long long sVt,
                     long long sOh, long long sOs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1) ||
      H < 1 || H > 65535 || S < 1 || T < 0 || D < 1 || D > MAX_HEAD ||
      E < 1 || E > MAX_HEAD)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a;
  a.Q = Q;
  a.K = K;
  a.V = V;
  a.O = O;
  a.lengths = lengths;
  a.H = H;
  a.S = S;
  a.T = T;
  a.D = D;
  a.E = E;
  a.sQh = sQh;
  a.sQs = sQs;
  a.sKh = sKh;
  a.sKt = sKt;
  a.sVh = sVh;
  a.sVt = sVt;
  a.sOh = sOh;
  a.sOs = sOs;
  a.causal = causal;
  a.out_dtype = out_dtype;
  a.vec = D % 8 == 0 && E % 8 == 0 && aligned16(Q) && aligned16(K) &&
          aligned16(V) && sQh % 8 == 0 && sQs % 8 == 0 && sKh % 8 == 0 &&
          sKt % 8 == 0 && sVh % 8 == 0 && sVt % 8 == 0;
  const dim3 grid((unsigned)((S + BR - 1) / BR), (unsigned)H);
  const int w = D > E ? D : E;
  if (in_dtype == 1) {
    const int W = w <= 64 ? 64 : w <= 128 ? 128 : 256;
    const size_t smem = (size_t)(BR + 4 * BC) * (W + 8) * 2;
    if (W == 64)
      return launch(attn_bf16_kernel<64>, grid, BF_THREADS, smem, a, s);
    if (W == 128)
      return launch(attn_bf16_kernel<128>, grid, BF_THREADS, smem, a, s);
    return launch(attn_bf16_kernel<256>, grid, BF_THREADS, smem, a, s);
  }
  const size_t smem = (size_t)(D * (BR + 1) + D * (BC + 1) + BC * E +
                               BR * (BC + 1) + 3 * BR) *
                      sizeof(float);
  if (E <= 64) return launch(attn_f32_kernel<64>, grid, F_THREADS, smem, a, s);
  if (E <= 128)
    return launch(attn_f32_kernel<128>, grid, F_THREADS, smem, a, s);
  return launch(attn_f32_kernel<256>, grid, F_THREADS, smem, a, s);
}

}  // extern "C"
