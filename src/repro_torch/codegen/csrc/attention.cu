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
// (head, block of rows of s) and walks the KV axis itself, m, l and the
// accumulator in registers; nothing carries between CTAs.  The reference's
// semantics hold exactly in every body:
//   * masked scores take the finite MASK_VALUE (-0.7 * FLT_MAX), so
//     exp(MASK - m) underflows to 0 and never makes a NaN, and masked
//     probabilities are re-zeroed, so a KV block masked in full at the start
//     of a row adds exp(0) = 1 to nothing;
//   * a row with l == 0 (kv_lengths 0) stores exact zeros;
//   * a CTA stops at the last KV block its rows can see (causal: its last
//     row; kv_lengths: the head's length, read by the CTA itself).  That is
//     exact: a skipped block would add alpha = 1 and p = 0.
// Any S and T (ragged edges zero-filled and masked), d and e up to 256.
// The host picks one of four bodies by dtype, shape and layout
// (fused_gen.attention_body; attention_launch re-checks the rules and
// refuses a body they exclude):
//
//   * "ring" (attn_bf16_ring_kernel<DB, EB, BN>, bf16, d and e multiples
//     of 8 up to 128, q, k and v as TMA reads them): persistent CTAs of
//     three warpgroups, one an SM, on hopper.cuh's skeleton, each taking tiles
//     of (head, 128 rows of s) from a global counter in head order,
//     heaviest causal rows first.  One thread of warpgroup 0 (its
//     registers given away) keeps TMA loads in flight: a tile's Q, then
//     its K and V blocks of BN = 128 columns into a ring of stages (3 at d
//     = e = 128), each with a "full" mbarrier for K, one for V and an "empty"
//     one; the next tile's Q loads once the consumers are past the last
//     Q.K^T, under the tile's last P.V and its store.  Each map is 3-D (d,
//     s|t, head) with the caller's strides, so TMA zero-fills rows past S
//     or T within a head (ragged shapes, transposed views) and never reads
//     the next head; a box is 64 wide along d (the 128-byte swizzle), so d
//     > 64 takes two boxes, the second zero-filled past d.  Warpgroups 1
//     and 2 take 64 rows each: S = Q.K^T on wgmma m64n128k16 with both
//     operands in shared memory, K-major as they lie; the online softmax
//     on the accumulator fragments; P rounded to bf16 and packed from the
//     S fragments into register-A fragments; O += P.V on the register-A
//     wgmma (m64n128k16, or n64 where e <= 64), V N-major through the
//     MN-major descriptor.  Step j issues S_j, then P_{j-1}.V_{j-1}, and
//     runs S_j's softmax in place while the P.V runs; P_j is rounded into
//     the P.V's registers only after it retires: a register operand of a
//     wgmma written while it is in flight (C7513), or a wgmma issued under
//     a branch (C7520), makes ptxas serialize every wgmma of the kernel.
//     The two warpgroups interleave on the tensor cores too.
//   * "mma" (attn_bf16_kernel<W>, W = max(d, e) rounded up to 64, 128 or
//     256; every other bf16 call: d or e past 128, d not a multiple of 8,
//     unaligned or element-strided operands): 4 warps of 16 rows.  Q.K^T
//     on mma.sync m16n8k16 (bf16 in, f32 accumulate); the online softmax
//     on the accumulator fragments (quad shuffles for the row max,
//     per-thread partial sums reduced once at the end); P is rounded to
//     bf16 in registers, and its accumulator fragments are the A fragments
//     of P.V's m16n8k16.  V reaches its B fragments through
//     ldmatrix.trans.  K and V tiles stream through a two-stage cp.async
//     ring (16-byte copies; element-wise loads when d or e is not a
//     multiple of 8 or a pointer or stride is not 16-byte aligned).
//   * "tc32" (attn_f32_tc_kernel<DP, EP, BC>, f32, d and e up to 128,
//     padded with zeros to 64 or 128): 3xTF32 on the tensor cores, 8 warps
//     of 16 rows, KV blocks of BC = 32 columns.  Each operand is split into a hi and
//     a lo part, each rounded to TF32 (to nearest, ties away: cvt.rna's
//     rounding), and each product accumulates lo.hi + hi.lo + hi.hi in f32
//     on mma.sync m16n8k8: about 2^-21 relative, against TF32's 2^-11 that
//     would miss the f32 tolerance.  K and V land by cp.async and are split
//     once a block into shared memory for all 8 warps (hi and lo of two
//     elements in one 16-byte load); Q and P are split in registers.
//     Scores stay in the accumulator fragments for the softmax; P's
//     fragments feed P.V with the k axis permuted (slot t of a k8 step
//     holds column 2t, slot t + 4 column 2t + 1, V's rows split in the
//     same order), so no shuffle.  (tf32 wgmma takes only K-major
//     operands, and V is N-major.)
//   * "fma" (attn_f32_kernel<EP>, f32 with d or e past 128): exact f32 on
//     the FMA pipes: 256 threads, each a 4 x 4 micro-tile of the 64 x 64
//     scores, then four threads per row for the softmax, then a 4 x EP/16
//     micro-tile of the accumulator; tiles are loaded synchronously.
// Every launch of the ring or the 3xTF32 body runs a plan
// (attention_launch_plan, fused_gen.FusedPlan: the searched one, else
// fused_gen.attention_plan's) of two knobs: the ring's KV block (BN = 128
// or 64, the S fragments and P's k16 steps halved with it) and its
// persistent grid's CTA count, or the 3xTF32 body's KV block (BC = 32, or
// 64 where its tiles fit).  A smaller KV block moves the causal diagonal's
// masked work and the stages' depth; a wider one halves the softmax
// steps.
// The ring, mma and tc32 bodies share the online softmax (softmax_step).  The reference
// multiplies P and V in f32: the bf16 bodies' rounding of P to bf16 is held
// at the bf16 tolerance.
//
// What bounds it on the H100: one qwen3-8b prefill's attention (128 folded
// heads, S = T = 512, d = e = 128, causal, bf16) does 8.6 GFLOP on 67 MB of
// q, k, v and o, 128 operations a byte, below the card's 295: the bytes
// bound it (0.020 ms at 3.35 TB/s).  A 4096-token prompt (32 heads) does
// 137 GFLOP on 134 MB and the tensor cores bound it (0.139 ms at 989
// TFLOP/s).  Every body keeps the (S, T) scores and probabilities out of
// device memory, which is what the bound asks; each reads K and V once per
// block of rows (from L2 for all but the first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BR = 64;  // rows of s per CTA (mma and fma bodies)
constexpr int BC = 64;  // columns of t per KV block (mma and fma bodies)
constexpr int BF_THREADS = 128;
constexpr int F_THREADS = 256;
constexpr int MAX_HEAD = 256;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

// the bodies' codes (fused_gen.ATTENTION_BODIES)
constexpr int BODY_RING = 0, BODY_MMA = 1, BODY_TC32 = 2, BODY_FMA = 3;

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
  int vec;        // mma / tc32: 16-byte cp.async loads
  int* sched;     // ring: the next tile and the CTAs done, 0 between launches
};

// Columns [0, tlen) of head h can be valid: T, cut to the head's length.
__device__ __forceinline__ int kv_len(const AttnArgs& a, int h) {
  int t = a.T;
  if (a.lengths) t = min(t, max(a.lengths[h], 0));
  return t;
}

// The KV columns a CTA of rows [r0, r0 + rows) has to visit.
__device__ __forceinline__ int kv_stop(const AttnArgs& a, int tlen, int r0,
                                       int rows) {
  return a.causal ? min(tlen, r0 + rows) : tlen;
}

__device__ __forceinline__ bool visible(const AttnArgs& a, int tlen, int row,
                                        int col) {
  return col < tlen && (!a.causal || col <= row);
}

__device__ __forceinline__ void store_out(const AttnArgs& a, long long off,
                                          float y) {
  if (a.out_dtype == 1)
    static_cast<__nv_bfloat16*>(a.O)[off] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(a.O)[off] = y;
}

// two neighbouring outputs (off even, the row's extent even)
__device__ __forceinline__ void store_pair(const AttnArgs& a, long long off,
                                           float y0, float y1) {
  if (a.out_dtype == 1)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.O) +
                                       off) = __floats2bfloat162_rn(y0, y1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(a.O) + off) =
        make_float2(y0, y1);
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x to 2 ulp, a denormal result flushed to 0 (2^-inf = 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax's step on a thread's fragments of one KV block: ``sc``
// holds NF raw scores of rows ``row`` (even i / 2) and ``row + 8`` (odd
// i / 2), column col0 + 8 (i / 4) + (i % 2) -- the m16n8 accumulator
// layout of mma.sync and wgmma alike.  Masks (only where ``edge``: the
// block crosses the diagonal or the head's length), updates the running
// max ``m`` (log2 domain, quad shuffles) and this thread's partial sums
// ``l``, leaves p = 2^(s scale - m) in ``sc`` and returns each row's
// rescale in ``alpha``.  A masked score is -inf against a running max that
// starts at the finite MASK_VALUE, so its p is exactly 0 and 2^(m - m_new)
// never sees -inf - -inf: the values of the reference's finite mask with
// re-zeroed probabilities, one FFMA and one ex2 an element.
template <int NF>
__device__ __forceinline__ void softmax_step(float (&sc)[NF], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const AttnArgs& a, int tlen,
                                             int row, int col0, float scale,
                                             bool edge) {
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int r = (i >> 1) & 1;
    if (edge &&
        !visible(a, tlen, row + 8 * r, col0 + 8 * (i >> 2) + (i & 1)))
      sc[i] = neg_inf;
    mx[r] = fmaxf(mx[r], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * scale);
    alpha[r] = exp2_ftz(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int r = (i >> 1) & 1;
    const float p = exp2_ftz(fmaf(sc[i], scale, -m[r]));
    sc[i] = p;
    l[r] += p;
  }
}

// The rows' sums over the quad, 1 for a row with no visible column (its
// accumulator is 0: it stores 0 / 1).
__device__ __forceinline__ void finish_sums(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
  }
}

// ----------------------------------------------------------------------------
// bf16 ring body (TMA, mbarriers, wgmma)
// ----------------------------------------------------------------------------

constexpr int RG_BM = 128;  // rows of s per CTA
constexpr int RG_BN = 128;  // columns of t per KV block (the heuristic's)
constexpr int RG_BN_NARROW = 64;  // the KV block a plan may take instead
constexpr int RG_THREADS = 384;
constexpr int RG_BOX = 64;                // bf16 along d or e of one box
constexpr int RG_BOX_BYTES = 128 * 128;   // a box: 128 rows of 128 bytes
constexpr int RG_MAX_HEAD = 2 * RG_BOX;   // d and e up to 128
constexpr int SMEM_MAX = 232448;          // an H100 block's shared memory

// Shared memory of a ring CTA whose d takes DB boxes and e EB, on KV
// blocks of BN columns: Q, then each stage's K and V tiles (boxes of BN
// rows of 128 bytes; as many stages as fit, up to 4: 3 at d = e = 128 and
// BN = 128), then the barriers (Q's full and empty, the stages' full K,
// full V and empty) and the slot of the tile in hand, after 1024 bytes to
// align the tiles.
template <int DB, int EB, int BN>
struct RingLayout {
  static constexpr int KV_BOX = BN * 128;  // a K or V box
  static constexpr int Q = DB * RG_BOX_BYTES;
  static constexpr int KB = DB * KV_BOX;
  static constexpr int VB = EB * KV_BOX;
  static constexpr int STAGE = KB + VB;
  static constexpr int FIT = (SMEM_MAX - Q - 1024 - 15 * 8) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int TILES = Q + STAGES * STAGE;
  static constexpr int SMEM = TILES + 1024 + (2 + 3 * STAGES) * 8 + 8;
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "a ring of two stages");
};

// The fences of a step's registers: the compiler keeps their reads and
// writes on their side of a wgmma's issue and wait.
// (a thread's S fragments of a KV block of BN columns: BN / 2 floats; P's
// register-A fragments: BN / 16 k16 steps of four words)
template <int NS, int NO, int NP>
__device__ __forceinline__ void ring_fence(float (&sc)[NS], float (&o)[NO],
                                           uint32_t (&pa)[NP][4]) {
  hopper::fence_regs(sc);
  hopper::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) hopper::fence_regs(pa[kk]);
}

// O += P.V_j: BN / 16 register-A k16 steps over the stage's V tile
// (N-major boxes of 64 e, BN rows of 128 bytes apart), not committed
template <int NO, int NP>
__device__ __forceinline__ void ring_pv_issue(float (&o)[NO],
                                              uint32_t (&pa)[NP][4],
                                              uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < NP; ++kk)
    hopper::wgmma_bf16_rs<1>(
        o, pa[kk], hopper::desc(vt + kk * 2048, NP * 16 * 128, 1024));
}

// S = Q.K_j^T: the warpgroup's 64 rows of Q against the stage's BN rows
// of K, both K-major, DB boxes of four k16 steps, the first overwriting
// the accumulator, not committed
template <int DB, int NS>
__device__ __forceinline__ void ring_qk_issue(float (&sc)[NS], uint32_t qa,
                                              uint32_t kt) {
#pragma unroll
  for (int b = 0; b < DB; ++b)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::wgmma_bf16<0, 0>(
          sc, hopper::desc(qa + b * RG_BOX_BYTES + ks * 32, 16, 1024),
          hopper::desc(kt + b * NS * 2 * 128 + ks * 32, 16, 1024),
          b + ks > 0);
}

// The first step: S_0 alone, one group
template <int DB, int NS>
__device__ __forceinline__ void ring_qk(float (&sc)[NS], uint32_t qa,
                                        uint32_t kt) {
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
  ring_qk_issue<DB>(sc, qa, kt);
  hopper::wgmma_commit();
}

// A middle step: S_j, then O += P_{j-1}.V_{j-1}, two groups, so the
// softmax of S_j can start while the second runs
template <int DB, int NS, int NO, int NP>
__device__ __forceinline__ void ring_qk(float (&sc)[NS], uint32_t qa,
                                        uint32_t kt, float (&o)[NO],
                                        uint32_t (&pa)[NP][4], uint32_t vt) {
  ring_fence(sc, o, pa);
  hopper::wgmma_fence();
  ring_qk_issue<DB>(sc, qa, kt);
  hopper::wgmma_commit();
  ring_pv_issue(o, pa, vt);
  hopper::wgmma_commit();
}

// The last step's group: O += P.V alone
template <int NO, int NP>
__device__ __forceinline__ void ring_pv(float (&o)[NO], uint32_t (&pa)[NP][4],
                                        uint32_t vt) {
  hopper::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) hopper::fence_regs(pa[kk]);
  hopper::wgmma_fence();
  ring_pv_issue(o, pa, vt);
  hopper::wgmma_commit();
}

// S_j (columns c0 .. c0 + 2 NS) into P_j in place: the softmax step,
// masks only on a block that crosses the diagonal or the head's length;
// returns O's rescale in ``alpha``
template <int NS>
__device__ __forceinline__ void ring_softmax(float (&sc)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const AttnArgs& a, int tlen,
                                             int row, int col, int first,
                                             int c0, float scale) {
  const bool edge =
      c0 + 2 * NS > tlen || (a.causal && c0 + 2 * NS - 1 > first);
  softmax_step(sc, m, l, alpha, a, tlen, row, c0 + col, scale, edge);
}

// O rescaled and P rounded to bf16: the S fragments of columns 16 kk ..
// 16 kk + 15 are the register-A fragment of P.V's k16 step kk
template <int NS, int NO, int NP>
__device__ __forceinline__ void ring_rescale_pack(const float (&sc)[NS],
                                                  float (&o)[NO],
                                                  uint32_t (&pa)[NP][4],
                                                  const float (&alpha)[2]) {
  static_assert(NS == 8 * NP, "a k16 step of P is 8 S fragments");
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < NP; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// Tile t of the ring's persistent walk: head t / nrb, and within it the
// heaviest causal row block first.  CTAs take tiles in that order as they
// free up (a global counter): the tiles in flight share a few heads, whose
// K and V stay in L2, and the light tiles come last.
struct RingTile {
  int h, r0, tlen, nblk;
  __device__ __forceinline__ RingTile(const AttnArgs& a, int nrb, int t,
                                      int bn) {
    h = t / nrb;
    r0 = (nrb - 1 - (t - h * nrb)) * RG_BM;
    tlen = kv_len(a, h);
    nblk = (kv_stop(a, tlen, r0, RG_BM) + bn - 1) / bn;
  }
};

template <int DB, int EB, int BN>
__global__ void __launch_bounds__(RG_THREADS, 1)
    attn_bf16_ring_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV,
                          const AttnArgs a) {
  using L = RingLayout<DB, EB, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* tiles =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(tiles + L::TILES);
  uint64_t* qempty = qfull + 1;
  uint64_t* fullk = qempty + 1;
  uint64_t* fullv = fullk + L::STAGES;
  uint64_t* empty = fullv + L::STAGES;
  volatile int* slot = reinterpret_cast<int*>(empty + L::STAGES);  // tile
  const int nrb = (a.S + RG_BM - 1) / RG_BM;
  const int ntiles = nrb * a.H;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init(qempty, 2);  // one arrival per consumer group
    for (int s = 0; s < L::STAGES; ++s) {
      hopper::mbar_init(&fullk[s], 1);
      hopper::mbar_init(&fullv[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tmQ);
      hopper::tma_prefetch(&tmK);
      hopper::tma_prefetch(&tmV);
      int it = 0;  // K / V blocks loaded so far
      for (int tc = 0;; ++tc) {  // tiles handed to the consumers so far
        const int t = atomicAdd(a.sched, 1);
        // the consumers have read the last tile and are past its final
        // Q.K^T: the slot and Q's tile are free
        hopper::mbar_wait(qempty, (tc & 1) ^ 1);
        if (t >= ntiles) {
          *slot = -1;
          hopper::mbar_arrive(qfull);
          // the launch's last CTA sets the counter back for the next one
          if (atomicAdd(a.sched + 1, 1) == (int)gridDim.x - 1) {
            a.sched[0] = 0;
            a.sched[1] = 0;
          }
          break;
        }
        const RingTile tile(a, nrb, t, BN);
        *slot = t;
        if (tile.nblk == 0) {  // a head of length 0: zeros, no loads
          hopper::mbar_arrive(qfull);
          continue;
        }
        hopper::mbar_arrive_tx(qfull, L::Q);
#pragma unroll
        for (int b = 0; b < DB; ++b)
          hopper::tma_load(tiles + b * RG_BOX_BYTES, &tmQ, qfull, b * RG_BOX,
                           tile.r0, tile.h);
        for (int j = 0; j < tile.nblk; ++j, ++it) {
          const int s = it % L::STAGES;
          hopper::mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
          unsigned char* kt = tiles + L::Q + s * L::STAGE;
          hopper::mbar_arrive_tx(&fullk[s], L::KB);
#pragma unroll
          for (int b = 0; b < DB; ++b)
            hopper::tma_load(kt + b * L::KV_BOX, &tmK, &fullk[s],
                             b * RG_BOX, j * BN, tile.h);
          hopper::mbar_arrive_tx(&fullv[s], L::VB);
#pragma unroll
          for (int b = 0; b < EB; ++b)
            hopper::tma_load(kt + L::KB + b * L::KV_BOX, &tmV, &fullv[s],
                             b * RG_BOX, j * BN, tile.h);
        }
      }
    }
    return;
  }

  hopper::regs_inc<232>();
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int wg = ct >> 7;            // its warpgroup's 64 rows
  const int warp = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int col = 2 * (lane & 3);  // + 8 j (+ 1)
  const bool leader = ct % 128 == 0;
  const float scale = rsqrtf(static_cast<float>(a.D)) * LOG2E;
  const uint32_t base = hopper::smem_u32(tiles);
  const uint32_t qa = base + wg * 8192;  // 64 rows of 128 bytes a box
  const auto stage = [&](int i) { return base + L::Q + i * L::STAGE; };
  int it = 0;
  for (int tc = 0;; ++tc) {
    hopper::mbar_wait(qfull, tc & 1);  // a tile in the slot (and its Q)
    const int t = *slot;
    if (t < 0) break;
    const RingTile tile(a, nrb, t, BN);
    const int nblk = tile.nblk;
    const int first = tile.r0 + wg * 64 + warp * 16;  // the warp's first row
    const int row = first + (lane >> 2);              // and row + 8
    float o[EB * 32];
#pragma unroll
    for (int i = 0; i < EB * 32; ++i) o[i] = 0.f;
    float m[2] = {MASK_VALUE, MASK_VALUE};  // rows row, row + 8; log2
    float l[2] = {0.f, 0.f};                // this thread's partial sums
    float sc[BN / 2];
    float alpha[2];
    uint32_t pa[BN / 16][4];  // P of the block before, bf16: P.V's register A
    // Step j issues S_j = Q.K_j^T, then O += P_{j-1}.V_{j-1}, as two
    // groups; waits for S_j alone and runs its softmax in place while the
    // P.V runs; then waits for that, releases stage j - 1 (and Q after the
    // last S), rescales O and rounds P_j into pa.  The first step has no
    // P.V, the last (j = nblk) only P.V.  The two warpgroups interleave on
    // the tensor cores too.  No operand of a wgmma in flight is written,
    // and no wgmma is issued under a branch inside a step: either makes
    // ptxas serialize every wgmma of the kernel (C7513, C7520).
    if (nblk == 0 && leader) hopper::mbar_arrive(qempty);
    if (nblk > 0) {
      hopper::mbar_wait(&fullk[it % L::STAGES], (it / L::STAGES) & 1);
      ring_qk<DB>(sc, qa, stage(it % L::STAGES));
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (nblk == 1 && leader) hopper::mbar_arrive(qempty);
      ring_softmax(sc, m, l, alpha, a, tile.tlen, row, col, first, 0, scale);
      ring_rescale_pack(sc, o, pa, alpha);
      for (int j = 1; j < nblk; ++j) {
        const int s = (it + j) % L::STAGES;      // stage of block j
        const int sp = (it + j - 1) % L::STAGES;  // of block j - 1
        hopper::mbar_wait(&fullk[s], ((it + j) / L::STAGES) & 1);
        hopper::mbar_wait(&fullv[sp], ((it + j - 1) / L::STAGES) & 1);
        ring_qk<DB>(sc, qa, stage(s), o, pa, stage(sp) + L::KB);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        if (leader && j == nblk - 1) hopper::mbar_arrive(qempty);
        ring_softmax(sc, m, l, alpha, a, tile.tlen, row, col, first,
                     j * BN, scale);
        hopper::wgmma_wait<0>();
        ring_fence(sc, o, pa);
        if (leader) hopper::mbar_arrive(&empty[sp]);
        ring_rescale_pack(sc, o, pa, alpha);
      }
      const int sl = (it + nblk - 1) % L::STAGES;  // the last block's
      hopper::mbar_wait(&fullv[sl], ((it + nblk - 1) / L::STAGES) & 1);
      ring_pv(o, pa, stage(sl) + L::KB);
      hopper::wgmma_wait<0>();
      ring_fence(sc, o, pa);
      if (leader) hopper::mbar_arrive(&empty[sl]);
      it += nblk;
    }

    finish_sums(l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      if (rr >= a.S) continue;
      const long long off = tile.h * a.sOh + rr * a.sOs;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int jn = 0; jn < EB * 8; ++jn) {
        const int c = 8 * jn + col;  // e is a multiple of 8: c + 1 < E
        if (c < a.E)
          store_pair(a, off + c, o[4 * jn + 2 * r] * inv,
                     o[4 * jn + 2 * r + 1] * inv);
      }
    }
  }
}

// ----------------------------------------------------------------------------
// bf16 mma.sync body
// ----------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
  const int nblk = (kv_stop(a, tlen, r0, BR) + BC - 1) / BC;
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

    const int c0 = j * BC;
    float alpha[2];
    softmax_step(reinterpret_cast<float(&)[BC / 2]>(sc), m, l, alpha, a,
                 tlen, r0 + wr + g, c0 + 2 * t4, scale, true);
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

  finish_sums(l);
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
// f32 body on the tensor cores (3xTF32)
// ----------------------------------------------------------------------------

constexpr int TC_BR = 128;  // rows of s per CTA: 8 warps of 16
constexpr int TC_BC = 32;   // columns of t per KV block (the heuristic's)
constexpr int TC_BC_WIDE = 64;  // the KV block a plan may take instead
constexpr int TC_THREADS = 256;
constexpr int TC_MAX_HEAD = 128;

// The 3xTF32 body's shared memory, in floats, for d up to DP and e up to EP
// (64 or 128; columns past d and e are zeros) on KV blocks of BC columns
// (TC_BC, or TC_BC_WIDE where it fits: all but d = e = 128): Q as it lies (rows of DP +
// 8: a k8 step's float2 loads of a half-warp hit 32 distinct banks); the
// landing K and V blocks (cp.async); and the block split for the tensor
// cores, as float4s {hi, hi, lo, lo}: K's columns 2c and 2c + 1 of each
// row (rows of DP / 2 + 4 float4s), V's rows 2p and 2p + 1 of each column
// (rows of EP + 2) -- one conflict-free 16-byte load is a B fragment's hi
// and lo register pairs.
template <int DP, int EP, int BC>
struct TcLayout {
  static constexpr int LDQ = DP + 8, LDK4 = DP / 2 + 4, LDV4 = EP + 2;
  static constexpr int KRAW = TC_BR * LDQ;
  static constexpr int VRAW = KRAW + BC * DP;
  static constexpr int KS4 = VRAW + BC * EP;
  static constexpr int VS4 = KS4 + 4 * BC * LDK4;
  static constexpr int FLOATS = VS4 + 4 * (BC / 2) * LDV4;
  static constexpr bool FITS = FLOATS * 4 <= SMEM_MAX;
};

using hopper::split_tf32;  // hi + lo, each rounded to TF32 (hopper.cuh)

// {hi0, hi1, lo0, lo1}: a B fragment's hi and lo register pairs
__device__ __forceinline__ float4 split_pair(float x0, float x1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(x0, h0, l0);
  split_tf32(x1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32 from a pre-split B fragment x = {hi0, hi1, lo0,
// lo1}: the two small terms, then the large one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           float4 x) {
  const uint32_t bh[2] = {__float_as_uint(x.x), __float_as_uint(x.y)};
  const uint32_t bl[2] = {__float_as_uint(x.z), __float_as_uint(x.w)};
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Rows [row0, row0 + ROWS) x columns [0, ncols) of G (row stride ld) into
// T (row stride ldt); rows at or past nrows become zeros.  Columns past
// ncols are never written: the kernel zeroed them once.
template <int ROWS>
__device__ __forceinline__ void load_rows_f32(float* T, int ldt,
                                              const float* G, long long ld,
                                              int row0, int nrows, int ncols,
                                              bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int per_row = ncols / 4;
    for (int v = tid; v < ROWS * per_row; v += TC_THREADS) {
      const int r = v / per_row;
      const int c = (v - r * per_row) * 4;
      const bool ok = row0 + r < nrows;
      cp_async16(T + r * ldt + c, ok ? G + (long long)(row0 + r) * ld + c : G,
                 ok);
    }
  } else {
    for (int e = tid; e < ROWS * ncols; e += TC_THREADS) {
      const int r = e / ncols;
      const int c = e - r * ncols;
      T[r * ldt + c] =
          row0 + r < nrows ? G[(long long)(row0 + r) * ld + c] : 0.f;
    }
  }
}

template <int DP, int EP, int BC>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_f32_tc_kernel(
    const AttnArgs a) {
  using L = TcLayout<DP, EP, BC>;
  extern __shared__ __align__(16) float smt[];
  const float* Qs = smt;
  float* Kr = smt + L::KRAW;
  float* Vr = smt + L::VRAW;
  float4* Ks4 = reinterpret_cast<float4*>(smt + L::KS4);
  float4* Vs4 = reinterpret_cast<float4*>(smt + L::VS4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int first = (tid >> 5) * 16;  // the warp's first row in the CTA
  const int h = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * TC_BR;
  const int tlen = kv_len(a, h);
  const int nblk = (kv_stop(a, tlen, r0, TC_BR) + BC - 1) / BC;
  const float* Q = static_cast<const float*>(a.Q) + h * a.sQh;
  const float* K = static_cast<const float*>(a.K) + h * a.sKh;
  const float* V = static_cast<const float*>(a.V) + h * a.sVh;
  const bool vec = a.vec != 0;

  // zero Q and the landing tiles once: columns past d and e stay zero
  for (int i = tid; i < L::KS4 / 4; i += TC_THREADS)
    reinterpret_cast<float4*>(smt)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  load_rows_f32<TC_BR>(smt, L::LDQ, Q, a.sQs, r0, a.S, a.D, vec);
  if (nblk > 0) {
    load_rows_f32<BC>(Kr, DP, K, a.sKt, 0, a.T, a.D, vec);
    load_rows_f32<BC>(Vr, EP, V, a.sVt, 0, a.T, a.E, vec);
  }
  cp_async_commit();

  const float scale = rsqrtf(static_cast<float>(a.D)) * LOG2E;
  float acc[EP / 8][4];
#pragma unroll
  for (int ni = 0; ni < EP / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
  float m[2] = {MASK_VALUE, MASK_VALUE};  // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};                // this thread's partial sums

  for (int j = 0; j < nblk; ++j) {
    cp_async_wait<0>();  // block j (and Q) has landed (this thread's) ...
    __syncthreads();     // ... and everyone's; the split block j - 1 is read
    // split block j once for all warps: K by column pairs, V by row pairs
#pragma unroll
    for (int i = tid; i < BC * DP / 2; i += TC_THREADS) {
      const int r = i / (DP / 2), c = i % (DP / 2);
      const float2 x = reinterpret_cast<const float2*>(Kr + r * DP)[c];
      Ks4[r * L::LDK4 + c] = split_pair(x.x, x.y);
    }
#pragma unroll
    for (int i = tid; i < BC / 2 * EP; i += TC_THREADS) {
      const int p = i / EP, c = i % EP;
      Vs4[p * L::LDV4 + c] =
          split_pair(Vr[2 * p * EP + c], Vr[(2 * p + 1) * EP + c]);
    }
    __syncthreads();  // the split block is ready; the landing tiles free
    if (j + 1 < nblk) {
      load_rows_f32<BC>(Kr, DP, K, a.sKt, (j + 1) * BC, a.T, a.D, vec);
      load_rows_f32<BC>(Vr, EP, V, a.sVt, (j + 1) * BC, a.T, a.E, vec);
      cp_async_commit();
    }

    // S = Q.K^T; k slot t of a k8 step holds column 2t, slot t + 4 column
    // 2t + 1, for A (one float2 of Q, split here) and B (one float4 of
    // the split K) alike
    float sc[BC / 8][4];
#pragma unroll
    for (int ni = 0; ni < BC / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[ni][e] = 0.f;
    const float* qrow = Qs + (first + g) * L::LDQ + 2 * t4;
    const float4* krow = Ks4 + g * L::LDK4 + t4;
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks) {
      const float2 q0 = *reinterpret_cast<const float2*>(qrow + ks * 8);
      const float2 q1 =
          *reinterpret_cast<const float2*>(qrow + 8 * L::LDQ + ks * 8);
      uint32_t ah[4], al[4];
      split_tf32(q0.x, ah[0], al[0]);
      split_tf32(q1.x, ah[1], al[1]);
      split_tf32(q0.y, ah[2], al[2]);
      split_tf32(q1.y, ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < BC / 8; ++ni) {
        mma_3xtf32(sc[ni], ah, al, krow[ni * 8 * L::LDK4 + ks * 4]);
      }
    }

    const int c0 = j * BC;
    const bool edge = c0 + BC > tlen ||
                      (a.causal && c0 + BC - 1 > r0 + first);
    float alpha[2];
    softmax_step(reinterpret_cast<float(&)[BC / 2]>(sc), m, l, alpha, a,
                 tlen, r0 + first + g, c0 + 2 * t4, scale, edge);
#pragma unroll
    for (int ni = 0; ni < EP / 8; ++ni) {
      acc[ni][0] *= alpha[0];
      acc[ni][1] *= alpha[0];
      acc[ni][2] *= alpha[1];
      acc[ni][3] *= alpha[1];
    }

    // O += P.V: P's n-tile kk is the A fragment of k8 step kk, permuted as
    // above (slot t: column 2t, slot t + 4: 2t + 1); V's split row pair
    // 4 kk + t holds rows 8 kk + 2t and 8 kk + 2t + 1 to match
#pragma unroll
    for (int kk = 0; kk < BC / 8; ++kk) {
      uint32_t ph[4], pl[4];
      split_tf32(sc[kk][0], ph[0], pl[0]);
      split_tf32(sc[kk][2], ph[1], pl[1]);
      split_tf32(sc[kk][1], ph[2], pl[2]);
      split_tf32(sc[kk][3], ph[3], pl[3]);
      const float4* vrow = Vs4 + (4 * kk + t4) * L::LDV4 + g;
#pragma unroll
      for (int ni = 0; ni < EP / 8; ++ni)
        mma_3xtf32(acc[ni], ph, pl, vrow[ni * 8]);
    }
  }

  finish_sums(l);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + first + g + 8 * r;
    if (row >= a.S) continue;
    const long long base = h * a.sOh + row * a.sOs;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int ni = 0; ni < EP / 8; ++ni)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = ni * 8 + 2 * t4 + jj;
        if (col < a.E) store_out(a, base + col, acc[ni][2 * r + jj] * inv);
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
  const int nblk = (kv_stop(a, tlen, r0, BR) + BC - 1) / BC;
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

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The ring's three tensor maps: (d, s, head) of Q, (d, t, head) of K and
// (e, t, head) of V, boxes of 64 x 128 x 1 (64 x bn x 1 for K and V);
// false where TMA cannot read one (hopper::tma_ok: 16-byte aligned data,
// every stride of an axis longer than 1 a positive multiple of 16 bytes).
bool ring_maps(const AttnArgs& a, CUtensorMap* tq, CUtensorMap* tk,
               CUtensorMap* tv, int bn) {
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const hopper::Operand q{a.Q, a.D, a.S, a.sQs, a.H, a.sQh};
  const hopper::Operand k{a.K, a.D, a.T, a.sKt, a.H, a.sKh};
  const hopper::Operand v{a.V, a.E, a.T, a.sVt, a.H, a.sVh};
  return hopper::make_map(tq, q, 2, bf16, RG_BOX, RG_BM) &&
         hopper::make_map(tk, k, 2, bf16, RG_BOX, bn) &&
         hopper::make_map(tv, v, 2, bf16, RG_BOX, bn);
}

template <int DP, int EP, int BC>
int launch_tc32(const AttnArgs& a, cudaStream_t s) {
  static_assert(TcLayout<DP, EP, BC>::FITS, "the 3xTF32 body's tiles fit");
  const dim3 grid((unsigned)((a.S + TC_BR - 1) / TC_BR), (unsigned)a.H);
  return launch(attn_f32_tc_kernel<DP, EP, BC>, grid, TC_THREADS,
                TcLayout<DP, EP, BC>::FLOATS * sizeof(float), s, a);
}

// The 3xTF32 body at d up to DP and e up to EP on KV blocks of ``block``
// columns (TC_BC or TC_BC_WIDE where its tiles fit)
template <int DP, int EP>
int launch_tc32_block(const AttnArgs& a, int block, cudaStream_t s) {
  if (block == TC_BC) return launch_tc32<DP, EP, TC_BC>(a, s);
  if constexpr (TcLayout<DP, EP, TC_BC_WIDE>::FITS) {
    if (block == TC_BC_WIDE) return launch_tc32<DP, EP, TC_BC_WIDE>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ``ctas`` persistent CTAs (at most one a tile) on KV blocks of BN columns
template <int DB, int EB, int BN>
int launch_ring(const AttnArgs& a, const CUtensorMap& tq,
                const CUtensorMap& tk, const CUtensorMap& tv, int ctas,
                cudaStream_t s) {
  const int nrb = (a.S + RG_BM - 1) / RG_BM;
  if ((long long)nrb * a.H > 0x7fffffff || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = nrb * a.H < ctas ? nrb * a.H : ctas;
  return launch(attn_bf16_ring_kernel<DB, EB, BN>, dim3((unsigned)grid),
                RG_THREADS, RingLayout<DB, EB, BN>::SMEM, s, tq, tk, tv, a);
}

template <int BN>
int launch_ring_heads(const AttnArgs& a, int ctas, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!ring_maps(a, &tq, &tk, &tv, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.D <= RG_BOX)
    return a.E <= RG_BOX ? launch_ring<1, 1, BN>(a, tq, tk, tv, ctas, s)
                         : launch_ring<1, 2, BN>(a, tq, tk, tv, ctas, s);
  return a.E <= RG_BOX ? launch_ring<2, 1, BN>(a, tq, tk, tv, ctas, s)
                       : launch_ring<2, 2, BN>(a, tq, tk, tv, ctas, s);
}

// One launch of ``body`` on the plan (``block``, ``ctas``); the arguments
// as attention_launch_plan's below.
int attention_run(int block, int ctas, int in_dtype, int out_dtype,
                  int causal, int body, const void* Q, const void* K,
                  const void* V, void* O, const int* lengths, int* sched,
                  int H, int S, int T, int D, int E, long long sQh,
                  long long sQs, long long sKh, long long sKt, long long sVh,
                  long long sVt, long long sOh, long long sOs,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1) ||
      H < 1 || H > 65535 || S < 1 || T < 0 || D < 1 || D > MAX_HEAD ||
      E < 1 || E > MAX_HEAD)
    return invalid;
  const bool bf16 = in_dtype == 1;
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
  a.vec = 0;
  a.sched = sched;

  if (body == BODY_RING) {
    // paired stores: even output strides, 8-byte aligned output
    if (!bf16 || D % 8 || E % 8 || D > RG_MAX_HEAD || E > RG_MAX_HEAD ||
        T < 1 || sOh % 2 || sOs % 2 || reinterpret_cast<uintptr_t>(O) % 8 ||
        !sched)
      return invalid;
    if (block == RG_BN) return launch_ring_heads<RG_BN>(a, ctas, s);
    if (block == RG_BN_NARROW)
      return launch_ring_heads<RG_BN_NARROW>(a, ctas, s);
    return invalid;
  }
  if ((block != 0 || ctas != 0) && body != BODY_TC32)
    return invalid;  // a body that takes no plan
  if (body == BODY_MMA) {
    if (!bf16) return invalid;
    a.vec = D % 8 == 0 && E % 8 == 0 && aligned16(Q) && aligned16(K) &&
            aligned16(V) && sQh % 8 == 0 && sQs % 8 == 0 && sKh % 8 == 0 &&
            sKt % 8 == 0 && sVh % 8 == 0 && sVt % 8 == 0;
    const dim3 grid((unsigned)((S + BR - 1) / BR), (unsigned)H);
    const int w = D > E ? D : E;
    const int W = w <= 64 ? 64 : w <= 128 ? 128 : 256;
    const size_t smem = (size_t)(BR + 4 * BC) * (W + 8) * 2;
    if (W == 64)
      return launch(attn_bf16_kernel<64>, grid, BF_THREADS, smem, s, a);
    if (W == 128)
      return launch(attn_bf16_kernel<128>, grid, BF_THREADS, smem, s, a);
    return launch(attn_bf16_kernel<256>, grid, BF_THREADS, smem, s, a);
  }
  if (body == BODY_TC32) {
    if (bf16 || D > TC_MAX_HEAD || E > TC_MAX_HEAD) return invalid;
    a.vec = D % 4 == 0 && E % 4 == 0 && aligned16(Q) && aligned16(K) &&
            aligned16(V) && sQh % 4 == 0 && sQs % 4 == 0 && sKh % 4 == 0 &&
            sKt % 4 == 0 && sVh % 4 == 0 && sVt % 4 == 0;
    if (ctas != 0) return invalid;  // one CTA a (head, row block)
    if (D <= 64)
      return E <= 64 ? launch_tc32_block<64, 64>(a, block, s)
                     : launch_tc32_block<64, 128>(a, block, s);
    return E <= 64 ? launch_tc32_block<128, 64>(a, block, s)
                   : launch_tc32_block<128, 128>(a, block, s);
  }
  if (body == BODY_FMA) {
    if (bf16) return invalid;
    const dim3 grid((unsigned)((S + BR - 1) / BR), (unsigned)H);
    const size_t smem = (size_t)(D * (BR + 1) + D * (BC + 1) + BC * E +
                                 BR * (BC + 1) + 3 * BR) *
                        sizeof(float);
    if (E <= 64)
      return launch(attn_f32_kernel<64>, grid, F_THREADS, smem, s, a);
    if (E <= 128)
      return launch(attn_f32_kernel<128>, grid, F_THREADS, smem, s, a);
    return launch(attn_f32_kernel<256>, grid, F_THREADS, smem, s, a);
  }
  return invalid;
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16; body: 0 ring, 1 mma, 2 tc32, 3 fma
// (the header's bodies; fused_gen.attention_body picks one).  The plan
// (fused_gen.FusedPlan): the ring takes a KV block of ``block`` = RG_BN or
// RG_BN_NARROW columns and a persistent grid of ``ctas`` >= 1 CTAs (at
// most one a tile); the 3xTF32 body a KV block of TC_BC or TC_BC_WIDE
// columns (the latter where its tiles fit: not at d = e = 128) and
// ``ctas`` 0; the mma.sync and FMA bodies take no plan (``block`` and
// ``ctas`` 0).  Q (H, S, D), K (H, T, D), V (H, T, E), O (H, S, E), each
// unit-stride along its last axis; strides in elements.  lengths: nullptr
// or (H,) int32 on the device.  sched: two int32 on the device, zero
// before the first launch, which the ring's launches take tiles from and
// leave at zero (launches that share them must be ordered on one stream).
// A body or a plan the call cannot take is refused with
// cudaErrorInvalidValue, never swapped for another.  Returns
// cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised or allocated here.
int attention_launch_plan(int block, int ctas, int in_dtype, int out_dtype,
                          int causal, int body, const void* Q, const void* K,
                          const void* V, void* O, const int* lengths,
                          int* sched, int H, int S, int T, int D, int E,
                          long long sQh, long long sQs, long long sKh,
                          long long sKt, long long sVh, long long sVt,
                          long long sOh, long long sOs, void* stream) {
  return attention_run(block, ctas, in_dtype, out_dtype, causal, body, Q, K,
                       V, O, lengths, sched, H, S, T, D, E, sQh, sQs, sKh,
                       sKt, sVh, sVt, sOh, sOs, stream);
}

// attention_launch_plan on fused_gen.attention_plan's plan for ``body``
// (the ring's RG_BN on one CTA an SM, the 3xTF32 body's TC_BC): a
// launch of a named body for callers that hold no plan.
int attention_launch(int in_dtype, int out_dtype, int causal, int body,
                     const void* Q, const void* K, const void* V, void* O,
                     const int* lengths, int* sched, int H, int S, int T,
                     int D, int E, long long sQh, long long sQs,
                     long long sKh, long long sKt, long long sVh,
                     long long sVt, long long sOh, long long sOs,
                     void* stream) {
  int block = 0, ctas = 0;
  if (body == BODY_RING) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&ctas, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return static_cast<int>(cudaErrorInvalidValue);
    block = RG_BN;
  } else if (body == BODY_TC32) {
    block = TC_BC;
  }
  return attention_run(block, ctas, in_dtype, out_dtype, causal, body, Q, K,
                       V, O, lengths, sched, H, S, T, D, E, sQh, sQs, sKh,
                       sKt, sVh, sVt, sOh, sOs, stream);
}

}  // extern "C"
