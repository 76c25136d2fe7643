// Ragged grouped GEMM out[n, :] = x[n, :] @ W[group(n)] for Hopper: the MoE
// expert products.
//
// Replaces the reference's Pallas kernel B3 (src/repro/codegen/fused_gen.py:
// _grouped_row_fn, pl.pallas_call at :243) in both of its orientations:
//   forward  out[n, f] = sum_k x[n, k] * W[g, k, f]
//   dX       out[n, k] = sum_f x[n, f] * W[g, k, f]   (W's contract axis last)
// The Python side (codegen/fused_gen.py) passes W's strides so that the
// contracted axis is "k" and the output axis "n" of the product; the dX
// orientation is the forward one with W's two trailing strides swapped.
// Rows are partitioned into contiguous groups; the host builds a table of
// the non-empty groups only (group id, first row, row count), so empty
// groups launch no CTA.
//
// The TPU kernel keeps a whole (N, C) x block and an (N, bn) f32 output
// block resident in VMEM while a sequential grid axis walks the groups.
// Hopper has no sequential grid, so here one CTA owns one (group, 128-column
// block) of the output: it reads its group's row range from the table,
// streams K through shared memory and keeps the f32 accumulator in
// registers.  The rows of a group are covered by one pass of up to 16 x MT
// rows (MT = 1, 2 or 4 m16 tiles, picked on the host from the largest
// group); a group larger than 64 rows takes several passes, each streaming
// its W tiles again.  Rows past the group's end are zero on load and
// masked on store, so ragged and size-1 groups come out exactly.
//
// What bounds it on the H100: on the serving path every expert's matrix is
// read once per call while each group holds only C = 4..16 rows, so a call
// moves the whole expert slab (kimi-k2: 384 x 7168 x 2048 bf16 = 11.27 GB,
// 3.37 ms at 3.35 TB/s) against 0.18 ms of bf16 tensor-core math at C = 16.
// It is bound by bytes at every shape on the path.  The design keeps the
// slab's bytes moving: W tiles stream with cp.async into a three-stage
// shared-memory ring (16-byte copies, so a CTA has two K steps in flight
// while it computes a third), each W element is read from device memory
// once per pass, and the x rows of a group (C x K, re-read by the group's
// column-block CTAs, which the grid schedules side by side) come from L2.
// Two bodies, chosen by the operand type:
//   * bf16 operands run on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//     accumulate), 4 warps of 32 columns.  The W tile is kept k-major as it
//     lies in memory ([k][n], rows padded to 136 elements so the eight rows
//     of an ldmatrix phase hit distinct banks) and reaches the B fragments
//     through ldmatrix.trans.  Without 16-byte alignment or unit strides
//     (the dX orientation, odd widths) the same body loads element-wise.
//   * f32 operands keep exact f32 math on the FMA pipes (16 rows x 64
//     columns a pass, 256 threads of 4 outputs each).
// Accumulation is f32; the store rounds once to the output type (round to
// nearest even for bf16), as the reference's f32 accumulator is cast once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// bf16 body (tensor cores)
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int LDX = BK + 8;  // padded x row: 80 bytes
constexpr int LDW = BN + 8;  // padded W row: 272 bytes

// f32 body (FMA pipes)
constexpr int F_BN = 64;
constexpr int F_RM = 16;
constexpr int F_BK = 32;
constexpr int F_THREADS = 256;

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// One K step of the bf16 body into one ring slot: the x rows [0, rows) of
// the pass (zero past them) and the W tile [k0, k0 + BK) x [n0, n0 + BN).
template <int RM, bool VEC>
__device__ __forceinline__ void load_tiles(
    __nv_bfloat16 (*xs)[LDX], __nv_bfloat16 (*ws)[LDW],
    const __nv_bfloat16* X, const __nv_bfloat16* Xp, const __nv_bfloat16* W,
    const __nv_bfloat16* Wg, int rows, int n0, int k0, int N, int K,
    long long sXm, long long sXk, long long sWk, long long sWn) {
  const int tid = threadIdx.x;
  if (VEC) {
    for (int v = tid; v < RM * (BK / 8); v += THREADS) {
      const int r = v >> 2;
      const int c = (v & 3) * 8;
      const bool ok = r < rows && k0 + c < K;
      cp_async16(&xs[r][c], ok ? Xp + r * sXm + k0 + c : X, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int kk = v >> 4;
      const int c = (v & 15) * 8;
      const bool ok = k0 + kk < K && n0 + c < N;
      cp_async16(&ws[kk][c], ok ? Wg + (k0 + kk) * sWk + n0 + c : W, ok);
    }
  } else {
    const bool k_fast = sWk == 1;  // walk k first where W is k-contiguous
    for (int e = tid; e < RM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const int k = k0 + c;
      xs[r][c] = (r < rows && k < K) ? Xp[r * sXm + k * sXk]
                                     : __float2bfloat16(0.f);
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = k_fast ? e % BK : e / BN;
      const int c = k_fast ? e / BK : e % BN;
      const int k = k0 + kk;
      const int n = n0 + c;
      ws[kk][c] = (k < K && n < N) ? Wg[k * sWk + n * sWn]
                                   : __float2bfloat16(0.f);
    }
  }
}

// VEC: x has unit stride along k and W along n, K and N are multiples of 8
// and every row starts 16-byte aligned, so 8 elements move as one cp.async.
template <typename TOut, int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
grouped_bf16_mma_kernel(const __nv_bfloat16* __restrict__ X,
                        const __nv_bfloat16* __restrict__ W,
                        TOut* __restrict__ O, const int* __restrict__ table,
                        int N, int K, long long sXm, long long sXk,
                        long long sWg, long long sWk, long long sWn,
                        long long sOm, long long sOn) {
  constexpr int RM = 16 * MT;
  __shared__ __align__(16) __nv_bfloat16 Xs[STAGES][RM][LDX];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Ws[STAGES][BK][LDW];  // [k][n]

  const int gid = table[3 * blockIdx.y];
  const int start = table[3 * blockIdx.y + 1];
  const int size = table[3 * blockIdx.y + 2];
  const int n0 = blockIdx.x * BN;
  const __nv_bfloat16* Wg = W + gid * sWg;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wn = warp * 32;
  const int nk = (K + BK - 1) / BK;

  for (int r0 = 0; r0 < size; r0 += RM) {
    const int rows = min(RM, size - r0);
    const __nv_bfloat16* Xp = X + (start + r0) * sXm;

    float acc[MT][4][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_tiles<RM, VEC>(Xs[s], Ws[s], X, Xp, W, Wg, rows, n0, s * BK, N,
                            K, sXm, sXk, sWk, sWn);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's)
      __syncthreads();              // ... and everyone's; slot kt-1 is free
      const int nxt = kt + STAGES - 1;
      if (nxt < nk)
        load_tiles<RM, VEC>(Xs[nxt % STAGES], Ws[nxt % STAGES], X, Xp, W, Wg,
                            rows, n0, nxt * BK, N, K, sXm, sXk, sWk, sWn);
      cp_async_commit();
      const int slot = kt % STAGES;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t bf[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, &Ws[slot][ks + (lane & 15)][wn + p * 16 + (lane >> 4) * 8]);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int r = mi * 16 + g;
          uint32_t af[4];
          af[0] = lds_u32(&Xs[slot][r][ks + 2 * t]);
          af[1] = lds_u32(&Xs[slot][r + 8][ks + 2 * t]);
          af[2] = lds_u32(&Xs[slot][r][ks + 2 * t + 8]);
          af[3] = lds_u32(&Xs[slot][r + 8][ks + 2 * t + 8]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af, bf[ni]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass's first loads reuse every slot

    // accumulator fragment: e = 2h + j holds row g + 8h, column 2t + j
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mi * 16 + g + 8 * h;
        if (row >= rows) continue;
        TOut* Orow = O + (start + r0 + row) * sOm;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = n0 + wn + ni * 8 + 2 * t + j;
            if (n < N) store_from_f32(Orow + n * sOn, acc[mi][ni][2 * h + j]);
          }
      }
  }
}

template <typename TOut>
__global__ void __launch_bounds__(F_THREADS)
grouped_f32_kernel(const float* __restrict__ X, const float* __restrict__ W,
                   TOut* __restrict__ O, const int* __restrict__ table, int N,
                   int K, long long sXm, long long sXk, long long sWg,
                   long long sWk, long long sWn, long long sOm, long long sOn) {
  __shared__ float Xs[F_BK][F_RM + 1];  // [k][m]
  __shared__ float Ws[F_BK][F_BN + 1];  // [k][n]

  const int gid = table[3 * blockIdx.y];
  const int start = table[3 * blockIdx.y + 1];
  const int size = table[3 * blockIdx.y + 2];
  const int n0 = blockIdx.x * F_BN;
  const float* Wg = W + gid * sWg;
  const int tid = threadIdx.x;
  const int tx = tid % F_BN;  // column
  const int ty = tid / F_BN;  // rows ty + 4 i
  const bool k_fast = sWk == 1;

  for (int r0 = 0; r0 < size; r0 += F_RM) {
    const int rows = min(F_RM, size - r0);
    const float* Xp = X + (start + r0) * sXm;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += F_BK) {
      for (int e = tid; e < F_RM * F_BK; e += F_THREADS) {
        const int r = e / F_BK;
        const int c = e % F_BK;
        const int k = k0 + c;
        Xs[c][r] = (r < rows && k < K) ? Xp[r * sXm + k * sXk] : 0.f;
      }
      for (int e = tid; e < F_BK * F_BN; e += F_THREADS) {
        const int kk = k_fast ? e % F_BK : e / F_BN;
        const int c = k_fast ? e / F_BK : e % F_BN;
        const int k = k0 + kk;
        const int n = n0 + c;
        Ws[kk][c] = (k < K && n < N) ? Wg[k * sWk + n * sWn] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < F_BK; ++kk) {
        const float b = Ws[kk][tx];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] = fmaf(Xs[kk][ty + 4 * i], b, acc[i]);
      }
      __syncthreads();
    }
    const int n = n0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 4 * i;
      if (row < rows && n < N)
        store_from_f32(O + (start + r0 + row) * sOm + n * sOn, acc[i]);
    }
  }
}

template <typename TOut, int MT>
void launch_bf16(const void* X, const void* W, void* O, const int* table,
                 dim3 grid, int N, int K, long long sXm, long long sXk,
                 long long sWg, long long sWk, long long sWn, long long sOm,
                 long long sOn, cudaStream_t stream) {
  const bool vec = sXk == 1 && sWn == 1 && K % 8 == 0 && N % 8 == 0 &&
                   sXm % 8 == 0 && sWk % 8 == 0 && sWg % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(X);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(W);
  TOut* o = static_cast<TOut*>(O);
  if (vec)
    grouped_bf16_mma_kernel<TOut, MT, true><<<grid, THREADS, 0, stream>>>(
        x, w, o, table, N, K, sXm, sXk, sWg, sWk, sWn, sOm, sOn);
  else
    grouped_bf16_mma_kernel<TOut, MT, false><<<grid, THREADS, 0, stream>>>(
        x, w, o, table, N, K, sXm, sXk, sWg, sWk, sWn, sOm, sOn);
}

template <typename TOut>
void launch_bf16_rows(int max_rows, const void* X, const void* W, void* O,
                      const int* table, int n_live, int N, int K,
                      long long sXm, long long sXk, long long sWg,
                      long long sWk, long long sWn, long long sOm,
                      long long sOn, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, n_live);
  if (max_rows <= 16)
    launch_bf16<TOut, 1>(X, W, O, table, grid, N, K, sXm, sXk, sWg, sWk, sWn,
                         sOm, sOn, stream);
  else if (max_rows <= 32)
    launch_bf16<TOut, 2>(X, W, O, table, grid, N, K, sXm, sXk, sWg, sWk, sWn,
                         sOm, sOn, stream);
  else
    launch_bf16<TOut, 4>(X, W, O, table, grid, N, K, sXm, sXk, sWg, sWk, sWn,
                         sOm, sOn, stream);
}

template <typename TOut>
void launch_f32(const void* X, const void* W, void* O, const int* table,
                int n_live, int N, int K, long long sXm, long long sXk,
                long long sWg, long long sWk, long long sWn, long long sOm,
                long long sOn, cudaStream_t stream) {
  const dim3 grid((N + F_BN - 1) / F_BN, n_live);
  grouped_f32_kernel<TOut><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const float*>(X), static_cast<const float*>(W),
      static_cast<TOut*>(O), table, N, K, sXm, sXk, sWg, sWk, sWn, sOm, sOn);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements.  table
// is a device array of n_live (group id, first row, row count) triples of
// the non-empty groups; max_rows is the largest row count among them.  W's
// element (g, k, n) of the product is W[g * sWg + k * sWk + n * sWn].
// Returns cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised, and nothing is allocated here.
int grouped_launch(int in_dtype, int out_dtype, const void* X, const void* W,
                   void* O, const int* table, int n_live, int max_rows, int N,
                   int K, long long sXm, long long sXk, long long sWg,
                   long long sWk, long long sWn, long long sOm, long long sOn,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      n_live < 1 || max_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      launch_f32<float>(X, W, O, table, n_live, N, K, sXm, sXk, sWg, sWk, sWn,
                        sOm, sOn, s);
      break;
    case 1:
      launch_f32<__nv_bfloat16>(X, W, O, table, n_live, N, K, sXm, sXk, sWg,
                                sWk, sWn, sOm, sOn, s);
      break;
    case 2:
      launch_bf16_rows<float>(max_rows, X, W, O, table, n_live, N, K, sXm,
                              sXk, sWg, sWk, sWn, sOm, sOn, s);
      break;
    case 3:
      launch_bf16_rows<__nv_bfloat16>(max_rows, X, W, O, table, n_live, N, K,
                                      sXm, sXk, sWg, sWk, sWn, sOm, sOn, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
