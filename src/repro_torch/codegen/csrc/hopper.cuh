// Hopper building blocks of the ring bodies (contract.cu's bf16 ring and
// f32 tc32 ring, contract_q8.cu's 8-bit ring, attention.cu's bf16 ring,
// baselines.cu's ring of B5 and B7, grouped_dw.cu's ring of B4):
// mbarriers, TMA tensor loads and stores, wgmma descriptors (bf16, int8,
// e4m3 and tf32), the 3xTF32 split, fences and register rebalancing, and
// the host side of a TMA tensor map.  Header only; codegen/build.py hashes it
// into the library name of every source that includes it, so an edit
// rebuilds them.
//
// The skeleton B1's rings share (attention.cu's walks KV blocks on it):
// one CTA of three warpgroups owns a 128-row output tile.  Warpgroup 0
// gives its registers away (setmaxnreg) and one of
// its threads keeps TMA loads of the A and B tiles in flight into a ring of
// stages in dynamic shared memory; each stage has a "full" mbarrier (the
// TMA's bytes arrive on it) and an "empty" one (each consumer warpgroup
// arrives once its wgmmas on the stage have retired).  Warpgroups 1 and 2
// take 64 rows each and run wgmma on the stages as they fill, keeping one
// wgmma group in flight across K steps.  The tiles are 128-byte swizzled:
// row r of a 128-byte-row tile holds its 16-byte chunk c at (c ^ r % 8),
// 1024-byte aligned atoms of 8 rows, the layout TMA writes under
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads through a descriptor.
//
// The host encodes a tensor map with libcuda's cuTensorMapEncodeTiled,
// reached through the runtime's entry-point query
// (cudaGetDriverEntryPointByVersion): no source links libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// the inits, made visible to the other threads and to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive, and expect ``bytes`` of TMA transactions before the phase ends
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity ``parity`` to complete (a fresh barrier is
// in phase 0, so waiting on parity 1 returns at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// a named barrier over ``threads`` threads (the consumers; the producer
// warpgroup has left)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Grouped rasterization of a one-dimensional grid over gy x gx output
// tiles: tile ``t`` is row tile ``m_t``, column tile ``n_t``, the row tiles
// of a band of ``band`` walked first for each column tile in turn, so the
// CTAs resident together share a few B tiles and a few A row blocks
// through L2 (a row-major walk of a 48-tile-wide output reads all of B
// once per row of tiles).
__device__ __forceinline__ void raster(int t, int gx, int gy, int band,
                                       int& m_t, int& n_t) {
  const int per_band = band * gx;
  const int first = t / per_band * band;
  const int rows = min(band, gy - first);
  const int r = t - first * gx;
  m_t = first + r % rows;
  n_t = r / rows;
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The box of a 3-D map at coordinates (c0, c1, c2) into ``dst`` (1024-byte
// aligned), its bytes counted on ``bar``.  Elements outside the tensor are
// written as zeros and counted too.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// The box at (c0, c1, c2) of a 3-D map from ``src`` in shared memory
// (1024-byte aligned where the map swizzles) to device memory, in the
// thread's bulk group; elements outside the tensor are not written.  The
// caller fences its generic writes of ``src`` (fence_proxy_async) first.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of the thread's bulk groups still read their
// shared memory (the source may then be written again)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until every bulk group of the thread has completed (its writes
// done)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes of shared memory made visible to the async proxy
// (a wgmma's or a TMA store's reads) that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- 3xTF32 ---------------------------------------------------------------

// f32 rounded to TF32 (10 explicit mantissa bits), to nearest with ties
// away from zero (cvt.rna's rounding; two integer operations)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each rounded to TF32: together about 2^-21 of x (B2's tc32
// body, B1's tc32 body)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ---- wgmma ----------------------------------------------------------------

// Matrix descriptor of a 128-byte-swizzled tile at shared address ``addr``:
// leading and stride byte offsets.  K-major (rows of 128 bytes along k):
// lbo unused (16), sbo 1024 between 8-row atoms, and a k step of 32 bytes
// moves ``addr`` along the row.  MN-major (rows of 64 bf16 along m or n,
// one row per k): lbo the offset between 64-wide atoms, sbo 1024 between
// groups of 8 k rows, and a k16 step moves ``addr`` by 2048.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers in place around the asynchronous wgmma (the
// compiler must not move their reads or writes across a wait).
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(int& x) {
  asm volatile("" : "+r"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}
template <typename T, int R>
__device__ __forceinline__ void fence_regs(T (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_reg(d[i]);
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

#define HOPPER_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39," \
  "%40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39," \
  "%40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63," \
  "%64, %65, %66, %67, %68, %69, %70, %71," \
  "%72, %73, %74, %75, %76, %77, %78, %79," \
  "%80, %81, %82, %83, %84, %85, %86, %87," \
  "%88, %89, %90, %91, %92, %93, %94, %95," \
  "%96, %97, %98, %99, %100, %101, %102, %103," \
  "%104, %105, %106, %107, %108, %109, %110, %111," \
  "%112, %113, %114, %115, %116, %117, %118, %119," \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define HOPPER_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HOPPER_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_OP8(c, d, i)                                           \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),        \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define HOPPER_OP64(c, d)                                             \
  HOPPER_OP8(c, d, 0), HOPPER_OP8(c, d, 8), HOPPER_OP8(c, d, 16),     \
      HOPPER_OP8(c, d, 24), HOPPER_OP8(c, d, 32), HOPPER_OP8(c, d, 40), \
      HOPPER_OP8(c, d, 48), HOPPER_OP8(c, d, 56)
#define HOPPER_OP128(c, d)                                            \
  HOPPER_OP64(c, d), HOPPER_OP8(c, d, 64), HOPPER_OP8(c, d, 72),      \
      HOPPER_OP8(c, d, 80), HOPPER_OP8(c, d, 88), HOPPER_OP8(c, d, 96), \
      HOPPER_OP8(c, d, 104), HOPPER_OP8(c, d, 112), HOPPER_OP8(c, d, 120)
#define HOPPER_F "+f"
#define HOPPER_R "+r"

// d += A(64 x 16) . B(16 x 8, 16, 32, 64, 128 or 256), bf16 in, f32
// accumulate; TA / TB: A M-major / B N-major (transposed).  The narrow
// widths are decode's x^T (8 to 64 token columns).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[4], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[8], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " HOPPER_REGS8
      ", %8, %9, p, 1, 1, %11, %12;\n}\n"
      : HOPPER_OP8(HOPPER_F, d, 0)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_REGS16
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : HOPPER_OP8(HOPPER_F, d, 0), HOPPER_OP8(HOPPER_F, d, 8)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
// (accumulate 0: d = A . B, as the m64n128k16 form below)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_OP8(HOPPER_F, d, 0), HOPPER_OP8(HOPPER_F, d, 8),
        HOPPER_OP8(HOPPER_F, d, 16), HOPPER_OP8(HOPPER_F, d, 24)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}
// (accumulate 0: d = A . B, the accumulator's old values unread)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_REGS64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : HOPPER_OP64(HOPPER_F, d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_REGS128
      ", %128, %129, p, 1, 1, %131, %132;\n}\n"
      : HOPPER_OP128(HOPPER_F, d)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A(64 x 16, in registers) . B(16 x 128) from shared memory, bf16
// in, f32 accumulate.  ``a`` is the warp's 16-row slice in mma.m16n8k16's
// A fragment order (ldmatrix.x4's four 8 x 8 matrices: rows 0-7 and 8-15
// of k 0-7, then of k 8-15); TB: B N-major.  The registers must hold until
// the wgmma has retired (wgmma_wait).
template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : HOPPER_OP64(HOPPER_F, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB),
        "r"(1));
}

// The same at n256 (baselines.cu's B7 ring, a g-scaled A).
template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %134, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_REGS128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, %133;\n}\n"
      : HOPPER_OP128(HOPPER_F, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB),
        "r"(1));
}

// The same at n64 (attention.cu's P.V where e <= 64).
template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : HOPPER_OP8(HOPPER_F, d, 0), HOPPER_OP8(HOPPER_F, d, 8),
        HOPPER_OP8(HOPPER_F, d, 16), HOPPER_OP8(HOPPER_F, d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB),
        "r"(1));
}

// d += A(64 x 8, in registers) . B(8 x 128) from shared memory, tf32 in
// (the low 13 bits of each f32 word are not read), f32 accumulate.  ``a``
// is the warp's 16-row slice in mma.m16n8k8's tf32 A order: (row g, k t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4), g = lane / 4, t = lane % 4.  B is
// K-major only (tf32 takes no transpose bits): rows of 128 bytes along k,
// 128-byte swizzled, a k8 step 32 bytes along the row.  The registers
// must hold until the wgmma has retired (wgmma_wait).
// (accumulate 0: d = A . B, the accumulator's old values unread).  The
// narrower B (8, 16, 32 or 64 columns: n = 2 x the accumulator's length)
// are decode's x^T in B1's tc32 body.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t db,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " HOPPER_REGS8
      ", {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : HOPPER_OP8(HOPPER_F, d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " HOPPER_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : HOPPER_OP8(HOPPER_F, d, 0), HOPPER_OP8(HOPPER_F, d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HOPPER_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HOPPER_OP8(HOPPER_F, d, 0), HOPPER_OP8(HOPPER_F, d, 8),
        HOPPER_OP8(HOPPER_F, d, 16), HOPPER_OP8(HOPPER_F, d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HOPPER_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HOPPER_OP64(HOPPER_F, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += A(64 x 32) . B(32 x 128), int8 in, int32 accumulate (wraps modulo
// 2^32; no .satfinite)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_REGS64
      ", %64, %65, p;\n}\n"
      : HOPPER_OP64(HOPPER_R, d)
      : "l"(da), "l"(db), "r"(1));
}

// d = A(64 x 32) . B(32 x 128), e4m3 in, from zero (the caller adds d into
// its f32 accumulator)
__device__ __forceinline__ void wgmma_e4m3(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " HOPPER_REGS64
      ", %64, %65, p, 1, 1;\n}\n"
      : HOPPER_OP64(HOPPER_F, d)
      : "l"(da), "l"(db), "r"(0));
}

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A matrix operand as the rings take it: ``rows`` x ``cols`` elements of
// ``elem`` bytes, stride 1 along cols, ``row_stride`` elements along rows,
// ``batch`` matrices ``batch_stride`` elements apart.  Element strides.
struct Operand {
  const void* base;
  long long cols, rows, row_stride, batch, batch_stride;
};

// Can TMA read the operand: a 16-byte aligned base, and every stride of an
// axis longer than 1 a positive multiple of 16 bytes below 2^40.
inline bool tma_ok(const Operand& o, int elem) {
  const auto stride_ok = [&](long long extent, long long s) {
    return extent == 1 || (s > 0 && (s * elem) % 16 == 0 &&
                           s * elem < (1LL << 40));
  };
  return reinterpret_cast<uintptr_t>(o.base) % 16 == 0 && o.cols >= 1 &&
         o.rows >= 1 && o.batch >= 1 && stride_ok(o.rows, o.row_stride) &&
         stride_ok(o.batch, o.batch_stride);
}

// The 3-D map (cols, rows, batch) of ``o``, 128-byte swizzle (or none),
// zero fill out of bounds, boxes of box_cols x box_rows x 1.  The stride
// of an axis of extent 1 is never used; it is set to one TMA takes.
inline bool make_map(CUtensorMap* map, const Operand& o, int elem,
                     CUtensorMapDataType type, int box_cols, int box_rows,
                     bool swizzle = true) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || !tma_ok(o, elem)) return false;
  const auto up16 = [](long long bytes) { return (bytes + 15) / 16 * 16; };
  const long long rs =
      o.rows == 1 ? up16(o.cols * elem) : o.row_stride * elem;
  const long long bs =
      o.batch == 1 ? up16(rs * o.rows) : o.batch_stride * elem;
  const cuuint64_t dims[3] = {(cuuint64_t)o.cols, (cuuint64_t)o.rows,
                              (cuuint64_t)o.batch};
  const cuuint64_t strides[2] = {(cuuint64_t)rs, (cuuint64_t)bs};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const auto encoded = [&]() {
    return encode(map, type, 3, const_cast<void*>(o.base), dims, strides,
                  box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (encoded()) return true;
  // The encode checks the address against the calling thread's current
  // context, and a thread that has made no runtime call yet has none (a
  // fresh host thread; the autograd engine's, whose first work is this
  // launch): bind the device that holds the operand and encode again.
  cudaPointerAttributes at;
  return cudaPointerGetAttributes(&at, o.base) == cudaSuccess &&
         cudaSetDevice(at.device) == cudaSuccess && encoded();
}

}  // namespace hopper
