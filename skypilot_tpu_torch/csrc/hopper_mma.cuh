// Hopper (sm_90a) building blocks shared by the flash kernels: TMA
// tensor maps and loads, mbarriers, and bf16 warpgroup MMAs (wgmma)
// reading 128-byte-swizzled shared-memory tiles.
//
// Tile layout.  A [rows][d] bf16 tile lives in shared memory as d/64
// "panels", each [rows][64] (128 bytes a row) in the 128-byte swizzle
// that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes; every panel starts on
// a 1024-byte boundary (8 rows, one swizzle atom).  One TMA box fills
// one panel, so a tile of d 128 takes two loads.
//
// wgmma operands, all m64n64k16 with f32 accumulators:
// - K-major (the reduction dimension is d, contiguous in a row): the
//   k16 slice kk of panel kk/4 starts (kk%4)*32 bytes into the panel;
//   8-row groups are 1024 bytes apart (SBO).
// - MN-major (the reduction runs over rows, e.g. V in P·V): the k16
//   slice kk starts kk*16 rows = kk*2048 bytes into the panel, and a
//   64-wide n-chunk is one panel.
// - A from registers: the f32 accumulator of a previous product,
//   columns 16kk..16kk+15, packed as bf16 pairs (`pack_a`), is the A
//   fragment of k16 slice kk (the layouts line up: thread t of the
//   warpgroup holds rows 16(t/32) + (t%32)/4 and +8, columns
//   2(t%4) + 8j and +1).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace hopper {

// ------------------------------------------------------------ host side

// Raise `kernel`'s dynamic shared memory limit to `bytes`.
// cudaFuncSetAttribute acts on the calling thread's current device, so
// this runs once per (kernel, device): a mesh whose positions lie on
// several cards launches each kernel on each of them.
inline cudaError_t max_dynamic_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.insert({kernel, dev});
  return err;
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// the library needs no -lcuda.
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 [n, len, d] tensor with a box of
// [rows][64] (one panel).  Rows past `len` read as zeros and never
// spill into the next of the n slices.  Returns a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, int n, int len,
                    int d, int rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return (int)cudaErrorInitializationError;
  if (reinterpret_cast<uintptr_t>(base) % 16)
    return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)len, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)len * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of a phase, expecting `bytes` from TMA.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier has completed the phase of parity `phase`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
}

// One panel: box {64, rows, 1} at (d0, row, slice).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int row,
                                         int slice) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(d0),
      "r"(row), "r"(slice)
      : "memory");
}

// Every panel of a [rows][d] tile, the whole tile counted on `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int slice) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load(dst + p * ROWS * 128, map, bar, 64 * p, row, slice);
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major: LBO unused (1 by convention), SBO = one 8-row atom.
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return desc(p, 16, 1024);
}
// MN-major with a 64-wide n-chunk: one atom across, 8-row groups of
// the reduction 1024 bytes apart (both offsets name that stride).
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return desc(p, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous wgmma and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 slice kk from a 64x(16n) f32 accumulator.
template <int N>
__device__ __forceinline__ void pack_a(const float (&acc)[N], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

#define SKYT_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SKYT_ACC32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d[64x64] (+)= A[64x16] · B[16x64], A and B from shared memory.
// TB = 1 when B is MN-major.  Accumulates unless `accumulate` is 0.
template <int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SKYT_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : SKYT_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d[64x64] += A[64x16] · B[16x64], A from registers (`pack_a`).
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SKYT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SKYT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

#undef SKYT_D32
#undef SKYT_ACC32

// The first byte at or after p on a 1024-byte boundary (the swizzle
// atom; dynamic shared memory is only 16-byte aligned).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

}  // namespace hopper
