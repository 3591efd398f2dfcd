// Paged decode attention over one layer's KV page pool, for Hopper
// (sm_90a): a native-dtype kernel (B1) and an int8 kernel (B2).
//
// Replaces the Pallas kernels skypilot_tpu/ops/paged_attention.py:
// _paged_decode_kernel and _paged_decode_kernel_int8 (launched by
// _paged_attention_pallas).  Same function: for every slot b and
// kv-head g, the R = rep * S query rows (the rep q-heads of the group
// times the S query tokens; row r sits at absolute position
// lengths[b] + r % S) attend the slot's cache, which is the
// concatenation of the pool pages its block-table row names, with the
// mask kpos <= qpos; pages past position lengths[b] + S - 1 are never
// read.  One kernel serves S = 1 decode and the S = k + 1 speculative
// verify.  The int8 kernel multiplies each loaded value by its token's
// f32 scale in registers (dequant in f32, as the reference does).
//
// What bounds it on an H100: bytes.  Every live K and V page is read
// once per (slot, kv-head) - ps * d elements of 2 bytes (bf16) or 1
// byte plus a 4-byte scale per token (int8) - against 3.35 TB/s, while
// the arithmetic is ~4 * R FLOPs per element read.  What the design
// does about it: the GQA group's R query rows share each page load, so
// a page crosses device memory once per kv-head and not once per
// q-head; the block table is read in-kernel, so the gathered dense
// view the CPU reference builds never exists; int8 pools move int8.
// With one block per (slot, kv-head), a small batch leaves SMs idle;
// splitting long contexts across blocks (flash-decoding) is later work.
//
// Translation from the TPU kernel: its grid walks table rows in order
// on one core, carrying (m, l, acc) in VMEM scratch between pages.
// Here the page walk is a loop inside the block and the running
// statistics live in shared memory; the block loads its own table row
// and length (the TPU's scalar prefetch).  Every score is a sequential
// dot product by one thread and every output lane a sequential sum
// over the page's tokens, so a row's result does not depend on R: the
// speculative verify tick and a plain tick compute the same numbers
// for the same token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_floats(int R, int ps, int D) {
  // sQ [R][D+1], sK [ps][D+1], sV [ps][D], sS [R][ps+1], sAcc [R][D],
  // sM/sL/sCorr [R].
  return (size_t)R * (D + 1) + (size_t)ps * (D + 1) + (size_t)ps * D +
         (size_t)R * (ps + 1) + (size_t)R * D + 3 * (size_t)R;
}

// TQ: query/output type.  TKV: pool element type; int8_t pools carry
// per-token f32 scales (kscale/vscale [n_pages, h_kv, ps]), other pools
// pass null scales.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kpool,
    const TKV* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, TQ* __restrict__ out,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    int h_kv, int R, int S, int P, int ps, float sm_scale) {
  constexpr int DS = D + 1;
  const int SS = ps + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + R * DS;
  float* sV = sK + ps * DS;
  float* sS = sV + ps * D;
  float* sAcc = sS + R * SS;
  float* sM = sAcc + R * D;
  float* sL = sM + R;
  float* sCorr = sL + R;

  const int bg = blockIdx.x;  // slot * h_kv + kv-head
  const int b = bg / h_kv;
  const int g = bg - b * h_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  const int* table = tables + (size_t)b * P;

  const TQ* qp = q + (size_t)bg * R * D;
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    sQ[r * DS + c] = to_f(qp[i]) * sm_scale;
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  // Pages holding positions [0, length + S): ceil((length + S) / ps).
  const int n_pages = min(P, (length + S + ps - 1) / ps);
  for (int i = 0; i < n_pages; ++i) {
    const size_t base = ((size_t)table[i] * h_kv + g) * ps;
    __syncthreads();  // previous page fully consumed (and init done)
    for (int e = tid; e < ps * D; e += kThreads) {
      const int t = e / D, c = e - t * D;
      float kv = to_f(kpool[base * D + e]);
      float vv = to_f(vpool[base * D + e]);
      if (kscale != nullptr) {
        kv *= kscale[base + t];
        vv *= vscale[base + t];
      }
      sK[t * DS + c] = kv;
      sV[e] = vv;
    }
    __syncthreads();
    for (int e = tid; e < R * ps; e += kThreads) {
      const int r = e / ps, t = e - r * ps;
      const float* qrow = sQ + r * DS;
      const float* krow = sK + t * DS;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) s = fmaf(qrow[dd], krow[dd], s);
      const int kpos = i * ps + t;
      const int qpos = length + r % S;
      sS[r * SS + t] = kpos <= qpos ? s : kNegInf;
    }
    __syncthreads();
    // Online-softmax update, one warp per row.
    for (int r = warp; r < R; r += kWarps) {
      float* srow = sS + r * SS;
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, srow[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = expf(srow[t] - m_new);
        srow[t] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sCorr[r] = corr;
        sL[r] = sL[r] * corr + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < R * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const float* prow = sS + r * SS;
      float a = sAcc[e] * sCorr[r];
      for (int t = 0; t < ps; ++t) a = fmaf(prow[t], sV[t * D + c], a);
      sAcc[e] = a;
    }
  }
  __syncthreads();
  TQ* op = out + (size_t)bg * R * D;
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D;
    op[e] = from_f<TQ>(sAcc[e] / fmaxf(sL[r], 1e-30f));
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* out, const int* tables, const int* lengths,
           int B, int h_kv, int R, int S, int P, int ps, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(R, ps, D) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TKV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<TQ, TKV, D><<<B * h_kv, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<TQ*>(out), tables, lengths,
      h_kv, R, S, P, ps, sm_scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* ks, const void* vs, void* out, const int* tables,
               const int* lengths, int B, int h_kv, int R, int S, int P,
               int ps, float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, ks, vs, out, tables, lengths, B,
                                 h_kv, R, S, P, ps, sm_scale, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, ks, vs, out, tables, lengths, B,
                                  h_kv, R, S, P, ps, sm_scale, stream);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, ks, vs, out, tables, lengths, B,
                                  h_kv, R, S, P, ps, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int check_shape(int B, int h_kv, int R, int S, int P, int ps) {
  if (B <= 0 || h_kv <= 0 || R <= 0 || S <= 0 || R % S || P <= 0 ||
      ps <= 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// B1.  q/out [B, h_kv, R, d] in `dtype` (0 = float32, 1 = bfloat16); the
// pools [n_pages, h_kv, ps, d] in the same dtype; tables [B, P] and
// lengths [B] int32.  Returns a cudaError_t (0 on success).
extern "C" int skyt_paged_attention(const void* q, const void* k,
                                    const void* v, void* out,
                                    const int* tables, const int* lengths,
                                    int dtype, int B, int h_kv, int R, int S,
                                    int P, int ps, int d, float sm_scale,
                                    void* stream) {
  int rc = check_shape(B, h_kv, R, S, P, ps);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, float>(d, q, k, v, nullptr, nullptr, out,
                                    tables, lengths, B, h_kv, R, S, P, ps,
                                    sm_scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(
        d, q, k, v, nullptr, nullptr, out, tables, lengths, B, h_kv, R, S, P,
        ps, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// B2.  As B1 with int8 pools and f32 scales [n_pages, h_kv, ps]; q/out
// in `dtype` (0 = float32, 1 = bfloat16).
extern "C" int skyt_paged_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, void* out, const int* tables, const int* lengths,
    int dtype, int B, int h_kv, int R, int S, int P, int ps, int d,
    float sm_scale, void* stream) {
  int rc = check_shape(B, h_kv, R, S, P, ps);
  if (rc) return rc;
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, int8_t>(d, q, k, v, k_scale, v_scale, out,
                                     tables, lengths, B, h_kv, R, S, P, ps,
                                     sm_scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, int8_t>(d, q, k, v, k_scale, v_scale,
                                             out, tables, lengths, B, h_kv,
                                             R, S, P, ps, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
