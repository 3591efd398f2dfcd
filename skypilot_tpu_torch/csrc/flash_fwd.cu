// Causal flash-attention forward with GQA, for Hopper (sm_90a).
//
// Replaces the Pallas kernel skypilot_tpu/ops/attention.py:
// _flash_fwd_kernel (launched by _flash_fwd_pallas).  Same function:
// out = softmax(scale * q k^T + mask) v and the per-row log-sum-exp,
// for q [b, h, q_len, d] against k/v [b, h_kv, k_len, d] (q-head hh
// reads kv-head hh / (h / h_kv); repeated K/V never exists in memory),
// with the causal diagonal aligned at pos_offset = k_len - q_len, the
// padding mask kpos < k_len, NEG_INF = -1e30 (finite, so fully masked
// rows stay finite) and l floored at 1e-30.
//
// What bounds it on an H100: the larger of two times.  FLOPs, 4 * b * h
// * q_len * k_len * d (half of that when causal), against 989 TFLOP/s
// of bf16 tensor cores; and bytes (q, k, v and out once each, plus the
// f32 LSE) against 3.35 TB/s.  With 32/8 heads and d = 128 in bf16 the
// causal FLOPs pass the bytes only beyond about 740 tokens, so a
// 512-token prefill chunk is bound by bytes (about 3.1 us against
// 2.2 us of FLOPs) and longer prompts by FLOPs.  This first version
// does its products with scalar f32 FMAs out of shared memory, so it
// reaches a small fraction of either bound; what the design
// does about the bound is keep the work at the minimum: causal k-blocks
// past the diagonal are skipped (the TPU grid's block skip), K/V tiles
// are read once per (q-block, k-block) and shared by the 64 query rows
// of the block, scores never leave the SM.  Tensor-core products
// (mma.sync / wgmma) with TMA-fed tiles are the follow-up.
//
// Translation from the TPU kernel: the Pallas grid walks k-blocks in
// order on one core with the running (m, l, acc) in VMEM; here one
// thread block owns one (b*h, q-block) and loops over the k-blocks
// itself, the running statistics in registers.  Threads form quads:
// quad `row` owns one query row (4 threads share its 8 score columns
// and D/4 output lanes); row max and row sum reduce across the quad
// with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per k-block
constexpr int kThreads = 256;  // 4 threads per query row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D+1], sK [BK][D+1], sV [BK][D], sP [BQ][BK+1]; the +1
  // paddings keep the row-strided reads free of bank conflicts.
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int h, int h_kv, int q_len,
                     int k_len, float sm_scale, int causal) {
  constexpr int DS = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int CPT = kBK / 4;  // score columns per thread
  constexpr int DPT = D / 4;    // output lanes per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DS;
  float* sV = sK + kBK * DS;
  float* sP = sV + kBK * D;

  const int bh = blockIdx.x;
  const int qb = blockIdx.y;
  const int b = bh / h;
  const int kvh = (bh - b * h) / (h / h_kv);
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quad = tid & 3;
  const int q0 = qb * kBQ;
  const int pos_offset = k_len - q_len;
  const T* qp = q + (size_t)bh * q_len * D;
  const T* kp = k + ((size_t)b * h_kv + kvh) * k_len * D;
  const T* vp = v + ((size_t)b * h_kv + kvh) * k_len * D;

  // q pre-scaled in f32, as the TPU kernel does (q * sm_scale).
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int qi = q0 + r;
    sQ[r * DS + c] =
        qi < q_len ? to_f(qp[(size_t)qi * D + c]) * sm_scale : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;
  const int qpos = pos_offset + q0 + row;

  int n_kb = (k_len + kBK - 1) / kBK;
  if (causal) {
    // Skip k-blocks strictly above the diagonal for this q-block.
    n_kb = min(n_kb, (pos_offset + (qb + 1) * kBQ + kBK - 1) / kBK);
  }
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // every thread is done with the previous tiles
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int ki = k0 + r;
      const bool ok = ki < k_len;
      sK[r * DS + c] = ok ? to_f(kp[(size_t)ki * D + c]) : 0.f;
      sV[r * D + c] = ok ? to_f(vp[(size_t)ki * D + c]) : 0.f;
    }
    __syncthreads();

    float s[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
    const float* qrow = sQ + row * DS;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qrow[dd];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        s[j] = fmaf(qv, sK[(quad + 4 * j) * DS + dd], s[j]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kpos = k0 + quad + 4 * j;
      const bool ok = kpos < k_len && (!causal || kpos <= qpos);
      s[j] = ok ? s[j] : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      sP[row * PS + quad + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the quad's sP row is complete (one warp)
    const float* prow = sP + row * PS;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = prow[c];
      const float* vrow = sV + c * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(p, vrow[quad + 4 * j],
                                                  acc[j]);
    }
  }

  const int qi = q0 + row;
  if (qi < q_len) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* op = o + ((size_t)bh * q_len + qi) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) op[quad + 4 * j] = from_f<T>(acc[j] / l_safe);
    if (quad == 0) lse[(size_t)bh * q_len + qi] = m + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int h, int h_kv, int q_len, int k_len, float sm_scale,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (q_len + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), h, h_kv, q_len, k_len, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               void* lse, int b, int h, int h_kv, int q_len, int k_len,
               float sm_scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, h, h_kv, q_len, k_len,
                           sm_scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, h, h_kv, q_len, k_len,
                            sm_scale, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, b, h, h_kv, q_len, k_len,
                            sm_scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Returns a cudaError_t (0 on success).
extern "C" int skyt_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int dtype, int b, int h,
                              int h_kv, int q_len, int k_len, int d,
                              float sm_scale, int causal, void* stream) {
  if (b <= 0 || h <= 0 || h_kv <= 0 || h % h_kv || q_len <= 0 ||
      k_len <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, lse, b, h, h_kv, q_len, k_len,
                             sm_scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, b, h, h_kv, q_len,
                                     k_len, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
