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
// 512-token prefill chunk is bound by bytes and the training shape
// (2048 tokens) by FLOPs.
//
// Two bodies, chosen by dtype (not a fallback: each dtype has one):
//
// bf16 (d 64, 128, 256): tensor cores.  One 128-thread warpgroup owns
// 64 query rows of one (b*h); K/V tiles of 64 keys arrive by TMA in a
// 2-stage ring of 128-byte-swizzled shared tiles (hopper_mma.cuh), the
// copy of tile j+1 in flight while tile j is multiplied.  S = Q K^T is
// a wgmma with both operands K-major in shared memory; sm_scale is
// applied to the f32 scores (the reference scales q in f32, and a
// scaled q rounded to bf16 would add an error it does not have), with
// log2(e) folded in for exp2f.  The online softmax runs on the
// accumulator fragment (a row lives on 4 threads: max by __shfl_xor 1
// and 2; the row sum stays per thread and is reduced once at the end).
// O += P V takes P from registers, rounded to bf16 (the one rounding
// the reference does not have), and V MN-major.  Causal k-tiles past
// the q-tile's last row are skipped, and q-tiles are launched heaviest
// first.  A row's numbers do not depend on q_len, its q-tile or b: the
// k-tile width and loop order are fixed, and a fully masked tile adds
// exact zeros.
//
// f32 (any of the three d): the scalar body below, quads of threads
// per query row with f32 FMAs out of shared memory.  It is the parity
// path (GPU-vs-CPU checks at 1e-4); tensor cores would make it TF32.
//
// Translation from the TPU kernel: the Pallas grid walks k-blocks in
// order on one core with the running (m, l, acc) in VMEM; here one
// thread block owns one (b*h, q-block) and loops over the k-blocks
// itself, the running statistics in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------ bf16: wgmma + TMA

constexpr int kWgBQ = 64;       // query rows per block (one warpgroup)
constexpr int kWgBK = 64;       // keys per k-tile
constexpr int kWgThreads = 128;
constexpr int kStages = 2;

template <int D>
struct FwdTiles {
  static constexpr int kQBytes = kWgBQ * D * 2;
  static constexpr int kKVBytes = kWgBK * D * 2;  // one K or V tile
  // Q, then K[stage], then V[stage], then the barriers; 1024 bytes of
  // slack for aligning the base to the swizzle atom.
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 64;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int h, int h_kv,
                           int q_len, int k_len, float sm_scale,
                           int causal) {
  using T = FwdTiles<D>;
  constexpr int NC = D / 64;  // 64-wide chunks of O (and panels of a tile)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align1024(smem_raw);
  uint8_t* sK = sQ + T::kQBytes;
  uint8_t* sV = sK + kStages * T::kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * T::kKVBytes);

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest q-tiles first
  const int b = bh / h;
  const int bkv = b * h_kv + (bh - b * h) / (h / h_kv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = qb * kWgBQ;
  const int pos_offset = k_len - q_len;
  int n_kb = (k_len + kWgBK - 1) / kWgBK;
  if (causal) {
    // Skip k-tiles strictly above the diagonal for this q-tile.
    n_kb = min(n_kb, (pos_offset + q0 + kWgBQ + kWgBK - 1) / kWgBK);
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect(&full[0], T::kQBytes + 2 * T::kKVBytes);
    hopper::tma_load_tile<D, kWgBQ>(sQ, &tm_q, &full[0], q0, bh);
    for (int s = 0; s < kStages && s < n_kb; ++s) {
      if (s > 0) hopper::mbar_expect(&full[s], 2 * T::kKVBytes);
      hopper::tma_load_tile<D, kWgBK>(sK + s * T::kKVBytes, &tm_k, &full[s],
                                      s * kWgBK, bkv);
      hopper::tma_load_tile<D, kWgBK>(sV + s * T::kKVBytes, &tm_v, &full[s],
                                      s * kWgBK, bkv);
    }
  }

  // This thread's rows r0 and r0 + 8 of the tile, columns c0 + 8j, +1.
  const int r0 = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int qpos0 = pos_offset + q0 + r0, qpos1 = qpos0 + 8;
  const float scale_log2 = sm_scale * kLog2e;

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  // Running max (log2 units) and this thread's share of the row sum.
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int stage = kb % kStages;
    const int k0 = kb * kWgBK;
    const uint8_t* kt = sK + stage * T::kKVBytes;
    const uint8_t* vt = sV + stage * T::kKVBytes;
    hopper::mbar_wait(&full[stage], (kb / kStages) & 1);

    float s[32];
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      hopper::mma_ss<0>(s, hopper::desc_k(sQ + off),
                        hopper::desc_k(kt + off), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(s);

    const bool edge = k0 + kWgBK > k_len ||
                      (causal && k0 + kWgBK - 1 > pos_offset + q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = s[4 * j + e] * scale_log2;
        float v1 = s[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int kpos = k0 + c0 + 8 * j + e;
          const bool in = kpos < k_len;
          v0 = in && (!causal || kpos <= qpos0) ? v0 : kNegInf;
          v1 = in && (!causal || kpos <= qpos1) ? v1 : kNegInf;
        }
        s[4 * j + e] = v0;
        s[4 * j + 2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - mn0);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn1);
        ps0 += s[4 * j + e];
        ps1 += s[4 * j + 2 + e];
      }
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[c][4 * j] *= corr0;
        acc[c][4 * j + 1] *= corr0;
        acc[c][4 * j + 2] *= corr1;
        acc[c][4 * j + 3] *= corr1;
      }

    uint32_t pa[kWgBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) hopper::pack_a(s, kk, pa[kk]);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        hopper::mma_rs<1>(acc[c], pa[kk],
                          hopper::desc_mn(vt + c * kWgBK * 128 + kk * 2048));
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);

    __syncthreads();  // every warp is done with this stage's K and V
    if (tid == 0 && kb + kStages < n_kb) {
      hopper::mbar_expect(&full[stage], 2 * T::kKVBytes);
      hopper::tma_load_tile<D, kWgBK>(sK + stage * T::kKVBytes, &tm_k,
                                      &full[stage], (kb + kStages) * kWgBK,
                                      bkv);
      hopper::tma_load_tile<D, kWgBK>(sV + stage * T::kKVBytes, &tm_v,
                                      &full[stage], (kb + kStages) * kWgBK,
                                      bkv);
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + c0;
      if (qi0 < q_len)
        *reinterpret_cast<__nv_bfloat162*>(
            o + ((size_t)bh * q_len + qi0) * D + col) =
            __floats2bfloat162_rn(acc[c][4 * j] / ls0,
                                  acc[c][4 * j + 1] / ls0);
      if (qi1 < q_len)
        *reinterpret_cast<__nv_bfloat162*>(
            o + ((size_t)bh * q_len + qi1) * D + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2] / ls1,
                                  acc[c][4 * j + 3] / ls1);
    }
  if ((lane & 3) == 0) {
    if (qi0 < q_len) lse[(size_t)bh * q_len + qi0] = m0 * kLn2 + logf(ls0);
    if (qi1 < q_len) lse[(size_t)bh * q_len + qi1] = m1 * kLn2 + logf(ls1);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int h, int h_kv, int q_len, int k_len,
                 float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = FwdTiles<D>::kSmem;
  const cudaError_t attr = hopper::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<D>),
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = hopper::make_map(&tq, q, b * h, q_len, D, kWgBQ);
  if (!err) err = hopper::make_map(&tk, k, b * h_kv, k_len, D, kWgBK);
  if (!err) err = hopper::make_map(&tv, v, b * h_kv, k_len, D, kWgBK);
  if (err) return err;
  const dim3 grid(b * h, (q_len + kWgBQ - 1) / kWgBQ);
  flash_fwd_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      h, h_kv, q_len, k_len, sm_scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- f32: scalar body

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per k-block
constexpr int kThreads = 256;  // 4 threads per query row

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D+1], sK [BK][D+1], sV [BK][D], sP [BQ][BK+1]; the +1
  // paddings keep the row-strided reads free of bank conflicts.
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// Quad `row` of threads owns one query row (4 threads share its 8
// score columns and D/4 output lanes); row max and row sum reduce
// across the quad with shuffles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
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
  const float* qp = q + (size_t)bh * q_len * D;
  const float* kp = k + ((size_t)b * h_kv + kvh) * k_len * D;
  const float* vp = v + ((size_t)b * h_kv + kvh) * k_len * D;

  // q pre-scaled in f32, as the TPU kernel does (q * sm_scale).
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int qi = q0 + r;
    sQ[r * DS + c] = qi < q_len ? qp[(size_t)qi * D + c] * sm_scale : 0.f;
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
      sK[r * DS + c] = ok ? kp[(size_t)ki * D + c] : 0.f;
      sV[r * D + c] = ok ? vp[(size_t)ki * D + c] : 0.f;
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
    float* op = o + ((size_t)bh * q_len + qi) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) op[quad + 4 * j] = acc[j] / l_safe;
    if (quad == 0) lse[(size_t)bh * q_len + qi] = m + logf(l_safe);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int b, int h, int h_kv, int q_len, int k_len,
               float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  const cudaError_t attr = hopper::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_kernel<D>),
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(b * h, (q_len + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), h, h_kv, q_len, k_len, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           void* lse, int b, int h, int h_kv, int q_len, int k_len,
           float sm_scale, int causal, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, b, h, h_kv, q_len, k_len, sm_scale,
                         causal, stream);
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, o, lse, b, h, h_kv, q_len, k_len,
                           sm_scale, causal, stream);
  return (int)cudaErrorInvalidValue;
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
  switch (d) {
    case 64:
      return launch<64>(dtype, q, k, v, o, lse, b, h, h_kv, q_len, k_len,
                        sm_scale, causal, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, lse, b, h, h_kv, q_len, k_len,
                         sm_scale, causal, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, lse, b, h, h_kv, q_len, k_len,
                         sm_scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
