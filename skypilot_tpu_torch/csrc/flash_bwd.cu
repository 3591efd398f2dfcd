// Flash-attention backward with GQA, for Hopper (sm_90a): dQ and fused
// dK/dV, recompute-style (the probabilities are rebuilt from the saved
// per-row LSE, never read from device memory).
//
// Replaces the Pallas kernels skypilot_tpu/ops/attention.py:
// _flash_bwd_dq_kernel (skyt_flash_bwd_dq) and _flash_bwd_dkv_kernel
// (skyt_flash_bwd_dkv), launched by _flash_bwd_pallas.  Same function,
// for q/dO [b, h, q_len, d] against k/v [b, h_kv, k_len, d] (q-head hh
// reads kv-head hh / (h / h_kv)), lse and delta [b, h, q_len] f32:
//
//   p  = exp(scale * q k^T - lse)  (0 where masked)
//   dp = dO v^T,  ds = p * (dp - delta)
//   dQ = scale * ds k,  dV = p^T dO,  dK = scale * ds^T q
//
// with the causal diagonal at pos_offset = k_len - q_len, keys masked at
// kpos < k_len and query rows at or past q_len skipped (the reference
// pads them with LSE_PAD instead).  delta = rowsum(dO * O) - g_lse comes
// in precomputed, as in the reference.
//
// What bounds it on an H100: FLOPs.  Over the causal triangle (n(n+1)/2
// score entries per head for q_len = k_len = n) dQ does 3 products of
// 2 d FLOPs per entry (s, dp, ds k) and dK/dV 4 (s, dp, p^T dO, ds^T q);
// at the training shape (b 2, 32/8 heads, d 128, n 2048) that is 103
// and 137 GFLOP, about 0.10 and 0.14 ms at 989 TFLOP/s of bf16 tensor
// cores, against ~0.035 ms for the bytes (~118 and ~101 MB at 3.35
// TB/s).  Both kernels keep the work at the minimum: causal tiles past
// the diagonal are skipped, every K/V (dQ) or Q/dO (dK/dV) tile read
// from device memory is shared by a whole block, and no score or
// probability leaves the SM.
//
// Bodies by (kernel, dtype, d); each dtype has one, none is a fallback:
// - dQ, bf16, d 64, 128 and 256: tensor cores (flash_bwd_dq_wgmma_kernel
//   below).  One 128-thread warpgroup owns 64 query rows of one (b*h);
//   Q and dO arrive once by TMA and stay in shared memory, the rows'
//   lse (times log2 e) and delta sit in registers, and the kv-head's
//   K/V tiles of 64 keys stream through a 2-stage TMA ring.  Per k-tile
//   S = Q K^T and dP = dO V^T are wgmmas with both operands K-major;
//   P and dS = P * (dP - delta) are formed in f32 on the accumulator
//   fragments, dS is rounded to bf16 as the register A of dQ += dS K,
//   whose B (the K tile) is MN-major.  That rounding is the only one
//   the reference does not have.  dQ (d/64 x 32 f32 a thread, 128 at
//   d 256) stays in registers across the k-loop; the causal loop stops
//   at the diagonal and q-tiles launch heaviest first.  Each block owns
//   its dQ rows: no atomics, and every launch gives the same bits.
// - dK/dV, bf16, d 64 and 128: tensor cores (flash_bwd_dkv_wgmma_kernel
//   below).  One 128-thread warpgroup owns 64 keys; K and V stay in
//   shared memory for the whole block, and the Q/dO tiles of 64 query
//   rows arrive by TMA in a 2-stage ring of 128-byte-swizzled tiles
//   (hopper_mma.cuh), the next tile's copy in flight while this one is
//   multiplied.  S^T = K Q^T and dP^T = V dO^T are wgmmas with both
//   operands K-major; P^T and dS^T are formed in f32 registers on the
//   accumulator fragments, rounded to bf16 and fed back as the A
//   operand of dV += P^T dO and dK += dS^T Q, whose B (dO or Q) is
//   MN-major.  Those two bf16 roundings are the only ones the
//   reference does not have.
// - dK/dV, bf16, d 256 (Gemma): the scalar body.  dK and dV for 64 keys
//   x 256 lanes would take 256 f32 registers a thread in one
//   warpgroup; splitting d across two warpgroups is still to do.
// - f32, both kernels: the scalar body, the parity path (GPU-vs-CPU
//   checks at 1e-4); tensor cores would make it TF32.
// The scalar bodies do f32 FMAs out of padded f32 shared tiles.
//
// Translation from the TPU kernels.  dQ: the Pallas grid walks k-blocks
// in order on one core; here one thread block owns one (b*h, q-tile)
// and loops over the k-tiles itself, its dQ rows in registers (the
// wgmma accumulator fragment; in the scalar body quads of threads own
// one query row).  dK/dV: the Pallas
// kernel runs once per q-head and leaves rep f32-sized partials per
// kv-head that XLA then sums over the GQA group; here one block owns
// one (b*h_kv, k-tile) and loops over the rep q-heads of its group and
// their q-tiles, so dK and dV accumulate in f32 registers across the
// whole group.  No partial buffers, no extra summation pass and no
// atomics: every launch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;

// dQ: query rows and keys per tile (4 threads per query row).
constexpr int kDqBQ = 64;
constexpr int kDqBK = 32;

// dK/dV: keys per block (threads per key row = kThreads / BK) and query
// rows per streamed tile.  d 256 halves the key tile to stay within
// the 227 KB of shared memory a block can have and 255 registers.
template <int D>
struct DkvTile {
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int BQ = 64;
};

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

// The +1 paddings keep the row-strided shared reads free of bank
// conflicts (an odd row stride puts neighbouring rows in other banks).
template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO [BQ][D+1]; sK, sV [BK][D+1]; sDS [BQ][BK+1]
  return sizeof(float) * (2 * kDqBQ * (D + 1) + 2 * kDqBK * (D + 1) +
                          kDqBQ * (kDqBK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV [BK][D+1]; sQ, sdO [BQ][D+1]; sP, sDS [BK][BQ+1]; sL, sDl [BQ]
  constexpr int BK = DkvTile<D>::BK, BQ = DkvTile<D>::BQ;
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                          2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int h, int h_kv, int q_len, int k_len,
                        float sm_scale, int causal) {
  constexpr int DS = D + 1;
  constexpr int SS = kDqBK + 1;
  constexpr int CPT = kDqBK / 4;  // score columns per thread
  constexpr int DPT = D / 4;      // dQ lanes per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kDqBQ * DS;
  float* sK = sdO + kDqBQ * DS;
  float* sV = sK + kDqBK * DS;
  float* sDS = sV + kDqBK * DS;

  const int bh = blockIdx.x;
  const int qb = blockIdx.y;
  const int b = bh / h;
  const int kvh = (bh - b * h) / (h / h_kv);
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quad = tid & 3;
  const int q0 = qb * kDqBQ;
  const int pos_offset = k_len - q_len;
  const size_t qoff = (size_t)bh * q_len * D;
  const T* kp = k + ((size_t)b * h_kv + kvh) * k_len * D;
  const T* vp = v + ((size_t)b * h_kv + kvh) * k_len * D;

  for (int i = tid; i < kDqBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int qi = q0 + r;
    const bool ok = qi < q_len;
    sQ[r * DS + c] = ok ? to_f(q[qoff + (size_t)qi * D + c]) : 0.f;
    sdO[r * DS + c] = ok ? to_f(dout[qoff + (size_t)qi * D + c]) : 0.f;
  }
  const int qi = q0 + row;
  const bool row_ok = qi < q_len;
  const float row_lse = row_ok ? lse[(size_t)bh * q_len + qi] : 0.f;
  const float row_delta = row_ok ? delta[(size_t)bh * q_len + qi] : 0.f;
  const int qpos = pos_offset + qi;

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  int n_kb = (k_len + kDqBK - 1) / kDqBK;
  if (causal) {
    // Skip k-tiles strictly above the diagonal for this q-tile.
    n_kb = min(n_kb, (pos_offset + (qb + 1) * kDqBQ + kDqBK - 1) / kDqBK);
  }
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kDqBK;
    __syncthreads();  // every thread is done with the previous tiles
    for (int i = tid; i < kDqBK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int ki = k0 + r;
      const bool ok = ki < k_len;
      sK[r * DS + c] = ok ? to_f(kp[(size_t)ki * D + c]) : 0.f;
      sV[r * DS + c] = ok ? to_f(vp[(size_t)ki * D + c]) : 0.f;
    }
    __syncthreads();

    float s[CPT], dp[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = dp[j] = 0.f;
    const float* qrow = sQ + row * DS;
    const float* dorow = sdO + row * DS;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qrow[dd];
      const float ov = dorow[dd];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[j] = fmaf(qv, sK[(quad + 4 * j) * DS + dd], s[j]);
        dp[j] = fmaf(ov, sV[(quad + 4 * j) * DS + dd], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kpos = k0 + quad + 4 * j;
      const bool ok = row_ok && kpos < k_len && (!causal || kpos <= qpos);
      const float p = ok ? expf(s[j] * sm_scale - row_lse) : 0.f;
      sDS[row * SS + quad + 4 * j] = p * (dp[j] - row_delta);
    }
    __syncwarp();  // the quad's sDS row is complete (one warp)
    const float* dsrow = sDS + row * SS;
    for (int c = 0; c < kDqBK; ++c) {
      const float ds = dsrow[c];
      const float* krow = sK + c * DS;
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        acc[j] = fmaf(ds, krow[quad + 4 * j], acc[j]);
    }
  }

  if (row_ok) {
    T* out = dq + qoff + (size_t)qi * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      out[quad + 4 * j] = from_f<T>(acc[j] * sm_scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int h,
                         int h_kv, int q_len, int k_len, float sm_scale,
                         int causal) {
  constexpr int BK = DkvTile<D>::BK;
  constexpr int BQ = DkvTile<D>::BQ;
  constexpr int TPR = kThreads / BK;  // threads per key row
  constexpr int CPT = BQ / TPR;       // score columns (query rows) per thread
  constexpr int LPT = D / TPR;        // dK/dV lanes per thread
  constexpr int DS = D + 1;
  constexpr int PS = BQ + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DS;
  float* sQ = sV + BK * DS;
  float* sdO = sQ + BQ * DS;
  float* sP = sdO + BQ * DS;
  float* sDS = sP + BK * PS;
  float* sL = sDS + BK * PS;
  float* sDl = sL + BQ;

  const int bkv = blockIdx.x;
  const int kb = blockIdx.y;
  const int b = bkv / h_kv;
  const int kvh = bkv - b * h_kv;
  const int rep = h / h_kv;
  const int tid = threadIdx.x;
  const int kr = tid / TPR;
  const int part = tid - kr * TPR;
  const int k0 = kb * BK;
  const int pos_offset = k_len - q_len;
  const size_t kvoff = (size_t)bkv * k_len * D;

  for (int i = tid; i < BK * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int ki = k0 + r;
    const bool ok = ki < k_len;
    sK[r * DS + c] = ok ? to_f(k[kvoff + (size_t)ki * D + c]) : 0.f;
    sV[r * DS + c] = ok ? to_f(v[kvoff + (size_t)ki * D + c]) : 0.f;
  }
  const int kpos = k0 + kr;
  const bool key_ok = kpos < k_len;

  float dk_acc[LPT], dv_acc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int n_qb = (q_len + BQ - 1) / BQ;
  // First q-tile whose last row can see this k-tile: qpos >= k0.
  const int first = causal ? max(0, (k0 - pos_offset) / BQ) : 0;
  for (int r = 0; r < rep; ++r) {
    const int bh = b * h + kvh * rep + r;
    const size_t qoff = (size_t)bh * q_len * D;
    const float* lp = lse + (size_t)bh * q_len;
    const float* dlp = delta + (size_t)bh * q_len;
    for (int qb = first; qb < n_qb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // every thread is done with the previous tiles
      for (int i = tid; i < BQ * D; i += kThreads) {
        const int rr = i / D, c = i - rr * D;
        const int qi = q0 + rr;
        const bool ok = qi < q_len;
        sQ[rr * DS + c] = ok ? to_f(q[qoff + (size_t)qi * D + c]) : 0.f;
        sdO[rr * DS + c] = ok ? to_f(dout[qoff + (size_t)qi * D + c]) : 0.f;
      }
      for (int i = tid; i < BQ; i += kThreads) {
        const bool ok = q0 + i < q_len;
        sL[i] = ok ? lp[q0 + i] : 0.f;
        sDl[i] = ok ? dlp[q0 + i] : 0.f;
      }
      __syncthreads();

      float s[CPT], dp[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[j] = dp[j] = 0.f;
      const float* krow = sK + kr * DS;
      const float* vrow = sV + kr * DS;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float kv = krow[dd];
        const float vv = vrow[dd];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = part + TPR * j;
          s[j] = fmaf(kv, sQ[col * DS + dd], s[j]);
          dp[j] = fmaf(vv, sdO[col * DS + dd], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = part + TPR * j;
        const int qi = q0 + col;
        const bool ok = key_ok && qi < q_len &&
                        (!causal || kpos <= pos_offset + qi);
        const float p = ok ? expf(s[j] * sm_scale - sL[col]) : 0.f;
        sP[kr * PS + col] = p;
        sDS[kr * PS + col] = p * (dp[j] - sDl[col]);
      }
      __syncwarp();  // the key row's sP / sDS are complete (one warp)
      const float* prow = sP + kr * PS;
      const float* dsrow = sDS + kr * PS;
      for (int c = 0; c < BQ; ++c) {
        const float p = prow[c];
        const float ds = dsrow[c];
        const float* dorow = sdO + c * DS;
        const float* qrow = sQ + c * DS;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          dv_acc[j] = fmaf(p, dorow[part + TPR * j], dv_acc[j]);
          dk_acc[j] = fmaf(ds, qrow[part + TPR * j], dk_acc[j]);
        }
      }
    }
  }

  if (key_ok) {
    T* dkp = dk + kvoff + (size_t)kpos * D;
    T* dvp = dv + kvoff + (size_t)kpos * D;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      dkp[part + TPR * j] = from_f<T>(dk_acc[j] * sm_scale);
      dvp[part + TPR * j] = from_f<T>(dv_acc[j]);
    }
  }
}

// ------------------------------------------- dQ, bf16: wgmma + TMA

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgBK = 64;  // keys per tile (dK/dV: per block)
constexpr int kWgBQ = 64;  // query rows per tile (dQ: per block)
constexpr int kWgThreads = 128;
constexpr int kStages = 2;

template <int D>
struct DqWgTiles {
  static constexpr int kQBytes = kWgBQ * D * 2;   // Q or dO
  static constexpr int kKVBytes = kWgBK * D * 2;  // one K or V tile
  // Q, dO, then K[stage], V[stage], then the barriers; 1024 bytes of
  // slack for aligning the base to the swizzle atom.
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 64;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int h,
                              int h_kv, int q_len, int k_len,
                              float sm_scale, int causal) {
  using T = DqWgTiles<D>;
  constexpr int NC = D / 64;  // 64-wide chunks of dQ (panels of a tile)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align1024(smem_raw);
  uint8_t* sdO = sQ + T::kQBytes;
  uint8_t* sK = sdO + T::kQBytes;
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
  auto load_kv = [&](int kb, int stage) {
    hopper::tma_load_tile<D, kWgBK>(sK + stage * T::kKVBytes, &tm_k,
                                    &full[stage], kb * kWgBK, bkv);
    hopper::tma_load_tile<D, kWgBK>(sV + stage * T::kKVBytes, &tm_v,
                                    &full[stage], kb * kWgBK, bkv);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // Q and dO stay resident; they ride on stage 0's barrier.
    hopper::mbar_expect(&full[0], 2 * T::kQBytes + 2 * T::kKVBytes);
    hopper::tma_load_tile<D, kWgBQ>(sQ, &tm_q, &full[0], q0, bh);
    hopper::tma_load_tile<D, kWgBQ>(sdO, &tm_do, &full[0], q0, bh);
    for (int s = 0; s < kStages && s < n_kb; ++s) {
      if (s > 0) hopper::mbar_expect(&full[s], 2 * T::kKVBytes);
      load_kv(s, s);
    }
  }

  // This thread's query rows r0 and r0 + 8, key columns c0 + 8j, +1;
  // their lse (log2 units) and delta in registers, 0 past q_len.
  const int r0 = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const bool ok0 = qi0 < q_len, ok1 = qi1 < q_len;
  const size_t row0 = (size_t)bh * q_len + qi0;
  const float l2_0 = ok0 ? lse[row0] * kLog2e : 0.f;
  const float l2_1 = ok1 ? lse[row0 + 8] * kLog2e : 0.f;
  const float dl0 = ok0 ? delta[row0] : 0.f;
  const float dl1 = ok1 ? delta[row0 + 8] : 0.f;
  const int qpos0 = pos_offset + qi0, qpos1 = qpos0 + 8;
  const float scale_log2 = sm_scale * kLog2e;

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int stage = kb % kStages;
    const int k0 = kb * kWgBK;
    const uint8_t* kt = sK + stage * T::kKVBytes;
    const uint8_t* vt = sV + stage * T::kKVBytes;
    hopper::mbar_wait(&full[stage], (kb / kStages) & 1);

    // S = Q K^T and dP = dO V^T, both operands K-major.
    float s[32], dp[32];
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      hopper::mma_ss<0>(s, hopper::desc_k(sQ + off), hopper::desc_k(kt + off),
                        kk > 0);
    }
    hopper::wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      hopper::mma_ss<0>(dp, hopper::desc_k(sdO + off),
                        hopper::desc_k(vt + off), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait<1>();
    hopper::fence_regs(s);

    // P = exp(scale * S - lse), 0 where masked.
    const bool edge = k0 + kWgBK > k_len || q0 + kWgBQ > q_len ||
                      (causal && k0 + kWgBK - 1 > pos_offset + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(s[4 * j + e] * scale_log2 - l2_0);
        float p1 = exp2f(s[4 * j + 2 + e] * scale_log2 - l2_1);
        if (edge) {
          const int kpos = k0 + c0 + 8 * j + e;
          const bool in = kpos < k_len;
          p0 = ok0 && in && (!causal || kpos <= qpos0) ? p0 : 0.f;
          p1 = ok1 && in && (!causal || kpos <= qpos1) ? p1 : 0.f;
        }
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
      }
    }
    hopper::wg_wait<0>();
    hopper::fence_regs(dp);
    // dS = P * (dP - delta), then bf16 as the register A of dQ += dS K.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl0);
        dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl1);
      }
    }
    uint32_t da[kWgBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) hopper::pack_a(dp, kk, da[kk]);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        hopper::mma_rs<1>(acc[c], da[kk],
                          hopper::desc_mn(kt + c * kWgBK * 128 + kk * 2048));
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);

    __syncthreads();  // every warp is done with this stage's K and V
    if (tid == 0 && kb + kStages < n_kb) {
      hopper::mbar_expect(&full[stage], 2 * T::kKVBytes);
      load_kv(kb + kStages, stage);
    }
  }

#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + c0;
      if (ok0)
        *reinterpret_cast<__nv_bfloat162*>(dq + row0 * D + col) =
            __floats2bfloat162_rn(acc[c][4 * j] * sm_scale,
                                  acc[c][4 * j + 1] * sm_scale);
      if (ok1)
        *reinterpret_cast<__nv_bfloat162*>(dq + (row0 + 8) * D + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2] * sm_scale,
                                  acc[c][4 * j + 3] * sm_scale);
    }
}

// ------------------------------------------ dK/dV, bf16: wgmma + TMA

template <int D>
struct DkvWgTiles {
  static constexpr int kKBytes = kWgBK * D * 2;  // K or V
  static constexpr int kQBytes = kWgBQ * D * 2;  // one Q or dO tile
  // K, V, Q[stage], dO[stage], then the f32 lse*log2(e) and delta
  // slices [stage][BQ] and the barriers; 1024 bytes of slack for
  // aligning the base to the swizzle atom.
  static constexpr size_t kSmem = 1024 + 2 * kKBytes +
                                  2 * kStages * kQBytes +
                                  2 * kStages * kWgBQ * 4 + 64;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int h,
                               int h_kv, int q_len, int k_len,
                               float sm_scale, int causal) {
  using T = DkvWgTiles<D>;
  constexpr int NC = D / 64;  // 64-wide chunks of dK/dV (panels of a tile)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = hopper::align1024(smem_raw);
  uint8_t* sV = sK + T::kKBytes;
  uint8_t* sQ = sV + T::kKBytes;
  uint8_t* sdO = sQ + kStages * T::kQBytes;
  float* sL = reinterpret_cast<float*>(sdO + kStages * T::kQBytes);
  float* sDl = sL + kStages * kWgBQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sDl + kStages * kWgBQ);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;

  const int bkv = blockIdx.x;
  const int kb = blockIdx.y;
  const int b = bkv / h_kv;
  const int kvh = bkv - b * h_kv;
  const int rep = h / h_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int k0 = kb * kWgBK;
  const int pos_offset = k_len - q_len;
  const int n_qb = (q_len + kWgBQ - 1) / kWgBQ;
  // First q-tile whose last row can see this k-tile: qpos >= k0.
  const int first = causal ? max(0, (k0 - pos_offset) / kWgBQ) : 0;
  const int per = n_qb - first;  // q-tiles per q-head (>= 1)
  const int tiles = rep * per;   // the group's q-heads, one after another

  // Tile t: q-head r = t / per of the group, q-tile first + t % per.
  auto head_of = [&](int t) { return b * h + kvh * rep + t / per; };
  auto row_of = [&](int t) { return (first + t % per) * kWgBQ; };
  auto load_tile = [&](int t, int stage) {
    hopper::mbar_expect(&full[stage], 2 * T::kQBytes);
    hopper::tma_load_tile<D, kWgBQ>(sQ + stage * T::kQBytes, &tm_q,
                                    &full[stage], row_of(t), head_of(t));
    hopper::tma_load_tile<D, kWgBQ>(sdO + stage * T::kQBytes, &tm_do,
                                    &full[stage], row_of(t), head_of(t));
  };
  // lse (in log2 units) and delta of tile t's rows, 0 past q_len.
  auto load_rows = [&](int t, int stage) {
    if (tid < kWgBQ) {
      const int qi = row_of(t) + tid;
      const size_t at = (size_t)head_of(t) * q_len + qi;
      sL[stage * kWgBQ + tid] = qi < q_len ? lse[at] * kLog2e : 0.f;
      sDl[stage * kWgBQ + tid] = qi < q_len ? delta[at] : 0.f;
    }
  };

  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect(kv_bar, 2 * T::kKBytes);
    hopper::tma_load_tile<D, kWgBK>(sK, &tm_k, kv_bar, k0, bkv);
    hopper::tma_load_tile<D, kWgBK>(sV, &tm_v, kv_bar, k0, bkv);
    for (int s = 0; s < kStages && s < tiles; ++s) load_tile(s, s);
  }
  load_rows(0, 0);
  __syncthreads();

  // This thread's key rows r0 and r0 + 8, query columns c0 + 8j, +1.
  const int r0 = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int kpos0 = k0 + r0, kpos1 = kpos0 + 8;
  const float scale_log2 = sm_scale * kLog2e;

  float dk_acc[NC][32], dv_acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  hopper::mbar_wait(kv_bar, 0);
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % kStages;
    const int q0 = row_of(t);
    const uint8_t* qt = sQ + stage * T::kQBytes;
    const uint8_t* dot = sdO + stage * T::kQBytes;
    const float* lt = sL + stage * kWgBQ;
    const float* dlt = sDl + stage * kWgBQ;
    hopper::mbar_wait(&full[stage], (t / kStages) & 1);

    float s[32], dp[32];
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      hopper::mma_ss<0>(s, hopper::desc_k(sK + off), hopper::desc_k(qt + off),
                        kk > 0);
    }
    hopper::wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      hopper::mma_ss<0>(dp, hopper::desc_k(sV + off),
                        hopper::desc_k(dot + off), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait<1>();
    hopper::fence_regs(s);

    // P^T = exp(scale * S^T - lse[col]), 0 where masked.
    const bool edge = k0 + kWgBK > k_len || q0 + kWgBQ > q_len ||
                      (causal && k0 + kWgBK - 1 > pos_offset + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + e;
        const float l2 = lt[col];
        float p0 = exp2f(s[4 * j + e] * scale_log2 - l2);
        float p1 = exp2f(s[4 * j + 2 + e] * scale_log2 - l2);
        if (edge) {
          const int qi = q0 + col;
          const bool row_ok = qi < q_len;
          const int lim = causal ? pos_offset + qi : k_len;
          p0 = row_ok && kpos0 < k_len && kpos0 <= lim ? p0 : 0.f;
          p1 = row_ok && kpos1 < k_len && kpos1 <= lim ? p1 : 0.f;
        }
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
      }
    }
    hopper::wg_wait<0>();
    hopper::fence_regs(dp);
    // dS^T = P^T * (dP^T - delta[col]).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = dlt[c0 + 8 * j + e];
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl);
        dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl);
      }
    }
    uint32_t pa[kWgBQ / 16][4], da[kWgBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBQ / 16; ++kk) {
      hopper::pack_a(s, kk, pa[kk]);
      hopper::pack_a(dp, kk, da[kk]);
    }
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int off = c * kWgBQ * 128 + kk * 2048;
        hopper::mma_rs<1>(dv_acc[c], pa[kk], hopper::desc_mn(dot + off));
        hopper::mma_rs<1>(dk_acc[c], da[kk], hopper::desc_mn(qt + off));
      }
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hopper::fence_regs(dv_acc[c]);
      hopper::fence_regs(dk_acc[c]);
    }

    if (t + 1 < tiles) load_rows(t + 1, (t + 1) % kStages);
    __syncthreads();  // this stage is free; the next rows are visible
    if (tid == 0 && t + kStages < tiles) load_tile(t + kStages, stage);
  }

  const size_t kvoff = (size_t)bkv * k_len * D;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + c0;
      if (kpos0 < k_len) {
        const size_t at = kvoff + (size_t)kpos0 * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            dk_acc[c][4 * j] * sm_scale, dk_acc[c][4 * j + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[c][4 * j], dv_acc[c][4 * j + 1]);
      }
      if (kpos1 < k_len) {
        const size_t at = kvoff + (size_t)kpos1 * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dk_acc[c][4 * j + 2] * sm_scale,
                                  dk_acc[c][4 * j + 3] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(
            dv_acc[c][4 * j + 2], dv_acc[c][4 * j + 3]);
      }
    }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int b, h, h_kv, q_len, k_len;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<D>();
  const cudaError_t attr = hopper::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, D>),
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(a.b * a.h, (a.q_len + kDqBQ - 1) / kDqBQ);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.h, a.h_kv, a.q_len, a.k_len, a.sm_scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const Args& a) {
  constexpr size_t smem = DqWgTiles<D>::kSmem;
  const cudaError_t attr = hopper::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<D>),
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tdo, tk, tv;
  int err = hopper::make_map(&tq, a.q, a.b * a.h, a.q_len, D, kWgBQ);
  if (!err) err = hopper::make_map(&tdo, a.dout, a.b * a.h, a.q_len, D,
                                   kWgBQ);
  if (!err) err = hopper::make_map(&tk, a.k, a.b * a.h_kv, a.k_len, D,
                                   kWgBK);
  if (!err) err = hopper::make_map(&tv, a.v, a.b * a.h_kv, a.k_len, D,
                                   kWgBK);
  if (err) return err;
  const dim3 grid(a.b * a.h, (a.q_len + kWgBQ - 1) / kWgBQ);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kWgThreads, smem, a.stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      a.h, a.h_kv, a.q_len, a.k_len, a.sm_scale, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const Args& a) {
  constexpr size_t smem = DkvWgTiles<D>::kSmem;
  const cudaError_t attr = hopper::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkv_wgmma_kernel<D>),
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tdo, tk, tv;
  int err = hopper::make_map(&tq, a.q, a.b * a.h, a.q_len, D, kWgBQ);
  if (!err) err = hopper::make_map(&tdo, a.dout, a.b * a.h, a.q_len, D,
                                   kWgBQ);
  if (!err) err = hopper::make_map(&tk, a.k, a.b * a.h_kv, a.k_len, D,
                                   kWgBK);
  if (!err) err = hopper::make_map(&tv, a.v, a.b * a.h_kv, a.k_len, D,
                                   kWgBK);
  if (err) return err;
  const dim3 grid(a.b * a.h_kv, (a.k_len + kWgBK - 1) / kWgBK);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kWgThreads, smem, a.stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.h, a.h_kv, a.q_len, a.k_len,
      a.sm_scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<D>();
  const cudaError_t attr = hopper::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkv_kernel<T, D>),
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int BK = DkvTile<D>::BK;
  const dim3 grid(a.b * a.h_kv, (a.k_len + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.h, a.h_kv,
      a.q_len, a.k_len, a.sm_scale, a.causal);
  return (int)cudaGetLastError();
}

// kind: 0 = dQ, 1 = dK/dV.  bf16 dQ and bf16 dK/dV at d 64 and 128
// run on the tensor cores (see the top); no scalar bf16 body is
// instantiated for them.
template <typename T, int D>
int launch_kind(int kind, const Args& a) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  if (kind == 0) {
    if constexpr (bf16)
      return launch_dq_wgmma<D>(a);
    else
      return launch_dq<T, D>(a);
  }
  if constexpr (bf16 && D <= 128)
    return launch_dkv_wgmma<D>(a);
  else
    return launch_dkv<T, D>(a);
}

template <typename T>
int dispatch_d(int kind, int d, const Args& a) {
  switch (d) {
    case 64:
      return launch_kind<T, 64>(kind, a);
    case 128:
      return launch_kind<T, 128>(kind, a);
    case 256:
      return launch_kind<T, 256>(kind, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int kind, int dtype, int d, const Args& a) {
  if (a.b <= 0 || a.h <= 0 || a.h_kv <= 0 || a.h % a.h_kv ||
      a.q_len <= 0 || a.k_len < a.q_len)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_d<float>(kind, d, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(kind, d, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients
// share it); lse and delta are f32.  Each returns a cudaError_t (0 on
// success).
extern "C" int skyt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int dtype,
                                 int b, int h, int h_kv, int q_len,
                                 int k_len, int d, float sm_scale,
                                 int causal, void* stream) {
  const Args a{q,     k,    v,     dout,  lse,      delta,
               dq,    nullptr, b,  h,     h_kv,     q_len,
               k_len, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(0, dtype, d, a);
}

extern "C" int skyt_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int dtype, int b,
                                  int h, int h_kv, int q_len, int k_len,
                                  int d, float sm_scale, int causal,
                                  void* stream) {
  const Args a{q,     k,  v,     dout,  lse,      delta,
               dk,    dv, b,     h,     h_kv,     q_len,
               k_len, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(1, dtype, d, a);
}
