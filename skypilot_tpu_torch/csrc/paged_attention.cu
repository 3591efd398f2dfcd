// Paged decode attention over one layer's KV page pool, for Hopper
// (sm_90a): one split-context kernel, for native-dtype pools (B1) and
// int8 pools (B2).
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
// verify.  Arithmetic is in f32: q is scaled by sm_scale in f32, bf16
// K and V widen to f32 exactly, and the int8 kernel multiplies each
// value by its token's f32 scale (dequant in f32, as the reference
// does).
//
// What bounds it on an H100: bytes.  Every live K and V page is read
// once per (slot, kv-head) - ps * d elements of 2 or 4 bytes (native)
// or 1 byte plus a 4-byte scale per token (int8) - against 3.35 TB/s,
// while the arithmetic is ~4 * R FLOPs per element read.  The GQA
// group's R query rows share each page load, so a page crosses device
// memory once per kv-head and not once per q-head, and each block reads
// the block table in-kernel, so the gathered dense view the CPU
// reference builds never exists.  At serving sizes the bytes are a few
// MB, so what sets the time is how much of the card the page walk keeps
// busy and how long one block's chain of latencies is.
//
// Split-context flash-decoding (paged_decode_split_kernel, templated
// over the pool's element type TKV: TQ for B1, int8_t for B2).  Each
// slot's page walk is cut into splits of a fixed kSplitPages (C) pages,
// one block per (slot, kv-head, split), so a long context spreads over
// many SMs.  A block brings its C pages into shared memory at once:
// - native pools: K and V go straight into shared memory in their own
//   dtype by 16-byte cp.async, nothing staged in registers, in two
//   commit groups; the scores wait for K's only, so V's bytes land
//   while the scores and the softmax run.  bf16 widens to f32 where it
//   is read, exactly, by a 16-bit shift.
// - int8 pools: K and its scales by 16-byte cp.async, V by 16-byte
//   loads dequantized once into f32 (P·V reads each value once per row
//   block).  int8 values become floats by a byte permute into the
//   mantissa of 2^23 (exact; I2F runs at a quarter of the rate).
// It computes the R x C*ps scores with a fixed group of 8 lanes per dot
// product (each lane a fixed slice of d; 4 rows x 2 tokens a lane, so q
// is read once for two tokens; the 8 partials meet in a transposed
// xor-shuffle tree), the split's own softmax (one warp a row), and P·V
// with each thread owning 4 output lanes of its rows.  It leaves its
// partial (m, l, acc[R][d]) in f32 in a workspace the wrapper
// allocates.  The last block of a (slot, kv-head) to finish - found
// with a ticket counter that it resets to 0 - merges the splits in
// split order: w_s = exp(m_s - max m), out = sum w_s acc_s / sum w_s
// l_s, reading the partials from L2.  One launch, no second merge
// kernel (the decode tick is bound by the host's ~2800 launches).  A
// slot that fits in one split writes its output directly, with the
// same arithmetic.
//
// Row invariance (a query row's bits do not depend on R, S, B or the
// other slots; the speculative verify tick must reproduce a plain
// tick's tokens): C is a compile-time constant, so split boundaries
// sit at fixed positions; the lanes-to-(row, d) mapping and every
// reduction order are fixed; a token past a row's qpos, or past the
// loaded pages, gets p = 0 exactly, and a split wholly past it keeps
// m = NEG_INF, l = 0 and acc = 0, so its combine weight exp(NEG_INF -
// M) is 0 and it adds exact zeros.  Tensor cores are not used: they
// would round P (and the dequantized K) to bf16, which the reference
// does not.
//
// Translation from the TPU kernels: their grid walks table rows in
// order on one core, carrying (m, l, acc) in VMEM scratch between
// pages.  Here each split has its own block and the partials are
// merged in a fixed order.  Each block loads its own table row and
// length (the TPU's scalar prefetch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Pages per split (C), of B1 and B2 alike.  Fixed: a split's span of
// positions - and so every row's arithmetic - depends on nothing but the
// page size, never on B, R, S or how many slots are live.  At ps 16 a
// split is 64 tokens, and a 1000-token slot spreads over 16 blocks.  On
// an H100 B1 was slower at the ragged serving tick with 2 or 8 pages
// (PERF.md, `profile_paged --split-pages`); 8 pages were faster at a
// full batch, but 8 pages of f32 K and V at d 256 (256 KB) do not fit
// in shared memory.
constexpr int kSplitPages = 4;
constexpr int kGroup = 8;        // lanes per score dot product
constexpr int kScoreRows = 4;    // a lane's kGroup partial scores:
constexpr int kScoreToks = 2;    //   kScoreRows rows x kScoreToks tokens
static_assert(kScoreRows * kScoreToks == kGroup,
              "the transposed tree gives each of the 8 lanes one score");
constexpr int kRowsPerPass = 4;  // P·V rows a thread holds in registers
constexpr int kBatch = 4;        // global loads a thread keeps in flight
constexpr int kMergeBatch = 16;  // splits' partials in flight in the merge

// What B1's and B2's pools differ in.  TV is V's type in shared memory:
// int8 V is dequantized into f32 as it is stored, native V stays as it
// is in the pool.
template <typename TKV>
struct Pool {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  using TV = typename std::conditional<kInt8, float, TKV>::type;
};

// Shared memory of a split block (T = C * ps tokens, a multiple of 4):
// f32 sQ [R][D], sP [p] (the scores, then p; the merge's m/weights and
// l [2][splits][R]), sKs [T] (int8 pools only), sL/sM [R], the ticket's
// verdict (one int); then sV [T][D] as TV and sK [T][D] as TKV.  No
// static shared memory, so the whole 227 KB stays dynamic.
template <typename TKV>
struct SplitLayout {
  int p;       // floats of sP, a multiple of 4
  int ks;      // floats of sKs
  size_t f32;  // floats before sV, a multiple of 4
  __host__ __device__ SplitLayout(int R, int T, int D, int max_splits) {
    const int n = R * T > 2 * max_splits * R ? R * T : 2 * max_splits * R;
    p = (n + 3) & ~3;
    ks = Pool<TKV>::kInt8 ? T : 0;
    f32 = ((size_t)R * D + p + ks + 2 * (size_t)R + 1 + 3) & ~(size_t)3;
  }
  size_t bytes(int T, int D) const {
    return f32 * 4 +
           (size_t)T * D * (sizeof(typename Pool<TKV>::TV) + sizeof(TKV));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Signed byte k (0..3) of w as a float, exactly: the byte with its sign
// bit flipped is x + 128, placed in the mantissa of 2^23 by one byte
// permute; less 2^23 + 128.  Full-rate ALU work where I2F runs at a
// quarter of the rate.
__device__ __forceinline__ float s8(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                    0x7540 | k)) -
         8388736.f;
}

// The 16 bytes u as 16 / sizeof(T) floats (bf16 widens exactly).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u,
                                         float (&f)[16 / sizeof(T)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Four consecutive values of shared memory as floats (bf16 exactly).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// grid (B * h_kv, ceil(P / C)); blockIdx.y is the split.  TQ: q and out;
// TKV: the pools (TQ, or int8_t with f32 scales; the native kernel gets
// null scales).  work holds acc [B*h_kv][splits][R][D], then m, l
// [B*h_kv][splits][2][R]; tickets [B*h_kv] are 0 between launches.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kpool,
    const TKV* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, TQ* __restrict__ out,
    float* __restrict__ work, int* __restrict__ tickets,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    int h_kv, int R, int S, int P, int ps, float sm_scale) {
  using TV = typename Pool<TKV>::TV;
  constexpr bool kInt8 = Pool<TKV>::kInt8;
  // A lane's slice of d: chunks of W elements (at most 16 bytes of the
  // pool) at d = W*j + 8W*ch (j its lane in the group), ch < NCH.
  constexpr int KW = 16 / sizeof(TKV);  // pool elements in 16 bytes
  constexpr int W = D / kGroup < KW ? D / kGroup : KW;
  constexpr int NCH = D / (kGroup * W);
  static_assert(kInt8 || W == KW, "a native lane chunk is 16 bytes");
  constexpr int Q4 = D / 4;          // 4-lane column quads of a row
  constexpr int RS = kThreads / Q4;  // P·V row stride between threads
  const int T = kSplitPages * ps;
  const int max_splits = gridDim.y;
  const SplitLayout<TKV> lay(R, T, D, max_splits);
  extern __shared__ __align__(16) float split_smem[];
  float* sQ = split_smem;
  float* sP = sQ + R * D;
  float* sKs = sP + lay.p;
  float* sL = sKs + lay.ks;
  float* sM = sL + R;
  int& last = *reinterpret_cast<int*>(sM + R);
  TV* sV = reinterpret_cast<TV*>(split_smem + lay.f32);
  TKV* sK = reinterpret_cast<TKV*>(sV + T * D);

  const int bg = blockIdx.x;  // slot * h_kv + kv-head
  const int split = blockIdx.y;
  const int b = bg / h_kv;
  const int g = bg - b * h_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  // Pages holding positions [0, length + S): ceil((length + S) / ps).
  const int n_pages = min(P, (length + S + ps - 1) / ps);
  const int nsplit = (n_pages + kSplitPages - 1) / kSplitPages;
  if (split >= nsplit) return;
  const int tok0 = split * kSplitPages * ps;  // position of slot 0
  const int n_tok = min(kSplitPages * ps, n_pages * ps - tok0);
  const int* table = tables + (size_t)b * P + split * kSplitPages;

  // q's 16-byte pieces (the first kBatch a thread) are fetched first:
  // they need no table entry.
  constexpr int QV = 16 / sizeof(TQ);
  const TQ* qp = q + (size_t)bg * R * D;
  uint4 qraw[kBatch];
#pragma unroll
  for (int x = 0; x < kBatch; ++x) {
    const int e = (tid + x * kThreads) * QV;
    if (e < R * D) qraw[x] = *reinterpret_cast<const uint4*>(qp + e);
  }
  // K's pages by cp.async, all in flight at once.
  const int page_chunks = ps * D / KW;  // 16-byte chunks of a page
  const int n_chunks = n_tok * D / KW;
  for (int e = tid; e < n_chunks; e += kThreads) {
    const int i = e / page_chunks;
    cp_async16(sK + e * KW, kpool + ((size_t)table[i] * h_kv + g) * ps * D +
                                (size_t)(e - i * page_chunks) * KW);
  }
  if constexpr (kInt8) {
    // Scales 16 bytes at a time where a page's run of ps floats allows.
    const int sc =
        ps % 4 == 0 && reinterpret_cast<uintptr_t>(kscale) % 16 == 0 ? 4 : 1;
    for (int t = tid * sc; t < n_tok; t += kThreads * sc) {
      const int i = t / ps;
      const float* src = kscale + ((size_t)table[i] * h_kv + g) * ps +
                         (t - i * ps);
      if (sc == 4)
        cp_async16(sKs + t, src);
      else
        cp_async4(sKs + t, src);
    }
    // V dequantized once (value x its token's scale, in f32), so that
    // P·V, which reads every value once per row block, reads floats.
    for (int e0 = tid; e0 < n_chunks; e0 += kThreads * kBatch) {
      uint4 u[kBatch];
      float vs[kBatch];
#pragma unroll
      for (int x = 0; x < kBatch; ++x) {
        const int e = e0 + x * kThreads;
        if (e < n_chunks) {
          const int i = e / page_chunks, t = e * 16 / D;
          const size_t page = (size_t)table[i] * h_kv + g;
          u[x] = __ldg(reinterpret_cast<const uint4*>(
              vpool + page * ps * D + (size_t)(e - i * page_chunks) * 16));
          vs[x] = __ldg(vscale + page * ps + (t - i * ps));
        }
      }
#pragma unroll
      for (int x = 0; x < kBatch; ++x) {
        const int e = e0 + x * kThreads;
        if (e < n_chunks) {
          float4* dst = reinterpret_cast<float4*>(sV + e * 16);
          const uint32_t w[4] = {u[x].x, u[x].y, u[x].z, u[x].w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dst[k] = make_float4(s8(w[k], 0) * vs[x], s8(w[k], 1) * vs[x],
                                 s8(w[k], 2) * vs[x], s8(w[k], 3) * vs[x]);
        }
      }
    }
  } else {
    // V's pages as they are, in a commit group after K's: the scores
    // wait for K's group alone.
    cp_async_commit();
    for (int e = tid; e < n_chunks; e += kThreads) {
      const int i = e / page_chunks;
      cp_async16(sV + e * KW, vpool + ((size_t)table[i] * h_kv + g) * ps * D +
                                  (size_t)(e - i * page_chunks) * KW);
    }
    cp_async_commit();
  }
  // q pre-scaled in f32, stored so that the group's 8 lanes read
  // neighbouring float4s: d = W*j + 8W*ch + 4*k4 + x sits at
  // 8W*ch + 32*k4 + 4*j + x.
  for (int e0 = tid * QV; e0 < R * D; e0 += kThreads * QV * kBatch) {
    if (e0 != tid * QV) {
#pragma unroll
      for (int x = 0; x < kBatch; ++x) {
        const int e = e0 + x * kThreads * QV;
        if (e < R * D) qraw[x] = *reinterpret_cast<const uint4*>(qp + e);
      }
    }
#pragma unroll
    for (int x = 0; x < kBatch; ++x) {
      const int e = e0 + x * kThreads * QV;
      if (e < R * D) {
        float f[QV];
        unpack16<TQ>(qraw[x], f);
#pragma unroll
        for (int y = 0; y < QV; ++y) {
          const int r = (e + y) / D, d = e + y - r * D;
          const int ch = d / (8 * W), rem = d - ch * 8 * W;
          const int j = rem / W, k4 = (rem - j * W) / 4;
          sQ[r * D + ch * 8 * W + 32 * k4 + 4 * j + (rem & 3)] =
              f[y] * sm_scale;
        }
      }
    }
  }
  // K in place (int8 pools: with its scales, while this thread's own
  // stores wrote V); native V may still be landing.
  if constexpr (kInt8)
    cp_async_wait_all();
  else
    cp_async_wait<1>();
  __syncthreads();

  // Scores: group grp takes tokens grp + 64i and grp + 32 + 64i; its 8
  // lanes split d, and each lane sums its slice of d in a fixed order
  // for 4 rows x 2 tokens (q read once for both tokens).  The 8 lanes'
  // partials of those 8 scores then meet in a transposed xor tree:
  // lanes 4 apart, then 2, then 1 exchange halves, so lane j ends with
  // score j in 7 shuffles.  Every score's sum has the one partition
  // ((j, j^4), (j^2, j^6)), ((j^1, j^5), (j^3, j^7)) whichever lane
  // ends with it, so a row's bits do not depend on the rows beside it.
  // Rows past R and tokens past n_tok are computed from clamped ones
  // and not stored; every group runs the same trip counts.
  {
    constexpr int TPG = kThreads / kGroup;  // token lanes per pass
    const int grp = tid / kGroup, j = tid % kGroup;
    const bool b2 = j & 4, b1 = j & 2, b0 = j & 1;
    for (int t00 = 0; t00 < n_tok; t00 += kScoreToks * TPG) {
      const int t0 = t00 + grp;
      float kf[kScoreToks][NCH * W];
#pragma unroll
      for (int u = 0; u < kScoreToks; ++u) {
        const int t = min(t0 + u * TPG, n_tok - 1);
        if constexpr (kInt8) {
          const float ks = sKs[t];
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            const int8_t* src = sK + t * D + W * j + 8 * W * ch;
            uint32_t w4[W / 4];
            if constexpr (W == 16) {
              const uint4 v = *reinterpret_cast<const uint4*>(src);
              w4[0] = v.x, w4[1] = v.y, w4[2] = v.z, w4[3] = v.w;
            } else {
              const uint2 v = *reinterpret_cast<const uint2*>(src);
              w4[0] = v.x, w4[1] = v.y;
            }
#pragma unroll
            for (int x = 0; x < W; ++x)
              kf[u][ch * W + x] = s8(w4[x / 4], x % 4) * ks;
          }
        } else {
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            float f[KW];
            unpack16<TKV>(*reinterpret_cast<const uint4*>(
                              sK + t * D + W * j + 8 * W * ch),
                          f);
#pragma unroll
            for (int x = 0; x < W; ++x) kf[u][ch * W + x] = f[x];
          }
        }
      }
      for (int r0 = 0; r0 < R; r0 += kScoreRows) {
        float v[kScoreRows * kScoreToks];  // [row][token]
#pragma unroll
        for (int i = 0; i < kScoreRows * kScoreToks; ++i) v[i] = 0.f;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int k4 = 0; k4 < W / 4; ++k4)
#pragma unroll
            for (int rs = 0; rs < kScoreRows; ++rs) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  sQ + min(r0 + rs, R - 1) * D + 4 * j + 8 * W * ch +
                  32 * k4);
#pragma unroll
              for (int u = 0; u < kScoreToks; ++u) {
                const float* kv = kf[u] + ch * W + 4 * k4;
                float& a = v[rs * kScoreToks + u];
                a = fmaf(qv.x, kv[0], a);
                a = fmaf(qv.y, kv[1], a);
                a = fmaf(qv.z, kv[2], a);
                a = fmaf(qv.w, kv[3], a);
              }
            }
        float h4[4], h2[2];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          h4[k] = (b2 ? v[k + 4] : v[k]) +
                  __shfl_xor_sync(0xffffffffu, b2 ? v[k] : v[k + 4], 4);
#pragma unroll
        for (int k = 0; k < 2; ++k)
          h2[k] = (b1 ? h4[k + 2] : h4[k]) +
                  __shfl_xor_sync(0xffffffffu, b1 ? h4[k] : h4[k + 2], 2);
        const float score =
            (b0 ? h2[1] : h2[0]) +
            __shfl_xor_sync(0xffffffffu, b0 ? h2[0] : h2[1], 1);
        const int r = r0 + j / kScoreToks;
        const int t = t0 + (j % kScoreToks) * TPG;
        if (r < R && t < n_tok) sP[r * T + t] = score;
      }
    }
  }
  __syncthreads();

  // The split's softmax, one warp a row: m over the visible scores,
  // p = exp(s - m) and 0 where masked, l = sum p.
  for (int r = warp; r < R; r += kWarps) {
    const int qpos = length + r % S;
    float* srow = sP + r * T;
    float mx = kNegInf;
    for (int t = lane; t < T; t += 32)
      if (t < n_tok && tok0 + t <= qpos) mx = fmaxf(mx, srow[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float p =
          t < n_tok && tok0 + t <= qpos ? expf(srow[t] - mx) : 0.f;
      srow[t] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      sM[r] = mx;
      sL[r] = l;
    }
  }
  // Native V's commit group in place too.
  if constexpr (!kInt8) cp_async_wait<0>();
  __syncthreads();

  // P·V: this thread's column quad cq of rows rb, rb + RS, ..., summed
  // over the split's tokens in order.
  const bool direct = nsplit == 1;
  const size_t slot = (size_t)bg * max_splits + split;
  float* wacc = work + slot * R * D;
  float* wml = work + (size_t)gridDim.x * max_splits * R * D + slot * 2 * R;
  const int cq = tid % Q4, rb = tid / Q4;
  for (int r0 = rb; r0 < R; r0 += RS * kRowsPerPass) {
    float acc[kRowsPerPass][4] = {};
    // acc += p[r][t] * v[t] for t in order: 4 tokens a step (p as a
    // float4), then the rest one by one.
    static_assert(kRowsPerPass == 4, "p below is a float4 per row");
    auto step = [&](int t, const float (&p)[kRowsPerPass]) {
      const float4 v = load4(sV + t * D + 4 * cq);
#pragma unroll
      for (int i = 0; i < kRowsPerPass; ++i) {
        if (r0 + RS * i < R) {
          acc[i][0] = fmaf(p[i], v.x, acc[i][0]);
          acc[i][1] = fmaf(p[i], v.y, acc[i][1]);
          acc[i][2] = fmaf(p[i], v.z, acc[i][2]);
          acc[i][3] = fmaf(p[i], v.w, acc[i][3]);
        }
      }
    };
    int rows[kRowsPerPass];  // rows past R read row R - 1, unused
#pragma unroll
    for (int i = 0; i < kRowsPerPass; ++i) rows[i] = min(r0 + RS * i, R - 1);
    int t = 0;
    for (; t + 4 <= n_tok; t += 4) {
      float4 p4[kRowsPerPass];
#pragma unroll
      for (int i = 0; i < kRowsPerPass; ++i)
        p4[i] = *reinterpret_cast<const float4*>(sP + rows[i] * T + t);
      const float p[4][kRowsPerPass] = {
          {p4[0].x, p4[1].x, p4[2].x, p4[3].x},
          {p4[0].y, p4[1].y, p4[2].y, p4[3].y},
          {p4[0].z, p4[1].z, p4[2].z, p4[3].z},
          {p4[0].w, p4[1].w, p4[2].w, p4[3].w}};
#pragma unroll
      for (int x = 0; x < 4; ++x) step(t + x, p[x]);
    }
    for (; t < n_tok; ++t) {
      float p[kRowsPerPass];
#pragma unroll
      for (int i = 0; i < kRowsPerPass; ++i) p[i] = sP[rows[i] * T + t];
      step(t, p);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerPass; ++i) {
      const int r = r0 + RS * i;
      if (r >= R) break;
      if (direct) {
        TQ* op = out + ((size_t)bg * R + r) * D + 4 * cq;
        const float ls = fmaxf(sL[r], 1e-30f);
#pragma unroll
        for (int x = 0; x < 4; ++x) op[x] = from_f<TQ>(acc[i][x] / ls);
      } else {
        *reinterpret_cast<float4*>(wacc + r * D + 4 * cq) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
  if (direct) return;
  for (int r = tid; r < R; r += kThreads) {
    wml[r] = sM[r];
    wml[R + r] = sL[r];
  }

  // The last of the slot's splits to finish merges them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bg, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* acc0 = work + (size_t)bg * max_splits * R * D;
  const float* ml0 = work + (size_t)gridDim.x * max_splits * R * D +
                     (size_t)bg * max_splits * 2 * R;
  // This thread's output quads e = tid, tid + kThreads, ...: row r,
  // lanes c..c+3, its splits' partials kMergeBatch at a time; the
  // first batch is in flight while the weights are worked out.
  float4 a[kMergeBatch];
  auto fetch = [&](int e, int s0) {
    const int r = e / Q4, c = 4 * (e - r * Q4);
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
      if (s0 + u < nsplit)
        a[u] = __ldcg(reinterpret_cast<const float4*>(
            acc0 + ((size_t)(s0 + u) * R + r) * D + c));
  };
  if (tid < R * Q4) fetch(tid, 0);
  // Every split's (m, l), then M = max m per row, then the weights
  // w_s = exp(m_s - M) in place of m.
  float* sWm = sP;               // [nsplit][R]
  float* sWl = sP + nsplit * R;  // [nsplit][R]
  for (int i0 = tid; i0 < nsplit * R; i0 += 2 * kThreads) {
    float m[2], l[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = i0 + x * kThreads, s = i / R, r = i - s * R;
      if (i < nsplit * R) {
        m[x] = __ldcg(ml0 + (size_t)s * 2 * R + r);
        l[x] = __ldcg(ml0 + (size_t)s * 2 * R + R + r);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = i0 + x * kThreads;
      if (i < nsplit * R) {
        sWm[i] = m[x];
        sWl[i] = l[x];
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) {
    float M = kNegInf;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, sWm[s * R + r]);
    sM[r] = M;
  }
  __syncthreads();
  for (int i = tid; i < nsplit * R; i += kThreads)
    sWm[i] = expf(sWm[i] - sM[i % R]);
  __syncthreads();
  // out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), both in split
  // order.
  for (int e = tid; e < R * Q4; e += kThreads) {
    const int r = e / Q4, c = 4 * (e - r * Q4);
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) L = fmaf(sWl[s * R + r], sWm[s * R + r], L);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nsplit; s0 += kMergeBatch) {
      if (e != tid || s0 != 0) fetch(e, s0);
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        if (s0 + u < nsplit) {
          const float w = sWm[(s0 + u) * R + r];
          o[0] = fmaf(a[u].x, w, o[0]);
          o[1] = fmaf(a[u].y, w, o[1]);
          o[2] = fmaf(a[u].z, w, o[2]);
          o[3] = fmaf(a[u].w, w, o[3]);
        }
    }
    const float ls = fmaxf(L, 1e-30f);
    TQ* op = out + ((size_t)bg * R + r) * D + c;
#pragma unroll
    for (int x = 0; x < 4; ++x) op[x] = from_f<TQ>(o[x] / ls);
  }
  if (tid == 0) tickets[bg] = 0;
}

template <typename TQ, typename TKV, int D>
int launch_split(const void* q, const void* k, const void* ks, const void* v,
                 const void* vs, void* out, void* work, void* tickets,
                 const int* tables, const int* lengths, int B, int h_kv,
                 int R, int S, int P, int ps, float sm_scale,
                 cudaStream_t stream) {
  const int splits = (P + kSplitPages - 1) / kSplitPages;
  const int T = kSplitPages * ps;
  const size_t smem = SplitLayout<TKV>(R, T, D, splits).bytes(T, D);
  if (smem > kMaxSmem || splits > 65535 || T % 4)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_split_kernel<TQ, TKV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  paged_decode_split_kernel<TQ, TKV, D>
      <<<dim3(B * h_kv, splits), kThreads, smem, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k),
          static_cast<const TKV*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<TQ*>(out),
          static_cast<float*>(work), static_cast<int*>(tickets), tables,
          lengths, h_kv, R, S, P, ps, sm_scale);
  return (int)cudaGetLastError();
}

// 0 if the shape and the buffers are ones the kernel takes: work and
// tickets given, q and the pools 16-byte aligned (cp.async and 16-byte
// loads).
int check_args(int B, int h_kv, int R, int S, int P, int ps, const void* q,
               const void* k, const void* v, const void* work,
               const void* tickets) {
  if (B <= 0 || h_kv <= 0 || R <= 0 || S <= 0 || R % S || P <= 0 ||
      ps <= 0 || work == nullptr || tickets == nullptr ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Pages per split, so the wrapper can size the workspace.
extern "C" int skyt_paged_split_pages() { return kSplitPages; }

// B1.  q/out [B, h_kv, R, d] in `dtype` (0 = float32, 1 = bfloat16); the
// pools [n_pages, h_kv, ps, d] in the same dtype; tables [B, P] and
// lengths [B] int32.  work: B * h_kv * ceil(P / split_pages) * R *
// (d + 2) f32, uninitialised; tickets: B * h_kv int32, 0 before the
// launch and 0 after it.  q and the pools must be 16-byte aligned.
// Returns a cudaError_t (0 on success).
extern "C" int skyt_paged_attention(const void* q, const void* k,
                                    const void* v, void* out, void* work,
                                    void* tickets, const int* tables,
                                    const int* lengths, int dtype, int B,
                                    int h_kv, int R, int S, int P, int ps,
                                    int d, float sm_scale, void* stream) {
  int rc = check_args(B, h_kv, R, S, P, ps, q, k, v, work, tickets);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SKYT_NATIVE(TQ, D)                                                 \
  launch_split<TQ, TQ, D>(q, k, nullptr, v, nullptr, out, work, tickets,   \
                          tables, lengths, B, h_kv, R, S, P, ps, sm_scale, \
                          s)
  if (dtype == 0 && d == 64) return SKYT_NATIVE(float, 64);
  if (dtype == 0 && d == 128) return SKYT_NATIVE(float, 128);
  if (dtype == 0 && d == 256) return SKYT_NATIVE(float, 256);
  if (dtype == 1 && d == 64) return SKYT_NATIVE(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) return SKYT_NATIVE(__nv_bfloat16, 128);
  if (dtype == 1 && d == 256) return SKYT_NATIVE(__nv_bfloat16, 256);
#undef SKYT_NATIVE
  return (int)cudaErrorInvalidValue;
}

// B2.  As B1 with int8 pools and f32 scales [n_pages, h_kv, ps]; q/out
// in `dtype` (0 = float32, 1 = bfloat16).
extern "C" int skyt_paged_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, void* out, void* work, void* tickets,
    const int* tables, const int* lengths, int dtype, int B, int h_kv,
    int R, int S, int P, int ps, int d, float sm_scale, void* stream) {
  int rc = check_args(B, h_kv, R, S, P, ps, q, k, v, work, tickets);
  if (rc) return rc;
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SKYT_INT8(TQ, D)                                                   \
  launch_split<TQ, int8_t, D>(q, k, k_scale, v, v_scale, out, work,        \
                              tickets, tables, lengths, B, h_kv, R, S, P,  \
                              ps, sm_scale, s)
  if (dtype == 0 && d == 64) return SKYT_INT8(float, 64);
  if (dtype == 0 && d == 128) return SKYT_INT8(float, 128);
  if (dtype == 0 && d == 256) return SKYT_INT8(float, 256);
  if (dtype == 1 && d == 64) return SKYT_INT8(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) return SKYT_INT8(__nv_bfloat16, 128);
  if (dtype == 1 && d == 256) return SKYT_INT8(__nv_bfloat16, 256);
#undef SKYT_INT8
  return (int)cudaErrorInvalidValue;
}
