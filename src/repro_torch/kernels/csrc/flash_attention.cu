// flash_attention: blocked online-softmax attention forward, head-major
// q (B, Hq, S, D), k and v (B, Hkv, S, D), grouped query heads reading KV
// head h / (Hq / Hkv), causal and sliding-window masks, float32 sums, the
// output in q's dtype.  Replaces the Pallas kernel of
// src/repro/kernels/flash_attention.py (flash_attention), whose grid walks
// the KV blocks of one q block in order with m, l and acc in VMEM scratch.
//
// Grid (B * Hq, ceil(S / FA_BQ)), FA_THREADS threads a block; the q blocks
// are taken last-first, so under a causal mask the longest rows start
// first.  A block holds FA_BQ query rows of one head in shared memory as
// float32, pre-scaled by 1/sqrt(D), and walks the KV tiles of FA_BK rows that
// its mask leaves visible (tiles wholly masked by the causal or window mask
// are skipped: the reference masks them, which changes no value).  Per tile:
//   1. K tile -> shared memory (float32, rows >= S zero);
//   2. scores: each thread a 4 x 4 micro-tile of rows ty + 16 i and
//      columns tx + 16 j, 16-byte shared loads, explicit fmaf; masked
//      scores are -1e30 (the reference's NEG_INF);
//   3. V tile -> the same buffer, while one warp per row runs the online
//      softmax (m_new = max(m, max s), p = exp(s - m_new) where visible
//      else 0, corr = exp(m - m_new), l = l corr + sum p; accurate expf);
//   4. acc = acc * corr + P V, each thread D/16 rows x 4 columns in
//      registers.
// The output is acc / max(l, 1e-37).  Rows are padded by 4 floats so that a
// quarter warp's 16-byte loads of 8 rows hit 32 different banks.
// Bound: at the reference bench's shapes the work is operations (about
// 1.1e12 FLOP at B 8, S 4096, Hq 32, D 128, causal), far above the card's
// operations-per-byte line; this first version does them on the float32
// FMA units, not the tensor cores, so it runs at a fraction of the bf16
// bound.  Shared memory for D 128: 85 760 bytes, two blocks an SM.
#include "dtype.cuh"

#define FA_THREADS 256
#define FA_WARPS (FA_THREADS / 32)
#define FA_BQ 64
#define FA_BK 64
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return kp < S && (!causal || qp >= kp) && (!window || qp - kp < window);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS, 2) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv, int S,
    int causal, int window, float scale) {
  constexpr int LD = D + 4;             // padded row of q, K and V tiles
  constexpr int LDP = FA_BK + 4;        // padded row of the score tile
  constexpr int QD = D / 4;             // column quads of a row
  constexpr int RG = FA_THREADS / QD;   // row groups of the P V phase
  constexpr int RPT = FA_BQ / RG;       // rows a thread accumulates
  static_assert(FA_THREADS % QD == 0 && FA_BQ % RG == 0, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // FA_BQ x LD
  float* kv_s = q_s + FA_BQ * LD;       // FA_BK x LD: K tile, then V tile
  float* p_s = kv_s + FA_BK * LD;       // FA_BQ x LDP
  float* m_s = p_s + FA_BQ * LDP;
  float* l_s = m_s + FA_BQ;
  float* c_s = l_s + FA_BQ;

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qg = q + ((size_t)bh * S + q0) * D;
  const T* kg = k + (size_t)(b * Hkv + hk) * S * D;
  const T* vg = v + (size_t)(b * Hkv + hk) * S * D;

  for (int i = tid; i < FA_BQ * QD; i += FA_THREADS) {
    const int r = i / QD;
    const int c = (i - r * QD) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = load4(qg + (size_t)r * D + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(q_s + r * LD + c) = x;
  }
  for (int r = tid; r < FA_BQ; r += FA_THREADS) {
    m_s[r] = FA_NEG_INF;
    l_s[r] = 0.f;
  }

  // KV tiles with at least one visible key for some row of this block
  const int k_end = causal ? min(S, q0 + FA_BQ) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;

  // the rows and column quad of this thread's accumulators
  const int cq = tid % QD;
  const int rg = tid / QD;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // score micro-tile coordinates
  const int tx = tid & 15;
  const int ty = tid >> 4;

  auto load_tile = [&](const T* src, int k0) {
    for (int i = tid; i < FA_BK * QD; i += FA_THREADS) {
      const int r = i / QD;
      const int c = (i - r * QD) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < S) x = load4(src + (size_t)(k0 + r) * D + c);
      *reinterpret_cast<float4*>(kv_s + r * LD + c) = x;
    }
  };

  for (int k0 = (k_begin / FA_BK) * FA_BK; k0 < k_end; k0 += FA_BK) {
    __syncthreads();                    // the last tile's P V is done
    load_tile(kg, k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        p_s[r * LDP + c] =
            visible(q0 + r, k0 + c, S, causal, window) ? s[i][j] : FA_NEG_INF;
      }
    }
    __syncthreads();                    // scores written, K tile read out

    load_tile(vg, k0);
    for (int r = warp; r < FA_BQ; r += FA_WARPS) {
      float* pr = p_s + r * LDP;
      const float a0 = pr[lane];
      const float a1 = pr[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a0, a1)));
      const float e0 =
          visible(q0 + r, k0 + lane, S, causal, window) ? expf(a0 - m_new)
                                                         : 0.f;
      const float e1 =
          visible(q0 + r, k0 + lane + 32, S, causal, window)
              ? expf(a1 - m_new) : 0.f;
      pr[lane] = e0;
      pr[lane + 32] = e1;
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();                    // V tile, p and corr in place

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = c_s[rg + RG * i];
      acc[i][0] *= corr;
      acc[i][1] *= corr;
      acc[i][2] *= corr;
      acc[i][3] *= corr;
    }
#pragma unroll 2
    for (int kk = 0; kk < FA_BK; kk += 4) {
      float4 vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = *reinterpret_cast<const float4*>(kv_s + (kk + u) * LD + 4 * cq);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(
            p_s + (rg + RG * i) * LDP + kk);
        const float pu[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(pu[u], vv[u].x, acc[i][0]);
          acc[i][1] = fmaf(pu[u], vv[u].y, acc[i][1]);
          acc[i][2] = fmaf(pu[u], vv[u].z, acc[i][2]);
          acc[i][3] = fmaf(pu[u], vv[u].w, acc[i][3]);
        }
      }
    }
  }

  T* og = out + ((size_t)bh * S + q0) * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (q0 + r < S) {
      const float l = fmaxf(l_s[r], 1e-37f);
      store4(og + (size_t)r * D + 4 * cq,
             make_float4(acc[i][0] / l, acc[i][1] / l, acc[i][2] / l,
                         acc[i][3] / l));
    }
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Hq, int Hkv, int S, int causal, int window,
                  float scale, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * Hq, (S + FA_BQ - 1) / FA_BQ);
  flash_fwd_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, S, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* out,
                    int B, int Hq, int Hkv, int S, int D, int causal,
                    int window, float scale, int smem, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Hq, Hkv, S, causal, window,
                           scale, smem, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Hq, Hkv, S, causal, window,
                           scale, smem, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, S, causal, window,
                            scale, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16; window 0 means none.  Returns
// cudaGetLastError() after the launch (or the error of the shared-memory
// opt-in; cudaErrorInvalidValue for a head_dim without an instance).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Hq, int Hkv, int S, int D,
                                      int causal, int window, int dtype,
                                      float scale, int smem, void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, D, causal,
                                   window, scale, smem, s);
  return launch_d<float>(q, k, v, out, B, Hq, Hkv, S, D, causal, window,
                         scale, smem, s);
}
