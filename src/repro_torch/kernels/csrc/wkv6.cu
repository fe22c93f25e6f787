// wkv6: the RWKV-6 recurrence, per (batch, head),
//   out_t = r_t . (S + (u * k_t) v_t^T),   S <- diag(exp(log_w_t)) S + k_t v_t^T,
// with r, k, v, log_w (B, S, H, D), u (H, D), the D x D state in float32 and
// the output in r's dtype.  Replaces the Pallas kernel of
// src/repro/kernels/wkv6.py (wkv6), whose grid (B, H, chunks) streams time
// through VMEM in chunks with the state in VMEM scratch.
//
// The work is bound by bytes: each input is read once and the output written
// once, 1.0 GB at rwkv6-3b's width (B 8, S 4096, H 40, D 64; bf16 r, k, v,
// float32 log_w): 0.30 ms at 3.35 TB/s.  Two instances, picked by dtype.
//
// Instance chunk_tc_bf16 (bf16 r, k, v; log_w in bf16 or float32; D 32 or
// 64).  The chunked form of the recurrence (wkv_chunked of the reference's
// model): time in chunks of TC_C = 32 steps, and inside a chunk the decays
// as products of w = exp(log_w) that restart at each quarter of TC_Q = 8
// steps, so every factor is a product of w's (each <= 1) and nothing
// overflows, whatever the decays.  With c the inclusive and ce the exclusive
// cumulative log-decay of the chunk, per chunk
//   y = (r o exp(ce)) S_prev + A V,
//   S = S_prev o exp(c_last) + (k o exp(c_last - c))^T V,
// where A (TC_C x TC_C, lower triangle) holds
//   A[t][s] = sum_d r_td k_sd exp(ce_td - c_sd)  (s < t),
//   A[t][t] = r_t . (u o k_t):
// the 16 x 16 block between the chunk's two subchunks of 16 steps as the
// product (r o exp(ce - ref_1)) (k o exp(ref_1 - c))^T with ref_1 the
// exclusive sum at step 16, the 8 x 8 block between the two quarters of each
// subchunk the same way about the quarter boundary (both on the tensor cores
// in fp16: the operands are r and k scaled by factors <= 1), and the four
// 8 x 8 diagonal blocks element by element in float32, exp(ce_t - c_s)
// carried as a running product of w along t and the sum over d taken across
// the warp by a reduce-scatter of shuffles.  The other products run on the
// tensor cores too (mma.sync m16n8k16, float32 accumulators) with every
// operand that is not an input a bf16 pair hi + lo (about 16 significant
// bits): the state, r o exp(ce), k o exp(c_last - c) and A.  One bf16
// rounding of those is up to 2^-9 of each term, and the sums over d and s
// cancel rows of the output down far below their terms: an error of a few
// percent of a row.  The state stays in float32 registers across chunks.
// Block: one (b, h), four warps; warp w owns the state's columns e of
// [16w, 16w + 16) as S^T in mma accumulator layout, which is also the B
// operand layout of (r o exp(ce)) S, so the state never leaves the registers.
// The chunks stream through a ring of two stages in shared memory, each
// filled by four TMA boxes that one thread issues (v swizzled for
// ldmatrix; rows past S zero-filled) and guarded by an mbarrier, so that
// chunk c + 1 loads while chunk c computes and no thread spends issue slots
// on addresses; 76 304 bytes at D 64 and at most 168 registers a thread,
// so three blocks share an SM and all B * H = 320 blocks of the bench shape
// are in flight at once.  One exponential an element (w) and eight a thread
// a chunk (the quarters' decays); four barriers a chunk; no atomics, so
// two calls give the same bits.
//
// Instance scalar_f32 (float32 r, k, v; its 5e-5 limit is beyond bf16 and
// TF32 products): grid (B * H), D threads a block.  Thread e owns column e
// of the state, S[:, e], in registers (WKV_DMAX of them, indexed only by
// unrolled constants), so out_e = sum_d r_d (S[d][e] + u_d k_d v_e) needs no
// exchange between threads.  Time is streamed in chunks of tc steps: the
// block copies the chunk's r, k, v and exp(log_w) into shared memory, and
// runs the tc steps with every thread reading r_t, k_t, w_t as broadcasts.
// Accurate expf; explicit fmaf.
#include <cuda_fp16.h>

#include "dtype.cuh"
#include "mma.cuh"
#include "tma.cuh"

#define WKV_DMAX 64

template <typename T, typename TW>
__global__ void __launch_bounds__(WKV_DMAX) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const TW* __restrict__ log_w,
    const float* __restrict__ u, T* __restrict__ out, int S, int H, int D,
    int tc) {
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                    // tc x D
  float* k_s = r_s + tc * D;
  float* w_s = k_s + tc * D;            // exp(log_w)
  float* v_s = w_s + tc * D;
  float* u_s = v_s + tc * D;            // D

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int e = threadIdx.x;
  const size_t step = (size_t)H * D;               // between time steps
  const size_t base = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)

  u_s[e] = u[(size_t)h * D + e];
  float st[WKV_DMAX];                   // st[d] = S[d][e]
#pragma unroll
  for (int d = 0; d < WKV_DMAX; ++d) st[d] = 0.f;

  for (int t0 = 0; t0 < S; t0 += tc) {
    const int n = min(tc, S - t0);
    __syncthreads();                    // the last chunk is read out
    for (int j = 0; j < n; ++j) {
      const size_t g = base + (size_t)(t0 + j) * step + e;
      r_s[j * D + e] = to_f32(r[g]);
      k_s[j * D + e] = to_f32(k[g]);
      v_s[j * D + e] = to_f32(v[g]);
      w_s[j * D + e] = expf(to_f32(log_w[g]));
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* rj = r_s + j * D;
      const float* kj = k_s + j * D;
      const float* wj = w_s + j * D;
      const float ve = v_s[j * D + e];
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int d = 0; d < WKV_DMAX; d += 4) {
        if (d < D) {                    // uniform across the block
          const float4 rr = *reinterpret_cast<const float4*>(rj + d);
          const float4 kk = *reinterpret_cast<const float4*>(kj + d);
          const float4 ww = *reinterpret_cast<const float4*>(wj + d);
          const float4 uu = *reinterpret_cast<const float4*>(u_s + d);
          float kv;
          kv = kk.x * ve;
          o0 = fmaf(rr.x, fmaf(uu.x, kv, st[d]), o0);
          st[d] = fmaf(st[d], ww.x, kv);
          kv = kk.y * ve;
          o1 = fmaf(rr.y, fmaf(uu.y, kv, st[d + 1]), o1);
          st[d + 1] = fmaf(st[d + 1], ww.y, kv);
          kv = kk.z * ve;
          o2 = fmaf(rr.z, fmaf(uu.z, kv, st[d + 2]), o2);
          st[d + 2] = fmaf(st[d + 2], ww.z, kv);
          kv = kk.w * ve;
          o3 = fmaf(rr.w, fmaf(uu.w, kv, st[d + 3]), o3);
          st[d + 3] = fmaf(st[d + 3], ww.w, kv);
        }
      }
      out[base + (size_t)(t0 + j) * step + e] = from_f32<T>((o0 + o1) + (o2 + o3));
    }
  }
}

template <typename T, typename TW>
static int launch(const void* r, const void* k, const void* v,
                  const void* log_w, const void* u, void* out, int B, int S,
                  int H, int D, int tc, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  wkv6_kernel<T, TW><<<B * H, D, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const TW*)log_w,
      (const float*)u, (T*)out, S, H, D, tc);
  return (int)cudaGetLastError();
}

// -- chunk_tc_bf16 -------------------------------------------------------------

#define TC_C 32         // steps a chunk
#define TC_Q 8          // steps a quarter: the element-by-element blocks
#define TC_THREADS 128  // four warps
#define TC_LOG2E 1.4426950408889634f

// Shared memory of one block, in bytes, from a base aligned to 1024 (the
// kernel aligns it; BYTES counts the slack): two ring stages, each the TMA
// boxes of one chunk (v swizzled for ldmatrix, r, k and log_w dense), then
// the chunk's operand tiles (rows padded to LDT; the two that meet the
// state and the score tile each as a bf16 pair hi + lo, the four of the
// products between reference points in fp16), the state's decay over the
// chunk, u, each quarter's summed log decay, and the stages' mbarriers.
template <int D, typename TW>
struct TcLayout {
  static constexpr int LDT = D + 8;  // 16-bit row stride of an operand tile
  static constexpr int LDA = TC_C + 8;
  static constexpr int V_OFF = 0;
  static constexpr int R_OFF = V_OFF + TC_C * D * 2;
  static constexpr int K_OFF = R_OFF + TC_C * D * 2;
  static constexpr int W_OFF = K_OFF + TC_C * D * 2;
  static constexpr int STAGE = W_OFF + TC_C * D * (int)sizeof(TW);
  static constexpr int TILE = TC_C * LDT * 2;    // 32 rows
  static constexpr int HALF = 16 * LDT * 2;      // 16 rows
  static constexpr int ATILE = TC_C * LDA * 2;
  static constexpr int RH = 2 * STAGE;           // r o exp(ce): hi, then lo
  static constexpr int KH = RH + 2 * TILE;       // k o exp(c_last - c): hi, lo
  static constexpr int RT1 = KH + 2 * TILE;      // subchunk 1's r, from step 16
  static constexpr int KT0 = RT1 + HALF;         // subchunk 0's k, to step 15
  static constexpr int RQO = KT0 + HALF;         // quarters 1, 3: r from their start
  static constexpr int KQE = RQO + HALF;         // quarters 0, 2: k to their end
  static constexpr int AS = KQE + HALF;          // scores A: hi, then lo
  static constexpr int DEC = AS + 2 * ATILE;     // exp(c_last), D floats
  static constexpr int US = DEC + D * 4;         // u, D floats
  static constexpr int TQ = US + D * 4;          // quarters' log decay, 4 x D
  static constexpr int BAR = TQ + 4 * D * 4;     // two mbarriers
  static constexpr int BYTES = BAR + 16 + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two consecutive elements as float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// x as a bf16 pair hi + lo (about 16 significant bits), two at a time
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// two floats into the hi and lo tiles at element offset `at`
__device__ __forceinline__ void store_split(__nv_bfloat16* hi_tile,
                                            int lo_offset, int at, float x0,
                                            float x1) {
  uint32_t hi, lo;
  split_pair(x0, x1, hi, lo);
  *reinterpret_cast<uint32_t*>(hi_tile + at) = hi;
  *reinterpret_cast<uint32_t*>(hi_tile + lo_offset + at) = lo;
}

__device__ __forceinline__ void store_half2(__half* p, float x0, float x1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x0, x1);
}

// c += a (16 x 16, row) * b (16 x 8, col), fp16 in, float32 accumulate
__device__ __forceinline__ void mma_16816_f16(float* c, const unsigned* a,
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix lane address of a 16 x 16 block at (row0, col0) of a row-major
// 16-bit tile: as an A operand (non-transposed), or a B operand stored
// [k][n] (transposed): n-tile col0 is {r0, r1}, n-tile col0 + 8 {r2, r3}.
__device__ __forceinline__ uint32_t frag_a(const void* tile, int ld, int row0,
                                           int col0, int lane) {
  return smem_u32(reinterpret_cast<const uint16_t*>(tile) +
                  (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}
// ... or a B operand stored [n][k] (non-transposed): n-tile n0 is
// {r0, r1}, n-tile n0 + 8 is {r2, r3}
__device__ __forceinline__ uint32_t frag_bn(const void* tile, int ld, int n0,
                                            int k0, int lane) {
  return smem_u32(reinterpret_cast<const uint16_t*>(tile) +
                  (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                  ((lane >> 3) & 1) * 8);
}

// ldmatrix lane address of the 16 x 16 block at (row0, col0) of the v box,
// which TMA wrote with its 128-byte (D 64) or 64-byte (D 32) swizzle: the
// 16-byte piece c of row r lies at piece c ^ (r & 7), or c ^ ((r / 2) & 3).
template <int D>
__device__ __forceinline__ uint32_t frag_v(const unsigned char* vs, int row0,
                                           int col0, int lane) {
  const int row = row0 + (lane & 15);
  const int piece = (col0 >> 3) + (lane >> 4);
  const int sw = D == 64 ? (row & 7) : ((row >> 1) & 3);
  return smem_u32(vs + row * D * 2 + ((piece ^ sw) << 4));
}

// Reduce-scatter over the warp: v[0..2N) per lane in, and after the fold of
// every lane bit below 2N, v[0] of lane L holds the sum over the 32 lanes
// of the entry whose index is L's low bits.
template <int N>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

// One chunk's four boxes (v, r, k, log_w of steps t0 .. t0 + 31 of (b, h))
// into a ring stage by TMA, completion on `bar`; rows past S arrive as
// zeros.  One thread issues it.
template <int D, typename TW>
__device__ __forceinline__ void load_chunk(
    unsigned char* stage, uint32_t bar, const CUtensorMap* mv,
    const CUtensorMap* mr, const CUtensorMap* mk, const CUtensorMap* mw,
    int b, int h, int t0) {
  using L = TcLayout<D, TW>;
  // the stage's last reads were generic-proxy loads; order them before the
  // async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, L::STAGE);
  tma_load_4d(smem_u32(stage + L::V_OFF), mv, 0, h, t0, b, bar);
  tma_load_4d(smem_u32(stage + L::R_OFF), mr, 0, h, t0, b, bar);
  tma_load_4d(smem_u32(stage + L::K_OFF), mk, 0, h, t0, b, bar);
  tma_load_4d(smem_u32(stage + L::W_OFF), mw, 0, h, t0, b, bar);
}

// The 8 x 8 diagonal block of quarter qq, element by element in float32:
// each lane sums its two columns, carrying p = k_s o prod_{s < j < t} w_j
// along t, and fold() sums over the warp.  Entry L < 28 is the pair (t, s),
// s < t, with L = t (t - 1) / 2 + s; entries 28..31 and the four more of x
// are A[t][t] = r_t . (u o k_t) (lane L writes entry L; lanes 0..3 those
// of x, t = 4 + L).
template <int D, typename TW>
__device__ __forceinline__ void diag_scores(
    unsigned char* sm, int qq, int lane, int my_t, int my_s,
    const float (&rv)[TC_Q][2], const float (&kv)[TC_Q][2],
    const float (&w)[TC_Q][2], float u0, float u1) {
  using L = TcLayout<D, TW>;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(sm + L::AS);
  float a[32], x[4];
#pragma unroll
  for (int s = 0; s < TC_Q - 1; ++s) {
    float p0 = kv[s][0], p1 = kv[s][1];
#pragma unroll
    for (int t = s + 1; t < TC_Q; ++t) {
      a[t * (t - 1) / 2 + s] = fmaf(rv[t][0], p0, rv[t][1] * p1);
      p0 *= w[t][0];
      p1 *= w[t][1];
    }
  }
#pragma unroll
  for (int t = 0; t < TC_Q; ++t) {
    const float b = fmaf(rv[t][0] * u0, kv[t][0], rv[t][1] * u1 * kv[t][1]);
    if (t < 4) a[28 + t] = b;
    else x[t - 4] = b;
  }
  fold<16>(a, lane);
  fold<8>(a, lane);
  fold<4>(a, lane);
  fold<2>(a, lane);
  fold<1>(a, lane);
  fold<2>(x, lane);
  fold<1>(x, lane);
#pragma unroll
  for (int m = 4; m <= 16; m <<= 1)
    x[0] += __shfl_xor_sync(0xffffffffu, x[0], m);
  const int lo = TC_C * L::LDA;
  const int row = TC_Q * qq + my_t, col = TC_Q * qq + my_s;
  const __nv_bfloat16 h = __float2bfloat16(a[0]);
  as[row * L::LDA + col] = h;
  as[lo + row * L::LDA + col] = __float2bfloat16(a[0] - __bfloat162float(h));
  if (lane < 4) {
    const int t = TC_Q * qq + 4 + lane;
    const __nv_bfloat16 hb = __float2bfloat16(x[0]);
    as[t * L::LDA + t] = hb;
    as[lo + t * L::LDA + t] = __float2bfloat16(x[0] - __bfloat162float(hb));
  }
}

// The chunk's factors.  Warp qq takes quarter qq (steps 8qq .. 8qq + 7),
// lane dp the columns d = 2dp, 2dp + 1.  Inside the quarter r is scaled by
// the running product of w from the quarter's start (exclusive) and k by
// the product to its end; products of whole quarters (exp2 of their summed
// log2 decay) move each to the reference point a tile needs.  Each warp
// sums its own quarter's log decay and publishes it; the diagonal block runs
// before the barrier that makes the four sums visible.  Lanes past D / 2
// (D 32) hold zeros, for the sums over the warp.  Every thread of the block
// calls it (it holds a barrier).
template <int D, typename TW>
__device__ __forceinline__ void chunk_factors(const unsigned char* stage,
                                              unsigned char* sm, int qq,
                                              int lane, int my_t, int my_s) {
  using L = TcLayout<D, TW>;
  constexpr int LDT = L::LDT;
  const bool live = lane < D / 2;
  const int d = live ? 2 * lane : 0;
  const TW* lw = reinterpret_cast<const TW*>(stage + L::W_OFF);
  const __nv_bfloat16* rr =
      reinterpret_cast<const __nv_bfloat16*>(stage + L::R_OFF);
  const __nv_bfloat16* kk =
      reinterpret_cast<const __nv_bfloat16*>(stage + L::K_OFF);
  __nv_bfloat16* rh = reinterpret_cast<__nv_bfloat16*>(sm + L::RH);
  __nv_bfloat16* kh = reinterpret_cast<__nv_bfloat16*>(sm + L::KH);
  __half* rt1 = reinterpret_cast<__half*>(sm + L::RT1);
  __half* kt0 = reinterpret_cast<__half*>(sm + L::KT0);
  __half* rqo = reinterpret_cast<__half*>(sm + L::RQO);
  __half* kqe = reinterpret_cast<__half*>(sm + L::KQE);
  constexpr int LO = TC_C * LDT;                   // hi tile -> lo tile

  float tot[4][2], w[TC_Q][2], rv[TC_Q][2], kv[TC_Q][2];
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < TC_Q; ++j) {
    const int t = TC_Q * qq + j;
    const float2 l = load2(lw + t * D + d);
    const float2 r2 = load2(rr + t * D + d);
    const float2 k2 = load2(kk + t * D + d);
    s0 += l.x;
    s1 += l.y;
    w[j][0] = ex2(l.x * TC_LOG2E);
    w[j][1] = ex2(l.y * TC_LOG2E);
    rv[j][0] = live ? r2.x : 0.f;
    rv[j][1] = live ? r2.y : 0.f;
    kv[j][0] = live ? k2.x : 0.f;
    kv[j][1] = live ? k2.y : 0.f;
  }
  float* tq = reinterpret_cast<float*>(sm + L::TQ);
  if (live)
    *reinterpret_cast<float2*>(tq + qq * D + d) = make_float2(s0, s1);
  const float* us = reinterpret_cast<const float*>(sm + L::US);
  diag_scores<D, TW>(sm, qq, lane, my_t, my_s, rv, kv, w, us[d], us[d + 1]);
  __syncthreads();  // the four quarters' sums are visible
  if (!live) return;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float2 l = *reinterpret_cast<const float2*>(tq + x * D + d);
    tot[x][0] = ex2(l.x * TC_LOG2E);
    tot[x][1] = ex2(l.y * TC_LOG2E);
  }
  float pre0 = 1.f, pre1 = 1.f, post0 = 1.f, post1 = 1.f;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (x < qq) {
      pre0 *= tot[x][0];
      pre1 *= tot[x][1];
    } else if (x > qq) {
      post0 *= tot[x][0];
      post1 *= tot[x][1];
    }
  }
  // forward: r_t * prod_{quarter start <= j < t} w_j
  float e0 = 1.f, e1 = 1.f;
#pragma unroll
  for (int j = 0; j < TC_Q; ++j) {
    const int t = TC_Q * qq + j;
    const float x0 = rv[j][0] * e0, x1 = rv[j][1] * e1;
    store_split(rh, LO, t * LDT + d, x0 * pre0, x1 * pre1);
    if (qq == 1) store_half2(rqo + j * LDT + d, x0, x1);
    if (qq == 2) store_half2(rt1 + j * LDT + d, x0, x1);
    if (qq == 3) {
      store_half2(rt1 + (TC_Q + j) * LDT + d, x0 * tot[2][0], x1 * tot[2][1]);
      store_half2(rqo + (TC_Q + j) * LDT + d, x0, x1);
    }
    e0 *= w[j][0];
    e1 *= w[j][1];
  }
  // backward: k_s * prod_{s < j <= quarter end} w_j
  float f0 = 1.f, f1 = 1.f;
#pragma unroll
  for (int j = TC_Q - 1; j >= 0; --j) {
    const int t = TC_Q * qq + j;
    const float y0 = kv[j][0] * f0, y1 = kv[j][1] * f1;
    store_split(kh, LO, t * LDT + d, y0 * post0, y1 * post1);
    if (qq == 0) {
      store_half2(kt0 + j * LDT + d, y0 * tot[1][0], y1 * tot[1][1]);
      store_half2(kqe + j * LDT + d, y0, y1);
    }
    if (qq == 1) store_half2(kt0 + (TC_Q + j) * LDT + d, y0, y1);
    if (qq == 2) store_half2(kqe + (TC_Q + j) * LDT + d, y0, y1);
    f0 *= w[j][0];
    f1 *= w[j][1];
  }
  if (qq == 0) {
    float* dec = reinterpret_cast<float*>(sm + L::DEC);
    dec[d] = (tot[0][0] * tot[1][0]) * (tot[2][0] * tot[3][0]);
    dec[d + 1] = (tot[0][1] * tot[1][1]) * (tot[2][1] * tot[3][1]);
  }
}

// The blocks of A between reference points, on the tensor cores in fp16
// (the operands are r and k times products of w, so within r's and k's
// range), one 16 x 8 product a warp.  Warps 0 and 1: rows 16..31 x columns
// 8w..8w + 7, subchunk 1's r from step 16 times subchunk 0's k to step 15.
// Warps 2 and 3: the blocks between the quarters of each subchunk (rows of
// quarters 1 and 3 from their start, k of quarters 0 and 2 to their end);
// warp 2 keeps rows 8..15 x columns 0..7, warp 3 rows 24..31 x 16..23.
template <int D, typename TW>
__device__ __forceinline__ void cross_scores(unsigned char* sm, int warp,
                                             int lane) {
  using L = TcLayout<D, TW>;
  const bool sub = warp < 2;
  const int n = warp & 1;
  const void* ra = sm + (sub ? L::RT1 : L::RQO);
  const void* kb = sm + (sub ? L::KT0 : L::KQE);
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(sm + L::AS);
  constexpr int LO = TC_C * L::LDA;
  float c[4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(frag_a(ra, L::LDT, 0, 16 * kk, lane), a[0], a[1], a[2], a[3]);
    ldsm_x4(frag_bn(kb, L::LDT, 0, 16 * kk, lane), b[0], b[1], b[2], b[3]);
    mma_16816_f16(c, a, n ? b[2] : b[0], n ? b[3] : b[1]);
  }
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  if (sub) {
    store_split(as, LO, (16 + g) * L::LDA + 8 * n + q2, c[0], c[1]);
    store_split(as, LO, (24 + g) * L::LDA + 8 * n + q2, c[2], c[3]);
  } else if (n == 0) {
    store_split(as, LO, (TC_Q + g) * L::LDA + q2, c[0], c[1]);
  } else {
    store_split(as, LO, (24 + g) * L::LDA + 16 + q2, c[2], c[3]);
  }
}

// y += (r o exp(ce)) S_prev for this warp's 16 columns, every operand a
// bf16 pair hi + lo (hi hi + hi lo + lo hi): the A operand from its two
// tiles, the B operand from the state's accumulator fragments.  One bf16
// operand would round each S[d][e], a sum over past steps, by up to 2^-9
// on its own, and r . S[:, e] cancels those sums down by about sqrt(D): an
// error of a few percent of a row.
template <int D, typename TW>
__device__ __forceinline__ void inter_product(const unsigned char* sm,
                                              const float (&st)[D / 8][4],
                                              float (&y)[2][2][4], int lane) {
  using L = TcLayout<D, TW>;
  const unsigned char* rh = sm + L::RH;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[2][2][2];  // [n tile][k half][hi, lo]
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        split_pair(st[2 * kk + hf][2 * n], st[2 * kk + hf][2 * n + 1],
                   b[n][hf][0], b[n][hf][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4], al[4];
      ldsm_x4(frag_a(rh, L::LDT, 16 * mt, 16 * kk, lane), a[0], a[1], a[2],
              a[3]);
      ldsm_x4(frag_a(rh + L::TILE, L::LDT, 16 * mt, 16 * kk, lane), al[0],
              al[1], al[2], al[3]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_16816(y[mt][n], a, b[n][0][0], b[n][1][0]);
        mma_16816(y[mt][n], a, b[n][0][1], b[n][1][1]);
        mma_16816(y[mt][n], al, b[n][0][0], b[n][1][0]);
      }
    }
  }
}

// S^T <- S^T o exp(c_last) + V^T (k o exp(c_last - c)) for this warp's rows
// e of S^T; vt holds the A fragments of V^T for the two 16-step halves, and
// the B operand is the pair hi + lo.
template <int D, typename TW>
__device__ __forceinline__ void carry_state(const unsigned char* sm,
                                            float (&st)[D / 8][4],
                                            const uint32_t (&vt)[2][4],
                                            int lane) {
  using L = TcLayout<D, TW>;
  const unsigned char* kh = sm + L::KH;
  const float* dec = reinterpret_cast<const float*>(sm + L::DEC);
  const int q2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float2 f = *reinterpret_cast<const float2*>(dec + 8 * n + q2);
    st[n][0] *= f.x;
    st[n][1] *= f.y;
    st[n][2] *= f.x;
    st[n][3] *= f.y;
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        uint32_t b[4];
        ldsm_x4_trans(frag_a(kh + part * L::TILE, L::LDT, 16 * kk, 16 * j,
                             lane),
                      b[0], b[1], b[2], b[3]);
        mma_16816(st[2 * j], vt[kk], b[0], b[1]);
        mma_16816(st[2 * j + 1], vt[kk], b[2], b[3]);
      }
    }
  }
}

// The chunk's output for this warp's columns [e0, e0 + 16) and the state's
// carry: y (holding (r o exp(ce)) S_prev) += A V (A as hi + lo); V comes by
// ldmatrix.trans, once for A V (as B) and for the carry (as the A operand
// V^T).
template <int D, typename TW>
__device__ __forceinline__ void chunk_outputs(
    const unsigned char* stage, const unsigned char* sm,
    float (&st)[D / 8][4], float (&y)[2][2][4],
    __nv_bfloat16* __restrict__ out, size_t base, size_t step, int t0, int S,
    int e0, int lane) {
  using L = TcLayout<D, TW>;
  const unsigned char* vs = stage + L::V_OFF;
  const unsigned char* as = sm + L::AS;
  uint32_t vt[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t m[4];
    ldsm_x4_trans(frag_v<D>(vs, 16 * kk, e0, lane), m[0], m[1], m[2], m[3]);
    vt[kk][0] = m[0];
    vt[kk][1] = m[2];
    vt[kk][2] = m[1];
    vt[kk][3] = m[3];
#pragma unroll
    for (int mt = kk; mt < 2; ++mt) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        uint32_t a[4];
        ldsm_x4(frag_a(as + part * L::ATILE, L::LDA, 16 * mt, 16 * kk, lane),
                a[0], a[1], a[2], a[3]);
        mma_16816(y[mt][0], a, m[0], m[1]);
        mma_16816(y[mt][1], a, m[2], m[3]);
      }
    }
  }
  carry_state<D, TW>(sm, st, vt, lane);
  const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = t0 + 16 * mt + 8 * hf + g;
      if (t < S) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<uint32_t*>(out + base + (size_t)t * step + e0 +
                                       8 * n + q2) =
              pack_bf16(y[mt][n][2 * hf], y[mt][n][2 * hf + 1]);
      }
    }
  }
}

template <int D, typename TW>
__global__ void __launch_bounds__(TC_THREADS, 3) wkv6_tc_kernel(
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_r,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ u,
    __nv_bfloat16* __restrict__ out, int S, int H) {
  static_assert(D == 32 || D == 64, "head_dim 32 or 64");
  using L = TcLayout<D, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t step = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;
  const int n_chunks = (S + TC_C - 1) / TC_C;
  const uint32_t bar0 = smem_u32(sm + L::BAR);
  // the diagonal-block entry this lane writes (diag_scores): a pair (t, s)
  // with lane = t (t - 1) / 2 + s, or for lanes 28..31 the bonus of t = s
  int my_t = 1;
  while (my_t * (my_t + 1) / 2 <= lane && my_t < TC_Q - 1) ++my_t;
  int my_s = lane - my_t * (my_t - 1) / 2;
  if (lane >= 28) my_t = my_s = lane - 28;

  // entries of A above the diagonal are never written: zero them once
  uint32_t* a32 = reinterpret_cast<uint32_t*>(sm + L::AS);
  for (int i = tid; i < TC_C * L::LDA; i += TC_THREADS) a32[i] = 0u;
  float* us = reinterpret_cast<float*>(sm + L::US);
  for (int i = tid; i < D; i += TC_THREADS) us[i] = u[(size_t)h * D + i];
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_chunk<D, TW>(sm, bar0, &tm_v, &tm_r, &tm_k, &tm_w, b, h, 0);
  }

  float st[D / 8][4];                   // S^T, rows [16 warp, 16 warp + 16)
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;

  __syncthreads();  // the barriers' init and the zeroed A are visible
  for (int c = 0; c < n_chunks; ++c) {
    const unsigned char* stage = sm + (c & 1) * L::STAGE;
    mbar_wait(bar0 + 8 * (c & 1), (c >> 1) & 1);  // chunk c has landed
    __syncthreads();                              // chunk c - 1 is read out
    if (tid == 0 && c + 1 < n_chunks)
      load_chunk<D, TW>(sm + ((c + 1) & 1) * L::STAGE, bar0 + 8 * ((c + 1) & 1),
                        &tm_v, &tm_r, &tm_k, &tm_w, b, h, (c + 1) * TC_C);
    chunk_factors<D, TW>(stage, sm, warp, lane, my_t, my_s);
    __syncthreads();
    cross_scores<D, TW>(sm, warp, lane);
    __syncthreads();
    if (warp < D / 16) {
      float y[2][2][4] = {};
      inter_product<D, TW>(sm, st, y, lane);
      chunk_outputs<D, TW>(stage, sm, st, y, out, base, step, c * TC_C, S,
                           16 * warp, lane);
    }
  }
}

// A (B, S, H, D) tensor as a 4-D tensor map whose boxes are one chunk of
// one (b, h): D x 1 x TC_C x 1, rows past S zero-filled.  Returns 0, or the
// negated CUresult.
static int chunk_map(CUtensorMap* map, const void* base,
                     CUtensorMapDataType type, int elem, int B, int S, int H,
                     int D, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * elem,
                                 (cuuint64_t)H * D * elem,
                                 (cuuint64_t)S * H * D * elem};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, TC_C, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// The kernel's shared-memory opt-in, and the carveout that lets three
// blocks share an SM.
template <int D, typename TW>
static cudaError_t tc_opt_in() {
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_tc_kernel<D, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TcLayout<D, TW>::BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv6_tc_kernel<D, TW>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int D, typename TW>
static int launch_tc(const void* r, const void* k, const void* v,
                     const void* log_w, const void* u, void* out, int B,
                     int S, int H, int smem, cudaStream_t stream) {
  if (smem != TcLayout<D, TW>::BYTES) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType wt = sizeof(TW) == 4
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap mv, mr, mk, mw;
  int m = chunk_map(&mv, v, bf, 2, B, S, H, D,
                    D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B);
  if (!m) m = chunk_map(&mr, r, bf, 2, B, S, H, D, none);
  if (!m) m = chunk_map(&mk, k, bf, 2, B, S, H, D, none);
  if (!m) m = chunk_map(&mw, log_w, wt, (int)sizeof(TW), B, S, H, D, none);
  if (m) return m;
  const cudaError_t e = tc_opt_in<D, TW>();
  if (e != cudaSuccess) return (int)e;
  wkv6_tc_kernel<D, TW><<<B * H, TC_THREADS, smem, stream>>>(
      mv, mr, mk, mw, (const float*)u, (__nv_bfloat16*)out, S, H);
  return (int)cudaGetLastError();
}

static int launch_tc_bf16(const void* r, const void* k, const void* v,
                          const void* log_w, const void* u, void* out, int B,
                          int S, int H, int D, int w_dtype, int smem,
                          cudaStream_t s) {
  switch (D * 2 + w_dtype) {
    case 64: return launch_tc<32, float>(r, k, v, log_w, u, out, B, S, H, smem, s);
    case 65: return launch_tc<32, __nv_bfloat16>(r, k, v, log_w, u, out, B, S, H, smem, s);
    case 128: return launch_tc<64, float>(r, k, v, log_w, u, out, B, S, H, smem, s);
    case 129: return launch_tc<64, __nv_bfloat16>(r, k, v, log_w, u, out, B, S, H, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype (of r, k, v and the output): 0 float32 (scalar_f32: D <= WKV_DMAX
// and a multiple of 4, tc steps staged), 1 bfloat16 (chunk_tc_bf16: D 32 or
// 64, smem its TcLayout's bytes); w_dtype (of log_w) 0 float32, 1 bfloat16;
// u is float32.  Returns cudaGetLastError() after the launch (or the error
// of the shared-memory opt-in; cudaErrorInvalidValue for a D or a shared
// memory size the instance does not take).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* log_w, const void* u, void* out, int B,
                           int S, int H, int D, int tc, int dtype,
                           int w_dtype, int smem, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_tc_bf16(r, k, v, log_w, u, out, B, S, H, D, w_dtype, smem, s);
  if (D <= 0 || D > WKV_DMAX || D % 4 || tc <= 0)
    return (int)cudaErrorInvalidValue;
  if (w_dtype == 1)
    return launch<float, __nv_bfloat16>(r, k, v, log_w, u, out, B, S, H, D,
                                        tc, smem, s);
  return launch<float, float>(r, k, v, log_w, u, out, B, S, H, D, tc, smem,
                              s);
}

template <int D, typename TW>
static int tc_blocks_per_sm() {
  int n = -1;
  if (tc_opt_in<D, TW>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv6_tc_kernel<D, TW>, TC_THREADS, TcLayout<D, TW>::BYTES) !=
          cudaSuccess)
    return -1;
  return n;
}

// Blocks of the chunk_tc_bf16 kernel for head_dim D and log_w type w_dtype
// (0 float32, 1 bfloat16) that one SM holds at once, or -1 on an error.
extern "C" int wkv6_tc_blocks_per_sm(int D, int w_dtype) {
  switch (D * 2 + w_dtype) {
    case 64: return tc_blocks_per_sm<32, float>();
    case 65: return tc_blocks_per_sm<32, __nv_bfloat16>();
    case 128: return tc_blocks_per_sm<64, float>();
    case 129: return tc_blocks_per_sm<64, __nv_bfloat16>();
    default: return -1;
  }
}
