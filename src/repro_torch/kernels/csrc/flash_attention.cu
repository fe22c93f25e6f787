// flash_attention: blocked online-softmax attention forward, head-major
// q (B, Hq, S, D), k and v (B, Hkv, S, D), grouped query heads reading KV
// head h / (Hq / Hkv), causal and sliding-window masks, float32 softmax
// statistics and accumulator, the output in q's dtype.  Replaces the Pallas
// kernel of src/repro/kernels/flash_attention.py (flash_attention), whose
// grid walks the KV blocks of one q block in order with m, l and acc in VMEM
// scratch.  Two instances, picked by dtype:
//
// wgmma_bf16 (flash_fwd_tc_kernel): bfloat16 on Hopper's tensor cores.
//   Grid (ceil(S / 128), B * Hq): the q blocks of one head are neighbours in
//   launch order, so the blocks resident together read the same K and V out
//   of L2, and they come last-first, so under a causal mask a head's longest
//   rows start first.  384 threads a block, warp-specialised: warpgroup 0 is
//   the producer (one thread starts the TMA loads, the warpgroup drops to 40
//   registers), warpgroups 1 and 2 are consumers of 64 query rows each (232
//   registers).  The producer loads the 128-row Q tile once and streams
//   128-row K and V tiles into a ring of three stages; TMA writes them
//   swizzled (128-byte swizzle, 64-column boxes; 64-byte at D 32) and
//   zero-fills rows past S.  Each stage has full barriers for K and for V
//   (transaction counts) and empty barriers for K and for V, on which the
//   eight consumer warps arrive once the product reading the tile retired.
//   Per KV tile a consumer warpgroup
//     1. computes S = Q K^T: wgmma m64n128k16, Q and K both K-major from
//        shared memory, f32 accumulators (64 a thread);
//     2. masks from each accumulator's (row, column), only on tiles that
//        cross the ragged edge, the causal diagonal or the window edge;
//        masked scores are -inf;
//     3. runs the online softmax in registers: row max over the thread's
//        values and two quad shuffles, p = exp2(s * c - m * c) with
//        c = log2(e) / sqrt(D) written as explicit fmaf (the library builds
//        with -fmad=false), l = l * corr + sum p (quad-reduced once at the
//        end), acc *= corr;
//     4. adds O += P V: P packed to bf16 in registers as the A operand of
//        wgmma m64nDk16, V from shared memory as the transposed (MN-major)
//        B operand.
//   Steps overlap inside a warpgroup: tile j's Q K^T and tile j-1's P V are
//   started together, and tile j's softmax runs while that P V is in flight;
//   acc is rescaled and the new P packed once it retired.  Wholly masked KV
//   tiles are skipped (the reference masks them, which changes no value).
//   The output is acc / max(l, 1e-37), written as bf16 pairs from the
//   registers; rows >= S are never written.
//   Bound: operations.  At the reference bench's shape (B 8, S 4096, Hq 32,
//   D 128, causal) the work is 1.1e12 FLOP, 1.11 ms at the 989 TFLOP/s bf16
//   tensor rate, against 0.2 ms for its 0.67 GB: both products run on the
//   tensor cores, the score tile never leaves the registers, and loads
//   overlap the products through the ring.  The ring's traffic out of L2 is
//   not small: every block reads the K and V of its head up to its diagonal,
//   8.9 GB at that shape (PERF.md has the measured split).
//   Shared memory at D 128: 32 KB Q + 3 x (32 KB K + 32 KB V) + barriers,
//   230 504 bytes with the alignment slack: one block an SM.
//
// scalar_f32 (flash_fwd_kernel<float, D>): float32, which must meet 5e-5,
//   beyond bf16 or TF32 products: scalar fmaf on the FMA units.  Grid
//   (B * Hq, ceil(S / FA_BQ)), FA_THREADS threads a block; the q blocks are
//   taken last-first.  A block holds FA_BQ query rows of one head in shared
//   memory as float32, pre-scaled by 1/sqrt(D), and walks the KV tiles of
//   FA_BK rows that its mask leaves visible.  Per tile:
//   1. K tile -> shared memory (float32, rows >= S zero);
//   2. scores: each thread a 4 x 4 micro-tile of rows ty + 16 i and
//      columns tx + 16 j, 16-byte shared loads, explicit fmaf; masked
//      scores are -1e30 (the reference's NEG_INF);
//   3. V tile -> the same buffer, while one warp per row runs the online
//      softmax (m_new = max(m, max s), p = exp(s - m_new) where visible
//      else 0, corr = exp(m - m_new), l = l corr + sum p; accurate expf);
//   4. acc = acc * corr + P V, each thread D/16 rows x 4 columns in
//      registers.
//   The output is acc / max(l, 1e-37).  Rows are padded by 4 floats so that
//   a quarter warp's 16-byte loads of 8 rows hit 32 different banks.
//   Shared memory for D 128: 85 760 bytes, two blocks an SM.
#include <math.h>

#include "dtype.cuh"
#include "tma.cuh"

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


// -- wgmma_bf16: TMA ring, warp-specialised, wgmma -----------------------------

#define TC_BQ 128       // query rows of a block: two consumer warpgroups of 64
#define TC_BK 128       // key rows of a ring stage
#define TC_STAGES 3
#define TC_THREADS 384  // producer warpgroup + two consumer warpgroups
#define TC_PRODUCER_REGS 40
#define TC_CONSUMER_REGS 232

template <int D>
struct TcShape {
  static constexpr int SWB = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int ATOM = SWB / 2;            // bf16 columns of a box
  static constexpr int NBOX = D / ATOM;           // boxes across a row
  static constexpr int Q_BYTES = TC_BQ * D * 2;
  static constexpr int KV_BYTES = TC_BK * D * 2;  // one K or one V tile
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint32_t LAYOUT = SWB == 128 ? 1u : 2u;
};

// shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units), layout type in bits 62-63
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across an
// asynchronous wgmma: each register looks written here, after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(d, i) \
  WG_F4(d, i), WG_F4(d, i + 4), WG_F4(d, i + 8), WG_F4(d, i + 12)
#define WG_ACC16(d) WG_F16(d, 0)
#define WG_ACC32(d) WG_F16(d, 0), WG_F16(d, 16)
#define WG_ACC64(d) WG_F16(d, 0), WG_F16(d, 16), WG_F16(d, 32), WG_F16(d, 48)

// Accumulator fragment of m64nNk16 (f32): thread t of the warpgroup holds,
// for each 8-column chunk j, d[4j + 0..1] at row 16 (t / 32) + (t % 32) / 4,
// columns 8j + 2 (t % 4) + 0..1, and d[4j + 2..3] eight rows below.  The A
// fragment from registers (four bf16x2) has the same rows and columns for
// 16 columns, so the score accumulators of columns 16k..16k+15,
// d[8k..8k+7], pack pairwise into the A operand of k-step k of P V.

// m64n128k16, A and B from shared memory: 64 f32 accumulators a thread
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n32k16, A (four bf16x2 registers) from registers, B from shared
// memory, transposed (MN-major): 16 f32 accumulators a thread
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// m64n64k16, A (four bf16x2 registers) from registers, B from shared
// memory, transposed (MN-major): 32 f32 accumulators a thread
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// m64n128k16, A (four bf16x2 registers) from registers, B from shared
// memory, transposed (MN-major): 64 f32 accumulators a thread
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// S = Q K^T of one 128-key tile, started and committed (not waited): Q rows
// from `q_rows` (the warpgroup's 64 rows of box 0), K from `k_tile`
template <int D>
__device__ __forceinline__ void start_qk(float (&sc)[TC_BK / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
  using Sh = TcShape<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk * 16 / Sh::ATOM;
    const uint32_t off = (kk * 16 % Sh::ATOM) * 2;
    const uint64_t da = gmma_desc(q_rows + x * TC_BQ * Sh::SWB + off, 16,
                                  8 * Sh::SWB, Sh::LAYOUT);
    const uint64_t db = gmma_desc(k_tile + x * TC_BK * Sh::SWB + off, 16,
                                  8 * Sh::SWB, Sh::LAYOUT);
    wgmma_ss_n128(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V of one tile, started and committed (not waited): P from registers,
// V (MN-major) from `v_tile`
template <int D>
__device__ __forceinline__ void start_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[TC_BK / 4],
                                         uint32_t v_tile) {
  using Sh = TcShape<D>;
#pragma unroll
  for (int kk = 0; kk < TC_BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs<D>(o, a, gmma_desc(v_tile + kk * 16 * Sh::SWB,
                                TC_BK * Sh::SWB, 8 * Sh::SWB, Sh::LAYOUT));
  }
  wgmma_commit();
}

// Masks and online softmax of the scores of the tile at key k0, for the
// thread's rows qa and qb: the running maxima ma, mb and sums la, lb are
// updated, corr_a, corr_b set, and sc holds p = exp2(s c - m c) in float32.
// Masks are built only on a tile that crosses the ragged edge, the causal
// diagonal or the window edge (q_lo: the warpgroup's first row).
__device__ __forceinline__ void softmax_tile(
    float (&sc)[TC_BK / 2], int k0, int S, int causal, int window, int q_lo,
    int qa, int qb, int cq, float sl2, float& ma, float& mb, float& la,
    float& lb, float& corr_a, float& corr_b) {
  if (k0 + TC_BK > S || (causal && k0 + TC_BK - 1 > q_lo) ||
      (window && q_lo + 63 - k0 >= window)) {
#pragma unroll
    for (int i = 0; i < TC_BK / 2; ++i) {
      const int kp = k0 + 8 * (i >> 2) + cq + (i & 1);
      const int qp = (i & 2) ? qb : qa;
      if (!(kp < S && (!causal || qp >= kp) && (!window || qp - kp < window)))
        sc[i] = -INFINITY;
    }
  }
  float xa = ma, xb = mb;
#pragma unroll
  for (int i = 0; i < TC_BK / 2; ++i) {
    if (i & 2)
      xb = fmaxf(xb, sc[i]);
    else
      xa = fmaxf(xa, sc[i]);
  }
  xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, 1));
  xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, 2));
  xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, 1));
  xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, 2));
  // a row with nothing visible yet keeps m = -inf; subtract 0 there
  const float na = -((xa == -INFINITY ? 0.f : xa) * sl2);
  const float nb = -((xb == -INFINITY ? 0.f : xb) * sl2);
  corr_a = ex2(fmaf(ma, sl2, na));
  corr_b = ex2(fmaf(mb, sl2, nb));
  ma = xa;
  mb = xb;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < TC_BK / 2; ++i) {
    sc[i] = ex2(fmaf(sc[i], sl2, (i & 2) ? nb : na));
    if (i & 2)
      sb += sc[i];
    else
      sa += sc[i];
  }
  la = la * corr_a + sa;
  lb = lb * corr_b + sb;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    int Hq, int Hkv, int S, int causal, int window, float sl2) {
  using Sh = TcShape<D>;
  constexpr int SWB = Sh::SWB;
  constexpr int ATOM = Sh::ATOM;
  extern __shared__ uint8_t tc_smem[];
  // 1024-byte aligned, as the swizzle patterns of TMA and wgmma assume
  const uint32_t q_s = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + Sh::Q_BYTES;  // stage s: K, then V
  const uint32_t bar = kv_s + 2 * TC_STAGES * Sh::KV_BYTES;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 + 8 * s; };
  auto v_full = [&](int s) { return bar + 8 + 8 * (TC_STAGES + s); };
  auto k_empty = [&](int s) { return bar + 8 + 8 * (2 * TC_STAGES + s); };
  auto v_empty = [&](int s) { return bar + 8 + 8 * (3 * TC_STAGES + s); };
  auto k_tile = [&](int s) { return kv_s + 2 * s * Sh::KV_BYTES; };
  auto v_tile = [&](int s) { return kv_s + (2 * s + 1) * Sh::KV_BYTES; };

  // the q blocks of one head are neighbours in launch order (their K and
  // V stay in L2), last-first
  const int bh = blockIdx.y;
  const int bi = bh / Hq;
  const int bkv = bi * Hkv + (bh - bi * Hq) / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  // KV tiles with at least one visible key for some row of this block,
  // walked from the last (the causal diagonal) down
  const int k_end = causal ? min(S, q0 + TC_BQ) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int kt_last = (k_end - 1) / TC_BK;
  const int n_tiles = kt_last - k_begin / TC_BK + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival per consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer warpgroup: one thread keeps the ring full ------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        TC_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Sh::Q_BYTES);
#pragma unroll
      for (int x = 0; x < Sh::NBOX; ++x)
        tma_load_3d(q_s + x * TC_BQ * SWB, &tm_q, x * ATOM, q0, bh, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % TC_STAGES;
        const int k0 = (kt_last - it) * TC_BK;
        const uint32_t vacant = ((it / TC_STAGES) & 1) ^ 1;
        mbar_wait(k_empty(s), vacant);
        mbar_expect_tx(k_full(s), Sh::KV_BYTES);
#pragma unroll
        for (int x = 0; x < Sh::NBOX; ++x)
          tma_load_3d(k_tile(s) + x * TC_BK * SWB, &tm_k, x * ATOM, k0, bkv,
                      k_full(s));
        mbar_wait(v_empty(s), vacant);
        mbar_expect_tx(v_full(s), Sh::KV_BYTES);
#pragma unroll
        for (int x = 0; x < Sh::NBOX; ++x)
          tma_load_3d(v_tile(s) + x * TC_BK * SWB, &tm_v, x * ATOM, k0, bkv,
                      v_full(s));
      }
    }
  } else {
    // -- consumer warpgroups: 64 query rows each -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        TC_CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int q_lo = q0 + 64 * c;                  // the warpgroup's rows
    const int qa = q_lo + 16 * (t >> 5) + (lane >> 2);  // this thread's
    const int qb = qa + 8;                               // two rows
    const int cq = 2 * (lane & 3);  // its first column in each 8-col chunk

    float o[D / 2];
    float sc[TC_BK / 2];
    uint32_t p[TC_BK / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TC_BK / 2; ++i) sc[i] = 0.f;
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
    float corr_a, corr_b;
    const uint32_t q_rows = q_s + c * 64 * SWB;

    // The first tile: S = Q K^T and its softmax.  Then, for each later
    // tile, its Q K^T and the previous tile's P V are both in flight while
    // the warpgroup waits for the first, runs the softmax on it and waits
    // for the second; the previous stage is then released, acc rescaled and
    // the new P packed.  The last P V closes the loop.
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    start_qk<D>(sc, q_rows, k_tile(0));
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_tile(sc, kt_last * TC_BK, S, causal, window, q_lo, qa, qb, cq,
                 sl2, ma, mb, la, lb, corr_a, corr_b);
#pragma unroll
    for (int i = 0; i < TC_BK / 2; i += 2)
      p[i / 2] = pack_bf16(sc[i], sc[i + 1]);
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % TC_STAGES;
      const int sp = (it - 1) % TC_STAGES;
      mbar_wait(k_full(s), (it / TC_STAGES) & 1);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      start_qk<D>(sc, q_rows, k_tile(s));
      mbar_wait(v_full(sp), ((it - 1) / TC_STAGES) & 1);
      start_pv<D>(o, p, v_tile(sp));
      wgmma_wait<1>();                    // Q K^T done, P V in flight
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(s));
      softmax_tile(sc, (kt_last - it) * TC_BK, S, causal, window, q_lo, qa,
                   qb, cq, sl2, ma, mb, la, lb, corr_a, corr_b);
      wgmma_wait<0>();                    // P V done: P and acc free
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(v_empty(sp));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;
#pragma unroll
      for (int i = 0; i < TC_BK / 2; i += 2)
        p[i / 2] = pack_bf16(sc[i], sc[i + 1]);
    }
    const int sl = (n_tiles - 1) % TC_STAGES;
    mbar_wait(v_full(sl), ((n_tiles - 1) / TC_STAGES) & 1);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    start_pv<D>(o, p, v_tile(sl));
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: acc / max(l, 1e-37) as bf16 pairs; rows >= S not written
    la += __shfl_xor_sync(0xffffffffu, la, 1);
    la += __shfl_xor_sync(0xffffffffu, la, 2);
    lb += __shfl_xor_sync(0xffffffffu, lb, 1);
    lb += __shfl_xor_sync(0xffffffffu, lb, 2);
    const float da = fmaxf(la, 1e-37f), db = fmaxf(lb, 1e-37f);
    __nv_bfloat16* og = out + (size_t)bh * S * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int qp = (i & 2) ? qb : qa;
      const float d = (i & 2) ? db : da;
      if (qp < S)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)qp * D + 8 * (i >> 2) +
                                           cq) =
            __floats2bfloat162_rn(o[i] / d, o[i + 1] / d);
    }
  }
}

// -- launchers -----------------------------------------------------------------

template <int D>
static int launch_scalar(const void* q, const void* k, const void* v,
                         void* out, int B, int Hq, int Hkv, int S, int causal,
                         int window, float scale, int smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<float, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * Hq, (S + FA_BQ - 1) / FA_BQ);
  flash_fwd_kernel<float, D><<<grid, FA_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Hq, Hkv,
      S, causal, window, scale);
  return (int)cudaGetLastError();
}

// A (BH, S, D) bf16 tensor as a 3-D tensor map of boxes `cols` x `rows` x 1,
// swizzled; rows past S read as zeros.  Returns 0, or the negated CUresult.
static int tensor_map(CUtensorMap* map, const void* base, int D, int S,
                      int BH, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v, void* out,
                     int B, int Hq, int Hkv, int S, int causal, int window,
                     float scale, int smem, cudaStream_t stream) {
  using Sh = TcShape<D>;
  const CUtensorMapSwizzle sw = Sh::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  int e = tensor_map(&mq, q, D, S, B * Hq, Sh::ATOM, TC_BQ, sw);
  if (!e) e = tensor_map(&mk, k, D, S, B * Hkv, Sh::ATOM, TC_BK, sw);
  if (!e) e = tensor_map(&mv, v, D, S, B * Hkv, Sh::ATOM, TC_BK, sw);
  if (e) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((S + TC_BQ - 1) / TC_BQ, B * Hq);
  flash_fwd_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, Hq, Hkv, S, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// dtype: 0 float32 (scalar_f32), 1 bfloat16 (wgmma_bf16); window 0 means
// none.  Returns cudaGetLastError() after the launch, the error of the
// shared-memory opt-in, cudaErrorInvalidValue for a head_dim without an
// instance, or the negated CUresult of a tensor map that cannot be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Hq, int Hkv, int S, int D,
                                      int causal, int window, int dtype,
                                      float scale, int smem, void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_ARGS q, k, v, out, B, Hq, Hkv, S, causal, window, scale, smem, s
  switch (D * 2 + dtype) {
    case 64: return launch_scalar<32>(FA_ARGS);
    case 128: return launch_scalar<64>(FA_ARGS);
    case 256: return launch_scalar<128>(FA_ARGS);
    case 65: return launch_tc<32>(FA_ARGS);
    case 129: return launch_tc<64>(FA_ARGS);
    case 257: return launch_tc<128>(FA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_ARGS
}
