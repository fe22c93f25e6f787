// paged_decode_attention: one new token per sequence attends over a page
// store (P, page, Hkv, D) through a block table.  Replaces the Pallas kernel
// of src/repro/kernels/paged_kv_gather.py (paged_decode_attention), whose
// VMEM staging ring is filled by make_async_copy DMAs.
//
// Split and merge (flash-decoding), both instances.  The grid is
// (n_splits, Hkv, B): split s of (b, h) walks the pages [s*pps, (s+1)*pps)
// of b's table, so a long table is spread over many blocks.  n_splits and
// pps come from the host (launch_plan in paged_kv_gather.py), which never
// reads the lengths; a block whose range starts at or past the sequence's
// page count ceil(length / page) exits at once.  A block keeps m, l and acc
// in float32 for the rep = Hq / Hkv query rows of its KV head.  When (b, h)
// has one live split, that block writes the output.  Otherwise each live
// split writes its (m, l, acc) to a float32 workspace, fences, and counts
// itself in a per-(b, h) arrival counter; the block that arrives last merges
// all partials in split order (deterministic):
//   o = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-37),
//   M = max_s m_s.
// The wrapper allocates the workspace and zeroed counters for each call.
// A page id is normalised as the reference's gather normalises an index:
// id < 0 -> id + n_store, then clamped into [0, n_store - 1].
//
// Instance mma_bf16 (bfloat16): the tensor cores, mma.sync m16n8k16 with
// float32 accumulators.  4 warps; a round is 64 key rows (64 / page pages
// of 8-64 tokens, or a part of a longer page), warp w takes rows 16w..16w+15
// of each round.  Q (rep <= 16 rows, zero-padded to 16) is the A operand,
// held in registers for the whole loop; K comes from the ring by ldmatrix
// as B, S = Q K^T is scaled in float32 by log2(e) / sqrt(D); each warp keeps
// its own online softmax (m, l per row, reduced across a quad; exp2f) and a
// 16 x D accumulator.  The two n8 score tiles, packed to bf16, are the A
// fragment of P V over 16 keys; V comes by ldmatrix.trans.  The four warp
// states merge once, through shared memory, at the end of the block.  The
// ring is filled by cp.async 16-byte copies whose destinations are swizzled
// (16-byte chunk index XOR row) so that ldmatrix has no bank conflicts;
// rows past the split's last valid position are zero-filled.  The ring holds
// 1 + ceil(n_buf * page / 64) rounds: the round being computed plus the
// fewest whole rounds that hold n_buf pages, so at least n_buf pages (the
// paper's prefetch depth P) are in flight ahead of the page being computed.
// One __syncthreads a round, none a page.
//
// Instance scalar_f32 (float32, held to 5e-5, which bf16 and TF32 products
// do not meet): the first design, one page a step of an n_buf-page ring, one
// thread per (query row, key row) dot product, one warp per row of online
// softmax (accurate expf), one thread per column of P V, explicit fmaf (so
// -fmad=false does not split them), now over the pages of its split.
//
// The work is bound by bytes: each valid K/V row of head h is read once,
// about 2 * length * D elements per (b, h); a decode token does 4 * D
// operations per key and query row, far below the card's operations-per-byte
// line.
#include "dtype.cuh"
#include "mma.cuh"

#define PD_THREADS 128
#define PD_WARPS (PD_THREADS / 32)
#define PD_NEG_INF (-1e30f)
#define PD_PV_ROWS 8
#define TC_ROWS 64          // key rows a round of the mma_bf16 instance
#define TC_QROWS 16         // query rows of one mma tile (rep <= 16)

// Wait until at most n of this thread's commit groups are still in flight.
// Groups complete in commit order; for n > 7 waiting down to 7 is stronger
// than needed and still correct.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// A block-table entry as a page of the store (the reference's gather rule).
__device__ __forceinline__ int page_id(int id, int n_store) {
  if (id < 0) id += n_store;
  return min(max(id, 0), n_store - 1);
}

// The pages of split s of one sequence, and the number of live splits.
struct SplitRange {
  int n_live;   // splits of (b, h) that hold a page (at least 1)
  int p_begin;  // first page of split s
  int p_end;    // one past its last page (p_end <= p_begin: none)
  int len;      // valid positions, clamped to [0, ppseq * page]
};

__device__ __forceinline__ SplitRange split_range(int length, int page,
                                                  int ppseq, int pps, int s) {
  SplitRange r;
  const int len = max(length, 0);
  const int n_pages = min(len / page + (len % page != 0), ppseq);
  r.len = min(len, ppseq * page);
  r.n_live = max(1, (n_pages + pps - 1) / pps);
  r.p_begin = s * pps;
  r.p_end = min(r.p_begin + pps, n_pages);
  return r;
}

template <bool kLog2>
__device__ __forceinline__ float exp_of(float x) {
  return kLog2 ? exp2f(x) : expf(x);
}

// The end of a block: its (acc, m, l) for rep rows sit in shared memory.
// One live split writes the output; otherwise the partial goes to the
// workspace and the last block of (b, h) to arrive merges all partials in
// split order.  `merge_w` is shared scratch of n_live * rep + rep floats.
// kLog2: m is in log2 units (mma_bf16) rather than natural ones.
template <typename T, bool kLog2>
__device__ void finish_block(const float* acc_c, const float* m_c,
                             const float* l_c, float* merge_w, T* out_bh,
                             float* ws_acc, float* ws_ml, int* counters,
                             int bh, int s, int n_splits, int n_live, int rep,
                             int D) {
  const int tid = threadIdx.x;
  const int n = rep * D;
  if (n_live == 1) {
    for (int i = tid; i < n; i += PD_THREADS)
      out_bh[i] = from_f32<T>(acc_c[i] / fmaxf(l_c[i / D], 1e-37f));
    return;
  }
  const size_t part0 = (size_t)bh * n_splits;     // partial of split 0
  float* my_acc = ws_acc + (part0 + s) * n;
  for (int i = tid; i < n; i += PD_THREADS) my_acc[i] = acc_c[i];
  for (int r = tid; r < rep; r += PD_THREADS) {
    ws_ml[((part0 + s) * rep + r) * 2] = m_c[r];
    ws_ml[((part0 + s) * rep + r) * 2 + 1] = l_c[r];
  }
  __threadfence();
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(counters + bh, 1) == n_live - 1;
  if (!__syncthreads_or(last)) return;
  __threadfence();
  // the last block: weights of each split, one thread per row, in order
  float* L = merge_w + (size_t)n_live * rep;
  for (int r = tid; r < rep; r += PD_THREADS) {
    float M = PD_NEG_INF;
    for (int t = 0; t < n_live; ++t)
      M = fmaxf(M, __ldcg(ws_ml + ((part0 + t) * rep + r) * 2));
    float sum = 0.f;
    for (int t = 0; t < n_live; ++t) {
      const float* ml = ws_ml + ((part0 + t) * rep + r) * 2;
      const float w = exp_of<kLog2>(__ldcg(ml) - M);
      merge_w[t * rep + r] = w;
      sum = fmaf(w, __ldcg(ml + 1), sum);
    }
    L[r] = sum;
  }
  __syncthreads();
  for (int i = tid; i < n; i += PD_THREADS) {
    const int r = i / D;
    float a = 0.f;
    for (int t = 0; t < n_live; ++t)
      a = fmaf(merge_w[t * rep + r], __ldcg(ws_acc + (part0 + t) * n + i), a);
    out_bh[i] = from_f32<T>(a / fmaxf(L[r], 1e-37f));
  }
}

// -- scalar_f32 -----------------------------------------------------------

__global__ void __launch_bounds__(PD_THREADS) paged_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, float* __restrict__ out, float* ws_acc,
    float* ws_ml, int* counters, int n_store, int Hq, int Hkv, int D,
    int page, int ppseq, int n_buf, int n_splits, int pps, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const SplitRange sr = split_range(lengths[b], page, ppseq, pps, s);
  if (s >= sr.n_live) return;
  const int rep = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = sr.len;

  // shared layout (smem_bytes() in paged_kv_gather.py): K ring, V ring
  // (the region reused by the split merge's weights at the end, and at
  // least as large as they are), q rows, accumulators, one page of scores,
  // m, l, corr per row
  const int slot_elems = page * D;
  float* k_ring = reinterpret_cast<float*>(smem_raw);
  float* v_ring = k_ring + (size_t)n_buf * slot_elems;
  const size_t ring_kv = 2 * (size_t)n_buf * slot_elems * sizeof(float);
  const size_t merge_b = ((size_t)(n_splits + 1) * rep * 4 + 15) / 16 * 16;
  const size_t ring_bytes = ring_kv > merge_b ? ring_kv : merge_b;
  float* q_s = reinterpret_cast<float*>(smem_raw + ring_bytes);
  float* acc_s = q_s + rep * D;
  float* p_s = acc_s + rep * D;
  float* m_s = p_s + rep * page;
  float* l_s = m_s + rep;
  float* c_s = l_s + rep;

  const int* table = block_tables + (size_t)b * ppseq;
  const int p_begin = sr.p_begin;
  const int n_pages = max(sr.p_end - p_begin, 0);   // this split's pages

  const int n_quads = D / 4;                // score loop: 4 elements a step
  const int n_groups = (rep + PD_PV_ROWS - 1) / PD_PV_ROWS;
  constexpr int VEC = 4;                    // floats per 16-byte copy
  const int row_chunks = D / VEC;
  const int page_chunks = page * row_chunks;
  const size_t row_stride = (size_t)Hkv * D;   // between slots of a page

  // copies of page p_begin + i (head h) into ring slot `slot`, one commit
  // group per page (an empty group past the split's last page, so that
  // every iteration counts the same number of groups)
  auto issue = [&](int i, int slot) {
    if (i < n_pages) {
      const int pid = page_id(table[p_begin + i], n_store);
      const size_t base = ((size_t)pid * page * Hkv + (size_t)h) * D;
      float* kd = k_ring + (size_t)slot * slot_elems;
      float* vd = v_ring + (size_t)slot * slot_elems;
      for (int c = tid; c < page_chunks; c += PD_THREADS) {
        const int j = c / row_chunks;
        const int w = (c - j * row_chunks) * VEC;
        const size_t src = base + j * row_stride + w;
        cp_async16(kd + j * D + w, k_pages + src);
        cp_async16(vd + j * D + w, v_pages + src);
      }
    }
    cp_async_commit();
  };

  for (int i = 0; i < n_buf; ++i) issue(i, i);

  const float* qb = q + ((size_t)b * Hq + (size_t)h * rep) * D;
  for (int i = tid; i < rep * D; i += PD_THREADS) {
    q_s[i] = qb[i] * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += PD_THREADS) {
    m_s[r] = PD_NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int i = 0; i < n_pages; ++i) {
    const int slot = i % n_buf;
    cp_async_wait_upto(n_buf - 1);
    __syncthreads();                  // every thread's copies of page i
    const float* kt = k_ring + (size_t)slot * slot_elems;
    const float* vt = v_ring + (size_t)slot * slot_elems;
    const int pos0 = (p_begin + i) * page;

    // scores: one thread per (query row r, key row j), four elements a
    // step; row j starts at column chunk j so that the threads of a warp
    // read different banks
    for (int idx = tid; idx < rep * page; idx += PD_THREADS) {
      const int r = idx / page;
      const int j = idx - r * page;
      const float* qr = q_s + r * D;
      const float* kr = kt + j * D;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int c = j % n_quads;
      for (int n = 0; n < n_quads; ++n) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + 4 * c);
        const float4 kv = load4(kr + 4 * c);
        a0 = fmaf(qv.x, kv.x, a0);
        a1 = fmaf(qv.y, kv.y, a1);
        a2 = fmaf(qv.z, kv.z, a2);
        a3 = fmaf(qv.w, kv.w, a3);
        if (++c == n_quads) c = 0;
      }
      p_s[idx] = (pos0 + j < length) ? (a0 + a1) + (a2 + a3) : PD_NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < rep; r += PD_WARPS) {
      float* pr = p_s + r * page;
      float mx = PD_NEG_INF;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float e = (pos0 + j < length) ? expf(pr[j] - m_new) : 0.f;
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: one thread per (column d, group of up to
    // PD_PV_ROWS query rows), the group's sums in registers
    for (int i2 = tid; i2 < D * n_groups; i2 += PD_THREADS) {
      const int g = i2 / D;
      const int d = i2 - g * D;
      const int r0 = g * PD_PV_ROWS;
      float a[PD_PV_ROWS];
#pragma unroll
      for (int rr = 0; rr < PD_PV_ROWS; ++rr) a[rr] = 0.f;
      for (int j = 0; j < page; ++j) {
        const float vj = vt[j * D + d];
#pragma unroll
        for (int rr = 0; rr < PD_PV_ROWS; ++rr)
          if (r0 + rr < rep) a[rr] = fmaf(p_s[(r0 + rr) * page + j], vj, a[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < PD_PV_ROWS; ++rr) {
        if (r0 + rr < rep) {
          float* acc = acc_s + (r0 + rr) * D + d;
          *acc = fmaf(*acc, c_s[r0 + rr], a[rr]);
        }
      }
    }
    __syncthreads();                  // page i's slot is read out
    issue(i + n_buf, slot);
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free for the merge

  float* ob = out + ((size_t)b * Hq + (size_t)h * rep) * D;
  finish_block<float, false>(acc_s, m_s, l_s, reinterpret_cast<float*>(smem_raw),
                         ob, ws_acc, ws_ml, counters, b * Hkv + h, s,
                         n_splits, sr.n_live, rep, D);
}

// -- mma_bf16 -------------------------------------------------------------

// Element offset of 16-byte chunk c of row r in a swizzled (64, D) bf16
// tile: the chunk index is XORed with the row so that the 8 rows one
// ldmatrix 8 x 8 matrix reads lie in 8 different 16-byte bank groups.
template <int D>
__device__ __forceinline__ int tile_off(int r, int c) {
  constexpr int CPR = D / 8;                         // chunks a row
  constexpr int SHIFT = CPR >= 8 ? 0 : 1;            // D 32: 2 rows a line
  constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  return r * D + ((c ^ ((r >> SHIFT) & MASK)) << 3);
}

template <int D>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* ws_acc, float* ws_ml,
    int* counters, int n_store, int Hq, int Hkv, int page, int ppseq,
    int n_slots, int n_splits, int pps, float scale_log2) {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "head_dim 32/64/128");
  constexpr int CPR = D / 8;                 // 16-byte chunks a row
  constexpr int TILE = TC_ROWS * D;          // elements of one K or V round
  constexpr int KS = D / 16;                 // k-steps of Q K^T
  constexpr int NT = D / 8;                  // n8 tiles of the output
  constexpr int COPIES = TC_ROWS * CPR / PD_THREADS;  // a thread, a tensor
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const SplitRange sr = split_range(lengths[b], page, ppseq, pps, s);
  if (s >= sr.n_live) return;
  const int rep = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                   // row of a fragment
  const int t = lane & 3;                    // column pair of a fragment

  __nv_bfloat16* k_ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_ring = k_ring + (size_t)n_slots * TILE;
  const int* table = block_tables + (size_t)b * ppseq;
  const int row_begin = sr.p_begin * page;
  const int row_end = max(min(sr.p_end * page, sr.len), row_begin);
  const int n_rounds = (row_end - row_begin + TC_ROWS - 1) / TC_ROWS;

  // copies of round j (rows row_begin + 64 j ..) into ring slot `slot`, one
  // commit group a round; rows at or past row_end are zero-filled
  auto issue = [&](int j, int slot) {
    if (j < n_rounds) {
      __nv_bfloat16* kd = k_ring + (size_t)slot * TILE;
      __nv_bfloat16* vd = v_ring + (size_t)slot * TILE;
#pragma unroll
      for (int it = 0; it < COPIES; ++it) {
        const int c = tid + it * PD_THREADS;
        const int r = c / CPR;
        const int ch = c - r * CPR;
        const int pos = row_begin + j * TC_ROWS + r;
        const bool ok = pos < row_end;
        size_t src = 0;
        if (ok) {
          const int pi = pos / page;
          const int pid = page_id(table[pi], n_store);
          src = (((size_t)pid * page + (pos - pi * page)) * Hkv + h) * D +
                ch * 8;
        }
        const int dst = tile_off<D>(r, ch);
        cp_async16_zfill(kd + dst, k_pages + src, ok);
        cp_async16_zfill(vd + dst, v_pages + src, ok);
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < n_slots - 1; ++j) issue(j, j);

  // Q as the A operand: rows g and g + 8 (zero past rep), k-step ks holds
  // columns 16 ks + 2t, +1 (a0, a1) and 16 ks + 8 + 2t, +1 (a2, a3)
  unsigned qa[KS][4];
  {
    const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)h * rep) * D;
    const unsigned* q_lo = reinterpret_cast<const unsigned*>(qb + g * D);
    const unsigned* q_hi = reinterpret_cast<const unsigned*>(qb + (g + 8) * D);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 8 + t;       // in bf16 pairs
      qa[ks][0] = g < rep ? q_lo[c] : 0u;
      qa[ks][1] = g + 8 < rep ? q_hi[c] : 0u;
      qa[ks][2] = g < rep ? q_lo[c + 4] : 0u;
      qa[ks][3] = g + 8 < rep ? q_hi[c + 4] : 0u;
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = PD_NEG_INF, m_hi = PD_NEG_INF;  // rows g, g + 8 (log2 units)
  float l_lo = 0.f, l_hi = 0.f;                // this thread's share

  // ldmatrix lanes: matrix mi = lane / 8, its row lane % 8
  const int mi = lane >> 3;
  const int r8 = lane & 7;
  const int k_row = warp * 16 + ((mi >> 1) << 3) + r8;  // K: (keys, d lo/hi)
  const int k_ch = mi & 1;
  const int v_row = warp * 16 + ((mi & 1) << 3) + r8;   // V: (keys lo/hi, d)
  const int v_ch = mi >> 1;
  const unsigned k_base = (unsigned)__cvta_generic_to_shared(k_ring);
  const unsigned v_base = (unsigned)__cvta_generic_to_shared(v_ring);

  for (int j = 0; j < n_rounds; ++j) {
    const int slot = j % n_slots;
    cp_async_wait_upto(n_slots - 2);
    __syncthreads();          // round j has landed; round j - 1 is read out
    issue(j + n_slots - 1, (j + n_slots - 1) % n_slots);

    const int kb = row_begin + j * TC_ROWS + warp * 16;  // first key row
    if (kb >= row_end) continue;                         // warp-uniform
    const unsigned ks_addr = k_base + 2u * (unsigned)(slot * TILE);
    const unsigned vs_addr = v_base + 2u * (unsigned)(slot * TILE);

    // S = Q K^T over this warp's 16 keys: s0 keys 0-7, s1 keys 8-15
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned b0, b1, b2, b3;
      ldsm_x4(ks_addr + 2u * (unsigned)tile_off<D>(k_row, 2 * ks + k_ch),
              b0, b1, b2, b3);
      mma_16816(s0, qa[ks], b0, b1);
      mma_16816(s1, qa[ks], b2, b3);
    }

    // online softmax in log2 units; key columns 2t, 2t + 1 (+ 8 for s1)
    const int valid = row_end - kb;      // keys 0 .. valid-1 are in range
    const bool v0 = 2 * t < valid, v1 = 2 * t + 1 < valid;
    const bool v2 = 2 * t + 8 < valid, v3 = 2 * t + 9 < valid;
    s0[0] = v0 ? s0[0] * scale_log2 : PD_NEG_INF;
    s0[1] = v1 ? s0[1] * scale_log2 : PD_NEG_INF;
    s0[2] = v0 ? s0[2] * scale_log2 : PD_NEG_INF;
    s0[3] = v1 ? s0[3] * scale_log2 : PD_NEG_INF;
    s1[0] = v2 ? s1[0] * scale_log2 : PD_NEG_INF;
    s1[1] = v3 ? s1[1] * scale_log2 : PD_NEG_INF;
    s1[2] = v2 ? s1[2] * scale_log2 : PD_NEG_INF;
    s1[3] = v3 ? s1[3] * scale_log2 : PD_NEG_INF;
    float mx_lo = fmaxf(fmaxf(s0[0], s0[1]), fmaxf(s1[0], s1[1]));
    float mx_hi = fmaxf(fmaxf(s0[2], s0[3]), fmaxf(s1[2], s1[3]));
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = exp2f(m_lo - mn_lo);
    const float c_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    const float p00 = v0 ? exp2f(s0[0] - mn_lo) : 0.f;
    const float p01 = v1 ? exp2f(s0[1] - mn_lo) : 0.f;
    const float p02 = v0 ? exp2f(s0[2] - mn_hi) : 0.f;
    const float p03 = v1 ? exp2f(s0[3] - mn_hi) : 0.f;
    const float p10 = v2 ? exp2f(s1[0] - mn_lo) : 0.f;
    const float p11 = v3 ? exp2f(s1[1] - mn_lo) : 0.f;
    const float p12 = v2 ? exp2f(s1[2] - mn_hi) : 0.f;
    const float p13 = v3 ? exp2f(s1[3] - mn_hi) : 0.f;
    l_lo = l_lo * c_lo + ((p00 + p01) + (p10 + p11));
    l_hi = l_hi * c_hi + ((p02 + p03) + (p12 + p13));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= c_lo;
      acc[n][1] *= c_lo;
      acc[n][2] *= c_hi;
      acc[n][3] *= c_hi;
    }

    // P (16 x 16 keys) as the A operand of P V
    const unsigned pa[4] = {pack_bf16(p00, p01), pack_bf16(p02, p03),
                            pack_bf16(p10, p11), pack_bf16(p12, p13)};
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      unsigned b0, b1, b2, b3;
      ldsm_x4_trans(vs_addr + 2u * (unsigned)tile_off<D>(v_row, 2 * dj + v_ch),
                    b0, b1, b2, b3);
      mma_16816(acc[2 * dj], pa, b0, b1);
      mma_16816(acc[2 * dj + 1], pa, b2, b3);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free for the merges

  // the four warps' states through shared memory: wm, wl, ww (4 x 16 each),
  // wacc (4 x rep x D), then the block's m, l (rep each), then the split
  // merge's weights (n_live * rep + rep)
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  float* wm = reinterpret_cast<float*>(smem_raw);
  float* wl = wm + PD_WARPS * TC_QROWS;
  float* ww = wl + PD_WARPS * TC_QROWS;
  float* wacc = ww + PD_WARPS * TC_QROWS;
  float* m_c = wacc + PD_WARPS * rep * D;
  float* l_c = m_c + rep;
  float* merge_w = l_c + rep;
  if (t == 0) {
    wm[warp * TC_QROWS + g] = m_lo;
    wl[warp * TC_QROWS + g] = l_lo;
    wm[warp * TC_QROWS + g + 8] = m_hi;
    wl[warp * TC_QROWS + g + 8] = l_hi;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (g < rep) {
      float* a = wacc + ((size_t)warp * rep + g) * D + col;
      a[0] = acc[n][0];
      a[1] = acc[n][1];
    }
    if (g + 8 < rep) {
      float* a = wacc + ((size_t)warp * rep + g + 8) * D + col;
      a[0] = acc[n][2];
      a[1] = acc[n][3];
    }
  }
  __syncthreads();
  for (int r = tid; r < rep; r += PD_THREADS) {
    float M = PD_NEG_INF;
    for (int w = 0; w < PD_WARPS; ++w) M = fmaxf(M, wm[w * TC_QROWS + r]);
    float sum = 0.f;
    for (int w = 0; w < PD_WARPS; ++w) {
      const float e = exp2f(wm[w * TC_QROWS + r] - M);
      ww[w * TC_QROWS + r] = e;
      sum = fmaf(e, wl[w * TC_QROWS + r], sum);
    }
    m_c[r] = M;
    l_c[r] = sum;
  }
  __syncthreads();
  // combined acc into warp 0's rows, in place (each element has one owner)
  for (int i = tid; i < rep * D; i += PD_THREADS) {
    const int r = i / D;
    float a = 0.f;
    for (int w = 0; w < PD_WARPS; ++w)
      a = fmaf(ww[w * TC_QROWS + r], wacc[(size_t)w * rep * D + i], a);
    wacc[i] = a;
  }
  __syncthreads();

  __nv_bfloat16* ob = out + ((size_t)b * Hq + (size_t)h * rep) * D;
  finish_block<__nv_bfloat16, true>(wacc, m_c, l_c, merge_w, ob, ws_acc,
                                    ws_ml, counters, b * Hkv + h, s, n_splits,
                                    sr.n_live, rep, D);
}

// -- launch ---------------------------------------------------------------

template <typename K>
static int opt_in(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v,
                     const void* bt, const void* ln, void* out, float* ws_acc,
                     float* ws_ml, int* counters, dim3 grid, int n_store,
                     int Hq, int Hkv, int page, int ppseq, int ring,
                     int n_splits, int pps, float scale, int smem,
                     cudaStream_t stream) {
  const int e = opt_in(paged_decode_tc_kernel<D>, smem);
  if (e) return e;
  const float log2e = 1.4426950408889634f;
  paged_decode_tc_kernel<D><<<grid, PD_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)bt, (const int*)ln,
      (__nv_bfloat16*)out, ws_acc, ws_ml, counters, n_store, Hq, Hkv, page,
      ppseq, ring, n_splits, pps, scale * log2e);
  return (int)cudaGetLastError();
}

// instance: 0 scalar_f32 (float32), 1 mma_bf16 (bfloat16, D 32/64/128).
// ring: pages of the scalar instance's ring, rounds of the mma instance's.
// ws_acc, ws_ml, counters: the split merge's workspace (null when
// n_splits == 1).  Returns cudaGetLastError() after the launch (or the
// error of the shared-memory opt-in); cudaErrorInvalidValue for an
// instance or head_dim that was not built.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, void* ws_acc,
    void* ws_ml, void* counters, int B, int n_store, int Hq, int Hkv, int D,
    int page, int ppseq, int ring, int n_splits, int pps, int instance,
    float scale, int smem, void* stream) {
  if (B <= 0 || Hkv <= 0 || n_store <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_splits, Hkv, B);
  float* wa = (float*)ws_acc;
  float* wm = (float*)ws_ml;
  int* cnt = (int*)counters;
  if (instance == 1) {
    switch (D) {
      case 32:
        return launch_tc<32>(q, k_pages, v_pages, block_tables, lengths, out,
                             wa, wm, cnt, grid, n_store, Hq, Hkv, page, ppseq,
                             ring, n_splits, pps, scale, smem, s);
      case 64:
        return launch_tc<64>(q, k_pages, v_pages, block_tables, lengths, out,
                             wa, wm, cnt, grid, n_store, Hq, Hkv, page, ppseq,
                             ring, n_splits, pps, scale, smem, s);
      case 128:
        return launch_tc<128>(q, k_pages, v_pages, block_tables, lengths,
                              out, wa, wm, cnt, grid, n_store, Hq, Hkv, page,
                              ppseq, ring, n_splits, pps, scale, smem, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (instance != 0) return (int)cudaErrorInvalidValue;
  const int e = opt_in(paged_decode_kernel, smem);
  if (e) return e;
  paged_decode_kernel<<<grid, PD_THREADS, smem, s>>>(
      (const float*)q, (const float*)k_pages, (const float*)v_pages,
      (const int*)block_tables, (const int*)lengths, (float*)out, wa, wm, cnt,
      n_store, Hq, Hkv, D, page, ppseq, ring, n_splits, pps, scale);
  return (int)cudaGetLastError();
}
