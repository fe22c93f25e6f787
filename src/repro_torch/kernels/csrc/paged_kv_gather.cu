// paged_decode_attention: one new token per sequence attends over a page
// store (P, page, Hkv, D) through a block table, with an n_buf-deep ring of
// page slots in shared memory filled by cp.async ahead of the page being
// computed.  Replaces the Pallas kernel of
// src/repro/kernels/paged_kv_gather.py (paged_decode_attention), whose
// VMEM staging ring is filled by make_async_copy DMAs.
//
// Grid (B, Hkv), PD_THREADS threads a block.  A block holds the rep = Hq/Hkv
// query rows of one KV head in float32, pre-scaled by 1/sqrt(D).  For page
// i of its sequence: wait until page i's copy group has landed (at most
// n_buf-1 younger groups may still be in flight), scores (one thread per
// (query row, key row), a dot product over D with four partial sums), an
// online softmax per query row in float32 (one warp per row; positions >=
// length masked with -1e30; accurate expf), the acc = acc * corr + P V
// update (one thread per column, up to PD_PV_ROWS rows' sums in registers),
// and only then the copies of page i + n_buf into the slot page i leaves
// free.  The products are explicit fmaf, so -fmad=false does not split them.
// The work is bound by bytes (each page row of head h is read once); this
// version uses no tensor cores and keeps one block per (sequence, KV head).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define PD_THREADS 128
#define PD_WARPS (PD_THREADS / 32)
#define PD_NEG_INF (-1e30f)
#define PD_PV_ROWS 8

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// four consecutive elements (8- or 16-byte aligned) as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, T* __restrict__ out, int n_store,
    int Hq, int Hkv, int D, int page, int ppseq, int n_buf, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rep = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // shared layout (smem_bytes() in paged_kv_gather.py): K ring, V ring,
  // q rows, accumulators, one page of scores, m, l, corr per row
  const int slot_elems = page * D;
  T* k_ring = reinterpret_cast<T*>(smem_raw);
  T* v_ring = k_ring + (size_t)n_buf * slot_elems;
  float* q_s = reinterpret_cast<float*>(v_ring + (size_t)n_buf * slot_elems);
  float* acc_s = q_s + rep * D;
  float* p_s = acc_s + rep * D;
  float* m_s = p_s + rep * page;
  float* l_s = m_s + rep;
  float* c_s = l_s + rep;

  const int length = lengths[b];
  int n_pages = length > 0 ? (length + page - 1) / page : 0;
  if (n_pages > ppseq) n_pages = ppseq;     // positions past the table: none
  const int* table = block_tables + (size_t)b * ppseq;

  const int n_quads = D / 4;                // score loop: 4 elements a step
  const int n_groups = (rep + PD_PV_ROWS - 1) / PD_PV_ROWS;
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  const int row_chunks = D / VEC;
  const int page_chunks = page * row_chunks;
  const size_t row_stride = (size_t)Hkv * D;   // between slots of a page

  // copies of page p_idx of this sequence (head h) into ring slot `slot`,
  // one commit group per page (an empty group past the last page, so that
  // every iteration counts the same number of groups)
  auto issue = [&](int p_idx, int slot) {
    if (p_idx < n_pages) {
      // a page id outside the store is the caller's error; clamping keeps
      // the copy inside the store's memory (the plain version raises)
      const int pid = min(max(table[p_idx], 0), n_store - 1);
      const size_t base = ((size_t)pid * page * Hkv + (size_t)h) * D;
      T* kd = k_ring + (size_t)slot * slot_elems;
      T* vd = v_ring + (size_t)slot * slot_elems;
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

  for (int s = 0; s < n_buf; ++s) issue(s, s);

  const T* qb = q + ((size_t)b * Hq + (size_t)h * rep) * D;
  for (int i = tid; i < rep * D; i += PD_THREADS) {
    q_s[i] = to_f32(qb[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += PD_THREADS) {
    m_s[r] = PD_NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int slot = p % n_buf;
    cp_async_wait_upto(n_buf - 1);
    __syncthreads();                  // every thread's copies of page p
    const T* kt = k_ring + (size_t)slot * slot_elems;
    const T* vt = v_ring + (size_t)slot * slot_elems;
    const int pos0 = p * page;

    // scores: one thread per (query row r, key row j), four elements a
    // step; row j starts at column chunk j so that the threads of a warp
    // read different banks
    for (int idx = tid; idx < rep * page; idx += PD_THREADS) {
      const int r = idx / page;
      const int j = idx - r * page;
      const float* qr = q_s + r * D;
      const T* kr = kt + j * D;
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
    for (int i = tid; i < D * n_groups; i += PD_THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      const int r0 = g * PD_PV_ROWS;
      float a[PD_PV_ROWS];
#pragma unroll
      for (int rr = 0; rr < PD_PV_ROWS; ++rr) a[rr] = 0.f;
      for (int j = 0; j < page; ++j) {
        const float vj = to_f32(vt[j * D + d]);
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
    __syncthreads();                  // page p's slot is read out
    issue(p + n_buf, slot);
  }
  cp_async_wait<0>();

  T* ob = out + ((size_t)b * Hq + (size_t)h * rep) * D;
  for (int i = tid; i < rep * D; i += PD_THREADS) {
    const int r = i / D;
    ob[i] = from_f32<T>(acc_s[i] / fmaxf(l_s[r], 1e-37f));
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* bt, const void* ln, void* out, int B,
                  int n_store, int Hq, int Hkv, int D, int page, int ppseq,
                  int n_buf, float scale, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, PD_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)bt,
      (const int*)ln, (T*)out, n_store, Hq, Hkv, D, page, ppseq, n_buf,
      scale);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after the
// launch (or the error of the shared-memory opt-in).
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_tables,
                                   const void* lengths, void* out, int B,
                                   int n_store, int Hq, int Hkv, int D,
                                   int page, int ppseq, int n_buf, int dtype,
                                   float scale, int smem, void* stream) {
  if (B <= 0 || Hkv <= 0 || n_store <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                                 out, B, n_store, Hq, Hkv, D, page, ppseq,
                                 n_buf, scale, smem, s);
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B,
                       n_store, Hq, Hkv, D, page, ppseq, n_buf, scale, smem,
                       s);
}
