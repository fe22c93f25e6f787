// wkv6: the RWKV-6 recurrence, per (batch, head),
//   out_t = r_t . (S + (u * k_t) v_t^T),   S <- diag(exp(log_w_t)) S + k_t v_t^T,
// with r, k, v, log_w (B, S, H, D), u (H, D), the D x D state in float32 and
// the output in r's dtype.  Replaces the Pallas kernel of
// src/repro/kernels/wkv6.py (wkv6), whose grid (B, H, chunks) streams time
// through VMEM in chunks with the state in VMEM scratch.
//
// Grid (B * H), D threads a block.  Thread e owns column e of the state,
// S[:, e], in registers (WKV_DMAX of them, indexed only by unrolled
// constants), so out_e = sum_d r_d (S[d][e] + u_d k_d v_e) needs no
// exchange between threads.  Time is streamed in chunks of tc steps: the
// block copies the chunk's r, k, v and exp(log_w) into shared memory
// (coalesced, one row of D elements a step), synchronises once, and runs
// the tc steps with every thread reading r_t, k_t, w_t as broadcasts; the
// state never leaves the SM.  Accurate expf; explicit fmaf.
// Bound: bytes (each input read once, the output written once: about 1 GB
// at rwkv6-3b's width, B 8, S 4096, H 40, D 64); the operations (3 D^2 a
// step and head) are float32 and few.  What limits this version is the
// chain of S steps inside each block: B * H = 320 blocks of two warps each
// on 132 SMs, each walking 4096 steps.
#include "dtype.cuh"

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

// dtype (of r, k, v and the output) and w_dtype (of log_w): 0 float32,
// 1 bfloat16; u is float32.  D <= WKV_DMAX and a multiple of 4.  Returns
// cudaGetLastError() after the launch (or the error of the shared-memory
// opt-in; cudaErrorInvalidValue for a D the kernel does not take).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* log_w, const void* u, void* out, int B,
                           int S, int H, int D, int tc, int dtype,
                           int w_dtype, int smem, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D <= 0 || D > WKV_DMAX || D % 4 || tc <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (w_dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, log_w, u, out, B,
                                                  S, H, D, tc, smem, s);
    return launch<__nv_bfloat16, float>(r, k, v, log_w, u, out, B, S, H, D,
                                        tc, smem, s);
  }
  if (w_dtype == 1)
    return launch<float, __nv_bfloat16>(r, k, v, log_w, u, out, B, S, H, D,
                                        tc, smem, s);
  return launch<float, float>(r, k, v, log_w, u, out, B, S, H, D, tc, smem,
                              s);
}
