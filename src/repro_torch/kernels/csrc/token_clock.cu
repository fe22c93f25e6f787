// token_clock_update as a standalone CUDA kernel.  Replaces the Pallas
// kernel of src/repro/kernels/token_clock.py (token_clock_update).
//
// The function moves a few kilobytes (at the scenarios' (128, 2) planes
// about 13 KB): its byte bound is some 1000x below the cost of launching
// any kernel, so what bounds it on the card is the launch, and the design
// keeps the kernel at an empty kernel's cost.  One thread a grid cell, one
// launch a call.  Instances:
//   * S = 1, 2, 4, 8 (the scenarios' device counts), specialised at compile
//     time: the cell's clock rows in registers, loaded and stored as
//     16-byte double2 where S is even, and the bool mask row read as one
//     1-, 2-, 4- or 8-byte word;
//   * generic, any S <= TC_MAX_DEVICES and a mask of 1-, 2-, 4- or 8-byte
//     integers: two passes over the row (the selected clocks' sums, then
//     the writes), nothing held per device.
// Both give the grant of token_clock.cuh bit for bit (-fmad=false).
//
// Outputs go to one buffer: tok' (G*S) | bw' (G*S) | svc (G).
#include <cuda_runtime.h>
#include <cstdint>

#include "token_clock.cuh"

#define TC_THREADS 128

template <int N>
__device__ __forceinline__ void tc_load_row(const double* __restrict__ p,
                                            double* r) {
  if constexpr (N % 2 == 0) {
    const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 v = q[i];
      r[2 * i] = v.x;
      r[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void tc_store_row(double* __restrict__ p,
                                             const double* r) {
  if constexpr (N % 2 == 0) {
    double2* q = reinterpret_cast<double2*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) q[i] = make_double2(r[2 * i], r[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = r[i];
  }
}

// The bit set of a row of N one-byte mask entries, read as one word.
template <int N>
__device__ __forceinline__ uint64_t tc_mask_bits(const uint8_t* __restrict__ p) {
  uint64_t word;
  if constexpr (N == 1) word = p[0];
  else if constexpr (N == 2) word = *reinterpret_cast<const uint16_t*>(p);
  else if constexpr (N == 4) word = *reinterpret_cast<const uint32_t*>(p);
  else word = *reinterpret_cast<const uint64_t*>(p);
  uint64_t bits = 0;
#pragma unroll
  for (int s = 0; s < N; ++s)
    if ((word >> (8 * s)) & 0xffull) bits |= 1ull << s;
  return bits;
}

// Entry i of a mask of `mb`-byte integers is non-zero.
__device__ __forceinline__ bool tc_mask_at(const uint8_t* __restrict__ p,
                                           size_t i, int mb) {
  switch (mb) {
    case 1: return p[i] != 0;
    case 2: return reinterpret_cast<const uint16_t*>(p)[i] != 0;
    case 4: return reinterpret_cast<const uint32_t*>(p)[i] != 0;
    default: return reinterpret_cast<const uint64_t*>(p)[i] != 0;
  }
}

// N > 0: the instance for S == N (one-byte mask, aligned rows); N == 0: the
// generic instance.
template <int N>
__global__ void __launch_bounds__(TC_THREADS)
token_clock_kernel(const double* __restrict__ submit,
                   const uint8_t* __restrict__ devmask,
                   const double* __restrict__ tok_in,
                   const double* __restrict__ bw_in,
                   double* __restrict__ out, int G, int S, int mask_bytes,
                   double inv_r, double cost_bw) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t n = (size_t)G * S;
  const size_t row = (size_t)g * S;
  double* tok_out = out;
  double* bw_out = out + n;
  if constexpr (N > 0) {
    double tok[N], bw[N];
    tc_load_row<N>(tok_in + row, tok);
    tc_load_row<N>(bw_in + row, bw);
    const uint64_t mask = tc_mask_bits<N>(devmask + row);
    out[2 * n + g] = tc_update<N>(submit[g], tok, bw, N, mask, inv_r,
                                  cost_bw);
    tc_store_row<N>(tok_out + row, tok);
    tc_store_row<N>(bw_out + row, bw);
  } else {
    // tc_update's arithmetic, the row streamed: the selected clocks' sums
    // in device order, then each clock written once
    uint64_t mask = 0;
    double at_tok = 0.0, at_bw = 0.0;
    for (int s = 0; s < S; ++s) {
      const bool m = tc_mask_at(devmask, row + s, mask_bytes);
      mask |= (uint64_t)m << s;
      at_tok = at_tok + (m ? tok_in[row + s] : 0.0);
      at_bw = at_bw + (m ? bw_in[row + s] : 0.0);
    }
    const double svc_tok = tc_service(submit[g], at_tok, inv_r);
    const double svc = tc_service(svc_tok, at_bw, cost_bw);
    const double next_tok = svc_tok + inv_r;
    const double next_bw = svc + cost_bw;
    const bool on_tok = inv_r > 0.0, on_bw = cost_bw > 0.0;
    for (int s = 0; s < S; ++s) {
      const bool m = (mask >> s) & 1ull;
      tok_out[row + s] = (on_tok && m) ? next_tok : tok_in[row + s];
      bw_out[row + s] = (on_bw && m) ? next_bw : bw_in[row + s];
    }
    out[2 * n + g] = svc;
  }
}

template <int N>
static void tc_launch(const void* submit, const void* devmask,
                      const void* tok_in, const void* bw_in, void* out, int G,
                      int S, int mask_bytes, double inv_r, double cost_bw,
                      cudaStream_t stream) {
  const int blocks = (G + TC_THREADS - 1) / TC_THREADS;
  token_clock_kernel<N><<<blocks, TC_THREADS, 0, stream>>>(
      (const double*)submit, (const uint8_t*)devmask, (const double*)tok_in,
      (const double*)bw_in, (double*)out, G, S, mask_bytes, inv_r, cost_bw);
}

// width: S for a specialised instance (1, 2, 4 or 8; the caller has checked
// a one-byte mask and 16-byte aligned rows), 0 for the generic one.
extern "C" int token_clock_launch(const void* submit, const void* devmask,
                                  const void* tok_in, const void* bw_in,
                                  void* out, int G, int S, int mask_bytes,
                                  int width, double inv_r, double cost_bw,
                                  void* stream) {
  if (G <= 0) return 0;
  if (S < 1 || S > TC_MAX_DEVICES || (width != 0 && width != S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 0: tc_launch<0>(submit, devmask, tok_in, bw_in, out, G, S,
                         mask_bytes, inv_r, cost_bw, st); break;
    case 1: tc_launch<1>(submit, devmask, tok_in, bw_in, out, G, S,
                         mask_bytes, inv_r, cost_bw, st); break;
    case 2: tc_launch<2>(submit, devmask, tok_in, bw_in, out, G, S,
                         mask_bytes, inv_r, cost_bw, st); break;
    case 4: tc_launch<4>(submit, devmask, tok_in, bw_in, out, G, S,
                         mask_bytes, inv_r, cost_bw, st); break;
    case 8: tc_launch<8>(submit, devmask, tok_in, bw_in, out, G, S,
                         mask_bytes, inv_r, cost_bw, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
