// token_clock_update as a standalone CUDA kernel: one thread per grid cell
// loops over that cell's S device clocks (S is small; the row is 2*S
// doubles).  Replaces the Pallas kernel of
// src/repro/kernels/token_clock.py (token_clock_update).  The work is
// bytes-bound: every input is read once and every output written once.
#include <cuda_runtime.h>
#include "token_clock.cuh"

__global__ void token_clock_kernel(const double* __restrict__ submit,
                                   const int* __restrict__ devmask,
                                   const double* __restrict__ tok_in,
                                   const double* __restrict__ bw_in,
                                   double* __restrict__ svc_out,
                                   double* __restrict__ tok_out,
                                   double* __restrict__ bw_out,
                                   int G, int S, double inv_r,
                                   double cost_bw) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  double tok[TC_MAX_DEVICES];
  double bw[TC_MAX_DEVICES];
  uint64_t mask = 0;
  for (int s = 0; s < S; ++s) {
    tok[s] = tok_in[(size_t)g * S + s];
    bw[s] = bw_in[(size_t)g * S + s];
    if (devmask[(size_t)g * S + s] != 0) mask |= (1ull << s);
  }
  svc_out[g] = tc_update(submit[g], tok, bw, S, mask, inv_r, cost_bw);
  for (int s = 0; s < S; ++s) {
    tok_out[(size_t)g * S + s] = tok[s];
    bw_out[(size_t)g * S + s] = bw[s];
  }
}

extern "C" int token_clock_launch(const void* submit, const void* devmask,
                                  const void* tok_in, const void* bw_in,
                                  void* svc_out, void* tok_out, void* bw_out,
                                  int G, int S, double inv_r, double cost_bw,
                                  void* stream) {
  if (G <= 0) return 0;
  const int threads = 128;
  const int blocks = (G + threads - 1) / threads;
  token_clock_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)submit, (const int*)devmask, (const double*)tok_in,
      (const double*)bw_in, (double*)svc_out, (double*)tok_out,
      (double*)bw_out, G, S, inv_r, cost_bw);
  return (int)cudaGetLastError();
}
