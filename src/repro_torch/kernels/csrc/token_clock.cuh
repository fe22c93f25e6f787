// Token-clock grant shared by the standalone token_clock_update kernel and
// the fused scheduler step (sched_step.cu).
//
// One grant admits a request at `submit` against the clocks of one cell:
//   at_dev  = sum over devices of (mask ? clock : 0)   (one-hot mask: the
//             selected device's clock; empty mask: 0.0, which never gates
//             because simulated time is non-negative)
//   svc     = spacing > 0 ? max(submit, at_dev) : submit
//   clock_s = spacing > 0 && mask_s ? svc + spacing : clock_s
// The device mask is a bit set (bit s = device s), so S <= TC_MAX_DEVICES.
// Compiled with -fmad=false: svc + spacing must not contract with anything.
#pragma once
#include <cstdint>

#define TC_MAX_DEVICES 64

// The grant's service time from the selected clock's value `at_dev`.
__device__ __forceinline__ double tc_service(double submit, double at_dev,
                                             double spacing) {
  return spacing > 0.0 ? fmax(submit, at_dev) : submit;
}

// N > 0: the row's width known at compile time (the loops unroll and the
// row stays in registers); N == 0: `n_dev` at run time.
template <int N = 0>
__device__ __forceinline__ double tc_grant(double submit, double* clocks,
                                           int n_dev, uint64_t mask,
                                           double spacing) {
  if (!(spacing > 0.0)) return submit;
  const int n = N > 0 ? N : n_dev;
  double at_dev = 0.0;
#pragma unroll
  for (int s = 0; s < n; ++s)
    at_dev = at_dev + (((mask >> s) & 1ull) ? clocks[s] : 0.0);
  const double svc = tc_service(submit, at_dev, spacing);
  const double next = svc + spacing;
#pragma unroll
  for (int s = 0; s < n; ++s)
    if ((mask >> s) & 1ull) clocks[s] = next;
  return svc;
}

// IOPS clock first, then bandwidth: the bandwidth grant sees the
// IOPS-delayed service time.
template <int N = 0>
__device__ __forceinline__ double tc_update(double submit, double* tok,
                                            double* bw, int n_dev,
                                            uint64_t mask, double inv_r,
                                            double cost_bw) {
  double svc = tc_grant<N>(submit, tok, n_dev, mask, inv_r);
  return tc_grant<N>(svc, bw, n_dev, mask, cost_bw);
}
