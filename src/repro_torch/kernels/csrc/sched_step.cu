// Fused whole-step scheduler kernel: K scheduler substeps for every cell of
// a latency x threads grid in one launch.
//
// Replaces the Pallas kernel `fused_steps` (body `make_substep`) of
// src/repro/kernels/sched_step.py and computes, value for value, what the
// plain PyTorch `make_substep` of repro_torch/kernels/sched_step.py
// computes -- by direct indexing instead of one-hot selects.
//
// Design.  Cells are independent; each cell is one serial recurrence, so the
// kernel is bound by the latency of one step's dependent operations times K,
// not by bytes or arithmetic throughput.  One warp (one block) owns one cell:
//   * `stamp` / `wake` live in registers, lane l owning slots l, l+32, ...
//     (T <= 256, so at most 8 slots a lane; NS is the compile-time count);
//   * `pft`, the prefetch window, the per-core clocks, the SSD token clocks
//     and the sojourn histogram live in shared memory; the cell's scalars
//     (`cf`, `ci`, `latmax`) are replicated in every lane's registers;
//   * the ring pop is a warp-shuffle min over int64 bit patterns: every key
//     is a non-negative double, so integer order equals float order and the
//     tag bits (the thread id) ride along;
//   * state is loaded once and stored once per launch; only the uniform
//     block and the trace tables (L2-resident gathers) are read per step.
// Every lane computes the scalar part redundantly (all inputs are warp
// uniform), lane 0 alone writes shared memory, fenced by __syncwarp().
// The static configuration flags are run-time arguments: uniform over the
// launch, so no branch diverges.
//
// Compiled with -fmad=false: bit-identity with eager PyTorch needs
// `a * b + c` left uncontracted.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "token_clock.cuh"

// Mirror of `_SchedArgs` in repro_torch/kernels/sched_step.py (same order).
struct SchedArgs {
  // state planes (updated in place)
  double* cf;        // (G, 6)
  int* ci;           // (G, NCI)
  double* stamp;     // (G, T)
  double* wake;      // (G, T)
  double* pft;       // (G, T, W)
  double* pf_slots;  // (G, C, P)
  double* cores;     // (G, C, 2)     C > 1
  double* io_tok;    // (G, S)        clock configs
  double* io_bw;     // (G, S)
  double* hist;      // (G, HIST_BINS) has_lat
  double* latmax;    // (G,)
  // inputs
  const double* u;        // (K, n_u, G) or null
  const double* kd;       // (n_subops, 2): kind, duration
  const double* se;       // (n_ops, 2): op start, op end
  const double* arr;      // (n_arr,) or null
  const double* L_mem_g;  // (G,)
  const int* nthr_g;      // (G,)
  const int* warm_g;      // (G,)
  int G, T, P, S, C, W, NCI, n_u, K, n_trace, n_arr;
  int has_eps, has_rho, has_jitter, has_rio, has_bio, has_bmem, has_lock,
      has_arr, has_lat, has_deadline, has_degrade;
  double n_ops;
  double T_sw, eps, rho, L_dram, L_io, jitter, inv_R, cost_bw_io, L_switch,
      cost_bmem, T_lock, deadline, T_degrade, io_degrade;
  double hist_lo, hist_inv_ln_ratio;
};

namespace {

constexpr int HIST_BINS = 512;
constexpr long long TAG_MASK = 255ll;
constexpr long long KEY_MASK = ~255ll;
constexpr double SPAN = 67108864.0;               // 2**26
constexpr double INV_SPAN = 1.0 / 67108864.0;
constexpr double EPOCH = 2.2250738585072014e-308; // smallest normal f64
constexpr double KIND_MEM = 0.0;
constexpr double KIND_PREIO = 1.0;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ long long d2b(double x) {
  return __double_as_longlong(x);
}
__device__ __forceinline__ double b2d(long long x) {
  return __longlong_as_double(x);
}
__device__ __forceinline__ long long tag_enc(double key, int idx) {
  return (d2b(key) & KEY_MASK) | ((long long)idx & TAG_MASK);
}
__device__ __forceinline__ long long warp_min_ll(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    long long o = __shfl_xor_sync(FULL, v, off);
    v = o < v ? o : v;
  }
  return v;
}
__device__ __forceinline__ double warp_min_d(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmin(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ double pick4(const double (&v)[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

template <int NS>
__global__ void __launch_bounds__(32) sched_step_kernel(const SchedArgs a) {
  extern __shared__ double smem[];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int T = a.T, P = a.P, C = a.C, W = a.W, K = a.K, G = a.G;
  const int Tpc = T / C;
  const int n_u = a.n_u;
  const bool multicore = C > 1;
  const bool has_clk = a.has_rio || a.has_bio;
  const bool has_lat = a.has_lat != 0;
  const bool has_arr = a.has_arr != 0;
  const bool has_rho = a.has_rho != 0;
  const int S = has_clk ? a.S : 0;
  const double BIG = b2d(d2b(1e30) & KEY_MASK);
  const long long BIG_BITS = d2b(BIG);
  const double INF = b2d(0x7ff0000000000000ll);
  const double TE = (double)T * EPOCH;

  double* s_pft = smem;                 // T * W
  double* s_slots = s_pft + T * W;      // C * P
  double* s_cores = s_slots + C * P;    // 2 * C
  double* s_tok = s_cores + 2 * C;      // S
  double* s_bw = s_tok + S;             // S
  double* s_hist = s_bw + S;            // HIST_BINS (has_lat)

  // ---- load the cell's state once ----------------------------------------
  double* g_pft = a.pft + (size_t)g * T * W;
  for (int i = lane; i < T * W; i += 32) s_pft[i] = g_pft[i];
  double* g_slots = a.pf_slots + (size_t)g * C * P;
  for (int i = lane; i < C * P; i += 32) s_slots[i] = g_slots[i];
  if (multicore)
    for (int i = lane; i < 2 * C; i += 32)
      s_cores[i] = a.cores[(size_t)g * 2 * C + i];
  for (int i = lane; i < S; i += 32) {
    s_tok[i] = a.io_tok[(size_t)g * S + i];
    s_bw[i] = a.io_bw[(size_t)g * S + i];
  }
  if (has_lat)
    for (int i = lane; i < HIST_BINS; i += 32)
      s_hist[i] = a.hist[(size_t)g * HIST_BINS + i];

  double stamp[NS], wake[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int t = lane + 32 * j;
    stamp[j] = t < T ? a.stamp[(size_t)g * T + t] : BIG;
    wake[j] = t < T ? a.wake[(size_t)g * T + t] : INF;
  }
  double cf0 = a.cf[g * 6 + 0], cf1 = a.cf[g * 6 + 1], cf2 = a.cf[g * 6 + 2],
         cf3 = a.cf[g * 6 + 3], cf4 = a.cf[g * 6 + 4], cf5 = a.cf[g * 6 + 5];
  const int* g_ci = a.ci + (size_t)g * a.NCI;
  int ci0 = g_ci[0], ci1 = g_ci[1], ci2 = g_ci[2], ci3 = g_ci[3],
      ci4 = g_ci[4], ci5 = g_ci[5];
  int ci6 = has_lat ? g_ci[6] : 0;
  double latmax = has_lat ? a.latmax[g] : 0.0;
  const double L_mem = a.L_mem_g[g];
  const int nthr = a.nthr_g[g];
  const int warm = a.warm_g[g];
  const double n_ops = a.n_ops;
  __syncwarp();

  // Positions of the draws inside one step's uniform row, in consumption
  // order: eps test, eps resample, IO jitter, prefetch latency sample.
  const int ix_jit = 2 * a.has_eps;
  const int ix_pf = ix_jit + a.has_jitter;

  double u_next[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n_u && K > 0) u_next[j] = __ldg(a.u + (size_t)j * G + g);

  for (int k = 0; k < K; ++k) {
    double u_cur[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u_cur[j] = u_next[j];
    if (k + 1 < K) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n_u)
          u_next[j] = __ldg(a.u + ((size_t)(k + 1) * n_u + j) * G + g);
    }

    const bool reached = (double)ci3 >= n_ops;

    // ---- core selection (exact strict-< scan; ties to the lower core) ----
    int cstar = 0;
    double now;
    if (multicore) {
      now = s_cores[0];
      for (int c = 1; c < C; ++c) {
        const double cand = s_cores[2 * c];
        if (cand < now) { cstar = c; now = cand; }
      }
    } else {
      now = cf0;
    }
    const int seg_lo = cstar * Tpc;
    const int seg_hi = seg_lo + Tpc;

    // ---- pop the ring head: tagged min over the selected segment ---------
    auto ring_min = [&](double now_v) -> long long {
      long long m = LLONG_MAX;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int t = lane + 32 * j;
        if (t >= seg_lo && t < seg_hi) {
          const double w = wake[j];
          const long long key =
              (w <= now_v) ? tag_enc(fmax(fmin(w, BIG), TE), t)
                           : d2b(stamp[j]);
          m = key < m ? key : m;
        }
      }
      return warp_min_ll(m);
    };
    long long head = ring_min(now);
    if (head >= BIG_BITS) {
      // idle-skip: nothing runnable -> jump to the earliest wake-up
      double wm = INF;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int t = lane + 32 * j;
        if (t >= seg_lo && t < seg_hi) wm = fmin(wm, wake[j]);
      }
      wm = warp_min_d(wm);
      now = fmax(now, wm);
      head = ring_min(now);
    }
    const double pop_now = now;
    const int tid = (int)(head & TAG_MASK);
    const long long ticket = tag_enc(fmax(now, TE), tid);

    const double* pr = s_pft + tid * W;
    const double pf_tid0 = pr[0];
    const double span = pr[1];
    const double op_start_r = has_lat ? pr[2] : 0.0;
    const double end_f = floor(span * INV_SPAN);
    const double i_f = span - end_f * SPAN;
    const int ii = (int)i_f;
    const double kind = __ldg(a.kd + 2 * (size_t)ii);
    const double dur = __ldg(a.kd + 2 * (size_t)ii + 1);

    // ---- MEM: stall on the outstanding prefetch (or an eps re-fetch) -----
    const bool is_mem = kind == KIND_MEM;
    double ready_at = pf_tid0;
    if (a.has_eps) {
      const double u_eps = u_cur[0];
      const double u_evict = u_cur[1];
      const double lm = (has_rho && u_evict >= a.rho) ? a.L_dram : L_mem;
      if (u_eps < a.eps) ready_at = now + lm;
    }
    const double stall = ready_at - now;
    const bool stalled = is_mem && (stall > 0.0);
    const bool live = (ci5 > 0) && !reached;
    const double mem_stall = cf5 + ((stalled && live) ? stall : 0.0);
    const int mem_acc = ci4 + ((is_mem && live) ? 1 : 0);
    now = (stalled ? ready_at : now) + dur;

    // ---- op completion: counters, measurement window, next op, T_lock ----
    const double i2 = i_f + 1.0;
    const bool eoo = i2 >= end_f;
    const int done = ci2 + (eoo ? 1 : 0);
    const bool meas_evt = eoo && (done >= warm) && !reached;
    const int measuring = ci5 > (meas_evt ? 1 : 0) ? ci5 : (meas_evt ? 1 : 0);
    const int counted = ci3 + (meas_evt ? 1 : 0);
    const double t_start = (meas_evt && cf3 < 0.0) ? now : cf3;
    double arr_next = 0.0;
    if (has_arr) {
      int ai = C * nthr + ci2;
      ai = ai < a.n_arr - 1 ? ai : a.n_arr - 1;
      arr_next = __ldg(a.arr + ai);
    }
    int missed = ci6;
    bool rec = false;
    int hist_bin = 0;
    double op_start_new = 0.0;
    if (has_lat) {
      const double sojourn = now - op_start_r;
      const bool is_miss = a.has_deadline ? (sojourn > a.deadline) : false;
      rec = meas_evt && !is_miss;
      missed = ci6 + ((meas_evt && is_miss) ? 1 : 0);
      double b = floor(log(fmax(sojourn, a.hist_lo) / a.hist_lo)
                       * a.hist_inv_ln_ratio);
      b = fmin(fmax(b, 0.0), (double)(HIST_BINS - 1));
      hist_bin = (int)b;
      if (rec) latmax = fmax(latmax, sojourn);
      op_start_new = eoo ? (has_arr ? arr_next : now) : op_start_r;
    }
    const double se_s = __ldg(a.se + 2 * (size_t)ci0);
    const double se_e = __ldg(a.se + 2 * (size_t)ci0 + 1);
    const double span_next = eoo ? (se_e * SPAN + se_s) : (span + 1.0);
    const double ni = eoo ? se_s : i2;
    const int cursor = eoo ? (ci0 + 1) % a.n_trace : ci0;
    double lock_next = cf2;
    if (a.has_lock) {
      const double lock_end = fmax(now, lock_next) + a.T_lock;
      if (eoo) { now = lock_end; lock_next = lock_end; }
    }

    // ---- PREIO: submit against the striped per-device token clocks -------
    const bool park = (kind == KIND_PREIO) && !eoo;
    int io_rr = ci1;
    double svc = now;
    // The clocks live in shared memory: every lane derives svc and the
    // selected device's new clock values from the pre-grant clocks, lane 0
    // commits them in the write phase below.
    bool grant = false;
    int clk_dev = 0;
    double tok_new = 0.0, bw_new = 0.0;
    if (has_clk) {
      if (a.S == 1) {
        // inlined single-device clocks: IOPS first, then bandwidth
        tok_new = s_tok[0];
        bw_new = s_bw[0];
        if (a.has_rio) {
          svc = fmax(svc, tok_new);
          if (park) tok_new = svc + a.inv_R;
        }
        if (a.has_bio) {
          svc = fmax(svc, bw_new);
          if (park) bw_new = svc + a.cost_bw_io;
        }
        grant = park;
      } else {
        // striped devices: the shared __device__ grant on the round-robin
        // device's two clocks (a row that submits no IO is not gated)
        clk_dev = io_rr % a.S;
        if (park) {
          tok_new = s_tok[clk_dev];
          bw_new = s_bw[clk_dev];
          svc = tc_update(now, &tok_new, &bw_new, 1, 1ull, a.inv_R,
                          a.cost_bw_io);
          grant = true;
        }
        io_rr = io_rr + (park ? 1 : 0);
      }
    }
    double lat_io = a.L_io;
    if (a.has_degrade)
      lat_io = (now >= a.T_degrade) ? (a.L_io * a.io_degrade) : a.L_io;
    if (a.has_jitter)
      lat_io = lat_io * (1.0 + a.jitter * (2.0 * pick4(u_cur, ix_jit) - 1.0));
    const double park_until = (svc + lat_io) + a.L_switch;

    // ---- issue the next suboperation's prefetch (P-deep window) ----------
    const bool issue = __ldg(a.kd + 2 * (size_t)(int)ni) == KIND_MEM;
    double* srow = s_slots + cstar * P;
    double pf_bw = multicore ? s_cores[2 * cstar + 1] : cf1;
    long long sm = LLONG_MAX;
    for (int p = lane; p < P; p += 32) {
      const long long key = tag_enc(fmax(srow[p], EPOCH), p);
      sm = key < sm ? key : sm;
    }
    sm = warp_min_ll(sm);
    const int slot = (int)(sm & TAG_MASK);
    const double slot_min = srow[slot];
    const double t_iss = (has_arr && eoo) ? fmax(now, arr_next) : now;
    double pstart = fmax(t_iss, slot_min);
    if (a.has_bmem) {
      pstart = fmax(pstart, pf_bw);
      if (issue) pf_bw = pstart + a.cost_bmem;
    }
    const double lm_pf =
        (has_rho && pick4(u_cur, ix_pf) >= a.rho) ? a.L_dram : L_mem;
    const double comp = pstart + lm_pf;
    const double pf_tid = issue ? comp : pf_tid0;

    // ---- yield: context switch, park or re-enter the ready ring ----------
    now = now + a.T_sw;
    bool parked_any = park;
    double wake_val = park ? fmax(park_until, now) : INF;
    if (has_arr) {
      const bool park_arr = eoo && (arr_next > now);
      parked_any = park || park_arr;
      if (park_arr) wake_val = arr_next;
    }
    const double stamp_val = parked_any ? BIG : b2d(ticket);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (lane + 32 * j == tid) { stamp[j] = stamp_val; wake[j] = wake_val; }
    }

    const bool crossed = ((double)counted >= n_ops) && !reached;

    // ---- write phase: lane 0 commits the shared-memory planes ------------
    __syncwarp();
    if (lane == 0) {
      double* pw = s_pft + tid * W;
      pw[0] = pf_tid;
      pw[1] = span_next;
      if (has_lat) {
        pw[2] = op_start_new;
        if (rec) s_hist[hist_bin] = s_hist[hist_bin] + 1.0;
      }
      srow[slot] = issue ? comp : slot_min;
      if (grant) { s_tok[clk_dev] = tok_new; s_bw[clk_dev] = bw_new; }
      if (multicore) {
        s_cores[2 * cstar] = now;
        s_cores[2 * cstar + 1] = pf_bw;
      }
    }
    __syncwarp();
    double t_end;
    if (multicore) {
      // global drain horizon: materialize cross-core early wake-ups
      const double H = fmax(cf0, pop_now);
      const double TE2 = 2.0 * (double)T * EPOCH;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int t = lane + 32 * j;
        if (t < T) {
          const double clock_t = s_cores[2 * (t / Tpc)];
          const double w = wake[j];
          if (w <= H && w > clock_t) {
            const long long cb = d2b(fmax(clock_t, TE2));
            stamp[j] = b2d(tag_enc(b2d(cb - (TAG_MASK + 1)), t));
            wake[j] = INF;
          }
        }
      }
      t_end = cf4;
      if (crossed) {
        double mx = s_cores[0];
        for (int c = 1; c < C; ++c) mx = fmax(mx, s_cores[2 * c]);
        t_end = mx;
      }
      cf0 = H;        // cf slot 0 carries the drain horizon
      // cf1 is unused with a core axis and passes through
    } else {
      t_end = crossed ? now : cf4;
      cf0 = now;
      cf1 = pf_bw;
    }
    cf2 = lock_next; cf3 = t_start; cf4 = t_end; cf5 = mem_stall;
    ci0 = cursor; ci1 = io_rr; ci2 = done; ci3 = counted; ci4 = mem_acc;
    ci5 = measuring; ci6 = missed;
  }

  // ---- store the cell's state once ---------------------------------------
  __syncwarp();
  for (int i = lane; i < T * W; i += 32) g_pft[i] = s_pft[i];
  for (int i = lane; i < C * P; i += 32) g_slots[i] = s_slots[i];
  if (multicore)
    for (int i = lane; i < 2 * C; i += 32)
      a.cores[(size_t)g * 2 * C + i] = s_cores[i];
  for (int i = lane; i < S; i += 32) {
    a.io_tok[(size_t)g * S + i] = s_tok[i];
    a.io_bw[(size_t)g * S + i] = s_bw[i];
  }
  if (has_lat)
    for (int i = lane; i < HIST_BINS; i += 32)
      a.hist[(size_t)g * HIST_BINS + i] = s_hist[i];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int t = lane + 32 * j;
    if (t < T) {
      a.stamp[(size_t)g * T + t] = stamp[j];
      a.wake[(size_t)g * T + t] = wake[j];
    }
  }
  if (lane == 0) {
    double* g_cf = a.cf + (size_t)g * 6;
    g_cf[0] = cf0; g_cf[1] = cf1; g_cf[2] = cf2;
    g_cf[3] = cf3; g_cf[4] = cf4; g_cf[5] = cf5;
    int* ci_out = a.ci + (size_t)g * a.NCI;
    ci_out[0] = ci0; ci_out[1] = ci1; ci_out[2] = ci2;
    ci_out[3] = ci3; ci_out[4] = ci4; ci_out[5] = ci5;
    if (has_lat) { ci_out[6] = ci6; a.latmax[g] = latmax; }
  }
}

}  // namespace

extern "C" int sched_step_launch(const SchedArgs* args, void* stream_ptr) {
  const SchedArgs a = *args;
  if (a.G <= 0 || a.K <= 0) return 0;
  const bool has_clk = a.has_rio || a.has_bio;
  const size_t n_dbl = (size_t)a.T * a.W + (size_t)a.C * a.P + 2 * a.C +
                       (has_clk ? 2 * a.S : 0) +
                       (a.has_lat ? HIST_BINS : 0);
  const size_t smem = n_dbl * sizeof(double);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int ns = (a.T + 31) / 32;
  if (ns <= 1)
    sched_step_kernel<1><<<a.G, 32, smem, stream>>>(a);
  else if (ns <= 2)
    sched_step_kernel<2><<<a.G, 32, smem, stream>>>(a);
  else if (ns <= 4)
    sched_step_kernel<4><<<a.G, 32, smem, stream>>>(a);
  else if (ns <= 8)
    sched_step_kernel<8><<<a.G, 32, smem, stream>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
