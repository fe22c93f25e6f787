// Fused whole-step scheduler kernel: K scheduler substeps for every cell of
// every cohort of a latency x threads grid in one launch.
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
//   * state is loaded once and stored once per launch; only the uniform
//     block and the trace tables (L2-resident gathers) are read per step.
// Every lane computes the scalar part redundantly (all inputs are warp
// uniform), lane 0 alone writes shared memory, fenced by __syncwarp().
// The static configuration flags are run-time arguments: uniform over the
// launch, so no branch diverges.
//
// One launch steps every cohort of a grid (thread buckets of different T):
// the argument block holds up to SCHED_MAX_COHORTS per-cohort blocks, a block
// finds its cohort from the prefix sum of the cohorts' cell counts and runs
// the body instantiated for that cohort's slot count NS.  A grid of 4
// cohorts x 128 cells so fills 512 warps, about 4 an SM, where a launch per
// cohort left 3 of an SM's 4 warp schedulers idle.
//
// The dependent chain of one step, and what keeps it short:
//   * the ring pop and the prefetch-window min are 64-bit minima taken as
//     two 32-bit `redux.sync` (high words, then low words among the lanes
//     holding the least high word); keys are non-negative doubles, so
//     unsigned integer order is float order and the tag bits (the index)
//     ride along.  The window min is taken only for a step that issues a
//     prefetch (a MEM suboperation next), the idle skip's wake min only
//     for a step that skips;
//   * each thread's current suboperation -- kind, duration, index + 1 and
//     its op's end -- is cached in shared memory, refreshed in the write
//     phase from the row the prefetch reads anyway and the new span's
//     parts, so the pop reaches `now` and the op's end without a
//     device-memory gather or unpacking the span;
//   * a parked thread's woken ring key is kept beside its wake time in
//     registers, set when the wake time is, not rebuilt at every pop;
//   * the cursor's op bounds (`se`) are held in registers one op ahead, and
//     the next suboperation's row (`kd[ni]`) is requested as soon as the
//     popped thread's cache is read;
//   * the IO round-robin's device and the trace cursor wrap by compare, not
//     by an integer modulo (a division sequence on the grant's chain).
// The profiling instance (PROF) adds clock64() stamps at the phase
// boundaries and sums them per cell into a (cells, SCHED_N_PROF) buffer; it
// changes no state plane.
//
// Compiled with -fmad=false: bit-identity with eager PyTorch needs
// `a * b + c` left uncontracted.
#include <cuda_runtime.h>
#include <cstdint>

#include "token_clock.cuh"

#define SCHED_MAX_COHORTS 8
// pop, row + kd, op completion + se, clock grant, prefetch issue, write
// phase (cycles summed over steps), idle skips, cycles of the whole launch
#define SCHED_N_PROF 8

// Mirror of `_SchedCohort` in repro_torch/kernels/sched_step.py (same order):
// one cohort of cells sharing a thread-slot count T.
struct SchedCohort {
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
  // per-cell inputs
  const double* L_mem_g;  // (G,)
  const int* nthr_g;      // (G,)
  const int* warm_g;      // (G,)
  int G, T, NS;
  int block0;        // first block (cell) of the cohort: prefix sum of G
};

// Mirror of `_SchedArgs` (same order): the cohorts, then what they share.
struct SchedArgs {
  SchedCohort co[SCHED_MAX_COHORTS];
  const double* u;        // (K, n_u, n_blocks) or null: cell b at column b
  const double* kd;       // (n_subops, 2): kind, duration
  const double* se;       // (n_ops, 2): op start, op end
  const double* arr;      // (n_arr,) or null
  long long* prof;        // (n_blocks, SCHED_N_PROF), profiling instance
  int n_cohorts, n_blocks, P, S, C, W, NCI, n_u, K, n_trace, n_arr;
  int has_eps, has_rho, has_jitter, has_rio, has_bio, has_bmem, has_lock,
      has_arr, has_lat, has_deadline, has_degrade;
  double n_ops;
  double T_sw, eps, rho, L_dram, L_io, jitter, inv_R, cost_bw_io, L_switch,
      cost_bmem, T_lock, deadline, T_degrade, io_degrade;
  double hist_lo, hist_inv_ln_ratio;
};

namespace {

constexpr int HIST_BINS = 512;
constexpr unsigned long long TAG_MASK = 255ull;
constexpr unsigned long long KEY_MASK = ~255ull;
constexpr double SPAN = 67108864.0;               // 2**26
constexpr double INV_SPAN = 1.0 / 67108864.0;
constexpr double EPOCH = 2.2250738585072014e-308; // smallest normal f64
constexpr double KIND_MEM = 0.0;
constexpr double KIND_PREIO = 1.0;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;      // above every key

__device__ __forceinline__ unsigned long long d2b(double x) {
  return (unsigned long long)__double_as_longlong(x);
}
__device__ __forceinline__ double b2d(unsigned long long x) {
  return __longlong_as_double((long long)x);
}
__device__ __forceinline__ unsigned long long tag_enc(double key, int idx) {
  return (d2b(key) & KEY_MASK) | ((unsigned long long)idx & TAG_MASK);
}
__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                  unsigned long long b) {
  return a < b ? a : b;
}

// The warp's least 64-bit key, in every lane.
__device__ __forceinline__ unsigned long long warp_min_key(
    unsigned long long v) {
  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(v >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL, (unsigned)(v >> 32) == hi ? (unsigned)v : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
}
__device__ __forceinline__ double pick4(const double (&v)[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

// Phase stamps of the profiling instance.
template <bool PROF>
struct PhaseClock {
  long long acc[SCHED_N_PROF - 2];
  long long last;
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int p = 0; p < SCHED_N_PROF - 2; ++p) acc[p] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void stamp(int p) {
    const long long t = clock64();
    acc[p] += t - last;
    last = t;
  }
};
template <>
struct PhaseClock<false> {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void stamp(int) {}
};

template <int NS, bool PROF>
__device__ __forceinline__ void run_cell(const SchedArgs& a,
                                         const SchedCohort& co, const int g,
                                         double* smem) {
  const long long t_launch = PROF ? clock64() : 0;
  const int cell = co.block0 + g;       // column of the uniform block
  const int lane = threadIdx.x;
  const int T = co.T, P = a.P, C = a.C, W = a.W, K = a.K;
  const int U = a.n_blocks;
  const int Tpc = T / C;
  const int n_u = a.n_u;
  const bool multicore = C > 1;
  const bool has_clk = a.has_rio || a.has_bio;
  const bool has_lat = a.has_lat != 0;
  const bool has_arr = a.has_arr != 0;
  const bool has_rho = a.has_rho != 0;
  const int S = has_clk ? a.S : 0;
  const double BIG = b2d(d2b(1e30) & KEY_MASK);
  const unsigned long long BIG_BITS = d2b(BIG);
  const double INF = b2d(0x7ff0000000000000ull);
  const double TE = (double)T * EPOCH;

  double* s_pft = smem;                 // T * W
  // each thread's current suboperation: kind, dur, i + 1, op end
  double* s_kd = s_pft + T * W;         // T * 4
  double* s_slots = s_kd + 4 * T;       // C * P
  double* s_cores = s_slots + C * P;    // 2 * C
  double* s_tok = s_cores + 2 * C;      // S
  double* s_bw = s_tok + S;             // S
  double* s_hist = s_bw + S;            // HIST_BINS (has_lat)

  // ---- load the cell's state once ----------------------------------------
  double* g_pft = co.pft + (size_t)g * T * W;
  for (int i = lane; i < T * W; i += 32) s_pft[i] = g_pft[i];
  double* g_slots = co.pf_slots + (size_t)g * C * P;
  for (int i = lane; i < C * P; i += 32) s_slots[i] = g_slots[i];
  if (multicore)
    for (int i = lane; i < 2 * C; i += 32)
      s_cores[i] = co.cores[(size_t)g * 2 * C + i];
  for (int i = lane; i < S; i += 32) {
    s_tok[i] = co.io_tok[(size_t)g * S + i];
    s_bw[i] = co.io_bw[(size_t)g * S + i];
  }
  if (has_lat)
    for (int i = lane; i < HIST_BINS; i += 32)
      s_hist[i] = co.hist[(size_t)g * HIST_BINS + i];

  // a parked thread's ring key once woken: a function of its wake time,
  // so computed where the wake time is set, not at every pop
  auto woken_key = [&](double w, int t) {
    return tag_enc(fmax(fmin(w, BIG), TE), t);
  };
  double stamp[NS], wake[NS];
  unsigned long long wkey[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int t = lane + 32 * j;
    stamp[j] = t < T ? co.stamp[(size_t)g * T + t] : BIG;
    wake[j] = t < T ? co.wake[(size_t)g * T + t] : INF;
    wkey[j] = woken_key(wake[j], t);
  }
  const double* g_cf = co.cf + (size_t)g * 6;
  double cf0 = g_cf[0], cf1 = g_cf[1], cf2 = g_cf[2], cf3 = g_cf[3],
         cf4 = g_cf[4], cf5 = g_cf[5];
  const int* g_ci = co.ci + (size_t)g * a.NCI;
  int ci0 = g_ci[0], ci1 = g_ci[1], ci2 = g_ci[2], ci3 = g_ci[3],
      ci4 = g_ci[4], ci5 = g_ci[5];
  int ci6 = has_lat ? g_ci[6] : 0;
  double latmax = has_lat ? co.latmax[g] : 0.0;
  const double L_mem = co.L_mem_g[g];
  const int nthr = co.nthr_g[g];
  const int warm = co.warm_g[g];
  // (double)c >= n_ops for an integer count c
  const int n_ops_i = (int)ceil(a.n_ops);
  // the round-robin device of the next IO (io_rr % S), kept by increments
  int io_dev = (has_clk && a.S > 1) ? ci1 % a.S : 0;
  // the cursor's op bounds, held one op ahead
  double se_s = __ldg(a.se + 2 * (size_t)ci0);
  double se_e = __ldg(a.se + 2 * (size_t)ci0 + 1);
  __syncwarp();
  // each thread's current suboperation, from its span
  for (int t = lane; t < T; t += 32) {
    const double span = s_pft[t * W + 1];
    const double end_f = floor(span * INV_SPAN);
    const double i_f = span - end_f * SPAN;
    s_kd[4 * t] = __ldg(a.kd + 2 * (size_t)(int)i_f);
    s_kd[4 * t + 1] = __ldg(a.kd + 2 * (size_t)(int)i_f + 1);
    s_kd[4 * t + 2] = i_f + 1.0;
    s_kd[4 * t + 3] = end_f;
  }
  __syncwarp();

  // Positions of the draws inside one step's uniform row, in consumption
  // order: eps test, eps resample, IO jitter, prefetch latency sample.
  const int ix_jit = 2 * a.has_eps;
  const int ix_pf = ix_jit + a.has_jitter;

  double u_next[4] = {0.0, 0.0, 0.0, 0.0};
  // step k's draws: u_row[j * U].  threadIdx.y is 0 (a block is one warp),
  // but the compiler cannot prove the address warp-uniform, so each lane
  // loads into its own registers: measured faster than the uniform loads.
  const double* u_row = a.u + cell + threadIdx.y;
  const size_t u_step = (size_t)n_u * U;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n_u && K > 0) u_next[j] = __ldg(u_row + (size_t)j * U);

  PhaseClock<PROF> clk;
  long long idle_skips = 0;
  clk.start();
  for (int k = 0; k < K; ++k) {
    double u_cur[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u_cur[j] = u_next[j];
    if (k + 1 < K) {
      u_row += u_step;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n_u) u_next[j] = __ldg(u_row + (size_t)j * U);
    }

    const bool reached = ci3 >= n_ops_i;
    double arr_next = 0.0;
    if (has_arr) {
      int ai = C * nthr + ci2;
      ai = ai < a.n_arr - 1 ? ai : a.n_arr - 1;
      arr_next = __ldg(a.arr + ai);
    }

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

    double* srow = s_slots + cstar * P;   // the core's prefetch window

    // ---- pop the ring head: tagged min over the selected segment ---------
    // (and the segment's earliest wake-up, reduced only for an idle skip)
    auto ring_keys = [&](double now_v, unsigned long long& wk) {
      unsigned long long m = NO_KEY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int t = lane + 32 * j;
        if (t >= seg_lo && t < seg_hi) {
          const double w = wake[j];
          const unsigned long long key =
              (w <= now_v) ? wkey[j] : d2b(stamp[j]);
          m = umin(m, key);
          wk = umin(wk, d2b(w));
        }
      }
      return m;
    };
    unsigned long long wk = NO_KEY;
    unsigned long long head = ring_keys(now, wk);
    head = warp_min_key(head);
    if (head >= BIG_BITS) {
      // idle-skip: nothing runnable -> jump to the earliest wake-up
      ++idle_skips;
      now = fmax(now, b2d(warp_min_key(wk)));
      head = warp_min_key(ring_keys(now, wk));
    }
    const double pop_now = now;
    const int tid = (int)(head & TAG_MASK);
    const unsigned long long ticket = tag_enc(fmax(now, TE), tid);
    clk.stamp(0);

    const double kind = s_kd[4 * tid];
    const double dur = s_kd[4 * tid + 1];
    const double i2 = s_kd[4 * tid + 2];
    const double end_f = s_kd[4 * tid + 3];
    const double* pr = s_pft + tid * W;
    const double pf_tid0 = pr[0];
    const double span = pr[1];
    const double op_start_r = has_lat ? pr[2] : 0.0;
    const bool eoo = i2 >= end_f;
    // the thread's next suboperation: its row is the prefetch's, and the
    // thread's cached (kind, dur) from the write phase on
    const double ni = eoo ? se_s : i2;
    const double kind_n = __ldg(a.kd + 2 * (size_t)(int)ni);
    const double dur_n = __ldg(a.kd + 2 * (size_t)(int)ni + 1);

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
    clk.stamp(1);

    // ---- op completion: counters, measurement window, next op, T_lock ----
    const int done = ci2 + (eoo ? 1 : 0);
    const bool meas_evt = eoo && (done >= warm) && !reached;
    const int measuring = ci5 > (meas_evt ? 1 : 0) ? ci5 : (meas_evt ? 1 : 0);
    const int counted = ci3 + (meas_evt ? 1 : 0);
    const double t_start = (meas_evt && cf3 < 0.0) ? now : cf3;
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
    const double span_next = eoo ? (se_e * SPAN + se_s) : (span + 1.0);
    const int cursor = !eoo ? ci0 : (ci0 + 1 == a.n_trace ? 0 : ci0 + 1);
    double lock_next = cf2;
    if (a.has_lock) {
      const double lock_end = fmax(now, lock_next) + a.T_lock;
      if (eoo) { now = lock_end; lock_next = lock_end; }
    }
    clk.stamp(2);

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
        clk_dev = io_dev;
        if (park) {
          tok_new = s_tok[clk_dev];
          bw_new = s_bw[clk_dev];
          svc = tc_update(now, &tok_new, &bw_new, 1, 1ull, a.inv_R,
                          a.cost_bw_io);
          grant = true;
        }
        io_rr = io_rr + (park ? 1 : 0);
        if (park) io_dev = io_dev + 1 == a.S ? 0 : io_dev + 1;
      }
    }
    double lat_io = a.L_io;
    if (a.has_degrade)
      lat_io = (now >= a.T_degrade) ? (a.L_io * a.io_degrade) : a.L_io;
    if (a.has_jitter)
      lat_io = lat_io * (1.0 + a.jitter * (2.0 * pick4(u_cur, ix_jit) - 1.0));
    const double park_until = (svc + lat_io) + a.L_switch;
    clk.stamp(3);

    // ---- issue the next suboperation's prefetch (P-deep window) ----------
    // Only a MEM suboperation issues; otherwise the window, the bandwidth
    // clock and the thread's prefetch stay as they are, so the window's
    // earliest slot (the one a prefetch replaces) is looked up only then.
    const bool issue = kind_n == KIND_MEM;
    double pf_bw = multicore ? s_cores[2 * cstar + 1] : cf1;
    int slot = 0;
    double comp = 0.0;
    if (issue) {
      unsigned long long sk =
          lane < P ? tag_enc(fmax(srow[lane], EPOCH), lane) : NO_KEY;
#pragma unroll 1
      for (int p = lane + 32; p < P; p += 32)
        sk = umin(sk, tag_enc(fmax(srow[p], EPOCH), p));
      slot = (int)(warp_min_key(sk) & TAG_MASK);
      const double t_iss = (has_arr && eoo) ? fmax(now, arr_next) : now;
      double pstart = fmax(t_iss, srow[slot]);
      if (a.has_bmem) {
        pstart = fmax(pstart, pf_bw);
        pf_bw = pstart + a.cost_bmem;
      }
      const double lm_pf =
          (has_rho && pick4(u_cur, ix_pf) >= a.rho) ? a.L_dram : L_mem;
      comp = pstart + lm_pf;
    }
    const double pf_tid = issue ? comp : pf_tid0;
    clk.stamp(4);

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
    const unsigned long long wkey_val = woken_key(wake_val, tid);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (lane + 32 * j == tid) {
        stamp[j] = stamp_val;
        wake[j] = wake_val;
        wkey[j] = wkey_val;
      }
    }

    const bool crossed = (counted >= n_ops_i) && !reached;

    // ---- write phase: lane 0 commits the shared-memory planes ------------
    __syncwarp();
    if (lane == 0) {
      double* pw = s_pft + tid * W;
      pw[0] = pf_tid;
      pw[1] = span_next;
      s_kd[4 * tid] = kind_n;
      s_kd[4 * tid + 1] = dur_n;
      s_kd[4 * tid + 2] = ni + 1.0;
      s_kd[4 * tid + 3] = eoo ? se_e : end_f;
      if (has_lat) {
        pw[2] = op_start_new;
        if (rec) s_hist[hist_bin] = s_hist[hist_bin] + 1.0;
      }
      if (issue) srow[slot] = comp;
      if (grant) { s_tok[clk_dev] = tok_new; s_bw[clk_dev] = bw_new; }
      if (multicore) {
        s_cores[2 * cstar] = now;
        s_cores[2 * cstar + 1] = pf_bw;
      }
    }
    if (eoo) {
      // the new cursor's op bounds, for the next op completion
      se_s = __ldg(a.se + 2 * (size_t)cursor);
      se_e = __ldg(a.se + 2 * (size_t)cursor + 1);
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
            const unsigned long long cb = d2b(fmax(clock_t, TE2));
            stamp[j] = b2d(tag_enc(b2d(cb - (TAG_MASK + 1)), t));
            wake[j] = INF;
            wkey[j] = woken_key(INF, t);
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
    clk.stamp(5);
  }

  // ---- store the cell's state once ---------------------------------------
  __syncwarp();
  for (int i = lane; i < T * W; i += 32) g_pft[i] = s_pft[i];
  for (int i = lane; i < C * P; i += 32) g_slots[i] = s_slots[i];
  if (multicore)
    for (int i = lane; i < 2 * C; i += 32)
      co.cores[(size_t)g * 2 * C + i] = s_cores[i];
  for (int i = lane; i < S; i += 32) {
    co.io_tok[(size_t)g * S + i] = s_tok[i];
    co.io_bw[(size_t)g * S + i] = s_bw[i];
  }
  if (has_lat)
    for (int i = lane; i < HIST_BINS; i += 32)
      co.hist[(size_t)g * HIST_BINS + i] = s_hist[i];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int t = lane + 32 * j;
    if (t < T) {
      co.stamp[(size_t)g * T + t] = stamp[j];
      co.wake[(size_t)g * T + t] = wake[j];
    }
  }
  if (lane == 0) {
    double* cf_out = co.cf + (size_t)g * 6;
    cf_out[0] = cf0; cf_out[1] = cf1; cf_out[2] = cf2;
    cf_out[3] = cf3; cf_out[4] = cf4; cf_out[5] = cf5;
    int* ci_out = co.ci + (size_t)g * a.NCI;
    ci_out[0] = ci0; ci_out[1] = ci1; ci_out[2] = ci2;
    ci_out[3] = ci3; ci_out[4] = ci4; ci_out[5] = ci5;
    if (has_lat) { ci_out[6] = ci6; co.latmax[g] = latmax; }
  }
  if constexpr (PROF) {
    if (lane == 0) {
      long long* pr = a.prof + (size_t)cell * SCHED_N_PROF;
#pragma unroll
      for (int p = 0; p < SCHED_N_PROF - 2; ++p) pr[p] += clk.acc[p];
      pr[SCHED_N_PROF - 2] += idle_skips;
      pr[SCHED_N_PROF - 1] += clock64() - t_launch;
    }
  }
}

template <bool PROF>
__global__ void __launch_bounds__(32)
    sched_step_kernel(const __grid_constant__ SchedArgs a) {
  extern __shared__ double smem[];
  int c = 0;
  while (c + 1 < a.n_cohorts && (int)blockIdx.x >= a.co[c + 1].block0) ++c;
  const SchedCohort& co = a.co[c];
  const int g = (int)blockIdx.x - co.block0;
  switch (co.NS) {
    case 1: run_cell<1, PROF>(a, co, g, smem); break;
    case 2: run_cell<2, PROF>(a, co, g, smem); break;
    case 4: run_cell<4, PROF>(a, co, g, smem); break;
    default: run_cell<8, PROF>(a, co, g, smem); break;
  }
}

}  // namespace

// Validates the cohort blocks and launches the grouped kernel (the
// profiling instance when `profile` is non-zero).  Returns a cudaError_t.
extern "C" int sched_step_launch(const SchedArgs* args, int profile,
                                 void* stream_ptr) {
  const SchedArgs& a = *args;
  if (a.n_cohorts < 1 || a.n_cohorts > SCHED_MAX_COHORTS)
    return (int)cudaErrorInvalidValue;
  const bool has_clk = a.has_rio || a.has_bio;
  size_t n_dbl = 0;
  int next = 0;
  for (int c = 0; c < a.n_cohorts; ++c) {
    const SchedCohort& co = a.co[c];
    if (co.block0 != next || co.G < 0 || co.T < 1 || co.T > 32 * co.NS ||
        !(co.NS == 1 || co.NS == 2 || co.NS == 4 || co.NS == 8))
      return (int)cudaErrorInvalidValue;
    next += co.G;
    const size_t n = (size_t)co.T * a.W + 4 * (size_t)co.T +
                     (size_t)a.C * a.P + 2 * a.C + (has_clk ? 2 * a.S : 0) +
                     (a.has_lat ? HIST_BINS : 0);
    n_dbl = n > n_dbl ? n : n_dbl;
  }
  if (next != a.n_blocks) return (int)cudaErrorInvalidValue;
  if (a.n_blocks == 0 || a.K <= 0) return 0;
  if (profile && a.prof == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = n_dbl * sizeof(double);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (profile)
    sched_step_kernel<true><<<a.n_blocks, 32, smem, stream>>>(a);
  else
    sched_step_kernel<false><<<a.n_blocks, 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
