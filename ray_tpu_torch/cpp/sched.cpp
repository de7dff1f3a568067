// Native scheduling core: feasibility + node selection over dense
// resource matrices.
//
// Equivalent of the reference's C++ scheduling policies
// (reference: src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h:50
// hybrid pack-then-spread; scheduling_policy spread variant;
// cluster_resource_data.h dense NodeResources). The Python layer
// (ray_tpu_torch/_private/scheduler.py) lowers its node dicts into dense
// [n_nodes x n_res] matrices and calls rt_pick_node; semantics are kept
// identical to the Python implementation, which doubles as the test oracle.
//
// Build: g++ -O2 -shared -fPIC -o libray_tpu_torch_sched.so sched.cpp
#include <cstdint>

namespace {

constexpr double kEps = 1e-9;

inline bool Fits(const double* demand, const double* avail, int n_res) {
  for (int r = 0; r < n_res; ++r) {
    if (demand[r] > 0 && avail[r] + kEps < demand[r]) return false;
  }
  return true;
}

// available CPU fraction — the load signal the Python policy uses. A
// missing/out-of-range CPU column reads as fully available rather than
// indexing out of bounds (found by the ASAN fuzz driver in
// tests/test_sanitizers.py; the same bounds discipline rt_pick_node
// already applies to local_index).
inline double AvailFrac(const double* avail, const double* total, int cpu_col,
                        int n_res) {
  if (cpu_col < 0 || cpu_col >= n_res) return 1.0;
  double cpu_total = total[cpu_col];
  if (cpu_total == 0) cpu_total = 1.0;
  return avail[cpu_col] / cpu_total;
}

}  // namespace

extern "C" {

// strategy: 0 = default/hybrid (local first, else most-loaded feasible —
//               pack), 1 = spread (least-loaded feasible)
// Returns the chosen node row index, or -1 if infeasible everywhere.
int rt_pick_node(const double* demand, int n_res, const double* avail,
                 const double* total, const uint8_t* alive, int n_nodes,
                 int cpu_col, int strategy, int local_index) {
  if (n_nodes <= 0 || n_res <= 0) return -1;
  // hybrid: local node wins outright when feasible
  if (strategy == 0 && local_index >= 0 && local_index < n_nodes &&
      alive[local_index] &&
      Fits(demand, avail + (int64_t)local_index * n_res, n_res)) {
    return local_index;
  }
  int best = -1;
  double best_frac = 0;
  for (int i = 0; i < n_nodes; ++i) {
    if (!alive[i]) continue;
    const double* a = avail + (int64_t)i * n_res;
    if (!Fits(demand, a, n_res)) continue;
    double frac = AvailFrac(a, total + (int64_t)i * n_res, cpu_col, n_res);
    if (best == -1 ||
        (strategy == 1 ? frac > best_frac : frac < best_frac)) {
      best = i;
      best_frac = frac;
    }
  }
  return best;
}

// Batch feasibility check: out[i] = 1 if demand fits node i's availability.
// Used by the dispatch loop to prefilter queued work without Python dict
// traffic.
void rt_feasible_mask(const double* demand, int n_res, const double* avail,
                      const uint8_t* alive, int n_nodes, uint8_t* out) {
  for (int i = 0; i < n_nodes; ++i) {
    out[i] = alive[i] && Fits(demand, avail + (int64_t)i * n_res, n_res);
  }
}

}  // extern "C"
