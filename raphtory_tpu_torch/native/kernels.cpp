// raphtory_tpu_torch native host kernels.
//
// Host hot loops around the device compute path: the snapshot builder's
// event sorts and fused latest-state fold, the sorted two-column join used by
// property materialisation, and the parallel batched searchsorted behind the
// per-hop engine-position lookup. Loaded from Python via ctypes
// (`raphtory_tpu_torch/native/lib.py`); every entry point has a pure-numpy
// fallback, so this library is an accelerator, not a dependency. Host code,
// not a device kernel.
//
// Build: g++ -O3 -shared -fPIC (see native/build.py). Plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Argsort event rows by (k1[, k2], time, alive-first) — the order
// np.lexsort((~alive, times, k2, k1)) produces. At equal (key, time) dead
// rows sort last so a "last row of group" scan picks the tombstone
// (delete-wins tie-break of the temporal fold; Entity.scala:41-57 semantics).
// k2 may be null for single-key streams. order_out: int64[n].
void rtpu_sort_events(int64_t n, const int64_t* k1, const int64_t* k2,
                      const int64_t* times, const uint8_t* alive,
                      int64_t* order_out) {
    for (int64_t i = 0; i < n; ++i) order_out[i] = i;
    if (k2 != nullptr) {
        std::sort(order_out, order_out + n, [&](int64_t a, int64_t b) {
            if (k1[a] != k1[b]) return k1[a] < k1[b];
            if (k2[a] != k2[b]) return k2[a] < k2[b];
            if (times[a] != times[b]) return times[a] < times[b];
            return alive[a] > alive[b];
        });
    } else {
        std::sort(order_out, order_out + n, [&](int64_t a, int64_t b) {
            if (k1[a] != k1[b]) return k1[a] < k1[b];
            if (times[a] != times[b]) return times[a] < times[b];
            return alive[a] > alive[b];
        });
    }
}

// Fused group fold over rows already sorted by rtpu_sort_events: one output
// row per distinct key with (latest_time, latest_alive, first_time) — the
// whole _fold_latest in one pass. Returns the group count.
int64_t rtpu_fold_sorted(int64_t n, const int64_t* k1, const int64_t* k2,
                         const int64_t* times, const uint8_t* alive,
                         const int64_t* order,
                         int64_t* out_k1, int64_t* out_k2,
                         int64_t* out_latest_t, uint8_t* out_alive,
                         int64_t* out_first_t) {
    int64_t g = -1;
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = order[i];
        bool fresh = (g < 0) || k1[r] != out_k1[g] ||
                     (k2 != nullptr && k2[r] != out_k2[g]);
        if (fresh) {
            ++g;
            out_k1[g] = k1[r];
            if (k2 != nullptr) out_k2[g] = k2[r];
            out_first_t[g] = times[r];
        }
        out_latest_t[g] = times[r];
        out_alive[g] = alive[r];
    }
    return g + 1;
}

// Position of each (q1, q2) pair in key columns sorted lexicographically by
// (b1, b2); -1 when absent. Replaces the per-query Python loop in
// snapshot._lex_lookup (edge-property materialisation hot path).
void rtpu_lex_lookup2(int64_t nb, const int64_t* b1, const int64_t* b2,
                      int64_t nq, const int64_t* q1, const int64_t* q2,
                      int64_t* out) {
    for (int64_t i = 0; i < nq; ++i) {
        const int64_t* lo = std::lower_bound(b1, b1 + nb, q1[i]);
        const int64_t* hi = std::upper_bound(lo, b1 + nb, q1[i]);
        if (lo == hi) { out[i] = -1; continue; }
        int64_t l = lo - b1, h = hi - b1;
        const int64_t* p = std::lower_bound(b2 + l, b2 + h, q2[i]);
        out[i] = (p != b2 + h && *p == q2[i]) ? (p - b2) : -1;
    }
}

// Parallel batched lower/upper bound over a sorted u64 array — the per-hop
// engine-position lookup of packed pair keys (GlobalTables.eng_pos).
// side: 0 = left (lower_bound), 1 = right (upper_bound). out: int64[nq].
void rtpu_searchsorted_u64(int64_t nb, const uint64_t* base,
                           int64_t nq, const uint64_t* queries,
                           int32_t side, int64_t* out) {
    int nt = (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 32) nt = 32;
    if (nq < (1 << 14)) nt = 1;
    int64_t chunk = (nq + nt - 1) / nt;
    auto work = [&](int t) {
        int64_t lo = t * chunk, hi = std::min(nq, lo + chunk);
        for (int64_t i = lo; i < hi; ++i) {
            const uint64_t* p = side
                ? std::upper_bound(base, base + nb, queries[i])
                : std::lower_bound(base, base + nb, queries[i]);
            out[i] = (int64_t)(p - base);
        }
    };
    std::vector<std::thread> th;
    for (int t = 1; t < nt; ++t) th.emplace_back(work, t);
    work(0);
    for (auto& x : th) x.join();
}

}  // extern "C"

