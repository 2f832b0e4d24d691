// raphtory_tpu_torch native host kernels.
//
// Host hot loops around the device compute path: the snapshot builder's
// event sorts and fused latest-state fold, the sorted two-column join used by
// property materialisation, the parallel batched searchsorted behind the
// per-hop engine-position lookup, and the bulk loader's stable radix
// argsort. Loaded from Python via ctypes (`raphtory_tpu_torch/native/lib.py`);
// every entry point has a pure-numpy fallback, so this library is an
// accelerator, not a dependency. Host code, not a device kernel.
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

// Parallel stable LSD radix argsort of uint64 keys. The bulk-load hot sort:
// 100M keys in seconds where std::sort takes minutes. Stability preserves
// the caller's time order within equal keys (the (pair, time) trick the
// bulk loader relies on). order_out: int64[n].

void rtpu_radix_argsort_u64(int64_t n, const uint64_t* keys,
                            int64_t* order_out) {
    const int PASSES = 8, BUCKETS = 256;
    int nt = (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 32) nt = 32;
    if (n < (1 << 16)) nt = 1;

    std::vector<uint64_t> kbuf(n);
    std::vector<int64_t> obuf(n);
    std::vector<uint64_t> kbuf2(n);
    std::vector<int64_t> obuf2(n);
    for (int64_t i = 0; i < n; ++i) { kbuf[i] = keys[i]; obuf[i] = i; }

    uint64_t* ks = kbuf.data(); int64_t* os = obuf.data();
    uint64_t* kd = kbuf2.data(); int64_t* od = obuf2.data();

    std::vector<int64_t> hist((size_t)nt * BUCKETS);
    int64_t chunk = (n + nt - 1) / nt;

    for (int pass = 0; pass < PASSES; ++pass) {
        int shift = pass * 8;
        // skip passes whose byte is constant (common: high bytes of ids)
        std::fill(hist.begin(), hist.end(), 0);
        auto count = [&](int t) {
            int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
            int64_t* h = &hist[(size_t)t * BUCKETS];
            for (int64_t i = lo; i < hi; ++i)
                ++h[(ks[i] >> shift) & 0xff];
        };
        {
            std::vector<std::thread> th;
            for (int t = 1; t < nt; ++t) th.emplace_back(count, t);
            count(0);
            for (auto& x : th) x.join();
        }
        int nonzero = 0; int64_t first_total = 0;
        for (int b = 0; b < BUCKETS && nonzero <= 1; ++b) {
            int64_t tot = 0;
            for (int t = 0; t < nt; ++t) tot += hist[(size_t)t * BUCKETS + b];
            if (tot) { ++nonzero; first_total = tot; }
        }
        if (nonzero <= 1 && first_total == n) continue;  // constant byte
        // exclusive prefix, bucket-major then thread order (stability)
        int64_t run = 0;
        for (int b = 0; b < BUCKETS; ++b) {
            for (int t = 0; t < nt; ++t) {
                int64_t c = hist[(size_t)t * BUCKETS + b];
                hist[(size_t)t * BUCKETS + b] = run;
                run += c;
            }
        }
        auto scatter = [&](int t) {
            int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
            int64_t* h = &hist[(size_t)t * BUCKETS];
            for (int64_t i = lo; i < hi; ++i) {
                int64_t p = h[(ks[i] >> shift) & 0xff]++;
                kd[p] = ks[i]; od[p] = os[i];
            }
        };
        {
            std::vector<std::thread> th;
            for (int t = 1; t < nt; ++t) th.emplace_back(scatter, t);
            scatter(0);
            for (auto& x : th) x.join();
        }
        std::swap(ks, kd); std::swap(os, od);
    }
    std::memcpy(order_out, os, (size_t)n * sizeof(int64_t));
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

