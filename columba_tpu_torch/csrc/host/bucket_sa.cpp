// Parallel suffix sorting by prefix buckets, for texts whose repeats are
// short. Host-side native component of the index build, beside SA-IS
// (sais.cpp), which runs on one thread: on a random 3.1 Gbp genome SA-IS
// takes most of `cli build`'s time, and this sort spreads the work over
// every core. The JAX package has no counterpart (its build runs SA-IS).
//
// Exposed C ABI:
//   int bucket_sa_u32(const uint8_t* text, int64_t n, uint32_t* sa,
//                     int threads, int64_t max_depth)
// Computes the suffix array of text[0..n) (codes 0..3, a virtual smallest
// sentinel at n) into sa, the same array sais_u8_u32 gives (a suffix array
// is unique). Returns 0, or 1 when two suffixes share a prefix longer than
// max_depth: the caller then runs SA-IS, whose time does not depend on the
// repeats. Negative on bad arguments or a failed allocation.
//
// Steps, each split over `threads` threads:
//   1. pack the text 2 bits a base, most significant first, so the 32
//      bases at any position are one 64-bit key (bases past n read as 0);
//   2. count the suffixes of each prefix bucket per text slice, and
//      scatter the positions into their buckets;
//   3. sort each bucket by the next 32 bases, then sort each run of equal
//      keys by comparing 32 bases at a time, a suffix that ends first
//      (the shorter one) first on a tie.
// The bucket key has up to 12 bases, about 64 suffixes a bucket. For random
// text two suffixes rarely share 44 bases, so the work is two passes over
// the text, one random read of the packed text a suffix and a small sort a
// bucket; the memory is the SA, the packed text (n / 4 bytes) and a count
// array a text slice (4 B a bucket). Steps 1 and 3 use `threads` threads;
// step 2 cuts the text into at most kMaxSlices slices, so that its counts
// (at most 8 x 4^12 x 4 B = 0.54 GB) do not grow with the core count.
//
// Also exposed:
//   int64_t bwt_u32(const uint8_t* text, int64_t n, const uint32_t* sa,
//                   uint8_t* bwt, int threads)
// The BWT of text + '$' from its suffix array, in rows (n + 1 of them,
// the '$' row first): bwt[0] = text[n - 1], bwt[i + 1] = text[sa[i] - 1],
// with the '$' slot (the row of sa[i] == 0) stored as code 0. Returns that
// row. A random gather of n bytes, split over `threads` threads.
//
// Built with sais.cpp into one library (native.load).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <system_error>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kMaxPrefix = 12;  // bases of a bucket key at genome scale
constexpr int kMaxSlices = 8;   // count arrays of step 2

struct Packed {
    std::vector<uint64_t> w;  // 32 bases a word, first base in bits 63..62
    int64_t n;

    // bases [i, i + 32) as a key; bases past n are 0
    inline uint64_t key(int64_t i) const {
        const int64_t q = i >> 5;
        const int s = static_cast<int>(i & 31) * 2;
        const uint64_t hi = w[static_cast<size_t>(q)];
        if (s == 0) return hi;
        return (hi << s) | (w[static_cast<size_t>(q) + 1] >> (64 - s));
    }
};

template <typename F>
void parallel_for(int threads, int64_t count, F&& fn) {
    // fn(t, lo, hi) on `threads` contiguous slices of [0, count)
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
        const int64_t lo = count * t / threads, hi = count * (t + 1) / threads;
        pool.emplace_back([&fn, t, lo, hi] { fn(t, lo, hi); });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" int bucket_sa_u32(const uint8_t* text, int64_t n, uint32_t* sa,
                             int threads, int64_t max_depth) {
    if (n < 0 || n >= (int64_t)0xFFFFFFFFll || threads < 1 ||
        (n > 0 && (text == nullptr || sa == nullptr)))
        return -1;
    if (n == 0) return 0;
    try {
        Packed P;
        P.n = n;
        const int64_t words = (n >> 5) + 4;  // keys read up to 3 words past n
        P.w.assign(static_cast<size_t>(words), 0);
        parallel_for(threads, words, [&](int, int64_t lo, int64_t hi) {
            for (int64_t q = lo; q < hi; ++q) {
                uint64_t v = 0;
                const int64_t b = q << 5;
                for (int j = 0; j < 32; ++j) {
                    const int64_t i = b + j;
                    const uint64_t c = i < n ? (text[i] & 3u) : 0u;
                    v |= c << (62 - 2 * j);
                }
                P.w[static_cast<size_t>(q)] = v;
            }
        });

        // about 64 suffixes a bucket, at most 4^12 buckets
        int prefix = 1;
        while (prefix < kMaxPrefix && (n >> (2 * prefix + 6)) > 0) ++prefix;
        const int64_t buckets = int64_t(1) << (2 * prefix);
        // bucket counts per slice
        const int slices = std::min(threads, kMaxSlices);
        std::vector<std::vector<uint32_t>> cnt(
            static_cast<size_t>(slices),
            std::vector<uint32_t>(static_cast<size_t>(buckets), 0u));
        const int shift = 64 - 2 * prefix;
        parallel_for(slices, n, [&](int t, int64_t lo, int64_t hi) {
            uint32_t* c = cnt[static_cast<size_t>(t)].data();
            for (int64_t i = lo; i < hi; ++i) ++c[P.key(i) >> shift];
        });
        std::vector<int64_t> start(static_cast<size_t>(buckets) + 1);
        {
            int64_t sum = 0;
            for (int64_t b = 0; b < buckets; ++b) {
                start[static_cast<size_t>(b)] = sum;
                for (int t = 0; t < slices; ++t) {
                    const uint32_t k = cnt[static_cast<size_t>(t)]
                                          [static_cast<size_t>(b)];
                    cnt[static_cast<size_t>(t)][static_cast<size_t>(b)] =
                        static_cast<uint32_t>(sum - start[static_cast<size_t>(b)]);
                    sum += k;
                }
            }
            start[static_cast<size_t>(buckets)] = sum;
        }
        parallel_for(slices, n, [&](int t, int64_t lo, int64_t hi) {
            uint32_t* c = cnt[static_cast<size_t>(t)].data();
            for (int64_t i = lo; i < hi; ++i) {
                const int64_t b = static_cast<int64_t>(P.key(i) >> shift);
                sa[start[static_cast<size_t>(b)] + c[b]++] =
                    static_cast<uint32_t>(i);
            }
        });
        cnt.clear();
        cnt.shrink_to_fit();

        // sort the buckets, handed out in chunks
        std::atomic<int64_t> next{0};
        std::atomic<int> too_deep{0};
        constexpr int64_t kChunk = 4096;
        auto suffix_less = [&](uint32_t a, uint32_t b) -> bool {
            for (int64_t d = prefix + 32;; d += 32) {
                const uint64_t ka = P.key(a + d), kb = P.key(b + d);
                if (ka != kb) return ka < kb;
                // equal so far: a suffix that ended in this window is the
                // shorter one and a prefix of the other
                if (static_cast<int64_t>(std::max(a, b)) + d + 32 > n)
                    return a > b;
                if (d > max_depth) {
                    too_deep.store(1, std::memory_order_relaxed);
                    return a < b;
                }
            }
        };
        parallel_for(threads, threads, [&](int, int64_t, int64_t) {
            std::vector<std::pair<uint64_t, uint32_t>> tmp;
            while (!too_deep.load(std::memory_order_relaxed)) {
                const int64_t b0 = next.fetch_add(kChunk);
                if (b0 >= buckets) break;
                const int64_t b1 = std::min(b0 + kChunk, buckets);
                for (int64_t b = b0; b < b1; ++b) {
                    const int64_t lo = start[static_cast<size_t>(b)];
                    const int64_t hi = start[static_cast<size_t>(b) + 1];
                    if (hi - lo < 2) continue;
                    tmp.resize(static_cast<size_t>(hi - lo));
                    for (int64_t j = lo; j < hi; ++j)
                        tmp[static_cast<size_t>(j - lo)] = {
                            P.key(sa[j] + prefix), sa[j]};
                    std::sort(tmp.begin(), tmp.end(),
                              [](const auto& x, const auto& y) {
                                  return x.first < y.first;
                              });
                    size_t r = 0;
                    while (r < tmp.size()) {
                        size_t e = r + 1;
                        while (e < tmp.size() && tmp[e].first == tmp[r].first)
                            ++e;
                        if (e - r > 1) {
                            // a suffix with fewer than 44 bases left can be
                            // in a tie: the comparison handles its end
                            std::sort(tmp.begin() + r, tmp.begin() + e,
                                      [&](const auto& x, const auto& y) {
                                          return suffix_less(x.second,
                                                             y.second);
                                      });
                        }
                        r = e;
                    }
                    for (int64_t j = lo; j < hi; ++j)
                        sa[j] = tmp[static_cast<size_t>(j - lo)].second;
                }
            }
        });
        return too_deep.load() ? 1 : 0;
    } catch (const std::bad_alloc&) {
        return -2;
    } catch (const std::system_error&) {
        return -3;
    }
}

extern "C" int64_t bwt_u32(const uint8_t* text, int64_t n, const uint32_t* sa,
                           uint8_t* bwt, int threads) {
    if (n < 1 || threads < 1 || text == nullptr || sa == nullptr ||
        bwt == nullptr)
        return -1;
    std::atomic<int64_t> dollar{-1};
    try {
        parallel_for(threads, n, [&](int, int64_t lo, int64_t hi) {
            for (int64_t i = lo; i < hi; ++i) {
                const uint32_t p = sa[i];
                if (p == 0) {
                    dollar.store(i + 1);
                    bwt[i + 1] = 0;
                } else {
                    bwt[i + 1] = text[p - 1];
                }
            }
        });
    } catch (const std::system_error&) {
        return -3;
    }
    bwt[0] = text[n - 1];
    return dollar.load();
}
