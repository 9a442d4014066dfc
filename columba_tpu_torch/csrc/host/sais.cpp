// SA-IS suffix array construction (Nong, Zhang & Chan, 2009), clean-room
// implementation. Host-side native component of the index build (the
// role of libsais/divsufsort in the reference build,
// reference: src/buildindex.cpp:479-538). The port's own copy of the JAX
// package's sais.cpp.
//
// Exposed C ABI:
//   int sais_u8(const uint8_t* text, int64_t n, int64_t* sa)
//   int sais_u8_u32(const uint8_t* text, int64_t n, uint32_t* sa)
// Computes the suffix array of text[0..n) into sa. The text does NOT need an
// explicit sentinel; a virtual smallest sentinel at position n is assumed and
// is not part of the output (sa has n entries, a permutation of 0..n-1).
//
// Performance notes:
//   - the SA index type is templated: uint32 rows for n < 2^32-1 halve the
//     memory traffic of every induce pass vs the old int64-only kernel;
//   - suffix types live in a bitmap (n/8 bytes instead of n bytes), so the
//     random t[j-1] lookups during induction stay cache-resident far longer;
//   - induce loops software-prefetch the text/type bytes of entries a fixed
//     distance ahead — the passes are memory-latency-bound pointer chases.
// The index build additionally runs the fwd and rev directions on two
// threads.
//
// Build: g++ -O3 -shared -fPIC -o libsais_tpu.so sais.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#if defined(__linux__)
#include <sys/mman.h>
#endif

namespace {

typedef int64_t len_t;  // loop counters / sizes, always signed 64-bit

// The induce passes are TLB-bound at genome scale (random reads across a
// multi-GB working set); transparent huge pages on the big buffers are worth
// ~2x at 256 Mbp+ (this box runs THP in madvise mode). Pages must not have
// been faulted yet for the advice to take full effect — callers pass
// freshly-mapped numpy buffers.
void advise_huge(const void* p, size_t bytes) {
#if defined(__linux__) && defined(MADV_HUGEPAGE)
    const uintptr_t HP = 2u << 20;
    uintptr_t a = ((uintptr_t)p + HP - 1) & ~(HP - 1);
    uintptr_t end = ((uintptr_t)p + bytes) & ~(HP - 1);
    if (end > a) madvise((void*)a, end - a, MADV_HUGEPAGE);
#else
    (void)p;
    (void)bytes;
#endif
}

void advise_huge(const void* p, size_t bytes);

// malloc + MADV_HUGEPAGE *before* first touch (a zeroing constructor would
// fault the pages at 4K before the advice could apply).
template <typename T>
struct HugeBuf {
    T* p = nullptr;
    size_t n = 0;
    explicit HugeBuf(size_t count, bool zero = false) : n(count) {
        p = (T*)malloc(sizeof(T) * (count ? count : 1));
        if (!p) throw std::bad_alloc();  // caught at the extern "C" boundary
        advise_huge(p, sizeof(T) * count);
        if (zero) std::memset(p, 0, sizeof(T) * count);
    }
    ~HugeBuf() { free(p); }
    HugeBuf(const HugeBuf&) = delete;
    HugeBuf& operator=(const HugeBuf&) = delete;
    T* data() { return p; }
    inline T& operator[](size_t i) { return p[i]; }
    inline const T& operator[](size_t i) const { return p[i]; }
};

// Suffix-type bitmap: bit i set <=> suffix i is S-type.
struct TypeBits {
    HugeBuf<uint64_t> w;
    explicit TypeBits(len_t n) : w((size_t)((n >> 6) + 1), true) {}
    inline bool get(len_t i) const {
        return (w[(size_t)(i >> 6)] >> (i & 63)) & 1;
    }
    inline void set(len_t i) { w[(size_t)(i >> 6)] |= 1ull << (i & 63); }
};

#if defined(__GNUC__)
#define SAIS_PREFETCH(addr) __builtin_prefetch((addr), 0, 1)
#else
#define SAIS_PREFETCH(addr)
#endif

// Generic SA-IS over an integer string s[0..n) with alphabet size sigma.
// A virtual sentinel < all symbols is assumed at position n.
// I is the SA entry type (uint32_t or int64_t); EMPTY is the max I value.
template <typename S, typename I>
void sais(const S* s, len_t n, len_t sigma, I* sa) {
    if (n == 0) return;
    if (n == 1) { sa[0] = 0; return; }

    const I EMPTY = (I)~(I)0;
    const len_t PD = 32;  // prefetch distance (entries ahead)

    // --- classify: t.get(i) = true if suffix i is S-type ---
    TypeBits t(n);
    // t[n-1] = L-type (sentinel is smaller)
    {
        bool prev_s = false;  // type of suffix i+1
        S prev_c = s[n - 1];
        for (len_t i = n - 2; i >= 0; --i) {
            S c = s[i];
            bool cur = (c < prev_c) || (c == prev_c && prev_s);
            if (cur) t.set(i);
            prev_s = cur;
            prev_c = c;
        }
    }

    auto is_lms = [&](len_t i) -> bool {
        return i > 0 && t.get(i) && !t.get(i - 1);
    };

    // --- bucket sizes ---
    std::vector<len_t> bkt(sigma), bkt_start(sigma), bkt_end(sigma);
    for (len_t i = 0; i < n; ++i) bkt[(len_t)s[i]]++;
    auto reset_start = [&]() {
        len_t sum = 0;
        for (len_t c = 0; c < sigma; ++c) { bkt_start[c] = sum; sum += bkt[c]; }
    };
    auto reset_end = [&]() {
        len_t sum = 0;
        for (len_t c = 0; c < sigma; ++c) { sum += bkt[c]; bkt_end[c] = sum; }
    };

    // Induce L then S from whatever LMS placement sa currently holds.
    auto induce = [&]() {
        // L pass
        reset_start();
        sa[bkt_start[(len_t)s[n - 1]]++] = (I)(n - 1);
        for (len_t i = 0; i < n; ++i) {
            if (i + PD < n) {
                I jp = sa[i + PD];
                if (jp != EMPTY && jp > 0) {
                    SAIS_PREFETCH(&s[jp - 1]);
                    SAIS_PREFETCH(&t.w[(size_t)(((len_t)jp - 1) >> 6)]);
                }
            }
            I j = sa[i];
            if (j != EMPTY && j > 0 && !t.get((len_t)j - 1))
                sa[bkt_start[(len_t)s[j - 1]]++] = j - 1;
        }
        // S pass
        reset_end();
        for (len_t i = n - 1; i >= 0; --i) {
            if (i - PD >= 0) {
                I jp = sa[i - PD];
                if (jp != EMPTY && jp > 0) {
                    SAIS_PREFETCH(&s[jp - 1]);
                    SAIS_PREFETCH(&t.w[(size_t)(((len_t)jp - 1) >> 6)]);
                }
            }
            I j = sa[i];
            if (j != EMPTY && j > 0 && t.get((len_t)j - 1))
                sa[--bkt_end[(len_t)s[j - 1]]] = j - 1;
        }
    };

    // --- stage 1: sort LMS positions approximately, then induce ---
    std::memset(sa, 0xff, sizeof(I) * (size_t)n);  // EMPTY
    reset_end();
    for (len_t i = 1; i < n; ++i)
        if (is_lms(i)) sa[--bkt_end[(len_t)s[i]]] = (I)i;
    induce();

    // --- collect sorted LMS positions ---
    len_t n_lms = 0;
    for (len_t i = 0; i < n; ++i) {
        I v = sa[i];
        if (v != EMPTY && is_lms((len_t)v)) sa[n_lms++] = v;
    }

    // --- name LMS substrings ---
    // use sa[n_lms..n) as scratch for names indexed by position/2
    I* name_buf = sa + n_lms;
    len_t buf_len = n - n_lms;
    std::vector<I> name_vec;  // fallback only; LMS count is always <= n/2
    I* names;
    if (buf_len >= (n + 1) / 2) {
        names = name_buf;
        std::memset(names, 0xff, sizeof(I) * (size_t)buf_len);
    } else {
        name_vec.assign((size_t)((n + 1) / 2), EMPTY);
        names = name_vec.data();
    }

    len_t name_count = 0;
    len_t prev = -1;
    for (len_t r = 0; r < n_lms; ++r) {
        len_t pos = (len_t)sa[r];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            // compare LMS substrings at prev and pos
            for (len_t d = 0;; ++d) {
                len_t a = prev + d, b = pos + d;
                bool a_end = (a == n), b_end = (b == n);
                if (a_end || b_end) { diff = !(a_end && b_end); break; }
                if (s[a] != s[b] || t.get(a) != t.get(b)) { diff = true; break; }
                if (d > 0 && (is_lms(a) || is_lms(b))) {
                    diff = !(is_lms(a) && is_lms(b));
                    break;
                }
            }
        }
        if (diff) { ++name_count; prev = pos; }
        names[pos / 2] = (I)(name_count - 1);
    }

    // --- build reduced string in LMS order of appearance ---
    HugeBuf<I> s1((size_t)n_lms), lms_pos((size_t)n_lms);
    {
        len_t j = 0;
        for (len_t i = 1; i < n; ++i)
            if (is_lms(i)) lms_pos[(size_t)j++] = (I)i;
        for (len_t i = 0; i < n_lms; ++i)
            s1[(size_t)i] = names[(len_t)lms_pos[(size_t)i] / 2];
    }
    name_vec.clear();
    name_vec.shrink_to_fit();

    // --- recurse or directly derive LMS order ---
    HugeBuf<I> sa1((size_t)n_lms);
    if (name_count < n_lms) {
        sais<I, I>(s1.data(), n_lms, name_count, sa1.data());
    } else {
        for (len_t i = 0; i < n_lms; ++i) sa1[(size_t)s1[(size_t)i]] = (I)i;
    }

    // --- stage 2: place LMS suffixes in true order, induce final SA ---
    std::memset(sa, 0xff, sizeof(I) * (size_t)n);
    reset_end();
    for (len_t r = n_lms - 1; r >= 0; --r) {
        I pos = lms_pos[(size_t)sa1[(size_t)r]];
        sa[--bkt_end[(len_t)s[pos]]] = pos;
    }
    induce();
}

}  // namespace

extern "C" {

// Copy the caller's text into a huge-page-backed buffer: the caller's numpy
// pages are long since faulted at 4K, and the induce passes' random reads of
// s[] are the dominant TLB pressure.
struct TextCopy {
    HugeBuf<uint8_t> buf;
    const uint8_t* p;
    TextCopy(const uint8_t* text, int64_t n) : buf((size_t)(n ? n : 1)) {
        std::memcpy(buf.data(), text, (size_t)n);
        p = buf.data();
    }
};

int sais_u8_u32(const uint8_t* text, int64_t n, uint32_t* sa) {
    if (n < 0 || n >= (int64_t)0xFFFFFFFFll ||
        (n > 0 && (text == nullptr || sa == nullptr)))
        return -1;
    try {
        advise_huge(sa, (size_t)n * 4);
        TextCopy tc(text, n);
        sais<uint8_t, uint32_t>(tc.p, n, 256, sa);
    } catch (const std::bad_alloc&) {
        return -2;  // Python falls back (suffix.py treats rc != 0 as miss)
    }
    return 0;
}

int sais_u8(const uint8_t* text, int64_t n, int64_t* sa) {
    if (n < 0 || (n > 0 && (text == nullptr || sa == nullptr))) return -1;
    try {
        TextCopy tc(text, n);
        if (n < (int64_t)0xFFFFFFFFll) {
            // 32-bit kernel (half the induce-pass memory traffic), widen once.
            HugeBuf<uint32_t> tmp((size_t)n);
            sais<uint8_t, uint32_t>(tc.p, n, 256, tmp.data());
            for (int64_t i = 0; i < n; ++i) sa[i] = (int64_t)tmp[(size_t)i];
        } else {
            advise_huge(sa, (size_t)n * 8);
            sais<uint8_t, int64_t>(tc.p, n, 256, sa);
        }
    } catch (const std::bad_alloc&) {
        return -2;
    }
    return 0;
}

}  // extern "C"
