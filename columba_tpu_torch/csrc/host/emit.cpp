// Native SE SAM emission: banded traceback DP + CIGAR + line formatting.
//
// The host-side throughput engine of the aligner (the analogue of the
// reference's per-worker SAM generation, src/indexhelpers.cpp:56-260 +
// src/searchstrategy.cpp:1824-1902): takes the batch's occurrences as
// struct-of-arrays grouped per read, runs the traceback per occurrence
// against the decoded text, applies the final redundancy filter
// (src/indexinterface.cpp:1451-1485) and writes complete SAM records.
//
// Exposed via ctypes (emit.py); calls release the GIL so emission worker
// threads run truly parallel with device dispatch. Internally threads over
// contiguous read ranges (one output buffer per thread, concatenated at
// the end so output order is deterministic).
//
// The port's own copy of the JAX package's emit.cpp. Parity contract:
// byte-identical output to that package's pure-Python path (io/sam.py
// traceback + search/strategy.py emit_sam), which its
// tests/test_emit_native.py fuzzes; the port's CLI tests compare the SAM
// records of the two packages.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int MAX_MAPQ = 60;
constexpr int16_t INF = 0x3fff;

inline int mapq_of(int64_t n_best) {
  if (n_best <= 1) return MAX_MAPQ;
  double v = -10.0 * std::log10(1.0 - 1.0 / (double)n_best);
  // Python int(round(v)): round-half-even
  double r = std::nearbyint(v);
  int iv = (int)r;
  return iv < MAX_MAPQ ? iv : MAX_MAPQ;
}

inline void append_int(std::string& s, int64_t v) {
  char buf[24];
  int n = std::snprintf(buf, sizeof buf, "%lld", (long long)v);
  s.append(buf, n);
}

// One traceback result.
struct TB {
  int64_t begin;     // absolute text begin
  int32_t ed;
  std::string cigar; // run-length encoded ops
};

// Scratch buffers reused across occurrences within a thread.
struct Scratch {
  std::vector<int16_t> D;     // full DP (m+1)*(t+1), fallback path
  std::vector<int16_t> band;  // banded DP (m+1) rows * bandw cols
  std::vector<int8_t> ops;    // walk ops (reverse order)
  std::string cig;
};

// Full DP + walk, mirroring sam.traceback() exactly. text points at the
// window (length t), pat at the pattern (length m). Free-start row,
// pattern fully consumed, end at column t. Tie order on the backward
// walk: insertion, then diagonal, then deletion.
void traceback_full(const uint8_t* pat, int m, const uint8_t* text, int t,
                    Scratch& sc, TB& out) {
  const int W = t + 1;
  sc.D.resize((size_t)(m + 1) * W);
  int16_t* D = sc.D.data();
  for (int c = 0; c <= t; ++c) D[c] = 0;
  for (int j = 1; j <= m; ++j) {
    int16_t* row = D + (size_t)j * W;
    const int16_t* prev = row - W;
    row[0] = (int16_t)j;
    const uint8_t pj = pat[j - 1];
    for (int c = 1; c <= t; ++c) {
      const uint8_t tc = text[c - 1];
      int16_t mis = (tc != pj || pj > 3 || tc > 3) ? 1 : 0;
      int16_t best = (int16_t)std::min<int>(prev[c - 1] + mis, prev[c] + 1);
      best = (int16_t)std::min<int>(best, row[c - 1] + 1);
      row[c] = best;
    }
  }
  out.ed = D[(size_t)m * W + t];
  // backward walk
  sc.ops.clear();
  int j = m, c = t;
  while (j > 0) {
    const int16_t cur = D[(size_t)j * W + c];
    if (D[(size_t)(j - 1) * W + c] + 1 == cur) {
      sc.ops.push_back(1);  // I
      --j;
    } else {
      const uint8_t pj = pat[j - 1];
      const uint8_t tc = c > 0 ? text[c - 1] : 255;
      int16_t mis = (tc != pj || pj > 3 || tc > 3) ? 1 : 0;
      if (c > 0 && D[(size_t)(j - 1) * W + (c - 1)] + mis == cur) {
        sc.ops.push_back(2);  // M
        --j; --c;
      } else {
        sc.ops.push_back(3);  // D
        --c;
      }
    }
  }
  out.begin = c;  // caller adds the window's absolute offset
}

// Banded DP + walk: half-width HW around the end diagonal c = j + (t - m).
// Exact when the final distance <= kb (every walk cell / probe cell then
// has a witness optimal path inside half-width kb; probes reach kb+1).
// Falls back to the full DP when the banded result exceeds kb.
bool traceback_banded(const uint8_t* pat, int m, const uint8_t* text, int t,
                      int kb, Scratch& sc, TB& out) {
  const int HW = kb + 2;
  const int BW = 2 * HW + 1;               // columns per row
  sc.band.resize((size_t)(m + 1) * BW);
  int16_t* B = sc.band.data();
  const int diag0 = t - m;                  // row j's center column j+diag0
  // row 0: center diag0; in-text columns get 0, others INF
  for (int o = 0; o < BW; ++o) {
    int c = diag0 + (o - HW);
    B[o] = (c >= 0 && c <= t) ? 0 : INF;
  }
  for (int j = 1; j <= m; ++j) {
    int16_t* row = B + (size_t)j * BW;
    const int16_t* prev = row - BW;
    const uint8_t pj = pat[j - 1];
    const int center = j + diag0;
    for (int o = 0; o < BW; ++o) {
      const int c = center + (o - HW);
      if (c < 0 || c > t) { row[o] = INF; continue; }
      if (c == 0) { row[o] = (int16_t)j; continue; }
      const uint8_t tc = text[c - 1];
      int16_t mis = (tc != pj || pj > 3 || tc > 3) ? 1 : 0;
      // prev row center is (j-1)+diag0 = center-1: column c is at offset
      // o+1 in the prev row; c-1 at offset o.
      int16_t v = INF;
      if (prev[o] < INF) v = (int16_t)(prev[o] + mis);            // diag
      if (o + 1 < BW && prev[o + 1] + 1 < v) v = (int16_t)(prev[o + 1] + 1);  // up (I)
      if (o > 0 && row[o - 1] + 1 < v) v = (int16_t)(row[o - 1] + 1);          // left (D)
      row[o] = v;
    }
  }
  const int16_t ed = B[(size_t)m * BW + HW];  // (m, t) is at offset HW
  if (ed > kb) return false;                  // outside guarantee: full DP
  out.ed = ed;
  sc.ops.clear();
  int j = m, c = t;
  while (j > 0) {
    const int center = j + diag0;
    const int o = c - center + HW;
    const int16_t cur = B[(size_t)j * BW + o];
    // prev row: column c at offset o+1, c-1 at offset o
    const int16_t up = (o + 1 < BW) ? B[(size_t)(j - 1) * BW + (o + 1)] : INF;
    if (up + 1 == cur) {
      sc.ops.push_back(1);
      --j;
    } else {
      const uint8_t pj = pat[j - 1];
      const uint8_t tc = c > 0 ? text[c - 1] : 255;
      int16_t mis = (tc != pj || pj > 3 || tc > 3) ? 1 : 0;
      const int16_t dg = B[(size_t)(j - 1) * BW + o];
      if (c > 0 && dg + mis == cur) {
        sc.ops.push_back(2);
        --j; --c;
      } else {
        sc.ops.push_back(3);
        --c;
      }
    }
  }
  out.begin = c;
  return true;
}

// CIGAR from sc.ops (reverse order) into out.cigar.
void rle_cigar(Scratch& sc, TB& out) {
  static const char OPC[4] = {'?', 'I', 'M', 'D'};
  out.cigar.clear();
  const auto& ops = sc.ops;
  int n = (int)ops.size();
  int i = n - 1;
  while (i >= 0) {
    int j = i;
    while (j >= 0 && ops[j] == ops[i]) --j;
    append_int(out.cigar, i - j);
    out.cigar.push_back(OPC[ops[i]]);
    i = j;
  }
}

// traceback of one occurrence; window = text[w_lo, end). Mirrors
// sam.traceback / sam.traceback_batch (incl. the exact-diagonal shortcut
// and the kb==0 hamming path).
void run_traceback(const uint8_t* pat, int m, const uint8_t* text,
                   int64_t w_lo, int64_t end, int kb, Scratch& sc, TB& out) {
  const int t = (int)(end - w_lo);
  const uint8_t* win = text + w_lo;
  if (kb == 0) {
    out.begin = w_lo + (t - m);
    out.ed = 0;
    for (int i = 0; i < m; ++i) out.ed += (win[t - m + i] != pat[i]) ? 1 : 0;
    out.cigar.clear();
    append_int(out.cigar, m);
    out.cigar.push_back('M');
    return;
  }
  // exact-diagonal shortcut (sam.traceback_batch): last m window chars
  // match the pattern exactly (codes <= 3)
  if (t >= m) {
    bool exact = true;
    for (int i = 0; i < m; ++i) {
      if (win[t - m + i] != pat[i] || pat[i] > 3) { exact = false; break; }
    }
    if (exact) {
      out.begin = w_lo + (t - m);
      out.ed = 0;
      out.cigar.clear();
      append_int(out.cigar, m);
      out.cigar.push_back('M');
      return;
    }
  }
  if (!traceback_banded(pat, m, win, t, kb, sc, out))
    traceback_full(pat, m, win, t, sc, out);
  out.begin += w_lo;
  rle_cigar(sc, out);
}

struct Finalized {
  int64_t begin;
  int64_t end;       // occurrence end (width = end - begin)
  int32_t ed;
  int32_t strand;
  int64_t pos1;
  int32_t sidx;
  std::string cigar;
  int32_t order;     // original emission order (stable-sort key backup)
};

struct Ctx {
  const uint8_t* codes; int32_t n_reads; int32_t m;
  const char* names; const int64_t* name_offs;
  const char* quals; const int64_t* qual_offs;
  const int64_t* occ_off;
  const int64_t* occ_end; const int32_t* occ_dist; const uint8_t* occ_strand;
  const int32_t* nbest_pre;
  const uint8_t* text; int64_t text_n;
  const int64_t* seq_starts; int32_t n_seqs;
  const char* seqnames; const int64_t* seqname_offs;
  int32_t kb;
  int32_t xa; int32_t unmapped; int32_t with_cigar;
};

inline int32_t seq_index(const Ctx& cx, int64_t pos) {
  // searchsorted(starts, pos, 'right') - 1, clamped to [0, n_seqs-1]
  const int64_t* s = cx.seq_starts;
  int32_t lo = 0, hi = cx.n_seqs + 1;  // starts has n_seqs+1 entries
  while (lo < hi) {
    int32_t mid = (lo + hi) / 2;
    if (s[mid] <= pos) lo = mid + 1; else hi = mid;
  }
  int32_t idx = lo - 1;
  if (idx < 0) idx = 0;
  if (idx > cx.n_seqs - 1) idx = cx.n_seqs - 1;
  return idx;
}

void append_seq(std::string& out, const uint8_t* pat, int m) {
  static const char C2C[6] = {'A', 'C', 'G', 'T', 'N', 'N'};
  size_t base = out.size();
  out.resize(base + m);
  for (int i = 0; i < m; ++i) out[base + i] = C2C[pat[i] > 4 ? 4 : pat[i]];
}

void emit_range(const Ctx& cx, int32_t r0, int32_t r1, std::string& out,
                int64_t* cigars_done) {
  const int m = cx.m;
  Scratch sc;
  std::vector<uint8_t> pat_rc(m);
  std::vector<Finalized> fin;
  std::vector<TB> tbs;
  int64_t n_cigars = 0;
  std::string qual_rev;
  for (int32_t r = r0; r < r1; ++r) {
    const int64_t o0 = cx.occ_off[r], o1 = cx.occ_off[r + 1];
    const char* name = cx.names + cx.name_offs[r];
    const int name_len = (int)(cx.name_offs[r + 1] - cx.name_offs[r]);
    const char* qual = cx.quals + cx.qual_offs[r];
    const int qual_len = (int)(cx.qual_offs[r + 1] - cx.qual_offs[r]);
    const uint8_t* fwd = cx.codes + (size_t)r * m;
    if (o0 == o1) {
      if (cx.unmapped) {
        // qname\t4\t*\t0\t0\t*\t*\t0\t0\tseq\tqual\tPG:Z:Columba\n
        out.append(name, name_len);
        out.append("\t4\t*\t0\t0\t*\t*\t0\t0\t");
        append_seq(out, fwd, m);
        out.push_back('\t');
        out.append(qual, qual_len);
        out.append("\tPG:Z:Columba\n");
      }
      continue;
    }
    bool have_rc = false;
    fin.clear();
    tbs.resize(o1 - o0);
    for (int64_t oi = o0; oi < o1; ++oi) {
      const int strand = cx.occ_strand[oi];
      const uint8_t* pat = fwd;
      if (strand) {
        if (!have_rc) {
          for (int i = 0; i < m; ++i) {
            uint8_t c = fwd[m - 1 - i];
            pat_rc[i] = c < 4 ? (uint8_t)(3 - c) : c;  // N -> N
          }
          have_rc = true;
        }
        pat = pat_rc.data();
      }
      const int64_t end = cx.occ_end[oi];
      const int64_t s_lo = cx.seq_starts[seq_index(cx, end - 1)];
      int64_t w_lo = end - m - cx.kb;
      if (s_lo > w_lo) w_lo = s_lo;
      TB& tb = tbs[oi - o0];
      run_traceback(pat, m, cx.text, w_lo, end, cx.kb, sc, tb);
      ++n_cigars;
      Finalized f;
      f.begin = tb.begin;
      f.end = end;
      f.ed = tb.ed;
      f.strand = strand;
      f.sidx = seq_index(cx, tb.begin);
      f.pos1 = tb.begin - cx.seq_starts[f.sidx] + 1;
      f.cigar = std::move(tb.cigar);
      f.order = (int32_t)(oi - o0);
      fin.push_back(std::move(f));
    }
    // final redundancy filter (strategy._final_redundancy_filter): per
    // strand group sorted by (begin, ed, width); same begin -> keep first;
    // begins within 2*kb -> keep the strictly better one.
    std::vector<Finalized> kept;
    kept.reserve(fin.size());
    for (int strand = 0; strand < 2; ++strand) {
      std::vector<Finalized*> group;
      for (auto& f : fin)
        if (f.strand == strand) group.push_back(&f);
      std::stable_sort(group.begin(), group.end(),
                       [](const Finalized* a, const Finalized* b) {
                         if (a->begin != b->begin) return a->begin < b->begin;
                         if (a->ed != b->ed) return a->ed < b->ed;
                         return (a->end - a->begin) < (b->end - b->begin);
                       });
      std::vector<Finalized*> g_kept;
      int64_t prev_begin = 0, prev_w = 0;
      int32_t prev_ed = 0;
      for (auto* f : group) {
        const int64_t begin = f->begin, width = f->end - f->begin;
        const int32_t ed = f->ed;
        if (!g_kept.empty()) {
          int64_t diff = begin >= prev_begin ? begin - prev_begin
                                             : prev_begin - begin;
          if (diff == 0) continue;
          if (diff <= 2 * (int64_t)cx.kb) {
            if (ed > prev_ed || (ed == prev_ed && width >= prev_w)) continue;
            g_kept.pop_back();
          }
        }
        prev_begin = begin; prev_ed = ed; prev_w = width;
        g_kept.push_back(f);
      }
      for (auto* f : g_kept) kept.push_back(std::move(*f));
    }
    // primary order: (ed, begin, strand), stable
    std::stable_sort(kept.begin(), kept.end(),
                     [](const Finalized& a, const Finalized& b) {
                       if (a.ed != b.ed) return a.ed < b.ed;
                       if (a.begin != b.begin) return a.begin < b.begin;
                       return a.strand < b.strand;
                     });
    int32_t best_ed = kept.empty() ? 0 : kept[0].ed;
    int64_t n_best = 0;
    for (auto& f : kept) n_best += (f.ed == best_ed);
    const int mq = mapq_of(n_best < 1 ? 1 : n_best);
    auto emit_line = [&](const Finalized& f, int flag, int field_mq,
                         bool newline) {
      out.append(name, name_len);
      out.push_back('\t');
      append_int(out, flag);
      out.push_back('\t');
      out.append(cx.seqnames + cx.seqname_offs[f.sidx],
                 cx.seqname_offs[f.sidx + 1] - cx.seqname_offs[f.sidx]);
      out.push_back('\t');
      append_int(out, f.pos1);
      out.push_back('\t');
      append_int(out, field_mq);
      out.push_back('\t');
      if (cx.with_cigar) out.append(f.cigar);
      else out.push_back('*');
      out.append("\t*\t0\t0\t");
      append_seq(out, f.strand ? pat_rc.data() : fwd, m);
      out.push_back('\t');
      if (f.strand) {
        qual_rev.assign(qual, qual_len);
        std::reverse(qual_rev.begin(), qual_rev.end());
        out.append(qual_rev);
      } else {
        out.append(qual, qual_len);
      }
      out.append("\tAS:i:");
      append_int(out, f.ed);
      out.append("\tNM:i:");
      append_int(out, f.ed);
      out.append("\tPG:Z:Columba");
      if (newline) out.push_back('\n');
    };
    if (cx.xa) {
      const Finalized& f = kept[0];
      // pat_rc may have been clobbered? no: pat_rc persists for the read
      if (f.strand && !have_rc) { /* unreachable: strand implies have_rc */ }
      emit_line(f, f.strand ? 16 : 0, mq, false);
      if (kept.size() > 1) {
        out.append("\tX0:i:");
        append_int(out, cx.nbest_pre ? cx.nbest_pre[r] : n_best);
        out.append("\tX1:i:");
        append_int(out, (int64_t)kept.size() -
                            (cx.nbest_pre ? cx.nbest_pre[r] : n_best));
        out.append("\tXA:Z:");
        for (size_t i = 1; i < kept.size(); ++i) {
          const Finalized& g = kept[i];
          out.append(cx.seqnames + cx.seqname_offs[g.sidx],
                     cx.seqname_offs[g.sidx + 1] - cx.seqname_offs[g.sidx]);
          out.push_back(',');
          out.push_back(g.strand ? '-' : '+');
          append_int(out, g.pos1);
          out.push_back(',');
          if (cx.with_cigar) out.append(g.cigar);
          else out.push_back('*');
          out.push_back(',');
          append_int(out, g.ed);
          out.push_back(';');
        }
      }
      out.push_back('\n');
    } else {
      for (size_t i = 0; i < kept.size(); ++i) {
        const Finalized& f = kept[i];
        int flag = (f.strand ? 16 : 0) | (i > 0 ? 256 : 0);
        emit_line(f, flag, f.ed == best_ed ? mq : 0, true);
      }
    }
  }
  *cigars_done = n_cigars;
}

// ------------------------- paired-end emission -------------------------
//
// PE SAM records (the analogue of the reference's per-worker PE output,
// src/searchstrategy.cpp:1904-1980 + src/indexhelpers.cpp:56-260): the
// caller ships candidate pairs as struct-of-arrays already in emission
// order (sorted per read by (total_distance, upstream begin), truncated
// to 100) plus per-read unpaired/unmapped fallbacks; this side runs the
// tracebacks (deduped per read-side) and formats both mates' lines.
// Parity contract: byte-identical to paired.emit_sam_paired (fuzzed by
// tests/test_emit_native.py).

struct PECtx {
  // read codes as flat buffers + absolute per-record offsets (parser
  // chunk buffers pass through unsliced; a (R, m) matrix is the special
  // case offs[r] = r*m)
  const uint8_t* codes1; const int64_t* seq_offs1; int32_t n_reads; int32_t m1;
  const uint8_t* codes2; const int64_t* seq_offs2; int32_t m2;
  const char* names1; const int64_t* name1_offs;
  const char* quals1; const int64_t* qual1_offs;
  const char* names2; const int64_t* name2_offs;
  const char* quals2; const int64_t* qual2_offs;
  const int64_t* pair_off;
  const int64_t* p_end1; const uint8_t* p_strand1;
  const int64_t* p_end2; const uint8_t* p_strand2;
  const int64_t* p_tlen1; const int32_t* p_mq;
  const uint8_t* r_proper;
  const int64_t* u_end1; const uint8_t* u_strand1; const int32_t* u_mq1;
  const int64_t* u_end2; const uint8_t* u_strand2; const int32_t* u_mq2;
  const uint8_t* text; int64_t text_n;
  const int64_t* seq_starts; int32_t n_seqs;
  const char* seqnames; const int64_t* seqname_offs;
  int32_t kb;
};

inline int32_t pe_seq_index(const PECtx& cx, int64_t pos) {
  const int64_t* s = cx.seq_starts;
  int32_t lo = 0, hi = cx.n_seqs + 1;
  while (lo < hi) {
    int32_t mid = (lo + hi) / 2;
    if (s[mid] <= pos) lo = mid + 1; else hi = mid;
  }
  int32_t idx = lo - 1;
  if (idx < 0) idx = 0;
  if (idx > cx.n_seqs - 1) idx = cx.n_seqs - 1;
  return idx;
}

// Per-read traceback cache for one side: the same occurrence can appear
// in several candidate pairs (Python dedups by object identity; (end,
// strand) is a superset key with identical results).
struct TBCache {
  struct Entry { int64_t end; uint8_t strand; TB tb; int32_t sidx; int64_t pos1; };
  std::vector<Entry> entries;
  void clear() { entries.clear(); }
};

struct PESide {
  const uint8_t* fwd;           // forward codes of this read
  int m;
  std::vector<uint8_t>* rc;     // lazily filled rev-comp buffer
  bool* have_rc;
  const char* qual; int qual_len;
};

const TBCache::Entry& pe_trace(const PECtx& cx, const PESide& side,
                               int64_t end, uint8_t strand, TBCache& cache,
                               Scratch& sc, int64_t* n_cigars) {
  for (const auto& e : cache.entries)
    if (e.end == end && e.strand == strand) return e;
  const uint8_t* pat = side.fwd;
  if (strand) {
    if (!*side.have_rc) {
      for (int i = 0; i < side.m; ++i) {
        uint8_t c = side.fwd[side.m - 1 - i];
        (*side.rc)[i] = c < 4 ? (uint8_t)(3 - c) : c;
      }
      *side.have_rc = true;
    }
    pat = side.rc->data();
  }
  const int64_t s_lo = cx.seq_starts[pe_seq_index(cx, end - 1)];
  int64_t w_lo = end - side.m - cx.kb;
  if (s_lo > w_lo) w_lo = s_lo;
  cache.entries.emplace_back();
  TBCache::Entry& e = cache.entries.back();
  e.end = end; e.strand = strand;
  run_traceback(pat, side.m, cx.text, w_lo, end, cx.kb, sc, e.tb);
  ++*n_cigars;
  e.sidx = pe_seq_index(cx, e.tb.begin);
  e.pos1 = e.tb.begin - cx.seq_starts[e.sidx] + 1;
  return e;
}

// one full SAM line for one mate of a pair (mate rname always '=',
// mirroring the Python emitter)
void pe_pair_line(const PECtx& cx, std::string& out,
                  const char* name, int name_len,
                  int flag, const TBCache::Entry& e, int mq,
                  int64_t mate_pos1, int64_t tlen,
                  const PESide& side, std::string& qual_rev) {
  out.append(name, name_len);
  out.push_back('\t');
  append_int(out, flag);
  out.push_back('\t');
  out.append(cx.seqnames + cx.seqname_offs[e.sidx],
             cx.seqname_offs[e.sidx + 1] - cx.seqname_offs[e.sidx]);
  out.push_back('\t');
  append_int(out, e.pos1);
  out.push_back('\t');
  append_int(out, mq);
  out.push_back('\t');
  out.append(e.tb.cigar);
  out.append("\t=\t");
  append_int(out, mate_pos1);
  out.push_back('\t');
  append_int(out, tlen);
  out.push_back('\t');
  append_seq(out, e.strand ? side.rc->data() : side.fwd, side.m);
  out.push_back('\t');
  if (e.strand) {
    qual_rev.assign(side.qual, side.qual_len);
    std::reverse(qual_rev.begin(), qual_rev.end());
    out.append(qual_rev);
  } else {
    out.append(side.qual, side.qual_len);
  }
  out.append("\tAS:i:");
  append_int(out, e.tb.ed);
  out.append("\tNM:i:");
  append_int(out, e.tb.ed);
  out.append("\tPG:Z:Columba\n");
}

void emit_pe_range(const PECtx& cx, int32_t r0, int32_t r1,
                   std::string& out, int64_t* cigars_done) {
  Scratch sc;
  std::vector<uint8_t> rc1(cx.m1), rc2(cx.m2);
  TBCache cache1, cache2;
  int64_t n_cigars = 0;
  std::string qual_rev;
  for (int32_t r = r0; r < r1; ++r) {
    const char* name1 = cx.names1 + cx.name1_offs[r];
    const int name1_len = (int)(cx.name1_offs[r + 1] - cx.name1_offs[r]);
    const char* name2 = cx.names2 + cx.name2_offs[r];
    const int name2_len = (int)(cx.name2_offs[r + 1] - cx.name2_offs[r]);
    bool have_rc1 = false, have_rc2 = false;
    PESide side1{cx.codes1 + cx.seq_offs1[r], cx.m1, &rc1, &have_rc1,
                 cx.quals1 + cx.qual1_offs[r],
                 (int)(cx.qual1_offs[r + 1] - cx.qual1_offs[r])};
    PESide side2{cx.codes2 + cx.seq_offs2[r], cx.m2, &rc2, &have_rc2,
                 cx.quals2 + cx.qual2_offs[r],
                 (int)(cx.qual2_offs[r + 1] - cx.qual2_offs[r])};
    const int64_t P0 = cx.pair_off[r], P1 = cx.pair_off[r + 1];
    if (P1 > P0) {
      cache1.clear(); cache2.clear();
      const int base = 0x1 | (cx.r_proper[r] ? 0x2 : 0);
      for (int64_t i = P0; i < P1; ++i) {
        const uint8_t s1 = cx.p_strand1[i], s2 = cx.p_strand2[i];
        const TBCache::Entry& e1 = pe_trace(cx, side1, cx.p_end1[i], s1,
                                            cache1, sc, &n_cigars);
        const TBCache::Entry& e2 = pe_trace(cx, side2, cx.p_end2[i], s2,
                                            cache2, sc, &n_cigars);
        const int sec = i > P0 ? 0x100 : 0;
        const int f1 = base | 0x40 | sec | (s1 ? 0x10 : 0) | (s2 ? 0x20 : 0);
        const int f2 = base | 0x80 | sec | (s2 ? 0x10 : 0) | (s1 ? 0x20 : 0);
        const int mq = cx.p_mq[i];
        const int64_t t1 = cx.p_tlen1[i];
        pe_pair_line(cx, out, name1, name1_len, f1, e1, mq, e2.pos1, t1,
                     side1, qual_rev);
        pe_pair_line(cx, out, name2, name2_len, f2, e2, mq, e1.pos1,
                     t1 == 0 ? 0 : -t1, side2, qual_rev);
      }
      continue;
    }
    // unpaired / unmapped per side (mate-unmapped bit always set,
    // mirroring the Python emitter's 0x8)
    struct USide { int fbit; int64_t end; uint8_t strand; int32_t mq;
                   PESide* side; TBCache* cache; const char* name;
                   int name_len; };
    USide us[2] = {
        {0x40, cx.u_end1[r], cx.u_strand1[r], cx.u_mq1[r], &side1, &cache1,
         name1, name1_len},
        {0x80, cx.u_end2[r], cx.u_strand2[r], cx.u_mq2[r], &side2, &cache2,
         name2, name2_len},
    };
    for (const USide& u : us) {
      if (u.end >= 0) {
        u.cache->clear();
        const TBCache::Entry& e = pe_trace(cx, *u.side, u.end, u.strand,
                                           *u.cache, sc, &n_cigars);
        const int flag = 0x1 | u.fbit | 0x8 | (u.strand ? 0x10 : 0);
        out.append(u.name, u.name_len);
        out.push_back('\t');
        append_int(out, flag);
        out.push_back('\t');
        out.append(cx.seqnames + cx.seqname_offs[e.sidx],
                   cx.seqname_offs[e.sidx + 1] - cx.seqname_offs[e.sidx]);
        out.push_back('\t');
        append_int(out, e.pos1);
        out.push_back('\t');
        append_int(out, u.mq);
        out.push_back('\t');
        out.append(e.tb.cigar);
        out.append("\t*\t0\t0\t");
        append_seq(out, e.strand ? u.side->rc->data() : u.side->fwd,
                   u.side->m);
        out.push_back('\t');
        if (e.strand) {
          qual_rev.assign(u.side->qual, u.side->qual_len);
          std::reverse(qual_rev.begin(), qual_rev.end());
          out.append(qual_rev);
        } else {
          out.append(u.side->qual, u.side->qual_len);
        }
        out.append("\tAS:i:");
        append_int(out, e.tb.ed);
        out.append("\tNM:i:");
        append_int(out, e.tb.ed);
        out.append("\tPG:Z:Columba\n");
      } else {
        const int flag = 0x1 | u.fbit | 0x4 | 0x8;
        out.append(u.name, u.name_len);
        out.push_back('\t');
        append_int(out, flag);
        out.append("\t*\t0\t0\t*\t*\t0\t0\t");
        append_seq(out, u.side->fwd, u.side->m);
        out.push_back('\t');
        out.append(u.side->qual, u.side->qual_len);
        out.append("\tPG:Z:Columba\n");
      }
    }
  }
  *cigars_done = n_cigars;
}

}  // namespace

extern "C" {

// Returns bytes written into out_buf, or -(needed) if out_cap is too
// small (caller retries with a larger buffer). stats[0] += cigars.
int64_t emit_sam_se(
    const uint8_t* codes, int32_t n_reads, int32_t m,
    const char* names, const int64_t* name_offs,
    const char* quals, const int64_t* qual_offs,
    const int64_t* occ_off, const int64_t* occ_end,
    const int32_t* occ_dist, const uint8_t* occ_strand,
    const int32_t* nbest_pre,
    const uint8_t* text, int64_t text_n,
    const int64_t* seq_starts, int32_t n_seqs,
    const char* seqnames, const int64_t* seqname_offs,
    int32_t kb, int32_t xa, int32_t unmapped, int32_t with_cigar,
    int32_t n_threads,
    char* out_buf, int64_t out_cap, int64_t* stats) {
  Ctx cx{codes, n_reads, m, names, name_offs, quals, qual_offs,
         occ_off, occ_end, occ_dist, occ_strand, nbest_pre,
         text, text_n, seq_starts, n_seqs, seqnames, seqname_offs,
         kb, xa, unmapped, with_cigar};
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_reads) n_threads = n_reads > 0 ? n_reads : 1;
  std::vector<std::string> bufs(n_threads);
  std::vector<int64_t> cig(n_threads, 0);
  if (n_threads == 1) {
    emit_range(cx, 0, n_reads, bufs[0], &cig[0]);
  } else {
    std::vector<std::thread> th;
    const int32_t step = (n_reads + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; ++i) {
      int32_t r0 = i * step;
      int32_t r1 = std::min(n_reads, r0 + step);
      if (r0 >= r1) { continue; }
      th.emplace_back([&, i, r0, r1] { emit_range(cx, r0, r1, bufs[i], &cig[i]); });
    }
    for (auto& t : th) t.join();
  }
  int64_t total = 0;
  for (auto& b : bufs) total += (int64_t)b.size();
  for (auto c : cig) stats[0] += c;
  if (total > out_cap) return -total;
  char* p = out_buf;
  for (auto& b : bufs) {
    std::memcpy(p, b.data(), b.size());
    p += b.size();
  }
  return total;
}

// Paired-end batch emission. Candidate pairs arrive as SoA in emission
// order (grouped per read via pair_off); unpaired fallbacks per read per
// side (u_end < 0 means unmapped record). Returns bytes written, or
// -(needed) when out_cap is too small. stats[0] += tracebacks run.
int64_t emit_sam_pe(
    const uint8_t* codes1, const int64_t* seq_offs1, int32_t n_reads,
    int32_t m1,
    const uint8_t* codes2, const int64_t* seq_offs2, int32_t m2,
    const char* names1, const int64_t* name1_offs,
    const char* quals1, const int64_t* qual1_offs,
    const char* names2, const int64_t* name2_offs,
    const char* quals2, const int64_t* qual2_offs,
    const int64_t* pair_off,
    const int64_t* p_end1, const uint8_t* p_strand1,
    const int64_t* p_end2, const uint8_t* p_strand2,
    const int64_t* p_tlen1, const int32_t* p_mq,
    const uint8_t* r_proper,
    const int64_t* u_end1, const uint8_t* u_strand1, const int32_t* u_mq1,
    const int64_t* u_end2, const uint8_t* u_strand2, const int32_t* u_mq2,
    const uint8_t* text, int64_t text_n,
    const int64_t* seq_starts, int32_t n_seqs,
    const char* seqnames, const int64_t* seqname_offs,
    int32_t kb, int32_t n_threads,
    char* out_buf, int64_t out_cap, int64_t* stats) {
  PECtx cx{codes1, seq_offs1, n_reads, m1, codes2, seq_offs2, m2,
           names1, name1_offs, quals1, qual1_offs,
           names2, name2_offs, quals2, qual2_offs,
           pair_off, p_end1, p_strand1, p_end2, p_strand2, p_tlen1, p_mq,
           r_proper, u_end1, u_strand1, u_mq1, u_end2, u_strand2, u_mq2,
           text, text_n, seq_starts, n_seqs, seqnames, seqname_offs, kb};
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_reads) n_threads = n_reads > 0 ? n_reads : 1;
  std::vector<std::string> bufs(n_threads);
  std::vector<int64_t> cig(n_threads, 0);
  if (n_threads == 1) {
    emit_pe_range(cx, 0, n_reads, bufs[0], &cig[0]);
  } else {
    std::vector<std::thread> th;
    const int32_t step = (n_reads + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; ++i) {
      int32_t r0 = i * step;
      int32_t r1 = std::min(n_reads, r0 + step);
      if (r0 >= r1) continue;
      th.emplace_back([&, i, r0, r1] { emit_pe_range(cx, r0, r1, bufs[i], &cig[i]); });
    }
    for (auto& t : th) t.join();
  }
  int64_t total = 0;
  for (auto& b : bufs) total += (int64_t)b.size();
  for (auto c : cig) stats[0] += c;
  if (total > out_cap) return -total;
  char* p = out_buf;
  for (auto& b : bufs) {
    std::memcpy(p, b.data(), b.size());
    p += b.size();
  }
  return total;
}

}  // extern "C"
