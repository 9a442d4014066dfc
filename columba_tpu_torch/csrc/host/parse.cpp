// Native FASTQ chunk parser: raw bytes -> (codes, names, quals) arrays.
// The port's own copy of the JAX package's parse.cpp.
//
// The producer-thread analogue of the reference's record parsing
// (reference: src/fastq.cpp:43-241 SequenceRecord + ReadBlock), built for
// the SoA batch layout the native SAM emitter consumes. Parses complete
// records from a byte buffer; a trailing partial record is left for the
// caller to carry into the next chunk (mirroring the reference's blocked
// reader, src/fastq.cpp:283-393).
//
// Cleanup mirrors Read::cleanUpRecord (src/reads.h:43-58): sequences are
// case-folded via the encode LUT and non-ACGT becomes code 4 (N).

#include <cstdint>
#include <cstring>

namespace {

struct Lut {
  uint8_t v[256];
  Lut() {
    std::memset(v, 4, sizeof v);
    const char* b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      v[(uint8_t)b[i]] = (uint8_t)i;
      v[(uint8_t)(b[i] + 32)] = (uint8_t)i;  // lowercase
    }
  }
};
const Lut LUT;

}  // namespace

extern "C" {

// Parse up to max_records complete FASTQ records from buf[0, len).
// Outputs:
//   codes_buf   encoded sequence bytes, concatenated
//   seq_offs    (n+1) int64 offsets into codes_buf
//   names_buf / name_offs   name bytes (up to first whitespace after '@')
//   quals_buf / qual_offs   quality bytes
// Returns n records parsed (>= 0) and sets *consumed to the byte count of
// complete records; returns -1 on malformed input, -2 if an output buffer
// is too small (caller enlarges and retries).
int32_t parse_fastq(
    const char* buf, int64_t len,
    uint8_t* codes_buf, int64_t codes_cap, int64_t* seq_offs,
    char* names_buf, int64_t names_cap, int64_t* name_offs,
    char* quals_buf, int64_t quals_cap, int64_t* qual_offs,
    int32_t max_records, int32_t is_final, int64_t* consumed) {
  int64_t pos = 0;
  int64_t co = 0, no = 0, qo = 0;
  int32_t n = 0;
  seq_offs[0] = 0;
  name_offs[0] = 0;
  qual_offs[0] = 0;
  while (n < max_records) {
    int64_t rec_start = pos;
    if (pos >= len) break;
    if (buf[pos] != '@') return -1;
    // header line
    const char* nl = (const char*)std::memchr(buf + pos, '\n', len - pos);
    if (!nl) break;
    int64_t hdr_end = nl - buf;
    // name = after '@' up to first whitespace
    int64_t ns = pos + 1, ne = ns;
    while (ne < hdr_end && buf[ne] != ' ' && buf[ne] != '\t'
           && buf[ne] != '\r') ++ne;
    // sequence line
    int64_t sp = hdr_end + 1;
    nl = (const char*)std::memchr(buf + sp, '\n', len - sp);
    if (!nl) break;
    int64_t se = nl - buf;
    int64_t sl = se - sp;
    if (sl > 0 && buf[se - 1] == '\r') --sl;
    // '+' line
    int64_t pp = se + 1;
    nl = (const char*)std::memchr(buf + pp, '\n', len - pp);
    if (!nl) break;
    if (pp >= len || buf[pp] != '+') return -1;
    // quality line
    int64_t qp = (nl - buf) + 1;
    nl = (const char*)std::memchr(buf + qp, '\n', len - qp);
    int64_t qe;
    if (!nl) {
      // a newline-less qual line is complete only in the file's final
      // chunk (otherwise the record continues in the next chunk)
      if (!is_final) break;
      qe = len;
      if (qe - qp < sl) break;
    } else {
      qe = nl - buf;
    }
    int64_t ql = qe - qp;
    if (ql > 0 && buf[qe - 1] == '\r') --ql;
    if (ql != sl) {
      if (!nl) break;  // partial tail
      return -1;
    }
    if (co + sl > codes_cap || no + (ne - ns) > names_cap
        || qo + ql > quals_cap) return -2;
    for (int64_t i = 0; i < sl; ++i)
      codes_buf[co + i] = LUT.v[(uint8_t)buf[sp + i]];
    std::memcpy(names_buf + no, buf + ns, ne - ns);
    std::memcpy(quals_buf + qo, buf + qp, ql);
    co += sl; no += ne - ns; qo += ql;
    ++n;
    seq_offs[n] = co;
    name_offs[n] = no;
    qual_offs[n] = qo;
    pos = nl ? (nl - buf) + 1 : len;
    (void)rec_start;
  }
  *consumed = pos;
  return n;
}

}  // extern "C"
