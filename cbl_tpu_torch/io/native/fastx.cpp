// Native FASTA/FASTQ decoder and 2-bit packer for cbl_tpu_torch.
//
// The port's own copy of `cbl_tpu/io/native/fastx.cpp`: the same state
// machine, byte for byte, behind a push interface.  Python opens the file
// (through the stdlib `gzip` module when it starts with 1f 8b) and feeds
// it in blocks; the parser keeps its state between blocks, so a record
// header or a `+` line may straddle a block edge.  The build needs a C++
// compiler and nothing else (no zlib).
//
// Output: the 2-bit code stream of every record, invalid bytes skipped
// (the reference's filter_map), and n_records + 1 record offsets into
// it.  Multi-line FASTQ is read with its quality lines counted against
// the sequence's raw length, not sniffed, so a quality line may begin
// with '@'.  Empty trailing records are dropped.
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// A=0, C=1, T=2, G=3; 255 = skip.
struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    memset(t, 255, sizeof(t));
    t[(unsigned)'A'] = 0; t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = 1; t[(unsigned)'c'] = 1;
    t[(unsigned)'T'] = 2; t[(unsigned)'t'] = 2;
    t[(unsigned)'G'] = 3; t[(unsigned)'g'] = 3;
  }
};
const CodeTable kCodes;

enum class State {
  kStart,
  kFastaHeader,   // inside '>' header line
  kFastaSeq,      // sequence lines of a FASTA record
  kFastqHeader,   // inside '@' header line
  kFastqSeq,      // sequence line(s) of a FASTQ record
  kFastqPlus,     // inside '+' line
  kFastqQual,     // quality characters (counted against seq length)
};

struct Result {
  const uint8_t* codes;
  uint64_t n_codes;
  const uint64_t* offsets;  // n_records + 1 entries
  uint64_t n_records;
};

struct Parser {
  std::vector<uint8_t> codes;
  std::vector<uint64_t> offsets{0};
  State state = State::kStart;
  uint64_t seq_len_raw = 0;  // raw sequence bytes of the FASTQ record
  uint64_t qual_seen = 0;    // quality bytes consumed so far
  bool at_line_start = true;
  Result result{};
};

}  // namespace

extern "C" {

Parser* fastx_new() {
  Parser* p = new Parser();
  p->codes.reserve(1 << 20);
  return p;
}

void fastx_feed(Parser* p, const char* buf, uint64_t n) {
  std::vector<uint8_t>& codes = p->codes;
  State state = p->state;
  bool at_line_start = p->at_line_start;
  for (uint64_t i = 0; i < n; i++) {
    unsigned char c = (unsigned char)buf[i];
    bool newline = (c == '\n');
    switch (state) {
      case State::kStart:
        if (c == '>') state = State::kFastaHeader;
        else if (c == '@') state = State::kFastqHeader;
        // else: leading junk/blank lines ignored
        break;
      case State::kFastaHeader:
        if (newline) state = State::kFastaSeq;
        break;
      case State::kFastaSeq:
        if (at_line_start && c == '>') {
          p->offsets.push_back(codes.size());
          state = State::kFastaHeader;
        } else if (!newline && c != '\r') {
          uint8_t v = kCodes.t[c];
          if (v != 255) codes.push_back(v);
        }
        break;
      case State::kFastqHeader:
        if (newline) {
          state = State::kFastqSeq;
          p->seq_len_raw = 0;
        }
        break;
      case State::kFastqSeq:
        if (at_line_start && c == '+') {
          state = State::kFastqPlus;
        } else if (!newline && c != '\r') {
          p->seq_len_raw++;
          uint8_t v = kCodes.t[c];
          if (v != 255) codes.push_back(v);
        }
        break;
      case State::kFastqPlus:
        if (newline) {
          state = State::kFastqQual;
          p->qual_seen = 0;
        }
        break;
      case State::kFastqQual:
        if (!newline && c != '\r') p->qual_seen++;
        if (p->qual_seen >= p->seq_len_raw) {
          p->offsets.push_back(codes.size());
          state = State::kStart;
        }
        break;
    }
    at_line_start = newline;
  }
  p->state = state;
  p->at_line_start = at_line_start;
}

// Close the last record and drop empty trailing ones; the result points
// into the parser and lives until fastx_free.
const Result* fastx_finish(Parser* p) {
  std::vector<uint64_t>& off = p->offsets;
  // final record end (FASTA last record, or truncated FASTQ)
  if (off.back() != p->codes.size() || p->state == State::kFastaSeq) {
    off.push_back(p->codes.size());
  }
  while (off.size() > 1 && off[off.size() - 1] == off[off.size() - 2]) {
    off.pop_back();
  }
  p->result = Result{p->codes.data(), p->codes.size(), off.data(),
                     off.size() - 1};
  return &p->result;
}

void fastx_free(Parser* p) { delete p; }

// Pack a 2-bit code stream 16 bases/uint32, base s at bits
// [30 - 2*(s%16), 32 - 2*(s%16)) of word s/16 (first base most
// significant): `cbl_tpu_torch.kmer.np_pack_stream`'s layout.  n must be
// a multiple of 16.
void cbl_pack_stream(const uint8_t* codes, uint64_t n, uint32_t* out) {
  const uint64_t nw = n / 16;
  for (uint64_t w = 0; w < nw; ++w) {
    const uint8_t* c = codes + w * 16;
    uint32_t v = 0;
    for (int j = 0; j < 16; ++j) v = (v << 2) | (uint32_t)c[j];
    out[w] = v;
  }
}

}  // extern "C"
