// raft_tpu native host I/O: streaming gz FASTA/FASTQ + PAF parsing and
// output emission.
//
// TPU-native equivalent of the reference's native I/O layer (kseq.h /
// paf.hpp / the ofstream emit loops in chop.hpp:318 and repeat.hpp:105) —
// re-implemented from scratch as a columnar parser: instead of per-record
// heap objects it produces contiguous blobs + int64 offsets and int32
// overlap columns that numpy wraps zero-copy. Parsing semantics match the
// reference exactly (first-whitespace-token names, CRLF stripping, FASTQ
// quality skipped by length, >=10-column PAF rows, first-seen-order name
// interning, record-0-mirror symmetric detection).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <condition_variable>
#include <mutex>
#include <regex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>
#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// Buffered line reader over gzFile (transparently handles plain files too).
// ---------------------------------------------------------------------------
class LineReader {
 public:
  explicit LineReader(const char* path)
      : fp_(gzopen(path, "rb")), buf_(1 << 22), pos_(0), end_(0), eof_(false) {
    if (fp_) gzbuffer(fp_, 1 << 20);
  }
  ~LineReader() {
    if (fp_) gzclose(fp_);
  }
  bool ok() const { return fp_ != nullptr; }

  // Returns a view of the next line (without trailing \n or \r\n); false at
  // EOF. The view stays valid until the next call.
  bool next(const char** s, size_t* n) {
    if (done_) return false;
    carry_.clear();
    for (;;) {
      if (pos_ < end_) {
        char* nl = static_cast<char*>(
            memchr(buf_.data() + pos_, '\n', end_ - pos_));
        if (nl) {
          size_t len = nl - (buf_.data() + pos_);
          if (carry_.empty()) {
            *s = buf_.data() + pos_;
            *n = strip_cr(*s, len);
          } else {
            carry_.append(buf_.data() + pos_, len);
            *s = carry_.data();
            *n = strip_cr(*s, carry_.size());
          }
          pos_ += len + 1;
          return true;
        }
        carry_.append(buf_.data() + pos_, end_ - pos_);
        pos_ = end_;
      }
      int r = gzread(fp_, buf_.data(), static_cast<unsigned>(buf_.size()));
      if (r <= 0) {
        done_ = true;  // final line without trailing newline
        if (carry_.empty()) return false;
        *s = carry_.data();
        *n = strip_cr(*s, carry_.size());
        return true;
      }
      pos_ = 0;
      end_ = static_cast<size_t>(r);
    }
  }

 private:
  static size_t strip_cr(const char* s, size_t n) {
    return (n && s[n - 1] == '\r') ? n - 1 : n;
  }
  gzFile fp_;
  std::vector<char> buf_;
  size_t pos_, end_;
  bool eof_;
  bool done_ = false;
  std::string carry_;
};

struct Interner {
  // Open-addressing FNV-1a string→id map. The previous
  // std::unordered_map<std::string, int32_t> built a temporary
  // std::string PER CALL — one heap allocation per name per PAF row,
  // ~63 M allocations for the 512k-read / 31.5 M-row parse — which
  // dominated the preparse profile. This probes with the raw bytes and
  // allocates only for first-seen names. Ids are assigned in
  // first-seen order (the reference's create_pileup contract).
  std::vector<uint64_t> hashes;    // 0 = empty slot
  std::vector<int32_t> ids;        // slot → id
  std::vector<std::string> names;  // id → name (first-seen order)
  size_t mask = 0;

  static uint64_t hash_bytes(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; i++) {
      h ^= static_cast<unsigned char>(s[i]);
      h *= 1099511628211ull;
    }
    return h | 1;  // never 0 (0 marks an empty slot)
  }
  void grow(size_t want_ids) {
    size_t cap = 64;
    while (cap < want_ids * 2) cap <<= 1;
    if (cap <= hashes.size()) return;
    std::vector<uint64_t> oh = std::move(hashes);
    std::vector<int32_t> oi = std::move(ids);
    hashes.assign(cap, 0);
    ids.assign(cap, 0);
    mask = cap - 1;
    for (size_t j = 0; j < oh.size(); j++) {
      if (!oh[j]) continue;
      size_t i = oh[j] & mask;
      while (hashes[i]) i = (i + 1) & mask;
      hashes[i] = oh[j];
      ids[i] = oi[j];
    }
  }
  // warm the probe slot for a hash about to be interned: at millions of
  // distinct names the probe arrays are 100+ MB and every lookup is a
  // cache miss — batching hash computation and prefetching ~20 slots
  // ahead overlaps those misses (measured on the 4M-read / 139M-row
  // preparse, SCALE_r05 many_small_reads hotspot)
  inline void prefetch(uint64_t h) const {
    if (mask) __builtin_prefetch(&hashes[h & mask]);
  }
  int32_t intern_h(const char* s, size_t n, uint64_t h) {
    if (hashes.empty()) grow(16);
    size_t i = h & mask;
    while (hashes[i]) {
      if (hashes[i] == h) {
        const std::string& k = names[ids[i]];
        if (k.size() == n && memcmp(k.data(), s, n) == 0) return ids[i];
      }
      i = (i + 1) & mask;
    }
    int32_t id = static_cast<int32_t>(names.size());
    names.emplace_back(s, n);
    hashes[i] = h;
    ids[i] = id;
    if (names.size() * 2 >= mask) grow(names.size() * 2);
    return id;
  }
  int32_t intern(const char* s, size_t n) {
    return intern_h(s, n, hash_bytes(s, n));
  }
  // read-only (thread-safe) lookup; -1 if unknown
  int32_t lookup(const char* s, size_t n) const {
    if (hashes.empty()) return -1;
    uint64_t h = hash_bytes(s, n);
    size_t i = h & mask;
    while (hashes[i]) {
      if (hashes[i] == h) {
        const std::string& k = names[ids[i]];
        if (k.size() == n && memcmp(k.data(), s, n) == 0) return ids[i];
      }
      i = (i + 1) & mask;
    }
    return -1;
  }
  size_t size() const { return names.size(); }
};

// Read-only file mapping for the multi-threaded plain-file parsers.
struct Mapped {
  const char* p = nullptr;
  size_t n = 0;
  int fd = -1;
  bool ok() const { return p != nullptr; }
  ~Mapped() {
    if (p) munmap(const_cast<char*>(p), n);
    if (fd >= 0) close(fd);
  }
};

bool map_file(const char* path, Mapped* m) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) return false;
  struct stat st;
  if (fstat(m->fd, &st) != 0 || st.st_size == 0) return false;
  m->n = static_cast<size_t>(st.st_size);
  void* p = mmap(nullptr, m->n, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p == MAP_FAILED) {
    m->n = 0;
    return false;
  }
  madvise(p, m->n, MADV_SEQUENTIAL);
  m->p = static_cast<const char*>(p);
  return true;
}

// ---------------------------------------------------------------------------
// gzip → memory decompression.
//
// BGZF files (gzip members carrying the BC extra subfield, ≤64 KB
// uncompressed per block — bgzip/samtools output) decompress
// block-parallel across threads. Plain gzip streams on one thread.
// Either way the result is one contiguous buffer the multi-threaded
// parsers run on, so gz inputs reach plain-file parse speeds instead of
// the single-thread gzread line reader. (The reference reads all inputs
// through single-thread kseq+zlib, /root/reference/kseq.h + paf.hpp:7.)
// ---------------------------------------------------------------------------
int n_parse_threads();

struct BgzfBlock {
  size_t off;         // byte offset of the gzip member
  uint32_t data_off;  // offset of the raw-deflate payload within the member
  uint32_t comp_len;  // payload length
  uint32_t isize;     // uncompressed size (≤ 65536 per spec)
  size_t out_off;     // exclusive-scan of isize
};

inline uint32_t le16(const char* p) {
  return static_cast<uint8_t>(p[0]) | (static_cast<uint8_t>(p[1]) << 8);
}
inline uint32_t le32(const char* p) {
  return le16(p) | (le16(p + 2) << 16);
}

bool bgzf_index(const char* p, size_t n, std::vector<BgzfBlock>* blocks,
                size_t* total_out) {
  size_t i = 0;
  *total_out = 0;
  while (i < n) {
    if (i + 18 > n) return false;
    if (static_cast<uint8_t>(p[i]) != 0x1f ||
        static_cast<uint8_t>(p[i + 1]) != 0x8b ||
        static_cast<uint8_t>(p[i + 2]) != 8 ||
        !(static_cast<uint8_t>(p[i + 3]) & 4))
      return false;  // not a gzip member with FEXTRA → not BGZF
    uint32_t xlen = le16(p + i + 10);
    if (i + 12 + xlen > n) return false;
    uint32_t bsize = 0;
    bool found = false;
    for (uint32_t so = 0; so + 4 <= xlen;) {
      const char* sf = p + i + 12 + so;
      uint32_t slen = le16(sf + 2);
      if (sf[0] == 'B' && sf[1] == 'C' && slen == 2) {
        bsize = le16(sf + 4) + 1;  // BSIZE = total member size − 1
        found = true;
        break;
      }
      so += 4 + slen;
    }
    if (!found || bsize < 12 + xlen + 8 || i + bsize > n) return false;
    uint32_t isize = le32(p + i + bsize - 4);
    if (isize > (1u << 16)) return false;
    blocks->push_back({i, 12 + xlen, bsize - 12 - xlen - 8, isize,
                       *total_out});
    *total_out += isize;
    i += bsize;
  }
  return !blocks->empty();
}

bool bgzf_inflate_blocks(const char* p, const std::vector<BgzfBlock>& blocks,
                         char* out) {
  const int T = n_parse_threads();
  const size_t B = blocks.size();
  std::vector<char> fail(T, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; t++) {
    threads.emplace_back([&, t]() {
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) {
        fail[t] = 1;
        return;
      }
      for (size_t k = B * t / T; k < B * (t + 1) / T; k++) {
        const BgzfBlock& b = blocks[k];
        if (b.isize == 0) continue;  // EOF marker block
        inflateReset(&zs);
        zs.next_in = reinterpret_cast<Bytef*>(
            const_cast<char*>(p + b.off + b.data_off));
        zs.avail_in = b.comp_len;
        zs.next_out = reinterpret_cast<Bytef*>(out + b.out_off);
        zs.avail_out = b.isize;
        int r = inflate(&zs, Z_FINISH);
        if (r != Z_STREAM_END || zs.avail_out != 0) {
          fail[t] = 1;
          return;
        }
      }
      inflateEnd(&zs);
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < T; t++)
    if (fail[t]) return false;
  return true;
}

// Decompress a whole gz file into `out`: BGZF in parallel, else one
// streaming gzread pass (handles multi-member and raw-looking inputs).
bool gunzip_all(const char* path, const char* p, size_t n,
                std::vector<char>* out) {
  {
    std::vector<BgzfBlock> blocks;
    size_t total = 0;
    if (bgzf_index(p, n, &blocks, &total)) {
      out->resize(total);
      if (bgzf_inflate_blocks(p, blocks, out->data())) return true;
      out->clear();  // corrupt block: fall through to streaming
    }
  }
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, 1 << 20);
  out->clear();
  out->reserve(n * 3);
  std::vector<char> chunk(1 << 22);
  for (;;) {
    int r = gzread(f, chunk.data(), static_cast<unsigned>(chunk.size()));
    if (r < 0) {
      gzclose(f);
      return false;
    }
    if (r == 0) break;
    out->insert(out->end(), chunk.data(), chunk.data() + r);
  }
  gzclose(f);
  return true;
}

// A parse input: plain files are mmapped; gz files are decompressed to a
// heap buffer — so the threaded parsers always see contiguous bytes.
struct Source {
  Mapped m;
  std::vector<char> buf;
  const char* p = nullptr;
  size_t n = 0;
  bool ok() const { return p != nullptr && n > 0; }
};

bool open_source(const char* path, Source* s) {
  if (!map_file(path, &s->m)) return false;
  if (s->m.n >= 2 && static_cast<uint8_t>(s->m.p[0]) == 0x1f &&
      static_cast<uint8_t>(s->m.p[1]) == 0x8b) {
    if (!gunzip_all(path, s->m.p, s->m.n, &s->buf)) return false;
    s->p = s->buf.data();
    s->n = s->buf.size();
  } else {
    s->p = s->m.p;
    s->n = s->m.n;
  }
  return s->ok();
}

size_t mt_threshold() {
  const char* env = getenv("RAFT_IO_MT_THRESHOLD");
  if (env && *env) return static_cast<size_t>(strtoull(env, nullptr, 10));
  return 1u << 22;
}

int n_parse_threads() {
  const char* env = getenv("RAFT_IO_THREADS");
  if (env && *env) {
    int v = atoi(env);
    if (v >= 1) return v;
  }
  unsigned hc = std::thread::hardware_concurrency();
  if (hc == 0) hc = 4;
  return static_cast<int>(hc > 16 ? 16 : hc);
}

inline size_t line_len(const char* s, size_t n) {  // without \r
  return (n && s[n - 1] == '\r') ? n - 1 : n;
}

}  // namespace

// ---------------------------------------------------------------------------
// FASTA/FASTQ store
// ---------------------------------------------------------------------------
struct RaftFasta {
  std::vector<char> name_blob;   // names joined by '\0'
  std::vector<int64_t> name_off; // n+1
  std::vector<char> seq_blob;
  std::vector<int64_t> seq_off;  // n+1; copy mode: contiguous blob
                                 // offsets; zero-copy mode: ABSOLUTE
                                 // offsets into the source buffer
                                 // ([n] = source size either way)
  std::vector<int64_t> lens;     // n per-read sequence lengths (zero-copy
                                 // mode cannot derive them from seq_off)
  std::vector<int64_t> rec_off;  // n+1 record BYTE offsets (index mode)
  int real_reads = 1;
  Interner interner;
  int64_t n = 0;
  // Zero-copy single-line FASTA: sequence bytes stay in the mmap (or the
  // gz-decompressed buffer) owned here; ext_seq is the base pointer.
  Source* src = nullptr;
  const char* ext_seq = nullptr;
  ~RaftFasta() { delete src; }
  // Streaming over gz inputs: the index pass spills the decompressed
  // bytes to this temp file (unlinked when the handle is freed); rec_off
  // are offsets into it and chunk loads mmap it like a plain input.
  std::string decomp_path;
  bool has_fastq = false;  // any '@' record → range loads use the
                           // sequential fastx parser, not the threaded
                           // plain-FASTA one
};

namespace {

// ---------------------------------------------------------------------------
// Multi-threaded plain-FASTA parse (mmap + record-aligned byte regions).
// gz / FASTQ inputs use the streaming single-thread path below.
// ---------------------------------------------------------------------------
struct FaSizes {
  int64_t n_records = 0;
  int64_t name_bytes = 0;  // incl. one NUL per name
  int64_t seq_bytes = 0;
  bool zc_ok = true;  // every record single-seq-line, no CR → sequence
                      // bytes can stay in the source (zero-copy mode)
};

size_t fasta_region_start(const char* p, size_t n, size_t lo) {
  if (lo == 0) return (n && p[0] == '>') ? 0 : fasta_region_start(p, n, 1);
  const char* q = p + lo - 1;
  const char* end = p + n;
  while (q < end) {
    q = static_cast<const char*>(memchr(q, '\n', end - q));
    if (!q) return n;
    if (q + 1 < end && q[1] == '>') return static_cast<size_t>(q + 1 - p);
    q++;
  }
  return n;
}

// Pass 1: exact output sizes for a region (no allocation, pure scan).
void size_fasta_region(const char* p, size_t n, size_t lo, size_t hi,
                       FaSizes* out) {
  size_t i = fasta_region_start(p, n, lo);
  while (i < hi && i < n) {
    const char* line = p + i;
    const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
    size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
    size_t hlen = line_len(line, llen);
    size_t b = 1;
    while (b < hlen && isspace(static_cast<unsigned char>(line[b]))) b++;
    size_t e = b;
    while (e < hlen && !isspace(static_cast<unsigned char>(line[e]))) e++;
    out->n_records++;
    out->name_bytes += static_cast<int64_t>(e - b) + 1;

    size_t j = nl ? static_cast<size_t>(nl - p) + 1 : n;
    int seq_lines = 0;
    while (j < n && p[j] != '>') {
      const char* l2 = p + j;
      const char* nl2 = static_cast<const char*>(memchr(l2, '\n', n - j));
      size_t l2len = nl2 ? static_cast<size_t>(nl2 - l2) : n - j;
      size_t slen = line_len(l2, l2len);
      out->seq_bytes += static_cast<int64_t>(slen);
      if (slen != l2len) out->zc_ok = false;  // CR needs stripping
      if (slen) seq_lines++;
      j = nl2 ? static_cast<size_t>(nl2 - p) + 1 : n;
    }
    if (seq_lines > 1) out->zc_ok = false;
    i = j;
  }
}

// Zero-copy pass 2: names copy out (small), sequences stay in place —
// record ABSOLUTE seq offsets + lengths instead of building seq_blob.
void fill_fasta_zc_region(const char* p, size_t n, size_t lo, size_t hi,
                          char* name_blob, int64_t name_base,
                          int64_t* name_off, int64_t* seq_off,
                          int64_t* lens, int64_t rec_base) {
  size_t i = fasta_region_start(p, n, lo);
  int64_t npos = name_base;
  int64_t rec = rec_base;
  while (i < hi && i < n) {
    const char* line = p + i;
    const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
    size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
    size_t hlen = line_len(line, llen);
    size_t b = 1;
    while (b < hlen && isspace(static_cast<unsigned char>(line[b]))) b++;
    size_t e = b;
    while (e < hlen && !isspace(static_cast<unsigned char>(line[e]))) e++;
    memcpy(name_blob + npos, line + b, e - b);
    npos += static_cast<int64_t>(e - b);
    name_blob[npos++] = '\0';

    size_t j = nl ? static_cast<size_t>(nl - p) + 1 : n;
    int64_t s_off = static_cast<int64_t>(j);
    int64_t s_len = 0;
    while (j < n && p[j] != '>') {
      const char* l2 = p + j;
      const char* nl2 = static_cast<const char*>(memchr(l2, '\n', n - j));
      size_t l2len = nl2 ? static_cast<size_t>(nl2 - l2) : n - j;
      if (l2len && s_len == 0) s_off = static_cast<int64_t>(j);
      s_len += static_cast<int64_t>(l2len);  // zc-verified: single line
      j = nl2 ? static_cast<size_t>(nl2 - p) + 1 : n;
    }
    seq_off[rec] = s_off;
    lens[rec] = s_len;
    rec++;
    name_off[rec] = npos;
    i = j;
  }
}

// Pass 2: write names/seqs/offsets DIRECTLY into the final arrays at this
// region's precomputed base offsets (no local buffers, no merge copies —
// each output page is touched exactly once).
void fill_fasta_region(const char* p, size_t n, size_t lo, size_t hi,
                       char* name_blob, int64_t name_base,
                       char* seq_blob, int64_t seq_base,
                       int64_t* name_off, int64_t* seq_off,
                       int64_t rec_base) {
  size_t i = fasta_region_start(p, n, lo);
  int64_t npos = name_base;
  int64_t spos = seq_base;
  int64_t rec = rec_base;
  while (i < hi && i < n) {
    const char* line = p + i;
    const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
    size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
    size_t hlen = line_len(line, llen);
    size_t b = 1;
    while (b < hlen && isspace(static_cast<unsigned char>(line[b]))) b++;
    size_t e = b;
    while (e < hlen && !isspace(static_cast<unsigned char>(line[e]))) e++;
    memcpy(name_blob + npos, line + b, e - b);
    npos += static_cast<int64_t>(e - b);
    name_blob[npos++] = '\0';

    size_t j = nl ? static_cast<size_t>(nl - p) + 1 : n;
    while (j < n && p[j] != '>') {
      const char* l2 = p + j;
      const char* nl2 = static_cast<const char*>(memchr(l2, '\n', n - j));
      size_t l2len = nl2 ? static_cast<size_t>(nl2 - l2) : n - j;
      size_t slen = line_len(l2, l2len);
      memcpy(seq_blob + spos, l2, slen);
      spos += static_cast<int64_t>(slen);
      j = nl2 ? static_cast<size_t>(nl2 - p) + 1 : n;
    }
    rec++;
    name_off[rec] = npos;
    seq_off[rec] = spos;
    i = j;
  }
}

void fill_index_region(const char* p, size_t n, size_t lo, size_t hi,
                       char* name_blob, int64_t name_base,
                       int64_t* name_off, int64_t* rec_off,
                       int64_t rec_base, int64_t* lens) {
  size_t i = fasta_region_start(p, n, lo);
  int64_t npos = name_base;
  int64_t rec = rec_base;
  while (i < hi && i < n) {
    rec_off[rec] = static_cast<int64_t>(i);
    const char* line = p + i;
    const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
    size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
    size_t hlen = line_len(line, llen);
    size_t b = 1;
    while (b < hlen && isspace(static_cast<unsigned char>(line[b]))) b++;
    size_t e = b;
    while (e < hlen && !isspace(static_cast<unsigned char>(line[e]))) e++;
    memcpy(name_blob + npos, line + b, e - b);
    npos += static_cast<int64_t>(e - b);
    name_blob[npos++] = '\0';
    // sequence length rides along for free: the scan below already
    // walks every sequence line to find the next record (consumers:
    // the chunked pipeline's whole-input native event grouping)
    int64_t slen = 0;
    size_t j = nl ? static_cast<size_t>(nl - p) + 1 : n;
    while (j < n && p[j] != '>') {
      const char* nl2 =
          static_cast<const char*>(memchr(p + j, '\n', n - j));
      size_t l2 = nl2 ? static_cast<size_t>(nl2 - (p + j)) : n - j;
      slen += static_cast<int64_t>(line_len(p + j, l2));
      j = nl2 ? static_cast<size_t>(nl2 - p) + 1 : n;
    }
    lens[rec] = slen;
    rec++;
    name_off[rec] = npos;
    i = j;
  }
}

RaftFasta* load_fasta_threaded_range(const char* p, size_t n,
                                     size_t range_lo, size_t range_hi,
                                     bool allow_zc);

// Name + byte-offset index over the whole buffer (no sequence copies):
// the cheap first pass of the streaming (beyond-RAM) pipeline mode.
RaftFasta* index_fasta_threaded(const char* p, const size_t n) {
  const int T = n_parse_threads();
  std::vector<FaSizes> sizes(T);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      threads.emplace_back(size_fasta_region, p, n, n * t / T,
                           n * (t + 1) / T, &sizes[t]);
    }
    for (auto& th : threads) th.join();
  }
  std::vector<int64_t> rec_base(T + 1, 0), nb_base(T + 1, 0);
  for (int t = 0; t < T; t++) {
    rec_base[t + 1] = rec_base[t] + sizes[t].n_records;
    nb_base[t + 1] = nb_base[t] + sizes[t].name_bytes;
  }
  auto* fa = new RaftFasta();
  fa->name_blob.resize(nb_base[T]);
  fa->name_off.resize(rec_base[T] + 1);
  fa->rec_off.resize(rec_base[T] + 1);
  fa->lens.resize(rec_base[T]);
  fa->name_off[0] = 0;
  fa->rec_off[rec_base[T]] = static_cast<int64_t>(n);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      threads.emplace_back(fill_index_region, p, n, n * t / T,
                           n * (t + 1) / T, fa->name_blob.data(),
                           nb_base[t], fa->name_off.data(),
                           fa->rec_off.data(), rec_base[t],
                           fa->lens.data());
    }
    for (auto& th : threads) th.join();
  }
  fa->n = rec_base[T];
  static const std::regex sim_re(
      "^read=[0-9]+,[a-z]+,position=[0-9]+-[0-9]+,length=[0-9]+,(.*)");
  for (int64_t i = 0; i < fa->n; i++) {
    const char* nm = fa->name_blob.data() + fa->name_off[i];
    size_t nl = static_cast<size_t>(fa->name_off[i + 1] - fa->name_off[i] - 1);
    if (i == 0 && std::regex_match(std::string(nm, nl), sim_re))
      fa->real_reads = 0;
    fa->interner.intern(nm, nl);
  }
  return fa;
}

// Parse only the records starting in [range_lo, range_hi) — the byte-range
// primitive behind the streaming (beyond-RAM) pipeline mode.
// ``allow_zc``: when every record is single-seq-line with no CR (the
// common case for error-corrected output), sequence bytes are NOT copied
// — seq_off become ABSOLUTE source offsets and the caller must attach
// the source buffer to the returned store (ext_seq/src).
RaftFasta* load_fasta_threaded_range(const char* p, size_t n,
                                     size_t range_lo, size_t range_hi,
                                     bool allow_zc) {
  const int T = n_parse_threads();

  const size_t span = range_hi - range_lo;
  auto seg = [&](int t) { return range_lo + span * t / T; };

  // pass 1: size every region (parallel scan, no allocation)
  std::vector<FaSizes> sizes(T);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      threads.emplace_back(size_fasta_region, p, n, seg(t), seg(t + 1),
                           &sizes[t]);
    }
    for (auto& th : threads) th.join();
  }
  int64_t total_names = 0, total_name_bytes = 0, total_seq = 0;
  bool zc = allow_zc;
  std::vector<int64_t> rec_base(T + 1, 0), nb_base(T + 1, 0),
      sb_base(T + 1, 0);
  for (int t = 0; t < T; t++) {
    rec_base[t + 1] = rec_base[t] + sizes[t].n_records;
    nb_base[t + 1] = nb_base[t] + sizes[t].name_bytes;
    sb_base[t + 1] = sb_base[t] + sizes[t].seq_bytes;
    zc = zc && sizes[t].zc_ok;
  }
  total_names = rec_base[T];
  total_name_bytes = nb_base[T];
  total_seq = sb_base[T];

  // pass 2: exact-size allocations written once, in parallel, in place
  auto* fa = new RaftFasta();
  fa->name_blob.resize(total_name_bytes);
  fa->name_off.resize(total_names + 1);
  fa->seq_off.resize(total_names + 1);
  fa->lens.resize(total_names);
  fa->name_off[0] = 0;
  fa->seq_off[0] = 0;
  {
    std::vector<std::thread> threads;
    if (zc) {
      fa->ext_seq = p;
      fa->seq_off[total_names] = static_cast<int64_t>(n);
      for (int t = 0; t < T; t++) {
        threads.emplace_back(fill_fasta_zc_region, p, n, seg(t),
                             seg(t + 1), fa->name_blob.data(), nb_base[t],
                             fa->name_off.data(), fa->seq_off.data(),
                             fa->lens.data(), rec_base[t]);
      }
    } else {
      fa->seq_blob.resize(total_seq);
      for (int t = 0; t < T; t++) {
        threads.emplace_back(fill_fasta_region, p, n, seg(t), seg(t + 1),
                             fa->name_blob.data(), nb_base[t],
                             fa->seq_blob.data(), sb_base[t],
                             fa->name_off.data(), fa->seq_off.data(),
                             rec_base[t]);
      }
    }
    for (auto& th : threads) th.join();
  }
  fa->n = total_names;
  if (!zc) {
    for (int64_t i = 0; i < fa->n; i++)
      fa->lens[i] = fa->seq_off[i + 1] - fa->seq_off[i];
  }

  // global first-seen-order interning + the record-0 simulated gate
  for (int64_t i = 0; i < fa->n; i++) {
    const char* nm = fa->name_blob.data() + fa->name_off[i];
    size_t nl = static_cast<size_t>(
        fa->name_off[i + 1] - fa->name_off[i] - 1);
    if (i == 0) {
      static const std::regex sim_re(
          "^read=[0-9]+,[a-z]+,position=[0-9]+-[0-9]+,length=[0-9]+,(.*)");
      if (std::regex_match(std::string(nm, nl), sim_re)) fa->real_reads = 0;
    }
    fa->interner.intern(nm, nl);
  }
  return fa;
}

// Sequential fastx index over a buffer (kseq semantics: '>' or '@'
// records, multi-line sequence, quality skipped by accumulated length).
// Used when the file is not pure '>'-FASTA; O(bytes) memchr scan.
void index_fastx_buf(const char* p, size_t n, RaftFasta* fa) {
  fa->name_off.push_back(0);
  bool in_fastq = false;
  bool have_rec = false;
  bool skipping_qual = false;
  int64_t seq_len_cur = 0, qual_len = 0;
  size_t i = 0;
  while (i < n) {
    const char* line = p + i;
    const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
    size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
    size_t len = line_len(line, llen);
    size_t next = nl ? static_cast<size_t>(nl - p) + 1 : n;
    if (skipping_qual) {
      qual_len += static_cast<int64_t>(len);
      if (qual_len >= seq_len_cur) skipping_qual = false;
    } else if (len && (line[0] == '>' || line[0] == '@')) {
      size_t b = 1;
      while (b < len && isspace(static_cast<unsigned char>(line[b]))) b++;
      size_t e = b;
      while (e < len && !isspace(static_cast<unsigned char>(line[e]))) e++;
      if (fa->n > 0) fa->lens.push_back(seq_len_cur);
      fa->rec_off.push_back(static_cast<int64_t>(i));
      fa->name_blob.insert(fa->name_blob.end(), line + b, line + e);
      fa->name_blob.push_back('\0');
      fa->name_off.push_back(static_cast<int64_t>(fa->name_blob.size()));
      fa->n++;
      have_rec = true;
      in_fastq = (line[0] == '@');
      if (in_fastq) fa->has_fastq = true;
      seq_len_cur = 0;
    } else if (len && line[0] == '+' && in_fastq) {
      qual_len = 0;
      if (seq_len_cur > 0) skipping_qual = true;
      have_rec = false;  // record complete (possibly empty sequence)
    } else if (len && have_rec) {
      seq_len_cur += static_cast<int64_t>(len);
    }
    i = next;
  }
  if (fa->n > 0) fa->lens.push_back(seq_len_cur);
  fa->rec_off.push_back(static_cast<int64_t>(n));
  static const std::regex sim_re(
      "^read=[0-9]+,[a-z]+,position=[0-9]+-[0-9]+,length=[0-9]+,(.*)");
  for (int64_t r = 0; r < fa->n; r++) {
    const char* nm = fa->name_blob.data() + fa->name_off[r];
    size_t nmlen = static_cast<size_t>(
        fa->name_off[r + 1] - fa->name_off[r] - 1);
    if (r == 0 && std::regex_match(std::string(nm, nmlen), sim_re))
      fa->real_reads = 0;
    fa->interner.intern(nm, nmlen);
  }
}

// Sequential fastx RANGE parse: records starting in [lo, hi) with kseq
// semantics. Callers pass exact record boundaries from the index, so the
// parse is self-contained (chunks are bounded; threading is unnecessary).
RaftFasta* load_fastx_buf_range(const char* p, size_t n, size_t lo,
                                size_t hi) {
  auto* fa = new RaftFasta();
  fa->name_off.push_back(0);
  fa->seq_off.push_back(0);  // invariant: seq_off.size()==n means a
                             // record is open; ==n+1 means closed
  bool in_fastq = false;
  bool have_rec = false;
  bool skipping_qual = false;
  int64_t seq_len_cur = 0, qual_len = 0;
  auto close_rec = [&]() {
    if (fa->seq_off.size() == static_cast<size_t>(fa->n))
      fa->seq_off.push_back(static_cast<int64_t>(fa->seq_blob.size()));
  };
  size_t i = lo;
  while (i < n) {
    const char* line = p + i;
    const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
    size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
    size_t len = line_len(line, llen);
    size_t next = nl ? static_cast<size_t>(nl - p) + 1 : n;
    if (skipping_qual) {
      qual_len += static_cast<int64_t>(len);
      if (qual_len >= seq_len_cur) skipping_qual = false;
    } else if (len && (line[0] == '>' || line[0] == '@')) {
      if (i >= hi) break;  // next chunk's record
      close_rec();
      size_t b = 1;
      while (b < len && isspace(static_cast<unsigned char>(line[b]))) b++;
      size_t e = b;
      while (e < len && !isspace(static_cast<unsigned char>(line[e]))) e++;
      fa->name_blob.insert(fa->name_blob.end(), line + b, line + e);
      fa->name_blob.push_back('\0');
      fa->name_off.push_back(static_cast<int64_t>(fa->name_blob.size()));
      fa->n++;
      have_rec = true;
      in_fastq = (line[0] == '@');
      seq_len_cur = 0;
    } else if (len && line[0] == '+' && in_fastq) {
      qual_len = 0;
      if (seq_len_cur > 0) skipping_qual = true;
      have_rec = false;
    } else if (len && have_rec) {
      fa->seq_blob.insert(fa->seq_blob.end(), line, line + len);
      seq_len_cur += static_cast<int64_t>(len);
    }
    i = next;
  }
  close_rec();
  fa->lens.resize(fa->n);
  for (int64_t r = 0; r < fa->n; r++)
    fa->lens[r] = fa->seq_off[r + 1] - fa->seq_off[r];
  return fa;
}

// Temp file in RAFT_TMPDIR > TMPDIR > /tmp; caller owns/unlinks.
int make_temp_fd(std::string* out_path) {
  const char* dir = getenv("RAFT_TMPDIR");
  if (!dir || !*dir) dir = getenv("TMPDIR");
  if (!dir || !*dir) dir = "/tmp";
  std::string tmpl = std::string(dir) + "/raft_decomp_XXXXXX";
  std::vector<char> t(tmpl.begin(), tmpl.end());
  t.push_back('\0');
  int fd = mkstemp(t.data());
  if (fd >= 0) out_path->assign(t.data());
  return fd;
}

bool write_full(int fd, const char* p, size_t n);  // defined below

// One background writer thread with a single pending buffer: the
// producer inflates the NEXT window while this thread writes the
// previous one — decompress and disk write overlap instead of running
// serially (the old gz index path inflated the WHOLE input into RAM,
// then wrote it back: a full-input RAM spike plus inflate+write in
// sequence; at 12.4 GB that is ~2x the unavoidable wall).
class PendingWriter {
 public:
  explicit PendingWriter(int fd) : fd_(fd) {
    th_ = std::thread([this]() { run(); });
  }
  // blocks until the previous buffer is on disk; false on write error
  bool submit(std::vector<char>&& buf) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [this]() { return !has_ || fail_; });
    if (fail_) return false;
    pend_ = std::move(buf);
    has_ = true;
    cv_.notify_all();
    return true;
  }
  bool finish() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [this]() { return !has_ || fail_; });
    stop_ = true;
    cv_.notify_all();
    lk.unlock();
    th_.join();
    return !fail_;
  }
  ~PendingWriter() {
    if (th_.joinable()) finish();
  }

 private:
  void run() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [this]() { return has_ || stop_; });
      if (has_) {
        std::vector<char> buf;
        buf.swap(pend_);
        has_ = false;
        cv_.notify_all();
        lk.unlock();
        bool ok = write_full(fd_, buf.data(), buf.size());
        lk.lock();
        if (!ok) {
          fail_ = true;
          cv_.notify_all();
        }
      } else if (stop_) {
        return;
      }
    }
  }
  int fd_;
  std::thread th_;
  std::vector<char> pend_;
  bool has_ = false, fail_ = false, stop_ = false;
  std::mutex mu_;
  std::condition_variable cv_;
};

// BGZF → fd: inflate 64 MB windows of blocks in parallel, write each
// window while the next inflates. Bounded memory (2 windows).
// Returns 0 ok; 1 corrupt/failed INFLATE (caller may fall back to the
// streaming gzread path); 2 disk-WRITE failure (falling back would just
// re-fail after minutes of serial inflate — caller must abort).
int bgzf_inflate_to_fd(const char* p, const std::vector<BgzfBlock>& blocks,
                       int fd) {
  const int T = n_parse_threads();
  PendingWriter w(fd);
  const size_t WIN_BYTES = 64u << 20;
  const size_t B = blocks.size();
  size_t k = 0;
  bool ok = true;
  bool write_failed = false;
  while (k < B && ok) {
    size_t k2 = k, bytes = 0;
    const size_t base = blocks[k].out_off;
    while (k2 < B && bytes < WIN_BYTES) bytes += blocks[k2++].isize;
    std::vector<char> buf(bytes);
    std::vector<char> fail(static_cast<size_t>(T), 0);
    std::vector<std::thread> threads;
    const size_t nb = k2 - k;
    for (int t = 0; t < T; t++) {
      threads.emplace_back([&, t]() {
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) {
          fail[t] = 1;
          return;
        }
        for (size_t j = k + nb * t / T; j < k + nb * (t + 1) / T; j++) {
          const BgzfBlock& b = blocks[j];
          if (b.isize == 0) continue;
          inflateReset(&zs);
          zs.next_in = reinterpret_cast<Bytef*>(
              const_cast<char*>(p + b.off + b.data_off));
          zs.avail_in = b.comp_len;
          zs.next_out = reinterpret_cast<Bytef*>(
              buf.data() + (b.out_off - base));
          zs.avail_out = b.isize;
          int r = inflate(&zs, Z_FINISH);
          if (r != Z_STREAM_END || zs.avail_out != 0) {
            fail[t] = 1;
            break;
          }
        }
        inflateEnd(&zs);
      });
    }
    for (auto& th : threads) th.join();
    for (int t = 0; t < T; t++)
      if (fail[t]) ok = false;
    if (ok && !w.submit(std::move(buf))) {
      ok = false;
      write_failed = true;
    }
    k = k2;
  }
  if (!w.finish()) write_failed = true;
  if (write_failed) return 2;
  return ok ? 0 : 1;
}

// Plain gz → fd: single-stream gzread (inherently serial) but the disk
// write of chunk k overlaps the inflate of chunk k+1.
bool gz_stream_to_fd(const char* path, int fd) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, 1 << 20);
  PendingWriter w(fd);
  bool ok = true;
  for (;;) {
    std::vector<char> chunk(8u << 20);
    int r = gzread(f, chunk.data(), static_cast<unsigned>(chunk.size()));
    if (r < 0) {
      ok = false;
      break;
    }
    if (r == 0) break;
    chunk.resize(static_cast<size_t>(r));
    if (!w.submit(std::move(chunk))) {
      ok = false;
      break;
    }
  }
  gzclose(f);
  bool wok = w.finish();
  return ok && wok;
}

// Whole gz file → temp file, bounded memory: BGZF block-parallel with
// overlapped writes, else streaming gzread with overlapped writes.
bool stream_decomp_to_temp(const char* path, const char* p, size_t n,
                           std::string* out) {
  int fd = make_temp_fd(out);
  if (fd < 0) return false;
  bool ok = false;
  bool tried_bgzf = false;
  {
    std::vector<BgzfBlock> blocks;
    size_t total = 0;
    if (bgzf_index(p, n, &blocks, &total)) {
      tried_bgzf = true;
      int rc = bgzf_inflate_to_fd(p, blocks, fd);
      ok = rc == 0;
      if (rc == 2) {
        // disk-write failure: a serial-gzread retry onto the same disk
        // is doomed and would burn minutes of inflate first — abort
        close(fd);
        unlink(out->c_str());
        out->clear();
        return false;
      }
    }
  }
  if (!ok) {
    if (tried_bgzf &&
        (lseek(fd, 0, SEEK_SET) != 0 || ftruncate(fd, 0) != 0)) {
      close(fd);
      unlink(out->c_str());
      out->clear();
      return false;
    }
    ok = gz_stream_to_fd(path, fd);
  }
  close(fd);
  if (!ok) {
    unlink(out->c_str());
    out->clear();
  }
  return ok;
}

}  // namespace

extern "C" {

RaftFasta* raftio_load_fasta(const char* path) {
  {
    auto* src = new Source();
    if (open_source(path, src) && src->n > mt_threshold() &&
        src->p[0] == '>') {
      RaftFasta* fa = load_fasta_threaded_range(src->p, src->n, 0, src->n,
                                                /*allow_zc=*/true);
      if (fa) {
        if (fa->ext_seq) {
          fa->src = src;  // sequences point into the source buffer
        } else {
          delete src;
        }
        return fa;
      }
    }
    delete src;
  }
  LineReader rd(path);
  if (!rd.ok()) return nullptr;
  auto* fa = new RaftFasta();
  fa->name_off.push_back(0);
  fa->seq_off.push_back(0);

  static const std::regex sim_re(
      "^read=[0-9]+,[a-z]+,position=[0-9]+-[0-9]+,length=[0-9]+,(.*)");

  bool have_rec = false;
  bool in_fastq = false;
  bool skipping_qual = false;
  int64_t seq_len_cur = 0;
  int64_t qual_len = 0;
  std::string cur_name;

  auto flush = [&]() {
    if (!have_rec) return;
    if (fa->n == 0) {
      if (std::regex_match(cur_name, sim_re)) fa->real_reads = 0;
    }
    fa->interner.intern(cur_name.data(), cur_name.size());
    fa->name_blob.insert(fa->name_blob.end(), cur_name.begin(),
                         cur_name.end());
    fa->name_blob.push_back('\0');
    fa->name_off.push_back(static_cast<int64_t>(fa->name_blob.size()));
    fa->seq_off.push_back(static_cast<int64_t>(fa->seq_blob.size()));
    fa->n++;
    have_rec = false;
  };

  const char* s;
  size_t len;
  while (rd.next(&s, &len)) {
    if (skipping_qual) {
      qual_len += static_cast<int64_t>(len);
      if (qual_len >= seq_len_cur) skipping_qual = false;
      continue;
    }
    if (len && (s[0] == '>' || s[0] == '@')) {
      flush();
      // name = first whitespace-delimited token after the marker
      size_t b = 1;
      while (b < len && isspace(static_cast<unsigned char>(s[b]))) b++;
      size_t e = b;
      while (e < len && !isspace(static_cast<unsigned char>(s[e]))) e++;
      cur_name.assign(s + b, e - b);
      have_rec = true;
      in_fastq = (s[0] == '@');
    } else if (len && s[0] == '+' && in_fastq) {
      seq_len_cur = static_cast<int64_t>(fa->seq_blob.size()) -
                    fa->seq_off.back();
      qual_len = 0;
      if (seq_len_cur > 0) {
        skipping_qual = true;
      } else {
        flush();
      }
    } else if (len) {
      if (have_rec)
        fa->seq_blob.insert(fa->seq_blob.end(), s, s + len);
    }
  }
  flush();
  fa->lens.resize(fa->n);
  for (int64_t i = 0; i < fa->n; i++)
    fa->lens[i] = fa->seq_off[i + 1] - fa->seq_off[i];
  return fa;
}

RaftFasta* raftio_index_fasta(const char* path) {
  Mapped m;
  if (!map_file(path, &m)) return nullptr;
  if (!m.n || m.p[0] != '>') return nullptr;  // plain FASTA only
  return index_fasta_threaded(m.p, m.n);
}

// Index ANY supported input for streaming: plain FASTA (threaded index),
// FASTQ or mixed fastx (sequential kseq-semantics scan), and gz of either
// (decompressed once to a temp file the handle owns — rec_off then index
// that file, so chunk loads stay byte-range mmap reads). Mixed files
// STARTING with '>' take the threaded pure-FASTA path (same assumption
// as raftio_load_fasta's fast path).
RaftFasta* raftio_index_fastx(const char* path) {
  Mapped m;
  if (!map_file(path, &m) || !m.n) return nullptr;
  const bool is_gz = m.n >= 2 &&
                     static_cast<uint8_t>(m.p[0]) == 0x1f &&
                     static_cast<uint8_t>(m.p[1]) == 0x8b;
  const char* p = m.p;
  size_t n = m.n;
  std::string decomp;
  Mapped dm;
  if (is_gz) {
    // stream-decompress to the handle's temp file (bounded memory;
    // BGZF inflates block-parallel, plain gz single-stream — either
    // way the disk write overlaps the inflate) and index the MAPPED
    // temp file. Replaces inflate-everything-into-RAM + write-back:
    // at 12.4 GB that was a full-input RAM spike plus the inflate and
    // the write in sequence (SCALE_r05 gz section).
    if (!stream_decomp_to_temp(path, m.p, m.n, &decomp)) return nullptr;
    if (!map_file(decomp.c_str(), &dm) || !dm.n) {
      unlink(decomp.c_str());
      return nullptr;
    }
    p = dm.p;
    n = dm.n;
  }
  RaftFasta* fa = nullptr;
  if (p[0] == '>') {
    fa = index_fasta_threaded(p, n);
  } else if (p[0] == '@') {
    fa = new RaftFasta();
    index_fastx_buf(p, n, fa);
  }
  if (!fa) {
    if (!decomp.empty()) unlink(decomp.c_str());
    return nullptr;
  }
  fa->decomp_path = decomp;
  return fa;
}

const char* rf_decomp_path(RaftFasta* fa) { return fa->decomp_path.c_str(); }
int rf_has_fastq(RaftFasta* fa) { return fa->has_fastq ? 1 : 0; }

static RaftFasta* load_range_common(const char* path, int64_t lo,
                                    int64_t hi, int fastq) {
  auto* src = new Source();
  if (!map_file(path, &src->m)) {
    delete src;
    return nullptr;
  }
  src->p = src->m.p;
  src->n = src->m.n;
  if (static_cast<size_t>(hi) > src->n || lo < 0 || lo >= hi) {
    delete src;
    return nullptr;
  }
  RaftFasta* fa =
      fastq ? load_fastx_buf_range(src->p, src->n, static_cast<size_t>(lo),
                                   static_cast<size_t>(hi))
            : load_fasta_threaded_range(src->p, src->n,
                                        static_cast<size_t>(lo),
                                        static_cast<size_t>(hi),
                                        /*allow_zc=*/true);
  if (fa && fa->ext_seq) {
    fa->src = src;
  } else {
    delete src;
  }
  return fa;
}

RaftFasta* raftio_load_fasta_range(const char* path, int64_t lo,
                                   int64_t hi) {
  return load_range_common(path, lo, hi, 0);
}

// Byte-range load with fastx (FASTQ/mixed) record support; `fastq` != 0
// routes to the sequential kseq-semantics parser (range boundaries come
// from the index, so the parse needs no record-start guessing).
RaftFasta* raftio_load_fastx_range(const char* path, int64_t lo,
                                   int64_t hi, int fastq) {
  return load_range_common(path, lo, hi, fastq);
}

const int64_t* rf_rec_off(RaftFasta* fa) { return fa->rec_off.data(); }

void raftio_free_fasta(RaftFasta* fa) {
  if (fa && !fa->decomp_path.empty()) unlink(fa->decomp_path.c_str());
  delete fa;
}
int64_t rf_n_reads(RaftFasta* fa) { return fa->n; }
int rf_real_reads(RaftFasta* fa) { return fa->real_reads; }
const char* rf_name_blob(RaftFasta* fa) { return fa->name_blob.data(); }
int64_t rf_name_blob_size(RaftFasta* fa) {
  return static_cast<int64_t>(fa->name_blob.size());
}
const int64_t* rf_name_off(RaftFasta* fa) { return fa->name_off.data(); }
const char* rf_seq_blob(RaftFasta* fa) {
  return fa->ext_seq ? fa->ext_seq : fa->seq_blob.data();
}
const int64_t* rf_lens(RaftFasta* fa) { return fa->lens.data(); }
int rf_zero_copy(RaftFasta* fa) { return fa->ext_seq ? 1 : 0; }
const int64_t* rf_seq_off(RaftFasta* fa) { return fa->seq_off.data(); }

// ---------------------------------------------------------------------------
// PAF
// ---------------------------------------------------------------------------
struct RaftPaf {
  std::vector<int32_t> a_id, b_id, a_s, a_e, b_s, b_e;
  int symmetric = 0;
  int64_t n_names = 0;
};

namespace {

struct PafRow {
  int32_t a, b, as_, ae, bs, be;
  bool valid;
};

inline PafRow parse_paf_line(const char* s, size_t len, const Interner& in) {
  PafRow r{0, 0, 0, 0, 0, 0, false};
  const char* col[10];
  size_t clen[10];
  int nc = 0;
  const char* p = s;
  const char* endp = s + len;
  while (nc < 10) {
    const char* t = static_cast<const char*>(memchr(p, '\t', endp - p));
    col[nc] = p;
    clen[nc] = (t ? t : endp) - p;
    nc++;
    if (!t) break;
    p = t + 1;
  }
  if (nc < 10) return r;  // also requires a 10th column present
  auto toi = [](const char* q, size_t n) -> int64_t {
    int64_t v = 0;
    size_t i = 0;
    bool neg = false;
    if (i < n && (q[i] == '-' || q[i] == '+')) neg = (q[i++] == '-');
    for (; i < n && q[i] >= '0' && q[i] <= '9'; i++)
      v = v * 10 + (q[i] - '0');
    return neg ? -v : v;
  };
  r.as_ = static_cast<int32_t>(toi(col[2], clen[2]));
  r.ae = static_cast<int32_t>(toi(col[3], clen[3]));
  r.bs = static_cast<int32_t>(toi(col[7], clen[7]));
  r.be = static_cast<int32_t>(toi(col[8], clen[8]));
  r.a = in.lookup(col[0], clen[0]);
  r.b = in.lookup(col[5], clen[5]);
  r.valid = true;
  return r;
}

struct PafLocal {
  std::vector<int32_t> a_id, b_id, a_s, a_e, b_s, b_e;
  bool mirror = false;
  int64_t unknown = 0;
};

void parse_paf_region(const char* p, size_t n, size_t lo, size_t hi,
                      const Interner* in, PafRow row0, size_t row0_off,
                      PafLocal* out) {
  size_t i = lo;
  if (lo != 0) {
    const char* q = static_cast<const char*>(memchr(p + lo - 1, '\n',
                                                    n - (lo - 1)));
    if (!q) return;
    i = static_cast<size_t>(q - p) + 1;
  }
  while (i < hi && i < n) {
    size_t line_off = i;
    const char* line = p + i;
    const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
    size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
    size_t len = line_len(line, llen);
    i = nl ? static_cast<size_t>(nl - p) + 1 : n;
    PafRow r = parse_paf_line(line, len, *in);
    if (!r.valid) continue;
    if (r.a < 0 || r.b < 0) out->unknown++;
    bool is_row0 = line_off == row0_off;
    if (!is_row0 && r.a >= 0 && r.b >= 0 &&
        row0.a == r.b && row0.b == r.a && row0.as_ == r.bs &&
        row0.ae == r.be && row0.bs == r.as_ && row0.be == r.ae)
      out->mirror = true;
    out->a_id.push_back(r.a);
    out->b_id.push_back(r.b);
    out->a_s.push_back(r.as_);
    out->a_e.push_back(r.ae);
    out->b_s.push_back(r.bs);
    out->b_e.push_back(r.be);
  }
}

RaftPaf* load_paf_threaded(const char* p, size_t n, RaftFasta* fa) {
  // row 0 = first valid (>=10 col) row, needed by every thread's mirror
  // test; identified by byte offset so no thread ever compares it to
  // itself (the reference skips exactly record 0, chop.hpp:171-184)
  PafRow row0{0, 0, 0, 0, 0, 0, false};
  size_t row0_off = 0;
  {
    size_t i = 0;
    while (i < n && !row0.valid) {
      row0_off = i;
      const char* line = p + i;
      const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
      size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
      row0 = parse_paf_line(line, line_len(line, llen), fa->interner);
      i = nl ? static_cast<size_t>(nl - p) + 1 : n;
    }
    if (!row0.valid || row0.a < 0 || row0.b < 0)
      return nullptr;  // unknown names in row 0 → streaming path interns
  }

  const int T = n_parse_threads();
  std::vector<PafLocal> locals(T);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; t++) {
    size_t lo = n * t / T;
    size_t hi = n * (t + 1) / T;
    threads.emplace_back(parse_paf_region, p, n, lo, hi, &fa->interner,
                         row0, row0_off, &locals[t]);
  }
  for (auto& th : threads) th.join();

  int64_t unknown = 0;
  size_t total = 0;
  bool mirror = false;
  for (auto& L : locals) {
    unknown += L.unknown;
    total += L.a_id.size();
    mirror |= L.mirror;
  }
  if (unknown) return nullptr;  // fall back: streaming path interns them

  auto* pf = new RaftPaf();
  auto fill = [&](std::vector<int32_t> RaftPaf::*col,
                  std::vector<int32_t> PafLocal::*lcol) {
    (pf->*col).resize(total);
    size_t off = 0;
    for (auto& L : locals) {
      if (!(L.*lcol).empty())
        memcpy((pf->*col).data() + off, (L.*lcol).data(),
               (L.*lcol).size() * sizeof(int32_t));
      off += (L.*lcol).size();
    }
  };
  fill(&RaftPaf::a_id, &PafLocal::a_id);
  fill(&RaftPaf::b_id, &PafLocal::b_id);
  fill(&RaftPaf::a_s, &PafLocal::a_s);
  fill(&RaftPaf::a_e, &PafLocal::a_e);
  fill(&RaftPaf::b_s, &PafLocal::b_s);
  fill(&RaftPaf::b_e, &PafLocal::b_e);
  pf->symmetric = mirror ? 1 : 0;
  pf->n_names = static_cast<int64_t>(fa->interner.size());
  return pf;
}

}  // namespace

// ---------------------------------------------------------------------------
// Two-phase PAF load. Phase 1 (preparse) tokenizes columns and interns
// names into THREAD-LOCAL interners — it has no dependency on the FASTA
// parse, so the pipeline runs both concurrently. Phase 2 (resolve) maps
// each DISTINCT local name onto the global interner (one lookup per
// distinct name instead of two per row) and interns names absent from
// the FASTA in exact file first-seen order, which is the reference's
// behavior (create_pileup interns PAF names too, chop.hpp:160-163).
// ---------------------------------------------------------------------------
// Thread-local interner for the preparse phase: same fast map (ids in
// region-encounter order; .names consumed by raftio_resolve_paf).
using LocalInterner = Interner;

struct PafPreLocal {
  std::vector<int32_t> a_id, b_id, a_s, a_e, b_s, b_e;
  LocalInterner in;
  bool mirror = false;
};

struct RaftPafPre {
  std::vector<PafPreLocal> locals;
};

namespace {

struct PafRowS {  // tokenized row with name VIEWS (no interner)
  const char* qn;
  size_t qn_len;
  const char* tn;
  size_t tn_len;
  int32_t as_, ae, bs, be;
  bool valid;
};

inline PafRowS parse_paf_line_s(const char* s, size_t len) {
  PafRowS r{nullptr, 0, nullptr, 0, 0, 0, 0, 0, false};
  const char* col[10];
  size_t clen[10];
  int nc = 0;
  const char* p = s;
  const char* endp = s + len;
  while (nc < 10) {
    const char* t = static_cast<const char*>(memchr(p, '\t', endp - p));
    col[nc] = p;
    clen[nc] = (t ? t : endp) - p;
    nc++;
    if (!t) break;
    p = t + 1;
  }
  if (nc < 10) return r;
  auto toi = [](const char* q, size_t n) -> int64_t {
    int64_t v = 0;
    size_t i = 0;
    bool neg = false;
    if (i < n && (q[i] == '-' || q[i] == '+')) neg = (q[i++] == '-');
    for (; i < n && q[i] >= '0' && q[i] <= '9'; i++)
      v = v * 10 + (q[i] - '0');
    return neg ? -v : v;
  };
  r.qn = col[0];
  r.qn_len = clen[0];
  r.tn = col[5];
  r.tn_len = clen[5];
  r.as_ = static_cast<int32_t>(toi(col[2], clen[2]));
  r.ae = static_cast<int32_t>(toi(col[3], clen[3]));
  r.bs = static_cast<int32_t>(toi(col[7], clen[7]));
  r.be = static_cast<int32_t>(toi(col[8], clen[8]));
  r.valid = true;
  return r;
}

void preparse_paf_region(const char* p, size_t n, size_t lo, size_t hi,
                         const PafRowS& row0, size_t row0_off,
                         PafPreLocal* out) {
  size_t i = lo;
  if (lo != 0) {
    const char* q = static_cast<const char*>(memchr(p + lo - 1, '\n',
                                                    n - (lo - 1)));
    if (!q) return;
    i = static_cast<size_t>(q - p) + 1;
  }
  const char* mq = nullptr;  // last-qn/tn memo (see below)
  const char* mt = nullptr;
  size_t mq_len = 0, mt_len = 0;
  int32_t mq_id = 0, mt_id = 0;
  // Rows parse in batches: tokenize + hash a batch, PREFETCH every
  // row's probe slots, then intern with the precomputed hashes. At
  // millions of distinct names the interner's probe arrays dwarf the
  // caches and the un-batched loop stalled on one dependent miss per
  // lookup; batching overlaps ~2*BATCH misses (measured 86 s -> see
  // SCALE_r05 many_small_reads for the 139M-row corner).
  constexpr int BATCH = 24;
  struct RowBuf {
    PafRowS r;
    size_t line_off;
    uint64_t qh, th;
  };
  RowBuf bb[BATCH];
  while (i < hi && i < n) {
    int nb = 0;
    while (nb < BATCH && i < hi && i < n) {
      size_t line_off = i;
      const char* line = p + i;
      const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
      size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
      size_t len = line_len(line, llen);
      i = nl ? static_cast<size_t>(nl - p) + 1 : n;
      PafRowS r = parse_paf_line_s(line, len);
      if (!r.valid) continue;
      bb[nb].r = r;
      bb[nb].line_off = line_off;
      nb++;
    }
    for (int k = 0; k < nb; k++) {
      bb[k].qh = Interner::hash_bytes(bb[k].r.qn, bb[k].r.qn_len);
      bb[k].th = Interner::hash_bytes(bb[k].r.tn, bb[k].r.tn_len);
      out->in.prefetch(bb[k].qh);
      out->in.prefetch(bb[k].th);
    }
    for (int k = 0; k < nb; k++) {
      const PafRowS& r = bb[k].r;
      // mirror-of-row-0 test (chop.hpp:175-184) on raw names: coords
      // first (cheap reject), then the two name compares
      if (bb[k].line_off != row0_off && row0.valid &&
          row0.as_ == r.bs && row0.ae == r.be && row0.bs == r.as_ &&
          row0.be == r.ae && row0.qn_len == r.tn_len &&
          row0.tn_len == r.qn_len &&
          memcmp(row0.qn, r.tn, r.tn_len) == 0 &&
          memcmp(row0.tn, r.qn, r.qn_len) == 0)
        out->mirror = true;
      // run-length memo: ava PAFs are query-grouped (hifiasm/minimap2
      // emit all rows of a query consecutively), so consecutive rows
      // usually repeat qn — one memcmp replaces the hash+probe
      if (mq && mq_len == r.qn_len && memcmp(mq, r.qn, mq_len) == 0) {
        out->a_id.push_back(mq_id);
      } else {
        mq_id = out->in.intern_h(r.qn, r.qn_len, bb[k].qh);
        mq = r.qn;
        mq_len = r.qn_len;
        out->a_id.push_back(mq_id);
      }
      if (mt && mt_len == r.tn_len && memcmp(mt, r.tn, mt_len) == 0) {
        out->b_id.push_back(mt_id);
      } else {
        mt_id = out->in.intern_h(r.tn, r.tn_len, bb[k].th);
        mt = r.tn;
        mt_len = r.tn_len;
        out->b_id.push_back(mt_id);
      }
      out->a_s.push_back(r.as_);
      out->a_e.push_back(r.ae);
      out->b_s.push_back(r.bs);
      out->b_e.push_back(r.be);
    }
  }
}

}  // namespace

extern "C" {

RaftPafPre* raftio_preparse_paf(const char* path) {
  Source src;
  if (!open_source(path, &src) || !src.n) return nullptr;
  const char* p = src.p;
  const size_t n = src.n;
  // row 0 = first valid row of the FILE, needed by every thread's
  // mirror test; identified by byte offset
  PafRowS row0{nullptr, 0, nullptr, 0, 0, 0, 0, 0, false};
  size_t row0_off = 0;
  {
    size_t i = 0;
    while (i < n && !row0.valid) {
      row0_off = i;
      const char* line = p + i;
      const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
      size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
      row0 = parse_paf_line_s(line, line_len(line, llen));
      i = nl ? static_cast<size_t>(nl - p) + 1 : n;
    }
  }
  auto* pre = new RaftPafPre();
  const int T = n_parse_threads();
  pre->locals.resize(T);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; t++) {
    size_t lo = n * t / T;
    size_t hi = n * (t + 1) / T;
    threads.emplace_back(preparse_paf_region, p, n, lo, hi, row0,
                         row0_off, &pre->locals[t]);
  }
  for (auto& th : threads) th.join();
  return pre;
}

void raftio_free_pafpre(RaftPafPre* pre) { delete pre; }

// Resolve local ids against the global interner. Unknown names intern in
// exact file first-seen order (regions merge in order; within a region
// local-id order IS encounter order).
RaftPaf* raftio_resolve_paf(RaftPafPre* pre, RaftFasta* fa) {
  if (!pre || !fa) return nullptr;
  auto* pf = new RaftPaf();
  size_t total = 0;
  bool mirror = false;
  for (auto& L : pre->locals) {
    total += L.a_id.size();
    mirror |= L.mirror;
  }
  pf->a_id.resize(total);
  pf->b_id.resize(total);
  pf->a_s.resize(total);
  pf->a_e.resize(total);
  pf->b_s.resize(total);
  pf->b_e.resize(total);
  size_t off = 0;
  for (auto& L : pre->locals) {
    std::vector<int32_t> remap(L.in.names.size());
    // same batched-hash + prefetch treatment as the preparse loop:
    // at millions of distinct names the global interner's probe
    // arrays miss on every call
    {
      constexpr size_t RB = 24;
      uint64_t hs[RB];
      const size_t nn = L.in.names.size();
      for (size_t k0 = 0; k0 < nn; k0 += RB) {
        const size_t k1 = std::min(k0 + RB, nn);
        for (size_t k = k0; k < k1; k++) {
          hs[k - k0] = Interner::hash_bytes(L.in.names[k].data(),
                                            L.in.names[k].size());
          fa->interner.prefetch(hs[k - k0]);
        }
        for (size_t k = k0; k < k1; k++)
          remap[k] = fa->interner.intern_h(L.in.names[k].data(),
                                           L.in.names[k].size(),
                                           hs[k - k0]);
      }
    }
    const size_t m = L.a_id.size();
    for (size_t r = 0; r < m; r++) {
      if (r + 16 < m) {
        __builtin_prefetch(&remap[L.a_id[r + 16]]);
        __builtin_prefetch(&remap[L.b_id[r + 16]]);
      }
      pf->a_id[off + r] = remap[L.a_id[r]];
      pf->b_id[off + r] = remap[L.b_id[r]];
    }
    memcpy(pf->a_s.data() + off, L.a_s.data(), m * sizeof(int32_t));
    memcpy(pf->a_e.data() + off, L.a_e.data(), m * sizeof(int32_t));
    memcpy(pf->b_s.data() + off, L.b_s.data(), m * sizeof(int32_t));
    memcpy(pf->b_e.data() + off, L.b_e.data(), m * sizeof(int32_t));
    off += m;
  }
  pf->symmetric = mirror ? 1 : 0;
  pf->n_names = static_cast<int64_t>(fa->interner.size());
  return pf;
}

}  // extern "C"

RaftPaf* raftio_load_paf(const char* path, RaftFasta* fa) {
  {
    Source src;
    if (open_source(path, &src) && src.n > mt_threshold()) {
      RaftPaf* pf = load_paf_threaded(src.p, src.n, fa);
      if (pf) return pf;
    }
  }
  LineReader rd(path);
  if (!rd.ok()) return nullptr;
  auto* pf = new RaftPaf();
  Interner& in = fa->interner;

  bool have_first = false;
  int32_t f_a = 0, f_b = 0, f_as = 0, f_ae = 0, f_bs = 0, f_be = 0;
  bool check_sym = true;
  bool symmetric = false;

  const char* s;
  size_t len;
  const char* col[16];
  size_t clen[16];
  while (rd.next(&s, &len)) {
    // split on tabs, need at least 10 columns (paf.hpp:84-86)
    int nc = 0;
    const char* p = s;
    const char* endp = s + len;
    while (nc < 16) {
      const char* t = static_cast<const char*>(memchr(p, '\t', endp - p));
      col[nc] = p;
      clen[nc] = (t ? t : endp) - p;
      nc++;
      if (!t) break;
      p = t + 1;
    }
    if (nc < 10) continue;

    auto toi = [](const char* q, size_t n) -> int64_t {
      int64_t v = 0;
      size_t i = 0;
      bool neg = false;
      if (i < n && (q[i] == '-' || q[i] == '+')) neg = (q[i++] == '-');
      for (; i < n && q[i] >= '0' && q[i] <= '9'; i++) v = v * 10 + (q[i] - '0');
      return neg ? -v : v;
    };

    int32_t qs = static_cast<int32_t>(toi(col[2], clen[2]));
    int32_t qe = static_cast<int32_t>(toi(col[3], clen[3]));
    int32_t ts = static_cast<int32_t>(toi(col[7], clen[7]));
    int32_t te = static_cast<int32_t>(toi(col[8], clen[8]));
    int32_t ai = in.intern(col[0], clen[0]);
    int32_t bi = in.intern(col[5], clen[5]);

    if (!have_first) {
      have_first = true;
      f_a = ai; f_b = bi; f_as = qs; f_ae = qe; f_bs = ts; f_be = te;
    } else if (check_sym && !symmetric) {
      if (f_a == bi && f_b == ai && f_as == ts && f_ae == te &&
          f_bs == qs && f_be == qe) {
        symmetric = true;
        check_sym = false;
      }
    }
    pf->a_id.push_back(ai);
    pf->b_id.push_back(bi);
    pf->a_s.push_back(qs);
    pf->a_e.push_back(qe);
    pf->b_s.push_back(ts);
    pf->b_e.push_back(te);
  }
  pf->symmetric = symmetric ? 1 : 0;
  pf->n_names = static_cast<int64_t>(in.size());
  return pf;
}

// ---------------------------------------------------------------------------
// Grouped coverage events: six PAF columns → read-grouped, window-binned
// events in one counting-sort pass. Event semantics mirror the reference:
// every row contributes its A side (repeat.hpp:50-53); the B side only
// when the PAF is not symmetric and a_id != b_id (chop.hpp:166-169 +
// repeat.hpp:54-58; self-overlaps count once). Rows naming reads absent
// from the FASTA are dropped per side and counted (reference UB:
// chop.hpp:165 vs sizing at chop.hpp:361-364); kept events with lo < 0 or
// end > read length are counted as out-of-bounds (reference UB:
// repeat.hpp:69-73) so the caller can enforce strict mode. Within a read,
// event order is row order (A/B interleaved) — every consumer
// (scatter-add pileup, diff+cumsum render) is order-independent.
// ---------------------------------------------------------------------------
struct RaftGroupedEv {
  std::vector<int64_t> off;   // [n_reads + 1] exclusive per-read offsets
  std::vector<int32_t> w0, w1;  // [m] binned windows (w1 inclusive; -1 empty)
  int64_t n_unknown = 0;  // unknown-name sides over all rows (both sides)
  int64_t n_oob = 0;      // kept events violating 0 <= lo, end <= len
};

static inline int32_t floordiv32(int64_t a, int32_t b) {
  int64_t q = a / b, r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) q--;
  return static_cast<int32_t>(q);
}

RaftGroupedEv* raftio_group_events(
    const int32_t* a_id, const int32_t* b_id,
    const int32_t* a_s, const int32_t* a_e,
    const int32_t* b_s, const int32_t* b_e,
    int64_t n_rows, int symmetric,
    int64_t n_reads, const int64_t* lens, int32_t reso) {
  auto* g = new RaftGroupedEv();
  g->off.assign(static_cast<size_t>(n_reads) + 1, 0);
  int64_t* cnt = g->off.data() + 1;  // counts accumulate at off[1..n]
  // counting-sort passes touch cnt/cur at RANDOM read ids: at millions
  // of reads those arrays miss on every access — prefetch 16 rows
  // ahead (same fix as the interner probes, SCALE_r05 hotspot)
  constexpr int64_t PD = 16;
  for (int64_t r = 0; r < n_rows; r++) {
    if (r + PD < n_rows) {
      const int32_t pa = a_id[r + PD], pb = b_id[r + PD];
      if (pa >= 0 && pa < n_reads) __builtin_prefetch(&cnt[pa], 1);
      if (pb >= 0 && pb < n_reads) __builtin_prefetch(&cnt[pb], 1);
    }
    const int32_t a = a_id[r], b = b_id[r];
    if (a >= 0 && a < n_reads) cnt[a]++; else g->n_unknown++;
    if (b < 0 || b >= n_reads) g->n_unknown++;
    else if (!symmetric && a != b) cnt[b]++;
  }
  for (int64_t i = 0; i < n_reads; i++) g->off[i + 1] += g->off[i];
  const int64_t m = g->off[n_reads];
  g->w0.resize(static_cast<size_t>(m));
  g->w1.resize(static_cast<size_t>(m));
  std::vector<int64_t> cur(g->off.begin(), g->off.end() - 1);
  int64_t oob = 0;
  auto put = [&](int32_t rid, int64_t lo, int64_t hi) {
    const int64_t k = cur[rid]++;
    g->w0[k] = floordiv32(lo, reso);  // numpy floor-division semantics
    // hi<0 -> w1=-1 matches EVERY python binning site (oracle.py:58,
    // engine_jax.py:657, bucketing.py:152 all np.where(hi<0, -1, ...)),
    // so --no-strict traces of garbage intervals are bit-identical by
    // path; guarded by test_native_io.py::test_negative_interval_binning
    g->w1[k] = hi < 0 ? -1 : static_cast<int32_t>(hi / reso);
    if (lo < 0 || hi >= lens[rid]) oob++;
  };
  for (int64_t r = 0; r < n_rows; r++) {
    if (r + PD < n_rows) {
      const int32_t pa = a_id[r + PD], pb = b_id[r + PD];
      if (pa >= 0 && pa < n_reads) __builtin_prefetch(&cur[pa], 1);
      if (pb >= 0 && pb < n_reads) __builtin_prefetch(&cur[pb], 1);
    }
    const int32_t a = a_id[r], b = b_id[r];
    if (a >= 0 && a < n_reads)
      put(a, a_s[r], static_cast<int64_t>(a_e[r]) - 1);
    if (!symmetric && a != b && b >= 0 && b < n_reads)
      put(b, b_s[r], static_cast<int64_t>(b_e[r]) - 1);
  }
  g->n_oob = oob;
  return g;
}

void raftio_free_grouped(RaftGroupedEv* g) { delete g; }
int64_t rge_n(RaftGroupedEv* g) {
  return static_cast<int64_t>(g->w0.size());
}
const int64_t* rge_off(RaftGroupedEv* g) { return g->off.data(); }
const int32_t* rge_w0(RaftGroupedEv* g) { return g->w0.data(); }
const int32_t* rge_w1(RaftGroupedEv* g) { return g->w1.data(); }
int64_t rge_n_unknown(RaftGroupedEv* g) { return g->n_unknown; }
int64_t rge_n_oob(RaftGroupedEv* g) { return g->n_oob; }

// Per-window coverage histogram over read-grouped window-binned events
// (the --auto-e est_cov estimator's input; raft_tpu/auto_e.py). Same
// per-read diff+cumsum reconstruction as raftio_emit_coverage_events'
// render, but reduced to a bincount — the O(total windows) coverage
// array itself is never materialized. hist[min(cov, hist_len-1)] += 1
// for every window; threaded over read ranges with per-thread
// histograms merged at the end. Returns 0 on success.
int raftio_cov_hist(const int32_t* w0, const int32_t* w1,
                    const int64_t* ev_off, const int64_t* lens,
                    int64_t n_reads, int32_t reso,
                    int64_t* hist, int64_t hist_len) {
  if (reso <= 0 || hist_len <= 0) return -1;
  std::fill(hist, hist + hist_len, 0);
  unsigned hw = std::thread::hardware_concurrency();
  int nth = static_cast<int>(std::min<unsigned>(hw ? hw : 1, 8));
  if (n_reads < 1024) nth = 1;
  std::vector<std::vector<int64_t>> th_hist(
      static_cast<size_t>(nth), std::vector<int64_t>(
          static_cast<size_t>(hist_len), 0));
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    int64_t lo_r = n_reads * t / nth, hi_r = n_reads * (t + 1) / nth;
    int64_t* h = th_hist[static_cast<size_t>(t)].data();
    std::vector<int32_t> diff;
    for (int64_t i = lo_r; i < hi_r; i++) {
      int64_t nw = (lens[i] + reso - 1) / reso;
      if (nw <= 0) continue;
      diff.assign(static_cast<size_t>(nw + 1), 0);
      for (int64_t j = ev_off[i]; j < ev_off[i + 1]; j++) {
        int64_t a = w0[j];
        int64_t b = w1[j];
        if (b < a || a < 0 || a >= nw) continue;
        if (b >= nw) b = nw - 1;
        diff[static_cast<size_t>(a)]++;
        diff[static_cast<size_t>(b + 1)]--;
      }
      int64_t c = 0;
      for (int64_t k = 0; k < nw; k++) {
        c += diff[static_cast<size_t>(k)];
        int64_t bin = c < 0 ? 0 : (c >= hist_len ? hist_len - 1 : c);
        h[bin]++;
      }
    }
  };
  for (int t = 1; t < nth; t++) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
  for (int t = 0; t < nth; t++)
    for (int64_t c = 0; c < hist_len; c++)
      hist[c] += th_hist[static_cast<size_t>(t)][static_cast<size_t>(c)];
  return 0;
}

void raftio_free_paf(RaftPaf* pf) { delete pf; }
int64_t rp_n_rows(RaftPaf* pf) { return static_cast<int64_t>(pf->a_id.size()); }
int rp_symmetric(RaftPaf* pf) { return pf->symmetric; }
int64_t rp_n_names(RaftPaf* pf) { return pf->n_names; }
const int32_t* rp_a_id(RaftPaf* pf) { return pf->a_id.data(); }
const int32_t* rp_b_id(RaftPaf* pf) { return pf->b_id.data(); }
const int32_t* rp_a_s(RaftPaf* pf) { return pf->a_s.data(); }
const int32_t* rp_a_e(RaftPaf* pf) { return pf->a_e.data(); }
const int32_t* rp_b_s(RaftPaf* pf) { return pf->b_s.data(); }
const int32_t* rp_b_e(RaftPaf* pf) { return pf->b_e.data(); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Binned PAF event spill (streaming mode).
//
// Bounds overlap-table residency for beyond-RAM inputs: instead of loading
// all rows into columns, a two-pass parse writes the coverage *events*
// (read_id, start, end_inclusive as 3x int32) grouped by owner-read chunk
// (bin k owns reads [k*chunk, (k+1)*chunk)) into two spill files — A-side
// events and B-side events — plus per-bin event offsets. The consumer reads
// one bin at a time; B-side events are ignored when the file turns out to
// be symmetric (reference rule: B-side coverage only when not symmetric,
// /root/reference/repeat.hpp:54-58, chop.hpp:166-169).
//
// The record-0-mirror symmetric test (/root/reference/chop.hpp:175-184)
// compares NAMES instead of interned ids here — equivalent because
// interning is injective — so rows naming reads absent from the FASTA
// need no id assignment (they are counted and dropped; the reference
// overruns its pileup array on such rows).
// ---------------------------------------------------------------------------
struct RaftPafBins {
  int64_t n_rows = 0;     // valid (>=10 column) rows seen
  int symmetric = 0;
  int64_t n_unknown = 0;  // per-side count of names absent from the FASTA
  int64_t n_bins = 0;
  std::vector<int64_t> a_off, b_off;  // [n_bins+1] event offsets per bin
};

namespace {

struct PafRowN {  // parsed row with name views (no interning)
  const char* qn;
  size_t qn_len;
  const char* tn;
  size_t tn_len;
  int32_t as_, ae, bs, be;
  bool valid;
};

inline PafRowN parse_paf_line_n(const char* s, size_t len) {
  PafRowN r{nullptr, 0, nullptr, 0, 0, 0, 0, 0, false};
  const char* col[10];
  size_t clen[10];
  int nc = 0;
  const char* p = s;
  const char* endp = s + len;
  while (nc < 10) {
    const char* t = static_cast<const char*>(memchr(p, '\t', endp - p));
    col[nc] = p;
    clen[nc] = (t ? t : endp) - p;
    nc++;
    if (!t) break;
    p = t + 1;
  }
  if (nc < 10) return r;
  auto toi = [](const char* q, size_t n) -> int64_t {
    int64_t v = 0;
    size_t i = 0;
    bool neg = false;
    if (i < n && (q[i] == '-' || q[i] == '+')) neg = (q[i++] == '-');
    for (; i < n && q[i] >= '0' && q[i] <= '9'; i++) v = v * 10 + (q[i] - '0');
    return neg ? -v : v;
  };
  r.qn = col[0];
  r.qn_len = clen[0];
  r.tn = col[5];
  r.tn_len = clen[5];
  r.as_ = static_cast<int32_t>(toi(col[2], clen[2]));
  r.ae = static_cast<int32_t>(toi(col[3], clen[3]));
  r.bs = static_cast<int32_t>(toi(col[7], clen[7]));
  r.be = static_cast<int32_t>(toi(col[8], clen[8]));
  r.valid = true;
  return r;
}

inline bool names_eq(const char* a, size_t an, const char* b, size_t bn) {
  return an == bn && memcmp(a, b, an) == 0;
}

inline bool row_is_mirror(const PafRowN& r0, const PafRowN& r) {
  return r0.as_ == r.bs && r0.ae == r.be && r0.bs == r.as_ &&
         r0.be == r.ae && names_eq(r0.qn, r0.qn_len, r.tn, r.tn_len) &&
         names_eq(r0.tn, r0.tn_len, r.qn, r.qn_len);
}

// Walk rows of [lo, hi) starting at the first line boundary >= lo
// (lo==0 starts immediately); calls fn(row, byte_offset) per valid row.
template <class F>
void walk_paf_region(const char* p, size_t n, size_t lo, size_t hi, F&& fn) {
  size_t i = lo;
  if (lo != 0) {
    const char* q =
        static_cast<const char*>(memchr(p + lo - 1, '\n', n - (lo - 1)));
    if (!q) return;
    i = static_cast<size_t>(q - p) + 1;
  }
  while (i < hi && i < n) {
    size_t off = i;
    const char* line = p + i;
    const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
    size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
    i = nl ? static_cast<size_t>(nl - p) + 1 : n;
    PafRowN r = parse_paf_line_n(line, line_len(line, llen));
    if (r.valid) fn(r, off);
  }
}

struct BinCounts {
  std::vector<int64_t> a, b;  // events per bin
  int64_t n_rows = 0, n_unknown = 0;
  bool mirror = false;
};

// Per-row pass-1 accounting shared by the mmap and gz paths.
inline void count_row(const PafRowN& r, size_t off, const PafRowN& row0,
                      size_t row0_off, bool have_row0, const Interner& in,
                      int64_t n_reads, int64_t chunk, BinCounts* L) {
  L->n_rows++;
  if (have_row0 && off != row0_off && row_is_mirror(row0, r))
    L->mirror = true;
  int32_t a = in.lookup(r.qn, r.qn_len);
  int32_t b = in.lookup(r.tn, r.tn_len);
  bool a_known = a >= 0 && a < n_reads;
  bool b_known = b >= 0 && b < n_reads;
  if (!a_known) L->n_unknown++;
  if (!b_known) L->n_unknown++;
  if (a_known) L->a[a / chunk]++;
  if (b_known && !names_eq(r.qn, r.qn_len, r.tn, r.tn_len))
    L->b[b / chunk]++;
}

ssize_t pwrite_full(int fd, const void* buf, size_t n, int64_t off) {
  const char* p = static_cast<const char*>(buf);
  size_t done = 0;
  while (done < n) {
    ssize_t w = pwrite(fd, p + done, n - done, off + done);
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) return -1;
    done += static_cast<size_t>(w);
  }
  return static_cast<ssize_t>(n);
}

// Buffered per-bin event writer into one pre-sized spill file at exact
// offsets (safe for concurrent threads: disjoint ranges, pwrite).
class BinWriter {
 public:
  BinWriter(int fd, std::vector<int64_t> start_ev, int cap_events)
      : fd_(fd), cursor_(std::move(start_ev)), bufs_(cursor_.size()),
        cap_(cap_events), failed_(false) {}

  void add(int64_t bin, int32_t id, int32_t lo, int32_t hi) {
    auto& b = bufs_[bin];
    if (b.capacity() == 0) b.reserve(3 * cap_);
    b.push_back(id);
    b.push_back(lo);
    b.push_back(hi);
    if (static_cast<int>(b.size() / 3) >= cap_) flush(bin);
  }
  void flush_all() {
    for (size_t k = 0; k < bufs_.size(); k++) flush(static_cast<int64_t>(k));
  }
  bool failed() const { return failed_; }

 private:
  void flush(int64_t bin) {
    auto& b = bufs_[bin];
    if (b.empty()) return;
    if (pwrite_full(fd_, b.data(), b.size() * sizeof(int32_t),
                    cursor_[bin] * 12) < 0)
      failed_ = true;
    cursor_[bin] += static_cast<int64_t>(b.size() / 3);
    b.clear();
  }
  int fd_;
  std::vector<int64_t> cursor_;
  std::vector<std::vector<int32_t>> bufs_;
  int cap_;
  bool failed_;
};

// Per-row pass-2 emission shared by the mmap and gz paths.
inline void emit_row(const PafRowN& r, const Interner& in, int64_t n_reads,
                     int64_t chunk, BinWriter* wa, BinWriter* wb) {
  int32_t a = in.lookup(r.qn, r.qn_len);
  int32_t b = in.lookup(r.tn, r.tn_len);
  if (a >= 0 && a < n_reads)
    wa->add(a / chunk, a, r.as_, r.ae - 1);
  if (b >= 0 && b < n_reads &&
      !names_eq(r.qn, r.qn_len, r.tn, r.tn_len))
    wb->add(b / chunk, b, r.bs, r.be - 1);
}

int buf_events_for(int T, int64_t n_bins) {
  // bound total staging memory at ~64 MB across all threads and bins
  int64_t per = (64LL << 20) / (static_cast<int64_t>(T) *
                                std::max<int64_t>(n_bins, 1) * 12);
  if (per < 64) per = 64;
  if (per > 4096) per = 4096;
  return static_cast<int>(per);
}

RaftPafBins* paf_bin_events_mmap(const char* p, size_t n,
                                 const Interner& in,
                                 int64_t n_reads, int64_t chunk,
                                 int fda, int fdb) {
  const int64_t n_bins = (n_reads + chunk - 1) / chunk;

  // row 0 = first valid row, identified by byte offset (the reference's
  // mirror test skips exactly record 0, chop.hpp:171-184)
  PafRowN row0{nullptr, 0, nullptr, 0, 0, 0, 0, 0, false};
  size_t row0_off = 0;
  {
    size_t i = 0;
    while (i < n && !row0.valid) {
      row0_off = i;
      const char* line = p + i;
      const char* nl = static_cast<const char*>(memchr(line, '\n', n - i));
      size_t llen = nl ? static_cast<size_t>(nl - line) : n - i;
      row0 = parse_paf_line_n(line, line_len(line, llen));
      i = nl ? static_cast<size_t>(nl - p) + 1 : n;
    }
  }

  const int T = n_parse_threads();
  std::vector<BinCounts> locals(T);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      locals[t].a.assign(n_bins, 0);
      locals[t].b.assign(n_bins, 0);
      size_t lo = n * t / T;
      size_t hi = n * (t + 1) / T;
      threads.emplace_back([&, t, lo, hi]() {
        walk_paf_region(p, n, lo, hi, [&](const PafRowN& r, size_t off) {
          count_row(r, off, row0, row0_off, row0.valid, in, n_reads, chunk,
                    &locals[t]);
        });
      });
    }
    for (auto& th : threads) th.join();
  }

  auto* out = new RaftPafBins();
  out->n_bins = n_bins;
  out->a_off.assign(n_bins + 1, 0);
  out->b_off.assign(n_bins + 1, 0);
  bool mirror = false;
  for (auto& L : locals) {
    out->n_rows += L.n_rows;
    out->n_unknown += L.n_unknown;
    mirror |= L.mirror;
    for (int64_t k = 0; k < n_bins; k++) {
      out->a_off[k + 1] += L.a[k];
      out->b_off[k + 1] += L.b[k];
    }
  }
  out->symmetric = mirror ? 1 : 0;
  for (int64_t k = 0; k < n_bins; k++) {
    out->a_off[k + 1] += out->a_off[k];
    out->b_off[k + 1] += out->b_off[k];
  }

  if (ftruncate(fda, out->a_off[n_bins] * 12) != 0 ||
      ftruncate(fdb, out->b_off[n_bins] * 12) != 0) {
    delete out;
    return nullptr;
  }

  // per-(thread, bin) start offsets from the pass-1 counts
  const int cap = buf_events_for(T, n_bins);
  bool failed = false;
  {
    std::vector<std::thread> threads;
    std::vector<int64_t> a_cur(out->a_off.begin(), out->a_off.end() - 1);
    std::vector<int64_t> b_cur(out->b_off.begin(), out->b_off.end() - 1);
    std::vector<std::vector<int64_t>> a_start(T), b_start(T);
    for (int t = 0; t < T; t++) {
      a_start[t] = a_cur;
      b_start[t] = b_cur;
      for (int64_t k = 0; k < n_bins; k++) {
        a_cur[k] += locals[t].a[k];
        b_cur[k] += locals[t].b[k];
      }
    }
    std::vector<char> fail(T, 0);
    for (int t = 0; t < T; t++) {
      size_t lo = n * t / T;
      size_t hi = n * (t + 1) / T;
      threads.emplace_back([&, t, lo, hi]() {
        BinWriter wa(fda, a_start[t], cap);
        BinWriter wb(fdb, b_start[t], cap);
        walk_paf_region(p, n, lo, hi, [&](const PafRowN& r, size_t) {
          emit_row(r, in, n_reads, chunk, &wa, &wb);
        });
        wa.flush_all();
        wb.flush_all();
        fail[t] = (wa.failed() || wb.failed()) ? 1 : 0;
      });
    }
    for (auto& th : threads) th.join();
    for (int t = 0; t < T; t++) failed |= fail[t] != 0;
  }
  if (failed) {
    delete out;
    return nullptr;
  }
  return out;
}

RaftPafBins* paf_bin_events_stream(const char* path, const Interner& in,
                                   int64_t n_reads, int64_t chunk,
                                   int fda, int fdb) {
  const int64_t n_bins = (n_reads + chunk - 1) / chunk;
  // pass 1: counts + row0 capture (names copied: LineReader views expire)
  BinCounts cnt;
  cnt.a.assign(n_bins, 0);
  cnt.b.assign(n_bins, 0);
  std::string r0qn, r0tn;
  PafRowN row0{nullptr, 0, nullptr, 0, 0, 0, 0, 0, false};
  {
    LineReader rd(path);
    if (!rd.ok()) return nullptr;
    const char* s;
    size_t len;
    int64_t row_idx = 0;
    int64_t row0_idx = -1;
    while (rd.next(&s, &len)) {
      PafRowN r = parse_paf_line_n(s, len);
      if (!r.valid) continue;
      if (!row0.valid) {
        r0qn.assign(r.qn, r.qn_len);
        r0tn.assign(r.tn, r.tn_len);
        row0 = r;
        row0.qn = r0qn.data();
        row0.tn = r0tn.data();
        row0_idx = row_idx;
      }
      // reuse count_row with the row index standing in for a byte offset
      count_row(r, static_cast<size_t>(row_idx),
                row0, static_cast<size_t>(row0_idx), row0.valid, in,
                n_reads, chunk, &cnt);
      row_idx++;
    }
  }
  auto* out = new RaftPafBins();
  out->n_bins = n_bins;
  out->n_rows = cnt.n_rows;
  out->n_unknown = cnt.n_unknown;
  out->symmetric = cnt.mirror ? 1 : 0;
  out->a_off.assign(n_bins + 1, 0);
  out->b_off.assign(n_bins + 1, 0);
  for (int64_t k = 0; k < n_bins; k++) {
    out->a_off[k + 1] = out->a_off[k] + cnt.a[k];
    out->b_off[k + 1] = out->b_off[k] + cnt.b[k];
  }
  if (ftruncate(fda, out->a_off[n_bins] * 12) != 0 ||
      ftruncate(fdb, out->b_off[n_bins] * 12) != 0) {
    delete out;
    return nullptr;
  }
  // pass 2: re-read and emit
  {
    LineReader rd(path);
    if (!rd.ok()) {
      delete out;
      return nullptr;
    }
    BinWriter wa(fda, std::vector<int64_t>(out->a_off.begin(),
                                           out->a_off.end() - 1),
                 buf_events_for(1, n_bins));
    BinWriter wb(fdb, std::vector<int64_t>(out->b_off.begin(),
                                           out->b_off.end() - 1),
                 buf_events_for(1, n_bins));
    const char* s;
    size_t len;
    while (rd.next(&s, &len)) {
      PafRowN r = parse_paf_line_n(s, len);
      if (!r.valid) continue;
      emit_row(r, in, n_reads, chunk, &wa, &wb);
    }
    wa.flush_all();
    wb.flush_all();
    if (wa.failed() || wb.failed()) {
      delete out;
      return nullptr;
    }
  }
  return out;
}

}  // namespace

extern "C" RaftPafBins* raftio_paf_bin_events(const char* path,
                                              RaftFasta* fa,
                                              int64_t n_reads, int64_t chunk,
                                              const char* a_path,
                                              const char* b_path) {
  if (chunk <= 0 || n_reads <= 0 || !fa) return nullptr;
  int fda = open(a_path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fda < 0) return nullptr;
  int fdb = open(b_path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fdb < 0) {
    close(fda);
    return nullptr;
  }
  RaftPafBins* out = nullptr;
  {
    Source src;
    if (open_source(path, &src))
      out = paf_bin_events_mmap(src.p, src.n, fa->interner, n_reads,
                                chunk, fda, fdb);
  }
  if (!out)
    out = paf_bin_events_stream(path, fa->interner, n_reads, chunk, fda,
                                fdb);
  close(fda);
  close(fdb);
  return out;
}

extern "C" void raftio_free_pafbins(RaftPafBins* b) { delete b; }
extern "C" int64_t rpb_n_rows(RaftPafBins* b) { return b->n_rows; }
extern "C" int rpb_symmetric(RaftPafBins* b) { return b->symmetric; }
extern "C" int64_t rpb_n_unknown(RaftPafBins* b) { return b->n_unknown; }
extern "C" int64_t rpb_n_bins(RaftPafBins* b) { return b->n_bins; }
extern "C" const int64_t* rpb_a_off(RaftPafBins* b) {
  return b->a_off.data();
}
extern "C" const int64_t* rpb_b_off(RaftPafBins* b) {
  return b->b_off.data();
}

extern "C" {

// ---------------------------------------------------------------------------
// Emitters
// ---------------------------------------------------------------------------

}  // extern "C"

namespace {

bool write_full(int fd, const char* p, size_t n) {
  size_t done = 0;
  while (done < n) {
    ssize_t w = write(fd, p + done, n - done);
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) return false;
    done += static_cast<size_t>(w);
  }
  return true;
}

bool writev_full(int fd, struct iovec* iov, int cnt) {
  while (cnt > 0) {
    ssize_t w = writev(fd, iov, cnt);
    if (w < 0 && errno == EINTR) continue;
    if (w < 0) return false;
    while (cnt > 0 && w >= static_cast<ssize_t>(iov->iov_len)) {
      w -= static_cast<ssize_t>(iov->iov_len);
      iov++;
      cnt--;
    }
    if (cnt > 0 && w > 0) {
      iov->iov_base = static_cast<char*>(iov->iov_base) + w;
      iov->iov_len -= static_cast<size_t>(w);
    }
  }
  return true;
}

bool pwritev_full(int fd, struct iovec* iov, int cnt, int64_t off) {
  while (cnt > 0) {
    ssize_t w = pwritev(fd, iov, cnt, off);
    if (w < 0 && errno == EINTR) continue;
    if (w < 0) return false;
    off += w;
    while (cnt > 0 && w >= static_cast<ssize_t>(iov->iov_len)) {
      w -= static_cast<ssize_t>(iov->iov_len);
      iov++;
      cnt--;
    }
    if (cnt > 0 && w > 0) {
      iov->iov_base = static_cast<char*>(iov->iov_base) + w;
      iov->iov_len -= static_cast<size_t>(w);
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// BGZF output: block-parallel deflate, the write-side mirror of the
// block-parallel inflate above. Input splits into 0xff00-byte blocks
// (bgzip's block size, chosen so the worst-case deflate expansion still
// fits the 16-bit BSIZE field); blocks compress concurrently and write
// in order; files end with the standard 28-byte BGZF EOF marker, so
// outputs are valid bgzip files (zcat / htslib / our own parallel
// BGZF reader all consume them).
// ---------------------------------------------------------------------------
constexpr size_t kBgzfIn = 0xff00;

int gz_level() {
  const char* env = getenv("RAFT_GZ_LEVEL");
  if (env && *env) {
    int v = atoi(env);
    if (v >= 1 && v <= 9) return v;
  }
  return 6;  // bgzip's default
}

const uint8_t kBgzfEof[28] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff,
                              6,    0,    66, 67, 2, 0, 27, 0, 3, 0,
                              0,    0,    0,  0,  0, 0, 0,  0};

bool bgzf_deflate_block(z_stream* zs, const char* in, size_t n,
                        std::vector<char>* out) {
  static const uint8_t H[18] = {0x1f, 0x8b, 8,   4,   0, 0, 0, 0, 0,
                                0xff, 6,    0,   'B', 'C', 2, 0, 0, 0};
  size_t hdr = out->size();
  size_t cap = deflateBound(zs, static_cast<uLong>(n));
  out->resize(hdr + 18 + cap + 8);
  memcpy(out->data() + hdr, H, 18);
  deflateReset(zs);
  zs->next_in = reinterpret_cast<Bytef*>(const_cast<char*>(in));
  zs->avail_in = static_cast<uInt>(n);
  zs->next_out = reinterpret_cast<Bytef*>(out->data() + hdr + 18);
  zs->avail_out = static_cast<uInt>(cap);
  if (deflate(zs, Z_FINISH) != Z_STREAM_END) return false;
  size_t clen = cap - zs->avail_out;
  size_t total = 18 + clen + 8;
  if (total - 1 > 0xffff) return false;  // cannot happen at kBgzfIn
  char* p = out->data() + hdr;
  p[16] = static_cast<char>((total - 1) & 0xff);
  p[17] = static_cast<char>(((total - 1) >> 8) & 0xff);
  uint32_t crc = static_cast<uint32_t>(
      crc32(0, reinterpret_cast<const Bytef*>(in), static_cast<uInt>(n)));
  char* f = p + 18 + clen;
  for (int i = 0; i < 4; i++) f[i] = static_cast<char>((crc >> (8 * i)) & 0xff);
  uint32_t isz = static_cast<uint32_t>(n);
  for (int i = 0; i < 4; i++)
    f[4 + i] = static_cast<char>((isz >> (8 * i)) & 0xff);
  out->resize(hdr + total);
  return true;
}

// Compress `n` bytes into BGZF members appended to fd (no EOF marker —
// callers add it once per file).
bool bgzf_write(int fd, const char* data, size_t n, int T) {
  size_t nblk = (n + kBgzfIn - 1) / kBgzfIn;
  if (!nblk) return true;
  if (static_cast<size_t>(T) > nblk) T = static_cast<int>(nblk);
  std::vector<std::vector<char>> outs(T);
  std::vector<char> fail(T, 0);
  std::vector<std::thread> threads;
  int lvl = gz_level();
  for (int t = 0; t < T; t++) {
    threads.emplace_back([&, t]() {
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (deflateInit2(&zs, lvl, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) != Z_OK) {
        fail[t] = 1;
        return;
      }
      size_t k0 = nblk * t / T, k1 = nblk * (t + 1) / T;
      outs[t].reserve((k1 - k0) * (kBgzfIn / 2));
      for (size_t k = k0; k < k1; k++) {
        size_t off = k * kBgzfIn;
        size_t len = n - off < kBgzfIn ? n - off : kBgzfIn;
        if (!bgzf_deflate_block(&zs, data + off, len, &outs[t])) {
          fail[t] = 1;
          break;
        }
      }
      deflateEnd(&zs);
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < T; t++)
    if (fail[t]) return false;
  for (int t = 0; t < T; t++)
    if (!outs[t].empty() && !write_full(fd, outs[t].data(), outs[t].size()))
      return false;
  return true;
}

// Two-digit-LUT integer formatter shared by the render writers: the
// coverage files alone are ~2 GB of "start,cov " pairs at 512k scale,
// so halving the div/mod chain cuts the emit render term (VERDICT r4
// item 5). Returns the digit count written at d (no sign handling).
static const char kDigits2[201] =
    "0001020304050607080910111213141516171819202122232425262728293031323334353637383940414243444546474849"
    "5051525354555657585960616263646566676869707172737475767778798081828384858687888990919293949596979899";
inline int fmt_u64(char* d, uint64_t v) {
  char tmp[24];
  int k = 0;
  while (v >= 100) {
    const unsigned r = static_cast<unsigned>(v % 100);
    v /= 100;
    tmp[k++] = kDigits2[2 * r + 1];
    tmp[k++] = kDigits2[2 * r];
  }
  if (v >= 10) {
    tmp[k++] = kDigits2[2 * v + 1];
    tmp[k++] = kDigits2[2 * v];
  } else {
    tmp[k++] = static_cast<char>('0' + v);
  }
  for (int i = 0; i < k; i++) d[i] = tmp[k - 1 - i];
  return k;
}

// The emitters' optional stats array (the last argument of every
// raftio_emit_* entry point; NULL = off, and then no clock is read):
// nanoseconds of the CountWriter pre-pass, of the render (outside the
// writes) and inside write/pwrite/bgzf_write, the number
// of those calls, the shards, and the bytes written; each thread keeps
// its own and they are added once it has joined.
enum { kStCount = 0, kStRender, kStWrite, kStWriteCalls, kStShards,
       kStBytes, kEmitStats };

inline int64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// One write call, timed into ws = {ns, calls} when ws is set.
template <class F>
inline bool timed_write(int64_t* ws, F write_call) {
  if (!ws) return write_call();
  const int64_t t = now_ns();
  const bool ok = write_call();
  ws[0] += now_ns() - t;
  ws[1]++;
  return ok;
}

// Buffered emitter: rendered text and copied payload (fragment sequences)
// accumulate in a fixed 4 MB buffer, and each flush is one write of it; a
// payload longer than the buffer is written straight from its source
// after a flush. Copying costs less than it saves: on a sandboxed kernel
// such as gVisor a writev of references into the input (its file mapping
// or the process's memory) takes about twice as long as copying the same
// bytes into 4 MB buffers and writing those.
class BufWriter {
 public:
  // reserved: the file's extent was allocated ahead (raftio_reserve), so
  // it is opened without O_TRUNC and cut to the bytes written by trim()
  explicit BufWriter(const char* path, bool append = false,
                     int64_t* ws = nullptr, bool reserved = false)
      : fd_(open(path, O_WRONLY | O_CREAT |
                           (append ? O_APPEND : reserved ? 0 : O_TRUNC),
                 0644)),
        buf_(1 << 22), n_(0), failed_(false), bytes_(0), ws_(ws),
        reserved_(reserved) {}
  ~BufWriter() {
    flush();
    if (fd_ >= 0) close(fd_);
  }
  bool ok() const { return fd_ >= 0 && !failed_; }
  inline void put(const char* s, size_t n) {
    if (n_ + n > buf_.size()) {
      flush();
      if (n > buf_.size()) {  // oversized copy: write straight through
        if (!timed_write(ws_, [&] { return write_full(fd_, s, n); }))
          failed_ = true;
        bytes_ += static_cast<int64_t>(n);
        return;
      }
    }
    memcpy(buf_.data() + n_, s, n);
    n_ += n;
  }
  inline void putc(char c) {
    if (n_ + 1 > buf_.size()) flush();
    buf_[n_++] = c;
  }
  inline void putint(int64_t v) {
    if (n_ + 24 > buf_.size()) flush();
    char* d = buf_.data();
    if (v < 0) {
      d[n_++] = '-';
      v = -v;
    }
    n_ += static_cast<size_t>(fmt_u64(d + n_, static_cast<uint64_t>(v)));
  }
  void flush() {
    if (n_ > 0) {
      bytes_ += static_cast<int64_t>(n_);
      if (!timed_write(ws_, [&] { return write_full(fd_, buf_.data(), n_); }))
        failed_ = true;
    }
    n_ = 0;
  }
  int64_t bytes() const { return bytes_; }  // handed to write so far
  // after the last flush: a reserved file keeps no byte past the output
  // (none at all after a failed write), so no reserved NUL survives
  void trim() {
    if (reserved_ && fd_ >= 0 && ftruncate(fd_, failed_ ? 0 : bytes_) != 0)
      failed_ = true;
  }

 private:
  int fd_;
  std::vector<char> buf_;
  size_t n_;
  bool failed_;
  int64_t bytes_;
  int64_t* ws_;
  bool reserved_;
};

// Growable in-memory writer with BufWriter's interface: the unit of the
// parallel emitters — each thread renders a contiguous item shard into
// its own MemWriter, then the shards are written to the file in order
// (bytes identical to a single-threaded render; the formatting, which
// dominates emit cost, runs on all cores). Same memcpy/raw-index inner
// loops as BufWriter — per-byte push_back was measured 10x slower.
class MemWriter {
 public:
  MemWriter() : n_(0) {}
  inline void put(const char* s, size_t n) {
    if (n_ + n > buf_.size()) grow(n);
    memcpy(buf_.data() + n_, s, n);
    n_ += n;
  }
  inline void putc(char c) {
    if (n_ + 1 > buf_.size()) grow(1);
    buf_[n_++] = c;
  }
  inline void putint(int64_t v) {
    if (n_ + 24 > buf_.size()) grow(24);
    char* d = buf_.data();
    if (v < 0) {
      d[n_++] = '-';
      v = -v;
    }
    n_ += static_cast<size_t>(fmt_u64(d + n_, static_cast<uint64_t>(v)));
  }
  const char* data() const { return buf_.data(); }
  size_t size() const { return n_; }

 private:
  void grow(size_t need) {
    size_t cap = buf_.size() ? buf_.size() : (1u << 20);
    while (cap < n_ + need) cap <<= 1;
    buf_.resize(cap);
  }
  std::vector<char> buf_;
  size_t n_;
};

// Byte-count pre-pass writer: same interface as BufWriter/MemWriter but
// only accumulates the rendered size — no memory traffic. putint mirrors
// the render writers' digit logic exactly so the counted size equals the
// written size byte-for-byte (the pwrite ranges below depend on it).
class CountWriter {
 public:
  CountWriter() : n_(0) {}
  inline void put(const char*, size_t n) { n_ += static_cast<int64_t>(n); }
  inline void putc(char) { n_++; }
  inline void putint(int64_t v) {
    if (v < 0) {
      n_++;
      v = -v;
    }
    do {
      n_++;
      v /= 10;
    } while (v);
  }
  int64_t size() const { return n_; }

 private:
  int64_t n_;
};

// BufWriter variant that flushes with pwrite at a tracked file offset:
// the unit of the PARALLEL emitters — each thread renders a contiguous
// item shard straight into its own disjoint byte range of the file (sized
// by a CountWriter pre-pass), so payload bytes are written once (no
// render-into-memory second pass) and all cores format and copy
// concurrently.
class PWriter {
 public:
  PWriter(int fd, int64_t off, int64_t* ws = nullptr)
      : fd_(fd), off_(off), buf_(1 << 22), n_(0), failed_(false),
        ws_(ws) {}
  ~PWriter() { flush(); }
  bool ok() const { return !failed_; }
  int64_t offset() const { return off_; }  // valid after flush()
  inline void put(const char* s, size_t n) {
    if (n_ + n > buf_.size()) {
      flush();
      if (n > buf_.size()) {
        if (!timed_write(ws_,
                         [&] { return pwrite_full(fd_, s, n, off_) >= 0; }))
          failed_ = true;
        off_ += static_cast<int64_t>(n);
        return;
      }
    }
    memcpy(buf_.data() + n_, s, n);
    n_ += n;
  }
  inline void putc(char c) {
    if (n_ + 1 > buf_.size()) flush();
    buf_[n_++] = c;
  }
  inline void putint(int64_t v) {
    if (n_ + 24 > buf_.size()) flush();
    char* d = buf_.data();
    if (v < 0) {
      d[n_++] = '-';
      v = -v;
    }
    n_ += static_cast<size_t>(fmt_u64(d + n_, static_cast<uint64_t>(v)));
  }
  void flush() {
    if (n_ > 0) {
      if (!timed_write(ws_, [&] {
            return pwrite_full(fd_, buf_.data(), n_, off_) >= 0;
          }))
        failed_ = true;
      off_ += static_cast<int64_t>(n_);
    }
    n_ = 0;
  }

 private:
  int fd_;
  int64_t off_;
  std::vector<char> buf_;
  size_t n_;
  bool failed_;
  int64_t* ws_;
};

// Per-file shard budget: the pipeline writes the output files
// CONCURRENTLY (one Python thread per file), so each file gets half the
// machine. The parallel emitters are single-pass (CountWriter
// pre-pass + disjoint pwrite ranges) so shards contend only on memory
// bandwidth; measured on a 2-vCPU host one shard already saturates the
// kernel copy (parallel = 0.305 s vs serial 0.274 s on the 754 MB
// fragment file), so small machines stay serial and the parallel path
// engages at >= 4 cores.
// explicit RAFT_EMIT_SHARDS (0 = unset → auto)
int emit_shards_explicit() {
  const char* env = getenv("RAFT_EMIT_SHARDS");
  if (env && *env) {
    int v = atoi(env);
    if (v >= 1) return v > 64 ? 64 : v;
  }
  return 0;
}

int emit_shards() {
  int v = emit_shards_explicit();
  if (v) return v;
  int t = n_parse_threads() / 2;
  return t < 1 ? 1 : (t > 16 ? 16 : t);
}

// Render items [0, n_items) with render(writer, lo, hi) sharded over
// threads. Small item counts render single-threaded straight into the
// file buffer. The parallel plain-file path is single-pass:
// a CountWriter pre-pass (no memory traffic — formatting arithmetic
// only) sizes each shard's byte range, then every thread renders its
// shard with a PWriter straight into its disjoint pwrite range. With
// gz != 0 the shards render into memory and are BGZF-compressed
// (block-parallel) instead, ending with the BGZF EOF marker;
// decompressed bytes are identical to the gz=0 output. With `st` set
// (an int64_t[kEmitStats]) the counters above are added to it. With
// reserved != 0 (plain, not append) the file's extent was allocated ahead
// by raftio_reserve: it is opened without O_TRUNC and cut to the exact
// output size, so the writes only copy.
template <class RenderFn>
int emit_sharded(const char* path, int64_t n_items, int append,
                 RenderFn render, int gz, int64_t* st, int reserved = 0) {
  const int T = emit_shards();
  // an explicit RAFT_EMIT_SHARDS > 1 engages the parallel path even on
  // small item counts (tests exercise PWriter that way); the auto
  // default keeps small files on the serial fast path
  if (!gz && (T == 1 || (n_items < 4096 && emit_shards_explicit() == 0))) {
    int64_t ws[2] = {0, 0};
    BufWriter w(path, append != 0, st ? ws : nullptr, reserved != 0);
    if (!w.ok()) return -1;
    const int64_t t0 = st ? now_ns() : 0;
    render(w, static_cast<int64_t>(0), n_items);
    // flush BEFORE deciding the return code: the destructor's flush is
    // too late to report ENOSPC/EIO, and a silently truncated output
    // with rc=0 is the worst possible failure (found by an actual
    // disk-full event during the r4 512k runs)
    w.flush();
    w.trim();
    if (st) {
      st[kStRender] += now_ns() - t0 - ws[0];
      st[kStWrite] += ws[0];
      st[kStWriteCalls] += ws[1];
      st[kStShards] += 1;
      st[kStBytes] += w.bytes();
    }
    return w.ok() ? 0 : -1;
  }
  // per shard thread: render ns, and write {ns, calls}
  std::vector<int64_t> tst(static_cast<size_t>(3 * T), 0);
  if (gz) {
    std::vector<MemWriter> shards(T);
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      int64_t lo = n_items * t / T;
      int64_t hi = n_items * (t + 1) / T;
      threads.emplace_back([&shards, &tst, st, t, lo, hi, &render]() {
        const int64_t t0 = st ? now_ns() : 0;
        render(shards[t], lo, hi);
        if (st) tst[3 * t] = now_ns() - t0;
      });
    }
    for (auto& th : threads) th.join();
    int fd = open(path, O_WRONLY | O_CREAT | (append ? O_APPEND : O_TRUNC),
                  0644);
    if (fd < 0) return -1;
    struct stat st0;
    if (st && fstat(fd, &st0) != 0) st0.st_size = 0;
    int64_t ws[2] = {0, 0};
    int64_t* wsp = st ? ws : nullptr;
    const int ZT = n_parse_threads();
    for (auto& s : shards)
      if (s.size() && !timed_write(wsp, [&] {
            return bgzf_write(fd, s.data(), s.size(), ZT);
          })) {
        close(fd);
        return -1;
      }
    if (!timed_write(wsp, [&] {
          return write_full(fd, reinterpret_cast<const char*>(kBgzfEof),
                            28);
        })) {
      close(fd);
      return -1;
    }
    if (st) {
      struct stat st1;
      if (fstat(fd, &st1) == 0) st[kStBytes] += st1.st_size - st0.st_size;
      for (int t = 0; t < T; t++) st[kStRender] += tst[3 * t];
      st[kStWrite] += ws[0];
      st[kStWriteCalls] += ws[1];
      st[kStShards] += T;
    }
    close(fd);
    return 0;
  }
  // parallel: counting pre-pass → disjoint pwrite ranges
  std::vector<int64_t> sizes(static_cast<size_t>(T), 0);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      int64_t lo = n_items * t / T;
      int64_t hi = n_items * (t + 1) / T;
      threads.emplace_back([&sizes, &tst, st, t, lo, hi, &render]() {
        const int64_t t0 = st ? now_ns() : 0;
        CountWriter w;
        render(w, lo, hi);
        sizes[t] = w.size();
        if (st) tst[3 * t] = now_ns() - t0;
      });
    }
    for (auto& th : threads) th.join();
    if (st)
      for (int t = 0; t < T; t++) st[kStCount] += tst[3 * t];
  }
  // NO O_APPEND: on Linux pwrite ignores the offset on O_APPEND fds;
  // append mode instead bases the ranges at the current file size. A
  // reserved file keeps its extent: the ftruncate below sets its size.
  int fd = open(path, O_WRONLY | O_CREAT | (append || reserved ? 0 : O_TRUNC),
                0644);
  if (fd < 0) return -1;
  int64_t base = 0;
  if (append) {
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return -1;
    }
    base = static_cast<int64_t>(st.st_size);
  }
  std::vector<int64_t> starts(static_cast<size_t>(T) + 1, base);
  for (int t = 0; t < T; t++) starts[t + 1] = starts[t] + sizes[t];
  if (ftruncate(fd, starts[T]) != 0) {
    close(fd);
    return -1;
  }
  std::vector<uint8_t> fail(static_cast<size_t>(T), 0);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      int64_t lo = n_items * t / T;
      int64_t hi = n_items * (t + 1) / T;
      threads.emplace_back([&, t, lo, hi]() {
        int64_t* ws = st ? &tst[3 * t + 1] : nullptr;
        const int64_t t0 = st ? now_ns() : 0;
        PWriter w(fd, starts[t], ws);
        render(w, lo, hi);
        w.flush();
        if (st) tst[3 * t] = now_ns() - t0 - ws[0];
        if (!w.ok() || w.offset() != starts[t + 1]) fail[t] = 1;
      });
    }
    for (auto& th : threads) th.join();
  }
  if (st) {
    for (int t = 0; t < T; t++) {
      st[kStRender] += tst[3 * t];
      st[kStWrite] += tst[3 * t + 1];
      st[kStWriteCalls] += tst[3 * t + 2];
    }
    st[kStShards] += T;
    st[kStBytes] += starts[T] - base;
  }
  for (int t = 0; t < T; t++)
    if (fail[t]) {
      // count/render divergence or I/O error: restore the original length
      // so the caller's fallback can rewrite/append cleanly. If the restore
      // itself fails the file still ends with partial shard bytes — return
      // -2 so the caller knows a plain append would corrupt the output.
      int rc;
      do {
        rc = ftruncate(fd, base);
      } while (rc != 0 && errno == EINTR);
      close(fd);
      return rc == 0 ? -1 : -2;
    }
  close(fd);
  return 0;
}
}  // namespace

// Simulated-read metadata parsed out of every name in one native pass
// (python-contract semantics of chop.hpp:25-70: find-based substring
// scans + atoi; the reference's hidden 15-char buffer is UB we do not
// reproduce). Blobs are contiguous with [n+1] offsets so the emitters
// consume them directly.
struct RaftSimMeta {
  std::vector<int64_t> start_pos, end_pos;
  std::vector<uint8_t> align_code;  // 0=forward 1=reverse 2=other
  std::vector<char> align_blob, suffix_blob, chrom_blob;
  std::vector<int64_t> align_off, suffix_off, chrom_off;
};

extern "C" {

// Parse n names (NUL-terminated, name i at name_blob+name_off[i]).
// Returns nullptr when any name lacks a required delimiter — the caller
// falls back to the per-name python parse for exact degenerate-input
// semantics (str.find with -1 positions etc.).
RaftSimMeta* raftio_sim_meta(const char* name_blob, const int64_t* name_off,
                             int64_t n) {
  auto* m = new RaftSimMeta();
  m->start_pos.resize(static_cast<size_t>(n));
  m->end_pos.resize(static_cast<size_t>(n));
  m->align_code.resize(static_cast<size_t>(n));
  m->align_off.resize(static_cast<size_t>(n) + 1, 0);
  m->suffix_off.resize(static_cast<size_t>(n) + 1, 0);
  m->chrom_off.resize(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < n; i++) {
    const char* nm = name_blob + name_off[i];
    const char* nm_end = name_blob + name_off[i + 1] - 1;  // the NUL
    const char* c0 = strchr(nm, ',');            // first comma
    const char* eq = c0 ? strchr(c0, '=') : nullptr;   // '=' from c0
    const char* d0 = strchr(nm, '-');            // first dash anywhere
    const char* c1 = c0 ? strchr(c0 + 1, ',') : nullptr;  // second comma
    const char* cr = c0 ? strrchr(nm, ',') : nullptr;     // last comma
    if (!c0 || !eq || !d0 || !c1 || !cr) {
      delete m;
      return nullptr;
    }
    m->start_pos[i] = atoll(eq + 1);
    m->end_pos[i] = atoll(d0 + 1);
    size_t al = static_cast<size_t>(c1 - (c0 + 1));
    m->align_code[i] =
        (al == 7 && memcmp(c0 + 1, "forward", 7) == 0) ? 0
        : (al == 7 && memcmp(c0 + 1, "reverse", 7) == 0) ? 1 : 2;
    m->align_blob.insert(m->align_blob.end(), c0 + 1, c1);
    m->align_off[i + 1] = static_cast<int64_t>(m->align_blob.size());
    m->suffix_blob.insert(m->suffix_blob.end(), cr, nm_end);
    m->suffix_off[i + 1] = static_cast<int64_t>(m->suffix_blob.size());
    m->chrom_blob.insert(m->chrom_blob.end(), cr + 1, nm_end);
    m->chrom_off[i + 1] = static_cast<int64_t>(m->chrom_blob.size());
  }
  return m;
}

void raftio_free_sim_meta(RaftSimMeta* m) { delete m; }
const int64_t* rsm_start(RaftSimMeta* m) { return m->start_pos.data(); }
const int64_t* rsm_end(RaftSimMeta* m) { return m->end_pos.data(); }
const uint8_t* rsm_align_code(RaftSimMeta* m) { return m->align_code.data(); }
const char* rsm_align_blob(RaftSimMeta* m) { return m->align_blob.data(); }
const int64_t* rsm_align_off(RaftSimMeta* m) { return m->align_off.data(); }
const char* rsm_suffix_blob(RaftSimMeta* m) { return m->suffix_blob.data(); }
const int64_t* rsm_suffix_off(RaftSimMeta* m) { return m->suffix_off.data(); }
const char* rsm_chrom_blob(RaftSimMeta* m) { return m->chrom_blob.data(); }
const int64_t* rsm_chrom_off(RaftSimMeta* m) { return m->chrom_off.data(); }

}  // extern "C"

extern "C" {

// Fragment FASTA: headers are pre-rendered by the caller (hdr_blob with
// hdr_off offsets, one per fragment; empty header → no header line, which
// mirrors the reference's headerless simulated-mode fallthrough).
// bgzip-equivalent utility: BGZF-compress a whole file block-parallel
// (RAFT_GZ_LEVEL honored). Exists so BGZF test/bench inputs need no
// external bgzip binary, and as the user-facing recompression route for
// plain-gz inputs (whose single-stream inflate is the serial floor the
// SCALE_r05 gz section measures).
int raftio_bgzf_file(const char* in_path, const char* out_path) {
  Mapped m;
  if (!map_file(in_path, &m) || !m.n) return -1;
  int fd = open(out_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  bool ok = bgzf_write(fd, m.p, m.n, n_parse_threads());
  if (ok)
    ok = write_full(fd, reinterpret_cast<const char*>(kBgzfEof), 28);
  close(fd);
  if (!ok) unlink(out_path);
  return ok ? 0 : -1;
}

int raftio_emit_frags(const char* path, const char* seq_blob,
                      const int64_t* seq_off, const int32_t* frag_read,
                      const int64_t* char_start, const int64_t* char_len,
                      int64_t n_frags, const char* hdr_blob,
                      const int64_t* hdr_off) {
  BufWriter w(path);
  if (!w.ok()) return -1;
  for (int64_t i = 0; i < n_frags; i++) {
    int64_t hn = hdr_off[i + 1] - hdr_off[i];
    if (hn > 0) {
      w.put(hdr_blob + hdr_off[i], static_cast<size_t>(hn));
      w.putc('\n');
    }
    int64_t base = seq_off[frag_read[i]] + char_start[i];
    w.put(seq_blob + base, static_cast<size_t>(char_len[i]));
    w.putc('\n');
  }
  w.flush();
  return w.ok() ? 0 : -1;
}

// Fragment FASTA with in-C++ header rendering (chop.hpp:250-321).
// All header fields derive from char_start/char_len (see
// raft_tpu/result.py); name/align/suffix text arrives as blobs with
// [n+1] offsets. name offsets include a trailing NUL per name
// (len = off[i+1]-off[i]-1); align/suffix offsets are exact.
int raftio_emit_frags_full(
    const char* path, const char* seq_blob, const int64_t* seq_off,
    int64_t n_frags, const int32_t* frag_read, const int64_t* char_start,
    const int64_t* char_len, const uint8_t* whole, int real_reads,
    const char* name_blob, const int64_t* name_off,
    const uint8_t* align_code, const int64_t* start_pos,
    const int64_t* end_pos, const char* align_blob,
    const int64_t* align_off, const char* suffix_blob,
    const int64_t* suffix_off, int64_t first_read_num, int append,
    int reserved, int gz, int64_t* stats) {
  auto render = [&](auto& w, int64_t jlo, int64_t jhi) {
  for (int64_t j = jlo; j < jhi; j++) {
    int64_t i = frag_read[j];
    int64_t cs = char_start[j];
    int64_t cl = char_len[j];
    int64_t num = first_read_num + j;
    if (real_reads) {
      w.put(">read=", 6);
      w.putint(num);
      w.putc(',');
      w.put(name_blob + name_off[i],
            static_cast<size_t>(name_off[i + 1] - name_off[i] - 1));
      w.put(",pos_on_original_read=", 22);
      w.putint(cs);
      w.putc('-');
      w.putint(cs + cl);
      w.putc('\n');
    } else {
      uint8_t ac = align_code[i];
      bool wh = whole[j] != 0;
      if (wh || ac == 0 || ac == 1) {
        w.put(">read=", 6);
        w.putint(num);
        w.putc(',');
        w.put(align_blob + align_off[i],
              static_cast<size_t>(align_off[i + 1] - align_off[i]));
        w.put(",position=", 10);
        if (wh) {
          w.putint(start_pos[i]);
          w.putc('-');
          w.putint(end_pos[i]);
        } else if (ac == 0) {  // forward
          w.putint(start_pos[i] + cs);
          w.putc('-');
          w.putint(start_pos[i] + cs + cl);
        } else {  // reverse
          w.putint(end_pos[i] - cs - cl);
          w.putc('-');
          w.putint(end_pos[i] - cs);
        }
        w.put(",length=", 8);
        w.putint(cl);
        w.put(suffix_blob + suffix_off[i],
              static_cast<size_t>(suffix_off[i + 1] - suffix_off[i]));
        w.putc('\n');
      }
    }
    w.put(seq_blob + seq_off[i] + cs, static_cast<size_t>(cl));
    w.putc('\n');
  }
  };
  return emit_sharded(path, n_frags, append, render, gz, stats, reserved);
}

// Reserve the first nbytes of the plain output file at path ahead of its
// writer (raftio_emit_frags_full with reserved = 1): open it, truncate it
// and allocate the range with the fallocate(2) syscall, mode 0 (not
// posix_fallocate, whose fallback writes a byte per block where the
// filesystem lacks fallocate), in emit_shards() disjoint ranges on as many
// threads: allocating a memfd's pages scales with threads where writing
// into the file does not. O_NONBLOCK and the fstat keep a FIFO or a
// device untouched. Returns 0, or -errno with nothing left reserved.
int raftio_reserve(const char* path, int64_t nbytes) {
  int fd = open(path, O_WRONLY | O_CREAT | O_NONBLOCK | O_CLOEXEC, 0644);
  if (fd < 0) return -errno;
  struct stat sb;
  int err = 0;
  if (fstat(fd, &sb) != 0)
    err = errno;
  else if (!S_ISREG(sb.st_mode))
    err = ESPIPE;
  else if (ftruncate(fd, 0) != 0)
    err = errno;
  if (err) {
    close(fd);
    return -err;
  }
  const int T = emit_shards();
  std::vector<int> errs(static_cast<size_t>(T), 0);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) {
      const off_t lo = static_cast<off_t>(nbytes * t / T);
      const off_t hi = static_cast<off_t>(nbytes * (t + 1) / T);
      threads.emplace_back([&errs, fd, t, lo, hi]() {
        if (hi <= lo) return;
        int rc;
        do {
          rc = fallocate(fd, 0, lo, hi - lo);
        } while (rc != 0 && errno == EINTR);
        if (rc != 0) errs[t] = errno;
      });
    }
    for (auto& th : threads) th.join();
  }
  for (int e : errs)
    if (e && !err) err = e;
  if (err) {
    // a partial allocation must not survive as the file's length
    while (ftruncate(fd, 0) != 0 && errno == EINTR) {
    }
  }
  close(fd);
  return -err;
}

// Σcov, the coverage summed over every window of every read (the
// "coverage per window" line's numerator), in closed form from read-grouped,
// window-binned events with the coverage renderer's clamp semantics: an
// event of read i counts iff w1 >= w0 and 0 <= w0 < nw (nw = ceil(len /
// reso)), over min(w1, nw - 1) - w0 + 1 windows. Reads [lo, hi); where o0
// is given, each event is copied to (o0, o1) on the way. The inner loops
// are branch-free, so they vectorise.
static int64_t cov_sum_reads(const int32_t* w0, const int32_t* w1,
                             const int64_t* ev_off, const int64_t* lens,
                             int64_t lo, int64_t hi, int32_t reso,
                             int32_t* o0, int32_t* o1) {
  int64_t sum = 0;
  for (int64_t i = lo; i < hi; i++) {
    const int64_t nw = (lens[i] + reso - 1) / reso;
    int64_t s = 0;
    const int64_t j0 = ev_off[i], j1 = ev_off[i + 1];
    if (o0) {
      for (int64_t j = j0; j < j1; j++) {
        const int32_t a = w0[j], b = w1[j];
        o0[j] = a;
        o1[j] = b;
        const int64_t v = (b < nw - 1 ? b : nw - 1) - int64_t{a} + 1;
        s += (b >= a && a >= 0 && a < nw) ? v : 0;
      }
    } else {
      for (int64_t j = j0; j < j1; j++) {
        const int32_t a = w0[j], b = w1[j];
        const int64_t v = (b < nw - 1 ? b : nw - 1) - int64_t{a} + 1;
        s += (b >= a && a >= 0 && a < nw) ? v : 0;
      }
    }
    sum += s;
  }
  return sum;
}

// cov_sum_reads over all reads, cut into ranges of about equal events, one
// a thread (at most 8, one below 2^18 events), as raftio_cov_hist threads.
static int64_t cov_sum_threaded(const int32_t* w0, const int32_t* w1,
                                const int64_t* ev_off, const int64_t* lens,
                                int64_t n_reads, int32_t reso, int32_t* o0,
                                int32_t* o1) {
  const int64_t m = ev_off[n_reads];
  unsigned hw = std::thread::hardware_concurrency();
  int nth = static_cast<int>(std::min<unsigned>(hw ? hw : 1, 8));
  if (m < (int64_t{1} << 18)) nth = 1;
  std::vector<int64_t> part(static_cast<size_t>(nth), 0);
  auto work = [&](int t) {
    const int64_t lo = std::lower_bound(ev_off, ev_off + n_reads,
                                        m * t / nth) - ev_off;
    const int64_t hi = std::lower_bound(ev_off, ev_off + n_reads,
                                        m * (t + 1) / nth) - ev_off;
    part[static_cast<size_t>(t)] =
        cov_sum_reads(w0, w1, ev_off, lens, lo, hi, reso, o0, o1);
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nth; t++) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
  int64_t sum = 0;
  for (int64_t p : part) sum += p;
  return sum;
}

// Σcov of read-grouped events held by the caller.
int64_t raftio_cov_sum(const int32_t* w0, const int32_t* w1,
                       const int64_t* ev_off, const int64_t* lens,
                       int64_t n_reads, int32_t reso) {
  return cov_sum_threaded(w0, w1, ev_off, lens, n_reads, reso, nullptr,
                          nullptr);
}

// The grouping's arrays copied out to the caller's off [n+1], w0 and w1
// [m], and its Σcov, summed in the same threaded pass: the accessor
// beside rge_n_unknown and rge_n_oob that hands the grouping over.
int64_t rge_export(RaftGroupedEv* g, const int64_t* lens, int32_t reso,
                   int64_t* off, int32_t* w0, int32_t* w1) {
  const int64_t n = static_cast<int64_t>(g->off.size()) - 1;
  std::memcpy(off, g->off.data(), g->off.size() * sizeof(int64_t));
  return cov_sum_threaded(g->w0.data(), g->w1.data(), g->off.data(), lens,
                          n, reso, w0, w1);
}

// coverage.txt: "read {i} " + "{w*reso},{cov} " per window + "\n"
// cov values for read i are cov[cov_off[i] .. cov_off[i+1])
int raftio_emit_coverage(const char* path, const int32_t* cov,
                         const int64_t* cov_off, int64_t n_reads,
                         int32_t reso, int64_t first_read_index,
                         int append, int gz, int64_t* stats) {
  auto render = [&](auto& w, int64_t ilo, int64_t ihi) {
  for (int64_t i = ilo; i < ihi; i++) {
    w.put("read ", 5);
    w.putint(first_read_index + i);
    w.putc(' ');
    int64_t wstart = 0;
    for (int64_t j = cov_off[i]; j < cov_off[i + 1]; j++) {
      w.putint(wstart);
      w.putc(',');
      w.putint(cov[j]);
      w.putc(' ');
      wstart += reso;
    }
    w.putc('\n');
  }
  };
  return emit_sharded(path, n_reads, append, render, gz, stats);
}

// coverage.txt rendered straight from window-binned events (the fast
// path: the engine never materializes the O(total windows) coverage
// array — each render thread rebuilds one read's coverage in a reused
// diff buffer while formatting). Same bytes as raftio_emit_coverage on
// the materialized array. w1 is inclusive; w1 one past the last window
// clamps to the row end exactly like the device's row-local carry.
int raftio_emit_coverage_events(const char* path, const int32_t* w0,
                                const int32_t* w1, const int64_t* ev_off,
                                const int64_t* cov_off, int64_t n_reads,
                                int32_t reso, int64_t first_read_index,
                                int append, int gz, int64_t* stats) {
  auto render = [&](auto& w, int64_t ilo, int64_t ihi) {
  std::vector<int32_t> diff;
  // The "wstart," prefix for window k is k*reso — IDENTICAL for every
  // read. Render each prefix once per shard and memcpy it thereafter
  // (the coverage file is ~2 GB of these pairs at 512k scale; this
  // halves the remaining putint work after the digit-LUT). Capped —
  // ultralong reads beyond the table fall back to putint.
  const int64_t kMaxTab = 65536;
  int64_t max_nw = 0;
  for (int64_t i = ilo; i < ihi; i++)
    max_nw = std::max(max_nw, cov_off[i + 1] - cov_off[i]);
  const int64_t tab_n = std::min(max_nw, kMaxTab);
  std::vector<char> tab_blob(static_cast<size_t>(tab_n) * 24);
  std::vector<uint32_t> tab_off(static_cast<size_t>(tab_n) + 1, 0);
  for (int64_t k = 0; k < tab_n; k++) {
    char* d = tab_blob.data() + tab_off[k];
    int len = fmt_u64(d, static_cast<uint64_t>(k) * reso);
    d[len] = ',';
    tab_off[k + 1] = tab_off[k] + static_cast<uint32_t>(len) + 1;
  }
  for (int64_t i = ilo; i < ihi; i++) {
    int64_t nw = cov_off[i + 1] - cov_off[i];
    diff.assign(static_cast<size_t>(nw + 1), 0);
    for (int64_t j = ev_off[i]; j < ev_off[i + 1]; j++) {
      int64_t a = w0[j];
      int64_t b = w1[j];
      if (b < a || a < 0 || a >= nw) continue;
      if (b >= nw) b = nw - 1;
      diff[a]++;
      diff[b + 1]--;
    }
    w.put("read ", 5);
    w.putint(first_read_index + i);
    w.putc(' ');
    int32_t c = 0;
    const int64_t ntab = std::min(nw, tab_n);
    for (int64_t k = 0; k < ntab; k++) {
      c += diff[k];
      w.put(tab_blob.data() + tab_off[k], tab_off[k + 1] - tab_off[k]);
      w.putint(c);
      w.putc(' ');
    }
    for (int64_t k = ntab; k < nw; k++) {
      c += diff[k];
      w.putint(k * reso);
      w.putc(',');
      w.putint(c);
      w.putc(' ');
    }
    w.putc('\n');
  }
  };
  return emit_sharded(path, n_reads, append, render, gz, stats);
}

// long_repeats.bed (repeat.hpp:187-199, simulated mode): per interval
// "{chrom}\t{start}\t{end}\n" in genome coordinates; forward reads map
// [s,e] to [sp+s, sp+e], reverse reads flip to [ep-e, ep-s]; reads whose
// alignment is neither are skipped. Real-reads mode is handled by the
// caller (file created empty, n_reads == 0 here).
int raftio_emit_bed(const char* path, const int32_t* rep_s,
                    const int32_t* rep_e, const int64_t* rep_off,
                    int64_t n_reads, const uint8_t* align_code,
                    const int64_t* start_pos, const int64_t* end_pos,
                    const char* chrom_blob, const int64_t* chrom_off,
                    int append, int gz, int64_t* stats) {
  auto render = [&](auto& w, int64_t ilo, int64_t ihi) {
  for (int64_t i = ilo; i < ihi; i++) {
    uint8_t ac = align_code[i];
    if (ac > 1) continue;
    int64_t cb = chrom_off[i];
    size_t cn = static_cast<size_t>(chrom_off[i + 1] - cb);
    for (int64_t j = rep_off[i]; j < rep_off[i + 1]; j++) {
      w.put(chrom_blob + cb, cn);
      w.putc('\t');
      if (ac == 0) {
        w.putint(start_pos[i] + rep_s[j]);
        w.putc('\t');
        w.putint(start_pos[i] + rep_e[j]);
      } else {
        w.putint(end_pos[i] - rep_e[j]);
        w.putc('\t');
        w.putint(end_pos[i] - rep_s[j]);
      }
      w.putc('\n');
    }
  }
  };
  return emit_sharded(path, n_reads, append, render, gz, stats);
}

// long_repeats.txt: "read {i}, " + "{s},{e}    " per interval + "\n"
int raftio_emit_repeats(const char* path, const int32_t* rep_s,
                        const int32_t* rep_e, const int64_t* rep_off,
                        int64_t n_reads, int64_t first_read_index,
                        int append, int gz, int64_t* stats) {
  auto render = [&](auto& w, int64_t ilo, int64_t ihi) {
  for (int64_t i = ilo; i < ihi; i++) {
    w.put("read ", 5);
    w.putint(first_read_index + i);
    w.put(", ", 2);
    for (int64_t j = rep_off[i]; j < rep_off[i + 1]; j++) {
      w.putint(rep_s[j]);
      w.putc(',');
      w.putint(rep_e[j]);
      w.put("    ", 4);
    }
    w.putc('\n');
  }
  };
  return emit_sharded(path, n_reads, append, render, gz, stats);
}

}  // extern "C"
