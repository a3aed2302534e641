// kmerlsh_tpu native host runtime: streaming FASTQ/gzip parser and
// open-addressing canonical k-mer counter.
//
// Replacement for the reference's host-side C++ components:
//   * kseq.h + utils/fastq.cc  -> FastqReader (zlib gzFile streaming,
//     part-buffered like the reference's 2^16-read parts)
//   * utils/libcuckoo + kmer/kmc_reader.cc -> KmerCounter (key-range-sharded
//     open-addressing uint64->uint32 maps over 2-bit packed k-mers; threads
//     each decode the whole read block and insert only keys whose hash
//     falls in their shard — the lock-free analog of the reference's
//     thread-strided OpenMP loops, kmer/kmc_reader.cc:11,96)
//
// Plain CPython C API (no pybind11 in the image). Data crosses the
// boundary as bytes objects; Python wraps them with np.frombuffer.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <string.h>
#include <zlib.h>

#include <algorithm>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- utilities

// 2-bit code per base; 4 = invalid (non-ACGT). Matches
// kmerlsh_tpu.kmer.codec: A=0 C=1 G=2 T=3, case-sensitive like the
// reference Kmer::set_kmer (kmer/Kmer.cc:121-129).
static uint8_t kBaseCode[256];

struct InitTables {
  InitTables() {
    memset(kBaseCode, 4, sizeof(kBaseCode));
    kBaseCode[(unsigned char)'A'] = 0;
    kBaseCode[(unsigned char)'C'] = 1;
    kBaseCode[(unsigned char)'G'] = 2;
    kBaseCode[(unsigned char)'T'] = 3;
  }
} init_tables_;

// reverse the 32 2-bit groups of a word (for revcomp)
static inline uint64_t reverse_bases64(uint64_t v) {
  v = ((v >> 2) & 0x3333333333333333ULL) | ((v & 0x3333333333333333ULL) << 2);
  v = ((v >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((v & 0x0F0F0F0F0F0F0F0FULL) << 4);
  return __builtin_bswap64(v);
}

static inline uint64_t revcomp(uint64_t packed, int k) {
  return reverse_bases64(~packed) >> (64 - 2 * k);
}

// lexicographic value (base 0 most significant) for KMC-style canonical
static inline uint64_t lex_value(uint64_t packed, int k) {
  return reverse_bases64(packed) >> (64 - 2 * k);
}

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// ------------------------------------------------------------- FastqReader

struct FastqReaderObject {
  PyObject_HEAD
  gzFile fp;
  std::string* carry;  // partial line from the previous fill
  bool eof;
};

static void FastqReader_dealloc(FastqReaderObject* self) {
  if (self->fp) gzclose(self->fp);
  delete self->carry;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* FastqReader_new(PyTypeObject* type, PyObject* args,
                                 PyObject* kwds) {
  const char* path = nullptr;
  static const char* kwlist[] = {"path", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "s",
                                   const_cast<char**>(kwlist), &path))
    return nullptr;
  FastqReaderObject* self = (FastqReaderObject*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->fp = gzopen(path, "rb");
  self->carry = new std::string();
  self->eof = false;
  if (!self->fp) {
    PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
    Py_DECREF(self);
    return nullptr;
  }
  gzbuffer(self->fp, 1 << 20);
  return (PyObject*)self;
}

// read one logical line into out (without newline); returns false on EOF
static bool read_line(FastqReaderObject* self, std::string& out) {
  out.clear();
  char buf[1 << 16];
  for (;;) {
    char* got = gzgets(self->fp, buf, sizeof(buf));
    if (!got) {
      self->eof = true;
      return !out.empty();
    }
    size_t n = strlen(buf);
    if (n && buf[n - 1] == '\n') {
      if (n >= 2 && buf[n - 2] == '\r') n -= 1;
      out.append(buf, n - 1);
      return true;
    }
    out.append(buf, n);
  }
}

// next_part(max_reads) ->
//   (n, names_blob, name_off, seq_blob, seq_off, qual_blob, qual_off)
// offsets are int64 arrays of length n+1 serialized as bytes
static PyObject* FastqReader_next_part(FastqReaderObject* self,
                                       PyObject* args) {
  Py_ssize_t max_reads = 1 << 16;
  if (!PyArg_ParseTuple(args, "|n", &max_reads)) return nullptr;

  std::string names, seqs, quals, line, tmp;
  std::vector<int64_t> noff{0}, soff{0}, qoff{0};
  Py_ssize_t n = 0;

  Py_BEGIN_ALLOW_THREADS
  while (n < max_reads && !self->eof) {
    if (!read_line(self, line)) break;
    if (line.empty()) continue;
    if (line[0] == '@') {
      size_t sp = line.find_first_of(" \t");
      size_t name_end = (sp == std::string::npos) ? line.size() : sp;
      names.append(line, 1, name_end - 1);
      read_line(self, tmp);  // sequence
      seqs += tmp;
      read_line(self, line);  // '+'
      read_line(self, tmp);   // quality
      quals += tmp;
    } else if (line[0] == '>') {
      size_t sp = line.find_first_of(" \t");
      size_t name_end = (sp == std::string::npos) ? line.size() : sp;
      names.append(line, 1, name_end - 1);
      // multi-line FASTA: peek lines until next header
      while (!self->eof) {
        z_off_t pos = gztell(self->fp);
        if (!read_line(self, tmp)) break;
        if (!tmp.empty() && (tmp[0] == '>' || tmp[0] == '@')) {
          gzseek(self->fp, pos, SEEK_SET);
          self->eof = false;
          break;
        }
        seqs += tmp;
      }
    } else {
      continue;  // tolerate stray lines
    }
    noff.push_back((int64_t)names.size());
    soff.push_back((int64_t)seqs.size());
    qoff.push_back((int64_t)quals.size());
    ++n;
  }
  Py_END_ALLOW_THREADS

  return Py_BuildValue(
      "(n y# y# y# y# y# y#)", n,
      names.data(), (Py_ssize_t)names.size(),
      (const char*)noff.data(), (Py_ssize_t)(noff.size() * sizeof(int64_t)),
      seqs.data(), (Py_ssize_t)seqs.size(),
      (const char*)soff.data(), (Py_ssize_t)(soff.size() * sizeof(int64_t)),
      quals.data(), (Py_ssize_t)quals.size(),
      (const char*)qoff.data(), (Py_ssize_t)(qoff.size() * sizeof(int64_t)));
}

static PyMethodDef FastqReader_methods[] = {
    {"next_part", (PyCFunction)FastqReader_next_part, METH_VARARGS,
     "Read up to max_reads records; returns blob/offset tuple."},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject FastqReaderType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ------------------------------------------------------------- KmerCounter

static const uint64_t kEmpty = ~0ULL;

// one open-addressing shard; a shard is only ever touched by one thread
struct CounterShard {
  std::vector<uint64_t> keys;
  std::vector<uint32_t> counts;
  size_t used = 0;

  CounterShard() : keys(1 << 13, kEmpty), counts(1 << 13, 0) {}

  void grow() {
    std::vector<uint64_t> old_k;
    std::vector<uint32_t> old_c;
    old_k.swap(keys);
    old_c.swap(counts);
    size_t ns = old_k.size() * 2;
    keys.assign(ns, kEmpty);
    counts.assign(ns, 0);
    size_t mask = ns - 1;
    for (size_t j = 0; j < old_k.size(); ++j) {
      uint64_t key = old_k[j];
      if (key == kEmpty) continue;
      size_t i = splitmix64(key) & mask;
      while (keys[i] != kEmpty) i = (i + 1) & mask;
      keys[i] = key;
      counts[i] = old_c[j];
    }
  }

  inline void add(uint64_t key) {
    size_t mask = keys.size() - 1;
    size_t i = splitmix64(key) & mask;
    for (;;) {
      if (keys[i] == key) {
        if (counts[i] != UINT32_MAX) ++counts[i];
        return;
      }
      if (keys[i] == kEmpty) {
        keys[i] = key;
        counts[i] = 1;
        if (++used * 10 > keys.size() * 7) grow();
        return;
      }
      i = (i + 1) & mask;
    }
  }
};

static const int kShardBits = 3;  // 8 shards
static const int kNumShards = 1 << kShardBits;

struct KmerCounterObject {
  PyObject_HEAD
  int k;
  int threads;
  CounterShard* shards;  // [kNumShards]
};

// shard owner: TOP hash bits (slot index uses the low bits — independent)
static inline int shard_of(uint64_t key) {
  return (int)(splitmix64(key) >> (64 - kShardBits));
}

static void KmerCounter_dealloc(KmerCounterObject* self) {
  delete[] self->shards;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* KmerCounter_new(PyTypeObject* type, PyObject* args,
                                 PyObject* kwds) {
  int k = 0, threads = 0;
  static const char* kwlist[] = {"k", "threads", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "i|i",
                                   const_cast<char**>(kwlist), &k, &threads))
    return nullptr;
  if (k < 1 || k > 31) {
    PyErr_SetString(PyExc_ValueError, "k must be in [1, 31]");
    return nullptr;
  }
  KmerCounterObject* self = (KmerCounterObject*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->k = k;
  if (threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    threads = hc ? (int)hc : 1;
  }
  self->threads = std::min(threads, kNumShards);
  self->shards = new CounterShard[kNumShards];
  return (PyObject*)self;
}

// add(seq_blob: bytes, seq_off: bytes(int64[n+1])) — slides canonical
// (lexicographic-min) k-mers over each read, skipping windows with
// non-ACGT bases (KMC semantics). Two parallel phases, no locks:
//   1. threads decode disjoint read ranges into per-thread key buffers;
//   2. threads scan ALL buffers and insert only the keys whose shard they
//      own (the lock-free analog of the reference's thread-strided OpenMP
//      loops, kmer/kmc_reader.cc:11,96). Deterministic for any T.
static PyObject* KmerCounter_add(KmerCounterObject* self, PyObject* args) {
  Py_buffer blob, off;
  if (!PyArg_ParseTuple(args, "y*y*", &blob, &off)) return nullptr;
  const uint8_t* s = (const uint8_t*)blob.buf;
  const int64_t* o = (const int64_t*)off.buf;
  Py_ssize_t n_reads = off.len / (Py_ssize_t)sizeof(int64_t) - 1;
  const int k = self->k;
  const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  CounterShard* shards = self->shards;
  const int n_threads = self->threads;

  auto decode_range = [=](Py_ssize_t r0, Py_ssize_t r1,
                          std::vector<uint64_t>& out) {
    for (Py_ssize_t r = r0; r < r1; ++r) {
      int64_t beg = o[r], end = o[r + 1];
      uint64_t fwd = 0;
      int valid_run = 0;
      for (int64_t i = beg; i < end; ++i) {
        uint8_t c = kBaseCode[s[i]];
        if (c > 3) {
          valid_run = 0;
          fwd = 0;
          continue;
        }
        fwd = ((fwd >> 2) | ((uint64_t)c << (2 * (k - 1)))) & mask;
        if (++valid_run >= k) {
          uint64_t rc = revcomp(fwd, k);
          out.push_back((lex_value(fwd, k) <= lex_value(rc, k)) ? fwd : rc);
        }
      }
    }
  };

  Py_BEGIN_ALLOW_THREADS
  if (n_threads <= 1) {
    std::vector<uint64_t> buf;
    buf.reserve((size_t)(o[n_reads] - o[0]));
    decode_range(0, n_reads, buf);
    for (uint64_t key : buf) shards[shard_of(key)].add(key);
  } else {
    std::vector<std::vector<uint64_t>> bufs(n_threads);
    {
      std::vector<std::thread> pool;
      pool.reserve(n_threads);
      for (int t = 0; t < n_threads; ++t) {
        Py_ssize_t r0 = n_reads * t / n_threads;
        Py_ssize_t r1 = n_reads * (t + 1) / n_threads;
        bufs[t].reserve((size_t)(o[r1] - o[r0]));
        pool.emplace_back([&, t, r0, r1] { decode_range(r0, r1, bufs[t]); });
      }
      for (auto& th : pool) th.join();
    }
    {
      std::vector<std::thread> pool;
      pool.reserve(n_threads);
      for (int t = 0; t < n_threads; ++t) {
        pool.emplace_back([&, t] {
          for (const auto& buf : bufs)
            for (uint64_t key : buf) {
              int sh = shard_of(key);
              if (sh % n_threads == t) shards[sh].add(key);
            }
        });
      }
      for (auto& th : pool) th.join();
    }
  }
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&blob);
  PyBuffer_Release(&off);
  Py_RETURN_NONE;
}

// finalize(count_min, cs) -> (packed_bytes(uint64[n]), counts_bytes(uint32[n]))
// sorted lexicographically, counts capped at cs.
static PyObject* KmerCounter_finalize(KmerCounterObject* self,
                                      PyObject* args) {
  unsigned int count_min = 2, cs = 65535;
  if (!PyArg_ParseTuple(args, "|II", &count_min, &cs)) return nullptr;

  std::vector<std::pair<uint64_t, uint32_t>> out;
  Py_BEGIN_ALLOW_THREADS
  size_t total = 0;
  for (int sh = 0; sh < kNumShards; ++sh) total += self->shards[sh].used;
  out.reserve(total);
  for (int sh = 0; sh < kNumShards; ++sh) {
    CounterShard& shard = self->shards[sh];
    for (size_t i = 0; i < shard.keys.size(); ++i) {
      uint64_t key = shard.keys[i];
      if (key == kEmpty) continue;
      uint32_t c = shard.counts[i];
      if (c < count_min) continue;
      if (c > cs) c = cs;
      out.emplace_back(lex_value(key, self->k), c);
    }
  }
  std::sort(out.begin(), out.end());
  Py_END_ALLOW_THREADS

  std::vector<uint64_t> packed(out.size());
  std::vector<uint32_t> cnts(out.size());
  for (size_t i = 0; i < out.size(); ++i) {
    // lex -> packed: reverse of lex_value
    packed[i] = reverse_bases64(out[i].first << (64 - 2 * self->k));
    cnts[i] = out[i].second;
  }
  return Py_BuildValue(
      "(y# y#)",
      (const char*)packed.data(), (Py_ssize_t)(packed.size() * 8),
      (const char*)cnts.data(), (Py_ssize_t)(cnts.size() * 4));
}

static PyObject* KmerCounter_size(KmerCounterObject* self, PyObject*) {
  size_t total = 0;
  for (int sh = 0; sh < kNumShards; ++sh) total += self->shards[sh].used;
  return PyLong_FromSize_t(total);
}

static PyMethodDef KmerCounter_methods[] = {
    {"add", (PyCFunction)KmerCounter_add, METH_VARARGS,
     "Count canonical k-mers of packed reads."},
    {"finalize", (PyCFunction)KmerCounter_finalize, METH_VARARGS,
     "Return (packed uint64 bytes, uint32 count bytes) sorted lex."},
    {"size", (PyCFunction)KmerCounter_size, METH_NOARGS,
     "Distinct k-mers counted so far."},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject KmerCounterType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// -------------------------------------------------------------- ReadScorer
//
// Mode-E differential-read scorer (io/ioFastQ.cc:5-76 semantics, identical
// selection contract to kmerlsh_tpu.ops.reads.score_part): slides every
// window of each read (non-ACGT bases encode as A, windows are NOT
// skipped), canonicalizes by the memcmp rule, counts membership in the
// differential set, selects iff hits/(len-k+1) > vote and len >= k+10.
// The diff set lives in an open-addressing hash table built once per group
// (the reference rebuilds an unordered_set per group too); scoring is
// read-parallel over a read-only table — no locks.

static inline uint64_t memcmp_key(uint64_t packed) {
  return __builtin_bswap64(packed);
}

struct ReadScorerObject {
  PyObject_HEAD
  int k;
  uint64_t mask2k;      // (1 << 2k) - 1
  std::vector<uint64_t>* table;  // open addressing; kEmpty = empty
  size_t tmask;
};

static void ReadScorer_dealloc(ReadScorerObject* self) {
  delete self->table;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* ReadScorer_new(PyTypeObject* type, PyObject* args,
                                PyObject* kwds) {
  Py_buffer keys;
  int k = 0;
  static const char* kwlist[] = {"diff_keys", "k", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "y*i",
                                   const_cast<char**>(kwlist), &keys, &k))
    return nullptr;
  if (k < 1 || k > 31) {
    PyBuffer_Release(&keys);
    PyErr_SetString(PyExc_ValueError, "k must be in [1, 31]");
    return nullptr;
  }
  ReadScorerObject* self = (ReadScorerObject*)type->tp_alloc(type, 0);
  if (!self) {
    PyBuffer_Release(&keys);
    return nullptr;
  }
  self->k = k;
  self->mask2k = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const uint64_t* kv = (const uint64_t*)keys.buf;
  size_t n = (size_t)keys.len / 8;
  size_t cap = 16;
  while (cap < 2 * n + 1) cap <<= 1;
  self->table = new std::vector<uint64_t>(cap, kEmpty);
  self->tmask = cap - 1;
  std::vector<uint64_t>& t = *self->table;
  for (size_t j = 0; j < n; ++j) {
    uint64_t key = kv[j];
    size_t i = splitmix64(key) & self->tmask;
    while (t[i] != kEmpty && t[i] != key) i = (i + 1) & self->tmask;
    t[i] = key;
  }
  PyBuffer_Release(&keys);
  return (PyObject*)self;
}

// score(seq_blob, offsets: int64[n+1], vote, threads=0) -> bytes(uint8[n])
static PyObject* ReadScorer_score(ReadScorerObject* self, PyObject* args) {
  Py_buffer blob, off;
  double vote = 0.5;
  int threads = 0;
  if (!PyArg_ParseTuple(args, "y*y*d|i", &blob, &off, &vote, &threads))
    return nullptr;
  const uint8_t* s = (const uint8_t*)blob.buf;
  const int64_t* o = (const int64_t*)off.buf;
  Py_ssize_t n_reads = off.len / (Py_ssize_t)sizeof(int64_t) - 1;
  if (n_reads < 0) n_reads = 0;
  if (threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    threads = hc ? (int)hc : 1;
  }
  if ((Py_ssize_t)threads > n_reads) threads = n_reads > 0 ? (int)n_reads : 1;

  PyObject* out = PyBytes_FromStringAndSize(nullptr, n_reads);
  if (!out) {
    PyBuffer_Release(&blob);
    PyBuffer_Release(&off);
    return nullptr;
  }
  uint8_t* mask = (uint8_t*)PyBytes_AS_STRING(out);
  const int k = self->k;
  const uint64_t m2k = self->mask2k;
  const std::vector<uint64_t>& t = *self->table;
  const size_t tmask = self->tmask;

  auto score_range = [&](Py_ssize_t r0, Py_ssize_t r1) {
    for (Py_ssize_t r = r0; r < r1; ++r) {
      int64_t beg = o[r], end = o[r + 1];
      int64_t len = end - beg;
      mask[r] = 0;
      if (len < k + 10) continue;            // strict '<' (ioFastQ.cc:25)
      uint64_t fwd = 0;
      int64_t hits = 0;
      for (int64_t i = beg; i < end; ++i) {
        uint8_t c = kBaseCode[s[i]];
        if (c > 3) c = 0;                    // non-ACGT encodes as A
        fwd = ((fwd >> 2) | ((uint64_t)c << (2 * (k - 1)))) & m2k;
        if (i - beg + 1 < k) continue;
        uint64_t kf = memcmp_key(fwd);
        uint64_t kr = memcmp_key(revcomp(fwd, k));
        uint64_t key = kf < kr ? kf : kr;
        size_t j = splitmix64(key) & tmask;
        while (t[j] != kEmpty) {
          if (t[j] == key) {
            ++hits;
            break;
          }
          j = (j + 1) & tmask;
        }
      }
      double denom = (double)(len - k + 1);
      if ((double)hits / denom > vote) mask[r] = 1;
    }
  };

  Py_BEGIN_ALLOW_THREADS
  if (threads <= 1) {
    score_range(0, n_reads);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int tix = 0; tix < threads; ++tix) {
      Py_ssize_t r0 = n_reads * tix / threads;
      Py_ssize_t r1 = n_reads * (tix + 1) / threads;
      pool.emplace_back([&, r0, r1] { score_range(r0, r1); });
    }
    for (auto& th : pool) th.join();
  }
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&blob);
  PyBuffer_Release(&off);
  return out;
}

static PyMethodDef ReadScorer_methods[] = {
    {"score", (PyCFunction)ReadScorer_score, METH_VARARGS,
     "Score reads against the differential k-mer set; returns uint8 mask."},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject ReadScorerType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ------------------------------------------------------------ render_clust
//
// Bytes-level renderer for the `.clust` text format (one line per cluster,
// "size\tid1\tid2…\n", io/ioMatrix.cc:265-294 in the reference). The
// per-token Python/NumPy string path costs ~0.8 M ids/s at the 1e7-id
// design point; this streams tens of M ids/s like the reference's
// ofstream writer.

static inline size_t u64_to_chars(uint64_t v, char* out) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + (v % 10));
    v /= 10;
  } while (v);
  for (int i = 0; i < n; ++i) out[i] = tmp[n - 1 - i];
  return (size_t)n;
}

// render_clust(flat: bytes(uint64[n]), offsets: bytes(int64[g+1]),
//              threads=0) -> bytes
static PyObject* native_render_clust(PyObject*, PyObject* args) {
  Py_buffer flat_buf, off_buf;
  int threads = 0;
  if (!PyArg_ParseTuple(args, "y*y*|i", &flat_buf, &off_buf, &threads))
    return nullptr;
  const uint64_t* flat = (const uint64_t*)flat_buf.buf;
  const int64_t* off = (const int64_t*)off_buf.buf;
  Py_ssize_t g = off_buf.len / (Py_ssize_t)sizeof(int64_t) - 1;
  if (g < 0) g = 0;
  if (threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    threads = hc ? (int)hc : 1;
  }
  if ((Py_ssize_t)threads > g) threads = g > 0 ? (int)g : 1;

  std::vector<std::string> parts((size_t)threads);

  auto render_range = [&](Py_ssize_t g0, Py_ssize_t g1, std::string& out) {
    // worst case per group: 20-digit size + per id (tab + 20 digits) + \n
    out.reserve((size_t)(off[g1] - off[g0]) * 21 + (size_t)(g1 - g0) * 22);
    char buf[21];
    for (Py_ssize_t gi = g0; gi < g1; ++gi) {
      int64_t lo = off[gi], hi = off[gi + 1];
      out.append(buf, u64_to_chars((uint64_t)(hi - lo), buf));
      for (int64_t i = lo; i < hi; ++i) {
        buf[0] = '\t';
        out.append(buf, 1 + u64_to_chars(flat[i], buf + 1));
      }
      out.push_back('\n');
    }
  };

  Py_BEGIN_ALLOW_THREADS
  if (threads <= 1) {
    render_range(0, g, parts[0]);
  } else {
    // split group ranges so each thread owns ~equal id counts
    std::vector<std::thread> pool;
    pool.reserve(threads);
    const int64_t total_ids = off[g];
    Py_ssize_t g0 = 0;
    for (int t = 0; t < threads; ++t) {
      Py_ssize_t g1;
      if (t == threads - 1) {
        g1 = g;
      } else {
        int64_t target = total_ids * (t + 1) / threads;
        g1 = (Py_ssize_t)(std::upper_bound(off + g0, off + g + 1, target) -
                          off) - 1;
        if (g1 < g0) g1 = g0;
      }
      pool.emplace_back([&, t, g0, g1] { render_range(g0, g1, parts[t]); });
      g0 = g1;
    }
    for (auto& th : pool) th.join();
  }
  Py_END_ALLOW_THREADS

  size_t total = 0;
  for (const auto& p : parts) total += p.size();
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)total);
  if (out) {
    char* dst = PyBytes_AS_STRING(out);
    for (const auto& p : parts) {
      memcpy(dst, p.data(), p.size());
      dst += p.size();
    }
  }
  PyBuffer_Release(&flat_buf);
  PyBuffer_Release(&off_buf);
  return out;
}

// ------------------------------------------------------------- parse_clust
//
// Inverse of render_clust: parse `.clust` text ("size\tid…\n" per line,
// io/ioMatrix.cc:48-120 reader semantics) into (uint64 flat ids, int64
// group offsets). The NumPy path materializes ~2 Python objects per token
// via bytes.split() (~73 s for a 45 M-line tmp round at the 2^26 design
// point); this parses the same bytes multithreaded in ~1-2 s.

// parse_clust(text: bytes, threads=0)
//   -> (flat: bytes(uint64[n]), offsets: bytes(int64[g+1]))
static PyObject* native_parse_clust(PyObject*, PyObject* args) {
  Py_buffer tb;
  int threads = 0;
  if (!PyArg_ParseTuple(args, "y*|i", &tb, &threads)) return nullptr;
  const char* s = (const char*)tb.buf;
  Py_ssize_t n = tb.len;
  if (threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    threads = hc ? (int)hc : 1;
  }
  if (n < (Py_ssize_t)threads * 4096) threads = 1;

  std::vector<Py_ssize_t> bounds((size_t)threads + 1, 0);
  bounds[(size_t)threads] = n;
  for (int t = 1; t < threads; ++t) {
    Py_ssize_t p = n * t / threads;
    while (p < n && s[p] != '\n') ++p;
    bounds[(size_t)t] = p < n ? p + 1 : n;
  }
  for (int t = 1; t < threads; ++t)
    if (bounds[(size_t)t] < bounds[(size_t)t - 1])
      bounds[(size_t)t] = bounds[(size_t)t - 1];

  struct Part {
    std::vector<uint64_t> ids;
    std::vector<int64_t> sizes;
    bool bad = false;
  };
  std::vector<Part> parts((size_t)threads);

  auto parse_range = [&](Py_ssize_t lo, Py_ssize_t hi, Part& pr) {
    const char* p = s + lo;
    const char* end = s + hi;
    pr.ids.reserve((size_t)(hi - lo) / 8);
    while (p < end) {
      if (*p == '\n') { ++p; continue; }
      uint64_t declared = 0;
      bool any = false;
      while (p < end && *p >= '0' && *p <= '9') {
        declared = declared * 10 + (uint64_t)(*p - '0');
        ++p;
        any = true;
      }
      if (!any) { pr.bad = true; return; }
      uint64_t count = 0;
      while (p < end && *p == '\t') {
        ++p;
        uint64_t v = 0;
        bool d = false;
        while (p < end && *p >= '0' && *p <= '9') {
          v = v * 10 + (uint64_t)(*p - '0');
          ++p;
          d = true;
        }
        if (!d) { pr.bad = true; return; }
        pr.ids.push_back(v);
        ++count;
      }
      if (p < end) {
        if (*p == '\n') ++p; else { pr.bad = true; return; }
      }
      if (count != declared) { pr.bad = true; return; }
      pr.sizes.push_back((int64_t)count);
    }
  };

  Py_BEGIN_ALLOW_THREADS
  if (threads <= 1) {
    parse_range(0, n, parts[0]);
  } else {
    std::vector<std::thread> pool;
    pool.reserve((size_t)threads);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        parse_range(bounds[(size_t)t], bounds[(size_t)t + 1],
                    parts[(size_t)t]);
      });
    for (auto& th : pool) th.join();
  }
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&tb);
  for (auto& pr : parts)
    if (pr.bad) {
      PyErr_SetString(PyExc_ValueError,
                      ".clust parse error: malformed line or size field "
                      "mismatch");
      return nullptr;
    }
  size_t g = 0, tot = 0;
  for (auto& pr : parts) {
    g += pr.sizes.size();
    tot += pr.ids.size();
  }
  PyObject* flat_o =
      PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)(tot * 8));
  PyObject* off_o =
      PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)((g + 1) * 8));
  if (!flat_o || !off_o) {
    Py_XDECREF(flat_o);
    Py_XDECREF(off_o);
    return nullptr;
  }
  uint64_t* fd = (uint64_t*)PyBytes_AS_STRING(flat_o);
  int64_t* od = (int64_t*)PyBytes_AS_STRING(off_o);
  int64_t acc = 0;
  size_t oi = 0;
  od[oi++] = 0;
  for (auto& pr : parts) {
    if (!pr.ids.empty()) {
      memcpy(fd, pr.ids.data(), pr.ids.size() * sizeof(uint64_t));
      fd += pr.ids.size();
    }
    for (int64_t szv : pr.sizes) {
      acc += szv;
      od[oi++] = acc;
    }
  }
  return Py_BuildValue("NN", flat_o, off_o);
}

static PyMethodDef native_functions[] = {
    {"render_clust", native_render_clust, METH_VARARGS,
     "Render (flat uint64 ids, int64 group offsets) to .clust text bytes."},
    {"parse_clust", native_parse_clust, METH_VARARGS,
     "Parse .clust text bytes to (flat uint64 ids, int64 group offsets)."},
    {nullptr, nullptr, 0, nullptr},
};

// ------------------------------------------------------------------ module

static PyModuleDef native_module = {
    PyModuleDef_HEAD_INIT, "_kmerlsh_native",
    "Native host runtime: FASTQ streaming + k-mer counting", -1,
    native_functions,
};

}  // namespace

PyMODINIT_FUNC PyInit__kmerlsh_native(void) {
  FastqReaderType.tp_name = "_kmerlsh_native.FastqReader";
  FastqReaderType.tp_basicsize = sizeof(FastqReaderObject);
  FastqReaderType.tp_dealloc = (destructor)FastqReader_dealloc;
  FastqReaderType.tp_flags = Py_TPFLAGS_DEFAULT;
  FastqReaderType.tp_new = FastqReader_new;
  FastqReaderType.tp_methods = FastqReader_methods;
  if (PyType_Ready(&FastqReaderType) < 0) return nullptr;

  KmerCounterType.tp_name = "_kmerlsh_native.KmerCounter";
  KmerCounterType.tp_basicsize = sizeof(KmerCounterObject);
  KmerCounterType.tp_dealloc = (destructor)KmerCounter_dealloc;
  KmerCounterType.tp_flags = Py_TPFLAGS_DEFAULT;
  KmerCounterType.tp_new = KmerCounter_new;
  KmerCounterType.tp_methods = KmerCounter_methods;
  if (PyType_Ready(&KmerCounterType) < 0) return nullptr;

  ReadScorerType.tp_name = "_kmerlsh_native.ReadScorer";
  ReadScorerType.tp_basicsize = sizeof(ReadScorerObject);
  ReadScorerType.tp_dealloc = (destructor)ReadScorer_dealloc;
  ReadScorerType.tp_flags = Py_TPFLAGS_DEFAULT;
  ReadScorerType.tp_new = ReadScorer_new;
  ReadScorerType.tp_methods = ReadScorer_methods;
  if (PyType_Ready(&ReadScorerType) < 0) return nullptr;

  PyObject* m = PyModule_Create(&native_module);
  if (!m) return nullptr;
  Py_INCREF(&FastqReaderType);
  PyModule_AddObject(m, "FastqReader", (PyObject*)&FastqReaderType);
  Py_INCREF(&KmerCounterType);
  PyModule_AddObject(m, "KmerCounter", (PyObject*)&KmerCounterType);
  Py_INCREF(&ReadScorerType);
  PyModule_AddObject(m, "ReadScorer", (PyObject*)&ReadScorerType);
  return m;
}
