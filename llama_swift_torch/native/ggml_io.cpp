// Native host runtime of the PyTorch/CUDA port: mmap'd GGML model loading,
// Q4_0 codecs, the greedy tokenizer, and the reference sampling pipeline
// with a true std::mt19937 stream.
//
// The port's own copy of llama_swift_tpu/native/ggml_io.cpp (the port
// imports nothing of the JAX package); everything below this comment is
// that file unchanged, so that both packages draw the same tokens from the
// same seed when built by the same g++ (std::mt19937 and
// std::discrete_distribution come from libstdc++).  It keeps the host path
// native: zero-copy mmap tensor access (PROT_READ, MAP_PRIVATE), an
// O(len*maxlen) tokenizer, and the sampler of llama_sample_top_p_top_k
// (utils.cpp:333-428).
//
// Exposed as a C ABI for ctypes (bindings in bindings.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// model file handle
// ---------------------------------------------------------------------------

struct GioTensor {
  char name[128];
  int32_t n_dims;
  int32_t ne[2];  // fastest-first, as stored
  int32_t ftype;
  uint64_t data_offset;
  uint64_t data_size;
};

struct GioModel {
  void* map = nullptr;
  size_t map_size = 0;
  int32_t hparams[7];  // n_vocab n_embd n_mult n_head n_layer n_rot f16
  std::vector<uint32_t> vocab_offsets;  // offset of each piece's bytes
  std::vector<uint32_t> vocab_lengths;
  std::vector<GioTensor> tensors;
  std::string error;
};

static size_t row_nbytes(int ftype, int cols) {
  switch (ftype) {
    case 0: return (size_t)cols * 4;
    case 1: return (size_t)cols * 2;
    case 2: return (size_t)cols / 32 * 20;
    case 3: return (size_t)cols / 32 * 24;
  }
  return 0;
}

GioModel* gio_open(const char* path) {
  auto* m = new GioModel();
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    m->error = "failed to open file";
    return m;
  }
  struct stat st;
  fstat(fd, &st);
  m->map_size = (size_t)st.st_size;
  m->map = mmap(nullptr, m->map_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m->map == MAP_FAILED) {
    m->map = nullptr;
    m->error = "mmap failed";
    return m;
  }
  const uint8_t* base = (const uint8_t*)m->map;
  size_t off = 0;
  auto read_i32 = [&](int32_t* out) -> bool {
    if (off + 4 > m->map_size) return false;
    memcpy(out, base + off, 4);
    off += 4;
    return true;
  };
  int32_t magic;
  if (!read_i32(&magic) || magic != 0x67676d6c) {
    m->error = "invalid model file (bad magic)";
    return m;
  }
  for (int i = 0; i < 7; i++) {
    if (!read_i32(&m->hparams[i])) {
      m->error = "truncated hparams";
      return m;
    }
  }
  const int n_vocab = m->hparams[0];
  m->vocab_offsets.reserve(n_vocab);
  m->vocab_lengths.reserve(n_vocab);
  for (int i = 0; i < n_vocab; i++) {
    int32_t len;
    if (!read_i32(&len) || off + (uint32_t)len > m->map_size) {
      m->error = "truncated vocab";
      return m;
    }
    m->vocab_offsets.push_back((uint32_t)off);
    m->vocab_lengths.push_back((uint32_t)len);
    off += (uint32_t)len;
  }
  // tensor records until EOF
  while (off + 12 <= m->map_size) {
    GioTensor t;
    memset(&t, 0, sizeof(t));
    int32_t name_len;
    read_i32(&t.n_dims);
    read_i32(&name_len);
    read_i32(&t.ftype);
    if (t.n_dims < 1 || t.n_dims > 2 || name_len <= 0 || name_len >= 127) {
      m->error = "corrupt tensor record";
      return m;
    }
    t.ne[0] = t.ne[1] = 1;
    for (int i = 0; i < t.n_dims; i++) read_i32(&t.ne[i]);
    if (off + (size_t)name_len > m->map_size) {
      m->error = "truncated tensor name";
      return m;
    }
    memcpy(t.name, base + off, name_len);
    off += name_len;
    t.data_offset = off;
    t.data_size = row_nbytes(t.ftype, t.ne[0]) * (size_t)t.ne[1];
    if (t.data_size == 0 || off + t.data_size > m->map_size) {
      m->error = "truncated tensor data";
      return m;
    }
    off += t.data_size;
    m->tensors.push_back(t);
  }
  return m;
}

const char* gio_error(GioModel* m) { return m->error.empty() ? nullptr : m->error.c_str(); }

void gio_close(GioModel* m) {
  if (m->map) munmap(m->map, m->map_size);
  delete m;
}

void gio_hparams(GioModel* m, int32_t* out7) { memcpy(out7, m->hparams, 7 * 4); }

int32_t gio_n_tensors(GioModel* m) { return (int32_t)m->tensors.size(); }

const GioTensor* gio_tensor(GioModel* m, int32_t i) { return &m->tensors[i]; }

const void* gio_base(GioModel* m) { return m->map; }

int32_t gio_vocab_piece(GioModel* m, int32_t id, const uint8_t** data) {
  if (id < 0 || id >= (int32_t)m->vocab_offsets.size()) return -1;
  *data = (const uint8_t*)m->map + m->vocab_offsets[id];
  return (int32_t)m->vocab_lengths[id];
}

// ---------------------------------------------------------------------------
// Q4_0 codecs (scalar semantics of ggml.c:568-601 / utils.cpp:431-485)
// ---------------------------------------------------------------------------

// dequantize interleaved-row Q4_0 bytes -> f32 [rows, cols]
void gio_dequant_q4_0(const uint8_t* src, float* dst, int64_t rows, int64_t cols) {
  const int64_t nb = cols / 32;
  const size_t bs = 20;
  for (int64_t r = 0; r < rows; r++) {
    const uint8_t* row = src + (size_t)r * nb * bs;
    float* out = dst + r * cols;
    for (int64_t b = 0; b < nb; b++) {
      float d;
      memcpy(&d, row + b * bs, 4);
      const uint8_t* pp = row + b * bs + 4;
      for (int l = 0; l < 16; l++) {
        const uint8_t v = pp[l];
        out[b * 32 + 2 * l + 0] = ((int8_t)(v & 0xf) - 8) * d;
        out[b * 32 + 2 * l + 1] = ((int8_t)(v >> 4) - 8) * d;
      }
    }
  }
}

// quantize f32 [rows, cols] -> interleaved-row Q4_0 bytes; hist16 optional
void gio_quantize_q4_0(const float* src, uint8_t* dst, int64_t rows, int64_t cols,
                       int64_t* hist16) {
  const int64_t nb = cols / 32;
  const size_t bs = 20;
  for (int64_t r = 0; r < rows; r++) {
    const float* in = src + r * cols;
    uint8_t* row = dst + (size_t)r * nb * bs;
    for (int64_t b = 0; b < nb; b++) {
      float amax = 0.0f;
      for (int l = 0; l < 32; l++) amax = std::max(amax, fabsf(in[b * 32 + l]));
      const float d = amax / 7.0f;
      const float id = d ? 1.0f / d : 0.0f;
      memcpy(row + b * bs, &d, 4);
      uint8_t* pp = row + b * bs + 4;
      for (int l = 0; l < 32; l += 2) {
        const uint8_t v0 = (uint8_t)((int8_t)roundf(in[b * 32 + l] * id) + 8);
        const uint8_t v1 = (uint8_t)((int8_t)roundf(in[b * 32 + l + 1] * id) + 8);
        if (hist16) {
          hist16[v0]++;
          hist16[v1]++;
        }
        pp[l / 2] = (uint8_t)(v0 | (v1 << 4));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// greedy tokenizer (semantics of utils.cpp:275-311; O(len·maxlen))
// ---------------------------------------------------------------------------

struct GioTokenizer {
  std::unordered_map<std::string, int32_t> piece_to_id;  // max id wins
  int32_t max_len = 0;
};

GioTokenizer* gio_tokenizer_new(GioModel* m) {
  auto* t = new GioTokenizer();
  const int n = (int)m->vocab_offsets.size();
  for (int i = 0; i < n; i++) {
    const char* p = (const char*)m->map + m->vocab_offsets[i];
    const int len = (int)m->vocab_lengths[i];
    if (len == 0) continue;
    t->piece_to_id[std::string(p, len)] = i;  // ascending ids: later wins
    t->max_len = std::max(t->max_len, len);
  }
  return t;
}

void gio_tokenizer_free(GioTokenizer* t) { delete t; }

int32_t gio_tokenize(GioTokenizer* t, const uint8_t* text, int32_t text_len,
                     int32_t bos, int32_t* out, int32_t out_cap) {
  int32_t n = 0;
  if (bos && n < out_cap) out[n++] = 1;  // hardcoded BOS id (utils.cpp:286)
  int32_t pos = 0;
  std::string probe;
  while (pos < text_len && n < out_cap) {
    int32_t best = -1;
    const int32_t maxl = std::min(t->max_len, text_len - pos);
    for (int32_t l = maxl; l >= 1; l--) {
      probe.assign((const char*)text + pos, l);
      auto it = t->piece_to_id.find(probe);
      if (it != t->piece_to_id.end()) {
        best = it->second;
        pos += l;
        break;
      }
    }
    if (best < 0) break;  // silently stop at first unmatched byte
    out[n++] = best;
  }
  return n;
}

// ---------------------------------------------------------------------------
// sampler (exact pipeline of utils.cpp:333-428 with true std::mt19937)
// ---------------------------------------------------------------------------

struct GioSampler {
  std::mt19937 rng;
};

GioSampler* gio_sampler_new(uint32_t seed) {
  auto* s = new GioSampler();
  s->rng.seed(seed);
  return s;
}

void gio_sampler_free(GioSampler* s) { delete s; }

int32_t gio_sample_top_p_top_k(GioSampler* s, const float* logits, int32_t n_logits,
                               const int32_t* last_n, int32_t n_last,
                               double repeat_penalty, int32_t top_k, double top_p,
                               double temp) {
  std::vector<std::pair<double, int32_t>> logits_id;
  logits_id.reserve(n_logits);
  std::vector<uint8_t> in_last(n_logits, 0);
  for (int32_t i = 0; i < n_last; i++) {
    if (last_n[i] >= 0 && last_n[i] < n_logits) in_last[last_n[i]] = 1;
  }
  const double scale = 1.0 / temp;
  for (int32_t i = 0; i < n_logits; i++) {
    double v = logits[i] * scale;
    if (in_last[i]) {
      // CTRL repetition penalty, sign-dependent (utils.cpp:364-370)
      v = logits[i] < 0.0 ? v * repeat_penalty : v / repeat_penalty;
    }
    logits_id.emplace_back(v, i);
  }
  const int32_t k = std::min(top_k, n_logits);
  std::partial_sort(logits_id.begin(), logits_id.begin() + k, logits_id.end(),
                    [](const auto& a, const auto& b) { return a.first > b.first; });
  logits_id.resize(k);

  double maxl = -INFINITY;
  for (const auto& kv : logits_id) maxl = std::max(maxl, kv.first);
  std::vector<double> probs;
  probs.reserve(k);
  double sum = 0.0;
  for (const auto& kv : logits_id) {
    const double p = exp(kv.first - maxl);
    probs.push_back(p);
    sum += p;
  }
  for (auto& p : probs) p /= sum;
  if (top_p < 1.0) {
    double cumsum = 0.0;
    for (size_t i = 0; i < probs.size(); i++) {
      cumsum += probs[i];
      if (cumsum >= top_p) {
        probs.resize(i + 1);
        logits_id.resize(i + 1);
        break;
      }
    }
    const double inv = 1.0 / cumsum;
    for (auto& p : probs) p *= inv;
  }
  std::discrete_distribution<> dist(probs.begin(), probs.end());
  const int idx = dist(s->rng);
  return logits_id[idx].second;
}

}  // extern "C"
