// Native shorten v2 decoder — the hot path for raw LDC Fisher ingest.
//
// Mirrors ast_tpu/data/shorten.py::decode exactly (that module is the
// readable reference implementation, cross-validated bit-exact against
// libavcodec); this C++ port exists because corpus ingest decodes
// hundreds of hours of 2-channel telephone audio and the Python
// bit-walker runs ~20x realtime while this runs ~2000x.  Equivalence
// is enforced by tests/test_shorten.py::test_native_matches_python on
// randomized streams covering every predictor and option.
//
// Exposed via ctypes from ast_tpu/native/__init__.py (no pybind11 in
// this image).  Reference behavior: shorten v2 bitstream as produced
// for "embedded-shorten" SPHERE (reference pipeline decodes with the
// external sph2pipe: linking_files/fisher/kaldi/local/fsp_data_prep.sh).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kFnSize = 2;
constexpr int kUlongSize = 2;
constexpr int kEnergySize = 3;
constexpr int kBitshiftSize = 2;
constexpr int kLpcqSize = 2;
constexpr int kLpcQuant = 5;
constexpr int kXByteSize = 7;
constexpr int kVerbatimCkSize = 5;
constexpr int kVerbatimByteSize = 8;
constexpr long kV2LpcQOffset = 1L << kLpcQuant;
constexpr int kNWrap = 3;

enum Fn {
  FN_DIFF0 = 0,
  FN_DIFF1 = 1,
  FN_DIFF2 = 2,
  FN_DIFF3 = 3,
  FN_QUIT = 4,
  FN_BLOCKSIZE = 5,
  FN_BITSHIFT = 6,
  FN_QLPC = 7,
  FN_ZERO = 8,
  FN_VERBATIM = 9,
};

struct BitReader {
  const uint8_t* data;
  size_t len;     // bytes
  size_t pos;     // bit position
  bool fail = false;

  inline int bit() {
    size_t byte = pos >> 3;
    if (byte >= len) {
      fail = true;
      return 1;  // terminate unary loops
    }
    int b = (data[byte] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }

  inline uint64_t uvar(int k) {
    uint64_t q = 0;
    while (!bit()) q++;
    if (fail) return 0;
    uint64_t low = 0;
    for (int i = 0; i < k; i++) low = (low << 1) | (uint64_t)bit();
    return (q << k) | low;
  }

  inline long svar(int k) {
    uint64_t u = uvar(k + 1);
    return (long)(u >> 1) ^ -(long)(u & 1);
  }

  inline uint64_t ulong_() {
    uint64_t k = uvar(kUlongSize);
    if (fail || k > 48) {
      fail = true;
      return 0;
    }
    return uvar((int)k);
  }
};

inline long cdiv(long a, long b) {
  long q = (a < 0 ? -a : a) / b;
  return a < 0 ? -q : q;
}

inline long rounded_shift_down(long x, int n) {
  return n == 0 ? x : ((x >> (n - 1)) + 1) >> 1;
}

}  // namespace

extern "C" {

struct ShnResult {
  int32_t* samples;       // interleaved (n * nchan)
  long long n;            // per-channel sample count
  int nchan;
  int ftype;
  uint8_t* verbatim;
  long long verbatim_len;
  const char* error;      // static string; non-null on failure
};

ShnResult* shn_decode(const uint8_t* data, long long len,
                      long long max_samples) {
  ShnResult* res = (ShnResult*)calloc(1, sizeof(ShnResult));
  if (len < 5 || memcmp(data, "ajkg", 4) != 0) {
    res->error = "shorten: bad magic (expected 'ajkg')";
    return res;
  }
  int version = data[4];
  if (version != 1 && version != 2) {
    res->error = "shorten: unsupported version";
    return res;
  }
  BitReader r{data + 5, (size_t)(len - 5), 0};

  long ftype = (long)r.ulong_();
  long nchan = (long)r.ulong_();
  long blocksize = (long)r.ulong_();
  long maxnlpc = (long)r.ulong_();
  long nmean = (long)r.ulong_();
  long nskip = (long)r.ulong_();
  if (r.fail || ftype < 0 || ftype > 10 || nchan < 1 || nchan > 16 ||
      blocksize < 1 || blocksize > (1 << 20) || maxnlpc < 0 ||
      maxnlpc > 1024 || nmean < 0 || nmean > 65536 || nskip < 0 ||
      nskip > (1 << 20)) {
    res->error = "shorten: malformed header";
    return res;
  }
  std::vector<uint8_t> verbatim;
  for (long i = 0; i < nskip; i++)
    verbatim.push_back((uint8_t)r.uvar(kXByteSize));

  long nwrap = maxnlpc > kNWrap ? maxnlpc : kNWrap;
  long mean0 =
      ftype == 2 ? 0x80 : ((ftype == 4 || ftype == 6) ? 0x8000 : 0);
  std::vector<std::vector<long>> hist(nchan,
                                      std::vector<long>(nwrap, 0));
  long n_off = nmean > 0 ? nmean : 1;
  std::vector<std::vector<long>> offset(
      nchan, std::vector<long>(n_off, mean0));
  int bitshift = 0;
  long lpcqoffset = version > 0 ? kV2LpcQOffset : 0;

  std::vector<std::vector<int32_t>> out(nchan);
  std::vector<long> qlpc;
  std::vector<long> buf;
  int chan = 0;
  long long n_done = 0;

  while (true) {
    long cmd = (long)r.uvar(kFnSize);
    if (r.fail) {
      res->error = "shorten: bitstream truncated";
      return res;
    }
    if (cmd == FN_QUIT) break;
    if (cmd == FN_BLOCKSIZE) {
      long bs = (long)r.ulong_();
      if (r.fail || bs < 1 || bs > (1 << 20)) {
        res->error = "shorten: bad blocksize";
        return res;
      }
      blocksize = bs;
      continue;
    }
    if (cmd == FN_BITSHIFT) {
      bitshift = (int)r.uvar(kBitshiftSize);
      if (bitshift > 31) {
        res->error = "shorten: bad bitshift";
        return res;
      }
      continue;
    }
    if (cmd == FN_VERBATIM) {
      long n = (long)r.uvar(kVerbatimCkSize);
      for (long i = 0; i < n && !r.fail; i++)
        verbatim.push_back((uint8_t)r.uvar(kVerbatimByteSize));
      continue;
    }
    if (cmd > FN_VERBATIM) {
      res->error = "shorten: unknown function code";
      return res;
    }

    int resn = 0;
    if (cmd != FN_ZERO) {
      resn = (int)r.uvar(kEnergySize);
      if (version == 0) resn--;
      if (resn < 0 || resn > 40) {
        res->error = "shorten: bad residual size";
        return res;
      }
    }

    long coffset;
    if (nmean == 0) {
      coffset = offset[chan][0];
    } else {
      long sum = version < 2 ? 0 : nmean / 2;
      for (long i = 0; i < nmean; i++) sum += offset[chan][i];
      coffset = version < 2 ? cdiv(sum, nmean)
                            : rounded_shift_down(cdiv(sum, nmean),
                                                 bitshift);
    }

    std::vector<long>& h = hist[chan];
    buf.assign((size_t)blocksize, 0);
    switch (cmd) {
      case FN_ZERO:
        break;
      case FN_DIFF0:
        for (long i = 0; i < blocksize; i++)
          buf[i] = r.svar(resn) + coffset;
        break;
      case FN_DIFF1: {
        long p1 = h[nwrap - 1];
        for (long i = 0; i < blocksize; i++) {
          buf[i] = r.svar(resn) + p1;
          p1 = buf[i];
        }
        break;
      }
      case FN_DIFF2: {
        long p1 = h[nwrap - 1], p2 = h[nwrap - 2];
        for (long i = 0; i < blocksize; i++) {
          buf[i] = r.svar(resn) + 2 * p1 - p2;
          p2 = p1;
          p1 = buf[i];
        }
        break;
      }
      case FN_DIFF3: {
        long p1 = h[nwrap - 1], p2 = h[nwrap - 2], p3 = h[nwrap - 3];
        for (long i = 0; i < blocksize; i++) {
          buf[i] = r.svar(resn) + 3 * (p1 - p2) + p3;
          p3 = p2;
          p2 = p1;
          p1 = buf[i];
        }
        break;
      }
      case FN_QLPC: {
        long nlpc = (long)r.uvar(kLpcqSize);
        if (r.fail || nlpc < 0 || nlpc > nwrap) {
          res->error = "shorten: bad lpc order";
          return res;
        }
        qlpc.assign((size_t)nlpc, 0);
        for (long j = 0; j < nlpc; j++) qlpc[j] = r.svar(kLpcQuant);
        // prediction history, de-offset
        std::vector<long> prev((size_t)nlpc);
        for (long j = 0; j < nlpc; j++)
          prev[j] = h[nwrap - 1 - j] - coffset;
        for (long i = 0; i < blocksize; i++) {
          long acc = lpcqoffset;
          for (long j = 0; j < nlpc; j++) acc += qlpc[j] * prev[j];
          long v = r.svar(resn) + (acc >> kLpcQuant);
          buf[i] = v;
          for (long j = nlpc - 1; j > 0; j--) prev[j] = prev[j - 1];
          if (nlpc) prev[0] = v;
        }
        if (coffset != 0)
          for (long i = 0; i < blocksize; i++) buf[i] += coffset;
        break;
      }
    }
    if (r.fail) {
      res->error = "shorten: bitstream truncated";
      return res;
    }

    if (nmean > 0) {
      long sum = version < 2 ? 0 : blocksize / 2;
      for (long i = 0; i < blocksize; i++) sum += buf[i];
      for (long i = 1; i < nmean; i++)
        offset[chan][i - 1] = offset[chan][i];
      offset[chan][nmean - 1] = version < 2
                                    ? cdiv(sum, blocksize)
                                    : cdiv(sum, blocksize) << bitshift;
    }

    if (blocksize >= nwrap) {
      for (long i = 0; i < nwrap; i++)
        h[i] = buf[blocksize - nwrap + i];
    } else {
      // short block: shift history left, append block
      std::vector<long> merged;
      merged.reserve(nwrap + blocksize);
      merged.insert(merged.end(), h.begin(), h.end());
      merged.insert(merged.end(), buf.begin(), buf.end());
      for (long i = 0; i < nwrap; i++)
        h[i] = merged[merged.size() - nwrap + i];
    }

    std::vector<int32_t>& oc = out[chan];
    if (bitshift) {
      for (long i = 0; i < blocksize; i++)
        oc.push_back((int32_t)(buf[i] << bitshift));
    } else {
      for (long i = 0; i < blocksize; i++)
        oc.push_back((int32_t)buf[i]);
    }

    if (chan == nchan - 1) {
      n_done += blocksize;
      if (max_samples > 0 && n_done >= max_samples) break;
    }
    chan = (chan + 1) % (int)nchan;
  }

  size_t n = out[0].size();
  for (int c = 1; c < nchan; c++)
    if (out[c].size() < n) n = out[c].size();
  int32_t* samples = (int32_t*)malloc(sizeof(int32_t) * n * nchan);
  for (size_t i = 0; i < n; i++)
    for (int c = 0; c < nchan; c++) samples[i * nchan + c] = out[c][i];
  res->samples = samples;
  res->n = (long long)n;
  res->nchan = (int)nchan;
  res->ftype = (int)ftype;
  if (!verbatim.empty()) {
    res->verbatim = (uint8_t*)malloc(verbatim.size());
    memcpy(res->verbatim, verbatim.data(), verbatim.size());
    res->verbatim_len = (long long)verbatim.size();
  }
  return res;
}

void shn_free(ShnResult* res) {
  if (!res) return;
  free(res->samples);
  free(res->verbatim);
  free(res);
}

}  // extern "C"
