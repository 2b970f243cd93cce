// Fast Kaldi text-ark parser.
//
// Native-runtime replacement for the reference's line-by-line Python text
// ark parsing (reference: linking_files/kaldi_io.py:12-53), which is the
// slowest host-side stage of the offline feature pipeline: a text ark for
// one Fisher conversation is tens of MB of ASCII floats.  This parser
// does a single pass over an mmap-friendly buffer with strtof, emitting
// one contiguous float32 block plus per-utterance row offsets; the Python
// side slices views out of it with zero copies.
//
// Build: g++ -O3 -march=native -shared -fPIC ark_parser.cc -o libastio.so

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct ArkResult {
  float* data;       // concatenated row-major floats
  long long n_floats;
  long long* rows;   // rows per utterance
  long long n_utts;
  int cols;
  char* names;       // '\n'-joined utterance ids
  long long names_len;
};

ArkResult* ark_parse_text(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(size + 1);
  if (!buf || fread(buf, 1, size, f) != (size_t)size) {
    fclose(f);
    free(buf);
    return nullptr;
  }
  fclose(f);
  buf[size] = '\0';

  std::vector<float> data;
  data.reserve(size / 8);
  std::vector<long long> rows;
  std::string names;
  long long cur_rows = 0;
  int cols = 0, cur_cols = 0;
  bool counting_cols = true;
  // structural state: a token OUTSIDE '[...]' is always an utterance
  // id — a digits-only id (e.g. "123") must not be consumed as a float
  // datum, which would silently fold the id into the feature data
  bool in_matrix = false;

  char* p = buf;
  char* end = buf + size;
  while (p < end) {
    // skip whitespace
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
      p++;
    if (p >= end) break;

    if (*p == '[') {
      in_matrix = true;
      p++;
      continue;
    }
    if (*p == ']') {
      // end of matrix: close current row + utterance
      if (cur_cols > 0) {
        cur_rows++;
        if (counting_cols) { cols = cur_cols; counting_cols = false; }
        cur_cols = 0;
      }
      rows.push_back(cur_rows);
      cur_rows = 0;
      in_matrix = false;
      p++;
      continue;
    }

    char* tok_end;
    float v = in_matrix ? strtof(p, &tok_end) : 0.0f;
    bool is_number =
        in_matrix && tok_end != p &&
        (*tok_end == ' ' || *tok_end == '\n' || *tok_end == '\r' ||
         *tok_end == '\t' || *tok_end == ']' || tok_end == end);
    if (is_number) {
      data.push_back(v);
      cur_cols++;
      // detect row end (newline before next non-space token)
      char* q = tok_end;
      while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
      if (q < end && *q == '\n') {
        cur_rows++;
        if (counting_cols) { cols = cur_cols; counting_cols = false; }
        cur_cols = 0;
      }
      p = tok_end;
    } else {
      // utterance id token runs to whitespace (a non-numeric token
      // inside a matrix also lands here; the Python-side consistency
      // checks then reject the parse and fall back)
      char* q = p;
      while (q < end && *q != ' ' && *q != '\n' && *q != '\t' && *q != '\r')
        q++;
      if (!names.empty()) names.push_back('\n');
      names.append(p, q - p);
      p = q;
    }
  }

  ArkResult* r = (ArkResult*)malloc(sizeof(ArkResult));
  r->n_floats = (long long)data.size();
  r->data = (float*)malloc(sizeof(float) * data.size());
  memcpy(r->data, data.data(), sizeof(float) * data.size());
  r->n_utts = (long long)rows.size();
  r->rows = (long long*)malloc(sizeof(long long) * rows.size());
  memcpy(r->rows, rows.data(), sizeof(long long) * rows.size());
  r->cols = cols;
  r->names_len = (long long)names.size();
  r->names = (char*)malloc(names.size() + 1);
  memcpy(r->names, names.c_str(), names.size() + 1);
  free(buf);
  return r;
}

void ark_free(ArkResult* r) {
  if (!r) return;
  free(r->data);
  free(r->rows);
  free(r->names);
  free(r);
}

}  // extern "C"
