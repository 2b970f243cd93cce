// Shared declarations of the hand-written Hopper kernels (sm_90a).
//
// The per-step building blocks live in step_kernels.cu: an LSTM cell
// step with its gate math fused into the epilogue, a row-wise linear
// layer, and Luong attention of each row against its own encoder rows.
// k1_encoder.cu, k5_greedy.cu and k6_beam.cu drive them from a host-side
// time loop and add the decode-specific kernels (argmax, top-K, beam
// selection, parent gather).  Everything is float32 with FMA
// accumulation; no library GEMM is called.
//
// Every exported entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() as an
// int (0 = every launch was accepted).
#pragma once

#include <cuda_runtime.h>

#define AST_EXPORT extern "C" __attribute__((visibility("default")))

#define AST_RETURN_IF_ERR(expr)                    \
  do {                                             \
    cudaError_t err_ = (expr);                     \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

namespace ast {

constexpr float NEG_INF = -1e30f;
constexpr int PAD_ID = 0;
constexpr int GO_ID = 1;
constexpr int EOS_ID = 2;

// One input segment of a row-wise product.  Row r of the segment is
// src + g * g_stride + row(r) * K, with row(r) = idx ? idx[r] : r and g
// the block's group (the direction, for the encoder).  src == nullptr or
// K == 0 means the segment is absent.
struct Seg {
  const float* src;
  long g_stride;
  const int* idx;
  int K;
};

// One LSTM step for R rows and H units in each of gridDim.z groups:
//   z = [xa | xb] @ wx + hp @ wh + bias (+ pre),  gates [i, f, g, o],
//   c_out = f * c_in + i * g,  h_out = o * tanh(c_out)  (+ y_out copy).
// c_in may equal c_out (each element is read and written by one
// thread); h_out must not alias hp, which other blocks still read.
struct CellArgs {
  Seg xa, xb, hp;
  const float* wx;  long wx_g;   // (xa.K + xb.K, 4H)
  const float* wh;  long wh_g;   // (H, 4H)
  const float* bias; long b_g;   // (4H)
  const float* pre; long pre_g;  // (R, 4H) or nullptr
  const float* c_in; float* c_out; long c_g;  // (R, H)
  float* h_out; long h_g;        // (R, H)
  float* y_out; long y_g;        // (R, H) or nullptr
  int R, H;
  const int* done;               // skip the launch when *done != 0
};

// out = act([xa | xb] @ w + bias), act = tanh or identity.
struct LinearArgs {
  Seg xa, xb;
  const float* w;     // (xa.K + xb.K, N)
  const float* bias;  // (N)
  float* out;         // (R, N)
  int R, N;
  int act_tanh;
  const int* done;
};

// Decoder weights in ast_tpu's layout (models/seq2seq.pack_decoder_weights
// without the vocab padding).
struct DecoderWeights {
  const float* embed;    // (V, E)
  const float* wx0;      // (E + A, 4H)
  const float* wx_rest;  // (L - 1, H, 4H)
  const float* wh;       // (L, H, 4H)
  const float* bias;     // (L, 4H)
  const float* wa;       // (H, H)
  const float* wa_b;     // (H)
  const float* ctx_w;    // (2H, A)
  const float* ctx_b;    // (A)
  const float* out_w;    // (A, V)
  const float* out_b;    // (V)
  int L, H, E, A, V;
};

// Per-step scratch and state of a decoder run over R rows.
struct DecoderStep {
  const int* tok;    // (R) input token of this step
  const float* ht_in;  // (R, A) attentional state of the previous step
  const float* h_in;   // (L, R, H)
  const float* c_in;   // (L, R, H)
  float* h_out;        // (L, R, H), must not alias h_in
  float* c_out;        // (L, R, H), may alias c_in
  float* q;            // (R, H) attention query
  float* cv;           // (R, H) context vector
  float* ht_out;       // (R, A), may alias ht_in
  float* logits;       // (R, V)
};

cudaError_t launch_lstm_cell(const CellArgs& a, int groups, cudaStream_t s);
cudaError_t launch_linear(const LinearArgs& a, cudaStream_t s);
// cv[r] = softmax(enc[r / rows_per_utt] @ q[r]) @ enc[r / rows_per_utt]
cudaError_t launch_attention(const float* enc, const float* q, float* cv,
                             int R, int rows_per_utt, int T, int H,
                             const int* done, cudaStream_t s);
// One decoder step for R rows: embedding gather + input feeding, the
// L-layer LSTM stack, attention, ht = tanh(ctx([cv; h])), logits.
cudaError_t decoder_step(const DecoderWeights& w, const float* enc, int T,
                         int rows_per_utt, const DecoderStep& st, int R,
                         const int* done, cudaStream_t s);

}  // namespace ast
