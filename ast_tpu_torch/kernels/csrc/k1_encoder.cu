// K1: fused stacked (bi)LSTM encoder, eval and train mode.
//
// Replaces ast_tpu/ops/fused_lstm.py _fwd_kernel (via _forward /
// fused_stacked_lstm): all L layers x D2 directions of the recurrence
// from the hoisted layer-0 projection x0_proj.  Train mode adds hash
// dropout on every layer's output and streams the residuals K2 needs.
//
// What bounds it on the H100: the recurrence is sequential in time, and
// each (step, layer) is a small product -- B rows x (H or 2H) inputs x 4H
// outputs per direction, about 1 MFLOP per row -- so the run is bound by
// the T * L dependent launches and by re-reading each layer's 2-4 MB of
// f32 weights from L2 every step, not by FLOPs.  Design: one launch per
// (step, layer) covering both directions (gridDim.z) and all B rows, so
// the directions run side by side; the host loop issues all T * L
// launches in one call with no synchronisation.  The previous step's h
// is read whole by every block, so h ping-pongs between two buffers;
// c is updated in place (one thread owns each element).  In train mode
// the state lives in the residual streams themselves (step t reads step
// t-1's h_pre / c_all), so nothing ping-pongs, and the extra epilogue
// stores (gates, dropout) ride on the same launches of the cell's train
// variant; the eval launches run the eval kernel unchanged.
#include "common.cuh"

// x0:   (T, D2, B, 4H) layer-0 input projection
// wx:   (L-1, D2, H, 4H), wh: (L, D2, H, 4H), b: (L, D2, 4H)
// outs: (T, D2, B, H) top-layer outputs
// hbuf: (2, L, D2, B, H), zero in slot 0; after the call the final h is
//       in slot T % 2
// c:    (L, D2, B, H), zero on entry, the final c on exit
AST_EXPORT int k1_encoder_forward(const float* x0, const float* wx,
                                  const float* wh, const float* b,
                                  float* outs, float* hbuf, float* c, int T,
                                  int L, int D2, int B, int H,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long H4 = 4L * H, BH = (long)B * H, DBH = (long)D2 * BH;
  const long state = (long)L * DBH;
  for (int t = 0; t < T; ++t) {
    const float* hc = hbuf + (t & 1) * state;
    float* hn = hbuf + ((t + 1) & 1) * state;
    for (int l = 0; l < L; ++l) {
      ast::CellArgs a = {};
      if (l == 0) {
        a.pre = x0 + (long)t * D2 * B * H4;
        a.pre_g = (long)B * H4;
      } else {
        a.xa = ast::Seg{hn + (l - 1) * DBH, BH, nullptr, H};
        a.wx = wx + (long)(l - 1) * D2 * H * H4;
        a.wx_g = (long)H * H4;
      }
      a.hp = ast::Seg{hc + l * DBH, BH, nullptr, H};
      a.wh = wh + (long)l * D2 * H * H4;
      a.wh_g = (long)H * H4;
      a.bias = b + (long)l * D2 * H4;
      a.b_g = H4;
      a.c_in = c + l * DBH;
      a.c_out = c + l * DBH;
      a.c_g = BH;
      a.h_out = hn + l * DBH;
      a.h_g = BH;
      if (l == L - 1) {
        a.y_out = outs + (long)t * DBH;
        a.y_g = BH;
      }
      a.R = B;
      a.H = H;
      AST_RETURN_IF_ERR(ast::launch_lstm_cell(a, D2, s));
    }
  }
  return (int)cudaGetLastError();
}

// Train mode.  x0, wx, wh, b, outs as above; residual streams, all
// (T, L, D2, B, .): acts (4H) [i|f|g|o], c_all, h_pre (pre-dropout h),
// x_drop (post-dropout, the next layer's input and for the top layer
// outs).  zero: (D2, B, H) zeros, the state before t = 0.  Dropout mask
// of layer l at step t: seed + t * L + l over (D2, B, H); kept values
// times keep_scale = 1 / (1 - rate); threshold 0 = no dropout.
AST_EXPORT int k1_encoder_forward_train(
    const float* x0, const float* wx, const float* wh, const float* b,
    float* outs, float* acts, float* c_all, float* h_pre, float* x_drop,
    const float* zero, int T, int L, int D2, int B, int H, unsigned seed,
    unsigned threshold, float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long H4 = 4L * H, BH = (long)B * H, DBH = D2 * BH;
  for (int t = 0; t < T; ++t) {
    for (int l = 0; l < L; ++l) {
      const long tl = (long)t * L + l;   // (step, layer) in the streams
      ast::CellArgs a = {};
      if (l == 0) {
        a.pre = x0 + (long)t * D2 * B * H4;
        a.pre_g = (long)B * H4;
      } else {
        a.xa = ast::Seg{x_drop + (tl - 1) * DBH, BH, nullptr, H};
        a.wx = wx + (long)(l - 1) * D2 * H * H4;
        a.wx_g = (long)H * H4;
      }
      a.hp = ast::Seg{t ? h_pre + (tl - L) * DBH : zero, BH, nullptr, H};
      a.wh = wh + (long)l * D2 * H * H4;
      a.wh_g = (long)H * H4;
      a.bias = b + (long)l * D2 * H4;
      a.b_g = H4;
      a.c_in = t ? c_all + (tl - L) * DBH : zero;
      a.c_out = c_all + tl * DBH;
      a.c_g = BH;
      a.h_out = h_pre + tl * DBH;
      a.h_g = BH;
      if (l == L - 1) {
        a.y_out = outs + (long)t * DBH;
        a.y_g = BH;
      }
      a.R = B;
      a.H = H;
      ast::CellTrain tr = {};
      tr.acts_out = acts + tl * D2 * B * H4;
      tr.acts_g = (long)B * H4;
      tr.x_out = x_drop + tl * DBH;
      tr.x_g = BH;
      tr.seed = seed + (unsigned)tl;
      tr.threshold = threshold;
      tr.keep_scale = keep_scale;
      tr.mask_g = BH;
      AST_RETURN_IF_ERR(ast::launch_lstm_cell(a, D2, s, &tr));
    }
  }
  return (int)cudaGetLastError();
}
