// K1: fused stacked (bi)LSTM encoder, inference variant.
//
// Replaces ast_tpu/ops/fused_lstm.py _fwd_kernel (via _forward /
// fused_stacked_lstm, train=False): all L layers x D2 directions of the
// recurrence from the hoisted layer-0 projection x0_proj.
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
// c is updated in place (one thread owns each element).
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
