// K2: reverse-time backward of the fused stacked (bi)LSTM encoder.
//
// Replaces ast_tpu/ops/fused_lstm.py _bwd_kernel (via _bwd_rule): walking
// t from T-1 to 0 and l from L-1 to 0, it regenerates each layer's
// dropout mask, applies it to the gradient arriving from above (douts
// for the top layer, dz_{l+1} @ wx^T below it), runs the gate backward
// with the carried dh / dc, and writes dz for every (t, l, d).  The
// weight gradients are time-batched GEMMs outside, as on the TPU.
//
// What bounds it on the H100: like K1, T * L dependent steps of small
// products -- per (t, l) and direction, B rows x 4H inputs x (H or 2H)
// outputs -- bound by launch latency and by re-reading the transposed
// weights (2-4 MB a layer, L2-resident), not by FLOPs.  Design: two
// launches per (t, l), both directions side by side: the elementwise
// cell backward, then one row-wise product dz @ [wh^T | wx^T] that gives
// the next step's dh carry and the layer below's input gradient at once.
// The transposed copy is made once per call by the wrapper, so the
// product is the shared coalesced linear kernel.  Each layer's product
// writes its own [dh | dx] buffer, which the cell backward of the same
// layer (next step) and of the layer below (this step) read; stream
// order separates the reads from the next write, so nothing ping-pongs.
#include "common.cuh"

// acts (T, L, D2, B, 4H), c_all (T, L, D2, B, H): K1's residuals.
// w_t: layer 0's wh^T (D2, 4H, H), then for l >= 1 [wh^T | wx^T]
//      (D2, 4H, 2H), back to back.
// douts (T, D2, B, H): cotangent of the top layer's (post-dropout) output.
// carry: per layer (D2, B, H) for l = 0 and (D2, B, 2H) above, back to
//        back; columns 0..H-1 hold dh_fin on entry.
// dc (L, D2, B, H): dc_fin on entry.  dz (T, L, D2, B, 4H): output.
AST_EXPORT int k2_encoder_backward(const float* acts, const float* c_all,
                                   const float* w_t, const float* douts,
                                   float* carry, float* dc, float* dz,
                                   int T, int L, int D2, int B, int H,
                                   unsigned seed, unsigned threshold,
                                   float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long H4 = 4L * H, BH = (long)B * H, DBH = D2 * BH;
  auto width = [H](int l) { return l ? 2 * H : H; };
  long w_off[64], c_off[64];
  if (L > 64) return (int)cudaErrorInvalidValue;
  for (long l = 0, wo = 0, co = 0; l < L; ++l) {
    w_off[l] = wo;
    c_off[l] = co;
    wo += D2 * H4 * width(l);
    co += (long)D2 * B * width(l);
  }
  for (int t = T - 1; t >= 0; --t) {
    for (int l = L - 1; l >= 0; --l) {
      const long tl = (long)t * L + l;
      const int n = width(l);
      ast::CellBwdArgs c = {};
      if (l == L - 1) {
        c.cons = douts + (long)t * DBH;
        c.cons_g = BH;
        c.cons_ld = H;
      } else {
        c.cons = carry + c_off[l + 1] + H;   // dx of the layer above
        c.cons_g = (long)B * width(l + 1);
        c.cons_ld = width(l + 1);
      }
      c.dh = carry + c_off[l];
      c.dh_g = (long)B * n;
      c.dh_ld = n;
      c.acts = acts + tl * D2 * B * H4;
      c.acts_g = (long)B * H4;
      c.c_new = c_all + tl * DBH;
      c.c_g = BH;
      c.c_prev = t ? c_all + (tl - L) * DBH : nullptr;
      c.cp_g = BH;
      c.dc = dc + (long)l * DBH;
      c.dc_g = BH;
      c.dz = dz + tl * D2 * B * H4;
      c.dz_g = (long)B * H4;
      c.seed = seed + (unsigned)tl;
      c.threshold = threshold;
      c.keep_scale = keep_scale;
      c.mask_g = BH;
      c.R = B;
      c.H = H;
      AST_RETURN_IF_ERR(ast::launch_lstm_cell_bwd(c, D2, s));

      ast::LinearArgs g = {};
      g.xa = ast::Seg{c.dz, (long)B * H4, nullptr, (int)H4};
      g.w = w_t + w_off[l];
      g.w_g = H4 * n;
      g.out = carry + c_off[l];
      g.out_g = (long)B * n;
      g.R = B;
      g.N = n;
      AST_RETURN_IF_ERR(ast::launch_linear(g, s, D2));
    }
  }
  return (int)cudaGetLastError();
}
