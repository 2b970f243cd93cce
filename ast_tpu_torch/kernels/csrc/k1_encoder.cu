// K1: fused stacked (bi)LSTM encoder, eval and train mode.
//
// Replaces ast_tpu/ops/fused_lstm.py _fwd_kernel (via _forward /
// fused_stacked_lstm): all L layers x D2 directions of the recurrence
// from the hoisted layer-0 projection x0_proj.  Train mode adds hash
// dropout on every layer's output and streams the residuals K2 needs.
//
// What bounds it on the H100: the recurrence is sequential in time, and
// a cell (step t, layer l, one direction) is a small product -- B rows x
// (H or 2H) inputs x 4H outputs -- so the run is bound by the chain of
// dependent launches and by what one launch can pull from L2 (the
// encoder's f32 weights are L2-resident), not by FLOPs.  Design: cell
// (t, l) needs only (t - 1, l) and (t, l - 1), so the cells with t + l = w
// are independent and run as ONE launch, wave w: up to L x D2 products
// side by side, T + L - 1 launches in all (the schedule comes from the
// wrapper, ops/fused_lstm.wave_schedule).  A wave is decode_step.cu's
// product with a table of groups (Wave): a block owns 64 gate columns --
// all four gates of 16 units -- of one cell for all B rows and walks that
// cell's whole input axis, its weight tiles arriving as 8 KB bulk copies
// from the layout ops/fused_lstm.pack_encoder_step_weights makes once per
// call ([layer][direction][column block][k][64], [wx; wh] stacked along
// k); few groups (the first and last L - 1 waves, small H) split the
// input axis over a thread-block cluster instead.  The gate math, layer
// 0's x0_proj row (`pre`), the top layer's copy to outs and, in train
// mode, the gates, the dropout and the residual stores run in the
// product's epilogue.  Every launch is a programmatic dependent launch.
// Eval keeps h of layer l at step t in slot t & 1 of the layer's pair: in
// wave w layer l reads its own slot (t - 1) & 1 and layer l - 1's slot
// t & 1 while layer l - 1, one step ahead, writes its slot (t + 1) & 1,
// so two slots do; c is updated in place (one thread owns an element).
// Train mode reads and writes the residual streams themselves.
//
// bfloat16 (eval only; ast_tpu's compute_dtype bfloat16): the packed
// [wx; wh] in bf16, each product's inputs (the layer below's h and the
// layer's own h) rounded to bf16 as the product reads them, the sums, the
// bias (not rounded, as in ast_tpu), x0_proj, the state and the outputs in
// f32 (decode_step.cu's products at W = __nv_bfloat16).
#include "common.cuh"

namespace {

using ast::EncCell;
using ast::Prod;
using ast::Seg;

// One encoder call.  Eval: hbuf, c.  Train: the residual streams, zero,
// and the dropout.
struct Encoder {
  const float* x0;
  const void* w;  // float, or __nv_bfloat16 when bf16
  const float* b;
  float* outs;
  float* hbuf;
  float* c;
  float* acts;
  float* c_all;
  float* h_pre;
  float* x_drop;
  const float* zero;
  int L, D2, B, H;
  unsigned seed, threshold;
  float keep_scale;
  bool train, bf16;
};

// The product of cell (t, l) in direction d.
void cell_group(const Encoder& e, int t, int l, int d, Prod* p, EncCell* x) {
  const int H = e.H, D2 = e.D2, L = e.L;
  const long H4 = 4L * H, BH = (long)e.B * H;
  const long ld = (long)l * D2 + d;               // (layer, direction)
  const long tl = (long)t * L + l;                // (step, layer)
  const long at = (tl * D2 + d) * BH;             // in a (T, L, D2, B, H)
  const long before = ((tl - L) * D2 + d) * BH;   // (t - 1, l)
  *p = Prod{};
  *x = EncCell{};
  const float* x_in = nullptr;  // the layer below's output at step t
  const float* h_prev;
  if (e.train) {
    if (l) x_in = e.x_drop + at - D2 * BH;
    h_prev = t ? e.h_pre + before : e.zero + d * BH;
    p->out = e.h_pre + at;
    p->c_in = t ? e.c_all + before : e.zero + d * BH;
    p->c_out = e.c_all + at;
    x->acts = e.acts + (tl * D2 + d) * e.B * H4;
    x->x_drop = e.x_drop + at;
    x->seed = e.seed + (unsigned)tl;
    x->threshold = e.threshold;
    x->flat0 = (unsigned)(d * BH);
    x->keep_scale = e.keep_scale;
  } else {
    const long slots = (long)L * D2 * BH;
    if (l) x_in = e.hbuf + (t & 1) * slots + (ld - D2) * BH;
    h_prev = e.hbuf + ((t - 1) & 1) * slots + ld * BH;
    p->out = e.hbuf + (t & 1) * slots + ld * BH;
    p->c_in = e.c + ld * BH;
    p->c_out = e.c + ld * BH;
  }
  const char* wb = static_cast<const char*>(e.w);
  const long esize = e.bf16 ? 2 : 4;
  if (l == 0) {
    p->seg[0] = Seg{h_prev, nullptr, H};
    p->nseg = 1;
    p->w = wb + esize * (d * H * H4);
    x->pre = e.x0 + ((long)t * D2 + d) * e.B * H4;
  } else {
    p->seg[0] = Seg{x_in, nullptr, H};
    p->seg[1] = Seg{h_prev, nullptr, H};
    p->nseg = 2;
    p->w = wb + esize * (D2 * H * H4 + (ld - D2) * 2 * H * H4);
  }
  p->bias = e.b + ld * H4;
  p->R = e.B;
  p->N = H;
  if (l == L - 1) x->y_out = e.outs + ((long)t * D2 + d) * BH;
}

cudaError_t launch(const Encoder& e, ast::Wave<EncCell>& w, cudaStream_t s) {
  return e.bf16 ? ast::launch_cell_wave_bf16(w, s)
                : ast::launch_cell_wave(w, e.train, s);
}

// cells: (t, l) pairs; wave i is cells[wave_start[i] .. wave_start[i + 1]).
int run_waves(const Encoder& e, const int* cells, const int* wave_start,
              int n_waves, cudaStream_t s) {
  ast::Wave<EncCell> w;
  for (int i = 0; i < n_waves; ++i) {
    w.n = 0;
    for (int k = wave_start[i]; k < wave_start[i + 1]; ++k) {
      for (int d = 0; d < e.D2; ++d) {
        cell_group(e, cells[2 * k], cells[2 * k + 1], d, &w.p[w.n],
                   &w.x[w.n]);
        if (++w.n == ast::MAX_WAVE_GROUPS) {  // a wide wave takes several
          AST_RETURN_IF_ERR(launch(e, w, s));
          w.n = 0;
        }
      }
    }
    if (w.n) AST_RETURN_IF_ERR(launch(e, w, s));
  }
  return (int)cudaGetLastError();
}

}  // namespace

static int forward_eval(const float* x0, const void* w, const float* b,
                        float* outs, float* hbuf, float* c, const int* cells,
                        const int* wave_start, int n_waves, int L, int D2,
                        int B, int H, bool bf16, void* stream) {
  Encoder e = {};
  e.bf16 = bf16;
  e.x0 = x0;
  e.w = w;
  e.b = b;
  e.outs = outs;
  e.hbuf = hbuf;
  e.c = c;
  e.L = L;
  e.D2 = D2;
  e.B = B;
  e.H = H;
  return run_waves(e, cells, wave_start, n_waves,
                   static_cast<cudaStream_t>(stream));
}

// x0:   (T, D2, B, 4H) layer-0 input projection
// w:    the packed [wx; wh] of every (layer, direction) (see above)
// b:    (L, D2, 4H)
// outs: (T, D2, B, H) top-layer outputs
// hbuf: (2, L, D2, B, H), zero on entry; after the call the final h is in
//       slot (T - 1) % 2
// c:    (L, D2, B, H), zero on entry, the final c on exit
// cells, wave_start, n_waves: the wave schedule (host memory)
AST_EXPORT int k1_encoder_forward(const float* x0, const float* w,
                                  const float* b, float* outs, float* hbuf,
                                  float* c, const int* cells,
                                  const int* wave_start, int n_waves, int L,
                                  int D2, int B, int H, void* stream) {
  return forward_eval(x0, w, b, outs, hbuf, c, cells, wave_start, n_waves,
                      L, D2, B, H, false, stream);
}

// The same with the packed weights w in bfloat16 (everything else f32).
AST_EXPORT int k1_encoder_forward_bf16(const float* x0,
                                       const __nv_bfloat16* w,
                                       const float* b, float* outs,
                                       float* hbuf, float* c,
                                       const int* cells,
                                       const int* wave_start, int n_waves,
                                       int L, int D2, int B, int H,
                                       void* stream) {
  return forward_eval(x0, w, b, outs, hbuf, c, cells, wave_start, n_waves,
                      L, D2, B, H, true, stream);
}

// Train mode.  x0, w, b, outs and the schedule as above; residual
// streams, all (T, L, D2, B, .): acts (4H) [i|f|g|o], c_all, h_pre
// (pre-dropout h), x_drop (post-dropout, the next layer's input and for
// the top layer outs).  zero: (D2, B, H) zeros, the state before t = 0.
// Dropout mask of layer l at step t: seed + t * L + l over (D2, B, H);
// kept values times keep_scale = 1 / (1 - rate); threshold 0 = no dropout.
AST_EXPORT int k1_encoder_forward_train(
    const float* x0, const float* w, const float* b, float* outs,
    float* acts, float* c_all, float* h_pre, float* x_drop,
    const float* zero, const int* cells, const int* wave_start, int n_waves,
    int L, int D2, int B, int H, unsigned seed, unsigned threshold,
    float keep_scale, void* stream) {
  Encoder e = {};
  e.x0 = x0;
  e.w = w;
  e.b = b;
  e.outs = outs;
  e.acts = acts;
  e.c_all = c_all;
  e.h_pre = h_pre;
  e.x_drop = x_drop;
  e.zero = zero;
  e.L = L;
  e.D2 = D2;
  e.B = B;
  e.H = H;
  e.seed = seed;
  e.threshold = threshold;
  e.keep_scale = keep_scale;
  e.train = true;
  return run_waves(e, cells, wave_start, n_waves,
                   static_cast<cudaStream_t>(stream));
}
