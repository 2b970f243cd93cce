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
// bfloat16 (ast_tpu's compute_dtype bfloat16): the packed [wx; wh] in
// bf16, each product's inputs (the layer below's output and the layer's
// own h) rounded to bf16 as the product stages them into its block's
// shared tile (never in the f32 state it reads), the sums, the bias (not
// rounded, as in ast_tpu), x0_proj, the state and the outputs in f32.
// The waves run on the tensor cores (decode_step.cu's mma_wave_kernel:
// mma.sync m16n8k16 bf16 -> f32), the pack in their B-fragment order: per
// (layer, direction) (H / 16 column blocks, K / 32, 2048), the same
// offsets as the f32 layout; a 32-row tile of layers above 0 lies in one
// of their two input segments, H being a multiple of 32.  Train mode at
// bf16 stores the four residual streams in bf16 (ast_tpu's res_dtype =
// wh.dtype; x_drop = round(h * keep_scale)); the recurrence carries f32
// h, c and dropped h as eval mode carries h and c -- h and the dropped h
// of step t in slot t & 1, c in place -- so h_fin and c_fin leave f32.
#include "common.cuh"

namespace {

using ast::EncCell;
using ast::Prod;
using ast::Seg;

// One encoder call.  Eval: hbuf, c.  Train: the residual streams, zero,
// and the dropout; train at bf16: the bf16 streams and hbuf, xbuf, c.
struct Encoder {
  const float* x0;
  const void* w;  // float, or __nv_bfloat16 when bf16
  const float* b;
  float* outs;
  float* hbuf;
  float* xbuf;
  float* c;
  float* acts;
  float* c_all;
  float* h_pre;
  float* x_drop;
  __nv_bfloat16 *acts16, *c16, *h16, *x16;
  const float* zero;
  int L, D2, B, H;
  int row_offset, global_rows;  // the rows' place in the global batch
  unsigned seed, threshold;
  float keep_scale;
  bool train, bf16;
};

// The dropout mask's flat index of direction d's first row: the mask runs
// over the global batch's (D2, global_rows, H), of which this call holds
// rows row_offset .. row_offset + B - 1 (ast_tpu's _drop_mask with
// row_offset / global_rows), in uint32 arithmetic as the hash's.
unsigned mask_flat0(const Encoder& e, int d) {
  return ((unsigned)d * (unsigned)e.global_rows + (unsigned)e.row_offset) *
         (unsigned)e.H;
}

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
  const long slots = (long)L * D2 * BH;  // one slot of hbuf / xbuf
  if (e.train && e.bf16) {
    if (l) x_in = e.xbuf + (t & 1) * slots + (ld - D2) * BH;
    h_prev = e.hbuf + ((t - 1) & 1) * slots + ld * BH;
    p->out = e.hbuf + (t & 1) * slots + ld * BH;
    p->c_in = e.c + ld * BH;
    p->c_out = e.c + ld * BH;
    x->x_drop = e.xbuf + (t & 1) * slots + ld * BH;
    x->acts16 = e.acts16 + (tl * D2 + d) * e.B * H4;
    x->c16 = e.c16 + at;
    x->h16 = e.h16 + at;
    x->x16 = e.x16 + at;
    x->seed = e.seed + (unsigned)tl;
    x->threshold = e.threshold;
    x->flat0 = mask_flat0(e, d);
    x->keep_scale = e.keep_scale;
  } else if (e.train) {
    if (l) x_in = e.x_drop + at - D2 * BH;
    h_prev = t ? e.h_pre + before : e.zero + d * BH;
    p->out = e.h_pre + at;
    p->c_in = t ? e.c_all + before : e.zero + d * BH;
    p->c_out = e.c_all + at;
    x->acts = e.acts + (tl * D2 + d) * e.B * H4;
    x->x_drop = e.x_drop + at;
    x->seed = e.seed + (unsigned)tl;
    x->threshold = e.threshold;
    x->flat0 = mask_flat0(e, d);
    x->keep_scale = e.keep_scale;
  } else {
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
  return e.bf16 ? ast::launch_cell_wave_bf16(w, e.train, s)
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
// Dropout mask of layer l at step t: seed + t * L + l over (D2,
// global_rows, H), of which the call's B rows are rows row_offset ..
// row_offset + B - 1 (a data-parallel rank's shard; 0 and B for a whole
// batch); kept values times keep_scale = 1 / (1 - rate); threshold 0 = no
// dropout.
AST_EXPORT int k1_encoder_forward_train(
    const float* x0, const float* w, const float* b, float* outs,
    float* acts, float* c_all, float* h_pre, float* x_drop,
    const float* zero, const int* cells, const int* wave_start, int n_waves,
    int L, int D2, int B, int H, int row_offset, int global_rows,
    unsigned seed, unsigned threshold, float keep_scale, void* stream) {
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
  e.row_offset = row_offset;
  e.global_rows = global_rows;
  e.seed = seed;
  e.threshold = threshold;
  e.keep_scale = keep_scale;
  e.train = true;
  return run_waves(e, cells, wave_start, n_waves,
                   static_cast<cudaStream_t>(stream));
}

// Train mode at bf16: w the packed [wx; wh] in bfloat16; the residual
// streams acts, c_all, h_pre, x_drop in bfloat16 (shapes as above); the
// f32 state, zero on entry: hbuf and xbuf (2, L, D2, B, H) -- h and the
// dropped output of step t in slot t % 2, the final h in slot (T - 1) % 2
// after the call -- and c (L, D2, B, H), the final c after the call.
AST_EXPORT int k1_encoder_forward_train_bf16(
    const float* x0, const __nv_bfloat16* w, const float* b, float* outs,
    __nv_bfloat16* acts, __nv_bfloat16* c_all, __nv_bfloat16* h_pre,
    __nv_bfloat16* x_drop, float* hbuf, float* xbuf, float* c,
    const int* cells, const int* wave_start, int n_waves, int L, int D2,
    int B, int H, int row_offset, int global_rows, unsigned seed,
    unsigned threshold, float keep_scale, void* stream) {
  Encoder e = {};
  e.x0 = x0;
  e.w = w;
  e.b = b;
  e.outs = outs;
  e.acts16 = acts;
  e.c16 = c_all;
  e.h16 = h_pre;
  e.x16 = x_drop;
  e.hbuf = hbuf;
  e.xbuf = xbuf;
  e.c = c;
  e.L = L;
  e.D2 = D2;
  e.B = B;
  e.H = H;
  e.row_offset = row_offset;
  e.global_rows = global_rows;
  e.seed = seed;
  e.threshold = threshold;
  e.keep_scale = keep_scale;
  e.train = true;
  e.bf16 = true;
  return run_waves(e, cells, wave_start, n_waves,
                   static_cast<cudaStream_t>(stream));
}
