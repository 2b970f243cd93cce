#!/usr/bin/env python3
"""Where a launch of a bf16 product spends its cycles, on one NVIDIA
GPU: the decode step's (K5, K6), the training decoder's (K3's train
cells and linears, K4's backward products and d_cv) and the encoder's
waves (K1's eval and train cells, K2's linears).

    python3 scripts/torch_prod_phases.py [OTHER_DIR]

Copies this checkout's ``ast_tpu_torch`` (and, given OTHER_DIR, that
checkout's too, e.g. the parent unpacked by ``git archive``; each run in
its own process) into ``build/prod_phases/`` and adds ``clock64()`` reads
to ``decode_step.cu``'s product at bf16 (``prod_body``, single or in a
wave, on the tensor cores or on FMAs, whichever the checkout launches):
thread 0 of every block adds, per launch, the cycles of each phase to a
device array, by mode (linear, cell, train cell, backward, encoder cell
wave, encoder train cell wave, wave linear) and row tile.  Then one call
each at bf16 at ``chip_smoke.py``'s shapes (es_en_20h width, B=32, 640
frames -> T'=160, seeded weights): K5 and K6 (stop 175, beam 5,5), K3
(U=64 targets, teacher ratio 0.8, dropout 0.3), K4 (on K3's streams, a
seeded cotangent), K1 eval (over ``decode_weights``' pack), K1 train
(dropout 0.3) and K2 (on K1 train's streams, seeded cotangents); for
each call, each kind's mean cycles a block-launch:

  dep wait       entry to griddepcontrol.wait's return (programmatic
                 dependent launch: overlaps the kernel before it)
  prologue       barrier init and the ring's first tiles issued
  loop top       each tile's block barrier and the next tile's issue
  cp wait        cp.async.wait_group for the tile's input rows
  round          the rounding (into the bf16 tile, or in place) and its
                 block barrier
  mbar wait      the weight tile's bulk copy (mbarrier)
  mma / fma      warp 0's ldmatrix + mma.sync over the tile, or thread
                 0's FMAs
  partials+sync  the partial sums to shared memory and cluster.sync
  epilogue       the cluster's DSMEM reduction and the epilogue (gates
                 and streams, bias + tanh, or the backward's per column)
  final sync     the last cluster.sync

and the card's SM clock beside them.  The clock reads slow the call (its
instrumented time is printed; chip_smoke.py prints the plain one).
Needs a CUDA device; exits 2 without one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = os.path.join(ROOT, "build", "prod_phases")
PHASES = ("dep wait", "prologue", "loop top", "cp wait", "round",
          "mbar wait", "mma / fma", "partials+sync", "epilogue",
          "final sync")
# decode_step.cu's PROD_* modes, in order
MODES = ("linear", "cell", "train cell", "backward", "encoder cell wave",
         "encoder train cell wave", "wave linear")
KINDS = len(MODES) * 17       # mode x row tile / 16 (1 .. 16)

# what thread 0 of a block adds up at the end of a bf16 product
RECORD = """  if constexpr (IS_BF16<W>) {
    if (tid == 0) {
      unsigned long long* g = g_prof[MODE * 17 + RB / 16];
      const long long v[11] = {T1 - T0, Tp - T1, d_top, d_cp, d_conv,
          d_mbar, d_mma, Tq - Tl, Te - Tq, clock64() - Te, 1};
      for (int j = 0; j < 11; ++j)
        atomicAdd(g + j, (unsigned long long)v[j]);
    }
  }
"""

# (anchor in decode_step.cu, text that replaces it): each anchor must
# occur once
PATCH = (
    ("namespace ast {\nnamespace {\n",
     f"namespace ast {{\n__device__ unsigned long long g_prof[{KINDS}][11];"
     "\n"
     "namespace {\n"),
    ("  grid_dep_wait();\n  if (a.done && *a.done) return;  // every block "
     "of the launch alike\n  grid_dep_launch();\n",
     "  const long long T0 = clock64();\n  grid_dep_wait();\n"
     "  if (a.done && *a.done) return;  // every block of the launch alike\n"
     "  grid_dep_launch();\n  const long long T1 = clock64();\n"
     "  long long Tp, Tl, Tq, Te, tt, d_top = 0, d_cp = 0, d_conv = 0,\n"
     "      d_mbar = 0, d_mma = 0;\n"),
    ("    if (s < n_ch) issue(s, c_beg + s);\n    cp_commit();\n  }\n",
     "    if (s < n_ch) issue(s, c_beg + s);\n    cp_commit();\n  }\n"
     "  Tp = clock64();\n"),
    ("  for (int i = 0; i < n_ch; ++i) {\n    __syncthreads();",
     "  for (int i = 0; i < n_ch; ++i) {\n    tt = clock64();\n"
     "    __syncthreads();"),
    ("    cp_commit();\n    cp_wait<STAGES - 1>();  // this thread's rows of "
     "chunk i\n",
     "    cp_commit();\n    d_top += clock64() - tt;\n    tt = clock64();\n"
     "    cp_wait<STAGES - 1>();\n    d_cp += clock64() - tt;\n"
     "    tt = clock64();\n"),
    ("    __syncthreads();        // everyone's\n"
     "    mbar_wait(&full[i % STAGES], (unsigned)(i / STAGES) & 1u);\n",
     "    __syncthreads();\n    d_conv += clock64() - tt;\n"
     "    tt = clock64();\n"
     "    mbar_wait(&full[i % STAGES], (unsigned)(i / STAGES) & 1u);\n"
     "    d_mbar += clock64() - tt;\n    tt = clock64();\n"),
    ("          mma_bf16(macc[t * WM + j], fa, b[j].z, b[j].w);\n      }\n"
     "      continue;\n",
     "          mma_bf16(macc[t * WM + j], fa, b[j].z, b[j].w);\n      }\n"
     "      d_mma += clock64() - tt;\n      continue;\n"),
    # the FMA path's tile ends here
    ("    }\n  }\n  __syncthreads();  // the ring is read; its memory takes "
     "the partials\n",
     "    }\n    d_mma += clock64() - tt;\n  }\n  __syncthreads();\n"
     "  Tl = clock64();\n"),
    ("        P[(rg + RGN * p) * NC + pc] = acc[p][e];\n      }\n  }\n"
     "  cluster.sync();\n",
     "        P[(rg + RGN * p) * NC + pc] = acc[p][e];\n      }\n  }\n"
     "  cluster.sync();\n  Tq = clock64();\n"),
    # the backward's epilogue returns early
    ("    cluster.sync();  // no block leaves while another reads its "
     "partials\n    return;\n",
     "    Te = clock64();\n    cluster.sync();\n" + RECORD
     + "    return;\n"),
    ("      }\n    }\n  }\n  cluster.sync();  // no block leaves while "
     "another reads its partials\n}\n",
     "      }\n    }\n  }\n  Te = clock64();\n  cluster.sync();\n" + RECORD
     + "}\n"),
)

EXPORTS = f"""
AST_EXPORT int ast_prof_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, ast::g_prof, sizeof(ast::g_prof));
}}

AST_EXPORT int ast_prof_reset() {{
  static unsigned long long z[{KINDS}][11] = {{}};
  return (int)cudaMemcpyToSymbol(ast::g_prof, z, sizeof(z));
}}
"""


def instrumented_copy(tree):
    """A copy of ``tree``'s ``ast_tpu_torch`` under build/prod_phases/
    with the clock reads patched into its decode_step.cu; returns the
    directory that holds it."""
    copy = os.path.join(COPIES, hashlib.sha256(tree.encode()).hexdigest()[:8])
    dst = os.path.join(copy, "ast_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "ast_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "kernels", "csrc", "decode_step.cu")
    with open(path) as f:
        src = f.read()
    for old, new in PATCH:
        assert src.count(old) == 1, f"anchor not found once: {old[:60]!r}"
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src + EXPORTS)
    return copy


def calls(cs, dev):
    """{name: fn}: one K5, K6, K3, K4, K1 eval, K1 train and K2 call at
    bf16 at chip_smoke's shapes."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_infer as fi
    from ast_tpu_torch.ops import fused_lstm as fl

    bf = torch.bfloat16
    root = tempfile.mkdtemp()
    _, cfg, _ = cs.make_experiment(root)
    mcfg = cfg.model
    params, state = seq2seq.init_model(mcfg, seed=0, device=dev)
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal(
        (cs.B, cs.FRAMES, 13)).astype(np.float32)).to(dev)
    w = seq2seq.decode_weights(params, bf)
    enc_in = seq2seq.encoder_inputs(params, state, mcfg, X,
                                    enc_w=w["enc"], compute_dtype=bf)
    enc32, h0, c0 = seq2seq.encoder_outputs(
        *fl.stacked_lstm_reference(*enc_in[:4]))
    enc = enc32.to(bf)
    y = rng.integers(4, cs.VOCAB, (cs.U_TRAIN - 1, cs.B)).astype(np.int32)
    coins = (rng.random(cs.U_TRAIN - 1) < cs.TEACH).astype(np.int32)
    coins[0] = 1
    y_in, coins = (torch.from_numpy(a).to(dev) for a in (y, coins))
    w_train = seq2seq.pack_decoder_weights(params, bf)
    dec = (enc, h0, c0, w_train, y_in, coins, 777, cs.DROP, cs.DROP)
    ht, res = fd.decoder_forward(*dec)
    d_ht = torch.from_numpy(rng.standard_normal(tuple(ht.shape)).astype(
        np.float32) * 0.1).to(dev)
    db = (res, ht, enc, c0, w_train, d_ht, 777, cs.DROP, cs.DROP)
    x0, wxr, wh, b, _ = seq2seq.encoder_inputs(params, state, mcfg, X,
                                               train=True, compute_dtype=bf)
    tr = (x0, wxr.to(bf), wh.to(bf), b, 12345, cs.DROP)
    streams = fl.fused_stacked_lstm_train(*tr)
    bwd = (streams[3], streams[4], tr[1], tr[2],
           *(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
               np.float32) * 0.1).to(dev) for t in streams[:3]), 12345,
           cs.DROP)
    shutil.rmtree(root, ignore_errors=True)
    return {
        "K5": lambda: fi.greedy_decode_fused(enc, h0, c0, w, cs.STOP),
        "K6": lambda: fi.beam_decode_fused(enc, h0, c0, w, cs.N_BEAM,
                                           cs.K_BEAM, cs.STOP),
        "K3": lambda: fd.decoder_forward(*dec),
        "K4": lambda: fd.decoder_backward(*db),
        "K1 eval": lambda: fl.fused_stacked_lstm(*enc_in),
        "K1 train": lambda: fl.fused_stacked_lstm_train(*tr),
        "K2": lambda: fl.encoder_backward(*bwd)}


def run(tree):
    """Instrument ``tree``, run the four calls, print each kind's phases."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    copy = instrumented_copy(tree)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, copy)
    import chip_smoke as cs
    from ast_tpu_torch.kernels import build

    assert build.__file__.startswith(copy), build.__file__
    lib = build.library()
    lib.ast_prof_read.argtypes = [ctypes.c_void_p]
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
           "--format=csv,noheader"]
    with torch.inference_mode():
        for name, fn in calls(cs, torch.device("cuda")).items():
            ms = cs.cuda_ms(fn, 1)
            assert lib.ast_prof_reset() == 0
            fn()
            torch.cuda.synchronize()
            buf = np.zeros((KINDS, 11), np.uint64)
            assert lib.ast_prof_read(buf.ctypes.data) == 0
            card = subprocess.run(smi, capture_output=True, text=True,
                                  check=True).stdout.strip()
            print(f"{name} at bf16 ({tree}), instrumented: {ms:.3f} ms a "
                  f"call ({card})", flush=True)
            for kind in range(KINDS):
                n = int(buf[kind, 10])
                if n:
                    mean = buf[kind, :10].astype(np.float64) / n
                    print(f"  {MODES[kind // 17]} product, "
                          f"{(kind % 17) * 16}-row tile: {n} block-launches;"
                          f" cycles a block-launch: " + ", ".join(
                              f"{p} {c:.0f}" for p, c in zip(PHASES, mean))
                          + f"; total {mean.sum():.0f}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_prod_phases: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tree"]:
        run(os.path.abspath(sys.argv[2]))
        return 0
    trees = [ROOT] + [os.path.abspath(d) for d in sys.argv[1:2]]
    for tree in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree], capture_output=True, text=True)
        print(res.stdout, res.stderr[-4000:] if res.returncode else "",
              flush=True)
        if res.returncode:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
