#!/usr/bin/env python3
"""Smoke test of ast_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing a line:
1. device: the card's name and power limit (nvidia-smi); TF32 off, so
   the plain PyTorch versions run in full float32;
2. build: the hand-written CUDA kernels, compiled from the sources in
   this checkout;
3. each kernel against its plain PyTorch version on the card, at the
   full width of experiments/es_en_20h (B=32, 640 frames, stop 175,
   float32, seeded random weights): K1 outputs within 1e-4, again at the
   partial batches of ENC_PARTIAL and ENC_EVAL_PARTIAL (5 to 64 rows, T'
   of 3 to 140, even and odd) and on DEEP_ENCODER's five-layer stack,
   whose waves take two launches each, and REPEATS more calls at each
   size bit-equal to the first, with the cluster size each wave took.  K5
   and K6
   are compared twice: free-running (rows or utterances whose tokens
   agree with the plain decode must agree exactly, scores within 1e-3),
   and with the plain decoder step run along the kernel's own tokens, so
   every step of every row is checked even after a near-tie has sent the
   two apart: each K5 token within 1e-4 of the step's largest logit and
   PAD once every row has ended; each K6 token within 1e-4 of its
   slot's top K, the chosen scores within 1e-3 of the best N candidates
   (beam scores are sums of ~1e3 in magnitude: an f32 ulp is 6e-5), the
   beam's rules for frozen slots, distinct candidates and the ended
   search, and final scores within 1e-3.  Both run again with an EOS
   logit bias picked so that rows end at staggered steps before the
   stop limit, which drives the kernels' early exit, and along their own
   tokens at the partial batches of PARTIAL (5 to 64 utterances, T' of
   20 to 140, stop 60), which reach every row tiling of the decode
   step's products and attention clusters of 2 to 8 blocks;
4. the serving path through its entry point, ast_tpu_torch.cli.infer,
   on a synthetic es_en_20h experiment (seeded checkpoint, 1098-entry
   BPE vocab, 64 feature files of mixed lengths): after a warm-up call,
   greedy, then beam 5,5, each timed over the whole CLI call (checkpoint
   and file loading included); one output line per input, and every
   kernel's count above 0;
5. the training kernels against their plain versions at es_en_20h width
   (B=32, 640 frames -> T'=160, random targets of U=64, dropout 0.3 /
   0.3, seeded teacher-ratio-0.8 coins, fixed hash seeds): K1 in train
   mode, outputs and residuals within 1e-4 and its dropout zero pattern
   equal to the torch hash mask; K3, with the plain forward run along
   K3's own selected inputs: every sampled id within 1e-4 of the plain
   step's largest logit, the teacher's ids on forced steps, ht and the
   residual streams within 1e-4; K2 and K4 fed the same residuals and
   the cross-entropy loss's own cotangents as their plain versions, every
   output stream within 1e-3 * max|plain| (reverse-time sums over up to
   160 or 63 steps in another order); the whole step's gradient of every
   parameter leaf, through the kernels and through the plain versions
   (along K3's ids), within the same relative 1e-3; each kernel's time
   beside its plain version's; K1 train and K2 again at the partial
   batches of ENC_PARTIAL and on DEEP_ENCODER's stack under the same
   tolerances, masks bit-equal, and
   REPEATS more calls at every size bit-equal to the first; then K3 and
   K4 again at the partial
   batches of TRAIN_PARTIAL (5 to 40 rows, T' of 20 to 140, 12 steps of
   which 5 sample, dropout 0.3), the sizes the trainer's shrunk tail
   batches have and two that fill a row tiling only in part, under the
   same tolerances; the thread-block cluster size every launch of K3
   and K4 took at each of these shapes; and K3 and K4 called REPEATS
   times more at each, every output bit-equal to the first call's (their
   sums run in a fixed order, so a difference would be a launch that
   read or wrote before the one it depends on had ended); then the dev
   loss's settings: K3 with every step teacher-forced and both dropout
   rates 0 against its plain version (ht and streams within 1e-4), and
   seq2seq.forward_loss(train=False) through K1 eval and K3 against the
   same loss through the plain versions, within 1e-4 relative;
6. the training path through its entry point, ast_tpu_torch.cli.train,
   on a synthetic es_en_20h experiment (96 train and 32 dev utterances
   of 100-1,200 frames, Zipf-like targets of 5-40 tokens, es_en_20h's
   train_cfg): two epochs, falling loss, two dev.log rows, a checkpoint
   that decodes through ast_tpu_torch.cli.infer, and every training
   kernel's count above 0; then train utts/s, one step's time split
   into its kernels, the optimizer and the rest (CUDA events), and the
   step's device busy time by kernel group and idle share
   (torch.profiler);
7. the beam CLI, ast_tpu_torch.cli.beam -n 5 -k 5 -w 0.6, over phase 6's
   32 dev utterances: a pickle with one entry an utterance of 5
   hypotheses that begin with GO, one .en line a reference line, a BLEU
   line, K1 eval and K6 launched; --resume launches no kernel and gives
   the same BLEU and .en bytes; --ckpt of phase 6's checkpoint writes the
   _ckpt- files with equal text; beam utts/s over the whole call
   (--save-attn: phase 12);
8. the trainer's machinery on the same experiment: NN.eval_loss(dev)
   through K1 eval and K3 within 1e-4 relative of the same through the
   plain versions; predict and decode_beam_set at decode_pipeline 1 and
   2 (utts/s, and predict's device idle share under torch.profiler); an
   epoch with checkpoint_steps 4 that request_preempt() stops after 5
   batches (PreemptedError, seq2seq_inflight.npz with extra/epoch and
   extra/step), a fresh NN that resumes at that batch, trains exactly the
   rest and saves a checkpoint that loads; two epochs under
   label_smoothing 0.1, random_out 0.1, spec_augment, grad_noise_eta 0.01
   and moments_dtype bfloat16 together: finite, falling-or-level loss,
   K1 train / K2 / K3 / K4 launched, the saved first moment bfloat16
   values that load as bfloat16;
9. serving over HTTP, on phase 4's experiment:
   ast_tpu_torch.cli.export_model --batch 32 --beam 5,5 (the default
   ladder of 400 / 800 / 1,200 / 1,680 frames: 8 entries) and a second,
   greedy directory with --quantize int8; ast_tpu_torch.cli.serve
   --warmup --batch-window-ms 5 as a subprocess, ready on /healthz; the
   64 feature files as binary .npy bodies from one client, greedy then
   beam, each reply's ids bit-equal to the in-process K1 + K5 (or K1 +
   K6 and the rerank) decode of the same row as row 0 of a call at the
   entry's batch, padded to the chosen entry's frames (the server runs
   every call at its entry's static batch, zero rows after the
   requests), its text the port's detokenisation of them, the beam
   score equal; the same 64 from 8 client threads, every reply
   bit-equal to the sequential one (ids, text and score: a row's sums
   depend neither on its batch mates nor on its place among them),
   greedy and beam; requests/s, latency p50 / p90 / p99, device
   calls and batch_occupancy of each run, /stats with 0 errors and its
   kernel_launches: the server process's K1 and K5 (greedy) or K6
   (beam) counts rise in every run, by at most one a device call; 8 seeded 1-12 s audio vectors through /decode and
   /decode_batch, the card's fbank within 1e-3 of the CPU's (PyTorch's
   TF32 default for matmuls, which the server keeps, asserted off), the
   replies equal to the in-process decode of the card's features; SIGTERM
   while a 4-call /decode_batch is in flight: 200, exit 0; the int8
   server's 64 greedy replies, their share of texts equal to f32's, K1
   and K5 launched in its process too.  Phases 7-9 set every count to 0
   before each path and read it after (phase 9's in-process counts are
   its reference decodes');
10. the pretrain -> transfer -> fine-tune workflow through the CLIs: a
   donor shaped as experiments/asr_gpfr (the globalphone loader, its own
   600-entry vocab, 64 train / 16 dev utterances) trained two epochs
   through ast_tpu_torch.cli.train; ast_tpu_torch.cli.copy_params
   --groups enc,attn into a fresh es_en_20h experiment over phase 6's
   data, the copied leaves and BN state bit-equal to the donor's on the
   card and no optimizer state saved; one epoch with optimizer.freeze
   ["cnn", "enc"]: every frozen leaf bit-equal to the donor's, every
   other param leaf moved; --average last:2 equal to NumPy's float64
   mean of epochs 0 and 1, then cli.beam --ckpt on it; --export-chainer
   into a directory that holds only the configs and the .model, whose
   cli.beam pickle, BLEU and .en bytes equal the .npz directory's, and
   one cli.train epoch there resumed at the .model's epoch; the donor's
   dev greedy hypotheses scored by python -m ast_tpu_torch.eval.wer
   against an sclite trn reference.  Every count is set to 0 before the
   phase, and every kernel must launch in it;
11. from raw tapes to a trained model: a raw tree written from a seed --
   N_CONV two-channel 8 kHz tapes of CONV_S s (tape 0 embedded-shorten
   SPHERE by the port's shorten.encode, its encode time printed and kept
   out of the recipe's, the others mu-law SPHERE), LDC .tdf transcript
   tables and a translations file (the AST side) from AUDIO_WORDS-word
   lists, about 300 utterances of 1-12 s; the native and the Python
   shorten decoders in MB/s; ast_tpu_torch.cli.prep_data fisher-recipe
   --device cuda twice, with --wav and without, each stage's seconds;
   the two trees' text side byte-equal, the features tree's .npy files
   within 1e-3 of the CPU fbank + CMVN of the same audio, a wav-mode
   batch featurized and normalised on the card within 1e-3 of the
   features tree's batch of the same utterances, validate --deep with 0
   errors and 0 warnings on both; the train buckets of 8+ utterances by
   --buckets_num; one step at B=32 near FRAMES frames split by CUDA
   events into fbank + CMVN and the rest, beside a features-mode step on
   the same utterances, and the host-to-device bytes of each; cli.train
   -e 2 on the wav tree (falling loss, two dev.log rows, K1 train, K2,
   K3, K4, K1 eval and K5 launched), cli.beam -n 5 -k 5 on its dev split
   (K1 eval, K6); pack-features on the features tree's train split and
   an epoch read from the pack alone; prep_data bnf --device cuda on an
   nnet2 net shaped as a Kaldi BNF net (splice +-4, p-norm layers, a
   42-dim bottleneck) within 1e-4 of --device cpu.  PyTorch's TF32 for
   matmuls is asserted off;
12. the model variants ast_tpu runs on its XLA scan path, at es_en_20h
   width with B=8 rows of 640 frames (T' 160), U=64, decodes to 60 steps:
   ln, rnn_relu, linear_proj, bi_rnn false, n_attn 2, feed_attn false,
   dropout.out 0.3, attn_block_size 32, a conv stack with max_pool and
   leaky_relu, text-encoder input, a model of widths the kernels' shape
   gates turn away (hidden_units 80, 40 a direction, and embedding_units
   100: every stage plain), and the default beside them.  For
   each: the routing predicates equal VARIANT_STAGES (the stages that
   run a kernel); every kernel counter read around one train step, one
   greedy batch and one beam 5,5 batch, above 0 for a stage routed to
   its kernel and 0 for a plain one; the card's loss within 1e-4 and
   every parameter's gradient within 1e-4 of max|CPU| (BWD_TOL where K2
   or K4 is on the path) of the same call on the CPU -- or, where float32
   itself moves a gradient further (LayerNorm, the kinks of ReLU and max
   pooling), the same step in float64 on the card and the CPU within
   1e-9, the training kernels' plain versions in their place; greedy tokens
   within TOK_TOL and beams (top-K, selection, scores) held along the
   card's own path by the plain step on the CPU; ms a train step and
   greedy utts/s.  A beam of 40 (cli.beam -n 40, past K6's 32) on the
   default model: the plain frontier loop (K1 eval launched, K6 not), each
   best hypothesis's score within SCORE_TOL of the plain step along its
   tokens on the CPU.  K1 eval, K1 train and K2 at D2 = 1 (bi_rnn false, 512
   units) against their plain versions at B=32, T' 160 and at
   ENC_PARTIAL's batches, as in phases 3 and 5 (masks equal, REPEATS
   more calls bit-equal, clusters), K1 eval against one cuDNN
   torch.nn.LSTM.  cli.train -e 2 on phase 6's data for an ln +
   rnn_relu model (no kernel launches) and a bi_rnn false + dropout.out
   0.3 + n_attn 2 model (K1 train / K2 / K1 eval only): falling loss,
   two dev.log rows; cli.beam --save-attn on the second: a history (len,
   T') a hypothesis, rows past GO summing to 1 within 1e-5, no K6;
   export_model + cli.serve of a linear_proj model: one request's ids
   equal to the in-process decode.  Then the bf16 pass (compute_dtype
   bfloat16: the scan path's rounding points on the plain stages, the
   kernels' bf16 modes on the kernel stages) over the default model and
   every variant above: one train step, one greedy and one beam batch on
   the card, the bf16 and f32 counters around each (a kernel stage
   launches its bf16 entry and nothing else; the odd-width model no
   kernel), the loss within BF16_LOSS_TOL of the same bf16 call's on the
   CPU.  One comparison a variant, fixed by its stages: with a kernel
   stage every gradient leaf within BF16_MAX_TOL of the CPU's in the
   Frobenius norm (||card - CPU|| / ||CPU||) and the encoder outputs
   within BF16_ENC_TOL; with none (ln, rnn_relu, the odd width: bf16's
   rounding feeds their gradients through LayerNorm before a saturated
   attention and ReLU's kinks, where one value rounding to the other
   bf16 neighbour moves a leaf far) each leaf's and the encoder outputs'
   distance from the float64-sum bf16 step (the same rounding points,
   exact sums, on the CPU) within the larger of those bounds and
   BF16_SPREAD times the CPU's float32-sum distance from it.  The
   max-element distance from the CPU's step is printed beside.  Greedy
   tokens and beams are held along the card's path by the CPU's bf16
   step (K5 / K6's plain bf16 step, or the scan path's) on the card's
   encoder outputs, within BF16_TOK_TOL and BF16_SCORE_TOL.  ms a train
   step and greedy utts/s beside the f32
   pass's.  cli.train -e 1 at bf16 on an ln + rnn_relu experiment and
   cli.beam --save-attn on it (no kernel launched), export_model --dtype
   bfloat16 + cli.serve of the linear_proj model (its server launches
   K5's bf16 entry only): one request's ids equal to the in-process
   bf16 decode.
13. bfloat16 decoding (extras.compute_dtype "bfloat16"), phase 3's model
   and batch: K1 eval, K5 and K6 in their bf16 mode against their plain
   bf16 versions on the card -- encoder states within BF16_ENC_TOL, K5
   tokens along the kernel's own path within BF16_TOK_TOL of the plain
   step's best logit, K6 held to the beam's rules with scores within
   BF16_SCORE_TOL -- at B=32 and at the partial batches of BF16_PARTIAL
   (PARTIAL's: every row tiling of the tensor-core products; K1 at
   ENC_PARTIAL's, ENC_EVAL_PARTIAL's and TRAIN_WIDE's, every row tiling
   of its tensor-core waves, and on DEEP_ENCODER's stack), REPEATS more
   calls bit-equal at every size, each timed beside its f32 mode in the
   same call, K1 beside two cuDNN torch.nn.LSTM in bf16; one K5 and one K6
   call at bf16 split by kernel under torch.profiler (cells, q, ctx,
   logits, attention, argmax or beam step); then cli.infer on phase 4's
   64 files at bf16, greedy and beam (utts/s beside f32, the share of
   utterances whose text equals the f32 decode), export_model --dtype
   bfloat16 (and --quantize int8 of the bf16 experiment) and cli.serve:
   one greedy and one beam request, ids equal to the in-process bf16
   decode.  Then the determinism check: two NNs from one seed train two
   epochs of phase 6's experiment and end with bit-equal parameters, BN
   and optimizer state (one epoch of the NCHW conv family too), and one
   train step's time with the embedding gradient's one-hot sum and with
   index_add_ (before the repair), in turns.
14. bfloat16 training (extras.compute_dtype "bfloat16"), phase 5's model
   and batch: K1 train, K2, K3 and K4 in their bf16 mode against their
   plain bf16 versions on the card, along their own paths -- each output,
   stream and gradient leaf within BF16_MAX_TOL of its own max|plain|:
   K1's outputs and bf16 streams, h_fin / c_fin f32, its dropout zero
   pattern the hash mask; K3 along its own ids (sampled ids within
   BF16_TOK_TOL of the plain step's best logit) and its streams; K2 and
   K4 fed the same streams and cotangents -- and one step at a time,
   each product recomputed from the streams the kernel rounded its
   operands into, within BF16_MAX_TOL and BF16_STEP_TOL of its
   mean|plain| (K3 without dropout between its layers); at B=32, at
   ENC_PARTIAL's / TRAIN_PARTIAL's batches and at D2 = 1 (bi_rnn false),
   all four also at TRAIN_WIDE's 100 to 200 rows (every row tiling of
   their tensor-core products and waves), K1 train and K2 on
   DEEP_ENCODER's stack, REPEATS more calls bit-equal; controls,
   which must fail the one-step checks: the plain versions with one of
   ast_tpu's rounding points dropped standing in for each kernel (K1's
   and K2's product operands, K3's alphas, K4's d_scores unrounded); the
   whole bf16 step's gradient
   of every leaf through the kernels and through the plain versions,
   every leaf f32 and within BF16_MAX_TOL, the loss within
   BF16_LOSS_TOL; no f32 training kernel launched; each kernel's time
   beside its f32 mode's in the same call, and one K3 and one K4 call at
   each dtype split by launch kind under torch.profiler (train cells,
   linears, d_top, layer backward products, attention and its backward,
   select / head, the rest, launch gaps).  Then cli.train -e 2 at bf16
   on phase 6's experiment: falling loss, two dev.log rows, only the bf16
   training and decode kernels launched; NN.eval_loss at bf16 within
   BF16_LOSS_TOL of the same through the plain versions; two NNs from
   one seed end one bf16 epoch bit-equal; a train step at f32 and at
   bf16 in turns (CUDA events split by kernel) and its peak memory
   (torch.cuda.max_memory_allocated), with the peak of each span between
   the fused Functions' forward and backward calls.
15. the feed options and the epoch (the training headline's
   configuration), es_en_20h's model: K1 train, K2, K3 and K4 against
   their plain versions at the epoch's longest bucket (1,680 frames: T'
   420, U 96) at B=32 and at an 8-row tail, at f32 and at bf16 (phase
   5's and phase 14's tolerances, REPEATS more calls bit-equal); then on
   scripts/torch_trainer_epoch_bench.py's corpus over EPOCH_SUBSET
   (build_corpus; 160, 640 and 1,680 frames; zero_input 0.1), at bf16:
   an hbm_cache epoch bit-equal to a host-fed one (losses, parameters,
   BN and optimizer state), with the host-to-device bytes a step of
   each; at steps_per_dispatch 4 an epoch preempted in its fifth step and
   resumed in a fresh NN, bit-equal to the uninterrupted one; one step's
   gradients with and without extras.remat bit-equal, each step's peak
   memory; transfer_dtype bfloat16 / float16 and hbm_cache_dtype
   bfloat16 epochs finite, with their bytes a step; the headline
   configuration (bf16, B 32, G 4, hbm_cache) over two warm epochs:
   utts/s and its kernels' launches (only the bf16 training kernels).
16. data parallelism (ast_tpu_torch.parallel over torch.distributed):
   K1 train, K2, K3 and K4, f32 and bf16, on rows 16-31 of a 32-row
   batch at row_offset 16 (a rank's shard) against their plain versions
   at that offset (phase 5's and phase 14's bounds along the path),
   every dropout mask bit-equal to the global batch's rows; NCCL at
   world size 1 (a one-rank group: the gradient all-reduce, the eval
   gather, replicate's broadcast, the preemption flag); two gloo ranks
   sharing cuda:0 (gloo's all_reduce, broadcast and all_gather on CUDA
   tensors checked first) train DP_EPOCHS epochs of es_en_20h (B = 32,
   16 rows a rank, DP_SUBSET of the epoch benchmark's corpus) through
   NN.train_epoch, then predict and beam-decode the dev split, beside
   one process running the same: the first step's gradient within
   DP_RTOL / DP_ATOL of one process's, the parameters' sha256 equal on
   both ranks, parameters and BN state within the same bounds, both
   ranks' decodes the whole split and equal, every kernel launched on
   each rank; the gloo all-reduce's ms for the gradient and a step's ms,
   two ranks on one card; torchrun --nproc-per-node 1 -m
   ast_tpu_torch.cli.train -e 1 --dist-backend nccl (train.log, dev.log);
17. vocab tensor parallelism (parallel.model_axis): two gloo ranks
   sharing cuda:0 at data 1 x model 2 (dec/out_w, dec/out_b and
   dec/embed split at 549 of VOCAB's 1,098 entries a rank) train
   DP_EPOCHS epochs of phase 16's es_en_20h experiment, then eval_loss,
   predict and beam-decode the dev split and save, beside one process
   running the same: the first step's gradient (its shards gathered)
   and BN state and the last step's optimizer state within DP_RTOL /
   DP_ATOL, the losses and eval_loss within 1e-5, the replicated leaves
   bit-equal on both ranks, the whole parameters against one process's
   (where the first step's sign is sure, within the bounds; after the
   last step at most TP_OUTSIDE of the elements outside), the decodes
   equal on both ranks and to one process's decode of rank 0's
   checkpoint, whose keys and shapes are one process's; K1 train, K2,
   K3, K4, K1 eval, K5 and K6 launched on each rank; then the
   vocab-parallel cross-entropy alone (B = 32, U = 64, A = 512,
   V = 1,098, f32 and bf16, label smoothing and random_out on): loss
   and d_ht against sequence_loss on the card, its ms against
   sequence_loss's and the gloo all-reduce's ms for d_ht, two ranks on
   one card.

Then a JSON line with each kernel's count, error and times, and last
{"ok": true, "device": {...}}.  A kernel's count ("launches") is the
number of calls of its wrapper while its path was driven: K1 (eval), K5
and K6 over the greedy and beam passes of phase 4 (not the warm-up), K1
(train), K2, K3 and K4 over phase 6's two epochs, and the one-direction
rows (k1_d1, k1t_d1, k2_d1) over phase 12's bi_rnn false experiment
(cli.train -e 2 and cli.beam --save-attn), the bf16 rows (k1_bf16,
k5_bf16, k6_bf16) over phase 13's cli.infer passes at bf16, and the bf16
training rows (k1_train_bf16, k2_bf16, k3_bf16, k4_bf16) over phase 14's
cli.train -e 2 at bf16;
"launches_per_unit"
is that count over the served batches (K1 eval, K5, K6) or the train
steps (K1 train, K2, K3, K4) of those runs.  Each call runs the whole
kernel -- every step and layer, many CUDA launches.  "max_abs_err" is
K1's largest state difference, K5's largest shortfall of a chosen
token's logit below the plain step's best, K6's largest score
difference, and for the training kernels the largest difference over
their output streams (the bf16 training rows: the largest error along
the kernel's path over each tensor's own max|plain|, held to
BF16_MAX_TOL).  "ms" and "plain_ms" are phase 3's and phase 5's times
(the bf16 rows' phase 13's and 14's).  "bound_ms" is the least time the
card could take for the same call: the larger of its matrix products'
FLOPs over 67 TFLOP/s (f32 outside the tensor cores; the bf16 rows over
989 TFLOP/s, bf16 dense) and its bytes -- each input read once, each
output written once, the bf16 rows' matrices, encoder states and
(training rows) residual and gradient streams at 2 bytes -- over 3.35
TB/s,
from kernel_cost at the call's
shapes and, for K5 / K6, the steps the timed call ran; "bound_by" says
which ("operations" or "bytes").  "library_ms" is one PyTorch call of
the same function where one exists: for K1 eval two cuDNN torch.nn.LSTM
calls, one per direction stack, on the conv output (so they include the
hoisted layer-0 GEMM), checked against K1's outputs first (one call at
D2 = 1; in bf16 for k1_bf16); null for the others, which no one library
call computes.  "f32_ms" (bf16 rows) is the f32 mode's time in the same
call.  The bf16 training rows also carry "epoch_launches" and
"epoch_launches_per_step": their counts over phase 15's headline epochs.
Any failure raises (exit
code 1, no result line); with no CUDA device it exits 2.  The script
checks that neither JAX nor any module of ast_tpu was imported.
"""

import contextlib
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B, FRAMES, STOP = 32, 640, 175
N_BEAM, K_BEAM = 5, 5
N_UTTS = 64
VOCAB = 1098
TOK_TOL, ENC_TOL, SCORE_TOL = 1e-4, 1e-4, 1e-3
U_TRAIN, DROP, TEACH, NOISE = 64, 0.3, 0.8, 0.25
ENC_SEED, DEC_SEED = 2 ** 31 - 1000, 1234567
BWD_TOL = 1e-3          # relative to max|plain| (reverse-time sums)
EVAL_TOL = 1e-4         # the dev loss, kernels against plain, relative
N_TRAIN, N_DEV = 96, 32
N_ASR, N_ASR_DEV, ASR_VOCAB = 64, 16, 600       # phase 10's donor
# phase 11's raw corpus: tapes, seconds a tape, sample rate, words a
# second, the size of each side's word list and the recipe's BPE merges
# (V lands near es_en_20h's 1,098 on it)
N_CONV, CONV_S, RATE, WORDS_PER_S = 6, 240, 8000, 3.0
AUDIO_WORDS, AUDIO_MERGES = 1100, 1500
# (utterances, T') of the partial-batch decode checks, at T' of the
# infer CLI's length buckets (multiples of 20): with greedy R = B rows
# and beam R = 5 B, these reach every row tiling of decode_step.cu's
# launch_prod (R <= 16: 5, 11; <= 32: 20, 25; <= 64: 55, 64; <= 128:
# 100; > 160: 320, in two 256-row chunks) besides the full batch's R =
# 32 and 160, and attention clusters from 8 blocks (B = 5) down to 2
PARTIAL, PARTIAL_STOP = ((5, 20), (11, 60), (20, 100), (64, 140)), 60
# (rows, T') of the training decoder's partial-batch checks: the trainer
# shrinks a tail batch to 8 or 16 rows (data/dataloader.py tail_rows); 5
# and 11 leave rows of the products' 16-row tile empty, 40 takes the
# 64-row tile.  TRAIN_PARTIAL_COINS: the steps' coins (0 = the step's
# input is sampled).
TRAIN_PARTIAL = ((5, 20), (8, 60), (11, 100), (16, 140), (40, 60))
TRAIN_PARTIAL_COINS = (1, 1, 0, 1, 0, 0, 1, 1, 0, 1, 1, 0)
# (rows, T') past 64 rows, which a train_cfg's batch size may send: K3
# and K4 at bf16 also at these, so that their tensor-core products meet
# the 128-, 160- and 256-row tiles (phase 14)
TRAIN_WIDE = ((100, 60), (150, 60), (200, 60))
# (rows, T') of the encoder's partial-batch checks (K1 eval, K1 train,
# K2): TRAIN_PARTIAL's, a T' below L + 1 (no wave holds every layer) and
# an odd T' (the eval state's slot parity); for K1 eval, which the infer
# CLI sends any count up to its batch, also the 64-row tile filled
ENC_PARTIAL = TRAIN_PARTIAL + ((8, 3), (16, 41))
ENC_EVAL_PARTIAL = ((64, 140),)
# a stack whose full waves (L layers x 2 directions = 10 cells) exceed the
# 8 products one launch takes, so each takes two: (L, H, rows, T')
DEEP_ENCODER = (5, 64, 6, 9)
REPEATS = 20
# the H100 SXM's published peaks (NVIDIA's data sheet, 700 W): float32
# outside the tensor cores, bf16 dense on the tensor cores, and HBM3
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12


def kernel_cost(key, d):
    """(FLOPs of the matrix products, bytes moved) of one call of kernel
    ``key`` ("k1", "k1t", "k2", "k3", "k4", "k5", "k6") at the dims ``d``:
    B, H, L and, for the encoder, T and D2 (directions, H a direction's
    units), for the decoder T, E, A, V and U (K3, K4), n (the steps a K5 /
    K6 call ran), stop, N (K6) and n_logits (K3: the steps whose next
    input is sampled, the only ones that compute logits); ``wbytes`` 2
    for the bf16 modes: the weight matrices (for K5 / K6 the encoder
    states too) and, for the training kernels, the encoder states and
    every residual and gradient stream but ht, the cotangents and the
    final states, which stay f32 (K3 at bf16 writes no x_drop).  Bytes
    count each input read once and each output written once, 4 bytes an
    element but those.  Elementwise work (gates, softmax, dropout, top-K)
    is left out of the FLOPs.  "opt", the optimizer kernel over ``n``
    parameters: no products; launch 1 reads g and p, launch 2 reads g, p,
    mu, nu and nu_max and writes p, mu, nu and nu_max (mu at
    ``mu_bytes``)."""
    if key == "opt":
        n, mb = d["n"], d.get("mu_bytes", 4)
        return 0, n * (8 + 16 + 12 + 2 * mb)
    B, H, L = d["B"], d["H"], d["L"]
    wb = d.get("wbytes", 4)
    if key in ("k1", "k1t", "k2"):
        T, D2 = d["T"], d["D2"]
        flops = 2 * T * D2 * B * 4 * H * H * (2 * L - 1)
        mats, bias = (2 * L - 1) * D2 * H * 4 * H, L * D2 * 4 * H
        fins = 2 * L * D2 * B * H
        if key == "k2":
            streams = T * L * D2 * B * 5 * H + T * L * D2 * B * 4 * H
            return flops, (wb * (mats + streams)
                           + 4 * (T * D2 * B * H + fins))
        ins = bias + T * D2 * B * 4 * H
        if key == "k1":
            return flops, wb * mats + 4 * (ins + T * D2 * B * H + fins)
        # train: the f32 mode's final states are copies of the streams'
        return flops, (wb * (mats + T * L * D2 * B * 7 * H)
                       + 4 * (ins + T * D2 * B * H
                              + (fins if wb == 2 else 0)))
    T, E, A, V = d["T"], d["E"], d["A"], d["V"]
    cell = 4 * H * (E + A + H) + (L - 1) * 4 * H * 2 * H
    attn = H * H + 2 * T * H + 2 * H * A
    dec_w = (V * E + (E + A) * 4 * H + (2 * L - 1) * H * 4 * H + L * 4 * H
             + H * H + H + 2 * H * A + A + A * V + V)
    enc_state = B * T * H + 2 * L * B * H
    # the products' matrices (wbytes; the embedding and biases f32)
    mats = ((E + A) * 4 * H + (2 * L - 1) * H * 4 * H + H * H + 2 * H * A
            + A * V)
    if key == "k3":
        U = d["U"]
        flops = 2 * U * B * (cell + attn) + 2 * d["n_logits"] * B * A * V
        # ht, sel; acts, c, h (and at f32 x_drop), alphas, q, cv, emb
        streams = U * B * (L * (6 if wb == 2 else 7) * H + T + 2 * H + E)
        return flops, (wb * (mats + B * T * H + streams)
                       + 4 * (enc_state - B * T * H + dec_w - mats + U * B
                              + U + U * B * (A + 1)))
    if key == "k4":
        U = d["U"]
        flops = 2 * U * B * (2 * H * A + 2 * T * H + H * H
                             + (2 * L - 1) * 4 * H * H + 4 * H * (E + A))
        mats = 2 * H * A + H * H + (2 * L - 1) * H * 4 * H + (E + A) * 4 * H
        streams = (U * L * B * 5 * H + L * B * H + U * B * T + B * T * H
                   + U * B * (L * 4 * H + A + T + 2 * H + E))
        return flops, (wb * (mats + streams)
                       + 4 * (2 * U * B * A + 2 * L * B * H))
    R = B * d.get("N", 1)
    flops = 2 * d["n"] * R * (cell + attn + A * V)
    outs = d["stop"] * R * (3 if key == "k6" else 1) + (R if key == "k6"
                                                          else 0)
    # the products' matrices and the encoder states in wbytes; the
    # embedding, the biases and the state in f32
    return flops, (wb * (mats + B * T * H)
                   + 4 * (enc_state - B * T * H + dec_w - mats + outs))


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of the two least times, the
    products at ``peak`` FLOP/s."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def make_experiment(root, seed=0):
    """Synthetic es_en_20h experiment: model_cfg.json from the repo, a
    generated BPE vocab, a seeded checkpoint and feature files."""
    from ast_tpu_torch import SYMBOLS, Config
    from ast_tpu_torch.checkpoint import save_checkpoint, unflatten
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.params import to_flat

    exp = os.path.join(root, "exp")
    feats = os.path.join(root, "feats")
    os.makedirs(exp)
    os.makedirs(feats)
    with open(os.path.join(REPO, "experiments", "es_en_20h",
                           "model_cfg.json")) as f:
        model_cfg = json.load(f)
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(model_cfg, f)
    vocab_path = os.path.join(root, "fisher.vocab")
    write_vocab(vocab_path)
    train_cfg = {"seed": "chip-smoke", "batch_size": B,
                 "data": {"enc_key": "sp", "dec_key": "bpe_w",
                          "vocab_path": vocab_path, "max_pred": STOP,
                          "buckets_num": 20, "buckets_width": 80}}
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)
    cfg = Config(exp)
    params, state = seq2seq.init_model(cfg.model, seed=seed)
    tree = unflatten(to_flat(params, state))
    save_checkpoint(os.path.join(exp, "seq2seq_1.model.npz"),
                    tree["params"], tree["state"])
    rng = np.random.default_rng(seed + 1)
    paths = []
    for i in range(N_UTTS):
        T = int(rng.integers(100, 1200))
        path = os.path.join(feats, f"utt{i:03d}.npy")
        np.save(path, rng.standard_normal((T, 13)).astype(np.float32))
        paths.append(path)
    return exp, cfg, paths


def write_vocab(path, size=VOCAB, stem="w"):
    """A ``size``-entry BPE vocab pickle of words ``<stem><i>`` (every
    third a joiner); returns its words, id 4 onwards."""
    from ast_tpu_torch import SYMBOLS

    words = [(f"{stem}{i}@@" if i % 3 == 0 else f"{stem}{i}").encode()
             for i in range(size - SYMBOLS.N_SPECIAL)]
    w2i = {w: i for i, w in enumerate(SYMBOLS.START_VOCAB + words)}
    vocab = {"bpe_w": {"w2i": w2i, "i2w": {i: w for w, i in w2i.items()},
                       "freq": {w: 1 for w in words}}}
    with open(path, "wb") as f:
        pickle.dump(vocab, f)
    return words


def eos_bias(enc, h0, c0, w):
    """An EOS logit bias under which the rows' greedy decodes end at
    staggered steps, all within 3/4 of STOP.  A row's decode is unchanged
    up to the first step where its EOS logit comes within the bias of the
    largest, so one unbiased plain decode gives every row's finishing step
    under any bias; of the biases 1e-3 above a gap on that path, the one
    with the most distinct finishing steps is taken (None if none ends
    every row in time)."""
    import torch

    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.ops import fused_infer

    nb = enc.shape[0]
    word = torch.full((nb,), SYMBOLS.GO_ID, device=enc.device)
    h, c, ht = h0, c0, enc.new_zeros((nb, w["ctx_w"].shape[1]))
    gaps = []
    for _ in range(STOP):
        logits, h, c, ht, _ = fused_infer.decode_step_reference(
            w, enc, h, c, ht, word)
        word = logits.argmax(dim=-1)
        gaps.append(logits.amax(dim=-1) - logits[:, SYMBOLS.EOS_ID])
    least = torch.stack(gaps, 1).cummin(dim=1).values.cpu().numpy()
    last = STOP * 3 // 4
    best, best_n = None, 1
    for beta in np.unique(least[:, :last]) + 1e-3:
        ended = least[:, :last] < beta
        n = len(np.unique(ended.argmax(axis=1)))
        if ended[:, -1].all() and n > best_n:
            best, best_n = float(beta), n
    return best


def beam_ends(val):
    """(steps run, steps where some utterance has ended and another has
    not) of a beam search's valid stream (stop, B, N)."""
    live = val != 0
    return (int(live.any(dim=(1, 2)).sum()),
            int(((~live).all(dim=2).any(dim=1) & live.any(dim=(1, 2))).sum()))


def with_eos_bias(w, beta):
    """The decoder weights with ``beta`` added to the EOS logit, the
    decode step's layout packed anew."""
    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.ops import fused_infer

    w = dict(w)
    w["out_b"] = w["out_b"].clone()
    w["out_b"][SYMBOLS.EOS_ID] += beta
    w["step"] = fused_infer.pack_decode_step(w)
    return w


def check_greedy(enc, h0, c0, w, stop=STOP, tok_tol=TOK_TOL):
    """K5 against its plain version, both free-running and stepped along
    the kernel's own tokens: every kernel token within ``tok_tol`` of the
    plain step's largest logit, and PAD from the step after which every
    row has emitted EOS.  Returns (preds, numbers)."""
    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.ops import fused_infer

    tok = fused_infer.greedy_decode_fused(enc, h0, c0, w, stop)
    ref = fused_infer.greedy_reference(enc, h0, c0, w, stop)
    short, n_run = fused_infer.greedy_follow(enc, h0, c0, w, tok)
    short = float(short.max())
    assert short <= tok_tol, (
        f"K5 chose a token whose logit is {short} below the plain step's "
        f"largest")
    assert (tok[:, n_run:] == SYMBOLS.PAD_ID).all(), (
        f"K5 wrote other than PAD after step {n_run}, where every row has "
        f"finished")
    return tok, dict(shortfall=short, steps=n_run,
                     rows_equal=int((tok == ref).all(dim=1).sum()))


def check_beam(enc, h0, c0, w, stop=STOP, tok_tol=TOK_TOL,
               score_tol=SCORE_TOL):
    """K6 against its plain version, free-running (utterances whose
    streams are equal must give equal hypotheses, lengths and scores) and
    stepped along the kernel's own streams, where every step of every
    utterance is held to the beam's rules: chosen tokens within
    ``tok_tol`` of their slot's top K, the chosen scores within
    ``score_tol`` of the best N candidates, frozen slots continued by EOS
    with valid 0, no candidate twice, and EOS / identity parents / valid
    0 once every slot has finished; final scores within ``score_tol``.
    Returns (valid stream, numbers)."""
    from ast_tpu_torch.ops import fused_infer

    k_tok, k_par, k_val, k_scores = fused_infer.beam_search_streams(
        enc, h0, c0, w, N_BEAM, K_BEAM, stop)
    f_scores, topk_short, sel_err, bad = fused_infer.beam_follow(
        enc, h0, c0, w, N_BEAM, K_BEAM, k_tok, k_par, k_val)
    assert not bad.any(), (
        f"K6 streams break the beam's rules at (step, utterance) "
        f"{bad.nonzero().tolist()[:8]}")
    topk_short, sel_err = float(topk_short.max()), float(sel_err.max())
    assert topk_short <= tok_tol, (
        f"K6 chose a token {topk_short} below its slot's top K")
    assert sel_err <= score_tol, (
        f"K6's selection is {sel_err} off the best N candidates")
    live = f_scores > fused_infer.NEG_INF / 2
    s_err = float((k_scores - f_scores).abs()[live].max())
    assert s_err <= score_tol, f"K6 scores disagree: {s_err}"

    r_hyps, r_scores, r_lens, r_tok, r_par, r_val = \
        fused_infer.beam_reference(enc, h0, c0, w, N_BEAM, K_BEAM, stop,
                                   trace=True)
    pair_eq = ((k_tok == r_tok) & (k_par == r_par)
               & (k_val == r_val)).all(dim=2)          # (step, utterance)
    same = pair_eq.all(dim=0)
    k_hyps, k_lens = fused_infer.backtrack(k_tok, k_par, k_val)
    assert (k_lens[same] == r_lens[same]).all(), "K6 lengths disagree"
    assert (k_hyps[same] == r_hyps[same]).all(), "K6 hypotheses disagree"
    free_err = (float((k_scores - r_scores).abs()[same].max())
                if same.any() else 0.0)
    assert free_err <= score_tol, f"K6 scores disagree: {free_err}"
    return k_val, dict(
        score_err=max(s_err, free_err), topk_short=topk_short,
        sel_err=sel_err, utts_equal=int(same.sum()),
        pairs_equal=int(pair_eq.sum()), pairs=pair_eq.numel(),
        steps=beam_ends(k_val)[0])


def check_kernels(cfg, device):
    """Phase 3: each kernel vs its plain version at es_en_20h width, and
    K5 / K6 again with an EOS bias, so that rows finish at staggered
    steps and the early exit (post-EOS tokens, PAD tail; frozen slots,
    EOS placeholders, identity parents, valid 0) runs on the card."""
    import torch

    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_infer, fused_lstm

    mcfg = cfg.model
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, FRAMES, 13)).astype(np.float32)).to(device)
    results = {}

    enc_in = seq2seq.encoder_inputs(params, state, mcfg, X)
    got = fused_lstm.fused_stacked_lstm(*enc_in)
    ref = fused_lstm.stacked_lstm_reference(*enc_in)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"K1 encoder: x0_proj {tuple(enc_in[0].shape)}, max abs err "
          f"{err:.3e} (tol {ENC_TOL})", flush=True)
    assert err <= ENC_TOL, f"K1 disagrees with its plain version: {err}"
    T_enc, D2, _, H4e = enc_in[0].shape
    lstms, xs = cudnn_pair(params, state, mcfg, X)
    lib_err = cudnn_pair_err(lstms, xs, got)
    print(f"  cuDNN pair (two torch.nn.LSTM, one per direction stack, from "
          f"the conv output): max abs err {lib_err:.3e} against K1 (tol "
          f"{ENC_TOL})", flush=True)
    assert lib_err <= ENC_TOL, "the cuDNN pair computes another function"
    check_repeats(lambda: fused_lstm.fused_stacked_lstm(*enc_in), got,
                  f"K1 at {B} rows")
    print(f"  clusters at {B} rows: {encoder_clusters(B)}", flush=True)
    for nb, t_enc in ENC_PARTIAL + ENC_EVAL_PARTIAL:
        err = max(err, check_encoder_partial(
            encoder_case(params, nb, t_enc, device)))
    err = max(err, check_encoder_partial(deep_encoder_case(device)))
    results["k1"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fused_lstm.fused_stacked_lstm(*enc_in), 5),
        plain_ms=cuda_ms(lambda: fused_lstm.stacked_lstm_reference(*enc_in),
                         2),
        library_ms=cuda_ms(lambda: [m(x) for m, x in zip(lstms, xs)], 5),
        dims=dict(T=T_enc, D2=D2, B=B, H=H4e // 4, L=enc_in[2].shape[0]))

    enc, h0, c0 = seq2seq.encoder_outputs(*ref)
    w = seq2seq.decode_weights(params)
    beta = eos_bias(enc, h0, c0, w)
    assert beta is not None, "no EOS bias staggers the greedy decode"
    w_eos = with_eos_bias(w, beta)

    _, g = check_greedy(enc, h0, c0, w)
    tok, g_eos = check_greedy(enc, h0, c0, w_eos)
    is_eos = tok == SYMBOLS.EOS_ID
    first_eos = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                            STOP)
    n_finish = len(set(first_eos.tolist()))
    assert g_eos["steps"] < STOP and n_finish > 1, (
        f"the EOS-biased greedy pass ended at step {g_eos['steps']} with "
        f"{n_finish} distinct finishing steps: no staggered early exit")
    for name, r in (("K5 greedy", g), ("K5 greedy, EOS bias", g_eos)):
        print(f"{name}: {B} rows, {r['steps']} of {STOP} steps run, "
              f"{r['rows_equal']} rows equal to the free-running plain "
              f"decode; on the kernel's path every token within "
              f"{r['shortfall']:.3e} of the plain step's best logit (tol "
              f"{TOK_TOL})", flush=True)
    print(f"  EOS bias {beta:.4f}: rows finish at {n_finish} distinct "
          f"steps from {int(first_eos.min())} to {int(first_eos.max())}, "
          f"PAD after step {g_eos['steps']}", flush=True)
    dec_dims = dict(B=B, T=enc.shape[1], H=enc.shape[2], L=h0.shape[0],
                    E=w["embed"].shape[1], A=w["ctx_w"].shape[1],
                    V=w["embed"].shape[0], stop=STOP)
    results["k5"] = dict(
        max_abs_err=max(g["shortfall"], g_eos["shortfall"]),
        rows_equal=g["rows_equal"], rows_equal_eos_bias=g_eos["rows_equal"],
        ms=cuda_ms(lambda: fused_infer.greedy_decode_fused(
            enc, h0, c0, w, STOP), 3),
        plain_ms=cuda_ms(lambda: fused_infer.greedy_reference(
            enc, h0, c0, w, STOP), 2),
        dims=dict(dec_dims, n=g["steps"]))

    _, bm = check_beam(enc, h0, c0, w)
    # the beam ends early only once every slot of every utterance is
    # frozen: the first of these biases under which the plain search does
    for scale in (1, 1.5, 2, 3, 4, 6, 8):
        w_eos = with_eos_bias(w, beta * scale)
        val = fused_infer.beam_reference(enc, h0, c0, w_eos, N_BEAM, K_BEAM,
                                         STOP, trace=True)[5]
        steps, mixed = beam_ends(val)
        if steps < STOP and mixed > 0:
            break
    val, bm_eos = check_beam(enc, h0, c0, w_eos)
    steps, mixed = beam_ends(val)
    assert steps < STOP and mixed > 0, (
        f"the EOS-biased beam pass ran {steps} steps with {mixed} steps "
        f"holding an utterance already ended: no staggered early exit")
    for name, r in (("K6 beam", bm), ("K6 beam, EOS bias", bm_eos)):
        print(f"{name} {N_BEAM},{K_BEAM}: {B} utterances, {r['steps']} of "
              f"{STOP} steps run; {r['utts_equal']} utterances and "
              f"{r['pairs_equal']} of {r['pairs']} (step, utterance) pairs "
              f"equal to the free-running plain search; on the kernel's "
              f"path every step of every utterance checked: top-K "
              f"shortfall {r['topk_short']:.3e} (tol {TOK_TOL}), selection "
              f"{r['sel_err']:.3e} and score {r['score_err']:.3e} max abs "
              f"err (tol {SCORE_TOL})", flush=True)
    print(f"  EOS bias {beta * scale:.4f}: {mixed} steps hold an utterance "
          f"already ended, valid 0 for all after step {steps}", flush=True)
    results["k6"] = dict(
        max_abs_err=max(bm["score_err"], bm_eos["score_err"]),
        utts_equal=bm["utts_equal"], utts_equal_eos_bias=bm_eos["utts_equal"],
        ms=cuda_ms(lambda: fused_infer.beam_decode_fused(
            enc, h0, c0, w, N_BEAM, K_BEAM, STOP), 3),
        plain_ms=cuda_ms(lambda: fused_infer.beam_reference(
            enc, h0, c0, w, N_BEAM, K_BEAM, STOP), 1),
        dims=dict(dec_dims, n=bm["steps"], N=N_BEAM))
    for nb, t_enc in PARTIAL:
        g, bm = check_partial(params, state, mcfg, w, nb, t_enc, device)
        results["k5"]["max_abs_err"] = max(results["k5"]["max_abs_err"],
                                           g["shortfall"])
        results["k6"]["max_abs_err"] = max(results["k6"]["max_abs_err"],
                                           bm["score_err"])
    return results


def encoder_case(params, nb, t_enc, device):
    """Inputs of a partial-batch encoder check: a seeded x0_proj (T', D2,
    nb, 4H) and the model's (wx_rest, wh, b)."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_lstm

    wxr, wh, b = fused_lstm.pack_encoder_weights(
        seq2seq.direction_stacked(params["enc"]["lstm"]))
    _, D2, _, H4 = wh.shape
    x0 = torch.from_numpy(np.random.default_rng(1000 * nb + t_enc)
                          .standard_normal((t_enc, D2, nb, H4))
                          .astype(np.float32)).to(device)
    return x0, wxr, wh, b


def deep_encoder_case(device):
    """The same for DEEP_ENCODER's stack, with seeded random weights."""
    import torch

    L, H, nb, t_enc = DEEP_ENCODER
    rng = np.random.default_rng(L)
    return tuple(
        torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device)
        for shape, scale in (((t_enc, 2, nb, 4 * H), 1.0),
                             ((L - 1, 2, H, 4 * H), 0.2),
                             ((L, 2, H, 4 * H), 0.2), ((L, 2, 4 * H), 0.1)))


def bf16_encoder_cases(params, sizes, device):
    """[(name, (x0_proj, wx_rest, wh, b) in bf16)] of the bf16 encoder
    checks: encoder_case at each (rows, T') of ``sizes``, then
    DEEP_ENCODER's stack."""
    import torch

    cases = [(f"{nb} rows, T' {t_enc}", encoder_case(params, nb, t_enc,
                                                      device))
             for nb, t_enc in sizes]
    L, H, nb, t_enc = DEEP_ENCODER
    cases.append((f"DEEP_ENCODER {L} layers, H {H}, {nb} rows, T' {t_enc}",
                  deep_encoder_case(device)))
    return [(name, (x0, wxr.to(torch.bfloat16), wh.to(torch.bfloat16), b))
            for name, (x0, wxr, wh, b) in cases]


def encoder_clusters(nb):
    """{kind: {column blocks of a wave: cluster size}} of the encoder
    waves launched so far at the row tiling ``nb`` rows take."""
    from ast_tpu_torch.kernels import build

    rows = next(r for r in (16, 32, 64, 128, 160, 256) if nb <= r)
    out = {}
    for c in build.cluster_choices():
        if c["kind"].startswith("encoder") and c["rows"] == rows:
            out.setdefault(c["kind"], {})[c["clusters"]] = c["cluster"]
    return out


def check_encoder_partial(args):
    """K1 eval against its plain version on ``args`` (x0_proj, wx_rest,
    wh, b) within ENC_TOL, and bit-equal over REPEATS more calls; returns
    the max abs err."""
    from ast_tpu_torch.ops import fused_lstm

    t_enc, _, nb, _ = args[0].shape
    L = args[2].shape[0]
    got = fused_lstm.fused_stacked_lstm(*args)
    ref = fused_lstm.stacked_lstm_reference(*args)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    assert err <= ENC_TOL, (
        f"K1 disagrees at {nb} rows, T' {t_enc}, {L} layers: {err}")
    check_repeats(lambda: fused_lstm.fused_stacked_lstm(*args), got,
                  f"K1 at {nb} rows, T' {t_enc}, {L} layers")
    print(f"K1 batch of {nb} rows, T' {t_enc}, {L} layers, {args[0].shape[1]} "
          f"direction(s): max abs err "
          f"{err:.3e}, {REPEATS} more calls bit-equal; clusters "
          f"{encoder_clusters(nb).get('encoder cell wave')}", flush=True)
    return err


def hash_mask_equal(x_drop, seed, rate, device, row_offset=0,
                    global_rows=None):
    """(whether the zero pattern of K1 train's x_drop (T, L, D2, B, H) is
    the torch hash mask's, the mask's dropped share); ``row_offset`` /
    ``global_rows``: the rows' place in a global batch (a shard's)."""
    import torch

    from ast_tpu_torch.ops.dropout import drop_mask

    T, L = x_drop.shape[:2]
    seeds = (seed + torch.arange(T * L, device=device)).view(T, L, 1, 1, 1)
    keep = drop_mask(tuple(x_drop.shape[2:]), rate, seeds, row_axis=1,
                     row_offset=row_offset, global_rows=global_rows,
                     device=device)
    return (bool(((x_drop == 0) == ~keep).all()),
            float((~keep).float().mean()))


def check_encoder_train_partial(x0, wxr, wh, b):
    """K1 train and K2 against their plain versions on these encoder
    inputs with dropout DROP: K1's outputs and residuals within
    ENC_TOL, its zero pattern the hash mask; K2, fed K1's residuals and
    random cotangents, within BWD_TOL of max|plain|; both bit-equal over
    REPEATS more calls.  Returns (K1 train max abs err, K2 max abs err)."""
    import torch

    from ast_tpu_torch.ops import fused_lstm as fl

    t_enc, _, nb, _ = x0.shape
    L, device = wh.shape[0], x0.device
    seed = ENC_SEED + nb
    args = (x0, wxr, wh, b, seed, DROP)
    got = fl.fused_stacked_lstm_train(*args)
    ref = fl.stacked_lstm_reference(x0, wxr, wh, b, True, seed, DROP)
    err1 = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    mask_ok, _ = hash_mask_equal(got[6], seed, DROP, device)
    assert err1 <= ENC_TOL and mask_ok, (
        f"K1 train disagrees at {nb} rows, T' {t_enc}, {L} layers: {err1}, "
        f"mask "
        f"{'equal' if mask_ok else 'differs'}")
    rng = np.random.default_rng(7000 + nb)
    cot = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32) * 0.1).to(device) for t in got[:3]]
    bwd = (got[3], got[4], wxr, wh, *cot, seed, DROP)
    dz = fl.encoder_backward(*bwd)
    rel, err2 = rel_err(dz, fl.encoder_backward_reference(*bwd))
    assert rel <= BWD_TOL, (
        f"K2 disagrees at {nb} rows, T' {t_enc}, {L} layers: {rel} of "
        f"max|plain|")
    check_repeats(lambda: fl.fused_stacked_lstm_train(*args), got,
                  f"K1 train at {nb} rows, T' {t_enc}")
    check_repeats(lambda: fl.encoder_backward(*bwd), dz,
                  f"K2 at {nb} rows, T' {t_enc}")
    cl = encoder_clusters(nb)
    print(f"K1 train / K2 batch of {nb} rows, T' {t_enc}, {L} layers, "
          f"{x0.shape[1]} direction(s): K1 train "
          f"max abs err {err1:.3e}, mask equal; K2 dz {rel:.3e} of "
          f"max|plain|; {REPEATS} more calls of each bit-equal; clusters "
          f"{ {k: v for k, v in cl.items() if k != 'encoder cell wave'} }",
          flush=True)
    return err1, err2


def check_partial(params, state, mcfg, w, nb, t_enc, device):
    """K5 and K6 against their plain versions (check_greedy, check_beam)
    on a partial batch of ``nb`` utterances of T' = ``t_enc``, encoded
    from seeded features, to PARTIAL_STOP steps; returns their numbers."""
    import torch

    from ast_tpu_torch.models import seq2seq

    X = torch.from_numpy(np.random.default_rng(nb).standard_normal(
        (nb, 4 * t_enc, 13)).astype(np.float32)).to(device)
    enc, h0, c0 = seq2seq.encode(params, state, mcfg, X)
    assert enc.shape[1] == t_enc, (enc.shape, t_enc)
    _, g = check_greedy(enc, h0, c0, w, PARTIAL_STOP)
    _, bm = check_beam(enc, h0, c0, w, PARTIAL_STOP)
    print(f"K5 / K6 partial batch of {nb} utterances, T' {t_enc}, "
          f"{g['steps']} / {bm['steps']} of {PARTIAL_STOP} steps run: greedy "
          f"{nb} rows, every token within {g['shortfall']:.3e} of the plain "
          f"step's best logit, {g['rows_equal']} rows equal free-running; "
          f"beam {N_BEAM},{K_BEAM} {nb * N_BEAM} rows, top-K shortfall "
          f"{bm['topk_short']:.3e}, selection {bm['sel_err']:.3e}, score "
          f"{bm['score_err']:.3e}, {bm['utts_equal']} utterances equal "
          f"free-running", flush=True)
    return g, bm


def cudnn_pair(params, state, mcfg, X, dtype=None):
    """K1's yardstick: per direction stack one cuDNN torch.nn.LSTM (3
    layers, the port's weights, b_ih = its bias, b_hh = 0), and its input,
    the conv output (the reverse stack's time-reversed); one of each for
    a unidirectional encoder; in ``dtype`` (default f32).  Returns (lstms,
    inputs)."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops.cnn import conv_frontend

    h_cnn, _ = conv_frontend(params["cnn"], state["cnn_bn"],
                             mcfg["cnn_config"], X)
    seq = h_cnn.transpose(0, 1).contiguous()              # (T', B, C)
    if dtype is not None:
        seq = seq.to(dtype)
    if mcfg["rnn_config"].get("ref_rev_quirk", False):
        rev = torch.cat([seq[:1], seq[1:].flip(0)])
    else:
        rev = seq.flip(0)
    layers = seq2seq.direction_stacked(params["enc"]["lstm"])
    H, D2 = layers[0]["wh"].shape[-2], layers[0]["wh"].shape[0]
    lstms = []
    for d in range(D2):
        m = torch.nn.LSTM(seq.shape[-1], H, num_layers=len(layers),
                          device=seq.device, dtype=seq.dtype)
        with torch.no_grad():
            for l, p in enumerate(layers):
                getattr(m, f"weight_ih_l{l}").copy_(p["wx"][d].t())
                getattr(m, f"weight_hh_l{l}").copy_(p["wh"][d].t())
                getattr(m, f"bias_ih_l{l}").copy_(p["b"][d])
                getattr(m, f"bias_hh_l{l}").zero_()
        m.flatten_parameters()      # cuDNN's one weight buffer
        lstms.append(m)
    return lstms, (seq, rev.contiguous())[:D2]


def cudnn_pair_err(lstms, xs, k1_out):
    """Largest difference of the cuDNN pair's outputs, final h and final c
    from K1's (outs (T, D2, B, H), h_fin, c_fin (L, D2, B, H))."""
    err = 0.0
    for d, (m, x) in enumerate(zip(lstms, xs)):
        y, (h, c) = m(x)
        for a, b in ((y, k1_out[0][:, d]), (h, k1_out[1][:, d]),
                     (c, k1_out[2][:, d])):
            err = max(err, float((a - b).abs().max()))
    return err


def quiet(main, argv):
    """A CLI's ``main(argv)`` with its stdout (one line per file or epoch
    report) captured; returns (main's result, the captured text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


def run_slice(exp, paths, out_dir):
    """Phase 4: greedy then beam through the CLI, with launch counts."""
    import torch

    from ast_tpu_torch.cli import infer
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_infer, fused_lstm

    counters = {"k1": fused_lstm.fused_stacked_lstm,
                "k5": fused_infer.greedy_decode_fused,
                "k6": fused_infer.beam_search_streams}
    # first call: CUDA context, library and cuBLAS start-up stay out of
    # the timed passes and out of the counts
    quiet(infer.main, ["-m", exp, "--device", "cuda", "-o",
                       os.path.join(out_dir, "warmup.txt")] + paths[:2])
    for fn in counters.values():
        fn.launches = 0
    rates, batches = {}, {}
    for name, extra in (("greedy", []),
                        ("beam", ["--beam", f"{N_BEAM},{K_BEAM}"])):
        out = os.path.join(out_dir, f"{name}.txt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # every served batch is encoded once
        with counting(seq2seq, "encode") as calls:
            hyps, _ = quiet(infer.main, ["-m", exp, "--device", "cuda",
                                         "-o", out] + extra + paths)
        batches[name] = calls[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with open(out) as f:
            lines = f.read().splitlines()
        assert len(hyps) == len(paths) == len(lines), (name, len(lines))
        assert [ln.split("\t")[0] for ln in lines] == [
            os.path.splitext(os.path.basename(p))[0] for p in paths]
        assert any(hyps.values()), f"{name}: every hypothesis is empty"
        rates[name] = len(paths) / dt
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        assert n > 0, f"the main path never launched {k}"
    units = {"k1": batches["greedy"] + batches["beam"],
             "k5": batches["greedy"], "k6": batches["beam"]}
    return rates, launches, units


@contextlib.contextmanager
def counting(owner, name):
    """Count the calls of ``owner.name`` inside the block; yields a
    one-element list holding the count."""
    fn = getattr(owner, name)
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    setattr(owner, name, counted)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def tensors(out):
    """The tensors of a kernel wrapper's result (a tensor, or tuples and
    dicts of them), in a fixed order."""
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in tensors(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensors(o)]
    return [out]


def check_repeats(fn, first, name):
    """Call ``fn`` REPEATS times; every tensor of each result must be
    bit-equal to ``first``, an earlier call's result."""
    import torch

    for i in range(REPEATS):
        assert all(torch.equal(a, b)
                   for a, b in zip(tensors(fn()), tensors(first))), (
            f"{name}: call {i + 2} differs from the first")


def rel_err(got, want):
    """max |got - want| / max |want| and max |got - want|."""
    d = float((got - want).abs().max())
    return d / max(float(want.abs().max()), 1e-30), d


def train_batch(device, seed=3):
    """Phase 5's batch: B x FRAMES features, B x U_TRAIN targets (GO,
    random ids, EOS at random lengths, PAD after)."""
    import torch

    from ast_tpu_torch import SYMBOLS

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, FRAMES, 13)).astype(np.float32)
    y = np.full((B, U_TRAIN), SYMBOLS.PAD_ID, np.int64)
    for r in range(B):
        n = int(rng.integers(5, U_TRAIN - 1))
        y[r, 0] = SYMBOLS.GO_ID
        y[r, 1:n] = rng.integers(SYMBOLS.N_SPECIAL, VOCAB, n - 1)
        y[r, n] = SYMBOLS.EOS_ID
    return torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)


def leaf_names(tree, prefix=""):
    """Flat-NPZ style names of a tree's leaves, in leaf order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def step_loss(params, state, mcfg, X, y, n_real, draws, sel=None):
    """The train step's loss, built from the public pieces that
    ``seq2seq.forward_loss`` chains.  Without ``sel``: through the
    kernels (K1 train, K3; K2 and K4 under autograd); returns (loss,
    K3's sampled ids).  With ``sel``: through the plain versions with
    autograd, the decoder along those ids; returns (loss, sel)."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl

    x0, wxr, wh, b, _ = seq2seq.encoder_inputs(
        params, state, mcfg, X * (1.0 + draws.noise), train=True)
    w = seq2seq.pack_decoder_weights(params)
    y_in = y.t()[:-1].to(torch.int32).contiguous()
    if sel is None:
        enc_out = fl.FusedStackedLSTM.apply(x0, wxr, wh, b, draws.enc_seed,
                                            True, DROP)
        enc, h0, c0 = seq2seq.encoder_outputs(*enc_out)
        ht, sel = fd.FusedDecoder.apply(
            enc, h0, c0, *(w[k] for k in fd.W_NAMES), y_in, draws.coins,
            draws.dec_seed, DROP, DROP)
    else:
        enc_out = fl.stacked_lstm_reference(x0, wxr, wh, b, True,
                                            draws.enc_seed, DROP)[:3]
        enc, h0, c0 = seq2seq.encoder_outputs(*enc_out)
        ht = fd.decoder_forward_reference(enc, h0, c0, w, y_in, draws.coins,
                                          draws.dec_seed, DROP, DROP,
                                          forced_ids=sel)[0]
    dec = params["dec"]
    return seq2seq.sequence_loss(ht, dec["out_w"], dec["out_b"], y.t()[1:],
                                 n_real), sel


def check_train_kernels(cfg, device):
    """Phase 5: K1 train, K2, K3, K4 and the whole step's gradient
    against the plain versions; returns per-kernel numbers."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl
    from ast_tpu_torch.train.optimizer import tree_leaves

    mcfg = cfg.model
    assert mcfg["dropout"]["rnn"] == DROP and mcfg["dropout"]["embed"] == DROP
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    X, y = train_batch(device)
    n_real = float(B)
    draws = seq2seq.make_draws(7, X, U_TRAIN - 1, TEACH, NOISE)
    draws.enc_seed, draws.dec_seed = ENC_SEED, DEC_SEED
    results = {}

    with torch.no_grad():
        x0, wxr, wh, b, _ = seq2seq.encoder_inputs(
            params, state, mcfg, X * (1.0 + draws.noise), train=True)
        enc_args = (x0, wxr, wh, b, ENC_SEED, DROP)
        got = fl.fused_stacked_lstm_train(*enc_args)
        ref = fl.stacked_lstm_reference(*enc_args[:4], True, ENC_SEED, DROP)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        T, L = got[3].shape[:2]
        mask_ok, dropped = hash_mask_equal(got[6], ENC_SEED, DROP, device)
        print(f"K1 train: x0_proj {tuple(x0.shape)}, outputs and residuals "
              f"max abs err {err:.3e} (tol {ENC_TOL}); dropout zero pattern "
              f"{'equals' if mask_ok else 'DIFFERS from'} the hash mask "
              f"({dropped:.3f} dropped)", flush=True)
        assert err <= ENC_TOL and mask_ok, "K1 train disagrees"
        check_repeats(lambda: fl.fused_stacked_lstm_train(*enc_args), got,
                      f"K1 train at {B} rows")
        enc_dims = dict(T=T, D2=x0.shape[1], B=B, H=x0.shape[3] // 4, L=L)
        results["k1t"] = dict(
            max_abs_err=err, ms=cuda_ms(lambda: fl.fused_stacked_lstm_train(
                *enc_args), 5),
            plain_ms=cuda_ms(lambda: fl.stacked_lstm_reference(
                *enc_args[:4], True, ENC_SEED, DROP), 2),
            dims=enc_dims)

        enc, h0, c0 = seq2seq.encoder_outputs(*ref[:3])
        w = seq2seq.pack_decoder_weights(params)
        y_in = y.t()[:-1].to(torch.int32).contiguous()
        dec_args = (enc, h0, c0, w, y_in, draws.coins, DEC_SEED, DROP, DROP)
        ht_k, res_k = fd.decoder_forward(*dec_args)
        sel = res_k["sel"]
        ht_p, res_p = fd.decoder_forward_reference(*dec_args,
                                                   forced_ids=sel)
        short = float(fd.sampled_shortfall(ht_p, w, sel, draws.coins).max())
        forced = draws.coins.bool()
        teacher_ok = bool((sel[forced] == y_in[forced]).all())
        err = float((ht_k - ht_p).abs().max())
        for k in fd.RES_NAMES[1:]:
            err = max(err, float((res_k[k] - res_p[k]).abs().max()))
        n_sampled = int((~forced).sum())
        print(f"K3 decoder: {U_TRAIN - 1} steps, {n_sampled} sampled; every "
              f"sampled id within {short:.3e} of the plain step's best logit "
              f"(tol {TOK_TOL}), teacher ids on forced steps "
              f"{'equal' if teacher_ok else 'DIFFER'}; ht and residuals max "
              f"abs err {err:.3e} (tol {ENC_TOL})", flush=True)
        assert n_sampled > 0 and short <= TOK_TOL and teacher_ok \
            and err <= ENC_TOL, "K3 disagrees"
        dec_dims = dict(B=B, T=enc.shape[1], H=enc.shape[2], L=h0.shape[0],
                        E=w["embed"].shape[1], A=w["ctx_w"].shape[1],
                        V=w["embed"].shape[0], U=U_TRAIN - 1)
        results["k3"] = dict(
            max_abs_err=err, sampled_shortfall=short,
            ms=cuda_ms(lambda: fd.decoder_forward(*dec_args), 5),
            plain_ms=cuda_ms(lambda: fd.decoder_forward_reference(
                *dec_args), 2),
            dims=dict(dec_dims, n_logits=n_sampled))

    # the loss's own cotangents at the encoder outputs and at ht
    enc_out = [t.detach().requires_grad_(True) for t in ref[:3]]
    enc, h0, c0 = seq2seq.encoder_outputs(*enc_out)
    ht = fd.decoder_forward_reference(enc, h0, c0, w, y_in, draws.coins,
                                      DEC_SEED, DROP, DROP,
                                      forced_ids=sel)[0]
    loss = seq2seq.sequence_loss(ht, params["dec"]["out_w"],
                                 params["dec"]["out_b"], y.t()[1:], n_real)
    cot = torch.autograd.grad(loss, enc_out + [ht])
    d_enc_out, d_ht = [c.contiguous() for c in cot[:3]], cot[3].contiguous()

    with torch.no_grad():
        bwd = (got[3], got[4], wxr, wh, *d_enc_out, ENC_SEED, DROP)
        dz = fl.encoder_backward(*bwd)
        rel, err = rel_err(dz, fl.encoder_backward_reference(*bwd))
        print(f"K2 encoder backward: dz max abs err {err:.3e}, {rel:.3e} of "
              f"max|plain| (tol {BWD_TOL})", flush=True)
        assert rel <= BWD_TOL, "K2 disagrees"
        check_repeats(lambda: fl.encoder_backward(*bwd), dz, f"K2 at {B} rows")
        print(f"  K1 train and K2 called {REPEATS} times more: every output "
              f"bit-equal to the first call's; clusters at {B} rows: "
              f"{encoder_clusters(B)}", flush=True)
        results["k2"] = dict(
            max_abs_err=err, rel_err=rel,
            ms=cuda_ms(lambda: fl.encoder_backward(*bwd), 5),
            plain_ms=cuda_ms(lambda: fl.encoder_backward_reference(*bwd), 2),
            dims=enc_dims)

        enc, h0, c0 = seq2seq.encoder_outputs(*ref[:3])
        bwd = (res_k, ht_k, enc, c0, w, d_ht, DEC_SEED, DROP, DROP)
        g_k = fd.decoder_backward(*bwd)
        g_p = fd.decoder_backward_reference(*bwd)
        worst = max((rel_err(g_k[k], g_p[k]) + (k,) for k in fd.GRAD_NAMES))
        err = max(rel_err(g_k[k], g_p[k])[1] for k in fd.GRAD_NAMES)
        print(f"K4 decoder backward: {len(fd.GRAD_NAMES)} streams, worst "
              f"{worst[2]} at {worst[0]:.3e} of max|plain| (tol {BWD_TOL}); "
              f"max abs err {err:.3e}", flush=True)
        assert worst[0] <= BWD_TOL, "K4 disagrees"
        results["k4"] = dict(
            max_abs_err=err, rel_err=worst[0],
            ms=cuda_ms(lambda: fd.decoder_backward(*bwd), 5),
            plain_ms=cuda_ms(lambda: fd.decoder_backward_reference(*bwd), 2),
            dims=dec_dims)
        print(f"  clusters at {B} rows, T' {enc.shape[1]}: "
              f"{train_clusters(B, enc.shape[1], w)}", flush=True)
        check_repeats(lambda: fd.decoder_forward(*dec_args), (ht_k, res_k),
                      f"K3 at {B} rows")
        check_repeats(lambda: fd.decoder_backward(*bwd), g_k,
                      f"K4 at {B} rows")
        print(f"  K3 and K4 called {REPEATS} times more, here and at every "
              f"partial batch below: every output bit-equal to the first "
              f"call's", flush=True)
        cases = [encoder_case(params, nb, t_enc, device)
                 for nb, t_enc in ENC_PARTIAL] + [deep_encoder_case(device)]
        for case in cases:
            err1, err2 = check_encoder_train_partial(*case)
            results["k1t"]["max_abs_err"] = max(
                results["k1t"]["max_abs_err"], err1)
            results["k2"]["max_abs_err"] = max(results["k2"]["max_abs_err"],
                                               err2)
        for nb, t_enc in TRAIN_PARTIAL:
            err3, err4 = check_train_partial(params, state, mcfg, nb, t_enc,
                                             device)
            results["k3"]["max_abs_err"] = max(results["k3"]["max_abs_err"],
                                               err3)
            results["k4"]["max_abs_err"] = max(results["k4"]["max_abs_err"],
                                               err4)

    results["dev_loss"] = check_dev_loss(params, state, mcfg, X, y, n_real)

    # the whole step: every parameter's gradient, kernels vs plain
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_k, sel = step_loss(params, state, mcfg, X, y, n_real, draws)
    g_k = torch.autograd.grad(loss_k, leaves)
    loss_p, _ = step_loss(params, state, mcfg, X, y, n_real, draws, sel)
    g_p = torch.autograd.grad(loss_p, leaves)
    with torch.no_grad():
        loss_f = seq2seq.forward_loss(params, state, mcfg, X, y, n_real,
                                      draws)[0].item()
    names = leaf_names(params)
    worst = max(rel_err(a, b) + (n,) for a, b, n in zip(g_k, g_p, names))
    loss_err = abs(loss_k.item() - loss_p.item())
    print(f"train step: loss {loss_k.item():.6f} (plain {loss_p.item():.6f}"
          f", forward_loss {loss_f:.6f}); {len(leaves)} parameter "
          f"gradients, worst leaf {worst[2]} at {worst[0]:.3e} of max|plain| "
          f"(tol {BWD_TOL})", flush=True)
    assert worst[0] <= BWD_TOL and loss_err <= 1e-4 * abs(loss_p.item()), \
        "the step's gradients disagree"
    assert abs(loss_f - loss_k.item()) <= 1e-6 * abs(loss_k.item()), \
        "forward_loss disagrees with its pieces"
    results["step"] = dict(worst_leaf=worst[2], rel_err=worst[0])
    return results


def check_opt_kernel(cfg, device, reps=20):
    """The optimizer kernel (``Optimizer.apply_`` on CUDA tensors) on
    es_en_20h's parameters and optimizer: its global norm (launch 1)
    against the foreach chain's own norm of g + l2 p, as a share of it
    (their one difference is the order of summation: at most 1e-5); one
    step against the chain's (``update`` and the add) from the same
    state, the chain given the kernel's norm, largest difference over
    the largest |update| (0: bit for bit); ``max_abs_err`` the larger of
    the two.  The ms of a step of each (CUDA
    events around ``reps`` steps issued back to back, so a step that the
    host issues slower than the card runs it is timed at the host's
    pace), and of ``torch.optim.Adam(fused=True, amsgrad=True)`` over the
    same leaves (timed only: optax's AMSGrad keeps the maximum of the
    bias-corrected second moment, which it does not).  Its launches a
    train step are counted in phase 6's training run."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.train.optimizer import build_optimizer, tree_leaves

    opt_cfg = {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2}
    gen = torch.Generator(device=device).manual_seed(5)
    sides = {}
    for side in ("kernel", "chain"):
        params, _ = seq2seq.init_model(cfg.model, seed=3, device=device)
        opt, state = build_optimizer(opt_cfg, params)
        sides[side] = (tree_leaves(params), opt, [state])
    leaves = sides["kernel"][0]
    n = sum(p.numel() for p in leaves)
    # gradients as the step's GEMMs leave them (contiguous), norm ~ 4:
    # the clip (2) is active.  The chain's parameters keep init_model's
    # layout, the kernel's are made contiguous at its first step (the
    # values are the same)
    g = [torch.randn(tuple(p.shape), generator=gen, device=device)
         * (4.0 / n ** 0.5) for p in leaves]

    def kernel():
        p, opt, st = sides["kernel"]
        opt.apply_(g, st[0], p)

    def chain():
        p, opt, st = sides["chain"]
        updates, st[0] = opt.update(g, st[0], p)
        torch._foreach_add_(p, tree_leaves(updates))

    before = [p.clone() for p in leaves]
    opt_c, opt_k = sides["chain"][1], sides["kernel"][1]
    ref_norm = float(opt_c._global_norm(torch._foreach_add(
        g, torch._foreach_mul(before, opt_c.l2))))
    opt_c._global_norm = lambda g: opt_k._kernel.norm.clone()
    kernel()
    chain()
    del opt_c._global_norm
    norm_err = abs(float(opt_k._kernel.norm) - ref_norm) / ref_norm
    assert ref_norm > opt_cfg["grad_clip"] and norm_err <= 1e-5, (
        f"optimizer kernel's norm {float(opt_k._kernel.norm)} against "
        f"the chain's {ref_norm}")
    upd = max(float((a - b).abs().max()) for a, b in zip(leaves, before))
    err = max(float((a - b).abs().max())
              for a, b in zip(leaves, sides["chain"][0])) / upd
    assert err == 0, f"optimizer kernel against the chain: {err:.3e}"
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(chain, reps)
    lib = [torch.nn.Parameter(p.detach().clone()) for p in leaves]
    for x, gg in zip(lib, g):
        # the fused Adam takes gradients laid out as their parameters
        x.grad = torch.empty_like(x).copy_(gg)
    adam = torch.optim.Adam(lib, lr=1e-3, amsgrad=True, fused=True)
    library_ms = cuda_ms(adam.step, reps)
    print(f"optimizer kernel: {ms:.3f} ms a step, foreach chain "
          f"{plain_ms:.3f} ms, torch.optim.Adam(fused, amsgrad) "
          f"{library_ms:.3f} ms; {n} parameters; its norm {ref_norm:.6f} "
          f"within {norm_err:.2e} of the chain's, the step bit for bit "
          f"the chain's given its norm", flush=True)
    return {"opt": dict(dims={"n": n, "mu_bytes": 4},
                        max_abs_err=max(err, norm_err), ms=ms,
                        plain_ms=plain_ms, library_ms=library_ms)}


def plain_dev_loss(params, state, mcfg, X, y, n_real):
    """``seq2seq.forward_loss(train=False)`` through the plain versions:
    (loss, the decoder call's arguments -- every step teacher-forced, no
    dropout --, the plain decoder's ht and streams)."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl

    x0, wxr, wh, b = seq2seq.encoder_inputs(params, state, mcfg, X)
    enc, h0, c0 = seq2seq.encoder_outputs(
        *fl.stacked_lstm_reference(x0, wxr, wh, b)[:3])
    w = seq2seq.pack_decoder_weights(params)
    y_in = y.t()[:-1].to(torch.int32).contiguous()
    coins = torch.ones(y_in.shape[0], dtype=torch.int32, device=X.device)
    args = (enc, h0, c0, w, y_in, coins, 0, 0.0, 0.0)
    ht, res = fd.decoder_forward_reference(*args)
    dec = params["dec"]
    loss = seq2seq.sequence_loss(ht, dec["out_w"], dec["out_b"], y.t()[1:],
                                 n_real)
    return loss, args, ht, res


def check_dev_loss(params, state, mcfg, X, y, n_real):
    """Phase 5, the dev loss's settings: K3 with every step teacher-forced
    and both dropout rates 0 (its "threshold 0 = none" branch) against its
    plain version, and ``forward_loss(train=False)`` through K1 eval and
    K3 against the same loss through the plain versions."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd

    with torch.no_grad():
        loss_p, args, ht_p, res_p = plain_dev_loss(params, state, mcfg, X, y,
                                                   n_real)
        y_in = args[4]
        ht_k, res_k = fd.decoder_forward(*args)
        err = float((ht_k - ht_p).abs().max())
        for k in fd.RES_NAMES[1:]:
            err = max(err, float((res_k[k] - res_p[k]).abs().max()))
        ids_ok = torch.equal(res_k["sel"], y_in)
        undropped = torch.equal(res_k["x_drop"], res_k["h_all"])
        loss_p = loss_p.item()
        loss_k = seq2seq.forward_loss(params, state, mcfg, X, y, n_real,
                                      train=False)[0].item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"K3 with every coin 1 and rates 0: ht and residuals max abs err "
          f"{err:.3e} (tol {ENC_TOL}), fed ids "
          f"{'equal' if ids_ok else 'DIFFER from'} the teacher's, the "
          f"undropped stream {'equals' if undropped else 'DIFFERS from'} "
          f"h; forward_loss(train=False) {loss_k:.6f} through the kernels, "
          f"{loss_p:.6f} through the plain versions ({rel:.3e} apart, tol "
          f"{EVAL_TOL})", flush=True)
    assert err <= ENC_TOL and ids_ok and undropped, \
        "K3 disagrees at the dev loss's settings"
    assert np.isfinite(loss_k) and rel <= EVAL_TOL, \
        "forward_loss(train=False) disagrees"
    return dict(max_abs_err=err, rel_err=rel)


def check_train_partial(params, state, mcfg, nb, t_enc, device,
                        coins=TRAIN_PARTIAL_COINS):
    """K3 and K4 against their plain versions on a partial batch of
    ``nb`` rows of T' = ``t_enc`` (encoded from seeded features), random
    teacher ids, ``coins`` (one a step) and a random cotangent: K3 along its
    own selected ids as in phase 5 (sampled ids within TOK_TOL of the
    plain step's best logit, streams within ENC_TOL), K4's streams within
    BWD_TOL of max|plain|, and both bit-equal over REPEATS more calls.
    Returns (K3 max abs err, K4 max abs err)."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd

    rng = np.random.default_rng(100 + nb)
    X = torch.from_numpy(rng.standard_normal(
        (nb, 4 * t_enc, 13)).astype(np.float32)).to(device)
    enc, h0, c0 = seq2seq.encode(params, state, mcfg, X)
    assert enc.shape[1] == t_enc, (enc.shape, t_enc)
    w = seq2seq.pack_decoder_weights(params)
    U = len(coins)
    y_in = torch.from_numpy(rng.integers(
        4, VOCAB, (U, nb)).astype(np.int32)).to(device)
    coins = torch.tensor(coins, dtype=torch.int32, device=device)
    args = (enc, h0, c0, w, y_in, coins, DEC_SEED + nb, DROP, DROP)
    ht_k, res_k = fd.decoder_forward(*args)
    sel = res_k["sel"]
    ht_p, res_p = fd.decoder_forward_reference(*args, forced_ids=sel)
    short = float(fd.sampled_shortfall(ht_p, w, sel, coins).max())
    forced = coins.bool()
    assert (sel[forced] == y_in[forced]).all(), "K3 teacher ids differ"
    err3 = max([float((ht_k - ht_p).abs().max())]
               + [float((res_k[k] - res_p[k]).abs().max())
                  for k in fd.RES_NAMES[1:]])
    assert short <= TOK_TOL and err3 <= ENC_TOL, (
        f"K3 disagrees at {nb} rows, T' {t_enc}: sampled shortfall {short}, "
        f"streams {err3}")
    d_ht = torch.from_numpy(rng.standard_normal(
        tuple(ht_k.shape)).astype(np.float32) * 0.1).to(device)
    bwd = (res_k, ht_k, enc, c0, w, d_ht, DEC_SEED + nb, DROP, DROP)
    g_k = fd.decoder_backward(*bwd)
    g_p = fd.decoder_backward_reference(*bwd)
    errs = {k: rel_err(g_k[k], g_p[k]) for k in fd.GRAD_NAMES}
    worst = max(errs, key=lambda k: errs[k][0])
    assert errs[worst][0] <= BWD_TOL, (
        f"K4 disagrees at {nb} rows, T' {t_enc}: {worst} at "
        f"{errs[worst][0]} of max|plain|")
    check_repeats(lambda: fd.decoder_forward(*args), (ht_k, res_k),
                  f"K3 at {nb} rows")
    check_repeats(lambda: fd.decoder_backward(*bwd), g_k, f"K4 at {nb} rows")
    cl = train_clusters(nb, t_enc, w)
    print(f"K3 / K4 partial batch of {nb} rows, T' {t_enc}, {U} steps "
          f"({int((~forced).sum())} sampled): K3 sampled ids within "
          f"{short:.3e} of the plain step's best logit, streams max abs err "
          f"{err3:.3e}; K4 worst stream {worst} at {errs[worst][0]:.3e} of "
          f"max|plain|; clusters {cl}", flush=True)
    return err3, max(e[1] for e in errs.values())


def train_clusters(nb, t_enc, w):
    """The thread-block cluster size each launch of a K3 / K4 step took at
    ``nb`` rows and T' = ``t_enc`` with the decoder weights ``w`` (a
    KeyError if one never ran), from the choices the kernel library
    recorded."""
    from ast_tpu_torch.kernels import build

    (V, E), H, A = w["embed"].shape, w["wh"].shape[1], w["ctx_w"].shape[1]
    rows = next(r for r in (16, 32, 64, 128, 160, 256) if nb <= r)

    def blocks(n):
        return -(-n // 64)

    got = {(c["kind"], c["rows"], c["clusters"], c["tiles"]): c["cluster"]
           for c in build.cluster_choices()}
    want = {
        "K3 cell 0": ("train cell product", rows, H // 16,
                      (E + A + H) // 32),
        "cells 1+": ("train cell product", rows, H // 16, 2 * H // 32),
        "q": ("linear product", rows, blocks(H), H // 32),
        "attention": ("train attention", 0, nb, t_enc),
        "ctx": ("linear product", rows, blocks(A), 2 * H // 32),
        "logits": ("linear product", rows, blocks(V), A // 32),
        "K4 d_cv": ("linear product", rows, blocks(H), A // 32),
        "attention bwd": ("attention backward", 0, nb, t_enc),
        "d_top": ("backward product", rows, blocks(H), (H + A) // 32),
        "layer 0": ("backward product", rows, blocks(H + E + A),
                    4 * H // 32),
        "layers 1+": ("backward product", rows, blocks(2 * H), 4 * H // 32),
    }
    return {name: got[key] for name, key in want.items()}


def make_train_experiment(root, seed=5):
    """Synthetic es_en_20h training experiment: es_en_20h's model_cfg and
    train_cfg with paths rewritten, the 1098-entry BPE vocab, N_TRAIN /
    N_DEV .npy utterances of 100-1,200 frames with Zipf-like targets of
    5-40 tokens, map / info pickles and four dev references."""
    exp = os.path.join(root, "train_exp")
    data = os.path.join(root, "train_data")
    speech = os.path.join(root, "train_speech")
    refs = os.path.join(data, "refs")
    os.makedirs(exp)
    es_en = os.path.join(REPO, "experiments", "es_en_20h")
    shutil.copy(os.path.join(es_en, "model_cfg.json"), exp)
    with open(os.path.join(es_en, "train_cfg.json")) as f:
        train_cfg = json.load(f)
    os.makedirs(refs)
    words = write_vocab(os.path.join(data, "fisher.vocab"))
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, len(words) + 1)
    zipf /= zipf.sum()
    sets = {train_cfg["train_set"]: N_TRAIN, train_cfg["dev_set"]: N_DEV}
    map_dict, info = {}, {}
    for set_key, n in sets.items():
        map_dict[set_key], info[set_key] = {}, {}
        os.makedirs(os.path.join(speech, set_key))
        for i in range(n):
            utt = f"{set_key}_utt{i:03d}"
            T = int(rng.integers(100, 1200))
            np.save(os.path.join(speech, set_key, f"{utt}.npy"),
                    rng.standard_normal((T, 13)).astype(np.float32))
            toks = [words[j] for j in rng.choice(
                len(words), int(rng.integers(5, 41)), p=zipf)]
            map_dict[set_key][utt] = {"bpe_w": toks}
            info[set_key][utt] = {"sp": T, "bpe_w": len(toks)}
    for name, obj in (("fisher.map", map_dict), ("fisher.info", info)):
        with open(os.path.join(data, name), "wb") as f:
            pickle.dump(obj, f)
    dev = train_cfg["dev_set"]
    dev_refs = os.path.join(refs, dev)
    os.makedirs(dev_refs)
    utts = sorted(map_dict[dev])
    with open(os.path.join(dev_refs, "eval.ids"), "w") as f:
        f.write("\n".join(utts) + "\n")
    for k in range(train_cfg["data"]["n_evals"]):
        with open(os.path.join(dev_refs, f"ref.en{k}"), "w") as f:
            for u in utts:
                text = " ".join(w.decode() for w in map_dict[dev][u]["bpe_w"])
                f.write(text.replace("@@ ", "") + "\n")
    train_cfg["data"].update(
        speech_path=speech, map_path=os.path.join(data, "fisher.map"),
        vocab_path=os.path.join(data, "fisher.vocab"),
        info_path=os.path.join(data, "fisher.info"), refs_path=refs)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)
    dev_paths = [os.path.join(speech, dev, f"{u}.npy") for u in utts]
    return exp, dev_paths


def run_train_slice(root, smi, device="cuda"):
    """Phase 6: two epochs through ast_tpu_torch.cli.train, with launch
    counts (the optimizer kernel's among them), then the checkpoint
    through cli.infer and one step's time."""
    import torch

    from ast_tpu_torch.cli import infer, train
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_infer, fused_lstm as fl
    from ast_tpu_torch.ops.fused_optimizer import AmsgradKernel
    from ast_tpu_torch.train.trainer import NN

    exp, dev_paths = make_train_experiment(root)
    counters = {"k1t": fl.fused_stacked_lstm_train, "k2": fl.encoder_backward,
                "k3": fd.decoder_forward, "k4": fd.decoder_backward,
                "k5": fused_infer.greedy_decode_fused, "opt": AmsgradKernel}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with counting(NN, "train_step") as steps:
        _, report = quiet(train.main, ["-m", exp, "-e", "2", "--device",
                                       device])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    rates = [float(v) for v in re.findall(
        r"train throughput = ([0-9.]+) utts/sec", report)]
    with open(os.path.join(exp, "train.log")) as f:
        losses = [float(line.split(", ")[1]) for line in f]
    with open(os.path.join(exp, "dev.log")) as f:
        bleus = [line.strip() for line in f]
    print(f"train slice ({N_TRAIN} train / {N_DEV} dev utts, 2 epochs, "
          f"{wall:.1f} s through the CLI): train.log losses {losses}, "
          f"dev.log {bleus}; train {rates} utts/s ({smi}); launches "
          f"{launches}", flush=True)
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert losses[1] < losses[0], f"the loss did not fall: {losses}"
    assert len(bleus) == 2 and len(rates) == 2
    for k, n in launches.items():
        assert n > 0, f"the training path never launched {k}"
    files = dev_paths[:8]
    hyps, _ = quiet(infer.main, ["-m", exp, "--device", device, "-o",
                                 os.path.join(root, "train_hyps.txt")]
                    + files)
    assert len(hyps) == len(files)
    print(f"  seq2seq_2.model.npz decodes through the infer CLI: "
          f"{sum(len(h.split()) for h in hyps.values())} words for "
          f"{len(files)} files", flush=True)

    # one step at phase 5's shapes, split by CUDA events recorded around
    # each kernel wrapper and the optimizer inside a real train_step
    nn = NN(exp, device)
    X, y = train_batch(torch.device(device))
    batch = {"X": X.cpu().numpy(), "y": y.cpu().numpy(), "n_real": B,
             "utts": [""] * B}
    split = step_split(nn, batch, 3)
    fwd, bwd = split["k1t"] + split["k3"], split["k2"] + split["k4"]
    rest = split["step"] - fwd - bwd - split["opt"]
    print(f"one step (B={B}, {FRAMES} frames, U={U_TRAIN}; {smi}): "
          f"{split['step']:.2f} ms = forward kernels {fwd:.2f} (K1 train "
          f"{split['k1t']:.2f}, K3 {split['k3']:.2f}) + backward kernels "
          f"{bwd:.2f} (K4 {split['k4']:.2f}, K2 {split['k2']:.2f}) + "
          f"optimizer {split['opt']:.2f} + GEMMs, loss, conv and the rest "
          f"{rest:.2f}", flush=True)
    if device == "cuda":
        wall, busy, groups = step_profile(nn, batch, 2)
        print(f"  under torch.profiler: {wall:.2f} ms a step, device busy "
              f"{busy:.2f} ms (idle share {1 - busy / wall:.3f}); busy by "
              f"kernel: " + ", ".join(f"{k} {v:.2f}" for k, v in groups),
              flush=True)
    return launches, dict(utts_per_s=rates, split=split, losses=losses,
                          steps=steps[0], exp=exp)


def edit_train_cfg(exp, fn):
    """Rewrite ``exp``'s train_cfg.json through ``fn(cfg)``."""
    path = os.path.join(exp, "train_cfg.json")
    with open(path) as f:
        cfg = json.load(f)
    fn(cfg)
    with open(path, "w") as f:
        json.dump(cfg, f)


def all_counters():
    """Every kernel wrapper by its key in the ``kernels`` line."""
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_infer, fused_lstm as fl

    return {"k1": fl.fused_stacked_lstm, "k1t": fl.fused_stacked_lstm_train,
            "k2": fl.encoder_backward, "k3": fd.decoder_forward,
            "k4": fd.decoder_backward,
            "k5": fused_infer.greedy_decode_fused,
            "k6": fused_infer.beam_search_streams}


def zero_counts():
    for fn in all_counters().values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in all_counters().items()}


def run_beam_cli(exp, smi):
    """Phase 7: ast_tpu_torch.cli.beam over phase 6's dev split, with
    --resume and --ckpt."""
    import torch

    from ast_tpu_torch import SYMBOLS, Config
    from ast_tpu_torch.cli import beam
    from ast_tpu_torch.train.trainer import NN

    tcfg = Config(exp).train
    dev = tcfg["dev_set"]
    args = ["-m", exp, "-n", str(N_BEAM), "-k", str(K_BEAM), "-w", "0.6",
            "-s", dev, "--device", "cuda"]
    stem = os.path.join(exp, f"{dev}_beam_N-{N_BEAM}_K-{K_BEAM}")

    def read(tag=""):
        with open(f"{stem}{tag}.p", "rb") as f:
            beams = pickle.load(f)
        with open(f"{stem}_W-0.60{tag}.en", "rb") as f:
            return beams, f.read()

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bleu, out = quiet(beam.main, args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = counts()
    assert n["k1"] > 0 and n["k6"] > 0, f"cli.beam never launched K1 / K6: {n}"
    assert re.search(r"^BLEU = [0-9.]+$", out, re.M), out
    beams, text = read()
    with open(os.path.join(tcfg["data"]["refs_path"], dev, "ref.en0")) as f:
        n_refs = len(f.read().splitlines())
    assert len(beams) == N_DEV == n_refs == len(text.splitlines())
    for utt, hyps in beams.items():
        assert len(hyps) == N_BEAM, utt
        for ids, score in hyps:
            assert ids[0] == SYMBOLS.GO_ID and np.isfinite(score), utt
            assert type(ids) is list and type(score) is float
    t0 = time.perf_counter()
    NN(exp, "cuda")
    torch.cuda.synchronize()
    dt_nn = time.perf_counter() - t0
    print(f"beam CLI ({N_DEV} dev utts in {n['k6']} batches, N {N_BEAM}, K "
          f"{K_BEAM}, {smi}): {N_DEV / dt:.1f} utts/s over the whole call of "
          f"{dt:.2f} s (config, checkpoint, data loader and BLEU included; "
          f"building NN alone takes {dt_nn:.2f} s), BLEU {bleu:.2f}; "
          f"launches K1 eval {n['k1']}, K6 {n['k6']}", flush=True)

    zero_counts()
    bleu2, out = quiet(beam.main, args + ["--resume"])
    n2 = counts()
    assert "Loading saved beam results" in out
    assert n2["k6"] == 0 and n2["k1"] == 0, f"--resume decoded again: {n2}"
    assert bleu2 == bleu and read()[1] == text, "--resume changed the result"

    ckpt = os.path.join(exp, "seq2seq_2.model.npz")     # phase 6's
    bleu3, _ = quiet(beam.main, args + ["--ckpt", ckpt])
    beams3, text3 = read("_ckpt-seq2seq_2.model")
    assert text3 == text and bleu3 == bleu and list(beams3) == list(beams)
    print(f"  --resume: K6 launched 0 times, the same BLEU and .en bytes; "
          f"--ckpt seq2seq_2.model.npz: the _ckpt- files with equal text "
          f"(--save-attn: phase 12)", flush=True)
    return dict(utts_per_s=N_DEV / dt, launches=n)


def run_trainer_machinery(exp, smi):
    """Phase 8: eval_loss, a preempted epoch and its resume, epochs under
    the loss / optimizer / augmentation options, the decode pipeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ast_tpu_torch.checkpoint import load_checkpoint
    from ast_tpu_torch.train.optimizer import tree_leaves
    from ast_tpu_torch.train.trainer import NN, PreemptedError

    nn = NN(exp, "cuda")
    tcfg = nn.cfg.train
    train_set, dev = tcfg["train_set"], tcfg["dev_set"]
    assert nn.max_epoch == 2

    # eval_loss through the kernels, and through the plain versions over
    # the same batches (a fresh loader's first pass is in the same order)
    zero_counts()
    loss_k = nn.eval_loss(dev)
    n = counts()
    assert n["k1"] > 0 and n["k3"] > 0 and n["k1"] == n["k3"], n
    plain, sizes = [], []
    with torch.no_grad():
        for batch in NN(exp, "cuda").data_loader.get_batch(
                tcfg["batch_size"], dev, train=False, labels=True,
                tail_shrink=nn.tail_shrink):
            X = torch.from_numpy(batch["X"]).cuda()
            y = torch.from_numpy(batch["y"]).cuda().long()
            plain.append(plain_dev_loss(nn.params, nn.state, nn.mcfg, X, y,
                                        float(batch["n_real"]))[0].item())
            sizes.append(max(1, len(batch["utts"])))
    loss_p = sum(v / s for v, s in zip(plain, sizes)) / len(plain)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"eval_loss({dev}): {loss_k:.6f} through K1 eval and K3 "
          f"({n['k3']} batches), {loss_p:.6f} through the plain versions "
          f"({rel:.3e} apart, tol {EVAL_TOL})", flush=True)
    assert np.isfinite(loss_k) and rel <= EVAL_TOL, "eval_loss disagrees"

    # the decode pipeline: the dev split at depth 1, 2, 2, 1
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    nn.predict(dev)
    rates = {"greedy": {1: [], 2: []}, "beam": {1: [], 2: []}}
    for depth in (1, 2, 2, 1):
        tcfg["extras"]["decode_pipeline"] = depth
        rates["greedy"][depth].append(N_DEV / timed(
            lambda: nn.predict(dev))[1])
        rates["beam"][depth].append(N_DEV / timed(
            lambda: nn.decode_beam_set(dev, N_BEAM, K_BEAM))[1])
    idle = {}
    for depth in (1, 2):
        tcfg["extras"]["decode_pipeline"] = depth
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed(lambda: nn.predict(dev))[1] * 1e3
        idle[depth] = 1 - device_busy(prof)[0] / wall
    tcfg["extras"]["decode_pipeline"] = None

    def fmt(v):
        return "/".join(f"{x:.1f}" for x in v)

    print(f"decode pipeline over the {N_DEV} dev utts, utts/s at depth 1 | "
          f"2, two passes each ({smi}): predict {fmt(rates['greedy'][1])} "
          f"| {fmt(rates['greedy'][2])}, decode_beam_set "
          f"{fmt(rates['beam'][1])} | {fmt(rates['beam'][2])}; device idle "
          f"share of predict under torch.profiler {idle[1]:.3f} | "
          f"{idle[2]:.3f}", flush=True)

    # a preempted epoch and its resume
    edit_train_cfg(exp, lambda c: c.update(checkpoint_steps=4))
    nn = NN(exp, "cuda")
    epoch, stop_after = nn.max_epoch + 1, 5
    n_total = sum(1 for _ in nn.data_loader.get_batch(
        tcfg["batch_size"], train_set, train=True, labels=True, epoch=epoch,
        tail_shrink=nn.tail_shrink))
    assert n_total > stop_after + 1, n_total
    step = nn.train_step
    seen = []

    def stop_soon(batch, seed):
        seen.append(seed)
        if len(seen) == stop_after:
            nn.request_preempt()
        return step(batch, seed)

    nn.train_step = stop_soon
    try:
        nn.train_epoch(train_set, epoch=epoch)
    except PreemptedError as e:
        print(f"preemption: {e}", flush=True)
    else:
        raise AssertionError("request_preempt() did not stop the epoch")
    extra = load_checkpoint(os.path.join(exp, "seq2seq_inflight.npz"))["extra"]
    assert (int(extra["epoch"]), int(extra["step"]), int(extra["g"])) == (
        epoch, stop_after, 1), extra
    nn = NN(exp, "cuda")
    assert nn.inflight_resume == (epoch, stop_after) and nn.max_epoch == 2
    zero_counts()
    with counting(NN, "train_step") as steps:
        loss = nn.train_epoch(train_set, epoch=epoch)
    n = counts()
    assert steps[0] == n_total - stop_after, (steps[0], n_total)
    assert all(n[k] == steps[0] for k in ("k1t", "k2", "k3", "k4")), n
    nn.save(epoch)
    nn = NN(exp, "cuda")
    assert nn.max_epoch == epoch and nn.inflight_resume is None
    print(f"  a fresh NN resumed epoch {epoch} at batch {stop_after} of "
          f"{n_total}, trained the other {steps[0]} (loss {loss:.4f}), and "
          f"seq2seq_{epoch}.model.npz loads", flush=True)
    assert np.isfinite(loss)

    # the options that live outside the kernels, all at once
    def options(c):
        c["checkpoint_steps"] = 0
        c["extras"].update(label_smoothing=0.1, random_out=0.1)
        c["data"]["spec_augment"] = {"freq_masks": 2, "freq_width": 3,
                                     "time_masks": 2, "time_width": 40}
        c["optimizer"].update(grad_noise_eta=0.01, moments_dtype="bfloat16")

    edit_train_cfg(exp, options)
    os.remove(os.path.join(exp, "seq2seq_inflight.npz"))
    nn, notes = quiet(lambda _: NN(exp, "cuda"), None)
    assert "optimizer state not restored" in notes   # another chain's state
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [nn.train_epoch(train_set, epoch=epoch + 1 + i) for i in (0, 1)]
    dt = time.perf_counter() - t0
    n = counts()
    assert all(n[k] > 0 for k in ("k1t", "k2", "k3", "k4")), n
    assert all(np.isfinite(losses)) and losses[1] <= 1.02 * losses[0], losses
    nn.save(epoch + 2)
    mu = tree_leaves(nn.opt_state[3][1])
    assert mu and all(t.dtype == torch.bfloat16 for t in mu)
    saved = load_checkpoint(os.path.join(
        exp, f"seq2seq_{epoch + 2}.model.npz"))["opt"]
    for a, t in zip(tree_leaves(saved[3][1]), mu):
        a = torch.from_numpy(a)
        # NPZ holds bfloat16 values as float32, as ast_tpu's checkpoints
        assert torch.equal(a.bfloat16().float(), a)
        assert torch.equal(a.bfloat16(), t.cpu())
    back, notes = quiet(lambda _: NN(exp, "cuda"), None)
    assert "optimizer state not restored" not in notes
    assert all(t.dtype == torch.bfloat16
               for t in tree_leaves(back.opt_state[3][1]))
    assert int(back.opt_state[2]["count"]) == int(back.opt_state[3][0]) > 0
    print(f"  two epochs under label_smoothing 0.1, random_out 0.1, "
          f"spec_augment, grad_noise_eta 0.01 and moments_dtype bfloat16: "
          f"losses {[round(v, 4) for v in losses]}, "
          f"{2 * N_TRAIN / dt:.1f} utts/s ({smi}); launches {n}; the saved "
          f"mu leaves are bfloat16 values and load as bfloat16", flush=True)
    return dict(eval_loss=loss_k, eval_rel_err=rel, pipeline=rates,
                idle=idle)


# the decode kernels' keys in the server's /stats kernel_launches
KERNEL_KEYS = ("k1", "k5", "k6")


def http_post(url, body, timeout=120):
    """POST a JSON body, or one .npy blob for an ndarray; (status, reply)."""
    import urllib.error
    import urllib.request

    if isinstance(body, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, body)
        data, ctype = buf.getvalue(), "application/octet-stream"
    else:
        data, ctype = json.dumps(body).encode(), "application/json"
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_get(url, timeout=30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def start_server(serving_dir, log_path, window_ms=5, ready_s=600,
                 device="cuda"):
    """ast_tpu_torch.cli.serve as a subprocess on a free port, --warmup:
    (process, base url, seconds until /healthz said ready)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    log = open(log_path, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ast_tpu_torch.cli.serve", "-d", serving_dir,
         "--port", str(port), "--warmup", "--batch-window-ms",
         str(window_ms), "--device", device], cwd=REPO, stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    base = f"http://127.0.0.1:{port}"
    while True:
        try:
            health = http_get(base + "/healthz", timeout=5)
            assert health["ok"], health
            if health["ready"]:
                return proc, base, time.perf_counter() - t0
        except OSError:
            pass
        if proc.poll() is not None or time.perf_counter() - t0 > ready_s:
            if proc.poll() is None:         # leave no server behind
                proc.kill()
                proc.wait(timeout=60)
            with open(log_path) as f:
                raise AssertionError(f"server not ready (exit "
                                     f"{proc.poll()}): {f.read()[-3000:]}")
        time.sleep(0.2)


def stop_server(proc, timeout=120):
    """SIGTERM, wait for the drain; the exit code."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=timeout)


def client_run(base, bodies, clients):
    """POST every (path, body) of ``bodies`` to /decode from ``clients``
    threads, each taking every clients-th; (replies in order, seconds,
    each request's latency)."""
    import threading

    out, lat = [None] * len(bodies), [0.0] * len(bodies)

    def client(c):
        for i in range(c, len(bodies), clients):
            t = time.perf_counter()
            out[i] = http_post(base + bodies[i][0], bodies[i][1])
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a client hung"
    dt = time.perf_counter() - t0
    bad = [r for r in out if r[0] != 200]
    assert not bad, f"{len(bad)} requests failed: {bad[:2]}"
    return [r[1] for r in out], dt, lat


def run_serving(exp, paths, root, smi, tf32_default):
    """Phase 9: export es_en_20h (f32 and int8), serve it over HTTP from a
    subprocess, and hold the replies to in-process decodes."""
    import threading

    import torch

    from ast_tpu_torch import Config, SYMBOLS
    from ast_tpu_torch.checkpoint import load_checkpoint
    from ast_tpu_torch.cli import export_model
    from ast_tpu_torch.detok import dec_i2w, ids_to_text
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import beam as beam_ops
    from ast_tpu_torch.ops.fbank import (
        MfccExtractor, apply_cmvn, compute_cmvn_stats, num_frames)
    from ast_tpu_torch.params import from_jax_numpy

    assert tf32_default is False, (
        "torch.backends.cuda.matmul.allow_tf32 defaults to True here: the "
        "server's fbank and conv products would not be float32")
    dirs = {"f32": os.path.join(root, "serving"),
            "q8": os.path.join(root, "serving_q8")}
    quiet(export_model.main, ["-m", exp, "-o", dirs["f32"], "--batch",
                              str(B), "--beam", f"{N_BEAM},{K_BEAM}"])
    quiet(export_model.main, ["-m", exp, "-o", dirs["q8"], "--batch",
                              str(B), "--quantize", "int8"])
    with open(os.path.join(dirs["f32"], "manifest.json")) as f:
        entries = json.load(f)["entries"]
    ladder = sorted({e["frames"] for e in entries})
    assert ladder == [400, 800, 1200, 1680] and len(entries) == 8, entries

    cfg = Config(exp)
    mcfg, dec_key = cfg.model, cfg.train["data"]["dec_key"]
    i2w = dec_i2w(cfg.train)
    device = torch.device("cuda")
    snap = load_checkpoint(os.path.join(exp, "seq2seq_1.model.npz"))
    params, state = from_jax_numpy(snap["params"], snap["state"], device)
    beam = beam_ops.make_beam_decoder(mcfg, N_BEAM, K_BEAM, STOP)

    def text(ids):
        return ids_to_text(ids, lambda i: i2w[i].decode(), dec_key)

    def padded(xs, T):
        """``xs`` as the first rows of a B-row call, zero rows after
        them: the server runs every call at its entry's static batch."""
        X = np.zeros((max(B, len(xs)), T, 13), np.float32)
        for j, x in enumerate(xs):
            X[j, :min(T, len(x))] = x[:T]
        return torch.from_numpy(X).to(device)

    def entry_T(x):
        return next((T for T in ladder if T >= len(x)), ladder[-1])

    def cut(row):
        eos = np.nonzero(row == SYMBOLS.EOS_ID)[0]
        return (row[:eos[0]] if eos.size else row).tolist()

    def strip(h):
        h = [int(i) for i in h]
        if h and h[0] == SYMBOLS.GO_ID:
            h = h[1:]
        if h and h[-1] == SYMBOLS.EOS_ID:
            h = h[:-1]
        return h

    zero_counts()
    with torch.inference_mode():
        w = seq2seq.decode_weights(params)

        def greedy_ids(xs, T):
            preds = seq2seq.predict_greedy(params, state, mcfg, padded(xs, T),
                                           STOP, w)[0].cpu().numpy()
            return [cut(p) for p in preds]

        def beam_best(x):
            """The reranked winner (ids, score) of x, row 0 of a K1 + K6
            call at the entry's batch."""
            hyps, scores, lengths = (a.cpu().numpy() for a in beam(
                params, state, padded([x], entry_T(x)), w))
            best = beam_ops.rerank_hypothesis(
                [(hyps[0, n, :lengths[0, n]].tolist(), float(scores[0, n]))
                 for n in range(N_BEAM)], 0.6)[0]
            return strip(best[0]), float(best[1])

        feats = [np.load(p) for p in paths]
        want_g = [greedy_ids([x], entry_T(x))[0] for x in feats]
        want_b = [beam_best(x) for x in feats]
    ref_counts = counts()

    proc, base, warm_s = start_server(dirs["f32"],
                                      os.path.join(root, "serve.log"))
    report, stats = {}, [http_get(base + "/stats")]
    try:
        health = http_get(base + "/healthz")
        print(f"serving: {len(entries)} entries ({ladder} frames, greedy "
              f"and beam {N_BEAM},{K_BEAM}, batch {B}); server ready after "
              f"{warm_s:.1f} s, its warm-up {health['warmup']['seconds']:.1f}"
              f" s ({smi})", flush=True)
        runs = {}
        for mode, q in (("greedy", "?mode=greedy"),
                        ("beam", "?mode=beam&w=0.6")):
            bodies = [("/decode" + q, x) for x in feats]
            for clients in (1, 8):
                runs[mode, clients] = client_run(base, bodies, clients)
                stats.append(http_get(base + "/stats"))
        # sequential replies: bit-equal to the in-process kernel decode of
        # the same row padded to the chosen entry's frames
        for i, (g, (b_ids, b_score)) in enumerate(zip(want_g, want_b)):
            rg, rb = runs["greedy", 1][0][i], runs["beam", 1][0][i]
            assert rg["ids"] == g and rg["text"] == text(g), (i, rg, g)
            assert rg["artifact"].startswith(f"greedy_B{B}_T{entry_T(feats[i])}")
            assert rb["ids"] == b_ids and rb["text"] == text(b_ids), (i, rb)
            assert rb["score"] == b_score, (i, rb["score"], b_score)
        # the server's own launches: every run went through K1 and its
        # mode's decode kernel, at most once each a device call
        for k, (mode, clients) in enumerate(runs):
            before, after = stats[k], stats[k + 1]
            launched = {n: after["kernel_launches"][n]
                        - before["kernel_launches"][n] for n in KERNEL_KEYS}
            calls = after["device_calls"] - before["device_calls"]
            used, unused = ("k5", "k6") if mode == "greedy" else ("k6", "k5")
            assert 0 < launched["k1"] <= calls and \
                0 < launched[used] <= calls and launched[unused] == 0, (
                    mode, launched, calls)
            runs[mode, clients] += (launched,)
        # concurrent replies: bit-equal to the sequential ones -- every
        # call runs at the entry's batch, so a row's sums do not depend
        # on its batch mates or its place among them
        for mode in ("greedy", "beam"):
            parted = [i for i, (a, b) in enumerate(zip(
                runs[mode, 1][0], runs[mode, 8][0])) if a != b]
            assert not parted, (
                f"{mode}: {len(parted)} rows differ under 8 clients from "
                f"the sequential replies, first {parted[0]}: "
                f"{runs[mode, 1][0][parted[0]]} vs "
                f"{runs[mode, 8][0][parted[0]]}")

        # audio: 1-12 s of seeded 8 kHz audio, fbank on the card
        rng = np.random.default_rng(9)
        audio = [(rng.standard_normal(int(n)) * 0.1).astype(np.float32)
                 for n in rng.integers(8000, 96000, 8)]
        card, host = MfccExtractor(device=device), MfccExtractor()
        fb_err, cmvn = 0.0, []
        with torch.inference_mode():
            for a in audio:
                got = card(a).cpu().numpy()
                fb_err = max(fb_err, float(np.abs(got - host(a).numpy()).max()))
                cmvn.append(np.asarray(apply_cmvn(
                    got, compute_cmvn_stats([got])), np.float32))
            assert fb_err <= 1e-3, f"card fbank {fb_err} from the CPU's"
            single = [http_post(base + "/decode?mode=greedy", a)
                      for a in audio[:4]]
            status, bulk = http_post(base + "/decode_batch", {
                "batch": [{"audio": a.tolist()} for a in audio[4:]],
                "mode": "greedy"})
            assert status == 200, bulk
            for (status, r), a, f in zip(single, audio, cmvn):
                assert status == 200, r
                assert r["frames"] == num_frames(card.cfg, len(a)) == len(f)
                assert r["ids"] == greedy_ids([f], entry_T(f))[0], r
            # /decode_batch: rows grouped by entry, in input order
            groups = {}
            for j, f in enumerate(cmvn[4:]):
                groups.setdefault(entry_T(f), []).append(j)
            for T, idx in groups.items():
                got_ids = greedy_ids([cmvn[4 + j] for j in idx], T)
                for j, ids in zip(idx, got_ids):
                    assert bulk["results"][j]["ids"] == ids, (j, T)
        stats.append(http_get(base + "/stats"))
        audio_launched = {n: stats[-1]["kernel_launches"][n]
                          - stats[-2]["kernel_launches"][n]
                          for n in KERNEL_KEYS}
        assert audio_launched["k1"] > 0 and audio_launched["k5"] > 0, (
            audio_launched)

        # SIGTERM while a request is in flight (a 4-call beam batch, the
        # signal sent once its first call has ended): 200, then exit 0
        inflight = [None]
        stack = padded(feats + feats, ladder[-1]).cpu().numpy()
        calls0 = http_get(base + "/stats")["device_calls"]

        def long_request():
            inflight[0] = http_post(base + "/decode_batch?mode=beam", stack)
            inflight.append(time.perf_counter())

        t = threading.Thread(target=long_request)
        t.start()
        deadline = time.perf_counter() + 120
        while http_get(base + "/stats")["device_calls"] == calls0:
            assert time.perf_counter() < deadline and t.is_alive()
            time.sleep(0.005)
        t_term = time.perf_counter()
        rc = stop_server(proc)
        t.join(timeout=120)
        assert inflight[0] is not None and inflight[0][0] == 200, inflight
        assert inflight[1] > t_term, "the request ended before SIGTERM"
        assert rc == 0, f"the server exited {rc} after SIGTERM"
    finally:
        stop_server(proc)
    final = stats[-1]
    assert final["errors"] == 0, final

    # the int8 directory: the same 64 greedy requests
    proc, base_q8, warm_q8 = start_server(dirs["q8"],
                                          os.path.join(root, "serve_q8.log"))
    try:
        q8_before = http_get(base_q8 + "/stats")["kernel_launches"]
        q8, q8_dt, _ = client_run(base_q8, [("/decode?mode=greedy", x)
                                            for x in feats], 1)
        q8_stats = http_get(base_q8 + "/stats")
        assert q8_stats["errors"] == 0
        q8_launched = {n: q8_stats["kernel_launches"][n] - q8_before[n]
                       for n in KERNEL_KEYS}
        assert q8_launched["k1"] > 0 and q8_launched["k5"] > 0, q8_launched
        assert stop_server(proc) == 0
    finally:
        stop_server(proc)
    same_q8 = sum(a["text"] == b["text"]
                  for a, b in zip(q8, runs["greedy", 1][0])) / len(feats)

    for k, (mode, clients) in enumerate(runs):
        replies, dt, lat, launched = runs[mode, clients]
        before, after = stats[k], stats[k + 1]
        calls = after["device_calls"] - before["device_calls"]
        occ = (after["rows_decoded"] - before["rows_decoded"]) / (B * calls)
        p50, p90, p99 = np.percentile(lat, [50, 90, 99]) * 1e3
        report[f"{mode}_{clients}"] = dict(
            req_per_s=len(feats) / dt, p50_ms=p50, p90_ms=p90, p99_ms=p99,
            device_calls=calls, batch_occupancy=occ)
        print(f"  {mode}, {clients} client{'s' if clients > 1 else ''}: "
              f"{len(feats) / dt:.1f} requests/s, latency p50 {p50:.1f} / "
              f"p90 {p90:.1f} / p99 {p99:.1f} ms, {calls} device calls, "
              f"batch_occupancy {occ:.4f}, the server's launches "
              f"{launched} ({smi})", flush=True)
    lat = final.get("latency_s", {})
    print(f"  /stats: {final['requests']} requests, {final['errors']} "
          f"errors, {final['device_calls']} device calls, batch_occupancy "
          f"{final['batch_occupancy']}, latency p50 {lat.get('p50')} / p90 "
          f"{lat.get('p90')} / p99 {lat.get('p99')} s; sequential replies "
          f"bit-equal to in-process K1+K5 / K1+K6 at the entry's batch, "
          f"and the 8 clients' replies bit-equal to the sequential ones "
          f"(greedy and beam); card fbank within {fb_err:.2e} of the "
          f"CPU's; SIGTERM "
          f"with a request in flight: 200, exit 0", flush=True)
    print(f"  int8 directory: {len(feats) / q8_dt:.1f} greedy requests/s, "
          f"ready after {warm_q8:.1f} s, {same_q8:.3f} of the texts equal "
          f"to f32's, the server's launches {q8_launched}; audio bodies' "
          f"launches {audio_launched}; the in-process reference decodes' "
          f"{ref_counts}", flush=True)
    return report


def make_asr_experiment(root, seed=7):
    """Phase 10's donor: experiments/asr_gpfr's model_cfg and train_cfg
    (the globalphone loader: every utterance's features in one pickled
    dict) with paths rewritten, its own ASR_VOCAB-entry vocab, N_ASR /
    N_ASR_DEV utterances of 100-1,200 frames with Zipf-like targets of
    5-40 tokens, and an sclite trn reference of the dev split."""
    exp = os.path.join(root, "asr_exp")
    data = os.path.join(root, "asr_data")
    refs = os.path.join(data, "refs")
    os.makedirs(exp)
    gpfr = os.path.join(REPO, "experiments", "asr_gpfr")
    shutil.copy(os.path.join(gpfr, "model_cfg.json"), exp)
    with open(os.path.join(gpfr, "train_cfg.json")) as f:
        train_cfg = json.load(f)
    words = write_vocab(os.path.join(root, "asr.vocab"), ASR_VOCAB, "f")
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, len(words) + 1)
    zipf /= zipf.sum()
    dev = train_cfg["dev_set"]
    sets = {train_cfg["train_set"]: N_ASR, dev: N_ASR_DEV}
    speech, map_dict, info = {}, {}, {}
    for set_key, n in sets.items():
        speech[set_key], map_dict[set_key], info[set_key] = {}, {}, {}
        for i in range(n):
            utt = f"{set_key}_utt{i:03d}"
            T = int(rng.integers(100, 1200))
            speech[set_key][utt] = rng.standard_normal((T, 13)).astype(
                np.float32)
            toks = [words[j] for j in rng.choice(
                len(words), int(rng.integers(5, 41)), p=zipf)]
            map_dict[set_key][utt] = {"bpe_w": toks}
            info[set_key][utt] = {"sp": T, "bpe_w": len(toks)}
    os.makedirs(os.path.join(refs, dev))
    for name, obj in (("data.dict", speech), ("bpe_map.dict", map_dict),
                      ("info.dict", info)):
        with open(os.path.join(data, name), "wb") as f:
            pickle.dump(obj, f)
    utts = sorted(map_dict[dev])
    text = {u: " ".join(w.decode() for w in map_dict[dev][u]["bpe_w"])
            .replace("@@ ", "") for u in utts}
    with open(os.path.join(refs, dev, "eval.ids"), "w") as f:
        f.write("\n".join(utts) + "\n")
    with open(os.path.join(refs, dev, "ref.en0"), "w") as f:
        f.write("".join(text[u] + "\n" for u in utts))
    with open(os.path.join(data, f"{dev}.clean.wer"), "w") as f:
        f.write("".join(f"{text[u]} ({u})\n" for u in utts))
    train_cfg["data"].update(
        speech_path=os.path.join(data, "data.dict"),
        map_path=os.path.join(data, "bpe_map.dict"),
        vocab_path=os.path.join(root, "asr.vocab"),
        info_path=os.path.join(data, "info.dict"), refs_path=refs)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)
    return exp


def cuda_tree(snap, device):
    """A checkpoint's params and BN state as flat {key: tensor on the
    card}."""
    import torch

    from ast_tpu_torch.checkpoint import flatten
    from ast_tpu_torch.params import from_jax_numpy

    params, state = from_jax_numpy(snap["params"], snap.get("state") or {},
                                   device)
    flat = flatten({"params": params, "state": state}, leaf=lambda t: t)
    return {k: v for k, v in flat.items() if torch.is_tensor(v)}


def run_transfer(root, st_src, smi, device="cuda"):
    """Phase 10: the pretrain -> transfer -> fine-tune workflow through
    the CLIs.  ``st_src``: phase 6's experiment, whose data a fresh
    es_en_20h experiment takes."""
    import torch

    from ast_tpu_torch.checkpoint import (
        checkpoint_path, flatten, latest_checkpoint, load_checkpoint)
    from ast_tpu_torch.cli import beam, copy_params, train
    from ast_tpu_torch.eval.bleu import Eval
    from ast_tpu_torch.train.trainer import NN

    dev_ = torch.device(device)

    def sync():
        if dev_.type == "cuda":
            torch.cuda.synchronize()

    def timed(main, argv):
        sync()
        t0 = time.perf_counter()
        res, out = quiet(main, argv + ["--device", device])
        sync()
        return res, out, time.perf_counter() - t0

    def rates(out):
        return [float(v) for v in re.findall(
            r"train throughput = ([0-9.]+) utts/sec", out)]

    t_phase = time.perf_counter()
    zero_counts()
    donor = make_asr_experiment(root)
    _, out, _ = timed(train.main, ["-m", donor, "-e", "2"])
    donor_rates = rates(out)
    donor_ckpt, donor_epoch = latest_checkpoint(donor)
    assert donor_epoch == 2, donor_ckpt

    # the target: es_en_20h's train_cfg over phase 6's data, encoder and
    # conv front-end frozen for the fine-tune
    st = os.path.join(root, "transfer_st")
    os.makedirs(st)
    shutil.copy(os.path.join(st_src, "model_cfg.json"), st)
    with open(os.path.join(REPO, "experiments", "es_en_20h",
                           "train_cfg.json")) as f:
        st_cfg = json.load(f)
    with open(os.path.join(st_src, "train_cfg.json")) as f:
        src_data = json.load(f)["data"]
    st_cfg["data"].update({k: src_data[k] for k in (
        "speech_path", "map_path", "vocab_path", "info_path", "refs_path")})
    st_cfg["optimizer"]["freeze"] = ["cnn", "enc"]
    with open(os.path.join(st, "train_cfg.json"), "w") as f:
        json.dump(st_cfg, f)
    dev = st_cfg["dev_set"]

    _, out, copy_s = timed(copy_params.main, ["--src", donor, "--dst", st,
                                              "--groups", "enc,attn"])
    assert "encoder conv weights match donor: True" in out, out
    donor_t = cuda_tree(load_checkpoint(donor_ckpt), dev_)
    start = load_checkpoint(checkpoint_path(st, 0))
    assert "opt" not in start
    start_t = cuda_tree(start, dev_)
    copied = [k for k in start_t if k.split("/")[1] in ("cnn", "enc", "attn")
              or k.startswith("state/")]
    assert copied and all(torch.equal(start_t[k], donor_t[k])
                          for k in copied), "copied leaves differ"

    _, out, _ = timed(train.main, ["-m", st, "-e", "1"])
    tune_rates = rates(out)
    assert "epoch: 1" in out, out
    tuned_t = cuda_tree(load_checkpoint(checkpoint_path(st, 1)), dev_)
    frozen = [k for k in tuned_t if k.split("/")[:2] in (
        ["params", "cnn"], ["params", "enc"])]
    trained = [k for k in tuned_t
               if k.startswith("params/") and k not in frozen]
    assert frozen and all(torch.equal(tuned_t[k], donor_t[k])
                          for k in frozen), "a frozen leaf moved"
    still = [k for k in trained if torch.equal(tuned_t[k], start_t[k])]
    assert trained and not still, f"leaves that did not move: {still}"
    with open(os.path.join(st, "dev.log")) as f:
        tune_bleu = float(f.read().split(", ")[-1])

    avg, _, avg_s = timed(copy_params.main,
                          ["--src", st, "--average", "last:2"])
    got = flatten(load_checkpoint(avg))
    e0, e1 = (flatten({k: load_checkpoint(checkpoint_path(st, e))[k]
                       for k in ("params", "state")}) for e in (0, 1))
    assert sorted(got) == sorted(e0)
    for k, a in e0.items():
        if a.dtype == np.float32:
            mean = ((a.astype(np.float64) + e1[k]) / 2).astype(np.float32)
            assert np.array_equal(got[k], mean), f"average differs at {k}"
    def beam_args(exp):
        return ["-m", exp, "-n", str(N_BEAM), "-k", str(K_BEAM), "-w",
                "0.6", "-s", dev]
    avg_bleu, _, _ = timed(beam.main, beam_args(st) + ["--ckpt", avg])

    chainer_dir = os.path.join(root, "transfer_chainer")
    os.makedirs(chainer_dir)
    for name in ("model_cfg.json", "train_cfg.json"):
        shutil.copy(os.path.join(st, name), chainer_dir)
    model = os.path.join(chainer_dir, "seq2seq_1.model")
    _, _, export_s = timed(copy_params.main,
                           ["--src", st, "--export-chainer", model])
    assert os.path.exists(model) and not os.path.exists(model + ".npz")
    stem = f"{dev}_beam_N-{N_BEAM}_K-{K_BEAM}"
    decoded = []
    for exp in (st, chainer_dir):
        bleu, _, _ = timed(beam.main, beam_args(exp))
        with open(os.path.join(exp, f"{stem}.p"), "rb") as f, open(
                os.path.join(exp, f"{stem}_W-0.60.en"), "rb") as g:
            decoded.append((bleu, pickle.load(f), g.read()))
    assert decoded[0] == decoded[1], "the Chainer directory decodes otherwise"
    _, out, _ = timed(train.main, ["-m", chainer_dir, "-e", "1"])
    with open(os.path.join(chainer_dir, "train.log")) as f:
        resumed = [line.split(", ")[0] for line in f.read().splitlines()]
    assert "epoch: 2" in out and resumed == ["2"], (out, resumed)

    # the donor's dev greedy hypotheses, scored by the WER CLI
    nn = NN(donor, device)
    tcfg = nn.cfg.train
    refs = os.path.join(tcfg["data"]["refs_path"], tcfg["dev_set"])
    hyp_path = os.path.join(root, "asr_dev_hyps.txt")
    Eval(refs, 1).write_to_file(
        nn.data_loader.get_hyps(nn.predict(tcfg["dev_set"])), hyp_path)
    trn = os.path.join(os.path.dirname(tcfg["data"]["map_path"]),
                       f"{tcfg['dev_set']}.clean.wer")
    res = subprocess.run(
        [sys.executable, "-m", "ast_tpu_torch.eval.wer", trn, hyp_path,
         "--ids", os.path.join(refs, "eval.ids")], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    wer = re.search(r"^%WER ([0-9.]+) \[ \d+ / (\d+),.*\]$", res.stdout,
                    re.M)
    assert wer and int(wer.group(2)) > 0, res.stdout
    n = counts()
    wall = time.perf_counter() - t_phase
    print(f"transfer ({N_ASR} / {N_ASR_DEV} asr_gpfr-shaped donor utts, "
          f"es_en_20h target; {smi}): donor 2 epochs {donor_rates} utts/s, "
          f"copy_params enc,attn {copy_s:.2f} s ({len(copied)} leaves "
          f"bit-equal to the donor's on {dev_}), fine-tune 1 epoch with "
          f"cnn, enc frozen {tune_rates} utts/s ({len(frozen)} frozen leaves "
          f"bit-equal to the donor's, all {len(trained)} others moved), dev "
          f"BLEU {tune_bleu:.2f}; --average last:2 {avg_s:.2f} s, equal to "
          f"the float64 mean, beam {N_BEAM},{K_BEAM} BLEU {avg_bleu:.2f} "
          f"through --ckpt; --export-chainer {export_s:.2f} s, its "
          f"directory's beam hypotheses bit-equal to the .npz's and "
          f"cli.train resumed it at epoch 2; donor dev greedy, python -m "
          f"ast_tpu_torch.eval.wer: {wer.group(0)}; launches {n}; "
          f"{wall:.1f} s", flush=True)
    if dev_.type == "cuda":
        for k, v in n.items():
            assert v > 0, f"the transfer path never launched {k}"
    return dict(donor_utts_per_s=donor_rates, tune_utts_per_s=tune_rates,
                wer=float(wer.group(1)), bleu=tune_bleu, avg_bleu=avg_bleu,
                seconds=wall, launches=n)


# ---------------------------------------------------------------------------
# phase 11: from raw tapes to a trained model
# ---------------------------------------------------------------------------

class StampedOut(io.StringIO):
    """A stdout that keeps (perf_counter time, text) of every line
    written, so a CLI's log lines time its stages."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def write(self, s):
        now = time.perf_counter()
        self.lines.extend((now, ln) for ln in s.splitlines() if ln.strip())
        return super().write(s)


def pseudo_words(rng, n, max_syllables=4):
    """``n`` distinct words of 1 to ``max_syllables - 1`` syllables."""
    syl = [c + v for c in "bcdfghjklmnprstvwy" for v in "aeiou"] + [
        "th", "sh", "er", "ing", "ed", "ly"]
    out = set()
    while len(out) < n:
        k = int(rng.integers(1, max_syllables))
        out.add("".join(syl[i] for i in rng.integers(0, len(syl), k)))
    return sorted(out)


def speechlike(rng, n, scale):
    """Integer PCM: a tone under a slow envelope, plus noise."""
    t = np.arange(n)
    f = rng.uniform(15.0, 40.0)
    x = (scale * np.sin(t / f) * (0.5 + 0.5 * np.sin(t / rng.uniform(
        200.0, 900.0)) ** 2) + rng.standard_normal(n) * scale * 0.05)
    return np.round(x).astype(np.int64)


def sph_header(n, channels, coding, n_bytes=1):
    """A 1024-byte NIST SPHERE header of ``n`` samples a channel."""
    body = "".join(f"{k} {t} {v}\n" for k, (t, v) in {
        "channel_count": ("-i", channels), "sample_count": ("-i", n),
        "sample_rate": ("-i", RATE), "sample_n_bytes": ("-i", n_bytes),
        "sample_coding": (f"-s{len(coding)}", coding)}.items())
    return ("NIST_1A\n   1024\n" + body + "end_head\n").encode().ljust(
        1024, b" ")


def tdf_row(call, chan, start, end, words):
    return (f"{call}.sph\t{chan}\t{start}\t{end}\tspk{chan}\tfemale\tnative"
            f"\t{words}\t0\t0\t-1")


TDF_HEADER = (
    "file;unicode\tchannel;int\tstart;float\tend;float\tspeaker;unicode"
    "\tspeakerType;unicode\tspeakerDialect;unicode\ttranscript;unicode"
    "\tsection;int\tturn;int\tsegment;int\n"
    ";;MM sectionTypes\t[None, None]\n"
    ";;MM sectionBoundaries\t[0.0, 9999999.0]\n")


def write_audio_corpus(root, seed=11):
    """Phase 11's raw tree under ``root``: N_CONV two-channel 8 kHz tapes
    of CONV_S seconds (tape 0 embedded-shorten SPHERE written by the
    port's shorten.encode, the others mu-law SPHERE), one LDC ``.tdf``
    table each (Spanish-like transcripts, some markup) and a
    ``translations`` file (the AST side): each side speaks utterances of
    1-12 s with 0.5-5.5 s between them, about WORDS_PER_S words a second
    drawn from a Zipf-like list of AUDIO_WORDS words.  Returns (the
    shorten stream, its tape's samples, encode seconds, utterances)."""
    from ast_tpu_torch.data import shorten as sh

    rng = np.random.default_rng(seed)
    audio, tdf = os.path.join(root, "audio"), os.path.join(root, "tdf")
    os.makedirs(audio)
    os.makedirs(tdf)
    es, en = (pseudo_words(rng, AUDIO_WORDS) for _ in range(2))
    p = 1.0 / np.arange(1, AUDIO_WORDS + 1) ** 0.3
    p /= p.sum()
    n = CONV_S * RATE
    trans, n_utts = [], 0
    stream = encode_s = tape = None
    for ci in range(N_CONV):
        call = f"fsp_{ci:02d}"
        pcm = np.stack([speechlike(rng, n, 6000.0),
                        speechlike(rng, n, 3000.0)], axis=1)
        codes = np.stack([sh._nearest_code(pcm[:, c], sh._ULAW_EXPAND)
                          for c in (0, 1)], axis=1)
        if ci == 0:
            t0 = time.perf_counter()
            stream = sh.encode(sh._SIGNMAG_IN[codes], sh.TYPE_AU1, nmean=4)
            encode_s = time.perf_counter() - t0
            tape = codes
            body = sph_header(n, 2, "ulaw,embedded-shorten-v2") + stream
        else:
            body = sph_header(n, 2, "ulaw") + codes.tobytes()
        with open(os.path.join(audio, f"{call}.sph"), "wb") as f:
            f.write(body)
        rows = []
        for side in (0, 1):
            t = float(rng.uniform(0.2, 2.0))
            while True:
                dur = float(rng.uniform(1.0, 12.0))
                s0, s1 = round(t, 2), round(t + dur, 2)
                if s1 > CONV_S - 0.1:
                    break
                k = max(1, int(dur * WORDS_PER_S))
                words = " ".join(es[i] for i in rng.choice(AUDIO_WORDS, k,
                                                           p=p))
                if n_utts % 7 == 3:
                    words += " <laugh>ja ja</laugh>"
                rows.append((s0, tdf_row(call, side, s0, s1, words)))
                utt = (f"{call}-{'AB'[side]}-{int(s0 * 100):06d}-"
                       f"{int(s1 * 100):06d}")
                trans.append(f"{utt}\t" + " ".join(
                    en[i] for i in rng.choice(AUDIO_WORDS, k, p=p)))
                n_utts += 1
                t = s1 + float(rng.uniform(0.5, 5.5))
        with open(os.path.join(tdf, f"{call}.tdf"), "w") as f:
            f.write(TDF_HEADER + "\n".join(r for _, r in sorted(rows))
                    + "\n")
    with open(os.path.join(root, "translations"), "w") as f:
        f.write("\n".join(trans) + "\n")
    return stream, tape, encode_s, n_utts


def run_recipe(raw, out, wav, device="cuda"):
    """``prep_data fisher-recipe`` over the raw tree through the CLI:
    (seconds of each stage from its log line's time, total seconds)."""
    from ast_tpu_torch.cli import prep_data

    argv = ["fisher-recipe", "--audio_dir", os.path.join(raw, "audio"),
            "--tdf_dir", os.path.join(raw, "tdf"), "--translations",
            os.path.join(raw, "translations"), "--out", out, "--merges",
            str(AUDIO_MERGES), "--buckets_num", "20", "--buckets_width",
            "80", "--batch_size", str(B), "--device", device] + (
                ["--wav"] if wav else [])
    stamped = StampedOut()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stamped):
        prep_data.main(argv)
    total = time.perf_counter() - t0
    names = {"[tdf]": "tdf-to-text", "[1/6]": "extract-segments",
             "[2-3/6]": "mfcc+cmvn", "[4/6]": "bpe+dicts+refs",
             "[5/6]": "configs", "[6/6]": "validate"}
    stages, last = {}, t0
    for when, line in stamped.lines:
        key = line.split(" ", 1)[0]
        if key in names:
            name = names[key]
            if key == "[2-3/6]":
                name += " " + line.split()[1].rstrip(":")
            stages[name] = when - last
            last = when
    assert "experiment ready" in stamped.getvalue(), stamped.getvalue()
    return stages, total


def text_side_equal(wav_out, feat_out):
    """The two recipe trees' text side: every file of text/ and data/
    and model_cfg.json byte-equal, train_cfg.json equal but for
    data.features and the root; returns the number of files compared."""
    n = 0
    for sub in ("text", "data"):
        for d, _, files in os.walk(os.path.join(wav_out, sub)):
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), wav_out)
                with open(os.path.join(wav_out, rel), "rb") as a, open(
                        os.path.join(feat_out, rel), "rb") as b:
                    assert a.read() == b.read(), f"{rel} differs"
                n += 1
    cfgs = []
    for out in (wav_out, feat_out):
        with open(os.path.join(out, "exp", "model_cfg.json"), "rb") as f:
            cfgs.append(f.read())
        with open(os.path.join(out, "exp", "train_cfg.json")) as f:
            text = f.read().replace(out, "<root>")
        cfg = json.loads(text)
        cfg["data"].pop("features", None)
        cfgs.append(cfg)
    assert cfgs[0] == cfgs[2] and cfgs[1] == cfgs[3]
    return n + 2


def check_features_on_cpu(wav_out, feat_out, sets):
    """The features tree's .npy files against the CPU fbank + CMVN (stats
    per speaker from the CPU's own features) of the wav tree's audio:
    (files, largest difference)."""
    from ast_tpu_torch.ops.fbank import MfccExtractor, compute_cmvn_stats

    with open(os.path.join(wav_out, "speech", "cmvn.stats"), "rb") as f:
        utt2spk = pickle.load(f)["utt2spk"]
    ext = MfccExtractor(device="cpu")
    worst, n = 0.0, 0
    for c in sets:
        d = os.path.join(wav_out, "speech", c)
        feats = {f[:-4]: ext(np.load(os.path.join(d, f))[None])[0].numpy()
                 for f in sorted(os.listdir(d))}
        by_spk = {}
        for u, x in feats.items():
            by_spk.setdefault(utt2spk[u], []).append(x)
        stats = {s: compute_cmvn_stats(xs) for s, xs in by_spk.items()}
        for u, x in feats.items():
            s = stats[utt2spk[u]]
            want = (x - s["mean"]) / s["std"]
            got = np.load(os.path.join(feat_out, "speech", c, f"{u}.npy"))
            assert got.shape == want.shape, u
            worst = max(worst, float(np.abs(got - want).max()))
            n += 1
    return n, worst


def nnet2_bnf_text(rng, d_in=13, splice=4, hidden=(1000, 1000), group=5,
                   bnf_dim=42):
    """A text-format nnet2 net shaped as a Kaldi BNF net: splice
    +-``splice``, a fixed (LDA-like) affine, p-norm hidden layers with
    Normalize, and the ``bnf_dim`` bottleneck affine."""
    def mat(m):
        return "[\n" + "\n".join(" ".join(f"{v:.7e}" for v in row)
                                 for row in m) + " ]"

    def vec(v):
        return "[ " + " ".join(f"{x:.7e}" for x in v) + " ]"

    ctx = " ".join(str(c) for c in range(-splice, splice + 1))
    d = d_in * (2 * splice + 1)
    parts = [f"<SpliceComponent> <InputDim> {d_in} <Context> [ {ctx} ] "
             f"<ConstComponentDim> 0 </SpliceComponent>",
             f"<FixedAffineComponent> <LinearParams> "
             f"{mat(rng.standard_normal((d, d)) / np.sqrt(d))} <BiasParams> "
             f"{vec(rng.standard_normal(d) * 0.1)} </FixedAffineComponent>"]
    for h in hidden:
        parts.append(
            f"<AffineComponentPreconditionedOnline> <LearningRate> 0.001 "
            f"<LinearParams> {mat(rng.standard_normal((h, d)) / np.sqrt(d))}"
            f" <BiasParams> {vec(rng.standard_normal(h) * 0.1)} <RankIn> 20"
            f" <RankOut> 80 </AffineComponentPreconditionedOnline>")
        d = h // group
        parts += [f"<PnormComponent> <InputDim> {h} <OutputDim> {d} <P> 2 "
                  f"</PnormComponent>",
                  f"<NormalizeComponent> <Dim> {d} <ValueAvg> [ 1 2 ] "
                  f"<DerivAvg> [ 3 ] <Count> 5 </NormalizeComponent>"]
    parts.append(f"<AffineComponent> <LinearParams> "
                 f"{mat(rng.standard_normal((bnf_dim, d)) / np.sqrt(d))} "
                 f"<BiasParams> {vec(rng.standard_normal(bnf_dim))} "
                 f"</AffineComponent>")
    return (f"<Nnet> <NumComponents> {len(parts)} <Components>\n"
            + "\n".join(parts) + "\n</Components> </Nnet>\n")


def features_busy(nn, batch, reps):
    """Device busy ms a call of ``nn.features`` on a device batch, and the
    busy ms a call by kernel name, largest first, from ``reps`` calls
    under torch.profiler (after one warm-up call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        nn.features(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                nn.features(batch)
            torch.cuda.synchronize()
    busy, _ = device_busy(prof)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:40]] = by_name.get(e.name[:40], 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return busy / reps, sorted(by_name.items(), key=lambda kv: -kv[1])


def host_bytes(batch, keys):
    return sum(np.asarray(batch[k]).nbytes for k in keys)


def run_audio_corpus(root, smi):
    """Phase 11: synthetic raw tapes and LDC transcripts -> prep_data
    fisher-recipe (wav and features modes) -> checks of both trees ->
    cli.train on audio, cli.beam, an epoch from a .pack, prep_data bnf."""
    import torch

    from ast_tpu_torch import native
    from ast_tpu_torch.cli import beam, prep_data, train
    from ast_tpu_torch.data import shorten as sh
    from ast_tpu_torch.data.feature_pack import FeaturePack
    from ast_tpu_torch.train.trainer import NN

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on"
    t_phase = time.perf_counter()
    zero_counts()
    raw = os.path.join(root, "audio_raw")
    stream, tape, encode_s, n_utts = write_audio_corpus(raw)
    mb = tape.nbytes / 1e6
    t0 = time.perf_counter()
    assert native.library() is not None, "no g++: the native readers are off"
    build_s = time.perf_counter() - t0        # g++, unless built before
    t0 = time.perf_counter()
    st = sh.decode(stream)
    native_s = time.perf_counter() - t0
    assert np.array_equal(st.samples, sh._SIGNMAG_IN[tape])
    head = 20 * RATE                    # the Python decoder on 20 s of it
    t0 = time.perf_counter()
    st_py = sh.decode(stream, max_samples=head, _force_python=True)
    py_s = time.perf_counter() - t0
    assert np.array_equal(st_py.samples, st.samples[:len(st_py.samples)])
    rate_c, rate_py = mb / native_s, st_py.samples.size / 1e6 / py_s
    print(f"audio corpus: {N_CONV} two-channel 8 kHz tapes of {CONV_S} s, "
          f"{n_utts} utterances of 1-12 s, {AUDIO_WORDS}-word lists; tape 0 "
          f"embedded-shorten ({len(stream) / 1e6:.2f} MB for {mb:.2f} MB of "
          f"mu-law samples), encoded by shorten.encode in {encode_s:.2f} s "
          f"(not in the recipe's time); the native readers' library "
          f"{build_s:.2f} s to build and load; decode: native {rate_c:.1f} "
          f"MB/s ({native_s:.3f} s, the whole tape), Python {rate_py:.2f} "
          f"MB/s ({py_s:.2f} s, its first 20 s): native "
          f"{rate_c / rate_py:.0f}x",
          flush=True)

    outs, times = {}, {}
    for mode in ("wav", "features"):
        out = os.path.join(root, f"audio_{mode}")
        stages, total = run_recipe(raw, out, mode == "wav")
        outs[mode], times[mode] = out, total
        print(f"  prep_data fisher-recipe{' --wav' if mode == 'wav' else ''}"
              f" --device cuda: {total:.2f} s = " + ", ".join(
                  f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    wav_out, feat_out = outs["wav"], outs["features"]
    wav_exp, feat_exp = (os.path.join(o, "exp") for o in (wav_out, feat_out))
    with open(os.path.join(wav_exp, "train_cfg.json")) as f:
        tcfg = json.load(f)
    sets = (tcfg["train_set"], tcfg["dev_set"])
    with open(tcfg["data"]["info_path"], "rb") as f:
        info = pickle.load(f)
    with open(tcfg["data"]["vocab_path"], "rb") as f:
        V = len(pickle.load(f)["bpe_w"]["w2i"])
    n_files = text_side_equal(wav_out, feat_out)
    n_feats, feat_err = check_features_on_cpu(wav_out, feat_out, sets)
    assert feat_err <= 1e-3, f"features differ from the CPU's by {feat_err}"
    frames = [e["sp"] for e in info[sets[0]].values()]
    fill = {}
    for nb in range(20, 9, -1):
        counts_b = np.bincount(np.minimum(np.asarray(frames) // 80, nb - 1),
                               minlength=nb)
        used = counts_b[counts_b > 0]
        fill[nb] = (int((used >= 8).sum()), len(used),
                    int((np.asarray(frames) > (nb + 1) * 80).sum()))
    print(f"  trees: {len(info[sets[0]])} train / {len(info[sets[1]])} dev "
          f"utterances, V = {V}, max_pred {tcfg['data']['max_pred']}; the "
          f"text side byte-equal ({n_files} files); {n_feats} feature files "
          f"within {feat_err:.2e} of the CPU fbank + CMVN; train buckets of "
          f"8+ utterances / used / utterances cut, by --buckets_num (width "
          f"80): " + ", ".join(f"{k}: {a}/{b}/{c}" for k, (a, b, c) in
                               fill.items() if k % 2 == 0)
          + f"; every used bucket at 8+ and none cut from --buckets_num "
          f"{min(k for k, (a, b, c) in fill.items() if a == b and not c)}",
          flush=True)
    for exp in (wav_exp, feat_exp):
        _, out = quiet(prep_data.main, ["validate", exp, "--deep"])
        assert out.rstrip().endswith("0 errors, 0 warnings"), out

    # one batch: featurized on the card against the features tree's
    from ast_tpu_torch.data.dataloader import make_dataloader
    with open(os.path.join(feat_exp, "train_cfg.json")) as f:
        fcfg = json.load(f)
    nn = NN(wav_exp, "cuda")
    wav_b = next(nn.data_loader.get_batch(B, sets[0], train=False,
                                          labels=True, epoch=1))
    feat_b = next(make_dataloader(fcfg, feat_exp).get_batch(
        B, sets[0], train=False, labels=True, epoch=1))
    assert wav_b["utts"] == feat_b["utts"]
    assert np.array_equal(wav_b["frame_len"], feat_b["frame_len"])
    with torch.no_grad():
        X = nn.features(nn._device_batch(wav_b)).cpu().numpy()
    assert X.shape == feat_b["X"].shape, (X.shape, feat_b["X"].shape)
    real = wav_b["frame_len"][:wav_b["n_real"]]
    batch_err = max(float(np.abs(X[j, :L] - feat_b["X"][j, :L]).max())
                    for j, L in enumerate(real))
    assert batch_err <= 1e-3, f"card features differ by {batch_err}"
    print(f"  validate --deep: 0 errors, 0 warnings on both trees; a "
          f"{wav_b['n_real']}-utterance batch featurized and normalised on "
          f"the card within {batch_err:.2e} of the features tree's",
          flush=True)

    # the step: wav mode beside features mode, on the same utterances, in
    # B rows (no tail shrinking) at the bucket nearest FRAMES frames
    order = list(nn.data_loader.get_batch(B, sets[0], train=True,
                                          labels=True, epoch=1))
    wav_s = min(order, key=lambda b: abs(b["n_frames"] - FRAMES))
    feat_s = next(b for b in make_dataloader(fcfg, feat_exp).get_batch(
        B, sets[0], train=True, labels=True, epoch=1)
        if b["utts"] == wav_s["utts"])
    nn_f = NN(feat_exp, "cuda")
    wav_dev, feat_dev = nn._device_batch(wav_s), nn_f._device_batch(feat_s)
    split = step_split(nn, wav_dev, 5)
    fbank_busy, fbank_groups = features_busy(nn, wav_dev, 10)
    turns = [tuple(cuda_ms(lambda m=m, b=b: m.train_step(b, 0), 5)
                   for m, b in ((nn, wav_dev), (nn_f, feat_dev)))
             for _ in range(2)]
    del nn, nn_f
    wav_bytes = host_bytes(wav_s, ("audio", "cmvn_mean", "cmvn_std", "y"))
    feat_bytes = host_bytes(feat_s, ("X", "y"))
    print(f"  one step (B={wav_s['rows']}, {wav_s['n_real']} utterances, "
          f"{wav_s['n_frames']} frames, U={wav_s['y'].shape[1]}; {smi}): wav "
          f"mode {split['step']:.2f} ms = fbank + CMVN {split['features']:.3f}"
          f" + the rest {split['step'] - split['features']:.2f}; in turns, "
          f"wav / features mode " + ", ".join(f"{w:.2f} / {f:.2f}"
                                                for w, f in turns)
          + f" ms; host to device {wav_bytes / 1e6:.2f} MB a "
          f"step (audio, CMVN rows, targets) against {feat_bytes / 1e6:.2f} "
          f"MB (features, targets); fbank + CMVN alone, 10 calls under "
          f"torch.profiler: device busy {fbank_busy:.3f} ms a call ("
          + ", ".join(f"{k} {v:.3f}" for k, v in fbank_groups[:4]) + ")",
          flush=True)

    # train on audio, beam-decode, an epoch from a pack, BNF
    zero_counts()
    t0 = time.perf_counter()
    _, report = quiet(train.main, ["-m", wav_exp, "-e", "2", "--device",
                                   "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rates = [float(v) for v in re.findall(
        r"train throughput = ([0-9.]+) utts/sec", report)]
    with open(os.path.join(wav_exp, "train.log")) as f:
        losses = [float(line.split(", ")[1]) for line in f]
    with open(os.path.join(wav_exp, "dev.log")) as f:
        bleus = [line.strip() for line in f]
    n_train = counts()
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert losses[1] < losses[0], f"the loss did not fall: {losses}"
    assert len(bleus) == 2 and len(rates) == 2, (bleus, rates)
    for k in ("k1t", "k2", "k3", "k4", "k1", "k5"):
        assert n_train[k] > 0, f"training on audio never launched {k}"
    zero_counts()
    t0 = time.perf_counter()
    bleu, _ = quiet(beam.main, ["-m", wav_exp, "-n", str(N_BEAM), "-k",
                                str(K_BEAM), "-w", "0.6", "-s", sets[1],
                                "--device", "cuda"])
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    n_beam = counts()
    assert n_beam["k1"] > 0 and n_beam["k6"] > 0, n_beam
    with open(os.path.join(wav_exp, f"{sets[1]}_beam_N-{N_BEAM}_K-{K_BEAM}"
                           f"_W-0.60.en")) as f:
        assert len(f.read().splitlines()) == len(info[sets[1]])
    print(f"  cli.train -e 2 on audio ({smi}): train.log losses {losses}, "
          f"dev.log {bleus}; train {rates} utts/s; {train_s:.1f} s; launches"
          f" {n_train}; cli.beam -n {N_BEAM} -k {K_BEAM} on {sets[1]}: BLEU "
          f"{bleu:.2f}, {len(info[sets[1]]) / beam_s:.1f} utts/s over the "
          f"call, launches {n_beam}", flush=True)

    speech = os.path.join(feat_out, "speech")
    pack = os.path.join(speech, f"{sets[0]}.pack")
    _, msg = quiet(prep_data.main, ["pack-features",
                                    os.path.join(speech, sets[0]), pack])
    os.rename(os.path.join(speech, sets[0]),
              os.path.join(speech, sets[0] + ".unpacked"))
    zero_counts()
    with counting(FeaturePack, "get") as gets:
        _, report = quiet(train.main, ["-m", feat_exp, "-e", "1",
                                       "--device", "cuda"])
    n_pack = counts()
    with open(os.path.join(feat_exp, "train.log")) as f:
        pack_loss = [float(line.split(", ")[1]) for line in f]
    assert len(pack_loss) == 1 and np.isfinite(pack_loss[0]), pack_loss
    assert gets[0] >= len(info[sets[0]]), gets[0]
    assert n_pack["k1t"] > 0 and n_pack["k5"] > 0, n_pack

    rng = np.random.default_rng(3)
    net = os.path.join(root, "bnf.nnet2.txt")
    with open(net, "w") as f:
        f.write(nnet2_bnf_text(rng))
    dev_feats = os.path.join(speech, sets[1])
    bnf_s = {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quiet(prep_data.main, ["bnf", dev_feats, os.path.join(
            root, f"bnf_{device}"), "--model", net, "--device", device])
        torch.cuda.synchronize()
        bnf_s[device] = time.perf_counter() - t0
    bnf_err, n_bnf = 0.0, 0
    for f in os.listdir(os.path.join(root, "bnf_cpu")):
        a = np.load(os.path.join(root, "bnf_cuda", f))
        b = np.load(os.path.join(root, "bnf_cpu", f))
        assert a.shape == b.shape and a.shape[1] == 42, a.shape
        bnf_err = max(bnf_err, float(np.abs(a - b).max()))
        n_bnf += 1
    assert bnf_err <= 1e-4, f"BNF on the card differs by {bnf_err}"
    wall = time.perf_counter() - t_phase
    print(f"  {msg.strip()}; one epoch of the features tree from it: loss "
          f"{pack_loss[0]:.4f}, {gets[0]} pack reads, launches {n_pack}; "
          f"prep_data bnf (splice +-4, p-norm 1000 -> 200 twice, 42-dim "
          f"bottleneck) on {n_bnf} dev files: cuda {bnf_s['cuda']:.2f} s, "
          f"cpu {bnf_s['cpu']:.2f} s, within {bnf_err:.2e}; phase "
          f"{wall:.1f} s", flush=True)
    return dict(encode_s=encode_s, recipe_s=times, V=V, feat_err=feat_err,
                batch_err=batch_err, split=split, turns=turns,
                wav_bytes=wav_bytes, feat_bytes=feat_bytes, losses=losses,
                utts_per_s=rates, bnf_err=bnf_err, seconds=wall,
                launches={k: n_train[k] + n_beam[k] for k in n_train})


# ---------------------------------------------------------------------------
# phase 12: the model variants, each stage routed as ast_tpu routes it
# ---------------------------------------------------------------------------

# phase 12's batch: B=8 rows (32 would not fit the phase's budget with the
# plain stages' launches), FRAMES frames, decodes to PARTIAL_STOP steps
VARIANT_ROWS = 8
# the variants, each an edit of es_en_20h's model_cfg, with the stages
# that run a kernel (the routing table: "enc" K1 / K2, "dec" K3 / K4,
# "infer" K5 / K6; the rest plain PyTorch on the card, as ast_tpu runs
# them on XLA)
VARIANT_STAGES = {
    "ln": set(), "rnn_relu": set(), "linear_proj": {"dec", "infer"},
    "bi_rnn false": {"enc", "dec", "infer"}, "n_attn 2": {"enc"},
    "feed_attn false": {"enc"}, "dropout.out 0.3": {"enc", "infer"},
    "attn_block_size 32": {"enc"},
    "max_pool + leaky_relu": {"enc", "dec", "infer"},
    "text input": {"enc", "dec", "infer"},
    # widths the kernels' shape gates turn away: 40 units a direction,
    # E = 100 (every stage plain, as ast_tpu's scan path)
    "hidden_units 80 + embedding_units 100": set(),
}
# the kernels of each stage, in train steps and in decodes
STAGE_KERNELS = {"enc": ("k1t", "k2"), "dec": ("k3", "k4")}


def variant_cfg(mcfg, name):
    """es_en_20h's ``mcfg`` with variant ``name``'s edit."""
    import copy

    m = copy.deepcopy(mcfg)
    rnn, layers = m["rnn_config"], m["cnn_config"]["cnn_layers"]
    if name in ("ln", "rnn_relu", "linear_proj"):
        rnn[name] = True
    elif name == "bi_rnn false":
        rnn["bi_rnn"] = False
    elif name == "n_attn 2":
        rnn["n_attn"] = 2
    elif name == "feed_attn false":
        rnn["feed_attn"] = False
    elif name == "dropout.out 0.3":
        m["dropout"]["out"] = 0.3
    elif name == "attn_block_size 32":
        rnn["attn_block_size"] = 32
    elif name == "max_pool + leaky_relu":
        # layer 0 pools by 2 after its stride 2, layer 1 keeps the length:
        # the same T' = T / 4
        layers[0].update(max_pool=[3, 2], leaky_relu=True)
        layers[1].update(stride=[1, 1], leaky_relu=True)
    elif name == "hidden_units 80 + embedding_units 100":
        rnn.update(hidden_units=80, embedding_units=100)
    elif name == "text input":
        E = rnn["embedding_units"]
        rnn["enc_vocab_size"] = rnn["dec_vocab_size"]
        layers[0].update(ksize=[layers[0]["ksize"][0], E], stride=[
            layers[0]["stride"][0], E])
    elif name != "default":
        raise KeyError(name)
    return m


def check_launched(what, n, want):
    """The kernels with a count above 0 in ``n`` are exactly ``want``."""
    got = {k for k, v in n.items() if v > 0}
    assert got == set(want), (f"{what}: launched {sorted(got)}, routed "
                              f"{sorted(want)}")


def check_routing(what, stages, n, kinds):
    """The counts ``n`` of one train step (``kinds`` "train") or decode
    ("greedy", "beam") against the stages routed to a kernel: a stage's
    kernels above 0 when routed to one, 0 when plain; the other kernels
    0."""
    want = set()
    if kinds == "train":
        for stage, keys in STAGE_KERNELS.items():
            if stage in stages:
                want.update(keys)
    else:
        if "enc" in stages:
            want.add("k1")
        if "infer" in stages:
            want.add("k5" if kinds == "greedy" else "k6")
    check_launched(what, n, want)


def variant_step(params, state, mcfg, X, y, draws, compute_dtype=None):
    """One train step's loss and parameter gradients (forward_loss and
    autograd, as NN.train_step), at ``compute_dtype`` (None: float32)."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.train.optimizer import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = seq2seq.forward_loss(
        params, state, mcfg, X, y, float(X.shape[0]), draws,
        compute_dtype=compute_dtype or torch.float32)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@contextlib.contextmanager
def plain_kernels(sel=None, eval_encoder=False):
    """The training kernels' wrappers (K1 train, K2, K3, K4) replaced by
    their plain versions on every device, inside the block; with ``sel``
    (a K3 call's selected ids) the plain decoder forward takes those ids
    as its inputs; with ``eval_encoder`` K1 eval's wrapper too."""
    import functools

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl

    def k1t(x0, wxr, wh, b, seed, rate, row_offset=0, global_rows=None):
        return fl.stacked_lstm_reference(x0, wxr, wh, b, True, seed, rate,
                                         row_offset=row_offset,
                                         global_rows=global_rows)

    def k1(x0, wxr, wh, b, packed=None):
        return fl.stacked_lstm_reference(x0, wxr, wh, b)

    patches = ((fl, "fused_stacked_lstm_train", k1t),
               (fl, "encoder_backward", fl.encoder_backward_reference),
               (fd, "decoder_forward", functools.partial(
                   fd.decoder_forward_reference, forced_ids=sel)),
               (fd, "decoder_backward", fd.decoder_backward_reference))
    if eval_encoder:
        patches += ((fl, "fused_stacked_lstm", k1),
                    (seq2seq, "fused_stacked_lstm", k1))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def grad_errs(got, want):
    """Each gradient leaf's max |got - want| over the larger of its own
    max |want| and 1e-3 of the largest leaf's: a leaf whose gradient is
    zero but for rounding (a bias ahead of batch-statistics BN) is held
    at that floor."""
    floor = 1e-3 * max(float(w.abs().max()) for w in want)
    return [float((g.to(w) - w).abs().max()) / max(float(w.abs().max()),
                                                    floor)
            for g, w in zip(got, want)]


def leaf_dists(got, want):
    """Each gradient leaf's distance in the Frobenius norm, ||got - want||
    over the larger of ||want|| and 1e-3 of the largest leaf's norm (the
    floor of :func:`grad_errs`), on the CPU in float64."""
    want = [w.detach().cpu().double() for w in want]
    norms = [float(w.norm()) for w in want]
    floor = 1e-3 * max(norms)
    return [float((g.detach().cpu().double() - w).norm()) / max(n, floor)
            for g, w, n in zip(got, want, norms)]


def variant_step_f64(params, state, mcfg, X, y, draws, compute_dtype=None):
    """The gradients of :func:`variant_step` in float64, on the device of
    ``params`` (plain stages only: the kernels are float32); at
    ``compute_dtype`` bf16 every rounding point still rounds to bf16 and
    the rest runs in float64: the bf16 function with its sums taken
    exactly."""
    import dataclasses

    from ast_tpu_torch.params import tree_map

    p64, s64 = (tree_map(lambda t: t.detach().double(), tree)
                for tree in (params, state))
    d64 = dataclasses.replace(
        draws, noise=None if draws.noise is None else draws.noise.double())
    with float64_default():
        return variant_step(p64, s64, mcfg,
                            X.double() if X.is_floating_point() else X, y,
                            d64, compute_dtype)[1]


def variant_inputs(mcfg, device, seed=12):
    """Phase 12's seeded batch: VARIANT_ROWS x FRAMES features (token ids
    for text input), U_TRAIN targets, and the step's draws (dropout at
    es_en_20h's rates, speech noise, every step teacher-forced so the
    card and the CPU feed the same tokens), on the CPU."""
    import torch

    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.models import seq2seq

    rng = np.random.default_rng(seed)
    nb = VARIANT_ROWS
    if mcfg["rnn_config"].get("enc_vocab_size", 0):
        X = torch.from_numpy(rng.integers(
            SYMBOLS.N_SPECIAL, mcfg["rnn_config"]["enc_vocab_size"],
            (nb, FRAMES)).astype(np.int32))
    else:
        X = torch.from_numpy(rng.standard_normal((nb, FRAMES, 13)).astype(
            np.float32))
    V = mcfg["rnn_config"]["dec_vocab_size"]
    y = np.full((nb, U_TRAIN), SYMBOLS.PAD_ID, np.int64)
    for r in range(nb):
        n = int(rng.integers(5, U_TRAIN - 1))
        y[r, 0] = SYMBOLS.GO_ID
        y[r, 1:n] = rng.integers(SYMBOLS.N_SPECIAL, V, n - 1)
        y[r, n] = SYMBOLS.EOS_ID
    draws = seq2seq.make_draws(seed, X, U_TRAIN - 1, 1.0, NOISE)
    return X, torch.from_numpy(y), draws


def draws_on(draws, device):
    import dataclasses

    return dataclasses.replace(
        draws, coins=draws.coins.to(device),
        noise=None if draws.noise is None else draws.noise.to(device))


def run_variant(name, base, device, smi):
    """Phase 12 for one variant: the routing of one train step, one
    greedy batch and one beam 5,5 batch read from the kernel counters;
    the card's loss and gradients against the same call on the CPU; the
    card's greedy tokens and beams held along their own path by the
    plain step on the CPU; ms a train step and greedy utts/s.  Returns
    (ms a step, greedy utts/s)."""
    import torch

    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import beam as beam_ops
    from ast_tpu_torch.ops import fused_infer
    from ast_tpu_torch.params import tree_map

    mcfg = variant_cfg(base, name)
    stages = VARIANT_STAGES.get(name, {"enc", "dec", "infer"})
    got_stages = {s for s, on in (
        ("enc", seq2seq.use_fused_encoder(mcfg, device)),
        ("dec", seq2seq.use_fused_decoder(mcfg, device, T=FRAMES // 4)),
        ("infer", seq2seq.use_fused_infer(mcfg, device, VARIANT_ROWS,
                                          FRAMES // 4, N_BEAM, K_BEAM)))
        if on}
    assert got_stages == stages, (name, got_stages, stages)
    cpu = torch.device("cpu")
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    p_cpu, s_cpu = (tree_map(lambda t: t.detach().to(cpu), tree)
                    for tree in (params, state))
    X, y, draws = variant_inputs(mcfg, device)
    Xd, yd, dd = X.to(device), y.to(device), draws_on(draws, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    zero_counts()
    loss, grads = variant_step(params, state, mcfg, Xd, yd, dd)
    sync()
    check_routing(f"{name}: train step", stages, counts(), "train")
    t0 = time.perf_counter()
    variant_step(params, state, mcfg, Xd, yd, dd)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    loss_c, grads_c = variant_step(p_cpu, s_cpu, mcfg, X, y, draws)
    loss_rel = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
    # every gradient crosses plain stages only (1e-4), or also K2 / K4,
    # whose bound against their plain versions is BWD_TOL
    tol = 1e-4 if not stages & {"enc", "dec"} else BWD_TOL
    names = leaf_names(params)
    worst = max(zip(grad_errs(grads, grads_c), names))
    assert loss_rel <= 1e-4, f"{name}: the card's loss is {loss_rel} apart"
    note = ""
    if worst[0] > tol:
        # the float32 gradients of LayerNorm and of the kinks of ReLU and
        # max pooling move by more than the bound under a change of
        # summation order (the CPU's own float32 ones against float64
        # too): the model then runs the same step in float64 on both
        # devices -- the training kernels' plain versions in the kernels'
        # place, the kernels being float32 and held to those versions in
        # phases 5 and 12 -- and the two must agree
        with plain_kernels():
            g64 = variant_step_f64(params, state, mcfg, Xd, yd, dd)
        c64 = variant_step_f64(p_cpu, s_cpu, mcfg, X, y, draws)
        f64 = max(grad_errs(g64, c64))
        spread = [max(grad_errs(f32, ref))
                  for f32, ref in ((grads, g64), (grads_c, c64))]
        assert f64 <= 1e-9, f"{name}: float64 gradients {f64:.3e} apart"
        note = (f"; float32 itself moves these gradients by {spread[0]:.2e}"
                f" on the card and {spread[1]:.2e} on the CPU (each against "
                f"its float64 step), and in float64 the card's equal the "
                f"CPU's within {f64:.2e}")
    with torch.inference_mode():
        w = seq2seq.decode_weights(params)
        zero_counts()
        preds, n_steps = seq2seq.predict_greedy(params, state, mcfg, Xd,
                                                PARTIAL_STOP, w)
        sync()
        check_routing(f"{name}: greedy batch", stages, counts(), "greedy")
        t0 = time.perf_counter()
        seq2seq.predict_greedy(params, state, mcfg, Xd, PARTIAL_STOP, w)
        sync()
        greedy_rate = X.shape[0] / (time.perf_counter() - t0)
        zero_counts()
        beam_ops.make_beam_decoder(mcfg, N_BEAM, K_BEAM, PARTIAL_STOP)(
            params, state, Xd, w)
        sync()
        check_routing(f"{name}: beam batch", stages, counts(), "beam")
        # the beam's per-step streams along the card's own path
        enc, h0, c0 = seq2seq.encode(params, state, mcfg, Xd, w)
        if "infer" in stages:
            tok, par, val, scores = fused_infer.beam_search_streams(
                enc, h0, c0, w, N_BEAM, K_BEAM, PARTIAL_STOP)
        else:
            out = fused_infer.beam_reference(
                enc, h0, c0, w, N_BEAM, K_BEAM, PARTIAL_STOP, trace=True,
                step=seq2seq.plain_step(params, mcfg))
            scores, tok, par, val = out[1], out[3], out[4], out[5]

        w_c = seq2seq.decode_weights(p_cpu)
        enc, h0, c0 = seq2seq.encode(p_cpu, s_cpu, mcfg, X, w_c)
        step = seq2seq.plain_step(p_cpu, mcfg)
        short, n_run = fused_infer.greedy_follow(enc, h0, c0, w_c,
                                                 preds.cpu(), step)
        pad_ok = bool((preds[:, n_run:] == SYMBOLS.PAD_ID).all())
        f_scores, topk_short, sel_err, bad = fused_infer.beam_follow(
            enc, h0, c0, w_c, N_BEAM, K_BEAM, tok.cpu(), par.cpu(),
            val.cpu(), step)
        score_err = float((f_scores - scores.cpu()).abs().max())
    assert float(short.max()) <= TOK_TOL and pad_ok and n_run == int(
        n_steps), (f"{name}: the greedy tokens disagree with the plain step: "
                   f"{float(short.max())}, PAD {pad_ok}")
    assert (float(topk_short.max()) <= TOK_TOL
            and float(sel_err.max()) <= SCORE_TOL and not bool(bad.any())
            and score_err <= SCORE_TOL), (
        f"{name}: the beam disagrees with the plain step")
    print(f"  {name}: kernels at {sorted(stages) or 'no stage'}; train "
          f"step loss {loss.item():.4f} ({loss_rel:.2e} from the CPU's), "
          f"worst gradient {worst[1]} {worst[0]:.2e} of max|CPU| (tol "
          f"{tol}{note}); greedy {int(n_steps)} steps, every token within "
          f"{float(short.max()):.2e} of the CPU step's best logit; beam "
          f"top-K {float(topk_short.max()):.2e}, selection "
          f"{float(sel_err.max()):.2e}, score {score_err:.2e}; "
          f"{step_ms:.1f} ms a train step, greedy {greedy_rate:.1f} utts/s "
          f"({smi})", flush=True)
    return step_ms, greedy_rate


def check_routing_bf16(what, stages, kinds, device):
    """The counts of one bf16 train step (``kinds`` "train") or decode
    ("greedy", "beam") against the stages routed to a kernel: on the card
    a stage's bf16 entries above 0 when routed to a kernel, every other
    bf16 entry 0, and no f32 entry launched; on the CPU (the plain
    versions) nothing."""
    want = set()
    if str(device).startswith("cuda"):
        if kinds == "train":
            want.update(k for stage, keys in (
                ("enc", ("k1_train_bf16", "k2_bf16")),
                ("dec", ("k3_bf16", "k4_bf16"))) if stage in stages
                for k in keys)
        else:
            if "enc" in stages:
                want.add("k1_bf16")
            if "infer" in stages:
                want.add("k5_bf16" if kinds == "greedy" else "k6_bf16")
    check_launched(what, dict(bf16_counters(), **bf16_train_counts()), want)
    f32 = {k: v for k, v in counts().items() if v}
    assert not f32, f"{what}: f32 entries launched at bf16: {f32}"


def zero_all_counts():
    zero_counts()
    zero_bf16_counts()
    zero_train_counts()


def run_variant_bf16(name, base, device, smi):
    """Phase 12's bf16 pass for one variant (compute_dtype bfloat16: the
    scan path's rounding points on its plain stages, the kernels' bf16
    modes on its kernel stages): the routing of one train step, one
    greedy batch and one beam 5,5 batch read from the bf16 and f32
    counters; the card's loss against the same bf16 call on the CPU
    within BF16_LOSS_TOL; its gradients and encoder outputs by the
    comparison of the variant's stages (:func:`bf16_limits`); the card's
    greedy tokens and beams held along their own path by the CPU's bf16
    step (the K5 / K6 plain bf16 step where the variant decodes on them,
    else the scan path's) on the card's encoder outputs, within
    BF16_TOK_TOL and BF16_SCORE_TOL; ms a train step and greedy utts/s.
    Returns (ms a step, greedy utts/s)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        # the CPU's reference calls route as the card's do (a width the
        # kernels do not take runs the scan path on both: at bf16 its
        # rounding is not K1's plain version's)
        with card_routing():
            return _run_variant_bf16(name, base, device, smi)
    return _run_variant_bf16(name, base, device, smi)


@contextlib.contextmanager
def card_routing():
    """``seq2seq``'s routing predicates apply the card's shape gate to
    every device inside the block."""
    from ast_tpu_torch.models import seq2seq

    on_card = seq2seq.on_card
    seq2seq.on_card = lambda device: True
    try:
        yield
    finally:
        seq2seq.on_card = on_card


def bf16_limits(stages, cpu, exact):
    """The bf16 pass's comparison, fixed by a variant's kernel ``stages``,
    for readings whose CPU float32-sum values are ``cpu`` and whose
    float64-sum values ``exact()`` gives: (the reference the card is held
    to, ``bounds(cpu_dists, tol)`` -> each reading's bound, from the
    CPU's own distances from that reference).  With a kernel stage the
    reference is the CPU's call (the plain bf16 version in the kernel's
    place) and every bound ``tol``.  With none it is the float64-sum
    function, and each bound the larger of ``tol`` and BF16_SPREAD times
    the CPU's distance: where bf16's rounding feeds an ill-conditioned
    gradient, a value rounding to the other bf16 neighbour in one float32
    sum and not in another moves a leaf past ``tol`` on any device, and
    the card must then lie no further than the CPU does from the
    exact-sum function."""
    if stages:
        return cpu, lambda dists, tol: [tol] * len(dists)
    return exact(), lambda dists, tol: [max(tol, BF16_SPREAD * d)
                                        for d in dists]


def _run_variant_bf16(name, base, device, smi):
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import beam as beam_ops
    from ast_tpu_torch.ops import fused_infer
    from ast_tpu_torch.params import tree_map

    bf = torch.bfloat16
    mcfg = variant_cfg(base, name)
    stages = {s for s, on in (
        ("enc", seq2seq.use_fused_encoder(mcfg, device)),
        ("dec", seq2seq.use_fused_decoder(mcfg, device, T=FRAMES // 4)),
        ("infer", seq2seq.use_fused_infer(mcfg, device, VARIANT_ROWS,
                                          FRAMES // 4, N_BEAM, K_BEAM)))
        if on}
    if device.type == "cuda":
        assert stages == VARIANT_STAGES.get(name, {"enc", "dec", "infer"})
    cpu = torch.device("cpu")
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    p_cpu, s_cpu = (tree_map(lambda t: t.detach().to(cpu), tree)
                    for tree in (params, state))
    X, y, draws = variant_inputs(mcfg, device)
    Xd, yd, dd = X.to(device), y.to(device), draws_on(draws, device)

    zero_all_counts()
    loss, grads = variant_step(params, state, mcfg, Xd, yd, dd, bf)
    sync(device)
    check_routing_bf16(f"{name}: bf16 train step", stages, "train", device)
    t0 = time.perf_counter()
    variant_step(params, state, mcfg, Xd, yd, dd, bf)
    sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3
    loss_c, grads_c = variant_step(p_cpu, s_cpu, mcfg, X, y, draws, bf)
    loss_rel = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
    assert loss_rel <= BF16_LOSS_TOL, f"{name}: bf16 loss {loss_rel} apart"
    names = leaf_names(params)
    worst_max = max(zip(grad_errs(grads, grads_c), names))
    ref, bounds = bf16_limits(stages, grads_c, lambda: variant_step_f64(
        p_cpu, s_cpu, mcfg, X, y, draws, bf))
    dists = leaf_dists(grads, ref)
    limits = bounds(leaf_dists(grads_c, ref), BF16_MAX_TOL)
    worst = max(zip([d / m for d, m in zip(dists, limits)], dists, limits,
                    names))
    assert worst[0] <= 1, (
        f"{name}: the card's bf16 gradient {worst[3]} lies {worst[1]:.3e} "
        f"from the reference (bound {worst[2]:.3e})")
    infer = "infer" in stages
    with torch.inference_mode():
        w = seq2seq.decode_weights(params, bf)
        zero_all_counts()
        preds, n_steps = seq2seq.predict_greedy(params, state, mcfg, Xd,
                                                PARTIAL_STOP, w,
                                                compute_dtype=bf)
        sync(device)
        check_routing_bf16(f"{name}: bf16 greedy batch", stages, "greedy",
                           device)
        t0 = time.perf_counter()
        seq2seq.predict_greedy(params, state, mcfg, Xd, PARTIAL_STOP, w,
                               compute_dtype=bf)
        sync(device)
        greedy_rate = X.shape[0] / (time.perf_counter() - t0)
        zero_all_counts()
        beam_ops.make_beam_decoder(mcfg, N_BEAM, K_BEAM, PARTIAL_STOP,
                                   compute_dtype=bf)(params, state, Xd, w)
        sync(device)
        check_routing_bf16(f"{name}: bf16 beam batch", stages, "beam",
                           device)
        # the beam's per-step streams along the card's own path
        enc = seq2seq.encode(params, state, mcfg, Xd, w, bf)
        if infer and device.type == "cuda":
            tok, par, val, scores = fused_infer.beam_search_streams(
                enc[0].to(bf), enc[1], enc[2], w, N_BEAM, K_BEAM,
                PARTIAL_STOP)
        else:
            out = fused_infer.beam_reference(
                enc[0].to(bf) if infer else enc[0], enc[1], enc[2], w,
                N_BEAM, K_BEAM, PARTIAL_STOP, trace=True, step=None
                if infer else seq2seq.plain_step(params, mcfg,
                                                 compute_dtype=bf))
            scores, tok, par, val = out[1], out[3], out[4], out[5]
        enc = tuple(t.cpu() for t in enc)
        w_c = seq2seq.decode_weights(p_cpu, bf)
        enc_c = seq2seq.encode(p_cpu, s_cpu, mcfg, X, w_c, bf)
    ref, bounds = bf16_limits(stages, enc_c, lambda: encode_f64(
        p_cpu, s_cpu, mcfg, X))
    states = max_dist(enc, ref)
    states_tol = bounds([max_dist(enc_c, ref)], BF16_ENC_TOL)[0]
    assert states <= states_tol, (
        f"{name}: the card's bf16 encoder outputs lie {states:.3e} from the "
        f"reference (bound {states_tol:.3e})")
    # the decoder a stage at a time, on the card's encoder outputs: the
    # CPU's step (K5 / K6's plain bf16 step on the states rounded to bf16,
    # or the scan path's) follows the card's decodes; with no kernel stage
    # the float64-sum step follows them and the CPU's own
    on_enc = (enc[0].to(bf) if infer else enc[0], enc[1], enc[2])
    step = None if infer else seq2seq.plain_step(p_cpu, mcfg,
                                                 compute_dtype=bf)
    card_dec = (preds, n_steps, (tok, par, val, scores))
    with torch.inference_mode():
        if stages:
            errs = decode_follow_errs(on_enc, w_c, *card_dec, step)
            dec_tol = dict(BF16_DECODE_TOLS)
        else:
            cpu_dec = decode_on(on_enc, w_c, step)
            errs, cpu_errs = exact_follow(p_cpu, mcfg, on_enc,
                                          (card_dec, cpu_dec))
            dec_tol = {k: max(t, BF16_SPREAD * cpu_errs[k])
                       for k, t in BF16_DECODE_TOLS.items()}
    assert errs["path"] and all(errs[k] <= t for k, t in dec_tol.items()), (
        f"{name}: the card's bf16 decodes {errs}, bounds {dec_tol}")
    shown = ", ".join(f"{k} {errs[k]:.2e} ({t:.2e})"
                      for k, t in dec_tol.items())
    ref_name = ("the CPU's" if stages else "the float64-sum step's, "
                f"bound {BF16_SPREAD}x the CPU's distance or more")
    print(f"  {name} at bf16: kernels at {sorted(stages) or 'no stage'} "
          f"(bf16 entries only); train step loss {loss.item():.4f} "
          f"({loss_rel:.2e} from the CPU's); gradients from {ref_name}: "
          f"worst {worst[3]} {worst[1]:.2e} (bound {worst[2]:.2e}), "
          f"max-element {worst_max[0]:.2e} of max|CPU| ({worst_max[1]}); "
          f"encoder outputs {states:.2e} (bound {states_tol:.2e}); greedy "
          f"{int(n_steps)} steps and beam {N_BEAM},{K_BEAM} along the "
          f"card's path by {'the CPU' if stages else 'the float64-sum'} "
          f"step on its encoder outputs (bound): {shown}; {step_ms:.1f} ms a "
          f"train step, greedy {greedy_rate:.1f} utts/s ({smi})", flush=True)
    return step_ms, greedy_rate


def max_dist(got, want):
    """max |got - want| over the tensors of two tuples (the encoder
    states, h0, c0), each over the larger of 1 and its max |want| (the
    cell state c0 is not bounded by 1), on the CPU."""
    return max(float((g.cpu().double() - w.cpu().double()).abs().max())
               / max(1.0, float(w.abs().max())) for g, w in zip(got, want))


@contextlib.contextmanager
def float64_default():
    """Tensors made inside the block default to float64."""
    import torch

    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(torch.float32)


def decode_follow_errs(enc, w, preds, n_steps, beam, step):
    """A greedy decode ``preds`` and a beam search's streams ``beam`` (tok,
    par, val, scores), held along their own path by ``step`` on the
    encoder outputs ``enc`` (enc, h0, c0) on the CPU: {"greedy": the
    largest shortfall of a greedy token below the step's best logit,
    "path": the greedy run ended where the step's would, PAD after, and
    no beam step broke off, "topk", "selection", "score": beam_follow's}."""
    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.ops import fused_infer

    tok, par, val, scores = (t.cpu() for t in beam)
    short, n_run = fused_infer.greedy_follow(*enc, w, preds.cpu(), step)
    f_scores, topk, sel, bad = fused_infer.beam_follow(
        *enc, w, N_BEAM, K_BEAM, tok, par, val, step)
    return {"greedy": float(short.max()),
            "path": bool((preds.cpu()[:, n_run:] == SYMBOLS.PAD_ID).all())
            and n_run == int(n_steps) and not bool(bad.any()),
            "topk": float(topk.max()), "selection": float(sel.max()),
            "score": float((f_scores - scores.to(f_scores)).abs().max())}


def decode_on(enc, w, step):
    """The CPU's own greedy decode and beam search (streams) on the
    encoder outputs ``enc`` by ``step``: (preds, n_steps, (tok, par, val,
    scores)), as a card's decodes are given to :func:`decode_follow_errs`."""
    from ast_tpu_torch.ops import fused_infer

    preds = fused_infer.greedy_reference(*enc, w, PARTIAL_STOP, step)
    n_steps = fused_infer.greedy_follow(*enc, w, preds, step)[1]
    out = fused_infer.beam_reference(*enc, w, N_BEAM, K_BEAM, PARTIAL_STOP,
                                     trace=True, step=step)
    return preds, n_steps, (out[3], out[4], out[5], out[1])


def exact_follow(params, mcfg, enc, decodes):
    """:func:`decode_follow_errs` of each of ``decodes`` (preds, n_steps,
    streams) by a plain-stage model's bf16 step in float64 (its sums
    taken exactly) on the encoder outputs ``enc``, on the CPU."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.params import tree_map

    with float64_default():
        p64 = tree_map(lambda t: t.detach().cpu().double(), params)
        step = seq2seq.plain_step(p64, mcfg, compute_dtype=torch.bfloat16)
        enc64 = tuple(t.cpu().double() for t in enc)
        w = {"ctx_w": p64["attn"]["context"]["w"]}
        return [decode_follow_errs(enc64, w, *d, step) for d in decodes]


def encode_f64(params, state, mcfg, X):
    """A plain-stage model's bf16 encode in float64 with bf16's rounding
    points (the bf16 function with its sums taken exactly), on
    ``params``' device: (enc, h0, c0)."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.params import tree_map

    with float64_default(), torch.inference_mode():
        p64, s64 = (tree_map(lambda t: t.detach().double(), tree)
                    for tree in (params, state))
        return seq2seq.encode(
            p64, s64, mcfg, X.double() if X.is_floating_point() else X, None,
            torch.bfloat16)


def unidirectional_case(params, state, mcfg, nb, device):
    """(x0_proj, wx_rest, wh, b) of a bi_rnn: false encoder (D2 = 1) on
    ``nb`` rows of seeded features, from the model's own front-end."""
    import torch

    from ast_tpu_torch.models import seq2seq

    X = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (nb, FRAMES, 13)).astype(np.float32)).to(device)
    return seq2seq.encoder_inputs(params, state, mcfg, X)


def check_unidirectional_kernels(mcfg, device):
    """K1 eval, K1 train and K2 at D2 = 1 (bi_rnn: false, 512 units at
    es_en_20h width) against their plain versions: at B rows and T' =
    FRAMES / 4 within ENC_TOL (K2 BWD_TOL of max|plain|), masks equal to
    the hash's, REPEATS more calls bit-equal, again at ENC_PARTIAL's
    batches; the times, and for K1 eval one cuDNN torch.nn.LSTM of the
    same stack.  Returns the three kernels' numbers."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_lstm as fl

    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    with torch.no_grad():
        args = unidirectional_case(params, state, mcfg, B, device)
        T_enc, D2, _, H4 = args[0].shape
        assert D2 == 1 and H4 == 4 * mcfg["rnn_config"]["hidden_units"]
        err = check_encoder_partial(args)
        X = torch.from_numpy(np.random.default_rng(21).standard_normal(
            (B, FRAMES, 13)).astype(np.float32)).to(device)
        lstms, xs = cudnn_pair(params, state, mcfg, X)
        lib_err = cudnn_pair_err(lstms, xs, fl.fused_stacked_lstm(*args))
        print(f"  cuDNN torch.nn.LSTM of the same stack from the conv "
              f"output: max abs err {lib_err:.3e} against K1 at D2 = 1",
              flush=True)
        assert lib_err <= ENC_TOL, "the cuDNN LSTM computes another function"
        err1, err2 = check_encoder_train_partial(*args[:4])
        for nb, t_enc in ENC_PARTIAL:
            case = encoder_case(params, nb, t_enc, device)
            err = max(err, check_encoder_partial(case))
            e1, e2 = check_encoder_train_partial(*case)
            err1, err2 = max(err1, e1), max(err2, e2)
        dims = dict(T=T_enc, D2=1, B=B, H=H4 // 4, L=args[2].shape[0])
        seed = ENC_SEED
        targs = args[:4] + (seed, DROP)
        got = fl.fused_stacked_lstm_train(*targs)
        rng = np.random.default_rng(17)
        cot = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
            np.float32) * 0.1).to(device) for t in got[:3]]
        bwd = (got[3], got[4], args[1], args[2], *cot, seed, DROP)
        return {
            "k1_d1": dict(
                max_abs_err=err, dims=dims,
                ms=cuda_ms(lambda: fl.fused_stacked_lstm(*args), 5),
                plain_ms=cuda_ms(lambda: fl.stacked_lstm_reference(*args), 2),
                library_ms=cuda_ms(lambda: [m(x) for m, x in zip(lstms, xs)],
                                   5)),
            "k1t_d1": dict(
                max_abs_err=err1, dims=dims,
                ms=cuda_ms(lambda: fl.fused_stacked_lstm_train(*targs), 5),
                plain_ms=cuda_ms(lambda: fl.stacked_lstm_reference(
                    *args[:4], True, seed, DROP), 2)),
            "k2_d1": dict(
                max_abs_err=err2, dims=dims,
                ms=cuda_ms(lambda: fl.encoder_backward(*bwd), 5),
                plain_ms=cuda_ms(lambda: fl.encoder_backward_reference(*bwd),
                                 2)),
        }


def check_wide_beam(mcfg, device, N=40, K=2, nb=2):
    """A beam wider than K6 takes (``cli.beam -n 40``) on es_en_20h's
    model: routed to the plain frontier loop (K1 eval launched, K6 not),
    each utterance's best hypothesis's score that of the plain step run
    along its tokens on the CPU, within SCORE_TOL."""
    import torch

    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import beam as beam_ops
    from ast_tpu_torch.ops import fused_infer
    from ast_tpu_torch.params import tree_map

    X = variant_inputs(mcfg, device)[0][:nb]
    t_enc = FRAMES // 4
    assert not seq2seq.use_fused_infer(mcfg, device, nb, t_enc, N, K)
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    decode = beam_ops.make_beam_decoder(mcfg, N, K, PARTIAL_STOP)
    zero_counts()
    with torch.inference_mode():
        hyps, scores, lengths = decode(params, state, X.to(device))
    check_launched(f"beam N={N}", counts(), ("k1",))
    cpu = torch.device("cpu")
    p_cpu, s_cpu = (tree_map(lambda t: t.detach().to(cpu), tree)
                    for tree in (params, state))
    assert hyps.shape == (nb, N, PARTIAL_STOP + 1)
    err = 0.0
    with torch.inference_mode():
        w = seq2seq.decode_weights(p_cpu)
        enc, h0, c0 = seq2seq.encode(p_cpu, s_cpu, mcfg, X, w)
        for r in range(nb):
            ids = hyps[r, 0, :int(lengths[r, 0])].tolist()
            assert ids[0] == SYMBOLS.GO_ID, ids[:3]
            h, c = h0[:, r:r + 1], c0[:, r:r + 1]
            ht = enc.new_zeros((1, w["ctx_w"].shape[1]))
            total = 0.0
            for prev, t in zip(ids[:-1], ids[1:]):
                logits, h, c, ht, _ = fused_infer.decode_step_reference(
                    w, enc[r:r + 1], h, c, ht, torch.tensor([prev]))
                total += float(torch.log_softmax(logits, -1)[0, t])
            err = max(err, abs(total - float(scores[r, 0])))
    assert err <= SCORE_TOL, f"beam N={N}: best scores {err} off the path"
    print(f"  beam {N},{K} at {nb} utterances (cli.beam -n {N}): the plain "
          f"frontier loop on the card (K1 eval launched, K6 not), each best "
          f"hypothesis's score within {err:.2e} of the plain step along its "
          f"tokens on the CPU", flush=True)


def variant_experiment(root, train_exp, name, edits):
    """An experiment over phase 6's data with es_en_20h's train_cfg and
    its model_cfg under ``edits`` (variant names)."""
    from ast_tpu_torch import Config

    exp = os.path.join(root, name)
    os.makedirs(exp)
    es_en = os.path.join(REPO, "experiments", "es_en_20h")
    with open(os.path.join(es_en, "train_cfg.json")) as f:
        tcfg = json.load(f)
    tcfg["data"].update({k: Config(train_exp).train["data"][k] for k in (
        "speech_path", "map_path", "vocab_path", "info_path", "refs_path")})
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(tcfg, f)
    with open(os.path.join(es_en, "model_cfg.json")) as f:
        mcfg = json.load(f)
    for e in edits:
        mcfg = variant_cfg(mcfg, e)
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(mcfg, f)
    return exp


def train_variant_cli(exp, smi, device):
    """cli.train -e 2 on a variant experiment: two falling train.log
    rows, two dev.log rows; the launch counts."""
    from ast_tpu_torch.cli import train

    zero_counts()
    t0 = time.perf_counter()
    quiet(train.main, ["-m", exp, "-e", "2", "--device", device])
    dt = time.perf_counter() - t0
    n = counts()
    with open(os.path.join(exp, "train.log")) as f:
        losses = [float(line.split(", ")[1]) for line in f]
    with open(os.path.join(exp, "dev.log")) as f:
        bleus = [line.strip() for line in f]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert losses[1] < losses[0], f"{exp}: the loss did not fall: {losses}"
    assert len(bleus) == 2, bleus
    print(f"  cli.train -e 2 on {os.path.basename(exp)} ({N_TRAIN} train / "
          f"{N_DEV} dev utts, {dt:.1f} s, {smi}): train.log {losses}, "
          f"dev.log {bleus}; launches {n}", flush=True)
    return n


def run_variants(root, train_exp, smi, device="cuda"):
    """Phase 12: the model variants ast_tpu runs on its scan path, at
    es_en_20h width (es_en_20h's model_cfg from ``train_exp``): per
    variant run_variant; K1 eval, K1 train and K2 at D2 = 1 against their
    plain versions; cli.train -e 2 on two variant experiments over phase
    6's data, cli.beam --save-attn, and export + serve of a linear_proj
    model.  Returns (the D2 = 1 kernels' numbers, their launches on the
    variant experiments' main path, the train steps and decoded batches
    they ran in)."""
    import torch

    from ast_tpu_torch import SYMBOLS, Config
    from ast_tpu_torch.checkpoint import save_checkpoint
    from ast_tpu_torch.cli import beam, export_model
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.train.trainer import NN, to_numpy

    t_phase = time.perf_counter()
    dev_name, device = device, torch.device(device)
    base = Config(train_exp).model
    print(f"phase 12: the model variants at es_en_20h width, B="
          f"{VARIANT_ROWS} rows of {FRAMES} frames (T' {FRAMES // 4}), "
          f"U={U_TRAIN}, decodes to {PARTIAL_STOP} steps ({smi})", flush=True)
    timing = {"default": run_variant("default", base, device, smi)}
    for name in VARIANT_STAGES:
        timing[name] = run_variant(name, base, device, smi)
    print(f"  f32 pass: {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_bf16 = time.perf_counter()
    timing_bf16 = {name: run_variant_bf16(name, base, device, smi)
                   for name in timing}
    print(f"  bf16 pass: {time.perf_counter() - t_bf16:.1f} s", flush=True)
    check_wide_beam(base, device)
    results = check_unidirectional_kernels(
        variant_cfg(base, "bi_rnn false"), device)

    plain_exp = variant_experiment(root, train_exp, "variant_ln_relu",
                                   ("ln", "rnn_relu"))
    n = train_variant_cli(plain_exp, smi, dev_name)
    check_launched("cli.train, ln + rnn_relu", n, ())
    mixed = variant_experiment(root, train_exp, "variant_uni_out_heads",
                               ("bi_rnn false", "dropout.out 0.3",
                                "n_attn 2"))
    # every decoded batch is encoded once (its K1 eval launch)
    with counting(NN, "train_step") as steps, \
            counting(seq2seq, "encode") as dev_batches:
        n = train_variant_cli(mixed, smi, dev_name)
    check_launched("cli.train, bi_rnn false + dropout.out + n_attn 2", n,
                   ("k1t", "k2", "k1"))
    launches = {"k1t_d1": n["k1t"], "k2_d1": n["k2"], "k1_d1": n["k1"]}
    units = {"k1t_d1": steps[0], "k2_d1": steps[0]}

    dev = Config(mixed).train["dev_set"]
    zero_counts()
    with counting(seq2seq, "encode") as beam_batches:
        quiet(beam.main, ["-m", mixed, "-n", str(N_BEAM), "-k", str(K_BEAM),
                          "-w", "0.6", "-s", dev, "--save-attn", "--device",
                          dev_name])
    n = counts()
    check_launched("cli.beam --save-attn", n, ("k1",))
    launches["k1_d1"] += n["k1"]
    with open(os.path.join(mixed, f"{dev}_beam_N-{N_BEAM}_K-{K_BEAM}.p"),
              "rb") as f:
        beams = pickle.load(f)
    assert len(beams) == N_DEV
    worst = 0.0
    for utt, entries in beams.items():
        assert len(entries) == N_BEAM, utt
        for ids, score, attn in entries:
            assert ids[0] == SYMBOLS.GO_ID and np.isfinite(score), utt
            assert attn.ndim == 2 and attn.shape[0] == len(ids), attn.shape
            assert not attn[0].any(), "the GO row holds attention"
            worst = max(worst, float(np.abs(attn[1:].sum(axis=1) - 1).max()))
    assert worst <= 1e-5, f"an attention row sums to 1 +- {worst}"
    print(f"  cli.beam --save-attn on {os.path.basename(mixed)}: {N_DEV} "
          f"utterances x {N_BEAM} hypotheses, each with its history (len, "
          f"T'), the GO row 0 and every other row summing to 1 within "
          f"{worst:.2e}; launches K1 eval {n['k1']}, K6 {n['k6']}",
          flush=True)
    units["k1_d1"] = dev_batches[0] + beam_batches[0]

    proj_exp = variant_experiment(root, train_exp, "variant_linear_proj",
                                  ("linear_proj",))
    mcfg = Config(proj_exp).model
    params, state = seq2seq.init_model(mcfg, seed=3, device=device)
    save_checkpoint(os.path.join(proj_exp, "seq2seq_1.model.npz"),
                    to_numpy(params), to_numpy(state))
    serving_dir = os.path.join(root, "serving_linear_proj")
    quiet(export_model.main, ["-m", proj_exp, "-o", serving_dir, "--batch",
                              str(VARIANT_ROWS), "--frames", str(FRAMES)])
    speech = Config(proj_exp).train["data"]["speech_path"]
    x = next(a for a in (np.load(os.path.join(speech, dev, f))
                         for f in sorted(os.listdir(os.path.join(speech,
                                                                 dev))))
             if len(a) <= FRAMES)
    # row 0 of a call at the entry's batch, as the server runs it
    X = np.zeros((VARIANT_ROWS, FRAMES, 13), np.float32)
    X[0, :len(x)] = x
    with open(os.path.join(serving_dir, "manifest.json")) as f:
        stop = int(json.load(f)["stop_limit"])
    with torch.inference_mode():
        pred = seq2seq.predict_greedy(params, state, mcfg,
                                      torch.from_numpy(X).to(device),
                                      stop)[0][0].cpu().numpy()
    eos = np.nonzero(pred == SYMBOLS.EOS_ID)[0]
    want = (pred[:eos[0]] if eos.size else pred).tolist()
    proc, base_url, warm_s = start_server(
        serving_dir, os.path.join(root, "serve_linear_proj.log"),
        device=dev_name)
    try:
        before = http_get(base_url + "/stats")["kernel_launches"]
        status, reply = http_post(base_url + "/decode?mode=greedy", x)
        after = http_get(base_url + "/stats")["kernel_launches"]
    finally:
        rc = stop_server(proc)
    assert status == 200 and reply["ids"] == want, (status, reply, want)
    check_launched("cli.serve, linear_proj", {
        k: after[k] - before[k] for k in KERNEL_KEYS}, ("k5",))
    assert rc == 0, rc
    print(f"  export_model + cli.serve of a linear_proj model: ready after "
          f"{warm_s:.1f} s; one greedy request's ids equal the in-process "
          f"decode ({len(want)} tokens), the server launched K5 and no K1 "
          f"(its encoder is plain)", flush=True)
    run_variants_bf16_clis(root, train_exp, proj_exp, smi, dev_name)
    print(f"  ms a train step | greedy utts/s, B={VARIANT_ROWS}, f32 / bf16 "
          f"({smi}): " + "; ".join(
              f"{k} {v[0]:.1f} / {timing_bf16[k][0]:.1f} | {v[1]:.1f} / "
              f"{timing_bf16[k][1]:.1f}" for k, v in timing.items()),
          flush=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results, launches, units


def set_compute_dtype(exp, dtype):
    """``extras.compute_dtype`` of ``exp``'s train_cfg.json."""
    path = os.path.join(exp, "train_cfg.json")
    with open(path) as f:
        tcfg = json.load(f)
    tcfg.setdefault("extras", {})["compute_dtype"] = dtype
    with open(path, "w") as f:
        json.dump(tcfg, f)


def run_variants_bf16_clis(root, train_exp, proj_exp, smi, device):
    """Phase 12's entry points at compute_dtype bfloat16: cli.train -e 1
    on an ln + rnn_relu experiment (every stage on the scan path: no
    kernel launched), cli.beam --save-attn on it, and export_model
    --dtype bfloat16 + cli.serve of phase 12's linear_proj model (its
    encoder plain, K5 at bf16): one greedy request's ids equal to the
    in-process bf16 decode of the same row at the entry's batch."""
    import torch

    from ast_tpu_torch import SYMBOLS, Config
    from ast_tpu_torch.checkpoint import load_checkpoint
    from ast_tpu_torch.cli import beam, export_model, train
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.params import from_jax_numpy

    exp = variant_experiment(root, train_exp, "variant_ln_relu_bf16",
                             ("ln", "rnn_relu"))
    set_compute_dtype(exp, "bfloat16")
    zero_all_counts()
    t0 = time.perf_counter()
    quiet(train.main, ["-m", exp, "-e", "1", "--device", device])
    dt = time.perf_counter() - t0
    with open(os.path.join(exp, "train.log")) as f:
        losses = [float(line.split(", ")[1]) for line in f]
    with open(os.path.join(exp, "dev.log")) as f:
        bleus = [line.strip() for line in f]
    assert len(losses) == 1 and np.isfinite(losses[0]), losses
    assert len(bleus) == 1, bleus
    check_routing_bf16("cli.train at bf16, ln + rnn_relu", set(), "train",
                       device)
    dev = Config(exp).train["dev_set"]
    zero_all_counts()
    quiet(beam.main, ["-m", exp, "-n", str(N_BEAM), "-k", str(K_BEAM),
                      "-w", "0.6", "-s", dev, "--save-attn", "--device",
                      device])
    check_routing_bf16("cli.beam --save-attn at bf16", set(), "beam",
                       device)
    with open(os.path.join(exp, f"{dev}_beam_N-{N_BEAM}_K-{K_BEAM}.p"),
              "rb") as f:
        beams = pickle.load(f)
    assert len(beams) == N_DEV
    worst = 0.0
    for utt, entries in beams.items():
        assert len(entries) == N_BEAM, utt
        for ids, score, attn in entries:
            assert ids[0] == SYMBOLS.GO_ID and np.isfinite(score), utt
            assert attn.ndim == 2 and attn.shape[0] == len(ids), attn.shape
            assert not attn[0].any(), "the GO row holds attention"
            worst = max(worst, float(np.abs(attn[1:].sum(axis=1) - 1).max()))
    assert worst <= 1e-5, f"a bf16 attention row sums to 1 +- {worst}"
    print(f"  cli.train -e 1 at bf16 on {os.path.basename(exp)} ({dt:.1f} "
          f"s, {smi}): train.log {losses}, dev.log {bleus}, no kernel "
          f"launched; cli.beam --save-attn at bf16: {N_DEV} utterances x "
          f"{N_BEAM} hypotheses with histories, rows summing to 1 within "
          f"{worst:.2e}", flush=True)

    mcfg = Config(proj_exp).model
    dev_t = torch.device(device)
    snap = load_checkpoint(os.path.join(proj_exp, "seq2seq_1.model.npz"))
    params, state = from_jax_numpy(snap["params"], snap["state"], dev_t)
    serving_dir = os.path.join(root, "serving_linear_proj_bf16")
    quiet(export_model.main, ["-m", proj_exp, "-o", serving_dir, "--batch",
                              str(VARIANT_ROWS), "--frames", str(FRAMES),
                              "--dtype", "bfloat16"])
    with open(os.path.join(serving_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["compute_dtype"] == "bfloat16", manifest
    speech = Config(proj_exp).train["data"]["speech_path"]
    x = next(a for a in (np.load(os.path.join(speech, dev, f))
                         for f in sorted(os.listdir(os.path.join(speech,
                                                                 dev))))
             if len(a) <= FRAMES)
    # row 0 of a call at the entry's batch, as the server runs it
    X = np.zeros((VARIANT_ROWS, FRAMES, 13), np.float32)
    X[0, :len(x)] = x
    with torch.inference_mode():
        pred = seq2seq.predict_greedy(
            params, state, mcfg, torch.from_numpy(X).to(dev_t),
            int(manifest["stop_limit"]),
            compute_dtype=torch.bfloat16)[0][0].cpu().numpy()
    eos = np.nonzero(pred == SYMBOLS.EOS_ID)[0]
    want = (pred[:eos[0]] if eos.size else pred).tolist()
    proc, base_url, warm_s = start_server(
        serving_dir, os.path.join(root, "serve_linear_proj_bf16.log"),
        device=device)
    try:
        before = http_get(base_url + "/stats")["kernel_launches"]
        status, reply = http_post(base_url + "/decode?mode=greedy", x)
        after = http_get(base_url + "/stats")["kernel_launches"]
    finally:
        rc = stop_server(proc)
    assert status == 200 and reply["ids"] == want, (status, reply, want)
    moved = {k: after[k] - before[k] for k in after}
    check_launched("cli.serve at bf16, linear_proj", moved,
                   ("k5_bf16",) if dev_t.type == "cuda" else ())
    assert rc == 0, rc
    print(f"  export_model --dtype bfloat16 + cli.serve of the linear_proj "
          f"model: ready after {warm_s:.1f} s; one greedy request's ids "
          f"equal the in-process bf16 decode ({len(want)} tokens); the "
          f"server launched {moved}", flush=True)


# kernel-name fragments -> group, first match wins
KERNEL_GROUPS = (("cell_bwd_kernel", "encoder cell backward"),
                 ("EncCell", "encoder cell waves"),
                 ("wave_kernel", "encoder backward product waves"),
                 ("prod_train_kernel", "decoder cell product"),
                 ("prod_bwd_kernel", "decoder backward products"),
                 ("prod_kernel", "decoder linear products"),
                 ("attention", "attention"),
                 ("select_embed", "small step kernels"),
                 ("argmax", "small step kernels"),
                 ("head_kernel", "small step kernels"),
                 ("foreach", "optimizer (foreach)"),
                 ("gemm", "cuBLAS GEMM"), ("sm90", "cuBLAS GEMM"),
                 ("cutlass", "cuBLAS GEMM"))


def step_profile(nn, batch, reps):
    """``reps`` train steps under torch.profiler: (wall ms a step, device
    busy ms a step -- the union of kernel intervals --, [(kernel group,
    busy ms a step)] largest first).  The decoder's kernels are
    programmatic dependent launches, whose spans start while the kernel
    before them runs: a kernel counts for the part of its span past the
    end of every span that started before it, so the groups add up to
    the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    nn.train_step(batch, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            nn.train_step(batch, 1 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    busy, groups = device_busy(prof)
    return (wall, busy / reps,
            sorted(((g, ms / reps) for g, ms in groups.items()),
                   key=lambda kv: -kv[1]))


def device_busy(prof):
    """(device busy ms, {kernel group: busy ms}) of a torch.profiler
    trace: the union of the device spans, each kernel counted for the part
    of its span past the end of every span that started before it."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end, groups = 0.0, -np.inf, {}
    for a, b, name in spans:
        own = max(0.0, b - max(a, end))
        busy += own
        end = max(end, b)
        g = next((g for k, g in KERNEL_GROUPS if k in name), "other torch")
        groups[g] = groups.get(g, 0.0) + own / 1e3
    return busy / 1e3, groups


# ---------------------------------------------------------------------------
# phase 13: bfloat16 decoding (extras.compute_dtype: "bfloat16")
# ---------------------------------------------------------------------------

# K1 eval, K5 and K6 at bf16 against their plain bf16 versions on the
# card.  Both round the same values to bf16 at the same points and sum in
# f32, in another order: a value that falls within an f32 rounding of a
# bf16 boundary rounds one bf16 ulp (2**-8 of it) apart in the two, and
# the recurrences carry such steps on, so the two part by bf16's
# precision, not f32's.  The bounds: encoder states (|h| < 1) within
# BF16_ENC_TOL, one bf16 ulp at 1; a kernel token within BF16_TOK_TOL of
# the plain step's best logit along the kernel's own tokens (logits of a
# few units: a bf16 ulp of 4 is 1.6e-2); beam scores (sums of up to 175
# log-probs) within BF16_SCORE_TOL.  (Measured on the H100: 4.4e-4,
# 4.8e-4 and 9.4e-3 at B = 32.)
BF16_ENC_TOL, BF16_TOK_TOL, BF16_SCORE_TOL = 3.9e-3, 1e-2, 5e-2
# phase 12's bf16 pass: decode_follow_errs' readings and their bounds
BF16_DECODE_TOLS = {"greedy": BF16_TOK_TOL, "topk": BF16_TOK_TOL,
                    "selection": BF16_SCORE_TOL, "score": BF16_SCORE_TOL}
# (utterances, T') of the bf16 partial-batch checks: PARTIAL's, so the
# tensor-core products meet every row tiling of launch_prod (greedy R =
# 5, 11, 20, 64; beam R = 25, 55, 100, 320 in two 256-row chunks)
BF16_PARTIAL = PARTIAL


def profiled_spans(fn):
    """One call of ``fn`` under torch.profiler after a warm-up call: its
    device spans, [(start µs, end µs, kernel name)]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert spans, "torch.profiler saw no kernel on the card"
    return spans


def decode_split(fn, layers):
    """One call of ``fn`` (a K5 or K6 decode) under torch.profiler after
    a warm-up call: {part: device ms} by kernel -- the L cells and the q,
    ctx and logits linears told apart by their place in the step (the
    product launches before attention are the cells, then q; after it
    ctx, then logits), attention, the argmax or beam step, the rest
    (torch ops, K6's backtrack) -- each kernel counted for the part of
    its span past the end of every span that started before it (the
    launches are programmatic dependent launches), and the launch gaps:
    first start to last end less the busy time."""
    return split_spans(profiled_spans(fn), layers)


def split_spans(spans, layers):
    """decode_split's parts of (start µs, end µs, kernel name) spans."""
    spans = sorted(spans)
    parts = dict.fromkeys(("cells", "q", "ctx", "logits", "attention",
                           "selection", "other"), 0.0)
    end, busy, pre, post = -np.inf, 0.0, 0, None
    for a, b, name in spans:
        own = max(0.0, b - max(a, end)) / 1e3
        busy += own
        end = max(end, b)
        if "prod_kernel" in name:
            if post is None:
                part = "cells" if pre < layers else "q"
                pre += 1
            else:
                part = "ctx" if post == 0 else "logits"
                post += 1
        elif "attention" in name:
            part, post = "attention", 0
        elif "argmax" in name or "beam_step" in name:
            part, pre, post = "selection", 0, None
        else:
            part = "other"
        parts[part] += own
    parts["launch gaps"] = (end - spans[0][0]) / 1e3 - busy
    return parts


# the parts of a K3 or K4 call (train_split)
TRAIN_PARTS = ("train cells", "linears", "d_top", "layer backward",
               "attention", "select / head", "other")


def train_split(fn):
    """One call of ``fn`` (a K3 or K4 call) under torch.profiler after a
    warm-up call: {part: device ms} by launch kind (train_split_spans)."""
    return train_split_spans(profiled_spans(fn))


def train_split_spans(spans):
    """train_split's parts of (start µs, end µs, kernel name) spans: K3's
    train cells (the cell products with the train epilogue), the linears
    (K3's q, ctx and logits, K4's d_cv), K4's d_top (the first backward
    product after each attention backward) and its layer backward
    products, attention and its backward, select_embed / head, the rest
    (the wrappers' packs and fills), each kernel counted for the part of
    its span past the end of every span that started before it, and the
    launch gaps: first start to last end less the busy time."""
    spans = sorted(spans)
    parts = dict.fromkeys(TRAIN_PARTS, 0.0)
    end, busy, after_attn = -np.inf, 0.0, False
    for a, b, name in spans:
        own = max(0.0, b - max(a, end)) / 1e3
        busy += own
        end = max(end, b)
        if "prod_train_kernel" in name:
            part = "train cells"
        elif "prod_bwd_kernel" in name:
            part = "d_top" if after_attn else "layer backward"
            after_attn = False
        elif "prod_kernel" in name:
            part = "linears"
        elif "attention" in name:
            part, after_attn = "attention", True
        elif "select_embed" in name or "head_kernel" in name:
            part = "select / head"
        else:
            part = "other"
        parts[part] += own
    parts["launch gaps"] = (end - spans[0][0]) / 1e3 - busy
    return parts


def show_split(parts):
    return ", ".join(f"{k} {v:.3f}" for k, v in parts.items())


def bf16_counters():
    """The bf16 entries' launch counts by their key in the kernels line."""
    from ast_tpu_torch.ops import fused_infer, fused_lstm as fl

    return {"k1_bf16": fl.fused_stacked_lstm.launches_bf16,
            "k5_bf16": fused_infer.greedy_decode_fused.launches_bf16,
            "k6_bf16": fused_infer.beam_search_streams.launches_bf16}


def zero_bf16_counts():
    from ast_tpu_torch.ops import fused_infer, fused_lstm as fl

    for fn in (fl.fused_stacked_lstm, fused_infer.greedy_decode_fused,
               fused_infer.beam_search_streams):
        fn.launches_bf16 = 0


def check_bf16_encoder(args, name):
    """K1 eval at bf16 on ``args`` (x0_proj, bf16 wx_rest, bf16 wh, b[,
    packed]) against its plain version within BF16_ENC_TOL and bit-equal
    over REPEATS more calls; returns the max abs err."""
    from ast_tpu_torch.ops import fused_lstm

    got = fused_lstm.fused_stacked_lstm(*args)
    ref = fused_lstm.stacked_lstm_reference(*args[:4])
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    assert err <= BF16_ENC_TOL, f"K1 bf16 disagrees, {name}: {err}"
    check_repeats(lambda: fused_lstm.fused_stacked_lstm(*args), got,
                  f"K1 bf16, {name}")
    return err


def check_bf16_kernels(cfg, device):
    """Phase 13, kernels: K1 eval, K5 and K6 at bf16 against their plain
    bf16 versions at es_en_20h width (phase 3's model and batch), at
    BF16_PARTIAL's batches too (K1 at ENC_PARTIAL's, ENC_EVAL_PARTIAL's
    and TRAIN_WIDE's, and on DEEP_ENCODER's stack), REPEATS more calls
    bit-equal, each timed beside its f32 mode in the same call, and K1
    beside two cuDNN torch.nn.LSTM in bf16."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_infer, fused_lstm

    bf = torch.bfloat16
    mcfg = cfg.model
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, FRAMES, 13)).astype(np.float32)).to(device)
    w, w32 = seq2seq.decode_weights(params, bf), seq2seq.decode_weights(params)
    enc_in = seq2seq.encoder_inputs(params, state, mcfg, X, enc_w=w["enc"],
                                    compute_dtype=bf)
    enc_in32 = seq2seq.encoder_inputs(params, state, mcfg, X,
                                      enc_w=w32["enc"])
    assert enc_in[1].dtype == enc_in[4].dtype == bf
    err = check_bf16_encoder(enc_in, f"{B} rows")
    print(f"K1 encoder bf16: x0_proj {tuple(enc_in[0].shape)}, max abs err "
          f"{err:.3e} against its plain bf16 version (tol {BF16_ENC_TOL}), "
          f"{REPEATS} more calls bit-equal", flush=True)
    # every row tiling of the tensor-core waves (16 to 256 rows), T' below
    # L + 1 and odd, and a stack whose full waves take two launches
    for name, args in bf16_encoder_cases(
            params, ENC_PARTIAL + ENC_EVAL_PARTIAL + TRAIN_WIDE, device):
        e = check_bf16_encoder(args, name)
        err = max(err, e)
        print(f"  K1 bf16 at {name}: max abs err {e:.3e}", flush=True)
    lib_ms, lib_note = None, ""
    try:
        lstms, xs = cudnn_pair(params, state, mcfg, X, bf)
        lib_ms = cuda_ms(lambda: [m(x) for m, x in zip(lstms, xs)], 5)
    except RuntimeError as e:         # cuDNN without a bf16 LSTM
        lib_note = f" (cuDNN LSTM in bf16 refused: {e})"
    T_enc, D2, _, H4e = enc_in[0].shape
    res = {"k1_bf16": dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fused_lstm.fused_stacked_lstm(*enc_in), 5),
        f32_ms=cuda_ms(lambda: fused_lstm.fused_stacked_lstm(*enc_in32), 5),
        plain_ms=cuda_ms(
            lambda: fused_lstm.stacked_lstm_reference(*enc_in[:4]), 2),
        library_ms=lib_ms,
        dims=dict(T=T_enc, D2=D2, B=B, H=H4e // 4, L=enc_in[2].shape[0],
                  wbytes=2))}
    print(f"  K1 bf16 {res['k1_bf16']['ms']:.3f} ms, f32 "
          f"{res['k1_bf16']['f32_ms']:.3f} ms (same call); two cuDNN "
          f"nn.LSTM in bf16 "
          + (f"{lib_ms:.3f} ms" if lib_ms is not None else "none")
          + lib_note, flush=True)

    out = fused_lstm.stacked_lstm_reference(*enc_in[:4])
    enc32, h0, c0 = seq2seq.encoder_outputs(*out)
    enc = enc32.to(bf)
    _, g = check_greedy(enc, h0, c0, w, STOP, BF16_TOK_TOL)
    _, bm = check_beam(enc, h0, c0, w, STOP, BF16_TOK_TOL, BF16_SCORE_TOL)
    check_repeats(lambda: fused_infer.greedy_decode_fused(enc, h0, c0, w,
                                                          STOP),
                  fused_infer.greedy_decode_fused(enc, h0, c0, w, STOP),
                  "K5 bf16")
    first = fused_infer.beam_search_streams(enc, h0, c0, w, N_BEAM, K_BEAM,
                                            STOP)
    check_repeats(lambda: fused_infer.beam_search_streams(
        enc, h0, c0, w, N_BEAM, K_BEAM, STOP), first, "K6 bf16")
    print(f"K5 greedy bf16: {B} rows, {g['steps']} of {STOP} steps, "
          f"{g['rows_equal']} rows equal to the free-running plain bf16 "
          f"decode, every token within {g['shortfall']:.3e} of the plain "
          f"step's best logit (tol {BF16_TOK_TOL}); K6 beam bf16 "
          f"{N_BEAM},{K_BEAM}: {bm['utts_equal']} utterances equal "
          f"free-running, top-K shortfall {bm['topk_short']:.3e}, selection "
          f"{bm['sel_err']:.3e}, score {bm['score_err']:.3e} (tol "
          f"{BF16_SCORE_TOL}); {REPEATS} more calls of each bit-equal",
          flush=True)
    dec_dims = dict(B=B, T=enc.shape[1], H=enc.shape[2], L=h0.shape[0],
                    E=w["embed"].shape[1], A=w["ctx_w"].shape[1],
                    V=w["embed"].shape[0], stop=STOP, wbytes=2)
    enc32c = enc32.contiguous()
    res["k5_bf16"] = dict(
        max_abs_err=g["shortfall"], rows_equal=g["rows_equal"],
        ms=cuda_ms(lambda: fused_infer.greedy_decode_fused(
            enc, h0, c0, w, STOP), 3),
        f32_ms=cuda_ms(lambda: fused_infer.greedy_decode_fused(
            enc32c, h0, c0, w32, STOP), 3),
        plain_ms=cuda_ms(lambda: fused_infer.greedy_reference(
            enc, h0, c0, w, STOP), 1),
        dims=dict(dec_dims, n=g["steps"]))
    res["k6_bf16"] = dict(
        max_abs_err=bm["score_err"], utts_equal=bm["utts_equal"],
        ms=cuda_ms(lambda: fused_infer.beam_decode_fused(
            enc, h0, c0, w, N_BEAM, K_BEAM, STOP), 3),
        f32_ms=cuda_ms(lambda: fused_infer.beam_decode_fused(
            enc32c, h0, c0, w32, N_BEAM, K_BEAM, STOP), 3),
        plain_ms=cuda_ms(lambda: fused_infer.beam_reference(
            enc, h0, c0, w, N_BEAM, K_BEAM, STOP), 1),
        dims=dict(dec_dims, n=bm["steps"], N=N_BEAM))
    for nb, t_enc in BF16_PARTIAL:
        Xp = torch.from_numpy(np.random.default_rng(nb).standard_normal(
            (nb, 4 * t_enc, 13)).astype(np.float32)).to(device)
        e32, ph0, pc0 = seq2seq.encode(params, state, mcfg, Xp, w, bf)
        pe = e32.to(bf)
        ptok, pg = check_greedy(pe, ph0, pc0, w, PARTIAL_STOP, BF16_TOK_TOL)
        _, pb = check_beam(pe, ph0, pc0, w, PARTIAL_STOP, BF16_TOK_TOL,
                           BF16_SCORE_TOL)
        res["k5_bf16"]["max_abs_err"] = max(res["k5_bf16"]["max_abs_err"],
                                            pg["shortfall"])
        res["k6_bf16"]["max_abs_err"] = max(res["k6_bf16"]["max_abs_err"],
                                            pb["score_err"])
        check_repeats(lambda: fused_infer.greedy_decode_fused(
            pe, ph0, pc0, w, PARTIAL_STOP), ptok, f"K5 bf16, {nb} utterances")
        check_repeats(lambda: fused_infer.beam_search_streams(
            pe, ph0, pc0, w, N_BEAM, K_BEAM, PARTIAL_STOP),
            fused_infer.beam_search_streams(pe, ph0, pc0, w, N_BEAM, K_BEAM,
                                            PARTIAL_STOP),
            f"K6 bf16, {nb} utterances")
        print(f"  K5 / K6 bf16 partial batch of {nb} utterances (greedy "
              f"{nb} rows, beam {nb * N_BEAM}), T' {t_enc}: greedy "
              f"shortfall {pg['shortfall']:.3e}, beam top-K "
              f"{pb['topk_short']:.3e}, score {pb['score_err']:.3e}; "
              f"{REPEATS} more calls of each bit-equal", flush=True)
    L = h0.shape[0]
    for key, fn in (
            ("k5_bf16", lambda: fused_infer.greedy_decode_fused(
                enc, h0, c0, w, STOP)),
            ("k6_bf16", lambda: fused_infer.beam_decode_fused(
                enc, h0, c0, w, N_BEAM, K_BEAM, STOP))):
        split = decode_split(fn, L)
        print(f"  {key} split by kernel (torch.profiler, device ms of one "
              f"call, {B} utterances): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    for key in ("k1_bf16", "k5_bf16", "k6_bf16"):
        r = res[key]
        print(f"  {key}: {r['ms']:.3f} ms at bf16, {r['f32_ms']:.3f} ms at "
              f"f32 ({r['ms'] / r['f32_ms']:.3f} of it), plain bf16 "
              f"{r['plain_ms']:.2f} ms", flush=True)
    return res


def bf16_experiment(exp, root):
    """Phase 4's experiment with extras.compute_dtype "bfloat16": its
    configs and checkpoint in a directory of its own."""
    bexp = os.path.join(root, "exp_bf16")
    os.makedirs(bexp)
    for f in ("model_cfg.json", "train_cfg.json", "seq2seq_1.model.npz"):
        shutil.copy(os.path.join(exp, f), bexp)
    edit_train_cfg(bexp, lambda c: c.setdefault("extras", {}).update(
        compute_dtype="bfloat16"))
    return bexp


def run_bf16_serving(exp, paths, root, smi, device="cuda"):
    """Phase 13, the entry points: cli.infer at bf16 on phase 4's 64
    files, greedy and beam (utts/s beside f32 in the same phase, the
    share of utterances whose text equals the f32 decode, the bf16
    kernels' launches), then export_model --dtype bfloat16 and cli.serve:
    one greedy and one beam request whose ids equal the in-process bf16
    decode.  Returns the launches and served batches of the infer runs."""
    import torch

    from ast_tpu_torch import Config, SYMBOLS
    from ast_tpu_torch.checkpoint import load_checkpoint
    from ast_tpu_torch.cli import export_model, infer
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import beam as beam_ops
    from ast_tpu_torch.params import from_jax_numpy

    bexp = bf16_experiment(exp, root)
    texts, rates, batches = {}, {}, {}
    for dt, e in (("float32", exp), ("bfloat16", bexp)):
        for name, extra in (("greedy", []),
                            ("beam", ["--beam", f"{N_BEAM},{K_BEAM}"])):
            if dt == "bfloat16" and name == "greedy":
                zero_bf16_counts()      # the bf16 main path starts here
            sync(device)
            t0 = time.perf_counter()
            with counting(seq2seq, "encode") as calls:
                texts[dt, name], _ = quiet(infer.main, [
                    "-m", e, "--device", device] + extra + paths)
            sync(device)
            rates[dt, name] = len(paths) / (time.perf_counter() - t0)
            batches[dt, name] = calls[0]
    launches = bf16_counters()
    for k, n in launches.items():
        assert n > 0, f"the bf16 main path never launched {k}"
    for name in ("greedy", "beam"):
        b16 = texts["bfloat16", name]
        assert len(b16) == len(paths) and any(b16.values()), name
        same = sum(b16[u] == texts["float32", name][u] for u in b16)
        # words before the two texts first part, over the f32 text's
        prefix = []
        for u in b16:
            a, b = b16[u].split(), texts["float32", name][u].split()
            n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            prefix.append(n / max(1, len(b)))
        print(f"cli.infer bf16 {name}: {rates['bfloat16', name]:.1f} utts/s "
              f"against {rates['float32', name]:.1f} at f32 ({smi}); "
              f"{same} of {len(b16)} utterances' text equal to the f32 "
              f"decode, the common prefix {np.mean(prefix):.3f} of the f32 "
              f"text's words on average", flush=True)

    serving_dir = os.path.join(root, "serving_bf16")
    quiet(export_model.main, ["-m", exp, "-o", serving_dir, "--batch",
                              str(B), "--frames", str(FRAMES), "--beam",
                              f"{N_BEAM},{K_BEAM}", "--dtype", "bfloat16"])
    serving_q8 = os.path.join(root, "serving_bf16_q8")
    quiet(export_model.main, ["-m", bexp, "-o", serving_q8, "--batch",
                              str(B), "--frames", str(FRAMES), "--quantize",
                              "int8"])
    for d in (serving_dir, serving_q8):
        with open(os.path.join(d, "manifest.json")) as f:
            assert json.load(f)["compute_dtype"] == "bfloat16", d
    cfg = Config(exp)
    snap = load_checkpoint(os.path.join(exp, "seq2seq_1.model.npz"))
    params, state = from_jax_numpy(snap["params"], snap["state"],
                                   torch.device(device))
    x = next(a for a in (np.load(p) for p in paths) if len(a) <= FRAMES)
    # row 0 of a call at the entry's batch, as the server runs it
    X = np.zeros((B, FRAMES, 13), np.float32)
    X[0, :len(x)] = x
    Xt = torch.from_numpy(X).to(torch.device(device))
    bf = torch.bfloat16
    with torch.inference_mode():
        w = seq2seq.decode_weights(params, bf)
        pred = seq2seq.predict_greedy(params, state, cfg.model, Xt, STOP, w,
                                      compute_dtype=bf)[0][0].cpu().numpy()
        hyps, scores, lengths = (a.cpu().numpy() for a in
                                 beam_ops.make_beam_decoder(
                                     cfg.model, N_BEAM, K_BEAM, STOP,
                                     compute_dtype=bf)(params, state, Xt, w))
    eos = np.nonzero(pred == SYMBOLS.EOS_ID)[0]
    want_g = (pred[:eos[0]] if eos.size else pred).tolist()
    best = beam_ops.rerank_hypothesis(
        [(hyps[0, n, :lengths[0, n]].tolist(), float(scores[0, n]))
         for n in range(N_BEAM)], 0.6)[0][0]
    want_b = [int(i) for i in best[1:]]
    if want_b and want_b[-1] == SYMBOLS.EOS_ID:
        want_b = want_b[:-1]
    proc, base_url, warm_s = start_server(
        serving_dir, os.path.join(root, "serve_bf16.log"), device=device)
    try:
        before = http_get(base_url + "/stats")["kernel_launches"]
        sg, rg = http_post(base_url + "/decode?mode=greedy", x)
        sb, rb = http_post(base_url + "/decode?mode=beam", x)
        after = http_get(base_url + "/stats")["kernel_launches"]
    finally:
        rc = stop_server(proc)
    assert sg == 200 and rg["ids"] == want_g, (sg, rg, want_g)
    assert sb == 200 and rb["ids"] == want_b, (sb, rb, want_b)
    moved = {k: after[k] - before[k] for k in after}
    check_launched("cli.serve bf16", moved, ("k1_bf16", "k5_bf16",
                                             "k6_bf16"))
    assert rc == 0, rc
    print(f"  export_model --dtype bfloat16 (and int8 from the bf16 "
          f"experiment: manifests say bfloat16) + cli.serve: ready after "
          f"{warm_s:.1f} s; one greedy and one beam request, ids equal to "
          f"the in-process bf16 decode ({len(want_g)} / {len(want_b)} "
          f"tokens); the server launched {moved}", flush=True)
    units = {"k1_bf16": batches["bfloat16", "greedy"]
             + batches["bfloat16", "beam"],
             "k5_bf16": batches["bfloat16", "greedy"],
             "k6_bf16": batches["bfloat16", "beam"]}
    return launches, units


def sync(device):
    """Wait for the card (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_determinism(train_exp, root, smi, device="cuda"):
    """Two NNs from one seed train two epochs of phase 6's experiment
    (fresh directories, its configs) and must end with bit-equal
    parameters, BN state and optimizer state; so must one epoch of the
    NCHW conv family (force_nchw, whose backward is F.fold and GEMMs).
    Then one step's time with the embedding gradient summed by the
    one-hot product (the repair) and by index_add_ (as before it), in
    turns in this call, and the two sums' own device time."""
    import torch

    from ast_tpu_torch.ops import embedding
    from ast_tpu_torch.train.optimizer import tree_leaves
    from ast_tpu_torch.train.trainer import NN

    def run(tag, epochs, exp=train_exp, model_edit=None):
        d = os.path.join(root, f"determinism_{tag}")
        os.makedirs(d)
        for f in ("model_cfg.json", "train_cfg.json"):
            shutil.copy(os.path.join(exp, f), d)
        if model_edit:
            path = os.path.join(d, "model_cfg.json")
            with open(path) as f:
                mcfg = json.load(f)
            model_edit(mcfg)
            with open(path, "w") as f:
                json.dump(mcfg, f)
        nn = NN(d, device)
        with contextlib.redirect_stdout(io.StringIO()):
            for e in range(1, epochs + 1):
                nn.train_epoch(nn.cfg.train["train_set"], epoch=e)
        sync(device)
        return nn

    def leaves(nn):
        return (tree_leaves(nn.params) + tree_leaves(nn.state)
                + tree_leaves(nn.opt_state))

    def same(x, y):
        return torch.equal(x, y) if torch.is_tensor(x) else x == y

    def index_add_grad(ids, d_rows, V):
        return torch.zeros((V, d_rows.shape[-1]), device=d_rows.device,
                           dtype=d_rows.dtype).index_add_(
            0, ids.reshape(-1).long(), d_rows.reshape(ids.numel(), -1))

    t0 = time.perf_counter()
    a, b = run("a", 2), run("b", 2)
    la, lb = leaves(a), leaves(b)
    diff = [i for i, (x, y) in enumerate(zip(la, lb)) if not same(x, y)]
    assert len(la) == len(lb) and not diff, (
        f"two runs from one seed differ in {len(diff)} of {len(la)} "
        f"leaves after two epochs")
    def nchw(m):
        m["cnn_config"]["force_nchw"] = True

    na, nb = run("nchw_a", 1, model_edit=nchw), run("nchw_b", 1,
                                                     model_edit=nchw)
    assert all(same(x, y) for x, y in zip(leaves(na), leaves(nb))), (
        "two runs of the NCHW conv family differ after one epoch")
    repair = embedding.embedding_grad
    embedding.embedding_grad = index_add_grad
    try:
        c, d = run("c", 1), run("d", 1)
    finally:
        embedding.embedding_grad = repair
    before_equal = all(same(x, y) for x, y in zip(leaves(c), leaves(d)))
    X, y = train_batch(torch.device(device))
    batch = {"X": X.cpu().numpy(), "y": y.cpu().numpy(), "n_real": B,
             "utts": [""] * B}
    ms = {"one-hot": [], "index_add_": []}
    for name in ("index_add_", "one-hot", "one-hot", "index_add_"):
        embedding.embedding_grad = (index_add_grad if name == "index_add_"
                                    else repair)
        try:
            ms[name].append(step_split(a, batch, 10)["step"])
        finally:
            embedding.embedding_grad = repair
    # the sum alone, at the step's shapes: (U - 1) B rows of E
    V, E = a.params["dec"]["embed"].shape
    gen = np.random.default_rng(9)
    ids = torch.from_numpy(gen.integers(0, V, (U_TRAIN - 1, B))).to(device)
    d_rows = torch.from_numpy(gen.standard_normal(
        (U_TRAIN - 1, B, E)).astype(np.float32)).to(device)
    sum_ms = {n: cuda_ms(lambda f=f: f(ids, d_rows, V), 20)
              for n, f in (("one-hot", repair),
                           ("index_add_", index_add_grad))}
    print(f"determinism: two NNs from one seed, two epochs of phase 6's "
          f"experiment each: {len(la)} leaves of parameters, BN and "
          f"optimizer state bit-equal, and one epoch of the NCHW conv "
          f"family ({time.perf_counter() - t0:.1f} s); with index_add_ in "
          f"the repair's place, one epoch's two runs "
          f"{'were' if before_equal else 'were not'} bit-equal", flush=True)
    print(f"  the embedding gradient's sum alone ({U_TRAIN - 1} x {B} rows, "
          f"V {V}, E {E}): one-hot product {sum_ms['one-hot']:.4f} ms, "
          f"index_add_ {sum_ms['index_add_']:.4f} ms", flush=True)
    print(f"  one step (B={B}, {FRAMES} frames, U={U_TRAIN}; {smi}; CUDA "
          f"events, turns index_add_ / one-hot / one-hot / index_add_): "
          f"before the repair {np.mean(ms['index_add_']):.2f} ms "
          f"{[round(v, 3) for v in ms['index_add_']]}, after "
          f"{np.mean(ms['one-hot']):.2f} ms "
          f"{[round(v, 3) for v in ms['one-hot']]}", flush=True)
    return ms


# ---------------------------------------------------------------------------
# phase 14: bfloat16 training (extras.compute_dtype: "bfloat16")
# ---------------------------------------------------------------------------

# K1 train, K2, K3 and K4 in their bf16 mode against their plain bf16
# versions on the card.  As in phase 13 both round the same values to
# bf16 at the same points and sum in f32 in another order, so they part
# by one bf16 ulp where a value falls within an f32 rounding of a bf16
# boundary, and a flip feeds the recurrence from there on: along each
# one's own path they drift apart by about as much as a rounding point
# dropped would move them (the mean errors, printed for the kernels and
# the controls alike), so two checks.  (1) Along its own path each
# output, stream and gradient leaf is within BF16_MAX_TOL of its own
# max|plain| (bf16_errs' first measure): 2**-6, while a one-ulp flip of
# its largest value reads 2**-8 to 2**-7 of it and a wrong row (the
# alphas of another step, or zero) about 1.  (2) One step at a time
# (k1_step_errs, k2_step_errs, k3_step_errs, k4_step_errs): each product
# recomputed in f32 from the streams the kernel rounded its operands
# into, so that only the order of a sum differs, is within BF16_MAX_TOL
# of its max and BF16_STEP_TOL of its mean|plain| (the second measure);
# a rounding point dropped moves about half the values by an ulp, and
# the controls -- the plain versions with one dropped, standing in for
# each kernel -- must fail it.  The step's loss and NN.eval_loss within
# BF16_LOSS_TOL relative; K3's sampled ids within BF16_TOK_TOL of the
# plain step's best logit.
BF16_MAX_TOL = 2 ** -6
BF16_STEP_TOL = 2 ** -16
BF16_LOSS_TOL = 2 ** -16
# phase 12's bf16 pass: how far the card's bf16 step of a variant with
# no kernel stage may lie from the float64-sum bf16 step, as a multiple
# of the CPU's float32-sum distance from it (bf16_limits)
BF16_SPREAD = 4
BF16_TRAIN_KEYS = ("k1_train_bf16", "k2_bf16", "k3_bf16", "k4_bf16")


def train_counters():
    """The training kernels' wrappers by their key in the kernels line
    (f32 and bf16 modes count apart: ``launches``, ``launches_bf16``)."""
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl

    return dict(zip(BF16_TRAIN_KEYS, (fl.fused_stacked_lstm_train,
                                      fl.encoder_backward,
                                      fd.decoder_forward,
                                      fd.decoder_backward)))


def bf16_train_counts():
    return {k: fn.launches_bf16 for k, fn in train_counters().items()}


def f32_train_counts():
    return {k: fn.launches for k, fn in train_counters().items()}


def zero_train_counts():
    for fn in train_counters().values():
        fn.launches = fn.launches_bf16 = 0


def bf16_errs(got, want):
    """(max |got - want| / max |want|, mean |got - want| / mean |want|),
    in f32."""
    g, w = got.float(), want.float()
    d, a = (g - w).abs(), w.abs()
    return (float(d.max()) / max(float(a.max()), 1e-30),
            float(d.mean()) / max(float(a.mean()), 1e-30))


def worst_errs(pairs):
    """The largest of each of :func:`bf16_errs`'s two measures over
    ``pairs`` of (got, want)."""
    return tuple(map(max, zip(*(bf16_errs(g, w) for g, w in pairs))))


def worse(a, b):
    return tuple(map(max, a, b))


def show(errs):
    """bf16_errs' (max, mean) along the path, then one step at a time."""
    return (f"along its path max {errs[0]:.3e}, mean {errs[1]:.3e}; one "
            f"step max {errs[2]:.3e}, mean {errs[3]:.3e}")


def step_ok(errs):
    return errs[0] <= BF16_MAX_TOL and errs[1] <= BF16_STEP_TOL


def check(errs, what):
    """``errs`` (along the path, one step) of a kernel against its plain
    version: the path's max and one step's max and mean within their
    bounds."""
    assert errs[0] <= BF16_MAX_TOL and step_ok(errs[2:]), (
        f"{what} disagrees: {show(errs)} (tol {BF16_MAX_TOL} of max|plain|,"
        f" one step also {BF16_STEP_TOL} of mean|plain|)")


def check_control(errs, what):
    """A control -- a plain version with one of ast_tpu's rounding points
    dropped, standing in for a kernel -- must fail the one-step check
    that the kernel passes."""
    assert not step_ok(errs[2:]), (
        f"the one-step check cannot see {what}: {show(errs)}")


@contextlib.contextmanager
def patched(*patches):
    """Each (object, name, value) of ``patches`` set inside the block."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, value in patches:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def unrounded_operand(shape):
    """fused_decoder's plain versions with the left operand of ``shape``
    left unrounded: at (B, T') K3's alphas before the context product
    and K4's d_scores before d_q, one rounding point each."""
    from ast_tpu_torch.ops import fused_decoder as fd

    plain = fd._plain_math

    def math(enc, w):
        enc, w, lhs = plain(enc, w)
        return enc, w, lambda v: v if tuple(v.shape) == shape else lhs(v)
    return patched((fd, "_plain_math", math))


def gate_acts(z):
    """The LSTM gates' activations [i|f|g|o] of pre-activations ``z``."""
    import torch

    from ast_tpu_torch.ops.lstm import lstm_gate_acts

    H = z.shape[-1] // 4
    return lstm_gate_acts(z, torch.zeros_like(z[..., :H]), H)[0]


def k1_step_errs(x0, wxr, wh, b, out):
    """K1 train's gate activations against the same recomputed from its
    own streams, every (step, layer) at once: each product reads the
    bf16 stream its operand was rounded into (h_pre of the step before,
    x_drop of the layer below; layer 0 adds x0_proj), in f32."""
    import torch

    acts, _, h_pre, x_drop = (s.float() for s in out[3:])
    h_prev = torch.cat([torch.zeros_like(h_pre[:1]), h_pre[:-1]])
    wxr, wh = wxr.float(), wh.float()
    z = [x0 if l == 0 else
         torch.einsum("tdbh,dhk->tdbk", x_drop[:, l - 1], wxr[l - 1])
         for l in range(wh.shape[0])]
    z = torch.stack([z[l] + torch.einsum("tdbh,dhk->tdbk", h_prev[:, l],
                                         wh[l]) + b[l][:, None]
                     for l in range(wh.shape[0])], dim=1)
    return bf16_errs(out[3], gate_acts(z).to(out[3].dtype))


def k2_step_errs(dz, bwd):
    """K2's dz against the plain version whose carries read K2's own dz
    (``forced_dz``)."""
    from ast_tpu_torch.ops import fused_lstm as fl

    return bf16_errs(dz, fl.encoder_backward_reference(*bwd, forced_dz=dz))


def k3_step_errs(enc, h0, w, ht, res):
    """K3 run without dropout between its layers (every product operand
    is then a stream): its gates, query, alphas, context and ht against
    the same recomputed from its streams and ht, every step at once."""
    import torch

    from ast_tpu_torch.ops.bf16 import rounded

    f = {k: v.float() for k, v in w.items()}
    enc = enc.float()
    acts, h_all, emb, alphas, cv = (res[k].float() for k in (
        "acts", "h_all", "emb", "alphas", "cv"))
    L = h_all.shape[1]
    x0 = torch.cat([emb, rounded(torch.cat([torch.zeros_like(ht[:1]),
                                            ht[:-1]]))], dim=-1)
    h_prev = torch.cat([rounded(h0)[None], h_all[:-1]])
    z = torch.stack([(x0 @ f["wx0"] if l == 0
                      else h_all[:, l - 1] @ f["wx_rest"][l - 1])
                     + h_prev[:, l] @ f["wh"][l] + f["b"][l]
                     for l in range(L)], dim=1)
    top = h_all[:, L - 1]
    q = top @ f["wa"] + f["wa_b"]
    bf = res["q"].dtype
    return worst_errs([
        (res["acts"], gate_acts(z).to(bf)), (res["q"], q.to(bf)),
        (res["alphas"], torch.softmax(torch.einsum("bth,ubh->ubt", enc, q),
                                      dim=-1).to(bf)),
        (res["cv"], torch.einsum("ubt,bth->ubh", alphas, enc).to(bf)),
        (ht, torch.tanh(torch.cat([cv, top], dim=-1) @ f["ctx_w"]
                        + f["ctx_b"]))])


def k4_step_errs(enc, w, g, seed, drop_emb):
    """K4's d_cv, d_q and d_emb against the same recomputed from its own
    d_pre, d_scores and layer-0 dz streams, every step at once."""
    import torch

    from ast_tpu_torch.ops import fused_decoder as fd

    f = {k: v.float() for k, v in w.items()}
    enc = enc.float()
    U, B, H = g["d_cv"].shape
    E = f["embed"].shape[1]
    d_emb = (g["dz"][:, 0].float() @ f["wx0"].t())[..., :E]
    if drop_emb > 0:
        keep = torch.stack([fd.embed_drop_mask(drop_emb, seed, t, B, E,
                                               enc.device)
                            for t in range(U)])
        d_emb = torch.where(keep, d_emb * (1.0 / (1.0 - drop_emb)), 0.0)
    bf = g["d_cv"].dtype
    return worst_errs([
        (g["d_cv"], (g["d_pre"].float() @ f["ctx_w"].t())[..., :H].to(bf)),
        (g["d_q"], torch.einsum("ubt,bth->ubh", g["d_scores"].float(),
                                enc).to(bf)),
        (g["d_emb"], d_emb.to(bf))])


def check_bf16_encoder_train(x0, wxr, wh, b, name, controls=False):
    """K1 train and K2 at bf16 (``wxr`` / ``wh`` bf16) against their plain
    bf16 versions along their paths (K1's f32 outputs and final states
    and bf16 streams, its zero pattern the hash mask; K2 fed K1's
    residuals and seeded cotangents) and one step at a time, both
    bit-equal over REPEATS more calls.  With ``controls``, the plain
    versions with their products' operands unrounded (K1: x and h; K2:
    the carries' dz) stand in for the kernels and must fail the one-step
    checks.  Returns (K1 errs, K2 errs, K1's outputs, the controls'
    errs or None); each errs the worst (along the path, one step)."""
    import torch

    from ast_tpu_torch.ops import fused_lstm as fl

    t_enc, _, nb, _ = x0.shape
    seed = ENC_SEED + nb
    args = (x0, wxr, wh, b, seed, DROP)
    got = fl.fused_stacked_lstm_train(*args)
    ref = fl.stacked_lstm_reference(x0, wxr, wh, b, True, seed, DROP)
    assert [t.dtype for t in got] == [torch.float32] * 3 + [
        torch.bfloat16] * 4, [t.dtype for t in got]
    mask_ok, _ = hash_mask_equal(got[6], seed, DROP, x0.device)
    assert mask_ok, f"K1 train bf16's dropout pattern differs, {name}"
    err1 = (*worst_errs(zip(got, ref)), *k1_step_errs(x0, wxr, wh, b, got))
    check(err1, f"K1 train bf16, {name}")
    rng = np.random.default_rng(7000 + nb)
    cot = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32) * 0.1).to(x0.device) for t in got[:3]]
    bwd = (got[3], got[4], wxr, wh, *cot, seed, DROP)
    dz = fl.encoder_backward(*bwd)
    assert dz.dtype == torch.bfloat16
    dz_p = fl.encoder_backward_reference(*bwd)
    err2 = (*bf16_errs(dz, dz_p), *k2_step_errs(dz, bwd))
    check(err2, f"K2 bf16, {name}")
    check_repeats(lambda: fl.fused_stacked_lstm_train(*args), got,
                  f"K1 train bf16, {name}")
    check_repeats(lambda: fl.encoder_backward(*bwd), dz, f"K2 bf16, {name}")
    ctl = None
    if controls:
        with patched((fl, "rounded", lambda v: v)):
            k1 = fl.stacked_lstm_reference(x0, wxr, wh, b, True, seed, DROP)
            k2 = fl.encoder_backward_reference(*bwd)
        ctl = ((*worst_errs(zip(k1, ref)), *k1_step_errs(x0, wxr, wh, b, k1)),
               (*bf16_errs(k2, dz_p), *k2_step_errs(k2, bwd)))
        check_control(ctl[0], "K1 train's products reading unrounded "
                      "operands")
        check_control(ctl[1], "K2's carries reading dz unrounded")
    return err1, err2, got, ctl


def check_bf16_decoder_train(enc, h0, c0, w, y_in, coins, seed, d_ht,
                             name, controls=False):
    """K3 and K4 at bf16 (``enc`` and ``w`` bf16) against their plain
    bf16 versions along K3's own selected ids (sampled ids within
    BF16_TOK_TOL of the plain step's best logit, the teacher's on forced
    steps, ht and every stream within BF16_MAX_TOL), K4 fed K3's streams
    and ``d_ht``; one step at a time K4 at DROP and K3 without dropout
    between its layers; both bit-equal over REPEATS more calls.  With
    ``controls``, the plain versions with the alphas (K3) and d_scores
    (K4) unrounded stand in for the kernels and must fail the one-step
    checks.  Returns (K3 errs, shortfall, K4 errs, K3's (ht, streams),
    K4's streams, the controls' errs or None)."""
    import torch

    from ast_tpu_torch.ops import fused_decoder as fd

    args = (enc, h0, c0, w, y_in, coins, seed, DROP, DROP)
    ht_k, res_k = fd.decoder_forward(*args)
    assert tuple(res_k) == fd.RES_NAMES_BF16 and ht_k.dtype == torch.float32
    assert all(res_k[k].dtype == torch.bfloat16
               for k in fd.RES_NAMES_BF16[1:])
    sel = res_k["sel"]
    ht_p, res_p = fd.decoder_forward_reference(*args, forced_ids=sel)
    short = float(fd.sampled_shortfall(ht_p, w, sel, coins).max())
    forced = coins.bool()
    assert (sel[forced] == y_in[forced]).all(), f"K3 bf16 teacher ids, {name}"
    assert short <= BF16_TOK_TOL, (
        f"K3 bf16's sampled ids, {name}: shortfall {short}")

    def path_errs(ht, res, ht_p, res_p):
        return worst_errs([(ht, ht_p)] + [(res[k], res_p[k])
                                          for k in fd.RES_NAMES_BF16[1:]])
    # one step at a time: no dropout between the layers, so that every
    # product's operand is a stream
    args0 = args[:-1] + (0.0,)
    fwd0 = fd.decoder_forward(*args0)
    err3 = (*path_errs(ht_k, res_k, ht_p, res_p),
            *k3_step_errs(enc, h0, w, *fwd0))
    check(err3, f"K3 bf16, {name}")
    bwd = (res_k, ht_k, enc, c0, w, d_ht, seed, DROP, DROP)
    g_k = fd.decoder_backward(*bwd)
    assert g_k["dh0"].dtype == g_k["dc0"].dtype == torch.float32
    assert all(g_k[k].dtype == torch.bfloat16 for k in fd.GRAD_NAMES[:6])
    g_p = fd.decoder_backward_reference(*bwd)
    err4 = (*worst_errs((g_k[k], g_p[k]) for k in fd.GRAD_NAMES),
            *k4_step_errs(enc, w, g_k, seed, DROP))
    check(err4, f"K4 bf16, {name}")
    check_repeats(lambda: fd.decoder_forward(*args), (ht_k, res_k),
                  f"K3 bf16, {name}")
    check_repeats(lambda: fd.decoder_backward(*bwd), g_k, f"K4 bf16, {name}")
    ctl = None
    if controls:
        sel0 = fwd0[1]["sel"]
        p0 = fd.decoder_forward_reference(*args0, forced_ids=sel0)
        with unrounded_operand((enc.shape[0], enc.shape[1])):
            k3 = fd.decoder_forward_reference(*args0, forced_ids=sel0)
            k4 = fd.decoder_backward_reference(*bwd)
        ctl = ((*path_errs(*k3, *p0), *k3_step_errs(enc, h0, w, *k3)),
               (*worst_errs((k4[k], g_p[k]) for k in fd.GRAD_NAMES),
                *k4_step_errs(enc, w, k4, seed, DROP)))
        check_control(ctl[0], "K3 with its alphas unrounded")
        check_control(ctl[1], "K4 with its d_scores unrounded")
    return err3, short, err4, (ht_k, res_k), g_k, ctl


def step_loss_bf16(params, state, mcfg, X, y, n_real, draws):
    """The bf16 train step's loss from the public pieces that
    ``seq2seq.forward_loss`` chains at ``compute_dtype`` bf16 (the
    autograd Functions with f32 encoder weights cast inside, the decoder's
    in bf16); returns (loss, K3's selected ids).  Under
    ``plain_kernels(sel)`` the same with the plain versions."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl

    bf = torch.bfloat16
    x0, wxr, wh, b, _ = seq2seq.encoder_inputs(
        params, state, mcfg, X * (1.0 + draws.noise), train=True,
        compute_dtype=bf)
    out = fl.FusedStackedLSTM.apply(x0, wxr, wh, b, draws.enc_seed, True,
                                    DROP, bf)
    enc, h0, c0 = seq2seq.encoder_outputs(*out)
    w = seq2seq.pack_decoder_weights(params, bf)
    y_in = y.t()[:-1].to(torch.int32).contiguous()
    ht, sel = fd.FusedDecoder.apply(
        enc.to(bf), h0, c0, *(w[k] for k in fd.W_NAMES), y_in, draws.coins,
        draws.dec_seed, DROP, DROP)
    dec = params["dec"]
    return seq2seq.sequence_loss(ht, dec["out_w"], dec["out_b"], y.t()[1:],
                                 n_real, compute_dtype=bf), sel


def check_bf16_train_kernels(cfg, device):
    """Phase 14, kernels: K1 train, K2, K3 and K4 at bf16 against their
    plain bf16 versions on phase 5's batch at es_en_20h width, at
    ENC_PARTIAL's / TRAIN_PARTIAL's and TRAIN_WIDE's batches, at D2 = 1
    (bi_rnn false) and (K1 train, K2) on DEEP_ENCODER's stack, REPEATS
    more calls bit-equal; the whole step's gradient of every leaf through
    the kernels and through the plain versions; each kernel's time beside
    its f32 mode's in this call, and K3's and K4's split by launch kind.
    Only the bf16 entries launch until the f32 times are taken."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl
    from ast_tpu_torch.train.optimizer import tree_leaves

    bf = torch.bfloat16
    mcfg = cfg.model
    zero_train_counts()
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    X, y = train_batch(device)
    n_real = float(B)
    draws = seq2seq.make_draws(7, X, U_TRAIN - 1, TEACH, NOISE)
    draws.enc_seed, draws.dec_seed = ENC_SEED, DEC_SEED
    res = {}
    with torch.no_grad():
        x0, wxr, wh, b, _ = seq2seq.encoder_inputs(
            params, state, mcfg, X * (1.0 + draws.noise), train=True,
            compute_dtype=bf)
        wxr16, wh16 = wxr.to(bf), wh.to(bf)
        err1, err2, got, ctl_enc = check_bf16_encoder_train(
            x0, wxr16, wh16, b, f"{B} rows", controls=True)
        T_enc, D2 = x0.shape[:2]
        enc_dims = dict(T=T_enc, D2=D2, B=B, H=x0.shape[3] // 4,
                        L=wh.shape[0], wbytes=2)
        ref = fl.stacked_lstm_reference(x0, wxr16, wh16, b, True, ENC_SEED,
                                        DROP)
        enc, h0, c0 = seq2seq.encoder_outputs(*ref[:3])
        w = seq2seq.pack_decoder_weights(params, bf)
        y_in = y.t()[:-1].to(torch.int32).contiguous()
        # the loss's own cotangent at ht, along K3's ids
        sel = fd.decoder_forward(enc.to(bf), h0, c0, w, y_in, draws.coins,
                                 DEC_SEED, DROP, DROP)[1]["sel"]
        ht = fd.decoder_forward_reference(enc.to(bf), h0, c0, w, y_in,
                                          draws.coins, DEC_SEED, DROP, DROP,
                                          forced_ids=sel)[0]
    ht.requires_grad_(True)
    loss = seq2seq.sequence_loss(ht, params["dec"]["out_w"],
                                 params["dec"]["out_b"], y.t()[1:], n_real,
                                 compute_dtype=bf)
    d_ht = torch.autograd.grad(loss, ht)[0].contiguous()
    with torch.no_grad():
        err3, short, err4, fwd_k, bwd_k, ctl_dec = check_bf16_decoder_train(
            enc.to(bf), h0, c0, w, y_in, draws.coins, DEC_SEED, d_ht,
            f"{B} rows", controls=True)
        n_sampled = int((draws.coins == 0).sum())
        print(f"K1 train bf16: x0_proj {tuple(x0.shape)}, outputs and bf16 "
              f"streams {show(err1)} (tol {BF16_MAX_TOL} of each tensor's "
              f"max|plain|; one step also {BF16_STEP_TOL} of its "
              f"mean|plain|), h_fin / c_fin f32, dropout zero pattern the "
              f"hash mask; K2 bf16 dz {show(err2)}; K3 bf16 {U_TRAIN - 1} "
              f"steps, {n_sampled} sampled, ids within {short:.3e} of the "
              f"plain step's best logit (tol {BF16_TOK_TOL}), ht and "
              f"streams {show(err3)}; K4 bf16 streams {show(err4)}; "
              f"{REPEATS} more calls of each bit-equal", flush=True)
        print(f"  controls, each failing the one-step check: plain K1 train "
              f"with its products' operands unrounded {show(ctl_enc[0])}; "
              f"plain K2 with its carries reading dz unrounded "
              f"{show(ctl_enc[1])}; plain K3 with the alphas unrounded "
              f"{show(ctl_dec[0])}; plain K4 with d_scores unrounded "
              f"{show(ctl_dec[1])}", flush=True)
        # every row tiling of the tensor-core waves (16 to 256 rows), T'
        # below L + 1 and odd, and a stack whose full waves take two
        # launches
        for name, args in bf16_encoder_cases(
                params, ENC_PARTIAL + TRAIN_WIDE, device):
            e1, e2, _, _ = check_bf16_encoder_train(*args, name)
            err1, err2 = worse(err1, e1), worse(err2, e2)
            print(f"  K1 train / K2 bf16 at {name}: {show(e1)}; "
                  f"{show(e2)}", flush=True)
        umcfg = variant_cfg(mcfg, "bi_rnn false")
        uparams, ustate = seq2seq.init_model(umcfg, seed=0, device=device)
        u0, ur, uh, ub = unidirectional_case(uparams, ustate, umcfg, B,
                                             device)
        e1, e2, _, _ = check_bf16_encoder_train(
            u0, ur.to(bf), uh.to(bf), ub, f"D2 = 1, {B} rows")
        err1, err2 = worse(err1, e1), worse(err2, e2)
        print(f"  K1 train / K2 bf16 at D2 = 1 ({B} rows, T' "
              f"{u0.shape[0]}, {uh.shape[2]} units): {show(e1)}; "
              f"{show(e2)}", flush=True)
        for nb, t_enc in TRAIN_PARTIAL + TRAIN_WIDE:
            rng = np.random.default_rng(100 + nb)
            Xp = torch.from_numpy(rng.standard_normal(
                (nb, 4 * t_enc, 13)).astype(np.float32)).to(device)
            pe, ph0, pc0 = seq2seq.encode(params, state, mcfg, Xp)
            U = len(TRAIN_PARTIAL_COINS)
            py = torch.from_numpy(rng.integers(4, VOCAB, (U, nb)).astype(
                np.int32)).to(device)
            pcoins = torch.tensor(TRAIN_PARTIAL_COINS, dtype=torch.int32,
                                  device=device)
            pd = torch.from_numpy(rng.standard_normal(
                (U, nb, w["ctx_w"].shape[1])).astype(np.float32)
                * 0.1).to(device)
            e3, sh, e4, _, _, _ = check_bf16_decoder_train(
                pe.to(bf), ph0, pc0, w, py, pcoins, DEC_SEED + nb, pd,
                f"{nb} rows, T' {t_enc}")
            err3, err4 = worse(err3, e3), worse(err4, e4)
            short = max(short, sh)
            print(f"  K3 / K4 bf16 at {nb} rows, T' {t_enc}: ids {sh:.3e}, "
                  f"streams {show(e3)}; K4 {show(e4)}", flush=True)

    # the whole step: every parameter's gradient, kernels vs plain
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_k, sel = step_loss_bf16(params, state, mcfg, X, y, n_real, draws)
    g_k = torch.autograd.grad(loss_k, leaves)
    with plain_kernels(sel):
        loss_p, _ = step_loss_bf16(params, state, mcfg, X, y, n_real, draws)
        g_p = torch.autograd.grad(loss_p, leaves)
    with torch.no_grad():
        loss_f = seq2seq.forward_loss(params, state, mcfg, X, y, n_real,
                                      draws, compute_dtype=bf)[0].item()
    names = leaf_names(params)
    worst = max((bf16_errs(a, b)[0], n) for a, b, n in zip(g_k, g_p, names))
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    print(f"train step bf16: loss {loss_k.item():.6f} (plain "
          f"{loss_p.item():.6f}, {loss_err:.3e} apart, tol {BF16_LOSS_TOL}; "
          f"forward_loss {loss_f:.6f}); {len(leaves)} f32 parameter "
          f"gradients, worst leaf {worst[1]} at {worst[0]:.3e} of its "
          f"max|plain| (tol {BF16_MAX_TOL})", flush=True)
    assert all(g.dtype == torch.float32 for g in g_k)
    assert worst[0] <= BF16_MAX_TOL, (
        f"the bf16 step's gradient of {worst[1]} disagrees: {worst[0]}")
    assert loss_err <= BF16_LOSS_TOL, f"the bf16 step's loss: {loss_err}"
    assert abs(loss_f - loss_k.item()) <= 1e-6 * abs(loss_k.item()), \
        "forward_loss at bf16 disagrees with its pieces"
    for p in leaves:
        p.requires_grad_(False)
    f32 = f32_train_counts()
    assert not any(f32.values()), f"an f32 training kernel launched: {f32}"

    # times: each kernel at bf16 beside its f32 mode, in this call, in
    # turns
    with torch.no_grad():
        enc_args = (x0, wxr16, wh16, b, ENC_SEED, DROP)
        enc_args32 = (x0, wxr, wh, b, ENC_SEED, DROP)
        got32 = fl.fused_stacked_lstm_train(*enc_args32)
        cot = [torch.zeros_like(t) for t in got32[:3]]
        bwd = (got[3], got[4], wxr16, wh16, *cot, ENC_SEED, DROP)
        bwd32 = (got32[3], got32[4], wxr, wh, *cot, ENC_SEED, DROP)
        w32 = seq2seq.pack_decoder_weights(params)
        dargs = (enc.to(bf), h0, c0, w, y_in, draws.coins, DEC_SEED, DROP,
                 DROP)
        dargs32 = (enc, h0, c0, w32, y_in, draws.coins, DEC_SEED, DROP, DROP)
        ht32, res32 = fd.decoder_forward(*dargs32)
        dbwd = (fwd_k[1], fwd_k[0], enc.to(bf), c0, w, d_ht, DEC_SEED, DROP,
                DROP)
        dbwd32 = (res32, ht32, enc, c0, w32, d_ht, DEC_SEED, DROP, DROP)
        dec_dims = dict(B=B, T=enc.shape[1], H=enc.shape[2], L=h0.shape[0],
                        E=w["embed"].shape[1], A=w["ctx_w"].shape[1],
                        V=w["embed"].shape[0], U=U_TRAIN - 1, wbytes=2)
        timed = {
            "k1_train_bf16": (
                lambda: fl.fused_stacked_lstm_train(*enc_args),
                lambda: fl.fused_stacked_lstm_train(*enc_args32),
                lambda: fl.stacked_lstm_reference(*enc_args[:4], True,
                                                  ENC_SEED, DROP),
                err1, enc_dims),
            "k2_bf16": (lambda: fl.encoder_backward(*bwd),
                        lambda: fl.encoder_backward(*bwd32),
                        lambda: fl.encoder_backward_reference(*bwd), err2,
                        enc_dims),
            "k3_bf16": (lambda: fd.decoder_forward(*dargs),
                        lambda: fd.decoder_forward(*dargs32),
                        lambda: fd.decoder_forward_reference(*dargs), err3,
                        dict(dec_dims, n_logits=n_sampled)),
            "k4_bf16": (lambda: fd.decoder_backward(*dbwd),
                        lambda: fd.decoder_backward(*dbwd32),
                        lambda: fd.decoder_backward_reference(*dbwd), err4,
                        dec_dims),
        }
        for key, (fn, fn32, plain, err, dims) in timed.items():
            # in turns: f32, bf16, bf16, f32
            t = [cuda_ms(f, 5) for f in (fn32, fn, fn, fn32)]
            res[key] = dict(max_abs_err=err[0], ms=(t[1] + t[2]) / 2,
                            f32_ms=(t[0] + t[3]) / 2,
                            plain_ms=cuda_ms(plain, 2), dims=dims)
            r = res[key]
            print(f"  {key}: {r['ms']:.3f} ms at bf16, {r['f32_ms']:.3f} ms "
                  f"at f32 ({r['ms'] / r['f32_ms']:.3f} of it), plain bf16 "
                  f"{r['plain_ms']:.2f} ms", flush=True)
        # one K3 and one K4 call split by launch kind, each dtype
        for key in ("k3_bf16", "k4_bf16"):
            fn, fn32 = timed[key][:2]
            print(f"  {key} by launch kind (device ms, torch.profiler): "
                  f"bf16 {show_split(train_split(fn))}; f32 "
                  f"{show_split(train_split(fn32))}", flush=True)
    return res


@contextlib.contextmanager
def memory_spans(opt):
    """Inside the block, the peak memory allocated in each span between
    the fused Functions' forward and backward calls and the optimizer's
    ``opt.apply_``, and inside each: yields a list that fills with (span,
    peak bytes)."""
    import torch

    from ast_tpu_torch.ops.fused_decoder import FusedDecoder
    from ast_tpu_torch.ops.fused_lstm import FusedStackedLSTM

    spans, where = [], ["before encoder.forward"]

    def mark(span):
        spans.append((where[0], torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()
        where[0] = span

    def bracket(fn, name):
        def run(*args, **kw):
            mark(f"in {name}")
            try:
                return fn(*args, **kw)
            finally:
                mark(f"after {name}")
        return run

    fns = [(cls, m, f"{tag}.{m}") for cls, tag in ((FusedStackedLSTM,
                                                    "encoder"),
                                                   (FusedDecoder, "decoder"))
           for m in ("forward", "backward")]
    saved = [(cls, m, cls.__dict__[m]) for cls, m, _ in fns]
    try:
        for cls, m, name in fns:
            setattr(cls, m, staticmethod(bracket(getattr(cls, m), name)))
        with patched((opt, "apply_", bracket(opt.apply_, "optimizer"))):
            torch.cuda.reset_peak_memory_stats()
            yield spans
            mark(None)
    finally:
        for cls, m, fn in saved:
            setattr(cls, m, fn)


def step_memory(nn, batch):
    """(peak bytes allocated during one ``nn.train_step`` on ``batch``,
    those above what was allocated before it, and each span of
    :func:`memory_spans` with its peak above that)."""
    import torch

    nn.train_step(batch, 0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with memory_spans(nn.opt) as spans:
        nn.train_step(batch, 1)
        torch.cuda.synchronize()
    peak = max(p for _, p in spans)
    return peak, peak - before, [(w, p - before) for w, p in spans]


def run_bf16_training(train_exp, train_cfg, root, smi, device="cuda"):
    """Phase 14, the entry points: cli.train -e 2 at compute_dtype
    bfloat16 on phase 6's experiment, with ``train_cfg`` (phase 6's, as
    it was before phase 8's options) and f32 beside it where timed
    (falling loss, two dev.log rows;
    K1 train / K2 / K3 / K4 bf16 launched and none of their f32 modes,
    K1 eval and K5 bf16 in the dev decode and not their f32 modes);
    NN.eval_loss at bf16 against the same through the plain versions; two
    NNs from one seed end one bf16 epoch bit-equal; a train step's time
    split by kernel and its peak memory at bf16 beside f32.  Returns the
    bf16 training kernels' launches and the run's train steps."""
    import torch

    from ast_tpu_torch.cli import train
    from ast_tpu_torch.train.optimizer import tree_leaves
    from ast_tpu_torch.train.trainer import NN

    def experiment(tag, dtype):
        d = os.path.join(root, f"exp_{tag}")
        os.makedirs(d)
        shutil.copy(os.path.join(train_exp, "model_cfg.json"), d)
        cfg = json.loads(json.dumps(train_cfg))
        cfg.setdefault("extras", {})["compute_dtype"] = dtype
        with open(os.path.join(d, "train_cfg.json"), "w") as f:
            json.dump(cfg, f)
        return d

    bexp = experiment("train_bf16", "bfloat16")
    zero_counts()
    zero_train_counts()
    zero_bf16_counts()
    t0 = time.perf_counter()
    with counting(NN, "train_step") as steps:
        _, report = quiet(train.main, ["-m", bexp, "-e", "2", "--device",
                                       device])
    sync(device)
    wall = time.perf_counter() - t0
    launches = bf16_train_counts()
    f32 = dict(f32_train_counts(), k1=all_counters()["k1"].launches,
               k5=all_counters()["k5"].launches)
    decode = bf16_counters()
    with open(os.path.join(bexp, "train.log")) as f:
        losses = [float(line.split(", ")[1]) for line in f]
    with open(os.path.join(bexp, "dev.log")) as f:
        bleus = [line.strip() for line in f]
    rates = [float(v) for v in re.findall(
        r"train throughput = ([0-9.]+) utts/sec", report)]
    print(f"cli.train -e 2 at bf16 ({wall:.1f} s): train.log losses "
          f"{losses}, dev.log {bleus}; train {rates} utts/s ({smi}); bf16 "
          f"launches {launches}, decode {decode}; f32 launches {f32}",
          flush=True)
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert losses[1] < losses[0], f"the bf16 loss did not fall: {losses}"
    assert len(bleus) == 2
    for k, n in launches.items():
        assert n > 0, f"the bf16 training path never launched {k}"
    assert decode["k1_bf16"] > 0 and decode["k5_bf16"] > 0, decode
    assert not any(f32.values()), f"an f32 kernel launched: {f32}"

    nn = NN(bexp, device)
    dev_key = nn.cfg.train["dev_set"]
    loss_k = nn.eval_loss(dev_key)
    with plain_kernels(eval_encoder=True):
        loss_p = nn.eval_loss(dev_key)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  NN.eval_loss at bf16 {loss_k:.6f} through the kernels, "
          f"{loss_p:.6f} through the plain versions ({rel:.3e} apart, tol "
          f"{BF16_LOSS_TOL})", flush=True)
    assert np.isfinite(loss_k) and rel <= BF16_LOSS_TOL

    def one_epoch(tag):
        d = experiment(tag, "bfloat16")
        run = NN(d, device)
        with contextlib.redirect_stdout(io.StringIO()):
            run.train_epoch(run.cfg.train["train_set"], epoch=1)
        sync(device)
        return (tree_leaves(run.params) + tree_leaves(run.state)
                + tree_leaves(run.opt_state))

    la, lb = one_epoch("bf16_a"), one_epoch("bf16_b")
    same = all(torch.equal(x, y) if torch.is_tensor(x) else x == y
               for x, y in zip(la, lb))
    print(f"  two NNs from one seed, one bf16 epoch each: {len(la)} leaves "
          f"of parameters, BN and optimizer state "
          f"{'bit-equal' if same else 'DIFFER'}", flush=True)
    assert len(la) == len(lb) and same, "bf16 training does not repeat"

    X, y = train_batch(torch.device(device))
    batch = {"X": X.cpu().numpy(), "y": y.cpu().numpy(), "n_real": B,
             "utts": [""] * B}
    nn32 = NN(experiment("train_f32", "float32"), device)
    split, mem = {}, {}
    for tag, run in (("f32", nn32), ("bf16", nn), ("bf16 ", nn),
                     ("f32 ", nn32)):
        split.setdefault(tag.strip(), []).append(step_split(run, batch, 5))
        mem[tag.strip()] = step_memory(run, batch)
    for tag in ("f32", "bf16"):
        s = {k: np.mean([d[k] for d in split[tag]]) for k in split[tag][0]}
        fwd, bwd = s["k1t"] + s["k3"], s["k2"] + s["k4"]
        print(f"  one step at {tag} (B={B}, {FRAMES} frames, U={U_TRAIN}; "
              f"{smi}; CUDA events, turns f32 / bf16 / bf16 / f32): "
              f"{s['step']:.3f} ms = K1 train {s['k1t']:.3f} + K3 "
              f"{s['k3']:.3f} + K4 {s['k4']:.3f} + K2 {s['k2']:.3f} + "
              f"optimizer {s['opt']:.3f} + the rest "
              f"{s['step'] - fwd - bwd - s['opt']:.3f}; peak memory "
              f"{mem[tag][0] / 2 ** 20:.1f} MiB allocated, "
              f"{mem[tag][1] / 2 ** 20:.1f} MiB of it the step's own; "
              f"each span's own peak (MiB): " + ", ".join(
                  f"{w} {p / 2 ** 20:.1f}" for w, p in mem[tag][2]),
              flush=True)
    return launches, steps[0]


# ---------------------------------------------------------------------------
# phase 15: the feed options and the epoch (the training headline's
# configuration: es_en_20h's model, B=32, G=4, bf16, hbm_cache)
# ---------------------------------------------------------------------------

# the epoch benchmark's buckets that phase 15 trains on, at reduced counts:
# 160 frames (four full 32-row batches and an 8-row tail: full runs of
# G = 4), 640 (two and a tail) and 1,680 (T' 420, U 96: one and a tail)
EPOCH_SUBSET = "1:136,7:72,19:40"
EPOCH_T, EPOCH_U, EPOCH_TAIL = 420, 96, 8
HEADLINE_G = 4


def epoch_coins(steps, seed=15):
    """Teacher coins of a ``steps``-step decode at TEACH, the first and
    last steps forced (make_draws' rule)."""
    rng = np.random.default_rng(seed)
    c = (rng.random(steps) < TEACH).astype(int)
    c[0] = c[-1] = 1
    return tuple(int(v) for v in c)


def check_epoch_shapes(cfg, device):
    """K1 train / K2 / K3 / K4 against their plain versions at the
    epoch's longest bucket (T' 420, U 96) at B = 32 and at an 8-row tail,
    at f32 (ENC_TOL / BWD_TOL / TOK_TOL, REPEATS more calls bit-equal)
    and at bf16 (BF16_MAX_TOL along the path and one step at a time,
    BF16_STEP_TOL, BF16_TOK_TOL).  Returns {kernel: worst err}."""
    import torch

    from ast_tpu_torch.models import seq2seq

    bf = torch.bfloat16
    mcfg = cfg.model
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    coins = epoch_coins(EPOCH_U - 1)
    w16 = seq2seq.pack_decoder_weights(params, bf)
    worst = {}
    for nb in (B, EPOCH_TAIL):
        x0, wxr, wh, b = encoder_case(params, nb, EPOCH_T, device)
        e1, e2 = check_encoder_train_partial(x0, wxr, wh, b)
        e3, e4 = check_train_partial(params, state, mcfg, nb, EPOCH_T,
                                     device, coins)
        f1, f2, _, _ = check_bf16_encoder_train(
            x0, wxr.to(bf), wh.to(bf), b, f"{nb} rows, T' {EPOCH_T}")
        rng = np.random.default_rng(200 + nb)
        X = torch.from_numpy(rng.standard_normal(
            (nb, 4 * EPOCH_T, 13)).astype(np.float32)).to(device)
        enc, h0, c0 = seq2seq.encode(params, state, mcfg, X)
        y_in = torch.from_numpy(rng.integers(
            4, VOCAB, (EPOCH_U - 1, nb)).astype(np.int32)).to(device)
        d_ht = torch.from_numpy(rng.standard_normal(
            (EPOCH_U - 1, nb, w16["ctx_w"].shape[1])).astype(np.float32)
            * 0.1).to(device)
        f3, short, f4, _, _, _ = check_bf16_decoder_train(
            enc.to(bf), h0, c0, w16, y_in,
            torch.tensor(coins, dtype=torch.int32, device=device),
            DEC_SEED + nb, d_ht, f"{nb} rows, T' {EPOCH_T}, U {EPOCH_U}")
        for k, v in (("k1t", e1), ("k2", e2), ("k3", e3), ("k4", e4)):
            worst[k] = max(worst.get(k, 0.0), v)
        for k, v in zip(BF16_TRAIN_KEYS, (f1, f2, f3, f4)):
            worst[k] = worse(worst[k], v) if k in worst else v
        print(f"  bf16 at {nb} rows, T' {EPOCH_T}, U {EPOCH_U}: K1 train "
              f"{show(f1)}; K2 {show(f2)}; K3 ids {short:.3e}, {show(f3)}; "
              f"K4 {show(f4)}", flush=True)
    return worst


def feed_experiment(root, tag, **opts):
    """A copy of the epoch benchmark's experiment over the phase's corpus
    (root/corpus) in its own directory, with write_configs' options;
    zero_input 0.1, so that frame dropout's mask is drawn."""
    import torch_trainer_epoch_bench as eb

    corpus = os.path.join(root, "corpus")
    exp = eb.write_configs(corpus, B, opts.pop("g", 1), **opts)
    d = os.path.join(root, f"feed_{tag}")
    os.makedirs(d)
    for f in ("model_cfg.json", "train_cfg.json"):
        shutil.copy(os.path.join(exp, f), d)
    edit_train_cfg(d, lambda c: c["data"].update(zero_input=0.1))
    return d


def run_feed_options(cfg, root, smi, device="cuda"):
    """Phase 15: the feed options and the epoch.  The training kernels at
    the epoch's longest shapes; on the epoch benchmark's corpus over
    EPOCH_SUBSET (build_corpus, es_en_20h's model): an hbm_cache epoch
    bit-equal to a host-fed one; at G = 4 a preempted and resumed epoch
    bit-equal to an uninterrupted one; one step's gradients with and
    without remat bit-equal, each step's peak memory; transfer_dtype
    bfloat16 / float16 and hbm_cache_dtype bfloat16 epochs finite, with
    their host-to-device bytes a step; the headline configuration's
    utts/s and its kernels' launches.  Returns (the headline's launches
    {bf16 training row: count}, its steps)."""
    import torch

    from ast_tpu_torch.train import trainer
    from ast_tpu_torch.train.optimizer import tree_leaves

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_trainer_epoch_bench as eb

    t_phase = time.perf_counter()
    print(f"phase 15: the feed options and the epoch ({smi})", flush=True)
    with torch.inference_mode():
        worst = check_epoch_shapes(cfg, device)
    print(f"  K1 train / K2 / K3 / K4 at T' {EPOCH_T}, U {EPOCH_U}, "
          f"{B} and {EPOCH_TAIL} rows: f32 max abs err K1 train "
          f"{worst['k1t']:.3e}, K2 {worst['k2']:.3e}, K3 {worst['k3']:.3e}, "
          f"K4 {worst['k4']:.3e}; bf16 "
          + "; ".join(f"{k} {show(worst[k])}" for k in BF16_TRAIN_KEYS),
          flush=True)

    corpus = os.path.join(root, "corpus")
    n_utts = eb.build_corpus(corpus, log=lambda *a: None,
                             buckets=eb.parse_buckets(EPOCH_SUBSET))
    train_set = "syn_train"

    def state_of(nn):
        return (tree_leaves(nn.params) + tree_leaves(nn.state)
                + tree_leaves(nn.opt_state))

    def equal(a, b):
        return all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                   for x, y in zip(state_of(a), state_of(b)))

    def epochs(exp, n=1, nn=None, first=1):
        nn = nn or trainer.NN(exp, device)
        with contextlib.redirect_stdout(io.StringIO()):
            losses = [nn.train_epoch(train_set, epoch=e)
                      for e in range(first, first + n)]
        sync(device)
        return nn, losses

    # hbm_cache: bit-equal to host feeding (frame dropout on)
    host, l_host = epochs(feed_experiment(root, "host", g=HEADLINE_G))
    cached, l_cache = epochs(feed_experiment(root, "cache", g=HEADLINE_G,
                                             hbm_cache=True))
    steps = host.timer.n_steps
    assert l_cache == l_host and equal(cached, host), \
        "an hbm_cache epoch differs from host feeding"
    print(f"  hbm_cache (bf16, G {HEADLINE_G}): one epoch of {n_utts} "
          f"utterances, {steps} steps, losses and every parameter, BN and "
          f"optimizer leaf bit-equal to host feeding; host-to-device "
          f"{host.epoch_h2d_bytes / steps / 1e6:.3f} MB a step host-fed, "
          f"{cached.epoch_h2d_bytes / steps / 1e6:.4f} MB cached "
          f"({cached._hbm_caches[train_set].nbytes / 1e6:.1f} MB resident)",
          flush=True)
    del cached

    # G = 4: preempted in its fifth step (so at the end of that step's
    # run), resumed, bit-equal to `host`
    exp = feed_experiment(root, "resume", g=HEADLINE_G)
    nn1 = trainer.NN(exp, device)
    step = nn1.train_step

    def preempt_in_fifth(batch, seed, seen=[]):
        seen.append(seed)
        if len(seen) == 5:
            nn1.request_preempt()
        return step(batch, seed)

    nn1.train_step = preempt_in_fifth
    try:
        epochs(exp, nn=nn1)
        raise AssertionError("the preempted epoch did not stop")
    except trainer.PreemptedError:
        pass
    nn2 = trainer.NN(exp, device)
    at = nn2.inflight_resume
    assert at[0] == 1 and 5 <= at[1] < 5 + HEADLINE_G, at
    nn2, _ = epochs(exp, nn=nn2)
    assert equal(nn2, host), "the resumed epoch differs from the whole one"
    print(f"  G {HEADLINE_G}: an epoch preempted in its fifth step stops "
          f"at the end of that step's run ({at[1]} steps), and resumed in a "
          f"fresh NN ends bit-equal to the uninterrupted one", flush=True)
    del nn1, nn2

    # remat: one step's gradients bit-equal, and each step's peak
    grads, peaks = {}, {}
    for remat in (False, True):
        nn = trainer.NN(feed_experiment(root, f"remat_{remat}",
                                        remat=remat), device)
        batch = next(b for b in nn.data_loader.get_batch(
            B, train_set, train=True, labels=True, epoch=1)
            if b["bucket"] == 19 and b["n_real"] == B)
        orig = nn.opt.apply_

        def apply_(g, st, params, remat=remat, orig=orig):
            grads[remat] = [t.clone() for t in tree_leaves(g)]
            return orig(g, st, params)

        nn.opt.apply_ = apply_
        nn.train_step(batch, 0)           # warm
        sync(device)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        nn.train_step(batch, 1)
        sync(device)
        peaks[remat] = (torch.cuda.max_memory_allocated() - before) / 2**20
        del nn
    assert all(torch.equal(a, b) for a, b in zip(grads[False],
                                                 grads[True])), \
        "remat's gradients differ"
    print(f"  remat: one step at {B} rows, T' {EPOCH_T}, U {EPOCH_U} "
          f"(bf16): {len(grads[True])} gradients bit-equal with and "
          f"without; step peak {peaks[False]:.1f} MiB without, "
          f"{peaks[True]:.1f} MiB with ({smi})", flush=True)

    # narrow transfers and a bf16 cache: finite epochs, bytes a step
    for tag, opts in (("transfer_bf16", dict(transfer_dtype="bfloat16")),
                      ("transfer_f16", dict(transfer_dtype="float16")),
                      ("cache_bf16", dict(hbm_cache=True,
                                          hbm_cache_dtype="bfloat16"))):
        nn, losses = epochs(feed_experiment(root, tag, g=HEADLINE_G,
                                            **opts))
        assert np.isfinite(losses).all(), (tag, losses)
        print(f"  {tag}: loss {losses[0]:.4f} (host f32 {l_host[0]:.4f}), "
              f"{nn.epoch_h2d_bytes / nn.timer.n_steps / 1e6:.4f} MB "
              f"host-to-device a step", flush=True)
        del nn

    # the headline configuration: utts/s over the reduced corpus, and the
    # launches of its epochs
    exp = feed_experiment(root, "headline", g=HEADLINE_G, hbm_cache=True)
    nn, _ = epochs(exp)                   # cold: cache fill, first steps
    cold_steps = nn.timer.n_steps
    zero_train_counts()
    t0 = time.perf_counter()
    nn, losses = epochs(exp, 2, nn, first=2)
    dt = time.perf_counter() - t0
    n = bf16_train_counts()
    head_steps = nn.timer.n_steps - cold_steps
    assert all(n.values()) and not any(f32_train_counts().values()), n
    print(f"  headline (bf16, B {B}, G {HEADLINE_G}, hbm_cache): "
          f"{2 * n_utts / dt:.1f} utts/s over two warm epochs of "
          f"{n_utts} utterances ({smi}); launches over its {head_steps} "
          f"steps {n}", flush=True)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return n, head_steps


# ---------------------------------------------------------------------------
# phase 16: data parallel (ast_tpu_torch.parallel over torch.distributed)
# ---------------------------------------------------------------------------

# the shard the kernels are held at: rows [DP_OFFSET, B) of a B-row batch
DP_OFFSET = 16
DP_RANKS = 2
# the two-rank run's corpus: buckets of the epoch benchmark's (160 and 640
# frames), two full 32-row batches each, so that no tail batch is shrunk
# to another row count at one process than at two; the dev split is
# build_corpus' 8 utterances
DP_SUBSET = "1:64,7:64"
DP_EPOCHS = 2
# parameters and BN state of two ranks against one process (the
# sums over rows run in another order): tests/test_parallel.py's bounds
DP_RTOL, DP_ATOL = 2e-4, 1e-5


def check_row_offset_kernels(cfg, device):
    """K1 train, K2, K3 and K4, f32 and bf16, on rows [DP_OFFSET, B) of a
    B-row batch with ``row_offset`` DP_OFFSET (a data-parallel rank's
    shard) against their plain versions at the same offset: f32 within
    ENC_TOL (K1 train, K3 along its own ids, sampled ids within TOK_TOL)
    and BWD_TOL of max|plain| (K2, K4); bf16 within BF16_MAX_TOL of each
    tensor's max|plain| along the path.  Every dropout mask bit-equal to
    the global batch's rows: K1's x_drop zero pattern, K3's dropped
    embedding and layer outputs (f32) against the hash masks of the
    whole batch, and K1's against a whole-batch K1 call's rows.  Returns
    {key: worst error}."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl
    from ast_tpu_torch.ops.dropout import drop_mask

    bf = torch.bfloat16
    mcfg = cfg.model
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    off, nb, t_enc = DP_OFFSET, B - DP_OFFSET, FRAMES // 4
    mine = slice(off, B)
    x0, wxr, wh, b = encoder_case(params, B, t_enc, device)
    x0s = x0[:, :, mine].contiguous()
    seed = ENC_SEED + 16
    whole = fl.fused_stacked_lstm_train(x0, wxr, wh, b, seed, DROP)[6]
    out = {}
    for dt in (torch.float32, bf):
        w_x, w_h = wxr.to(dt), wh.to(dt)
        got = fl.fused_stacked_lstm_train(x0s, w_x, w_h, b, seed, DROP, off, B)
        ref = fl.stacked_lstm_reference(x0s, w_x, w_h, b, True, seed, DROP,
                                        row_offset=off, global_rows=B)
        assert hash_mask_equal(got[6], seed, DROP, device, off, B)[0], \
            f"K1 train's masks at offset {off} ({dt}) are not the batch's"
        if dt == torch.float32:
            assert torch.equal(got[6] == 0, whole[:, :, :, mine] == 0)
        rng = np.random.default_rng(7100)
        cot = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
            np.float32) * 0.1).to(device) for t in got[:3]]
        bwd = (got[3], got[4], w_x, w_h, *cot, seed, DROP)
        dz = fl.encoder_backward(*bwd, off, B)
        dz_p = fl.encoder_backward_reference(*bwd, row_offset=off,
                                             global_rows=B)
        if dt == torch.float32:
            e1 = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            e2 = rel_err(dz, dz_p)[0]
            assert e1 <= ENC_TOL and e2 <= BWD_TOL, (e1, e2)
            out["k1t"], out["k2"] = e1, e2
        else:
            e1, e2 = worst_errs(zip(got, ref))[0], bf16_errs(dz, dz_p)[0]
            assert e1 <= BF16_MAX_TOL and e2 <= BF16_MAX_TOL, (e1, e2)
            out["k1_train_bf16"], out["k2_bf16"] = e1, e2
        check_repeats(lambda: fl.encoder_backward(*bwd, off, B), dz,
                      f"K2 at offset {off} ({dt})")

    rng = np.random.default_rng(160)
    X = torch.from_numpy(rng.standard_normal(
        (B, FRAMES, 13)).astype(np.float32)).to(device)
    enc, h0, c0 = seq2seq.encode(params, state, mcfg, X)
    enc, h0, c0 = enc[mine], h0[:, mine], c0[:, mine]
    coins = torch.tensor(TRAIN_PARTIAL_COINS, dtype=torch.int32,
                         device=device)
    U = coins.shape[0]
    y_in = torch.from_numpy(rng.integers(4, VOCAB, (U, nb)).astype(
        np.int32)).to(device)
    dseed = DEC_SEED + 16
    E, Hd = params["dec"]["embed"].shape[1], h0.shape[2]
    Ld = h0.shape[0]
    # the global batch's masks (fused_decoder's seeds), this shard's rows
    t = torch.arange(U * Ld, device=device)
    keep_e = drop_mask((B, E), DROP, (dseed + 2 * t[:U]).view(U, 1, 1),
                       row_axis=0, device=device)[:, mine]
    keep_r = drop_mask((B, Hd), DROP, (dseed + 2 * t + 1).view(U, Ld, 1, 1),
                       row_axis=0, device=device)[:, :, mine]
    for dt in (torch.float32, bf):
        w = seq2seq.pack_decoder_weights(params, dt)
        args = (enc.to(dt).contiguous(), h0.contiguous(), c0.contiguous(),
                w, y_in, coins, dseed, DROP, DROP)
        ht_k, res_k = fd.decoder_forward(*args, off)
        sel = res_k["sel"]
        ht_p, res_p = fd.decoder_forward_reference(*args, forced_ids=sel,
                                                   row_offset=off)
        short = float(fd.sampled_shortfall(ht_p, w, sel, coins).max())
        d_ht = torch.from_numpy(rng.standard_normal(
            tuple(ht_k.shape)).astype(np.float32) * 0.1).to(device)
        bwd = (res_k, ht_k, args[0], args[2], w, d_ht, dseed, DROP, DROP)
        g_k = fd.decoder_backward(*bwd, off)
        g_p = fd.decoder_backward_reference(*bwd, off)
        if dt == torch.float32:
            assert torch.equal(res_k["emb"] == 0, ~keep_e), \
                f"K3's embedding masks at offset {off} are not the batch's"
            assert torch.equal(res_k["x_drop"] == 0, ~keep_r), \
                f"K3's layer masks at offset {off} are not the batch's"
            e3 = max([float((ht_k - ht_p).abs().max())]
                     + [float((res_k[k] - res_p[k]).abs().max())
                        for k in fd.RES_NAMES[1:]])
            e4 = max(rel_err(g_k[k], g_p[k])[0] for k in fd.GRAD_NAMES)
            assert short <= TOK_TOL and e3 <= ENC_TOL and e4 <= BWD_TOL, (
                short, e3, e4)
            out["k3"], out["k4"] = e3, e4
        else:
            e3 = worst_errs([(ht_k, ht_p)] + [
                (res_k[k], res_p[k]) for k in fd.RES_NAMES_BF16[1:]])[0]
            e4 = worst_errs((g_k[k], g_p[k]) for k in fd.GRAD_NAMES)[0]
            assert (short <= BF16_TOK_TOL and e3 <= BF16_MAX_TOL
                    and e4 <= BF16_MAX_TOL), (short, e3, e4)
            # the dropped embedding rows: the global batch's mask
            assert torch.equal(res_k["emb"].float() == 0, ~keep_e), \
                f"K3 bf16's embedding masks at offset {off}"
            out["k3_bf16"], out["k4_bf16"] = e3, e4
        check_repeats(lambda: fd.decoder_backward(*bwd, off), g_k,
                      f"K4 at offset {off} ({dt})")
    print(f"  K1 train / K2 / K3 / K4 at row_offset {off} (rows {off}-{B - 1}"
          f" of a {B}-row batch, T' {t_enc}, U {U}): masks bit-equal to the "
          f"global batch's rows (K1 also to a whole-batch call's); f32 max "
          f"abs err K1 train {out['k1t']:.3e}, K3 {out['k3']:.3e}, K2 "
          f"{out['k2']:.3e} and K4 {out['k4']:.3e} of max|plain|; bf16 "
          + ", ".join(f"{k} {out[k]:.3e}" for k in BF16_TRAIN_KEYS)
          + " of max|plain| along the path", flush=True)
    return out


def gloo_cuda_probe(rank, world, device):
    """all_reduce, broadcast and all_gather over gloo on CUDA tensors:
    raises unless each gives the expected values on the card."""
    import torch
    import torch.distributed as dist

    x = torch.full((1000,), float(rank + 1), device=device)
    dist.all_reduce(x)
    assert x.device == device and bool((x == world * (world + 1) / 2).all()), \
        "gloo all_reduce on CUDA tensors"
    y = torch.full((7,), float(rank), device=device)
    dist.broadcast(y, src=0)
    assert y.device == device and bool((y == 0).all()), "gloo broadcast"
    parts = [torch.empty(3, dtype=torch.int32, device=device)
             for _ in range(world)]
    dist.all_gather(parts, torch.full((3,), rank, dtype=torch.int32,
                                      device=device))
    assert all(p.device == device and bool((p == r).all())
               for r, p in enumerate(parts)), "gloo all_gather"


def params_digest(nn, replicated_only=False):
    """sha256 of every parameter leaf's bytes this rank holds, in tree
    order (with ``replicated_only``, of the leaves no model axis
    shards)."""
    import hashlib

    import torch

    from ast_tpu_torch import parallel
    from ast_tpu_torch.checkpoint import flatten

    h = hashlib.sha256()
    for k, t in flatten(nn.params, leaf=lambda t: t).items():
        if torch.is_tensor(t) and not (replicated_only
                                       and parallel.leaf_spec(k)):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_run(nn, epochs=DP_EPOCHS, eval_loss=False):
    """Train ``epochs`` epochs of ``syn_train`` on ``nn``, then (with
    ``eval_loss``) its dev loss, predict and beam-decode ``syn_dev``.
    Returns a record: the losses, the last epoch's ms a step, the
    kernels' launches in training and decoding, the params, BN state and
    digest, the decodes.  Under a model axis every tree is whole (its
    vocab shards gathered) and ``opt`` holds the optimizer state."""
    import torch

    from ast_tpu_torch import parallel
    from ast_tpu_torch.checkpoint import flatten
    from ast_tpu_torch.train.optimizer import tree_unflatten
    from ast_tpu_torch.train.trainer import to_numpy

    def whole(tree):
        # copies: on the CPU to_numpy shares the tensors' memory
        with torch.no_grad():
            return flatten(to_numpy(parallel.gather_params(tree, nn.mesh)),
                           leaf=np.array)

    zero_counts()
    # the first step's gradient as the optimizer gets it (summed over the
    # ranks under a mesh) and the parameters it moved, and the parameters
    # and BN state it made
    grad1, params0, params1, state1 = {}, {}, {}, {}
    apply_ = nn.opt.apply_

    def first_apply(g, st, params):
        # the step passes the leaves; the trees hold the shards' paths
        if not grad1:
            grad1.update(whole(tree_unflatten(nn.params, list(g))))
            params0.update(whole(nn.params))
        elif not params1:
            params1.update(whole(nn.params))
            state1.update(flatten(to_numpy(nn.state)))
        return apply_(g, st, params)

    nn.opt.apply_ = first_apply
    losses, ms = [], 0.0
    for e in range(1, epochs + 1):
        steps0 = nn.timer.n_steps
        sync(nn.device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            losses.append(nn.train_epoch("syn_train", epoch=e))
        sync(nn.device)
        ms = (time.perf_counter() - t0) * 1e3 / (nn.timer.n_steps - steps0)
    nn.opt.apply_ = apply_
    rec = {"losses": losses, "ms_step": ms, "grad1": grad1,
           "params0": params0, "params1": params1, "state1": state1,
           "steps": nn.timer.n_steps,
           "params": whole(nn.params), "opt": whole(nn.opt_state),
           "state": flatten(to_numpy(nn.state)),
           "digest": params_digest(nn),
           "replicated": params_digest(nn, replicated_only=True)}
    if eval_loss:
        rec["eval_loss"] = nn.eval_loss("syn_dev")
    rec.update(preds=nn.predict("syn_dev"),
               beams=nn.decode_beam_set("syn_dev", N_BEAM, K_BEAM))
    rec["launches"] = counts()          # the epochs' and the decodes'
    return rec


def dp_rank(rank, world, port, exp, out, device):
    """One rank of phase 16's data-parallel run: joins a gloo group of
    ``world`` ranks on ``device`` (cuda:0 for both), checks that gloo
    takes its tensors,
    runs :func:`dp_run` through ``NN`` and times the gradient's
    all-reduce; pickles its record to ``out.<rank>``."""
    import torch
    import torch.distributed as dist

    from ast_tpu_torch import parallel
    from ast_tpu_torch.train import trainer
    from ast_tpu_torch.train.optimizer import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    parallel.init_distributed(f"localhost:{port}", world, rank, "gloo")
    try:
        gloo_cuda_probe(rank, world, device)
        nn = trainer.NN(exp, device)
        assert nn.mesh == parallel.Mesh(world, rank), nn.mesh
        rec = dp_run(nn)
        grads = [torch.randn_like(p) for p in tree_leaves(nn.params)]
        reps, spans = 5, []
        for i in range(reps + 2):
            dist.barrier()
            sync(device)
            t0 = time.perf_counter()
            parallel.all_reduce_grads(grads, nn.mesh)
            sync(device)
            spans.append(time.perf_counter() - t0)
        rec["allreduce_ms"] = sum(spans[2:]) * 1e3 / reps
        rec["grad_mb"] = sum(g.numel() * 4 for g in grads) / 1e6
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(rec, f)
    finally:
        dist.destroy_process_group()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_nccl_one_rank(device):
    """NCCL at world size 1 on the card: a one-rank group, and the data
    parallel collectives on a one-rank mesh (the gradient all-reduce,
    the eval gather, the broadcast of ``replicate``, ``any_rank``) give
    their inputs back.  Returns the all-reduce's ms for ``n`` floats."""
    import torch
    import torch.distributed as dist

    from ast_tpu_torch import parallel

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = parallel.Mesh(1, 0)
        g = [torch.randn(1000, 7, device=device),
             torch.randn(5, device=device)]
        out = parallel.all_reduce_grads([t.clone() for t in g], mesh)
        assert all(torch.equal(a, b) for a, b in zip(out, g))
        rows = parallel.gather_rows([g[0]], mesh)[0]
        assert torch.equal(rows, g[0])
        tree = {"a": g[0].clone(), "b": [g[1].to(torch.bfloat16)]}
        parallel.replicate([tree], mesh)
        assert torch.equal(tree["a"], g[0])
        assert parallel.any_rank(True, mesh, device)
        assert not parallel.any_rank(False, mesh, device)
    finally:
        dist.destroy_process_group()


def run_data_parallel(cfg, root, smi, device="cuda"):
    """Phase 16: data parallelism.  The training kernels at a shard's row
    offset (:func:`check_row_offset_kernels`); NCCL at world size 1
    (:func:`check_nccl_one_rank`); two gloo ranks sharing cuda:0
    (:func:`dp_rank`) train DP_EPOCHS epochs of es_en_20h (B = 32, 16
    rows a rank) on DP_SUBSET, then predict and beam-decode the dev
    split, against one process running the same: the parameters' sha256
    equal on both ranks, parameters and BN state within DP_RTOL /
    DP_ATOL of one process's, both ranks' decodes the whole split and
    equal, the training kernels launched on each rank; the gloo
    all-reduce's ms for the gradient and the two-rank step's ms (two
    ranks on one card); then ``torchrun --nproc-per-node 1 -m
    ast_tpu_torch.cli.train ... --dist-backend nccl`` for one epoch."""
    import torch
    import torch.multiprocessing as mp

    from ast_tpu_torch.train import trainer

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_trainer_epoch_bench as eb

    t_phase = time.perf_counter()
    print(f"phase 16: data parallel ({smi})", flush=True)
    with torch.inference_mode():
        errs = check_row_offset_kernels(cfg, torch.device(device))
    check_nccl_one_rank(torch.device(device))
    print("  NCCL at world size 1: a one-rank group's all-reduce, gather, "
          "broadcast and flag agree with their inputs", flush=True)

    corpus = os.path.join(root, "dp_corpus")
    n_utts = eb.build_corpus(corpus, log=lambda *a: None,
                             buckets=eb.parse_buckets(DP_SUBSET))
    exps = {}
    for tag in ("ranks", "single", "cli"):
        d = os.path.join(root, f"dp_{tag}")
        os.makedirs(d)
        exp = eb.write_configs(corpus, B, 1, compute_dtype="float32")
        for f in ("model_cfg.json", "train_cfg.json"):
            shutil.copy(os.path.join(exp, f), d)
        edit_train_cfg(d, lambda c: c["extras"].update(
            shrink_tail_batches=False))
        exps[tag] = d

    out = os.path.join(root, "dp_rank")
    t0 = time.perf_counter()
    mp.spawn(dp_rank, args=(DP_RANKS, free_port(), exps["ranks"], out,
                            "cuda:0" if device == "cuda" else device),
             nprocs=DP_RANKS, join=True)
    t_ranks = time.perf_counter() - t0
    recs = []
    for r in range(DP_RANKS):
        with open(f"{out}.{r}", "rb") as f:
            recs.append(pickle.load(f))
    single = dp_run(trainer.NN(exps["single"], device))

    assert len({r["digest"] for r in recs}) == 1, \
        "the ranks' parameters differ"
    # the first step's gradient (summed over the ranks) and the BN state
    # it made within DP_RTOL / DP_ATOL of one process's; the parameters
    # after the first and the last step are compared and their elements
    # outside those bounds counted: AMSGrad divides each element's
    # gradient by its own running size (lr g / (|g| + eps) at the first
    # step), so where |g| sits near the f32 rounding of the row sums the
    # step that element takes is set by the sums' order
    worst, outside = {}, {}
    for what in ("grad1", "state1", "params1", "params", "state"):
        n_out = n_all = 0
        for k, want in single[what].items():
            if not isinstance(want, np.ndarray):
                continue
            got = recs[0][what][k]
            out = ~np.isclose(got, want, rtol=DP_RTOL, atol=DP_ATOL)
            n_out, n_all = n_out + int(out.sum()), n_all + out.size
            worst[what] = max(worst.get(what, 0.0),
                              float(np.abs(got - want).max()))
            assert what not in ("grad1", "state1") or not out.any(), (
                f"{what} {k}: two ranks differ from one process by "
                f"{np.abs(got - want).max()}")
        outside[what] = (n_out, n_all)
    assert all(np.isclose(a, b, rtol=1e-5) for a, b in zip(
        recs[0]["losses"], single["losses"])), (recs[0]["losses"],
                                                single["losses"])
    dev_utts = sorted(u for u, _ in single["preds"])
    for r, rec in enumerate(recs):
        assert sorted(u for u, _ in rec["preds"]) == dev_utts, r
        assert sorted(rec["beams"]) == dev_utts, r
        assert rec["preds"] == recs[0]["preds"], r
        assert rec["beams"] == recs[0]["beams"], r
        # a CPU rehearsal runs the plain versions
        assert device == "cpu" or all(
            rec["launches"][k] > 0 for k in ("k1t", "k2", "k3", "k4", "k1",
                                             "k5", "k6")), rec["launches"]
    # a row's ids up to its first EOS (past it: those of the rows that
    # share its decode loop, a rank's, as under ast_tpu's shard_map)
    hyp = {u: ids[:ids.index(2) + 1] if 2 in ids else ids
           for u, ids in single["preds"]}
    same_greedy = sum(hyp[u] == (ids[:ids.index(2) + 1] if 2 in ids
                                 else ids) for u, ids in recs[0]["preds"])
    same_beam = sum(recs[0]["beams"][u][0][0] == single["beams"][u][0][0]
                    for u in dev_utts)
    print(f"  two gloo ranks on cuda:0 (es_en_20h, {B} rows, "
          f"{B // DP_RANKS} a rank, {n_utts} train utterances, "
          f"{recs[0]['steps']} steps) against one process: parameter "
          f"sha256 equal on both ranks; the first step's gradient within "
          f"{worst['grad1']:.3e} and its BN state within "
          f"{worst['state1']:.3e} (bounds rtol {DP_RTOL}, atol {DP_ATOL}); "
          f"the parameters it made within {worst['params1']:.3e} "
          f"({outside['params1'][0]} of {outside['params1'][1]} elements "
          f"outside the bounds); after {recs[0]['steps']} steps params within "
          f"{worst['params']:.3e}, {outside['params'][0]} of "
          f"{outside['params'][1]} elements outside the bounds, BN state "
          f"within {worst['state']:.3e} ({outside['state'][0]} of "
          f"{outside['state'][1]} outside); losses "
          f"{[round(v, 6) for v in recs[0]['losses']]} vs "
          f"{[round(v, 6) for v in single['losses']]}; both ranks predict "
          f"and beam-decode the whole dev split ({len(dev_utts)} "
          f"utterances), equal on both, {same_greedy} greedy and "
          f"{same_beam} beam bests equal to one process's; launches a "
          f"rank {recs[0]['launches']}", flush=True)
    print(f"  two ranks on one card over gloo ({smi}): gradient all-reduce "
          f"{recs[0]['allreduce_ms']:.2f} ms a step ({recs[0]['grad_mb']:.1f}"
          f" MB f32); a step {recs[0]['ms_step']:.2f} ms at {B // DP_RANKS} "
          f"rows a rank against {single['ms_step']:.2f} ms at {B} rows in "
          f"one process; the two-rank run {t_ranks:.1f} s with start-up",
          flush=True)

    # the CLI's launch path under torchrun, NCCL stated
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "1", "--master-port", str(free_port()), "-m",
           "ast_tpu_torch.cli.train", "-m", exps["cli"], "-e", "1",
           "--dist-backend", "nccl"]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    with open(os.path.join(exps["cli"], "train.log")) as f:
        rows = f.read().split()
    assert len(rows) == 2 and os.path.exists(
        os.path.join(exps["cli"], "dev.log")), rows
    print(f"  torchrun --nproc-per-node 1 -m ast_tpu_torch.cli.train -e 1 "
          f"--dist-backend nccl: exit 0 in {time.perf_counter() - t0:.1f} s, "
          f"train.log {rows}, dev.log written", flush=True)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return errs


# ---------------------------------------------------------------------------
# phase 17: vocab tensor parallel (parallel.model_axis over torch.distributed)
# ---------------------------------------------------------------------------

TP_MODEL = 2
# the vocab-parallel cross-entropy alone: es_en_20h's loss GEMM at U = 64
TP_U, TP_A = 64, 512
# its loss against sequence_loss's (relative), and d_ht's largest
# difference over max|d_ht|: f32 sums in another order; at bf16 d_ht is
# rounded to bf16 after the model group's sum, so where the partial
# sums' order moves a value across a rounding point it moves by one
# bf16 ulp, at most 2^-7 of the value
TP_LOSS_RTOL = 1e-5
TP_DHT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# The whole parameters against one process's, within DP_RTOL / DP_ATOL.
# AMSGrad's first step is lr c h / (c |h| + eps), h = g + l2 p and c the
# clip's scale: lr sign(h) wherever |h| is clear of the gradients'
# difference d and of eps / c, and then two runs' steps part by at most
# lr eps c d / (c h)^2.  So after the first step every element whose
# one-process |h| exceeds TP_SIGN_MARGIN times both is held (the steps
# then part by lr / TP_SIGN_MARGIN^2, a tenth of DP_ATOL); after the
# last step (the flips' steps carried on through the moments) at most
# TP_OUTSIDE of all elements, and of each vocab-split leaf's, lie
# outside.  A sharded update of the wrong columns or rows moves whole
# columns or rows, and at its first step.
TP_SIGN_MARGIN = 32
TP_OUTSIDE = {"all": 1e-3, "vocab leaf": 1e-2}


def check_vocab_parallel_ce(mesh, device, reps=10):
    """``parallel.tp.vocab_parallel_loss`` on this rank's vocab shards at
    B = 32, U = TP_U, A = TP_A, V = VOCAB, f32 and bf16, with label
    smoothing 0.1 and random_out's target corruption, against
    ``seq2seq.sequence_loss`` over the whole vocabulary on the same
    inputs (the same seeded tensors on every rank): the loss within
    TP_LOSS_RTOL, d_ht (summed over the model group) and this rank's
    slice of d_out_w within TP_DHT_TOL of their largest value.  Returns
    {dtype: (loss rel err, d_ht err, ms of the vocab-parallel loss's
    forward and backward, ms of sequence_loss's)} and the ms of the gloo
    all-reduce of a d_ht-sized tensor."""
    import torch
    import torch.distributed as dist

    from ast_tpu_torch import parallel
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops.bf16 import parse_dtype
    from ast_tpu_torch.parallel import tp

    gen = torch.Generator(device="cpu").manual_seed(17)
    ht = torch.randn(TP_U, B, TP_A, generator=gen).to(device)
    out_w = (torch.randn(TP_A, VOCAB, generator=gen)
             * TP_A ** -0.5).to(device)
    out_b = (torch.randn(VOCAB, generator=gen) * 0.1).to(device)
    target = torch.randint(4, VOCAB, (TP_U, B), generator=gen).to(device)
    target[TP_U // 2:, :B // 4] = 0                     # PAD tails
    replace = (torch.rand(TP_U, B, generator=gen) > 0.9).to(device)
    rand_ids = torch.randint(4, VOCAB, (TP_U, B), generator=gen).to(device)
    kw = dict(label_smoothing=0.1, replace=replace, rand_ids=rand_ids)
    spec = parallel.leaf_spec("dec/out_w")
    w_m = mesh.shard(out_w, spec)
    b_m = mesh.shard(out_b, parallel.leaf_spec("dec/out_b"))

    def run(fn, *leaves):
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        loss = fn(*leaves)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    def timed(fn):
        spans = []
        for _ in range(reps + 2):
            dist.barrier()
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            spans.append(time.perf_counter() - t0)
        return sum(spans[2:]) * 1e3 / reps

    out = {}
    for name in ("float32", "bfloat16"):
        dt = parse_dtype(name)

        def mine():
            return run(lambda h, w, b: tp.vocab_parallel_loss(
                h, w, b, target, float(B), mesh, compute_dtype=dt, **kw),
                ht, w_m, b_m)

        def whole():
            return run(lambda h, w, b: seq2seq.sequence_loss(
                h, w, b, target, float(B), compute_dtype=dt, **kw),
                ht, out_w, out_b)

        got, want = mine(), whole()
        loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        dht_err = float((got[1] - want[1]).abs().max()
                        / want[1].abs().max())
        dw_want = mesh.shard(want[2], spec)
        dw_err = float((got[2] - dw_want).abs().max()
                       / dw_want.abs().max())
        assert loss_err <= TP_LOSS_RTOL, (name, loss_err)
        assert dht_err <= TP_DHT_TOL[name] and dw_err <= TP_DHT_TOL[name], \
            (name, dht_err, dw_err)
        out[name] = (loss_err, dht_err, timed(mine), timed(whole))
    d_ht = torch.randn(TP_U, B, TP_A, device=device)
    allreduce_ms = timed(lambda: dist.all_reduce(d_ht,
                                                 group=mesh.model_group))
    return out, allreduce_ms


def tp_rank(rank, world, port, exp, out, device):
    """One rank of phase 17's vocab-parallel run: joins a gloo group of
    ``world`` ranks on ``device`` (cuda:0 for both), runs :func:`dp_run`
    (with the dev loss) through ``NN`` on a data 1 x model TP_MODEL mesh,
    saves the last epoch's checkpoint (rank 0 writes), then
    :func:`check_vocab_parallel_ce`; pickles its record to
    ``out.<rank>``."""
    import torch
    import torch.distributed as dist

    from ast_tpu_torch import parallel
    from ast_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    parallel.init_distributed(f"localhost:{port}", world, rank, "gloo")
    try:
        gloo_cuda_probe(rank, world, device)
        nn = trainer.NN(exp, device)
        assert nn.mesh == parallel.Mesh(1, rank, TP_MODEL), nn.mesh
        rnn, Vm = nn.mcfg["rnn_config"], VOCAB // TP_MODEL
        shards = {k: tuple(v.shape) for k, v in nn.params["dec"].items()
                  if k in ("embed", "out_w", "out_b")}
        assert shards == {"embed": (Vm, rnn["embedding_units"]),
                          "out_w": (rnn["attn_units"], Vm),
                          "out_b": (Vm,)}, shards
        rec = dp_run(nn, eval_loss=True)
        nn.save(DP_EPOCHS)
        rec["ce"], rec["allreduce_ms"] = check_vocab_parallel_ce(nn.mesh,
                                                                 device)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(rec, f)
        dist.barrier()          # no rank leaves mid-exchange
    finally:
        dist.destroy_process_group()


def run_vocab_parallel(root, smi, device="cuda"):
    """Phase 17: vocab tensor parallelism.  Two gloo ranks sharing cuda:0
    (:func:`tp_rank`) train DP_EPOCHS epochs of phase 16's es_en_20h
    experiment (B = 32, all rows on both ranks, 549 of the 1,098 vocab
    entries each), then eval_loss, predict and beam-decode the dev
    split, against one process running the same (module docstring), and
    run the vocab-parallel cross-entropy alone."""
    import torch.multiprocessing as mp

    from ast_tpu_torch import parallel
    from ast_tpu_torch.train import trainer
    from ast_tpu_torch.train.optimizer import EPS

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_trainer_epoch_bench as eb

    t_phase = time.perf_counter()
    print(f"phase 17: vocab tensor parallel ({smi})", flush=True)
    corpus = os.path.join(root, "tp_corpus")
    n_utts = eb.build_corpus(corpus, log=lambda *a: None,
                             buckets=eb.parse_buckets(DP_SUBSET))
    exps = {}
    for tag, model_axis in (("ranks", TP_MODEL), ("single", 1)):
        d = os.path.join(root, f"tp_{tag}")
        os.makedirs(d)
        exp = eb.write_configs(corpus, B, 1, compute_dtype="float32")
        for f in ("model_cfg.json", "train_cfg.json"):
            shutil.copy(os.path.join(exp, f), d)

        def edit(c, model_axis=model_axis):
            c["extras"].update(shrink_tail_batches=False)
            c["parallel"] = {"model_axis": model_axis}
        edit_train_cfg(d, edit)
        exps[tag] = d

    out = os.path.join(root, "tp_rank")
    t0 = time.perf_counter()
    mp.spawn(tp_rank, args=(TP_MODEL, free_port(), exps["ranks"], out,
                            "cuda:0" if device == "cuda" else device),
             nprocs=TP_MODEL, join=True)
    t_ranks = time.perf_counter() - t0
    recs = []
    for r in range(TP_MODEL):
        with open(f"{out}.{r}", "rb") as f:
            recs.append(pickle.load(f))
    nn = trainer.NN(exps["single"], device)
    single = dp_run(nn, eval_loss=True)
    nn.save(DP_EPOCHS)

    # the replicated leaves bit-equal on both ranks; the first step's
    # gradient (shards gathered) and BN state, and the last step's
    # optimizer state within DP_RTOL / DP_ATOL; the parameters' elements
    # outside those bounds counted and held (TP_SIGN_MARGIN, TP_OUTSIDE)
    # and the last BN state's counted (AMSGrad's normalised step takes
    # lr sign(g) where |g| is near the rounding of the sums: phase 16)
    assert len({r["replicated"] for r in recs}) == 1, \
        "the ranks' replicated parameters differ"
    assert recs[0]["digest"] != recs[1]["digest"]      # their vocab shards
    worst, outside, leaf_out = {}, {}, {}
    for what in ("grad1", "state1", "params1", "params", "opt", "state"):
        n_out = n_all = 0
        for k, want in single[what].items():
            if not isinstance(want, np.ndarray) or want.dtype.kind != "f":
                continue
            for rec in recs:
                got = rec[what][k]
                assert got.shape == want.shape, (what, k, got.shape)
                far = ~np.isclose(got, want, rtol=DP_RTOL, atol=DP_ATOL)
                n_out, n_all = n_out + int(far.sum()), n_all + far.size
                worst[what] = max(worst.get(what, 0.0),
                                  float(np.abs(got - want).max()))
                assert what not in ("grad1", "state1", "opt") \
                    or not far.any(), (
                    f"{what} {k}: the model axis differs from one process "
                    f"by {np.abs(got - want).max()}")
                if what == "params":
                    o, a = leaf_out.get(k, (0, 0))
                    leaf_out[k] = (o + int(far.sum()), a + far.size)
        outside[what] = (n_out, n_all)
    h = {k: single["grad1"][k] + nn.opt.l2 * p
         for k, p in single["params0"].items()}
    norm = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                       for v in h.values()))
    clip = min(1.0, nn.opt.clip / norm) if nn.opt.clip else 1.0
    floor = TP_SIGN_MARGIN * max(worst["grad1"], EPS / clip)
    n_sure = n_param = 0
    for k, want in single["params1"].items():
        sure = np.abs(h[k]) > floor
        n_sure, n_param = n_sure + int(sure.sum()), n_param + sure.size
        for rec in recs:
            far = ~np.isclose(rec["params1"][k], want, rtol=DP_RTOL,
                              atol=DP_ATOL)
            assert not (far & sure).any(), (
                f"params1 {k}: {int((far & sure).sum())} elements whose "
                f"first step is sure differ from one process's")
    n_out, n_all = outside["params"]
    assert n_out <= TP_OUTSIDE["all"] * n_all, outside["params"]
    for k, (o, a) in leaf_out.items():
        assert not parallel.leaf_spec(k) \
            or o <= TP_OUTSIDE["vocab leaf"] * a, (k, o, a)
    most = sorted(((o / a, k) for k, (o, a) in leaf_out.items() if o),
                  reverse=True)[:6]
    for rec in recs:
        assert all(np.isclose(a, b, rtol=1e-5) for a, b in zip(
            rec["losses"], single["losses"])), (rec["losses"],
                                                single["losses"])
        assert np.isclose(rec["eval_loss"], single["eval_loss"],
                          rtol=1e-5), (rec["eval_loss"], single["eval_loss"])
        assert rec["preds"] == recs[0]["preds"]
        assert rec["beams"] == recs[0]["beams"]
        # a CPU rehearsal runs the plain versions
        assert device == "cpu" or all(
            rec["launches"][k] > 0 for k in ("k1t", "k2", "k3", "k4", "k1",
                                             "k5", "k6")), rec["launches"]
    # the decodes: one process decoding rank 0's checkpoint gives the
    # ranks' ids and hypotheses (the same whole weights); rank 0's file
    # holds one process's keys and shapes
    name = f"seq2seq_{DP_EPOCHS}.model.npz"
    with np.load(os.path.join(exps["ranks"], name)) as got, \
            np.load(os.path.join(exps["single"], name)) as want:
        assert sorted(got.files) == sorted(want.files)
        assert all(got[k].shape == want[k].shape for k in want.files)
    ckpt = trainer.NN(exps["single"], device,
                      ckpt=os.path.join(exps["ranks"], name))
    preds = ckpt.predict("syn_dev")
    beams = ckpt.decode_beam_set("syn_dev", N_BEAM, K_BEAM)

    def hyps(preds):
        return {u: ids[:ids.index(2) + 1] if 2 in ids else ids
                for u, ids in preds}
    assert hyps(preds) == hyps(recs[0]["preds"]), "greedy ids differ"
    assert sorted(beams) == sorted(recs[0]["beams"])
    for u, want in beams.items():
        got = recs[0]["beams"][u]
        assert [h for h, _ in got] == [h for h, _ in want], u
        assert np.allclose([s for _, s in got], [s for _, s in want],
                           rtol=1e-5), u
    same_greedy = sum(hyps(single["preds"])[u] == ids
                      for u, ids in hyps(recs[0]["preds"]).items())
    same_beam = sum(recs[0]["beams"][u][0][0] == single["beams"][u][0][0]
                    for u in beams)
    print(f"  two gloo ranks on cuda:0 (es_en_20h, {B} rows on both, "
          f"model axis {TP_MODEL}: {VOCAB // TP_MODEL} of {VOCAB} vocab "
          f"entries a rank, {n_utts} train utterances, {recs[0]['steps']} "
          f"steps) against one process: replicated leaves bit-equal on "
          f"both ranks; the first step's gradient within "
          f"{worst['grad1']:.3e} and its BN state within "
          f"{worst['state1']:.3e} (bounds rtol {DP_RTOL}, atol {DP_ATOL}); "
          f"the parameters it made within {worst['params1']:.3e} "
          f"({outside['params1'][0]} of {outside['params1'][1]} elements "
          f"outside the bounds; all {n_sure} of {n_param} whose |g + l2 p| "
          f"exceeds {floor:.2e}, their step's sign sure, within them); "
          f"after {recs[0]['steps']} steps params within "
          f"{worst['params']:.3e} ({outside['params'][0]} of "
          f"{outside['params'][1]} outside, limit {TP_OUTSIDE['all']}; the "
          f"most a leaf {[(k, f'{f:.2e}') for f, k in most]}, limit "
          f"{TP_OUTSIDE['vocab leaf']} a vocab-split leaf), optimizer "
          f"state within {worst['opt']:.3e} ({outside['opt'][0]} of "
          f"{outside['opt'][1]} outside), BN state within "
          f"{worst['state']:.3e} ({outside['state'][0]} of "
          f"{outside['state'][1]} outside); "
          f"losses {[round(v, 6) for v in recs[0]['losses']]} vs "
          f"{[round(v, 6) for v in single['losses']]}, eval_loss "
          f"{recs[0]['eval_loss']:.6f} vs {single['eval_loss']:.6f}; "
          f"decodes equal on both ranks and to one process's decode of "
          f"rank 0's checkpoint ({len(beams)} utterances; {same_greedy} "
          f"greedy and {same_beam} beam bests equal to the one-process "
          f"run's own); checkpoint keys and shapes one process's; "
          f"launches a rank {recs[0]['launches']}", flush=True)
    for name in ("float32", "bfloat16"):
        loss_err, dht_err, ms, plain = recs[0]["ce"][name]
        print(f"  vocab-parallel cross-entropy at {name} (B {B}, U {TP_U}, "
              f"A {TP_A}, V {VOCAB}, {VOCAB // TP_MODEL} a rank; label "
              f"smoothing, random_out): loss within {loss_err:.2e} "
              f"(relative), d_ht within {dht_err:.2e} of max|d_ht| of "
              f"sequence_loss's; forward + backward {ms:.3f} ms a rank "
              f"against sequence_loss's {plain:.3f} ms ({smi}; two ranks "
              f"on one card: a check, not a speed)", flush=True)
    print(f"  gloo all-reduce of d_ht ({TP_U * B * TP_A * 4 / 1e6:.1f} MB "
          f"f32) over the model group: {recs[0]['allreduce_ms']:.2f} ms "
          f"({smi}; two ranks on one card); a two-rank step "
          f"{recs[0]['ms_step']:.2f} ms against {single['ms_step']:.2f} ms "
          f"in one process; the two-rank run {t_ranks:.1f} s with "
          f"start-up", flush=True)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s", flush=True)


def step_split(nn, batch, reps):
    """Mean device time (ms) of ``nn.train_step`` on ``batch`` and of the
    parts of it that run in K1 train, K2, K3, K4, the optimizer's step
    (``apply_``) and, in wav mode, the fbank + CMVN (``features``), from
    CUDA events recorded around each (after one warm-up step)."""
    import torch

    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_lstm as fl

    spans = {k: [] for k in ("k1t", "k2", "k3", "k4", "opt", "step",
                             "features")}

    def timed(key, fn):
        def run(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans[key].append((a, b))
            return out
        # a wrapper bumps its count under its module-level name, which is
        # this function while the patch holds
        run.launches = getattr(fn, "launches", 0)
        run.launches_bf16 = getattr(fn, "launches_bf16", 0)
        return run

    patches = [(fl, "fused_stacked_lstm_train", "k1t"),
               (fl, "encoder_backward", "k2"), (fd, "decoder_forward", "k3"),
               (fd, "decoder_backward", "k4"), (nn.opt, "apply_", "opt")]
    if nn.wav_mode:
        patches.append((nn, "features", "features"))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    nn.train_step(batch, 0)
    try:
        for obj, name, key in patches:
            setattr(obj, name, timed(key, getattr(obj, name)))
        step = timed("step", nn.train_step)
        for i in range(reps):
            step(batch, 1 + i)
        torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return {k: sum(a.elapsed_time(b) for a, b in v) / reps
            for k, v in spans.items()}


def print_registers(log):
    """Each kernel's registers and spills, from the build's ptxas lines
    (the mangled name holds the source of a kernel in an anonymous
    namespace, e.g. decode_step_cu ... prod_kernel ILi8ELi4ELb1E for
    prod_kernel<8, 4, true>)."""
    fn, spill = "", ""
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = re.sub(r"^_ZN(3ast)?\d*_GLOBAL__N_+\w*?_\d+_", "",
                            m.group(1))
            if "spill" in line:
                spill = line.strip()
            if "registers" in line:
                print(f"  {fn[:64]}: {line.strip().split(': ')[-1]}; "
                      f"{spill}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from ast_tpu_torch.kernels import build

    # the server subprocess of phase 9 runs with PyTorch's default
    tf32_default = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.library()
    built = build.last_build
    print(f"build: {time.perf_counter() - t0:.1f} s"
          + (f" (nvcc {built['seconds']:.1f} s, {built['path']})"
             if built else " (library already built)"), flush=True)
    if built:
        print_registers(built["log"])

    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        exp, cfg, paths = make_experiment(root)
        with torch.inference_mode():
            results = check_kernels(cfg, device)
        rates, launches, units = run_slice(exp, paths, root)
        print(f"slice ({N_UTTS} utts, {smi}): greedy {rates['greedy']:.1f} "
              f"utts/s, beam {N_BEAM},{K_BEAM} {rates['beam']:.1f} utts/s; "
              f"served batches {units}", flush=True)
        results.update(check_train_kernels(cfg, device))
        results.update(check_opt_kernel(cfg, device))
        train_launches, train = run_train_slice(root, smi)
        # phase 6's train_cfg, before phase 8 turns its options on
        with open(os.path.join(train["exp"], "train_cfg.json")) as f:
            train_cfg6 = json.load(f)
        run_beam_cli(train["exp"], smi)
        run_trainer_machinery(train["exp"], smi)
        run_serving(exp, paths, root, smi, tf32_default)
        run_transfer(root, train["exp"], smi)
        run_audio_corpus(root, smi)
        d1, d1_launches, d1_units = run_variants(root, train["exp"], smi)
        t13 = time.perf_counter()
        with torch.inference_mode():
            results.update(check_bf16_kernels(cfg, device))
        bf_launches, bf_units = run_bf16_serving(exp, paths, root, smi)
        print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
        check_determinism(train["exp"], root, smi)
        t14 = time.perf_counter()
        results.update(check_bf16_train_kernels(cfg, device))
        bt_launches, bt_steps = run_bf16_training(train["exp"], train_cfg6,
                                                  root, smi)
        print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)
        ep_launches, ep_steps = run_feed_options(cfg, root, smi)
        run_data_parallel(cfg, root, smi)
        run_vocab_parallel(root, smi)
    launches.update(bf_launches)
    units.update(bf_units)
    launches.update({k: v for k, v in train_launches.items() if k != "k5"})
    units.update({k: train["steps"]
                  for k in ("k1t", "k2", "k3", "k4", "opt")})
    results.update(d1)
    launches.update(d1_launches)
    units.update(d1_units)
    launches.update(bt_launches)
    units.update({k: bt_steps for k in BF16_TRAIN_KEYS})

    meta = {
        "k1": ("K1 fused biLSTM encoder", "k1_encoder.cu",
               "ast_tpu/ops/fused_lstm.py:275"),
        "k1t": ("K1 fused biLSTM encoder, train mode", "k1_encoder.cu",
                "ast_tpu/ops/fused_lstm.py:275"),
        "k2": ("K2 fused biLSTM encoder backward", "k2_encoder_bwd.cu",
               "ast_tpu/ops/fused_lstm.py:348"),
        "k3": ("K3 fused attention decoder, train forward",
               "k3_decoder_fwd.cu", "ast_tpu/ops/fused_decoder.py:284"),
        "k4": ("K4 fused attention decoder backward", "k4_decoder_bwd.cu",
               "ast_tpu/ops/fused_decoder.py:484"),
        "k5": ("K5 fused greedy decode", "k5_greedy.cu",
               "ast_tpu/ops/fused_infer.py:251"),
        "k6": ("K6 fused beam decode", "k6_beam.cu",
               "ast_tpu/ops/fused_infer.py:537"),
        "k1_d1": ("K1 fused LSTM encoder, one direction (bi_rnn: false)",
                  "k1_encoder.cu", "ast_tpu/ops/fused_lstm.py:275"),
        "k1t_d1": ("K1 fused LSTM encoder, one direction, train mode",
                   "k1_encoder.cu", "ast_tpu/ops/fused_lstm.py:275"),
        "k2_d1": ("K2 fused LSTM encoder backward, one direction",
                  "k2_encoder_bwd.cu", "ast_tpu/ops/fused_lstm.py:348"),
        "k1_bf16": ("K1 fused biLSTM encoder, bf16 (compute_dtype)",
                    "k1_encoder.cu", "ast_tpu/ops/fused_lstm.py:275"),
        "k5_bf16": ("K5 fused greedy decode, bf16 (compute_dtype)",
                    "k5_greedy.cu", "ast_tpu/ops/fused_infer.py:251"),
        "k6_bf16": ("K6 fused beam decode, bf16 (compute_dtype)",
                    "k6_beam.cu", "ast_tpu/ops/fused_infer.py:537"),
        "k1_train_bf16": ("K1 fused biLSTM encoder, train mode, bf16 "
                          "(compute_dtype)", "k1_encoder.cu",
                          "ast_tpu/ops/fused_lstm.py:275"),
        "k2_bf16": ("K2 fused biLSTM encoder backward, bf16 "
                    "(compute_dtype)", "k2_encoder_bwd.cu",
                    "ast_tpu/ops/fused_lstm.py:348"),
        "k3_bf16": ("K3 fused attention decoder, train forward, bf16 "
                    "(compute_dtype)", "k3_decoder_fwd.cu",
                    "ast_tpu/ops/fused_decoder.py:284"),
        "k4_bf16": ("K4 fused attention decoder backward, bf16 "
                    "(compute_dtype)", "k4_decoder_bwd.cu",
                    "ast_tpu/ops/fused_decoder.py:484"),
        "opt": ("Optimizer step: L2, global-norm clip, AMSGrad and the "
                "in-place update", "opt_amsgrad.cu",
                "none: ast_tpu's Adam step is plain XLA (optax)"),
    }
    kernels = []
    for key, (name, src, replaces) in meta.items():
        r = results[key]
        cost_key = "k1t" if key == "k1_train_bf16" else key.split("_")[0]
        bound_ms, bound_by = bound(
            *kernel_cost(cost_key, r["dims"]),
            PEAK_BF16_FLOPS if key.endswith("bf16") else PEAK_F32_FLOPS)
        kernels.append(dict(
            name=name, route="cuda",
            source=f"ast_tpu_torch/kernels/csrc/{src}", replaces=replaces,
            launches=launches[key],
            launches_per_unit=launches[key] / units[key],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=r.get("library_ms"),
            **({"f32_ms": r["f32_ms"]} if "f32_ms" in r else {}),
            **({"epoch_launches": ep_launches[key],
                "epoch_launches_per_step": ep_launches[key] / ep_steps}
               if key in ep_launches else {})))
        unit = ("train step" if key in ("k1t", "k2", "k3", "k4", "k1t_d1",
                                        "k2_d1", "opt") + BF16_TRAIN_KEYS
                else "served batch")
        print(f"{name}: {r['ms']:.3f} ms, bound {bound_ms:.3f} ms "
              f"({bound_by}; {bound_ms / r['ms']:.3f} of it reached), "
              f"{launches[key] / units[key]:.2f} launches per {unit} "
              f"({smi})", flush=True)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "ast_tpu")]
    assert not loaded, f"JAX or ast_tpu was imported: {loaded[:5]}"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
