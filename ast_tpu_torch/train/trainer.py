"""Training harness: the ``NN`` facade of ``ast_tpu/train/trainer.py``.

``NN(cfg_path, device, ckpt)`` builds the config, the bucketed data
loader, the model and the optimizer for one experiment directory and
resumes from its latest checkpoint or, when newer, from the mid-epoch
snapshot ``seq2seq_inflight.npz``; an explicit ``ckpt`` loads exactly
that file instead.  ``train_epoch`` runs one epoch of training steps,
``eval_loss`` the teacher-forced dev loss, ``predict`` greedy-decodes a
split, ``decode_beam_set`` beam-decodes one, ``save`` writes the epoch's
snapshot (params, BN state and optimizer state, in ``ast_tpu``'s
flat-NPZ layout).

One step: a worker thread assembles the host batch and copies it to the
device (:class:`Prefetcher`); the step's random numbers (SpecAugment
masks, speech noise, dropout seeds, scheduled-sampling coins, target
corruption) are drawn from generators seeded by
``stable_seed(f"{seed}|{epoch}|{batch}")``, so a rerun or a resumed
epoch replays the same draws, and on one card a run is bit-equal to the
next from the same seed: every gradient sum runs in a fixed order (the
kernels' reductions, cuBLAS GEMMs, and the embedding gradients as a
one-hot product, ``ops.embedding``, where ``index_add_`` would sum with
atomics).
``forward_loss`` runs the conv front-end, K1 (train), K3 and the loss,
autograd runs K4, K2 and the weight-gradient GEMMs -- or, for a model
variant ``ast_tpu`` runs on its scan path, the plain encoder or decoder
in their place (``models.seq2seq``'s routing); the update is added
to the parameters in place.  Losses stay on the device until the epoch's
end.  With ``data.features: "wav"`` a batch carries raw audio and CMVN
statistics instead of features: every step, ``eval_loss`` and the
decodes first make the normalised MFCC features on the trainer's device
(``ops.fbank.MfccExtractor``, then ``(f - mean) / std`` a row), as
``ast_tpu`` does inside its jitted step.

Every ``checkpoint_steps`` batches, and when :meth:`NN.request_preempt`
was called (the train CLI wires SIGTERM to it), the epoch writes
``seq2seq_inflight.npz`` with ``extra = {epoch, step, g}``: "epoch
``epoch`` has consumed ``step`` batches"; a preempted epoch then raises
:class:`PreemptedError`.  The epoch's batch stream is a function of
``(seed, set, epoch)``, so the next run skips exactly the consumed
batches.  Either package resumes the other's snapshot.

``extras.compute_dtype: "bfloat16"`` decodes at bf16 (``predict``,
``decode_beam_set`` and so ``cli.train``'s dev decode, ``cli.beam``) with
K1 eval, K5 and K6 in their bf16 mode; training at it is not ported, and
``train_epoch`` / ``eval_loss`` refuse it by name.

Not ported (ROADMAP.md queue 1): bf16 training, multi-step dispatch
(``steps_per_dispatch``), the device feature cache, narrow transfer
dtypes, rematerialisation and data parallelism.
"""

import collections
import itertools
import os
import threading
import time

import numpy as np
import torch

from ast_tpu_torch.config import Config
from ast_tpu_torch.checkpoint import (
    checkpoint_path, flatten, latest_checkpoint, load_checkpoint,
    save_checkpoint, unflatten)
from ast_tpu_torch.data.dataloader import make_dataloader
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.ops.bf16 import parse_dtype
from ast_tpu_torch.ops.fbank import MfccExtractor
from ast_tpu_torch.ops.fused_infer import (
    require_bf16_variant, require_train_dtype, require_train_variant)
from ast_tpu_torch.params import torch_device, tree_map
from ast_tpu_torch.train.optimizer import (
    build_optimizer, tree_leaves, tree_unflatten)
from ast_tpu_torch.utils.profiling import StepTimer
from ast_tpu_torch.utils.seeding import stable_seed

INFLIGHT = "seq2seq_inflight.npz"


def to_numpy(tree):
    """Torch tree -> numpy tree.  bfloat16 leaves (AMSGrad's first moment
    under ``moments_dtype``), which NPZ cannot hold, go up to float32 as
    ``ast_tpu``'s checkpoints store them; :func:`merge` casts them back."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(conv, tree)


def merge(template, loaded, what):
    """``loaded`` (numpy tree) as torch tensors in ``template``'s place:
    the same flat keys and shapes, each leaf on its template leaf's
    device in its dtype, or ValueError."""
    want = flatten(template, leaf=lambda t: t)
    got = flatten(loaded)
    if sorted(want) != sorted(got):
        raise ValueError(f"{what}: keys differ from this model's "
                         f"({sorted(set(want) ^ set(got))[:4]} ...)")
    out = {}
    for k, t in want.items():
        if not torch.is_tensor(t):      # a list length or empty-dict mark
            out[k] = got[k]
            continue
        if tuple(t.shape) != np.shape(got[k]):
            raise ValueError(f"{what}: {k} has shape {np.shape(got[k])}, "
                             f"not {tuple(t.shape)}")
        out[k] = torch.tensor(np.asarray(got[k])).to(
            device=t.device, dtype=t.dtype)
    return unflatten(out)


class Prefetcher:
    """Run ``prepare`` (host-to-device staging) over the items of ``gen``
    on ``workers`` threads, at most ``depth`` items ahead of the consumer,
    and yield the results in the generator's exact order.  The generator
    (batch assembly) is pulled under a lock, one item at a time; only
    ``prepare`` runs concurrently.  An exception of the generator or of
    ``prepare`` is raised at its item's place in the stream."""

    def __init__(self, gen, prepare, depth=2, workers=1):
        self._closed = False
        self._err = None
        self._buf = {}
        self._next_read = 0        # next index to pull from gen
        self._next_yield = 0       # next index the consumer gets
        self._done_reading = False
        self._cond = threading.Condition()
        self._gen = iter(gen)
        self._prepare = prepare
        self._depth = max(int(depth), int(workers))
        self.threads = [threading.Thread(target=self._worker, daemon=True)
                        for _ in range(max(1, int(workers)))]
        for t in self.threads:
            t.start()

    def _worker(self):
        while True:
            with self._cond:
                while (not self._closed and not self._done_reading
                       and self._next_read - self._next_yield
                       >= self._depth):
                    self._cond.wait()
                if self._closed or self._done_reading:
                    return
                idx = self._next_read
                try:
                    item = next(self._gen)
                except StopIteration:
                    self._done_reading = True
                    self._cond.notify_all()
                    return
                except BaseException as e:  # raised again by the consumer
                    self._err = e
                    self._done_reading = True
                    self._cond.notify_all()
                    return
                self._next_read += 1
            try:
                out = self._prepare(item)
            except BaseException as e:      # raised again by the consumer
                out = e
            with self._cond:
                self._buf[idx] = out
                self._cond.notify_all()

    def __iter__(self):
        try:
            while True:
                with self._cond:
                    while (self._next_yield not in self._buf
                           and not (self._done_reading
                                    and self._next_yield >= self._next_read)
                           and not self._closed):
                        self._cond.wait()
                    if self._closed:
                        return
                    if self._next_yield in self._buf:
                        item = self._buf.pop(self._next_yield)
                        self._next_yield += 1
                        self._cond.notify_all()
                    else:               # stream drained
                        if self._err is not None:
                            err, self._err = self._err, None
                            raise err
                        return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the consumer left the stream (preemption, an exception, an
            # early break): release the workers
            self.close()

    def close(self):
        """Release the workers and drop anything buffered."""
        with self._cond:
            self._closed = True
            self._buf.clear()
            self._cond.notify_all()
        for t in self.threads:
            if t.is_alive():
                t.join(timeout=1.0)


class PreemptedError(RuntimeError):
    """Raised by ``train_epoch`` after it wrote an in-flight snapshot
    because preemption was requested.  The next run resumes the same
    epoch at the same batch."""


class NN:
    """Model, optimizer and data of one experiment directory."""

    def __init__(self, cfg_path, device="cuda", ckpt=None):
        """``ckpt``: load exactly this checkpoint file instead of the
        latest epoch's; the in-flight snapshot is then not looked at, and
        ``max_epoch`` is 0."""
        self.device = torch_device(device)
        self.cfg = Config(cfg_path)
        self.model_dir = self.cfg.model["model_dir"]
        self.mcfg = self.cfg.model
        tcfg = self.cfg.train
        require_train_variant(tcfg)
        # the dtype of decoding (ast_tpu's NN.compute_dtype); training
        # refuses bf16 where it starts (require_train_dtype)
        self.compute_dtype = parse_dtype(tcfg["extras"].get("compute_dtype"))
        require_bf16_variant(self.mcfg, self.compute_dtype)
        ignored = [name for name, on in (
            ("extras.remat", tcfg["extras"].get("remat", False)),
            ("parallel", any(tcfg["parallel"].get(k, d) != d for k, d in
                             (("data_axis", 0), ("model_axis", 1)))),
        ) if on]
        if ignored:
            print(f"set and ignored (not ported, see ROADMAP.md queue 1): "
                  f"{', '.join(ignored)}", flush=True)
        self.seed = stable_seed(tcfg["seed"], bits=31)
        self.data_loader = make_dataloader(tcfg, self.model_dir)
        # features: wav -- the loader ships audio, the step featurizes
        self.wav_mode = tcfg["data"].get("features", "precomputed") == "wav"
        self._mfcc = (MfccExtractor(self.data_loader.mfcc_cfg, self.device)
                      if self.wav_mode else None)
        self.params, self.state = seq2seq.init_model(
            self.mcfg, seed=self.seed, device=self.device)
        self.opt, self.opt_state = build_optimizer(
            tcfg["optimizer"], self.params, seed=self.seed)
        self.max_epoch = 0
        explicit_ckpt = ckpt
        if explicit_ckpt is None:
            ckpt, epoch = latest_checkpoint(self.model_dir)
        else:
            epoch = 0
        if ckpt is not None:
            self._load_snapshot(load_checkpoint(ckpt))
            self.max_epoch = epoch
        self.loaded_ckpt = ckpt     # the file loaded, None = fresh init

        # a newer mid-epoch snapshot wins over the latest epoch's file
        self.inflight_resume = None
        inflight = os.path.join(self.model_dir, INFLIGHT)
        if explicit_ckpt is None and os.path.exists(inflight):
            snap = load_checkpoint(inflight)
            extra = snap.get("extra") or {}
            in_epoch = int(extra.get("epoch", 0))
            in_step = int(extra.get("step", 0))
            in_g = int(extra.get("g", 1))
            if in_epoch >= 1 and in_epoch - 1 >= self.max_epoch:
                self._load_snapshot(snap)
                self.max_epoch = in_epoch - 1
                if in_step > 0 and in_g != 1:
                    # ast_tpu's stream at steps_per_dispatch = g is in
                    # another order: its position means nothing here
                    print(f"inflight snapshot was written with "
                          f"steps_per_dispatch={in_g}, which is not "
                          f"ported; restarting epoch {in_epoch} from the "
                          f"beginning", flush=True)
                elif in_step > 0:
                    self.inflight_resume = (in_epoch, in_step)

        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.train_log = os.path.join(self.model_dir, "train.log")
        self.dev_log = os.path.join(self.model_dir, "dev.log")
        self._preempt = False
        # tail batches pad to a repeated half of the batch size, kept a
        # multiple of 8 rows (ast_tpu on one device)
        self.tail_shrink = (8 if tcfg["extras"].get("shrink_tail_batches",
                                                    True) else 0)
        self.timer = StepTimer()

    def _load_snapshot(self, loaded):
        self.params = merge(self.params, loaded["params"], "params")
        if loaded.get("state") is not None:
            self.state = merge(self.state, loaded["state"], "state")
        if loaded.get("opt") is not None:
            try:
                self.opt_state = merge(self.opt_state, loaded["opt"], "opt")
            except ValueError as e:
                print(f"warning: optimizer state not restored ({e}); "
                      "restarting moments")

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _device_batch(self, batch, labels=True):
        """A host batch with ``X`` -- in wav mode ``audio``, ``cmvn_mean``
        and ``cmvn_std`` -- (and ``y`` with ``labels``) as tensors on the
        device: through pinned memory and an asynchronous copy on a card.
        A batch already there passes through."""
        speech = (("audio", "cmvn_mean", "cmvn_std") if self.wav_mode
                  else ("X",))
        if torch.is_tensor(batch[speech[0]]):
            return batch
        cuda = self.device.type == "cuda"

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if cuda:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=cuda)

        out = dict(batch, **{k: put(batch[k]) for k in speech})
        if labels:
            out["y"] = put(batch["y"]).long()
        return out

    def features(self, batch):
        """A device batch's features (B, T, D): its ``X``, or in wav mode
        its audio's MFCC normalised by each row's CMVN statistics."""
        if not self.wav_mode:
            return batch["X"]
        feats = self._mfcc(batch["audio"])
        return ((feats - batch["cmvn_mean"][:, None, :])
                / batch["cmvn_std"][:, None, :])

    def _prefetch(self, gen, labels):
        workers = max(1, int(self.cfg.train["extras"].get(
            "prefetch_workers", 2)))
        return Prefetcher(gen, lambda b: self._device_batch(b, labels),
                          depth=2 * workers, workers=workers)

    def _decode_pipeline_depth(self, heavy_outputs=False):
        """Decode batches kept in flight before the copy to the host that
        waits for the oldest: ``extras.decode_pipeline``; when unset 2,
        or 1 for ``heavy_outputs`` (beam attention histories)."""
        depth = self.cfg.train["extras"].get("decode_pipeline")
        if depth is None:
            return 1 if heavy_outputs else 2
        return max(1, int(depth))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def train_step(self, batch, seed):
        """One update from a batch (host or device); returns the loss (on
        device)."""
        tcfg = self.cfg.train
        extras = tcfg["extras"]
        batch = self._device_batch(batch)
        # featurized first: the draws take T from the features' shape
        X, y = self.features(batch), batch["y"]
        draws = seq2seq.make_draws(
            seed, X, y.shape[1] - 1, extras["teach_ratio"],
            extras["speech_noise"], random_out=extras["random_out"],
            vocab=self.mcfg["rnn_config"]["dec_vocab_size"],
            spec_cfg=tcfg["data"].get("spec_augment") or None,
            frame_len=batch.get("frame_len"))
        loss, new_state = seq2seq.forward_loss(
            self.params, self.state, self.mcfg, X, y,
            float(batch["n_real"]), draws,
            label_smoothing=extras["label_smoothing"])
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            updates, self.opt_state = self.opt.update(
                tree_unflatten(self.params, grads), self.opt_state,
                self.params)
            torch._foreach_add_(leaves, tree_leaves(updates))
        self.state = new_state
        return loss.detach()

    def add_weight_noise(self, epoch):
        """``extras.weight_noise_*``: N(mean, sigma) added to the LSTM
        weights and the decoder embedding, drawn from the run's seed and
        the epoch."""
        extras = self.cfg.train["extras"]
        gen = torch.Generator().manual_seed(
            stable_seed(f"{self.seed}|weight_noise|{epoch}"))
        noise = [torch.randn(p.shape, generator=gen)
                 for p in seq2seq.weight_noise_targets(self.params)]
        seq2seq.add_weight_noise(self.params, extras["weight_noise_mean"],
                                 extras["weight_noise_sigma"], noise)

    def train_epoch(self, set_key, epoch=0):
        """One epoch over ``set_key`` in the loader's order for ``epoch``,
        or the rest of it after an in-flight snapshot of this epoch;
        returns the mean over the batches trained of loss / real rows."""
        tcfg = self.cfg.train
        require_train_dtype(tcfg)
        skip = 0
        if self.inflight_resume and self.inflight_resume[0] == epoch:
            skip = self.inflight_resume[1]
            self.inflight_resume = None
        # once an epoch, and the noise stays in the weights: a snapshot of
        # this epoch already holds it
        wn_iter = tcfg["extras"].get("weight_noise_iter", 0)
        if wn_iter and epoch >= wn_iter and not skip:
            self.add_weight_noise(epoch)

        gen = self.data_loader.get_batch(
            tcfg["batch_size"], set_key, train=True, labels=True,
            curriculum=tcfg.get("curriculum", False), epoch=epoch,
            tail_shrink=self.tail_shrink)
        if skip:
            gen = itertools.islice(gen, skip, None)
        ckpt_steps = tcfg.get("checkpoint_steps", 0)
        losses, sizes = [], []
        consumed = last_snap = skip
        t0 = time.perf_counter()
        for batch in self._prefetch(gen, labels=True):
            # the step's seed is the batch's place in the whole epoch
            losses.append(self.train_step(
                batch, stable_seed(f"{self.seed}|{epoch}|{consumed}")))
            sizes.append(max(1, len(batch["utts"])))
            consumed += 1
            if ckpt_steps and consumed - last_snap >= ckpt_steps:
                self.save_inflight(epoch, consumed)
                last_snap = consumed
            if self._preempt:
                self.save_inflight(epoch, consumed)
                raise PreemptedError(
                    f"preempted: epoch {epoch} snapshotted after "
                    f"{consumed} batches")
        if ckpt_steps:
            # the epoch is complete: "epoch + 1 has consumed 0 batches"
            self.save_inflight(epoch + 1, 0)
        if not losses:
            return 0.0
        vals = torch.stack(losses).cpu().numpy()     # the epoch's one sync
        self.timer.add(time.perf_counter() - t0, sum(sizes), len(vals))
        return float(sum(v / s for v, s in zip(vals, sizes)) / len(vals))

    def request_preempt(self):
        """Ask the running epoch to snapshot and stop at the next batch
        boundary (safe in a signal handler: it only sets a flag)."""
        self._preempt = True

    def preempt_pending(self):
        """Whether preemption was requested: the train CLI asks between
        an epoch's phases."""
        return self._preempt

    def save_inflight(self, epoch, step):
        """The mid-epoch snapshot, written atomically; ``g`` is
        ``ast_tpu``'s steps per dispatch, always 1 here."""
        save_checkpoint(
            os.path.join(self.model_dir, INFLIGHT), to_numpy(self.params),
            to_numpy(self.state), to_numpy(self.opt_state),
            extra={"epoch": np.int64(epoch), "step": np.int64(step),
                   "g": np.int64(1)})

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def eval_loss(self, set_key):
        """Teacher-forced loss on a split, nothing updated (K1 eval, K3
        with every step forced and no dropout): the mean over batches of
        loss / real rows.  Not at bf16 (the dev loss is training's)."""
        tcfg = self.cfg.train
        require_train_dtype(tcfg)
        gen = self.data_loader.get_batch(
            tcfg["batch_size"], set_key, train=False, labels=True,
            tail_shrink=self.tail_shrink)
        losses, sizes = [], []
        with torch.no_grad():
            enc_w = seq2seq.encoder_weights(self.params)
            for batch in self._prefetch(gen, labels=True):
                loss, _ = seq2seq.forward_loss(
                    self.params, self.state, self.mcfg, self.features(batch),
                    batch["y"], float(batch["n_real"]), train=False,
                    enc_w=enc_w)
                losses.append(loss)
                sizes.append(max(1, len(batch["utts"])))
        if not losses:
            return 0.0
        vals = torch.stack(losses).cpu().numpy()
        return float(sum(v / s for v, s in zip(vals, sizes)) / len(vals))

    def _decode_set(self, set_key, batch_size, decode, collect,
                    heavy_outputs=False):
        """Run ``decode(X)`` over a split's batches, keeping
        ``decode_pipeline`` of them in flight: the copy to the host waits
        for its batch, so ``collect(batch, output on the host)`` of one
        batch runs while the device decodes the next.  Outputs are
        collected in the batches' order."""
        inflight = collections.deque()

        def drain():
            batch, out = inflight.popleft()
            collect(batch, [a.cpu().numpy() for a in out])

        depth = self._decode_pipeline_depth(heavy_outputs)
        with torch.inference_mode():
            gen = self.data_loader.get_batch(
                batch_size, set_key, train=False, labels=False,
                tail_shrink=self.tail_shrink)
            for batch in self._prefetch(gen, labels=False):
                inflight.append((batch, decode(self.features(batch))))
                if len(inflight) >= depth:
                    drain()
            while inflight:
                drain()

    def predict(self, set_key):
        """Greedy-decode a split (K1 eval + K5, or their plain stages for
        a variant): [(utt, ids)] with each row's full ``max_pred``
        ids."""
        tcfg = self.cfg.train
        stop_limit = tcfg["data"]["max_pred"]
        preds = []
        with torch.inference_mode():     # once for the split
            w = seq2seq.decode_weights(self.params, self.compute_dtype)

        def decode(X):
            return seq2seq.predict_greedy(
                self.params, self.state, self.mcfg, X, stop_limit, w,
                compute_dtype=self.compute_dtype)[:1]

        def collect(batch, out):
            preds.extend(zip(batch["utts"],
                             out[0][:len(batch["utts"])].tolist()))

        self._decode_set(set_key, tcfg["batch_size"], decode, collect)
        return preds

    def decode_beam_set(self, set_key, N, K, batch_size=None,
                        save_attn=False):
        """Beam-decode a whole split (K1 eval + K6, or their plain stages
        for a variant).  Returns {utt: [(hyp_ids, score)]}: N hypotheses
        an utterance, ids from GO up to each hypothesis's length; with
        ``save_attn`` {utt: [(hyp_ids, score, attn_history)]},
        attn_history (len, T') float32, the attention of the step that
        produced each token (the GO row 0) -- the reference's beam
        entries -- from the plain frontier loop."""
        tcfg = self.cfg.train
        if batch_size is None:
            batch_size = tcfg["batch_size"]
        beam = beam_ops.make_beam_decoder(
            self.mcfg, N=N, K=K, stop_limit=tcfg["data"]["max_pred"],
            return_attn=save_attn, compute_dtype=self.compute_dtype)
        results = {}
        with torch.inference_mode():     # once for the split
            w = seq2seq.decode_weights(self.params, self.compute_dtype)

        def decode(X):
            return beam(self.params, self.state, X, w)

        def collect(batch, out):
            hyps, scores, lengths = out[:3]
            for j, utt in enumerate(batch["utts"]):
                entries = []
                for n in range(hyps.shape[1]):
                    n_tok = int(lengths[j, n])
                    e = (hyps[j, n, :n_tok].tolist(), float(scores[j, n]))
                    if save_attn:
                        e = e + (out[3][j, n, :n_tok],)
                    entries.append(e)
                results[utt] = entries

        self._decode_set(set_key, batch_size, decode, collect,
                         heavy_outputs=save_attn)
        return results

    def save(self, epoch):
        save_checkpoint(checkpoint_path(self.model_dir, epoch),
                        to_numpy(self.params), to_numpy(self.state),
                        to_numpy(self.opt_state))
