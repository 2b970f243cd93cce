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

``extras.compute_dtype: "bfloat16"`` trains and decodes at bf16 as
``ast_tpu`` does: ``train_epoch`` and ``eval_loss`` run
``forward_loss`` at bf16 (K1 train / eval, K2, K3, K4 in their bf16
mode), ``predict``, ``decode_beam_set`` and so ``cli.train``'s dev decode
and ``cli.beam`` decode with K1 eval, K5 and K6 at bf16; the parameters,
BN state, optimizer and checkpoints stay f32.  Every model variant, and
on the card a width the kernels' shape gate sends to the plain stages,
trains and decodes at bf16 too: its plain stages run ``ast_tpu``'s scan
path at its bf16 rounding points (``models.seq2seq``), beside the
kernel stages' bf16 modes.

The feed options of ``ast_tpu``'s trainer, each as it works there:

- ``extras.transfer_dtype`` ("bfloat16" / "float16"): training features
  cross to the card in that dtype, rounded on the host as
  ``ast_tpu``'s ``astype`` rounds (to nearest, ties to even), and the
  step widens them to f32 before any compute; eval and decode ship f32.
- ``extras.hbm_cache`` (with ``hbm_cache_dtype``): each split's
  features live on the device (:mod:`ast_tpu_torch.data.device_cache`);
  a train, eval or decode batch is a gather of cache rows times the
  frame-dropout mask, so only indices, the mask and targets cross per
  batch, and with an f32 cache every step is bit-equal to host feeding.
- ``extras.steps_per_dispatch`` = G: the epoch's stream is regrouped
  into runs of up to G same-bucket batches (the loader's
  ``group_runs``); a full run crosses as one stacked pinned copy a
  tensor and its G steps are issued back to back, shorter runs as single
  steps.  Step i of a run has the seed of the batch's place in the
  epoch, so the math is that of single steps over the grouped stream.
  Snapshots and the preemption check fire at run boundaries; an
  in-flight snapshot records G, and one of another G keeps its
  parameters and restarts its epoch.
- ``extras.remat``: ``forward_loss`` under
  ``torch.utils.checkpoint.checkpoint`` (non-reentrant), so its
  activations are recomputed in the backward instead of held across the
  loss; the draws are made before it, so the recompute repeats K1 train
  and K3 exactly and the gradients are bit-equal to a step without it.

Data parallelism (``train_cfg["parallel"]``, ``ast_tpu``'s mesh over
``torch.distributed``, :mod:`ast_tpu_torch.parallel`): one process a
card, started by ``torchrun`` or by the caller after
``parallel.init_distributed``.  ``data_axis`` (0: every process) is the
data axis; every rank builds the identical batch stream, keeps its rows
of each batch (``shard_batch``: only they cross to its card; the cache
of ``hbm_cache`` is whole on every rank) and runs the step on them with
its draws of the global batch's (``seq2seq.make_draws``): dropout hashes
global rows, BN takes the global batch's statistics, and the gradients
are summed over the ranks in one flat all-reduce before the optimizer,
so that parameters, optimizer and BN state stay bit-identical on every
rank.  Tail batches shrink to multiples of 8 rows a rank; the eval
streams are pinned (epoch 0) and ``eval_loss``, ``predict`` and
``decode_beam_set`` return the whole split on every rank; preemption is
agreed over the ranks every ``preempt_sync_steps`` batches; only rank 0
writes.  One process makes no mesh and issues no collective.

Vocab tensor parallelism (``parallel.model_axis`` M > 1, ``ast_tpu``'s
``model`` axis): the world is ``data x M`` ranks, rank r at data index
``r // M``.  The parameters, BN state and optimizer state are built,
loaded or resumed whole, broadcast from rank 0, then sliced
(``parallel.shard_params``): each rank of a model group keeps 1/M of the
vocabulary of ``dec/out_w``, ``dec/out_b``, ``dec/embed`` and their
moments.  A step gathers them for the kernels and keeps the loss
logits sharded (``seq2seq.forward_loss``); the gradients, the epoch's
losses and the eval outputs are summed or gathered over the data group
only; the optimizer's global norm and gradient noise are the whole
leaves' (``train.optimizer``).  ``eval_loss``, ``predict`` and
``decode_beam_set`` gather the weights once a call; ``save`` and the
in-flight snapshot gather the shards on every rank, and rank 0 writes
one process's flat NPZ, so a checkpoint of any ``model_axis`` (or of
``ast_tpu``) loads at any other.
"""

import collections
import itertools
import math
import os
import threading
import time

import numpy as np
import torch
import torch.utils.checkpoint

from ast_tpu_torch.config import Config
from ast_tpu_torch.checkpoint import (
    checkpoint_path, flatten, latest_checkpoint, load_checkpoint,
    save_checkpoint, unflatten)
from ast_tpu_torch.data.dataloader import make_dataloader
from ast_tpu_torch.data.device_cache import EpochFeatureCache, gather_batch
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.ops.bf16 import parse_dtype
from ast_tpu_torch.ops.fbank import MfccExtractor
from ast_tpu_torch.ops.fused_infer import require_train_variant
from ast_tpu_torch.parallel import (
    all_reduce_grads, all_reduce_sum, any_rank, gather_params, gather_rows,
    leaf_spec, make_mesh, replicate, shard_batch, shard_params)
from ast_tpu_torch.params import torch_device, tree_map
from ast_tpu_torch.train.optimizer import build_optimizer, tree_leaves
from ast_tpu_torch.utils.profiling import (
    StepTimer, adopt_span, armed, count, current_span, span)
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
    ``prepare`` is raised at its item's place in the stream.  Spans:
    ``feed.assemble`` (a pull of the generator) and ``feed.stage`` (one
    ``prepare``) on the workers, under the span the Prefetcher was made
    in; ``feed.wait`` where the consumer waits for its next item."""

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
        self._parent = current_span()
        self.threads = [threading.Thread(target=self._worker, daemon=True)
                        for _ in range(max(1, int(workers)))]
        for t in self.threads:
            t.start()

    def _worker(self):
        adopt_span(self._parent)
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
                    with span("feed.assemble"):
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
                with span("feed.stage"):
                    out = self._prepare(item)
            except BaseException as e:      # raised again by the consumer
                out = e
            with self._cond:
                self._buf[idx] = out
                self._cond.notify_all()

    def __iter__(self):
        try:
            while True:
                with span("feed.wait"), self._cond:
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


class CrossingGate:
    """Fires when a counter crosses a multiple of ``every``
    (``ast_tpu``'s): the batches consumed advance by runs of 1..G, so an
    exact ``consumed % every == 0`` could be stepped over until the
    epoch's end."""

    def __init__(self, every, start=0):
        self.every = max(1, int(every))
        self.last = start // self.every

    def crossed(self, consumed):
        q = consumed // self.every
        if q == self.last:
            return False
        self.last = q
        return True


def mesh_batch_size(batch_size):
    """The rows every batch has, which the data axis must divide: the
    batch size, or the gcd of per-bucket sizes (``ast_tpu``'s)."""
    if not isinstance(batch_size, dict):
        return int(batch_size)
    sizes = [int(batch_size[k]) for k in ("max", "med", "min")
             if k in batch_size]
    if not sizes:
        raise ValueError("batch_size dict must carry at least one of "
                         f"'max'/'med'/'min' (got keys {sorted(batch_size)})")
    return math.gcd(*sizes)


def _group_stream(gen, G):
    """Chunk a batch stream into runs of consecutive batches of one
    bucket and one row count, at most G long (``ast_tpu``'s
    ``_group_stream``; the loader's ``group_runs`` order makes full runs
    the common case).  Yields lists of 1..G host batches."""
    buf = []
    for b in gen:
        if buf and (b["bucket"] != buf[0]["bucket"]
                    or b["rows"] != buf[0]["rows"] or len(buf) == G):
            yield buf
            buf = []
        buf.append(b)
    if buf:
        yield buf


def _transfer_dtype(name):
    """``extras.transfer_dtype`` -> the dtype train features cross in
    (None: float32, as they are)."""
    if name not in ("float32", "bfloat16", "float16"):
        raise ValueError(f"extras.transfer_dtype={name!r}: use float32 | "
                         "bfloat16 | float16")
    return {"float32": None, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _count_frames(kind, batch, T):
    """The ``<kind>.frames_real`` (the rows' ``frame_len``) and
    ``<kind>.frames_padded`` (rows x T) counters of a batch, while the
    spans are armed."""
    frame_len = batch.get("frame_len")
    if armed() and frame_len is not None:
        count(f"{kind}.frames_real", int(np.sum(frame_len)))
        count(f"{kind}.frames_padded", len(frame_len) * int(T))


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
        extras = tcfg["extras"]
        require_train_variant(tcfg)
        # the dtype of training and decoding (ast_tpu's NN.compute_dtype)
        self.compute_dtype = parse_dtype(extras.get("compute_dtype"))
        # the (data, model) mesh over the process group (None: one
        # process)
        self.mesh = make_mesh(tcfg["parallel"],
                              batch_size=mesh_batch_size(tcfg["batch_size"]),
                              vocab=self.mcfg["rnn_config"]["dec_vocab_size"])
        # the feed options (the module docstring)
        self.transfer_dtype = _transfer_dtype(
            extras.get("transfer_dtype", "float32"))
        self.hbm_cache = bool(extras.get("hbm_cache", False))
        cache_dtype = extras.get("hbm_cache_dtype", "float32")
        if cache_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"extras.hbm_cache_dtype={cache_dtype!r}: "
                             "float32 | bfloat16")
        self.hbm_cache_dtype = parse_dtype(cache_dtype)
        self._hbm_caches = {}
        self.steps_per_dispatch = max(
            1, int(extras.get("steps_per_dispatch", 1)))
        self.remat = bool(extras.get("remat", False))
        # host-to-device bytes of the last train epoch's batches
        self.epoch_h2d_bytes = 0
        self.seed = stable_seed(tcfg["seed"], bits=31)
        self.data_loader = make_dataloader(tcfg, self.model_dir)
        # features: wav -- the loader ships audio, the step featurizes
        self.wav_mode = tcfg["data"].get("features", "precomputed") == "wav"
        self._mfcc = (MfccExtractor(self.data_loader.mfcc_cfg, self.device)
                      if self.wav_mode else None)
        self.params, self.state = seq2seq.init_model(
            self.mcfg, seed=self.seed, device=self.device)
        self.opt, self.opt_state = build_optimizer(
            tcfg["optimizer"], self.params, seed=self.seed, mesh=self.mesh)
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
                cfg_g = self.steps_per_dispatch
                if in_step > 0 and in_g != cfg_g:
                    # the grouped stream's order depends on G: a position
                    # in another G's stream names other batches
                    print(f"inflight snapshot was written with "
                          f"steps_per_dispatch={in_g} but the config "
                          f"says {cfg_g}; restarting epoch {in_epoch} "
                          f"from the beginning", flush=True)
                elif in_step > 0:
                    self.inflight_resume = (in_epoch, in_step)
        # every rank starts from rank 0's bytes, then keeps its vocab
        # shards
        replicate((self.params, self.state, self.opt_state), self.mesh)
        self.params = shard_params(self.params, self.mesh)
        self.opt_state = shard_params(self.opt_state, self.mesh)
        self.opt.reset(self.opt_state)

        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.train_log = os.path.join(self.model_dir, "train.log")
        self.dev_log = os.path.join(self.model_dir, "dev.log")
        self._preempt = False
        # tail batches pad to a repeated half of the batch size, kept a
        # multiple of 8 rows a rank (ast_tpu's 8 x data shards)
        shards = 1 if self.mesh is None else self.mesh.data
        self.tail_shrink = (8 * shards if tcfg["extras"].get(
            "shrink_tail_batches", True) else 0)
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
    def _speech_keys(self, batch):
        """The keys of a host batch's speech: cache rows and dropout
        mask (index mode), audio and CMVN statistics (wav mode), or
        ``X``."""
        if "rows_idx" in batch:
            return ("rows_idx", "drop_mask")
        if self.wav_mode:
            return ("audio", "cmvn_mean", "cmvn_std")
        return ("X",)

    def _host_tensors(self, arrays, labels, narrow):
        """Host arrays -> CPU tensors to copy: ``y`` as it is, ``X``
        rounded to ``transfer_dtype`` when ``narrow`` (train features
        only, never token ids), the rest as they are."""
        out = {k: torch.from_numpy(np.ascontiguousarray(a))
               for k, a in arrays.items() if labels or k != "y"}
        X = out.get("X")
        if (narrow and self.transfer_dtype is not None and X is not None
                and X.is_floating_point()):
            out["X"] = X.to(self.transfer_dtype)
        return out

    def _put(self, tensors):
        """CPU tensors -> the device: through pinned memory and an
        asynchronous copy on a card.  Returns (tensors, bytes copied)."""
        cuda = self.device.type == "cuda"
        out, nbytes = {}, 0
        for k, t in tensors.items():
            nbytes += t.numel() * t.element_size()
            if cuda:
                t = t.pin_memory()
            t = t.to(self.device, non_blocking=cuda)
            out[k] = t.long() if k == "y" else t
        count("feed.h2d_bytes", nbytes)
        return out, nbytes

    def _device_batch(self, batch, labels=True, narrow=False, cache=None):
        """A host batch with its speech (:meth:`_speech_keys`) and, with
        ``labels``, ``y`` as tensors on the device, this rank's rows of
        them under a mesh (``utts``, ``n_real`` and ``frame_len`` stay
        the global batch's); ``narrow``: ``X`` in ``transfer_dtype``
        (train batches); ``cache``: the ``EpochFeatureCache`` an
        index-mode batch gathers from.  The bytes copied are under
        ``h2d_bytes``.  A batch already there passes through."""
        keys = self._speech_keys(batch)
        if torch.is_tensor(batch[keys[0]]):
            return batch
        arrays = shard_batch({k: batch[k] for k in keys + ("y",)
                              if k in batch}, self.mesh)
        dev, nbytes = self._put(self._host_tensors(arrays, labels, narrow))
        out = dict(batch, h2d_bytes=nbytes, **dev)
        if cache is not None:
            out["cache"] = cache.bucket_array(batch["bucket"])
        return out

    def _device_run(self, batches, cache=None):
        """A run of train batches (:func:`_group_stream`) on the device:
        a full run of ``steps_per_dispatch`` > 1 as one stacked copy a
        tensor, split into its steps' batches (``ast_tpu``'s
        ``_device_group``), any other as single batches.  Returns
        (step batches, bytes copied)."""
        if len(batches) < max(2, self.steps_per_dispatch):
            steps = [self._device_batch(b, True, narrow=True, cache=cache)
                     for b in batches]
            return steps, sum(b["h2d_bytes"] for b in steps)
        keys = self._speech_keys(batches[0]) + ("y",)
        stacked = shard_batch({k: np.stack([b[k] for b in batches])
                               for k in keys}, self.mesh, axis=1)
        dev, nbytes = self._put(self._host_tensors(stacked, True, True))
        steps = []
        for i, b in enumerate(batches):
            step = dict(b, **{k: t[i] for k, t in dev.items()})
            if cache is not None:
                step["cache"] = cache.bucket_array(b["bucket"])
            steps.append(step)
        return steps, nbytes

    def features(self, batch):
        """A device batch's features (B, T, D) f32: its ``X`` (widened
        from ``transfer_dtype``), the cache's rows times the dropout mask
        (index mode), or in wav mode its audio's MFCC normalised by each
        row's CMVN statistics."""
        if "rows_idx" in batch:
            return gather_batch(batch["cache"], batch["rows_idx"],
                                batch["drop_mask"])
        if self.wav_mode:
            feats = self._mfcc(batch["audio"])
            return ((feats - batch["cmvn_mean"][:, None, :])
                    / batch["cmvn_std"][:, None, :])
        X = batch["X"]
        return X.float() if X.dtype in (torch.bfloat16, torch.float16) else X

    def _prefetch(self, gen, prepare):
        # one worker a rank when several processes share the host's cores
        workers = 1 if self.mesh is not None else max(1, int(
            self.cfg.train["extras"].get("prefetch_workers", 2)))
        return Prefetcher(gen, prepare, depth=2 * workers, workers=workers)

    def _cache(self, set_key):
        """With ``hbm_cache``, the split's device feature cache, built at
        its first use; else None."""
        if self.hbm_cache and set_key not in self._hbm_caches:
            cache = EpochFeatureCache(self.data_loader, set_key,
                                      self.device, self.hbm_cache_dtype)
            print(f"hbm_cache[{set_key}]: {cache.nbytes / 1e6:.0f} MB "
                  f"resident", flush=True)
            self._hbm_caches[set_key] = cache
        return self._hbm_caches.get(set_key)

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
        device; under a mesh this rank's share of it).  Spans:
        ``train.step``, inside it ``train.draws``, ``train.forward``,
        ``train.backward`` (with the gradients' all-reduce) and
        ``train.optimizer``."""
        with span("train.step", bucket=batch.get("bucket")):
            return self._train_step(batch, seed)

    def _train_step(self, batch, seed):
        tcfg = self.cfg.train
        extras = tcfg["extras"]
        batch = self._device_batch(batch, narrow=True)
        with span("train.draws"):
            # featurized first: the draws take T from the features' shape
            X, y = self.features(batch), batch["y"]
            draws = seq2seq.make_draws(
                seed, X, y.shape[1] - 1, extras["teach_ratio"],
                extras["speech_noise"], random_out=extras["random_out"],
                vocab=self.mcfg["rnn_config"]["dec_vocab_size"],
                spec_cfg=tcfg["data"].get("spec_augment") or None,
                frame_len=batch.get("frame_len"), mesh=self.mesh)
        _count_frames("train", batch, X.shape[1])

        def loss_fn():
            return seq2seq.forward_loss(
                self.params, self.state, self.mcfg, X, y,
                float(batch["n_real"]), draws,
                label_smoothing=extras["label_smoothing"],
                compute_dtype=self.compute_dtype, mesh=self.mesh)

        with span("train.forward"):
            if self.remat:
                # the backward recomputes the forward from its inputs and
                # the draws, kernel for kernel
                loss, new_state = torch.utils.checkpoint.checkpoint(
                    loss_fn, use_reentrant=False)
            else:
                loss, new_state = loss_fn()
        leaves = tree_leaves(self.params)
        with span("train.backward"):
            grads = all_reduce_grads(torch.autograd.grad(loss, leaves),
                                     self.mesh)
        with span("train.optimizer"), torch.no_grad():
            self.opt.apply_(grads, self.opt_state, leaves)
        self.state = new_state
        return loss.detach()

    def add_weight_noise(self, epoch):
        """``extras.weight_noise_*``: N(mean, sigma) added to the LSTM
        weights and the decoder embedding, drawn from the run's seed and
        the epoch."""
        extras = self.cfg.train["extras"]
        gen = torch.Generator().manual_seed(
            stable_seed(f"{self.seed}|weight_noise|{epoch}"))
        # under a model axis a vocab-laid target is drawn whole, then
        # sliced
        noise = [torch.randn(p.shape, generator=gen) if self.mesh is None
                 else self.mesh.shard(torch.randn(self.mesh.full_shape(
                     p.shape, leaf_spec(path)), generator=gen),
                     leaf_spec(path))
                 for path, p in seq2seq.weight_noise_targets(self.params)]
        seq2seq.add_weight_noise(self.params, extras["weight_noise_mean"],
                                 extras["weight_noise_sigma"], noise)

    def train_epoch(self, set_key, epoch=0):
        """One epoch over ``set_key`` in the loader's order for ``epoch``
        (grouped into runs at ``steps_per_dispatch``), or the rest of it
        after an in-flight snapshot of this epoch; returns the mean over
        the batches trained of loss / real rows.  Spans: ``train.epoch``
        around it all, ``train.loss_sync`` around its one copy of the
        losses to the host."""
        with span("train.epoch", epoch=epoch):
            return self._train_epoch(set_key, epoch)

    def _train_epoch(self, set_key, epoch):
        tcfg = self.cfg.train
        cache = self._cache(set_key)
        skip = 0
        if self.inflight_resume and self.inflight_resume[0] == epoch:
            skip = self.inflight_resume[1]
            self.inflight_resume = None
        # once an epoch, and the noise stays in the weights: a snapshot of
        # this epoch already holds it
        wn_iter = tcfg["extras"].get("weight_noise_iter", 0)
        if wn_iter and epoch >= wn_iter and not skip:
            self.add_weight_noise(epoch)

        G = self.steps_per_dispatch
        gen = self.data_loader.get_batch(
            tcfg["batch_size"], set_key, train=True, labels=True,
            curriculum=tcfg.get("curriculum", False), epoch=epoch,
            group_runs=G, tail_shrink=self.tail_shrink, index_cache=cache)
        if skip:
            gen = itertools.islice(gen, skip, None)
        ckpt_steps = tcfg.get("checkpoint_steps", 0)
        # several processes agree on the stop step, or the ones that run
        # on wait in the next step's collectives: their flags are OR-ed
        # every preempt_sync_steps batches, at the same batch on every
        # rank (ast_tpu's CrossingGate)
        gate = CrossingGate(tcfg["extras"].get("preempt_sync_steps",
                                               ckpt_steps or 8), start=skip)
        losses, sizes = [], []
        consumed = last_snap = skip
        self.epoch_h2d_bytes = 0
        t0 = time.perf_counter()
        # runs of G; single batches without _group_stream's look-ahead
        runs = self._prefetch(
            _group_stream(gen, G) if G > 1 else ([b] for b in gen),
            lambda run: self._device_run(run, cache))
        for steps, nbytes in runs:
            # issued back to back: no step waits for the device
            for i, batch in enumerate(steps):
                # the step's seed is the batch's place in the whole epoch
                losses.append(self.train_step(
                    batch, stable_seed(f"{self.seed}|{epoch}|{consumed + i}")))
                sizes.append(max(1, len(batch["utts"])))
            consumed += len(steps)
            self.epoch_h2d_bytes += nbytes
            if ckpt_steps and consumed - last_snap >= ckpt_steps:
                self.save_inflight(epoch, consumed)
                last_snap = consumed
            if self._preempt_agreed(gate, consumed):
                self.save_inflight(epoch, consumed)
                raise PreemptedError(
                    f"preempted: epoch {epoch} snapshotted after "
                    f"{consumed} batches")
        if ckpt_steps:
            # the epoch is complete: "epoch + 1 has consumed 0 batches"
            self.save_inflight(epoch + 1, 0)
        if not losses:
            return 0.0
        # the ranks' shares summed; the epoch's one sync
        with span("train.loss_sync"):
            vals = all_reduce_sum(torch.stack(losses),
                                  self.mesh).cpu().numpy()
        self.timer.add(time.perf_counter() - t0, sum(sizes), len(vals))
        return float(sum(v / s for v, s in zip(vals, sizes)) / len(vals))

    def _preempt_agreed(self, gate, consumed):
        """Whether the epoch stops after ``consumed`` batches: this
        process's request, or under a mesh any rank's, read when
        ``gate`` fires."""
        if self.mesh is None:
            return self._preempt
        return gate.crossed(consumed) and any_rank(self._preempt, self.mesh,
                                                   self.device)

    def request_preempt(self):
        """Ask the running epoch to snapshot and stop at the next batch
        boundary (safe in a signal handler: it only sets a flag)."""
        self._preempt = True

    def preempt_pending(self):
        """Whether preemption was requested, under a mesh on any rank
        (every rank asks at the same point): the train CLI asks between
        an epoch's phases."""
        return any_rank(self._preempt, self.mesh, self.device)

    @property
    def primary(self):
        """Whether this process writes logs and checkpoints (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def whole_params(self):
        """The parameters with every vocab shard gathered whole (no
        autograd; every rank calls it at the same point): ``params``
        itself without a model axis."""
        with torch.no_grad():
            return gather_params(self.params, self.mesh)

    def _snapshot(self):
        """(params, state, opt state) whole, as numpy trees: the shards
        gathered on every rank of the model group."""
        return (to_numpy(self.whole_params()), to_numpy(self.state),
                to_numpy(gather_params(self.opt_state, self.mesh)))

    def save_inflight(self, epoch, step):
        """The mid-epoch snapshot, written atomically (rank 0: every rank
        holds the same state, or its vocab shards of it); ``g`` is the
        steps per dispatch whose grouped stream ``step`` counts in."""
        snap = self._snapshot()
        if not self.primary:
            return
        save_checkpoint(
            os.path.join(self.model_dir, INFLIGHT), *snap,
            extra={"epoch": np.int64(epoch), "step": np.int64(step),
                   "g": np.int64(self.steps_per_dispatch)})

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _eval_epoch(self):
        """The loader's epoch for an eval stream: pinned under a mesh, so
        that every rank builds the identical stream (else the loader's
        running generator)."""
        return None if self.mesh is None else 0

    def eval_loss(self, set_key):
        """Teacher-forced loss on a split, nothing updated (K1 eval, K3
        with every step forced and no dropout): the mean over batches of
        loss / real rows, at ``compute_dtype`` (under a mesh the ranks'
        shares summed)."""
        tcfg = self.cfg.train
        cache = self._cache(set_key)
        gen = self.data_loader.get_batch(
            tcfg["batch_size"], set_key, train=False, labels=True,
            epoch=self._eval_epoch(), tail_shrink=self.tail_shrink,
            index_cache=cache)
        losses, sizes = [], []
        params = self.whole_params()
        with torch.no_grad():
            enc_w = seq2seq.encoder_weights(params, self.compute_dtype)
            for batch in self._prefetch(
                    gen, lambda b: self._device_batch(b, True, cache=cache)):
                loss, _ = seq2seq.forward_loss(
                    params, self.state, self.mcfg, self.features(batch),
                    batch["y"], float(batch["n_real"]), train=False,
                    enc_w=enc_w, compute_dtype=self.compute_dtype)
                losses.append(loss)
                sizes.append(max(1, len(batch["utts"])))
        if not losses:
            return 0.0
        vals = all_reduce_sum(torch.stack(losses), self.mesh).cpu().numpy()
        return float(sum(v / s for v, s in zip(vals, sizes)) / len(vals))

    def _decode_set(self, set_key, batch_size, decode, collect,
                    heavy_outputs=False):
        """Run ``decode(X)`` over a split's batches, keeping
        ``decode_pipeline`` of them in flight: the copy to the host waits
        for its batch, so ``collect(batch, output on the host)`` of one
        batch runs while the device decodes the next.  Outputs are
        collected in the batches' order.  Under a mesh each rank decodes
        its rows and every rank collects the whole batch's outputs
        (``parallel.gather_rows``).  Spans: ``decode.issue`` (a batch's
        features and decode launched), ``decode.drain_wait`` (the copy
        to the host that waits for the oldest batch) and
        ``decode.collect``."""
        inflight = collections.deque()

        def drain():
            batch, out = inflight.popleft()
            with span("decode.drain_wait"):
                out = [a.cpu().numpy() for a in out]
            with span("decode.collect"):
                collect(batch, out)

        depth = self._decode_pipeline_depth(heavy_outputs)
        cache = self._cache(set_key)
        with torch.inference_mode():
            gen = self.data_loader.get_batch(
                batch_size, set_key, train=False, labels=False,
                epoch=self._eval_epoch(), tail_shrink=self.tail_shrink,
                index_cache=cache)
            for batch in self._prefetch(
                    gen, lambda b: self._device_batch(b, False, cache=cache)):
                with span("decode.issue", bucket=batch["bucket"]):
                    X = self.features(batch)
                    _count_frames("decode", batch, X.shape[1])
                    inflight.append((batch, gather_rows(decode(X),
                                                        self.mesh)))
                if len(inflight) >= depth:
                    drain()
            while inflight:
                drain()

    def predict(self, set_key):
        """Greedy-decode a split (K1 eval + K5, or their plain stages for
        a variant): [(utt, ids)] with each row's full ``max_pred``
        ids.  Spans: ``decode.pass`` around it, ``decode.setup`` around
        the weights' gathering and packing."""
        with span("decode.pass", set=set_key):
            return self._predict(set_key)

    def _predict(self, set_key):
        tcfg = self.cfg.train
        stop_limit = tcfg["data"]["max_pred"]
        preds = []
        with span("decode.setup"):
            params = self.whole_params()
            with torch.inference_mode():     # once for the split
                w = seq2seq.decode_weights(params, self.compute_dtype)

        def decode(X):
            return seq2seq.predict_greedy(
                params, self.state, self.mcfg, X, stop_limit, w,
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
        entries -- from the plain frontier loop.  Spans: ``decode.pass``
        around it, ``decode.setup`` around the beam builder and the
        weights' gathering and packing."""
        with span("decode.pass", set=set_key, N=N, K=K):
            return self._decode_beam_set(set_key, N, K, batch_size,
                                         save_attn)

    def _decode_beam_set(self, set_key, N, K, batch_size, save_attn):
        tcfg = self.cfg.train
        if batch_size is None:
            batch_size = tcfg["batch_size"]
        results = {}
        with span("decode.setup"):
            beam = beam_ops.make_beam_decoder(
                self.mcfg, N=N, K=K, stop_limit=tcfg["data"]["max_pred"],
                return_attn=save_attn, compute_dtype=self.compute_dtype)
            params = self.whole_params()
            with torch.inference_mode():     # once for the split
                w = seq2seq.decode_weights(params, self.compute_dtype)

        def decode(X):
            return beam(params, self.state, X, w)

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
        """The epoch's checkpoint (rank 0; every rank gathers)."""
        snap = self._snapshot()
        if not self.primary:
            return
        save_checkpoint(checkpoint_path(self.model_dir, epoch), *snap)
