"""Bucketed, statically shaped batches: the counterpart of
``ast_tpu/data/dataloader.py`` (the port imports no module of
``ast_tpu``), numpy only.

The batch stream equals ``ast_tpu``'s element for element: the same
bucketing, the same RNGs derived from ``(seed, set_key, epoch)``, the same
shuffles, frame dropout (``zero_input``: ``int(rate * len)`` frames drawn
with replacement and zeroed), tail-batch shrinking, curriculum order and
per-bucket target lengths.  Every batch of a bucket has one shape: speech
padded to the bucket's frame width, targets ``[GO] + ids[:max_pred-2] +
[EOS]`` padded to the bucket's target length, and the batch padded with
all-zero / all-PAD rows.  In text-encoder mode (``enc_key`` other than
``"sp"``) the source is the utterance's ``enc_key`` tokens as int32 ids
(UNK for a word the vocabulary lacks), PAD-padded to the bucket's width
and bucketed by their count, which is the row's ``frame_len``.  The
Fisher loader reads a split's ``<set>.pack``
(:mod:`ast_tpu_torch.data.feature_pack`) when there is one; ``features:
wav`` takes :class:`ast_tpu_torch.data.wav_loader.WavDataLoader`.

Two options of ``get_batch`` feed the trainer's feed options:
``group_runs`` (``extras.steps_per_dispatch``) regroups the shuffled
batch order into runs of same-bucket batches (:func:`_group_bucket_runs`),
and ``index_cache`` (``extras.hbm_cache``) emits cache row indices and a
frame-dropout mask in place of the feature block, drawing the dropout
indices from the same stream as host assembly
(:class:`ast_tpu_torch.data.device_cache.EpochFeatureCache`).
"""

import collections
import os
import pickle
import random

import numpy as np

from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.data import buckets as prep_buckets
from ast_tpu_torch.data.feature_pack import FeaturePack
from ast_tpu_torch.detok import get_hyps
from ast_tpu_torch.utils.seeding import stable_seed


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _group_bucket_runs(batch_list, run_len):
    """Permute a shuffled [(utts, bucket)] list into runs of up to
    ``run_len`` consecutive same-bucket entries by pulling later
    same-bucket entries forward (first-seen bucket order kept).
    Deterministic in the input order; every entry appears once."""
    pending, order = {}, []
    for item in batch_list:
        pending.setdefault(item[1], collections.deque()).append(item)
        order.append(item[1])
    out = []
    for b in order:
        q = pending[b]
        for _ in range(run_len):
            if not q:
                break
            out.append(q.popleft())
    return out


class DataLoader:
    """Shared bucketing, batching and detokenisation."""

    def __init__(self, data_cfg, model_dir, seed="seed"):
        self.data_cfg = data_cfg
        self.model_dir = model_dir
        self.seed = seed
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.RandomState(stable_seed(seed, bits=32))
        with open(data_cfg["map_path"], "rb") as f:
            self.map = pickle.load(f)
        with open(data_cfg["vocab_path"], "rb") as f:
            self.vocab = pickle.load(f)
        with open(data_cfg["info_path"], "rb") as f:
            self.info = pickle.load(f)
        # speech buckets on frame counts, text-encoder mode on source
        # token counts
        self.enc_key = data_cfg.get("enc_key", "sp")
        self.text_mode = self.enc_key != "sp"
        self.buckets = prep_buckets.buckets_main(
            model_dir, data_cfg["buckets_num"], data_cfg["buckets_width"],
            key=self.enc_key, scale=data_cfg["train_scale"], seed="haha",
            info_dict=self.info)
        self.n_utts = {k: sum(len(b) for b in v["buckets"])
                       for k, v in self.buckets.items()}
        self._compute_target_lengths()

    def _compute_target_lengths(self):
        """Per-bucket decoder length: the most target tokens (+ GO + EOS)
        of any utterance in the bucket, rounded up to
        ``target_pad_multiple`` and capped at ``max_pred``."""
        dec_key = self.data_cfg["dec_key"]
        max_pred = self.data_cfg["max_pred"]
        mult = self.data_cfg.get("target_pad_multiple", 16)
        min_n = 1 if (self.data_cfg.get("limit_vocab", False)
                      and self.data_cfg.get("add_unk", False)) else 0
        self.target_len = {}
        for set_key, info in self.buckets.items():
            lens = [2] * info["num_b"]
            for b, bucket in enumerate(info["buckets"]):
                for u in bucket:
                    n = max(self._n_target_tokens(set_key, u, dec_key),
                            min_n)
                    lens[b] = max(lens[b], min(n + 2, max_pred))
            self.target_len[set_key] = [min(_round_up(l, mult), max_pred)
                                        for l in lens]

    def _n_target_tokens(self, set_key, utt, dec_key):
        entry = self.map.get(set_key, {}).get(utt)
        if entry is not None and dec_key in entry:
            return len(entry[dec_key])
        return int(self.info[set_key][utt].get(dec_key, 2))

    def _drop_frames(self, x, rate, np_rng):
        num_drop = int(rate * len(x))
        if num_drop > 0:
            mask = np.ones(len(x), dtype=np.float32)
            mask[np_rng.choice(np.arange(len(x)), size=num_drop)] = 0
            return x * mask[:, np.newaxis]
        return x

    def _load_speech(self, utt, set_key, max_sp):
        raise NotImplementedError

    def _bucket_batch_size(self, batch_size, b, num_b):
        """Flat int, or legacy per-bucket sizes {max, med, min} by bucket
        thirds."""
        if isinstance(batch_size, dict):
            if b < num_b // 3:
                return int(batch_size["max"])
            if b < (num_b * 2) // 3:
                return int(batch_size["med"])
            return int(batch_size["min"])
        return int(batch_size)

    @staticmethod
    def tail_rows(n, b_size, min_rows):
        """Smallest repeated half of ``b_size`` that holds ``n`` rows and
        stays a multiple of ``min_rows``."""
        B = b_size
        while B // 2 >= max(n, min_rows) and (B // 2) % min_rows == 0:
            B //= 2
        return B

    def get_batch(self, batch_size, set_key, train, labels=False,
                  pad_batch=True, curriculum=False, epoch=None,
                  group_runs=1, tail_shrink=0, _skip_speech=False,
                  index_cache=None):
        """Generator of batch dicts {"X": (B, T, D) f32 (text-encoder
        mode: (B, T) int32 ids), "y": (B, U) i32
        (with ``labels``), "utts", "n_real", "bucket", "rows",
        "frame_len"}; ``ast_tpu``'s ``get_batch``.

        ``group_runs`` > 1: the shuffled batch order regrouped into runs
        of up to that many same-bucket batches (:func:`_group_bucket_runs`),
        a deterministic permutation, so a prefix of the stream still
        names what an interrupted epoch consumed.  ``index_cache``: an
        ``EpochFeatureCache`` of this split; a batch then has ``X`` None
        and carries ``rows_idx`` (B,) int32 rows of
        ``index_cache.bucket_array(bucket)`` (padding rows its
        ``pad_row``) and ``drop_mask`` (B, T) uint8, 0 at the frames
        frame dropout zeroes, drawn from the same stream with the same
        counts as host assembly: the cache's rows times the mask are the
        host batch's ``X`` bit for bit.  ``_skip_speech``: no ``X``
        (``None``) and no frame dropout -- so no draw of the dropout RNG
        -- and ``"X_rows"``: B; the raw-audio loader assembles its own
        speech."""
        if epoch is not None:
            tag = f"{self.seed}|{set_key}|{epoch}"
            py_rng = random.Random(tag)
            np_rng = np.random.RandomState(stable_seed(tag, bits=32))
        else:
            py_rng, np_rng = self.py_rng, self.np_rng
        num_b = self.buckets[set_key]["num_b"]
        width_b = self.buckets[set_key]["width_b"]
        max_sp = (num_b + 1) * width_b

        batch_list = []
        for b, bucket in enumerate(self.buckets[set_key]["buckets"]):
            b_size = self._bucket_batch_size(batch_size, b, num_b)
            bucket = list(bucket)
            py_rng.shuffle(bucket)
            for i in range(0, len(bucket), b_size):
                batch_list.append((bucket[i:i + b_size], b))
        if not curriculum:
            py_rng.shuffle(batch_list)
        if group_runs > 1:
            batch_list = _group_bucket_runs(batch_list, group_runs)

        rate = self.data_cfg.get("zero_input", 0)
        drop = train and rate > 0 and "train" in set_key
        for utts, b in batch_list:
            T = max_sp if b == num_b - 1 else (b + 1) * width_b
            b_size = self._bucket_batch_size(batch_size, b, num_b)
            B = b_size if pad_batch else len(utts)
            if pad_batch and tail_shrink > 0 and len(utts) < b_size:
                B = self.tail_rows(len(utts), b_size, tail_shrink)
            frame_len = np.zeros((B,), dtype=np.int32)
            X = rows_idx = drop_mask = None
            if index_cache is not None and not _skip_speech:
                # _drop_frames' draws over the length host assembly loads
                rows_idx = np.full((B,), index_cache.pad_row(b),
                                   dtype=np.int32)
                drop_mask = np.ones((B, T), dtype=np.uint8)
                for j, u in enumerate(utts):
                    rows_idx[j] = index_cache.row_of[u]
                    L = min(index_cache.true_len[u], max_sp)
                    num_drop = int(rate * L) if drop else 0
                    if num_drop > 0:
                        drop_mask[j, np_rng.choice(np.arange(L),
                                                   size=num_drop)] = 0
                    frame_len[j] = min(L, T)
            elif self.text_mode and not _skip_speech:
                w2i = self.vocab[self.enc_key]["w2i"]
                X = np.full((B, T), SYMBOLS.PAD_ID, dtype=np.int32)
                for j, u in enumerate(utts):
                    ids = [w2i.get(w, SYMBOLS.UNK_ID)
                           for w in self.map[set_key][u][self.enc_key]][:T]
                    X[j, :len(ids)] = ids
                    frame_len[j] = len(ids)
            elif not _skip_speech:
                feats = [self._load_speech(u, set_key, max_sp)
                         for u in utts]
                X = np.zeros((B, T, feats[0].shape[1]), dtype=np.float32)
                for j, x in enumerate(feats):
                    if drop:
                        x = self._drop_frames(x, rate, np_rng)
                    X[j, :len(x)] = x
                    frame_len[j] = min(len(x), T)
            batch = {"X": X, "utts": list(utts), "n_real": len(utts),
                     "bucket": b, "rows": B, "frame_len": frame_len}
            if rows_idx is not None:
                batch["rows_idx"], batch["drop_mask"] = rows_idx, drop_mask
            if _skip_speech:
                batch["X_rows"] = B
            if labels:
                batch["y"] = self._targets(set_key, utts, b, B)
            yield batch

    def _targets(self, set_key, utts, b, B):
        data = self.data_cfg
        dec_key, max_pred = data["dec_key"], data["max_pred"]
        y = np.full((B, self.target_len[set_key][b]), SYMBOLS.PAD_ID,
                    dtype=np.int32)
        limit_vocab = data.get("limit_vocab", False)
        w2i = self.vocab["w2i"] if limit_vocab else self.vocab[dec_key]["w2i"]
        for j, u in enumerate(utts):
            toks = self.map[set_key][u][dec_key]
            if limit_vocab:
                ids = [w2i[w] for w in toks if w in w2i]
                if not ids and data.get("add_unk", False):
                    ids = [SYMBOLS.UNK_ID]
            else:
                ids = [w2i.get(w, SYMBOLS.UNK_ID) for w in toks]
            y_ids = [SYMBOLS.GO_ID] + ids[:max_pred - 2] + [SYMBOLS.EOS_ID]
            y[j, :len(y_ids)] = y_ids
        return y

    @property
    def dec_i2w(self):
        """The decoder-side id -> token table (limit_vocab-aware)."""
        return (self.vocab["i2w"] if self.data_cfg.get("limit_vocab", False)
                else self.vocab[self.data_cfg["dec_key"]]["i2w"])

    def get_hyps(self, preds):
        """``[(utt, ids)]`` -> ``{utt: [word, ...]}`` (specials dropped
        wherever they occur, BPE joiners merged)."""
        return get_hyps(preds, self.dec_i2w, self.data_cfg["dec_key"])


class FisherDataLoader(DataLoader):
    """Fisher: per-utterance ``.npy`` features on disk, cached in RAM
    after the first read (``cache_features``); or, when
    ``<speech_path>/<set_key>.pack`` exists (``prep_data
    pack-features``), the split's rows served from that one
    memory-mapped file."""

    def __init__(self, data_cfg, model_dir, seed="seed",
                 cache_features=True):
        super().__init__(data_cfg, model_dir, seed)
        # the host feature cache; off while a device cache reads the split
        self.cache_features = cache_features
        self._cache = {}
        self._packs = {}

    def _pack_for(self, set_key):
        if set_key not in self._packs:
            path = os.path.join(self.data_cfg["speech_path"],
                                f"{set_key}.pack")
            self._packs[set_key] = (FeaturePack(path)
                                    if os.path.exists(path) else None)
        return self._packs[set_key]

    def _load_speech(self, utt, set_key, max_sp):
        pack = self._pack_for(set_key)
        if pack is not None and utt in pack:
            return pack.get(utt, max_rows=max_sp)
        key = (set_key, utt)
        if key in self._cache:
            return self._cache[key]
        sp_path = os.path.join(self.data_cfg["speech_path"], set_key)
        path = os.path.join(sp_path, f"{utt}.npy")
        if not os.path.exists(path):
            path = os.path.join(sp_path, utt.split("_", 1)[0], f"{utt}.npy")
        x = np.load(path)[:max_sp].astype(np.float32)
        if self.cache_features:
            self._cache[key] = x
        return x


class GlobalPhoneDataLoader(DataLoader):
    """GlobalPhone: all features in one pickled dict
    (``speech_path`` -> {set_key: {utt: (T, D) array}})."""

    def __init__(self, data_cfg, model_dir, seed="seed"):
        super().__init__(data_cfg, model_dir, seed)
        with open(data_cfg["speech_path"], "rb") as f:
            self.speech_data = pickle.load(f)

    def _load_speech(self, utt, set_key, max_sp):
        return np.asarray(self.speech_data[set_key][utt][:max_sp],
                          dtype=np.float32)


def make_dataloader(train_cfg, model_dir):
    """Loader by ``data.dataloader`` ("fisher" or "globalphone") and
    ``data.features`` ("wav": raw audio and CMVN stats, featurized in the
    train step)."""
    data_cfg = train_cfg["data"]
    seed = train_cfg.get("seed", "seed")
    if data_cfg.get("features", "precomputed") == "wav":
        from ast_tpu_torch.data.wav_loader import WavDataLoader
        return WavDataLoader(data_cfg, model_dir, seed)
    if data_cfg.get("dataloader") == "globalphone":
        return GlobalPhoneDataLoader(data_cfg, model_dir, seed)
    return FisherDataLoader(data_cfg, model_dir, seed)
