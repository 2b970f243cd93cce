"""The synthetic corpus a traffic mix names, kept as one feature pack.

The Fisher corpus is licensed and not shipped, so a mix's corpus is
made from its ``corpus`` block and the configuration's vocabulary
(``vocab_words``, the configuration's ``vocab_size`` less the four
special symbols): for each ``[bucket, count, frames, U]``
row, ``count`` utterances of ``frames - 79 .. frames`` frames (not
below ``bucket * 80 + 1``) with ``U - 8 .. U - 2`` target words of a
``vocab_words``-word vocabulary, and N(0, 1) features of ``feat_dim``
columns, all drawn in that order from ``numpy.random.RandomState(seed)``
(the recipe of ``scripts/torch_trainer_epoch_bench.py``'s
``build_corpus``).  It is fixed data: ``--seed`` does not change it.

The first run in a checkout writes it under ``benchmark/.cache/corpus/
<hash of the block>/``: ``<split>.pack`` (the ``ASTPACK1`` layout the
program's Fisher loader reads: magic, index offset, the row-major
matrices, a pickled ``{utt: (offset, T, D, dtype)}``), the map / vocab /
info pickles the loader takes, and ``corpus.json`` (names, frames,
tokens) for the benchmark and its reference; later runs read them.
"""

import hashlib
import json
import os
import pickle
import struct

import numpy as np

MAGIC = b"ASTPACK1"
SPLIT = "bench_train"
DEC_KEY = "en_w"
SPECIALS = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]


def corpus_dir(cache, spec):
    h = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()
    return os.path.join(cache, "corpus", h[:16])


def _generate(spec, out):
    """Write the corpus of ``spec`` into ``out``; returns its meta."""
    rng = np.random.RandomState(int(spec["seed"]))
    D, n_words = int(spec["feat_dim"]), int(spec["vocab_words"])
    names, frames, tokens = [], [], []
    index = {}
    pack = os.path.join(out, f"{SPLIT}.pack")
    with open(pack + ".tmp", "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", 0))
        for b, n, hi, U in spec["buckets"]:
            lo = b * 80 + 1
            for i in range(int(n)):
                utt = f"b{b:02d}_u{i:05d}"
                fr = int(rng.randint(max(lo, hi - 79), hi + 1))
                nw = int(rng.randint(max(2, U - 8), U - 1))
                toks = [int(rng.randint(n_words)) for _ in range(nw)]
                feats = rng.randn(fr, D).astype(np.float32)
                index[utt] = (f.tell(), fr, D, feats.dtype.str)
                f.write(feats.tobytes())
                names.append(utt)
                frames.append(fr)
                tokens.append(toks)
        off = f.tell()
        pickle.dump(index, f, protocol=2)
        f.seek(len(MAGIC))
        f.write(struct.pack("<Q", off))
    os.replace(pack + ".tmp", pack)
    words = [f"w{i}".encode() for i in range(n_words)]
    w2i = {w: i for i, w in enumerate(SPECIALS + words)}
    tables = {
        "map": {SPLIT: {u: {DEC_KEY: [words[w] for w in t]}
                        for u, t in zip(names, tokens)}},
        "vocab": {DEC_KEY: {"w2i": w2i,
                            "i2w": {i: w for w, i in w2i.items()},
                            "freq": {}}},
        "info": {SPLIT: {u: {"sp": fr, DEC_KEY: len(t)}
                         for u, fr, t in zip(names, frames, tokens)}},
    }
    for name, obj in tables.items():
        with open(os.path.join(out, f"{name}.pkl"), "wb") as f:
            pickle.dump(obj, f)
    meta = {"names": names, "frames": frames, "tokens": tokens,
            "feat_dim": D, "offsets": [index[u][0] for u in names]}
    with open(os.path.join(out, "corpus.json.tmp"), "w") as f:
        json.dump(meta, f)
    os.replace(os.path.join(out, "corpus.json.tmp"),
               os.path.join(out, "corpus.json"))
    return meta


class Corpus:
    """A mix's corpus on disk: ``paths`` for the experiment, ``feats(u)``
    of utterance index ``u``, and the meta lists."""

    def __init__(self, cache, spec):
        self.dir = corpus_dir(cache, spec)
        os.makedirs(self.dir, exist_ok=True)
        meta_path = os.path.join(self.dir, "corpus.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        else:
            meta = _generate(spec, self.dir)
        self.names = meta["names"]
        self.frames = np.asarray(meta["frames"])
        self.tokens = meta["tokens"]
        self.n_tokens = np.asarray([len(t) for t in self.tokens])
        self.feat_dim = meta["feat_dim"]
        self._off = meta["offsets"]
        self.vocab_size = len(SPECIALS) + int(spec["vocab_words"])
        self._mm = np.memmap(os.path.join(self.dir, f"{SPLIT}.pack"),
                             dtype=np.uint8, mode="r")

    def feats(self, u):
        """(frames, D) float32 features of utterance index ``u``."""
        n = int(self.frames[u]) * self.feat_dim
        return np.frombuffer(self._mm[self._off[u]:self._off[u] + 4 * n],
                             dtype=np.float32).reshape(-1, self.feat_dim)

    def as_dict(self, max_pred):
        """The fields ``benchmark.reference.batches`` reads."""
        return {"names": self.names, "frames": self.frames,
                "tokens": self.tokens, "n_tokens": self.n_tokens,
                "feat_dim": self.feat_dim, "max_pred": max_pred}

    def data_paths(self):
        """The experiment's ``data`` paths of this corpus."""
        return {"speech_path": self.dir,
                "map_path": os.path.join(self.dir, "map.pkl"),
                "vocab_path": os.path.join(self.dir, "vocab.pkl"),
                "info_path": os.path.join(self.dir, "info.pkl"),
                "refs_path": os.path.join(self.dir, "refs")}


def write_experiment(exp_dir, config, corpus, seed):
    """The experiment directory of one run: the configuration's
    ``model_cfg`` and its ``train_cfg`` with the corpus's paths and the
    run's seed string.  Returns the directory."""
    os.makedirs(exp_dir, exist_ok=True)
    for name in os.listdir(exp_dir):      # a former run's bucket dict
        os.remove(os.path.join(exp_dir, name))
    tcfg = json.loads(json.dumps(config["train_cfg"]))
    tcfg["seed"] = f"bench-{seed}"
    tcfg["train_set"] = tcfg["dev_set"] = SPLIT
    tcfg["data"].update(corpus.data_paths(), enc_key="sp", dec_key=DEC_KEY)
    with open(os.path.join(exp_dir, "train_cfg.json"), "w") as f:
        json.dump(tcfg, f, indent=1)
    with open(os.path.join(exp_dir, "model_cfg.json"), "w") as f:
        json.dump(config["model_cfg"], f, indent=1)
    return exp_dir
