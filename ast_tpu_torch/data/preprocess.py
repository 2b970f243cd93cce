"""Offline corpus preparation: text+features -> framework data dicts --
the port's copy of ``ast_tpu/data/preprocess.py`` (the same merges,
pickles and refs files, byte for byte).

Capability-parity rebuild of the reference's preprocessing stage
(reference: preprocessing/preprocess_gp.py:41-176, preprocess_gpfr.py),
which the shipped data blobs depend on but which must be *regenerable*
(two pickles are stripped from the reference repo — SURVEY §0).

Pipeline (one corpus layout):
  <in_path>/<set>.ids           utterance ids, one per line
  <in_path>/<set>.clean.text    whitespace-tokenized target text
  <in_path>/<set>/<conv>.np     pickled {utt: (T, D) float32} features
produces:
  bpe codes (learned in-repo, subword-nmt conventions)
  map   {set: {utt: {"bpe_w": [bytes], "en_w": [bytes]}}}
  vocab {"bpe_w": {w2i, i2w, freq}} (specials first, freq-sorted)
  info  {set: {utt: {"sp": frames, "en_w": n, ...}}}
  data  {set: {utt: features}}            (GlobalPhone-style in-RAM dict)
  refs  eval.ids + ref.en0 (+ .wer sclite format, reference:
        preprocess_gp.py:168-173)

Tokens are stored as *bytes* to match the reference's pickle conventions
(reference: preprocess_gp.py:75,97-103 opens text in binary mode).
"""

import os
import pickle
from collections import Counter

from ast_tpu_torch.data.bpe import apply_bpe, learn_bpe, save_merges
from ast_tpu_torch.symbols import SYMBOLS


def _read_lines(path):
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f]


def create_new_vocab(word_freq):
    """Freq-sorted vocab with specials pinned first (reference:
    preprocess_gp.py:66-80).

    Corpus tokens that collide with a special symbol are excluded —
    re-assigning e.g. b'_UNK' would both break the PAD/GO/EOS/UNK=0..3
    id contract and make the len()-based counter hand the same id to
    two tokens.  Ties break by token, the same order as
    ``vocab.build_vocab``, so the two in-repo builders assign identical
    ids to identical corpora."""
    freq = Counter()
    for w, n in word_freq.items():
        freq[w.encode() if isinstance(w, str) else w] += n
    out = {"w2i": {}, "i2w": {}, "freq": {}}
    for w in SYMBOLS.START_VOCAB:
        out["w2i"][w] = len(out["w2i"])
        out["freq"][w] = 1
    for w, n in sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])):
        if w in SYMBOLS.START_VOCAB:
            continue
        out["w2i"][w] = len(out["w2i"])
        out["freq"][w] = n
    out["i2w"] = {v: k for k, v in out["w2i"].items()}
    return out


def load_speech_dict(in_path, sets):
    """Read per-conversation .np pickles into one {set: {utt: arr}} dict
    (reference: preprocess_gp.py:115-126)."""
    data = {}
    for c in sets:
        data[c] = {}
        set_dir = os.path.join(in_path, c)
        if not os.path.isdir(set_dir):
            continue
        for fname in sorted(os.listdir(set_dir)):
            if fname.endswith(".np"):
                with open(os.path.join(set_dir, fname), "rb") as f:
                    conv = pickle.load(f)
                data[c].update(conv)
    return data


def prepare_corpus(in_path, out_path, bpe_merges=1000,
                   sets=("train", "dev", "test"), text_key="en_w",
                   speech_data=None, speech_frames=None):
    """Full corpus prep: learn BPE on train text, build map/vocab/info/data
    pickles + refs.  Returns the dict of artifact paths.

    ``speech_frames`` ({set: {utt: n_frames}}): pass frame counts
    directly when features already live as per-utterance .npy files
    (the fisher-recipe path) — info gets exact "sp" counts without
    loading or re-pickling any feature arrays, and data.dict is
    written empty (the loader reads features from speech_path, never
    from data.dict).
    """
    os.makedirs(out_path, exist_ok=True)

    texts = {c: _read_lines(os.path.join(in_path, f"{c}.clean.text"))
             for c in sets}
    ids = {c: _read_lines(os.path.join(in_path, f"{c}.ids"))
           for c in sets}
    for c in sets:
        # the files pair line-for-line; a silent zip() over a skewed
        # pair would train every utterance after the skew on another
        # utterance's transcript
        if len(ids[c]) != len(texts[c]):
            raise ValueError(
                f"{c}.ids has {len(ids[c])} lines but {c}.clean.text "
                f"has {len(texts[c])} — they must pair line-for-line")

    # learn BPE on the training text only (reference learns with
    # subword-nmt on train: linking_files/get_bpe.sh:13-19)
    train_tok = [line.split() for line in texts[sets[0]]]
    merges = learn_bpe(train_tok, num_merges=bpe_merges, min_frequency=2)
    codes_path = os.path.join(out_path, f"bpe_{bpe_merges}.codes")
    save_merges(merges, codes_path)

    bpe_texts = {
        c: [apply_bpe(merges, line.split()) for line in texts[c]]
        for c in sets
    }

    vocab = {"bpe_w": create_new_vocab(
        Counter(w for sent in bpe_texts[sets[0]] for w in sent))}

    map_dict = {}
    for c in sets:
        map_dict[c] = {}
        for utt, bpe_sent, raw in zip(ids[c], bpe_texts[c], texts[c]):
            map_dict[c][utt] = {
                "bpe_w": [w.encode() for w in bpe_sent],
                text_key: [w.encode() for w in raw.split()],
            }

    if speech_frames is not None:
        speech_data = {c: {} for c in sets}
    elif speech_data is None:
        speech_data = load_speech_dict(in_path, sets)

    def _frames(c, utt):
        if speech_frames is not None:
            return int(speech_frames[c].get(utt, 0))
        feats = speech_data[c].get(utt)
        return int(feats.shape[0]) if feats is not None else 0

    info = {}
    for c in sets:
        info[c] = {}
        for utt in map_dict[c]:
            info[c][utt] = {
                "sp": _frames(c, utt),
                text_key: len(map_dict[c][utt][text_key]),
                "bpe_w": len(map_dict[c][utt]["bpe_w"]),
            }

    paths = {
        "map": os.path.join(out_path, "bpe_map.dict"),
        "vocab": os.path.join(out_path, "bpe_train_vocab.dict"),
        "info": os.path.join(out_path, "info.dict"),
        "data": os.path.join(out_path, "data.dict"),
        "codes": codes_path,
    }
    for name, obj in [("map", map_dict), ("vocab", vocab),
                      ("info", info), ("data", speech_data)]:
        with open(paths[name], "wb") as f:
            pickle.dump(obj, f)

    # refs: eval.ids + ref.en0 per non-train set, plus sclite .wer files
    for c in sets:
        refs_dir = os.path.join(out_path, "refs", c)
        os.makedirs(refs_dir, exist_ok=True)
        with open(os.path.join(refs_dir, "eval.ids"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(ids[c]) + "\n")
        with open(os.path.join(refs_dir, "ref.en0"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(texts[c]) + "\n")
        with open(os.path.join(out_path, f"{c}.clean.wer"), "w",
                  encoding="utf-8") as f:
            for utt, line in zip(ids[c], texts[c]):
                f.write(f"{line} ({utt})\n")

    return paths
