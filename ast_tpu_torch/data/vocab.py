"""Vocabulary + map/info dict construction and I/O -- the port's copy of
``ast_tpu/data/vocab.py`` (the same pickles, byte for byte).

The reference ships these as opaque pickles (``fisher.vocab``,
``fisher_20h.info``, ``fisher.map``) built offline by
preprocessing/preprocess_gp.py:66-160; two of the blobs are stripped from
the repo (.MISSING_LARGE_BLOBS), so this module makes them *regenerable*:

- vocab: {key: {"w2i": {bytes: id}, "i2w": {id: bytes}, "freq": {bytes: n}}}
  with SYMBOLS.START_VOCAB always occupying ids 0-3, remaining types sorted
  by descending frequency (reference: preprocess_gp.py:66-83).
- map:   {set_key: {utt: {key: [bytes tokens]}}}
- info:  {set_key: {utt: {"sp": n_frames, key: n_tokens}}}
"""

import pickle
from collections import Counter

from ast_tpu_torch.symbols import SYMBOLS


def _to_bytes(tok):
    return tok.encode("utf-8") if isinstance(tok, str) else tok


def build_vocab(token_streams):
    """Build a vocab dict for several keys at once.

    ``token_streams``: {key: iterable of token sequences}.
    """
    vocab = {}
    for key, seqs in token_streams.items():
        freq = Counter()
        for seq in seqs:
            freq.update(_to_bytes(t) for t in seq)
        # frequency-sorted types, specials pinned at the front
        types = [t for t, _ in sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
                 if t not in SYMBOLS.START_VOCAB]
        all_types = list(SYMBOLS.START_VOCAB) + types
        w2i = {w: i for i, w in enumerate(all_types)}
        i2w = {i: w for w, i in w2i.items()}
        vocab[key] = {"w2i": w2i, "i2w": i2w, "freq": dict(freq)}
    return vocab


def build_map_and_info(utt_tokens, utt_frames):
    """Build map/info dicts for one dataset split layout.

    ``utt_tokens``: {set_key: {utt: {key: [tokens]}}}
    ``utt_frames``: {set_key: {utt: n_speech_frames}}
    """
    map_dict, info_dict = {}, {}
    for set_key, utts in utt_tokens.items():
        map_dict[set_key] = {}
        info_dict[set_key] = {}
        for utt, keyed in utts.items():
            map_dict[set_key][utt] = {
                k: [_to_bytes(t) for t in toks] for k, toks in keyed.items()
            }
            entry = {"sp": int(utt_frames[set_key][utt])}
            for k, toks in keyed.items():
                entry[k] = len(toks)
            info_dict[set_key][utt] = entry
    return map_dict, info_dict


def save_pickle(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)
