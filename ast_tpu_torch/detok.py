"""Token ids -> text, the contract of ``ast_tpu.data.detok`` and
``FisherDataLoader.get_hyps``: specials (ids < 4) are dropped wherever
they occur, tokens after EOS are kept, ``*_w`` units join with spaces
and char units join bare, and ``bpe_w`` merges the ``@@ `` joiner."""

import pickle

from ast_tpu_torch.symbols import SYMBOLS


def dec_i2w(train_cfg):
    """Decoder id -> token bytes table of an experiment's vocab pickle,
    ``limit_vocab``-aware, as ``FisherDataLoader.dec_i2w`` reads it.
    ``train_cfg``: the ``train`` dict of ``ast_tpu.config.Config``."""
    data = train_cfg["data"]
    with open(data["vocab_path"], "rb") as f:
        vocab = pickle.load(f)
    if data.get("limit_vocab", False):
        return vocab["i2w"]
    return vocab[data["dec_key"]]["i2w"]



def ids_to_text(ids, lookup, dec_key):
    """Token ids -> canonical text; ``lookup``: id -> token str."""
    join = " " if dec_key.endswith("_w") else ""
    text = join.join(lookup(i) for i in ids if i >= SYMBOLS.N_SPECIAL)
    if "bpe_w" in dec_key:
        text = text.replace("@@ ", "")
    return " ".join(text.strip().split())


def get_hyps(preds, i2w, dec_key):
    """``[(utt, id sequence)]`` -> ``{utt: [word, ...]}``.

    ``i2w``: id -> token bytes (the vocab pickle's table)."""
    hyps = {}
    for utt, p in preds:
        if hasattr(p, "tolist"):
            p = p.tolist()
        if not isinstance(p, (list, tuple)):
            raise TypeError(f"get_hyps: pred for {utt!r} must be a "
                            f"token-id sequence, got {type(p).__name__}")
        hyps[utt] = ids_to_text(p, lambda i: i2w[i].decode(),
                                dec_key).split()
    return hyps
