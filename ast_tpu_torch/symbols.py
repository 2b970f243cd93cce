"""Special-symbol vocabulary contract: the port's own copy of
``ast_tpu/symbols.py``.

The four special tokens are always the first four vocabulary entries,
with fixed ids PAD=0 / GO=1 / EOS=2 / UNK=3.  Token *bytes* (not str) are
the dict keys of the pickled vocab dicts.
"""


class SYMBOLS:
    PAD = b"_PAD"
    GO = b"_GO"
    EOS = b"_EOS"
    UNK = b"_UNK"
    START_VOCAB = [PAD, GO, EOS, UNK]

    PAD_ID = 0
    GO_ID = 1
    EOS_ID = 2
    UNK_ID = 3

    N_SPECIAL = 4
