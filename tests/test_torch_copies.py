"""The port's own copies of ast_tpu's JAX-free modules (config, symbols,
BLEU) against the originals: the same configuration field by field, the
same symbol ids, and exactly the same BLEU."""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

from ast_tpu import config as jax_config
from ast_tpu.eval import bleu as jax_bleu
from ast_tpu.symbols import SYMBOLS as JAX_SYMBOLS
from ast_tpu_torch import SYMBOLS, Config
from ast_tpu_torch import config as port_config
from ast_tpu_torch.eval import bleu as port_bleu
from tests.conftest import make_tiny_experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = sorted(os.listdir(os.path.join(REPO, "experiments")))


def _assert_same_config(path):
    mine, ref = Config(path), jax_config.Config(path)
    assert mine.cfg_path == ref.cfg_path
    assert mine.model == ref.model
    assert mine.train == ref.train


def test_config_matches_on_tiny_experiment(tmp_path):
    _assert_same_config(make_tiny_experiment(str(tmp_path)))


@pytest.mark.parametrize("name", EXPERIMENTS)
@pytest.mark.parametrize("limit_vocab", [False, True])
def test_config_matches_on_repo_experiments(tmp_path, name, limit_vocab):
    """Each experiment of the repo, its vocab path pointed at a synthetic
    pickle (the real ones are not in the repo)."""
    exp = tmp_path / "exp"
    shutil.copytree(os.path.join(REPO, "experiments", name), exp)
    with open(exp / "train_cfg.json") as f:
        train_cfg = json.load(f)
    data = train_cfg["data"]
    vocab = {data["dec_key"]: {"w2i": {b"_PAD": 0, b"x": 1, b"y": 2}},
             "w2i": {b"_PAD": 0, b"x": 1}}
    with open(tmp_path / "v.vocab", "wb") as f:
        pickle.dump(vocab, f)
    data["vocab_path"] = str(tmp_path / "v.vocab")
    data["limit_vocab"] = limit_vocab
    with open(exp / "train_cfg.json", "w") as f:
        json.dump(train_cfg, f)
    _assert_same_config(str(exp))


def test_config_defaults_and_constants_match():
    for name in ("OPT_ADAM", "OPT_SGD", "_RNN_DEFAULTS", "_TRAIN_DEFAULTS",
                 "_EXTRAS_DEFAULTS", "_DATA_DEFAULTS", "_OPT_DEFAULTS",
                 "_PARALLEL_DEFAULTS"):
        assert getattr(port_config, name) == getattr(jax_config, name), name


def test_symbols_match():
    names = [k for k in vars(JAX_SYMBOLS) if not k.startswith("_")]
    assert names == [k for k in vars(SYMBOLS) if not k.startswith("_")]
    for k in names:
        assert getattr(SYMBOLS, k) == getattr(JAX_SYMBOLS, k), k


def _corpus(seed, n_utts=24, n_refs=4):
    """Seeded synthetic hypotheses and n_refs references per utterance,
    over a small word set so n-grams repeat."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(12)]

    def sent(lo, hi):
        return [words[j] for j in rng.integers(0, len(words),
                                               int(rng.integers(lo, hi)))]

    ids = [f"utt{i:03d}" for i in range(n_utts)]
    refs = [[sent(3, 15) for _ in ids] for _ in range(n_refs)]
    # a few empty and one-word hypotheses exercise the edge cases
    hyps = {u: (sent(0, 2) if i % 7 == 0 else sent(2, 16))
            for i, u in enumerate(ids)}
    return ids, refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bleu_matches_exactly(tmp_path, seed):
    ids, refs, hyps = _corpus(seed)
    with open(tmp_path / "eval.ids", "w") as f:
        f.write("\n".join(ids) + "\n")
    for k, lines in enumerate(refs):
        with open(tmp_path / f"ref.en{k}", "w") as f:
            f.write("\n".join(" ".join(s) for s in lines) + "\n")
    mine = port_bleu.Eval(str(tmp_path), len(refs))
    ref = jax_bleu.Eval(str(tmp_path), len(refs))
    assert mine.ids == ref.ids and mine.refs == ref.refs
    assert mine.calc_bleu(hyps) == ref.calc_bleu(hyps)
    assert mine.calc_bleu(hyps) > 0
    list_refs = list(zip(*refs))
    hyp_list = [hyps[u] for u in ids]
    for smoothing in ("method2", "none"):
        assert port_bleu.corpus_bleu(list_refs, hyp_list,
                                     smoothing=smoothing) == \
            jax_bleu.corpus_bleu(list_refs, hyp_list, smoothing=smoothing)
    mine.write_to_file(hyps, str(tmp_path / "mine.en"))
    ref.write_to_file(hyps, str(tmp_path / "ref.en"))
    assert (tmp_path / "mine.en").read_text() == \
        (tmp_path / "ref.en").read_text()
