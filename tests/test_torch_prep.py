"""The port's corpus preparation against ast_tpu's, on the CPU.

BPE, vocab and preprocess write ast_tpu's merges files, pickles and refs
byte for byte; the transcript chain (``.tdf`` tables written as
tests/test_transcripts.py writes them) gives the same text and tables;
the Kaldi ark readers (text, binary, ragged) and the conversation
repacking the same arrays and pickles; feature packs the same bytes, and
the Fisher loader reads a split's pack into the same batches; validate
the same findings and summary on a clean corpus and on one with each
problem ``fix_corpus`` repairs, and the same repaired files; and every
``prep_data`` subcommand the same output files and messages (paths with
the root replaced), features within 1e-4.  ``ast_tpu.native`` is
replaced by a module without its readers while ast_tpu runs, so
ast_tpu's Python readers are the reference and its build never runs.
"""

import json
import os
import pickle
import shutil
import wave

import numpy as np
import pytest

from ast_tpu.cli import prep_data as jax_prep
from ast_tpu.data import bpe as jax_bpe
from ast_tpu.data import feature_pack as jax_pack
from ast_tpu.data import kaldi_ark as jax_ark
from ast_tpu.data import preprocess as jax_pre
from ast_tpu.data import transcripts as jax_tr
from ast_tpu.data import validate as jax_val
from ast_tpu.data import vocab as jax_vocab
from ast_tpu_torch.cli import prep_data
from ast_tpu_torch.data import bpe, feature_pack, kaldi_ark, preprocess
from ast_tpu_torch.data import transcripts, validate, vocab
from tests.conftest import make_tiny_experiment
from tests.test_torch_native import write_text_ark
from tests.test_torch_recipe import (
    make_raw_tree, python_readers_in_ast_tpu, run_cli, speechlike,
    sph_header, tdf_row, ulaw_codes, write_shorten_sph, write_tdf)

FEAT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _python_readers():
    with python_readers_in_ast_tpu():
        yield


def same_bytes(a, b, root_a=None, root_b=None):
    with open(a, "rb") as f, open(b, "rb") as g:
        want = f.read()
        if root_a is not None:
            want = want.replace(root_a.encode(), root_b.encode())
        assert g.read() == want, (a, b)


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def same_tree(a, b, tol=None):
    """The trees under ``a`` and ``b`` hold the same files: ``.npy``
    within ``tol`` when given, everything else byte-equal (``a``'s root
    path read as ``b``'s)."""
    files = tree_files(a)
    assert files and files == tree_files(b)
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if tol is not None and rel.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.shape == y.shape and x.dtype == y.dtype, rel
            np.testing.assert_allclose(y, x, rtol=0, atol=tol, err_msg=rel)
        else:
            same_bytes(pa, pb, a, b)


def both_clis(tmp, argv, device=False):
    """``argv(out_root)`` through ast_tpu's and the port's prep_data
    (the port's with ``--device cpu`` when ``device``): the two output
    roots, after checking their exit codes and messages are equal."""
    results = []
    for name, main in (("jax", jax_prep.main), ("port", prep_data.main)):
        out = os.path.join(tmp, name)
        os.makedirs(out, exist_ok=True)
        extra = ["--device", "cpu"] if device and name == "port" else []
        code, text = run_cli(main, argv(out) + extra)
        results.append((out, code, text.replace(out, "<out>")))
    (a, ca, ta), (b, cb, tb) = results
    assert (ca, ta) == (cb, tb)
    return a, b


# ---------------------------------------------------------------------------
# BPE, vocab, preprocess
# ---------------------------------------------------------------------------

def corpus_lines(seed=0, n=60):
    rng = np.random.RandomState(seed)
    words = ["low", "lower", "lowest", "newer", "wider", "#yes", "año",
             "a", "ab", "ba", "zz", "señor"]
    return [" ".join(words[rng.randint(len(words))]
                     for _ in range(rng.randint(1, 9))) for _ in range(n)]


def test_bpe_merges_and_segmentation_equal(tmp_path):
    sents = [ln.split() for ln in corpus_lines()]
    for num, minf in ((5, 2), (40, 2), (200, 1)):
        merges = bpe.learn_bpe(sents, num_merges=num, min_frequency=minf)
        assert merges == jax_bpe.learn_bpe(sents, num_merges=num,
                                           min_frequency=minf)
        for s in sents[:20] + [["unseen", "lowerest"]]:
            assert bpe.apply_bpe(merges, s) == jax_bpe.apply_bpe(merges, s)
        a, b = str(tmp_path / f"j{num}"), str(tmp_path / f"p{num}")
        jax_bpe.save_merges(merges, a)
        bpe.save_merges(merges, b)
        same_bytes(a, b)
        assert bpe.load_merges(a) == jax_bpe.load_merges(b) == merges


def test_vocab_pickles_equal(tmp_path):
    streams = {"bpe_w": [ln.split() for ln in corpus_lines(1)],
               "en_w": [[w.encode() for w in ln.split()] + [b"_UNK"]
                        for ln in corpus_lines(2)]}
    utt_tokens = {"train": {f"u{i}": {"en_w": ln.split()}
                            for i, ln in enumerate(corpus_lines(3, 10))}}
    utt_frames = {"train": {f"u{i}": 40 + i for i in range(10)}}
    for name, obj, ref in (
            ("vocab", vocab.build_vocab(streams),
             jax_vocab.build_vocab(streams)),
            ("map_info", vocab.build_map_and_info(utt_tokens, utt_frames),
             jax_vocab.build_map_and_info(utt_tokens, utt_frames))):
        a, b = str(tmp_path / f"{name}.j"), str(tmp_path / f"{name}.p")
        jax_vocab.save_pickle(ref, a)
        vocab.save_pickle(obj, b)
        same_bytes(a, b)
        assert vocab.load_pickle(b) == ref


def test_create_new_vocab_equal(tmp_path):
    freq = {"x": 3, b"y": 3, "_UNK": 9, "z": 1, "a": 3}
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax_vocab.save_pickle(jax_pre.create_new_vocab(freq), a)
    vocab.save_pickle(preprocess.create_new_vocab(freq), b)
    same_bytes(a, b)


def write_text_corpus(root, sets=("train", "dev", "test")):
    """<set>.ids / <set>.clean.text and per-conversation ``.np`` feature
    pickles, the build-dicts input layout."""
    rng = np.random.RandomState(4)
    lines = corpus_lines(5, 24)
    for k, c in enumerate(sets):
        part = lines[8 * k: 8 * k + 8]
        ids = [f"conv{k}-{i:03d}" for i in range(len(part))]
        with open(os.path.join(root, f"{c}.ids"), "w") as f:
            f.write("\n".join(ids) + "\n")
        with open(os.path.join(root, f"{c}.clean.text"), "w") as f:
            f.write("\n".join(part) + "\n")
        os.makedirs(os.path.join(root, c))
        conv = {u: rng.randn(20 + i, 13).astype(np.float32)
                for i, u in enumerate(ids)}
        with open(os.path.join(root, c, f"conv{k}.np"), "wb") as f:
            pickle.dump(conv, f)


def test_prepare_corpus_files_equal(tmp_path):
    src = str(tmp_path / "in")
    os.makedirs(src)
    write_text_corpus(src)
    a, b = str(tmp_path / "j"), str(tmp_path / "p")
    pj = jax_pre.prepare_corpus(src, a, bpe_merges=50)
    pp = preprocess.prepare_corpus(src, b, bpe_merges=50)
    assert {k: os.path.relpath(v, a) for k, v in pj.items()} == \
        {k: os.path.relpath(v, b) for k, v in pp.items()}
    same_tree(a, b)
    # the frame-count path of the recipe
    frames = {c: {f"conv{k}-{i:03d}": 30 + i for i in range(8)}
              for k, c in enumerate(("train", "dev", "test"))}
    jax_pre.prepare_corpus(src, a + "f", bpe_merges=50, speech_frames=frames)
    preprocess.prepare_corpus(src, b + "f", bpe_merges=50,
                              speech_frames=frames)
    same_tree(a + "f", b + "f")
    with open(os.path.join(src, "dev.ids"), "a") as f:
        f.write("extra\n")
    with pytest.raises(ValueError, match="pair line-for-line"):
        preprocess.prepare_corpus(src, b + "x")


# ---------------------------------------------------------------------------
# transcripts
# ---------------------------------------------------------------------------

MARKUP = ["hola <laugh>ja</laugh> qué tal", "((no se)) bueno",
          "Árbol PEQUEÑO señor Güero güisqui ÚNico", "<cough/> sí, claro.",
          "<foreign lang=\"English\">okay</foreign> pues",
          "<background>ruido</background> vale ¿no?", "   ",
          "<lname>Pérez</lname> y <breath/> [ruido] ah-ha", "()"]


def write_tdfs(root, calls=("20050908_182943_22_fsp", "conv_b", "conv-c"),
               per=9):
    os.makedirs(root)
    for ci, call in enumerate(calls):
        rows = []
        for k in range(per):
            t = 0.5 + 1.25 * k
            rows.append(tdf_row(call, (k + ci) % 2, round(t, 2),
                                round(t + 0.9 + 0.01 * k, 2),
                                MARKUP[(k + ci) % len(MARKUP)]))
        rows.append(tdf_row(call, 0, 20.0, 20.0, "vacío cero"))
        write_tdf(os.path.join(root, f"{call}.tdf"), rows)
    return [os.path.join(root, f"{c}.tdf") for c in calls]


def test_transcript_functions_equal(tmp_path):
    paths = write_tdfs(str(tmp_path / "tdf"))
    for p in paths:
        assert transcripts.parse_tdf(p) == jax_tr.parse_tdf(p)
    text1 = transcripts.make_trans(paths)
    assert text1 == jax_tr.make_trans(paths)
    text = transcripts.fsp_clean_text(text1[0])
    assert text == jax_tr.fsp_clean_text(text1[0])
    assert transcripts.segments_from_text(text) == \
        jax_tr.segments_from_text(text)
    assert transcripts.clean_text_ids(text) == jax_tr.clean_text_ids(text)
    calls = [f"call{i}" for i in range(12)]
    for frac, seed in ((0.1, "s"), (0.5, "t"), (0.0, "u"), (1.0, "v")):
        assert transcripts._hash_split(calls, frac, seed) == \
            jax_tr._hash_split(calls, frac, seed)
    with pytest.raises(ValueError, match=">= 2 conversations"):
        transcripts._hash_split(["one"], 0.1, "s")


@pytest.mark.parametrize("case", ["hash", "splits", "translations"])
def test_prepare_fisher_text_equal(tmp_path, case):
    tdf = str(tmp_path / "tdf")
    write_tdfs(tdf)
    kw = {}
    if case == "splits":
        sp = tmp_path / "splits"
        sp.mkdir()
        (sp / "train").write_text("20050908_182943_22_fsp\nconv_b\n")
        (sp / "dev").write_text("conv-c\n")
        kw = dict(splits=str(sp), sets=("train", "dev"))
    elif case == "translations":
        paths = sorted(os.path.join(tdf, f) for f in os.listdir(tdf))
        text = jax_tr.fsp_clean_text(jax_tr.make_trans(paths)[0])
        utts = [ln.split(" ", 1)[0] for ln in text]
        tr = tmp_path / "tr"
        tr.write_text("".join(f"{u}\t{'' if i % 5 == 4 else f'good {i}'}\n"
                              for i, u in enumerate(utts) if i % 3))
        kw = dict(translations=str(tr))
    logs = {}
    for name, fn in (("j", jax_tr.prepare_fisher_text),
                     ("p", transcripts.prepare_fisher_text)):
        lines = []
        res = fn(tdf, str(tmp_path / name), seed="x", log=lines.append,
                 **kw)
        logs[name] = (lines, res["counts"])
    assert logs["j"] == logs["p"]
    same_tree(str(tmp_path / "j"), str(tmp_path / "p"))


# ---------------------------------------------------------------------------
# Kaldi arks
# ---------------------------------------------------------------------------

def ark_items(seed=0, dims=(13, 13, 13)):
    rng = np.random.RandomState(seed)
    return [(f"conv{i % 2}-{i}-{i + 1}", rng.randn(3 + i, d)
             .astype(np.float32)) for i, d in enumerate(dims)]


@pytest.mark.parametrize("kind", ["rect", "ragged", "bracket_line"])
def test_text_ark_equal(tmp_path, kind):
    items = ark_items(dims=(13, 42, 13) if kind == "ragged" else (13,) * 3)
    path = str(tmp_path / "a.ark")
    write_text_ark(path, items, fmt=lambda v: f"{v:.7g}",
                   closing_own_line=kind == "bracket_line")
    got = list(kaldi_ark.read_text_ark(path))
    want = list(jax_ark.read_text_ark(path))
    assert [u for u, _ in got] == [u for u, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert [u for u, _ in kaldi_ark._read_text_ark_py(path)] == \
        [u for u, _ in want]


def test_binary_ark_equal(tmp_path):
    items = ark_items(1, dims=(13, 7, 13))
    a, b = str(tmp_path / "j.ark"), str(tmp_path / "p.ark")
    jax_ark.write_binary_ark(a, items)
    kaldi_ark.write_binary_ark(b, items)
    same_bytes(a, b)
    # a double matrix (DM) reads as float32 by both
    with open(a, "ab") as f:
        f.write(b"dm-1-2 \0BDM ")
        for dim in (2, 3):
            f.write(b"\x04" + int(dim).to_bytes(4, "little"))
        f.write(np.arange(6, dtype=np.float64).tobytes())
    got, want = (list(m.read_binary_ark(a)) for m in (kaldi_ark, jax_ark))
    assert [u for u, _ in got] == [u for u, _ in want]
    for (_, x), (_, y) in zip(got, want):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_conversation_pickles_and_merge_equal(tmp_path):
    items = ark_items(2, dims=(13,) * 5)
    # non-contiguous conversations: conv0, conv1, conv0, ...
    path = str(tmp_path / "a.ark")
    write_text_ark(path, items)
    for name, mod in (("j", jax_ark), ("p", kaldi_ark)):
        assert mod.ark_to_conversation_pickles(
            path, str(tmp_path / name)) == 2
    same_tree(str(tmp_path / "j"), str(tmp_path / "p"))
    mats = [m for _, m in items]
    np.testing.assert_array_equal(kaldi_ark.merge_segments(mats),
                                  jax_ark.merge_segments(mats))


# ---------------------------------------------------------------------------
# feature packs and the loader
# ---------------------------------------------------------------------------

def npy_tree(root, seed=0):
    rng = np.random.RandomState(seed)
    for sub in ("", "20050908"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(3):
            np.save(os.path.join(root, sub, f"{sub or 'u'}_{i}.npy"),
                    rng.randn(10 + 3 * i, 13).astype(np.float32))


@pytest.mark.parametrize("dtype", [None, np.float16])
def test_feature_pack_equal(tmp_path, dtype):
    src = str(tmp_path / "src")
    npy_tree(src)
    a, b = str(tmp_path / "j.pack"), str(tmp_path / "p.pack")
    assert jax_pack.pack_features(src, a, dtype) == \
        feature_pack.pack_features(src, b, dtype) == 6
    same_bytes(a, b)
    pj, pp = jax_pack.FeaturePack(a), feature_pack.FeaturePack(b)
    assert len(pp) == len(pj) and sorted(pp.index) == sorted(pj.index)
    for u in pj.index:
        for rows in (None, 4):
            x, y = pj.get(u, rows), pp.get(u, rows)
            assert y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="duplicate utterance key"):
        feature_pack.write_pack(str(tmp_path / "d.pack"),
                                [("u", np.zeros((2, 2)))] * 2)
    (tmp_path / "bad").write_bytes(b"NOTAPACK" + b"\0" * 8)
    with pytest.raises(ValueError, match="not a feature pack"):
        feature_pack.FeaturePack(str(tmp_path / "bad"))


def test_loader_reads_packs_as_ast_tpu(tmp_path):
    from ast_tpu.data.dataloader import make_dataloader as jax_make
    from ast_tpu_torch.data.dataloader import make_dataloader

    exp = make_tiny_experiment(str(tmp_path))
    with open(os.path.join(exp, "train_cfg.json")) as f:
        cfg = json.load(f)
    speech = cfg["data"]["speech_path"]
    for s in ("tiny_train", "tiny_dev"):
        feature_pack.pack_features(os.path.join(speech, s),
                                   os.path.join(speech, f"{s}.pack"),
                                   dtype=np.float16)
        shutil.rmtree(os.path.join(speech, s))     # only the pack is left
    for s, train in (("tiny_train", True), ("tiny_dev", False)):
        got = make_dataloader(cfg, exp).get_batch(
            4, s, train=train, labels=True, epoch=1)
        want = jax_make(cfg, exp).get_batch(4, s, train=train, labels=True,
                                            epoch=1)
        n = 0
        for x, y in zip(got, want):
            assert x["utts"] == y["utts"]
            np.testing.assert_array_equal(x["X"], y["X"])
            np.testing.assert_array_equal(x["y"], y["y"])
            n += 1
        assert n > 0


# ---------------------------------------------------------------------------
# validate / fix
# ---------------------------------------------------------------------------

def _rewrite(path, mutate):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    mutate(obj)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _missing_speech(cfg):
    os.remove(os.path.join(cfg["data"]["speech_path"], "tiny_train",
                           "tiny_train_utt000.npy"))


def _map_only(cfg):
    _rewrite(cfg["data"]["map_path"], lambda m: m["tiny_train"].update(
        ghost_map={"en_w": [b"w1"]}))


def _info_only(cfg):
    _rewrite(cfg["data"]["info_path"], lambda i: i["tiny_dev"].update(
        ghost_info={"sp": 40, "en_w": 1}))


def _missing_dec(cfg):
    _rewrite(cfg["data"]["map_path"],
             lambda m: m["tiny_train"]["tiny_train_utt001"].pop("en_w"))


def _stale_frames(cfg, T):
    np.save(os.path.join(cfg["data"]["speech_path"], "tiny_train",
                         "tiny_train_utt002.npy"),
            np.random.RandomState(1).randn(T, 13).astype(np.float32))
    _rewrite(cfg["data"]["info_path"],
             lambda i: i["tiny_train"]["tiny_train_utt002"].update(sp=90))


def _bad_frames(cfg):
    _rewrite(cfg["data"]["info_path"],
             lambda i: i["tiny_train"]["tiny_train_utt003"].update(sp=0))


def _unreadable(cfg):
    with open(os.path.join(cfg["data"]["speech_path"], "tiny_dev",
                           "tiny_dev_utt001.npy"), "wb") as f:
        f.write(b"not an array")


def _refs_unknown(cfg):
    with open(os.path.join(cfg["data"]["refs_path"], "tiny_dev",
                           "eval.ids"), "a") as f:
        f.write("not_a_real_utt\n")


def _vocab_broken(cfg):
    def brk(v):
        v["en_w"]["w2i"][b"_PAD"], v["en_w"]["w2i"][b"_GO"] = 1, 0
        v["en_w"]["i2w"][999] = b"orphan"
    _rewrite(cfg["data"]["vocab_path"], brk)


BREAKS = {
    "clean": [],
    "missing_speech": [_missing_speech],
    "map_only": [_map_only],
    "info_only": [_info_only],
    "missing_dec_tokens": [_missing_dec],
    "frames_exceed_info": [lambda c: _stale_frames(c, 150)],
    "frames_below_info": [lambda c: _stale_frames(c, 60)],
    "bad_frame_count": [_bad_frames],
    "unreadable_speech": [_unreadable],
    "refs": [_refs_unknown, _vocab_broken],
    "all": [_missing_speech, _map_only, _info_only, _missing_dec,
            lambda c: _stale_frames(c, 150), _bad_frames, _unreadable,
            _refs_unknown],
}


def _broken_copies(tmp_path, breaks):
    """The same broken tiny corpus twice: (root_j, cfg_j), (root_p,
    cfg_p)."""
    out = []
    for name in ("j", "p"):
        exp = make_tiny_experiment(str(tmp_path / name))
        with open(os.path.join(exp, "train_cfg.json")) as f:
            cfg = json.load(f)
        for b in breaks:
            b(cfg)
        out.append((str(tmp_path / name), cfg))
    return out


@pytest.mark.parametrize("case", sorted(BREAKS))
def test_validate_and_fix_equal(tmp_path, case):
    (rj, cj), (rp, cp) = _broken_copies(tmp_path, BREAKS[case])
    for kw in (dict(deep=True), dict(deep=False, max_load=3),
               dict(check_features=False)):
        pj, sj = jax_val.validate_corpus(cj, **kw)
        pp, sp = validate.validate_corpus(cp, **kw)
        assert [repr(p) for p in pp] == \
            [repr(p).replace(rj, rp) for p in pj]
        assert [(p.code, p.utts) for p in pp] == \
            [(p.code, p.utts) for p in pj]
        assert sp == sj
    if case == "clean":
        assert sp["n_errors"] == 0
    fj, fp = jax_val.fix_corpus(cj), validate.fix_corpus(cp)
    assert fp == fj
    same_tree(rj, rp)
    assert [repr(p) for p in validate.validate_corpus(cp, deep=True)[0]] \
        == [repr(p).replace(rj, rp)
            for p in jax_val.validate_corpus(cj, deep=True)[0]]


def test_fix_no_feats_equal(tmp_path):
    (rj, cj), (rp, cp) = _broken_copies(tmp_path, [_map_only])
    for c in (cj, cp):
        shutil.rmtree(c["data"]["speech_path"])
    assert validate.fix_corpus(cp, check_features=False) == \
        jax_val.fix_corpus(cj, check_features=False)
    same_tree(rj, rp)


# ---------------------------------------------------------------------------
# every prep_data subcommand
# ---------------------------------------------------------------------------

def test_cli_tdf_to_text_and_clean_text(tmp_path):
    tdf = str(tmp_path / "tdf")
    write_tdfs(tdf)
    a, b = both_clis(str(tmp_path), lambda out: [
        "tdf-to-text", tdf, os.path.join(out, "t"), "--seed", "q"])
    same_tree(a, b)
    text = os.path.join(a, "t", "text")
    a, b = both_clis(str(tmp_path / "c"), lambda out: [
        "clean-text", text, "--out", os.path.join(out, "clean")])
    same_tree(a, b)


def test_cli_ark_to_conv_and_merge_segments(tmp_path):
    ark = str(tmp_path / "feats.ark")
    items = ark_items(3, dims=(13,) * 5)
    write_text_ark(ark, items)
    a, b = both_clis(str(tmp_path), lambda out: [
        "ark-to-conv", ark, os.path.join(out, "convs")])
    same_tree(a, b)
    seg_map = {"utt1": {"seg": ["conv0-0-1", "conv0-2-3"]},
               "utt2": ["conv1-1-2"], "utt3": {"seg": []},
               "utt4": {"seg": ["conv1-3-4", "conv1-9-9"]}}
    map_path = str(tmp_path / "seg.map")
    with open(map_path, "wb") as f:
        pickle.dump(seg_map, f)
    conv_dir = os.path.join(a, "convs")
    for extra in (["--allow-missing"], []):
        a2, b2 = both_clis(str(tmp_path / f"m{len(extra)}"), lambda out: [
            "merge-segments", "--map", map_path, "--conv_dir", conv_dir,
            "--out_dir", os.path.join(out, "utts")] + extra)
        same_tree(a2, b2)


def _audio_dir(root):
    """``.sph`` (embedded shorten, 2 channels; mu-law; pcm), ``.wav``
    and ``.npy`` conversation audio, and a segments table over them."""
    os.makedirs(root)
    n = 8000 * 4
    pcm = np.stack([speechlike(n, 1), speechlike(n, 2, 3000.0)], axis=1)
    write_shorten_sph(os.path.join(root, "call1.sph"), pcm)
    with open(os.path.join(root, "mono-A.sph"), "wb") as f:
        f.write(sph_header(n, 1, "ulaw") + ulaw_codes(pcm[:, :1]).tobytes())
    with open(os.path.join(root, "pcm.sph"), "wb") as f:
        f.write(sph_header(n, 1, "pcm", n_bytes=2)
                + pcm[:, 0].astype("<i2").tobytes())
    with wave.open(os.path.join(root, "w.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(pcm.astype("<i2").tobytes())
    np.save(os.path.join(root, "n.npy"), pcm.astype(np.float32) / 32768.0)
    segs = [("call1-A", 0.1, 1.3), ("call1-B", 1.5, 2.5), ("mono-A", 0.0,
            1.0), ("pcm", 2.0, 3.75), ("w", 0.2, 1.0), ("n", 3.5, 3.9),
            ("n", 3.9, 3.9)]
    with open(os.path.join(root, "segments"), "w") as f:
        for i, (reco, s0, s1) in enumerate(segs):
            f.write(f"u{i}-{reco} {reco} {s0:.2f} {s1:.2f}\n")
    with open(os.path.join(root, "channel_map"), "w") as f:
        f.write("w 1\nn 0\n")
    return root


def test_cli_extract_segments_and_mfcc_and_cmvn(tmp_path):
    audio = _audio_dir(str(tmp_path / "audio"))
    seg = os.path.join(audio, "segments")
    a, b = both_clis(str(tmp_path), lambda out: [
        "extract-segments", "--segments", seg, "--audio_dir", audio,
        "--out_dir", os.path.join(out, "utts"), "--channel-map",
        os.path.join(audio, "channel_map")])
    same_tree(a, b)
    # a rate the files do not have: the same refusal
    errs = []
    for mod in (jax_prep, prep_data):
        with pytest.raises(ValueError) as e:
            run_cli(mod.main, ["extract-segments", "--segments", seg,
                               "--audio_dir", audio, "--out_dir",
                               str(tmp_path / "r"), "--rate", "16000"])
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "file sample rate" in errs[0]
    # mfcc over the utterances (+ a .wav), then per-speaker CMVN stats
    utts = os.path.join(a, "utts")
    shutil.copy(os.path.join(audio, "w.wav"), utts)
    a2, b2 = both_clis(str(tmp_path / "f"), lambda out: [
        "mfcc", utts, os.path.join(out, "feats")], device=True)
    same_tree(a2, b2, tol=FEAT_TOL)
    utt2spk = tmp_path / "utt2spk"
    utt2spk.write_text("".join(f"{f[:-4]} s{i % 2}\n" for i, f in
                               enumerate(sorted(os.listdir(utts)))))
    for root in (a2, b2):
        main = jax_prep.main if root == a2 else prep_data.main
        code, _ = run_cli(main, ["cmvn", "--feat_dir",
                                 os.path.join(root, "feats"), "--utt2spk",
                                 str(utt2spk)])
        assert code is None
    with open(os.path.join(a2, "feats", "cmvn.stats"), "rb") as f, open(
            os.path.join(b2, "feats", "cmvn.stats"), "rb") as g:
        x, y = pickle.load(f), pickle.load(g)
    assert x["utt2spk"] == y["utt2spk"] and sorted(x["stats"]) == \
        sorted(y["stats"])
    for spk, s in x["stats"].items():
        for k in ("mean", "std"):
            np.testing.assert_allclose(y["stats"][spk][k], s[k], atol=FEAT_TOL)


def test_cli_mfcc_refuses_other_rates_and_a_missing_card(tmp_path):
    import torch
    audio = tmp_path / "a"
    audio.mkdir()
    with wave.open(str(audio / "x.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(800, "<i2").tobytes())
    msgs = []
    for main, extra in ((jax_prep.main, []),
                        (prep_data.main, ["--device", "cpu"])):
        code, _ = run_cli(main, ["mfcc", str(audio), str(tmp_path / "o")]
                          + extra)
        msgs.append(code)
    assert msgs[0] == msgs[1] and "16000 Hz" in msgs[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_cli(prep_data.main, ["mfcc", str(audio), str(tmp_path / "o")])


def test_cli_pack_features(tmp_path):
    src = str(tmp_path / "src")
    npy_tree(src, seed=2)
    for extra in ([], ["--f16"]):
        a, b = both_clis(str(tmp_path / f"k{len(extra)}"), lambda out: [
            "pack-features", src, os.path.join(out, "train.pack")] + extra)
        same_tree(a, b)


def test_cli_learn_bpe_build_dicts_meteor(tmp_path):
    text = tmp_path / "train.txt"
    text.write_text("\n".join(corpus_lines(6, 40)) + "\n")
    a, b = both_clis(str(tmp_path / "b"), lambda out: [
        "learn-bpe", str(text), os.path.join(out, "codes"), "--merges",
        "25"])
    same_tree(a, b)
    src = str(tmp_path / "corpus")
    os.makedirs(src)
    write_text_corpus(src)
    a, b = both_clis(str(tmp_path / "d"), lambda out: [
        "build-dicts", src, os.path.join(out, "dicts"), "--merges", "40",
        "--sets", "train,dev,test"])
    same_tree(a, b)
    refs = tmp_path / "refs"
    refs.mkdir()
    for k in range(3):
        (refs / f"ref.en{k}").write_text(f"a{k} b\nc d{k}\né {k}\n")
    a, b = both_clis(str(tmp_path / "m"), lambda out: [
        "meteor-refs", str(refs), "--n_evals", "3", "--out",
        os.path.join(out, "meteor.en")])
    same_tree(a, b)


@pytest.mark.parametrize("flags", [["--deep"], ["--fix"],
                                   ["--fix", "--no-feats"],
                                   ["--sets", "tiny_dev", "--deep"]])
def test_cli_validate_equal(tmp_path, flags):
    (rj, _), (rp, _) = _broken_copies(
        tmp_path, [_missing_speech, _map_only,
                   lambda c: _stale_frames(c, 60), _refs_unknown])
    outs = []
    for main, root in ((jax_prep.main, rj), (prep_data.main, rp)):
        code, text = run_cli(main, ["validate", os.path.join(root, "exp")]
                             + flags)
        outs.append((code, text.replace(root, "<root>")))
    assert outs[0] == outs[1]
    same_tree(rj, rp)


def test_cli_fisher_recipe_messages_and_refusals(tmp_path):
    """The recipe's stage lines equal ast_tpu's (the trees themselves:
    tests/test_torch_recipe.py); both refuse a call without text."""
    raw = make_raw_tree(str(tmp_path / "raw"), n_utts=4)
    texts = []
    for main, name, extra in ((jax_prep.main, "j", []),
                              (prep_data.main, "p", ["--device", "cpu"])):
        out = str(tmp_path / name)
        code, text = run_cli(main, [
            "fisher-recipe", "--audio_dir", os.path.join(raw, "audio"),
            "--tdf_dir", os.path.join(raw, "tdf"), "--out", out,
            "--merges", "10", "--buckets_num", "2", "--buckets_width",
            "60"] + extra)
        assert code is None
        texts.append(text.replace(out, "<out>").splitlines())
    assert texts[0][:-1] == texts[1][:-1]
    assert texts[1][-1] == ("experiment ready: python -m "
                            "ast_tpu_torch.cli.train -m <out>/exp "
                            "-e <epochs>")
    codes = [run_cli(m, ["fisher-recipe", "--audio_dir", raw, "--out",
                         str(tmp_path / "x")])[0]
             for m in (jax_prep.main, prep_data.main)]
    assert codes[0] == codes[1] and "--tdf_dir" in codes[0]
