"""The port's one-command Fisher recipe against ast_tpu's, through both
CLIs: ``prep_data fisher-recipe --tdf_dir`` on a tiny raw tree (two
2-channel embedded-shorten SPHERE tapes and their LDC ``.tdf``
transcript tables), in features mode and in wav mode, the port's with
``--device cpu`` (ast_tpu's shorten decoder in Python: its native
library is not loaded here).  The two trees hold the same files: text, pickles,
refs and configs byte for byte (paths with the root replaced), the
features and CMVN statistics within 1e-4, the wav-mode audio bit-equal;
and ``prep_data validate`` prints the same report over both.
"""

import contextlib
import io
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest

from ast_tpu_torch.data import shorten as sh
from chip_smoke import TDF_HEADER, sph_header, tdf_row
from tests.conftest import TINY_MODEL_CFG

FEAT_TOL = 1e-4


def speechlike(n, seed, scale=6000.0):
    """Integer PCM with a speech-like envelope."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = (scale * np.sin(t / 23.0) * (0.5 + 0.5 * np.sin(t / 311.0) ** 2)
         + rng.randn(n) * scale * 0.05)
    return np.round(x).astype(np.int64)


def ulaw_codes(pcm2):
    """(n, channels) int PCM -> the nearest mu-law byte codes."""
    return np.stack([sh._nearest_code(pcm2[:, c], sh._ULAW_EXPAND)
                     for c in range(pcm2.shape[1])], axis=1)


def write_shorten_sph(path, pcm2):
    """2-channel mu-law embedded-shorten-v2 SPHERE from int PCM, by the
    port's encoder; returns the shorten stream."""
    data = sh.encode(sh._SIGNMAG_IN[ulaw_codes(pcm2)], sh.TYPE_AU1,
                     nmean=4)
    with open(path, "wb") as f:
        f.write(sph_header(len(pcm2), pcm2.shape[1],
                           "ulaw,embedded-shorten-v2") + data)
    return data


def write_tdf(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        f.write(TDF_HEADER + "\n".join(rows) + "\n")


def make_raw_tree(root, n_utts=8, seed=7):
    """``root``/audio (two 12 s tapes), ``root``/tdf and
    ``root``/translations (utt<TAB>text: the AST side)."""
    audio, tdfs = os.path.join(root, "audio"), os.path.join(root, "tdf")
    os.makedirs(audio)
    os.makedirs(tdfs)
    rng = np.random.RandomState(seed)
    words = [f"palabra{i}" for i in range(8)]
    trans = []
    for ci, conv in enumerate(["tape_one", "tape_two"]):
        n = 8000 * 12
        pcm = np.stack([speechlike(n, 30 + ci),
                        speechlike(n, 40 + ci, scale=3000.0)], axis=1)
        write_shorten_sph(os.path.join(audio, f"{conv}.sph"), pcm)
        rows, t = [], 0.25
        for k in range(n_utts):
            dur = 0.8 + 0.1 * (k % 3)
            sent = " ".join(words[rng.randint(8)]
                            for _ in range(rng.randint(2, 6)))
            if k == 3:
                sent += " <laugh>ja ja</laugh>"
            s0, s1 = round(t, 2), round(t + dur, 2)
            rows.append(tdf_row(conv, k % 2, s0, s1, sent))
            side = "B" if k % 2 else "A"
            trans.append(f"{conv}-{side}-{int(s0 * 100):06d}-"
                         f"{int(s1 * 100):06d}\tword{k} thing{ci} word{k}")
            t += dur + 0.2
        write_tdf(os.path.join(tdfs, f"{conv}.tdf"), rows)
    with open(os.path.join(root, "translations"), "w") as f:
        f.write("\n".join(trans) + "\n")
    return root


@contextlib.contextmanager
def python_readers_in_ast_tpu():
    """ast_tpu's readers take their Python paths: ``ast_tpu.native``
    (which builds a library when it is imported) is, meanwhile, a module
    without them."""
    stub = types.ModuleType("ast_tpu.native")
    stub.fast_text_ark = stub.fast_shn_decode = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "ast_tpu.native", stub)
        yield


def run_cli(main, argv):
    """``main(argv)`` with stdout captured: (exit code or None, text)."""
    out = io.StringIO()
    code = None
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


def recipe_argv(raw, out, wav, model_cfg):
    argv = ["fisher-recipe", "--audio_dir", os.path.join(raw, "audio"),
            "--tdf_dir", os.path.join(raw, "tdf"), "--out", out,
            "--merges", "30", "--buckets_num", "4", "--buckets_width", "50",
            "--batch_size", "4", "--model_cfg", model_cfg,
            "--seed", "tdfe2e"]
    if wav:
        argv += ["--wav", "--translations",
                 os.path.join(raw, "translations")]
    return argv


def build_trees(tmp, wav):
    """The same raw tree through both packages' fisher-recipe CLIs:
    (ast_tpu's out dir, the port's out dir)."""
    import ast_tpu.cli.prep_data as jax_prep
    from ast_tpu_torch.cli import prep_data

    raw = make_raw_tree(os.path.join(tmp, "raw"))
    mc = os.path.join(tmp, "tiny_model.json")
    with open(mc, "w") as f:
        json.dump(TINY_MODEL_CFG, f)
    outs = []
    for name, main, extra in (("jax", jax_prep.main, []),
                              ("port", prep_data.main,
                               ["--device", "cpu"])):
        out = os.path.join(tmp, name)
        with python_readers_in_ast_tpu():
            code, _ = run_cli(main, recipe_argv(raw, out, wav, mc) + extra)
        assert code is None
        outs.append(out)
    return outs


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_trees_equal(jax_out, port_out, wav):
    """Every file of the two trees: features / stats within FEAT_TOL,
    everything else byte-equal with the root's path replaced."""
    files = tree_files(jax_out)
    assert files == tree_files(port_out)
    n_feats = 0
    for rel in files:
        a, b = os.path.join(jax_out, rel), os.path.join(port_out, rel)
        if rel.startswith("speech") and rel.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.shape == y.shape and x.dtype == y.dtype, rel
            if wav:
                np.testing.assert_array_equal(y, x, err_msg=rel)
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=FEAT_TOL,
                                           err_msg=rel)
            n_feats += 1
        elif rel.endswith("cmvn.stats"):
            with open(a, "rb") as f, open(b, "rb") as g:
                x, y = pickle.load(f), pickle.load(g)
            assert x["utt2spk"] == y["utt2spk"]
            assert sorted(x["stats"]) == sorted(y["stats"])
            for spk, s in x["stats"].items():
                assert y["stats"][spk]["count"] == s["count"]
                for k in ("mean", "std"):
                    np.testing.assert_allclose(y["stats"][spk][k], s[k],
                                               rtol=0, atol=FEAT_TOL)
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                want = f.read().replace(jax_out.encode(), port_out.encode())
                assert g.read() == want, rel
    assert n_feats > 0


@pytest.fixture(scope="module", params=["features", "wav"])
def trees(request, tmp_path_factory):
    wav = request.param == "wav"
    jax_out, port_out = build_trees(
        str(tmp_path_factory.mktemp(request.param)), wav)
    return jax_out, port_out, wav


def test_recipe_trees_equal(trees):
    jax_out, port_out, wav = trees
    assert_trees_equal(jax_out, port_out, wav)
    with open(os.path.join(port_out, "exp", "train_cfg.json")) as f:
        cfg = json.load(f)
    assert (cfg["data"].get("features") == "wav") == wav
    # the frame counts in info are exact: num_frames of each utterance
    with open(cfg["data"]["info_path"], "rb") as f:
        info = pickle.load(f)
    assert all(e["sp"] > 0 for s in info.values() for e in s.values())


def test_recipe_validate_reports_equal(trees):
    import ast_tpu.cli.prep_data as jax_prep
    from ast_tpu_torch.cli import prep_data

    jax_out, port_out, _ = trees
    reports = []
    for main, out in ((jax_prep.main, jax_out), (prep_data.main, port_out)):
        with python_readers_in_ast_tpu():
            code, text = run_cli(main, ["validate", os.path.join(out, "exp"),
                                        "--deep"])
        assert code is None, text
        reports.append(text.replace(out, "<root>"))
    assert reports[0] == reports[1]
    assert "\n0 errors, " in reports[1]


def test_recipe_refuses_a_missing_card(tmp_path):
    import torch

    from ast_tpu_torch.data.recipe import fisher_recipe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fisher_recipe(str(tmp_path), tdf_dir=str(tmp_path),
                      out=str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")
