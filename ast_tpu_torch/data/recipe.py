"""One-command Fisher-style corpus recipe: raw tapes -> runnable
experiment directory -- the port's copy of ``ast_tpu/data/recipe.py``,
with the MFCC front-end on the device the caller names.

The reference's data preparation is a chained shell pipeline
(reference: linking_files/fisher/kaldi/train_all.sh:32-60 — data prep
-> make_mfcc -> fix/validate -> splits -> compute_cmvn) driving Kaldi
binaries and sph2pipe.  Every stage is an individually tested
component; this module is the composition: ONE call (or
``prep_data fisher-recipe``) goes from

    <audio_dir>/<reco>.sph           (embedded-shorten / pcm / ulaw /
                                      .wav / .npy conversation audio)
    <segments>                       Kaldi segments table
                                     (utt reco start_sec end_sec)
    <text_dir>/<set>.ids             utterance ids, one per line
    <text_dir>/<set>.clean.text      transcripts, pairing line-for-line

to a complete experiment tree:

    <out>/speech/<set>/<utt>.npy     CMVN'd MFCC features (or raw audio
                                     + cmvn.stats in wav mode)
    <out>/data/                      map/vocab/info pickles, BPE codes,
                                     refs/<set>/{eval.ids, ref.en0}
    <out>/exp/{train_cfg,model_cfg}.json   ready for train.py / beam.py

Stages (all in-repo, zero external tools):
  0. tdf-to-text        OPTIONAL (``tdf_dir=``): raw LDC ``.tdf``
                        transcript tables -> per-set .ids/.clean.text
                        + segments + channel_map (data/transcripts.py
                        — fsp_make_trans.pl + fsp_data_prep.sh stage 2
                        + get_clean-text_ids.sh semantics); with this,
                        the recipe input is raw tapes + raw
                        transcripts only
  1. extract-segments   slice conversations to per-utt audio
                        (wav_loader.extract_segments; shorten decode
                        is native via ast_tpu_torch/native/
                        shorten_dec.cc)
  2. mfcc               matmul-DFT extractor (ops/fbank) on ``device``:
                        one utterance a call, frames past its count
                        never computed (``ast_tpu`` pads to whole
                        seconds for XLA's shapes; the frames are equal)
  3. cmvn               per-speaker stats; features normalized on disk
                        like the reference's apply-cmvn step
  4. learn-bpe/apply + build-dicts + refs   (data/preprocess)
  5. configs            train_cfg/model_cfg with paths + bucket
                        geometry derived from the actual frame
                        distribution
  6. validate           data/validate consistency check
"""

import json
import os
import pickle
import shutil

import numpy as np

from ast_tpu_torch.params import torch_device

# flagship model configuration (mirrors experiments/es_en_20h/
# model_cfg.json — reference model shape, seq2seq.py:30-80)
DEFAULT_MODEL_CFG = {
    "dropout": {"embed": 0.3, "rnn": 0.3, "out": 0},
    "rnn_config": {
        "bi_rnn": True, "enc_layers": 3, "dec_layers": 3,
        "hidden_units": 512, "embedding_units": 128, "attn_units": 512,
        "n_attn": 1, "feed_attn": True, "ln": False,
    },
    "cnn_config": {
        "bn": True,
        "cnn_layers": [
            {"in_channels": None, "out_channels": 128,
             "ksize": [9, 13], "stride": [2, 13], "pad": [4, 0]},
            {"in_channels": None, "out_channels": 512,
             "ksize": [9, 1], "stride": [2, 1], "pad": [4, 0]},
        ],
    },
}


def _read_lines(path):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


def fisher_recipe(audio_dir, segments=None, text_dir=None, out=None,
                  sets=("train", "dev"), channel_map=None, utt2spk=None,
                  bpe_merges=1000, buckets_num=20, buckets_width=80,
                  wav_mode=False, model_cfg=None, batch_size=32,
                  seed="fisher-recipe", max_pred=None, rate=8000,
                  allow_missing=False, tdf_dir=None, splits=None,
                  dev_fraction=0.1, translations=None, log=print,
                  device="cuda"):
    """Run the full raw-tree -> experiment pipeline.  Returns the
    experiment directory (pass it to ``ast_tpu_torch.cli.train -m``).

    ``channel_map``: {reco: channel} dict or a path to `reco channel`
    lines (Fisher tapes are 2-channel, one speaker per side); unmapped
    recos are channel-averaged.  ``utt2spk``: optional {utt: spk} dict
    or file; default speaker = the utterance's recording (so CMVN is
    per-conversation-side, the Fisher convention when each reco+channel
    is one speaker).  ``wav_mode``: ship raw audio + cmvn.stats and let
    the train step compute MFCC on its device (data.features="wav")
    instead of materializing feature files.  ``device``: where the MFCC
    front-end runs (default ``cuda``, which must exist: no silent CPU).

    ``tdf_dir``: stage 0 — raw LDC ``.tdf`` transcript tables.  When
    given, ``segments``/``text_dir``/``channel_map`` are DERIVED
    in-repo (data/transcripts.py reimplements the reference's
    fsp_make_trans.pl + fsp_data_prep.sh stage 2 +
    get_clean-text_ids.sh chain) instead of being required inputs, so
    the recipe truly starts from raw tapes + raw transcripts.
    ``splits``: conversation-level split spec for stage 0 ({set:
    call_ids} or a directory of ``<set>`` call-id list files, the
    reference's local/splits layout); default: deterministic hash
    split by ``dev_fraction``.  ``translations``: optional {utt: text}
    or ``utt<TAB>text`` file giving the target side (AST); default
    trains on the cleaned source transcript (ASR).
    """
    from ast_tpu_torch.data.preprocess import prepare_corpus
    from ast_tpu_torch.data.wav_loader import extract_segments
    from ast_tpu_torch.ops.fbank import (
        MfccConfig, MfccExtractor, compute_cmvn_stats, num_frames)

    # before any stage: --device cuda without a card raises here
    dev = torch_device(device)
    os.makedirs(out, exist_ok=True)
    if tdf_dir is not None:
        from ast_tpu_torch.data.transcripts import prepare_fisher_text
        if splits is None and tuple(sets) != ("train", "dev"):
            # the hash split only produces train/dev; silently
            # overriding the caller's set names would drop sets
            raise ValueError(
                f"tdf_dir without splits derives sets ('train', 'dev');"
                f" pass splits= (a dir of <set> call-id lists) to use "
                f"custom set names {tuple(sets)}")
        derived = prepare_fisher_text(
            tdf_dir, os.path.join(out, "text"), splits=splits,
            sets=tuple(sets) if splits is not None else None,
            dev_fraction=dev_fraction, seed=str(seed),
            translations=translations, log=log)
        segments = derived["segments"]
        text_dir = derived["text_dir"]
        if channel_map is None:
            channel_map = derived["channel_map"]
    if segments is None or text_dir is None:
        raise ValueError(
            "fisher_recipe needs segments+text_dir (pre-cleaned text) "
            "or tdf_dir (raw transcripts, stage 0 derives them)")
    speech_root = os.path.join(out, "speech")
    data_dir = os.path.join(out, "data")
    exp_dir = os.path.join(out, "exp")
    for d in (speech_root, data_dir, exp_dir):
        os.makedirs(d, exist_ok=True)

    ids = {c: _read_lines(os.path.join(text_dir, f"{c}.ids"))
           for c in sets}
    set_of = {}
    for c in sets:
        for u in ids[c]:
            set_of[u] = c

    # ---- 1. extract-segments: conversations -> per-utt audio --------
    utt_audio = os.path.join(out, "_audio_utts")
    n = extract_segments(segments, audio_dir, utt_audio,
                         channel_map=channel_map, rate=rate,
                         allow_missing=allow_missing)
    log(f"[1/6] extract-segments: {n} utterances")

    if utt2spk is None:
        spk_of = {}
    elif isinstance(utt2spk, str):
        spk_of = {}
        for line in _read_lines(utt2spk):
            parts = line.split()
            if len(parts) >= 2:
                spk_of[parts[0]] = parts[1]
    else:
        spk_of = dict(utt2spk)
    if not spk_of:
        # default: speaker = recording (one conversation side per reco
        # once channel_map splits sides)
        for line in _read_lines(segments):
            parts = line.split()
            if len(parts) >= 2:
                spk_of[parts[0]] = parts[1]

    mfcc_cfg = MfccConfig(sample_rate=rate)
    ext = MfccExtractor(mfcc_cfg, device=dev)

    def featurize(audio, true_frames):
        return ext(audio[None])[0][:true_frames].cpu().numpy()

    # ---- 2+3. features + CMVN per set -------------------------------
    frames = {c: {} for c in sets}
    all_utt2spk = {}
    all_stats = {}
    missing = []
    for c in sets:
        set_dir = os.path.join(speech_root, c)
        os.makedirs(set_dir, exist_ok=True)
        feats = {}
        for u in ids[c]:
            src = os.path.join(utt_audio, f"{u}.npy")
            if not os.path.exists(src):
                missing.append(u)
                continue
            audio = np.load(src)
            frames[c][u] = num_frames(mfcc_cfg, len(audio))
            feats[u] = featurize(audio, frames[c][u])
            if wav_mode:
                os.replace(src, os.path.join(set_dir, f"{u}.npy"))
        # per-speaker CMVN inside the split (reference:
        # train_all.sh:53-58 compute_cmvn_stats per set + apply-cmvn)
        by_spk = {}
        for u, f in feats.items():
            by_spk.setdefault(spk_of.get(u, u), []).append(f)
        stats = {spk: compute_cmvn_stats(arrs)
                 for spk, arrs in by_spk.items()}
        if wav_mode:
            # stats ride along; normalization happens in-graph
            all_utt2spk.update({u: spk_of.get(u, u) for u in frames[c]})
            all_stats.update(stats)
        else:
            for u, feat in feats.items():
                s = stats[spk_of.get(u, u)]
                feat = (feat - s["mean"]) / s["std"]
                np.save(os.path.join(set_dir, f"{u}.npy"),
                        feat.astype(np.float32))
        log(f"[2-3/6] {c}: {len(frames[c])} utts featurized"
            + ("" if wav_mode else " + CMVN'd")
            + f" ({len(stats)} speakers)")
    if wav_mode:
        with open(os.path.join(speech_root, "cmvn.stats"), "wb") as fh:
            pickle.dump({"utt2spk": all_utt2spk, "stats": all_stats},
                        fh)
    # the staging dir was consumed (features written / audio moved);
    # don't leave a second copy of the corpus on disk (at 160 h that
    # doubles storage)
    shutil.rmtree(utt_audio, ignore_errors=True)
    if missing:
        msg = (f"{len(missing)} utterances in ids files have no "
               f"extracted audio (first: {missing[:5]})")
        if allow_missing:
            log(f"warning: {msg}")
            ids = {c: [u for u in ids[c] if u in frames[c]]
                   for c in sets}
        else:
            raise FileNotFoundError(msg)

    # ---- 4. BPE + dicts + refs --------------------------------------
    # prepare_corpus reads <set>.ids/<set>.clean.text from text_dir and
    # takes frame counts from speech_frames (features live as npy files
    # — no duplicate pickle of the raw arrays)
    paths = prepare_corpus(text_dir, data_dir, bpe_merges=bpe_merges,
                           sets=tuple(sets), speech_frames=frames)
    log(f"[4/6] dicts + BPE codes + refs in {data_dir}")

    # ---- 5. configs --------------------------------------------------
    if max_pred is None:
        with open(paths["map"], "rb") as f:
            map_dict = pickle.load(f)
        longest = max((len(e["bpe_w"]) for c in sets
                       for e in map_dict[c].values()), default=16)
        max_pred = int(longest * 1.5) + 8
    train_cfg = {
        "seed": seed,
        "iters_save": 10,
        "train_set": sets[0],
        "dev_set": sets[1] if len(sets) > 1 else sets[0],
        "extras": {"random_out": 0, "speech_noise": 0.25,
                   "teach_ratio": 0.8},
        "data": {
            "enc_key": "sp",
            "dec_key": "bpe_w",
            "speech_path": os.path.abspath(speech_root),
            "map_path": os.path.abspath(paths["map"]),
            "vocab_path": os.path.abspath(paths["vocab"]),
            "max_pred": max_pred,
            "info_path": os.path.abspath(paths["info"]),
            "refs_path": os.path.abspath(os.path.join(data_dir, "refs")),
            "n_evals": 1,
            "buckets_num": buckets_num,
            "buckets_width": buckets_width,
            "train_scale": 1,
            "zero_input": 0.1,
        },
        "optimizer": {"type": 0, "lr": 0.001, "l2": 0.0001,
                      "grad_clip": 2, "grad_noise_eta": 0,
                      "freeze": []},
        "batch_size": batch_size,
    }
    if wav_mode:
        train_cfg["data"]["features"] = "wav"
    if isinstance(model_cfg, str):
        with open(model_cfg) as f:
            model_cfg = json.load(f)
    with open(os.path.join(exp_dir, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f, indent=1)
    with open(os.path.join(exp_dir, "model_cfg.json"), "w") as f:
        json.dump(model_cfg or DEFAULT_MODEL_CFG, f, indent=1)
    log(f"[5/6] configs in {exp_dir}")

    # ---- 6. validate -------------------------------------------------
    from ast_tpu_torch.data.validate import validate_corpus
    problems, summary = validate_corpus(train_cfg, sets=list(sets))
    log("[6/6] validate: "
        + ("clean" if not problems else f"{len(problems)} findings"))
    for p in problems[:20]:
        log(f"  {p}")
    return exp_dir
