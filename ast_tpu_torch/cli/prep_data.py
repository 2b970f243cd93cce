"""Data preparation CLI — the offline pipeline as one tool: the port's
copy of ``ast_tpu/cli/prep_data.py``, every subcommand with its flags,
messages and outputs.  ``mfcc``, ``bnf`` and ``fisher-recipe`` compute on
``--device`` (default ``cuda``, which must exist: no silent CPU).

Replaces the reference's shell-script chain (linking_files/*.sh driving
Kaldi binaries + kaldi_io.py + prep_speech_segments.py + preprocess_gp.py
— SURVEY §3.5) with subcommands over in-repo implementations, so the
stripped data blobs (fisher.map / *.info — .MISSING_LARGE_BLOBS) are
regenerable end to end:

  tdf-to-text      raw LDC .tdf transcripts -> per-set .ids/.clean.text
                   + segments + channel_map (fsp_make_trans.pl +
                   fsp_data_prep.sh stage 2 + get_clean-text_ids.sh)
  clean-text       'utt words' text -> aligned .ids + .clean.text
  ark-to-conv      text ark -> per-conversation .np pickles (C++ fast path)
  extract-segments Kaldi segments table + conversation audio -> per-utt audio
  merge-segments   conversation pickles + segment lists -> per-utt .npy
  mfcc             raw audio dir -> per-utt MFCC .npy (on --device)
  bnf              features -> nnet2 bottleneck features
  pack-features    per-utt .npy dir -> one mmap-able .pack file
  cmvn             feature dir + utt2spk -> cmvn.stats pickle
  learn-bpe        tokenized text -> BPE codes
  build-dicts      corpus dir -> map/vocab/info/data pickles + refs
  meteor-refs      ref.en0..N-1 -> METEOR multi-ref layout
  validate         corpus consistency check (+ --fix in-place repair)
  fisher-recipe    ALL of the above in one command: raw tapes +
                   segments + transcripts -> runnable experiment dir
                   (the reference's train_all.sh:32-60 chain, in-repo)

Usage: python -m ast_tpu_torch.cli.prep_data <subcommand> [args]
"""

import argparse
import os
import pickle
import sys

import numpy as np

from ast_tpu_torch.params import torch_device


def _device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the computation (default cuda; "
                        "cpu runs it on the host)")


def cmd_extract_segments(args):
    from ast_tpu_torch.data.wav_loader import extract_segments
    n = extract_segments(args.segments, args.audio_dir, args.out_dir,
                         channel_map=args.channel_map, rate=args.rate,
                         allow_missing=args.allow_missing)
    print(f"wrote {n} utterance audio files to {args.out_dir}")


def cmd_ark_to_conv(args):
    from ast_tpu_torch.data.kaldi_ark import ark_to_conversation_pickles
    n = ark_to_conversation_pickles(args.ark, args.out_dir)
    print(f"wrote {n} conversation pickles to {args.out_dir}")


def cmd_merge_segments(args):
    """Concatenate per-segment features into per-utterance .npy files.

    ``--map`` points at a pickle {utt: {"seg": [segment ids]}} (the
    reference's map layout, prep_speech_segments.py:23-70).  Conversation
    pickles are loaded on demand (one at a time) using the segment-id
    convention ``conv = seg.rsplit('-', 2)[0]``, so memory stays
    O(one conversation).  An utterance with ANY missing segment is
    skipped loudly — truncated feature files silently corrupt training.
    """
    from ast_tpu_torch.data.kaldi_ark import merge_segments
    with open(args.map, "rb") as f:
        seg_map = pickle.load(f)
    os.makedirs(args.out_dir, exist_ok=True)

    conv_cache = {}

    def load_conv(conv):
        if conv not in conv_cache:
            conv_cache.clear()  # one conversation resident at a time
            path = os.path.join(args.conv_dir, conv + ".np")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    conv_cache[conv] = pickle.load(f)
            else:
                conv_cache[conv] = {}
        return conv_cache[conv]

    n, n_skipped = 0, 0
    # group utterances by conversation so each pickle loads once
    by_conv = {}
    for utt, entry in seg_map.items():
        segs = entry["seg"] if isinstance(entry, dict) else entry
        conv = segs[0].rsplit("-", 2)[0] if segs else ""
        by_conv.setdefault(conv, []).append((utt, segs))

    for conv in sorted(by_conv):
        data = load_conv(conv)
        for utt, segs in by_conv[conv]:
            if not segs:
                # same skip path as missing segments — concatenating
                # zero arrays would abort the whole run mid-way
                print(f"warning: skipping {utt}: empty segment list",
                      file=sys.stderr)
                n_skipped += 1
                continue
            missing = [s for s in segs if s not in data]
            if missing:
                print(f"warning: skipping {utt}: missing segments "
                      f"{missing}", file=sys.stderr)
                n_skipped += 1
                continue
            np.save(os.path.join(args.out_dir, f"{utt}.npy"),
                    merge_segments([data[s] for s in segs]))
            n += 1
    print(f"wrote {n} utterance feature files to {args.out_dir}"
          + (f" ({n_skipped} skipped: missing/empty segments)"
             if n_skipped else ""))
    if n_skipped and not args.allow_missing:
        sys.exit(f"error: {n_skipped} utterances had missing or empty "
                 "segments (pass --allow-missing to proceed anyway)")


def cmd_mfcc(args):
    from ast_tpu_torch.data.wav_loader import read_wav
    from ast_tpu_torch.ops.fbank import MfccExtractor
    ext = MfccExtractor(device=torch_device(args.device))
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(args.audio_dir)):
        path = os.path.join(args.audio_dir, fname)
        if fname.endswith(".wav"):
            audio, rate = read_wav(path, with_rate=True)
            if rate != ext.cfg.sample_rate:
                # silently framing 16 kHz audio with 8 kHz geometry
                # corrupts every feature file (wrong time scale + mel
                # warp); infer.py rejects this for the same reason
                sys.exit(f"error: {fname} is {rate} Hz but the "
                         f"extractor expects {ext.cfg.sample_rate} Hz "
                         "— resample the audio first")
        elif fname.endswith(".npy"):
            audio = np.load(path).astype(np.float32).reshape(-1)
        else:
            continue
        feats = ext(audio[None])[0].cpu().numpy()
        np.save(os.path.join(args.out_dir,
                             fname.rsplit(".", 1)[0] + ".npy"), feats)
        n += 1
    print(f"extracted MFCC for {n} files into {args.out_dir}")


def cmd_bnf(args):
    """Bottleneck features: forward precomputed features through a
    text-format Kaldi nnet2 raw net (reference: create_bnfs.sh:46-53 ->
    dump_bottleneck_features.sh -> nnet-compute final.raw), on
    ``--device``."""
    from ast_tpu_torch.ops import bnf as bnf_ops
    device = torch_device(args.device)
    net = bnf_ops.net_to(bnf_ops.load_nnet2(args.model), device)
    transform = np.loadtxt(args.lda_mat) if args.lda_mat else None
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(args.feat_dir)):
        if not fname.endswith(".npy"):
            continue
        feats = bnf_ops.to_device(
            np.load(os.path.join(args.feat_dir, fname)), device)
        if args.feat_type == "delta":
            feats = bnf_ops.add_deltas(feats)
        elif args.feat_type == "lda":
            feats = bnf_ops.splice_frames(feats, args.splice, args.splice)
            if transform is not None:
                feats = bnf_ops.apply_transform(feats, transform)
        out = bnf_ops.nnet2_forward(net, feats).cpu().numpy()
        np.save(os.path.join(args.out_dir, fname), out)
        n += 1
    print(f"wrote BNF for {n} files into {args.out_dir}")


def cmd_pack_features(args):
    """Pack a split's per-utterance .npy features into one mmap-able
    file the dataloader serves without per-utterance opens
    (ast_tpu_torch/data/feature_pack.py)."""
    from ast_tpu_torch.data.feature_pack import pack_features
    dtype = np.float16 if args.f16 else None
    n = pack_features(args.src_dir, args.out, dtype=dtype)
    size = os.path.getsize(args.out)
    print(f"packed {n} utterances into {args.out} "
          f"({size / 1e6:.1f} MB{', f16' if args.f16 else ''})")


def cmd_cmvn(args):
    """Per-speaker CMVN statistics (reference: compute_cmvn_stats.sh +
    apply-cmvn --norm-vars=true, SURVEY §2.4)."""
    from ast_tpu_torch.ops.fbank import compute_cmvn_stats
    utt2spk = {}
    with open(args.utt2spk) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                utt2spk[parts[0]] = parts[1]
    by_spk = {}
    for fname in sorted(os.listdir(args.feat_dir)):
        if not fname.endswith(".npy"):
            continue
        utt = fname[:-4]
        spk = utt2spk.get(utt)
        if spk is None:
            continue
        by_spk.setdefault(spk, []).append(
            np.load(os.path.join(args.feat_dir, fname)))
    stats = {spk: compute_cmvn_stats(arrays)
             for spk, arrays in by_spk.items()}
    out = os.path.join(args.feat_dir, "cmvn.stats")
    with open(out, "wb") as f:
        pickle.dump({"utt2spk": utt2spk, "stats": stats}, f)
    print(f"wrote per-speaker CMVN stats for {len(stats)} speakers: {out}")


def cmd_learn_bpe(args):
    from ast_tpu_torch.data.bpe import learn_bpe, save_merges
    corpus = []
    with open(args.text, encoding="utf-8") as f:
        for line in f:
            corpus.append(line.split())
    merges = learn_bpe(corpus, num_merges=args.merges)
    save_merges(merges, args.out)
    print(f"learned {len(merges)} merges -> {args.out}")


def cmd_build_dicts(args):
    from ast_tpu_torch.data.preprocess import prepare_corpus
    paths = prepare_corpus(args.in_path, args.out_path,
                           bpe_merges=args.merges,
                           sets=tuple(args.sets.split(",")))
    for k, v in paths.items():
        print(f"{k}: {v}")


def cmd_meteor_refs(args):
    from ast_tpu_torch.eval.bleu import export_meteor_refs
    out = export_meteor_refs(args.refs_dir, args.n_evals, args.out)
    print(f"wrote METEOR {args.n_evals}-ref file: {out}")


def cmd_validate(args):
    """Corpus consistency check + optional in-place repair (the
    reference pipeline's validate_data_dir.sh / fix_data_dir.sh step,
    reference: linking_files/fisher/kaldi/train_all.sh:35-36)."""
    import json

    from ast_tpu_torch.data.validate import fix_corpus, validate_corpus
    cfg_path = os.path.join(args.exp_dir, "train_cfg.json")
    if not os.path.exists(cfg_path):
        sys.exit(f"error: no train_cfg.json under {args.exp_dir}")
    with open(cfg_path) as f:
        train_cfg = json.load(f)
    sets = args.sets.split(",") if args.sets else None

    if args.fix:
        result = fix_corpus(train_cfg, sets=sets, deep=not args.no_feats,
                            check_features=not args.no_feats)
        print(f"fix: dropped {result['dropped']} utterances, repaired "
              f"{result['repaired']} frame counts, filtered "
              f"{result['refs_filtered']} refs lines"
              + (" (originals saved as .bak)"
                 if result["dropped"] or result["repaired"] else ""))

    # the post-fix confirmation pass is sampled unless --deep was asked
    # for explicitly: fix_corpus already deep-read every feature file,
    # and a second full read doubles hours of I/O at 160h scale
    problems, summary = validate_corpus(
        train_cfg, sets=sets, check_features=not args.no_feats,
        deep=args.deep)
    for p in problems:
        print(p)
    for set_key, stats in summary["sets"].items():
        extra = (f", OOV {stats['oov_rate']:.1%}" if "oov_rate" in stats
                 else "")
        print(f"{set_key}: {stats['n_info']} utts in info, "
              f"{stats['n_map']} in map{extra}")
    print(f"{summary['n_errors']} errors, {summary['n_warnings']} warnings")
    if summary["n_errors"]:
        sys.exit(1)


def cmd_fisher_recipe(args):
    """One command from a raw LDC-style tree to a runnable experiment
    (reference: linking_files/fisher/kaldi/train_all.sh:32-60 chains
    the same stages through Kaldi + sph2pipe; every stage here is
    in-repo — see ast_tpu_torch/data/recipe.py)."""
    from ast_tpu_torch.data.recipe import fisher_recipe
    if args.tdf_dir is None and (args.segments is None
                                 or args.text_dir is None):
        sys.exit("error: pass --segments + --text_dir (pre-cleaned "
                 "text) or --tdf_dir (raw LDC transcripts)")
    exp = fisher_recipe(
        audio_dir=args.audio_dir, segments=args.segments,
        text_dir=args.text_dir, out=args.out,
        sets=tuple(args.sets.split(",")),
        channel_map=args.channel_map, utt2spk=args.utt2spk,
        bpe_merges=args.merges, buckets_num=args.buckets_num,
        buckets_width=args.buckets_width, wav_mode=args.wav,
        model_cfg=args.model_cfg, batch_size=args.batch_size,
        seed=args.seed, rate=args.rate,
        allow_missing=args.allow_missing, tdf_dir=args.tdf_dir,
        splits=args.splits, dev_fraction=args.dev_fraction,
        translations=args.translations, device=args.device)
    print(f"experiment ready: python -m ast_tpu_torch.cli.train -m {exp} "
          f"-e <epochs>")


def cmd_tdf_to_text(args):
    """Raw LDC .tdf transcripts -> per-set .ids/.clean.text + segments
    + channel_map (reference: fsp_make_trans.pl + fsp_data_prep.sh
    stage 2 + get_clean-text_ids.sh, reimplemented in
    data/transcripts.py)."""
    from ast_tpu_torch.data.transcripts import prepare_fisher_text
    res = prepare_fisher_text(
        args.tdf_dir, args.out_dir, splits=args.splits,
        sets=tuple(args.sets.split(",")) if args.sets else None,
        dev_fraction=args.dev_fraction, seed=args.seed,
        translations=args.translations)
    for k, v in sorted(res["counts"].items()):
        print(f"{k}: {v} utterances")
    print(f"text tree ready in {res['text_dir']}")


def cmd_clean_text(args):
    """Kaldi-style `utt words...` text file -> aligned .ids +
    .clean.text pair (reference: get_clean-text_ids.sh:10-21 — label
    split, [bracket] annotation strip, punctuation strip)."""
    from ast_tpu_torch.data.transcripts import clean_text_ids
    with open(args.text, encoding="utf-8") as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    ids, cleans = clean_text_ids(lines)
    # splitext only strips the FILENAME's extension (rsplit('.') would
    # truncate at a dotted parent directory for extensionless files)
    base = args.out or os.path.splitext(args.text)[0]
    with open(base + ".ids", "w") as f:
        f.write("\n".join(ids) + ("\n" if ids else ""))
    with open(base + ".clean.text", "w", encoding="utf-8") as f:
        f.write("\n".join(cleans) + ("\n" if cleans else ""))
    print(f"wrote {base}.ids + {base}.clean.text ({len(ids)} lines)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser(
        "fisher-recipe",
        help="raw tapes (+segments+transcripts) -> complete runnable "
             "experiment dir in one command (extract-segments -> mfcc "
             "-> cmvn -> bpe -> dicts -> refs -> configs -> validate)")
    p.add_argument("--audio_dir", required=True,
                   help="directory of <reco>.sph|.wav|.npy (embedded-"
                        "shorten SPHERE decodes natively; reco "
                        "'<call>-A/-B' falls back to 2-channel "
                        "<call>.sph sides)")
    p.add_argument("--segments", default=None,
                   help="Kaldi segments file: utt reco start end "
                        "(omit with --tdf_dir: derived from the raw "
                        "transcripts)")
    p.add_argument("--text_dir", default=None,
                   help="directory of <set>.ids + <set>.clean.text "
                        "(omit with --tdf_dir)")
    p.add_argument("--tdf_dir", default=None,
                   help="stage 0: directory of raw LDC .tdf "
                        "transcript tables; segments/text/channel_map "
                        "are derived in-repo (fsp_make_trans.pl + "
                        "fsp_data_prep.sh stage-2 + "
                        "get_clean-text_ids.sh semantics)")
    p.add_argument("--splits", default=None,
                   help="with --tdf_dir: directory of <set> files "
                        "listing call ids (reference local/splits "
                        "layout); default: hash split by "
                        "--dev-fraction")
    p.add_argument("--dev-fraction", dest="dev_fraction", type=float,
                   default=0.1)
    p.add_argument("--translations", default=None,
                   help="with --tdf_dir: 'utt<TAB>target text' file "
                        "supplying the translation side (AST); "
                        "default: cleaned source transcript (ASR)")
    p.add_argument("--out", required=True, help="output tree root")
    p.add_argument("--sets", default="train,dev",
                   help="comma list; first is the train set")
    p.add_argument("--channel-map", dest="channel_map", default=None,
                   help="file of 'reco channel' lines (Fisher A/B)")
    p.add_argument("--utt2spk", default=None,
                   help="file of 'utt spk' lines for CMVN grouping "
                        "(default: speaker = recording)")
    p.add_argument("--merges", type=int, default=1000)
    p.add_argument("--buckets_num", type=int, default=20)
    p.add_argument("--buckets_width", type=int, default=80)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", default="fisher-recipe")
    p.add_argument("--rate", type=int, default=8000)
    p.add_argument("--wav", action="store_true",
                   help="wav mode: ship raw audio + cmvn.stats; MFCC "
                        "runs inside the train step")
    p.add_argument("--model_cfg", default=None,
                   help="model_cfg.json to copy (default: flagship)")
    p.add_argument("--allow-missing", action="store_true")
    _device_flag(p)
    p.set_defaults(fn=cmd_fisher_recipe)

    p = sub.add_parser(
        "tdf-to-text",
        help="raw LDC .tdf transcripts -> per-set .ids/.clean.text + "
             "segments + channel_map (fsp_make_trans.pl + stage-2 + "
             "get_clean-text_ids.sh semantics, in-repo)")
    p.add_argument("tdf_dir")
    p.add_argument("out_dir")
    p.add_argument("--splits", default=None,
                   help="directory of <set> files listing call ids")
    p.add_argument("--sets", default=None,
                   help="comma list restricting which split files load")
    p.add_argument("--dev-fraction", dest="dev_fraction", type=float,
                   default=0.1)
    p.add_argument("--seed", default="fisher-text")
    p.add_argument("--translations", default=None)
    p.set_defaults(fn=cmd_tdf_to_text)

    p = sub.add_parser(
        "clean-text",
        help="'utt words' text -> aligned .ids + .clean.text "
             "(get_clean-text_ids.sh semantics)")
    p.add_argument("text")
    p.add_argument("--out", default=None,
                   help="output basename (default: text path minus "
                        "extension)")
    p.set_defaults(fn=cmd_clean_text)

    p = sub.add_parser("ark-to-conv")
    p.add_argument("ark")
    p.add_argument("out_dir")
    p.set_defaults(fn=cmd_ark_to_conv)

    p = sub.add_parser("merge-segments")
    p.add_argument("--map", required=True)
    p.add_argument("--conv_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--allow-missing", action="store_true",
                   help="write what exists even if some utterances "
                        "have missing segments")
    p.set_defaults(fn=cmd_merge_segments)

    p = sub.add_parser(
        "extract-segments",
        help="slice conversation audio into per-utterance .npy by a "
             "Kaldi segments table (audio-domain extract-segments)")
    p.add_argument("--segments", required=True,
                   help="Kaldi segments file: utt reco start end")
    p.add_argument("--audio_dir", required=True,
                   help="directory of <reco>.sph|.wav|.npy")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--channel-map", default=None,
                   help="file of 'reco channel' lines (0-based; "
                        "Fisher A/B sides are 0/1); unmapped recos "
                        "are channel-averaged")
    p.add_argument("--rate", type=int, default=8000)
    p.add_argument("--allow-missing", action="store_true",
                   help="skip recordings with no audio file instead "
                        "of failing")
    p.set_defaults(fn=cmd_extract_segments)

    p = sub.add_parser("mfcc")
    p.add_argument("audio_dir")
    p.add_argument("out_dir")
    _device_flag(p)
    p.set_defaults(fn=cmd_mfcc)

    p = sub.add_parser("bnf")
    p.add_argument("feat_dir")
    p.add_argument("out_dir")
    p.add_argument("--model", required=True,
                   help="text-format nnet2 raw net (final.raw via "
                        "nnet-copy --binary=false)")
    p.add_argument("--feat-type", choices=["raw", "delta", "lda"],
                   default="raw")
    p.add_argument("--lda-mat", default=None,
                   help="final.mat as plain text (for --feat-type lda)")
    p.add_argument("--splice", type=int, default=4)
    _device_flag(p)
    p.set_defaults(fn=cmd_bnf)

    p = sub.add_parser("pack-features")
    p.add_argument("src_dir",
                   help="per-utterance .npy dir (subdirs included)")
    p.add_argument("out", help="output .pack path, e.g. "
                               "<speech_path>/<set_key>.pack")
    p.add_argument("--f16", action="store_true",
                   help="store float16 (half the file; loader casts "
                        "back to float32)")
    p.set_defaults(fn=cmd_pack_features)

    p = sub.add_parser("cmvn")
    p.add_argument("--feat_dir", required=True)
    p.add_argument("--utt2spk", required=True)
    p.set_defaults(fn=cmd_cmvn)

    p = sub.add_parser("learn-bpe")
    p.add_argument("text")
    p.add_argument("out")
    p.add_argument("--merges", type=int, default=1000)
    p.set_defaults(fn=cmd_learn_bpe)

    p = sub.add_parser(
        "meteor-refs",
        help="interleave ref.en0..N-1 into the METEOR multi-ref layout")
    p.add_argument("refs_dir")
    p.add_argument("--n_evals", type=int, default=4)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_meteor_refs)

    p = sub.add_parser(
        "validate",
        help="corpus consistency check + optional --fix repair "
             "(validate_data_dir.sh / fix_data_dir.sh equivalent)")
    p.add_argument("exp_dir", help="experiment dir with train_cfg.json")
    p.add_argument("--sets", default=None,
                   help="comma list of split keys (default: every split "
                        "in the info pickle)")
    p.add_argument("--deep", action="store_true",
                   help="load EVERY feature file (default: existence "
                        "checks + a small random sample per split)")
    p.add_argument("--no-feats", action="store_true",
                   help="skip the speech-source checks")
    p.add_argument("--fix", action="store_true",
                   help="drop inconsistent utterances and repair stale "
                        "frame counts in place (map/info rewritten, "
                        ".bak backups)")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("build-dicts")
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("--merges", type=int, default=1000)
    p.add_argument("--sets", default="train,dev,test")
    p.set_defaults(fn=cmd_build_dicts)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
