"""Corpus validation and repair — ``validate_data_dir.sh`` / ``fix_data_dir.sh``
equivalents for the pickle-based corpus layout: the port's copy of
``ast_tpu/data/validate.py``, whose speech source resolves packs, ``.npy``
files and audio through the port's own readers.

The reference pipeline quality-checks its Kaldi data dirs with
``utils/validate_data_dir.sh`` and repairs them with ``utils/fix_data_dir.sh``
(reference: linking_files/fisher/kaldi/train_all.sh:35-36) before features
are ever extracted.  This corpus contract is different — three pickles
(map / vocab / info), a speech source (per-utt ``.npy`` tree, ``.pack``
file, GlobalPhone ``data.dict``, or raw audio + ``cmvn.stats``) and a
``refs/`` eval protocol — so this module checks *that* contract:

errors (the loader will crash, or silently train on wrong data):
- utterances present in only one of map/info
- map entries missing the decoder-side token list (``dec_key``)
- token key type mismatch between map tokens and the vocab table
  (bytes vs str makes every lookup silently UNK)
- vocab table malformed: specials not at ids 0-3, w2i/i2w not inverses
- missing / unloadable speech for an utterance
- actual feature frames EXCEED info's frame count (the batch assembler
  sizes the bucket from info and would crash mid-epoch)
- refs protocol broken for the dev set: missing ``eval.ids``, ids not in
  the split, ``ref.enK`` missing or line-count mismatch

warnings (suspicious but survivable):
- actual frames below info's count (wrong bucket, wasted padding)
- empty target token lists, targets truncated by ``max_pred``
- frames beyond ``max_sp`` (silently truncated, reference semantics)
- high decoder-side OOV rate (UNK flood)
- wav mode: utterances missing from ``utt2spk``/CMVN stats (the loader
  falls back to identity normalization for them)

``fix_corpus`` (the ``fix_data_dir.sh`` analog) drops inconsistent
utterances from map+info in place (``.bak`` backups) and, in deep mode,
repairs stale info frame counts from the actual feature files.
"""

import os
import pickle
import random

import numpy as np

from ast_tpu_torch.symbols import SYMBOLS

# examples listed per problem before truncating to a count
_MAX_EXAMPLES = 5


class Problem:
    """One validation finding."""

    def __init__(self, severity, set_key, code, message, utts=()):
        self.severity = severity  # "error" | "warning"
        self.set_key = set_key    # split name or "" for corpus-global
        self.code = code
        self.message = message
        self.utts = sorted(utts)

    def __repr__(self):
        where = f"[{self.set_key}] " if self.set_key else ""
        line = f"{self.severity.upper()}: {where}{self.message}"
        if self.utts:
            shown = ", ".join(map(str, self.utts[:_MAX_EXAMPLES]))
            more = len(self.utts) - _MAX_EXAMPLES
            line += f" (e.g. {shown}" + (f" … +{more} more)" if more > 0
                                         else ")")
        return line


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _vocab_tables_needed(data_cfg):
    """Which vocab sub-tables the configured run reads."""
    tables = []
    if data_cfg.get("limit_vocab", False):
        tables.append(None)  # top-level w2i/i2w (reference: nmt_run.py:781)
    else:
        tables.append(data_cfg["dec_key"])
    enc_key = data_cfg.get("enc_key", "sp")
    if enc_key != "sp" and enc_key not in tables:
        tables.append(enc_key)  # text-encoder mode embeds source tokens
    return tables


def _check_vocab(vocab, data_cfg, problems):
    """Validate every vocab table the run will consult.  Returns the
    decoder-side w2i (or None if broken) for OOV accounting."""
    dec_w2i = None
    for key in _vocab_tables_needed(data_cfg):
        name = key if key is not None else "<top-level>"
        table = vocab if key is None else vocab.get(key)
        if not isinstance(table, dict) or "w2i" not in table \
                or "i2w" not in table:
            problems.append(Problem(
                "error", "", "vocab_table_missing",
                f"vocab table {name!r} missing or lacks w2i/i2w"))
            continue
        w2i, i2w = table["w2i"], table["i2w"]
        bad_special = [
            s for s, i in zip(SYMBOLS.START_VOCAB, range(SYMBOLS.N_SPECIAL))
            if w2i.get(s) != i
        ]
        if bad_special:
            problems.append(Problem(
                "error", "", "vocab_specials",
                f"vocab table {name!r}: specials not at ids 0-3 "
                f"(PAD/GO/EOS/UNK contract, reference dataloader.py:26-36); "
                f"wrong: {bad_special}"))
        if len(w2i) != len(i2w) or any(
                i2w.get(i) != w for w, i in w2i.items()):
            problems.append(Problem(
                "error", "", "vocab_not_bijective",
                f"vocab table {name!r}: w2i and i2w are not inverses "
                f"({len(w2i)} vs {len(i2w)} entries)"))
        if key == data_cfg["dec_key"] or (
                key is None and data_cfg.get("limit_vocab", False)):
            dec_w2i = w2i
    return dec_w2i


class _SpeechSource:
    """Uniform existence/load interface over the configured speech mode.

    This deliberately re-implements the loaders' speech resolution
    (pack/npy/subdir/wav/sph fallbacks) rather than importing it: the
    validator doubles as an independent cross-check of the load path.
    tests/test_torch_prep.py holds its findings and repairs to
    ``ast_tpu``'s, and feeds a corpus served from packs alone through the
    REAL dataloader.  When adding a new speech source, update both and
    extend those tests."""

    def __init__(self, data_cfg):
        self.data_cfg = data_cfg
        self.mode = ("wav" if data_cfg.get("features") == "wav"
                     else "globalphone"
                     if data_cfg.get("dataloader") == "globalphone"
                     else "fisher")
        self._packs = {}
        self._gp = None
        if self.mode == "globalphone":
            self._gp = _load_pickle(data_cfg["speech_path"])

    def _pack(self, set_key):
        if set_key not in self._packs:
            path = os.path.join(self.data_cfg["speech_path"],
                                f"{set_key}.pack")
            pack = None
            if os.path.exists(path):
                from ast_tpu_torch.data.feature_pack import FeaturePack
                pack = FeaturePack(path)
            self._packs[set_key] = pack
        return self._packs[set_key]

    def resolve(self, utt, set_key):
        """Return a loader closure for the utterance's features/audio, or
        None when no source exists.  The closure returns the raw array."""
        if self.mode == "globalphone":
            split = self._gp.get(set_key, {})
            if utt in split:
                return lambda: np.asarray(split[utt])
            return None
        base = os.path.join(self.data_cfg["speech_path"], set_key)
        if self.mode == "wav":
            for ext, reader in ((".npy", np.load), (".wav", None),
                                (".sph", None)):
                path = os.path.join(base, utt + ext)
                if os.path.exists(path):
                    if reader is not None:
                        return lambda p=path: np.load(p)

                    def _read(p=path, e=ext):
                        from ast_tpu_torch.data import wav_loader
                        fn = (wav_loader.read_wav if e == ".wav"
                              else wav_loader.read_sph)
                        return fn(p)
                    return _read
            return None
        pack = self._pack(set_key)
        if pack is not None and utt in pack:
            return lambda: pack.get(utt)
        for path in (os.path.join(base, f"{utt}.npy"),
                     os.path.join(base, utt.split("_", 1)[0],
                                  f"{utt}.npy")):
            if os.path.exists(path):
                return lambda p=path: np.load(p)
        return None


def validate_corpus(train_cfg, sets=None, check_features=True, deep=False,
                    max_load=8, seed=0):
    """Validate the corpus a train_cfg points at.

    Returns (problems, summary).  ``deep=True`` loads every feature file
    (frame counts verified exactly); the default loads ``max_load`` random
    files per split and only checks existence for the rest.
    """
    problems = []
    data_cfg = train_cfg["data"]
    dec_key = data_cfg["dec_key"]
    enc_key = data_cfg.get("enc_key", "sp")
    text_mode = enc_key != "sp"
    bucket_key = enc_key if text_mode else "sp"
    max_pred = data_cfg.get("max_pred", 175)
    max_sp = (data_cfg["buckets_num"] + 1) * data_cfg["buckets_width"]

    try:
        map_dict = _load_pickle(data_cfg["map_path"])
        vocab = _load_pickle(data_cfg["vocab_path"])
        info = _load_pickle(data_cfg["info_path"])
    except Exception as e:  # noqa: BLE001 — report, don't crash
        problems.append(Problem("error", "", "pickle_unreadable",
                                f"cannot load corpus pickles: {e!r}"))
        return problems, {"sets": {}, "n_errors": 1, "n_warnings": 0}

    dec_w2i = _check_vocab(vocab, data_cfg, problems)

    if sets is None:
        sets = sorted(set(info) | set(map_dict))
    summary = {"sets": {}}

    speech = None
    if check_features and not text_mode:
        try:
            speech = _SpeechSource(data_cfg)
        except Exception as e:  # noqa: BLE001
            problems.append(Problem(
                "error", "", "speech_source_unreadable",
                f"cannot open speech source: {e!r}"))

    rng = random.Random(seed)
    for set_key in sets:
        m = map_dict.get(set_key, {})
        i = info.get(set_key, {})
        stats = {"n_map": len(m), "n_info": len(i)}

        only_map = set(m) - set(i)
        only_info = set(i) - set(m)
        if only_map:
            problems.append(Problem(
                "error", set_key, "map_only",
                f"{len(only_map)} utterances in map but not info "
                "(bucketing reads info; these never train)", only_map))
        if only_info:
            problems.append(Problem(
                "error", set_key, "info_only",
                f"{len(only_info)} utterances in info but not map "
                "(label assembly reads map; the loader crashes on these)",
                only_info))

        shared = sorted(set(m) & set(i))
        missing_dec, empty_dec, truncated = [], [], []
        bad_frames, over_max_sp = [], []
        oov, total_tok = 0, 0
        tok_type = type(next(iter(dec_w2i))) if dec_w2i else bytes
        type_mismatch = []
        for u in shared:
            toks = m[u].get(dec_key)
            if toks is None:
                missing_dec.append(u)
            else:
                if len(toks) == 0:
                    empty_dec.append(u)
                if len(toks) > max_pred - 2:
                    truncated.append(u)
                if dec_w2i is not None:
                    for t in toks:
                        if not isinstance(t, tok_type):
                            if len(type_mismatch) < 64:
                                type_mismatch.append(u)
                            break
                    else:
                        total_tok += len(toks)
                        oov += sum(1 for t in toks if t not in dec_w2i)
            frames = i[u].get(bucket_key)
            if not isinstance(frames, (int, np.integer)) or frames <= 0:
                bad_frames.append(u)
            elif not text_mode and frames > max_sp:
                over_max_sp.append(u)

        if missing_dec:
            problems.append(Problem(
                "error", set_key, "missing_dec_tokens",
                f"{len(missing_dec)} map entries lack the {dec_key!r} "
                "token list", missing_dec))
        if type_mismatch:
            problems.append(Problem(
                "error", set_key, "token_type_mismatch",
                f"map {dec_key!r} tokens are not {tok_type.__name__} like "
                "the vocab keys — every lookup would silently become UNK",
                type_mismatch))
        if bad_frames:
            problems.append(Problem(
                "error", set_key, "bad_frame_count",
                f"{len(bad_frames)} info entries lack a positive "
                f"{bucket_key!r} count (bucketing needs it)", bad_frames))
        if empty_dec:
            problems.append(Problem(
                "warning", set_key, "empty_target",
                f"{len(empty_dec)} utterances have empty {dec_key!r} "
                "targets (train as GO+EOS only)", empty_dec))
        if truncated:
            problems.append(Problem(
                "warning", set_key, "target_truncated",
                f"{len(truncated)} targets exceed max_pred-2={max_pred - 2} "
                "tokens and will be truncated", truncated))
        if over_max_sp:
            problems.append(Problem(
                "warning", set_key, "frames_truncated",
                f"{len(over_max_sp)} utterances exceed max_sp={max_sp} "
                "frames and will be truncated (reference semantics)",
                over_max_sp))
        if total_tok:
            stats["oov_rate"] = oov / total_tok
            if stats["oov_rate"] > 0.05:
                problems.append(Problem(
                    "warning", set_key, "high_oov",
                    f"decoder-side OOV rate {stats['oov_rate']:.1%} "
                    "(> 5%): vocab and corpus may be mismatched"))

        # ---- speech source ------------------------------------------
        if speech is not None:
            missing_speech, unreadable = [], []
            frames_over, frames_under = [], []
            have = []
            for u in shared:
                loader = speech.resolve(u, set_key)
                if loader is None:
                    missing_speech.append(u)
                else:
                    have.append((u, loader))
            to_load = (have if deep else
                       rng.sample(have, min(max_load, len(have))))
            dims = {}
            for u, loader in to_load:
                try:
                    arr = np.asarray(loader())
                except Exception as e:  # noqa: BLE001
                    unreadable.append(f"{u} ({e!r})")
                    continue
                if speech.mode == "wav":
                    continue  # raw audio: frame counts derive from MFCC cfg
                if arr.ndim != 2:
                    unreadable.append(f"{u} (ndim={arr.ndim})")
                    continue
                dims.setdefault(int(arr.shape[1]), []).append(u)
                declared = i[u].get(bucket_key)
                if isinstance(declared, (int, np.integer)):
                    actual = min(int(arr.shape[0]), max_sp)
                    declared_eff = min(int(declared), max_sp)
                    if actual > declared_eff:
                        frames_over.append(u)
                    elif actual < declared_eff:
                        frames_under.append(u)
            if missing_speech:
                problems.append(Problem(
                    "error", set_key, "missing_speech",
                    f"{len(missing_speech)} utterances have no speech "
                    "source", missing_speech))
            if unreadable:
                problems.append(Problem(
                    "error", set_key, "unreadable_speech",
                    f"{len(unreadable)} feature files unreadable or "
                    "malformed", unreadable))
            if len(dims) > 1:
                problems.append(Problem(
                    "error", set_key, "inconsistent_feat_dim",
                    "feature dimension differs across utterances: "
                    + ", ".join(f"D={d} x{len(us)}"
                                for d, us in sorted(dims.items()))))
            if frames_over:
                problems.append(Problem(
                    "error", set_key, "frames_exceed_info",
                    f"{len(frames_over)} feature files hold MORE frames "
                    "than info declares — the bucket is sized from info "
                    "and batch assembly would crash mid-epoch",
                    frames_over))
            if frames_under:
                problems.append(Problem(
                    "warning", set_key, "frames_below_info",
                    f"{len(frames_under)} feature files hold fewer frames "
                    "than info declares (stale info: wrong bucket, wasted "
                    "padding)", frames_under))
            checked = "all" if deep else f"{len(to_load)}/{len(have)}"
            stats["features_loaded"] = checked

            if speech.mode == "wav":
                stats_path = os.path.join(data_cfg["speech_path"],
                                          "cmvn.stats")
                no_spk = []
                if os.path.exists(stats_path):
                    blob = _load_pickle(stats_path)
                    no_spk = [u for u in shared
                              if u not in blob.get("utt2spk", {})]
                else:
                    no_spk = list(shared)
                if no_spk:
                    problems.append(Problem(
                        "warning", set_key, "no_cmvn",
                        f"{len(no_spk)} utterances missing from "
                        "utt2spk/CMVN stats (loader falls back to "
                        "identity normalization)", no_spk))

        summary["sets"][set_key] = stats

    # ---- refs protocol (dev/eval splits) -----------------------------
    refs_path = data_cfg.get("refs_path")
    n_evals = data_cfg.get("n_evals", 1)
    dev_set = train_cfg.get("dev_set")
    for set_key in sets:
        ref_dir = os.path.join(refs_path, set_key) if refs_path else None
        if ref_dir is None or not os.path.isdir(ref_dir):
            if set_key == dev_set:
                problems.append(Problem(
                    "error", set_key, "refs_missing",
                    f"dev set has no refs dir ({ref_dir}): per-epoch BLEU "
                    "cannot run"))
            continue
        ids_path = os.path.join(ref_dir, "eval.ids")
        if not os.path.exists(ids_path):
            problems.append(Problem(
                "error", set_key, "eval_ids_missing",
                f"refs dir lacks eval.ids: {ref_dir}"))
            continue
        with open(ids_path) as f:
            ids = [line.strip() for line in f if line.strip()]
        known = set(info.get(set_key, {}))
        unknown = [u for u in ids if u not in known]
        if unknown:
            problems.append(Problem(
                "error", set_key, "eval_ids_unknown",
                f"{len(unknown)} eval.ids entries are not in the split "
                "(decode never produces them; hyp files would misalign)",
                unknown))
        if len(set(ids)) != len(ids):
            problems.append(Problem(
                "warning", set_key, "eval_ids_duplicates",
                "duplicate entries in eval.ids"))
        for k in range(n_evals):
            ref_k = os.path.join(ref_dir, f"ref.en{k}")
            if not os.path.exists(ref_k):
                problems.append(Problem(
                    "error", set_key, "ref_file_missing",
                    f"missing reference file ref.en{k} "
                    f"(n_evals={n_evals})"))
                continue
            with open(ref_k) as f:
                n_lines = sum(1 for _ in f)
            if n_lines != len(ids):
                problems.append(Problem(
                    "error", set_key, "ref_line_mismatch",
                    f"ref.en{k} has {n_lines} lines but eval.ids has "
                    f"{len(ids)}"))

    summary["n_errors"] = sum(p.severity == "error" for p in problems)
    summary["n_warnings"] = sum(p.severity == "warning" for p in problems)
    return problems, summary


def fix_corpus(train_cfg, sets=None, deep=True, backup=True,
               check_features=True):
    """Repair the corpus in place (``fix_data_dir.sh`` analog).

    Drops utterances that are inconsistent (present in only one pickle,
    missing decoder tokens, missing/unreadable speech, features longer
    than info declares) from BOTH map and info, and — in deep mode —
    repairs stale info frame counts from the actual feature files.
    Originals are saved as ``<path>.bak`` first.  Returns a summary dict.

    ``check_features=False`` (the CLI's ``--no-feats``) repairs only the
    metadata-level problems — essential when the feature tree is not
    mounted, where speech checks would otherwise report EVERY utterance
    missing and the fix would wipe the corpus.
    """
    problems, _ = validate_corpus(train_cfg, sets=sets, deep=deep,
                                  check_features=check_features)
    data_cfg = train_cfg["data"]
    bucket_key = (data_cfg.get("enc_key", "sp")
                  if data_cfg.get("enc_key", "sp") != "sp" else "sp")

    drop_codes = {"map_only", "info_only", "missing_dec_tokens",
                  "missing_speech", "unreadable_speech",
                  "bad_frame_count", "frames_exceed_info",
                  "frames_below_info"}
    # frames_* problems are repaired (info restated), not dropped, when
    # deep mode can read the true count
    repair_codes = {"frames_exceed_info", "frames_below_info"} if deep \
        else set()

    drops = {}
    repairs = {}
    for p in problems:
        if p.severity != "error" and p.code not in repair_codes:
            continue
        if p.code in repair_codes:
            repairs.setdefault(p.set_key, set()).update(
                u.split(" ")[0] for u in p.utts)
        elif p.code in drop_codes:
            drops.setdefault(p.set_key, set()).update(
                u.split(" ")[0] for u in p.utts)

    map_dict = _load_pickle(data_cfg["map_path"])
    info = _load_pickle(data_cfg["info_path"])
    # an unreadable speech source is itself one of the problems
    # validate reports (speech_source_unreadable) — the metadata
    # repairs must still apply, so degrade to no-speech mode instead
    # of crashing before any fix lands
    try:
        speech = _SpeechSource(data_cfg) if check_features else None
    except Exception:  # noqa: BLE001
        speech = None
    max_sp = (data_cfg["buckets_num"] + 1) * data_cfg["buckets_width"]

    n_dropped, n_repaired = 0, 0
    # repairs only exist when speech checks ran (check_features=True)
    for set_key, utts in repairs.items():
        for u in sorted(utts - drops.get(set_key, set())):
            loader = speech.resolve(u, set_key) if speech else None
            if loader is None:
                drops.setdefault(set_key, set()).add(u)
                continue
            try:
                arr = np.asarray(loader())
            except Exception:  # noqa: BLE001
                drops.setdefault(set_key, set()).add(u)
                continue
            true_frames = int(min(arr.shape[0], max_sp))
            if info[set_key][u].get(bucket_key) != true_frames:
                info[set_key][u][bucket_key] = true_frames
                n_repaired += 1

    for set_key, utts in drops.items():
        for u in utts:
            map_dict.get(set_key, {}).pop(u, None)
            info.get(set_key, {}).pop(u, None)
            n_dropped += 1

    # keep the refs protocol aligned: filter eval.ids and every ref.enK
    # by the same drops (Kaldi's fix_data_dir filters all files by the
    # surviving utterance set)
    refs_path = data_cfg.get("refs_path")
    n_refs_filtered = 0
    if refs_path:
        for set_key, utts in drops.items():
            ids_path = os.path.join(refs_path, set_key, "eval.ids")
            if not os.path.exists(ids_path):
                continue
            # indices are RAW line numbers (blank lines included) so the
            # kept eval.ids line j and ref.enK line j stay paired
            with open(ids_path) as f:
                raw = [line.rstrip("\n") for line in f]
            keep = [j for j, u in enumerate(raw) if u.strip() not in utts]
            if len(keep) == len(raw):
                continue
            n_refs_filtered += len(raw) - len(keep)
            ref_files = [ids_path]
            k = 0
            while True:
                ref_k = os.path.join(refs_path, set_key, f"ref.en{k}")
                if not os.path.exists(ref_k):
                    break
                ref_files.append(ref_k)
                k += 1
            for path in ref_files:
                with open(path) as f:
                    lines = [line.rstrip("\n") for line in f]
                if backup:
                    import shutil
                    shutil.copy2(path, path + ".bak")
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    for j in keep:
                        if j < len(lines):
                            f.write(lines[j] + "\n")
                os.replace(tmp, path)

    if n_dropped or n_repaired:
        for path, obj in ((data_cfg["map_path"], map_dict),
                          (data_cfg["info_path"], info)):
            if backup and os.path.exists(path):
                import shutil
                shutil.copy2(path, path + ".bak")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(obj, f)
            os.replace(tmp, path)

    return {"dropped": n_dropped, "repaired": n_repaired,
            "refs_filtered": n_refs_filtered,
            "drops": {k: sorted(v) for k, v in drops.items()}}
