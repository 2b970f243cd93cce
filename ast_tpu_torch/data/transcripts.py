"""Raw LDC transcript preparation: Fisher ``.tdf`` tables -> clean
per-set ``.ids`` / ``.clean.text`` files + Kaldi segments -- the port's
copy of ``ast_tpu/data/transcripts.py``.

This closes the last out-of-repo stage of the data pipeline: the
reference prepares its text with a Perl/sed/awk chain —
``fsp_make_trans.pl`` (.tdf parsing + punctuation/markup handling,
reference: linking_files/fisher/kaldi/local/fsp_make_trans.pl),
``fsp_data_prep.sh`` stage 2 (markup -> [laughter]/[noise] annotation
cleanup + segments/utt2spk derivation, reference:
linking_files/fisher/kaldi/local/fsp_data_prep.sh:113-152), and
``get_clean-text_ids.sh`` (label split + bracket-annotation and
punctuation strip, reference: linking_files/get_clean-text_ids.sh:10-21).
Each stage here reproduces the corresponding line-for-line text
transform; quirk deviations are documented inline.

LDC ``.tdf`` format (one speech segment per row, tab-separated, 3
header lines): ``file;unicode  channel  start  end  speaker  gender
native  transcript  section  turn  segment  ...``.
"""

import os
import re

__all__ = [
    "parse_tdf", "make_trans", "fsp_clean_text", "segments_from_text",
    "clean_text_ids", "prepare_fisher_text",
]


def _fmt_cs(seconds):
    """``sprintf("%06d", $t * 100)`` — centiseconds, truncated toward
    zero like Perl's %d (fsp_make_trans.pl:33-34)."""
    return "%06d" % int(float(seconds) * 100)


# the 32 ASCII punctuation characters of POSIX [[:punct:]] (the Perl
# strip runs under the C locale)
_PUNCT = re.compile(r"[!-/:-@\[-`{-~]")

# Perl's lc without `use utf8` lowercases BYTES, i.e. ASCII only — the
# explicit Á/Í/Ó/Ú folds exist in the reference precisely because lc
# does not touch them.  Python's str.lower() would also fold Ñ/É/...,
# diverging from the reference on such input, so the ASCII-only
# translation reproduces the byte-wise behavior.
_ASCII_LOWER = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")


def _clean_words(words):
    """The fsp_make_trans.pl word-normalization chain
    (fsp_make_trans.pl:45-68), in order:

    1. protect markup: ``</`` -> lendarrow, ``<`` -> larrow,
       ``>`` -> rarrow (so tags survive the punctuation strip)
    2. strip ASCII [[:punct:]]
    3. restore the protected delimiters
    4. accent/diacritic folding: upper-case accented vowels to lower,
       drop combining marks, ``N``->``n`` (pre-lowercase), lowercase
       (ASCII-only, matching Perl's byte-wise lc — Ñ/É etc. pass
       through untouched exactly as in the reference),
       ``ü(e|i|é|í)`` -> ``w$1``, ``ü`` -> ``u``, ``ñ`` -> ``N`` (the
       Kaldi convention: capital N denotes eñe after lowercasing)
    """
    w = words
    w = w.replace("</", "lendarrow")
    w = w.replace("<", "larrow").replace(">", "rarrow")
    w = _PUNCT.sub("", w)
    w = w.replace("larrow", "<").replace("rarrow", ">")
    w = w.replace("lendarrow", "</")
    for a, b in (("Á", "á"), ("Í", "í"),
                 ("Ó", "ó"), ("Ú", "ú"),
                 ("¨", ""), ("·", ""), ("´", ""),
                 ("N", "n")):
        w = w.replace(a, b)
    w = w.translate(_ASCII_LOWER)
    w = re.sub("ü([eiéí])", r"w\1", w)
    w = w.replace("ü", "u")
    w = w.replace("ñ", "N")
    return w


def parse_tdf(path, call_id=None):
    """Parse one LDC ``.tdf`` transcript table.

    Returns a list of segment dicts ``{"utt", "reco", "side",
    "start_cs", "end_cs", "speaker", "gender", "words"}`` in file
    order, with the reference's id scheme: ``utt =
    {call_id}-{side}-{start:06d}-{end:06d}`` (centiseconds), ``side =
    A/B`` by channel falsiness, ``speaker = {call_id}-{side}``
    (fsp_make_trans.pl:29-43).

    Documented deviation: the reference's gender map uses Perl numeric
    ``==`` on the gender string (always true -> every speaker "f",
    fsp_make_trans.pl:40-42); here the string comparison is performed
    as evidently intended.  Nothing downstream consumes gender.
    """
    if call_id is None:
        call_id = os.path.basename(path)
        if call_id.endswith(".tdf"):
            call_id = call_id[:-4]
    segs = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    for line in lines[3:]:  # 3 header rows (fsp_make_trans.pl:21-23)
        if not line:
            continue
        parts = line.split("\t")
        if len(parts) < 11:
            continue
        start = _fmt_cs(parts[2])
        end = _fmt_cs(parts[3])
        if len(end) > 6:
            raise ValueError(f"time too long {end} in {path}")
        # Perl truthiness: "0" and "" are false -> side A
        side = "B" if parts[1].strip() not in ("", "0") else "A"
        utt = f"{call_id}-{side}-{start}-{end}"
        segs.append({
            "utt": utt, "reco": f"{call_id}-{side}", "side": side,
            "start_cs": int(start), "end_cs": int(end),
            "speaker": f"{call_id}-{side}",
            "gender": "f" if parts[5].strip() == "female" else "m",
            "words": _clean_words(parts[7]),
        })
    return segs


def make_trans(tdf_paths):
    """All ``.tdf`` files -> (text lines, reco2file_and_channel,
    spk2gender) — the fsp_make_trans.pl outputs.  ``text`` lines are
    ``"{utt} {words}"`` in file order (pre-sort, i.e. ``text.1``)."""
    text, r2fc, s2g = [], [], {}
    for path in tdf_paths:
        call_id = os.path.basename(path)
        if call_id.endswith(".tdf"):
            call_id = call_id[:-4]
        r2fc.append(f"{call_id}-A {call_id} A")
        r2fc.append(f"{call_id}-B {call_id} B")
        for seg in parse_tdf(path, call_id):
            text.append(f"{seg['utt']} {seg['words']}")
            s2g.setdefault(seg["speaker"], seg["gender"])
    return text, sorted(r2fc), s2g


# fsp_data_prep.sh stage-2 sed chain (fsp_data_prep.sh:113-143), one
# (pattern, replacement) per sed expression, applied in order
_STAGE2 = [
    (re.compile(r"<\s*/*\s*for[ei][ei]g[nh]\s*\w*>"), ""),
    (re.compile(r"<lname>([^<]*)</lname>"), r"\1"),
    (re.compile(r"<lname/*>"), ""),
    (re.compile(r"<laugh>[^<]*</laugh>"), "[laughter]"),
    (re.compile(r"<\s*cough/*>"), "[noise]"),
    (re.compile(r"<sneeze/*>"), "[noise]"),
    (re.compile(r"<breath/*>"), "[noise]"),
    (re.compile(r"<lipsmack/*>"), "[noise]"),
    (re.compile(r"<background>[^<]*</background>"), "[noise]"),
    (re.compile(r"<[/]?background[/]?>"), "[noise]"),
    # "one more time to take care of nested stuff"
    (re.compile(r"<laugh>[^<]*</laugh>"), "[laughter]"),
    (re.compile(r"<[/]?laugh[/]?>"), "[laughter]"),
    # the reference's hand-collected exceptions
    (re.compile(r"<foreign langenglish"), ""),
    (re.compile(r"</foreign"), ""),
    (re.compile(r"<[/]?foreing\s*\w*>"), ""),
    (re.compile(r"</b"), ""),
    (re.compile(r"<foreign langengullís>"), ""),
    (re.compile(r"foreign>"), ""),
    (re.compile(r">"), ""),
    (re.compile("¿"), ""),
]


def fsp_clean_text(text_lines):
    """fsp_data_prep.sh stage 2: ``sort text.1`` -> markup cleanup ->
    ``text`` (fsp_data_prep.sh:113-143).  Drops lines containing
    ``((`` (unintelligible markers) or ``()``, and lines with no words
    after the utterance id; byte sort matches the script's LC_ALL=C."""
    out = []
    for line in sorted(text_lines):
        if "((" in line or len(line.split()) <= 1:
            continue
        for pat, repl in _STAGE2:
            line = pat.sub(repl, line)
        if "()" in line:
            continue
        out.append(line)
    return out


def segments_from_text(text_lines):
    """Kaldi ``segments`` + ``utt2spk`` rows from cleaned text lines
    (fsp_data_prep.sh:146-151): ``utt {call}-{side} start end`` with
    centisecond fields scaled to %.2f seconds; zero-length segments
    are dropped from segments (not from utt2spk)."""
    seg_rows, utt2spk = [], []
    pat = re.compile(r"^((\S+-[AB])-(\d+)-(\d+))\s")
    for line in text_lines:
        m = pat.match(line)
        if not m:
            raise ValueError(f"bad utterance id in line: {line[:60]!r}")
        utt, reco, s_cs, e_cs = m.group(1), m.group(2), m.group(3), \
            m.group(4)
        utt2spk.append(f"{utt} {reco}")
        s, e = 0.01 * int(s_cs), 0.01 * int(e_cs)
        if s != e:
            seg_rows.append(f"{utt} {reco} {s:.2f} {e:.2f}")
    return seg_rows, utt2spk


# get_clean-text_ids.sh:20 — bracket annotations, then the literal
# character class [-_.><=.,!?:~;$@%&]
_BRACKETS = re.compile(r"\[[^][]*\]")
_GP_PUNCT = re.compile(r"[-_.><=,!?:~;$@%&]")


def clean_text_ids(text_lines):
    """get_clean-text_ids.sh semantics on ``"{utt} {words}"`` lines:
    returns (ids, clean_texts) where ids[i] is the first field and
    clean_texts[i] is the rest with ``[...]`` annotations and the
    script's punctuation set removed (get_clean-text_ids.sh:10-21).
    Whitespace is left un-squeezed, as the sed chain leaves it; the
    downstream tokenizers split on any whitespace run."""
    ids, texts = [], []
    for line in text_lines:
        parts = line.split(" ", 1)
        ids.append(parts[0])
        t = parts[1] if len(parts) > 1 else ""
        t = t.lstrip(" ")
        t = _BRACKETS.sub("", t)
        t = _GP_PUNCT.sub("", t)
        texts.append(t)
    return ids, texts


def _hash_split(call_ids, dev_fraction, seed):
    """Deterministic conversation-level split (sha256 of call id)."""
    import hashlib
    ordered = sorted(call_ids)
    if len(ordered) < 2:
        # a 1-conversation corpus cannot be split at conversation
        # level; proceeding would silently write an empty train or dev
        # side and fail obscurely stages later
        raise ValueError(
            "conversation-level hash split needs >= 2 conversations "
            f"(got {len(ordered)}); pass an explicit splits= mapping")
    dev = set()
    for cid in call_ids:
        h = hashlib.sha256(f"{seed}:{cid}".encode()).digest()
        if int.from_bytes(h[:8], "big") / 2**64 < dev_fraction:
            dev.add(cid)
    # never leave either side empty
    if not dev:
        dev.add(ordered[-1])
    if len(dev) == len(ordered):
        dev.discard(ordered[0])
    return dev


def prepare_fisher_text(tdf_dir, out_dir, splits=None, sets=None,
                        dev_fraction=0.1, seed="fisher-text",
                        translations=None, log=print):
    """Raw ``.tdf`` transcripts -> per-set text + segment tables.

    Writes into ``out_dir``:
      ``<set>.ids`` / ``<set>.clean.text``  (get_clean-text_ids.sh
          outputs; line-aligned)
      ``segments``      Kaldi table, reco = ``{call}-{side}``
      ``channel_map``   ``{call}-{side} 0|1`` (A/B -> sph channel —
          reference wav.scp maps side A to channel 1-of-2,
          fsp_data_prep.sh:165)
      ``utt2spk``       speaker = conversation side
      ``text``          the intermediate cleaned text (stage-2 output)

    ``splits``: {set_name: iterable of call_ids} or a directory of
    files named ``<set>`` listing call ids (the reference's
    local/splits layout); conversations not listed are dropped.
    Default: deterministic conversation-level hash split into
    train/dev by ``dev_fraction``.  ``translations``: optional
    {utt: target_text} (or a path to ``utt<TAB>text`` lines) replacing
    the transcript as the .clean.text side — for AST targets prepared
    from a translation release; default uses the (cleaned) source
    transcript, the ASR configuration.
    """
    tdfs = sorted(
        os.path.join(tdf_dir, f) for f in os.listdir(tdf_dir)
        if f.endswith(".tdf"))
    if not tdfs:
        raise FileNotFoundError(f"no .tdf files under {tdf_dir}")
    text1, r2fc, _ = make_trans(tdfs)
    text = fsp_clean_text(text1)
    seg_rows, utt2spk = segments_from_text(text)
    have_audio = {r.split()[0] for r in seg_rows}
    # zero-length segments have no audio to train on
    text = [ln for ln in text if ln.split(" ", 1)[0] in have_audio]

    if isinstance(translations, str):
        tr = {}
        with open(translations, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t", 1)
                if len(parts) == 2:
                    tr[parts[0]] = parts[1]
        translations = tr
    if translations:
        text = [f"{ln.split(' ', 1)[0]} "
                f"{translations.get(ln.split(' ', 1)[0], '')}"
                for ln in text]
        text = [ln for ln in text if len(ln.split()) > 1]

    # strip the -{side}-{start}-{end} suffix (call ids may themselves
    # contain hyphens)
    call_of = lambda utt: re.sub(r"-[AB]-\d+-\d+$", "", utt)  # noqa: E731
    if splits is None:
        calls = {call_of(ln.split()[0]) for ln in text}
        dev_calls = _hash_split(calls, dev_fraction, seed)
        split_map = {"train": calls - dev_calls, "dev": dev_calls}
    elif isinstance(splits, str):
        split_map = {}
        names = sets or sorted(os.listdir(splits))
        for name in names:
            path = os.path.join(splits, name)
            with open(path) as f:
                split_map[name] = {ln.strip() for ln in f if ln.strip()}
    else:
        split_map = {k: set(v) for k, v in splits.items()}
    if sets:
        split_map = {k: split_map[k] for k in sets}

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "text"), "w", encoding="utf-8") as f:
        f.write("\n".join(text) + "\n")
    with open(os.path.join(out_dir, "segments"), "w") as f:
        f.write("\n".join(seg_rows) + "\n")
    with open(os.path.join(out_dir, "utt2spk"), "w") as f:
        f.write("\n".join(utt2spk) + "\n")
    with open(os.path.join(out_dir, "channel_map"), "w") as f:
        for row in r2fc:
            reco, _, side = row.split()
            f.write(f"{reco} {0 if side == 'A' else 1}\n")

    counts = {}
    for name, calls in split_map.items():
        lines = [ln for ln in text if call_of(ln.split()[0]) in calls]
        ids, cleans = clean_text_ids(lines)
        with open(os.path.join(out_dir, f"{name}.ids"), "w") as f:
            f.write("\n".join(ids) + ("\n" if ids else ""))
        with open(os.path.join(out_dir, f"{name}.clean.text"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(cleans) + ("\n" if cleans else ""))
        counts[name] = len(ids)
    log(f"[tdf] {len(tdfs)} transcripts -> "
        + ", ".join(f"{k}: {v} utts" for k, v in sorted(counts.items())))
    return {
        "text_dir": out_dir,
        "segments": os.path.join(out_dir, "segments"),
        "channel_map": os.path.join(out_dir, "channel_map"),
        "utt2spk": os.path.join(out_dir, "utt2spk"),
        "counts": counts,
    }
