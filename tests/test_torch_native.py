"""The port's native readers (ast_tpu_torch.native) and its shorten codec
against ast_tpu's.

The C++ shorten decoder equals the port's Python decoder and ast_tpu's
Python decoder (``_force_python=True``: ast_tpu.native is never loaded
here, so its build race cannot skip these) sample for sample and
verbatim byte for byte, on the committed ``tests/fixtures/shorten``
streams and on round trips over the predictor and option grid of
tests/test_shorten.py; the port's encoder writes ast_tpu's bytes.  The
C++ ark parser equals ``_read_text_ark_py`` bit for bit.  And the build:
four processes that load the library at once from an empty build
directory all decode, with ``g++`` run once; a failed build raises with
the compiler's stderr; a machine without ``g++`` takes the Python path
and says so.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from ast_tpu.data import kaldi_ark as jax_ark
from ast_tpu.data import shorten as jax_sh
from ast_tpu_torch import native
from ast_tpu_torch.data import kaldi_ark
from ast_tpu_torch.data import shorten as sh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "shorten")

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ on PATH")


def _sig(n=4000, seed=0, scale=2000.0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = scale * np.sin(t / 25.0) + rng.randint(-100, 100, n)
    return np.stack([x, np.roll(x, 3)], axis=1).astype(np.int64)


def _decoders_agree(data, want=None, max_samples=None):
    """The port's C++ and Python decoders and ast_tpu's Python decoder
    give one stream; returns it."""
    cc = sh.decode(data, max_samples)
    py = sh.decode(data, max_samples, _force_python=True)
    ref = jax_sh.decode(data, max_samples, _force_python=True)
    for st in (cc, py):
        assert (st.ftype, st.nchan) == (ref.ftype, ref.nchan)
        np.testing.assert_array_equal(st.samples, ref.samples)
        assert st.verbatim == ref.verbatim
    assert cc.samples.dtype == ref.samples.dtype
    if want is not None:
        np.testing.assert_array_equal(cc.samples, want)
    return cc


def _stream(path):
    """A fixture's shorten stream: the file, or a SPHERE's body."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(b"NIST_1A"):
        return raw[int(raw.split(b"\n")[1]):]
    return raw


@needs_gxx
@pytest.mark.parametrize("name", ["raw_s16.shn", "fisher_like.sph",
                                  "pcm_like.sph"])
def test_native_decoder_on_fixtures(name):
    st = _decoders_agree(_stream(os.path.join(FIX, name)))
    assert len(st.samples) > 0


@needs_gxx
@pytest.mark.parametrize("kw", [
    {}, {"use_qlpc": True, "predictors": (sh.FN_QLPC,)},
    {"predictors": (sh.FN_DIFF0,)}, {"predictors": (sh.FN_DIFF1,)},
    {"predictors": (sh.FN_DIFF2,)}, {"predictors": (sh.FN_DIFF3,)},
    {"nmean": 0}, {"nmean": 1}, {"nmean": 4}, {"bitshift": 2},
    {"blocksize": 64}, {"blocksize": 100},
    {"verbatim": b"HDR\x00\xffbytes"},
])
def test_encode_roundtrip_grid(kw):
    x = _sig(3000, seed=7)
    if kw.get("bitshift"):
        x &= ~3
    data = sh.encode(x, sh.TYPE_S16LH, **kw)
    assert data == jax_sh.encode(x, jax_sh.TYPE_S16LH, **kw)
    _decoders_agree(data, want=x)


@needs_gxx
@pytest.mark.parametrize("ftype", [
    sh.TYPE_S16LH, sh.TYPE_S16HL, sh.TYPE_U16LH, sh.TYPE_U16HL,
    sh.TYPE_S8, sh.TYPE_U8])
def test_encode_roundtrip_linear_types(ftype):
    x = _sig()
    if ftype in (sh.TYPE_U16LH, sh.TYPE_U16HL):
        x = x + 0x8000
    elif ftype == sh.TYPE_U8:
        x = (x % 200) + 28
    elif ftype == sh.TYPE_S8:
        x = np.clip(x // 32, -128, 127)
    data = sh.encode(x, ftype)
    assert data == jax_sh.encode(x, ftype)
    _decoders_agree(data, want=x)


@needs_gxx
def test_encode_roundtrip_ulaw_family():
    x = _sig()
    codes = sh._nearest_code(x.reshape(-1), sh._ULAW_EXPAND)
    np.testing.assert_array_equal(
        codes, jax_sh._nearest_code(x.reshape(-1), jax_sh._ULAW_EXPAND))
    for ftype, table in ((sh.TYPE_AU1, sh._SIGNMAG_IN),
                         (sh.TYPE_AU2, sh._SIGNMAG_IN),
                         (sh.TYPE_ULAW, sh._ULAW_EXPAND)):
        internal = table[codes].reshape(x.shape)
        data = sh.encode(internal, ftype, nmean=4)
        assert data == jax_sh.encode(internal, ftype, nmean=4)
        st = _decoders_agree(data, want=internal)
        assert sh.samples_to_bytes(st) == jax_sh.samples_to_bytes(st)
        np.testing.assert_array_equal(sh.samples_to_float(st),
                                      jax_sh.samples_to_float(st))


@needs_gxx
def test_encoder_helpers_match():
    rng = np.random.RandomState(3)
    raw = rng.randint(0, 256, 600).astype(np.uint8).tobytes()
    for ftype in (sh.TYPE_U8, sh.TYPE_S8, sh.TYPE_S16HL, sh.TYPE_S16LH,
                  sh.TYPE_U16HL, sh.TYPE_U16LH, sh.TYPE_AU1, sh.TYPE_ULAW,
                  sh.TYPE_ALAW):
        np.testing.assert_array_equal(sh.bytes_to_samples(raw, ftype, 2),
                                      jax_sh.bytes_to_samples(raw, ftype, 2))
    e = rng.randint(-3000, 3000, 256)
    assert sh._best_resn(e) == jax_sh._best_resn(e)
    v = rng.randint(-40000, 40000, 500)
    np.testing.assert_array_equal(sh._ulaw_code(v), jax_sh._ulaw_code(v))
    for t in (sh.TYPE_AU3, sh.TYPE_ALAW):
        np.testing.assert_array_equal(sh._alaw_code(v, t),
                                      jax_sh._alaw_code(v, t))
    w, wj = sh._BitWriter(), jax_sh._BitWriter()
    for val, k in ((5, 0), (-7, 3), (123456, 2), (0, 5)):
        w.var(val, k)
        wj.var(val, k)
    w.ulong(77)
    wj.ulong(77)
    w.vars(e, 4)
    for val in e:
        wj.var(int(val), 4)
    assert w.tobytes() == wj.tobytes()


@needs_gxx
def test_native_max_samples_and_errors():
    x = _sig(8000)
    data = sh.encode(x, sh.TYPE_S16LH)
    st = _decoders_agree(data, max_samples=1000)
    assert len(st.samples) >= 1000
    np.testing.assert_array_equal(st.samples, x[:len(st.samples)])
    with pytest.raises(ValueError, match="magic"):
        native.shn_decode(b"nope" + b"\x00" * 50)
    with pytest.raises(ValueError, match="truncated"):
        native.shn_decode(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        sh.decode(data[:len(data) // 2])


def write_text_ark(path, items, fmt=repr, closing_own_line=False):
    """A Kaldi text ark of (utt, (T, D) matrix) items; ``closing_own_line``
    puts each matrix's ``]`` on a line of its own."""
    with open(path, "w") as f:
        for utt, mat in items:
            f.write(f"{utt}  [\n")
            for i, row in enumerate(mat):
                last = i == len(mat) - 1 and not closing_own_line
                f.write("  " + " ".join(fmt(float(v)) for v in row)
                        + (" ]" if last else "") + "\n")
            if closing_own_line:
                f.write("]\n")


@needs_gxx
def test_native_ark_parser_fuzz(tmp_path):
    """Random arks (scientific notation, subnormals, negative zero,
    extreme magnitudes): the C++ parser equals both packages' Python
    parsers bit for bit."""
    rng = np.random.RandomState(1234)
    for trial in range(8):
        D = int(rng.randint(1, 40))
        items = []
        for k in range(int(rng.randint(1, 6))):
            T = int(rng.randint(1, 30))
            mat = (rng.randn(T, D) * 10.0 ** rng.randint(-30, 30, (T, D))
                   ).astype(np.float32)
            flat = mat.ravel()
            idx = rng.randint(0, flat.size, min(6, flat.size))
            flat[idx] = np.array(
                [0.0, -0.0, 1e-38, -1e38, 3.4e38, 1.1754944e-38],
                np.float32)[:len(idx)]
            items.append((f"utt_{trial}-{k}-x", mat))
        path = str(tmp_path / f"fuzz{trial}.ark")
        write_text_ark(path, items)
        cc = native.text_ark(path)
        for ref in (list(kaldi_ark._read_text_ark_py(path)),
                    list(jax_ark._read_text_ark_py(path))):
            assert [u for u, _ in cc] == [u for u, _ in ref]
            for (_, a), (_, b) in zip(cc, ref):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)


@needs_gxx
def test_native_ark_parser_refuses_ragged(tmp_path):
    rng = np.random.RandomState(1)
    items = [("u1", rng.randn(4, 13).astype(np.float32)),
             ("u2", rng.randn(3, 42).astype(np.float32))]
    path = str(tmp_path / "ragged.ark")
    write_text_ark(path, items, fmt=lambda v: f"{v:.6g}")
    with pytest.raises(ValueError, match="not representable"):
        native.text_ark(path)
    (tmp_path / "empty.ark").write_text("")
    assert native.text_ark(str(tmp_path / "empty.ark")) == []
    assert list(kaldi_ark.read_text_ark(path)) != []


# ---------------------------------------------------------------------------
# the build: concurrent first calls, a failed build, no g++
# ---------------------------------------------------------------------------

_WORKER = """
import os, sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
import ast_tpu_torch.native as native
from ast_tpu_torch.data import shorten as sh
native.BUILD_DIR = Path(sys.argv[1])
data = open(sys.argv[2], "rb").read()
open(sys.argv[3] + ".ready", "w").close()
while not os.path.exists(sys.argv[3]):
    time.sleep(0.005)
st = sh.decode(data)
assert native._lib is not None, "the native library did not load"
print(int(st.samples.sum()), len(st.samples))
"""


def _stub_gxx(bin_dir, count_file, body):
    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, "g++")
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\necho run >> {count_file}\n{body}\n")
    os.chmod(path, 0o755)


@needs_gxx
def test_concurrent_first_loads_build_once(tmp_path):
    """Four processes make their first decode at once on an empty build
    directory, ``g++`` stubbed to count its runs (and to take a second,
    so the builds would overlap): one build, four libraries that
    decode."""
    real = shutil.which("g++")
    count = str(tmp_path / "gxx_runs")
    _stub_gxx(str(tmp_path / "bin"), count,
              f'sleep 1\nexec {real} "$@"')
    build = tmp_path / "build"
    x = _sig(5000, seed=3)
    stream = tmp_path / "s.shn"
    stream.write_bytes(sh.encode(x, sh.TYPE_S16LH))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO))
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}{os.pathsep}"
               f"{os.environ.get('PATH', '')}")
    gos = [str(tmp_path / f"go{i}") for i in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(build), str(stream), go],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for go in gos]
    deadline = time.time() + 120
    while not all(os.path.exists(g + ".ready") for g in gos):
        assert time.time() < deadline, "workers did not start"
        assert all(p.poll() is None for p in procs), procs[0].stderr.read()
        time.sleep(0.01)
    for g in gos:
        open(g, "w").close()
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == [str(int(x.sum())), str(len(x))]
    with open(count) as f:
        assert f.read().split() == ["run"]
    assert [p.name for p in build.iterdir() if p.suffix == ".so"] != []
    assert not [p for p in build.iterdir() if ".tmp" in p.name]


def _fresh_process(code, tmp_path, path):
    return subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "build")],
        env=dict(os.environ, PATH=path), capture_output=True, text=True,
        timeout=300, cwd=REPO)


_LOAD = ("import sys\nfrom pathlib import Path\n"
         "import ast_tpu_torch.native as native\n"
         "native.BUILD_DIR = Path(sys.argv[1])\n")


def test_failed_build_raises_with_compiler_stderr(tmp_path):
    count = str(tmp_path / "gxx_runs")
    _stub_gxx(str(tmp_path / "bin"), count,
              'echo "shorten_dec.cc:1: error: stub refuses" >&2\nexit 1')
    res = _fresh_process(_LOAD + "native.library()\n", tmp_path,
                         str(tmp_path / "bin"))
    assert res.returncode != 0
    assert "g++ failed" in res.stderr and "stub refuses" in res.stderr
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_compiler_takes_the_python_path(tmp_path):
    x = _sig(2000, seed=5)
    (tmp_path / "s.shn").write_bytes(sh.encode(x, sh.TYPE_S16LH))
    code = (_LOAD + "from ast_tpu_torch.data import shorten as sh\n"
            f"st = sh.decode(open({str(tmp_path / 's.shn')!r}, 'rb')"
            ".read())\n"
            "assert native.library() is None and native.shn_decode(b'') "
            "is None\nprint(int(st.samples.sum()))\n")
    empty = tmp_path / "empty_bin"
    empty.mkdir()
    res = _fresh_process(code, tmp_path, str(empty))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [str(int(x.sum()))]
    lines = [ln for ln in res.stderr.splitlines() if "no g++" in ln]
    assert len(lines) == 1
