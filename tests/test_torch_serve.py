"""The port's serving front door against ast_tpu's, on the CPU.

One tiny experiment and one ast_tpu checkpoint are exported by both
packages (``ast_tpu.cli.export_model --platforms cpu --dtype float32``
and ``ast_tpu_torch.cli.export_model``), f32 and int8.  The port's
``ArtifactServer`` (``--device cpu``: the kernels' plain versions) must
answer ast_tpu's on the same bodies -- ``ids`` and ``text`` exactly,
``score`` within 1e-4 -- for greedy, beam with n-best, audio, int8, an
over-long input and the rejected bodies.  Over HTTP on port 0: the
endpoints and counters, binary ``.npy`` bodies, ``/decode_batch`` with a
bad row, micro-batching, the replica pool and its in-flight bound,
``--warmup`` readiness, a device fault as 500, the drain (in process and
through SIGTERM to the CLI) and ``--workers``.  The kernel library's
first build is held to one build under concurrent callers, with ``nvcc``
stubbed.  Every request carries a timeout and every server is shut down
in a ``finally``.
"""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from ast_tpu import serving as jax_serving
from ast_tpu.cli import export_model as jax_export
from ast_tpu.cli import serve as jax_serve
from ast_tpu.config import Config as JaxConfig
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu_torch import serving
from ast_tpu_torch.checkpoint import flatten, load_checkpoint
from ast_tpu_torch.cli import export_model, serve
from ast_tpu_torch.kernels import build
from tests.conftest import make_tiny_experiment

SCORE_TOL = 1e-4
TIMEOUT = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    exp = make_tiny_experiment(str(root))
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(11),
                                           JaxConfig(exp).model)
    # EOS held back so reranked beams are not all the empty hypothesis
    params["dec"]["out_b"] = params["dec"]["out_b"].at[2].add(-2.0)
    jax_ckpt.save_checkpoint(os.path.join(exp, "seq2seq_2.model.npz"),
                             params, state)
    common = ["-m", exp, "--batch", "2", "--frames", "60"]
    q8 = ["--quantize", "int8", "--quantize-min-size", "64"]
    jax_flags = ["--platforms", "cpu", "--dtype", "float32"]
    out = {"exp": exp, "root": str(root)}
    for name, extra in (("f32", ["--beam", "2,2"]), ("q8", q8)):
        out[f"jax_{name}"] = jax_export.main(
            common + extra + jax_flags + ["-o", str(root / f"jax_{name}")])
        out[f"port_{name}"] = export_model.main(
            common + extra + ["-o", str(root / f"port_{name}")])
    speech = os.path.join(str(root), "speech", "tiny_dev")
    xs = [np.load(os.path.join(speech, f)).astype(np.float32)
          for f in sorted(os.listdir(speech))]
    out["xs"] = [xs[0][:60], xs[1][:30], xs[2][:45]]
    return out


@pytest.fixture(scope="module")
def servers(dirs):
    """(port, ast_tpu) servers over the f32 and int8 directories."""
    return {name: (serve.ArtifactServer(dirs[f"port_{name}"], device="cpu"),
                   jax_serve.ArtifactServer(dirs[f"jax_{name}"]))
            for name in ("f32", "q8")}


def _stem(name):
    return name.split(".")[0]


def _assert_same(got, want):
    """A port response against ast_tpu's: ids and text exact, scores
    within SCORE_TOL, the entry by its name pattern."""
    assert set(got) == set(want)
    for k in set(got) - {"score", "nbest", "artifact"}:
        assert got[k] == want[k], k
    assert _stem(got["artifact"]) == _stem(want["artifact"])
    if "score" in want:
        assert abs(got["score"] - want["score"]) <= SCORE_TOL
    if "nbest" in want:
        assert len(got["nbest"]) == len(want["nbest"])
        for g, w in zip(got["nbest"], want["nbest"]):
            assert (g["ids"], g["text"]) == (w["ids"], w["text"])
            assert abs(g["score"] - w["score"]) <= SCORE_TOL


def _bodies(dirs, case):
    xs = dirs["xs"]
    audio = (np.random.RandomState(0).randn(4000) * 0.1).astype(np.float32)
    return {
        "greedy": [{"features": x, "mode": "greedy"} for x in xs],
        "beam_nbest": [{"features": x, "mode": "beam", "w": 0.6,
                        "nbest": 2} for x in xs],
        "beam_default_w": [{"features": xs[0], "mode": "beam"}],
        "audio": [{"audio": audio}, {"audio": audio[:2000],
                                     "mode": "beam", "nbest": 2}],
        "truncated": [{"features": np.concatenate([xs[0], xs[1]])}],
        "int8": [{"features": x} for x in xs],
    }[case]


def test_quantize_params_bit_equal_to_ast_tpu(dirs):
    params = load_checkpoint(os.path.join(dirs["exp"],
                                          "seq2seq_2.model.npz"))["params"]
    for min_size in (64, 4096):
        got = serving.quantize_params(params, min_size)
        want = jax_serving.quantize_params(params, min_size)
        flat_got = flatten(got)
        flat_want = flatten(jax.tree.map(np.asarray, want))
        assert flat_got.keys() == flat_want.keys()
        for k, v in flat_want.items():
            assert flat_got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(flat_got[k], v)
        n_q8 = sum(k.endswith("/__q8__") for k in flat_got)
        assert n_q8 > 0 if min_size == 64 else n_q8 == 0


def test_export_dirs_match_ast_tpu(dirs):
    for name in ("f32", "q8"):
        port, ref = dirs[f"port_{name}"], dirs[f"jax_{name}"]
        with open(os.path.join(port, "vocab.json"), "rb") as f, \
                open(os.path.join(ref, "vocab.json"), "rb") as g:
            assert f.read() == g.read()
        with open(os.path.join(port, "manifest.json")) as f:
            got = json.load(f)
        with open(os.path.join(ref, "manifest.json")) as f:
            want = json.load(f)
        assert set(want) - {"format"} <= set(got)
        for k in ("symbols", "dec_vocab_size", "dec_key", "stop_limit",
                  "compute_dtype", "vocab", "input"):
            assert got[k] == want[k], k
        assert ("quantization" in got) == ("quantization" in want)
        keys = ("kind", "batch", "frames", "N", "K")
        assert [{k: e.get(k) for k in keys} for e in got["entries"]] == \
            [{k: e.get(k) for k in keys} for e in want["entries"]]
        assert [_stem(e["file"]) for e in got["entries"]] == \
            [_stem(e["file"]) for e in want["entries"]]
        # one model for every entry: an entry is a manifest record only
        assert sorted(os.listdir(port)) == sorted(
            ["manifest.json", "vocab.json", serving.MODEL, serving.WEIGHTS])
        for e in got["entries"]:
            assert e["file"] == _stem(e["file"])
            assert e["bytes"] == os.path.getsize(
                os.path.join(port, serving.WEIGHTS))
    with np.load(os.path.join(dirs["port_q8"], serving.WEIGHTS),
                 allow_pickle=False) as z:
        q8 = [k for k in z.files if k.endswith("/__q8__")]
        assert q8 and all(z[k].dtype == np.int8 for k in q8)
        assert all(z[k[:-len("__q8__")] + "scale"].dtype == np.float32
                   for k in q8)


@pytest.mark.parametrize("case", ["greedy", "beam_nbest", "beam_default_w",
                                  "audio", "truncated", "int8"])
def test_decode_matches_ast_tpu(dirs, servers, case):
    port, ref = servers["q8" if case == "int8" else "f32"]
    for body in _bodies(dirs, case):
        got, want = port.decode(dict(body)), ref.decode(dict(body))
        _assert_same(got, want)
        if case == "truncated":
            assert got["truncated_to_frames"] == 60 and got["frames"] == 90
        if case == "beam_nbest":
            assert len(got["nbest"]) == 2


@pytest.mark.parametrize("body", [
    {"features": np.zeros((30, 7), np.float32)},
    {"nonsense": 1},
    {"features": np.zeros(5, np.float32)},
    {"audio": np.zeros(100, np.float32)},
    {"features": np.zeros((30, 13), np.float32), "mode": "topk"},
], ids=["bad-width", "no-body", "1-d-features", "short-audio", "bad-mode"])
def test_decode_rejects_like_ast_tpu(servers, body):
    port, ref = servers["f32"]
    with pytest.raises(ValueError) as got:
        port.decode(dict(body))
    with pytest.raises(ValueError) as want:
        ref.decode(dict(body))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_batch_matches_ast_tpu(dirs, servers, mode):
    port, ref = servers["f32"]
    body = {"batch": ([{"features": x} for x in dirs["xs"]]
                      + [{"features": np.zeros((4, 7), np.float32)}]),
            "mode": mode, "nbest": 2}
    calls = port.stats.device_calls
    got, want = port.decode_batch(body), ref.decode_batch(body)
    # 3 good rows on a batch-2 entry: 2 calls
    assert port.stats.device_calls - calls == 2
    assert got["results"][3] == want["results"][3]
    assert "features must be" in got["results"][3]["error"]
    for x, g, w in zip(dirs["xs"], got["results"], want["results"]):
        _assert_same(g, w)
        assert g == port.decode({"features": x, "mode": mode, "nbest": 2})
    with pytest.raises(ValueError, match="non-empty"):
        port.decode_batch({"batch": []})


# ---------------------------------------------------------------------------
# over HTTP
# ---------------------------------------------------------------------------

def _post(url, body, timeout=TIMEOUT):
    if isinstance(body, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, body)
        data, ctype = buf.getvalue(), "application/octet-stream"
    else:
        data, ctype = json.dumps(body).encode(), "application/json"
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=TIMEOUT):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def _serving(serving_dir, **kw):
    """A port server on a free port in a thread: (base url, state)."""
    httpd, state = serve.make_server(serving_dir, port=0, device="cpu",
                                     **kw)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", state
    finally:
        if state.batcher is not None:
            state.batcher.close(timeout=TIMEOUT)
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=TIMEOUT)


def _json(x):
    return x.tolist()


def test_http_endpoints_and_bodies(dirs, servers):
    solo = servers["f32"][0]
    x = dirs["xs"][0]
    with _serving(dirs["port_f32"]) as (base, state):
        manifest = _get(base + "/manifest")
        assert manifest["dec_key"] == "en_w"
        assert manifest["server"]["default_w"] == 0.6
        health = _get(base + "/healthz")
        assert health["ok"] and health["ready"]
        assert health["replicas"] == ["cpu"] and health["artifacts"] == 2
        assert health["batching"] is False

        status, got = _post(base + "/decode",
                            {"features": _json(x), "mode": "greedy"})
        assert status == 200 and got == solo.decode(
            {"features": x, "mode": "greedy"})
        status, got_bin = _post(base + "/decode?mode=greedy", x)
        assert status == 200 and got_bin == got
        status, beam = _post(base + "/decode?mode=beam&w=0.6&nbest=2", x)
        assert status == 200 and beam == solo.decode(
            {"features": x, "mode": "beam", "w": 0.6, "nbest": 2})
        audio = (np.random.RandomState(1).randn(4000) * 0.1).astype(
            np.float32)
        status, got = _post(base + "/decode", audio)
        assert status == 200 and got == solo.decode({"audio": audio})

        status, err = _post(base + "/decode", np.zeros((2, 3, 4),
                                                       np.float32))
        assert status == 400 and "1-D audio" in err["error"]
        status, err = _post(base + "/decode", {"nonsense": 1})
        assert status == 400 and "features" in err["error"]
        status, err = _post(base + "/decode", {"features": {"a": 1}})
        assert status == 400
        status, _ = _post(base + "/nope", {})
        assert status == 404

        body = {"batch": [{"features": _json(x)},
                          {"features": _json(np.zeros((4, 7)))}],
                "mode": "greedy"}
        status, res = _post(base + "/decode_batch", body)
        assert status == 200
        assert res["results"][0] == solo.decode({"features": x,
                                                 "mode": "greedy"})
        assert "features must be" in res["results"][1]["error"]
        stack = np.stack(dirs["xs"][:1] * 3)
        status, res_bin = _post(base + "/decode_batch?mode=greedy", stack)
        assert status == 200 and res_bin["results"] == [
            res["results"][0]] * 3
        status, err = _post(base + "/decode_batch", {"batch": []})
        assert status == 400 and "non-empty" in err["error"]

        stats = _get(base + "/stats")
        # 6 requests answered, 4 bodies rejected (the 404 is no request);
        # device calls: 4 single decodes, then 1 + 2 for the batches
        assert stats["requests"] == 10 and stats["errors"] == 4
        assert stats["device_calls"] == 7 and stats["rows_decoded"] == 8
        assert stats["batch_occupancy"] == round(8 / 14, 4)
        assert stats["latency_s"]["n"] == 6
        assert stats["latency_s"]["p50"] <= stats["latency_s"]["p99"]
        # the plain versions ran: no kernel launched
        assert stats["kernel_launches"] == {
            "k1": 0, "k5": 0, "k6": 0, "k1_bf16": 0, "k5_bf16": 0,
            "k6_bf16": 0}


def test_http_stats_read_the_kernel_counters(dirs, monkeypatch):
    """``/stats`` reports the wrappers' own launch counters of the
    serving process, as a card's launches move them."""
    from ast_tpu_torch.ops import fused_infer, fused_lstm

    with _serving(dirs["port_f32"]) as (base, state):
        before = _get(base + "/stats")["kernel_launches"]
        for fn, n in ((fused_lstm.fused_stacked_lstm, 3),
                      (fused_infer.greedy_decode_fused, 2),
                      (fused_infer.beam_search_streams, 1)):
            monkeypatch.setattr(fn, "launches", fn.launches + n)
            # the bf16 entries' counters (compute_dtype bfloat16)
            monkeypatch.setattr(fn, "launches_bf16", fn.launches_bf16 + 2 * n)
        after = _get(base + "/stats")["kernel_launches"]
    assert {k: after[k] - before[k] for k in after} == \
        {"k1": 3, "k5": 2, "k6": 1, "k1_bf16": 6, "k5_bf16": 4, "k6_bf16": 2}


def _hit_all(base, bodies):
    results = [None] * len(bodies)

    def hit(i):
        results[i] = _post(base + "/decode", bodies[i])

    ts = [threading.Thread(target=hit, args=(i,)) for i in range(len(bodies))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=2 * TIMEOUT)
        assert not t.is_alive()
    return results


def _count_runs(state, during=None):
    """Wrap ``state._run``: the calls it sees, and ``during()`` inside
    each."""
    calls = []
    run = state._run

    def counted(entry, X, dev, stream):
        calls.append(X.shape[0])
        if during is not None:
            during()
        return run(entry, X, dev, stream)

    state._run = counted
    return calls


def test_http_concurrent_requests_share_one_call(dirs, servers):
    solo = servers["f32"][0]
    xs = dirs["xs"][:2]
    with _serving(dirs["port_f32"], batch_window_ms=2000) as (base, state):
        calls = _count_runs(state)
        results = _hit_all(base, [{"features": _json(x), "mode": "greedy"}
                                  for x in xs])
        assert calls == [2], calls
        for x, (status, got) in zip(xs, results):
            assert status == 200
            assert got == solo.decode({"features": x, "mode": "greedy"})
        stats = _get(base + "/stats")
        assert stats["device_calls"] == 1 and stats["batch_occupancy"] == 1.0


def test_http_replica_pool_and_inflight_bound(dirs, servers):
    """Two host replicas run two calls at once (a barrier inside the call
    would deadlock a pool of one); one replica with two tokens never runs
    a third call beside two."""
    x = dirs["xs"][0]
    want = servers["f32"][0].decode({"features": x, "mode": "greedy"})
    body = {"features": _json(x), "mode": "greedy"}
    barrier = threading.Barrier(2, timeout=TIMEOUT)
    with _serving(dirs["port_f32"], replicas=2, inflight=1) as (base,
                                                               state):
        assert len(state.devices) == 2 and len(state.models) == 1
        calls = _count_runs(state, during=barrier.wait)
        results = _hit_all(base, [body, body])
        assert calls == [1, 1]
        assert all(r == (200, want) for r in results)
        assert len(_get(base + "/healthz")["replicas"]) == 2

    live, peak = [0], [0]
    lock = threading.Lock()

    def held():
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.05)
        with lock:
            live[0] -= 1

    with _serving(dirs["port_f32"], replicas=1, inflight=2) as (base,
                                                               state):
        _count_runs(state, during=held)
        results = _hit_all(base, [body] * 6)
        assert all(r == (200, want) for r in results)
        assert peak[0] == 2, f"peak {peak[0]} calls in flight"


def test_audio_features_run_inside_the_call(dirs, servers):
    """An audio body's fbank runs on the device of the token its call
    holds, not before the call takes one."""
    audio = (np.random.RandomState(2).randn(4000) * 0.1).astype(np.float32)
    state = serve.ArtifactServer(dirs["port_f32"], inflight=1, device="cpu")
    seen = []
    features = state._audio_features

    def held(a, dev, stream):
        seen.append((dev, state._free.qsize()))
        return features(a, dev, stream)

    state._audio_features = held
    got = state.decode({"audio": audio})
    bulk = state.decode_batch({"batch": [{"audio": audio},
                                         {"features": dirs["xs"][0]}]})
    assert seen == [(state.devices[0], 0)] * 2      # the one token taken
    assert got == servers["f32"][0].decode({"audio": audio})
    assert bulk["results"][0] == got


def test_http_warmup_readiness(dirs, servers):
    x = dirs["xs"][0]
    with _serving(dirs["port_f32"], warmup=True) as (base, state):
        assert state.warm_total == 2
        deadline = time.monotonic() + TIMEOUT
        health = _get(base + "/healthz")
        while not health["ready"]:
            assert health["ok"] and time.monotonic() < deadline, health
            time.sleep(0.05)
            health = _get(base + "/healthz")
        assert health["warmup"]["done"] == health["warmup"]["total"] == 2
        assert "error" not in health["warmup"]
        assert state.stats.device_calls == 0    # warm calls are not served
        status, got = _post(base + "/decode", {"features": _json(x)})
        assert status == 200 and got == servers["f32"][0].decode(
            {"features": x})


def test_http_device_fault_is_500_and_not_ready(dirs, monkeypatch):
    def fault(self, entry, X, dev, stream):
        raise RuntimeError("k5_greedy_decode: CUDA launch failed with "
                           "cudaError 1")

    monkeypatch.setattr(serve.ArtifactServer, "_run", fault)
    with _serving(dirs["port_f32"], warmup=True) as (base, state):
        deadline = time.monotonic() + TIMEOUT
        while state.warm_done < state.warm_total:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        health = _get(base + "/healthz")
        assert health["ready"] is False and health["ok"] is False
        assert "cudaError 1" in health["warmup"]["error"]
        status, err = _post(base + "/decode",
                            {"features": _json(dirs["xs"][0])})
        assert status == 500 and "cudaError 1" in err["error"]


def test_http_graceful_drain(dirs, servers):
    x = dirs["xs"][0]
    with _serving(dirs["port_f32"], batch_window_ms=60000) as (base,
                                                              state):
        result = [None]

        def hit():
            result[0] = _post(base + "/decode",
                              {"features": _json(x), "mode": "greedy"})

        t = threading.Thread(target=hit)
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while not state.batcher._pending:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        state.batcher.close(timeout=TIMEOUT)        # the drain
        t.join(timeout=TIMEOUT)
        assert result[0] == (200, servers["f32"][0].decode(
            {"features": x, "mode": "greedy"}))
        status, err = _post(base + "/decode", {"features": _json(x)})
        assert status == 503 and "shutting down" in err["error"]
        status, err = _post(base + "/decode_batch",
                            {"batch": [{"features": _json(x)}]})
        assert status == 503


def _serve_cli(serving_dir, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "ast_tpu_torch.cli.serve", "-d", serving_dir,
         "--device", "cpu", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_cli_sigterm_drains_inflight_request(dirs, servers):
    """SIGTERM to the serve CLI while a request waits in the batch
    window: the request still gets 200, then the process exits 0."""
    x = dirs["xs"][0]
    proc = _serve_cli(dirs["port_f32"], "--port", "0",
                      "--batch-window-ms", "60000")
    try:
        line = proc.stdout.readline()
        assert "http://127.0.0.1:" in line, line
        base = line.split("on ")[1].split()[0].rstrip(",")
        result = [None]

        def hit():
            result[0] = _post(base + "/decode",
                              {"features": _json(x), "mode": "greedy"})

        t = threading.Thread(target=hit)
        t.start()
        time.sleep(1.0)
        assert result[0] is None            # still in the window
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=TIMEOUT)
        assert result[0] == (200, servers["f32"][0].decode(
            {"features": x, "mode": "greedy"}))
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)


def test_cli_prefork_workers(dirs, servers):
    """--workers 2: two processes on one port, each answers exactly, and
    SIGTERM drains both (exit 0)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    x = dirs["xs"][0]
    want = servers["f32"][0].decode({"features": x, "mode": "greedy"})
    proc = _serve_cli(dirs["port_f32"], "--port", str(port), "--workers",
                      "2")
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 2 * TIMEOUT
        while True:
            try:
                if _get(base + "/healthz", timeout=5)["ok"]:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "server never up"
            time.sleep(0.2)
        for _ in range(8):
            assert _post(base + "/decode", {"features": _json(x),
                                            "mode": "greedy"}) == (200, want)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert rc == 0, proc.stdout.read()[-500:]


# ---------------------------------------------------------------------------
# the export CLI's refusals, and the kernel library's first build
# ---------------------------------------------------------------------------

def test_export_refusals_and_ignored_flags(dirs, tmp_path, capsys):
    exp = dirs["exp"]
    # --dtype bfloat16 exports (once refused): the manifest's dtype
    out = export_model.main(["-m", exp, "--dtype", "bfloat16",
                             "-o", str(tmp_path / "a")])
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="beam width K=99"):
        export_model.main(["-m", exp, "--beam", "2,99",
                           "-o", str(tmp_path / "b")])
    assert not os.path.exists(tmp_path / "b")
    out = export_model.main(["-m", exp, "--platforms", "cpu,tpu",
                             "--native-kernels", "-o", str(tmp_path / "c")])
    assert "set and ignored" in capsys.readouterr().out
    with open(os.path.join(out, "manifest.json")) as f:
        entries = json.load(f)["entries"]
    # the default ladder: quarter points of 4 buckets of 50 + the cap
    assert [e["frames"] for e in entries] == [50, 100, 150, 250]
    assert [e["file"] for e in entries][0] == "greedy_B32_T50"


def test_export_refuses_a_variant_the_kernels_lack(tmp_path):
    """Once refused, a variant the decode kernels lack (``ln``) now
    exports and serves: both packages export one ast_tpu checkpoint of
    it, f32 with beam and int8 with the LayerNorm gains quantized, and
    the port's server answers ast_tpu's (its plain decode loops, as
    ast_tpu's XLA ones)."""
    exp = make_tiny_experiment(str(tmp_path))
    path = os.path.join(exp, "model_cfg.json")
    with open(path) as f:
        mcfg = json.load(f)
    mcfg["rnn_config"]["ln"] = True
    with open(path, "w") as f:
        json.dump(mcfg, f)
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(13),
                                           JaxConfig(exp).model)
    params["dec"]["out_b"] = params["dec"]["out_b"].at[2].add(-2.0)
    rng = np.random.RandomState(0)
    params["enc"]["ln"] = [{k: v + 0.3 * rng.randn(*v.shape)
                            for k, v in ln.items()}
                           for ln in params["enc"]["ln"]]
    jax_ckpt.save_checkpoint(os.path.join(exp, "seq2seq_1.model.npz"),
                             params, state)
    common = ["-m", exp, "--batch", "2", "--frames", "60"]
    q8 = ["--quantize", "int8", "--quantize-min-size", "16"]
    speech = os.path.join(os.path.dirname(exp), "speech", "tiny_dev")
    xs = [np.load(os.path.join(speech, f)).astype(np.float32)[:60]
          for f in sorted(os.listdir(speech))[:2]]
    for name, extra, modes in (("f32", ["--beam", "2,2"], ("greedy", "beam")),
                               ("q8", q8, ("greedy",))):
        want_dir = jax_export.main(common + extra + [
            "--platforms", "cpu", "--dtype", "float32",
            "-o", str(tmp_path / f"jax_{name}")])
        got_dir = export_model.main(common + extra + [
            "-o", str(tmp_path / f"port_{name}")])
        if name == "q8":
            z = np.load(os.path.join(got_dir, serving.WEIGHTS))
            assert "params/enc/ln/0/g/__q8__" in z.files
        port = serve.ArtifactServer(got_dir, device="cpu")
        ref = jax_serve.ArtifactServer(want_dir)
        for x in xs:
            for mode in modes:
                body = {"features": x, "mode": mode, "nbest": 2}
                _assert_same(port.decode(dict(body)), ref.decode(dict(body)))


def test_kernel_library_builds_once_under_threads(tmp_path, monkeypatch):
    """Four threads make their first kernel call at once: nvcc (stubbed
    by a script that records its calls) runs one build, and every thread
    gets the one loaded library."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "time.sleep(0.2)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    nvcc.chmod(0o755)
    loads = []

    class FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = [None] * 4
        barrier = threading.Barrier(4, timeout=TIMEOUT)

        def first_call(i):
            barrier.wait()
            got[i] = build.library()

        ts = [threading.Thread(target=first_call, args=(i,))
              for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    n_sources = len(list(build.CSRC.glob("*.cu")))
    lines = log.read_text().splitlines()
    assert len(lines) == n_sources + 1          # one compile each, one link
    assert sum("-shared" in ln for ln in lines) == 1
    assert len(loads) == 1 and all(g is got[0] for g in got)
    assert got[0].k5_greedy_decode.argtypes == build._SIGNATURES[
        "k5_greedy_decode"]
