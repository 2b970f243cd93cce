"""HTTP server over a serving directory, on the card.

``python -m ast_tpu_torch.cli.serve -d <serving_dir> [--port 8000]
[-w 0.6] [--batch-window-ms W] [--replicas N] [--inflight-per-replica I]
[--warmup] [--workers P] [--device cuda|cpu]``

The counterpart of ``ast_tpu/cli/serve.py``, behaviour for behaviour,
over the directory ``cli/export_model.py`` writes (``serving.py``): no
experiment directory, config pickle or checkpoint is read.  The model
loads once per replica device -- weights, their decode pack
(``seq2seq.decode_weights``, at the manifest's ``compute_dtype``) and
the MFCC front-end -- and an entry is a (kind, batch, frames[, N, K])
shape over it: greedy runs K1 + K5, beam K1 + K6, in their bf16 mode
when the manifest says ``"bfloat16"``.

Endpoints (JSON over HTTP, stdlib server):

- ``GET /manifest`` -- the manifest, plus ``server.default_w``.
- ``GET /healthz`` -- liveness and readiness: uptime, the replica
  devices, entry count, the warm-up's progress.
- ``GET /stats`` -- request/error totals, device calls, batch-slot
  occupancy, request latency p50/p90/p99 over a sliding window, and
  ``kernel_launches``: the K1 / K5 / K6 wrappers' launch counts in this
  process (0 where the plain versions run).
- ``POST /decode`` -- ``{"features": (T, 13) CMVN'd MFCCs}`` or
  ``{"audio": [...]}`` (8 kHz samples: MFCC on the device and stream of
  the call that decodes it, then per-utterance CMVN); optional
  ``"mode": "greedy"|"beam"``, ``"w"``, ``"nbest"``.  Response
  ``{"text", "ids", "mode", "frames", "artifact"}``, beam ``score`` and
  ``nbest``, and ``truncated_to_frames`` when the input exceeds every
  entry.  With ``Content-Type: application/octet-stream`` the body is
  one ``.npy`` blob (2-D features or 1-D audio) and options ride the
  query string.
- ``POST /decode_batch`` -- ``{"batch": [item, ...]}`` (or a binary
  ``(B, T, 13)`` stack): rows grouped by entry and decoded in batch-size
  chunks; a malformed row errors alone.

Status codes: 400 for bad input, 503 while draining, 500 for a device
fault (a refused kernel launch, a CUDA error) -- never a silent CPU
decode.

An entry's rows are padded to its ``frames`` (the model attends over
padding unmasked, so the padded length is part of the result, as in
``ast_tpu``) but not to its batch: the kernels take any row count, and
zero rows would keep a greedy decode running to the stop limit.  The
slots are still counted against the entry's batch, so
``batch_occupancy`` means what it means in ``ast_tpu``.

``--batch-window-ms`` collects concurrent requests for one entry into
one device call.  ``--replicas N`` serves from the first N CUDA devices
(0 = all); each holds ``--inflight-per-replica`` tokens, and each token
owns a CUDA stream, so two batches on one card overlap one's host launch
loop with the other's device time; a call synchronises its own stream
before its token goes back.  ``--warmup`` builds the kernel library and
decodes one full batch of every entry on every replica in the
background; ``/healthz`` says ``ready: false`` until then.  ``--workers
P`` re-executes this module P - 1 times, every process bound to the same
port with ``SO_REUSEPORT``.  On SIGTERM the server drains: in-flight
requests finish, queued ones are dispatched, new ones get 503, then it
exits 0.
"""

import argparse
import collections
import contextlib
import io
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ast_tpu_torch import serving
from ast_tpu_torch.detok import ids_to_text
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import fused_infer, fused_lstm
from ast_tpu_torch.ops.beam import make_beam_decoder, rerank_hypothesis
from ast_tpu_torch.ops.bf16 import parse_dtype
from ast_tpu_torch.ops.fbank import (
    MfccExtractor, apply_cmvn, compute_cmvn_stats, num_frames)
from ast_tpu_torch.params import torch_device


def _detok(ids, vocab, dec_key):
    return ids_to_text(ids, lambda i: vocab[str(i)], dec_key)


def kernel_launches():
    """The decode kernels' launch counts in this process, by the names of
    ``chip_smoke.py``'s kernels line (each wrapper counts where it
    launches its kernel, never where it runs its plain version)."""
    return {"k1": fused_lstm.fused_stacked_lstm.launches,
            "k5": fused_infer.greedy_decode_fused.launches,
            "k6": fused_infer.beam_search_streams.launches,
            "k1_bf16": fused_lstm.fused_stacked_lstm.launches_bf16,
            "k5_bf16": fused_infer.greedy_decode_fused.launches_bf16,
            "k6_bf16": fused_infer.beam_search_streams.launches_bf16}


@contextlib.contextmanager
def _on(dev, stream):
    """Inference mode, and on a card its device and the call's stream."""
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(torch.inference_mode())
        if stream is not None:
            ctx.enter_context(torch.cuda.device(dev))
            ctx.enter_context(torch.cuda.stream(stream))
        yield


class _Audio:
    """An audio body's samples and frame count: its MFCC runs inside the
    call that decodes it, on that call's device and stream."""

    __slots__ = ("samples", "shape")

    def __init__(self, samples, n_frames, n_ceps):
        self.samples = samples
        self.shape = (n_frames, n_ceps)


class _Stats:
    """Serving counters for ``GET /stats`` (lock-protected)."""

    def __init__(self, window=2048):
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests = 0
        self.errors = 0
        self.device_calls = 0
        self.rows = 0                    # utterances decoded
        self.slots = 0                   # entry batch capacity used
        self._lat = collections.deque(maxlen=window)

    def record_request(self, seconds, error=False):
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            else:
                self._lat.append(seconds)

    def record_call(self, rows, batch):
        with self._lock:
            self.device_calls += 1
            self.rows += rows
            self.slots += batch

    def snapshot(self):
        with self._lock:
            lat = sorted(self._lat)
            out = {
                "uptime_s": round(time.time() - self.started, 3),
                "requests": self.requests,
                "errors": self.errors,
                "device_calls": self.device_calls,
                "rows_decoded": self.rows,
                # fraction of the entries' batch rows that carried real
                # utterances (1.0 = perfectly packed calls)
                "batch_occupancy": (round(self.rows / self.slots, 4)
                                    if self.slots else None),
            }
        if lat:
            pick = lambda q: round(lat[min(len(lat) - 1,
                                           int(q * len(lat)))], 4)
            out["latency_s"] = {"p50": pick(0.50), "p90": pick(0.90),
                                "p99": pick(0.99), "n": len(lat)}
        return out


class ServerDraining(RuntimeError):
    """Request rejected because the server is shutting down (503)."""


class _Pending:
    """One utterance waiting inside the micro-batcher."""

    __slots__ = ("x", "event", "out", "error", "t")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.out = None
        self.error = None
        self.t = time.monotonic()       # arrival: bounds the wait window


class _MicroBatcher:
    """Collects concurrent same-entry requests into one device call.

    A dispatcher thread waits up to ``window_s`` after the oldest pending
    request (dispatching at once when an entry's batch is full), then
    hands the group to ``call_rows``.  Exceptions propagate to every
    affected waiter.  ``workers`` dispatchers (one per replica token) can
    have that many groups in flight."""

    def __init__(self, call_rows, window_s, workers=1):
        self._call_rows = call_rows
        self.window_s = window_s
        self._cond = threading.Condition()
        self._pending = {}              # file -> (entry, [_Pending, ...])
        self._closed = False
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(max(1, workers))]
        for t in self._threads:
            t.start()

    def submit(self, entry, x):
        req = _Pending(x)
        with self._cond:
            if self._closed:
                raise ServerDraining("server is shutting down")
            self._pending.setdefault(entry["file"], (entry, []))[1] \
                .append(req)
            self._cond.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.out

    @property
    def closed(self):
        with self._cond:
            return self._closed

    def close(self, timeout=120.0):
        """Reject new submissions, dispatch everything already queued,
        and join the dispatcher threads (the timeout covers a cold
        kernel build and a full-batch decode)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _fullest(self):
        return max(self._pending.items(), key=lambda kv: len(kv[1][1]))

    def _run(self):
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                while not self._closed and self._pending:
                    _, (entry, reqs) = self._fullest()
                    if len(reqs) >= entry["batch"]:
                        break
                    # the OLDEST pending request sets the deadline, so no
                    # request waits more than ~window_s past arrival
                    oldest = min(v[1][0].t for v in self._pending.values())
                    left = oldest + self.window_s - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=left)
                if not self._pending:
                    # another worker drained the queue while we waited
                    continue
                # a full group if one exists, else the group holding the
                # oldest (deadline-expired) request
                fname, (entry, reqs) = self._fullest()
                if len(reqs) < entry["batch"]:
                    fname, (entry, reqs) = min(
                        self._pending.items(),
                        key=lambda kv: kv[1][1][0].t)
                take = reqs[: entry["batch"]]
                del reqs[: len(take)]
                if not reqs:
                    del self._pending[fname]
            try:
                outs = self._call_rows(entry, [r.x for r in take])
                for r, o in zip(take, outs):
                    r.out = o
            except Exception as e:       # surface to every waiter
                for r in take:
                    r.error = e
            for r in take:
                r.event.set()


class _Replica:
    """The model on one device: weights, their decode pack at the
    compute dtype and the MFCC front-end, made once."""

    def __init__(self, serving_dir, device, dtype):
        self.device = device
        self.mcfg, self.params, self.state = serving.load_model(
            serving_dir, device)
        with torch.inference_mode():
            self.w = seq2seq.decode_weights(self.params, dtype, self.mcfg)
        self.mfcc = MfccExtractor(device=device)
        if device.type == "cuda":
            # made on the default stream; calls read them on their own
            torch.cuda.synchronize(device)


class ArtifactServer:
    """Loads a serving dir; decodes single utterances and batches."""

    def __init__(self, serving_dir, default_w=0.6, batch_window_ms=0.0,
                 replicas=1, warmup=False, inflight=2, device="cuda"):
        self.dir = serving_dir
        self.default_w = default_w
        with open(os.path.join(serving_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        if "vocab" not in self.manifest:
            raise ValueError(
                f"{serving_dir}/manifest.json has no 'vocab' entry — "
                "re-export with export_model; the server cannot "
                "detokenize without it")
        with open(os.path.join(serving_dir, self.manifest["vocab"])) as f:
            self.vocab = json.load(f)
        self.stop_limit = int(self.manifest["stop_limit"])
        self.dtype = parse_dtype(self.manifest.get("compute_dtype"))
        self.entries = {"greedy": [], "beam": []}
        self.artifacts = {}             # entry name -> entry
        for e in self.manifest["entries"]:
            self.entries[e["kind"]].append(e)
            self.artifacts[e["file"]] = e
        for v in self.entries.values():         # smallest fitting shape first
            v.sort(key=lambda e: (e["frames"], e["batch"]))

        dev = torch_device(device)
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            n = count if replicas <= 0 else min(replicas, count)
            self.devices = [torch.device("cuda", i) for i in range(n)]
        else:
            # host replicas share one model; the pool still bounds and
            # overlaps their calls
            self.devices = [dev] * max(1, replicas)
        self.models = {}
        for d in self.devices:
            if str(d) not in self.models:
                self.models[str(d)] = _Replica(serving_dir, d, self.dtype)
        first = self.models[str(self.devices[0])]
        self.mfcc_cfg = first.mfcc.cfg
        # conv layer 0's kernel spans the whole feature axis (OIHW)
        self.feat_dim = int(first.params["cnn"][0]["w"].shape[3])
        self._beam = {(e["N"], e["K"]): make_beam_decoder(
            first.mcfg, e["N"], e["K"], self.stop_limit,
            compute_dtype=self.dtype)
            for e in self.entries["beam"]}
        self.stats = _Stats()
        # replica pool: ``inflight`` tokens a device, each with its own
        # stream; a call holds its token until its stream has finished
        self.inflight = max(1, int(inflight))
        self._free = queue.Queue()
        for _ in range(self.inflight):
            for d in self.devices:
                self._free.put((d, self._stream(d)))
        self.batcher = (_MicroBatcher(self._call_rows,
                                      batch_window_ms / 1000.0,
                                      workers=(len(self.devices)
                                               * self.inflight))
                        if batch_window_ms > 0 else None)
        self._warm_lock = threading.Lock()
        self.warm_total = (len(self.artifacts) * len(self.devices)
                           if warmup else 0)
        self.warm_done = 0
        self.warm_error = None
        self.warm_seconds = None
        if warmup:
            threading.Thread(target=self._warmup, daemon=True).start()

    @staticmethod
    def _stream(dev):
        return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def _warmup(self):
        # the first kernel call builds the library (nvcc, on a cold
        # build/ directory)
        t0 = time.monotonic()
        for fname, entry in self.artifacts.items():
            X = np.zeros((entry["batch"], entry["frames"], self.feat_dim),
                         np.float32)
            for dev in self.devices:
                try:
                    self._run(entry, X, dev, self._stream(dev))
                except Exception as e:     # surface via /healthz; the
                    with self._warm_lock:  # request path re-raises it
                        if self.warm_error is None:
                            self.warm_error = f"{fname}: {e}"
                with self._warm_lock:
                    self.warm_done += 1
        self.warm_seconds = time.monotonic() - t0
        print(f"warm-up: {self.warm_done} entry-replicas in "
              f"{self.warm_seconds:.1f} s", flush=True)

    @property
    def ready(self):
        # a warm-up failure means some entry fails every decode: stay
        # not-ready so a load balancer gating on `ready` holds traffic
        with self._warm_lock:
            return (self.warm_done >= self.warm_total
                    and self.warm_error is None)

    def _features(self, body):
        if "features" in body:
            x = np.asarray(body["features"], np.float32)
            if x.ndim != 2:
                raise ValueError("features must be a (T, n_ceps) matrix")
            return x
        if "audio" in body:
            audio = np.asarray(body["audio"], np.float32).reshape(-1)
            n = num_frames(self.mfcc_cfg, len(audio))
            if n == 0:
                raise ValueError("audio shorter than one MFCC frame")
            return _Audio(audio, n, self.mfcc_cfg.n_ceps)
        raise ValueError("body must carry 'features' or 'audio'")

    def _audio_features(self, audio, dev, stream):
        """An audio body's CMVN'd MFCCs, the fbank on ``dev`` under
        ``stream``."""
        with _on(dev, stream):
            feats = self.models[str(dev)].mfcc(audio.samples).cpu().numpy()
        return np.asarray(apply_cmvn(feats, compute_cmvn_stats([feats])),
                          np.float32)

    def _run(self, entry, X, dev, stream):
        """Decode the rows of X (n, frames, F) for ``entry`` on ``dev``
        under ``stream``; returns the outputs as NumPy arrays, batch-major
        (greedy: preds; beam: hyps, scores, lengths).  An error inside
        the decode is a server fault (RuntimeError, 500), not bad input."""
        rep = self.models[str(dev)]
        with _on(dev, stream):
            try:
                Xt = torch.from_numpy(X).to(dev)
                if entry["kind"] == "greedy":
                    out = (seq2seq.predict_greedy(
                        rep.params, rep.state, rep.mcfg, Xt,
                        self.stop_limit, rep.w,
                        compute_dtype=self.dtype)[0],)
                else:
                    out = self._beam[(entry["N"], entry["K"])](
                        rep.params, rep.state, Xt, rep.w)
                out = [o.cpu().numpy() for o in out]
            except (ValueError, KeyError, TypeError) as e:
                raise RuntimeError(f"{entry['file']}: {e}") from e
            if stream is not None:
                stream.synchronize()
        return out

    def _call_rows(self, entry, xs):
        """Decode utterances ``xs`` (each ``(t, F)`` features or an
        ``_Audio``, at most the entry's batch) in one call at the entry's
        static batch, zero rows after them; returns the real rows' output
        tuples.  A row's float sums then do not depend on how many
        requests share its call (the GEMMs' blocking and algorithm are
        chosen by their row count), so a batched row equals the request
        decoded alone."""
        T, B = entry["frames"], entry["batch"]
        dev, stream = self._free.get()      # block until a token frees
        try:
            # width from the model, not from the first queued request: a
            # malformed request must not poison its batch mates (each
            # row is validated in decode() before submit)
            X = np.zeros((B, T, self.feat_dim), np.float32)
            for i, x in enumerate(xs):
                if isinstance(x, _Audio):
                    x = self._audio_features(x, dev, stream)
                X[i, : min(T, x.shape[0])] = x[:T]
            out = self._run(entry, X, dev, stream)
        finally:
            self._free.put((dev, stream))
        self.stats.record_call(len(xs), B)
        return [tuple(o[i] for o in out) for i in range(len(xs))]

    def _pick_entry(self, mode, x):
        """The smallest fitting entry for one utterance, its feature width
        checked (before any batching, so a bad width fails only its own
        request)."""
        options = self.entries.get(mode)
        if not options:
            raise ValueError(f"no {mode!r} artifact exported")
        entry = next((e for e in options if e["frames"] >= x.shape[0]),
                     options[-1])
        if x.shape[1] != self.feat_dim:
            raise ValueError(
                f"features must be (T, {self.feat_dim}); got (T, "
                f"{x.shape[1]})")
        return entry

    def decode(self, body):
        x = self._features(body)
        mode = body.get("mode") or (
            "greedy" if self.entries["greedy"] else "beam")
        entry = self._pick_entry(mode, x)
        if self.batcher is not None:
            row = self.batcher.submit(entry, x)
        else:
            row = self._call_rows(entry, [x])[0]
        return self._row_response(row, mode, entry, body, x.shape[0])

    def _row_response(self, row, mode, entry, body, n_frames):
        """The per-utterance response dict from one output row (shared by
        /decode and /decode_batch)."""
        T = entry["frames"]
        syms = self.manifest.get("symbols", {"GO": 1, "EOS": 2})
        go_id, eos_id = int(syms["GO"]), int(syms["EOS"])
        dec_key = self.manifest["dec_key"]
        if mode == "greedy":
            raw = row[0]
            # cut at the utterance's own first EOS: post-EOS argmax is
            # babble conditioned beyond the sentence
            eos = np.nonzero(raw == eos_id)[0]
            ids = [int(i) for i in (raw[: eos[0]] if eos.size else raw)]
        else:
            hyps, scores, lengths = row
            entries = [(hyps[n, : int(lengths[n])].tolist(),
                        float(scores[n]))
                       for n in range(hyps.shape[0])]
            reranked = rerank_hypothesis(entries,
                                         float(body.get("w",
                                                        self.default_w)))

            # beam hyps carry the GO prefix and (when finished) the EOS
            # terminator; strip both so 'ids' means the same thing in
            # every mode
            def _strip(h):
                h = [int(i) for i in h]
                if h and h[0] == go_id:
                    h = h[1:]
                if h and h[-1] == eos_id:
                    h = h[:-1]
                return h

            ids = _strip(reranked[0][0])
        resp = {"text": _detok(ids, self.vocab, dec_key),
                "ids": ids, "mode": mode, "frames": int(n_frames),
                "artifact": entry["file"]}
        if mode == "beam":
            resp["score"] = float(reranked[0][1])
            nbest = int(body.get("nbest", 1))
            if nbest > 1:
                out = [{"ids": ids, "text": resp["text"],
                        "score": resp["score"]}]
                for hyp, s, _len in reranked[1:nbest]:
                    h = _strip(hyp)
                    out.append({"ids": h,
                                "text": _detok(h, self.vocab, dec_key),
                                "score": float(s)})
                resp["nbest"] = out
        if n_frames > T:
            # no entry fits: only the first T frames were decoded
            resp["truncated_to_frames"] = T
        return resp

    def decode_batch(self, body):
        """Bulk decode: ``{"batch": [item, ...]}``, each item a
        ``/decode`` body; top-level ``mode``/``w``/``nbest`` apply to
        every item.  Rows are grouped by entry and decoded in chunks of
        its batch; a malformed item yields ``{"error": ...}`` in its slot
        while the rest decode.  Returns ``{"results": [...]}`` in input
        order."""
        if self.batcher is not None and self.batcher.closed:
            raise ServerDraining("server is shutting down")
        items = body.get("batch")
        if not isinstance(items, list) or not items:
            raise ValueError("body must carry a non-empty 'batch' list")
        mode = body.get("mode") or (
            "greedy" if self.entries["greedy"] else "beam")
        opts = {k: body[k] for k in ("w", "nbest") if k in body}
        results = [None] * len(items)
        groups = {}                      # entry name -> (entry, [i, ...])
        xs = {}
        for i, item in enumerate(items):
            try:
                x = self._features(item)
                entry = self._pick_entry(mode, x)
            except (ValueError, KeyError, TypeError) as e:
                results[i] = {"error": str(e)}
                continue
            xs[i] = x
            groups.setdefault(entry["file"], (entry, []))[1].append(i)
        for entry, idxs in groups.values():
            B = entry["batch"]
            for c in range(0, len(idxs), B):
                chunk = idxs[c: c + B]
                rows = self._call_rows(entry, [xs[i] for i in chunk])
                for i, row in zip(chunk, rows):
                    results[i] = self._row_response(
                        row, mode, entry, opts, xs[i].shape[0])
        return {"results": results}


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog (5) resets connections under
    # a burst of concurrent clients -- the load micro-batching is for
    request_queue_size = 128
    # NON-daemon handler threads: server_close() joins only those, and
    # the SIGTERM drain (in-flight requests write their responses before
    # exit) depends on that join
    daemon_threads = False
    # --workers: every worker binds the SAME port with SO_REUSEPORT and
    # the kernel spreads connections across them
    reuse_port = False

    def server_bind(self):
        if self.reuse_port:
            self.socket.setsockopt(socket.SOL_SOCKET,
                                   socket.SO_REUSEPORT, 1)
        super().server_bind()


def make_server(serving_dir, port=0, host="127.0.0.1", default_w=0.6,
                batch_window_ms=0.0, replicas=1, warmup=False,
                inflight=2, reuse_port=False, device="cuda"):
    """Build (ThreadingHTTPServer, ArtifactServer); the caller runs
    ``serve_forever`` (the CLI) or a thread (tests)."""
    state = ArtifactServer(serving_dir, default_w=default_w,
                           batch_window_ms=batch_window_ms,
                           replicas=replicas, warmup=warmup,
                           inflight=inflight, device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):              # quiet by default
            pass

        def _reply(self, code, obj):
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/manifest":
                self._reply(200, dict(state.manifest,
                                      server={"default_w": state.default_w}))
            elif self.path == "/healthz":
                out = {
                    "ok": state.warm_error is None,
                    "ready": state.ready,
                    "uptime_s": round(time.time() - state.stats.started, 3),
                    "replicas": [str(d) for d in state.devices],
                    "artifacts": len(state.artifacts),
                    "batching": state.batcher is not None,
                }
                if state.warm_total:
                    out["warmup"] = {"done": state.warm_done,
                                     "total": state.warm_total}
                    if state.warm_error:
                        out["warmup"]["error"] = state.warm_error
                    if state.warm_seconds is not None:
                        out["warmup"]["seconds"] = round(
                            state.warm_seconds, 3)
                self._reply(200, out)
            elif self.path == "/stats":
                self._reply(200, dict(state.stats.snapshot(),
                                      kernel_launches=kernel_launches()))
            else:
                self._reply(404, {"error": "GET /manifest|/healthz|/stats "
                                           "or POST /decode"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/decode", "/decode_batch"):
                self._reply(404, {"error": "POST /decode|/decode_batch"})
                return
            bulk = url.path == "/decode_batch"
            t0 = time.monotonic()
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/octet-stream"):
                    # one .npy blob: (T, n_ceps) features or 1-D audio;
                    # for /decode_batch a (B, T, n_ceps) stack; options
                    # ride the query string (?mode=beam&w=0.6&nbest=5)
                    arr = np.load(io.BytesIO(raw), allow_pickle=False)
                    want_nd = (3,) if bulk else (1, 2)
                    if arr.ndim not in want_nd:
                        raise ValueError(
                            "binary body must be a (B, T, n_ceps) "
                            "feature stack" if bulk else
                            "binary body must be a (T, n_ceps) feature "
                            f"matrix or a 1-D audio vector (got shape "
                            f"{arr.shape})")
                    arr = arr.astype(np.float32)
                    q = {k: v[-1] for k, v in
                         parse_qs(url.query).items()}
                    if bulk:
                        body = {"batch": [{"features": a} for a in arr]}
                    else:
                        body = {"features" if arr.ndim == 2 else "audio":
                                arr}
                    if "mode" in q:
                        body["mode"] = q["mode"]
                    if "w" in q:
                        body["w"] = float(q["w"])
                    if "nbest" in q:
                        body["nbest"] = int(q["nbest"])
                else:
                    body = json.loads(raw or b"{}")
                out = (state.decode_batch(body) if bulk
                       else state.decode(body))
            except (ValueError, KeyError, TypeError) as e:
                state.stats.record_request(time.monotonic() - t0,
                                           error=True)
                self._reply(400, {"error": str(e)})
                return
            except ServerDraining as e:     # retryable: shutting down
                state.stats.record_request(time.monotonic() - t0,
                                           error=True)
                self._reply(503, {"error": str(e)})
                return
            except RuntimeError as e:
                # device faults (a refused launch, a CUDA error) are
                # server faults, not retryable drains
                state.stats.record_request(time.monotonic() - t0,
                                           error=True)
                self._reply(500, {"error": str(e)})
                return
            state.stats.record_request(time.monotonic() - t0)
            self._reply(200, out)

    cls = _Server if not reuse_port else type(
        "_ReusePortServer", (_Server,), {"reuse_port": True})
    return cls((host, port), Handler), state


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve a serving directory over HTTP")
    parser.add_argument("-d", "--serving_dir", required=True,
                        help="directory written by cli/export_model.py")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("-w", "--W", type=float, default=0.6,
                        help="default beam length-norm weight "
                             "(per-request 'w' overrides)")
    parser.add_argument("--batch-window-ms", type=float, default=0.0,
                        help="micro-batch concurrent requests: wait up "
                             "to this long to fill an entry's batch "
                             "before dispatching (0 = off)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="serve from this many CUDA devices (0 = "
                             "all visible; default 1)")
    parser.add_argument("--warmup", action="store_true",
                        help="build the kernels and decode every entry "
                             "on every replica at startup in the "
                             "background; /healthz reports ready=false "
                             "until done")
    parser.add_argument("--inflight-per-replica", type=int, default=2,
                        dest="inflight",
                        help="max batches in flight per device, each on "
                             "its own stream (1 = one call at a time)")
    parser.add_argument("--workers", type=int, default=1,
                        help="run this many server PROCESSES, all bound "
                             "to --port via SO_REUSEPORT: one Python "
                             "lock per worker for the host-side work.  "
                             "Requires an explicit --port.")
    parser.add_argument("--device", default="cuda",
                        help="torch device type (default cuda; cpu runs "
                             "the kernels' plain PyTorch versions)")
    parser.add_argument("--_reuseport_child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    children = []
    if args.workers > 1:
        if args.port == 0:
            parser.error("--workers requires an explicit --port "
                         "(every worker binds the same one)")
        # this process is worker 0; workers 1..N-1 are fresh processes
        # (never a fork of a process that may hold a CUDA context)
        child_argv = list(argv if argv is not None else sys.argv[1:])
        while "--workers" in child_argv:
            i = child_argv.index("--workers")
            del child_argv[i:i + 2]
        children = [
            subprocess.Popen(
                [sys.executable, "-m", "ast_tpu_torch.cli.serve",
                 *child_argv, "--_reuseport_child"])
            for _ in range(args.workers - 1)]

    httpd, state = make_server(args.serving_dir, args.port, args.host,
                               default_w=args.W,
                               batch_window_ms=args.batch_window_ms,
                               replicas=args.replicas,
                               warmup=args.warmup,
                               inflight=args.inflight,
                               reuse_port=(args.workers > 1
                                           or args._reuseport_child),
                               device=args.device)
    kinds = {k: len(v) for k, v in state.entries.items() if v}
    batching = (f", micro-batch window {args.batch_window_ms:g} ms"
                if state.batcher else "")
    pool = (f", {len(state.devices)} device replicas"
            if len(state.devices) > 1 else "")
    warm = (f", warming {state.warm_total} entry-replicas"
            if state.warm_total else "")
    print(f"serving {kinds} entries from {args.serving_dir} "
          f"on http://{args.host}:{httpd.server_address[1]}"
          f"{batching}{pool}{warm}", flush=True)

    # graceful drain on SIGTERM: stop accepting connections, finish
    # in-flight requests (server_close joins handler threads), dispatch
    # what the micro-batcher holds, then exit 0.  shutdown() must run off
    # the main thread: the signal handler interrupts serve_forever.
    def _term(signum, frame):
        print("SIGTERM: draining in-flight requests and shutting down",
              flush=True)
        for c in children:               # fan out to the other workers
            c.send_signal(signal.SIGTERM)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    finally:
        # draining the batcher unblocks handler threads waiting on their
        # _Pending events, THEN server_close joins the handler threads
        if state.batcher is not None:
            state.batcher.close()
        httpd.server_close()
        for c in children:               # every worker drains before exit
            c.wait()


if __name__ == "__main__":
    main()
