"""Reference (Chainer) checkpoints without Chainer, NumPy only: a copy
of ``ast_tpu.train.chainer_import`` (``tests/test_torch_transfer.py``
holds the two equal on every model variant).

The reference saves its whole model with ``chainer.serializers.save_npz``
(reference: train.py:75, nn.py:150), which is a plain NumPy ``.npz``
archive: one array per parameter, keyed by the link path (``CNN_0/W``,
``L0_enc/upward/W``, ``embed_dec/W``, ``out/b``, ...).  This module
remaps names and layouts into the ``init_model`` tree, so the port's
entry points resume from a reference experiment directory as it is (the
on-disk name is ``seq2seq_<epoch>.model``: Chainer hands
``numpy.savez_compressed`` an open file handle, so no ``.npz`` suffix is
appended).

Layout differences handled:

* **Linear** (reference ``L.Linear``): W is (out, in) applied as
  ``x @ W.T + b``; ours is (in, out) applied as ``x @ w + b`` ->
  transpose.
* **Conv2D**: both are OIHW -> copied as-is.
* **LSTM** (reference ``L.LSTM``): two children, ``upward`` (W (4H, in),
  b (4H)) and ``lateral`` (W (4H, H), no bias), computing
  ``z = upward(x) + lateral(h)``.  Chainer's ``F.lstm`` reads the packed
  preactivation *interleaved per unit*: ``z.reshape(B, H, 4)`` with gate
  order (a, i, f, o) where ``a`` is the tanh cell candidate.  Our cells
  use contiguous blocks in order (i, f, g, o) with
  ``z = x @ wx + h @ wh + b`` -> de-interleave + permute + transpose.
* **BatchNormalization**: ``gamma``/``beta`` are trained params,
  ``avg_mean``/``avg_var`` go to the running-stat state tree (``N`` is
  Chainer's sample counter, dropped).
* **Bidirectional encoder**: the reference keeps separate links
  ``L{i}_enc`` / ``L{i}_rev_enc``; we stack the two directions on a
  leading axis (dir 0 = forward), as ``init_model`` does.

Every variant ``ast_tpu`` converts is converted here (LayerNorm,
``linear_proj``, several attention heads, a unidirectional or text
encoder), including those the port's model gate refuses: this is key
remapping only.  ``ast_to_chainer`` is the exact inverse, used by
``cli.copy_params --export-chainer``.
"""

import re

import numpy as np

# our packed gate blocks [i, f, g, o] drawn from chainer's per-unit
# interleave (a, i, f, o): block m comes from chainer gate index GATES[m]
_GATE_PERM = (1, 2, 0, 3)


def is_chainer_checkpoint(keys):
    """True if the npz key set looks like a Chainer-serialized model."""
    ks = set(keys)
    if any(k.lstrip("/").endswith("upward/W") for k in ks):
        return True
    return any(k.lstrip("/") in ("embed_dec/W", "out/W") for k in ks)


def _from_chainer_packed(m):
    """Chainer packed matrix (4H, X), per-unit gate interleave (a,i,f,o)
    -> ours (X, 4H), contiguous blocks (i, f, g, o)."""
    H = m.shape[0] // 4
    r = m.reshape(H, 4, -1)  # (unit, chainer gate, in)
    blocks = [r[:, g, :] for g in _GATE_PERM]  # each (H, in)
    return np.concatenate(blocks, axis=0).T.astype(np.float32)


def _to_chainer_packed(w):
    """Inverse of :func:`_from_chainer_packed`: (X, 4H) -> (4H, X)."""
    X, H4 = w.shape
    H = H4 // 4
    blocks = w.T.reshape(4, H, X)  # our order (i, f, g, o)
    r = np.empty((H, 4, X), dtype=np.float32)
    for m, g in enumerate(_GATE_PERM):
        r[:, g, :] = blocks[m]
    return r.reshape(4 * H, X)


def _from_chainer_bias(b):
    H = b.shape[0] // 4
    r = b.reshape(H, 4)
    return np.concatenate([r[:, g] for g in _GATE_PERM]).astype(np.float32)


def _to_chainer_bias(b):
    H4 = b.shape[0]
    H = H4 // 4
    blocks = b.reshape(4, H)
    r = np.empty((H, 4), dtype=np.float32)
    for m, g in enumerate(_GATE_PERM):
        r[:, g] = blocks[m]
    return r.reshape(4 * H)


def _lstm(a, name):
    return {
        "wx": _from_chainer_packed(a[f"{name}/upward/W"]),
        "wh": _from_chainer_packed(a[f"{name}/lateral/W"]),
        "b": _from_chainer_bias(a[f"{name}/upward/b"]),
    }


def _linear(a, name):
    return {"w": a[f"{name}/W"].T.astype(np.float32),
            "b": a[f"{name}/b"].astype(np.float32)}


def _stack(trees):
    """Stack a list of identically-shaped param dicts on a new axis 0."""
    if len(trees) == 1:
        return trees[0]
    return {k: np.stack([t[k] for t in trees]) for k in trees[0]}


def chainer_to_ast(arrays):
    """Convert a Chainer-serialized model dict to ``init_model``'s
    (params, state) layout.  Returns ``{"params": ..., "state": ...}``
    (the ``load_checkpoint`` contract; no optimizer state — the
    reference never saves one, reference: nmt_run.py:755-761)."""
    a = {k.lstrip("/"): np.asarray(v) for k, v in arrays.items()}

    def count(pat):
        rx = re.compile(pat)
        hits = {int(m.group(1)) for k in a if (m := rx.match(k))}
        return max(hits) + 1 if hits else 0

    # --- conv front-end ---------------------------------------------------
    cnn_params, cnn_state = [], []
    for i in range(count(r"CNN_(\d+)/W$")):
        p = {"w": a[f"CNN_{i}/W"].astype(np.float32)}
        s = {}
        if f"CNN_{i}_bn/gamma" in a:
            p["bn_gamma"] = a[f"CNN_{i}_bn/gamma"].astype(np.float32)
            p["bn_beta"] = a[f"CNN_{i}_bn/beta"].astype(np.float32)
            s["bn_mean"] = a[f"CNN_{i}_bn/avg_mean"].astype(np.float32)
            s["bn_var"] = a[f"CNN_{i}_bn/avg_var"].astype(np.float32)
        else:
            p["b"] = a[f"CNN_{i}/b"].astype(np.float32)
        cnn_params.append(p)
        cnn_state.append(s)

    # --- encoder LSTMs (dir 0 = forward, dir 1 = reverse) ------------------
    n_enc = count(r"L(\d+)_enc/upward/W$")
    bi = "L0_rev_enc/upward/W" in a
    enc_layers = []
    for i in range(n_enc):
        dirs = [_lstm(a, f"L{i}_enc")]
        if bi:
            dirs.append(_lstm(a, f"L{i}_rev_enc"))
        enc_layers.append(_stack(dirs))

    # --- optional per-layer LayerNorm --------------------------------------
    has_ln = "L0_enc_ln/gamma" in a
    enc_ln, dec_ln = [], []
    if has_ln:
        for i in range(n_enc):
            g = [a[f"L{i}_enc_ln/gamma"]]
            b = [a[f"L{i}_enc_ln/beta"]]
            if bi:
                g.append(a[f"L{i}_rev_enc_ln/gamma"])
                b.append(a[f"L{i}_rev_enc_ln/beta"])
            # ALWAYS stacked: init_model allocates (n_dirs, H) even for
            # n_dirs=1 and the forward indexes ln['g'][:, None, :] — a
            # bare (H,) import would crash the first non-bi+ln forward
            enc_ln.append({"g": np.stack(g).astype(np.float32),
                           "b": np.stack(b).astype(np.float32)})

    # --- optional inter-layer projection (linear_proj) ----------------------
    proj_params, proj_state = [], []
    for i in range(count(r"enc_proj(\d+)/W$")):
        lin = _linear(a, f"enc_proj{i}")
        proj_params.append({
            "w": lin["w"], "b": lin["b"],
            "bn_gamma": a[f"enc_proj{i}_bn/gamma"].astype(np.float32),
            "bn_beta": a[f"enc_proj{i}_bn/beta"].astype(np.float32),
        })
        proj_state.append({
            "bn_mean": a[f"enc_proj{i}_bn/avg_mean"].astype(np.float32),
            "bn_var": a[f"enc_proj{i}_bn/avg_var"].astype(np.float32),
        })

    # --- attention ----------------------------------------------------------
    # heads are named attn_Wa, attn_Wa1, ..., attn_Wa{n-1}
    n_attn = count(r"attn_Wa(\d+)/W$") or 1
    wa = [_linear(a, "attn_Wa")]
    for i in range(1, n_attn):
        wa.append(_linear(a, f"attn_Wa{i}"))
    attn = {"wa": wa, "context": _linear(a, "context")}

    # --- decoder ------------------------------------------------------------
    dec_layers = [_lstm(a, f"L{i}_dec")
                  for i in range(count(r"L(\d+)_dec/upward/W$"))]
    out = _linear(a, "out")
    dec = {
        "embed": a["embed_dec/W"].astype(np.float32),
        "lstm": dec_layers,
        "out_w": out["w"],
        "out_b": out["b"],
    }
    if has_ln:
        for i in range(len(dec_layers)):
            if f"L{i}_dec_ln/gamma" not in a:
                # this model family ties enc+dec LN to one `ln` flag —
                # an encoder-only-LN checkpoint has no valid mapping
                raise ValueError(
                    "checkpoint has encoder LayerNorm but no "
                    f"L{i}_dec_ln — enc-only LN is not representable "
                    "in this model (rnn_config.ln covers both sides)")
            dec_ln.append({"g": a[f"L{i}_dec_ln/gamma"].astype(np.float32),
                           "b": a[f"L{i}_dec_ln/beta"].astype(np.float32)})

    params = {
        "cnn": cnn_params,
        "enc": {"lstm": enc_layers, "proj": proj_params},
        "attn": attn,
        "dec": dec,
    }
    if "embed_enc/W" in a:  # legacy text-encoder mode (enc_dec.py)
        params["enc"]["embed"] = a["embed_enc/W"].astype(np.float32)
    if has_ln:
        params["enc"]["ln"] = enc_ln
        params["dec"]["ln"] = dec_ln
    state = {"cnn_bn": cnn_state, "enc_proj_bn": proj_state}
    return {"params": params, "state": state}


def ast_to_chainer(params, state=None):
    """Inverse of :func:`chainer_to_ast`: flat Chainer-named array dict."""
    state = state or {}
    cnn_bn = state.get("cnn_bn") or [{} for _ in params["cnn"]]
    proj_bn = (state.get("enc_proj_bn")
               or [{} for _ in params["enc"]["proj"]])
    out = {}
    n = np.asarray

    for i, (p, s) in enumerate(zip(params["cnn"], cnn_bn)):
        out[f"CNN_{i}/W"] = n(p["w"])
        if "bn_gamma" in p:
            g = n(p["bn_gamma"])
            out[f"CNN_{i}_bn/gamma"] = g
            out[f"CNN_{i}_bn/beta"] = n(p["bn_beta"])
            # Chainer's fresh-BN defaults when running stats are absent
            out[f"CNN_{i}_bn/avg_mean"] = n(s.get("bn_mean",
                                                  np.zeros_like(g)))
            out[f"CNN_{i}_bn/avg_var"] = n(s.get("bn_var",
                                                 np.ones_like(g)))
            out[f"CNN_{i}_bn/N"] = np.asarray(0)
        else:
            out[f"CNN_{i}/b"] = n(p["b"])

    def put_lstm(name, p):
        out[f"{name}/upward/W"] = _to_chainer_packed(n(p["wx"]))
        out[f"{name}/upward/b"] = _to_chainer_bias(n(p["b"]))
        out[f"{name}/lateral/W"] = _to_chainer_packed(n(p["wh"]))

    def put_linear(name, w, b):
        out[f"{name}/W"] = n(w).T
        out[f"{name}/b"] = n(b)

    bi = np.ndim(params["enc"]["lstm"][0]["wx"]) == 3
    for i, p in enumerate(params["enc"]["lstm"]):
        if bi:
            put_lstm(f"L{i}_enc", {k: p[k][0] for k in p})
            put_lstm(f"L{i}_rev_enc", {k: p[k][1] for k in p})
        else:
            put_lstm(f"L{i}_enc", p)
    for i, ln in enumerate(params["enc"].get("ln", [])):
        if bi:
            out[f"L{i}_enc_ln/gamma"] = n(ln["g"])[0]
            out[f"L{i}_enc_ln/beta"] = n(ln["b"])[0]
            out[f"L{i}_rev_enc_ln/gamma"] = n(ln["g"])[1]
            out[f"L{i}_rev_enc_ln/beta"] = n(ln["b"])[1]
        else:
            # stored (1, H) (init_model's n_dirs axis); Chainer's
            # L.LayerNormalization serializes 1-D (H,)
            out[f"L{i}_enc_ln/gamma"] = n(ln["g"])[0]
            out[f"L{i}_enc_ln/beta"] = n(ln["b"])[0]
    for i, (p, s) in enumerate(zip(params["enc"]["proj"], proj_bn)):
        put_linear(f"enc_proj{i}", p["w"], p["b"])
        g = n(p["bn_gamma"])
        out[f"enc_proj{i}_bn/gamma"] = g
        out[f"enc_proj{i}_bn/beta"] = n(p["bn_beta"])
        out[f"enc_proj{i}_bn/avg_mean"] = n(s.get("bn_mean",
                                                  np.zeros_like(g)))
        out[f"enc_proj{i}_bn/avg_var"] = n(s.get("bn_var",
                                                 np.ones_like(g)))
        out[f"enc_proj{i}_bn/N"] = np.asarray(0)
    if "embed" in params["enc"]:
        out["embed_enc/W"] = n(params["enc"]["embed"])

    for i, wa in enumerate(params["attn"]["wa"]):
        put_linear("attn_Wa" if i == 0 else f"attn_Wa{i}",
                   wa["w"], wa["b"])
    put_linear("context", params["attn"]["context"]["w"],
               params["attn"]["context"]["b"])

    dec = params["dec"]
    out["embed_dec/W"] = n(dec["embed"])
    for i, p in enumerate(dec["lstm"]):
        put_lstm(f"L{i}_dec", p)
    for i, ln in enumerate(dec.get("ln", [])):
        out[f"L{i}_dec_ln/gamma"] = n(ln["g"])
        out[f"L{i}_dec_ln/beta"] = n(ln["b"])
    put_linear("out", dec["out_w"], dec["out_b"])
    return out
