"""Kaldi nnet2 bottleneck-feature (BNF) forward pass in PyTorch: the
port's copy of ``ast_tpu/ops/bnf.py``.

The reference's zero-resource feature variant (reference:
fisher/kaldi/create_bnfs.sh:46-53 runs
``steps/nnet2/dump_bottleneck_features.sh`` -> ``nnet-compute final.raw``
over MFCC+CMVN features and stores 42-dim bottleneck features).  Instead
of shelling out to Kaldi C++ binaries, this module parses a *text-format*
nnet2 raw net (``nnet-am-copy --binary=false`` / ``nnet-copy`` output)
with NumPy and runs it as a chain of float32 ``torch.matmul``s and
activations on the device of its input (``ast_tpu`` leaves these to XLA,
outside any Pallas kernel); :func:`net_to` moves the parameters to that
device once.

Supported components (the set used by published nnet2 bottleneck
recipes): Splice, FixedAffine, Affine (incl. the *Preconditioned*
/*Online* training variants, which are plain affines at inference),
Pnorm, Normalize, Sigmoid, Tanh, RectifiedLinear, FixedScale, FixedBias.
Unknown scalar/vector/matrix fields inside a component (e.g. the
NonlinearComponent value/deriv statistics) are skipped, matching
``nnet-compute``'s inference-only use of the model.

Feature-type front-ends of ``dump_bottleneck_features.sh`` are provided
too: ``add_deltas`` (feat_type=delta; Kaldi defaults order 2, window 2)
and ``splice_frames``+``apply_transform`` (feat_type=lda with final.mat).
"""

import numpy as np
import torch


# ---------------------------------------------------------------------------
# text-format parser
# ---------------------------------------------------------------------------

_COMPONENT_ALIASES = {
    "AffineComponentPreconditioned": "AffineComponent",
    "AffineComponentPreconditionedOnline": "AffineComponent",
    "FixedAffineComponent": "FixedAffineComponent",
}

_ACTIVATIONS = {
    "SigmoidComponent", "TanhComponent", "RectifiedLinearComponent",
    "NormalizeComponent", "PnormComponent", "SoftmaxComponent",
}


class _Tokens:
    def __init__(self, text):
        self.toks = text.split()
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of nnet2 model text")
        self.i += 1
        return t

    def expect(self, tok):
        t = self.next()
        if t != tok:
            raise ValueError(f"expected {tok!r}, got {t!r}")

    def read_vector(self):
        self.expect("[")
        out = []
        while True:
            t = self.next()
            if t == "]":
                return np.asarray(out, np.float32)
            out.append(float(t))

    def read_flat_until_bracket(self):
        """Matrix body as a flat list (rows are recovered from the
        component's output dim, so newline row boundaries are not
        needed)."""
        self.expect("[")
        out = []
        while True:
            t = self.next()
            if t == "]":
                return np.asarray(out, np.float32)
            out.append(float(t))

    def skip_value(self):
        """Skip one unknown field value: a bracketed block or a scalar."""
        if self.peek() == "[":
            self.next()
            depth = 1
            while depth:
                t = self.next()
                if t == "[":
                    depth += 1
                elif t == "]":
                    depth -= 1
        else:
            self.next()


def _parse_component(toks, name):
    end_tag = f"</{name}>"
    fields = {}
    flats = {}
    while True:
        t = toks.next()
        if t == end_tag:
            break
        if not (t.startswith("<") and t.endswith(">")):
            continue
        key = t[1:-1]
        if key in ("LinearParams", "Params"):
            flats["linear"] = toks.read_flat_until_bracket()
        elif key == "BiasParams":
            fields["bias"] = toks.read_vector()
        elif key == "Context":
            fields["context"] = [
                int(v) for v in toks.read_vector().tolist()]
        elif key in ("InputDim", "OutputDim", "Dim", "ConstComponentDim"):
            fields[key] = int(toks.next())
        elif key == "P":
            fields["P"] = float(toks.next())
        elif key in ("Scales", "Bias"):
            fields[key.lower()] = toks.read_vector()
        else:
            toks.skip_value()

    comp = {"type": _COMPONENT_ALIASES.get(name, name)}
    comp.update(fields)
    if "linear" in flats:
        flat = flats["linear"]
        if "bias" in fields:
            rows = len(fields["bias"])
        elif "OutputDim" in fields:
            rows = fields["OutputDim"]
        else:
            raise ValueError(f"{name}: cannot infer matrix shape")
        comp["linear"] = flat.reshape(rows, -1)
    return comp


def parse_nnet2_text(text):
    """Parse a text-format nnet2 raw net into a component list."""
    toks = _Tokens(text)
    toks.expect("<Nnet>")
    comps = []
    while True:
        t = toks.next()
        if t == "</Nnet>":
            break
        if t in ("<NumComponents>",):
            toks.next()
            continue
        if t in ("<Components>", "</Components>"):
            continue
        if (t.startswith("<") and t.endswith(">")
                and "Component" in t and not t.startswith("</")):
            comps.append(_parse_component(toks, t[1:-1]))
        # anything else at top level (priors etc.) is skipped
    return comps


def load_nnet2(path):
    with open(path, "r", encoding="utf-8") as f:
        return parse_nnet2_text(f.read())


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------

def to_device(x, device):
    """(T, D) features or a parameter array (NumPy or tensor) as float32
    on ``device``."""
    if torch.is_tensor(x):
        return x.to(device, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _as_tensor(x):
    """``x`` as float32 on its own device (the CPU for NumPy input)."""
    return to_device(x, x.device if torch.is_tensor(x) else "cpu")


def net_to(components, device):
    """The parsed net with its parameter arrays as float32 tensors on
    ``device``: moved once, then run over many utterances."""
    return [{k: to_device(v, device) if isinstance(v, np.ndarray) else v
             for k, v in c.items()} for c in components]


def _clamped(T, offset, device):
    return torch.clamp(torch.arange(T, device=device) + offset, 0, T - 1)


def _splice(x, context, const_dim=0):
    """Frame splicing with edge clamping (nnet-compute --pad-input=true
    duplicates the first/last frame to cover the context)."""
    T = x.shape[0]
    main = x[:, : x.shape[1] - const_dim] if const_dim else x
    parts = [main[_clamped(T, c, x.device)] for c in context]
    if const_dim:
        parts.append(x[:, x.shape[1] - const_dim:])
    return torch.cat(parts, dim=1)


def nnet2_forward(components, feats):
    """Run a parsed nnet2 net over (T, D) features -> (T, D_out), a
    float32 tensor on the features' device (a NumPy input runs on the
    CPU)."""
    h = _as_tensor(feats)
    dev = h.device
    for c in components:
        t = c["type"]
        if t == "SpliceComponent":
            h = _splice(h, c["context"], c.get("ConstComponentDim", 0))
        elif t in ("AffineComponent", "FixedAffineComponent"):
            h = h @ to_device(c["linear"], dev).T
            if "bias" in c:
                h = h + to_device(c["bias"], dev)
        elif t == "PnormComponent":
            in_dim, out_dim = c["InputDim"], c["OutputDim"]
            p = c.get("P", 2.0)
            g = h.reshape(h.shape[0], out_dim, in_dim // out_dim)
            if p == 2.0:
                h = torch.sqrt(torch.sum(g * g, dim=-1))
            else:
                h = torch.sum(torch.abs(g) ** p, dim=-1) ** (1.0 / p)
        elif t == "NormalizeComponent":
            # scale rows to unit RMS (Kaldi: 1/sqrt(sum x^2 / D))
            ms = torch.mean(h * h, dim=-1, keepdim=True)
            h = h * torch.where(ms > 0, 1.0 / torch.sqrt(ms),
                                torch.zeros_like(ms))
        elif t == "SigmoidComponent":
            h = 1.0 / (1.0 + torch.exp(-h))
        elif t == "TanhComponent":
            h = torch.tanh(h)
        elif t == "RectifiedLinearComponent":
            h = torch.clamp(h, min=0.0)
        elif t == "SoftmaxComponent":
            h = torch.exp(h - torch.amax(h, dim=-1, keepdim=True))
            h = h / torch.sum(h, dim=-1, keepdim=True)
        elif t == "FixedScaleComponent":
            h = h * to_device(c["scales"], dev)
        elif t == "FixedBiasComponent":
            h = h + to_device(c["bias"], dev)
        else:
            raise ValueError(f"unsupported nnet2 component: {t}")
    return h


# ---------------------------------------------------------------------------
# feature-type front ends (dump_bottleneck_features.sh)
# ---------------------------------------------------------------------------

def add_deltas(feats, order=2, window=2):
    """Kaldi add-deltas (defaults order 2, window 2): each delta order is
    the least-squares slope over +-window frames with edge clamping;
    output is [x, d1, ..., d_order] concatenated."""
    x = _as_tensor(feats)
    T = x.shape[0]
    denom = sum(k * k for k in range(1, window + 1)) * 2.0
    outs = [x]
    cur = x
    for _ in range(order):
        acc = torch.zeros_like(cur)
        for k in range(1, window + 1):
            fwd = cur[_clamped(T, k, x.device)]
            bwd = cur[_clamped(T, -k, x.device)]
            acc = acc + k * (fwd - bwd)
        cur = acc / denom
        outs.append(cur)
    return torch.cat(outs, dim=1)


def splice_frames(feats, left=4, right=4):
    """splice-feats: concat frames t-left..t+right, edge-clamped."""
    return _splice(_as_tensor(feats), list(range(-left, right + 1)))


def apply_transform(feats, mat):
    """transform-feats: linear (out, in) or affine (out, in+1) matrix
    (trailing column is the offset), e.g. an LDA final.mat."""
    x = _as_tensor(feats)
    mat = to_device(mat, x.device)
    if mat.shape[1] == x.shape[1] + 1:
        return x @ mat[:, :-1].T + mat[:, -1]
    return x @ mat.T
