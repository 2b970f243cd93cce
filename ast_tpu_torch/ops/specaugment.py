"""SpecAugment: time and frequency masking of a training batch.

The counterpart of ``ast_tpu/ops/specaugment.py`` (Park et al. 2019).
Config (``train_cfg["data"]["spec_augment"]``), all fields optional::

    {"freq_masks": 2, "freq_width": 6,
     "time_masks": 2, "time_width": 40, "time_p": 0.0}

Each frequency mask zeroes a band of width ~ U{0..freq_width} channels;
each time mask zeroes a span of width ~ U{0..time_width} frames placed
within the row's real (unpadded) frame count; ``time_p`` > 0 also caps a
time mask at ``floor(time_p * length)``.  Masked cells become 0.0.
A feature row of P planes (the conv front-end's ``in_channels``:
static, delta and delta-delta side by side) takes its frequency masks
over the ``D / P`` bins of a plane, and each mask zeroes the same bins
of every plane.

Drawing is apart from applying: :func:`draw_spec_masks` makes each
mask's per-row start and width from a host generator, and
:func:`apply_spec_masks` zeroes the cells, so a test can apply the
starts and widths that ``ast_tpu`` drew.  Plain PyTorch: elementwise
compares on the (B, T, D) block, no kernel on the TPU either.
"""

import dataclasses
from typing import List, Tuple

import torch


@dataclasses.dataclass
class SpecMasks:
    """Per mask a ``(start, width)`` pair of (B, 1) int64 tensors: the
    zeroed cells of row r are ``start[r] <= i < start[r] + width[r]``
    along the feature axis (``freq``; of each of the row's ``planes``
    planes) or the time axis (``time``)."""
    freq: List[Tuple[torch.Tensor, torch.Tensor]]
    time: List[Tuple[torch.Tensor, torch.Tensor]]
    planes: int = 1


def frame_lengths(X):
    """Per-row real frame count inferred from the data: the last frame
    with any nonzero coefficient, + 1.  For callers that only have the
    padded block; the trainer passes the loader's true counts."""
    valid = (X != 0).any(dim=-1)                          # (B, T)
    T = X.shape[1]
    last = T - valid.flip(1).int().argmax(dim=1)
    return torch.where(valid.any(dim=1), last, 0).to(torch.int32)


def _draw_axis(gen, B, max_width, span, width_cap=None):
    """One mask's (start, width), (B, 1) int64 each: width ~
    U{0..max_width} clipped to ``width_cap`` and ``span`` ((B, 1) or an
    int), start = floor(u * (span - width + 1)) with u ~ U[0, 1) in
    float32."""
    span = torch.as_tensor(span).long().reshape(-1, 1).expand(B, 1)
    w = torch.randint(0, max_width + 1, (B, 1), generator=gen)
    if width_cap is not None:
        w = torch.minimum(w, width_cap)
    w = torch.minimum(w, span)
    u = torch.rand((B, 1), generator=gen)
    start = torch.floor(u * (span - w + 1).float()).long()
    return start, w


def draw_spec_masks(gen, shape, cfg, lengths=None, X=None, planes=1):
    """Starts and widths of every mask for a (B, T, D) batch of
    ``shape`` from the host generator ``gen``.  ``lengths``: the rows'
    true frame counts, (B,) ints; without them they are inferred from
    ``X`` (:func:`frame_lengths`).  ``planes``: the frequency masks lie
    in the ``D / planes`` bins of a plane."""
    B, T, D = shape
    D //= planes
    n_f, f_w = int(cfg.get("freq_masks", 2)), int(cfg.get("freq_width", 6))
    n_t, t_w = int(cfg.get("time_masks", 2)), int(cfg.get("time_width", 40))
    t_p = float(cfg.get("time_p", 0.0))
    freq = [_draw_axis(gen, B, f_w, D) for _ in range(n_f) if f_w > 0]
    time = []
    if n_t > 0 and t_w > 0:
        if lengths is None:
            lengths = frame_lengths(X).cpu()
        lengths = torch.as_tensor(lengths).long().reshape(B, 1)
        cap = (t_p * lengths.float()).long() if t_p > 0 else None
        time = [_draw_axis(gen, B, t_w, lengths, cap) for _ in range(n_t)]
    return SpecMasks(freq, time, planes)


def _keep(masks, B, size, device):
    keep = torch.ones((B, size), dtype=torch.bool, device=device)
    i = torch.arange(size, device=device)[None, :]
    for start, w in masks:
        start, w = start.to(device), w.to(device)
        keep &= ~((i >= start) & (i < start + w))
    return keep


def apply_spec_masks(X, masks):
    """X (B, T, D) with the cells of ``masks`` (:class:`SpecMasks`)
    zeroed."""
    B, T, D = X.shape
    freq = _keep(masks.freq, B, D // masks.planes, X.device)
    keep = (_keep(masks.time, B, T, X.device)[:, :, None]
            & freq.repeat(1, masks.planes)[:, None, :])
    return X * keep.to(X.dtype)


def spec_augment(gen, X, cfg, lengths=None):
    """Draw and apply in one call (``ast_tpu``'s ``spec_augment``)."""
    return apply_spec_masks(X, draw_spec_masks(gen, X.shape, cfg, lengths,
                                               X))
