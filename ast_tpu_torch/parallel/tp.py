"""Vocab tensor parallelism: the collectives that XLA inserts in
``ast_tpu`` for the ``model`` axis, as ``torch.distributed`` calls
inside autograd functions.

Under a model axis of M ranks each rank of a model group holds 1/M of
the vocabulary of ``dec/out_w`` (columns), ``dec/out_b`` and
``dec/embed`` (rows) (``parallel.mesh.leaf_spec``), and the same batch
rows as the others.  The kernels take the whole weights
(:func:`gathered_params`: ``ast_tpu`` runs them under ``shard_map`` with
the weights ``P()``, so XLA gathers the shards); the loss logits stay
sharded (:func:`vocab_parallel_loss`: a logits GEMM over the rank's
columns and a cross-entropy whose max, sum of exponentials and target
logit are all-reduced over the model group, Megatron-LM's
``_VocabParallelCrossEntropy``).  Every rank of a model group ends a
step with the whole loss and the same gradient of every replicated
leaf; a vocab shard's gradient is its slice of the whole one.  With no
model axis nothing here is called: the loss is
``seq2seq.sequence_loss``, the one-process code.
"""

import torch
import torch.distributed as dist

from ast_tpu_torch.ops.bf16 import BF16, rounded
from ast_tpu_torch.parallel.mesh import (
    _map_with_path, all_gather_axis, leaf_spec)
from ast_tpu_torch.symbols import SYMBOLS


class _GatherVocab(torch.autograd.Function):
    """Forward: the model group's shards concatenated along ``axis``.
    Backward: this rank's slice of the whole gradient, not summed --
    every rank of the group computed the same whole gradient from the
    same rows (``torch.distributed.nn.functional.all_gather``'s
    backward would reduce-scatter it, M times the gradient)."""

    @staticmethod
    def forward(ctx, shard, axis, mesh):
        ctx.axis, ctx.mesh, ctx.n = axis, mesh, shard.shape[axis]
        return all_gather_axis(shard, axis, mesh.model_group, mesh.model)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.axis, ctx.mesh.model_index * ctx.n,
                         ctx.n).contiguous(), None, None)


def gathered_params(params, mesh):
    """``params`` with each vocab-laid leaf (``leaf_spec``) gathered
    whole, differentiably (:class:`_GatherVocab`), a new tree sharing
    every other leaf; ``params`` itself without a model axis."""
    if mesh is None or mesh.model == 1:
        return params

    def whole(path, t):
        spec = leaf_spec(path)
        if "model" not in spec:
            return t
        return _GatherVocab.apply(t, spec.index("model"), mesh)
    return _map_with_path(whole, params)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group: each rank's logits read only its columns, so each holds a
    part of the gradient that reaches the GEMM's left operand."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_reduce(t, op, group):
    """``t`` reduced over ``group`` in place (None: one shard, as is)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


class VocabParallelCrossEntropy(torch.autograd.Function):
    """``seq2seq.logits_loss`` over a vocab shard of the logits.

    ``apply(logits, target, n_real, label_smoothing, vocab_start, vocab,
    group)``: ``logits`` (U, B, V/M) f32, this rank's columns
    ``[vocab_start, vocab_start + V/M)`` of the whole ``vocab`` V;
    ``target`` (U, B) ids of the whole vocabulary, already corrupted;
    ``group`` the model group (None: one shard holding every column).
    Forward: the max over the group (all-reduce MAX, no gradient), then
    one all-reduce SUM of the sum of exponentials, the target's shifted
    logit from its owner and, with label smoothing, the sum of the
    shifted logits; the PAD-masked mean of the whole loss over
    ``n_real``, the same on every rank.  Backward: ``w (p - (1 - eps)
    onehot - eps / V)`` on this rank's columns, no collective -- each
    rank holds the whole loss, so its gradient is already whole."""

    @staticmethod
    def forward(ctx, logits, target, n_real, label_smoothing, vocab_start,
                vocab, group):
        Vm = logits.shape[-1]
        top = _all_reduce(logits.detach().amax(dim=-1), dist.ReduceOp.MAX,
                          group)
        shifted = logits - top[..., None]
        local = target.long() - vocab_start
        own = (local >= 0) & (local < Vm)
        picked = shifted.gather(-1, local.clamp(0, Vm - 1)[..., None])[..., 0]
        sums = [shifted.exp().sum(dim=-1), torch.where(own, picked, 0.0)]
        if label_smoothing > 0:
            sums.append(shifted.sum(dim=-1))
        sums = _all_reduce(torch.stack(sums), dist.ReduceOp.SUM, group)
        lse = sums[0].log()
        nll = lse - sums[1]
        if label_smoothing > 0:
            # -mean over V of log p = lse - mean of the shifted logits
            nll = ((1.0 - label_smoothing) * nll
                   + label_smoothing * (lse - sums[2] / vocab))
        weight = (target != SYMBOLS.PAD_ID).to(logits.dtype)
        ctx.save_for_backward(shifted, lse, local, own, weight)
        ctx.hyper = (n_real, label_smoothing, vocab)
        return (nll * weight).sum() / n_real

    @staticmethod
    def backward(ctx, g):
        shifted, lse, local, own, weight = ctx.saved_tensors
        n_real, eps, vocab = ctx.hyper
        coef = (g * weight / n_real)[..., None]
        d = torch.exp(shifted - lse[..., None])
        if eps > 0:
            d = d - eps / vocab
        hot = torch.zeros_like(d).scatter_(
            -1, local.clamp(0, d.shape[-1] - 1)[..., None],
            (1.0 - eps) * own[..., None].to(d.dtype))
        return (d - hot) * coef, None, None, None, None, None, None


def vocab_parallel_loss(ht, out_w, out_b, target, n_real, mesh,
                        label_smoothing=0.0, replace=None, rand_ids=None,
                        compute_dtype=torch.float32):
    """``seq2seq.sequence_loss`` with ``out_w`` (A, V/M) and ``out_b``
    this rank's vocab shards: the logits of its columns, ``ht @ out_w +
    out_b`` (``ht`` and ``out_w`` rounded to bf16 first at bf16, their
    gradients too), with ``ht``'s gradient summed over the model group
    before its rounding (XLA sums the partial products in f32, then
    casts), then :class:`VocabParallelCrossEntropy`.  The target
    corruption (``replace`` / ``rand_ids``, drawn over the whole
    vocabulary) is the same on every rank."""
    vocab = out_w.shape[1] * mesh.model
    if replace is not None:
        target = torch.where(replace & (target >= SYMBOLS.N_SPECIAL),
                             rand_ids.to(target.dtype), target)
    if compute_dtype == BF16:
        ht, out_w = rounded(ht), rounded(out_w)
    ht = _CopyToModel.apply(ht, mesh.model_group)
    logits = torch.matmul(ht, out_w) + out_b
    return VocabParallelCrossEntropy.apply(
        logits, target, n_real, label_smoothing,
        mesh.model_index * out_w.shape[1], vocab, mesh.model_group)
