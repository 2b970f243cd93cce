"""The optimizer chain of ``ast_tpu/train/optimizer.py``, in PyTorch.

L2 weight decay added to the gradient -> global-norm clipping ->
AMSGrad (optax's ``scale_by_amsgrad(0.9, 0.999, eps=1e-8)``) or nothing
(SGD) -> ``-lr * lr_scale``.  optax's AMSGrad keeps the running maximum
of the *bias-corrected* second moment, which ``torch.optim.Adam(amsgrad=
True)`` does not, so the chain is written out on lists of tensors here
(torch's multi-tensor ``_foreach`` ops, a few launches for all leaves;
the Adam step is plain XLA in JAX too).

``freeze`` follows ``optax.masked``: frozen leaves skip the whole chain
(out of the global norm and the L2 term) and get zero updates.  The
state mirrors optax's pytree as ``ast_tpu.train.checkpoint`` flattens
it, so the flat-NPZ keys are the same in both packages: one list per
chain link (``[]`` for the stateless ones, ``[count, mu, nu, nu_max]``
for AMSGrad), wrapped as ``[[chain]]`` under a freeze, where frozen
leaves of the moment trees are ``[]``.
"""

import torch

from ast_tpu_torch.config import OPT_ADAM
from ast_tpu_torch.params import tree_map

B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_leaves(tree):
    """Tensor leaves of a nested dict/list tree, in insertion order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def freeze_mask(params, freeze_list):
    """Tree of bools, True = trainable (``ast_tpu``'s ``freeze_mask``):
    names address top-level groups ("cnn", "enc", "attn", "dec") or
    dotted subpaths ("dec.embed")."""
    prefixes = [tuple(name.split(".")) for name in freeze_list]

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [build(v, path + (str(i),)) for i, v in enumerate(tree)]
        return not any(path[:len(p)] == p for p in prefixes)

    return build(params)


class Optimizer:
    """``update(grads, state, params) -> (updates, new_state)``, as an
    optax ``GradientTransformation``; the caller adds the updates."""

    def __init__(self, opt_cfg, params):
        if opt_cfg.get("grad_noise_eta", 0) > 0 or opt_cfg.get(
                "moments_dtype"):
            raise NotImplementedError(
                "gradient noise and bf16 moments are not ported (ROADMAP.md "
                "queue 1, 'training options not ported')")
        self.l2 = opt_cfg.get("l2", 0)
        self.clip = opt_cfg.get("grad_clip", 0)
        self.adam = opt_cfg.get("type", OPT_ADAM) == OPT_ADAM
        self.lr = opt_cfg["lr"] * opt_cfg.get("lr_scale", 1)
        self.frozen = bool(opt_cfg.get("freeze", []))
        self.mask = freeze_mask(params, opt_cfg.get("freeze", []))
        self.trainable = tree_leaves(self.mask)

    def _moments_like(self, params):
        """Zero moments of the trainable leaves, ``[]`` for frozen ones."""
        return tree_unflatten(params, [
            torch.zeros_like(p) if m else []
            for p, m in zip(tree_leaves(params), self.trainable)])

    def init(self, params):
        chain = [[]] * ((self.l2 > 0) + (self.clip > 0))
        if self.adam:
            count = torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)
            chain.append([count] + [self._moments_like(params)
                                    for _ in range(3)])
        chain.append([])
        return [[chain]] if self.frozen else chain

    def update(self, grads, state, params):
        chain = state[0][0] if self.frozen else state
        on = self.trainable
        g = [x for x, m in zip(tree_leaves(grads), on) if m]
        p = [x for x, m in zip(tree_leaves(params), on) if m]
        if self.l2 > 0:
            g = torch._foreach_add(g, torch._foreach_mul(p, self.l2))
        if self.clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(g)))
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
            g = torch._foreach_mul(g, scale)
        new_chain = [[] for _ in chain]
        if self.adam:
            count, mu, nu, nu_max = chain[-2]
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1),
                                    torch._foreach_mul(tree_leaves(mu), B1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2),
                torch._foreach_mul(tree_leaves(nu), B2))
            count = count + 1
            n = count.to(torch.float32)
            bc1 = 1 - torch.pow(torch.full_like(n, B1), n)
            bc2 = 1 - torch.pow(torch.full_like(n, B2), n)
            nu_max = torch._foreach_maximum(tree_leaves(nu_max),
                                            torch._foreach_div(nu, bc2))
            g = torch._foreach_div(
                torch._foreach_div(mu, bc1),
                torch._foreach_add(torch._foreach_sqrt(nu_max), EPS))
            like = chain[-2][1]
            new_chain[-2] = [count] + [tree_unflatten(like, t)
                                       for t in (mu, nu, nu_max)]
        it = iter(torch._foreach_mul(g, -self.lr))
        updates = tree_unflatten(grads, [
            next(it) if m else torch.zeros_like(x)
            for x, m in zip(tree_leaves(grads), on)])
        return updates, ([[new_chain]] if self.frozen else new_chain)


def build_optimizer(opt_cfg, params):
    """Returns (optimizer, initial state), as ``ast_tpu``'s."""
    opt = Optimizer(opt_cfg, params)
    return opt, opt.init(params)
