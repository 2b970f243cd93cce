"""The optimizer chain of ``ast_tpu/train/optimizer.py``, in PyTorch.

L2 weight decay added to the gradient -> global-norm clipping ->
annealed gradient noise (``grad_noise_eta``) -> AMSGrad (optax's ``scale_by_amsgrad(0.9, 0.999, eps=1e-8)``) or nothing
(SGD) -> ``-lr * lr_scale``.  optax's AMSGrad keeps the running maximum
of the *bias-corrected* second moment, which ``torch.optim.Adam(amsgrad=
True)`` does not, so the chain is written out on lists of tensors here
(torch's multi-tensor ``_foreach`` ops, a few launches for all leaves;
the Adam step is plain XLA in JAX too).

``freeze`` follows ``optax.masked``: frozen leaves skip the whole chain
(out of the global norm and the L2 term) and get zero updates.  The
state mirrors optax's pytree as ``ast_tpu.train.checkpoint`` flattens
it, so the flat-NPZ keys are the same in both packages: one entry per
chain link (``[]`` for the stateless ones, ``{"count", "key"}`` for the
gradient noise, ``[count, mu, nu, nu_max]`` for AMSGrad), wrapped as
``[[chain]]`` under a freeze, where frozen leaves of the moment trees
are ``[]``.

Gradient noise is N(0, eta / (1 + t)^0.55) with t the link's ``count``.
Its schedule and its state's layout are ``ast_tpu``'s; the noise itself
is not: ``key`` (JAX's threefry key of the run's seed, uint32 (2,)) is
carried as initialised or loaded, and each step draws from a torch
generator seeded from the run's seed and ``count``, so a resumed run
draws what an uninterrupted one would.  The optimizer keeps ``count`` on
the host beside the tensor (no device sync a step): ``init`` starts it at
0, and :meth:`Optimizer.reset` reads it from a state that was loaded or
replaced.

:meth:`Optimizer.apply_` is the training step's call: the update added
to the parameters, the parameters and the state written in place.  On
CUDA tensors it is one hand-written pass in two launches
(``ops/fused_optimizer.py``, ``kernels/csrc/opt_amsgrad.cu``), equal to
the chain element for element given the same global norm; on CPU
tensors it is :meth:`Optimizer.update` and an in-place add, the plain
version.

Under a model axis (``parallel.mesh``: ``dec/out_w``, ``dec/out_b`` and
``dec/embed`` and their moments hold this rank's vocab shard) the chain
is the one-process chain of the whole leaves: the global norm adds the
shards' squared norms over the model group to the replicated leaves'
(counted once), and the gradient noise draws the one-process stream
over the whole leaves and keeps this rank's slices.  L2 and AMSGrad are
elementwise and shard with their leaves.

``moments_dtype: "bfloat16"`` keeps AMSGrad's first moment in bfloat16
as optax's ``mu_dtype`` does: the stored ``mu`` decays in bfloat16
(``b1`` rounded to it), the new gradient is added in float32, the
update is made from that float32 value, and only then is ``mu`` rounded
for storage.  ``nu`` and ``nu_max`` stay float32.
"""

import numpy as np
import torch
import torch.distributed as dist

from ast_tpu_torch.config import OPT_ADAM
from ast_tpu_torch.ops.fused_optimizer import AmsgradKernel, chain_consts
from ast_tpu_torch.parallel.mesh import spec_leaves
from ast_tpu_torch.params import tree_map
from ast_tpu_torch.utils.seeding import stable_seed

B1, B2, EPS = 0.9, 0.999, 1e-8
NOISE_GAMMA = 0.55


def noise_sigma(eta, t):
    """Standard deviation of the gradient noise at step ``t``."""
    return float(np.sqrt(eta / (1.0 + t) ** NOISE_GAMMA))


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
    optax ``GradientTransformation``, the caller adding the updates; or
    ``apply_(grads, state, params)``, in place."""

    def __init__(self, opt_cfg, params, seed=0, mesh=None):
        mu_dtype = opt_cfg.get("moments_dtype") or "float32"
        if mu_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"optimizer.moments_dtype={mu_dtype!r}: "
                             "float32 | bfloat16")
        self.mu_dtype = getattr(torch, mu_dtype)
        self.noise_eta = opt_cfg.get("grad_noise_eta", 0)
        self.seed = seed
        # the noise link's step, kept on the host (no device sync a step)
        self._noise_step = 0
        self.l2 = opt_cfg.get("l2", 0)
        self.clip = opt_cfg.get("grad_clip", 0)
        # the noise link's place in the chain
        self._noise_at = (self.l2 > 0) + (self.clip > 0)
        self.adam = opt_cfg.get("type", OPT_ADAM) == OPT_ADAM
        self.lr = opt_cfg["lr"] * opt_cfg.get("lr_scale", 1)
        self.frozen = bool(opt_cfg.get("freeze", []))
        self.mask = freeze_mask(params, opt_cfg.get("freeze", []))
        self.trainable = tree_leaves(self.mask)
        # the layout of each trainable leaf (parallel.mesh.leaf_spec; all
        # replicated without a model axis)
        self.mesh = mesh
        self.specs = [spec for spec, m in zip(spec_leaves(params, mesh),
                                              self.trainable) if m]
        self.sharded = any("model" in spec for spec in self.specs)
        # apply_'s kernel and the state links its table was built over
        self._kernel, self._kernel_links = None, None

    def _moments_like(self, params, dtype=torch.float32):
        """Zero moments of the trainable leaves, ``[]`` for frozen ones."""
        return tree_unflatten(params, [
            torch.zeros_like(p, dtype=dtype) if m else []
            for p, m in zip(tree_leaves(params), self.trainable)])

    def init(self, params):
        device = tree_leaves(params)[0].device
        self._noise_step = 0
        chain = [[]] * ((self.l2 > 0) + (self.clip > 0))
        if self.noise_eta > 0:
            key = np.array([self.seed >> 32, self.seed & 0xFFFFFFFF],
                           np.uint32)
            chain.append({"count": torch.zeros((), dtype=torch.int32,
                                               device=device),
                          "key": torch.from_numpy(key).to(device)})
        if self.adam:
            count = torch.zeros((), dtype=torch.int32, device=device)
            chain.append([count, self._moments_like(params, self.mu_dtype)]
                         + [self._moments_like(params) for _ in range(2)])
        chain.append([])
        return [[chain]] if self.frozen else chain

    def reset(self, state):
        """Take up ``state`` (loaded, or replaced by another's bytes) as
        this optimizer's: the noise link's step is read from its
        ``count`` (one device sync)."""
        if self.noise_eta > 0:
            chain = state[0][0] if self.frozen else state
            self._noise_step = int(chain[self._noise_at]["count"])

    def _noise(self, g):
        """This step's gradient noise (leaves shaped as ``g``) and its
        sigma; advances the link's step."""
        sigma = noise_sigma(self.noise_eta, self._noise_step)
        gen = torch.Generator(device=g[0].device).manual_seed(stable_seed(
            f"{self.seed}|grad_noise|{self._noise_step}"))
        # the whole leaves' stream; a vocab shard keeps its slice of its
        # leaf's
        shapes = [self.mesh.full_shape(x.shape, spec) if self.sharded
                  else x.shape for x, spec in zip(g, self.specs)]
        sizes = [int(np.prod(s)) for s in shapes]
        noise = torch.randn(sum(sizes), generator=gen, device=g[0].device)
        noise = [n.view(shape) for n, shape in zip(noise.split(sizes),
                                                   shapes)]
        if self.sharded:
            noise = [self.mesh.shard(n, spec)
                     for n, spec in zip(noise, self.specs)]
        self._noise_step += 1
        return noise, sigma

    def _add_noise(self, g, link):
        """``g`` plus this step's noise, and the link's new state."""
        noise, sigma = self._noise(g)
        return (torch._foreach_add(g, noise, alpha=sigma),
                {"count": link["count"] + 1, "key": link["key"]})

    def _global_norm(self, g):
        """The norm of the whole gradient: under a model axis the shards'
        squared norms summed over the model group, plus the replicated
        leaves' (the same on every rank of the group)."""
        norms = torch._foreach_norm(g)
        if not self.sharded:
            return torch.linalg.vector_norm(torch.stack(norms))
        sq = {True: [norms[0].new_zeros(())], False: [norms[0].new_zeros(())]}
        for n, spec in zip(norms, self.specs):
            sq["model" in spec].append(n * n)
        return self._sharded_norm(torch.stack(sq[False]).sum(),
                                  torch.stack(sq[True]).sum())

    def _sharded_norm(self, replicated, shards):
        """The global norm from the replicated leaves' squares and this
        rank's vocab shards' squares, those summed over the model
        group."""
        dist.all_reduce(shards, group=self.mesh.model_group)
        return torch.sqrt(replicated + shards)

    def update(self, grads, state, params):
        chain = state[0][0] if self.frozen else state
        on = self.trainable
        g = [x for x, m in zip(tree_leaves(grads), on) if m]
        p = [x for x, m in zip(tree_leaves(params), on) if m]
        if self.l2 > 0:
            g = torch._foreach_add(g, torch._foreach_mul(p, self.l2))
        if self.clip > 0:
            norm = self._global_norm(g)
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
            g = torch._foreach_mul(g, scale)
        new_chain = [[] for _ in chain]
        if self.noise_eta > 0:
            at = (self.l2 > 0) + (self.clip > 0)
            g, new_chain[at] = self._add_noise(g, chain[at])
        if self.adam:
            count, mu, nu, nu_max = chain[-2]
            old = tree_leaves(mu)
            if self.mu_dtype == torch.bfloat16:
                # the stored moment times b1, both in bfloat16, as optax's
                # weakly typed ``decay * mu``
                b1 = float(torch.tensor(B1).bfloat16())
                old = [m.bfloat16().float() for m in torch._foreach_mul(
                    [m.float() for m in old], b1)]
            else:
                old = torch._foreach_mul(old, B1)
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1), old)
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
            mu = [m.to(self.mu_dtype) for m in mu]
            new_chain[-2] = [count] + [tree_unflatten(like, t)
                                       for t in (mu, nu, nu_max)]
        it = iter(torch._foreach_mul(g, -self.lr))
        updates = tree_unflatten(grads, [
            next(it) if m else torch.zeros_like(x)
            for x, m in zip(tree_leaves(grads), on)])
        return updates, ([[new_chain]] if self.frozen else new_chain)

    def apply_(self, grads, state, params):
        """:meth:`update` with its updates added to ``params``, in place:
        the parameters and every tensor of ``state`` take their new
        values (the trees and their tensors stay the same objects).
        ``grads`` and ``params``: trees shaped like the parameters, or
        their leaves in tree order.  CUDA tensors run the optimizer
        kernel or raise; CPU tensors the foreach chain."""
        g = tree_leaves(grads) if isinstance(grads, dict) else list(grads)
        p = tree_leaves(params) if isinstance(params, dict) else list(params)
        if not p[0].is_cuda:
            # the trees update takes (parameter-shaped, as optax's)
            updates, new = self.update(tree_unflatten(self.mask, g), state,
                                       tree_unflatten(self.mask, p))
            torch._foreach_add_(p, tree_leaves(updates))
            for old, t in zip(tree_leaves(state), tree_leaves(new)):
                if t is not old:
                    old.copy_(t)
            return
        on = self.trainable
        g = [x for x, m in zip(g, on) if m]
        p = [x for x, m in zip(p, on) if m]
        kernel = self._kernel_for(p, state[0][0] if self.frozen else state)
        noise, sigma = self._noise(g) if self.noise_eta > 0 else (None, 0.0)
        kernel(g, noise, sigma, self._combine if self.sharded else None)

    def _combine(self, partials):
        """The global norm from the kernel's partial sums of squares:
        (2, blocks), row 0 the replicated leaves', row 1 the shards'."""
        return self._sharded_norm(partials[0].sum(), partials[1].sum())

    def _kernel_for(self, p, chain):
        """The optimizer kernel over the trainable leaves ``p`` and the
        state ``chain``: built at the first step, and again only for
        another state or a tensor whose storage moved."""
        links = (chain[-2] if self.adam else None,
                 chain[self._noise_at] if self.noise_eta > 0 else None)
        if (self._kernel is None or self._kernel.stale(p)
                or any(a is not b for a, b in zip(links,
                                                  self._kernel_links))):
            adam, noise = links
            self._kernel = AmsgradKernel(
                p, None if adam is None else [tree_leaves(t)
                                              for t in adam[1:]],
                None if adam is None else adam[0],
                None if noise is None else noise["count"],
                ["model" in spec for spec in self.specs],
                chain_consts(self.l2, self.clip, self.lr, B1, B2, EPS,
                             self.mu_dtype == torch.bfloat16),
                self.l2 > 0, self.clip > 0, self.noise_eta > 0)
            self._kernel_links = links
        return self._kernel

def build_optimizer(opt_cfg, params, seed=0, mesh=None):
    """Returns (optimizer, initial state), as ``ast_tpu``'s; ``seed``
    (the run's, an int) seeds the gradient noise; ``mesh``
    (``parallel.make_mesh``): the mesh whose vocab shards the updates
    will be of (``params`` and the state whole)."""
    opt = Optimizer(opt_cfg, params, seed, mesh)
    return opt, opt.init(params)
