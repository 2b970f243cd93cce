"""ast_tpu_torch's vocab tensor parallelism (``parallel.model_axis``:
``dec/out_w``, ``dec/out_b`` and ``dec/embed`` sharded over a model
group of ranks) against ``ast_tpu``'s (data, model) mesh and against one
process, on the CPU.

Ranks are processes of their own (``torch.multiprocessing``, gloo): the
module's fixture ``ranks`` starts a group of four (a 2x2 mesh) and one
of two (1x2, and the 2x1 data axis) in one spawn and runs every job in
them (``tests/torch_ranks.py``, which imports only the port); the JAX
side (a 2x2 mesh over 4 of conftest's 8 virtual CPU devices,
interpret-mode kernels) and the one-process references run here.
Bounds: gradients, parameters and optimizer state rtol 2e-4 / atol 1e-5
(tests/test_torch_parallel.py's ``GRAD``), BN statistics 1e-6, losses
rtol 1e-5, ids, hypotheses and the replicated leaves' bytes exactly; a
data axis at bf16 against one process: the first step's gradients
within ``BF16_LEAF`` of each leaf's largest |g|, the epoch's parameters
within 3 lr.
"""

import os
import pickle
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.parallel import mesh as jax_mesh
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu_torch import parallel
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.parallel import tp
from tests import torch_ranks
from tests.test_torch_parallel import (
    BN_TOL, FL_KEY, FL_N_REAL, FL_NOISE, FL_TEACH, FL_U, GRAD, _edit,
    _forward_loss_case, _hyps, _jax_draws, _port, _tiny)

# every option whose draws or sums the model axis touches
OPTIONS = {"label_smoothing": 0.1, "random_out": 0.1, "weight_noise_iter": 1,
           "weight_noise_mean": 0.0, "weight_noise_sigma": 0.01}
MESH_2X2 = {"data_axis": 2, "model_axis": 2}
LR = 0.01                               # the tiny experiment's
# A data axis at bf16 sums BN's global statistics in another order than
# one process, so a value in the forward crosses a bf16 rounding point
# now and then, and the first step's gradients part from one process's
# by about one bf16 step (2^-8) of a leaf's largest |g| (printed by
# test_first_step_matches_one_process).  A fault of the axes (a sum over
# the wrong group, a wrong shard, a gradient counted M times) parts by
# the order of that scale.  The bound: two bf16 steps.
BF16_LEAF = 2.0 ** -7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the ranks use, restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(root, tag, model_axis=1, **extras):
    """A tiny experiment with :data:`OPTIONS`, gradient noise,
    ``extras`` and ``parallel.model_axis``."""
    exp = _tiny(root, tag, **OPTIONS, **extras)
    _edit(exp, lambda c: c["optimizer"].update(grad_noise_eta=0.01))
    _edit(exp, lambda c: c.update(parallel={"model_axis": model_axis}))
    return exp


def _copy(exp, root, tag, model_axis):
    """A copy of ``exp``'s experiment tree (configs, data, checkpoints) at
    another ``model_axis``; its exp directory."""
    dst = os.path.join(str(root), tag)
    shutil.copytree(os.path.dirname(exp), dst)
    out = os.path.join(dst, "exp")
    # the copied configs name the source's data: keep them
    _edit(out, lambda c: c.update(parallel={"model_axis": model_axis}))
    return out


def _single_resume(exp, epoch):
    """One process resuming ``exp``, then training ``epoch``."""
    return torch_ranks.resume(0, exp, epoch)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The one-process references that resumes start from, then every
    job of a 2x2 group (four ranks) and a two-rank group in one spawn.
    {job: [records by rank]}, plus the references under ``single_*``."""
    root = tmp_path_factory.mktemp("model_axis")
    inputs = str(root / "inputs.pkl")
    mcfg, params, state, X, y = _forward_loss_case()
    noise, enc_seed, dec_seed, coins = _jax_draws(
        jax.random.PRNGKey(FL_KEY), X.shape, FL_U - 1, FL_TEACH, FL_NOISE)
    with open(inputs, "wb") as f:
        pickle.dump({"params": params, "state": state, "mcfg": mcfg,
                     "X": X, "y": y, "n_real": FL_N_REAL, "noise": noise,
                     "enc_seed": enc_seed, "dec_seed": dec_seed,
                     "coins": coins, "parallel": MESH_2X2}, f)
    out = {}
    # one process: epoch 1, its checkpoint, epoch 2 (f32); bf16; an epoch
    # preempted after its first batch
    single = _exp(root, "single", 1)
    out["single"] = dict(torch_ranks.record(single, then_save=True),
                         exp=single)
    out["single_bf16"] = torch_ranks.record(
        _exp(root, "single_bf16", 1, compute_dtype="bfloat16"))
    inflight = _exp(root, "inflight", 1)
    out["single_preempt"] = torch_ranks.record(inflight, preempt=True)
    from_single = _copy(single, root, "from_single", 2)
    # the two-rank group resumes the in-flight snapshot; this process
    # resumes it after the spawn, from a copy of its own
    inflight_ranks = _copy(inflight, root, "inflight_ranks", 2)
    out["inflight_exp"] = inflight

    quad = {"tp_forward_loss": ("tp_forward_loss", (inputs,)),
            "f32_2x2": ("train", (_exp(root, "f32_2x2", 2),)),
            "bf16_2x2": ("train", (_exp(root, "bf16_2x2", 2,
                                        compute_dtype="bfloat16"),))}
    pair = {"f32_1x2": ("train", (_exp(root, "f32_1x2", 2), -1, True)),
            "bf16_1x2": ("train", (_exp(root, "bf16_1x2", 2,
                                        compute_dtype="bfloat16"),)),
            "bf16_2x1": ("train", (_exp(root, "bf16_2x1", 1,
                                        compute_dtype="bfloat16"),)),
            "from_single": ("resume", (from_single, 2)),
            "inflight": ("resume", (inflight_ranks, 1))}
    groups = [(4, _port(), list(quad.values())),
              (2, _port(), list(pair.values()))]
    base = str(root / "out")
    mp.spawn(torch_ranks.run_groups, args=(groups, base), nprocs=6,
             join=True)
    for g, jobs in enumerate((quad, pair)):
        for i, name in enumerate(jobs):
            out[name] = []
            for r in range(groups[g][0]):
                with open(f"{base}.g{g}.{i}.{r}", "rb") as f:
                    out[name].append(pickle.load(f))
    out["f32_1x2_exp"] = pair["f32_1x2"][1][0]
    return out


def _close(got, want, what, tol=GRAD):
    """Every array of the flat ``want`` within ``tol`` of ``got``'s, the
    same keys."""
    got, want = torch_ranks.arrays(got), torch_ranks.arrays(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], **tol,
                                   err_msg=f"{what} {k}")


def _same_state(recs, ref):
    """Each rank's whole parameters, optimizer state (``GRAD``) and BN
    state (``BN_TOL``) as ``ref``'s; the replicated leaves' bytes equal
    on every rank, and every leaf's on the ranks of a data group."""
    assert len({r["replicated"] for r in recs}) == 1
    model = recs[0]["mesh"].model
    for r, rec in enumerate(recs):
        assert rec["digest"] == recs[r % model]["digest"]
        _close(rec["params"], ref["params"], "params")
        _close(rec["opt"], ref["opt"], "opt")
        _close(rec["state"], ref["state"], "state",
               dict(rtol=0, atol=BN_TOL))


def _same_outputs(recs, ref):
    """The epoch's loss and ``eval_loss`` within rtol 1e-5 of ``ref``'s,
    ``predict``'s hypotheses and ``decode_beam_set``'s equal (the whole
    dev split on every rank)."""
    for rec in recs:
        np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(rec["eval_loss"], ref["eval_loss"],
                                   rtol=1e-5)
        assert _hyps(rec["preds"]) == _hyps(ref["preds"])
        assert sorted(rec["beams"]) == sorted(ref["beams"])
        for u, hyps in ref["beams"].items():
            assert [h for h, _ in rec["beams"][u]] == [h for h, _ in hyps]
            np.testing.assert_allclose([s for _, s in rec["beams"][u]],
                                       [s for _, s in hyps], rtol=1e-5)


# ---------------------------------------------------------------------------
# forward_loss on a 2x2 mesh against ast_tpu's
# ---------------------------------------------------------------------------

def test_forward_loss_2x2_matches_jax_mesh(ranks):
    """Four gloo ranks (data 2 x model 2: two rows each, half the vocab
    of out_w / out_b / embed each) against ast_tpu's forward_loss on a
    2x2 mesh (its vocab matrices sharded over 'model', interpret-mode
    kernels under shard_map): the loss, every gradient gathered whole
    and the new BN statistics, on every rank."""
    mcfg, params, state, X, y = _forward_loss_case()
    jm = jax_mesh.make_mesh(MESH_2X2, devices=jax.devices()[:4])
    spec = jax_mesh.param_spec(params, jm)
    assert spec["dec"]["out_w"].spec == jax.sharding.PartitionSpec(
        None, "model")

    def loss_fn(p, X, y):
        return jax_seq2seq.forward_loss(
            p, state, mcfg, X, y, jax.random.PRNGKey(FL_KEY), train=True,
            n_real=FL_N_REAL, teach_ratio=FL_TEACH, add_noise=FL_NOISE,
            mesh=jm)

    sharded = jax_mesh.shard_batch({"X": X, "y": y}, jm)
    (ref_loss, ref_state), ref_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax_mesh.replicate(params, jm),
                                sharded["X"], sharded["y"])
    want = jax_ckpt._flatten(jax.tree.map(np.asarray, ref_g))
    want_state = jax_ckpt._flatten(jax.tree.map(np.asarray, ref_state))
    V = mcfg["rnn_config"]["dec_vocab_size"]
    for r, rec in enumerate(ranks["tp_forward_loss"]):
        mesh = rec["mesh"]
        assert (mesh.data_index, mesh.model_index) == divmod(r, 2)
        assert {k: tuple(rec["spec"][k]) for k in ("out_w", "out_b",
                                                   "embed")} == {
            k: tuple(spec["dec"][k].spec) for k in ("out_w", "out_b",
                                                    "embed")}
        assert rec["shapes"]["out_w"][1] == rec["shapes"]["out_b"][0] == \
            rec["shapes"]["embed"][0] == V // 2
        np.testing.assert_allclose(rec["loss"], float(ref_loss), rtol=1e-5)
        _close(rec["grads"], want, "grads")
        for k, v in torch_ranks.arrays(rec["state"]).items():
            np.testing.assert_allclose(v, want_state[k], rtol=0,
                                       atol=BN_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# NN on 1x2 and 2x2 meshes against one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["f32_1x2", "f32_2x2", "bf16_1x2"])
def test_train_epoch_matches_one_process(ranks, case):
    """An epoch of NN.train_epoch with label smoothing, random_out,
    gradient noise and weight noise on a model axis of 2 (1x2: both
    ranks hold the batch; 2x2: two rows a rank), then eval_loss, predict
    and decode_beam_set over the whole dev split, against one process:
    the whole parameters and optimizer state within GRAD, BN statistics
    within 1e-6, the replicated leaves bit-equal on every rank, the
    losses within 1e-5 and the decodes equal."""
    ref = ranks["single_bf16" if case.startswith("bf16") else "single"]
    recs = ranks[case]
    data, model = map(int, case.split("_")[1].split("x"))
    for r, rec in enumerate(recs):
        assert rec["mesh"] == parallel.Mesh(data, r, model)
        assert rec["tail_shrink"] == 8 * data
        assert rec["steps"] == ref["steps"]
    _same_state(recs, ref)
    _same_outputs(recs, ref)


@pytest.mark.parametrize("case", ["f32_1x2", "f32_2x2", "bf16_1x2",
                                  "bf16_2x1", "bf16_2x2"])
def test_first_step_matches_one_process(ranks, case):
    """The epoch's first step (weight noise on) against one process's,
    before AMSGrad's normalised step can turn a rounding difference into
    a step of lr: the BN state within 1e-6 and the gradients (summed
    over the data group, gathered whole) within GRAD on every rank.  A
    data axis at bf16 holds each gradient leaf within ``BF16_LEAF`` of
    its largest |g| instead (see :data:`BF16_LEAF`)."""
    ref = ranks["single_bf16" if case.startswith("bf16") else "single"]
    want = torch_ranks.arrays(ref["first"]["grads"])
    for rec in ranks[case]:
        _close(rec["first"]["state"], ref["first"]["state"], "state",
               dict(rtol=0, atol=BN_TOL))
        if case.startswith("f32") or rec["mesh"].data == 1:
            _close(rec["first"]["grads"], want, "grads")
            continue
        got = torch_ranks.arrays(rec["first"]["grads"])
        assert sorted(got) == sorted(want)
        gaps = {}
        for k, w in want.items():
            gap, scale = np.abs(got[k] - w).max(), np.abs(w).max()
            assert gap <= BF16_LEAF * scale, (k, gap, scale)
            if scale:
                gaps[k] = float(gap / scale)
    if case.startswith("bf16") and ranks[case][0]["mesh"].data > 1:
        print(f"{case} first step: largest gradient gap / leaf's largest "
              f"|g| {max(gaps.values())} ({max(gaps, key=gaps.get)})")


def _epoch_gap(rec, ref):
    """{part: (elements outside GRAD, elements, largest |difference|)}
    of ``rec``'s whole parameters, optimizer state and BN state against
    ``ref``'s."""
    out = {}
    for part in ("params", "opt", "state"):
        got, want = torch_ranks.arrays(rec[part]), torch_ranks.arrays(
            ref[part])
        out[part] = (
            sum(int((~np.isclose(got[k], w, **GRAD)).sum())
                for k, w in want.items()),
            sum(w.size for w in want.values()),
            max(float(np.abs(got[k] - w).max()) for k, w in want.items()))
    return out


def test_bf16_2x2_matches_its_data_axis(ranks):
    """At bf16 the 2x2 epoch equals the 2x1 (data-parallel) epoch within
    GRAD, with the same decodes; its losses are within 1e-5 of one
    process's.  The 2x1 epoch itself parts from one process (its first
    step is held in :func:`test_first_step_matches_one_process`): a
    flipped rounding point turns, through AMSGrad's normalised step,
    into a parameter step of up to 2 lr, so each parameter is held
    within 3 lr of one process's.  The gap is printed."""
    recs, dp = ranks["bf16_2x2"], ranks["bf16_2x1"]
    assert dp[0]["mesh"] == parallel.Mesh(2, 0)
    _same_state(recs, dp[0])
    _same_outputs(recs, dp[0])
    one = ranks["single_bf16"]
    for rec in recs + dp:
        np.testing.assert_allclose(rec["loss"], one["loss"], rtol=1e-5)
    gap = _epoch_gap(dp[0], one)
    print(f"bf16 2x1 epoch against one process: {gap}")
    assert gap["params"][2] <= 3 * LR


# ---------------------------------------------------------------------------
# checkpoints across mesh shapes
# ---------------------------------------------------------------------------

def test_checkpoint_is_one_process_layout(ranks):
    """Rank 0's seq2seq_1.model.npz at 1x2 holds one process's keys,
    shapes and dtypes, and ast_tpu's load_checkpoint reads it; one
    process resuming it trains epoch 2 as the ranks did (model 2 ->
    model 1)."""
    exp = ranks["f32_1x2_exp"]
    path = os.path.join(exp, "seq2seq_1.model.npz")
    with np.load(path) as got, np.load(os.path.join(
            ranks["single"]["exp"], "seq2seq_1.model.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                    want[k].dtype), k
    loaded = jax_ckpt.load_checkpoint(path)
    assert loaded["params"]["dec"]["out_w"].shape == (16, 12)
    assert loaded["opt"] is not None
    _edit(exp, lambda c: c.update(parallel={"model_axis": 1}))
    single = _single_resume(exp, 2)
    nxt = ranks["f32_1x2"][0]["next"]
    np.testing.assert_allclose(single["loss"], nxt["loss"], rtol=1e-5)
    _close(single["params"], nxt["params"], "params")
    _close(single["opt"], nxt["opt"], "opt")


def test_checkpoint_of_one_process_resumes_at_model_2(ranks):
    """A checkpoint one process wrote resumes on a 1x2 mesh: epoch 2 as
    one process trains it after the same checkpoint."""
    recs, ref = ranks["from_single"], ranks["single"]["next"]
    for rec in recs:
        assert rec["max_epoch"] == 1 and rec["inflight"] is None
        np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-5)
    _same_state(recs, ref)


def test_inflight_snapshot_resumes_at_model_2(ranks):
    """A mid-epoch snapshot of one process (its epoch preempted after a
    batch) resumes on a 1x2 mesh at that batch: the rest of the epoch as
    one process trains it from the same snapshot."""
    pre = ranks["single_preempt"]
    assert pre["preempted"].endswith("after 1 batches")
    ref = _single_resume(ranks["inflight_exp"], 1)
    assert ref["inflight"] == (1, 1)
    recs = ranks["inflight"]
    for rec in recs:
        assert rec["inflight"] == (1, 1) and rec["steps"] == ref["steps"]
        np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-5)
    _same_state(recs, ref)


# ---------------------------------------------------------------------------
# the vocab-parallel cross-entropy at one shard
# ---------------------------------------------------------------------------

def _ce_case(seed=0, U=5, B=3, A=8, V=12):
    rng = np.random.RandomState(seed)
    ht = torch.tensor(rng.randn(U, B, A).astype(np.float32))
    out_w = torch.tensor(rng.randn(A, V).astype(np.float32))
    out_b = torch.tensor(rng.randn(V).astype(np.float32))
    target = torch.tensor(rng.randint(0, V, (U, B)))
    target[0, 0] = 0                                  # a PAD
    replace = torch.tensor(rng.rand(U, B) > 0.5)
    rand_ids = torch.tensor(rng.randint(4, V, (U, B)))
    return ht, out_w, out_b, target, replace, rand_ids


def _grads(fn, *leaves):
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    loss = fn(*leaves)
    return [loss.detach()] + list(torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_loss_at_one_shard_is_sequence_loss(dtype, smoothing):
    """At a model axis of 1 (and without a mesh) the sharded loss is
    ``sequence_loss`` itself, bit for bit, loss and gradients (target
    corruption and label smoothing on); ``VocabParallelCrossEntropy``
    over one shard holding every column equals ``logits_loss`` within
    1e-6, loss and logits' gradient."""
    ht, out_w, out_b, target, replace, rand_ids = _ce_case()
    kw = dict(label_smoothing=smoothing, replace=replace, rand_ids=rand_ids)
    want = _grads(lambda h, w, b: seq2seq.sequence_loss(
        h, w, b, target, 3.0, compute_dtype=dtype, **kw), ht, out_w, out_b)
    for mesh in (None, parallel.Mesh(2, 0)):
        got = _grads(lambda h, w, b: seq2seq.sharded_sequence_loss(
            h, w, b, target, 3.0, mesh, compute_dtype=dtype, **kw),
            ht, out_w, out_b)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    tgt = torch.where(replace & (target >= 4), rand_ids, target)
    logits = (ht @ out_w + out_b).requires_grad_(True)
    ref = seq2seq.logits_loss(logits, tgt, 3.0, smoothing)
    (d_ref,) = torch.autograd.grad(ref, logits)
    got = tp.VocabParallelCrossEntropy.apply(logits, tgt, 3.0, smoothing, 0,
                                             logits.shape[-1], None)
    (d_got,) = torch.autograd.grad(got, logits)
    torch.testing.assert_close(got, ref.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(d_got, d_ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# cli.beam under torchrun
# ---------------------------------------------------------------------------

def test_cli_beam_two_ranks_under_torchrun(ranks, tmp_path):
    """``torchrun --nproc-per-node 2 -m ast_tpu_torch.cli.beam ...
    --device cpu`` on an experiment at ``model_axis: 2`` (one process's
    epoch-1 checkpoint): rank 0 alone writes the pickle and the .en
    file, whose bytes equal one process's ``cli.beam`` on the same
    checkpoint; the pickle holds one process's hypotheses."""
    from ast_tpu_torch.cli import beam as cli_beam

    exp = _copy(ranks["single"]["exp"], tmp_path, "cli_beam", 2)
    one = ranks["single"]["exp"]
    flags = ["-n", "2", "-k", "2", "-s", "tiny_dev", "-w", "0.6",
             "--device", "cpu"]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_port()), "-m", "ast_tpu_torch.cli.beam",
         "-m", exp] + flags, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert res.stdout.count("BLEU = ") == 2         # both ranks score
    assert res.stdout.count("Predictions written to") == 1
    cli_beam.main(["-m", one] + flags)
    name = "tiny_dev_beam_N-2_K-2_W-0.60.en"
    with open(os.path.join(exp, name), "rb") as f, \
            open(os.path.join(one, name), "rb") as g:
        assert f.read() == g.read()
    with open(os.path.join(exp, "tiny_dev_beam_N-2_K-2.p"), "rb") as f, \
            open(os.path.join(one, "tiny_dev_beam_N-2_K-2.p"), "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    assert {u: [h for h, _ in v] for u, v in got.items()} == {
        u: [h for h, _ in v] for u, v in want.items()}
