"""ast_tpu_torch's data parallelism (``ast_tpu_torch.parallel`` over
``torch.distributed``) against ``ast_tpu.parallel`` and against one
process, on the CPU.

Ranks are processes of their own (``torch.multiprocessing``, gloo): the
module's fixture ``ranks`` starts two once and runs every job in them
(``tests/torch_ranks.py``, which imports only the port); the JAX side
and the one-process references run here, on the 8-device virtual CPU
mesh of conftest.
Bounds: gradients and parameters rtol 2e-4 / atol 1e-5
(tests/test_parallel.py's, sums over rows in another order), BN
statistics 1e-6, dropout masks, digests, ids and launch counts exactly.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.parallel import mesh as jax_mesh
from ast_tpu_torch import parallel
from ast_tpu_torch.cli import train as cli_train
from ast_tpu_torch.ops import fused_decoder, fused_lstm
from ast_tpu_torch.train import trainer
from tests import torch_ranks
from tests.conftest import TINY_MODEL_CFG, make_tiny_experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD = dict(rtol=2e-4, atol=1e-5)
BN_TOL = 1e-6
V = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models here gain nothing from intra-op threads, which on
    a loaded host (the suite's workers) only contend: one, as the ranks
    use, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(jobs, out, world=2):
    """Run ``jobs`` ((name, args) of ``torch_ranks.JOBS``) in ``world``
    gloo ranks; each job's records, by rank."""
    mp.spawn(torch_ranks.run_jobs, args=(world, _port(), jobs, out),
             nprocs=world, join=True)
    recs = []
    for i in range(len(jobs)):
        recs.append([])
        for r in range(world):
            with open(f"{out}.{i}.{r}", "rb") as f:
                recs[-1].append(pickle.load(f))
    return recs


def _edit(exp, fn, name="train_cfg.json"):
    path = os.path.join(exp, name)
    with open(path) as f:
        cfg = json.load(f)
    fn(cfg)
    with open(path, "w") as f:
        json.dump(cfg, f)


# ---------------------------------------------------------------------------
# the mesh and batch sharding
# ---------------------------------------------------------------------------

# (world, batch, data_axis, model_axis, the port's outcome): "same" --
# ast_tpu's mesh (or None) over the first `world` devices; "raise" --
# both raise; "vocab" -- both raise for a vocab of VOCAB_ODD, ast_tpu as
# it places the vocab shards; else the port refuses what ast_tpu would
# build, and the text names why (one process a card cannot leave a
# device idle or split a batch unevenly)
VOCAB_ODD = 30
MESH_CASES = [
    (1, 32, 0, 1, "same"), (2, 32, 0, 1, "same"), (4, 32, 0, 1, "same"),
    (8, 32, 0, 1, "same"), (2, 6, 2, 1, "same"), (8, 16, 8, 1, "same"),
    (1, 8, 4, 1, "raise"), (2, 8, 4, 1, "raise"), (8, 32, 16, 1, "raise"),
    (4, 6, 0, 1, "batch size 6"), (4, 8, 2, 1, "idle"),
    (2, 7, 2, 1, "does not split"), (4, 32, 0, 2, "same"),
    (2, 32, 1, 2, "same"), (8, 32, 0, 2, "same"), (4, 32, 0, 4, "same"),
    (3, 32, 0, 2, "idle"), (2, 32, 2, 2, "raise"), (8, 32, 0, 4, "vocab"),
    (2, 32, 1, 1, "idle"), (2, 3, 0, 1, "idle"),
]


@pytest.mark.parametrize("world,batch,data_axis,model_axis,outcome",
                         MESH_CASES)
def test_make_mesh_matches_jax(world, batch, data_axis, model_axis, outcome):
    """Each rank's (data_index, model_index) is its device's place in
    ast_tpu's ``Mesh.devices``."""
    cfg = {"data_axis": data_axis, "model_axis": model_axis}
    devices = jax.devices()[:world]
    try:
        want = jax_mesh.make_mesh(cfg, devices=devices, batch_size=batch)
    except ValueError:
        want = "raise"
    if outcome == "raise":
        assert want == "raise"
        with pytest.raises(ValueError, match="needs more than"):
            parallel.make_mesh(cfg, world, batch, rank=0)
        return
    if outcome == "vocab":
        with pytest.raises(ValueError, match="divisible"):
            jax_mesh.replicate({"dec": {"out_w": np.zeros(
                (4, VOCAB_ODD), np.float32)}}, want)
        with pytest.raises(ValueError, match=f"vocab of {VOCAB_ODD}"):
            parallel.make_mesh(cfg, world, batch, rank=0, vocab=VOCAB_ODD)
        return
    if outcome != "same":
        assert want != "raise"          # ast_tpu builds it
        with pytest.raises(ValueError, match=outcome):
            parallel.make_mesh(cfg, world, batch, rank=0)
        return
    for rank in range(world):
        got = parallel.make_mesh(cfg, world, batch, rank=rank)
        if want is None:
            assert got is None
            continue
        assert dict(want.shape) == got.shape and got.rank == rank
        place = np.argwhere(want.devices == devices[rank])
        assert [tuple(p) for p in place] == [(got.data_index,
                                              got.model_index)]


@pytest.mark.parametrize("axis", [0, 1])
def test_shard_batch_matches_jax_shards(axis):
    """Rank r's slice of every array is device r's shard of ast_tpu's
    ``shard_batch`` on a two-device mesh; scalars and arrays without the
    axis stay whole."""
    rng = np.random.default_rng(axis)
    lead = (3,) if axis else ()
    batch = {"X": rng.standard_normal(lead + (4, 5, 13)).astype(np.float32),
             "y": rng.integers(0, V, lead + (4, 6)).astype(np.int32),
             "n_real": np.float32(3)}
    if axis:
        batch["n_real"] = np.float32([4, 4, 3])
    jm = jax_mesh.make_mesh({"data_axis": 2}, devices=jax.devices()[:2])
    ref = jax_mesh.shard_batch(batch, jm, axis=axis)
    for rank in range(2):
        got = parallel.shard_batch(batch, parallel.Mesh(2, rank), axis)
        for k, v in ref.items():
            shard = next(s for s in v.addressable_shards
                         if s.device == jax.devices()[rank])
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))
    assert parallel.shard_batch(batch, None) is not batch
    assert all(parallel.shard_batch(batch, None)[k] is batch[k]
               for k in batch)


def test_collectives_two_ranks(ranks):
    """Two gloo ranks: the gradient sum, the eval gather in rank order,
    a flag raised on one rank seen on both, and replicate making a
    tree of bf16, f32 and int32 leaves of odd sizes rank 0's."""
    for rec in ranks["collectives"]:
        np.testing.assert_array_equal(rec["grads"][0], np.full((3, 5), 3.0))
        np.testing.assert_array_equal(rec["grads"][1], np.arange(7.0))
        np.testing.assert_array_equal(rec["rows"], np.repeat(
            np.arange(2, dtype=np.int32), 2)[:, None].repeat(3, 1))
        assert rec["any"] == [True, False]
        np.testing.assert_array_equal(rec["tree"][0], np.full(3, 0.5))
        np.testing.assert_array_equal(rec["tree"][1], np.full(5, -1.0))
        assert rec["tree"][2] == 0


def test_shards_draw_what_the_whole_batch_draws():
    """K1 train's and K3's plain versions on rows [3, 6) and [0, 3) of a
    6-row batch at their row offsets: the rows (and the dropout masks)
    of one call over the whole batch."""
    rng = np.random.RandomState(0)
    T, L, D2, B, H = 5, 2, 2, 6, 8
    x0 = torch.from_numpy(rng.randn(T, D2, B, 4 * H).astype(np.float32))
    w = [torch.from_numpy((rng.randn(*s) * 0.3).astype(np.float32))
         for s in ((L - 1, D2, H, 4 * H), (L, D2, H, 4 * H), (L, D2, 4 * H))]
    whole = fused_lstm.fused_stacked_lstm_train(x0, *w, 77, 0.4)
    for off in (0, 3):
        part = fused_lstm.fused_stacked_lstm_train(
            x0[:, :, off:off + 3].contiguous(), *w, 77, 0.4, off, B)
        torch.testing.assert_close(part[6], whole[6][:, :, :, off:off + 3],
                                   rtol=0, atol=1e-6)
        assert torch.equal(part[6] == 0, whole[6][:, :, :, off:off + 3] == 0)
    Ld, E, A, U, T2 = 2, 8, 8, 4, 5
    dw = {"wx0": (E + A, 4 * H), "wx_rest": (Ld - 1, H, 4 * H),
          "wh": (Ld, H, 4 * H), "b": (Ld, 4 * H), "wa": (H, H), "wa_b": (H,),
          "ctx_w": (2 * H, A), "ctx_b": (A,), "out_w": (A, V),
          "out_b": (V,), "embed": (V, E)}
    dw = {k: torch.from_numpy((rng.randn(*s) * 0.4).astype(np.float32))
          for k, s in dw.items()}
    enc = torch.from_numpy(rng.randn(B, T2, H).astype(np.float32))
    h0, c0 = (torch.from_numpy(rng.randn(Ld, B, H).astype(np.float32))
              for _ in range(2))
    y_in = torch.from_numpy(rng.randint(4, V, (U, B)).astype(np.int32))
    coins = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    ht, res = fused_decoder.decoder_forward(enc, h0, c0, dw, y_in, coins, 9,
                                            0.4, 0.4)
    for off in (0, 3):
        m = slice(off, off + 3)
        ht_p, res_p = fused_decoder.decoder_forward(
            enc[m], h0[:, m], c0[:, m], dw, y_in[:, m], coins, 9, 0.4, 0.4,
            off)
        torch.testing.assert_close(ht_p, ht[:, m], rtol=0, atol=1e-6)
        for k in ("emb", "x_drop"):
            rows = res[k][:, m] if k == "emb" else res[k][:, :, m]
            assert torch.equal(res_p[k] == 0, rows == 0), k


# ---------------------------------------------------------------------------
# forward_loss on two ranks against ast_tpu on a two-device mesh
# ---------------------------------------------------------------------------

def _mcfg():
    m = jax.tree.map(lambda x: x, TINY_MODEL_CFG)
    m["rnn_config"] = dict(m["rnn_config"], dec_vocab_size=V,
                           fused_encoder=True, fused_decoder=True,
                           fused_interpret=True)
    m["dropout"] = {"embed": 0.3, "rnn": 0.3, "out": 0}
    return m


def _jax_draws(key, X_shape, steps, teach_ratio, add_noise):
    """forward_loss's random numbers from JAX's key (its splits): the
    noise over the whole batch, the hash seeds and the coins."""
    key, ekey = jax.random.split(key)                 # forward_loss
    enc_key, nkey = jax.random.split(ekey)            # encode
    noise = np.asarray(add_noise * jax.random.normal(nkey, X_shape))
    enc_seed = int(jax.random.randint(enc_key, (), 0, 2 ** 31 - 1,
                                      jnp.int32))
    k_coin, k_seed, _, _ = jax.random.split(key, 4)   # _fused_decoder_loss
    idx = jnp.arange(steps)
    coins = ((idx == 0) | (idx >= steps - 1)
             | jax.random.bernoulli(k_coin, teach_ratio, (steps,)))
    dec_seed = int(jax.random.randint(k_seed, (), 0, 2 ** 31 - 1,
                                      jnp.int32))
    return noise, enc_seed, dec_seed, np.asarray(coins, np.int32)


# the sharded forward_loss check's settings: JAX's key, n_real, teacher
# ratio, speech noise, rows, frames, target length
FL_KEY, FL_N_REAL, FL_TEACH, FL_NOISE = 1, 4.0, 0.8, 0.1
FL_B, FL_T, FL_U = 4, 40, 7


def _forward_loss_case():
    """(mcfg, params, state, X, y) of the sharded forward_loss check."""
    mcfg = _mcfg()
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(3), mcfg)
    rng = np.random.RandomState(4)
    X = rng.randn(FL_B, FL_T, 13).astype(np.float32)
    y = rng.randint(4, V, (FL_B, FL_U)).astype(np.int32)
    y[:, 0] = 1
    y[0, 5], y[0, 6] = 2, 0
    y[1, 6] = 2
    y[2, 3], y[2, 4:] = 2, 0
    y[3, 6] = 2
    return (mcfg, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), X, y)


def _forward_loss_inputs(path):
    """Write the forward_loss job's inputs: the case and JAX's draws."""
    mcfg, params, state, X, y = _forward_loss_case()
    noise, enc_seed, dec_seed, coins = _jax_draws(
        jax.random.PRNGKey(FL_KEY), X.shape, FL_U - 1, FL_TEACH, FL_NOISE)
    assert (coins == 0).any()                # scheduled sampling runs
    with open(path, "wb") as f:
        pickle.dump({"params": params, "state": state, "mcfg": mcfg,
                     "X": X, "y": y, "n_real": FL_N_REAL, "noise": noise,
                     "enc_seed": enc_seed, "dec_seed": dec_seed,
                     "coins": coins}, f)


def test_forward_loss_two_ranks_match_jax_mesh(ranks):
    """Two gloo ranks, two rows each, against ast_tpu's forward_loss on a
    two-device mesh (interpret-mode kernels under shard_map, hashing
    global rows; BN over the sharded batch): the loss, every gradient
    summed over the ranks and the new BN statistics."""
    mcfg, params, state, X, y = _forward_loss_case()
    jm = jax_mesh.make_mesh({"data_axis": 2}, devices=jax.devices()[:2])

    def loss_fn(p, X, y):
        return jax_seq2seq.forward_loss(
            p, state, mcfg, X, y, jax.random.PRNGKey(FL_KEY), train=True,
            n_real=FL_N_REAL, teach_ratio=FL_TEACH, add_noise=FL_NOISE,
            mesh=jm)

    sharded = jax_mesh.shard_batch({"X": X, "y": y}, jm)
    (ref_loss, ref_state), ref_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax_mesh.replicate(params, jm),
                                sharded["X"], sharded["y"])
    recs = ranks["forward_loss"]
    from ast_tpu.train import checkpoint as jax_ckpt
    want = jax_ckpt._flatten(jax.tree.map(np.asarray, ref_g))
    want_state = jax_ckpt._flatten(jax.tree.map(np.asarray, ref_state))
    for rec in recs:
        np.testing.assert_allclose(rec["loss"], float(ref_loss), rtol=1e-5)
        got = torch_ranks.arrays(rec["grads"])
        assert sorted(got) == sorted(torch_ranks.arrays(want))
        for k in got:
            np.testing.assert_allclose(got[k], want[k], **GRAD, err_msg=k)
        for k, v in torch_ranks.arrays(rec["state"]).items():
            np.testing.assert_allclose(v, want_state[k], rtol=0,
                                       atol=BN_TOL, err_msg=k)
    for k in recs[0]["grads"]:
        np.testing.assert_array_equal(recs[0]["grads"][k],
                                      recs[1]["grads"][k])


# ---------------------------------------------------------------------------
# NN on two ranks against one process
# ---------------------------------------------------------------------------

def _tiny(tmp_path, tag, scan_path=False, **extras):
    """A tiny experiment with ``extras``; ``scan_path``: a variant whose
    encoder and decoder run ast_tpu's scan path (linear_proj's per-layer
    BN, n_attn 2 with output dropout), trained by SGD: the projections'
    biases feed a BatchNorm, so their exact gradient is 0 and what any
    sum leaves of it is rounding, which AMSGrad would scale up to a
    step of lr (the normalised steps then part by lr in either run)."""
    exp = make_tiny_experiment(str(tmp_path / tag), n_train=16, n_dev=6,
                               batch_size=4)
    _edit(exp, lambda c: c["extras"].update(extras))
    if scan_path:
        _edit(exp, lambda c: c["optimizer"].update(type=1))
        def variant(m):
            m["rnn_config"].update(linear_proj=True, n_attn=2)
            m["dropout"]["out"] = 0.3
        _edit(exp, variant, "model_cfg.json")
    return exp


def _hyps(preds):
    """{utt: its ids up to and including the first EOS}."""
    out = {}
    for utt, ids in preds:
        end = ids.index(2) + 1 if 2 in ids else len(ids)
        out[utt] = ids[:end]
    return out


def _assert_records_match(recs, single):
    assert len({r["digest"] for r in recs}) == 1
    for r, rec in enumerate(recs):
        assert rec["mesh"] == parallel.Mesh(len(recs), r)
        assert rec["tail_shrink"] == 8 * len(recs)
        assert rec["steps"] == single["steps"]
        for what, tol in (("params", GRAD), ("opt", GRAD),
                          ("state", dict(rtol=0, atol=BN_TOL))):
            want = torch_ranks.arrays(single[what])
            got = torch_ranks.arrays(rec[what])
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], **tol,
                                           err_msg=f"{what} {k}")


# the two-rank epochs' configurations (tiny experiments' extras)
TRAIN_CASES = {"g1": {}, "g2": {"steps_per_dispatch": 2},
               "hbm_cache": {"hbm_cache": True},
               "scan_path": {"scan_path": True}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job of two gloo ranks, started once: the collectives, the
    sharded forward_loss, an epoch of each TRAIN_CASES experiment, and
    one preempted on rank 1.  {job: [rank 0's record, rank 1's]}."""
    root = tmp_path_factory.mktemp("ranks")
    inputs = str(root / "inputs.pkl")
    _forward_loss_inputs(inputs)
    jobs = {"collectives": ("collectives", ()),
            "forward_loss": ("forward_loss", (inputs,))}
    for tag, extras in TRAIN_CASES.items():
        jobs[tag] = ("train", (_tiny(root, tag, **extras),))
    preempt = _tiny(root, "preempt", preempt_sync_steps=2)
    jobs["preempt"] = ("train", (preempt, 1))
    recs = _run_ranks(list(jobs.values()), str(root / "out"))
    out = dict(zip(jobs, recs))
    out["preempt_exp"] = preempt
    return out


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_epoch_two_ranks_match_one_process(ranks, tmp_path, case):
    """An epoch of NN.train_epoch on two gloo ranks (two rows each of
    4-row batches; at steps_per_dispatch 2 stacked runs sliced on axis 1;
    under hbm_cache the index batches sliced; on the scan path the
    projections' BN global and every mask over global rows): the
    parameters' digests
    equal on both ranks; parameters, optimizer state and BN statistics
    as one process's; the epoch's loss, eval_loss, and predict /
    decode_beam_set over the whole dev split on both ranks, as one
    process's."""
    recs = ranks[case]
    single = torch_ranks.record(_tiny(tmp_path, "single",
                                      **TRAIN_CASES[case]))
    assert single["mesh"] is None and single["tail_shrink"] == 8
    _assert_records_match(recs, single)
    for rec in recs:
        np.testing.assert_allclose(rec["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(rec["eval_loss"], single["eval_loss"],
                                   rtol=1e-5)
        # the ranks' pinned eval stream orders the split otherwise; the
        # ids past a row's first EOS are those of the rows that share its
        # decode loop (a rank's, as under ast_tpu's shard_map)
        assert _hyps(rec["preds"]) == _hyps(single["preds"])
        assert len(rec["preds"]) == 6 and all(
            len(ids) == len(single["preds"][0][1]) for _, ids in rec["preds"])
        assert sorted(rec["beams"]) == sorted(single["beams"])
        for u, hyps in single["beams"].items():
            assert [h for h, _ in rec["beams"][u]] == [h for h, _ in hyps]
            np.testing.assert_allclose([s for _, s in rec["beams"][u]],
                                       [s for _, s in hyps], rtol=1e-5)


def test_preempt_on_one_rank_stops_both(ranks):
    """Preemption asked on rank 1 only: at the first preempt_sync_steps
    boundary both ranks stop after the same batch, with equal
    parameters, and only rank 0 writes the in-flight snapshot."""
    exp, recs = ranks["preempt_exp"], ranks["preempt"]
    assert all(r["preempted"].endswith("after 2 batches") for r in recs)
    assert recs[0]["steps"] == recs[1]["steps"] == 0
    assert recs[0]["digest"] == recs[1]["digest"]
    snap = np.load(os.path.join(exp, trainer.INFLIGHT))
    assert int(snap["extra/epoch"]) == 1 and int(snap["extra/step"]) == 2
    assert not os.path.exists(os.path.join(exp, "train.log"))


def test_one_process_issues_no_collective(tmp_path, monkeypatch):
    """At world size 1 there is no mesh and no torch.distributed call:
    an epoch, eval_loss, predict and decode_beam_set run with every
    collective and the process group's start-up made to raise."""
    def refuse(*a, **k):
        raise AssertionError("torch.distributed called at world size 1")

    for name in ("init_process_group", "all_reduce", "all_gather",
                 "broadcast", "barrier", "reduce_scatter",
                 "all_gather_into_tensor"):
        monkeypatch.setattr(dist, name, refuse)
    import torch.distributed.nn.functional as dnf
    monkeypatch.setattr(dnf, "all_reduce", refuse)
    assert parallel.init_distributed("localhost:1", 1, 0) is False
    exp = _tiny(tmp_path, "one", steps_per_dispatch=2)
    _edit(exp, lambda c: c.update(parallel={"data_axis": 0}))
    rec = torch_ranks.record(exp)
    assert rec["mesh"] is None and np.isfinite(rec["loss"])
    assert len(rec["preds"]) == 6 and len(rec["beams"]) == 6
    assert parallel.host_info() == (0, 1) and parallel.is_primary()


def test_cli_launch_reads_the_launcher(monkeypatch):
    """torchrun's environment: a bare cuda is cuda:LOCAL_RANK, an
    explicit device is taken as given, and one process joins no
    group."""
    monkeypatch.setattr(cli_train, "init_distributed", lambda *a: (
        _ for _ in ()).throw(AssertionError("joined at world size 1")))
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "3",
           "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}
    assert cli_train.launch("cuda", env=env) == "cuda:3"
    assert cli_train.launch("cuda:0", env=env) == "cuda:0"
    assert cli_train.launch("cpu", env=env) == "cpu"
    assert cli_train.launch("cuda", env={}) == "cuda"
    joined = []
    monkeypatch.setattr(cli_train, "init_distributed",
                        lambda *a: joined.append(a))
    env.update(WORLD_SIZE="2", RANK="1", LOCAL_RANK="1", MASTER_PORT="29511")
    assert cli_train.launch("cpu", "gloo", env=env) == "cpu"
    assert cli_train.launch("cpu", env=env) == "cpu"
    assert joined == [("localhost:29511", 2, 1, "gloo")] * 2


def test_cli_two_ranks_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m ast_tpu_torch.cli.train ...
    --device cpu``: two gloo ranks train an epoch and decode the dev
    split; rank 0 alone writes one train.log row, one dev.log row and
    the checkpoint."""
    exp = _tiny(tmp_path, "cli")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_port()), "-m", "ast_tpu_torch.cli.train",
         "-m", exp, "-e", "1", "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert res.stdout.count("BLEU = ") == 2         # both ranks score
    for log in ("train.log", "dev.log"):
        with open(os.path.join(exp, log)) as f:
            assert len(f.read().splitlines()) == 1, log
    assert os.path.exists(os.path.join(exp, "seq2seq_1.model.npz"))
