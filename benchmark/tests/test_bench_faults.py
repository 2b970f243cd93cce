"""Each fault a cell can have, planted under the timed path of a tiny CPU
run, comes out ``correct: false``; the same run without it comes out
true (``test_bench_train.py``, ``test_bench_decode.py``).

- a step that returns its state unchanged (training);
- half of the batch left out, the mean taken over the rest (training:
  the step trains on half its rows over their count; decoding: half the
  rows decoded, the other half answered from silence);
- a token or an answer altered where it is produced (decoding: one
  token of every hypothesis; the search scoring each candidate by its
  last step alone; the N-best returned worst first; N copies of the
  best hypothesis);
- the exchange between chips left out: no cell runs on more than one
  chip, so none has it.
"""

import json

import pytest
import torch

from test_bench_train import run_cell


def frozen_state(monkeypatch):
    from ast_tpu_torch.train import trainer

    step = trainer.NN.train_step

    def unchanged(self, batch, seed):
        params = [p.detach().clone() for p in trainer.tree_leaves(self.params)]
        opt = [t.clone() for t in trainer.tree_leaves(self.opt_state)]
        loss = step(self, batch, seed)
        with torch.no_grad():
            for p, q in zip(trainer.tree_leaves(self.params), params):
                p.copy_(q)
            for t, q in zip(trainer.tree_leaves(self.opt_state), opt):
                t.copy_(q)
        return loss
    monkeypatch.setattr(trainer.NN, "train_step", unchanged)


def half_batch_train(monkeypatch):
    from ast_tpu_torch.train import trainer

    step = trainer.NN.train_step

    def half(self, batch, seed):
        n = max(1, batch["n_real"] // 2)
        cut = {k: batch[k][:n] for k in ("X", "y", "rows_idx", "drop_mask")
               if batch.get(k) is not None}
        return step(self, dict(batch, n_real=n, **cut), seed)
    monkeypatch.setattr(trainer.NN, "train_step", half)


def half_batch_decode(monkeypatch):
    from ast_tpu_torch.ops import beam

    make = beam.make_beam_decoder

    def made(*a, **kw):
        decode = make(*a, **kw)

        def half(params, state, X, w=None, enc_mask=None):
            # the first half: a tail batch's padding rows come last
            X = X.clone()
            X[:X.shape[0] // 2] = 0
            return decode(params, state, X, w, enc_mask)
        return half
    monkeypatch.setattr(beam, "make_beam_decoder", made)


def altered_token(monkeypatch):
    from ast_tpu_torch.ops import beam

    make = beam.make_beam_decoder

    def made(*a, **kw):
        decode = make(*a, **kw)

        def altered(params, state, X, w=None, enc_mask=None):
            hyps, scores, lengths = decode(params, state, X, w, enc_mask)
            hyps = hyps.clone()
            hyps[:, :, 1] = 4 + (hyps[:, :, 1] - 3) % 20
            return hyps, scores, lengths
        return altered
    monkeypatch.setattr(beam, "make_beam_decoder", made)


def last_step_scores(monkeypatch):
    """The search ranks and scores each candidate by its last token's
    log-probability alone, not the sum along its hypothesis."""
    from ast_tpu_torch.ops import fused_infer

    candidates = fused_infer._BeamState.candidates

    def last_step(self):
        scores = self.scores
        self.scores = torch.where(scores > fused_infer.NEG_INF / 2, 0.0,
                                  scores)
        try:
            return candidates(self)
        finally:
            self.scores = scores
    monkeypatch.setattr(fused_infer._BeamState, "candidates", last_step)


def _answers_altered(monkeypatch, alter):
    from ast_tpu_torch.ops import beam

    make = beam.make_beam_decoder

    def made(*a, **kw):
        decode = make(*a, **kw)

        def altered(params, state, X, w=None, enc_mask=None):
            return alter(*decode(params, state, X, w, enc_mask))
        return altered
    monkeypatch.setattr(beam, "make_beam_decoder", made)


def worst_first(monkeypatch):
    _answers_altered(monkeypatch, lambda hyps, scores, lengths: (
        hyps.flip(1), scores.flip(1), lengths.flip(1)))


def copies_of_the_best(monkeypatch):
    def best(hyps, scores, lengths):
        N = hyps.shape[1]
        return (hyps[:, :1].expand(-1, N, -1), scores[:, :1].expand(-1, N),
                lengths[:, :1].expand(-1, N))
    _answers_altered(monkeypatch, best)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train", frozen_state), ("tiny.train", half_batch_train),
    ("tiny_g2.train", frozen_state), ("tiny_g2.train", half_batch_train),
    ("tiny.decode", half_batch_decode), ("tiny.decode", altered_token),
    ("tiny.decode", last_step_scores), ("tiny.decode", worst_first),
    ("tiny.decode", copies_of_the_best)],
    ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(bench_root, monkeypatch, cell, fault):
    # every answer of the window is read, so that the faulty rows are
    # read whatever the sample would have drawn
    mix = bench_root / "traffic" / "tiny_dev.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   sample=10 ** 6)))
    fault(monkeypatch)
    line = run_cell(bench_root, cell)
    assert not line["correct"], line["checks"]
