"""Scoring: BLEU of the dev decode, unigram precision / recall (copies
of ast_tpu.eval.bleu and ast_tpu.eval.metrics) and WER (``eval.wer``)."""

from ast_tpu_torch.eval.bleu import Eval, corpus_bleu
from ast_tpu_torch.eval.metrics import unigram_precision_recall

__all__ = ["Eval", "corpus_bleu", "unigram_precision_recall"]
