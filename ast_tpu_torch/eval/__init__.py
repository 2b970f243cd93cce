"""BLEU scoring of the dev decode (a copy of ast_tpu.eval.bleu)."""

from ast_tpu_torch.eval.bleu import Eval, corpus_bleu

__all__ = ["Eval", "corpus_bleu"]
