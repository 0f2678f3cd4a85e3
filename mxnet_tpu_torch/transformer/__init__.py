"""Decoder-only transformer LM.  Counterpart: ``mxnet_tpu/transformer/``
(the model, its generation forwards, training on one device,
data-parallel with ZeRO-1 or sequence-parallel over a dp x sp mesh with
ring or Ulysses attention, and the synthetic token stream)."""
from .data import LMTokenIter, make_corpus
from .model import (ATTENTION_IMPLS, TransformerConfig, apply,
                    apply_decode, apply_prefill, attention_impl,
                    dense_causal_attn, gather_kv, init_params, lm_loss,
                    make_attn_fn, param_shapes)
from .train import TransformerTrainStep

__all__ = [
    "ATTENTION_IMPLS", "TransformerConfig", "TransformerTrainStep",
    "LMTokenIter", "make_corpus", "apply", "apply_decode",
    "apply_prefill", "attention_impl", "dense_causal_attn",
    "gather_kv", "init_params", "lm_loss", "make_attn_fn",
    "param_shapes",
]
