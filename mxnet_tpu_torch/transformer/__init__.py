"""Decoder-only transformer LM.  Counterpart: ``mxnet_tpu/transformer/``
(the model, its generation forwards, one-device training and the
synthetic token stream; sequence parallelism and ZeRO-1 wait for the
multi-device tier, ROADMAP A6)."""
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
