"""Parallel primitives of the port.  Counterpart: ``mxnet_tpu/parallel/``
(the single-device attention with its gradient, the bucket plan, and
``dp.FusedTrainStep`` on one device; ``import mxnet_tpu_torch.parallel.dp``
for it)."""
from .attention import (FlashAttention, attention_reference,
                        flash_attention, flash_attention_bwd,
                        flash_attention_bwd_reference, flash_attention_fwd,
                        flash_attention_train)

__all__ = ["attention_reference", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "FlashAttention", "flash_attention_train"]
