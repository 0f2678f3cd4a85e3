"""Parallel primitives of the port.  Counterpart: ``mxnet_tpu/parallel/``
(the attention kernels with their gradient, ``mesh`` (dp meshes over a
process group), ``buckets`` (the bucket plan and its all-reduce) and
``dp`` (``FusedTrainStep`` on one device or data-parallel, ZeRO-1);
``import mxnet_tpu_torch.parallel.dp`` for it).  Ring / Ulysses sequence
parallelism is ROADMAP A6b."""
from .attention import (FlashAttention, attention_reference,
                        flash_attention, flash_attention_bwd,
                        flash_attention_bwd_reference, flash_attention_fwd,
                        flash_attention_train)

__all__ = ["attention_reference", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "FlashAttention", "flash_attention_train"]
