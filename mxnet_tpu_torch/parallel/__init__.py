"""Parallel primitives of the port.  Counterpart: ``mxnet_tpu/parallel/``
(the attention kernels with their gradient, ``mesh`` (meshes of named
axes over a process group, a subgroup per axis), ``buckets`` (the bucket
plan and its all-reduce), ``dp`` (``FusedTrainStep`` on one device or
data-parallel, ZeRO-1, and the multi-context ``Module``'s
``DataParallelRunner``), ``ring_attention`` and ``sequence`` (ring and
Ulysses attention over an ``sp`` axis, on the flash kernels); import
the submodules for them)."""
from .attention import (FlashAttention, attention_reference,
                        flash_attention, flash_attention_bwd,
                        flash_attention_bwd_reference, flash_attention_fwd,
                        flash_attention_train)

__all__ = ["attention_reference", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "FlashAttention", "flash_attention_train"]
