"""Parallel primitives of the port.  Counterpart: ``mxnet_tpu/parallel/``
(the attention kernels with their gradient, ``mesh`` (meshes of named
axes over a process group, a subgroup per axis), ``buckets`` (the bucket
plan and its all-reduce), ``dp`` (``FusedTrainStep`` on one device or
data-parallel, ZeRO-1, and the multi-context ``Module``'s
``DataParallelRunner``), ``ring_attention`` and ``sequence`` (ring and
Ulysses attention over an ``sp`` axis, on the flash kernels),
``tensor`` (tensor parallelism: ``param_spec_fn``'s ``P`` over the
non-dp axes), ``scaling`` (the rank sweep, collectives by verb from a
trace, the bucket-pipeline model) and ``overlap`` (the exchange's
measured overlap and its dataflow bound, from a trace); import the
submodules for them)."""
from .attention import (FlashAttention, attention_reference,
                        flash_attention, flash_attention_bwd,
                        flash_attention_bwd_reference, flash_attention_fwd,
                        flash_attention_train)
from .tensor import P, PartitionSpec

__all__ = ["attention_reference", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "FlashAttention", "flash_attention_train", "P",
           "PartitionSpec"]
