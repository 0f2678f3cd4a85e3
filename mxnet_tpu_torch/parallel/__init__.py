"""Parallel primitives of the port.  Counterpart: ``mxnet_tpu/parallel/``
(the single-device attention, and ``dp.FusedTrainStep`` on one device;
``import mxnet_tpu_torch.parallel.dp`` for it)."""
from .attention import (attention_reference, flash_attention,
                        flash_attention_fwd)

__all__ = ["attention_reference", "flash_attention", "flash_attention_fwd"]
