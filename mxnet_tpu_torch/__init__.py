"""mxnet_tpu_torch — the PyTorch + CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``mxnet_tpu`` stays the reference: each module here
names its counterpart there and is held against it by parity tests
(``tests/test_torch_*.py``).  This package imports neither JAX nor
``mxnet_tpu``.  Its entry points run on the card unless the caller asks
for the CPU (``device="cpu"``, ``ctx=mx.cpu()``); without a CUDA device
they raise.  Every kernel the JAX package wrote in Pallas is a
hand-written CUDA C++ kernel: ``csrc/*.cu`` built by ``nvcc`` at first
use (``_build``), and ``csrc/rtc/*.cu`` compiled by NVRTC through
``rtc.CudaModule``.  Nothing is built at import.

Ported so far:

* the generation serving path — ``serving`` (``ModelServer`` over a
  paged-KV continuous-batching ``GenerationRuntime``),
  ``transformer.model`` and ``parallel.attention`` with the
  flash-attention kernel that the prefill runs;
* the imperative path — ``nd`` (``NDArray``, the op registry's core
  ops, save/load), ``autograd`` on ``torch.autograd``, ``engine`` and
  ``rtc`` (``CudaModule`` / ``PallasModule``);
* ResNet training — ``random``, the ``nn`` ops, ``initializer``,
  ``gluon`` (blocks, layers, losses, ``Trainer``, the ResNet zoo),
  ``optimizer`` (SGD, the fused SGD-momentum update), ``kvstore``
  (``local`` / ``device``) and ``parallel.dp.FusedTrainStep`` on one
  device;
* transformer-LM training on one device —
  ``transformer.TransformerTrainStep`` (``fit`` with checkpoints and
  exact resume) over ``transformer.LMTokenIter`` (``io``), with the
  flash-attention forward and backward kernels, ``remat`` and the
  bucket plan (``parallel.buckets``) that checkpoints record.
"""
from . import base, context, convert, env, parallel, serving, transformer
from . import autograd, engine, ndarray, rtc
from . import io, remat
from . import ndarray as nd
from . import random
from . import initializer
from . import initializer as init
from . import optimizer
from . import kvstore
from . import kvstore as kv
from . import gluon
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, tpu)
from .initializer import Normal, Uniform, Xavier
from .ndarray import NDArray

rnd = random

__all__ = ["convert", "env", "parallel", "serving", "transformer", "io",
           "remat", "nd",
           "ndarray", "autograd", "engine", "rtc", "base", "context",
           "random", "initializer", "init", "optimizer", "kvstore", "kv",
           "gluon", "Context", "cpu", "cpu_pinned", "gpu", "tpu",
           "current_context", "num_gpus", "NDArray", "MXNetError"]
