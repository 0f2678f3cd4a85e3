"""2-bit gradient compression with error feedback.

Counterpart: ``mxnet_tpu/gradient_compression.py`` (ref:
src/kvstore/gradient_compression.h:37-52, CompressionType::kTwoBit and
its threshold, and the quantize / dequantize kernels of
gradient_compression-inl.h).  Values >= threshold encode as +threshold
(code 1), values <= -threshold as -threshold (code 2), the rest as 0
(code 0); the quantisation error (the residual) stays with the worker
and is added to the key's next gradient before encoding, so small
gradients accumulate until they cross the threshold.  Codes pack 4 a
byte (the reference packs 16 a float32 word: the same 16x against
float32).

:meth:`GradientCompression.compress` takes a numpy array (encoded on
the host) or a torch tensor (encoded where it lies: on the card the
codes and the residual are computed there, so only the packed codes
cross PCIe).  Both give the same bytes: the same float32 additions,
comparisons and subtractions, element by element.

A row-sparse push (:meth:`GradientCompression.compress_rows`) encodes
its values and keeps the residual per (key, row id): a row's remainder
waits for that row's next push, whatever rows the batches between
carry.  The row ids travel exact beside the codes
(:meth:`rows_wire_nbytes`).  It runs on the host: the rows of one push
are few, and their ids key a dict.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["GradientCompression"]


class GradientCompression:
    def __init__(self, type: str = "2bit", threshold: float = 0.5):
        if type != "2bit":
            raise ValueError("unsupported compression type %r "
                             "(reference supports 2bit)" % type)
        if threshold <= 0:
            raise ValueError("threshold must be positive "
                             "(ref: gradient_compression.h:43 range check)")
        self.type = type
        self.threshold = float(threshold)
        self._residual: Dict = {}
        self._row_residual: Dict = {}

    def get_params(self) -> Dict[str, str]:
        return {"type": self.type, "threshold": str(self.threshold)}

    @staticmethod
    def wire_nbytes(n_elements: int) -> int:
        """On-wire payload of one compressed gradient: 2-bit codes pack
        4 a byte, so byte counters can account a push before encoding
        it."""
        return (int(n_elements) + 3) // 4

    def compress(self, key, grad):
        """``grad`` (+ the key's carried residual) -> packed 2-bit codes
        and the shape: ``(bytes, shape)`` for a numpy array, ``(uint8
        tensor on grad's device, shape)`` for a tensor."""
        import torch

        if isinstance(grad, torch.Tensor):
            return self._compress_tensor(key, grad)
        grad = np.asarray(grad, dtype=np.float32)
        res = self._residual.get(key)
        if res is None:
            res = np.zeros_like(grad)
        elif isinstance(res, torch.Tensor):
            res = res.cpu().numpy()
        work = grad + res
        codes = np.zeros(work.size, dtype=np.uint8)
        flat = work.ravel()
        pos = flat >= self.threshold
        neg = flat <= -self.threshold
        codes[pos] = 1
        codes[neg] = 2
        decoded = np.zeros_like(flat)
        decoded[pos] = self.threshold
        decoded[neg] = -self.threshold
        self._residual[key] = (flat - decoded).reshape(grad.shape)
        return self._pack(codes), tuple(grad.shape)

    def _compress_tensor(self, key, grad):
        import torch

        g = grad.detach().to(torch.float32)
        res = self._residual.get(key)
        if res is None:
            res = torch.zeros_like(g)
        elif not isinstance(res, torch.Tensor):
            res = torch.from_numpy(np.asarray(res)).to(g.device)
        work = g + res                   # as numpy: + 0.0 turns -0.0 to 0.0
        flat = work.reshape(-1)
        pos = flat >= self.threshold
        neg = flat <= -self.threshold
        codes = pos.to(torch.uint8) | (neg.to(torch.uint8) << 1)
        decoded = torch.where(pos, self.threshold,
                              torch.where(neg, -self.threshold, 0.0)
                              ).to(torch.float32)
        self._residual[key] = (flat - decoded).reshape(g.shape)
        pad = (-codes.numel()) % 4
        if pad:
            codes = torch.cat([codes, codes.new_zeros(pad)])
        c = codes.view(-1, 4)
        packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
        return packed, tuple(g.shape)

    def residual(self, key):
        """The key's carried residual (numpy or a tensor), or None."""
        return self._residual.get(key)

    @staticmethod
    def rows_wire_nbytes(n_rows: int, row_elements: int) -> int:
        """On-wire payload of one compressed row-sparse push: the 8-byte
        int64 row ids (exact) and the 2-bit codes of the values."""
        return int(n_rows) * 8 + GradientCompression.wire_nbytes(
            int(n_rows) * int(row_elements))

    def compress_rows(self, key, rows, values) -> Tuple[bytes, tuple]:
        """A row-sparse ``(rows, values)`` gradient plus each row's
        carried residual -> the packed 2-bit codes of the values and
        their shape ``(len(rows), row elements)``; decode with
        :meth:`decompress`.  ``values`` may be a tensor (it moves to the
        host)."""
        import torch

        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        values = np.asarray(values, dtype=np.float32).reshape(rows.size, -1)
        store = self._row_residual.setdefault(key, {})
        work = values.copy()
        for i, r in enumerate(rows):
            res = store.get(int(r))
            if res is not None:
                work[i] += res
        pos = work >= self.threshold
        neg = work <= -self.threshold
        codes = np.zeros(work.shape, dtype=np.uint8)
        codes[pos] = 1
        codes[neg] = 2
        decoded = np.zeros_like(work)
        decoded[pos] = self.threshold
        decoded[neg] = -self.threshold
        err = work - decoded
        for i, r in enumerate(rows):
            store[int(r)] = err[i]
        return self._pack(codes.ravel()), tuple(values.shape)

    @staticmethod
    def _pack(codes: np.ndarray) -> bytes:
        pad = (-codes.size) % 4
        if pad:
            codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
        return (codes[0::4] | (codes[1::4] << 2) | (codes[2::4] << 4)
                | (codes[3::4] << 6)).tobytes()

    def decompress(self, codes: bytes, shape: tuple) -> np.ndarray:
        packed = np.frombuffer(codes, dtype=np.uint8)
        n = int(np.prod(shape)) if shape else 1
        codes4 = np.empty(packed.size * 4, np.uint8)
        codes4[0::4] = packed & 0x3
        codes4[1::4] = (packed >> 2) & 0x3
        codes4[2::4] = (packed >> 4) & 0x3
        codes4[3::4] = (packed >> 6) & 0x3
        codes4 = codes4[:n]
        out = np.zeros(n, np.float32)
        out[codes4 == 1] = self.threshold
        out[codes4 == 2] = -self.threshold
        return out.reshape(shape)
