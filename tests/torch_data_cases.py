"""Picklable datasets for the DataLoader parity tests
(``tests/test_torch_gluon_data.py``): spawned loader workers import
this module, so it imports numpy only."""
import numpy as np


class SquareDataset:
    """Items ``(x * x, i % 4)`` with ``x`` three copies of ``i``: a
    pure-Python transform, the case process workers exist for."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.full((3,), float(i), np.float32)
        return x * x, np.float32(i % 4)


class FailingDataset(SquareDataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return super().__getitem__(i)
