"""``gluon.data``: datasets, samplers and the ``DataLoader``.

Counterpart: ``mxnet_tpu/gluon/data/``.  Items and batches are host
data (``mx.cpu()``); ``DataLoader(pin_memory=True)`` page-locks each
batch when a card is present, so its copy to the card can run
asynchronously.
"""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader
from . import vision
