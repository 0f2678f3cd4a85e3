"""mxnet_tpu_torch.recommender: the recommender-scale sparse tier.

Counterpart: ``mxnet_tpu/recommender/``.  Embedding-dominated CTR
training whose tables live sharded over parameter-server keys (row
blocks named ``emb<f>:s<k>``, placed by the store's crc32 key rule) and
whose step computes the embedding gradients over the batch's unique
rows only, never a dense ``(vocab, dim)`` buffer.  The traffic a step
is proportional to the batch's unique rows
(``mxnet_kvstore_bytes_total{op=row_sparse_pull|row_sparse_push}``),
and the store's lazy update touches only those rows.
"""
from .data import ClickstreamIter, make_clickstream
from .model import (RecommenderConfig, apply, apply_rows,
                    dense_param_names, init_params, logloss,
                    make_dense_train_step, make_sparse_train_step,
                    param_shapes, table_names)
from .train import RecommenderTrainStep, ShardedEmbeddingTable

__all__ = [
    "RecommenderConfig", "RecommenderTrainStep",
    "ShardedEmbeddingTable", "ClickstreamIter", "make_clickstream",
    "apply", "apply_rows", "dense_param_names", "init_params",
    "logloss", "make_dense_train_step", "make_sparse_train_step",
    "param_shapes", "table_names",
]
