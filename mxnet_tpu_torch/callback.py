"""Training callbacks (ref: python/mxnet/callback.py).

Counterpart: ``mxnet_tpu/callback.py``, a copy.  ``Speedometer`` sets
its gauge; the allocator-peak sample and the registry's smoothed
samples/s of the JAX package wait for the observability port (ROADMAP
A11).
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "module_checkpoint",
           "log_train_metric", "LogValidationMetricsCallback", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """ref: callback.py:27 module_checkpoint."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """ref: callback.py:55 do_checkpoint."""
    from .model import save_checkpoint

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Throughput logging (ref: callback.py:120 Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                from . import diagnostics as _diag

                elapsed = time.time() - self.tic
                # `frequent` batches within the clock's resolution read
                # as 0 samples/sec rather than a division by zero
                speed = self.frequent * self.batch_size / elapsed \
                    if elapsed > 0 else 0.0
                _diag.metrics.gauge(
                    "mxnet_speedometer_samples_per_second",
                    help="throughput over the last Speedometer "
                         "interval").set(speed)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s"
                    logging.info(msg, param.epoch, count, speed,
                                 "\t".join("%s=%f" % kv for kv in name_value))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """ref: callback.py ProgressBar."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name, value)
