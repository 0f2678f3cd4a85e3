"""mx.monitor — tap internal node outputs during training for debugging.

ref: python/mxnet/monitor.py:33 (Monitor registers a per-node output
callback inside the executor via MXExecutorSetMonitorCallback;
GraphExecutor::ExecuteMonCallback, graph_executor.cc:1418).

Counterpart: ``mxnet_tpu/monitor.py``, a copy over the port's NDArray.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Tuple

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Collect statistics of a Module's internal tensors every `interval`
    batches (ref: monitor.py Monitor).

    Parameters match the reference: interval, stat_func (NDArray →
    NDArray, default |x|.mean()), pattern (regex on node-output names),
    sort (sort output by name), monitor_all (also tap input arrays).
    """

    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False,
                 monitor_all: bool = False):
        if stat_func is None:
            def asum_stat(x):
                """|x|/size(x), the reference default."""
                return x.abs().mean()

            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, NDArray]] = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))

        self.stat_helper = stat_helper

    def install(self, exe):
        """Attach to an executor (ref: monitor.py install → exe
        set_monitor_callback)."""
        exe.set_monitor_callback(self.stat_helper, self.monitor_all)
        self.exes.append(exe)

    def tic(self):
        """Begin collecting for this batch if the interval has elapsed
        (ref: monitor.py tic)."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_dict.values():
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, str]]:
        """End collection, fold in parameter/grad stats, return
        (step, name, stat-str) rows (ref: monitor.py toc)."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_dict.values():
                array.wait_to_read()
            # grad stats are read below too — an async backward still in
            # flight must land before stat_func sees the buffers
            for array in exe.grad_dict.values():
                if array is not None:
                    array.wait_to_read()
        for exe in self.exes:
            for name, array in exe.arg_dict.items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
            for name, array in exe.grad_dict.items():
                if array is not None and self.re_prog.match(name):
                    self.queue.append((self.step, "grad_" + name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            assert isinstance(v_list, list)
            s = ""
            for v in v_list:
                assert isinstance(v, NDArray)
                if v.shape == (1,) or v.shape == ():
                    s += str(v.asnumpy().reshape(-1)[0]) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """toc + log each row (ref: monitor.py toc_print)."""
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
        return res
