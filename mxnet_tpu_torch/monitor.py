"""Monitor: statistics of a bound executor's outputs (and arguments)
every ``interval`` batches (parity: python/mxnet/monitor.py:33 over the
executor monitor callback, src/executor/graph_executor.cc:123,1441).

The counterpart of ``mxnet_tpu/monitor.py`` over
``Executor.set_monitor_callback``.  The default statistic is
``norm(x) / sqrt(x.size)``, computed in float32.
"""
from __future__ import annotations

import logging
import re
from math import sqrt

import torch

from . import ndarray as nd


def _asum_stat(x):
    return torch.linalg.vector_norm(x.detach().float()) / sqrt(x.numel())


def _scalar(v):
    return nd.asnumpy(v).reshape(-1)[0] if isinstance(v, torch.Tensor) else v


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.stat_func = stat_func or _asum_stat
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = bool(monitor_all)

    def stat_helper(self, name, array):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(array)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper,
                                 monitor_all=self.monitor_all)
        self.exes.append(exe)

    def tic(self):
        """Start collecting when this batch is due."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End collecting: add the arguments' statistics and return
        [(step, name, "value[,value...]")]."""
        if not self.activated:
            return []
        for exe in self.exes:
            for name, array in exe.arg_dict.items():
                self.stat_helper(name, array)
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if not isinstance(v_list, list):
                v_list = [v_list]
            res.append((n, k, ",".join(str(_scalar(v)) for v in v_list)))
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
