"""Monitor, per-output statistics for debugging: the port of
`mxnet_tpu/monitor.py` (parity `python/mxnet/monitor.py`). An executor with
a monitor installed calls `stat_helper` with each output of its forward;
a module with one runs the eager step, never the fused one."""
from __future__ import annotations

import logging
import re

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        if stat_func is None:
            def asum_stat(x):
                return x.norm() / (x.size ** 0.5)

            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all

    def stat_helper(self, name, value):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(value)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper, self.monitor_all)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        res = []
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            for v in v_list:
                res.append((n, k, str(v.asscalar() if v.size == 1
                                      else v.asnumpy())))
        if self.sort:
            res = sorted(res, key=lambda x: x[1])
        self.queue = []
        return res

    def toc_print(self):
        logger = logging.getLogger("mxnet_tpu_torch.monitor")
        for n, k, v in self.toc():
            logger.info("Batch: %7d %30s %s", n, k, v)
