"""Training callbacks: the port of `mxnet_tpu/callback.py` (parity
`python/mxnet/callback.py`): module_checkpoint, do_checkpoint,
log_train_metric, Speedometer, ProgressBar, LogValidationMetricsCallback.
`Speedometer` also logs the step latency's p50 / p99 (``step_stats``,
with telemetry on) and the worst step of the interval with its slowest
phase (the flight recorder, with tracing on)."""
from __future__ import annotations

import logging
import math
import sys
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def _logger():
    return logging.getLogger("mxnet_tpu_torch.callback")


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint

            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                _logger().info("Iter[%d] Batch[%d] Train-%s=%f",
                               param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Logs samples a second every ``frequent`` batches, with the step
    latency's p50 / p99 and the interval's worst step where the planes
    are on (``worst_step`` keeps that tree)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset
        self.worst_step = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        try:
            speed = self.frequent * self.batch_size / (time.time() - self.tic)
        except ZeroDivisionError:
            speed = float("inf")
        # the quantile sort runs here, once a log tick
        stats = getattr(param, "step_stats", None)
        lat, lat_args = "", ()
        if stats and stats.get("hist") is not None:
            p50_us, p99_us = stats["hist"].quantiles(50, 99)
            if p50_us is not None:
                lat = "\tstep-p50: %.1f ms\tstep-p99: %.1f ms"
                lat_args = (p50_us / 1e3, p99_us / 1e3)
        from . import tracing

        if tracing._enabled:
            # this interval's worst step tree, its slowest phase named
            worst = tracing.flight_recorder.worst(reset=True)
            if worst is not None:
                self.worst_step = worst
                kids = worst.get("children") or []
                if kids:
                    slow = max(kids, key=lambda c: c.get("dur") or 0)
                    lat += "\tworst-step: %.1f ms (%s %.1f ms)"
                    lat_args += ((worst.get("dur") or 0) / 1e3, slow["name"],
                                 (slow.get("dur") or 0) / 1e3)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            _logger().info(msg + lat, param.epoch, count, speed,
                           *(sum(name_value, ()) + lat_args))
        else:
            _logger().info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                           + lat, param.epoch, count, speed, *lat_args)
        self.tic = time.time()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write(f"[{prog_bar}] {percents}%\r")


class LogValidationMetricsCallback:
    """Logs the validation metrics at each epoch's end."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            _logger().info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                           value)
