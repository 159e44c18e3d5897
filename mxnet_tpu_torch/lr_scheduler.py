"""Learning-rate schedules: the port of `mxnet_tpu/lr_scheduler.py`
(parity `python/mxnet/lr_scheduler.py`): factor, multi-factor, polynomial
and cosine decay, each with a linear or constant warm-up. A scheduler is
called with the update count and returns the learning rate."""
from __future__ import annotations

from math import cos, pi

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """The base: ``base_lr`` and the warm-up from ``warmup_begin_lr`` over
    ``warmup_steps`` updates."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        if warmup_steps < 0:
            raise ValueError("warmup_steps should be positive or 0")
        self.warmup_steps = warmup_steps
        self.warmup_final_lr = base_lr
        self.warmup_begin_lr = warmup_begin_lr
        if self.warmup_begin_lr > self.warmup_final_lr:
            raise ValueError(
                "warmup_begin_lr should be smaller than warmup_final_lr")
        if warmup_mode not in ("linear", "constant"):
            raise ValueError(
                "Supports only linear and constant modes of warmup")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if num_update >= self.warmup_steps:
            raise ValueError("get_warmup_lr past the warm-up")
        if self.warmup_mode == "linear":
            increase = (self.warmup_final_lr - self.warmup_begin_lr) \
                * float(num_update) / float(self.warmup_steps)
            return self.warmup_begin_lr + increase
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr times ``factor`` every ``step`` updates, not below
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError(
                "Schedule step must be greater or equal than 1 round")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr times ``factor`` after each update count in ``step``."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or len(step) < 1:
            raise ValueError("step must be a non-empty list")
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError(
                    "Schedule step must be an increasing integer list")
            if _step < 1:
                raise ValueError(
                    "Schedule step must be greater or equal than 1 round")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """final_lr + (base_lr - final_lr) * (1 - t / T)^pwr after the
    warm-up, T = max_update - warmup_steps."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError(
                "maximum number of updates must be strictly positive")
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (
                self.base_lr_orig - self.final_lr) * pow(
                    1 - float(num_update - self.warmup_steps)
                    / float(self.max_steps), self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """final_lr + (base_lr - final_lr) * (1 + cos(pi t / T)) / 2 after the
    warm-up."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError(
                "maximum number of updates must be strictly positive")
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (
                self.base_lr_orig - self.final_lr) * (
                    1 + cos(pi * (num_update - self.warmup_steps)
                            / self.max_steps)) / 2
        return self.base_lr
