"""Learning-rate schedulers (parity: python/mxnet/lr_scheduler.py).

The port's copy of ``mxnet_tpu/lr_scheduler.py``, which has no JAX in it:
the port imports nothing of the JAX package, so it keeps its own.
"""
from __future__ import annotations

import logging
import math

from .base import MXNetError


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (parity: lr_scheduler.FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise MXNetError("step must be >= 1")
        if factor > 1.0:
            raise MXNetError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: lr reached stop factor, freeze at %0.5e",
                             num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise MXNetError("step must be a non-empty list")
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise MXNetError("schedule steps must be increasing")
            if _step < 1:
                raise MXNetError("steps must be >= 1")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if max_update < 1:
            raise MXNetError("max_update must be >= 1")
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.power = pwr
        self.base_lr = self.base_lr_orig

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * pow(
                1.0 - float(num_update) / float(self.max_update), self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay (an addition of the JAX package; not in the 2017
    reference)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, warmup_steps=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.base_lr_orig = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.base_lr_orig * num_update / max(1, self.warmup_steps)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / max(
                1, self.max_update - self.warmup_steps)
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * frac)) / 2
        return self.final_lr
