"""Learning-rate schedulers (ref: python/mxnet/lr_scheduler.py).

Counterpart: ``mxnet_tpu/lr_scheduler.py``, a copy.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates (ref: lr_scheduler.py FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0
        self._cur_lr = self.base_lr

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self._cur_lr = max(self._cur_lr * self.factor, self.stop_factor_lr)
        return self._cur_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each listed step (ref: MultiFactorScheduler)."""

    def __init__(self, step, factor=1.0, base_lr=0.01):
        super().__init__(base_lr)
        self.step = list(step)
        self.factor = factor
        self.cur_step_ind = 0
        self._cur_lr = self.base_lr

    def __call__(self, num_update):
        while self.cur_step_ind < len(self.step) and num_update > self.step[self.cur_step_ind]:
            self._cur_lr *= self.factor
            self.cur_step_ind += 1
        return self._cur_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update >= self.max_update:
            return self.final_lr
        frac = 1.0 - num_update / self.max_update
        return self.final_lr + (self.base_lr - self.final_lr) * (frac ** self.power)


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            inc = (self.base_lr - self.warmup_begin_lr) / max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc * num_update
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * (
            1 + math.cos(math.pi * frac)
        ) / 2
