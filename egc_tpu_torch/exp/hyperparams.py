"""Hyperparameter space primitives (a copy of ``egc_tpu.exp.hyperparams``,
numpy only; the exptune surface the reference's configs use: reference
``experiments/zinc/configs.py:194-199``, ``main.py:356-360``). Given the
same ``numpy`` generator, each samples what the JAX package's does."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


class HyperParam:
    def default(self):
        raise NotImplementedError

    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def grid(self, n: int):
        raise NotImplementedError


class ChoiceHyperParam(HyperParam):
    def __init__(self, choices: Sequence, default=None):
        self.choices = list(choices)
        self._default = default if default is not None else self.choices[0]

    def default(self):
        return self._default

    def sample(self, rng):
        return self.choices[int(rng.integers(0, len(self.choices)))]

    def grid(self, n: int):
        return list(self.choices)[:max(n, 1)] if n < len(self.choices) \
            else list(self.choices)


class UniformHyperParam(HyperParam):
    def __init__(self, low: float, high: float, default=None):
        self.low, self.high = float(low), float(high)
        self._default = default if default is not None else \
            0.5 * (self.low + self.high)

    def default(self):
        return self._default

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))

    def grid(self, n: int):
        return list(np.linspace(self.low, self.high, max(n, 1)))


class LogUniformHyperParam(HyperParam):
    def __init__(self, low: float, high: float, default=None):
        self.low, self.high = float(low), float(high)
        self._default = default if default is not None else \
            float(np.sqrt(self.low * self.high))

    def default(self):
        return self._default

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))

    def grid(self, n: int):
        return list(np.exp(np.linspace(np.log(self.low), np.log(self.high),
                                       max(n, 1))))


def default_hparams(space: Dict[str, HyperParam]) -> Dict[str, Any]:
    return {k: v.default() for k, v in space.items()}
