"""Training loggers: console table, DAWNBench TSV, epoch metric averaging.

PyTorch-port counterpart of the parts of :mod:`tpu_compressed_dp.utils.loggers`
the CIFAR harness uses (``TableLogger``, ``TSVLogger``,
``MetricAccumulator``).
"""

from __future__ import annotations

import os
from typing import Dict, List

__all__ = ["TableLogger", "TSVLogger", "MetricAccumulator"]


class TableLogger:
    """Fixed-width console table; columns locked to the first row's keys."""

    def append(self, output: Dict) -> None:
        if not hasattr(self, "keys"):
            self.keys = list(output.keys())
            print(*(f"{k:>12s}" for k in self.keys))
        filtered = [output.get(k) for k in self.keys]
        print(*(f"{v:12.4f}" if isinstance(v, float) else f"{v!s:>12}" for v in filtered))


class TSVLogger:
    """DAWNBench ``epoch\\thours\\ttop1Accuracy`` log (`dawn.py:89-96`)."""

    def __init__(self):
        self.log: List[str] = ["epoch\thours\ttop1Accuracy"]

    def append(self, output: Dict) -> None:
        hours = output["total time"] / 3600
        self.log.append(f"{output['epoch']}\t{hours:.8f}\t{output['test acc'] * 100:.2f}")

    def save(self, log_dir: str, name: str = "logs.tsv") -> str:
        log_dir = os.path.expanduser(log_dir)
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, name)
        with open(path, "w") as f:
            f.write(str(self))
        return path

    def __str__(self) -> str:
        return "\n".join(self.log)


class MetricAccumulator:
    """Per-step metric dicts (already world-reduced) -> epoch means/sums."""

    #: keys that are world sums per step (the JAX metric registry's
    #: sum-reduced keys); every other key is averaged with the step's
    #: example count as weight
    SUM_KEYS = frozenset({"correct", "correct5", "count", "loss_sum", "tokens"})

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.weights: Dict[str, float] = {}
        #: the newest value of each key: the honest summary of cumulative or
        #: stateful metrics (``guard/skipped``, ``guard/loss_scale``)
        self.last: Dict[str, float] = {}
        self.steps: int = 0

    def update(self, metrics: Dict[str, float]) -> None:
        self.steps += 1
        w = float(metrics.get("count", 1.0))
        for k, v in metrics.items():
            v = float(v)
            self.last[k] = v
            if k in self.SUM_KEYS:
                self.sums[k] = self.sums.get(k, 0.0) + v
            else:
                self.sums[k] = self.sums.get(k, 0.0) + v * w
                self.weights[k] = self.weights.get(k, 0.0) + w

    def mean(self, key: str) -> float:
        if key in self.SUM_KEYS:
            return self.sums[key] / max(self.sums.get("count", 1.0), 1e-12)
        return self.sums[key] / max(self.weights[key], 1e-12)
