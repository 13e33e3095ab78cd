"""Training loggers: console table, TSV, tensorboard, files, metric averaging.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.utils.loggers`: the
CIFAR ``TableLogger`` (`CIFAR10/core.py:31-37`), ``TSVLogger``
(`dawn.py:89-96`, the DAWNBench submission format), the ImageNet
``AverageMeter`` (`IMAGENET/training/meter.py:4-22`), the master-only
``TensorboardLogger`` on ``torch.utils.tensorboard`` with scalar JSON
export and an examples-count x-axis (`logger.py:13-68`), the three-file
``FileLogger`` (verbose/event/debug, rank-prefixed console,
`logger.py:74-121`) and ``MetricAccumulator``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Dict, List, Optional

from tpu_compressed_dp_torch.obs import registry as obs_registry

__all__ = ["TableLogger", "TSVLogger", "AverageMeter", "MetricAccumulator",
           "TensorboardLogger", "FileLogger", "NoOp"]


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


class AverageMeter:
    """Running value/average/smoothed view (`meter.py:4-22`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.smooth_avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.smooth_avg = val if self.count == n else self.smooth_avg * 0.9 + val * 0.1
        self.avg = self.sum / self.count


class NoOp:
    """Absorbing sink for non-master ranks (`logger.py:124-127`)."""

    def __getattr__(self, name):
        def noop(*args, **kwargs):
            return None

        return noop


class TensorboardLogger:
    """Master-only tensorboard writer, x-axis in cumulative *examples*
    (`logger.py:24-34`: "Tensorboard is easier to parse if global_step is
    examples seen"); scalars mirrored to a JSON file on close
    (`logger.py:36-38`).  Instantiate on every rank — non-master ranks get a
    no-op (the reference gated identically)."""

    def __new__(cls, output_dir: Optional[str], is_master: bool = True):
        if not output_dir or not is_master:
            return NoOp()
        return super().__new__(cls)

    def __init__(self, output_dir: str, is_master: bool = True):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(output_dir, exist_ok=True)
        self.writer = SummaryWriter(output_dir)
        self.output_dir = output_dir
        self.examples = 0
        self.scalars: Dict[str, List] = {}

    def update_examples_count(self, n: int) -> None:
        self.examples += int(n)

    def log_scalar(self, tag: str, value: float, step: Optional[int] = None) -> None:
        step = self.examples if step is None else step
        self.writer.add_scalar(tag, value, step)
        self.scalars.setdefault(tag, []).append([step, float(value)])

    def log_metrics(self, metrics: Dict[str, float], prefix: str = "") -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self.log_scalar(prefix + k, v)

    def close(self) -> None:
        with open(os.path.join(self.output_dir, "scalars.json"), "w") as f:
            json.dump(self.scalars, f)
        self.writer.close()


class FileLogger:
    """Three-file logger + rank-prefixed console (`logger.py:74-121`):
    ``verbose.log`` (INFO+), ``event.log`` (WARN+ — the ``~~epoch`` summary
    lines go here via :meth:`event`), ``debug.log`` (DEBUG+ with
    timestamps).  Only the master rank writes files; every rank prints."""

    def __init__(self, output_dir: Optional[str], rank: int = 0,
                 is_master: bool = True):
        self.rank = rank
        self.logger = logging.getLogger(f"tpu_compressed_dp_torch.r{rank}")
        self.logger.setLevel(logging.DEBUG)
        for h in self.logger.handlers:     # a second run in one process
            h.close()
        self.logger.handlers = []
        self.logger.propagate = False
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        console.setFormatter(logging.Formatter(f"{rank}: %(message)s"))
        self.logger.addHandler(console)
        if output_dir and is_master:
            os.makedirs(output_dir, exist_ok=True)
            for fname, level, fmt in [
                ("verbose.log", logging.INFO, "%(message)s"),
                ("event.log", logging.WARNING, "%(message)s"),
                ("debug.log", logging.DEBUG, "%(asctime)s %(levelname)s %(message)s"),
            ]:
                h = logging.FileHandler(os.path.join(output_dir, fname))
                h.setLevel(level)
                h.setFormatter(logging.Formatter(fmt))
                self.logger.addHandler(h)

    def debug(self, msg: str) -> None:
        self.logger.debug(msg)

    def info(self, msg: str) -> None:
        self.logger.info(msg)

    def event(self, msg: str) -> None:
        """Epoch-summary channel (reference logs these at WARN so they land
        in event.log, `train_imagenet_nv.py:232,243`)."""
        self.logger.warning(msg)


class MetricAccumulator:
    """Per-step metric dicts (already world-reduced) -> epoch means/sums."""

    #: keys that are world sums per step (every other key is averaged with
    #: the step's example count as weight), derived from the metric
    #: registry's declared reductions: a new sum-reduced metric joins
    #: automatically
    SUM_KEYS = frozenset(name for name, ms in obs_registry.REGISTRY.items()
                         if ms.reduction == "sum")

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

    def sum(self, key: str) -> float:
        return self.sums[key]
