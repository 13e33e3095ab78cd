"""Least-squares calibration of the twin's per-fabric alpha/beta/gamma.

The joint system solved: each **step row** contributes

    step_ms  =  compute[context]  +  sum_f (alpha_f*cnt + beta_f*mb
                                            + gamma_f*hops)

with one ``compute[context]`` unknown per context key (repeat runs of the
same config share it); each **phase row** contributes the pure comm
equation (no compute term).  The phase rows are what identify the fabric
vector — inside one context every step row carries identical comm
features, so step rows pin the compute terms and bound the residuals by
their within-context repeat spread.

Solved with ``numpy.linalg.lstsq``, then clipped to physical range by an
active-set pass (a negative alpha/beta/gamma is noise, not a wire that
pays you): the most negative fabric coordinate is fixed to zero and the
rest refit, until all are non-negative.  Compute terms are then re-solved
exactly as ``mean(target - comm_pred)`` per context, so clipping never
leaks error into the step rows.

Per-row residuals are first-class output — ``twin_report.py`` renders
them and the JAX package's tests assert every step row of the committed
records lands within 15%.

Deterministic: pure function of the rows.  The port's copy of
:mod:`tpu_compressed_dp.twin.calibrate`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_compressed_dp_torch.twin.model import CostModel, FabricParams
from tpu_compressed_dp_torch.twin.records import CalibRow

__all__ = ["Residual", "Calibration", "fit", "load_calibration",
           "save_calibration"]

_PARAMS_PER_FABRIC = 3   # alpha, beta, gamma


@dataclasses.dataclass(frozen=True)
class Residual:
    """One row's modeled-vs-measured verdict."""

    source: str
    index: int
    kind: str
    label: str
    measured_ms: float
    modeled_ms: float

    @property
    def err_frac(self) -> float:
        return (self.modeled_ms - self.measured_ms) / max(
            self.measured_ms, 1e-9)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A fitted twin: per-fabric params, per-context compute anchors, and
    the per-row residual table the fit left behind."""

    fabrics: Dict[str, FabricParams]
    contexts: Dict[str, float]          # context key -> compute ms
    residuals: Tuple[Residual, ...]
    n_step_rows: int
    n_phase_rows: int

    @property
    def model(self) -> CostModel:
        return CostModel(fabrics=self.fabrics)

    @property
    def step_rms_frac(self) -> float:
        """RMS relative error over the step rows — the error bar quoted
        next to every prediction (``pred_step_ms`` +/- rms * pred)."""
        fracs = [r.err_frac for r in self.residuals if r.kind == "step"]
        if not fracs:
            return 0.0
        return float(np.sqrt(np.mean(np.square(fracs))))

    def comm_ms_for(self, row: CalibRow) -> float:
        """Price one row's comm features through the fitted fabrics."""
        total = 0.0
        for fab, (cnt, mb, hops) in row.features.items():
            p = self.fabrics.get(fab, FabricParams())
            total += (cnt * p.alpha_ms + mb * p.beta_ms_per_mb
                      + hops * p.gamma_ms_per_hop)
        return total

    def predict_row_ms(self, row: CalibRow) -> Optional[float]:
        """Modeled wall for a calibration row; None when a step row's
        context was never fitted."""
        comm = self.comm_ms_for(row)
        if row.kind != "step":
            return comm
        if row.context not in self.contexts:
            return None
        return self.contexts[row.context] + comm

    def to_json(self) -> dict:
        return {
            "fabrics": {f: p.to_json() for f, p in self.fabrics.items()},
            "contexts": dict(self.contexts),
            "n_step_rows": self.n_step_rows,
            "n_phase_rows": self.n_phase_rows,
            "residuals": [dataclasses.asdict(r) for r in self.residuals],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Calibration":
        return cls(
            fabrics={f: FabricParams.from_json(p)
                     for f, p in d["fabrics"].items()},
            contexts={k: float(v) for k, v in d["contexts"].items()},
            residuals=tuple(Residual(**r) for r in d.get("residuals", [])),
            n_step_rows=int(d["n_step_rows"]),
            n_phase_rows=int(d["n_phase_rows"]))


def _design(rows: Sequence[CalibRow], contexts: List[str],
            fabrics: List[str], free: Dict[Tuple[str, int], int]
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Design matrix: one indicator column per context + the still-free
    fabric coordinates (``free`` maps (fabric, param_i) -> column)."""
    ctx_col = {c: i for i, c in enumerate(contexts)}
    n_cols = len(contexts) + len(free)
    a = np.zeros((len(rows), n_cols))
    b = np.zeros(len(rows))
    for ri, row in enumerate(rows):
        b[ri] = row.target_ms
        if row.kind == "step":
            a[ri, ctx_col[row.context]] = 1.0
        for fab, feats in row.features.items():
            for pi in range(_PARAMS_PER_FABRIC):
                col = free.get((fab, pi))
                if col is not None:
                    a[ri, len(contexts) + col] = feats[pi]
    return a, b


def fit(rows: Sequence[CalibRow]) -> Calibration:
    """Fit alpha/beta/gamma per fabric + a compute term per context from
    normalized calibration rows."""
    rows = list(rows)
    if not rows:
        raise ValueError("no calibration rows — nothing to fit")
    contexts = sorted({r.context for r in rows if r.kind == "step"})
    fabrics = sorted({f for r in rows for f in r.features})
    fabric_rows = {f: sum(1 for r in rows if f in r.features)
                   for f in fabrics}

    # active-set least squares: drop (zero) the most negative fabric
    # coordinate and refit until all remaining ones are non-negative
    free = {(f, pi): i for i, (f, pi) in enumerate(
        (f, pi) for f in fabrics for pi in range(_PARAMS_PER_FABRIC))}
    fixed: Dict[Tuple[str, int], float] = {}
    sol = np.zeros(0)
    while True:
        free = {k: i for i, k in enumerate(sorted(free))}
        a, b = _design(rows, contexts, fabrics, free)
        sol, *_ = np.linalg.lstsq(a, b, rcond=None)
        fab_part = {k: float(sol[len(contexts) + i])
                    for k, i in free.items()}
        neg = [(v, k) for k, v in fab_part.items() if v < -1e-9]
        if not neg:
            break
        _, worst = min(neg)
        fixed[worst] = 0.0
        del free[worst]

    params: Dict[str, FabricParams] = {}
    for f in fabrics:
        vals = []
        for pi in range(_PARAMS_PER_FABRIC):
            if (f, pi) in free:
                vals.append(max(0.0, float(sol[len(contexts)
                                              + free[(f, pi)]])))
            else:
                vals.append(fixed.get((f, pi), 0.0))
        params[f] = FabricParams(alpha_ms=vals[0], beta_ms_per_mb=vals[1],
                                 gamma_ms_per_hop=vals[2],
                                 rows=fabric_rows[f])

    # re-solve compute terms exactly against the clipped fabric vector
    partial = Calibration(fabrics=params, contexts={}, residuals=(),
                          n_step_rows=0, n_phase_rows=0)
    ctx_ms: Dict[str, float] = {}
    for ctx in contexts:
        gaps = [r.target_ms - partial.comm_ms_for(r)
                for r in rows if r.kind == "step" and r.context == ctx]
        ctx_ms[ctx] = float(np.mean(gaps))

    calib = Calibration(
        fabrics=params, contexts=ctx_ms, residuals=(),
        n_step_rows=sum(1 for r in rows if r.kind == "step"),
        n_phase_rows=sum(1 for r in rows if r.kind == "phase"))
    residuals = tuple(
        Residual(source=r.source, index=r.index, kind=r.kind, label=r.label,
                 measured_ms=r.target_ms,
                 modeled_ms=float(calib.predict_row_ms(r)))
        for r in rows)
    return dataclasses.replace(calib, residuals=residuals)


def save_calibration(calib: Calibration, path: str) -> None:
    with open(path, "w") as f:
        json.dump(calib.to_json(), f, indent=1, sort_keys=True)


def load_calibration(path: str) -> Calibration:
    with open(path) as f:
        return Calibration.from_json(json.load(f))
