"""The modeled-performance gate: pinned flagship configs re-priced
through the current twin (the port's copy of
:mod:`tpu_compressed_dp.twin.gate`).

A pins file pins a handful of flagship (W, pods, transport, method, knob)
points with the step time the twin modeled when the pin was minted.  The
gate re-fits the calibration from the records (a deterministic function
of the files) and re-prices every pin through the CURRENT model code: a
change to the schedule arithmetic, the payload functions or the fitter
that inflates a flagship's modeled step time by more than the pin's
tolerance fails the gate — the raw-speed ratchet.  Modeled-time DROPS
beyond tolerance don't fail (faster is what we want) but are flagged
stale so the pin gets re-minted (``harness/twin_report.py
--update_pins``).

Deterministic: pure function of the pins file + records.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from tpu_compressed_dp_torch.twin.calibrate import Calibration
from tpu_compressed_dp_torch.twin.model import TwinPoint, predict_step_ms

__all__ = ["PinResult", "load_pins", "price_pin", "check_pins",
           "make_pin", "DEFAULT_TOL_FRAC"]

DEFAULT_TOL_FRAC = 0.10

_POINT_KEYS = ("world", "transport", "n_params", "dp_pods", "method",
               "ratio", "num_collectives", "hideable_fraction")


@dataclasses.dataclass(frozen=True)
class PinResult:
    """One pin's verdict after re-pricing through the current model."""

    name: str
    pinned_ms: float
    modeled_ms: Optional[float]
    tol_frac: float
    ok: bool
    note: str

    @property
    def frac_change(self) -> Optional[float]:
        if self.modeled_ms is None:
            return None
        return (self.modeled_ms - self.pinned_ms) / max(self.pinned_ms, 1e-9)


def load_pins(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    pins = doc.get("pins")
    if not isinstance(pins, list) or not pins:
        raise ValueError(f"{path}: expected a non-empty 'pins' list")
    for i, pin in enumerate(pins):
        for key in ("name", "point", "context", "modeled_step_ms"):
            if key not in pin:
                raise ValueError(f"{path}: pins[{i}] missing {key!r}")
    return doc


def _pin_point(pin: dict, calib: Calibration) -> TwinPoint:
    ctx = pin["context"]
    if ctx not in calib.contexts:
        raise KeyError(
            f"pin {pin['name']!r}: context {ctx!r} not in the calibration "
            "(its source record vanished?)")
    kwargs = {k: v for k, v in pin["point"].items() if k in _POINT_KEYS}
    return TwinPoint(compute_ms=calib.contexts[ctx], **kwargs)


def price_pin(pin: dict, calib: Calibration) -> float:
    """The pin's config priced through the CURRENT model + calibration."""
    return predict_step_ms(calib.model, _pin_point(pin, calib))


def check_pins(doc: dict, calib: Calibration) -> List[PinResult]:
    """Re-price every pin; a result is not-ok on a modeled regression
    beyond tolerance OR when the pin can no longer be priced at all."""
    default_tol = float(doc.get("tolerance_frac", DEFAULT_TOL_FRAC))
    out: List[PinResult] = []
    for pin in doc["pins"]:
        tol = float(pin.get("tol_frac", default_tol))
        pinned = float(pin["modeled_step_ms"])
        try:
            modeled = price_pin(pin, calib)
        except (KeyError, ValueError) as e:
            out.append(PinResult(name=pin["name"], pinned_ms=pinned,
                                 modeled_ms=None, tol_frac=tol, ok=False,
                                 note=f"unpriceable: {e}"))
            continue
        frac = (modeled - pinned) / max(pinned, 1e-9)
        if frac > tol:
            ok, note = False, f"modeled regression {frac:+.1%} > {tol:.0%}"
        elif frac < -tol:
            ok, note = True, f"stale pin ({frac:+.1%}) — re-mint it"
        else:
            ok, note = True, "within tolerance"
        out.append(PinResult(name=pin["name"], pinned_ms=pinned,
                             modeled_ms=modeled, tol_frac=tol, ok=ok,
                             note=note))
    return out


def make_pin(name: str, point: Dict, context: str, calib: Calibration,
             tol_frac: float = DEFAULT_TOL_FRAC) -> dict:
    """Mint one pin at the CURRENT modeled price (the update procedure
    ``harness/twin_report.py --update_pins`` runs for every existing pin)."""
    pin = {"name": name, "point": dict(point), "context": context,
           "modeled_step_ms": 0.0, "tol_frac": tol_frac}
    pin["modeled_step_ms"] = round(price_pin(pin, calib), 3)
    return pin
