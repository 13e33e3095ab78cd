"""The scale-out digital twin: a calibrated per-fabric alpha/beta/gamma
cost model over the collective schedules the transports actually emit,
fitted from BENCH/MULTICHIP sweep records.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.twin`, numpy only: the
same float64 arithmetic in the same order, so a fit, a price and a gate
verdict agree bit for bit with the JAX package's on the same records.

  * :mod:`~tpu_compressed_dp_torch.twin.model`      the cost model + forward
    payload/schedule derivation (predict any (W, pods, transport,
    method, knob) point)
  * :mod:`~tpu_compressed_dp_torch.twin.records`    BENCH/MULTICHIP loader ->
    calibration rows
  * :mod:`~tpu_compressed_dp_torch.twin.calibrate`  least-squares fitter with
    per-row residuals
  * :mod:`~tpu_compressed_dp_torch.twin.gate`       the modeled-perf
    ratchet over a pins file

Every module is replay-deterministic: fits and predictions are pure
functions of the records they read.
"""

from tpu_compressed_dp_torch.twin.calibrate import (        # noqa: F401
    Calibration, Residual, fit, load_calibration, save_calibration,
)
from tpu_compressed_dp_torch.twin.gate import (             # noqa: F401
    PinResult, check_pins, load_pins, make_pin, price_pin,
)
from tpu_compressed_dp_torch.twin.model import (            # noqa: F401
    Collective, CostModel, FabricParams, TwinPoint,
    UncalibratedFabricError, predict_step_ms, schedule_for_point,
)
from tpu_compressed_dp_torch.twin.records import (          # noqa: F401
    CalibRow, RecordFile, calibration_rows, discover_record_paths,
    load_record_file,
)

__all__ = [
    "Calibration", "Residual", "fit", "load_calibration",
    "save_calibration", "PinResult", "check_pins", "load_pins", "make_pin",
    "price_pin", "Collective", "CostModel", "FabricParams", "TwinPoint",
    "UncalibratedFabricError", "predict_step_ms", "schedule_for_point",
    "CalibRow", "RecordFile", "calibration_rows", "discover_record_paths",
    "load_record_file",
]
