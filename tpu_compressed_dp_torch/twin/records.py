"""BENCH/MULTICHIP record loader: schema-validate the hand-shaped
``BENCH_r*.json`` / ``MULTICHIP_r*.json`` acceptance artifacts and
normalize them into the twin's calibration rows.

The files come in five shapes, all produced by the repo's own tooling:

  * **headline** (r01-r05): ``parsed`` is a single benchmark headline
    (``{metric, value, unit, ...}``) — validated, zero calibration rows
    (no step/payload decomposition to fit against)
  * **step** (r06): ``parsed`` is one full ``bench/sweep.py`` step record
  * **sweep** (r07/r08/r10/r11): ``records`` is a list of step records,
    optionally with ``phase_<name>_ms`` columns (``--phase_breakdown``)
  * **adaptive** (r09): ``records`` carry ``static_rungs`` /
    ``window_trace`` from the closed-loop controller runs — the timed
    ``static_rungs`` become step rows; ``window_trace`` rows are
    validated only (they mix compile/warmup walls into step_ms)
  * **stream** (r12): delta-stream segment records — validated only
    (byte accounting, no step times)

MULTICHIP files record dry-run verdicts (``{n_devices, rc, ok, ...}``)
with no timings: validated, zero calibration rows.

A **step row** carries the record's wall ``step_ms`` as target plus
per-fabric ``(count, per_chip_mb, hops)`` comm features derived from the
billed payload columns through the same schedule arithmetic the engines
use; its *context key* (model x method x knob x transport x topology x
pallas mode) gives the fitter a per-context compute term so rows that
differ only in repeat noise share one.  A **phase row** is a pure comm
equation — a ``--phase_breakdown`` comm phase's wall time against that
one collective's features, no compute term — and is what actually
identifies alpha/beta/gamma per fabric (``pallas off`` rows only: the
``force`` column times the kernel interpreter, not the wire).

Pure functions of file contents — no clocks.  The port's copy of
:mod:`tpu_compressed_dp.twin.records`: the schema constants and the
classifier are the JAX loader's, so both packages read a file alike.  The
context key has no device field, so records a port run writes belong
beside no CPU or TPU record they could share a compute term with.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_compressed_dp_torch.twin.model import (
    Collective, flat_schedule, hier_schedule, schedule_features,
)

__all__ = [
    "CalibRow", "RecordFile", "load_record_file", "discover_record_paths",
    "calibration_rows", "context_key", "step_row",
]

_STEP_REQUIRED = ("model", "method", "granularity", "mode", "devices",
                  "batch", "step_ms", "payload_mb_per_step", "transport")
_PAYLOAD_COLS = ("payload_mb_psum", "payload_mb_allgather",
                 "payload_mb_alltoall", "payload_mb_ici", "payload_mb_dcn")
_ADAPTIVE_REQUIRED = ("model", "method", "granularity", "mode", "knob",
                      "rungs", "window", "windows", "devices", "batch",
                      "static_rungs", "window_trace")
_RUNG_REQUIRED = ("rung", "value", "step_ms", "bits_per_update")
_STREAM_SEG_REQUIRED = ("seq", "kind", "step", "bytes", "nnz")
_MULTICHIP_REQUIRED = ("n_devices", "rc", "ok", "skipped")


@dataclasses.dataclass(frozen=True)
class CalibRow:
    """One calibration equation: per-fabric comm features against a wall
    target.  ``kind='step'`` rows add a per-context compute unknown keyed
    by ``context``; ``kind='phase'`` rows are comm-only."""

    source: str    # file basename
    index: int     # record position inside the file
    kind: str      # 'step' | 'phase'
    label: str     # human-readable row id for residual tables
    context: Optional[str]  # canonical context key (step rows)
    features: Dict[str, Tuple[float, float, float]]  # fabric -> (cnt,mb,hops)
    target_ms: float


@dataclasses.dataclass(frozen=True)
class RecordFile:
    """One validated artifact file."""

    source: str
    shape: str           # headline|step|sweep|adaptive|stream|multichip
    raw: dict
    rows: Tuple[CalibRow, ...]


def _err(source: str, msg: str) -> ValueError:
    return ValueError(f"{source}: {msg}")


def _require(d: dict, keys: Sequence[str], source: str, what: str) -> None:
    missing = [k for k in keys if k not in d]
    if missing:
        raise _err(source, f"{what} missing keys {missing}")


def _num(d: dict, key: str, source: str, minimum: float = None) -> float:
    v = d.get(key)
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        raise _err(source, f"{key} must be numeric, got {v!r}")
    if minimum is not None and v < minimum:
        raise _err(source, f"{key} must be >= {minimum}, got {v}")
    return float(v)


# ------------------------------------------------------------ step rows


def context_key(rec: dict) -> str:
    """Canonical compute-context key for a step record: everything that
    pins the non-comm step time.  Rows sharing a key share one fitted
    compute term, so repeat runs of the same config interpolate instead
    of each demanding its own unknown."""
    method = str(rec.get("method", "none"))
    knob = rec.get("rank") if method == "powersgd" else rec.get("ratio")
    parts = [
        f"model={rec.get('model')}",
        f"method={method}",
        f"gran={rec.get('granularity')}",
        f"mode={rec.get('mode')}",
        f"transport={rec.get('transport', 'psum')}",
        f"knob={knob}",
        f"devices={rec.get('devices')}",
        f"pods={rec.get('dp_pods', 1)}",
        f"batch={rec.get('batch')}",
        f"cs={rec.get('channels_scale', 1.0)}",
        f"pallas={rec.get('pallas_mode', 'off')}",
    ]
    return "|".join(parts)


def _hier_dcn_split(rec: dict, source: str) -> Tuple[float, float]:
    """Split a hierarchical record's billed ``payload_mb_dcn`` into
    (route_mb, return_mb) using the engine's own analytic payload ratio
    (``hier_payload_bits``), so the twin's route/return features match
    what actually rode the all_to_all vs the all_gather."""
    from tpu_compressed_dp_torch.ops.compressors import topk_keep_count
    from tpu_compressed_dp_torch.ops.wire_sharded import hier_payload_bits

    dcn_mb = float(rec.get("payload_mb_dcn", 0.0))
    if dcn_mb <= 0.0:
        return 0.0, 0.0
    dense_mb = rec.get("dense_mb_per_step")
    ratio = rec.get("ratio")
    if not dense_mb or not ratio:
        return dcn_mb, 0.0
    n = int(round(float(dense_mb) * 1e6 / 4.0))
    keep = topk_keep_count(n, float(ratio))
    _, route_bits, ret_bits = hier_payload_bits(
        n, keep, int(rec["devices"]), int(rec.get("dp_pods", 1)),
        1.25, 1.25)
    tot = route_bits + ret_bits
    if tot <= 0.0:
        return dcn_mb, 0.0
    return dcn_mb * route_bits / tot, dcn_mb * ret_bits / tot


def _step_schedule(rec: dict, source: str) -> List[Collective]:
    world = int(_num(rec, "devices", source, minimum=1))
    pods = int(rec.get("dp_pods", 1) or 1)
    count = float(rec.get("num_collectives", 1.0) or 1.0)
    if str(rec.get("transport")) == "hierarchical":
        route_mb, ret_mb = _hier_dcn_split(rec, source)
        return hier_schedule(
            world=world, pods=pods, count=count,
            ici_mb=float(rec.get("payload_mb_ici", 0.0)),
            dcn_route_mb=route_mb, dcn_return_mb=ret_mb)
    return flat_schedule(
        world=world, pods=pods, count=count,
        psum_mb=float(rec.get("payload_mb_psum", 0.0)),
        allgather_mb=float(rec.get("payload_mb_allgather", 0.0)),
        alltoall_mb=float(rec.get("payload_mb_alltoall", 0.0)))


def step_row(rec: dict, *, source: str, index: int) -> CalibRow:
    """Normalize one sweep step record into a calibration row."""
    _require(rec, _STEP_REQUIRED, source, f"step record {index}")
    for col in _PAYLOAD_COLS:
        if col in rec:
            _num(rec, col, source, minimum=0.0)
    target = _num(rec, "step_ms", source, minimum=0.0)
    label = "{}[{}] {} {} W={} pods={}".format(
        source, index, rec.get("transport"), rec.get("method"),
        rec.get("devices"), rec.get("dp_pods", 1))
    return CalibRow(
        source=source, index=index, kind="step", label=label,
        context=context_key(rec),
        features=schedule_features(_step_schedule(rec, source)),
        target_ms=target)


#: which ``phase_<name>_ms`` columns time a wire collective, per
#: transport — everything else (compress, ef, recompress, update, and the
#: sharded transport's local segment-sum 'reduce') is compute
_COMM_PHASES = {
    "all_gather": ("reduce",),
    "sharded": ("route", "return"),
    "hierarchical": ("ici_reduce", "route", "return"),
}


def _phase_rows(rec: dict, *, source: str, index: int) -> List[CalibRow]:
    if str(rec.get("pallas_mode", "off")) != "off":
        return []   # force rows time the kernel interpreter, not the wire
    transport = str(rec.get("transport"))
    names = _COMM_PHASES.get(transport, ())
    world = int(rec["devices"])
    pods = int(rec.get("dp_pods", 1) or 1)
    count = float(rec.get("num_collectives", 1.0) or 1.0)
    route_mb, ret_mb = (0.0, 0.0)
    if transport == "hierarchical":
        route_mb, ret_mb = _hier_dcn_split(rec, source)
    out: List[CalibRow] = []
    for name in names:
        col = f"phase_{name}_ms"
        if col not in rec:
            continue
        target = _num(rec, col, source, minimum=0.0)
        if transport == "all_gather" and name == "reduce":
            sched = flat_schedule(
                world=world, pods=pods, count=count,
                allgather_mb=float(rec.get("payload_mb_allgather", 0.0)))
        elif transport == "sharded" and name == "route":
            sched = flat_schedule(
                world=world, pods=pods, count=count,
                alltoall_mb=float(rec.get("payload_mb_alltoall", 0.0)))
        elif transport == "sharded" and name == "return":
            sched = flat_schedule(
                world=world, pods=pods, count=count,
                allgather_mb=float(rec.get("payload_mb_allgather", 0.0)))
        elif name == "ici_reduce":
            sched = hier_schedule(
                world=world, pods=pods, count=count,
                ici_mb=float(rec.get("payload_mb_ici", 0.0)))
            sched = [c for c in sched if c.fabric == "ici"]
        elif name == "route":
            sched = [Collective(
                fabric="dcn", count=count,
                per_chip_mb=(pods - 1) / pods * route_mb,
                hops=count * 1.0)] if pods > 1 else []
        else:   # hierarchical return
            sched = [Collective(
                fabric="dcn", count=count,
                per_chip_mb=(pods - 1) * ret_mb,
                hops=count * (pods - 1))] if pods > 1 else []
        if not sched:
            continue
        out.append(CalibRow(
            source=source, index=index, kind="phase",
            label=f"{source}[{index}] {transport} phase:{name}",
            context=None, features=schedule_features(sched),
            target_ms=target))
    return out


def _rung_row(rec: dict, rung: dict, *, source: str, index: int,
              rung_i: int) -> CalibRow:
    """A timed static rung from an adaptive record: the billed bits ride
    the simulate path's psum bucket (compressed payload, dense transport
    — exactly how ``bench/sweep.py --adaptive`` bills them)."""
    _require(rung, _RUNG_REQUIRED, source,
             f"record {index} static_rungs[{rung_i}]")
    world = int(rec["devices"])
    mb = _num(rung, "bits_per_update", source, minimum=0.0) / 8.0 / 1e6
    sched = flat_schedule(world=world, pods=int(rec.get("dp_pods", 1) or 1),
                          count=1.0, psum_mb=mb)
    knobbed = dict(rec)
    knobbed["transport"] = "psum"
    key = "rank" if rec.get("method") == "powersgd" else "ratio"
    knobbed[key] = rung["value"]
    return CalibRow(
        source=source, index=index, kind="step",
        label=f"{source}[{index}] static_rung{rung_i} "
              f"{rec.get('method')}={rung['value']}",
        context=context_key(knobbed),
        features=schedule_features(sched),
        target_ms=_num(rung, "step_ms", source, minimum=0.0))


# ------------------------------------------------------------ file level


def _classify(raw: dict, source: str) -> str:
    if source.startswith("MULTICHIP"):
        _require(raw, _MULTICHIP_REQUIRED, source, "multichip record")
        return "multichip"
    _require(raw, ("n", "cmd", "rc"), source, "bench artifact")
    recs = raw.get("records")
    if isinstance(recs, list) and recs:
        first = recs[0]
        if "static_rungs" in first:
            return "adaptive"
        if "seq" in first and "bytes" in first:
            return "stream"
        return "sweep"
    parsed = raw.get("parsed")
    if isinstance(parsed, dict) and "step_ms" in parsed:
        return "step"
    if isinstance(parsed, dict) and "metric" in parsed:
        return "headline"
    raise _err(source, "unrecognized artifact shape (no records list, no "
                       "parsed step record, no parsed headline)")


def load_record_file(path: str) -> RecordFile:
    """Load + schema-validate one artifact file; normalize whatever it
    contains into calibration rows (possibly none)."""
    source = os.path.basename(path)
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise _err(source, "top level must be a JSON object")
    shape = _classify(raw, source)
    rows: List[CalibRow] = []
    if shape == "headline":
        parsed = raw["parsed"]
        _require(parsed, ("metric", "value", "unit"), source, "headline")
        _num(parsed, "value", source)
    elif shape == "step":
        rows.append(step_row(raw["parsed"], source=source, index=0))
    elif shape == "sweep":
        for i, rec in enumerate(raw["records"]):
            rows.append(step_row(rec, source=source, index=i))
            rows.extend(_phase_rows(rec, source=source, index=i))
    elif shape == "adaptive":
        for i, rec in enumerate(raw["records"]):
            _require(rec, _ADAPTIVE_REQUIRED, source, f"adaptive record {i}")
            for j, rung in enumerate(rec["static_rungs"]):
                rows.append(_rung_row(rec, rung, source=source, index=i,
                                      rung_i=j))
            for j, w in enumerate(rec["window_trace"]):
                _require(w, ("window", "rung", "step_ms"), source,
                         f"record {i} window_trace[{j}]")
    elif shape == "stream":
        for i, seg in enumerate(raw["records"]):
            _require(seg, _STREAM_SEG_REQUIRED, source, f"segment {i}")
            _num(seg, "bytes", source, minimum=0.0)
    elif shape == "multichip":
        if not isinstance(raw.get("ok"), bool):
            raise _err(source, f"ok must be bool, got {raw.get('ok')!r}")
        _num(raw, "n_devices", source, minimum=1)
    return RecordFile(source=source, shape=shape, raw=raw, rows=tuple(rows))


def discover_record_paths(root: str) -> List[str]:
    """Every BENCH/MULTICHIP artifact under ``root``, sorted."""
    out = sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))
    out += sorted(glob.glob(os.path.join(root, "MULTICHIP_r*.json")))
    return out


def scaled_schedule(rec: dict, *, world: int, pods: int
                    ) -> List[Collective]:
    """The collective schedule one step record's config would emit at a
    DIFFERENT (world, pods) topology — the W-projection tables' engine.

    Sparse wire transports re-derive their payloads analytically (the
    sharded route/return and hierarchical splits genuinely depend on W
    and pods); dense psum and simulate rows keep their billed per-update
    payload (it is W-independent) and re-lay it on the new topology.
    """
    from tpu_compressed_dp_torch.twin.model import TwinPoint, schedule_for_point

    transport = str(rec.get("transport"))
    method = str(rec.get("method", "none"))
    sparse_wire = (rec.get("mode") == "wire" and method == "topk"
                   and transport in ("all_gather", "sharded",
                                     "hierarchical"))
    if sparse_wire and rec.get("dense_mb_per_step") and rec.get("ratio"):
        n = int(round(float(rec["dense_mb_per_step"]) * 1e6 / 4.0))
        return schedule_for_point(TwinPoint(
            world=world, transport=transport, n_params=n, dp_pods=pods,
            method=method, ratio=float(rec["ratio"]),
            num_collectives=float(rec.get("num_collectives", 1.0) or 1.0)))
    scaled = dict(rec)
    scaled["devices"] = world
    scaled["dp_pods"] = pods
    return _step_schedule(scaled, "scaled")


def calibration_rows(root_or_paths) -> List[CalibRow]:
    """All calibration rows from a records root dir (or explicit path
    list), in deterministic file-then-record order."""
    if isinstance(root_or_paths, str):
        paths = discover_record_paths(root_or_paths)
    else:
        paths = list(root_or_paths)
    rows: List[CalibRow] = []
    for p in paths:
        rows.extend(load_record_file(p).rows)
    return rows
