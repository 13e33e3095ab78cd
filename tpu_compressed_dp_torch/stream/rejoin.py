"""Warm rejoin: adopt the parameters from the delta stream instead of the
survivors' broadcast.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.stream.rejoin`.  A
joiner at the rendezvous barrier normally takes the FULL parameters from
the coordinator's broadcast.  When a stream directory is live,
:func:`warm_rejoin` tails it with a
:class:`~tpu_compressed_dp_torch.stream.reader.StreamReader` and copies the
reconstruction into the joiner's model in place, moving only keyframe +
deltas over the shared directory.

Correctness leans on the survivors' side of the protocol: the coordinator
calls :meth:`StreamWriter.sync` at the rejoin barrier (a window-closing
flush), so by the time the joiner's catch-up runs the stream head
reconstructs to the live parameters *bitwise* and the barrier's broadcast
skips them.  An absent, corrupt or unanchored stream returns ``(state,
None)`` and the caller joins cold (the reference's protocol; the flight
recorder gets ``warm_rejoin_fallback``), never with a half-adopted state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from tpu_compressed_dp_torch.stream.delta import param_dict
from tpu_compressed_dp_torch.stream.reader import StreamReader
from tpu_compressed_dp_torch.stream.store import StreamCorrupt, is_stream_dir

__all__ = ["warm_rejoin", "adopt_params"]


@torch.no_grad()
def adopt_params(model, params: Mapping[str, torch.Tensor]) -> None:
    """Copy ``{param_leaves key: tensor}`` (the port's layout) into
    ``model``'s parameters in place; a parameter that already is the given
    tensor is left alone."""
    for key, p in param_dict(model).items():
        src = params[key]
        if src is not p:
            p.copy_(src)


def warm_rejoin(state, stream_dir: str, *, log=print, flight=None
                ) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """Catch ``state.model``'s parameters up from the segment stream, in
    place.  Returns ``(state, info)``: ``info`` is None when the stream is
    absent, corrupt or not anchored (the model is then untouched and the
    caller joins cold), else ``{"bytes", "segments", "step", "seq",
    "exact"}`` for the rejoin accounting."""
    if not is_stream_dir(stream_dir):
        return state, None
    reader = StreamReader(stream_dir, log=log)
    try:
        reader.catch_up()
        params = reader.params_like(state.model)
    except (StreamCorrupt, ValueError) as e:
        log(f"[stream] warm rejoin unavailable ({e}); falling back to full restore")
        if flight is not None:
            try:
                flight.record("stream", "warm_rejoin_fallback", error=repr(e))
            except Exception:
                pass
        return state, None
    adopt_params(state.model, params)
    info = {
        "bytes": int(reader.bytes_read),
        "segments": int(reader.segments_applied),
        "step": int(reader.applied_step),
        "seq": int(reader.applied_seq),
        "exact": bool(reader.exact),
    }
    if flight is not None:
        try:
            flight.record("stream", "warm_rejoin", **info)
        except Exception:
            pass
    log(f"[stream] warm rejoin: adopted step {info['step']} from {info['segments']} "
        f"segments ({info['bytes']} bytes, exact={info['exact']})")
    return state, info
