"""Analytic model FLOPs and MFU (model-FLOPs utilisation) on NVIDIA cards.

PyTorch counterpart of the LM parts of :mod:`tpu_compressed_dp.utils.flops`:
model FLOPs are the model's forward + backward only (train = 3 x forward),
the decoder LM's closed form is ``6N + 12 L d s`` per token, and MFU is
quoted against the card's peak dense bf16 tensor-core rate whatever the
activation type (float32 runs show as lower MFU).  MFU is absent on the CPU
and for a card the table does not know, rather than quoted against a guessed
peak.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["transformer_train_flops_per_token", "device_peak_flops", "mfu",
           "throughput_record", "PEAK_FLOPS_BF16"]

# Peak dense bf16 FLOP/s per card (NVIDIA data sheets, without sparsity), by
# the prefix of torch.cuda.get_device_name().  The SXM part reports itself as
# "NVIDIA H100 80GB HBM3".
PEAK_FLOPS_BF16: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def transformer_train_flops_per_token(n_params: int, n_layers: int, d_model: int,
                                      seq_len: int) -> float:
    """``6N`` for the parameter matmuls (2N forward, 4N backward) plus
    ``12 L d s`` for the attention score and value matmuls (forward and
    backward, causal factor ignored), per token (PaLM appendix B)."""
    return 6.0 * n_params + 12.0 * n_layers * d_model * seq_len


def device_peak_flops(device=None) -> Optional[float]:
    """The card's peak dense bf16 FLOP/s, or None on the CPU or for a card
    not in :data:`PEAK_FLOPS_BF16`."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    best = None
    for prefix, peak in PEAK_FLOPS_BF16.items():
        if name.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), peak)
    return best[1] if best else None


def mfu(model_flops_per_sec: float, device=None) -> Optional[float]:
    """``model_flops_per_sec / peak`` — None where the peak is unknown."""
    peak = device_peak_flops(device)
    if not peak or model_flops_per_sec <= 0:
        return None
    return model_flops_per_sec / peak


def throughput_record(fwd_flops: Optional[float], steps_per_sec: float, *,
                      tokens_per_sec: Optional[float] = None, device=None
                      ) -> Dict[str, float]:
    """The throughput telemetry of one window: tokens/s, model TFLOP/s per
    card and MFU, from the per-card forward FLOPs of one step (MFU omitted
    where the peak is unknown)."""
    rec: Dict[str, float] = {}
    if tokens_per_sec is not None:
        rec["throughput/tokens_per_sec"] = tokens_per_sec
    if fwd_flops is None or steps_per_sec <= 0:
        return rec
    per_card = 3.0 * fwd_flops * steps_per_sec
    rec["throughput/model_tflops_per_chip"] = per_card / 1e12
    u = mfu(per_card, device)
    if u is not None:
        rec["throughput/mfu"] = u
    return rec
