"""Analytic model FLOPs and MFU (model-FLOPs utilisation) on NVIDIA cards.

PyTorch counterpart of :mod:`tpu_compressed_dp.utils.flops`: model FLOPs
are the model's forward + backward only (train = 3 x forward), the decoder
LM's closed form is ``6N + 12 L d s`` per token, and a CNN's forward is
counted from its convolutions' and matmuls' multiply-adds
(:func:`cnn_fwd_flops`, where the JAX package reads XLA's cost model).  MFU
is quoted against the card's peak dense rate for the compute type: bf16
tensor cores (the default, which the LM quotes whatever its activations),
or float32 outside the tensor cores.  MFU is absent on the CPU and for a
card the table does not know, rather than quoted against a guessed peak.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["transformer_train_flops_per_token", "cnn_fwd_flops", "device_peak_flops", "mfu",
           "throughput_record", "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32"]

# Peak dense bf16 FLOP/s per card (NVIDIA data sheets, without sparsity), by
# the prefix of torch.cuda.get_device_name().  The SXM part reports itself as
# "NVIDIA H100 80GB HBM3".
PEAK_FLOPS_BF16: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
}
# float32 outside the tensor cores (the port keeps TF32 off)
PEAK_FLOPS_FP32: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 67e12,
}


def transformer_train_flops_per_token(n_params: int, n_layers: int, d_model: int,
                                      seq_len: int) -> float:
    """``6N`` for the parameter matmuls (2N forward, 4N backward) plus
    ``12 L d s`` for the attention score and value matmuls (forward and
    backward, causal factor ignored), per token (PaLM appendix B)."""
    return 6.0 * n_params + 12.0 * n_layers * d_model * seq_len


class _MacCounter(TorchFunctionMode):
    """Counts the multiply-adds of every ``conv2d`` and ``linear`` call made
    under it, from the output's and the weight's shapes."""

    def __init__(self):
        super().__init__()
        self.macs = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (F.conv2d, torch.conv2d):
            w = args[1] if len(args) > 1 else kwargs["weight"]
            # per output element: in_channels / groups x kh x kw
            self.macs += out.numel() * w[0].numel()
        elif func is F.linear:
            w = args[1] if len(args) > 1 else kwargs["weight"]
            self.macs += out.numel() * w.shape[-1]
        return out


@torch.no_grad()
def cnn_fwd_flops(model, input_shape, device=None) -> float:
    """Forward FLOPs (2 per multiply-add of the convolutions and matmuls) of
    ``model`` on one input of ``input_shape`` (NHWC, the batch dimension
    included), counted in an eval-mode forward of zeros (BatchNorm's running
    statistics stay as they are; elementwise work, pooling and BatchNorm are
    not counted)."""
    if device is None:
        device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    counter = _MacCounter()
    try:
        with counter:
            model(torch.zeros(input_shape, device=device), train=False)
    finally:
        model.train(was_training)
    return 2.0 * counter.macs


def device_peak_flops(device=None, dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """The card's peak dense FLOP/s for ``dtype`` (bf16 on the tensor cores,
    float32 outside them), or None on the CPU or for a card not in the
    tables."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    table = PEAK_FLOPS_FP32 if dtype == torch.float32 else PEAK_FLOPS_BF16
    best = None
    for prefix, peak in table.items():
        if name.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), peak)
    return best[1] if best else None


def mfu(model_flops_per_sec: float, device=None,
        dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """``model_flops_per_sec / peak`` — None where the peak is unknown."""
    peak = device_peak_flops(device, dtype)
    if not peak or model_flops_per_sec <= 0:
        return None
    return model_flops_per_sec / peak


def throughput_record(fwd_flops: Optional[float], steps_per_sec: float, *,
                      tokens_per_sec: Optional[float] = None,
                      examples_per_sec: Optional[float] = None, device=None,
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The throughput telemetry of one window: tokens/s or examples/s, model
    TFLOP/s per card and MFU against the ``dtype`` peak, from the per-card
    forward FLOPs of one step (MFU omitted where the peak is unknown)."""
    rec: Dict[str, float] = {}
    if tokens_per_sec is not None:
        rec["throughput/tokens_per_sec"] = tokens_per_sec
    if examples_per_sec is not None:
        rec["throughput/examples_per_sec"] = examples_per_sec
    if fwd_flops is None or steps_per_sec <= 0:
        return rec
    per_card = 3.0 * fwd_flops * steps_per_sec
    rec["throughput/model_tflops_per_chip"] = per_card / 1e12
    u = mfu(per_card, device, dtype)
    if u is not None:
        rec["throughput/mfu"] = u
    return rec
