"""Gradient compression operators on flat tensors.

PyTorch counterpart of :mod:`tpu_compressed_dp.ops.compressors`: identity,
Top-K, Block-Top-K, Random-K, Threshold-V, Adaptive-Threshold, TernGrad and
QSGD (random dithering).  Each operator maps a flat gradient and a seed to a
same-shaped dense tensor with zeros at the dropped coordinates (the paper's
"simulate" representation).  PowerSGD registers its stateless single-shot
form (``ops/lowrank.py``); the sync engine runs its warm-started stateful
form.

Randomness is a 64-bit seed (a plain Python integer) in place of a
``jax.random`` key: :func:`fold_in` and :func:`leaf_seed` derive it on the
host with a fixed splitmix64 mix, so deriving one never waits for the card.
Draws come from :func:`draw_uniform` (Philox, ``kernels.uniform``); the
quantizer kernels draw the same stream inside the kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from tpu_compressed_dp_torch.ops import kernels

__all__ = [
    "identity",
    "top_k",
    "random_k",
    "randomk_mask",
    "threshold_v",
    "adaptive_threshold",
    "terngrad",
    "random_dithering",
    "get_compressor",
    "canonical_name",
    "payload_bits_per_elem",
    "REGISTRY",
    "topk_keep_count",
    "randomk_keep_count",
    "block_top_k",
    "blocktopk_blocks",
    "blocktopk_scores",
    "blocktopk_num_blocks",
    "blocktopk_keep_blocks",
    "terngrad_prescale",
    "terngrad_levels",
    "terngrad_dense",
    "terngrad_num_chunks",
    "qsgd_levels",
    "fold_in",
    "leaf_seed",
    "draw_uniform",
    "float32_value",
]

# fn(flat_grad, seed) -> same-shaped dense tensor
CompressorFn = Callable[[torch.Tensor, Optional[int]], torch.Tensor]

# the JAX package's method spellings (canonical plus the reference CLI's)
_ALIASES = {
    "topk": "topk", "blocktopk": "blocktopk", "block_topk": "blocktopk",
    "blocktop_k": "blocktopk", "randomk": "randomk", "thresholdv": "thresholdv",
    "adaptivethreshold": "adaptive_threshold",
    "adaptive_threshold": "adaptive_threshold", "terngrad": "terngrad",
    "randomdithering": "qsgd", "random_dithering": "qsgd", "qsgd": "qsgd",
    "powersgd": "powersgd", "power_sgd": "powersgd", "lowrank": "powersgd",
    "none": "none", "dense": "none",
}

REGISTRY = ("none", "topk", "blocktopk", "randomk", "thresholdv",
            "adaptive_threshold", "terngrad", "qsgd", "powersgd")

_U64 = (1 << 64) - 1


def _flat(g: torch.Tensor) -> torch.Tensor:
    if g.dim() != 1:
        raise ValueError(f"compressors operate on flat vectors, got shape {tuple(g.shape)}")
    return g


# ---------------------------------------------------------------------------
# Seeds
# ---------------------------------------------------------------------------


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed from ``seed`` and an integer, the counterpart of
    ``jax.random.fold_in`` (a fixed splitmix64 mix of plain integers)."""
    return _splitmix64((_splitmix64(seed & _U64) + data) & _U64)


def leaf_seed(seed: int, index: int, rank: Optional[int] = None) -> int:
    """The seed of reduction group ``index`` (the counterpart of
    ``leaf_key``): fold in the global group index always, and this worker's
    rank only where draws must differ across workers.  Every sync derives
    its group seeds here, so a chunked sync can shift ``index`` the way the
    JAX engines shift it by ``group_offset``."""
    s = fold_in(seed, index)
    return s if rank is None else fold_in(s, rank)


def draw_uniform(seed: int, n: int, device) -> torch.Tensor:
    """The uniforms the formula paths draw: the Philox stream of ``seed``
    (the CUDA kernel on the card, its plain version on the CPU)."""
    return kernels.uniform(seed, n, device)


# ---------------------------------------------------------------------------
# Keep counts
# ---------------------------------------------------------------------------


def topk_keep_count(n: int, ratio: float) -> int:
    """Elements Top-K keeps: ``n - ceil(n*(1-ratio)) + 1`` (the reference's
    ``kthvalue`` threshold, everything ``>=`` it kept)."""
    m = max(1, math.ceil(n * (1.0 - ratio)))
    return max(1, n - m + 1)


def randomk_keep_count(n: int, ratio: float) -> int:
    """Elements Random-K keeps: ``ceil(n*ratio)`` clamped to ``[0, n]``, with
    an epsilon absorbing binary dust in ``n*ratio``."""
    return max(0, min(n, int(math.ceil(n * ratio - 1e-9))))


def blocktopk_num_blocks(n: int, block_size: int) -> int:
    return -(-n // block_size)


def blocktopk_keep_blocks(n: int, ratio: float, block_size: int) -> int:
    """Blocks Block-Top-K keeps: ``ceil(num_blocks * ratio)``, at least 1."""
    nb = blocktopk_num_blocks(n, block_size)
    return max(1, min(nb, int(math.ceil(nb * ratio - 1e-9))))


# ---------------------------------------------------------------------------
# Sparsifiers
# ---------------------------------------------------------------------------


def identity(g: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
    """No compression."""
    return _flat(g)


def top_k(g: torch.Tensor, seed: Optional[int] = None, *, ratio: float) -> torch.Tensor:
    """Keep the ``~ratio*n`` largest-magnitude coordinates; ties at the
    threshold are all kept."""
    g = _flat(g)
    keep = topk_keep_count(g.shape[0], ratio)
    mag = g.abs().to(torch.float32)  # threshold compare in fp32 always
    thresh = kernels.topk_threshold(mag, keep)
    return torch.where(mag >= thresh, g, 0.0)


def blocktopk_blocks(g: torch.Tensor, block_size: int) -> torch.Tensor:
    """Zero-padded ``[num_blocks, block_size]`` view of a flat vector."""
    g = _flat(g)
    pad = (-g.shape[0]) % block_size
    return torch.nn.functional.pad(g, (0, pad)).reshape(-1, block_size)


def blocktopk_scores(g: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block squared-L2 scores (float32).  The JAX package folds small
    blocks with a 0/1 matmul; a row sum gives the same values up to the
    order of summation (rtol ~1e-6)."""
    x = blocktopk_blocks(_flat(g).to(torch.float32), block_size)
    return (x * x).sum(dim=1)


def block_top_k(g: torch.Tensor, seed: Optional[int] = None, *, ratio: float,
                block_size: int = 256) -> torch.Tensor:
    """Keep the ``~ratio`` fraction of contiguous ``block_size``-element
    blocks with the largest L2 norm; zero the rest."""
    g = _flat(g)
    n = g.shape[0]
    keep = blocktopk_keep_blocks(n, ratio, block_size)
    scores = blocktopk_scores(g, block_size)
    thresh = kernels.topk_threshold(scores, keep)
    mask = torch.repeat_interleave(scores >= thresh, block_size)[:n]
    return torch.where(mask, g, 0.0)


def randomk_mask(seed: int, n: int, keep: int, device) -> torch.Tensor:
    """A uniformly random ``keep``-subset of ``[0, n)`` as a boolean mask:
    the ``keep`` largest of ``n`` uniforms drawn from ``seed``, found by the
    threshold search; ties at the smallest selected value are broken by
    index (one cumsum), so exactly ``keep`` are set.  Stays on the device:
    the tie budget is a 0-d tensor, never fetched."""
    if keep <= 0 or keep >= n:
        return torch.full((n,), keep > 0, dtype=torch.bool, device=device)
    w = draw_uniform(seed, n, device)
    t = kernels.topk_threshold(w, keep)
    boundary = torch.where(w >= t, w, math.inf).min()
    above = w > boundary
    tie = w == boundary
    return above | (tie & (torch.cumsum(tie, 0) <= keep - above.sum()))


def random_k(g: torch.Tensor, seed: int, *, ratio: float) -> torch.Tensor:
    """Keep a uniformly random subset of ``ceil(ratio*n)`` coordinates; the
    seed decides whether the workers share the mask."""
    g = _flat(g)
    n = g.shape[0]
    mask = randomk_mask(seed, n, randomk_keep_count(n, ratio), g.device)
    return torch.where(mask, g, 0.0)


def float32_value(v: float) -> float:
    """``v`` rounded to float32, as JAX compares a weakly typed Python float
    with a float32 array."""
    return float(torch.tensor(v, dtype=torch.float32))


def threshold_v(g: torch.Tensor, seed: Optional[int] = None, *,
                threshold: float) -> torch.Tensor:
    """Keep coordinates with ``|g| >= V``."""
    g = _flat(g)
    return torch.where(g.abs() >= float32_value(threshold), g, 0.0)


def adaptive_threshold(g: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
    """Keep coordinates with ``2|g| >= max|g|``."""
    g = _flat(g)
    gmax = g.abs().max()
    return torch.where(2.0 * g.abs() >= gmax, g, 0.0)


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------


def terngrad_num_chunks(n: int, chunk: int) -> int:
    """Scale chunks TernGrad uses: 1 when chunking is off or the vector fits
    in one chunk, else ``ceil(n / chunk)``."""
    if chunk <= 0 or n <= chunk:
        return 1
    return -(-n // chunk)


def terngrad_prescale(g: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Divide each ``chunk``-element slice by its own ``max|g|``: returns
    ``(scaled f32[n] with |scaled| <= 1, gmax f32[num_chunks])``."""
    g = _flat(g)
    n = g.shape[0]
    nc = terngrad_num_chunks(n, chunk)
    g2 = torch.nn.functional.pad(g.to(torch.float32), (0, nc * chunk - n)).reshape(nc, chunk)
    gmax = g2.abs().amax(dim=1)
    inv = torch.where(gmax > 0, 1.0 / torch.where(gmax > 0, gmax, 1.0), 0.0)
    return (g2 * inv[:, None]).reshape(-1)[:n], gmax


def _levels(sign_of: torch.Tensor, m: torch.Tensor, dtype) -> torch.Tensor:
    return kernels._to_int(kernels._select_sign(sign_of) * m, dtype)


def terngrad_levels(g: torch.Tensor, seed: int, *, chunk: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 levels in {-1, 0, 1}, scale)``: one ``max|g|`` (scalar scale)
    or one per ``chunk`` elements (vector scale).  The dither kernel serves
    large tensors (``kernels.use_quant_kernels``); below its cut-off the
    formula of the JAX package's jnp path, ``coin < |g| / max|g|``, runs on
    :func:`draw_uniform`."""
    g = _flat(g)
    n = g.shape[0]
    if terngrad_num_chunks(n, chunk) == 1:
        if kernels.use_quant_kernels(n, g.device):
            return kernels.terngrad_quantize(g, seed)
        mag = g.abs()
        gmax = mag.max()
        prob = torch.where(gmax > 0, mag / torch.where(gmax > 0, gmax, 1.0), 0.0)
        coin = draw_uniform(seed, n, g.device)
        return _levels(g, (coin < prob).to(torch.float32), torch.int8), gmax
    scaled, gmax = terngrad_prescale(g, chunk)
    if kernels.use_quant_kernels(n, g.device):
        return kernels.terngrad_quantize_prescaled(scaled, seed), gmax
    coin = draw_uniform(seed, n, g.device)
    return _levels(scaled, (coin < scaled.abs()).to(torch.float32), torch.int8), gmax


def terngrad_dense(levels: torch.Tensor, scale: torch.Tensor, chunk: int,
                   dtype=torch.float32) -> torch.Tensor:
    """The dense estimator ``scale * levels`` (per-chunk scales broadcast)."""
    if scale.dim() == 0:
        return scale.to(dtype) * levels.to(dtype)
    n, nc = levels.shape[0], scale.shape[0]
    lv = torch.nn.functional.pad(levels, (0, nc * chunk - n)).reshape(nc, chunk).to(dtype)
    return (scale.to(dtype)[:, None] * lv).reshape(-1)[:n]


def terngrad(g: torch.Tensor, seed: int, *, chunk: int = 0) -> torch.Tensor:
    """TernGrad: ``max|g| * sign(g_i) * Bernoulli(|g_i| / max|g|)``, the max
    taken per ``chunk`` elements when chunking is on; unbiased."""
    levels, scale = terngrad_levels(g, seed, chunk=chunk)
    return terngrad_dense(levels, scale, chunk, dtype=g.dtype)


def qsgd_levels(g: torch.Tensor, seed: int, *, qstates: int = 255
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int16 levels in [-s, s], scale = ||g|| / s)``, 0 for a zero vector.
    The dither kernel (``(|g| * inv) * s + u``) serves large tensors; below
    its cut-off the jnp path's formula ``|g| / ||g|| * s + u`` (a division)
    runs on :func:`draw_uniform`."""
    g = _flat(g)
    if kernels.use_quant_kernels(g.shape[0], g.device):
        return kernels.qsgd_quantize(g, seed, qstates=qstates)
    norm = torch.linalg.vector_norm(g)
    safe_norm = torch.where(norm > 0, norm, 1.0)
    u = draw_uniform(seed, g.shape[0], g.device)
    levels = _levels(g, torch.floor(g.abs() / safe_norm * float(qstates) + u), torch.int16)
    return levels, torch.where(norm > 0, norm, 0.0) / qstates


def random_dithering(g: torch.Tensor, seed: int, *, qstates: int = 255) -> torch.Tensor:
    """QSGD / random dithering: ``||g|| * sign(g_i) * floor(|g_i| / ||g|| *
    s + u_i) / s`` with ``u_i ~ U[0, 1)``; unbiased."""
    levels, scale = qsgd_levels(g, seed, qstates=qstates)
    return scale * levels.to(g.dtype)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Bound:
    """A compressor with its hyper-parameters bound, keyed by canonical name."""

    name: str
    fn: CompressorFn
    needs_rng: bool

    @property
    def is_sparsifier(self) -> bool:
        """Sparsifiers send only the surviving coordinates; quantizers and
        identity send every coordinate at reduced width."""
        return self.name in ("topk", "randomk", "thresholdv",
                             "adaptive_threshold", "blocktopk")

    @property
    def is_stateful(self) -> bool:
        """Stateful compressors carry a warm start through the sync
        (``TrainState.comp``); ``fn`` is their stateless single-shot form."""
        return self.name == "powersgd"


def canonical_name(method: Optional[str]) -> str:
    """Resolve a method spelling to its canonical name (raises on unknown)."""
    if method is None:
        return "none"
    canon = _ALIASES.get(method.lower().replace("-", "_"))
    if canon is None:
        raise ValueError(f"unknown compression method {method!r}; known: {REGISTRY}")
    return canon


def payload_bits_per_elem(name: str, *, qstates: int = 255, shared_mask: bool = False,
                          block_size: int = 256, rank: int = 4,
                          n: Optional[int] = None) -> float:
    """Wire width of one transmitted element, in bits: dense fp32 32; a
    (value, index) pair 64, or 32 for shared-seed Random-K whose indices the
    common seed implies; Block-Top-K 32 + one index per block; TernGrad 2;
    QSGD 8, 9 or 16 by ``qstates``; PowerSGD its two fp32 factors over the
    ``n`` elements of the group (``n`` required: the width depends on it)."""
    if name == "powersgd":
        if n is None:
            raise ValueError("powersgd wire width is shape-dependent; pass n (the flat "
                             "group's element count)")
        from tpu_compressed_dp_torch.ops import lowrank

        return lowrank.powersgd_group_bits(n, rank) / n
    if name in ("none", "thresholdv", "adaptive_threshold", "topk"):
        return 32.0 if name == "none" else 64.0
    if name == "randomk":
        return 32.0 if shared_mask else 64.0
    if name == "blocktopk":
        return 32.0 + 32.0 / block_size
    if name == "terngrad":
        return 2.0
    if name == "qsgd":
        return 8.0 if qstates <= 127 else (9.0 if qstates <= 255 else 16.0)
    raise ValueError(f"unknown compressor {name!r}")


def get_compressor(method: Optional[str], *, ratio: float = 0.5, threshold: float = 1e-3,
                   qstates: int = 255, block_size: int = 256,
                   terngrad_chunk: int = 1 << 21, rank: int = 4) -> _Bound:
    """Resolve a method name (canonical or reference spelling) to a bound
    operator ``fn(flat, seed)``."""
    canon = canonical_name(method)
    if canon == "none":
        return _Bound("none", identity, needs_rng=False)
    if canon == "topk":
        return _Bound("topk", lambda g, seed=None: top_k(g, ratio=ratio), needs_rng=False)
    if canon == "blocktopk":
        return _Bound("blocktopk", lambda g, seed=None: block_top_k(
            g, ratio=ratio, block_size=block_size), needs_rng=False)
    if canon == "randomk":
        return _Bound("randomk", lambda g, seed: random_k(g, seed, ratio=ratio),
                      needs_rng=True)
    if canon == "thresholdv":
        return _Bound("thresholdv", lambda g, seed=None: threshold_v(
            g, threshold=threshold), needs_rng=False)
    if canon == "adaptive_threshold":
        return _Bound("adaptive_threshold", lambda g, seed=None: adaptive_threshold(g),
                      needs_rng=False)
    if canon == "terngrad":
        return _Bound("terngrad", lambda g, seed: terngrad(g, seed, chunk=terngrad_chunk),
                      needs_rng=True)
    if canon == "qsgd":
        return _Bound("qsgd", lambda g, seed: random_dithering(g, seed, qstates=qstates),
                      needs_rng=True)
    # powersgd: the stateless single-shot form; the sync engine runs the
    # warm-started one (parallel/dp.py)
    from tpu_compressed_dp_torch.ops import lowrank

    return _Bound("powersgd", lambda g, seed: lowrank.powersgd_approx(g, seed, rank=rank),
                  needs_rng=True)
