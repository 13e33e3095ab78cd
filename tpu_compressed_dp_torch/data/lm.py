"""LM token pipelines: synthetic streams and byte-level text files (numpy only).

The port's own copy of :mod:`tpu_compressed_dp.data.lm` (the port imports
nothing of the JAX package).  Batches are ``{'input': [B, T] int32,
'target': [B, T] int32}`` next-token pairs, deterministic in ``(seed, step,
process_index)``: the same arguments give batches bitwise equal to the JAX
module's.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticTokens", "ByteCorpus"]


class SyntheticTokens:
    """Deterministic synthetic stream with learnable structure.

    Sequences interleave fixed-period repeating motifs drawn from a
    per-stream PRNG and uniform noise tokens, so a model that learns the
    motifs drops well below the uniform-entropy loss (``log(vocab)``).
    """

    def __init__(self, vocab: int, seq_len: int, batch_size: int, *,
                 seed: int = 0, motif_len: int = 8, noise: float = 0.1,
                 process_index: int = 0, process_count: int = 1):
        if vocab < 4:
            raise ValueError("vocab must be >= 4")
        self.vocab, self.seq_len, self.batch_size = vocab, seq_len, batch_size
        self.seed, self.motif_len, self.noise = seed, motif_len, noise
        self.pi, self.pc = process_index, process_count
        rng = np.random.default_rng([seed, 0x70C])
        self.motifs = rng.integers(0, vocab, size=(16, motif_len))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, step, self.pi])
        b, t = self.batch_size, self.seq_len + 1
        motif_ids = rng.integers(0, len(self.motifs), size=(b,))
        reps = -(-t // self.motif_len)
        seqs = np.tile(self.motifs[motif_ids], (1, reps))[:, :t]
        noise_mask = rng.random((b, t)) < self.noise
        seqs = np.where(noise_mask, rng.integers(0, self.vocab, size=(b, t)), seqs)
        seqs = seqs.astype(np.int32)
        return {"input": seqs[:, :-1], "target": seqs[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class ByteCorpus:
    """Byte-level tokens from a text or binary file (vocab 256), random crops."""

    def __init__(self, path: str, seq_len: int, batch_size: int, *,
                 seed: int = 0, process_index: int = 0, process_count: int = 1):
        self.data = np.fromfile(path, dtype=np.uint8)
        if len(self.data) < seq_len + 2:
            raise ValueError(f"corpus {path!r} shorter than seq_len")
        self.vocab = 256
        self.seq_len, self.batch_size = seq_len, batch_size
        self.seed, self.pi, self.pc = seed, process_index, process_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, step, self.pi])
        starts = rng.integers(0, len(self.data) - self.seq_len - 1,
                              size=(self.batch_size,))
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None, :]
        seqs = self.data[idx].astype(np.int32)
        return {"input": seqs[:, :-1], "target": seqs[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
