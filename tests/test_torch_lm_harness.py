"""The port's LM harness and token pipelines against the JAX package's.

  * ``SyntheticTokens`` and ``ByteCorpus`` batches are bitwise the JAX
    module's for the same ``(seed, step, process_index)``;
  * the CPU drive of the entry point (tiny preset, entire-model Top-K 1 % +
    EF, 30 steps) learns the motifs: its loss ends below ``log(vocab)``;
  * every JAX flag the port does not carry yet raises
    ``NotImplementedError`` naming its ROADMAP item, the flag names and
    defaults are the JAX parser's, and CUDA is the default device;
  * the MFU accounting matches the JAX closed form and is absent off the
    card.
"""

import math

import numpy as np
import pytest

from tpu_compressed_dp.data import lm as jdata
from tpu_compressed_dp.harness import lm as jharness
from tpu_compressed_dp.utils import flops as jflops

import torch

from tpu_compressed_dp_torch.data import lm as tdata
from tpu_compressed_dp_torch.harness import lm as tharness
from tpu_compressed_dp_torch.utils import flops as tflops


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=7, motif_len=5, noise=0.3),
                                dict(seed=3, process_index=2, process_count=4)])
def test_synthetic_tokens_bitwise(kw):
    a = jdata.SyntheticTokens(97, 33, 5, **kw)
    b = tdata.SyntheticTokens(97, 33, 5, **kw)
    np.testing.assert_array_equal(a.motifs, b.motifs)
    for step in (0, 1, 12):
        for k, v in a.batch(step).items():
            got = b.batch(step)[k]
            assert got.dtype == v.dtype == np.int32
            np.testing.assert_array_equal(got, v)


def test_byte_corpus_bitwise(tmp_path):
    path = tmp_path / "corpus.bin"
    path.write_bytes(np.random.default_rng(0).integers(0, 256, 5000, dtype=np.uint8).tobytes())
    a = jdata.ByteCorpus(str(path), 40, 3, seed=5, process_index=1)
    b = tdata.ByteCorpus(str(path), 40, 3, seed=5, process_index=1)
    assert b.vocab == a.vocab == 256
    for step in (0, 4):
        for k, v in a.batch(step).items():
            np.testing.assert_array_equal(b.batch(step)[k], v)
    with pytest.raises(ValueError):
        tdata.ByteCorpus(str(path), 6000, 1)


def test_cpu_drive_learns():
    summary = tharness.main(["--preset", "tiny", "--device", "cpu", "--steps", "30",
                             "--seq_len", "64", "--global_batch", "8", "--fp32", "--compress",
                             "entiremodel", "--method", "topk", "--ratio", "0.01",
                             "--error_feedback", "--log_every", "10"])
    assert summary["step"] == 30
    assert math.isfinite(summary["loss"]) and summary["loss"] < math.log(256)
    # entire-model Top-K keeps ~1 % of each of the two signature groups
    assert 0.009 <= summary["sent frac"] <= 0.011
    assert summary["tok/s"] > 0 and "mfu" not in summary


def test_cpu_drive_corpus_and_wire(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 40)
    summary = tharness.main(["--preset", "tiny", "--device", "cpu", "--steps", "3",
                             "--seq_len", "32", "--global_batch", "4", "--corpus", str(path),
                             "--compress", "layerwise", "--method", "topk", "--mode", "wire",
                             "--error_feedback", "--log_every", "3"])
    assert math.isfinite(summary["loss"]) and summary["wire frac"] > 0


def _flags():
    return {a.dest: a.default for a in jharness.build_parser()._actions
            if a.dest != "help"}


def test_parser_surface_matches_jax():
    jflags = _flags()
    tflags = {a.dest: a.default for a in tharness.build_parser()._actions if a.dest != "help"}
    assert set(tflags) - set(jflags) == {"device"}
    assert tflags["device"] == "cuda"
    for dest, default in jflags.items():
        if dest == "job_id":
            continue  # the JAX default reads $TCDP_JOB_ID
        assert tflags[dest] == default, dest


_UNPORTED = [
    (["--tp", "2"], 11), (["--sp", "2"], 11), (["--pp", "2"], 11), (["--experts", "4"], 11),
    (["--remat"], 11), (["--guard"], 12), (["--guard_max_skips", "3"], 12),
    (["--chaos", "nan,target=grads,steps=1"], 12), (["--checkpoint_dir", "ck"], 12),
    (["--resume", "ck"], 12), (["--elastic"], 12), (["--elastic_dir", "d"], 12),
    (["--stream_dir", "s"], 14), (["--stream_rejoin"], 14), (["--adaptive"], 13),
    (["--adaptive_window", "4"], 13), (["--events", "e.jsonl"], 13), (["--prom", "m.prom"], 13),
    (["--overlap", "2"], 9),
]


@pytest.mark.parametrize("argv,item", _UNPORTED, ids=[a[0] for a, _ in _UNPORTED])
def test_unported_flags_raise(argv, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tharness.main(["--device", "cpu", "--steps", "1", *argv])


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tharness.main(["--steps", "1"])
    with pytest.raises(ValueError, match="requires --compress"):
        tharness.main(["--device", "cpu", "--method", "topk"])


def test_flops_and_mfu():
    for args in ((1_486_901_248, 2, 4096, 8192), (124_000_000, 12, 768, 1024)):
        assert tflops.transformer_train_flops_per_token(*args) == \
            jflops.transformer_train_flops_per_token(*args)
    assert tflops.mfu(1e15, "cpu") is None
    rec = tflops.throughput_record(1e12, 2.0, tokens_per_sec=5.0, device="cpu")
    assert rec == {"throughput/tokens_per_sec": 5.0, "throughput/model_tflops_per_chip": 6.0}
    assert tflops.PEAK_FLOPS_BF16["NVIDIA H100 80GB HBM3"] == 989e12

