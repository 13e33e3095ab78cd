"""The port's DAWNBench entry point (``harness/dawn.py``) driven on the CPU.

Every compressor, granularity, transport mode, network and flag of the
port's CIFAR-10 harness runs a short synthetic drive of the scaled nets
(channels_scale 0.125, batches of 32): finite losses, and the sent and wire
fractions billed exactly as the JAX package's counting rules give them
from the leaf sizes.  The entry point refuses a missing CUDA device unless
the CPU is asked for, and raises naming the ROADMAP item for a flag not
ported yet.  (The step-by-step parity of the slice against the JAX package
is in ``tests/test_torch_resnet9_step.py``.)
"""

import numpy as np
import pytest
import torch

from tpu_compressed_dp.parallel import dp as jdp

from tpu_compressed_dp_torch.models import resnet9 as tres

SCALE = 0.125

def test_dawn_needs_cuda_unless_cpu_is_asked():
    from tpu_compressed_dp_torch.harness import dawn

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dawn.main(["--synthetic"])


def test_dawn_cpu_smoke():
    from tpu_compressed_dp_torch.harness import dawn

    summary = dawn.main(["--synthetic", "--synthetic_n", "128", "--batch_size", "32",
                         "--epochs", "1", "--compress", "entiremodel", "--method", "topk",
                         "--ratio", "0.01", "--error_feedback", "--device", "cpu",
                         "--channels_scale", "0.125", "--log_dir", ""])
    assert summary["steps"] == 4 and np.isfinite(summary["train loss"])
    assert abs(summary["sent frac"] - 0.01) < 0.001


def _billed(method: str, gran: str, bucket_mb: float, ratio: float):
    """(sent frac, wire frac) the sync bills for one step of the scaled
    ResNet-9, from its leaf sizes and the JAX package's counting rules."""
    from tpu_compressed_dp.ops import compressors as jc

    sizes = [p.numel() for p in tres.param_leaves(
        tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=0, device="cpu")).values()]
    groups = jdp.make_leaf_groups([4 * n for n in sizes], gran, bucket_mb * jdp.BUCKET_MB)
    dense = sum(sizes)
    sent = bits = 0.0
    for g in groups:
        n = sum(sizes[i] for i in g)
        if method == "randomk":
            k = jc.randomk_keep_count(n, ratio)
            sent, bits = sent + k, bits + 64.0 * k
        elif method == "blocktopk":
            kb = jc.blocktopk_keep_blocks(n, ratio, 256)
            k = min(kb * 256, n)
            sent, bits = sent + k, bits + k * (32.0 if kb * 256 >= n else 32.0 + 32.0 / 256)
        else:
            width = {"terngrad": 2.0, "randomdithering": 9.0}[method]
            sent, bits = sent + n, bits + width * n
    return sent / dense, bits / (32.0 * dense)


@pytest.mark.parametrize("granularity", ["layerwise", "entiremodel", "bucketed"])
@pytest.mark.parametrize("method", ["randomk", "thresholdv", "adaptivethreshold", "terngrad",
                                    "randomdithering", "blocktopk"])
def test_dawn_cpu_drive_every_method(method, granularity):
    from tpu_compressed_dp_torch.harness import dawn

    ef = ["--error_feedback"] if method in ("randomk", "thresholdv", "adaptivethreshold",
                                            "blocktopk") else []
    summary = dawn.main(["--synthetic", "--synthetic_n", "64", "--batch_size", "32",
                         "--epochs", "1", "--compress", granularity, "--method", method,
                         "--ratio", "0.01", "--bucket_mb", "0.1", "--device", "cpu",
                         "--channels_scale", "0.125", "--log_dir", "", *ef])
    assert summary["steps"] == 2 and np.isfinite(summary["train loss"])
    sent, wire = summary["sent frac"], summary["wire frac"]
    if method in ("thresholdv", "adaptivethreshold"):
        # a (value, index) pair per surviving coordinate
        assert 0.0 < sent <= 1.0 and wire == 2.0 * sent
    else:
        want_sent, want_wire = _billed(method, granularity, 0.1, 0.01)
        assert sent == pytest.approx(want_sent, rel=1e-12)
        assert wire == pytest.approx(want_wire, rel=1e-12)


@pytest.mark.parametrize("flag", ["--clip_sent_norm", "--ratio_warmup_epochs", "--lr_schedule",
                                  "--synthetic_hard"])
def test_dawn_deferred_protocol_flags_raise(flag):
    """The four protocol flags that raised until they were ported (ROADMAP
    queue 1 item 16) now run: a 2-epoch Top-K + EF drive of the scaled
    ResNet-9 with each, finite losses (their values against the JAX harness:
    ``tests/test_torch_dawn_protocol.py``)."""
    from tpu_compressed_dp_torch.harness import dawn

    value = {"--clip_sent_norm": ["0.5"], "--ratio_warmup_epochs": ["2"],
             "--lr_schedule": ["step"], "--synthetic_hard": []}[flag]
    summary = dawn.main([flag, *value, "--device", "cpu", "--synthetic", "--synthetic_n", "64",
                         "--batch_size", "32", "--epochs", "2", "--compress", "entiremodel",
                         "--method", "topk", "--ratio", "0.01", "--error_feedback",
                         "--channels_scale", "0.125", "--log_dir", ""])
    assert summary["epoch"] == 2 and np.isfinite(summary["train loss"])
    assert np.isfinite(summary["test loss"])


# --dtype, --network vgg16 and --overlap were cases here until they were
# ported (the drives below, tests/test_torch_overlap.py); flags that still
# raise took their places
@pytest.mark.parametrize("argv", [["--chaos", "nan"], ["--resume", "ckpt"],
                                  ["--guard"], ["--stream_dir", "s"],
                                  ["--job_id", "j0"]])
def test_dawn_unported_flags_raise(argv):
    from tpu_compressed_dp_torch.harness import dawn

    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item"):
        dawn.main(argv + ["--device", "cpu", "--synthetic", "--synthetic_n", "64",
                          "--batch_size", "32", "--epochs", "1", "--channels_scale", "0.125"])


def _wire_billed(method: str, gran: str, bucket_mb: float, ratio: float, cap: float):
    """(sent frac, wire frac) of one wire step of the scaled ResNet-9, from
    its leaf sizes and the byte layout of each method's payload."""
    from tpu_compressed_dp.ops import compressors as jc

    sizes = [p.numel() for p in tres.param_leaves(
        tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=0, device="cpu")).values()]
    groups = jdp.make_leaf_groups([4 * n for n in sizes], gran, bucket_mb * jdp.BUCKET_MB)
    chunk = jdp.CompressionConfig(granularity=gran).resolved_terngrad_chunk
    dense = sum(sizes)
    sent = bits = 0.0
    for g in groups:
        n = sum(sizes[i] for i in g)
        if method == "topk":
            k = jc.topk_keep_count(n, ratio)
            sent, bits = sent + k, bits + 64.0 * k
        elif method == "randomk":  # values only: the shared seed implies the indices
            k = jc.randomk_keep_count(n, ratio)
            sent, bits = sent + k, bits + 32.0 * k
        elif method == "blocktopk":
            kb = jc.blocktopk_keep_blocks(n, ratio, 256)
            k = min(kb * 256, n)
            sent, bits = sent + k, bits + (32.0 * n if k >= n else 32.0 * k + 32.0 * kb)
        elif method in ("thresholdv", "adaptivethreshold"):  # the whole capacity buffer
            bits += 64.0 * max(1, int(round(cap * n)))
        elif method == "terngrad":
            sent += n
            bits += 8.0 * (-(-n // 4)) + 32.0 * jc.terngrad_num_chunks(n, chunk)
        else:  # randomdithering, qstates 255: byte magnitudes + sign bitmap + norm
            sent += n
            bits += 8.0 * n + 8.0 * (-(-n // 8)) + 32.0
    return sent / dense, bits / (32.0 * dense)


@pytest.mark.parametrize("granularity", ["layerwise", "entiremodel", "bucketed"])
@pytest.mark.parametrize("method", ["topk", "randomk", "blocktopk", "thresholdv",
                                    "adaptivethreshold", "terngrad", "randomdithering"])
def test_dawn_cpu_wire_drive_every_method(method, granularity):
    from tpu_compressed_dp_torch.harness import dawn

    ef = [] if method in ("terngrad", "randomdithering") else ["--error_feedback"]
    summary = dawn.main(["--synthetic", "--synthetic_n", "64", "--batch_size", "32",
                         "--epochs", "1", "--compress", granularity, "--method", method,
                         "--ratio", "0.01", "--bucket_mb", "0.1", "--mode", "wire",
                         "--wire_cap_ratio", "0.02", "--device", "cpu",
                         "--channels_scale", "0.125", "--log_dir", "", *ef])
    assert summary["steps"] == 2 and np.isfinite(summary["train loss"])
    want_sent, want_wire = _wire_billed(method, granularity, 0.1, 0.01, 0.02)
    # the measured bits of the payload tensors are the layout's, exactly
    assert summary["wire frac"] == pytest.approx(want_wire, rel=1e-12)
    if method in ("thresholdv", "adaptivethreshold"):
        # the survivors that travelled, at most the capacity (64 bits a slot)
        assert 0.0 < summary["sent frac"] <= want_wire / 2
    else:
        assert summary["sent frac"] == pytest.approx(want_sent, rel=1e-12)


# the port's other CIFAR nets through the entry point: 1 step each at the
# smallest size their flags allow (the fixed-width nets at full width, batch 2)
@pytest.mark.parametrize("network,argv", [
    ("alexnet", ["--channels_scale", "0.125"]),
    ("resnet9_graph", ["--channels_scale", "0.125"]),
    ("alexnet_graph", ["--channels_scale", "0.125"]),
    ("resnet9", ["--channels_scale", "0.125", "--dtype", "bfloat16"]),
    ("alexnet", ["--channels_scale", "0.125", "--dtype", "bfloat16"]),
    ("resnet9_graph", ["--channels_scale", "0.125", "--dtype", "bfloat16"]),
    ("alexnet_module", []),
])
def test_dawn_cpu_drive_every_network(network, argv):
    from tpu_compressed_dp_torch.harness import dawn

    bs = "2" if network == "alexnet_module" else "32"
    summary = dawn.main(["--network", network, *argv, "--synthetic", "--synthetic_n", bs,
                         "--batch_size", bs, "--epochs", "1", "--compress", "layerwise",
                         "--method", "topk", "--ratio", "0.01", "--error_feedback",
                         "--device", "cpu", "--log_dir", ""])
    assert summary["steps"] == 1 and np.isfinite(summary["train loss"])
    assert np.isfinite(summary["test loss"])
    assert abs(summary["sent frac"] - 0.01) < 0.001


def test_dawn_cpu_drive_vgg16():
    # full width (134,301,514 parameters), batch 2, dense: ~4 s and ~5 GB
    from tpu_compressed_dp_torch.harness import dawn

    summary = dawn.main(["--network", "vgg16", "--synthetic", "--synthetic_n", "2",
                         "--batch_size", "2", "--epochs", "1", "--device", "cpu",
                         "--log_dir", ""])
    assert summary["steps"] == 1 and np.isfinite(summary["train loss"])
    assert summary["sent frac"] == summary["wire frac"] == 1.0


@pytest.mark.parametrize("network", ["vgg16", "alexnet_module"])
@pytest.mark.parametrize("argv,match", [(["--channels_scale", "0.5"], "channels_scale"),
                                        (["--dtype", "bfloat16"], "--dtype")])
def test_dawn_fixed_width_nets_refuse(network, argv, match):
    from tpu_compressed_dp_torch.harness import dawn

    with pytest.raises(ValueError, match=match):
        dawn.main(["--network", network, *argv, "--synthetic", "--synthetic_n", "2",
                   "--batch_size", "2", "--epochs", "1", "--device", "cpu", "--log_dir", ""])


@pytest.mark.parametrize("granularity", ["layerwise", "entiremodel", "bucketed"])
def test_dawn_cpu_drive_powersgd(granularity):
    """PowerSGD rank 2 + EF: the billed fractions are the factor pairs of
    the compressed groups and the dense vectors of the rest."""
    from tpu_compressed_dp.ops import lowrank as jlr

    from tpu_compressed_dp_torch.harness import dawn

    summary = dawn.main(["--synthetic", "--synthetic_n", "64", "--batch_size", "32",
                         "--epochs", "1", "--compress", granularity, "--method", "powersgd",
                         "--rank", "2", "--bucket_mb", "0.1", "--error_feedback",
                         "--device", "cpu", "--channels_scale", "0.125", "--log_dir", ""])
    assert summary["steps"] == 2 and np.isfinite(summary["train loss"])
    sizes = [p.numel() for p in tres.param_leaves(
        tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=0, device="cpu")).values()]
    groups = jdp.make_leaf_groups([4 * n for n in sizes], granularity, 0.1 * jdp.BUCKET_MB)
    ns = [sum(sizes[i] for i in g) for g in groups]
    bits = sum(jlr.powersgd_group_bits(n, 2) for n in ns)
    assert summary["wire frac"] == pytest.approx(bits / (32.0 * sum(ns)), rel=1e-12)
    assert summary["sent frac"] == pytest.approx(bits / (32.0 * sum(ns)), rel=1e-12)
