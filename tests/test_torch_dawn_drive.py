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

import os

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


# --dtype, --network vgg16, --overlap, --guard, --resume and in-step chaos
# were cases here until they were ported (the drives below,
# tests/test_torch_overlap.py); flags that still raise took their places
# the elastic flags (item 12) were cases here until they were ported
# (test_dawn_elastic_* below); flags that still raise took their places, and
# the telemetry flags (item 13) moved to test_dawn_item13_flags_work
_DAWN_TINY = ["--device", "cpu", "--synthetic", "--synthetic_n", "64", "--batch_size", "32",
              "--epochs", "1", "--channels_scale", "0.125"]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def twin_records_dir(flag: str, tmp_path) -> str:
    """The records directory a twin-flag case calibrates from: the
    repository root for ``--adaptive_model``, a directory holding two of
    its sweep files for ``--twin_records`` (so the flag's directory shows
    in ``twin/calib_rows``)."""
    if flag == "--adaptive_model":
        return REPO
    d = tmp_path / "records"
    d.mkdir()
    for name in ("BENCH_r10.json", "BENCH_r11.json"):
        (d / name).write_bytes(open(os.path.join(REPO, name), "rb").read())
    return str(d)


def twin_gauges(events_path: str, kind: str) -> list:
    """The ``twin/*`` gauges of every ``kind`` record on an event stream."""
    import json

    with open(events_path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r["control"].items() if k.startswith("twin/")}
            for r in recs if r["kind"] == kind]


def check_twin_gauges(gauges: list, records: str) -> None:
    """At least one window's ``twin/*`` gauges, each with the evidence rows
    of ``records`` (the JAX loader's count) and finite prices."""
    from tpu_compressed_dp.twin import calibration_rows

    seen = [g for g in gauges if g]
    assert seen, gauges
    for g in seen:
        assert set(g) == {"twin/pred_step_ms", "twin/pred_err_frac", "twin/calib_rows"}
        assert g["twin/calib_rows"] == float(len(calibration_rows(records)))
        assert np.isfinite(g["twin/pred_step_ms"]) and np.isfinite(g["twin/pred_err_frac"])


# the twin flags were cases of test_dawn_unported_flags_raise until the
# digital twin was ported
@pytest.mark.parametrize("flag", ["--twin_records", "--adaptive_model"])
def test_dawn_twin_flags_work(flag, tmp_path):
    """Two epochs under ``--adaptive --adaptive_model twin``: the epoch
    records carry the ``twin/*`` gauges, calibrated from the flag's records
    directory; the run ends with finite losses."""
    from tpu_compressed_dp_torch.harness import dawn

    records = twin_records_dir(flag, tmp_path)
    ev = str(tmp_path / "e.jsonl")
    summary = dawn.main(_DAWN_TINY[:-4] + [
        "--epochs", "2", "--channels_scale", "0.125", "--log_dir", "", "--compress",
        "entiremodel", "--method", "topk", "--ratio", "0.01", "--error_feedback", "--adaptive",
        "--adaptive_model", "twin", "--twin_records", records, "--adaptive_budget_ms", "1.0",
        "--events", ev])
    assert summary["epoch"] == 2 and np.isfinite(summary["train loss"])
    check_twin_gauges(twin_gauges(ev, "epoch"), records)


# the stream flags were cases of test_dawn_unported_flags_raise until the
# delta stream was ported (item 14's first part)
@pytest.mark.parametrize("flag", ["--stream_keyframe_every", "--stream_every", "--stream_dir"])
def test_dawn_stream_flags_work(flag, tmp_path):
    """Three epochs with the flag: the segments its cadence and window make,
    each verifiable."""
    from tpu_compressed_dp_torch.harness import dawn
    from tpu_compressed_dp_torch.stream import store

    sd = str(tmp_path / "s")
    extra = {"--stream_keyframe_every": ["--stream_keyframe_every", "2"],
             "--stream_every": ["--stream_every", "2"], "--stream_dir": []}[flag]
    dawn.main(_DAWN_TINY + ["--epochs", "3", "--compress", "entiremodel", "--method", "topk",
                            "--ratio", "0.05", "--error_feedback", "--log_dir", "",
                            "--stream_dir", sd, *extra])
    problems, seqs = store.verify_stream(sd)
    kinds = [store.read_segment_manifest(sd, q)["kind"]
             + ("*" if store.read_segment_manifest(sd, q)["window_close"] else "") for q in seqs]
    assert problems == [] and kinds == {
        "--stream_keyframe_every": ["keyframe*", "delta*", "keyframe*"],
        "--stream_every": ["keyframe*"],
        "--stream_dir": ["keyframe*", "delta", "delta"]}[flag], kinds


@pytest.mark.parametrize("flag", ["--events", "--flight_dir", "--job_id"])
def test_dawn_item13_flags_work(flag, tmp_path):
    from tpu_compressed_dp_torch.harness import dawn

    d = str(tmp_path)
    argv, want = {"--events": (["--events", f"{d}/e.jsonl"], "e.jsonl"),
                  "--flight_dir": (["--flight_dir", f"{d}/f"], "f/flight.rank0.phases.json"),
                  "--job_id": (["--job_id", "j0", "--prom", f"{d}/m.prom"], "j0.m.prom")}[flag]
    dawn.main(argv + _DAWN_TINY + ["--log_dir", ""])
    assert os.path.exists(os.path.join(d, want))


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


_ROBUST = ["--device", "cpu", "--synthetic", "--synthetic_n", "64", "--batch_size", "32",
           "--compress", "layerwise", "--method", "topk", "--ratio", "0.05",
           "--error_feedback", "--momentum", "0.9", "--channels_scale", "0.125", "--log_dir", ""]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's in-process drives: under the
    tier-1 run's parallel workers a thread per core in every worker
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dawn_guard_chaos_checkpoint_resume(tmp_path, one_torch_thread):
    """``--guard --chaos ... --checkpoint_dir ... --heartbeat``, then
    ``--resume``: the poisoned step is skipped (the epoch's loss stays
    finite), each epoch ends in a verifiable checkpoint, the heartbeat
    carries the step, the applied-update watermark and the checkpoint's
    step, and the resumed run starts at the next epoch with the guard's
    count carried over."""
    from tpu_compressed_dp_torch.harness import dawn
    from tpu_compressed_dp_torch.utils import checkpoint as tckpt
    from tpu_compressed_dp_torch.utils import resilience as tres_mod

    ck, hb = str(tmp_path / "ck"), str(tmp_path / "hb.json")
    s1 = dawn.main(_ROBUST + ["--epochs", "2", "--guard", "--chaos", "nan,steps=1",
                              "--checkpoint_dir", ck, "--heartbeat", hb])
    assert s1["skipped"] == 1.0 and s1["loss scale"] == 1.0 and np.isfinite(s1["train loss"])
    assert tckpt.list_step_dirs(ck) == [2, 4]
    assert all(tckpt.verify_step_dir(ck, s) == [] for s in (2, 4))
    rec = tres_mod.read_heartbeat(hb)
    assert rec["step"] == 4 and rec["last_good_step"] == 4 and rec["epoch"] == 1
    s2 = dawn.main(_ROBUST + ["--epochs", "3", "--guard", "--resume", ck, "--checkpoint_dir",
                              str(tmp_path / "ck2")])
    assert s2["epoch"] == 3 and s2["steps"] == 2 and s2["skipped"] == 1.0
    assert tckpt.list_step_dirs(str(tmp_path / "ck2")) == [6]


def test_dawn_crash_recovery_and_wedge(tmp_path, one_torch_thread):
    """``--chaos crash=3`` with ``--checkpoint_dir`` recovers through
    ``run_with_recovery`` and finishes; every step poisoned trips the
    wedge check (``GuardExceeded``) at the epoch's end."""
    from tpu_compressed_dp_torch.harness import dawn
    from tpu_compressed_dp_torch.train.guard import GuardExceeded
    from tpu_compressed_dp_torch.utils.chaos import ChaosCrash

    s = dawn.main(_ROBUST + ["--epochs", "3", "--chaos", "crash=3", "--checkpoint_dir",
                             str(tmp_path / "ck")])
    assert s["epoch"] == 3 and np.isfinite(s["train loss"])
    with pytest.raises(ChaosCrash):
        dawn.main(_ROBUST + ["--epochs", "2", "--chaos", "crash=3"])
    with pytest.raises(GuardExceeded, match="consecutive nonfinite steps"):
        dawn.main(_ROBUST + ["--epochs", "1", "--chaos", "inf,every=1", "--guard_max_skips",
                             "1"])


def test_dawn_elastic_remesh_w3_to_w2(tmp_path):
    """``--elastic --chaos crash=mid_collective,crash_at_step=2,worker=1``
    on 3 gloo processes of the entry point: worker 1 exits for the watchdog,
    ranks 0 and 2 commit epoch 1 over [0, 2], re-shard the batch of 24 over
    2 and finish the run with finite losses (the remesh itself is held to
    JAX in ``tests/test_torch_elastic_world.py``).  The checkpoints after
    the remesh are written at W = 2, and 2 fresh processes ``--resume``
    them."""
    from test_torch_elastic_world import harness_world
    from tpu_compressed_dp_torch.utils import checkpoint as tckpt

    ck = str(tmp_path / "ck")
    argv = ["--synthetic", "--synthetic_n", "96", "--batch_size", "24", "--epochs", "2",
            "--compress", "entiremodel", "--method", "topk", "--ratio", "0.05",
            "--error_feedback", "--channels_scale", "0.125", "--log_dir", "",
            "--peer_timeout", "20", "--checkpoint_dir", ck]
    rcs, logs, summaries, epoch = harness_world(
        "tpu_compressed_dp_torch.harness.dawn",
        argv + ["--chaos", "crash=mid_collective,crash_at_step=2,worker=1"], 3, tmp_path / "a")
    assert rcs[0] == rcs[2] == 0 and rcs[1] != 0, [lg[-2000:] for lg in logs]
    assert "among the declared dead" in logs[1]
    assert epoch["epoch"] == 1 and epoch["ranks"] == [0, 2]
    for r in (0, 2):
        s = summaries[r]
        assert s["world"] == 2 and s["epoch"] == 2 and s["steps"] == 4
        assert np.isfinite(s["train loss"]) and np.isfinite(s["test loss"])
    steps = tckpt.list_step_dirs(ck)
    assert steps and tckpt.read_manifest(ck, steps[-1])["meta"]["layout"] == {"world": 2}
    resume = [a for a in argv if a not in ("--checkpoint_dir", ck)]
    resume[resume.index("--epochs") + 1] = "3"
    rcs, logs, summaries, _ = harness_world("tpu_compressed_dp_torch.harness.dawn",
                                            resume + ["--resume", ck], 2, tmp_path / "b")
    assert rcs == [0, 0], [lg[-2000:] for lg in logs]
    assert summaries[0]["epoch"] == 3 and summaries[0]["steps"] == 4


def test_dawn_elastic_alone_and_devices():
    """One process with ``--elastic`` runs (no peers: the runtime only
    polls); ``--devices`` must be the world's process count."""
    from tpu_compressed_dp_torch.harness import dawn

    argv = ["--device", "cpu", "--synthetic", "--synthetic_n", "64", "--batch_size", "32",
            "--epochs", "1", "--channels_scale", "0.125", "--log_dir", ""]
    s = dawn.main(argv + ["--elastic", "--elastic_ef", "drop", "--elastic_min_world", "1",
                          "--peer_timeout", "5", "--devices", "1"])
    assert s["world"] == 1 and s["steps"] == 2
    with pytest.raises(ValueError, match="workers are processes"):
        dawn.main(argv + ["--devices", "2"])
