"""The port's ImageNet harness (``harness/imagenet.py``) on the CPU.

  * ``main`` with the synthetic data, a width-8 ResNet-18, layer-wise Top-K
    + EF and ``--overlap 2`` runs the smoke phase schedule (64 px, then 96 px
    with rect val) through ``--device cpu``;
  * from the JAX harness's initial weights (the JAX module's init carried
    across), the first epoch's train loss (4 steps) is held to the JAX
    harness's on the same flags plus ``--fp32`` (one device there, one rank
    here) within 1 % of its value (measured 0.17 %), and the sent and wire
    fractions to the JAX run's bill within 1e-3 of theirs (Top-K + EF
    counts its nonzero survivors, which follow the gradients).  The loaders
    hand both the same bytes and the schedules the same learning rates (to
    one float32 ulp).  In bf16 a trajectory comparison says nothing at this
    width: one step's bf16 gradients of the width-8 ResNet-18 are 20-70 % of
    each leaf's largest entry off the fp32 ones, in JAX and in the port
    alike, so the two bf16 runs end 14 % apart; the bf16 forward is held in
    ``tests/test_torch_resnet.py``;
  * flags this slice does not carry raise ``NotImplementedError`` naming
    their ROADMAP item; ``--method`` without ``--compress`` is refused;
  * ``FileLogger`` and ``AverageMeter`` are JAX's, and ``--logdir`` gets
    JAX's ``~~epoch`` line in ``event.log``.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_compressed_dp.harness import imagenet as jharness
from tpu_compressed_dp.models import resnet as jres
from tpu_compressed_dp.models.common import init_model

import torch

from tpu_compressed_dp_torch.harness import imagenet as tharness
from tpu_compressed_dp_torch.models import common as tcommon

FLAGS = ["--synthetic", "--arch", "resnet18", "--width", "8", "--num_classes", "8",
         "--compress", "layerwise", "--method", "topk", "--error_feedback", "--overlap", "2",
         "--workers", "2"]
ONE_EPOCH = '[{"ep": 0, "sz": 64, "bs": 32}, {"ep": [0, 1], "lr": [0.1, 0.2]}]'
LOSS_REL = 0.01
FRAC_REL = 1e-3


def test_smoke_schedule_runs_with_overlap():
    summary = tharness.main(FLAGS + ["--device", "cpu"])
    assert summary["epoch"] == 2 and summary["steps"] == 16  # 512 images at bs 32
    assert np.isfinite(summary["train loss"]) and np.isfinite(summary["test loss"])
    assert 0.0 <= summary["top1"] <= summary["top5"] <= 100.0
    assert 0.5 < summary["sent frac"] < 0.6  # the default --ratio 0.5


def test_first_epoch_matches_jax_harness(monkeypatch):
    argv = FLAGS + ["--synthetic_n", "128", "--phases", ONE_EPOCH, "--ratio", "0.1",
                    "--seed", "5", "--fp32"]
    want = jharness.main(argv + ["--devices", "1"])
    module = jres.resnet18(num_classes=8, width=8)
    params, stats = init_model(module, jax.random.key(5), jnp.zeros((1, 64, 64, 3)))
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    build = tharness.ARCHS["resnet18"]

    def from_jax_init(**kw):
        model = build(**kw)
        tcommon.load_flax_params(model, params, stats)
        return model

    monkeypatch.setitem(tharness.ARCHS, "resnet18", from_jax_init)
    got = tharness.main(argv + ["--device", "cpu"])
    assert got["steps"] == 4
    assert abs(got["train loss"] - want["train loss"]) <= LOSS_REL * want["train loss"], (
        got["train loss"], want["train loss"])
    for key in ("sent frac", "wire frac"):
        assert abs(got[key] - want[key]) <= FRAC_REL * want[key], (key, got[key], want[key])
    assert np.isfinite(got["test loss"])


# the elastic flags (item 12) and the telemetry and control flags (item 13)
# were cases of test_unported_flags_raise until they were ported
# (test_elastic_* and test_item13_flags_work), then the stream flags
# (test_stream_flags_work) and the twin flags (test_twin_flags_work)
@pytest.mark.parametrize("flag", ["--twin_records", "--adaptive_model"])
def test_twin_flags_work(flag, tmp_path):
    """One synthetic epoch under ``--adaptive --adaptive_model twin``: the
    epoch record carries the ``twin/*`` gauges, calibrated from the flag's
    records directory."""
    from tests.test_torch_dawn_drive import check_twin_gauges, twin_gauges, twin_records_dir

    records = twin_records_dir(flag, tmp_path)
    ev = str(tmp_path / "ev.jsonl")
    got = tharness.main(FLAGS + ["--phases", ONE_EPOCH, "--synthetic_n", "64", "--device",
                                 "cpu", "--adaptive", "--adaptive_model", "twin",
                                 "--twin_records", records, "--adaptive_budget_ms", "1.0",
                                 "--events", ev])
    assert np.isfinite(got["train loss"])
    check_twin_gauges(twin_gauges(ev, "epoch"), records)


TWO_EPOCHS = '[{"ep": 0, "sz": 64, "bs": 32}, {"ep": [0, 2], "lr": [0.1, 0.2]}]'


@pytest.mark.parametrize("flag", ["--stream_every", "--stream_dir", "--stream_rejoin",
                                  "--stream_keyframe_every"])
def test_stream_flags_work(flag, tmp_path):
    """Two synthetic epochs with the flag: the segments its cadence and
    window make, each verifiable (``--stream_rejoin`` on a fresh launch is
    the plain run: there is no world to rejoin)."""
    from tpu_compressed_dp_torch.stream import store

    sd = str(tmp_path / "s")
    extra = {"--stream_every": ["--stream_every", "2"], "--stream_dir": [],
             "--stream_rejoin": ["--stream_rejoin"],
             "--stream_keyframe_every": ["--stream_keyframe_every", "2"]}[flag]
    tharness.main(FLAGS + ["--phases", TWO_EPOCHS, "--synthetic_n", "64", "--device", "cpu",
                           "--stream_dir", sd, *extra])
    problems, seqs = store.verify_stream(sd)
    kinds = [store.read_segment_manifest(sd, q)["kind"]
             + ("*" if store.read_segment_manifest(sd, q)["window_close"] else "") for q in seqs]
    assert problems == [] and kinds == {"--stream_every": ["keyframe*"],
                                        "--stream_keyframe_every": ["keyframe*", "delta*"]}.get(
        flag, ["keyframe*", "delta"]), kinds



@pytest.mark.parametrize("flag", ["--flight_dir", "--tensorboard", "--events", "--adaptive",
                                  "--profile_epoch"])
def test_item13_flags_work(flag, tmp_path):
    """Each flag that raised before item 13 now runs one synthetic epoch and
    leaves its output: the flight profile, TensorBoard's scalars, the event
    stream, the controller's columns, the profiler trace."""
    d = str(tmp_path)
    argv = {"--flight_dir": ["--flight_dir", d + "/fl"],
            "--tensorboard": ["--tensorboard", "--logdir", d],
            "--events": ["--events", d + "/ev.jsonl"],
            "--adaptive": ["--adaptive", "--adaptive_window", "1",
                           "--adaptive_budget_ms", "1e-6"],
            "--profile_epoch": ["--profile_epoch", "0", "--logdir", d]}[flag]
    got = tharness.main(FLAGS + ["--phases", ONE_EPOCH, "--synthetic_n", "64", "--device",
                                 "cpu", *argv])
    want = {"--flight_dir": "fl/flight.rank0.phases.json", "--tensorboard": "tb/scalars.json",
            "--events": "ev.jsonl", "--profile_epoch": "profile/trace.json"}
    if flag == "--adaptive":
        # one window of one epoch, far over budget: rung 0 -> 1
        assert (got["rung"], got["ratio"]) == (1.0, 0.25)
    else:
        assert os.path.exists(os.path.join(d, want[flag])), flag


def test_file_logger_and_average_meter_match_jax(tmp_path, capsys):
    """``FileLogger`` writes JAX's files for the same messages (the debug
    log's timestamps aside) and writes none off the master rank;
    ``AverageMeter`` holds JAX's values bitwise over one update sequence.
    The harness then writes JAX's ``~~epoch`` line to ``event.log``."""
    from tpu_compressed_dp.utils import loggers as jl

    from tpu_compressed_dp_torch.utils import loggers as tl

    for mod, d in ((jl, tmp_path / "jax"), (tl, tmp_path / "port")):
        flog = mod.FileLogger(str(d), rank=0, is_master=True)
        flog.debug("d")
        flog.info("i")
        flog.event("~~0\t0.00001\t\t12.500\t\t50.000\n")
        mod.FileLogger(str(d / "r1"), rank=1, is_master=False).info("quiet")
        assert not (d / "r1").exists()
        for h in flog.logger.handlers:
            h.close()
    for name in ("verbose.log", "event.log"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    strip = lambda p: [ln.split(" ", 2)[2] for ln in p.read_text().splitlines() if ln]  # noqa
    assert strip(tmp_path / "port" / "debug.log") == strip(tmp_path / "jax" / "debug.log")
    out = capsys.readouterr().out
    assert out.count("0: i\n") == 2 and out.count("1: quiet\n") == 2
    rng = np.random.default_rng(0)
    jm, tm = jl.AverageMeter(), tl.AverageMeter()
    for v, n in zip(rng.standard_normal(20).tolist(), rng.integers(1, 5, 20).tolist()):
        jm.update(v, n)
        tm.update(v, n)
        assert vars(tm) == vars(jm)
    d = tmp_path / "run"
    got = tharness.main(FLAGS + ["--phases", ONE_EPOCH, "--synthetic_n", "64", "--device", "cpu",
                                 "--logdir", str(d)])
    (line,) = (d / "event.log").read_text().splitlines()[:1]
    ep, hours, _, top1, _, top5 = line.split("\t")
    assert ep == "~~0" and 0.0 < float(hours) < 1.0
    assert (top1, top5) == (f"{got['top1']:.3f}", f"{got['top5']:.3f}")


def test_refusals():
    with pytest.raises(ValueError, match="requires --compress"):
        tharness.main(["--synthetic", "--method", "topk", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tharness.main(FLAGS)


def test_evaluate_only():
    stats = tharness.main(FLAGS + ["--synthetic_n", "64", "--evaluate", "--device", "cpu"])
    assert stats["count"] == 64 and 0.0 <= stats["acc"] <= stats["acc5"] <= 1.0


def test_meters_match_jax():
    from tpu_compressed_dp.utils import meters as jm

    from tpu_compressed_dp_torch.utils import meters as tm

    for args in ((1e6, 2e5, 4), (3e5, 0.0, 8, 1e4), (0.0, 5e5, 2, 0.0)):
        assert tm.per_chip_traffic_bytes(*args) == jm.per_chip_traffic_bytes(*args)
    for args in ((1e6, 2e5, 8, 1e4, 3e5, 2e4, 1e4, 2), (1e6, 2e5, 4, 0.0, 0.0, 0.0, 0.0, 1)):
        assert tm.per_fabric_traffic_bytes(*args) == jm.per_fabric_traffic_bytes(*args)
    m = {"comm/sent_bits": 8e6, "comm/sent_bits_psum": 3e6, "comm/sent_bits_allgather": 4e6,
         "comm/sent_bits_alltoall": 1e6, "comm/sent_bits_ici": 2e6, "comm/sent_bits_dcn": 1e6,
         "comm/sent_bits_dcn_route": 4e5, "comm/dense_elems": 1e6}
    for world, pods in ((1, 1), (4, 1), (8, 2)):
        assert tm.per_chip_comm_bytes(m, world, pods) == jm.per_chip_comm_bytes(m, world, pods)
        assert tm.per_fabric_comm_bytes(m, world, pods) == jm.per_fabric_comm_bytes(m, world,
                                                                                    pods)
    assert tm.per_chip_comm_bytes({}, 4) is None
    cm = tm.CommMeter(4)
    cm.update(m)
    cm.update({"loss": 1.0})
    out = cm.gbps()
    assert out["net/payload_mb_per_step"] == 1.0 and out["net/compression_frac"] == 0.25
    t = tm.TimeMeter()
    t.batch_loaded()
    t.batch_dispatched()
    assert set(t.summary()) == {"data ms/batch", "dispatch ms/batch"} and t.batches == 1
    recv, sent = tm.NetworkMeter().update_bandwidth()
    assert recv >= 0.0 and sent >= 0.0


def test_cnn_flops_and_peaks():
    from tpu_compressed_dp_torch.models import resnet as tres
    from tpu_compressed_dp_torch.utils import flops as tflops

    # ResNet-50's 4,089,184,256 multiply-adds an image at 224 px (the
    # convolutions' and the classifier's), independent of the compute dtype
    for dtype in (torch.float32, torch.bfloat16):
        model = tres.resnet50(dtype=dtype)
        assert tflops.cnn_fwd_flops(model, (1, 224, 224, 3)) == 2 * 4_089_184_256
    small = tres.resnet18(num_classes=8, width=8)
    one = tflops.cnn_fwd_flops(small, (1, 64, 64, 3))
    assert tflops.cnn_fwd_flops(small, (3, 64, 64, 3)) == 3 * one
    assert small.training  # the count leaves the mode as it found it
    assert tflops.PEAK_FLOPS_FP32["NVIDIA H100 80GB HBM3"] == 67e12
    assert tflops.device_peak_flops("cpu", torch.float32) is None
    rec = tflops.throughput_record(1e12, 2.0, examples_per_sec=10.0, device="cpu",
                                   dtype=torch.float32)
    assert rec == {"throughput/examples_per_sec": 10.0, "throughput/model_tflops_per_chip": 6.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's in-process drives: under the
    tier-1 run's parallel workers a thread per core in every worker
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_best_floor_checkpoint_and_resume(tmp_path, one_torch_thread):
    """``--checkpoint_dir`` with ``--best_floor``: ``save_if_best`` saves
    each epoch whose top-5 beats the best and reaches the floor; the
    phase-boundary save and the resume carry on from it (``--guard`` and a
    poisoned step on the way)."""
    from tpu_compressed_dp_torch.utils import checkpoint as tckpt

    ck = str(tmp_path / "ck")
    two = '[{"ep": 0, "sz": 32, "bs": 32}, {"ep": 1, "sz": 48, "bs": 32}, ' \
          '{"ep": [0, 3], "lr": [0.1, 0.01]}]'
    argv = FLAGS + ["--synthetic_n", "64", "--phases", two, "--device", "cpu", "--guard",
                    "--checkpoint_dir", ck, "--best_floor", "0"]
    first = tharness.main(argv + ["--chaos", "nan,steps=1"])
    assert first["epoch"] == 2 and first["skipped"] == 1.0 and np.isfinite(first["train loss"])
    steps = tckpt.list_step_dirs(ck)
    assert steps and all(tckpt.verify_step_dir(ck, s) == [] for s in steps)
    man = tckpt.read_manifest(ck, steps[-1])
    assert "best_metric" in man["meta"]
    resumed = tharness.main(argv + ["--resume", ck])
    assert resumed["epoch"] == 2


def test_elastic_remesh_redivides_the_loaders(tmp_path):
    """``--elastic`` with worker 1 killed after step 1 on 3 gloo processes:
    ranks 0 and 2 re-form the world, re-divide the loaders (12 images a
    process of the batch of 24) and finish the 2 epochs."""
    from test_torch_elastic_world import harness_world

    argv = ["--synthetic", "--arch", "resnet18", "--width", "8", "--num_classes", "8",
            "--compress", "layerwise", "--method", "topk", "--ratio", "0.05",
            "--error_feedback", "--workers", "1", "--synthetic_n", "72", "--phases",
            '[{"ep": 0, "sz": 32, "bs": 24}, {"ep": [0, 2], "lr": [0.1, 0.01]}]',
            "--peer_timeout", "20", "--chaos", "crash=mid_collective,crash_at_step=1,worker=1"]
    rcs, logs, summaries, epoch = harness_world("tpu_compressed_dp_torch.harness.imagenet",
                                                argv, 3, tmp_path)
    assert rcs[0] == rcs[2] == 0 and rcs[1] != 0, [lg[-2000:] for lg in logs]
    assert epoch["ranks"] == [0, 2]
    for r in (0, 2):
        s = summaries[r]
        assert s["world"] == 2 and s["epoch"] == 1 and s["steps"] == 3
        assert np.isfinite(s["train loss"])
