"""The dawn harness's protocol flags against the JAX harness.

  * ``--ratio_warmup_epochs``: the port's ``warmup_ratio_for_epoch`` equals
    the JAX harness's for every epoch, bitwise, over ratios, warm-up lengths
    and methods; a run rebuilds its sync per ratio (the wire sent fraction
    of the first epoch is the warm-up ratio's keep count);
  * ``--lr_schedule step``: ``lr_phases_to_knots`` equals the JAX one, and
    the learning rate at every step of the ``step`` and ``dawn`` schedules
    equals the JAX harness's (``sched(step / steps_per_epoch) / batch``),
    bitwise;
  * ``--synthetic_hard``: the port's arrays equal the JAX package's bitwise;
  * ``--job_id`` names ROADMAP item 13 in both of the port's harnesses.

``--clip_sent_norm`` is held against the JAX step in
``tests/test_torch_resnet9_step.py``.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_compressed_dp.data import cifar10 as jdata
from tpu_compressed_dp.harness import dawn as jdawn
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp_torch.data import cifar10 as tdata
from tpu_compressed_dp_torch.harness import dawn as tdawn
from tpu_compressed_dp_torch.harness import lm as tlm
from tpu_compressed_dp_torch.models import resnet9 as tres
from tpu_compressed_dp_torch.ops import compressors as tc
from tpu_compressed_dp_torch.train import schedules as tsched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("method", ["topk", "randomk", "blocktopk", "thresholdv", "terngrad",
                                    "randomdithering", None])
def test_warmup_ratios_bitwise(method):
    for ratio in (0.001, 0.01, 0.05, 0.3, 0.9999):
        for warmup in (0, 1, 2, 3, 5, 8):
            for epoch in range(12):
                kw = dict(ratio=ratio, warmup_epochs=warmup, method=method)
                got = tdawn.warmup_ratio_for_epoch(epoch, **kw)
                want = jdawn.warmup_ratio_for_epoch(epoch, **kw)
                assert type(got) is type(want) and got == want, (kw, epoch)


def test_lr_phases_to_knots_match():
    for phases in ([{"ep": (0, 3.0), "lr": (0.0, 0.4)}, {"ep": 3.0, "lr": 0.4},
                    {"ep": 14.4, "lr": 0.04}, {"ep": 20.4, "lr": 0.004}],
                   [{"ep": 0, "lr": 1.0}, {"ep": [1, 2], "lr": [1.0, 0.5]}, {"ep": 2, "sz": 3},
                    {"ep": 2, "lr": 0.1}],
                   [{"ep": (0, 1), "lr": (0.1, 0.2)}]):
        assert tsched.lr_phases_to_knots(phases) == jsched.lr_phases_to_knots(phases)


def _jax_harness_sched(args, epochs):
    """The JAX harness's schedule, as its run() builds it (`harness/dawn.py`)."""
    ramp_ep = 5 if epochs > 5 else epochs / 2
    if args.lr_schedule == "step":
        ramp_s = epochs / 8.0
        knots, vals = jsched.lr_phases_to_knots([
            {"ep": (0, ramp_s), "lr": (0.0, args.peak_lr)},
            {"ep": ramp_s, "lr": args.peak_lr},
            {"ep": 0.6 * epochs, "lr": args.peak_lr / 10.0},
            {"ep": 0.85 * epochs, "lr": args.peak_lr / 100.0},
        ])
        return jsched.piecewise_linear(knots, vals)
    return jsched.piecewise_linear([0, ramp_ep, epochs], [0, args.peak_lr, 0])


@pytest.mark.parametrize("schedule", ["step", "dawn"])
@pytest.mark.parametrize("epochs,spe,bs", [(24, 97, 512), (3, 4, 32), (8, 13, 64)])
def test_schedule_lrs_bitwise_every_step(schedule, epochs, spe, bs):
    args = argparse.Namespace(lr_schedule=schedule, peak_lr=0.4)
    sched_j = _jax_harness_sched(args, epochs)
    sched_t = tdawn.lr_schedule(args, epochs)
    steps = np.arange(epochs * spe + 2)
    want = np.asarray(sched_j(jnp.asarray(steps, jnp.int32) / spe) / bs)
    got = np.array([sched_t(np.float32(s) / np.float32(spe)) / np.float32(bs) for s in steps],
                   np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the summary's per-epoch lr
    for e in range(epochs):
        assert np.float32(sched_t(e + 1)) == np.asarray(sched_j(e + 1))


def test_synthetic_hard_bitwise():
    got = tdata.synthetic_cifar10_hard(n_train=192, n_test=64)
    want = jdata.synthetic_cifar10_hard(n_train=192, n_test=64)
    for split in ("train", "test"):
        for key in ("data", "labels"):
            a, b = got[split][key], want[split][key]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_job_id_is_item_13_in_both_harnesses(tmp_path):
    """``--job_id`` (item 13, ported) parses in both harnesses as in JAX's,
    and scopes the telemetry files' names: ``dir/<job>.file``."""
    assert tdawn.parse_args(["--job_id", "j0"]).job_id == "j0"
    assert jdawn.build_parser().parse_args(["--job_id", "j0"]).job_id == "j0"
    d = str(tmp_path)
    tlm.main(["--job_id", "j0", "--device", "cpu", "--steps", "1", "--log_every", "1",
              "--seq_len", "32", "--global_batch", "2", "--fp32", "--events", d + "/ev.jsonl"])
    assert os.path.exists(os.path.join(d, "j0.ev.jsonl"))


def test_ratio_warmup_rebuilds_the_sync():
    # wire Top-K at entiremodel bills exactly the group's keep count, so the
    # sent fraction shows which ratio each epoch's sync was built with
    n = sum(p.numel() for p in tres.param_leaves(
        tres.ResNet9(channels=tres.scaled_channels(0.125), seed=0, device="cpu")).values())
    base = ["--synthetic", "--synthetic_n", "64", "--batch_size", "32", "--compress",
            "entiremodel", "--method", "topk", "--ratio", "0.01", "--error_feedback",
            "--mode", "wire", "--device", "cpu", "--channels_scale", "0.125", "--log_dir", ""]
    for epochs, warmup in ((1, 3), (2, 2), (3, 2)):
        summary = tdawn.main(base + ["--epochs", str(epochs), "--ratio_warmup_epochs",
                                     str(warmup)])
        r = jdawn.warmup_ratio_for_epoch(epochs - 1, ratio=0.01, warmup_epochs=warmup,
                                         method="topk")
        assert summary["sent frac"] == tc.topk_keep_count(n, r) / n, (epochs, warmup, r)
    assert jdawn.warmup_ratio_for_epoch(0, ratio=0.01, warmup_epochs=3, method="topk") == 0.22
    with pytest.raises(ValueError, match="adaptive"):
        tdawn._check_slice(argparse.Namespace(network="resnet9", method="topk",
                                              compress="entiremodel", adaptive=True,
                                              ratio_warmup_epochs=2))


# --- the W = 4 loss-tracking acceptance run -----------------------------------------

W4_ARGV = ["--synthetic", "--synthetic_n", "512", "--batch_size", "64", "--epochs", "2",
           "--compress", "entiremodel", "--method", "topk", "--ratio", "0.01",
           "--error_feedback", "--channels_scale", "0.125"]
W4_SEEDS = (0, 1, 2, 3)


# runs a harness's main with argv[3:], recording each epoch's train loss as
# the table logger receives it (rank 0 only), to the JSON file argv[1];
# argv[2] is jax64 (the JAX harness computing in float64), jax32 (in
# float32) or torch (the port, from the JAX harness's initial weights)
_RUNNER = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", sys.argv[2] == "jax64")
from tpu_compressed_dp.harness import dawn as jdawn
if sys.argv[2] == "jax64":
    resnet9_f32 = jdawn.MODELS["resnet9"]
    jdawn.MODELS["resnet9"] = lambda s, dtype: resnet9_f32(s, dtype=jnp.float64)
if sys.argv[2] == "torch":
    from tpu_compressed_dp_torch.harness import dawn
    from tpu_compressed_dp_torch.models import resnet9
    from tpu_compressed_dp_torch.utils import loggers
    seed = int(sys.argv[sys.argv.index("--seed") + 1])
    params, stats = jdawn.init_model(jdawn.MODELS["resnet9"](0.125, dtype=jnp.float32),
                                     jax.random.key(seed), jnp.zeros((1, 32, 32, 3), jnp.float32))
    planted = []
    def jax_init(channels, seed, device):
        planted.append(seed)
        model = resnet9.ResNet9(channels=channels, seed=seed, device=device)
        resnet9.load_flax_params(model, jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray, stats))
        return model
    # plant through the table the harness builds its net from
    dawn.MODELS["resnet9"] = lambda s, dtype, seed, device: jax_init(
        resnet9.scaled_channels(s), seed, device)
else:
    from tpu_compressed_dp.utils import loggers
    dawn = jdawn
losses, append = [], loggers.TableLogger.append
def record(self, row):
    losses.append(float(row["train loss"]))
    append(self, row)
loggers.TableLogger.append = record
dawn.main(sys.argv[3:])
if sys.argv[2] == "torch" and not planted:
    sys.exit("the JAX initial weights were never planted: the harness did not build "
             "its net through dawn.MODELS")
if losses:
    with open(sys.argv[1], "w") as f:
        json.dump(losses, f)
"""


def _jax_losses(tmp_path, kind, seed):
    out = str(tmp_path / f"{kind}{seed}.json")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", _RUNNER, out, kind, *W4_ARGV, "--seed", str(seed),
                          "--devices", "4", "--log_dir", ""], cwd=REPO, capture_output=True,
                         text=True, timeout=600, env=env)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    with open(out) as f:
        return np.asarray(json.load(f))


def _port_losses(tmp_path, seed):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path / f"torch{seed}.json")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RUNNER, out, "torch", *W4_ARGV, "--seed", str(seed), "--device",
         "cpu", "--log_dir", ""], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="4",
                            MASTER_ADDR="localhost", MASTER_PORT=str(port)))
        for r in range(4)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(out) as f:
        return np.asarray(json.load(f))


@pytest.mark.slow
def test_dawn_w4_tracks_jax_loss(tmp_path):
    """The port's dawn at W = 4 gloo ranks against the JAX dawn on a 4-device
    CPU mesh, from the same initial weights, over four seeds: Top-K 1 % + EF
    entiremodel, 2 epochs of 8 steps of the scaled ResNet-9 at the
    protocol's learning rate.  The reference computes in float64 (its
    float32 CPU gradients are off by up to ~5 %).  Every seed's first epoch
    is within the Top-K + EF contract (1e-3 relative).  At the peak rate a
    float32 trajectory then leaves the float64 one, so each later epoch is
    held to the reference's own float32 spread over the seeds: every seed's
    gap within twice the largest JAX float32-vs-float64 gap at that epoch,
    and the gaps' RMS over the seeds within twice the JAX float32 gaps'."""
    got, want, j32 = (np.stack([f(s) for s in W4_SEEDS]) for f in (
        lambda s: _port_losses(tmp_path, s), lambda s: _jax_losses(tmp_path, "jax64", s),
        lambda s: _jax_losses(tmp_path, "jax32", s)))
    assert got.shape == want.shape == j32.shape == (len(W4_SEEDS), 2)
    assert np.isfinite(got).all()
    gap, spread = np.abs(got - want) / want, np.abs(j32 - want) / want
    for s, g, w, j, a, b in zip(W4_SEEDS, got, want, j32, gap, spread):
        print(f"seed {s}: port {g.tolist()} jax float64 {w.tolist()} jax float32 {j.tolist()}; "
              f"relative gap to float64: port {a.tolist()}, jax float32 {b.tolist()}")
    np.testing.assert_array_less(gap[:, 0], 1e-3)
    assert np.all(gap <= np.maximum(1e-3, 2 * spread.max(axis=0))), (gap, spread)
    rms = lambda a: np.sqrt((a ** 2).mean(axis=0))  # noqa: E731
    assert np.all(rms(gap) <= np.maximum(1e-3, 2 * rms(spread))), (rms(gap), rms(spread))
