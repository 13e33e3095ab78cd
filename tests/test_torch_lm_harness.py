"""The port's LM harness and token pipelines against the JAX package's.

  * ``SyntheticTokens`` and ``ByteCorpus`` batches are bitwise the JAX
    module's for the same ``(seed, step, process_index)``;
  * the CPU drive of the entry point (tiny preset, entire-model Top-K 1 % +
    EF, 30 steps) learns the motifs: its loss ends below ``log(vocab)``;
  * every JAX flag the port does not carry yet raises
    ``NotImplementedError`` naming its ROADMAP item, the flag names and
    defaults are the JAX parser's, and CUDA is the default device;
  * the mesh and sync flags drive the entry point on 2 gloo processes
    (``--tp 2``, ``--sp 2``, ``--remat``, ``--overlap 2``, ``--method
    powersgd``, ``--experts 4``, ``--pp 2 --microbatches 2``), each with a
    finite first-step loss equal to the JAX
    harness's to rtol 1e-5 (float32; the port's processes start from the
    JAX harness's ``init_llama`` parameters, injected as the tests inject
    JAX's draws elsewhere);
  * the MFU accounting matches the JAX closed form and is absent off the
    card;
  * the robustness flags on 2 gloo processes of ``--pp 2`` (``--guard``,
    Inf on the loss at step 1, ``--checkpoint_dir --ckpt_every 2``): a
    ``--resume`` from step 2 ends at the uninterrupted run's step-4
    checkpoint, every rank's file bitwise.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from tpu_compressed_dp.data import lm as jdata
from tpu_compressed_dp.harness import lm as jharness
from tpu_compressed_dp.models import transformer as jtf
from tpu_compressed_dp.utils import flops as jflops

import torch

from tpu_compressed_dp_torch.data import lm as tdata
from tpu_compressed_dp_torch.harness import lm as tharness
from tpu_compressed_dp_torch.utils import flops as tflops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's in-process torch work: under
    the tier-1 run's parallel workers, a thread per core in every worker
    oversubscribes the machine, and small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # a dead process's EF is lost with it: the port drops it and refuses
    # fold, where JAX's multi-process runtime accepts fold and drops
    assert (tflags["elastic_ef"], jflags["elastic_ef"]) == ("drop", "fold")
    for dest, default in jflags.items():
        if dest in ("job_id", "elastic_ef"):
            continue  # the JAX default reads $TCDP_JOB_ID
        assert tflags[dest] == default, dest


# the elastic flags (item 12) and the telemetry and control flags (item 13)
# were cases of test_unported_flags_raise until they were ported
# (test_elastic_lm_* and test_item13_flags_work), then the stream flags
# (test_stream_flags_work) and the twin flags (test_twin_flags_work)
@pytest.mark.parametrize("flag", ["--twin_records", "--adaptive_model"])
def test_twin_flags_work(flag, tmp_path):
    """Four tiny steps under ``--adaptive --adaptive_model twin``, a log
    window of 2: the step records carry the ``twin/*`` gauges, calibrated
    from the flag's records directory."""
    from tests.test_torch_dawn_drive import check_twin_gauges, twin_gauges, twin_records_dir

    records = twin_records_dir(flag, tmp_path)
    ev = str(tmp_path / "e.jsonl")
    got = tharness.main(["--device", "cpu", "--preset", "tiny", "--steps", "4", "--log_every",
                         "2", "--seq_len", "32", "--global_batch", "2", "--fp32", "--compress",
                         "entiremodel", "--method", "topk", "--ratio", "0.05",
                         "--error_feedback", "--adaptive", "--adaptive_model", "twin",
                         "--twin_records", records, "--adaptive_budget_ms", "1.0",
                         "--events", ev])
    assert math.isfinite(got["loss"]), got
    check_twin_gauges(twin_gauges(ev, "step"), records)


@pytest.mark.parametrize("flag", ["--stream_every", "--stream_keyframe_every", "--stream_ratio",
                                  "--stream_dir", "--stream_rejoin"])
def test_stream_flags_work(flag, tmp_path):
    """Four tiny steps with the flag: the segments its cadence and window
    make, each verifiable, and a delta of ``--stream_ratio``'s keep."""
    from tpu_compressed_dp_torch.stream import delta, store

    sd = str(tmp_path / "s")
    extra = {"--stream_every": ["--stream_every", "2"],
             "--stream_keyframe_every": ["--stream_keyframe_every", "2"],
             "--stream_ratio": ["--stream_ratio", "0.1"], "--stream_dir": [],
             "--stream_rejoin": ["--stream_rejoin"]}[flag]
    tharness.main(["--device", "cpu", "--preset", "tiny", "--steps", "4", "--log_every", "2",
                   "--seq_len", "32", "--global_batch", "2", "--fp32", "--compress",
                   "entiremodel", "--method", "topk", "--ratio", "0.05", "--error_feedback",
                   "--stream_dir", sd, *extra])
    problems, seqs = store.verify_stream(sd)
    mans = [store.read_segment_manifest(sd, q) for q in seqs]
    kinds = [m["kind"] + ("*" if m["window_close"] else "") for m in mans]
    assert problems == [] and kinds == {
        "--stream_every": ["keyframe*", "delta"],
        "--stream_keyframe_every": ["keyframe*", "delta*", "keyframe*", "delta*"]}.get(
        flag, ["keyframe*", "delta", "delta", "delta"]), kinds
    n = int(np.load(store.segment_payload_path(sd, seqs[0]))["vals"].shape[0])
    keep = delta.keep_for_ratio(n, 0.1 if flag == "--stream_ratio" else 0.01)
    # a Top-K delta's nnz is the keep, or fewer where fewer coordinates
    # moved; a flush carries every moved coordinate
    for m in mans[1:]:
        assert 0 < m["nnz"] <= (n if m["window_close"] else keep), (m["nnz"], keep)



_ITEM13 = ["--adaptive_deadband", "--adaptive_rungs", "--job_id", "--flight_dir", "--adaptive",
           "--adaptive_window", "--events", "--prom"]


@pytest.mark.parametrize("flag", _ITEM13)
def test_item13_flags_work(flag, tmp_path):
    """Each flag that raised before item 13 now drives a 4-step tiny run and
    shows its effect: the controller's rung and ratio columns (the deadband,
    rungs and window flags on top of ``--adaptive``), the job-scoped event
    file, the flight profile, the event stream, the Prometheus file."""
    d = str(tmp_path)
    adaptive = ["--compress", "entiremodel", "--method", "topk", "--ratio", "0.05",
                "--error_feedback", "--adaptive", "--adaptive_budget_ms", "1e-6"]
    argv = {"--adaptive_deadband": [*adaptive, "--adaptive_deadband", "0.5"],
            "--adaptive_rungs": [*adaptive, "--adaptive_rungs", "0.05,0.02",
                                 "--adaptive_window", "2"],
            "--job_id": ["--job_id", "j1", "--events", d + "/e.jsonl"],
            "--flight_dir": ["--flight_dir", d + "/f"],
            "--adaptive": adaptive,
            "--adaptive_window": [*adaptive, "--adaptive_window", "4"],
            "--events": ["--events", d + "/e.jsonl"],
            "--prom": ["--prom", d + "/m.prom"]}[flag]
    got = tharness.main(["--device", "cpu", "--preset", "tiny", "--steps", "4", "--log_every",
                         "2", "--seq_len", "32", "--global_batch", "2", "--fp32", *argv])
    if flag.startswith("--adaptive"):
        # far over budget, so each closed window steps one rung down: the
        # default window of 8 updates never closes in 4 steps, a window of
        # 4 closes once, one of 2 twice (on a ladder of two rungs)
        want = {"--adaptive_window": (1.0, 0.025), "--adaptive_rungs": (1.0, 0.02)}.get(
            flag, (0.0, 0.05))
        assert (got["rung"], got["ratio"]) == want, (flag, got)
    else:
        want = {"--job_id": "j1.e.jsonl", "--flight_dir": "f/flight.rank0.phases.json",
                "--events": "e.jsonl", "--prom": "m.prom"}[flag]
        assert os.path.exists(os.path.join(d, want)), flag


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DRIVE = ["--preset", "tiny", "--steps", "1", "--log_every", "1", "--seq_len", "64",
          "--global_batch", "4", "--fp32", "--seed", "3"]
_TOPK = ["--method", "topk", "--ratio", "0.05", "--error_feedback"]
# label -> (port flags, JAX flags): 2 processes each; the JAX harness runs
# the same mesh on 2 virtual devices
MESH_DRIVES = {
    "tp2": (["--tp", "2", "--compress", "entiremodel", *_TOPK], ["--dp", "1", "--tp", "2"]),
    "sp2": (["--sp", "2", "--compress", "entiremodel", *_TOPK], ["--dp", "1", "--sp", "2"]),
    "remat": (["--remat", "--sp", "2", "--compress", "layerwise", *_TOPK],
              ["--dp", "1", "--sp", "2", "--remat"]),
    "overlap2": (["--overlap", "2", "--compress", "layerwise", *_TOPK],
                 ["--dp", "2", "--overlap", "2"]),
    # the first step's loss comes before any sync; the JAX LM step refuses
    # PowerSGD on this JAX (ROADMAP.md queue 3), so its dense run is the
    # reference
    "powersgd": (["--method", "powersgd", "--rank", "2", "--compress", "layerwise",
                  "--error_feedback"], ["--dp", "2"]),
    # 4 experts on every second layer (its capacity per worker's tokens)
    "experts4": (["--experts", "4", "--compress", "entiremodel", *_TOPK],
                 ["--dp", "2", "--experts", "4"]),
    # two GPipe stages of one layer each, two microbatches
    "pp2": (["--pp", "2", "--microbatches", "2", "--compress", "entiremodel", *_TOPK],
            ["--dp", "1", "--pp", "2", "--microbatches", "2"]),
}

_DRIVE_WORKER = r"""
import json, sys
import numpy as np
from tpu_compressed_dp_torch.harness import lm
from tpu_compressed_dp_torch.models import transformer as tf
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.train import pp_step
out, port, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
saved = np.load(sys.argv[5])
flat = {k: saved[k] for k in saved.files}
tree = {"embed": flat.pop("embed"), "final_norm": flat.pop("final_norm"),
        "lm_head": flat.pop("lm_head")}
n_layers = 1 + max(int(k.split(".")[1]) for k in flat)
tree["layers"] = [{k.split(".")[2]: v for k, v in flat.items() if k.startswith(f"layers.{i}.")}
                  for i in range(n_layers)]
llama = tf.Llama


def from_jax(cfg, *, seed=0, device=None, tensor_rank=0, tensor_size=1, layers=None):
    # the whole model: a pipeline stage takes its layers from it
    tf.Llama = llama
    try:
        return tf.load_jax_params(cfg, tree, tensor_rank, tensor_size, device=device)
    finally:
        tf.Llama = from_jax


tf.Llama = pp_step.Llama = from_jax
summary = lm.main(json.loads(sys.argv[4]))
with open(out, "w") as f:
    json.dump(summary, f)
mesh.destroy()
"""


@pytest.fixture(scope="module")
def mesh_drives(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = tmp_path_factory.mktemp("lm_mesh_drives")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = {}
    for label, (flags, jflags) in MESH_DRIVES.items():
        # the JAX harness's initial parameters (init_llama of its seed and
        # config)
        jargs = jharness.build_parser().parse_args(_DRIVE + jflags)
        params = jtf.init_llama(jharness.build_config(jargs), jax.random.key(jargs.seed))
        names = [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
        np.savez(out / f"{label}_params.npz", **{n: np.asarray(a) for n, a in
                                                 zip(names, jax.tree.leaves(params))})
        port = str(free_port())
        procs[label] = [subprocess.Popen(
            [sys.executable, "-c", _DRIVE_WORKER, str(out / f"{label}_{r}.json"), port, str(r),
             json.dumps(_DRIVE + ["--device", "cpu"] + flags), str(out / f"{label}_params.npz")],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
    results = {}
    for label, ps in procs.items():
        logs = [p.communicate(timeout=300)[0] for p in ps]
        for p, log in zip(ps, logs):
            assert p.returncode == 0, log[-3000:]
        results[label] = [json.loads((out / f"{label}_{r}.json").read_text()) for r in range(2)]
    return results


@pytest.mark.parametrize("label", list(MESH_DRIVES))
def test_mesh_flags_drive_and_match_the_jax_first_step(mesh_drives, label):
    port_flags, jax_flags = MESH_DRIVES[label]
    want = jharness.main(_DRIVE + jax_flags)["loss"]
    for summary in mesh_drives[label]:
        assert summary["step"] == 1 and math.isfinite(summary["loss"])
        np.testing.assert_allclose(summary["loss"], want, rtol=1e-5)
        if "--method" in port_flags:
            assert 0.0 < summary["sent frac"] < 1.0


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



_PP_CKPT_WORKER = r"""
import json, sys
from tpu_compressed_dp_torch.harness import lm
from tpu_compressed_dp_torch.parallel import mesh
port, rank = sys.argv[1], int(sys.argv[2])
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
lm.main(json.loads(sys.argv[3]))
mesh.destroy()
"""


def _pp_world(argv):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _PP_CKPT_WORKER, port, str(r),
                               json.dumps(argv)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def test_pp_guard_checkpoint_resume_bitwise(tmp_path):
    import shutil

    from tpu_compressed_dp_torch.utils import checkpoint as tckpt

    argv = ["--preset", "tiny", "--device", "cpu", "--steps", "4", "--seq_len", "64",
            "--global_batch", "4", "--fp32", "--pp", "2", "--microbatches", "2",
            "--compress", "entiremodel", *_TOPK, "--guard", "--chaos",
            "inf,target=loss,steps=1", "--ckpt_every", "2", "--log_every", "2"]
    full, cut, rest = (str(tmp_path / n) for n in ("full", "cut", "rest"))
    _pp_world(argv + ["--checkpoint_dir", full])
    assert tckpt.list_step_dirs(full) == [2, 4]
    man = tckpt.read_manifest(full, 4)
    assert set(man["files"]) == {"state.pt", "rank0.pt", "rank1.pt"}
    assert man["meta"]["layout"] == {"world": 2, "mesh": "dp1xsp1xpp2xtp1(mb2)"}
    shutil.copytree(full, cut)
    shutil.rmtree(os.path.join(cut, "4"))
    os.remove(tckpt.manifest_path(cut, 4))
    logs = _pp_world(argv + ["--resume", cut, "--checkpoint_dir", rest])
    assert "resumed step 2" in logs[0]
    for rel in ("state.pt", "rank0.pt", "rank1.pt"):
        want = torch.load(os.path.join(full, "4", rel), weights_only=True)
        got = torch.load(os.path.join(rest, "4", rel), weights_only=True)
        _same_tree(got, want, rel)
    # each stage's file holds its own layers
    r0 = torch.load(os.path.join(full, "4", "rank0.pt"), weights_only=True)
    r1 = torch.load(os.path.join(full, "4", "rank1.pt"), weights_only=True)
    assert not all(torch.equal(r0["model"][k], r1["model"][k]) for k in r0["model"]
                   if k.startswith("layers"))


def _same_tree(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    else:
        assert got == want, where


def test_elastic_lm_remesh_on_the_data_axis(tmp_path):
    """``--elastic`` on 3 gloo processes of the tiny LM, worker 2 killed
    after step 3: ranks 0 and 1 re-form the world, re-run step 3 on 2 ranks
    over the batch cut to 6 rows and finish at step 6."""
    from test_torch_elastic_world import harness_world

    argv = ["--preset", "tiny", "--steps", "6", "--seq_len", "32", "--global_batch", "6",
            "--fp32", "--compress", "entiremodel", "--method", "topk", "--ratio", "0.05",
            "--error_feedback", "--log_every", "2", "--peer_timeout", "20", "--chaos",
            "crash=mid_collective,crash_at_step=3,worker=2"]
    rcs, logs, summaries, epoch = harness_world("tpu_compressed_dp_torch.harness.lm", argv, 3,
                                                tmp_path)
    assert rcs[:2] == [0, 0] and rcs[2] != 0, [lg[-2000:] for lg in logs]
    assert epoch["ranks"] == [0, 1]
    for r in (0, 1):
        assert summaries[r]["step"] == 6 and summaries[r]["world"] == 2
        assert math.isfinite(summaries[r]["loss"])


@pytest.mark.parametrize("argv,err,match", [
    (["--pp", "2"], ValueError, "orphans a pipeline stage"),
    (["--sp", "2"], NotImplementedError, r"item 12 \(elastic, model axes\)"),
    (["--tp", "2"], NotImplementedError, r"item 12 \(elastic, model axes\)")])
def test_elastic_lm_model_axes_refused(argv, err, match):
    with pytest.raises(err, match=match):
        tharness.main(["--device", "cpu", "--steps", "1", "--elastic", *argv])
