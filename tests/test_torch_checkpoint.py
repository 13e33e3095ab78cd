"""The port's checkpoints: the manifest against the JAX package's, and the
save / restore contract within the port.  (The JAX package is imported only
inside the tests that compare with it: the W = 2 workers import this
module's helpers.)

  * Manifest interchange: a port step directory passes the JAX package's
    own ``verify_step_dir`` and reads with its ``read_manifest`` (schema 1,
    keys ``v/step/ts/files/meta``, a sha256 and a size a file); one flipped
    byte fails both with the same problems.
  * Save and restore round-trip bitwise: parameters, BatchNorm buffers,
    momentum, EF, PowerSGD's warm starts, the guard state, step and seed.
  * The walk-back: a corrupt newest step is skipped for the newest
    verifiable one (``ckpt/rollback_steps``); asked for by number it raises.
  * ``save_async`` copies the state before it returns: writes into the live
    tensors right after do not reach the checkpoint.
  * GC keeps the newest ``max_to_keep`` steps and the ``save_if_best`` pin.
  * W = 2 over gloo: one payload file a rank (each rank's own EF, and its
    model shard with ``sharded_model``), rank 0's replicated state, one
    manifest over the world's files; each rank restores its own; a
    checkpoint of another world size is refused naming the elastic item.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpu_compressed_dp_torch.models import resnet9 as tres
from tpu_compressed_dp_torch.parallel import dp as tdp
from tpu_compressed_dp_torch.train import guard as tguard
from tpu_compressed_dp_torch.train import optim as toptim
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small in-process steps: under
    the tier-1 run's parallel workers, a thread per core in every worker
    oversubscribes the machine, and small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0, method="powersgd"):
    """A small train state with every field in use, filled from ``seed``."""
    model = tres.ResNet9(channels=tres.scaled_channels(0.125), seed=seed)
    leaves = tres.param_leaves(model)
    cfg = tdp.CompressionConfig(method=method, rank=2, error_feedback=True)
    opt = toptim.SGD(lr=0.1, momentum=0.9)
    gcfg = tguard.GuardConfig(growth_interval=2)
    state = TrainState.create(model, opt.init(leaves), tdp.init_ef_state(leaves, cfg),
                              seed=11 + seed, comp=tdp.init_comp_state(leaves, cfg, seed=seed),
                              guard=tguard.init_guard_state(gcfg))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in ([*state.opt_state["momentum"].values(), *state.ef.values(),
                   *model.buffers()]):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    gs = state.guard
    for ok, s in ((True, 1), (False, 2), (True, 3)):
        gs = tguard.update_guard(gcfg, gs, ok, s)
    return dataclasses.replace(state, step=3 + seed, guard=gs)


def _tensors(state):
    return ([p.detach().clone() for p in state.model.state_dict().values()]
            + [v.clone() for v in state.opt_state["momentum"].values()]
            + [v.clone() for v in state.ef.values()]
            + ([v.clone() for v in state.comp.values()] if isinstance(state.comp, dict) else []))


def _same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                                           y.contiguous().reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


def _same_state(a, b):
    assert _same(_tensors(a), _tensors(b))
    assert (a.step, a.seed) == (b.step, b.seed)
    assert tguard.guard_to_dict(a.guard).keys() == tguard.guard_to_dict(b.guard).keys()
    for k, v in tguard.guard_to_dict(a.guard).items():
        w = tguard.guard_to_dict(b.guard)[k]
        assert v.dtype == w.dtype and torch.equal(v, w), k


def _flip(directory, step):
    path = os.path.join(directory, str(step), "state.pt")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def test_manifest_interchange_with_jax(tmp_path):
    from tpu_compressed_dp.utils import checkpoint as jckpt

    d = str(tmp_path)
    ck = tckpt.Checkpointer(d)
    ck.save(_state(), {"epoch": 4})
    ck.close()
    assert tckpt.list_step_dirs(d) == jckpt.list_step_dirs(d) == [3]
    assert jckpt.verify_step_dir(d, 3) == tckpt.verify_step_dir(d, 3) == []
    man = jckpt.read_manifest(d, 3)
    assert man == tckpt.read_manifest(d, 3)
    assert set(man) == {"v", "step", "ts", "files", "meta"}
    assert man["v"] == jckpt.MANIFEST_SCHEMA == tckpt.MANIFEST_SCHEMA and man["step"] == 3
    assert set(man["files"]) == {"state.pt", "rank0.pt"}
    for rel, ent in man["files"].items():
        path = os.path.join(d, "3", rel)
        assert ent == {"sha256": jckpt.digest_file(path), "bytes": os.path.getsize(path)}
    assert man["meta"]["epoch"] == 4
    _flip(d, 3)
    assert jckpt.verify_step_dir(d, 3) == tckpt.verify_step_dir(d, 3) == [
        "digest mismatch: state.pt"]
    # a manifest the JAX helpers wrote verifies under the port's
    os.makedirs(os.path.join(d, "9"))
    with open(os.path.join(d, "9", "blob"), "wb") as f:
        f.write(b"\x00\x01" * 100)
    jckpt.write_manifest(d, 9, meta={"x": 1})
    assert tckpt.verify_step_dir(d, 9) == []


def test_roundtrip_bitwise(tmp_path):
    src = _state(0)
    ck = tckpt.Checkpointer(str(tmp_path))
    assert ck.save(src, {"epoch": 1}) == 3
    fresh = _state(5)
    got, meta = ck.restore(fresh)
    assert meta["epoch"] == 1
    _same_state(got, src)
    # the model and momentum were written into the target's own tensors
    assert got.model is fresh.model and got.opt_state is fresh.opt_state
    m = ck.metrics()
    assert set(m) == {"ckpt/save_ms", "ckpt/blocked_ms", "ckpt/inflight", "ckpt/last_step",
                      "ckpt/age_s", "ckpt/rollback_steps"}
    assert m["ckpt/last_step"] == 3.0 and m["ckpt/rollback_steps"] == 0.0
    assert ck.heartbeat_fields()["last_ckpt_step"] == 3
    ck.close()
    # the one-shot helpers and a state with the guard and comp off
    plain = _state(1, method="topk")
    plain = dataclasses.replace(plain, guard=())
    tckpt.save_checkpoint(str(tmp_path / "b"), plain)
    back, _ = tckpt.restore_checkpoint(str(tmp_path / "b"), dataclasses.replace(
        _state(2, method="topk"), guard=()))
    assert back.guard == () and back.comp == ()
    assert _same(_tensors(back), _tensors(plain))


def test_walk_back_past_corrupt_step(tmp_path):
    d = str(tmp_path)
    ck = tckpt.Checkpointer(d, max_to_keep=None)
    states = {}
    for s in (3, 4, 5):
        st = _state(s - 3)
        st = dataclasses.replace(st, step=s)
        ck.save(st, {"epoch": s})
        states[s] = _tensors(st)
    _flip(d, 5)
    got, meta = ck.restore(_state(7))
    assert got.step == 4 and meta["epoch"] == 4
    assert _same(_tensors(got), states[4])
    assert ck.metrics()["ckpt/rollback_steps"] == 1.0
    with pytest.raises(tckpt.CheckpointCorrupt, match="step 5"):
        ck.restore(_state(7), step=5)
    _flip(d, 4)
    _flip(d, 3)
    with pytest.raises(tckpt.CheckpointCorrupt):
        ck.restore(_state(7))
    with pytest.raises(FileNotFoundError):
        tckpt.Checkpointer(str(tmp_path / "empty")).restore(_state(7))


def test_save_async_copies_before_returning(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path))
    st = _state(0)
    want = _tensors(st)
    ck.save_async(st, {"epoch": 0})
    # the next step writes parameters, momentum and EF in place
    with torch.no_grad():
        for t in [*tres.param_leaves(st.model).values(), *st.opt_state["momentum"].values(),
                  *st.ef.values()]:
            t.add_(1.0)
    ck.drain()
    got, _ = ck.restore(_state(4))
    assert _same(_tensors(got), want)
    m = ck.metrics()
    assert m["ckpt/inflight"] == 0.0 and m["ckpt/save_ms"] > 0.0
    assert m["ckpt/blocked_ms"] >= 0.0
    ck.close()


def test_gc_keeps_newest_and_best(tmp_path):
    d = str(tmp_path)
    ck = tckpt.Checkpointer(d, max_to_keep=2)
    for s, metric in ((1, 0.5), (2, 0.9), (3, 0.2), (4, 0.3), (5, 0.95), (6, 0.1), (7, 0.1)):
        st = dataclasses.replace(_state(0), step=s)
        if not ck.save_if_best(st, metric, floor=0.4):
            ck.save(st, {"epoch": s})
    assert tckpt.list_step_dirs(d) == [5, 6, 7]
    assert not any(n.startswith(".pending") for n in os.listdir(d))
    assert sorted(int(n[9:-5]) for n in os.listdir(d) if n.startswith("manifest-")) == [5, 6, 7]
    fresh = tckpt.Checkpointer(d)
    fresh.restore(_state(1))
    assert fresh.best_metric == 0.95 and fresh.best_step == 5


_WORKER = r"""
import dataclasses, sys, numpy as np, torch
sys.path.insert(0, sys.argv[3])
from tests.test_torch_checkpoint import _state, _tensors, _same
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.utils import checkpoint as tckpt
d, port, _, rank = sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
for sharded in (False, True):
    sub = f"{d}/sharded{int(sharded)}"
    # rank-distinct EF (and, sharded, model and momentum): seed 10 * rank
    st = _state(10 * rank if sharded else 0)
    # the compressor state is the same on every rank
    st = dataclasses.replace(st, comp=_state(0).comp)
    with torch.no_grad():
        for t in st.ef.values():
            t.fill_(float(rank + 1))
    st = dataclasses.replace(st, step=7)
    want = _tensors(st)
    ck = tckpt.Checkpointer(sub, sharded_model=sharded)
    ck.save_async(st, {"epoch": 2})
    ck.drain()
    ck.close()
    torch.distributed.barrier()
    got, meta = tckpt.Checkpointer(sub, sharded_model=sharded).restore(_state(3))
    assert got.step == 7 and meta["epoch"] == 2, (got.step, meta)
    assert _same(_tensors(got), want), f"rank {rank} sharded={sharded}"
    assert all(float(t.reshape(-1)[0]) == rank + 1 for t in got.ef.values())
try:
    tckpt.Checkpointer(f"{d}/sharded0", world=1, rank=0).restore(_state(3))
except NotImplementedError as e:
    assert "restores only onto the layout that wrote it" in str(e), e
else:
    raise AssertionError("a W = 2 checkpoint restored at W = 1")
torch.distributed.barrier()
mesh.destroy()
"""


def test_world2_per_rank_files(tmp_path):
    from tpu_compressed_dp.utils import checkpoint as jckpt
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    d = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, d, port, REPO, str(r)], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for sharded in (0, 1):
        sub = os.path.join(d, f"sharded{sharded}")
        assert tckpt.list_step_dirs(sub) == [7]
        man = jckpt.read_manifest(sub, 7)
        assert set(man["files"]) == {"state.pt", "rank0.pt", "rank1.pt"}
        assert jckpt.verify_step_dir(sub, 7) == []
        assert man["meta"]["layout"] == {"world": 2}
        rank1 = torch.load(os.path.join(sub, "7", "rank1.pt"), weights_only=True)
        assert ("model" in rank1) == bool(sharded)
        rep = torch.load(os.path.join(sub, "7", "state.pt"), weights_only=True)
        assert ("model" in rep) != bool(sharded)


def test_follow_world_after_a_remesh(tmp_path):
    """An elastic remesh (``Checkpointer.follow_world``): a write that still
    waits for a gone rank's file is abandoned (its error kept, no hang), and
    the next saves are written, and restore, at the new world; a joiner's
    Checkpointer takes the survivors' pending-directory sequence."""
    src = _state(4)
    ck = tckpt.Checkpointer(str(tmp_path), rank=0, world=3, layout={"mesh": "dp3"})
    ck.save_async(src, {"epoch": 0})           # rank 0 waits for ranks 1-2's files
    time.sleep(0.05)
    t0 = time.monotonic()
    ck.follow_world(0, 2, layout={"mesh": "dp2"})
    assert time.monotonic() - t0 < 5.0 and "abandoned" in str(ck.last_save_error)
    assert ck.layout == {"world": 2, "mesh": "dp2"}
    assert tckpt.list_step_dirs(str(tmp_path)) == []
    ck.follow_world(0, 1)
    assert ck.save(src, {"epoch": 1}) == src.step
    man = tckpt.read_manifest(str(tmp_path), src.step)
    assert man["meta"]["layout"] == {"world": 1, "mesh": "dp2"}
    joiner = tckpt.Checkpointer(str(tmp_path), rank=0, world=1, token="joining")
    joiner.follow_world(0, 1, layout={"mesh": "dp2"}, sequence=ck.sequence())
    assert joiner.sequence() == ck.sequence()
    got, meta = joiner.restore(_state(5))
    _same_state(got, src)
    ck.close()
    joiner.close()
