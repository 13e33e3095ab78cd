"""The port's delta state stream (``tpu_compressed_dp_torch/stream/``) held
to the JAX package's (``tpu_compressed_dp/stream/``) on the same numpy
inputs from a seed.

  * **The codec.**  ``topk_delta`` / ``flush_delta`` give ``idx`` / ``vals``
    bitwise JAX's, in ``auto`` mode (the exact threshold on both sides) and
    in ``force`` mode (the port's plain histogram search and select+pack
    against JAX's Pallas kernels in interpret mode), on a drift of every
    coordinate and on one that touches fewer than ``keep`` (the early exact
    branch).  The flat vector and spec of a small ResNet-9 and of a tiny
    LM (an MoE layer included) equal JAX's ``flatten_params`` of the
    carried-over parameters.
  * **The writer**, over one append sequence (Top-K deltas, flushes,
    keyframes, a requested keyframe, ``sync``) on a tree and on a model:
    the segment arrays are bitwise JAX's and the manifests equal field for
    field but ``ts``, ``sha256`` and ``bytes`` (``np.savez`` stamps the zip's
    time).
  * **Each package reads the other's stream**: JAX's ``StreamReader`` +
    ``unflatten_like`` reconstructs a port stream bitwise onto the JAX
    parameters and ``verify_stream`` passes on it; the port's reader
    reconstructs a JAX stream, onto a model in the port's layout too.
  * **The window invariant, walk-back and restart** as in the JAX tests,
    the keyframe tee of the Checkpointer (a failing stream never fails a
    save), the declared ``stream/*`` keys, the ``stream_corrupt`` drill
    row, ``watchdog --check --max_stream_lag`` and ``stream_serve --once``.
"""

import copy
import json
import os
import time
import types

import numpy as np
import pytest
import torch

import jax

from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp.stream import delta as jd
from tpu_compressed_dp.stream import reader as jreader
from tpu_compressed_dp.stream import store as jstore
from tpu_compressed_dp.stream import writer as jwriter
from tpu_compressed_dp_torch.models import resnet9 as tres
from tpu_compressed_dp_torch.ops import kernels as tk
from tpu_compressed_dp_torch.stream import delta as td
from tpu_compressed_dp_torch.stream import store as tstore
from tpu_compressed_dp_torch.stream.reader import StreamReader
from tpu_compressed_dp_torch.stream.rejoin import warm_rejoin
from tpu_compressed_dp_torch.stream.writer import StreamWriter

SCALE = 0.125


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small in-process work: under
    the tier-1 run's parallel workers, a thread per core in every worker
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _modes():
    j_mode, t_mode = jk.pallas_mode(), tk.pallas_mode()
    yield
    jk.set_pallas_mode(j_mode)
    tk.set_pallas_mode(t_mode)


def _quiet(*a, **k):
    pass


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _params(rng, scale=1.0):
    return {"dense": {"kernel": (rng.randn(24, 8) * scale).astype(np.float32)},
            "bias": (rng.randn(32) * scale).astype(np.float32)}


def _advance(params, rng, scale=0.01):
    return {"dense": {"kernel": params["dense"]["kernel"]
                      + (rng.randn(24, 8) * scale).astype(np.float32)},
            "bias": params["bias"] + (rng.randn(32) * scale).astype(np.float32)}


def _tensors(tree):
    """The same tree as CPU tensors (the port's writer input)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _same_tree(a, b, what):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert np.array_equal(_bits(x), _bits(y)), f"{what}: a leaf differs"


def _flip_payload(directory, seq):
    path = tstore.segment_payload_path(directory, seq)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------- the codec

@pytest.mark.parametrize("mode", ["auto", "force"])
@pytest.mark.parametrize("touched", [1.0, 0.004])
def test_topk_and_flush_delta_bitwise_jax(mode, touched):
    """The same drift through both codecs: equal idx dtype and idx / vals
    bits.  ``touched`` 0.004 leaves fewer changed coordinates than keep
    (the early exact branch); the drift carries a -0.0 vs 0.0 flip, which
    only a bitwise compare sees."""
    jk.set_pallas_mode(mode)
    tk.set_pallas_mode(mode)
    rng = np.random.RandomState(3)
    n, keep = 150_001, td.keep_for_ratio(150_001, 0.01)
    last = rng.randn(n).astype(np.float32)
    vec = last.copy()
    hit = rng.rand(n) < touched
    vec[hit] += (rng.randn(int(hit.sum())) * 0.01).astype(np.float32)
    last[7], vec[7] = 0.0, -0.0
    for jfn, tfn, args in ((jd.topk_delta, td.topk_delta, (keep,)),
                           (jd.flush_delta, td.flush_delta, ())):
        ji, jv = jfn(vec, last.copy(), *args)
        ti, tv = tfn(torch.from_numpy(vec), torch.from_numpy(last.copy()), *args)
        assert ti.numpy().dtype == ji.dtype == np.int32
        assert np.array_equal(ti.numpy(), ji), (jfn.__name__, ti.shape, ji.shape)
        assert np.array_equal(_bits(tv), _bits(jv)), jfn.__name__
        assert 7 in ti.numpy() or len(ti) == keep


def test_keep_for_ratio_and_residual_match_jax():
    for n, r in ((1, 0.01), (100, 0.0), (6_573_120, 0.01), (1_486_901_248, 0.01), (10, 3.0)):
        assert td.keep_for_ratio(n, r) == jd.keep_for_ratio(n, r)
    assert td.keep_for_ratio(6_573_120, 0.01) == 65_731
    assert td.keep_for_ratio(1_486_901_248, 0.01) == 14_869_012
    rng = np.random.RandomState(2)
    vec, last = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    idx, vals = td.topk_delta(torch.from_numpy(vec), torch.from_numpy(last), 8)
    t_last = td.apply_delta(torch.from_numpy(last.copy()), idx, vals)
    j_last = jd.apply_delta(last.copy(), *jd.topk_delta(vec, last.copy(), 8))
    assert np.array_equal(_bits(t_last), _bits(j_last))
    res = td.residual_of(torch.from_numpy(vec), t_last)
    assert np.array_equal(_bits(res), _bits(jd.residual_of(vec, j_last)))
    assert not res[idx.long()].any()


def _resnet9_pair():
    """A port ResNet-9 and the JAX parameters it was loaded from."""
    from tpu_compressed_dp.models import resnet9 as jres
    from tpu_compressed_dp.models.common import init_model

    fm = jres.ResNet9(channels={k: max(8, int(v * SCALE)) for k, v in
                                {"prep": 64, "layer1": 128, "layer2": 256,
                                 "layer3": 512}.items()})
    params, stats = init_model(fm, jax.random.key(0), jax.numpy.zeros((1, 32, 32, 3)))
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    model = tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=1, device="cpu")
    tres.load_flax_params(model, params, stats)
    return model, params


def _lm_pair():
    """A port tiny LM with an MoE layer and the JAX tree it was loaded from."""
    import dataclasses

    from tpu_compressed_dp.models import transformer as jtf
    from tpu_compressed_dp_torch.models import transformer as ttf

    jcfg = dataclasses.replace(jtf.tiny_llama(), n_experts=4, moe_every=2)
    tcfg = dataclasses.replace(ttf.tiny_llama(), n_experts=4, moe_every=2)
    params = jax.tree.map(np.asarray, jtf.init_llama(jcfg, jax.random.key(0)))
    return ttf.load_jax_params(tcfg, params), params


@pytest.mark.parametrize("which", ["resnet9", "lm"])
def test_flatten_params_matches_jax(which):
    model, params = _resnet9_pair() if which == "resnet9" else _lm_pair()
    tv, tspec = td.flatten_params(model)
    jv, jspec = jd.flatten_params(params)
    assert tspec == jspec
    assert np.array_equal(_bits(tv), _bits(jv))
    # each package unflattens the other's vector onto its own template
    back = td.unflatten_like(model, jv, jspec)
    for k, p in td.param_dict(model).items():
        assert back[k].shape == p.shape and np.array_equal(_bits(back[k]), _bits(p)), k
    _same_tree(jd.unflatten_like(params, tv.numpy(), tspec), params, "JAX unflatten")
    with pytest.raises(ValueError, match="spec"):
        td.unflatten_like(model, jv, [dict(jspec[0], path="['x']")] + jspec[1:])


# --------------------------------------------------------------- the writer

def _drive(writer_cls, directory, seq_of_params, make_input):
    """One append sequence: appends, a requested keyframe, an async append
    and a closing sync."""
    w = writer_cls(directory, ratio=0.05, keyframe_every=4, log=_quiet,
                   wall=lambda: 123.0)
    for step, p in enumerate(seq_of_params[:7], 1):
        if step == 6:
            w.request_keyframe()
        w.append(make_input(p), step=step)
    w.append_async(make_input(seq_of_params[7]), step=8)
    w.drain()
    w.sync(make_input(seq_of_params[8]), step=9)
    w.close()
    return w


def _compare_streams(tdir, jdir):
    seqs = jstore.list_segments(jdir)
    assert tstore.list_segments(tdir) == seqs and len(seqs) == 9
    kinds = []
    for q in seqs:
        tm, ta = tstore.load_segment(tdir, q)
        jm, ja = jstore.load_segment(jdir, q)
        drop = ("ts", "sha256", "bytes")
        assert {k: v for k, v in tm.items() if k not in drop} == \
            {k: v for k, v in jm.items() if k not in drop}, q
        assert sorted(ta) == sorted(ja)
        for k in ja:
            assert ta[k].dtype == ja[k].dtype and np.array_equal(_bits(ta[k]), _bits(ja[k])), (q, k)
        kinds.append(jm["kind"] + ("*" if jm["window_close"] and jm["kind"] == "delta" else ""))
    assert kinds == ["keyframe", "delta", "delta", "delta*", "keyframe", "keyframe", "delta",
                     "delta", "delta*"]
    assert ({k: v for k, v in tstore.read_head(tdir).items() if k != "ts"}
            == {k: v for k, v in jstore.read_head(jdir).items() if k != "ts"})


def test_writer_segments_match_jax_on_a_tree(tmp_path):
    rng = np.random.RandomState(4)
    seq = [_params(rng)]
    for _ in range(8):
        seq.append(_advance(seq[-1], rng))
    tw = _drive(StreamWriter, str(tmp_path / "t"), seq, _tensors)
    jw = _drive(jwriter.StreamWriter, str(tmp_path / "j"), seq, lambda p: p)
    _compare_streams(str(tmp_path / "t"), str(tmp_path / "j"))
    tm, jm = tw.metrics(), jw.metrics()
    assert set(tm) == set(jm)
    for k in ("stream/segments", "stream/keyframes", "stream/bytes", "stream/keyframe_bytes",
              "stream/last_step", "stream/residual_norm"):
        assert tm[k] == jm[k], k
    assert tw.heartbeat_fields().keys() == jw.heartbeat_fields().keys()


def test_writer_segments_match_jax_on_a_resnet9(tmp_path):
    """The port writer appends the live model (in place updates between
    appends, as SGD makes them); JAX appends the flax tree of each state."""
    model, params = _resnet9_pair()
    rng = np.random.RandomState(5)
    trees = []
    leaves = tres.param_leaves(model)
    tw = StreamWriter(str(tmp_path / "t"), ratio=0.05, keyframe_every=4, log=_quiet,
                      wall=lambda: 1.0)
    for step in range(1, 10):
        if step == 6:
            tw.request_keyframe()
        if step == 8:
            tw.append_async(model, step=step)
        elif step == 9:
            tw.sync(model, step=step)
        else:
            tw.append(model, step=step)
        trees.append(jax.tree.map(np.copy, tres.leaves_to_flax(leaves)))
        with torch.no_grad():
            for p in leaves.values():
                # every coordinate moves, a few by much more than the rest
                d = rng.randn(*p.shape).astype(np.float32) * 1e-3
                d[rng.rand(*p.shape) < 0.02] *= 100
                p.add_(torch.from_numpy(d))
    tw.close()
    _drive(jwriter.StreamWriter, str(tmp_path / "j"), trees, lambda p: p)
    _compare_streams(str(tmp_path / "t"), str(tmp_path / "j"))


# -------------------------------------------------- each reads the other

def test_jax_reads_a_port_stream_and_the_port_reads_a_jax_one(tmp_path):
    model, params = _resnet9_pair()
    rng = np.random.RandomState(6)
    leaves = tres.param_leaves(model)
    td_, jd_ = str(tmp_path / "port"), str(tmp_path / "jax")
    tw = StreamWriter(td_, ratio=0.02, keyframe_every=3, log=_quiet)
    jw = jwriter.StreamWriter(jd_, ratio=0.02, keyframe_every=3, log=_quiet)
    for step in range(1, 6):
        tw.append(model, step=step)
        jw.append(tres.leaves_to_flax(leaves), step=step)
        with torch.no_grad():
            for p in leaves.values():
                p.add_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 1e-3))
    tw.sync(model, step=6)
    jw.sync(tres.leaves_to_flax(leaves), step=6)
    tw.close()
    jw.close()
    live = jax.tree.map(np.copy, tres.leaves_to_flax(leaves))
    assert jstore.verify_stream(td_) == ([], list(range(6)))
    # JAX reads the port's stream onto the JAX parameters
    jr = jreader.StreamReader(td_, log=_quiet)
    jr.catch_up()
    assert jr.exact
    _same_tree(jr.params_like(params), live, "JAX reader on a port stream")
    # the port reads JAX's stream, onto the model in its layout and as a tree
    tr = StreamReader(jd_, log=_quiet)
    tr.catch_up()
    assert tr.exact and tr.applied_step == 6
    got = tr.params_like(model)
    for k, p in leaves.items():
        assert np.array_equal(_bits(got[k]), _bits(p)), k
    _same_tree(tr.params_like(params), live, "port reader on a JAX stream")
    assert tstore.verify_stream(jd_) == ([], list(range(6)))


# ------------------------------------ window invariant, walk-back, restart

def test_keyframe_plus_deltas_reconstruct_bitwise(tmp_path):
    sd = str(tmp_path / "stream")
    rng = np.random.RandomState(4)
    params = _params(rng)
    w = StreamWriter(sd, ratio=0.05, keyframe_every=4, log=_quiet)
    r = StreamReader(sd, log=_quiet)
    closes = 0
    for step in range(1, 10):
        w.append(_tensors(params), step=step)
        r.catch_up()
        man = tstore.read_segment_manifest(sd, w.head_seq)
        pvec, _ = jd.flatten_params(params)
        rvec, _ = jd.flatten_params(r.params_like(params))
        if man["window_close"]:
            closes += 1
            assert r.exact and np.array_equal(_bits(pvec), _bits(rvec))
        else:
            diff = pvec.view(np.int32) != rvec.view(np.int32)
            sent = set(np.load(tstore.segment_payload_path(sd, w.head_seq))["idx"].tolist())
            assert sent.isdisjoint(np.flatnonzero(diff).tolist())
        params = _advance(params, rng)
    assert closes >= 2


def test_reader_walks_back_and_recovers(tmp_path):
    sd = str(tmp_path / "stream")
    rng = np.random.RandomState(10)
    params = _params(rng)
    w = StreamWriter(sd, ratio=0.05, keyframe_every=4, log=_quiet)
    w.append(_tensors(params), step=1)               # seq 0 keyframe
    kf = copy.deepcopy(params)
    for step in (2, 3):
        params = _advance(params, rng)
        w.append(_tensors(params), step=step)        # seq 1, 2 deltas
    _flip_payload(sd, 2)
    r = StreamReader(sd, log=_quiet)
    r.catch_up()
    assert r.metrics()["stream/corrupt_segments"] == 1.0 and r.applied_seq == 0
    _same_tree(r.params_like(kf), kf, "walk-back")
    for step in (4, 5):
        params = _advance(params, rng)
        w.append(_tensors(params), step=step)        # seq 3 flush (skipped), 4 keyframe
    w.sync(_tensors(params), step=5)
    r.catch_up()
    assert r.exact
    _same_tree(r.params_like(params), params, "re-anchor")
    w.close()
    # JAX's reader walks the same way over the same (port-written) stream
    jr = jreader.StreamReader(sd, log=_quiet)
    jr.catch_up()
    assert jr.applied_seq == r.applied_seq and jr.exact


def test_restart_past_an_unheaded_segment(tmp_path):
    """A crash between the manifest and the head commit: the restarted
    writer continues past the committed segment with a keyframe, and a
    tailing reader that had scanned it stays exact."""
    sd = str(tmp_path / "stream")
    rng = np.random.RandomState(17)
    params = _params(rng)
    w = StreamWriter(sd, ratio=0.05, keyframe_every=4, log=_quiet)
    for step in (1, 2, 3):
        w.append(_tensors(params), step=step)
        params = _advance(params, rng)
    w.close()
    head = tstore.read_head(sd)
    with open(tstore.head_path(sd), "w") as f:
        json.dump({**head, "seq": head["seq"] - 1}, f)
    r = StreamReader(sd, log=_quiet)
    r.catch_up()
    assert r.applied_seq == 2
    w2 = StreamWriter(sd, ratio=0.05, keyframe_every=4, log=_quiet)
    assert w2.append(_tensors(params), step=4) == 3
    assert tstore.read_segment_manifest(sd, 3)["kind"] == "keyframe"
    r.catch_up()
    _same_tree(r.params_like(params), params, "restart")
    assert r.exact
    w2.close()


def test_no_anchor_raises_and_warm_rejoin_falls_back(tmp_path):
    sd = str(tmp_path / "stream")
    model, _ = _resnet9_pair()
    w = StreamWriter(sd, keyframe_every=4, log=_quiet)
    w.append(model, step=1)
    w.close()
    _flip_payload(sd, 0)
    with pytest.raises(tstore.StreamCorrupt):
        StreamReader(sd, log=_quiet).catch_up()
    flights = []
    state = types.SimpleNamespace(model=model)
    before = {k: p.detach().clone() for k, p in td.param_dict(model).items()}
    out, info = warm_rejoin(state, sd, log=_quiet, flight=types.SimpleNamespace(
        record=lambda *a, **k: flights.append(a)))
    assert out is state and info is None and flights == [("stream", "warm_rejoin_fallback")]
    for k, p in td.param_dict(model).items():
        assert torch.equal(p, before[k]), k
    assert warm_rejoin(state, str(tmp_path / "none"), log=_quiet) == (state, None)


def test_warm_rejoin_adopts_in_place(tmp_path):
    sd = str(tmp_path / "stream")
    src, _ = _resnet9_pair()
    w = StreamWriter(sd, ratio=0.05, keyframe_every=4, log=_quiet)
    w.append(src, step=1)
    with torch.no_grad():
        for p in src.parameters():
            p.mul_(1.5)
    w.sync(src, step=2)
    w.close()
    dst = types.SimpleNamespace(model=tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=9))
    ids = {k: id(p) for k, p in td.param_dict(dst.model).items()}
    out, info = warm_rejoin(dst, sd, log=_quiet)
    assert out is dst and info["exact"] and info["step"] == 2 and info["bytes"] > 0
    for k, p in td.param_dict(dst.model).items():
        assert id(p) == ids[k] and torch.equal(p, td.param_dict(src)[k]), k


# ---------------------------------------------------- the checkpoint's tee

def test_committed_save_requests_a_keyframe_and_never_fails(tmp_path):
    from tpu_compressed_dp_torch.train import optim as toptim
    from tpu_compressed_dp_torch.train.state import TrainState
    from tpu_compressed_dp_torch.utils.checkpoint import Checkpointer

    model = tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=0)
    state = TrainState.create(model, toptim.SGD(lr=0.1).init(tres.param_leaves(model)), ())
    sd = str(tmp_path / "stream")
    w = StreamWriter(sd, ratio=0.05, keyframe_every=32, log=_quiet)
    w.append(model, step=0)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.stream = w
    ckpt.save(state, {"step": 0})
    w.append(model, step=1)
    ckpt.save_async(state, {"step": 1})
    ckpt.drain()
    w.append(model, step=2)
    w.append(model, step=3)
    assert [tstore.read_segment_manifest(sd, q)["kind"] for q in range(4)] == \
        ["keyframe", "keyframe", "keyframe", "delta"]

    class BadStream:
        def request_keyframe(self):
            raise RuntimeError("disk full")

    ckpt.stream = BadStream()
    state.step = 5
    assert ckpt.save(state, {"step": 5}) == 5
    ckpt.close()
    w.close()
    assert ckpt.verify_step(5) == []


def test_stat_keys_declared():
    from tpu_compressed_dp_torch.obs import registry

    w = StreamWriter(os.devnull + "_unused", log=_quiet)
    keys = list(w.metrics()) + list(StreamReader(os.devnull).metrics()) + ["stream/rejoin_bytes"]
    for k in keys:
        assert registry.is_declared(k), k


# --------------------------------------------------- drill, watchdog, serve

def test_stream_corrupt_drill_row():
    from tpu_compressed_dp_torch.harness import chaos_drill

    assert "stream_corrupt" in chaos_drill.QUICK and "stream_corrupt" in chaos_drill.FULL
    got = chaos_drill.run_drills(["stream_corrupt"], "cpu")
    assert got["stream_corrupt"] == {"corrupt_segments": 1, "walkback_seq": 0,
                                     "reconverged": True, "keyframe_fallback": True}


def test_watchdog_check_max_stream_lag(tmp_path):
    from tpu_compressed_dp_torch.harness import watchdog

    hb = str(tmp_path / "hb.json")
    w = StreamWriter(str(tmp_path / "s"), log=_quiet, wall=lambda: 1000.0)
    w.append(_tensors(_params(np.random.RandomState(1))), step=4)
    w._wall = lambda: 1030.0           # thirty seconds since the segment
    with open(hb, "w") as f:
        json.dump({"ts": time.time(), "step": 9, **w.heartbeat_fields()}, f)
    assert w.heartbeat_fields() == {"stream_last_step": 4, "stream_lag_s": 30.0}
    base = ["--check", "--heartbeat", hb]
    assert watchdog.main(base) == 0
    assert watchdog.main(base + ["--max_stream_lag", "60"]) == 0
    assert watchdog.main(base + ["--max_stream_lag", "10"]) == 1


def test_stream_serve_once(tmp_path, capsys):
    from tpu_compressed_dp_torch.harness import stream_serve

    sd = str(tmp_path / "stream")
    rng = np.random.RandomState(13)
    params = _params(rng)
    w = StreamWriter(sd, ratio=0.05, keyframe_every=4, log=_quiet)
    for s in (1, 2):
        w.append(_tensors(params), step=s)
        params = _advance(params, rng)
    w.sync(_tensors(params), step=3)
    w.close()
    snap, hb = str(tmp_path / "snap"), str(tmp_path / "hb.json")
    assert stream_serve.main([sd, "--once", "--snapshot_dir", snap, "--heartbeat", hb]) == 0
    with np.load(os.path.join(snap, "snapshot-3.npz")) as z:
        got = {k: z[k] for k in z.files}
    want = jd.unflatten_dict(*jd.flatten_params(params))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k
    rec = json.load(open(hb))
    assert rec["exact"] is True and rec["applied_step"] == 3 and rec["stream_lag_s"] >= 0.0
    assert stream_serve.main([str(tmp_path / "nope"), "--once"]) == 2
    os.makedirs(str(tmp_path / "empty"))
    assert stream_serve.main([str(tmp_path / "empty"), "--once"]) == 2
    _flip_payload(sd, 0)      # the only keyframe
    assert stream_serve.main([sd, "--once"]) == 1
