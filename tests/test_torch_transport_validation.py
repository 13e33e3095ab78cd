"""The port's measured-vs-analytic transport check
(``harness/validate_transport.py``) against the JAX package on the CPU.

The port runs each case on 2 gloo processes at 2^20 elements (2^19 a rank)
and counts each rank's own written bytes (``/proc/self/io`` ``wchar``), so
a neighbour's loopback traffic cannot enter the count (the reference's
system-wide ``lo`` counter takes it in; that is why
``tests/test_transport_validation.py`` passes alone and can fail under a
parallel run).  Against the JAX sync under ``shard_map`` on 2 CPU devices,
on the same gradients:

  * each case's billed ``sent_bits_*`` equal the JAX sync's, exactly;
  * the analytic column equals JAX's ``per_fabric_traffic_bytes`` of those
    bits, as ``tools/validate_transport.py`` bills them;
  * the measured / analytic ratio lies in the reference test's band
    (0.85-1.6) for every case, and the order dense > terngrad > topk-1 %
    holds.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh
from tpu_compressed_dp.utils.meters import per_fabric_traffic_bytes as jfabric

from tpu_compressed_dp_torch.harness import validate_transport as tvt

N = 2 ** 20
PROCS = 2
LABELS = [c[0] for c in tvt.CASES]


@pytest.fixture(scope="module")
def port_run():
    """Every case once, its ranks one intra-op thread each."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rows, recs = tvt.validate(n_param=N, steps=10, procs=PROCS, device="cpu")
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    return {r["case"]: r for r in rows}, {r["case"]: r for r in recs}


def _jax_bits(label: str) -> dict:
    """The JAX engine's stats for the case's config on the ranks' gradients
    (EF zero, key 7), as the reference tool's worker computes them."""
    _, method, mode, extra = next(c for c in tvt.CASES if c[0] == label)
    cfg = jdp.CompressionConfig(
        method=method, granularity="entiremodel", mode=mode,
        ratio=extra.get("ratio", 0.01), block_size=extra.get("block_size", 256),
        transport=extra.get("transport", "allgather"), dp_pods=extra.get("dp_pods", 1),
        error_feedback=extra.get("error_feedback", False))
    sync = jdp.make_grad_sync(cfg, "data")

    def one(g, ef):
        _, _, _, stats = sync({"g": g}, {"g": ef} if cfg.error_feedback else (), (),
                              jax.random.key(7))
        return jax.tree.map(lambda x: x[None], stats)

    g = np.concatenate([tvt.case_gradient(r, PROCS, N) for r in range(PROCS)])
    fn = jax.jit(shard_map(one, mesh=make_data_mesh(PROCS), in_specs=(P("data"), P("data")),
                           out_specs=P("data"), check_vma=False))
    stats = {k: np.asarray(v) for k, v in fn(g, np.zeros_like(g)).items()}
    for k in tvt.BITS_KEYS:
        if k in stats:      # every rank bills the same bits
            assert (stats[k] == stats[k][0]).all(), (label, k, stats[k])
    # rank 0's, as the reference tool reports them
    return {k: float(v[0]) for k, v in stats.items()}


@pytest.mark.parametrize("label", LABELS)
def test_billed_bits_and_analytic_are_jax(port_run, label):
    rows, recs = port_run
    assert label in recs, f"{label}: no record (a worker failed)"
    got, want = recs[label], _jax_bits(label)
    for k in tvt.BITS_KEYS:
        assert got[k] == want.get(k, 0.0), (label, k, got[k], want.get(k))
    # the reference tool's analytic arithmetic on the JAX bits
    b = {k: want.get(k, 0.0) / 8.0 for k in tvt.BITS_KEYS}
    psum_b, ag_b, a2a_b = b["sent_bits_psum"], b["sent_bits_allgather"], b["sent_bits_alltoall"]
    ici_b, dcn_b, rt_b = b["sent_bits_ici"], b["sent_bits_dcn"], b["sent_bits_dcn_route"]
    if psum_b == ag_b == a2a_b == 0.0 and ici_b + dcn_b == 0.0:
        psum_b = b["sent_bits"]
    pods = next(c for c in tvt.CASES if c[0] == label)[3].get("dp_pods", 1)
    analytic = sum(jfabric(psum_b, ag_b, PROCS, a2a_b, ici_b, rt_b, max(dcn_b - rt_b, 0.0),
                           pods)) * PROCS
    assert rows[label]["analytic_bytes_per_step_all_ranks"] == round(analytic, 1)
    assert rows[label]["steps"] == 10


def test_measured_tracks_analytic(port_run):
    rows, _ = port_run
    assert list(rows) == LABELS
    for label, r in rows.items():
        # payload-dominated, bounded framing overhead: the reference test's band
        assert 0.85 < r["ratio_measured_over_analytic"] < 1.6, r
    meas = {c: r["measured_lo_tx_bytes_per_step"] for c, r in rows.items()}
    assert meas["dense"] > meas["terngrad-wire"] > meas["topk-1%-wire-EF"], meas


def test_count_is_the_process_own(tmp_path):
    """Bytes this process writes show in its count; another process's
    writes do not (until this process reaps it, as the kernel accounts
    them)."""
    import subprocess
    import sys
    import time

    before = tvt.written_bytes()
    with open(tmp_path / "a.bin", "wb") as f:
        f.write(b"\0" * 1_000_000)
    mid = tvt.written_bytes()
    assert mid - before >= 1_000_000
    other = tmp_path / "b.bin"
    code = (f"import time; f = open({str(other)!r}, 'wb'); f.write(bytes(4_000_000)); "
            "f.flush(); time.sleep(60)")
    proc = subprocess.Popen([sys.executable, "-c", code])
    try:
        t0 = time.monotonic()
        while not (other.exists() and other.stat().st_size == 4_000_000):
            assert time.monotonic() - t0 < 60, "the other process never wrote"
            time.sleep(0.05)
        assert tvt.written_bytes() - mid < 1_000_000
    finally:
        proc.kill()
        proc.wait()
