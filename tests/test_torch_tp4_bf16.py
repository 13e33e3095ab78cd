"""16-bit sums over a tensor group of 4: the port against the JAX package.

``mesh._sum_exact`` sums bf16 in float32 over the group and rounds once.
XLA's CPU ``psum`` of bf16 over 4 devices does the same (a pairwise or
running sum rounded to bf16 at every step would differ in ~30 % of the
entries of the data below), so the port's ``reduce_from_group`` is held
bitwise to the JAX ``psum`` on ``make_lm_mesh(1, 1, 4)``.  A bf16 forward of
a tiny LM (4 KV heads, so that heads split 4 ways) at ``(1, 1, 4)`` on 4
spawned gloo ranks then holds to the JAX bf16 forward within the
reference's own bf16 error: the largest |port - JAX| logit gap is at most
the largest gap between JAX's bf16 and float32 forwards on the same mesh,
and the port's own gap to that float32 forward at most 1.25 times JAX's.
Two bf16 runs of this model differ by ~5 % of the logits' rms whatever the
mesh (0.047 at tensor size 1), so a fixed share of the rms is no contract
here.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.models import transformer as jtf
from tpu_compressed_dp.train import lm_step as jlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_J = dataclasses.replace(jtf.tiny_llama(), n_kv_heads=4, dtype=jnp.bfloat16)
TP = 4

_WORKER = r"""
import json, sys, numpy as np, torch
from tpu_compressed_dp_torch.models import transformer as tf
from tpu_compressed_dp_torch.parallel import mesh
out, port, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=4, rank=rank)
g = mesh.lm_groups(1, 1, 4)
inp = np.load(f"{out}/inputs.npz")
meta = json.loads(str(inp["meta"]))
x = torch.from_numpy(inp["sum_in"][rank]).to(torch.bfloat16)
res = {"sum": mesh.reduce_from_group(x, g.tensor).to(torch.float32).numpy()}
names = meta["names"]
params = {k: inp[f"p{i}"] for i, k in enumerate(names)}
cfg = tf.LlamaConfig(**{**meta["cfg"], "dtype": torch.bfloat16})
tree = {"embed": params["embed"], "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
        "layers": [{k.split(".")[2]: v for k, v in params.items()
                    if k.startswith(f"layers.{i}.")} for i in range(cfg.n_layers)]}
model = tf.load_jax_params(cfg, tree, g.tensor_index, 4)
with torch.no_grad():
    res["logits"] = model(torch.from_numpy(inp["tokens"]), tensor_group=g.tensor).to(
        torch.float32).numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
mesh.destroy()
"""


def _names(tree):
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp("torch_tp4_bf16"))
    rng = np.random.default_rng(0)
    # bf16 values of mixed scales, exactly representable
    sum_in = np.asarray(jnp.asarray(rng.standard_normal((TP, 4096)) * np.exp(
        rng.uniform(-4, 4, (TP, 4096))), jnp.bfloat16).astype(jnp.float32))
    params = jax.tree.map(np.asarray, jtf.init_llama(CFG_J, jax.random.key(0)))
    tokens = rng.integers(0, CFG_J.vocab_size, (2, 64)).astype(np.int32)
    cfg = {f.name: getattr(CFG_J, f.name) for f in dataclasses.fields(CFG_J)
           if f.name != "dtype"}
    np.savez(f"{out}/inputs.npz", meta=json.dumps(dict(names=_names(params), cfg=cfg)),
             sum_in=sum_in, tokens=tokens,
             **{f"p{i}": a for i, a in enumerate(jax.tree.leaves(params))})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r)], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(TP)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = [dict(np.load(f"{out}/rank{r}.npz")) for r in range(TP)]
    return sum_in, params, tokens, got


def test_bf16_sum_over_four_is_bitwise_the_jax_psum(case):
    sum_in, _, _, got = case
    mesh = jlm.make_lm_mesh(1, 1, TP)
    psum = jax.jit(shard_map(lambda a: jax.lax.psum(a, "tensor"), mesh=mesh,
                             in_specs=P("tensor"), out_specs=P("tensor")))
    want = np.asarray(psum(jnp.asarray(sum_in, jnp.bfloat16)).astype(jnp.float32))
    # each rank's row of the output is the sum over the 4 rows
    running = sum_in[0]
    for r in range(1, TP):
        running = np.asarray(jnp.asarray(running + sum_in[r], jnp.bfloat16).astype(jnp.float32))
    assert (running != want[0]).mean() > 0.1      # a step-wise rounding would differ
    for r in range(TP):
        np.testing.assert_array_equal(got[r]["sum"].view(np.uint32), want[r].view(np.uint32))


def test_bf16_forward_at_tensor_four_matches_jax(case):
    _, params, tokens, got = case
    mesh = jlm.make_lm_mesh(1, 1, TP)
    pspecs = jtf.param_specs(CFG_J)

    def logits(cfg):
        fwd = jax.jit(shard_map(
            lambda p, x: jtf.apply_llama(cfg, p, x, tensor_axis="tensor", seq_axis="seq"),
            mesh=mesh, in_specs=(pspecs, P("data", "seq")),
            out_specs=P("data", "seq", "tensor")))
        return np.asarray(fwd(params, jnp.asarray(tokens)).astype(jnp.float32))

    want, want32 = logits(CFG_J), logits(dataclasses.replace(CFG_J, dtype=jnp.float32))
    own = np.abs(want - want32).max()
    got_all = np.concatenate([got[r]["logits"] for r in range(TP)], axis=-1)
    assert np.isfinite(got_all).all() and 0.0 < own < 0.2 * np.sqrt((want32 ** 2).mean())
    assert np.abs(got_all - want).max() <= own, (np.abs(got_all - want).max(), own)
    assert np.abs(got_all - want32).max() <= 1.25 * own, (np.abs(got_all - want32).max(), own)
