"""Per-phase timing of the element Top-K wire sync chain (``--phase_breakdown``).

The port's counterpart of the stage ladders the JAX sweep borrows from
``tools/wire_profile.py`` (``_dispatch_chain``, ``_sharded_chain``,
``_hier_chain``).  XLA drops a stage whose result nothing reads, so the JAX
ladders time cumulative prefix chains and take rung differences; eager
PyTorch runs every stage it is given, so here each stage of one chain is
timed directly, over the port's own wire functions: CUDA events around each
stage on the card, ``time.perf_counter`` on the CPU.  The stage names and
the map from stage to ``phase_<name>_ms`` column are the JAX sweep's.

One chain per transport, on a flat fp32 vector of the model's gradient size
and the Top-K keep of the sweep point:

  * all_gather (``DISPATCH_STAGES``): mag -> threshold -> select_pack (the
    shipped ``wire._select_pack`` dispatch: the fused kernel, or the mask /
    pack / gather chain under ``--pallas off``) -> combine (all_gather +
    scatter) -> ef;
  * sharded (``SHARDED_STAGES``): ... -> route -> reduce -> return -> ef,
    the three middle stages ``wire_sharded``'s own stage functions;
  * hierarchical (``HIER_STAGES``): ... -> pack (the dense contribution) ->
    ici_reduce -> recompress -> dcn_route (the grouped sharded exchange) ->
    return (the second pod sum) -> ef.

Every rank of a multi-rank sweep runs the same chain: the collectives pair.
On one worker the collectives are self-copies, so the route / return stages
price the bucketing and reduction work, not link time.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

from tpu_compressed_dp_torch.ops import kernels, wire, wire_sharded
from tpu_compressed_dp_torch.parallel import mesh

__all__ = ["DISPATCH_STAGES", "SHARDED_STAGES", "HIER_STAGES", "PHASE_OF", "chain_stages",
           "time_stages", "phase_breakdown_cols"]

DISPATCH_STAGES = ["mag", "threshold", "select_pack", "combine", "ef"]
SHARDED_STAGES = ["mag", "threshold", "select_pack", "route", "reduce", "return", "ef"]
HIER_STAGES = ["mag", "threshold", "pack", "ici_reduce", "recompress", "dcn_route", "return",
               "ef"]

#: stage -> ``phase_<name>_ms`` column, per transport (the JAX sweep's maps)
PHASE_OF = {
    "all_gather": {"mag": "compress", "threshold": "compress", "select_pack": "compress",
                   "combine": "reduce", "ef": "ef"},
    "sharded": {"mag": "compress", "threshold": "compress", "select_pack": "compress",
                "route": "route", "reduce": "reduce", "return": "return", "ef": "ef"},
    "hierarchical": {"mag": "compress", "threshold": "compress", "pack": "compress",
                     "ici_reduce": "ici_reduce", "recompress": "recompress",
                     "dcn_route": "route", "return": "return", "ef": "ef"},
}

Stage = Tuple[str, Callable[[Dict], None]]
#: seconds of whole-chain runs before a chain's stages are timed
WARMUP_S = 0.5


def _ef(c: Dict) -> None:
    c["ef"] = c["flat"].index_fill(0, c["idx"].long(), 0.0)


def _front(pack_name: str, keep: int, pack: Callable[[Dict], None]) -> List[Stage]:
    def mag(c):
        c["mag"] = c["flat"].abs()

    def threshold(c):
        c["t"] = kernels.topk_threshold(c["mag"], keep)

    return [("mag", mag), ("threshold", threshold), (pack_name, pack)]


def chain_stages(transport: str, n: int, keep: int, cfg, group=None) -> List[Stage]:
    """The stages of ``transport``'s chain as ``(name, fn)`` pairs in order,
    each ``fn`` reading and writing one context dict (``flat`` in it)."""
    world = mesh.size(group)

    def select_pack(c):
        c["vals"], c["idx"], c["count"] = wire._select_pack(c["flat"], c["mag"], c["t"], keep)

    if transport == "all_gather":
        def combine(c):
            c["dense"] = wire._scatter_combine(n, (), c["flat"].dtype,
                                               mesh.all_gather(c["idx"], group),
                                               mesh.all_gather(c["vals"], group), world)

        return _front("select_pack", keep, select_pack) + [("combine", combine), ("ef", _ef)]

    if transport == "sharded":
        plan = wire_sharded.make_shard_plan(n, keep, world, 1, cfg.shard_route_factor,
                                            cfg.shard_return_factor)

        def route(c):
            c["rvals"], c["ridx"], c["accepted"], _ = wire_sharded.route_stage(
                c["vals"], c["idx"], plan, group=group)

        def reduce(c):
            c["shard"], c["occ"] = wire_sharded.reduce_stage(c["rvals"], c["ridx"], plan)

        def ret(c):
            dense = wire_sharded.return_stage(c["shard"], c["occ"], c["accepted"], c["idx"],
                                              plan, group)[0]
            c["dense"] = dense[:n] / world

        return _front("select_pack", keep, select_pack) + [
            ("route", route), ("reduce", reduce), ("return", ret), ("ef", _ef)]

    if transport == "hierarchical":
        plan = wire_sharded.make_hier_plan(n, keep, world, cfg.dp_pods,
                                           cfg.hier_route_factor_ici, cfg.hier_route_factor_dcn)
        ici_group, dcn_group = mesh.hier_groups(world, plan.pods, group)
        c_rank = mesh.group_rank(group) % plan.chips

        def pack(c):
            select_pack(c)
            c["contrib"] = torch.zeros_like(c["flat"]).index_copy_(0, c["idx"].long(),
                                                                   c["vals"])

        def ici_reduce(c):
            c["pod_sum"] = (mesh.all_reduce_sum(c["contrib"], ici_group) if plan.chips > 1
                            else c["contrib"])

        def recompress(c):
            if plan.pods > 1:
                c["slab"] = wire.hier_recompress(c["pod_sum"], plan, c_rank)[:3]

        def dcn_route(c):
            if plan.pods > 1:
                s_vals, s_idx, s_valid = c["slab"]
                c["partial"] = wire_sharded.sharded_combine(
                    s_vals, s_idx, plan.dcn, valid=s_valid, group=dcn_group)[0][:n]
            else:
                c["partial"] = c["pod_sum"]

        def ret(c):
            total = (mesh.all_reduce_sum(c["partial"], ici_group)
                     if plan.chips > 1 and plan.pods > 1 else c["partial"])
            c["dense"] = total / world

        return _front("pack", keep, pack) + [
            ("ici_reduce", ici_reduce), ("recompress", recompress), ("dcn_route", dcn_route),
            ("return", ret), ("ef", _ef)]

    raise ValueError(f"no phase chain for transport {transport!r}")


def time_stages(stages: List[Stage], make_ctx: Callable[[], Dict], iters: int, device,
                group=None) -> Dict[str, float]:
    """Mean ms of each stage over ``iters`` runs of the chain, after
    ``WARMUP_S`` seconds of whole-chain runs (as many on every rank of
    ``group``): CUDA events between the stages on the card (one synchronize
    at the end), ``time.perf_counter`` on the CPU."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def run_once(ctx, marks=None):
        for i, (_, fn) in enumerate(stages):
            fn(ctx)
            if marks is not None:
                if cuda:
                    marks[i + 1].record()
                else:
                    marks[i + 1] = time.perf_counter()

    t_end = time.perf_counter() + WARMUP_S
    run_once(make_ctx())
    while mesh.more_on_any_rank(time.perf_counter() < t_end, device, group):
        run_once(make_ctx())
    if cuda:
        torch.cuda.synchronize(device)
    total = [0.0] * len(stages)
    for _ in range(iters):
        ctx = make_ctx()
        if cuda:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
            marks[0].record()
            run_once(ctx, marks)
            marks[-1].synchronize()
            for i in range(len(stages)):
                total[i] += marks[i].elapsed_time(marks[i + 1])
        else:
            marks = [0.0] * (len(stages) + 1)
            marks[0] = time.perf_counter()
            run_once(ctx, marks)
            for i in range(len(stages)):
                total[i] += (marks[i + 1] - marks[i]) * 1e3
    return {name: t / iters for (name, _), t in zip(stages, total)}


def phase_breakdown_cols(cfg, n: int, keep: int, opt, params: Dict[str, torch.Tensor],
                         iters: int, device, group=None) -> Dict[str, float]:
    """The ``phase_<name>_ms`` columns of one Top-K wire sweep point: the
    chain of ``cfg.transport`` at the model's flat gradient size ``n`` and
    keep ``keep``, each stage's mean ms summed into its phase, and
    ``phase_update_ms``, the optimizer's apply on fresh parameters of the
    model's shapes (the train step's own ``opt``).  The select+pack and
    route stages ride the live ``kernels.pallas_mode()`` dispatch, so an
    off-vs-auto row pair prices the kernels on identical phase boundaries.
    Rounded to 4 decimals, as the JAX sweep's."""
    transport = "all_gather" if cfg.transport in ("allgather", "all_gather") else cfg.transport
    stages = chain_stages(transport, n, keep, cfg, group)
    gen = torch.Generator(device=device).manual_seed(7)
    flat = torch.randn(n, generator=gen, device=device)
    times = time_stages(stages, lambda: {"flat": flat}, iters, device, group=group)
    cols: Dict[str, float] = {}
    for name, ms in times.items():
        key = f"phase_{PHASE_OF[transport][name]}_ms"
        cols[key] = cols.get(key, 0.0) + ms

    fresh = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    grads = {k: torch.randn(p.shape, generator=gen, device=device) for k, p in fresh.items()}
    opt_state = opt.init(fresh)
    cols["phase_update_ms"] = time_stages(
        [("update", lambda c: opt.apply(fresh, grads, opt_state, 0))], dict, iters,
        device)["update"]
    return {k: round(v, 4) for k, v in cols.items()}
