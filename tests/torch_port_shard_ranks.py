"""Rank-side code of the sharded, spatially sharded, multi-slice and
pipeline tests (tests/test_torch_port_sharded.py,
tests/test_torch_port_pipeline.py; no tests here): the functions
`agdiff_torch.parallel.launch` runs in each of four spawned gloo ranks,
which must be importable and import no JAX, and the planted faults of
the sharded steps and the pipeline."""

import contextlib
import dataclasses

import torch

from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.ops import masked
from agdiff_torch.ops.pairs import owned_pairs
from agdiff_torch.parallel import pipeline as pp
from agdiff_torch.parallel import sharded as sh
from agdiff_torch.parallel.data_parallel import (
    make_parallel_train_step,
    shard_graph_batch,
)
from agdiff_torch.parallel.mesh import (
    Mesh,
    NodeLayout,
    make_hybrid_mesh,
    make_mesh,
    with_adjoint,
)
from agdiff_torch.train import train_step as ts
from agdiff_torch.train.optimizer import TwoAdams, global_norm, make_optimizer

import torch_port_dp_ranks as dp
from torch_port_sp_faults import SP_PACKED_FAULTS, patch_packed

# the faults a sharded step must not have: an fsdp gradient shard left
# unsummed over the model axis (the gather's backward keeps the rank's own
# row); a row-parallel partial product left unreduced; the clip's norm
# taken from the rank's own shards
SHARD_FAULTS = ("shard_unsummed", "partial_unreduced", "own_shard_norm")
# the faults a spatially sharded ('sp') step must not have: the transposed
# terms of the equivariant transform dropped (no column partial);
# BatchNorm's statistics from the rank's own rows; the j side of the pair
# ops from the rank's own rows in place of the whole axis (h not
# gathered); the loss's node count the rank's own
SP_FAULTS = ("transposed_dropped", "own_row_stats", "own_rows_hj",
             "own_rows_count")


@contextlib.contextmanager
def planted(fault):
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if fault == "shard_unsummed":
        patch(Mesh, "all_gather_with_grad", lambda self, x: with_adjoint(
            x, self.all_gather, lambda g: g[self.rank].clone()))
    elif fault == "partial_unreduced":
        patch(Mesh, "sum_replicated", lambda self, x: x.clone())
    elif fault == "own_shard_norm":
        patch(TwoAdams, "norm", lambda self, grads: global_norm(grads))
    elif fault == "cross_slice_skipped":
        def within(self, params):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            flat = self.axis(self.axis_names[-1]).all_reduce(
                torch.cat([g.reshape(-1) for g in grads]))
            for p, g in zip(params, flat.split([g.numel() for g in grads])):
                p.grad = g.view_as(p)
        patch(Mesh, "sum_gradients", within)
    elif fault == "transposed_dropped":
        patch(NodeLayout, "columns", lambda self, partial: torch.zeros_like(
            partial[:, self.rows]))
    elif fault == "own_row_stats":
        real_stats = masked.masked_batch_norm_stats
        patch(masked, "masked_batch_norm_stats",
              lambda x, mask, group=None: real_stats(x, mask))
    elif fault == "own_rows_hj":
        real_gather = NodeLayout.gather

        def own_rows(self, x):
            if x.is_floating_point() and x.shape[-1] != 3:
                return torch.cat([x] * self.mesh.world_size, 1)
            return real_gather(self, x)
        patch(NodeLayout, "gather", own_rows)
    elif fault == "own_rows_count":
        real_loss = ts.diffusion_loss
        patch(ts, "diffusion_loss",
              lambda *a: real_loss(*a[:5], None, *a[6:]))
    elif fault in SP_PACKED_FAULTS:
        patch_packed(fault, patch)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def state_of(config, module):
    return ts.TrainState(
        step=0, module=module, optimizer=make_optimizer(module, config.train),
        generator=torch.Generator(),
        ema=ts.ema_copy(module) if config.train.ema_decay > 0 else None)


def sharded_case(group, case):
    """One sharded step ('fsdp' or 'tp' on a (2, 2) mesh) of the case's
    weights on this rank's rows, t and the noise the global batch's: the
    whole state after it (parallel/sharded.py gather_state), the metrics,
    the specs, whether the cut state gathers back to the weights bit for
    bit, and the size of each shard this rank holds."""
    config, mode = case["config"], case["mode"]
    mesh = make_hybrid_mesh(4, 2, model_axis=mode)
    state = state_of(config, dp.module_of(config.model, case["variables"]))
    before = {n: t.detach().clone() for n, t in
              list(state.module.named_parameters())
              + list(state.module.named_buffers())}
    sh.shard_train_state(state, mesh, mode)
    held = sh.gather_state(state)
    round_trip = all(torch.equal(held[part][n], before[n])
                     for part in ("params", "buffers")
                     for n in held[part])
    sizes = {n: p.numel() for n, p in state.module.named_parameters()}
    moment_sizes = {n: (mu.numel(), nu.numel()) for adam in
                    state.optimizer.adams.values()
                    for n, mu, nu in zip(
                        [k for k, p in state.module.named_parameters()
                         if any(p is q for q in adam.params)],
                        adam.mu, adam.nu)}
    step = sh.make_sharded_train_step(config, mesh, state, mode)
    axes = mesh.axis_names if mode == "fsdp" else ("dp",)
    shard = sh.shard_graph_batch_over(case["batch"], mesh, axes)
    with planted(case.get("fault")):
        metrics = step(state, shard, case["t"], case["noise"])
    return dict(metrics=[float(m) for m in metrics], state=sh.gather_state(
        state), specs=sh.state_specs(state, mesh, mode), dims=dict(
        state.layout.dims), round_trip=round_trip, sizes=sizes,
        moment_sizes=moment_sizes, bytes=state.layout.rank_bytes(state),
        rows=shard.num_graphs)


def sp_case(group, case):
    """One spatially sharded step ('sp') of the case's weights on a
    ('dp', 'sp') mesh of case['dims'] over the first ranks of the world,
    this rank's (graph rows, node rows) of the batch, t and the noise the
    global batch's: the metrics, the whole state after it, and the shape
    of each field of the rank's shard, and the pairs the rank owns under
    packed_pairs (ops/pairs.py owned_pairs). None on a rank outside the
    mesh."""
    config, (d, s) = case["config"], case["dims"]
    mesh = make_hybrid_mesh(d * s, s, model_axis="sp")
    if mesh is None:
        return None
    state = state_of(config, dp.module_of(config.model, case["variables"]))
    step = sh.make_sharded_train_step(config, mesh, state, "sp")
    shard = sh.shard_graph_batch_nodes(case["batch"], mesh)
    with planted(case.get("fault")):
        metrics = step(state, shard, case["t"], case["noise"])
    nodes = NodeLayout(mesh.axis("sp"), shard.pos.shape[1])
    return dict(metrics=[float(m) for m in metrics],
                state=sh.gather_state(state),
                pairs=owned_pairs(nodes, "cpu").num_pairs,
                shapes={f: tuple(getattr(shard, f).shape) for f in (
                    "atom_type", "pos", "node_mask", "bond_adj",
                    "graph_mask")})


def dp_step(group, case, mesh):
    config = case["config"]
    module = dp.module_of(config.model, case["variables"])
    state = state_of(config, module)
    with planted(case.get("fault")):
        metrics = make_parallel_train_step(config, mesh)(
            state, shard_graph_batch(case["batch"], mesh), case["t"],
            case["noise"])
    return dp._result(metrics, module)


def dcn_case(group, case):
    """The DP step over the ('dcn', 'dp') = (2, 2) mesh, and the mesh."""
    mesh = make_mesh(4, dcn_slices=2)
    out = dp_step(group, case, mesh)
    out.update(axis_names=mesh.axis_names, shape=mesh.shape,
               lines={a: mesh.axis(a).members for a in mesh.axis_names})
    return out


def flat_case(group, case):
    """The DP step over make_mesh(4) and over the world's group built
    directly (Mesh(world_size, rank, device, backend)): (both results)."""
    return [dp_step(group, case, mesh) for mesh in (
        make_mesh(4), Mesh(group.world_size, group.rank, group.device,
                           group.backend))]


def _error(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def refusals_case(group, case):
    """The meshes' and the sharded step's checks: {check: (error name,
    message) or None}."""
    config = case["config"]
    tp = make_hybrid_mesh(4, 2, model_axis="tp")
    sp = make_hybrid_mesh(4, 2, model_axis="sp")
    packed = dataclasses.replace(config, model=dataclasses.replace(
        config.model, packed_pairs=True))
    batch = case["batch"]
    odd = batch.replace(**{f: getattr(batch, f)[:, :15] for f in (
        "atom_type", "pos", "node_mask")}, bond_adj=batch.bond_adj[:, :15,
                                                                   :15])
    return dict(
        indivisible=_error(lambda: make_hybrid_mesh(4, 3)),
        too_many=_error(lambda: make_hybrid_mesh(8, 4)),
        tp_mesh=(tp.axis_names, tp.shape, tp.axis("tp").members),
        dcn_indivisible=_error(lambda: make_mesh(4, dcn_slices=3)),
        dcn_world=_error(lambda: make_mesh(8, dcn_slices=2)),
        pp2=_error(lambda: sh.make_sharded_train_step(config, tp,
                                                      mode="pp2")),
        sp_on_tp=_error(lambda: sh.make_sharded_train_step(config, tp,
                                                           mode="sp")),
        sp=_error(lambda: sh.make_sharded_train_step(config, sp,
                                                     mode="sp")),
        sp_batch=_error(lambda: sh.shard_graph_batch_nodes(
            case["batch"], sp)),
        sp_indivisible=_error(lambda: sh.shard_graph_batch_nodes(odd, sp)),
        sp_packed=_error(lambda: sh.make_sharded_train_step(packed, sp,
                                                            mode="sp")),
        no_axis=_error(lambda: sh.make_sharded_train_step(config, tp,
                                                          mode="fsdp")))


def collectives_case(group, case):
    """all_gather, reduce_scatter and ppermute over the world and a
    line of a (2, 2) mesh, values and gradients, on rank-made inputs."""
    r = group.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    w = torch.arange(24, dtype=torch.float32).reshape(4, 2, 3) + 1.0
    xg = x.clone().requires_grad_(True)
    (group.all_gather_with_grad(xg) * w).sum().backward()
    stacked = torch.arange(24, dtype=torch.float32).reshape(4, 2, 3) * (r + 1)
    sg = stacked.clone().requires_grad_(True)
    (group.reduce_scatter_with_grad(sg) * (r + 1)).sum().backward()
    ring = [(j, (j + 1) % 4) for j in range(4)]
    pg = x.clone().requires_grad_(True)
    (group.ppermute_with_grad(pg, ring) * (r + 1)).sum().backward()
    partial = group.ppermute(x, [(0, 2), (1, 0)])
    line = make_hybrid_mesh(4, 2, model_axis="fsdp").axis("fsdp")
    return dict(
        gathered=group.all_gather(x), gather_grad=xg.grad,
        scattered=group.reduce_scatter(stacked), scatter_grad=sg.grad,
        permuted=group.ppermute(x, ring), permute_grad=pg.grad,
        partial=partial, bf16=group.all_gather(x.bfloat16()),
        line=line.all_gather(x), line_members=line.members)


SHARD_KINDS = {"sharded": sharded_case, "sp": sp_case, "dcn": dcn_case,
               "flat": flat_case, "refusals": refusals_case,
               "collectives": collectives_case, "train": dp.train_case}


def run_cases(group, cases):
    """Every case in this rank; returns [each rank's {name: result}]."""
    torch.manual_seed(0)
    out = {}
    for name, case in cases.items():
        kind = case["kind"]
        out[name] = (PIPE_KINDS.get(kind) or SHARD_KINDS[kind])(group, case)
    return dp.every_rank(group, out)


# ---- the pipeline -----------------------------------------------------------


def toy_stage(w, xm):
    return torch.tanh(xm @ w)


def toy_pair_stage(w, payload):
    xm, a = payload
    return torch.tanh(xm @ w), a


@contextlib.contextmanager
def wrong_neighbour():
    """The rotation moved two stages on instead of one."""
    real = Mesh.ppermute_with_grad

    def skip(self, x, perm):
        return real(self, x, [(s, (s + 2) % self.world_size)
                              for s, _ in perm])
    Mesh.ppermute_with_grad = skip
    try:
        yield
    finally:
        Mesh.ppermute_with_grad = real


def toy_case(group, case):
    """pipeline_apply on the toy stages over the 4-rank 'pp' mesh: the
    output, the gradients of sum(out ** 2) in the stacked weights (summed
    over the ranks: each holds its stage's) and in x; jit_pipeline's
    placement and run; a pytree payload; the stage-count check; the
    rotation fault."""
    mesh = pp.make_pp_mesh(4)
    ws, x = case["ws"], case["x"]
    wg, xg = ws.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = pp.pipeline_apply(toy_stage, wg, xg, mesh=mesh)
    (out ** 2).sum().backward()
    run, place = pp.jit_pipeline(toy_stage, mesh)
    placed = place(ws)
    aux = torch.arange(x.shape[0], dtype=torch.float32)[:, None]
    pair = pp.pipeline_apply(toy_pair_stage, ws, (x, aux), mesh=mesh)
    with wrong_neighbour():
        wrong = pp.pipeline_apply(toy_stage, ws, x, mesh=mesh)
    return dict(out=out.detach(), grad_w=group.all_reduce(wg.grad.clone()),
                grad_x=xg.grad, placed_shape=tuple(placed.shape),
                placed=placed, jit_out=run(placed, x), pair=pair,
                wrong=wrong, stage_error=_error(lambda: pp.pipeline_apply(
                    toy_stage, ws[:3], x, mesh=mesh)),
                too_many=_error(lambda: pp.make_pp_mesh(8)))


def schnet_case(group, case):
    """schnet_pipeline over the 'pp' axis of a ('dp', 'pp') = (2, 2) mesh
    on the case's forward: the pipelined h, the stage bodies run one
    after another on one rank, K3's calls per rank in a pipelined
    forward, and the rotation fault."""
    cfg = case["model_config"]
    module = dp.module_of(cfg, case["variables"]).eval()
    fwd = build_fast_forward(cfg, module, "pallas")
    mesh = make_hybrid_mesh(4, 2, model_axis="pp")
    run, stacked = pp.schnet_pipeline(fwd, mesh)
    payload = case["payload"]
    calls = [0]
    real = pp.interaction_block_aggregate

    def counted(*args):
        calls[0] += 1
        return real(*args)
    pp.interaction_block_aggregate = counted
    try:
        with torch.no_grad():
            h = run(stacked, payload)
    finally:
        pp.interaction_block_aggregate = real
    stage = pp.schnet_stage(fwd)
    seq = []
    with torch.no_grad():
        for m in range(payload[0].shape[0]):
            p = tuple(a[m] for a in payload)
            for s in range(mesh.shape["pp"]):
                p = stage(pp.stage_slice(stacked, s), p)
            seq.append(p[0])
        with wrong_neighbour():
            wrong = run(stacked, payload)
    return dict(h=h, sequential=torch.stack(seq), k3_calls=calls[0],
                wrong=wrong)


PIPE_KINDS = {"toy": toy_case, "schnet": schnet_case}

