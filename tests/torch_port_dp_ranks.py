"""Rank-side code of the data-parallel tests (tests/test_torch_port_
parallel*.py; no tests here): the functions `agdiff_torch.parallel.launch`
runs in each spawned rank, which must be importable and import no JAX,
and the planted faults of the data-parallel step. Each case function
also runs without a group (group None), in the test's own process, as
the single-process reference. The train and sample cases run on the
case's "device" (the CPU when it names none; a rank on its group's) and
return CPU tensors: tests/test_torch_port_cuda.py runs them on the
card."""

import contextlib

import torch

from agdiff_torch.eval.generate import MODULE, GenerationRunner
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.tight_forward import (
    ENGINES as TIGHT_ENGINES,
    build_tight_forward,
)
from agdiff_torch.models.weights import load_jax_variables
from agdiff_torch.ops import masked
from agdiff_torch.parallel.data_parallel import (
    make_parallel_chunked_train_step,
    make_parallel_distill_step,
    make_parallel_sampler,
    shard_graph_batch,
)
from agdiff_torch.parallel.mesh import Mesh
from agdiff_torch.serve.server import call_on_every_rank
from agdiff_torch.train import distill
from agdiff_torch.train import train_step as ts
from agdiff_torch.train.optimizer import make_optimizer

# the faults a data-parallel step must not have: per-rank BatchNorm
# statistics; statistics summed by an all-reduce that carries no gradient
# (the cross-rank terms of their gradient lost); DDP's mean of per-rank
# mean losses; each rank drawing only its own rows' share of the noise
# (the first rows of a draw from the shared generator)
FAULTS = ("local_stats", "stats_without_grad", "ddp_mean", "own_noise")


@contextlib.contextmanager
def planted(fault):
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if fault == "local_stats":
        real = masked.masked_batch_norm_stats
        patch(masked, "masked_batch_norm_stats",
              lambda x, mask, group=None: real(x, mask))
    elif fault == "stats_without_grad":
        patch(Mesh, "sum_with_grad", lambda self, x: x + (
            self.all_reduce(x.detach().clone()) - x.detach()))
    elif fault == "ddp_mean":
        real_loss, real_sum = ts.diffusion_loss, Mesh.sum_gradients

        def mean(self, params):
            real_sum(self, params)
            for p in params:
                p.grad /= self.world_size
        patch(ts, "diffusion_loss", lambda *a: real_loss(*a[:5]))
        patch(Mesh, "sum_gradients", mean)
    elif fault == "own_noise":
        patch(ts, "global_draw_rows", lambda batch, group: (
            batch.num_graphs, slice(0, batch.num_graphs)))
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def device_of(group, case) -> torch.device:
    return group.device if group is not None else torch.device(
        case.get("device", "cpu"))


def module_of(model_config, variables, device="cpu"):
    module = DualEncoderEpsNetwork(model_config)
    load_jax_variables(module, variables)
    return module.to(device)


def _step_state(module, config, device):
    return ts.TrainState(step=0, module=module,
                         optimizer=make_optimizer(module, config.train),
                         generator=torch.Generator(device=device))


def _result(metrics, module):
    return dict(
        metrics=[float(m) for m in metrics],
        grads={n: p.grad.detach().cpu().clone()
               for n, p in module.named_parameters()},
        params={n: p.detach().cpu().clone()
                for n, p in module.named_parameters()},
        buffers={n: b.cpu().clone() for n, b in module.named_buffers()})


def train_case(group, case):
    """One train step of the case's weights on its batch (this rank's
    shard of it) with the global t and noise injected, a planted fault
    when the case names one."""
    config, dev = case["config"], device_of(group, case)
    module = module_of(config.model, case["variables"], dev)
    state = _step_state(module, config, dev)
    if group is None:
        step = ts.make_train_step(config, dev)
        batch = case["batch"].to(dev)
    else:
        step = ts.TrainStep(config, dev, group)
        batch = shard_graph_batch(case["batch"], group)
    with planted(case.get("fault")):
        metrics = step(state, batch, case["t"].to(dev),
                       case["noise"].to(dev))
    return _result(metrics, module)


def chunked_case(group, case):
    """The chunked step over two copies of the case's shard against two
    steps: the parameters after each (a rank only)."""
    config = case["config"]
    shard = shard_graph_batch(case["batch"], group)
    out = []
    for chunked in (True, False):
        module = module_of(config.model, case["variables"], group.device)
        state = _step_state(module, config, group.device)
        if chunked:
            make_parallel_chunked_train_step(config, 2, group)(
                state, [shard, shard], [case["t"]] * 2, [case["noise"]] * 2)
        else:
            step = ts.TrainStep(config, group.device, group)
            for _ in range(2):
                step(state, shard, case["t"], case["noise"])
        out.append(_result([], module)["params"])
    return out


def distill_case(group, case):
    """One distill step: the student (the case's student weights) against
    its teacher, k and the noise the global batch's."""
    config = case["config"]
    teacher = module_of(config.model, case["variables"]).eval()
    state = distill.create_distill_state(config, teacher, "cpu", 0)
    state.module.load_state_dict(
        module_of(config.model, case["student"]).state_dict())
    batch = case["batch"]
    if group is None:
        step = distill.make_distill_step(config, case["sampler"],
                                         case["n_student"], "cpu")
    else:
        step = make_parallel_distill_step(config, case["sampler"],
                                          case["n_student"], group)
        batch = shard_graph_batch(batch, group)
    metrics = step(state, teacher, batch, case["k"], case["noise"])
    return _result(metrics, state.module)


def _forward(cfg, module, engine, capacity):
    if engine == MODULE:
        return None
    if engine in TIGHT_ENGINES:
        return build_tight_forward(cfg, module, engine, capacity=capacity)
    return build_fast_forward(cfg, module, engine)


def sample_case(group, case):
    """The case's ladder over the global batch from its starts and noise:
    the gathered positions and flags, and this rank's forwards."""
    cfg, dev = case["model_config"], device_of(group, case)
    module = module_of(cfg, case["variables"], dev).eval()
    fwd = _forward(cfg, module, case["engine"], case.get("capacity"))
    sampler = make_parallel_sampler(
        module, make_diffusion(cfg), case["sampler"], group, forward_fn=fwd,
        pair_capacity=case.get("capacity"))
    out = sampler(case["batch"].to(dev), case["pos_init"].to(dev),
                  noise=case["noise"].to(dev))
    return dict(pos=out.pos.cpu(), flags=out.nan_flags.cpu(),
                calls=None if fwd is None else fwd.calls)


def runner_case(group, case):
    """GenerationRunner.run over the case's molecules: each molecule's
    samples."""
    cfg = case["model_config"]
    runner = GenerationRunner(
        module_of(cfg, case["variables"]), cfg, make_diffusion(cfg),
        case["sampler"], buckets=case["buckets"], chunk_size=case["chunk"],
        device="cpu", engine=case["engine"],
        use_fast=case["engine"] != MODULE, group=group)
    return [torch.from_numpy(m.meta["pos_gen"]) for m in runner.run(
        case["molecules"], seed=case["seed"], num_confs=case["num_confs"])]


class _PlantedRunner:
    """A runner whose calls succeed, fail on every rank, or fail on
    rank 1 only."""

    def __init__(self, group):
        self.group = group

    def ok(self):
        return self.group.rank

    def fails(self, on_rank=None):
        if on_rank is None or on_rank == self.group.rank:
            raise ValueError("planted failure")


def outcomes_case(group, case):
    """serve.server.call_on_every_rank on each of _PlantedRunner's calls:
    {call: its result, or the name of the error it raised}."""
    runner = _PlantedRunner(group)
    out = {}
    for label, name, kwargs in (("ok", "ok", {}),
                                ("fails_everywhere", "fails", {}),
                                ("fails_on_rank_1", "fails",
                                 {"on_rank": 1})):
        try:
            out[label] = call_on_every_rank(runner, name, (), kwargs)
        except Exception as e:
            out[label] = type(e).__name__
    return out


KINDS = {"train": train_case, "chunked": chunked_case,
         "distill": distill_case,
         "sample": sample_case, "runner": runner_case,
         "outcomes": outcomes_case}


def every_rank(group, obj):
    """[each rank's obj], on every rank."""
    return [group.broadcast_object(obj if group.rank == r else None, src=r)
            for r in range(group.world_size)]


def run_cases(group, cases):
    """Every case in this rank; returns {name: [each rank's result]}."""
    torch.manual_seed(0)
    out = {name: KINDS[case["kind"]](group, case)
           for name, case in cases.items()}
    return every_rank(group, out)


def die_on_rank_1(group):
    """Rank 1 fails while rank 0 waits for it in a collective."""
    if group.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    group.barrier()
