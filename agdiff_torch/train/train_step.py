"""Training and evaluation steps (port of agdiff_tpu/train/train_step.py:
29-192; reference: scripts/train.py:117-187).

A step samples antithetic timesteps and the noise from the state's
generator (or takes them from the caller, as the parity tests do),
perturbs the positions, runs the dense module in train mode (batch
statistics; the running ones move once), takes the loss and its
gradients, clips them and steps the two Adams (train/optimizer.py), then
moves the EMA shadow. Every step is eager PyTorch on the module path: the
TPU package computes training in XLA, outside any Pallas kernel, and so
does this one outside the hand kernels.

With a data-parallel `group` (parallel/data_parallel.py
make_parallel_train_step) the step is JAX's SPMD step over the global
batch, one rank's shard at a time: the timesteps and the noise are drawn
at the global batch's shape and sliced, BatchNorm takes the global
statistics, the loss divides by the global real-node count, and the
gradients are summed over the ranks (not averaged, as DDP would) in one
flat all-reduce before the clip and the Adams, which then take the same
decisions on every rank.

A sharded state (parallel/sharded.py, modes 'fsdp' and 'tp') takes the
same step with its module made whole for the forward and the backward
(`ShardLayout.materialized`): the gradients land on each rank's shards,
and the clip's norm and the finite check span the model axis
(train/optimizer.py `TwoAdams.use_shards`).

Mode 'sp' (spatial sharding) keeps the state whole on every rank and
gives each rank the node rows of its graphs: the module and the loss run
under a node layout (parallel/mesh.py NodeLayout) over the mesh's 'sp'
line, the timesteps are the rank's graphs' and the noise its graphs'
node rows of the global draw, BatchNorm's statistics and the loss's
count span every rank, and the gradients, partial sums over each rank's
rows, are summed over every rank before the clip, so that the norm and
the finite check are the whole step's.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import torch

from agdiff_torch.config import Config
from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.loss import (
    diffusion_loss,
    perturb_positions,
    sample_timesteps,
)
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.weights import init_like_jax
from agdiff_torch.nn.common import synced_batch_stats
from agdiff_torch.train.optimizer import TwoAdams, make_optimizer


@dataclass
class TrainState:
    step: int
    module: DualEncoderEpsNetwork
    optimizer: TwoAdams
    generator: torch.Generator      # timesteps and noise, on the device
    ema: Optional[Dict[str, torch.Tensor]] = None  # shadow of the params
    # a sharded state's layout (parallel/sharded.py shard_train_state): the
    # module, both Adams' moments and the shadow hold this rank's slice of
    # every sharded leaf
    layout: Any = None


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    loss_global: torch.Tensor
    loss_local: torch.Tensor
    grad_norm: torch.Tensor


def ema_copy(module) -> Dict[str, torch.Tensor]:
    """A copy of the parameters (never an alias: the shadow moves on its
    own)."""
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def create_train_state(config: Config, device, seed: Optional[int] = None
                       ) -> TrainState:
    """A model drawn by init_like_jax from a CPU generator seeded with
    `seed` (config.train.seed by default), moved to `device`, its
    optimizer, the step generator on the device (seeded likewise) and,
    when config.train.ema_decay > 0, the EMA shadow."""
    seed = config.train.seed if seed is None else seed
    device = torch.device(device)
    module = init_like_jax(DualEncoderEpsNetwork(config.model),
                           torch.Generator().manual_seed(seed)).to(device)
    return TrainState(
        step=0, module=module, optimizer=make_optimizer(module, config.train),
        generator=torch.Generator(device=device).manual_seed(seed),
        ema=ema_copy(module) if config.train.ema_decay > 0 else None)


def update_ema(state: TrainState, decay: float) -> None:
    """shadow <- decay * shadow + (1 - decay) * params, when there is a
    shadow."""
    if state.ema is None:
        return
    with torch.no_grad():
        ema = list(state.ema.values())
        params = [p for _, p in state.module.named_parameters()]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, params, alpha=1.0 - decay)


def global_draw_rows(batch: GraphBatch, group):
    """(graphs of the global batch, this rank's rows of it): a batch
    without a group is the global one."""
    if group is None:
        return batch.num_graphs, slice(None)
    b = batch.num_graphs * group.world_size
    return b, group.rows(b)



class TrainStep:
    """(state, batch[, t, noise]) -> StepMetrics, updating the state in
    place; `t` (B,) and `noise` (B, N, 3) replace the generator's draws.
    With a `group`, `batch` is this rank's shard and `t` and `noise` are
    the global batch's (module docstring). `mode` 'fsdp' or 'tp' steps a
    sharded state (parallel/sharded.py make_sharded_train_step; `group`
    is then the mesh the batch is sharded over); 'sp' a whole state on
    node rows (`group` the whole mesh, its 'sp' line the node axis's)."""

    def __init__(self, config: Config, device, group=None,
                 mode: Optional[str] = None):
        diffusion = make_diffusion(config.model)
        self.alphas = torch.as_tensor(diffusion.alphas, device=device)
        self.num_timesteps = diffusion.num_timesteps
        self.cutoff = config.model.cutoff
        self.ema_decay = config.train.ema_decay
        self.group = group
        self.mode = mode
        # the ranks the graph axis and the node axis split over
        spatial = mode == "sp"
        self.graphs = group.others("sp") if spatial else group
        self.node_line = group.axis("sp") if spatial else None

    def draws(self, state: TrainState, batch: GraphBatch, t=None,
              noise=None, nodes=None):
        """(perturbed positions, alpha_bar of each graph) of this rank's
        graphs, and under a node layout its node rows, of the global
        draws."""
        b, rows = global_draw_rows(batch, self.graphs)
        dev = batch.pos.device
        n = batch.pos.shape[1] if nodes is None else nodes.n
        if t is None:
            t = sample_timesteps(state.generator, b, self.num_timesteps, dev)
        if noise is None:
            noise = torch.randn((b, n) + tuple(batch.pos.shape[2:]),
                                generator=state.generator, device=dev,
                                dtype=batch.pos.dtype)
        noise = noise[rows]
        if nodes is not None:
            noise = noise[:, nodes.rows]
        return perturb_positions(batch, self.alphas, t[rows].to(dev),
                                 noise.to(dev))

    def loss(self, state: TrainState, batch: GraphBatch, t=None, noise=None,
             train: bool = True):
        nodes = None
        if self.node_line is not None:
            # imported here: the parallel package imports this module
            from agdiff_torch.parallel.mesh import NodeLayout

            nodes = NodeLayout(self.node_line, batch.pos.shape[1])
        pos_p, a = self.draws(state, batch, t, noise, nodes)
        out = state.module(batch.replace(pos=pos_p), train=train, nodes=nodes)
        return diffusion_loss(out, batch, pos_p, a, self.cutoff, self.group,
                              nodes)

    def gradients(self, state: TrainState, batch: GraphBatch, t=None,
                  noise=None):
        """The loss terms, with the gradients (summed over the group's
        ranks) in each parameter's .grad; on a sharded state, in each
        shard's, the module whole inside its layout's `materialized`."""
        layout = state.layout
        if (layout is None) != (self.mode in (None, "sp")):
            raise ValueError(f"a step of mode {self.mode} on a state "
                             f"{'not ' if layout is None else ''}sharded")
        whole = (contextlib.nullcontext() if layout is None
                 else layout.materialized(state.module, self.mode))
        with synced_batch_stats(self.group), whole:
            lo = self.loss(state, batch, t, noise)
            state.optimizer.zero_grad()
            lo.loss.backward()
        if layout is not None:
            layout.sum_gradients(state.optimizer, self.mode)
        elif self.group is not None:
            self.group.sum_gradients(state.optimizer.params)
        return lo

    def logged(self, *terms: torch.Tensor):
        """The loss terms as logged: the global loss's (summed over the
        ranks)."""
        terms = [x.detach() for x in terms]
        if self.group is None:
            return terms
        return list(self.group.all_reduce(torch.stack(terms)).unbind())

    def __call__(self, state: TrainState, batch: GraphBatch, t=None,
                 noise=None) -> StepMetrics:
        lo = self.gradients(state, batch, t, noise)
        grad_norm = state.optimizer.step()
        update_ema(state, self.ema_decay)
        state.step += 1
        return StepMetrics(*self.logged(lo.loss, lo.loss_global,
                                        lo.loss_local), grad_norm)


def make_train_step(config: Config, device) -> TrainStep:
    return TrainStep(config, device)


class EvalStep:
    """Validation (train.py:160-187): the running statistics, no update;
    returns the node-weighted sums of the loss terms and the node count
    (agdiff_tpu/train/train_step.py:165-192)."""

    def __init__(self, config: Config, device):
        self.step = TrainStep(config, device)

    @torch.no_grad()
    def __call__(self, state: TrainState, batch: GraphBatch, t=None,
                 noise=None) -> Dict[str, torch.Tensor]:
        lo = self.step.loss(state, batch, t, noise, train=False)
        count = torch.sum((batch.node_mask
                           & batch.graph_mask[:, None]).float())
        return {"sum_loss": lo.loss * count,
                "sum_global": lo.loss_global * count,
                "sum_local": lo.loss_local * count, "count": count}


def make_eval_step(config: Config, device) -> EvalStep:
    return EvalStep(config, device)
